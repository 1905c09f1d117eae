"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py                      # every phase, one card

Phases (each prints one line or more; any failure exits non-zero, and the
result lines are printed only when every phase passed):

  1. device — the card's name, and its power limit from ``nvidia-smi``;
  2. build — every ``src/repro_torch/csrc/*.cu`` compiled by ``nvcc`` for
     ``sm_90a``, all sources at once; the seconds it took and each kernel's
     registers/spills as ``ptxas`` reports them (``flash_attention_tc``'s
     consumers run at the 240 registers ``setmaxnreg`` gives them, not the
     168 ptxas prints for the kernel; ``bitset_unpack``'s are repeated on its
     ``[ops]`` line);
  3. main path — a US-Patents-shaped R-MAT graph (3,774,768 nodes,
     16,522,438 edges, 418 labels, seed 0) opened with
     ``GraphSession.open(g)`` on the card (CUDA kernels), eight or more
     seeded DFS queries of 4-6 nodes run with ``max_matches=1024,
     adaptive=False`` as in the paper's §6.1, and one stream consumed to its
     end. The launch counts are zeroed just before and read just after;
     each of the matcher's five kernels must be > 0. Every returned row is
     checked to be a label-preserving injective embedding of its query in
     the graph. Each query then runs three more times, uncounted, for its
     median wall and stage times past first-call warm-up, and the explore
     stage's median ms per exploration round (a round launches
     ``stwig_expand`` once and ``bitset_build`` once for all its columns);
     one repeat is traced with ``torch.profiler`` (device time, busy share,
     top kernels), a measurement only. Then the engine's direct entry
     points, counted alone (the five kernels each > 0):
     ``session.engine.match(q, adaptive=False)`` gives each query's rows,
     and ``match_stream`` pages (at most the open stream's ``n_blocks``)
     whose first 1,024 rows are the facade stream's;
  4. the same queries and stream with ``kernels="torch"`` (the plain
     PyTorch versions) on the card must give identical rows; the inputs of
     each op's largest call there are kept for phase 5, and every
     ``stwig_expand`` and ``bitset_build`` call with its output for phase 6;
  serve — the continuous-batching server (``session.serve()``, `ServerConfig`'s
     defaults: 8 in flight, blocks of 512 rows, first 1,024 matches) on
     phase 3's session with the CUDA kernels again and its graph:
     ``mixed_workload(g, 32, n_labels=418, rng=default_rng(0))`` (DFS and
     random queries of 4-7 nodes, alternating). The counts are zeroed
     before and read after (each of the matcher's five kernels > 0); no
     outcome may be ``"failed"`` (a per-query exception, a kernel's
     included, is isolated into that status) and ``global_degradations``
     must be 0. Every query's rows must equal, in order, its sequential
     ``compiled.stream(max_matches=1024, block_rows=512)``, and each row is
     checked as an embedding. Printed: queries a second, p50/p99 of each
     outcome's ``wall_s``, ``ttfp_s``, ``queue_s``, the served/partial/failed
     split, join and setup quanta, warm admissions, cache hits and misses,
     peak memory. Then the same workload open loop (``with session.serve()
     as srv``: the scheduler on its own thread, submissions and
     ``Ticket.result()`` on the main one), the same rows a query; a
     ``deadline_s=0`` server sheds every query at admission with no launch
     and no quantum; and one ``server.serve(workload)`` traced with
     ``torch.profiler`` (device time and busy share, a measurement only);
  5. kernels — each matcher kernel against its plain version on the card,
     on those main-path inputs and on small adversarial cases, bit for bit
     (tolerance 0: all outputs are integers or flags); ``bitset_lookup``'s
     include ragged lengths (15, 16, 17, 1,000,008), starts 1-15 ids past a
     16-byte boundary and ids -1, 32·W, 2^31 - 1 on the kernel's group
     boundaries; ``stwig_expand``'s include a 60,000-edge row over ~30 tiles, 10,000 empty rows, k = 16
     with C = 1 and survivors straddling a tile boundary, ``bitset_build``'s
     a round's 7 columns with negative ids, ``hash_join_probe``'s both of
     its routes (a build side above its 102,400-byte shared-memory budget,
     one exactly at it, one row above it), dup_cap 1, 5 and 100, capB not a
     multiple of its tile, nk 3; the route each call took, as the kernel's
     C entry point recorded it, must be the one its case names, and the
     line names them all. ``bitset_pack`` runs as the matcher calls it,
     through ``mask_to_host`` (``pack_flags``: any length; its plain version
     pads the mask), on the main path's largest mask, on masks of ragged
     lengths and on masks that start off 16-byte alignment (the op, whole
     words, too; and the op must refuse a ragged mask); the line lists the
     main path's masks, and ``mask_to_host``'s host path is timed step by
     step (``perf_counter_ns``, as ``[probe]`` times the lower bound's),
     its byte-wise host unpack beside the 32-lane one it replaced.
     Kernel and plain times are CUDA-event medians of 10 runs after a
     warm-up; the device time of ``hash_join_probe`` and of the bitset
     kernels (``bitset_unpack``'s in phase 6) also from a CUDA graph of
     20 calls, with the eager call's parts beside it (`eager_times`: host
     µs, 100 calls back to back, a call behind queued work);
     ``bitset_lookup``'s beside one PyTorch kernel moving about its bound's
     bytes on the same tensors (``ids.ne(0)``, `same_bytes`).
     ``stwig_expand``'s bound
     counts the bytes it must read when it reads lazily (as
     ``candidate_filter``'s does), the all-inputs figure printed beside it,
     with the device time of each of its two kernels from ``torch.profiler``;
  6. ops — ``bitset_unpack`` on every binding bitset the main path built
     (each column of each ``bitset_build`` call) and
     ``candidate_filter`` on every (``stwig_expand`` call, child) of it, with
     the counts zeroed before and read after (each > 0): bit-exact against
     the plain versions, ``unpack(build(ids))`` equal to the built ids' bits,
     and the filter's per-root sums equal to ``stwig_expand``'s exact counts.
     Then, uncounted, the filter on ragged lengths, ``root_ok`` all false,
     all true and on ~1 edge in 418 in runs by source, each edge array
     (then all three) starting 1-15 elements past a 16-byte boundary, ids
     out of range on group boundaries: bit-exact too.
     The filter's kernel row is timed on those edges made dense (every edge
     ``root_ok`` with the child's label, random binding words), where its
     whole byte bound is needed; its sparse main-path input is timed too;
     each input also by a CUDA graph of 20 calls, with `eager_times`, the
     sparse one beside ``root_ok.clone()`` (`same_bytes`); ``bitset_unpack``
     on the largest main-path bitset likewise;
  sharded — the paper's engine (§4.3) on phase 3's graph in 16 hash shards
     (``configs/stwig.py``'s 250,000 nodes a shard; 236,632 a shard here),
     every shard on the card, opened with ``GraphSession.open(pg,
     backend="sharded")`` once the local session is freed; phase 3's
     queries and stream with the counts zeroed before and read after
     (each of the matcher's five kernels > 0; a kernel launches once a
     shard where the local path launches once), every row checked as an
     embedding; at ``max_matches=0`` no row twice, and the local engine's
     row set wherever the local result is complete (phase 3's queries, and
     four smaller queries picked for a complete local result) and for
     every query of one STwig; three repeats a query (wall and
     explore/fetch/join/materialize times), one repeat traced with
     ``torch.profiler`` (a measurement only), peak memory; the same queries
     and stream with ``kernels="torch"`` give identical rows and pages
     (the direct entry points as in phase 3, and ``bool_allreduce_any``
     over the stacked shard dim bit-exact with numpy's ``any``),
     and on the last shard's ids (global ids from 15 · 236,632 up) each
     ``stwig_expand`` call and ``candidate_filter`` on each of its
     children are bit-exact against the plain versions;
  ranks — the paper's engine with one shard a process: [sharded]'s 16
     shards, saved once by this process (``PartitionedGraph.save``, the
     cluster-graph index beside it) and opened by 16 gloo ranks
     (``spawn_ranks``; each maps its own shard's pages) with
     ``GraphSession.open(pg, backend="sharded", mesh=make_host_mesh(16))``,
     every rank on ``cuda:0`` with the CUDA kernels (the one card takes no
     NCCL group of two ranks); phase 3's queries and stream, each rank's
     counts zeroed before and read after (each rank launches each of the
     matcher's five kernels; no rank builds a library); every rank's rows
     and pages identical to [sharded]'s, truncated ones included, and each
     row an embedding; on rank 15 each ``stwig_expand`` call and
     ``candidate_filter`` on each of its children bit-exact against the
     plain versions (every rank re-runs on them: the same rows). Measured,
     not held: three repeats a query (wall and stage times), each rank's
     peak memory, and the bytes the rank collectives staged through pinned
     host memory (``rank_collectives.GLOO_HOST_OPS``);
  7. a 2,000-node graph gives the same rows on the CPU and on the card, on
     the local engine and on the sharded one at S = 4 (smaller tables:
     every CPU shard probes all four shards' tables);
  chaos — seeded faults (``GraphSession.open(..., chaos=ChaosInjector(...))``,
     kernels ``"chaos(cuda)"``) on phase 7's graph in 4 shards on the card,
     on phase 7's queries whose local and clean sharded results are both
     complete at ``max_matches=0, adaptive=False``: shard 1 dead for good
     (rows a subset of the local session's, ``complete=False``, health
     ``"dead"``, ``fetch_retries`` the policy's 3), shard 2 dead for 2
     attempts (the clean rows, ``"recovered"``), shard 3's fetch truncated
     to half (a subset, ``"truncated"``), shard 0 slow (the clean rows,
     ``"slow"``); the matcher's five kernels launched under chaos (counted);
     forced overflow on the local engine under ``RetryPolicy(ceiling_bytes=
     1.0)``: partial, ``"overflow-ceiling"``, its rows a subset;
  ranks-small — phase 7's graph in 4 shards, one spawn of 8 gloo ranks as
     a (2, 4) mesh: a row of 4 on ``cuda:0`` (counted: each rank launches
     the matcher's five) and a row of 4 on the CPU (``kernels="torch"``),
     each row a mesh of its own: phase 7's queries give the stacked
     engine's rows on the card on all 8, and on the card's row the four
     chaos cases give its rows, completeness, reason, shard health and
     fetch retries; ``compressed_psum`` over each row's 4 against the
     single-process int8 sum (within 1e-6 of max|x|) and ``gpipe`` over the
     2-rank pod dim of a (4, 2) mesh against the two stages applied in
     order (within 1e-5); the card's row runs [analysis]'s rank-engine
     probe too;
  8. recsys — xDeepFM at its published widths (39 fields, 1,000,000 rows a
     field, embed 10, CIN 200-200-200, MLP 400-400, bag 4; random weights
     from seed 0) built on the card and served through ``make_serve_fns``:
     ``"score"`` at serve_p99 (B = 512) and serve_bulk (B = 262,144),
     ``"retrieve"`` at retrieval_cand (1 query × 1,000,000 candidates), with
     the counts zeroed before and read after (``cin_layer`` 3 per forward).
     TF32 is off for the plain versions (the kernel runs split TF32 on the
     tensor cores, its bound taken at the TF32 rate, the fp32 bound printed
     beside it). Each CIN layer at serve_p99 and the logits are held to the
     plain versions within ``1e-4 · max|plain|``; at serve_bulk each layer's
     and the logits' first 4,096 rows are; the smoke config gives the same
     logits on card and CPU. Each serve_p99 layer runs twice with identical
     bits, and is timed with its ``h`` range in 1 to 6 parts, each held
     within the same bound (the times behind ``cin.splits``' cost).

  9. gnn — an ogbn-products-shaped R-MAT (2,449,029 nodes, 30,929,570
     undirected draws symmetrized, seed 0; no cut of scale) served through
     ``make_serve_fns(cfg, model)["infer"]``: GIN-TU at its published widths
     (5 layers, d_hidden 64, learnable ε, 16 classes, d_in 100) on
     ``gnn_full_batch``, then GatedGCN (16 layers, d_hidden 70, d_edge 8,
     16 classes, d_in 602) on a ``minibatch_lg`` batch (``NeighborSampler``
     on the same graph, fanouts (15, 10), 1,024 seeds). Random weights from
     seed 0. The counts are zeroed before and read after each forward:
     ``segment_mp`` 5 per GIN forward and 32 per GatedGCN forward. TF32 is
     off. Logits and each first-layer aggregation are held to
     ``kernels="torch"`` within ``1e-4 · max|plain|``; the four kinds'
     smoke configs give the same outputs on card and CPU. Then the
     ``molecule`` shape: ``molecule_batch(128, 30, 2.15)`` (32 bonds drawn a
     molecule, 4,096 in all; every kept bond in both directions in 8,192
     slots, ``graph_id = node // 30``), GIN-TU and GatedGCN forwards at their
     published widths (d_in 32, graph task), counted alone (``segment_mp``
     7 and 34: a layer's 1 or 2, and 2 for the pooling), logits held to
     ``kernels="torch"`` within 1e-4 of each graph's scale;
 10. probe — the join probe's two kernels (``extras/join_probe/ops.py``
     ``lower_bound``, ``window``) on the inputs of the query path's largest
     ``hash_join_probe`` call, counted (each > 0), bit-exact against their
     plain versions there and on adversarial cases (keys ≥ 2^31, a
     power-of-two build side whose duplicate run fills the window,
     ``dup_cap > capA``, dup_cap 1, 17 and 67 with capB 1, 1,003 and
     16,387), and in agreement with ``hash_join_probe``: the
     window's hits with both rows valid and equal key columns are its
     ``hit``, and the ``idx`` arrays are equal. Then the lower bound's host
     path step by step (``perf_counter_ns`` over 2,000 calls each), its
     CUDA-event time and ``torch.searchsorted``'s as medians of 10 runs (as
     every row) and also in turns (100 calls a turn), and each kernel's
     device time from a CUDA graph of 20 calls and from ``torch.profiler``,
     with `eager_times` beside it;
 11. lm — gemma-2b at its published widths and full depth (18 layers,
     d_model 2048, 8 query heads on 1 kv head, head_dim 256, d_ff 16384
     GeGLU, vocab 256,000 tied; 2,506,172,416 parameters, bf16; random
     weights from a generator seeded 0) served through
     ``make_serve_fns(cfg, model)``: ``"prefill"`` of 2 × 8,192
     ``lm_batch`` tokens (seed 0; a cut of prefill_32k, 32,768 × 32, whose
     logits alone would be 537 GB), then 32 greedy ``"decode"`` steps into
     a cache of 8,224 slots grown from the prefill's. The counts are zeroed
     before and read after each: ``flash_attention``'s bf16 tensor-core
     route (``flash_attention_tc``) 18 per prefill, its split-TF32 route
     (``flash_attention_tf32``) and its FMA route 0; all three 0 in decode.
     Each of the prefill's 18 attentions goes through the tensor-core route
     again and is held to ``mha_reference`` within ``2e-2 ·`` each output
     row's max|plain|; N(0,1) inputs at gemma's heads (fp32 through the
     split-TF32 route within 2e-5, the FMA kernel on the same call likewise,
     bf16 through the tensor-core route within 2e-2 of the row's max) and at
     qwen2-72b's (64 on 8, head_dim 128, B = 1, S = 4,096, window 1,024,
     softcap 30) likewise, each call failing if another route moved. The
     FMA route's own shapes (fp32 head_dim 250, bf16 128 query heads on 1),
     counted through ``Kernels.flash_attention`` (2 FMA launches, the
     others 0), within the same bounds. The fp32 model (TF32 off, 1 × 2,048
     tokens; 18 split-TF32 launches, the others 0, counted) is held layer by
     layer:
     each layer's output and the logits within ``1e-4 ·`` each row's
     max|plain|, with that layer's attention by the kernel and by the plain
     version on one shared input.
     Printed, not held: the bf16 served logits and greedy tokens against
     ``kernels="torch"``, and the free-running fp32 logits against the
     plain and a float64 plain forward (this init amplifies any rounding
     difference ~30× a layer); prefill and decode-step times, device time
     by kernel, peak memory. The tensor-core route's row is timed on the
     served path's layer-0 attention (the FMA route timed on the same call
     beside it), with SDPA (``is_causal``, ``enable_gqa``) on
     pre-transposed inputs as ``library_ms`` and its bound at the bf16
     tensor-core rate; the split-TF32 route's row on the fp32 N(0,1) call at
     gemma's heads, its bound at the TF32 tensor-core rate (split TF32's three
     products, Q·Kᵀ alone at the fp32 rate — that route sums the logits in
     fp32 FMAs — and the fp32 CUDA-core bound printed beside it), and the FMA
     route's row on that same call (its launches those of its own shapes),
     its bound at the fp32 CUDA-core rate; both with fp32 SDPA as
     ``library_ms``, and both also timed by a CUDA graph (5 and 3 calls).
 12. moe-mla — the MoE and MLA LM families served through
     ``make_serve_fns(cfg, model)`` at their published widths, bf16,
     random weights from a generator seeded 0, each cut in depth only
     (`MOE_MLA_SERVE`): deepseek-v3-671b at 5 of its 61 layers (its 3
     dense layers and 2 MoE layers, all 256 experts; MLA, 128 heads),
     ``"prefill"`` of 2 × 2,048 ``lm_batch`` tokens; mixtral-8x22b at 4 of
     its 56 layers (8 experts top-2, GQA 48 on 8, window 4,096), 1 × 8,192
     tokens, twice its window; then 16 greedy ``"decode"`` steps each into
     a cache grown from the prefill's. The counts are zeroed before and
     read after each: ``flash_attention_tc`` once a layer a prefill (5, 4),
     the other routes 0, and all three 0 in decode. Held: each prefill
     attention again through the tensor-core route against
     ``mha_reference`` (a chunk of kv heads at a time, `plain_attention`)
     within ``2e-2 ·`` each output row's max|plain|; N(0,1) inputs at MLA's
     attention shape (2 × 2,048, 128 heads on 128, q/k head dim 192, v 128)
     through ``routed``: bf16 on the tensor-core route within 2e-2, fp32 on
     the split-TF32 route within 2e-5; finite logits of the right shape
     and dtype, the caches' shapes after the prefill and after decode
     (MLA: ``c_kv (5, 2, 2048, 512)``, ``k_rope (5, 2, 2048, 64)``, then
     2,064 slots); the two smoke configs (fp32, TF32 off) give the same
     prefill and decode logits on card and CPU within ``1e-4 ·`` each
     row's max|cpu|. Printed, not held: prefill ms and tokens/s, decode-step
     ms, device time by kernel, peak memory; each MoE layer's share of
     assignments dropped at capacity factor 1.25 and its least and most
     loaded expert; the MLA-shape kernel's time beside its bound (and the
     operations the tensor-core route executes with head dims padded to
     256) and SDPA's; the bf16 decode logits against a teacher-forced
     prefill's at the same position.
 13. train — `make_train_step` (AdamW at its defaults, warm-up 1: step 0
     at lr 0 must move no parameter, the later steps every one), each
     step's launch counts zeroed before and read after it: gemma-2b at
     its published widths and full depth (18 layers, bf16, remat a layer,
     random weights; 4 steps of 2 × 2,048 ``lm_batch`` tokens, `LM_TRAIN`):
     ``flash_attention_tc`` 36 a step (18 in the forward, 18 in remat's
     recomputation; the backward's vjp is the plain version's), the other
     routes 0; its step 0 held to the same step with ``kernels="torch"``
     (the loss at full depth, the gradient a layer at a time on shared
     inputs, `STEP0_TOL`); step ms, tokens/s, peak memory, a step split
     into forward, backward (and the plain attention vjp's share of it)
     and optimizer by CUDA events, one traced step. xDeepFM at its
     published widths and train batch (65,536, `RECSYS_TRAIN`, 3 steps):
     ``cin_layer`` 9 a step (3 forward, 6 backward). GatedGCN at its
     published widths on `[gnn]`'s ``minibatch_lg`` batch (3 steps):
     ``segment_mp`` 32 a step. Each autograd Function at its path's shapes
     against autograd of the plain version on the card (`function_check`):
     attention at gemma's layer-0 shape in bf16 and fp32, exact (the same
     vjp); ``cin_layer`` at xDeepFM's layer 1 and a 200-wide layer, within
     1e-4 of each row's scale; ``segment_mp`` on GatedGCN's first
     aggregation, exact. Then `TrainSupervisor` at gemma-2b's smoke config:
     preempted at step 3 of 6 and restarted from its step-2 checkpoint
     (under ``build/``), bit-identical to an uninterrupted run. The
     full-width runs write no checkpoint.
  examples — each ``examples/torch_*.py`` ``main()`` on the card at its
     default size, counted alone: the three matcher examples launch the
     matcher's five kernels (the served workload with no failed outcome),
     the training example's attention route launches once a layer a step;
  dryrun — ``dryrun.run_cell`` for every cell, in this process on the
     host (meta tensors), after the card's other phases: a line a arch ×
     shape cell (priced peak, whether it fits the card's memory, FLOPs,
     model FLOPs, the roofline's terms), 0 failed, every skipped cell one
     of its arch's ``skipped_shapes``; then each of `DRYRUN_CARD_CELLS` run
     once on the card from its cell's shapes, its ``max_memory_allocated``
     within `DRYRUN_BAND` of the priced peak where it is at least 256 MB;
  tp — gemma-2b at its published widths (bf16, seed 0) on a (data=2,
     model=2) mesh of 4 gloo ranks sharing ``cuda:0`` (`TP`), served
     through ``make_serve_fns``: the prefill of `LM_SERVE`'s 2 × 8,192
     tokens, then 32 decode steps under the decode rules. Held: each
     rank's launches (``flash_attention_tc`` 18 a prefill, the FMA route
     0), its parameter bytes as ``param_pspecs`` imply; on the one-card
     model's shared inputs, each prefill layer, each layer's attention
     (before ``wo``) and each first-decode-step layer within 2e-2 of each
     row's max; ``flash_attention_tc`` on every rank's ``(batch, heads)``
     block of each layer's one-card inputs within 2e-2 of
     ``mha_reference``; the fp32 2-layer model (TF32 off) within 1e-4 of
     the one-card layer in the mesh's GEMM blocks with the plain attention
     (`blocked_layer`), and within 1.5× that layer's distance of the
     one-card layer as served;
  dryrun-mesh — ``python -m repro_torch.extras.dryrun --mesh single-pod``
     and ``multi-pod`` ``--all`` in subprocesses: a record under ``--out``
     for every cell, the 12 dense-LM serving cells priced, every other
     refused naming its ``ROADMAP.md`` item, and each priced cell's
     per-chip parameter bytes equal to ``schema.rank_bytes``;

Before the last line it prints the fourteen kernels as one JSON object, then
the ``nvidia-smi`` name/power-limit line; the last line is
``{"ok": true, "device": {...}}``. It imports neither ``jax`` nor the JAX
package.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100 SXM data-sheet rates and the models' useful FLOPs, from the
# port's roofline (one source)
from repro_torch.analysis.roofline import (  # noqa: E402
    BF16_FLOPS as BF16_OPS_PER_S,
    FP32_FLOPS as CUDA_CORE_OPS_PER_S,
    HBM_BW as HBM_BYTES_PER_S,
    TF32_FLOPS as TF32_OPS_PER_S,
    model_flops_lm,
    model_flops_recsys,
    peak_for,
)

MATCHER_KERNELS = ("stwig_expand", "hash_join_probe", "bitset_lookup", "bitset_build",
                   "bitset_pack")
PATENTS = dict(n_nodes=3_774_768, n_edges=16_522_438, n_labels=418, seed=0)
# ogbn-products' counts (GNN_SHAPES["ogb_products"]): the edge count is
# directed, so half of it is drawn and symmetrized; 47 labels (its classes)
PRODUCTS = dict(n_nodes=2_449_029, n_edges=61_859_140 // 2, n_labels=47, seed=0)
# gemma-2b served at a cut of prefill_32k (32,768 tokens × batch 32): 2 prompts of
# 8,192 tokens, then 32 greedy decode steps into a cache of 8,224 slots
LM_SERVE = dict(batch=2, seq=8192, decode=32)
# deepseek-v3 (61 layers, 1,342.5 GB in bf16) and mixtral-8x22b (56 layers, 281.3 GB)
# served at their published widths, cut in depth only: deepseek's 3 dense layers
# and 2 MoE layers (all 256 experts; 53.4 GB), 2 prompts of 2,048 tokens;
# mixtral's first 4 layers (20.8 GB), 1 prompt of 8,192 tokens (twice its
# 4,096-token window); 16 greedy decode steps each
MOE_MLA_SERVE = {"deepseek-v3-671b": dict(n_layers=5, batch=2, seq=2048, decode=16),
                 "mixtral-8x22b": dict(n_layers=4, batch=1, seq=8192, decode=16)}
# [small]'s 4 shards on the CPU: every shard probes the fetched tables of all
# four, so the tables are kept small there (on the card too, for the same rows)
SMALL_SHARDED_CAPS = dict(emission_budget=1 << 12, join_rows_cap=1 << 14)
# [chaos]'s and [ranks-small]'s seeded faults on the small graph's 4 shards
CHAOS_FAULTS = {
    "dead shard 1, never heals": dict(dead_shard=1),
    "dead shard 2, heals after 2 attempts": dict(dead_shard=2, dead_heals_after=2),
    "shard 3's fetch truncated to keep_frac 0.5": dict(truncate_shard=3,
                                                     truncate_keep_frac=0.5),
    "shard 0 slow (5 ms)": dict(slow_shard=0, slow_delay_s=0.005),
}
# [ranks]: one gloo rank a shard of [sharded]'s 16, every rank on cuda:0
RANKS = 16
# [ranks-small]: compressed_psum's gradients (4 ranks) and gpipe's 2 stages
RANKS_SMALL = dict(ranks=4, grad=(64, 1000), stages=2, micro=4, mb=8, d=64)
# [tp]: gemma-2b at its published widths served on a (data=2, model=2) mesh of
# 4 gloo ranks sharing cuda:0 ([lm]'s 2 prompts of 8,192 tokens, one a data
# rank, then [lm]'s 32 decode steps); fp32 at full width cut to 2 layers on
# 2 x 2,048 tokens
TP = dict(mesh={"data": 2, "model": 2}, fp32_layers=2, fp32_seq=2048)
# gemma-2b trained at its published widths and full depth: 4 steps of 2 x 2,048
# lm_batch tokens; xDeepFM at its train_batch (65,536, the JAX package's
# extras/shapes.py); GatedGCN on [gnn]'s minibatch_lg batch
LM_TRAIN = dict(batch=2, seq=2048, steps=4)
RECSYS_TRAIN = dict(batch=65536, steps=3)
GNN_TRAIN = dict(steps=3)
# gemma-2b's step 0 with kernels="cuda" against kernels="torch" (relative): the
# two differ only in the forward attention's rounding (bf16 P on the tensor
# cores), which the random init amplifies ~30x a layer ([lm]). The loss, a mean
# over 4,094 tokens, is held at full depth (1.2e-3 apart on the card); the
# gradient is held a layer at a time on shared inputs (1.0e-4 and 7.9e-3 apart:
# the input gradient moves by about one bf16 ulp, 7.8e-3). Its norm at full
# depth differs ~10x between the two roundings, so that is printed, not held
STEP0_TOL = dict(loss=1e-2, layer_grad_norm=1e-3, layer_input_grad=3e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms_turns(fn_a, fn_b, reps: int = 100) -> tuple[float, float]:
    """CUDA-event medians of ``fn_a`` and ``fn_b`` timed in turns (a, b, b,
    a), ``reps`` calls a turn: one call's time, host path included."""
    runs = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        fn = (fn_a, fn_b)[i]
        fn()
        torch.cuda.synchronize()
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            runs[i].append(a.elapsed_time(b))
    return statistics.median(runs[0]), statistics.median(runs[1])


def graph_ms(fn, n: int = 20) -> float:
    """Device ms a call of ``fn``: ``n`` calls captured in one CUDA graph
    (after a warm-up on a side stream), the median of 5 replays over ``n``.
    A replay costs the host almost nothing, so this is the kernels' time
    back to back; and it runs only what the capture recorded on the current
    stream, so it also shows the launches went there."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def host_us(fn, n: int = 2000) -> float:
    """Host µs a call of ``fn``: ``perf_counter_ns`` over ``n`` calls, a
    sync after every 100 (outside the timed span)."""
    total = 0
    for _ in range(n // 100):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(100):
            fn()
        total += time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return total / n / 1e3


def eager_times(fn) -> str:
    """Where a call's CUDA-event time goes: the host µs a call (`host_us`),
    the ms a call of 100 calls between two events (the larger of the
    device's time a call in eager mode and the host's launch interval),
    and the median ms of 10 single calls each timed behind ~0.2 ms of
    queued work (the start event then waits on the card, not on the host
    path)."""
    spin = torch.empty(1 << 26, device="cuda")
    one = []
    for _ in range(10):
        spin.mul_(1.0)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        one.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(100):
        fn()
    b.record()
    b.synchronize()
    return (f"host {host_us(fn):.3f} µs a call; 100 calls back to back "
            f"{a.elapsed_time(b) / 100:.4f} ms a call; a call behind queued work "
            f"{statistics.median(one):.4f} ms")


def same_bytes(fn, what: str) -> str:
    """A yardstick for a kernel's device time: one PyTorch elementwise
    kernel that moves about the bytes of the kernel's bound (its streamed
    inputs and its output) on the same tensors, in the same cache state, by
    a CUDA graph of 20 calls (`graph_ms`)."""
    return (f"{what}, one PyTorch kernel moving about the bound's bytes: "
            f"{graph_ms(fn):.4f} ms by graph")


def device_profile(fn, reps: int = 3):
    """One `torch.profiler` trace of ``reps`` calls of ``fn`` after a
    warm-up: (device ms a call, the device's busy share of the span from
    its first kernel's start to its last kernel's end, the six kernels
    with the most device time as (name, ms a call)); or, when the trace
    holds no device kernel or cannot be read, why not. It is a measurement
    only: nothing is checked by it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    try:
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kernels:
            return "the trace held no device kernel"
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    except AttributeError as exc:  # the trace's event API differs across PyTorch versions
        return f"the trace could not be read: {exc}"
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (busy / reps / 1e3, busy / max(span, 1e-9),
            [(name[:70], us / reps / 1e3) for name, us in top])


def profile_line(prof) -> str:
    if isinstance(prof, str):
        return f"device time not measured ({prof})"
    ms, busy, top = prof
    return (f"device time {ms:.4f} ms a call, busy {100 * busy:.1f}% of its span; top kernels "
            f"{[(n, round(t, 4)) for n, t in top]}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- phase 1
def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    return name, smi


def flops_share(model_flops: float, ms: float, rate: str, smi: str) -> str:
    """A step's model FLOPs (`repro_torch.analysis.roofline.model_flops_*`)
    over its measured time, as a share of the H100's peak for ``rate``, on
    the card ``smi`` names (its name and power limit, from nvidia-smi)."""
    per_s = model_flops / (ms / 1e3)
    return (f"model FLOPs {model_flops:.6g} in {ms:.4f} ms: {per_s / 1e12:.3f} TFLOP/s, "
            f"{100 * per_s / peak_for(rate):.2f}% of the {rate} peak "
            f"({peak_for(rate) / 1e12:g} T/s) on {smi}")


# ---------------------------------------------------------------- phase 2
BUILD_MSGS: dict[str, str] = {}  # ptxas's messages by source, from phase 2


def ptxas_usage(source: str, kernel: str) -> str:
    """Registers and spills ptxas reported for the first kernel of
    ``source`` whose mangled name holds ``kernel``."""
    found = False
    spills = "spills not reported"
    for line in BUILD_MSGS.get(source, "").splitlines():
        if "Compiling entry" in line:
            found = kernel in line
        elif found and "spill" in line:
            spills = line.strip()
        elif found and "Used " in line:
            return f"{line.split('Used ')[1].split(',')[0]}, {spills}"
    return "registers not reported"


def phase_build() -> None:
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    msgs = cuda.build(ptxas_verbose=True)
    BUILD_MSGS.update(msgs)
    log(f"[build] {len(msgs)} sources built in {time.perf_counter() - t0:.2f} s "
        f"into {cuda.BUILD_DIR.relative_to(ROOT)}")
    for src, text in msgs.items():
        for line in text.splitlines():
            if "Used " in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {src}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def embedding_check(g, edge_keys: np.ndarray, q, rows: np.ndarray) -> None:
    """Every row maps query node i to a data node of label q.labels[i],
    injectively, and every query edge to a data edge."""
    if rows.shape[1] != q.n_nodes or (rows < 0).any():
        fail(f"rows of shape {rows.shape} / ghost ids for a {q.n_nodes}-node query")
    if not (g.labels[rows] == np.asarray(q.labels)[None, :]).all():
        fail("a row maps a query node to a node of another label")
    srt = np.sort(rows, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        fail("a row maps two query nodes to one data node")
    for u, v in q.edges:
        key = rows[:, u].astype(np.int64) * g.n_nodes + rows[:, v]
        pos = np.searchsorted(edge_keys, key)
        if not (edge_keys[np.minimum(pos, len(edge_keys) - 1)] == key).all():
            fail(f"a row maps query edge ({u},{v}) to a non-edge")


def make_queries(g, n: int = 8, seed: int = 0):
    from repro_torch.workloads import dfs_query

    rng = np.random.default_rng(seed)
    qs = []
    while len(qs) < n:
        q = dfs_query(g, rng, int(rng.integers(4, 7)))
        if q is not None and q.n_nodes >= 4:
            qs.append(q)
    return qs


def run_queries(session, queries, stream_q):
    """The queries with ``max_matches=1024, adaptive=False``, then one stream
    consumed to its end. Returns (rows per query, stream rows, report)."""
    out, report = [], []
    for i, q in enumerate(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = session.compile(q, max_matches=1024).run(adaptive=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out.append(res.rows)
        st = {k: round(v * 1e3, 3) for k, v in res.stats.stage_times.items()}
        report.append(
            f"q{i} nodes={q.n_nodes} stwigs={len(res.stats.rounds)} rounds={res.stats.rounds} "
            f"matches={res.n_matches} complete={res.complete} ms={ms:.3f} stage_ms={st}"
        )
    t0 = time.perf_counter()
    pages = list(session.compile(stream_q, max_matches=1024).stream(page_size=256))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    srows = [p.rows for p in pages]
    report.append(f"stream pages={len(pages)} rows={sum(len(r) for r in srows)} ms={ms:.3f}")
    return out, srows, report


def repeat_times(session, queries, reps: int = 3) -> list[str]:
    """Each query run ``reps`` more times after the counted run: the median
    wall ms, the median of each stage and the explore stage's median ms per
    exploration round (one ``stwig_expand`` and one ``bitset_build`` each),
    past first-call warm-up; last, the median of that over the queries."""
    report, per_round = [], []
    for i, q in enumerate(queries):
        compiled = session.compile(q, max_matches=1024)
        wall, stages, explore = [], {}, []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = compiled.run(adaptive=False)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            for k, v in res.stats.stage_times.items():
                stages.setdefault(k, []).append(v * 1e3)
            explore.append(res.stats.stage_times["explore"] * 1e3 / sum(res.stats.rounds))
        st = {k: round(statistics.median(v), 3) for k, v in stages.items()}
        per_round.append(statistics.median(explore))
        report.append(f"q{i} median of {reps} repeats: ms={statistics.median(wall):.3f} "
                      f"(runs {[round(x, 3) for x in wall]}) stage_ms={st} "
                      f"explore_ms_per_round={per_round[-1]:.3f} over {sum(res.stats.rounds)} "
                      f"rounds")
    report.append(f"explore ms per round, median over the {len(queries)} queries: "
                  f"{statistics.median(per_round):.3f} (each query's: "
                  f"{[round(x, 3) for x in per_round]})")
    return report


# ---------------------------------------------------------------- phase 4
def recording_kernels():
    """The plain PyTorch backend, keeping the inputs of each op's largest
    call (they are the main path's real inputs)."""
    from repro_torch.core.backend import Kernels

    class Recording(Kernels):
        def __init__(self):
            self.calls = {}
            self.masks = []  # (length, data_ptr mod 16) of every mask_to_host call
            self.expands = []  # (args, kw, cnt) of every stwig_expand call
            # ((ids, valid, nwords), words) of every bitset_build call: a
            # round's (n, width) columns and their (width, nwords) bitsets
            self.builds = []

        def _keep(self, op, size, args, kw):
            if size > self.calls.get(op, (-1,))[0]:
                self.calls[op] = (size, args, kw)

        def mask_to_host(self, mask):  # the matcher's only bitset_pack caller
            self._keep("bitset_pack", mask.numel(), (mask,), {})
            self.masks.append((mask.numel(), mask.data_ptr() % 16))
            return super().mask_to_host(mask)

        def bitset_lookup(self, words, ids):
            self._keep("bitset_lookup", ids.numel(), (words, ids), {})
            return super().bitset_lookup(words, ids)

        def bitset_build(self, ids, valid, nwords):
            self._keep("bitset_build", ids.numel(), (ids, valid, nwords), {})
            words = super().bitset_build(ids, valid, nwords)
            self.builds.append(((ids, valid, nwords), words))
            return words

        def stwig_expand(self, *args, **kw):
            self._keep("stwig_expand", args[0].shape[0] * args[1].numel(), args, kw)
            cand, cnt = super().stwig_expand(*args, **kw)
            self.expands.append((args, kw, cnt))
            return cand, cnt

        def hash_join_probe(self, *args, dup_cap):
            self._keep("hash_join_probe", args[3].numel() * dup_cap, args, {"dup_cap": dup_cap})
            return super().hash_join_probe(*args, dup_cap=dup_cap)

    return Recording()


# ---------------------------------------------------------------- phase 5
def adversarial_cases(dev):
    """Small cases of the CPU tests, on the card: (op, args, kwargs), and
    for some ``hash_join_probe`` cases the route the kernel must take."""
    from repro_torch.kernels.bitset.ref import n_words

    rng = np.random.default_rng(0)

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(dev)

    W = 64
    n_bits = W * 32
    ids = np.concatenate([rng.integers(0, n_bits, 256),
                          [0, n_bits - 1, n_bits, n_bits + 31, -1, -32, -(2**31), 2**31 - 1]])
    words = rng.integers(0, 2**32, W, dtype=np.uint32)
    bids = rng.integers(-2 * n_bits, n_bits + 40, 500).astype(np.int32)
    bids[:4] = [-1, -n_bits, -(2**31), 2**31 - 1]
    E, cap, n_total = 64, 5, 100
    indptr = np.zeros(cap + 2, np.int32)
    indptr[1:] = E
    rng2 = np.random.default_rng(3)  # a round's 7 columns, negative ids too
    bids2 = rng2.integers(-2 * n_bits, n_bits + 40, (500, 7)).astype(np.int32)
    bids2[:4, 0] = [-1, -n_bits, -(2**31), 2**31 - 1]
    ka = np.array([0, 5, 5, 5, 5, 5, 5, 9], np.uint32)
    big = np.sort(rng.integers(0, 2**32, 64, dtype=np.uint64)).astype(np.uint32)
    big[-3:] = 0xFFFFFFFF
    # sixteen ids a thread: ragged lengths (1,000,008 ends 8 past a group, as
    # the main path's edge count does), starts 1-15 ids past a 16-byte
    # boundary, ids out of range on group boundaries
    tw = t(words)
    lookups = [("bitset_lookup", (tw, t(group_ids(rng, n, W))), {})
               for n in (15, 16, 17, 1_000_008)]
    base = t(group_ids(rng, 1100, W))
    lookups += [("bitset_lookup", (tw, base[off:off + 1000]), {}) for off in range(1, 16)]
    return [
        ("bitset_lookup", (tw, t(ids.astype(np.int32))), {}),
        *lookups,
        ("bitset_build", (t(bids), t(rng.random(500) < 0.7), W), {}),
        ("bitset_build", (t(bids2), t(rng2.random(500) < 0.7), W), {}),
        ("bitset_pack", (t(rng.random(4096) < 0.4),), {}),
        ("stwig_expand", (t(np.full((2, n_words(n_total + 1)), 0xFFFFFFFF, np.uint32)),
                          t(np.arange(E, dtype=np.int32)), t(np.full(E, 1, np.int32)),
                          t(indptr), t(np.ones(E, bool))),
         dict(child_labels=(1, 1), child_bound=(True, False), child_cap=3, cap=cap,
              n_total=n_total)),
        skewed_expand_case(t, np.random.default_rng(1), k=16, C=1),
        skewed_expand_case(t, np.random.default_rng(2), k=4, C=8),
        ("hash_join_probe", (t(ka), t(np.full((8, 1), 5, np.int32)), t(np.ones(8, bool)),
                             t(np.array([5], np.uint32)), t(np.array([[5]], np.int32)),
                             t(np.ones(1, bool))), dict(dup_cap=6)),
        ("hash_join_probe", (t(big), t(rng.integers(0, 3, (64, 1)).astype(np.int32)),
                             t(rng.random(64) < 0.9),
                             t(np.concatenate([big[::3], [0, 0xFFFFFFFF, 2**31]]).astype(np.uint32)),
                             t(rng.integers(0, 3, (25, 1)).astype(np.int32)),
                             t(np.ones(25, bool))), dict(dup_cap=4)),
        # both routes of the kernel (build side vs the 102,400-byte budget),
        # dup_cap not a multiple of 16, capB not a multiple of the tile, nk 3
        join_case(t, 5, 16_384, 3000, 1, 64, "global"),  # 147,456 B
        join_case(t, 6, 4096, 3000, 5, 16, "shared"),    # 102,400 B: exactly at the budget
        join_case(t, 7, 4097, 3000, 5, 16, "global"),    # one row above it
        join_case(t, 8, 8192, 2000, 1, 1, "shared"),
        join_case(t, 9, 8192, 1000, 1, 5, "shared"),
        join_case(t, 10, 8192, 1000, 2, 100, "global"),
        join_case(t, 11, 3000, 1000, 3, 16, "shared"),   # nk 3
        join_case(t, 12, 8000, 999, 3, 5, "global"),     # nk 3
    ]


def group_ids(rng, n: int, W: int) -> np.ndarray:
    """``n`` int32 ids over ``W`` words, 100 past either end, with -1, 32·W
    and 2^31 - 1 on boundaries of the kernels' groups of sixteen."""
    ids = rng.integers(-100, 32 * W + 100, n).astype(np.int32)
    for i, x in zip((0, 15, 16, 31, 32, 47, n - 1),
                    (2**31 - 1, -1, 32 * W, 2**31 - 1, -1, 32 * W, 2**31 - 1)):
        if i < n:
            ids[i] = x
    return ids


def filter_checks(cuda_k, plain, dev) -> str:
    """``candidate_filter`` off the main path's shapes, bit-exact against
    its plain version: ragged lengths, ``root_ok`` all false, all true and
    on ~1 edge in 418 in runs by source, each edge array in turn (then all
    three) starting 1-15 elements past a 16-byte boundary, and ids out of
    range on group boundaries throughout. Returns what it checked."""
    rng = np.random.default_rng(5)
    W = 37

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x).to(dev)

    def check(args, what):
        if not torch.equal(cuda_k.candidate_filter(*args), plain.candidate_filter(*args)):
            fail(f"candidate_filter differs from its plain version ({what})")

    words = t(rng.integers(0, 2**32, W, dtype=np.uint32))

    def edges(n, rok):
        return (t(group_ids(rng, n, W)), t(rng.integers(0, 3, n).astype(np.int32)), t(rok))

    lengths = (15, 16, 17, 1_000_008)
    for n in lengths:
        check((words, *edges(n, rng.random(n) < 0.8), 2), f"{n} edges")
    n = 1_000_008
    kinds = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
             "1 in 418 by source": np.repeat(rng.random(n) < 1 / 418,
                                             rng.integers(1, 41, n))[:n]}
    for kind, rok in kinds.items():
        dst, lab, rk = edges(n, rok)
        for label in (0, 1, 2):
            check((words, dst, lab, rk, label), f"root_ok {kind}, label {label}")
    dst, lab, rok = edges(1100, np.ones(1100, bool))
    lab = torch.where(lab == 0, 2, lab)
    names = ("dst_ids", "dst_labels", "root_ok", "all three")
    for off in range(1, 16):
        for which, name in enumerate(names):
            cut = [x[off:off + 1000] if which in (i, 3) else x[:1000]
                   for i, x in enumerate((dst, lab, rok))]
            check((words, *cut, 2), f"{name} starting {off} elements in")
    torch.cuda.synchronize()
    return (f"ragged lengths {list(lengths)}; root_ok {list(kinds)} on {n} edges, labels 0-2; "
            f"{' / '.join(names)} starting 1-15 elements past a 16-byte boundary (1,000 edges); "
            f"ids -1, 32 x W, 2^31 - 1 on group boundaries")


def join_case(t, seed: int, cap_a: int, cap_b: int, nk: int, dup: int, route: str):
    """``hash_join_probe`` on a sorted build side with duplicate runs (its
    last key 0xFFFFFFFF), probe keys half from it and half random, ~10% of
    rows invalid on each side, key columns of 3 values; ``route`` is the
    one the kernel must take (``hash_join.last_route``)."""
    rng = np.random.default_rng(seed)
    ka = (np.sort(rng.integers(0, cap_a // 3 + 1, cap_a)).astype(np.uint64) * 977).astype(np.uint32)
    ka[-1] = 0xFFFFFFFF
    kb = np.where(rng.random(cap_b) < 0.5, ka[rng.integers(0, cap_a, cap_b)],
                  rng.integers(0, 2**32, cap_b, dtype=np.uint64).astype(np.uint32))
    return ("hash_join_probe", (
        t(ka), t(rng.integers(0, 3, (cap_a, nk)).astype(np.int32)), t(rng.random(cap_a) < 0.9),
        t(kb.astype(np.uint32)), t(rng.integers(0, 3, (cap_b, nk)).astype(np.int32)),
        t(rng.random(cap_b) < 0.9)), dict(dup_cap=dup), route)


def skewed_expand_case(t, rng, k: int, C: int):
    """``stwig_expand`` on a 60,000-edge row (~30 tiles), a run of 10,000
    empty rows and a pad tail owned by the ghost row; the long row's
    survivors for child 0 straddle a tile boundary at ranks C-1 | C."""
    from repro_torch.kernels.bitset.ref import n_words
    from repro_torch.kernels.stwig_expand.stwig_expand import TILE

    n_total = 20000
    deg = rng.integers(0, 3000, 500)
    deg[7] = 60_000
    deg = np.concatenate([deg[:100], np.zeros(10_000, deg.dtype), deg[100:]])
    E = int(deg.sum()) + 13
    indptr = np.concatenate([[0], np.cumsum(deg), [E]]).astype(np.int32)
    labels = tuple(int(x) for x in rng.integers(0, 3, k))
    lab = rng.integers(0, 3, E).astype(np.int32)
    rok = rng.random(E) < 0.9
    first = -(-(7 + int(indptr[7])) // TILE) * TILE - 7  # row 7's first edge of the next tile
    lab[indptr[7]:first - C] = 3  # no child's label
    lab[first - C:first + 1] = labels[0]
    rok[first - C:first + 1] = True
    return ("stwig_expand", (
        t(rng.integers(0, 2**32, (k, n_words(n_total + 1)), dtype=np.uint32)),
        t(rng.integers(0, n_total, E).astype(np.int32)), t(lab), t(indptr), t(rok)),
        dict(child_labels=labels, child_bound=tuple(bool(i % 2) for i in range(k)),
             child_cap=C, cap=len(deg), n_total=n_total))


def max_abs_err(a, b) -> int:
    outs_a = a if isinstance(a, tuple) else (a,)
    outs_b = b if isinstance(b, tuple) else (b,)
    err = 0
    for x, y in zip(outs_a, outs_b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"shape/dtype mismatch {tuple(x.shape)} {x.dtype} vs {tuple(y.shape)} {y.dtype}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def work(op, args, kw) -> tuple[int, float]:
    """(bytes the op must move: inputs once, outputs once; integer ops)."""
    if op == "bitset_lookup":
        words, ids = args
        return nbytes(words, ids) + ids.numel(), 6.0 * ids.numel()
    if op == "bitset_build":
        ids, valid, nwords = args  # ids (n,) or a round's (n, width) columns
        width = ids.shape[1] if ids.dim() == 2 else 1
        return nbytes(ids, valid) + 4 * width * nwords, 6.0 * ids.numel()
    if op == "bitset_pack":
        (mask,) = args
        return nbytes(mask) + 4 * -(-mask.numel() // 32), 2.0 * mask.numel()
    if op == "stwig_expand":
        # read lazily, as candidate_filter's entry counts: every root_ok and
        # indptr, the labels of root_ok edges, the dst ids of edges whose
        # label is a child's and, for a bound child, the bitset words its
        # matches land in; all of cand and cnt written
        words_k, dst, lab, indptr, rok = args
        k, C, cap = words_k.shape[0], kw["child_cap"], kw["cap"]
        ok = rok.bool()
        n_rok = int(ok.sum())
        match = torch.zeros_like(ok)
        n_words = 0
        for c, (label, bound) in enumerate(zip(kw["child_labels"], kw["child_bound"])):
            m = ok & (lab == label)
            match |= m
            if bound:
                w_idx = dst[m].long() >> 5
                n_words += torch.unique(w_idx[(w_idx >= 0) & (w_idx < words_k.shape[1])]).numel()
        n_match = int(match.sum())
        out = 4 * k * ((cap + 1) * C + cap)
        return (dst.numel() + nbytes(indptr) + 4 * n_rok + 4 * n_match + 4 * n_words + out,
                dst.numel() + 2.0 * k * n_rok + 6.0 * k * n_match)
    if op == "hash_join_probe":
        ka, akeys, avalid, kb, bkeys, bvalid = args
        dup = kw["dup_cap"]
        steps = max(1, ka.numel().bit_length())
        ops = kb.numel() * (4.0 * steps + dup * (4.0 + 2 * akeys.shape[1]))
        return nbytes(*args) + 5 * kb.numel() * dup, ops
    if op == "bitset_unpack":
        (words,) = args
        return nbytes(words) + 32 * words.numel(), 3.0 * 32 * words.numel()
    if op == "candidate_filter":
        # `root_ok ∧ label == l ∧ bit(dst)` short-circuits: every edge reads
        # root_ok and writes its bool, the root_ok edges read their label,
        # the label matches their dst id and the bitset words it lands in
        words, dst, lab, rok, label = args
        ok = rok.bool()
        match = ok & (lab == label)
        w_idx = dst[match].long() >> 5
        n_words = torch.unique(w_idx[(w_idx >= 0) & (w_idx < words.numel())]).numel()
        n_rok, n_match = int(ok.sum()), int(match.sum())
        return (2 * dst.numel() + 4 * n_rok + 4 * n_match + 4 * n_words,
                dst.numel() + 2.0 * n_rok + 6.0 * n_match)
    if op == "cin_layer":
        xk, x0, w = args
        B, H, d = xk.shape
        out = 4 * B * w.shape[1] * d
        # z = xk ⊗ x0 (one multiply per z element) and the FMA contraction
        return nbytes(xk, x0, w) + out, B * d * H * x0.shape[1] * (1.0 + 2.0 * w.shape[1])
    if op == "segment_mp":
        msg, dst, n = args
        return nbytes(msg, dst) + 4 * n * msg.shape[1], float(msg.numel())
    if op == "probe_lower_bound":
        ka, kb = args
        return nbytes(ka, kb) + 4 * kb.numel(), 4.0 * max(1, ka.numel().bit_length()) * kb.numel()
    if op == "probe_window":
        ka, kb, lo = args
        dup = kw["dup_cap"]
        return nbytes(ka, kb, lo) + 5 * kb.numel() * dup, 4.0 * kb.numel() * dup
    if op in ("flash_attention", "flash_attention_tc", "flash_attention_tf32"):
        # Q·Kᵀ and P·V over the (query, key) pairs the causal/window mask keeps
        q, k, v = args
        B, S, Nq, H = q.shape
        Hv = v.shape[-1]
        pairs = B * Nq * attention_pairs(S, kw.get("window"))
        return nbytes(q, k, v) + q.numel() // H * Hv * q.element_size(), pairs * (2.0 * H + 2.0 * Hv)
    raise KeyError(op)


def attention_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs with key ≤ query (and key > query - window) in one
    (batch, head) of S positions."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


# the rate each kernel's operation bound is taken at: fp32 CUDA cores, except
# the kernels on the tensor cores: attention's bf16 route at the bf16 rate,
# its fp32 route and the CIN layer (split TF32) at the TF32 rate; the fp32
# bounds (and split TF32's three products) are printed beside them
OPS_RATE = {"flash_attention_tc": BF16_OPS_PER_S, "flash_attention_tf32": TF32_OPS_PER_S,
            "cin_layer": TF32_OPS_PER_S}


def kernel_row(op, args, kw, launches, err, ms, plain_ms, library_ms=None) -> dict:
    b, ops = work(op, args, kw)
    t_bytes, t_ops = b / HBM_BYTES_PER_S * 1e3, ops / OPS_RATE.get(op, CUDA_CORE_OPS_PER_S) * 1e3
    source, replaces = KERNEL_INFO[op]
    return {
        "name": op, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


KERNEL_INFO = {
    "bitset_lookup": ("src/repro_torch/csrc/bitset.cu", "src/repro/kernels/bitset/bitset.py:81"),
    "bitset_build": ("src/repro_torch/csrc/bitset.cu", "src/repro/core/backend.py:263"),
    "bitset_pack": ("src/repro_torch/csrc/bitset.cu", "src/repro/kernels/bitset/bitset.py:57"),
    "stwig_expand": ("src/repro_torch/csrc/stwig_expand.cu",
                     "src/repro/kernels/stwig_expand/stwig_expand.py:173"),
    "hash_join_probe": ("src/repro_torch/csrc/hash_join.cu",
                        "src/repro/kernels/hash_join/hash_join.py:60"),
    "bitset_unpack": ("src/repro_torch/csrc/bitset.cu", "src/repro/kernels/bitset/bitset.py:34"),
    "candidate_filter": ("src/repro_torch/csrc/bitset.cu",
                         "src/repro/kernels/bitset/bitset.py:122"),
    "cin_layer": ("src/repro_torch/csrc/cin.cu", "src/repro/kernels/cin/cin.py:28"),
    "segment_mp": ("src/repro_torch/csrc/segment_mp.cu",
                   "src/repro/extras/segment_mp/segment_mp.py:43"),
    "probe_lower_bound": ("src/repro_torch/csrc/join_probe.cu",
                          "src/repro/extras/join_probe/join_probe.py:38"),
    "probe_window": ("src/repro_torch/csrc/join_probe.cu",
                     "src/repro/extras/join_probe/join_probe.py:80"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/extras/flash_attention/flash_attention.py:86"),
    "flash_attention_tc": ("src/repro_torch/csrc/flash_attention_tc.cu",
                           "src/repro/extras/flash_attention/flash_attention.py:86"),
    "flash_attention_tf32": ("src/repro_torch/csrc/flash_attention_tf32.cu",
                             "src/repro/extras/flash_attention/flash_attention.py:86"),
}


def pack_checks(cuda_k, plain, dev) -> str:
    """``bitset_pack`` off the main path's shapes: masks of ragged lengths
    through ``mask_to_host`` (the only caller that passes them: its words
    bit-exact against the plain version of the zero-padded mask, its host
    bools equal to the mask), and masks whose data start off 16-byte
    alignment, through the op (whole words) and through ``mask_to_host``
    (ragged). The op refuses a ragged mask. Returns what it checked."""
    from repro_torch.kernels.bitset import bitset, ref

    gen = np.random.default_rng(4)

    def ragged_check(m, what):
        if not torch.equal(bitset.pack_flags(m), ref.pack_padded_reference(m)):
            fail(f"bitset_pack of {what} differs from its plain version (the padded mask)")
        if not np.array_equal(cuda_k.mask_to_host(m), m.cpu().numpy()):
            fail(f"mask_to_host of {what} differs from the mask")

    lengths = (1, 31, 33, 1000, 4097, 786_427)
    for n in lengths:
        ragged_check(torch.from_numpy(gen.random(n) < 0.4).to(dev), f"a {n}-flag mask")
    base = torch.from_numpy(gen.random(4096 + 64) < 0.4).to(dev)
    offsets = (1, 3, 4, 8)
    for off in offsets:
        whole = base[off:off + 4096]
        if not torch.equal(cuda_k.bitset_pack(whole), plain.bitset_pack(whole)):
            fail(f"bitset_pack of a mask at data_ptr mod 16 = {whole.data_ptr() % 16} differs "
                 "from its plain version")
        ragged_check(base[off:off + 1001], f"a ragged mask at data_ptr mod 16 = "
                     f"{base[off:].data_ptr() % 16}")
    try:
        cuda_k.bitset_pack(base[:33])
    except ValueError:
        pass
    else:
        fail("the bitset_pack op took a mask of 33 flags")
    torch.cuda.synchronize()
    return (f"ragged lengths {list(lengths)} through mask_to_host, and starts at data_ptr mod 16 "
            f"= {[base[o:].data_ptr() % 16 for o in offsets]} (4,096 flags through the op, "
            f"1,001 through mask_to_host); the op refuses 33 flags")


def unpack_by_lanes(words: np.ndarray, n_bits: int) -> np.ndarray:
    """The host unpack ``mask_to_host`` ran before it read bytes: every word
    shifted into 32 uint32 lanes. Timed beside its replacement only."""
    lanes = (words.view(np.uint32)[:, None] >> np.arange(32, dtype=np.uint32)) & np.uint32(1)
    return lanes.reshape(-1)[:n_bits].astype(bool)


def mask_host_path(cuda_k, mask, dev) -> str:
    """``mask_to_host``'s host path on the main path's largest mask, step by
    step, in µs a call (`host_us`); also the whole path 5 flags short of
    whole words, and the padded copy that the kernel's ragged tail made
    unneeded (``mask_to_host`` made it for a ragged mask)."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.bitset import bitset, ref

    n = mask.numel()
    n_w = ref.n_words(n)
    ragged = mask[:n - 5]
    words = torch.empty(n_w, dtype=torch.int32, device=dev)
    cuda_k.bitset_pack(mask)  # binds the entry point
    raw = bitset.PACK._fn
    host_words = words.cpu().numpy()

    def stream():  # the read CudaKernel passes to every launch
        return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())

    steps = {
        "mask_to_host (the whole path)": lambda: cuda_k.mask_to_host(mask),
        "mask_to_host, 5 flags short of whole words": lambda: cuda_k.mask_to_host(ragged),
        "the padded copy no longer made (torch.cat with new_zeros)":
            lambda: torch.cat([ragged, ragged.new_zeros(5)]),
        "the wrapper's checks": lambda: (cuda.on_cpu(mask), cuda.check(mask, "mask", torch.bool, 1)),
        "torch.empty (the words)": lambda: torch.empty(ref.n_words(mask.shape[0]),
                                                       dtype=torch.int32, device=dev),
        "the ctypes call with its launch": lambda: raw(mask.data_ptr(), n, words.data_ptr(),
                                                       stream()),
        ".cpu() of the words": lambda: words.cpu(),
        "unpack_bitset on the host (byte-wise)": lambda: ref.unpack_bitset(host_words, n),
        "the 32-lane unpack it replaced": lambda: unpack_by_lanes(host_words, n),
    }
    return ", ".join(f"{k} {host_us(f):.3f}" for k, f in steps.items())


def phase_kernels(recorder, launches, dev) -> list[dict]:
    from repro_torch.core.backend import get_kernels

    from repro_torch.kernels.hash_join.hash_join import last_route

    from repro_torch.kernels.bitset import bitset, ref

    recorded = recorder.calls
    cuda_k, plain = get_kernels("cuda"), get_kernels("torch")
    # each op as the main path calls it: bitset_pack through mask_to_host's
    # pack_flags (any length), whose plain version pads the mask
    fns = {op: (getattr(cuda_k, op), getattr(plain, op)) for op in MATCHER_KERNELS}
    fns["bitset_pack"] = (bitset.pack_flags, ref.pack_padded_reference)
    cases = {op: [] for op in MATCHER_KERNELS}
    for op, args, kw, *route in adversarial_cases(dev):
        cases[op].append((args, kw, route[0] if route else None))
    rows = []
    for op in MATCHER_KERNELS:
        if op not in recorded:
            fail(f"{op}: the main path never called it")
        _, args, kw = recorded[op]
        err, routes = 0, []
        kernel, plain_fn = fns[op]
        for a, k, want in [(args, kw, None)] + cases[op]:
            got = kernel(*a, **k)
            if op == "hash_join_probe":  # the route the C entry point launched
                routes.append(last_route())
                if want is not None and routes[-1] != want:
                    fail(f"hash_join_probe on a build side of {tuple(a[1].shape)} took the "
                         f"{routes[-1]!r} route, not {want!r}")
            err = max(err, max_abs_err(got, plain_fn(*a, **k)))
        torch.cuda.synchronize()
        if err != 0:
            fail(f"{op}: kernel differs from its plain version (max abs err {err})")
        ms = time_ms(lambda: kernel(*args, **kw))
        plain_ms = time_ms(lambda: plain_fn(*args, **kw))
        rows.append(kernel_row(op, args, kw, launches[op], err, ms, plain_ms))
        shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        log(f"[kernels] {op}: bit-exact on main-path input {shapes} {kw} and "
            f"{len(cases[op])} adversarial case(s); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}, "
            f"{work(op, args, kw)[0]} B), main-path launches {launches[op]}")
        if op.startswith("bitset_"):
            log(f"[kernels] {op}: device time by a CUDA graph of 20 calls "
                f"{graph_ms(lambda: kernel(*args, **kw)):.4f} ms a call; "
                f"{eager_times(lambda: kernel(*args, **kw))}"
                + ("" if op != "bitset_lookup" else "; " + same_bytes(lambda: args[1].ne(0),
                                                                      "ids.ne(0)")))
        if op == "bitset_pack":
            log(f"[kernels] bitset_pack: the main path's {len(recorder.masks)} mask_to_host "
                f"calls took masks of (length, data_ptr mod 16) {recorder.masks}; bit-exact on "
                f"{pack_checks(cuda_k, plain, dev)}")
            log("[kernels] mask_to_host's host path on the main path's largest mask, µs a call "
                "(perf_counter_ns over 2,000 calls, a sync every 100): "
                + mask_host_path(cuda_k, args[0], dev))
        if op == "hash_join_probe":
            log(f"[kernels] hash_join_probe: the main-path call took the {routes[0]!r} route "
                f"(build side {args[1].shape[0]} x (5 + 4 x {args[1].shape[1]}) B); the "
                f"adversarial cases took {routes[1:]}, as the C entry point recorded them; "
                f"device time by a CUDA graph of 20 calls "
                f"{graph_ms(lambda: cuda_k.hash_join_probe(*args, **kw)):.4f} ms a call; "
                f"{eager_times(lambda: cuda_k.hash_join_probe(*args, **kw))}; "
                f"{profile_line(device_profile(lambda: cuda_k.hash_join_probe(*args, **kw), 10))}")
            if not {"shared", "global"} <= set(routes):
                fail(f"hash_join_probe's checks took the routes {routes}, not both")
        if op == "stwig_expand":
            # the bound counted every input byte until the kernel read lazily
            words_k, dst, lab, indptr, rok = args
            k, C, cap = words_k.shape[0], kw["child_cap"], kw["cap"]
            every = nbytes(words_k, dst, lab, indptr, rok) + 4 * k * ((cap + 1) * C + cap)
            log(f"[kernels] stwig_expand: every input read once would be {every} B, "
                f"{every / HBM_BYTES_PER_S * 1e3:.4f} ms; the call's kernels (plan_kernel: "
                f"tile bounds and open rows' counts, emit_kernel: ranks and candidates): "
                f"{profile_line(device_profile(lambda: cuda_k.stwig_expand(*args, **kw)))}")
    return rows


# ---------------------------------------------------------------- phase 6
def phase_ops(recorder) -> list[dict]:
    """``bitset_unpack`` over every binding bitset the main path built and
    ``candidate_filter`` over every (``stwig_expand`` call, child) of it."""
    from repro_torch.core.backend import get_kernels
    from repro_torch.kernels import cuda

    cuda_k, plain = get_kernels("cuda"), get_kernels("torch")
    if not recorder.builds or not recorder.expands:
        fail("the main path recorded no bitset_build or stwig_expand call")
    # one bitset a column of each bitset_build call (a round's columns)
    bitsets = [(ids[:, p] if ids.dim() == 2 else ids, valid, nwords,
                words[p] if words.dim() == 2 else words)
               for (ids, valid, nwords), words in recorder.builds
               for p in range(ids.shape[1] if ids.dim() == 2 else 1)]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    for ids, valid, nwords, words in bitsets:
        bits = cuda_k.bitset_unpack(words)
        if not torch.equal(bits, plain.bitset_unpack(words)):
            fail("bitset_unpack differs from its plain version on a main-path bitset")
        # unpack(build(ids)) holds exactly the built ids (JAX's index rules:
        # a negative id wraps once, what is still outside drops)
        n_bits = nwords * 32
        wrapped = torch.where(ids < 0, ids + n_bits, ids)
        keep = valid & (wrapped >= 0) & (wrapped < n_bits)
        want = torch.zeros(n_bits, dtype=torch.bool, device=ids.device)
        want[wrapped[keep].long()] = True
        if not torch.equal(bits, want):
            fail("unpack(build(ids, valid)) is not the set of built ids")

    def filter_and_check(words, dst, lab, rok, label, indptr, cap, cnt_i, what):
        """The filter bit-exact against its plain version, and its per-root
        sums equal to stwig_expand's exact counts for that child."""
        mask = cuda_k.candidate_filter(words, dst, lab, rok, label)
        if not torch.equal(mask, plain.candidate_filter(words, dst, lab, rok, label)):
            fail(f"candidate_filter differs from its plain version ({what})")
        cs = torch.cat([mask.new_zeros(1, dtype=torch.int64), torch.cumsum(mask, 0)])
        sums = cs[indptr[1:cap + 1].long()] - cs[indptr[:cap].long()]
        if not torch.equal(sums.to(torch.int32), cnt_i):
            fail(f"candidate_filter's per-root sums differ from stwig_expand's counts ({what})")

    n_bound, n_free = 0, 0
    for (words_k, dst, lab, indptr, rok), kw, cnt in recorder.expands:
        for i, label in enumerate(kw["child_labels"]):
            # a child with no binding yet is filtered by label alone: with
            # every bit set, the filter computes the same survivors
            bound = kw["child_bound"][i]
            words = words_k[i] if bound else torch.full_like(words_k[i], -1)
            filter_and_check(words, dst, lab, rok, label, indptr, kw["cap"], cnt[i],
                             "a main-path input")
            n_bound += bound
            n_free += not bound
    # the main path binds no child before it expands, so hold bound children
    # on its largest call with random binding words: stwig_expand's counts
    # then include the bit test that candidate_filter does
    (words_k, dst, lab, indptr, rok), kw, _ = max(
        recorder.expands, key=lambda c: c[0][1].numel())
    gen = torch.Generator(device=dst.device).manual_seed(0)
    words_r = torch.randint(-2**31, 2**31, words_k.shape, generator=gen,
                            dtype=torch.int64, device=dst.device).to(torch.int32)
    k = words_k.shape[0]
    _, cnt = cuda_k.stwig_expand(words_r, dst, lab, indptr, rok,
                                 **dict(kw, child_bound=(True,) * k))
    for i, label in enumerate(kw["child_labels"]):
        filter_and_check(words_r[i], dst, lab, rok, label, indptr, kw["cap"], cnt[i],
                         "random binding words")
    n_bound += k
    n_filter = n_bound + n_free
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    for op in ("bitset_unpack", "candidate_filter"):
        if counts[op] <= 0:
            fail(f"kernel {op} was never launched on its path")
    log(f"[ops] bitset_unpack on the {len(bitsets)} main-path bitsets of "
        f"{len(recorder.builds)} bitset_build calls: bit-exact, and unpack(build(ids)) is "
        f"each column's built ids' set")
    log(f"[ops] candidate_filter on {n_filter} (stwig_expand call, child) inputs: bit-exact; "
        f"per-root sums equal stwig_expand's exact counts for {n_free} unbound children "
        f"(all bits set) and {n_bound} bound ones ({n_bound - k} with the path's binding "
        f"words, {k} with random words on its largest call); "
        f"launches {({op: counts[op] for op in ('bitset_unpack', 'candidate_filter')})}")

    # the filter's main-path input is sparse (root_ok holds on ~1 edge in
    # 418), so it reads little more than root_ok. The kernel row is timed on
    # the same edges made dense: every edge a root_ok edge of the child's
    # label, so every byte of the bound is needed
    label = kw["child_labels"][0]
    dense = (words_r[0], dst, torch.full_like(lab, label), torch.ones_like(rok), label)
    if not torch.equal(cuda_k.candidate_filter(*dense), plain.candidate_filter(*dense)):
        fail("candidate_filter differs from its plain version (dense root_ok and labels)")
    log(f"[ops] candidate_filter bit-exact on {filter_checks(cuda_k, plain, dst.device)}")
    rows = []
    words = max(bitsets, key=lambda b: b[2])[3]
    sparse = (words_k[0], dst, lab, rok, label)
    for op, args, what in (
        ("candidate_filter", sparse, "main-path input"),
        ("bitset_unpack", (words,), "main-path input"),
        ("candidate_filter", dense, "dense input"),
    ):
        fn = getattr(cuda_k, op)
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(lambda: getattr(plain, op)(*args))
        row = kernel_row(op, args, {}, counts[op], 0, ms, plain_ms)
        shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args]
        log(f"[ops] {op} on {what} {shapes}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{work(op, args, {})[0] / 1e6:.1f} MB), launches {counts[op]}; device time by a "
            f"CUDA graph of 20 calls {graph_ms(lambda: fn(*args)):.4f} ms a call"
            f"; {eager_times(lambda: fn(*args))}"
            + ("" if op != "bitset_unpack" else
               f"; unpack_kernel: {ptxas_usage('bitset', 'unpack_kernel')}")
            # the sparse input needs its root_ok read and its output written
            + ("" if args is not sparse else "; " + same_bytes(lambda: rok.clone(),
                                                              "root_ok.clone()")))
        if what != "main-path input" or op == "bitset_unpack":
            rows.append(row)
    return rows


# ------------------------------------------------------------ [sharded]
def complete_queries(session, g, n: int = 4, tries: int = 200) -> list:
    """Seeded DFS queries of 3-4 nodes whose local result at
    ``max_matches=0`` is complete and not empty, as (query, row set, True):
    the main path's queries overflow ``child_cap`` at the R-MAT's hubs."""
    from repro_torch.workloads import dfs_query

    rng = np.random.default_rng(7)
    out = []
    for _ in range(tries):
        q = dfs_query(g, rng, int(rng.integers(3, 5)))
        if q is None:
            continue
        res = session.compile(q, max_matches=0).run(adaptive=False)
        if res.complete and res.n_matches:
            out.append((q, set(map(tuple, res.rows.tolist())), True))
            if len(out) == n:
                break
    return out


def phase_sharded(g, edge_keys, queries, local_full) -> dict:
    """The sharded engine (paper §4.3) with the paper's shard size
    (`configs/stwig.py`: 250,000 nodes a shard) on the main path's graph and
    queries, every shard on the card. ``local_full``: the local session's
    (query, row set, complete) at ``max_matches=0`` of each main-path query
    and of `complete_queries`. Returns the partition, its cluster-graph
    index, and the queries' rows and stream pages, for [ranks]."""
    from repro_torch.api import GraphSession
    from repro_torch.configs import stwig
    from repro_torch.core.backend import Kernels
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.kernels import cuda

    per_shard = stwig.CONFIG.n_nodes // stwig.CONFIG.n_shards
    S = -(-g.n_nodes // per_shard)
    t0 = time.perf_counter()
    pg = PartitionedGraph.build(g, S)
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    session = GraphSession.open(pg, backend="sharded")
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    if session.kernels.name != "cuda":
        fail(f"GraphSession.open(pg, backend='sharded') on the card chose "
             f"{session.kernels.name!r}")
    eng = session.engine
    log(f"[sharded] {S} hash shards (the paper's {per_shard} nodes a shard): "
        f"cap {pg.cap} nodes, edge_cap {pg.edge_cap} edges a shard, partition "
        f"{pg.memory_bytes() / 1e6:.1f} MB, built in {t_part:.2f} s; session (cluster-graph "
        f"index of {len(eng.cgi.pair_index)} label pairs, shards to the card) opened in "
        f"{t_open:.2f} s; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")

    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    rows_cuda, stream_cuda, report = run_queries(session, queries, queries[0])
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    for line in report:
        log(f"[sharded] {line}")
    log(f"[sharded] max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
        f"launches { {k: counts[k] for k in MATCHER_KERNELS} } (a launch per shard where "
        f"the local path launches once)")
    for sym in MATCHER_KERNELS:
        if counts[sym] <= 0:
            fail(f"kernel {sym} was never launched on the sharded path")
    if not any(len(r) for r in rows_cuda):
        fail("every sharded query returned 0 rows")
    for q, rows in zip(queries, rows_cuda):
        embedding_check(g, edge_keys, q, rows)
    embedding_check(g, edge_keys, queries[0], np.concatenate(stream_cuda) if stream_cuda
                    else np.zeros((0, queries[0].n_nodes), np.int64))
    log(f"[sharded] every row of {len(queries)} queries + stream is a valid embedding")
    direct_entry_points(session, queries, rows_cuda, stream_cuda, "sharded")
    log(f"[sharded] {stacked_any_check(eng)}")

    # every match at max_matches=0: no duplicate across shards, and the
    # local engine's set wherever the local result is complete. A query of
    # one STwig is held even when incomplete: a root's first child_cap
    # candidates are the same edges in both layouts (each shard keeps its
    # nodes' edges in the graph's order), so the tables are the same set
    n_complete = n_one = 0
    sizes = []
    for i, (q, want, complete) in enumerate(local_full):
        res = session.compile(q, max_matches=0).run(adaptive=False)
        got = set(map(tuple, res.rows.tolist()))
        embedding_check(g, edge_keys, q, res.rows)
        if len(got) != len(res.rows):
            fail(f"q{i}: the sharded rows hold a duplicate")
        one = len(res.stats.rounds) == 1
        sizes.append((res.n_matches, res.complete, len(want), complete))
        if complete and not res.complete:
            fail(f"q{i}: the sharded result is incomplete where the local one is complete")
        if (complete or one) and got != want:
            fail(f"q{i}: the sharded engine's {res.n_matches} rows are not the local "
                 f"engine's {len(want)}")
        n_complete += complete
        n_one += one and not complete
    log(f"[sharded] max_matches=0, (sharded rows, complete, local rows, complete) a query "
        f"(the {len(queries)} main-path queries, then {len(local_full) - len(queries)} smaller "
        f"ones): "
        f"{sizes}; no duplicates; equal to the local engine's set on the {n_complete} "
        f"queries whose local result is complete and on {n_one} incomplete one-STwig ones")
    if n_complete == 0:
        fail("no query's local result was complete: nothing held the sharded rows")
    for line in repeat_times(session, queries):
        log(f"[sharded] {line}")
    # where a repeat's time goes: the query with the most STwigs (a fetch
    # and a join), traced once
    i = max(range(len(queries)), key=lambda j: (
        len(session.compile(queries[j]).plan.specs), len(queries[j].edges)))
    compiled = session.compile(queries[i], max_matches=1024)
    log(f"[sharded] q{i} repeat traced: "
        f"{profile_line(device_profile(lambda: compiled.run(adaptive=False), reps=1))}")

    # the plain versions on the card: the same rows and pages; the last
    # shard's stwig_expand calls are kept to hold the kernels on its ids
    last = eng.graphs[-1].indices.data_ptr()

    class LastShard(Kernels):
        def __init__(self):
            self.expands = []

        def stwig_expand(self, *args, **kw):
            cand, cnt = super().stwig_expand(*args, **kw)
            if args[1].data_ptr() == last:
                self.expands.append((args, kw, cand, cnt))
            return cand, cnt

    recorder = LastShard()
    session.set_kernels(recorder)
    rows_torch, stream_torch, report = run_queries(session, queries, queries[0])
    for line in report:
        log(f"[sharded] torch: {line}")
    for i, (a, b) in enumerate(zip(rows_cuda, rows_torch)):
        if a.shape != b.shape or not (a == b).all():
            fail(f"q{i}: sharded rows differ between kernels='cuda' and kernels='torch'")
    if len(stream_cuda) != len(stream_torch) or not all(
        (a.shape == b.shape) and (a == b).all() for a, b in zip(stream_cuda, stream_torch)
    ):
        fail("sharded stream pages differ between kernels='cuda' and kernels='torch'")
    n_filter = expand_checks(recorder.expands, f"shard {S - 1}")
    log(f"[sharded] kernels='torch' on the card: rows and stream pages identical to "
        f"kernels='cuda'; on shard {S - 1}'s ids (global ids {(S - 1) * pg.cap} and up) "
        f"stwig_expand bit-exact on its {len(recorder.expands)} calls and candidate_filter on "
        f"{n_filter} (call, child) inputs, its per-root sums equal to stwig_expand's counts")
    out = dict(pg=pg, rows=rows_cuda, stream=stream_cuda)
    del session, eng, recorder
    torch.cuda.empty_cache()
    return out


def expand_checks(expands, where: str) -> int:
    """Each recorded plain ``stwig_expand`` call ``(args, kw, cand, cnt)``
    again on the kernel, bit-exact, and ``candidate_filter`` on each of its
    children against its plain version, its per-root sums equal to the
    call's counts. Returns the (call, child) inputs held."""
    from repro_torch.core.backend import get_kernels

    cuda_k, plain = get_kernels("cuda"), get_kernels("torch")
    n_filter = 0
    for args, kw, cand, cnt in expands:
        got = cuda_k.stwig_expand(*args, **kw)
        if not (torch.equal(got[0], cand) and torch.equal(got[1], cnt)):
            fail(f"stwig_expand differs from its plain version on {where}'s ids")
        words_k, dst, lab, indptr, rok = args
        for i, label in enumerate(kw["child_labels"]):
            words = words_k[i] if kw["child_bound"][i] else torch.full_like(words_k[i], -1)
            mask = cuda_k.candidate_filter(words, dst, lab, rok, label)
            if not torch.equal(mask, plain.candidate_filter(words, dst, lab, rok, label)):
                fail(f"candidate_filter differs from its plain version on {where}")
            cs = torch.cat([mask.new_zeros(1, dtype=torch.int64), torch.cumsum(mask, 0)])
            sums = cs[indptr[1:kw["cap"] + 1].long()] - cs[indptr[:kw["cap"]].long()]
            if not torch.equal(sums.to(torch.int32), cnt[i]):
                fail(f"candidate_filter's per-root sums differ from stwig_expand's counts on "
                     f"{where}")
            n_filter += 1
    if not expands:
        fail(f"the sharded path never expanded on {where}")
    return n_filter


def sharded_small(small, queries, caps) -> str:
    """The sharded engine at S = 4 on a small graph: the same rows on the
    CPU and on the card, and the local engine's set where all are complete."""
    from repro_torch.api import GraphSession
    from repro_torch.graphstore.partition import PartitionedGraph

    pg4 = PartitionedGraph.build(small, 4)
    sh_cpu = GraphSession.open(pg4, device="cpu")
    sh_gpu = GraphSession.open(pg4)
    loc = GraphSession.open(small)
    n_rows = n_same = 0
    for q in queries:
        a = sh_cpu.run(q, max_matches=0, **caps)
        b = sh_gpu.run(q, max_matches=0, **caps)
        if a.complete != b.complete or a.rows.shape != b.rows.shape or not (a.rows == b.rows).all():
            fail("the 2,000-node graph's 4 shards give other rows on the CPU and on the card")
        c = loc.run(q, max_matches=0, **caps)
        if a.complete and c.complete:
            if set(map(tuple, a.rows.tolist())) != set(map(tuple, c.rows.tolist())):
                fail("the 2,000-node graph's 4 shards give other rows than its local session")
            n_same += 1
        n_rows += len(a.rows)
    if n_same == 0:
        fail("no small-graph query was complete on both engines: nothing held the 4 shards")
    return (f"sharded at S = 4 ({caps}): {len(queries)} queries, {n_rows} rows, identical on "
            f"CPU and card, the local session's set on the {n_same} complete ones")


# ------------------------------------------------------------------ [ranks]
def ranks_rank(rank: int, path: str, queries, n_ranks: int, t_spawn: float) -> dict:
    """[ranks] in one rank process: the saved partition opened on a mesh of
    the world (its own shard to ``cuda:0``), the queries and stream counted,
    three repeats a query, then the same calls on the plain versions, the
    last rank keeping its ``stwig_expand`` calls to hold the kernels on its
    ids. Loads the kernel libraries phase 2 built; builds none.
    ``t_spawn``: the parent's clock when it started the ranks."""
    started = time.time() - t_spawn
    from repro_torch.api import GraphSession
    from repro_torch.core import rank_collectives as rc
    from repro_torch.core.backend import Kernels
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.kernels import cuda
    from repro_torch.launch import make_host_mesh

    t0 = time.perf_counter()
    path = pathlib.Path(path)
    session = GraphSession.open(
        PartitionedGraph.load(path / "pg"), backend="sharded", mesh=make_host_mesh(n_ranks))
    torch.cuda.synchronize()
    out = dict(device=str(session.device), kernels=session.kernels.name, started_s=started,
               open_s=time.perf_counter() - t0, allocated=torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    rc.reset_staged_bytes()
    rows, stream, report = run_queries(session, queries, queries[0])
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    out.update(rows=rows, stream=stream, report=report, staged=dict(rc.staged_bytes),
               launches={k: counts[k] for k in MATCHER_KERNELS},
               peak=torch.cuda.max_memory_allocated())
    out["repeats"] = repeat_times(session, queries)

    class Expands(Kernels):
        def __init__(self):
            self.expands = []

        def stwig_expand(self, *args, **kw):
            cand, cnt = super().stwig_expand(*args, **kw)
            if rank == n_ranks - 1:
                self.expands.append((args, kw, cand, cnt))
            return cand, cnt

    plain = Expands()
    session.set_kernels(plain)
    rows_t, stream_t, _ = run_queries(session, queries, queries[0])
    out["torch_same"] = (all(np.array_equal(a, b) for a, b in zip(rows, rows_t))
                         and len(stream) == len(stream_t)
                         and all(np.array_equal(a, b) for a, b in zip(stream, stream_t)))
    if rank == n_ranks - 1:
        out["tables"] = (len(plain.expands), expand_checks(plain.expands, f"rank {rank}"),
                         rank * session.pg.cap)
    out["sources_built"] = cuda.sources_built
    return out


def phase_ranks(g, edge_keys, queries, sharded: dict) -> None:
    """[ranks]: the paper's engine with one shard a process — [sharded]'s
    16 hash shards, one gloo rank each on ``cuda:0`` (`spawn_ranks`), each
    rank's session opened with ``mesh=make_host_mesh(16)`` on the partition
    saved once here (a rank maps its own shard's pages, never builds the
    graph); the queries and stream held to [sharded]'s rows."""
    import shutil
    import tempfile

    from repro_torch.core.rank_collectives import GLOO_HOST_OPS
    from repro_torch.launch import spawn_ranks

    pg, n = sharded["pg"], RANKS
    if pg.n_shards != n:
        fail(f"[ranks] [sharded]'s partition has {pg.n_shards} shards, not {n}")
    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    path = pathlib.Path(tempfile.mkdtemp(prefix="ranks-", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        pg.save(path / "pg")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = spawn_ranks(ranks_rank, n, str(path), queries, n, time.time(), timeout=900)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    for k, r in enumerate(res):
        if r["kernels"] != "cuda" or r["device"] != "cuda:0" or r["sources_built"]:
            fail(f"[ranks] rank {k}: kernels {r['kernels']!r} on {r['device']}, "
                 f"{r['sources_built']} sources built")
        for sym in MATCHER_KERNELS:
            if r["launches"][sym] <= 0:
                fail(f"[ranks] rank {k} never launched {sym}: {r['launches']}")
        if not r["torch_same"]:
            fail(f"[ranks] rank {k}: kernels='torch' gave other rows or pages than 'cuda'")
        for i, (a, b) in enumerate(zip(r["rows"], sharded["rows"])):
            if a.shape != b.shape or not (a == b).all():
                fail(f"[ranks] rank {k}, q{i}: {len(a)} rows, not [sharded]'s {len(b)} in its order")
        if len(r["stream"]) != len(sharded["stream"]) or not all(
                a.shape == b.shape and (a == b).all() for a, b in zip(r["stream"], sharded["stream"])):
            fail(f"[ranks] rank {k}: stream pages differ from [sharded]'s")
    for q, rows in zip(queries, res[0]["rows"]):
        embedding_check(g, edge_keys, q, rows)
    n_calls, n_filter, first_id = res[-1]["tables"]
    sums = {sym: sum(r["launches"][sym] for r in res) for sym in MATCHER_KERNELS}
    lows = {sym: min(r["launches"][sym] for r in res) for sym in MATCHER_KERNELS}
    staged = {}
    for r in res:
        for name, b in r["staged"].items():
            staged[name] = staged.get(name, 0) + b
    log(f"[ranks] {n} gloo ranks on cuda:0 (spawn_ranks, one shard a process), each on "
        f"GraphSession.open(pg, backend='sharded', mesh=make_host_mesh({n})); partition saved "
        f"in {t_save:.2f} s; ranks started, opened and done in {t_ranks:.2f} s: a rank's function "
        f"entered {min(r['started_s'] for r in res):.2f}-{max(r['started_s'] for r in res):.2f} s "
        f"after the spawn, its session open "
        f"{min(r['open_s'] for r in res):.2f}-{max(r['open_s'] for r in res):.2f} s")
    for line in res[0]["report"]:
        log(f"[ranks] rank 0: {line}")
    log(f"[ranks] launches summed over the ranks {sums}, the fewest on a rank {lows}: each "
        f"rank launched each of the five; no rank built a kernel library")
    log(f"[ranks] every rank's rows of the {len(queries)} queries (max_matches=1024, "
        f"adaptive=False; {sum(len(r) == 1024 for r in res[0]['rows'])} truncated at 1,024) and "
        f"the stream's {len(sharded['stream'])} pages identical to [sharded]'s, in order; every "
        f"row a valid embedding; kernels='torch' gives the same on every rank")
    log(f"[ranks] rank {n - 1} (global ids {first_id} and up): stwig_expand bit-exact on its "
        f"{n_calls} calls and candidate_filter on {n_filter} (call, child) inputs, its "
        f"per-root sums equal to stwig_expand's counts")
    for line in res[0]["repeats"]:
        log(f"[ranks] rank 0: {line}")
    log(f"[ranks] max_memory_allocated a rank (GB): "
        f"{[round(r['peak'] / 1e9, 3) for r in res]}; allocated after open "
        f"{[round(r['allocated'] / 1e9, 3) for r in res]}")
    log(f"[ranks] bytes staged through pinned host memory, summed over the ranks, by "
        f"collective: {staged} (gloo ops staged on CUDA tensors: {sorted(GLOO_HOST_OPS)})")
    log(f"[ranks] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ [ranks-small]
def small_rank_inputs(seed: int = 0) -> dict:
    """[ranks-small]'s compressed_psum gradients and EF errors (one a rank)
    and gpipe's stage weights and microbatches, from a seed."""
    c = RANKS_SMALL
    rng = np.random.default_rng(seed)
    return {
        "grad": rng.normal(size=(c["ranks"],) + c["grad"]).astype(np.float32),
        "ef": (rng.normal(size=(c["ranks"],) + c["grad"]) * 1e-3).astype(np.float32),
        "ws": (rng.normal(size=(c["stages"], c["d"], c["d"])) * 0.15).astype(np.float32),
        "x": rng.normal(size=(c["micro"], c["mb"], c["d"])).astype(np.float32),
    }


def small_rank(rank: int, pg, queries, held, caps, t_spawn: float) -> dict:
    """[ranks-small] in one of 8 rank processes, a (2, 4) mesh: ranks 0-3
    (the first row) on ``cuda:0`` with the CUDA kernels, counted, ranks 4-7
    on the CPU with the plain versions; each row a 4-rank mesh of its own.
    Both rows run the small graph's queries, `compressed_psum` over their
    4 and `gpipe` over the pod dim of a (4, 2) mesh; the card's row also
    runs `CHAOS_FAULTS` on the ``held`` queries and the engine probe of
    [analysis]. Each part's seconds are returned beside its results, and
    when the function was entered after ``t_spawn``, the parent's clock
    when it started the ranks."""
    started = time.time() - t_spawn
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analysis.staticcheck import engines
    from repro_torch.api import GraphSession
    from repro_torch.kernels import cuda
    from repro_torch.launch import gpipe
    from repro_torch.optim import EFState, compressed_psum
    from repro_torch.runtime import ChaosConfig, ChaosInjector, RetryPolicy

    n = RANKS_SMALL["ranks"]
    on_card = rank < n
    dev = torch.device("cuda:0" if on_card else "cpu")
    kw = dict(device=None if on_card else "cpu", kernels="auto" if on_card else "torch")
    mesh = init_device_mesh("cpu", (2, n), mesh_dim_names=("where", "data"))["data"]
    pods = init_device_mesh("cpu", (2 * n // RANKS_SMALL["stages"], RANKS_SMALL["stages"]),
                            mesh_dim_names=("data", "pod"))
    secs = {"entered": started, "meshes": time.time() - t_spawn}
    t0 = time.perf_counter()
    session = GraphSession.open(pg, mesh=mesh, **kw)
    out = {"kernels": session.kernels.name, "device": str(session.device)}
    cuda.reset_launch_counts()
    out["rows"] = [(r.rows, r.complete) for r in
                   (session.run(q, max_matches=0, **caps) for q in queries)]
    if on_card:
        torch.cuda.synchronize()
    counts = cuda.launch_counts()
    out["launches"] = {k: counts[k] for k in MATCHER_KERNELS}
    secs["queries"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inp = {k: torch.from_numpy(v).to(dev) for k, v in small_rank_inputs().items()}
    me = rank % n
    red, ef = compressed_psum(inp["grad"][me], EFState(inp["ef"][me]), mesh.get_group())
    out["psum"] = (red.cpu().numpy(), ef.error.cpu().numpy())
    pipe = gpipe(lambda w, x: torch.tanh(x @ w), pods, axis="pod")
    out["gpipe"] = pipe(inp["ws"][rank % RANKS_SMALL["stages"]], inp["x"]).cpu().numpy()
    secs["psum+gpipe"] = time.perf_counter() - t0
    if on_card:
        t0 = time.perf_counter()
        out["chaos"] = {}
        for what, fault in CHAOS_FAULTS.items():
            res = []
            for q in held:
                s = GraphSession.open(
                    pg, mesh=mesh, chaos=ChaosInjector(ChaosConfig(seed=0, **fault)), **kw)
                r = s.run(q, max_matches=0, adaptive=False, retry_policy=RetryPolicy(), **caps)
                res.append((r.rows, r.complete, r.stats.degrade_reason, r.stats.shard_health,
                            r.stats.fetch_retries))
            out["chaos"][what] = res
        secs["chaos"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["probe"] = engines.rank_probe(me, "cuda", None, mesh=mesh)
        secs["probe"] = time.perf_counter() - t0
    out["secs"] = secs
    out["sources_built"] = cuda.sources_built
    return out


def phase_ranks_small(small, queries, caps) -> list:
    """[ranks-small]: the 2,000-node graph's 4 shards as 4 gloo ranks on
    the card and 4 on the CPU, one spawn of 8 (`small_rank`), held to the
    stacked engine on the card (rows; on the card's ranks the chaos cases'
    rows and shard health), `compressed_psum` to its plain single-process
    counterpart and `gpipe` to the sequential stages. Returns the card
    ranks' engine probes, for [analysis]."""
    from repro_torch.api import GraphSession
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.launch import spawn_ranks
    from repro_torch.runtime import ChaosConfig, ChaosInjector, RetryPolicy

    t_phase = time.perf_counter()
    n = RANKS_SMALL["ranks"]
    pg4 = PartitionedGraph.build(small, n)
    stacked = GraphSession.open(pg4)
    want = [stacked.run(q, max_matches=0, **caps) for q in queries]
    held = [q for q, r in zip(queries, want) if r.complete and r.n_matches]
    want_chaos = {}
    for what, fault in CHAOS_FAULTS.items():
        want_chaos[what] = []
        for q in held:
            s = GraphSession.open(pg4, chaos=ChaosInjector(ChaosConfig(seed=0, **fault)))
            r = s.run(q, max_matches=0, adaptive=False, retry_policy=RetryPolicy(), **caps)
            want_chaos[what].append((r.rows, r.complete, r.stats.degrade_reason,
                                     r.stats.shard_health, r.stats.fetch_retries))
    t_ref = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    res = spawn_ranks(small_rank, 2 * n, pg4, queries, held, caps, time.time(), timeout=600)
    t_ranks = time.perf_counter() - t0
    card, host = res[:n], res[n:]
    for k, r in enumerate(res):
        where = "card" if k < n else "cpu"
        if (r["kernels"], r["device"]) != (("cuda", "cuda:0") if k < n else ("torch", "cpu")) \
                or r["sources_built"]:
            fail(f"[ranks-small] rank {k}: kernels {r['kernels']!r} on {r['device']}, "
                 f"{r['sources_built']} sources built")
        for i, ((rows, complete), w) in enumerate(zip(r["rows"], want)):
            if complete != w.complete or rows.shape != w.rows.shape or not (rows == w.rows).all():
                fail(f"[ranks-small] {where} rank {k}, q{i}: {len(rows)} rows, complete "
                     f"{complete}; the stacked engine's {w.n_matches}, {w.complete}")
    for k, r in enumerate(card):
        for sym in MATCHER_KERNELS:
            if r["launches"][sym] <= 0:
                fail(f"[ranks-small] card rank {k} never launched {sym}: {r['launches']}")
        for what, cases in want_chaos.items():
            for i, (got, exp) in enumerate(zip(r["chaos"][what], cases)):
                if not (np.array_equal(got[0], exp[0]) and got[1:] == exp[1:]):
                    fail(f"[ranks-small] card rank {k}, {what}, held q{i}: {len(got[0])} "
                         f"rows, {got[1:]}; the stacked engine's {len(exp[0])}, {exp[1:]}")
    inp = {k: torch.from_numpy(v).cuda() for k, v in small_rank_inputs().items()}
    x = inp["grad"] + inp["ef"]
    scale = torch.clamp(x.abs().amax(dim=(1, 2)) / 127.0, min=1e-12).max()
    # the int8 payload written out, independent of the port: round half to
    # even, clip to ±127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    mean = (q.to(torch.int32).sum(0).to(torch.float32) * scale / n).cpu().numpy()
    err = (x - q.to(torch.float32) * scale).cpu().numpy()
    tol = 1e-6 * float(x.abs().max())
    y = inp["x"]
    for s in range(RANKS_SMALL["stages"]):
        y = torch.tanh(y @ inp["ws"][s])
    y = y.cpu().numpy()
    worst = {"psum": 0.0, "ef": 0.0, "gpipe": 0.0}
    for k, r in enumerate(res):
        worst["psum"] = max(worst["psum"], float(np.abs(r["psum"][0] - mean).max()))
        worst["ef"] = max(worst["ef"], float(np.abs(r["psum"][1] - err[k % n]).max()))
        worst["gpipe"] = max(worst["gpipe"], float(np.abs(r["gpipe"] - y).max()))
    if worst["psum"] > tol or worst["ef"] > tol or worst["gpipe"] > 1e-5:
        fail(f"[ranks-small] compressed_psum / gpipe against the plain versions: {worst} "
             f"(tolerances {tol:.3g}, {tol:.3g}, 1e-5)")
    log(f"[ranks-small] one spawn of 8 gloo ranks, a (2, 4) mesh: 4 on cuda:0 with the CUDA "
        f"kernels, 4 on the CPU with kernels='torch' ({t_ranks:.2f} s; the stacked references "
        f"{t_ref:.2f} s): {len(queries)} queries' rows identical to the stacked engine's on the "
        f"card ({sum(w.n_matches for w in want)} rows) on all 8; launches a card rank "
        f"{[r['launches'] for r in card]}")
    log(f"[ranks-small] seconds a part, card ranks {[r['secs'] for r in card]}; CPU ranks "
        f"{[r['secs'] for r in host]}")
    log(f"[ranks-small] the four chaos cases on {len(held)} queries: rows, completeness, "
        f"reason, shard health and fetch retries equal to the stacked engine's on every card "
        f"rank ({ {w: sorted({tuple(sorted(c[3].items())) for c in v}) for w, v in want_chaos.items()} })")
    log(f"[ranks-small] compressed_psum over each row's 4 ranks (gradients {RANKS_SMALL['grad']}) "
        f"against the single-process int8 sum: max |mean error| {worst['psum']:.3g}, max |EF "
        f"residual error| {worst['ef']:.3g} (tol {tol:.3g}); gpipe over the 2 stages of each "
        f"pod ({RANKS_SMALL['micro']} microbatches of {RANKS_SMALL['mb']} x {RANKS_SMALL['d']}) "
        f"against the sequential stages: max |diff| {worst['gpipe']:.3g} (tol 1e-5)")
    log(f"[ranks-small] phase {time.perf_counter() - t_phase:.1f} s")
    return [r["probe"] for r in card]


# ------------------------------------------------------------------ [serve]
def pct(xs, q: float) -> str:
    return "-" if not xs else f"{float(np.percentile(xs, q)) * 1e3:.3f}"


def served_rows(outcomes, want, what: str) -> None:
    """Fail unless every outcome's rows equal ``want``'s, in order."""
    for i, (o, w) in enumerate(zip(outcomes, want)):
        if o.rows.shape != w.shape or not (o.rows == w).all():
            fail(f"[serve] q{i}: {what} gave {o.rows.shape[0]} rows, not the sequential "
                 f"stream's {w.shape[0]} in its order")


def no_failure(server, outcomes, what: str) -> None:
    """A failed outcome hides its exception (a kernel that did not launch,
    too) behind a status: any one, or a global degradation, fails."""
    bad = [(i, o.error) for i, o in enumerate(outcomes) if o.status == "failed"]
    if bad:
        fail(f"[serve] {what}: failed outcomes {bad}")
    if server.stats.global_degradations:
        fail(f"[serve] {what}: {server.stats.global_degradations} global degradations")


def phase_serve(session, g, edge_keys) -> None:
    """The continuous-batching server on the main path's session and graph:
    ``mixed_workload`` of 32 queries served at `ServerConfig`'s defaults,
    held query by query to the sequential streams; open loop from the main
    thread with the scheduler on its own; a deadline of 0 sheds all."""
    from repro_torch.api.serve import ServerConfig, summarize_outcomes
    from repro_torch.kernels import cuda
    from repro_torch.workloads import mixed_workload

    session.set_kernels("cuda")
    workload = mixed_workload(g, 32, n_labels=PATENTS["n_labels"], rng=np.random.default_rng(0))
    cfg = ServerConfig()
    log(f"[serve] mixed_workload: {len(workload)} of 32 drawn queries (a DFS query from "
        f"an isolated node is dropped); nodes {[q.n_nodes for q in workload]}, edges "
        f"{[len(q.edges) for q in workload]}); ServerConfig defaults: max_inflight "
        f"{cfg.max_inflight}, block_rows {cfg.block_rows}, max_matches {cfg.max_matches}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hits, misses = session.cache.hits, session.cache.misses
    cuda.reset_launch_counts()
    server = session.serve()
    t0 = time.perf_counter()
    outcomes = server.serve(workload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    no_failure(server, outcomes, "synchronous serve")
    for sym in MATCHER_KERNELS:
        if counts[sym] <= 0:
            fail(f"[serve] kernel {sym} was never launched while serving")
    st = server.stats
    log(f"[serve] served {len(workload)} queries in {wall:.3f} s: "
        f"{len(workload) / wall:.2f} queries a second")
    for name in ("wall_s", "ttfp_s", "queue_s"):
        xs = [getattr(o, name) for o in outcomes if getattr(o, name) is not None]
        log(f"[serve] {name}: p50 {pct(xs, 50)} ms, p99 {pct(xs, 99)} ms over {len(xs)} queries")
    log(f"[serve] {summarize_outcomes(outcomes)} (served/partial/failed, matches); "
        f"partial reasons {[o.stats.degrade_reason or 'overflow' for o in outcomes if o.status == 'partial']}")
    log(f"[serve] join quanta {st.join_quanta}, setup quanta {st.setup_quanta}, warm admissions "
        f"{st.warm_admissions}, peak in flight {st.peak_inflight}, {len(st.buckets)} buckets; "
        f"cache {session.cache.hits - hits} hits / {session.cache.misses - misses} misses; "
        f"global degradations {st.global_degradations}; launches "
        f"{ {k: counts[k] for k in MATCHER_KERNELS} }; max_memory_allocated "
        f"{peak / 1e9:.3f} GB")

    # each query alone, as a stream: the rows the server must give, in order
    want = []
    for q in workload:
        pages = list(session.compile(q).stream(max_matches=cfg.max_matches,
                                               block_rows=cfg.block_rows))
        want.append(np.concatenate([p.rows for p in pages]) if pages
                    else np.zeros((0, q.n_nodes), np.int64))
    served_rows(outcomes, want, "the server")
    for q, o in zip(workload, outcomes):
        embedding_check(g, edge_keys, q, o.rows)
    log(f"[serve] every query's {sum(len(w) for w in want)} rows equal, in order, its "
        f"sequential compiled.stream(max_matches={cfg.max_matches}, "
        f"block_rows={cfg.block_rows}); every row a valid embedding")

    # open loop: the scheduler on its own thread, submissions from this one
    t0 = time.perf_counter()
    with session.serve() as srv:
        tickets = [srv.submit(q) for q in workload]
        threaded = [t.result(timeout=600) for t in tickets]
    torch.cuda.synchronize()
    no_failure(srv, threaded, "open loop")
    served_rows(threaded, want, "the open-loop server")
    log(f"[serve] open loop (with session.serve() as srv, submitted from the main thread): "
        f"the same rows a query, {time.perf_counter() - t0:.3f} s")

    # a deadline of 0: every query is shed at admission, nothing launches
    cuda.reset_launch_counts()
    shed_server = session.serve(deadline_s=0.0)
    shed = shed_server.serve(workload)
    torch.cuda.synchronize()
    moved = {k: v for k, v in cuda.launch_counts().items() if v}
    if moved or shed_server.stats.setup_quanta or shed_server.stats.join_quanta:
        fail(f"[serve] deadline 0: launches {moved}, quanta {shed_server.stats.as_dict()}")
    if not all(o.status == "partial" and o.stats.degrade_reason == "deadline" and not o.n_matches
               for o in shed):
        fail("[serve] deadline 0: a query was not shed at admission")
    log(f"[serve] deadline_s=0: {summarize_outcomes(shed)}, every query shed at admission "
        f"(reason deadline), 0 launches, 0 quanta")
    log(f"[serve] one server.serve(workload) traced: "
        f"{profile_line(device_profile(lambda: session.serve().serve(workload), reps=1))}")


# ------------------------------------------------------------------ [chaos]
def phase_chaos(small, queries, caps) -> None:
    """Seeded faults on the sharded engine (4 shards of the 2,000-node
    graph, on the card) and forced overflow on the local engine, every
    result held to the clean runs: partial, typed, and never a wrong row."""
    from repro_torch.api import GraphSession
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.kernels import cuda
    from repro_torch.runtime import ChaosConfig, ChaosInjector, RetryPolicy

    pg4 = PartitionedGraph.build(small, 4)
    loc, clean = GraphSession.open(small), GraphSession.open(pg4)
    # (query, local rows, clean sharded rows), both complete at these caps:
    # no escalation re-runs the fetch gate (a healed shard would read "ok")
    held = []
    for q in queries:
        a = loc.run(q, max_matches=0, adaptive=False, **caps)
        b = clean.run(q, max_matches=0, adaptive=False, **caps)
        if a.complete and b.complete and a.n_matches:
            held.append((q, set(map(tuple, a.rows.tolist())), set(map(tuple, b.rows.tolist()))))
    if not held:
        fail("[chaos] no query is complete on both clean engines: nothing holds the faults")
    policy = RetryPolicy()
    cuda.reset_launch_counts()
    for what, kw in CHAOS_FAULTS.items():
        n_rows, health = [], set()
        for q, want_local, want_clean in held:
            s = GraphSession.open(pg4, chaos=ChaosInjector(ChaosConfig(seed=0, **kw)))
            if s.kernels.name != "chaos(cuda)":
                fail(f"[chaos] chaos= on the card gave kernels {s.kernels.name!r}")
            res = s.run(q, max_matches=0, adaptive=False, retry_policy=policy, **caps)
            got = set(map(tuple, res.rows.tolist()))
            h, reason = res.stats.shard_health, res.stats.degrade_reason
            health.add(tuple(sorted(h.items())))
            n_rows.append(len(got))
            if "never heals" in what:
                ok = (got <= want_local and not res.complete and h[1] == "dead"
                      and reason == "shard-fault" and res.stats.fetch_retries == policy.fetch_retries)
            elif "heals" in what:
                ok = got == want_clean and res.complete and h[2] == "recovered"
            elif "truncated" in what:
                ok = got <= want_local and not res.complete and h[3] == "truncated"
            else:
                ok = got == want_clean and res.complete and h[0] == "slow"
            if not ok or len(got) != res.n_matches:
                fail(f"[chaos] {what}: {len(got)} rows (clean {len(want_clean)}), complete "
                     f"{res.complete}, reason {reason}, health {h}, fetch retries "
                     f"{res.stats.fetch_retries}")
        log(f"[chaos] sharded, 4 shards, {what}: rows a query {n_rows} (clean "
            f"{[len(c) for _, _, c in held]}), shard health {sorted(health)}: held")
    counts = cuda.launch_counts()
    for sym in MATCHER_KERNELS:
        if counts[sym] <= 0:
            fail(f"[chaos] kernel {sym} was never launched under chaos(cuda)")
    # forced overflow on the local engine: the first result is final under a
    # ceiling below any escalation, typed, its rows a subset (here all)
    inj = ChaosInjector(ChaosConfig(seed=0, force_overflow=True))
    s = GraphSession.open(small, chaos=inj)
    for q, want_local, _ in held:
        res = s.run(q, max_matches=0, retry_policy=RetryPolicy(ceiling_bytes=1.0), **caps)
        got = set(map(tuple, res.rows.tolist()))
        if res.complete or res.stats.degrade_reason != "overflow-ceiling" or not got <= want_local:
            fail(f"[chaos] forced overflow: complete {res.complete}, reason "
                 f"{res.stats.degrade_reason}, {len(got)} rows of {len(want_local)}")
    log(f"[chaos] local, forced overflow under RetryPolicy(ceiling_bytes=1.0): {len(held)} "
        f"queries partial, reason overflow-ceiling, rows a subset of the clean run's "
        f"({inj.op_calls['mask_to_host']} mask_to_host calls through chaos(cuda)); launches "
        f"over the sharded fault runs { {k: counts[k] for k in MATCHER_KERNELS} }")


# ---------------------------------------------------------------- phase 8
def rel_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max|got - want| / max|want|; fails above 1e-4 (fp32, TF32 off, sums
    of up to 7,800 products in another order), on a non-finite value, or
    when ``want`` is all zeros."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{what}: non-finite values")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if scale == 0:
        fail(f"{what}: the plain version is all zeros, so the check would hold nothing")
    if err > 1e-4 * scale:
        fail(f"{what}: max|kernel - plain| {err:.3e} > 1e-4 · max|plain| ({scale:.3e})")
    return err



def scaled_err(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor,
               what: str, tol: float = 1e-4) -> tuple[float, float]:
    """``(largest |got - want| / scale, largest |got - want|)``, each element
    held to its own ``scale`` (broadcast to ``got``'s shape): fails above
    ``tol``, on a non-finite value, or where ``scale`` is 0 and the two
    differ at all."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    scale = scale.expand_as(err)
    bad = err > tol * scale
    if bad.any():
        i = tuple(int(x) for x in bad.nonzero()[0])
        fail(f"{what}: {int(bad.sum())} elements off; at {i} |kernel - plain| "
             f"{err[i].item():.3e} > {tol:g} · its scale {scale[i].item():.3e}")
    return ((err / scale.clamp_min(torch.finfo(scale.dtype).tiny)).max().item(),
            err.max().item())


def row_scale(want: torch.Tensor) -> torch.Tensor:
    """Each row's largest |value|, floored at the median row's: the scale a
    row of GNN logits is held to. Logits of an R-MAT graph span many orders
    of magnitude (GIN sums, unnormalised, over hubs), so one scale for all
    rows would hold the typical row to nothing; the floor keeps a row whose
    logits cancel to near zero at a typical row's scale."""
    r = want.abs().amax(dim=1, keepdim=True)
    return r.clamp_min(r.median())


def cin_parts(xk, x0, w, ks: int) -> torch.Tensor:
    """``cin_layer``'s kernel called directly with the ``h`` range in ``ks``
    parts, whatever ``splits`` would choose: the times behind its cost."""
    from repro_torch.kernels.cin import cin

    (B, H, d), m, Hp = xk.shape, x0.shape[1], w.shape[1]
    out = torch.empty((B, Hp, d), dtype=torch.float32, device=xk.device)
    part = torch.empty((ks, B, Hp, d) if ks > 1 else (0,), dtype=torch.float32, device=xk.device)
    cin.CIN(xk.data_ptr(), x0.data_ptr(), w.data_ptr(), out.data_ptr(), part.data_ptr(), B, H, m,
            d, Hp, ks)
    return out


def phase_recsys(dev, smi: str) -> list[dict]:
    from repro_torch.configs import xdeepfm
    from repro_torch.core.backend import get_kernels
    from repro_torch.data.pipeline import recsys_batch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.cin.cin import splits
    from repro_torch.models.recsys import XDeepFM, embedding_bag
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_k, plain = get_kernels("cuda"), get_kernels("torch")
    from repro_torch.extras.shapes import REC_SHAPES

    cfg, shapes = xdeepfm.CONFIG, REC_SHAPES
    n_cin = len(cfg.cin_layers)

    # ---- the smoke config: the same logits on the card and on the CPU -----
    small = xdeepfm.smoke()
    s_gpu = XDeepFM(small, device=dev)
    s_cpu = XDeepFM(small, device="cpu")
    s_cpu.load_state_dict({k: v.cpu() for k, v in s_gpu.state_dict().items()})
    b = recsys_batch(small, 256, seed=0, step=0)
    cand_small = np.arange(small.vocab_per_field, dtype=np.int32)
    f_gpu, f_cpu = make_serve_fns(small, s_gpu), make_serve_fns(small, s_cpu)
    e1 = rel_err(f_gpu["score"](b["ids"], b["bag_mask"]).cpu(),
                 f_cpu["score"](b["ids"], b["bag_mask"]), "smoke logits, card vs CPU")
    e2 = rel_err(f_gpu["retrieve"](b["ids"][:1], b["bag_mask"][:1], cand_small).cpu(),
                 f_cpu["retrieve"](b["ids"][:1], b["bag_mask"][:1], cand_small),
                 "smoke retrieval scores, card vs CPU")
    log(f"[recsys] smoke config: logits and retrieval scores agree on card and CPU "
        f"(max abs err {e1:.3e}, {e2:.3e})")
    del s_gpu, s_cpu

    # ---- set-up: the full-width model and the inputs, on the card ----------
    t0 = time.perf_counter()
    model = XDeepFM(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    if model.kernels.name != "cuda":
        fail(f"XDeepFM on the card chose kernels {model.kernels.name!r}")
    fns = make_serve_fns(cfg, model)

    def batch(shape_id, step):
        bt = recsys_batch(cfg, shapes[shape_id]["batch"], seed=0, step=step)
        return (torch.from_numpy(bt["ids"]).to(dev), torch.from_numpy(bt["bag_mask"]).to(dev))

    p99, bulk, query = batch("serve_p99", 0), batch("serve_bulk", 1), batch("retrieval_cand", 2)
    cand = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_per_field, shapes["retrieval_cand"]["n_candidates"]).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[recsys] xdeepfm {cfg}: {n_params} parameters ({4 * n_params / 1e9:.3f} GB) "
        f"made on the card from seed 0, inputs from recsys_batch, in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- the path: score p99, score bulk, retrieve, counted ----------------
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    logits_p99 = fns["score"](*p99)
    logits_bulk = fns["score"](*bulk)
    scores = fns["retrieve"](*query, cand)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["cin_layer"] != 2 * n_cin:
        fail(f"cin_layer launched {counts['cin_layer']} times for 2 forwards of {n_cin} layers")
    for what, t, n in (("serve_p99 logits", logits_p99, shapes["serve_p99"]["batch"]),
                       ("serve_bulk logits", logits_bulk, shapes["serve_bulk"]["batch"]),
                       ("retrieval scores", scores, cand.numel())):
        if t.shape != (n,) or not torch.isfinite(t).all():
            fail(f"{what}: shape {tuple(t.shape)} or non-finite values")
    log(f"[recsys] path run: score at serve_p99 and serve_bulk, retrieve at retrieval_cand; "
        f"cin_layer launches {counts['cin_layer']} ({n_cin} per forward); "
        f"max_memory_allocated {peak / 1e9:.3f} GB")

    # ---- each CIN layer at serve_p99 against its plain version -------------
    with torch.inference_mode():
        x0 = embedding_bag(model.tables, *p99)
        xk, layer_rows, p99_cin_ms = x0, [], 0.0
        for i in range(n_cin):
            args = (xk, x0, model.cin[f"w{i}"])
            got, want = cuda_k.cin_layer(*args), plain.cin_layer(*args)
            err = rel_err(got, want, f"CIN layer {i} at serve_p99")
            ms = time_ms(lambda: cuda_k.cin_layer(*args))
            plain_ms = time_ms(lambda: plain.cin_layer(*args))
            B, H, d = xk.shape
            W = args[2]
            lib_ms = time_ms(lambda: torch.einsum(
                "bhd,bmd,hmk->bkd", xk, x0, W.view(H, x0.shape[1], W.shape[1])))
            row = kernel_row("cin_layer", args, {}, counts["cin_layer"], err, ms, plain_ms, lib_ms)
            fp32_ms = work("cin_layer", args, {})[1] / CUDA_CORE_OPS_PER_S * 1e3
            log(f"[recsys] CIN layer {i} serve_p99 {tuple(xk.shape)} x {tuple(W.shape)}: "
                f"max abs err {err:.3e} ({err / want.abs().max().item():.3e} of max|plain|); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, einsum {lib_ms:.4f} ms, TF32 "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), fp32 bound {fp32_ms:.4f} "
                f"ms, {work('cin_layer', args, {})[1] / ms / 1e9:.2f} TFLOP/s")
            # the same bits at every run; the time at each count of h parts
            if not torch.equal(got, cuda_k.cin_layer(*args)):
                fail(f"CIN layer {i} at serve_p99: two runs of the kernel differ")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            by_ks = {}
            for ks in (*range(1, 7), *range(6, 0, -1)):
                rel_err(cin_parts(*args, ks), want, f"CIN layer {i} at serve_p99 in {ks} parts")
                by_ks.setdefault(ks, []).append(time_ms(lambda: cin_parts(*args, ks)))
            log(f"[recsys] CIN layer {i} serve_p99 by parts of h (ks: ms, ascending then "
                f"descending), each within 1e-4, two runs bit-identical: "
                f"{ {k: [round(t, 4) for t in v] for k, v in by_ks.items()} }; "
                f"splits() chooses {splits(B * d, W.shape[1], H, sms)} on {sms} SMs")
            layer_rows.append(row)
            p99_cin_ms += ms
            xk = want
        model.set_kernels("torch")
        plain_logits = fns["score"](*p99)
        plain_bulk = fns["score"](bulk[0][:4096], bulk[1][:4096])
        model.set_kernels("cuda")
        e_p99 = rel_err(logits_p99, plain_logits, "serve_p99 logits")
        e_bulk = rel_err(logits_bulk[:4096], plain_bulk, "serve_bulk logits, first 4,096 rows")
        log(f"[recsys] logits within 1e-4 · max|plain| of kernels='torch': serve_p99 max abs "
            f"err {e_p99:.3e}, serve_bulk first 4,096 rows {e_bulk:.3e}")

        # ---- times ------------------------------------------------------
        fwd_p99 = time_ms(lambda: fns["score"](*p99))
        model.set_kernels("torch")
        fwd_p99_plain = time_ms(lambda: fns["score"](*p99))
        model.set_kernels("cuda")
        fwd_bulk = time_ms(lambda: fns["score"](*bulk), reps=3)
        x0 = embedding_bag(model.tables, *bulk)
        xk, bulk_cin_ms, bulk_layers, bulk_bounds, bulk_errs = x0, 0.0, [], [], []
        for i in range(n_cin):
            args = (xk, x0, model.cin[f"w{i}"])
            ms = time_ms(lambda: cuda_k.cin_layer(*args), reps=3)
            bulk_layers.append(ms)
            bulk_cin_ms += ms
            ops = work("cin_layer", args, {})[1]
            bulk_bounds.append((ops / CUDA_CORE_OPS_PER_S * 1e3, ops / TF32_OPS_PER_S * 1e3))
            out = cuda_k.cin_layer(*args)
            # each layer at the bulk N = B·d, held on its first 4,096 rows
            # (plain at full bulk would need the 82 GB z)
            bulk_errs.append(rel_err(out[:4096], plain.cin_layer(xk[:4096], x0[:4096], args[2]),
                                     f"CIN layer {i} at serve_bulk, first 4,096 rows"))
            xk = out
        del x0, xk, out
        log(f"[recsys] each CIN layer at serve_bulk within 1e-4 · max|plain| on its first "
            f"4,096 rows: max abs err {[f'{e:.3e}' for e in bulk_errs]}")
        retrieve_ms = time_ms(lambda: fns["retrieve"](*query, cand))
    log(f"[recsys] serve_p99 forward {fwd_p99:.4f} ms (kernels='torch': {fwd_p99_plain:.4f} ms), "
        f"CIN kernels {p99_cin_ms:.4f} ms = {100 * p99_cin_ms / fwd_p99:.1f}% of it")
    log(f"[recsys] serve_bulk forward {fwd_bulk:.4f} ms, CIN kernels "
        f"{[round(x, 4) for x in bulk_layers]} ms = {100 * bulk_cin_ms / fwd_bulk:.1f}% of it "
        f"(fp32 / TF32 bounds {[(round(a, 4), round(b, 4)) for a, b in bulk_bounds]} ms); "
        f"retrieval_cand {retrieve_ms:.4f} ms; max_memory_allocated {peak / 1e9:.3f} GB")
    n_bulk = shapes["serve_bulk"]["batch"]
    log(f"[recsys] serve_bulk forward (CIN on split-TF32 tensor cores): "
        f"{flops_share(model_flops_recsys(cfg, n_bulk, 'serve'), fwd_bulk, 'tf32', smi)}")
    # the kernel line's row: the largest layer (1) at serve_p99
    return [max(layer_rows, key=lambda r: r["bound_ms"])]


# ---------------------------------------------------------------- phase 9
def recording_segment_mp(n_keep: int):
    """The CUDA backend, keeping a copy of the inputs of its first
    ``n_keep`` ``segment_mp`` calls (a model may change its messages in
    place after the call)."""
    from repro_torch.core.backend import CudaKernels

    class Recording(CudaKernels):
        def __init__(self):
            self.args = []

        def segment_mp(self, messages, dst_sorted, n_nodes):
            if len(self.args) < n_keep:
                self.args.append((messages.clone(), dst_sorted, n_nodes))
            return super().segment_mp(messages, dst_sorted, n_nodes)

    return Recording()


def phase_gnn(dev) -> tuple[list[dict], object]:
    import dataclasses

    from repro_torch.configs import egnn, gatedgcn, gin_tu, meshgraphnet
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.core.backend import get_kernels
    from repro_torch.data.pipeline import gnn_full_batch, gnn_minibatch
    from repro_torch.graphstore import generators
    from repro_torch.graphstore.sampler import NeighborSampler
    from repro_torch.kernels import cuda
    from repro_torch.models.gnn import GNN, batch_to
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_k, plain = get_kernels("cuda"), get_kernels("torch")

    # ---- the smoke configs: the same outputs on the card and on the CPU ----
    small = generators.rmat(2000, 8000, 4, seed=0)
    smoke_errs = {}
    for mod in (gin_tu, gatedgcn, egnn, meshgraphnet):
        cfg = mod.smoke()
        m_gpu = GNN(cfg, device=dev)
        m_cpu = GNN(cfg, device="cpu")
        m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
        batches = [gnn_full_batch(cfg, small, n_classes=cfg.n_classes, seed=0)]
        if mod is gatedgcn:
            batches.append(gnn_minibatch(cfg, small, NeighborSampler(small, (5, 3), seed=0),
                                         batch_nodes=32, n_classes=cfg.n_classes, seed=0,
                                         step=0))
        f_gpu, f_cpu = make_serve_fns(cfg, m_gpu)["infer"], make_serve_fns(cfg, m_cpu)["infer"]
        for i, b in enumerate(batches):
            smoke_errs[f"{cfg.name}/{i}"] = rel_err(f_gpu(b).cpu(), f_cpu(b),
                                                    f"{cfg.name} smoke outputs, card vs CPU")
    log(f"[gnn] smoke configs: outputs agree on card and CPU (max abs err "
        f"{ {k: f'{v:.3e}' for k, v in smoke_errs.items()} })")

    # ---- set-up: the graph, the batches, the models ------------------------
    t0 = time.perf_counter()
    g = generators.rmat(PRODUCTS["n_nodes"], PRODUCTS["n_edges"], PRODUCTS["n_labels"],
                        seed=PRODUCTS["seed"])
    log(f"[gnn] ogbn-products-shaped R-MAT: {g.n_nodes} nodes, {g.n_edges} directed edges "
        f"(of at most {2 * PRODUCTS['n_edges']}: self-loops and duplicates dropped), max degree "
        f"{g.max_degree()}, built in {time.perf_counter() - t0:.2f} s")
    gin_cfg = dataclasses.replace(gin_tu.CONFIG, d_in=GNN_SHAPES["ogb_products"]["d"])
    gg_cfg = dataclasses.replace(gatedgcn.CONFIG, d_in=GNN_SHAPES["minibatch_lg"]["d"])
    t0 = time.perf_counter()
    full = batch_to(gnn_full_batch(gin_cfg, g, n_classes=gin_cfg.n_classes, seed=0), dev)
    t_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(g, (15, 10), seed=0)
    mb_host = gnn_minibatch(gg_cfg, g, sampler, batch_nodes=1024, n_classes=gg_cfg.n_classes,
                            seed=0, step=0)
    mb = batch_to(mb_host, dev)
    t_mb = time.perf_counter() - t0
    node_cap, edge_cap = sampler.capacities(1024)
    if (node_cap, edge_cap) != (169_984, 168_960) or mb.edge_src.shape[0] != edge_cap:
        fail(f"minibatch_lg capacities {(node_cap, edge_cap)}, not (169984, 168960)")
    del g, sampler
    paths = []  # name, model, serve fn, batch, segment_mp calls a layer, timing repetitions
    for what, cfg, batch, per, reps in (("gin", gin_cfg, full, 1, 5),
                                        ("gatedgcn", gg_cfg, mb, 2, 10)):
        model = GNN(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        if model.kernels.name != "cuda":
            fail(f"GNN on the card chose kernels {model.kernels.name!r}")
        paths.append((what, model, make_serve_fns(cfg, model)["infer"], batch, per, reps))
    torch.cuda.synchronize()
    log(f"[gnn] gnn_full_batch ({full.node_feat.shape[0]} nodes x {gin_cfg.d_in}, "
        f"{full.edge_src.shape[0]} edges) on the card in {t_full:.2f} s; minibatch_lg "
        f"({mb_host.node_feat.shape[0]} node slots, {int(mb_host.node_mask.sum())} real; "
        f"{edge_cap} edge slots, {int(mb_host.edge_mask.sum())} real) sampled in {t_mb:.2f} s")

    # ---- the path: GIN full-graph inference, GatedGCN minibatch, counted ---
    torch.cuda.reset_peak_memory_stats()
    launches, outs = {}, {}
    for what, model, fn, batch, per, _ in paths:
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        outs[what] = fn(batch)
        torch.cuda.synchronize()
        launches[what] = cuda.launch_counts()["segment_mp"]
        if launches[what] != per * model.cfg.n_layers:
            fail(f"{what}: segment_mp launched {launches[what]} times in one forward of "
                 f"{model.cfg.n_layers} layers ({per} a layer)")
        shape = (batch.node_feat.shape[0], model.cfg.n_classes)
        if outs[what].shape != shape or not torch.isfinite(outs[what]).all():
            fail(f"{what}: logits of shape {tuple(outs[what].shape)} or non-finite values")
    log(f"[gnn] path run: GIN-TU infer on the full graph, GatedGCN infer on minibatch_lg; "
        f"segment_mp launches {launches} (1 a GIN layer, 2 a GatedGCN layer); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    # ---- each path against plain: logits, first-layer aggregations, times --
    rows = []
    for what, model, fn, batch, per, reps in paths:
        model.set_kernels("torch")
        want = fn(batch)
        scale = row_scale(want)
        errs = {"logits": scaled_err(outs[what], want, scale, f"{what} logits")}
        # float atomics (the kernel's and index_add_'s) change the last bits
        # from run to run: the plain version against itself shows how much
        plain_noise = scaled_err(fn(batch), want, scale, f"{what} logits, plain vs plain")[0]
        fwd_plain = time_ms(lambda: fn(batch), reps=reps)
        model.set_kernels(recording_segment_mp(per))
        fn(batch)
        calls = model.kernels.args  # the first layer's aggregations
        model.set_kernels("cuda")
        again = [scaled_err(fn(batch), want, scale, f"{what} logits, forward {i + 2}")[0]
                 for i in range(2)]
        for i, (msg, dst, n) in enumerate(calls):
            # each element against the segment sum of its |messages|: a node
            # with no in-range edge must come out exactly zero
            errs[f"layer-0 aggregation {i}"] = scaled_err(
                cuda_k.segment_mp(msg, dst, n), plain.segment_mp(msg, dst, n),
                plain.segment_mp(msg.abs(), dst, n), f"{what} first-layer aggregation {i}")
        log(f"[gnn] {what}: within 1e-4 of kernels='torch', the logits row by row (scale: the "
            f"row's max|plain|, floored at the median row's), the first layer's aggregations "
            f"element by element (scale: the segment sum of |messages|); largest "
            f"|kernel - plain| / scale, largest |kernel - plain| "
            f"{ {k: f'{r:.3e}, {e:.3e}' for k, (r, e) in errs.items()} }; logits of two more "
            f"kernel forwards {[f'{r:.3e}' for r in again]}, of a second plain forward "
            f"{plain_noise:.3e}")
        fwd = time_ms(lambda: fn(batch), reps=reps)
        sort_ms = time_ms(lambda: torch.sort(batch.edge_dst, stable=True), reps=reps)
        log(f"[gnn] {what} forward {fwd:.4f} ms (kernels='torch': {fwd_plain:.4f} ms); edge "
            f"sort {sort_ms:.4f} ms; forward {profile_line(device_profile(lambda: fn(batch)))}")
        # the kernel on the first layer's (message) aggregation
        args = calls[-1]
        msg, dst, n = args
        dst_l = dst.long()
        ms = time_ms(lambda: cuda_k.segment_mp(*args))
        plain_ms = time_ms(lambda: plain.segment_mp(*args))
        lib_ms = time_ms(lambda: torch.zeros((n, msg.shape[1]), device=dev).index_add_(
            0, dst_l, msg))
        row = kernel_row("segment_mp", args, {}, sum(launches.values()),
                         errs[f"layer-0 aggregation {len(calls) - 1}"][1], ms, plain_ms, lib_ms)
        b = work("segment_mp", args, {})[0]
        log(f"[gnn] segment_mp, {what} first layer ({tuple(msg.shape)} messages -> {n} "
            f"nodes): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {b / 1e9:.3f} GB), "
            f"{b / ms / 1e9:.3f} TB/s; kernel alone: "
            f"{profile_line(device_profile(lambda: cuda_k.segment_mp(*args)))}")
        if what == "gin":  # the kernel line's row: one GIN layer at the full size
            rows.append(row)
        del calls, args, msg
    del full, mb, paths, outs
    torch.cuda.empty_cache()
    gnn_molecule(dev)
    return rows, mb_host


# ---------------------------------------------------------------- phase 10
def probe_cases(dev):
    """Adversarial (what, ka, kb, dup_cap) cases of the CPU tests, on the card."""
    rng = np.random.default_rng(1)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.uint32).view(np.int32)).to(dev)

    big = np.sort(rng.integers(0, 2**32, 64, dtype=np.uint64)).astype(np.uint32)
    big[-4:] = 0xFFFFFFFF

    def runs(cap_a, cap_b):  # duplicate runs, probe keys half from them
        ka = (np.sort(rng.integers(0, cap_a // 3 + 1, cap_a)) * 977).astype(np.uint32)
        ka[-1] = 0xFFFFFFFF
        kb = np.where(rng.random(cap_b) < 0.5, ka[rng.integers(0, cap_a, cap_b)],
                      rng.integers(0, 2**32, cap_b, dtype=np.uint64).astype(np.uint32))
        return t(ka), t(kb)

    return [
        ("keys >= 2**31", t(big), t(np.concatenate([big[::3], [0, 0xFFFFFFFF, 2**31,
                                                               2**31 - 1, 2**31 + 1]])), 4),
        ("pow2 capA, full run", t([0, 5, 5, 5, 5, 5, 5, 9]), t([5, 9, 0, 4, 6, 10, 0xFFFFFFFF]), 6),
        ("dup_cap > capA", t([3, 3, 7]), t([3, 7, 1, 8]), 5),
        # dup_cap 1, 17 and 67 (not multiples of 16), capB 1, 1,003 and
        # 16,387 (not multiples of 16)
        ("dup_cap 1, capB 1,003", *runs(8192, 1003), 1),
        ("dup_cap 17, capB 1,003", *runs(8192, 1003), 17),
        ("dup_cap 67, capB 16,387", *runs(8192, 16_387), 67),
        ("dup_cap 17, capB 1", *runs(300, 1), 17),
    ]


def phase_probe(dev, probe_call) -> list[dict]:
    from repro_torch.core.backend import get_kernels
    from repro_torch.extras.join_probe import join_probe, ops, ref
    from repro_torch.kernels import cuda

    (ka, a_keys, a_valid, kb, b_keys, b_valid), dup = probe_call[1], probe_call[2]["dup_cap"]
    # ---- the path: lower bound then window, counted ------------------------
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    lo = ops.lower_bound(ka, kb)
    hit, idx = ops.window(ka, kb, lo, dup_cap=dup)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    for sym in ("probe_lower_bound", "probe_window"):
        if counts[sym] <= 0:
            fail(f"kernel {sym} was never launched on its path")
    # ---- bit-exact against the plain versions ------------------------------
    lo_p = ref.lower_bound_reference(ka, kb)
    err_lo = max_abs_err(lo, lo_p)
    err_w = max_abs_err((hit, idx), ref.window_reference(ka, kb, lo_p, dup_cap=dup))
    cases = probe_cases(dev)
    for what, a, b, d in cases:
        la, lb = ops.lower_bound(a, b), ref.lower_bound_reference(a, b)
        err_lo = max(err_lo, max_abs_err(la, lb))
        got = ops.window(a, b, la, dup_cap=d)
        err_w = max(err_w, max_abs_err(got, ref.window_reference(a, b, lb, dup_cap=d)))
        if what.startswith("pow2") and not bool(got[0][0].all()):
            fail("probe_window missed a duplicate of a run that fills the window")
    if err_lo or err_w:
        fail(f"join probe kernels differ from their plain versions ({err_lo}, {err_w})")
    # ---- agreement with the matcher's probe --------------------------------
    h_ref, i_ref = get_kernels("cuda").hash_join_probe(ka, a_keys, a_valid, kb, b_keys, b_valid,
                                                       dup_cap=dup)
    verified = (hit & a_valid[idx.long()] & b_valid[:, None]
                & (a_keys[idx.long()] == b_keys[:, None, :]).all(dim=-1))
    if not (torch.equal(verified, h_ref) and torch.equal(idx, i_ref)):
        fail("window hits verified by validity and key columns differ from hash_join_probe")
    log(f"[probe] lower_bound + window on the query path's largest hash_join_probe input "
        f"(capA {ka.numel()}, capB {kb.numel()}, dup {dup}): bit-exact against plain there and "
        f"on {len(cases)} adversarial cases ({'; '.join(c[0] for c in cases)}); verified hits "
        f"({int(h_ref.sum())}) and idx equal hash_join_probe's; launches "
        f"{ {k: counts[k] for k in ('probe_lower_bound', 'probe_window')} }")
    # ---- the lower bound's host path, step by step --------------------------
    ka64, kb64 = ka.long() & 0xFFFFFFFF, kb.long() & 0xFFFFFFFF
    lo_out = torch.empty_like(kb)
    raw = join_probe.LOWER_BOUND._fn

    def stream():  # the read CudaKernel passes to every launch
        return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())

    ptrs = (ka.data_ptr(), ka.numel(), kb.data_ptr())
    steps = {
        "ops.lower_bound (the whole path)": lambda: ops.lower_bound(ka, kb),
        "on_cpu": lambda: cuda.on_cpu(ka, kb),
        "the checks": lambda: (join_probe._check_build_side(ka),
                               cuda.check(kb, "kb", torch.int32, 1)),
        "torch.empty_like (contiguous_format)":
            lambda: torch.empty_like(kb, memory_format=torch.contiguous_format),
        "the stream read (raw accessor)": stream,
        "torch.cuda.current_stream().cuda_stream (the read it replaced)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "three data_ptr()": lambda: (ka.data_ptr(), kb.data_ptr(), lo_out.data_ptr()),
        "the ctypes call, nothing launched (capB 0)":
            lambda: raw(*ptrs, 0, lo_out.data_ptr(), stream()),
        "the ctypes call with its launch": lambda: raw(*ptrs, kb.numel(), lo_out.data_ptr(), stream()),
        "torch.searchsorted (int64, the library call)":
            lambda: torch.searchsorted(ka64, kb64, side="left"),
    }
    log("[probe] probe_lower_bound's host path, µs a call (perf_counter_ns over 2,000 calls, "
        "a sync every 100): " + "; ".join(f"{k} {host_us(f):.3f}" for k, f in steps.items()))
    # ---- times ------------------------------------------------------------
    rows = []
    for op, args, kw, fn, plain_fn, lib in (
        ("probe_lower_bound", (ka, kb), {}, lambda: ops.lower_bound(ka, kb),
         lambda: ref.lower_bound_reference(ka, kb),
         lambda: torch.searchsorted(ka64, kb64, side="left")),
        ("probe_window", (ka, kb, lo), {"dup_cap": dup},
         lambda: ops.window(ka, kb, lo, dup_cap=dup),
         lambda: ref.window_reference(ka, kb, lo, dup_cap=dup), None),
    ):
        ms, lib_ms = time_ms(fn), None if lib is None else time_ms(lib)
        plain_ms = time_ms(plain_fn)
        row = kernel_row(op, args, kw, counts[op], 0, ms, plain_ms, lib_ms)
        rows.append(row)
        turns = "" if lib is None else (
            "; in turns of 100 calls (a, b, b, a): kernel {:.4f} ms, library {:.4f} ms".format(
                *time_ms_turns(fn, lib)))
        log(f"[probe] {op}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms (torch.searchsorted, int64)'}"
            f"{turns}, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{work(op, args, kw)[0] / 1e6:.2f} MB), launches {counts[op]}; device time by a "
            f"CUDA graph of 20 calls {graph_ms(fn):.4f} ms a call"
            + ("" if lib is None else f" (library {graph_ms(lib):.4f})")
            + f"; {eager_times(fn)}"
            + f"; kernel alone: {profile_line(device_profile(fn, reps=10))}"
            + ("" if lib is None else f"; library alone: {profile_line(device_profile(lib, 10))}"))
    return rows


# ---------------------------------------------------------------- phase 11
def recording_flash_attention():
    """The CUDA backend, keeping the inputs of every ``flash_attention``
    call (references: the model does not change them after the call)."""
    from repro_torch.core.backend import CudaKernels

    class Recording(CudaKernels):
        def __init__(self):
            self.args = []

        def flash_attention(self, q, k, v, **kw):
            self.args.append((q, k, v, kw))
            return super().flash_attention(q, k, v, **kw)

    return Recording()


def plain_float64():
    """A backend whose attention is the plain version's arithmetic in
    float64, rounded to the input's dtype: the same function in a finer
    rounding — the control for how far two roundings of the forward part
    (``mha_reference`` itself always computes in float32)."""
    from repro_torch.core.backend import Kernels

    class PlainFloat64(Kernels):
        def flash_attention(self, q, k, v, *, scale=None, window=None, softcap=None):
            B, S, Nq, H = q.shape
            Nkv = k.shape[2]
            scale = H**-0.5 if scale is None else scale
            qg = q.reshape(B, S, Nkv, Nq // Nkv, H).double()
            logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.double()) * scale
            if softcap is not None:
                logits = torch.tanh(logits / softcap) * softcap
            pos = torch.arange(S, device=q.device)
            ok = pos[None, :] <= pos[:, None]
            if window is not None:
                ok &= pos[None, :] > pos[:, None] - window
            p = torch.softmax(logits.masked_fill(~ok, -1e30), dim=-1)
            out = torch.einsum("bkgqs,bskh->bqkgh", p, v.double())
            return out.reshape(B, S, Nq, v.shape[-1]).to(q.dtype)

    return PlainFloat64()


def fma_route(q, k, v, *, scale=None, window=None, softcap=None) -> torch.Tensor:
    """``flash_attention``'s FMA kernel called directly, on a call `route`
    sends to the tensor cores: its time beside the tensor-core route's on
    the served call."""
    from repro_torch.extras.flash_attention import flash_attention as fa

    (B, S, Nq, H), Nkv, Hv = q.shape, k.shape[2], v.shape[3]
    out = torch.empty((B, S, Nq, Hv), dtype=q.dtype, device=q.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)) and H % 4 == 0 and Hv % 4 == 0
    fa.FLASH_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Nq, Nkv,
                       H, Hv, float(scale if scale is not None else H**-0.5), window or 0,
                       float(softcap or 0.0), int(q.dtype == torch.bfloat16), int(vec))
    return out


def own_row_scale(want: torch.Tensor) -> torch.Tensor:
    """Each row's (last axis) own largest |value|."""
    return want.abs().amax(dim=-1, keepdim=True)


def row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over rows of max|got - want| / max|want| along the last
    axis."""
    return ((got - want).abs().amax(dim=-1) / own_row_scale(want)[..., 0]).max().item()


def logits_diff(a: torch.Tensor, b: torch.Tensor, chunk: int = 1024) -> tuple[float, float]:
    """(largest |a - b| / the row's max|b|, largest |a - b|) over (B, S, V)
    logits, in float32, ``chunk`` positions at a time."""
    ratio, err = 0.0, 0.0
    for s0 in range(0, a.shape[1], chunk):
        x, y = a[:, s0:s0 + chunk].float(), b[:, s0:s0 + chunk].float()
        d = (x - y).abs()
        ratio = max(ratio, (d / own_row_scale(y).clamp_min(1e-30)).max().item())
        err = max(err, d.max().item())
    return ratio, err


def moved_by_route() -> dict:
    """``flash_attention``'s launch counts by route."""
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.kernels import cuda

    counts = cuda.launch_counts()
    return {r: counts[k.symbol] for r, k in fa.ROUTES.items()}


def routed(fn, want: str, what: str):
    """``fn()``, failing unless it launched ``flash_attention``'s route
    ``want`` once and the other routes not at all."""
    before = moved_by_route()
    out = fn()
    after = moved_by_route()
    moved = {r: after[r] - before[r] for r in after}
    if moved != {r: int(r == want) for r in after}:
        fail(f"{what}: route launches {moved}, expected one {want!r}")
    return out


def grown_cache(cfg, cache, n: int, dev):
    """A prefill's cache grown by ``n`` slots, as ``src/repro/launch/
    serve.py`` ``serve_lm`` grows it."""
    from repro_torch.models.transformer import init_cache

    B, S = cache.data[0].shape[1:3]
    grown = init_cache(cfg, B, S + n, device=dev)
    for z, c in zip(grown.data, cache.data):
        z[:, :, :S] = c
    return grown


def greedy(fns, logits, cache, cfg, dev, n: int):
    """``n`` greedy decode steps after a prefill, into its cache grown by
    ``n`` slots (`grown_cache`): the tokens ``(B, n + 1)``, the grown cache
    and the last step's logits."""
    S = logits.shape[1]
    grown = grown_cache(cfg, cache, n, dev)
    tok = logits[:, -1:].argmax(-1)
    out = [tok]
    for i in range(n):
        step_logits, grown = fns["decode"](grown, tok, S + i)
        tok = step_logits.argmax(-1)
        out.append(tok)
    return torch.cat(out, 1), grown, step_logits


def phase_lm(dev, smi: str) -> list[dict]:
    import dataclasses

    from repro_torch.configs import gemma_2b, qwen2_72b
    from repro_torch.core.backend import get_kernels
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.extras.flash_attention.ref import mha_reference
    from repro_torch.kernels import cuda
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_k = get_kernels("cuda")
    B, S, T = LM_SERVE["batch"], LM_SERVE["seq"], LM_SERVE["decode"]

    # ---- the smoke configs: the same logits on the card and on the CPU -----
    smoke_errs = {}
    for small in (gemma_2b.smoke(), dataclasses.replace(qwen2_72b.smoke(), sliding_window=40,
                                                        attn_logit_softcap=30.0)):
        m_gpu = Transformer(small, device=dev)
        m_cpu = Transformer(small, device="cpu")
        m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
        toks = lm_batch(small, 2, 200, seed=0, step=0)["tokens"]
        want = make_serve_fns(small, m_cpu)["prefill"](toks)[0]
        got = make_serve_fns(small, m_gpu)["prefill"](toks)[0].cpu()
        smoke_errs[small.name] = scaled_err(got, want, own_row_scale(want),
                                            f"{small.name} logits, card vs CPU")[0]
    log(f"[lm] smoke configs (2 x 200 tokens): logits within 1e-4 of each row's max|cpu| on "
        f"card and CPU (largest ratio { {k: f'{v:.3e}' for k, v in smoke_errs.items()} })")

    # ---- set-up: gemma-2b at its published widths, bf16, seed 0 -------------
    cfg = gemma_2b.CONFIG
    t0 = time.perf_counter()
    model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    if model.kernels.name != "cuda":
        fail(f"Transformer on the card chose kernels {model.kernels.name!r}")
    fns = make_serve_fns(cfg, model)
    tokens = torch.from_numpy(lm_batch(cfg, B, S, seed=0, step=0)["tokens"]).to(dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(nbytes(p) for p in model.parameters())
    log(f"[lm] gemma-2b ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads on "
        f"{cfg.n_kv_heads}, head_dim {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}): {n_params} parameters ({n_bytes / 1e9:.3f} GB) made on the card from "
        f"seed 0, lm_batch tokens {tuple(tokens.shape)}, in {time.perf_counter() - t0:.2f} s")

    # ---- the path: prefill, then greedy decode; counted ---------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    logits, cache = fns["prefill"](tokens)
    torch.cuda.synchronize()
    prefill_routes = moved_by_route()
    n_prefill = prefill_routes["tc"]
    cuda.reset_launch_counts()
    out_k, grown, step_logits = greedy(fns, logits, cache, cfg, dev, T)
    torch.cuda.synchronize()
    n_decode = sum(moved_by_route().values())
    peak = torch.cuda.max_memory_allocated()
    if prefill_routes != {r: cfg.n_layers if r == "tc" else 0 for r in fa.ROUTES}:
        fail(f"a bf16 prefill of {cfg.n_layers} layers launched the routes {prefill_routes} "
             f"(expected the tensor-core route {cfg.n_layers} times, the others 0)")
    if n_decode != 0:
        fail(f"flash_attention launched {n_decode} times in {T} decode steps (expected 0)")
    if logits.shape != (B, S, cfg.vocab_size) or logits.dtype != torch.bfloat16:
        fail(f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    if step_logits.shape != (B, 1, cfg.vocab_size) or out_k.shape != (B, T + 1):
        fail(f"decode logits {tuple(step_logits.shape)}, tokens {tuple(out_k.shape)}")
    if not all(bool(torch.isfinite(logits[:, s0:s0 + 1024]).all()) for s0 in range(0, S, 1024)):
        fail("prefill logits: non-finite values")
    if not torch.isfinite(step_logits).all():
        fail("decode logits: non-finite values")
    if cache.s_cap != S or grown.s_cap != S + T:
        fail(f"cache slots {cache.s_cap} / {grown.s_cap}, not {S} / {S + T}")
    log(f"[lm] path run: prefill {B} x {S} -> logits {tuple(logits.shape)} "
        f"{str(logits.dtype).removeprefix('torch.')}, cache {tuple(cache.data[0].shape)} x 2; "
        f"{T} greedy decode steps into {S + T} slots; flash_attention launches by route in the "
        f"prefill ({cfg.n_layers} layers) {prefill_routes}, {n_decode} in decode; "
        f"max_memory_allocated "
        f"{peak / 1e9:.3f} GB")

    # ---- each of the prefill's attentions against the plain version ---------
    rec = recording_flash_attention()
    model.set_kernels(rec)
    fns["prefill"](tokens)
    model.set_kernels("cuda")
    if len(rec.args) != cfg.n_layers:
        fail(f"recorded {len(rec.args)} attention calls, not {cfg.n_layers}")
    call_errs = []
    for i, (q, k, v, kw) in enumerate(rec.args):
        got = routed(lambda: cuda_k.flash_attention(q, k, v, **kw), "tc", f"layer {i} attention")
        want = mha_reference(q, k, v, **kw)
        call_errs.append(scaled_err(got.float(), want.float(), own_row_scale(want.float()),
                                    f"layer {i} prefill attention (bf16)", tol=2e-2))
        del got, want
    log(f"[lm] the {len(call_errs)} prefill attentions (q {tuple(rec.args[0][0].shape)}, "
        f"k/v {tuple(rec.args[0][1].shape)}, bf16), each through the tensor-core route, within "
        f"2e-2 of each output row's max|plain|: "
        f"largest ratio {max(r for r, _ in call_errs):.3e}, largest |kernel - plain| "
        f"{max(e for _, e in call_errs):.3e}")

    # ---- N(0,1) inputs at gemma's and qwen2-72b's heads ---------------------
    gen = torch.Generator(device=dev).manual_seed(1)
    tf32_row = fma_row = None
    for what, (b, s, nq, nkv, h), kw in (
            ("gemma-2b heads", (B, S, cfg.n_heads, cfg.n_kv_heads, cfg.d_head), {}),
            ("qwen2-72b heads", (1, 4096, 64, 8, 128), dict(window=1024, softcap=30.0))):
        for dt, tol, rt in ((torch.float32, 2e-5, "tf32"), (torch.bfloat16, 2e-2, "tc")):
            q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dt)
                       for sh in ((b, s, nq, h), (b, s, nkv, h), (b, s, nkv, h)))
            got = routed(lambda: cuda_k.flash_attention(q, k, v, **kw), rt, f"{what} {dt}")
            want = mha_reference(q, k, v, **kw)
            ratio, err = scaled_err(got.float(), want.float(), own_row_scale(want.float()),
                                    f"{what}, N(0,1), {dt}", tol=tol)
            del got
            ms = time_ms(lambda: cuda_k.flash_attention(q, k, v, **kw), reps=5)
            ops = work("flash_attention", (q, k, v), kw)[1]
            fma = ""
            if dt == torch.float32:
                # the FMA kernel on the same call: the route fp32 took before
                fma_out = fma_route(q, k, v, **kw)
                fma_ratio, fma_err = scaled_err(fma_out.float(), want.float(),
                                                own_row_scale(want.float()),
                                                f"{what}, N(0,1), {dt}, FMA kernel", tol=tol)
                del fma_out
                fma_ms = time_ms(lambda: fma_route(q, k, v, **kw), reps=3)
                qk_ops = ops / 2  # Q·Kᵀ's share, H of H + Hv: here Hv = H
                fma = (f"; the FMA kernel on the same call {fma_ms:.4f} ms (largest ratio "
                       f"{fma_ratio:.3e}); TF32 bound {ops / TF32_OPS_PER_S * 1e3:.4f} ms, split "
                       f"TF32's three products {3 * ops / TF32_OPS_PER_S * 1e3:.4f} ms, Q·Kᵀ "
                       f"alone at the fp32 rate {qk_ops / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms")
            del want
            log(f"[lm] {what} N(0,1) {str(dt).removeprefix('torch.')} q {(b, s, nq, h)} "
                f"k/v {(b, s, nkv, h)} {kw}, {rt} route: within {tol:g} of each row's max|plain| "
                f"(largest ratio {ratio:.3e}, |kernel - plain| {err:.3e}); kernel {ms:.4f} ms, "
                f"{ops / ms / 1e9:.2f} TFLOP/s (fp32-FMA bound {ops / CUDA_CORE_OPS_PER_S * 1e3:.4f} "
                f"ms, bf16 tensor bound {ops / BF16_OPS_PER_S * 1e3:.4f} ms){fma}")
            if tf32_row is None and rt == "tf32":
                # the split-TF32 route's row and the FMA kernel's: fp32 at gemma's
                # served shape (the tf32 route's launches are the fp32
                # prefill's, below)
                plain_ms = time_ms(lambda: mha_reference(q, k, v, **kw), reps=3)
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
                del qt, kt, vt
                tf32_row = kernel_row("flash_attention_tf32", (q, k, v), kw, None, err, ms,
                                      plain_ms, lib_ms)
                fma_row = kernel_row("flash_attention", (q, k, v), kw, None, fma_err, fma_ms,
                                     plain_ms, lib_ms)
                log(f"[lm] {what} N(0,1) float32, device time by a CUDA graph: split-TF32 "
                    f"route {graph_ms(lambda: cuda_k.flash_attention(q, k, v, **kw), n=5):.4f} "
                    f"ms, the FMA kernel {graph_ms(lambda: fma_route(q, k, v, **kw), n=3):.4f} "
                    f"ms a call")
            del q, k, v

    # ---- the FMA kernel's own shapes: head dims TMA cannot describe, and
    # more query heads a kv head than a tile's rows; counted ------------------
    fma_cases = (("fp32, head_dim 250", (1, 2048, 8, 1, 250), torch.float32, 2e-5),
                 ("bf16, 128 query heads on 1", (1, 1024, 128, 1, 64), torch.bfloat16, 2e-2))
    fma_inputs = [tuple(torch.randn(sh, generator=gen, device=dev).to(dt)
                        for sh in ((b, s, nq, h), (b, s, nkv, h), (b, s, nkv, h)))
                  for _, (b, s, nq, nkv, h), dt, _ in fma_cases]
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    fma_outs = [cuda_k.flash_attention(*x) for x in fma_inputs]
    torch.cuda.synchronize()
    fma_routes = moved_by_route()
    if fma_routes != {r: len(fma_cases) if r == "fma" else 0 for r in fa.ROUTES}:
        fail(f"the FMA kernel's shapes launched the routes {fma_routes}")
    fma_ratios = []
    for (what, _, dt, tol), x, got in zip(fma_cases, fma_inputs, fma_outs):
        want = mha_reference(*x)
        fma_ratios.append(scaled_err(got.float(), want.float(), own_row_scale(want.float()),
                                     f"FMA kernel, {what}", tol=tol)[0])
    fma_row["launches"] = fma_routes["fma"]
    log(f"[lm] the FMA kernel's own shapes, N(0,1), through Kernels.flash_attention: "
        + "; ".join(f"{what} q {tuple(x[0].shape)} k/v {tuple(x[1].shape)} within {tol:g} of each "
                    f"row's max|plain| (largest ratio {r:.3e})"
                    for (what, _, _, tol), x, r in zip(fma_cases, fma_inputs, fma_ratios))
        + f"; launches by route {fma_routes}")
    del fma_inputs, fma_outs

    # ---- the kernel line's row: layer 0's attention on the served path ------
    q, k, v, kw = rec.args[0]
    del rec
    ms = time_ms(lambda: cuda_k.flash_attention(q, k, v, **kw))
    fma_ms = time_ms(lambda: fma_route(q, k, v, **kw), reps=3)
    plain_ms = time_ms(lambda: mha_reference(q, k, v, **kw), reps=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    del qt, kt, vt
    row = kernel_row("flash_attention_tc", (q, k, v), kw, n_prefill,
                     max(e for _, e in call_errs), ms, plain_ms, lib_ms)
    b, ops = work("flash_attention_tc", (q, k, v), kw)
    log(f"[lm] flash_attention, served layer ({tuple(q.shape)} x {tuple(k.shape)} bf16): "
        f"tensor-core route {ms:.4f} ms, the FMA route on the same call {fma_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']}, bf16 tensor rate; {ops:.4g} operations, {b / 1e6:.1f} MB), "
        f"fp32-FMA bound {ops / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms; "
        f"{ops / ms / 1e9:.2f} TFLOP/s; kernel alone: "
        f"{profile_line(device_profile(lambda: cuda_k.flash_attention(q, k, v, **kw)))}")
    del q, k, v

    # ---- the served path: times, device time by kernel ---------------------
    prefill_ms = time_ms(lambda: fns["prefill"](tokens), reps=3)
    last = out_k[:, T - 1:T]
    decode_ms = time_ms(lambda: fns["decode"](grown, last, S + T - 1))
    log(f"[lm] prefill {B} x {S}: {prefill_ms:.4f} ms ({B * S / prefill_ms * 1e3:.0f} tokens/s), "
        f"attention {n_prefill} x {ms:.4f} ms = {100 * n_prefill * ms / prefill_ms:.1f}% of it; "
        f"decode step (batch {B}, {S + T} slots): {decode_ms:.4f} ms")
    log(f"[lm] prefill {B} x {S}: "
        f"{flops_share(model_flops_lm(cfg, B, S, 'prefill'), prefill_ms, 'bfloat16', smi)}")
    log(f"[lm] prefill {profile_line(device_profile(lambda: fns['prefill'](tokens), reps=1))}")
    log(f"[lm] decode step "
        f"{profile_line(device_profile(lambda: fns['decode'](grown, last, S + T - 1)))}")

    # ---- bf16 served logits against kernels="torch" (printed, not held) -----
    model.set_kernels("torch")
    plain_logits, plain_cache = fns["prefill"](tokens)
    plain_prefill_ms = time_ms(lambda: fns["prefill"](tokens), reps=1)
    out_p = greedy(fns, plain_logits, plain_cache, cfg, dev, T)[0]
    model.set_kernels("cuda")
    ratio, err = logits_diff(logits, plain_logits)
    last_agree = (logits[:, -1].argmax(-1) == plain_logits[:, -1].argmax(-1)).float().mean().item()
    log(f"[lm] bf16 served logits vs kernels='torch' (not held): largest |kernel - plain| "
        f"{err:.4g}, {ratio:.3e} of the row's max|plain|; greedy tokens agree "
        f"{(out_k == out_p).float().mean().item():.4f} of {out_k.numel()}, the prefill's last "
        f"argmax {last_agree:.2f}; plain prefill {plain_prefill_ms:.4f} ms")
    del logits, cache, grown, plain_logits, plain_cache, step_logits, model, fns
    torch.cuda.empty_cache()

    # ---- fp32 full width, B = 1, S = 2,048 ----------------------------------
    # Held layer by layer: each layer's output, and the logits, with that
    # layer's attention by the kernel and by the plain version on one shared
    # input (the kernel path's stream). The free-running forwards are only
    # printed: this init's attention logits (scale ~720) amplify any ulp-level
    # difference ~30x a layer, so two roundings of the same function part by
    # O(1) within 18 layers; the plain version computed in float64 shows how
    # far, for the kernel and the plain version alike.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = Transformer(cfg32, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    fns = make_serve_fns(cfg32, model)
    toks = tokens[:1, :2048]
    cuda.reset_launch_counts()
    got = fns["prefill"](toks)[0]
    torch.cuda.synchronize()
    fp32_routes = moved_by_route()
    n_fp32 = fp32_routes["tf32"]
    if fp32_routes != {r: cfg.n_layers if r == "tf32" else 0 for r in fa.ROUTES}:
        fail(f"the fp32 prefill launched the routes {fp32_routes}, not the split-TF32 route "
             f"{cfg.n_layers} times and the others 0")
    tf32_row["launches"] = n_fp32
    # the kernel path's stream, and two free-running streams: the plain
    # version's, and the plain version's in float64
    others = {"plain": "torch", "float64-plain": plain_float64()}
    layer_ratios, drift = [], {name: [] for name in others}
    vs64 = {"kernel": [], "plain": []}  # each layer on the shared input, against float64
    with torch.inference_mode():
        x = model.embed_tokens(toks)
        free = dict.fromkeys(others, x)
        positions = torch.arange(toks.shape[1], device=dev)[None]
        for l in range(cfg.n_layers):
            outs = {}
            for name, kern in (("plain", "torch"), ("float64", others["float64-plain"]),
                               ("kernel", "cuda")):
                model.set_kernels(kern)
                outs[name] = model.layer(l, x, positions)[0]
            for name, kern in others.items():
                model.set_kernels(kern)
                free[name] = model.layer(l, free[name], positions)[0]
            model.set_kernels("cuda")
            x, x_plain = outs["kernel"], outs["plain"]
            layer_ratios.append(scaled_err(x, x_plain, own_row_scale(x_plain),
                                           f"fp32 layer {l} output, shared input")[0])
            for name in vs64:
                vs64[name].append(row_rel(outs[name], outs["float64"]))
            for name in others:
                drift[name].append(row_rel(x, free[name]))
            del outs
        logits_k, logits_p = model.head(x), model.head(x_plain)
        ratio, err = scaled_err(logits_k, logits_p, own_row_scale(logits_p),
                                "fp32 full-width logits, last layer's attention kernel vs plain")
        same = bool(torch.equal(logits_k, got))
        del x, x_plain, logits_p, got
        free_logits = {name: model.head(free[name]) for name in others}
        at_logits = {f"kernel vs {name}": logits_diff(logits_k, free_logits[name])
                     for name in others}
        at_logits["plain vs float64-plain"] = logits_diff(free_logits["plain"],
                                                          free_logits["float64-plain"])
    log(f"[lm] fp32 gemma-2b (TF32 off), {toks.shape[0]} x {toks.shape[1]} tokens, attention "
        f"launches by route {fp32_routes}; layer by "
        f"layer on a shared input: every layer's output and the logits within 1e-4 of each "
        f"row's max|plain| (largest ratio by layer {[f'{r:.2e}' for r in layer_ratios]}; "
        f"logits {ratio:.3e}, |kernel - plain| {err:.3e}); the kernel stream's logits equal "
        f"the served forward's bit for bit: {same}; largest |diff| / the row's max against "
        f"the float64 version on the same input, by layer: "
        + "; ".join(f"{name} {[f'{d:.1e}' for d in vs64[name]]}" for name in vs64))
    log(f"[lm] fp32 free-running streams (not held), largest |diff| / the row's max after each "
        f"layer: " + "; ".join(f"kernel vs {name} {[f'{d:.1e}' for d in drift[name]]}"
                               for name in others)
        + f"; at the logits {[f'{k} {r:.3e}' for k, (r, _) in at_logits.items()]}")
    del model, fns, logits_k, free, free_logits
    torch.cuda.empty_cache()
    return [row, tf32_row, fma_row]


# ------------------------------------------------------------------ [tp]
def layer_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over its row's max|want| (rows: the last
    axis); inf on a shape mismatch or a non-finite value."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        return float("inf")
    scale = want.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return ((got - want).abs() / scale).max().item()


def collective_counter():
    """A dispatch mode counting the functional collectives a rank runs and
    the bytes of their results, by kind (DTensor's ops pass through to its
    own dispatch, whose collectives come back here)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.analysis.staticcheck import costmodel

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count, self.nbytes = {}, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if func.namespace == "_c10d_functional":
                kind = costmodel.FUNCTIONAL_KIND.get(costmodel.base_name(str(func)))
                if kind is not None:
                    self.count[kind] = self.count.get(kind, 0) + 1
                    self.nbytes[kind] = self.nbytes.get(kind, 0) + out.numel() * out.element_size()
            return out

    return Counter()


def tp_rank(rank: int, path: str, t_spawn: float) -> dict:
    """[tp] in one rank process: gemma-2b drawn from seed 0 onto the (data=2,
    model=2) mesh (`make_mesh`: device type "cuda" over the gloo world),
    served through ``make_serve_fns`` — the prefill counted and timed, its
    layers run again one at a time on the parent's one-card inputs, the
    cache moved once to the decode placements, [lm]'s decode steps timed,
    the first decode step's layers on the parent's inputs — then the fp32
    2-layer model's prefill and layers. Returns measurements and the
    largest error ratios; the parent holds them."""
    started = time.time() - t_spawn
    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import gemma_2b
    from repro_torch.core import rank_collectives as rc
    from repro_torch.kernels import cuda
    from repro_torch.launch import axis_rules, make_mesh, make_rules
    from repro_torch.launch.sharding import shard_input
    from repro_torch.models import schema
    from repro_torch.models.transformer import (
        CACHE_AXES, DecodeCache, Transformer, grow_cache, lm_schema)
    from repro_torch.train.step import make_serve_fns

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(pathlib.Path(path) / "ref.pt", mmap=True)
    mesh = make_mesh(TP["mesh"], "cuda")
    cfg = gemma_2b.CONFIG
    B, S, T = LM_SERVE["batch"], LM_SERVE["seq"], LM_SERVE["decode"]
    rules = make_rules(cfg, "prefill", mesh)
    decode_rules = make_rules(cfg, "decode", mesh)
    out = {"started_s": started}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0),
                        mesh=mesh, rules=rules)
    torch.cuda.synchronize()
    out["draw_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(p.to_local().numel() * p.element_size() for p in model.parameters())
    out["param_bytes_want"] = schema.rank_bytes(lm_schema(cfg), rules, TP["mesh"])
    fns = make_serve_fns(cfg, model)
    tokens = ref["tokens"]

    # ---- the prefill, counted: launches, collectives --------------------
    cuda.reset_launch_counts()
    rc.reset_staged_bytes()
    counter = collective_counter()
    with CommDebugMode() as comm, counter:
        logits, cache = fns["prefill"](tokens)
    torch.cuda.synchronize()
    out["prefill_routes"] = moved_by_route()
    out["prefill_comm"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["prefill_coll"] = (counter.count, counter.nbytes)
    out["prefill_staged"] = dict(rc.staged_bytes)
    out["logits"] = (tuple(logits.shape), str(logits.dtype), type(logits).__name__,
                     tuple(logits.to_local().shape),
                     bool(torch.isfinite(logits.to_local()).all()))
    t0 = time.perf_counter()
    logits, cache = fns["prefill"](tokens)
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3

    # ---- each layer on the parent's one-card input -----------------------
    ratios = []
    with torch.no_grad(), axis_rules(mesh, rules), model.scope():
        positions = torch.arange(S, device=dev).expand(B, S)
        for l in range(cfg.n_layers):
            x = shard_input(ref["xs"][l].to(dev), "batch", "seq", "embed")
            y = model.layer(l, x, positions)[0].full_tensor()
            ratios.append(layer_ratio(y, ref["xs"][l + 1].to(dev)))
            del x, y
    out["prefill_layers"] = ratios

    # ---- each layer's attention (before wo) on the parent's q, k, v --------
    ratios = []
    kw = dict(window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
    with torch.no_grad(), axis_rules(mesh, rules), model.scope():
        for q, k, v in ref["attn"]:
            q, k, v = q.to(dev), k.to(dev), v.to(dev)
            o = model.kernels.flash_attention(
                shard_input(q, "batch", "seq", "heads", None),
                *(shard_input(t, "batch", "seq", "kv_heads", None) for t in (k, v)), **kw)
            ratios.append(layer_ratio(o.full_tensor(), model.kernels.flash_attention(q, k, v, **kw)))
            del q, k, v, o
    out["attention"] = ratios

    # ---- decode: the cache moved once, then T steps ----------------------
    with axis_rules(mesh, decode_rules):
        cache = grow_cache(cache, S + T)
    out["cache_placements"] = str(tuple(cache.data[0].placements))
    tok = logits[:, -1:].full_tensor().argmax(-1)
    del logits
    cuda.reset_launch_counts()
    counter = collective_counter()
    with CommDebugMode() as comm, counter:
        step_logits, cache = fns["decode"](cache, tok, S)
    torch.cuda.synchronize()
    out["decode_comm"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    out["decode_coll"] = (counter.count, counter.nbytes)
    tok = step_logits.full_tensor().argmax(-1)
    times = []
    for i in range(1, T):
        t0 = time.perf_counter()
        step_logits, cache = fns["decode"](cache, tok, S + i)
        tok = step_logits.full_tensor().argmax(-1)
        times.append((time.perf_counter() - t0) * 1e3)
    out["decode_routes"] = moved_by_route()
    out["decode_ms"] = times
    out["decode_logits"] = (tuple(step_logits.shape), bool(torch.isfinite(
        step_logits.to_local()).all()))
    del cache, step_logits

    # ---- the first decode step's layers on the parent's inputs ------------
    ratios = []
    with torch.no_grad(), axis_rules(mesh, decode_rules):
        shared = DecodeCache(tuple(shard_input(c.to(dev), *CACHE_AXES) for c in ref["cache"]),
                             "gqa", S + T, False)
        for l in range(cfg.n_layers):
            x = shard_input(ref["xd"][l].to(dev), "batch", None, "embed")
            y = model.decode_layer(l, x, shared, S).full_tensor()
            ratios.append(layer_ratio(y, ref["xd"][l + 1].to(dev)))
    out["decode_layers"] = ratios
    del shared, model, fns
    torch.cuda.empty_cache()

    # ---- fp32: full width, 2 layers, TF32 off ----------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=TP["fp32_layers"])
    rules32 = make_rules(cfg32, "prefill", mesh)
    model = Transformer(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(0),
                        mesh=mesh, rules=rules32)
    tokens32 = tokens[:, :TP["fp32_seq"]]
    cuda.reset_launch_counts()
    make_serve_fns(cfg32, model)["prefill"](tokens32)
    torch.cuda.synchronize()
    out["fp32_routes"] = moved_by_route()
    ratios, served = [], []
    with torch.no_grad(), axis_rules(mesh, rules32), model.scope():
        positions = torch.arange(tokens32.shape[1], device=dev).expand(*tokens32.shape)
        for l in range(cfg32.n_layers):
            x = shard_input(ref["xs32"][l].to(dev), "batch", "seq", "embed")
            y = model.layer(l, x, positions)[0].full_tensor()
            ratios.append(layer_ratio(y, ref["ys32"][l].to(dev)))
            served.append(layer_ratio(y, ref["xs32"][l + 1].to(dev)))
    out["fp32_layers"] = ratios
    out["fp32_vs_served"] = served
    out["peak"] = torch.cuda.max_memory_allocated()
    out["staged"] = dict(rc.staged_bytes)
    out["sources_built"] = cuda.sources_built
    return out


def blocked_layer(model, l: int, x: torch.Tensor, positions: torch.Tensor, mesh: dict):
    """Layer ``l`` of the one-card ``model`` on ``x`` computed in the
    blocks a rank of the ``mesh`` ({"data": d, "model": m}) computes: the
    batch in ``d`` row blocks, each column-parallel GEMM (q, the gate and
    up projections) in ``m`` column blocks, the plain attention
    (``mha_reference``) on each block's heads (with every kv head: gemma's
    one), each row-parallel GEMM (the attention's and the FFN's output
    projections) as ``m`` partial sums added. fp32 GEMMs round by their
    shapes (cuBLAS picks its algorithm by them): this is the one-card
    function in the mesh's GEMM rounding, with the plain version in place
    of the attention kernel."""
    from repro_torch.extras.flash_attention.ref import mha_reference
    from repro_torch.models.layers import apply_rope, rms_norm

    import torch.nn.functional as F

    cfg, n_d, n_m = model.cfg, mesh["data"], mesh["model"]
    B, S, D = x.shape
    N, H = cfg.n_heads, cfg.d_head
    p, f = model.attn, model.ffn_dense
    wq, wk, wv = (p[w][l].reshape(D, -1) for w in ("wq", "wk", "wv"))
    wo = p["wo"][l].reshape(-1, D)
    cq, cf = N * H // n_m, cfg.d_ff // n_m
    outs = []
    for rows in x.split(B // n_d):
        b = rows.shape[0]
        h = rms_norm(rows, model.norm_attn[l], cfg.norm_eps).reshape(b * S, D)
        k = apply_rope((h @ wk).view(b, S, cfg.n_kv_heads, H), positions[:b], cfg.rope_theta)
        v = (h @ wv).view(b, S, cfg.n_kv_heads, H)
        a = 0
        for m in range(n_m):
            q = apply_rope((h @ wq[:, m * cq:(m + 1) * cq].contiguous()).view(b, S, N // n_m, H),
                           positions[:b], cfg.rope_theta)
            o = mha_reference(q, k, v, window=cfg.sliding_window, softcap=cfg.attn_logit_softcap)
            a = a + o.reshape(b * S, cq) @ wo[m * cq:(m + 1) * cq]
        x1 = rows + a.view(b, S, D)
        h = rms_norm(x1, model.norm_ffn[l], cfg.norm_eps).reshape(b * S, D)
        y = 0
        for m in range(n_m):
            cols = slice(m * cf, (m + 1) * cf)
            g = h @ f["wi_gate"][l][:, cols].contiguous()
            u = h @ f["wi_up"][l][:, cols].contiguous()
            y = y + (F.gelu(g, approximate="tanh") * u) @ f["wo"][l][cols]
        outs.append(x1 + y.view(b, S, D))
    return torch.cat(outs)


def tp_reference(dev, path: pathlib.Path) -> dict:
    """[tp]'s shared inputs, from the one-card model (seed 0, CUDA kernels)
    saved to ``path/ref.pt``: the prefill's stream layer by layer (each
    layer's input; the next is its output), each layer's attention inputs
    ``(q, k, v)``, the prefill's cache grown by [lm]'s decode steps, the
    first decode step's stream, and the fp32 2-layer model's stream and
    its layers in the mesh's blocks (`blocked_layer`). Holds
    ``flash_attention_tc`` to the plain version on every rank's ``(batch,
    heads)`` block of every layer's attention inputs (2e-2 of each row's
    max, [lm]'s bf16 tolerance); returns the largest ratio beside the
    reference."""
    import dataclasses

    from repro_torch.configs import gemma_2b
    from repro_torch.core.backend import get_kernels
    from repro_torch.extras.flash_attention.ref import mha_reference
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.transformer import Transformer, grow_cache
    from repro_torch.train.step import make_serve_fns

    cfg = gemma_2b.CONFIG
    B, S, T = LM_SERVE["batch"], LM_SERVE["seq"], LM_SERVE["decode"]
    tokens = torch.from_numpy(lm_batch(cfg, B, S, seed=0, step=0)["tokens"])

    def stream(model, toks):
        with torch.inference_mode():
            x = model.embed_tokens(toks.to(dev))
            positions = torch.arange(toks.shape[1], device=dev).expand(*toks.shape)
            xs = [x.cpu()]
            for l in range(model.cfg.n_layers):
                x = model.layer(l, x, positions)[0]
                xs.append(x.cpu())
        return xs

    model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    rec = recording_flash_attention()
    model.set_kernels(rec)
    ref = {"tokens": tokens, "xs": stream(model, tokens)}
    model.set_kernels("cuda")
    # the kernel at the shapes a rank gives it: batch 1, its model rank's heads
    cuda_k, n_m = get_kernels("cuda"), TP["mesh"]["model"]
    block_ratios = []
    for l, (q, k, v, kw) in enumerate(rec.args):
        cq = q.shape[2] // n_m
        for b in range(q.shape[0]):
            for m in range(n_m):
                qb = q[b:b + 1, :, m * cq:(m + 1) * cq].contiguous()
                kb, vb = k[b:b + 1].contiguous(), v[b:b + 1].contiguous()
                got = routed(lambda: cuda_k.flash_attention(qb, kb, vb, **kw), "tc",
                             f"[tp] layer {l} attention, block ({b}, {m})")
                want = mha_reference(qb, kb, vb, **kw).float()
                block_ratios.append(scaled_err(
                    got.float(), want, own_row_scale(want),
                    f"[tp] layer {l} attention on the block (batch {b}, heads {m * cq}-"
                    f"{(m + 1) * cq - 1}) q {tuple(qb.shape)} k/v {tuple(kb.shape)}",
                    tol=2e-2)[0])
                del got, want
    ref["attn"] = [tuple(t.cpu() for t in a[:3]) for a in rec.args]
    ref["block_shapes"] = (tuple(qb.shape), tuple(kb.shape))
    del rec, q, k, v, qb, kb, vb
    logits, cache = make_serve_fns(cfg, model)["prefill"](tokens)
    cache = grow_cache(cache, S + T)
    ref["cache"] = [c.cpu() for c in cache.data]
    with torch.inference_mode():
        x = model.embed_tokens(logits[:, -1:].argmax(-1))
        xd = [x.cpu()]
        for l in range(cfg.n_layers):
            x = model.decode_layer(l, x, cache, S)
            xd.append(x.cpu())
    ref["xd"] = xd
    del model, logits, cache
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=TP["fp32_layers"])
    model = Transformer(cfg32, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    toks32 = tokens[:, :TP["fp32_seq"]].to(dev)
    ref["xs32"] = stream(model, toks32)
    with torch.inference_mode():
        positions = torch.arange(toks32.shape[1], device=dev).expand(*toks32.shape)
        ref["ys32"] = [blocked_layer(model, l, ref["xs32"][l].to(dev), positions, TP["mesh"]).cpu()
                       for l in range(cfg32.n_layers)]
    ref["blocked_vs_served"] = [layer_ratio(y, x) for y, x in zip(ref["ys32"], ref["xs32"][1:])]
    del model
    torch.cuda.empty_cache()
    torch.save(ref, path / "ref.pt")
    ref["block_ratio"] = max(block_ratios)
    return ref


def phase_tp(dev, smi: str) -> None:
    """[tp]: gemma-2b at its published widths served on a mesh of 4 gloo
    ranks sharing ``cuda:0`` (`tp_rank`), held layer by layer to the
    one-card model on shared inputs (`tp_reference`)."""
    import shutil
    import tempfile

    from repro_torch.configs import gemma_2b
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.launch import spawn_ranks

    cfg = gemma_2b.CONFIG
    n = TP["mesh"]["data"] * TP["mesh"]["model"]
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    path = pathlib.Path(tempfile.mkdtemp(prefix="tp-", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        ref = tp_reference(dev, path)
        blocked_vs_served, block_ratio, block_shapes = (
            ref["blocked_vs_served"], ref["block_ratio"], ref["block_shapes"])
        del ref
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = spawn_ranks(tp_rank, n, str(path), time.time(), timeout=900)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    want_routes = {r: cfg.n_layers if r == "tc" else 0 for r in fa.ROUTES}
    for k, r in enumerate(res):
        if r["sources_built"]:
            fail(f"[tp] rank {k} built {r['sources_built']} kernel sources")
        if r["prefill_routes"] != want_routes:
            fail(f"[tp] rank {k}: the bf16 prefill launched the routes {r['prefill_routes']}, "
                 f"not the tensor-core route {cfg.n_layers} times and the others 0")
        if any(r["decode_routes"].values()):
            fail(f"[tp] rank {k}: decode launched flash_attention {r['decode_routes']}")
        want32 = {rt: TP["fp32_layers"] if rt == "tf32" else 0 for rt in fa.ROUTES}
        if r["fp32_routes"] != want32:
            fail(f"[tp] rank {k}: the fp32 prefill launched the routes {r['fp32_routes']}")
        if r["param_bytes"] != r["param_bytes_want"]:
            fail(f"[tp] rank {k}: {r['param_bytes']} parameter bytes, param_pspecs imply "
                 f"{r['param_bytes_want']}")
        shape, dtype, kind, local, finite = r["logits"]
        if (shape, dtype, kind, finite) != ((LM_SERVE["batch"], LM_SERVE["seq"], cfg.vocab_size),
                                            "torch.bfloat16", "DTensor", True):
            fail(f"[tp] rank {k}: prefill logits {r['logits']}")
        if r["decode_logits"] != ((LM_SERVE["batch"], 1, cfg.vocab_size), True):
            fail(f"[tp] rank {k}: decode logits {r['decode_logits']}")
        for what, ratios, tol in (("prefill", r["prefill_layers"], 2e-2),
                                  ("prefill attention (before wo)", r["attention"], 2e-2),
                                  ("first decode step", r["decode_layers"], 2e-2),
                                  ("fp32 prefill", r["fp32_layers"], 1e-4)):
            if len(ratios) != (TP["fp32_layers"] if what.startswith("fp32") else cfg.n_layers) \
                    or max(ratios) > tol:
                fail(f"[tp] rank {k}: {what} layers on shared inputs, largest |mesh - one card| "
                     f"/ the row's max|one card| by layer {ratios} (tolerance {tol:g})")
        # the served one-card fp32 layer differs from the mesh's by the GEMMs'
        # rounding alone: no more than 1.5x the blocked one-card layer does
        if len(r["fp32_vs_served"]) != TP["fp32_layers"] or any(
                got > 1.5 * want for got, want in zip(r["fp32_vs_served"], blocked_vs_served)):
            fail(f"[tp] rank {k}: fp32 layers, |mesh - one card as served| / the row's max "
                 f"{r['fp32_vs_served']}, above 1.5x the blocked one-card layer's "
                 f"{blocked_vs_served}")
    r0 = res[0]
    log(f"[tp] gemma-2b ({cfg.n_layers} layers, bf16) on a {TP['mesh']} mesh of {n} gloo ranks "
        f"sharing cuda:0 (make_mesh: device type cuda; heads, MLP and vocab over model, the "
        f"batch and the FSDP dims over data); one-card reference saved in {t_ref:.2f} s; ranks "
        f"started, served and checked in {t_ranks:.2f} s, a rank's function entered "
        f"{min(r['started_s'] for r in res):.2f}-{max(r['started_s'] for r in res):.2f} s after "
        f"the spawn, its parameters drawn leaf by leaf in "
        f"{min(r['draw_s'] for r in res):.2f}-{max(r['draw_s'] for r in res):.2f} s ({smi})")
    log(f"[tp] each rank holds {r0['param_bytes']} parameter bytes "
        f"({r0['param_bytes'] / 1e9:.3f} GB), as param_pspecs imply; each rank's prefill "
        f"launched the routes {r0['prefill_routes']}, the fp32 model's {r0['fp32_routes']}, "
        f"decode {r0['decode_routes']}; no rank built a kernel library")
    log(f"[tp] prefill {LM_SERVE['batch']} x {LM_SERVE['seq']} (one prompt a data rank), the "
        f"second call: {[round(r['prefill_ms'], 2) for r in res]} ms by rank; logits "
        f"{r0['logits'][0]} as DTensors, {r0['logits'][3]} a rank; decode steps "
        f"2-{LM_SERVE['decode']} "
        f"(cache {r0['cache_placements']}): median "
        f"{[round(statistics.median(r['decode_ms']), 2) for r in res]} ms a step by rank")
    log(f"[tp] largest |mesh - one card| / the row's max|one card|, layer by layer on shared "
        f"inputs (rank 0): prefill {[f'{x:.2e}' for x in r0['prefill_layers']]}; first decode "
        f"step {[f'{x:.2e}' for x in r0['decode_layers']]}; fp32 "
        f"{[f'{x:.2e}' for x in r0['fp32_layers']]}; every rank within 2e-2 (bf16) and 1e-4 "
        f"(fp32): largest {max(max(r['prefill_layers'] + r['decode_layers']) for r in res):.3e} "
        f"and {max(max(r['fp32_layers']) for r in res):.3e}")
    log(f"[tp] each prefill layer's attention (before wo) on the one-card q, k, v, the mesh's "
        f"(each rank's kernel on its block) against the one-card kernel's, within 2e-2 of each "
        f"row's max: largest by layer (rank 0) {[f'{x:.2e}' for x in r0['attention']]}, every "
        f"rank {max(max(r['attention']) for r in res):.3e}; flash_attention_tc on every rank's "
        f"block, q {block_shapes[0]} k/v {block_shapes[1]}, of each layer's one-card inputs, "
        f"against mha_reference: within 2e-2 of each row's max (largest ratio {block_ratio:.3e})")
    log(f"[tp] fp32: each layer is held at 1e-4 to the one-card layer in the mesh's GEMM blocks "
        f"with the plain attention (blocked_layer); against the one-card layer as served the "
        f"mesh's are {[f'{x:.2e}' for x in r0['fp32_vs_served']]} (rank 0; held to 1.5x the "
        f"blocked layer's distance from it, {[f'{x:.2e}' for x in blocked_vs_served]}): fp32 "
        f"GEMMs round by their shapes, and this init's attention logits (~720) amplify it")
    for what in ("prefill", "decode"):
        count, nbytes = r0[f"{what}_coll"]
        log(f"[tp] rank 0's collectives in one {what if what == 'prefill' else 'decode step'} "
            f"(CommDebugMode {r0[f'{what}_comm']}): calls by kind {count}, result bytes by kind "
            f"{nbytes}")
    log(f"[tp] bytes staged through pinned host memory by rank 0 (the gloo all-gather rule), "
        f"by collective: prefill {r0['prefill_staged']}, whole phase {r0['staged']}")
    log(f"[tp] max_memory_allocated a rank (GB): {[round(r['peak'] / 1e9, 3) for r in res]}")
    log(f"[tp] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ [dryrun-mesh]
def phase_dryrun_mesh(smi: str) -> None:
    """[dryrun-mesh]: the dense-LM serving cells priced a chip on the
    reference's single-pod and multi-pod meshes, each mesh in a process of
    its own (``python -m repro_torch.extras.dryrun --mesh ... --all``: a
    world of fake ranks; each cell's record read from ``--out``); every
    cell's per-rank parameter bytes held to
    the sum of its leaves' local chunks under the port's ``spec_for``."""
    import shutil

    from repro_torch.configs import get
    from repro_torch.extras.dryrun import MESH_CELLS, MESHES, all_cell_ids
    from repro_torch.launch.rules import make_rules
    from repro_torch.models import schema
    from repro_torch.models.transformer import lm_schema

    total = torch.cuda.get_device_properties(0).total_memory
    sizes = {"single-pod": {"data": 16, "model": 16},
             "multi-pod": {"pod": 2, "data": 16, "model": 16}}
    t_phase = time.perf_counter()
    for mesh in ("single-pod", "multi-pod"):
        t0 = time.perf_counter()
        out = ROOT / "build" / "dryrun-mesh" / mesh
        shutil.rmtree(out, ignore_errors=True)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.extras.dryrun", "--mesh", mesh, "--all",
             "--device-bytes", str(total), "--out", str(out)],
            capture_output=True, text=True, timeout=600, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        if proc.returncode != 0:
            fail(f"[dryrun-mesh] {mesh}: exit {proc.returncode}\n{proc.stdout[-3000:]}"
                 f"\n{proc.stderr[-3000:]}")
        # every cell's record, priced or refused, is a file under ``out``
        recs = [json.loads(f.read_text()) for f in sorted(out.glob("*.json"))]
        if sorted((r["arch"], r["shape"]) for r in recs) != sorted(all_cell_ids()):
            fail(f"[dryrun-mesh] {mesh}: {len(recs)} records, not one for each of the "
                 f"{len(all_cell_ids())} cells")
        ok = {(r["arch"], r["shape"]): r for r in recs if r["status"] == "ok"}
        refused = [r for r in recs if r["status"] == "not ported"]
        if set(ok) != set(MESH_CELLS):
            fail(f"[dryrun-mesh] {mesh}: priced {sorted(ok)}, not {sorted(MESH_CELLS)}")
        if any("ROADMAP.md" not in r["reason"] for r in refused):
            fail(f"[dryrun-mesh] {mesh}: a cell refused without its ROADMAP item")
        for (arch, shape), r in sorted(ok.items()):
            cfg = get(arch).config
            want = schema.rank_bytes(lm_schema(cfg), make_rules(cfg, r["kind"], sizes[mesh]),
                                     sizes[mesh])
            got = r["memory"]["param_bytes"]
            if got != want:
                fail(f"[dryrun-mesh] {arch} x {shape} x {r['mesh']}: {got} parameter bytes a "
                     f"chip, the port's spec_for gives {want}")
            coll = r["collectives"]
            log(f"[dryrun-mesh] {arch} x {shape} x {r['mesh']} ({r['n_chips']} chips): a chip "
                f"holds {got} parameter bytes ({got / 1e9:.4f} GB, as spec_for gives); priced "
                f"peak {r['memory']['peak_bytes'] / 1e9:.3f} GB, fits {total / 1e9:.3f} GB: "
                f"{r['fits']}; FLOPs {r['flops']:.6g}, HBM bytes {r['bytes']:.6g}; collective "
                f"bytes by kind { {k: f'{v:.4g}' for k, v in coll['bytes_by_kind'].items()} }, "
                f"calls {coll['count_by_kind']}; roofline t_compute "
                f"{r['roofline']['t_compute_s'] * 1e3:.3f} ms, t_memory "
                f"{r['roofline']['t_memory_s'] * 1e3:.3f} ms, t_collective "
                f"{r['roofline']['t_collective_s'] * 1e3:.3f} ms -> {r['roofline']['bottleneck']}")
        log(f"[dryrun-mesh] {mesh} ({MESHES[mesh][0]}): {len(ok)} cells priced, {len(refused)} "
            f"refused naming their ROADMAP item, "
            f"{sum(r['status'] == 'skipped' for r in recs)} skipped (their arch's skipped_shapes), "
            f"a record each under {out.relative_to(ROOT)}, in {time.perf_counter() - t0:.2f} s")
    log(f"[dryrun-mesh] phase {time.perf_counter() - t_phase:.1f} s ({smi})")


# ------------------------------------------------------------ [moe-mla]
def plain_attention(q, k, v, **kw) -> torch.Tensor:
    """``mha_reference`` a chunk of kv heads at a time (its float32 logits
    ``(B, heads, G, S, S)`` kept near 1 GB a chunk): the same function, in
    the memory a full-width MoE model leaves."""
    from repro_torch.extras.flash_attention.ref import mha_reference

    B, S, Nq, _ = q.shape
    Nkv = k.shape[2]
    G = Nq // Nkv
    hc = max(1, (1 << 30) // (4 * B * G * S * S))
    return torch.cat([mha_reference(q[:, :, h * G:(h + hc) * G], k[:, :, h:h + hc],
                                    v[:, :, h:h + hc], **kw)
                      for h in range(0, Nkv, hc)], dim=2)


def moe_inputs(model, tokens) -> list:
    """``(layer, the normed stream its MoE FFN gets (T, D))`` for each MoE
    layer of one prefill, read by wrapping the model's ``ffn``."""
    first = model.cfg.moe.first_k_dense
    seen = []
    ffn = model.ffn

    def record(l, h):
        if l >= first:
            seen.append((l, h.reshape(-1, h.shape[-1])))
        return ffn(l, h)

    model.ffn = record
    try:
        with torch.inference_mode():
            model(tokens)
    finally:
        del model.ffn
    return seen


def routing_stats(model, l: int, h: torch.Tensor) -> str:
    """Layer ``l``'s routing of ``h``: the share of (token, expert)
    assignments dropped at its capacity, and the least and most tokens an
    expert was given."""
    from repro_torch.models import moe

    cfg = model.cfg.moe
    p = {name: w[l - cfg.first_k_dense] for name, w in model.moe.items()}
    idx = moe.route(h, p["router"], p.get("router_bias"), cfg)[0]
    C = moe.capacity(h.shape[0], cfg)
    kept = moe.assignment_slots(idx[None], cfg.n_experts, C) < cfg.n_experts * C
    load = torch.bincount(idx.reshape(-1).long(), minlength=cfg.n_experts)
    return (f"layer {l}: C {C}, dropped {1 - kept.float().mean().item():.4f} of "
            f"{idx.numel()} assignments, expert load min {load.min().item()} max "
            f"{load.max().item()}")


def phase_moe_mla(dev) -> None:
    import dataclasses

    from repro_torch.configs import deepseek_v3_671b, mixtral_8x22b
    from repro_torch.core.backend import get_kernels
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.kernels import cuda
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import make_serve_fns

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_k = get_kernels("cuda")

    # ---- the smoke configs: the same logits on the card and on the CPU -----
    # (fp32, TF32 off; the decode steps take the CPU's greedy tokens on both)
    smoke_errs = {}
    for small in (mixtral_8x22b.smoke(), deepseek_v3_671b.smoke()):
        m_gpu = Transformer(small, device=dev)
        m_cpu = Transformer(small, device="cpu")
        m_cpu.load_state_dict({k: v.cpu() for k, v in m_gpu.state_dict().items()})
        f_gpu, f_cpu = make_serve_fns(small, m_gpu), make_serve_fns(small, m_cpu)
        toks = lm_batch(small, 2, 200, seed=0, step=0)["tokens"]
        want, c_cpu = f_cpu["prefill"](toks)
        got, c_gpu = f_gpu["prefill"](toks)
        ratios = [scaled_err(got.cpu(), want, own_row_scale(want),
                             f"{small.name} prefill logits, card vs CPU")[0]]
        g_cpu, g_gpu = grown_cache(small, c_cpu, 4, "cpu"), grown_cache(small, c_gpu, 4, dev)
        tok = want[:, -1:].argmax(-1)
        for i in range(4):
            want, _ = f_cpu["decode"](g_cpu, tok, 200 + i)
            got, _ = f_gpu["decode"](g_gpu, tok, 200 + i)
            ratios.append(scaled_err(got.cpu(), want, own_row_scale(want),
                                     f"{small.name} decode step {i} logits, card vs CPU")[0])
            tok = want.argmax(-1)
        smoke_errs[small.name] = ratios
    log(f"[moe-mla] smoke configs (fp32, 2 x 200 tokens, then 4 decode steps): logits within 1e-4 "
        f"of each row's max|cpu| on card and CPU (largest ratio, prefill then each step: "
        f"{ {k: [f'{r:.2e}' for r in v] for k, v in smoke_errs.items()} })")

    # ---- N(0,1) inputs at MLA's attention shape ------------------------------
    m = deepseek_v3_671b.CONFIG.mla
    N, H, Hv = deepseek_v3_671b.CONFIG.n_heads, m.d_nope + m.d_rope, m.d_v
    kw = dict(scale=1.0 / np.sqrt(H))
    gen = torch.Generator(device=dev).manual_seed(2)
    for dt, tol, rt in ((torch.bfloat16, 2e-2, "tc"), (torch.float32, 2e-5, "tf32")):
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(dt)
                   for sh in ((2, 2048, N, H), (2, 2048, N, H), (2, 2048, N, Hv)))
        got = routed(lambda: cuda_k.flash_attention(q, k, v, **kw), rt, f"MLA shape {dt}")
        want = plain_attention(q, k, v, **kw).float()
        ratio, err = scaled_err(got.float(), want, own_row_scale(want),
                                f"MLA shape, N(0,1), {dt}", tol=tol)
        del got, want
        ms = time_ms(lambda: cuda_k.flash_attention(q, k, v, **kw), reps=5)
        b, ops = work("flash_attention_tc", (q, k, v), kw)
        rate = BF16_OPS_PER_S if rt == "tc" else TF32_OPS_PER_S
        bound = max(b / HBM_BYTES_PER_S, ops / rate) * 1e3
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, **kw), reps=5)
        del qt, kt, vt, q, k, v
        # the tensor-core route pads head dims to HD = 256 when max(H, Hv) is
        # 192: Q·Kᵀ stops at H, P·V runs over all HD columns
        pairs = ops / (2.0 * H + 2.0 * Hv)
        padded = (f", {pairs * 2.0 * (H + 256):.4g} executed at HD 256 (P·V over 256 columns)"
                  if rt == "tc" else "")
        log(f"[moe-mla] MLA shape N(0,1) {str(dt).removeprefix('torch.')} q (2, 2048, {N}, {H}) "
            f"v (…, {Hv}), {rt} route: within {tol:g} of each row's max|plain| (largest ratio "
            f"{ratio:.3e}, |kernel - plain| {err:.3e}); kernel {ms:.4f} ms, bound {bound:.4f} ms "
            f"({ops:.4g} operations needed at the {'bf16' if rt == 'tc' else 'TF32'} tensor rate, "
            f"{b / 1e6:.1f} MB{padded}); {ops / ms / 1e9:.2f} TFLOP/s needed; SDPA "
            f"{lib_ms:.4f} ms")

    # ---- each model at its published widths, cut in depth ------------------
    for mod in (deepseek_v3_671b, mixtral_8x22b):
        cut = MOE_MLA_SERVE[mod.CONFIG.name]
        cfg = dataclasses.replace(mod.CONFIG, n_layers=cut["n_layers"])
        B, S, T = cut["batch"], cut["seq"], cut["decode"]
        t0 = time.perf_counter()
        model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        if model.kernels.name != "cuda":
            fail(f"Transformer on the card chose kernels {model.kernels.name!r}")
        fns = make_serve_fns(cfg, model)
        tokens = torch.from_numpy(lm_batch(cfg, B, S, seed=0, step=0)["tokens"]).to(dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        n_bytes = sum(nbytes(p) for p in model.parameters())
        tag = f"[moe-mla] {cfg.name}"
        log(f"{tag}: {cfg.n_layers} of its {mod.CONFIG.n_layers} layers (depth cut only: "
            f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.moe.n_experts} experts top-"
            f"{cfg.moe.top_k}, first_k_dense {cfg.moe.first_k_dense}, "
            f"{'MLA' if cfg.mla else f'GQA {cfg.n_heads} on {cfg.n_kv_heads}'}, vocab "
            f"{cfg.vocab_size}, {cfg.dtype}): {n_params} parameters ({n_bytes / 1e9:.3f} GB) "
            f"made on the card from seed 0 in {time.perf_counter() - t0:.2f} s; lm_batch "
            f"tokens {tuple(tokens.shape)}")

        # ---- the path: prefill, then greedy decode; counted -----------------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        logits, cache = fns["prefill"](tokens)
        torch.cuda.synchronize()
        prefill_routes = moved_by_route()
        cuda.reset_launch_counts()
        out_k, grown, step_logits = greedy(fns, logits, cache, cfg, dev, T)
        torch.cuda.synchronize()
        n_decode = sum(moved_by_route().values())
        peak = torch.cuda.max_memory_allocated()
        if prefill_routes != {r: cfg.n_layers if r == "tc" else 0 for r in fa.ROUTES}:
            fail(f"{cfg.name}: a bf16 prefill of {cfg.n_layers} layers launched the routes "
                 f"{prefill_routes} (expected the tensor-core route {cfg.n_layers} times, the "
                 f"others 0)")
        if n_decode != 0:
            fail(f"{cfg.name}: flash_attention launched {n_decode} times in {T} decode steps")
        if logits.shape != (B, S, cfg.vocab_size) or logits.dtype != torch.bfloat16:
            fail(f"{cfg.name}: prefill logits {tuple(logits.shape)} {logits.dtype}")
        if step_logits.shape != (B, 1, cfg.vocab_size) or out_k.shape != (B, T + 1):
            fail(f"{cfg.name}: decode logits {tuple(step_logits.shape)}, tokens "
                 f"{tuple(out_k.shape)}")
        if not all(bool(torch.isfinite(logits[:, s0:s0 + 1024]).all())
                   for s0 in range(0, S, 1024)) or not torch.isfinite(step_logits).all():
            fail(f"{cfg.name}: non-finite logits")
        if cfg.mla is not None:
            want_shapes = [(cfg.n_layers, B, S, cfg.mla.kv_lora_rank),
                           (cfg.n_layers, B, S, cfg.mla.d_rope)]
        else:
            want_shapes = [(cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)] * 2
        grown_shapes = [sh[:2] + (S + T,) + sh[3:] for sh in want_shapes]
        if ([tuple(c.shape) for c in cache.data] != want_shapes
                or [tuple(c.shape) for c in grown.data] != grown_shapes
                or cache.s_cap != S or grown.s_cap != S + T):
            fail(f"{cfg.name}: cache {[tuple(c.shape) for c in cache.data]} / "
                 f"{[tuple(c.shape) for c in grown.data]}, not {want_shapes} / {grown_shapes}")
        log(f"{tag} path run: prefill {B} x {S} -> logits {tuple(logits.shape)} bfloat16, "
            f"{cache.kind} cache {want_shapes}; {T} greedy decode steps into {S + T} slots; "
            f"flash_attention launches by route in the prefill {prefill_routes}, {n_decode} in "
            f"decode; max_memory_allocated {peak / 1e9:.3f} GB")

        # ---- each prefill attention against the plain version; the routing --
        rec = recording_flash_attention()
        model.set_kernels(rec)
        moe_in = moe_inputs(model, tokens)
        model.set_kernels("cuda")
        if len(rec.args) != cfg.n_layers:
            fail(f"{cfg.name}: recorded {len(rec.args)} attention calls, not {cfg.n_layers}")
        call_errs = []
        for i, (q, k, v, kw) in enumerate(rec.args):
            got = routed(lambda: cuda_k.flash_attention(q, k, v, **kw), "tc",
                         f"{cfg.name} layer {i} attention")
            want = plain_attention(q, k, v, **kw)
            call_errs.append(scaled_err(got.float(), want.float(), own_row_scale(want.float()),
                                        f"{cfg.name} layer {i} prefill attention (bf16)",
                                        tol=2e-2))
            del got, want
        q, k, v, kw = rec.args[0]
        log(f"{tag}: the {len(call_errs)} prefill attentions (q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, {kw}), each through the tensor-core route, "
            f"within 2e-2 of each output row's max|plain|: largest ratio "
            f"{max(r for r, _ in call_errs):.3e}, largest |kernel - plain| "
            f"{max(e for _, e in call_errs):.3e}; served layer 0's attention "
            f"{time_ms(lambda: cuda_k.flash_attention(q, k, v, **kw), reps=5):.4f} ms")
        del rec, q, k, v
        log(f"{tag} routing of the prefill's {B * S} tokens (not held), capacity factor "
            f"{cfg.moe.capacity_factor}: " + "; ".join(routing_stats(model, l, h)
                                                       for l, h in moe_in))
        del moe_in

        # ---- the served path: times, device time by kernel --------------------
        prefill_ms = time_ms(lambda: fns["prefill"](tokens), reps=3)
        last = out_k[:, T - 1:T]
        decode_ms = time_ms(lambda: fns["decode"](grown, last, S + T - 1), reps=5)
        log(f"{tag} prefill {B} x {S}: {prefill_ms:.4f} ms ({B * S / prefill_ms * 1e3:.0f} "
            f"tokens/s); decode step (batch {B}, {S + T} slots): {decode_ms:.4f} ms; peak "
            f"{peak / 1e9:.3f} GB")
        log(f"{tag} prefill "
            f"{profile_line(device_profile(lambda: fns['prefill'](tokens), reps=1))}")
        log(f"{tag} decode step "
            f"{profile_line(device_profile(lambda: fns['decode'](grown, last, S + T - 1)))}")

        # ---- bf16 decode logits against a teacher-forced prefill (printed) ----
        # The prefill of the prompt and the greedy tokens: its logits at the
        # last decode step's position (the MoE capacity is the longer
        # prompt's, and every sum runs in another order)
        forced = fns["prefill"](torch.cat([tokens, out_k[:, :T]], dim=1))[0][:, -1:]
        ratio, err = logits_diff(step_logits, forced)
        agree = (step_logits.argmax(-1) == forced.argmax(-1)).float().mean().item()
        log(f"{tag} bf16 decode logits at position {S + T - 1} vs a teacher-forced prefill of "
            f"{S + T} tokens (not held): largest |diff| {err:.4g}, {ratio:.3e} of the row's max; "
            f"argmax agrees {agree:.2f}")
        del model, fns, logits, cache, grown, step_logits, forced, tokens
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 13
def step_ms(fn) -> float:
    """CUDA-event ms of one call of ``fn``."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


class VjpTimer:
    """Wraps an autograd Function's ``backward`` with CUDA events: the
    device time of its vector-Jacobian products in a backward."""

    def __init__(self, fn_cls):
        self.cls, self.orig, self.spans = fn_cls, fn_cls.backward, []

    def __enter__(self):
        orig, spans = self.orig, self.spans

        def backward(ctx, g):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(ctx, g)
            b.record()
            spans.append((a, b))
            return out

        self.cls.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.orig)

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def split_step(cfg, model, state, batch, step, opt_cfg, total, fn_cls):
    """One training step written out as `make_train_step` (warm-up 1) runs
    it, timed by CUDA events around the forward (the loss), the backward
    and the optimizer: ``(state, (fwd, bwd, opt) ms, ms of the autograd
    Function ``fn_cls``'s backward)``."""
    from repro_torch import optim
    from repro_torch.train.step import batch_on, grads_of, loss_for

    params = dict(model.named_parameters())
    b = batch_on(batch, model.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.zero_grad(set_to_none=True)
    with VjpTimer(fn_cls) as vjp:
        ev[0].record()
        loss = loss_for(cfg, b)(model)
        ev[1].record()
        loss.backward()
        ev[2].record()
    grads = grads_of(params)
    lr_scale = optim.cosine_warmup(step, warmup=1, total=total).to(model.device)
    state, _ = optim.update(opt_cfg, grads, state, params, lr_scale)
    ev[3].record()
    del grads, loss
    model.zero_grad(set_to_none=True)
    ev[3].synchronize()
    return state, tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3)), vjp.ms()


def grad_scale(want: torch.Tensor) -> torch.Tensor:
    """Each row's (last axis) largest |value|, floored at the median row's."""
    r = want.abs().amax(dim=-1, keepdim=True)
    return r.clamp_min(r.median())


def function_check(what, apply, plain, inputs, grad_out, tol, chunks=1) -> str:
    """``apply``'s (an autograd Function's) gradients against autograd of
    ``plain`` on the same inputs and output gradient, each element within
    ``tol`` × its row's scale (`grad_scale`). ``plain`` runs over
    ``chunks`` slices of the batch dim of the first two inputs and of
    ``grad_out`` (a third input's gradient summed over them), so that its
    materialised intermediates fit. Returns the line to print."""
    from repro_torch.kernels import cuda

    xs = [t.detach().clone().requires_grad_() for t in inputs]
    before = cuda.launch_counts()
    t_fn = step_ms(lambda: apply(*xs).backward(grad_out))
    launched = {k: v - before[k] for k, v in cuda.launch_counts().items() if v > before[k]}
    ys = [t.detach().clone().requires_grad_() for t in inputs]
    B = inputs[0].shape[0]
    per = -(-B // chunks)
    t_plain = 0.0
    for i in range(0, B, per):
        def run(i=i):
            parts = [y[i:i + per] if j < 2 else y for j, y in enumerate(ys)]
            plain(*parts).backward(grad_out[i:i + per] if chunks > 1 else grad_out)
        t_plain += step_ms(run)
    errs = {}
    for j, (x, y) in enumerate(zip(xs, ys)):
        errs[f"d{j}"] = scaled_err(x.grad, y.grad, grad_scale(y.grad),
                                   f"[train] {what}: gradient {j}", tol)[0]
    del xs, ys
    return (f"{what}: Function forward+backward {t_fn:.4f} ms (plain autograd {t_plain:.4f} "
            f"ms, {chunks} chunk(s)), launches {launched}; largest |Function - plain| / row "
            f"scale { {k: f'{v:.3e}' for k, v in errs.items()} } (tol {tol:g})")


def train_steps(what, cfg, model, batch_fn, n_steps, opt_cfg, kernels) -> dict:
    """``n_steps`` of `make_train_step` (warm-up 1: step 0 moves nothing)
    on ``model``, each step's launches counted from zero; fails on a count
    of a kernel other than ``kernels[name]``, a non-finite loss, a
    parameter moved by step 0 or one left as it was by the later steps."""
    from repro_torch import optim
    from repro_torch.kernels import cuda
    from repro_torch.train import make_train_step

    params = dict(model.named_parameters())
    state = optim.init(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg, total_steps=n_steps, warmup=1)
    before = {n: p.detach().clone() for n, p in params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = dict(times=[], metrics=[], counts=[])
    for s in range(n_steps):
        batch = batch_fn(s)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        box = []
        out["times"].append(step_ms(lambda: box.append(step(model, state, batch, s))))
        state, metrics = box[0]
        counts = cuda.launch_counts()
        out["counts"].append({k: counts[k] for k in kernels})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if not np.isfinite(out["metrics"][-1]["loss"]):
            fail(f"[train] {what}: loss {out['metrics'][-1]['loss']} at step {s}")
        if out["counts"][-1] != kernels:
            fail(f"[train] {what}: launches {out['counts'][-1]} in step {s}, expected {kernels}")
        if s == 0:
            moved = [n for n, p in params.items() if not torch.equal(p, before[n])]
            if moved:
                fail(f"[train] {what}: step 0 (lr 0) moved {moved[:4]}")
    still = [n for n, p in params.items() if torch.equal(p, before[n])]
    if still:
        fail(f"[train] {what}: steps 1-{n_steps - 1} left {len(still)} parameters as they "
             f"were: {still[:4]}")
    del before
    out.update(state=state, step=step, peak=torch.cuda.max_memory_allocated() / 1e9,
               median=statistics.median(out["times"][1:]))
    return out


def resume_check(dev) -> str:
    """The supervisor at gemma-2b's smoke config on the card: a
    `SimulatedPreemption` at step 3 of 6 and a restart from the latest
    checkpoint (step 2) must give the state of an uninterrupted run, bit for
    bit. Checkpoints go under ``build/``."""
    import shutil

    from repro_torch import optim
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten_with_paths
    from repro_torch.configs import gemma_2b
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models.transformer import Transformer
    from repro_torch.runtime import SimulatedPreemption, TrainSupervisor
    from repro_torch.train import make_train_step
    from repro_torch.train.step import supervised

    cfg = gemma_2b.smoke()
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def supervisor(sub, fail_at=None):
        return TrainSupervisor(Checkpointer(root / sub, keep=2), ckpt_every=2,
                               fail_at=dict(fail_at or {}))

    def run(sup):
        model = Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(3),
                            device=dev)
        opt = optim.AdamWConfig(quantize_moments=True)
        step_fn, params = supervised(model, make_train_step(cfg, opt, total_steps=6, warmup=1))
        return sup.run(state=(params, optim.init(opt, params)), step_fn=step_fn,
                       batch_fn=lambda s: lm_batch(cfg, 4, 64, seed=0, step=s), n_steps=6)

    want, hist = run(supervisor("whole"))
    cut = supervisor("cut", {3: SimulatedPreemption})
    try:
        run(cut)
        fail("[train] resume: the injected preemption did not stop the run")
    except SimulatedPreemption:
        pass
    # the restart is a fresh supervisor over the same directory, as a
    # restarted process would be: it sees only what is on disk
    got, hist2 = run(supervisor("cut"))
    if [h["step"] for h in hist2] != [2, 3, 4, 5]:
        fail(f"[train] resume: resumed at {[h['step'] for h in hist2]}, not [2, 3, 4, 5]")
    a, b = flatten_with_paths(want), flatten_with_paths(got)
    differ = [n for (n, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
    if differ or [h["loss"] for h in hist2] != [h["loss"] for h in hist[2:]]:
        fail(f"[train] resume: {len(differ)} of {len(a)} leaves differ from the uninterrupted "
             f"run ({differ[:4]}), losses {[h['loss'] for h in hist2]} vs "
             f"{[h['loss'] for h in hist[2:]]}")
    shutil.rmtree(root, ignore_errors=True)
    losses = [round(h["loss"], 6) for h in hist2]
    return (f"resume: {cfg.name} (fp32, int8 moments) preempted at step 3 of 6, restarted from "
            f"step 2: all {len(a)} leaves (parameters, step, m, v) bit-identical to the "
            f"uninterrupted run, losses of steps 2-5 {losses} equal")


def layer_grad_check(model, tokens) -> str:
    """gemma-2b's step-0 gradient a layer at a time, kernels="cuda" against
    kernels="torch": each layer's `train_layer` on the plain path's input to
    it, backward from one shared seeded output gradient; held: the norm of
    the layer's parameter gradients and the input gradient (relative to its
    max|plain|) within `STEP0_TOL`."""
    cfg = model.cfg
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    g = torch.Generator(device=tokens.device).manual_seed(5)
    params = [p for n, p in model.named_parameters() if p.shape[:1] == (cfg.n_layers,)]
    worst = dict(layer_grad_norm=0.0, layer_input_grad=0.0)
    with torch.no_grad():
        x = model.embed_tokens(tokens)
    for l in range(cfg.n_layers):
        go = torch.randn(x.shape, generator=g, device=x.device).to(x.dtype)
        got = {}
        for name in ("cuda", "torch"):
            model.set_kernels(name)
            xx = x.detach().requires_grad_()
            out, _ = model.train_layer(l, xx, positions)
            out.backward(go)
            norm = torch.sqrt(sum(p.grad[l].float().square().sum() for p in params))
            got[name] = (float(norm), xx.grad.float())
            model.zero_grad(set_to_none=True)
        (na, ga), (nb, gb) = got["cuda"], got["torch"]
        rel = dict(layer_grad_norm=abs(na - nb) / nb,
                   layer_input_grad=float((ga - gb).abs().max() / gb.abs().max()))
        for k, v in rel.items():
            if not v <= STEP0_TOL[k]:
                fail(f"[train] gemma-2b step 0, layer {l}: {k} cuda vs torch rel {v:.3e} > "
                     f"{STEP0_TOL[k]:g}")
            worst[k] = max(worst[k], v)
        with torch.no_grad():
            x = model.train_layer(l, x, positions)[0]  # the plain path's input to l + 1
    model.set_kernels("cuda")
    return (f"{cfg.n_layers} layers held one at a time on the plain path's inputs: largest "
            f"rel |cuda - torch| of a layer's parameter-gradient norm "
            f"{worst['layer_grad_norm']:.3e} (tol {STEP0_TOL['layer_grad_norm']:g}), of its "
            f"input gradient (max-abs) {worst['layer_input_grad']:.3e} (tol "
            f"{STEP0_TOL['layer_input_grad']:g})")


def phase_train(dev, mb_host, smi: str) -> None:
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import gatedgcn, gemma_2b, xdeepfm
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.pipeline import lm_batch, recsys_batch
    from repro_torch.extras.flash_attention import flash_attention as fa
    from repro_torch.extras.flash_attention import ref as fa_ref
    from repro_torch.extras.segment_mp import ref as seg_ref
    from repro_torch.extras.segment_mp import segment_mp as smp
    from repro_torch.kernels.cin import cin
    from repro_torch.kernels.cin import ref as cin_ref
    from repro_torch.models import schema
    from repro_torch.models.gnn import GNN, batch_to
    from repro_torch.models.recsys import XDeepFM
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.step import batch_on, loss_for

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()

    # ---- gemma-2b at its published widths and full depth ------------------
    cfg = gemma_2b.CONFIG
    model = schema.trainable(Transformer(
        cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 2_506_172_416 or model.kernels.name != "cuda":
        fail(f"[train] gemma-2b: {n_params} parameters on kernels {model.kernels.name!r}")
    B, S, n_steps = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"]
    batch_fn = lambda s: lm_batch(cfg, B, S, seed=0, step=s)  # noqa: E731
    opt_cfg = optim.AdamWConfig()
    # step 0's loss and gradient norm with the plain versions (nothing updated)
    model.set_kernels("torch")
    loss = loss_for(cfg, batch_on(batch_fn(0), dev))(model)
    loss.backward()
    plain0 = dict(loss=float(loss.detach()), grad_norm=float(optim.global_norm(
        {n: p.grad for n, p in model.named_parameters()})))
    del loss
    model.zero_grad(set_to_none=True)
    model.set_kernels("cuda")
    torch.cuda.empty_cache()
    r = train_steps("gemma-2b", cfg, model, batch_fn, n_steps, opt_cfg,
                    {fa.ROUTES[k].symbol: 2 * cfg.n_layers * (k == "tc") for k in fa.ROUTES})
    rel0 = {k: abs(r["metrics"][0][k] - plain0[k]) / abs(plain0[k]) for k in plain0}
    if not rel0["loss"] <= STEP0_TOL["loss"]:
        fail(f"[train] gemma-2b step 0 loss: kernels='cuda' {r['metrics'][0]['loss']} vs "
             f"'torch' {plain0['loss']}, rel {rel0['loss']:.3e} > {STEP0_TOL['loss']:g}")
    log(f"[train] gemma-2b ({n_params} parameters, bf16, remat {cfg.remat!r}, AdamW at its "
        f"defaults, fp32 moments), {n_steps} steps of {B} x {S} lm_batch tokens (warm-up 1: "
        f"step 0 at lr 0 moved nothing; steps 1-{n_steps - 1} moved every parameter): losses "
        f"{[round(m['loss'], 6) for m in r['metrics']]}, grad_norm "
        f"{[round(m['grad_norm'], 6) for m in r['metrics']]}, lr "
        f"{[m['lr'] for m in r['metrics']]}; launches a step {r['counts']} (18 in the "
        f"forward, 18 in remat's recomputation; the backward's vjp is the plain version's)")
    log(f"[train] gemma-2b step ms {[round(t, 4) for t in r['times']]}: median of steps 1-"
        f"{n_steps - 1} {r['median']:.4f} ms, {B * S / r['median'] * 1e3:.0f} tokens/s; peak "
        f"max_memory_allocated {r['peak']:.3f} GB")
    log(f"[train] gemma-2b step (6·N·D, remat's second forward not counted): "
        f"{flops_share(model_flops_lm(cfg, B, S, 'train'), r['median'], 'bfloat16', smi)}")
    log(f"[train] gemma-2b step 0, kernels='cuda' vs 'torch' (same weights and batch): loss "
        f"{r['metrics'][0]['loss']:.6f} vs {plain0['loss']:.6f} (rel {rel0['loss']:.3e}, tol "
        f"{STEP0_TOL['loss']:g}); grad_norm at full depth {r['metrics'][0]['grad_norm']:.6e} "
        f"vs {plain0['grad_norm']:.6e} (rel {rel0['grad_norm']:.3e}, not held); "
        f"{layer_grad_check(model, torch.as_tensor(batch_fn(0)['tokens'], device=dev))}")
    state = r.pop("state")
    state, split, vjp = split_step(cfg, model, state, batch_fn(n_steps), n_steps, opt_cfg,
                                   n_steps + 1, fa.FlashAttention)
    log(f"[train] gemma-2b one step split by CUDA events: forward (loss) {split[0]:.4f} ms, "
        f"backward {split[1]:.4f} ms (FlashAttention's backward, the plain attention vjp, "
        f"{vjp:.4f} ms of it, {100 * vjp / split[1]:.1f}%), optimizer {split[2]:.4f} ms")
    step = r["step"]
    box = [state]

    def traced():
        box[0] = step(model, box[0], batch_fn(0), n_steps)[0]

    log(f"[train] gemma-2b one step traced: {profile_line(device_profile(traced, reps=1))}")
    del model, state, box, r, step
    torch.cuda.empty_cache()

    # ---- each Function at its path's shapes, against the plain autograd ---
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, S, cfg.n_heads, cfg.d_head), generator=g, device=dev)
    k = torch.randn((B, S, cfg.n_kv_heads, cfg.d_head), generator=g, device=dev)
    v = torch.randn((B, S, cfg.n_kv_heads, cfg.d_head), generator=g, device=dev)
    go = torch.randn((B, S, cfg.n_heads, cfg.d_head), generator=g, device=dev)
    for dt, route in ((torch.bfloat16, "tc"), (torch.float32, "tf32")):
        ins = [t.to(dt) for t in (q, k, v)]
        line = routed(lambda: function_check(
            f"flash_attention ({route}), gemma-2b layer-0 shape, {str(dt)[6:]} N(0,1)",
            fa.FlashAttention.apply, fa_ref.mha_reference, ins, go.to(dt), 1e-6), route,
            f"[train] flash_attention {route}")
        log(f"[train] {line}")
    del q, k, v, go, ins

    # ---- xDeepFM at its published widths and train batch ------------------
    rcfg = xdeepfm.CONFIG
    rmodel = schema.trainable(XDeepFM(
        rcfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev))
    Bt, n_rsteps = RECSYS_TRAIN["batch"], RECSYS_TRAIN["steps"]
    # a CIN layer's forward launch, and in the backward one for grad_xk and one
    # for grad_x0 (the first layer's xk is x0 itself: both still launch)
    per = 3 * len(rcfg.cin_layers)
    r = train_steps("xdeepfm", rcfg, rmodel, lambda s: recsys_batch(rcfg, Bt, seed=0, step=s),
                    n_rsteps, optim.AdamWConfig(), {cin.CIN.symbol: per})
    log(f"[train] xdeepfm (39 x 1,000,000 x 10 tables, CIN 200-200-200, MLP 400-400), "
        f"{n_rsteps} steps of recsys_batch at batch {Bt}: losses "
        f"{[round(m['loss'], 6) for m in r['metrics']]}; cin_layer launches a step "
        f"{r['counts']} (3 forward, 6 in the backward: grad_xk and grad_x0 are CIN layers); "
        f"step ms {[round(t, 4) for t in r['times']]}, median of steps 1-{n_rsteps - 1} "
        f"{r['median']:.4f} ms, {Bt / r['median'] * 1e3:.0f} rows/s; peak {r['peak']:.3f} GB")
    _, split, vjp = split_step(rcfg, rmodel, r.pop("state"),
                               recsys_batch(rcfg, Bt, seed=0, step=n_rsteps), n_rsteps,
                               optim.AdamWConfig(), n_rsteps + 1, cin.CinLayer)
    log(f"[train] xdeepfm one step split by CUDA events: forward (loss) {split[0]:.4f} ms, "
        f"backward {split[1]:.4f} ms (CinLayer's backward: 6 kernel launches and grad_w "
        f"in chunks, {vjp:.4f} ms of it, {100 * vjp / split[1]:.1f}%), optimizer "
        f"{split[2]:.4f} ms")
    del r
    ids = torch.as_tensor(recsys_batch(rcfg, Bt, seed=0, step=0)["ids"], device=dev)
    from repro_torch.models.recsys import embedding_bag

    with torch.no_grad():
        emb = embedding_bag(rmodel.tables, ids, torch.ones_like(ids, dtype=torch.bool))
        x1 = cin.cin_layer(emb, emb, rmodel.cin["w0"])
    del rmodel, ids
    torch.cuda.empty_cache()
    gg = torch.Generator(device=dev).manual_seed(2)
    for what, xk, w in (("layer 1", emb, torch.randn((39 * 39, 200), generator=gg, device=dev)),
                        ("a 200-wide layer", x1, torch.randn((200 * 39, 200), generator=gg,
                                                             device=dev))):
        go = torch.randn((Bt, 200, rcfg.embed_dim), generator=gg, device=dev)
        log("[train] " + function_check(
            f"cin_layer, xDeepFM {what} at batch {Bt} (xk {tuple(xk.shape)})",
            cin.CinLayer.apply, cin_ref.cin_layer_reference, [xk, emb, w], go, 1e-4,
            chunks=8))
    del emb, x1, w, go
    torch.cuda.empty_cache()

    # ---- GatedGCN at its published widths on [gnn]'s minibatch_lg batch ---
    gcfg = dataclasses.replace(gatedgcn.CONFIG, d_in=GNN_SHAPES["minibatch_lg"]["d"])
    gmodel = schema.trainable(GNN(
        gcfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev))
    graph = batch_to(mb_host, dev)
    n_gsteps = GNN_TRAIN["steps"]
    r = train_steps("gatedgcn", gcfg, gmodel, lambda s: {"graph": graph}, n_gsteps,
                    optim.AdamWConfig(), {smp.SEGMENT_MP.symbol: 2 * gcfg.n_layers})
    log(f"[train] gatedgcn (16 layers, d 70, d_in 602), {n_gsteps} steps on minibatch_lg "
        f"({graph.node_feat.shape[0]} node slots, {graph.edge_src.shape[0]} edge slots): losses "
        f"{[round(m['loss'], 6) for m in r['metrics']]}; segment_mp launches a step "
        f"{r['counts']} (2 a layer in the forward; the backward is a gather); step ms "
        f"{[round(t, 4) for t in r['times']]}, median of steps 1-{n_gsteps - 1} "
        f"{r['median']:.4f} ms; peak {r['peak']:.3f} GB")
    _, split, vjp = split_step(gcfg, gmodel, r.pop("state"), {"graph": graph}, n_gsteps,
                               optim.AdamWConfig(), n_gsteps + 1, smp.SegmentMP)
    log(f"[train] gatedgcn one step split by CUDA events: forward (loss) {split[0]:.4f} ms, "
        f"backward {split[1]:.4f} ms (SegmentMP's backward, a gather, {vjp:.4f} ms of it, "
        f"{100 * vjp / split[1]:.1f}%), optimizer {split[2]:.4f} ms")
    del r
    rec = recording_segment_mp(1)
    gmodel.set_kernels(rec)
    with torch.no_grad():
        gmodel(graph)
    msg, dst, n = rec.args[0]
    gmodel.set_kernels("cuda")
    go = torch.randn((n, msg.shape[1]), generator=gg, device=dev)
    log("[train] " + function_check(
        f"segment_mp, GatedGCN's first aggregation ({tuple(msg.shape)} -> {n} nodes)",
        lambda m: smp.SegmentMP.apply(m, dst, n), lambda m: seg_ref.segment_mp_reference(
            m, dst, n), [msg], go, 0.0))
    del gmodel, graph, msg, rec, go
    torch.cuda.empty_cache()

    # ---- the supervisor's resume, on the card ------------------------------
    log(f"[train] {resume_check(dev)}")
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------------- main
# each contracted op (and mask_to_host) → the C entry points its call may
# launch; attention takes the route of its example's dtype and shape
CONTRACT_KERNELS = {
    "bitset_pack": ("bitset_pack",), "bitset_unpack": ("bitset_unpack",),
    "bitset_lookup": ("bitset_lookup",), "bitset_build": ("bitset_build",),
    "candidate_filter": ("candidate_filter",), "stwig_expand": ("stwig_expand",),
    "hash_join_probe": ("hash_join_probe",), "cin_layer": ("cin_layer",),
    "segment_mp": ("segment_mp",), "mask_to_host": ("bitset_pack",),
    "flash_attention": ("flash_attention", "flash_attention_tc", "flash_attention_tf32"),
}


def phase_analysis(smi: str, rank_probes: list | None = None) -> None:
    """[analysis]: the port's static analyzer (`repro_torch.analysis`) on the
    card, every pass on, over the CUDA kernels: zero findings, each
    contracted op's kernel launched in the contract pass and the matcher's
    five in each engine's probe; then each probe step's cost-model peak
    beside the card's own count, and the engines' rooflines. With
    ``rank_probes`` (each card rank's `engines.rank_probe` from
    [ranks-small]), the collective-safety pass on the rank engine too: no
    finding on any rank, the ranks' call sequences alike, and each rank's
    probe launching the matcher's five."""
    from repro_torch.analysis import roofline
    from repro_torch.analysis.staticcheck import costmodel, engines, run_all
    from repro_torch.core.backend import op_contracts
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    if rank_probes is not None:
        findings = engines.check_rank_probes(rank_probes)
        for f in findings:
            log(f"[analysis] rank probe finding: {f}")
        if findings:
            fail(f"[analysis] {len(findings)} finding(s) on the rank engine's probe")
        for p in rank_probes:
            if any(p["launches"].get(sym, 0) <= 0 for sym in MATCHER_KERNELS):
                fail(f"[analysis] rank {p['rank']}'s probe launched {p['launches']}")
        seq = rank_probes[0]["sequence"]
        log(f"[analysis] collective safety on the rank engine's probe ({len(rank_probes)} "
            f"ranks on cuda:0, [ranks-small]'s run): 0 findings; {len(seq)} collectives a "
            f"rank, the same on every rank, each on a group of {sorted({g for _, g in seq})} "
            f"ranks; launches a rank {[p['launches'] for p in rank_probes]}")
    reports: dict = {}
    cuda.reset_launch_counts()
    findings = run_all(ROOT, device="cuda", kernel_backends=("cuda",), reports=reports)
    torch.cuda.synchronize()
    for f in findings:
        log(f"[analysis] finding: {f}")
    if findings:
        fail(f"[analysis] {len(findings)} finding(s) on the cuda backend")
    launches = reports["launches"]
    ops = [c.op for c in op_contracts("cuda")] + ["mask_to_host"]
    for op in ops:
        if not any(launches["contracts"].get(sym, 0) > 0 for sym in CONTRACT_KERNELS[op]):
            fail(f"[analysis] the contract pass launched no kernel of {op}: {launches['contracts']}")
    for eng in ("local", "sharded"):
        got = launches[f"engine:{eng}:cuda"]
        for sym in MATCHER_KERNELS:
            if got.get(sym, 0) <= 0:
                fail(f"[analysis] the {eng} probe launched no {sym}: {got}")
    log(f"[analysis] run_all(device='cuda', kernel_backends=('cuda',)): 0 findings; launches "
        f"{launches}")
    syncs = {s["target"]: s["host_syncs"] for s in reports["steps"]}
    for t in reports["traces"]:
        if not t.call or t.kernels != "cuda":
            continue
        fn, args, kwargs = t.call
        seen, arg_bytes = set(), 0
        for a in t.log.args:
            if a.storage not in seen:
                seen.add(a.storage)
                arg_bytes += a.nbytes
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - base + arg_bytes
        del out
        est = costmodel.estimate(t.log, t.target, t.collectives)
        log(f"[analysis] {t.target}: cost-model peak "
            f"{est.peak_bytes:.0f} B, max_memory_allocated over the step + its arguments "
            f"{step_peak} B (arguments {arg_bytes} B); {est.flops:.6g} operations, "
            f"{est.collective_bytes:.6g} collective bytes; {len(t.log.ops)} ops, "
            f"{syncs.get(t.target, 0)} host syncs")
    rl = roofline.engine_rooflines(traces=[t for t in reports["traces"] if t.kernels == "cuda"])
    for target, r in rl.items():
        log(f"[analysis] roofline {target}: compute {r.t_compute * 1e6:.4f} us, memory "
            f"{r.t_memory * 1e6:.4f} us, collective {r.t_collective * 1e6:.4f} us -> "
            f"{r.bottleneck}, fraction {r.roofline_fraction:.4f} ({smi})")
    log(f"[analysis] {retry_pricing_line()}")
    log(f"[analysis] phase {time.perf_counter() - t0:.1f} s")


def retry_pricing_line() -> str:
    """The host time of the adaptive retry's pricing: `plan_caps_bytes` (the
    cost model's peak of the join run on meta tensors) at each escalation
    from the default caps to the first past the ceiling, first sight and a
    second call. A cap an earlier phase already priced is marked cached."""
    from repro_torch.runtime import resilience

    caps = {"child_cap": 8, "join_rows_cap": 1 << 16, "join_dup_cap": 64}
    ceiling = resilience.retry_ceiling_bytes()
    parts = []
    while True:
        key = (caps["join_rows_cap"], caps["join_dup_cap"], 4)
        cached = key in resilience._COST_CACHE
        t = time.perf_counter()
        est = resilience.plan_caps_bytes(caps)
        first = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        resilience.plan_caps_bytes(caps)
        again = (time.perf_counter() - t) * 1e3
        parts.append(f"{key[0]} x {key[1]}: {est / 1e9:.4f} GB, {first:.3f} ms"
                     f"{' (cached)' if cached else ''}, again {again:.4f} ms")
        if est > ceiling or len(parts) > 8:
            break
        caps = resilience.grow_caps(caps)
    return (f"retry pricing (host, meta tensors) to the {ceiling / 1e9:g} GB ceiling: "
            + "; ".join(parts))


# ---------------------------------------------------------------- [direct]
def direct_entry_points(session, queries, rows, stream_rows, tag: str) -> None:
    """The engine's direct entry points on the path's queries, with the
    launch counts zeroed just before and read just after:
    ``session.engine.match(q, adaptive=False)`` must give the rows of
    ``compiled.run(adaptive=False)`` (``rows``, from `run_queries`), and
    ``match_stream`` on the streamed query pages whose rows, up to 1,024,
    are the facade stream's (``stream_rows``); the pages are at most the
    open stream's ``n_blocks``; the matcher's five kernels are launched."""
    from repro_torch.core.stream import open_stream
    from repro_torch.kernels import cuda

    eng = session.engine
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    got = [eng.match(q, adaptive=False, max_matches=1024).rows for q in queries]
    # CompiledQuery.stream(page_size=256) joins blocks of max(256, 1024) rows
    pages = list(eng.match_stream(queries[0], max_matches=1024, block_rows=1024))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = cuda.launch_counts()
    for sym in MATCHER_KERNELS:
        if counts[sym] <= 0:
            fail(f"[{tag}] kernel {sym} was never launched by the engine's direct entry points")
    for i, (a, b) in enumerate(zip(got, rows)):
        if a.shape != b.shape or not (a == b).all():
            fail(f"[{tag}] q{i}: engine.match gives other rows than compiled.run")
    direct = (np.concatenate([p.rows for p in pages]) if pages
              else np.zeros((0, queries[0].n_nodes), np.int64))
    want = (np.concatenate(stream_rows) if stream_rows
            else np.zeros((0, queries[0].n_nodes), np.int64))
    if direct[:1024].shape != want.shape or not (direct[:1024] == want).all():
        fail(f"[{tag}] match_stream's first {len(want)} rows are not the facade stream's")
    n_blocks = open_stream(eng, queries[0], None, block_rows=1024, max_matches=1024).n_blocks
    if not 0 < len(pages) <= n_blocks:
        fail(f"[{tag}] match_stream yielded {len(pages)} pages, n_blocks is {n_blocks}")
    log(f"[{tag}] direct entry points: engine.match(q, adaptive=False) x {len(queries)} "
        f"= compiled.run's rows, match_stream's {len(pages)} pages (n_blocks {n_blocks}, "
        f"{len(direct)} rows) begin with the facade stream's {len(want)}; {ms:.3f} ms; "
        f"launches { {k: counts[k] for k in MATCHER_KERNELS} }")


def stacked_any_check(eng) -> str:
    """`collectives.bool_allreduce_any` over the sharded engine's stacked
    shard dim, bit for bit against its plain version (numpy: the shards'
    largest value as int32 is positive): each shard's label == 0 flags, its
    int32 labels, and its labels less one (-1 where a label is 0)."""
    from repro_torch.core import collectives

    labels = torch.stack([gr.labels for gr in eng.graphs])  # (S, cap) on the card
    out = []
    for x in (labels == 0, labels, labels - 1):
        got = collectives.bool_allreduce_any(x)
        want = x.cpu().numpy().astype(np.int32).max(axis=0) > 0
        if got.dtype != torch.bool or not np.array_equal(got.cpu().numpy(), want):
            fail(f"bool_allreduce_any over {tuple(x.shape)} {x.dtype} differs from numpy")
        out.append(f"{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}")
    return f"bool_allreduce_any bit-exact with numpy's max > 0 over the shard dim on {out}"


# ---------------------------------------------------------------- molecule
# the GNN molecule shape (GNN_SHAPES["molecule"]: 128 graphs × 30 nodes,
# 8,192 slots of directed edges, d 32): molecule_batch at avg_degree 2.15
# draws int(30 · 2.15 / 2) = 32 bonds a molecule, 4,096 in all, 8,192 once
# stored both ways
MOLECULE = dict(avg_degree=2.15, n_labels=8, seed=0)


def gnn_molecule(dev) -> None:
    """GIN-TU and GatedGCN forwards at their published widths on
    ``molecule_batch`` at the molecule shape, ``kernels="cuda"`` against
    ``kernels="torch"`` (1e-4 of each graph's largest |logit|, floored at
    the median graph's), with ``segment_mp``'s launches counted for each
    forward alone (a launch a GIN layer, two a GatedGCN layer, two for the
    pooling)."""
    import dataclasses

    from repro_torch.configs import gatedgcn, gin_tu
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.pipeline import gnn_graph_batch
    from repro_torch.graphstore import generators
    from repro_torch.kernels import cuda
    from repro_torch.models.gnn import GNN, batch_to
    from repro_torch.train.step import make_serve_fns

    t_phase = time.perf_counter()
    s = GNN_SHAPES["molecule"]
    n_graphs = s["n_graphs"]
    per = s["n"] // n_graphs
    e_per = max(1, int(per * MOLECULE["avg_degree"] / 2))
    if 2 * n_graphs * e_per != s["e"]:
        fail(f"molecule_batch draws {n_graphs} x {e_per} bonds, not the shape's "
             f"{s['e']} directed edges")
    g = generators.molecule_batch(n_graphs, per, MOLECULE["avg_degree"], MOLECULE["n_labels"],
                                  seed=MOLECULE["seed"])
    src = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    undirected = int((src < g.indices).sum())
    log(f"[gnn] molecule: molecule_batch({n_graphs}, {per}, {MOLECULE['avg_degree']}) draws "
        f"{e_per} bonds a molecule ({n_graphs * e_per}); Graph.from_edges keeps {undirected} "
        f"(self-loops and repeats dropped) and stores each both ways ({g.n_edges} directed); "
        f"the batch carries every directed edge in {s['e']} slots, graph_id = node // {per}")
    for mod, per_layer in ((gin_tu, 1), (gatedgcn, 2)):
        cfg = dataclasses.replace(mod.CONFIG, d_in=s["d"], task="graph")
        batch = batch_to(gnn_graph_batch(cfg, g, nodes_per_graph=per, n_edges=s["e"],
                                         n_classes=cfg.n_classes, seed=0), dev)
        model = GNN(cfg, device=dev)
        if model.kernels.name != "cuda":
            fail(f"GNN on the card chose kernels {model.kernels.name!r}")
        fn = make_serve_fns(cfg, model)["infer"]
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        got = fn(batch)
        torch.cuda.synchronize()
        n = cuda.launch_counts()["segment_mp"]
        if n != per_layer * cfg.n_layers + 2:
            fail(f"{cfg.name} molecule: segment_mp launched {n} times, not "
                 f"{per_layer * cfg.n_layers + 2}")
        if got.shape != (n_graphs, cfg.n_classes):
            fail(f"{cfg.name} molecule: logits of shape {tuple(got.shape)}")
        ms = time_ms(lambda: fn(batch))
        model.set_kernels("torch")
        want = fn(batch)
        err = scaled_err(got, want, row_scale(want), f"{cfg.name} molecule logits")
        plain_ms = time_ms(lambda: fn(batch))
        log(f"[gnn] {cfg.name} molecule forward ({cfg.n_layers} layers, d {cfg.d_hidden}): "
            f"within 1e-4 of kernels='torch' (largest |kernel - plain| / scale, largest "
            f"|kernel - plain|: {err[0]:.3e}, {err[1]:.3e}); segment_mp launches {n}; "
            f"{ms:.4f} ms (kernels='torch': {plain_ms:.4f} ms)")
    log(f"[gnn] molecule {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------- [examples]
def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> None:
    """Each ``examples/torch_*.py`` ``main()`` on the card at its default
    size, its launch counts zeroed just before and read just after: the
    matcher examples must launch the matcher's five kernels, the training
    example the attention route its head dims take once a layer a step."""
    from repro_torch.kernels import cuda

    t_phase = time.perf_counter()
    for name in ("torch_quickstart", "torch_distributed_query", "torch_serve_queries"):
        mod = load_example(name)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = mod.main([])
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        counts = cuda.launch_counts()
        for sym in MATCHER_KERNELS:
            if counts[sym] <= 0:
                fail(f"[examples] {name}: kernel {sym} was never launched")
        if name == "torch_serve_queries":
            if out["summary"]["failed"] or out["stats"].global_degradations:
                fail(f"[examples] {name}: {out['summary']['failed']} failed, "
                     f"{out['stats'].global_degradations} global degradations")
            what = (f"{len(out['outcomes'])} queries: {out['summary']['served']} served, "
                    f"{out['summary']['partial']} partial")
        else:
            res = out["result"]
            if res.n_matches == 0 or res.stats.backend not in ("local", "sharded"):
                fail(f"[examples] {name}: {res.n_matches} matches on {res.stats.backend}")
            what = f"{res.n_matches} matches on {res.stats.backend}, complete {res.complete}"
        log(f"[examples] {name}: {what}; {s:.2f} s; launches "
            f"{ {k: counts[k] for k in MATCHER_KERNELS} }")
    mod = load_example("torch_train_lm")
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = mod.main(["--ckpt", str(ROOT / "build" / "torch_example_ckpt")])
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    hist = out["history"]
    launches = cuda.launch_counts()[out["symbol"]]
    if launches != out["launches"]:
        fail(f"[examples] torch_train_lm: the counts read {launches} launches of "
             f"{out['symbol']}, the example {out['launches']}")
    if launches != 4 * len(hist):
        fail(f"[examples] torch_train_lm: route {out['route']!r} launched {launches} "
             f"times in {len(hist)} steps of 4 layers")
    log(f"[examples] torch_train_lm: attention route {out['route']!r}, {launches} "
        f"launches in {len(hist)} steps (one a layer a step: the backward is the plain "
        f"version's); loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; {s:.2f} s")
    log(f"[examples] phase {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------- [dryrun]
# the cells the card runs at their assigned shapes (their priced peaks fit),
# each step run once on the card beside its price; a cell whose measured
# peak is >= DRYRUN_HELD_BYTES must fall in DRYRUN_BAND (measured / priced),
# the band written down before the first run (PERF.md, the dry run's findings)
DRYRUN_CARD_CELLS = (("xdeepfm", "serve_p99"), ("xdeepfm", "serve_bulk"),
                     ("xdeepfm", "retrieval_cand"), ("xdeepfm", "train_batch"),
                     ("gatedgcn", "molecule"), ("gin-tu", "molecule"),
                     ("gatedgcn", "minibatch_lg"))
DRYRUN_BAND = (0.8, 1.5)
DRYRUN_HELD_BYTES = 256e6


def card_args(cell, cfg, opt_cfg, dev):
    """The cell's abstract arguments made real on the card: the model drawn
    from seed 0 (CUDA kernels), AdamW state from ``optim.init``, and inputs
    of the abstract shapes and dtypes with their values in range."""
    from repro_torch import optim

    meta = cell.abstract_args(cfg, opt_cfg)
    model = type(meta[0])(meta[0].cfg, device=dev)
    mcfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)

    def fill(t, hi=None):
        if t.dtype == torch.bool:
            return torch.ones(t.shape, dtype=torch.bool, device=dev)
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen, dtype=t.dtype, device=dev)
        return torch.randint(0, hi, t.shape, generator=gen, dtype=t.dtype, device=dev)

    if cell.kind != "train":
        vocab = mcfg.vocab_per_field
        return (model,) + tuple(fill(t, vocab) for t in meta[1:])
    batch = meta[2]
    if "graph" in batch:
        g = batch["graph"]
        N = g.node_feat.shape[0]
        hi = {"edge_src": N, "edge_dst": N, "graph_id": g.n_graphs, "labels": mcfg.n_classes}
        fields = {k: fill(v, hi.get(k)) for k, v in g._asdict().items()
                  if isinstance(v, torch.Tensor)}
        if g.graph_id is not None:
            fields["graph_id"] = (torch.arange(N, device=dev) * g.n_graphs // N).to(torch.int32)
        real = {"graph": g._replace(**fields)}
    else:
        real = {"ids": fill(batch["ids"], mcfg.vocab_per_field),
                "bag_mask": fill(batch["bag_mask"]), "labels": fill(batch["labels"], 2)}
    return (model, optim.init(opt_cfg, dict(model.named_parameters())), real,
            torch.zeros((), dtype=torch.int32, device=dev))


def phase_dryrun(smi: str) -> None:
    """Every arch × shape cell priced on meta tensors on the host
    (``dryrun.run_cell``, in this process): a line a cell, the summary (0
    failed, every skipped cell one of its arch's ``skipped_shapes``), the
    seconds; then each `DRYRUN_CARD_CELLS` step run once on the card from
    the cell's shapes, its measured peak (``max_memory_allocated`` over the
    memory allocated before its arguments were made) beside the priced
    one, and the priced FLOPs beside the model FLOPs."""
    from repro_torch.configs import get
    from repro_torch.extras import dryrun, shapes
    from repro_torch.kernels import cuda

    total = torch.cuda.get_device_properties(0).total_memory
    t_start = time.perf_counter()
    recs = {}
    for arch, shape in dryrun.all_cell_ids():
        recs[(arch, shape)] = r = dryrun.run_cell(arch, shape, device_bytes=total, save=False)
        if r["status"] == "skipped":
            if shape not in dict(get(arch).skipped_shapes):
                fail(f"[dryrun] {arch} x {shape} skipped, not one of its skipped_shapes")
            log(f"[dryrun] {arch} x {shape}: skipped ({r['reason']})")
            continue
        if r["status"] != "ok":
            fail(f"[dryrun] {arch} x {shape}: {r.get('error')}\n{r.get('traceback', '')}")
        roof = r["roofline"]
        log(f"[dryrun] {arch} x {shape} ({r['kind']}): peak {r['memory']['peak_bytes'] / 1e9:.3f} "
            f"GB (arguments {r['memory']['argument_bytes'] / 1e9:.3f} GB; fit of depths "
            f"{r['extrapolated']['peak_bytes'] / 1e9:.3f}), fits {r['fits']}; FLOPs "
            f"{roof['flops_per_chip']:.6g}, model FLOPs {roof['model_flops']:.6g}; bytes "
            f"{roof['hbm_bytes_per_chip']:.6g}; t_compute {roof['t_compute_s'] * 1e3:.4f} ms, "
            f"t_memory {roof['t_memory_s'] * 1e3:.4f} ms -> {roof['bottleneck']}; priced in "
            f"{r['record_s']:.2f} + {r['measure_s']:.2f} s")
    n = {k: sum(r["status"] == k for r in recs.values()) for k in ("ok", "skipped", "error")}
    log(f"[dryrun] {n['ok']} ok, {n['skipped']} skipped, {n['error']} failed; "
        f"{sum(r['fits'] for r in recs.values() if r['status'] == 'ok')} cells fit "
        f"{total / 1e9:.3f} GB ({smi}); priced in {time.perf_counter() - t_start:.2f} s")

    # ---- the cells the card can hold, run once each on the card ------------
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, shape in DRYRUN_CARD_CELLS:
        r = recs[(arch, shape)]
        if not r["fits"]:
            fail(f"[dryrun] {arch} x {shape} is priced at {r['memory']['peak_bytes'] / 1e9:.3f} "
                 f"GB, over the card's {total / 1e9:.3f}")
        entry = get(arch)
        cell = shapes.build_cell(entry, shape)
        cfg, opt_cfg = entry.config, dryrun._opt_cfg_for(entry.config)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = card_args(cell, cfg, opt_cfg, dev=torch.device("cuda"))
        if args[0].kernels.name != "cuda":
            fail(f"[dryrun] {arch} on the card chose kernels {args[0].kernels.name!r}")
        fn = cell.fn(cfg, opt_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t1 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        counts = {k: v for k, v in cuda.launch_counts().items() if v}
        value = res[1]["loss"] if cell.kind == "train" else res
        if not torch.isfinite(value).all():
            fail(f"[dryrun] {arch} x {shape}: non-finite output on the card")
        priced = r["memory"]["peak_bytes"]
        ratio = peak / priced
        held = peak >= DRYRUN_HELD_BYTES
        log(f"[dryrun] card {arch} x {shape}: max_memory_allocated {peak / 1e9:.4f} GB, priced "
            f"{priced / 1e9:.4f} GB (measured / priced {ratio:.4f}"
            f"{'' if held else ', under 256 MB: printed only'}); priced FLOPs "
            f"{r['roofline']['flops_per_chip']:.6g}, model FLOPs "
            f"{r['roofline']['model_flops']:.6g}; one call {ms:.3f} ms (first call); "
            f"launches {counts}")
        if held and not DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1]:
            fail(f"[dryrun] {arch} x {shape}: measured / priced peak {ratio:.4f} outside "
                 f"{DRYRUN_BAND}")
        del args, res, value
    torch.cuda.empty_cache()
    log(f"[dryrun] card runs {time.perf_counter() - t0:.2f} s")


def main() -> None:
    name, smi = phase_device()
    from repro_torch.api import GraphSession
    from repro_torch.graphstore import generators
    from repro_torch.graphstore.partition import PartitionedGraph
    from repro_torch.kernels import cuda

    phase_build()
    dev = torch.device("cuda")

    # ---- the graph (set-up: made on the host from the seed) ----------------
    t0 = time.perf_counter()
    g = generators.rmat(PATENTS["n_nodes"], PATENTS["n_edges"], PATENTS["n_labels"],
                        seed=PATENTS["seed"])
    pg = PartitionedGraph.build(g, 1)
    src = np.repeat(np.arange(g.n_nodes, dtype=np.int64), np.diff(g.indptr))
    edge_keys = src * g.n_nodes + g.indices  # sorted: CSR rows, sorted columns
    del src
    queries = make_queries(g, 8, seed=0)
    log(f"[graph] patents-shaped R-MAT: {g.n_nodes} nodes, {g.n_edges} directed edges, "
        f"{g.n_labels} labels, max degree {g.max_degree()}, partition "
        f"{pg.memory_bytes() / 1e6:.1f} MB, built in {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: the main path, CUDA kernels ------------------------------
    session = GraphSession.open(pg)
    if session.kernels.name != "cuda":
        fail(f"GraphSession.open(g) on the card chose {session.kernels.name!r}")
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    rows_cuda, stream_cuda, report = run_queries(session, queries, queries[0])
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    for line in report:
        log(f"[main] {line}")
    log(f"[main] max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
        f"launches { {k: counts[k] for k in MATCHER_KERNELS} } (stwig_expand and "
        f"bitset_build once a round each, the latter for all the round's columns; [ops] "
        f"counts the columns)")
    for sym in MATCHER_KERNELS:
        if counts[sym] <= 0:
            fail(f"kernel {sym} was never launched on the main path")
    if not any(len(r) for r in rows_cuda):
        fail("every main-path query returned 0 rows")
    for q, rows in zip(queries, rows_cuda):
        embedding_check(g, edge_keys, q, rows)
    embedding_check(g, edge_keys, queries[0], np.concatenate(stream_cuda) if stream_cuda
                    else np.zeros((0, queries[0].n_nodes), np.int64))
    log(f"[main] every row of {len(queries)} queries + stream is a valid embedding")
    direct_entry_points(session, queries, rows_cuda, stream_cuda, "main")
    for line in repeat_times(session, queries):
        log(f"[main] {line}")
    # where a repeat's time goes: the query with the most edges, traced once
    i = max(range(len(queries)), key=lambda j: len(queries[j].edges))
    compiled = session.compile(queries[i], max_matches=1024)
    log(f"[main] q{i} repeat traced: "
        f"{profile_line(device_profile(lambda: compiled.run(adaptive=False), reps=1))}")

    # every match of each query, for [sharded]: (query, row set, complete);
    # then smaller queries until four have a complete local result
    local_full = []
    for q in queries:
        res = session.compile(q, max_matches=0).run(adaptive=False)
        local_full.append((q, set(map(tuple, res.rows.tolist())), res.complete))
    local_full += complete_queries(session, g)

    # ---- phase 4: the plain versions on the card, same rows ----------------
    recorder = recording_kernels()
    session.set_kernels(recorder)
    rows_torch, stream_torch, report = run_queries(session, queries, queries[0])
    for line in report:
        log(f"[torch] {line}")
    for i, (a, b) in enumerate(zip(rows_cuda, rows_torch)):
        if a.shape != b.shape or not (a == b).all():
            fail(f"q{i}: rows differ between kernels='cuda' and kernels='torch'")
    if len(stream_cuda) != len(stream_torch) or not all(
        (a.shape == b.shape) and (a == b).all() for a, b in zip(stream_cuda, stream_torch)
    ):
        fail("stream pages differ between kernels='cuda' and kernels='torch'")
    log("[torch] rows and stream pages identical to kernels='cuda'")

    # ---- [serve]: the continuous-batching server on the same session -------
    phase_serve(session, g, edge_keys)

    # ---- phase 5: each kernel against its plain version --------------------
    kernel_rows = phase_kernels(recorder, counts, dev)

    # ---- phase 6: bitset_unpack and candidate_filter on the main path's data
    kernel_rows += phase_ops(recorder)
    probe_call = recorder.calls["hash_join_probe"]  # phase 10's inputs
    del session, recorder
    torch.cuda.empty_cache()

    # ---- [sharded]: the paper's engine, its 16 shards stacked on the card ---
    sharded = phase_sharded(g, edge_keys, queries, local_full)

    # ---- [ranks]: the paper's engine with one shard a process, on the card -
    phase_ranks(g, edge_keys, queries, sharded)
    del sharded

    # ---- phase 7: a small graph, CPU vs card -------------------------------
    small = generators.rmat(2000, 8000, 24, seed=0)
    s_cpu = GraphSession.open(small, device="cpu")
    s_gpu = GraphSession.open(small)
    n_rows = 0
    for q in make_queries(small, 6, seed=1):
        a = s_cpu.run(q, max_matches=0).rows
        b = s_gpu.run(q, max_matches=0).rows
        if a.shape != b.shape or not (a == b).all():
            fail("the 2,000-node graph gives other rows on the CPU and on the card")
        n_rows += len(a)
    log(f"[small] 2,000-node graph: 6 queries, {n_rows} rows, identical on CPU and card")
    log(f"[small] {sharded_small(small, make_queries(small, 6, seed=1), SMALL_SHARDED_CAPS)}")

    # ---- [chaos]: seeded faults on the small graph's 4 shards and engine --
    phase_chaos(small, make_queries(small, 6, seed=1), SMALL_SHARDED_CAPS)

    # ---- [ranks-small]: 4 ranks on the card and 4 on the CPU, small graph ---
    rank_probes = phase_ranks_small(small, make_queries(small, 6, seed=1), SMALL_SHARDED_CAPS)
    del g, pg, edge_keys, s_cpu, s_gpu
    torch.cuda.empty_cache()

    # ---- phase 8: xDeepFM serving at its published widths -------------------
    kernel_rows += phase_recsys(dev, smi)
    torch.cuda.empty_cache()

    # ---- phase 9: GNN inference on an ogbn-products-shaped graph ------------
    rows, mb_host = phase_gnn(dev)
    kernel_rows += rows

    # ---- phase 10: the join probe's two kernels on the query path's join ----
    kernel_rows += phase_probe(dev, probe_call)
    torch.cuda.empty_cache()

    # ---- phase 11: gemma-2b prefill and decode at its published widths ------
    kernel_rows += phase_lm(dev, smi)

    # ---- [tp]: gemma-2b on a (data=2, model=2) mesh of 4 gloo ranks ---------
    phase_tp(dev, smi)
    torch.cuda.empty_cache()

    # ---- phase 12: deepseek-v3 and mixtral-8x22b, published widths, cut depth
    phase_moe_mla(dev)
    torch.cuda.empty_cache()

    # ---- phase 13: training -- gemma-2b at full width, xDeepFM, GatedGCN ---
    phase_train(dev, mb_host, smi)
    del mb_host
    torch.cuda.empty_cache()

    # ---- [examples]: each examples/torch_*.py at its default size ----------
    phase_examples()
    torch.cuda.empty_cache()

    # ---- [dryrun]: every cell priced on meta; the cells the card holds run -
    phase_dryrun(smi)
    torch.cuda.empty_cache()

    # ---- [dryrun-mesh]: the dense-LM serving cells on the pod meshes -------
    phase_dryrun_mesh(smi)

    # ---- [analysis]: the static analyzer's five passes on the card, last, so
    # the main path's first calls are as cold as before it was added ---------
    phase_analysis(smi, rank_probes)
    if sorted(r["name"] for r in kernel_rows) != sorted(KERNEL_INFO):
        fail(f"the kernel line has {[r['name'] for r in kernel_rows]}, not {list(KERNEL_INFO)}")

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
