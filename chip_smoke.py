#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (predictionio_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N]

Needs one NVIDIA Hopper card, PyTorch built for CUDA, and nvcc (on PATH
or under /usr/local/cuda/bin): the kernels are compiled from
predictionio_tpu_torch/csrc at first use into build/torch_kernels/.
Exits non-zero, printing no result, when CUDA is absent, when the port
cannot be imported, or when any phase fails.  Phases, in order:

1. device  — the card's name and power limit, and the kernel builds
   (every csrc/*.cu compiled by its own nvcc, all started together).
2. kernel  — the fused top-k kernel (K3) against its plain PyTorch
   version on the card (float32, TF32 off) over a grid of N, B, k, D
   and n_valid and both score passes' edges (the tiled route's
   crossover at D 10, 63/65/128 queries, k at a tiled block's limit,
   n_valid inside a tile, exact ties), then CUDA-event timings at B 1,
   8 and 64 of kernel, the small-B route (the parent's design), plain
   version, one library call as a yardstick, and the least time the
   card could take (bound); ptxas's report of the tiled kernels.
3. kernel  — the training kernels, fused gram (K1), the ridge solve (K2:
   Cholesky with the system in registers to rank 64, the shared-memory
   LU above) and Gauss-Jordan solve (K4: in registers to rank 64, one
   thread a system to rank 12, in shared memory above), against their
   plain versions and a float64 solve over a grid of shapes (K2 with
   exactly symmetric A; K4 at every design edge, the design the library
   reports checked, and on non-symmetric, diagonally dominant A), then
   timed as in phase 2 at representative shapes, K2 beside the
   shared-memory LU kernel it replaced.
4. serve   — the ALS recommendation template at the MovieLens-25M shape
   (162,541 users x 59,047 items, rank 64, seeded random factors) carried
   in with wrapper_from_numpy, persisted, deployed on an EngineServer
   with PIO_RETRIEVAL_RUNG=chunked, asked 16 /queries.json over HTTP and
   one 64-user query_batch; every answer is held against the plain top-k
   on the card, and the fused top-k kernel must have launched.
5. catalog — a 4,194,304-item corpus with no rung forced: the router's
   own thresholds must pick the chunked rung; 8 queries, checked as in 4.
6. train   — ALS training at the MovieLens-25M shape (25,000,000 seeded
   ratings, rank 64, reg 0.01, 10 iterations, solver "auto"): the prep
   both ways, the default (device_prep "auto", which must bucket on the
   card) and the host route (device_prep False), each with its time and
   peak device memory, the factor init's share, and both layouts held
   equal as canonical COO (each side's (entity, other id, value) in slot
   order, stably sorted by entity); the dead rows (index -1) of the
   chunks, now and as they were before the last row chunk of a plain
   bucket was trimmed, ms per iteration, ratings/s, final RMSE, and the
   K1/K2 launches of the run from the card's prep; the same 10
   iterations from the host prep must agree with it; one iteration from
   the same init with the plain versions
   must agree with the kernels' iteration; a solver="gj" iteration must
   launch K4; then each training kernel timed over the calls that the
   first iteration made (their own arguments, kept as the run made
   them) against its plain version, its library yardstick and its
   bound, K2 also beside the shared-memory LU kernel.
7. dase    — seeded rate/buy events in the port's in-memory event store
   → run_train with the template's engine.json at rank 64 → the
   COMPLETED instance deployed on an EngineServer → 16 /queries.json,
   each held against the plain top-k of the trained factors; run_train
   must have bucketed on the card (two plans); K1, K2 and K3 must have
   launched.  Then serve-time fold-in: rate/buy events of
   two unseen users go into the store, and each user's /queries.json
   must equal the plain top-k of the port's fold_in vector over the
   served item factors (K3 launched for them); a repeat query counts
   "cached" and a user with no events gets [].
8. kernel  — the PQ scan kernel (K5) against its plain version over a
   grid of B, S (tables), N, k and n_valid and the edges of its plan
   (16-byte, 4-byte and byte code loads, blocks of one and of several
   queries, n_valid tails, k at the plan's limit), then timed at N =
   1,048,576, S = 17, k = 40 (B = 1 and 64) beside its plain version, a
   library yardstick (torch.topk over the decoded corpus) and its bound,
   its time split into the score and merge passes (torch.profiler).
9. kernel  — the gather experiments' kernels, T1 (gather + weighted
   Gram) and T2 (gather + sum), against their plain versions at the
   tools' shape, timed likewise, T2 also under four index distributions
   beside the warp design it replaced (bitwise equal), then driven
   through the tools' own entry points (exp_gram, exp_gather2), which
   must launch them.
10. pq     — a 1,048,576-item catalog (rank 64): an IVF index
   (PIO_IVF=on) and PQ codes on top of it (the default policy: M = 16)
   built as ALSAlgorithm.train builds them, persisted, deployed; 16
   /queries.json and a 64-user query_batch under
   PIO_RETRIEVAL_RUNG=pq_flat (K5 once per request), a 64-user
   query_batch under auto routing (ivf_pq), every answer held against the
   port's host search over the same structures.
11. dase+pq — phase 7's events trained again with PIO_PQ_MIN_ITEMS=5000,
   so the template's own policy builds PQ codes and the quality and
   recall scorecards (a pq_flat baseline); deployed with every request
   quality- and recall-sampled (PIO_QUALITY_SAMPLE=1,
   PIO_RECALL_SAMPLE=1); 256 /queries.json on the device pq_flat rung,
   each held against the host PQ search of the trained factors; K1, K2
   and K5 must have launched; /quality.json's live pq_flat recall@10,
   re-ranked exactly off the serving path, within PIO_RECALL_TOLERANCE
   (0.05) of the baseline on both windows, at least 50 captures scored,
   drift not tripped and gate.rollback false.
12. cli loop — the engine.json loop across processes at the MovieLens-1M
   shape (1,000,209 seeded rate events, 6,040 users x 3,706 Zipf items,
   half stars, and buys by 5 % of the users) on the default sqlite +
   localfs storage of a fresh PIO_HOME: JSONL → `pio app new` and `pio
   import` as subprocesses; `pio train` (the examples' engine.json with
   the port's engineFactory, rank 64, 10 iterations) in-process through
   the CLI's main, its factors held by entity id against run_train on
   the same events in a MEMORY store; `pio deploy` as a subprocess,
   which must report a CUDA device and answer 64 /queries.json each
   equal to the plain top-k of the persisted factors; 24 events of two
   unseen users imported by another process and folded in, then a
   second deploy answering one of them from the shared KV
   (pio_fold_in_total{result="shared"} 1); both stopped by POST /stop
   with exit 0; `pio batchpredict` and `pio eval` (two candidates)
   in-process; K1, K2 and K3 must launch (the chunked rung is forced:
   the router would answer 3,706 items on the host).
13. templates — the three templates that read entity state through
   aggregate_properties, each trained by `pio train` in-process from its
   shipped examples/<t>/engine.json with the port's engineFactory, on the
   default sqlite + localfs storage of a fresh PIO_HOME, at phase 12's
   shape, the events written in-process through insert_columnar:
   13a similarproduct: 1,001,719 views, a $set of 1-3 of the 18
   MovieLens-1M genres on every item, an $unset of 5 items' genres and a
   $delete of 5 items; K1 and K2 must launch; the item factors held by
   entity id against run_train on the same rows in a MEMORY store, whose
   aggregate_properties must equal the sqlite store's; the COMPLETED
   instance on an EngineServer, 64 /queries.json (1-3 items, a third with
   categories, some with a whiteList or blackList) under the router's
   choice (host) and on the chunked rung, each held against the plain
   masked top-k of the persisted normalised factors; 8 views each of two
   unseen items, each folded query equal to the plain top-k of the
   normalised fold_in vector, pio_fold_in_items_total solved 2 then
   cached 1.  13b ecommerce: the same events as view/buy (buys by 5 % of
   the users), the genres, two unavailable lists at distinct times; K1
   and K2 must launch; `pio deploy` as a subprocess, on the card; 64
   /queries.json of known users with mixed filters and 4 of unknown
   ones, each held against the plain answer (persisted factors; the
   newest 512 seen items and the latest list from the phase's own
   events; view counts for the unknown); a newer list written by another
   process (`pio import`) must be excluded without a redeploy, the
   result cache on and holding none of its answers; POST /stop exits 0.  13c classification: 100,000 users' $set of attr0..attr2
   and a 4-class plan, 40 plans $unset later; `pio train` naive (the
   shipped engine.json) and lr (maxIter 200), 64 /queries.json each
   equal to the plain numpy prediction of the persisted model (where its
   top two differ by more than NEAR_TIE); `pio eval` (3 candidates,
   evalK 3), its accuracy equal to a plain float64 recount.  Each part
   logs its writes, train wall and read, launches and client p50.
14. eventserver — the event server on phase 12's first 300,000 events
   (cut from all 1,000,209 for the time limit) and storage:
   `pio app new` and `pio eventserver --port 0` as subprocesses (/ready
   must answer ready); every one of them posted by the port's
   sdk.EventClient as POST /batch/events.json at the reference's cap of
   50, eight client threads each with a contiguous share, each batch
   under a client token (events/s, client p50 and p99 a batch, the
   server's /stats.json); three batches posted again under their tokens
   must add no row and answer the same ids; `pio export` must equal the
   generated events exactly as a multiset of (event, entity, target,
   rating, eventTime); `pio train` in-process (K1 and K2 must launch);
   `pio deploy` as a subprocess on the forced chunked rung, which must
   report a CUDA device and answer 64 /queries.json each equal to the
   plain top-k of the persisted factors (K3 must launch, counted in the
   deploy process); SIGTERM must drain the event server with exit 0.
15. scheduler — phase 4's ML-25M serving model persisted on the default
   sqlite + localfs storage and deployed on an EngineServer with the
   default SchedulerConfig (batcher and autotuner on, depth 128, max
   batch 64) under PIO_RETRIEVAL_RUNG=chunked, warmed by one query: 64
   client threads in 4 client processes each post 32 /queries.json for
   distinct users over keep-alive HTTP, each
   answer held against the plain top-k on the card; the batcher must
   count fewer dispatches than requests and K3 must launch once a
   dispatch (recs/s, client p50/p99, server p50, mean and largest
   cohort, the autotuner's window); the same 2,048 queries again must be
   byte-equal result-cache hits with no K3 launch; 256 of them through
   the inline path (batcher off) one K3 launch each; `pio deploy
   --native` as a subprocess on the same stored instance, on the card,
   answering 256 of them as the Python path did (K3 counted there), POST
   /stop exit 0; `pio eventserver --native` taking phase 12's first
   100,000 events through the SDK, `pio export` equal to them as a
   multiset, SIGTERM exit 0; within 120 s.  The quality and recall
   monitors run at their shipped rates (0.1, 0.05) throughout; the
   coalesced drive's waterfall (pio_serve_stage_ms, p50/p99/mean a
   stage) names the stage with the largest p99, and the same drive on a
   fresh server with PIO_QUALITY=off and PIO_RECALL=off, then on another
   with them on again, gives the monitors' cost in recs/s and p99.
   Phases 7 and 13a count a repeat query as a result-cache hit and reach
   the fold-in cache with another num; 13b deploys with the result cache
   on, which keeps no ecommerce answer (F7: its algorithm reads live
   state).
16. refresh — phase 12's sqlite + localfs store (kept alive for this
   phase) and its generation 1: `pio deploy` as a subprocess answers 64
   /queries.json (the baseline); 20,000 rate events stamped after the
   watermark (2 % of the corpus; 200 new users, 100 new items); one
   RefreshDaemon cycle with an HttpPromoter on that server must train
   warm and promote through POST /reload (generation 2; every row no
   delta event touched bitwise generation 1's; the 64 answers and 64 of
   new users each the plain top-k of the warm factors;
   pio_refresh_staleness_s 0); a candidate with a NaN row must get 409
   and change nothing; POST /admin/rollback restores generation 1 (the
   64 answers equal the baseline, all result-cache hits) and a second
   one generation 2; a second warm generation promoted by POST /reload
   while 16 client threads query: every answer 200 and the plain top-k
   of one generation or the other; a delta over
   PIO_REFRESH_MAX_DELTA_FRACTION must fall back to a full retrain in
   one instance, launching K1 and K2; on an in-process server the bytes
   an eviction frees (torch.cuda.memory_allocated) must cover the
   evicted generation's staged corpus.  Times: warm vs full train, the
   /reload and rollback walls, client p50/p99 under load.
17. twotower — the two-tower engine.  17a: two_tower.train at bench.py's
   shape (200,000 users x 100,000 items, embed 64, hidden [128], out 64,
   batch 1,024; 800,000 seeded interaction rows, 1 epoch) from numpy
   and from the native feeder, at K=1 and K=8 (one init outside the
   walls): examples/s, the pipeline probe's device_wait / h2d /
   host_wait / dispatch shares, peak device memory; each K=8 state
   equal to its K=1 state bit for bit; a NaN batch must raise
   TrainDiverged with no checkpoint directory.  17b: `pio train
   --fuse-steps 8` in-process with the port's shipped twotower
   engine.json (appName set, eventNames rate and buy; 2 epochs of its
   10, for time) on phase 12's store; `pio deploy` as a
   subprocess on the card (chunked rung, PIO_SERVE_HOST_MACS=0, result
   cache off) answering 64 /queries.json, each held against the plain
   top-k of the persisted vectors; two_tower.retrieve(chunk=) (K3)
   against the plain top-k of encode_users/encode_items.  17c: 20,000
   rate events after the watermark (phase 16's delta shape: 200 new
   users, 100 new items), run_train(warm_from=) must come out warm past
   the template's loss gate; POST /reload to it; 64 answers (32 of new
   users) held against the plain top-k of the warm vectors; K3 counted
   in the deploy process.
18. dlrm — the DLRM engine, whose path runs no kernel of the port (the
   reference computes it without Pallas).  18a: dlrm.train at bench.py's
   DLRM shape (8 fields x 100,000 rows, 13 dense features, embed 32,
   bottom [64, 32], top [128, 64], batch 8,192; 800,000 seeded rows at a
   25 % click rate, 1 epoch) from numpy and from the native feeder, at
   K=1 and K=8 (one init outside the walls): examples/s, the probe's
   shares, peak device memory; each K=8 state equal to its K=1 state bit
   for bit; a NaN batch must raise TrainDiverged.  18b: phase 12's
   1,000,209 (user, item) rate pairs written in-process as impressions
   of a planted click model (hidden user and item factors and 4 dense
   features, about 25 % clicks) into a new app of phase 12's store; `pio
   train` in-process with the port's shipped dlrm engine.json; a
   held-out log-loss below the constant-CTR predictor's; `pio deploy` as
   a subprocess on the card answering 64 /queries.json of 50 candidates
   (some of unseen users and items), each answer's order and scores
   held against dlrm.predict_proba of the persisted state.  18c: 20,000
   impressions after the watermark (phase 16's delta shape),
   run_train(warm_from=) must come out warm past the template's
   log-loss gate; POST /reload to it; 64 answers (32 of new users) held
   against the warm state.
19. supervision — checkpoints, the profiler and traces, each part run
   where its inputs live.  19a, right after phase 6 on its inputs: the
   same ML-25M train under sweep checkpoints every 2 sweeps (about 54
   MiB a save), uninterrupted, preempted after its second chunk
   (TrainPreempted at sweep 4 with the step file on disk) then resumed,
   and with one chunk's factors made NaN (rolled back, replayed); each
   torch.equal to phase 6's factors, K1 and K2 launched.  19b-e, right
   after phase 12 on its store (so phase 12's own eval is the
   uninterrupted sweep): `pio train --checkpoint-dir D
   --checkpoint-every 2` with a SIGTERM during the read must exit 143
   with a PREEMPTED instance and the step-2 file, the same command then
   exit 0 with factors equal to an uninterrupted `pio train`'s by
   entity id bit for bit;
   `pio eval --checkpoint-dir` SIGTERM'd after its first (candidate,
   fold) unit must exit 143, the same command train only the other 3
   units and score phase 12's eval exactly; one run_train under
   PIO_PROFILE_DIR, whose Chrome trace must name K1's and K2's CUDA
   functions; `pio deploy --no-batcher`, whose /traces.json?request_id=
   must resolve a query's tree http.request > http.handle >
   batcher.dispatch > retrieval (chunked rung; K3 counted in the deploy
   process).
20. obs — the serving waterfall, the SLO engine behind /ready and the
   quality monitors' canary gate, on phase 12's store after phases
   16-18 (its newest generation), an EngineServer and an EventServer in
   this process on the chunked rung, result cache off, every query
   quality-sampled.  20a: 256 /queries.json from 8 threads with
   PIO_REQUEST_LOG set, each the plain top-k; every wide event carries
   the dispatch path's stages, its serverMs equal to X-PIO-Server-Ms;
   the p50 of attestedSumMs / serverMs in [0.9, 1.1] (the reference's
   bound); a dispatch bucket's exemplar on /metrics?exemplars=1 (none on
   the plain view) resolves through /traces.json?request_id= to one
   http.request tree; p50 and p99 of each stage.  20b: a server with
   PIO_SLO_LATENCY_TARGET_MS=0.5, 2/4 s burn windows and a 1 s recovery:
   /ready 200, then 503 degraded (sustained_burn) after 24 dispatched
   queries, 200 again after the dwell once the same queries are cache
   hits; with PIO_READY_SLO=off /ready stays 200 while /stats.json's slo
   reads degraded.  20c: every 200 of 20a carries X-PIO-Serve-Id; 64
   buys echoing them (properties.pioServeId) through the event server,
   40 on a served item: /quality.json's generation-1 hit rate exactly
   40/64.  20d: a RefreshDaemon cycle retrains on the same store and
   promotes through POST /reload across a 3 s canary window of traffic;
   the shadow scorer re-predicts on the retained generation (one K3
   launch each, counted), overlap at least PIO_SHADOW_MIN_OVERLAP, no
   rollback; then a fresh server deploys that generation, a second
   cycle's candidate is loaded with its user vectors scaled 4x (the
   reference's own fault: ranking and corpus fingerprint intact), drift
   trips, gate.rollback, the daemon posts /admin/rollback, generation 1
   serves again and its answers are the plain top-k.  Budget 45 s.
21. fleet — the fleet plane, after phase 20 on phases 15's and 12's
   stores.  Four `pio deploy` processes serve phase 15's ML-25M model
   (G1; chunked rung, result cache off, every query quality-sampled),
   two serve phase 12's newest ALS generation; all six start together.
   21a: a second ML-25M generation G2 (G1 plus a little noise, with its
   quality scorecard) persisted, then `pio rollout --waves 1,50%,100%
   --bake-s 2` to it while 16 client threads query all four: exit 0,
   the journal's waves 1, 2, 4, the instances taking G2 in that order,
   every answer 200 and the plain top-10 of G1 or G2, then 64 answers
   an instance G2's.  21b: G3 = G2's user vectors x4 carrying G2's
   scorecard (phase 20d's fault): the rollout halts at the canary on
   the merged quality gate, rolls U1 back, U2-U4 read G2 at every poll,
   all four then serve G2.  21c: a `pio rollout` SIGTERM'd in its
   second wave's bake; a plain rollout refused (exit 1, the reference's
   message); --resume finishes it; a second SIGTERM'd one --unwind'd,
   its instances back on the previous generation.  21d (beside 21a-c):
   `pio train --follow --promote-url U5,U6` on phase 12's store: a
   20,000-event delta trains warm (host solves) and rolls across both,
   which then serve the warm factors' plain top-10; a delta over
   PIO_REFRESH_MAX_DELTA_FRACTION falls back to a full retrain (K1, K2)
   rolled across both; pio_refresh_staleness_s from the older served
   watermark.  21e: `pio dashboard --fleet`: /fleet.json's counters the
   four instances' sums, buckets added, gauges by instance; a stopped
   instance stale and still counted; `pio status --fleet` and
   `--metrics-url`.  21f: an AdminServer beside an in-process
   EngineServer: POST /admin/profile 200 then 409, its artifact and
   `pio profile --url --out`'s, each Chrome trace naming K3's
   functions; the app routes as `pio app list` sees them.  Budget 90 s.
22. remote — the storage server, after phase 21 on phase 12's store:
   `pio storageserver` (a secret, a free port) hosts it in a process of
   its own.  22a: `pio template get recommendation` scaffolds the
   engine.json (the port's engineFactory; appName and rank 64 set),
   phase 12's first 200,000 events go into an app of their own (cut for
   the time limit; in that app sqlite's entity-index read and the wire's
   event-time read give the same order), and `pio train` runs twice in
   this process: on sqlite, then with METADATA, EVENTDATA and MODELDATA
   on `type=pioserver`; K1 and K2 must launch in the second, and its
   factors must be torch.equal to the first's by entity id; both walls,
   both reads and the wire's events/s.  22b: `pio deploy` on pioserver
   as a subprocess (result cache off) answering 64 /queries.json, each
   the plain top-k of the persisted factors (K3 counted in the deploy
   process).  22c: the storage server killed: 8 answers 200 and
   unchanged, POST /reload 503 until the modeldata breaker opens (2
   failures), then 503 shed by the open breaker with Retry-After; the
   storage server restarted on the same port: after the 3 s recovery
   /reload 200 and the 8 answers unchanged.  22d: `pio status` prints
   type=pioserver for each repository.  22e: `entry()`'s two-tower
   forward on the card within rtol = atol = 1e-5 of the CPU's.  Budget
   60 s.
23. mesh — the device mesh (`predictionio_tpu_torch/parallel`) on the
   one card, after phase 22.  23a: `sharded_top_k` on 4 shards of the
   card (`devices=[cuda:0] * 4`), K3 on every shard, at N 59,047 (the
   tail padded) and 4,194,304, D 64, B 1 and 64, k 10: 4 K3 launches a
   call, each answer the meshless K3's and the plain top-k's (rtol =
   atol = 1e-5, ids equal except within a tie), the sharded call timed
   beside the meshless K3 and the plain version.  23b: phase 6's ML-25M
   ratings on `data=4`, rank 64, 10 iterations, factors row-sharded
   (`factor_sharding="sharded"`, `gather_window=True`): prep and train
   walls, K1 and K2 launched, the factors within phase 6's tolerance of
   phase 6's meshless factors, a second train torch.equal to the first.
   23c: phase 12's store as phase 12 trained it (copied then): `pio
   train --mesh data=1` and `pio deploy --mesh data=1` as subprocesses,
   each in an NCCL world of one (PIO_COORDINATOR_ADDRESS on loopback,
   PIO_NUM_PROCESSES=1), the corpus sharded (PIO_SERVE_SHARD_ABOVE=0)
   and routed by the default plan: phase 12's 64 queries, each the
   plain top-k of the mesh train's factors and phase 12's meshless
   answer within the training tolerance (ids equal except within a tie
   of that size); every retrieval on the `sharded` rung; K1, K2 and K3
   counted in the subprocesses.  Budget 90 s.
24. report — one JSON line of per-kernel numbers, the card's name and
   power limit, and the final status line.
After phases 7, 11-14, 16, 17, 19b-e and 20 a line gives the seconds the
quality and recall scorecards took in that phase's in-process trains.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

RTOL = 1e-5   # float32 sums in another order than the plain matmul
ATOL = 1e-5
GRAM_RTOL = 1e-5   # K1: the same float32 products summed in another order;
GRAM_SIGMAS = 5.0  # atol: this many standard deviations of a float32 sum
                   # of L terms, 5·√L·2^-24·Σ|terms| (the kernel adds its
                   # L slots one after another)
SOLVE_RTOL = 1e-4  # K2/K4: the same float32 elimination, FMAs contracted
SOLVE_ATOL = 1e-5  # differently; atol times max |x|
# One ALS iteration, kernels vs plain versions at the full shape: float32
# Gram sums of up to 4,096 terms per partial row and segment sums by
# atomics, in another order, then solved and carried into the item side.
TRAIN_RTOL = 1e-3
TRAIN_ATOL = 1e-3
RANK = 64
ML25M_USERS, ML25M_ITEMS = 162_541, 59_047
ML25M_RATINGS = 25_000_000
TRAIN_ITERS = 10
BIG_ITEMS = 4_194_304
DASE_EVENTS, DASE_USERS, DASE_ITEMS = 300_000, 20_000, 10_000
# Phase 3 grids: K1 over R x L x K, K2/K4 over B x K; then the timed shapes.
# K1's R, L and K edges up to rank 128 (its symmetric-tile kernel): R below
# a block's rows, L around the pipeline step (16 or 32 slots), ranks whose
# rows are no multiple of 16 bytes and both register-tile widths; rows
# whose every slot is padding must give exactly 0.
GRAM_ROWS, GRAM_LENS = (1, 3, 8, 13, 4096), (1, 8, 17, 33, 64, 1000, 4096)
GRAM_RANKS = (10, 17, 63, 64, 65, 100, 127, 128)
# R large enough that a block holds several rows, its last block partial
GRAM_MULTI_ROW = ((10_001, 9, 3), (11_111, 17, 10), (4501, 20, 33),
                  (2001, 33, 64), (601, 50, 100), (3001, 40, 128))
# Phase 9: T1 (K1's kernels without b) over the same edges
T1_GRID = [(r, l, k) for r in (1, 3, 13) for l in (1, 17, 33, 4096)
           for k in GRAM_RANKS] + list(GRAM_MULTI_ROW)
# K1 above rank 128, where it cuts A into 2 x 2 tiles: (R, L, K)
GRAM_TILED = ((8, 4096, 256), (512, 1000, 256), (4096, 64, 200),
              (8, 1000, 129))
# K4: each design's compiled sizes (one thread a system: KP 4, 8, 12; one
# warp: 32, 64) and the edges between them, rank 10 (every shipped
# engine.json), the shared-memory kernel above 64; B around a 32-system
# tile, a 4-warp block and the TPU kernel's 128-system block.
GJ_BATCHES = (1, 31, 32, 33, 127, 128, 131_072)
GJ_RANKS = (1, 4, 5, 8, 9, 10, 12, 13, 16, 17, 32, 33, 64, 65, 128)
# K2: every compiled size (one thread a system: KP 4, 8, 12, 16; one warp:
# 32, 64), the identity padding below each, the shared-memory LU above
# 64; B around a 32-system tile and a 4-warp block.
LU_BATCHES = (1, 31, 32, 33, 127, 128, 131_072)
LU_RANKS = (1, 2, 10, 16, 17, 32, 33, 63, 64, 65, 100, 128)
EXACT_CHUNK = 16_384        # systems a float64 reference solve takes
# (R, L, K); rank 10 is what every shipped engine.json trains at
GRAM_TIMED = ((4096, 64, 64), (4096, 1000, 64), (4096, 64, 256),
              (4096, 64, 10), (4096, 1000, 10))
SOLVE_TIMED = ((131_072, 64), (131_072, 10))   # K2 and K4 (B, K)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SMEM_BANKS = 32             # 4-byte shared-memory banks per SM, one access
                            # each per clock (CUDA programming guide)
SPIN_CYCLES = 4_000_000     # ~2 ms of device spin: covers any host enqueue
# Phase 8 grid (K5): queries, tables S = 1 + M, items, k (k <= N), plus
# cases with n_valid < N; then the timed shape.
PQ_BATCHES, PQ_TABLES = (1, 3, 8, 64), (1, 5, 17, 33, 65)
PQ_ITEMS_GRID, PQ_KS = (1, 511, 100_003, 1_048_576), (1, 10, 40, 1000, 4000)
PQ_N_VALID = ((8, 17, 100_003, 40, 50_000), (3, 5, 511, 10, 300),
              (64, 65, 1_048_576, 1000, 1_048_576 - 777),
              (1, 1, 100_003, 4000, 4000))        # (B, S, N, k, n_valid)
# The plan's edges (B, S, N, k, n_valid): 16 items a thread a round at
# B 1 (a 16-byte code load a table when N % 16 == 0, byte loads if not),
# 4 at B > 1 (a 4-byte load when N % 4 == 0); B 7/9 around the 8 queries
# a block; n_valid inside a round; k at the plan's limit (16,128).
PQ_EDGES = ((7, 17, 1_048_576, 40, None), (9, 17, 1_048_576, 1000, None),
            (1, 17, 65_540, 40, None), (1, 17, 65_536, 40, 65_535),
            (9, 17, 65_540, 40, 65_539), (7, 17, 65_539, 10, None),
            (8, 5, 4095, 100, 4001), (1, 17, 40_000, 16_128, None),
            (2, 65, 40_000, 16_128, 39_999), (9, 17, 100_003, 16_128, None),
            (1, 1, 1_048_576, 40, None), (9, 1, 100_003, 1000, None),
            (1, 17, 1_048_576, 40, 1_048_576 - 9))
PQ_TIMED = (1_048_576, 17, 40)                     # (N, S, k) at B 1 and 64
PQ_ITEMS = 1_048_576        # phase 10: 5x PIO_PQ_MIN_ITEMS, the 1e6 scale
PQ_USERS = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def die(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(b: int, n: int, d: int, k: int):
    """Least time for the fused top-k: each input read once, each output
    written once, over the memory rate; 2*B*N*D float32 flops over the
    float32 peak.  Returns (ms, 'bytes' | 'operations')."""
    t_bytes = (n * d * 4 + b * d * 4 + b * k * 8) / HBM_BYTES_PER_S
    t_ops = 2.0 * b * n * d / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Bound:
    """Least time the card could take for a sequence of calls: for each
    call the larger of its bytes over the memory rate and its float32
    flops over the float32 peak, summed; ``by`` names the term that
    binds most of the total."""

    def __init__(self):
        self.ms = 0.0
        self.ms_by = {"bytes": 0.0, "operations": 0.0}

    def add(self, n_bytes: float, flops: float) -> "Bound":
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.ms += max(t_bytes, t_ops)
        self.ms_by[by] += max(t_bytes, t_ops)
        return self

    @property
    def by(self) -> str:
        return max(self.ms_by, key=self.ms_by.get)


def gram_cost(r: int, l: int, k: int, n: int, elem: int = 4):
    """K1 on one [R, L] block against an [N, K] factor matrix of
    ``elem``-byte elements: (bytes, flops).  Bytes: the index, weight and
    value reads, one read of the factor matrix, the A and b writes.
    Flops, per slot: K multiplies for w·f, K(K+1) for the symmetric A
    (its upper triangle, the SYRK count) and 2K for b, so
    R·L·(K(K+1) + 3K)."""
    return (r * l * 12 + n * k * elem + r * k * (k + 1) * 4,
            float(r * l * (k * (k + 1) + 3 * k)))


def time_stream(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` back-to-back calls, CUDA events,
    after a warm-up.  Where the host enqueues slower than the card runs,
    this is the host's rate, not the card's."""
    import torch

    for _ in range(3):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def time_single(fn, reps: int, flush=None, *, warmup: int = 3,
                spin: int = SPIN_CYCLES) -> float:
    """Median device ms of single calls, each between its own CUDA
    events.  A spin kernel queued first keeps the card busy while the
    host enqueues the call, so the events see the call's kernels (and
    the gaps between them), not the host's enqueue time; a call made of
    many small launches needs a longer ``spin``.  With ``flush`` (a
    callable that evicts L2) each call starts cold."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(spin)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[len(times) // 2]


def check_against_plain(got_s, got_i, q, items, k, n_valid, what, ft,
                        topk_mismatch) -> float:
    """Hold a [B, k] answer against the plain top-k on the card; returns
    the largest score error."""
    n_real = items.shape[0] if n_valid is None else n_valid
    rs, ri = ft.fused_topk_reference(q, items, min(k + 1, n_real),
                                     n_valid=n_valid)
    next_s = rs[:, k].cpu().numpy() if rs.shape[1] > k else None
    ref_s, ref_i = rs[:, :k].cpu().numpy(), ri[:, :k].cpu().numpy()
    why = topk_mismatch(got_s, got_i, ref_s, ref_i, next_s, rtol=RTOL,
                        atol=ATOL)
    if why is not None:
        die(f"{what}: {why}")
    import numpy as np

    return float(np.max(np.abs(np.asarray(got_s) - ref_s))) \
        if ref_s.size else 0.0


def assert_close(got, want, rtol: float, atol, what: str) -> float:
    """Die unless ``got`` is finite and within ``atol`` (a number or a
    tensor of per-element bounds) + rtol·|want| of ``want``; returns the
    largest absolute error."""
    import torch

    if not bool(torch.isfinite(got).all()):
        die(f"{what}: non-finite values")
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if bool(bad.any()):
        die(f"{what}: max |err| {err:.3g} beyond rtol {rtol} + atol "
            f"(largest {float(torch.as_tensor(atol).max()):.3g})")
    return err


def scaled(rel: float, want) -> float:
    """``rel`` times the largest magnitude of ``want``."""
    return rel * float(want.abs().max()) if want.numel() else 0.0


def exact_solve(a, b, reg):
    """(A + diag(reg)) x = b by ``torch.linalg.solve`` in float64, in
    chunks of EXACT_CHUNK systems; x as float32."""
    import torch

    k = a.shape[-1]
    eye = torch.eye(k, dtype=torch.float64, device=a.device)
    out = torch.empty_like(b)
    for i in range(0, a.shape[0], EXACT_CHUNK):
        sl = slice(i, i + EXACT_CHUNK)
        out[sl] = torch.linalg.solve(
            a[sl].double() + reg[sl].double()[:, None, None] * eye,
            b[sl].double()[..., None])[..., 0].float()
    return out


def gram_atol(l: int, abs_sum):
    """K1's absolute tolerance per entry: GRAM_SIGMAS standard deviations
    of the rounding of a float32 sum of ``l`` terms whose magnitudes sum
    to ``abs_sum``."""
    return GRAM_SIGMAS * math.sqrt(l) * 2.0 ** -24 * abs_sum


def training_kernels_phase(dev, fg, rs, card: str):
    """Phase 3: K1, K2 and K4 against their plain versions over a grid
    of shapes, then timed at representative shapes.  Returns the
    largest error of each kernel."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n_fac = 50_000
    base = torch.randn((n_fac, 256), generator=gen, device=dev)
    err = {"fused_gram": 0.0, "ridge_solve_lu": 0.0, "ridge_solve_gj": 0.0}

    def gram_block(r, l, dead=False):
        idx = torch.randint(0, n_fac, (r, l), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand((r, l), generator=gen, device=dev)
        c = torch.randn((r, l), generator=gen, device=dev)
        # ragged rows: slots past a row's degree carry index 0, w = c = 0;
        # with `dead`, every fifth row is padding throughout
        deg = torch.randint(1, l + 1, (r, 1), generator=gen, device=dev)
        if dead:
            deg[torch.arange(r, device=dev) % 5 == 4] = 0
        tail = torch.arange(l, device=dev)[None, :] >= deg
        idx[tail] = 0
        w[tail] = 0.0
        c[tail] = 0.0
        return idx, w, c

    n_gram = 0
    shapes = [(r, l, k) for k in GRAM_RANKS for r in GRAM_ROWS
              for l in GRAM_LENS] + list(GRAM_MULTI_ROW) + list(GRAM_TILED)
    for r, l, k in shapes:
        fac32 = base[:, :k].contiguous()
        idx, w, c = gram_block(r, l, dead=True)
        dead = w.abs().sum(1) == 0
        for fac in (fac32, fac32.bfloat16()):
            a, b = fg.fused_gram_vector_cuda(fac, idx, w, c)
            torch.cuda.synchronize()
            what = f"fused_gram R={r} L={l} K={k} {fac.dtype}"
            if bool(a[dead].any()) or bool(b[dead].any()):
                die(f"{what}: a row of padding gave a nonzero A or b")
            if k <= 128 and not torch.equal(a, a.mT):
                die(f"{what}: A is not exactly symmetric")
            ra, rb = fg.fused_gram_vector_reference(fac, idx, w, c)
            abs_a, abs_b = fg.fused_gram_vector_reference(
                fac.abs(), idx, w.abs(), c.abs())
            err["fused_gram"] = max(
                err["fused_gram"],
                assert_close(a, ra, GRAM_RTOL, gram_atol(l, abs_a), what),
                assert_close(b, rb, GRAM_RTOL, gram_atol(l, abs_b), what))
            del a, b, ra, rb, abs_a, abs_b
            n_gram += 1
    def spd(bsz, k):
        m = torch.randn((bsz, k, 16), generator=gen, device=dev)
        a = (m @ m.mT) / 16
        del m
        a = (a + a.mT) / 2                  # exactly symmetric
        rhs = torch.randn((bsz, k), generator=gen, device=dev)
        reg = 0.05 * torch.randint(1, 40, (bsz,), generator=gen,
                                   device=dev).float()
        return a, rhs, reg

    n_lu = 0
    err["ridge_solve_lu_f64"] = 0.0
    for k in LU_RANKS:
        for bsz in LU_BATCHES:
            a, rhs, reg = spd(bsz, k)
            x = rs.ridge_solve_cuda(a, rhs, reg, "lu")
            torch.cuda.synchronize()
            what = f"ridge_solve_lu B={bsz} K={k}"
            want = rs.ridge_solve_lu_reference(a, rhs, reg)
            err["ridge_solve_lu"] = max(err["ridge_solve_lu"], assert_close(
                x, want, SOLVE_RTOL, scaled(SOLVE_ATOL, want), what))
            exact = exact_solve(a, rhs, reg)
            err["ridge_solve_lu_f64"] = max(
                err["ridge_solve_lu_f64"], assert_close(
                    x, exact, SOLVE_RTOL, scaled(SOLVE_ATOL, exact),
                    what + " vs float64"))
            n_lu += 1
            del a, rhs, reg, x, want, exact
    def dominant(bsz, k):
        """A non-symmetric, diagonally dominant A, b and reg."""
        a = 0.5 * torch.randn((bsz, k, k), generator=gen, device=dev)
        a.diagonal(dim1=1, dim2=2).add_(float(k))
        rhs = torch.randn((bsz, k), generator=gen, device=dev)
        reg = 0.05 * torch.randint(1, 40, (bsz,), generator=gen,
                                   device=dev).float()
        return a, rhs, reg

    n_gj = 0
    err["ridge_solve_gj_f64"] = 0.0
    for k in GJ_RANKS:
        design = ("gj_thread" if k <= rs.GJ_THREAD_MAX_RANK else
                  "gj_warp" if k <= rs.REG_MAX_RANK else "gj_shared")
        for bsz, make in [(b, spd) for b in GJ_BATCHES] + [(33, dominant)]:
            a, rhs, reg = make(bsz, k)
            before = dict(rs.KERNEL_LAUNCHES)
            x = rs.ridge_solve_cuda(a, rhs, reg, "gj")
            torch.cuda.synchronize()
            what = (f"ridge_solve_gj B={bsz} K={k}"
                    + (" non-symmetric" if make is dominant else ""))
            if rs.KERNEL_LAUNCHES != {**before,
                                      design: before[design] + 1}:
                die(f"{what}: expected one launch of {design}, the library "
                    f"reports {rs.KERNEL_LAUNCHES} after {before}")
            want = rs.ridge_solve_gj_reference(a, rhs, reg)
            err["ridge_solve_gj"] = max(err["ridge_solve_gj"], assert_close(
                x, want, SOLVE_RTOL, scaled(SOLVE_ATOL, want), what))
            exact = exact_solve(a, rhs, reg)
            err["ridge_solve_gj_f64"] = max(
                err["ridge_solve_gj_f64"], assert_close(
                    x, exact, SOLVE_RTOL, scaled(SOLVE_ATOL, exact),
                    what + " vs float64"))
            n_gj += 1
            del a, rhs, reg, x, want, exact
    log(f"phase 3 kernel: fused_gram matches its plain version in "
        f"{n_gram} cases (R in {GRAM_ROWS}, L in {GRAM_LENS}, K in "
        f"{GRAM_RANKS}, and (R, L, K) in {GRAM_MULTI_ROW + GRAM_TILED}; "
        f"float32 and bfloat16 factors, ragged rows, every fifth row all "
        f"padding and exactly 0, A exactly symmetric to K 128), max "
        f"|err| {err['fused_gram']:.3g} (rtol {GRAM_RTOL} + "
        f"{GRAM_SIGMAS}·√L·2^-24·Σ|terms|); ridge_solve lu (K2) matches "
        f"its plain version and a float64 solve in {n_lu} cases (B in "
        f"{LU_BATCHES}, K in {LU_RANKS}, A exactly symmetric), max |err| "
        f"{err['ridge_solve_lu']:.3g} and {err['ridge_solve_lu_f64']:.3g}; "
        f"gj (K4) matches its plain version and a float64 solve in {n_gj} "
        f"cases (B in {GJ_BATCHES}, K in {GJ_RANKS}, and B 33 with a "
        f"non-symmetric, diagonally dominant A; the design the library "
        f"reports is the rank's), max |err| {err['ridge_solve_gj']:.3g} and "
        f"{err['ridge_solve_gj_f64']:.3g} (rtol {SOLVE_RTOL} + "
        f"{SOLVE_ATOL}·max|x|)")

    for r, l, k in GRAM_TIMED:
        fac = base[:, :k].contiguous()
        idx, w, c = gram_block(r, l)
        f = fac.index_select(0, idx.reshape(-1)).reshape(r, l, k)
        fw = f * w[..., None]
        row = {"kernel_ms": time_single(
                   lambda: fg.fused_gram_vector_cuda(fac, idx, w, c), 20),
               "plain_ms": time_single(
                   lambda: fg.fused_gram_vector_reference(fac, idx, w, c),
                   10),
               "library_ms": time_single(lambda: torch.bmm(fw.mT, f), 20)}
        bnd = Bound().add(*gram_cost(r, l, k, n_fac))
        row.update(bound_ms=bnd.ms, bound_by=bnd.by,
                   share_of_bound=bnd.ms / row["kernel_ms"])
        log("phase 3 timing: " + json.dumps(
            {"kernel": "fused_gram", "R": r, "L": l, "K": k, "N": n_fac,
             "library": "torch.bmm(fw^T, f) on the pre-gathered block",
             "card": card, **row}))
        del f, fw
    for bsz, k in SOLVE_TIMED:
        a, rhs, reg = spd(bsz, k)
        a_reg = a + torch.diag_embed(reg[:, None].expand(bsz, k))
        lib = time_single(lambda: torch.cholesky_solve(
            rhs[..., None], torch.linalg.cholesky(a_reg)), 10)
        del a_reg
        for method, plain in (("lu", rs.ridge_solve_lu_reference),
                              ("gj", rs.ridge_solve_gj_reference)):
            bnd = Bound().add(*rs.solve_cost(bsz, k, method))
            row = {"kernel_ms": time_single(
                       lambda: rs.ridge_solve_cuda(a, rhs, reg, method), 10),
                   "plain_ms": time_single(lambda: plain(a, rhs, reg), 3,
                                           warmup=1, spin=20 * SPIN_CYCLES),
                   "library_ms": lib, "bound_ms": bnd.ms,
                   "bound_by": bnd.by}
            if method == "lu":
                row["shared_lu_ms"] = time_single(
                    lambda: rs.ridge_solve_cuda(a, rhs, reg, "lu_shared"),
                    10)
            row["share_of_bound"] = bnd.ms / row["kernel_ms"]
            log("phase 3 timing: " + json.dumps(
                {"kernel": f"ridge_solve_{method}", "B": bsz, "K": k,
                 "library": "torch.linalg.cholesky + torch.cholesky_solve "
                            "on A + diag(reg)", "card": card, **row}))
        del a, rhs, reg
    return err


class swapped_routes:
    """Within the block, the training sweep's K1 and K2 routes
    (``fg.fused_gram_vector``, ``rs.ridge_solve_lu``) are ``gram`` and
    ``solve`` instead."""

    def __init__(self, fg, rs, gram, solve):
        self.fg, self.rs, self.routes = fg, rs, (gram, solve)

    def __enter__(self):
        self.saved = (self.fg.fused_gram_vector, self.rs.ridge_solve_lu)
        self.fg.fused_gram_vector, self.rs.ridge_solve_lu = self.routes
        return self

    def __exit__(self, *exc):
        self.fg.fused_gram_vector, self.rs.ridge_solve_lu = self.saved


def plain_versions(fg, rs) -> swapped_routes:
    """The sweep runs the plain PyTorch versions of K1 and K2."""
    return swapped_routes(fg, rs, fg.fused_gram_vector_reference,
                          rs.ridge_solve_lu_reference)


class recorded_calls(swapped_routes):
    """The sweep's K1 and K2 calls run as usual, and a copy of each
    call's arguments is kept (the sweep updates its factor matrices in
    place afterwards): ``gram`` holds (factors, indices, w, c) per K1
    call, ``solve`` (a, b, reg) per K2 call."""

    def __init__(self, fg, rs):
        self.gram, self.solve = [], []
        gram_fn, solve_fn = fg.fused_gram_vector, rs.ridge_solve_lu

        def gram(*args):
            self.gram.append(tuple(t.clone() for t in args))
            return gram_fn(*args)

        def solve(*args):
            self.solve.append(tuple(t.clone() for t in args))
            return solve_fn(*args)

        super().__init__(fg, rs, gram, solve)


def iteration_kernel_times(calls: recorded_calls, fg, rs):
    """Each training kernel timed over the recorded calls of one ALS
    iteration, on their own arguments: the kernel, its plain version,
    its library yardstick and its bound, summed over the calls; K2 also
    the shared-memory LU kernel it replaced ("shared_lu_ms").  K4 is
    timed on K2's arguments (``solver="gj"`` makes the same calls).
    Returns {kernel name: row}."""
    import torch

    rows = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound": Bound(), "calls": 0}
            for n in ("fused_gram", "ridge_solve_lu", "ridge_solve_gj")}
    rows["ridge_solve_lu"]["shared_lu_ms"] = 0.0
    long_spin = 20 * SPIN_CYCLES        # plain versions: many launches each
    row = rows["fused_gram"]
    for args in calls.gram:
        src, idx, w, _ = args
        (r, l), k = idx.shape, src.shape[1]
        row["ms"] += time_single(lambda: fg.fused_gram_vector_cuda(*args),
                                 3, warmup=1)
        row["plain_ms"] += time_single(
            lambda: fg.fused_gram_vector_reference(*args), 1, warmup=1,
            spin=long_spin)
        f = src.index_select(0, idx.reshape(-1)).reshape(r, l, k).float()
        fw = f * w[..., None]
        row["library_ms"] += time_single(lambda: torch.bmm(fw.mT, f), 3,
                                         warmup=1)
        del f, fw
        row["bound"].add(*gram_cost(r, l, k, src.shape[0],
                                    src.element_size()))
        row["calls"] += 1
    for a, b, reg in calls.solve:
        k = b.shape[1]
        a_reg = a + torch.diag_embed(reg[:, None].expand(-1, k))
        lib = time_single(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(a_reg)), 3, warmup=1)
        del a_reg
        for method, plain in (("lu", rs.ridge_solve_lu_reference),
                              ("gj", rs.ridge_solve_gj_reference)):
            row = rows[f"ridge_solve_{method}"]
            row["ms"] += time_single(
                lambda: rs.ridge_solve_cuda(a, b, reg, method), 3, warmup=1)
            if method == "lu":
                row["shared_lu_ms"] += time_single(
                    lambda: rs.ridge_solve_cuda(a, b, reg, "lu_shared"), 3,
                    warmup=1)
            row["plain_ms"] += time_single(lambda: plain(a, b, reg), 1,
                                           warmup=1, spin=long_spin)
            row["library_ms"] += lib
            row["bound"].add(*rs.solve_cost(a.shape[0], k, method))
            row["calls"] += 1
    for row in rows.values():
        bnd = row.pop("bound")
        row.update(bound_ms=bnd.ms, bound_by=bnd.by)
    return rows


def canonical_coo(chunks):
    """The ratings a side's chunks hold, as (entity id, other id, value)
    tensors: every masked slot in chunk, row and slot order, then stably
    sorted by entity id.  Two layouts of the same ratings give equal
    tensors when each entity's events keep their order."""
    import torch

    ents, others, vals = [], [], []
    for c in chunks:
        n_slots = c.n_seg if c.kind == "merged" else c.indices.shape[0]
        ent = torch.full((n_slots + 1,), -1, dtype=torch.int64,
                         device=c.indices.device)
        ent[c.keep] = c.targets
        row_ent = ent[c.seg_ids] if c.kind == "merged" else ent[:-1]
        m = c.mask
        ents.append(row_ent[:, None].expand_as(m)[m])
        others.append(c.indices[m].long())
        vals.append(c.values[m])
    ents = torch.cat(ents)
    order = torch.argsort(ents, stable=True)
    return ents[order], torch.cat(others)[order], torch.cat(vals)[order]


def timed_prep(als, users, items, ratings, cfg, dev):
    """(inputs, seconds, peak device bytes above the start) of one
    prepare_als_inputs call, synchronized."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inputs = als.prepare_als_inputs(users, items, ratings, ML25M_USERS,
                                    ML25M_ITEMS, cfg, device=dev)
    torch.cuda.synchronize()
    return (inputs, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def device_prep_steps(als, users, items, ratings, cfg, dev) -> dict:
    """Seconds of each step of the device route, run again one at a
    time with a synchronize after each: the ids to int32 on the host, the
    upload, both sides' plans (host np.bincount + plan_buckets), each
    side's build and chunks on the card, the factor init."""
    import numpy as np
    import torch

    out = {}

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return r

    h_u, h_i = step("int32_on_host", lambda: (np.asarray(users, np.int32),
                                              np.asarray(items, np.int32)))
    r_u, r_i, v = step("upload", lambda: (
        torch.from_numpy(h_u).to(dev), torch.from_numpy(h_i).to(dev),
        torch.from_numpy(ratings).to(dev, torch.float32)))
    p_u, p_i = step("plans", lambda: (
        als._plan_side(r_u, ML25M_USERS, cfg, host_rows=h_u),
        als._plan_side(r_i, ML25M_ITEMS, cfg, host_rows=h_i)))
    for side, rows, cols, plan in (("user", r_u, r_i, p_u),
                                   ("item", r_i, r_u, p_i)):
        step(f"build_{side}",
             lambda: als._device_side(rows, cols, v, plan))
    step("init", lambda: als._init_factors(ML25M_USERS, ML25M_ITEMS, RANK,
                                           cfg.seed))
    return out


def train_phase(dev, seed: int, als, fg, rs, card: str) -> dict:
    """Phase 6: ALS training at the MovieLens-25M shape."""
    import dataclasses

    import torch

    from predictionio_tpu_torch.tools.exp_gram_calls import (
        dead_rows, ml25m_ratings)

    t0 = time.perf_counter()
    users, items, ratings = ml25m_ratings(seed)
    gen_s = time.perf_counter() - t0
    cfg = als.ALSConfig(rank=RANK, iterations=TRAIN_ITERS, reg=0.01,
                        solver="auto", seed=seed)
    statics = als._resolve_loop_statics(cfg, dev)
    if statics["solver"] != "lu":
        die(f"training routes {statics} on the card; expected the LU "
            "kernel")
    # The default route ("auto") buckets on the card; the host route is
    # prepped too and held against it.
    taken = []
    real_device_route = als._prepare_als_inputs_device
    als._prepare_als_inputs_device = \
        lambda *a: taken.append(a[-1]) or real_device_route(*a)
    try:
        inputs, prep_s, prep_peak = timed_prep(als, users, items, ratings,
                                               cfg, dev)
    finally:
        als._prepare_als_inputs_device = real_device_route
    if len(taken) != 1:
        die("device_prep='auto' did not take the device route on the card")
    host_inputs, host_prep_s, host_peak = timed_prep(
        als, users, items, ratings,
        dataclasses.replace(cfg, device_prep=False), dev)
    steps = device_prep_steps(als, users, items, ratings, cfg, dev)
    init_s = steps["init"]
    for side in ("user", "item"):
        got = canonical_coo(getattr(inputs, f"{side}_buckets"))
        want = canonical_coo(getattr(host_inputs, f"{side}_buckets"))
        for what, g, w in zip(("entity ids", "other ids", "values"), got,
                              want):
            if not torch.equal(g, w):
                die(f"phase 6 prep: the {side} side's {what} differ "
                    "between the device and the host layouts")
        if got[0].numel() != ML25M_RATINGS:
            die(f"phase 6 prep: the {side} side holds {got[0].numel()} "
                f"ratings of {ML25M_RATINGS}")
        del got, want
    log(f"phase 6 prep: ML-25M {ML25M_RATINGS} ratings, device_prep auto "
        f"(bucketing on the card) {prep_s:.3f} s, peak {prep_peak / 2**30:.3f} "
        f"GiB allocated above the start; host route (device_prep=False) "
        f"{host_prep_s:.3f} s, peak {host_peak / 2**30:.3f} GiB; factor init "
        f"(in both) {init_s:.3f} s; the device route's steps run one by "
        f"one (s): {json.dumps({k: round(v, 4) for k, v in steps.items()})}"
        f"; {len(inputs.user_buckets)} user / "
        f"{len(inputs.item_buckets)} item chunks on the card, "
        f"{len(host_inputs.user_buckets)} / {len(host_inputs.item_buckets)} "
        f"from the host; both sides' ratings equal as canonical COO; card "
        f"{card}")
    n_chunks = (len(inputs.user_buckets), len(inputs.item_buckets))
    dead = {side: dead_rows(chunks, RANK, cfg.max_block_floats)
            for side, chunks in (("user", inputs.user_buckets),
                                 ("item", inputs.item_buckets))}
    log("phase 6 dead rows (index -1; 'untrimmed': with each plain "
        "bucket's last row chunk padded to the full chunk, as before the "
        "trim): " + json.dumps(dead))
    n_merged = sum(c.kind == "merged" for c in inputs.item_buckets)
    one = dataclasses.replace(cfg, iterations=1)
    t0 = time.perf_counter()
    with recorded_calls(fg, rs) as calls:   # the calls timed below
        first = als.train_als_prepared(inputs, one)
    first_s = time.perf_counter() - t0

    fg.LAUNCHES = 0                         # main path starts here
    rs.LU_LAUNCHES = 0
    rs.GJ_LAUNCHES = 0
    t0 = time.perf_counter()
    model = als.train_als_prepared(inputs, cfg)
    wall_s = time.perf_counter() - t0
    launches = {"fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES}
    if rs.GJ_LAUNCHES:
        die(f"ridge_solve_gj launched {rs.GJ_LAUNCHES} times under "
            "solver='auto'")
    for name, n in launches.items():     # main path ends here
        if n == 0:
            die(f"{name} never launched in the training run")
    ms_iter = wall_s * 1e3 / TRAIN_ITERS
    rmse = als.rmse(model, users, items, ratings, device=dev)
    t0 = time.perf_counter()
    host_model = als.train_als_prepared(host_inputs, cfg)
    host_ms_iter = (time.perf_counter() - t0) * 1e3 / TRAIN_ITERS
    del host_inputs
    err_routes = max(
        assert_close(torch.from_numpy(model.user_factors),
                     torch.from_numpy(host_model.user_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL,
                            torch.from_numpy(host_model.user_factors)),
                     f"{TRAIN_ITERS} iterations, device vs host prep: users"),
        assert_close(torch.from_numpy(model.item_factors),
                     torch.from_numpy(host_model.item_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL,
                            torch.from_numpy(host_model.item_factors)),
                     f"{TRAIN_ITERS} iterations, device vs host prep: items"))
    del host_model
    if not 0.0 < rmse < 5.0:
        die(f"training RMSE {rmse} out of range")

    with plain_versions(fg, rs):
        before = (fg.LAUNCHES, rs.LU_LAUNCHES)
        plain = als.train_als_prepared(inputs, one)
        if (fg.LAUNCHES, rs.LU_LAUNCHES) != before:
            die("the plain iteration launched a kernel")
    err_plain = max(
        assert_close(torch.from_numpy(first.user_factors),
                     torch.from_numpy(plain.user_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(plain.user_factors)),
                     "one iteration, kernels vs plain: users"),
        assert_close(torch.from_numpy(first.item_factors),
                     torch.from_numpy(plain.item_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(plain.item_factors)),
                     "one iteration, kernels vs plain: items"))
    rs.GJ_LAUNCHES = 0                      # the gj path starts here
    t0 = time.perf_counter()
    gj = als.train_als_prepared(inputs,
                                dataclasses.replace(one, solver="gj"))
    gj_s = time.perf_counter() - t0
    gj_launches = rs.GJ_LAUNCHES            # and ends here
    if gj_launches == 0:
        die("solver='gj' did not launch ridge_solve_gj")
    err_gj = max(
        assert_close(torch.from_numpy(gj.user_factors),
                     torch.from_numpy(first.user_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(first.user_factors)),
                     "one iteration, gj vs lu: users"),
        assert_close(torch.from_numpy(gj.item_factors),
                     torch.from_numpy(first.item_factors), TRAIN_RTOL,
                     scaled(TRAIN_ATOL, torch.from_numpy(first.item_factors)),
                     "one iteration, gj vs lu: items"))
    log(f"phase 6 train: ML-25M shape {ML25M_USERS}x{ML25M_ITEMS}, "
        f"{ML25M_RATINGS} ratings (made in {gen_s:.1f} s), rank {RANK}, "
        f"reg 0.01, solver auto -> {statics['solver']}: prep on the card "
        f"{prep_s:.2f} s, of which the factor init (threefry "
        f"normals on the host, {ML25M_USERS + ML25M_ITEMS} x {RANK}) "
        f"{init_s:.3f} s ({n_chunks[0]} user / {n_chunks[1]} item "
        f"chunks, {n_merged} split); {TRAIN_ITERS} iterations from the "
        f"device prep vs from the host prep max |err| {err_routes:.3g} "
        f"(from the host prep {host_ms_iter:.2f} ms/iter); "
        f"first iteration (its calls recorded) "
        f"{first_s * 1e3:.1f} ms; "
        f"{TRAIN_ITERS} iterations {wall_s:.3f} s = {ms_iter:.2f} ms/iter "
        f"= {ML25M_RATINGS / (ms_iter / 1e3):.4g} ratings/s; final RMSE "
        f"{rmse:.6f}; launches fused_gram {launches['fused_gram']}, "
        f"ridge_solve_lu {launches['ridge_solve_lu']}; one iteration "
        f"kernels vs plain versions max |err| {err_plain:.3g}, gj vs lu "
        f"{err_gj:.3g} (rtol {TRAIN_RTOL}, atol {TRAIN_ATOL}·max|ref|); "
        f"solver gj iteration {gj_s * 1e3:.1f} ms, ridge_solve_gj launches "
        f"{gj_launches}; card {card}")
    per_iter = iteration_kernel_times(calls, fg, rs)
    del calls
    for name, row in per_iter.items():
        log("phase 6 timing (one iteration's calls): " + json.dumps(
            {"kernel": name, "card": card, **row}))
    launches["ridge_solve_gj"] = gj_launches
    return {"launches": launches, "per_iter": per_iter,
            "err": max(err_plain, err_gj),
            # phase 19a trains these inputs again under checkpoints,
            # phase 23b its ratings on a mesh
            "inputs": inputs, "cfg": cfg, "model": model,
            "ratings": (users, items, ratings),
            "prep": {"device_s": prep_s, "host_s": host_prep_s,
                     "init_s": init_s, "device_peak_bytes": prep_peak,
                     "host_peak_bytes": host_peak}}


def dase_phase(dev, seed: int, home: str, mods: dict, card: str) -> dict:
    """Phase 7: events → run_train → deploy → /queries.json on the card.
    Returns the K3 launches of the phase, and the storage, engine variant
    and engine that phase 11 trains again."""
    import numpy as np
    import torch

    fg, rs, ft = mods["fg"], mods["rs"], mods["ft"]
    rng = np.random.default_rng(seed + 1)
    storage = mods["memory_storage"](os.path.join(home, "dase"))
    app_id = storage.get_apps().insert(mods["App"](id=None, name="chipsmoke"))
    events = storage.get_events()
    events.init(app_id)
    t0 = time.perf_counter()
    users = rng.integers(0, DASE_USERS, DASE_EVENTS).tolist()
    items = (rng.zipf(1.25, DASE_EVENTS) % DASE_ITEMS).tolist()
    stars = (rng.integers(1, 11, DASE_EVENTS) * 0.5).tolist()
    buys = (rng.random(DASE_EVENTS) < 0.1).tolist()
    Event, DataMap = mods["Event"], mods["DataMap"]
    events.insert_batch([
        Event(event="buy" if buy else "rate", entity_type="user",
              entity_id=f"u{u}", target_entity_type="item",
              target_entity_id=f"i{i}",
              properties=DataMap({} if buy else {"rating": r}))
        for u, i, r, buy in zip(users, items, stars, buys)], app_id)
    insert_s = time.perf_counter() - t0
    spec = json.loads((mods["csrc"].parent / "templates" / "recommendation"
                       / "engine.json").read_text())
    spec["datasource"]["params"]["appName"] = "chipsmoke"
    spec["algorithms"][0]["params"].update(rank=RANK, numIterations=10)
    variant = mods["EngineVariant"].from_dict(spec)
    eng = mods["engine"]()
    ctx = mods["RuntimeContext"].create(storage=storage)   # the card
    os.environ["PIO_RETRIEVAL_RUNG"] = "chunked"
    server = None
    plans = mods["get_registry"]().histogram("pio_device_prep_plan_ms")
    try:
        plans_before = plans.count()
        fg.LAUNCHES = 0                     # main path starts here
        rs.LU_LAUNCHES = 0
        ft.LAUNCHES = 0
        t0 = time.perf_counter()
        iid = mods["run_train"](eng, variant, ctx)
        train_s = time.perf_counter() - t0
        if plans.count() - plans_before != 2:
            die("DASE phase: run_train did not bucket both sides on the "
                "card")
        server = mods["EngineServer"](eng, variant, storage,
                                      host="127.0.0.1", port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        wrapper = server._models[0]
        names = list(wrapper.user_index.keys())
        asked = [names[j] for j in rng.choice(len(names), 16,
                                              replace=False)]
        answers, lats = [], []
        for user in asked:
            t0 = time.perf_counter()
            ans, _ = post_json(f"{base}/queries.json",
                               {"user": user, "num": 10})
            lats.append(time.perf_counter() - t0)
            answers.append(ans)
        counts = {"fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES,
                  "fused_topk": ft.LAUNCHES}   # main path ends here
        for name, n in counts.items():
            if n == 0:
                die(f"DASE phase: {name} never launched")
        if counts["fused_topk"] < 16:
            die(f"DASE phase: fused_topk launched {counts['fused_topk']} "
                "times for 16 queries")
        status = storage.get_engine_instances().get(iid).status
        if status != "COMPLETED":
            die(f"DASE phase: instance {iid} is {status}")
        uf, itf = wrapper.host_factors()
        items_d = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
        err = 0.0
        for user, ans in zip(asked, answers):
            hits = ans["itemScores"]
            if len(hits) != 10:
                die(f"DASE answer for {user} has {len(hits)} items")
            s = [[h["score"] for h in hits]]
            i = [[wrapper.item_index[h["item"]] for h in hits]]
            q = torch.from_numpy(uf[[wrapper.user_index[user]]]).to(dev)
            err = max(err, check_against_plain(
                s, i, q, items_d, 10, None, f"DASE /queries.json {user}",
                ft, mods["topk_mismatch"]))
        phases = mods["get_registry"]().get("pio_train_phase_ms")
        spans = {p: round(phases.sum(phase=p), 3) for p in (
            "train.datasource", "train.prepare", "train.algorithm",
            "train.persist")}
        fold = fold_in_queries(dev, rng, base, storage, app_id, wrapper,
                               items_d, mods)
    finally:
        if server is not None:
            server.stop()
        os.environ.pop("PIO_RETRIEVAL_RUNG", None)
    log(f"phase 7 dase: {DASE_EVENTS} rate/buy events ({DASE_USERS} "
        f"users, {DASE_ITEMS} items, generator distributions) inserted in "
        f"{insert_s:.2f} s; run_train rank {RANK} COMPLETED in "
        f"{train_s:.2f} s (phase ms {json.dumps(spans)}; trained "
        f"{len(wrapper.user_index)} users x {len(wrapper.item_index)} "
        f"items); 16 /queries.json p50 {sorted(lats)[8] * 1e3:.2f} ms, each "
        f"held against the plain top-k of the trained factors, max |score "
        f"err| {err:.3g}; launches {json.dumps(counts)}; card {card}")
    log(f"phase 7 fold-in: {fold['events']} rate/buy events of "
        f"{len(fold['users'])} unseen users inserted after deploy; their "
        f"/queries.json answers equal the plain top-k of fold_in's vector "
        f"(max |score err| {fold['err']:.3g}); a repeat query a result-"
        f"cache hit, the same user with num 5 from the fold-in cache, a "
        f"user with no events answered []; pio_fold_in_total "
        f"{json.dumps(fold['counts'])}; fused_topk launches "
        f"{fold['fused_topk']}; p50 {fold['p50_ms']:.2f} ms; card {card}")
    return {"fused_topk": counts["fused_topk"], "storage": storage,
            "variant": variant, "engine": eng}


def fold_in_queries(dev, rng, base: str, storage, app_id: int, wrapper,
                    items_d, mods) -> dict:
    """Phase 7's fold-in: rate/buy events of two users the deployed
    generation never saw, then /queries.json for each (each answer held
    against the plain top-k of ``fold_in``'s vector over the served item
    factors), a repeat query (a result-cache hit, which never reaches the
    fold-in), the same user with another ``num`` (another cache key: the
    fold-in cache answers it) and a user with no events ([])."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models.als import fold_in

    ft = mods["ft"]
    Event, DataMap = mods["Event"], mods["DataMap"]
    names = list(wrapper.item_index.keys())
    fresh, batch = {}, []
    for j in range(2):
        user = f"unseen{j}"
        ids, vals = [], []
        for n, p in enumerate(rng.choice(len(names), 12, replace=False)):
            buy = n % 4 == 3
            stars = float(rng.integers(1, 11) * 0.5)
            batch.append(Event(
                event="buy" if buy else "rate", entity_type="user",
                entity_id=user, target_entity_type="item",
                target_entity_id=names[p],
                properties=DataMap({} if buy else {"rating": stars})))
            ids.append(wrapper.item_index[names[p]])
            vals.append(wrapper.buy_rating if buy else stars)
        if user in wrapper.user_index:
            die(f"fold-in: {user} is a trained user")
        fresh[user] = (np.asarray(ids), np.asarray(vals, np.float32))
    storage.get_events().insert_batch(batch, app_id)
    registry = mods["get_registry"]()

    def fold_counts():
        c = registry.get("pio_fold_in_total")
        return {r: 0.0 if c is None else c.value(result=r)
                for r in ("solved", "cached", "no_events", "unavailable")}

    before = fold_counts()
    hits_before = metric_value(registry, "pio_result_cache_hits_total",
                               tier="local")
    ft.LAUNCHES = 0                         # fold-in path starts here
    answers, lats = {}, []
    for user in fresh:
        t0 = time.perf_counter()
        answers[user], _ = post_json(f"{base}/queries.json",
                                     {"user": user, "num": 10})
        lats.append(time.perf_counter() - t0)
    again, _ = post_json(f"{base}/queries.json",
                         {"user": "unseen0", "num": 10})
    five, _ = post_json(f"{base}/queries.json",
                        {"user": "unseen0", "num": 5})
    ghost, _ = post_json(f"{base}/queries.json",
                         {"user": "no_events_user", "num": 10})
    launches = ft.LAUNCHES                  # and ends here
    counts = {r: v - before[r] for r, v in fold_counts().items()}
    hits = metric_value(registry, "pio_result_cache_hits_total",
                        tier="local") - hits_before
    if counts != {"solved": 2, "cached": 1, "no_events": 1,
                  "unavailable": 0}:
        die(f"fold-in: pio_fold_in_total moved by {counts}")
    if hits != 1:
        die(f"fold-in: the repeat query made {hits} result-cache hits")
    if launches < 3:
        die(f"fold-in: fused_topk launched {launches} times for 3 "
            "dispatched queries")
    if ghost["itemScores"] != []:
        die(f"fold-in: a user with no events got {ghost}")
    if again != answers["unseen0"]:
        die("fold-in: the repeat query answered differently")
    _, itf = wrapper.host_factors()
    yty = None
    if wrapper.model.implicit:
        f = itf.astype(np.float64)
        yty = f.T @ f
    err = 0.0
    for user, (ids, vals) in fresh.items():
        hits = answers[user]["itemScores"]
        if len(hits) != 10:
            die(f"fold-in answer for {user} has {len(hits)} items")
        vec = fold_in(itf, ids, vals, reg=wrapper.reg, alpha=wrapper.alpha,
                      implicit=wrapper.model.implicit, yty=yty)
        err = max(err, check_against_plain(
            [[h["score"] for h in hits]],
            [[wrapper.item_index[h["item"]] for h in hits]],
            torch.from_numpy(vec[None]).to(dev), items_d, 10, None,
            f"fold-in /queries.json {user}", ft, mods["topk_mismatch"]))
        if user == "unseen0":
            err = max(err, check_against_plain(
                [[h["score"] for h in five["itemScores"]]],
                [[wrapper.item_index[h["item"]]
                  for h in five["itemScores"]]],
                torch.from_numpy(vec[None]).to(dev), items_d, 5, None,
                "fold-in /queries.json unseen0 num 5", ft,
                mods["topk_mismatch"]))
    return {"users": sorted(fresh), "events": len(batch), "counts": counts,
            "fused_topk": launches, "err": err,
            "p50_ms": sorted(lats)[len(lats) // 2] * 1e3}


class env_vars:
    """Within the block, the environment variables given are set (a value
    of None unsets one); the previous values come back afterwards."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def smem_lookups_per_s() -> tuple:
    """Shared-memory lookups per second of this card: SMs x 32 banks x
    the maximum SM clock (nvidia-smi clocks.max.sm), one 4-byte access
    per bank per clock.  Returns (rate, how it was derived)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * SMEM_BANKS * mhz * 1e6
    return rate, (f"{sms} SMs x {SMEM_BANKS} banks x {mhz:.0f} MHz "
                  f"(nvidia-smi clocks.max.sm) = {rate:.4g} lookups/s")


def pq_bound(b: int, s: int, n: int, k: int, smem_rate: float):
    """Least time for K5: the bytes (codes S*N, tables 4*B*S*256, output
    8*B*k) over the memory rate, or the B*S*N table lookups over the
    shared-memory rate, whichever is larger.  Returns (ms, by)."""
    t_bytes = (s * n + 4 * b * s * 256 + 8 * b * k) / HBM_BYTES_PER_S
    t_ops = b * s * n / smem_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def pq_kernel_phase(dev, seed: int, pqs, tpq, topk_mismatch, card: str):
    """Phase 8: K5 against its plain version over the grid, then timed.
    Returns (largest score error, {B: timing row})."""
    import torch

    from predictionio_tpu_torch.tools.exp_pq import kernel_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    codes_all = torch.randint(0, 256, (max(PQ_TABLES), max(PQ_ITEMS_GRID)),
                              generator=gen, device=dev, dtype=torch.uint8)
    luts_all = torch.randn((max(PQ_BATCHES), max(PQ_TABLES), 256),
                           generator=gen, device=dev)
    cases = [(b, t, n, k, None) for b in PQ_BATCHES for t in PQ_TABLES
             for n in PQ_ITEMS_GRID for k in PQ_KS if k <= n]
    cases += list(PQ_N_VALID) + list(PQ_EDGES)
    err = 0.0
    for b, t, n, k, n_valid in cases:
        luts = luts_all[:b, :t].contiguous()
        codes = codes_all[:t, :n].contiguous()
        got_s, got_i = pqs.pq_scan_cuda(luts, codes, k, n_valid=n_valid)
        torch.cuda.synchronize()
        n_real = n if n_valid is None else n_valid
        ref_s, ref_i = pqs.pq_scan_reference(luts, codes, min(k + 1, n_real),
                                             n_valid=n_valid)
        next_s = ref_s[:, k].cpu().numpy() if ref_s.shape[1] > k else None
        got_s, got_i = got_s.cpu().numpy(), got_i.cpu().numpy()
        ref_s = ref_s[:, :k].cpu().numpy()
        why = topk_mismatch(got_s, got_i, ref_s, ref_i[:, :k].cpu().numpy(),
                            next_s, rtol=RTOL, atol=ATOL)
        if why is None and int(got_i.max()) >= n_real:
            why = f"id {int(got_i.max())} at or past n_valid {n_real}"
        if why is not None:
            die(f"pq_scan B={b} S={t} N={n} k={k} n_valid={n_valid}: {why}")
        err = max(err, float(abs(got_s - ref_s).max()))
    del luts_all
    torch.cuda.empty_cache()
    log(f"phase 8 kernel: pq_scan matches its plain version in {len(cases)} "
        f"cases (B in {PQ_BATCHES}, S in {PQ_TABLES}, N in {PQ_ITEMS_GRID}, "
        f"k in {PQ_KS} with k <= N, and (B, S, N, k, n_valid) in "
        f"{PQ_N_VALID + PQ_EDGES}; S = 1 is the tie case: ids compared only "
        f"above the k-th score); max |score err| {err:.3g} (rtol {RTOL}, "
        f"atol {ATOL})")

    # Timed on a real codebook's tables, so that one library call computes
    # the same function: sum_t lut[t, code_t] = q . decode(n).
    n, t, k = PQ_TIMED
    m = t - 1
    coarse = torch.randn((256, RANK), generator=gen, device=dev) / 8
    books = torch.randn((m, 256, RANK // m), generator=gen, device=dev) / 8
    codes = codes_all[:t].contiguous()
    del codes_all
    decoded = coarse[codes[0].long()] + torch.cat(
        [books[j][codes[1 + j].long()] for j in range(m)], dim=1)
    queries = torch.randn((64, RANK), generator=gen, device=dev) / 8
    smem_rate, rate_note = smem_lookups_per_s()
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for b in (1, 64):
        q = queries[:b].contiguous()
        luts = tpq.device_luts(q, coarse, books)
        fns = {"": lambda: pqs.pq_scan_cuda(luts, codes, k),
               "plain_": lambda: pqs.pq_scan_reference(luts, codes, k),
               "library_": lambda: torch.topk(q @ decoded.T, k)}
        row = {}
        for _ in range(2):   # kernel, plain, library; twice, in turns
            for tag, fn in fns.items():
                row.setdefault(f"{tag}ms", []).append(time_single(fn, 20))
        row = {name: min(v) for name, v in row.items()}
        row["ms_cold"] = time_single(fns[""], 20, flush=flush_buf.zero_)
        # device ms a call of each of its two kernels (torch.profiler)
        row["by_kernel"] = kernel_ms(fns[""], 20)
        row["bound_ms"], row["bound_by"] = pq_bound(b, t, n, k, smem_rate)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[b] = row
        log("phase 8 timing: " + json.dumps(
            {"kernel": "pq_scan", "B": b, "S": t, "N": n, "k": k,
             "library": "torch.topk(q @ decoded.T, k), decode not timed",
             "card": card, **row}))
    log(f"phase 8 bound: bytes S*N + 4*B*S*256 + 8*B*k at "
        f"{HBM_BYTES_PER_S:.4g} B/s, or B*S*N lookups at {rate_note}")
    del flush_buf, decoded, codes
    torch.cuda.empty_cache()
    return err, rows


def tiled_report(_build) -> list:
    """ptxas's registers and spills of K3's tiled score pass kernels."""
    path = _build.library_path("fused_topk")
    lines, kernel = [], ""
    for ln in path.with_name(path.name + ".log").read_text().splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "topk_tiled_pass" in kernel and ("registers" in ln
                                             or "spill" in ln):
            lines.append(f"{kernel.split('topk_tiled_pass')[1][:6]}: "
                         f"{ln.replace('ptxas info    :', '').strip()}")
    return lines


def topk_kernel_phase(dev, ft, _build, topk_mismatch, queries_d, corpus,
                      card: str):
    """Phase 2: K3 against its plain version over a grid of N, B, k, D and
    n_valid, both score passes' edges and exact ties, then timed at B 1,
    8 and 64 beside the small-B route (the parent's design), its plain
    version, the library yardstick and its bound.  Returns (max |score
    err|, {(N, B, k): timing row})."""
    import torch

    ml, big = ML25M_ITEMS, BIG_ITEMS
    c = ft.TILED_MIN_BATCH
    # (N, B, k, n_valid, D): the grid, then the tiled route's edges: B
    # around the crossover (D 10 takes it from c on), around a 64-query
    # block, D 10 at B 64, k at a tiled block's limit (1,024 at D 64) and
    # past it, n_valid inside a tile (N 59,047 is no tile multiple)
    cases = [(n, b, k, None, RANK) for n in (ml, big) for b in (1, 8, 64)
             for k in (10, 100, 1000)]
    cases += [(ml, 8, 100, 50_000, RANK), (big, 64, 1000, big - 777, RANK),
              (ml, 1, 10, None, 10), (ml, c - 1, 10, None, 10),
              (ml, c, 10, None, 10), (ml, c + 1, 10, None, 10),
              (ml, 63, 10, None, RANK), (ml, 65, 10, None, RANK),
              (ml, 128, 10, None, RANK), (big, 128, 10, None, RANK),
              (ml, 64, 10, None, 10), (big, 64, 10, None, 10),
              (ml, 64, 1024, None, RANK), (ml, 64, 1025, None, RANK),
              (ml, 64, 10, ml - 50, RANK), (ml, 64, 100, 1000, 10)]
    routes = {True: 0, False: 0}
    max_err = 0.0
    for n, b, k, n_valid, d in cases:
        q = queries_d[:b, :d].contiguous()
        items = corpus[n] if d == RANK else corpus[n][:, :d].contiguous()
        routes[ft.plan(b, n if n_valid is None else n_valid, d,
                       k).tiled] += 1
        s, i = ft.fused_topk_cuda(q, items, k, n_valid=n_valid)
        torch.cuda.synchronize()
        max_err = max(max_err, check_against_plain(
            s.cpu().numpy(), i.cpu().numpy(), q, items, k, n_valid,
            f"kernel N={n} B={b} k={k} n_valid={n_valid} D={d}", ft,
            topk_mismatch))
        del items
    # exact ties on the tiled route: four copies of the best row, in
    # other tiles and chunks, come out lowest id first for every query
    tie_rows = [10, 300, 1500, 19_999]
    items = corpus[ml][:20_000].clone()
    items[tie_rows] = 5.0
    q = queries_d[:64].abs().contiguous()
    if not ft.plan(64, 20_000, RANK, 10).tiled:
        die("phase 2: the tie case does not take the tiled route")
    s, i = ft.fused_topk_cuda(q, items, 10)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    if not ((i[:, :4] == tie_rows).all() and (s[:, :4] == s[:, :1]).all()):
        die(f"phase 2: tied rows {tie_rows} came out as {i[:3, :4]} "
            f"(scores {s[:3, :4]})")
    max_err = max(max_err, check_against_plain(
        s, i, q, items, 10, None, "kernel ties B=64", ft, topk_mismatch))
    del items
    log(f"phase 2 kernel: fused_topk matches the plain version in "
        f"{len(cases) + 1} cases ({routes[True]} on the tiled route, "
        f"{routes[False]} on the small-B route; N in {{{ml}, {big}}}, B in "
        f"{{1, 8, 64}} x k in {{10, 100, 1000}}, n_valid < N, D 10; edges "
        f"B {c - 1}/{c}/{c + 1} at D 10, B 63/65/128, k 1024/1025, n_valid "
        f"inside a tile; exact ties at B 64 lowest id first); max |score "
        f"err| {max_err:.3g} (rtol {RTOL}, atol {ATOL})")
    log("phase 2 ptxas (tiled score pass, by queries a block): "
        + json.dumps(tiled_report(_build)))

    lib = ft.bind(_build.load("fused_topk"))
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    timings = {}
    k = 10
    for n in (ml, big):
        items = corpus[n]
        for b in (1, 8, 64):
            q = queries_d[:b].contiguous()
            reps = 50 if n == ml else 10
            small = ft.small_plan(b, n, RANK, k)
            fns = {"": lambda: ft.fused_topk_cuda(q, items, k),
                   "small_": lambda: ft.launch(lib, q, items, k, n, small),
                   "plain_": lambda: ft.fused_topk_reference(q, items, k),
                   "library_": lambda: torch.topk(q @ items.T, k)}
            row = {"route": "tiled" if ft.plan(b, n, RANK, k).tiled
                   else "small"}
            times = {}
            for _ in range(2):   # in turns, twice
                for tag, fn in fns.items():
                    times.setdefault(f"{tag}ms", []).append(
                        time_single(fn, reps))
                    times.setdefault(f"{tag}ms_stream", []).append(
                        time_stream(fn, reps))
            row.update({name: min(v) for name, v in times.items()})
            if n == ml:   # the corpus fits in L2: time it cold too
                row["ms_cold"] = time_single(fns[""], 20,
                                             flush=flush_buf.zero_)
            row["bound_ms"], row["bound_by"] = bound(b, n, RANK, k)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            timings[(n, b, k)] = row
            log("phase 2 timing: " + json.dumps(
                {"N": n, "B": b, "D": RANK, "k": k, "card": card,
                 "small": "the small-B route (the parent's design)",
                 "library": "torch.topk(q @ items.T, k)", **row}))
    del flush_buf
    return max_err, timings


def gather_kernels_phase(dev, seed: int, mods, card: str):
    """Phase 9: T1 and T2 against their plain versions at the tools'
    shape, timed, then driven through the tools' entry points.  Returns
    {kernel name: report fields}."""
    import torch

    fg, gt = mods["fg"], mods["gt"]
    exp_gram, exp_gather2 = mods["exp_gram"], mods["exp_gather2"]
    t = exp_gram.make_inputs(dev, seed)
    y, idx, w = t["y"], t["idx"], t["w"]
    r, l = idx.shape
    i_rows, k = y.shape
    k1_before = fg.LAUNCHES
    a = fg.gather_gram_cuda(y, idx, w)
    torch.cuda.synchronize()
    if fg.LAUNCHES != k1_before:
        die("gather_gram counted as a fused_gram (K1) launch")
    want = fg.gather_gram_reference(y, idx, w)
    abs_a = fg.gather_gram_reference(y.abs(), idx, w)
    err_t1 = assert_close(a, want, GRAM_RTOL, gram_atol(l, abs_a),
                          f"gather_gram R={r} L={l} K={k}")
    del a, want, abs_a
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    base = torch.randn((3000, max(GRAM_RANKS)), generator=gen, device=dev)
    for r_, l_, k_ in T1_GRID:
        ix = torch.randint(0, 3000, (r_, l_), generator=gen, device=dev,
                           dtype=torch.int32)
        ww = torch.rand((r_, l_), generator=gen, device=dev)
        fac32 = base[:, :k_].contiguous()
        for fac in (fac32, fac32.bfloat16()):
            what = f"gather_gram R={r_} L={l_} K={k_} {fac.dtype}"
            a = fg.gather_gram_cuda(fac, ix, ww)
            torch.cuda.synchronize()
            if not torch.equal(a, a.mT):
                die(f"{what}: A is not exactly symmetric")
            want = fg.gather_gram_reference(fac, ix, ww)
            abs_a = fg.gather_gram_reference(fac.abs(), ix, ww)
            err_t1 = max(err_t1, assert_close(
                a, want, GRAM_RTOL, gram_atol(l_, abs_a), what))
    del base, a, want, abs_a
    out = gt.gather_sum_cuda(y, idx)
    torch.cuda.synchronize()
    want = gt.gather_sum_reference(y, idx)
    abs_s = gt.gather_sum_reference(y.abs(), idx)
    err_t2 = assert_close(out, want, 0.0, gram_atol(l, abs_s),
                          f"gather_sum R={r} L={l} K={k}")
    del out, want, abs_s
    log(f"phase 9 kernel: gather_gram (T1) and gather_sum (T2) match their "
        f"plain versions at I {i_rows}, K {k}, R {r}, L {l} (Zipf(1.25) "
        f"indices, seed {seed}), and T1 also at {len(T1_GRID)} shapes (R "
        f"in (1, 3, 13), L in (1, 17, 33, 4096), K in {GRAM_RANKS}, and "
        f"(R, L, K) in {GRAM_MULTI_ROW}) with float32 and bfloat16 "
        f"factors, A exactly symmetric; max "
        f"|err| T1 {err_t1:.3g} (rtol "
        f"{GRAM_RTOL} + {GRAM_SIGMAS}·√L·2^-24·Σ|terms|), T2 {err_t2:.3g} "
        f"({GRAM_SIGMAS}·√L·2^-24·Σ|terms|)")

    f = y.index_select(0, idx.reshape(-1).long()).reshape(r, l, k)
    fw = f * w[..., None]
    idx64 = idx.long()
    rows = {}
    specs = {
        "gather_gram": (
            lambda: fg.gather_gram_cuda(y, idx, w),
            lambda: fg.gather_gram_reference(y, idx, w),
            lambda: torch.bmm(fw.mT, f),
            "torch.bmm(fw^T, f) on the pre-gathered block, gather not timed",
            Bound().add(r * l * 8 + i_rows * k * 4 + r * k * k * 4,
                        float(r * l * (k * (k + 1) + k))), err_t1),
        "gather_sum": (
            lambda: gt.gather_sum_cuda(y, idx),
            lambda: gt.gather_sum_reference(y, idx),
            lambda: torch.nn.functional.embedding_bag(idx64, y, mode="sum"),
            "torch.nn.functional.embedding_bag(idx, y, mode='sum')",
            Bound().add(r * l * 4 + i_rows * k * 4 + r * k * 4,
                        float(r * l * k)), err_t2),
    }
    for name, (kern, plain, lib, lib_note, bnd, err) in specs.items():
        row = {"ms": [], "plain_ms": [], "library_ms": []}
        for _ in range(2):   # kernel, plain, library; twice, in turns
            row["ms"].append(time_single(kern, 10))
            row["plain_ms"].append(time_single(plain, 5))
            row["library_ms"].append(time_single(lib, 10))
        row = {n_: min(v) for n_, v in row.items()}
        row.update(bound_ms=bnd.ms, bound_by=bnd.by,
                   share_of_bound=bnd.ms / row["ms"], max_abs_err=err)
        rows[name] = row
        log("phase 9 timing: " + json.dumps(
            {"kernel": name, "I": i_rows, "K": k, "R": r, "L": l,
             "library": lib_note, "card": card, **row}))
    del f, fw, idx64

    # T2 by index distribution (the tool's Zipf, its 2,048-row head, all
    # zero, uniform), the vec4 design beside the warp design it replaced;
    # the two add in the same order, so they must agree bit for bit
    dists = exp_gather2.distributions(
        {"idx": idx, "idx_head": torch.clamp(idx, max=2047)}, seed)
    by_dist = {}
    for name, ix in dists.items():
        vec4 = gt.gather_sum_cuda(y, ix)
        warp = gt.gather_sum_cuda(y, ix, design="warp")
        if not torch.equal(vec4, warp):
            die(f"gather_sum {name}: the vec4 and warp designs differ")
        err_t2 = max(err_t2, assert_close(
            vec4, gt.gather_sum_reference(y, ix), 0.0,
            gram_atol(l, gt.gather_sum_reference(y.abs(), ix)),
            f"gather_sum {name} indices"))
        times = {"ms": [], "warp_ms": []}
        for _ in range(2):   # in turns, twice
            times["ms"].append(time_single(
                lambda: gt.gather_sum_cuda(y, ix), 10))
            times["warp_ms"].append(time_single(
                lambda: gt.gather_sum_cuda(y, ix, design="warp"), 10))
        by_dist[name] = {n_: min(v) for n_, v in times.items()}
    rows["gather_sum"].update(max_abs_err=err_t2,
                              warp_ms=by_dist["zipf"]["warp_ms"])
    log("phase 9 T2 by index distribution (ms; vec4 design, and the warp "
        "design it replaced; bitwise equal): " + json.dumps(
            {"card": card, **by_dist}))
    del dists, t, y, idx, w
    torch.cuda.empty_cache()

    fg.GATHER_GRAM_LAUNCHES = 0             # main path (T1) starts here
    exp_gram.main(["pallas"])
    rows["gather_gram"]["launches"] = fg.GATHER_GRAM_LAUNCHES  # and ends
    gt.LAUNCHES = 0                         # main path (T2) starts here
    exp_gather2.main(["take"])
    rows["gather_sum"]["launches"] = gt.LAUNCHES               # and ends
    for name, row in rows.items():
        if row["launches"] == 0:
            die(f"the tool's entry point never launched {name}")
    log(f"phase 9 tools: exp_gram pallas launched gather_gram "
        f"{rows['gather_gram']['launches']} times, exp_gather2 take "
        f"launched gather_sum {rows['gather_sum']['launches']} times")
    torch.cuda.empty_cache()
    return rows


def pq_answers_agree(answers, host_s, host_i, what: str, topk_mismatch,
                     num: int = 10) -> float:
    """Hold served answers against a host search that returned num + 1
    columns (the extra one is the next score, for ties); returns the
    largest score error."""
    import numpy as np

    err = 0.0
    for row, ans in enumerate(answers):
        s, i = answer_arrays(ans, num)
        why = topk_mismatch(s, i, host_s[row:row + 1, :num],
                            host_i[row:row + 1, :num], host_s[row:row + 1, num],
                            rtol=RTOL, atol=ATOL)
        if why is not None:
            die(f"{what} row {row}: {why}")
        err = max(err, float(np.max(np.abs(np.asarray(s)
                                           - host_s[row:row + 1, :num]))))
    return err


def pq_serve_phase(seed: int, home: str, users_np, mods, card: str) -> dict:
    """Phase 10: a 1,048,576-item catalog with an IVF index and PQ codes,
    served on pq_flat (K5) and ivf_pq.  Returns K5's launches and the
    answers' largest score error."""
    import numpy as np

    pqs, tpq = mods["pqs"], mods["tpq"]
    retrieval = mods["retrieval"]
    rng = np.random.default_rng(seed + 10)
    t0 = time.perf_counter()
    items = rng.standard_normal((PQ_ITEMS, RANK), np.float32) \
        / np.float32(np.sqrt(RANK))
    gen_s = time.perf_counter() - t0
    with env_vars(PIO_IVF="on", PIO_IVF_MIN_ITEMS=None, PIO_IVF_NLIST=None,
                  PIO_PQ=None, PIO_PQ_M=None, PIO_PQ_MIN_ITEMS=None):
        t0 = time.perf_counter()
        ivf = retrieval.build_train_index(items, name="als", seed=seed,
                                          require_explicit=True)
        ivf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pq = retrieval.build_train_pq(items, name="als", ivf=ivf, seed=seed)
        pq_s = time.perf_counter() - t0
    if ivf is None or pq is None or pq.n_tables != 17:
        die(f"phase 10: the train policy built ivf={ivf is not None}, "
            f"pq={pq is not None and pq.n_tables}")
    log(f"phase 10 build: {PQ_ITEMS} x {RANK} items made in {gen_s:.1f} s; "
        f"IVF (PIO_IVF=on) nlist {ivf.nlist}, pad_len {ivf.pad_len}, built "
        f"in {ivf_s:.2f} s; PQ (default policy) M {pq.m}, "
        f"{pq.bytes_per_item()} B/item, built in {pq_s:.2f} s (host, numpy)")
    eng = mods["engine"]()
    spec = json.loads((mods["csrc"].parent / "templates" / "recommendation"
                       / "engine.json").read_text())
    spec["algorithms"][0]["params"]["rank"] = RANK
    variant = mods["EngineVariant"].from_dict(spec)
    storage = mods["memory_storage"](os.path.join(home, "pq"))
    wrapper = mods["wrapper_from_numpy"](
        users_np[:PQ_USERS], items, [f"u{j}" for j in range(PQ_USERS)],
        [f"i{j}" for j in range(PQ_ITEMS)], rank=RANK, ivf=ivf, pq=pq)
    t0 = time.perf_counter()
    mods["persist_instance"](eng, variant, [wrapper], storage)
    persist_s = time.perf_counter() - t0
    del wrapper
    server = None
    try:
        with env_vars(PIO_RETRIEVAL_RUNG="pq_flat", PIO_SERVE_HOST_MACS="0",
                      PIO_PQ_RERANK=None, PIO_IVF_NPROBE=None,
                      PIO_CORPUS_DTYPE=None):
            t0 = time.perf_counter()
            server = mods["EngineServer"](eng, variant, storage,
                                          host="127.0.0.1", port=0)
            server.start()
            load_s = time.perf_counter() - t0
            base = f"http://127.0.0.1:{server.port}"
            loaded = server._models[0]
            users = rng.choice(PQ_USERS, size=16 + 64 + 64, replace=False)
            one_u, flat_u, auto_u = users[:16], users[16:80], users[80:]
            pqs.LAUNCHES = 0                  # main path starts here
            lats, answers = [], []
            for u in one_u:
                t0 = time.perf_counter()
                ans, _ = post_json(f"{base}/queries.json",
                                   {"user": f"u{u}", "num": 10})
                lats.append(time.perf_counter() - t0)
                answers.append(ans)
            t0 = time.perf_counter()
            flat = server.query_batch([{"user": f"u{u}", "num": 10}
                                       for u in flat_u])
            flat_s = time.perf_counter() - t0
            flat_launches = pqs.LAUNCHES
            plan_flat = loaded.retriever().plan(64, 10)
            with env_vars(PIO_RETRIEVAL_RUNG=None):
                plan_auto = loaded.retriever().plan(64, 10)
                t0 = time.perf_counter()
                auto = server.query_batch([{"user": f"u{u}", "num": 10}
                                           for u in auto_u])
                auto_s = time.perf_counter() - t0
            launches = pqs.LAUNCHES           # main path ends here
            with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
                metrics = r.read().decode()
    finally:
        if server is not None:
            server.stop()
    if flat_launches != 17 or launches != 17:
        die(f"phase 10: pq_scan launched {flat_launches} times for 17 "
            f"pq_flat requests and {launches - flat_launches} times for the "
            "ivf_pq batch")
    if plan_flat.rung != "pq_flat" or plan_auto.rung != "ivf_pq":
        die(f"phase 10: planned {plan_flat} forced and {plan_auto} auto")
    lines = [ln for ln in metrics.splitlines()
             if ln.startswith("pio_retrieval_requests_total{")]
    if not any('rung="ivf_pq"' in ln for ln in lines) \
            or not any('rung="pq_flat"' in ln for ln in lines):
        die(f"phase 10: /metrics lacks the PQ rungs: {lines}")
    topk_mismatch = mods["topk_mismatch"]
    uf = users_np[:PQ_USERS]
    t0 = time.perf_counter()
    err = 0.0
    hs, hi, _ = tpq.search_pq_host(pq, items, uf[one_u], 11,
                                   plan_flat.rerank)
    err = max(err, pq_answers_agree(answers, hs, hi, "pq_flat /queries.json",
                                    topk_mismatch))
    hs, hi, _ = tpq.search_pq_host(pq, items, uf[flat_u], 11,
                                   plan_flat.rerank)
    err = max(err, pq_answers_agree(flat, hs, hi, "pq_flat query_batch",
                                    topk_mismatch))
    hs, hi, _ = tpq.search_ivf_pq_host(ivf, pq, items, uf[auto_u], 11,
                                       plan_auto.nprobe, plan_auto.rerank)
    err = max(err, pq_answers_agree(auto, hs, hi, "ivf_pq query_batch",
                                    topk_mismatch))
    check_s = time.perf_counter() - t0
    log(f"phase 10 pq: persisted in {persist_s:.2f} s, deployed in "
        f"{load_s:.2f} s; pq_flat (rerank {plan_flat.rerank}): 16 "
        f"/queries.json p50 {sorted(lats)[8] * 1e3:.2f} ms (first "
        f"{lats[0] * 1e3:.2f} ms, max {max(lats) * 1e3:.2f} ms), "
        f"query_batch of 64 in {flat_s * 1e3:.2f} ms; auto -> ivf_pq "
        f"(nprobe {plan_auto.nprobe}, rerank {plan_auto.rerank}): "
        f"query_batch of 64 in {auto_s * 1e3:.2f} ms; pq_scan launches "
        f"{launches}; every answer equals the host search on the same "
        f"structures (checked in {check_s:.1f} s), max |score err| "
        f"{err:.3g}; {' '.join(lines)}; card {card}")
    return {"launches": launches, "err": err}


PQ_DASE_QUERIES = 256   # phase 11: > PIO_RECALL_MIN_SAMPLES (50), and
#                         enough sampled scores that drift's PSI noise
#                         (~15/n + 15/256 for 16 bins) stays well under 0.25


def quality_doc(base: str, want_scored: int, phase: str,
                timeout_s: float = 20.0) -> dict:
    """``/quality.json`` once the recall monitor's off-thread worker has
    re-ranked every capture (scored + dropped + stale + errors reach the
    captured count) and at least ``want_scored`` of them."""
    deadline = time.perf_counter() + timeout_s
    while True:
        with urllib.request.urlopen(base + "/quality.json",
                                    timeout=60) as r:
            doc = json.loads(r.read())
        rec = doc.get("recall") or {}
        if rec.get("scored", 0) + rec.get("dropped", 0) >= \
                rec.get("captured", 0) and rec.get("scored", 0) >= \
                want_scored:
            return doc
        if time.perf_counter() > deadline:
            die(f"{phase}: the recall monitor scored {rec.get('scored')} "
                f"of {rec.get('captured')} captures in {timeout_s:.0f} s")
        time.sleep(0.1)


def pq_dase_phase(dase, mods, card: str) -> dict:
    """Phase 11: phase 7's events trained again with PIO_PQ_MIN_ITEMS=5000
    (the template builds codes, and the quality and recall scorecards),
    deployed with every request quality- and recall-sampled,
    PQ_DASE_QUERIES /queries.json on pq_flat; /quality.json's live
    pq_flat recall against the scorecard's baseline."""
    import numpy as np

    from predictionio_tpu_torch.obs.quality import Scorecard
    from predictionio_tpu_torch.obs.recall import RecallScorecard

    fg, rs, pqs, tpq = mods["fg"], mods["rs"], mods["pqs"], mods["tpq"]
    storage, variant, eng = dase["storage"], dase["variant"], dase["engine"]
    server = None
    try:
        with env_vars(PIO_PQ_MIN_ITEMS="5000", PIO_SERVE_HOST_MACS="0",
                      PIO_IVF=None, PIO_PQ=None, PIO_PQ_M=None,
                      PIO_RETRIEVAL_RUNG=None, PIO_PQ_RERANK=None,
                      PIO_QUALITY=None, PIO_QUALITY_SAMPLE="1",
                      PIO_QUALITY_MIN_SAMPLES=None, PIO_RECALL=None,
                      PIO_RECALL_SAMPLE="1", PIO_RECALL_MIN_SAMPLES=None,
                      PIO_RECALL_TOLERANCE=None, PIO_RECALL_K=None,
                      PIO_RESULT_CACHE=None):
            ctx = mods["RuntimeContext"].create(storage=storage)  # the card
            fg.LAUNCHES = 0                     # main path starts here
            rs.LU_LAUNCHES = 0
            pqs.LAUNCHES = 0
            t0 = time.perf_counter()
            iid = mods["run_train"](eng, variant, ctx)
            train_s = time.perf_counter() - t0
            server = mods["EngineServer"](eng, variant, storage,
                                          host="127.0.0.1", port=0)
            server.start()
            base = f"http://127.0.0.1:{server.port}"
            wrapper = server._models[0]
            names = list(wrapper.user_index.keys())
            rng = np.random.default_rng(len(names))
            asked = [names[j] for j in rng.choice(
                len(names), PQ_DASE_QUERIES, replace=False)]
            answers, lats = [], []
            for user in asked:
                t0 = time.perf_counter()
                ans, _ = post_json(f"{base}/queries.json",
                                   {"user": user, "num": 10})
                lats.append(time.perf_counter() - t0)
                answers.append(ans)
            counts = {"fused_gram": fg.LAUNCHES,
                      "ridge_solve_lu": rs.LU_LAUNCHES,
                      "pq_scan": pqs.LAUNCHES}    # main path ends here
            plan = wrapper.retriever().plan(1, 10)
            quality = quality_doc(base, 50, "phase 11")
    finally:
        if server is not None:
            server.stop()
    status = storage.get_engine_instances().get(iid).status
    if status != "COMPLETED":
        die(f"phase 11: instance {iid} is {status}")
    if not isinstance(wrapper.pq, tpq.PQCodebook) or wrapper.ivf is not None:
        die(f"phase 11: the generation carries pq={type(wrapper.pq)}, "
            f"ivf={type(wrapper.ivf)}")
    rsc = wrapper.recall
    if not isinstance(wrapper.quality, Scorecard) \
            or not isinstance(rsc, RecallScorecard) \
            or set(rsc.recall) != {"pq_flat"}:
        die(f"phase 11: the wrapper carries quality "
            f"{type(wrapper.quality)}, recall {rsc}")
    for name, n in counts.items():
        if n == 0:
            die(f"phase 11: {name} never launched")
    if counts["pq_scan"] != PQ_DASE_QUERIES or plan.rung != "pq_flat":
        die(f"phase 11: pq_scan launched {counts['pq_scan']} times for "
            f"{PQ_DASE_QUERIES} queries on the {plan.rung} rung")
    uf, itf = wrapper.host_factors()
    q = uf[[wrapper.user_index[u] for u in asked]]
    hs, hi, _ = tpq.search_pq_host(wrapper.pq, itf, q, 11, plan.rerank)
    rows = wrapper.item_index      # answer_arrays reads "i<row>"
    answers = [{"itemScores": [{"item": f"i{rows[h['item']]}",
                                "score": h["score"]}
                               for h in a["itemScores"]]} for a in answers]
    err = pq_answers_agree(answers, hs, hi, "DASE+PQ /queries.json",
                           mods["topk_mismatch"])
    rec = quality["recall"]
    row = rec["rungs"].get("pq_flat") or {}
    tol = rec["tolerance"]
    drift = quality["drift"]
    if (rec["verdict"] != "healthy" or row.get("baseline") is None
            or abs(row["recallFast"] - row["baseline"]) > tol
            or abs(row["recallSlow"] - row["baseline"]) > tol
            or rec["scorecard"].get("fingerprint") != rsc.fingerprint):
        die(f"phase 11: live pq_flat recall {json.dumps(rec)}")
    if (quality["sampling"]["sampledTotal"] < 50 or drift["tripped"]
            or drift["reportingOnly"] or quality["gate"]["rollback"]):
        die(f"phase 11: quality {json.dumps(quality)}")
    log(f"phase 11 dase+pq: run_train with PIO_PQ_MIN_ITEMS=5000 COMPLETED "
        f"in {train_s:.2f} s ({len(wrapper.user_index)} users x "
        f"{len(wrapper.item_index)} items; codes M {wrapper.pq.m}, "
        f"{wrapper.pq.bytes_per_item()} B/item; scorecards: quality "
        f"{wrapper.quality.n} rank-1 scores, recall@10 pq_flat "
        f"{rsc.recall['pq_flat'][10]:.4f} over {rsc.n_queries} users); "
        f"{PQ_DASE_QUERIES} /queries.json on {plan.rung} (rerank "
        f"{plan.rerank}) p50 {sorted(lats)[len(lats) // 2] * 1e3:.2f} ms, "
        f"each equal to the host PQ search of the trained factors, max "
        f"|score err| {err:.3g}; launches {json.dumps(counts)}; card {card}")
    log(f"phase 11 quality+recall (every request sampled): live pq_flat "
        f"recall@10 fast {row['recallFast']} slow {row['recallSlow']} vs "
        f"baseline {row['baseline']} (tolerance {tol}), {rec['scored']} of "
        f"{rec['captured']} captures re-ranked exactly off the serving "
        f"path ({rec['dropped']} dropped), scanned fraction "
        f"{row.get('scannedFraction')}, shortlist saturation "
        f"{row.get('shortlistSaturation')}; drift psi fast "
        f"{drift['psi']['fast']} slow {drift['psi']['slow']} over "
        f"{drift['nFast']} scores (threshold {drift['threshold']}), "
        f"verdict {quality['verdict']}, gate.rollback "
        f"{quality['gate']['rollback']}; card {card}")
    return {"launches": counts["pq_scan"], "err": err}


# Phase 12: the engine.json loop across processes, at the MovieLens-1M
# shape (cut from ML-25M in depth only: a 25 M-event import through JSON
# and sqlite would not fit the run's limit).
ML1M_EVENTS, ML1M_USERS, ML1M_ITEMS = 1_000_209, 6_040, 3_706
ML1M_BUYER_SHARE, ML1M_BUYS_EACH = 0.05, 5
CLI_APP, CLI_QUERIES = "chipcli", 64
CLI_FACTORY = "predictionio_tpu_torch.templates.recommendation:engine"
CLI_TIMEOUT_S = 600       # any one subprocess of phase 12


def cli_eval_params():
    """``pio eval``'s two candidates in phase 12 (the CLI loads this by
    name): rank 64, 5 iterations, evalK 2, two ridges."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithmParams, DataSourceParams)
    from predictionio_tpu_torch.templates.recommendation.evaluation import (
        ParamsList)

    ds = DataSourceParams(appName=CLI_APP, evalK=2)
    return ParamsList([
        EngineParams(datasource_params=ds, algorithms_params=(
            ("als", ALSAlgorithmParams(rank=RANK, numIterations=5,
                                       lambda_=lam, seed=3)),))
        for lam in (0.01, 0.1)])


def ml1m_events(seed: int):
    """The phase's events as columns, in the order they are written:
    1,000,209 rate events (every user and item at least once, Zipf(1.25)
    items, half stars) and 5 buys each for 5 % of the users, sorted by
    the user id's string, with event times one second apart — the order
    the sqlite training scan reads them in (its entity index), so the
    in-memory store's event-time scan sees the same order."""
    import numpy as np

    rng = np.random.default_rng(seed + 12)
    n = ML1M_EVENTS
    users = rng.integers(0, ML1M_USERS, n)
    users[:ML1M_USERS] = rng.permutation(ML1M_USERS)
    items = rng.zipf(1.25, n) % ML1M_ITEMS
    items[:ML1M_ITEMS] = rng.permutation(ML1M_ITEMS)
    stars = rng.integers(1, 11, n) * 0.5
    buyers = rng.choice(ML1M_USERS, int(ML1M_USERS * ML1M_BUYER_SHARE),
                        replace=False)
    b_users = np.repeat(buyers, ML1M_BUYS_EACH)
    b_items = rng.zipf(1.25, len(b_users)) % ML1M_ITEMS
    users = np.concatenate([users, b_users])
    items = np.concatenate([items, b_items])
    stars = np.concatenate([stars, np.full(len(b_users), np.nan)])
    names = np.array([f"u{u}" for u in range(ML1M_USERS)])
    rank = np.empty(ML1M_USERS, np.int64)
    rank[np.argsort(names)] = np.arange(ML1M_USERS)
    order = np.argsort(rank[users], kind="stable")
    # one second apart, ending three weeks ago: all before any train's
    # watermark
    start = np.datetime64("now", "D") - np.timedelta64(35, "D")
    times = np.datetime_as_string(
        start.astype("datetime64[s]")
        + np.arange(len(order)).astype("timedelta64[s]"))
    return users[order], items[order], stars[order], times


def write_jsonl(path: str, users, items, stars, times) -> None:
    with open(path, "w") as f:
        for u, i, r, t in zip(users.tolist(), items.tolist(), stars.tolist(),
                              times.tolist()):
            if r != r:   # NaN: a buy
                f.write(f'{{"event":"buy","entityType":"user","entityId":'
                        f'"u{u}","targetEntityType":"item","targetEntityId":'
                        f'"i{i}","eventTime":"{t}Z"}}\n')
            else:
                f.write(f'{{"event":"rate","entityType":"user","entityId":'
                        f'"u{u}","targetEntityType":"item","targetEntityId":'
                        f'"i{i}","properties":{{"rating":{r}}},'
                        f'"eventTime":"{t}Z"}}\n')


def cli_env(home: str) -> env_vars:
    """The phase's environment, in this process and its children: a
    fresh PIO_HOME on the default storage, the chunked rung (K3) for
    every answer — at 3,706 items the router would answer on the host
    or by a library call — and no other switch of the path set."""
    return env_vars(
        PIO_HOME=home, PIO_RETRIEVAL_RUNG="chunked", PIO_CONFIG_FILE=None,
        PIO_IVF=None, PIO_PQ=None, PIO_PQ_M=None, PIO_SERVE_HOST_MACS=None,
        PIO_FOLD_IN=None, PIO_FOLD_IN_SHARED=None, PIO_EVAL_BATCH=None,
        PIO_FOLD_IN_SHARED_MAX_AGE_S=None,
        PIO_STORAGE_REPOSITORIES_METADATA_SOURCE=None,
        PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=None,
        PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE=None,
        PYTHONPATH=str(Path(__file__).resolve().parent))


def run_cli(*argv, phase: str = "phase 12") -> str:
    """One ``python -m predictionio_tpu_torch.cli`` subprocess; dies
    unless it exits 0.  Returns its standard output."""
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli", *argv],
        cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)
    if out.returncode != 0:
        die(f"{phase}: pio {' '.join(argv)} exited {out.returncode}: "
            f"{out.stderr[-2000:]}")
    return out.stdout


def timed_scorecards() -> dict:
    """Wrap the ALS and two-tower templates' scorecard builders
    (``scorecard_from_matrix``, ``build_recall_scorecard``) so that every
    in-process train sums their wall time: what the quality and recall
    layers add to a train.  Returns the running totals."""
    totals = {"s": 0.0, "calls": 0}
    for path in ("predictionio_tpu_torch.templates.recommendation.engine",
                 "predictionio_tpu_torch.templates.twotower.engine"):
        mod = importlib.import_module(path)
        for name in ("scorecard_from_matrix", "build_recall_scorecard"):
            def timed(*args, _real=getattr(mod, name), **kwargs):
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kwargs)
                finally:
                    totals["s"] += time.perf_counter() - t0
                    totals["calls"] += 1
            setattr(mod, name, timed)
    return totals


def counted_pio(argv) -> int:
    """``pio <argv>`` in this process, then one line ``launches {...}``
    with the kernel launches it made: how a verb run as a subprocess
    reports its counts (``deployed``)."""
    from predictionio_tpu_torch.cli.main import main as pio
    from predictionio_tpu_torch.ops import fused_gram as fg
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.ops import ridge_solve as rs

    from predictionio_tpu_torch.obs import get_registry

    rc = pio(list(argv))
    print("launches " + json.dumps({
        "fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES,
        "fused_topk": ft.LAUNCHES}), flush=True)
    stale = get_registry().get("pio_refresh_staleness_s")
    if stale is not None:
        print(f"pio_refresh_staleness_s {stale.value()!r}", flush=True)
    return rc


class deployed:
    """``pio deploy`` in a subprocess on a free port (``extra``: more of
    its arguments; ``env``: its environment, this process's by default),
    until ``stop()`` (``POST /stop``; it must exit 0).  ``started_s``:
    Popen time.  With ``wait=False`` the constructor returns at once and
    :meth:`ready` waits for the listening line, so several deploys start
    together.  It runs through :func:`counted_pio`, so ``stop()`` leaves
    the subprocess's kernel launches in ``launches``."""

    def __init__(self, engine_json: str, log_path: str, extra=(),
                 phase: str = "phase 12", env=None, wait: bool = True):
        self.phase = phase
        self.log_path = log_path
        self.started_s = time.perf_counter()
        self.log = open(log_path, "w")
        self.launches = None
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.counted_pio(sys.argv[1:]))", "deploy",
             "--engine-json", engine_json, "--ip", "127.0.0.1", "--port",
             "0", *extra],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        if wait:
            self.ready()

    def ready(self) -> "deployed":
        """Wait for the listening line: the port, instance and device."""
        import re
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    CLI_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        m = re.search(r"(?:listening|frontend) on 127\.0\.0\.1:(\d+) "
                      r"\(instance (\w+); device (\S+);", line)
        if not m:
            self.kill()
            die(f"{self.phase}: pio deploy did not start ({line!r}): "
                f"{Path(self.log_path).read_text()[-2000:]}")
        self.base = f"http://127.0.0.1:{m.group(1)}"
        self.instance, self.device = m.group(2), m.group(3)
        return self

    def get(self, path: str) -> str:
        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.read().decode()

    def stop(self) -> None:
        post_json(self.base + "/stop", {})
        rc = self.proc.wait(timeout=120)
        rest = self.proc.stdout.read()
        self.proc.stdout.close()
        self.log.close()
        if rc != 0:
            die(f"{self.phase}: pio deploy exited {rc} after POST /stop")
        for line in rest.splitlines():
            if line.startswith("launches "):
                self.launches = json.loads(line[len("launches "):])

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.proc.stdout.close()
        self.log.close()


def answers_agree(got, want, what: str, topk_mismatch) -> None:
    """Two answers to one query: ids equal except within a tie, scores
    within the answer tolerance."""
    gs = [[h["score"] for h in got["itemScores"]]]
    gi = [[int(h["item"][1:]) for h in got["itemScores"]]]
    ws = [[h["score"] for h in want["itemScores"]]]
    wi = [[int(h["item"][1:]) for h in want["itemScores"]]]
    why = topk_mismatch(gs, gi, ws, wi, None, rtol=RTOL, atol=ATOL)
    if why is not None or len(gs[0]) != len(ws[0]):
        die(f"{what}: {why or 'lengths differ'}")


def cli_loop_phase(dev, seed: int, mods: dict, card: str) -> dict:
    """Phase 12: app new and import (subprocesses) → train (in-process,
    through the CLI's main) → deploy (two subprocesses) → 64
    /queries.json → fold-in across processes → batchpredict and eval
    (in-process), all on the default sqlite + localfs storage of a fresh
    PIO_HOME.  Returns the phase's launches of K1, K2 and K3, and the
    store's directory (``work``, which phase 16 refreshes and removes)
    with its ``engine_json``."""
    import logging

    import numpy as np
    import torch

    fg, rs, ft, pio = mods["fg"], mods["rs"], mods["ft"], mods["pio"]
    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.models.als import fold_in
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    logging.basicConfig(level=logging.WARNING)   # the CLI's INFO stays off
    work = tempfile.mkdtemp(prefix="pio_chip_cli_")
    env = cli_env(os.path.join(work, "home"))
    registry = mods["get_registry"]()

    def read_ms() -> float:
        h = registry.get("pio_train_phase_ms")
        return 0.0 if h is None else h.sum(phase="train.datasource")

    def fold_count(metrics: str, result: str) -> float:
        key = f'pio_fold_in_total{{result="{result}"}} '
        return sum(float(ln[len(key):]) for ln in metrics.splitlines()
                   if ln.startswith(key))

    servers = []
    out = {}
    kept = False
    phase_t0 = time.perf_counter()
    env.__enter__()
    reset_storage()
    try:
        # -- 1: events → JSONL → app new, import (subprocesses) -----------
        t0 = time.perf_counter()
        users, items, stars, times = ml1m_events(seed)
        events_path = os.path.join(work, "events.jsonl")
        write_jsonl(events_path, users, items, stars, times)
        n_events = len(users)
        out["write_s"] = time.perf_counter() - t0
        run_cli("app", "new", CLI_APP)
        t0 = time.perf_counter()
        said = run_cli("import", "--appid", "1", "--input", events_path)
        out["import_s"] = time.perf_counter() - t0
        if f"Imported {n_events} events" not in said:
            die(f"phase 12: import said {said!r}")

        # -- 2: train in-process through the CLI ---------------------------
        spec = json.loads((Path(__file__).resolve().parent / "examples" /
                           "recommendation" / "engine.json").read_text())
        spec["engineFactory"] = CLI_FACTORY
        spec["datasource"]["params"]["appName"] = CLI_APP
        spec["algorithms"][0]["params"].update(
            rank=RANK, numIterations=TRAIN_ITERS, seed=seed)
        engine_json = os.path.join(work, "engine.json")
        Path(engine_json).write_text(json.dumps(spec))
        read_before = read_ms()
        fg.LAUNCHES = 0                      # main path starts here
        rs.LU_LAUNCHES = 0
        t0 = time.perf_counter()
        if pio(["train", "--engine-json", engine_json]) != 0:
            die("phase 12: pio train failed")
        out["train_s"] = time.perf_counter() - t0
        launches = {"fused_gram": fg.LAUNCHES,
                    "ridge_solve_lu": rs.LU_LAUNCHES}
        out["read_ms"] = read_ms() - read_before
        # phase 23c trains this store again on a mesh: a copy as it
        # stands now, before the fold-in events and later phases
        out["mesh_home"] = os.path.join(work, "mesh_home")
        shutil.copytree(os.path.join(work, "home"), out["mesh_home"])
        out["mesh_engine_json"] = os.path.join(work, "mesh_engine.json")
        shutil.copyfile(engine_json, out["mesh_engine_json"])
        storage = get_storage()
        eng = mods["engine"]()
        variant = mods["EngineVariant"].from_file(engine_json)
        [inst] = storage.get_engine_instances().get_all()
        if inst.status != "COMPLETED":
            die(f"phase 12: instance {inst.id} is {inst.status}")
        ctx = mods["RuntimeContext"](storage=storage, device=dev)
        [wrapper] = load_models(eng, inst, ctx)
        uf, itf = wrapper.host_factors()
        if uf.shape != (ML1M_USERS, RANK) or itf.shape != (ML1M_ITEMS, RANK):
            die(f"phase 12: trained {uf.shape} x {itf.shape}")
        # the same events, in the same order, in a MEMORY store: run_train
        # there must give the same factors by entity id
        mem = mods["memory_storage"](os.path.join(work, "mem"))
        app_id = mem.get_apps().insert(mods["App"](id=None, name=CLI_APP))
        mem.get_events().init(app_id)
        Event, DataMap = mods["Event"], mods["DataMap"]
        from predictionio_tpu_torch.data.json_support import parse_iso8601

        mem.get_events().insert_batch([
            Event(event="buy" if r != r else "rate", entity_type="user",
                  entity_id=f"u{u}", target_entity_type="item",
                  target_entity_id=f"i{i}",
                  properties=DataMap({} if r != r else {"rating": r}),
                  event_time=parse_iso8601(t + "Z"))
            for u, i, r, t in zip(users.tolist(), items.tolist(),
                                  stars.tolist(), times.tolist())], app_id)
        mid = mods["run_train"](eng, variant, mods["RuntimeContext"].create(
            storage=mem, device=dev))
        [mw] = load_models(eng, mem.get_engine_instances().get(mid),
                           mods["RuntimeContext"](storage=mem, device=dev))
        del mem
        mu, mi = mw.host_factors()
        same_order = (list(mw.user_index.keys()) ==
                      list(wrapper.user_index.keys()))
        err = 0.0
        for what, got, gidx, want, widx in (
                ("users", uf, wrapper.user_index, mu, mw.user_index),
                ("items", itf, wrapper.item_index, mi, mw.item_index)):
            if sorted(gidx.keys()) != sorted(widx.keys()):
                die(f"phase 12: the sqlite and memory trains saw other "
                    f"{what}")
            rows = [widx[key] for key in gidx.keys()]
            g = torch.from_numpy(np.ascontiguousarray(got))
            w = torch.from_numpy(np.ascontiguousarray(want[rows]))
            err = max(err, assert_close(
                g, w, TRAIN_RTOL, scaled(TRAIN_ATOL, w),
                f"phase 12: {what} factors, sqlite train vs memory train"))
        out["factor_err"] = err
        out["same_order"] = same_order

        # -- 3: deploy (a second process on the same files) ---------------
        a = deployed(engine_json, os.path.join(work, "deploy_a.log"))
        servers.append(a)
        rng = np.random.default_rng(seed + 121)
        names = list(wrapper.user_index.keys())
        asked = [names[j] for j in rng.choice(len(names), CLI_QUERIES,
                                              replace=False)]
        answers, lats, server_ms = [], [], []
        for n, user in enumerate(asked):
            t0 = time.perf_counter()
            ans, ms = post_json(f"{a.base}/queries.json",
                                {"user": user, "num": 10})
            lats.append(time.perf_counter() - t0)
            if n == 0:
                out["deploy_to_first_s"] = time.perf_counter() - a.started_s
            answers.append(ans)
            server_ms.append(ms)
        status = json.loads(a.get("/"))
        if not status["device"].startswith(dev.type) or \
                status["engineInstanceId"] != inst.id:
            die(f"phase 12: deploy reports {status}")
        items_d = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
        qerr = 0.0
        for user, ans in zip(asked, answers):
            hits = ans["itemScores"]
            if len(hits) != 10:
                die(f"phase 12: the answer for {user} has {len(hits)} items")
            qerr = max(qerr, check_against_plain(
                [[h["score"] for h in hits]],
                [[wrapper.item_index[h["item"]] for h in hits]],
                torch.from_numpy(uf[[wrapper.user_index[user]]]).to(dev),
                items_d, 10, None, f"phase 12 /queries.json {user}", ft,
                mods["topk_mismatch"]))
        out["p50_ms"] = sorted(lats)[len(lats) // 2] * 1e3
        out["server_p50_ms"] = sorted(server_ms)[len(server_ms) // 2]
        out["query_err"] = qerr
        # phase 23c asks these again of a mesh train's deploy
        out["asked"], out["answers"] = asked, answers
        out["factors12"] = (uf, itf, wrapper.user_index, wrapper.item_index)

        # -- 4: fold-in across processes ------------------------------------
        item_names = list(wrapper.item_index.keys())
        fold_path = os.path.join(work, "fold.jsonl")
        fresh = {}
        out["fold_events"] = 0
        with open(fold_path, "w") as f:
            for j in range(2):
                user = f"unseen{j}"
                ids, vals = [], []
                for n, p in enumerate(rng.choice(len(item_names), 12,
                                                 replace=False)):
                    buy = n % 4 == 3
                    r = float(rng.integers(1, 11) * 0.5)
                    ev = {"event": "buy" if buy else "rate",
                          "entityType": "user", "entityId": user,
                          "targetEntityType": "item",
                          "targetEntityId": item_names[p]}
                    if not buy:
                        ev["properties"] = {"rating": r}
                    f.write(json.dumps(ev) + "\n")
                    out["fold_events"] += 1
                    ids.append(wrapper.item_index[item_names[p]])
                    vals.append(wrapper.buy_rating if buy else r)
                fresh[user] = (np.asarray(ids), np.asarray(vals, np.float32))
        run_cli("import", "--appid", "1", "--input", fold_path)
        folded, fold_lats = {}, []
        for user in fresh:
            t0 = time.perf_counter()
            folded[user], _ = post_json(f"{a.base}/queries.json",
                                        {"user": user, "num": 10})
            fold_lats.append(time.perf_counter() - t0)
        ferr = 0.0
        for user, (ids, vals) in fresh.items():
            hits = folded[user]["itemScores"]
            if len(hits) != 10:
                die(f"phase 12: the folded answer for {user} has "
                    f"{len(hits)} items")
            vec = fold_in(itf, ids, vals, reg=wrapper.reg,
                          alpha=wrapper.alpha, implicit=False)
            ferr = max(ferr, check_against_plain(
                [[h["score"] for h in hits]],
                [[wrapper.item_index[h["item"]] for h in hits]],
                torch.from_numpy(vec[None]).to(dev), items_d, 10, None,
                f"phase 12 fold-in {user}", ft, mods["topk_mismatch"]))
        b = deployed(engine_json, os.path.join(work, "deploy_b.log"))
        servers.append(b)
        again, _ = post_json(f"{b.base}/queries.json",
                             {"user": "unseen0", "num": 10})
        answers_agree(again, folded["unseen0"],
                      "phase 12: the second deploy's folded answer",
                      mods["topk_mismatch"])
        counts = {name: {r: fold_count(s.get("/metrics"), r)
                         for r in ("solved", "shared", "cached")}
                  for name, s in (("first", a), ("second", b))}
        if counts["second"] != {"solved": 0, "shared": 1, "cached": 0} \
                or counts["first"]["solved"] != 2:
            die(f"phase 12: pio_fold_in_total by deploy {counts}")
        out["fold_first_ms"] = max(fold_lats) * 1e3
        out["fold_err"] = ferr
        out["fold_counts"] = counts
        for s in (b, a):
            s.stop()
            servers.remove(s)

        # -- 5: batchpredict in-process -------------------------------------
        q_path = os.path.join(work, "queries.jsonl")
        p_path = os.path.join(work, "predictions.jsonl")
        Path(q_path).write_text("".join(
            json.dumps({"user": u, "num": 10}) + "\n" for u in asked))
        ft.LAUNCHES = 0
        t0 = time.perf_counter()
        if pio(["batchpredict", "--engine-json", engine_json,
                     "--input", q_path, "--output", p_path]) != 0:
            die("phase 12: pio batchpredict failed")
        out["batch_s"] = time.perf_counter() - t0
        launches["fused_topk"] = ft.LAUNCHES
        lines = [json.loads(ln) for ln in
                 Path(p_path).read_text().splitlines()]
        if [ln["query"]["user"] for ln in lines] != asked:
            die("phase 12: batchpredict's lines are not the queries")
        for ln, ans in zip(lines, answers):
            answers_agree(ln["prediction"], ans,
                          f"phase 12 batchpredict {ln['query']['user']}",
                          mods["topk_mismatch"])
        if launches["fused_topk"] < 1:
            die("phase 12: batchpredict never launched fused_topk")

        # -- 6: eval in-process ----------------------------------------------
        before = {"fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES,
                  "fused_topk": ft.LAUNCHES}
        eval_json = os.path.join(work, "eval.json")
        t0 = time.perf_counter()
        if pio([
                "eval", "predictionio_tpu_torch.templates.recommendation."
                "evaluation:evaluation", "chip_smoke:cli_eval_params",
                "--output-json", eval_json]) != 0:
            die("phase 12: pio eval failed")
        out["eval_s"] = time.perf_counter() - t0
        for name, n in before.items():
            mod = {"fused_gram": fg, "ridge_solve_lu": rs,
                   "fused_topk": ft}[name]
            now = mod.LU_LAUNCHES if name == "ridge_solve_lu" \
                else mod.LAUNCHES
            if now == n:
                die(f"phase 12: eval never launched {name}")
            launches[name] += now - n        # main path ends here
        res = json.loads(Path(eval_json).read_text())
        scores = [c["score"] for c in res["candidates"]]
        if len(scores) != 2 or not all(math.isfinite(s) for s in scores):
            die(f"phase 12: eval scored {scores}")
        if len(storage.get_evaluation_instances().get_completed()) != 1:
            die("phase 12: no completed EvaluationInstance")
        out["eval_scores"] = scores
        for name, n in launches.items():
            if n == 0:
                die(f"phase 12: {name} never launched")
        # K3 at eval's batch (PIO_EVAL_BATCH, 1,024 queries) against its
        # plain version, beyond phase 2's grid
        q = torch.from_numpy(np.ascontiguousarray(uf[:1024])).to(dev)
        s, i = ft.fused_topk_cuda(q, items_d, 10)
        out["eval_batch_err"] = check_against_plain(
            s.cpu().numpy(), i.cpu().numpy(), q, items_d, 10, None,
            "phase 12 K3 at B 1,024", ft, mods["topk_mismatch"])
        # phase 16 refreshes this store: it outlives the phase
        out["work"], out["engine_json"] = work, engine_json
        kept = True
    finally:
        for s in servers:
            s.kill()
        reset_storage()
        env.__exit__()
        if not kept:
            shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    out["n_events"] = n_events
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 12 cli loop: ML-1M shape, {n_events} events ({ML1M_EVENTS} "
        f"rate + {n_events - ML1M_EVENTS} buy; {ML1M_USERS} users x "
        f"{ML1M_ITEMS} items) written in {out['write_s']:.2f} s; pio import "
        f"(subprocess) {out['import_s']:.2f} s = "
        f"{n_events / out['import_s']:.0f} events/s; pio train rank {RANK}, "
        f"{TRAIN_ITERS} iterations (in-process) {out['train_s']:.2f} s, read "
        f"{out['read_ms']:.0f} ms; factors equal the memory store's train "
        f"by entity id (max |err| {out['factor_err']:.3g}, same numbering "
        f"{out['same_order']}); card {card}")
    log(f"phase 12 deploy: subprocess on {status['device']}, start to first "
        f"answer {out['deploy_to_first_s']:.2f} s; {CLI_QUERIES} "
        f"/queries.json p50 {out['p50_ms']:.2f} ms (server "
        f"{out['server_p50_ms']:.2f} ms), each equal to the plain top-k of "
        f"the persisted factors (max |score err| {out['query_err']:.3g}); "
        f"fold-in of 2 unseen users imported by another process: first "
        f"query {out['fold_first_ms']:.2f} ms (the larger), answers equal "
        f"the plain top-k of fold_in's vector (max |err| "
        f"{out['fold_err']:.3g}); a second deploy answered from the shared "
        f"KV {json.dumps(out['fold_counts'])}; both exited 0 on POST /stop; "
        f"card {card}")
    log(f"phase 12 batchpredict+eval: batchpredict {CLI_QUERIES} queries "
        f"in {out['batch_s']:.2f} s = {CLI_QUERIES / out['batch_s']:.1f} "
        f"recs/s (wall of the verb, model load included), lines equal the "
        f"deploy's answers; pio eval (2 candidates, rank {RANK}, 5 "
        f"iterations, evalK 2) {out['eval_s']:.2f} s, scores "
        f"{out['eval_scores']}; K3 at B 1,024 max |err| "
        f"{out['eval_batch_err']:.3g}; launches {json.dumps(launches)}; "
        f"phase 12 in {out['phase_s']:.1f} s; card {card}")
    return out


# Phase 13: the three aggregate_properties templates, each trained by
# `pio train` from its shipped engine.json with the port's engineFactory,
# at phase 12's MovieLens-1M shape (the events written in-process
# through the storage API: phase 12 times the import).
TPL_QUERIES = 64
TPL_GENRES = ("Action", "Adventure", "Animation", "Children's", "Comedy",
              "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir",
              "Horror", "Musical", "Mystery", "Romance", "Sci-Fi",
              "Thriller", "War", "Western")    # MovieLens-1M's 18 genres
TPL_BUY_WEIGHT = 5.0        # the ecommerce datasource's buyWeight
TPL_SEEN = 512              # the newest seen events the ecommerce rule reads
CLS_USERS, CLS_UNSET = 100_000, 40
CLS_APP, CLS_EVAL_K = "MyApp2", 3
NEAR_TIE = 1e-3   # a plain top-two margin under this may flip between the
                  # card's float32 and numpy's float64


def cls_eval_params():
    """``pio eval``'s candidates in phase 13 (the CLI loads this by
    name): the classification template's default generator."""
    from predictionio_tpu_torch.templates.classification.evaluation \
        import default_params_generator

    return default_params_generator(app_name=CLS_APP, eval_k=CLS_EVAL_K)


def tpl_engine_json(work: str, template: str, **changes) -> str:
    """The shipped examples/<template>/engine.json with the port's
    engineFactory (and ``changes`` at its top level), written to
    ``work``; its path."""
    root = Path(__file__).resolve().parent
    spec = json.loads((root / "examples" / template /
                       "engine.json").read_text())
    spec["engineFactory"] = \
        f"predictionio_tpu_torch.templates.{template}:engine"
    spec.update(changes)
    path = os.path.join(work, f"{template}-{spec['id']}.json")
    Path(path).write_text(json.dumps(spec))
    return path


def tpl_write(storage, app: str, rows, start_us: int):
    """Create ``app`` if it is new and write ``rows`` — (event, entity
    type, entity id, target item or None, properties) — through the
    port's columnar insert, one second apart from ``start_us``.  Returns
    the app id and the seconds the insert took."""
    from predictionio_tpu_torch.data.storage import App

    apps = storage.get_apps()
    found = apps.get_by_name(app)
    app_id = found.id if found else apps.insert(App(id=None, name=app))
    storage.get_events().init(app_id)
    stamps = [start_us + n * 1_000_000 for n in range(len(rows))]
    cols = {name: [row[j] for row in rows] for j, name in enumerate(
        ("event", "entity_type", "entity_id", "target_entity_id",
         "properties"))}
    cols["target_entity_type"] = ["item" if t else None
                                  for t in cols["target_entity_id"]]
    cols["event_time_us"] = cols["creation_time_us"] = stamps
    t0 = time.perf_counter()
    storage.get_events().insert_columnar(cols, app_id)
    return app_id, time.perf_counter() - t0


def tpl_catalog(rng):
    """A $set of 1-3 genres on every item, then an $unset of 5 items'
    genres and a $delete of 5 other items: (the events, each item's
    genres as aggregation must leave them)."""
    cats, rows = {}, []
    for i in range(ML1M_ITEMS):
        g = [TPL_GENRES[j] for j in sorted(rng.choice(
            len(TPL_GENRES), int(rng.integers(1, 4)), replace=False))]
        cats[f"i{i}"] = set(g)
        rows.append(("$set", "item", f"i{i}", None, {"categories": g}))
    picked = rng.choice(ML1M_ITEMS, 10, replace=False).tolist()
    for i in picked[:5]:
        rows.append(("$unset", "item", f"i{i}", None, {"categories": None}))
        del cats[f"i{i}"]
    for i in picked[5:]:
        rows.append(("$delete", "item", f"i{i}", None, {}))
        del cats[f"i{i}"]
    return rows, cats


def tpl_queries(rng, pool, n: int, key: str):
    """``n`` queries — 1-3 items of ``pool`` under "items", or one name
    of it under "user" — a third with categories, some with a whiteList
    of a twelfth of the items or a blackList of 20."""
    items = [f"i{i}" for i in range(ML1M_ITEMS)]
    out = []
    for k in range(n):
        if key == "items":
            q = {"items": [pool[j] for j in rng.choice(
                len(pool), int(rng.integers(1, 4)), replace=False)]}
        else:
            q = {"user": pool[int(rng.integers(len(pool)))]}
        q["num"] = int(rng.choice([1, 5, 10, 50]))
        if k % 3 == 0:
            q["categories"] = [TPL_GENRES[j] for j in rng.choice(
                len(TPL_GENRES), 2, replace=False)]
        if k % 5 == 1:
            q["whiteList"] = [items[j] for j in rng.choice(
                len(items), ML1M_ITEMS // 12, replace=False)]
        if k % 4 == 2:
            q["blackList"] = [items[j] for j in rng.choice(
                len(items), 20, replace=False)]
        out.append(q)
    return out


def tpl_mask(q, index, cats, also=()):
    """The phase's own exclude row for query ``q`` over the model's item
    numbering ``index``: the items of ``also``, the items sharing no
    genre with ``categories``, the items off a whiteList, the
    blackList."""
    import numpy as np

    inv = index.inverse
    ex = np.zeros(len(index), bool)
    for name in list(also) + list(q.get("blackList") or ()):
        if name in index:
            ex[index[name]] = True
    if q.get("categories") is not None:
        want = set(q["categories"])
        ex |= np.array([not (cats.get(inv[j], set()) & want)
                        for j in range(len(index))])
    if q.get("whiteList") is not None:
        off = np.ones(len(index), bool)
        off[[index[t] for t in q["whiteList"] if t in index]] = False
        ex |= off
    return ex


def hold_answer(ans, index, scores, exclude, num: int, what: str,
                topk_mismatch, rtol=RTOL, atol=ATOL) -> float:
    """Hold one /queries.json answer against the plain top-``num`` of a
    float64 score row with ``exclude`` dropped (ids equal except within
    a tie at the edge); returns the largest score error."""
    import numpy as np

    s = np.where(exclude, -np.inf, scores)
    order = np.argsort(-s, kind="stable")
    live = order[np.isfinite(s[order])]
    k = min(num, len(live))
    hits = ans["itemScores"]
    if len(hits) != k:
        die(f"{what}: {len(hits)} items, the plain answer has {k}")
    ref_i, ref_s = live[:k], s[live[:k]]
    nxt = [s[live[k]]] if len(live) > k else None
    got_s = np.array([h["score"] for h in hits])
    why = topk_mismatch([got_s], [[index[h["item"]] for h in hits]],
                        [ref_s], [ref_i], nxt, rtol=rtol, atol=atol)
    if why is not None:
        die(f"{what}: {why}")
    return float(np.max(np.abs(got_s - ref_s))) if k else 0.0


def tpl_serve(base: str, queries):
    """Each query through /queries.json: (answers, client seconds)."""
    answers, lats = [], []
    for q in queries:
        t0 = time.perf_counter()
        ans, _ = post_json(f"{base}/queries.json", q)
        lats.append(time.perf_counter() - t0)
        answers.append(ans)
    return answers, lats


def p50_ms(lats) -> float:
    return sorted(lats)[len(lats) // 2] * 1e3


def metric_value(registry, name: str, **labels) -> float:
    """A counter's value in the port's registry (0 before it exists)."""
    m = registry.get(name)
    return 0.0 if m is None else m.value(**labels)


def tpl_train(mods, engine_json: str, cli_dev) -> dict:
    """``pio train`` in-process through the CLI's main, the K1/K2 counts
    set to 0 just before and read just after: its wall time, its
    train.datasource read and the launches."""
    fg, rs, pio = mods["fg"], mods["rs"], mods["pio"]
    reg = mods["get_registry"]()

    def read_ms() -> float:
        h = reg.get("pio_train_phase_ms")
        return 0.0 if h is None else h.sum(phase="train.datasource")

    before = read_ms()
    fg.LAUNCHES = 0                       # main path starts here
    rs.LU_LAUNCHES = 0
    t0 = time.perf_counter()
    if pio(["train", "--engine-json", engine_json, *cli_dev]) != 0:
        die(f"phase 13: pio train --engine-json {engine_json} failed")
    return {"train_s": time.perf_counter() - t0,
            "launches": {"fused_gram": fg.LAUNCHES,   # main path ends here
                         "ridge_solve_lu": rs.LU_LAUNCHES},
            "read_ms": read_ms() - before}


def tpl_load(mods, engine_json: str, storage, dev):
    """(engine, variant, model) of the latest COMPLETED instance of
    ``engine_json``'s variant."""
    from predictionio_tpu_torch.controller import load_engine_factory
    from predictionio_tpu_torch.version import __version__
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    variant = mods["EngineVariant"].from_file(engine_json)
    eng = load_engine_factory(variant.engine_factory)()
    inst = storage.get_engine_instances().get_latest_completed(
        variant.engine_factory, __version__, variant.variant_id)
    if inst is None:
        die(f"phase 13: no COMPLETED instance of {engine_json}")
    [model] = load_models(eng, inst, mods["RuntimeContext"](
        storage=storage, device=dev))
    return eng, variant, model


def templates_phase(dev, seed: int, mods: dict, card: str) -> dict:
    """Phase 13: similarproduct, ecommerce and classification, each
    trained by ``pio train`` from its shipped engine.json (the port's
    engineFactory) on the default sqlite + localfs storage of a fresh
    PIO_HOME, served, and held against plain answers.  Returns each
    part's numbers and the K1/K2 launches of the two ALS trains."""
    import logging

    import numpy as np

    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage

    logging.basicConfig(level=logging.WARNING)
    work = tempfile.mkdtemp(prefix="pio_chip_tpl_")
    env = cli_env(os.path.join(work, "home"))
    env.values["PIO_RETRIEVAL_RUNG"] = None      # the router's own choice
    cli_dev = [] if dev.type == "cuda" else ["--device", "cpu"]
    out = {}
    phase_t0 = time.perf_counter()
    env.__enter__()
    reset_storage()
    try:
        users, items, stars, _ = ml1m_events(seed)
        events = (users, items, np.isnan(stars))
        start_us = int((time.time() - 40 * 86400) * 1e6)
        rng = np.random.default_rng(seed + 13)
        storage = get_storage()
        args = (dev, rng, storage, start_us, work, cli_dev, mods, card)
        out["similarproduct"] = tpl_similarproduct(events, *args)
        out["ecommerce"] = tpl_ecommerce(events, *args)
        out["classification"] = tpl_classification(*args)
    finally:
        reset_storage()
        env.__exit__()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {
        name: sum(out[t]["launches"][name]
                  for t in ("similarproduct", "ecommerce"))
        for name in ("fused_gram", "ridge_solve_lu")}
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 13 templates: K1/K2 launches of the two ALS trains "
        f"{json.dumps(out['launches'])}; phase 13 in "
        f"{out['phase_s']:.1f} s; card {card}")
    return out


def tpl_similarproduct(events, dev, rng, storage, start_us, work, cli_dev,
                       mods, card) -> dict:
    """13a: views + item genres → pio train → item factors held by entity
    id against run_train on a MEMORY store → 64 /queries.json under the
    router's choice and on the chunked rung, each held against the plain
    masked top-k of the persisted factors → fold-in of two unseen
    items."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.store import EventStore
    from predictionio_tpu_torch.models.als import fold_in
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    users, items, _ = events
    app = "MyApp3"
    catalog, cats = tpl_catalog(rng)
    rows = [("view", "user", f"u{u}", f"i{i}", {})
            for u, i in zip(users.tolist(), items.tolist())] + catalog
    _, write_s = tpl_write(storage, app, rows, start_us)
    engine_json = tpl_engine_json(work, "similarproduct")
    out = tpl_train(mods, engine_json, cli_dev)
    for name, n in out["launches"].items():
        if n == 0:
            die(f"phase 13a: pio train never launched {name}")
    eng, variant, model = tpl_load(mods, engine_json, storage, dev)
    # the same rows, in the same order, in a MEMORY store
    mem = mods["memory_storage"](os.path.join(work, "mem"))
    tpl_write(mem, app, rows, start_us)
    mid = mods["run_train"](eng, variant, mods["RuntimeContext"].create(
        storage=mem, device=dev))
    [mw] = load_models(eng, mem.get_engine_instances().get(mid),
                       mods["RuntimeContext"](storage=mem, device=dev))
    if sorted(mw.item_index.keys()) != sorted(model.item_index.keys()):
        die("phase 13a: the sqlite and memory trains saw other items")
    w = torch.from_numpy(np.ascontiguousarray(
        mw.item_factors[[mw.item_index[k] for k in model.item_index]]))
    out["factor_err"] = assert_close(
        torch.from_numpy(model.item_factors), w, TRAIN_RTOL,
        scaled(TRAIN_ATOL, w), "phase 13a: item factors, sqlite train vs "
        "memory train")

    def aggregated(st):
        return {k: (dict(v), v.first_updated, v.last_updated) for k, v in
                EventStore(st).aggregate_properties(app, "item").items()}

    agg = aggregated(storage)
    if agg != aggregated(mem) or {k: set(v[0]["categories"])
                                  for k, v in agg.items()
                                  if v[0].get("categories")} != cats \
            or model.item_categories != cats:
        die("phase 13a: aggregate_properties differs between the stores, "
            "or from the genres written")
    del mem, mw
    server = mods["EngineServer"](eng, variant, storage, host="127.0.0.1",
                                  port=0, device=dev)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        index = model.item_index
        queries = tpl_queries(rng, list(index.keys()), TPL_QUERIES, "items")
        f64 = model.item_factors.astype(np.float64)
        reg = mods["get_registry"]()
        err, out["p50_ms"], out["rungs"] = 0.0, {}, {}
        for rung in ("auto", "chunked"):
            # The same queries on another rung: the result cache's key
            # does not hold the rung, so empty it or the second round
            # would be all hits and never reach the retrieval.
            server.result_cache.clear()
            before = {r: metric_value(reg, "pio_retrieval_requests_total",
                                      rung=r, corpus="similarproduct")
                      for r in ("host", "device", "chunked")}
            with env_vars(PIO_RETRIEVAL_RUNG=None if rung == "auto"
                          else rung):
                answers, lats = tpl_serve(base, queries)
            out["p50_ms"][rung] = p50_ms(lats)
            out["rungs"][rung] = {
                r: metric_value(reg, "pio_retrieval_requests_total", rung=r,
                                corpus="similarproduct") - n
                for r, n in before.items()}
            for q, ans in zip(queries, answers):
                qv = f64[[index[t] for t in q["items"]]].sum(axis=0)
                err = max(err, hold_answer(
                    ans, index, f64 @ qv,
                    tpl_mask(q, index, cats, q["items"]), q["num"],
                    f"phase 13a ({rung}) {q}", mods["topk_mismatch"]))
        if out["rungs"]["chunked"]["chunked"] != TPL_QUERIES:
            die(f"phase 13a: rungs served {out['rungs']}")
        out["err"] = err
        # fold-in: 8 views each of two items this generation never saw
        inv_u = model.user_index.inverse
        viewers = {f"new{j}": rng.choice(len(inv_u), 8, replace=False)
                   for j in range(2)}
        tpl_write(storage, app, [
            ("view", "user", inv_u[int(u)], item, {})
            for item, who in viewers.items() for u in who],
            int((time.time() - 3600) * 1e6))
        before = {r: metric_value(reg, "pio_fold_in_items_total", result=r)
                  for r in ("solved", "cached")}
        hits_before = metric_value(reg, "pio_result_cache_hits_total",
                                   tier="local")
        uf = model.user_factors
        uty = uf.astype(np.float64).T @ uf.astype(np.float64)
        ferr, fold_lats = 0.0, []
        for item, who in viewers.items():
            vec = fold_in(uf, who, np.ones(len(who), np.float32),
                          reg=model.reg, alpha=model.alpha, implicit=True,
                          yty=uty).astype(np.float64)
            vec /= max(float(np.linalg.norm(vec)), 1e-9)
            [ans], lat = tpl_serve(base, [{"items": [item], "num": 10}])
            fold_lats += lat
            ferr = max(ferr, hold_answer(
                ans, index, f64 @ vec, np.zeros(len(index), bool), 10,
                f"phase 13a fold-in {item}", mods["topk_mismatch"]))
        # The repeat is a result-cache hit and never reaches the fold-in;
        # another num is another cache key, which the fold-in cache
        # answers.
        tpl_serve(base, [{"items": ["new0"], "num": 10}])
        tpl_serve(base, [{"items": ["new0"], "num": 5}])
        counts = {r: metric_value(reg, "pio_fold_in_items_total",
                                  result=r) - n
                  for r, n in before.items()}
        hits = metric_value(reg, "pio_result_cache_hits_total",
                            tier="local") - hits_before
        if counts != {"solved": 2, "cached": 1} or hits != 1:
            die(f"phase 13a: pio_fold_in_items_total {counts}, result-"
                f"cache hits {hits}")
        out["fold_err"], out["fold_counts"] = ferr, counts
        out["fold_first_ms"] = max(fold_lats) * 1e3
    finally:
        server.stop()
    out["write_s"] = write_s
    log(f"phase 13a similarproduct: {len(users)} views + {len(catalog)} "
        f"item $set/$unset/$delete written in {write_s:.2f} s; pio train "
        f"(shipped engine.json: rank 10, 20 iterations, alpha 10) "
        f"{out['train_s']:.2f} s, read {out['read_ms']:.0f} ms, launches "
        f"{json.dumps(out['launches'])}; item factors equal the memory "
        f"store's train by entity id (max |err| {out['factor_err']:.3g}); "
        f"aggregate_properties equal on both stores; {TPL_QUERIES} "
        f"/queries.json p50 {json.dumps(out['p50_ms'])} ms, rungs "
        f"{json.dumps(out['rungs'])}, each equal to the plain masked top-k "
        f"of the persisted factors (max |err| {err:.3g}); fold-in of 2 "
        f"unseen items (max |err| {ferr:.3g}, first "
        f"{out['fold_first_ms']:.2f} ms) {json.dumps(counts)}; card {card}")
    return out


def tpl_ecommerce(events, dev, rng, storage, start_us, work, cli_dev, mods,
                  card) -> dict:
    """13b: views, buys, item genres and two unavailable lists → pio
    train → pio deploy (a subprocess on the card) → 64 /queries.json of
    known users and 4 of unknown ones, each held against the plain
    answer (persisted factors, the phase's own seen and unavailable
    lists; popularity for the unknown) → a newer unavailable list from
    another process, excluded without a redeploy → POST /stop."""
    import numpy as np

    users, items, buys = events
    app = "MyApp4"
    catalog, cats = tpl_catalog(rng)
    lists = [sorted(f"i{i}" for i in rng.choice(ML1M_ITEMS, 40,
                                                replace=False))
             for _ in range(2)]
    rows = [("buy" if b else "view", "user", f"u{u}", f"i{i}", {})
            for u, i, b in zip(users.tolist(), items.tolist(),
                               buys.tolist())] + catalog + [
        ("$set", "constraint", "unavailableItems", None, {"items": lst})
        for lst in lists]
    app_id, write_s = tpl_write(storage, app, rows, start_us)
    engine_json = tpl_engine_json(work, "ecommerce")
    out = tpl_train(mods, engine_json, cli_dev)
    for name, n in out["launches"].items():
        if n == 0:
            die(f"phase 13b: pio train never launched {name}")
    _, _, model = tpl_load(mods, engine_json, storage, dev)
    index, uindex = model.item_index, model.user_index
    itf = model.item_factors.astype(np.float64)
    # the plain answer's inputs, from the phase's own event lists
    order = np.argsort(users, kind="stable")
    bounds = np.searchsorted(users[order], np.arange(ML1M_USERS + 1))
    weights = np.where(buys, TPL_BUY_WEIGHT, 1.0)
    counts = np.bincount(items, weights=weights, minlength=ML1M_ITEMS)
    popular = np.array([counts[int(index.inverse[j][1:])]
                        for j in range(len(index))])

    def plain(q, unavailable):
        user = q["user"]
        seen = set()
        if user in uindex:
            u = int(user[1:])
            mine = order[bounds[u]:bounds[u + 1]][-TPL_SEEN:]
            seen = {f"i{i}" for i in items[mine].tolist()}
            scores = itf @ model.user_factors[uindex[user]].astype(
                np.float64)
        else:
            scores = popular
        return scores, tpl_mask(q, index, cats, seen | set(unavailable))

    queries = tpl_queries(rng, list(uindex.keys()), TPL_QUERIES, "user") \
        + [{"user": f"visitor{j}", "num": n, **extra} for j, (n, extra) in
           enumerate(((10, {}), (5, {"categories": ["Drama"]}),
                      (50, {"blackList": ["i0", "i1"]}), (1, {})))]
    # F7: the result cache stays on (its default).  Ecommerce reads the
    # unavailable list and seen items live, so its algorithm declares
    # reads_live_state and the server keeps no cached answer for it: the
    # newer list below must be served although queries[0] repeats.
    with env_vars(PIO_RESULT_CACHE=None):
        server = deployed(engine_json, os.path.join(work, "deploy_ec.log"),
                          cli_dev, phase="phase 13b")
    try:
        status = json.loads(server.get("/"))
        if not status["device"].startswith(dev.type):
            die(f"phase 13b: pio deploy reports {status}")
        if not status["resultCache"]["enabled"]:
            die(f"phase 13b: the result cache is off: {status}")
        t0 = time.perf_counter()
        answers, lats = tpl_serve(server.base, queries)
        out["deploy_to_first_s"] = t0 + lats[0] - server.started_s
        err = 0.0
        for q, ans in zip(queries, answers):
            scores, mask = plain(q, lists[-1])
            # popularity scores are counts: held exactly
            tol = RTOL if q["user"] in uindex else 0.0
            err = max(err, hold_answer(
                ans, index, scores, mask, q["num"], f"phase 13b {q}",
                mods["topk_mismatch"], rtol=tol, atol=tol))
        # another process writes a newer list: the next answer excludes
        # it without a redeploy
        newer = [h["item"] for h in answers[0]["itemScores"][:3]]
        path = os.path.join(work, "unavailable.jsonl")
        Path(path).write_text(json.dumps({
            "event": "$set", "entityType": "constraint",
            "entityId": "unavailableItems",
            "properties": {"items": newer}}) + "\n")
        run_cli("import", "--appid", str(app_id), "--input", path,
                phase="phase 13b")
        [again], _ = tpl_serve(server.base, [queries[0]])
        if {h["item"] for h in again["itemScores"]} & set(newer):
            die(f"phase 13b: the newer unavailable list {newer} was served")
        scores, mask = plain(queries[0], newer)
        err = max(err, hold_answer(again, index, scores, mask,
                                   queries[0]["num"], "phase 13b newer list",
                                   mods["topk_mismatch"]))
        cache = json.loads(server.get("/"))["resultCache"]
        if cache["entries"] or cache["hits"]:
            die(f"phase 13b: the result cache kept ecommerce answers: "
                f"{cache}")
        server.stop()
    except BaseException:
        server.kill()
        raise
    out.update(write_s=write_s, err=err, p50_ms=p50_ms(lats),
               device=status["device"])
    log(f"phase 13b ecommerce: {len(users)} view/buy events + "
        f"{len(catalog)} item $set/$unset/$delete + 2 unavailable lists "
        f"written in {write_s:.2f} s; pio train (shipped engine.json: rank "
        f"10, 20 iterations, alpha 10) {out['train_s']:.2f} s, read "
        f"{out['read_ms']:.0f} ms, launches {json.dumps(out['launches'])}; "
        f"pio deploy (subprocess on {status['device']}) start to first "
        f"answer {out['deploy_to_first_s']:.2f} s; {len(queries)} "
        f"/queries.json ({TPL_QUERIES} known users, 4 unknown) p50 "
        f"{out['p50_ms']:.2f} ms, each equal to the plain answer (seen: "
        f"newest {TPL_SEEN}; latest unavailable list; popularity for the "
        f"unknown; max |err| {err:.3g}); a newer list from another process "
        f"excluded without a redeploy, with the result cache on (0 entries "
        f"kept: reads_live_state); exit 0 on POST /stop; card {card}")
    return out


def tpl_classification(dev, rng, storage, start_us, work, cli_dev, mods,
                       card) -> dict:
    """13c: 100,000 users' $set attributes and plan (a few plans
    $unset later) → pio train naive (shipped) and lr (maxIter 200) →
    64 /queries.json per model, each equal to the plain numpy prediction
    of the persisted model → pio eval, its accuracy equal to a plain
    recount."""
    import numpy as np

    labels = rng.integers(0, 4, CLS_USERS)
    attrs = rng.poisson(1.0 + 4.0 * np.eye(4, 3)[labels]).astype(float)
    unset = rng.choice(CLS_USERS, CLS_UNSET, replace=False)
    rows = [("$set", "user", f"c{j}", None,
             {"attr0": a[0], "attr1": a[1], "attr2": a[2],
              "plan": float(lbl)})
            for j, (a, lbl) in enumerate(zip(attrs.tolist(),
                                              labels.tolist()))]
    rows += [("$unset", "user", f"c{j}", None, {"plan": None})
             for j in unset.tolist()]
    _, write_s = tpl_write(storage, CLS_APP, rows, start_us)
    out = {"write_s": write_s}
    queries = [{f"attr{d}": float(v) for d, v in enumerate(row)}
               for row in rng.integers(0, 8, (TPL_QUERIES, 3)).tolist()]
    qx = np.array([[q[f"attr{d}"] for d in range(3)] for q in queries])
    for name, changes in (
            ("naive", {}),
            ("lr", {"id": "lr", "algorithms": [
                {"name": "lr", "params": {"maxIter": 200}}]})):
        engine_json = tpl_engine_json(work, "classification", **changes)
        out[name] = tpl_train(mods, engine_json, cli_dev)
        eng, variant, wrapper = tpl_load(mods, engine_json, storage, dev)
        m = {k: (v.cpu().double().numpy()
                 if hasattr(v, "cpu") else v)
             for k, v in vars(wrapper.model).items()}
        if name == "naive":
            plain = m["class_log_prior"] + qx @ m["feature_log_prob"].T
        else:
            z = ((qx - m["mean"]) / m["scale"]) @ m["weights"] + m["bias"]
            plain = np.exp(z - z.max(1, keepdims=True))
            plain /= plain.sum(1, keepdims=True)
        server = mods["EngineServer"](eng, variant, storage,
                                      host="127.0.0.1", port=0, device=dev)
        server.start()
        try:
            answers, lats = tpl_serve(f"http://127.0.0.1:{server.port}",
                                      queries)
        finally:
            server.stop()
        top2 = np.sort(plain, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > NEAR_TIE
        want = wrapper.classes[plain.argmax(1)]
        got = np.array([a["label"] for a in answers])
        if (got[clear] != want[clear]).any() or clear.sum() < 0.9 * len(got):
            die(f"phase 13c {name}: labels {got.tolist()} vs plain "
                f"{want.tolist()} (clear {clear.sum()})")
        out[name].update(p50_ms=p50_ms(lats), clear=int(clear.sum()))
    # pio eval, and its accuracy recounted with a plain float64 NB
    eval_json = os.path.join(work, "cls_eval.json")
    t0 = time.perf_counter()
    if mods["pio"](["eval", "predictionio_tpu_torch.templates."
                    "classification.evaluation:evaluation",
                    "chip_smoke:cls_eval_params", "--output-json",
                    eval_json, *cli_dev]) != 0:
        die("phase 13c: pio eval failed")
    out["eval_s"] = time.perf_counter() - t0
    scores = [c["score"] for c in json.loads(
        Path(eval_json).read_text())["candidates"]]
    keep = np.ones(CLS_USERS, bool)
    keep[unset] = False
    ids = np.flatnonzero(keep)
    ids = ids[np.argsort([f"c{j}" for j in ids])]   # entity-id order
    x, y = attrs[ids], labels[ids]
    fold_of = np.random.default_rng(3).integers(0, CLS_EVAL_K, len(y))
    recount, near = [], []
    for lam in (0.5, 1.0, 5.0):
        right = ties = 0
        for k in range(CLS_EVAL_K):
            tr, te = fold_of != k, fold_of == k
            onehot = np.eye(4)[y[tr]]
            cc = onehot.sum(0)
            feat = onehot.T @ x[tr] + lam
            lp = (np.log(cc) - np.log(cc.sum()))[None, :] + x[te] @ (
                np.log(feat) - np.log(feat.sum(1, keepdims=True))).T
            right += int((lp.argmax(1) == y[te]).sum())
            t2 = np.sort(lp, axis=1)[:, -2:]
            ties += int((t2[:, 1] - t2[:, 0] <= NEAR_TIE).sum())
        recount.append(right / len(y))
        near.append(ties)
    for got, want, ties in zip(scores, recount, near):
        if abs(got - want) * len(y) > ties + 1e-6:
            die(f"phase 13c: eval accuracy {scores} vs plain recount "
                f"{recount} (near ties {near})")
    out.update(eval_scores=scores, recount=recount, near_ties=near)
    log(f"phase 13c classification: {CLS_USERS} users' $set + "
        f"{CLS_UNSET} $unset of plan written in {write_s:.2f} s; pio train "
        f"naive (shipped engine.json) {out['naive']['train_s']:.2f} s "
        f"(read {out['naive']['read_ms']:.0f} ms), lr maxIter 200 "
        f"{out['lr']['train_s']:.2f} s (read {out['lr']['read_ms']:.0f} "
        f"ms); {TPL_QUERIES} /queries.json each, p50 naive "
        f"{out['naive']['p50_ms']:.2f} ms / lr {out['lr']['p50_ms']:.2f} "
        f"ms, labels equal the plain prediction of the persisted model "
        f"({out['naive']['clear']} / {out['lr']['clear']} of "
        f"{TPL_QUERIES} clear of a {NEAR_TIE} margin); pio eval (evalK "
        f"{CLS_EVAL_K}, 3 candidates) {out['eval_s']:.2f} s, accuracy "
        f"{scores} = plain recount {recount} (near ties {near}); card "
        f"{card}")
    return out


# Phase 14: the event server — every event of phase 12's MovieLens-1M
# shape posted by the SDK to `pio eventserver` in batches of the
# reference's cap, then trained and served from what it stored.
ES_APP = "chipes"
ES_THREADS = 8            # client threads, each a contiguous share
ES_BATCH = 50             # the reference's cap of /batch/events.json
ES_REPLAYED = 3           # batches posted again under their tokens
ES_EVENTS = 300_000       # phase 12's first events (all of ~30 % of its
                          # users): cut from 1,000,209 for the time limit


def es_batch(users, items, stars, times, lo: int, hi: int):
    """Events [lo, hi) of ``ml1m_events``'s columns as event JSON."""
    out = []
    for u, i, r, t in zip(users[lo:hi].tolist(), items[lo:hi].tolist(),
                          stars[lo:hi].tolist(), times[lo:hi].tolist()):
        ev = {"event": "buy" if r != r else "rate", "entityType": "user",
              "entityId": f"u{u}", "targetEntityType": "item",
              "targetEntityId": f"i{i}", "eventTime": t + "Z"}
        if r == r:
            ev["properties"] = {"rating": r}
        out.append(ev)
    return out


class eventserver_proc:
    """``pio eventserver --port 0`` in a subprocess (``extra``: more of
    its arguments); ``drain()`` sends SIGTERM, which must end it with
    exit 0."""

    def __init__(self, log_path: str, extra=(), phase: str = "phase 14"):
        import re
        import select

        self.phase = phase
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli",
             "eventserver", "--ip", "127.0.0.1", "--port", "0", *extra],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=self.log, text=True)
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    CLI_TIMEOUT_S)
        line = self.proc.stdout.readline() if ready else ""
        m = re.search(r"listening on 127\.0\.0\.1:(\d+) ", line)
        if not m:
            self.kill()
            die(f"{phase}: pio eventserver did not start ({line!r}): "
                f"{Path(log_path).read_text()[-2000:]}")
        self.base = f"http://127.0.0.1:{m.group(1)}"

    def get(self, path: str):
        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return json.loads(r.read())

    def drain(self) -> None:
        import signal

        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=120)
        self.proc.stdout.close()
        self.log.close()
        if rc != 0:
            die(f"{self.phase}: pio eventserver exited {rc} after SIGTERM")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.proc.stdout.close()
        self.log.close()


def es_ingest(base: str, key: str, cols, n: int, phase: str = "phase 14"):
    """Every event through ``sdk.EventClient.create_events`` in batches
    of ``ES_BATCH``, ``ES_THREADS`` threads each posting a contiguous
    share, each batch under a token of its own; every item must answer
    201 with the id its token derives.  Returns (wall s, per-batch
    client latencies, the batches as (token, lo, hi, ids))."""
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.sdk import EventClient

    bounds = [n * t // ES_THREADS for t in range(ES_THREADS + 1)]

    def share(t: int):
        client = EventClient(key, base, timeout=120)
        lats, done = [], []
        for j, lo in enumerate(range(bounds[t], bounds[t + 1], ES_BATCH)):
            hi = min(lo + ES_BATCH, bounds[t + 1])
            token = f"s{t}b{j}"
            batch = es_batch(*cols, lo, hi)
            t0 = time.perf_counter()
            res = client.create_events(batch, batch_token=token)
            lats.append(time.perf_counter() - t0)
            ids = [r.event_id for r in res]
            if [r.status for r in res] != [201] * len(batch) or \
                    ids != [f"bt{token}.{k}" for k in range(len(batch))]:
                die(f"{phase}: batch {token} answered "
                    f"{[(r.status, str(r)) for r in res][:3]}...")
            done.append((token, lo, hi, ids))
        return lats, done

    t0 = time.perf_counter()
    with ThreadPoolExecutor(ES_THREADS) as pool:
        parts = list(pool.map(share, range(ES_THREADS)))
    wall = time.perf_counter() - t0
    lats = [x for p in parts for x in p[0]]
    batches = [x for p in parts for x in p[1]]
    return wall, lats, batches


def es_export_matches(path: str, cols, n: int,
                      phase: str = "phase 14") -> None:
    """`pio export`'s lines against the generated events, exactly, as a
    multiset of (event, entity, target, rating, eventTime)."""
    from collections import Counter

    users, items, stars, times = cols
    want = Counter(
        ("buy" if r != r else "rate", f"u{u}", f"i{i}",
         None if r != r else r, t)
        for u, i, r, t in zip(users.tolist(), items.tolist(),
                              stars.tolist(), times.tolist()))
    got = Counter()
    lines = 0
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            lines += 1
            t = e["eventTime"]
            if not t.endswith(".000+00:00"):
                die(f"{phase}: exported eventTime {t!r}")
            got[(e["event"], e["entityId"], e["targetEntityId"],
                 e.get("properties", {}).get("rating"),
                 t[:-len(".000+00:00")])] += 1
    if lines != n or got != want:
        extra = list((got - want).items())[:3]
        missing = list((want - got).items())[:3]
        die(f"{phase}: export has {lines} events against {n}; extra "
            f"{extra}, missing {missing}")


def eventserver_phase(dev, seed: int, mods: dict, card: str) -> dict:
    """Phase 14: `pio app new` and `pio eventserver` (subprocesses) →
    phase 12's first ES_EVENTS events posted by the port's SDK over HTTP →
    ``ES_REPLAYED`` batches posted again under their tokens → `pio
    export` held exactly against the generated events → `pio train`
    in-process (K1, K2) → `pio deploy` (a subprocess, K3 counted there)
    → 64 /queries.json against the plain top-k → SIGTERM drains the
    event server with exit 0.  Returns the phase's numbers and
    launches."""
    import logging
    import re

    import numpy as np
    import torch

    fg, rs, ft, pio = mods["fg"], mods["rs"], mods["ft"], mods["pio"]
    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.sdk import EventClient
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    logging.basicConfig(level=logging.WARNING)
    work = tempfile.mkdtemp(prefix="pio_chip_es_")
    env = cli_env(os.path.join(work, "home"))
    dev_args = [] if dev.type == "cuda" else ["--device", dev.type]
    out = {}
    procs = []
    phase_t0 = time.perf_counter()
    env.__enter__()
    reset_storage()
    try:
        # -- 1: app new, eventserver (subprocesses) ----------------------
        cols = tuple(c[:ES_EVENTS] for c in ml1m_events(seed))
        n = len(cols[0])
        said = run_cli("app", "new", ES_APP, phase="phase 14")
        key = re.search(r"Access Key: (\S+)", said).group(1)
        es = eventserver_proc(os.path.join(work, "eventserver.log"))
        procs.append(es)
        ready = es.get("/ready")
        if ready["status"] != "ready":
            die(f"phase 14: /ready answered {ready}")

        # -- 2: ingest over HTTP -----------------------------------------
        wall, lats, batches = es_ingest(es.base, key, cols, n)
        lats.sort()
        out["ingest_s"] = wall
        out["events_per_s"] = n / wall
        out["batch_p50_ms"] = lats[len(lats) // 2] * 1e3
        out["batch_p99_ms"] = lats[min(len(lats) - 1,
                                       int(len(lats) * 0.99))] * 1e3
        out["batches"] = len(batches)
        out["stats"] = es.get("/stats.json")

        # -- 3: three batches again under their tokens --------------------
        client = EventClient(key, es.base, timeout=120)
        for token, lo, hi, ids in (batches[0], batches[len(batches) // 2],
                                   batches[-1])[:ES_REPLAYED]:
            again = client.create_events(es_batch(*cols, lo, hi),
                                         batch_token=token)
            if [r.event_id for r in again] != ids or \
                    {r.status for r in again} != {201}:
                die(f"phase 14: the replay of {token} answered other ids")

        # -- 4: export, exactly the generated events ---------------------
        exported = os.path.join(work, "export.jsonl")
        t0 = time.perf_counter()
        said = run_cli("export", "--appid", "1", "--output", exported,
                       phase="phase 14")
        out["export_s"] = time.perf_counter() - t0
        if f"Exported {n} events" not in said:
            die(f"phase 14: export said {said!r}")
        es_export_matches(exported, cols, n)

        # -- 5: train in-process through the CLI ---------------------------
        spec = json.loads((Path(__file__).resolve().parent / "examples" /
                           "recommendation" / "engine.json").read_text())
        spec["engineFactory"] = CLI_FACTORY
        spec["datasource"]["params"]["appName"] = ES_APP
        spec["algorithms"][0]["params"].update(
            rank=RANK, numIterations=TRAIN_ITERS, seed=seed)
        engine_json = os.path.join(work, "engine.json")
        Path(engine_json).write_text(json.dumps(spec))
        fg.LAUNCHES = 0                      # main path starts here
        rs.LU_LAUNCHES = 0
        t0 = time.perf_counter()
        if pio(["train", "--engine-json", engine_json, *dev_args]) != 0:
            die("phase 14: pio train failed")
        out["train_s"] = time.perf_counter() - t0
        launches = {"fused_gram": fg.LAUNCHES,
                    "ridge_solve_lu": rs.LU_LAUNCHES}
        storage = get_storage()
        [inst] = storage.get_engine_instances().get_all()
        if inst.status != "COMPLETED":
            die(f"phase 14: instance {inst.id} is {inst.status}")
        [wrapper] = load_models(mods["engine"](), inst, mods[
            "RuntimeContext"](storage=storage, device=dev))
        uf, itf = wrapper.host_factors()
        want = ((len(np.unique(cols[0])), RANK), (len(np.unique(cols[1])),
                                                   RANK))
        if (uf.shape, itf.shape) != want:
            die(f"phase 14: trained {uf.shape} x {itf.shape}, not {want}")

        # -- 6: deploy (a subprocess), 64 /queries.json --------------------
        d = deployed(engine_json, os.path.join(work, "deploy.log"),
                     extra=dev_args, phase="phase 14")
        procs.append(d)
        if not d.device.startswith(dev.type):
            die(f"phase 14: deploy reports device {d.device}")
        rng = np.random.default_rng(seed + 141)
        names = list(wrapper.user_index.keys())
        asked = [names[j] for j in rng.choice(len(names), CLI_QUERIES,
                                              replace=False)]
        items_d = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
        qlats, qerr = [], 0.0
        for user in asked:
            t0 = time.perf_counter()
            ans, _ = post_json(f"{d.base}/queries.json",
                               {"user": user, "num": 10})
            qlats.append(time.perf_counter() - t0)
            hits = ans["itemScores"]
            if len(hits) != 10:
                die(f"phase 14: the answer for {user} has {len(hits)} "
                    "items")
            qerr = max(qerr, check_against_plain(
                [[h["score"] for h in hits]],
                [[wrapper.item_index[h["item"]] for h in hits]],
                torch.from_numpy(uf[[wrapper.user_index[user]]]).to(dev),
                items_d, 10, None, f"phase 14 /queries.json {user}", ft,
                mods["topk_mismatch"]))
        d.stop()
        procs.remove(d)
        launches["fused_topk"] = (d.launches or {}).get("fused_topk", 0)
        out["query_err"] = qerr
        out["p50_ms"] = sorted(qlats)[len(qlats) // 2] * 1e3

        # -- 7: SIGTERM drains the event server ----------------------------
        es.drain()
        procs.remove(es)
        for name, k in launches.items():    # main path ends here
            if k == 0:
                die(f"phase 14: {name} never launched")
    finally:
        for p in procs:
            p.kill()
        reset_storage()
        env.__exit__()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    out["n_events"] = n
    out["phase_s"] = time.perf_counter() - phase_t0
    st = out["stats"]
    log(f"phase 14 eventserver ingest: {n} events (the first of phase 12's "
        f"ML-1M events) posted by sdk.EventClient.create_events to `pio "
        f"eventserver` (a subprocess) in {out['batches']} batches of "
        f"{ES_BATCH} from {ES_THREADS} threads: {out['ingest_s']:.2f} s = "
        f"{out['events_per_s']:.0f} events/s; client p50 "
        f"{out['batch_p50_ms']:.2f} ms, p99 {out['batch_p99_ms']:.2f} ms a "
        f"batch; server /stats.json statusCounts "
        f"{json.dumps(st['statusCounts'])}, latency p50/p95/p99 "
        f"{st['latencyMs']['p50']:.2f}/{st['latencyMs']['p95']:.2f}/"
        f"{st['latencyMs']['p99']:.2f} ms; {ES_REPLAYED} batches posted "
        f"again under their tokens: same ids, and `pio export` "
        f"({out['export_s']:.2f} s) equals the generated events exactly "
        f"as a multiset ({n} events, 0 rows added); card {card}")
    log(f"phase 14 train+serve: pio train rank {RANK}, {TRAIN_ITERS} "
        f"iterations (in-process) {out['train_s']:.2f} s; pio deploy "
        f"(subprocess) {CLI_QUERIES} /queries.json p50 {out['p50_ms']:.2f} "
        f"ms, each equal to the plain top-k (max |score err| "
        f"{out['query_err']:.3g}); launches {json.dumps(launches)} (K3 "
        f"counted in the deploy process); SIGTERM drained the event "
        f"server with exit 0; phase 14 in {out['phase_s']:.1f} s; card "
        f"{card}")
    return out


# Phase 15: the serving scheduler — concurrent /queries.json coalesce
# into one K3 launch a cohort; the result cache; the native frontends.
SCHED_CLIENTS = 64        # client threads, each on a keep-alive connection
SCHED_PER_CLIENT = 32     # /queries.json each, every one for its own user
SCHED_INLINE = 256        # of those queries through the inline path
SCHED_NATIVE = 256        # ... and through `pio deploy --native`
SCHED_EVENTS = 100_000    # phase 12's first events via `eventserver --native`
SCHED_LIMIT_S = 120.0     # the phase's wall-time budget
SCHED_CLIENT_PROCS = 4    # client processes the client threads run in
SCHED_STAGES = ("ingress", "bind", "cache", "queue_wait", "batch_wait",
                "dispatch", "retrieval", "resume", "shed_check",
                "serialize")     # the waterfall's (obs.waterfall)


def sched_share(base: str, queries, clients: int, ready) -> dict:
    """In this process: ``clients`` threads, each posting its contiguous
    share of ``queries`` to ``/queries.json`` over one keep-alive
    connection.  ``ready()`` runs once every connection is open; the
    threads start when it returns.  Returns the 200 bodies (text) in
    query order, the client latencies (s), the server's
    ``X-PIO-Server-Ms`` (NaN where absent) and the start and end on the
    host's monotonic clock."""
    import http.client
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import urlparse

    u = urlparse(base)
    n = len(queries)
    bounds = [n * t // clients for t in range(clients + 1)]
    bodies, lats, server_ms = [None] * n, [0.0] * n, [math.nan] * n
    start = threading.Barrier(clients + 1)

    def share(t: int):
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
        conn.connect()
        start.wait()
        try:
            for j in range(bounds[t], bounds[t + 1]):
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json",
                             body=json.dumps(queries[j]).encode(),
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                lats[j] = time.perf_counter() - t0
                if r.status != 200:
                    die(f"phase 15: /queries.json {queries[j]} answered "
                        f"{r.status}: {data[:200]!r}")
                bodies[j] = data.decode("utf-8")
                server_ms[j] = float(r.getheader("X-PIO-Server-Ms") or "nan")
        finally:
            conn.close()

    with ThreadPoolExecutor(clients) as pool:
        done = [pool.submit(share, t) for t in range(clients)]
        ready()
        start.wait()
        t0 = time.monotonic()
        for f in done:
            f.result()
        t1 = time.monotonic()
    return {"bodies": bodies, "lats": lats, "server_ms": server_ms,
            "start": t0, "end": t1}


def sched_client(argv) -> None:
    """One client process of :func:`sched_drive` (base URL, query file,
    first and last query, threads): says ``ready`` once connected, starts
    on a line from its standard input, prints one JSON result line."""
    base, path, lo, hi, clients = argv
    queries = json.loads(Path(path).read_text())[int(lo):int(hi)]

    def ready():
        print("ready", flush=True)
        sys.stdin.readline()

    print(json.dumps(sched_share(base, queries, int(clients), ready)),
          flush=True)


def sched_drive(base: str, queries, clients: int, work: str,
                procs: int = SCHED_CLIENT_PROCS):
    """``clients`` threads spread over ``procs`` client processes — the
    load does not share the server's interpreter — each thread posting
    its contiguous share of ``queries`` over one keep-alive connection,
    all released together.  Returns the raw 200 bodies in query order,
    the client latencies (s), the servers' ``X-PIO-Server-Ms`` (NaN where
    absent) and the wall time from the release to the last answer."""
    procs = max(1, min(procs, clients))
    path = os.path.join(work, "sched_queries.json")
    Path(path).write_text(json.dumps(queries))
    n = len(queries)
    children = []
    for k in range(procs):
        lo, hi = n * k // procs, n * (k + 1) // procs
        c = clients * (k + 1) // procs - clients * k // procs
        children.append(subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.sched_client(sys.argv[1:])", base, path, str(lo),
             str(hi), str(c)], cwd=Path(__file__).resolve().parent,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
    try:
        for ch in children:
            if ch.stdout.readline().strip() != "ready":
                die("phase 15: a client process did not connect")
        for ch in children:
            ch.stdin.write("go\n")
            ch.stdin.flush()
        parts = []
        for ch in children:
            out, _ = ch.communicate(timeout=CLI_TIMEOUT_S)
            if ch.returncode != 0:
                die(f"phase 15: a client process exited {ch.returncode}")
            parts.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for ch in children:
            if ch.poll() is None:
                ch.kill()
                ch.wait(timeout=60)
    bodies = [b.encode("utf-8") for p_ in parts for b in p_["bodies"]]
    lats = [x for p_ in parts for x in p_["lats"]]
    server_ms = [x for p_ in parts for x in p_["server_ms"]]
    wall = max(p_["end"] for p_ in parts) - min(p_["start"] for p_ in parts)
    return bodies, lats, server_ms, wall


def pct(values, q: float) -> float:
    """The q-quantile of ``values`` (nearest rank, as the phases log)."""
    v = sorted(x for x in values if x == x)
    return v[min(len(v) - 1, int(q * len(v)))] if v else math.nan


def stage_cdf(registry, stage: str) -> tuple:
    """(counts ≤ each bucket bound, count, sum) of ``pio_serve_stage_ms``
    for one stage: exact at the bounds, so two readings' difference is
    the distribution of the requests in between."""
    h = registry.get("pio_serve_stage_ms")
    if h is None:
        return (), 0, 0.0
    return (tuple(h.count_le(b, stage=stage) for b in h.buckets),
            h.count(stage=stage), h.sum(stage=stage))


def stage_split(registry, before: dict) -> dict:
    """Per stage of the waterfall: (p50, p99, mean) ms of the requests
    since ``before`` (``{stage: stage_cdf(...)}``), the quantiles
    interpolated inside their bucket as the registry's own are."""
    h = registry.get("pio_serve_stage_ms")
    out = {}
    for stage, (cum0, n0, sum0) in before.items():
        cum1, n1, sum1 = stage_cdf(registry, stage)
        n = n1 - n0
        if n <= 0:
            continue
        cum = [a - (cum0[j] if cum0 else 0.0) for j, a in enumerate(cum1)]

        def q(p):
            target, lo, prev = p * n, 0.0, 0.0
            for b, c in zip(h.buckets, cum):
                if c >= target and c > prev:
                    return lo + (b - lo) * (target - prev) / (c - prev)
                lo, prev = b, c
            return h.buckets[-1]

        out[stage] = (round(q(0.5), 4), round(q(0.99), 4),
                      round((sum1 - sum0) / n, 4))
    return out


def scheduler_phase(dev, seed: int, users_np, items_np, mods: dict,
                    card: str) -> dict:
    """Phase 15: phase 4's ML-25M serving model persisted on the default
    sqlite + localfs storage and deployed on an EngineServer with the
    default SchedulerConfig on the chunked rung →
    SCHED_CLIENTS x SCHED_PER_CLIENT concurrent /queries.json for
    distinct users (coalesced: fewer dispatches than requests, K3
    launches = dispatches, each answer the plain top-k on the card) →
    the same queries again (2,048 byte-equal result-cache hits, no K3
    launch) → SCHED_INLINE through the inline path (batcher off: one K3
    launch a request) → `pio deploy --native` (a subprocess, K3 counted
    there) answering SCHED_NATIVE as the Python path did, POST /stop exit
    0 → `pio eventserver --native` taking SCHED_EVENTS of phase 12's
    events through the SDK, `pio export` equal to them, SIGTERM exit 0.
    Returns the phase's numbers and launches, and its store (``work``,
    ``home``, ``engine_json``, ``instance``: the persisted model) for
    phase 21."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.serving import SchedulerConfig

    ft, reg = mods["ft"], mods["get_registry"]()
    dev_args = () if dev.type == "cuda" else ("--device", dev.type)
    phase_t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pio_chip_sched_")
    env = cli_env(os.path.join(work, "home"))
    out = {}
    procs, servers = [], []
    env.__enter__()
    reset_storage()
    try:
        with env_vars(PIO_BATCH_ENABLED=None, PIO_QUEUE_DEPTH=None,
                      PIO_BATCH_WINDOW_MS=None, PIO_BATCH_WINDOW_MAX_MS=None,
                      PIO_BATCH_MAX=None, PIO_BATCH_AUTOTUNE=None,
                      PIO_BATCH_P99_TARGET_MS=None, PIO_RESULT_CACHE=None,
                      PIO_RESULT_CACHE_SIZE=None,
                      PIO_RESULT_CACHE_BYTES=None):
            cfg = SchedulerConfig.from_env()
        if (cfg.enabled, cfg.autotune, cfg.queue_depth, cfg.max_batch) != \
                (True, True, 128, 64):
            die(f"phase 15: the default SchedulerConfig is {cfg}")
        # -- 1: persist phase 4's model, deploy it ---------------------------
        eng = mods["engine"]()
        spec = json.loads((mods["csrc"].parent / "templates" /
                           "recommendation" / "engine.json").read_text())
        spec["algorithms"][0]["params"]["rank"] = RANK
        engine_json = os.path.join(work, "engine.json")
        Path(engine_json).write_text(json.dumps(spec))
        variant = mods["EngineVariant"].from_dict(spec)
        storage = get_storage()
        wrapper = mods["wrapper_from_numpy"](
            users_np, items_np, [f"u{j}" for j in range(ML25M_USERS)],
            [f"i{j}" for j in range(ML25M_ITEMS)], rank=RANK)
        t0 = time.perf_counter()
        iid = mods["persist_instance"](eng, variant, [wrapper], storage)
        out["persist_s"] = time.perf_counter() - t0
        del wrapper
        server = mods["EngineServer"](eng, variant, storage,
                                      host="127.0.0.1", port=0,
                                      scheduler_config=cfg)
        servers.append(server)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        cohorts = []
        batcher = server.scheduler._lanes["default"].batcher
        dispatch = batcher.dispatch_fn

        def recorded(queries):
            cohorts.append(len(queries))
            return dispatch(queries)

        batcher.dispatch_fn = recorded       # sizes only; same dispatch
        rng = np.random.default_rng(seed + 151)
        n = SCHED_CLIENTS * SCHED_PER_CLIENT
        users = rng.choice(ML25M_USERS, n + 1, replace=False)
        # the last user warms each server up (corpus staged on the card,
        # first launch) outside the measured rounds
        warm, users = {"user": f"u{users[-1]}", "num": 10}, users[:n]
        queries = [{"user": f"u{u}", "num": 10} for u in users]
        items_d = torch.from_numpy(items_np).to(dev)

        def chunked_requests():
            return metric_value(reg, "pio_retrieval_requests_total",
                                rung="chunked", corpus="als")

        # -- 2: coalescing ----------------------------------------------------
        post_json(f"{base}/queries.json", warm)
        cohorts.clear()
        snap0 = server.scheduler.snapshot()["default"]
        rung0 = chunked_requests()
        stages0 = {st: stage_cdf(reg, st) for st in SCHED_STAGES}
        ft.LAUNCHES = 0                      # main path starts here
        bodies, lats, server_ms, wall = sched_drive(base, queries,
                                                    SCHED_CLIENTS, work)
        launches = ft.LAUNCHES               # and ends here
        split = stage_split(reg, stages0)
        wall_split = {k: v for k, v in split.items() if k != "retrieval"}
        out["stages"] = split
        out["p99_stage"] = max(wall_split, key=lambda k: wall_split[k][1])
        snap = server.scheduler.snapshot()["default"]
        dispatches = snap["dispatches"] - snap0["dispatches"]
        requests = snap["requests"] - snap0["requests"]
        on_chunked = chunked_requests() - rung0
        if requests != n or dispatches >= n:
            die(f"phase 15: {requests} requests in {dispatches} dispatches")
        if launches != dispatches or on_chunked != dispatches:
            die(f"phase 15: fused_topk launched {launches} times for "
                f"{dispatches} dispatches ({on_chunked} on the chunked "
                "rung)")
        if sum(cohorts) != n or len(cohorts) != dispatches:
            die(f"phase 15: recorded cohorts {len(cohorts)} summing to "
                f"{sum(cohorts)}")
        err = 0.0
        answers = [json.loads(b) for b in bodies]
        for lo in range(0, n, 256):
            s_, i_ = zip(*(answer_arrays(a, 10) for a in answers[lo:lo + 256]))
            err = max(err, check_against_plain(
                np.concatenate(s_), np.concatenate(i_),
                torch.from_numpy(users_np[users[lo:lo + 256]]).to(dev),
                items_d, 10, None, "phase 15 coalesced /queries.json", ft,
                mods["topk_mismatch"]))
        out.update(
            requests=n, dispatches=dispatches, launches=launches,
            recs_per_s=n / wall, wall_s=wall,
            client_p50_ms=pct(lats, 0.5) * 1e3,
            client_p99_ms=pct(lats, 0.99) * 1e3,
            server_p50_ms=pct(server_ms, 0.5),
            server_p99_ms=pct(server_ms, 0.99),
            mean_cohort=n / dispatches, largest_cohort=max(cohorts),
            cohorts_by_size={str(k): int(v) for k, v in zip(
                *np.unique(cohorts, return_counts=True))},
            window_ms=snap["windowMs"], max_batch=snap["maxBatch"],
            served_p99_ms=snap["servedP99Ms"], err=err)

        # -- 3: the same queries again: result-cache hits --------------------
        hits0 = metric_value(reg, "pio_result_cache_hits_total",
                             tier="local")
        before = ft.LAUNCHES
        again, lats2, server_ms2, wall2 = sched_drive(base, queries,
                                                      SCHED_CLIENTS, work)
        hits = metric_value(reg, "pio_result_cache_hits_total",
                            tier="local") - hits0
        if hits != n or ft.LAUNCHES != before:
            die(f"phase 15: the repeat made {hits} cache hits and "
                f"{ft.LAUNCHES - before} fused_topk launches")
        differ = sum(a != b for a, b in zip(again, bodies))
        if differ:
            die(f"phase 15: {differ} cached bodies differ from the first")
        out.update(cache_hits=hits, cache_recs_per_s=n / wall2,
                   cache_client_p50_ms=pct(lats2, 0.5) * 1e3,
                   cache_client_p99_ms=pct(lats2, 0.99) * 1e3,
                   cache_server_p50_ms=pct(server_ms2, 0.5),
                   cache_hit_rate=server.result_cache.snapshot()["hitRate"])

        # -- 3b: the monitors' cost: the same drive on fresh servers with
        # them off, then on again (on, off, on in one run)
        out["off_launches"] = 0
        for label, knobs in (("off", {"PIO_QUALITY": "off",
                                       "PIO_RECALL": "off"}),
                             ("on2", {"PIO_QUALITY": None,
                                      "PIO_RECALL": None})):
            with env_vars(**knobs):
                fresh = mods["EngineServer"](eng, variant, storage,
                                             host="127.0.0.1", port=0,
                                             scheduler_config=cfg)
            servers.append(fresh)
            fresh.start()
            fbase = f"http://127.0.0.1:{fresh.port}"
            post_json(f"{fbase}/queries.json", warm)
            before = ft.LAUNCHES
            _, flats, _, fwall = sched_drive(fbase, queries, SCHED_CLIENTS,
                                             work)
            out["off_launches"] += ft.LAUNCHES - before
            out[f"{label}_recs_per_s"] = n / fwall
            out[f"{label}_client_p99_ms"] = pct(flats, 0.99) * 1e3
            fresh.stop()
            servers.remove(fresh)

        # -- 4: the inline path (batcher off) ----------------------------------
        inline = mods["EngineServer"](
            eng, variant, storage, host="127.0.0.1", port=0,
            scheduler_config=SchedulerConfig.from_env(enabled=False))
        servers.append(inline)
        inline.start()
        post_json(f"http://127.0.0.1:{inline.port}/queries.json", warm)
        before = ft.LAUNCHES
        # one registry: the counters are the process's, so read deltas
        isnap0 = inline.scheduler.snapshot()["default"]
        ibodies, ilats, _, iwall = sched_drive(
            f"http://127.0.0.1:{inline.port}", queries[:SCHED_INLINE], 8,
            work)
        ilaunches = ft.LAUNCHES - before
        isnap = inline.scheduler.snapshot()["default"]
        if ilaunches != SCHED_INLINE or isnap["batching"] \
                or isnap["dispatches"] - isnap0["dispatches"] \
                != SCHED_INLINE:
            die(f"phase 15: the inline path launched fused_topk "
                f"{ilaunches} times for {SCHED_INLINE} requests ({isnap})")
        for q, b, a in zip(queries, ibodies, answers):
            answers_agree(json.loads(b), a, f"phase 15 inline {q}",
                          mods["topk_mismatch"])
        inline.stop()
        servers.remove(inline)
        out.update(inline_launches=ilaunches,
                   inline_recs_per_s=SCHED_INLINE / iwall,
                   inline_client_p50_ms=pct(ilats, 0.5) * 1e3)

        # -- 5: `pio deploy --native` (a subprocess) ---------------------------
        t0 = time.perf_counter()
        d = deployed(engine_json, os.path.join(work, "deploy_native.log"),
                     extra=("--native", "--engine-instance-id", iid,
                            *dev_args), phase="phase 15")
        procs.append(d)
        out["native_start_s"] = time.perf_counter() - t0
        if not d.device.startswith(dev.type) or d.instance != iid:
            die(f"phase 15: pio deploy --native serves {d.instance} on "
                f"{d.device}")
        alive = json.loads(d.get("/"))
        if alive != {"status": "alive", "frontend": "native"}:
            die(f"phase 15: the native frontend's / answered {alive}")
        post_json(f"{d.base}/queries.json", warm)
        nbodies, nlats, _, nwall = sched_drive(
            d.base, queries[:SCHED_NATIVE], SCHED_CLIENTS, work)
        for q, b, a in zip(queries, nbodies, answers):
            answers_agree(json.loads(b), a, f"phase 15 native {q}",
                          mods["topk_mismatch"])
        fe_metrics = d.get("/metrics")
        d.stop()
        procs.remove(d)
        nlaunch = (d.launches or {}).get("fused_topk", 0)
        if not 1 < nlaunch <= SCHED_NATIVE + 1:       # + the warm-up
            die(f"phase 15: the native deploy launched fused_topk "
                f"{nlaunch} times")
        out.update(native_launches=nlaunch,
                   native_recs_per_s=SCHED_NATIVE / nwall,
                   native_client_p50_ms=pct(nlats, 0.5) * 1e3,
                   native_client_p99_ms=pct(nlats, 0.99) * 1e3,
                   native_metrics=" ".join(
                       ln for ln in fe_metrics.splitlines()
                       if ln.startswith(("pio_frontend_batches_total",
                                         "pio_frontend_mean_batch_size"))))
        for srv in servers:
            srv.stop()
        servers.clear()
        del items_d

        # -- 6: `pio eventserver --native`: SDK ingest, export, SIGTERM -------
        import re

        cols = tuple(c[:SCHED_EVENTS] for c in ml1m_events(seed))
        said = run_cli("app", "new", "chipsched", phase="phase 15")
        key = re.search(r"Access Key: (\S+)", said).group(1)
        app_id = re.search(r"ID: (\d+)", said)
        app_id = app_id.group(1) if app_id else "1"
        es = eventserver_proc(os.path.join(work, "eventserver_native.log"),
                              extra=("--native",), phase="phase 15")
        procs.append(es)
        ready = es.get("/ready")
        if ready["status"] != "ready":
            die(f"phase 15: the native event server's /ready is {ready}")
        ewall, elats, _ = es_ingest(es.base, key, cols, SCHED_EVENTS,
                                    phase="phase 15")
        exported = os.path.join(work, "export_native.jsonl")
        said = run_cli("export", "--appid", app_id, "--output", exported,
                       phase="phase 15")
        if f"Exported {SCHED_EVENTS} events" not in said:
            die(f"phase 15: export said {said!r}")
        es_export_matches(exported, cols, SCHED_EVENTS, phase="phase 15")
        es.drain()
        procs.remove(es)
        out.update(es_events_per_s=SCHED_EVENTS / ewall,
                   es_batch_p50_ms=pct(elats, 0.5) * 1e3)
        # the store stays for phase 21 (its G1); main() removes it
        out.update(work=work, home=os.path.join(work, "home"),
                   engine_json=engine_json, instance=iid)
    finally:
        for p_ in procs:
            p_.kill()
        for srv in servers:
            srv.stop()
        reset_storage()
        env.__exit__()
        if "work" not in out:
            shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 15 scheduler: ML-25M shape {ML25M_USERS}x{ML25M_ITEMS} "
        f"rank {RANK} on the chunked rung, default SchedulerConfig "
        f"(batcher and autotuner on, depth 128, max batch 64): {n} "
        f"/queries.json from {SCHED_CLIENTS} clients x {SCHED_PER_CLIENT} "
        f"({SCHED_CLIENT_PROCS} client processes), distinct users, in "
        f"{out['wall_s']:.2f} s = "
        f"{out['recs_per_s']:.1f} recs/s; client p50 "
        f"{out['client_p50_ms']:.2f} ms, p99 {out['client_p99_ms']:.2f} "
        f"ms; server p50 {out['server_p50_ms']:.2f} ms, p99 "
        f"{out['server_p99_ms']:.2f} ms; {out['dispatches']} dispatches "
        f"= {out['launches']} fused_topk launches, mean cohort "
        f"{out['mean_cohort']:.2f}, largest {out['largest_cohort']}, by "
        f"size {json.dumps(out['cohorts_by_size'])}; autotuner settled at "
        f"window {out['window_ms']} ms, max batch {out['max_batch']}, "
        f"served p99 {out['served_p99_ms']} ms; max |score err| "
        f"{out['err']:.3g}; card {card}")
    log(f"phase 15 waterfall (monitors on at the shipped rates: quality "
        f"0.1, recall 0.05): stage ms (p50, p99, mean) "
        f"{json.dumps(out['stages'])}; the largest p99 is "
        f"{out['p99_stage']}'s; the same drive on a fresh server with "
        f"PIO_QUALITY=off PIO_RECALL=off: {out['off_recs_per_s']:.1f} "
        f"recs/s, client p99 {out['off_client_p99_ms']:.2f} ms, then on "
        f"another with the monitors on again: "
        f"{out['on2_recs_per_s']:.1f} recs/s, p99 "
        f"{out['on2_client_p99_ms']:.2f} ms ({out['off_launches']} "
        f"fused_topk launches in the two)")
    log(f"phase 15 cache: the same {n} queries again: {out['cache_hits']} "
        f"result-cache hits, every body byte-equal, 0 launches; "
        f"{out['cache_recs_per_s']:.1f} recs/s, client p50 "
        f"{out['cache_client_p50_ms']:.2f} ms, p99 "
        f"{out['cache_client_p99_ms']:.2f} ms, server p50 "
        f"{out['cache_server_p50_ms']:.2f} ms; hit rate "
        f"{out['cache_hit_rate']:.3f}")
    log(f"phase 15 inline (batcher off): {SCHED_INLINE} queries from 8 "
        f"clients, {out['inline_launches']} fused_topk launches, "
        f"{out['inline_recs_per_s']:.1f} recs/s, client p50 "
        f"{out['inline_client_p50_ms']:.2f} ms; answers equal")
    log(f"phase 15 native: `pio deploy --native` started in "
        f"{out['native_start_s']:.2f} s, {SCHED_NATIVE} queries from "
        f"{SCHED_CLIENTS} clients equal to the Python path's, "
        f"{out['native_recs_per_s']:.1f} recs/s, client p50 "
        f"{out['native_client_p50_ms']:.2f} ms, p99 "
        f"{out['native_client_p99_ms']:.2f} ms, fused_topk launches "
        f"{out['native_launches']} ({out['native_metrics']}); POST /stop "
        f"exit 0; `pio eventserver --native`: {SCHED_EVENTS} events by "
        f"sdk.EventClient in batches of {ES_BATCH} from {ES_THREADS} "
        f"threads, {out['es_events_per_s']:.0f} events/s, batch p50 "
        f"{out['es_batch_p50_ms']:.2f} ms; export exact; SIGTERM exit 0; "
        f"the phase {out['phase_s']:.1f} s")
    if out["phase_s"] > SCHED_LIMIT_S:
        die(f"phase 15: took {out['phase_s']:.1f} s, over "
            f"{SCHED_LIMIT_S:.0f} s")
    return out


# Phase 16: staged reload, rollback and the ALS warm-start refresh, on
# phase 12's sqlite + localfs store (its generation 1, rank 64, at the
# MovieLens-1M shape: no import is repeated).
REFRESH_DELTA = 20_000        # rate events stamped after the watermark: 2 %
REFRESH_NEW_USERS, REFRESH_NEW_ITEMS = 200, 100
REFRESH_TOUCHED_USERS = 1_500  # existing users the delta touches
REFRESH_QUERIES = 64
REFRESH_LOAD_CLIENTS = 16      # client threads across the loaded /reload
REFRESH_LOAD_S = 1.0           # load before and after the POST
REFRESH_FALLBACK_DELTA = 1_000
REFRESH_LIMIT_S = 150.0


def post_status(url: str, obj=None):
    """POST ``obj`` (no body for None); returns (status, answer, wall s)
    whatever the status."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={} if obj is None else {"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, json.loads(body or b"{}"), time.perf_counter() - t0


def refresh_delta(rng, names, item_names, n: int, new_users: int,
                  new_items: int, touched: int, prefix: str):
    """``n`` rate events: every new user 5 and every new item 10 of them,
    the rest spread over ``touched`` existing users (Zipf(1.25) items);
    half stars.  Returns [(user, item, rating)]."""
    rows = []
    nu = [f"{prefix}u{j}" for j in range(new_users)]
    ni = [f"{prefix}i{j}" for j in range(new_items)]
    users = list(rng.choice(names, touched, replace=False))
    for u in nu:
        for _ in range(5):
            rows.append((u, item_names[int(rng.zipf(1.25)) % len(
                item_names)]))
    for i in ni:
        for _ in range(10):
            rows.append((users[int(rng.integers(len(users)))], i))
    while len(rows) < n:
        rows.append((users[int(rng.integers(len(users)))],
                     item_names[int(rng.zipf(1.25)) % len(item_names)]))
    stars = rng.integers(1, 11, len(rows)) * 0.5
    return [(u, i, float(r)) for (u, i), r in zip(rows, stars)]


def refresh_phase(dev, seed: int, loop: dict, mods: dict, card: str) -> dict:
    """Phase 16: `pio deploy` generation 1 of phase 12's store (a
    subprocess), then a warm refresh cycle promoted through POST /reload,
    a poisoned candidate (409), rollback and back, a second warm
    generation promoted under 16 client threads, a full fallback, and
    the eviction's freed bytes on an in-process server.  Returns the
    phase's times and launches."""
    import datetime as dt
    import gc
    import threading

    import numpy as np
    import torch

    fg, rs, ft = mods["fg"], mods["rs"], mods["ft"]
    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.refresh import RefreshConfig
    from predictionio_tpu_torch.refresh.daemon import HttpPromoter, \
        RefreshDaemon
    from predictionio_tpu_torch.version import __version__
    from predictionio_tpu_torch.workflow.core_workflow import (
        data_watermark, load_models)

    phase_t0 = time.perf_counter()
    work, engine_json = loop["work"], loop["engine_json"]
    env = cli_env(os.path.join(work, "home"))
    env.values.update({k: None for k in (
        "PIO_REFRESH_INTERVAL_S", "PIO_REFRESH_MAX_DELTA_FRACTION",
        "PIO_REFRESH_EVAL_TOLERANCE", "PIO_REFRESH_PROMOTE_URL",
        "PIO_REFRESH_CANARY_WINDOW_S", "PIO_CANARY_QUERIES",
        "PIO_RETAIN_PREVIOUS", "PIO_RETAIN_PREVIOUS_TTL_S",
        "PIO_RESULT_CACHE")})
    registry = mods["get_registry"]()
    rng = np.random.default_rng(seed + 16)
    out, server = {}, None
    env.__enter__()
    reset_storage()
    try:
        storage = get_storage()
        eng = mods["engine"]()
        variant = mods["EngineVariant"].from_file(engine_json)
        instances = storage.get_engine_instances()
        inst1 = instances.get_latest_completed(
            variant.engine_factory, __version__, variant.variant_id)
        ctx = mods["RuntimeContext"](storage=storage, device=dev)
        [w1] = load_models(eng, inst1, ctx)
        uf1, itf1 = (x.copy() for x in w1.host_factors())
        names = list(w1.user_index.keys())
        item_names = list(w1.item_index.keys())
        app_id = storage.get_apps().get_by_name(CLI_APP).id
        ft.LAUNCHES = 0                      # main path starts here
        fg.LAUNCHES = 0
        rs.LU_LAUNCHES = 0

        def plain(w, users, num):
            """The plain top-k of ``w``'s factors for ``users``: (ids,
            scores) a user, on the card."""
            uf, itf = w.host_factors()
            q = torch.from_numpy(np.ascontiguousarray(
                uf[[w.user_index[u] for u in users]])).to(dev)
            items = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
            s, i = ft.fused_topk_reference(q, items, min(num + 1,
                                                         itf.shape[0]))
            return s.cpu().numpy(), i.cpu().numpy()

        def mismatch(answer, w, user, num):
            """Why ``answer`` is not ``w``'s plain top-``num`` (None when
            it is, within the answer tolerance and ties)."""
            s, i = plain(w, [user], num)
            hits = answer["itemScores"]
            if len(hits) != num:
                return f"{len(hits)} items, not {num}"
            inv = w.item_index
            if any(h["item"] not in inv for h in hits):
                return "an item the generation does not know"
            return mods["topk_mismatch"](
                [[h["score"] for h in hits]],
                [[inv[h["item"]] for h in hits]], s[:, :num], i[:, :num],
                s[:, num] if s.shape[1] > num else None, rtol=RTOL,
                atol=ATOL)

        def hold(answers, w, users, num, what):
            for user, ans in zip(users, answers):
                why = mismatch(ans, w, user, num)
                if why is not None:
                    die(f"phase 16 {what} {user}: {why}")

        def cache_hits(srv) -> float:
            key = 'pio_result_cache_hits_total{tier="local"} '
            return sum(float(ln[len(key):]) for ln in
                       srv.get("/metrics").splitlines()
                       if ln.startswith(key))

        # -- a: deploy generation 1, baseline answers -----------------------
        server = deployed(engine_json, os.path.join(work, "refresh.log"),
                          phase="phase 16")
        if server.instance != inst1.id:
            die(f"phase 16: deploy serves {server.instance}, not "
                f"generation 1 {inst1.id}")
        asked = [names[j] for j in rng.choice(len(names), REFRESH_QUERIES,
                                              replace=False)]
        base = [post_json(f"{server.base}/queries.json",
                          {"user": u, "num": 10})[0] for u in asked]
        hold(base, w1, asked, 10, "baseline")

        # -- b: the delta, stamped after generation 1's watermark -----------
        wm1 = data_watermark(inst1)
        rows = refresh_delta(rng, names, item_names, REFRESH_DELTA,
                             REFRESH_NEW_USERS, REFRESH_NEW_ITEMS,
                             REFRESH_TOUCHED_USERS, "r")
        Event, DataMap = mods["Event"], mods["DataMap"]
        stamp = dt.datetime.now(dt.timezone.utc)
        if stamp <= wm1:
            die(f"phase 16: the clock reads {stamp}, not after generation "
                f"1's watermark {wm1}")
        t0 = time.perf_counter()
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=DataMap({"rating": r}),
                  event_time=stamp + dt.timedelta(microseconds=n))
            for n, (u, i, r) in enumerate(rows)], app_id)
        out["delta_write_s"] = time.perf_counter() - t0

        # -- c: one warm cycle promoted through POST /reload ----------------
        reload_walls = []

        def timed_opener(req, timeout=30.0):
            t = time.perf_counter()
            resp = urllib.request.urlopen(req, timeout=timeout)
            if req.full_url.endswith("/reload"):
                reload_walls.append(time.perf_counter() - t)
            return resp

        dctx = mods["RuntimeContext"].create(storage=storage, device=dev)
        daemon = RefreshDaemon(
            eng, variant, dctx, config=RefreshConfig.from_env(
                canary_window_s=0.0),
            promoter=HttpPromoter(server.base, canary_window_s=0.0,
                                  opener=timed_opener))
        cycle = daemon.run_once()
        if (cycle["result"], cycle["promotion"]) != ("warm", "promoted"):
            die(f"phase 16: the warm cycle ended {cycle}")
        train_s = registry.get("pio_refresh_train_s")   # unrounded
        out["warm_train_s"] = train_s.value(mode="warm")
        out["reload_s"] = reload_walls[-1]
        status = json.loads(server.get("/"))
        if (status["engineInstanceId"], status["modelGeneration"],
                status["refreshMode"]) != (cycle["instance"], 2, "warm"):
            die(f"phase 16: after the warm cycle the server reports "
                f"{status}")
        stale = registry.get("pio_refresh_staleness_s").value()
        if stale != 0.0:
            die(f"phase 16: pio_refresh_staleness_s reads {stale}")
        inst2 = instances.get(cycle["instance"])
        [w2] = load_models(eng, inst2, ctx)
        uf2, itf2 = w2.host_factors()
        wm2 = data_watermark(inst2)
        window = list(storage.get_events().find(
            app_id, start_time=wm1, until_time=wm2))
        touched_u = {e.entity_id for e in window}
        touched_i = {e.target_entity_id for e in window}
        kept_u = [r for u, r in w1.user_index.items() if u not in touched_u]
        kept_i = [r for t, r in w1.item_index.items() if t not in touched_i]
        if not (np.array_equal(uf2[kept_u], uf1[kept_u])
                and np.array_equal(itf2[kept_i], itf1[kept_i])):
            die("phase 16: a row no delta event touched moved")
        moved_u = int(np.sum(np.any(uf2[:len(names)] != uf1, axis=1)))
        new_u = touched_u.difference(w1.user_index.keys())
        new_i = touched_i.difference(w1.item_index.keys())
        if (len(window) != REFRESH_DELTA + loop["fold_events"]
                or w2.n_examples != w1.n_examples + len(window)
                or len(new_i) != REFRESH_NEW_ITEMS
                or len(new_u) < REFRESH_NEW_USERS
                or len(w2.user_index) != len(names) + len(new_u)
                or len(w2.item_index) != len(item_names) + len(new_i)):
            die(f"phase 16: the warm generation read {len(window)} events, "
                f"{w2.n_examples} examples, {len(w2.user_index)} x "
                f"{len(w2.item_index)}")
        fresh = [f"ru{j}" for j in rng.choice(REFRESH_NEW_USERS,
                                              REFRESH_QUERIES,
                                              replace=False)]
        warm_ans = [post_json(f"{server.base}/queries.json",
                              {"user": u, "num": 10})[0]
                    for u in asked + fresh]
        hold(warm_ans, w2, asked + fresh, 10, "warm answer")
        changed = sum(a != b for a, b in zip(warm_ans, base))

        # -- e: a poisoned candidate is refused -----------------------------
        bad_uf = uf2.copy()
        bad_uf[int(rng.integers(len(bad_uf)))] = np.nan
        bad = mods["wrapper_from_numpy"](
            bad_uf, itf2, list(w2.user_index.keys()),
            list(w2.item_index.keys()), rank=RANK)
        bad_id = mods["persist_instance"](eng, variant, [bad], storage)
        del bad, bad_uf
        st, body, _ = post_status(f"{server.base}/reload",
                                  {"engineInstanceId": bad_id})
        status = json.loads(server.get("/"))
        if st != 409 or "non-finite" not in body.get("message", "") or (
                status["engineInstanceId"], status["modelGeneration"]) != (
                inst2.id, 2):
            die(f"phase 16: the poisoned reload answered {st} {body}; the "
                f"server reports {status}")
        again = [post_json(f"{server.base}/queries.json",
                           {"user": u, "num": 10})[0] for u in asked[:8]]
        if again != warm_ans[:8]:
            die("phase 16: answers changed after the refused reload")
        # the operator retires the bad train: no later cycle warms from it
        poisoned = instances.get(bad_id)
        poisoned.status = "FAILED"
        instances.update(poisoned)

        # -- f: rollback to generation 1, and back --------------------------
        hits0 = cache_hits(server)
        st, body, out["rollback_s"] = post_status(
            f"{server.base}/admin/rollback")
        if st != 200 or body["engineInstanceId"] != inst1.id:
            die(f"phase 16: rollback answered {st} {body}")
        back = [post_json(f"{server.base}/queries.json",
                          {"user": u, "num": 10})[0] for u in asked]
        hits = cache_hits(server) - hits0
        if back != base or hits != REFRESH_QUERIES:
            die(f"phase 16: after the rollback {sum(a != b for a, b in zip(back, base))} "
                f"answers differ from the baseline, {hits} cache hits")
        st, body, out["rollback2_s"] = post_status(
            f"{server.base}/admin/rollback")
        if st != 200 or body["engineInstanceId"] != inst2.id:
            die(f"phase 16: the second rollback answered {st} {body}")

        # -- d: a second warm generation promoted under load ----------------
        rows3 = [(u, item_names[int(rng.zipf(1.25)) % len(item_names)],
                  float(rng.integers(1, 11) * 0.5))
                 for u in asked for _ in range(8)]
        stamp = dt.datetime.now(dt.timezone.utc)
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=DataMap({"rating": r}),
                  event_time=stamp + dt.timedelta(microseconds=n))
            for n, (u, i, r) in enumerate(rows3)], app_id)
        trainer = RefreshDaemon(eng, variant, dctx,
                                config=RefreshConfig.from_env(
                                    canary_window_s=0.0))
        cycle3 = trainer.run_once()
        if cycle3["result"] != "warm":
            die(f"phase 16: the second warm cycle ended {cycle3}")
        [w3] = load_models(eng, instances.get(cycle3["instance"]), ctx)
        stop = threading.Event()
        results = [[] for _ in range(REFRESH_LOAD_CLIENTS)]

        def client(n):
            j = n
            while not stop.is_set():
                user = asked[j % len(asked)]
                num = 5 + (j // len(asked)) % 16
                t = time.perf_counter()
                st, ans, _ = post_status(f"{server.base}/queries.json",
                                         {"user": user, "num": num})
                results[n].append((st, user, num, ans,
                                   time.perf_counter() - t))
                j += REFRESH_LOAD_CLIENTS

        threads = [threading.Thread(target=client, args=(n,))
                   for n in range(REFRESH_LOAD_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(REFRESH_LOAD_S)
        st, body, out["reload_load_s"] = post_status(
            f"{server.base}/reload", {"engineInstanceId": cycle3["instance"]})
        time.sleep(REFRESH_LOAD_S)
        stop.set()
        for t in threads:
            t.join(120)
        if st != 200 or body["engineInstanceId"] != cycle3["instance"]:
            die(f"phase 16: the loaded reload answered {st} {body}")
        flat = [r for rs_ in results for r in rs_]
        if any(r[0] != 200 for r in flat):
            die(f"phase 16: {sum(r[0] != 200 for r in flat)} of "
                f"{len(flat)} answers under load were not 200")
        seen = {}
        for _, user, num, ans, _ in flat:
            seen.setdefault((user, num, json.dumps(ans)), ans)
        of_gen = {2: 0, 3: 0}
        for (user, num, _), ans in seen.items():
            if mismatch(ans, w2, user, num) is None:
                of_gen[2] += 1
            elif mismatch(ans, w3, user, num) is None:
                of_gen[3] += 1
            else:
                die(f"phase 16: an answer for {user} under load is neither "
                    f"generation's: {ans}")
        lats = sorted(r[4] for r in flat)
        out["load"] = {"requests": len(flat), "distinct": len(seen),
                       "of_gen": of_gen, "p50_ms": pct(lats, 0.5) * 1e3,
                       "p99_ms": pct(lats, 0.99) * 1e3}

        # -- g: a delta over PIO_REFRESH_MAX_DELTA_FRACTION: full fallback --
        rows4 = refresh_delta(rng, names, item_names,
                              REFRESH_FALLBACK_DELTA, 0, 0, 200, "g")
        stamp = dt.datetime.now(dt.timezone.utc)
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  properties=DataMap({"rating": r}),
                  event_time=stamp + dt.timedelta(microseconds=n))
            for n, (u, i, r) in enumerate(rows4)], app_id)
        n_before = len(instances.get_all())
        k_before = (fg.LAUNCHES, rs.LU_LAUNCHES)
        with env_vars(PIO_REFRESH_MAX_DELTA_FRACTION="0.0001"):
            full = RefreshDaemon(
                eng, variant, dctx, config=RefreshConfig.from_env(
                    canary_window_s=0.0),
                promoter=HttpPromoter(server.base, canary_window_s=0.0,
                                      opener=timed_opener)).run_once()
        k1, k2 = (fg.LAUNCHES - k_before[0], rs.LU_LAUNCHES - k_before[1])
        inst4 = instances.get(full["instance"])
        if (full["result"], inst4.env.get("refreshMode"), inst4.status,
                len(instances.get_all())) != (
                "full_fallback", "full_fallback", "COMPLETED",
                n_before + 1) or k1 == 0 or k2 == 0:
            die(f"phase 16: the fallback cycle ended {full} "
                f"({len(instances.get_all()) - n_before} new instances, "
                f"K1 {k1}, K2 {k2} launches)")
        out["full_train_s"] = train_s.value(mode="full_fallback")
        [w4] = load_models(eng, inst4, ctx)
        sample = asked[:16]
        hold([post_json(f"{server.base}/queries.json",
                        {"user": u, "num": 10})[0] for u in sample],
             w4, sample, 10, "fallback answer")
        server.stop()
        deploy_k3 = server.launches["fused_topk"]
        server = None

        # -- h: the bytes an eviction frees, on an in-process server --------
        del w1, w2, w4, window
        gc.collect()
        srv = mods["EngineServer"](eng, variant, storage, host="127.0.0.1",
                                   port=0, device=dev, instance_id=inst2.id)
        try:
            srv.query({"user": asked[0], "num": 10})   # stages generation 2
            srv.reload(cycle3["instance"])
            srv.query({"user": asked[0], "num": 10})   # stages generation 3
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            if not srv._evict_previous(srv._generation):
                die("phase 16: nothing to evict")
            gc.collect()
            torch.cuda.synchronize()
            out["evicted_bytes"] = before - torch.cuda.memory_allocated()
        finally:
            srv.stop()
        corpus = itf2.shape[0] * itf2.shape[1] * 4
        if out["evicted_bytes"] < corpus:
            die(f"phase 16: eviction freed {out['evicted_bytes']} bytes, "
                f"less than generation 2's staged corpus ({corpus})")
        launches = {"fused_topk": ft.LAUNCHES + deploy_k3,   # main path ends
                    "fused_gram": fg.LAUNCHES,
                    "ridge_solve_lu": rs.LU_LAUNCHES}
        if launches["fused_topk"] == 0:
            die("phase 16: fused_topk never launched")
    finally:
        if server is not None:
            server.kill()
        reset_storage()
        env.__exit__()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 16 refresh: generation 1 of phase 12's store deployed; "
        f"{REFRESH_DELTA} delta events ({REFRESH_NEW_USERS} new users, "
        f"{REFRESH_NEW_ITEMS} new items; {len(touched_u)} users and "
        f"{len(touched_i)} items touched) written in "
        f"{out['delta_write_s']:.2f} s; warm cycle: train "
        f"{out['warm_train_s']:.3f} s against the full fallback's "
        f"{out['full_train_s']:.3f} s (phase 12's pio train "
        f"{loop['train_s']:.2f} s); POST /reload {out['reload_s'] * 1e3:.1f} "
        f"ms to 200; generation 2 warm ({moved_u} trained user rows moved, "
        f"every untouched row bitwise generation 1's); "
        f"{2 * REFRESH_QUERIES} answers ({changed} of the "
        f"{REFRESH_QUERIES} baseline ones changed) equal "
        f"the plain top-k of the warm factors; staleness 0; card {card}")
    log(f"phase 16 gate: the NaN candidate 409, generation 2 kept serving; "
        f"POST /admin/rollback {out['rollback_s'] * 1e3:.1f} ms (back "
        f"{out['rollback2_s'] * 1e3:.1f} ms), the {REFRESH_QUERIES} "
        f"baseline answers equal, each a result-cache hit; under "
        f"{REFRESH_LOAD_CLIENTS} clients a /reload took "
        f"{out['reload_load_s'] * 1e3:.1f} ms: "
        f"{out['load']['requests']} answers all 200, "
        f"{out['load']['distinct']} distinct, by generation "
        f"{json.dumps(out['load']['of_gen'])}, none mixed, client p50 "
        f"{out['load']['p50_ms']:.2f} ms p99 {out['load']['p99_ms']:.2f} ms; "
        f"the full fallback in one instance launched K1 {k1} and K2 {k2} "
        f"times; eviction freed {out['evicted_bytes']} bytes "
        f"(generation 2's corpus {corpus}); launches "
        f"{json.dumps(launches)}; phase 16 in {out['phase_s']:.1f} s; "
        f"card {card}")
    if out["phase_s"] > REFRESH_LIMIT_S:
        log(f"phase 16: over its {REFRESH_LIMIT_S:.0f} s budget")
    return out


# Phase 17: the two-tower engine.  (a) the train loop at bench.py's
# shape; (b) the shipped engine.json through `pio train` / `pio deploy`
# on phase 12's store; (c) one warm cycle on a 20,000-event delta.
TT_USERS, TT_ITEMS = 200_000, 100_000       # bench.py's two-tower shape
TT_EMBED, TT_HIDDEN, TT_OUT, TT_BATCH = 64, (128,), 64, 1024
# bench.py's feeder rows, one epoch a run: the eager loop is host-bound
# (PERF.md §5), and the smoke must end inside its time limit
TT_ROWS, TT_EPOCHS = 800_000, 1
TT_PIO_EPOCHS = 2     # 17b: the shipped engine.json's 10, cut for time
TT_FUSED = 8
TT_NAN_ROWS = 65_536                        # the injected-NaN run's rows
TT_FACTORY = "predictionio_tpu_torch.templates.twotower:engine"
TT_CHUNK = 8_192                            # retrieve(chunk=) on the card
TT_LIMIT_S = 150.0


def tt_state_leaves(tt, state):
    """Every tensor of a two-tower state (params, both moments) in one
    fixed order."""
    adam = state.opt_state[0]
    return (tt._leaves(state.params) + tt._leaves(adam.mu)
            + tt._leaves(adam.nu))


def two_tower_train_runs(dev, seed: int, card: str) -> dict:
    """Phase 17a: ``two_tower.train`` at bench.py's shape, from numpy and
    from the native feeder, at K=1 and K=8: examples/s, the probe's
    shares, peak device memory; K=8's state bitwise K=1's; and a NaN
    batch must raise TrainDiverged with no checkpoint directory."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import two_tower as tt
    from predictionio_tpu_torch.obs.runtime import get_timeline
    from predictionio_tpu_torch.resilience.supervision import TrainDiverged

    rng = np.random.default_rng(seed + 17)
    users = rng.integers(0, TT_USERS, TT_ROWS)
    items = rng.integers(0, TT_ITEMS, TT_ROWS)
    cfg = tt.TwoTowerConfig(
        n_users=TT_USERS, n_items=TT_ITEMS, embed_dim=TT_EMBED,
        hidden_dims=TT_HIDDEN, out_dim=TT_OUT, batch_size=TT_BATCH,
        epochs=TT_EPOCHS, seed=seed)
    t0 = time.perf_counter()
    # One init for every run: train() never changes its starting state,
    # and starting from it (warm_state) times the loop alone.
    init = tt.init_state(cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # Warm-up outside the walls: the first train of a process pays the
    # card's and PyTorch's first-call costs, the first feeder run the
    # library's g++ build.
    t0 = time.perf_counter()
    warm_rows = 2 * TT_FUSED * TT_BATCH
    for source in ("numpy", "feeder"):
        for k in (1, TT_FUSED):
            tt.train(users[:warm_rows], items[:warm_rows], cfg,
                     data_source=source, fuse_steps=k, warm_state=init,
                     device=dev)
    torch.cuda.synchronize()
    out = {"init_s": init_s, "warmup_s": time.perf_counter() - t0,
           "runs": {}}
    finals = {}
    steps = TT_EPOCHS * -(-TT_ROWS // TT_BATCH)
    for source in ("numpy", "feeder"):
        for k in (1, TT_FUSED):
            timeline = get_timeline()
            timeline.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            state = tt.train(users, items, cfg, data_source=source,
                             fuse_steps=k, warm_state=init, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if int(state.step) != steps:
                die(f"phase 17a {source} K={k}: {state.step} steps, not "
                    f"{steps}")
            summ = timeline.summary("two_tower")
            ms = summ["phase_ms"]
            loop_ms = sum(ms[p] for p in ("host_wait", "h2d", "dispatch",
                                          "device_wait"))
            out["runs"][f"{source}_k{k}"] = {
                "wall_s": wall,
                "examples_per_s": TT_ROWS * TT_EPOCHS / wall,
                "dispatches": summ["dispatches"],
                "device_wait_share": summ["phase_share"]["device_wait"],
                "h2d_share": summ["phase_share"]["h2d"],
                "host_wait_share": summ["phase_share"]["host_wait"],
                "dispatch_share": summ["phase_share"]["dispatch"],
                "h2d_overlap_ms": ms["h2d_overlap"],
                "loop_ms": loop_ms,
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
            }
            finals[(source, k)] = state
        a, b = finals[(source, 1)], finals[(source, TT_FUSED)]
        la, lb = tt_state_leaves(tt, a), tt_state_leaves(tt, b)
        if not all(torch.equal(x, y) for x, y in zip(la, lb)) or (
                int(a.opt_state[0].count), a.step) != (
                int(b.opt_state[0].count), b.step):
            worst = max(float((x - y).abs().max()) for x, y in zip(la, lb))
            die(f"phase 17a {source}: the K={TT_FUSED} state is not the "
                f"K=1 state bit for bit (max |diff| {worst:.3g})")
        if not all(bool(torch.isfinite(x).all()) for x in la):
            die(f"phase 17a {source}: non-finite trained state")
    del finals, a, b, la, lb
    # The finite-loss guard: one NaN weight poisons one batch's loss.
    w = np.ones(TT_NAN_ROWS, np.float32)
    w[TT_NAN_ROWS // 2] = np.nan
    nan_cfg = tt.TwoTowerConfig(**{**vars(cfg), "epochs": 1})
    try:
        tt.train(users[:TT_NAN_ROWS], items[:TT_NAN_ROWS], nan_cfg,
                 weights=w, data_source="numpy", fuse_steps=TT_FUSED,
                 warm_state=init, device=dev)
        die("phase 17a: a NaN batch did not raise TrainDiverged")
    except TrainDiverged as e:
        out["diverged"] = str(e).split(" (")[0]
    torch.cuda.empty_cache()
    return out


def two_tower_phase(dev, seed: int, loop: dict, mods: dict, card: str
                    ) -> dict:
    """Phase 17: (a) :func:`two_tower_train_runs`; (b) `pio train` of
    the port's shipped twotower engine.json on phase 12's store (in
    process), `pio deploy` as a subprocess answering 64 /queries.json on
    the chunked rung, each held against the plain top-k of the persisted
    vectors, and ``two_tower.retrieve(chunk=)`` against the plain top-k;
    (c) one warm ``run_train(warm_from=)`` on a 20,000-event delta
    promoted through POST /reload, 64 answers held against the new
    vectors.  Returns the phase's numbers and K3 launches."""
    import datetime as dt
    import logging

    import numpy as np
    import torch

    ft, pio = mods["ft"], mods["pio"]
    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.models import two_tower as tt
    from predictionio_tpu_torch.refresh import WarmStartContext
    from predictionio_tpu_torch.templates.twotower import engine
    from predictionio_tpu_torch.version import __version__
    from predictionio_tpu_torch.workflow.core_workflow import (
        data_watermark, load_models)

    phase_t0 = time.perf_counter()
    out = {"train": two_tower_train_runs(dev, seed, card)}
    work = loop["work"]
    spec = json.loads((Path(__file__).resolve().parent /
                       "predictionio_tpu_torch" / "templates" / "twotower" /
                       "engine.json").read_text())
    if spec["engineFactory"] != TT_FACTORY:
        die(f"phase 17: the shipped engine.json names "
            f"{spec['engineFactory']}")
    spec["datasource"]["params"].update(appName=CLI_APP,
                                        eventNames=["rate", "buy"])
    spec["algorithms"][0]["params"].update(seed=seed, epochs=TT_PIO_EPOCHS)
    engine_json = os.path.join(work, "twotower.json")
    Path(engine_json).write_text(json.dumps(spec))
    env = cli_env(os.path.join(work, "home"))
    env.values.update(PIO_SERVE_HOST_MACS="0", PIO_RESULT_CACHE="0",
                      PIO_FUSE_STEPS=None, PIO_PREFETCH_DEPTH=None)
    rng = np.random.default_rng(seed + 171)
    server = None
    captured = []

    class _Gate(logging.Handler):
        def emit(self, record):
            captured.append(record.getMessage())

    gate = _Gate(level=logging.INFO)
    tpl_log = logging.getLogger(
        "predictionio_tpu_torch.templates.twotower.engine")
    env.__enter__()
    reset_storage()
    try:
        # -- b: pio train (in-process), pio deploy (subprocess) -----------
        ft.LAUNCHES = 0                      # main path starts here
        t0 = time.perf_counter()
        if pio(["train", "--engine-json", engine_json, "--fuse-steps",
                str(TT_FUSED)]) != 0:
            die("phase 17: pio train (twotower) failed")
        out["train_s"] = time.perf_counter() - t0
        storage = get_storage()
        eng = engine()
        variant = mods["EngineVariant"].from_file(engine_json)
        instances = storage.get_engine_instances()
        inst1 = instances.get_latest_completed(
            variant.engine_factory, __version__, variant.variant_id)
        ctx = mods["RuntimeContext"](storage=storage, device=dev)
        [w1] = load_models(eng, inst1, ctx)
        out["n_examples"] = w1.n_examples
        out["shape"] = (len(w1.user_index), len(w1.item_index))
        d = spec["algorithms"][0]["params"]["outDim"]
        if w1.user_vecs.shape != (out["shape"][0], d) or \
                w1.item_vecs.shape != (out["shape"][1], d) or not (
                np.isfinite(w1.user_vecs).all()
                and np.isfinite(w1.item_vecs).all()):
            die(f"phase 17: trained vectors {w1.user_vecs.shape} x "
                f"{w1.item_vecs.shape}")
        norms = np.linalg.norm(w1.item_vecs, axis=1)
        if not np.allclose(norms, 1.0, atol=1e-3):
            die(f"phase 17: item vectors not normalised ({norms.min()} .. "
                f"{norms.max()})")
        server = deployed(engine_json, os.path.join(work, "tt.log"),
                          phase="phase 17")
        if server.instance != inst1.id or \
                not server.device.startswith(dev.type):
            die(f"phase 17: deploy serves {server.instance} on "
                f"{server.device}")
        names = list(w1.user_index.keys())
        asked = [names[j] for j in rng.choice(len(names), CLI_QUERIES,
                                              replace=False)]

        def hold(w, users, what):
            """64 /queries.json, each the plain top-k of ``w``'s vectors
            on the card; returns (max |err|, p50 ms)."""
            items_d = torch.from_numpy(w.item_vecs).to(dev)
            err, lats = 0.0, []
            for user in users:
                t = time.perf_counter()
                ans, _ = post_json(f"{server.base}/queries.json",
                                   {"user": user, "num": 10})
                lats.append(time.perf_counter() - t)
                hits = ans["itemScores"]
                if len(hits) != 10:
                    die(f"phase 17 {what} {user}: {len(hits)} items")
                err = max(err, check_against_plain(
                    [[h["score"] for h in hits]],
                    [[w.item_index[h["item"]] for h in hits]],
                    torch.from_numpy(w.user_vecs[[w.user_index[user]]]).to(
                        dev), items_d, 10, None, f"phase 17 {what} {user}",
                    ft, mods["topk_mismatch"]))
            return err, sorted(lats)[len(lats) // 2] * 1e3

        out["query_err"], out["p50_ms"] = hold(w1, asked, "/queries.json")
        # retrieve(chunk=) on the card (K3), from the carried train state
        state = tt.state_from_host(w1.train_state, dev)
        q_users = torch.as_tensor(rng.choice(len(names), 64, replace=False),
                                  device=dev)
        n_items = len(w1.item_index)
        s, i = tt.retrieve(state.params, q_users, n_items, 10,
                           chunk=TT_CHUNK)
        q = tt.encode_users(state.params, q_users)
        if not np.array_equal(q.cpu().numpy(),
                              w1.user_vecs[q_users.cpu().numpy()]):
            die("phase 17: encode_users differs from the persisted vectors")
        items_d = tt.encode_items(state.params,
                                  torch.arange(n_items, device=dev))
        out["retrieve_err"] = check_against_plain(
            s.cpu().numpy(), i.cpu().numpy(), q, items_d, 10, None,
            "phase 17 retrieve(chunk=)", ft, mods["topk_mismatch"])
        del state, items_d

        # -- c: one warm cycle on a 20,000-event delta ----------------------
        wm1 = data_watermark(inst1)
        rows = refresh_delta(rng, names, list(w1.item_index.keys()),
                             REFRESH_DELTA, REFRESH_NEW_USERS,
                             REFRESH_NEW_ITEMS, REFRESH_TOUCHED_USERS, "t")
        stamp = dt.datetime.now(dt.timezone.utc)
        if stamp <= wm1:
            die(f"phase 17: the clock reads {stamp}, not after the "
                f"watermark {wm1}")
        app_id = storage.get_apps().get_by_name(CLI_APP).id
        Event, DataMap = mods["Event"], mods["DataMap"]
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i_,
                  properties=DataMap({"rating": r}),
                  event_time=stamp + dt.timedelta(microseconds=n))
            for n, (u, i_, r) in enumerate(rows)], app_id)
        warm = WarmStartContext(instance=inst1, models=[w1],
                                start_time=wm1)
        tpl_log.addHandler(gate)
        tpl_log.setLevel(logging.INFO)
        t0 = time.perf_counter()
        wid = mods["run_train"](
            eng, variant, mods["RuntimeContext"].create(storage=storage,
                                                        device=dev),
            warm_from=warm)
        out["warm_s"] = time.perf_counter() - t0
        inst2 = instances.get(wid)
        mode = inst2.env.get("refreshMode")
        if mode != "warm":
            die(f"phase 17: the warm cycle came out {mode!r} "
                f"({captured})")
        gate_lines = [m for m in captured if "delta-sample loss" in m]
        if not gate_lines:
            die("phase 17: the warm start logged no delta-sample loss")
        out["warm_gate"] = gate_lines[-1].split("delta-sample loss ")[-1]
        [w2] = load_models(eng, inst2, ctx)
        if w2.n_examples != w1.n_examples + REFRESH_DELTA or \
                len(w2.user_index) < len(w1.user_index) + REFRESH_NEW_USERS:
            die(f"phase 17: the warm generation has {w2.n_examples} "
                f"examples, {len(w2.user_index)} users")
        st, body, out["reload_s"] = post_status(f"{server.base}/reload",
                                                {"engineInstanceId": wid})
        if st != 200:
            die(f"phase 17: POST /reload answered {st} {body}")
        fresh = [r[0] for r in rows[:REFRESH_NEW_USERS * 5:5]]
        out["warm_err"], out["warm_p50_ms"] = hold(
            w2, asked[:CLI_QUERIES // 2] + fresh[:CLI_QUERIES // 2],
            "warm answer")
        server.stop()
        deploy_k3 = server.launches["fused_topk"]
        server = None
        out["launches"] = {"fused_topk": ft.LAUNCHES + deploy_k3}
        # main path ends here
        if deploy_k3 < 2 * CLI_QUERIES or ft.LAUNCHES < 1:
            die(f"phase 17: K3 launched {deploy_k3} times in the deploy "
                f"process and {ft.LAUNCHES} in this one")
    finally:
        tpl_log.removeHandler(gate)
        if server is not None:
            server.kill()
        reset_storage()
        env.__exit__()
    out["phase_s"] = time.perf_counter() - phase_t0
    tr = out["train"]
    runs = " | ".join(
        f"{name}: {r['examples_per_s']:.0f} ex/s ({r['wall_s']:.2f} s, "
        f"{r['dispatches']} dispatches; shares device_wait "
        f"{r['device_wait_share']:.3f} h2d {r['h2d_share']:.3f} host_wait "
        f"{r['host_wait_share']:.3f} dispatch {r['dispatch_share']:.3f}; "
        f"h2d overlapped {r['h2d_overlap_ms']:.0f} ms; peak "
        f"{r['peak_bytes'] / 2**20:.0f} MiB)"
        for name, r in tr["runs"].items())
    log(f"phase 17 two-tower train: {TT_USERS}x{TT_ITEMS}, embed "
        f"{TT_EMBED}, hidden {list(TT_HIDDEN)}, out {TT_OUT}, batch "
        f"{TT_BATCH}, {TT_ROWS} rows x {TT_EPOCHS} epochs (init "
        f"{tr['init_s']:.2f} s and a warm-up of 4 short trains "
        f"{tr['warmup_s']:.2f} s, outside the walls): {runs}; K={TT_FUSED} "
        f"state equals K=1 bit for bit from both sources; a NaN batch "
        f"raised {tr['diverged']!r}; card {card}")
    log(f"phase 17 two-tower pio loop: pio train --fuse-steps {TT_FUSED} "
        f"(shipped engine.json, epochs {TT_PIO_EPOCHS}, "
        f"{out['n_examples']} events, {out['shape'][0]} users x "
        f"{out['shape'][1]} items) {out['train_s']:.2f} s; pio deploy on "
        f"the chunked rung: {CLI_QUERIES} /queries.json p50 "
        f"{out['p50_ms']:.2f} ms, each the plain top-k of the persisted "
        f"vectors (max |err| {out['query_err']:.3g}); retrieve(chunk="
        f"{TT_CHUNK}) max |err| {out['retrieve_err']:.3g}; warm cycle on "
        f"{REFRESH_DELTA} delta events {out['warm_s']:.2f} s, mode warm, "
        f"delta-sample loss {out['warm_gate']}; POST /reload "
        f"{out['reload_s'] * 1e3:.1f} ms; {CLI_QUERIES} answers "
        f"({CLI_QUERIES // 2} new "
        f"users) the plain top-k of the warm vectors (max |err| "
        f"{out['warm_err']:.3g}, p50 {out['warm_p50_ms']:.2f} ms); K3 "
        f"launches {out['launches']['fused_topk']}; phase 17 in "
        f"{out['phase_s']:.1f} s; card {card}")
    if out["phase_s"] > TT_LIMIT_S:
        log(f"phase 17: over its {TT_LIMIT_S:.0f} s budget")
    return out


# Phase 18: the DLRM engine.  (a) the train loop at bench.py's DLRM
# shape; (b) the shipped engine.json through `pio train` / `pio deploy`
# on phase 12's store, its rate pairs written as impressions; (c) one
# warm cycle on a 20,000-impression delta through POST /reload.
DLRM_FIELDS, DLRM_VOCAB, DLRM_DENSE = 8, 100_000, 13   # bench.py:705-708
DLRM_EMBED, DLRM_BOTTOM, DLRM_TOP = 32, (64, 32), (128, 64)
DLRM_BATCH = 8_192                                      # bench.py:611
DLRM_ROWS, DLRM_EPOCHS = 800_000, 1                     # bench.py:743
DLRM_CTR = 0.25                                         # bench.py:717
DLRM_FUSED = 8
DLRM_NAN_ROWS = 65_536                    # the injected-NaN run's rows
DLRM_FACTORY = "predictionio_tpu_torch.templates.dlrm:engine"
DLRM_APP = "chipdlrm"
DLRM_CANDIDATES = 50                      # items a /queries.json ranks
DLRM_HELD_OUT = 20_000                    # impressions never written
DLRM_FACTORS = 4                          # the planted model's hidden rank
DLRM_DENSE_W = (0.8, -0.6, 0.4, 0.0)      # ... and its dense weights
DLRM_LIMIT_S = 150.0


def dlrm_state_leaves(dl, state):
    """Every tensor of a DLRM state (params, the Adagrad accumulator) in
    one fixed order."""
    return (dl._leaves(state.params)
            + dl._leaves(state.opt_state[0].sum_of_squares))


def dlrm_train_runs(dev, seed: int, card: str) -> dict:
    """Phase 18a: ``dlrm.train`` at bench.py's DLRM shape, from numpy and
    from the native feeder, at K=1 and K=8: examples/s, the probe's
    shares, peak device memory; K=8's state bitwise K=1's; and a NaN
    batch must raise TrainDiverged with no checkpoint directory."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import dlrm as dl
    from predictionio_tpu_torch.obs.runtime import get_timeline
    from predictionio_tpu_torch.resilience.supervision import TrainDiverged

    rng = np.random.default_rng(seed + 18)
    dense = rng.standard_normal((DLRM_ROWS, DLRM_DENSE), np.float32)
    cat = rng.integers(0, DLRM_VOCAB, (DLRM_ROWS, DLRM_FIELDS))
    labels = (rng.random(DLRM_ROWS) < DLRM_CTR).astype(np.float32)
    cfg = dl.DLRMConfig(
        vocab_sizes=(DLRM_VOCAB,) * DLRM_FIELDS, n_dense=DLRM_DENSE,
        embed_dim=DLRM_EMBED, bottom_mlp=DLRM_BOTTOM, top_mlp=DLRM_TOP,
        batch_size=DLRM_BATCH, epochs=DLRM_EPOCHS, seed=seed)
    t0 = time.perf_counter()
    # One init for every run, handed in as warm_state (train() copies it
    # onto the card and never changes it): the walls time the loop.
    init = dl.init_state(cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # Warm-up outside the walls: the first train of a process pays the
    # card's and PyTorch's first-call costs.
    t0 = time.perf_counter()
    warm_rows = 2 * DLRM_FUSED * DLRM_BATCH
    for source in ("numpy", "feeder"):
        for k in (1, DLRM_FUSED):
            dl.train(dense[:warm_rows], cat[:warm_rows], labels[:warm_rows],
                     cfg, data_source=source, fuse_steps=k,
                     warm_state=init, device=dev)
    torch.cuda.synchronize()
    out = {"init_s": init_s, "warmup_s": time.perf_counter() - t0,
           "runs": {}}
    finals = {}
    steps = DLRM_EPOCHS * -(-DLRM_ROWS // DLRM_BATCH)
    for source in ("numpy", "feeder"):
        for k in (1, DLRM_FUSED):
            timeline = get_timeline()
            timeline.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            state = dl.train(dense, cat, labels, cfg, data_source=source,
                             fuse_steps=k, warm_state=init, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if int(state.step) != steps:
                die(f"phase 18a {source} K={k}: {state.step} steps, not "
                    f"{steps}")
            summ = timeline.summary("dlrm")
            ms = summ["phase_ms"]
            out["runs"][f"{source}_k{k}"] = {
                "wall_s": wall,
                "examples_per_s": DLRM_ROWS * DLRM_EPOCHS / wall,
                "dispatches": summ["dispatches"],
                "device_wait_share": summ["phase_share"]["device_wait"],
                "h2d_share": summ["phase_share"]["h2d"],
                "host_wait_share": summ["phase_share"]["host_wait"],
                "dispatch_share": summ["phase_share"]["dispatch"],
                "h2d_overlap_ms": ms["h2d_overlap"],
                "peak_bytes": torch.cuda.max_memory_allocated() - base,
            }
            finals[(source, k)] = state
        a, b = finals[(source, 1)], finals[(source, DLRM_FUSED)]
        la, lb = dlrm_state_leaves(dl, a), dlrm_state_leaves(dl, b)
        if not all(torch.equal(x, y) for x, y in zip(la, lb)) or \
                a.step != b.step:
            worst = max(float((x - y).abs().max()) for x, y in zip(la, lb))
            die(f"phase 18a {source}: the K={DLRM_FUSED} state is not the "
                f"K=1 state bit for bit (max |diff| {worst:.3g})")
        if not all(bool(torch.isfinite(x).all()) for x in la):
            die(f"phase 18a {source}: non-finite trained state")
    del finals, a, b, la, lb
    # The finite-loss guard: one NaN dense feature poisons one batch.
    d = dense[:DLRM_NAN_ROWS].copy()
    d[DLRM_NAN_ROWS // 2, 0] = np.nan
    try:
        dl.train(d, cat[:DLRM_NAN_ROWS], labels[:DLRM_NAN_ROWS], cfg,
                 data_source="numpy", fuse_steps=DLRM_FUSED,
                 warm_state=init, device=dev)
        die("phase 18a: a NaN batch did not raise TrainDiverged")
    except TrainDiverged as e:
        out["diverged"] = str(e).split(" (")[0]
    out["table_mib"] = init.params["embed"].numel() * 4 / 2**20
    del init
    torch.cuda.empty_cache()
    return out


class dlrm_clicks:
    """The planted click model of 18b and 18c: each user and item name
    has hidden factors (drawn at first sight), each impression four
    dense features; P(click) = sigmoid(u·i / 2 + w·dense + bias), the
    bias set once so the training impressions click at DLRM_CTR."""

    def __init__(self, rng):
        self.rng = rng
        self.factors = {}
        self.bias = 0.0

    def _f(self, names):
        import numpy as np

        out = np.empty((len(names), DLRM_FACTORS))
        for j, name in enumerate(names):
            f = self.factors.get(name)
            if f is None:
                f = self.factors[name] = self.rng.standard_normal(
                    DLRM_FACTORS)
            out[j] = f
        return out

    def draw(self, users, items, calibrate: bool = False):
        """(dense [n, 4] rounded to 4 places, clicked [n] bool) for the
        (user, item) name pairs."""
        import numpy as np

        n = len(users)
        dense = np.round(self.rng.standard_normal((n, 4)), 4)
        z = (self._f(users) * self._f(items)).sum(1) / 2 \
            + dense @ np.asarray(DLRM_DENSE_W)
        if calibrate:
            lo, hi = -10.0, 10.0
            for _ in range(60):
                mid = (lo + hi) / 2
                rate = (1 / (1 + np.exp(-(z + mid)))).mean()
                lo, hi = (mid, hi) if rate < DLRM_CTR else (lo, mid)
            self.bias = (lo + hi) / 2
        p = 1 / (1 + np.exp(-(z + self.bias)))
        return dense, self.rng.random(n) < p


def dlrm_bags(dense, clicked):
    """The impressions' property bags as the JSON text ``json.dumps``
    writes (floats by ``repr``)."""
    return [f'{{"clicked": {"true" if c else "false"}, "dense": '
            f'[{a!r}, {b!r}, {e!r}, {f!r}]}}'
            for c, (a, b, e, f) in zip(clicked.tolist(), dense.tolist())]


def dlrm_logloss(p, y) -> float:
    """The mean binary log-loss of probabilities ``p`` on labels ``y``
    (clipped as the template's warm-start gate clips)."""
    import numpy as np

    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    y = np.asarray(y, np.float64)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def dlrm_phase(dev, seed: int, loop: dict, mods: dict, card: str) -> dict:
    """Phase 18: (a) :func:`dlrm_train_runs`; (b) phase 12's 1,000,209
    (user, item) rate pairs written as impressions of a planted click
    model into a new app of its store, `pio train` of the port's
    shipped dlrm engine.json (in process), `pio deploy` as a subprocess
    answering 64 /queries.json of 50 candidates each, every answer's
    order and scores held against ``dlrm.predict_proba`` of the
    persisted state, and a held-out log-loss against the constant-CTR
    predictor; (c) 20,000 impressions after the watermark, a warm
    ``run_train(warm_from=)`` promoted through POST /reload, 64 answers
    held against the warm state.  Raises (dies) on any failure."""
    import datetime as dt
    import logging
    import zlib

    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.models import dlrm as dl
    from predictionio_tpu_torch.refresh import WarmStartContext
    from predictionio_tpu_torch.templates.dlrm import engine
    from predictionio_tpu_torch.version import __version__
    from predictionio_tpu_torch.workflow.core_workflow import (
        data_watermark, load_models)

    phase_t0 = time.perf_counter()
    out = {"train": dlrm_train_runs(dev, seed, card)}
    work = loop["work"]
    spec = json.loads((Path(__file__).resolve().parent /
                       "predictionio_tpu_torch" / "templates" / "dlrm" /
                       "engine.json").read_text())
    if spec["engineFactory"] != DLRM_FACTORY:
        die(f"phase 18: the shipped engine.json names "
            f"{spec['engineFactory']}")
    ds = spec["datasource"]["params"]
    ds["appName"] = DLRM_APP
    algo = spec["algorithms"][0]["params"]
    algo["seed"] = seed
    n_dense = ds["nDense"]
    user_vocab = ds.get("userVocab", 65536)
    item_vocab = ds.get("itemVocab", 65536)
    engine_json = os.path.join(work, "dlrm.json")
    Path(engine_json).write_text(json.dumps(spec))
    env = cli_env(os.path.join(work, "home"))
    env.values.update(PIO_RESULT_CACHE="0", PIO_RETRIEVAL_RUNG=None,
                      PIO_FUSE_STEPS=None, PIO_PREFETCH_DEPTH=None,
                      PIO_BATCH_AUTOSCALE=None)
    rng = np.random.default_rng(seed + 181)
    clicks = dlrm_clicks(rng)
    server = None
    captured = []

    class _Gate(logging.Handler):
        def emit(self, record):
            captured.append(record.getMessage())

    gate = _Gate(level=logging.INFO)
    tpl_log = logging.getLogger(
        "predictionio_tpu_torch.templates.dlrm.engine")
    reg = mods["get_registry"]()

    def read_ms() -> float:
        h = reg.get("pio_train_phase_ms")
        return 0.0 if h is None else h.sum(phase="train.datasource")

    def hashed(user, items):
        return np.stack([
            np.full(len(items), zlib.crc32(user.encode()) % user_vocab),
            np.array([zlib.crc32(i.encode()) % item_vocab for i in items])],
            axis=1)

    def hold(ans, q, state, cfg, what) -> float:
        """One answer: its items the candidates, each score the plain
        predict_proba of ``state`` (rtol = atol = 1e-5), ranked by it
        (an order may differ only within that size).  Returns max
        |err|."""
        hits = ans["itemScores"]
        if sorted(h["item"] for h in hits) != sorted(q["items"]):
            die(f"phase 18 {what}: the answer ranks other items")
        d = list(q.get("dense") or [])[:n_dense]
        d += [0.0] * (n_dense - len(d))
        want = dl.predict_proba(
            state, np.tile(np.asarray(d, np.float32), (len(q["items"]), 1)),
            hashed(q["user"], q["items"]), cfg).cpu().numpy()
        by_item = dict(zip(q["items"], want.tolist()))
        got = np.array([h["score"] for h in hits])
        ref_ = np.array([by_item[h["item"]] for h in hits])
        tol = ATOL + RTOL * np.abs(ref_)
        if np.any(np.abs(got - ref_) > tol):
            die(f"phase 18 {what}: scores differ from predict_proba by "
                f"{np.abs(got - ref_).max():.3g}")
        if np.any(np.diff(got) > 2 * tol[1:]):
            die(f"phase 18 {what}: the answer is not ranked by score")
        return float(np.abs(got - ref_).max())

    def serve(queries, state, cfg, what):
        """The queries over HTTP, each held; returns (max |err|, p50
        ms)."""
        err, lats = 0.0, []
        for j, q in enumerate(queries):
            t = time.perf_counter()
            ans, _ = post_json(f"{server.base}/queries.json", q)
            lats.append(time.perf_counter() - t)
            err = max(err, hold(ans, q, state, cfg, f"{what} {j}"))
        return err, sorted(lats)[len(lats) // 2] * 1e3

    env.__enter__()
    reset_storage()
    try:
        # -- b: impressions, pio train (in-process), pio deploy ----------
        users, items, stars, _ = ml1m_events(seed)
        rate = ~np.isnan(stars)
        u_names = np.array([f"u{u}" for u in range(ML1M_USERS)])[
            users[rate]]
        i_names = np.array([f"i{i}" for i in range(ML1M_ITEMS)])[
            items[rate]]
        n = len(u_names)
        dense, clicked = clicks.draw(u_names, i_names, calibrate=True)
        storage = get_storage()
        start_us = int((time.time() - 40 * 86400) * 1e6)
        bags = dlrm_bags(dense, clicked)
        _, out["write_s"] = tpl_write(storage, DLRM_APP, [
            ("impression", "user", u, i, b)
            for u, i, b in zip(u_names.tolist(), i_names.tolist(), bags)],
            start_us)
        del bags
        out["n"], out["ctr"] = n, float(clicked.mean())
        before = read_ms()
        t0 = time.perf_counter()
        if mods["pio"](["train", "--engine-json", engine_json]) != 0:
            die("phase 18: pio train (dlrm) failed")
        out["train_s"] = time.perf_counter() - t0
        out["read_ms"] = read_ms() - before
        eng = engine()
        variant = mods["EngineVariant"].from_file(engine_json)
        instances = storage.get_engine_instances()
        inst1 = instances.get_latest_completed(
            variant.engine_factory, __version__, variant.variant_id)
        ctx = mods["RuntimeContext"](storage=storage, device=dev)
        [w1] = load_models(eng, inst1, ctx)
        steps = algo["epochs"] * -(-n // algo["batchSize"])
        leaves = dlrm_state_leaves(dl, w1.state)
        if w1.n_examples != n or w1.state.step != steps or \
                w1.state.params["embed"].device.type != dev.type or \
                not all(bool(torch.isfinite(x).all()) for x in leaves):
            die(f"phase 18: the trained model has {w1.n_examples} "
                f"examples, {w1.state.step} steps (want {n}, {steps})")
        # held-out impressions of the same pairs, never written
        pick = rng.choice(n, DLRM_HELD_OUT, replace=False)
        hd, hc = clicks.draw(u_names[pick], i_names[pick])
        cat_h = np.stack([
            np.array([zlib.crc32(u.encode()) % user_vocab
                      for u in u_names[pick].tolist()]),
            np.array([zlib.crc32(i.encode()) % item_vocab
                      for i in i_names[pick].tolist()])], axis=1)
        proba = dl.predict_proba(w1.state, hd.astype(np.float32), cat_h,
                                 w1.cfg).cpu().numpy()
        out["logloss"] = dlrm_logloss(proba, hc)
        out["logloss_const"] = dlrm_logloss(
            np.full(len(hc), out["ctr"]), hc)
        if not out["logloss"] < out["logloss_const"]:
            die(f"phase 18: held-out log-loss {out['logloss']:.4f} is not "
                f"below the constant CTR's {out['logloss_const']:.4f}")
        server = deployed(engine_json, os.path.join(work, "dlrm.log"),
                          phase="phase 18")
        if server.instance != inst1.id or \
                not server.device.startswith(dev.type):
            die(f"phase 18: deploy serves {server.instance} on "
                f"{server.device}")
        known_items = [f"i{i}" for i in range(ML1M_ITEMS)]
        queries = []
        for j in range(CLI_QUERIES):
            user = f"newu{j}" if j % 8 == 7 else \
                str(u_names[rng.integers(n)])
            cand = [known_items[k] for k in rng.choice(
                ML1M_ITEMS, DLRM_CANDIDATES, replace=False)]
            if j % 4 == 3:          # unseen items land in hash buckets
                cand[-5:] = [f"newi{j}_{k}" for k in range(5)]
            q = {"user": user, "items": cand}
            if j % 16 != 15:
                q["dense"] = np.round(rng.standard_normal(
                    n_dense if j % 5 else 2), 4).tolist()
            queries.append(q)
        out["query_err"], out["p50_ms"] = serve(queries, w1.state, w1.cfg,
                                                "/queries.json")

        # -- c: one warm cycle on a 20,000-impression delta --------------
        wm1 = data_watermark(inst1)
        rows = refresh_delta(rng, list(dict.fromkeys(u_names.tolist())),
                             known_items, REFRESH_DELTA, REFRESH_NEW_USERS,
                             REFRESH_NEW_ITEMS, REFRESH_TOUCHED_USERS, "d")
        du = [r[0] for r in rows]
        di = [r[1] for r in rows]
        d_dense, d_clicked = clicks.draw(du, di)
        stamp = dt.datetime.now(dt.timezone.utc)
        if stamp <= wm1:
            die(f"phase 18: the clock reads {stamp}, not after the "
                f"watermark {wm1}")
        stamp_us = int(stamp.timestamp() * 1e6)
        app_id = storage.get_apps().get_by_name(DLRM_APP).id
        storage.get_events().insert_columnar({
            "event": ["impression"] * len(rows),
            "entity_type": ["user"] * len(rows), "entity_id": du,
            "target_entity_type": ["item"] * len(rows),
            "target_entity_id": di,
            "properties": dlrm_bags(d_dense, d_clicked),
            "event_time_us": [stamp_us + k for k in range(len(rows))],
            "creation_time_us": [stamp_us + k for k in range(len(rows))]},
            app_id)
        warm = WarmStartContext(instance=inst1, models=[w1],
                                start_time=wm1)
        tpl_log.addHandler(gate)
        tpl_log.setLevel(logging.INFO)
        t0 = time.perf_counter()
        wid = mods["run_train"](
            eng, variant, mods["RuntimeContext"].create(storage=storage,
                                                        device=dev),
            warm_from=warm)
        out["warm_s"] = time.perf_counter() - t0
        inst2 = instances.get(wid)
        mode = inst2.env.get("refreshMode")
        if mode != "warm":
            die(f"phase 18: the warm cycle came out {mode!r} ({captured})")
        gate_lines = [m for m in captured if "delta-sample logloss" in m]
        if not gate_lines:
            die("phase 18: the warm start logged no delta-sample logloss")
        out["warm_gate"] = gate_lines[-1].split("logloss ")[-1]
        [w2] = load_models(eng, inst2, ctx)
        warm_steps = steps + algo["epochs"] * -(-REFRESH_DELTA //
                                                algo["batchSize"])
        if w2.n_examples != n + REFRESH_DELTA or \
                w2.state.step != warm_steps:
            die(f"phase 18: the warm generation has {w2.n_examples} "
                f"examples, {w2.state.step} steps")
        st, body, out["reload_s"] = post_status(f"{server.base}/reload",
                                                {"engineInstanceId": wid})
        if st != 200:
            die(f"phase 18: POST /reload answered {st} {body}")
        fresh = [{**q, "user": u} for q, u in zip(
            queries, dict.fromkeys(u for u in du if u.startswith("du")))]
        out["warm_err"], out["warm_p50_ms"] = serve(
            queries[:CLI_QUERIES // 2] + fresh[:CLI_QUERIES // 2],
            w2.state, w2.cfg, "warm answer")
        server.stop()
        server = None
    finally:
        tpl_log.removeHandler(gate)
        if server is not None:
            server.kill()
        reset_storage()
        env.__exit__()
    out["phase_s"] = time.perf_counter() - phase_t0
    tr = out["train"]
    runs = " | ".join(
        f"{name}: {r['examples_per_s']:.0f} ex/s ({r['wall_s']:.2f} s, "
        f"{r['dispatches']} dispatches; shares device_wait "
        f"{r['device_wait_share']:.3f} h2d {r['h2d_share']:.3f} host_wait "
        f"{r['host_wait_share']:.3f} dispatch {r['dispatch_share']:.3f}; "
        f"h2d overlapped {r['h2d_overlap_ms']:.0f} ms; peak "
        f"{r['peak_bytes'] / 2**20:.0f} MiB)"
        for name, r in tr["runs"].items())
    log(f"phase 18 dlrm train: {DLRM_FIELDS} fields x {DLRM_VOCAB} rows "
        f"(table {tr['table_mib']:.0f} MiB), {DLRM_DENSE} dense, embed "
        f"{DLRM_EMBED}, bottom {list(DLRM_BOTTOM)}, top {list(DLRM_TOP)}, "
        f"batch {DLRM_BATCH}, {DLRM_ROWS} rows x {DLRM_EPOCHS} epochs at "
        f"CTR {DLRM_CTR} (init {tr['init_s']:.2f} s and a warm-up of 4 "
        f"short trains {tr['warmup_s']:.2f} s, outside the walls): {runs}; "
        f"K={DLRM_FUSED} state equals K=1 bit for bit from both sources; "
        f"a NaN batch raised {tr['diverged']!r}; card {card}")
    log(f"phase 18 dlrm pio loop: {out['n']} impressions (CTR "
        f"{out['ctr']:.4f}) written in {out['write_s']:.2f} s; pio train "
        f"(shipped engine.json: embed {algo['embedDim']}, bottom "
        f"{algo['bottomMlp']}, top {algo['topMlp']}, {algo['epochs']} "
        f"epochs, batch {algo['batchSize']}, {steps} steps) "
        f"{out['train_s']:.2f} s, read {out['read_ms']:.0f} ms; held-out "
        f"log-loss {out['logloss']:.4f} vs the constant CTR's "
        f"{out['logloss_const']:.4f} on {DLRM_HELD_OUT}; pio deploy on the "
        f"card: {CLI_QUERIES} /queries.json of {DLRM_CANDIDATES} items p50 "
        f"{out['p50_ms']:.2f} ms, each ranked by predict_proba of the "
        f"persisted state (max |err| {out['query_err']:.3g}); warm cycle on "
        f"{REFRESH_DELTA} delta impressions {out['warm_s']:.2f} s, mode "
        f"warm, delta-sample logloss {out['warm_gate']}; POST /reload "
        f"{out['reload_s'] * 1e3:.1f} ms; {CLI_QUERIES} answers "
        f"({CLI_QUERIES // 2} of new users) held against the warm state "
        f"(max |err| {out['warm_err']:.3g}, p50 {out['warm_p50_ms']:.2f} "
        f"ms); phase 18 in {out['phase_s']:.1f} s; card {card}")
    if out["phase_s"] > DLRM_LIMIT_S:
        log(f"phase 18: over its {DLRM_LIMIT_S:.0f} s budget")
    return out


# Phase 19: supervision, checkpoints and traces, each run where its
# inputs live: 19a on phase 6's ML-25M inputs, 19b-e on phase 12's store
# before phase 16 changes it (so phase 12's own eval is the uninterrupted
# sweep 19c is held against).
SUPERVISE_EVERY = 2              # sweeps a checkpoint (19a, 19b)
PHASE19_LIMIT_S = 45.0           # the whole phase's budget


def held_equal(got, want, what: str) -> None:
    """Two ALS models' factors bit for bit (``torch.equal``)."""
    import numpy as np
    import torch

    for side in ("user_factors", "item_factors"):
        g = torch.from_numpy(np.ascontiguousarray(getattr(got, side)))
        w = torch.from_numpy(np.ascontiguousarray(getattr(want, side)))
        if g.shape != w.shape or not torch.equal(g, w):
            diff = float((g - w).abs().max()) if g.shape == w.shape \
                else float("nan")
            die(f"{what}: {side} differ from the uninterrupted train's "
                f"(max |diff| {diff:.3g})")


def supervised_als_runs(dev, train: dict, als, fg, rs, card: str) -> dict:
    """Phase 19a: phase 6's ML-25M train (rank 64, 10 iterations) again
    under sweep checkpoints every SUPERVISE_EVERY sweeps: uninterrupted,
    preempted after its second chunk (TrainPreempted at sweep 4, the
    step file on disk) then resumed, and with one chunk's factors made
    NaN (rolled back and replayed); each must equal phase 6's
    uninterrupted factors bit for bit."""
    from predictionio_tpu_torch.obs import get_registry
    from predictionio_tpu_torch.resilience import supervision as sup

    inputs, cfg, plain = train["inputs"], train["cfg"], train["model"]
    work = tempfile.mkdtemp(prefix="pio_chip_ckpt_")
    real_loop = als._train_loop
    div = get_registry().counter(
        "pio_train_divergence_total",
        "Non-finite loss/params observations per training loop.", ("fn",))
    phase_t0 = time.perf_counter()
    walls = {}

    def run(name, what):
        ck = os.path.join(work, name)
        t0 = time.perf_counter()
        model = als.train_als_prepared(inputs, cfg, checkpoint_dir=ck,
                                       save_every=SUPERVISE_EVERY)
        walls[name] = time.perf_counter() - t0
        held_equal(model, plain, f"phase 19a {what}")
        if os.listdir(ck):
            die(f"phase 19a {what}: the completed run left {os.listdir(ck)}")
        return model

    fg.LAUNCHES = 0                          # main path starts here
    rs.LU_LAUNCHES = 0
    try:
        run("plain", "checkpointed, uninterrupted")
        calls = [0]

        def preempting(*a, **k):
            out = real_loop(*a, **k)
            calls[0] += 1
            if calls[0] == 2:
                sup.request_preemption()     # the SIGTERM flag
            return out

        als._train_loop = preempting
        ck = os.path.join(work, "preempted")
        try:
            als.train_als_prepared(inputs, cfg, checkpoint_dir=ck,
                                   save_every=SUPERVISE_EVERY)
            die("phase 19a: a preemption after the second chunk did not "
                "raise TrainPreempted")
        except sup.TrainPreempted as e:
            if (e.step, e.checkpointed) != (2 * SUPERVISE_EVERY, True):
                die(f"phase 19a: preempted at {e.step} ({e})")
        finally:
            als._train_loop = real_loop
            sup.clear_preemption()
        saved = sorted(os.listdir(ck))
        step_file = os.path.join(ck, f"{2 * SUPERVISE_EVERY}.pt")
        if not os.path.exists(step_file):
            die(f"phase 19a: no step-{2 * SUPERVISE_EVERY} checkpoint "
                f"({saved})")
        ckpt_mb = os.path.getsize(step_file) / 2 ** 20
        run("preempted", "resumed after a preemption")
        calls = [0]
        before = div.value(fn="als")

        def poisoned(*a, **k):
            uf, itf = real_loop(*a, **k)
            calls[0] += 1
            if calls[0] == 3:
                uf[0, 0] = float("nan")
            return uf, itf

        als._train_loop = poisoned
        try:
            run("nan", "rolled back from a NaN chunk")
        finally:
            als._train_loop = real_loop
        n_chunks = -(-cfg.iterations // SUPERVISE_EVERY)
        if calls[0] != n_chunks + 1 or div.value(fn="als") != before + 1:
            die(f"phase 19a: {calls[0]} chunks for {n_chunks} and one "
                f"replay, divergences +{div.value(fn='als') - before}")
        launches = {"fused_gram": fg.LAUNCHES,
                    "ridge_solve_lu": rs.LU_LAUNCHES}   # and ends here
    finally:
        als._train_loop = real_loop
        shutil.rmtree(work, ignore_errors=True)
    for name, n in launches.items():
        if n == 0:
            die(f"phase 19a: {name} never launched")
    out = {"launches": launches, "walls": walls, "ckpt_mb": ckpt_mb,
           "phase_s": time.perf_counter() - phase_t0}
    log(f"phase 19a supervised ALS: ML-25M, rank {RANK}, {cfg.iterations} "
        f"iterations, a checkpoint every {SUPERVISE_EVERY} sweeps "
        f"({ckpt_mb:.1f} MiB a save, {saved} on disk at the preemption): "
        f"uninterrupted {walls['plain']:.2f} s, resumed from sweep "
        f"{2 * SUPERVISE_EVERY} {walls['preempted']:.2f} s, NaN chunk rolled "
        f"back and replayed {walls['nan']:.2f} s; each torch.equal to phase "
        f"6's uninterrupted factors; launches {json.dumps(launches)}; the "
        f"phase {out['phase_s']:.2f} s; card {card}")
    return out


def checkpoint_cli_phase(dev, loop: dict, mods: dict, card: str) -> dict:
    """Phase 19b-e on phase 12's store, before phase 16 changes it:
    19b `pio train --checkpoint-dir D --checkpoint-every 2` with a
    SIGTERM during the read (exit 143, a PREEMPTED instance, the step-2
    file), the same command again (exit 0) equal to an uninterrupted
    `pio train` by entity id bit for bit; 19c `pio eval --checkpoint-dir` SIGTERM'd
    after its first (candidate, fold) unit (143), the same command
    training only the other units and scoring phase 12's eval exactly;
    19d one run_train under PIO_PROFILE_DIR, whose Chrome trace must name
    K1's and K2's CUDA functions; 19e `pio deploy --no-batcher`:
    /traces.json?request_id= resolves a query's span tree http.request ⊃
    batcher.dispatch ⊃ retrieval (chunked rung, K3)."""
    import signal

    import numpy as np

    fg, rs, ft, pio = mods["fg"], mods["rs"], mods["ft"], mods["pio"]
    from predictionio_tpu_torch.controller import engine as ctl_engine
    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.obs.profiler import TRACE_FILE
    from predictionio_tpu_torch.resilience import supervision as sup
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    tpl = importlib.import_module(
        "predictionio_tpu_torch.templates.recommendation.engine")
    phase_t0 = time.perf_counter()
    work, engine_json = loop["work"], loop["engine_json"]
    env = cli_env(os.path.join(work, "home"))
    env.values.update(PIO_CHECKPOINT_DIR=None, PIO_CHECKPOINT_EVERY=None,
                      PIO_EVAL_CHECKPOINT_DIR=None, PIO_PROFILE_DIR=None,
                      PIO_BATCH_ENABLED=None)
    out, launches, server = {}, {}, None
    env.__enter__()
    reset_storage()
    try:
        storage = get_storage()
        instances = storage.get_engine_instances()
        eng = mods["engine"]()
        variant = mods["EngineVariant"].from_file(engine_json)
        ctx = mods["RuntimeContext"](storage=storage, device=dev)

        def newest():
            return max(instances.get_all(), key=lambda i: i.start_time)

        def by_entity(inst):
            """(names, rows) of an instance's user and item factors, in
            the order of the names."""
            [w] = load_models(eng, inst, ctx)
            uf, itf = w.host_factors()
            users, items = sorted(w.user_index.keys()), \
                sorted(w.item_index.keys())
            return (users, items,
                    uf[[w.user_index[u] for u in users]],
                    itf[[w.item_index[i] for i in items]])

        # -- 19b: a SIGTERM'd pio train, then the same command -------------
        ck = os.path.join(work, "ckpt")
        argv = ["train", "--engine-json", engine_json, "--checkpoint-dir",
                ck, "--checkpoint-every", str(SUPERVISE_EVERY)]
        ds = tpl.RecommendationDataSource
        real_read = ds.read_training

        def read_then_sigterm(self, c):
            os.kill(os.getpid(), signal.SIGTERM)   # lands during the read
            return real_read(self, c)

        fg.LAUNCHES = 0                        # main path starts here
        rs.LU_LAUNCHES = 0
        ft.LAUNCHES = 0
        ds.read_training = read_then_sigterm
        t0 = time.perf_counter()
        try:
            rc = pio(argv)
        finally:
            ds.read_training = real_read
            sup.clear_preemption()   # the flag outlives the verb
        out["preempted_s"] = time.perf_counter() - t0
        first = newest()
        saved = sorted(os.listdir(os.path.join(ck, "als"))) \
            if os.path.isdir(os.path.join(ck, "als")) else []
        if rc != 143 or first.status != "PREEMPTED" or \
                f"{SUPERVISE_EVERY}.pt" not in saved:
            die(f"phase 19b: pio train exited {rc}, instance "
                f"{first.status}, checkpoints {saved}")
        t0 = time.perf_counter()
        if pio(argv) != 0:
            die("phase 19b: the resumed pio train failed")
        out["resumed_s"] = time.perf_counter() - t0
        resumed = newest()
        if os.listdir(os.path.join(ck, "als")):
            die("phase 19b: the completed train left its checkpoints")
        # the uninterrupted train of the same store (phase 12's train
        # predates its fold-in events), without the checkpoint flags
        for k in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY"):
            os.environ.pop(k, None)
        t0 = time.perf_counter()
        if pio(["train", "--engine-json", engine_json]) != 0:
            die("phase 19b: the uninterrupted pio train failed")
        out["plain_s"] = time.perf_counter() - t0
        want, got = by_entity(newest()), by_entity(resumed)
        if resumed.status != "COMPLETED" or got[:2] != want[:2] or not (
                np.array_equal(got[2], want[2])
                and np.array_equal(got[3], want[3])):
            diff = "different entities" if got[:2] != want[:2] else (
                f"max |diff| users {np.abs(got[2] - want[2]).max():.3g}, "
                f"items {np.abs(got[3] - want[3]).max():.3g}")
            die(f"phase 19b: the resumed train ({resumed.status}) differs "
                f"from the uninterrupted one by entity id ({diff})")

        # -- 19c: a SIGTERM'd pio eval, then the same command --------------
        eck = os.path.join(work, "eval_ckpt")
        eargv = ["eval", "predictionio_tpu_torch.templates.recommendation."
                 "evaluation:evaluation", "chip_smoke:cli_eval_params",
                 "--checkpoint-dir", eck, "--output-json",
                 os.path.join(work, "eval19.json")]
        real_put = ctl_engine.EvalCheckpoint.put
        algo = tpl.ALSAlgorithm
        real_train = algo.train
        trains = [0]

        def put_then_sigterm(self, ci, fi, result):
            real_put(self, ci, fi, result)
            os.kill(os.getpid(), signal.SIGTERM)

        def counted_train(self, *a, **k):
            trains[0] += 1
            return real_train(self, *a, **k)

        ctl_engine.EvalCheckpoint.put = put_then_sigterm
        algo.train = counted_train
        t0 = time.perf_counter()
        try:
            rc = pio(eargv)
            sup.clear_preemption()
            units = sorted(os.listdir(eck))
            first_trains = trains[0]
            ctl_engine.EvalCheckpoint.put = real_put
            if rc != 143 or first_trains != 1 or len(units) != 1:
                die(f"phase 19c: pio eval exited {rc} after {first_trains} "
                    f"train(s), units {units}")
            out["eval_preempted_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if pio(eargv) != 0:
                die("phase 19c: the resumed pio eval failed")
            out["eval_resumed_s"] = time.perf_counter() - t0
        finally:
            ctl_engine.EvalCheckpoint.put = real_put
            algo.train = real_train
        res = json.loads(Path(os.path.join(work, "eval19.json")).read_text())
        scores = [c["score"] for c in res["candidates"]]
        if trains[0] - first_trains != 3 or scores != loop["eval_scores"] \
                or os.listdir(eck):
            die(f"phase 19c: the resumed eval trained "
                f"{trains[0] - first_trains} unit(s), scored {scores} "
                f"against phase 12's {loop['eval_scores']}, left "
                f"{os.listdir(eck)}")
        launches = {"fused_gram": fg.LAUNCHES,
                    "ridge_solve_lu": rs.LU_LAUNCHES,
                    "fused_topk": ft.LAUNCHES}

        # -- 19d: run_train under PIO_PROFILE_DIR --------------------------
        prof_dir = os.path.join(work, "profile")
        before = (fg.LAUNCHES, rs.LU_LAUNCHES)
        t0 = time.perf_counter()
        with env_vars(PIO_PROFILE_DIR=prof_dir):
            mods["run_train"](eng, variant, mods["RuntimeContext"].create(
                storage=storage, device=dev))
        out["profiled_s"] = time.perf_counter() - t0
        profiled = (fg.LAUNCHES - before[0], rs.LU_LAUNCHES - before[1])
        trace = json.loads(Path(prof_dir, TRACE_FILE).read_text())
        kernels = [e["name"] for e in trace.get("traceEvents", ())
                   if e.get("cat") == "kernel"]
        k1 = sum("gram_kernel" in k for k in kernels)
        k2 = sum("chol_" in k or "ridge_kernel" in k for k in kernels)
        if not k1 or not k2:
            cats = {}
            for e in trace.get("traceEvents", ()):
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            die(f"phase 19d: the profiler's trace names no K1 ({k1}) or K2 "
                f"({k2}) function among {len(kernels)} kernels "
                f"{sorted(set(kernels))[:20]}; events by category {cats}; "
                f"launches in the window {profiled}")
        out["trace_mb"] = os.path.getsize(
            os.path.join(prof_dir, TRACE_FILE)) / 2 ** 20
        launches["fused_gram"] = fg.LAUNCHES
        launches["ridge_solve_lu"] = rs.LU_LAUNCHES

        # -- 19e: a deploy with traces -------------------------------------
        server = deployed(engine_json, os.path.join(work, "deploy19.log"),
                          extra=("--no-batcher",), phase="phase 19e")
        req = urllib.request.Request(
            server.base + "/queries.json",
            data=json.dumps({"user": "u1", "num": 10}).encode(),
            method="POST", headers={"Content-Type": "application/json",
                                    "X-Request-ID": "chip-19e"})
        with urllib.request.urlopen(req, timeout=120) as r:
            if r.headers.get("X-Request-ID") != "chip-19e":
                die("phase 19e: the answer lost its X-Request-ID")
            answer = json.loads(r.read())
        one = json.loads(server.get("/traces.json?request_id=chip-19e"))
        slow = json.loads(server.get("/traces.json?min_ms=1e9"))
        [tree] = one["traces"] or [None]
        handle = [s for s in (tree or {}).get("spans", ())
                  if s["name"] == "http.handle"]
        dispatch = [s for s in (handle[0].get("spans", ()) if handle else ())
                    if s["name"] == "batcher.dispatch" and "spans" in s]
        retrieval = [s for s in (dispatch[0]["spans"] if dispatch else ())
                     if s["name"] == "retrieval"]
        if tree is None or tree["name"] != "http.request" or not retrieval \
                or retrieval[0]["attrs"].get("rung") != "chunked" \
                or slow["traces"] or len(answer["itemScores"]) != 10:
            die(f"phase 19e: /traces.json?request_id=chip-19e gave {one}")
        server.stop()
        launches["fused_topk"] += server.launches["fused_topk"]
        if not server.launches["fused_topk"]:
            die("phase 19e: the deploy never launched fused_topk")
        out["trace_tree"] = [tree["name"], handle[0]["name"],
                             dispatch[0]["name"], retrieval[0]["name"]]
        server = None
        for name, n in launches.items():    # main path ends here
            if n == 0:
                die(f"phase 19b-e: {name} never launched")
    finally:
        if server is not None:
            server.kill()
        reset_storage()
        env.__exit__()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - phase_t0
    # The store's latest generation is now 19d's, whose read took in
    # phase 12's fold-in events: phase 16's delta window starts after
    # them.
    loop["fold_events"] = 0
    log(f"phase 19b pio train --checkpoint-every {SUPERVISE_EVERY} on phase "
        f"12's store: SIGTERM during the read → exit 143, instance "
        f"PREEMPTED, {saved} on disk, {out['preempted_s']:.2f} s; the same "
        f"command → exit 0 in {out['resumed_s']:.2f} s, its factors equal "
        f"an uninterrupted pio train's ({out['plain_s']:.2f} s) by entity "
        f"id bit for bit ({len(got[0])} users, {len(got[1])} items); card "
        f"{card}")
    log(f"phase 19c pio eval --checkpoint-dir: SIGTERM after unit (0, 0) → "
        f"exit 143 in {out['eval_preempted_s']:.2f} s; the same command "
        f"trained the other 3 units in {out['eval_resumed_s']:.2f} s and "
        f"scored {scores}, phase 12's exactly")
    log(f"phase 19d run_train under PIO_PROFILE_DIR: {out['profiled_s']:.2f} "
        f"s, Chrome trace {out['trace_mb']:.1f} MiB with {len(kernels)} "
        f"kernel events, K1 functions {k1} (launches {profiled[0]}), K2 "
        f"functions {k2} (launches {profiled[1]})")
    log(f"phase 19e pio deploy --no-batcher: /traces.json?request_id= "
        f"resolved {' > '.join(out['trace_tree'])} (rung chunked); "
        f"launches 19b-e {json.dumps(launches)}; phases 19b-e "
        f"{out['phase_s']:.2f} s; card {card}")
    return out


# Phase 20: the serving waterfall, the SLO engine behind /ready, and the
# quality monitors' canary gate, in-process on phase 12's store after
# phases 16-18 (its newest generation; the engine server and the event
# server share one process, so the feedback join is process-local, as in
# the reference).
P20_QUERIES = 256            # 20a: /queries.json, distinct users ...
P20_THREADS = 8              # ... from this many client threads
P20_STAGES = ("ingress", "bind", "queue_wait", "batch_wait", "dispatch",
              "retrieval", "serialize", "shed_check")
P20_SLO_QUERIES = 24         # 20b: dispatched queries of the burn
P20_SLO_TARGET_MS = "0.5"    # 20b: below a dispatched request's handler
#                              time, above a result-cache hit's
P20_FEEDBACK = 64            # 20c: buys echoing 20a's serve ids ...
P20_PLANTED = 40             # ... of which this many target a served item
P20_CANARY_S = 3.0           # 20d: the daemon's canary window
P20_CLIENTS = 4              # 20d: client threads across each window
P20_DRIFT_SCALE = 4.0        # 20d: tests/test_quality.py's planted fault
P20_HELD = 32                # 20d: answers held after the rollback
PHASE20_LIMIT_S = 45.0


def http_call(url: str, obj=None):
    """GET (``obj`` None) or POST ``obj``; returns (status, headers,
    JSON answer) whatever the status."""
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(
        url, data=data, method="GET" if obj is None else "POST",
        headers={} if obj is None else {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read() or b"{}")


class _Answer:
    """A response already read: what ``HttpPromoter``'s reads need."""

    def __init__(self, status: int, data: bytes):
        self.status, self._data = status, data

    def read(self) -> bytes:
        return self._data

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class recorded_opener:
    """An ``HttpPromoter`` opener that keeps every (method, path, status,
    answer) it carried, so a phase can read what the daemon saw."""

    def __init__(self):
        self.calls = []

    def __call__(self, req, timeout=30.0):
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, data = r.status, r.read()
        self.calls.append((req.get_method(), req.selector, status,
                           json.loads(data or b"{}")))
        return _Answer(status, data)


class query_load:
    """``threads`` client threads posting /queries.json (num 10) for
    ``users`` in turn to the instances of ``bases`` (thread n on
    ``bases[n % len(bases)]``, or the whole list in turn with
    ``spread``), until ``stop()``, which returns (instance, user index,
    status, answer, client ms) of every request."""

    def __init__(self, bases, users, threads: int, spread: bool = True):
        import threading

        self.stop_ev = threading.Event()
        self.answers = [[] for _ in range(threads)]

        def run(n):
            j = n
            while not self.stop_ev.is_set():
                b = (j if spread else n) % len(bases)
                u = j % len(users)
                t0 = time.perf_counter()
                st, _, ans = http_call(f"{bases[b]}/queries.json",
                                       {"user": users[u], "num": 10})
                self.answers[n].append(
                    (b, u, st, ans, (time.perf_counter() - t0) * 1e3))
                j += threads

        # daemon: a phase that dies mid-load leaves no thread behind
        self.threads = [threading.Thread(target=run, args=(n,), daemon=True)
                        for n in range(threads)]
        for t in self.threads:
            t.start()

    def stop(self) -> list:
        self.stop_ev.set()
        for t in self.threads:
            t.join(120)
        return [a for aa in self.answers for a in aa]


def read_request_log(path: str, n: int, timeout_s: float = 20.0) -> list:
    """The first ``n`` wide events of a PIO_REQUEST_LOG file: a line lands
    after its answer reached the client, so poll."""
    deadline = time.perf_counter() + timeout_s
    while True:
        rows = []
        if os.path.exists(path):
            for line in Path(path).read_text().splitlines():
                if line.endswith("}"):
                    rows.append(json.loads(line))
        if len(rows) >= n:
            return rows
        if time.perf_counter() > deadline:
            die(f"phase 20a: the request log holds {len(rows)} of {n} "
                "wide events")
        time.sleep(0.05)


def obs_phase(dev, seed: int, loop: dict, mods: dict, card: str) -> dict:
    """Phase 20: an EngineServer and an EventServer in this process on
    phase 12's store.  20a the waterfall of 256 concurrent queries (wide
    events, attested ratio, an exemplar resolved to its trace); 20b
    /ready under a burn and its recovery, and with PIO_READY_SLO=off;
    20c the feedback join of echoed buys; 20d the canary gate: a
    retrained candidate promoted by the RefreshDaemon with the shadow
    scorer on the retained generation, then a candidate whose loaded
    user vectors are scaled 4x rolled back through gate.rollback.
    Returns the phase's launches and numbers."""
    import datetime as dt
    import threading

    import numpy as np
    import torch

    fg, rs, ft = mods["fg"], mods["rs"], mods["ft"]
    from predictionio_tpu_torch.data.storage import AccessKey, \
        get_storage, reset_storage
    from predictionio_tpu_torch.obs.quality import QualityConfig
    from predictionio_tpu_torch.refresh import RefreshConfig
    from predictionio_tpu_torch.refresh.daemon import HttpPromoter, \
        RefreshDaemon
    from predictionio_tpu_torch.server import engine_server as es_mod
    from predictionio_tpu_torch.server.event_server import EventServer
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    phase_t0 = time.perf_counter()
    work, engine_json = loop["work"], loop["engine_json"]
    req_log = os.path.join(work, "p20_requests.jsonl")
    env = cli_env(os.path.join(work, "home"))
    env.values.update({k: None for k in (
        "PIO_REFRESH_INTERVAL_S", "PIO_REFRESH_MAX_DELTA_FRACTION",
        "PIO_REFRESH_EVAL_TOLERANCE", "PIO_REFRESH_PROMOTE_URL",
        "PIO_REFRESH_CANARY_WINDOW_S", "PIO_CANARY_QUERIES",
        "PIO_RETAIN_PREVIOUS", "PIO_RETAIN_PREVIOUS_TTL_S",
        "PIO_REQUEST_LOG", "PIO_REQUEST_LOG_SAMPLE", "PIO_QUALITY",
        "PIO_QUALITY_MIN_SAMPLES", "PIO_QUALITY_FAST_WINDOW",
        "PIO_QUALITY_RESERVOIR", "PIO_QUALITY_PSI_THRESHOLD",
        "PIO_QUALITY_GATE", "PIO_SHADOW_MIN_OVERLAP", "PIO_SHADOW_QUEUE",
        "PIO_QUALITY_FEEDBACK_EVENTS", "PIO_RECALL", "PIO_READY_SLO",
        "PIO_SLO_AVAILABILITY", "PIO_SLO_LATENCY_OBJECTIVE",
        "PIO_SLO_LATENCY_TARGET_MS", "PIO_SLO_FAST_WINDOW_S",
        "PIO_SLO_SLOW_WINDOW_S", "PIO_SLO_BURN_THRESHOLD",
        "PIO_SLO_MIN_REQUESTS", "PIO_SLO_RECOVERY_S",
        "PIO_BATCH_P99_TARGET_MS", "PIO_FAULTS")})
    # Every query dispatches (no cache) and is quality-sampled; the
    # shadow scorer takes every sampled query of a canary window.
    env.values.update(PIO_RESULT_CACHE="0", PIO_QUALITY_SAMPLE="1",
                      PIO_SHADOW_SAMPLE="1")
    rng = np.random.default_rng(seed + 20)
    registry = mods["get_registry"]()
    out, servers = {}, []
    env.__enter__()
    reset_storage()
    real_load = es_mod.load_models
    try:
        storage = get_storage()
        eng = mods["engine"]()
        variant = mods["EngineVariant"].from_file(engine_json)
        instances = storage.get_engine_instances()
        app_id = storage.get_apps().get_by_name(CLI_APP).id
        storage.get_access_keys().insert(
            AccessKey(key="chip-p20", app_id=app_id))
        ctx = mods["RuntimeContext"](storage=storage, device=dev)
        ft.LAUNCHES = 0                      # main path starts here
        fg.LAUNCHES = 0
        rs.LU_LAUNCHES = 0

        def start(**knobs):
            with env_vars(**knobs):
                srv = mods["EngineServer"](eng, variant, storage,
                                           host="127.0.0.1", port=0,
                                           device=dev)
            servers.append(srv)
            srv.start()
            return srv, f"http://127.0.0.1:{srv.port}"

        def stop(srv):
            srv.stop()
            servers.remove(srv)

        def mismatch(answer, w, user, num=10):
            """Why ``answer`` is not ``w``'s plain top-``num`` on the
            card (None when it is, within the tolerance and ties)."""
            uf, itf = w.host_factors()
            q = torch.from_numpy(np.ascontiguousarray(
                uf[[w.user_index[user]]])).to(dev)
            items = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
            s, i = (x.cpu().numpy() for x in ft.fused_topk_reference(
                q, items, min(num + 1, itf.shape[0])))
            hits = answer.get("itemScores") or []
            if len(hits) != num:
                return f"{len(hits)} items, not {num}"
            inv = w.item_index
            return mods["topk_mismatch"](
                [[h["score"] for h in hits]],
                [[inv[h["item"]] for h in hits]], s[:, :num], i[:, :num],
                s[:, num] if s.shape[1] > num else None, rtol=RTOL,
                atol=ATOL)

        server, base = start()
        es = EventServer(storage=storage, host="127.0.0.1", port=0)
        servers.append(es)
        es.start()
        es_base = f"http://127.0.0.1:{es.port}"
        [w1] = server._models
        inst1 = server._instance
        names = list(w1.user_index.keys())
        item_names = list(w1.item_index.keys())

        # -- 20a: the waterfall of 256 concurrent queries -----------------
        asked = [names[j] for j in rng.choice(len(names), P20_QUERIES,
                                              replace=False)]
        results = [None] * P20_QUERIES

        def client(t):
            for j in range(t, P20_QUERIES, P20_THREADS):
                results[j] = http_call(f"{base}/queries.json",
                                       {"user": asked[j], "num": 10})

        with env_vars(PIO_REQUEST_LOG=req_log):
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(P20_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            wall = time.perf_counter() - t0
            rows = read_request_log(req_log, P20_QUERIES)
        by_id = {r["traceId"]: r for r in rows}
        ratios, stage_ms = [], {s: [] for s in P20_STAGES + ("resume",)}
        for user, (st, head, ans) in zip(asked, results):
            if st != 200:
                die(f"phase 20a: /queries.json for {user} answered {st}")
            why = mismatch(ans, w1, user)
            if why is not None:
                die(f"phase 20a: the answer for {user}: {why}")
            row = by_id.get(head.get("X-Request-ID"))
            if row is None:
                die(f"phase 20a: no wide event for {head}")
            missing = set(P20_STAGES) - set(row["stages"])
            if missing or row.get("rung") != "chunked" \
                    or row.get("generation") != 1 \
                    or abs(row["serverMs"]
                           - float(head["X-PIO-Server-Ms"])) > 0.06:
                die(f"phase 20a: wide event {row} (missing {missing}) "
                    f"against X-PIO-Server-Ms {head.get('X-PIO-Server-Ms')}")
            ratios.append(row["attestedSumMs"] / row["serverMs"])
            for s_ in stage_ms:
                stage_ms[s_].append(row["stages"].get(s_, 0.0))
        ratio_p50 = pct(ratios, 0.5)
        if not 0.9 <= ratio_p50 <= 1.1:
            die(f"phase 20a: p50 of attestedSumMs / serverMs is "
                f"{ratio_p50:.4f}, outside [0.9, 1.1]")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            plain = r.read().decode()
        with urllib.request.urlopen(base + "/metrics?exemplars=1",
                                    timeout=60) as r:
            expo = r.read().decode()
        tids = [ln.split('trace_id="', 1)[1].split('"', 1)[0]
                for ln in expo.splitlines() if ln.startswith(
                    'pio_serve_stage_ms_bucket{stage="dispatch"')
                and 'trace_id="' in ln]
        if 'trace_id="' in plain or not tids:
            die("phase 20a: exemplars on the plain /metrics, or none on "
                "?exemplars=1")
        # A bucket keeps its newest request's id; the trace ring keeps
        # the last PIO_TRACE_RING (256) traces, batcher.dispatch roots
        # included, so an early bucket's request may have left it.
        resolved = 0
        for tid in tids:
            _, _, tr = http_call(f"{base}/traces.json?request_id={tid}")
            traces = tr.get("traces") or []
            if not traces:
                continue
            if len(traces) != 1 or traces[0].get("name") != \
                    "http.request" or traces[0].get("traceId") != tid \
                    or '"waterfall"' not in json.dumps(traces[0]):
                die(f"phase 20a: exemplar {tid} resolved to {traces}")
            resolved += 1
        if not resolved:
            die(f"phase 20a: none of the dispatch buckets' exemplars "
                f"{tids} is in the trace ring")
        out["waterfall"] = {
            "recs_per_s": P20_QUERIES / wall, "ratio_p50": ratio_p50,
            "exemplars": (resolved, len(tids)),
            "stages": {s_: (round(pct(v, 0.5), 4), round(pct(v, 0.99), 4))
                       for s_, v in stage_ms.items()}}

        # -- 20c: the feedback join of echoed buys -------------------------
        sids = [head.get("X-PIO-Serve-Id") for _, head, _ in results]
        if not all(s_ and s_.startswith("g1-") for s_ in sids):
            die(f"phase 20c: a 200 without a generation-1 serve id: "
                f"{[s_ for s_ in sids if not (s_ or '').startswith('g1-')]}")
        buys = []
        for k in range(P20_FEEDBACK):
            served = [h["item"] for h in results[k][2]["itemScores"]]
            target = served[0] if k < P20_PLANTED else next(
                t for t in item_names if t not in served)
            buys.append({"event": "buy", "entityType": "user",
                         "entityId": asked[k], "targetEntityType": "item",
                         "targetEntityId": target,
                         "properties": {"pioServeId": sids[k]}})
        for lo in range(0, P20_FEEDBACK, ES_BATCH):
            st, _, ans = http_call(
                f"{es_base}/batch/events.json?accessKey=chip-p20",
                buys[lo:lo + ES_BATCH])
            if st != 200 or any(a.get("status") != 201 for a in ans):
                die(f"phase 20c: the buys answered {st} {ans}")
        _, _, quality = http_call(f"{base}/quality.json")
        fb = quality["feedback"]["generations"].get("1") or {}
        rate = registry.get("pio_quality_online_hit_rate").value()
        if (fb.get("hits"), fb.get("misses"), fb.get("attributedOnly")) != \
                (P20_PLANTED, P20_FEEDBACK - P20_PLANTED, 0) \
                or rate != P20_PLANTED / P20_FEEDBACK \
                or quality["sampling"]["sampledTotal"] < P20_QUERIES:
            die(f"phase 20c: feedback {fb}, hit-rate gauge {rate}, "
                f"sampling {quality['sampling']}")
        out["feedback"] = dict(fb, gauge=rate)

        # -- 20b: /ready under a burn, its recovery, the escape hatch -----
        slo_knobs = dict(
            PIO_QUALITY="off", PIO_RECALL="off", PIO_RESULT_CACHE="1",
            PIO_SLO_LATENCY_TARGET_MS=P20_SLO_TARGET_MS,
            PIO_SLO_FAST_WINDOW_S="2", PIO_SLO_SLOW_WINDOW_S="4",
            PIO_SLO_MIN_REQUESTS="8", PIO_SLO_RECOVERY_S="1")
        burn_users = asked[:P20_SLO_QUERIES]
        out["slo"] = {}
        for hatch in ("on", "off"):
            srv, b = start(PIO_READY_SLO=hatch, **slo_knobs)
            polls, t0 = [], time.perf_counter()

            def poll():
                st, _, doc = http_call(f"{b}/ready")
                stats = http_call(f"{b}/stats.json")[2]["slo"]
                polls.append((round(time.perf_counter() - t0, 2), st,
                              doc["status"], doc["slo"], stats))
                return polls[-1]

            def ask(users):
                for u in users:
                    st, _, _ = http_call(f"{b}/queries.json",
                                         {"user": u, "num": 10})
                    if st != 200:
                        die(f"phase 20b: /queries.json answered {st}")

            first = poll()
            if first[1] != 200 or first[2] != "ready":
                die(f"phase 20b ({hatch}): /ready before the burn {first}")
            ask(burn_users)                   # dispatched: each misses
            time.sleep(1.05)
            burn = poll()
            lat_burn = burn[3]["burn"]["fast"]["latency"]
            if hatch == "on" and (
                    burn[1] != 503 or burn[2] != "degraded"
                    or "sustained_burn" not in burn[3]["tripReasons"]):
                die(f"phase 20b: /ready under the burn {burn}")
            if hatch == "off" and (burn[1] != 200
                                   or not burn[4]["degraded"]):
                die(f"phase 20b (PIO_READY_SLO=off): /ready {burn}")
            while hatch == "on" and polls[-1][1] != 200:
                ask(burn_users)               # result-cache hits: meet it
                time.sleep(1.05)
                poll()
                if time.perf_counter() - t0 > 20:
                    die(f"phase 20b: /ready never recovered {polls}")
            if hatch == "on":
                if not any(p_[3].get("recoveringForS") is not None
                           for p_ in polls):
                    die(f"phase 20b: no recovery dwell seen {polls}")
            stop(srv)
            out["slo"][hatch] = {
                "latency_burn": lat_burn, "trip": burn[3]["tripReasons"],
                "statuses": [p_[1] for p_ in polls],
                "recovered_s": polls[-1][0]}

        # -- 20d: the canary gate, healthy ---------------------------------
        shadow_calls = [0]
        real_shadow = server._shadow_predict

        def counted_shadow(gen, q):
            answer = real_shadow(gen, q)
            shadow_calls[0] += 1             # one K3 launch (B 1, chunked)
            return answer

        server._shadow_predict = counted_shadow
        load_users = list(names)
        rng.shuffle(load_users)
        dctx = mods["RuntimeContext"].create(storage=storage, device=dev)
        opener = recorded_opener()
        daemon = RefreshDaemon(
            eng, variant, dctx,
            config=RefreshConfig.from_env(canary_window_s=P20_CANARY_S),
            promoter=HttpPromoter(base, canary_window_s=P20_CANARY_S,
                                  canary_poll_s=0.2, opener=opener))
        k3_0 = ft.LAUNCHES
        disp0 = server.scheduler.snapshot()["default"]["dispatches"]
        drive = query_load([base], load_users, P20_CLIENTS)
        cycle = daemon.run_once()
        statuses = [a[2] for a in drive.stop()]
        _, _, q1 = http_call(f"{base}/quality.json")
        shadow = q1["shadow"]
        # Count once the shadow worker is idle: its session ends (the queue
        # dropped), and its last prediction returns.
        server.quality.end_shadow("phase 20d count")
        seen_k3 = None
        while seen_k3 != (ft.LAUNCHES, shadow_calls[0]):
            seen_k3 = (ft.LAUNCHES, shadow_calls[0])
            time.sleep(0.2)
        k3 = ft.LAUNCHES - k3_0
        dispatches = server.scheduler.snapshot()["default"]["dispatches"] \
            - disp0
        min_samples = QualityConfig.from_env().min_samples
        if cycle["promotion"] != "promoted" or cycle["result"] not in (
                "warm", "full_fallback"):
            die(f"phase 20d: the healthy cycle ended {cycle}")
        if any(c[1] == "/admin/rollback" for c in opener.calls) \
                or q1["gate"]["rollback"] or not shadow["active"] \
                or shadow["scored"] < min_samples \
                or shadow["overlapMean"] < shadow["minOverlap"] \
                or shadow["divergent"] or q1["drift"]["tripped"]:
            die(f"phase 20d: the healthy canary read {json.dumps(q1)}")
        if k3 != dispatches + shadow_calls[0] or shadow_calls[0] < \
                shadow["scored"] or any(s_ != 200 for s_ in statuses):
            die(f"phase 20d: {k3} fused_topk launches for {dispatches} "
                f"dispatches and {shadow_calls[0]} shadow predictions; "
                f"client statuses {set(statuses)}")
        inst2 = instances.get(cycle["instance"])
        out["healthy"] = {
            "cycle": cycle["result"], "requests": len(statuses),
            "shadow_scored": shadow["scored"],
            "shadow_launches": shadow_calls[0],
            "overlap": shadow["overlapMean"],
            "overlap_p10": shadow["overlapP10"],
            "psi": q1["drift"]["psi"], "polls": sum(
                c[1] == "/quality.json" for c in opener.calls)}
        stop(server)
        server = None

        # -- 20d: the planted fault on a fresh deploy of that generation --
        srv_e, base_e = start()
        if srv_e._instance.id != inst2.id:
            die(f"phase 20d: the fresh server loaded {srv_e._instance.id},"
                f" not the promoted {inst2.id}")
        stamp = dt.datetime.now(dt.timezone.utc)
        Event, DataMap = mods["Event"], mods["DataMap"]
        storage.get_events().insert_batch([
            Event(event="rate", entity_type="user", entity_id=u,
                  target_entity_type="item",
                  target_entity_id=item_names[int(rng.integers(
                      len(item_names)))],
                  properties=DataMap({"rating": 4.0}),
                  event_time=stamp + dt.timedelta(microseconds=n))
            for n, u in enumerate(asked[:P20_FEEDBACK])], app_id)

        def planted(engine_, instance, ctx_=None):
            models = real_load(engine_, instance, ctx_)
            m = models[0].model
            m.user_factors = m.user_factors * np.float32(P20_DRIFT_SCALE)
            return models

        es_mod.load_models = planted         # the server's loads only
        opener2 = recorded_opener()
        daemon2 = RefreshDaemon(
            eng, variant, dctx,
            config=RefreshConfig.from_env(canary_window_s=P20_CANARY_S),
            promoter=HttpPromoter(base_e, canary_window_s=P20_CANARY_S,
                                  canary_poll_s=0.2, opener=opener2))
        drive = query_load([base_e], load_users, P20_CLIENTS)
        try:
            cycle2 = daemon2.run_once()
        finally:
            statuses2 = [a[2] for a in drive.stop()]
            es_mod.load_models = real_load
        seen = [c[3] for c in opener2.calls if c[1] == "/quality.json"]
        tripped = seen[-1] if seen else {}
        if cycle2["promotion"] != "rolled_back" \
                or ("POST", "/admin/rollback") not in [
                    c[:2] for c in opener2.calls] \
                or not tripped.get("gate", {}).get("rollback") \
                or "drift" not in tripped["gate"]["reasons"] \
                or not tripped["drift"]["tripped"]:
            die(f"phase 20d: the planted candidate's cycle ended {cycle2}; "
                f"the daemon's last /quality.json {json.dumps(tripped)}")
        _, _, alive = http_call(base_e + "/")
        if (alive["engineInstanceId"], alive["modelGeneration"]) != (
                inst2.id, 3) or any(s_ != 200 for s_ in statuses2):
            die(f"phase 20d: after the rollback the server reports "
                f"{alive}; client statuses {set(statuses2)}")
        [w2] = load_models(eng, inst2, ctx)
        held = [names[j] for j in rng.choice(len(names), P20_HELD,
                                             replace=False)]
        for u in held:
            st, _, ans = http_call(f"{base_e}/queries.json",
                                   {"user": u, "num": 10})
            why = mismatch(ans, w2, u) if st == 200 else st
            if why is not None:
                die(f"phase 20d: after the rollback the answer for {u}: "
                    f"{why}")
        out["fault"] = {
            "requests": len(statuses2), "psi": tripped["drift"]["psi"],
            "reasons": tripped["gate"]["reasons"],
            "polls": len(seen), "cycle": cycle2["result"]}
        stop(srv_e)
        launches = {"fused_topk": ft.LAUNCHES,       # main path ends here
                    "fused_gram": fg.LAUNCHES,
                    "ridge_solve_lu": rs.LU_LAUNCHES}
    finally:
        es_mod.load_models = real_load
        for srv in servers:
            srv.stop()
        reset_storage()
        env.__exit__()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - phase_t0
    wf = out["waterfall"]
    log(f"phase 20a waterfall: {P20_QUERIES} /queries.json from "
        f"{P20_THREADS} threads ({wf['recs_per_s']:.1f} recs/s, result "
        f"cache off, every one sampled), each the plain top-k of "
        f"generation 1 and a wide event carrying {', '.join(P20_STAGES)}; "
        f"p50 attestedSumMs / serverMs {wf['ratio_p50']:.4f}; stage ms "
        f"(p50, p99) {json.dumps(wf['stages'])}; {wf['exemplars'][0]} of "
        f"the {wf['exemplars'][1]} dispatch buckets' exemplars still in "
        f"the trace ring, each resolved to its one http.request tree "
        f"(with its waterfall event); card {card}")
    log(f"phase 20b slo: target {P20_SLO_TARGET_MS} ms, windows 2/4 s, "
        f"recovery 1 s: {P20_SLO_QUERIES} dispatched queries burnt latency "
        f"{out['slo']['on']['latency_burn']} x ({out['slo']['on']['trip']}) "
        f"→ /ready {out['slo']['on']['statuses']}, 200 again at "
        f"{out['slo']['on']['recovered_s']} s once the same queries were "
        f"cache hits; PIO_READY_SLO=off: /ready "
        f"{out['slo']['off']['statuses']} while /stats.json's slo read "
        f"degraded; card {card}")
    log(f"phase 20c feedback: every 200 carried X-PIO-Serve-Id g1-*; "
        f"{P20_FEEDBACK} buys echoing them through the in-process event "
        f"server, {P20_PLANTED} on a served item: /quality.json generation "
        f"1 {json.dumps(out['feedback'])} (planted share "
        f"{P20_PLANTED / P20_FEEDBACK})")
    h, f_ = out["healthy"], out["fault"]
    log(f"phase 20d canary: RefreshDaemon cycle {h['cycle']} promoted "
        f"through POST /reload after a {P20_CANARY_S:.0f} s window of "
        f"{h['requests']} queries from {P20_CLIENTS} threads; the shadow "
        f"scorer re-predicted {h['shadow_launches']} of them on the "
        f"retained generation (one fused_topk launch each; "
        f"{h['shadow_scored']} scored), overlap mean {h['overlap']} p10 "
        f"{h['overlap_p10']}, drift psi {json.dumps(h['psi'])}, no "
        f"rollback; the planted candidate (user vectors x"
        f"{P20_DRIFT_SCALE:.0f} at load, cycle {f_['cycle']}): drift psi "
        f"{json.dumps(f_['psi'])}, gate.rollback for {f_['reasons']} at "
        f"the daemon's poll {f_['polls']}, POST /admin/rollback; "
        f"generation 1 serves again, {P20_HELD} answers the plain top-k; "
        f"{f_['requests']} queries all 200; launches "
        f"{json.dumps(launches)}; phase 20 in {out['phase_s']:.1f} s "
        f"(budget {PHASE20_LIMIT_S:.0f} s); card {card}")
    if out["phase_s"] > PHASE20_LIMIT_S:
        log(f"phase 20: over its {PHASE20_LIMIT_S:.0f} s budget")
    return out


# Phase 21: the fleet plane.  Four `pio deploy` processes serve phase
# 15's ML-25M store (G1 pinned), two serve phase 12's ML-1M store; the
# rollouts, the dashboard and the status verb drive them over HTTP.
FLEET_N = 4                    # 21a-c, e: deploys of phase 15's store
FLEET_CLIENTS = 16             # client threads across each rollout
FLEET_POOL = 2048              # distinct users the clients ask
FLEET_HELD = 64                # answers an instance held after a rollout
FLEET_WAVES = "1,50%,100%"
FLEET_BAKE_S = "2"             # 21a's bake
FLEET_HALT_BAKE_S = "4"        # 21b: the canary's bake, drift must trip
FLEET_RESUME_BAKE_S = "1"      # 21c
FLEET_G2_NOISE = 0.05          # G2 = G1 + this x N(0, 1/rank): a neighbour
#                                generation, as a retrain is (the shadow
#                                canary's overlap stays high)
FLEET_DRIFT_SCALE = 4.0        # 21b's G3: G2's user vectors x4 (20d's fault)
FLEET_DELTA = 20_000           # 21d: phase 16's delta shape (2 %)
FLEET_DELTA2 = 30_000          # ... then over the fraction gate: fallback
FLEET_MAX_DELTA_FRACTION = "0.025"
FLEET_PROFILE_MS = 2000
FLEET_WARM_S = 6.0             # 21a: traffic before the rollout starts
PHASE21_LIMIT_S = 90.0


def fleet_lats(answers, n: int) -> list:
    """(count, p50, max) of the client walls in ms by instance, of
    ``query_load`` answers (instance, user, status, answer, ms)."""
    out = []
    for b in range(n):
        lats = sorted(a[4] for a in answers if a[0] == b)
        out.append((len(lats), round(lats[len(lats) // 2], 1) if lats
                    else None, round(lats[-1], 1) if lats else None))
    return out


def proc_env(home: str, **extra) -> dict:
    """This process's environment with :func:`cli_env`'s values for
    ``home`` and ``extra`` applied (None unsets): a subprocess's own,
    with nothing of this process's environment changed."""
    env = dict(os.environ)
    for k, v in {**cli_env(home).values, **extra}.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return env


class served_poller:
    """Reads ``GET <path>``'s ``key`` of each base every ``every_s`` until
    ``stop()`` (by default ``GET /``'s engineInstanceId); ``seen[i]``:
    (time, value) of base i's reads."""

    def __init__(self, bases, every_s: float = 0.1, path: str = "/",
                 key: str = "engineInstanceId"):
        import threading

        self.stop_ev = threading.Event()
        self.seen = [[] for _ in bases]

        def run():
            while not self.stop_ev.is_set():
                for n, b in enumerate(bases):
                    try:
                        _, _, doc = http_call(b + path)
                        got = doc.get(key)
                    except OSError as e:
                        got = f"unreachable: {e}"
                    self.seen[n].append((time.perf_counter(), got))
                self.stop_ev.wait(every_s)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def stop(self) -> list:
        self.stop_ev.set()
        self.thread.join(60)
        return self.seen


class timed_rollouts:
    """Within the block, the rollout controllers ``pio rollout`` makes
    note when the fleet gate first reads tripped and when each rollback
    returns (``marks``), and count the gate's polls."""

    def __init__(self):
        self.marks = {"polls": 0}

    def __enter__(self):
        from predictionio_tpu_torch import fleet

        base, marks = fleet.RolloutController, self.marks

        class Timed(base):
            def fleet_tripped(self):
                out = base.fleet_tripped(self)
                marks["polls"] += 1
                if out[0]:
                    marks.setdefault("tripped", time.perf_counter())
                return out

            def _rollback_instance(self, url):
                out = base._rollback_instance(self, url)
                marks["rolled_back"] = time.perf_counter()
                return out

        self.saved, fleet.RolloutController = base, Timed
        return self

    def __exit__(self, *exc):
        from predictionio_tpu_torch import fleet

        fleet.RolloutController = self.saved


def run_pio(mods, argv, what: str):
    """``pio <argv>`` in this process: (exit code, standard output,
    standard error); a SystemExit is its code."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mods["pio"](list(argv))
        except SystemExit as e:
            rc = e.code
    said = " | ".join(ln.strip() for ln in out.getvalue().splitlines()
                      if ln.strip())
    log(f"  {what}: pio {' '.join(argv)} → exit {rc}: {said[:600]}")
    return rc, out.getvalue(), err.getvalue()


def held_ml25m(answers, gens, plain, what, topk_mismatch) -> dict:
    """Each (instance, user, status, answer) of ``answers`` must be 200
    and the plain top-10 of one of ``gens`` (names into ``plain``: a
    generation's (scores, ids) [pool, 11] on the pool).  Returns the
    answers' count by generation."""
    import numpy as np

    by_gen = {g: 0 for g in gens}
    for b, u, st, ans, *_ in answers:
        if st != 200:
            die(f"{what}: an answer of instance {b} was {st}: {ans}")
        hits = ans.get("itemScores") or []
        got_s = [[h["score"] for h in hits]]
        got_i = [[int(h["item"][1:]) for h in hits]]
        for g in gens:
            s, i = plain[g]
            if len(hits) == 10 and topk_mismatch(
                    got_s, got_i, s[u:u + 1, :10], i[u:u + 1, :10],
                    s[u:u + 1, 10], rtol=RTOL, atol=ATOL) is None:
                by_gen[g] += 1
                break
        else:
            die(f"{what}: instance {b}'s answer for user {u} is the plain "
                f"top-10 of none of {gens}: {np.round(got_s, 4)}")
    return by_gen


def fleet_phase(dev, seed: int, users_np, items_np, sched: dict,
                loop: dict, mods: dict, card: str) -> dict:
    """Phase 21: the fleet plane on the card.  21a `pio rollout` of a
    second ML-25M generation across four `pio deploy` processes in waves
    1, 50 %, 100 % under 16 client threads; 21b a candidate whose user
    vectors are 4x halts at the canary on the merged quality gate; 21c a
    SIGTERM'd rollout refused, resumed, and another unwound; 21d `pio
    train --follow --promote-url` across two ML-1M deploys (a warm cycle,
    then a full fallback); 21e `pio dashboard --fleet` and `pio status
    --fleet`; 21f the admin server's capture and app routes.  Returns
    the phase's numbers and launches."""
    import signal
    import threading

    import numpy as np
    import torch

    from predictionio_tpu_torch.config import load_config
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.obs.fleet import parse_exposition
    from predictionio_tpu_torch.obs.quality import scorecard_from_matrix
    from predictionio_tpu_torch.server.admin import AdminServer

    ft = mods["ft"]
    topk_mismatch = mods["topk_mismatch"]
    dev_args = () if dev.type == "cuda" else ("--device", dev.type)
    phase_t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pio_chip_fleet_")
    home15, home12 = sched["home"], os.path.join(loop["work"], "home")
    # A 1 s latency objective: at the default 100 ms, U1's own ML-25M
    # reload on an H100 (answers stalled up to ~1.7 s) under 16
    # closed-loop clients spent the latency budget while the autotuner
    # sat at its floor (saturation_with_burn, fast burn 1.133) and the
    # fleet gate halted a healthy rollout; 21b's halt must come from the
    # quality gate.
    env15 = proc_env(home15, PIO_RESULT_CACHE="0", PIO_QUALITY_SAMPLE="1",
                     PIO_SLO_LATENCY_TARGET_MS="1000", PIO_QUALITY=None,
                     PIO_RECALL=None, PIO_RETAIN_PREVIOUS=None,
                     PIO_CANARY_QUERIES=None)
    env12 = proc_env(home12, PIO_RESULT_CACHE="0",
                     PIO_RETAIN_PREVIOUS=None, PIO_CANARY_QUERIES=None)
    rng = np.random.default_rng(seed + 21)
    out, procs, servers = {"launches": {}}, [], []
    store15 = None
    k3 = {"deploys": 0, "here": 0}

    def stop_proc(d):
        d.stop()
        procs.remove(d)
        k3["deploys"] += (d.launches or {}).get("fused_topk", 0)

    box = {}                          # 21d's outcome, from its thread
    try:
        # -- six deploys started together: four pinned to G1, two on the
        # ML-1M store's newest ALS generation
        t0 = time.perf_counter()
        g1 = sched["instance"]
        fleet = [deployed(sched["engine_json"],
                          os.path.join(work, f"deploy{n}.log"),
                          extra=("--engine-instance-id", g1, *dev_args),
                          phase="phase 21", env=env15, wait=False)
                 for n in range(FLEET_N)]
        pair = [deployed(loop["engine_json"],
                         os.path.join(work, f"deploy1m{n}.log"),
                         extra=dev_args, phase="phase 21d", env=env12,
                         wait=False) for n in range(2)]
        procs.extend(fleet + pair)

        # -- meanwhile: G2 (a neighbour of G1 with its scorecard) and G3
        # (G2's user vectors x4 carrying G2's scorecard)
        store15 = Storage(load_config(env={"PIO_HOME": home15}))
        eng = mods["engine"]()
        variant15 = mods["EngineVariant"].from_file(sched["engine_json"])
        scale = np.float32(FLEET_G2_NOISE / np.sqrt(RANK))
        users2 = users_np + scale * rng.standard_normal(
            users_np.shape, np.float32)
        items2 = items_np + scale * rng.standard_normal(
            items_np.shape, np.float32)
        users3 = users2 * np.float32(FLEET_DRIFT_SCALE)
        card2 = scorecard_from_matrix(users2, items2, seed=0, name="als")
        uid = [f"u{j}" for j in range(ML25M_USERS)]
        iid = [f"i{j}" for j in range(ML25M_ITEMS)]
        g2 = mods["persist_instance"](eng, variant15, [
            mods["wrapper_from_numpy"](users2, items2, uid, iid, rank=RANK,
                                       quality=card2)], store15)
        g3 = mods["persist_instance"](eng, variant15, [
            mods["wrapper_from_numpy"](users3, items2, uid, iid, rank=RANK,
                                       quality=card2)], store15)
        pool = rng.choice(ML25M_USERS, FLEET_POOL, replace=False)
        users = [f"u{p}" for p in pool]
        plain = {}
        items_d = {"G1": torch.from_numpy(items_np).to(dev),
                   "G2": torch.from_numpy(items2).to(dev)}
        for g, uf, itd in (("G1", users_np, items_d["G1"]),
                           ("G2", users2, items_d["G2"]),
                           ("G3", users3, items_d["G2"])):
            s, i = ft.fused_topk_reference(
                torch.from_numpy(uf[pool]).to(dev), itd, 11)
            plain[g] = (s.cpu().numpy(), i.cpu().numpy())
        del items_d
        for d in procs:
            d.ready()
        out["start_s"] = time.perf_counter() - t0
        urls = [d.base for d in fleet]
        # One query each before any load: a fresh process's first answer
        # stages its corpus and kernels, and under the 16 clients every
        # request queued behind it would be slow too, several slow
        # answers in a window of a few: a sustained burn that latches
        # `degraded` for the SLO recovery (60 s) and halts the rollout.
        for d in procs:
            post_json(f"{d.base}/queries.json",
                      {"user": f"u{pool[0]}" if d in fleet else "u1",
                       "num": 10})
        if any(d.instance != g1 or not d.device.startswith(dev.type)
               for d in fleet):
            die(f"phase 21: the deploys serve "
                f"{[(d.instance, d.device) for d in fleet]}, not G1 {g1}")

        def served(bases):
            return [http_call(b + "/")[2].get("engineInstanceId")
                    for b in bases]

        def held_after(gen, label, what):
            """FLEET_HELD answers on each instance, each the plain top-10
            of ``gen``; and GET / reads ``label`` everywhere."""
            if served(urls) != [label] * len(urls):
                die(f"{what}: GET / reads {served(urls)}, not {label}")
            answers = []
            for b, base in enumerate(urls):
                for u in range(b * FLEET_HELD, (b + 1) * FLEET_HELD):
                    st, _, ans = http_call(f"{base}/queries.json", {
                        "user": users[u], "num": 10})
                    answers.append((b, u, st, ans))
            held_ml25m(answers, (gen,), plain, what, topk_mismatch)

        # -- 21d in a thread of its own, beside 21a-c ----------------------
        d_thread = threading.Thread(target=follow_fleet, args=(
            dev, rng.integers(1 << 30), pair, loop, env12, work, mods, box),
            daemon=True)
        d_thread.start()

        # -- 21a: the rollout at full width ----------------------------------
        # A load balancer's health check polls /ready through 21a-c, and
        # traffic runs before the rollout starts: each instance's SLO
        # windows then hold its steady traffic, not only the seconds
        # around its own reload (the first tick opens the window).
        health = served_poller(urls, every_s=0.5, path="/ready",
                               key="status")
        poll = served_poller(urls)
        load = query_load(urls, users, FLEET_CLIENTS)
        time.sleep(FLEET_WARM_S)
        t0 = time.perf_counter()
        rc, said, err = run_pio(mods, [
            "rollout", "--instances", ",".join(urls), "--engine-instance-id",
            g2, "--waves", FLEET_WAVES, "--bake-s", FLEET_BAKE_S, "--state",
            os.path.join(work, "rollout_a.json")], "21a")
        out["rollout_s"] = time.perf_counter() - t0
        answers = load.stop()
        seen = poll.stop()
        state = json.loads(Path(work, "rollout_a.json").read_text())
        if rc != 0 or (state["status"], state["waveCounts"], state["wave"],
                       state["promoted"], state["target"]) != (
                "promoted", [1, 2, 4], 2, urls, g2):
            bad = [a[:4] for a in answers if a[2] != 200]
            halted = next((n for n, u in enumerate(urls)
                           if u in str(state.get("haltReason"))), 0)
            die(f"phase 21a: pio rollout exited {rc} ({err[-1000:]}); "
                f"journal {json.dumps(state)}; {len(bad)} of "
                f"{len(answers)} answers not 200, the first {bad[:5]}; "
                f"client wall by instance (n, p50, max ms) "
                f"{fleet_lats(answers, len(urls))}; U{halted + 1}'s slo "
                f"{json.dumps(http_call(urls[halted] + '/stats.json')[2].get('slo'))}; "
                f"its log {Path(fleet[halted].log_path).read_text()[-3000:]}")
        switched = [next((t for t, g in rows if g == g2), None)
                    for rows in seen]
        if None in switched or not (switched[0] < switched[1]
                                    < min(switched[2:])):
            die(f"phase 21a: the instances took G2 at {switched}, not in "
                "the waves 1, 2, 4")
        lost = sum(a[2] != 200 for a in answers)
        by_gen = held_ml25m(answers, ("G1", "G2"), plain,
                            "phase 21a during the rollout", topk_mismatch)
        held_after("G2", g2, "phase 21a after the rollout")
        lats = [a[4] for a in answers]
        out["a"] = {"answers": len(answers), "lost": lost, "by_gen": by_gen,
                    "waves_s": [round(t - switched[0], 3)
                                for t in switched],
                    "client_ms": (round(pct(lats, 0.5), 3),
                                  round(pct(lats, 0.99), 3),
                                  round(max(lats), 3))}

        # -- 21b: a halt at the canary -------------------------------------
        poll = served_poller(urls[1:])
        # half the clients on the canary, so drift fills its window
        load = query_load([urls[0]] * FLEET_N + urls, users, FLEET_CLIENTS,
                          spread=False)
        t0 = time.perf_counter()
        with timed_rollouts() as timed:
            rc, said, err = run_pio(mods, [
                "rollout", "--instances", ",".join(urls),
                "--engine-instance-id", g3, "--waves", FLEET_WAVES,
                "--bake-s", FLEET_HALT_BAKE_S, "--poll-s", "0.25",
                "--state", os.path.join(work, "rollout_b.json")], "21b")
        out["halt_rollout_s"] = time.perf_counter() - t0
        answers = load.stop()
        seen = poll.stop()
        state = json.loads(Path(work, "rollout_b.json").read_text())
        if rc != 1 or state["status"] != "rolled_back" \
                or state["promoted"] != [urls[0]] \
                or state["rolledBack"] != [urls[0]] \
                or "fleet quality gate" not in (state["haltReason"] or ""):
            die(f"phase 21b: pio rollout exited {rc}; journal "
                f"{json.dumps(state)}")
        others = {g for rows in seen for _, g in rows}
        if others != {g2} or min(len(rows) for rows in seen) < 5:
            die(f"phase 21b: U2-U4 read {others} during the halted rollout")
        lost_b = sum(a[2] != 200 for a in answers)
        by_gen_b = held_ml25m(answers, ("G2", "G3"), plain,
                              "phase 21b during the rollout", topk_mismatch)
        held_after("G2", g2, "phase 21b after the rollback")
        out["b"] = {"answers": len(answers), "lost": lost_b,
                    "by_gen": by_gen_b, "reason": state["haltReason"],
                    "polls": timed.marks["polls"],
                    "trip_to_rollback_s": timed.marks["rolled_back"]
                    - timed.marks["tripped"],
                    "reads": sum(len(r) for r in seen)}

        # -- 21c: preemption: refused, resumed; another unwound -----------
        def preempted(target, state_path):
            """`pio rollout` (a subprocess) SIGTERM'd in its second wave's
            bake; returns its exit code and the journal then."""
            proc = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.cli",
                 "rollout", "--instances", ",".join(urls),
                 "--engine-instance-id", target, "--waves", FLEET_WAVES,
                 "--bake-s", FLEET_RESUME_BAKE_S, "--state", state_path],
                cwd=Path(__file__).resolve().parent, env=env15,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            deadline = time.perf_counter() + CLI_TIMEOUT_S
            while True:
                try:
                    st = json.loads(Path(state_path).read_text())
                except (OSError, ValueError):
                    st = {}
                if st.get("wave") == 1 and len(st.get("promoted", ())) == 2:
                    break
                if proc.poll() is not None or time.perf_counter() > deadline:
                    proc.kill()
                    die(f"phase 21c: the rollout ended ({proc.returncode}) "
                        f"before its second wave's bake: {st}")
                time.sleep(0.02)
            time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            return rc, json.loads(Path(state_path).read_text())

        state_c = os.path.join(work, "rollout_c.json")
        rc, st = preempted(g1, state_c)
        if rc != -signal.SIGTERM or st["status"] != "in_progress" \
                or st["promoted"] != urls[:2]:
            die(f"phase 21c: the SIGTERM'd rollout exited {rc}: {st}")
        common = ["--instances", ",".join(urls), "--waves", FLEET_WAVES,
                  "--bake-s", FLEET_RESUME_BAKE_S, "--state", state_c]
        rc, _, err = run_pio(mods, ["rollout", "--engine-instance-id", g1,
                                    *common], "21c plain")
        if rc != 1 or f"rollout {st['rolloutId']} is journaled " \
                f"'in_progress' at {state_c} — finish it first (--resume " \
                "to continue, --unwind to roll it back)" not in err:
            die(f"phase 21c: a plain rollout over the journal exited {rc}: "
                f"{err[-500:]}")
        t0 = time.perf_counter()
        rc, _, err = run_pio(mods, ["rollout", "--resume", *common],
                             "21c resume")
        out["resume_s"] = time.perf_counter() - t0
        st = json.loads(Path(state_c).read_text())
        if rc != 0 or st["status"] != "promoted" or st["promoted"] != urls:
            die(f"phase 21c: --resume exited {rc}: {json.dumps(st)}")
        held_after("G1", g1, "phase 21c after --resume")
        state_u = os.path.join(work, "rollout_u.json")
        rc, st = preempted(g2, state_u)
        if rc != -signal.SIGTERM or st["promoted"] != urls[:2]:
            die(f"phase 21c: the second SIGTERM'd rollout exited {rc}: {st}")
        rc, _, err = run_pio(mods, [
            "rollout", "--unwind", "--instances", ",".join(urls), "--state",
            state_u], "21c unwind")
        st = json.loads(Path(state_u).read_text())
        if rc != 0 or st["status"] != "rolled_back" \
                or st["rolledBack"] != urls[1::-1] \
                or st["postRollback"] != {u: g1 for u in urls}:
            die(f"phase 21c: --unwind exited {rc}: {json.dumps(st)}")
        held_after("G1", g1, "phase 21c after --unwind")
        ready = health.stop()
        out["ready_statuses"] = sorted({v for rows in ready
                                        for _, v in rows})

        # -- 21d's outcome ----------------------------------------------------
        d_thread.join(CLI_TIMEOUT_S)
        if d_thread.is_alive() or "error" in box:
            die(f"phase 21d: {box.get('error', 'did not finish')}")
        out["d"] = box["out"]
        for name in ("fused_gram", "ridge_solve_lu"):
            out["launches"][name] = out["d"]["launches"].get(name, 0)

        # -- 21e: fleet telemetry ----------------------------------------------
        dash = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli", "dashboard",
             "--ip", "127.0.0.1", "--port", "0", "--fleet", ",".join(urls)],
            cwd=Path(__file__).resolve().parent, env=env15,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            out["e"] = fleet_telemetry(dash, urls, fleet, mods, env15,
                                       state_u, parse_exposition)
            stop_proc(fleet[-1])             # an instance goes away
            _, _, doc = http_call(out["e"]["dash"] + "/fleet.json")
            rows = {r["instance"]: r for r in doc["instances"]}
            if [rows[u]["stale"] for u in urls] != [False] * 3 + [True] \
                    or doc["merged"]["counters"] != out["e"]["counters"]:
                die(f"phase 21e: after a stop the fleet reads "
                    f"{[rows[u]['stale'] for u in urls]}, counters equal "
                    f"{doc['merged']['counters'] == out['e']['counters']}")
            out["e"].pop("counters")
        finally:
            dash.terminate()
            dash.wait(timeout=60)
            dash.stdout.close()

        # -- 21f: the admin server beside an in-process engine server --------
        ft_before = ft.LAUNCHES
        with env_vars(**cli_env(home15).values, PIO_RESULT_CACHE="0"):
            srv = mods["EngineServer"](eng, variant15, store15,
                                       host="127.0.0.1", port=0, device=dev,
                                       instance_id=g2)
            servers.append(srv)
            srv.start()
            admin = AdminServer(storage=store15, host="127.0.0.1", port=0)
            servers.append(admin)
            admin.start()
            out["f"] = admin_capture(
                f"http://127.0.0.1:{srv.port}",
                f"http://127.0.0.1:{admin.port}", users, work, home15, mods)
            for s_ in list(servers):
                s_.stop()
                servers.remove(s_)
        k3["here"] = ft.LAUNCHES - ft_before
        if not k3["here"]:
            die("phase 21f: the in-process server launched no fused_topk")
        for d in list(fleet[:-1]) + pair:
            stop_proc(d)
    finally:
        follow = box.get("proc")
        if follow is not None and follow.poll() is None:
            follow.kill()
            follow.wait()
        for d in procs:
            d.kill()
        for s_ in servers:
            s_.stop()
        if store15 is not None:
            store15.close()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"]["fused_topk"] = k3["deploys"] + k3["here"]
    out["k3"] = dict(k3)
    out["phase_s"] = time.perf_counter() - phase_t0
    a, b, d, e, f = (out[x] for x in "abdef")
    log(f"phase 21a rollout: six pio deploy processes up in "
        f"{out['start_s']:.2f} s; pio rollout of G2 across "
        f"{FLEET_N} ML-25M instances ({ML25M_USERS}x{ML25M_ITEMS} rank "
        f"{RANK}, chunked, cache off, every query quality-sampled), waves "
        f"{FLEET_WAVES}, bake {FLEET_BAKE_S} s: exit 0 in "
        f"{out['rollout_s']:.3f} s; instances took G2 at "
        f"{a['waves_s']} s; {a['answers']} answers from {FLEET_CLIENTS} "
        f"threads meanwhile (client ms p50, p99, max {a['client_ms']}), "
        f"{a['lost']} lost, by generation "
        f"{json.dumps(a['by_gen'])} (each the plain top-10 of its "
        f"generation); then {FLEET_HELD} answers an instance the plain "
        f"top-10 of G2; card {card}")
    log(f"phase 21b halt: the x{FLEET_DRIFT_SCALE:g} candidate halted at "
        f"the canary ({b['reason']}) after {b['polls']} gate polls, "
        f"rollout {out['halt_rollout_s']:.3f} s, first tripped poll to the "
        f"last rollback {b['trip_to_rollback_s']:.4f} s; U2-U4 read G2 at "
        f"all {b['reads']} polls; {b['answers']} answers, {b['lost']} "
        f"lost, {json.dumps(b['by_gen'])}; all four serve G2's plain "
        f"top-10 after")
    log(f"phase 21c preemption: a rollout SIGTERM'd in its second wave's "
        f"bake, a plain rollout refused (exit 1, the reference's message), "
        f"--resume finished it in {out['resume_s']:.3f} s (all on G1); a "
        f"second SIGTERM'd rollout unwound (U1, U2 back on G1); /ready "
        f"read {out['ready_statuses']} through 21a-c")
    log(f"phase 21d fleet refresh: pio train --follow --promote-url "
        f"U5,U6 on the ML-1M store: cycle 1 {d['cycles'][0]}, cycle 2 "
        f"{d['cycles'][1]}; both instances served each cycle's plain "
        f"top-10; pio_refresh_staleness_s {d['staleness']!r} = latest "
        f"event - the older served watermark; launches "
        f"{json.dumps(d['launches'])}; {d['s']:.2f} s beside 21a-c")
    log(f"phase 21e telemetry: /fleet.json scrape {e['scrape_ms']:.2f} ms; "
        f"{e['n_counters']} counters equal to the four instances' sums, "
        f"{e['n_buckets']} histogram buckets add, "
        f"{e['n_gauges']} gauges keep their instance label; a stopped "
        f"instance reads stale and still counts; pio status --fleet "
        f"prints the same totals, the rollout and shared-spill lines")
    log(f"phase 21f admin: POST /admin/profile 200 then 409 inside the "
        f"window; captures of {FLEET_PROFILE_MS} ms under "
        f"{f['queries']} queries: the admin route's {f['bytes'][0]} "
        f"bytes ({f['k3_events'][0]} K3 kernel events), pio profile "
        f"--url's {f['bytes'][1]} bytes ({f['k3_events'][1]}); the app "
        f"routes' create, list and delete seen by pio app list; launches "
        f"K3 {json.dumps(out['k3'])}; phase 21 "
        f"{out['phase_s']:.1f} s (budget {PHASE21_LIMIT_S:.0f} s); card "
        f"{card}")
    if out["phase_s"] > PHASE21_LIMIT_S:
        log(f"phase 21: over its {PHASE21_LIMIT_S:.0f} s budget")
    return out


def follow_fleet(dev, seed: int, pair, loop: dict, env12: dict, work: str,
                 mods: dict, box: dict) -> None:
    """Phase 21d (in a thread of its own; its outcome or error in
    ``box``): `pio train --follow --promote-url U5,U6` on phase 12's
    store.  A 20,000-event delta → cycle 1 warm, rolled across both;
    both serve the warm factors' plain top-10; then a delta over the
    fraction gate → cycle 2 full_fallback (K1, K2), rolled across both;
    the staleness gauge from the older served watermark."""
    try:
        box["out"] = _follow_fleet(dev, seed, pair, loop, env12, work, mods,
                                   box)
    except BaseException as e:  # noqa: BLE001 - handed to the main thread
        box["error"] = f"{type(e).__name__}: {e}"


def _follow_fleet(dev, seed, pair, loop, env12, work, mods, box):
    import datetime as dt
    import select
    import signal

    import numpy as np
    import torch

    from predictionio_tpu_torch.config import load_config
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.refresh import staleness_s
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    t_start = time.perf_counter()
    ft = mods["ft"]
    rng = np.random.default_rng(seed)
    storage = Storage(load_config(env={"PIO_HOME": os.path.join(
        loop["work"], "home")}))
    eng = mods["engine"]()
    ctx = mods["RuntimeContext"].create(storage=storage, device=dev)
    instances = storage.get_engine_instances()
    app_id = storage.get_apps().get_by_name(CLI_APP).id
    Event, DataMap = mods["Event"], mods["DataMap"]
    bases = [d.base for d in pair]
    proc = None
    try:
        first = pair[0].instance
        if pair[1].instance != first:
            raise RuntimeError(f"the two deploys serve {pair[0].instance} "
                               f"and {pair[1].instance}")
        [w1] = load_models(eng, instances.get(first), ctx)
        names = list(w1.user_index.keys())
        item_names = list(w1.item_index.keys())

        def insert(n, prefix):
            rows = refresh_delta(rng, names, item_names, n,
                                 REFRESH_NEW_USERS, REFRESH_NEW_ITEMS,
                                 REFRESH_TOUCHED_USERS, prefix)
            stamp = dt.datetime.now(dt.timezone.utc)
            storage.get_events().insert_batch([
                Event(event="rate", entity_type="user", entity_id=u,
                      target_entity_type="item", target_entity_id=i,
                      properties=DataMap({"rating": r}),
                      event_time=stamp + dt.timedelta(microseconds=k))
                for k, (u, i, r) in enumerate(rows)], app_id)

        def held(instance_id, what):
            """Both deploys serve ``instance_id``: GET / and 64 answers
            each, the plain top-10 of its factors."""
            for b in bases:
                got = http_call(b + "/")[2].get("engineInstanceId")
                if got != instance_id:
                    raise RuntimeError(f"{what}: {b} serves {got}, not "
                                       f"{instance_id}")
            [w] = load_models(eng, instances.get(instance_id), ctx)
            uf, itf = w.host_factors()
            users = [names[j] for j in rng.choice(len(names), REFRESH_QUERIES,
                                                  replace=False)]
            q = torch.from_numpy(np.ascontiguousarray(
                uf[[w.user_index[u] for u in users]])).to(dev)
            s, i = (x.cpu().numpy() for x in ft.fused_topk_reference(
                q, torch.from_numpy(np.ascontiguousarray(itf)).to(dev), 11))
            inv = w.item_index
            for b in bases:
                for row, u in enumerate(users):
                    st, _, ans = http_call(f"{b}/queries.json",
                                           {"user": u, "num": 10})
                    hits = (ans or {}).get("itemScores") or []
                    why = st if st != 200 or len(hits) != 10 else \
                        mods["topk_mismatch"](
                            [[h["score"] for h in hits]],
                            [[inv[h["item"]] for h in hits]],
                            s[row:row + 1, :10], i[row:row + 1, :10],
                            s[row:row + 1, 10], rtol=RTOL, atol=ATOL)
                    if why is not None:
                        raise RuntimeError(f"{what}: {b}'s answer for {u}: "
                                           f"{why}")

        insert(FLEET_DELTA, "f")
        env = dict(env12, PIO_ROLLOUT_WAVES="1,100%", PIO_ROLLOUT_BAKE_S="1",
                   PIO_ROLLOUT_POLL_S="0.25",
                   PIO_ROLLOUT_STATE=os.path.join(work, "rollout_d.json"),
                   PIO_REFRESH_MAX_DELTA_FRACTION=FLEET_MAX_DELTA_FRACTION,
                   PIO_REFRESH_TRIGGER_POLL_S="0.25")
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.counted_pio(sys.argv[1:]))", "train",
             "--engine-json", loop["engine_json"], "--follow",
             "--refresh-interval", "600", "--trigger-delta-count",
             str(FLEET_DELTA2), "--promote-url", ",".join(bases),
             *(() if dev.type == "cuda" else ("--device", dev.type))],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE,
            stderr=open(os.path.join(work, "follow.log"), "w"), text=True)
        box["proc"] = proc                   # killed by the phase if it dies

        def line(prefix):
            ready, _, _ = select.select([proc.stdout], [], [], CLI_TIMEOUT_S)
            got = proc.stdout.readline() if ready else ""
            if not got.startswith(prefix):
                raise RuntimeError(f"pio train --follow said {got!r}: "
                                   f"{Path(work, 'follow.log').read_text()[-2000:]}")
            return got[len(prefix):]

        line("Refresh daemon: trigger mode")
        cycles = [json.loads(line("Refresh cycle: "))]
        if (cycles[0]["result"], cycles[0]["promotion"]) != ("warm",
                                                             "promoted"):
            raise RuntimeError(f"cycle 1 ended {cycles[0]}")
        held(cycles[0]["instance"], "after the warm cycle")
        insert(FLEET_DELTA2, "g")
        cycles.append(json.loads(line("Refresh cycle: ")))
        if (cycles[1]["result"], cycles[1]["promotion"]) != (
                "full_fallback", "promoted"):
            raise RuntimeError(f"cycle 2 ended {cycles[1]}")
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=CLI_TIMEOUT_S)[0]
        if proc.returncode != 0 or "stopped after 2 cycle(s)" not in rest:
            raise RuntimeError(f"pio train --follow exited "
                               f"{proc.returncode}: {rest[-1000:]}")
        launches, stale = {}, None
        for ln in rest.splitlines():
            if ln.startswith("launches "):
                launches = json.loads(ln[len("launches "):])
            if ln.startswith("pio_refresh_staleness_s "):
                stale = float(ln.split()[1])
        if not launches.get("fused_gram") \
                or not launches.get("ridge_solve_lu"):
            raise RuntimeError(f"the fallback cycle launched {launches}")
        held(cycles[1]["instance"], "after the fallback cycle")
        marks = [dt.datetime.fromisoformat(
            http_call(b + "/")[2]["dataWatermark"]) for b in bases]
        want = staleness_s(ctx.event_store.latest_event_time(CLI_APP),
                           min(marks))
        if stale is None or want is None or abs(stale - want) > 1e-6:
            raise RuntimeError(f"pio_refresh_staleness_s {stale}, the "
                               f"older served watermark gives {want}")
        return {"cycles": [{k: c[k] for k in ("result", "promotion")}
                           for c in cycles],
                "launches": launches, "staleness": stale,
                "s": time.perf_counter() - t_start}
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        storage.close()


def fleet_telemetry(dash, urls, fleet, mods, env15, state_path,
                    parse_exposition) -> dict:
    """Phase 21e: the dashboard's /fleet.json against the instances' own
    /metrics, read between two scrapes with no traffic; then `pio status
    --fleet` and `--metrics-url`.  Returns the numbers and the merged
    counters (for the stale check after a stop)."""
    import re
    import select

    ready, _, _ = select.select([dash.stdout], [], [], CLI_TIMEOUT_S)
    said = dash.stdout.readline() if ready else ""
    m = re.search(r"Dashboard listening on 127\.0\.0\.1:(\d+)", said)
    if not m:
        die(f"phase 21e: pio dashboard said {said!r}")
    base = f"http://127.0.0.1:{m.group(1)}"
    def key(name, labels):
        return name + ("{" + ",".join(f'{k}="{labels[k]}"'
                                      for k in sorted(labels)) + "}"
                       if labels else "")

    for _ in range(10):
        t0 = time.perf_counter()
        _, _, first = http_call(base + "/fleet.json")
        scrape_ms = (time.perf_counter() - t0) * 1e3
        counters, buckets = {}, {}
        for u in urls:
            with urllib.request.urlopen(u + "/metrics", timeout=60) as r:
                types, samples = parse_exposition(r.read().decode())
            for name, labels, v in samples:
                fam = name[:-len("_bucket")]
                if types.get(name) == "counter":
                    counters[key(name, labels)] = \
                        counters.get(key(name, labels), 0.0) + v
                elif name.endswith("_bucket") \
                        and types.get(fam) == "histogram":
                    rest = {k: v_ for k, v_ in labels.items() if k != "le"}
                    b_ = (fam, key(fam, rest), labels["le"])
                    buckets[b_] = buckets.get(b_, 0.0) + v
        _, _, second = http_call(base + "/fleet.json")
        if first["merged"]["counters"] == second["merged"]["counters"]:
            break
        time.sleep(0.5)
    else:
        die("phase 21e: the fleet's counters moved between every two "
            "scrapes with no traffic")
    merged = second["merged"]
    if merged["counters"] != counters:
        diff = {k: (merged["counters"].get(k), counters.get(k))
                for k in set(counters) | set(merged["counters"])
                if merged["counters"].get(k) != counters.get(k)}
        die(f"phase 21e: /fleet.json counters differ from the sums: "
            f"{dict(list(diff.items())[:10])}")
    got = {(fam, skey, le): v
           for fam, series in merged["histograms"].items()
           for skey, row in series.items()
           for le, v in row["buckets"].items()}
    if got != buckets:
        diff = {k: (got.get(k), buckets.get(k))
                for k in set(got) | set(buckets)
                if got.get(k) != buckets.get(k)}
        die(f"phase 21e: merged histogram buckets differ from the sums: "
            f"{dict(list(diff.items())[:10])}")
    n_buckets = len(got)
    gauges = [k for k in merged["gauges"]
              if k.startswith("pio_model_generation{")]
    if sorted(gauges) != sorted(f'pio_model_generation{{instance="{u}"}}'
                                for u in urls) \
            or any(r["stale"] for r in second["instances"]):
        die(f"phase 21e: generation gauges {gauges}, rows "
            f"{[r['stale'] for r in second['instances']]}")
    from predictionio_tpu_torch.data.storage import reset_storage

    with env_vars(**{**cli_env(env15["PIO_HOME"]).values,
                     "PIO_ROLLOUT_STATE": state_path,
                     "PIO_FLEET_INSTANCES": None}):
        reset_storage()
        rc, said, _ = run_pio(mods, ["status", "--fleet", ",".join(urls)],
                              "21e status --fleet")
        totals = {}
        for ln in said.splitlines():
            mm = re.match(r"    (pio_\S+) (\S+)$", ln)
            if mm:
                totals[mm.group(1)] = float(mm.group(2))
        want = {k: v for k, v in counters.items() if k.startswith((
            "pio_query_requests_total", "pio_query_errors_total",
            "pio_event_requests_total", "pio_queue_rejected_total",
            "pio_deadline_shed_total"))}
        if rc != 0 or not said.startswith("predictionio_tpu_torch") \
                or f"fleet: {len(urls)} instance(s)" not in said \
                or totals != want or "  shared spill queue: " not in said \
                or "  rollout [" not in said:
            die(f"phase 21e: pio status --fleet exited {rc}: totals {totals}"
                f" against {want}: {said[-1500:]}")
        rc, one, _ = run_pio(mods, ["status", "--metrics-url", urls[0]],
                             "21e status --metrics-url")
        if rc != 0 or "fleet:" in one or "serving: model generation" \
                not in one or f"metrics (scraped from {urls[0]}/metrics)" \
                not in one:
            die(f"phase 21e: pio status --metrics-url exited {rc}: "
                f"{one[-1500:]}")
        reset_storage()
    return {"dash": base, "scrape_ms": scrape_ms, "counters":
            merged["counters"], "n_counters": len(counters),
            "n_buckets": n_buckets, "n_gauges": len(merged["gauges"])}


def admin_capture(engine_base, admin_base, users, work, home15,
                  mods) -> dict:
    """Phase 21f: POST /admin/profile under query load (200, then 409
    inside the window), its artifact, then `pio profile --url --out`; each
    Chrome trace must name K3's CUDA functions.  Then the app routes
    against `pio app list`."""
    import io
    import re
    import tarfile

    from predictionio_tpu_torch.data.storage import reset_storage
    from predictionio_tpu_torch.obs.profiler import TRACE_FILE

    def k3_events(tar) -> int:
        member = next(n for n in tar.getnames() if n.endswith(TRACE_FILE))
        doc = json.load(tar.extractfile(member))
        return sum(1 for e in doc.get("traceEvents", ())
                   if e.get("cat") == "kernel" and re.search(
                       r"topk_(score|tiled)_pass", e.get("name", "")))

    out = {"bytes": [], "k3_events": []}
    load = query_load([engine_base], users, 8)
    try:
        st, _, doc = http_call(
            f"{admin_base}/admin/profile?duration_ms={FLEET_PROFILE_MS}",
            {})
        st2, _, _ = http_call(f"{admin_base}/admin/profile?duration_ms=100",
                              {})
        if (st, st2) != (200, 409):
            die(f"phase 21f: POST /admin/profile answered {st} ({doc}), "
                f"then {st2} inside the window")
        deadline = time.perf_counter() + 60
        while http_call(f"{admin_base}/admin/profile")[2].get("active"):
            if time.perf_counter() > deadline:
                die("phase 21f: the capture never finished")
            time.sleep(0.1)
        with urllib.request.urlopen(f"{admin_base}/admin/profile/artifact",
                                    timeout=120) as r:
            data = r.read()
        out["bytes"].append(len(data))
        with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tar:
            out["k3_events"].append(k3_events(tar))
        dest = os.path.join(work, "profile")
        os.makedirs(dest)
        rc, said, err = run_pio(mods, [
            "profile", "--url", admin_base, "--duration-ms",
            str(FLEET_PROFILE_MS), "--out", dest], "21f profile --url")
        m = re.search(r"Profile archive downloaded: (\S+) \((\S+) bytes\)",
                      said)
        if rc != 0 or not m:
            die(f"phase 21f: pio profile --url exited {rc}: {said} {err}")
        out["bytes"].append(os.path.getsize(m.group(1)))
        with tarfile.open(m.group(1), mode="r:gz") as tar:
            out["k3_events"].append(k3_events(tar))
    finally:
        answers = load.stop()
    out["queries"] = len(answers)
    if out["queries"] < 64 or any(a[2] != 200 for a in answers):
        die(f"phase 21f: {out['queries']} queries under the captures, "
            f"statuses {sorted({a[2] for a in answers})}")
    if not all(out["k3_events"]):
        die(f"phase 21f: a capture's trace names no K3 function: "
            f"{out['k3_events']} K3 kernel events")
    # the app routes, as `pio app list` sees them
    st, _, made = http_call(f"{admin_base}/v1/cmd/app", {"name": "chipfleet"})
    with env_vars(**cli_env(home15).values):
        reset_storage()
        rc, listed, _ = run_pio(mods, ["app", "list"], "21f app list")
        st3, _, apps = http_call(f"{admin_base}/v1/cmd/app")
        req = urllib.request.Request(f"{admin_base}/v1/cmd/app/chipfleet",
                                     method="DELETE")
        with urllib.request.urlopen(req, timeout=60) as r:
            st4 = r.status
        rc2, after, _ = run_pio(mods, ["app", "list"], "21f app list")
        reset_storage()
    row = re.search(rf"^chipfleet\s+{made.get('id')}\s+(\S+)$", listed,
                    re.M)
    if st != 201 or rc != 0 or not row or row.group(1) != made["accessKey"] \
            or {"name": "chipfleet", "id": made["id"],
                "accessKeys": [made["accessKey"]]} not in apps \
            or st4 != 200 or rc2 != 0 or "chipfleet" in after:
        die(f"phase 21f: the app routes ({st}, {st3}, {st4}: {made}) "
            f"against pio app list {listed!r} / {after!r}")
    return out


# Phase 22: the storage server.  Every repository of a train and a deploy
# on `type=pioserver`, behind a `pio storageserver` process over phase
# 12's store.
REMOTE_APP = "chipremote"
REMOTE_EVENTS = 200_000        # phase 12's first events (cut for the time
#                                limit: the wire reads ~12,000 events/s)
REMOTE_SECRET_BYTES = 16
REMOTE_QUERIES = 64
REMOTE_BREAKER = {"PIO_BREAKER_THRESHOLD": "2", "PIO_BREAKER_RECOVERY_S": "3"}
REMOTE_LIMIT_S = 60.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class storage_server:
    """``pio storageserver`` in a subprocess over ``home`` on ``port``,
    until :meth:`kill`.  With ``wait=False`` the constructor returns at
    once and :meth:`ready` waits for its two lines, so the server starts
    while this process works."""

    def __init__(self, home: str, port: int, secret: str, log_path: str,
                 wait: bool = True):
        self.port, self.log_path = port, log_path
        self.started_s = time.perf_counter()
        self.log = open(log_path, "a")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli",
             "storageserver", "--ip", "127.0.0.1", "--port", str(port),
             "--secret", secret],
            cwd=Path(__file__).resolve().parent, env=proc_env(home),
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        if wait:
            self.ready()

    def ready(self) -> "storage_server":
        """Wait for the listening and client lines; ``up_s``: Popen to
        the listening line."""
        import re
        import select

        port = self.port
        ready, _, _ = select.select([self.proc.stdout], [], [],
                                    CLI_TIMEOUT_S)
        # the two lines are printed together: the second needs no wait
        lines = [self.proc.stdout.readline() if ready else ""]
        self.up_s = time.perf_counter() - self.started_s
        lines.append(self.proc.stdout.readline() if lines[0] else "")
        if not re.match(rf"Storage server listening on 127\.0\.0\.1:{port} ",
                        lines[0]) or not lines[1].startswith(
                "Clients: PIO_STORAGE_SOURCES_REMOTE_TYPE=pioserver "
                f"PIO_STORAGE_SOURCES_REMOTE_HOSTS=127.0.0.1 "
                f"PIO_STORAGE_SOURCES_REMOTE_PORTS={port} "):
            self.kill()
            die(f"phase 22: pio storageserver did not start ({lines!r}): "
                f"{Path(self.log_path).read_text()[-2000:]}")
        return self

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self.proc.stdout.close()
        self.log.close()


def reload_status(base: str):
    """POST /reload: (status, Retry-After, message, wall s)."""
    req = urllib.request.Request(base + "/reload", data=b"", method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, body, ra = r.status, r.read(), r.headers.get(
                "Retry-After")
    except urllib.error.HTTPError as e:
        status, body, ra = e.code, e.read(), e.headers.get("Retry-After")
    return (status, ra, json.loads(body or b"{}").get("message", ""),
            time.perf_counter() - t0)


def remote_phase(dev, seed: int, loop: dict, mods: dict, card: str) -> dict:
    """Phase 22: ALS trains and serves through a store in another
    process.  22a `pio template get recommendation`, then `pio train`
    twice on REMOTE_EVENTS of phase 12's events in an app of their own:
    directly on sqlite, then with METADATA, EVENTDATA and MODELDATA on
    `pioserver` (K1/K2 launched; factors torch.equal by entity id); 22b
    `pio deploy` on `pioserver`, 64 answers the plain top-k (K3 in the
    deploy process); 22c the storage server killed: answers 200, /reload
    503 until the breaker opens, then shed with Retry-After; restarted:
    /reload 200, answers unchanged; 22d `pio status` names pioserver;
    22e `entry()` on the card equals it on the CPU.  Returns the phase's
    numbers and launches."""
    import secrets

    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.entry import entry
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    fg, rs, ft = mods["fg"], mods["rs"], mods["ft"]
    registry = mods["get_registry"]()
    home = os.path.join(loop["work"], "home")
    work = tempfile.mkdtemp(prefix="pio_chip_remote_", dir=loop["work"])
    port, secret = free_port(), secrets.token_hex(REMOTE_SECRET_BYTES)
    remote = {"PIO_STORAGE_SOURCES_REMOTE_TYPE": "pioserver",
              "PIO_STORAGE_SOURCES_REMOTE_HOSTS": "127.0.0.1",
              "PIO_STORAGE_SOURCES_REMOTE_PORTS": str(port),
              "PIO_STORAGE_SOURCES_REMOTE_SECRET": secret,
              **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "REMOTE"
                 for r in ("METADATA", "EVENTDATA", "MODELDATA")}}
    server_log = os.path.join(work, "storageserver.log")

    def read_ms() -> float:
        h = registry.get("pio_train_phase_ms")
        return 0.0 if h is None else h.sum(phase="train.datasource")

    def train(what: str) -> dict:
        fg.LAUNCHES, rs.LU_LAUNCHES = 0, 0
        before = read_ms()
        t0 = time.perf_counter()
        rc, said, err = run_pio(mods, ["train", "--engine-json",
                                       engine_json], f"22a {what} train")
        out = {"s": time.perf_counter() - t0, "read_ms": read_ms() - before,
               "launches": {"fused_gram": fg.LAUNCHES,
                            "ridge_solve_lu": rs.LU_LAUNCHES}}
        if rc != 0 or "Training completed. Engine instance ID: " not in said:
            die(f"phase 22a: the {what} pio train failed ({rc}): "
                f"{err[-2000:]}")
        out["id"] = said.split("Engine instance ID: ")[1].split()[0]
        storage = get_storage()
        inst = storage.get_engine_instances().get(out["id"])
        if inst is None or inst.status != "COMPLETED":
            die(f"phase 22a: the {what} train's instance reads {inst}")
        [w] = load_models(mods["engine"](), inst, mods["RuntimeContext"](
            storage=storage, device=dev))
        out["wrapper"] = w
        return out

    phase_t0 = time.perf_counter()
    out = {}
    servers, deploys = [], []
    env = cli_env(home)
    env.__enter__()
    reset_storage()
    try:
        # -- 22a: the scaffold, the app, two trains --------------------------
        scaffold = os.path.join(work, "engine")
        rc, said, _ = run_pio(mods, ["template", "get", "recommendation",
                                     scaffold], "22a")
        engine_json = os.path.join(scaffold, "engine.json")
        spec = json.loads(Path(engine_json).read_text())
        if rc != 0 or spec["engineFactory"] != CLI_FACTORY:
            die(f"phase 22a: pio template get gave {rc}, {spec}")
        spec["datasource"]["params"]["appName"] = REMOTE_APP
        spec["algorithms"][0]["params"].update(rank=RANK, seed=seed)
        Path(engine_json).write_text(json.dumps(spec, indent=2))
        users, items, stars, times = (
            a[:REMOTE_EVENTS] for a in ml1m_events(seed))
        storage = get_storage()
        app_id = storage.get_apps().insert(mods["App"](id=None,
                                                       name=REMOTE_APP))
        storage.get_events().init(app_id)
        buy = np.isnan(stars)
        stamps = (times.astype("datetime64[us]").astype(np.int64)).tolist()
        t0 = time.perf_counter()
        storage.get_events().insert_columnar({
            "event": np.where(buy, "buy", "rate").tolist(),
            "entity_type": ["user"] * REMOTE_EVENTS,
            "entity_id": [f"u{u}" for u in users.tolist()],
            "target_entity_type": ["item"] * REMOTE_EVENTS,
            "target_entity_id": [f"i{i}" for i in items.tolist()],
            "properties": ["{}" if b else f'{{"rating": {r}}}'
                           for b, r in zip(buy.tolist(), stars.tolist())],
            "event_time_us": stamps, "creation_time_us": stamps},
            app_id)
        out["write_s"] = time.perf_counter() - t0
        # the storage server starts while the sqlite train runs
        servers.append(storage_server(home, port, secret, server_log,
                                      wait=False))
        direct = train("sqlite")
        out["server_start_s"] = servers[-1].ready().up_s
        reset_storage()
        with env_vars(**remote):
            try:
                wire = train("pioserver")
            finally:
                reset_storage()
        if not all(wire["launches"].values()):
            die(f"phase 22a: the pioserver train launched "
                f"{wire['launches']}")
        dw, ww = direct["wrapper"], wire["wrapper"]
        du, di = dw.host_factors()
        wu, wi = ww.host_factors()
        for what, got, gidx, want, widx in (
                ("users", wu, ww.user_index, du, dw.user_index),
                ("items", wi, ww.item_index, di, dw.item_index)):
            if sorted(gidx.keys()) != sorted(widx.keys()):
                die(f"phase 22a: the two trains saw other {what}")
            rows = [gidx[key] for key in widx.keys()]
            if not torch.equal(torch.from_numpy(np.ascontiguousarray(
                    got[rows])), torch.from_numpy(np.ascontiguousarray(
                    want))):
                diff = float(np.max(np.abs(got[rows] - want)))
                die(f"phase 22a: {what} factors of the pioserver train "
                    f"differ from the sqlite train's by entity id (max "
                    f"|diff| {diff:.3g})")
        out["same_numbering"] = (list(ww.user_index.keys()) ==
                                 list(dw.user_index.keys()))
        out["direct"], out["wire"] = (
            {k: v for k, v in t.items() if k != "wrapper"}
            for t in (direct, wire))
        out["wire_events_per_s"] = REMOTE_EVENTS / (wire["read_ms"] / 1e3)
        log(f"phase 22a pioserver train: {REMOTE_EVENTS} of phase 12's "
            f"events written in {out['write_s']:.2f} s; pio storageserver "
            f"up in {out['server_start_s']:.2f} s (beside the sqlite "
            f"train); pio train (the "
            f"template-get engine.json, rank {RANK}, "
            f"{spec['algorithms'][0]['params']['numIterations']} "
            f"iterations) on sqlite {direct['s']:.2f} s (read "
            f"{direct['read_ms']:.0f} ms) and on pioserver {wire['s']:.2f} "
            f"s (read {wire['read_ms']:.0f} ms = "
            f"{out['wire_events_per_s']:.0f} events/s over the wire, "
            f"{wire['read_ms'] / max(direct['read_ms'], 1e-9):.1f}x the "
            f"sqlite read); factors torch.equal by entity id (same "
            f"numbering {out['same_numbering']}); launches sqlite "
            f"{json.dumps(direct['launches'])}, pioserver "
            f"{json.dumps(wire['launches'])}; card {card}")
        del direct, dw

        # -- 22b: pio deploy on pioserver ------------------------------------
        deploy_env = proc_env(home, PIO_RESULT_CACHE="0", **remote,
                              **REMOTE_BREAKER)
        a = deployed(engine_json, os.path.join(work, "deploy.log"),
                     phase="phase 22", env=deploy_env)
        deploys.append(a)
        status = json.loads(a.get("/"))
        if not status["device"].startswith(dev.type) or \
                status["engineInstanceId"] != wire["id"]:
            die(f"phase 22b: deploy reports {status}")
        rng = np.random.default_rng(seed + 22)
        names = list(ww.user_index.keys())
        asked = [names[j] for j in rng.choice(len(names), REMOTE_QUERIES,
                                              replace=False)]
        answers, lats, server_ms = [], [], []
        for n, user in enumerate(asked):
            t0 = time.perf_counter()
            ans, ms = post_json(f"{a.base}/queries.json",
                                {"user": user, "num": 10})
            lats.append(time.perf_counter() - t0)
            if n == 0:
                out["deploy_to_first_s"] = time.perf_counter() - a.started_s
            answers.append(ans)
            server_ms.append(ms)
        items_d = torch.from_numpy(np.ascontiguousarray(wi)).to(dev)
        qerr = 0.0
        for user, ans in zip(asked, answers):
            hits = ans["itemScores"]
            if len(hits) != 10:
                die(f"phase 22b: the answer for {user} has {len(hits)} "
                    "items")
            qerr = max(qerr, check_against_plain(
                [[h["score"] for h in hits]],
                [[ww.item_index[h["item"]] for h in hits]],
                torch.from_numpy(wu[[ww.user_index[user]]]).to(dev),
                items_d, 10, None, f"phase 22b /queries.json {user}", ft,
                mods["topk_mismatch"]))
        out["p50_ms"] = sorted(lats)[len(lats) // 2] * 1e3
        out["server_p50_ms"] = sorted(server_ms)[len(server_ms) // 2]
        out["query_err"] = qerr
        log(f"phase 22b pioserver deploy: subprocess on "
            f"{status['device']}, start to first answer "
            f"{out['deploy_to_first_s']:.2f} s; {REMOTE_QUERIES} "
            f"/queries.json p50 {out['p50_ms']:.2f} ms (server "
            f"{out['server_p50_ms']:.2f} ms), each the plain top-k of the "
            f"persisted factors (max |score err| {qerr:.3g}); card {card}")

        # -- 22c: the storage server killed, then restarted ------------------
        drill_t0 = time.perf_counter()
        servers.pop().kill()
        during = [post_json(f"{a.base}/queries.json",
                            {"user": u, "num": 10})[0] for u in asked[:8]]
        if during != answers[:8]:
            die("phase 22c: answers changed with the storage server down")
        reloads = [reload_status(a.base)
                   for _ in range(int(REMOTE_BREAKER[
                       "PIO_BREAKER_THRESHOLD"]) + 1)]
        shed = reloads[-1]
        if [r[0] for r in reloads] != [503] * len(reloads) or \
                "circuit breaker 'modeldata' is open" not in shed[2] or \
                not shed[1] or int(shed[1]) < 1 or \
                any("is open" in r[2] for r in reloads[:-1]):
            die(f"phase 22c: /reload with the store down answered "
                f"{reloads}")
        if json.loads(a.get("/"))["breaker"] != "open":
            die("phase 22c: the modeldata breaker is not open")
        servers.append(storage_server(home, port, secret, server_log))
        out["restart_s"] = servers[-1].up_s
        deadline = time.perf_counter() + 30
        while json.loads(a.get("/"))["breaker"] == "open":
            if time.perf_counter() > deadline:
                die("phase 22c: the breaker stayed open")
            time.sleep(0.1)
        back = reload_status(a.base)
        after = [post_json(f"{a.base}/queries.json",
                           {"user": u, "num": 10})[0] for u in asked[:8]]
        if back[0] != 200 or after != answers[:8]:
            die(f"phase 22c: after the restart /reload answered {back} "
                "and the answers " + ("agree" if after == answers[:8]
                                      else "changed"))
        out["drill_s"] = time.perf_counter() - drill_t0
        a.stop()
        deploys.remove(a)
        out["topk_launches"] = a.launches["fused_topk"]
        if not out["topk_launches"]:
            die("phase 22b: the deploy process never launched fused_topk")
        log(f"phase 22c outage drill: storage server killed: 8 answers 200 "
            f"and unchanged; /reload {[(r[0], r[1]) for r in reloads]} "
            f"(the last shed by the open breaker: {shed[2]!r}); restarted "
            f"on port {port} in {out['restart_s']:.2f} s; after the "
            f"{REMOTE_BREAKER['PIO_BREAKER_RECOVERY_S']} s recovery /reload "
            f"{back[0]} in {back[3] * 1e3:.1f} ms, the 8 answers "
            f"unchanged; drill {out['drill_s']:.2f} s; the deploy launched "
            f"fused_topk {out['topk_launches']} times; exit 0 on POST "
            "/stop")

        # -- 22d: pio status on pioserver ------------------------------------
        with env_vars(**remote):
            try:
                rc, said, _ = run_pio(mods, ["status"], "22d")
            finally:
                reset_storage()
        for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
            if f"  {repo}: type=pioserver path=-" not in said:
                die(f"phase 22d: pio status printed {said!r}")
        servers.pop().kill()

        # -- 22e: entry() on the card against the CPU ------------------------
        forward, args = entry()
        s, i = forward(*args)
        cforward, cargs = entry(device="cpu")
        cs, ci = cforward(*cargs)
        if s.device.type != dev.type:
            die(f"phase 22e: entry() ran on {s.device}")
        why = mods["topk_mismatch"](s.cpu().numpy(), i.cpu().numpy(),
                                    cs.numpy(), ci.numpy(), None,
                                    rtol=RTOL, atol=ATOL)
        if why is not None:
            die(f"phase 22e: entry() on the card vs the CPU: {why}")
        out["entry_err"] = float((s.cpu() - cs).abs().max())
        out["entry_ids_equal"] = bool(torch.equal(i.cpu(), ci))
    finally:
        for d in deploys:
            d.kill()
        for srv in servers:
            srv.kill()
        reset_storage()
        env.__exit__()
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {
        "fused_gram": out["direct"]["launches"]["fused_gram"]
        + out["wire"]["launches"]["fused_gram"],
        "ridge_solve_lu": out["direct"]["launches"]["ridge_solve_lu"]
        + out["wire"]["launches"]["ridge_solve_lu"],
        "fused_topk": out["topk_launches"]}
    out["phase_s"] = time.perf_counter() - phase_t0
    log(f"phase 22e entry(): two-tower forward (512 x 1,024, embed 64, "
        f"top-10 of 8 users) on the card, max |score - CPU| "
        f"{out['entry_err']:.3g}, ids equal {out['entry_ids_equal']}; "
        f"phase 22 in {out['phase_s']:.1f} s (budget "
        f"{REMOTE_LIMIT_S:.0f} s); card {card}")
    return out


# Phase 23: the device mesh on the card.  23a: the sharded rung's
# scorer, K3 on every shard of a 4-shard mesh of this one card; 23b:
# phase 6's ML-25M ALS train on `data=4` with row-sharded factors and
# windowed gathers (K1, K2 on every shard); 23c: `pio train` and `pio
# deploy --mesh data=1` on phase 12's store as phase 12 trained it, in
# an NCCL world of one.  One card shows that the split and the merge
# give the meshless answer at full width, not any gain across cards.
MESH_SHARDS = 4
MESH_K = 10
MESH_REPS = 20
PHASE23_LIMIT_S = 90.0


def sharded_rung_phase(dev, seed: int, items_np, mods, card: str) -> dict:
    """23a: ``sharded_top_k`` on MESH_SHARDS shards of one card
    (``devices=[cuda:0] * 4``) at N 59,047 (tail padded) and 4,194,304,
    D 64, B 1 and 64, k 10: each answer against the meshless K3 and the
    plain version, both timed beside it."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops.topk import sharded_top_k
    from predictionio_tpu_torch.parallel.mesh import (
        PartitionSpec,
        make_mesh,
        put_sharded,
    )

    ft, topk_mismatch = mods["ft"], mods["topk_mismatch"]
    mesh = make_mesh({"data": MESH_SHARDS}, devices=[dev] * MESH_SHARDS)
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    corpora = {
        ML25M_ITEMS: torch.from_numpy(items_np).to(dev),
        BIG_ITEMS: torch.randn(BIG_ITEMS, RANK, generator=g, device=dev)
        / math.sqrt(RANK)}
    queries = torch.randn(64, RANK, generator=g, device=dev) \
        / math.sqrt(RANK)
    out = {"launches": 0, "err": 0.0, "rows": []}
    for n, items in corpora.items():
        pad = (-n) % MESH_SHARDS
        sharded = put_sharded(torch.nn.functional.pad(items, (0, 0, 0, pad)),
                              mesh, PartitionSpec("data"))
        for b in (1, 64):
            q = queries[:b].contiguous()
            before = ft.LAUNCHES              # main path starts here
            s, i = sharded_top_k(mesh, "data", q, sharded, MESH_K,
                                 n_valid=n)
            got = ft.LAUNCHES - before        # and ends here
            if got != MESH_SHARDS:
                die(f"phase 23a: N {n} B {b}: {got} K3 launches for "
                    f"{MESH_SHARDS} shards")
            out["launches"] += got
            s, i = s.cpu().numpy(), i.cpu().numpy()
            what = f"phase 23a sharded N {n} B {b}"
            out["err"] = max(out["err"], check_against_plain(
                s, i, q, items, MESH_K, None, what, ft, topk_mismatch))
            ms, mi = ft.fused_topk_cuda(q, items, MESH_K)
            ps, _ = ft.fused_topk_reference(q, items, MESH_K + 1)
            why = topk_mismatch(s, i, ms.cpu().numpy(), mi.cpu().numpy(),
                                ps[:, MESH_K].cpu().numpy(), rtol=RTOL,
                                atol=ATOL)
            if why is not None:
                die(f"{what} against the meshless K3: {why}")
            same = int((i == mi.cpu().numpy()).all(axis=1).sum())
            row = {
                "n": n, "b": b, "shards": MESH_SHARDS,
                "sharded_ms": time_single(lambda: sharded_top_k(
                    mesh, "data", q, sharded, MESH_K, n_valid=n),
                    MESH_REPS),
                "meshless_k3_ms": time_single(
                    lambda: ft.fused_topk_cuda(q, items, MESH_K), MESH_REPS),
                "plain_ms": time_single(
                    lambda: ft.fused_topk_reference(q, items, MESH_K),
                    MESH_REPS),
                "rows_ids_equal_meshless": f"{same}/{b}",
                "card": card}
            out["rows"].append(row)
            log("phase 23a sharded rung: " + json.dumps(row))
    del corpora, queries
    torch.cuda.empty_cache()
    return out


def mesh_train_phase(dev, seed: int, six: dict, mods, card: str) -> dict:
    """23b: phase 6's ML-25M inputs on a ``data=4`` mesh of one card,
    factors row-sharded, windowed gathers on: the factors against phase
    6's meshless factors (rtol 1e-3 + 1e-3·max|ref|, as phase 6), a
    second train ``torch.equal`` to the first, K1 and K2 counted."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.parallel.mesh import make_mesh

    als, fg, rs = mods["als"], mods["fg"], mods["rs"]
    users, items, ratings = six["ratings"]
    cfg = als.ALSConfig(rank=RANK, iterations=TRAIN_ITERS, reg=0.01,
                        solver="auto", seed=seed, factor_sharding="sharded",
                        gather_window=True)
    mesh = make_mesh({"data": MESH_SHARDS}, devices=[dev] * MESH_SHARDS)
    t0 = time.perf_counter()
    inputs = als.prepare_als_inputs(users, items, ratings, ML25M_USERS,
                                    ML25M_ITEMS, cfg, mesh=mesh)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    windowed = {side: sum(c.win is not None
                          for c in getattr(inputs, f"{side}_buckets"))
                for side in ("user", "item")}
    chunks = {side: len(getattr(inputs, f"{side}_buckets"))
              for side in ("user", "item")}
    fg.LAUNCHES = 0                          # main path starts here
    rs.LU_LAUNCHES = 0
    t0 = time.perf_counter()
    model = als.train_als_prepared(inputs, cfg)
    train_s = time.perf_counter() - t0
    launches = {"fused_gram": fg.LAUNCHES, "ridge_solve_lu": rs.LU_LAUNCHES}
    for name, n in launches.items():         # main path ends here
        if n == 0:
            die(f"phase 23b: {name} never launched in the mesh train")
    t0 = time.perf_counter()
    again = als.train_als_prepared(inputs, cfg)
    again_s = time.perf_counter() - t0
    for what in ("user_factors", "item_factors"):
        if not np.array_equal(getattr(model, what), getattr(again, what)):
            die(f"phase 23b: two mesh trains' {what} differ")
    del inputs, again
    err = 0.0
    for what in ("user_factors", "item_factors"):
        want = torch.from_numpy(getattr(six["model"], what))
        err = max(err, assert_close(
            torch.from_numpy(getattr(model, what)), want, TRAIN_RTOL,
            scaled(TRAIN_ATOL, want),
            f"phase 23b: mesh {what} vs phase 6's meshless"))
    out = {"launches": launches, "prep_s": prep_s, "train_s": train_s,
           "err": err}
    log(f"phase 23b mesh train: ML-25M {ML25M_USERS}x{ML25M_ITEMS}, "
        f"{ML25M_RATINGS} ratings, rank {RANK}, {TRAIN_ITERS} iterations "
        f"on data={MESH_SHARDS} of one card, factors row-sharded, "
        f"gather_window on: prep (host bucketing through the prefetcher, "
        f"the mesh placement; beside 23c's train subprocess) "
        f"{prep_s:.2f} s, {chunks['user']} user / "
        f"{chunks['item']} item chunks of which {windowed['user']} / "
        f"{windowed['item']} windowed; train {train_s:.3f} s = "
        f"{train_s * 1e3 / TRAIN_ITERS:.2f} ms/iter (again {again_s:.3f} s, "
        f"torch.equal); launches {json.dumps(launches)}; factors vs phase "
        f"6's meshless max |err| {err:.3g} (rtol {TRAIN_RTOL}, atol "
        f"{TRAIN_ATOL}·max|ref|); phase 6's host route prep "
        f"{six['host_prep_s']:.2f} s; card {card}")
    torch.cuda.empty_cache()
    return out


# 23c's subprocesses: an NCCL world of one each, the corpus sharded,
# the default plan with the host fast path off
MESH_CLI_ENV = dict(PIO_RETRIEVAL_RUNG=None, PIO_SERVE_HOST_MACS="1",
                    PIO_SERVE_SHARD_ABOVE="0", PIO_NUM_PROCESSES="1",
                    PIO_PROCESS_ID="0", PIO_MESH=None)


class mesh_train_cli:
    """23c's ``pio train --mesh data=1`` on phase 12's copied store, a
    subprocess through :func:`counted_pio`, started at once; ``wait()``
    gives its standard output, kernel launches and wall."""

    def __init__(self, loop: dict):
        self.argv = ["train", "--engine-json", loop["mesh_engine_json"],
                     "--mesh", "data=1"]
        base = os.path.join(os.path.dirname(loop["mesh_home"]), "train_23c")
        self.out_path, self.err_path = base + ".out", base + ".log"
        self.t0 = time.perf_counter()
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.counted_pio(sys.argv[1:]))",
                 *self.argv],
                cwd=Path(__file__).resolve().parent, stdout=out, stderr=err,
                env=proc_env(loop["mesh_home"], **MESH_CLI_ENV,
                             PIO_COORDINATOR_ADDRESS=(
                                 f"127.0.0.1:{free_port()}")))

    def wait(self) -> tuple:
        rc = self.proc.wait(timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - self.t0
        if rc != 0:
            die(f"phase 23c: pio {' '.join(self.argv)} exited {rc}: "
                f"{Path(self.err_path).read_text()[-2000:]}")
        said = Path(self.out_path).read_text()
        launches = next((json.loads(ln[len("launches "):])
                         for ln in said.splitlines()
                         if ln.startswith("launches ")), None)
        return said, launches, wall

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def mesh_cli_phase(dev, loop: dict, train: mesh_train_cli, mods,
                   card: str) -> dict:
    """23c: on phase 12's store as phase 12 trained it (its copy),
    ``pio train --mesh data=1`` (``train``, started earlier) and ``pio
    deploy --mesh data=1`` as subprocesses, each in an NCCL world of one
    (``PIO_COORDINATOR_ADDRESS`` on loopback, ``PIO_NUM_PROCESSES=1``),
    the corpus sharded (``PIO_SERVE_SHARD_ABOVE=0``) and routed by the
    default plan (host fast path off): phase 12's 64 queries, each the
    plain top-k of the mesh train's factors and phase 12's answer within
    the training tolerance; the plan named by /metrics is ``sharded``."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.data.storage import get_storage, \
        reset_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_models

    ft, topk_mismatch = mods["ft"], mods["topk_mismatch"]
    home, engine_json = loop["mesh_home"], loop["mesh_engine_json"]
    work = os.path.dirname(home)
    out = {}
    said, launches, out["train_s"] = train.wait()
    if "Mesh: {'data': 1} over 1 device(s)" not in said:
        die(f"phase 23c: pio train --mesh printed {said[-500:]!r}")
    if not launches or not launches["fused_gram"] \
            or not launches["ridge_solve_lu"]:
        die(f"phase 23c: the mesh train launched {launches}")
    out["launches"] = {"fused_gram": launches["fused_gram"],
                       "ridge_solve_lu": launches["ridge_solve_lu"]}
    reset_storage()
    with cli_env(home):
        storage = get_storage()
        inst = max((i for i in storage.get_engine_instances().get_all()
                    if i.status == "COMPLETED"), key=lambda i: i.start_time)
        [wrapper] = load_models(
            mods["engine"](), inst,
            mods["RuntimeContext"](storage=storage, device=dev))
        uf, itf = wrapper.host_factors()
        reset_storage()
    d = None
    try:
        d = deployed(engine_json, os.path.join(work, "deploy_23c.log"),
                     extra=("--mesh", "data=1"), phase="phase 23c",
                     env=proc_env(home, **MESH_CLI_ENV,
                                  PIO_COORDINATOR_ADDRESS=(
                                      f"127.0.0.1:{free_port()}")))
        if d.instance != inst.id:
            die(f"phase 23c: the deploy serves {d.instance}, not the mesh "
                f"train's {inst.id}")
        items_d = torch.from_numpy(np.ascontiguousarray(itf)).to(dev)
        u12, i12, uidx12, iidx12 = loop["factors12"]
        items12 = torch.from_numpy(np.ascontiguousarray(i12)).to(dev)
        lats, qerr, terr = [], 0.0, 0.0
        for user, want in zip(loop["asked"], loop["answers"]):
            t0 = time.perf_counter()
            ans, _ = post_json(f"{d.base}/queries.json",
                               {"user": user, "num": 10})
            lats.append(time.perf_counter() - t0)
            hits = ans["itemScores"]
            s = [[h["score"] for h in hits]]
            qerr = max(qerr, check_against_plain(
                s, [[wrapper.item_index[h["item"]] for h in hits]],
                torch.from_numpy(uf[[wrapper.user_index[user]]]).to(dev),
                items_d, 10, None, f"phase 23c /queries.json {user}", ft,
                topk_mismatch))
            # against phase 12's meshless answer: another train of the
            # same events, so the training tolerance, ties at its edge
            ps, _ = ft.fused_topk_reference(
                torch.from_numpy(u12[[uidx12[user]]]).to(dev), items12, 11)
            ws = [[h["score"] for h in want["itemScores"]]]
            why = topk_mismatch(
                s, [[iidx12[h["item"]] for h in hits]], ws,
                [[iidx12[h["item"]] for h in want["itemScores"]]],
                ps[:, 10].cpu().numpy(), rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
            if why is not None:
                die(f"phase 23c: {user} against phase 12's answer: {why}")
            terr = max(terr, float(np.max(np.abs(np.asarray(s) -
                                                 np.asarray(ws)))))
        metrics = d.get("/metrics")
        rungs = {}
        for ln in metrics.splitlines():
            if ln.startswith("pio_retrieval_requests_total{"):
                rung = ln.split('rung="', 1)[1].split('"', 1)[0]
                rungs[rung] = rungs.get(rung, 0.0) + float(ln.split()[-1])
        if set(rungs) != {"sharded"} or rungs["sharded"] < 1:
            die(f"phase 23c: the deploy's retrievals by rung {rungs}")
        d.stop()
        topk = d.launches["fused_topk"]
        d = None
    finally:
        if d is not None:
            d.kill()
    if topk < rungs["sharded"]:
        die(f"phase 23c: {topk} K3 launches for {rungs['sharded']} "
            "sharded retrievals")
    out["launches"]["fused_topk"] = topk
    out.update(p50_ms=sorted(lats)[len(lats) // 2] * 1e3, query_err=qerr,
               vs_phase12=terr, rungs=rungs)
    log(f"phase 23c mesh CLI: pio train --mesh data=1 (NCCL world of one; "
        f"a subprocess beside 23a and 23b) {out['train_s']:.2f} s on phase "
        f"12's store, launches "
        f"{json.dumps(out['launches'])}; pio deploy --mesh data=1: "
        f"retrievals by rung {json.dumps(rungs)}; {len(lats)} "
        f"/queries.json p50 {out['p50_ms']:.2f} ms, each the plain top-k "
        f"of the mesh train's factors (max |score err| {qerr:.3g}) and "
        f"phase 12's meshless answer within rtol {TRAIN_RTOL} + atol "
        f"{TRAIN_ATOL} (max |score diff| {terr:.3g}); card {card}")
    return out


def mesh_phase(dev, seed: int, items_np, six: dict, loop: dict, mods,
               card: str) -> dict:
    """Phase 23, 23a-c (23c's train runs beside 23a and 23b); returns
    the launches of K1, K2 and K3."""
    t0 = time.perf_counter()
    cli_train = mesh_train_cli(loop)
    try:
        rung = sharded_rung_phase(dev, seed, items_np, mods, card)
        train = mesh_train_phase(dev, seed, six, mods, card)
        cli = mesh_cli_phase(dev, loop, cli_train, mods, card)
    finally:
        cli_train.kill()
    phase_s = time.perf_counter() - t0
    launches = {
        "fused_topk": rung["launches"] + cli["launches"]["fused_topk"],
        "fused_gram": train["launches"]["fused_gram"]
        + cli["launches"]["fused_gram"],
        "ridge_solve_lu": train["launches"]["ridge_solve_lu"]
        + cli["launches"]["ridge_solve_lu"]}
    log(f"phase 23 in {phase_s:.1f} s (budget {PHASE23_LIMIT_S:.0f} s); "
        f"launches {json.dumps(launches)}; card {card}")
    if phase_s > PHASE23_LIMIT_S:
        log(f"phase 23 over its budget: {phase_s:.1f} s > "
            f"{PHASE23_LIMIT_S:.0f} s")
    return {"launches": launches, "phase_s": phase_s, "rows": rung["rows"],
            "err": rung["err"], "train": train}


def post_json(url: str, obj):
    """POST one query; returns (answer, the server's own wall ms)."""
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        # the native frontend sends no X-PIO-Server-Ms
        return json.loads(r.read()), float(
            r.headers.get("X-PIO-Server-Ms", "nan"))


def answer_arrays(answer, num):
    """itemScores of one answer → ([1, num] scores, [1, num] int ids)."""
    hits = answer["itemScores"]
    if len(hits) != num:
        die(f"answer has {len(hits)} items, expected {num}")
    return ([[h["score"] for h in hits]],
            [[int(h["item"][1:]) for h in hits]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false; this smoke run needs an "
            "NVIDIA card")
    try:
        from predictionio_tpu_torch.controller import (
            EngineVariant, RuntimeContext)
        from predictionio_tpu_torch.data.event import DataMap, Event
        from predictionio_tpu_torch.cli.main import main as pio
        from predictionio_tpu_torch.config import memory_config
        from predictionio_tpu_torch.data.storage import App, Storage
        from predictionio_tpu_torch.device import set_float32_precision
        from predictionio_tpu_torch.models import als
        from predictionio_tpu_torch.obs import get_registry
        from predictionio_tpu_torch.ops import _build
        from predictionio_tpu_torch.ops import fused_gram as fg
        from predictionio_tpu_torch.ops import fused_topk as ft
        from predictionio_tpu_torch.ops import gather as gt
        from predictionio_tpu_torch.ops import pq_scan as pqs
        from predictionio_tpu_torch.ops import ridge_solve as rs
        from predictionio_tpu_torch.ops.topk import topk_mismatch
        from predictionio_tpu_torch import retrieval
        from predictionio_tpu_torch.retrieval import pq as tpq
        from predictionio_tpu_torch.server.engine_server import EngineServer
        from predictionio_tpu_torch.templates.recommendation import (
            engine, wrapper_from_numpy)
        from predictionio_tpu_torch.tools import exp_gather2, exp_gram
        from predictionio_tpu_torch.workflow.core_workflow import (
            persist_instance, run_train)
    except ImportError as e:
        die(f"cannot import the port (run from the repository root): {e}")

    def memory_storage(home):
        """A fresh in-process store (every repository on MEMORY)."""
        return Storage(memory_config(home))

    # -- phase 1: device ------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    log(f"phase 1 device: {card} | {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | built {sorted(built)} in {build_s:.2f} s "
        f"(parallel nvcc; per source {json.dumps(built)})")
    spilled = []
    for name in built:
        rep = _build.library_path(name).with_name(
            _build.library_path(name).name + ".log").read_text()
        kernel = "?"
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            if "registers" in line or "spill" in line:
                log(f"  {name} ptxas: {line.strip()}")
            if "spill" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spilled.append(f"{name}: {kernel}: {line.strip()}")
    log("phase 1 ptxas: " + ("no kernel spills registers" if not spilled
                             else f"spills in {spilled}"))
    set_float32_precision()
    dev = torch.device("cuda")

    # -- data (seeded; made in bulk) -----------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    scale = np.float32(np.sqrt(RANK))
    users_np = rng.standard_normal((ML25M_USERS, RANK), np.float32) / scale
    items_np = rng.standard_normal((ML25M_ITEMS, RANK), np.float32) / scale
    big_np = rng.standard_normal((BIG_ITEMS, RANK), np.float32) / scale
    items_d = torch.from_numpy(items_np).to(dev)
    big_d = torch.from_numpy(big_np).to(dev)
    queries_d = torch.from_numpy(users_np[:128]).to(dev).contiguous()
    log(f"data: seed {args.seed}, factors made in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernel vs plain version --------------------------------
    max_err, timings = topk_kernel_phase(
        dev, ft, _build, topk_mismatch, queries_d,
        {ML25M_ITEMS: items_d, BIG_ITEMS: big_d}, card)

    # -- phase 3: training kernels vs their plain versions ----------------
    train_kernel_err = training_kernels_phase(dev, fg, rs, card)
    torch.cuda.empty_cache()

    # -- phase 4: serve at the MovieLens-25M shape ------------------------
    home = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    server = None
    try:
        eng = engine()
        spec = json.loads((_build.CSRC_DIR.parent / "templates" /
                           "recommendation" / "engine.json").read_text())
        spec["algorithms"][0]["params"]["rank"] = RANK
        variant = EngineVariant.from_dict(spec)
        storage = memory_storage(home)
        wrapper = wrapper_from_numpy(
            users_np, items_np, [f"u{j}" for j in range(ML25M_USERS)],
            [f"i{j}" for j in range(ML25M_ITEMS)], rank=RANK)
        persist_instance(eng, variant, [wrapper], storage)
        os.environ["PIO_RETRIEVAL_RUNG"] = "chunked"
        server = EngineServer(eng, variant, storage, host="127.0.0.1",
                              port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        users = rng.choice(ML25M_USERS, size=16 + 64, replace=False)
        ft.LAUNCHES = 0                       # main path starts here
        lats, server_ms, answers = [], [], []
        for u in users[:16]:
            t0 = time.perf_counter()
            ans, ms = post_json(f"{base}/queries.json",
                                {"user": f"u{u}", "num": 10})
            lats.append(time.perf_counter() - t0)
            answers.append(ans)
            server_ms.append(ms)
        retrieval_ms = get_registry().get("pio_retrieval_ms")
        n_ret = retrieval_ms.count(rung="chunked")
        ret_mean = retrieval_ms.sum(rung="chunked") / max(n_ret, 1)
        batch_users = users[16:]
        t0 = time.perf_counter()
        batch = server.query_batch([{"user": f"u{u}", "num": 10}
                                    for u in batch_users])
        batch_s = time.perf_counter() - t0
        main_launches = ft.LAUNCHES           # main path ends here
        if main_launches < 17:
            die(f"fused_topk launched {main_launches} times on the main "
                "path; expected one per request and one for the batch")
        err = 0.0
        for u, ans in zip(users[:16], answers):
            s, i = answer_arrays(ans, 10)
            err = max(err, check_against_plain(
                s, i, torch.from_numpy(users_np[[u]]).to(dev), items_d, 10,
                None, f"/queries.json user u{u}", ft, topk_mismatch))
        bs, bi = zip(*(answer_arrays(a, 10) for a in batch))
        err = max(err, check_against_plain(
            np.concatenate(bs), np.concatenate(bi),
            torch.from_numpy(users_np[batch_users]).to(dev), items_d, 10,
            None, "query_batch", ft, topk_mismatch))
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        if 'pio_retrieval_requests_total{rung="chunked",corpus="als"}' \
                not in metrics:
            die("/metrics lacks pio_retrieval_requests_total for the "
                "chunked rung")
        p50_ms = sorted(lats)[len(lats) // 2] * 1e3
        log(f"phase 4 serve: ML-25M shape {ML25M_USERS}x{ML25M_ITEMS} "
            f"rank {RANK}, rung chunked: 16 /queries.json p50 "
            f"{p50_ms:.2f} ms (first {lats[0] * 1e3:.2f} ms, max "
            f"{max(lats) * 1e3:.2f} ms; server-side p50 "
            f"{sorted(server_ms)[8]:.2f} ms; retrieval mean "
            f"{ret_mean:.3f} ms over {n_ret}), sequential "
            f"{16 / sum(lats):.1f} recs/s; query_batch of 64 in "
            f"{batch_s * 1e3:.2f} ms = {64 / batch_s:.1f} recs/s; "
            f"fused_topk launches {main_launches}; max |score err| "
            f"{err:.3g}; card {card}")
        server.stop()
        server = None
        del wrapper

        # -- phase 5: the large catalog routes to chunked unforced -------
        os.environ.pop("PIO_RETRIEVAL_RUNG", None)
        n_users4 = 1024
        wrapper = wrapper_from_numpy(
            users_np[:n_users4], big_np, [f"u{j}" for j in range(n_users4)],
            [f"i{j}" for j in range(BIG_ITEMS)], rank=RANK)
        rung = wrapper.retriever().plan(1, 10).rung
        if rung != "chunked":
            die(f"a {BIG_ITEMS}-item corpus routed to {rung!r}, "
                "expected 'chunked'")
        persist_instance(eng, variant, [wrapper], storage)
        del wrapper
        server = EngineServer(eng, variant, storage, host="127.0.0.1",
                              port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"
        before = ft.LAUNCHES
        users4 = rng.choice(n_users4, size=8, replace=False)
        lats4 = []
        err4 = 0.0
        for u in users4:
            t0 = time.perf_counter()
            ans, _ = post_json(f"{base}/queries.json",
                               {"user": f"u{u}", "num": 10})
            lats4.append(time.perf_counter() - t0)
            s, i = answer_arrays(ans, 10)
            err4 = max(err4, check_against_plain(
                s, i, torch.from_numpy(users_np[[u]]).to(dev), big_d, 10,
                None, f"large catalog user u{u}", ft, topk_mismatch))
        if ft.LAUNCHES - before != 8:
            die(f"large catalog: {ft.LAUNCHES - before} fused_topk "
                "launches for 8 queries")
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = r.read().decode()
        line = next((ln for ln in metrics.splitlines() if ln.startswith(
            'pio_retrieval_requests_total{rung="chunked",corpus="als"}')),
            "")
        log(f"phase 5 catalog: {BIG_ITEMS} items routed to chunked by "
            f"the default thresholds; 8 /queries.json p50 "
            f"{sorted(lats4)[4] * 1e3:.2f} ms; max |score err| "
            f"{err4:.3g}; {line}")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(home, ignore_errors=True)
    del items_d, big_d, queries_d, big_np
    torch.cuda.empty_cache()

    # -- phase 6: ALS training at the MovieLens-25M shape -----------------
    train = train_phase(dev, args.seed, als, fg, rs, card)
    # -- phase 19a: the same train under checkpoints, while its inputs live
    supervised = supervised_als_runs(dev, train, als, fg, rs, card)
    # phase 23b trains phase 6's ratings again on a mesh
    six = {"ratings": train.pop("ratings"), "model": train["model"],
           "host_prep_s": train["prep"]["host_s"]}
    for key in ("inputs", "cfg", "model"):
        del train[key]
    torch.cuda.empty_cache()

    scorecards = timed_scorecards()
    marks = []

    def mark(phase: str) -> None:
        """The scorecards' seconds and builds since the previous mark."""
        prev = marks[-1][1] if marks else {"s": 0.0, "calls": 0}
        marks.append((phase, dict(scorecards)))
        log(f"phase {phase} scorecards: {scorecards['s'] - prev['s']:.4f} s "
            f"in {scorecards['calls'] - prev['calls']} builds of the "
            f"phase's in-process trains")

    mods = {
        "fg": fg, "rs": rs, "ft": ft, "gt": gt, "pqs": pqs, "tpq": tpq,
        "retrieval": retrieval, "exp_gram": exp_gram,
        "exp_gather2": exp_gather2, "memory_storage": memory_storage,
        "App": App,
        "Event": Event, "DataMap": DataMap, "csrc": _build.CSRC_DIR,
        "EngineVariant": EngineVariant, "engine": engine,
        "RuntimeContext": RuntimeContext, "run_train": run_train,
        "EngineServer": EngineServer, "topk_mismatch": topk_mismatch,
        "get_registry": get_registry, "wrapper_from_numpy": wrapper_from_numpy,
        "persist_instance": persist_instance, "pio": pio,
    }
    home = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    try:
        # -- phase 7: events → run_train → deploy → /queries.json ---------
        dase = dase_phase(dev, args.seed, home, mods, card)
        dase_topk = dase["fused_topk"]
        mark("7")
        torch.cuda.empty_cache()

        # -- phase 8: the PQ scan kernel vs its plain version --------------
        pq_err, pq_rows = pq_kernel_phase(dev, args.seed, pqs, tpq,
                                          topk_mismatch, card)

        # -- phase 9: the gather experiments' kernels ----------------------
        gather_rows = gather_kernels_phase(dev, args.seed, mods, card)

        # -- phase 10: a 1,048,576-item catalog on the PQ rungs ------------
        pq_serve = pq_serve_phase(args.seed, home, users_np, mods, card)
        torch.cuda.empty_cache()

        # -- phase 11: phase 7's events trained again with PQ codes --------
        pq_dase = pq_dase_phase(dase, mods, card)
        mark("11")
        del dase
    finally:
        shutil.rmtree(home, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- phase 12: the engine.json loop across processes (the CLI) --------
    loop = cli_loop_phase(dev, args.seed, mods, card)
    mark("12")
    torch.cuda.empty_cache()
    # -- phases 19b-e: checkpoints, profiler and traces on phase 12's store
    try:
        ckpt = checkpoint_cli_phase(dev, loop, mods, card)
        mark("19b-e")
    except BaseException:
        shutil.rmtree(loop["work"], ignore_errors=True)
        raise
    log(f"phase 19: {supervised['phase_s'] + ckpt['phase_s']:.2f} s "
        f"(19a {supervised['phase_s']:.2f} s, 19b-e {ckpt['phase_s']:.2f} "
        f"s; budget {PHASE19_LIMIT_S:.0f} s)")
    torch.cuda.empty_cache()

    # -- phase 13: the aggregate_properties templates (the CLI) -----------
    tpl = templates_phase(dev, args.seed, mods, card)
    mark("13")
    torch.cuda.empty_cache()

    # -- phase 14: the event server: HTTP ingest → train → serve ----------
    es = eventserver_phase(dev, args.seed, mods, card)
    mark("14")
    torch.cuda.empty_cache()

    # -- phase 15: the serving scheduler, the result cache, --native ------
    try:
        sched = scheduler_phase(dev, args.seed, users_np, items_np, mods,
                                card)
    except BaseException:
        shutil.rmtree(loop["work"], ignore_errors=True)
        raise
    torch.cuda.empty_cache()

    # -- phase 16: staged reload, rollback, the warm-start refresh --------
    # -- phase 17: the two-tower engine on phase 12's store ---------------
    # -- phase 18: the DLRM engine on phase 12's store ---------------------
    try:
        refresh = refresh_phase(dev, args.seed, loop, mods, card)
        mark("16")
        torch.cuda.empty_cache()
        tt = two_tower_phase(dev, args.seed, loop, mods, card)
        mark("17")
        torch.cuda.empty_cache()
        dlrm_phase(dev, args.seed, loop, mods, card)
        torch.cuda.empty_cache()
        # -- phase 20: the waterfall, /ready, the quality canary gate -----
        obs = obs_phase(dev, args.seed, loop, mods, card)
        mark("20")
        torch.cuda.empty_cache()
        # -- phase 21: the fleet plane on phases 15's and 12's stores -----
        fleet = fleet_phase(dev, args.seed, users_np, items_np, sched, loop,
                            mods, card)
        torch.cuda.empty_cache()
        # -- phase 22: the storage server: train and serve on pioserver ---
        remote = remote_phase(dev, args.seed, loop, mods, card)
        torch.cuda.empty_cache()
        # -- phase 23: the device mesh on the card -------------------------
        mesh = mesh_phase(dev, args.seed, items_np, six, loop,
                          dict(mods, als=als), card)
        del six
    finally:
        shutil.rmtree(loop["work"], ignore_errors=True)
        shutil.rmtree(sched["work"], ignore_errors=True)
    torch.cuda.empty_cache()

    # -- phase 24: report --------------------------------------------------
    main_shape = timings[(ML25M_ITEMS, 1, 10)]
    b64 = timings[(ML25M_ITEMS, 64, 10)]   # a full batch of query_batch
    kernels = [{
        "name": "fused_topk",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/pallas_kernels.py:444",
        "launches": main_launches + loop["launches"]["fused_topk"]
        + es["launches"]["fused_topk"] + sched["launches"]
        + sched["inline_launches"] + sched["native_launches"]
        + sched["off_launches"]
        + refresh["launches"]["fused_topk"] + tt["launches"]["fused_topk"]
        + ckpt["launches"]["fused_topk"] + obs["launches"]["fused_topk"]
        + fleet["launches"]["fused_topk"] + remote["launches"]["fused_topk"]
        + mesh["launches"]["fused_topk"],
        "max_abs_err": max(max_err, err, err4),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "ms_b64": b64["ms"],
        "plain_ms_b64": b64["plain_ms"],
        "library_ms_b64": b64["library_ms"],
        "bound_ms_b64": b64["bound_ms"],
        "bound_by_b64": b64["bound_by"],
    }]
    replaces = {"fused_gram": "predictionio_tpu/ops/pallas_kernels.py:135",
                "ridge_solve_lu": "predictionio_tpu/ops/pallas_kernels.py:358",
                "ridge_solve_gj": "predictionio_tpu/ops/pallas_kernels.py:300"}
    for name, where in replaces.items():
        row = train["per_iter"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "predictionio_tpu_torch/csrc/" + (
                "fused_gram.cu" if name == "fused_gram" else
                "ridge_solve.cu"),
            "replaces": where,
            "launches": train["launches"][name]
            + loop["launches"].get(name, 0) + tpl["launches"].get(name, 0)
            + es["launches"].get(name, 0)
            + refresh["launches"].get(name, 0)
            + supervised["launches"].get(name, 0)
            + ckpt["launches"].get(name, 0)
            + obs["launches"].get(name, 0)
            + fleet["launches"].get(name, 0)
            + remote["launches"].get(name, 0)
            + mesh["launches"].get(name, 0),
            "max_abs_err": train_kernel_err[name],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    pq_main = pq_rows[1]     # B = 1: the shape of one pq_flat request
    kernels.append({
        "name": "pq_scan",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/pq_scan.cu",
        "replaces": "predictionio_tpu/ops/pallas_kernels.py:592",
        "launches": pq_serve["launches"] + pq_dase["launches"],
        "max_abs_err": pq_err,
        "ms": pq_main["ms"],
        "plain_ms": pq_main["plain_ms"],
        "bound_ms": pq_main["bound_ms"],
        "bound_by": pq_main["bound_by"],
        "library_ms": pq_main["library_ms"],
    })
    for name, source, where in (
            ("gather_gram", "fused_gram.cu", "tools/exp_gram.py:90"),
            ("gather_sum", "gather_sum.cu", "tools/exp_gather2.py:69")):
        row = gather_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "predictionio_tpu_torch/csrc/" + source,
            "replaces": where,
            "launches": row["launches"],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    log(f"launches: pq_scan {pq_serve['launches']} on the PQ serve path "
        f"(phase 10) + {pq_dase['launches']} on the DASE+PQ path (phase "
        f"11), timed at B = 1 (one pq_flat request's shape); gather_gram "
        f"and gather_sum per their tools' entry points (phase 9)")
    log(f"launches: fused_topk {main_launches} on the serve path (phase "
        f"4) + {loop['launches']['fused_topk']} on the CLI path (phase 12: "
        f"batchpredict and eval) + {es['launches']['fused_topk']} in phase "
        f"14's deploy process + {sched['launches']} coalesced, "
        f"{sched['inline_launches']} inline, {sched['off_launches']} "
        f"on the monitors' off/on servers and "
        f"{sched['native_launches']} in the native deploy process (phase "
        f"15), {refresh['launches']['fused_topk']} in phase 16 (its "
        f"deploy process and the eviction's server), "
        f"{tt['launches']['fused_topk']} in phase 17 (two-tower: its deploy "
        f"process and retrieve(chunk=)), {ckpt['launches']['fused_topk']} "
        f"in phase 19 (19c's eval and 19e's deploy process), "
        f"{obs['launches']['fused_topk']} in phase 20 (dispatches and the "
        f"shadow scorer's re-predictions), "
        f"{fleet['launches']['fused_topk']} in phase 21 (its six deploy "
        f"processes and 21f's server), {remote['launches']['fused_topk']} "
        f"in phase 22's pioserver deploy process, "
        f"{mesh['launches']['fused_topk']} in phase 23 (23a's sharded calls "
        f"and 23c's mesh deploy process), {dase_topk} "
        f"on the DASE path; training "
        f"kernels per the train run (fused_gram, ridge_solve_lu) + the CLI "
        f"path's train and eval ({loop['launches']['fused_gram']}, "
        f"{loop['launches']['ridge_solve_lu']}), the similarproduct and "
        f"ecommerce trains of phase 13 ({tpl['launches']['fused_gram']}, "
        f"{tpl['launches']['ridge_solve_lu']}), phase 14's train of the "
        f"ingested events ({es['launches']['fused_gram']}, "
        f"{es['launches']['ridge_solve_lu']}), phase 16's full fallback "
        f"({refresh['launches']['fused_gram']}, "
        f"{refresh['launches']['ridge_solve_lu']}), phase 19's supervised "
        f"trains (19a {json.dumps(supervised['launches'])}, 19b-d "
        f"({ckpt['launches']['fused_gram']}, "
        f"{ckpt['launches']['ridge_solve_lu']})), phase 20's retrains "
        f"({obs['launches']['fused_gram']}, "
        f"{obs['launches']['ridge_solve_lu']}), phase 21d's fallback cycle "
        f"({fleet['launches']['fused_gram']}, "
        f"{fleet['launches']['ridge_solve_lu']}), phase 22a's sqlite and "
        f"pioserver trains ({remote['launches']['fused_gram']}, "
        f"{remote['launches']['ridge_solve_lu']}), phase 23's mesh trains "
        f"({mesh['launches']['fused_gram']}, "
        f"{mesh['launches']['ridge_solve_lu']}) and the solver='gj' run "
        f"(ridge_solve_gj); timings of the training kernels are over one "
        f"iteration's calls at the ML-25M shape")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
