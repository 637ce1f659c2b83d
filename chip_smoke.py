#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA card.

    python3 chip_smoke.py [--n 500000] [--d 1024] [--users 20000] [--d-re 32] [--seed 0]

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, each of which must pass:

1. the card's name and power limit (nvidia-smi); TF32 off for matmul and cuDNN;
2. build every CUDA source of photon_ml_tpu_torch/csrc with nvcc for sm_90a
   (one nvcc per source, started together) and print -Xptxas -v;
3. hold each kernel against its plain PyTorch version, computed in float64
   from the same rounded inputs: all 4 losses, f32 and bf16 X, aligned and
   ragged row counts, small shapes and the main path's n x d, the Hessian
   statistics with and without the normalization shifts. Bounds are the
   reference suite's: value and s0 rtol 2e-6; gradient, Hv (with their
   scalar sums), s2 and s1 max-abs error <= 3e-5 * max(|ref|, 1); then B4's
   parts: the rank-order sum kernel against its plain version (bitwise, worlds
   1, 2, 4 and 8 at the main path's output widths) and the finalize's slot
   form against the f32 output widened (bitwise, B1-B3 at n x d); then V1,
   the lane reduction of the vmapped random-effect solve, in each of its
   four call forms at the billion-coefficient slice's shape against its
   plain version in float64 (max-abs error <= 3e-5 * max(|ref|, 1));
4. the fixed-effect path: bench-shaped logistic data made on the card from
   --seed, batch_from_dense -> GLMProblem(TRON, tol 1e-6, 10 iterations,
   L2 1.0).run -> model.score -> auc, with every launch counter at 0 before
   and read after; the same solve with the plain versions forced must agree
   at rtol 1e-3, atol 1e-5, and the card's solve of a small problem must
   reach the CPU solve's loss at rtol 1e-5; then one L-BFGS solve;
5. the GLMix sweep, the main path: bench.py's build_data (n x d dense fixed
   effect, --users users with --d-re per-user features, Zipf-skewed), one
   CoordinateDescent sweep of FixedEffectCoordinate (TRON tol 1e-6, 10
   iterations, L2 1.0, SIMPLE variance: kernels B1, B2, B3) and
   RandomEffectCoordinate (packed batched L-BFGS tol 1e-6, 30 iterations,
   L2 1.0, active cap 256), three timed sweeps after a warm-up one (five
   before the data-parallel phase joined the run's time limit), with
   every launch counter at 0 before them and read after (B3 launches once
   per fixed-effect solve). The same sweep with the
   plain versions forced must agree, and so must a small sweep on the card
   and on the CPU: fixed-effect coefficients and variances at rtol 1e-3 /
   atol 1e-5; random-effect coefficients at atol 5e-3 and per-entity loss
   at atol 1e-4, on identical residuals (the other side's random effect
   retrained on this side's fixed-effect scores). Random effects chained on
   two fixed effects are printed, not held: at bench shapes two fixed
   effects that agree to 1e-8 leave a capped user's loss (~1.7e4, with the
   count/cap weight rescale) apart by ~2e-4 (PERF.md).
   Prints the median sweep's wall seconds and examples/s with the spread,
   the coordinates' shares of the wall, syncs per coordinate and the
   training AUC; then one more sweep under torch.profiler (the device's busy
   share of the sweep, the top device operations);
6. the data-parallel GLMix sweep (kernel B4: B1-B3 on each rank's rows, the
   finalize writing into the rank's row of a float64 slot buffer, one
   all-gather over torch.distributed and the rank-order sum kernel), in
   processes started by photon_ml_tpu_torch.parallel.spawn, the kernels
   built here first:
   (a) B4 on 4 gloo ranks sharing the card against the float64 plain
   versions on the whole batch, at n and n-1 rows, f32 and bf16 X, logistic,
   Hessian statistics with and without shifts, at the bounds of phase 3;
   every rank bitwise alike, and bitwise equal to the all-reduce path (the rank's
   f32 outputs into a zero slot buffer, an all-reduce, a loop); at n rows
   and f32 X each function's time per call in turns with the all-reduce path
   (prev, new, new, prev), its collective alone (both designs) and the rank's
   kernel alone (the bf16 turns were cut to make room for phase 18);
   (b) the sweep of phase 5 on 4 gloo ranks (each rank reads its rows of the
   fixed effect's X from a memory-mapped .npy the parent wrote, builds the
   random effect and keeps its entity range), one warm-up and three timed
   sweeps, walls on rank 0 between barriers after a synchronize on every
   rank, launch counters at 0 before them; held against phase 5's sweep:
   fixed-effect coefficients and variances rtol 1e-3 / atol 1e-5,
   random-effect coefficients atol 5e-3 and per-entity loss atol 1e-4 on
   identical residuals (phase 5's random effect retrained on the 4-rank
   fixed effect's scores); prints examples/s, shares, each rank's RE wall
   and padded work, syncs and collectives per coordinate;
   (c) the same sweep over NCCL with one rank per card, one warm-up and
   three timed sweeps, the median printed beside phase 5's: on a one-card
   machine one rank, whose fixed-effect coefficients and variances must
   equal phase 5's bitwise; B4's three functions timed there as in (a), a
   B4 call of each with CUDA's sync debug mode at "error" and
   torch.cuda.synchronize counted (no host synchronize allowed), and the
   device operations of one profiled call;
7. each kernel timed with CUDA events beside its bound (bytes over 3.35 TB/s,
   or operations over the dtype's peak) and its plain version (the rank-order
   sum, a few microseconds, replayed from a CUDA graph, beside torch.sum over
   the ranks); B3 in turns with its serial finalize (prev/new/new/prev;
   B1's and B2's turns with the earlier staged body left the script to
   make room for phase 17 (f)),
   each kernel's main step and finalize alone (replayed from a CUDA graph),
   the launch plan (grid, blocks per SM, rows per tile, stages, shared
   bytes), and torch.mv(X, coef) as the time to read X once;
8. diagnostic variants of the segment kernel (SEGMENT_VARIANTS: contiguous
   reads in place of the gathers, the key walk without its output stores,
   the gathers under an L2 evict-last policy, the earlier design as it is
   and with streamed entries) on the sparse shape's products, replayed from CUDA
   graphs in turns, and ELL matvec with w of 10, 20 and 30 MB beside d's
   40 (with --prev-segment-source PATH, an earlier csrc/sparse_glm.cu too:
   S1's products and S2 at L = 1, 4, 8 and 16 in turns with it, bits
   compared); then of the ring body (RING_VARIANTS: margins in f32, no margins, no
   column sums, neither), each computing wrong sums, timed in turns with
   the ring to show what each part of its work costs. Phase 8 runs only
   under --only variants, not in a whole run;
9. the sparse fixed effects (run after phase 6 and before phase 7), every
   sparse product one launch of the segment kernel (csrc/sparse_glm.cu:
   row groups for matvec, a key walk over int32 keys for rmatvec and
   sq_rmatvec):
   (a) the kernel against its float64 plain version for all six products
   (ELL and COO matvec, rmatvec, sq_rmatvec), f32 and bf16 values, at
   bench.py's sparse shape (n=200,000, d=10,000,000, 32 entries a row) and a
   small ragged one (a full column, an empty column, empty rows, repeated
   pairs): max-abs error <= 3e-5 * max(|ref|, 1), and two launches give the
   same bits; (b) bench.py's sparse configuration at that shape through
   RawDataset.to_batch (COO, then ELL) and GLMProblem.run (logistic,
   L-BFGS tol 1e-9, 20 iterations, L2 1.0): the segment kernel's launches
   counted from 0 (the plain and dense counters must stay 0), two runs with
   the same bits, held against the plain route on the card by loss at
   rtol 1e-5, examples * iterations / s printed, each batch's companion
   bytes (the segments' tensors beyond the layout's own arrays) printed,
   and one more solve under torch.profiler (device time by kernel name,
   the segment kernel's time per launch inside the solve, the card's busy
   share of the solve's wall); then one OWL-QN solve (L1
   1.0, SIMPLE variance) on COO, its nonzeros printed, its loss held the
   same way and its variances at rtol 1e-3; (c) phase 5's
   sweep with its global shard sparse (n=500,000 rows of 32 entries over
   d=10,000,000, build_fixed_effect_dataset(layout="auto") picks ELL; FE
   TRON + SIMPLE variance, RE phase 5's), a warm-up and three timed sweeps
   with the counters at 0 before them, held against the plain route on the
   card at phase 5's bounds. Phase 7 then times each product at the sparse
   shape beside its bound (segment_bytes: entries, source and output once;
   the design's own bytes and a sector per gather beside), also replayed
   from a CUDA graph, its plain version, index_add_ and a cuSPARSE CSR SpMV
   (torch.mv on a sparse CSR tensor) (the earlier design,
   csrc/sparse_glm_warp.cu, is timed by --only variants alone);
10. the solvers (run after phase 6, before phase 9), every launch counter at
   0 before each part: (a) phase 5's data and coordinates with the fixed
   effect's variance FULL (B1 and B2 launch, B3 must not) and the random
   effect solved by the packed batched TRON (tol 1e-6, 30 iterations, 20
   CG steps), a warm-up and three timed sweeps printed beside phase 5's
   (wall, examples/s, shares, RE syncs per size bucket for TRON and phase
   5's L-BFGS); the seconds of hessian_matrix and of _diag_of_inverse at
   n x d; the FULL variances against a float64 Hessian built in this
   script (rtol 1e-3); the sweep against the plain route at phase 5's
   bounds; then one fixed-effect solve with down-sampling rate 0.5 (the
   keep mask drawn on the card from --seed; variance NONE) against its
   plain route by loss (rtol 1e-5); (b) bench.py's bench_billion_coef slice
   (32,768 entities x 16 rows x 256 columns, f32, logistic, L2 1.0, tol
   1e-6, 30 iterations), L-BFGS then TRON, each through the packed and the
   vmapped (entity-leading, per-lane history) solves, timed, held per
   entity at the packed bounds (coefficients atol 5e-3, loss atol 1e-4),
   V1's launches counted from 0 over each vmapped solve of the whole slice
   (both axes must launch); the vmapped solve of the first 4,096 entities
   alone, of entity 0 alone and of entities 1,000-1,010 against the same
   entities within the slice, bit for bit (a differing bit fails the
   phase); V1's call forms over those small stacks against the whole
   slice through torch.sum and through V1 (the elements whose bits differ
   printed; V1's must be none); V1 timed at the slice shape beside its
   bound, torch.sum of the product and torch.bmm; (c)
   compute_variances("FULL"), the Hessian's build included, on 4,096
   random logistic rows at d = 16,384, 32,768 and 65,536, float32 and
   float64: seconds and peak device memory, float32 against float64 at
   rtol 1e-3; the port's MAX_FULL_VARIANCE_DIM must be the largest d
   measured here, and one column more must raise;
11. data and model IO (run after phase 10, before phase 9; phase 5 first):
   (a) the port's Avro writer, in worker processes (started beside phase
   2's build since PR 19, so their start is not timed), writes 200,000 training
   and 50,000 validation rows (8 + 2 deflate parts, 32 nonzeros a row drawn
   from 1,023 named features, values N(0, 1), logistic labels from a
   seeded model; 8,000,000 feature entries) into a temporary directory,
   timed; (b) read_avro_dataset_chunked over the training parts with the
   native decoder at 1 and 4 workers, and the Python codec and the native
   decoder on one part: rows/s each, the parts each engine decoded (the
   native library must have built and decoded every part), the results
   bitwise alike (across engines after sorting the entries by row and
   column); (c) cli.glm.run_models on the card (TRON, STANDARDIZATION,
   SIMPLE variance, L2 over 0.1|1|10, AUC on the validation parts; the
   dense 200,000 x 1,024 f32 batch) with every counter at 0 before it:
   each stage's wall, the launches of B1, B2 and B3 with its shift terms
   (each must be above 0); each lambda's loss against the same grid
   through the plain versions on the card (GLMProblem.run(plain=True), the
   same batch, normalization and warm starts) at rtol 1e-5 and the
   validation AUC within 1e-4; every saved Avro model reloaded through
   load_glm bitwise equal to the trained coefficients and variances; (d)
   phase 5's GLMix model with synthetic index maps through save_game_model
   and load_game_model: coefficients bitwise, scores on phase 5's batch
   equal, save and load seconds;
12. the GAME driver (run after phase 11; phase 5 first): (a) worker
   processes write phase 11's fixture with a userId over 20,000 users drawn
   Zipf(1.1) (build_data's assignment) in metadataMap and the user's 31
   named features in a userFeatures bag (d_re = 32 with the intercept),
   logistic labels from both effects (and, in the same pool, phase 14's
   day 3); (b) cli.train.run on the card
   (global: TRON tol 1e-6, 10 iterations, L2 1.0, SIMPLE variance,
   STANDARDIZATION; per-user: L-BFGS tol 1e-6, 30 iterations, L2 1.0,
   active cap 256; 2 sweeps; AUC on the validation parts; a boundary
   checkpoint every update) with every counter at 0 before it: the stage
   walls, the launches (B1, B2, B3 with shifts and S1's ELL matvec each
   above 0), the checkpoints' count, bytes and seconds from the run's
   registry, the validation AUC; then the same fit in process, its best
   model bitwise the driver's saved one, and through the plain versions on
   the card: FE coefficients and variances rtol 1e-3 / atol 1e-5, the
   second sweep's RE on identical residuals (coefficients atol 5e-3, loss
   atol 1e-4), AUC within 1e-4; (c) the run killed at cd.boundary_saved
   after the first sweep's second boundary and resumed: the saved models
   bitwise (b)'s; (d) cli.score.run on the validation parts with (b)'s best
   model: bitwise GameTransformer's, rtol 1e-5 of the plain route, AUC
   within 1e-4 of (b)'s, one S1 launch, rows/s; (e) a
   coordinate.scores:nan:1 run: the poisoned update rejected, the models
   finite, photon_coordinate_rejections_total above 0, one flight-recorder
   dump under its metrics directory, listed by cli.report; (f) (b)'s fit
   without checkpoints and with every telemetry flag on (--metrics-out,
   --trace-out, --status-port, --report-out), cli.train.run on a thread
   while /statusz, /metrics and /healthz are polled: at least one 200 from
   /statusz and /metrics, B1, B2, B3 with shifts and S1 launched as often
   as in (b), the best model bitwise (b)'s, run_summary.json's timeline one
   entry a sweep with critical_path + other == wall (rel 1e-6), the Chrome
   trace one complete event per closed span and one cd.sweep a sweep, the
   card's peak allocator bytes (photon_mem_device_peak_bytes_in_use
   {device="cuda:N"}) in (0, total memory), report.json rebuilt byte for
   byte by `python -m photon_ml_tpu_torch.cli.report`, no flight dump; its
   wall beside (b)'s, the report build's seconds and the per-sweep phase
   attribution beside phase 5's profiled busy share.

13. hyperparameter tuning (run after phase 12, on its fixture; phase 5
   first): (a) S2, the lane-wide segment kernel (matmat and rmatmat), at
   phase 9's sparse shape, COO and ELL, L = 1, 4, 7, 8, 16 and 40 (7: a
   tail sub-chunk; 40: past the panel of 16 columns; L = 3 cut to make room
   for phase 18): against its float64
   plain version (max-abs <= 3e-5 * max(|ref|, 1)), each column bitwise
   S1's, two launches alike; at L = 4 and 16 timed by CUDA events (one
   round of turns; two rounds at every width before phase 18 joined the
   run's time limit) and from a CUDA graph beside its byte bound (the
   distinct gathered source rows counted),
   L x S1, the index_add_ composition and cuSPARSE's SpMM; (b) lambda-lane sweeps in process on phase 5's data
   (bench.py's sweep protocol: L-BFGS tol 1e-7, 50 iterations, 2 sweeps,
   variance NONE): K = 4 lanes against K sequential fits (walls; K = 8,
   timed only, was cut to make room for phase 18, K = 1 for phase 18 (e)
   and (f); each lane: its FE
   coefficients atol 5e-3 and training AUC within 1e-4 of its sequential
   fit's; its RE on identical residuals in float64 atol
   5e-3, the f32 pair and the chained difference printed), the RE lane
   solve's wall and peak memory, and the K = 4 sweep's synchronizing
   operations under the sync debug mode (beyond the solvers' own fetches
   fewer than one a lane an update); (c) phase 9's sparse configuration
   through GLMProblem.run_lanes with 4 L2 weights on ELL and COO, S2's
   launches counted from 0 (each product above 0), each lane against its
   single-lane solve (loss rtol 1e-5; coefficients atol 5e-3 in float64,
   the f32 gaps printed), then, on COO (ELL's cut to make room for phase
   18 (e) and (f)), warm and profiled, the 8-lane solve of bench.py's
   protocol lambdas (S2's device ms, launches and share of the busy time
   beside the top operations; the 4-lane solve's and its 4 singles'
   breakdowns cut to make room for (b)'s four held lanes); (d)
   cli.train on phase 12's fixture:
   RANDOM --trial-lanes 3 with 3 trials, variance and normalization NONE
   (1 batch timed, 3 trials counted, the tuned model reloaded bitwise, the
   prior file with 4 records; 4 lanes and trials until phase 18 (e) and (f),
   8 trials before phase 18 joined the run's time limit; a sequential
   BAYESIAN run beside it until phase 17 (f) did); (e) that lane run with
   --checkpoint-dir, killed by tuning.trial at the second lane and resumed
   (the other two lanes as a batch of 2): candidates bitwise (d)'s, AUC
   within 1e-4.
14. the retrain chain (run after phase 13, on phase 12's fixture): the
   feed laid out as three days under <feed>/2026/01/01..03 (days 1 and 2
   link phase 12's training parts 0-3 and 4-7; day 3 holds new rows of the
   even-numbered half of the 20,000 users, written with phase 12's), the
   feature index built by cli.index and pinned; (a) cli.retrain on the card
   (per-user first: phase 12's L-BFGS with active cap 256; then global:
   phase 12's TRON + SIMPLE + STANDARDIZATION; both regularize-by-prior
   from day 2; 2 sweeps a day; the gate AUC,AUC:userId with margin RETRAIN_MARGIN; a
   serving root; a boundary checkpoint every update) with every counter at
   0 before it and read at each day's gate decision: per-day launches (B1,
   B2, B3 with shifts and S1 each above 0 over the run), day and stage
   walls (read, train, merge, gate, save, publish), every day accepted;
   days 1 and 3 (the first day, and the last with its prior and its
   untouched users; day 2's replay was cut to make room for phase 18)
   replayed from their boundary checkpoints on identical inputs: the
   fixed effect's first update through the kernels (bitwise the chain's)
   against the plain versions (means and variances rtol 1e-3 / atol 1e-5),
   the random effect's last update in f32 (bitwise the chain's) against
   float64 on the widened blocks (atol 5e-3); --status-port on, /healthz
   polled from another thread: at least one 200 during the chain; (b) the
   odd-numbered users
   after day 3's merge bitwise their day-2 rows; (c) the live snapshot
   reopened with open_current, its arrays bitwise the accepted model's; (d)
   day 3 with its labels flipped against day 2's model in a second serving
   root: refused, counted, CURRENT still day 2's; (e)
   PHOTON_FAULTS=retrain.publish:io:2,retrain.day:kill:3: CURRENT stays day
   1's, then the resumed run repairs the publish and ends with (a)'s ledger
   bit for bit and day 3 live.
15. resident serving (bench.py _serving_workload's configuration made in
   the port from --seed: d_fixed 1,024, 20,000 users with d_re 32 and
   support 8, 4,096 requests of 16 + 4 nonzeros, 20% from unseen users),
   published into a serving root: (a) ModelStore -> ScoreEngine.from_store
   on the card -> warm(); at rungs 1, 8, 64, 256 and 4,096 every score
   against the plain route and a float64 numpy oracle (max-abs error <=
   3e-5 * max(|ref|, 1)), cold starts equal to the unseen requests, one S1
   launch a batch; the resident path against the batch path at the rung's
   width (bitwise) and padded to width 64; per rung a batch's ms split into
   host assembly, upload + device (CUDA events) and fetch, and S1 alone
   beside its plain version, cuSPARSE's SpMV and its bound; the
   one-request-at-a-time rate; (b) bench_serving's protocol through
   ScoringServer: 8 closed-loop clients for 3 s, max_batch 256,
   max_latency 2 ms (scores/s, p50 and p99 from the server's latency
   histogram, mean batch), with (c) a second snapshot (fixed effect
   shifted) published and flipped mid-stream: nothing lost or failed, every
   response before the flip v1's and after it v2's; (d) the open-loop knee
   (a capacity probe, then Poisson arrivals at 0.5, 1 and 1.5 times it for
   1 s each, 100 ms budgets; counted sheds equal to observed); S1's
   launches counted from 0 over (b)-(d); (e) two `python -m
   photon_ml_tpu_torch.cli.serve --listen --status-port` replicas:
   /healthz 200, /metrics with the request counter; `python -m
   photon_ml_tpu_torch.cli.fleetz` over their status ports (the merged
   request counter the sum of the replicas' own, bit for bit) and in
   artifacts mode over phase 12 (b)'s and (f)'s metrics directories (every
   merged counter the sum of the two runs', as rendered); then open-loop load
   through a LeastLoadedFront over both with replica 0 killed mid-stream:
   every request answered or shed with a type.
16. out-of-core training (run right after phase 12, on its fixture; phase 5
   first), at phase 5's full width with its X (2.05 GB) in page-locked host
   memory: (a) the streamed objective under a 256 MiB budget (16 slices of
   32,768 rows) against the resident one at w = 0 and at the resident
   solve's w (value rtol 2e-6; gradient and Hv max-abs <= 3e-5 * max(|ref|,
   1), the gradient at the solution held against the float64 plain version
   no further than the resident kernel's), two passes bitwise alike, each
   slice's slot row against its plain version, B1 / B2 launched slices x
   passes and the sum once a pass, a pass's wall and copy rate beside a 1
   GiB pinned copy_'s; (b) the streamed TRON solve at depth 1 and 2
   against the resident solve (rtol 1e-3 / atol 1e-5; launches, staged
   bytes, overlap ratio, the solve's peak allocator bytes, two slices
   within the budget), then an L-BFGS solve over ELL slices at phase 9's
   shape through S1 against the resident ELL solve (loss rtol 1e-5); (c)
   the random effect in entity slices, its largest size bucket cut into 5:
   the vmapped solve bitwise the in-memory one (V1 launched on both axes),
   the packed one at the packed bound; (d) a two-sweep fit over both
   streamed coordinates at depth 1 and 2, models and ledger bitwise alike,
   the evaluations on the lane's thread; (e) cli.train on phase 12's
   fixture with hbm.budget.mb=224 on both coordinates and --pipeline-depth
   2: the best model against (b)'s of phase 12 at the solve bounds, the
   report's streaming block filled.
17. distributed (run after phase 16, on phase 12's fixture and against its
   (b)): (a) two `cli.train --distributed coordinator=127.0.0.1:PORT,
   process=I,n=2` ranks sharing the card over gloo, each reading its
   100,000 rows (the index of phase 12 (b) pinned), a two-phase boundary
   checkpoint every update, --metrics-out: each rank's launches of B1, B2,
   B3 with shifts, B4 and the rank-order sum above 0, its walls and its
   photon_re_build_* series; the coordinator's best model against phase 12
   (b)'s (FE coefficients and variances rtol 1e-3 / atol 1e-5; the RE
   retrained on one card from the two-rank run's last residual and warm
   start, atol 5e-3, per-entity loss atol 1e-4; the chained difference
   printed; validation AUC within 2e-3); each rank's normalization inputs
   bitwise alike; (b) the kill-a-worker drill: rank 1 killed at its second
   sweep boundary (dist.collective:kill:2), --collective-timeout 10,
   heartbeats every 0.5 s stale after 3 s: rank 0 exits non-zero with a
   typed error naming process 1 within 15 s of the kill and a peer_lost
   dump; both ranks resume and the final model equals (a)'s within 1e-9,
   its differing bits printed; (c) cli.score --distributed on two ranks
   over the validation parts with (a)'s model against the one-process
   scores of that model (rtol 1e-5, bitwise rows counted, AUC within 1e-4),
   S1 launched on each rank; (d) cli.fleetz over (a)'s two streams, every
   merged counter the ranks' sum; (e) one rank over NCCL, beside (c) and
   (d): the saved models bitwise phase 12 (b)'s; (f) beside (b)'s resume
   and (c)-(e), out of core across processes: two gloo ranks through phase 16 (e)'s argv
   (hbm.budget.mb=224 on both coordinates, variance NONE, --pipeline-depth
   2), a boundary checkpoint every update: both coordinates stream on each
   rank (the plan, and each rank's photon_stream_slices_total per site),
   each rank's B1 + B2 launches its slices x passes and one rank-order sum
   a pass (over both ranks' slot rows), S1 and its stage walls printed, the
   two ranks' best models bitwise alike; the coordinator's model against
   phase 12 (b)'s (FE rtol 1e-3 / atol 1e-5, the RE retrained on one card
   from the two-rank run's last residual atol 5e-3, per-entity loss atol
   1e-4, validation AUC within 2e-3); (g) beside (f), one NCCL rank through
   the same argv: its saved models bitwise phase 16 (e)'s.
18. the (data x model)-tiled fixed effect (run after phase 17, on phase
   12's fixture and its (b)'s coordinates) on a 2 x 2 grid of 4 gloo ranks
   sharing the card (parallel.spawn; NCCL refuses two ranks of one
   communicator on one card), every counter at 0 before each part: (a)
   phase 9's sparse data (n=200,000, d=10,000,000, 32 entries a row), each
   rank its 100,000 x 5,000,000 tile: matvec, rmatvec and sq_rmatvec
   against float64 plain products of the whole batch (max-abs <= 3e-5 *
   max(|ref|, 1)), the ranks of a data row bitwise alike in z and of a
   model column in their gradient slices, one S1 launch a product and one
   rank-order sum, no dense kernel; (b) phase 9's L-BFGS solve as
   GLMProblem.run on the tiled batch, twice (the same bits), against the
   one-card COO solve by loss (rtol 1e-5), every rank with the same
   iterations, reason, loss and model bits, its slice bitwise within its
   model column, the route tiled_kernel; per rank its wall, collectives by
   subgroup and their seconds, launches and the allocator's peak; then
   bench.py's tiled measure printed (S1's value+grad on one card at the
   whole nnz against the (2 x 4) tile (0, 0)'s share); (c) FULL variances
   on tiles at d = 8,191 (padded to 8,192: one pinned column, its variance
   1 / (1 + l2)), 24,576 rows in three chunks a data row, against the
   one-card dense FULL path (rtol 1e-3), every rank bitwise alike; (d)
   cli.train --distributed --mesh-shape data=2,model=2 with phase 12 (b)'s
   options, the fixed effect tiled (TRON, SIMPLE variance,
   STANDARDIZATION) and (f)'s dense fixed effect, every update a boundary
   checkpoint, beside the one-process cli.train on a 1 x 1 grid, in four
   cases whose grids start together: the dense fixed effect after and
   before the random effect, each in float32 (the kernels) and in float64
   (the plain versions on the card); in every case the fixed effects'
   variances rtol 1e-3 / atol 1e-5, AUC within 1e-4, the saved fixed
   effect of the shard's true dimension; the tiled fixed effect (ROADMAP
   C4 (e)): in float64 its chained means against the one process and its
   last update against one card's (phase 12 (b)'s global coordinate
   widened to float64) on the very residual the grid's rank 0 was handed,
   both rtol 1e-3 / atol 1e-5; in float32 the same gaps printed, with the
   one-card update in float32 and float64, the residual rebuilt from the
   boundary and both solves' loss histories; in float32 the random
   effect's last update retrained on one card from the grid's boundary
   before it (atol 5e-3, per-entity loss atol 1e-4), every rank on the
   tiled route with S1 and the sum launched;
   then a resume of the first case on data=2,model=1 refused on every rank
   in the JAX package's words; (e) the dense feature-axis shard in
   (a)-(c)'s ranks: phase 5's X (bench.py's build_data, n=500,000, d=1,024, f32; made anew
   without phase 5) written once to a .npy each rank memory-maps,
   shard_batch(shard_features_dim=True) cutting a 250,000 x 512 tile a
   rank onto the card, phase 5's fixed-effect TRON + SIMPLE solve through
   GLMProblem.run on the tiles (torch.mv on the tile, the rank-order sum
   over each subgroup, route tiled_dense, no B1-B4) against the same solve
   on one card through B1, B2 and B3 from the same w0 (coefficients and
   variances rtol 1e-3 / atol 1e-5), every rank with the same iterations,
   reason, loss and model bits; per rank the solve's wall, its collectives
   and their seconds by subgroup, its launches; (f) (d)'s runs' dense fixed
   effect (userShard, TRON, SIMPLE, STANDARDIZATION): on the grid it is
   each data row's rows replicated over the model axis (B1-B3 through B4
   over each model column), held against the one process at rtol 1e-3 /
   atol 1e-5 in each case, the grid's four best-model digests equal, each
   rank's B1-B3, B4 and sum launches printed.

    python3 chip_smoke.py --only timing    # card, build, then one phase

runs a subset of phases 3-18 (check, fe, glmix, dp, nccl, solvers, io, game, streaming, tuning, s2,
sparse, timing, variants, retrain, serving, distributed, tiled) and then reports not ok; "streaming" runs phase 5,
writes phase 12's fixture and runs its (b) before phase 16; "distributed" and "tiled" write phase 12's fixture
and run its (b) before phases 17 and 18 ("distributed" runs phase 16 (e) too, 17 (g)'s reference); "s2" is phase 13 (a) alone; "solvers", "io", "game" and "tuning" run phase 5 first ("game" and
"tuning" write phase 12's fixture first); "retrain" writes phase 12's
fixture and runs phase 14; "nccl" is phase 6 (c) alone after
phase 5 (for a machine with several cards: one NCCL rank per card).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when there is no card or no port to run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import re
import sys
import time
import traceback
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, per dtype
REPLACES = {
    "fused_value_grad": "photon_ml_tpu/ops/pallas_glm.py:165",
    "fused_hessian_vector": "photon_ml_tpu/ops/pallas_glm.py:203",
    "fused_hessian_stats": "photon_ml_tpu/ops/pallas_glm.py:238",
    "sharded_value_grad": "photon_ml_tpu/ops/pallas_glm.py:361",
    "sharded_hessian_vector": "photon_ml_tpu/ops/pallas_glm.py:390",
    "sharded_hessian_stats": "photon_ml_tpu/ops/pallas_glm.py:517",
    "rank_order_sum": "photon_ml_tpu/ops/pallas_glm.py:345",
}
KERNELS = tuple(REPLACES)
# the segment kernel replaces the JAX package's XLA gathers and scatter-adds
# (no Pallas kernel); by the product that each of its lines times
SPARSE_REPLACES = {
    "matvec": "photon_ml_tpu/ops/features.py:103",
    "rmatvec": "photon_ml_tpu/ops/features.py:130",
    "sq_rmatvec": "photon_ml_tpu/ops/features.py:160",
    "matmat": "photon_ml_tpu/ops/features.py:112",
    "rmatmat": "photon_ml_tpu/ops/features.py:144",
}
DESIGN = {
    "fused_value_grad": "ring: a producer warp keeps row tiles in flight by cp.async.bulk on mbarriers "
                        "(2 stages per consumer warp; 7 consumer warps, 16 KB tiles for f32, 11 and 8 KB "
                        "for bf16), a consumer warp takes 4 rows at a time with the coefficients in double "
                        "in registers and its column partials in registers; tree finalize",
    "fused_hessian_vector": "ring, as fused_value_grad; v in double in registers (f32) or in shared "
                            "memory (bf16); tree finalize",
    "fused_hessian_stats": "staged: 16-byte loads into shared tiles, a warp per row, a thread per "
                           "column; tree finalize",
    "rank_order_sum": "one thread per column adds the [world, width] float64 slot rows in rank order "
                      "in double and writes f32; no atomics",
    "segment_dot": "matvec: row groups of 4-32 lanes a segment (8 at 32 entries a row), each lane 4 "
                   "consecutive entries a pass by 16-byte loads, all its gathers issued before its first add, a "
                   "butterfly over the group; rmatvec and sq_rmatvec (and matvec with a row over 512 entries): "
                   "a key walk over int32 keys with no per-column pointer, a warp a tile of 256 entries, 8 a "
                   "lane, runs of equal keys added in entry order, a segmented scan over the lanes, float64 "
                   "carries for keys that cross tiles added in tile order by a second small kernel, each tile's "
                   "outputs (empty columns as zeros) staged in shared memory and stored coalesced; entries "
                   "streamed with evict-first loads; double sums, each output written once; no atomics",
    "segment_dot_lanes": "S1's row groups and key walk over panels of up to 16 columns (one pass over the entries "
                         "a panel; wider L in panels of 16, then the rest), a thread's entries loaded once and its "
                         "columns walked in sub-chunks of 4 (float4 gathers along the source row), each column by "
                         "S1's operations in S1's order (the same partition over lanes, fused multiply-adds, "
                         "butterfly, scan and tile joins), so column l is S1 on column l bit for bit; output rows "
                         "written whole: the row group's lanes share out the panel's sums, the key walk stages its "
                         "closed runs' sums in shared memory and stores the tile's rows contiguously, empty rows as "
                         "zeros; double sums, each output written once; no atomics",
}
PREV_SEGMENT_DESIGN = (
    "a warp per 32 consecutive segments over int64 pointers: a segment of at most 4 entries summed by its lane, "
    "a longer one by the whole warp; segments of more than 4,096 entries cut into chunks, a warp each, added "
    "by a second kernel (csrc/sparse_glm_warp.cu)")
B4_DESIGN = ("the rank's B1-B3 with its tree finalize writing the f32 totals widened to float64 into the "
             "rank's row of the group's cached [world, width] slot buffer; one in-place all-gather (NCCL: "
             "on the card in stream order, timed by CUDA events, no host synchronize; gloo: staged through "
             "a host buffer); the rank_order_sum kernel into the f32 outputs")
# B4's per-rank compute is B1-B3 (csrc/fused_glm.cu); its wrappers and the
# rank-order sum live in ops/fused_glm.py
SOURCES = {
    name: "photon_ml_tpu_torch/ops/fused_glm.py" if name.startswith("sharded_")
    else "photon_ml_tpu_torch/csrc/fused_glm.cu"
    for name in KERNELS
}
SUM_WORLDS = (1, 2, 4, 8)  # worlds of phase 3's rank-order sum check
# B4 name -> the one-rank kernel each rank runs (B1-B3)
B4_OF = {
    "sharded_value_grad": "fused_value_grad",
    "sharded_hessian_vector": "fused_hessian_vector",
    "sharded_hessian_stats": "fused_hessian_stats",
}
SWEEPS = 3  # timed GLMix sweeps; launches are counted over all of them
DP_RANKS = 4  # gloo ranks sharing the card in phase 6 (a) and (b)
DP_TIMEOUT_S = 300.0  # each spawn of phase 6, start to join


def log(*parts) -> None:
    print(*parts, flush=True)


class Phases:
    def __init__(self) -> None:
        self.failed = []

    def run(self, name, fn, *args):
        log(f"== phase: {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a failed phase is reported and the script goes on
            traceback.print_exc()
            self.failed.append(name)
            log(f"== phase {name}: FAILED after {time.perf_counter() - t0:.1f}s")
            return None
        log(f"== phase {name}: ok in {time.perf_counter() - t0:.1f}s")
        return out


def card(torch):
    from photon_ml_tpu_torch.device import nvidia_smi_identity

    out = nvidia_smi_identity()
    if not out:
        raise RuntimeError("nvidia-smi did not report the card's name and power limit")
    log(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return out


def build():
    from photon_ml_tpu_torch.ops import cuda_lib

    names = cuda_lib.all_sources()
    t0 = time.perf_counter()
    logs = cuda_lib.build(names)
    log(f"built {list(names)} in {time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "error", "warning")):
                log(f"  [{name}] {line.strip()}")
    return logs


def make_inputs(torch, gen, n, d, loss_name, xdt, dev):
    x = torch.randn((n, d), generator=gen, device=dev).to(xdt)
    coef = torch.randn(d, generator=gen, device=dev) * (0.5 / math.sqrt(d))
    v = torch.randn(d, generator=gen, device=dev)
    y = (torch.rand(n, generator=gen, device=dev) > 0.5).float()
    if loss_name == "poisson":
        y = y * 2
    off = torch.randn(n, generator=gen, device=dev) * 0.1
    wt = torch.rand(n, generator=gen, device=dev) + 0.5
    vshift = torch.randn((), generator=gen, device=dev) * 0.1
    return x, coef, v, y, off, wt, vshift


def errors(torch, inputs, loss):
    """Kernel against the float64 plain version on the same inputs: returns
    (value rel err, grad max-abs err, grad bound, Hv max-abs err, Hv bound)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    x, coef, v, y, off, wt, vshift = inputs
    val, grad, wdz = fg.fused_value_grad(x, coef, y, off, wt, loss)
    hv, csum = fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)
    torch.cuda.synchronize()
    f64 = torch.float64
    rval, rgrad, rwdz = fg.value_grad_plain(x, coef, y, off, wt, loss, compute_dtype=f64)
    rhv, rcsum = fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss, compute_dtype=f64)

    def vec_err(got, ref):
        got = got.to(f64)
        return float((got - ref).abs().max()), 3e-5 * max(float(ref.abs().max()), 1.0)

    g_err, g_bound = vec_err(torch.cat([grad, wdz.reshape(1)]), torch.cat([rgrad, rwdz.reshape(1)]))
    h_err, h_bound = vec_err(torch.cat([hv, csum.reshape(1)]), torch.cat([rhv, rcsum.reshape(1)]))
    v_rel = abs(float(val) - float(rval)) / max(abs(float(rval)), 1e-30)
    finite = all(bool(torch.isfinite(t).all()) for t in (val, grad, wdz, hv, csum))
    return v_rel, g_err, g_bound, h_err, h_bound, finite, float(grad.sub(rgrad).abs().max()), float(hv.sub(rhv).abs().max())


def stats_errors(torch, inputs, loss, need_shifts):
    """B3 against its float64 plain version: returns (s2/s1 max-abs err,
    bound, s0 rel err, finite, s2 max-abs err)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    x, coef, _, y, off, wt, _ = inputs
    s2, s1, s0 = fg.fused_hessian_stats(x, coef, y, off, wt, loss, need_shifts)
    torch.cuda.synchronize()
    r2, r1, r0 = fg.hessian_stats_plain(x, coef, y, off, wt, loss, need_shifts, compute_dtype=torch.float64)
    got, ref = s2.double(), r2
    if need_shifts:
        got, ref = torch.cat([s2.double(), s1.double()]), torch.cat([r2, r1])
    err = float((got - ref).abs().max())
    bound = 3e-5 * max(float(ref.abs().max()), 1.0)
    s0_rel = abs(float(s0) - float(r0)) / max(abs(float(r0)), 1e-30) if need_shifts else 0.0
    finite = bool(torch.isfinite(s2).all()) and (not need_shifts or bool(torch.isfinite(s1).all()))
    return err, bound, s0_rel, finite, float((s2.double() - r2).abs().max())


def check_kernels(torch, n_full, d_full, seed):
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    cases = []
    for n, d in ((4096, 1024), (4099, 1024), (4101, 203), (n_full, d_full), (n_full - 1, d_full)):
        for xname in ("float32", "bfloat16"):
            for loss_name in ("logistic", "squared", "poisson", "smoothed_hinge"):
                cases.append((n, d, xname, loss_name))
    bad = []
    main_errs = {}
    for i, (n, d, xname, loss_name) in enumerate(cases):
        gen.manual_seed(seed * 1000 + i)
        inputs = make_inputs(torch, gen, n, d, loss_name, getattr(torch, xname), dev)
        v_rel, g_err, g_bound, h_err, h_bound, finite, g_abs, h_abs = errors(torch, inputs, LOSSES[loss_name])
        ok = finite and v_rel <= 2e-6 and g_err <= g_bound and h_err <= h_bound
        log(f"  check n={n} d={d} {xname:8s} {loss_name:14s} value_rel={v_rel:.2e} "
            f"grad_err={g_err:.3e}/{g_bound:.3e} hv_err={h_err:.3e}/{h_bound:.3e} "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            bad.append((n, d, xname, loss_name))
        if (n, d, xname, loss_name) == (n_full, d_full, "float32", "logistic"):
            main_errs = {"fused_value_grad": g_abs, "fused_hessian_vector": h_abs}
        for need_shifts in (False, True):
            err, bound, s0_rel, finite, s2_abs = stats_errors(torch, inputs, LOSSES[loss_name], need_shifts)
            ok = finite and err <= bound and s0_rel <= 2e-6
            log(f"  check n={n} d={d} {xname:8s} {loss_name:14s} hessian_stats shifts={int(need_shifts)} "
                f"s2s1_err={err:.3e}/{bound:.3e} s0_rel={s0_rel:.2e} {'ok' if ok else 'MISS'}")
            if not ok:
                bad.append((n, d, xname, loss_name, "stats", need_shifts))
            # the main path's fixed effect has no normalization: no shifts
            if (n, d, xname, loss_name, need_shifts) == (n_full, d_full, "float32", "logistic", False):
                main_errs["fused_hessian_stats"] = s2_abs
        del inputs
        torch.cuda.empty_cache()
    main_errs["rank_order_sum"], parts_bad = check_b4_parts(torch, gen, n_full, d_full, seed)
    bad += parts_bad
    lane_errs, lane_bad = check_lane_reduce(torch, seed)
    main_errs.update({f"lane_reduce:{k}": v for k, v in lane_errs.items()})
    bad += lane_bad
    if bad:
        raise AssertionError(f"kernels disagree with the float64 plain version on {bad}")
    return main_errs


def check_b4_parts(torch, gen, n, d, seed):
    """B4's two new parts on the card. The rank-order sum kernel against its
    plain version, bitwise, on random float64 slots of wide magnitudes
    (worlds SUM_WORLDS, the main path's output widths and the FULL
    Hessian's d x d); the finalize's slot
    form against the f32 output widened, bitwise, for B1-B3 at n x d f32.
    Returns (the sum's max-abs error, the cases that missed)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    bad, err = [], 0.0
    saved = dict(fg.SUM_LAUNCHES)
    widths = [fg._out_width(m, d) for m in (fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS)] + [d * d]
    for world in SUM_WORLDS:
        for mode, width in enumerate(widths):
            gen.manual_seed(seed * 131 + world * 7 + mode)
            scale = 10.0 ** torch.randint(-8, 9, (world, width), generator=gen, device=dev).double()
            slots = torch.randn((world, width), generator=gen, device=dev, dtype=torch.float64) * scale
            got = fg.rank_order_sum(slots, torch.float32)
            want = fg.rank_order_sum_plain(slots, torch.float32)
            same = _same_bits(got, want)
            err = max(err, float((got.double() - want.double()).abs().max()))
            if not same:
                bad.append(("rank_order_sum", world, width))
    fg.SUM_LAUNCHES.update(saved)  # checks are not main-path launches
    log(f"  check rank_order_sum kernel vs plain, worlds {SUM_WORLDS}, widths {widths} (the last: FULL's "
        f"d x d over ranks): bitwise equal "
        f"{not bad} (max abs diff {err:.3e})")
    gen.manual_seed(seed + 11)
    x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", torch.float32, dev)
    saved = dict(fg.ROUTES)
    for mode in (fg.VG, fg.HV, fg.HD, fg.HD_SHIFTS):
        hv = mode == fg.HV
        operands = (x, coef, v if hv else None, y, off, wt, vshift if hv else None, LOSSES["logistic"])
        out = fg._launch(mode, *operands)
        slot = torch.empty(fg._out_width(mode, d), dtype=torch.float64, device=dev)
        fg._launch(mode, *operands, slot=slot)
        same = _same_bits(slot, out.double())
        log(f"  check finalize into the slot, mode {mode}, n={n} d={d} float32: the f32 output "
            f"widened, bitwise: {same}")
        if not same:
            bad.append(("slot finalize", mode))
    fg.ROUTES.update(saved)
    del x
    torch.cuda.empty_cache()
    return err, bad


def bench_data(torch, n, d, seed, dev):
    """bench.py's build_data without the random-effect term: standard-normal
    X with a constant last column, labels from a logistic model."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, d), generator=gen, device=dev)
    x[:, -1] = 1.0
    w = torch.randn(d, generator=gen, device=dev) / math.sqrt(d)
    y = (torch.rand(n, generator=gen, device=dev) < torch.sigmoid(torch.mv(x, w))).float()
    return x, y


def solve(torch, batch, optimizer_cfg, plain=False):
    from photon_ml_tpu_torch.evaluation.device import auc
    from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext

    problem = GLMProblem(
        "logistic_regression",
        GLMOptimizationConfig(
            optimizer=optimizer_cfg, regularization=RegularizationContext("L2"), reg_weight=1.0
        ),
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, res = problem.run(batch, plain=plain)
    scores = model.score(batch)
    a = auc(scores, batch.labels, batch.weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return model, res, scores, float(a), wall


def allclose(a, b, rtol=1e-3, atol=1e-5):
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    worst = float(((a - b).abs() - (atol + rtol * b.abs())).max())
    return worst <= 0.0, float((a - b).abs().max())


def fe_path(torch, n, d, seed):
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType

    dev = torch.device("cuda")
    x, y = bench_data(torch, n, d, seed, dev)
    batch = batch_from_dense(x, y)
    tron = OptimizerConfig(optimizer_type=OptimizerType.TRON, tolerance=1e-6, max_iterations=10)

    # a first, untimed solve loads PyTorch's own lazily loaded kernels
    # (sort, scan, ...) so that neither timed solve pays for it
    solve(torch, batch, tron)
    fg.reset_launch_counts()
    model, res, scores, a, wall = solve(torch, batch, tron)
    launches = dict(fg.LAUNCHES)
    loss = float(res.loss)
    log(f"  TRON kernels: iterations={res.iterations} reason={res.reason} loss={loss:.6f} "
        f"auc={a:.6f} wall_s={wall:.3f} syncs={res.syncs} launches={launches} by body {dict(fg.ROUTES)}")
    problems = []
    if min(launches["fused_value_grad"], launches["fused_hessian_vector"]) <= 0:
        problems.append(f"a kernel of the fixed-effect path was not launched: {launches}")
    if not (math.isfinite(loss) and bool(torch.isfinite(scores).all()) and scores.shape == (n,)):
        problems.append("non-finite loss or scores, or scores of the wrong shape")
    if not (0.5 < a <= 1.0):
        problems.append(f"AUC {a} out of (0.5, 1]")

    fg.reset_launch_counts()
    model_p, res_p, _, a_p, wall_p = solve(torch, batch, tron, plain=True)
    log(f"  TRON plain:   iterations={res_p.iterations} reason={res_p.reason} "
        f"loss={float(res_p.loss):.6f} auc={a_p:.6f} wall_s={wall_p:.3f} launches={dict(fg.LAUNCHES)}")
    if any(fg.LAUNCHES.values()):
        problems.append("the plain solve launched a kernel")
    ok, diff = allclose(model.coefficients.means, model_p.coefficients.means)
    log(f"  kernel vs plain coefficients: max abs diff {diff:.3e} (rtol 1e-3, atol 1e-5) {'ok' if ok else 'MISS'}")
    if not ok:
        problems.append(f"kernel and plain solves disagree (max abs diff {diff:.3e})")

    # a small problem: the card's kernel solve against the CPU's plain solve.
    # Both stop where the f32 loss stops resolving, so the reference is the
    # objective value each reaches (the CPU tests' rtol 1e-5 on the loss).
    from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext

    xs, ys = x[:4096, :64].contiguous(), y[:4096]
    _, r_card, *_ = solve(torch, batch_from_dense(xs, ys), tron)
    _, r_cpu = GLMProblem(
        "logistic_regression",
        GLMOptimizationConfig(optimizer=tron, regularization=RegularizationContext("L2"), reg_weight=1.0),
    ).run(batch_from_dense(xs.cpu(), ys.cpu(), device="cpu"))
    l_card, l_cpu = float(r_card.loss), float(r_cpu.loss)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    ok = rel <= 1e-5
    log(f"  small problem card vs CPU: iterations {r_card.iterations}/{r_cpu.iterations} "
        f"loss {l_card:.6f}/{l_cpu:.6f} rel diff {rel:.2e} (rtol 1e-5) {'ok' if ok else 'MISS'}")
    if not ok:
        problems.append(f"card and CPU solves of a small problem reach different losses ({rel:.2e})")

    fg.reset_launch_counts()
    _, res_l, scores_l, a_l, wall_l = solve(torch, batch, OptimizerConfig())
    log(f"  L-BFGS kernels: iterations={res_l.iterations} reason={res_l.reason} "
        f"loss={float(res_l.loss):.6f} auc={a_l:.6f} wall_s={wall_l:.3f} syncs={res_l.syncs} "
        f"launches={dict(fg.LAUNCHES)}")
    if fg.LAUNCHES["fused_value_grad"] <= 0 or not math.isfinite(float(res_l.loss)):
        problems.append("the L-BFGS solve did not run through fused_value_grad or diverged")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches


def build_data(n=500_000, d_fixed=1024, n_users=20_000, d_re=32, seed=0):
    """bench.py's build_data, copied: dense global features with a constant
    last column, Zipf(1.1)-skewed user assignment, per-user features with
    an intercept column, labels from a logistic model of both.

    Returns (gx, y, ex, ids): dense global features, labels, per-user
    features, user ids."""
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((n, d_fixed), dtype=np.float32)
    gx[:, -1] = 1.0
    w = (rng.standard_normal(d_fixed) / np.sqrt(d_fixed)).astype(gx.dtype)
    z = gx @ w
    probs = 1.0 / np.arange(1, n_users + 1) ** 1.1
    probs /= probs.sum()
    assign = rng.choice(n_users, size=n, p=probs)
    ex = rng.standard_normal((n, d_re), dtype=np.float32)
    ex[:, -1] = 1.0
    w_u = (rng.standard_normal((n_users, d_re)) / np.sqrt(d_re)).astype(ex.dtype)
    z = z + np.einsum("nd,nd->n", ex, w_u[assign])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(gx.dtype)
    ids = np.char.add("u", assign.astype(str)).astype(object)
    return gx, y, ex, ids


def glmix_coordinates(data, dev, plain=False, group=None, fe_dataset=None):
    """bench.py's product-path datasets and coordinates on ``dev``: the
    fixed effect batches the dense matrix; the random effect runs the real
    build on a userShard-only RawDataset with active cap 256. With a
    ``group``, the fixed effect's batch is this rank's rows (read from
    ``gx``, which may be memory-mapped) and the random effect keeps the
    rank's entity range. ``fe_dataset`` replaces the dense fixed effect
    (the sparse phase's)."""
    from photon_ml_tpu_torch.game import (
        FixedEffectCoordinate, FixedEffectDataset, GLMOptimizationConfig,
        RandomEffectCoordinate, build_random_effect_dataset,
    )
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType
    from photon_ml_tpu_torch.parallel import local_batch, row_range, shard_random_effect_dataset

    gx, y, ex, ids = data
    n, d_re = ex.shape
    raw = RawDataset(
        n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
        shard_coo={"userShard": (
            np.repeat(np.arange(n), d_re), np.tile(np.arange(d_re), n),
            ex.reshape(-1).astype(np.float64),
        )},
        shard_dims={"userShard": d_re}, id_tags={"userId": ids},
    )
    reg = dict(regularization=RegularizationContext("L2"), reg_weight=1.0)
    cfg_fe = dense_fe_config()
    cfg_re = GLMOptimizationConfig(optimizer=OptimizerConfig(tolerance=1e-6, max_iterations=30), **reg)
    if fe_dataset is not None:
        fe_ds = fe_dataset
    elif group is None:
        fe_ds = FixedEffectDataset("global", "global", batch=batch_from_dense(gx, y, device=dev))
    else:
        start, stop = row_range(n, group)
        rows = batch_from_dense(np.array(gx[start:stop]), y[start:stop], device=dev)
        fe_ds = FixedEffectDataset("global", "global", batch=local_batch(rows, n, group), true_n_rows=n)
    re_ds = build_random_effect_dataset(
        raw, "per-user", "userShard", "userId", active_cap=256, device=dev,
        pad_entities_to_multiple=1 if group is None else group.world_size,
    )
    if group is not None:
        re_ds = shard_random_effect_dataset(re_ds, group)
    return {
        "global": FixedEffectCoordinate(dataset=fe_ds, task="logistic_regression", config=cfg_fe, plain=plain),
        "per-user": RandomEffectCoordinate(dataset=re_ds, task="logistic_regression", config=cfg_re),
    }


def sweep(torch, coords):
    """One CoordinateDescent sweep; (result, wall seconds) on the host clock
    around work that ends in a device synchronize (over a group: between two
    barriers, after a synchronize on every rank)."""
    from photon_ml_tpu_torch.game import CoordinateDescent

    dev = coords["global"].dataset.batch.device
    group = coords["global"].group
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        group.barrier()
    t0 = time.perf_counter()
    result = CoordinateDescent(coords, n_iterations=1).run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        group.barrier()
    return result, time.perf_counter() - t0


def training_auc(coords, result):
    from photon_ml_tpu_torch.evaluation.device import auc

    batch = coords["global"].dataset.batch
    scores = sum(coords[name].score(result.model[name]) for name in coords)
    return float(auc(scores + batch.offsets, batch.labels, batch.weights)), scores


def hold(problems, what, got, ref, rtol, atol):
    ok, diff = allclose(got, ref, rtol=rtol, atol=atol)
    log(f"  {what}: max abs diff {diff:.3e} (rtol {rtol:g}, atol {atol:g}) {'ok' if ok else 'MISS'}")
    if not ok:
        problems.append(f"{what} disagree (max abs diff {diff:.3e})")


def hold_sweeps(problems, label, a, b, re_b):
    """The sweep bounds: fixed-effect coefficients and variances rtol 1e-3 /
    atol 1e-5; random-effect coefficients atol 5e-3, per-entity loss atol
    1e-4. ``re_b`` is b's random-effect (model, result) retrained on a's
    fixed-effect scores, so that the random effects compare on identical
    residuals. The random effects as each sweep chained them on its own
    fixed effect are printed beside, for the record."""
    fa, fb = a.model["global"].coefficients, b.model["global"].coefficients
    hold(problems, f"{label} FE coefficients", fa.means, fb.means, 1e-3, 1e-5)
    hold(problems, f"{label} FE variances", fa.variances, fb.variances, 1e-3, 1e-5)
    rb_model, rb_res = re_b
    hold(problems, f"{label} RE coefficients", a.model["per-user"].coef_values, rb_model.coef_values, 0.0, 5e-3)
    hold(problems, f"{label} RE loss", a.solver_results["per-user"].loss, rb_res.loss, 0.0, 1e-4)
    _, coef = allclose(a.model["per-user"].coef_values, b.model["per-user"].coef_values, 0.0, 5e-3)
    _, loss = allclose(a.solver_results["per-user"].loss, b.solver_results["per-user"].loss, 0.0, 1e-4)
    worst = int(
        (a.solver_results["per-user"].loss.cpu() - b.solver_results["per-user"].loss.cpu()).abs().argmax()
    )
    log(f"  (for the record) {label} RE chained on each sweep's own FE: max abs diff "
        f"coefficients {coef:.3e}, loss {loss:.3e} (entity row {worst}, loss "
        f"{float(a.solver_results['per-user'].loss[worst]):.4f})")


def retrain_re(coords, res_a, coords_b):
    """coords_b's random effect retrained on res_a's fixed-effect scores
    (in one sweep, the random effect's whole residual)."""
    fe_scores = coords["global"].score(res_a.model["global"])
    dev = coords_b["per-user"].dataset.device
    return coords_b["per-user"].train(fe_scores.to(dev), None)


def device_profile(torch, fn):
    """``fn()`` under torch.profiler: its result and the device's own events
    (kernels, copies, memsets) as (device us, count, name) rows; the
    operators that launched them carry the same device time again."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    return out, sorted(rows, reverse=True)


def log_profile(what, wall, rows, top=12):
    """Prints the busy share of ``wall`` and the top device operations;
    returns the device's busy seconds."""
    busy = sum(r[0] for r in rows) * 1e-6
    log(f"  {what}: wall_s={wall:.4f} device_busy_s={busy:.4f} busy_share={busy / wall:.3f} "
        f"idle_share={1 - busy / wall:.3f} device_ops={sum(r[1] for r in rows)}")
    for us, count, key in rows[:top]:
        log(f"    {us * 1e-3:9.3f} ms  x{count:6d}  {key[:90]}")
    return busy


def profile_sweep(torch, coords):
    """One more sweep under torch.profiler: the device's busy share of the
    sweep's wall and the device operations that fill it; returns the share."""
    (_, wall), rows = device_profile(torch, lambda: sweep(torch, coords))
    return log_profile("profiled sweep", wall, rows) / wall


def glmix_path(torch, n, d, users, d_re, seed):
    from photon_ml_tpu_torch.ops import fused_glm as fg

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = build_data(n, d, users, d_re, seed)
    coords = glmix_coordinates(data, dev)
    re_ds = coords["per-user"].dataset
    E, K, S = re_ds.blocks.features.shape
    from photon_ml_tpu_torch.game.coordinate import _size_buckets

    buckets = _size_buckets(re_ds)
    log(f"  data + datasets built in {time.perf_counter() - t0:.1f}s: n={n} d={d} users={users} "
        f"d_re={d_re}; RE blocks E={E} K={K} S={S}, buckets (start, end, K, S) {buckets}")

    # an untimed first sweep loads PyTorch's lazily loaded kernels; then
    # SWEEPS timed sweeps, each a fresh CoordinateDescent run (the median
    # is reported: the sweep is launch-bound, so its host-clock wall moves
    # with the host's load)
    sweep(torch, coords)
    fg.reset_launch_counts()
    runs = sorted((sweep(torch, coords) for _ in range(SWEEPS)), key=lambda rw: rw[1])
    launches, routes = dict(fg.LAUNCHES), dict(fg.ROUTES)
    res, wall = runs[len(runs) // 2]
    walls = [w for _, w in runs]
    a, _ = training_auc(coords, res)
    fe_r, re_r = res.solver_results["global"], res.solver_results["per-user"]
    log(f"  GLMix sweep (kernels), median of {SWEEPS}: wall_s={wall:.4f} examples_per_s={n / wall:.1f} "
        f"(walls {', '.join(f'{w:.4f}' for w in walls)}) "
        f"shares FE={res.seconds['global'] / wall:.3f} RE={res.seconds['per-user'] / wall:.3f} "
        f"syncs={res.syncs} launches={launches} by body {routes} train_auc={a:.6f}")
    log(f"  FE: iterations={fe_r.iterations} reason={fe_r.reason} loss={float(fe_r.loss):.6f}; "
        f"RE: lanes={int(re_r.loss.shape[0])} max_iterations={int(re_r.iterations.max())} "
        f"reasons={torch.bincount(re_r.reason.cpu().long(), minlength=6).tolist()} "
        f"loss_sum={float(re_r.loss.sum()):.4f}")
    problems = []
    if min(launches.values()) <= 0:
        problems.append(f"a kernel of the GLMix sweep was not launched: {launches}")
    if routes["ring_bulk_copy"] != launches["fused_value_grad"] + launches["fused_hessian_vector"]:
        problems.append(f"B1/B2 did not all run the ring body's bulk-copy route: {routes}")
    if launches["fused_hessian_stats"] != SWEEPS:
        problems.append(
            f"B3 launched {launches['fused_hessian_stats']} times for {SWEEPS} fixed-effect solves"
        )
    var = res.model["global"].coefficients.variances
    if var is None or not bool(torch.isfinite(var).all()) or not bool((var > 0).all()):
        problems.append("SIMPLE variances missing, non-finite or not positive")
    if not (0.5 < a <= 1.0):
        problems.append(f"training AUC {a} out of (0.5, 1]")
    if res.rejections != {"global": 0, "per-user": 0}:
        problems.append(f"the divergence guard rejected an update: {res.rejections}")
    busy_share = profile_sweep(torch, coords)

    # the same sweep with the plain versions forced
    plain = dict(coords, **{"global": dataclasses.replace(coords["global"], plain=True)})
    fg.reset_launch_counts()
    res_p, wall_p = sweep(torch, plain)
    log(f"  GLMix sweep (plain): wall_s={wall_p:.4f} examples_per_s={n / wall_p:.1f} "
        f"shares FE={res_p.seconds['global'] / wall_p:.3f} RE={res_p.seconds['per-user'] / wall_p:.3f} "
        f"syncs={res_p.syncs} launches={dict(fg.LAUNCHES)}")
    if any(fg.LAUNCHES.values()):
        problems.append("the plain sweep launched a kernel")
    hold_sweeps(problems, "kernel vs plain sweep:", res, res_p, retrain_re(coords, res, plain))
    del plain, res_p

    # a small sweep on the card and on the CPU
    small = build_data(20_000, 64, 300, 8, seed + 1)
    c_card = glmix_coordinates(small, dev)
    c_cpu = glmix_coordinates(small, torch.device("cpu"))
    r_card, _ = sweep(torch, c_card)
    r_cpu, _ = sweep(torch, c_cpu)
    hold_sweeps(problems, "small sweep card vs CPU:", r_card, r_cpu, retrain_re(c_card, r_card, c_cpu))
    if problems:
        raise AssertionError("; ".join(problems))
    return {
        "launches": launches, "routes": routes, "wall_s": wall, "walls": walls, "examples_per_s": n / wall,
        "fe_share": res.seconds["global"] / wall, "re_share": res.seconds["per-user"] / wall,
        "syncs": res.syncs, "train_auc": a, "busy_share": busy_share,
        # for the data-parallel phase: the data, the one-card coordinates and
        # the median sweep's result
        "state": {"data": data, "coords": coords, "result": res, "wall_s": wall},
    }


# ------------------------------------------------- phase 6: data parallel
#
# The rank bodies below run in processes that photon_ml_tpu_torch.parallel.
# spawn starts: each imports this file as a module, so they must stay at
# module level, import what they need themselves and return CPU tensors.


def _b4_inputs(torch, n, d, xname, seed, dev):
    """The B4 check's inputs, the same in every process on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 7919 + n * 3 + (xname == "bfloat16"))
    return make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)


def _b4_calls(fg, group, x, coef, v, y, off, wt, vshift, loss):
    """B4's three functions as the main path calls them (the Hessian
    statistics without and with shifts): name -> a call."""
    return {
        "sharded_value_grad": lambda: fg.sharded_value_grad(group, x, coef, y, off, wt, loss),
        "sharded_hessian_vector": lambda: fg.sharded_hessian_vector(group, x, coef, v, y, off, wt, vshift, loss),
        "sharded_hessian_stats": lambda: fg.sharded_hessian_stats(group, x, coef, y, off, wt, loss, False),
        "sharded_hessian_stats_shifts": lambda: fg.sharded_hessian_stats(group, x, coef, y, off, wt, loss, True),
    }


def _b4_kernels(fg, x, coef, v, y, off, wt, vshift, loss):
    """The rank's unsharded kernel of each of ``_b4_calls``: name -> (mode,
    a call)."""
    return {
        "sharded_value_grad": (fg.VG, lambda: fg.fused_value_grad(x, coef, y, off, wt, loss)),
        "sharded_hessian_vector": (fg.HV, lambda: fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss)),
        "sharded_hessian_stats": (fg.HD, lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, False)),
        "sharded_hessian_stats_shifts": (fg.HD_SHIFTS, lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, True)),
    }


def _all_reduce_slot_sum(torch, group, flat):
    """The previous design's collective, kept here to time it in turns with the
    redesign:
    a device synchronize, the rank's float64 row in a zero [world, width]
    buffer (on the host for gloo), one all_reduce(SUM), the rows added in
    rank order, the sum back on the device, a synchronize."""
    import torch.distributed as dist

    dev = flat.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    host = torch.device("cpu") if group.backend == "gloo" else dev
    buf = torch.zeros((group.world_size, flat.numel()), dtype=torch.float64, device=host)
    buf[group.rank] = flat.to(host)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.process_group)
    acc = buf[0]
    for r in range(1, group.world_size):
        acc = acc + buf[r]
    acc = acc.to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return acc


def _all_reduce_b4(torch, group, outs):
    """The previous design's B4 around the rank's unsharded outputs: widened
    to float64 and concatenated, ``_all_reduce_slot_sum``, split and cast back."""
    parts = [o for o in outs if o is not None]
    total = _all_reduce_slot_sum(torch, group, torch.cat([o.reshape(-1).to(torch.float64) for o in parts]))
    summed, at = [], 0
    for o in parts:
        summed.append(total[at : at + o.numel()].reshape(o.shape).to(o.dtype))
        at += o.numel()
    it = iter(summed)
    return tuple(None if o is None else next(it) for o in outs)


def _host_ms(torch, group, fn, reps):
    """Per-call host milliseconds of ``fn`` on every rank at once: the loop
    starts after a barrier and ends in a device synchronize, so the clock
    holds every call's device work."""
    sync = torch.cuda.synchronize if group.device.type == "cuda" else (lambda _: None)
    for _ in range(3):
        fn()
    sync(group.device)
    group.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(group.device)
    return (time.perf_counter() - t0) / reps * 1e3


def _b4_times(torch, fg, group, d, calls, kernels, reps=20, turns=True):
    """Each B4 function on the rank's shard (``d`` columns), ms per call
    (``_host_ms``): the call twice, with ``turns`` in turns with the
    all-reduce path (prev, new, new, prev); its collective alone, the
    all-gather of the cached slot buffer (with ``turns`` beside the previous
    design's all-reduce path); the rank's kernel alone; and the collective's
    own time per call as ``collective_seconds`` reads it (CUDA events over
    NCCL, the host clock between synchronizes over gloo) over ``reps``
    calls."""
    out = {}
    for name, call in calls.items():
        mode, kernel = kernels[name]
        prev = lambda kernel=kernel: _all_reduce_b4(torch, group, kernel())  # noqa: E731
        runs = [_host_ms(torch, group, f, reps) for f in ((prev, call, call, prev) if turns else (call, call))]
        width = fg._out_width(mode, d)
        slots = group.slot_buffer(width, group.device)
        flat = torch.zeros(width, dtype=torch.float64, device=group.device)
        c0 = (group.collectives, group.collective_seconds)
        for _ in range(reps):
            call()
        c1 = (group.collectives, group.collective_seconds)
        mine = runs[1:3] if turns else runs
        out[name] = {
            "ms": min(mine), "ms_runs": mine,
            "collective_ms": _host_ms(torch, group, lambda: group.gather_slots(slots), reps),
            "kernel_ms": _host_ms(torch, group, kernel, reps),
            "collective_own_ms": (c1[1] - c0[1]) / max(c1[0] - c0[0], 1) * 1e3,
            "collectives_per_call": (c1[0] - c0[0]) / reps,
        }
        if turns:
            out[name].update({
                "prev_ms": min(runs[0], runs[3]), "prev_ms_runs": [runs[0], runs[3]],
                "prev_collective_ms": _host_ms(torch, group, lambda: _all_reduce_slot_sum(torch, group, flat), reps),
            })
    return out


def _same_as_prev(torch, group, calls, kernels):
    """Whether each B4 function gives bitwise the all-reduce path's outputs on this rank."""
    same = {}
    for name, call in calls.items():
        new, old = call(), _all_reduce_b4(torch, group, kernels[name][1]())
        same[name] = all(_same_bits(a, b) for a, b in zip(new, old))
    return same


def _staging_ms(torch, group, width):
    """The collective's parts alone, every rank at once (ms per call): the
    all-gather of the [world, width] float64 slot buffer where it lies
    (host for gloo), a device synchronize, and (gloo) the copies of a
    width-wide float64 row to the host and of the buffer back."""
    host = group.device if group.backend == "nccl" else torch.device("cpu")
    buf = group.slot_buffer(width, host)
    row = torch.zeros(width, dtype=torch.float64, device=group.device)
    out = {"all_gather": _host_ms(torch, group, lambda: group._all_gather(buf), 20)}
    if group.device.type == "cuda":
        out["synchronize"] = _host_ms(torch, group, lambda: torch.cuda.synchronize(group.device), 20)
    if group.backend == "gloo" and group.device.type == "cuda":
        out["to_host"] = _host_ms(torch, group, lambda: row.to("cpu"), 20)
        out["to_device"] = _host_ms(torch, group, lambda: buf.to(group.device), 20)
    return out


def _host_syncs(torch, calls):
    """Each call once with CUDA's sync debug mode at "error" and
    torch.cuda.synchronize counting its calls: (synchronizes, the calls that
    raised for a synchronizing CUDA operation)."""
    real, count, raised = torch.cuda.synchronize, [0], []

    def counting(*a, **k):
        count[0] += 1
        return real(*a, **k)

    torch.cuda.synchronize = counting
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as e:  # the debug mode's error, reported as a check
                raised.append(f"{name}: {str(e).splitlines()[0]}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize = real
    return count[0], raised


def _device_ops(torch, call):
    """The device operations of one call under torch.profiler: (name,
    count) pairs."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def dp_b4_rank(group, n, d, seed):
    """Phase 6 (a), on one rank: B4 on the rank's rows of each case, bitwise
    against the all-reduce path on the same rows, and at n rows the times of
    ``_b4_times``."""
    import torch

    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.parallel import row_range

    dev, loss = group.device, LOSSES["logistic"]
    outs, times, same = {}, {}, {}
    for xname in ("float32", "bfloat16"):
        for nn in (n, n - 1):
            x, coef, v, y, off, wt, vshift = _b4_inputs(torch, nn, d, xname, seed, dev)
            start, stop = row_range(nn, group)
            share = -(-nn // group.world_size)
            pad = lambda a: torch.cat([a[start:stop], a.new_zeros((share - (stop - start),) + a.shape[1:])])  # noqa: E731
            xs, ys, offs, wts = pad(x), pad(y), pad(off), pad(wt)
            del x
            torch.cuda.empty_cache()
            operands = (xs, coef, v, ys, offs, wts, vshift, loss)
            calls, kernels = _b4_calls(fg, group, *operands), _b4_kernels(fg, *operands)
            outs[(nn, xname)] = {
                name: tuple(None if o is None else o.cpu() for o in call()) for name, call in calls.items()
            }
            same[(nn, xname)] = _same_as_prev(torch, group, calls, kernels)
            if nn == n and xname == "float32":
                # the bf16 turns were cut to make room for phase 18, the
                # all-reduce path's turns for phase 17 (f) (its bits are
                # still held above)
                times[xname] = _b4_times(torch, fg, group, d, calls, kernels, turns=False)
                times[xname]["staging"] = _staging_ms(torch, group, fg._out_width(fg.VG, d))
            del xs
            torch.cuda.empty_cache()
    return {"outs": outs, "times": times, "same_as_prev": same, "device": str(dev), "backend": group.backend}


def dp_sweep_rank(group, data_dir, sweeps):
    """Phase 6 (b) and (c), on one rank: the GLMix sweep over sharded
    datasets built from the parent's files, one untimed sweep and
    ``sweeps`` timed ones. Returns the rank's walls, per-coordinate seconds,
    syncs and collectives, launch counts, its random-effect solve (entities,
    bucket shape, padded and real cells), B4's times on its rows
    (``_b4_times``) and whether B4 gives the all-reduce path's bits there; over NCCL also
    the host synchronizes of one call of each B4 function and the device
    operations of one value+grad call; and from rank 0 the model, the random
    effect's per-entity loss and the fixed effect's scores."""
    import torch

    from photon_ml_tpu_torch.evaluation.device import auc
    from photon_ml_tpu_torch.game.coordinate import _size_buckets
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.parallel import entity_range

    t0 = time.perf_counter()
    gx = np.load(f"{data_dir}/gx.npy", mmap_mode="r")
    y, ex = np.load(f"{data_dir}/y.npy"), np.load(f"{data_dir}/ex.npy")
    ids = np.load(f"{data_dir}/ids.npy").astype(object)
    n = gx.shape[0]
    coords = glmix_coordinates((gx, y, ex, ids), group.device, group=group)
    del gx
    build_s = time.perf_counter() - t0
    re_ds = coords["per-user"].dataset
    E = re_ds.num_entities
    lo, hi = entity_range(E, group)
    e_local = hi - lo
    segs = _size_buckets(re_ds, align=e_local if group.world_size > 1 else 1) or [(0, E, None, None)]
    mine = [(s, e, kb, sb) for s, e, kb, sb in segs if s < hi and lo < e]
    _, K, S = re_ds.blocks.features.shape
    counts, sdims = re_ds.entity_counts[lo:hi], re_ds.entity_subspace_dims[lo:hi]
    padded = sum((min(e, hi) - max(s, lo)) * (kb or K) * (sb or S) for s, e, kb, sb in mine)

    sweep(torch, coords)  # loads PyTorch's lazily loaded kernels
    fg.reset_launch_counts()
    runs = [sweep(torch, coords) for _ in range(sweeps)]
    launches, sharded, sums = dict(fg.LAUNCHES), dict(fg.SHARDED_LAUNCHES), dict(fg.SUM_LAUNCHES)
    res = sorted(runs, key=lambda rw: rw[1])[len(runs) // 2][0]
    out = {
        "rank": group.rank, "world": group.world_size, "backend": group.backend,
        "device": str(group.device), "build_s": build_s,
        "walls": [w for _, w in runs], "seconds": dict(res.seconds), "syncs": dict(res.syncs),
        "collectives": dict(res.collectives), "collective_s": dict(res.collective_seconds),
        "launches": launches, "sharded": sharded, "sums": sums,
        "re": {
            "entities": (lo, hi), "buckets": [(kb, sb) for _, _, kb, sb in mine],
            "padded_cells": int(padded), "real_cells": int(np.sum(counts * sdims)),
            "rows": int(np.sum(counts)),
        },
        "rejections": dict(res.rejections),
    }
    # B4 as the sweep calls it, on this rank's rows (every rank at once),
    # after the launch counts were read
    from photon_ml_tpu_torch.ops.losses import LOSSES

    b = coords["global"].dataset.batch
    x = b.features.dense
    coef = res.model["global"].coefficients.means.to(x.device)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(17)
    v = torch.randn(x.shape[1], generator=gen, device=x.device)
    operands = (x, coef, v, b.labels, b.offsets, b.weights, torch.tensor(0.1, device=x.device), LOSSES["logistic"])
    calls, kernels = _b4_calls(fg, group, *operands), _b4_kernels(fg, *operands)
    out["b4_same_as_prev"] = _same_as_prev(torch, group, calls, kernels)
    out["b4"] = _b4_times(torch, fg, group, x.shape[1], calls, kernels)
    if group.backend == "nccl":
        torch.cuda.synchronize()
        out["b4_host_syncs"], out["b4_sync_errors"] = _host_syncs(torch, calls)
        out["b4_device_ops"] = _device_ops(torch, calls["sharded_value_grad"])
    # scoring the fixed effect gathers across the ranks: every rank scores
    fe_scores = coords["global"].score(res.model["global"])
    re_scores = coords["per-user"].score(res.model["per-user"])
    if group.rank == 0:
        fe = res.model["global"].coefficients
        ones = torch.ones_like(fe_scores)
        yt = torch.as_tensor(y, device=fe_scores.device)
        out.update(
            fe_means=fe.means.cpu(), fe_variances=fe.variances.cpu(), fe_scores=fe_scores.cpu(),
            fe_iterations=res.solver_results["global"].iterations,
            re_values=res.model["per-user"].coef_values.cpu(),
            re_loss=res.solver_results["per-user"].loss.cpu(),
            train_auc=float(auc(fe_scores + re_scores, yt, ones)),
        )
    return out


def _ref_b4(torch, fg, x, coef, v, y, off, wt, vshift, loss):
    """The float64 plain versions on the whole batch, in B4's output form."""
    f64 = torch.float64
    return {
        "sharded_value_grad": fg.value_grad_plain(x, coef, y, off, wt, loss, compute_dtype=f64),
        "sharded_hessian_vector": fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss, compute_dtype=f64),
        "sharded_hessian_stats": fg.hessian_stats_plain(x, coef, y, off, wt, loss, False, compute_dtype=f64),
        "sharded_hessian_stats_shifts": fg.hessian_stats_plain(x, coef, y, off, wt, loss, True, compute_dtype=f64),
    }


def _b4_errors(torch, got, ref):
    """(ok, {name: (vector err, bound, scalar rel err)}) at phase 3's bounds:
    the value and s0 rtol 2e-6; the vectors with their scalar sums max-abs
    <= 3e-5 * max(|ref|, 1)."""
    report, ok = {}, True
    for name, r in ref.items():
        g = got[name]
        if name == "sharded_value_grad":
            vec_g, vec_r = torch.cat([g[1].double(), g[2].double().reshape(1)]), torch.cat([r[1], r[2].reshape(1)])
            scal = (float(g[0]), float(r[0]))
        elif name == "sharded_hessian_vector":
            vec_g, vec_r = torch.cat([g[0].double(), g[1].double().reshape(1)]), torch.cat([r[0], r[1].reshape(1)])
            scal = None
        elif name == "sharded_hessian_stats":
            vec_g, vec_r, scal = g[0].double(), r[0], None
        else:
            vec_g, vec_r = torch.cat([g[0].double(), g[1].double()]), torch.cat([r[0], r[1]])
            scal = (float(g[2]), float(r[2]))
        vec_r = vec_r.cpu()
        err = float((vec_g - vec_r).abs().max())
        bound = 3e-5 * max(float(vec_r.abs().max()), 1.0)
        rel = abs(scal[0] - scal[1]) / max(abs(scal[1]), 1e-30) if scal else 0.0
        finite = all(bool(torch.isfinite(o).all()) for o in g if o is not None)
        good = finite and err <= bound and rel <= 2e-6
        ok &= good
        report[name] = (err, bound, rel, good)
    return ok, report


def _same_bits(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8), b.reshape(-1).contiguous().view(torch.uint8)
    )


def log_b4_time(where, name, t, worst):
    """One line of B4's times (``_b4_times``) on rank 0."""
    turns = "prev_ms" in t
    log(f"  time B4 {where} {name:28s} {t['ms']:.4f} ms/call on rank 0 (runs "
        f"{'/'.join(f'{u:.4f}' for u in t['ms_runs'])}; slowest rank {worst:.4f}); "
        + (f"the all-reduce path {t['prev_ms']:.4f} ({'/'.join(f'{u:.4f}' for u in t['prev_ms_runs'])}); "
           if turns else "")
        + f"collective alone {t['collective_ms']:.4f}"
        + (f" (all-reduce path {t['prev_collective_ms']:.4f})" if turns else "")
        + f"; its own time in the call {t['collective_own_ms']:.4f} ({t['collectives_per_call']:.0f} a call); "
          f"rank's kernel alone {t['kernel_ms']:.4f}; call - kernel {t['ms'] - t['kernel_ms']:+.4f}")


def launch_problems(ranks, backend):
    """Every rank launched each kernel of the data-parallel sweep, and one
    rank-order sum per B4 call whose rank launched its kernel."""
    problems = []
    for r in ranks:
        if min(r["sharded"].values()) <= 0 or min(r["launches"].values()) <= 0:
            problems.append(f"{backend} rank {r['rank']}: a kernel of the data-parallel sweep was not launched")
        if r["sums"]["rank_order_sum"] != sum(r["sharded"].values()):
            problems.append(f"{backend} rank {r['rank']}: {r['sums']} rank-order sums for B4 calls {r['sharded']}")
    return problems


def dp_path(torch, n, d, seed, state, device="cuda", gloo=True):
    """Phase 6: the data-parallel GLMix sweep; (a), (b), (c) as in the
    module docstring (``gloo=False``: (c) alone). ``device="cpu"``
    rehearses (a) and (b) on the CPU at a small size (the plain versions,
    no nccl)."""
    import tempfile

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.parallel import spawn

    dev = torch.device(device)
    if dev.type == "cuda":
        cuda_lib.load("fused_glm")  # built here, so that no two ranks run nvcc
    problems = []
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        if gloo:
            # (a) B4 against the float64 plain versions on the whole batch
            t0 = time.perf_counter()
            ranks = spawn(dp_b4_rank, DP_RANKS, "gloo", device, args=(n, d, seed),
                          timeout_s=DP_TIMEOUT_S, store_dir=tmp)
            log(f"  (a) B4 on {DP_RANKS} gloo ranks on {ranks[0]['device']} "
                f"(backend {ranks[0]['backend']}, world {DP_RANKS}): ranks done in {time.perf_counter() - t0:.1f}s")
            errs = {}
            for (nn, xname), got in ranks[0]["outs"].items():
                x, coef, v, y, off, wt, vshift = _b4_inputs(torch, nn, d, xname, seed, dev)
                ref = _ref_b4(torch, fg, x, coef, v, y, off, wt, vshift, LOSSES["logistic"])
                del x
                torch.cuda.empty_cache()
                ok, rep = _b4_errors(torch, got, ref)
                same = all(
                    _same_bits(a, b)
                    for r in ranks[1:] for name in got for a, b in zip(r["outs"][(nn, xname)][name], got[name])
                )
                for name, (err, bound, rel, good) in rep.items():
                    log(f"  check B4 gloo world={DP_RANKS} n={nn} d={d} {xname:8s} {name:28s} "
                        f"err={err:.3e}/{bound:.3e} scalar_rel={rel:.2e} {'ok' if good else 'MISS'}")
                prev = all(all(r["same_as_prev"][(nn, xname)].values()) for r in ranks)
                log(f"  B4 gloo world={DP_RANKS} n={nn} {xname}: every rank bitwise alike: {same}; "
                    f"every rank bitwise the all-reduce path: {prev}")
                if not (ok and same and prev):
                    problems.append(f"B4 n={nn} {xname}: bounds ok {ok}, ranks alike {same}, the all-reduce path's bits {prev}")
                if (nn, xname) == (n, "float32"):
                    errs = {name: rep[name][0] for name in B4_OF}
            times = {}
            for xname, row in ranks[0]["times"].items():
                for name, t in row.items():
                    if name == "staging":
                        continue
                    worst = max(r["times"][xname][name]["ms"] for r in ranks)
                    log_b4_time(f"gloo world={DP_RANKS} {xname:8s}", name, t, worst)
                times[xname] = row
            log("  (a) cut to make room for phase 18: B4 timed with f32 X only (the bf16 turns dropped); cut to make "
                "room for phase 17 (f): the all-reduce path's timed turns and collective times dropped (its bits "
                "still held)")
            st = ranks[0]["times"]["float32"]["staging"]
            log(f"  the collective's parts alone, ms per call on rank 0 of {DP_RANKS} (gloo): "
                + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))
            report["b4"] = {"errors": errs, "times": times}
            del ranks

        # the sweep's data for (b) and (c), and phase 5's one-card sweep
        gx, y, ex, ids = state["data"]
        t0 = time.perf_counter()
        np.save(f"{tmp}/gx.npy", gx)
        np.save(f"{tmp}/y.npy", y)
        np.save(f"{tmp}/ex.npy", ex)
        np.save(f"{tmp}/ids.npy", np.asarray(ids, dtype=str))
        log(f"  wrote the sweep's data for the ranks in {time.perf_counter() - t0:.1f}s")
        one, coords = state["result"], state["coords"]
        f1 = one.model["global"].coefficients
        if gloo:
            # (b) the 4-rank sweep against phase 5's one-card sweep
            t0 = time.perf_counter()
            ranks = spawn(dp_sweep_rank, DP_RANKS, "gloo", device, args=(tmp, SWEEPS),
                          timeout_s=DP_TIMEOUT_S, store_dir=tmp)
            log(f"  (b) sweep on {DP_RANKS} gloo ranks: ranks done in {time.perf_counter() - t0:.1f}s "
                f"(builds {', '.join(f'{r['build_s']:.1f}' for r in ranks)} s)")
            r0 = ranks[0]
            walls = sorted(r0["walls"])
            wall = walls[len(walls) // 2]
            log(f"  data-parallel sweep (backend gloo, world {DP_RANKS}, one card), median of {SWEEPS}: "
                f"wall_s={wall:.4f} examples_per_s={n / wall:.1f} (walls {', '.join(f'{w:.4f}' for w in r0['walls'])}) "
                f"shares FE={r0['seconds']['global'] / wall:.3f} RE={r0['seconds']['per-user'] / wall:.3f} "
                f"train_auc={r0['train_auc']:.6f}")
            for r in ranks:
                log(f"    rank {r['rank']} of {r['world']} ({r['backend']}): RE wall {r['seconds']['per-user']:.4f} s, FE {r['seconds']['global']:.4f} s; "
                    f"entities {r['re']['entities']} buckets (K, S) {r['re']['buckets']} "
                    f"padded cells {r['re']['padded_cells']} real cells {r['re']['real_cells']} rows {r['re']['rows']}; "
                    f"syncs {r['syncs']} collectives {r['collectives']} "
                    f"collective_s {{{', '.join(f'{k}: {v:.4f}' for k, v in r['collective_s'].items())}}}; "
                    f"launches {r['launches']} {r['sharded']} {r['sums']}")
            for name, t in r0["b4"].items():
                log_b4_time(f"gloo world={DP_RANKS} sweep rows", name, t, max(r["b4"][name]["ms"] for r in ranks))
            if any(r["rejections"] != {"global": 0, "per-user": 0} for r in ranks):
                problems.append("the divergence guard rejected an update on a rank")
            problems += launch_problems(ranks, "gloo")
            for r in ranks:
                if not all(r["b4_same_as_prev"].values()):
                    problems.append(f"gloo rank {r['rank']}: B4 differs from the all-reduce path {r['b4_same_as_prev']}")
            if not (0.5 < r0["train_auc"] <= 1.0):
                problems.append(f"data-parallel training AUC {r0['train_auc']} out of (0.5, 1]")
            hold(problems, "4 ranks vs one card: FE coefficients", r0["fe_means"], f1.means, 1e-3, 1e-5)
            hold(problems, "4 ranks vs one card: FE variances", r0["fe_variances"], f1.variances, 1e-3, 1e-5)
            E1 = one.model["per-user"].coef_values.shape[0]
            re1, res1 = coords["per-user"].train(r0["fe_scores"].to(dev), None)
            hold(problems, "4 ranks vs one card: RE coefficients (identical residuals)",
                 r0["re_values"][:E1], re1.coef_values, 0.0, 5e-3)
            hold(problems, "4 ranks vs one card: RE loss (identical residuals)",
                 r0["re_loss"][:E1], res1.loss, 0.0, 1e-4)
            _, coef = allclose(r0["re_values"][:E1], one.model["per-user"].coef_values, 0.0, 5e-3)
            _, loss = allclose(r0["re_loss"][:E1], one.solver_results["per-user"].loss, 0.0, 1e-4)
            log(f"  (for the record) RE chained on each sweep's own FE: max abs diff coefficients "
                f"{coef:.3e}, loss {loss:.3e}")
            report["sweep"] = {
                "wall_s": wall, "walls": r0["walls"], "examples_per_s": n / wall,
                "fe_share": r0["seconds"]["global"] / wall, "re_share": r0["seconds"]["per-user"] / wall,
                "re_walls": [r["seconds"]["per-user"] for r in ranks],
                "sharded": [r["sharded"] for r in ranks], "launches": [r["launches"] for r in ranks],
                "collectives": r0["collectives"], "syncs": r0["syncs"], "b4": r0["b4"],
                "sums": [r["sums"] for r in ranks],
            }
            del ranks

        # (c) NCCL, one rank per card
        if dev.type != "cuda":
            if problems:
                raise AssertionError("; ".join(problems))
            return report
        world = torch.cuda.device_count()
        t0 = time.perf_counter()
        ranks = spawn(dp_sweep_rank, world, "nccl", "cuda", args=(tmp, SWEEPS),
                      timeout_s=DP_TIMEOUT_S, store_dir=tmp)
        r0 = ranks[0]
        walls = sorted(r0["walls"])
        wall = walls[len(walls) // 2]
        log(f"  (c) sweep over nccl (backend nccl, world {world}, one rank per card), median of {SWEEPS}: "
            f"wall_s={wall:.4f} examples_per_s={n / wall:.1f} (walls {', '.join(f'{w:.4f}' for w in r0['walls'])}); "
            f"one card in phase 5: median wall_s={state['wall_s']:.4f}, the nccl sweep {wall / state['wall_s']:.3f}x it; "
            f"ranks done in {time.perf_counter() - t0:.1f}s; shares FE={r0['seconds']['global'] / wall:.3f} "
            f"RE={r0['seconds']['per-user'] / wall:.3f}; syncs {r0['syncs']} collectives {r0['collectives']} "
            f"collective_s {{{', '.join(f'{k}: {v:.6f}' for k, v in r0['collective_s'].items())}}}; "
            f"launches {r0['launches']} {r0['sharded']} {r0['sums']}")
        for name, t in r0["b4"].items():
            log_b4_time(f"nccl world={world}", name, t, max(r["b4"][name]["ms"] for r in ranks))
        log(f"  nccl B4: host synchronizes in one call of each function: {r0['b4_host_syncs']} "
            f"(sync debug errors: {r0['b4_sync_errors'] or 'none'}); bitwise the all-reduce path: {r0['b4_same_as_prev']}; "
            f"device operations of one value+grad call: {r0['b4_device_ops']}")
        problems += launch_problems(ranks, "nccl")
        for r in ranks:
            if r["b4_host_syncs"] or r["b4_sync_errors"]:
                problems.append(f"nccl rank {r['rank']}: a B4 call synchronized the host "
                                f"({r['b4_host_syncs']} synchronizes, {r['b4_sync_errors']})")
            if not all(r["b4_same_as_prev"].values()):
                problems.append(f"nccl rank {r['rank']}: B4 differs from the all-reduce path {r['b4_same_as_prev']}")
        if world == 1:
            for what, a, b in (("coefficients", r0["fe_means"], f1.means.cpu()),
                               ("variances", r0["fe_variances"], f1.variances.cpu())):
                same = _same_bits(a, b)
                log(f"  nccl world 1 vs one card: FE {what} bitwise equal: {same}")
                if not same:
                    problems.append(f"nccl world 1: FE {what} differ from the one-card sweep")
        else:
            hold(problems, f"nccl world {world} vs one card: FE coefficients", r0["fe_means"], f1.means, 1e-3, 1e-5)
            hold(problems, f"nccl world {world} vs one card: FE variances", r0["fe_variances"], f1.variances, 1e-3, 1e-5)
        report["nccl"] = {
            "world": world, "wall_s": wall, "walls": r0["walls"], "one_card_wall_s": state["wall_s"],
            "sharded": r0["sharded"], "sums": r0["sums"], "launches": r0["launches"], "b4": r0["b4"],
            "host_syncs": r0["b4_host_syncs"], "device_ops": r0["b4_device_ops"],
        }
    if problems:
        raise AssertionError("; ".join(problems))
    return report


def time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps):
    """Milliseconds per call of ``fn`` replayed from a CUDA graph of ``reps``
    calls, between CUDA events: a step as short as the finalize (a few us)
    would otherwise measure the host's launch time (~50 us a call). Three
    replays after a warm one; the lowest."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del g
    return best


def timings(torch, n, d, seed):
    """Per-call times at the main path's shape; the X of the main path is 2 GB
    (f32), far above the 50 MB L2, so every call reads it from device memory.
    Each kernel is timed twice between two runs of its plain version, with
    its main kernel and finalize alone and torch.mv(X, coef), the time to
    read X once (a yardstick, not a library call: it computes another
    function). B3 is timed in turns with its previous finalize (the serial
    one: prev, new, new, prev); B1's and B2's turns with the earlier staged
    body left the script to make room for phase 17 (f) (their "prev" columns in
    PERF.md stay as recorded)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    out = {}
    loss = LOSSES["logistic"]
    for xname in ("float32", "bfloat16"):
        gen.manual_seed(seed + 7)
        x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)
        saved, saved_routes = dict(fg.LAUNCHES), dict(fg.ROUTES)
        row = {}
        cx = coef.to(x.dtype)
        read_a = time_ms(torch, lambda: torch.mv(x, cx), 20)
        for name, kern, plain, mode, operands in (
            ("fused_value_grad",
             lambda: fg.fused_value_grad(x, coef, y, off, wt, loss),
             lambda: fg.value_grad_plain(x, coef, y, off, wt, loss), fg.VG,
             (x, coef, None, y, off, wt, None, loss)),
            ("fused_hessian_vector",
             lambda: fg.fused_hessian_vector(x, coef, v, y, off, wt, vshift, loss),
             lambda: fg.hessian_vector_plain(x, coef, v, y, off, wt, vshift, loss), fg.HV,
             (x, coef, v, y, off, wt, vshift, loss)),
            # as the main path calls it: no normalization, so no shifts
            ("fused_hessian_stats",
             lambda: fg.fused_hessian_stats(x, coef, y, off, wt, loss, False),
             lambda: fg.hessian_stats_plain(x, coef, y, off, wt, loss, False), fg.HD,
             (x, coef, None, y, off, wt, None, loss)),
        ):
            launch = lambda **kw: fg._launch(mode, *operands, **kw)  # noqa: E731
            prev = lambda: launch(body=fg.STAGED, finalize=fg.FINALIZE_SERIAL)  # noqa: E731
            turns = name == "fused_hessian_stats"
            nan = float("nan")
            plain_a = time_ms(torch, plain, 10)
            prev_a = time_ms(torch, prev, 20) if turns else nan
            ms_a = time_ms(torch, kern, 20)
            ms_b = time_ms(torch, kern, 20)
            prev_b = time_ms(torch, prev, 20) if turns else nan
            plain_b = time_ms(torch, plain, 10)
            main_ms = graph_ms(torch, lambda: launch(steps=fg.STEP_MAIN), 10)
            fin_ms = graph_ms(torch, lambda: launch(steps=fg.STEP_FINALIZE), 20)
            prev_main = graph_ms(torch, lambda: launch(body=fg.STAGED, steps=fg.STEP_MAIN), 10) if turns else nan
            prev_fin = graph_ms(
                torch, lambda: launch(body=fg.STAGED, finalize=fg.FINALIZE_SERIAL, steps=fg.STEP_FINALIZE), 20
            ) if turns else nan
            nbytes = fg.sweep_bytes(n, d, x.dtype, mode)
            ops = fg.sweep_flops(n, d, mode)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[xname] * 1e3
            plan = fg.plan_of(x, mode)
            ms = min(ms_a, ms_b)
            row[name] = {
                "ms": ms, "ms_runs": [ms_a, ms_b],
                "plain_ms": min(plain_a, plain_b), "plain_ms_runs": [plain_a, plain_b],
                "prev_ms": min(prev_a, prev_b) if turns else None, "prev_ms_runs": [prev_a, prev_b] if turns else None,
                "main_ms": main_ms, "finalize_ms": fin_ms,
                "prev_main_ms": prev_main if turns else None, "prev_finalize_ms": prev_fin if turns else None,
                "read_x_ms": read_a,
                "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "ops": ops, "plan": plan,
            }
            log(f"  time {xname:8s} {name:22s} kernel {ms_a:.4f}/{ms_b:.4f} ms "
                f"(graph-timed: main {main_ms:.4f} + finalize {fin_ms:.4f}; {plan['body']} body, route {plan['route']}, "
                f"grid {plan['grid']}, {plan['blocks_per_sm']} blocks/SM, {plan['rows_per_tile']} rows/tile, "
                f"{plan['stages']} stages, {plan['smem_bytes']} B smem)  "
                + (f"previous design {prev_a:.4f}/{prev_b:.4f} ms (graph-timed: main {prev_main:.4f} + serial finalize "
                   f"{prev_fin:.4f})  " if turns else "")
                + f"plain(unfused composition) {plain_a:.4f}/{plain_b:.4f} ms  read X once (torch.mv) {read_a:.4f} ms  "
                f"bound {max(t_bytes, t_ops):.4f} ms ({row[name]['bound_by']}, {nbytes} B)  "
                f"achieved {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s ({max(t_bytes, t_ops) / ms:.1%} of the bound)")
        fg.LAUNCHES.update(saved)  # timing launches are not main-path launches
        fg.ROUTES.update(saved_routes)
        out[xname] = row
        del x
        torch.cuda.empty_cache()
    out["rank_order_sum"] = time_rank_order_sum(torch, d, seed)
    return out


def time_rank_order_sum(torch, d, seed):
    """The rank-order sum at the data-parallel path's shapes (value+grad's
    width d + 2, worlds 1 and DP_RANKS), each call replayed from a CUDA
    graph: the kernel, its plain version (a loop of adds and a cast), and
    torch.sum over the ranks (float64 out, its own order) as the library's
    yardstick. Bound: the slots read once and the f32 row written once."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    saved = dict(fg.SUM_LAUNCHES)
    out = {}
    width = fg._out_width(fg.VG, d)
    for world in (1, DP_RANKS):
        slots = torch.randn((world, width), generator=gen, device=dev, dtype=torch.float64)
        nbytes = world * width * 8 + width * 4
        row = {
            "ms": graph_ms(torch, lambda: fg.rank_order_sum(slots), 50),
            "plain_ms": graph_ms(torch, lambda: fg.rank_order_sum_plain(slots, torch.float32), 50),
            "library_ms": graph_ms(torch, lambda: torch.sum(slots, dim=0), 50),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes,
            "world": world, "width": width,
        }
        out[world] = row
        log(f"  time rank_order_sum world={world} width={width}: kernel {row['ms']:.4f} ms (graph-timed)  "
            f"plain {row['plain_ms']:.4f} ms  torch.sum over ranks {row['library_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.6f} ms (bytes, {nbytes} B)")
    fg.SUM_LAUNCHES.update(saved)
    return out


# Diagnostic variants of the ring body (csrc/fused_glm.cu): each removes or
# cheapens one part of the consumer's work, so that its time says what that
# part costs. They compute wrong sums; nothing but phase 8 loads them.
_RING_MARGIN = """                const double xd = (double)xv[e];
                za[q] = fma(cd[i * VEC + e], xd, za[q]);
                if constexpr (HV) ua[q] = fma(SV ? vs[(i * VEC + e) * 32 + lane] : vd[i * VEC + e], xd, ua[q]);"""
_RING_COLUMNS = """            float xv[VEC];
            lane_chunk<T, VEC>(xr, d, lane, i, xv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i * VEC + e] = fmaf(wq, xv[e], acc[i * VEC + e]);"""
_RING_COEF = """    if constexpr (HV && !SV) lane_vector<T, VEC>(v, d, lane, vd);"""
RING_VARIANTS = {
    "ring": [],
    # margins in f32 FMAs on f32 coefficients: no conversion, no double FMA
    "f32_margins": [
        ("double za[B], ua[B];", "float za[B], ua[B];"),
        (_RING_MARGIN, """                za[q] = fmaf(cf[i * VEC + e], xv[e], za[q]);
                if constexpr (HV) ua[q] = fmaf(vf[i * VEC + e], xv[e], ua[q]);"""),
        (_RING_COEF, _RING_COEF + """
    float cf[kLaneCols], vf[kLaneCols];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
      cf[c] = (float)cd[c];
      vf[c] = SV ? (float)vs[c * 32 + lane] : (float)vd[c];
    }"""),
    ],
    # each row's x read from the tile and summed, nothing multiplied
    "no_margins": [("double za[B], ua[B];", "float za[B], ua[B];"),
                   (_RING_MARGIN, "                za[q] += xv[e];")],
    # the second read of each row and its column FMAs left out
    "no_columns": [(_RING_COLUMNS, "            acc[i * VEC] += wq;")],
    # the ring, the losses and the bookkeeping alone
    "no_compute": [("double za[B], ua[B];", "float za[B], ua[B];"),
                   (_RING_MARGIN, "                za[q] += xv[e];"),
                   (_RING_COLUMNS, "            acc[i * VEC] += wq;")],
}


def ring_variants(torch, n, d, seed):
    """Each RING_VARIANTS entry built from csrc/fused_glm.cu and timed (CUDA
    events, B1 and B2 at n x d, logistic, f32 and bf16) in turns: the
    variants in order, then in reverse."""
    import ctypes
    import subprocess

    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.losses import LOSSES

    base = (cuda_lib.CSRC_DIR / "fused_glm.cu").read_text()
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in RING_VARIANTS.items():
        text = base
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ring variant {name}: the source no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = fg._library()
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on ring variant {name}:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("fused_glm_plan", "fused_glm_launch", "fused_glm_blocks_per_sm"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = lib
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    loss = LOSSES["logistic"]
    library, plans = fg._library, dict(fg._PLANS)
    out = {}
    try:
        for xname in ("float32", "bfloat16"):
            gen.manual_seed(seed + 7)
            x, coef, v, y, off, wt, vshift = make_inputs(torch, gen, n, d, "logistic", getattr(torch, xname), dev)
            for fname, mode, operands in (
                ("fused_value_grad", fg.VG, (x, coef, None, y, off, wt, None, loss)),
                ("fused_hessian_vector", fg.HV, (x, coef, v, y, off, wt, vshift, loss)),
            ):
                runs = {}
                for name in list(libs) + list(libs)[::-1]:
                    fg._library, fg._PLANS = (lambda lib=libs[name]: lib), {}
                    runs.setdefault(name, []).append(time_ms(torch, lambda: fg._launch(mode, *operands), 20))
                out[(xname, fname)] = runs
                log(f"  ring variants {xname:8s} {fname:22s} " + "  ".join(
                    f"{name} {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})" for name, t in runs.items()) + " ms")
            del x
            torch.cuda.empty_cache()
    finally:
        fg._library, fg._PLANS = library, plans
    return out


# Diagnostic variants of the segment kernel (csrc/sparse_glm.cu) and of its
# earlier design (csrc/sparse_glm_warp.cu), built and timed like the ring's:
# each changes one part, so that its time says what that part costs. Those
# marked so compute wrong sums; nothing but phase 8 loads them.
_SEG_ROW_GATHER = "gather_cols<SW>(row + k * SW, width - k * SW, vec, x[e][k]);"
_SEG_KEY_GATHER = "gather_cols<S>(src + (long long)idx[e] * L + c0, n, vec, x[e]);"
_SEG_STORE = "for (int r = lane; r < n; r += kWarp) out[(w0 + r) * L + c0] = win[r];"
_SEG_GATHER_SCALAR = "  for (int c = 0; c < S; ++c) x[c] = c < n ? __ldg(p + c) : 0.0f;"
SEGMENT_VARIANTS = {
    "segment": ("sparse_glm", []),
    # wrong sums: entry j reads src[j] (row groups; j < d at the sparse
    # shape) or entry e of thread t src[(8 t + e) mod 2^17] (key walk;
    # 2^17 < n): the stream without the gathers
    "contiguous_src": ("sparse_glm", [
        (_SEG_ROW_GATHER, "gather_cols<SW>(src + (j + e) * L + c0 + k * SW, width - k * SW, vec, x[e][k]);"),
        (_SEG_KEY_GATHER, "gather_cols<S>(src + ((((long long)blockIdx.x * blockDim.x + threadIdx.x) * kRunEntries + e) "
                          "& 131071) * L + c0, n, vec, x[e]);"),
    ]),
    # wrong sums: the key walk's window built but not stored
    "no_output_stores": ("sparse_glm", [
        (_SEG_STORE, "for (int r = lane; r < n; r += kWarp) if (win[r] == 1234.5f) out[(w0 + r) * L + c0] = win[r];"),
    ]),
    # the gathers under an L2 evict-last cache policy (same sums; the
    # single-column products take the scalar loads)
    "l2_evict_last": ("sparse_glm", [(_SEG_GATHER_SCALAR, """  for (int c = 0; c < S; ++c) {
    unsigned long long policy;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
    float y = 0.0f;
    if (c < n) asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(y) : "l"(p + c), "l"(policy));
    x[c] = y;
  }""")]),
    # the earlier design as it is, and with its entries streamed (__ldcs;
    # same sums)
    "earlier": ("sparse_glm_warp", []),
    "earlier_streamed": ("sparse_glm_warp", [
        ("const double v = widen(val[j]);", "const double v = widen(__ldcs(val + j));"),
        ("return (double)src[gather[j]] * (SQ ? v * v : v);",
         "return (double)src[__ldcs(gather + j)] * (SQ ? v * v : v);"),
    ]),
}
MATVEC_W_COLUMNS = (2_500_000, 5_000_000, 7_500_000)  # w of 10, 20 and 30 MB beside d's 40
PREVIOUS_WIDTHS = (1, 4, 8, 16)  # S2's lanes timed against an earlier source


def _previous_lanes(torch, f, layout, libs, gen):
    """S2 (matmat, rmatmat) of one matrix at PREVIOUS_WIDTHS, each from a
    CUDA graph, in turns: this source, the earlier one, the earlier one,
    this source; and whether the two give the same bits."""
    from photon_ml_tpu_torch.ops import sparse

    library, out = sparse._library, {}
    try:
        for product, seg, n_seg, n_src in (("matmat", f.row_segments, f.n_rows, f.dim),
                                           ("rmatmat", f.col_segments, f.dim, f.n_rows)):
            name = f"{layout}_{product}"
            for L in PREVIOUS_WIDTHS:
                src = torch.randn((n_src, L), generator=gen, device="cuda")
                fn = lambda: sparse.segment_dot_lanes(name, seg, n_seg, src)  # noqa: E731
                runs, outs = {}, {}
                for v in ("segment", "previous", "previous", "segment"):
                    sparse._library = lambda lib=libs[v]: lib
                    outs.setdefault(v, fn())
                    runs.setdefault(v, []).append(graph_ms(torch, fn, 20))
                same = _same_bits(outs["segment"], outs["previous"])
                out[(name, L)] = {"runs": runs, "same_bits": same}
                log(f"  S2 {name:12s} L={L:2d} this source {min(runs['segment']):.4f} "
                    f"({'/'.join(f'{u:.4f}' for u in runs['segment'])}) ms, the previous "
                    f"{min(runs['previous']):.4f} ({'/'.join(f'{u:.4f}' for u in runs['previous'])}); same bits {same}")
                del src, outs
    finally:
        sparse._library = library
    return out



def segment_variants(torch, seed, batches=None, previous=None):
    """Each SEGMENT_VARIANTS entry built from its source and timed on the
    sparse shape's products (f32), each launch replayed from a CUDA graph,
    in turns: the variants in order, then in reverse. With ``previous``
    (the path of an earlier csrc/sparse_glm.cu with the same C interface)
    that source too, as the variant "previous", and S2 at PREVIOUS_WIDTHS
    in turns with it (segment, previous, previous, segment), its bits
    compared. Then ELL matvec over the same rows with their columns taken
    modulo each MATVEC_W_COLUMNS (a smaller w, the same gathers), in turns
    with the full d."""
    import ctypes
    import subprocess

    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import cuda_lib, sparse
    from photon_ml_tpu_torch.ops.features import batch_from_coo

    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, edits) in SEGMENT_VARIANTS.items():
        text = (cuda_lib.CSRC_DIR / f"{source}.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"segment variant {name}: the source no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
    sources = dict(SEGMENT_VARIANTS)
    if previous:
        (out_dir / "previous.cu").write_text(pathlib.Path(previous).read_text())
        sources["previous"] = ("sparse_glm", [])
    for name in sources:
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ref = sparse._library()
    libs = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on segment variant {name}:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        if sources[name][0] == "sparse_glm":
            for fn in ("segment_rows_launch", "segment_keys_launch"):
                getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
                getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = lib
    dev = torch.device("cuda")
    rows, cols, vals, y, _ = sparse_triplets(SPARSE_N, SPARSE_D, SPARSE_K, seed)
    if batches is None:
        raw = RawDataset(n_rows=SPARSE_N, labels=y, offsets=np.zeros(SPARSE_N), weights=np.ones(SPARSE_N),
                         shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": SPARSE_D}, id_tags={})
        batches = {layout: raw.to_batch("global", layout=layout) for layout in ("coo", "ell")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    library = sparse._library
    out = {}
    try:
        for layout, batch in batches.items():
            f = batch.features
            w = torch.randn(f.dim, generator=gen, device=dev)
            c = torch.randn(f.n_rows, generator=gen, device=dev)
            for name, (seg, n_seg, src, square) in _segment_calls(f, layout, c, w).items():
                if square:
                    continue
                design = warp_design(torch, seg, n_seg)
                runs = {}
                for v in list(libs) + list(libs)[::-1]:
                    if sources[v][0] == "sparse_glm":
                        sparse._library = lambda lib=libs[v]: lib
                        fn = lambda: sparse.segment_dot(name, seg, n_seg, src)  # noqa: E731
                    else:
                        fn = lambda lib=libs[v]: warp_segment_dot(torch, design, seg, n_seg, src, lib=lib)  # noqa: E731
                    runs.setdefault(v, []).append(graph_ms(torch, fn, 20))
                sparse._library = library
                out[name] = runs
                log(f"  segment variants {name:12s} " + "  ".join(
                    f"{v} {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})" for v, t in runs.items()) + " ms")
                del design
            if previous:
                out.update(_previous_lanes(torch, f, layout, libs, gen))
        # ELL matvec with a smaller w: the same rows, columns modulo d'
        mats = {SPARSE_D: batches["ell"].features}
        for dd in MATVEC_W_COLUMNS:
            mats[dd] = batch_from_coo(rows, cols % dd, vals, y, dd, layout="ell").features
        ws = {dd: torch.randn(dd, generator=gen, device=dev) for dd in mats}
        runs = {}
        for dd in list(mats) + list(mats)[::-1]:
            fn = lambda dd=dd: sparse.segment_dot("ell_matvec", mats[dd].row_segments, SPARSE_N, ws[dd])  # noqa: E731
            runs.setdefault(dd, []).append(graph_ms(torch, fn, 20))
        out["ell_matvec_by_w"] = {dd * 4: t for dd, t in runs.items()}
        log("  ell_matvec by the size of w: " + "  ".join(
            f"{dd * 4 / 1e6:.0f} MB {min(t):.4f} ({'/'.join(f'{u:.4f}' for u in t)})" for dd, t in runs.items()) + " ms")
        del mats, ws
    finally:
        sparse._library = library
        sparse.reset_launch_counts()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------- phase 9: sparse fixed effects
#
# bench.py's sparse configuration (bench_sparse_huge_d: n rows of k entries
# over d columns, uniform columns, values N(0, 0.3^2), labels from a
# logistic model of 1,000 hot columns), and its pairing with phase 5's
# random effect. Every sparse product is one launch of the segment kernel
# (csrc/sparse_glm.cu, ops/sparse.py).

SPARSE_N, SPARSE_D, SPARSE_K = 200_000, 10_000_000, 32
SPARSE_GLMIX_N = 500_000  # the GLMix pairing's rows (phase 5's n)
SPARSE_ITERS = 20  # bench.py's L-BFGS iterations on the sparse configuration
SPARSE_PRODUCTS = tuple(
    f"{layout}_{product}" for layout in ("coo", "ell") for product in ("matvec", "rmatvec", "sq_rmatvec")
)


def sparse_triplets(n, d, k, seed):
    """bench.py's bench_sparse_huge_d data from ``seed``: (rows, cols,
    vals, labels, hot-column logits)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k).astype(np.int64)
    cols = rng.integers(0, d, size=n * k).astype(np.int64)
    vals = (rng.normal(size=n * k) * 0.3).astype(np.float64)
    w_true = np.zeros(d)
    hot = rng.integers(0, d, size=1000)
    w_true[hot] = rng.normal(size=len(hot))
    logits = np.bincount(rows, weights=vals * w_true[cols], minlength=n)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return rows, cols, vals, y, logits


def ragged_triplets(n, d, seed):
    """A small ragged shape with a full column (3), an empty one (d - 1),
    empty rows and repeated (row, col) pairs, in a shuffled order."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 13, size=n)
    counts[::7] = 0
    rows = np.concatenate([np.repeat(np.arange(n), counts), np.arange(n)])
    cols = np.concatenate([rng.integers(0, d - 1, size=int(counts.sum())), np.full(n, 3)])
    pick = rng.integers(0, len(rows), size=len(rows) // 20 + 1)
    rows, cols = np.concatenate([rows, rows[pick]]), np.concatenate([cols, cols[pick]])
    order = rng.permutation(len(rows))
    return rows[order], cols[order], (rng.normal(size=len(rows)) * 0.3)[order], (rng.random(n) > 0.5) * 1.0


def _segment_calls(f, layout, src_rows, src_cols):
    """The three products of a matrix: name -> (segments, n_seg, src, square)."""
    return {
        f"{layout}_matvec": (f.row_segments, f.n_rows, src_cols, False),
        f"{layout}_rmatvec": (f.col_segments, f.dim, src_rows, False),
        f"{layout}_sq_rmatvec": (f.col_segments, f.dim, src_rows, True),
    }


def sparse_check(torch, seed, n, d, k):
    """(a) The segment kernel against its float64 plain version for all six
    products, ELL and COO, f32 and bf16 values, at the sparse shape and a
    small ragged one: max-abs error <= 3e-5 * max(|ref|, 1), and two
    launches give the same bits. Returns the max-abs errors at the sparse
    shape in f32, by product."""
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.features import batch_from_coo

    dev = torch.device("cuda")
    saved = dict(sparse.SPARSE_LAUNCHES)
    gen = torch.Generator(device=dev)
    shapes = {"sparse": sparse_triplets(n, d, k, seed)[:4] + (n, d), "ragged": ragged_triplets(5000, 3000, seed) + (
        5000, 3000)}
    bad, errs = [], {}
    for shape, (rows, cols, vals, y, nn, dd) in shapes.items():
        for layout in ("coo", "ell"):
            for fname in ("float32", "bfloat16"):
                f = batch_from_coo(rows, cols, vals, y, dd, layout=layout, feature_dtype=getattr(torch, fname)).features
                gen.manual_seed(seed + nn)
                w = torch.randn(dd, generator=gen, device=dev)
                c = torch.randn(nn, generator=gen, device=dev)
                for name, (seg, n_seg, src, square) in _segment_calls(f, layout, c, w).items():
                    a = sparse.segment_dot(name, seg, n_seg, src, square)
                    b = sparse.segment_dot(name, seg, n_seg, src, square)
                    torch.cuda.synchronize()
                    ref = sparse.segment_dot_plain(seg, n_seg, src.double(), square)
                    err = float((a.double() - ref).abs().max())
                    bound = 3e-5 * max(float(ref.abs().max()), 1.0)
                    same = _same_bits(a, b)
                    ok = err <= bound and same and bool(torch.isfinite(a).all())
                    log(f"  check segment kernel {shape:6s} {layout} {fname:8s} {name:15s} segments={n_seg} "
                        f"entries={seg.gather.shape[0]} err={err:.3e}/{bound:.3e} same bits twice={same} "
                        f"{'ok' if ok else 'MISS'}")
                    if not ok:
                        bad.append((shape, layout, fname, name))
                    if shape == "sparse" and fname == "float32":
                        errs[name] = err
                del f
        torch.cuda.empty_cache()
    sparse.SPARSE_LAUNCHES.update(saved)  # checks are not main-path launches
    if bad:
        raise AssertionError(f"the segment kernel disagrees with its float64 plain version on {bad}")
    return errs


def _sparse_problem(torch, optimizer, l1=0.0, variance_type="NONE"):
    from photon_ml_tpu_torch.game.problem import GLMOptimizationConfig, GLMProblem
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext

    return GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=optimizer, regularization=RegularizationContext("L1" if l1 else "L2"), reg_weight=l1 or 1.0,
        variance_type=variance_type,
    ))


def _counted_run(torch, problem, batch, plain=False):
    """A solve on the card with every counter at 0 before it: (model,
    result, wall seconds, sparse launches, dense launches, routes)."""
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse

    torch.cuda.synchronize()
    fg.reset_launch_counts()
    t0 = time.perf_counter()
    model, res = problem.run(batch, plain=plain)
    float(res.loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return model, res, wall, dict(sparse.SPARSE_LAUNCHES), dict(fg.LAUNCHES), dict(fg.OBJECTIVE_ROUTES)


# the segment kernel's device functions (csrc/sparse_glm.cu), as the
# profiler names them
S1_KERNELS = tuple(f"(anonymous namespace)::{k}" for k in (
    "row_group_kernel", "key_walk_kernel", "join_kernel", "zero_kernel"))


def _layout_arrays(f):
    return [t for t in (f.idx, f.val, f.coo_cols, f.coo_rows, f.coo_vals) if t is not None]


def companion_bytes(f):
    """Device bytes that a sparse ``FeatureMatrix`` holds for its products
    beyond its own arrays: the tensors of its row and column segments that
    are neither the layout's (idx/val, or the coo_* triplets) nor views of
    them, each counted once."""
    own = {t.untyped_storage().data_ptr() for t in _layout_arrays(f)}
    seen, total = set(), 0
    for seg in (f.row_segments, f.col_segments):
        for t in (seg.ptr, seg.gather, seg.val, seg.keys, seg.joins):
            if t is None:
                continue
            ptr = t.untyped_storage().data_ptr()
            if ptr not in own and ptr not in seen:
                seen.add(ptr)
                total += t.untyped_storage().nbytes()
    return total


def profile_sparse_solve(torch, layout, problem, batch):
    """One sparse L-BFGS solve under torch.profiler: device time by kernel
    name, the segment kernel's device time per launch inside the solve
    (where the L2 holds what the solver left there) and the card's busy
    share of the solve's wall."""
    (_, res, wall, launches, _, _), rows = device_profile(torch, lambda: _counted_run(torch, problem, batch))
    busy = log_profile(f"profiled {layout} L-BFGS solve ({res.iterations} iterations)", wall, rows, top=15)
    s1 = [r for r in rows if any(k in r[2] for k in S1_KERNELS)]
    s1_ms = sum(r[0] for r in s1) * 1e-3
    n = sum(launches.values())
    for us, count, key in s1:
        log(f"    S1 {key[:70]}: {us * 1e-3 / count:.4f} ms a launch over {count}")
    log(f"    S1 in the solve: {s1_ms:.4f} ms over {n} product launches, {s1_ms / max(n, 1):.4f} ms a product; "
        f"{s1_ms * 1e-3 / busy:.1%} of the device's busy time, {s1_ms * 1e-3 / wall:.1%} of the wall")
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall, "s1_ms": s1_ms, "s1_launches": n,
            "s1_ms_per_launch": s1_ms / max(n, 1),
            "by_kernel": [{"name": key, "ms": us * 1e-3, "count": count} for us, count, key in rows[:15]]}


def sparse_path(torch, seed, n, d, k):
    """(b) bench.py's sparse configuration at full size through
    RawDataset.to_batch (COO, then ELL) and GLMProblem.run: logistic loss,
    L-BFGS tol 1e-9 for SPARSE_ITERS iterations, L2 1.0. Each solve runs
    twice (the same bits), is held against the plain route on the card by
    loss (rtol 1e-5), and prints examples * iterations / s; then one OWL-QN
    solve (L1 1.0) on COO with SIMPLE variance (the COO Hessian diagonal
    once), held the same way, its variances at rtol 1e-3."""
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.optimize import OptimizerConfig

    t0 = time.perf_counter()
    rows, cols, vals, y, _ = sparse_triplets(n, d, k, seed)
    raw = RawDataset(n_rows=n, labels=y, offsets=np.zeros(n), weights=np.ones(n),
                     shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": d}, id_tags={})
    log(f"  sparse data n={n} d={d} k={k} made in {time.perf_counter() - t0:.1f}s")
    lbfgs = OptimizerConfig(tolerance=1e-9, max_iterations=SPARSE_ITERS)
    problems, report, batches = [], {"launches": {}}, {}
    for layout in ("coo", "ell"):
        t0 = time.perf_counter()
        batch = raw.to_batch("global", layout=layout)
        torch.cuda.synchronize()
        cb = companion_bytes(batch.features)
        report.setdefault("companion_bytes", {})[layout] = cb
        log(f"  {layout} batch (with its segments) built in {time.perf_counter() - t0:.1f}s; companions "
            f"{cb / 1e6:.1f} MB beside the layout's {sum(t.numel() * t.element_size() for t in _layout_arrays(batch.features)) / 1e6:.1f} MB")
        problem = _sparse_problem(torch, lbfgs)
        _counted_run(torch, problem, batch)  # loads PyTorch's lazily loaded kernels
        model, res, wall, launches, dense, routes = _counted_run(torch, problem, batch)
        model2, res2, wall2, *_ = _counted_run(torch, problem, batch)
        _, res_p, wall_p, launches_p, _, routes_p = _counted_run(torch, problem, batch, plain=True)
        loss, loss_p = float(res.loss), float(res_p.loss)
        rel = abs(loss - loss_p) / abs(loss_p)
        same = _same_bits(model.coefficients.means, model2.coefficients.means) and _same_bits(res.loss, res2.loss)
        rate = n * res.iterations / min(wall, wall2)
        log(f"  {layout} L-BFGS kernels: iterations={res.iterations} reason={res.reason} loss={loss:.6f} "
            f"wall_s={wall:.4f}/{wall2:.4f} syncs={res.syncs} examples*iterations/s={rate:.1f} launches={launches} "
            f"routes={ {r: v for r, v in routes.items() if v} }; plain: iterations={res_p.iterations} "
            f"loss={loss_p:.6f} wall_s={wall_p:.4f} launches={sum(launches_p.values())}; loss rel diff {rel:.2e} "
            f"(rtol 1e-5); same bits on two runs: {same}")
        if launches[f"{layout}_matvec"] <= 0 or launches[f"{layout}_rmatvec"] <= 0:
            problems.append(f"{layout}: the solve did not run through the segment kernel: {launches}")
        if routes["sparse_kernel"] != 1 or routes["plain_float64"] or routes["plain_cpu"] or any(dense.values()):
            problems.append(f"{layout}: a plain or dense route ran on the kernel path: {routes} {dense}")
        if any(launches_p.values()) or routes_p["sparse_kernel"]:
            problems.append(f"{layout}: the plain solve launched the kernel")
        if not (rel <= 1e-5 and same and math.isfinite(loss)):
            problems.append(f"{layout}: loss rel diff {rel:.2e} vs plain, same bits {same}")
        report["launches"] = {p: report["launches"].get(p, 0) + v for p, v in launches.items()}
        report[layout] = {"iterations": res.iterations, "wall_s": min(wall, wall2), "examples_iters_per_s": rate,
                          "loss": loss, "plain_loss": loss_p, "syncs": res.syncs,
                          "profile": profile_sparse_solve(torch, layout, problem, batch)}
        batches[layout] = batch
    # OWL-QN on the COO batch, with SIMPLE variance: the COO Hessian
    # diagonal (coo_sq_rmatvec) once
    problem = _sparse_problem(torch, lbfgs, l1=1.0, variance_type="SIMPLE")
    batch = batches["coo"]
    model, res, wall, launches, _, _ = _counted_run(torch, problem, batch)
    model_p, res_p, _, _, _, _ = _counted_run(torch, problem, batch, plain=True)
    nnz = int((model.coefficients.means != 0).sum())
    rel = abs(float(res.loss) - float(res_p.loss)) / abs(float(res_p.loss))
    var, var_p = model.coefficients.variances, model_p.coefficients.variances
    var_err = float(((var - var_p).abs() / var_p.abs()).max())
    log(f"  coo OWL-QN (L1 1.0): iterations={res.iterations} reason={res.reason} loss={float(res.loss):.6f} "
        f"nonzeros={nnz} of {d} wall_s={wall:.4f} launches={launches}; plain loss {float(res_p.loss):.6f}, "
        f"rel diff {rel:.2e} (rtol 1e-5); variances max rel diff {var_err:.2e} (rtol 1e-3)")
    if not rel <= 1e-5 or launches["coo_matvec"] <= 0 or launches["coo_sq_rmatvec"] != 1 or not var_err <= 1e-3:
        problems.append(f"OWL-QN: loss rel diff {rel:.2e} vs plain, variances {var_err:.2e}, launches {launches}")
    report["launches"] = {p: report["launches"].get(p, 0) + v for p, v in launches.items()}
    report["owlqn"] = {"nonzeros": nnz, "iterations": res.iterations, "loss": float(res.loss)}
    if problems:
        raise AssertionError("; ".join(problems))
    report["batches"] = batches
    return report


def sparse_glmix_data(n, d, k, users, d_re, seed):
    """The GLMix pairing: bench.py's sparse rows (k entries over d columns)
    as the global shard and build_data's Zipf(1.1) users with d_re
    per-user features, labels from a logistic model of both."""
    rows, cols, vals, _, z = sparse_triplets(n, d, k, seed)
    rng = np.random.default_rng(seed + 1)
    probs = 1.0 / np.arange(1, users + 1) ** 1.1
    assign = rng.choice(users, size=n, p=probs / probs.sum())
    ex = rng.standard_normal((n, d_re), dtype=np.float32)
    ex[:, -1] = 1.0
    w_u = (rng.standard_normal((users, d_re)) / np.sqrt(d_re)).astype(ex.dtype)
    z = z + np.einsum("nd,nd->n", ex, w_u[assign])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    ids = np.char.add("u", assign.astype(str)).astype(object)
    raw_kw = dict(n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
                  shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": d}, id_tags={})
    return raw_kw, (None, y, ex, ids)


def sparse_glmix(torch, seed, n, d, k, users, d_re):
    """(c) Phase 5's sweep with its global shard sparse: n rows of k entries
    over d columns, build_fixed_effect_dataset(layout="auto") picks ELL;
    FE TRON tol 1e-6, 10 iterations, L2 1.0, SIMPLE variance; RE phase 5's.
    One warm-up sweep, then SWEEPS timed ones (the median), counters at 0
    before them and read after; held against the same sweep on the plain
    route on the card at phase 5's bounds."""
    from photon_ml_tpu_torch.game import build_fixed_effect_dataset
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse

    t0 = time.perf_counter()
    raw_kw, data = sparse_glmix_data(n, d, k, users, d_re, seed)
    fe_ds = build_fixed_effect_dataset(RawDataset(**raw_kw), "global", "global", layout="auto")
    coords = glmix_coordinates(data, torch.device("cuda"), fe_dataset=fe_ds)
    log(f"  sparse GLMix data + datasets built in {time.perf_counter() - t0:.1f}s: n={n} d={d} k={k} "
        f"layout={fe_ds.batch.features.layout} users={users} d_re={d_re}")
    problems = []
    if fe_ds.batch.features.layout != "ell":
        problems.append(f"layout auto picked {fe_ds.batch.features.layout}, not ell")
    sweep(torch, coords)
    fg.reset_launch_counts()
    runs = [sweep(torch, coords) for _ in range(SWEEPS)]
    launches, dense, routes = dict(sparse.SPARSE_LAUNCHES), dict(fg.LAUNCHES), dict(fg.OBJECTIVE_ROUTES)
    same = all(_same_bits(r.model["global"].coefficients.means, runs[0][0].model["global"].coefficients.means)
               for r, _ in runs)
    res, wall = sorted(runs, key=lambda rw: rw[1])[len(runs) // 2]
    walls = [w for _, w in runs]
    a, _ = training_auc(coords, res)
    fe_r = res.solver_results["global"]
    log(f"  sparse GLMix sweep (kernels), median of {SWEEPS}: wall_s={wall:.4f} examples_per_s={n / wall:.1f} "
        f"(walls {', '.join(f'{w:.4f}' for w in walls)}) shares FE={res.seconds['global'] / wall:.3f} "
        f"RE={res.seconds['per-user'] / wall:.3f} syncs={res.syncs} launches={launches} routes="
        f"{ {r: v for r, v in routes.items() if v} } train_auc={a:.6f}; FE iterations={fe_r.iterations} "
        f"reason={fe_r.reason} loss={float(fe_r.loss):.6f}; FE bits equal over the sweeps: {same}")
    if min(launches["ell_matvec"], launches["ell_rmatvec"]) <= 0 or launches["ell_sq_rmatvec"] != SWEEPS:
        problems.append(f"the sparse sweep did not run the segment kernel as expected: {launches}")
    if routes["sparse_kernel"] != SWEEPS or routes["plain_float64"] or routes["plain_cpu"] or any(dense.values()):
        problems.append(f"a plain or dense route ran on the sparse sweep: {routes} {dense}")
    var = res.model["global"].coefficients.variances
    if var is None or not bool(torch.isfinite(var).all()) or not bool((var > 0).all()):
        problems.append("SIMPLE variances missing, non-finite or not positive")
    if not (0.5 < a <= 1.0):
        problems.append(f"training AUC {a} out of (0.5, 1]")
    plain = dict(coords, **{"global": dataclasses.replace(coords["global"], plain=True)})
    fg.reset_launch_counts()
    res_p, wall_p = sweep(torch, plain)
    log(f"  sparse GLMix sweep (plain): wall_s={wall_p:.4f} launches={sum(sparse.SPARSE_LAUNCHES.values())}")
    if any(sparse.SPARSE_LAUNCHES.values()):
        problems.append("the plain sweep launched the segment kernel")
    hold_sweeps(problems, "sparse kernel vs plain sweep:", res, res_p, retrain_re(coords, res, plain))
    if problems:
        raise AssertionError("; ".join(problems))
    return {"launches": launches, "wall_s": wall, "walls": walls, "examples_per_s": n / wall,
            "fe_share": res.seconds["global"] / wall, "re_share": res.seconds["per-user"] / wall,
            "syncs": res.syncs, "train_auc": a}


def sparse_phase(torch, seed, users, d_re):
    out = {"errors": sparse_check(torch, seed, SPARSE_N, SPARSE_D, SPARSE_K)}
    out["path"] = sparse_path(torch, seed, SPARSE_N, SPARSE_D, SPARSE_K)
    torch.cuda.empty_cache()
    out["glmix"] = sparse_glmix(torch, seed, SPARSE_GLMIX_N, SPARSE_D, SPARSE_K, users, d_re)
    return out


def time_sparse(torch, seed, batches=None):
    """Phase 7's row for the segment kernel: each product at the sparse
    shape (f32 values), CUDA events over 20 launches after 3, two rounds,
    and replayed from a CUDA graph (the earlier design's turns,
    ``warp_segment_dot``, left the script to make room for phase 17 (f):
    ``--only variants`` still builds and times it), beside its bound
    (``segment_bytes``'s function bytes over 3.35 TB/s, or its operations;
    the design's bytes and the worst case of a sector per gather beside),
    its plain version, index_add_ (the gather, the product and an atomic
    float32 index_add_, three launches) and one cuSPARSE CSR SpMV through
    torch.sparse computing the same product (library_ms)."""
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.features import batch_from_coo

    dev = torch.device("cuda")
    rows, cols, vals, y, _ = sparse_triplets(SPARSE_N, SPARSE_D, SPARSE_K, seed)
    if batches is None:
        raw = RawDataset(n_rows=SPARSE_N, labels=y, offsets=np.zeros(SPARSE_N), weights=np.ones(SPARSE_N),
                         shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": SPARSE_D}, id_tags={})
        batches = {layout: raw.to_batch("global", layout=layout) for layout in ("coo", "ell")}
    # the same rows with an intercept column (d - 1, 1.0 in every row): one
    # segment of n entries in rmatvec, a skewed case the main path lacks
    every = np.arange(SPARSE_N)
    batches = dict(batches, skewed=batch_from_coo(
        np.concatenate([rows, every]), np.concatenate([cols, np.full(SPARSE_N, SPARSE_D - 1)]),
        np.concatenate([vals, np.ones(SPARSE_N)]), y, SPARSE_D, layout="coo"))
    saved = dict(sparse.SPARSE_LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    out = {}
    for layout, batch in batches.items():
        f = batch.features
        w = torch.randn(f.dim, generator=gen, device=dev)
        c = torch.randn(f.n_rows, generator=gen, device=dev)
        calls = _segment_calls(f, f.layout, c, w)
        if layout == "skewed":
            calls = {"coo_rmatvec": calls["coo_rmatvec"]}
        for name, (seg, n_seg, src, square) in calls.items():
            key = name if layout != "skewed" else f"{name}_with_intercept"
            n_src = src.shape[0]
            ids = seg.segment_ids(n_seg)
            gather = seg.gather.long()
            val = seg.val * seg.val if square else seg.val
            if seg.keys is not None:  # the key form's CSR pointers, for the library call
                ptr = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
                ptr[1:] = torch.cumsum(torch.bincount(ids, minlength=n_seg), 0)
            else:
                ptr = seg.ptr if seg.ptr is not None else torch.arange(n_seg + 1, device=dev) * seg.seg_len
            library = lambda: torch.mv(csr, src)  # noqa: E731
            with warnings.catch_warnings():  # torch marks its sparse CSR tensors beta
                warnings.simplefilter("ignore")
                csr = torch.sparse_csr_tensor(ptr.to(torch.int32), seg.gather, val, size=(n_seg, n_src))
                library()
            acc = torch.empty(n_seg, device=dev)

            def by_index_add():
                acc.zero_()
                return acc.index_add_(0, ids, src[gather] * val)

            kern = lambda: sparse.segment_dot(name, seg, n_seg, src, square)  # noqa: E731
            plain = lambda: sparse.segment_dot_plain(seg, n_seg, src, square)  # noqa: E731
            lib_err = float((library().double() - plain().double()).abs().max())
            runs = {key: [] for key in ("ms", "plain_ms", "index_add_ms", "library_ms")}
            for _ in range(2):  # two rounds, each in turns: plain, library, index_add_, kernel, kernel
                runs["plain_ms"].append(time_ms(torch, plain, 5))
                runs["library_ms"].append(time_ms(torch, library, 20))
                runs["index_add_ms"].append(time_ms(torch, by_index_add, 20))
                runs["ms"].append(time_ms(torch, kern, 20))
                runs["ms"].append(time_ms(torch, kern, 20))
            # the kernels alone, replayed from a CUDA graph (no host launch time)
            graph = {"graph_ms": graph_ms(torch, kern, 20)}
            nbytes = segment_bytes(seg, n_seg, n_src)
            ops = segment_flops(seg, square)
            t_bytes, t_ops = nbytes["function"] / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3
            row = {key: min(v) for key, v in runs.items()}
            row.update({f"{key}_runs": v for key, v in runs.items()})
            row.update(graph)
            row.update({"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "design_bound_ms": nbytes["design"] / HBM_BYTES_PER_S * 1e3,
                        "sector_ms": nbytes["sectors"] / HBM_BYTES_PER_S * 1e3,
                        "bytes": nbytes["function"], "design_bytes": nbytes["design"],
                        "sector_bytes": nbytes["sectors"], "ops": ops, "segments": n_seg,
                        "entries": seg.gather.shape[0], "library_max_abs_diff": lib_err,
                        "form": "keys" if seg.keys is not None else f"row groups of {seg.group}"})
            out[key] = row
            log(f"  time segment kernel {key:15s} ({row['form']}) segments={n_seg} entries={seg.gather.shape[0]}: "
                f"kernel {'/'.join(f'{t:.4f}' for t in runs['ms'])} ms (graph {row['graph_ms']:.4f})  "
                f"plain {'/'.join(f'{t:.4f}' for t in runs['plain_ms'])} "
                f"ms  index_add_ (gather, product, atomic add) {'/'.join(f'{t:.4f}' for t in runs['index_add_ms'])} ms  "
                f"cuSPARSE CSR SpMV (torch.mv on a sparse CSR tensor) "
                f"{'/'.join(f'{t:.4f}' for t in runs['library_ms'])} ms (max abs diff {lib_err:.2e})  "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {nbytes['function']} B): "
                f"{row['bound_ms'] / row['ms']:.1%} of it; with the design's own bytes "
                f"{row['design_bound_ms']:.4f} ms ({nbytes['design']} B): "
                f"{row['design_bound_ms'] / row['ms']:.1%}; "
                f"a sector per gather (worst case, not a bound) {row['sector_ms']:.4f} ms")
            del csr, ids, gather, acc
        torch.cuda.empty_cache()
    sparse.SPARSE_LAUNCHES.update(saved)
    return out


# The segment kernel's earlier design (csrc/sparse_glm_warp.cu: a warp per
# 32 segments, int64 pointers over every segment, a chunk plan for the
# segments over WARP_CHUNK entries), timed as a variant in phase 8 (--only
# variants; phase 7 no longer times it in turns). Nothing on the main path
# calls it.
WARP_CHUNK = 4096


def warp_design(torch, seg, n_seg):
    """The earlier design's companions of a product: its int64 pointers
    (none for the uniform ELL rows) and the chunk plan of its segments over
    WARP_CHUNK entries, over ``seg``'s entries, gather and values."""
    dev = seg.gather.device
    uniform = seg.keys is None and seg.ptr is None
    counts = np.full(n_seg, seg.seg_len) if uniform else np.bincount(
        seg.segment_ids(n_seg).cpu().numpy(), minlength=n_seg)
    long_ids = np.flatnonzero(counts > WARP_CHUNK)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    ptr = None
    if not uniform or long_ids.size:
        ptr = to(np.concatenate([[0], np.cumsum(counts)]).astype(np.int64))
    plan = None
    if long_ids.size:
        n_chunks = -(-counts[long_ids] // WARP_CHUNK)
        plan = (to(long_ids.astype(np.int64)), to(np.concatenate([[0], np.cumsum(n_chunks)]).astype(np.int64)),
                to(np.repeat(np.arange(long_ids.size, dtype=np.int32), n_chunks)))
    return {"ptr": ptr, "seg_len": seg.seg_len if uniform and not long_ids.size else 0, "plan": plan,
            "bytes": (0 if ptr is None else 8 * (n_seg + 1)) + (0 if plan is None else (
                8 * long_ids.size + 8 * (long_ids.size + 1) + (4 + 16) * int(plan[2].shape[0])))}


def warp_segment_dot(torch, design, seg, n_seg, src, square=False, lib=None):
    """One launch of the earlier design (and of its chunk finalize where it
    has a plan) over ``design`` = ``warp_design(...)``: float32 out; ``lib``
    a variant's library (phase 8) in place of csrc/sparse_glm_warp.cu's."""
    import ctypes

    from photon_ml_tpu_torch.ops import cuda_lib

    lib = lib or cuda_lib.load("sparse_glm_warp")
    if lib.segment_dot_warp_launch.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.segment_dot_warp_launch.argtypes = [i, i, p, ll, ll, p, p, p, p, ll, ll, ll, p, p, p, p, p]
        lib.segment_dot_warp_launch.restype = i
    out = torch.empty(n_seg, dtype=torch.float32, device=src.device)
    plan = design["plan"]
    long_ids, chunk_first, owner = plan if plan is not None else (None, None, None)
    n_chunks = 0 if plan is None else owner.shape[0]
    partial = torch.empty(n_chunks, dtype=torch.float64, device=src.device)
    addr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.segment_dot_warp_launch(
        int(seg.val.dtype == torch.bfloat16), int(square), addr(design["ptr"]), design["seg_len"], n_seg,
        seg.gather.data_ptr(), seg.val.data_ptr(), src.data_ptr(), out.data_ptr(),
        WARP_CHUNK if plan is not None else 0, n_chunks, 0 if plan is None else long_ids.shape[0], addr(owner),
        addr(chunk_first), addr(long_ids), addr(partial) if n_chunks else None,
        torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the earlier segment design failed over {n_seg} segments: CUDA error {rc}")
    return out


# ------------------------------------------------------- phase 10: solvers
#
# The solver and variance surface at full width: phase 5's sweep with the
# fixed effect's FULL variance and a TRON random effect, a down-sampled
# fixed-effect solve, bench.py's billion-coefficient slice through the
# packed and the vmapped random-effect solves, and the FULL factorization's
# ceiling on the card.

BILLION_SLICE = (32_768, 16, 256)  # bench.py bench_billion_coef: entities, rows, subspace dim
BILLION_PREFIX = 4_096  # entities of the slice solved alone for the bitwise check
CEILING_DIMS = (16_384, 32_768, 65_536)  # FULL widths of (c)
CEILING_ROWS = 4_096  # rows of (c)'s batches
DOWN_SAMPLING_RATE = 0.5


def _timed(torch, fn):
    """(fn(), wall seconds on the host clock between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _float64_full_variances(torch, batch, coef, l2):
    """FULL variances from a float64 Hessian built here, not by the port:
    logistic curvature from float64 margins, X^T diag(c) X in row chunks,
    plus l2 I; diag of its inverse through a float64 Cholesky."""
    x = batch.features.dense
    n, d = x.shape
    c64 = coef.double()
    h = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    for lo in range(0, n, 65536):
        xc = x[lo : lo + 65536].double()
        p = torch.sigmoid(xc @ c64 + batch.offsets[lo : lo + 65536].double())
        c = batch.weights[lo : lo + 65536].double() * p * (1 - p)
        h += xc.T @ (c[:, None] * xc)
    h += l2 * torch.eye(d, dtype=torch.float64, device=x.device)
    return torch.diagonal(torch.cholesky_inverse(torch.linalg.cholesky(h)))


def solver_sweep(torch, state, seed):
    """(a) phase 5's sweep with FULL variance (B1, B2; B3 at 0) and a TRON
    random effect, against the plain route; FULL's seconds at d = 1,024 and
    its variances against a float64 Hessian; a down-sampled FE solve."""
    from photon_ml_tpu_torch.game import GLMProblem
    from photon_ml_tpu_torch.game.coordinate import _size_buckets
    from photon_ml_tpu_torch.game.sampling import down_sample
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.glm import _diag_of_inverse
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType

    base = state["coords"]
    fe = dataclasses.replace(base["global"], config=dataclasses.replace(base["global"].config, variance_type="FULL"))
    re_cfg = dataclasses.replace(base["per-user"].config, optimizer=OptimizerConfig(
        optimizer_type=OptimizerType.TRON, tolerance=1e-6, max_iterations=30, max_cg_iterations=20))
    coords = {"global": fe, "per-user": dataclasses.replace(base["per-user"], config=re_cfg)}
    batch = fe.dataset.batch
    n = batch.n_rows
    buckets = len(_size_buckets(coords["per-user"].dataset) or [None])

    sweep(torch, coords)
    fg.reset_launch_counts()
    runs = sorted((sweep(torch, coords) for _ in range(SWEEPS)), key=lambda rw: rw[1])
    launches = dict(fg.LAUNCHES)
    res, wall = runs[len(runs) // 2]
    walls = [w for _, w in runs]
    a, _ = training_auc(coords, res)
    lb = state["result"]
    re_r = res.solver_results["per-user"]
    log(f"  (a) FE TRON + FULL, RE TRON, median of {SWEEPS}: wall_s={wall:.4f} examples_per_s={n / wall:.1f} "
        f"(walls {', '.join(f'{w:.4f}' for w in walls)}) shares FE={res.seconds['global'] / wall:.3f} "
        f"RE={res.seconds['per-user'] / wall:.3f} syncs={res.syncs} launches={launches} train_auc={a:.6f}")
    log(f"  phase 5 in this run (FE SIMPLE, RE L-BFGS): wall_s={state['wall_s']:.4f} "
        f"examples_per_s={n / state['wall_s']:.1f}; RE syncs per bucket over {buckets} buckets: "
        f"TRON {res.syncs['per-user'] / buckets:.1f}, L-BFGS {lb.syncs['per-user'] / buckets:.1f}; "
        f"RE TRON lanes={int(re_r.loss.shape[0])} max_iterations={int(re_r.iterations.max())} "
        f"reasons={torch.bincount(re_r.reason.cpu().long(), minlength=6).tolist()}")
    problems = []
    if min(launches["fused_value_grad"], launches["fused_hessian_vector"]) <= 0:
        problems.append(f"B1 or B2 was not launched in the FULL sweep: {launches}")
    if launches["fused_hessian_stats"] != 0:
        problems.append(f"B3 launched {launches['fused_hessian_stats']} times in the FULL sweep")
    if res.rejections != {"global": 0, "per-user": 0}:
        problems.append(f"the divergence guard rejected an update: {res.rejections}")
    if not (0.5 < a <= 1.0):
        problems.append(f"training AUC {a} out of (0.5, 1]")
    if not bool((re_r.reason != 0).all()) or not bool(torch.isfinite(re_r.loss).all()):
        problems.append("a TRON random-effect lane did not finish, or its loss is not finite")

    # FULL's two steps at d = 1,024, and its variances against float64
    model = res.model["global"].coefficients
    obj = GLMProblem(fe.task, fe.config).objective(batch)
    h, t_h = _timed(torch, lambda: obj.hessian_matrix(model.means))
    var, t_inv = _timed(torch, lambda: _diag_of_inverse(h))
    log(f"  FULL variance at n={n}, d={batch.dim}: hessian_matrix {t_h:.4f} s, _diag_of_inverse {t_inv:.4f} s")
    if not torch.equal(var, model.variances):
        problems.append("FULL variances recomputed from the sweep's model differ from the sweep's")
    var64 = _float64_full_variances(
        torch, batch, model.means, fe.config.regularization.l2_weight(fe.config.reg_weight)
    )
    hold(problems, "FULL variances vs a float64 Hessian", var, var64, 1e-3, 0.0)
    del h, var64

    plain = dict(coords, **{"global": dataclasses.replace(fe, plain=True)})
    fg.reset_launch_counts()
    res_p, wall_p = sweep(torch, plain)
    log(f"  (a) plain route: wall_s={wall_p:.4f} launches={dict(fg.LAUNCHES)}")
    if any(fg.LAUNCHES.values()):
        problems.append("the plain sweep launched a kernel")
    hold_sweeps(problems, "FULL + TRON kernel vs plain sweep:", res, res_p, retrain_re(coords, res, plain))
    del plain, res_p

    # a down-sampled solve (variance NONE: FULL is timed above)
    ds = dataclasses.replace(fe, config=dataclasses.replace(
        fe.config, down_sampling_rate=DOWN_SAMPLING_RATE, variance_type="NONE"), down_sampling_seed=seed)
    kept = down_sample(batch, ds.task, DOWN_SAMPLING_RATE, seed).weights
    fg.reset_launch_counts()
    (_, r_ds), t_ds = _timed(torch, lambda: ds.train(None))
    ds_launches = dict(fg.LAUNCHES)
    _, r_dp = dataclasses.replace(ds, plain=True).train(None)
    l_k, l_p, l_full = float(r_ds.loss), float(r_dp.loss), float(res.solver_results["global"].loss)
    rel = abs(l_k - l_p) / abs(l_p)
    log(f"  down-sampled FE (rate {DOWN_SAMPLING_RATE}, seed {seed}, mask drawn on {kept.device}): rows kept "
        f"{int((kept != 0).sum())} of {n}, weight sum {float(kept.sum()):.1f}; wall_s={t_ds:.4f} "
        f"iterations={r_ds.iterations} launches={ds_launches}; loss {l_k:.6f} vs plain {l_p:.6f} rel diff "
        f"{rel:.2e} (rtol 1e-5) {'ok' if rel <= 1e-5 else 'MISS'}; the full-rate FE loss {l_full:.6f}")
    if rel > 1e-5:
        problems.append(f"the down-sampled solve and its plain route disagree ({rel:.2e})")
    if min(ds_launches["fused_value_grad"], ds_launches["fused_hessian_vector"]) <= 0:
        problems.append(f"the down-sampled solve did not run B1 and B2: {ds_launches}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {
        "launches": launches, "wall_s": wall, "walls": walls, "examples_per_s": n / wall,
        "fe_share": res.seconds["global"] / wall, "re_share": res.seconds["per-user"] / wall,
        "syncs": res.syncs, "re_syncs_per_bucket": res.syncs["per-user"] / buckets,
        "lbfgs_re_syncs_per_bucket": lb.syncs["per-user"] / buckets, "hessian_s": t_h, "inverse_s": t_inv,
        "down_sampled_s": t_ds,
    }


def _entity_gap(torch, a, b):
    """(max abs coefficient difference, max abs loss difference, entities
    whose results differ in any bit) between two entity-major results."""
    differ = (a.coefficients != b.coefficients).any(dim=1) | (a.loss != b.loss) | (a.iterations != b.iterations)
    return (float((a.coefficients - b.coefficients).abs().max()), float((a.loss - b.loss).abs().max()),
            int(differ.sum()))


def billion_slice(torch, seed):
    """(b) bench.py's bench_billion_coef slice: the packed and the vmapped
    solves, L-BFGS then TRON, held per entity at the packed solve's bounds;
    the vmapped solve of the first BILLION_PREFIX entities alone against
    the same entities within the slice, bit for bit."""
    from photon_ml_tpu_torch.game.coordinate import _train_blocks, _train_blocks_packed
    from photon_ml_tpu_torch.ops import lane_reduce as lr

    E, K, S = BILLION_SLICE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    feats = torch.randn((E, K, S), generator=gen, device=dev) * 0.3
    y = (torch.rand((E, K), generator=gen, device=dev) < 0.5).float()
    args = (feats, y, torch.zeros((E, K), device=dev), torch.ones((E, K), device=dev),
            torch.zeros((E, S), device=dev), torch.zeros((E, S), device=dev), torch.ones((E, S), device=dev))
    log(f"  (b) slice E={E} K={K} S={S}: features {feats.numel() * 4 / 1e6:.1f} MB, {E * S} coefficients")
    problems, out = [], {}
    for opt in ("LBFGS", "TRON"):
        kw = dict(task="logistic_regression", l2=1.0, l1=0.0, optimizer_type=opt, tolerance=1e-6,
                  max_iterations=30, num_corrections=10, max_cg_iterations=20, max_improvement_failures=5)
        for fn in (_train_blocks_packed, _train_blocks):  # PyTorch's lazily loaded kernels
            fn(*(a[:64] for a in args), **kw)
        rp, t_p = _timed(torch, lambda: _train_blocks_packed(*args, **kw))
        lr.reset_launch_counts()
        rv, t_v = _timed(torch, lambda: _train_blocks(*args, **kw))
        lane_launches = dict(lr.LANE_LAUNCHES)
        log(f"  (b) {opt} vmapped: V1 launches {lane_launches} (the vmapped walls before V1, NVIDIA H100 80GB "
            f"HBM3 at 700 W: L-BFGS 0.222-0.262 s, TRON 0.098-0.103 s)")
        if min(lane_launches.values()) <= 0:
            problems.append(f"(b) {opt}: the vmapped solve did not launch V1 on both axes: {lane_launches}")
        for name, r, t in (("packed", rp, t_p), ("vmapped", rv, t_v)):
            log(f"  (b) {opt} {name}: wall_s={t:.4f} coefficients_per_s={E * S / t:.1f} syncs={r.syncs} "
                f"max_iterations={int(r.iterations.max())} "
                f"reasons={torch.bincount(r.reason.cpu().long(), minlength=6).tolist()}")
        hold(problems, f"(b) {opt} packed vs vmapped coefficients", rp.coefficients, rv.coefficients, 0.0, 5e-3)
        hold(problems, f"(b) {opt} packed vs vmapped loss", rp.loss, rv.loss, 0.0, 1e-4)
        out[opt] = {"packed_s": t_p, "vmapped_s": t_v, "packed_syncs": rp.syncs, "vmapped_syncs": rv.syncs,
                    "lane_launches": lane_launches}
        # the BILLION_PREFIX entities, then smaller stacks: one entity, and
        # eleven from the middle
        for label, rows in ((f"the first {BILLION_PREFIX} entities", slice(0, BILLION_PREFIX)),
                            ("entity 0", slice(0, 1)), ("entities 1000-1010", slice(1000, 1011))):
            alone = _train_blocks(*(a[rows] for a in args), **kw)
            within = dataclasses.replace(rv, **{f: getattr(rv, f)[rows] for f in (
                "coefficients", "loss", "gradient", "iterations", "reason", "loss_history", "grad_norm_history")})
            coef_gap, loss_gap, n_diff = _entity_gap(torch, alone, within)
            log(f"  (b) {opt} vmapped, {label} alone vs within the slice: "
                f"{'bitwise equal' if n_diff == 0 else f'BITS DIFFER for {n_diff} entities'} (max abs diff "
                f"coefficients {coef_gap:.3e}, loss {loss_gap:.3e})")
            if n_diff:
                problems.append(f"(b) {opt}: the vmapped solve of {label} alone differs from the slice's in "
                                f"{n_diff} entities (ROADMAP C7)")
            out[opt].setdefault("alone_bitwise", {})[label] = n_diff == 0
            if rows.start == 0 and rows.stop == BILLION_PREFIX:
                out[opt].update(prefix_bitwise=n_diff == 0, prefix_entities_differ=n_diff,
                                prefix_coef_gap=coef_gap, prefix_loss_gap=loss_gap)
            del alone, within
        del rp, rv
    del args, feats, y
    torch.cuda.empty_cache()
    # V1's call forms: where torch.sum's bits depend on the stack and V1's
    # do not; V1's times at this shape
    X, w, c, g = lane_inputs(torch, seed, dev)
    if lane_op_diagnostic(torch, X, w, c, g, (("entity 0", slice(0, 1)), ("entities 1000-1010", slice(1000, 1011)))):
        problems.append("(b) V1's sums over a small stack differ from the whole slice's")
    out["lane_times"] = time_lane_reduce(torch, X, w, c, g)
    del X, w, c, g
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def full_ceiling(torch, seed):
    """(c) compute_variances("FULL") end to end, the Hessian's build
    included, on a logistic batch of CEILING_ROWS random rows at each
    CEILING_DIMS width, float32 and float64 (the float64 route, plain):
    seconds, the peak of device memory allocated and the part the call
    added; variances finite, in (0, 1/l2], float32 against float64 at rtol
    1e-3. The port's MAX_FULL_VARIANCE_DIM must be the largest d measured,
    and one column more must raise the ValueError."""
    from photon_ml_tpu_torch.ops import glm
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.ops.losses import LOSSES

    dev = torch.device("cuda")
    out, problems = {}, []
    for d in CEILING_DIMS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + d)
        x = torch.randn((CEILING_ROWS, d), generator=gen, device=dev) * 0.1
        y = (torch.rand(CEILING_ROWS, generator=gen, device=dev) < 0.5).float()
        got = {}
        for dt in (torch.float32, torch.float64):
            obj = glm.GLMObjective(loss=LOSSES["logistic"], batch=batch_from_dense(x, y, dtype=dt, device=dev),
                                   l2=1.0, plain=dt == torch.float64)
            w = torch.zeros(d, dtype=dt, device=dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            try:
                var, secs = _timed(torch, lambda: glm.compute_variances(obj, w, "FULL"))
                err = ""
            except torch.cuda.OutOfMemoryError as e:
                var, secs, err = None, float("nan"), f"out of memory: {str(e).splitlines()[0]}"
            peak = torch.cuda.max_memory_allocated()
            ok = var is not None and bool(torch.isfinite(var).all()) and bool(((var > 0) & (var <= 1.0)).all())
            name = str(dt).replace("torch.", "")
            log(f"  (c) compute_variances FULL n={CEILING_ROWS} d={d} {name}: {secs:.3f} s, peak allocated "
                f"{peak / 2**30:.2f} GiB, of which {(peak - before) / 2**30:.2f} GiB by the call (the batch and "
                f"the rest of this run, {before / 2**30:.2f} GiB, held before it); variances finite in (0, 1]: "
                f"{ok}{' ' + err if err else ''}")
            out[f"{d}_{name}"] = {"d": d, "dtype": name, "seconds": secs, "peak_gib": peak / 2**30,
                                  "call_peak_gib": (peak - before) / 2**30, "ok": ok}
            if not ok:
                problems.append(f"FULL at d={d} {name}: {err or 'variances not finite in (0, 1]'}")
            got[name] = var
            del obj, w
        if got["float32"] is not None and got["float64"] is not None:
            hold(problems, f"(c) FULL d={d} float32 vs float64", got["float32"].double(), got["float64"], 1e-3, 0.0)
        del x, y, got
    torch.cuda.empty_cache()
    if max(CEILING_DIMS) != glm.MAX_FULL_VARIANCE_DIM:
        problems.append(f"the port's ceiling {glm.MAX_FULL_VARIANCE_DIM} is not the largest d measured here")
    try:
        glm.check_full_variance_dim(glm.MAX_FULL_VARIANCE_DIM + 1)
        problems.append("one column above the ceiling did not raise")
    except ValueError:
        pass
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def solvers_phase(torch, state, seed, smi):
    out = {"sweep": solver_sweep(torch, state, seed)}
    torch.cuda.empty_cache()
    out["billion"] = billion_slice(torch, seed)
    torch.cuda.empty_cache()
    out["ceiling"] = full_ceiling(torch, seed)
    log(f"  on {smi}")
    return out


def sparse_entries(sp, times, game=None, retrain=None, served=None):
    """The segment kernel's lines of the kernels JSON, one per product:
    ``launches`` over the main paths that run it (the sparse phase's (b)
    kernel solves and (c) timed sweeps, phase 12's driver run (b) and
    cli.score (d), phase 14's chain (a), phase 15's serving path (b)-(d),
    each counted from 0), ``max_abs_err`` from (a) at the sparse shape in
    f32, times from phase 7; S1's line adds its times at phase 15's
    serving rungs."""
    sp = sp or {}
    path = (sp.get("path") or {}).get("launches", {})
    glmix = (sp.get("glmix") or {}).get("launches", {})
    game = game or {}
    chain_days = ((retrain or {}).get("chain") or {}).get("launches", [])
    entries = []
    for name in SPARSE_PRODUCTS:
        t = (times or {}).get("sparse", {}).get(name, {})
        driver = (game.get("train") or {}).get("s1_launches", 0) if name == "ell_matvec" else 0
        scorer = (game.get("score") or {}).get("s1_launches", 0) if name == "ell_matvec" else 0
        chain = [d.get(name, 0) for d in chain_days]
        serve = ((served or {}).get("launches") or {}).get(name, 0)
        entries.append({
            "name": f"segment_dot:{name}", "route": "cuda", "source": "photon_ml_tpu_torch/csrc/sparse_glm.cu",
            "replaces": SPARSE_REPLACES[name.split("_", 1)[1]],
            "launches": path.get(name, 0) + glmix.get(name, 0) + driver + scorer + sum(chain) + serve,
            "launches_serving": serve,
            "serving_rungs": {n: r["s1"] for n, r in (((served or {}).get("engine") or {}).get("rungs") or {}).items()}
            if name == "ell_matvec" else None,
            "launches_sparse_solves": path.get(name, 0), "launches_sparse_glmix": glmix.get(name, 0),
            "launches_game_driver": driver, "launches_game_score": scorer, "launches_retrain_chain_per_day": chain,
            "max_abs_err": (sp.get("errors") or {}).get(name),
            "ms": t.get("ms"), "prev_ms": t.get("prev_ms"), "graph_ms": t.get("graph_ms"),
            "prev_graph_ms": t.get("prev_graph_ms"), "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "design_bound_ms": t.get("design_bound_ms"),
            "prev_design_bound_ms": t.get("prev_design_bound_ms"), "form": t.get("form"),
            "sector_ms": t.get("sector_ms"), "library_ms": t.get("library_ms"),
            "library": "cuSPARSE CSR SpMV (torch.mv on a sparse CSR tensor)",
            "index_add_ms": t.get("index_add_ms"), "dtype": "float32 values and src, double sums",
            "segments": t.get("segments"), "entries": t.get("entries"), "design": DESIGN["segment_dot"],
            "prev_design": PREV_SEGMENT_DESIGN,
            "companion_bytes": ((sp.get("path") or {}).get("companion_bytes") or {}).get(name.split("_", 1)[0]),
            "solve_ms_per_launch": (((sp.get("path") or {}).get(name.split("_", 1)[0]) or {}).get("profile")
                                    or {}).get("s1_ms_per_launch"),
        })
    return entries


def gathered_rows(seg, n_src):
    """The distinct source rows that ``seg``'s entries gather (at most
    ``n_src``), counted on the host."""
    rows = int(np.unique(seg.gather.cpu().numpy()).size)
    if rows > n_src:
        raise ValueError(f"the gather reaches {rows} rows of a source of {n_src}")
    return rows


def segment_bytes(seg, n_seg, n_src):
    """Bytes of one segment product (``ops/sparse.py`` ``Segments``) over a
    source of ``n_src`` floats, three ways:

    - ``function``, the bound: what the product must move. Each entry's
      int32 source index and its value read once, each float32 source value
      that an entry gathers read once (the distinct gathered rows: 4,726,611
      of w's 10 M at the sparse shape, every one of c's), the float32 output
      written once. At the sparse shape both sources (w, 40 MB; c, 0.8 MB)
      fit the 50 MB L2, so a gather costs no sector of its own;
    - ``design``: ``function`` plus what this design adds: the row groups'
      segment pointers (none for uniform ELL rows), or the key walk's int32
      keys, its joins and their float64 carries (one written by each tile
      of a join and read by the join);
    - ``sectors``: the worst case, each gathered source value a 32-byte
      sector of its own, with the design's additions. Not a bound."""
    nnz = seg.gather.shape[0]
    entries = nnz * (4 + seg.val.element_size())
    if seg.keys is not None:
        tiles = int((seg.joins[:, 2] - seg.joins[:, 1] + 1).sum()) if seg.joins.shape[0] else 0
        own = 4 * nnz + 12 * seg.joins.shape[0] + 2 * 8 * tiles
    else:
        own = 0 if seg.ptr is None else seg.ptr.element_size() * (n_seg + 1)
    function = entries + 4 * gathered_rows(seg, n_src) + 4 * n_seg
    return {"function": function, "design": function + own, "sectors": entries + 32 * nnz + 4 * n_seg + own}


def segment_flops(seg, square=False):
    """Operations of one segment product: a multiply and an add per entry
    (one more multiply for the square)."""
    return (3 if square else 2) * seg.gather.shape[0]


def b4_bound_ms(n, d, mode, world):
    """Least time of one B4 call per card, from bytes over 3.35 TB/s (the
    operations take less): the card's rows of X and their [n] vectors read
    once, the [d] vectors read, the slot row written, the gathered
    [world, width] slots read by the sum and the f32 outputs written. With
    DP_RANKS gloo ranks sharing one card, that card streams every rank's
    rows: call it with world 1 and the whole padded n."""
    import torch

    from photon_ml_tpu_torch.ops import fused_glm as fg

    width = fg._out_width(mode, d)
    rows = fg.sweep_bytes(-(-n // world), d, torch.float32, mode) - 4 * width
    return (rows + 8 * width + 8 * world * width + 4 * width) / HBM_BYTES_PER_S * 1e3


def b4_entry(name, n, d, dp, times):
    """B4's line of the kernels JSON. ``launches``: its calls over the
    4-rank gloo sweeps, summed over the ranks (per rank beside), and over
    the NCCL sweeps. ``ms``: one call at n x d f32 on rank 0 of 4 gloo ranks
    sharing the card, the collective alone and the rank's kernel alone
    beside (the all-reduce path's turns, ``prev_ms``, left the script to
    make room for phase 17 (f): null); ``nccl_*`` the same
    over NCCL, one rank per card (world ``nccl_world``), on the sweep's
    rows. ``plain_ms``: the unsharded plain version on the whole batch
    (phase 7). ``bound_ms``: the gloo configuration's (one card streams all
    of X), ``nccl_bound_ms`` one card's of the NCCL world. No PyTorch call
    computes it: NCCL and gloo move bytes, they compute none of B4's sums."""
    from photon_ml_tpu_torch.ops import fused_glm as fg

    mode = {"sharded_value_grad": fg.VG, "sharded_hessian_vector": fg.HV, "sharded_hessian_stats": fg.HD}[name]
    share = -(-n // DP_RANKS)
    b4 = (dp or {}).get("b4", {})
    t32 = b4.get("times", {}).get("float32", {}).get(name, {})
    sweep = (dp or {}).get("sweep") or {}
    nccl = (dp or {}).get("nccl") or {}
    tn = nccl.get("b4", {}).get(name, {})
    world = nccl.get("world", 1)
    per_rank = [r[name] for r in sweep.get("sharded", [])]
    plain = (times or {}).get("float32", {}).get(B4_OF[name], {})
    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "sum_source": SOURCES["rank_order_sum"], "design": B4_DESIGN,
        "launches": sum(per_rank), "launches_per_rank": per_rank,
        "launches_nccl": nccl.get("sharded", {}).get(name, 0),
        "max_abs_err": b4.get("errors", {}).get(name),
        "ms": t32.get("ms"), "prev_ms": t32.get("prev_ms"), "collective_ms": t32.get("collective_ms"),
        "prev_collective_ms": t32.get("prev_collective_ms"), "rank_kernel_ms": t32.get("kernel_ms"),
        "plain_ms": plain.get("plain_ms"),
        "bound_ms": b4_bound_ms(share * DP_RANKS, d, mode, 1), "bound_by": "bytes",
        "bound_ms_per_card_p4": b4_bound_ms(share * DP_RANKS, d, mode, DP_RANKS),
        "library_ms": None, "dtype": "float32", "world": DP_RANKS, "backend": "gloo",
        "bf16_ms": b4.get("times", {}).get("bfloat16", {}).get(name, {}).get("ms"),
        "nccl_world": world, "nccl_ms": tn.get("ms"), "nccl_prev_ms": tn.get("prev_ms"),
        "nccl_collective_ms": tn.get("collective_ms"), "nccl_collective_own_ms": tn.get("collective_own_ms"),
        "nccl_prev_collective_ms": tn.get("prev_collective_ms"), "nccl_rank_kernel_ms": tn.get("kernel_ms"),
        "nccl_bound_ms": b4_bound_ms(n, d, mode, world),
    }


def sum_entry(dp, times, errs):
    """The rank-order sum's line of the kernels JSON: launches over the
    data-parallel sweeps (gloo, summed over the ranks; NCCL beside), its
    time at the 4-rank value+grad shape (phase 7; world 1 beside)."""
    t = (times or {}).get("rank_order_sum", {})
    t4, t1 = t.get(DP_RANKS, {}), t.get(1, {})
    sweep = (dp or {}).get("sweep") or {}
    nccl = (dp or {}).get("nccl") or {}
    return {
        "name": "rank_order_sum", "route": "cuda", "source": SOURCES["rank_order_sum"],
        "replaces": REPLACES["rank_order_sum"], "design": DESIGN["rank_order_sum"],
        "launches": sum(r["rank_order_sum"] for r in sweep.get("sums", [])),
        "launches_per_rank": [r["rank_order_sum"] for r in sweep.get("sums", [])],
        "launches_nccl": nccl.get("sums", {}).get("rank_order_sum", 0),
        "max_abs_err": (errs or {}).get("rank_order_sum"),
        "ms": t4.get("ms"), "plain_ms": t4.get("plain_ms"), "bound_ms": t4.get("bound_ms"),
        "bound_by": "bytes", "library_ms": t4.get("library_ms"), "dtype": "float64 in, float32 out",
        "world": DP_RANKS, "width": t4.get("width"),
        "world1_ms": t1.get("ms"), "world1_plain_ms": t1.get("plain_ms"), "world1_library_ms": t1.get("library_ms"),
    }


# ------------------------------------- V1: the lane reduction (phases 3, 10)

# V1 replaces no Pallas kernel: the JAX package's vmapped per-entity solve
# (jax.vmap of solve_one) reduces through XLA
LANE_REPLACES = "photon_ml_tpu/game/coordinate.py:1108"
LANE_DESIGN = ("last axis: a warp per output, lane l adding r = l, l+32, ... in order, then a fixed xor butterfly; "
               "middle axis: a thread per output adding r in order; operands by strides (a broadcast b read in "
               "place), products and sums in the output type; each output written once, no atomics: the order "
               "depends on the reduced length alone, never on the number of outputs")


def lane_forms(X, w, c, g):
    """V1's four call forms in the vmapped solve (game/coordinate.py
    _train_blocks and the LEADING lanes of optimize/), at X's shape: name ->
    (a, b, dim)."""
    return {
        "margins": (X, w[:, None, :], -1),  # [E, K, S] x [E, 1, S] over S
        "gradient": (X, c[:, :, None], 1),  # [E, K, S] x [E, K, 1] over K
        "lane_dot": (g, g, -1),  # [E, S] x [E, S] over S
        "value_sum": (c.double(), None, -1),  # float64 [E, K] over K
    }


def lane_inputs(torch, seed, dev):
    """The billion-coefficient slice's features X, an iterate w, the
    logistic loss's derivative c at w's margins for random labels, and the
    gradient g (the plain version's): the values of a solve's first
    evaluation."""
    from photon_ml_tpu_torch.ops import lane_reduce as lr
    from photon_ml_tpu_torch.ops.losses import LOSSES

    E, K, S = BILLION_SLICE
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    X = torch.randn((E, K, S), generator=gen, device=dev) * 0.3
    w = torch.randn((E, S), generator=gen, device=dev) * 0.1
    y = (torch.rand((E, K), generator=gen, device=dev) < 0.5).float()
    _, c = LOSSES["logistic"].loss_and_dz(lr.lane_reduce_plain(X, w[:, None, :]), y)
    return X, w, c, lr.lane_reduce_plain(X, c[:, :, None], 1)


def lane_bytes(a, b, dim):
    """What one V1 call must move: a and b read once (a broadcast b once
    per distinct element), the output written once."""
    out = a.numel() // a.shape[dim]
    nb = 0 if b is None else b.numel() * b.element_size()
    return a.numel() * a.element_size() + nb + out * (b.element_size() if b is not None else a.element_size())


def check_lane_reduce(torch, seed):
    """V1 against its plain version computed in float64 from the same
    inputs, at the slice shape for each call form of the vmapped solve:
    max-abs error <= 3e-5 * max(|ref|, 1); launches of this check are not
    counted."""
    from photon_ml_tpu_torch.ops import lane_reduce as lr

    dev = torch.device("cuda")
    saved = dict(lr.LANE_LAUNCHES)
    X, w, c, g = lane_inputs(torch, seed, dev)
    errs, bad = {}, []
    for name, (a, b, dim) in lane_forms(X, w, c, g).items():
        got = lr.lane_reduce(a, b, dim)
        ref = lr.lane_reduce_plain(a.double(), None if b is None else b.double(), dim)
        err = float((got.double() - ref).abs().max())
        bound = 3e-5 * max(float(ref.abs().max()), 1.0)
        errs[name] = err
        log(f"  check lane_reduce (V1) {name} {tuple(a.shape)} dim {dim} {str(got.dtype)[6:]}: "
            f"max_abs_err={err:.3e}/{bound:.3e} {'ok' if err <= bound else 'MISS'}")
        if not err <= bound:
            bad.append(("lane_reduce", name))
        del ref
    lr.LANE_LAUNCHES.update(saved)
    del X, w, c, g
    torch.cuda.empty_cache()
    return errs, bad


def lane_op_diagnostic(torch, X, w, c, g, stacks):
    """The finding behind ROADMAP C7, kept as a check: each call form over a
    small stack against the same rows of the whole slice, through
    torch.sum (the plain version) and through V1; elements whose bits
    differ. V1 must differ nowhere."""
    from photon_ml_tpu_torch.ops import lane_reduce as lr

    saved = dict(lr.LANE_LAUNCHES)
    whole = {name: (lr.lane_reduce_plain(*f), lr.lane_reduce(*f)) for name, f in lane_forms(X, w, c, g).items()}
    v1_differs = 0
    for label, rows in stacks:
        part = lane_forms(X[rows], w[rows], c[rows], g[rows])
        cells = []
        for name, f in part.items():
            p_plain, p_v1 = lr.lane_reduce_plain(*f), lr.lane_reduce(*f)
            n_plain = int((p_plain != whole[name][0][rows]).sum())
            n_v1 = int((p_v1 != whole[name][1][rows]).sum())
            v1_differs += n_v1
            cells.append(f"{name} torch.sum {n_plain}/{p_plain.numel()} V1 {n_v1}")
        log(f"  (b) {label} alone vs within the slice, elements whose bits differ: " + "; ".join(cells))
    lr.LANE_LAUNCHES.update(saved)
    return v1_differs


def time_lane_reduce(torch, X, w, c, g):
    """V1 at the slice shape beside its bound (bytes over 3.35 TB/s, or
    operations over the float32 peak), its plain version and the one
    PyTorch call that computes the same function (torch.bmm), CUDA events
    over 20 calls; for the margins (the main entry) and the gradient."""
    from photon_ml_tpu_torch.ops import lane_reduce as lr

    saved = dict(lr.LANE_LAUNCHES)
    forms = lane_forms(X, w, c, g)
    library = {"margins": lambda: torch.bmm(X, w[:, :, None]), "gradient": lambda: torch.bmm(c[:, None, :], X)}
    out = {}
    for name in ("margins", "gradient"):
        a, b, dim = forms[name]
        by_bytes = lane_bytes(a, b, dim) / HBM_BYTES_PER_S * 1e3
        by_ops = 2 * a.numel() / PEAK_OPS["float32"] * 1e3
        t = {"ms": time_ms(torch, lambda: lr.lane_reduce(a, b, dim), 20),
             "plain_ms": time_ms(torch, lambda: lr.lane_reduce_plain(a, b, dim), 20),
             "library_ms": time_ms(torch, library[name], 20),
             "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "bytes": lane_bytes(a, b, dim)}
        log(f"  (b) V1 {name} {tuple(a.shape)} dim {dim}: {t['ms']:.4f} ms (plain torch.sum {t['plain_ms']:.4f}, "
            f"torch.bmm {t['library_ms']:.4f}; bound {t['bound_ms']:.4f} by {t['bound_by']}, "
            f"{t['bytes'] / 1e6:.1f} MB)")
        out[name] = t
    lr.LANE_LAUNCHES.update(saved)
    return out


def lane_entry(errs, solvers):
    """V1's line of the kernels JSON: launches over phase 10 (b)'s vmapped
    solves of the whole slice (L-BFGS and TRON, counted from 0 before each),
    the error from phase 3, times from phase 10 (b)."""
    bl = (solvers or {}).get("billion") or {}
    t = (bl.get("lane_times") or {}).get("margins", {})
    g = (bl.get("lane_times") or {}).get("gradient", {})
    per_solve = {opt: v.get("lane_launches") for opt, v in bl.items() if isinstance(v, dict) and "lane_launches" in v}
    return {
        "name": "lane_reduce", "route": "cuda", "source": "photon_ml_tpu_torch/csrc/lane_reduce.cu",
        "replaces": LANE_REPLACES, "design": LANE_DESIGN,
        "launches": sum(sum(v.values()) for v in per_solve.values() if v), "launches_per_solve": per_solve,
        "max_abs_err": (errs or {}).get("lane_reduce:margins"),
        "max_abs_err_forms": {k.split(":", 1)[1]: v for k, v in (errs or {}).items() if k.startswith("lane_reduce:")},
        "ms": t.get("ms"), "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
        "bound_by": t.get("bound_by"), "library_ms": t.get("library_ms"), "library": "torch.bmm",
        "shape": list(BILLION_SLICE), "form": "margins: [E, K, S] x [E, 1, S] over S, float32",
        "gradient_ms": g.get("ms"), "gradient_plain_ms": g.get("plain_ms"), "gradient_bound_ms": g.get("bound_ms"),
        "gradient_library_ms": g.get("library_ms"),
    }


# --------------------------------------------------- phase 11: data and model IO

IO_TRAIN = (200_000, 8)  # rows, part files
IO_VALIDATION = (50_000, 2)
IO_FEATURES = 1_023  # named features; the reader adds the intercept: d = 1,024
IO_NNZ = 32  # named features a row
IO_LAMBDAS = "0.1|1|10"


def _io_write_part(path, seed, part, rows):
    """One part file of phase 11's fixture, written by the port's writer in
    a worker process: IO_NNZ distinct features of IO_FEATURES a row, values
    N(0, 1), labels from a logistic model whose weights come from ``seed``
    (the same in every part) and rows from ``(seed, part)``. Returns the
    writer's seconds (records built before the clock starts)."""
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    w_true = np.random.default_rng(seed).standard_normal(IO_FEATURES + 1) / np.sqrt(IO_NNZ)
    rng = np.random.default_rng([seed, part])
    cols = np.argpartition(rng.random((rows, IO_FEATURES)), IO_NNZ, axis=1)[:, :IO_NNZ]
    vals = rng.standard_normal((rows, IO_NNZ))
    z = (vals * w_true[cols]).sum(axis=1) + w_true[-1]
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    names = [f"f{j}" for j in range(IO_FEATURES)]
    recs = [
        {"uid": f"{part}-{i}", "label": float(y[i]),
         "features": [{"name": names[j], "term": "", "value": v} for j, v in zip(cols[i].tolist(), vals[i].tolist())]}
        for i in range(rows)
    ]
    t0 = time.perf_counter()
    write_avro_file(path, TRAINING_EXAMPLE_AVRO, recs)
    return time.perf_counter() - t0


_WRITER_POOL = None


def writer_pool():
    """The worker processes that write the fixtures' part files (phases 11
    (a) and 12 (a)), spawned on first use (``warm_writer_pool``, beside the
    build) and kept until ``close_writer_pool`` (or the interpreter's
    exit): neither fixture pays a process start (cut to make room for
    phase 18)."""
    global _WRITER_POOL
    if _WRITER_POOL is None:
        import atexit
        import concurrent.futures
        import multiprocessing
        import os

        _WRITER_POOL = concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 1, mp_context=multiprocessing.get_context("spawn"))
        atexit.register(close_writer_pool)
    return _WRITER_POOL


def _warm_writer() -> None:
    """A writer process's imports, done before its first part."""
    import photon_ml_tpu_torch.io.avro  # noqa: F401


def warm_writer_pool() -> None:
    """Start ``writer_pool``'s processes and their imports now, without
    waiting (the build phase runs meanwhile), so that the fixtures' writes
    pay no process start (cut to make room for phase 18)."""
    import os

    pool = writer_pool()
    for _ in range(os.cpu_count() or 1):
        pool.submit(_warm_writer)


def close_writer_pool():
    global _WRITER_POOL
    if _WRITER_POOL is not None:
        _WRITER_POOL.shutdown()
        _WRITER_POOL = None


def io_write(root, seed):
    """(a) The fixture's part files, all written at once by the worker
    processes of ``writer_pool``: (train dir, validation dir, wall seconds,
    summed writer seconds)."""
    import os

    jobs = []
    for name, (rows, parts), base in (("train", IO_TRAIN, 0), ("validation", IO_VALIDATION, 1000)):
        os.makedirs(os.path.join(root, name))
        jobs += [(os.path.join(root, name, f"part-{p:05d}.avro"), seed, base + p, rows // parts) for p in range(parts)]
    t0 = time.perf_counter()
    writer_s = list(writer_pool().map(_io_write_part, *zip(*jobs)))
    return os.path.join(root, "train"), os.path.join(root, "validation"), time.perf_counter() - t0, sum(writer_s)


def _same_raw(a, b, canonical=False):
    """Two RawDatasets' equality, bit for bit: labels, offsets, weights,
    uids, dims and the COO triples (``canonical``: after sorting the entries
    by row and column, as the two engines order them differently)."""
    same = a.n_rows == b.n_rows and a.shard_dims == b.shard_dims and list(a.uids) == list(b.uids)
    for f in ("labels", "offsets", "weights"):
        same = same and np.array_equal(getattr(a, f), getattr(b, f))
    for s in a.shard_coo:
        (ra, ca, va), (rb, cb, vb) = a.shard_coo[s], b.shard_coo[s]
        if canonical:
            oa, ob = np.lexsort((ca, ra)), np.lexsort((cb, rb))
            ra, ca, va, rb, cb, vb = ra[oa], ca[oa], va[oa], rb[ob], cb[ob], vb[ob]
        same = same and all(np.array_equal(x, y) for x, y in ((ra, rb), (ca, cb), (va, vb)))
    return bool(same)


def io_read(torch, train, problems):
    """(b) The chunked reader: the native engine at 1 and 4 workers over
    every part, the Python codec and the native engine on one part; rows/s
    each, the parts each engine decoded, the results bitwise alike."""
    import os

    from photon_ml_tpu_torch import native
    from photon_ml_tpu_torch.io import data as io_data

    shards = {"global": io_data.FeatureShardConfig(("features",))}
    t0 = time.perf_counter()
    built = native.available()
    log(f"  (b) native decoder built: {built} in {time.perf_counter() - t0:.1f}s ({native.library_path()})")
    if not built or not os.path.exists(native.library_path()):
        problems.append(f"the native decoder did not build: {native._lib_error}")
        return None, {}
    out, reads = {}, {}
    n_parts = IO_TRAIN[1]
    for label, path, engine, workers, parts in (
        ("native, 1 worker", train, "native", 1, n_parts), ("native, 4 workers", train, "native", 4, n_parts),
        ("python, one part", os.path.join(train, "part-00000.avro"), "python", 1, 1),
        ("native, one part", os.path.join(train, "part-00000.avro"), "native", 4, 1),
    ):
        io_data.reset_decoded_parts()
        t0 = time.perf_counter()
        ds, maps = io_data.read_avro_dataset_chunked(path, shards, index_maps=out.get("maps"), engine=engine,
                                                     workers=workers)
        secs = time.perf_counter() - t0
        decoded = dict(io_data.DECODED_PARTS)
        entries = len(ds.shard_coo["global"][0])
        log(f"  (b) read {label}: {ds.n_rows} rows, {entries} entries (the intercept included), d="
            f"{ds.shard_dims['global']} in {secs:.2f} s: {ds.n_rows / secs:.1f} rows/s, "
            f"{(entries - ds.n_rows) / secs:.1f} feature entries/s; parts decoded {decoded}")
        if decoded != {"native": parts if engine == "native" else 0, "python": parts if engine == "python" else 0}:
            problems.append(f"read {label}: the engine that decoded was {decoded}")
        reads[label] = {"rows": ds.n_rows, "seconds": secs, "rows_per_s": ds.n_rows / secs,
                        "entries_per_s": (entries - ds.n_rows) / secs, "decoded_parts": decoded}
        out.setdefault("maps", maps)
        out[label] = ds
    same_workers = _same_raw(out["native, 1 worker"], out["native, 4 workers"])
    same_engines = _same_raw(out["python, one part"], out["native, one part"], canonical=True)
    log(f"  (b) native at 1 and 4 workers bitwise equal: {same_workers}; python and native on one part bitwise "
        f"equal (entries sorted by row and column): {same_engines}")
    if not (same_workers and same_engines):
        problems.append("the readers disagree across worker counts or engines")
    if out["native, 1 worker"].n_rows != IO_TRAIN[0] or out["native, 1 worker"].shard_dims["global"] != 1024:
        problems.append(f"the fixture read back as {out['native, 1 worker'].n_rows} rows, "
                        f"d={out['native, 1 worker'].shard_dims['global']}")
    return out["maps"], reads


def io_driver(torch, train, validation, out_dir, maps, problems, dev="cuda"):
    """(c) cli.glm.run_models on the card (the driver's path: read, validate,
    statistics, normalization, a TRON grid with SIMPLE variance, selection,
    text and Avro models) with every launch counter at 0 before it; its
    grid against the same grid through the plain versions on the card;
    every saved Avro model reloaded through load_glm."""
    import os

    from photon_ml_tpu_torch.cli import glm
    from photon_ml_tpu_torch.estimators import train_glm_grid
    from photon_ml_tpu_torch.evaluation.suite import build_suite
    from photon_ml_tpu_torch.game import GLMOptimizationConfig
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_glm, read_avro_dataset
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.normalization import build_normalization
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType
    from photon_ml_tpu_torch.utils.stats import compute_feature_statistics

    argv = ["--input-data", train, "--validation-data", validation, "--output-dir", out_dir,
            "--optimizer", "TRON", "--normalization", "STANDARDIZATION", "--variance-type", "SIMPLE",
            "--regularization-type", "L2", "--regularization-weights", IO_LAMBDAS, "--evaluators", "AUC",
            "--log-level", "WARNING", "--device", dev]
    fg.reset_launch_counts()
    t0 = time.perf_counter()
    summary, trained = glm.run_models(argv)
    wall = time.perf_counter() - t0
    launches, shifts = dict(fg.LAUNCHES), fg.SHIFT_LAUNCHES["fused_hessian_stats"]
    routes = dict(fg.OBJECTIVE_ROUTES)
    log(f"  (c) cli.glm on the card: {wall:.2f} s; stages (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in summary["stage_seconds"].items())
        + f"; launches {launches}, B3 with shifts {shifts}, objective routes {routes}")
    for m in summary["models"]:
        log(f"  (c) lambda {m['reg_weight']}: iterations {m['iterations']} reason {m['convergence_reason']} "
            f"loss {m['loss']:.6f} validation AUC {m['metrics']['AUC']:.6f}")
    if min(launches["fused_value_grad"], launches["fused_hessian_vector"], shifts) <= 0:
        problems.append(f"the driver did not launch B1, B2 and B3 with shifts: {launches}, shifts {shifts}")

    # the same grid through the plain versions on the card, on the same batch
    shards = {"global": FeatureShardConfig(("features",))}
    raw, _ = read_avro_dataset(train, shards, index_maps=maps)
    val, _ = read_avro_dataset(validation, shards, index_maps=maps)
    stats = compute_feature_statistics(raw, "global")
    batch = raw.to_batch("global", device=dev)
    norm = build_normalization("STANDARDIZATION", stats["mean"], stats["variance"], stats["max_magnitude"],
                               intercept_index=maps["global"].intercept_index, dtype=batch.labels.dtype,
                               device=dev)
    cfg = GLMOptimizationConfig(optimizer=OptimizerConfig(optimizer_type=OptimizerType.TRON),
                                regularization=RegularizationContext("L2"), variance_type="SIMPLE")
    fg.reset_launch_counts()
    plain = train_glm_grid(batch, "logistic_regression", cfg, [float(w) for w in IO_LAMBDAS.split("|")],
                           normalization=norm, plain=True)
    if any(fg.LAUNCHES.values()):
        problems.append("the plain grid launched a kernel")
    suite = build_suite(["AUC"], val.labels, val.weights)
    vbatch = val.to_batch("global", device=dev)
    held = []
    for m, t, p in zip(summary["models"], trained, plain):
        l_k, l_p = float(t.solver_result.loss), float(p.solver_result.loss)
        a_p = suite.evaluate(p.model.score(vbatch)).primary_metric
        rel, gap = abs(l_k - l_p) / abs(l_p), abs(m["metrics"]["AUC"] - a_p)
        ok = rel <= 1e-5 and gap <= 1e-4
        log(f"  (c) lambda {t.reg_weight}: loss {l_k:.6f} vs plain {l_p:.6f} rel diff {rel:.2e} (rtol 1e-5); "
            f"AUC {m['metrics']['AUC']:.6f} vs plain {a_p:.6f} diff {gap:.2e} (1e-4) {'ok' if ok else 'MISS'}")
        if not ok:
            problems.append(f"lambda {t.reg_weight}: the driver's grid and the plain grid disagree")
        sub = os.path.join(out_dir, f"lambda-{t.reg_weight}")
        back = load_glm(os.path.join(sub, "model.avro"), maps["global"], device=dev)
        same = _same_bits(back.coefficients.means, t.model.coefficients.means) and _same_bits(
            back.coefficients.variances, t.model.coefficients.variances)
        held.append(same)
        if not same:
            problems.append(f"lambda {t.reg_weight}: the saved model does not reload bitwise")
    log(f"  (c) every saved model reloads through load_glm bitwise (means and variances, on "
        f"{back.coefficients.means.device}): {all(held)}")
    return {"wall_s": wall, "stage_seconds": summary["stage_seconds"], "launches": launches,
            "shift_launches": shifts, "models": summary["models"]}


def io_game_model(torch, state, root, problems):
    """(d) Phase 5's GLMix model (the fixed effect at d = 1,024 and the
    per-user random effect) with synthetic index maps, through
    save_game_model and load_game_model: coefficients bitwise, scores on
    phase 5's batch equal."""
    import os

    from photon_ml_tpu_torch.io import IndexMap, load_game_model, save_game_model

    coords, model = state["coords"], state["result"].model
    fe, re_model = model["global"], model["per-user"]
    dims = {fe.feature_shard: fe.coefficients.dim, re_model.feature_shard: state["data"][2].shape[1]}
    maps = {s: IndexMap({f"{s}_f{j}\x01": j for j in range(d)}) for s, d in dims.items()}
    path = os.path.join(root, "game-model")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_game_model(path, model, maps)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_game_model(path, maps)
    load_s = time.perf_counter() - t0
    bfe, bre = back["global"], back["per-user"]
    same_fe = _same_bits(bfe.coefficients.means, fe.coefficients.means) and _same_bits(
        bfe.coefficients.variances, fe.coefficients.variances)
    same_re = (list(map(str, bre.entity_ids)) == list(map(str, re_model.entity_ids))
               and _same_bits(bre.coef_indices, re_model.coef_indices)
               and _same_bits(bre.coef_values, re_model.coef_values)
               and _same_bits(bre.variances, re_model.variances))
    scores = {name: (coords[name].score(model[name]), coords[name].score(back[name])) for name in coords}
    same_scores = all(torch.equal(a, b) for a, b in scores.values())
    n_coef = fe.coefficients.dim + int((re_model.coef_indices >= 0).sum())
    log(f"  (d) GLMix model ({fe.coefficients.dim} fixed-effect coefficients, {re_model.num_entities} entities x "
        f"{re_model.coef_indices.shape[1]}, {n_coef} coefficients in all): save {save_s:.2f} s, load "
        f"{load_s:.2f} s (onto {bfe.coefficients.means.device}); fixed effect bitwise {same_fe}, random effect "
        f"bitwise {same_re}, scores on phase 5's batch equal {same_scores}")
    if not (same_fe and same_re and same_scores):
        problems.append("the GLMix model did not round-trip bitwise")
    return {"save_s": save_s, "load_s": load_s, "coefficients": n_coef}


def io_phase(torch, state, seed, smi):
    """Phase 11: write the fixture with the port's writer, read it back,
    run the legacy GLM driver on the card and round-trip phase 5's GLMix
    model. The temporary directory is removed at the end."""
    import tempfile

    problems, out = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as root:
        train, validation, wall, writer_s = io_write(root, seed)
        entries = (IO_TRAIN[0] + IO_VALIDATION[0]) * IO_NNZ
        rows = IO_TRAIN[0] + IO_VALIDATION[0]
        log(f"  (a) wrote {rows} rows ({entries} feature entries) into {IO_TRAIN[1]} + {IO_VALIDATION[1]} deflate "
            f"parts in {wall:.2f} s by worker processes: {rows / wall:.1f} rows/s, {entries / wall:.1f} entries/s "
            f"(the writers' own seconds summed: {writer_s:.2f}, {entries / writer_s:.1f} entries/s a process)")
        out["write"] = {"wall_s": wall, "writer_s": writer_s, "rows_per_s": rows / wall,
                        "entries_per_s": entries / wall}
        maps, out["read"] = io_read(torch, train, problems)
        if maps is not None:
            out["driver"] = io_driver(torch, train, validation, f"{root}/glm-out", maps, problems)
        torch.cuda.empty_cache()
        out["game_model"] = io_game_model(torch, state, root, problems)
    log(f"  on {smi}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ---------------------------------------------------------- phase 12: the GAME driver
#
# The GAME driver from Avro to saved models on the card, then batch
# scoring: phase 11's global bag (cut from bench.py's 500,000 rows to
# 200,000 for the script's time) with build_data's Zipf(1.1) users, each row
# carrying its user's userFeatures bag.

GAME_USERS = 20_000  # bench.py's users
GAME_RE_FEATURES = 31  # named per-user features; the reader adds the intercept: d_re = 32
GAME_FE = ("name=global,shard=global,optimizer=TRON,tolerance=1e-6,max.iter=10,reg.type=L2,reg.weights=1,"
           "variance=SIMPLE")
GAME_RE = ("name=per-user,shard=userShard,re.type=userId,optimizer=LBFGS,tolerance=1e-6,max.iter=30,"
           "reg.type=L2,reg.weights=1,active.cap=256")
GAME_KILL_AT = 2  # cd.boundary_saved: after the first sweep's second boundary


def _game_write_part(path, seed, part, rows, even_users=False):
    """One part file of phase 12's fixture, written by the port's writer in
    a worker process: phase 11's global bag (IO_NNZ of IO_FEATURES named
    features a row, N(0, 1)), a userId drawn Zipf(1.1) over GAME_USERS users
    (build_data's assignment) in metadataMap, the user's GAME_RE_FEATURES
    named features N(0, 1) in userFeatures, and logistic labels from both
    effects. The models come from ``seed`` (the same in every part), the
    rows from ``(seed, part)``; ``even_users`` keeps only the rows of the
    users with an even number (phase 14's day 3). Returns the writer's
    seconds."""
    from photon_ml_tpu_torch.io.avro import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    model = np.random.default_rng(seed)
    w_fe = model.standard_normal(IO_FEATURES + 1) / np.sqrt(IO_NNZ)
    w_re = model.standard_normal((GAME_USERS, GAME_RE_FEATURES + 1)) / np.sqrt(GAME_RE_FEATURES + 1)
    rng = np.random.default_rng([seed, part])
    cols = np.argpartition(rng.random((rows, IO_FEATURES)), IO_NNZ, axis=1)[:, :IO_NNZ]
    vals = rng.standard_normal((rows, IO_NNZ))
    probs = 1.0 / np.arange(1, GAME_USERS + 1) ** 1.1
    users = rng.choice(GAME_USERS, size=rows, p=probs / probs.sum())
    ex = rng.standard_normal((rows, GAME_RE_FEATURES))
    z = (vals * w_fe[cols]).sum(axis=1) + w_fe[-1] + (ex * w_re[users, :-1]).sum(axis=1) + w_re[users, -1]
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    names = [f"f{j}" for j in range(IO_FEATURES)]
    unames = [f"u{j}" for j in range(GAME_RE_FEATURES)]
    recs = [
        {"uid": f"{part}-{i}", "label": float(y[i]), "metadataMap": {"userId": f"u{users[i]}"},
         "features": [{"name": names[j], "term": "", "value": v} for j, v in zip(cols[i].tolist(), vals[i].tolist())],
         "userFeatures": [{"name": unames[j], "term": "", "value": v} for j, v in enumerate(ex[i].tolist())]}
        for i in range(rows) if not even_users or users[i] % 2 == 0
    ]
    schema = {**TRAINING_EXAMPLE_AVRO, "fields": TRAINING_EXAMPLE_AVRO["fields"] + [
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}]}
    t0 = time.perf_counter()
    write_avro_file(path, schema, recs)
    return time.perf_counter() - t0


def game_write(root, seed):
    """(a) The fixture's part files, and phase 14's day 3 under
    ``root/day3``, all written at once by the worker processes of
    ``writer_pool`` (phase 11 (a)'s, when it ran): (train dir, validation
    dir, day 3 dir, wall seconds, summed writer seconds of the fixture's
    parts)."""
    import os

    jobs = []
    for name, (rows, parts), base in (("train", IO_TRAIN, 0), ("validation", IO_VALIDATION, 1000)):
        os.makedirs(os.path.join(root, name))
        jobs += [(os.path.join(root, name, f"part-{p:05d}.avro"), seed, base + p, rows // parts, False)
                 for p in range(parts)]
    n_fixture = len(jobs)
    os.makedirs(os.path.join(root, "day3"))
    parts, rows = RETRAIN_DAY3
    jobs += [(os.path.join(root, "day3", f"part-{p:05d}.avro"), seed, 2000 + p, rows, True) for p in range(parts)]
    t0 = time.perf_counter()
    writer_s = list(writer_pool().map(_game_write_part, *zip(*jobs)))
    return (os.path.join(root, "train"), os.path.join(root, "validation"), os.path.join(root, "day3"),
            time.perf_counter() - t0, sum(writer_s[:n_fixture]))


def game_argv(train, validation, out, extra=()):
    return ["--input-data", train, "--validation-data", validation,
            "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
            "--coordinate", GAME_FE, "--coordinate", GAME_RE, "--normalization", "STANDARDIZATION",
            "--coordinate-descent-iterations", "2", "--evaluators", "AUC", "--output-dir", out,
            "--log-level", "WARNING", *extra]


def _counted_train(torch, argv):
    """cli.train.run with every launch counter at 0 before it; (summary,
    wall seconds, B1-B3 launches, B3 with shifts, S1 ell_matvec launches)."""
    from photon_ml_tpu_torch.cli import train
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse

    fg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (summary, wall, dict(fg.LAUNCHES), fg.SHIFT_LAUNCHES["fused_hessian_stats"],
            sparse.SPARSE_LAUNCHES["ell_matvec"])


def _run_metrics(metrics_dir):
    import os

    with open(os.path.join(metrics_dir, "run_summary.json")) as f:
        return json.load(f)["metrics"]


def _metric(metrics, name, field="value", **labels):
    return sum(m.get(field, 0) for m in metrics
               if m["name"] == name and all(m["labels"].get(k) == v for k, v in labels.items()))


def _game_models_equal(a, b):
    fa, fb = a["global"].model.coefficients, b["global"].model.coefficients
    ra, rb = a["per-user"], b["per-user"]
    return (_same_bits(fa.means, fb.means) and _same_bits(fa.variances, fb.variances)
            and list(map(str, ra.entity_ids)) == list(map(str, rb.entity_ids))
            and _same_bits(ra.coef_indices, rb.coef_indices) and _same_bits(ra.coef_values, rb.coef_values))


def game_train(torch, train, validation, root, problems, smi):
    """(b) cli.train.run on the card with boundary checkpoints, the
    launches counted; then the same fit in process, through the kernels
    (its best model bitwise the driver's) and through the plain versions on
    the card, held at the sweep bounds."""
    import os

    from photon_ml_tpu_torch.cli.params import parse_coordinate
    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.game import CoordinateDescent
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset_chunked
    from photon_ml_tpu_torch.ops.normalization import build_normalization
    from photon_ml_tpu_torch.utils.stats import compute_feature_statistics

    out, metrics_dir = os.path.join(root, "out-b"), os.path.join(root, "metrics-b")
    argv = game_argv(train, validation, out, ["--checkpoint-dir", os.path.join(root, "ck-b"),
                                              "--checkpoint-every", "1", "--checkpoint-keep", "4",
                                              "--metrics-out", metrics_dir])
    summary, wall, launches, shifts, s1 = _counted_train(torch, argv)
    metrics = _run_metrics(metrics_dir)
    saves = _metric(metrics, "photon_checkpoint_saves_total")
    ck_bytes = _metric(metrics, "photon_checkpoint_bytes_total")
    ck_s = _metric(metrics, "photon_checkpoint_save_seconds", "sum")
    auc = summary["best"]["metrics"]["AUC"]
    log(f"  (b) cli.train on the card: {wall:.2f} s; stages (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in summary["stage_seconds"].items())
        + f"; launches {launches}, B3 with shifts {shifts}, S1 ell_matvec {s1}; boundary checkpoints {int(saves)}, "
          f"{int(ck_bytes)} bytes, {ck_s:.3f} s in all; validation AUC {auc:.6f}; rejections "
          f"{summary['configs'][0]['rejections']} on {smi}")
    if min(launches["fused_value_grad"], launches["fused_hessian_vector"], shifts, s1) <= 0:
        problems.append(f"the GAME driver did not launch B1, B2, B3 with shifts and S1: {launches}, "
                        f"shifts {shifts}, S1 {s1}")
    if saves != 4:
        problems.append(f"the driver wrote {saves} boundary checkpoints, not 4")

    # the same fit in process: the driver's reads, statistics and datasets
    shards = {"global": FeatureShardConfig(("features",)), "userShard": FeatureShardConfig(("userFeatures",))}
    raw, maps = read_avro_dataset_chunked(train, shards, id_tag_columns=["userId"])
    val, _ = read_avro_dataset_chunked(validation, shards, index_maps=maps, id_tag_columns=["userId"])
    coords_cfg = [parse_coordinate(GAME_FE), parse_coordinate(GAME_RE)]
    est = GameEstimator("logistic_regression", coords_cfg, n_cd_iterations=2, evaluator_specs=["AUC"])
    stats = compute_feature_statistics(raw, "global")
    coords_cfg[0].normalization = build_normalization(
        "STANDARDIZATION", stats["mean"], stats["variance"], stats["max_magnitude"],
        intercept_index=maps["global"].intercept_index, device=est.device)
    datasets = est.prepare_datasets(raw)
    ctx, _ = est._validation_context(val)
    combo = {"global": 1.0, "per-user": 1.0}
    runs = {}
    for label, plain in (("kernels", False), ("plain", True)):
        coords = est._make_coordinates(datasets, combo)
        coords["global"] = dataclasses.replace(coords["global"], plain=plain)
        states = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = CoordinateDescent(coords, n_iterations=2, validation=ctx, boundary_fn=states.append).run()
        torch.cuda.synchronize()
        runs[label] = (coords, res, states, time.perf_counter() - t0)
    (ck, rk, sk, wk), (cp, rp, sp, wp) = runs["kernels"], runs["plain"]
    best = load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression")
    same = _game_models_equal(best, rk.model)
    log(f"  (b) the same fit in process: kernels {wk:.2f} s, plain {wp:.2f} s; the driver's saved best model "
        f"bitwise the in-process kernel fit's: {same}; best AUC {rk.best_evaluation.metrics['AUC']:.6f} "
        f"(plain {rp.best_evaluation.metrics['AUC']:.6f})")
    if not same:
        problems.append("the driver's saved model differs from the same fit in process")
    # the first sweep's fixed effect sees the same inputs on both sides; the
    # second sweep's coordinates are held on identical residuals: the plain
    # run's coordinate retrained on the kernel run's residual and warm start
    # (chained, each sweep's second fixed effect inherits the other's random
    # effect: printed, not held, as in phase 5)
    for label, states in (("kernels", sk), ("plain", sp)):
        r = states[0].trackers["global"].result
        log(f"  (b) sweep-1 FE solve, {label}: iterations {r.iterations}, reason {r.reason}, "
            f"loss {float(r.loss):.6f}")
    fk, fp = sk[0].models["global"].model.coefficients, sp[0].models["global"].model.coefficients
    hold(problems, "(b) kernels vs plain sweep-1 FE coefficients", fk.means, fp.means, 1e-3, 1e-5)
    hold(problems, "(b) kernels vs plain sweep-1 FE variances", fk.variances, fp.variances, 1e-3, 1e-5)
    st2 = sk[1]
    fe1 = st2.models["global"]
    fe_p, _ = cp["global"].train(st2.summed_scores - ck["global"].score(fe1), initial_model=fe1)
    fk = sk[2].models["global"].model.coefficients
    hold(problems, "(b) kernels vs plain sweep-2 FE coefficients (identical residuals)", fk.means,
         fe_p.model.coefficients.means, 1e-3, 1e-5)
    hold(problems, "(b) kernels vs plain sweep-2 FE variances (identical residuals)", fk.variances,
         fe_p.model.coefficients.variances, 1e-3, 1e-5)
    _, chained = allclose(fk.means, sp[2].models["global"].model.coefficients.means)
    log(f"  (b) (for the record) sweep-2 FE chained on each run's own random effect: max abs diff {chained:.3e}")
    st3 = sk[2]
    re1 = st3.models["per-user"]
    residual = st3.summed_scores - ck["per-user"].score(re1)
    re_p, re_res_p = cp["per-user"].train(residual, initial_model=re1)
    hold(problems, "(b) kernels vs plain RE coefficients (identical residuals)",
         sk[-1].models["per-user"].coef_values, re_p.coef_values, 0.0, 5e-3)
    hold(problems, "(b) kernels vs plain RE loss (identical residuals)",
         rk.solver_results["per-user"].loss, re_res_p.loss, 0.0, 1e-4)
    hold(problems, "(b) kernels vs plain validation AUC", torch.tensor([auc]),
         torch.tensor([rp.best_evaluation.metrics["AUC"]]), 0.0, 1e-4)
    return {"wall_s": wall, "stage_seconds": summary["stage_seconds"], "launches": launches,
            "shift_launches": shifts, "s1_launches": s1, "checkpoint_saves": saves, "checkpoint_bytes": ck_bytes,
            "checkpoint_seconds": ck_s, "auc": auc, "maps": maps, "out": out, "coords": ck}


def game_resume(torch, train, validation, root, problems, b):
    """(c) The same run killed right after the first sweep's second
    boundary checkpoint (PHOTON_FAULTS), then resumed: every saved
    coefficient equals (b)'s bit for bit."""
    import os

    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.io import load_game_model
    from photon_ml_tpu_torch.robust import SimulatedKill, faults

    out = os.path.join(root, "out-c")
    argv = game_argv(train, validation, out, ["--checkpoint-dir", os.path.join(root, "ck-c"),
                                              "--checkpoint-every", "1"])
    os.environ["PHOTON_FAULTS"] = f"cd.boundary_saved:kill:{GAME_KILL_AT}"
    t0 = time.perf_counter()
    try:
        cli_train.run(argv)
        problems.append("the injected kill did not fire")
    except SimulatedKill:
        pass
    finally:
        del os.environ["PHOTON_FAULTS"]
        faults.clear()
    killed = time.perf_counter() - t0
    summary, wall, launches, shifts, s1 = _counted_train(torch, argv + ["--resume"])
    same = _game_models_equal(
        load_game_model(os.path.join(b["out"], "models", "best"), b["maps"], task="logistic_regression"),
        load_game_model(os.path.join(out, "models", "best"), b["maps"], task="logistic_regression"))
    log(f"  (c) killed at cd.boundary_saved call {GAME_KILL_AT} after {killed:.2f} s; the resumed run "
        f"{wall:.2f} s (launches {launches}, B3 with shifts {shifts}, S1 {s1}); its saved coefficients "
        f"bitwise (b)'s: {same}; best AUC {summary['best']['metrics']['AUC']:.6f}")
    if not same:
        problems.append("the resumed run's models differ from the straight run's")
    if summary["best"]["metrics"]["AUC"] != b["auc"]:
        problems.append("the resumed run's validation AUC differs from the straight run's")
    return {"killed_s": killed, "wall_s": wall}


def game_score(torch, validation, root, problems, b):
    """(d) cli.score.run on the validation parts with (b)'s best model:
    bitwise GameTransformer's, rtol 1e-5 of the plain route, AUC within
    1e-4 of (b)'s; S1's launches counted."""
    import os

    from photon_ml_tpu_torch.cli import score
    from photon_ml_tpu_torch.estimators import GameTransformer
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.serving import ScoreEngine

    model_dir = os.path.join(b["out"], "models", "best")
    argv = ["--input-data", validation, "--feature-shard", "name=global,bags=features",
            "--feature-shard", "name=userShard,bags=userFeatures", "--id-tags", "userId",
            "--model-input-dir", model_dir, "--evaluators", "AUC", "--output-dir", os.path.join(root, "scores"),
            "--log-level", "WARNING"]
    sparse.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, ev = score.run(argv)
    wall = time.perf_counter() - t0
    s1 = sparse.SPARSE_LAUNCHES["ell_matvec"]
    shards = {"global": FeatureShardConfig(("features",)), "userShard": FeatureShardConfig(("userFeatures",))}
    val, maps = read_avro_dataset(validation, shards, id_tag_columns=["userId"])
    model = load_game_model(model_dir, maps, task="logistic_regression")
    engine = ScoreEngine.from_model(model)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total, _ = GameTransformer(model=model).transform(val)
    engine_s = time.perf_counter() - t1
    plain = ScoreEngine.from_model(model, plain=True).score_dataset(val)
    bitwise = bool(np.array_equal(scores, total))
    ok_plain, diff = allclose(torch.from_numpy(np.asarray(scores)), torch.from_numpy(plain), 1e-5, 1e-6)
    gap = abs(ev.metrics["AUC"] - b["auc"])
    log(f"  (d) cli.score: {len(scores)} rows in {wall:.2f} s ({len(scores) / wall:.1f} rows/s, the read, the "
        f"model's load and the score file included); the engine alone {engine_s:.3f} s "
        f"({len(scores) / engine_s:.1f} rows/s); S1 ell_matvec launches {s1}; bitwise GameTransformer's "
        f"{bitwise}; vs the plain route max abs diff {diff:.3e} (rtol 1e-5) {'ok' if ok_plain else 'MISS'}; "
        f"AUC {ev.metrics['AUC']:.6f} vs (b)'s {b['auc']:.6f}, diff {gap:.2e} (1e-4)")
    if not (bitwise and ok_plain and gap <= 1e-4 and s1 == 1):
        problems.append(f"cli.score: bitwise {bitwise}, plain {ok_plain}, AUC gap {gap:.2e}, S1 launches {s1}")
    return {"wall_s": wall, "rows_per_s": len(scores) / wall, "engine_s": engine_s, "s1_launches": s1,
            "auc": ev.metrics["AUC"]}


def game_fault(torch, train, validation, root, problems, b):
    """(e) A coordinate.scores:nan:1 run: the poisoned first update is
    rejected, the models finish finite, and the rejection shows in
    photon_coordinate_rejections_total; the flight recorder leaves one dump
    under the metrics directory, and cli.report over it lists the dump."""
    import glob
    import os

    from photon_ml_tpu_torch.cli import report as report_cli
    from photon_ml_tpu_torch.io import load_game_model
    from photon_ml_tpu_torch.robust import faults

    out, metrics_dir = os.path.join(root, "out-e"), os.path.join(root, "metrics-e")
    os.environ["PHOTON_FAULTS"] = "coordinate.scores:nan:1"
    try:
        summary, wall, launches, shifts, s1 = _counted_train(
            torch, game_argv(train, validation, out, ["--metrics-out", metrics_dir]))
    finally:
        del os.environ["PHOTON_FAULTS"]
        faults.clear()
    rejections = summary["configs"][0]["rejections"]
    counted = _metric(_run_metrics(metrics_dir), "photon_coordinate_rejections_total")
    model = load_game_model(os.path.join(out, "models", "best"), b["maps"], task="logistic_regression")
    finite = bool(torch.isfinite(model["global"].model.coefficients.means).all()) and bool(
        torch.isfinite(model["per-user"].coef_values).all())
    log(f"  (e) coordinate.scores:nan:1: {wall:.2f} s, rejections {rejections}, "
        f"photon_coordinate_rejections_total {counted}, models finite {finite}, best AUC "
        f"{summary['best']['metrics']['AUC']:.6f}")
    if not (sum(rejections.values()) > 0 and counted > 0 and finite):
        problems.append(f"the poisoned update was not rejected cleanly: {rejections}, counted {counted}, "
                        f"finite {finite}")
    dumps = sorted(os.path.relpath(p, metrics_dir) for p in glob.glob(os.path.join(metrics_dir, "flight", "flight-*.json")))
    listed = report_cli.run([metrics_dir, "--out", os.path.join(root, "report-e"), "--log-level", "WARNING"])["flight"]
    log(f"  (e) flight dumps {dumps}; cli.report lists {[(d['trigger'], d['path']) for d in listed]}")
    if len(dumps) != 1 or [d["path"] for d in listed] != dumps:
        problems.append(f"(e): flight dumps {dumps}, listed by cli.report {listed}")
    return {"wall_s": wall, "rejections": rejections, "flight_dumps": dumps}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _poll_endpoints(base, alive, paths=("/statusz", "/metrics", "/healthz"), stop=None):
    """GETs each of ``paths`` under ``base`` every 0.1 s while ``alive()``
    (and ``stop`` is unset): the count of 200 answers by path."""
    import urllib.error
    import urllib.request

    answered = dict.fromkeys(paths, 0)
    while alive() and not (stop is not None and stop.is_set()):
        for path in paths:
            try:
                with urllib.request.urlopen(base + path, timeout=5) as r:
                    answered[path] += r.status == 200
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
        time.sleep(0.1)
    return answered


def game_observed(torch, train, validation, root, problems, b, busy_share):
    """(f) (b)'s fit with every telemetry flag on (--metrics-out,
    --trace-out, --status-port, --report-out; no checkpoints, so that the
    report's directory holds what cli.report reads), cli.train.run on a
    thread with every counter at 0 before it while this thread polls the
    endpoints: the same launches and the same best model as (b), the
    timeline's per-sweep identity, the Chrome trace, the card's peak memory,
    the report rebuilt byte for byte and no flight dump. First the same
    fit with no flag at all, so that the telemetry's cost reads as the
    difference of two walls of one configuration (the peak allocator bytes
    reset before each)."""
    import glob
    import os
    import subprocess
    import tempfile
    import threading

    from photon_ml_tpu_torch.io import load_game_model
    from photon_ml_tpu_torch.obs import report as report_mod

    torch.cuda.reset_peak_memory_stats()
    _, bare_wall, *bare_launches = _counted_train(torch, game_argv(train, validation, os.path.join(root, "out-f-bare")))
    bare_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    froot = os.path.join(root, "observed-f")
    out, metrics_dir, report_dir = (os.path.join(froot, k) for k in ("out", "metrics", "report"))
    trace = os.path.join(froot, "trace.json")
    port = _free_port()
    argv = game_argv(train, validation, out, ["--metrics-out", metrics_dir, "--trace-out", trace,
                                              "--status-port", str(port), "--report-out", report_dir])
    result = {}

    def body():
        try:
            result["run"] = _counted_train(torch, argv)
        except BaseException as e:  # re-raised on this thread below
            result["error"] = e

    t = threading.Thread(target=body, name="chip-smoke-train-f")
    t.start()
    answered = _poll_endpoints(f"http://127.0.0.1:{port}", t.is_alive)
    t.join()
    if "error" in result:
        raise result["error"]
    summary, wall, launches, shifts, s1 = result["run"]
    same_launches = [launches, shifts, s1] == [b["launches"], b["shift_launches"], b["s1_launches"]] == bare_launches
    same_model = _game_models_equal(
        load_game_model(os.path.join(b["out"], "models", "best"), b["maps"], task="logistic_regression"),
        load_game_model(os.path.join(out, "models", "best"), b["maps"], task="logistic_regression"))

    with open(os.path.join(metrics_dir, "run_summary.json")) as f:
        rs = json.load(f)
    tl = rs["timeline"]
    identity = [math.isclose(w["critical_path_seconds"] + w["other_seconds"], w["wall_seconds"], rel_tol=1e-6)
                for w in tl["sweeps"]]
    with open(trace) as f:
        xs = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    with open(os.path.join(metrics_dir, "metrics.jsonl")) as f:
        closed = sum(json.loads(line).get("type") == "span" for line in f)
    n_sweeps = sum(e["name"] == "cd.sweep" for e in xs)
    card = torch.cuda.current_device()
    peak = _metric(rs["metrics"], "photon_mem_device_peak_bytes_in_use", device=f"cuda:{card}")
    total = torch.cuda.get_device_properties(card).total_memory
    flight = glob.glob(os.path.join(metrics_dir, "flight", "flight-*.json"))

    # the report: rebuilt by cli.report in a process of its own, beside
    # its build in process from the same directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_report_") as tmp:
        rebuilt = os.path.join(tmp, "cli")
        t1 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "photon_ml_tpu_torch.cli.report", froot, "--out", rebuilt,
                                 "--log-level", "WARNING"], cwd=str(pathlib.Path(__file__).resolve().parent),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            t0 = time.perf_counter()
            report_mod.write_report(report_mod.build_report(report_mod.discover(froot)),
                                    os.path.join(tmp, "in-process"))
            build_s = time.perf_counter() - t0
            proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        cli_s = time.perf_counter() - t1
        with open(os.path.join(report_dir, "report.json"), "rb") as f:
            trained_bytes = f.read()
        rebuilt_bytes = open(os.path.join(rebuilt, "report.json"), "rb").read() if proc.returncode == 0 else b""
    same_report = proc.returncode == 0 and rebuilt_bytes == trained_bytes

    log(f"  (f) every telemetry flag on: {wall:.2f} s; the same fit with no flag {bare_wall:.2f} s; (b) "
        f"{b['wall_s']:.2f} s (with --checkpoint-dir: the model saved in Avro after each sweep and at the end, and "
        f"{int(b['checkpoint_saves'])} boundary checkpoints); each wall ends in a synchronize; stages (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in summary["stage_seconds"].items())
        + f"; 200 answers while training {answered}; launches {launches}, B3 with shifts {shifts}, S1 ell_matvec "
          f"{s1}: (b)'s and the bare fit's {same_launches}; best model bitwise (b)'s {same_model}")
    log(f"  (f) Chrome trace: {len(xs)} complete events for {closed} closed spans, {n_sweeps} cd.sweep; timeline "
        f"identity critical_path + other == wall (rel 1e-6) per sweep {identity}; peak memory on cuda:{card} "
        f"{int(peak)} of {total} bytes (the bare fit's max_memory_allocated {bare_peak}); flight dumps {len(flight)}; report.json {len(trained_bytes)} bytes, built in "
        f"{build_s:.3f} s in process, rebuilt by cli.report in {cli_s:.2f} s (a process of its own, beside it): byte for "
        f"byte {same_report}")
    for w in tl["sweeps"]:
        log(f"  (f) sweep {w['iteration']}: wall {w['wall_seconds']:.3f} s, phases (s) "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(w["phases"].items()))
            + f", other {w['other_seconds']:.3f} s, overlap {w['overlap_factor']:.3f}; per coordinate "
            + "; ".join(f"{c}: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(ph.items()))
                        for c, ph in sorted(w["coordinates"].items())))
    log(f"  (f) beside phase 5's profiled sweep, which kept the card busy "
        f"{busy_share if busy_share is not None else float('nan'):.3f} of its wall: a span closes on the host "
        f"clock, so each phase above holds the card's work that the host waited for while it was open")
    if not (answered["/statusz"] and answered["/metrics"]):
        problems.append(f"(f): no 200 from /statusz or /metrics while training: {answered}")
    if not same_launches:
        problems.append(f"(f): launches {launches}, shifts {shifts}, S1 {s1} against (b)'s {b['launches']}, "
                        f"{b['shift_launches']}, {b['s1_launches']}")
    if not same_model:
        problems.append("(f): the best model differs from (b)'s")
    if tl["n_sweeps"] != 2 or not all(identity) or n_sweeps != 2 or len(xs) != closed:
        problems.append(f"(f): timeline sweeps {tl['n_sweeps']}, identity {identity}, trace cd.sweep {n_sweeps}, "
                        f"events {len(xs)} for {closed} spans")
    if not 0 < peak < total:
        problems.append(f"(f): peak memory {peak} on cuda:{card} not in (0, {total})")
    if flight:
        problems.append(f"(f): a clean run left flight dumps {flight}")
    if not same_report:
        problems.append(f"(f): cli.report did not rebuild report.json byte for byte (exit {proc.returncode}: "
                        f"{proc.stderr[-2000:]})")
    return {"wall_s": wall, "bare_wall_s": bare_wall, "bare_peak_bytes": bare_peak,
            "stage_seconds": summary["stage_seconds"], "launches": launches, "shift_launches": shifts,
            "s1_launches": s1, "answered": answered, "timeline": tl, "peak_bytes": peak, "report_build_s": build_s,
            "report_cli_s": cli_s, "metrics_dir": metrics_dir}


def game_fixture(root, seed):
    """Phase 12 (a): the fixture's part files under ``root`` (phases 12 and
    13 read them): (train dir, validation dir, wall seconds, summed writer
    seconds)."""
    reused = _WRITER_POOL is not None
    train, validation, day3, wall, writer_s = game_write(root, seed)
    if reused:
        log("  (a) cut to make room for phase 18: written by the writer processes started beside the build, kept "
            "(no process start here)")
    rows = IO_TRAIN[0] + IO_VALIDATION[0]
    log(f"  (a) wrote {rows} rows ({IO_NNZ} global and {GAME_RE_FEATURES} per-user features a row, "
        f"{GAME_USERS} Zipf(1.1) users) into {IO_TRAIN[1]} + {IO_VALIDATION[1]} deflate parts, and phase 14's "
        f"day 3 ({RETRAIN_DAY3[0]} parts of {RETRAIN_DAY3[1]} drawn rows, the even users' kept), in {wall:.2f} s "
        f"by worker processes (the fixture's writers' own seconds summed {writer_s:.2f})")
    return {"root": root, "train": train, "validation": validation, "day3": day3, "wall_s": wall,
            "writer_s": writer_s}


def game_phase(torch, fixture, smi, busy_share=None, keep=None):
    """Phase 12 (b)-(f) on the fixture of (a): the GAME driver with boundary
    checkpoints, killed and resumed, cli.score, a NaN-injected run and the
    driver with every telemetry flag on. (b)'s and (f)'s metrics
    directories are copied under ``keep`` for phase 15's cli.fleetz."""
    import os
    import shutil

    problems, out = [], {"write": {"wall_s": fixture["wall_s"], "writer_s": fixture["writer_s"]}}
    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    b = game_train(torch, train, validation, root, problems, smi)
    torch.cuda.empty_cache()
    out["resume"] = game_resume(torch, train, validation, root, problems, b)
    out["score"] = game_score(torch, validation, root, problems, b)
    out["fault"] = game_fault(torch, train, validation, root, problems, b)
    torch.cuda.empty_cache()
    out["observed"] = game_observed(torch, train, validation, root, problems, b, busy_share)
    out["train"] = {k: v for k, v in b.items() if k not in ("maps", "out", "coords")}
    # phase 16 (e) holds its streamed fit against (b)'s best model, phase 17
    # its two-rank fit (main drops "b", and the card memory of its
    # coordinates, after phase 17)
    out["best"] = {"maps": b["maps"], "out": b["out"], "auc": b["auc"]}
    out["b"] = b
    if keep is not None:
        for name, src in (("metrics-b", os.path.join(root, "metrics-b")), ("metrics-f", out["observed"]["metrics_dir"])):
            shutil.copytree(src, os.path.join(keep, name))
    log(f"  on {smi}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ------------------------------------------------- phase 17: distributed
#
# GAME training and scoring across processes on phase 12's fixture:
# ``python -m photon_ml_tpu_torch.cli.train --distributed
# coordinator=127.0.0.1:PORT,process=I,n=2``, two ranks sharing the card over
# gloo, each reading its 100,000 rows (per-host reads, the cross-rank random-
# effect build of game/data_mp.py, B1-B3 joined by B4); the kill-a-worker
# drill and its resume; cli.score --distributed; cli.fleetz over the ranks'
# streams; one rank over NCCL; and out of core across processes (phase 16
# (e)'s argv on two gloo ranks and on one NCCL rank).

DIST_WORLD = 2
DIST_BUDGET_S = 10.0  # (b)'s --collective-timeout
DIST_KILL_AT = 2  # dist.collective on rank 1: its second sweep boundary
DIST_TIMEOUT_S = 300.0  # each launch of ranks, start to exit
DIST_DEVICE = "cuda"  # every rank's --device and the device of the models phase 17 loads
# a rank: cli.train.run or cli.score.run on argv, then its launch counts, its
# wall and (train) its stage seconds and the sha256 of every normalization's
# inputs as JSON to the first argument (with SMOKE_RECORD_RESIDUALS
# "<coordinate>:<dir>", also the residual each solve of that fixed effect is
# handed); no JAX, as every rank of the port
RANK_RUNNER = r"""
import hashlib, json, os, sys, time
t0 = time.perf_counter()
import numpy as np
from photon_ml_tpu_torch.cli import score, train
from photon_ml_tpu_torch.ops import fused_glm as fg, sparse
out_path, cli, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
digests = []
real = train.build_normalization
def recording(kind, mean, variance, max_magnitude, **kw):
    digests.append(hashlib.sha256(b"".join(np.ascontiguousarray(a, dtype=np.float64).tobytes()
                                           for a in (mean, variance, max_magnitude))).hexdigest())
    return real(kind, mean, variance, max_magnitude, **kw)
train.build_normalization = recording
record = os.environ.get("SMOKE_RECORD_RESIDUALS")
if record:
    # "<coordinate>:<dir>": the residual each solve of that fixed effect is
    # handed (.npy) and the solve's histories (.json), numbered from 1
    from photon_ml_tpu_torch.game import coordinate as co
    watched, directory = record.split(":", 1)
    real_train, calls = co.FixedEffectCoordinate.train, []
    def recording_train(self, residual_scores, *args, **kwargs):
        out = real_train(self, residual_scores, *args, **kwargs)
        if self.coordinate_id == watched and residual_scores is not None:
            calls.append(1)
            stem = os.path.join(directory, f"{watched}-{len(calls)}")
            np.save(stem + ".npy", residual_scores.detach().cpu().numpy())
            r = out[1]
            hist = lambda h: [x for x in np.asarray(h.detach().cpu(), dtype=np.float64).tolist() if x == x]
            with open(stem + ".json", "w") as f:
                json.dump({"iterations": int(r.iterations), "reason": int(r.reason),
                           "losses": hist(r.loss_history), "grad_norms": hist(r.grad_norm_history)}, f)
        return out
    co.FixedEffectCoordinate.train = recording_train
result =(train if cli == "train" else score).run(argv)
doc = {"wall_s": time.perf_counter() - t0, "launches": dict(fg.LAUNCHES), "shifts": dict(fg.SHIFT_LAUNCHES),
       "sharded": dict(fg.SHARDED_LAUNCHES), "sums": dict(fg.SUM_LAUNCHES), "sparse": dict(sparse.SPARSE_LAUNCHES),
       "routes": dict(fg.OBJECTIVE_ROUTES), "normalization": digests}
if cli == "train":
    doc["stage_seconds"] = result["stage_seconds"]
    doc["model_sha256"] = result["best"]["model_sha256"]
with open(out_path, "w") as f:
    json.dump(doc, f)
"""


def _start_ranks(root, name, argv, world=DIST_WORLD, module=None, env_by_rank=None):
    """Start ``world`` ranks on the card, joined at a free local port:
    through RANK_RUNNER (``module`` None: its JSON under
    ``root/name-r<i>.json``) or as ``python -m
    photon_ml_tpu_torch.cli.<module>``. Returns (name, the processes, the
    start time on the host clock) for ``_wait_ranks``."""
    import os
    import subprocess

    repo = str(pathlib.Path(__file__).resolve().parent)
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for i in range(world):
        env = dict(os.environ, PYTHONPATH=repo)
        env.pop("PHOTON_FAULTS", None)
        env.update((env_by_rank or {}).get(i, {}))
        head = ([sys.executable, "-m", f"photon_ml_tpu_torch.cli.{module}"] if module else
                [sys.executable, "-c", RANK_RUNNER, os.path.join(root, f"{name}-r{i}.json"), name.split("-")[0]])
        procs.append(subprocess.Popen(
            head + argv + ["--device", DIST_DEVICE, "--distributed", f"coordinator=127.0.0.1:{port},process={i},n={world}"],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return name, procs, t0


def _wait_ranks(started):
    """Wait for the ranks of ``_start_ranks``: (each rank's (exit code,
    stdout, stderr, exit time on the host clock), the start time); every
    rank still running DIST_TIMEOUT_S after the start is killed."""
    name, procs, t0 = started
    ended = [None] * len(procs)
    try:
        while any(e is None for e in ended):
            for i, p in enumerate(procs):
                if ended[i] is None and p.poll() is not None:
                    ended[i] = time.perf_counter()
            if time.perf_counter() - t0 > DIST_TIMEOUT_S:
                raise TimeoutError(f"ranks {[i for i, e in enumerate(ended) if e is None]} of {name} still running "
                                   f"after {DIST_TIMEOUT_S:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, p.stdout.read(), p.stderr.read(), ended[i]) for i, p in enumerate(procs)], t0


def _dist_ranks(root, name, argv, world=DIST_WORLD, module=None, env_by_rank=None):
    """``_start_ranks`` and ``_wait_ranks`` in one."""
    return _wait_ranks(_start_ranks(root, name, argv, world, module, env_by_rank))


def _rank_docs(root, name, world=DIST_WORLD):
    import os

    docs = []
    for i in range(world):
        with open(os.path.join(root, f"{name}-r{i}.json")) as f:
            docs.append(json.load(f))
    return docs


def _prom_series(path, prefix):
    """``{(name, labels): value}`` of the series under ``prefix`` in a
    Prometheus text file."""
    from photon_ml_tpu_torch.obs import fleet

    with open(path) as f:
        return {(m["name"], tuple(sorted(m["labels"].items()))): m.get("value") for m in fleet.parse_prometheus(f.read())
                if m["name"].startswith(prefix)}


def _ranks_failed(outs, what):
    bad = [(i, rc, err[-3000:]) for i, (rc, _, err, _) in enumerate(outs) if rc != 0]
    return f"{what}: ranks exited {[(i, rc) for i, rc, _ in bad]}:\n" + "\n".join(e for _, _, e in bad) if bad else None


def _differing_bits(a, b):
    """Bits that differ between two tensors of one dtype and shape."""
    import torch

    x = a.reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
    y = b.reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
    return int(np.unpackbits(np.bitwise_xor(x, y)).sum())


def _model_bit_gap(a, b):
    """(differing bits, max abs difference) over two GAME models' fixed- and
    random-effect values (the random effect keyed by entity id)."""
    import torch

    fa, fb = a["global"].model.coefficients, b["global"].model.coefficients
    bits = _differing_bits(fa.means, fb.means) + _differing_bits(fa.variances, fb.variances)
    gap = max(float((fa.means - fb.means).abs().max()), float((fa.variances - fb.variances).abs().max()))
    ra, rb = a["per-user"], b["per-user"]
    ids = [str(e) for e in rb.entity_ids if not str(e).startswith("__pad")]
    rows_a = torch.as_tensor(ra.rows_for(ids), dtype=torch.long)
    rows_b = torch.as_tensor(rb.rows_for(ids), dtype=torch.long)
    if bool((rows_a < 0).any()):
        return None, float("inf")
    dim = int(max(int(ra.coef_indices.max()), int(rb.coef_indices.max()))) + 1
    da, db = ra.dense_coefficients(dim)[rows_a], rb.dense_coefficients(dim)[rows_b]
    da, db = torch.as_tensor(np.asarray(da)), torch.as_tensor(np.asarray(db))
    return bits + _differing_bits(da, db), max(gap, float((da - db).abs().max()))


def _re_losses(torch, coord, model, residual, l2):
    """Each entity's L2-regularized logistic loss, in float64 on the
    coordinate's blocks, at ``model``'s coefficients (projected by entity
    id and feature) on ``residual``: one function for both sides of a
    comparison."""
    from photon_ml_tpu_torch.game.coordinate import _project_model_values

    ds = coord.dataset
    b = ds.blocks
    w = _project_model_values(ds, model, model.coef_values, torch.float64)
    valid = b.active_rows >= 0
    off = b.offsets.double() + residual.double()[b.active_rows.clamp(min=0).long()] * valid
    z = torch.einsum("eks,es->ek", b.features.double(), w) + off
    ll = b.weights.double() * (torch.nn.functional.softplus(z) - b.labels.double() * z)
    return ll.sum(dim=1) + 0.5 * l2 * (w * w).sum(dim=1)


def _load_boundary(directory, step):
    """A boundary checkpoint's validated payload (the two-phase shards
    concatenated), by its sequence number."""
    import os

    from photon_ml_tpu_torch.robust import CheckpointManager

    mgr = CheckpointManager(directory)
    _, payload = mgr._load_validated(os.path.join(directory, f"ckpt-{step:06d}"))
    return payload


def dist_train(torch, fixture, b, index_dir, problems, smi):
    """(a) Two cli.train ranks sharing the card over gloo, every update a
    two-phase boundary checkpoint, --metrics-out: each rank's launches of
    B1, B2, B3 with shifts and B4, its walls and its photon_re_build_*
    series; the coordinator's best model against phase 12 (b)'s (FE
    coefficients and variances rtol 1e-3 / atol 1e-5; the RE retrained on
    one card on the two-rank run's last residual and warm start, atol 5e-3,
    per-entity loss atol 1e-4; the chained RE difference printed;
    validation AUC within 2e-3); each rank's normalization inputs bitwise
    alike."""
    import os

    from photon_ml_tpu_torch.io import load_game_model

    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    out, ck, metrics = (os.path.join(root, p) for p in ("out-17a", "ck-17a", "metrics-17a"))
    argv = game_argv(train, validation, out, ["--feature-index-dir", index_dir, "--checkpoint-dir", ck,
                                              "--checkpoint-every", "1", "--checkpoint-keep", "4",
                                              "--metrics-out", metrics])
    outs, t0 = _dist_ranks(root, "train-17a", argv)
    wall = max(o[3] for o in outs) - t0
    failed = _ranks_failed(outs, "(a) cli.train --distributed")
    if failed:
        raise AssertionError(failed)
    docs = _rank_docs(root, "train-17a")
    with open(os.path.join(metrics, "run_summary.json")) as f:
        summary = json.load(f)
    auc = summary["best"]["metrics"]["AUC"]
    builds = [_prom_series(os.path.join(metrics, "metrics.prom" if r == 0 else f"metrics.p{r}.prom"),
                           "photon_re_build") for r in range(DIST_WORLD)]
    for r, d in enumerate(docs):
        mine = {k[0].removeprefix("photon_re_build_"): v for k, v in builds[r].items()
                if dict(k[1]).get("process", str(r)) == str(r)}
        log(f"  (a) rank {r}: wall {d['wall_s']:.2f} s (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in d["stage_seconds"].items())
            + f"); launches {d['launches']}, B3 with shifts {d['shifts']['fused_hessian_stats']}, B4 {d['sharded']}, "
              f"rank-order sums {d['sums']}; RE build {mine}")
        if min(d["launches"]["fused_value_grad"], d["launches"]["fused_hessian_vector"],
               d["shifts"]["fused_hessian_stats"], *d["sharded"].values()) <= 0:
            problems.append(f"(a) rank {r} did not launch B1, B2, B3 with shifts and every B4: {d}")
    alike = len({tuple(d["normalization"]) for d in docs}) == 1 and bool(docs[0]["normalization"])
    log(f"  (a) two ranks over {summary.get('distributed')}: {wall:.2f} s from the first start to the last exit; "
        f"normalization inputs bitwise alike on every rank: {alike}; validation AUC {auc:.6f} (phase 12 (b) "
        f"{b['auc']:.6f}) on {smi}")
    if summary.get("distributed") != {"backend": "gloo", "world_size": DIST_WORLD}:
        problems.append(f"(a) the run summary records {summary.get('distributed')}, not gloo over {DIST_WORLD}")
    if not alike:
        problems.append(f"(a) the ranks' normalization inputs differ: {[d['normalization'] for d in docs]}")
    if abs(auc - b["auc"]) > 2e-3:
        problems.append(f"(a) validation AUC {auc:.6f} against phase 12 (b)'s {b['auc']:.6f} (2e-3)")
    maps = b["maps"]
    best = load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    ref = load_game_model(os.path.join(b["out"], "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    fa, fb = best["global"].model.coefficients, ref["global"].model.coefficients
    hold(problems, "(a) two ranks vs phase 12 (b): FE coefficients", fa.means, fb.means, 1e-3, 1e-5)
    hold(problems, "(a) two ranks vs phase 12 (b): FE variances", fa.variances, fb.variances, 1e-3, 1e-5)
    # the random effect on identical residuals: the two-rank run's last RE
    # update retrained on one card from its residual and warm start (the
    # boundary checkpoint before it; shards concatenated), both models'
    # per-entity losses evaluated alike
    boundaries = os.path.join(ck, "cd-boundaries")
    state, last = _load_boundary(boundaries, 2), _load_boundary(boundaries, 3)
    re_coord = b["coords"]["per-user"]
    dev = re_coord.dataset.device

    def on_card(m):
        return dataclasses.replace(m, coef_indices=m.coef_indices.to(dev), coef_values=m.coef_values.to(dev))

    re1 = on_card(state["models"]["per-user"])
    residual = state["summed_scores"].to(dev) - re_coord.score(re1)
    one, _ = re_coord.train(residual, initial_model=re1)
    two = on_card(last["models"]["per-user"])
    from photon_ml_tpu_torch.game.coordinate import _project_model_values

    ds = re_coord.dataset
    hold(problems, "(a) two ranks vs one card: RE coefficients (identical residuals)",
         _project_model_values(ds, two, two.coef_values, torch.float32), one.coef_values, 0.0, 5e-3)
    l2 = float(re_coord.config.reg_weight)
    hold(problems, "(a) two ranks vs one card: RE per-entity loss (identical residuals)",
         _re_losses(torch, re_coord, two, residual, l2), _re_losses(torch, re_coord, one, residual, l2), 0.0, 1e-4)
    rb = on_card(ref["per-user"])
    _, chained = allclose(_project_model_values(ds, two, two.coef_values, torch.float32),
                          _project_model_values(ds, rb, rb.coef_values, torch.float32), 0.0, 5e-3)
    log(f"  (a) (for the record) RE chained on each run's own fixed effect: max abs diff {chained:.3e}")
    return {"wall_s": wall, "ranks": docs, "auc": auc, "out": out, "metrics": metrics, "re_build": builds,
            "normalization_alike": alike}


def dist_drill(torch, fixture, a, index_dir, problems, smi, before_resume=None):
    """(b) The kill-a-worker drill: rank 1 dies at its second sweep boundary
    (PHOTON_FAULTS=dist.collective:kill:2), --collective-timeout 10,
    heartbeats every 0.5 s, stale after 3 s (``before_resume`` is called
    once the drill is judged, before the resume). Rank 0 must exit non-zero with
    DistributedTimeoutError or PeerLostError naming process 1 within the
    budget plus 5 s of rank 1's death and leave a peer_lost dump; both ranks
    then resume and the final model must equal (a)'s within 1e-9 (the
    differing bits printed; bitwise is expected)."""
    import glob
    import os

    from photon_ml_tpu_torch.io import load_game_model

    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    out, ck, metrics = (os.path.join(root, p) for p in ("out-17b", "ck-17b", "metrics-17b"))
    argv = game_argv(train, validation, out, [
        "--feature-index-dir", index_dir, "--checkpoint-dir", ck, "--checkpoint-every", "1", "--metrics-out", metrics,
        "--collective-timeout", f"{DIST_BUDGET_S:g}", "--heartbeat-interval", "0.5", "--heartbeat-timeout", "3",
    ])
    outs, t0 = _dist_ranks(root, "drill-17b", argv, module="train",
                           env_by_rank={1: {"PHOTON_FAULTS": f"dist.collective:kill:{DIST_KILL_AT}"}})
    (rc0, _, err0, end0), (rc1, _, err1, end1) = outs
    detect = end0 - end1
    typed = next((t for t in ("DistributedTimeoutError", "PeerLostError") if f"{t}:" in err0), None)
    named = "[1]" in (err0.strip().splitlines() or [""])[-1]
    dumps = glob.glob(os.path.join(metrics, "flight", "flight-peer_lost-*.json"))
    last = (err0.strip().splitlines() or [""])[-1]
    log(f"  (b) rank 1 killed at dist.collective call {DIST_KILL_AT} (exit {rc1}, SimulatedKill "
        f"{'SimulatedKill' in err1}) {end1 - t0:.2f} s after the start; rank 0 exited {rc0} {detect:.2f} s after "
        f"it (budget {DIST_BUDGET_S:g} s + 5): {last[:400]}; peer_lost dumps {len(dumps)}")
    if not (rc1 != 0 and rc0 != 0 and typed and named and detect <= DIST_BUDGET_S + 5 and dumps):
        problems.append(f"(b) the drill: rank 0 exit {rc0}, typed {typed}, names process 1 {named}, "
                        f"{detect:.2f} s after the kill, dumps {len(dumps)}; rank 0's end:\n{err0[-2000:]}")
        return {"detect_s": detect}
    if before_resume is not None:
        before_resume()
    t1 = time.perf_counter()
    outs, _ = _dist_ranks(root, "resume-17b", argv + ["--resume"], module="train")
    resume_s = time.perf_counter() - t1
    failed = _ranks_failed(outs, "(b) the resumed ranks")
    if failed:
        problems.append(failed)
        return {"detect_s": detect}
    maps = a["maps"]
    resumed = load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    straight = load_game_model(os.path.join(a["out"], "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    bits, gap = _model_bit_gap(resumed.models, straight.models)
    log(f"  (b) both ranks resumed in {resume_s:.2f} s; the final model against (a)'s: {bits} differing bits, "
        f"max abs diff {gap:.3e} (1e-9) on {smi}")
    if bits is None or gap > 1e-9:
        problems.append(f"(b) the resumed model differs from (a)'s by {gap:.3e} ({bits} bits)")
    return {"detect_s": detect, "killed_at_s": end1 - t0, "resume_s": resume_s, "differing_bits": bits}


def dist_score(torch, fixture, a, index_dir, problems, smi):
    """(c) cli.score --distributed on two ranks over the validation parts
    with (a)'s best model: the union of the ranks' part files against the
    one-process scores of the same model (phase 12 (d)'s path,
    GameTransformer.transform) at rtol 1e-5, the bitwise-equal rows
    counted; the AUC over every rank's rows within 1e-4 of the one-process
    AUC; S1 launched on each rank."""
    import os

    from photon_ml_tpu_torch.estimators import GameTransformer
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset, read_avro_file

    root, validation = fixture["root"], fixture["validation"]
    model_dir, out = os.path.join(a["out"], "models", "best"), os.path.join(root, "scores-17c")
    argv = ["--input-data", validation, "--feature-shard", "name=global,bags=features",
            "--feature-shard", "name=userShard,bags=userFeatures", "--id-tags", "userId", "--feature-index-dir",
            index_dir, "--model-input-dir", model_dir, "--evaluators", "AUC", "--output-dir", out,
            "--log-level", "WARNING"]
    outs, t0 = _dist_ranks(root, "score-17c", argv)
    wall = max(o[3] for o in outs) - t0
    failed = _ranks_failed(outs, "(c) cli.score --distributed")
    if failed:
        raise AssertionError(failed)
    docs = _rank_docs(root, "score-17c")
    got = np.concatenate([
        np.asarray([r["predictionScore"] for r in read_avro_file(os.path.join(out, f"scores-part-{i:04d}.avro"))[1]])
        for i in range(DIST_WORLD)])
    with open(os.path.join(out, "evaluation.json")) as f:
        auc = json.load(f)["AUC"]
    shards = {"global": FeatureShardConfig(("features",)), "userShard": FeatureShardConfig(("userFeatures",))}
    val, _ = read_avro_dataset(validation, shards, index_maps=a["maps"], id_tag_columns=["userId"])
    model = load_game_model(model_dir, a["maps"], task="logistic_regression", device=DIST_DEVICE)
    want, ev = GameTransformer(model=model, device=DIST_DEVICE).transform(val, evaluator_specs=["AUC"])
    ok, diff = allclose(torch.from_numpy(got), torch.from_numpy(np.asarray(want)), 1e-5, 1e-6)
    same = int(np.sum(got == np.asarray(want))) if got.shape == np.asarray(want).shape else 0
    s1 = [d["sparse"]["ell_matvec"] for d in docs]
    gap = abs(auc - ev.metrics["AUC"])
    log(f"  (c) cli.score --distributed: {len(got)} rows in {wall:.2f} s over {DIST_WORLD} ranks; against the "
        f"one-process scores of the same model: max abs diff {diff:.3e} (rtol 1e-5) {'ok' if ok else 'MISS'}, "
        f"{same} of {len(got)} rows bitwise equal; AUC {auc:.6f} vs {ev.metrics['AUC']:.6f} ({gap:.2e}, 1e-4); "
        f"S1 ell_matvec launches per rank {s1} on {smi}")
    if not (ok and gap <= 1e-4 and min(s1) > 0):
        problems.append(f"(c) distributed scores: rtol {ok} ({diff:.3e}), AUC gap {gap:.2e}, S1 launches {s1}")
    return {"wall_s": wall, "rows": len(got), "bitwise_rows": same, "auc": auc, "s1_launches": s1}


def dist_fleetz(torch, a, problems):
    """(d) cli.fleetz in artifacts mode (its ``run``, in process) over (a)'s
    metrics directory, the coordinator's stream and metrics.p1.jsonl: every
    merged counter is the sum of the two ranks' final snapshots, bit for
    bit (as the exposition renders them)."""
    import os
    import tempfile

    from photon_ml_tpu_torch.cli import fleetz
    from photon_ml_tpu_torch.obs import fleet

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleetz17_") as tmp:
        t0 = time.perf_counter()
        fleetz.run([a["metrics"], "--out", tmp, "--log-level", "WARNING"])
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "fleet.prom")) as f:
            prom = f.read()
    merged = {(m["name"], tuple(sorted(m["labels"].items()))): m["value"] for m in fleet.parse_prometheus(prom)
              if m["kind"] == "counter" and not m["name"].startswith("photon_fleet_")}
    streams = fleet.discover_streams([a["metrics"]])
    want = {}
    for s in streams:
        for m in s.snapshot:
            if m["kind"] == "counter":
                key = (m["name"], tuple(sorted(m["labels"].items())))
                want[key] = want.get(key, 0.0) + m["value"]
    # as the exposition renders them: 10 significant digits
    want = {k: float(f"{v:.10g}") for k, v in want.items()}
    log(f"  (d) cli.fleetz over (a)'s {len(streams)} rank streams (processes "
        f"{sorted(s.process_index for s in streams)}) in {wall:.2f} s: {len(merged)} merged counter series, the "
        f"ranks' sums {'equal' if merged == want else 'DIFFER'}")
    if not merged or merged != want or len(streams) != DIST_WORLD:
        problems.append(f"(d) cli.fleetz: {len(merged)} series against {len(want)}, {len(streams)} streams")
    return {"wall_s": wall, "series": len(merged)}


def dist_nccl_start(fixture, index_dir):
    """(e)'s rank, started before (c) and (d) so that it runs beside them:
    neither reads anything of it, and the walls printed are walls beside
    another run."""
    import os

    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    out, metrics = os.path.join(root, "out-17e"), os.path.join(root, "metrics-17e")
    argv = game_argv(train, validation, out, ["--feature-index-dir", index_dir, "--metrics-out", metrics])
    return _start_ranks(root, "train-17e", argv, world=1)


def dist_nccl(torch, fixture, b, started, problems, smi):
    """(e) One rank over NCCL (--distributed ...,n=1 on the card), started
    by ``dist_nccl_start``: the saved models bitwise phase 12 (b)'s (B4 of
    one rank is B1-B3's bits; the one-rank build is the one-process
    build's)."""
    import os

    from photon_ml_tpu_torch.io import load_game_model

    root = fixture["root"]
    out, metrics = os.path.join(root, "out-17e"), os.path.join(root, "metrics-17e")
    outs, t0 = _wait_ranks(started)
    failed = _ranks_failed(outs, "(e) cli.train over NCCL at world 1")
    if failed:
        raise AssertionError(failed)
    (doc,) = _rank_docs(root, "train-17e", world=1)
    with open(os.path.join(metrics, "run_summary.json")) as f:
        backend = json.load(f).get("distributed")
    maps = b["maps"]
    got = load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    ref = load_game_model(os.path.join(b["out"], "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    bits, gap = _model_bit_gap(got.models, ref.models)
    log(f"  (e) one rank over {backend}: wall {doc['wall_s']:.2f} s (beside (c) and (d)); launches {doc['launches']}, B4 "
        f"{doc['sharded']}, rank-order sums {doc['sums']}; the saved models against phase 12 (b)'s: {bits} differing "
        f"bits (max abs diff {gap:.3e}) on {smi}")
    if backend != {"backend": "nccl", "world_size": 1}:
        problems.append(f"(e) the one-rank run ran over {backend}, not NCCL")
    if bits != 0 or min(doc["sharded"].values()) <= 0:
        problems.append(f"(e) NCCL at world 1: {bits} bits differ from phase 12 (b)'s models; B4 {doc['sharded']}")
    return {"wall_s": doc["wall_s"], "launches": doc["launches"], "sharded": doc["sharded"], "sums": doc["sums"],
            "differing_bits": bits}


def dist_stream_start(fixture, index_dir):
    """(f)'s two ranks and (g)'s one, started at once (beside (b)'s resume
    and (c)-(e)): each through phase 16 (e)'s argv (``stream_game_argv``)."""
    import os

    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    out, ck, metrics = (os.path.join(root, p) for p in ("out-17f", "ck-17f", "metrics-17f"))
    two = _start_ranks(root, "train-17f", stream_game_argv(train, validation, out, [
        "--feature-index-dir", index_dir, "--checkpoint-dir", ck, "--checkpoint-every", "1", "--checkpoint-keep", "4",
        "--metrics-out", metrics]))
    try:
        one = _start_ranks(root, "train-17g", stream_game_argv(
            train, validation, os.path.join(root, "out-17g"), ["--feature-index-dir", index_dir, "--metrics-out",
                                                              os.path.join(root, "metrics-17g")]), world=1)
    except BaseException:
        for p in two[1]:
            p.kill()
        raise
    return two, one


def _stream_series(path):
    """A rank's streamed slices per site and the fixed effect's passes per
    kind, from its Prometheus file."""
    series = _prom_series(path, "photon_stream_")
    slices = {dict(k[1]).get("site"): v for k, v in series.items() if k[0] == "photon_stream_slices_total"}
    passes = {dict(k[1]).get("kind"): v for k, v in series.items()
              if k[0] == "photon_stream_passes_total" and dict(k[1]).get("site") == "fe.train"}
    return {k: int(v) for k, v in slices.items()}, {k: int(v) for k, v in passes.items()}


def dist_stream(torch, fixture, b, started, problems, smi):
    """(f) Out of core across processes: the two gloo ranks of
    ``dist_stream_start`` through phase 16 (e)'s argv. Both coordinates
    stream on each rank (the plan; each rank's photon_stream_slices_total
    per site); each rank launches B1 + B2 once a slice a pass and one
    rank-order sum a pass (over both ranks' slot rows in (rank, slice)
    order); the ranks' best models bitwise alike; the coordinator's model
    against phase 12 (b)'s: FE rtol 1e-3 / atol 1e-5, the RE retrained on
    one card from the two-rank run's last residual and warm start (atol
    5e-3, per-entity loss atol 1e-4), validation AUC within 2e-3."""
    import os

    from photon_ml_tpu_torch.game.coordinate import _project_model_values
    from photon_ml_tpu_torch.io import load_game_model

    root = fixture["root"]
    out, ck, metrics = (os.path.join(root, p) for p in ("out-17f", "ck-17f", "metrics-17f"))
    outs, t0 = _wait_ranks(started)
    wall = max(o[3] for o in outs) - t0
    failed = _ranks_failed(outs, "(f) cli.train --distributed, streamed")
    if failed:
        raise AssertionError(failed)
    docs = _rank_docs(root, "train-17f")
    with open(os.path.join(metrics, "run_summary.json")) as f:
        summary = json.load(f)
    plan = {c["name"]: c for c in summary["plan"]["coordinates"]}
    shardings = {k: (c["residency"], c["sharding"]) for k, c in plan.items()}
    want = {"global": ("streamed", "host-sharded rows (streamed slices)"),
            "per-user": ("streamed", "entity-sharded (host-resident blocks)")}
    if shardings != want or summary["plan"]["pipeline_depth"] != 2 or summary["plan"]["n_processes"] != DIST_WORLD:
        problems.append(f"(f) the plan: {shardings}, depth {summary['plan']['pipeline_depth']}")
    auc = summary["best"]["metrics"]["AUC"]
    launches = []
    for r, d in enumerate(docs):
        slices, passes = _stream_series(os.path.join(metrics, "metrics.prom" if r == 0 else f"metrics.p{r}.prom"))
        b1, b2 = d["launches"]["fused_value_grad"], d["launches"]["fused_hessian_vector"]
        sums, s1 = d["sums"]["rank_order_sum"], d["sparse"]["ell_matvec"]
        n_passes = passes.get("vg", 0) + passes.get("hvp", 0)
        launches.append({"fused_value_grad": b1, "fused_hessian_vector": b2, "rank_order_sum": sums,
                         "ell_matvec": s1, "slices": slices, "passes": passes})
        log(f"  (f) rank {r}: wall {d['wall_s']:.2f} s (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in d["stage_seconds"].items())
            + f"); streamed slices {slices}; FE passes {passes}; B1 {b1} + B2 {b2} launches (slices x passes "
              f"{slices.get('fe.train')}), rank-order sums {sums} (passes {n_passes}), S1 ell_matvec {s1}; "
              f"best model sha256 {d['model_sha256'][:16]}")
        if not (slices.get("fe.train", 0) > 0 and slices.get("re.train", 0) > 0):
            problems.append(f"(f) rank {r} did not stream both coordinates: {slices}")
        if b1 <= 0 or b2 <= 0 or b1 + b2 != slices.get("fe.train") or sums != n_passes:
            problems.append(f"(f) rank {r}: B1 {b1} + B2 {b2} against {slices.get('fe.train')} slices, {sums} sums "
                            f"against {n_passes} passes")
    alike = len({d["model_sha256"] for d in docs}) == 1
    log(f"  (f) two gloo ranks, both coordinates streamed under {STREAM_GAME_BUDGET_MB} MiB a rank, depth 2: "
        f"{wall:.2f} s from the first start to the last exit (beside (b)'s resume, (c)-(e) and (g)); best models "
        f"bitwise alike on "
        f"every rank: {alike}; validation AUC {auc:.6f} (phase 12 (b) {b['auc']:.6f}) on {smi}")
    if not alike:
        problems.append(f"(f) the ranks' best models differ: {[d['model_sha256'] for d in docs]}")
    if abs(auc - b["auc"]) > 2e-3:
        problems.append(f"(f) validation AUC {auc:.6f} against phase 12 (b)'s {b['auc']:.6f} (2e-3)")
    maps = b["maps"]
    best = load_game_model(os.path.join(out, "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    ref = load_game_model(os.path.join(b["out"], "models", "best"), maps, task="logistic_regression", device=DIST_DEVICE)
    hold(problems, "(f) two streamed ranks vs phase 12 (b): FE coefficients", best["global"].model.coefficients.means,
         ref["global"].model.coefficients.means, 1e-3, 1e-5)
    # the random effect on identical residuals, as (a): the last RE update
    # retrained on one card from the boundary before it
    boundaries = os.path.join(ck, "cd-boundaries")
    state, last = _load_boundary(boundaries, 2), _load_boundary(boundaries, 3)
    re_coord = b["coords"]["per-user"]
    dev = re_coord.dataset.device

    def on_card(m):
        return dataclasses.replace(m, coef_indices=m.coef_indices.to(dev), coef_values=m.coef_values.to(dev))

    re1 = on_card(state["models"]["per-user"])
    residual = state["summed_scores"].to(dev) - re_coord.score(re1)
    one, _ = re_coord.train(residual, initial_model=re1)
    two = on_card(last["models"]["per-user"])
    ds = re_coord.dataset
    hold(problems, "(f) two streamed ranks vs one card: RE coefficients (identical residuals)",
         _project_model_values(ds, two, two.coef_values, torch.float32), one.coef_values, 0.0, 5e-3)
    l2 = float(re_coord.config.reg_weight)
    hold(problems, "(f) two streamed ranks vs one card: RE per-entity loss (identical residuals)",
         _re_losses(torch, re_coord, two, residual, l2), _re_losses(torch, re_coord, one, residual, l2), 0.0, 1e-4)
    return {"wall_s": wall, "auc": auc, "launches": launches, "alike": alike,
            "stage_seconds": [d["stage_seconds"] for d in docs], "rank_walls_s": [d["wall_s"] for d in docs]}


def dist_stream_nccl(torch, fixture, b, started, reference, problems, smi):
    """(g) One NCCL rank through (f)'s argv: its saved models bitwise phase
    16 (e)'s (``reference``: its output directory and its best model's
    digest), the world-1 identity of the streamed pass over ranks."""
    import os

    from photon_ml_tpu_torch.io import load_game_model

    root = fixture["root"]
    outs, t0 = _wait_ranks(started)
    failed = _ranks_failed(outs, "(g) cli.train over NCCL at world 1, streamed")
    if failed:
        raise AssertionError(failed)
    (doc,) = _rank_docs(root, "train-17g", world=1)
    with open(os.path.join(root, "metrics-17g", "run_summary.json")) as f:
        backend = json.load(f).get("distributed")
    maps = b["maps"]
    got = load_game_model(os.path.join(root, "out-17g", "models", "best"), maps, task="logistic_regression",
                          device=DIST_DEVICE)
    ref = load_game_model(os.path.join(reference["out"], "models", "best"), maps, task="logistic_regression",
                          device=DIST_DEVICE)
    bits = _differing_bits(got["global"].model.coefficients.means, ref["global"].model.coefficients.means)
    ga, ra = got["per-user"], ref["per-user"]
    ids = [str(e) for e in ra.entity_ids]
    rows = torch.as_tensor(ga.rows_for(ids), dtype=torch.long)
    if bool((rows < 0).any()):
        bits = None
    else:
        bits += _differing_bits(ga.coef_values[rows.to(ga.coef_values.device)], ra.coef_values)
    same_digest = doc["model_sha256"] == reference["model_sha256"]
    log(f"  (g) one rank over {backend}, streamed: wall {doc['wall_s']:.2f} s (beside (f)); launches "
        f"{doc['launches']}, rank-order sums {doc['sums']}; the saved models against phase 16 (e)'s: {bits} differing "
        f"bits, best model digests equal: {same_digest} on {smi}")
    if backend != {"backend": "nccl", "world_size": 1}:
        problems.append(f"(g) the one-rank run ran over {backend}, not NCCL")
    if bits != 0 or not same_digest:
        problems.append(f"(g) NCCL at world 1, streamed: {bits} bits differ from phase 16 (e)'s models "
                        f"(digests equal: {same_digest})")
    return {"wall_s": doc["wall_s"], "launches": doc["launches"], "sums": doc["sums"], "differing_bits": bits}


def distributed_phase(torch, fixture, game, smi, streamed=None):
    """Phase 17 (a)-(g) on phase 12's fixture; ``game`` carries phase 12
    (b)'s best model, index maps and in-process coordinates, ``streamed``
    phase 16 (e)'s output directory and digest (17 (g)'s reference; run
    here when phase 16 did not run)."""
    import os

    from photon_ml_tpu_torch.io.index_map import save_partitioned

    problems, out = [], {}
    b = game["b"]
    if streamed is None:
        streamed = stream_cli(torch, fixture, game, problems, smi)
    index_dir = os.path.join(fixture["root"], "index-17")
    for shard, imap in b["maps"].items():
        save_partitioned(imap, index_dir, 1, shard)
    a = dist_train(torch, fixture, b, index_dir, problems, smi)
    a["maps"] = b["maps"]
    out["train"] = {k: v for k, v in a.items() if k not in ("maps", "out", "metrics")}
    # (f)'s two streamed ranks and (g)'s one start once the drill is judged:
    # they run beside (b)'s resume, then beside (e)'s one NCCL rank, (c)'s
    # two scoring ranks and (d)
    streams = []
    try:
        out["drill"] = dist_drill(torch, fixture, a, index_dir, problems, smi,
                                  before_resume=lambda: streams.extend(dist_stream_start(fixture, index_dir)))
        if not streams:
            streams.extend(dist_stream_start(fixture, index_dir))
        streams.append(dist_nccl_start(fixture, index_dir))
        out["score"] = dist_score(torch, fixture, a, index_dir, problems, smi)
        out["fleetz"] = dist_fleetz(torch, a, problems)
    except BaseException:
        for ranks in streams:
            for p in ranks[1]:
                p.kill()
        raise
    two, one, nccl = streams
    out["nccl"] = dist_nccl(torch, fixture, b, nccl, problems, smi)
    out["stream"] = dist_stream(torch, fixture, b, two, problems, smi)
    out["stream_nccl"] = dist_stream_nccl(torch, fixture, b, one, streamed, problems, smi)
    log(f"  on {smi}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ------------------------------------------------------- phase 13: tuning
#
# Hyperparameter tuning on the card: S2, the lane-wide segment kernel
# (csrc/sparse_glm.cu through ops/sparse.py segment_dot_lanes), at phase 9's
# sparse shape; lambda-lane sweeps in process at build_data's width (the
# lanes of bench.py's --config sweep protocol, bench.py:2301); the sparse
# fixed-effect lane solve; and cli.train's tuning on phase 12's fixture,
# sequential and lane-batched, killed in the middle of a batch and resumed.

# lanes of (a): 7 ends in a sub-chunk of 3, 40 runs panels of 16, 16 and 8
# (L = 3 was cut to make room for phase 18)
S2_WIDTHS = (1, 4, 7, 8, 16, 40)
# the widths (a) times (every width before phase 18 joined the run's time limit)
S2_TIMED_WIDTHS = (4, 16)
S2_MAIN_WIDTH = 4  # the lanes of (c) and (d): each S2 line of the kernels JSON is timed at this width
TUNING_LAMBDAS = (0.01, 0.1, 1.0, 10.0)
# (c)'s layouts whose solves are broken down under the profiler (ELL's cut
# to make room for phase 18 (e) and (f); its breakdown read as COO's)
SPARSE_LANE_BREAKDOWN = ("coo",)
SWEEP_LAMBDAS = tuple(float(x) for x in np.logspace(-2.0, 2.0, 8))  # (b)'s K = 8, bench_sweep's; K = 4 takes TUNING_LAMBDAS
# K = 8 (timed against 8 times K = 4's mean trial) cut to make room for
# phase 18, K = 1 for phase 18 (e) and (f)
SWEEP_LANES = (4,)
# tuning.trial: the second lane of the first batch, so that the resumed
# batch holds the other two
TUNING_KILL_AT = 2
# (d)'s and (e)'s lanes and trials: one batch of 3, cut to make room for
# phase 18 (e) and (f) (one batch of 4 before, and 8 trials in two batches
# before phase 18)
TUNING_LANES = 3
TUNING_LANE_TRIALS = 3
# the smallest lambda whose f32 lanes (b) and (c) hold at atol 5e-3 beside
# the float64 pair: below it the f32 solves stop at f32's resolution
# (ROADMAP C3 for (c)'s lambda 0.01, C4 (d) for (b)'s per-user problems),
# and their gaps are printed, not held
F32_HELD_FROM = {"b": 0.5, "c": 0.1}


def s2_bytes(seg, n_seg, n_src, L, rows=None):
    """Bytes S2 must move: each entry's int32 index and value once, the L
    float32 columns of each gathered source row once (``rows``, the distinct
    rows of the [n_src, L] source that the entries reach: ``gathered_rows``)
    and the [n_seg, L] float32 output once."""
    rows = gathered_rows(seg, n_src) if rows is None else rows
    return seg.gather.shape[0] * (4 + seg.val.element_size()) + 4 * L * (rows + n_seg)


def _s2_times(torch, sparse, name, layout, product, seg, n_seg, src, ids, gather, csr):
    """(a)'s times of S2 at one width: in turns, cuSPARSE's SpMM, the
    index_add_ composition, S1 on one column, S2, S2, S1 (CUDA events over
    20 calls after 3); S2 from a CUDA graph; the plain version."""
    L = src.shape[1]
    acc = torch.empty((n_seg, L), device=src.device)

    def by_index_add():
        acc.zero_()
        return acc.index_add_(0, ids, src[gather] * seg.val[:, None])

    def library():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return torch.sparse.mm(csr, src)

    kern = lambda: sparse.segment_dot_lanes(name, seg, n_seg, src)  # noqa: E731
    col0 = src[:, 0].contiguous()
    single = lambda: sparse.segment_dot(  # noqa: E731
        f"{layout}_{'matvec' if product == 'matmat' else 'rmatvec'}", seg, n_seg, col0)
    runs = {"library_ms": [time_ms(torch, library, 20)], "index_add_ms": [time_ms(torch, by_index_add, 20)]}
    runs["s1_ms"] = [time_ms(torch, single, 20)]
    runs["ms"] = [time_ms(torch, kern, 20), time_ms(torch, kern, 20)]
    runs["s1_ms"].append(time_ms(torch, single, 20))
    row = {k: min(v) for k, v in runs.items()}
    row.update({"ms_runs": runs["ms"], "graph_ms": graph_ms(torch, kern, 20),
                "plain_ms": time_ms(torch, lambda: sparse.segment_dot_plain(seg, n_seg, src), 3)})
    row["l_times_s1_ms"] = L * row["s1_ms"]
    return row


def s2_check_and_time(torch, seed, batches, problems):
    """(a) S2 at phase 9's sparse shape, COO and ELL, for every width of
    S2_WIDTHS: matmat and rmatmat against the float64 plain version
    (max-abs <= 3e-5 * max(|ref|, 1)), each column bitwise S1's on that
    column, two launches bitwise alike, cuSPARSE's SpMM (torch.sparse.mm
    on the CSR matrix) on the same inputs beside; at S2_TIMED_WIDTHS the
    times of ``_s2_times`` beside its byte bound. The launches made here
    are not main-path launches."""
    from photon_ml_tpu_torch.ops import sparse

    dev = torch.device("cuda")
    saved = dict(sparse.SPARSE_LAUNCHES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    out = {}
    for layout, batch in batches.items():
        f = batch.features
        for product, seg, n_seg, n_src in (("matmat", f.row_segments, f.n_rows, f.dim),
                                           ("rmatmat", f.col_segments, f.dim, f.n_rows)):
            name = f"{layout}_{product}"
            ids = seg.segment_ids(n_seg)
            gather = seg.gather.long()
            ptr = torch.zeros(n_seg + 1, dtype=torch.int64, device=dev)
            ptr[1:] = torch.cumsum(torch.bincount(ids, minlength=n_seg), 0)
            with warnings.catch_warnings():  # torch marks its sparse CSR tensors beta
                warnings.simplefilter("ignore")
                csr = torch.sparse_csr_tensor(ptr.to(torch.int32), seg.gather, seg.val, size=(n_seg, n_src))
            rows = gathered_rows(seg, n_src)
            if name == "coo_matmat":
                log(f"  (a) cut to make room for phase 18: L = 3 left out; timed at L = {S2_TIMED_WIDTHS} only (every "
                    f"width before), one round of turns (two before)")
            for L in S2_WIDTHS:
                src = torch.randn((n_src, L), generator=gen, device=dev)
                a = sparse.segment_dot_lanes(name, seg, n_seg, src)
                b = sparse.segment_dot_lanes(name, seg, n_seg, src)
                ref = sparse.segment_dot_plain(seg, n_seg, src.double())
                err = float((a.double() - ref).abs().max())
                bound = 3e-5 * max(float(ref.abs().max()), 1.0)
                cols = [sparse.segment_dot(f"{layout}_{'matvec' if product == 'matmat' else 'rmatvec'}", seg,
                                           n_seg, src[:, l].contiguous()) for l in range(L)]
                columns_s1 = all(_same_bits(a[:, l].contiguous(), cols[l]) for l in range(L))
                twice = _same_bits(a, b)
                ok = err <= bound and columns_s1 and twice and bool(torch.isfinite(a).all())
                del ref
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    lib_err = float((torch.sparse.mm(csr, src) - a).abs().max())
                nbytes = s2_bytes(seg, n_seg, n_src, L, rows)
                ops = 2 * seg.gather.shape[0] * L
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3
                row = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                       "bytes": nbytes, "ops": ops, "max_abs_err": err, "columns_bitwise_s1": columns_s1,
                       "same_bits_twice": twice, "library_max_abs_diff": lib_err, "segments": n_seg,
                       "entries": seg.gather.shape[0], "gathered_rows": rows,
                       "form": "keys" if seg.keys is not None else f"row groups of {seg.group}"}
                head = (f"  (a) S2 {name:12s} L={L:2d} ({row['form']}) err={err:.3e}/{bound:.3e} columns bitwise "
                        f"S1={columns_s1} same bits twice={twice} {'ok' if ok else 'MISS'}")
                if L in S2_TIMED_WIDTHS:
                    row.update(_s2_times(torch, sparse, name, layout, product, seg, n_seg, src, ids, gather, csr))
                    log(f"{head}; kernel {'/'.join(f'{t:.4f}' for t in row['ms_runs'])} ms (graph "
                        f"{row['graph_ms']:.4f}), L x S1 {row['l_times_s1_ms']:.4f} (S1 {row['s1_ms']:.4f}), "
                        f"index_add_ {row['index_add_ms']:.4f}, cuSPARSE SpMM {row['library_ms']:.4f} (max abs diff "
                        f"{lib_err:.2e}), plain {row['plain_ms']:.4f}; bound {row['bound_ms']:.4f} ms "
                        f"({row['bound_by']}, {nbytes} B): {row['bound_ms'] / row['ms']:.1%} of it")
                else:
                    log(f"{head}; cuSPARSE SpMM max abs diff {lib_err:.2e}; not timed")
                out[(name, L)] = row
                if not ok:
                    problems.append(f"S2 {name} L={L}: err {err:.3e} (bound {bound:.3e}), columns bitwise S1 "
                                    f"{columns_s1}, same bits twice {twice}")
                del src, a, b, cols
            del csr, ids, gather, ptr
            torch.cuda.empty_cache()
    sparse.SPARSE_LAUNCHES.update(saved)  # checks are not main-path launches
    return out


def _sweep_estimator(coords_cfg, device, n_iterations=2):
    from photon_ml_tpu_torch.estimators import GameEstimator

    return GameEstimator("logistic_regression", coords_cfg, n_cd_iterations=n_iterations, evaluator_specs=["AUC"],
                         device=device)


def _lane_configs():
    """bench.py's sweep protocol (bench_sweep, bench.py:2301): both
    coordinates L-BFGS tol 1e-7, 50 iterations, L2, variance NONE."""
    from photon_ml_tpu_torch.estimators import CoordinateConfig
    from photon_ml_tpu_torch.game import GLMOptimizationConfig
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig

    cfg = GLMOptimizationConfig(optimizer=OptimizerConfig(tolerance=1e-7, max_iterations=50),
                                regularization=RegularizationContext("L2"))
    return [
        CoordinateConfig(name="global", feature_shard="global", config=cfg),
        CoordinateConfig(name="per-user", feature_shard="userShard", random_effect_type="userId", config=cfg,
                         active_cap=256),
    ]


def _lane_auc(torch, coords, model):
    from photon_ml_tpu_torch.evaluation.device import auc

    batch = coords["global"].dataset.batch
    scores = sum(coords[name].score(model[name]) for name in coords)
    return float(auc(scores + batch.offsets, batch.labels, batch.weights))


def _count_syncs(torch, fn):
    """``fn()`` under CUDA's sync debug mode at "warn": (its result, the
    synchronizing CUDA operations it made, the solvers' fetches among them,
    the lane guard's fetches)."""
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.optimize import common

    real, fetches = common.SyncCounter.fetch, [0]

    def counting(self, *a, **k):
        fetches[0] += 1
        return real(self, *a, **k)

    run = obs.RunTelemetry()
    prev = obs.set_current_run(run)
    common.SyncCounter.fetch = counting
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        common.SyncCounter.fetch = real
        obs.set_current_run(prev)
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    guard = sum(m.get("value", 0) for m in obs.build_run_summary(run.registry, total_wall_seconds=0.0)["metrics"]
                if m["name"] == "photon_device_fetch_bytes_total" and m["labels"].get("site") == "lanes.update_guard")
    run.close()
    return result, syncs, fetches[0], guard


def lane_sweep(torch, state, problems):
    """(b) bench.py's --config sweep protocol in process at build_data's
    width (phase 5's datasets; L-BFGS tol 1e-7, 50 iterations, L2, variance
    NONE, bench_sweep's lambdas): 2 sweeps of K = 4 lanes (fit_lanes)
    against K sequential fits (CoordinateDescent, the kernels; K = 8 was
    cut to make room for phase 18, K = 1 for phase 18 (e) and (f)), walls
    on the host clock ending in a synchronize. Each lane's fixed
    effect against its sequential fit's (atol 5e-3) and its training AUC
    within 1e-4 of the sequential fit's. The random effect is held on
    identical residuals (ROADMAP C4) and in float64 (C3: at small lambdas
    two f32 solves of these unconverged, nearly separable per-user problems
    part at f32's resolution): the RE lane solve on each lane's fixed-effect
    scores against the sequential (bucketed) RE solve on the same scores,
    both on the blocks widened to float64, coefficients atol 5e-3; the same
    pair in f32 held at atol 5e-3 from lambda F32_HELD_FROM["b"] and printed
    below it; the chained sweeps' RE difference printed, not held; the f32
    lane solve's wall and peak memory printed. Then the
    K = 4 sweep's synchronizing operations under the sync debug mode: beyond
    the solvers' own fetches, fewer than one a lane an update (the guard's
    one fetch an update carries every lane)."""
    from photon_ml_tpu_torch.game import CoordinateDescent, FixedEffectCoordinate, RandomEffectCoordinate

    coords = state["coords"]
    datasets = {"global": coords["global"].dataset, "per-user": coords["per-user"].dataset}
    dev = datasets["global"].batch.device
    cfgs = _lane_configs()
    fe_scorer = FixedEffectCoordinate(dataset=datasets["global"], task="logistic_regression", config=cfgs[0].config)

    re_ds = datasets["per-user"]
    b = re_ds.blocks
    re_ds64 = dataclasses.replace(re_ds, blocks=dataclasses.replace(
        b, features=b.features.double(), labels=b.labels.double(), offsets=b.offsets.double(),
        weights=b.weights.double()))

    def re_coord(lam, ds=re_ds):
        return RandomEffectCoordinate(dataset=ds, task="logistic_regression",
                                      config=cfgs[1].config.with_reg_weight(lam))

    lanes_of = {1: (1.0,), 4: TUNING_LAMBDAS, 8: SWEEP_LAMBDAS}
    seq = {}
    # the sequential fits of K = 4's lanes (K = 8's, timed against 8 times
    # their mean and not held lane by lane, cut to make room for phase 17)
    for lam in lanes_of[4]:
        cs = {
            "global": FixedEffectCoordinate(dataset=datasets["global"], task="logistic_regression",
                                            config=cfgs[0].config.with_reg_weight(lam)),
            "per-user": re_coord(lam),
        }
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = CoordinateDescent(cs, n_iterations=2).run()
        torch.cuda.synchronize()
        seq[lam] = (res.model, time.perf_counter() - t0, _lane_auc(torch, coords, res.model))
    out = {"sequential_s": {lam: v[1] for lam, v in seq.items()}}
    log("  (b) cut to make room for phase 18: K = 8 lanes (timed only) left out; cut to make room for phase 18 (e) "
        "and (f): K = 1 left out (its lambda 1 held in K = 4)")
    for K in SWEEP_LANES:
        lams = lanes_of[K]
        combos = [{"global": lam, "per-user": lam} for lam in lams]
        est = _sweep_estimator(cfgs, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lane_results = est.fit_lanes(None, combos, datasets=datasets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        held_lanes = all(lam in seq for lam in lams)
        seq_wall = sum(seq[lam][1] for lam in lams)
        # the RE lane solve on each lane's fixed-effect scores, alone: its
        # wall and the card's peak memory above what was held
        residual = torch.stack([fe_scorer.score(r.model["global"]) for r in lane_results], dim=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        W_re, _ = re_coord(1.0).train_lanes(residual, torch.tensor(lams, dtype=residual.dtype, device=dev))
        torch.cuda.synchronize()
        re_wall = time.perf_counter() - t1
        re_peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        residual64 = residual.double() if held_lanes else None
        W_re64 = re_coord(1.0, re_ds64).train_lanes(
            residual64, torch.tensor(lams, dtype=torch.float64, device=dev))[0] if held_lanes else None
        gaps = []
        for k, (r, lam) in enumerate(zip(lane_results, lams) if held_lanes else ()):
            model, _, auc_seq = seq[lam]
            fe_gap = float((r.model["global"].model.coefficients.means
                            - model["global"].model.coefficients.means).abs().max())
            re_seq, _ = re_coord(lam).train(residual[:, k].contiguous())
            re_gap32 = float((W_re[:, :, k] - re_seq.coef_values).abs().max())
            re_seq64, _ = re_coord(lam, re_ds64).train(residual64[:, k].contiguous())
            re_gap = float((W_re64[:, :, k] - re_seq64.coef_values).abs().max())
            chained = float((r.model["per-user"].coef_values - model["per-user"].coef_values).abs().max())
            auc_lane = _lane_auc(torch, coords, r.model)
            gaps.append((lam, fe_gap, re_gap, re_gap32, chained, auc_lane, auc_seq))
            f32_held = lam >= F32_HELD_FROM["b"]
            if not (fe_gap <= 5e-3 and re_gap <= 5e-3 and (re_gap32 <= 5e-3 or not f32_held)
                    and abs(auc_lane - auc_seq) <= 1e-4):
                problems.append(f"(b) K={K} lane lambda={lam}: FE gap {fe_gap:.2e}, RE gap on identical residuals "
                                f"in float64 {re_gap:.2e} and in f32 {re_gap32:.2e} (held: {f32_held}), AUC "
                                f"{auc_lane:.6f} vs sequential {auc_seq:.6f}")
        out[K] = {"wall_s": wall, "sequential_s": seq_wall, "re_lane_solve_s": re_wall, "re_peak_gib": re_peak,
                  "gaps": gaps}
        log(f"  (b) K={K}: lanes {wall:.3f} s against {K} sequential fits {seq_wall:.3f} s "
            f"({wall / seq_wall:.3f} of them; {wall / K:.3f} s a trial); the RE lane solve alone {re_wall:.3f} s, "
            f"peak {re_peak:.2f} GiB above what was held; per lane (lambda, FE gap, RE gap on identical residuals "
            f"in float64 (held) / in f32 (held from lambda {F32_HELD_FROM['b']:g}), chained RE difference (not held), "
            f"AUC lane / sequential): " + "; ".join(
                f"{lam:g} {fg:.1e} {rg:.1e}/{rg32:.1e} {ch:.1e} {al:.6f}/{asq:.6f}"
                for lam, fg, rg, rg32, ch, al, asq in gaps))
        del residual, W_re, residual64, W_re64
    combos = [{"global": lam, "per-user": lam} for lam in TUNING_LAMBDAS]
    _, syncs, fetches, guard_bytes = _count_syncs(
        torch, lambda: _sweep_estimator(cfgs, dev).fit_lanes(None, combos, datasets=datasets))
    updates = 2 * len(cfgs)
    extra = syncs - fetches
    log(f"  (b) K=4 under the sync debug mode: {syncs} synchronizing operations, {fetches} of them the solvers' "
        f"fetches, {extra} others over {updates} coordinate updates and {len(cfgs)} coordinates; the lane guard "
        f"fetched {int(guard_bytes)} bytes")
    if extra >= len(combos) * updates or guard_bytes <= 0:
        problems.append(f"(b) the lane sweep synchronized {extra} times beyond its solvers' fetches over {updates} "
                        f"updates of {len(combos)} lanes: a fetch per lane")
    out["syncs"] = {"all": syncs, "solver_fetches": fetches, "others": extra, "updates": updates}
    return out


def sparse_lane_solve(torch, seed, batches, problems):
    """(c) Phase 9's sparse configuration (logistic, L-BFGS tol 1e-9, 20
    iterations) through GLMProblem.run_lanes with TUNING_LAMBDAS on ELL and
    COO, S2's launches counted from 0 (above 0 for each product); each lane
    against its single-lane solve (GLMProblem.run, S1) by loss, rtol 1e-5.
    Coefficients atol 5e-3, as C3 holds solves at tol 1e-9: in float64 (the
    same lanes and singles on the batch widened to float64, the plain route
    on the card), where the stopping rule is decided above the arithmetic's
    resolution; in f32 from lambda F32_HELD_FROM["c"], printed below it.
    Then, on the layouts of SPARSE_LANE_BREAKDOWN, the wall broken down
    (``_solve_breakdown``: warm, profiled and counted under the sync debug
    mode) of the lane solve of SWEEP_LAMBDAS (8 lanes, bench.py's tuning
    protocol), with S2's device ms, kernel launches and share of the busy
    time, and its calls counted over one warm solve (the 4-lane solve's and
    its four singles' breakdowns cut to make room for (b)'s four held
    lanes)."""
    from photon_ml_tpu_torch.game import GLMProblem
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.optimize import OptimizerConfig

    problem = _sparse_problem(torch, OptimizerConfig(tolerance=1e-9, max_iterations=SPARSE_ITERS))
    out = {"launches": {}}
    log(f"  (c) cut to make room for phase 18 (e) and (f): the profiled breakdown on {SPARSE_LANE_BREAKDOWN} only "
        "(ELL's as well before); cut to make room for (b)'s four held lanes: the 4-lane solve's and its four "
        "singles' breakdowns (the 8-lane solve's kept)")
    for layout, batch in batches.items():
        lams = torch.tensor(TUNING_LAMBDAS, device=batch.device)
        lane_problem = GLMProblem(problem.task, problem.config)
        offsets = batch.offsets[:, None].repeat(1, len(TUNING_LAMBDAS))
        fg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W, res = lane_problem.run_lanes(batch, offsets, lams)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in sparse.SPARSE_LAUNCHES.items() if v}
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        if min(sparse.SPARSE_LAUNCHES[f"{layout}_matmat"], sparse.SPARSE_LAUNCHES[f"{layout}_rmatmat"]) <= 0:
            problems.append(f"(c) the {layout} lane solve did not launch S2: {launches}")
        f = batch.features
        vals64 = f.coo_vals.double() if f.layout == "coo" else None
        batch64 = dataclasses.replace(
            batch, labels=batch.labels.double(), offsets=batch.offsets.double(), weights=batch.weights.double(),
            features=type(f)(dim=f.dim, coo_cols=f.coo_cols, coo_rows=f.coo_rows, coo_vals=vals64,
                             coo_n_rows=f.coo_n_rows) if vals64 is not None
            else type(f)(dim=f.dim, idx=f.idx, val=f.val.double()))
        W64, _ = lane_problem.run_lanes(batch64, batch64.offsets[:, None].repeat(1, len(TUNING_LAMBDAS)),
                                        lams.double())
        single_s, rows = 0.0, []
        for k, lam in enumerate(TUNING_LAMBDAS):
            single_problem = GLMProblem(problem.task, problem.config.with_reg_weight(lam))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model, single = single_problem.run(batch)
            torch.cuda.synchronize()
            single_s += time.perf_counter() - t1
            coef_gap32 = float((W[:, k] - model.coefficients.means).abs().max())
            loss_gap = abs(float(res.loss[k]) - float(single.loss)) / abs(float(single.loss))
            model64, _ = single_problem.run(batch64)
            coef_gap = float((W64[:, k] - model64.coefficients.means).abs().max())
            rows.append((lam, coef_gap, coef_gap32, loss_gap, int(res.iterations[k]), int(single.iterations)))
            f32_held = lam >= F32_HELD_FROM["c"]
            if not (coef_gap <= 5e-3 and (coef_gap32 <= 5e-3 or not f32_held) and loss_gap <= 1e-5):
                problems.append(f"(c) {layout} lane lambda={lam}: coefficient gap in float64 {coef_gap:.2e} and in "
                                f"f32 {coef_gap32:.2e} (held: {f32_held}), loss gap {loss_gap:.2e}")
        log(f"  (c) {layout} lane solve of {len(TUNING_LAMBDAS)} lambdas: {wall:.3f} s (S2 launches {launches}) "
            f"against {single_s:.3f} s of single-lane solves; per lane (lambda, coefficient gap in float64 (held) / "
            f"in f32 (held from lambda {F32_HELD_FROM['c']:g}), relative loss gap, iterations lane / single): "
            + "; ".join(f"{lam:g} {cg:.1e}/{cg32:.1e} {lg:.1e} {il}/{isg}" for lam, cg, cg32, lg, il, isg in rows))
        out[layout] = {"wall_s": wall, "single_s": single_s, "rows": rows}
        if layout not in SPARSE_LANE_BREAKDOWN:
            del W, res, offsets, W64, batch64
            continue
        lams8 = torch.tensor(SWEEP_LAMBDAS, device=batch.device)
        offsets8 = batch.offsets[:, None].repeat(1, len(SWEEP_LAMBDAS))
        lane_problem.run_lanes(batch, offsets8, lams8)  # the first call of this width
        sparse.reset_launch_counts()
        lane_problem.run_lanes(batch, offsets8, lams8)
        calls8 = {k: v for k, v in sparse.SPARSE_LAUNCHES.items() if v}
        parts8 = _solve_breakdown(torch, lambda: lane_problem.run_lanes(batch, offsets8, lams8))
        parts8["calls"] = calls8
        log(f"  (c) {layout} lane solve of {len(SWEEP_LAMBDAS)} lambdas, warm: {parts8['wall_s']:.4f} s; profiled: "
            f"device busy {parts8['busy_s']:.4f} s ({parts8['busy_s'] / parts8['wall_s']:.1%} of the warm wall), "
            f"{parts8['device_ops']} device operations; S2 {parts8['s2_ms']:.3f} ms over "
            f"{parts8['s2_launches']} kernel launches ({calls8} product calls), "
            f"{parts8['s2_ms'] * 1e-3 / parts8['busy_s']:.1%} of the busy time; all segment kernels "
            f"{parts8['segment_ms']:.3f} ms over {parts8['segment_launches']}; {parts8['syncs']} synchronizing "
            f"operations; top device operations: "
            + "; ".join(f"{ms:.3f} ms x{n} {key[:60]}" for ms, n, key in parts8["top"]))
        out[layout].update(lanes8=parts8)
        del W, res, offsets, W64, batch64, offsets8
    return out


# a segment kernel's name as the profiler gives it, up to its template
# arguments, the last of which is its panel's capacity (1: S1)
_SEGMENT_TEMPLATE = re.compile(r"(?:row_group_kernel|key_walk_kernel|join_kernel)<([^<>]*)>")


def _is_s2_kernel(key):
    """Whether a profiled segment kernel ran a panel of more than one
    column: S2's launches, not S1's."""
    m = _SEGMENT_TEMPLATE.search(key)
    return m is not None and int(m.group(1).split(",")[-1]) > 1


def _solve_breakdown(torch, fn):
    """Where a solve's wall goes: ``fn()`` once more on the host clock
    (warm, ending in a synchronize), once under torch.profiler (the device's
    busy seconds, its operations, the segment kernels' device ms and
    launches, S2's among them, the top five operations) and once under the
    sync debug mode (its synchronizing operations and the solvers' fetches
    among them)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, rows = device_profile(torch, fn)
    seg = [r for r in rows if any(k in r[2] for k in S1_KERNELS)]
    s2 = [r for r in seg if _is_s2_kernel(r[2])]
    _, syncs, fetches, _ = _count_syncs(torch, fn)
    return {"wall_s": wall, "busy_s": sum(r[0] for r in rows) * 1e-6, "device_ops": sum(r[1] for r in rows),
            "segment_ms": sum(r[0] for r in seg) * 1e-3, "segment_launches": sum(r[1] for r in seg),
            "s2_ms": sum(r[0] for r in s2) * 1e-3, "s2_launches": sum(r[1] for r in s2),
            "top": [(us * 1e-3, count, key) for us, count, key in rows[:5]], "syncs": syncs, "fetches": fetches}


def _saved_models(monkeypatch_target):
    """Wrap cli.train's save_game_model to record (directory, model) of
    every save."""
    saved = []
    real = monkeypatch_target.save_game_model

    def recording(path, model, *a, **k):
        saved.append((path, model))
        return real(path, model, *a, **k)

    monkeypatch_target.save_game_model = recording
    return saved, real


def _lane_argv(train, validation, out, extra=()):
    """Phase 12's coordinates with variance and normalization NONE (the
    lanes take neither), 2 sweeps, AUC on the validation parts."""
    fe = GAME_FE.replace(",variance=SIMPLE", "")
    return ["--input-data", train, "--validation-data", validation,
            "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
            "--coordinate", fe, "--coordinate", GAME_RE, "--coordinate-descent-iterations", "2",
            "--evaluators", "AUC", "--output-dir", out, "--log-level", "WARNING", *extra]


def tuning_driver(torch, fixture, problems, smi):
    """(d) cli.train's tuning on phase 12's fixture: RANDOM with
    --trial-lanes TUNING_LANES and TUNING_LANE_TRIALS trials, variance and
    normalization NONE, output mode TUNED: the batch walls
    (photon_tuning_batch_wall_seconds), the tuned model reloaded bitwise the
    model it was saved from, the prior file with 1 + TUNING_LANE_TRIALS
    records. (The sequential BAYESIAN run with phase 12's options left the
    script to make room for phase 17 (f); tests/test_torch_tuning.py holds
    BAYESIAN tuning against the JAX package on the CPU.)"""
    import os

    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset_chunked

    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    out = {}
    log(f"  (d) cut to make room for phase 18 (e) and (f): {TUNING_LANE_TRIALS} trials in one batch of "
        f"{TUNING_LANES} lanes (4 in one batch of 4 before, 8 in two batches before phase 18); cut to make room for "
        "phase 17 (f): the sequential BAYESIAN run (1 trial)")
    lane_out, metrics_dir = os.path.join(root, "out-13-lanes"), os.path.join(root, "metrics-13")
    saved, real = _saved_models(cli_train)
    try:
        summary, wall, launches, shifts, s1 = _counted_train(torch, _lane_argv(
            train, validation, lane_out, ["--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter",
                                          str(TUNING_LANE_TRIALS), "--trial-lanes", str(TUNING_LANES),
                                          "--output-mode", "TUNED",
                                          "--metrics-out", metrics_dir]))
    finally:
        cli_train.save_game_model = real
    metrics = _run_metrics(metrics_dir)
    batches = [m for m in metrics if m["name"] == "photon_tuning_batch_wall_seconds"]
    batch_n = sum(m.get("count", 0) for m in batches)
    batch_s = sum(m.get("sum", 0.0) for m in batches)
    trials = _metric(metrics, "photon_tuning_trials_total")
    in_flight = _metric(metrics, "photon_tuning_lanes_in_flight")
    # the driver's index maps: the reader's, built from the training parts
    shards = {"global": FeatureShardConfig(("features",)), "userShard": FeatureShardConfig(("userFeatures",))}
    _, maps = read_avro_dataset_chunked(train, shards, id_tag_columns=["userId"])
    same = [_game_models_equal(load_game_model(path, maps, task="logistic_regression"), model.models)
            for path, model in saved]
    prior = os.path.join(lane_out, "hyperparameter-prior.json")
    with open(prior) as f:
        records = len(json.load(f)["records"])
    log(f"  (d) RANDOM --trial-lanes {TUNING_LANES}, {TUNING_LANE_TRIALS} trials: {wall:.2f} s (stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in summary["stage_seconds"].items())
        + f"); {batch_n} batches, {batch_s:.3f} s in all (photon_tuning_batch_wall_seconds), trials counted "
          f"{int(trials)}, lanes in flight after the run {int(in_flight)}; launches {launches}, S1 {s1}; "
          f"{len(saved)} saved models reloaded bitwise: {all(same)}; prior file {records} records; trials "
        + "; ".join(f"{c['reg_weights']} AUC {c['metrics']['AUC']:.6f}" for c in summary["configs"][1:]))
    if not (batch_n == TUNING_LANE_TRIALS // TUNING_LANES and trials == TUNING_LANE_TRIALS and in_flight == 0 and same
            and all(same) and records == 1 + TUNING_LANE_TRIALS):
        problems.append(f"(d) lane tuning: batches {batch_n}, trials {trials}, in flight {in_flight}, saved "
                        f"models bitwise {same}, prior records {records}")
    out["lanes"] = {"wall_s": wall, "stage_seconds": summary["stage_seconds"], "batches": batch_n,
                    "batch_seconds": batch_s, "configs": summary["configs"], "launches": launches}
    log(f"  on {smi}")
    return out


def tuning_resume(torch, fixture, d, problems):
    """(e) (d)'s lane run (TUNING_LANE_TRIALS trials, --trial-lanes
    TUNING_LANES) with --checkpoint-dir, killed by tuning.trial at the
    second lane of the batch, then resumed (the rest of the batch, two
    lanes or more, as one batch): the trials' candidates bitwise (d)'s and
    their AUC within 1e-4 of (d)'s."""
    import os

    from photon_ml_tpu_torch.cli import train as cli_train
    from photon_ml_tpu_torch.robust import SimulatedKill, faults

    root, train, validation = fixture["root"], fixture["train"], fixture["validation"]
    ckpt = os.path.join(root, "ck-13")
    argv = _lane_argv(train, validation, os.path.join(root, "out-13-e"),
                      ["--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", str(TUNING_LANE_TRIALS),
                       "--trial-lanes", str(TUNING_LANES), "--output-mode", "TUNED", "--checkpoint-dir", ckpt])
    os.environ["PHOTON_FAULTS"] = f"tuning.trial:kill:{TUNING_KILL_AT}"
    t0 = time.perf_counter()
    try:
        cli_train.run(argv)
        problems.append("(e) the injected kill did not fire")
    except SimulatedKill:
        pass
    finally:
        del os.environ["PHOTON_FAULTS"]
        faults.clear()
    killed = time.perf_counter() - t0
    with open(os.path.join(ckpt, "checkpoint-state.json")) as f:
        recorded = len(json.load(f)["tuning_trials"])
    t1 = time.perf_counter()
    summary = cli_train.run(argv)
    wall = time.perf_counter() - t1
    want = d["lanes"]["configs"][1 : 1 + TUNING_LANE_TRIALS]
    got = summary["configs"][1:]
    same = [g["reg_weights"] == w["reg_weights"] for g, w in zip(got, want)]
    gaps = [abs(g["metrics"]["AUC"] - w["metrics"]["AUC"]) for g, w in zip(got, want)]
    log(f"  (e) killed at tuning.trial call {TUNING_KILL_AT} after {killed:.2f} s with {recorded} trial(s) recorded; "
        f"resumed in {wall:.2f} s ({TUNING_LANE_TRIALS - recorded} lanes left for the resumed batch); candidates bitwise (d)'s: {same}; AUC gaps "
        + ", ".join(f"{g:.1e}" for g in gaps) + " (1e-4)")
    # the resumed batch holds two lanes or more
    if not (len(got) == TUNING_LANE_TRIALS and all(same) and max(gaps) <= 1e-4
            and 1 <= recorded <= TUNING_LANE_TRIALS - 2):
        problems.append(f"(e) resumed trials: candidates {same}, AUC gaps {gaps}, recorded before the kill "
                        f"{recorded}")
    return {"killed_s": killed, "wall_s": wall, "recorded": recorded, "auc_gaps": gaps}


def sparse_batches(seed):
    """Phase 9's sparse shape from ``seed`` as COO and ELL batches on the card."""
    from photon_ml_tpu_torch.io.data import RawDataset

    rows, cols, vals, y, _ = sparse_triplets(SPARSE_N, SPARSE_D, SPARSE_K, seed)
    raw = RawDataset(n_rows=SPARSE_N, labels=y, offsets=np.zeros(SPARSE_N), weights=np.ones(SPARSE_N),
                     shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": SPARSE_D}, id_tags={})
    return {layout: raw.to_batch("global", layout=layout) for layout in ("coo", "ell")}


def s2_phase(torch, seed):
    """Phase 13 (a) alone (``--only s2``), for iterating on S2."""
    problems = []
    out = {"s2": s2_check_and_time(torch, seed, sparse_batches(seed), problems)}
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def tuning_phase(torch, fixture, state, seed, smi):
    """Phase 13: (a) S2 at the sparse shape; (b) lane sweeps in process at
    build_data's width; (c) the sparse fixed-effect lane solve; (d) tuning
    through cli.train on phase 12's fixture; (e) killed in the middle of a
    lane batch and resumed."""
    problems, out = [], {}
    batches = sparse_batches(seed)
    out["s2"] = s2_check_and_time(torch, seed, batches, problems)
    out["sparse_lanes"] = sparse_lane_solve(torch, seed, batches, problems)
    del batches
    torch.cuda.empty_cache()
    out["sweep"] = lane_sweep(torch, state, problems)
    torch.cuda.empty_cache()
    out["driver"] = tuning_driver(torch, fixture, problems, smi)
    out["resume"] = tuning_resume(torch, fixture, out["driver"], problems)
    log(f"  on {smi}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def s2_entries(tuning):
    """S2's lines of the kernels JSON, one per product: ``launches`` from
    (c)'s lane solves (counted from 0), the error and times at
    S2_MAIN_WIDTH lanes from (a), the other widths beside."""
    tuning = tuning or {}
    s2 = tuning.get("s2") or {}
    launches = (tuning.get("sparse_lanes") or {}).get("launches", {})
    entries = []
    for name in ("coo_matmat", "coo_rmatmat", "ell_matmat", "ell_rmatmat"):
        t = s2.get((name, S2_MAIN_WIDTH), {})
        entries.append({
            "name": f"segment_dot_lanes:{name}", "route": "cuda", "source": "photon_ml_tpu_torch/csrc/sparse_glm.cu",
            "replaces": SPARSE_REPLACES[name.split("_", 1)[1]], "launches": launches.get(name, 0),
            "max_abs_err": t.get("max_abs_err"), "ms": t.get("ms"), "graph_ms": t.get("graph_ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"), "bound_by": t.get("bound_by"),
            "library_ms": t.get("library_ms"), "library": "cuSPARSE SpMM (torch.sparse.mm on a sparse CSR tensor)",
            "index_add_ms": t.get("index_add_ms"), "l_times_s1_ms": t.get("l_times_s1_ms"), "lanes": S2_MAIN_WIDTH,
            "columns_bitwise_s1": t.get("columns_bitwise_s1"), "form": t.get("form"),
            "gathered_rows": t.get("gathered_rows"),
            "by_lanes": {L: {k: s2.get((name, L), {}).get(k) for k in ("ms", "graph_ms", "bound_ms", "l_times_s1_ms",
                                                                      "index_add_ms", "library_ms", "max_abs_err")}
                         for L in S2_WIDTHS},
            "dtype": "float32 values and src, double sums", "design": DESIGN["segment_dot_lanes"],
        })
    return entries


# ------------------------------------------------- phase 14: the retrain chain
#
# The day-chained incremental retrain on the card (cli.retrain over
# game/incremental.py): phase 12's fixture laid out as three day partitions
# under <feed>/yyyy/MM/dd, each day warm-started from the accepted model with
# prior-centred L2 (the fixed effect: TRON, SIMPLE variance,
# STANDARDIZATION, B1, B2 and B3 with shifts; the per-user effect: the
# packed L-BFGS with the day's entities' prior means), merged into the
# accepted model, gated against the live model on the validation parts
# (GameTransformer: S1 for the fixed effect) and published as an mmap store
# snapshot.

RETRAIN_RANGE = "20260101-20260103"
RETRAIN_LABELS = ("20260101", "20260102", "20260103")
RETRAIN_DAY3 = (8, 12_500)  # day 3's parts and the rows each draws before it keeps the even users' rows
RETRAIN_EVALUATORS = "AUC,AUC:userId"
# the gate tolerates this drop of either metric (noise of a day's update);
# the label-flipped day of (d) falls far below it
RETRAIN_MARGIN = 0.01
RETRAIN_TORN_AT = 2  # retrain.publish: day 2's publish fails
RETRAIN_KILL_AT = 3  # retrain.day: killed before day 3
RETRAIN_SHARDS = {"global": ("features",), "userShard": ("userFeatures",)}
# per-user first: on a warm-started day the live fixed effect is already
# good, and every snapshot the day's descent evaluates then holds the day's
# random effect. With the fixed effect first, the first snapshot keeps the
# live random effect, and at this phase's size (NVIDIA H100, float32) it
# stayed the best by validation AUC on days 2 and 3, so the merge carried
# it whole.
RETRAIN_COORDINATES = (GAME_RE, GAME_FE)


def retrain_fixture(fixture):
    """The feed: day 1 links phase 12's training parts 0-3, day 2 parts
    4-7, day 3 the new rows of the even-numbered users only (written with
    phase 12 (a)'s fixture); the feature index built by cli.index from one
    validation part (it holds every feature) and pinned for the chain."""
    import os

    from photon_ml_tpu_torch.cli import index

    root = fixture["root"]
    feed = os.path.join(root, "feed")
    days = [os.path.join(feed, "2026", "01", d[-2:]) for d in RETRAIN_LABELS]
    n_parts = IO_TRAIN[1]
    for day, parts in zip(days[:2], (range(n_parts // 2), range(n_parts // 2, n_parts))):
        os.makedirs(day)
        for p in parts:
            name = f"part-{p:05d}.avro"
            os.symlink(os.path.join(fixture["train"], name), os.path.join(day, name))
    os.makedirs(days[2])
    parts, rows = RETRAIN_DAY3
    for p in range(parts):
        name = f"part-{p:05d}.avro"
        os.symlink(os.path.join(fixture["day3"], name), os.path.join(days[2], name))
    idx = os.path.join(root, "index")
    t1 = time.perf_counter()
    maps = index.run(["--input-data", os.path.join(fixture["validation"], "part-00000.avro"),
                      "--feature-shard", "name=global,bags=features",
                      "--feature-shard", "name=userShard,bags=userFeatures",
                      "--output-dir", idx, "--num-partitions", "4", "--log-level", "WARNING"])
    index_s = time.perf_counter() - t1
    sizes = {k: len(v) for k, v in maps.items()}
    log(f"  set-up: days 1 and 2 link phase 12's parts 0-{n_parts // 2 - 1} and {n_parts // 2}-{n_parts - 1}, day 3 "
        f"the {parts} parts of {rows} drawn rows (the even users' kept) written with phase 12 (a)'s; the index "
        f"{sizes} built in {index_s:.2f} s")
    if sizes != {"global": IO_FEATURES + 1, "userShard": GAME_RE_FEATURES + 1}:
        raise AssertionError(f"the index misses features: {sizes}")
    return {"feed": feed, "days": days, "index": idx, "index_s": index_s}


def retrain_argv(fixture, fx, out, srv, extra=()):
    return ["--input-data", fx["feed"], "--input-data-date-range", RETRAIN_RANGE,
            "--validation-data", fixture["validation"], "--feature-index-dir", fx["index"],
            "--feature-shard", "name=global,bags=features", "--feature-shard", "name=userShard,bags=userFeatures",
            *[a for spec in RETRAIN_COORDINATES for a in ("--coordinate", spec)],
            "--normalization", "STANDARDIZATION", "--coordinate-descent-iterations", "2",
            "--evaluators", RETRAIN_EVALUATORS,
            "--gate-margin", str(RETRAIN_MARGIN), "--output-dir", out, "--serving-root", srv,
            "--log-level", "WARNING", *extra]


def _launch_counts():
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse

    return {"fused_value_grad": fg.LAUNCHES["fused_value_grad"],
            "fused_hessian_vector": fg.LAUNCHES["fused_hessian_vector"],
            "fused_hessian_stats": fg.LAUNCHES["fused_hessian_stats"],
            "fused_hessian_stats_with_shifts": fg.SHIFT_LAUNCHES["fused_hessian_stats"],
            "ell_matvec": sparse.SPARSE_LAUNCHES["ell_matvec"]}


def _chain_state(out):
    import os

    with open(os.path.join(out, "chain-state.json")) as f:
        return json.load(f)


def _day_payloads(out, day_index):
    """The day's boundary checkpoints (every update's models and summed
    scores, on the host), oldest first."""
    import os

    from photon_ml_tpu_torch.robust import CheckpointManager

    mgr = CheckpointManager(os.path.join(out, "checkpoints", f"day-{day_index:04d}"), keep_last=4)
    return [mgr._load_validated(d)[1] for d in mgr.checkpoints()]


def retrain_replay(torch, fixture, fx, maps, out, k, problems):
    """(a) Day ``k`` replayed on identical inputs from its boundary
    checkpoints: the fixed effect's first update through the kernels
    (bitwise the chain's) and through the plain versions (rtol 1e-3, atol
    1e-5, means and variances); the random effect's last update through the
    chain's f32 solve (bitwise) and in float64 on the blocks widened (atol
    5e-3, ROADMAP C4). Each update's residual is the descent's: the summed
    scores before it less the coordinate's own (from the models of the
    boundary before it, or the prior's at the day's start). The prior is the
    accepted model of day k - 1, reloaded from the chain's store (bitwise:
    f32 written as double)."""
    import os

    from photon_ml_tpu_torch.cli.params import parse_coordinate
    from photon_ml_tpu_torch.cli.train import normalize_fixed_effects
    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset
    from photon_ml_tpu_torch.robust.checkpoint import to_device

    dev = torch.device("cuda")
    shards = {k_: FeatureShardConfig(v) for k_, v in RETRAIN_SHARDS.items()}
    raw, _ = read_avro_dataset(fx["days"][k], shards, index_maps=maps, id_tag_columns=["userId"])
    cfgs = [parse_coordinate(spec) for spec in RETRAIN_COORDINATES]
    normalize_fixed_effects("STANDARDIZATION", cfgs, raw, maps, torch.float32, dev)
    prior = None
    if k > 0:
        prior = load_game_model(os.path.join(out, "models", f"day-{RETRAIN_LABELS[k - 1]}"), maps,
                                task="logistic_regression", device=dev)
        for c in cfgs:
            c.regularize_by_prior = True
    est = GameEstimator("logistic_regression", cfgs, n_cd_iterations=2, device=dev)
    order = [c.name for c in cfgs]
    coords = est._make_coordinates(est.prepare_datasets(raw), {name: 1.0 for name in order},
                                   {} if prior is None else dict(prior.models))
    states = _day_payloads(out, k)
    if [st["coordinate"] for st in states] != order * 2:
        raise AssertionError(f"day {k + 1}: boundary checkpoints {[st['coordinate'] for st in states]}")

    def update_inputs(i, name):
        """(residual, current model) of the day's update ``i``."""
        if i == 0:
            if prior is None:
                return None, None
            scores = {c: coords[c].score(prior[c]) for c in order}
            summed = scores[order[0]] + scores[order[1]]
            return summed - scores[name], prior[name]
        before = states[i - 1]
        model = before["models"].get(name)
        model = None if model is None else to_device(model, dev)
        summed = before["summed_scores"].to(dev)
        return (summed if model is None else summed - coords[name].score(model)), model

    i_fe = order.index("global")
    residual, initial = update_inputs(i_fe, "global")
    fe_chain = to_device(states[i_fe]["models"]["global"], dev).model.coefficients
    fe_k, _ = coords["global"].train(residual, initial_model=initial)
    fe_p, _ = dataclasses.replace(coords["global"], plain=True).train(residual, initial_model=initial)
    same_fe = _same_bits(fe_k.model.coefficients.means, fe_chain.means)
    label = f"(a) day {k + 1}"
    hold(problems, f"{label} FE kernels vs plain, identical inputs (means)", fe_chain.means,
         fe_p.model.coefficients.means, 1e-3, 1e-5)
    hold(problems, f"{label} FE kernels vs plain, identical inputs (variances)", fe_chain.variances,
         fe_p.model.coefficients.variances, 1e-3, 1e-5)
    i_re = len(order) + order.index("per-user")
    res_re, re_prev = update_inputs(i_re, "per-user")
    re_coord = coords["per-user"]
    re_chain = to_device(states[i_re]["models"]["per-user"], dev)
    re_k, _ = re_coord.train(res_re, initial_model=re_prev)
    ds = re_coord.dataset
    b = ds.blocks
    ds64 = dataclasses.replace(ds, blocks=dataclasses.replace(
        b, features=b.features.double(), labels=b.labels.double(), offsets=b.offsets.double(),
        weights=b.weights.double()))
    re64, _ = dataclasses.replace(re_coord, dataset=ds64).train(res_re.double(), initial_model=re_prev)
    same_re = _same_bits(re_k.coef_values, re_chain.coef_values)
    hold(problems, f"{label} RE f32 chain vs float64, identical residuals", re_chain.coef_values,
         re64.coef_values, 0.0, 5e-3)
    log(f"  {label}: {raw.n_rows} rows, {ds.num_entities} users; the replays bitwise the chain's: FE {same_fe}, "
        f"RE {same_re}")
    if not (same_fe and same_re):
        problems.append(f"{label}: the replay on the checkpoints' inputs is not bitwise the chain's "
                        f"(FE {same_fe}, RE {same_re})")
    return {"rows": raw.n_rows, "users": ds.num_entities, "replay_bitwise": same_fe and same_re}


def retrain_chain(torch, fixture, fx, root, problems, smi):
    """(a) cli.retrain on the card over the three days, every counter at 0
    before it and read after each day's gate, with --status-port: /healthz
    polled from another thread while the chain runs; per-day and stage
    walls; the days replayed on identical inputs (retrain_replay)."""
    import os
    import threading

    from photon_ml_tpu_torch.cli import retrain
    from photon_ml_tpu_torch.game import incremental
    from photon_ml_tpu_torch.ops import fused_glm as fg

    out, srv, metrics_dir = (os.path.join(root, "chain-a"), os.path.join(root, "serving-a"),
                             os.path.join(root, "metrics-a"))
    port = _free_port()
    argv = retrain_argv(fixture, fx, out, srv, ["--checkpoint-every", "1", "--checkpoint-keep", "4",
                                               "--metrics-out", metrics_dir, "--status-port", str(port)])
    stop, healthz = threading.Event(), {}
    poller = threading.Thread(target=lambda: healthz.update(_poll_endpoints(
        f"http://127.0.0.1:{port}", lambda: True, paths=("/healthz",), stop=stop)), name="chip-smoke-healthz")
    poller.start()
    per_day = []
    record = incremental._record_decision

    def counted(decision, day_index):
        torch.cuda.synchronize()
        per_day.append(_launch_counts())
        record(decision, day_index)

    incremental._record_decision = counted
    try:
        fg.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = retrain.run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        incremental._record_decision = record
        stop.set()
        poller.join()
    total = _launch_counts()
    launches = [{k: v - (per_day[i - 1][k] if i else 0) for k, v in c.items()} for i, c in enumerate(per_day)]
    state = _chain_state(out)
    for i, d in enumerate(summary["days"]):
        secs = summary["day_seconds"][d["day"]]
        log(f"  (a) day {d['day']}: {d['rows']} rows, {d['reason']}, touched {state['days'][i]['touched_entities']}, "
            f"metrics {d['metrics']}; {secs['day']:.2f} s (stages "
            + ", ".join(f"{s} {secs[s]:.3f}" for s in ("read", "train", "merge", "gate", "save", "publish")
                        if s in secs)
            + f"); launches {launches[i]} on {smi}")
    log(f"  (a) cli.retrain: {wall:.2f} s for {len(summary['days'])} days; launches {total}; /healthz answered 200 "
        f"{healthz.get('/healthz', 0)} times during the chain (--status-port)")
    if not healthz.get("/healthz"):
        problems.append("(a): /healthz never answered 200 during the chain")
    if min(total["fused_value_grad"], total["fused_hessian_vector"], total["fused_hessian_stats_with_shifts"],
           total["ell_matvec"]) <= 0:
        problems.append(f"the retrain chain did not launch B1, B2, B3 with shifts and S1: {total}")
    if [d["accepted"] for d in summary["days"]] != [True, True, True]:
        problems.append(f"the chain did not accept every day: {[d['reason'] for d in summary['days']]}")
    metrics = _run_metrics_prom(metrics_dir)
    return {"out": out, "srv": srv, "summary": summary, "wall_s": wall, "launches": launches, "total": total,
            "state": state, "metrics": metrics}


def _run_metrics_prom(metrics_dir):
    """The photon_retrain_* lines of a run's metrics.prom (the stage
    histograms by their sums and counts)."""
    import os

    with open(os.path.join(metrics_dir, "metrics.prom")) as f:
        return [ln for ln in f.read().splitlines() if ln.startswith("photon_retrain_")
                and not re.search(r"_bucket\{|_p\d\d\{", ln)]


def _tables(opened):
    """An opened ModelStore's coordinate tables by coordinate name."""
    return {c.name: c for c in opened.coords}


def retrain_untouched(a, problems):
    """(b) The odd-numbered users (absent from day 3) in day 3's published
    store, bitwise their rows in day 2's (widened with -1 / 0)."""
    from photon_ml_tpu_torch.serving import refresh, store

    s2, s3 = (_tables(store.ModelStore.open(refresh.snapshot_path(a["srv"], f"retrain-{d}")))["per-user"]
              for d in RETRAIN_LABELS[1:])
    odd = [f"u{u}" for u in range(1, GAME_USERS, 2)]
    r2, r3 = s2.rows_for(odd), s3.rows_for(odd)
    kept = r2 >= 0
    if not kept.any() or (r3[kept] < 0).any():
        problems.append("(b) untouched users are missing from day 3's model")
        return {}
    S2 = s2.coef_indices.shape[1]
    i2, v2 = np.asarray(s2.coef_indices)[r2[kept]], np.asarray(s2.coef_values)[r2[kept]]
    i3, v3 = np.asarray(s3.coef_indices)[r3[kept]], np.asarray(s3.coef_values)[r3[kept]]
    same = (np.array_equal(i3[:, :S2], i2) and np.array_equal(v3[:, :S2].view(np.uint32), v2.view(np.uint32))
            and bool((i3[:, S2:] == -1).all()) and bool((v3[:, S2:] == 0).all()))
    even_touched = a["state"]["days"][2]["touched_entities"]["per-user"]
    log(f"  (b) {int(kept.sum())} odd-numbered users carried through day 3 ({even_touched} even-numbered users "
        f"re-solved): bitwise their day-2 rows {same}")
    if even_touched >= GAME_USERS // 2:
        problems.append(f"(b) day 3's model re-solved {even_touched} users, not its own even-numbered ones")
    if not same:
        problems.append("(b) untouched users differ from their day-2 rows after day 3's merge")
    return {"carried": int(kept.sum()), "touched_day3": even_touched, "bitwise": same}


def retrain_snapshot(torch, a, maps, problems):
    """(c) The live snapshot reopened with open_current: its arrays equal
    the accepted model's (the chain's saved model of the last day, f32
    written as double in Avro) bitwise, the random effect compared as dense
    [users, d_re] tables."""
    import os

    from photon_ml_tpu_torch.io import load_game_model
    from photon_ml_tpu_torch.serving import refresh

    t0 = time.perf_counter()
    name, opened = refresh.open_current(a["srv"])
    open_s = time.perf_counter() - t0
    last = RETRAIN_LABELS[-1]
    model = load_game_model(os.path.join(a["out"], "models", f"day-{last}"), maps, task="logistic_regression",
                            device="cpu")
    fe, re_ = _tables(opened)["global"], _tables(opened)["per-user"]
    same_fe = np.array_equal(np.asarray(fe.weights).view(np.uint32),
                             model["global"].model.coefficients.means.numpy().view(np.uint32))
    d_re = GAME_RE_FEATURES + 1
    rm = model["per-user"]
    rows = re_.rows_for(list(rm.entity_ids))
    idx, val = np.asarray(re_.coef_indices), np.asarray(re_.coef_values)
    dense = np.zeros((len(rows), d_re), dtype=np.float32)
    ok_rows = rows >= 0
    r, c = np.nonzero(idx[rows[ok_rows]] >= 0)
    dense[np.flatnonzero(ok_rows)[r], idx[rows[ok_rows]][r, c]] = val[rows[ok_rows]][r, c]
    want = rm.dense_coefficients(d_re).astype(np.float32)
    same_re = bool(ok_rows.all()) and len(rows) == re_.coef_indices.shape[0] and np.array_equal(
        dense.view(np.uint32), want.view(np.uint32))
    log(f"  (c) open_current: {name} opened in {open_s * 1e3:.2f} ms ({len(rows)} users); bitwise the accepted "
        f"model: fixed effect {same_fe}, random effect {same_re}")
    if name != f"retrain-{last}" or not (same_fe and same_re):
        problems.append(f"(c) the live snapshot {name} differs from the accepted model (FE {same_fe}, RE {same_re})")
    return {"snapshot": name, "open_ms": open_s * 1e3, "bitwise": same_fe and same_re}


def retrain_degraded(torch, fixture, fx, a, maps, root, problems):
    """(d) Day 3 with its labels flipped, gated against day 2's accepted
    model in a second serving root (day 2's snapshot published there first):
    rejected, counted in photon_retrain_rejected_total, CURRENT still day
    2's."""
    import os

    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.cli.params import parse_coordinate
    from photon_ml_tpu_torch.cli.train import normalize_fixed_effects
    from photon_ml_tpu_torch.estimators import GameEstimator
    from photon_ml_tpu_torch.game import incremental
    from photon_ml_tpu_torch.io import FeatureShardConfig, load_game_model, read_avro_dataset
    from photon_ml_tpu_torch.serving import refresh

    dev = torch.device("cuda")
    shards = {k: FeatureShardConfig(v) for k, v in RETRAIN_SHARDS.items()}
    raw, _ = read_avro_dataset(fx["days"][2], shards, index_maps=maps, id_tag_columns=["userId"])
    raw = dataclasses.replace(raw, labels=1.0 - raw.labels)
    val, _ = read_avro_dataset(fixture["validation"], shards, index_maps=maps, id_tag_columns=["userId"])
    cfgs = [parse_coordinate(spec) for spec in RETRAIN_COORDINATES]
    normalize_fixed_effects("STANDARDIZATION", cfgs, raw, maps, torch.float32, dev)
    est = GameEstimator("logistic_regression", cfgs, n_cd_iterations=2,
                        evaluator_specs=RETRAIN_EVALUATORS.split(","), device=dev)
    live = load_game_model(os.path.join(a["out"], "models", f"day-{RETRAIN_LABELS[1]}"), maps,
                           task="logistic_regression", device=dev)
    srv = os.path.join(root, "serving-d")
    before = f"retrain-{RETRAIN_LABELS[1]}"
    refresh.publish_snapshot(srv, before, game_model=live)
    run_t = obs.RunTelemetry()
    t0 = time.perf_counter()
    with obs.use_run(run_t):
        res = incremental.run_chain(est, [(RETRAIN_LABELS[2], raw)], val, initial_model=live,
                                    chain_dir=os.path.join(root, "chain-d"), serving_root=srv,
                                    gate_margin=RETRAIN_MARGIN, index_maps=maps)
    wall = time.perf_counter() - t0
    rec = res.ledger[0]
    counted = sum(m["value"] for m in run_t.registry.snapshot() if m["name"] == "photon_retrain_rejected_total")
    current = refresh.current_snapshot(srv)
    log(f"  (d) day 3 with flipped labels: {rec.reason} (candidate {rec.metrics}) in {wall:.2f} s; "
        f"photon_retrain_rejected_total {counted}; CURRENT {current}")
    if rec.accepted or not rec.reason.startswith("degraded:") or counted != 1 or current != before:
        problems.append(f"(d) the degraded day was not refused cleanly: {rec.reason}, counted {counted}, "
                        f"CURRENT {current}")
    return {"reason": rec.reason, "wall_s": wall, "rejected_counted": counted}


def retrain_drills(torch, fixture, fx, a, root, problems):
    """(e) PHOTON_FAULTS=retrain.publish:io:2,retrain.day:kill:3: day 2's
    publish torn (CURRENT stays day 1's), the run killed before day 3; the
    resumed run repairs the publish first and ends with the straight run's
    ledger, bit for bit, and day 3 live."""
    import os

    from photon_ml_tpu_torch.cli import retrain
    from photon_ml_tpu_torch.robust import SimulatedKill, faults
    from photon_ml_tpu_torch.serving import refresh

    out, srv, metrics_dir = os.path.join(root, "chain-e"), os.path.join(root, "serving-e"), os.path.join(root, "m-e")
    argv = retrain_argv(fixture, fx, out, srv)
    os.environ["PHOTON_FAULTS"] = f"retrain.publish:io:{RETRAIN_TORN_AT},retrain.day:kill:{RETRAIN_KILL_AT}"
    t0 = time.perf_counter()
    try:
        retrain.run(argv)
        problems.append("(e) the injected kill did not fire")
    except SimulatedKill:
        pass
    finally:
        del os.environ["PHOTON_FAULTS"]
        faults.clear()
    killed = time.perf_counter() - t0
    torn = _chain_state(out)["days"]
    live_after_kill = refresh.current_snapshot(srv)
    t1 = time.perf_counter()
    summary = retrain.run(argv + ["--metrics-out", metrics_dir])
    resumed = time.perf_counter() - t1
    same = _chain_state(out)["days"] == a["state"]["days"]
    current = refresh.current_snapshot(srv)
    published = [ln for ln in _run_metrics_prom(metrics_dir) if ln.startswith("photon_retrain_published_total")]
    log(f"  (e) killed before day 3 after {killed:.2f} s with {len(torn)} days decided (day 2 published: "
        f"{torn[-1]['published'] if torn else None}; CURRENT {live_after_kill}); resumed in {resumed:.2f} s "
        f"(days run {list(summary['day_seconds'])}): ledger bitwise the straight run's {same}; CURRENT {current}; "
        f"{published}")
    if not (len(torn) == 2 and not torn[1]["published"] and live_after_kill == f"retrain-{RETRAIN_LABELS[0]}"
            and same and current == f"retrain-{RETRAIN_LABELS[2]}"):
        problems.append(f"(e) drills: decided before the kill {len(torn)}, CURRENT after it {live_after_kill}, "
                        f"resumed ledger identical {same}, CURRENT {current}")
    return {"killed_s": killed, "resumed_s": resumed, "ledger_identical": same}


def retrain_phase(torch, fixture, smi):
    """Phase 14: (a) cli.retrain over three days with launches, walls and
    each day held on identical inputs; (b) untouched users bitwise; (c) the
    live snapshot bitwise the accepted model; (d) a label-flipped day
    refused; (e) the torn-publish and kill-between-days drills."""
    from photon_ml_tpu_torch.io.index_map import load_partitioned

    problems, out = [], {}
    fx = retrain_fixture(fixture)
    out["setup"] = {"index_s": fx["index_s"]}
    maps = {s: load_partitioned(fx["index"], s) for s in RETRAIN_SHARDS}
    root = fixture["root"]
    a = retrain_chain(torch, fixture, fx, root, problems, smi)
    out["chain"] = {"wall_s": a["wall_s"], "launches": a["launches"], "total": a["total"],
                    "day_seconds": a["summary"]["day_seconds"], "days": a["summary"]["days"], "metrics": a["metrics"]}
    torch.cuda.empty_cache()
    log("  (a) cut to make room for phase 18: days 1 and 3 replayed (day 2's replay left out)")
    out["replays"] = [retrain_replay(torch, fixture, fx, maps, a["out"], k, problems) for k in RETRAIN_REPLAYED]
    torch.cuda.empty_cache()
    out["untouched"] = retrain_untouched(a, problems)
    out["snapshot"] = retrain_snapshot(torch, a, maps, problems)
    out["degraded"] = retrain_degraded(torch, fixture, fx, a, maps, root, problems)
    torch.cuda.empty_cache()
    out["drills"] = retrain_drills(torch, fixture, fx, a, root, problems)
    log(f"  photon_retrain_* of (a): {a['metrics']}")
    log(f"  on {smi}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


RETRAIN_REPLAYED = (0, 2)  # (a)'s replayed days (day 2's cut to make room for phase 18)
SERVING_D = 1_024  # bench.py _serving_workload: the fixed effect's width
SERVING_USERS = 20_000
SERVING_D_RE = 32
SERVING_SUPPORT = 8  # each user's coefficients
SERVING_UNSEEN = 0.2  # share of requests from users the model has not seen
SERVING_REQUESTS = 4_096
SERVING_NNZ = (16, 4)  # nonzeros a request: fixed effect, random effect
SERVING_RUNGS = (1, 8, 64, 256, 4_096)  # (a)'s batch sizes, each a rung of the engine's ladder
SERVING_CLIENTS = 8  # bench_serving's closed-loop clients
SERVING_SECONDS = 3.0
SERVING_MAX_BATCH = 256
SERVING_MAX_LATENCY_MS = 2.0
SERVING_KNEE = (0.5, 1.0, 1.5)  # (d)'s offered rates, as shares of the probed capacity
SERVING_KNEE_SECONDS = 1.0
SERVING_DEADLINE_MS = 100.0  # bench_serving_openloop's budget
SERVING_FRONT_QPS = 300.0  # (e)'s offered load through the front, under one replica's capacity
SERVING_SHIFT = 0.5  # (c): the second snapshot's fixed effect, shifted
S1_BOUND = 3e-5  # S1's bound: max-abs error <= 3e-5 * max(|ref|, 1)


def serving_workload(seed, fe_shift=0.0):
    """bench.py _serving_workload's model and requests, made in the port
    from ``seed`` with numpy: the model as ``convert``'s dict (float32
    tables, as the card serves them) and the requests, with the number of
    unseen users among them."""
    from photon_ml_tpu_torch.serving import ScoreRequest

    rng = np.random.default_rng(seed)
    w = rng.standard_normal(SERVING_D) / np.sqrt(SERVING_D)
    idx = np.sort(rng.integers(0, SERVING_D_RE, size=(SERVING_USERS, SERVING_SUPPORT), dtype=np.int32), axis=1)
    val = rng.standard_normal((SERVING_USERS, SERVING_SUPPORT)) * 0.3
    parts = {"task": "logistic_regression", "models": {
        "global": {"kind": "fixed", "feature_shard": "globalShard", "task": "logistic_regression",
                   "means": (w + fe_shift).astype(np.float32), "variances": None},
        "per-user": {"kind": "random", "random_effect_type": "userId", "feature_shard": "userShard",
                     "task": "logistic_regression",
                     "entity_ids": np.asarray([f"u{i}" for i in range(SERVING_USERS)], dtype=object),
                     "coef_indices": idx, "coef_values": val.astype(np.float32), "variances": None},
    }}
    requests, unseen = [], []
    nnz_fe, nnz_re = SERVING_NNZ
    for i in range(SERVING_REQUESTS):
        cold = rng.uniform() < SERVING_UNSEEN
        uid = f"cold{i}" if cold else f"u{rng.integers(0, SERVING_USERS)}"
        unseen.append(cold)
        requests.append(ScoreRequest(
            features={
                "globalShard": (tuple(rng.integers(0, SERVING_D, size=nnz_fe).tolist()),
                                tuple(rng.standard_normal(nnz_fe).tolist())),
                "userShard": (tuple(rng.integers(0, SERVING_D_RE, size=nnz_re).tolist()),
                              tuple(rng.standard_normal(nnz_re).tolist())),
            },
            ids={"userId": uid},
        ))
    return parts, requests, np.asarray(unseen)


def serving_oracle(parts, requests):
    """Each request's score in float64 numpy from the served inputs (the
    float32 tables, the feature values rounded to float32): the fixed
    effect's dot, and the random effect's through the first support entry
    of each feature (the searchsorted of ``score_entity_ell``), 0 unseen."""
    fe, re = parts["models"]["global"], parts["models"]["per-user"]
    w = fe["means"].astype(np.float64)
    rows = {e: i for i, e in enumerate(re["entity_ids"])}
    out = np.zeros(len(requests))
    for k, r in enumerate(requests):
        gi, gv = r.features["globalShard"]
        out[k] = float(np.dot(w[np.asarray(gi)], np.asarray(gv, np.float32).astype(np.float64)))
        e = rows.get(r.ids["userId"])
        if e is None:
            continue
        sup, coef = re["coef_indices"][e], re["coef_values"][e].astype(np.float64)
        for f, v in zip(*r.features["userShard"]):
            p = int(np.searchsorted(sup, f))
            if p < sup.size and sup[p] == f:
                out[k] += float(coef[p]) * float(np.float32(v))
    return out + np.asarray([r.offset for r in requests])


def hold_s1(problems, what, got, ref):
    """``got`` against ``ref`` at S1's bound; returns the worst error."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref))) if got.size else 0.0
    ok = bool(np.all(np.abs(got - ref) <= S1_BOUND * np.maximum(np.abs(ref), 1.0)))
    if not ok:
        problems.append(f"{what}: max abs error {err:.3e} past S1's bound")
    return err


def _counter(run, name):
    return sum(m["value"] for m in run.registry.snapshot() if m["name"] == name and m["kind"] == "counter")


def serving_split(torch, engine, reqs, reps=20):
    """One request batch's milliseconds by stage, each the mean of ``reps``,
    through the engine's own halves of ``score_requests``: host assembly
    (``assemble``: the padding loop and the entity lookups), the upload and
    the launches (``device_margins``, between CUDA events), and the fetch
    and float64 sum (``fetch_scores``, host clock, after the launches
    finished)."""
    from photon_ml_tpu_torch import obs

    with obs.use_run(obs.RunTelemetry()):
        t0 = time.perf_counter()
        for _ in range(reps):
            offsets, shard_ell, entity_rows = engine.assemble(reqs, count_cold=False)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        device_ms = fetch_ms = 0.0
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            margins = engine.device_margins(shard_ell, entity_rows)
            end.record()
            end.synchronize()
            device_ms += start.elapsed_time(end) / reps
            t1 = time.perf_counter()
            engine.fetch_scores(offsets, margins)
            fetch_ms += (time.perf_counter() - t1) * 1e3 / reps
    return {"host_ms": host_ms, "device_ms": device_ms, "fetch_ms": fetch_ms}


def s1_at_rung(torch, engine, reqs):
    """S1 alone at a rung's fixed-effect rows: ms per launch (CUDA events
    over back-to-back calls, and replayed from a CUDA graph: the device's
    own time), its plain version's, cuSPARSE's CSR SpMV on the same rows
    (back to back and from a graph, like S1), and the bound from the bytes these rows need (the distinct gathered weights
    counted) or their operations."""
    from photon_ml_tpu_torch.ops.sparse import segment_dot, segment_dot_plain
    from photon_ml_tpu_torch.serving.engine import EllRows, _FixedCoord

    _, shard_ell, _ = engine.assemble(reqs, count_cold=False)
    fe = next(c for c in engine._coords if isinstance(c, _FixedCoord))
    idx, val = shard_ell[fe.feature_shard]
    ell = EllRows(idx, val, torch.float32, engine.device)
    seg, n, w = ell.segments, ell.n_rows, fe.weights
    reps = 200
    ms = time_ms(torch, lambda: segment_dot("ell_matvec", seg, n, w), reps)
    graph = graph_ms(torch, lambda: segment_dot("ell_matvec", seg, n, w), reps)
    plain_ms = time_ms(torch, lambda: segment_dot_plain(seg, n, w), 50)
    width = idx.shape[1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sparse CSR's beta and invariant-check notices
        csr = torch.sparse_csr_tensor(
            torch.arange(0, n * width + 1, width, device=w.device), ell.idx.reshape(-1).long(), ell.val.reshape(-1),
            size=(n, w.shape[0]),
        )
    library_ms = time_ms(torch, lambda: csr @ w, reps)
    library_graph_ms = graph_ms(torch, lambda: csr @ w, reps)
    bytes_ms = segment_bytes(seg, n, w.shape[0])["function"] / HBM_BYTES_PER_S * 1e3
    ops_ms = segment_flops(seg) / PEAK_OPS["float32"] * 1e3
    return {"rows": n, "width": width, "ms": ms, "graph_ms": graph, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_graph_ms": library_graph_ms, "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def serving_engine_checks(torch, store, parts, requests, unseen, problems, smi):
    """(a) ModelStore -> ScoreEngine.from_store on the card -> warm(); at
    each rung every score against the plain route and the float64 oracle
    at S1's bound, the cold starts against the unseen requests, one S1
    launch a batch; the resident path against the batch path at the
    rung's width and a wider one; the stage split and S1 alone per rung;
    the one-request-at-a-time rate."""
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.serving import ScoreEngine

    engine = ScoreEngine.from_store(store)
    t0 = time.perf_counter()
    engine.warm()
    warm_s = time.perf_counter() - t0
    plain = ScoreEngine.from_store(store, plain=True)
    oracle = serving_oracle(parts, requests)
    rungs = {}
    for n in SERVING_RUNGS:
        reqs = requests[:n]
        run = obs.RunTelemetry()
        sparse.reset_launch_counts()
        with obs.use_run(run):
            got = engine.score_requests(reqs)
        s1 = sparse.SPARSE_LAUNCHES["ell_matvec"]
        cold = int(_counter(run, "photon_serving_cold_start_total"))
        with obs.use_run(obs.RunTelemetry()):
            ref = plain.score_requests(reqs)
        e_plain = hold_s1(problems, f"rung {n} vs the plain route", got, ref)
        e_oracle = hold_s1(problems, f"rung {n} vs the float64 oracle", got, oracle[:n])
        if cold != int(unseen[:n].sum()):
            problems.append(f"rung {n}: {cold} cold starts counted, {int(unseen[:n].sum())} unseen requests")
        if s1 != 1:
            problems.append(f"rung {n}: {s1} S1 launches for one batch")
        rungs[n] = {"max_abs_err_plain": e_plain, "max_abs_err_oracle": e_oracle, "cold": cold, "s1_launches": s1,
                    **serving_split(torch, engine, reqs), "s1": s1_at_rung(torch, engine, reqs)}
        r = rungs[n]
        log(f"  (a) rung {n}: vs plain {e_plain:.3e}, vs oracle {e_oracle:.3e} (bound {S1_BOUND:g} * max(|ref|, 1)); "
            f"cold starts {cold} of {int(unseen[:n].sum())} unseen; S1 launches {s1}; batch ms: host assembly "
            f"{r['host_ms']:.4f}, upload + device {r['device_ms']:.4f}, fetch {r['fetch_ms']:.4f}; S1 alone "
            f"{r['s1']['ms']:.5f} ms/launch (graph {r['s1']['graph_ms']:.5f}; {r['s1']['rows']} x {r['s1']['width']}), "
            f"plain {r['s1']['plain_ms']:.5f}, "
            f"cuSPARSE {r['s1']['library_ms']:.5f} (graph {r['s1']['library_graph_ms']:.5f}), "
            f"bound {r['s1']['bound_ms']:.3e} ({r['s1']['bound_by']})")
    # resident against batch: the same rows through score_ell at the rung's
    # width (16: one row group of 4 lanes) and padded to 64 (16 lanes)
    reqs = requests[:SERVING_RUNGS[-1]]
    with obs.use_run(obs.RunTelemetry()):
        resident = engine.score_requests(reqs)
        offsets, shard_ell, entity_rows = engine.assemble(reqs, count_cold=False)
        same = engine.score_ell(offsets, shard_ell, entity_rows)[: len(reqs)]
        idx, val = shard_ell["globalShard"]
        wide = dict(shard_ell, globalShard=(np.pad(idx, ((0, 0), (0, 48))), np.pad(val, ((0, 0), (0, 48)))))
        wider = engine.score_ell(offsets, wide, entity_rows)[: len(reqs)]
    parity = {"same_width_bitwise": bool(np.array_equal(resident, same)),
              "wider_bitwise_rows": int(np.sum(resident == wider)),
              "wider_max_abs_diff": hold_s1(problems, "resident vs batch at width 64", resident, wider)}
    if not parity["same_width_bitwise"]:
        problems.append("resident vs batch at the rung's width: not bitwise")
    log(f"  (a) resident vs batch: same width bitwise {parity['same_width_bitwise']}; padded to width 64: "
        f"{parity['wider_bitwise_rows']} of {len(reqs)} rows bitwise, max abs diff {parity['wider_max_abs_diff']:.3e}")
    t0 = time.perf_counter()
    n_seq = 0
    with obs.use_run(obs.RunTelemetry()):
        while time.perf_counter() - t0 < 1.0:
            engine.score_requests([requests[n_seq % len(requests)]])
            n_seq += 1
    seq_rate = n_seq / (time.perf_counter() - t0)
    log(f"  (a) warm() {warm_s:.3f} s; one request at a time: {seq_rate:.1f} scores/s on {smi}")
    return engine, {"warm_s": warm_s, "rungs": rungs, "parity": parity, "one_request_per_s": seq_rate}


def _histogram(run, name):
    for m in run.registry.snapshot():
        if m["name"] == name and m["kind"] == "histogram":
            return m
    return None


def serving_closed_loop(torch, root, parts2, requests, v1, v2, problems, smi):
    """(b) bench_serving's protocol through ScoringServer over a serving
    root on the card, with (c) a second snapshot published and flipped
    while the clients run: scores/s, p50 and p99 from the server's own
    latency histogram, the mean batch; no request lost or failed, every
    response before the flip v1's and every one after it v2's."""
    import threading

    from photon_ml_tpu_torch import convert, obs, serving

    run = obs.RunTelemetry()
    with obs.use_run(run):
        server = serving.ScoringServer(serving_root=root, max_batch=SERVING_MAX_BATCH,
                                       max_latency_ms=SERVING_MAX_LATENCY_MS, poll_seconds=3600.0)
        try:
            server.submit(requests[0]).result(timeout=60.0)
            results = [[] for _ in range(SERVING_CLIENTS)]
            failures = []
            flip = {}
            stop_at = time.perf_counter() + SERVING_SECONDS

            def client(k):
                i = k
                while time.perf_counter() < stop_at:
                    t_sub = time.perf_counter()
                    try:
                        s = server.submit(requests[i % len(requests)]).result(timeout=60.0)
                    except Exception as exc:  # counted: a lost or failed request fails the phase
                        failures.append(repr(exc))
                    else:
                        results[k].append((i % len(requests), s, t_sub, time.perf_counter()))
                    i += SERVING_CLIENTS

            def flipper():
                time.sleep(SERVING_SECONDS / 2)
                flip["t0"] = time.perf_counter()
                serving.publish_snapshot(root, "v2", game_model=convert.game_model_from_numpy(parts2, device="cpu"))
                server.poke_refresh()
                flip["t1"] = time.perf_counter()

            threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVING_CLIENTS)]
            threads.append(threading.Thread(target=flipper))
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            snapshot = server.snapshot_name
            queue_at_end = server.queue_stats()
        finally:
            server.close()
    done = [x for r in results for x in r]
    lat = _histogram(run, "photon_serving_request_latency_seconds")
    batch = _histogram(run, "photon_serving_batch_size")
    p50 = obs.histogram_quantile(lat["buckets"], lat["count"], 0.5)
    p99 = obs.histogram_quantile(lat["buckets"], lat["count"], 0.99)
    before = [(i, s) for i, s, ts, td in done if td < flip["t0"]]
    after = [(i, s) for i, s, ts, td in done if ts > flip["t1"]]
    e1 = hold_s1(problems, "(c) responses before the flip vs v1", [s for _, s in before], [v1[i] for i, _ in before])
    e2 = hold_s1(problems, "(c) responses after the flip vs v2", [s for _, s in after], [v2[i] for i, _ in after])
    if failures or snapshot != "v2" or not after or not before:
        problems.append(f"(b)/(c): {len(failures)} failed ({failures[:3]}), live snapshot {snapshot}, "
                        f"{len(before)} before and {len(after)} after the flip")
    out = {"scores_per_s": len(done) / wall, "requests": len(done), "wall_s": wall, "p50_s": p50, "p99_s": p99,
           "mean_batch": batch["sum"] / max(batch["count"], 1), "failed": len(failures),
           "flip_s": flip["t1"] - flip["t0"], "before": len(before), "after": len(after),
           "in_flight_at_flip": len(done) - len(before) - len(after), "err_v1": e1, "err_v2": e2,
           "cold": int(_counter(run, "photon_serving_cold_start_total")),
           "ewma_service_s": queue_at_end["ewma_service_seconds"]}
    log(f"  (b) {SERVING_CLIENTS} closed-loop clients for {wall:.2f} s: {out['scores_per_s']:.1f} scores/s "
        f"({len(done)} requests, {out['cold']} cold starts), p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms, mean "
        f"batch {out['mean_batch']:.2f} (max_batch {SERVING_MAX_BATCH}, max_latency {SERVING_MAX_LATENCY_MS} ms), "
        f"service EWMA {out['ewma_service_s'] * 1e3:.3f} ms a request on {smi}")
    log(f"  (c) live flip to v2 in {out['flip_s']:.3f} s mid-stream: {len(failures)} failed or lost; {len(before)} "
        f"responses before it (vs v1 {e1:.3e}), {len(after)} after it (vs v2 {e2:.3e}), "
        f"{out['in_flight_at_flip']} in flight across it")
    return out


def serving_knee(torch, root, requests, problems, smi):
    """(d) bench.py's open-loop protocol, shortened: a capacity probe, then
    Poisson arrivals at SERVING_KNEE shares of it for
    SERVING_KNEE_SECONDS each, every request with a SERVING_DEADLINE_MS
    budget; the knee, and the sheds the server counted against those the
    clients saw."""
    from photon_ml_tpu_torch import obs, serving

    run = obs.RunTelemetry()
    with obs.use_run(run):
        server = serving.ScoringServer(serving_root=root, max_batch=SERVING_MAX_BATCH,
                                       max_latency_ms=SERVING_MAX_LATENCY_MS, poll_seconds=3600.0)
        try:
            server.submit(requests[0], deadline_s=60.0).result(timeout=60.0)
            t0 = time.perf_counter()
            n = 0
            for lo in range(0, 4 * SERVING_MAX_BATCH, SERVING_MAX_BATCH):
                for f in [server.submit(r, deadline_s=60.0) for r in requests[lo: lo + SERVING_MAX_BATCH]]:
                    f.result(timeout=60.0)
                n += SERVING_MAX_BATCH
            capacity = n / (time.perf_counter() - t0)
            shed0 = _counter(run, "photon_serving_shed_total")
            steps = [serving.run_open_loop(server.submit, requests, offered_qps=max(frac * capacity, 1.0),
                                           duration_s=SERVING_KNEE_SECONDS, seed=i,
                                           deadline_s=SERVING_DEADLINE_MS / 1e3)
                     for i, frac in enumerate(SERVING_KNEE)]
            counted = _counter(run, "photon_serving_shed_total") - shed0
        finally:
            server.close()
    seen = sum(s.shed_total for s in steps)
    lost = sum(s.sent - s.completed - s.shed_total - s.errors for s in steps)
    knee = serving.find_knee(steps) or steps[0]
    if counted != seen or lost or any(s.errors for s in steps):
        problems.append(f"(d): counted sheds {counted}, observed {seen}, lost {lost}, "
                        f"errors {[s.errors for s in steps]}")
    log(f"  (d) capacity probe {capacity:.1f} scores/s; " + "; ".join(
        f"offered {s.offered_qps:.0f}/s: served {s.served_qps:.1f}/s, shed {s.shed_total}, p99 "
        f"{s.latency_p99_s * 1e3:.3f} ms" for s in steps)
        + f"; knee {knee.offered_qps:.0f} qps (p99 {knee.latency_p99_s * 1e3:.3f} ms); sheds counted {int(counted)}, "
          f"observed {seen} on {smi}")
    return {"capacity_per_s": capacity, "knee_qps": knee.offered_qps, "knee_p99_s": knee.latency_p99_s,
            "steps": [dataclasses.asdict(s) for s in steps], "sheds_counted": counted, "sheds_seen": seen}


def _wait_for_line(path, needle, proc, timeout_s=180.0):
    import os

    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"a cli.serve replica exited with {proc.returncode} before '{needle}'")
        if os.path.exists(path):
            for line in open(path):
                if needle in line:
                    return line
        time.sleep(0.05)
    raise RuntimeError(f"no '{needle}' in {path} after {timeout_s:.0f} s")


def fleetz_checks(repo, env, healthz, keep, problems):
    """Phase 15 (e)'s ``python -m photon_ml_tpu_torch.cli.fleetz``: one
    scrape of the replicas' status ports, whose merged request counter must
    equal the sum of the replicas' own bit for bit; then artifacts mode over
    phase 12 (b)'s and (f)'s metrics directories (under ``keep``), whose
    merged counters must equal the sums of the two runs' final snapshots."""
    import os
    import shutil
    import subprocess
    import tempfile
    import urllib.request

    from photon_ml_tpu_torch.obs import fleet

    def counters(snapshot, prefix="photon_serving_requests_total"):
        return {(m["name"], tuple(sorted(m["labels"].items()))): m["value"] for m in snapshot
                if m["kind"] == "counter" and m["name"].startswith(prefix)}

    cmd = [sys.executable, "-m", "photon_ml_tpu_torch.cli.fleetz", "--log-level", "WARNING"]
    # the artifacts-mode process runs beside the scrape's (it reads files only)
    dirs = [os.path.join(keep, d) for d in ("metrics-b", "metrics-f")] if keep else []
    have_dirs = bool(dirs) and all(os.path.isdir(d) for d in dirs)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleetz_")
    t1 = time.perf_counter()
    artifacts = subprocess.Popen(cmd + dirs + ["--out", tmp], cwd=repo, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) if have_dirs else None
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + [a for h in healthz for a in ("--scrape", f"http://{h}")], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=120)
        scrape_s = time.perf_counter() - t0
        own = {}
        for h in healthz:
            with urllib.request.urlopen(f"http://{h}/metrics", timeout=10) as m:
                for key, v in counters(fleet.parse_prometheus(m.read().decode())).items():
                    own[key] = own.get(key, 0.0) + v
    except BaseException:
        if artifacts is not None:
            artifacts.kill()
            artifacts.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    merged = counters(fleet.parse_prometheus(proc.stdout)) if proc.returncode == 0 else {}
    log(f"  (e) cli.fleetz over {len(healthz)} replicas in {scrape_s:.2f} s (a process of its own): merged "
        f"{merged}, the replicas' own summed {own}")
    if proc.returncode != 0 or not merged or merged != own:
        problems.append(f"(e) cli.fleetz: exit {proc.returncode}, merged {merged} against summed {own}: "
                        f"{proc.stderr[-2000:]}")
    if artifacts is None:
        shutil.rmtree(tmp, ignore_errors=True)
        log("  (e) cli.fleetz artifacts mode skipped: phase 12's metrics directories are not there")
        return {"scrape_s": scrape_s, "merged": merged}
    try:
        _, stderr = artifacts.communicate(timeout=120)
        artifacts_s = time.perf_counter() - t1
        ok = artifacts.returncode == 0
        prom = open(os.path.join(tmp, "fleet.prom")).read() if ok else ""
        trace = json.load(open(os.path.join(tmp, "fleet_trace.json"))) if ok else {}
    finally:
        if artifacts.poll() is None:
            artifacts.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    got = counters(fleet.parse_prometheus(prom), prefix="photon_")
    got = {k: v for k, v in got.items() if not k[0].startswith("photon_fleet_")}
    want = {}
    for d in dirs:
        for key, v in counters(fleet.load_metrics_jsonl(os.path.join(d, "metrics.jsonl")).snapshot,
                               prefix="photon_").items():
            want[key] = want.get(key, 0.0) + v
    # as the exposition renders them: 10 significant digits
    want = {k: float(f"{v:.10g}") for k, v in want.items()}
    n_spans = sum(e.get("ph") == "X" for e in trace.get("traceEvents", []))
    log(f"  (e) cli.fleetz artifacts mode over phase 12 (b) and (f): {len(got)} merged counter series in "
        f"{artifacts_s:.2f} s (beside the scrape), the runs' sums {'equal' if got == want else 'DIFFER'}; stitched "
        f"trace {n_spans} spans")
    if not ok or not got or got != want:
        problems.append(f"(e) cli.fleetz artifacts mode: exit {artifacts.returncode}, {len(got)} series against "
                        f"{len(want)}: {stderr[-2000:]}")
    return {"scrape_s": scrape_s, "merged": merged, "artifacts_s": artifacts_s, "series": len(got)}


def serving_replicas(torch, root, requests, v2, problems, smi, keep=None):
    """(e) Two ``python -m photon_ml_tpu_torch.cli.serve`` replicas on the
    card over (c)'s serving root, with --listen and --status-port: /healthz
    200 and /metrics with the request counter; cli.fleetz over their status
    ports and over phase 12's metrics directories (fleetz_checks); then
    open-loop load through a LeastLoadedFront over both, replica 0 killed
    mid-stream: every request answered (against v2 at S1's bound) or shed
    with a type."""
    import json as _json
    import os
    import re as _re
    import signal
    import socket
    import subprocess
    import tempfile
    import threading
    import urllib.request

    from photon_ml_tpu_torch import obs, serving

    repo = str(pathlib.Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=repo)
    procs, addrs, healthz = [], [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replicas_") as tmp:
        try:
            t0 = time.perf_counter()
            logs = [os.path.join(tmp, f"replica-{k}.log") for k in range(2)]
            for k in range(2):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "photon_ml_tpu_torch.cli.serve", "--serving-root", root, "--listen",
                     "127.0.0.1:0", "--status-port", "0", "--replica-id", str(k), "--poll-seconds", "3600",
                     "--max-latency-ms", str(SERVING_MAX_LATENCY_MS), "--log-file", logs[k]],
                    cwd=repo, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                ))
            for k in range(2):
                bound = _wait_for_line(logs[k], "socket front bound", procs[k])
                status = _wait_for_line(logs[k], "introspection endpoints", procs[k])
                addrs.append("127.0.0.1:" + _re.search(r"(\d+)\)\s*$", bound.strip()).group(1))
                healthz.append("127.0.0.1:" + _re.search(r"127\.0\.0\.1:(\d+)/", status).group(1))
            start_s = time.perf_counter() - t0
            for k in range(2):
                host, port = addrs[k].split(":")
                with socket.create_connection((host, int(port))) as c, c.makefile("rwb") as f:
                    r = requests[k]
                    doc = {"features": {s: [list(i), list(v)] for s, (i, v) in r.features.items()}, "ids": r.ids}
                    f.write((_json.dumps(doc) + "\n").encode())
                    f.flush()
                    got = _json.loads(f.readline())
                hold_s1(problems, f"(e) replica {k}'s response vs v2", [got.get("score", np.nan)], [v2[k]])
                with urllib.request.urlopen(f"http://{healthz[k]}/healthz", timeout=10) as h:
                    if h.status != 200:
                        problems.append(f"(e) replica {k}: /healthz {h.status}")
                with urllib.request.urlopen(f"http://{healthz[k]}/metrics", timeout=10) as m:
                    if b"photon_serving_requests_total" not in m.read():
                        problems.append(f"(e) replica {k}: no photon_serving_requests_total on /metrics")
            fleet_out = fleetz_checks(repo, env, healthz, keep, problems)
            run = obs.RunTelemetry()
            with obs.use_run(run):
                front = serving.LeastLoadedFront(addrs, healthz=healthz, connections_per_replica=4,
                                                  health_poll_seconds=0.1)
                try:
                    holder = {}
                    drive = threading.Thread(target=lambda: holder.update(r=serving.run_open_loop(
                        front.submit, requests, offered_qps=SERVING_FRONT_QPS, duration_s=SERVING_SECONDS, seed=7)))
                    drive.start()
                    time.sleep(SERVING_SECONDS / 3)
                    procs[0].kill()  # replica 0 dies mid-stream
                    drive.join()
                    res = holder["r"]
                    routed = {a: int(sum(m["value"] for m in run.registry.snapshot()
                                         if m["name"] == "photon_serving_route_total"
                                         and m["labels"].get("replica", "").split("#")[0] == a)) for a in addrs}
                    resubmits = int(_counter(run, "photon_serving_failover_resubmits_total"))
                    check = [requests[i] for i in range(8)]
                    scores = [front.score(r) for r in check]
                finally:
                    front.close()
            hold_s1(problems, "(e) scores through the front after the kill vs v2", scores, v2[:8])
            procs[1].send_signal(signal.SIGTERM)
            rc1 = procs[1].wait(timeout=60)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    lost = res.sent - res.completed - res.shed_total - res.errors
    if lost or res.errors or not res.completed or rc1 != 0 or not all(routed.values()):
        problems.append(f"(e): sent {res.sent}, completed {res.completed}, shed {res.shed_total}, errors "
                        f"{res.errors}, lost {lost}, routed {routed}, replica 1 exit {rc1}")
    log(f"  (e) two cli.serve replicas up in {start_s:.1f} s; through the front at {SERVING_FRONT_QPS:.0f}/s offered "
        f"for {SERVING_SECONDS:.0f} s with replica 0 killed at {SERVING_SECONDS / 3:.1f} s: sent {res.sent}, "
        f"answered {res.completed}, shed {res.shed_total} ({res.shed_admission}, expired {res.shed_expired}), errors "
        f"{res.errors}, lost {lost}; resubmitted {resubmits}; routed {routed}; p99 {res.latency_p99_s * 1e3:.3f} ms; "
        f"replica 1 stopped with exit {rc1} on {smi}")
    return {"start_s": start_s, "sent": res.sent, "completed": res.completed, "shed": res.shed_total,
            "errors": res.errors, "lost": lost, "resubmits": resubmits, "routed": routed,
            "p99_s": res.latency_p99_s, "fleetz": fleet_out}


def serving_phase(torch, seed, smi, keep=None):
    """Phase 15: (a) the engine's checks; (b) and (c) the closed-loop
    protocol with a live flip; (d) the open-loop knee; (e) cli.serve
    replicas behind the front, one killed. S1's launches counted from 0
    over (b)-(d), the in-process serving path."""
    import os
    import tempfile

    from photon_ml_tpu_torch import convert, serving
    from photon_ml_tpu_torch.ops import sparse

    problems, out = [], {}
    t0 = time.perf_counter()
    parts, requests, unseen = serving_workload(seed)
    parts2 = serving_workload(seed, fe_shift=SERVING_SHIFT)[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        root = os.path.join(tmp, "serving")
        serving.publish_snapshot(root, "v1", game_model=convert.game_model_from_numpy(parts, device="cpu"))
        out["setup_s"] = time.perf_counter() - t0
        store = serving.open_current(root)[1]
        engine, out["engine"] = serving_engine_checks(torch, store, parts, requests, unseen, problems, smi)
        v1 = engine.score_requests(requests, count_cold=False)
        v2_store = serving.build_store_from_model(convert.game_model_from_numpy(parts2, device="cpu"),
                                                  os.path.join(tmp, "v2-reference"))
        v2 = serving.ScoreEngine.from_store(serving.ModelStore.open(v2_store)).score_requests(
            requests, count_cold=False)
        del engine
        sparse.reset_launch_counts()
        out["closed_loop"] = serving_closed_loop(torch, root, parts2, requests, v1, v2, problems, smi)
        out["knee"] = serving_knee(torch, root, requests, problems, smi)
        out["launches"] = dict(sparse.SPARSE_LAUNCHES)
        log(f"  S1 launches over (b)-(d): {out['launches']['ell_matvec']} for "
            f"{int(out['closed_loop']['requests'] + sum(s['sent'] for s in out['knee']['steps']))} requests")
        if not out["launches"]["ell_matvec"]:
            problems.append("the serving path launched no S1")
        out["replicas"] = serving_replicas(torch, root, requests, v2, problems, smi, keep)
    if problems:
        raise AssertionError("; ".join(problems))
    return out


# ------------------------------------------- phase 16: out-of-core training
#
# The streamed fixed effect (game/fe_streaming.py: row slices of the host
# batch through B1 / B2 in slot mode and the rank-order sum; ELL slices
# through S1), the streamed random effect (game/streaming.py: entity slices
# through the vmapped solve's V1 or the packed solve) and the pipelined
# sweep (game/pipeline.py), at phase 5's full width.

STREAM_FE_BUDGET = 256 << 20  # 16 slices of 32,768 rows of phase 5's X
STREAM_ELL_BUDGET = 64 << 20  # 5 slices of phase 9's ELL rows
STREAM_RE_SLICES = 4  # entity slices the budget of (c) cuts the largest size bucket into
STREAM_PASSES = 5  # timed value+grad passes of (a)
# hbm.budget.mb of (e) on both coordinates, and of phase 17 (f) and (g): a
# rank's share of phase 12's fixture (100,000 rows of the fixed effect,
# 409.6 MB; 7,099 users' blocks, 262.6 MB) exceeds it on both coordinates,
# and the fixed effect keeps (e)'s 7 slices a pass in one process (4 a
# rank); at 256 MiB a rank's random effect fit the budget and stayed
# resident
STREAM_GAME_BUDGET_MB = 224


def _host_rows(torch, data):
    """Phase 5's fixed-effect rows as a streamed batch's page-locked host
    planes (the pinning timed)."""
    from photon_ml_tpu_torch.game.data import HostRowBatch

    gx, y, _, _ = data
    n, d = gx.shape
    t0 = time.perf_counter()
    host = HostRowBatch(dim=d, labels=torch.from_numpy(y), offsets=torch.zeros(n), weights=torch.ones(n),
                        dense=torch.from_numpy(gx).pin_memory())
    return host, time.perf_counter() - t0


def pinned_copy_gbps(torch, src, dst, reps=3):
    """A page-locked host-to-card ``copy_``'s rate (GB/s, CUDA events) from
    ``src`` into ``dst``: the ceiling of a streamed pass."""
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return src.numel() * src.element_size() / (ms / 1e3) / 1e9


def _vec_err(got, ref):
    """(max-abs error, bound 3e-5 * max(|ref|, 1))."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max()), 3e-5 * max(float(ref.abs().max()), 1.0)


def stream_objective(torch, state, host, problems):
    """(a) One value+grad and one Hv at the resident solve's w, streamed
    against resident; two passes bitwise alike; each slice's slot row
    against the plain version's; the launches; the pass's wall."""
    from photon_ml_tpu_torch.game.fe_streaming import StreamedFEObjective
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.features import FeatureMatrix, LabeledBatch
    from photon_ml_tpu_torch.ops.glm import GLMObjective
    from photon_ml_tpu_torch.ops.losses import get_loss

    dev = torch.device("cuda")
    loss = get_loss("logistic_regression")
    batch = state["coords"]["global"].dataset.batch
    w = state["result"].model["global"].coefficients.means.to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    v = torch.randn(host.dim, generator=gen, device=dev)
    obj = StreamedFEObjective(loss, host, STREAM_FE_BUDGET, l2_weight=1.0, device=dev)
    ref = GLMObjective(loss=loss, batch=batch, l2=1.0)
    fg.reset_launch_counts()
    (v1, g1), (v2, g2) = obj.value_and_grad(w), obj.value_and_grad(w)
    hv1, hv2 = obj.hessian_vector(w, v), obj.hessian_vector(w, v)
    torch.cuda.synchronize()
    launches = {"B1": fg.LAUNCHES["fused_value_grad"], "B2": fg.LAUNCHES["fused_hessian_vector"],
                "B3": fg.LAUNCHES["fused_hessian_stats"], "rank_order_sum": fg.SUM_LAUNCHES["rank_order_sum"],
                "ring_bulk_copy": fg.ROUTES["ring_bulk_copy"]}
    k = obj.n_slices
    log(f"  (a) streamed objective: n={obj.n_rows} d={obj.dim}, budget {STREAM_FE_BUDGET} bytes -> "
        f"{obj.step} rows a slice, {k} slices; 2 value+grad and 2 Hv passes launched {launches}")
    if (launches["B1"], launches["B2"], launches["B3"], launches["rank_order_sum"]) != (2 * k, 2 * k, 0, 4):
        problems.append(f"(a) B1 / B2 / sum launches {launches} are not slices x passes ({k} x 2, 4 sums)")
    if launches["ring_bulk_copy"] != 4 * k:
        problems.append(f"(a) the slices did not all run the ring's bulk-copy route: {launches}")
    same = float(v1) == float(v2) and torch.equal(g1, g2) and torch.equal(hv1, hv2)
    log(f"  (a) two passes bitwise alike: {same}")
    if not same:
        problems.append("(a) two streamed passes differ")
    # streamed against resident, at the solve's first evaluation (w = 0)
    # and at its last (the resident solve's w): the value at rtol 2e-6, the
    # gradient and Hv at max-abs <= 3e-5 * max(|ref|, 1). At the solution
    # the gradient's column sums cancel to |g| < 1, where that bound is an
    # absolute 3e-5, below the f32 rounding of either path's column sums
    # (about 1e-4 for 500,000 rows of terms of 0.1-1): there both are held
    # against the float64 plain version, the streamed gradient no further
    # from it than the resident kernel's
    x64 = LabeledBatch(FeatureMatrix(dim=batch.dim, dense=batch.features.dense.double()), batch.labels.double(),
                       batch.offsets.double(), batch.weights.double())
    exact = GLMObjective(loss=loss, batch=x64, l2=1.0, plain=True)
    errs = {}
    for where, at in (("w=0", torch.zeros_like(w)), ("w*", w)):
        (sv, sg), (rv, rg) = obj.value_and_grad(at), ref.value_and_grad(at)
        shv, rhv = obj.hessian_vector(at, v), ref.hessian_vector(at, v)
        rel = abs(float(sv) - float(rv)) / abs(float(rv))
        e = {"value_rel": rel, "grad": _vec_err(sg, rg), "hv": _vec_err(shv, rhv)}
        held = rel <= 2e-6 and e["hv"][0] <= e["hv"][1]
        if where == "w*":
            _, xg = exact.value_and_grad(at.double())
            e["grad_vs_float64"] = {"streamed": _vec_err(sg, xg), "resident": _vec_err(rg, xg)}
            held = held and e["grad_vs_float64"]["streamed"][0] <= e["grad_vs_float64"]["resident"][0]
        else:
            held = held and e["grad"][0] <= e["grad"][1]
        log(f"  (a) streamed vs resident at {where}: value rel {rel:.3e} (rtol 2e-6), grad {e['grad'][0]:.3e} "
            f"(bound {e['grad'][1]:.3e}), Hv {e['hv'][0]:.3e} (bound {e['hv'][1]:.3e})"
            + ("" if where != "w*" else f"; grad vs float64: streamed {e['grad_vs_float64']['streamed'][0]:.3e}, "
               f"resident {e['grad_vs_float64']['resident'][0]:.3e} (bound {e['grad_vs_float64']['resident'][1]:.3e})")
            + f" {'ok' if held else 'MISS'}")
        if not held:
            problems.append(f"(a) streamed and resident objectives disagree at {where}: {e}")
        errs[where] = e
    del x64, exact
    # each slice's kernel against its plain version: the slot rows
    plain = StreamedFEObjective(loss, host, STREAM_FE_BUDGET, l2_weight=1.0, device=dev, plain=True)
    plain.value_and_grad(w)
    plain.hessian_vector(w, v)
    worst = {}
    d = obj.dim
    for mode, name in ((fg.VG, "fused_value_grad"), (fg.HV, "fused_hessian_vector")):
        got, want = obj._slots[mode], plain._slots[mode]
        e = 0.0
        for s in range(k):
            err, bound = _vec_err(got[s, :d], want[s, :d])
            e = max(e, err)
            if err > bound:
                problems.append(f"(a) slice {s}'s {name} disagrees with its plain version ({err:.3e} > {bound:.3e})")
        if mode == fg.VG:
            vrel = float(((got[:, d] - want[:, d]).abs() / want[:, d].abs()).max())
            if vrel > 2e-6:
                problems.append(f"(a) a slice's value disagrees with its plain version (rel {vrel:.3e})")
        worst[name] = e
    log(f"  (a) each slice's slot row vs its plain version: worst max-abs {worst}")
    del plain
    # the pass's wall (host clock around a synchronize) in turns with a
    # 1 GiB pinned copy_'s rate, so that both see the same state of the
    # host link; the achieved rate over the batch's own n*d*itemsize bytes
    src = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    walls, rates = [], []
    useful = obj.n_rows * obj.dim * host.dense.element_size()
    for _ in range(STREAM_PASSES):
        before = obj.stats["staged_bytes"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obj.value_and_grad(w)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if obj.stats["staged_bytes"] - before != useful:
            problems.append(f"(a) a pass staged {obj.stats['staged_bytes'] - before} bytes, not the batch's {useful}")
        rates.append(pinned_copy_gbps(torch, src, dst))
    del src, dst
    pass_s = sorted(walls)[len(walls) // 2]
    ceiling = sorted(rates)[len(rates) // 2]
    achieved = useful / pass_s / 1e9
    predicted_s = useful / (ceiling * 1e9)
    log(f"  (a) value+grad pass: median wall {pass_s * 1e3:.3f} ms of {STREAM_PASSES} "
        f"({', '.join(f'{w_ * 1e3:.3f}' for w_ in walls)}), {useful} bytes (n*d*itemsize) staged a pass: "
        f"{achieved:.2f} GB/s against a 1 GiB pinned copy_'s median {ceiling:.2f} GB/s, taken in turns with the "
        f"passes ({', '.join(f'{r:.2f}' for r in rates)}); n*d*itemsize at that rate {predicted_s * 1e3:.3f} ms "
        f"(ratio {pass_s / predicted_s:.3f})")
    return {"n_slices": k, "step": obj.step, "launches": launches, "errors": errs, "slice_errors": worst,
            "pass_ms": pass_s * 1e3, "pass_walls_ms": [x * 1e3 for x in walls], "staged_bytes_per_pass": useful,
            "achieved_gbps": achieved, "pinned_copy_gbps": ceiling, "pinned_copy_gbps_runs": rates,
            "predicted_pass_ms": predicted_s * 1e3}


def _stream_metrics(run, site):
    """The photon_stream_* series of ``site`` in ``run``'s registry."""
    out = {}
    for m in run.registry.snapshot():
        if m["name"].startswith("photon_stream_") and m["labels"].get("site") == site:
            key = m["name"][len("photon_stream_"):]
            kind = m["labels"].get("kind")
            out[f"{key}:{kind}" if kind else key] = m.get("value")
    return out


def stream_solves(torch, state, host, seed, problems):
    """(b) The streamed TRON solve against the resident solve (launches,
    wall, staged bytes, peak allocator bytes; depth 2's overlap), then an
    L-BFGS solve over ELL slices at phase 9's sparse shape through S1,
    against the resident ELL solve."""
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.game import GLMOptimizationConfig, GLMProblem, pipeline
    from photon_ml_tpu_torch.game.data import HostRowBatch
    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType

    reg = dict(regularization=RegularizationContext("L2"), reg_weight=1.0)
    tron = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.TRON, tolerance=1e-6, max_iterations=10), **reg))
    batch = state["coords"]["global"].dataset.batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model_r, res_r = tron.run(batch)
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    out = {"resident_s": resident_s}
    for depth in (1, 2):
        run = obs.RunTelemetry()
        fg.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with obs.use_run(run), pipeline.pipelined(depth):
            model_s, res_s = tron.run_streamed(host, STREAM_FE_BUDGET, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        m = _stream_metrics(run, "fe.train")
        vg, hvp = int(m["passes_total:vg"]), int(m["passes_total:hvp"])
        slices = int(m["slices_total"]) // (vg + hvp)
        launches = {"B1": fg.LAUNCHES["fused_value_grad"], "B2": fg.LAUNCHES["fused_hessian_vector"],
                    "rank_order_sum": fg.SUM_LAUNCHES["rank_order_sum"]}
        log(f"  (b) streamed TRON, depth {depth}: {wall:.3f} s (resident {resident_s:.3f} s), iterations "
            f"{res_s.iterations} reason {res_s.reason}; {vg} value+grad and {hvp} Hv passes of {slices} slices; "
            f"launches {launches}; staged {int(m['staged_bytes_total'])} bytes ("
            f"{m['staged_bytes_total'] / wall / 1e9:.2f} GB/s over the solve's wall); overlap ratio "
            f"{m['overlap_ratio']:.3f}; largest slice {int(m['actual_slice_bytes'])} bytes, headroom "
            f"{int(m['budget_headroom_bytes'])} of {STREAM_FE_BUDGET}; peak allocator bytes above what was held "
            f"{peak}")
        if (launches["B1"], launches["B2"], launches["rank_order_sum"]) != (vg * slices, hvp * slices, vg + hvp):
            problems.append(f"(b) depth {depth}: launches {launches} are not slices x passes ({slices} x {vg}, {hvp})")
        if 2 * m["actual_slice_bytes"] > STREAM_FE_BUDGET:
            problems.append(f"(b) two slices ({2 * m['actual_slice_bytes']} bytes) exceed the budget")
        hold(problems, f"(b) depth {depth} streamed vs resident TRON coefficients", model_s.coefficients.means,
             model_r.coefficients.means, 1e-3, 1e-5)
        out[f"depth{depth}"] = {"wall_s": wall, "iterations": int(res_s.iterations), "vg_passes": vg,
                                "hv_passes": hvp, "slices": slices, "launches": launches, "peak_bytes": peak,
                                "metrics": m}
        if depth == 1:
            means_1 = model_s.coefficients.means
        elif not _same_bits(model_s.coefficients.means, means_1):
            problems.append("(b) the depth-2 streamed solve differs from depth 1's bits")
    # ELL slices through S1 at phase 9's sparse shape
    rows, cols, vals, y, _ = sparse_triplets(SPARSE_N, SPARSE_D, SPARSE_K, seed)
    raw = RawDataset(n_rows=SPARSE_N, labels=y, offsets=np.zeros(SPARSE_N), weights=np.ones(SPARSE_N),
                     shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": SPARSE_D}, id_tags={})
    ell = raw.to_batch("global", layout="ell")
    hell = HostRowBatch(dim=SPARSE_D, labels=ell.labels.cpu(), offsets=ell.offsets.cpu(), weights=ell.weights.cpu(),
                        ell_idx=ell.features.idx.cpu().pin_memory(), ell_val=ell.features.val.cpu().pin_memory())
    lbfgs = GLMProblem("logistic_regression", GLMOptimizationConfig(
        optimizer=OptimizerConfig(tolerance=1e-9, max_iterations=SPARSE_ITERS), **reg))
    _, res_e = lbfgs.run(ell)
    run = obs.RunTelemetry()
    fg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.use_run(run):
        model_se, res_se = lbfgs.run_streamed(hell, STREAM_ELL_BUDGET, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = _stream_metrics(run, "fe.train")
    vg = int(m["passes_total:vg"])
    slices = int(m["slices_total"]) // max(vg + int(m["passes_total:hvp"]), 1)
    s1 = {k_: sparse.SPARSE_LAUNCHES[k_] for k_ in ("ell_matvec", "ell_rmatvec")}
    rel = abs(float(res_se.loss) - float(res_e.loss)) / abs(float(res_e.loss))
    log(f"  (b) streamed ELL L-BFGS (n={SPARSE_N}, d={SPARSE_D}, k={SPARSE_K}): {wall:.3f} s, {vg} passes of "
        f"{slices} slices, S1 launches {s1}, sums {fg.SUM_LAUNCHES['rank_order_sum']}, loss {float(res_se.loss):.6f} "
        f"against the resident solve's {float(res_e.loss):.6f} (rel {rel:.2e}, rtol 1e-5); staged "
        f"{int(m['staged_bytes_total'])} bytes, largest slice {int(m['actual_slice_bytes'])}")
    if s1["ell_matvec"] != vg * slices or s1["ell_rmatvec"] != vg * slices:
        problems.append(f"(b) S1 launches {s1} are not slices x passes ({slices} x {vg})")
    if rel > 1e-5:
        problems.append(f"(b) the streamed ELL solve's loss is {rel:.2e} from the resident one's")
    out["ell"] = {"wall_s": wall, "passes": vg, "slices": slices, "s1_launches": s1, "loss_rel": rel,
                  "sums": fg.SUM_LAUNCHES["rank_order_sum"]}
    out["ell_fit"] = stream_ell_fit(torch, hell, lbfgs.config, res_se, problems)
    del ell, hell
    return out


def stream_ell_fit(torch, hell, config, solved, problems):
    """A two-sweep coordinate-descent fit of the streamed ELL fixed effect
    on a batch object of its own (so its column segments are not built
    yet): each sweep's wall, the second without the host build of the
    slices' column segments, which the batch keeps (one entry), and the
    fit's loss against the single solve's. Before it, the streamed
    objective built twice over another fresh batch object: the first
    construction builds the segments, the second finds them kept."""
    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.game import CoordinateDescent, FixedEffectCoordinate, FixedEffectDataset
    from photon_ml_tpu_torch.game.data import HostRowBatch
    from photon_ml_tpu_torch.game.fe_streaming import StreamedFEObjective
    from photon_ml_tpu_torch.obs.timeline import TimelineRecorder
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.losses import get_loss

    def fresh():
        return HostRowBatch(dim=hell.dim, labels=hell.labels, offsets=hell.offsets, weights=hell.weights,
                            ell_idx=hell.ell_idx, ell_val=hell.ell_val)

    other, builds = fresh(), []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        StreamedFEObjective(get_loss("logistic_regression"), other, STREAM_ELL_BUDGET, device="cuda")
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
    log(f"  (b) streamed ELL objective built on a fresh batch: {builds[0]:.3f} s (the slices' column segments "
        f"built on the host), again {builds[1]:.3f} s (kept with the batch: {len(other.cache())} set)")
    del other
    hb = fresh()
    ds = FixedEffectDataset("global", "global", batch=None, true_dim=hb.dim, true_n_rows=hb.n_rows, host_batch=hb,
                            streamed=True, hbm_budget_bytes=STREAM_ELL_BUDGET, device=torch.device("cuda"))
    coord = FixedEffectCoordinate(dataset=ds, task="logistic_regression", config=config)
    run, rec = obs.RunTelemetry(), TimelineRecorder()
    run.register_listener(rec)
    fg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.use_run(run):
        res = CoordinateDescent({"global": coord}, n_iterations=2).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sweeps = [float(s_.duration_s) for s_ in rec.spans() if s_.name == "cd.sweep"]
    s1 = {k_: sparse.SPARSE_LAUNCHES[k_] for k_ in ("ell_matvec", "ell_rmatvec")}
    sums = fg.SUM_LAUNCHES["rank_order_sum"]
    entries = len(hb.cache())
    loss, single = float(res.solver_results["global"].loss), float(solved.loss)
    log(f"  (b) two-sweep streamed ELL fit: {wall:.3f} s, sweeps {', '.join(f'{x:.3f}' for x in sweeps)} s "
        f"(the first builds the slices' column segments on the host, the second reuses them); cached segment "
        f"sets {entries}; S1 launches {s1}, sums {sums}; the second sweep's loss {loss:.6f} from the single "
        f"solve's model (that solve {single:.6f})")
    if len(sweeps) != 2 or entries != 1:
        problems.append(f"(b) the two-sweep ELL fit ran {len(sweeps)} sweeps and built {entries} segment sets")
    if min(s1.values()) <= 0 or sums <= 0:
        problems.append(f"(b) the two-sweep ELL fit did not launch S1 and the sum: {s1}, {sums}")
    # the second sweep starts from the first's model, the single solve's
    if not loss <= single * (1 + 1e-6):
        problems.append(f"(b) the two-sweep ELL fit ends at loss {loss} above the single solve's {single}")
    return {"wall_s": wall, "sweep_s": sweeps, "segment_sets": entries, "s1_launches": s1, "sums": sums,
            "loss": loss, "objective_build_s": builds}


def _re_raw(data):
    from photon_ml_tpu_torch.io.data import RawDataset

    _, y, ex, ids = data
    n, d_re = ex.shape
    return RawDataset(
        n_rows=n, labels=y.astype(np.float64), offsets=np.zeros(n), weights=np.ones(n),
        shard_coo={"userShard": (np.repeat(np.arange(n), d_re), np.tile(np.arange(d_re), n),
                                 ex.reshape(-1).astype(np.float64))},
        shard_dims={"userShard": d_re}, id_tags={"userId": ids},
    )


def stream_random_effect(torch, state, problems):
    """(c) The random effect streamed in entity slices, the largest size
    bucket cut into STREAM_RE_SLICES or more: the vmapped solve bitwise the
    in-memory one, V1 launched; the packed solve at the packed bound."""
    import os

    from photon_ml_tpu_torch.game import RandomEffectCoordinate, build_random_effect_dataset
    from photon_ml_tpu_torch.game.coordinate import _size_buckets
    from photon_ml_tpu_torch.game.streaming import entities_per_slice
    from photon_ml_tpu_torch.ops import lane_reduce

    coords = state["coords"]
    mem = coords["per-user"]
    start, end, kb, sb = (_size_buckets(mem.dataset) or [(0, mem.dataset.num_entities, *mem.dataset.blocks.features.shape[1:])])[0]
    step = max(8, (end - start) // STREAM_RE_SLICES // 8 * 8)
    per_entity = 2 * (kb * sb * 4 + 3 * kb * 4 + (sb + kb) * 4) + 4 * sb * 4
    budget = step * per_entity
    assert entities_per_slice(budget, kb, sb) == step
    t0 = time.perf_counter()
    sds = build_random_effect_dataset(_re_raw(state["data"]), "per-user", "userShard", "userId", active_cap=256,
                                      device="cuda", hbm_budget_bytes=budget)
    build_s = time.perf_counter() - t0
    n_largest = -(-(end - start) // step)
    log(f"  (c) streamed random effect: budget {budget} bytes, {step} entities a slice of the largest bucket "
        f"({end - start} entities, K={kb}, S={sb}): {n_largest} slices; host blocks built in {build_s:.1f} s")
    if not sds.streamed or n_largest < STREAM_RE_SLICES:
        problems.append(f"(c) the budget did not cut the largest bucket into {STREAM_RE_SLICES} slices")
    streamed = RandomEffectCoordinate(dataset=sds, task="logistic_regression", config=mem.config)
    residual = coords["global"].score(state["result"].model["global"])
    out = {"budget_bytes": budget, "largest_bucket_slices": n_largest}
    for solver in ("vmapped", "packed"):
        os.environ["PHOTON_RE_SOLVER"] = solver
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m_mem, r_mem = mem.train(residual)
            torch.cuda.synchronize()
            mem_s = time.perf_counter() - t0
            lane_reduce.reset_launch_counts()
            t0 = time.perf_counter()
            m_str, r_str = streamed.train(residual)
            torch.cuda.synchronize()
            str_s = time.perf_counter() - t0
            v1 = dict(lane_reduce.LANE_LAUNCHES)
        finally:
            del os.environ["PHOTON_RE_SOLVER"]
        coef_gap = float((m_str.coef_values.double() - m_mem.coef_values.double().cpu()).abs().max())
        loss_gap = float((r_str.loss.double() - r_mem.loss.double().cpu()).abs().max())
        log(f"  (c) {solver}: in memory {mem_s:.3f} s, streamed {str_s:.3f} s; V1 launches over the streamed solve "
            f"{v1}; largest coefficient gap {coef_gap:.3e}, loss gap {loss_gap:.3e}")
        if solver == "vmapped":
            bitwise = _same_bits(m_str.coef_values, m_mem.coef_values.cpu()) and _same_bits(
                r_str.iterations, r_mem.iterations.cpu())
            log(f"  (c) vmapped streamed bitwise the in-memory solve: {bitwise}")
            if not bitwise:
                problems.append("(c) the vmapped streamed solve differs from the in-memory one's bits")
            if min(v1.values()) <= 0:
                problems.append(f"(c) V1 was not launched on both axes: {v1}")
        else:
            if coef_gap > 5e-3 or loss_gap > 1e-4:
                problems.append(f"(c) packed streamed vs in memory: coefficients {coef_gap:.3e} (atol 5e-3), loss "
                                f"{loss_gap:.3e} (atol 1e-4)")
        out[solver] = {"memory_s": mem_s, "streamed_s": str_s, "v1_launches": v1, "coef_gap": coef_gap,
                       "loss_gap": loss_gap}
    out["dataset"] = sds
    return out


def stream_pipeline(torch, state, host, sds, problems):
    """(d) A two-sweep GLMix fit over the streamed fixed effect and random
    effect at depth 1 and 2: models and ledger bitwise alike, the
    evaluations on the lane's thread, both walls."""
    import threading

    from photon_ml_tpu_torch import obs
    from photon_ml_tpu_torch.evaluation import build_suite
    from photon_ml_tpu_torch.game import (
        CoordinateDescent, FixedEffectCoordinate, FixedEffectDataset, RandomEffectCoordinate, ValidationContext,
    )
    from photon_ml_tpu_torch.obs.timeline import TimelineRecorder

    coords0 = state["coords"]
    fe_cfg = dataclasses.replace(coords0["global"].config, variance_type="NONE")
    fe_ds = FixedEffectDataset("global", "global", batch=None, true_dim=host.dim, true_n_rows=host.n_rows,
                               host_batch=host, streamed=True, hbm_budget_bytes=STREAM_FE_BUDGET,
                               device=torch.device("cuda"))
    runs = {}
    for depth in (1, 2):
        coords = {"global": FixedEffectCoordinate(dataset=fe_ds, task="logistic_regression", config=fe_cfg),
                  "per-user": RandomEffectCoordinate(dataset=sds, task="logistic_regression",
                                                     config=coords0["per-user"].config)}
        val = ValidationContext(suite=build_suite(["AUC"], host.labels.numpy()), offsets=np.zeros(host.n_rows),
                                score_fns={k: c.score for k, c in coords.items()})
        run = obs.RunTelemetry()
        rec = TimelineRecorder()
        run.register_listener(rec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with obs.use_run(run):
            res = CoordinateDescent(coords, n_iterations=2, validation=val, pipeline_depth=depth).run()
        torch.cuda.synchronize()
        runs[depth] = (coords, res, time.perf_counter() - t0, rec.spans())
    (c1, r1, w1, _), (_, r2, w2, spans) = runs[1], runs[2]
    same_fe = _same_bits(r1.model["global"].coefficients.means, r2.model["global"].coefficients.means)
    same_re = _same_bits(r1.model["per-user"].coef_values, r2.model["per-user"].coef_values)
    ledger = [(n, e.primary_metric) for n, e in r1.evaluations] == [(n, e.primary_metric) for n, e in r2.evaluations]
    evals = [s for s in spans if s.name == "cd.eval"]
    stages = [s for s in spans if s.name in ("fe_stream.stage", "re_stream.stage")]
    main = threading.main_thread().ident
    off_main = bool(evals) and all(s.thread_id != main and s.thread_name.startswith("photon-eval") for s in evals)
    staged_off = sorted({s.thread_name for s in stages if s.thread_id != main})
    log(f"  (d) two-sweep streamed GLMix fit: depth 1 {w1:.3f} s, depth 2 {w2:.3f} s; models bitwise alike: FE "
        f"{same_fe}, RE {same_re}; ledger alike {ledger} (best AUC {r1.best_evaluation.metrics['AUC']:.6f}); "
        f"{len(evals)} evaluations off the main thread: {off_main}; staging threads {staged_off}")
    if not (same_fe and same_re and ledger):
        problems.append("(d) depth 2 differs from depth 1")
    if not off_main:
        problems.append("(d) the depth-2 evaluations did not run on the eval lane's thread")
    return {"depth1_s": w1, "depth2_s": w2, "evaluations": len(evals), "staging_threads": staged_off,
            "best_auc": r1.best_evaluation.metrics["AUC"]}


def stream_cli(torch, fixture, game, problems, smi):
    """(e) cli.train on phase 12's fixture with hbm.budget.mb on both
    coordinates (variance NONE: a streamed fixed effect never forms its
    Hessian) and --pipeline-depth 2: the best model against phase 12 (b)'s
    at the solve bound, the report's streaming block."""
    import os

    from photon_ml_tpu_torch.io import load_game_model
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import lane_reduce

    root = fixture["root"]
    out, metrics_dir, report_dir = (os.path.join(root, f"stream-{x}") for x in ("out", "metrics", "report"))
    argv = stream_game_argv(fixture["train"], fixture["validation"], out,
                            ["--metrics-out", metrics_dir, "--report-out", report_dir])
    lane_reduce.reset_launch_counts()
    summary, wall, launches, _, s1 = _counted_train(torch, argv)
    sums = fg.SUM_LAUNCHES["rank_order_sum"]
    with open(os.path.join(report_dir, "report.json")) as f:
        streaming = json.load(f)["performance"]["streaming"]
    log(f"  (e) cli.train, hbm.budget.mb={STREAM_GAME_BUDGET_MB} on both coordinates, --pipeline-depth 2: "
        f"{wall:.2f} s; launches {launches}, sums {sums}, S1 ell_matvec {s1}; validation AUC "
        f"{summary['best']['metrics']['AUC']:.6f}; the report's streaming block "
        + json.dumps({k: {f: v.get(f) for f in ('slices_staged', 'staged_bytes', 'budget_utilization')}
                      for k, v in streaming.items()}) + f" on {smi}")
    if set(streaming) < {"fe.train", "re.train"} or not all(v.get("slices_staged") for v in streaming.values()):
        problems.append(f"(e) the report's streaming block is not populated: {sorted(streaming)}")
    if min(launches["fused_value_grad"], launches["fused_hessian_vector"], sums) <= 0:
        problems.append(f"(e) the streamed fixed effect did not launch B1, B2 and the sum: {launches}, {sums}")
    best = game.get("best") or {}
    if best:
        ours = load_game_model(os.path.join(out, "models", "best"), best["maps"], task="logistic_regression")
        theirs = load_game_model(os.path.join(best["out"], "models", "best"), best["maps"], task="logistic_regression")
        hold(problems, "(e) streamed vs phase 12 (b) FE coefficients", ours["global"].model.coefficients.means,
             theirs["global"].model.coefficients.means, 1e-3, 1e-5)
        hold(problems, "(e) streamed vs phase 12 (b) RE coefficients", ours["per-user"].coef_values,
             theirs["per-user"].coef_values, 0.0, 5e-3)
        log(f"  (e) validation AUC {summary['best']['metrics']['AUC']:.6f} against (b)'s {best['auc']:.6f}")
    else:
        problems.append("(e) phase 12 (b)'s model is missing")
    return {"wall_s": wall, "launches": launches, "sums": sums, "s1_launches": s1,
            "auc": summary["best"]["metrics"]["AUC"], "streaming": streaming, "out": out,
            "model_sha256": summary["best"]["model_sha256"]}


def stream_game_argv(train, validation, out, extra=()):
    """Phase 16 (e)'s cli.train argv (phase 17 (f) and (g) run it across
    processes): phase 12's, both coordinates under hbm.budget.mb, the fixed
    effect's variance NONE (a streamed fixed effect never forms its
    Hessian), --pipeline-depth 2."""
    fe = GAME_FE.replace("variance=SIMPLE", "variance=NONE") + f",hbm.budget.mb={STREAM_GAME_BUDGET_MB}"
    re_ = GAME_RE + f",hbm.budget.mb={STREAM_GAME_BUDGET_MB}"
    argv = game_argv(train, validation, out, ["--pipeline-depth", "2", *extra])
    argv[argv.index(GAME_FE)], argv[argv.index(GAME_RE)] = fe, re_
    return argv


def game_b_only(torch, fixture, smi):
    """Phase 12 (b) alone (``--only streaming`` or ``distributed``): the
    model phase 16 (e) and phase 17 hold their fits against."""
    problems = []
    b = game_train(torch, fixture["train"], fixture["validation"], fixture["root"], problems, smi)
    if problems:
        raise AssertionError("; ".join(problems))
    return {"best": {"maps": b["maps"], "out": b["out"], "auc": b["auc"]}, "b": b}


def streaming_phase(torch, state, fixture, game, seed, smi):
    """Phase 16 (a)-(e). Each part's launches are counted from 0 before it;
    the streamed paths' totals go into the kernels line."""
    problems, out = [], {}
    host, pin_s = _host_rows(torch, state["data"])
    log(f"  phase 5's X pinned in host memory ({host.dense.numel() * host.dense.element_size()} bytes) in "
        f"{pin_s:.2f} s")
    out["objective"] = stream_objective(torch, state, host, problems)
    torch.cuda.empty_cache()
    out["solves"] = stream_solves(torch, state, host, seed, problems)
    torch.cuda.empty_cache()
    re_ = stream_random_effect(torch, state, problems)
    sds = re_.pop("dataset")
    out["random_effect"] = re_
    torch.cuda.empty_cache()
    out["pipeline"] = stream_pipeline(torch, state, host, sds, problems)
    del sds
    torch.cuda.empty_cache()
    if fixture is not None:
        out["cli"] = stream_cli(torch, fixture, game or {}, problems, smi)
    else:
        problems.append("(e) needs phase 12's fixture")
    log(f"  on {smi}")
    if problems:
        raise AssertionError("; ".join(problems))
    return out


def streamed_launches(streaming):
    """The streamed paths' launches by kernel, for the kernels line: (a)'s
    passes, (b)'s solves (depth 1 and 2, the ELL solve's and the two-sweep
    ELL fit's S1), (c)'s V1 and (e)'s driver run."""
    st = streaming or {}
    a = st.get("objective") or {}
    b = st.get("solves") or {}
    c = st.get("random_effect") or {}
    e = st.get("cli") or {}
    total = {"fused_value_grad": 0, "fused_hessian_vector": 0, "rank_order_sum": 0, "lane_reduce": 0,
             "ell_matvec": 0, "ell_rmatvec": 0}
    la = a.get("launches") or {}
    total["fused_value_grad"] += la.get("B1", 0)
    total["fused_hessian_vector"] += la.get("B2", 0)
    total["rank_order_sum"] += la.get("rank_order_sum", 0)
    for depth in ("depth1", "depth2"):
        lb = (b.get(depth) or {}).get("launches") or {}
        total["fused_value_grad"] += lb.get("B1", 0)
        total["fused_hessian_vector"] += lb.get("B2", 0)
        total["rank_order_sum"] += lb.get("rank_order_sum", 0)
    ell = b.get("ell") or {}
    for k in ("ell_matvec", "ell_rmatvec"):
        total[k] += (ell.get("s1_launches") or {}).get(k, 0)
    total["rank_order_sum"] += ell.get("sums", 0)
    fit = b.get("ell_fit") or {}
    for k in ("ell_matvec", "ell_rmatvec"):
        total[k] += (fit.get("s1_launches") or {}).get(k, 0)
    total["rank_order_sum"] += fit.get("sums", 0)
    total["lane_reduce"] += sum(((c.get("vmapped") or {}).get("v1_launches") or {}).values())
    le = e.get("launches") or {}
    total["fused_value_grad"] += le.get("fused_value_grad", 0)
    total["fused_hessian_vector"] += le.get("fused_hessian_vector", 0)
    total["rank_order_sum"] += e.get("sums", 0)
    return total


# --------------------------------- phase 18: the tiled fixed effect on a grid

TILED_GRID = (2, 2)  # (data, model): 4 gloo ranks sharing the card
TILED_TIMEOUT_S = 300.0  # the spawn, start to join
# (a), (b): bench.py's sparse configuration; (c): d = 8,191, padded to
# 8,192 on the model axis of 2 (one pinned column), 24,576 rows (12,288 a
# data row: three chunks of the default 4,096) of 16 entries
TILED_SIZES = dict(n=SPARSE_N, d=SPARSE_D, k=SPARSE_K, full_d=8191, full_rows=24_576, full_k=16)
TILED_L2 = 1.0


def _tiled_full_case(seed, sizes):
    """(c)'s data: ``full_rows`` rows of ``full_k`` entries over ``full_d``
    columns, labels and a coefficient vector, from ``seed``."""
    rng = np.random.default_rng(seed + 18)
    n, d, k = sizes["full_rows"], sizes["full_d"], sizes["full_k"]
    rows = np.repeat(np.arange(n), k).astype(np.int64)
    cols = rng.integers(0, d, size=n * k).astype(np.int64)
    vals = (rng.normal(size=n * k) * 0.3).astype(np.float32).astype(np.float64)
    y = (rng.uniform(size=n) < 0.5).astype(np.float64)
    w = (rng.normal(size=d) * 0.05).astype(np.float32).astype(np.float64)
    return rows, cols, vals, y, w


def _same_np(a, b) -> bool:
    """Two numpy arrays of the same dtype and shape, bitwise."""
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def _cuda_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_reset(torch, dev) -> int:
    """Reset the allocator's peak on a card; the bytes held now (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_gib(torch, dev, base=0) -> float:
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**30 if dev.type == "cuda" else 0.0


def tiled_rank(group, path, sizes, dense_dir=None):
    """One rank of phase 18 on the (2 x 2) grid: (a) its tile's products,
    (b) the L-BFGS solve through GLMProblem.run, (c) FULL variances on
    tiles, (e) the dense feature-axis shard's TRON solve (with ``dense_dir``,
    the directory of phase 5's ``gx.npy`` and ``y.npy``); counters from 0
    before each, read after. ``sizes``: the widths (``TILED_SIZES``; a CPU
    rehearsal passes small ones)."""
    import torch

    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.parallel.mesh import make_mesh
    from photon_ml_tpu_torch.parallel.sparse import replicated_coefficients, tiled_sparse_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    data = np.load(path)
    mesh = make_mesh(*TILED_GRID, group=group)
    dev = mesh.device
    out = {"pos": (mesh.data_index, mesh.model_index)}
    t0 = time.perf_counter()
    tb = tiled_sparse_batch(data["rows"], data["cols"], data["vals"], data["y"], sizes["d"], mesh)
    _cuda_sync(torch, dev)
    f = tb.features
    out["build_s"] = time.perf_counter() - t0
    out["tile"] = {"rows": f.n_local_rows, "cols": f.d_local, "entries": int(f.tile.coo_vals.numel())}
    w = replicated_coefficients(data["w"], mesh)
    lo = mesh.data_index * f.n_local_rows
    c = torch.zeros(f.n_local_rows, dtype=torch.float32)
    part = torch.as_tensor(data["c"][lo : lo + f.n_local_rows], dtype=torch.float32)
    c[: part.numel()] = part
    c = c.to(mesh.device)

    # (a) the products, each one S1 launch and one rank-order sum
    fg.reset_launch_counts()
    z, g, g2 = f.matvec(w), f.rmatvec(c), f.sq_rmatvec(c)
    _cuda_sync(torch, dev)
    out["a"] = {
        "z": z.cpu().numpy(), "g": g.cpu().numpy(), "g2": g2.cpu().numpy(),
        "s1": {k: v for k, v in sparse.SPARSE_LAUNCHES.items() if v}, "sums": dict(fg.SUM_LAUNCHES),
        "dense": sum(fg.LAUNCHES.values()),
    }
    del z, g, g2

    # (b) phase 9's L-BFGS solve, twice (the same bits), the second counted
    problem = _sparse_problem(torch, OptimizerConfig(tolerance=1e-9, max_iterations=SPARSE_ITERS))
    runs = []
    for _ in range(2):
        _cuda_sync(torch, dev)
        fg.reset_launch_counts()
        base = _peak_reset(torch, dev)
        before = (mesh.data.collectives, mesh.model.collectives, mesh.data.collective_seconds,
                  mesh.model.collective_seconds)
        t0 = time.perf_counter()
        model, res = problem.run(tb)
        float(res.loss)
        _cuda_sync(torch, dev)
        wall = time.perf_counter() - t0
        runs.append({
            "wall_s": wall, "loss": float(res.loss), "iterations": int(res.iterations), "reason": int(res.reason),
            "means": _digest(model.coefficients.means), "slice": _digest(mesh.model_slice(model.coefficients.means)),
            "collectives": {"data": mesh.data.collectives - before[0], "model": mesh.model.collectives - before[1]},
            "collective_s": {"data": mesh.data.collective_seconds - before[2],
                             "model": mesh.model.collective_seconds - before[3]},
            "s1": {k: v for k, v in sparse.SPARSE_LAUNCHES.items() if v}, "sums": dict(fg.SUM_LAUNCHES),
            "routes": {k: v for k, v in fg.OBJECTIVE_ROUTES.items() if v}, "dense": sum(fg.LAUNCHES.values()),
            "peak_gib": _peak_gib(torch, dev, base), "held_gib": base / 2**30, "syncs": res.syncs,
        })
        del model, res
    out["b"] = runs
    del tb, f, w, c
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) FULL variances on tiles
    d_full = sizes["full_d"]
    tb = tiled_sparse_batch(data["f_rows"], data["f_cols"], data["f_vals"], data["f_y"], d_full, mesh)
    obj = GLMObjective(loss=LOSSES["logistic"], batch=tb, l2=TILED_L2)
    wf = np.zeros(tb.dim)
    wf[:d_full] = data["f_w"]
    coef = replicated_coefficients(wf, mesh)
    _cuda_sync(torch, dev)
    fg.reset_launch_counts()
    base = _peak_reset(torch, dev)
    t0 = time.perf_counter()
    var = compute_variances(obj, coef, "FULL")
    _cuda_sync(torch, dev)
    out["c"] = {
        "wall_s": time.perf_counter() - t0, "var": var.cpu().numpy(), "dim": tb.dim,
        "chunk": tb.features.default_row_chunk(), "rows_local": tb.features.n_local_rows,
        "peak_gib": _peak_gib(torch, dev, base),
        "s1": {k: v for k, v in sparse.SPARSE_LAUNCHES.items() if v}, "sums": dict(fg.SUM_LAUNCHES),
    }
    del tb, obj, coef, var
    if dense_dir is not None:
        out["e"] = _dense_shard_rank(torch, mesh, dense_dir)
    return out


def _dense_shard_rank(torch, mesh, dense_dir):
    """(e) on one rank: phase 5's whole fixed-effect batch as a view of the
    memory-mapped X (copy-on-write: nothing is read but the tile), the
    rank's dense tile cut by shard_batch(shard_features_dim=True) onto the
    card, and phase 5's fixed-effect TRON + SIMPLE solve through
    GLMProblem.run on it, counters from 0 before the solve."""
    from photon_ml_tpu_torch.game.problem import GLMProblem
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops import sparse
    from photon_ml_tpu_torch.ops.features import FeatureMatrix, LabeledBatch
    from photon_ml_tpu_torch.parallel.mesh import shard_batch

    dev = mesh.device
    gx = np.load(f"{dense_dir}/gx.npy", mmap_mode="c")
    y = torch.from_numpy(np.load(f"{dense_dir}/y.npy"))
    n, d = gx.shape
    whole = LabeledBatch(features=FeatureMatrix(dim=d, dense=torch.from_numpy(gx)), labels=y,
                         offsets=torch.zeros(n), weights=torch.ones(n))
    t0 = time.perf_counter()
    tb = shard_batch(whole, mesh, shard_features_dim=True)
    _cuda_sync(torch, dev)
    build_s = time.perf_counter() - t0
    del whole, gx
    problem = GLMProblem("logistic_regression", dense_fe_config())
    fg.reset_launch_counts()
    base = _peak_reset(torch, dev)
    before = (mesh.data.collectives, mesh.model.collectives, mesh.data.collective_seconds,
              mesh.model.collective_seconds)
    t0 = time.perf_counter()
    model, res = problem.run(tb)
    float(res.loss)
    _cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    co = model.coefficients
    return {
        "tile": tuple(tb.features.tile.dense.shape), "tile_gb": tb.features.tile.dense.numel() * 4 / 1e9,
        "build_s": build_s, "wall_s": wall, "loss": float(res.loss), "iterations": int(res.iterations),
        "reason": int(res.reason), "syncs": res.syncs, "means": co.means.cpu().numpy(),
        "variances": co.variances.cpu().numpy(),
        "collectives": {"data": mesh.data.collectives - before[0], "model": mesh.model.collectives - before[1]},
        "collective_s": {"data": mesh.data.collective_seconds - before[2],
                         "model": mesh.model.collective_seconds - before[3]},
        "launches": dict(fg.LAUNCHES), "sharded": dict(fg.SHARDED_LAUNCHES), "sums": dict(fg.SUM_LAUNCHES),
        "s1": sum(sparse.SPARSE_LAUNCHES.values()), "routes": {k: v for k, v in fg.OBJECTIVE_ROUTES.items() if v},
        "peak_gib": _peak_gib(torch, dev, base),
    }


def dense_fe_config():
    """Phase 5's fixed-effect solve (glmix_coordinates' ``cfg_fe``): TRON
    tol 1e-6, 10 iterations, L2 1.0, SIMPLE variance."""
    from photon_ml_tpu_torch.game import GLMOptimizationConfig
    from photon_ml_tpu_torch.ops.regularization import RegularizationContext
    from photon_ml_tpu_torch.optimize import OptimizerConfig, OptimizerType

    return GLMOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.TRON, tolerance=1e-6, max_iterations=10),
        variance_type="SIMPLE", regularization=RegularizationContext("L2"), reg_weight=1.0,
    )


def _tiled_vg_times(torch, whole, rows, cols, vals, y, d):
    """bench.py's ``tiled`` measure, printed: S1's value+grad (one matvec,
    one rmatvec) on one card at the whole nnz (the COO batch ``whole``) and
    at the (2 x 4) grid's tile (0, 0), CUDA events over 20 calls after 3."""
    from photon_ml_tpu_torch.ops.features import batch_from_coo
    from photon_ml_tpu_torch.ops.glm import GLMObjective
    from photon_ml_tpu_torch.ops.losses import LOSSES

    n = len(y)
    sel = (rows < n // 2) & (cols < d // 4)
    tile = batch_from_coo(rows[sel], cols[sel], vals[sel], y[: n // 2], d // 4, layout="coo")
    out = {}
    for name, batch, dim in (("whole", whole, d), ("tile_0_0_of_2x4", tile, d // 4)):
        obj = GLMObjective(loss=LOSSES["logistic"], batch=batch, l2=1.0)
        wz = torch.zeros(dim, device="cuda")
        out[name] = {"ms": time_ms(torch, lambda: obj.value_and_grad(wz), 20), "entries": int(batch.features.coo_vals.numel())}
    out["ratio"] = out["whole"]["ms"] / out["tile_0_0_of_2x4"]["ms"]
    return out


def tiled_phase(torch, seed, smi, fixture=None, game=None, device="cuda", sizes=None, fe_xy=None, dense_args=None):
    """Phase 18: the (data x model)-tiled fixed effect on a 2 x 2 grid of
    gloo ranks sharing the card; (a)-(f) as in the module docstring, (d)
    and (f) on phase 12's fixture with its (b)'s coordinates (left out
    without them), (e) on ``fe_xy``, phase 5's ``(gx, y)``, or on
    ``build_data(*dense_args)`` without phase 5 (left out without
    either). ``device="cpu"`` with small ``sizes`` rehearses (a)-(c) and
    (e) on the CPU through the plain versions."""
    import concurrent.futures
    import tempfile

    from photon_ml_tpu_torch.io.data import RawDataset
    from photon_ml_tpu_torch.ops import cuda_lib
    from photon_ml_tpu_torch.ops.features import batch_from_dense
    from photon_ml_tpu_torch.ops.glm import GLMObjective, compute_variances
    from photon_ml_tpu_torch.ops.losses import LOSSES
    from photon_ml_tpu_torch.optimize import OptimizerConfig
    from photon_ml_tpu_torch.parallel import spawn

    sizes = dict(TILED_SIZES, **(sizes or {}))
    dev = torch.device(device)
    problems, report = [], {}
    n, d = sizes["n"], sizes["d"]
    if fe_xy is None and dense_args is not None:
        t0 = time.perf_counter()
        fe_xy = build_data(*dense_args)[:2]
        log(f"  (e)'s data: bench.py's build_data without phase 5, made in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rows, cols, vals, y, _ = sparse_triplets(n, d, sizes["k"], seed)
    vals = vals.astype(np.float32).astype(np.float64)  # the tiles' float32 values
    rng = np.random.default_rng(seed + 19)
    w = (rng.normal(size=d) * 0.1).astype(np.float32).astype(np.float64)
    c = rng.normal(size=n).astype(np.float32).astype(np.float64)
    f_rows, f_cols, f_vals, f_y, f_w = _tiled_full_case(seed, sizes)
    d_full = sizes["full_d"]
    if dev.type == "cuda":
        for lib in ("sparse_glm", "fused_glm"):
            cuda_lib.load(lib)  # built here, so that no two ranks run nvcc
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiled_") as tmp:
        path = f"{tmp}/data.npz"
        np.savez(path, rows=rows, cols=cols, vals=vals, y=y, w=w, c=c, f_rows=f_rows, f_cols=f_cols,
                 f_vals=f_vals, f_y=f_y, f_w=f_w)
        dense_dir = None
        if fe_xy is not None:
            # (e)'s X once on disk, memory-mapped by every rank (phase 6 (b)'s way)
            dense_dir = tmp
            np.save(f"{tmp}/gx.npy", fe_xy[0])
            np.save(f"{tmp}/y.npy", fe_xy[1])
        log(f"  data made in {time.perf_counter() - t0:.1f}s" + (
            f" ((e)'s {fe_xy[0].shape[0]} x {fe_xy[0].shape[1]} X written for the ranks)" if fe_xy else ""))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as waiter:
            pending = waiter.submit(spawn, tiled_rank, TILED_GRID[0] * TILED_GRID[1], "gloo", device,
                                    args=(path, sizes, dense_dir), timeout_s=TILED_TIMEOUT_S, store_dir=tmp)
            # while the ranks run, this process builds the references'
            # inputs on the host (nothing timed runs here until they end)
            z_ref = np.bincount(rows, weights=vals * w[cols], minlength=n)
            g_ref = np.bincount(cols, weights=vals * c[rows], minlength=d)
            g2_ref = np.bincount(cols, weights=vals * vals * c[rows], minlength=d)
            raw = RawDataset(n_rows=n, labels=y, offsets=np.zeros(n), weights=np.ones(n),
                             shard_coo={"global": (rows, cols, vals)}, shard_dims={"global": d}, id_tags={})
            batch = raw.to_batch("global", layout="coo", device=dev)
            del raw
            x = np.zeros((sizes["full_rows"], d_full), dtype=np.float32)
            np.add.at(x, (f_rows, f_cols), f_vals.astype(np.float32))
            dense = batch_from_dense(x, f_y, device=dev)
            del x
            ranks = pending.result()
        report["ranks_s"] = time.perf_counter() - t0
    log(f"  {len(ranks)} gloo ranks on a {TILED_GRID[0]} x {TILED_GRID[1]} grid done in {report['ranks_s']:.1f}s "
        "(this process built the references' inputs meanwhile); "
        + "; ".join(f"rank {r} at {o['pos']}: tile {o['tile']['rows']} x {o['tile']['cols']} with "
                    f"{o['tile']['entries']} entries built in {o['build_s']:.1f}s" for r, o in enumerate(ranks)))

    # (a) against float64 plain products of the whole batch
    t0 = time.perf_counter()
    by_pos = {o["pos"]: o for o in ranks}
    D, M = TILED_GRID
    same_rows = all(_same_np(by_pos[(i, j)]["a"]["z"], by_pos[(i, 0)]["a"]["z"]) for i in range(D) for j in range(M))
    same_cols = all(_same_np(by_pos[(i, j)]["a"][k], by_pos[(0, j)]["a"][k])
                    for i in range(D) for j in range(M) for k in ("g", "g2"))
    z = np.concatenate([by_pos[(i, 0)]["a"]["z"] for i in range(D)])[:n]
    errs = {}
    for name, got, ref in (("matvec", z, z_ref),
                           ("rmatvec", np.concatenate([by_pos[(0, j)]["a"]["g"] for j in range(M)])[:d], g_ref),
                           ("sq_rmatvec", np.concatenate([by_pos[(0, j)]["a"]["g2"] for j in range(M)])[:d], g2_ref)):
        err = float(np.abs(got.astype(np.float64) - ref).max())
        bound = 3e-5 * max(float(np.abs(ref).max()), 1.0)
        errs[name] = err
        log(f"  (a) tiled {name}: max-abs err {err:.3e} (bound {bound:.3e}) {'ok' if err <= bound else 'MISS'}")
        if not err <= bound:
            problems.append(f"(a) {name} err {err:.3e} > {bound:.3e}")
    a_launches = [o["a"]["s1"] for o in ranks]
    a_sums = [o["a"]["sums"]["rank_order_sum"] for o in ranks]
    log(f"  (a) data rows bitwise alike (z): {same_rows}; model columns bitwise alike (gradient slices): "
        f"{same_cols}; S1 launches per rank {a_launches}; sums per rank {a_sums}; dense launches "
        f"{[o['a']['dense'] for o in ranks]} (held in {time.perf_counter() - t0:.1f}s)")
    if not (same_rows and same_cols):
        problems.append("(a) ranks of a subgroup differ")
    if any(l != {"coo_matvec": 1, "coo_rmatvec": 1, "coo_sq_rmatvec": 1} for l in a_launches) or any(
            o["a"]["dense"] for o in ranks) or any(s != 3 for s in a_sums):
        problems.append(f"(a) launches: S1 {a_launches}, sums {a_sums}")
    report["a"] = {"errors": errs, "s1": a_launches, "sums": a_sums}
    del z_ref, g_ref, g2_ref, z

    # (b) against phase 9's one-card COO solve, by loss at rtol 1e-5
    problem = _sparse_problem(torch, OptimizerConfig(tolerance=1e-9, max_iterations=SPARSE_ITERS))
    t0 = time.perf_counter()
    _, res1 = problem.run(batch)
    loss1 = float(res1.loss)
    wall1 = time.perf_counter() - t0
    last = [o["b"][-1] for o in ranks]
    keys = ("loss", "iterations", "reason", "means")
    alike = all(r[k] == last[0][k] for r in last for k in keys)
    twice = all(o["b"][0][k] == o["b"][1][k] for o in ranks for k in keys)
    slices = all(by_pos[(i, j)]["b"][-1]["slice"] == by_pos[(0, j)]["b"][-1]["slice"]
                 for i in range(D) for j in range(M))
    rel = abs(last[0]["loss"] - loss1) / abs(loss1)
    walls = [r["wall_s"] for r in last]
    log(f"  (b) tiled L-BFGS on {D} x {M}: iterations={last[0]['iterations']} reason={last[0]['reason']} "
        f"loss={last[0]['loss']:.6f} wall {max(walls):.3f} s (first run {max(o['b'][0]['wall_s'] for o in ranks):.3f} s); "
        f"one-card COO: iterations={res1.iterations} loss={loss1:.6f} wall {wall1:.4f} s; loss rel diff {rel:.2e} "
        f"(rtol 1e-5); every rank alike (iterations, reason, loss, whole model bits): {alike}; slices bitwise "
        f"within each model column: {slices}; two runs the same bits: {twice}")
    for r, o in enumerate(ranks):
        b = o["b"][-1]
        log(f"  (b) rank {r} at {o['pos']}: wall {b['wall_s']:.3f} s, collectives data {b['collectives']['data']} "
            f"({b['collective_s']['data']:.3f} s) model {b['collectives']['model']} ({b['collective_s']['model']:.3f} s), "
            f"S1 {b['s1']}, sums {b['sums']['rank_order_sum']}, routes {b['routes']}, dense {b['dense']}, "
            f"syncs {b['syncs']}, allocator peak {b['peak_gib']:.3f} GiB")
    if not (rel <= 1e-5 and alike and twice and slices and math.isfinite(last[0]["loss"])):
        problems.append(f"(b) loss rel diff {rel:.2e}, ranks alike {alike}, twice {twice}, slices {slices}")
    for b in last:
        if b["routes"] != {"tiled_kernel": 1} or b["dense"] or not b["s1"].get("coo_matvec") or not b["s1"].get(
                "coo_rmatvec") or not b["sums"]["rank_order_sum"]:
            problems.append(f"(b) launches or routes off the tiled kernel path: {b['routes']} {b['s1']} {b['sums']}")
    report["b"] = {"ranks": last, "loss_rel": rel, "one_card_loss": loss1, "one_card_wall_s": wall1,
                   "iterations": last[0]["iterations"]}
    if dev.type == "cuda":
        report["vg_times"] = vt = _tiled_vg_times(torch, batch, rows, cols, vals, y, d)
        log(f"  (b) bench.py's tiled measure on one card: S1 value+grad {vt['whole']['ms']:.4f} ms at the whole nnz "
            f"({vt['whole']['entries']} entries) against {vt['tile_0_0_of_2x4']['ms']:.4f} ms at the (2 x 4) tile "
            f"(0, 0) ({vt['tile_0_0_of_2x4']['entries']} entries): {vt['ratio']:.2f}x (8.0 = linear)")
    del batch, rows, cols, vals, y
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (c) against the one-card dense FULL path at rtol 1e-3
    t0 = time.perf_counter()
    obj = GLMObjective(loss=LOSSES["logistic"], batch=dense, l2=TILED_L2)
    var_ref = compute_variances(obj, torch.as_tensor(f_w, dtype=torch.float32, device=dev), "FULL")
    var_ref = var_ref.cpu().numpy().astype(np.float64)
    ref_s = time.perf_counter() - t0
    del dense, obj
    cs = [o["c"] for o in ranks]
    alike = all(_same_np(x_["var"], cs[0]["var"]) for x_ in cs)
    var = cs[0]["var"].astype(np.float64)
    rel_each = float((np.abs(var[:d_full] - var_ref) / np.abs(var_ref)).max())
    pinned = var[d_full:]
    pin_ok = bool(np.allclose(pinned, 1.0 / (1.0 + TILED_L2), rtol=1e-6))
    log(f"  (c) FULL on tiles d={d_full} (padded {cs[0]['dim']}), {sizes['full_rows']} rows ({cs[0]['rows_local']} a "
        f"data row, chunks of {cs[0]['chunk']}): wall {max(x_['wall_s'] for x_ in cs):.2f} s a rank, peak "
        f"{max(x_['peak_gib'] for x_ in cs):.2f} GiB above what was held; one-card dense FULL {ref_s:.2f} s; max rel "
        f"diff {rel_each:.2e} (rtol 1e-3); ranks bitwise alike {alike}; padded variances {pinned} (1/(1+l2) "
        f"{'ok' if pin_ok else 'MISS'}); S1 {[x_['s1'] for x_ in cs]}, sums {[x_['sums']['rank_order_sum'] for x_ in cs]}")
    if not (rel_each <= 1e-3 and alike and pin_ok and np.all(np.isfinite(var))):
        problems.append(f"(c) FULL rel diff {rel_each:.2e}, ranks alike {alike}, pinned {pinned}")
    report["c"] = {"rel": rel_each, "wall_s": max(x_["wall_s"] for x_ in cs), "ref_s": ref_s,
                   "peak_gib": max(x_["peak_gib"] for x_ in cs), "chunk": cs[0]["chunk"]}
    if fe_xy is not None:
        report["e"] = dense_shard_holds(torch, ranks, fe_xy, dev, problems, smi)
        fe_xy = None
    if fixture is not None and (game or {}).get("b"):
        report["d"] = tiled_driver(torch, fixture, game["b"], problems, smi)
    d_s1 = (report.get("d") or {}).get("s1_per_rank") or [{} for _ in ranks]
    d_sums = (report.get("d") or {}).get("sums_per_rank") or [0 for _ in ranks]
    e_sums = [o.get("e", {}).get("sums", {}).get("rank_order_sum", 0) for o in ranks]
    # B1-B3 and B4 a rank: (e) runs none (torch.mv on the tile), (f) the
    # dense fixed effect's over its model column's data subgroup
    d_dense = (report.get("d") or {}).get("dense_per_rank") or [{} for _ in ranks]
    d_sharded = (report.get("d") or {}).get("sharded_per_rank") or [{} for _ in ranks]
    report["launches"] = {
        "s1_per_rank": [{k: o["a"]["s1"].get(k, 0) + o["b"][-1]["s1"].get(k, 0) + o["c"]["s1"].get(k, 0)
                         + d_s1[r].get(k, 0) for k in SPARSE_PRODUCTS if k.startswith("coo_")}
                        for r, o in enumerate(ranks)],
        "sums_per_rank": [o["a"]["sums"]["rank_order_sum"] + o["b"][-1]["sums"]["rank_order_sum"]
                          + o["c"]["sums"]["rank_order_sum"] + d_sums[r] + e_sums[r] for r, o in enumerate(ranks)],
        "dense_per_rank": [{k: d_dense[r].get(k, 0) + o.get("e", {}).get("launches", {}).get(k, 0)
                            for k in ("fused_value_grad", "fused_hessian_vector", "fused_hessian_stats")}
                           for r, o in enumerate(ranks)],
        "sharded_per_rank": [{k: d_sharded[r].get(k, 0) + o.get("e", {}).get("sharded", {}).get(k, 0)
                              for k in B4_OF} for r, o in enumerate(ranks)],
    }
    if problems:
        raise AssertionError("; ".join(problems))
    return report


def dense_shard_holds(torch, ranks, dense, dev, problems, smi):
    """(e)'s holds: phase 5's fixed-effect solve on one card (B1, B2, B3 on
    the whole X, from the same w0 = 0) against the grid's solve on dense
    tiles, coefficients and SIMPLE variances at rtol 1e-3 / atol 1e-5;
    every rank with the same iterations, reason, loss and model bits; each
    rank on the ``tiled_dense`` route with the rank-order sum and no B1-B4
    launch. Per rank: the solve's wall, its collectives and their seconds
    by subgroup, its launches."""
    from photon_ml_tpu_torch.game.problem import GLMProblem
    from photon_ml_tpu_torch.ops import fused_glm as fg
    from photon_ml_tpu_torch.ops.features import batch_from_dense

    es = [o["e"] for o in ranks]
    gx, y = dense
    batch = batch_from_dense(gx, y, device=dev)
    fg.reset_launch_counts()
    _cuda_sync(torch, dev)
    t0 = time.perf_counter()
    model, res = GLMProblem("logistic_regression", dense_fe_config()).run(batch)
    float(res.loss)
    _cuda_sync(torch, dev)
    wall = time.perf_counter() - t0
    one_launches = dict(fg.LAUNCHES)
    ref_means, ref_var = model.coefficients.means, model.coefficients.variances
    del batch, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    keys = ("loss", "iterations", "reason")
    alike = all(e[k] == es[0][k] for e in es for k in keys) and all(
        _same_np(e["means"], es[0]["means"]) and _same_np(e["variances"], es[0]["variances"]) for e in es)
    log(f"  (e) the dense feature-axis shard: phase 5's {gx.shape[0]} x {gx.shape[1]} X, a {es[0]['tile'][0]} x "
        f"{es[0]['tile'][1]} tile a rank ({es[0]['tile_gb']:.3f} GB, cut in "
        f"{max(e['build_s'] for e in es):.2f} s); TRON + SIMPLE on {TILED_GRID[0]} x {TILED_GRID[1]}: iterations="
        f"{es[0]['iterations']} reason={es[0]['reason']} loss={es[0]['loss']:.6f} wall {max(e['wall_s'] for e in es):.3f} "
        f"s; one card (B1/B2/B3 {one_launches}): iterations={res.iterations} loss={float(res.loss):.6f} wall "
        f"{wall:.4f} s; every rank alike (iterations, reason, loss, model bits): {alike}")
    for r, (o, e) in enumerate(zip(ranks, es)):
        log(f"  (e) rank {r} at {o['pos']}: wall {e['wall_s']:.3f} s, collectives data {e['collectives']['data']} "
            f"({e['collective_s']['data']:.3f} s) model {e['collectives']['model']} "
            f"({e['collective_s']['model']:.3f} s), B1-B3 {e['launches']}, B4 {e['sharded']}, sums "
            f"{e['sums']['rank_order_sum']}, S1 {e['s1']}, routes {e['routes']}, syncs {e['syncs']}, allocator peak "
            f"{e['peak_gib']:.3f} GiB")
        if (e["routes"] != {"tiled_dense": 1} or any(e["launches"].values()) or any(e["sharded"].values())
                or e["s1"] or not e["sums"]["rank_order_sum"]):
            problems.append(f"(e) rank {r} off the dense-tile path: routes {e['routes']}, B1-B3 {e['launches']}, "
                            f"B4 {e['sharded']}, S1 {e['s1']}, sums {e['sums']}")
    if not alike:
        problems.append("(e) the ranks' solves differ")
    hold(problems, "(e) dense tiles vs one card: FE coefficients", torch.from_numpy(es[0]["means"]), ref_means.cpu(),
         1e-3, 1e-5)
    hold(problems, "(e) dense tiles vs one card: FE variances", torch.from_numpy(es[0]["variances"]),
         ref_var.cpu(), 1e-3, 1e-5)
    log(f"  (e) on {smi}")
    return {"ranks": [{k: v for k, v in e.items() if k not in ("means", "variances")} for e in es],
            "one_card_wall_s": wall, "one_card_launches": one_launches, "iterations": es[0]["iterations"],
            "wall_s": max(e["wall_s"] for e in es)}


TILED_GAME_FE = GAME_FE + ",layout=tiled"  # phase 12 (b)'s fixed effect on the grid's tiles
# (f): a dense fixed effect on the userShard bag: replicated over the model
# axis, B1-B3 through B4 over each model column
TILED_DENSE_FE = ("name=user-fixed,shard=userShard,optimizer=TRON,tolerance=1e-6,max.iter=10,reg.type=L2,"
                  "reg.weights=1,variance=SIMPLE")
TILED_DRIVER_GRID = "data=2,model=2"
TILED_RESUME_GRID = "data=2,model=1"  # the refused resume: another model axis
# (d) and (f)'s runs, each on the grid and in one process: (name, the dense
# fixed effect's place against the random effect, --dtype). Both orders in
# float32 (the kernels) and in float64 (the plain versions on the card),
# where the tiled fixed effect's coefficients are held (ROADMAP C4 (e))
TILED_CASES = (("after", "after", "float32"), ("before", "before", "float32"), ("after64", "after", "float64"),
               ("before64", "before", "float64"))
TILED_FIRST_CASE = TILED_CASES[0][0]  # its checkpoint is the refused resume's


def _tiled_argv(fixture, out, extra=(), dense_at="after"):
    """Phase 12 (b)'s options with the fixed effect tiled and, (f), the
    dense fixed effect ``dense_at`` ("before" or "after") the random
    effect."""
    dense = ["--coordinate", TILED_DENSE_FE]
    argv = []
    for a in game_argv(fixture["train"], fixture["validation"], out, extra):
        if a == GAME_RE and dense_at == "before":
            argv[-1:-1] = dense  # ahead of the random effect's --coordinate
        argv.append(TILED_GAME_FE if a == GAME_FE else a)
        if a == GAME_RE and dense_at == "after":
            argv += dense
    return argv


def tiled_driver(torch, fixture, b, problems, smi):
    """(d) cli.train --distributed on the 2 x 2 grid (4 gloo ranks sharing
    the card) with phase 12 (b)'s options, the fixed effect tiled and, (f),
    a dense fixed effect (``TILED_DENSE_FE``) beside it, in each case of
    ``TILED_CASES``, every update a boundary checkpoint; beside each the
    one-process cli.train on a 1 x 1 grid. The grids start together; the one-process runs go one after
    another meanwhile. Held at phase 17 (a)'s bounds in each case (see
    ``_tiled_case_holds``). Beside those holds a resume of the first case's
    checkpoint on data=2,model=1 must be refused in the JAX package's
    words."""
    import os

    from photon_ml_tpu_torch.io.index_map import save_partitioned

    root = fixture["root"]
    index_dir = os.path.join(root, "index-18")
    maps = dict(b["maps"])
    for shard, imap in maps.items():
        save_partitioned(imap, index_dir, 1, shard)
    world, cases, started, refs = 4, {}, {}, {}
    for name, at, dtype in TILED_CASES:
        paths = {k: os.path.join(root, f"{k}-18{name}") for k in ("out", "one", "ck", "metrics", "residuals")}
        common = ["--feature-index-dir", index_dir] + (["--dtype", dtype] if dtype != "float32" else [])
        # every update a boundary checkpoint; rank 0 records the residual each
        # solve of the tiled fixed effect was handed (RANK_RUNNER)
        grid = common + ["--mesh-shape", TILED_DRIVER_GRID, "--metrics-out", paths["metrics"], "--checkpoint-dir",
                         paths["ck"], "--checkpoint-every", "1", "--checkpoint-keep", "4"]
        os.makedirs(paths["residuals"], exist_ok=True)
        env = {0: {"SMOKE_RECORD_RESIDUALS": f"global:{paths['residuals']}"}}
        cases[name] = (at, dtype, paths, common)
        started[name] = _start_ranks(root, f"train-18{name}", _tiled_argv(fixture, paths["out"], grid, at),
                                     world=world, env_by_rank=env)
    outs = {}
    try:
        for name, (at, dtype, paths, common) in cases.items():
            refs[name] = _counted_train(torch, _tiled_argv(
                fixture, paths["one"], common + ["--mesh-shape", "data=1,model=1", "--device", DIST_DEVICE], at))
    finally:
        for name, s in started.items():
            outs[name] = _wait_ranks(s)
    failed = [f for f in (_ranks_failed(o, f"(d) {name}: cli.train --distributed on the grid")
                          for name, (o, _) in outs.items()) if f]
    if failed:
        raise AssertionError("\n".join(failed))
    # the refused resume (the checkpoint carries the model axis) runs
    # beside the holds below
    first = cases[TILED_FIRST_CASE]
    resume_started = _start_ranks(root, "train-18r", _tiled_argv(fixture, os.path.join(root, "out-18r"), [
        "--feature-index-dir", index_dir, "--mesh-shape", TILED_RESUME_GRID, "--checkpoint-dir", first[2]["ck"],
        "--checkpoint-every", "1", "--resume"], first[0]))
    try:
        out_d = {name: _tiled_case_holds(torch, name, case, b, _rank_docs(root, f"train-18{name}", world=world),
                                         refs[name], max(o[3] for o in outs[name][0]) - outs[name][1], problems,
                                         smi, maps)
                 for name, case in cases.items()}
    finally:
        resume, t1 = _wait_ranks(resume_started)
    words = "checkpoint mesh reshape across the model axis is not supported"
    refused = [rc != 0 and words in err for rc, _, err, _ in resume]
    log(f"  (d) resume on {TILED_RESUME_GRID}: exit codes {[o[0] for o in resume]}, every rank refused in the JAX "
        f"package's words: {all(refused)} ({max(o[3] for o in resume) - t1:.2f} s, beside the holds)")
    if not all(refused):
        problems.append(f"(d) the resume across the model axis was not refused on every rank: {refused}")
    t_first = min(o[1] for o in outs.values())
    wall = max(max(e[3] for e in o[0]) for o in outs.values()) - t_first

    def per_rank(key):
        """Each rank's counts summed over the cases."""
        total = []
        for r in range(world):
            vals = [c[key][r] for c in out_d.values()]
            total.append(sum(vals) if isinstance(vals[0], int) else
                         {k: sum(v.get(k, 0) for v in vals) for k in vals[0]})
        return total

    log(f"  (d) the {len(cases)} grids started together: {wall:.2f} s from the first start to the last exit; "
        f"the one-process runs {sum(r[1] for r in refs.values()):.2f} s one after another meanwhile")
    return {"wall_s": wall, "one_process_s": sum(r[1] for r in refs.values()), "cases": out_d,
            **{k: per_rank(k) for k in ("s1_per_rank", "sums_per_rank", "dense_per_rank", "sharded_per_rank")}}


def _boundaries(directory):
    """Every boundary checkpoint left in ``directory``, in order: (step,
    payload)."""
    import os

    steps = sorted(int(p[5:]) for p in os.listdir(directory) if re.fullmatch(r"ckpt-\d+", p))
    return [(s, _load_boundary(directory, s)) for s in steps]


def _around(boundaries, coordinate):
    """The payloads of the boundaries before and after ``coordinate``'s
    last update."""
    k = max(i for i, (_, p) in enumerate(boundaries) if p["coordinate"] == coordinate)
    return boundaries[k - 1][1], boundaries[k][1]


def _float64_batch(batch):
    """``batch`` widened to float64 (its features in their layout, labels,
    offsets and weights): the same problem for the plain versions."""
    from photon_ml_tpu_torch.ops.features import FeatureMatrix

    f = batch.features
    if f.is_dense:
        feats = FeatureMatrix(dim=f.dim, dense=f.dense.double())
    elif f.layout == "coo":
        feats = FeatureMatrix(dim=f.dim, coo_cols=f.coo_cols, coo_rows=f.coo_rows, coo_vals=f.coo_vals.double(),
                              coo_n_rows=f.coo_n_rows)
    else:
        feats = FeatureMatrix(dim=f.dim, idx=f.idx, val=f.val.double())
    return dataclasses.replace(batch, features=feats, labels=batch.labels.double(),
                               offsets=batch.offsets.double(), weights=batch.weights.double())


def _float64_coordinate(coord):
    """A fixed-effect coordinate on its batch and normalization widened to
    float64 (the same problem, for the plain versions)."""
    norm = coord.normalization
    if norm is not None:
        wide = lambda t: None if t is None else t.double()  # noqa: E731
        norm = dataclasses.replace(norm, factors=wide(norm.factors), shifts=wide(norm.shifts))
    dataset = dataclasses.replace(coord.dataset, batch=_float64_batch(coord.dataset.batch))
    return dataclasses.replace(coord, dataset=dataset, normalization=norm)


def _tiled_case_holds(torch, name, case, b, docs, ref, wall, problems, smi, maps):
    """(d) and (f)'s holds of one case's grid run against its one process:
    the dense fixed effect's means and both fixed effects' SIMPLE variances
    rtol 1e-3 / atol 1e-5; validation AUC within 1e-4; the saved tiled
    fixed effect of the shard's true dimension; every rank's best model the
    same digest; in float32 every rank on the tiled kernel route (S1 and the
    rank-order sum) and the dense kernel route (B1-B3 through B4), in
    float64 on the plain versions. The tiled fixed effect (ROADMAP C4 (e)):
    in float64 its chained means against the one process, and its last
    update against phase 12 (b)'s global coordinate (one card, widened to
    float64) retrained from the boundary before it on the very residual the
    grid's rank 0 handed that solve, both at rtol 1e-3 / atol 1e-5; in
    float32 the same gaps printed (the one-card update in float32 and in
    float64; beside them the residual rebuilt from the boundary, its summed
    scores less one card's scores of the model, and the update on it; both
    solves' loss histories). In float32 also the random effect's last update
    retrained on one card from the boundary before it (atol 5e-3,
    per-entity loss atol 1e-4)."""
    import glob
    import os

    from photon_ml_tpu_torch.game.coordinate import _project_model_values
    from photon_ml_tpu_torch.io import load_game_model

    at, dtype, paths, _ = case
    f64 = dtype == "float64"
    tag = f"(d) {name} ({dtype}, the dense fixed effect {at} the random effect)"
    ref_summary, ref_wall, ref_launches = ref[0], ref[1], ref[2]
    with open(os.path.join(paths["metrics"], "run_summary.json")) as f:
        auc = json.load(f)["best"]["metrics"]["AUC"]
    ref_auc = ref_summary["best"]["metrics"]["AUC"]
    for r, d in enumerate(docs):
        s1 = {k: v for k, v in d["sparse"].items() if v}
        routes = {k: v for k, v in d["routes"].items() if v}
        log(f"  {tag} rank {r}: wall {d['wall_s']:.2f} s (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in d["stage_seconds"].items())
            + f"); S1 {s1}, rank-order sums {d['sums']['rank_order_sum']}, (f) B1-B3 {d['launches']} (with shifts "
              f"{d['shifts']['fused_hessian_stats']}), B4 {d['sharded']}, routes {routes}")
        if f64:
            if set(routes) != {"plain_float64"}:
                problems.append(f"{tag} rank {r} off the plain float64 route: {routes}")
        elif (not s1.get("coo_matvec") or not s1.get("coo_rmatvec") or not d["sums"]["rank_order_sum"]
                or set(routes) != {"tiled_kernel", "dense_kernel"} or not all(d["launches"].values())
                or not all(d["sharded"].values())):
            problems.append(f"{tag} rank {r} ran off the tiled kernel path and B1-B4: S1 {s1}, sums {d['sums']}, "
                            f"B1-B3 {d['launches']}, B4 {d['sharded']}, routes {routes}")
    digests = [d["model_sha256"] for d in docs]
    log(f"  {tag}: 4 ranks on a 2 x 2 grid {wall:.2f} s from their start to the last exit; one process on a 1 x 1 "
        f"grid {ref_wall:.2f} s (B1-B3 {ref_launches}); validation AUC {auc:.6f} against {ref_auc:.6f}; (f) best "
        f"models' digests: grid {digests}, one process {ref_summary['best']['model_sha256']} on {smi}")
    if len(set(digests)) != 1:
        problems.append(f"{tag}: the grid's ranks saved different best models: {digests}")
    if abs(auc - ref_auc) > 1e-4:
        problems.append(f"{tag}: validation AUC {auc:.6f} against the one process's {ref_auc:.6f} (1e-4)")
    load = dict(task="logistic_regression", device=DIST_DEVICE, dtype=torch.float64 if f64 else torch.float32)
    best = load_game_model(os.path.join(paths["out"], "models", "best"), maps, **load)
    one = load_game_model(os.path.join(paths["one"], "models", "best"), maps, **load)
    fa, fb = best["global"].model.coefficients, one["global"].model.coefficients
    d_true = maps["global"].size
    log(f"  {tag}: the saved fixed effects: {fa.means.shape[0]} and {fb.means.shape[0]} coefficients (the shard's "
        f"{d_true})")
    if fa.means.shape[0] != d_true or fb.means.shape[0] != d_true:
        problems.append(f"{tag}: saved fixed effects of {fa.means.shape[0]} / {fb.means.shape[0]}, not {d_true}")
    if f64:
        hold(problems, f"{tag} grid vs one process: FE coefficients", fa.means, fb.means, 1e-3, 1e-5)
    else:
        log(f"  {tag} grid vs one process: FE coefficients chained (printed; held in float64): max abs diff "
            f"{float((fa.means.double() - fb.means.double()).abs().max()):.3e}")
    hold(problems, f"{tag} grid vs one process: FE variances", fa.variances, fb.variances, 1e-3, 1e-5)
    ua, ub = best["user-fixed"].model.coefficients, one["user-fixed"].model.coefficients
    hold(problems, f"{tag} grid vs one process: dense FE coefficients", ua.means, ub.means, 1e-3, 1e-5)
    hold(problems, f"{tag} grid vs one process: dense FE variances", ua.variances, ub.variances, 1e-3, 1e-5)
    counts = {"s1_per_rank": [d["sparse"] for d in docs], "sums_per_rank": [d["sums"]["rank_order_sum"] for d in docs],
              "dense_per_rank": [d["launches"] for d in docs], "sharded_per_rank": [d["sharded"] for d in docs]}
    out = {"wall_s": wall, "one_process_s": ref_wall, "auc": auc, "one_process_auc": ref_auc, "digests": digests,
           "one_process_digest": ref_summary["best"]["model_sha256"], **counts}

    bounds = _boundaries(os.path.join(paths["ck"], "cd-boundaries"))
    log(f"  {tag}: the boundaries kept (step: sweep, coordinate): "
        + ", ".join(f"{s}: {p['iteration']}, {p['coordinate']}" for s, p in bounds))
    re_coord = b["coords"]["per-user"]
    dev = re_coord.dataset.device
    if not f64:
        def on_card(m):
            return dataclasses.replace(m, coef_indices=m.coef_indices.to(dev), coef_values=m.coef_values.to(dev))

        # the random effect on identical residuals, as phase 17 (a) holds it
        state, last = _around(bounds, "per-user")
        re1 = on_card(state["models"]["per-user"])
        residual = state["summed_scores"].to(dev) - re_coord.score(re1)
        re_one, _ = re_coord.train(residual, initial_model=re1)
        two = on_card(last["models"]["per-user"])
        hold(problems, f"{tag} grid vs one card: RE coefficients (identical residuals)",
             _project_model_values(re_coord.dataset, two, two.coef_values, torch.float32), re_one.coef_values, 0.0,
             5e-3)
        l2 = float(re_coord.config.reg_weight)
        hold(problems, f"{tag} grid vs one card: RE per-entity loss (identical residuals)",
             _re_losses(torch, re_coord, two, residual, l2), _re_losses(torch, re_coord, re_one, residual, l2), 0.0,
             1e-4)
    # the tiled fixed effect's last update from the boundary before it, on
    # the residual the grid's rank 0 handed that solve (its last recording)
    fe32 = b["coords"]["global"]
    fe64 = _float64_coordinate(fe32)
    before_fe, after_fe = _around(bounds, "global")
    g0 = before_fe["models"]["global"]
    recorded = sorted(glob.glob(os.path.join(paths["residuals"], "global-*.npy")),
                      key=lambda p: int(p.rsplit("-", 1)[1][:-4]))
    if not recorded:
        problems.append(f"{tag}: rank 0 recorded no residual of the tiled fixed effect")
        return out
    with open(recorded[-1][:-4] + ".json") as f:
        grid_solve = json.load(f)
    r_grid = torch.from_numpy(np.load(recorded[-1])).to(dev)
    grid_means = after_fe["models"]["global"].model.coefficients.means.to(dev)
    one64, res64 = fe64.train(r_grid.double(), initial_model=g0)
    m64 = one64.model.coefficients.means
    # a solve's accepted losses, from its NaN-padded history
    fmt = lambda h: "/".join(f"{x:.6f}" for x in h if x == x)  # noqa: E731
    if f64:
        hold(problems, f"{tag} grid vs one card: FE coefficients (the grid's residual)", grid_means, m64, 1e-3, 1e-5)
        log(f"  {tag}: the update's solves (iterations, reason, losses): grid {grid_solve['iterations']}, "
            f"{grid_solve['reason']}, {fmt(grid_solve['losses'])}; one card {int(res64.iterations)}, "
            f"{int(res64.reason)}, {fmt(res64.loss_history.tolist())}")
        return out
    r_rebuilt = before_fe["summed_scores"].to(dev) - fe32.score(g0)
    one32, res32 = fe32.train(r_grid, initial_model=g0)
    rebuilt32, res_re = fe32.train(r_rebuilt, initial_model=g0)
    m32, m_re = one32.model.coefficients.means, rebuilt32.model.coefficients.means
    gap = lambda a, c: float((a.double() - c.double()).abs().max())  # noqa: E731
    log(f"  {tag} grid vs one card: FE coefficients on the grid's residual (printed; held in float64): float32 "
        f"{gap(grid_means, m32):.3e}; from one card's float64 update: the grid's {gap(grid_means, m64):.3e}, one "
        f"card's float32 {gap(m32, m64):.3e}; the solves (iterations, reason, losses): grid "
        f"{grid_solve['iterations']}, {grid_solve['reason']}, {fmt(grid_solve['losses'])}; one card "
        f"{int(res32.iterations)}, {int(res32.reason)}, {fmt(res32.loss_history.tolist())}; "
        f"float64 {int(res64.iterations)}, {int(res64.reason)}, "
        f"{fmt(res64.loss_history.tolist())}")
    log(f"  {tag}: the grid's residual ({len(recorded)} recorded) against the one rebuilt from the boundary (summed "
        f"scores less one card's scores of its model): max abs diff {float((r_grid - r_rebuilt).abs().max()):.3e}; "
        f"one card's float32 updates on the two {gap(m32, m_re):.3e} apart (iterations {int(res_re.iterations)}, "
        f"reason {int(res_re.reason)})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--users", type=int, default=20_000)
    ap.add_argument("--d-re", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prev-segment-source", default=None,
                    help="an earlier csrc/sparse_glm.cu to time in turns with this one in phase 8 (S1 and S2)")
    ap.add_argument("--only", default="",
                    help="comma-separated subset of check,fe,glmix,dp,nccl,solvers,io,game,streaming,tuning,s2,"
                         "sparse,timing,variants,retrain,serving,distributed,tiled "
                         "to run after card and build (for iterating on one phase; the result is then not ok)")
    args = ap.parse_args()
    only = set(filter(None, args.only.split(",")))
    want = lambda phase: not only or phase in only  # noqa: E731

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import photon_ml_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    phases = Phases()
    smi = phases.run("card", card, torch)
    if want("io") or any(want(k) for k in ("game", "streaming", "tuning", "retrain", "distributed", "tiled")):
        # the fixtures' writers start beside the build
        warm_writer_pool()
        log("  the fixtures' writer processes start beside the build (cut to make room for phase 18)")
    phases.run("build", build)
    import shutil
    import tempfile

    # phase 12's metrics directories, kept for phase 15's cli.fleetz
    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    errs = fe_launches = glmix = dp = times = solvers = io = game = streaming = tuning = retrain = served = None
    dist = tiled = None
    if want("check"):
        errs = phases.run("kernels vs float64 plain", check_kernels, torch, args.n, args.d, args.seed)
    if want("fe"):
        fe_launches = phases.run("fixed-effect path", fe_path, torch, args.n, args.d, args.seed)
    if (want("glmix") or want("dp") or want("nccl") or want("solvers") or want("io") or want("game")
            or want("streaming") or want("tuning")):
        glmix = phases.run(
            "GLMix sweep (main path)", glmix_path, torch, args.n, args.d, args.users, args.d_re, args.seed
        )
    state = (glmix or {}).pop("state", None)
    if not (want("dp") or want("nccl")):
        pass
    elif state is None:
        log("== phase: data-parallel GLMix sweep needs the one-card sweep's results")
        phases.failed.append("data-parallel GLMix sweep")
    else:
        dp = phases.run(
            "data-parallel GLMix sweep", dp_path, torch, args.n, args.d, args.seed, state, "cuda", want("dp")
        )
    if not want("solvers"):
        pass
    elif state is None:
        log("== phase: solvers needs the one-card sweep's results")
        phases.failed.append("solvers")
    else:
        torch.cuda.empty_cache()
        solvers = phases.run("solvers", solvers_phase, torch, state, args.seed, smi)
    torch.cuda.empty_cache()
    if not want("io"):
        pass
    elif state is None:
        log("== phase: data and model IO needs the one-card sweep's results")
        phases.failed.append("data and model IO")
    else:
        io = phases.run("data and model IO", io_phase, torch, state, args.seed, smi)
    if not (want("tuning") or want("streaming") or want("tiled")):
        state = None
    torch.cuda.empty_cache()
    if (want("game") or want("streaming") or want("tuning") or want("retrain") or want("distributed")
            or want("tiled")):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_game_") as root:
            fixture = phases.run("GAME fixture (phase 12 (a))", game_fixture, root, args.seed)
            close_writer_pool()
            if fixture is None:
                phases.failed += [p for p, key in (("GAME driver", "game"), ("tuning", "tuning"),
                                                   ("retrain chain", "retrain"), ("distributed", "distributed"))
                                  if want(key)]
            else:
                if want("game"):
                    game = phases.run("GAME driver", game_phase, torch, fixture, smi,
                                      (glmix or {}).get("busy_share"), keep)
                elif want("streaming") or want("distributed") or want("tiled"):
                    game = phases.run("GAME driver (phase 12 (b))", game_b_only, torch, fixture, smi)
                torch.cuda.empty_cache()
                if not want("streaming"):
                    pass
                elif state is None:
                    log("== phase: out-of-core training needs the one-card sweep's results")
                    phases.failed.append("out-of-core training")
                else:
                    # before phase 17: its (g) holds its models against (e)'s
                    streaming = phases.run("out-of-core training", streaming_phase, torch, state, fixture, game,
                                           args.seed, smi)
                torch.cuda.empty_cache()
                if not want("distributed"):
                    pass
                elif not (game or {}).get("b"):
                    log("== phase: distributed needs phase 12 (b)'s model")
                    phases.failed.append("distributed")
                else:
                    dist = phases.run("distributed", distributed_phase, torch, fixture, game, smi,
                                      (streaming or {}).get("cli"))
                if want("tiled"):
                    torch.cuda.empty_cache()
                    # (e) on phase 5's X, or on build_data's without phase 5
                    fe_xy = tuple(state["data"][:2]) if state else None
                    tiled = phases.run("tiled fixed effect", tiled_phase, torch, args.seed, smi, fixture, game,
                                       "cuda", None, fe_xy, (args.n, args.d, args.users, args.d_re, args.seed))
                    fe_xy = None
                (game or {}).pop("b", None)
                torch.cuda.empty_cache()
                if not want("tuning"):
                    pass
                elif state is None:
                    log("== phase: tuning needs the one-card sweep's results")
                    phases.failed.append("tuning")
                else:
                    tuning = phases.run("tuning", tuning_phase, torch, fixture, state, args.seed, smi)
                state = None
                torch.cuda.empty_cache()
                if want("retrain"):
                    retrain = phases.run("retrain chain", retrain_phase, torch, fixture, smi)
        state = None
    torch.cuda.empty_cache()
    if want("serving"):
        served = phases.run("serving", serving_phase, torch, args.seed, smi, keep)
        torch.cuda.empty_cache()
    if want("s2") and not want("tuning"):
        tuning = phases.run("S2 (phase 13 (a))", s2_phase, torch, args.seed)
        torch.cuda.empty_cache()
    sp = None
    if want("sparse"):
        sp = phases.run("sparse fixed effects", sparse_phase, torch, args.seed, args.users, args.d_re)
    batches = (sp or {}).get("path", {}).pop("batches", None)
    if want("timing"):
        times = phases.run("timing", timings, torch, args.n, args.d, args.seed)
        sparse_times = phases.run("timing (segment kernel)", time_sparse, torch, args.seed, batches)
        if times is not None:
            times["sparse"] = sparse_times or {}
    torch.cuda.empty_cache()
    # phase 8's diagnostic builds (wrong sums by design; they check nothing
    # of the main path) run when asked for: a whole run leaves them out, so
    # that a slow host (one whole run saw the GLMix sweep at 0.54x its
    # usual rate) does not push the script past its limit
    variants = "variants" in only
    if not only:
        log("== phases segment kernel variants and ring variants: left out of a whole run (--only variants)")
    if variants:
        phases.run("segment kernel variants", segment_variants, torch, args.seed, batches, args.prev_segment_source)
    del batches
    torch.cuda.empty_cache()
    if variants:
        phases.run("ring variants", ring_variants, torch, args.n, args.d, args.seed)
    shutil.rmtree(keep, ignore_errors=True)
    if only:
        phases.failed.append(f"only {sorted(only)} ran")

    if glmix:
        log(f"GLMix sweep: {args.n / glmix['wall_s']:.1f} examples/s (median wall {glmix['wall_s']:.4f} s "
            f"of {min(glmix['walls']):.4f}-{max(glmix['walls']):.4f}, "
            f"FE share {glmix['fe_share']:.3f}, RE share {glmix['re_share']:.3f}, "
            f"syncs {glmix['syncs']}, train AUC {glmix['train_auc']:.6f}) on {smi}")
    if dp:
        sw = dp.get("sweep")
        if sw:
            log(f"data-parallel GLMix sweep (backend gloo, world {DP_RANKS}, one card): "
                f"{sw['examples_per_s']:.1f} examples/s (median wall {sw['wall_s']:.4f} s, "
                f"FE share {sw['fe_share']:.3f}, RE share {sw['re_share']:.3f}, RE walls per rank "
                f"{', '.join(f'{w:.4f}' for w in sw['re_walls'])} s, syncs {sw['syncs']}, "
                f"collectives {sw['collectives']})")
        log(f"data-parallel GLMix sweep over nccl, world {dp['nccl']['world']}: "
            f"median wall {dp['nccl']['wall_s']:.4f} s against one card's {dp['nccl']['one_card_wall_s']:.4f} s, "
            f"B4 value+grad {dp['nccl']['b4']['sharded_value_grad']['ms']:.4f} ms/call (the all-reduce path "
            f"{dp['nccl']['b4']['sharded_value_grad']['prev_ms']:.4f}), host synchronizes in B4 "
            f"{dp['nccl']['host_syncs']}; on {smi}")
    launches = (glmix or {}).get("launches", {})
    kernels = []
    for name in KERNELS:
        if name in B4_OF:
            kernels.append(b4_entry(name, args.n, args.d, dp, times))
            continue
        if name == "rank_order_sum":
            kernels.append(sum_entry(dp, times, errs))
            continue
        t = (times or {}).get("float32", {}).get(name, {})
        t16 = (times or {}).get("bfloat16", {}).get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches.get(name, 0),
            "launches_fixed_effect_path": (fe_launches or {}).get(name, 0),
            "launches_full_variance_sweep": ((solvers or {}).get("sweep") or {}).get("launches", {}).get(name, 0),
            "launches_glm_driver": ((io or {}).get("driver") or {}).get("launches", {}).get(name, 0),
            "launches_glm_driver_with_shifts": ((io or {}).get("driver") or {}).get("shift_launches", 0)
            if name == "fused_hessian_stats" else None,
            "launches_game_driver": ((game or {}).get("train") or {}).get("launches", {}).get(name, 0),
            "launches_game_driver_with_shifts": ((game or {}).get("train") or {}).get("shift_launches", 0)
            if name == "fused_hessian_stats" else None,
            "launches_retrain_chain_per_day": [d[name] for d in ((retrain or {}).get("chain") or {}).get(
                "launches", [])],
            "launches_retrain_chain_per_day_with_shifts": [
                d["fused_hessian_stats_with_shifts"] for d in ((retrain or {}).get("chain") or {}).get("launches", [])
            ] if name == "fused_hessian_stats" else None,
            "launches_data_parallel_per_rank": [
                r[name] for r in ((dp or {}).get("sweep") or {}).get("launches", [])
            ],
            "max_abs_err": (errs or {}).get(name),
            "ms": t.get("ms"), "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "library_ms": None, "dtype": "float32",
            "design": DESIGN[name], "route_launches": {
                k: v for k, v in ((glmix or {}).get("routes") or {}).items() if v
            } if name != "fused_hessian_stats" else None,
            "prev_ms": t.get("prev_ms"), "main_ms": t.get("main_ms"),
            "finalize_ms": t.get("finalize_ms"), "prev_finalize_ms": t.get("prev_finalize_ms"),
            "read_x_ms": t.get("read_x_ms"), "plan": t.get("plan"),
            **{f"bf16_{k}": t16.get(k) for k in ("ms", "prev_ms", "finalize_ms", "read_x_ms", "bound_ms")},
        })
    kernels += sparse_entries(sp, times, game, retrain, served)
    kernels += s2_entries(tuning)
    kernels.append(lane_entry(errs, solvers))
    # phase 17 (a): each rank's launches in the two-rank fit (B1-B3, B3
    # with shifts, B4, the rank-order sum); (e): the one NCCL rank's
    dist_ranks = ((dist or {}).get("train") or {}).get("ranks") or []
    nccl_one = (dist or {}).get("nccl") or {}
    for entry in kernels:
        name = entry["name"]
        if name in KERNELS:
            table = "sharded" if name in B4_OF else "sums" if name == "rank_order_sum" else "launches"
            entry["launches_distributed_per_rank"] = [d[table].get(name, 0) for d in dist_ranks]
            entry["launches_nccl_world_1"] = nccl_one.get(table, {}).get(name)
    # phase 17 (f): each rank's launches in the two-rank streamed fit (B1,
    # B2, the rank-order sum over both ranks' slot rows, S1)
    stream_ranks = ((dist or {}).get("stream") or {}).get("launches") or []
    for entry in kernels:
        key = entry["name"].split(":", 1)[-1]
        if stream_ranks and key in ("fused_value_grad", "fused_hessian_vector", "rank_order_sum", "ell_matvec"):
            entry["launches_streamed_per_rank"] = [r[key] for r in stream_ranks]
    # the streamed paths of phase 16: their launches join each kernel's
    st_launches = streamed_launches(streaming)
    for entry in kernels:
        key = entry["name"].split(":", 1)[-1]
        if key in st_launches:
            entry["launches_streamed"] = st_launches[key]
            entry["launches"] = (entry.get("launches") or 0) + st_launches[key]
    # phase 18: each rank's launches on the 2 x 2 grid, (a)-(f), join S1's
    # COO products, the rank-order sum and, from (f)'s dense fixed effect
    # over each model column, B1-B3 and B4
    tl = (tiled or {}).get("launches") or {}
    for entry in kernels:
        key = entry["name"].split(":", 1)[-1]
        per_rank = None
        if entry["name"].startswith("segment_dot:coo_") and tl:
            per_rank = [r.get(key, 0) for r in tl["s1_per_rank"]]
            # on the grid S1 replaces the tiled products' XLA gathers too
            entry["replaces_tiled"] = "photon_ml_tpu/parallel/sparse.py:" + ("87" if key == "coo_matvec" else "109")
        elif key == "rank_order_sum" and tl:
            per_rank = tl["sums_per_rank"]
        elif key in B4_OF and tl:
            per_rank = [r.get(key, 0) for r in tl["sharded_per_rank"]]
        elif key in B4_OF.values() and tl:
            per_rank = [r.get(key, 0) for r in tl["dense_per_rank"]]
        if per_rank is not None:
            entry["launches_tiled_per_rank"] = per_rank
            entry["launches"] = (entry.get("launches") or 0) + sum(per_rank)
    if sp:
        path, sg = sp["path"], sp["glmix"]
        log(f"sparse fixed effect (n={SPARSE_N}, d={SPARSE_D}, k={SPARSE_K}, L-BFGS at most {SPARSE_ITERS} "
            f"iterations, ran {path['coo']['iterations']} (COO) and {path['ell']['iterations']} (ELL)): "
            f"COO {path['coo']['examples_iters_per_s']:.1f} and ELL {path['ell']['examples_iters_per_s']:.1f} "
            f"examples*iterations/s; OWL-QN (L1 1.0) nonzeros {path['owlqn']['nonzeros']}; sparse GLMix sweep "
            f"(n={SPARSE_GLMIX_N}, ELL) {sg['examples_per_s']:.1f} examples/s (median wall {sg['wall_s']:.4f} s, "
            f"FE share {sg['fe_share']:.3f}, RE share {sg['re_share']:.3f}) on {smi}")
    if solvers:
        sw, bl, ce = solvers["sweep"], solvers["billion"], solvers["ceiling"]
        log(f"solvers: FULL + TRON GLMix sweep {sw['examples_per_s']:.1f} examples/s (median wall "
            f"{sw['wall_s']:.4f} s, FE share {sw['fe_share']:.3f}, RE share {sw['re_share']:.3f}; RE syncs per "
            f"bucket TRON {sw['re_syncs_per_bucket']:.1f}, L-BFGS {sw['lbfgs_re_syncs_per_bucket']:.1f}); FULL at "
            f"d={args.d}: Hessian {sw['hessian_s']:.4f} s, inverse {sw['inverse_s']:.4f} s; billion slice "
            + "; ".join(f"{o} packed {bl[o]['packed_s']:.3f} s vmapped {bl[o]['vmapped_s']:.3f} s prefix "
                        f"{'bitwise' if bl[o]['prefix_bitwise'] else 'differs'}" for o in ("LBFGS", "TRON"))
            + "; compute_variances FULL " + ", ".join(
                f"d={v['d']} {v['dtype']} {v['seconds']:.3f} s, {v['call_peak_gib']:.2f} GiB above what was held"
                for v in ce.values()) + f" on {smi}")
    if io:
        rd, dr, gm = io["read"], io.get("driver") or {}, io["game_model"]
        log(f"data and model IO: write {io['write']['rows_per_s']:.1f} rows/s; read "
            + ", ".join(f"{k} {v['rows_per_s']:.1f} rows/s" for k, v in rd.items())
            + f"; cli.glm {dr.get('wall_s', float('nan')):.2f} s (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in (dr.get("stage_seconds") or {}).items())
            + f"); GLMix model save {gm['save_s']:.2f} s, load {gm['load_s']:.2f} s on {smi}")
    if game and "resume" in game:
        tr, rs, sc = game["train"], game["resume"], game["score"]
        log(f"GAME driver: cli.train {tr['wall_s']:.2f} s (stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in tr["stage_seconds"].items())
            + f"), {int(tr['checkpoint_saves'])} boundary checkpoints ({int(tr['checkpoint_bytes'])} bytes, "
              f"{tr['checkpoint_seconds']:.3f} s), validation AUC {tr['auc']:.6f}; killed and resumed "
              f"{rs['killed_s']:.2f} + {rs['wall_s']:.2f} s; cli.score {sc['rows_per_s']:.1f} rows/s "
              f"(engine {sc['engine_s']:.3f} s); every telemetry flag on {game['observed']['wall_s']:.2f} s, "
              f"the report built in {game['observed']['report_build_s']:.3f} s on {smi}")
    if tuning and "sweep" in tuning:
        sw, dr, rs = tuning["sweep"], tuning["driver"], tuning["resume"]
        log("tuning: lane sweeps " + ", ".join(
            f"K={K} {sw[K]['wall_s']:.3f} s against {sw[K]['sequential_s']:.3f} s sequential" for K in SWEEP_LANES)
            + f"; cli.train RANDOM --trial-lanes {TUNING_LANES} "
              f"({TUNING_LANE_TRIALS} trials) {dr['lanes']['wall_s']:.2f} s ({dr['lanes']['batches']} batches, "
              f"{dr['lanes']['batch_seconds']:.3f} s); killed and resumed {rs['killed_s']:.2f} + {rs['wall_s']:.2f} s "
              f"on {smi}")
    if retrain:
        ch, dr = retrain["chain"], retrain["drills"]
        log(f"retrain chain: cli.retrain {ch['wall_s']:.2f} s for 3 days (day walls "
            + ", ".join(f"{d} {v['day']:.2f}" for d, v in ch["day_seconds"].items())
            + f" s), launches per day {ch['launches']}; the label-flipped day {retrain['degraded']['reason']}; "
              f"killed and resumed {dr['killed_s']:.2f} + {dr['resumed_s']:.2f} s on {smi}")
    if served:
        cl, kn, rp = served["closed_loop"], served["knee"], served["replicas"]
        log(f"serving: {cl['scores_per_s']:.1f} scores/s ({SERVING_CLIENTS} closed-loop clients, p50 "
            f"{cl['p50_s'] * 1e3:.3f} ms, p99 {cl['p99_s'] * 1e3:.3f} ms, mean batch {cl['mean_batch']:.2f}); one "
            f"request at a time {served['engine']['one_request_per_s']:.1f} scores/s; live flip with "
            f"{cl['failed']} failed; knee {kn['knee_qps']:.0f} qps (p99 {kn['knee_p99_s'] * 1e3:.3f} ms); replica "
            f"kill through the front: {rp['completed']} answered, {rp['shed']} shed, {rp['lost']} lost on {smi}")
    if streaming:
        a, b, c, d = (streaming.get(k) or {} for k in ("objective", "solves", "random_effect", "pipeline"))
        log(f"out-of-core training: {a.get('n_slices')} slices of {a.get('step')} rows, value+grad pass "
            f"{a.get('pass_ms', float('nan')):.3f} ms ({a.get('achieved_gbps', float('nan')):.2f} GB/s of a pinned "
            f"copy_'s {a.get('pinned_copy_gbps', float('nan')):.2f}); streamed TRON "
            f"{(b.get('depth1') or {}).get('wall_s', float('nan')):.3f} s (depth 2 "
            f"{(b.get('depth2') or {}).get('wall_s', float('nan')):.3f} s, overlap "
            f"{((b.get('depth2') or {}).get('metrics') or {}).get('overlap_ratio', float('nan')):.3f}) against "
            f"resident {b.get('resident_s', float('nan')):.3f} s; streamed RE vmapped "
            f"{(c.get('vmapped') or {}).get('streamed_s', float('nan')):.3f} s, packed "
            f"{(c.get('packed') or {}).get('streamed_s', float('nan')):.3f} s; two-sweep fit depth 1 "
            f"{d.get('depth1_s', float('nan')):.3f} s, depth 2 {d.get('depth2_s', float('nan')):.3f} s; streamed "
            f"launches {st_launches} on {smi}")
    if dist:
        a, dr, sc = dist["train"], dist["drill"], dist["score"]
        log(f"distributed: two gloo ranks sharing the card, cli.train {a['wall_s']:.2f} s (validation AUC "
            f"{a['auc']:.6f}); the kill-a-worker drill detected in {dr.get('detect_s', float('nan')):.2f} s, resumed "
            f"in {dr.get('resume_s', float('nan')):.2f} s with {dr.get('differing_bits')} differing bits; "
            f"cli.score --distributed {sc['wall_s']:.2f} s ({sc['bitwise_rows']} of {sc['rows']} rows bitwise); "
            f"one NCCL rank {dist['nccl']['wall_s']:.2f} s with {dist['nccl']['differing_bits']} differing bits; "
            f"streamed over two ranks {dist['stream']['wall_s']:.2f} s (validation AUC {dist['stream']['auc']:.6f}, "
            f"launches per rank {[{k: r[k] for k in ('fused_value_grad', 'fused_hessian_vector', 'rank_order_sum')} for r in dist['stream']['launches']]}), "
            f"streamed on one NCCL rank {dist['stream_nccl']['wall_s']:.2f} s with "
            f"{dist['stream_nccl']['differing_bits']} differing bits from phase 16 (e)'s on {smi}")
    if tiled:
        b, c, d, e = tiled["b"], tiled["c"], tiled.get("d") or {}, tiled.get("e") or {}
        log(f"tiled fixed effect on a 2 x 2 grid of gloo ranks sharing the card: the L-BFGS solve "
            f"{max(r['wall_s'] for r in b['ranks']):.3f} s ({b['iterations']} iterations; one card's COO solve "
            f"{b['one_card_wall_s']:.4f} s), FULL on tiles at d=8,191 {c['wall_s']:.2f} s, the dense feature-axis "
            f"shard's TRON solve {e.get('wall_s', float('nan')):.3f} s ({e.get('iterations')} iterations; one "
            f"card's {e.get('one_card_wall_s', float('nan')):.4f} s), cli.train on the grid with the dense fixed "
            f"effect beside {d.get('wall_s', float('nan')):.2f} s (one process "
            f"{d.get('one_process_s', float('nan')):.2f} s); launches per rank S1 {tl.get('s1_per_rank')}, sums "
            f"{tl.get('sums_per_rank')}, B1-B3 {tl.get('dense_per_rank')}, B4 {tl.get('sharded_per_rank')} on {smi}")
    log(f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    ok = not phases.failed
    if not ok:
        log(f"failed phases: {phases.failed}")
    print(json.dumps({
        "ok": ok,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
