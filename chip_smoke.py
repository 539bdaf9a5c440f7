#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. Print the card (``nvidia-smi`` name and power limit), the PyTorch and CUDA
   versions; build the CUDA kernels from ``metrics_tpu_torch/csrc`` with
   ``nvcc`` and print the build time and the compiler's resource report.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   tensors, at the main-path shapes and at ragged ones: exact equality, but
   for float sums of the segment scatter (B3), which add in an order that
   changes from run to run: within rtol=atol=1e-5 (a few float32 ulps of
   sums of a few terms), and run twice to print the run-to-run difference.
   B5's histograms must also equal the plain version run on the CPU (the
   plain version on the card divides by a device tensor, never by a Python
   scalar, whose CUDA division multiplies by the reciprocal), including at
   every bin edge and its float32 neighbours, and for NaN, +-inf and
   subnormal scores; at ragged last tiles (C = 7, 1001), one row, scores
   that start 4 and 8 bytes into their buffer, many chunks times tiles
   ((100000, 10)), a grid too wide for shared memory (B = 65536), all-equal
   scores, and with the labels as one class id per row (int32 and int64,
   ids outside [0, C) among them) against the one-hot of the ids.
   The segment scatters (B3, B4) are held at every
   vector width B3 takes (D = 40, 8, 6, 4, 2, 1 at the keyed path's shapes,
   and ragged shapes), each with int64 and int32 ids and with rows 16-, 4-
   and 8-byte aligned (views that start one or two floats into a buffer).
   B5's batched entry (``hist_batched_parity``) is held the same way, one
   launch a stack, at the keyed binary rows' (4096, 1, 1), the keyed
   10-class rows' (4096, 1, 10) and a bootstrap's (20, 1024, 1000) stacks,
   at C = 7, 65,536 slices (a last z group of one), slices of no row,
   ragged tiles, scores 4 bytes into their buffer, dense labels and int32 and
   int64 class ids (some outside [0, C)), every bin edge, the global mode,
   and outputs past 2^31 cells in the store mode ((131,200, 1, 8)) and the
   global mode ((66,000, 1, 1) at B = 32,768).
2b. Each kernel's wrapper captured once into a CUDA graph
   (``capture_error_mode="thread_local"``, as the compiled step captures) at
   its path's shape and replayed twice on fresh inputs, each replay equal
   to the plain version (B3's float sums within rtol = atol = 1e-5): B1, B2,
   B3, B4 max, B5 with class ids and B5's add mode (the binary stream's
   shape), the cooperative launches among them, and B5's batched entry at
   the keyed binary rows' stack.
3. The first path: ImageNet-1k evaluation (1000 classes, the 50,000-image
   validation split in batches of 1024 float32 softmax rows, 49 ``forward``
   calls, then ``compute()``) through
   ``MetricCollection({Accuracy, macro Precision/Recall/F1/Specificity,
   ConfusionMatrix, IoU, CohenKappa, MatthewsCorrcoef})`` on the card. Each
   kernel must have launched exactly once per batch (the macro members share
   one B1 update, the confusion-matrix members one B2 update), and
   the results must equal the same collection run on the CPU over the same
   batches (counts exactly, float metrics within 1e-6).
   The per-``forward`` time of the collection, and under the profiler the
   device's busy share of ten forwards with the kernels that fill it.
3b. The keyed path, the serving entry point: ``MultiTenantCollection({Accuracy,
   macro Precision/Recall/F1})`` over 10,000 tenants, ten classes, on the
   card, ``validate_ids=False``; 50 ``update`` calls of 4096-row mixed
   batches (float32 softmax rows, int64 targets, tenant ids uniform in
   [0, 10000); the last batch holds 3000 real rows padded with id -1 and
   zero rows), then ``compute()``. The merge must launch once per update
   (50, both bundles' eleven leaves), B3 and B4 never, B1 once per update (50: the macro
   bundle's (4096, 1, 10) stack of rows, in its short-slice layout), B2
   never; every multiclass row
   has one true class, so the Accuracy bundle's tp + fn over all tenants
   must count the real rows; the stacked states must equal the same
   collection's on the CPU exactly, the per-tenant values within 1e-6.
   The per-``update`` time, the ``compute()`` time, and the device's busy
   share of ten updates under the profiler.
3c. The sketched curve path: the same 49 ImageNet-1k batches through
   ``MetricCollection({AUROC, AveragePrecision})`` with ``num_classes=1000,
   sketched=True`` (2048 bins over (0, 1)) and ``compute_on_step=False``: 49
   ``update`` calls, then ``compute()``. B5 must launch twice per batch (98),
   B1-B4 never; the histogram states must equal the same collection's on the
   CPU exactly, the values within 1e-6. The per-``update`` time, the
   ``compute()`` time, the device's busy share of ten updates under the
   profiler, and (printed, not asserted) the exact list-mode AUROC of the
   same stream and its distance from the sketched one.
3d. The binary scorer stream: 100 updates of 10,000 seeded scores (labels
   Bernoulli(score)) into ``AUROC``, ``ROC`` and ``PrecisionRecallCurve``
   with ``sketched=True`` and into the exact ``AUROC()``. B5 must launch 300
   times; the sketched states must equal the CPU's exactly and the values
   within 1e-6; the sketched AUROC must lie within 5e-3 of the exact one.
3i. The compiled step (``jit_forward``, ``warmup``, ``update_many``: CUDA
   graphs replayed over the metrics' own state, written in place). (a) The
   ImageNet-1k collection under ``jit_forward()``, ``warmup`` of both batch
   shapes, then the 49 forwards: B1 49 and B2 49 launches counted through the
   replays, every on-step value and ``compute()`` == 49 eager forwards
   (counts exactly, floats within 1e-6); the time per forward back to back;
   zero synchronizing calls in 10 compiled forwards; the device idle share
   of 10 under the profiler; then a fresh eager and a fresh compiled
   collection over the 49 batches call by call (both medians and their
   ratio; every value equal), with a handle kept on one state from batch 10
   (the step takes the copying graph and the handle keeps its values) and a
   ``reset()`` of both at batch 30; then ``update_many`` over 6 stacked
   groups of 7 batches, one of 6 and the 848-row batch alone, captured in a
   first pass, ``reset()``, and counted in a second: states == 49 eager
   updates, B1 49, B2 49. (b) Phase 3b's keyed collection: ``warmup``, then
   ``update_many`` with K = 5 ten times over the 50 cohorts (captured by a
   first call, then ``reset()``): the merge 50, B1 50, B3 and B4 none, stacked states and the
   tenant report (all but its clock) == the eager updates'; then the
   compiled ``update`` after ``warmup`` against the eager one, call by call
   (medians, states equal, synchronizing calls of one update). (c) Phase
   3c's sketched curves under ``jit_forward`` (``compute_on_step=False``):
   B5 98, histograms == eager exactly. (d) The binary stream through
   ``AUROC(capacity=1_000_000)`` and ``AveragePrecision(capacity=1_000_000)``
   under ``jit_forward``: ``compute()`` == the exact list mode within 1e-6;
   ``AUROC(capacity=500_000, overflow="error")`` raises
   ``BufferOverflowError`` at ``compute()``.
3f. The leftovers at full width: the same 49 batches through
   ``HammingDistance``, ``Hinge(multiclass_mode="crammer-singer")``,
   ``KLDivergence`` (the softmax rows against seeded target distributions)
   and ``AverageMeter`` (of each batch's top-1 confidences), by ``forward``,
   and through the composition ``2 * P * R / (P + R)`` of macro Precision
   and Recall, by ``update``. Each value must equal the CPU run's within
   1e-6, and B1 must launch as often as the CPU run dispatches its plain
   version (4 per step: the tree holds P and R twice, and each occurrence
   updates). The per-step time.
3g. What telemetry costs: the collection's ``forward`` (three passes of the
   49 batches) and the keyed ``update`` (the 50 batches) with telemetry on
   and off, interleaved call by call in this process; both medians and
   their ratio; and the synchronizing calls of the 49 forwards and of the
   50 updates counted by ``torch.cuda.set_sync_debug_mode``, on and off,
   which must be equal; then the keyed update with telemetry on, with its
   tenant ledger and with a ledger that notes nothing, interleaved call by
   call over two passes of the 50 batches (medians, ratio).
   Telemetry stays on (the default) in every other phase; after each of
   3-3d and 3f, ``observability.snapshot()`` must count every op's launches
   as ``launch_count`` does, and each object on the card must hold the
   counters and info blobs of its twin driven on the CPU through the same
   calls (the keyed collection counts the last batch's 1096 pad rows under
   ``invalid_tenant_ids``).
3e. The epoch-end sync over ``torch.distributed``: an NCCL group of world
   size 1 (tcp on localhost). The gather protocol
   (``utilities/distributed.py::_gather_all_leaves``) runs on the ImageNet
   collection's whole state bundle and on the keyed collection's stacked
   leaves: exactly two ``all_gather`` calls per bundle, every leaf back
   bit-identical and on the card; ``sync_state_packed`` of the collection's
   states makes one ``all_reduce`` per bucket and gives the states back. The
   median time of each over 49 repetitions is printed beside the card. One
   card cannot show a sync of two ranks; the gloo tests show it on the CPU.
   The telemetry of the two bundles' gathers must read 2 gathers, 2
   descriptor and 2 payload rounds, and one span per round.
4. Times at the main-path shapes: the median of 50 CUDA-event-timed calls
   of each kernel's wrapper, of its plain version and of the one PyTorch
   call that computes the same function (where there is one), each beside
   the least time the card could take; and the same calls' device time
   alone (kernels and memsets, by the profiler), which leaves out the
   host's launch cost. For B3 and B4 also the library call with its own
   output and index (``library_alloc_ms``), and the host time of each piece
   of their wrappers (1000 calls back to back, no synchronisation); the
   same for B5's wrapper, beside the pieces its earlier design paid. B5 is
   timed with dense labels and with class ids at the curve path's shape and
   at the binary stream's; each kernel's device time is also read from 50
   calls captured into one CUDA graph and replayed between two CUDA events
   (the launch cost amortized); the device time of B1, B2 and B5 is split by
   device operation (fill, memset, kernel), and an empty kernel's device
   time is printed as the floor under the stream shape's byte bound. B1's
   batched form is timed at the keyed rows' (4096, 1, 10) stack (its
   short-slice layout), B2's in phase 3o-a.
3h. The serving plane (``metrics_tpu_torch.serving``). (a) Replay: phase
   3b's 50 cohorts (49 x 4096 rows and the last cohort's 3000 real rows, as
   host numpy) through ``AdmissionQueue(keyed.update, start=False,
   max_batch=4096, pad_to_bucket=True)``, a ``flush()`` after each, once
   unstaged and once with ``staging=True``, and a third time staged with
   every cohort resident before the flusher starts, so that each flush
   prefetches the next cohort on the staging lane (prefetched cohorts must
   be > 0): the stacked states must equal
   phase 3b's exactly and the values within 1e-6, 50 flushes, the merge 50
   and B1 50 launches per path (B3 and B4 none), 1096 ``invalid_tenant_ids`` (the last flush padded
   3000 -> 4096), ``rows_routed`` = 49 * 4096 + 3000, both conservation
   laws, no ``dispatch_error``; under the sync debug mode a staged flush
   makes exactly the synchronizing calls of a direct ``update`` of the same
   cohort on device tensors (the unstaged flush's count is printed); the
   per-flush medians (the flusher's run: its mean from its start to
   drain) beside phase 3b's per-update median. (b) Soak, twice
   (unstaged, then ``staging=True``), 10 s each: ``SLOScheduler(
   KeyedMetric(Accuracy(), num_tenants=10_000, validate_ids=False),
   max_batch=2048, max_delay_ms=5, policy="shed_oldest",
   max_staleness_s=1.0, pad_to_bucket=True)`` fed by 4 producer threads of
   64-row cohorts (uniform tenants, float32 scores, Bernoulli(score) int32
   targets, seeded) at 20,000 rows/s in all and read every second for 16
   random tenants. Printed: achieved rows/s, flushes/s by trigger, ingest
   p50/p99 (the ``serving_ingest_seconds`` histogram), shed rows by reason,
   the staged run's overlap and prefetched cohorts, the read outcomes, the
   reader's reads done against those due (one a second) and each read's
   wall time (p50/p99), and the device idle share over one second of the
   window (profiler). At
   drain: both conservation laws exactly, submitted - shed == the tenant
   report's ``rows_routed``, the ``serving.*`` counters == the queue's
   ledger, no ``dispatch_error`` and no ``_last_error``, the merge
   launched once per flush, and the keyed state == a CPU ``KeyedMetric``
   updated in one call with every cohort the scheduler dispatched.
   (c) ``compute_async()`` of the ImageNet-1k collection after 25 of its 49
   forwards equals a synchronous ``compute()`` at that point and is not
   moved by the 24 forwards after it; the caller's time in each is printed,
   and the time of the clone (the snapshot) alone.
3j. The regression slice (after 3h). (a) A stream of 1,000,000 seeded
   float32 pairs in 100 chunks of 10,000 (log-normal targets, preds =
   target * (1 + N(0, 0.1)) clipped at 0), one ``forward`` per chunk, through
   ``MetricCollection({MSE, RMSE, MAE, MAPE, MSLE, ExplainedVariance,
   R2Score, PearsonCorrcoef(), PearsonCorrcoef(streaming=True),
   SpearmanCorrcoef(), SpearmanCorrcoef(capacity=1_000_000),
   SpearmanCorrcoef(sketched=True, num_bins=512, value_range=(0, 8))})``
   beside ``CosineSimilarity`` in both modes on (10,000, 128) embedding
   chunks; ``compute()`` must equal the port on the CPU over the same chunks
   (relative 1e-5 for float32 states, 1e-12 for float64; counts, the
   capacity buffer and the grid exactly) and the float64 numpy/scipy oracle
   (relative 1e-4); the sketched rho within 1e-2 of the exact one; no kernel
   launches. The tie groups of the 1,000,000 sorted preds by the port's
   cumsum and scatter against ``torch.cummax``/``cummin`` (equal, both
   timed). Then the 10 fixed-state members and streaming cosine under
   ``jit_forward`` + ``warmup``, interleaved call by call with a fresh eager
   run (every on-step value and state equal; medians, capture time, idle
   share), zero synchronizing calls in 10 compiled forwards and in one
   ``update_many``, and ``update_many`` over 10 stacks of 10 chunks equal to
   100 eager updates. (b) ``MultiTenantCollection([MSE, MAE,
   PearsonCorrcoef(streaming=True)], 10,000)`` over phase 3b's 50 cohorts of
   tenant ids with seeded pairs on a 2^-8 grid (every per-tenant sum of one
   update exact in any order): the merge once per update (50), one
   plain ``index_add_`` per bundle per update for the int64 and float64
   leaves (150); the stacked states equal the CPU run's exactly and a float64
   per-tenant numpy oracle (float32 leaves within 1e-5, the others exactly);
   then ``warmup`` + ``update_many`` (K = 5): states equal, the merge 50 through
   the replays; the update median beside phase 3b's. (c) 50 batches of 16 x
   3 x 512 x 512 images (preds = target + N(0, 0.05) clipped to [0, 1])
   through ``SSIM(streaming=True, data_range=1.0)`` and
   ``PSNR(data_range=1.0)``: the first 4 batches' values equal the CPU port's
   within 1e-5, the buffered ``SSIM(data_range=1.0)`` equals the streaming
   one on them; the per-batch median and the idle share of 10 batches.
   ``regression_phase_main()`` runs 3j alone.
3k. The retrieval slice (after 3j): the MS MARCO passage-ranking dev set as
   rerankers evaluate it, made from a seed on the card: 6,980 queries, 90%
   with 1,000 candidates and the rest with a length uniform in [1, 999]
   (about 6.63 M rows), one relevant passage per query (6.5% of queries
   two, 15% none in the list), scores N(0, 1) and N(1.5, 1) rounded through
   bfloat16 (exact ties). (a) The rows, query-major in chunks of 50,000,
   through ``MetricCollection({RetrievalMAP, RetrievalMRR,
   RetrievalPrecision(k=10), RetrievalRecall(k=100),
   RetrievalNormalizedDCG(k=10), RetrievalFallOut(k=10)})`` by ``update``,
   then ``compute()``: == the same collection on the CPU within 1e-6 and ==
   a float64 numpy oracle (lexsort, one vectorized pass) within 1e-5. (b)
   The same queries as (64, 1000) rows with a mask (the last batch padded
   with fully masked rows) through the members with ``padded=True``: eager
   ``forward`` and ``jit_forward`` + ``warmup`` interleaved call by call
   (on-step values equal within 1e-6, 0 synchronizing calls in 10 compiled
   forwards, medians), then ``update_many`` (K = 10); each == (a) within
   1e-5. (c) The stream into ``RetrievalMAP(sketched=True,
   sketch_capacity=1_048_576)``: the reservoir == the CPU run's bit for bit,
   the sampled MAP within 0.05 of (a)'s. (d) ``MultiTenantCollection(
   [RetrievalMAP, RetrievalMRR, RetrievalNormalizedDCG(k=10)](padded=True),
   10,000)``: 50 updates of 4096 query rows x 100 candidates, tenant ids
   uniform (the last update 3000 real rows, padded with id -1): the merge
   once per update (50), B1-B5 never; ``query_total`` == the
   CPU's exactly, ``value_sum`` and the per-tenant values within rtol = atol
   = 1e-5; then ``warmup`` + ``update_many`` (K = 5), the merge 50 through the
   replays. ``retrieval_phase_main()`` runs 3k alone.
3l. The small metrics of the last slice (after 3k). (a) Speech separation
   evaluation shaped like the WSJ0-2mix test set: 3000 mixtures x 2 sources
   of 4 s at 8 kHz (32,000 samples; speech-like targets, Gaussian under a
   slow envelope, predictions at 5-15 dB SNR), 47 forwards of (64, 2,
   32000) through ``SI_SDR``, ``SI_SNR`` and ``SNR`` and their functionals:
   == the CPU port within 1e-5 relative, per signal within 1e-3 dB of a
   float64 numpy oracle; no kernel; per-forward medians and the idle share.
   (b) ``MultiTenantCollection([SI_SDR(), SNR()], 10,000)`` over the last 20
   of phase 3b's cohorts of tenant ids, one 1 s clip at 16 kHz a row (262 MB
   of preds and of targets an update): the merge once per update (20),
   B1-B5 never; the int32 counts == the CPU's exactly, the sums and
   per-tenant values within 1e-5 relative. (c) BLEU over 3003
   newstest2014-shaped pairs (5-80 tokens from a Zipf vocabulary of 32,000,
   30% of each hypothesis replaced), with and without smoothing: card ==
   CPU and == a pure-Python float64 oracle within 1e-6. (d)
   ``embedding_similarity`` at SimCLR's (4096, 128), cosine and dot, none and
   mean: == CPU within 1e-5, identical rows 1.0 within 1e-6 (no TF32); time
   beside the bound. (e) ``image_gradients`` of 16 x 3 x 512 x 512 crops: ==
   CPU exactly; time beside the bound. (f) ``BootStrapper(Accuracy(average=
   "macro", num_classes=1000), 20, quantile=[0.025, 0.975], raw=True)`` over
   phase 3's 49 batches: eager, B1 980 and 980 Poisson totals read, == a CPU
   run replaying the card's index vectors within 1e-6; pure
   (``init_state``/``apply_update``), B1 49 (its batched form, one launch an
   update for the 20 children's (1024, 1000) stack, held against its plain
   version at that shape first) and no synchronizing call in 10 updates, ==
   a CPU run replaying the card's index matrices within 1e-6, its mean
   within 4 std of the plain macro accuracy.
   ``small_metrics_phase_main()`` runs 3l alone.
3m. The generative metrics shaped like CIFAR-10 FID (after 3l): 4,000 real
   and 4,000 generated seeded uint8 3 x 32 x 32 images (the FID-50k protocol
   cut 12.5-fold) in batches of 250, resized to 299, through the InceptionV3
   port with seeded weights (batch-norm statistics from the first real
   batch), into ``FID()``, ``FID(streaming=True)``, ``KID(subsets=100,
   subset_size=1000)`` and ``IS(splits=10)`` (generated images, logits tap):
   the first 32 images' 2048-d features == the CPU's within 1e-3 relative;
   FID == the float64 ``scipy.linalg.sqrtm`` formula on the same features
   within 1e-3, Newton-Schulz == eigh within 1e-3, KID and IS == float64
   numpy oracles on the same subsets and permutation within 1e-4; singular
   covariances on the 'auto' form against a float64 numpy eigh oracle
   within 1e-4, with 123 features zeroed (oracle on the live features) and
   with 1,000 images a side (fewer than the 2048 dims); the jittered eigh
   rescue of a non-finite Newton-Schulz trace (float32 moments of 33
   samples a side at d = 512) == the CPU's within 1e-3; no kernel.
   Printed: the extractor's images/s beside its float32 bound, per-update and
   ``compute()`` times with the 2048 x 2048 trace term apart, peak memory.
   ``generative_phase_main()`` runs 3m alone.
3n. The observability plane armed on the main paths (after 3m). (a) The
   ImageNet-1k collection under ``jit_forward`` with health ``"record"`` and
   ``set_profiling(10)``, 49 forwards: B1 49 and B2 49; every synchronizing
   call of the run one of the profiler's 5 sampled waits, none from the
   health guard (and none in 10 forwards with health alone); the guard's
   flag copies drained, the health ledger healthy; the sampled
   ``dispatch_device_seconds{path=compiled}`` of one forward beside the
   torch profiler's device time of it. With everything off: B1 49, B2 49,
   0 synchronizing calls in 10 forwards, two captures of one B1 and one B2
   launch each (phase 3i's). Health on over off, call by call over 2 x 49
   forwards (medians, ratio). (b) Phase 3j-b's keyed regression collection
   with one NaN pred in cohort 20, eager and after ``warmup``: the merge 50 each;
   three health events (one per member, naming its states), at the step of
   cohort 20 eager and at most one dispatch later compiled; then the same
   cohorts through ``AdmissionQueue(quarantine="auto")``: the NaN row shed
   as ``"poisoned"``, no health event, states == the CPU run over the clean
   rows exactly. (c) ``memory_report()`` of the 10,000-tenant keyed
   collection == its tensors' ``nbytes``, ``warmup``'s ``"state_memory"`` ==
   ``state_memory_report()``, the caching allocator's blocks under a second
   one's state tensors hold its ``nbytes`` within 512 bytes a tensor, and an
   ``on_pressure`` watermark fires exactly once. (d) The SLO on the staged soak's ingest histogram (p99 <=
   100 ms, ``scripts/soak.py:60``), ticked each second: the burn rates.
   (e) ``timeline.export`` and ``export_fleet`` load back as JSON with the
   serving, profile, memory and collective tracks, and
   ``aggregate_snapshots`` over a one-rank NCCL group.
   ``observability_phase_main()`` runs 3n alone (with a 3 s soak).
3o. Durability, resilience and transport (after 3n). (a) The JAX package's
   checkpoint capture (``scripts/bench_suite.py:2059-2160``):
   ``KeyedMetric(ConfusionMatrix(16))`` over 4,096 tenants, 8,192 seeded
   rows, 5 rounds of a full save, 64 tenants touched and a delta save (the
   delta stamps exactly those 64, its payload <= full * 64 / 4096 + 256),
   one ``save_async`` while 256-row updates land (their synchronizing calls
   == as many as without a save in flight), B2's batched form (the keyed
   rows' counts, one launch for an update's rows) and the merge one launch an
   update, B2's batched form held against its plain version at the keyed
   rows' shapes and a bootstrap's (20, 1024, 1000) and timed (wrapper,
   device, bound, plain and ``bincount``); the
   restores onto a fresh card metric, a CPU metric and a card metric grown to
   8,192 == the cut exactly; a CPU-written snapshot == on the card; each of
   the seven crash points leaves the last complete snapshot restorable. (b)
   Phase 3b's collection saved after 25 cohorts, its owner dropped, restored
   into a new owner (eager, and compiled with the restore taking the graph's
   copy-in path), the last 25 cohorts: states == the uninterrupted run
   exactly, the merge 50 each (B3 and B4 none); ``grow(20,000)`` and ``compact(10,000)``
   under the compiled update == an eager twin, one capture per capacity, the
   ledger's bytes == the states' ``nbytes``. (c) The spill capture
   (``bench_suite.py:2166-2240``): ``KeyedMetric(Accuracy())`` over 2,048
   tenants at ``resident_cap`` 256, 7 rounds of fault-back then evict of 64:
   per-tenant times and synchronizing calls, reads == a never-evicted control
   bit for bit, conservation exact, the ledger's spilled bytes == the rows';
   then (b)'s compiled collection at 1,250 resident: a compiled update through
   the held graph and a read == its eager twin; then what an ``auto=True``
   spiller adds to a 512-row keyed update (its time and synchronizing calls
   without a spiller, with the hooks alone, and evicting to 256). (d) The chaos capture
   (``scripts/soak.py:184-316,417-975``): a 3-rank fleet of threads (rank 2
   dead) over ``StoreSubgroupChannel``s and one ``TCPStore`` with a dropped
   payload round, a hung channel get and rank 1's death promoted by the
   detector (failover time), then 10 s of 8,000 rows/s into 2,048 tenants
   (max batch 512) with ``serving.dispatch`` errors at hits 3 and 9, an
   auto-save crashed at ``checkpoint.before_manifest``, NaN rows quarantined:
   zero lost updates, the schedule fired, quarantine exact, restore
   bit-identical, no deadlock; ingest p50/p99. (e) An NCCL world of 1:
   ``ShardedTransport`` over a one-device mesh (``shard_state``,
   ``reduce_states``, a restore through ``place_state``) == the replicated
   state, a 1 x 1 ``Hierarchy`` == the flat sync, ``InGraphTransport`` == the
   eager pair. ``durability_phase_main()`` runs 3o alone.
3p. The keyed and bootstrapped sketched curves, B5's batched form (after
   3o). (a) ``KeyedMetric(AUROC(sketched=True))`` over 10,000 tenants (2048
   bins over (0, 1); a 164 MB state): phase 3b's 50 cohorts of tenant ids
   with the binary stream's scores and labels, 4096 at a time, then
   ``compute()``: B5 batched 50 (one (4096, 1, 1) stack an update), the merge 50,
   no plain B5 dispatch; states == the CPU run's exactly, values within
   1e-6; four tenants' AUROC == their own rows' unkeyed sketched AUROC on
   the card; the idle share of ten updates. (b) ``KeyedMetric(AUROC(
   num_classes=10, sketched=True))`` (a 1.64 GB state) over the first 10 of
   phase 3b's cohorts, cut for the CPU twin's time: B5 10 (class ids), the
   merge 10, == CPU. (c) (a) under ``warmup`` + ``update_many`` (K = 5, captured
   by a first call, then ``reset()``): B5 50 and the merge 50 through the replays,
   states == (a)'s. (d) ``BootStrapper(AUROC(num_classes=1000,
   sketched=True), 20)`` through ``init_state``/``apply_update``/
   ``apply_compute`` over 5 ImageNet-1k batches: B5 5 (one (20, 1024, 1000)
   stack an update), the children's histograms == a CPU replay of the card's
   index matrices exactly, the statistics within 1e-6 (NaN in the same
   places). (b) and (d) also compute their states per class
   (``average=None``) on both devices, since their macro values are NaN
   (a tenant or a resample with a class of one label): at least one finite
   value must be compared, within 1e-6. At each of the three stacks, B5
   batched's wrapper, device and graph time, the plain batched version and
   ``torch.bincount`` over the same flat index, beside the byte bound. The
   kernel's device time is the mean of the profile's records (a long
   process's profile drops some; their count is printed); one still below
   the bound is kept apart and the graph's time reported as the device
   time. ``sketched_keyed_phase_main()``
   runs 3p alone.
3q. The merge (``segment_merge``, the keyed update's one launch over every
   int32, float32, bfloat16, int16 and int8 leaf): at the keyed path's
   shapes (4096 rows, 10,000 tenants, the eleven leaves of phase 3b's two
   bundles, rows strided and broadcast, non-zero defaults, each of those
   dtypes, int64 and int32 ids) the kernel == its plain version bit for bit; phase 3b's real leaves ==
   the plain version == the per-leaf chain through B3 and B4 that it
   replaced; a keyed regression bundle's float32 sums within rtol 1e-6 and
   its int32 count exactly; phase 3b's collection eager and compiled: the
   merge 50 launches each, B3 and B4 none; a keyed bundle of narrow leaves
   (a bfloat16 sum, a wrapping int8 sum, int16 and int8 extrema, a bfloat16
   max over NaN and both signed zeros), alone and beside a second bundle,
   eager and compiled: == the CPU bit for bit, the merge once an update, B3
   and B4 none; times of the merge against the
   chain (CUDA events, device, a replayed graph, host time a call). Alone:
   ``chip_smoke.merge_phase_main(path)``.
5. One JSON line ``{"kernels": [...]}`` (the five kernels, the merge, then
   the batched forms of B1, B5 and B2 as entries of their own), the card line again,
   and, last, ``{"ok": true, "device": {...}}``.

With ``--record PATH`` the full record (every parity case, every forward's
time, the profile, the timings) is also written to PATH as JSON.
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

NUM_CLASSES = 1000
NUM_SAMPLES = 50_000
BATCH = 1024
SEED = 20261016
#: H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, and the 32-bit
#: non-tensor-core rate used as the operations bound of integer work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
REPS = 50
#: the keyed path: the repo's multitenant serving configuration
KEYED_TENANTS = 10_000
KEYED_ROWS = 4096
KEYED_CLASSES = 10
KEYED_UPDATES = 50
KEYED_LAST_REAL = 3000
#: the sketched curves: the class default grid, and the binary scorer stream
#: of the JAX package's bench_sketched_state_sync (1,000,000 scores in chunks
#: of 10,000)
NUM_BINS = 2048
STREAM_UPDATES = 100
STREAM_CHUNK = 10_000
#: the serving soak (scripts/soak.py:52-61, scripts/bench_suite.py:2009-2012):
#: 10,000 tenants, 2048-row micro-batches, a 5 ms deadline, shed_oldest, a
#: 1 s staleness budget, 4 producer threads of 64-row cohorts pacing 20,000
#: rows/s, a reader of 16 tenants every second; 10 s per run (the soak's
#: 60 s, cut to fit the script's time limit)
SOAK_TENANTS = 10_000
SOAK_MAX_BATCH = 2048
SOAK_DELAY_MS = 5.0
SOAK_RATE = 20_000
SOAK_PRODUCERS = 4
SOAK_COHORT = 64
SOAK_SECONDS = 10.0
SOAK_READ_TENANTS = 16
#: the soak's ingest-latency objective: p99 at or below 100 ms (scripts/soak.py:60)
SOAK_SLO_S = 0.1
#: phase 3j: the regression stream of 1,000,000 pairs in chunks of 10,000
#: (the binary stream's size), cosine over (10,000, 128) embedding chunks,
#: the sketched Spearman's class default grid over the stream's range, and
#: image quality over 800 crops of 512 x 512 (a super-resolution evaluation)
REG_UPDATES = 100
REG_CHUNK = 10_000
REG_DIM = 128
REG_BINS = 512
REG_RANGE = (0.0, 8.0)
IMG_BATCHES = 50
IMG_BATCH = 16
IMG_SIDE = 512


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof) -> list:
    """The device-side rows of a profile (kernels, memsets, copies), not the
    host operators that launched them (whose device time would count twice)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def _device_us(prof) -> float:
    """Device busy time (us) in a profile."""
    return sum(e.self_device_time_total for e in _device_events(prof))


def host_us(pieces, calls: int = 1000, warmup: int = 50) -> dict:
    """Host time (us per call) of each ``(name, fn)`` piece: ``calls`` calls
    back to back on the host clock, with no synchronisation in between (the
    device work a piece enqueues runs behind it and is not counted)."""
    import torch

    out = {}
    for name, fn in pieces:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - start) / calls * 1e6
        torch.cuda.synchronize()
    return out


def device_ms(fn, reps: int = REPS):
    """Device time of one call of ``fn`` (its kernels and memsets, without
    the host's launch cost) by the profiler; None if it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = _device_us(prof)
    return total_us / reps / 1e3 if total_us > 0 else None


def device_ms_records(fn, reps: int = REPS) -> tuple:
    """Device time of one call of ``fn``, which runs each of its device
    operations once a call, by the profiler, and how many records of its
    busiest operation the profile holds (``reps`` where none was dropped).
    A long process's profile can drop records, and :func:`device_ms`, which
    divides by the calls, then reads short: here each operation's time is
    the mean of the records the profile holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in _device_events(prof) if e.count]
    total_us = sum(e.self_device_time_total / e.count for e in events)
    records = max(events, key=lambda e: e.self_device_time_total).count if events else 0
    return (total_us / 1e3 if total_us > 0 else None), records


def graph_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn`` without the host's launch cost:
    ``reps`` calls captured into one CUDA graph (their launches counted per
    replay, as the compiled step counts them), the graph replayed between
    two CUDA events; the median of five replays over ``reps``."""
    import torch

    from metrics_tpu_torch.kernels import _common

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _common.capture_tally() as tally, torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        _common.note_replay(tally)
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_split(fn, reps: int = REPS) -> dict:
    """Device time (us per call of ``fn``) of each device operation, by its name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:70]: e.self_device_time_total / reps for e in _device_events(prof)}


def bound(nbytes: int, nops: int) -> tuple:
    """The least time (ms) the card could take: bytes moved or operations done."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def graph_probe(torch, dev) -> dict:
    """Phase 2b: each kernel's wrapper captured once in a CUDA graph
    (``capture_error_mode="thread_local"``, as the compiled step captures)
    at its path's shape, replayed twice on fresh inputs copied into the
    graph's input buffers, each replay held against the plain version (B3's
    float sums within rtol = atol = 1e-5, everything else exactly). B3, B4
    and B5's add mode are cooperative launches; a capture that refuses one
    fails the run here."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.binned_counts import (
        _label_score_histograms_onevsrest,
        _onevsrest_torch,
        histogram_plan,
        label_score_histograms_batched_cuda,
        label_score_histograms_batched_torch,
        label_score_histograms_cuda,
        label_score_histograms_torch,
    )
    from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
    from metrics_tpu_torch.kernels.segment_scatter import (
        segment_scatter_add_cuda,
        segment_scatter_add_torch,
        segment_scatter_max_cuda,
        segment_scatter_max_torch,
    )
    from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)

    def ids_rows(d):
        return (torch.randint(-1, KEYED_TENANTS + 1, (KEYED_ROWS,), generator=gen, device=dev),
                torch.rand((KEYED_ROWS, d), generator=gen, device=dev))

    def scores_ids():
        return (torch.rand((BATCH, NUM_CLASSES), generator=gen, device=dev),
                torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=dev))

    def stream():
        s = torch.rand((STREAM_CHUNK, 1), generator=gen, device=dev)
        return s, (torch.rand((STREAM_CHUNK, 1), generator=gen, device=dev) < s).to(torch.int32)

    def keyed_rows():
        s = torch.rand((KEYED_ROWS, 1, 1), generator=gen, device=dev)
        return s, (torch.rand((KEYED_ROWS, 1, 1), generator=gen, device=dev) < s).to(torch.int32)

    def canonical():
        return (torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=dev, dtype=torch.int32))

    def labels():
        return (torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=dev),
                torch.randint(0, NUM_CLASSES, (BATCH,), generator=gen, device=dev))

    cases = [
        ("stat_scores_counts", canonical, lambda p, t: stat_scores_counts_cuda(p, t, device=dev),
         stat_scores_counts_torch, 0.0),
        ("confmat_counts", labels, lambda p, t: (confmat_counts_cuda(p, t, NUM_CLASSES, device=dev),),
         lambda p, t: (confmat_counts_torch(p, t, NUM_CLASSES),), 0.0),
        ("segment_scatter_add", lambda: ids_rows(40),
         lambda i, r: segment_scatter_add_cuda(r, i, KEYED_TENANTS, device=dev),
         lambda i, r: segment_scatter_add_torch(r, i, KEYED_TENANTS), 1e-5),
        ("segment_scatter_max", lambda: ids_rows(1),
         lambda i, r: segment_scatter_max_cuda(r, i, KEYED_TENANTS, device=dev),
         lambda i, r: segment_scatter_max_torch(r, i, KEYED_TENANTS), 0.0),
        ("label_score_histograms", scores_ids,
         lambda s, i: _label_score_histograms_onevsrest(s, i, NUM_BINS),
         lambda s, i: _onevsrest_torch(s, i, NUM_BINS), 0.0),
        ("label_score_histograms_stream", stream,
         lambda s, t: label_score_histograms_cuda(s, t, NUM_BINS, device=dev),
         lambda s, t: label_score_histograms_torch(s, t, NUM_BINS), 0.0),
        ("label_score_histograms_batched", keyed_rows,
         lambda s, t: label_score_histograms_batched_cuda(s, t, NUM_BINS, device=dev),
         lambda s, t: label_score_histograms_batched_torch(s, t, NUM_BINS), 0.0),
    ]
    out = {}
    for name, make, kernel, plain, tol in cases:
        static = [x.clone() for x in make()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            kernel(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                captured = kernel(*static)
        except Exception as err:  # noqa: BLE001 - the probe reports what the capture refused
            fail(f"[graph probe] {name}: the capture refused the launch: {type(err).__name__}: {err}")
        errs = []
        for _ in range(2):
            fresh = make()
            for buf, x in zip(static, fresh):
                buf.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            want = plain(*fresh)
            for g, w in zip(captured, want):
                diff = torch.where(g == w, 0.0, (g.double() - w.double()).abs())  # equal infinities differ by 0
                errs.append(float(diff.max()) if g.numel() else 0.0)
                ok = (torch.allclose(g, w, rtol=tol, atol=tol) if tol else torch.equal(g, w)) and g.dtype == w.dtype
                if not ok:
                    fail(f"[graph probe] {name}: a replay differs from the plain version by {errs[-1]}")
        extra = ""
        if name == "label_score_histograms_stream":
            plan = histogram_plan(STREAM_CHUNK, 1, NUM_BINS, _common.sm_count(dev))
            extra = f" ({('store', 'add', 'global')[plan.mode]} mode)"
        out[name] = max(errs)
        print(f"[graph probe] {name}{extra}: captured with thread_local mode, two replays == plain "
              f"(max |diff| {max(errs):.3e})")
    return out


def graph_probe_main() -> int:
    """Build the kernels and run :func:`graph_probe` alone."""
    import torch

    from metrics_tpu_torch.kernels import _common

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _common.build_library()
    graph_probe(torch, torch.device("cuda", 0))
    return 0


#: the tenant report's keys that do not depend on the clock
_REPORT_KEYS = ("tenants", "tracking", "rows_routed", "occupancy", "top_traffic", "invalid_tenant_ids", "invalid_rate")


def _values_equal(torch, name, got, want) -> float:
    """``got`` == ``want``: integer tensors exactly, floats within 1e-6
    (NaN where the other is NaN); returns the largest difference."""
    if got is None or want is None:
        if got is not want:
            fail(f"[compiled] {name}: {got} against {want}")
        return 0.0
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"[compiled] {name}: {tuple(got.shape)} {got.dtype} against {tuple(want.shape)} {want.dtype}")
    if not got.is_floating_point():
        if not torch.equal(got, want):
            fail(f"[compiled] {name}: counts differ from the eager run's")
        return 0.0
    if not torch.equal(got.isnan(), want.isnan()):
        fail(f"[compiled] {name}: NaN where the eager run's is not, or the reverse")
    diff = float(torch.nan_to_num(got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if diff > 1e-6:
        fail(f"[compiled] {name}: differs from the eager run's by {diff}")
    return diff


def _states_equal(torch, label, got, want) -> None:
    for name, value in want._get_states().items():
        if not torch.equal(getattr(got, name), value):
            fail(f"[compiled] {label}.{name} differs from the eager run's")


def compiled_phase(torch, M, dev, card) -> dict:
    """Phase 3i: the compiled step (``jit_forward``, ``warmup``,
    ``update_many``: CUDA graphs replayed over the metrics' own state) on
    every path at full width, each against the same path run eagerly."""
    from metrics_tpu_torch.kernels import _common

    record = {}
    batches = make_batches(torch, dev)
    scope_ops = ("stat_scores_counts", "confmat_counts")

    # (a) the ImageNet-1k collection: warmup, then the 49 forwards alone (launches, values)
    # a capture runs the program once eagerly first (its launches count), so
    # every signature of the path (1024 rows, and the 848-row last batch) is
    # warmed before the counted run
    comp = build_collection(M, dev).jit_forward()
    start = time.perf_counter()
    warm = comp.warmup(*batches[0])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    comp.warmup(*batches[-1])
    _common.reset_dispatch_counters()
    comp_values = []
    for preds, target in batches:
        comp_values.append(comp(preds, target))
    torch.cuda.synchronize()
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    for op in KERNEL_OPS:
        want = len(batches) if op in scope_ops else 0
        if launches[op] != want:
            fail(f"[compiled] {op} launched {launches[op]} times through the replays of 49 forwards, expected {want}")
    cache = comp._jit_forward_fn.cache_info()
    if warm["compiled_this_call"] is not True or cache != {"entries": 2, "hits": 49, "misses": 2}:
        fail(f"[compiled] warmup {warm['compiled_this_call']}, dispatch cache {cache}: expected the two warmups' "
             "captures and 49 replays")
    print(f"[compiled] ImageNet-1k collection jit_forward + warmup on {card}: capture {warm_s * 1e3:.1f} ms "
          f"(compile_seconds {warm['compile_seconds']}); launches through the replays of 49 forwards {launches}; "
          f"dispatch cache {cache}; groups {comp._compute_groups}")
    # zero synchronizing calls per forward after warmup
    # back to back, no synchronization between forwards: the host's time per
    # forward, or the card's where the card is the slower
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for preds, target in batches[1:41]:
        comp(preds, target)
    host_end = time.perf_counter()
    torch.cuda.synchronize()
    back_ms = ((time.perf_counter() - t0) * 1e3 / 40, (host_end - t0) * 1e3 / 40)
    syncs = sync_calls(torch, lambda: [comp(*b) for b in batches[1:11]])
    if syncs:
        fail(f"[compiled] 10 compiled forwards made {len(syncs)} synchronizing calls: {syncs[:5]}")
    prof = profile_steps(torch, comp, batches[11:21])
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"[compiled] 40 compiled forwards back to back: {back_ms[0]:.3f} ms each to the card's end, "
          f"{back_ms[1]:.3f} ms each of host dispatch; 10 compiled forwards: 0 synchronizing calls; under the "
          f"profiler wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    for row in prof["top_device"]:
        print(f"[compiled]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")

    # the same 49 batches eagerly and compiled (fresh collections), call by
    # call: every on-step value equal; a handle kept on one state at batch 10
    # (the copying graph; the handle keeps its values) and a reset() of both
    # at batch 30
    eager, comp2 = build_collection(M, dev), build_collection(M, dev).jit_forward()
    comp2.warmup(*batches[0])
    comp2.warmup(*batches[-1])
    eager_ms, comp_ms, diffs = [], [], {}
    handle = kept = None
    for i, (preds, target) in enumerate(batches):
        if i == 30:
            eager.reset()
            comp2.reset()
        if i == 10:
            handle = comp2["F1"].tp
            kept = handle.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eager(preds, target)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = comp2(preds, target)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        eager_ms.append((t1 - t0) * 1e3)
        comp_ms.append((t2 - t1) * 1e3)
        for name, value in want.items():
            diffs[name] = max(diffs.get(name, 0.0), _values_equal(torch, f"step {i} {name}", got[name], value))
        if i == 10:
            if not torch.equal(handle, kept):
                fail("[compiled] the compiled step wrote into a state tensor held outside the collection")
            fallbacks = M.observability.snapshot()["metrics"][comp2.telemetry_key]["counters"].get(
                "jit_forward_alias_fallbacks")
            if fallbacks != 1:
                fail(f"[compiled] the aliased step counted {fallbacks} alias fallbacks, expected 1")
    if not torch.equal(handle, kept):
        fail("[compiled] a later step wrote into the state tensor held outside the collection")
    del handle
    final_eager, final_comp = eager.compute(), comp2.compute()
    for name, value in final_eager.items():
        _values_equal(torch, f"compute() {name}", final_comp[name], value)
    # the first compiled run (no reset) against phase 3's states: 49 eager forwards
    ref = build_collection(M, dev)
    for i, (preds, target) in enumerate(batches):
        want = ref(preds, target)
        for name, value in want.items():
            _values_equal(torch, f"step {i} {name} (first compiled run)", comp_values[i][name], value)
    ref_out = ref.compute()
    e_med, c_med = statistics.median(eager_ms), statistics.median(comp_ms)
    print(f"[compiled] eager and compiled forwards interleaved, 49 batches on {card}: eager median {e_med:.3f} ms, "
          f"compiled median {c_med:.3f} ms (ratio {c_med / e_med:.3f}); every on-step value and compute() == eager "
          f"(max |diff| {max(diffs.values()):.2e}); a kept state handle took the copying graph and kept its values; "
          f"reset() at batch 30 == eager")

    # update_many: 6 stacked groups of 7 batches, one of 6, and the 848-row
    # batch alone (K = 1); a first pass captures the three signatures, then
    # reset() and the counted pass, which only replays
    many = build_collection(M, dev)
    groups = [batches[k:k + 7] for k in range(0, 42, 7)] + [batches[42:48], batches[48:]]
    stacks = [(torch.stack([p for p, _ in group]), torch.stack([t for _, t in group])) for group in groups]
    for stacked in stacks:
        many.update_many(*stacked)
    many.reset()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    many_ms = []
    for stacked in stacks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        many.update_many(*stacked)
        torch.cuda.synchronize()
        many_ms.append((time.perf_counter() - t0) * 1e3)
    many_launches = {op: _common.launch_count(op) for op in scope_ops}
    if many_launches != {"stat_scores_counts": 49, "confmat_counts": 49}:
        fail(f"[compiled] update_many launched {many_launches}, expected 49 each")
    for name in many.keys(keep_base=True):
        _states_equal(torch, f"update_many {name}", many[name], ref[name])
    many_out = many.compute()
    for name, value in ref_out.items():
        _values_equal(torch, f"update_many compute() {name}", many_out[name], value)
    print(f"[compiled] update_many over 49 batches (6 x K=7, K=6, K=1; captured in a first pass, then reset()): "
          f"states == 49 eager updates, launches {many_launches}; per call "
          f"{', '.join(f'{ms:.2f}' for ms in many_ms)} ms")
    record["collection"] = {
        "launches": launches, "warmup": {k: v for k, v in warm.items() if k != "state_memory"},
        "capture_ms": warm_s * 1e3, "sync_calls_10_forwards": len(syncs), "profile": prof, "idle_share": idle,
        "back_to_back_ms": back_ms[0], "back_to_back_host_ms": back_ms[1],
        "eager_ms": eager_ms, "compiled_ms": comp_ms, "eager_median_ms": e_med, "compiled_median_ms": c_med,
        "max_abs_diff": diffs, "update_many_ms": many_ms, "update_many_launches": many_launches,
    }

    # (b) the keyed cohorts: warmup, then update_many with K = 5, ten times
    keyed_batches = make_keyed_batches(torch, dev)
    keyed_ref = build_keyed(M, dev)
    for cohort in keyed_batches:
        keyed_ref.update(*cohort)
    keyed = build_keyed(M, dev)
    start = time.perf_counter()
    keyed_warm = keyed.warmup(*keyed_batches[0])
    torch.cuda.synchronize()
    keyed_warm_s = time.perf_counter() - start
    keyed_stacks = [[torch.stack([c[j] for c in keyed_batches[k:k + 5]]) for j in range(3)]
                    for k in range(0, KEYED_UPDATES, 5)]
    # the first call captures update_many's graph (cohorts 0-4 hold no invalid id), then reset()
    keyed.update_many(*keyed_stacks[0])
    keyed.reset()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    keyed_many_ms = []
    for stacked in keyed_stacks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keyed.update_many(*stacked)
        torch.cuda.synchronize()
        keyed_many_ms.append((time.perf_counter() - t0) * 1e3)
    keyed_launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    want_launches = {op: 0 for op in KERNEL_OPS}
    want_launches.update(segment_merge=KEYED_UPDATES, stat_scores_counts=KEYED_UPDATES)
    if keyed_launches != want_launches:
        fail(f"[compiled] keyed update_many launched {keyed_launches}, expected {want_launches}")
    for owner, km in keyed_ref._keyed.items():
        _states_equal(torch, f"keyed {owner}", keyed._keyed[owner], km)
    rep_ref, rep = keyed_ref.tenant_report(), keyed.tenant_report()
    for key in _REPORT_KEYS:
        if rep[key] != rep_ref[key]:
            fail(f"[compiled] the keyed tenant report's {key} is {rep[key]}, eager {rep_ref[key]}")
    # the compiled single update after warmup, interleaved with the eager one
    keyed2, keyed_eager = build_keyed(M, dev), build_keyed(M, dev)
    keyed2.warmup(*keyed_batches[0])
    keyed_ms, keyed_eager_ms = [], []
    for cohort in keyed_batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keyed_eager.update(*cohort)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        keyed2.update(*cohort)
        torch.cuda.synchronize()
        keyed_eager_ms.append((t1 - t0) * 1e3)
        keyed_ms.append((time.perf_counter() - t1) * 1e3)
    for owner, km in keyed_ref._keyed.items():
        _states_equal(torch, f"keyed compiled update {owner}", keyed2._keyed[owner], km)
    keyed_syncs = sync_calls(torch, lambda: keyed2.update(*keyed_batches[1]))
    per_cohort = statistics.median(keyed_many_ms) / 5
    print(f"[compiled] keyed: warmup {keyed_warm_s * 1e3:.1f} ms; update_many K=5 x 10 over the 50 cohorts: launches "
          f"{ {k: v for k, v in keyed_launches.items() if v} }, states == eager, tenant report == eager; per call "
          f"median {statistics.median(keyed_many_ms):.3f} ms ({per_cohort:.3f} ms per cohort); compiled update median {statistics.median(keyed_ms):.3f} ms against "
          f"eager {statistics.median(keyed_eager_ms):.3f} ms, interleaved; states == eager; "
          f"{len(keyed_syncs)} synchronizing calls per compiled update")
    record["keyed"] = {"launches": keyed_launches, "warmup_ms": keyed_warm_s * 1e3, "update_many_ms": keyed_many_ms,
                       "update_many_per_cohort_ms": per_cohort, "compiled_update_ms": keyed_ms,
                       "eager_update_ms": keyed_eager_ms, "sync_calls_per_update": len(keyed_syncs),
                       "warmup": {k: v for k, v in keyed_warm.items() if k != "state_memory"}}

    # (c) the sketched curves under jit_forward (compute_on_step=False)
    curves_ref = build_curves(M, dev)
    for preds, target in batches:
        curves_ref.update(preds, target)
    curves = build_curves(M, dev).jit_forward()
    curves.warmup(*batches[0])
    curves.warmup(*batches[-1])
    _common.reset_dispatch_counters()
    curve_ms = []
    for preds, target in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if curves(preds, target) != {"AUROC": None, "AveragePrecision": None}:
            fail("[compiled] a curve metric built with compute_on_step=False returned a value")
        torch.cuda.synchronize()
        curve_ms.append((time.perf_counter() - t0) * 1e3)
    curve_launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    if curve_launches["label_score_histograms"] != 2 * len(batches) or sum(curve_launches.values()) != 2 * len(batches):
        fail(f"[compiled] the sketched curves launched {curve_launches}, expected B5 {2 * len(batches)} only")
    for name in ("AUROC", "AveragePrecision"):
        _states_equal(torch, f"curves {name}", curves[name], curves_ref[name])
    curve_out, curve_ref_out = curves.compute(), curves_ref.compute()
    for name, value in curve_ref_out.items():
        _values_equal(torch, f"curves compute() {name}", curve_out[name], value)
    print(f"[compiled] sketched AUROC + AveragePrecision (C={NUM_CLASSES}) jit_forward over 49 batches: launches "
          f"{ {k: v for k, v in curve_launches.items() if v} }, histograms == eager exactly; forward median "
          f"{statistics.median(curve_ms):.3f} ms")
    record["curves"] = {"launches": curve_launches, "forward_ms": curve_ms}

    # (d) capacity mode: the binary stream through AUROC/AveragePrecision(capacity=1_000_000)
    chunks = make_stream(torch, dev)
    exact = {"AUROC": M.AUROC(compute_on_step=False, device=dev),
             "AveragePrecision": M.AveragePrecision(compute_on_step=False, device=dev)}
    capped = {name: getattr(M, name)(capacity=STREAM_UPDATES * STREAM_CHUNK, device=dev).jit_forward()
              for name in exact}
    capped["AUROC"].warmup(*chunks[0])
    over = M.AUROC(capacity=STREAM_UPDATES * STREAM_CHUNK // 2, overflow="error", compute_on_step=False,
                   device=dev).jit_forward()
    cap_ms = []
    for scores, labels in chunks:
        for m in exact.values():
            m.update(scores, labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in capped.values():
            m(scores, labels)
        torch.cuda.synchronize()
        cap_ms.append((time.perf_counter() - t0) * 1e3)
        over(scores, labels)
    cap_diffs = {}
    for name, m in capped.items():
        got, want = m.compute(), exact[name].compute()
        cap_diffs[name] = abs(float(got) - float(want))
        if not (cap_diffs[name] <= 1e-6):
            fail(f"[compiled] {name}(capacity=1_000_000) computes {float(got)}, the exact list mode {float(want)}")
    try:
        over.compute()
    except M.BufferOverflowError as err:
        overflow_msg = str(err).split(".")[0]
    else:
        fail("[compiled] AUROC(capacity=500_000, overflow='error') did not raise BufferOverflowError at compute()")
    print(f"[compiled] capacity mode, 100 chunks of {STREAM_CHUNK} scores under jit_forward: |capacity - exact| "
          f"{cap_diffs} (limit 1e-6); step of both metrics median {statistics.median(cap_ms):.3f} ms; "
          f"capacity={STREAM_UPDATES * STREAM_CHUNK // 2} with overflow='error' raised at compute(): {overflow_msg}")
    record["capacity"] = {"max_abs_diff": cap_diffs, "step_ms": cap_ms, "overflow_error": overflow_msg}
    return record


def _phase_alone(run, record_path: str) -> int:
    """Build the kernels and run one phase, ``run(torch, M, dev, card)``,
    alone; with ``record_path``, write its record there as JSON."""
    import torch

    import metrics_tpu_torch as M
    from metrics_tpu_torch.kernels import _common

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    _common.build_library()
    record = run(torch, M, torch.device("cuda", 0), card)
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)), exist_ok=True)
        with open(record_path, "w") as fh:
            json.dump(record, fh, indent=1, default=str)
    return 0


def compiled_phase_main(record_path: str = "") -> int:
    """Run :func:`compiled_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(compiled_phase, record_path)


def make_batches(torch, device):
    """The 49 seeded ImageNet-1k-shaped batches: softmax rows whose true class
    gets a logit margin (about three quarters top-1 right), int64 targets."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    batches = []
    for start in range(0, NUM_SAMPLES, BATCH):
        n = min(BATCH, NUM_SAMPLES - start)
        target = torch.randint(0, NUM_CLASSES, (n,), generator=gen, device=device)
        logits = torch.randn((n, NUM_CLASSES), generator=gen, device=device)
        logits[torch.arange(n, device=device), target] += 4.0
        batches.append((torch.softmax(logits, dim=1), target))
    return batches


def build_collection(M, device):
    """The ImageNet-1k collection: the macro stat-scores members share one B1
    update per batch, the confusion-matrix members one B2 update."""
    macro = dict(average="macro", num_classes=NUM_CLASSES, device=device)
    return M.MetricCollection({
        "Accuracy": M.Accuracy(device=device),
        "Precision": M.Precision(**macro),
        "Recall": M.Recall(**macro),
        "F1": M.F1(**macro),
        "Specificity": M.Specificity(**macro),
        "ConfusionMatrix": M.ConfusionMatrix(num_classes=NUM_CLASSES, device=device),
        "IoU": M.IoU(num_classes=NUM_CLASSES, device=device),
        "CohenKappa": M.CohenKappa(num_classes=NUM_CLASSES, device=device),
        "MatthewsCorrcoef": M.MatthewsCorrcoef(num_classes=NUM_CLASSES, device=device),
    })


def sync_phase(torch, gpu, keyed_gpu, card) -> dict:
    """Phase 3e: the epoch-end sync's protocol over NCCL, on one card (world
    size 1). Every failure fails the run."""
    import socket
    import warnings

    import torch.distributed as dist
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.utilities import distributed as mdist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    real_gather, real_reduce = mdist._all_gather, dist.all_reduce
    calls = {"all_gather": 0, "all_reduce": 0}

    def counted_gather(buf, group):
        calls["all_gather"] += 1
        return real_gather(buf, group)

    def counted_reduce(*a, **k):
        calls["all_reduce"] += 1
        return real_reduce(*a, **k)

    mdist._all_gather, dist.all_reduce = counted_gather, counted_reduce
    out = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
    try:
        bundles = {
            "imagenet_collection": [m._pre_sync_states()[0] for m in gpu.values()],
            "keyed_collection": [km._get_states() for km in keyed_gpu._keyed.values()],
        }
        # the first collective of the group sets NCCL's communicator up
        mdist._gather_all_leaves(mdist._tree_leaves(bundles["imagenet_collection"], []), None)
        torch.cuda.synchronize()
        observability.reset()
        for name, trees in bundles.items():
            leaves = mdist._tree_leaves(trees, [])
            calls["all_gather"] = 0
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                gathered = mdist._gather_all_leaves(leaves, None)
                torch.cuda.set_sync_debug_mode("default")
            host_syncs = sum("synchroniz" in str(w.message) for w in seen)
            torch.cuda.synchronize()
            if calls["all_gather"] != 2:
                fail(f"the {name} bundle took {calls['all_gather']} all_gather calls, expected 2")
            for leaf, members in zip(leaves, gathered):
                got = members[0] if len(members) == 1 else None
                if got is None or got.device != leaf.device or got.dtype != leaf.dtype or not torch.equal(got, leaf):
                    fail(f"the {name} bundle did not come back bit-identical on the card")
            payload = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
            out[name] = {"leaves": len(leaves), "payload_bytes": payload, "all_gather": 2,
                         "synchronizing_calls": host_syncs}
            print(f"[sync] {name}: {len(leaves)} leaves, {payload} bytes, 2 all_gather calls, bit-identical on "
                  f"the card; synchronizing calls seen by the sync debug mode: {host_syncs}")

        sync = observability.snapshot()["sync"]
        rounds = {b: sum(s.bucket == b for s in observability.TRACER.records())
                  for b in ("descriptor", "payload", "transport")}
        if (sync["gathers"], sync["descriptor_rounds"], sync["payload_rounds"]) != (2, 2, 2) or rounds != {
                "descriptor": 2, "payload": 2, "transport": 2}:
            fail(f"the two bundles' gathers recorded {sync['gathers']} gathers, {sync['descriptor_rounds']} "
                 f"descriptor and {sync['payload_rounds']} payload rounds, spans {rounds}; expected 2 of each")
        out["telemetry"] = {k: sync[k] for k in ("gathers", "gather_leaves", "descriptor_rounds", "payload_rounds",
                                                 "payload_bytes_out", "transport_bytes")}
        out["telemetry"]["spans"] = rounds
        print(f"[sync] telemetry of the two gathers: {json.dumps(out['telemetry'], sort_keys=True)}")

        state, reductions = {}, {}
        for n, m in gpu.items(keep_base=True):
            for k, v in m._get_states().items():
                state[f"{n}.{k}"], reductions[f"{n}.{k}"] = v, m._reductions[k]
        buckets = len({(reductions[k], v.dtype) for k, v in state.items()})
        calls["all_reduce"] = 0
        synced = mdist.sync_state_packed(state, reductions, dist.group.WORLD)
        torch.cuda.synchronize()
        if calls["all_reduce"] != buckets:
            fail(f"sync_state_packed made {calls['all_reduce']} all_reduce calls for {buckets} buckets")
        for k, v in state.items():
            if synced[k].device != v.device or synced[k].dtype != v.dtype or not torch.equal(synced[k], v):
                fail(f"sync_state_packed changed {k} at world size 1")
        out["packed"] = {"leaves": len(state), "buckets": buckets, "all_reduce": calls["all_reduce"]}

        leaves = mdist._tree_leaves(bundles["imagenet_collection"], [])
        gather_ms, packed_ms = [], []
        for _ in range(49):
            start = time.perf_counter()
            mdist._gather_all_leaves(leaves, None)
            torch.cuda.synchronize()
            gather_ms.append((time.perf_counter() - start) * 1e3)
            start = time.perf_counter()
            mdist.sync_state_packed(state, reductions, dist.group.WORLD)
            torch.cuda.synchronize()
            packed_ms.append((time.perf_counter() - start) * 1e3)
        out["gather_ms"], out["sync_state_packed_ms"] = gather_ms, packed_ms
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(10):
                mdist._gather_all_leaves(leaves, None)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        busy_ms = _device_us(prof) / 1e3
        top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:6]
        out["profile"] = {"gathers": 10, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                          "top_device": [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total}
                                         for e in top]}
        print(f"[sync] 10 packed gathers of that bundle under the profiler: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f})")
        for row in out["profile"]["top_device"]:
            print(f"[sync]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
        print(f"[sync] ImageNet-1k collection bundle ({out['imagenet_collection']['leaves']} leaves, "
              f"{out['imagenet_collection']['payload_bytes']} bytes) over {out['backend']} at world size "
              f"{out['world_size']}: packed gather median {statistics.median(gather_ms):.3f} ms, "
              f"sync_state_packed ({buckets} all_reduce) median {statistics.median(packed_ms):.3f} ms, 49 reps, on {card}; one card cannot show a sync of two "
              f"ranks (the gloo tests hold two processes on the CPU)")
    finally:
        mdist._all_gather, dist.all_reduce = real_gather, real_reduce
        dist.destroy_process_group()
    return out


class _NoLedger:
    """A tenant ledger that notes nothing: phase 3g's keyed update without
    its ledger."""

    @staticmethod
    def note(counts) -> None:
        pass


_NO_LEDGER = _NoLedger()


def telemetry_cost(torch, M, dev, batches, keyed_batches, card) -> dict:
    """Phase 3g: the ImageNet-1k collection's forward and the keyed
    collection's update with telemetry on and off, interleaved call by call
    in this one process (the order alternates), over three passes of the 49
    forwards and one of the 50 updates; then the synchronizing calls of the
    49 forwards and of the 50 updates in each state, which must be equal,
    and come from the same lines, over two passes each (a first pass under
    the debug mode, not counted, takes what happens once)."""
    from metrics_tpu_torch import observability

    def timed(fn, *args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    coll, keyed = build_collection(M, dev), build_keyed(M, dev)
    coll(*batches[0])
    keyed.update(*keyed_batches[0])
    times = {"forward": {"on": [], "off": []}, "keyed_update": {"on": [], "off": []}}
    calls = [("forward", coll, args) for _ in range(3) for args in batches]
    calls += [("keyed_update", keyed.update, args) for args in keyed_batches]
    try:
        for i, (what, fn, args) in enumerate(calls):
            for state in (("on", "off") if i % 2 == 0 else ("off", "on")):
                observability.enable(state == "on")
                times[what][state].append(timed(fn, *args))
        # a first pass under the debug mode takes whatever it does once;
        # then off, on, on, off
        sites = {f"{what}_{state}": [] for what in ("forward", "keyed_update") for state in ("on", "off")}
        for state in ("warmup", "off", "on", "on", "off"):
            observability.enable(state != "off")
            forward_sites = sync_calls(torch, lambda: [coll(*args) for args in batches])
            keyed_sites = sync_calls(torch, lambda: [keyed.update(*args) for args in keyed_batches])
            if state != "warmup":
                sites[f"forward_{state}"] += forward_sites
                sites[f"keyed_update_{state}"] += keyed_sites
    finally:
        observability.enable()
    # the tenant ledger alone: telemetry on, the keyed collection's ledger
    # swapped for one that notes nothing, call by call (the order alternates),
    # over two passes of the 50 updates
    ledger = keyed._traffic
    ledger_times = {"with": [], "without": []}
    for i, args in enumerate(keyed_batches * 2):
        for state in (("with", "without") if i % 2 == 0 else ("without", "with")):
            keyed._traffic = ledger if state == "with" else _NO_LEDGER
            ledger_times[state].append(timed(keyed.update, *args))
    keyed._traffic = ledger
    syncs = {k: len(v) // 2 for k, v in sites.items()}  # per pass of the 49 forwards / 50 updates
    out = {"times_ms": times, "synchronizing_calls": syncs, "ledger_times_ms": ledger_times,
           "sync_sites": {k: {s: v.count(s) for s in sorted(set(v))} for k, v in sites.items()}}
    with_l, without_l = (statistics.median(ledger_times[k]) for k in ("with", "without"))
    out["keyed_update_ledger"] = {"with_median_ms": with_l, "without_median_ms": without_l,
                                  "ratio": with_l / without_l, "pairs": len(ledger_times["with"])}
    print(f"[telemetry] keyed_update with telemetry on: median {with_l:.4f} ms with the tenant ledger, "
          f"{without_l:.4f} ms without, ratio {with_l / without_l:.4f} over {len(ledger_times['with'])} "
          f"interleaved pairs, on {card}")
    for what, t in times.items():
        on, off = statistics.median(t["on"]), statistics.median(t["off"])
        out[what] = {"on_median_ms": on, "off_median_ms": off, "ratio": on / off, "pairs": len(t["on"])}
        print(f"[telemetry] {what}: median {on:.4f} ms on, {off:.4f} ms off, ratio {on / off:.4f} over "
              f"{len(t['on'])} interleaved pairs, on {card}")
    print(f"[telemetry] synchronizing calls (sync debug mode): 49 forwards {syncs['forward_on']} on / "
          f"{syncs['forward_off']} off; 50 keyed updates {syncs['keyed_update_on']} on / {syncs['keyed_update_off']} off")
    for what in ("forward", "keyed_update"):
        if sorted(sites[f"{what}_on"]) != sorted(sites[f"{what}_off"]):
            fail(f"telemetry changes the synchronizing calls of the {what}s: {syncs}; sites on "
                 f"{out['sync_sites'][what + '_on']}, off {out['sync_sites'][what + '_off']}")
    return out


def make_keyed_batches(torch, device):
    """The 50 seeded 4096-row mixed batches of the keyed path: ``(tenant ids,
    softmax rows, int64 targets)``; the last holds 3000 real rows and is
    padded with id -1 and zero rows, as a ragged last cohort is."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    batches = []
    rows = torch.arange(KEYED_ROWS, device=device)
    for step in range(KEYED_UPDATES):
        ids = torch.randint(0, KEYED_TENANTS, (KEYED_ROWS,), generator=gen, device=device)
        target = torch.randint(0, KEYED_CLASSES, (KEYED_ROWS,), generator=gen, device=device)
        logits = torch.randn((KEYED_ROWS, KEYED_CLASSES), generator=gen, device=device)
        logits[rows, target] += 2.0
        preds = torch.softmax(logits, dim=1)
        if step == KEYED_UPDATES - 1:
            ids[KEYED_LAST_REAL:] = -1
            preds[KEYED_LAST_REAL:] = 0.0
            target[KEYED_LAST_REAL:] = 0
        batches.append((ids, preds, target))
    return batches


def build_keyed(M, device):
    kw = dict(average="macro", num_classes=KEYED_CLASSES, device=device)
    return M.MultiTenantCollection({
        "Accuracy": M.Accuracy(device=device),
        "Precision": M.Precision(**kw),
        "Recall": M.Recall(**kw),
        "F1": M.F1(**kw),
    }, num_tenants=KEYED_TENANTS, validate_ids=False, device=device)


def scatter_inputs(torch, gen, dev, r, s, d, floats=False, ids_dtype=None, offset=0):
    """Rows (integer-valued, or normal floats) that start ``offset`` floats
    into their buffer (1 leaves them 4-byte aligned, 2 8-byte aligned), and
    ids (int64, or ``ids_dtype``) uniform in [0, s) with -1, s and s+7 mixed
    in."""
    n = r * d
    if floats:
        buf = torch.randn((n + offset,), generator=gen, device=dev)
    else:
        buf = torch.randint(-2, 3, (n + offset,), generator=gen, device=dev).float()
    rows = buf[offset:offset + n].view(r, d)
    ids = torch.randint(0, s, (r,), generator=gen, device=dev)
    ids[0::97], ids[1::97], ids[2::97] = -1, s, s + 7
    return rows, ids if ids_dtype is None else ids.to(ids_dtype)


def special_rows(torch, dev):
    """NaN, signed zeros and infinities, routed so each case has a segment."""
    nan, inf = float("nan"), float("inf")
    cases = [(nan, 0), (1.0, 0), (2.0, 1), (nan, 1), (-0.0, 2), (0.0, 2), (0.0, 3), (-0.0, 3), (-0.0, 4),
             (0.0, 5), (inf, 6), (1.0, 6), (-inf, 7), (-1.0, 7), (inf, 8), (-inf, 8), (5.0, -1), (5.0, 12)]
    rows = torch.tensor([[v, -v] for v, _ in cases], device=dev)
    ids = torch.tensor([sid for _, sid in cases], device=dev)
    return rows, ids, 12  # segments 9..11 get no row


def scatter_host_pieces(torch, dev, ids):
    """The host-side pieces of the B3 and B4 wrappers at the keyed path's
    shapes (rows (4096, 40) and (4096, 1), 10,000 segments), each timed
    alone by :func:`host_us`, then the whole wrappers. The parent design's
    pieces (fills, the device context, the ``Stream`` object, the uncached
    capability query) are timed beside the pieces that replace them."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels import segment_scatter as ss
    from metrics_tpu_torch.utilities.data import resolve_device

    s, d = KEYED_TENANTS, 40
    rows = torch.zeros((KEYED_ROWS, d), device=dev)
    rows1 = torch.zeros((KEYED_ROWS, 1), device=dev)
    out = torch.empty((s, d), device=dev)
    counts = torch.empty(s, dtype=torch.int32, device=dev)
    launch = _common.kernel_function(ss._ENTRY, ss._ARGTYPES)
    stream = _common.current_stream_handle(dev)
    args = (rows.data_ptr(), ids.data_ptr(), KEYED_ROWS, d, s, 8, ss._ADD, 4, out.data_ptr(), counts.data_ptr(),
            dev.index, stream)

    def device_context():
        with torch.cuda.device(dev):
            pass

    return [
        ("kernel_device (resolved device)", lambda: _common.kernel_device(dev)),
        ("parent: resolve_device", lambda: resolve_device(dev)),
        ("_check (capability cached)", lambda: ss._check("segment_scatter_add", rows, ids, s, dev)),
        ("require_capability (cached)", lambda: _common.require_capability(dev)),
        ("torch.empty(S, 40) float32", lambda: torch.empty(s, d, dtype=torch.float32, device=dev)),
        ("torch.empty((S, 40)) float32, shape as a tuple", lambda: torch.empty((s, d), dtype=torch.float32,
                                                                              device=dev)),
        ("torch.empty(S) int32", lambda: torch.empty(s, dtype=torch.int32, device=dev)),
        ("data_ptr x4 + element_size", lambda: (rows.data_ptr(), ids.data_ptr(), out.data_ptr(), counts.data_ptr(),
                                                ids.element_size())),
        ("vector_width", lambda: ss.vector_width(d, args[0] | args[8])),
        ("kernel_function lookup", lambda: _common.kernel_function(ss._ENTRY, ss._ARGTYPES)),
        ("current_stream_handle", lambda: _common.current_stream_handle(dev)),
        ("ctypes call, S = 0 (returns early in C)", lambda: launch(*args[:4], 0, *args[5:])),
        ("ctypes call, D = 40 (device scope, one cooperative launch)", lambda: launch(*args)),
        ("launch counter", lambda: _common.note_kernel_dispatch("host_pieces_probe", "cuda")),
        ("segment_scatter_add_cuda D=40, whole", lambda: ss.segment_scatter_add_cuda(rows, ids, s, device=dev)),
        ("segment_scatter_max_cuda D=1, whole", lambda: ss.segment_scatter_max_cuda(rows1, ids, s, device=dev)),
        ("parent: torch.cuda.get_device_capability", lambda: torch.cuda.get_device_capability(dev)),
        ("parent: torch.zeros (S, 40) float32", lambda: torch.zeros((s, d), dtype=torch.float32, device=dev)),
        ("parent: torch.zeros (S,) int32", lambda: torch.zeros(s, dtype=torch.int32, device=dev)),
        ("parent: torch.full (S, 1) -inf", lambda: torch.full((s, 1), float("-inf"), device=dev)),
        ("parent: torch.cuda.device context", device_context),
        ("parent: torch.cuda.current_stream(dev).cuda_stream", lambda: torch.cuda.current_stream(dev).cuda_stream),
    ]


def hist_host_pieces(torch, dev, scores, onehot, ids):
    """The host-side pieces of the B5 wrapper at the curve path's shape
    (scores (1024, 1000), 2048 bins), each timed alone by :func:`host_us`,
    then the whole wrapper with dense labels and with class ids. The earlier
    design's pieces (the zero fill, the views on return, the device context,
    ``resolve_device``, the one-hot of the ids) are timed beside the pieces
    that replace them."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels import binned_counts as bc
    from metrics_tpu_torch.utilities.data import resolve_device, to_onehot

    n, c = scores.shape
    b, cells = NUM_BINS, c * NUM_BINS
    plan = bc.histogram_plan(n, c, b, _common.sm_count(dev))
    pos, neg = torch.empty(c, b, device=dev), torch.empty(c, b, device=dev)
    clipped = torch.empty((), device=dev)
    out = torch.empty(2 * cells + 1, device=dev)
    launch = _common.kernel_function(bc._ENTRY, bc._ARGTYPES)
    stream = _common.current_stream_handle(dev)
    args = (scores.data_ptr(), onehot.data_ptr(), 0, n, c, b, 0.0, 1.0, 1.0, plan.mode, plan.k, plan.chunks,
            plan.threads, 4, pos.data_ptr(), neg.data_ptr(), clipped.data_ptr(), dev.index, stream)

    def device_context():
        with torch.cuda.device(dev):
            pass

    return [
        ("kernel_device (resolved device)", lambda: _common.kernel_device(dev)),
        ("_check (dense labels)", lambda: bc._check(scores, onehot, True, b, 0.0, 1.0, dev)),
        ("input qualifies: dtype and is_contiguous reads", lambda: (scores.dtype == torch.float32
                                                                     and scores.is_contiguous()
                                                                     and onehot.is_contiguous())),
        ("histogram_plan (cached) + sm_count", lambda: bc.histogram_plan(n, c, b, _common.sm_count(dev))),
        ("torch.empty(C, B) x2 + torch.empty(())", lambda: (torch.empty(c, b, dtype=torch.float32, device=dev),
                                                            torch.empty(c, b, dtype=torch.float32, device=dev),
                                                            torch.empty((), dtype=torch.float32, device=dev))),
        ("torch.empty(2, C, B).unbind(0) + torch.empty(())", lambda: (
            torch.empty(2, c, b, dtype=torch.float32, device=dev).unbind(0),
            torch.empty((), dtype=torch.float32, device=dev))),
        ("data_ptr x5 + load_width", lambda: (bc.load_width(c, plan.k, scores.data_ptr() | onehot.data_ptr()),
                                              pos.data_ptr(), neg.data_ptr(), clipped.data_ptr())),
        ("ctypes call, C = 0 (one 4-byte memset in C)", lambda: launch(*args[:4], 0, *args[5:])),
        ("ctypes call (device scope, 4-byte memset, one launch)", lambda: launch(*args)),
        ("launch counter", lambda: _common.note_kernel_dispatch("host_pieces_probe", "cuda")),
        ("label_score_histograms_cuda, dense labels, whole", lambda: bc.label_score_histograms_cuda(
            scores, onehot, b, device=dev)),
        ("_label_score_histograms_onevsrest, class ids, whole", lambda: bc._label_score_histograms_onevsrest(
            scores, ids, b)),
        ("earlier: resolve_device", lambda: resolve_device(dev)),
        ("earlier: .to(float32).contiguous() on inputs that qualify", lambda: (scores.to(torch.float32).contiguous(),
                                                                                 onehot.contiguous())),
        ("earlier: torch.zeros(2 * C * B + 1)", lambda: torch.zeros(2 * cells + 1, dtype=torch.float32, device=dev)),
        ("earlier: torch.cuda.device context", device_context),
        ("earlier: three views of one buffer on return", lambda: (out[:cells].view(c, b),
                                                                   out[cells:2 * cells].view(c, b), out[2 * cells])),
        ("earlier: to_onehot(ids.to(int32), C) before the dense call", lambda: to_onehot(ids.to(torch.int32), c)),
    ]


def build_curves(M, device):
    kw = dict(num_classes=NUM_CLASSES, sketched=True, num_bins=NUM_BINS, compute_on_step=False, device=device)
    return M.MetricCollection({"AUROC": M.AUROC(**kw), "AveragePrecision": M.AveragePrecision(**kw)})


def build_stream(M, device):
    kw = dict(sketched=True, num_bins=NUM_BINS, device=device)
    return {"AUROC": M.AUROC(**kw), "ROC": M.ROC(**kw), "PrecisionRecallCurve": M.PrecisionRecallCurve(**kw)}


def make_stream(torch, device):
    """The 100 seeded chunks of the binary scorer stream: uniform scores,
    labels Bernoulli(score), int64."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    chunks = []
    for _ in range(STREAM_UPDATES):
        scores = torch.rand(STREAM_CHUNK, generator=gen, device=device)
        labels = (torch.rand(STREAM_CHUNK, generator=gen, device=device) < scores).long()
        chunks.append((scores, labels))
    return chunks


def edge_scores(torch, dev, b, lo, hi):
    """Every bin edge of the grid with its float32 neighbours, then NaN,
    +-inf, signed zeros, subnormals and scores outside [lo, hi]."""
    edges = (lo + (hi - lo) * torch.arange(b + 1, dtype=torch.float64, device=dev) / b).float()
    up = torch.nextafter(edges, torch.full_like(edges, float("inf")))
    down = torch.nextafter(edges, torch.full_like(edges, float("-inf")))
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e-45, -1e-45, -1e-39, -1e-30,
                            lo - 1.0, hi + 1.0], device=dev)
    return torch.cat([edges, up, down, special])


def trees_equal(torch, got, want) -> bool:
    """Equal structure and dtypes, values equal exactly."""
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(trees_equal(torch, g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and got.shape == want.shape and bool(torch.equal(got.cpu(), want))


def tree_max_diff(torch, got, want) -> float:
    """Largest |got - want| over a (nested) tuple of tensors; raises on a shape or NaN mismatch."""
    if isinstance(want, (list, tuple)):
        return max(tree_max_diff(torch, g, w) for g, w in zip(got, want))
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got.isnan(), want.isnan()):
        fail(f"{tuple(got.shape)} {got.dtype} on the card against {tuple(want.shape)} {want.dtype} on the CPU, "
             "or NaN in other places")
    return float(torch.nan_to_num(got - want).abs().max()) if got.numel() else 0.0


def finite_max_diff(torch, label, got, want) -> tuple:
    """:func:`tree_max_diff`, and how many finite values it compared: fails
    where there is none, since NaN against NaN passes it on any output."""
    diff = tree_max_diff(torch, got, want)
    finite = sum(int(torch.isfinite(w).sum()) for w in (want if isinstance(want, (list, tuple)) else (want,)))
    if not finite:
        fail(f"{label}: no finite value to compare with the CPU's")
    return diff, finite


def profile_steps(torch, step, inputs):
    """Wall time, device busy time and the top device rows of ``step`` over ``inputs``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for args in inputs:
            step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms = _device_us(prof) / 1e3
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:10]
    breakdown = [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total} for e in top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "top_device": breakdown}


KERNEL_OPS = ("stat_scores_counts", "confmat_counts", "segment_scatter_add", "segment_scatter_max",
              "segment_scatter_min", "label_score_histograms", "segment_merge")


def check_telemetry(phase, pairs):
    """After a phase: ``observability.snapshot()["kernels"]`` must count each
    op's launches as ``launch_count`` does, and each object driven on the
    card must hold the counters and info blobs of its twin driven on the CPU
    through the same calls. Returns the card objects' counters."""
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.kernels import _common

    snap = observability.snapshot()
    dispatch = snap["kernels"]["dispatch"]
    for op in KERNEL_OPS:
        if dispatch.get(op, {}).get("cuda", 0) != _common.launch_count(op):
            fail(f"[{phase}] snapshot()['kernels'] counts {dispatch.get(op)} for {op}, launch_count "
                 f"{_common.launch_count(op)}")
    counters = {}
    for label, card_obj, cpu_obj in pairs:
        got = snap["metrics"].get(card_obj.telemetry_key, {})
        want = snap["metrics"].get(cpu_obj.telemetry_key, {})
        if got.get("counters", {}) != want.get("counters", {}) or got.get("info", {}) != want.get("info", {}):
            fail(f"[{phase}] telemetry of {label} on the card {got.get('counters')} {got.get('info')} differs from "
                 f"the CPU run's {want.get('counters')} {want.get('info')}")
        counters[label] = got.get("counters", {})
    launched = {op: dispatch[op]["cuda"] for op in KERNEL_OPS if dispatch.get(op, {}).get("cuda")}
    print(f"[{phase}] telemetry == CPU run's for {len(pairs)} objects; snapshot kernels (cuda) {launched}; "
          f"counters {json.dumps(counters, sort_keys=True)}")
    return counters


def sync_calls(torch, fn) -> list:
    """Where the sync debug mode reports a synchronizing call while ``fn``
    runs: one ``"file:line"`` per call (the mode's own notice that it is a
    prototype, raised as it is switched on, is not a call)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in seen
            if "synchroniz" in str(w.message) and "prototype feature" not in str(w.message)]


def _host_cohorts(keyed_batches):
    """Phase 3b's cohorts as host numpy, the last one cut to its real rows."""
    host = [tuple(t.cpu().numpy() for t in batch) for batch in keyed_batches]
    host[-1] = tuple(a[:KEYED_LAST_REAL] for a in host[-1])
    return host


def check_ledger(phase, q, routed):
    """Both conservation laws of the queue's exact ledger, no dispatch error,
    and ``submitted - shed`` == the rows the keyed state ingested."""
    s = q.stats()
    reasons = s["shed_by_reason"]
    post = sum(reasons.get(k, 0) for k in ("shed_oldest", "dispatch_error", "poisoned", "breaker_open"))
    if s["admitted"] != s["dispatched"] + s["resident"] + post:
        fail(f"[{phase}] admitted != dispatched + resident + shed after admission: {s}")
    if s["submitted"] - s["shed"] != s["dispatched"] + s["resident"]:
        fail(f"[{phase}] submitted - shed != dispatched + resident: {s}")
    if reasons.get("dispatch_error", 0) or q._last_error is not None:
        fail(f"[{phase}] a dispatch failed: {s['last_error']} ({reasons})")
    if s["submitted"] - s["shed"] != routed:
        fail(f"[{phase}] submitted - shed = {s['submitted'] - s['shed']}, the tenant report routed {routed}")
    return s


def serving_replay(torch, M, dev, keyed_batches, keyed_gpu, keyed_out, direct_ms, card) -> dict:
    """Phase 3h-a: phase 3b's cohorts through an admission queue, unstaged
    and staged; states == phase 3b's direct updates, launches, ledger, and
    the synchronizing calls of a flush against a direct update's."""
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.serving import AdmissionQueue

    host = _host_cohorts(keyed_batches)
    real_rows = sum(len(c[0]) for c in host)
    out = {"direct_update_median_ms": direct_ms}
    for path in ("unstaged", "staged", "prefetched"):
        keyed = build_keyed(M, dev)
        flusher = path == "prefetched"
        q = AdmissionQueue(keyed.update, start=False, max_batch=KEYED_ROWS, pad_to_bucket=True,
                           staging=path != "unstaged", max_delay_ms=1000.0, capacity_rows=len(host) * KEYED_ROWS)
        torch.cuda.synchronize()
        _common.reset_dispatch_counters()
        flush_ms = []
        if flusher:
            # every cohort resident, then the flusher started: each
            # size-triggered flush pops one cohort and prefetches the next on
            # the staging lane, so a flush carries one of phase 3b's cohorts
            start = time.perf_counter()
            for ids, preds, target in host:
                q.submit_many(ids, preds, target)
            submit_ms = (time.perf_counter() - start) * 1e3
            start = time.perf_counter()
            q._ensure_flusher()
            if not q.drain(timeout=120):
                fail("[replay prefetched] the queue did not drain")
            torch.cuda.synchronize()
            flush_ms.append((time.perf_counter() - start) * 1e3 / q.stats()["flushes"])
        else:
            for ids, preds, target in host:
                q.submit_many(ids, preds, target)
                torch.cuda.synchronize()
                start = time.perf_counter()
                q.flush()
                torch.cuda.synchronize()
                flush_ms.append((time.perf_counter() - start) * 1e3)
        launches = {op: _common.launch_count(op) for op in ("segment_merge", "segment_scatter_add",
                                                           "segment_scatter_max", "segment_scatter_min",
                                                           "stat_scores_counts")}
        want = {"segment_merge": KEYED_UPDATES, "segment_scatter_add": 0, "segment_scatter_max": 0,
                "segment_scatter_min": 0, "stat_scores_counts": KEYED_UPDATES}
        if launches != want:
            fail(f"[replay {path}] launches {launches}, expected {want}")
        for owner, km in keyed._keyed.items():
            for name, value in km._get_states().items():
                if not torch.equal(value, getattr(keyed_gpu._keyed[owner], name)):
                    fail(f"[replay {path}] state {owner}.{name} differs from phase 3b's direct updates")
        values = keyed.compute()
        diffs = {name: tree_max_diff(torch, values[name], keyed_out[name].cpu()) for name in keyed_out}
        if max(diffs.values()) > 1e-6:
            fail(f"[replay {path}] values differ from phase 3b's by {diffs}")
        report = keyed.tenant_report()
        if report["rows_routed"] != real_rows or report["invalid_tenant_ids"] != KEYED_ROWS - KEYED_LAST_REAL:
            fail(f"[replay {path}] the tenant report routes {report['rows_routed']} rows (expected {real_rows}) and "
                 f"counts {report['invalid_tenant_ids']} invalid ids (expected {KEYED_ROWS - KEYED_LAST_REAL})")
        stats = check_ledger(f"replay {path}", q, report["rows_routed"])
        if stats["flushes"] != KEYED_UPDATES:
            fail(f"[replay {path}] {stats['flushes']} flushes, expected one per cohort ({KEYED_UPDATES})")
        if flusher:
            staging = stats["staging"]
            if not staging["prefetched_cohorts"]:
                fail(f"[replay prefetched] no cohort was prefetched: {staging}")
            q.close(timeout=30)
            print(f"[replay prefetched] {len(host)} cohorts resident ({submit_ms:.1f} ms to submit), then the flusher "
                  f"on {card}: {flush_ms[0]:.3f} ms per flush from its start to drain; {staging['prefetched_cohorts']} "
                  f"of {staging['staged_cohorts']} cohorts prefetched on the staging lane, overlap "
                  f"{staging['overlap_seconds']:.4f} s of {staging['stage_seconds']:.4f} s staging; launches "
                  f"{launches}; states == phase 3b's, values max |diff| {max(diffs.values()):.2e}")
            out[path] = {"flush_ms_mean": flush_ms[0], "submit_ms": submit_ms, "launches": launches, "max_abs_diff": diffs, "ledger": stats}
            del keyed
            continue
        # synchronizing calls: three more (warm) flushes against a direct
        # update of the same cohorts on device tensors
        direct = build_keyed(M, dev)
        direct.update(*(torch.from_numpy(a).to(dev) for a in host[0]))
        flush_sites, direct_sites = [], []
        for ids, preds, target in host[:3]:
            q.submit_many(ids, preds, target)
            flush_sites.append(sorted(sync_calls(torch, q.flush)))
            args = [torch.from_numpy(a).to(dev) for a in (ids.astype("int32"), preds, target)]
            torch.cuda.synchronize()
            direct_sites.append(sorted(sync_calls(torch, lambda: direct.update(*args))))
        q.close()
        if path == "staged" and flush_sites != direct_sites:
            fail(f"[replay staged] a staged flush makes other synchronizing calls than a direct update: "
                 f"{flush_sites} against {direct_sites}")
        sites = {site: flush_sites[0].count(site) for site in sorted(set(flush_sites[0]))}
        med = statistics.median(flush_ms)
        print(f"[replay {path}] {len(host)} flushes of phase 3b's cohorts on {card}: flush median {med:.3f} ms "
              f"(first {flush_ms[0]:.3f} ms; phase 3b's direct update median {direct_ms:.3f} ms); launches {launches}; "
              f"states == phase 3b's, values max |diff| {max(diffs.values()):.2e}; rows_routed {real_rows}, invalid ids "
              f"{report['invalid_tenant_ids']}; synchronizing calls per flush {len(flush_sites[0])} at {sites} "
              f"(a direct update: {len(direct_sites[0])})")
        out[path] = {"flush_ms": flush_ms, "flush_median_ms": med, "launches": launches, "max_abs_diff": diffs,
                     "sync_calls_per_flush": len(flush_sites[0]), "sync_sites": sites,
                     "direct_update_sync_calls": len(direct_sites[0]), "ledger": stats}
        del keyed, direct
    observability.reset()
    return out


def _ms(value) -> str:
    return "none" if value is None else f"{value:.3f}"


def serving_soak(torch, M, dev, staging, card, seconds: float = SOAK_SECONDS) -> dict:
    """Phase 3h-b: the soak at its full width for ``seconds``; every check
    of the module docstring; returns the run's record. An SLO on the ingest
    histogram at the soak's 100 ms p99 objective (``scripts/soak.py:60``) is
    ticked by the reader each second (phase 3n-d reads its burn rates)."""
    import threading

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch import observability
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.observability.histogram import HISTOGRAMS
    from metrics_tpu_torch.serving import SERVING_STATS, SLOScheduler

    label = "soak staged" if staging else "soak unstaged"
    rng = np.random.default_rng(SEED + 8)
    per_producer = int(SOAK_RATE * seconds) // SOAK_PRODUCERS // SOAK_COHORT * SOAK_COHORT
    data = []
    for _ in range(SOAK_PRODUCERS):
        scores = rng.random(per_producer, dtype=np.float32)
        data.append((rng.integers(0, SOAK_TENANTS, per_producer), scores,
                     (rng.random(per_producer) < scores).astype(np.int32)))
    keyed = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=SOAK_TENANTS, validate_ids=False, device=dev)
    dispatched = []  # host copies of every cohort the scheduler dispatched
    real_update = keyed.update

    def recorded_update(ids, *cols):
        dispatched.append([np.array(a) for a in (ids, *cols)])
        real_update(ids, *cols)

    keyed.update = recorded_update
    observability.reset()
    observability.SLO_REGISTRY.declare(name="ingest_p99", series="serving_ingest_seconds", threshold=SOAK_SLO_S,
                                       percentile=99.0, labels={"policy": "shed_oldest"})
    slo_ticks = []  # the watchdog's statuses, one a second
    svc = SLOScheduler(keyed, max_batch=SOAK_MAX_BATCH, max_delay_ms=SOAK_DELAY_MS, policy="shed_oldest",
                       max_staleness_s=1.0, pad_to_bucket=True, staging=staging)
    # one warm cohort through, and a first read that installs the cache
    svc.submit_many(data[0][0][:SOAK_COHORT], data[0][1][:SOAK_COHORT], data[0][2][:SOAK_COHORT])
    if not svc.drain(timeout=60):
        fail(f"[{label}] the warm cohort did not drain")
    svc.read(np.arange(SOAK_READ_TENANTS))
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    flushes_before = svc.queue.stats()["flushes"]
    interval = SOAK_PRODUCERS * SOAK_COHORT / SOAK_RATE
    t0 = time.perf_counter() + 0.05
    stop = threading.Event()
    errors = []

    def producer(k):
        try:
            ids, scores, targets = data[k]
            for i in range(per_producer // SOAK_COHORT):
                delay = t0 + (i + k / SOAK_PRODUCERS) * interval - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                rows = slice(i * SOAK_COHORT, (i + 1) * SOAK_COHORT)
                svc.submit_many(ids[rows], scores[rows], targets[rows])
        except Exception as err:  # noqa: BLE001 - failed below
            errors.append(err)

    read_ms = []  # each read's wall time, on the reader's thread
    read_span = []

    def reader():
        try:
            rrng = np.random.default_rng(SEED + 9)
            begun = time.perf_counter()
            while not stop.wait(1.0):
                tenants = rrng.choice(SOAK_TENANTS, SOAK_READ_TENANTS, replace=False)
                start = time.perf_counter()
                values = svc.read(tenants)
                read_ms.append((time.perf_counter() - start) * 1e3)
                if values.shape != (SOAK_READ_TENANTS,):
                    errors.append(ValueError(f"a read returned {values.shape}"))
                status = observability.WATCHDOG.tick().get("ingest_p99")
                if status is not None:
                    slo_ticks.append({"t_s": time.perf_counter() - begun, "fast_burn": status["fast"]["burn_rate"],
                                      "slow_burn": status["slow"]["burn_rate"], "window_p_ms": status["window_p"] * 1e3,
                                      "fast_total": status["fast"]["total"], "breached": status["breached"]})
            read_span.append(time.perf_counter() - begun)
        except Exception as err:  # noqa: BLE001 - failed below
            errors.append(err)

    threads = [threading.Thread(target=producer, args=(k,)) for k in range(SOAK_PRODUCERS)]
    read_thread = threading.Thread(target=reader)
    for t in threads + [read_thread]:
        t.start()
    time.sleep(max(0.0, t0 + seconds / 2 - 0.5 - time.perf_counter()))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window_start = time.perf_counter()
        time.sleep(1.0)
        window_ms = (time.perf_counter() - window_start) * 1e3
    for t in threads:
        t.join(timeout=seconds + 60)
    submit_s = time.perf_counter() - t0
    drained = svc.drain(timeout=120)
    drain_s = time.perf_counter() - t0
    stop.set()
    read_thread.join(timeout=60)
    if any(t.is_alive() for t in threads + [read_thread]) or not drained or errors:
        fail(f"[{label}] producers or reader did not finish, or the queue did not drain: {errors}")
    busy_ms = _device_us(prof) / 1e3
    stats = check_ledger(label, svc.queue, keyed.tenant_report()["rows_routed"])
    serving = SERVING_STATS.summary()
    for counter, field in (("submitted_rows", "submitted"), ("admitted_rows", "admitted"), ("shed_rows", "shed"),
                           ("dispatched_rows", "dispatched"), ("flushes", "flushes")):
        if serving[counter] != stats[field]:
            fail(f"[{label}] serving.{counter} = {serving[counter]}, the queue's ledger {field} = {stats[field]}")
    if serving["shed_by_reason"] != stats["shed_by_reason"]:
        fail(f"[{label}] serving.shed_by_reason {serving['shed_by_reason']} != {stats['shed_by_reason']}")
    window_flushes = stats["flushes"] - flushes_before
    launches = {op: _common.launch_count(op) for op in ("segment_merge", "segment_scatter_add", "segment_scatter_max")}
    if launches != {"segment_merge": window_flushes, "segment_scatter_add": 0, "segment_scatter_max": 0}:
        fail(f"[{label}] launches {launches} over {window_flushes} flushes")
    svc.close(timeout=30)
    # the keyed state == a CPU KeyedMetric given every dispatched cohort in one update
    ids, scores, targets = (np.concatenate(col) for col in zip(*dispatched))
    if int((ids >= 0).sum()) != stats["dispatched"]:
        fail(f"[{label}] the dispatched cohorts hold {int((ids >= 0).sum())} real rows, the ledger {stats['dispatched']}")
    ref = M.KeyedMetric(M.Accuracy(device="cpu"), num_tenants=SOAK_TENANTS, validate_ids=False, device="cpu")
    ref.update(torch.from_numpy(ids), torch.from_numpy(scores), torch.from_numpy(targets))
    for name, value in keyed._get_states().items():
        if not torch.equal(value.cpu(), getattr(ref, name)):
            fail(f"[{label}] keyed state {name} differs from the CPU's over the dispatched rows")

    def pct(name, q):
        return HISTOGRAMS.get(name, unit="s", policy="shed_oldest").percentile(q) * 1e3

    triggers = {k: v / submit_s for k, v in serving["flushes_by_trigger"].items()}
    reads = {k: serving[k] for k in ("reads", "cache_hits", "tenant_cache_hits", "stale_serves", "cache_misses",
                                     "refreshes", "coalesced_refreshes")}
    # a read is due each second the reader ran; one that takes longer delays the next
    reads_due = int(read_span[0])
    read_p50, read_p99 = (float(np.percentile(read_ms, q)) for q in (50, 99)) if read_ms else (None, None)
    out = {
        "submitted": stats["submitted"], "dispatched": stats["dispatched"], "shed_by_reason": stats["shed_by_reason"],
        "submit_seconds": submit_s, "drain_seconds": drain_s, "achieved_rows_per_s": stats["submitted"] / submit_s,
        "flushes": stats["flushes"], "flushes_per_s_by_trigger": triggers,
        "rows_per_flush": stats["dispatched"] / stats["flushes"],
        "ingest_p50_ms": pct("serving_ingest_seconds", 50), "ingest_p99_ms": pct("serving_ingest_seconds", 99),
        "queue_wait_p50_ms": pct("serving_queue_wait_seconds", 50),
        "queue_wait_p99_ms": pct("serving_queue_wait_seconds", 99),
        "dispatch_p50_ms": pct("serving_dispatch_seconds", 50), "dispatch_p99_ms": pct("serving_dispatch_seconds", 99),
        "reads": reads, "reader_reads_done": len(read_ms), "reader_reads_due": reads_due, "read_ms": read_ms,
        "read_p50_ms": read_p50, "read_p99_ms": read_p99, "device_busy_ms": busy_ms, "window_ms": window_ms, "idle_share": 1 - busy_ms / window_ms,
        "launches": launches, "staging": stats["staging"], "slo_ticks": slo_ticks,
        "slo_breaches_total": observability.SLO_REGISTRY.summary()["breaches_total"],
    }
    staged = (f"; overlap {stats['staging']['overlap_seconds']:.4f} s over {stats['staging']['prefetched_cohorts']} "
              f"prefetched of {stats['staging']['staged_cohorts']} staged cohorts") if staging else ""
    print(f"[{label}] {seconds:.0f} s at {SOAK_RATE} rows/s on {card}: achieved {out['achieved_rows_per_s']:.1f} "
          f"rows/s submitted ({stats['submitted']} rows, drained {drain_s:.3f} s after start), {stats['flushes']} flushes "
          f"({out['rows_per_flush']:.1f} rows each), flushes/s by trigger "
          f"{ {k: round(v, 3) for k, v in triggers.items()} }; ingest p50 {out['ingest_p50_ms']:.3f} ms, p99 "
          f"{out['ingest_p99_ms']:.3f} ms (queue wait p50 {out['queue_wait_p50_ms']:.3f} / p99 "
          f"{out['queue_wait_p99_ms']:.3f}, dispatch p50 {out['dispatch_p50_ms']:.3f} / p99 {out['dispatch_p99_ms']:.3f}); "
          f"shed {stats['shed_by_reason']}; reader {len(read_ms)} reads done of {reads_due} due (one a second over "
          f"{read_span[0]:.3f} s), read wall time p50 {_ms(read_p50)} / p99 {_ms(read_p99)} ms; read outcomes "
          f"{reads}; device idle share {out['idle_share']:.4f} "
          f"({busy_ms:.3f} ms busy in {window_ms:.1f} ms){staged}; keyed state == CPU over the dispatched rows")
    observability.reset()
    return out



# --------------------------------------------------------------------------
# phase 3j: the regression slice
# --------------------------------------------------------------------------


def build_regression(M, device):
    """The regression stream's collection: every mode of the family that
    takes (N,) pairs."""
    return M.MetricCollection({
        "MSE": M.MeanSquaredError(device=device),
        "RMSE": M.MeanSquaredError(squared=False, device=device),
        "MAE": M.MeanAbsoluteError(device=device),
        "MAPE": M.MeanAbsolutePercentageError(device=device),
        "MSLE": M.MeanSquaredLogError(device=device),
        "ExplainedVariance": M.ExplainedVariance(device=device),
        "R2Score": M.R2Score(device=device),
        "Pearson": M.PearsonCorrcoef(device=device),
        "PearsonStreaming": M.PearsonCorrcoef(streaming=True, device=device),
        "Spearman": M.SpearmanCorrcoef(device=device),
        "SpearmanCapacity": M.SpearmanCorrcoef(capacity=REG_UPDATES * REG_CHUNK, device=device),
        "SpearmanSketched": M.SpearmanCorrcoef(sketched=True, num_bins=REG_BINS, value_range=REG_RANGE,
                                               device=device),
    })


#: the members whose state is fixed-shape, which the compiled step takes
REG_FIXED = ("MSE", "RMSE", "MAE", "MAPE", "MSLE", "ExplainedVariance", "R2Score", "PearsonStreaming",
             "SpearmanCapacity", "SpearmanSketched")


def build_regression_fixed(M, device):
    full = build_regression(M, device)
    return M.MetricCollection({name: full[name] for name in REG_FIXED})


def make_regression_stream(torch, device):
    """100 seeded chunks of 10,000 float32 pairs: log-normal targets (so MAPE
    and MSLE are defined), preds = target * (1 + N(0, 0.1)) clipped at 0;
    and 100 chunks of (10,000, 128) embeddings, preds = target + N(0, 0.5)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 10)
    pairs, embeddings = [], []
    for _ in range(REG_UPDATES):
        target = torch.exp(0.5 * torch.randn(REG_CHUNK, generator=gen, device=device))
        noise = torch.randn(REG_CHUNK, generator=gen, device=device)
        pairs.append((torch.clamp(target * (1 + 0.1 * noise), min=0.0), target))
        emb_t = torch.randn((REG_CHUNK, REG_DIM), generator=gen, device=device)
        emb_p = emb_t + 0.5 * torch.randn((REG_CHUNK, REG_DIM), generator=gen, device=device)
        embeddings.append((emb_p, emb_t))
    return pairs, embeddings


def _rel_diff(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _regression_oracle(np, preds, target):
    """The float64 numpy/scipy values of the stream's metrics."""
    from scipy.stats import pearsonr, spearmanr

    p, t = preds.astype(np.float64), target.astype(np.float64)
    diff = t - p
    mse = float(np.mean(diff ** 2))
    pearson = float(pearsonr(p, t).statistic)
    spearman = float(spearmanr(p, t).statistic)
    return {
        "MSE": mse, "RMSE": float(np.sqrt(mse)), "MAE": float(np.mean(np.abs(diff))),
        "MAPE": float(np.mean(np.abs(diff) / np.clip(np.abs(t), 1.17e-06, None))),
        "MSLE": float(np.mean((np.log1p(p) - np.log1p(t)) ** 2)),
        "ExplainedVariance": float(1 - np.var(diff) / np.var(t)),
        "R2Score": float(1 - np.sum(diff ** 2) / np.sum((t - t.mean()) ** 2)),
        "Pearson": pearson, "PearsonStreaming": pearson, "Spearman": spearman, "SpearmanCapacity": spearman,
    }


def _keyed_regression_cohorts(torch, keyed_batches, device):
    """Phase 3b's 50 cohorts of tenant ids with seeded float32 (preds,
    target) on a 2^-8 grid in [0, 4): every per-tenant sum of one update is
    exact in float32 and float64 in any order, so the card's atomics (whose
    order changes from run to run) and the CPU's loop give the same bits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 11)

    def grid(x):
        return torch.clamp(torch.floor(x * 256) / 256, 0.0, 4.0 - 1 / 256)

    cohorts = []
    for ids, _, _ in keyed_batches:
        target = torch.exp(0.5 * torch.randn(KEYED_ROWS, generator=gen, device=device))
        preds = target * (1 + 0.1 * torch.randn(KEYED_ROWS, generator=gen, device=device))
        cohorts.append((ids, grid(preds), grid(target)))
    return cohorts


def _regression_stream(torch, np, M, dev, card, _common, record) -> list:
    """Phase 3j-a: the stream through the 12 members and cosine, eagerly,
    against the CPU port and the float64 oracle. Returns the chunks."""
    pairs, embeddings = make_regression_stream(torch, dev)
    coll = build_regression(M, dev)
    cos = {"streaming": M.CosineSimilarity(reduction="mean", streaming=True, device=dev),
           "buffered": M.CosineSimilarity(reduction="mean", device=dev)}
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    fwd_ms, cos_ms = [], []
    for (preds, target), (emb_p, emb_t) in zip(pairs, embeddings):
        t0 = time.perf_counter()
        coll(preds, target)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for m in cos.values():
            m(emb_p, emb_t)
        torch.cuda.synchronize()
        fwd_ms.append((t1 - t0) * 1e3)
        cos_ms.append((time.perf_counter() - t1) * 1e3)
    t0 = time.perf_counter()
    out = coll.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    out.update({f"Cosine{k.title()}": m.compute() for k, m in cos.items()})
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    if any(launches.values()):
        fail(f"[regression] a kernel launched on the regression stream, which has none: {launches}")
    for name, value in out.items():
        if value.shape != () or not bool(torch.isfinite(value)):
            fail(f"[regression] {name}: {tuple(value.shape)} {value} is not a finite scalar")

    # the port on the CPU over the same chunks
    cpu = build_regression(M, "cpu")
    cos_cpu = {k: M.CosineSimilarity(reduction="mean", streaming=(k == "streaming"), device="cpu") for k in cos}
    for (preds, target), (emb_p, emb_t) in zip(pairs, embeddings):
        cpu.update(preds.cpu(), target.cpu())
        for m in cos_cpu.values():
            m.update(emb_p.cpu(), emb_t.cpu())
    cpu_out = cpu.compute()
    cpu_out.update({f"Cosine{k.title()}": m.compute() for k, m in cos_cpu.items()})
    diffs_cpu = {}
    for name, value in out.items():
        want = cpu_out[name]
        if value.dtype != want.dtype:
            fail(f"[regression] {name}: {value.dtype} on the card, {want.dtype} on the CPU")
        diffs_cpu[name] = _rel_diff(float(value), float(want))
        limit = 1e-12 if value.dtype == torch.float64 else 1e-5
        if diffs_cpu[name] > limit:
            fail(f"[regression] {name}: {float(value)} on the card, {float(want)} on the CPU (relative "
                 f"{diffs_cpu[name]:.2e} > {limit})")
    # the states: counts, the capacity buffer and the grid exactly, float64
    # moments within 1e-12 (float32 sums are held through the values above)
    for name, m in coll.items(keep_base=True):
        for leaf, value in m._get_states().items():
            if isinstance(value, list):
                continue
            want = getattr(cpu[name], leaf)
            if value.dtype != want.dtype or value.shape != want.shape:
                fail(f"[regression] state {name}.{leaf}: {value.dtype} {tuple(value.shape)} on the card, "
                     f"{want.dtype} {tuple(want.shape)} on the CPU")
            if not value.is_floating_point() or name in ("SpearmanCapacity", "SpearmanSketched"):
                if not torch.equal(value.cpu(), want):
                    fail(f"[regression] state {name}.{leaf} differs from the CPU's (counts and buffers exactly)")
            elif value.dtype == torch.float64:
                rel = float(((value.cpu() - want).abs() / want.abs().clamp(min=1e-30)).max())
                if rel > 1e-12:
                    fail(f"[regression] state {name}.{leaf} differs from the CPU's by {rel:.2e} (relative)")

    # the float64 numpy/scipy oracle
    oracle = _regression_oracle(np, torch.cat([p for p, _ in pairs]).cpu().numpy(),
                                torch.cat([t for _, t in pairs]).cpu().numpy())
    ep = torch.cat([p for p, _ in embeddings]).cpu().double().numpy()
    et = torch.cat([t for _, t in embeddings]).cpu().double().numpy()
    cos_oracle = float(np.mean(np.sum(ep * et, 1) / (np.linalg.norm(ep, axis=1) * np.linalg.norm(et, axis=1))))
    del ep, et
    oracle.update({"CosineStreaming": cos_oracle, "CosineBuffered": cos_oracle})
    diffs_oracle = {name: _rel_diff(float(out[name]), want) for name, want in oracle.items()}
    for name, d in diffs_oracle.items():
        if d > 1e-4:
            fail(f"[regression] {name}: {float(out[name])} on the card, float64 oracle {oracle[name]} "
                 f"(relative {d:.2e})")
    sketch_gap = abs(float(out["SpearmanSketched"]) - oracle["Spearman"])
    if sketch_gap > 1e-2:
        fail(f"[regression] sketched Spearman {float(out['SpearmanSketched'])} is {sketch_gap:.3e} from the exact "
             f"{oracle['Spearman']} (limit 1e-2)")
    clipped = float(coll["SpearmanSketched"].sketch_clipped)
    prof = profile_steps(torch, coll, pairs[:10])
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"[regression] {REG_UPDATES} forwards of {REG_CHUNK} pairs through 12 regression members on {card}: "
          f"forward median {statistics.median(fwd_ms):.3f} ms (first {fwd_ms[0]:.3f} ms), compute "
          f"{compute_ms:.3f} ms; cosine ({REG_CHUNK}, {REG_DIM}) both modes median {statistics.median(cos_ms):.3f} ms; "
          f"launches {launches}; 10 forwards under the profiler: wall {prof['wall_ms']:.3f} ms, busy "
          f"{prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    print(f"[regression] values { {k: round(float(v), 8) for k, v in out.items()} }")
    print(f"[regression] card == CPU port (max relative {max(diffs_cpu.values()):.2e}; float64 within 1e-12); == "
          f"float64 oracle (max relative {max(diffs_oracle.values()):.2e}, limit 1e-4); sketched Spearman "
          f"|rho - exact| {sketch_gap:.3e} (limit 1e-2, {clipped:.0f} clipped pairs)")
    for row in prof["top_device"][:6]:
        print(f"[regression]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    # the tie groups of the stream's 1,000,000 sorted preds: the port's cumsum
    # and scatter against the running max/min scans the JAX package uses
    from metrics_tpu_torch.utilities.data import tie_group_bounds

    keys = torch.sort(torch.cat([p for p, _ in pairs])).values
    changed = keys[1:] != keys[:-1]
    idx = torch.arange(keys.numel(), device=dev)
    n = keys.numel()

    def scans():
        one = torch.ones((1,), dtype=torch.bool, device=dev)
        start = torch.cummax(torch.where(torch.cat([one, changed]), idx, 0), dim=0).values
        end = torch.flip(torch.cummin(torch.flip(torch.where(torch.cat([changed, one]), idx, n - 1), (0,)), dim=0).values,
                         (0,))
        return start, end

    if not all(torch.equal(a, b) for a, b in zip(tie_group_bounds(changed), scans())):
        fail("[regression] the port's tie groups differ from the running max/min scans")
    tie_ms = {"cumsum_scatter": cuda_ms(lambda: tie_group_bounds(changed), reps=20),
              "cummax_cummin": cuda_ms(scans, reps=20)}
    print(f"[regression] tie groups of {n} sorted keys: cumsum + scatter {tie_ms['cumsum_scatter']:.3f} ms, "
          f"cummax + cummin {tie_ms['cummax_cummin']:.3f} ms (equal results)")
    record["stream"] = {"tie_groups_ms": tie_ms, "forward_ms": fwd_ms, "cosine_ms": cos_ms, "compute_ms": compute_ms,
                        "values": {k: float(v) for k, v in out.items()}, "oracle": oracle,
                        "rel_diff_vs_cpu": diffs_cpu, "rel_diff_vs_oracle": diffs_oracle,
                        "sketch_gap": sketch_gap, "sketch_clipped": clipped, "profile": prof}
    return pairs, embeddings


def _regression_compiled(torch, M, dev, card, pairs, embeddings, record) -> None:
    """Phase 3j-a, compiled: the fixed-state members (and streaming cosine)
    under ``jit_forward`` against a fresh eager run, call by call, and
    ``update_many`` against eager updates."""
    eager = build_regression_fixed(M, dev)
    comp = build_regression_fixed(M, dev).jit_forward()
    cos_eager = M.CosineSimilarity(reduction="mean", streaming=True, device=dev)
    cos_comp = M.CosineSimilarity(reduction="mean", streaming=True, device=dev).jit_forward()
    start = time.perf_counter()
    comp.warmup(*pairs[0])
    cos_comp.warmup(*embeddings[0])
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - start) * 1e3
    e_ms, c_ms = [], []
    for i, ((preds, target), emb) in enumerate(zip(pairs, embeddings)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eager(preds, target)
        cos_want = cos_eager(*emb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = comp(preds, target)
        cos_got = cos_comp(*emb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        e_ms.append((t1 - t0) * 1e3)
        c_ms.append((t2 - t1) * 1e3)
        for name, value in want.items():
            if not torch.equal(got[name], value):
                fail(f"[regression] compiled step {i} {name}: {got[name]} against eager {value}")
        if not torch.equal(cos_got, cos_want):
            fail(f"[regression] compiled step {i} cosine: {cos_got} against eager {cos_want}")
    for name, m in eager.items(keep_base=True):
        _states_equal(torch, f"regression {name}", comp[name], m)
    _states_equal(torch, "regression cosine", cos_comp, cos_eager)
    syncs = sync_calls(torch, lambda: [comp(*pairs[k]) for k in range(10)])
    syncs += sync_calls(torch, lambda: [cos_comp(*embeddings[k]) for k in range(10)])
    if syncs:
        fail(f"[regression] 10 compiled forwards made {len(syncs)} synchronizing calls: {syncs[:5]}")
    prof = profile_steps(torch, comp, pairs[:10])
    # update_many: 10 stacked groups of 10 chunks; a first pass captures, then reset() and the counted pass
    many = build_regression_fixed(M, dev)
    stacks = [(torch.stack([p for p, _ in pairs[k:k + 10]]), torch.stack([t for _, t in pairs[k:k + 10]]))
              for k in range(0, REG_UPDATES, 10)]
    many.update_many(*stacks[0])
    many.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for stacked in stacks:
        many.update_many(*stacked)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3 / len(stacks)
    check = build_regression_fixed(M, dev)
    for preds, target in pairs:
        check.update(preds, target)
    for name, m in check.items(keep_base=True):
        _states_equal(torch, f"regression update_many {name}", many[name], m)
    many_syncs = sync_calls(torch, lambda: many.update_many(*stacks[0]))
    if many_syncs:
        fail(f"[regression] update_many made {len(many_syncs)} synchronizing calls: {many_syncs[:5]}")
    e_med, c_med = statistics.median(e_ms), statistics.median(c_ms)
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"[regression] the {len(REG_FIXED)} fixed-state members + streaming cosine, eager and compiled "
          f"interleaved over {REG_UPDATES} chunks on {card}: eager median {e_med:.3f} ms, compiled median "
          f"{c_med:.3f} ms (ratio {c_med / e_med:.3f}); capture {warm_ms:.1f} ms; every on-step value and state "
          f"== eager; 0 synchronizing calls in 10 compiled forwards and in one update_many; update_many (K = 10) "
          f"{many_ms:.3f} ms a call, states == {REG_UPDATES} eager updates; 10 compiled forwards under the "
          f"profiler: wall {prof['wall_ms']:.3f} ms, busy {prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    record["compiled"] = {"eager_ms": e_ms, "compiled_ms": c_ms, "capture_ms": warm_ms, "update_many_ms": many_ms,
                          "profile": prof}


def _regression_keyed(torch, np, M, dev, card, _common, keyed_batches, keyed_update_ms, record) -> None:
    """Phase 3j-b: the keyed regression update on phase 3b's cohorts, against
    the CPU port and a float64 per-tenant oracle, eager and through
    ``update_many``."""
    cohorts = _keyed_regression_cohorts(torch, keyed_batches, dev)

    def build(device):
        return M.MultiTenantCollection([M.MeanSquaredError(device=device), M.MeanAbsoluteError(device=device),
                                        M.PearsonCorrcoef(streaming=True, device=device)], KEYED_TENANTS,
                                       validate_ids=False, device=device)

    kgpu = build(dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    k_ms = []
    for ids, preds, target in cohorts:
        t0 = time.perf_counter()
        kgpu.update(ids, preds, target)
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    plain = _common.dispatch_count("segment_scatter_add", "plain")
    bundles = kgpu.state_bundles
    expected = {op: (KEYED_UPDATES if op == "segment_merge" else 0) for op in KERNEL_OPS}
    if launches != expected or plain != bundles * KEYED_UPDATES:
        fail(f"[keyed regression] launches {launches} and {plain} plain scatters, expected {expected} and "
             f"{bundles * KEYED_UPDATES}: one merge launch an update and one plain scatter per bundle per update")
    kcpu = build("cpu")
    for ids, preds, target in cohorts:
        kcpu.update(ids.cpu(), preds.cpu(), target.cpu())
    # the float64 per-tenant oracle over the valid ids
    host = [tuple(x.cpu().numpy() for x in c) for c in cohorts]
    ids_all = np.concatenate([c[0] for c in host])
    valid = (ids_all >= 0) & (ids_all < KEYED_TENANTS)
    ids_v = ids_all[valid]
    p_v = np.concatenate([c[1] for c in host]).astype(np.float64)[valid]
    t_v = np.concatenate([c[2] for c in host]).astype(np.float64)[valid]

    def per_tenant(values):
        acc = np.zeros(KEYED_TENANTS, np.float64)
        np.add.at(acc, ids_v, values)
        return acc

    count = per_tenant(np.ones_like(p_v))
    oracle = {"MeanSquaredError": {"sum_squared_error": per_tenant((p_v - t_v) ** 2), "total": count},
              "MeanAbsoluteError": {"sum_abs_error": per_tenant(np.abs(p_v - t_v)), "total": count},
              "PearsonCorrcoef": {"n_total": count, "sum_x": per_tenant(p_v), "sum_y": per_tenant(t_v),
                                  "sum_xx": per_tenant(p_v * p_v), "sum_yy": per_tenant(t_v * t_v),
                                  "sum_xy": per_tenant(p_v * t_v)}}
    dtypes = {}
    for owner, km in kgpu._keyed.items():
        for name, value in km._get_states().items():
            want_cpu = getattr(kcpu._keyed[owner], name)
            dtypes[f"{owner}.{name}"] = str(value.dtype).replace("torch.", "")
            if value.dtype != want_cpu.dtype or not torch.equal(value.cpu(), want_cpu):
                fail(f"[keyed regression] {owner}.{name} ({value.dtype}) on the card differs from the CPU's")
            got, want = value.cpu().double().numpy(), oracle[owner][name]
            if value.dtype == torch.float32:
                rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
                if rel > 1e-5:
                    fail(f"[keyed regression] {owner}.{name} differs from the float64 oracle by {rel:.2e} (relative)")
            elif not np.array_equal(got, want):
                fail(f"[keyed regression] {owner}.{name} ({value.dtype}) differs from the float64 oracle")
    values, values_cpu = kgpu.compute(), kcpu.compute()
    for name, value in values.items():
        got = value.cpu()
        if not torch.equal(got.isnan(), values_cpu[name].isnan()) or float(
                torch.nan_to_num(got - values_cpu[name]).abs().max()) > 1e-6:
            fail(f"[keyed regression] per-tenant {name} on the card differs from the CPU's")
    # warmup + update_many, K = 5: a first pass captures, then reset() and the counted pass
    kmany = build(dev)
    stacks = [tuple(torch.stack([c[j] for c in cohorts[k:k + 5]]) for j in range(3))
              for k in range(0, KEYED_UPDATES, 5)]
    kmany.warmup(*cohorts[0])
    kmany.update_many(*stacks[0])
    kmany.reset()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    t0 = time.perf_counter()
    for stacked in stacks:
        kmany.update_many(*stacked)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3 / KEYED_UPDATES
    many_launches = _common.launch_count("segment_merge")
    if many_launches != KEYED_UPDATES:
        fail(f"[keyed regression] the merge launched {many_launches} times through the update_many replays, "
             f"expected {KEYED_UPDATES}")
    for owner, km in kgpu._keyed.items():
        _states_equal(torch, f"keyed regression update_many {owner}", kmany._keyed[owner], km)
    print(f"[keyed regression] MultiTenantCollection([MSE, MAE, Pearson(streaming)], {KEYED_TENANTS}) on {card}: "
          f"{KEYED_UPDATES} updates of {KEYED_ROWS} rows, median {statistics.median(k_ms):.3f} ms (phase 3b's keyed "
          f"update {keyed_update_ms:.3f} ms); {bundles} bundles; launches {launches}, {plain} plain scatters "
          f"(leaf dtypes {dtypes}); states == CPU exactly and == float64 oracle (float32 leaves within 1e-5, the "
          f"others exactly); update_many K = 5 {many_ms:.3f} ms a cohort, the merge {many_launches} through the "
          "replays, "
          f"states == eager")
    record["keyed"] = {"update_ms": k_ms, "keyed_3b_median_ms": keyed_update_ms, "launches": launches,
                       "plain_scatters": plain, "bundles": bundles, "leaf_dtypes": dtypes,
                       "update_many_ms_per_cohort": many_ms, "update_many_launches": many_launches}


def _regression_images(torch, M, dev, card, record) -> None:
    """Phase 3j-c: SSIM(streaming) and PSNR over 50 batches of 16 crops of
    512 x 512, the first 4 batches against the CPU port, buffered SSIM
    against streaming."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    shape = (IMG_BATCH, 3, IMG_SIDE, IMG_SIDE)
    images = []
    for _ in range(IMG_BATCHES):
        target = torch.rand(shape, generator=gen, device=dev)
        images.append((torch.clamp(target + 0.05 * torch.randn(shape, generator=gen, device=dev), 0.0, 1.0), target))
    ssim = M.SSIM(streaming=True, data_range=1.0, device=dev)
    psnr = M.PSNR(data_range=1.0, device=dev)
    torch.cuda.synchronize()
    img_ms, values = [], []
    for preds, target in images:
        t0 = time.perf_counter()
        values.append((ssim(preds, target), psnr(preds, target)))
        torch.cuda.synchronize()
        img_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"SSIM": ssim.compute(), "PSNR": psnr.compute()}
    for name, value in out.items():
        if value.shape != () or not bool(torch.isfinite(value)):
            fail(f"[image] {name}: {value} is not a finite scalar")
    ssim_cpu = M.SSIM(streaming=True, data_range=1.0, device="cpu")
    psnr_cpu = M.PSNR(data_range=1.0, device="cpu")
    diffs = []
    for i, (preds, target) in enumerate(images[:4]):
        want = (ssim_cpu(preds.cpu(), target.cpu()), psnr_cpu(preds.cpu(), target.cpu()))
        for name, got, w in zip(("SSIM", "PSNR"), values[i], want):
            diffs.append(abs(float(got) - float(w)))
            if got.dtype != w.dtype or diffs[-1] > 1e-5:
                fail(f"[image] batch {i} {name}: {float(got)} {got.dtype} on the card, {float(w)} {w.dtype} on the CPU")
    buffered = M.SSIM(data_range=1.0, device=dev)
    streaming = M.SSIM(streaming=True, data_range=1.0, device=dev)
    for preds, target in images[:4]:
        buffered.update(preds, target)
        streaming.update(preds, target)
    buf_value, stream_value = float(buffered.compute()), float(streaming.compute())
    buf_gap = abs(buf_value - stream_value)
    if buf_gap > 1e-5:
        fail(f"[image] the buffered SSIM {buf_value} differs from the streaming {stream_value}")
    del buffered, streaming
    prof = profile_steps(torch, lambda p, t: (ssim(p, t), psnr(p, t)), images[:10])
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"[image] {IMG_BATCHES} batches of {IMG_BATCH} x 3 x {IMG_SIDE} x {IMG_SIDE} through SSIM(streaming) + PSNR "
          f"on {card}: median {statistics.median(img_ms):.3f} ms a batch (first {img_ms[0]:.3f} ms); SSIM "
          f"{float(out['SSIM']):.6f}, PSNR {float(out['PSNR']):.4f} dB; first 4 batches == CPU port (max |diff| "
          f"{max(diffs):.2e}); buffered SSIM == streaming (|diff| {buf_gap:.2e}); 10 batches under the profiler: "
          f"wall {prof['wall_ms']:.3f} ms, busy {prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    for row in prof["top_device"][:6]:
        print(f"[image]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["image"] = {"batch_ms": img_ms, "values": {k: float(v) for k, v in out.items()},
                       "max_abs_diff_vs_cpu": max(diffs), "buffered_gap": buf_gap, "profile": prof}


def regression_phase(torch, M, dev, card, keyed_batches, keyed_update_ms) -> dict:
    """Phase 3j: the regression slice at full width (see the module
    docstring): (a) the regression stream, eager and compiled; (b) the keyed
    regression update; (c) image quality."""
    import numpy as np

    from metrics_tpu_torch.kernels import _common

    record = {}
    pairs, embeddings = _regression_stream(torch, np, M, dev, card, _common, record)
    _regression_compiled(torch, M, dev, card, pairs, embeddings, record)
    del pairs, embeddings
    _regression_keyed(torch, np, M, dev, card, _common, keyed_batches, keyed_update_ms, record)
    _regression_images(torch, M, dev, card, record)
    return record


def regression_phase_main(record_path: str = "") -> int:
    """Run :func:`regression_phase` alone (see :func:`_phase_alone`); phase
    3b's keyed update is not timed then, and its median prints as 0."""
    return _phase_alone(lambda torch, M, dev, card: regression_phase(
        torch, M, dev, card, make_keyed_batches(torch, dev), 0.0), record_path)


# --------------------------------------------------------------------------
# phase 3k: the retrieval slice
# --------------------------------------------------------------------------

#: the MS MARCO passage-ranking dev set as rerankers evaluate it: 6,980
#: queries, each with BM25's top 1,000 candidates
RET_QUERIES = 6980
RET_DEPTH = 1000
RET_CHUNK = 50_000
RET_PAD_ROWS = 64
RET_MANY = 10
RET_SKETCH_CAPACITY = 1_048_576
RET_KEYED_DEPTH = 100
RET_KEYS = ("MAP", "MRR", "P@10", "R@100", "nDCG@10", "FallOut@10")


def build_retrieval(M, device, **kw):
    """The reranker evaluation's six members, in one mode (``kw``)."""
    return M.MetricCollection({
        "MAP": M.RetrievalMAP(device=device, **kw),
        "MRR": M.RetrievalMRR(device=device, **kw),
        "P@10": M.RetrievalPrecision(k=10, device=device, **kw),
        "R@100": M.RetrievalRecall(k=100, device=device, **kw),
        "nDCG@10": M.RetrievalNormalizedDCG(k=10, device=device, **kw),
        "FallOut@10": M.RetrievalFallOut(k=10, device=device, **kw),
    })


def _relevance(torch, gen, dev, lengths):
    """Per query, the positions of its relevant passages in its list: one
    (6.5% of queries two, distinct), none in 15% (BM25 missed it)."""
    n = lengths.shape[0]
    r = torch.rand(n, generator=gen, device=dev)
    n_rel = torch.minimum(torch.where(r < 0.15, 0, torch.where(r < 0.215, 2, 1)), lengths)
    first = (torch.rand(n, generator=gen, device=dev) * lengths).long()
    second = (first + 1 + (torch.rand(n, generator=gen, device=dev) * (lengths - 1)).long()) % lengths
    return n_rel, first, second


def _reranker_scores(torch, gen, dev, target):
    """A reranker's logits: N(0, 1) for negatives, N(1.5, 1) for positives,
    rounded through bfloat16, so exact ties occur."""
    noise = torch.randn(target.shape, generator=gen, device=dev)
    return (noise + 1.5 * target).to(torch.bfloat16).float()


def make_reranker_stream(torch, dev):
    """The seeded reranker evaluation, query-major: ``(query ids, scores,
    int64 relevance)`` rows and each row's ``(query, position)``. 90% of
    queries hold 1,000 candidates, the rest a length uniform in [1, 999];
    the query ids are MS MARCO-like (distinct, below 1,102,000)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    full = torch.rand(RET_QUERIES, generator=gen, device=dev) < 0.9
    short = torch.randint(1, RET_DEPTH, (RET_QUERIES,), generator=gen, device=dev)
    lengths = torch.where(full, RET_DEPTH, short)
    n_rel, first, second = _relevance(torch, gen, dev, lengths)
    qids = torch.randperm(1_102_000, generator=gen, device=dev)[:RET_QUERIES]
    row_q = torch.repeat_interleave(torch.arange(RET_QUERIES, device=dev), lengths)
    pos = torch.arange(row_q.numel(), device=dev) - (torch.cumsum(lengths, 0) - lengths)[row_q]
    target = (((n_rel[row_q] >= 1) & (pos == first[row_q])) | ((n_rel[row_q] >= 2) & (pos == second[row_q]))).long()
    return qids[row_q], _reranker_scores(torch, gen, dev, target), target, row_q, pos


def _reranker_oracle(np, idx, preds, target) -> dict:
    """The six values in float64 numpy over the whole stream: numpy's
    ``lexsort((-preds, inverse))`` and one vectorized pass, no loop over
    queries (default policies: an empty query scores 0, FallOut's 1)."""
    _, inverse = np.unique(idx, return_inverse=True)
    order = np.lexsort((-preds, inverse))
    q, t = inverse[order], target[order].astype(np.float64)
    nq = int(q.max()) + 1
    counts = np.bincount(q, minlength=nq)
    starts = np.cumsum(counts) - counts
    rank = np.arange(q.size) - starts[q]
    csum = np.concatenate([[0.0], np.cumsum(t)])
    hits = csum[1:] - csum[starts[q]]

    def per_query(weights):
        return np.bincount(q, weights=weights, minlength=nq)

    n_rel = per_query(t)
    has = n_rel > 0
    safe = np.maximum(n_rel, 1)
    first = np.full(nq, np.inf)
    np.minimum.at(first, q[t > 0], rank[t > 0])
    disc = np.concatenate([[0.0], np.cumsum(1.0 / np.log2(np.arange(10) + 2.0))])
    idcg = disc[np.minimum(n_rel, 10).astype(np.int64)]
    neg = counts - n_rel
    values = {
        "MAP": np.where(has, per_query(np.where(t > 0, hits / (rank + 1), 0.0)) / safe, 0.0),
        "MRR": np.where(has, 1.0 / (first + 1), 0.0),
        "P@10": np.where(has, per_query(t * (rank < 10)) / 10, 0.0),
        "R@100": np.where(has, per_query(t * (rank < 100)) / safe, 0.0),
        "nDCG@10": np.where(idcg > 0, per_query(t * (rank < 10) / np.log2(rank + 2.0)) / np.maximum(idcg, 1e-30), 0.0),
        "FallOut@10": np.where(neg > 0, per_query((1 - t) * (rank < 10)) / np.maximum(neg, 1), 1.0),
    }
    return {name: float(np.mean(v)) for name, v in values.items()}


def _retrieval_flat(torch, np, M, dev, card, stream, record) -> dict:
    """Phase 3k-a: the stream in chunks of 50,000 through the flat members,
    against the CPU port and the float64 oracle. Returns the values."""
    idx, preds, target = stream[:3]
    chunks = list(zip(torch.split(idx, RET_CHUNK), torch.split(preds, RET_CHUNK), torch.split(target, RET_CHUNK)))
    coll = build_retrieval(M, dev, compute_on_step=False)
    torch.cuda.synchronize()
    update_ms = []
    for i, p, t in chunks:
        t0 = time.perf_counter()
        coll.update(p, t, indexes=i)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    out = coll.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    for name, value in out.items():
        if value.shape != () or value.dtype != torch.float32 or not bool(torch.isfinite(value)):
            fail(f"[retrieval flat] {name}: {value} is not a finite float32 scalar")
    values = {name: float(v) for name, v in out.items()}
    cpu = build_retrieval(M, "cpu", compute_on_step=False)
    for i, p, t in chunks:
        cpu.update(p.cpu(), t.cpu(), indexes=i.cpu())
    t0 = time.perf_counter()
    cpu_values = {name: float(v) for name, v in cpu.compute().items()}
    cpu_compute_ms = (time.perf_counter() - t0) * 1e3
    del cpu
    oracle = _reranker_oracle(np, idx.cpu().numpy(), preds.cpu().numpy(), target.cpu().numpy())
    cpu_diff = {n: abs(values[n] - cpu_values[n]) for n in values}
    oracle_diff = {n: abs(values[n] - oracle[n]) for n in values}
    for name in values:
        if cpu_diff[name] > 1e-6:
            fail(f"[retrieval flat] {name}: {values[name]} on the card, {cpu_values[name]} on the CPU")
        if oracle_diff[name] > 1e-5:
            fail(f"[retrieval flat] {name}: {values[name]} on the card, {oracle[name]} by the float64 oracle")
    prof = profile_steps(torch, lambda i, p, t: coll.update(p, t, indexes=i), chunks[:10])
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    # where a member's compute() goes: the grouping of the whole stream into its layout
    from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric

    flat = (idx.to(torch.int32), preds, target.to(torch.int32))
    group = profile_steps(torch, lambda: RetrievalMetric._group_arrays_into_rows(*flat), [()])
    print(f"[retrieval flat] {RET_QUERIES} queries, {idx.numel()} rows in {len(chunks)} chunks of {RET_CHUNK} through "
          f"MAP, MRR, P@10, R@100, nDCG@10, FallOut@10 on {card}: update median {statistics.median(update_ms):.3f} ms "
          f"(first {update_ms[0]:.3f} ms), compute {compute_ms:.3f} ms (the CPU's {cpu_compute_ms:.1f} ms); values "
          f"{json.dumps({n: round(v, 6) for n, v in values.items()})}; == CPU (max |diff| {max(cpu_diff.values()):.2e}), "
          f"== float64 oracle (max |diff| {max(oracle_diff.values()):.2e}); 10 updates under the profiler: wall "
          f"{prof['wall_ms']:.3f} ms, busy {prof['device_busy_ms']:.3f} ms (idle share {idle:.3f}); one grouping of "
          f"the stream: wall {group['wall_ms']:.3f} ms, busy {group['device_busy_ms']:.3f} ms")
    for row in group["top_device"][:5]:
        print(f"[retrieval flat]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["flat"] = {"rows": int(idx.numel()), "update_ms": update_ms, "compute_ms": compute_ms,
                      "cpu_compute_ms": cpu_compute_ms, "values": values, "cpu_values": cpu_values, "oracle": oracle,
                      "max_abs_diff_vs_cpu": max(cpu_diff.values()), "max_abs_diff_vs_oracle": max(oracle_diff.values()),
                      "profile": prof, "grouping_profile": group}
    del coll
    return values


def _retrieval_padded(torch, M, dev, card, stream, flat_values, record) -> None:
    """Phase 3k-b: the same queries as (64, 1000) rows with a mask: eager
    forward and the compiled forward interleaved call by call, then
    ``update_many``; each == 3k-a's values within 1e-5."""
    _, preds, target, row_q, pos = stream
    rows = -(-RET_QUERIES // RET_PAD_ROWS) * RET_PAD_ROWS  # the last batch padded with fully masked rows
    p_rows = torch.zeros((rows, RET_DEPTH), device=dev)
    t_rows = torch.zeros((rows, RET_DEPTH), dtype=torch.long, device=dev)
    m_rows = torch.zeros((rows, RET_DEPTH), dtype=torch.bool, device=dev)
    p_rows[row_q, pos], t_rows[row_q, pos], m_rows[row_q, pos] = preds, target, True
    batches = list(zip(torch.split(p_rows, RET_PAD_ROWS), torch.split(t_rows, RET_PAD_ROWS),
                       torch.split(m_rows, RET_PAD_ROWS)))
    eager = build_retrieval(M, dev, padded=True)
    compiled = build_retrieval(M, dev, padded=True).jit_forward()
    t0 = time.perf_counter()
    compiled.warmup(batches[0][0], batches[0][1], mask=batches[0][2])
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    eager_ms, compiled_ms, syncs, step_diff = [], [], [], 0.0
    for n, (p, t, m) in enumerate(batches):
        t0 = time.perf_counter()
        want = eager(p, t, mask=m)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        if n < 10:  # the synchronizing calls of the first ten compiled forwards (not timed)
            got = {}
            syncs += sync_calls(torch, lambda: got.update(compiled(p, t, mask=m)))
        else:
            t0 = time.perf_counter()
            got = compiled(p, t, mask=m)
            torch.cuda.synchronize()
            compiled_ms.append((time.perf_counter() - t0) * 1e3)
        for name in want:
            step_diff = max(step_diff, abs(float(got[name]) - float(want[name])))
    if syncs:
        fail(f"[retrieval padded] the compiled forward made synchronizing calls: {syncs}")
    if step_diff > 1e-6:
        fail(f"[retrieval padded] a compiled on-step value differs from the eager one by {step_diff}")
    # update_many: a first call captures, then reset() and the timed pass, which only replays
    many = build_retrieval(M, dev, padded=True)
    stacks = [tuple(torch.stack(col) for col in zip(*batches[k:k + RET_MANY])) for k in range(0, len(batches), RET_MANY)]
    many.update_many(stacks[0][0], stacks[0][1], mask=stacks[0][2])
    many.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, t, m in stacks:
        many.update_many(p, t, mask=m)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3
    diffs = {}
    for label, coll in (("eager", eager), ("compiled", compiled), ("update_many", many)):
        values = {name: float(v) for name, v in coll.compute().items()}
        diffs[label] = max(abs(values[n] - flat_values[n]) for n in RET_KEYS)
        if diffs[label] > 1e-5:
            fail(f"[retrieval padded] {label}: {values} against the flat mode's {flat_values}")
        queries = {int(coll[n].query_total) for n in RET_KEYS}
        if queries != {RET_QUERIES}:
            fail(f"[retrieval padded] {label} counted {queries} queries, expected {RET_QUERIES}")
    prof_e = profile_steps(torch, lambda p, t, m: eager(p, t, mask=m), batches[:10])
    prof_c = profile_steps(torch, lambda p, t, m: compiled(p, t, mask=m), batches[:10])
    idle_e = 1 - prof_e["device_busy_ms"] / prof_e["wall_ms"]
    idle_c = 1 - prof_c["device_busy_ms"] / prof_c["wall_ms"]
    e_med, c_med = statistics.median(eager_ms[10:]), statistics.median(compiled_ms)
    print(f"[retrieval padded] {len(batches)} batches of {RET_PAD_ROWS} x {RET_DEPTH} (the last with "
          f"{rows - RET_QUERIES} masked rows) on {card}: eager forward {e_med:.3f} ms, compiled {c_med:.3f} ms "
          f"(ratio {c_med / e_med:.3f}, interleaved, batches 10 on), capture {capture_ms:.1f} ms, 0 synchronizing "
          f"calls in 10 compiled forwards; update_many K = {RET_MANY} {many_ms / len(batches):.3f} ms a batch; "
          f"== flat values (max |diff| {diffs}); idle share eager {idle_e:.3f}, compiled {idle_c:.3f}")
    record["padded"] = {"batches": len(batches), "eager_ms": eager_ms, "compiled_ms": compiled_ms,
                        "capture_ms": capture_ms, "update_many_ms_per_batch": many_ms / len(batches),
                        "sync_calls": syncs, "max_abs_diff_vs_flat": diffs, "step_diff": step_diff,
                        "profile_eager": prof_e, "profile_compiled": prof_c}


def _retrieval_sketched(torch, np, M, dev, card, stream, flat_values, record) -> None:
    """Phase 3k-c: the stream into the 1,048,576-row query reservoir: its
    states == the CPU run's bit for bit, its MAP within 0.05 of the exact."""
    import warnings

    idx, preds, target = stream[:3]
    chunks = list(zip(torch.split(idx, RET_CHUNK), torch.split(preds, RET_CHUNK), torch.split(target, RET_CHUNK)))
    m = M.RetrievalMAP(sketched=True, sketch_capacity=RET_SKETCH_CAPACITY, compute_on_step=False, device=dev)
    host = M.RetrievalMAP(sketched=True, sketch_capacity=RET_SKETCH_CAPACITY, compute_on_step=False, device="cpu")
    torch.cuda.synchronize()
    update_ms = []
    for i, p, t in chunks:
        t0 = time.perf_counter()
        m.update(p, t, indexes=i)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for i, p, t in chunks:
        host.update(p.cpu(), t.cpu(), indexes=i.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3 / len(chunks)
    for name in ("res_key", "res_qid", "res_pred", "res_target", "res_seen", "res_overflow"):
        got, want = getattr(m, name).cpu(), getattr(host, name)
        if got.is_floating_point():
            got, want = got.view(torch.int32), want.view(torch.int32)
        if not torch.equal(got, want):
            fail(f"[retrieval sketched] the reservoir's {name} on the card differs from the CPU run's")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        value = float(m.compute())
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t0) * 1e3
        cpu_value = float(host.compute())
    sampled = [str(w.message) for w in seen if "sampled the query stream" in str(w.message)]
    if len(sampled) != 2:
        fail(f"[retrieval sketched] expected the sampling warning from both runs, got {sampled}")
    if abs(value - cpu_value) > 1e-6:
        fail(f"[retrieval sketched] MAP {value} on the card, {cpu_value} on the CPU")
    gap = abs(value - flat_values["MAP"])
    if gap > 0.05:
        fail(f"[retrieval sketched] the sampled MAP {value} is {gap} from the exact {flat_values['MAP']}")
    kept = int(torch.unique(m.res_qid[torch.isfinite(m.res_key)]).numel())
    print(f"[retrieval sketched] RetrievalMAP(sketched=True, sketch_capacity={RET_SKETCH_CAPACITY}) on {card}: update "
          f"median {statistics.median(update_ms):.3f} ms a chunk (the CPU's {cpu_ms:.1f} ms), compute {compute_ms:.3f} "
          f"ms; reservoir == CPU bit for bit; {kept} queries in the reservoir; {sampled[0].split(': ')[1][:60]}...; "
          f"MAP {value:.6f}, exact {flat_values['MAP']:.6f} (|diff| {gap:.4f})")
    record["sketched"] = {"update_ms": update_ms, "cpu_update_ms": cpu_ms, "compute_ms": compute_ms, "value": value,
                          "exact": flat_values["MAP"], "gap": gap, "queries_in_reservoir": kept,
                          "warning": sampled[0]}


def make_keyed_retrieval(torch, dev):
    """50 seeded cohorts of 4096 query rows x 100 candidates (a second-stage
    top-100 rerank) with tenant ids uniform in [0, 10000); the last holds
    3000 real rows, padded with id -1 and zero rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 21)
    lengths = torch.full((KEYED_ROWS,), RET_KEYED_DEPTH, device=dev)
    col = torch.arange(RET_KEYED_DEPTH, device=dev)
    cohorts = []
    for step in range(KEYED_UPDATES):
        ids = torch.randint(0, KEYED_TENANTS, (KEYED_ROWS,), generator=gen, device=dev)
        n_rel, first, second = _relevance(torch, gen, dev, lengths)
        target = (((n_rel >= 1)[:, None] & (col == first[:, None]))
                  | ((n_rel >= 2)[:, None] & (col == second[:, None]))).long()
        preds = _reranker_scores(torch, gen, dev, target)
        if step == KEYED_UPDATES - 1:
            ids[KEYED_LAST_REAL:] = -1
            preds[KEYED_LAST_REAL:] = 0.0
            target[KEYED_LAST_REAL:] = 0
        cohorts.append((ids, preds, target))
    return cohorts


def build_keyed_retrieval(M, device):
    return M.MultiTenantCollection([M.RetrievalMAP(padded=True, device=device),
                                    M.RetrievalMRR(padded=True, device=device),
                                    M.RetrievalNormalizedDCG(padded=True, k=10, device=device)],
                                   KEYED_TENANTS, validate_ids=False, device=device)


def _retrieval_keyed(torch, M, dev, card, _common, record) -> None:
    """Phase 3k-d: per-tenant ranking quality over 10,000 tenants: the merge
    once per update, no other kernel; the stacked states and the
    per-tenant values against the CPU; then ``update_many``."""
    cohorts = make_keyed_retrieval(torch, dev)
    kgpu = build_keyed_retrieval(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    k_ms = []
    for ids, preds, target in cohorts:
        t0 = time.perf_counter()
        kgpu.update(ids, preds, target)
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    bundles = kgpu.state_bundles
    expected = {op: (KEYED_UPDATES if op == "segment_merge" else 0) for op in KERNEL_OPS}
    if bundles != 3 or launches != expected:
        fail(f"[retrieval keyed] {bundles} bundles, launches {launches}, expected 3 and {expected}: one merge "
             "launch an update (every bundle's value_sum and query_total), no other kernel")
    kcpu = build_keyed_retrieval(M, "cpu")
    for ids, preds, target in cohorts:
        kcpu.update(ids.cpu(), preds.cpu(), target.cpu())
    sum_diff = 0.0
    for owner, km in kgpu._keyed.items():
        ref = kcpu._keyed[owner]
        if km.query_total.dtype != torch.int32 or not torch.equal(km.query_total.cpu(), ref.query_total):
            fail(f"[retrieval keyed] {owner}.query_total on the card differs from the CPU's")
        got, want = km.value_sum.cpu(), ref.value_sum
        sum_diff = max(sum_diff, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
            fail(f"[retrieval keyed] {owner}.value_sum on the card differs from the CPU's by {sum_diff}")
    queries = int(sum(km.query_total.sum() for km in kcpu._keyed.values()))
    if queries != 3 * ((KEYED_UPDATES - 1) * KEYED_ROWS + KEYED_LAST_REAL):
        fail(f"[retrieval keyed] {queries} queries counted over the three members")
    values, values_cpu = kgpu.compute(), kcpu.compute()
    value_diff = 0.0
    for name, value in values.items():
        got = value.cpu()
        value_diff = max(value_diff, float((got - values_cpu[name]).abs().max()))
        if not torch.allclose(got, values_cpu[name], rtol=1e-5, atol=1e-5):
            fail(f"[retrieval keyed] per-tenant {name} on the card differs from the CPU's by {value_diff}")
    telemetry = check_telemetry("retrieval keyed", [("MultiTenantCollection", kgpu, kcpu)])
    # warmup + update_many, K = 5: a first pass captures, then reset() and the counted pass
    kmany = build_keyed_retrieval(M, dev)
    stacks = [tuple(torch.stack([c[j] for c in cohorts[k:k + 5]]) for j in range(3))
              for k in range(0, KEYED_UPDATES, 5)]
    kmany.warmup(*cohorts[0])
    kmany.update_many(*stacks[0])
    kmany.reset()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    t0 = time.perf_counter()
    for stacked in stacks:
        kmany.update_many(*stacked)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3 / KEYED_UPDATES
    many_launches = _common.launch_count("segment_merge")
    if many_launches != KEYED_UPDATES:
        fail(f"[retrieval keyed] the merge launched {many_launches} times through the update_many replays, "
             f"expected {KEYED_UPDATES}")
    for owner, km in kgpu._keyed.items():
        if not torch.equal(kmany._keyed[owner].query_total, km.query_total) or not torch.allclose(
                kmany._keyed[owner].value_sum, km.value_sum, rtol=1e-5, atol=1e-5):
            fail(f"[retrieval keyed] update_many's {owner} differs from the eager updates'")
    prof = profile_steps(torch, lambda i, p, t: kgpu.update(i, p, t), cohorts[:10])
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"[retrieval keyed] MultiTenantCollection([MAP, MRR, nDCG@10](padded=True), {KEYED_TENANTS}) on {card}: "
          f"{KEYED_UPDATES} updates of {KEYED_ROWS} x {RET_KEYED_DEPTH}, median {statistics.median(k_ms):.3f} ms "
          f"(first {k_ms[0]:.3f} ms); launches {launches}; query_total == CPU exactly, value_sum within "
          f"{sum_diff:.2e}, per-tenant values within {value_diff:.2e}; update_many K = 5 {many_ms:.3f} ms a cohort, "
          f"the merge {many_launches} through the replays; 10 updates under the profiler: wall "
          f"{prof['wall_ms']:.3f} ms, "
          f"busy {prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    for row in prof["top_device"][:5]:
        print(f"[retrieval keyed]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["keyed"] = {"update_ms": k_ms, "launches": launches, "bundles": bundles, "value_sum_diff": sum_diff,
                       "value_diff": value_diff, "update_many_ms_per_cohort": many_ms,
                       "update_many_launches": many_launches, "telemetry": telemetry, "profile": prof}


def retrieval_phase(torch, M, dev, card) -> dict:
    """Phase 3k: the retrieval slice at full width (see the module
    docstring): (a) the reranker evaluation, flat; (b) the same queries
    padded, eager and compiled; (c) the query reservoir; (d) per-tenant
    ranking quality, keyed."""
    import numpy as np

    from metrics_tpu_torch.kernels import _common

    record = {}
    t0 = time.perf_counter()
    stream = make_reranker_stream(torch, dev)
    flat_values = _retrieval_flat(torch, np, M, dev, card, stream, record)
    _retrieval_padded(torch, M, dev, card, stream, flat_values, record)
    _retrieval_sketched(torch, np, M, dev, card, stream, flat_values, record)
    del stream
    _retrieval_keyed(torch, M, dev, card, _common, record)
    record["phase_s"] = time.perf_counter() - t0
    print(f"[retrieval] phase 3k took {record['phase_s']:.1f} s on {card}")
    return record


def retrieval_phase_main(record_path: str = "") -> int:
    """Run :func:`retrieval_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(retrieval_phase, record_path)


# --------------------------------------------------------------------------
# phase 3l: the small metrics of the last slice
# --------------------------------------------------------------------------

#: WSJ0-2mix's test set as speech separation evaluates it: 3000 mixtures of
#: two sources at 8 kHz, 4 s each
SPEECH_MIXTURES = 3000
SPEECH_SOURCES = 2
SPEECH_SAMPLES = 32_000
SPEECH_BATCH = 64
#: the keyed speech-enhancement service: one 1 s clip at 16 kHz per row
SPEECH_KEYED_SAMPLES = 16_000
SPEECH_KEYED_UPDATES = 20
#: WMT14 En->De newstest2014: 3003 sentence pairs, one reference each
BLEU_PAIRS = 3003
BLEU_VOCAB = 32_000
#: SimCLR's similarity matrix: a batch of 4096 projections of width 128
SIMCLR_BATCH = 4096
SIMCLR_DIM = 128
BOOTSTRAPS = 20


def _speech(torch, gen, dev, rows, samples, snr_db=(5.0, 15.0)):
    """Speech-like targets (Gaussian under a slow random envelope) and
    predictions at a per-row SNR uniform in ``snr_db``: ``(rows, samples)``
    float32 each."""
    t = torch.arange(samples, device=dev, dtype=torch.float32)
    rate = 2.0 + 4.0 * torch.rand((rows, 1), generator=gen, device=dev)
    phase = 6.283 * torch.rand((rows, 1), generator=gen, device=dev)
    envelope = 0.2 + torch.abs(torch.sin(t * (rate / samples * 6.283) + phase))
    target = torch.randn((rows, samples), generator=gen, device=dev) * envelope
    snr = snr_db[0] + (snr_db[1] - snr_db[0]) * torch.rand((rows, 1), generator=gen, device=dev)
    rms = target.pow(2).mean(dim=1, keepdim=True).sqrt()
    preds = target + torch.randn((rows, samples), generator=gen, device=dev) * rms * 10.0 ** (-snr / 20.0)
    return preds, target


def _audio_oracle(np, preds, target):
    """Per-signal SI-SDR, SI-SNR and SNR in float64 numpy (eps of float32,
    as the metrics use for float32 signals)."""
    p, t = preds.astype(np.float64), target.astype(np.float64)
    eps = float(np.finfo(np.float32).eps)

    def si_sdr(p, t):
        alpha = ((p * t).sum(-1, keepdims=True) + eps) / ((t * t).sum(-1, keepdims=True) + eps)
        ts = alpha * t
        return 10 * np.log10(((ts * ts).sum(-1) + eps) / (((ts - p) ** 2).sum(-1) + eps))

    pc, tc = p - p.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True)
    snr = 10 * np.log10(((t * t).sum(-1) + eps) / (((t - p) ** 2).sum(-1) + eps))
    return {"SI_SDR": si_sdr(p, t), "SI_SNR": si_sdr(pc, tc), "SNR": snr}


def _speech_separation(torch, np, M, dev, card, _common, record) -> None:
    """Phase 3l-a: WSJ0-2mix-shaped separation scores through SI_SDR, SI_SNR
    and SNR (forward) and their functionals, against the CPU port and a
    float64 oracle."""
    from metrics_tpu_torch import functional as MF

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    batches = []
    for start in range(0, SPEECH_MIXTURES, SPEECH_BATCH):
        n = min(SPEECH_BATCH, SPEECH_MIXTURES - start)
        preds, target = _speech(torch, gen, dev, n * SPEECH_SOURCES, SPEECH_SAMPLES)
        batches.append((preds.view(n, SPEECH_SOURCES, SPEECH_SAMPLES), target.view(n, SPEECH_SOURCES, SPEECH_SAMPLES)))
    names = ("SI_SDR", "SI_SNR", "SNR")
    fns = {"SI_SDR": MF.si_sdr, "SI_SNR": MF.si_snr, "SNR": MF.snr}

    def build(device):
        return {name: getattr(M, name)(device=device) for name in names}

    gpu, cpu = build(dev), build("cpu")
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    fwd_ms = {name: [] for name in names}
    step_diff, fn_diff, oracle_db = 0.0, 0.0, 0.0
    sums = {name: 0.0 for name in names}
    for preds, target in batches:
        p_cpu, t_cpu = preds.cpu(), target.cpu()
        oracle = _audio_oracle(np, p_cpu.numpy(), t_cpu.numpy())
        for name in names:
            t0 = time.perf_counter()
            value = gpu[name](preds, target)
            torch.cuda.synchronize()
            fwd_ms[name].append((time.perf_counter() - t0) * 1e3)
            want = cpu[name](p_cpu, t_cpu)
            step_diff = max(step_diff, _rel_diff(float(value), float(want)))
            per_signal, per_signal_cpu = fns[name](preds, target).cpu(), fns[name](p_cpu, t_cpu)
            fn_diff = max(fn_diff, float(((per_signal - per_signal_cpu).abs()
                                          / per_signal_cpu.abs().clamp(min=1e-30)).max()))
            oracle_db = max(oracle_db, float(np.abs(per_signal.double().numpy() - oracle[name]).max()))
            sums[name] += float(oracle[name].sum())
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    if any(launches.values()):
        fail(f"[audio] a kernel launched on the separation scores, which have none: {launches}")
    if step_diff > 1e-5 or fn_diff > 1e-5:
        fail(f"[audio] values on the card differ from the CPU's: on-step {step_diff:.2e}, per signal {fn_diff:.2e} "
             "(relative; limit 1e-5)")
    if oracle_db > 1e-3:
        fail(f"[audio] per-signal values differ from the float64 oracle by {oracle_db:.2e} dB (limit 1e-3)")
    signals = SPEECH_MIXTURES * SPEECH_SOURCES
    epoch = {}
    for name in names:
        got, want = gpu[name].compute(), cpu[name].compute()
        if int(gpu[name].total) != signals or not torch.equal(gpu[name].total.cpu(), cpu[name].total):
            fail(f"[audio] {name} counted {int(gpu[name].total)} signals, expected {signals}")
        rel_cpu, rel_oracle = _rel_diff(float(got), float(want)), _rel_diff(float(got), sums[name] / signals)
        if rel_cpu > 1e-5 or abs(float(got) - sums[name] / signals) > 1e-3:
            fail(f"[audio] {name} compute() {float(got)} against the CPU's {float(want)} and the oracle's "
                 f"{sums[name] / signals}")
        epoch[name] = {"value": float(got), "rel_diff_cpu": rel_cpu, "rel_diff_oracle": rel_oracle}
    prof = profile_steps(torch, lambda p, t: [gpu[name](p, t) for name in names], batches[:10])
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    medians = {name: statistics.median(ms) for name, ms in fwd_ms.items()}
    print(f"[audio] WSJ0-2mix-shaped separation scores on {card}: {len(batches)} forwards of "
          f"({SPEECH_BATCH}, {SPEECH_SOURCES}, {SPEECH_SAMPLES}) float32 through SI_SDR, SI_SNR, SNR: median ms per "
          f"forward { {k: round(v, 4) for k, v in medians.items()} }; values "
          f"{ {k: round(v['value'], 4) for k, v in epoch.items()} } dB, == CPU (on-step {step_diff:.2e}, per signal "
          f"{fn_diff:.2e} relative), per signal within {oracle_db:.2e} dB of the float64 oracle; no kernel; 10 "
          f"batches of the three forwards under the profiler: wall {prof['wall_ms']:.3f} ms, busy "
          f"{prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    record["speech"] = {"forward_ms": fwd_ms, "median_ms": medians, "epoch": epoch, "step_rel_diff": step_diff,
                        "signal_rel_diff": fn_diff, "oracle_max_db": oracle_db, "launches": launches,
                        "profile": prof, "idle_share": idle}


def _speech_keyed(torch, M, dev, card, _common, keyed_batches, record) -> None:
    """Phase 3l-b: per-customer speech quality: ``MultiTenantCollection([SI_SDR,
    SNR], 10,000)`` over the last 20 of phase 3b's cohorts of tenant ids, one
    1 s clip at 16 kHz per row; the merge once per update."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)

    def build(device):
        return M.MultiTenantCollection([M.SI_SDR(device=device), M.SNR(device=device)], KEYED_TENANTS,
                                       validate_ids=False, device=device)

    kgpu, kcpu = build(dev), build("cpu")
    ids_list = [ids for ids, _, _ in keyed_batches[-SPEECH_KEYED_UPDATES:]]
    k_ms, prof_inputs = [], []
    launches = {op: 0 for op in KERNEL_OPS}
    for step, ids in enumerate(ids_list):
        preds, target = _speech(torch, gen, dev, KEYED_ROWS, SPEECH_KEYED_SAMPLES)
        if step < 5:
            prof_inputs.append((ids, preds, target))
        torch.cuda.synchronize()
        _common.reset_dispatch_counters()
        t0 = time.perf_counter()
        kgpu.update(ids, preds, target)
        torch.cuda.synchronize()
        k_ms.append((time.perf_counter() - t0) * 1e3)
        for op in KERNEL_OPS:
            launches[op] += _common.launch_count(op)
        kcpu.update(ids.cpu(), preds.cpu(), target.cpu())
    bundles = kgpu.state_bundles
    expected = {op: (SPEECH_KEYED_UPDATES if op == "segment_merge" else 0) for op in KERNEL_OPS}
    if bundles != 2 or launches != expected:
        fail(f"[audio keyed] {bundles} bundles, launches {launches}, expected 2 and {expected}: one merge launch "
             "an update (each bundle's float32 sum and int32 count), no other kernel")
    sum_diff = 0.0
    for owner, km in kgpu._keyed.items():
        ref = kcpu._keyed[owner]
        if km.total.dtype != torch.int32 or not torch.equal(km.total.cpu(), ref.total):
            fail(f"[audio keyed] {owner}.total on the card differs from the CPU's")
        value_sum = next(n for n in km._reductions if n.startswith("sum_"))
        got, want = getattr(km, value_sum).cpu(), getattr(ref, value_sum)
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-3)).max())
        sum_diff = max(sum_diff, rel)
        if rel > 1e-5:
            fail(f"[audio keyed] {owner}.{value_sum} on the card differs from the CPU's by {rel:.2e} (relative)")
    rows = int(sum(int(km.total.sum()) for km in kcpu._keyed.values()))
    if rows != 2 * ((SPEECH_KEYED_UPDATES - 1) * KEYED_ROWS + KEYED_LAST_REAL):
        fail(f"[audio keyed] {rows} clips counted over the two members")
    values, values_cpu = kgpu.compute(), kcpu.compute()
    value_diff = 0.0
    for name, value in values.items():
        got, want = value.cpu(), values_cpu[name]
        if not torch.equal(got.isnan(), want.isnan()):
            fail(f"[audio keyed] per-tenant {name}: the tenants without clips differ from the CPU's")
        rel = float(torch.nan_to_num((got - want).abs() / want.abs().clamp(min=1e-3)).max())
        value_diff = max(value_diff, rel)
        if rel > 1e-5:
            fail(f"[audio keyed] per-tenant {name} on the card differs from the CPU's by {rel:.2e} (relative)")
    prof = profile_steps(torch, lambda i, p, t: kgpu.update(i, p, t), prof_inputs)
    idle = 1 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"[audio keyed] MultiTenantCollection([SI_SDR, SNR], {KEYED_TENANTS}) on {card}: {SPEECH_KEYED_UPDATES} "
          f"updates of {KEYED_ROWS} clips x {SPEECH_KEYED_SAMPLES} samples (preds and target "
          f"{KEYED_ROWS * SPEECH_KEYED_SAMPLES * 4 / 1e6:.0f} MB each), median {statistics.median(k_ms):.3f} ms "
          f"(first {k_ms[0]:.3f} ms); {bundles} bundles, launches "
          f"{ {k: v for k, v in launches.items() if v} }; counts == CPU exactly, sums within {sum_diff:.2e} and "
          f"per-tenant values within {value_diff:.2e} (relative); 5 updates under the profiler: wall "
          f"{prof['wall_ms']:.3f} ms, busy {prof['device_busy_ms']:.3f} ms (idle share {idle:.3f})")
    record["speech_keyed"] = {"update_ms": k_ms, "launches": launches, "bundles": bundles, "sum_rel_diff": sum_diff,
                              "value_rel_diff": value_diff, "profile": prof, "idle_share": idle}


def _bleu_corpus(np, seed):
    """newstest2014-shaped pairs: references of 5-80 tokens (mean about 27)
    from a Zipf vocabulary of 32,000 token strings, hypotheses with 30% of
    their tokens replaced."""
    rng = np.random.RandomState(seed)
    words = [f"tok{i}" for i in range(BLEU_VOCAB)]
    lengths = np.clip(np.round(rng.lognormal(3.2, 0.5, BLEU_PAIRS)), 5, 80).astype(int)
    hyps, refs = [], []
    for length in lengths:
        ranks = np.minimum(rng.zipf(1.1, length), BLEU_VOCAB) - 1
        ref = [words[r] for r in ranks]
        swap = rng.rand(length) < 0.3
        hyp = [words[rng.randint(BLEU_VOCAB)] if s else w for w, s in zip(ref, swap)]
        hyps.append(hyp)
        refs.append([ref])
    return hyps, refs, float(lengths.mean())


def _bleu_oracle(hyps, refs, smooth, n_gram=4):
    """BLEU in Python floats (float64), from the formula."""
    import math
    from collections import Counter

    num, den, c, r = [0] * n_gram, [0] * n_gram, 0, 0
    for hyp, rs in zip(hyps, refs):
        c += len(hyp)
        r += len(min(rs, key=lambda x: abs(len(hyp) - len(x))))  # the first closest length
        hc = Counter(tuple(hyp[j:j + n]) for n in range(1, n_gram + 1) for j in range(len(hyp) - n + 1))
        rc = Counter()
        for x in rs:
            rc |= Counter(tuple(x[j:j + n]) for n in range(1, n_gram + 1) for j in range(len(x) - n + 1))
        for g, k in (hc & rc).items():
            num[len(g) - 1] += k
        for g, k in hc.items():
            den[len(g) - 1] += k
    if min(num) == 0:
        return 0.0
    prec = [(num[i] + (1 if smooth and i else 0)) / (den[i] + (1 if smooth and i else 0)) for i in range(n_gram)]
    bp = 1.0 if c > r else math.exp(1 - r / c)
    return bp * math.exp(sum(math.log(p) for p in prec) / n_gram)


def _bleu(torch, np, dev, card, record) -> None:
    """Phase 3l-c: BLEU over newstest2014-shaped pairs, with and without
    smoothing, on the card, on the CPU and from a float64 oracle."""
    from metrics_tpu_torch.functional import bleu_score

    hyps, refs, mean_len = _bleu_corpus(np, SEED + 32)
    out = {}
    for smooth in (False, True):
        t0 = time.perf_counter()
        got = bleu_score(hyps, refs, smooth=smooth, device=dev)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        cpu = float(bleu_score(hyps, refs, smooth=smooth, device="cpu"))
        oracle = _bleu_oracle(hyps, refs, smooth)
        if got.device != dev or abs(float(got) - cpu) > 1e-6 or abs(float(got) - oracle) > 1e-6:
            fail(f"[bleu] smooth={smooth}: {float(got)} on {got.device}, CPU {cpu}, oracle {oracle} (limit 1e-6)")
        out[f"smooth={smooth}"] = {"value": float(got), "host_ms": host_ms, "diff_cpu": abs(float(got) - cpu),
                                   "diff_oracle": abs(float(got) - oracle)}
    print(f"[bleu] newstest2014-shaped corpus ({BLEU_PAIRS} pairs, mean length {mean_len:.1f} tokens, Zipf vocabulary "
          f"of {BLEU_VOCAB}) on {card}: " + "; ".join(
              f"{k}: {v['value']:.6f} in {v['host_ms']:.1f} ms (host), |card - CPU| {v['diff_cpu']:.1e}, "
              f"|card - oracle| {v['diff_oracle']:.1e}" for k, v in out.items()))
    record["bleu"] = out


def _embedding_similarity(torch, M, dev, card, record) -> None:
    """Phase 3l-d: SimCLR-shaped similarity matrices, card against CPU;
    identical rows read 1.0 (the guard against TF32)."""
    from metrics_tpu_torch.functional import embedding_similarity

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 33)
    batch = torch.randn((SIMCLR_BATCH, SIMCLR_DIM), generator=gen, device=dev)
    batch_cpu = batch.cpu()
    out = {}
    for similarity in ("cosine", "dot"):
        for reduction in ("none", "mean"):
            kw = dict(similarity=similarity, reduction=reduction)
            got, want = embedding_similarity(batch, **kw).cpu(), embedding_similarity(batch_cpu, **kw)
            diff = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
            if diff > 1e-5:
                fail(f"[similarity] {similarity}/{reduction} on the card differs from the CPU's by {diff:.2e}")
            ms = cuda_ms(lambda: embedding_similarity(batch, **kw))
            out[f"{similarity}/{reduction}"] = {"ms": ms, "max_diff": diff}
    same = batch[:1].repeat(SIMCLR_BATCH, 1)
    ones = embedding_similarity(same, zero_diagonal=False)
    one_diff = float((ones - 1.0).abs().max())
    if one_diff > 1e-6:
        fail(f"[similarity] identical rows read {one_diff:.2e} off 1.0 (limit 1e-6): the product ran in TF32")
    bound_ms, bound_by = bound(SIMCLR_BATCH * SIMCLR_DIM * 4 + SIMCLR_BATCH ** 2 * 4,
                               2 * SIMCLR_BATCH ** 2 * SIMCLR_DIM)
    library_ms = cuda_ms(lambda: torch.mm(batch, batch.T))
    print(f"[similarity] embedding_similarity at SimCLR's shape ({SIMCLR_BATCH}, {SIMCLR_DIM}) on {card}: "
          + "; ".join(f"{k} {v['ms']:.4f} ms (|card - CPU| {v['max_diff']:.1e})" for k, v in out.items())
          + f"; bound {bound_ms:.4f} ms ({bound_by}); the bare product torch.mm {library_ms:.4f} ms; identical rows "
          f"within {one_diff:.1e} of 1.0")
    record["similarity"] = {"cases": out, "bound_ms": bound_ms, "bound_by": bound_by, "mm_ms": library_ms,
                            "identical_rows_diff": one_diff}


def _image_gradients(torch, dev, card, record) -> None:
    """Phase 3l-e: image gradients of phase 3j's 16 x 3 x 512 x 512 crops,
    card against CPU exactly."""
    from metrics_tpu_torch.functional import image_gradients

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    img = torch.rand((IMG_BATCH, 3, IMG_SIDE, IMG_SIDE), generator=gen, device=dev)
    dy, dx = image_gradients(img)
    want_dy, want_dx = image_gradients(img.cpu())
    if not (torch.equal(dy.cpu(), want_dy) and torch.equal(dx.cpu(), want_dx)):
        fail("[gradients] image_gradients on the card differ from the CPU's")
    ms = cuda_ms(lambda: image_gradients(img))
    nbytes = img.numel() * 4 * 3
    bound_ms, bound_by = bound(nbytes, 2 * img.numel())
    print(f"[gradients] image_gradients of ({IMG_BATCH}, 3, {IMG_SIDE}, {IMG_SIDE}) float32 on {card}: "
          f"{ms:.4f} ms, == CPU exactly; bound {bound_ms:.4f} ms ({bound_by}: {img.numel() * 4 / 1e6:.1f} MB read, "
          f"{2 * img.numel() * 4 / 1e6:.1f} MB written)")
    record["image_gradients"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}


def _bootstrap(torch, M, dev, card, _common, batches, record) -> None:
    """Phase 3l-f: a bootstrap confidence interval of macro top-1 accuracy
    over phase 3's 49 ImageNet-1k batches, eager (B1 once per child per
    update; one Poisson total read per child per update) and pure (B1's
    batched form once per update for all the children, no synchronizing
    call); each run replayed on the CPU with the card's index vectors or
    matrices."""
    import metrics_tpu_torch.wrappers.bootstrapping as boot
    from metrics_tpu_torch.observability.registry import TELEMETRY

    def build(device, **kw):
        return M.BootStrapper(M.Accuracy(average="macro", num_classes=NUM_CLASSES, device=device),
                              num_bootstraps=BOOTSTRAPS, quantile=[0.025, 0.975], raw=True, seed=SEED, **kw)

    real_sampler, recorded = boot._bootstrap_sampler, []

    def recording(*args, **kwargs):
        idx = real_sampler(*args, **kwargs)
        recorded.append(idx)
        return idx

    eager = build(dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    boot._bootstrap_sampler = recording
    eager_ms = []
    try:
        for preds, target in batches:
            t0 = time.perf_counter()
            eager.update(preds, target)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        boot._bootstrap_sampler = real_sampler
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    want = {op: (BOOTSTRAPS * len(batches) if op == "stat_scores_counts" else 0) for op in KERNEL_OPS}
    if launches != want:
        fail(f"[bootstrap] eager launches {launches}, expected {want}: B1 once per child per update")
    reads = TELEMETRY.counter(eager.telemetry_key, "bootstrap_host_reads")
    if TELEMETRY.enabled and reads != BOOTSTRAPS * len(batches):
        fail(f"[bootstrap] {reads} Poisson totals read to the host, expected {BOOTSTRAPS * len(batches)}")
    got = {k: v.cpu() for k, v in eager.compute().items()}
    one_update = sync_calls(torch, lambda: build(dev).update(*batches[0]))
    cpu = build("cpu")
    replay = iter(recorded)
    boot._bootstrap_sampler = lambda *a, **k: next(replay).cpu()
    try:
        for preds, target in batches:
            cpu.update(preds.cpu(), target.cpu())
    finally:
        boot._bootstrap_sampler = real_sampler
    want_cpu = cpu.compute()
    eager_diff = max(float((got[k] - want_cpu[k]).abs().max()) for k in got)
    if eager_diff > 1e-6:
        fail(f"[bootstrap] the eager statistics on the card differ from the CPU replay by {eager_diff:.2e}")

    # B1's batched form at the pure path's shape (the 20 children's canonical
    # (1024, 1000) inputs in one stack) against its plain version; these
    # launches are not counted
    from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch

    stack_gen = torch.Generator(device=dev)
    stack_gen.manual_seed(SEED + 12)
    stack = [torch.randint(0, 2, (BOOTSTRAPS, BATCH, NUM_CLASSES), generator=stack_gen, device=dev,
                           dtype=torch.int32) for _ in range(2)]
    batched = {"shape": [BOOTSTRAPS, BATCH, NUM_CLASSES], "max_abs_err": max(
        int((g - w).abs().max()) for g, w in zip(stat_scores_counts_cuda(*stack, device=dev),
                                                 stat_scores_counts_torch(*stack)))}
    if batched["max_abs_err"]:
        fail(f"[bootstrap] B1's batched form differs from its plain version by {batched['max_abs_err']} at "
             f"{batched['shape']}")
    batched["ms"] = cuda_ms(lambda: stat_scores_counts_cuda(*stack, device=dev))
    batched["plain_ms"] = cuda_ms(lambda: stat_scores_counts_torch(*stack))
    elems = BOOTSTRAPS * BATCH * NUM_CLASSES
    batched["bound_ms"], batched["bound_by"] = bound(2 * elems * 4 + 4 * BOOTSTRAPS * NUM_CLASSES * 4, 5 * elems)
    del stack

    real_indices, matrices = boot._bootstrap_indices, []

    def recording_indices(*args, **kwargs):
        idx = real_indices(*args, **kwargs)
        matrices.append(idx)
        return idx

    pure = build(dev)
    pure.apply_update(pure.init_state(), *batches[0])  # the first call's warm-up, not counted
    state = pure.init_state()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    boot._bootstrap_indices = recording_indices
    pure_ms = []
    try:
        for preds, target in batches:
            t0 = time.perf_counter()
            state = pure.apply_update(state, preds, target)
            torch.cuda.synchronize()
            pure_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        boot._bootstrap_indices = real_indices
    pure_launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    want_pure = {op: (len(batches) if op == "stat_scores_counts" else 0) for op in KERNEL_OPS}
    if pure_launches != want_pure:
        fail(f"[bootstrap] the pure path launched {pure_launches}, expected {want_pure}: B1's batched form once "
             "per update for all the children")

    def ten_updates():
        s = pure.init_state()
        for preds, target in batches[:10]:
            s = pure.apply_update(s, preds, target)

    pure_syncs = sync_calls(torch, ten_updates)
    if pure_syncs:
        fail(f"[bootstrap] the pure path made {len(pure_syncs)} synchronizing calls in 10 updates "
             f"({pure_syncs[:3]}), expected none")
    stats = pure.apply_compute(state, process_group=None)
    # the pure run replayed on the CPU with the card's index matrices
    cpu_pure = build("cpu")
    cpu_state = cpu_pure.init_state()
    replay_pure = iter(matrices)
    boot._bootstrap_indices = lambda *a, **k: next(replay_pure).cpu()
    try:
        for preds, target in batches:
            cpu_state = cpu_pure.apply_update(cpu_state, preds.cpu(), target.cpu())
    finally:
        boot._bootstrap_indices = real_indices
    want_pure_cpu = cpu_pure.apply_compute(cpu_state, process_group=None)
    pure_diff = max(float((stats[k].cpu() - want_pure_cpu[k]).abs().max()) for k in stats)
    if pure_diff > 1e-6:
        fail(f"[bootstrap] the pure statistics on the card differ from the CPU replay by {pure_diff:.2e}")
    plain = M.Accuracy(average="macro", num_classes=NUM_CLASSES, device=dev)
    for preds, target in batches:
        plain.update(preds, target)
    plain_value = float(plain.compute())
    mean, std = float(stats["mean"]), float(stats["std"])
    if not (abs(mean - plain_value) <= 4 * std and std > 0):
        fail(f"[bootstrap] pure mean {mean} is not within 4 std ({std}) of the plain accuracy {plain_value}")
    print(f"[bootstrap] BootStrapper(Accuracy(average='macro', num_classes={NUM_CLASSES}), {BOOTSTRAPS}, "
          f"quantile=[0.025, 0.975]) over the {len(batches)} ImageNet-1k batches on {card}: eager median "
          f"{statistics.median(eager_ms):.3f} ms an update, launches { {k: v for k, v in launches.items() if v} }, "
          f"{reads} Poisson totals read ({len(one_update)} synchronizing calls in one update), == the CPU replay of "
          f"the card's indices within {eager_diff:.1e}: mean {float(got['mean']):.5f}, 95% interval "
          f"[{float(got['quantile'][0]):.5f}, {float(got['quantile'][1]):.5f}]; pure median "
          f"{statistics.median(pure_ms):.3f} ms an update, launches "
          f"{ {k: v for k, v in pure_launches.items() if v} } over {len(batches)} updates, no synchronizing call "
          f"in 10, == the CPU replay of the card's index matrices within {pure_diff:.1e}: mean {mean:.5f} std "
          f"{std:.5f}, plain accuracy {plain_value:.5f}; B1 batched {batched['shape']}: "
          f"{batched['ms']:.4f} ms (plain {batched['plain_ms']:.4f} ms, bound {batched['bound_ms']:.4f} ms, "
          f"{batched['bound_by']}), == plain")
    record["bootstrap"] = {"eager_ms": eager_ms, "pure_ms": pure_ms, "launches": launches,
                           "pure_launches": pure_launches, "host_reads": reads, "syncs_one_update": len(one_update),
                           "eager_diff_cpu": eager_diff, "pure_diff_cpu": pure_diff, "b1_batched": batched,
                           "eager": {k: v.tolist() for k, v in got.items()},
                           "pure": {k: v.tolist() for k, v in stats.items()}, "plain": plain_value}


def small_metrics_phase(torch, M, dev, card, batches, keyed_batches) -> dict:
    """Phase 3l: the small metrics of the last slice at full width (see the
    module docstring)."""
    import numpy as np

    from metrics_tpu_torch.kernels import _common

    record = {"part_s": {}}
    t0 = time.perf_counter()
    for name, run in (
        ("speech", lambda: _speech_separation(torch, np, M, dev, card, _common, record)),
        ("speech_keyed", lambda: _speech_keyed(torch, M, dev, card, _common, keyed_batches, record)),
        ("bleu", lambda: _bleu(torch, np, dev, card, record)),
        ("similarity", lambda: _embedding_similarity(torch, M, dev, card, record)),
        ("image_gradients", lambda: _image_gradients(torch, dev, card, record)),
        ("bootstrap", lambda: _bootstrap(torch, M, dev, card, _common, batches, record)),
    ):
        start = time.perf_counter()
        run()
        record["part_s"][name] = time.perf_counter() - start
    record["phase_s"] = time.perf_counter() - t0
    print(f"[small] phase 3l took {record['phase_s']:.1f} s on {card}: "
          f"{ {k: round(v, 1) for k, v in record['part_s'].items()} } s")
    return record


def small_metrics_phase_main(record_path: str = "") -> int:
    """Run :func:`small_metrics_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(lambda torch, M, dev, card: small_metrics_phase(
        torch, M, dev, card, make_batches(torch, dev), make_keyed_batches(torch, dev)), record_path)


# --------------------------------------------------------------------------
# phase 3m: the generative metrics
# --------------------------------------------------------------------------

#: CIFAR-10 FID as generative models report it (50,000 real and 50,000
#: generated 32 x 32 images), cut to 4,000 of each to fit the script's time
GEN_IMAGES = 4000
GEN_BATCH = 250
GEN_SIDE = 32
KID_SUBSETS = 100
KID_SUBSET_SIZE = 1000
IS_SPLITS = 10
#: images of the first batch whose features are held against the CPU's
GEN_CPU_CHECK = 32
#: features zeroed for the dead-feature FID check (as many as the seeded net
#: with identity batch norms left dead), and images a side for the rescue check
FID_DEAD = 123
FID_FEW = 1000
#: operations of one InceptionV3 forward at 299 x 299 (5.7 G multiply-adds)
INCEPTION_OPS = 11.4e9


def make_generative_images(torch, dev):
    """Seeded uint8 CIFAR-10-shaped images in batches of 250: "real" ones are
    random fields at three scales (4, 8 and 16 a side, upsampled) with
    grain, "generated" ones the same with a slight colour cast."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)

    def batch(cast):
        fields = torch.zeros((GEN_BATCH, 3, GEN_SIDE, GEN_SIDE), device=dev)
        for size, weight in ((4, 0.5), (8, 0.3), (16, 0.2)):
            coarse = torch.rand((GEN_BATCH, 3, size, size), generator=gen, device=dev)
            fields += weight * torch.nn.functional.interpolate(coarse, size=(GEN_SIDE, GEN_SIDE), mode="bilinear",
                                                               align_corners=False)
        noise = torch.randn((GEN_BATCH, 3, GEN_SIDE, GEN_SIDE), generator=gen, device=dev) * 0.1
        shift = torch.tensor(cast, device=dev).view(1, 3, 1, 1)
        return torch.clamp((fields + shift + noise) * 255.0, 0, 255).to(torch.uint8)

    count = GEN_IMAGES // GEN_BATCH
    real = [batch((0.0, 0.0, 0.0)) for _ in range(count)]
    fake = [batch((0.03, -0.02, 0.02)) for _ in range(count)]
    return real, fake


def calibrated_inception(torch, seed, imgs):
    """The seeded InceptionV3 with its batch norms' running statistics taken
    from ``imgs`` (resized and normalized as the extractor does), as a
    trained net's come from its data: with the identity statistics of
    :func:`~metrics_tpu_torch.image.inception_net.seeded_inception`, about a
    sixteenth of the 2048 features are zero for every image (a ReLU channel
    negative everywhere), and the covariances are singular."""
    from metrics_tpu_torch.image.inception_net import _bilinear_resize, seeded_inception

    net = seeded_inception(seed).to(imgs.device)
    for module in net.modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            module.momentum = None  # a cumulative average: one batch sets the statistics
            module.reset_running_stats()
    net.train()
    with torch.no_grad():
        net(_bilinear_resize((imgs.to(torch.float32) - 128.0) / 128.0, 299))
    return net.eval()


def _np_kid(np, real, fake, real_idx, fake_idx, degree=3, coef=1.0):
    """KID's per-subset unbiased MMD² in float64 numpy from the three full
    kernel matrices, indexed by each subset's rows."""
    gamma = 1.0 / real.shape[1]
    k_rr = (real @ real.T * gamma + coef) ** degree
    k_ff = (fake @ fake.T * gamma + coef) ** degree
    k_rf = (real @ fake.T * gamma + coef) ** degree
    m = real_idx.shape[1]
    scores = []
    for r, f in zip(real_idx, fake_idx):
        kxx, kyy, kxy = k_rr[np.ix_(r, r)], k_ff[np.ix_(f, f)], k_rf[np.ix_(r, f)]
        scores.append((kxx.sum() - np.trace(kxx)) / (m * (m - 1)) + (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
                      - 2 * kxy.sum() / m ** 2)
    return np.mean(scores), np.std(scores)


def _np_is(np, logits, perm, splits):
    """The inception score in float64 numpy on the given permutation."""
    import scipy.special

    x = logits[perm].astype(np.float64)
    n = x.shape[0] // splits
    x = x[: n * splits].reshape(splits, n, -1)
    log_p = x - scipy.special.logsumexp(x, axis=-1, keepdims=True)
    p = np.exp(log_p)
    marginal = p.mean(axis=1, keepdims=True)
    scores = np.exp((p * (log_p - np.log(marginal))).sum(-1).mean(-1))
    return scores.mean(), scores.std(ddof=1)


def _np_fid_eigh(np, mu1, c1, mu2, c2, jitter=0.0):
    """FID in float64 numpy by the symmetric form
    ``Tr((C1^1/2 C2 C1^1/2)^1/2)``, the square roots from LAPACK's eigh with
    negative eigenvalues clipped to zero; ``jitter`` is added to both
    diagonals inside the square root only, as the port's rescue does."""
    eye = np.eye(c1.shape[0]) * jitter
    w, v = np.linalg.eigh((c1 + c1.T) / 2 + eye)
    half = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
    inner = half @ (c2 + eye) @ half
    trace = np.sqrt(np.clip(np.linalg.eigvalsh((inner + inner.T) / 2), 0, None)).sum()
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(c1) + np.trace(c2) - 2 * trace)


def _singular_fid(torch, np, fid_mod, real_f, fake_f) -> dict:
    """FID on singular covariances. (a) The card's features with their first
    ``FID_DEAD`` columns zeroed (dead features, as a net with identity batch
    norms leaves them) and (b) the first ``FID_FEW`` images a side (fewer
    samples than dims), both on the float64 moments and the ``'auto'`` form
    (Newton-Schulz), each against :func:`_np_fid_eigh` (on the live columns
    for (a); with the rescue's jitter where the rescue ran). (c) The rescue
    branch itself: float32 moments of 33 seeded normal samples a side at
    d = 512, where Newton-Schulz goes non-finite and the jittered eigh rescue
    must run, against the port's CPU result of the same call."""
    import warnings

    def fid_of(mu1, c1, mu2, c2, method):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            value = float(fid_mod._compute_fid(mu1, c1, mu2, c2, method=method))
        return value, any("non-finite" in str(w.message) for w in seen)

    out = {}
    zeroed = [f.clone() for f in (real_f, fake_f)]
    for f in zeroed:
        f[:, :FID_DEAD] = 0.0
    few = [f[:FID_FEW] for f in (real_f, fake_f)]
    jitter = 1e-6  # _compute_fid's default eps
    for case, (r, f) in (("dead", zeroed), ("few", few)):
        mu1, c1 = fid_mod._mean_cov(r)
        mu2, c2 = fid_mod._mean_cov(f)
        method = fid_mod.resolve_sqrtm_method(r.shape[0], r.shape[1], "auto")
        value, rescued = fid_of(mu1, c1, mu2, c2, method)
        r_np, f_np = r.cpu().numpy(), f.cpu().numpy()
        if case == "dead":
            r_np, f_np = r_np[:, FID_DEAD:], f_np[:, FID_DEAD:]
        oracle = _np_fid_eigh(np, r_np.mean(0), np.cov(r_np, rowvar=False), f_np.mean(0),
                              np.cov(f_np, rowvar=False), jitter if rescued else 0.0)
        out[case] = {"method": method, "rescued": rescued, "fid": value, "oracle": oracle,
                     "rel": _rel_diff(value, oracle), "samples": int(r.shape[0])}
    rng = np.random.RandomState(3)
    sides = [torch.from_numpy(rng.randn(33, 512).astype(np.float32)) for _ in range(2)]
    results = []
    for device in (real_f.device, "cpu"):
        (mu1, c1), (mu2, c2) = (fid_mod._mean_cov(x.to(device)) for x in sides)
        results.append(fid_of(mu1, c1, mu2, c2, "ns"))
    (card_value, card_rescued), (cpu_value, cpu_rescued) = results
    out["rescue"] = {"method": "ns", "rescued": card_rescued and cpu_rescued, "fid": card_value, "cpu": cpu_value,
                     "rel": _rel_diff(card_value, cpu_value), "samples": 33}
    return out


def generative_phase(torch, M, dev, card) -> dict:
    """Phase 3m: FID (buffered and streaming), KID and IS on a CIFAR-10-shaped
    stream through the InceptionV3 port with seeded weights (see the module
    docstring)."""
    import warnings

    import numpy as np
    import scipy.linalg

    import metrics_tpu_torch.image.fid as fid_mod
    from metrics_tpu_torch.image.inception_net import InceptionFeatureExtractor, seeded_inception
    from metrics_tpu_torch.image.kid import subset_indices
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.utilities.data import full_fp32

    record = {}
    t_phase = time.perf_counter()
    real, fake = make_generative_images(torch, dev)
    with full_fp32(dev):
        net = calibrated_inception(torch, SEED, real[0])
    pool = InceptionFeatureExtractor(2048, net=net, device=dev)
    logits = InceptionFeatureExtractor("logits_unbiased", net=net, device=dev)
    # the first batch's features on the card against the port on the CPU
    # (its first GEN_CPU_CHECK images: the CPU takes about 0.1 s an image)
    cpu_net = seeded_inception(SEED)
    cpu_net.load_state_dict(net.state_dict())
    first = pool(real[0][:GEN_CPU_CHECK])
    cpu_first = InceptionFeatureExtractor(2048, net=cpu_net, device="cpu")(real[0][:GEN_CPU_CHECK].cpu())
    feat_diff = float((first.cpu() - cpu_first).abs().max() / cpu_first.abs().max())
    if feat_diff > 1e-3:
        fail(f"[generative] the first batch's 2048-d features differ from the CPU's by {feat_diff:.2e} (limit 1e-3)")
    # the extractor alone: images/s at 299 x 299 from 32 x 32 uint8
    ext_ms = cuda_ms(lambda: pool(real[1]), reps=10, warmup=2)
    images_s = GEN_BATCH / ext_ms * 1e3
    bound_s = PEAK_OPS_PER_S / INCEPTION_OPS

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the buffered metrics' footprint notices
        fid = M.FID(feature=pool, device=dev)
        fid_stream = M.FID(feature=pool, streaming=True, feature_dim=2048, device=dev)
        kid = M.KID(feature=pool, subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, device=dev)
        inception = M.IS(feature=logits, splits=IS_SPLITS, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _common.reset_dispatch_counters()
    update_ms = {"FID": [], "FID(streaming)": [], "KID": [], "IS": []}
    for batches, is_real in ((real, True), (fake, False)):
        for imgs in batches:
            for name, metric in (("FID", fid), ("FID(streaming)", fid_stream), ("KID", kid)):
                t0 = time.perf_counter()
                metric.update(imgs, real=is_real)
                torch.cuda.synchronize()
                update_ms[name].append((time.perf_counter() - t0) * 1e3)
            if not is_real:
                t0 = time.perf_counter()
                inception.update(imgs)
                torch.cuda.synchronize()
                update_ms["IS"].append((time.perf_counter() - t0) * 1e3)
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    if any(launches.values()):
        fail(f"[generative] a kernel launched on the generative metrics, which have none: {launches}")
    compute_ms, values = {}, {}
    for name, metric in (("FID", fid), ("FID(streaming)", fid_stream), ("KID", kid), ("IS", inception)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = metric.compute()
        out = [float(v) for v in out] if isinstance(out, tuple) else float(out)
        compute_ms[name] = (time.perf_counter() - t0) * 1e3
        values[name] = out
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    real_f = torch.cat(fid.real_features).double()
    fake_f = torch.cat(fid.fake_features).double()
    # the 2048 x 2048 square root alone, each form, on the card's float64 moments
    mu1, cov1 = fid_mod._mean_cov(real_f)
    mu2, cov2 = fid_mod._mean_cov(fake_f)
    sqrtm = {}
    for method in ("ns", "eigh"):
        fid_mod._trace_sqrt_product(cov1, cov2, method)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace = float(fid_mod._trace_sqrt_product(cov1, cov2, method))
        sqrtm[method] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "fid": float(fid_mod._compute_fid(mu1, cov1, mu2, cov2, method=method)), "trace": trace}
    # the float64 scipy formula on the same features
    t0 = time.perf_counter()
    r_np, f_np = real_f.cpu().numpy(), fake_f.cpu().numpy()
    c1, c2 = np.cov(r_np, rowvar=False), np.cov(f_np, rowvar=False)
    covmean = scipy.linalg.sqrtm(c1 @ c2).real
    scipy_fid = float(((r_np.mean(0) - f_np.mean(0)) ** 2).sum() + np.trace(c1 + c2 - 2 * covmean))
    scipy_s = time.perf_counter() - t0
    checks = {
        "FID vs scipy": _rel_diff(values["FID"], scipy_fid),
        "FID(streaming) vs scipy": _rel_diff(values["FID(streaming)"], scipy_fid),
        "ns vs eigh": _rel_diff(sqrtm["ns"]["fid"], sqrtm["eigh"]["fid"]),
    }
    limits = {"FID vs scipy": 1e-3, "FID(streaming) vs scipy": 1e-3, "ns vs eigh": 1e-3}
    # KID against the float64 numpy oracle on the same subsets
    gen = torch.Generator().manual_seed(kid.rng_seed)
    ridx = subset_indices(gen, KID_SUBSETS, GEN_IMAGES, KID_SUBSET_SIZE).numpy()
    fidx = subset_indices(gen, KID_SUBSETS, GEN_IMAGES, KID_SUBSET_SIZE).numpy()
    kid_mean, kid_std = _np_kid(np, torch.cat(kid.real_features).double().cpu().numpy(),
                                torch.cat(kid.fake_features).double().cpu().numpy(), ridx, fidx)
    checks["KID vs numpy"] = _rel_diff(values["KID"][0], kid_mean)
    perm = torch.randperm(GEN_IMAGES, generator=torch.Generator().manual_seed(inception.rng_seed)).numpy()
    is_mean, is_std = _np_is(np, torch.cat(inception.features).double().cpu().numpy(), perm, IS_SPLITS)
    checks["IS vs numpy"] = _rel_diff(values["IS"][0], is_mean)
    limits.update({"KID vs numpy": 1e-4, "IS vs numpy": 1e-4})
    t0 = time.perf_counter()
    singular = _singular_fid(torch, np, fid_mod, real_f, fake_f)
    singular_s = time.perf_counter() - t0
    if not singular["rescue"]["rescued"]:
        fail(f"[generative] float32 FID on 33 samples a side took no rescue on the Newton-Schulz form: "
             f"{singular['rescue']}")
    checks["FID dead features vs eigh oracle"] = singular["dead"]["rel"]
    checks["FID few samples vs eigh oracle"] = singular["few"]["rel"]
    checks["FID float32 rescue vs CPU"] = singular["rescue"]["rel"]
    limits.update({"FID dead features vs eigh oracle": 1e-4, "FID few samples vs eigh oracle": 1e-4,
                   "FID float32 rescue vs CPU": 1e-3})
    record.update({
        "feature_rel_diff_cpu": feat_diff, "extractor_ms_per_batch": ext_ms, "images_per_s": images_s,
        "images_per_s_bound": bound_s, "update_ms": update_ms, "compute_ms": compute_ms, "values": values,
        "sqrtm": sqrtm, "scipy_fid": scipy_fid, "scipy_s": scipy_s, "kid_oracle": [kid_mean, kid_std],
        "is_oracle": [is_mean, is_std], "checks": checks, "peak_memory_gb": peak_gb, "launches": launches,
        "singular": singular, "singular_s": singular_s,
    })
    record["phase_s"] = time.perf_counter() - t_phase
    medians = {k: round(statistics.median(v), 3) for k, v in update_ms.items()}
    print(f"[generative] CIFAR-10-shaped FID/KID/IS ({GEN_IMAGES} real + {GEN_IMAGES} generated uint8 3 x {GEN_SIDE} x "
          f"{GEN_SIDE}, batches of {GEN_BATCH}, resized to 299; InceptionV3 with seeded weights, batch-norm statistics from the first real batch) on {card}: the first "
          f"batch's first {GEN_CPU_CHECK} images' features == CPU within {feat_diff:.1e}; extractor {images_s:.0f} images/s (bound "
          f"{bound_s:.0f} images/s at {INCEPTION_OPS / 1e9:.1f} GFLOP an image, float32 peak); update median ms "
          f"{medians}; compute ms { {k: round(v, 1) for k, v in compute_ms.items()} }, the 2048 x 2048 trace "
          f"term alone: ns {sqrtm['ns']['ms']:.1f} ms, eigh {sqrtm['eigh']['ms']:.1f} ms; values {values}; scipy "
          f"sqrtm FID {scipy_fid:.6f} ({scipy_s:.1f} s on the host); singular covariances ({singular_s:.1f} s): "
          f"{FID_DEAD} dead features on '{singular['dead']['method']}' (rescued: {singular['dead']['rescued']}), "
          f"{FID_FEW} samples a side on '{singular['few']['method']}' (rescued: {singular['few']['rescued']}), "
          f"float32 33 a side on 'ns' (rescued: {singular['rescue']['rescued']}); checks "
          f"{ {k: f'{v:.1e}' for k, v in checks.items()} }; no kernel; peak memory {peak_gb:.2f} GB; phase 3m took "
          f"{record['phase_s']:.1f} s")
    for what, rel in checks.items():
        if not rel <= limits[what]:
            fail(f"[generative] {what}: {rel:.2e} apart (relative; limit {limits[what]:.0e})")
    if not all(np.isfinite(values["IS"])):
        fail(f"[generative] IS {values['IS']} is not finite")
    return record


def generative_phase_main(record_path: str = "") -> int:
    """Run :func:`generative_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(generative_phase, record_path)


# --------------------------------------------------------------------------
# phase 3n: the observability plane on the main paths
# --------------------------------------------------------------------------

#: phase 3n: the sampling stride of the dispatch profiler, the keyed cohort
#: that carries the NaN, and the event log's room for the phase
OBS_PROFILE_EVERY = 10
OBS_NAN_COHORT = 20
OBS_EVENT_CAPACITY = 65_536


def _obs_compiled(torch, M, dev, card, batches, record) -> None:
    """Phase 3n-a: the ImageNet-1k collection compiled, with health
    ``"record"`` and the profiler sampling every 10th dispatch; then with
    everything off (phase 3i's launches and synchronizing calls); then health
    on and off interleaved call by call."""
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.observability.profiling import split_series_keys

    scope_ops = ("stat_scores_counts", "confmat_counts")
    observability.set_health_policy("record")
    observability.set_profiling(OBS_PROFILE_EVERY)
    comp = build_collection(M, dev).jit_forward()
    comp.warmup(*batches[0])
    comp.warmup(*batches[-1])
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    before = observability.snapshot()["profiling"]["dispatches"].get("compiled", 0)
    syncs = sync_calls(torch, lambda: [comp(*b) for b in batches])
    torch.cuda.synchronize()
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    if launches != {op: (len(batches) if op in scope_ops else 0) for op in KERNEL_OPS}:
        fail(f"[observability] the armed compiled forward launched {launches}, expected B1 and B2 49 each")
    prof_summary = observability.snapshot()["profiling"]
    samples = prof_summary["samples"]["compiled"]
    if prof_summary["dispatches"]["compiled"] - before != len(batches) or samples != -(-len(batches) // OBS_PROFILE_EVERY):
        fail(f"[observability] the profiler counted {prof_summary}, expected 49 dispatches and 5 samples")
    # every synchronizing call of the run is a sampled dispatch's deliberate
    # wait on the stream (``Stream.synchronize``, one a sample)
    guard_syncs = [s for s in syncs if "torch/cuda/streams.py" not in s]
    if guard_syncs or len(syncs) != samples:
        fail(f"[observability] the armed compiled forwards made {len(syncs)} synchronizing calls for {samples} "
             f"samples; outside the samples' stream waits: {guard_syncs[:5]}")
    in_flight = observability.HEALTH.in_flight()
    torch.cuda.synchronize()
    observability.HEALTH.drain()
    health = observability.HEALTH.summary()
    checks = sum(r["checks"] for r in health["metrics"].values())
    if health["unhealthy_total"] or not checks or observability.HEALTH.in_flight():
        fail(f"[observability] the compiled collection's health after the drain: {health}")
    # health alone (no profiler): no synchronizing call at all
    observability.set_profiling(0)
    guard_alone = sync_calls(torch, lambda: [comp(*b) for b in batches[1:11]])
    if guard_alone:
        fail(f"[observability] 10 compiled forwards with health armed made {len(guard_alone)} synchronizing calls")
    # one sampled forward: the profiler's device window beside the torch profiler's device time
    observability.set_profiling(1)
    host_key, device_key = split_series_keys("compiled")
    hist = observability.HISTOGRAMS.get("dispatch_device_seconds", unit="s", path="compiled")
    sum_before = hist.sum
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tprof:
        comp(*batches[5])
        torch.cuda.synchronize()
    sampled_ms = (hist.sum - sum_before) * 1e3
    traced_ms = _device_us(tprof) / 1e3
    hists = observability.snapshot()["histograms"]
    split = {k: {"count": hists[k]["count"], "p50_ms": hists[k]["p50"] * 1e3, "p99_ms": hists[k]["p99"] * 1e3}
             for k in (host_key, device_key)}
    observability.set_profiling(0)
    record["armed"] = {"launches": launches, "sync_calls": len(syncs), "sync_sites": sorted(set(syncs)),
                       "samples": samples, "health_checks": checks, "in_flight_at_end": in_flight,
                       "split": split, "sampled_device_ms": sampled_ms, "profiler_device_ms": traced_ms,
                       "guard_alone_sync_calls": len(guard_alone)}
    print(f"[observability] ImageNet-1k collection compiled, health record + profiling every {OBS_PROFILE_EVERY} on "
          f"{card}: launches {launches}; {len(syncs)} synchronizing calls, every one a profiled sample's wait "
          f"({samples} samples; sites {sorted(set(syncs))}), 0 from the health guard (10 forwards with health alone: "
          f"{len(guard_alone)}); {in_flight} flag copies in flight after the last forward, health after the drain: "
          f"{checks} checks, unhealthy {health['unhealthy_total']}; split {split}; one sampled forward: "
          f"dispatch_device_seconds {sampled_ms:.4f} ms beside the torch profiler's device time {traced_ms:.4f} ms")

    # everything off: phase 3i's launches, captures and synchronizing calls
    observability.set_health_policy("off")
    plain = build_collection(M, dev).jit_forward()
    plain.warmup(*batches[0])
    plain.warmup(*batches[-1])
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    for preds, target in batches:
        plain(preds, target)
    torch.cuda.synchronize()
    off_launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    off_syncs = sync_calls(torch, lambda: [plain(*b) for b in batches[1:11]])
    cache = plain._jit_forward_fn.cache_info()
    tallies = [dict(e.tally) for e in plain._jit_forward_fn._cache.values()]
    if off_launches != launches or off_syncs or cache["entries"] != 2 or any(
            t != {"stat_scores_counts": 1, "confmat_counts": 1} for t in tallies):
        fail(f"[observability] everything off: launches {off_launches}, {len(off_syncs)} synchronizing calls, cache "
             f"{cache}, launches per replay {tallies}; phase 3i's are B1 49, B2 49, 0, two captures, one each")
    # health on against health off, call by call (each collection replays the graph captured under its policy)
    on_ms, off_ms = [], []
    for _ in range(2):
        for preds, target in batches:
            for policy, coll, out in (("record", comp, on_ms), ("off", plain, off_ms)):
                observability.set_health_policy(policy)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                coll(preds, target)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
    observability.set_health_policy("off")
    ratio = statistics.median(on_ms) / statistics.median(off_ms)
    record["off"] = {"launches": off_launches, "sync_calls": len(off_syncs), "cache": cache,
                     "launches_per_replay": tallies}
    record["health_cost"] = {"on_ms": on_ms, "off_ms": off_ms, "ratio": ratio}
    print(f"[observability] everything off: launches {off_launches}, {len(off_syncs)} synchronizing calls in 10 "
          f"forwards, captures {cache['entries']}, launches per replay {tallies[0]} (phase 3i's); health on/off "
          f"interleaved over 2 x 49 forwards: median {statistics.median(on_ms):.4f} / {statistics.median(off_ms):.4f} ms "
          f"(ratio {ratio:.4f})")


def _obs_keyed(torch, np, M, dev, card, keyed_batches, record) -> None:
    """Phase 3n-b: phase 3j-b's keyed regression collection with one NaN pred
    in cohort 20, eager and compiled (the health event names the state and
    the update within one dispatch), then through an admission queue with
    ``quarantine="auto"`` (the NaN row shed as ``"poisoned"``; the state ==
    the CPU run over the clean rows). Phase 3n-c: the memory ledger."""
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.serving import AdmissionQueue

    cohorts = _keyed_regression_cohorts(torch, keyed_batches, dev)
    ids20 = cohorts[OBS_NAN_COHORT][0]
    row = int(torch.nonzero(ids20 >= 0)[0])
    preds20 = cohorts[OBS_NAN_COHORT][1].clone()
    preds20[row] = float("nan")
    cohorts[OBS_NAN_COHORT] = (ids20, preds20, cohorts[OBS_NAN_COHORT][2])

    def build(device):
        return M.MultiTenantCollection([M.MeanSquaredError(device=device), M.MeanAbsoluteError(device=device),
                                        M.PearsonCorrcoef(streaming=True, device=device)], KEYED_TENANTS,
                                       validate_ids=False, device=device)

    def health_events():
        return [e for e in observability.EVENTS.events() if e.kind == "health"]

    observability.set_health_policy("record")
    out = {}
    for mode in ("eager", "compiled"):
        kgpu = build(dev)
        if mode == "compiled":
            kgpu.warmup(*cohorts[0])
        seen = len(health_events())
        torch.cuda.synchronize()
        _common.reset_dispatch_counters()
        for i, (ids, preds, target) in enumerate(cohorts):
            with observability.step_context(i):
                kgpu.update(ids, preds, target)
        torch.cuda.synchronize()
        with observability.step_context(len(cohorts)):
            observability.HEALTH.drain()
        launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
        expected = {op: (KEYED_UPDATES if op == "segment_merge" else 0) for op in KERNEL_OPS}
        if launches != expected:
            fail(f"[observability] keyed regression {mode}: launches {launches}, expected the merge 50")
        events = health_events()[seen:]
        flagged = {e.metric: sorted(e.payload["nan"]) for e in events}
        steps = sorted({e.step for e in events})
        lag_ok = steps == [OBS_NAN_COHORT] if mode == "eager" else (steps and steps[0] in (OBS_NAN_COHORT, OBS_NAN_COHORT + 1))
        if len(events) != 3 or not lag_ok or not all(names for names in flagged.values()):
            fail(f"[observability] keyed regression {mode}: health events {[(e.metric, e.step, e.payload) for e in events]}; "
                 f"expected one per member naming its states, at step {OBS_NAN_COHORT} (compiled: or the next)")
        out[mode] = {"launches": launches, "events": [(e.metric, e.step, e.payload["source"], e.payload["nan"])
                                                      for e in events]}
        if mode == "eager":
            keyed_eager = kgpu
    record["keyed_health"] = out
    print(f"[observability] keyed regression (10,000 tenants, 50 cohorts, NaN pred in cohort {OBS_NAN_COHORT}) on "
          f"{card}: eager launches {out['eager']['launches']}, health events {out['eager']['events']}; compiled "
          f"(warmup) launches {out['compiled']['launches']}, events {out['compiled']['events']} (step = the dispatch "
          f"that noted it)")

    # the same cohorts through the queue: quarantine "auto" follows the policy
    unhealthy_before = observability.HEALTH.summary()["unhealthy_total"]
    kq = build(dev)
    q = AdmissionQueue(kq.update, start=False, max_batch=KEYED_ROWS, pad_to_bucket=True,
                                 quarantine="auto", device=dev)
    host = _host_cohorts(keyed_batches)
    host = [(ids, c[1].cpu().numpy()[: len(ids)], c[2].cpu().numpy()[: len(ids)]) for (ids, _, _), c in zip(host, cohorts)]
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    for ids, preds, target in host:
        q.submit_many(ids, preds, target)
        q.flush()
    torch.cuda.synchronize()
    q_launches = _common.launch_count("segment_merge")
    stats = check_ledger("observability queue", q, kq.tenant_report()["rows_routed"])
    q.close()
    if stats["shed_by_reason"] != {"poisoned": 1} or observability.HEALTH.summary()["unhealthy_total"] != unhealthy_before:
        fail(f"[observability] quarantine auto: shed {stats['shed_by_reason']}, health events added "
             f"{observability.HEALTH.summary()['unhealthy_total'] - unhealthy_before}; expected 1 poisoned row, none")
    kcpu = build("cpu")
    for ids, preds, target in host:
        keep = ~np.isnan(preds)
        kcpu.update(torch.from_numpy(ids[keep]), torch.from_numpy(preds[keep]), torch.from_numpy(target[keep]))
    for owner, km in kq._keyed.items():
        for name, value in km._get_states().items():
            if not torch.equal(value.cpu(), getattr(kcpu._keyed[owner], name)):
                fail(f"[observability] quarantined queue: {owner}.{name} differs from the CPU run over the clean rows")
    record["quarantine"] = {"shed_by_reason": stats["shed_by_reason"], "launches": q_launches,
                            "flushes": stats["flushes"]}
    print(f"[observability] the same cohorts through AdmissionQueue(quarantine='auto') with health record: shed "
          f"{stats['shed_by_reason']}, {stats['flushes']} flushes, the merge {q_launches}; states == the CPU run "
          "over the "
          f"clean rows exactly")
    observability.set_health_policy("off")

    # 3n-c: the memory ledger of the 10,000-tenant keyed collection
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for km in keyed_eager._keyed.values() for v in km._get_states().values())
    observability.LEDGER.track(keyed_eager)
    report = observability.memory_report()
    entry = report["owners"][keyed_eager.telemetry_key]
    if entry["device_bytes"] != nbytes or not report["conservation_ok"]:
        fail(f"[observability] the ledger reads {entry}, the states' nbytes {nbytes} ({report})")
    warm = build(dev)
    warm_report = warm.warmup(*cohorts[0])
    if warm_report["state_memory"] != {o: km.state_memory_report() for o, km in warm._keyed.items()}:
        fail("[observability] warmup's state_memory differs from state_memory_report()")
    fired = []
    handle = observability.on_pressure(fired.append, high=report["tracked_bytes"] + nbytes // 2)
    second = build(dev)
    second.build()
    observability.LEDGER.track(second)  # crosses the watermark once
    observability.LEDGER.note(second)  # still above it: no second call
    handle.cancel()
    states = [v for km in second._keyed.values() for v in km._get_states().values()]
    tensors = len(states)
    alloc = sum(allocator_blocks(torch, states))
    if len(fired) != 1:
        fail(f"[observability] the pressure watermark fired {len(fired)} times, expected once")
    if not 0 <= alloc - nbytes <= 512 * tensors:
        fail(f"[observability] the allocator's blocks of the {tensors} state tensors hold {alloc} bytes for {nbytes} "
             "bytes of state")
    summary = observability.snapshot()["memory"]
    record["memory"] = {"state_bytes": nbytes, "ledger": entry, "allocator_bytes": alloc, "tensors": tensors,
                        "pressure_calls": len(fired), "summary": summary}
    print(f"[observability] memory: the keyed collection's {nbytes} bytes of state == the ledger's "
          f"{entry['device_bytes']} (conservation ok), warmup's state_memory == state_memory_report(), the allocator's "
          f"blocks of a second one's {tensors} state tensors hold {alloc} bytes (within 512 each), the watermark fired "
          f"{len(fired)} time; snapshot memory {summary}")
    observability.LEDGER.untrack(second)


def _obs_exports(torch, card, record) -> None:
    """Phase 3n-e: ``timeline.export`` and ``export_fleet`` and
    ``aggregate_snapshots`` over an NCCL group of world size 1."""
    import socket
    import tempfile

    import torch.distributed as dist
    from metrics_tpu_torch import observability

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        aggregated = observability.aggregate_snapshots()
        with tempfile.TemporaryDirectory() as tmp:
            local = observability.timeline.export(os.path.join(tmp, "timeline.json"))
            fleet = observability.timeline.export_fleet(os.path.join(tmp, "fleet.json"))
            docs = {}
            for name, path in (("timeline", local), ("fleet", fleet)):
                with open(path) as fh:
                    docs[name] = json.load(fh)
                docs[name]["bytes"] = os.path.getsize(path)
    finally:
        dist.destroy_process_group()
    tracks = {}
    for name, doc in docs.items():
        events = doc["traceEvents"]
        threads = {e["args"]["name"] for e in events if e.get("name") == "thread_name"}
        tracks[name] = {
            "serving": "<serving>" in threads or any(e.get("name", "").startswith("serving") for e in events),
            "profile": any(e.get("cat") == "profile" for e in events),
            "memory": any(e.get("name") == "memory.tracked_bytes" for e in events),
            "collective": "<collectives>" in threads and any(e.get("cat") == "collective" for e in events),
        }
    if not (tracks["timeline"]["serving"] and tracks["timeline"]["profile"] and tracks["timeline"]["memory"]
            and tracks["fleet"]["collective"] and tracks["fleet"]["profile"] and tracks["fleet"]["serving"]):
        fail(f"[observability] exported tracks {tracks}")
    merged = aggregated["merged"]
    if aggregated["process_count"] != 1 or not all(merged.get(k) for k in ("health", "profiling", "memory", "retrace")):
        fail(f"[observability] aggregate_snapshots over the NCCL group: {aggregated['process_count']} processes, "
             f"sections {[k for k in merged if merged[k]]}")
    record["exports"] = {"tracks": tracks, "bytes": {k: d["bytes"] for k, d in docs.items()},
                         "trace_events": {k: len(d["traceEvents"]) for k, d in docs.items()},
                         "aggregated_sections": sorted(k for k in merged if merged[k])}
    print(f"[observability] timeline.export ({docs['timeline']['bytes']} bytes, {len(docs['timeline']['traceEvents'])} "
          f"events) and export_fleet ({docs['fleet']['bytes']} bytes) load back as JSON with tracks {tracks}; "
          f"aggregate_snapshots over the one-rank NCCL group: 1 process, sections {record['exports']['aggregated_sections']}")


def allocator_blocks(torch, tensors) -> list:
    """The size of the caching allocator's block under each tensor (from
    ``torch.cuda.memory_snapshot()``; a tensor that starts no block fails)."""
    ptrs = {t.data_ptr() for t in tensors}
    sizes = {}
    for segment in torch.cuda.memory_snapshot():
        address = segment["address"]
        for block in segment["blocks"]:
            if address in ptrs:
                sizes[address] = block["size"]
            address += block["size"]
    if set(sizes) != ptrs:
        fail(f"[observability] {len(ptrs) - len(sizes)} state tensors start no allocator block")
    return [sizes[t.data_ptr()] for t in tensors]


def observability_phase(torch, M, dev, card, soak=None) -> dict:
    """Phase 3n: the observability plane armed on the main paths (3n-a to
    3n-e of the module docstring). ``soak`` is phase 3h's staged soak record
    (its SLO ticks); alone, a 3 s soak stands in."""
    import numpy as np

    from metrics_tpu_torch import observability

    start = time.perf_counter()
    record = {}
    if soak is None:  # first: the soak resets the observability plane
        soak = serving_soak(torch, M, dev, True, card, seconds=3.0)
    observability.reset()
    capacity = observability.EVENTS.capacity
    observability.EVENTS.set_capacity(OBS_EVENT_CAPACITY)
    try:
        _obs_compiled(torch, M, dev, card, make_batches(torch, dev), record)
        _obs_keyed(torch, np, M, dev, card, make_keyed_batches(torch, dev), record)
        # 3n-d: the SLO on the soak's ingest histogram, ticked each second
        ticks = soak["slo_ticks"]
        if not ticks:
            fail("[observability] the soak's SLO watchdog never ticked")
        record["slo"] = {"ticks": ticks, "breaches_total": soak["slo_breaches_total"]}
        print(f"[observability] SLO ingest p99 <= {SOAK_SLO_S * 1e3:.0f} ms over the staged soak, ticked each second: "
              f"burn rates fast {[round(t['fast_burn'], 4) for t in ticks]}, slow "
              f"{[round(t['slow_burn'], 4) for t in ticks]}, window p99 ms {[round(t['window_p_ms'], 3) for t in ticks]}, "
              f"breaches {soak['slo_breaches_total']}")
        _obs_exports(torch, card, record)
    finally:
        observability.set_health_policy("off")
        observability.set_profiling(0)
        observability.EVENTS.set_capacity(capacity)
    record["phase_s"] = time.perf_counter() - start
    print(f"[observability] phase 3n took {record['phase_s']:.1f} s on {card}")
    return record


def observability_phase_main(record_path: str = "") -> int:
    """Run :func:`observability_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(observability_phase, record_path)


# --------------------------------------------------------------------------
# phase 3o: durability, resilience and transport
# --------------------------------------------------------------------------

#: 3o-a: the JAX package's checkpoint capture (scripts/bench_suite.py:2059-2065)
CKPT_TENANTS, CKPT_CLASSES, CKPT_TOUCH, CKPT_ROUNDS, CKPT_FLIGHT_ROWS = 4096, 16, 64, 5, 256
#: 3o-c: the spill capture (scripts/bench_suite.py:2066-2067,2166-2240)
SPILL_TENANTS, SPILL_COHORT, SPILL_ROUNDS = 2048, 64, 7
SPILL_AUTO_ROWS, SPILL_AUTO_UPDATES = 512, 20
#: 3o-d: the chaos capture (scripts/bench_suite.py:2243-2250, scripts/soak.py:52-66)
CHAOS_TENANTS, CHAOS_QPS, CHAOS_MAX_BATCH, CHAOS_SECONDS, CHAOS_SEED = 2048, 8000, 512, 10.0, 1234
CHAOS_PRODUCERS, CHAOS_ROWS_PER_SUBMIT, CHAOS_DELAY_MS, CHAOS_POISON_EVERY = 4, 64, 5.0, 7


def _sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _durable_states_equal(torch, label, got, want) -> None:
    """Every leaf of two keyed objects (a ``KeyedMetric`` or a
    ``MultiTenantCollection``) equal exactly, on the host."""
    def leaves(obj):
        bundles = obj._keyed if hasattr(obj, "_keyed") else {"": obj}
        return {(o, n): t for o, km in bundles.items() for n, t in km._get_states().items()}

    g, w = leaves(got), leaves(want)
    if set(g) != set(w):
        fail(f"[{label}] state leaves differ: {sorted(g)} against {sorted(w)}")
    for key in g:
        a, b = g[key], w[key]
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        if a.shape != b.shape or not torch.equal(a.cpu(), b.cpu().to(a.dtype)):
            fail(f"[{label}] state {key} differs")


def _ckpt_batch(np, rng, ids, nc):
    rows = len(ids)
    logits = rng.rand(rows, nc).astype(np.float32)
    return np.asarray(ids, np.int32), logits / logits.sum(-1, keepdims=True), rng.randint(0, nc, rows)


def _durability_checkpoint(torch, np, M, dev, card, record) -> None:
    """Phase 3o-a: full and delta saves, an async save under updates, the
    restores, a CPU-written snapshot, the seven crash points; the keyed rows'
    counts go through B2's batched form (one launch an update), held against
    its plain version at the path's shapes and a bootstrap's."""
    import tempfile

    from metrics_tpu_torch.durability import CheckpointCrash, CheckpointManager, inject_crash, restore_checkpoint
    from metrics_tpu_torch.durability import save_checkpoint
    from metrics_tpu_torch.durability.checkpoint import CRASH_POINTS, resolve_chain
    from metrics_tpu_torch.kernels import _common

    n, nc, k = CKPT_TENANTS, CKPT_CLASSES, CKPT_TOUCH
    rng = np.random.RandomState(0)

    def build(device):
        return M.KeyedMetric(M.ConfusionMatrix(num_classes=nc, device=device), num_tenants=n, validate_ids=False,
                             device=device)

    def on(device, batch):
        return tuple(torch.as_tensor(a, device=device) for a in batch)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "trail")
        m = build(dev)
        first = _ckpt_batch(np, rng, rng.randint(0, n, 2 * n), nc)
        _common.reset_dispatch_counters()
        updates = 1
        m.update(*on(dev, first))
        first_state = m.confmat.clone()
        mgr = CheckpointManager(d, m)
        mgr.save()
        full_ms, delta_ms, stamped = [], [], 0
        full = delta = None
        for _ in range(CKPT_ROUNDS):
            _sync(torch, dev)
            t0 = time.perf_counter()
            full = mgr.save(delta=False)
            full_ms.append((time.perf_counter() - t0) * 1e3)
            touched = rng.choice(n, k, replace=False)
            m.update(*on(dev, _ckpt_batch(np, rng, touched, nc)))
            updates += 1
            _sync(torch, dev)
            t0 = time.perf_counter()
            delta = mgr.save()
            delta_ms.append((time.perf_counter() - t0) * 1e3)
            if delta["kind"] != "delta" or sorted(delta["tenants"]) != sorted(int(t) for t in touched):
                fail(f"[checkpoint] a delta save stamped {delta['kind']} {len(delta['tenants'] or [])} tenants,"
                     f" expected the {k} touched")
            stamped += len(delta["tenants"])
        confmat_bytes = n * nc * nc * 4
        if [r["dtype"] for r in full["layout"]] != ["int32", "int64"] or full["payload_bytes"] != confmat_bytes + n * 8:
            fail(f"[checkpoint] the full payload holds {full['payload_bytes']} bytes, layout {full['layout']}")
        delta_limit = full["payload_bytes"] * k / n + 256
        if delta["payload_bytes"] > delta_limit:
            fail(f"[checkpoint] the delta payload {delta['payload_bytes']} exceeds {delta_limit}")
        # the synchronizing calls of 20 updates with no save in flight
        pool = [on(dev, _ckpt_batch(np, rng, rng.randint(0, n, CKPT_FLIGHT_ROWS), nc)) for _ in range(32)]
        _sync(torch, dev)
        base_syncs = sync_calls(torch, lambda: [m.update(*b) for b in pool[:20]])
        updates += 20
        # the async save, with updates landing while it flies
        saved = m.confmat.clone()  # the cut's state: no update comes between
        flight = {}

        def fly():
            future = mgr.save_async()
            busy, steps, t0 = 0.0, 0, time.perf_counter()
            while not future.done():
                u0 = time.perf_counter()
                m.update(*pool[steps % len(pool)])
                busy += time.perf_counter() - u0
                steps += 1
            flight["manifest"] = future.result(timeout=60)
            flight["wall_s"] = time.perf_counter() - t0
            flight["busy_s"], flight["steps"] = busy, steps

        _sync(torch, dev)
        syncs = sync_calls(torch, fly)
        updates += flight["steps"]
        save_syncs = [s for s in syncs if "durability" in s]
        update_syncs = [s for s in syncs if "durability" not in s]
        per_update = len(base_syncs) / 20
        if len(update_syncs) != per_update * flight["steps"]:
            fail(f"[checkpoint] {flight['steps']} updates during the async save made {len(update_syncs)} "
                 f"synchronizing calls, {per_update} each without one: {update_syncs[:6]}")
        launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
        if launches["segment_merge"] != updates or launches["confmat_counts"] != updates or any(
                v for op, v in launches.items() if op not in ("segment_merge", "confmat_counts")):
            fail(f"[checkpoint] launches {launches} over {updates} keyed updates (B2's batched form and the merge "
                 "one each)")
        b2_batched = _b2_batched(torch, dev, [(2 * n, 1, nc), (CKPT_FLIGHT_ROWS, 1, nc),
                                              (BOOTSTRAPS, BATCH, NUM_CLASSES)])
        # restores: a fresh card metric, a CPU metric, a card metric grown to 2n
        restored = {}
        for name, target in (("card", build(dev)), ("cpu", build("cpu")), ("grown", build(dev))):
            if name == "grown":
                target.grow(2 * n)
            _sync(torch, dev)
            t0 = time.perf_counter()
            mgr.restore(target)
            _sync(torch, dev)
            restored[name] = (time.perf_counter() - t0) * 1e3
            got = target.confmat
            if not torch.equal(got[:n].cpu(), saved.cpu()) or (name == "grown" and (
                    got.shape[0] != 2 * n or bool(got[n:].any()))):
                fail(f"[checkpoint] the {name} restore differs from the saved state")
        # a snapshot written by a CPU run of the port restores onto the card
        cpu_src = build("cpu")
        cpu_src.update(*on("cpu", first))
        save_checkpoint(os.path.join(tmp, "cpu"), cpu_src)
        from_cpu = restore_checkpoint(os.path.join(tmp, "cpu"), build(dev))
        if not torch.equal(from_cpu.confmat.cpu(), cpu_src.confmat) or not torch.equal(from_cpu.confmat, first_state):
            fail("[checkpoint] the CPU-written snapshot restores differently onto the card")
        # every crash point: the torn ones leave the previous snapshot, the
        # ones after the rename the new one, complete
        crashes = {}
        last_complete = saved
        for point in CRASH_POINTS:
            m.update(*pool[len(crashes)])
            before = m.confmat.clone()
            try:
                with inject_crash(point):
                    mgr.save()
                fail(f"[checkpoint] the save armed at {point} did not crash")
            except CheckpointCrash:
                pass
            chain = resolve_chain(d)
            fresh = mgr.restore(build(dev))
            complete = point in ("after_rename", "before_latest")
            want = before if complete else last_complete
            if not torch.equal(fresh.confmat, want):
                fail(f"[checkpoint] after a crash at {point} the restore is not the last complete snapshot")
            last_complete = want
            crashes[point] = {"restored": "new" if complete else "previous", "chain": len(chain)}
        out.update({
            "full_payload_bytes": full["payload_bytes"], "confmat_bytes": confmat_bytes, "ledger_bytes": n * 8,
            "delta_payload_bytes": delta["payload_bytes"], "delta_limit": delta_limit, "tenants_stamped": stamped,
            "full_save_ms": statistics.median(full_ms), "delta_save_ms": statistics.median(delta_ms),
            "full_save_ms_all": full_ms, "delta_save_ms_all": delta_ms,
            "async": {"kind": flight["manifest"]["kind"], "wall_ms": flight["wall_s"] * 1e3,
                      "updates_in_flight": flight["steps"], "overlap": min(1.0, flight["busy_s"] / flight["wall_s"]),
                      "update_syncs": len(update_syncs), "update_syncs_without_save": per_update * flight["steps"],
                      "save_syncs": save_syncs},
            "restore_ms": restored, "launches": launches, "keyed_updates": updates, "crashes": crashes,
            "b2_batched": b2_batched,
        })
    print(f"[checkpoint] KeyedMetric(ConfusionMatrix({nc})) over {n} tenants on {card}: full save "
          f"{out['full_payload_bytes']} bytes (confmat {confmat_bytes} + ledger {n * 8}) median "
          f"{out['full_save_ms']:.3f} ms, delta of {k} tenants {out['delta_payload_bytes']} bytes (limit "
          f"{delta_limit:.0f}) median {out['delta_save_ms']:.3f} ms, {stamped} tenants stamped in {CKPT_ROUNDS} deltas; "
          f"async {out['async']['kind']} save {out['async']['wall_ms']:.3f} ms with {flight['steps']} updates landing "
          f"(overlap {out['async']['overlap']:.3f}; their synchronizing calls {len(update_syncs)}, as many as without a "
          f"save; the save's own {len(save_syncs)}); restores ms {({k_: round(v, 3) for k_, v in restored.items()})} "
          f"== the cut exactly (card, CPU, grown to {2 * n}), the CPU-written snapshot == on the card; crash points "
          f"{ {p: c['restored'] for p, c in crashes.items()} }; launches {launches}")
    for b in b2_batched:
        dev_ms = {k: "none" if b[k] is None else f"{b[k]:.5f}"
                  for k in ("device_ms", "plain_device_ms", "library_device_ms")}
        print(f"[checkpoint] B2 batched {b['shape']}: {b['ms']:.4f} ms, device {dev_ms['device_ms']} (plain "
              f"{b['plain_ms']:.4f} ms, device {dev_ms['plain_device_ms']}; bincount {b['library_ms']:.4f} ms, device "
              f"{dev_ms['library_device_ms']}; bound {b['bound_ms']:.4f} ms, {b['bound_by']}), {b['launches']} "
              f"launch, == plain")
    record["checkpoint"] = out


def _b2_batched(torch, dev, shapes) -> list:
    """B2's batched form held against its plain version at ``(B, N, C)``
    stacks: the keyed rows' (length-1 rows of a keyed ``ConfusionMatrix``'s
    update) and a bootstrap's children; labels in [-1, C] so that dropped
    pairs are held too, and timed. These launches are not counted."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_batched_cuda, confmat_counts_batched_torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    out = []
    for b, n, c in shapes:
        preds, target = (torch.randint(-1, c + 1, (b, n), generator=gen, device=dev) for _ in range(2))
        before = _common.launch_count("confmat_counts")
        got = confmat_counts_batched_cuda(preds, target, c, device=dev)
        launched = _common.launch_count("confmat_counts") - before
        err = int((got - confmat_counts_batched_torch(preds, target, c)).abs().max())
        if err or got.shape != (b, c, c):
            fail(f"[checkpoint] B2's batched form differs from its plain version by {err} at ({b}, {n}), C={c}")
        entry = {"shape": [b, n, c], "launches": launched, "max_abs_err": err,
                 "ms": cuda_ms(lambda: confmat_counts_batched_cuda(preds, target, c, device=dev)),
                 "plain_ms": cuda_ms(lambda: confmat_counts_batched_torch(preds, target, c)),
                 "device_ms": device_ms(lambda: confmat_counts_batched_cuda(preds, target, c, device=dev)),
                 "plain_device_ms": device_ms(lambda: confmat_counts_batched_torch(preds, target, c))}
        # the library call: one bincount of the kept pairs' flat cells, made
        # outside the timed region
        keep = (preds >= 0) & (preds < c) & (target >= 0) & (target < c)
        flat = (torch.arange(b, device=dev).unsqueeze(1) * (c * c) + target * c + preds)[keep]
        entry["library_ms"] = cuda_ms(lambda: torch.bincount(flat, minlength=b * c * c))
        entry["library_device_ms"] = device_ms(lambda: torch.bincount(flat, minlength=b * c * c))
        entry["bound_ms"], entry["bound_by"] = bound(2 * b * n * 8 + b * c * c * 4, 6 * b * n)
        out.append(entry)
        del got
    return out


def _durability_collection(torch, np, M, dev, card, record) -> tuple:
    """Phase 3o-b: phase 3b's collection saved after 25 cohorts, its owner
    dropped, restored into a new owner (eager, and compiled after its
    capture), the last 25 cohorts run; == the uninterrupted run; then
    ``grow``/``compact`` under the compiled update. Returns the compiled
    owner and its eager twin (3o-c spills it)."""
    import gc
    import tempfile

    from metrics_tpu_torch.durability import CheckpointManager
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.observability.memory import LEDGER

    batches = make_keyed_batches(torch, dev)
    half = KEYED_UPDATES // 2
    ref = build_keyed(M, dev)
    for batch in batches:
        ref.update(*batch)
    out = {}
    owner = None
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("eager", "compiled"):
            d = os.path.join(tmp, mode)
            first = build_keyed(M, dev)
            first.build()
            if mode == "compiled":
                first.warmup(*batches[0])
            _sync(torch, dev)
            _common.reset_dispatch_counters()
            for batch in batches[:half]:
                first.update(*batch)
            launches = {op: _common.launch_count(op) for op in ("segment_merge", "segment_scatter_add",
                                                               "segment_scatter_max")}
            manifest = CheckpointManager(d, first).save()
            del first
            gc.collect()
            second = build_keyed(M, dev)
            second.build()
            if mode == "compiled":
                second.warmup(*batches[0])  # the restore then takes the graph's copy-in path
            _sync(torch, dev)
            t0 = time.perf_counter()
            CheckpointManager(d, second).restore()
            _sync(torch, dev)
            restore_ms = (time.perf_counter() - t0) * 1e3
            _common.reset_dispatch_counters()
            for batch in batches[half:]:
                second.update(*batch)
            for op in launches:
                launches[op] += _common.launch_count(op)
            if launches != {"segment_merge": KEYED_UPDATES, "segment_scatter_add": 0, "segment_scatter_max": 0}:
                fail(f"[restart {mode}] launches {launches} over the 50 cohorts, phase 3b's are 50 merges")
            _durable_states_equal(torch, f"restart {mode}", second, ref)
            out[mode] = {"launches": launches, "payload_bytes": manifest["payload_bytes"], "restore_ms": restore_ms}
            owner = second
        # grow and compact under the compiled update, against an eager twin
        LEDGER.track(owner)
        shifted = (torch.where(batches[0][0] >= 0, batches[0][0] + KEYED_TENANTS, batches[0][0]),) + batches[0][1:]
        steps = []
        for obj in (owner, ref):
            steps.append(obj.grow(2 * KEYED_TENANTS))
            obj.update(*shifted)
            steps.append(obj.compact(KEYED_TENANTS))
            obj.update(*batches[1])
        _durable_states_equal(torch, "grow/compact", owner, ref)
        fn = owner.__dict__.get("_keyed_update_fn")
        captures = fn._cache_size() if fn is not None else 0
        capacities = {KEYED_TENANTS, steps[0], steps[1]}
        expected = [1 << (2 * KEYED_TENANTS - 1).bit_length(), 1 << (KEYED_TENANTS - 1).bit_length()]
        if steps[:2] != expected or captures != len(capacities):
            fail(f"[grow/compact] capacities {steps[:2]}, {captures} captures for capacities {sorted(capacities)}")
        nbytes = sum(t.numel() * t.element_size() for km in owner._keyed.values() for t in km._get_states().values())
        ledger = LEDGER.owner_bytes(owner)
        if ledger != nbytes:
            fail(f"[grow/compact] the memory ledger reads {ledger} bytes, the states hold {nbytes}")
        out["elastic"] = {"capacities": steps[:2], "captures": captures, "ledger_bytes": ledger, "nbytes": nbytes,
                          "capture_bound": int(np.log2(2 * KEYED_TENANTS)) + 1}
    print(f"[restart] phase 3b's collection over {KEYED_TENANTS} tenants saved after {half} cohorts, restored into "
          f"a new owner, {KEYED_UPDATES - half} more: == the uninterrupted run exactly, eager (launches "
          f"{out['eager']['launches']}, restore {out['eager']['restore_ms']:.3f} ms) and compiled (launches "
          f"{out['compiled']['launches']}, restore {out['compiled']['restore_ms']:.3f} ms); grow({2 * KEYED_TENANTS}) "
          f"-> capacity {steps[0]}, compact({KEYED_TENANTS}) -> {steps[1]}: == eager, {captures} captures for "
          f"{len(capacities)} capacities; ledger {ledger} bytes == the states' nbytes, on {card}")
    record["collection"] = out
    return owner, ref


def _durability_spill(torch, np, M, dev, card, record, owner, twin) -> None:
    """Phase 3o-c: the spill capture, then the same spiller on the
    10,000-tenant collection (the compiled owner of 3o-b) at n/8."""
    from metrics_tpu_torch.durability import TenantSpiller
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.observability.memory import LEDGER

    n, cohort = SPILL_TENANTS, SPILL_COHORT
    rows = 4 * n
    metrics = []
    for _ in range(2):
        rng = np.random.RandomState(0)
        m = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=n, validate_ids=False, device=dev)
        m.update(torch.as_tensor(rng.randint(0, n, rows), device=dev),
                 torch.as_tensor(rng.rand(rows).astype(np.float32), device=dev),
                 torch.as_tensor(rng.randint(0, 2, rows), device=dev))
        metrics.append(m)
    m, control = metrics
    sp = TenantSpiller(m, resident_cap=n // 8, auto=False)
    _sync(torch, dev)
    t0 = time.perf_counter()
    evicted = sp.maybe_evict()
    first_ms = (time.perf_counter() - t0) * 1e3
    occ = sp.report()
    row_bytes = sum(t[:1].numel() * t.element_size() for t in m._get_states().values())
    if not (occ["conservation_ok"] and occ["resident_under_cap"]) or occ["spilled_bytes"] != occ["spilled"] * row_bytes:
        fail(f"[spill] after the first pass: {occ}")
    if LEDGER.report()["owners"][m.telemetry_key]["spilled_bytes"] != occ["spilled_bytes"]:
        fail(f"[spill] the memory ledger's spilled bytes differ from the spilled rows' {occ['spilled_bytes']}")
    pick = np.random.RandomState(7)
    evict_us, back_us, evict_syncs, back_syncs = [], [], [], []
    for _ in range(SPILL_ROUNDS):
        ids = pick.choice(sorted(sp._spilled), cohort, replace=False)
        for what, times, syncs in (("fault_back", back_us, back_syncs), ("evict", evict_us, evict_syncs)):
            _sync(torch, dev)
            t0 = time.perf_counter()
            syncs.append(len(sync_calls(torch, lambda: getattr(sp, what)(ids))))
            times.append((time.perf_counter() - t0) * 1e6 / cohort)
    occ = sp.report()
    got, want = m.compute(), control.compute()
    same = torch.equal(got.isnan(), want.isnan()) and torch.equal(got[~want.isnan()], want[~want.isnan()])
    if not same or not occ["conservation_ok"]:
        fail(f"[spill] the fault-back read differs from the never-evicted control, or conservation broke: {occ}")
    if sp.report()["spilled"] != 0 or LEDGER.report()["owners"][m.telemetry_key]["spilled_bytes"] != 0:
        fail("[spill] a read left tenants spilled")
    out = {"tenants": n, "resident_cap": n // 8, "first_pass": {"evicted": evicted, "ms": first_ms},
           "evict_us_per_tenant": statistics.median(evict_us), "fault_back_us_per_tenant": statistics.median(back_us),
           "evict_syncs": evict_syncs, "fault_back_syncs": back_syncs, "row_bytes": row_bytes}
    sp.detach()
    # the 10,000-tenant collection, compiled, at n/8
    big = TenantSpiller(owner, resident_cap=KEYED_TENANTS // 8, auto=False)
    _sync(torch, dev)
    t0 = time.perf_counter()
    big_evicted = big.maybe_evict()
    _sync(torch, dev)
    big_evict_ms = (time.perf_counter() - t0) * 1e3
    big_occ = big.report()
    if not (big_occ["conservation_ok"] and big_occ["resident_under_cap"]):
        fail(f"[spill] the collection's pass: {big_occ}")
    batches = make_keyed_batches(torch, dev)
    _common.reset_dispatch_counters()
    for obj in (owner, twin):  # a compiled update whose tenants fault back first, under the held graph
        obj.update(*batches[2])
    launches = {op: _common.launch_count(op) for op in ("segment_merge", "segment_scatter_add", "segment_scatter_max")}
    _sync(torch, dev)
    t0 = time.perf_counter()
    got = owner.compute()  # faults back every spilled tenant
    _sync(torch, dev)
    read_ms = (time.perf_counter() - t0) * 1e3
    want = twin.compute()
    for name in want:
        g, w = got[name].cpu(), want[name].cpu()
        if not (torch.equal(g.isnan(), w.isnan()) and torch.equal(g[~w.isnan()], w[~w.isnan()])):
            fail(f"[spill] the collection's {name} after the spill differs from its never-evicted twin")
    _durable_states_equal(torch, "spill collection", owner, twin)
    big.detach()
    out["collection"] = {"tenants": KEYED_TENANTS, "resident_cap": KEYED_TENANTS // 8, "evicted": big_evicted,
                         "spilled_bytes": big_occ["spilled_bytes"], "evict_ms": big_evict_ms,
                         "read_with_fault_back_ms": read_ms, "launches": launches}
    out["auto"] = _spill_auto_cost(torch, np, M, dev)
    print(f"[spill] KeyedMetric(Accuracy()) over {n} tenants at resident_cap {n // 8} on {card}: first pass evicted "
          f"{evicted} ({first_ms:.3f} ms), {SPILL_ROUNDS} rounds of {cohort}: evict {out['evict_us_per_tenant']:.3f} "
          f"us/tenant ({evict_syncs} synchronizing calls), fault-back {out['fault_back_us_per_tenant']:.3f} us/tenant "
          f"({back_syncs}); read == the never-evicted control bit for bit, conservation exact, ledger's spilled bytes "
          f"== the rows'; the {KEYED_TENANTS}-tenant compiled collection at {KEYED_TENANTS // 8}: {big_evicted} "
          f"evicted, {big_occ['spilled_bytes']} bytes, {big_evict_ms:.3f} ms, a compiled update through the held "
          f"graph (launches {launches}) and a read with fault-back {read_ms:.3f} ms == its twin")
    for kind, a in out["auto"].items():
        print(f"[spill] a keyed update of {SPILL_AUTO_ROWS} rows over {n} tenants, {kind} (auto spiller at "
              f"resident_cap {a['resident_cap']}): median {a['ms']:.3f} ms, {a['syncs_per_update']} synchronizing "
              f"calls an update at {a['sync_sites']}, {a.get('spilled_at_end', 0)} spilled at the end; read == the "
              f"bare metric's")
    record["spill"] = out


def _spill_auto_cost(torch, np, M, dev) -> dict:
    """What an ``auto=True`` spiller adds to a keyed update on the card: the
    same updates timed (synchronized after each) and their synchronizing
    calls counted without a spiller, with one whose ``resident_cap`` holds
    every tenant (the hooks alone), and with one at n/8 and ``min_idle_s`` 0
    (an eviction pass after every update, which the uniform traffic makes
    fault back and evict hundreds of tenants an update), then without one
    again (the spread of the host's time); the metrics' reads must then
    agree bit for bit."""
    from metrics_tpu_torch.durability import TenantSpiller

    n = SPILL_TENANTS
    rng = np.random.RandomState(5)
    pool = [tuple(torch.as_tensor(a, device=dev) for a in (rng.randint(0, n, SPILL_AUTO_ROWS),
                                                             rng.rand(SPILL_AUTO_ROWS).astype(np.float32),
                                                             rng.randint(0, 2, SPILL_AUTO_ROWS)))
            for _ in range(SPILL_AUTO_UPDATES)]
    out, reads = {}, {}
    for kind, cap in (("bare", None), ("hooks", n), ("evicting", n // 8), ("bare_again", None)):
        m = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=n, validate_ids=False, device=dev)
        m.update(*pool[0])  # first call's warm-up, not counted
        sp = None if cap is None else TenantSpiller(m, resident_cap=cap, min_idle_s=0.0, auto=True)
        ms = []
        for batch in pool:
            _sync(torch, dev)
            t0 = time.perf_counter()
            m.update(*batch)
            _sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        sites = sync_calls(torch, lambda: [m.update(*b) for b in pool])
        out[kind] = {"resident_cap": cap, "ms": statistics.median(ms), "ms_all": ms,
                     "syncs_per_update": len(sites) / len(pool), "sync_sites": sorted(set(sites))}
        if sp is not None:
            occ = sp.report()
            if not occ["conservation_ok"]:
                fail(f"[spill] the auto spiller at {cap} broke conservation: {occ}")
            out[kind]["spilled_at_end"] = int(occ["spilled"])
        reads[kind] = m.compute()
        if sp is not None:
            sp.detach()
    want = reads["bare"]
    for kind in ("hooks", "evicting", "bare_again"):
        got = reads[kind]
        if not (torch.equal(got.isnan(), want.isnan()) and torch.equal(got[~want.isnan()], want[~want.isnan()])):
            fail(f"[spill] the metric under the {kind} auto spiller reads differently from the bare one")
    return out


class _RankChannels:
    """The thread-simulated fleet's subgroup channel: each rank (a thread)
    exchanges through its own ``StoreSubgroupChannel`` and store client."""

    def __init__(self, channels, rank_of) -> None:
        self.channels, self.rank_of = channels, rank_of

    def _mine(self):
        import threading

        return self.channels[self.rank_of[threading.get_ident()]]

    def __call__(self, buf, participants):
        return self._mine()(buf, participants)

    def consume_round(self, participants) -> None:
        self._mine().consume_round(participants)


def chaos_fleet(torch, dev, seed: int = CHAOS_SEED, channel_timeout_s: float = 0.5) -> dict:
    """Phase 3o-d's fleet: a 3-rank world of threads (rank 2 dead from the
    start, so every round is a subgroup round over [0, 1] through
    ``StoreSubgroupChannel``s over one ``TCPStore``), rank 1's first payload
    round dropped, a 0.2 s hung channel get on rank 0, then rank 1's death:
    the detector's strikes promote it out of the membership epoch and the
    first round over [0] closes the failover time (``scripts/soak.py:184``)."""
    import socket
    import threading
    from datetime import timedelta

    import metrics_tpu_torch.resilience as res
    from metrics_tpu_torch.observability import tracing as ttracing
    from metrics_tpu_torch.transport.gather import GatherTransport, StoreSubgroupChannel, set_subgroup_allgather
    from metrics_tpu_torch.utilities import distributed as tdist

    res.MEMBERSHIP.reset(world=3)
    detector = res.FailureDetector(membership=res.MEMBERSHIP, fail_after=2, phi_threshold=8.0)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    master = torch.distributed.TCPStore("localhost", port, is_master=True, wait_for_workers=False,
                                        timeout=timedelta(seconds=30))
    clients = [torch.distributed.TCPStore("localhost", port, is_master=False, timeout=timedelta(seconds=30))
               for _ in range(2)]
    rank_of = {}
    channel = _RankChannels({r: StoreSubgroupChannel(clients[r], timeout_s=channel_timeout_s, rank_fn=lambda r=r: r)
                             for r in range(2)}, rank_of)
    plan = res.FaultPlan(seed, [
        res.FaultSpec("transport.payload", "drop", at=[0], process=1),
        res.FaultSpec("subgroup.exchange", "delay", at=[4], process=0, delay_s=0.2),
    ])
    out = {"payload_drop_recovered": False, "round_counter_consistent": False, "hung_get_absorbed": False,
           "failover_mttr_ms": None}
    errors = {}
    barrier = threading.Barrier(2, timeout=30.0)

    def tree(rank, k):
        return {"v": torch.tensor([rank, k], dtype=torch.int32, device=dev)}

    def rank1():
        transport = GatherTransport(participants=[0, 1])
        try:
            transport.gather_pytrees([tree(1, 0)])
            errors["rank1_drop"] = "the payload drop did not fire"
        except res.DroppedFault:
            pass
        barrier.wait()
        transport.gather_pytrees([tree(1, 1)])
        barrier.wait()
        for k in range(3):
            transport.gather_pytrees([tree(1, 2 + k)])

    def rank0():
        transport = GatherTransport(participants=[0, 1])
        try:
            transport.gather_pytrees([tree(0, 0)])
            errors["rank0_drop"] = "expected a timed-out round"
        except Exception:  # noqa: BLE001 - rank 1 dropped its payload
            pass
        barrier.wait()
        got = transport.gather_pytrees([tree(0, 1)])[0]["v"]
        out["round_counter_consistent"] = bool(
            len(got) == 2 and got[0].tolist() == [0, 1] and got[1].tolist() == [1, 1])
        out["payload_drop_recovered"] = out["round_counter_consistent"]
        barrier.wait()
        t0 = time.monotonic()
        transport.gather_pytrees([tree(0, 2)])
        out["hung_get_absorbed"] = (time.monotonic() - t0) >= 0.18
        detector.observe_round([1], ok=True)
        for k in range(2):
            transport.gather_pytrees([tree(0, 3 + k)])
            detector.observe_round([1], ok=True)
        t_death = time.monotonic()
        for _ in range(detector.fail_after + 2):
            if 1 in res.MEMBERSHIP.dead():
                break
            try:
                transport.gather_pytrees([tree(0, 9)])
                detector.observe_round([0, 1], ok=True)
            except Exception:  # noqa: BLE001 - rank 1 is dead
                detector.observe_round([1], ok=False)
                detector.promote()
        if 1 not in res.MEMBERSHIP.dead():
            errors["rank0_detector"] = "the detector never promoted the dead peer"
            return
        got = transport.subgroup([0]).gather_pytrees([tree(0, 10)])[0]["v"]
        out["failover_mttr_ms"] = (time.monotonic() - t_death) * 1e3
        out["degraded_round"] = [t.tolist() for t in got]

    def named(rank, fn):
        def run():
            rank_of[threading.get_ident()] = rank
            try:
                fn()
            except Exception as err:  # noqa: BLE001 - in the record
                errors[f"rank{rank}"] = f"{type(err).__name__}: {err}"
        return run

    def no_global_round(buf, group):
        raise AssertionError("a global round in the subgroup-only fleet")

    saved = (tdist._all_gather, tdist.distributed_available, tdist.world_size, ttracing._process_index)
    tdist._all_gather, tdist.distributed_available, tdist.world_size = no_global_round, lambda: True, lambda: 3
    ttracing._process_index = lambda: rank_of.get(threading.get_ident(), 0)
    previous = set_subgroup_allgather(channel)
    try:
        with res.fault_plan(plan):
            threads = [threading.Thread(target=named(r, fn)) for r, fn in ((0, rank0), (1, rank1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            if any(t.is_alive() for t in threads):
                errors["deadlock"] = "a fleet rank did not finish"
    finally:
        set_subgroup_allgather(previous)
        tdist._all_gather, tdist.distributed_available, tdist.world_size, ttracing._process_index = saved
        del clients, master
    res.MEMBERSHIP.mark_recovered(1, reason="chaos-rejoin")
    out["epoch_final"] = res.MEMBERSHIP.current().epoch
    out["epoch_transitions"] = len(res.MEMBERSHIP.transitions())
    out["faults"] = plan.report()
    out["errors"] = errors
    out["ok"] = bool(not errors and out["payload_drop_recovered"] and out["round_counter_consistent"]
                     and out["hung_get_absorbed"] and out["failover_mttr_ms"] is not None
                     and out["epoch_transitions"] >= 2)
    return out


def chaos_window(torch, M, dev, *, seconds: float = CHAOS_SECONDS, qps: int = CHAOS_QPS,
                 tenants: int = CHAOS_TENANTS, max_batch: int = CHAOS_MAX_BATCH, seed: int = CHAOS_SEED) -> dict:
    """Phase 3o-d's serving window (``scripts/soak.py:417-975``, chaos):
    producers into an ``SLOScheduler(KeyedMetric(Accuracy()))`` with the
    quarantine on, interval auto-saves on the durability lane, and a seeded
    plan: ``serving.dispatch`` errors at hits 3 and 9, the auto-save crashed
    at ``checkpoint.before_manifest`` (hit 1), a NaN row every 7th cohort.
    Returns the record with its invariants (``ok``)."""
    import tempfile
    import threading

    import numpy as np

    import metrics_tpu_torch.resilience as res
    from metrics_tpu_torch import observability
    from metrics_tpu_torch.durability import CheckpointManager
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.observability.histogram import HISTOGRAMS
    from metrics_tpu_torch.serving import SERVING_STATS, SLOScheduler
    from metrics_tpu_torch.utilities.async_sync import get_engine

    observability.reset()
    metric = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=tenants, validate_ids=False, device=dev)
    calls = [0]
    real_update = metric.update

    def counted_update(ids, *cols):
        real_update(ids, *cols)
        calls[0] += 1

    metric.update = counted_update
    svc = SLOScheduler(metric, max_staleness_s=1.0, max_batch=max_batch, max_delay_ms=CHAOS_DELAY_MS,
                       policy="shed_oldest", pad_to_bucket=True, quarantine="on")
    rng = np.random.RandomState(seed)
    b = 1
    while b <= max_batch:  # one cohort of every power-of-two bucket before the window
        preds = rng.rand(b).astype(np.float32)
        svc.submit_many(rng.randint(0, tenants, b), preds, (preds > 0.5).astype(np.int32))
        svc.queue.flush()
        b *= 2
    svc.read(max_staleness_s=0.0)
    HISTOGRAMS.reset()
    _sync(torch, dev)
    _common.reset_dispatch_counters()
    calls[0] = 0
    out = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, svc)
        mgr.save(delta=False)
        plan = res.FaultPlan(seed + 1, [res.FaultSpec("serving.dispatch", "error", at=[3, 9]),
                                        res.FaultSpec("checkpoint.before_manifest", "error", at=[1])])
        res.install_fault_plan(plan)
        mgr.enable_auto_save(interval_s=min(0.8, max(0.2, seconds / 5.0)), tick_s=0.05)
        stop = threading.Event()
        counters = {"submitted": 0, "poisoned": 0, "reads": 0, "read_errors": 0}
        lock = threading.Lock()
        rate = qps / CHAOS_PRODUCERS
        errors = []

        def producer(k):
            prng = np.random.RandomState(seed + 1 + k)
            interval = CHAOS_ROWS_PER_SUBMIT / rate
            next_at = time.perf_counter()
            cohort = 0
            try:
                while not stop.is_set():
                    ids = prng.randint(0, tenants, CHAOS_ROWS_PER_SUBMIT)
                    preds = prng.rand(CHAOS_ROWS_PER_SUBMIT).astype(np.float32)
                    target = (prng.rand(CHAOS_ROWS_PER_SUBMIT) < preds).astype(np.int32)
                    cohort += 1
                    poisoned = cohort % CHAOS_POISON_EVERY == 0
                    if poisoned:
                        preds[int(prng.randint(CHAOS_ROWS_PER_SUBMIT))] = np.nan
                    svc.submit_many(ids, preds, target)
                    with lock:
                        counters["submitted"] += CHAOS_ROWS_PER_SUBMIT
                        counters["poisoned"] += int(poisoned)
                    next_at += interval
                    delay = next_at - time.perf_counter()
                    if delay > 0:
                        stop.wait(delay)
                    elif delay < -1.0:
                        next_at = time.perf_counter()
            except Exception as err:  # noqa: BLE001 - in the record
                errors.append(f"{type(err).__name__}: {err}")

        def reader():
            rrng = np.random.RandomState(10_007)
            while not stop.is_set():
                try:
                    svc.read(rrng.randint(0, tenants, 16), max_staleness_s=1.0)
                    counters["reads"] += 1
                except Exception:  # noqa: BLE001 - counted
                    counters["read_errors"] += 1
                stop.wait(1.0)

        threads = [threading.Thread(target=producer, args=(k,)) for k in range(CHAOS_PRODUCERS)]
        threads.append(threading.Thread(target=reader))
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(seconds)
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        joined = not any(t.is_alive() for t in threads)
        drained = svc.drain(timeout=60.0)
        get_engine().drain(timeout=30.0)
        elapsed = time.perf_counter() - t0
        auto = mgr.auto_save_report()
        mgr.disable_auto_save()
        lane_drained = get_engine("durability").drain(timeout=30.0)
        res.install_fault_plan(None)
        stats = svc.queue.stats()
        routed = metric.tenant_report()["rows_routed"]
        zero_lost = stats["submitted"] - stats["shed"] == stats["dispatched"] == routed and stats["resident"] == 0
        serving = SERVING_STATS.summary()
        telemetry_ok = (serving["shed_rows"] == stats["shed"] and serving["dispatched_rows"] == stats["dispatched"]
                        and serving["shed_by_reason"] == {r: v for r, v in stats["shed_by_reason"].items() if v})
        fired = [(seam, mode) for seam, mode, _ in plan.fired()]
        schedule_ok = (fired.count(("serving.dispatch", "error")) == 2
                       and fired.count(("checkpoint.before_manifest", "error")) == 1)
        shed = stats["shed_by_reason"]
        quarantined = int(shed.get("poisoned", 0))
        quarantine_ok = (quarantined == counters["poisoned"] if not shed.get("shed_oldest")
                         else 1 <= quarantined <= counters["poisoned"])
        values = metric.compute()
        rows = metric._traffic.arrays()[0]
        touched = torch.as_tensor(rows > 0, device=values.device)
        none_leaked = bool(torch.isfinite(values[touched]).all())
        durability = observability.snapshot()["durability"]
        final = mgr.save(delta=False)
        fresh = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=tenants, validate_ids=False, device=dev)
        CheckpointManager(ckpt_dir, fresh).restore(fresh)
        restore_ok = all(torch.equal(a, b) for a, b in zip(metric._get_states().values(),
                                                           fresh._get_states().values()))
        launches = {op: _common.launch_count(op) for op in ("segment_merge", "segment_scatter_add",
                                                           "segment_scatter_max")}
        # one merge launch a dispatch on the card (the CPU launches none)
        expected = calls[0] if torch.device(dev).type == "cuda" else 0
        launches_ok = launches == {"segment_merge": expected, "segment_scatter_add": 0, "segment_scatter_max": 0}

        def pct(name, q):
            return HISTOGRAMS.get(name, unit="s", policy="shed_oldest").percentile(q) * 1e3

        out.update({
            "seconds": elapsed, "submitted": stats["submitted"], "dispatched": stats["dispatched"],
            "rows_routed": routed, "shed_by_reason": {r: v for r, v in shed.items() if v},
            "achieved_rows_per_s": counters["submitted"] / seconds, "dispatches": calls[0], "launches": launches,
            "ingest_p50_ms": pct("serving_ingest_seconds", 50), "ingest_p99_ms": pct("serving_ingest_seconds", 99),
            "poisoned": {"injected": counters["poisoned"], "quarantined": quarantined, "none_leaked": none_leaked},
            "checkpoint": {"auto_saves": auto["auto_saves"], "save_errors": durability.get("save_errors", 0),
                           "restore_bit_identical": restore_ok, "last_snapshot": final["name"]},
            "reads": counters["reads"], "read_errors": counters["read_errors"], "errors": errors,
            "faults": plan.report(), "invariants": {
                "zero_lost_updates": bool(zero_lost), "telemetry_matches": bool(telemetry_ok),
                "schedule_fired": schedule_ok, "quarantine_exact": bool(quarantine_ok), "none_leaked": none_leaked,
                "mid_save_crash": durability.get("save_errors", 0) >= 1, "auto_saves": auto["auto_saves"] >= 2,
                "restore_bit_identical": restore_ok, "no_deadlocks": bool(joined and drained and lane_drained),
                "launches_per_dispatch": launches_ok, "dispatch_errors": shed.get("dispatch_error", 0) >= 1,
            },
        })
    svc.close(timeout=30)
    out["ok"] = bool(all(out["invariants"].values()) and not errors)
    return out


def _durability_chaos(torch, M, dev, card, record) -> None:
    """Phase 3o-d: the fleet, then the serving window."""
    fleet = chaos_fleet(torch, dev)
    if not fleet["ok"]:
        fail(f"[chaos] the fleet phase failed: {fleet}")
    window = chaos_window(torch, M, dev)
    if not window["ok"]:
        fail(f"[chaos] an invariant broke: {window['invariants']}, errors {window['errors']}")
    print(f"[chaos] fleet of 3 (rank 2 dead) on {card}: payload drop recovered, round counters consistent, hung get "
          f"absorbed, failover {fleet['failover_mttr_ms']:.1f} ms, epoch {fleet['epoch_final']} after "
          f"{fleet['epoch_transitions']} transitions; serving window {window['seconds']:.1f} s at {CHAOS_QPS} rows/s "
          f"over {CHAOS_TENANTS} tenants: {window['submitted']} submitted, {window['dispatched']} dispatched == "
          f"{window['rows_routed']} routed, shed {window['shed_by_reason']}, ingest p50 {window['ingest_p50_ms']:.3f} / "
          f"p99 {window['ingest_p99_ms']:.3f} ms, poisoned {window['poisoned']}, auto-saves "
          f"{window['checkpoint']['auto_saves']} ({window['checkpoint']['save_errors']} crashed), restore bit-identical, "
          f"launches {window['launches']} for {window['dispatches']} dispatches; invariants all held")
    record["chaos"] = {"fleet": fleet, "window": window}


def _durability_transport(torch, M, dev, card, record) -> None:
    """Phase 3o-e: ``ShardedTransport`` over a one-device mesh, a 1 x 1
    ``Hierarchy`` and ``InGraphTransport`` over an NCCL world of 1."""
    import socket
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from metrics_tpu_torch.durability import CheckpointManager
    from metrics_tpu_torch.transport import InGraphTransport, ShardedTransport, get_transport
    from metrics_tpu_torch.utilities.distributed import Hierarchy, sync_state_packed

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        m = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=SPILL_TENANTS, validate_ids=False, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 14)
        rows = 4 * SPILL_TENANTS
        m.update(torch.randint(0, SPILL_TENANTS, (rows,), generator=gen, device=dev),
                 torch.rand((rows,), generator=gen, device=dev), torch.randint(0, 2, (rows,), generator=gen, device=dev))
        state, reductions = m._get_states(), m._reductions
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shard",))
        sharded_t = ShardedTransport(mesh, "shard")
        sharded = sharded_t.shard_state(state)
        reduced = sharded_t.reduce_states(sharded, reductions)
        mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=("shard", "replica"))
        replica_t = ShardedTransport(mesh2, "shard", replica_axis="replica")
        replica = replica_t.reduce_states(replica_t.shard_state(state), reductions)
        for label, tree in (("shard_state", sharded), ("reduce_states", reduced), ("replica reduce", replica)):
            for name, value in tree.items():
                if not torch.equal(value.full_tensor(), state[name]):
                    fail(f"[transport] {label} of {name} differs from the replicated state")
        fractions = {name: sharded_t.max_shard_fraction(v) for name, v in sharded.items()}
        with tempfile.TemporaryDirectory() as tmp:
            CheckpointManager(tmp, m).save()
            target = M.KeyedMetric(M.Accuracy(device=dev), num_tenants=SPILL_TENANTS, validate_ids=False, device=dev)
            CheckpointManager(tmp, target).restore(target, transport=sharded_t)
            _durable_states_equal(torch, "place_state", target, m)
        hierarchy = Hierarchy(1)
        flat = sync_state_packed(dict(state), reductions, dist.group.WORLD)
        hier = sync_state_packed(dict(state), reductions, hierarchy)
        for name in state:
            if not (torch.equal(flat[name], state[name]) and torch.equal(hier[name], flat[name])):
                fail(f"[transport] the 1 x 1 hierarchy's {name} differs from the flat sync")
        tree = [{"state": dict(state)}]
        in_graph = InGraphTransport().gather_pytrees(tree)
        eager = get_transport().gather_pytrees(tree)
        for name in state:
            if not all(torch.equal(a, b) for a, b in zip(in_graph[0]["state"][name], eager[0]["state"][name])):
                fail(f"[transport] InGraphTransport's gather of {name} differs from the eager pair's")
    finally:
        dist.destroy_process_group()
    record["transport"] = {"leaves": len(state), "max_shard_fraction": fractions, "hierarchy": repr(hierarchy)}
    print(f"[transport] NCCL world of 1 on {card}: ShardedTransport over a 1-device mesh (Shard(0)): shard_state, "
          f"reduce_states (and across a 1-wide replica axis) and a restore through place_state == the replicated "
          f"{len(state)} leaves, max shard fraction {sorted(set(fractions.values()))}; {hierarchy} == the flat sync; "
          f"InGraphTransport == the eager pair")


def durability_phase(torch, M, dev, card) -> dict:
    """Phase 3o: durability, resilience and transport (3o-a to 3o-e of the
    module docstring)."""
    import numpy as np

    from metrics_tpu_torch import observability

    start = time.perf_counter()
    record = {}
    observability.reset()
    _durability_checkpoint(torch, np, M, dev, card, record)
    owner, twin = _durability_collection(torch, np, M, dev, card, record)
    _durability_spill(torch, np, M, dev, card, record, owner, twin)
    _durability_chaos(torch, M, dev, card, record)
    _durability_transport(torch, M, dev, card, record)
    observability.reset()
    record["phase_s"] = time.perf_counter() - start
    print(f"[durability] phase 3o took {record['phase_s']:.1f} s on {card}")
    return record


def durability_phase_main(record_path: str = "") -> int:
    """Run :func:`durability_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(durability_phase, record_path)


# --------------------------------------------------------------------------
# phase 3p: the keyed and bootstrapped sketched curves (B5's batched form)
# --------------------------------------------------------------------------

#: phase 3p-b's cut: the first 10 of phase 3b's cohorts (the CPU twin's
#: 1.64 GB keyed state is updated on the host, about a second an update)
SKETCH_CLASS_COHORTS = 10
#: phase 3p-d: the pure bootstrap over the first 5 ImageNet-1k batches
SKETCH_BOOT_BATCHES = 5
_HIST_STATES = ("pos_hist", "neg_hist", "sketch_clipped")


def keyed_binary_cohorts(torch, keyed_batches, device):
    """Phase 3b's 50 cohorts of tenant ids (the last one 3000 real rows,
    padded with id -1) with the binary scorer stream's scores and labels,
    4096 at a time."""
    chunks = make_stream(torch, device)
    scores = torch.cat([s for s, _ in chunks])
    labels = torch.cat([t for _, t in chunks])
    return [(ids, scores[k * KEYED_ROWS:(k + 1) * KEYED_ROWS], labels[k * KEYED_ROWS:(k + 1) * KEYED_ROWS])
            for k, (ids, _, _) in enumerate(keyed_batches)]


def build_sketched_keyed(M, device, **kw):
    """``KeyedMetric(AUROC(sketched=True))`` over 10,000 tenants at the class
    default of 2048 bins over (0, 1)."""
    return M.KeyedMetric(M.AUROC(sketched=True, device=device, **kw), num_tenants=KEYED_TENANTS,
                         validate_ids=False, device=device)


def _hist_batched_stack(torch, dev, r, n, c, dense, gen):
    """One stack as B5's batched entry takes it: uniform scores with dense
    int32 labels or int64 class ids (some outside [0, C))."""
    scores = torch.rand((r, n, c), generator=gen, device=dev)
    if dense:
        return scores, torch.randint(0, 2, (r, n, c), generator=gen, device=dev, dtype=torch.int32)
    return scores, torch.randint(-1, c + 1, (r, n), generator=gen, device=dev)


def hist_batched_timing(torch, dev, label, scores, labels) -> dict:
    """B5's batched wrapper at one stack: wrapper (CUDA events), device time
    (profiler) and its split, 50 calls in one replayed graph, the plain
    version, ``torch.bincount`` over the same flat (slice, label, class, bin)
    index (computed outside the timed region) and the byte bound."""
    from metrics_tpu_torch.kernels.binned_counts import (
        _bin_index,
        label_score_histograms_batched_cuda,
        label_score_histograms_batched_torch,
    )

    r, n, c = scores.shape
    dense = labels.ndim == 3
    cells = c * NUM_BINS
    positive = labels == 1 if dense else labels.unsqueeze(-1) == torch.arange(c, device=dev)
    flat = (torch.arange(r, device=dev).view(r, 1, 1) * (2 * cells) + torch.where(positive, 0, cells)
            + torch.arange(c, device=dev) * NUM_BINS + _bin_index(scores, NUM_BINS, 0.0, 1.0)).reshape(-1)
    calls = {"ms": lambda: label_score_histograms_batched_cuda(scores, labels, NUM_BINS, device=dev),
             "plain_ms": lambda: label_score_histograms_batched_torch(scores, labels, NUM_BINS),
             "library_ms": lambda: torch.bincount(flat, minlength=r * 2 * cells)}
    label_bytes = r * n * c * 4 if dense else r * n * labels.element_size()
    bound_ms, bound_by = bound(r * n * c * 4 + label_bytes + 2 * r * cells * 4 + r * 4, 4 * r * n * c)
    out = {"shape": f"{label}: scores ({r}, {n}, {c}) float32, "
                    + (f"labels ({r}, {n}, {c}) int32" if dense else f"class ids ({r}, {n}) {labels.dtype}")
                    + f", B={NUM_BINS}",
           "bound_ms": bound_ms, "bound_by": bound_by}
    for key, fn in calls.items():
        out[key] = cuda_ms(fn)
        out[key.replace("ms", "device_ms")] = device_ms(fn) if key != "ms" else None
    out["device_ms"], out["profiler_records"] = device_ms_records(calls["ms"])
    out["graph_ms"] = graph_ms(calls["ms"])
    out["device_split_us"] = device_split(calls["ms"])
    out["device_ms_from"] = "profiler"
    if out["device_ms"] is not None and out["device_ms"] < bound_ms:
        # a profiler time below the byte bound is no time the card can take for the work (PERF.md section 6,
        # scripts/torch_hist_ab.py --profiler-check): the kernel's time is the replayed graph's
        out["profiler_device_ms"], out["device_ms"], out["device_ms_from"] = out["device_ms"], out["graph_ms"], "graph"
    print(f"[sketched keyed] B5 batched at {out['shape']}: wrapper {out['ms']:.4f} ms (device "
          f"{out['device_ms']:.4f} from the {out['device_ms_from']}"
          + (f", the profiler's {out['profiler_device_ms']:.4f} below the bound" if "profiler_device_ms" in out else "")
          + f"; {out['profiler_records']} kernel records of {REPS} calls in its profile"
          + f"; in a replayed graph of 50 calls {out['graph_ms']:.4f}), plain "
          f"{out['plain_ms']:.4f} ms ({out['plain_device_ms']:.4f}), torch.bincount {out['library_ms']:.4f} ms "
          f"({out['library_device_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by}); device split "
          + "; ".join(f"{us:.2f} us {name}" for name, us in out["device_split_us"].items()))
    return out


def hist_batched_parity(torch, dev, gen, parity) -> float:
    """Phase 2, B5's batched entry: each stack counted by one call of the
    wrapper (one launch counted) == the plain batched version on the card
    exactly, and == the plain version on the CPU where the stack fits the
    host's time (the card's plain version divides by a device tensor). The
    three paths' stacks, ragged ones (C = 7, a last z group of one slice,
    slices of no row, ragged tiles, misaligned scores), both label forms
    with int32 and int64 ids (some outside [0, C)), every bin edge with its
    float32 neighbours and NaN, +-inf and subnormal scores, the global mode,
    and outputs past 2^31 cells in both modes. Returns the largest
    |kernel - plain|."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.binned_counts import (
        batched_histogram_plan,
        label_score_histograms_batched_cuda,
        label_score_histograms_batched_torch,
    )

    def stack(r, n, c, form):
        scores, labels = _hist_batched_stack(torch, dev, r, n, c, form == "dense", gen)
        return scores, labels if form != "ids32" else labels.to(torch.int32)

    cases = [(f"({r}, {n}, {c}) B={b} {form}{note}", *stack(r, n, c, form), b, 0.0, 1.0, on_cpu)
             for r, n, c, b, form, note, on_cpu in [
                 (KEYED_ROWS, 1, 1, NUM_BINS, "dense", ", the keyed binary rows", True),
                 (KEYED_ROWS, 1, KEYED_CLASSES, NUM_BINS, "ids64", ", the keyed 10-class rows", True),
                 (BOOTSTRAPS, BATCH, NUM_CLASSES, NUM_BINS, "ids64", ", a bootstrap's resamples", True),
                 (300, 5, 7, NUM_BINS, "dense", "", True), (300, 5, 7, NUM_BINS, "ids32", "", True),
                 (65_536, 1, 1, NUM_BINS, "dense", ", a last z group of one slice", True),
                 (5, 0, 7, NUM_BINS, "dense", ", no rows", True), (5, 0, 7, NUM_BINS, "ids64", ", no rows", True),
                 (3, 64, 1001, NUM_BINS, "ids32", ", ragged tiles", True),
                 (4, 300, 1000, NUM_BINS, "dense", ", 16-byte loads", True),
                 (3, 16, 4, 65536, "dense", ", global mode", True), (5, 7, 3, 40_000, "ids64", ", global mode", True),
                 (131_200, 1, 8, NUM_BINS, "dense", ", past 2^31 cells an output", False),
                 (66_000, 1, 1, 32_768, "ids64", ", global mode past 2^31 cells and 65,535 slices", False),
             ]]
    buf = torch.rand(8 * 16 * 8 + 1, generator=gen, device=dev)
    cases.append(("(8, 16, 8) B=2048 dense, scores 4 bytes into their buffer", buf[1:].view(8, 16, 8),
                  torch.randint(0, 2, (8, 16, 8), generator=gen, device=dev, dtype=torch.int32), NUM_BINS, 0.0, 1.0,
                  True))
    for b, lo, hi in [(NUM_BINS, 0.0, 1.0), (1000, 0.0, 1.0), (4096, 0.1, 0.7)]:
        edges = edge_scores(torch, dev, b, lo, hi)
        alternate = (torch.arange(edges.shape[0], device=dev) % 2).int()
        cases.append((f"every edge of B={b} over ({lo}, {hi}) with neighbours, NaN, +-inf, subnormals: a slice each",
                      edges.reshape(-1, 1, 1), alternate.reshape(-1, 1, 1), b, lo, hi, True))
        cases.append(("the same in one slice, class ids of 3 columns", edges.reshape(1, -1, 1).expand(1, -1, 3)
                      .contiguous(), alternate.reshape(1, -1).long(), b, lo, hi, True))
    worst = 0.0
    for label, scores, labels, b, lo, hi, on_cpu in cases:
        before = _common.launch_count("label_score_histograms")
        got = label_score_histograms_batched_cuda(scores, labels, b, lo, hi, device=dev)
        torch.cuda.synchronize()
        if _common.launch_count("label_score_histograms") != before + 1:
            fail(f"label_score_histograms' batched form did not count one launch: {label}")
        want = label_score_histograms_batched_torch(scores, labels, b, lo, hi)
        ok = all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
        if ok and on_cpu:
            ok = trees_equal(torch, got, label_score_histograms_batched_torch(scores.cpu(), labels.cpu(), b, lo, hi))
        err = 0.0 if ok else max(float((g - w).abs().max()) for g, w in zip(got, want) if g.numel())
        worst = max(worst, err)
        plan = batched_histogram_plan(scores.shape[1], scores.shape[2], b)
        mode = ("store", "add", "global")[plan.mode]
        parity.append({"kernel": "label_score_histograms_batched", "case": label, "equal": ok, "max_abs_err": err,
                       "clipped": float(got[2].sum())})
        print(f"[parity] label_score_histograms batched {label}: {'equal' if ok else 'DIFFERENT'} (kernel == plain "
              f"on the card{' == plain on the CPU' if on_cpu else ''}; clipped {float(got[2].sum()):.0f}; {mode}, "
              f"{plan.tiles} tiles of {plan.k} a slice, {plan.threads} threads)")
        if not ok:
            fail(f"label_score_histograms' batched form differs from its plain version: {label}")
        del got, want
        torch.cuda.empty_cache()
    return worst


def _sketched_keyed_run(torch, _common, label, gpu, cpu, cohorts, want_launches, per_class=None) -> dict:
    """One keyed sketched run: the updates on the card (timed, launches
    counted, no plain B5 dispatch), ``compute()``, the same cohorts on the
    CPU twin, the stacked states equal exactly and the values within 1e-6,
    at least one of them finite. ``per_class``, a pair of the same keyed
    metric with ``average=None`` on the card and on the CPU, also computes
    each device's states per class: where every macro value is NaN (a
    tenant with a class of one label), those hold the finite values."""
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    update_ms = []
    for cohort in cohorts:
        start = time.perf_counter()
        gpu.update(*cohort)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - start) * 1e3)
    launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    plain = _common.dispatch_count("label_score_histograms", "torch")
    if launches != want_launches or plain:
        fail(f"[sketched keyed] {label}: launches {launches} and {plain} plain B5 dispatches, expected "
             f"{want_launches} and none")
    start = time.perf_counter()
    out = gpu.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    for cohort in cohorts:
        cpu.update(*(x.cpu() for x in cohort))
    for name, value in cpu._get_states().items():
        got = getattr(gpu, name)
        if got.dtype != value.dtype or not torch.equal(got.cpu(), value):
            fail(f"[sketched keyed] {label}: state {name} on the card differs from the CPU's")
    if per_class is None:
        diff, compared = finite_max_diff(torch, f"[sketched keyed] {label}", out, cpu.compute())
    else:
        diff = tree_max_diff(torch, out, cpu.compute())
        gpu_per_class, cpu_per_class = per_class
        per_class_diff, compared = finite_max_diff(
            torch, f"[sketched keyed] {label} per class",
            gpu_per_class.apply_compute(gpu._get_states(), process_group=None),
            cpu_per_class.apply_compute(cpu._get_states(), process_group=None))
        diff = max(diff, per_class_diff)
    if diff > 1e-6:
        fail(f"[sketched keyed] {label}: values differ from the CPU's by {diff}")
    finite = out[~out.isnan()]
    print(f"[sketched keyed] {label}: {len(cohorts)} updates, launches "
          f"{ {k: v for k, v in launches.items() if v} }, 0 plain B5 dispatches; update median "
          f"{statistics.median(update_ms):.3f} ms (first {update_ms[0]:.3f}), compute {compute_ms:.3f} ms; states "
          f"== CPU exactly, values within {diff:.1e} over {compared} finite "
          f"{'per-class values of the same states' if per_class else 'values'}; {finite.numel()} tenants with a "
          f"value, mean {float(finite.mean()) if finite.numel() else float('nan'):.6f}")
    return {"launches": launches, "update_ms": update_ms, "compute_ms": compute_ms, "max_abs_diff_vs_cpu": diff,
            "finite_values_compared": compared, "tenants_with_value": finite.numel(),
            "mean": float(finite.mean()) if finite.numel() else None, "values": out}


def sketched_keyed_phase(torch, M, dev, card, batches=None, keyed_batches=None) -> dict:
    """Phase 3p: B5's batched form on its two paths. (a) ``KeyedMetric(
    AUROC(sketched=True))`` over 10,000 tenants, phase 3b's tenant ids with
    the binary stream's scores, 50 updates of 4096 rows; (b) the 10-class
    one-vs-rest ``KeyedMetric(AUROC(num_classes=10, sketched=True))`` over
    phase 3b's first 10 cohorts; (c) (a) under ``warmup`` + ``update_many``
    (K = 5); (d) the pure ``BootStrapper`` of sketched 1000-class ``AUROC``
    (20 resamples) over 5 ImageNet-1k batches. Each launches the batched
    entry once an update and never the plain version on the card; states
    == the CPU's exactly, values within 1e-6."""
    from metrics_tpu_torch.kernels import _common
    import metrics_tpu_torch.wrappers.bootstrapping as boot

    record = {}
    if batches is None:
        batches = make_batches(torch, dev)
    if keyed_batches is None:
        keyed_batches = make_keyed_batches(torch, dev)
    none = {op: 0 for op in KERNEL_OPS}

    # (a) the keyed binary curve
    cohorts = keyed_binary_cohorts(torch, keyed_batches, dev)
    gpu, cpu = build_sketched_keyed(M, dev), build_sketched_keyed(M, "cpu")
    want = {**none, "label_score_histograms": KEYED_UPDATES, "segment_merge": KEYED_UPDATES}
    binary = _sketched_keyed_run(torch, _common, "(a) binary AUROC", gpu, cpu, cohorts, want)
    values = binary.pop("values").cpu()
    scores = torch.cat([s for _, s, _ in cohorts]).cpu()
    labels = torch.cat([t for _, _, t in cohorts]).cpu()
    ids = torch.cat([i for i, _, _ in cohorts]).cpu()
    alone = {}
    for tenant in torch.nonzero(~values.isnan()).reshape(-1)[:4].tolist():
        m = M.AUROC(sketched=True, device=dev)
        rows = ids == tenant
        m.update(scores[rows].to(dev), labels[rows].to(dev))
        alone[tenant] = (float(m.compute()), float(values[tenant]))
        if abs(alone[tenant][0] - alone[tenant][1]) > 1e-6:
            fail(f"[sketched keyed] tenant {tenant}: keyed AUROC {alone[tenant][1]} against "
                 f"{alone[tenant][0]} of its own rows alone")
    print(f"[sketched keyed] (a) tenants' AUROC == their own unkeyed sketched AUROC on the card: {alone}")
    binary["alone"] = alone
    binary["state_bytes"] = sum(getattr(gpu, s).numel() * 4 for s in _HIST_STATES)
    prof = build_sketched_keyed(M, dev)
    prof.update(*cohorts[0])
    binary["profile"] = profile_steps(torch, prof.update, cohorts[1:11])
    p = binary["profile"]
    print(f"[sketched keyed] (a) 10 updates under the profiler: wall {p['wall_ms']:.3f} ms, device busy "
          f"{p['device_busy_ms']:.3f} ms (idle share {1 - p['device_busy_ms'] / p['wall_ms']:.3f})")
    for row in p["top_device"]:
        print(f"[sketched keyed]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["binary"] = binary
    del prof, cpu

    # (c) (a) compiled: warmup, then update_many with K = 5 ten times
    many = build_sketched_keyed(M, dev)
    many.warmup(*cohorts[0])
    stacks = [[torch.stack([c[j] for c in cohorts[k:k + 5]]) for j in range(3)] for k in range(0, KEYED_UPDATES, 5)]
    many.update_many(*stacks[0])  # captures the graph (cohorts 0-4 hold no invalid id); then reset()
    many.reset()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    many_ms = []
    for stacked in stacks:
        start = time.perf_counter()
        many.update_many(*stacked)
        torch.cuda.synchronize()
        many_ms.append((time.perf_counter() - start) * 1e3)
    many_launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    if many_launches != want or _common.dispatch_count("label_score_histograms", "torch"):
        fail(f"[sketched keyed] (c) update_many launched {many_launches}, expected {want} and no plain B5")
    for name in _HIST_STATES:
        if not torch.equal(getattr(many, name), getattr(gpu, name)):
            fail(f"[sketched keyed] (c) update_many's {name} differs from the eager updates'")
    print(f"[sketched keyed] (c) warmup + update_many (K = 5) x 10: launches "
          f"{ {k: v for k, v in many_launches.items() if v} } through the replays, states == (a)'s eager updates; "
          f"per call median {statistics.median(many_ms):.3f} ms")
    record["compiled"] = {"launches": many_launches, "update_many_ms": many_ms}
    del many, stacks

    # the batched entry at the keyed binary rows' stack, as the vmap rule hands it over
    _, first_scores, first_labels = cohorts[0]
    timing = {"keyed_binary": hist_batched_timing(
        torch, dev, "keyed binary rows", first_scores.reshape(KEYED_ROWS, 1, 1).contiguous(),
        (first_labels == 1).to(torch.int32).reshape(KEYED_ROWS, 1, 1))}
    del gpu, cohorts

    # (b) the keyed 10-class one-vs-rest curve, first cohorts only
    gpu = build_sketched_keyed(M, dev, num_classes=KEYED_CLASSES)
    cpu = build_sketched_keyed(M, "cpu", num_classes=KEYED_CLASSES)
    want_b = {**none, "label_score_histograms": SKETCH_CLASS_COHORTS, "segment_merge": SKETCH_CLASS_COHORTS}
    per_class = tuple(build_sketched_keyed(M, d, num_classes=KEYED_CLASSES, average=None) for d in (dev, "cpu"))
    multiclass = _sketched_keyed_run(torch, _common, "(b) 10-class one-vs-rest AUROC", gpu, cpu,
                                     keyed_batches[:SKETCH_CLASS_COHORTS], want_b, per_class)
    multiclass.pop("values")
    multiclass["state_bytes"] = sum(getattr(gpu, s).numel() * 4 for s in _HIST_STATES)
    record["multiclass"] = multiclass
    del gpu, cpu, per_class
    ids0, preds0, target0 = keyed_batches[0]
    timing["keyed_classes"] = hist_batched_timing(
        torch, dev, "keyed 10-class rows", preds0.reshape(KEYED_ROWS, 1, KEYED_CLASSES).contiguous(),
        target0.reshape(KEYED_ROWS, 1))

    # (d) the pure bootstrap of sketched 1000-class AUROC
    def build_boot(device, average="macro"):
        return M.BootStrapper(M.AUROC(num_classes=NUM_CLASSES, sketched=True, average=average, device=device),
                              num_bootstraps=BOOTSTRAPS, seed=SEED)

    real_indices, matrices = boot._bootstrap_indices, []

    def recording_indices(*args, **kwargs):
        idx = real_indices(*args, **kwargs)
        matrices.append(idx)
        return idx

    boot_batches = batches[:SKETCH_BOOT_BATCHES]
    pure = build_boot(dev)
    state = pure.init_state()
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    boot._bootstrap_indices = recording_indices
    pure_ms = []
    try:
        for preds, target in boot_batches:
            start = time.perf_counter()
            state = pure.apply_update(state, preds, target)
            torch.cuda.synchronize()
            pure_ms.append((time.perf_counter() - start) * 1e3)
    finally:
        boot._bootstrap_indices = real_indices
    pure_launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
    want_d = {**none, "label_score_histograms": SKETCH_BOOT_BATCHES}
    if pure_launches != want_d or _common.dispatch_count("label_score_histograms", "torch"):
        fail(f"[sketched keyed] (d) the pure bootstrap launched {pure_launches}, expected {want_d} and no plain B5")
    start = time.perf_counter()
    stats = pure.apply_compute(state, process_group=None)
    torch.cuda.synchronize()
    boot_compute_ms = (time.perf_counter() - start) * 1e3
    cpu_pure = build_boot("cpu")
    cpu_state = cpu_pure.init_state()
    replay = iter(matrices)
    boot._bootstrap_indices = lambda *a, **k: next(replay).cpu()
    try:
        for preds, target in boot_batches:
            cpu_state = cpu_pure.apply_update(cpu_state, preds.cpu(), target.cpu())
    finally:
        boot._bootstrap_indices = real_indices
    for name in _HIST_STATES:
        if not torch.equal(state["children"][name].cpu(), cpu_state["children"][name]):
            fail(f"[sketched keyed] (d) the children's {name} on the card differs from the CPU replay's")
    want_stats = cpu_pure.apply_compute(cpu_state, process_group=None)
    # NaN in the same places (tree_max_diff): a resample of 5,120 rows misses some of the 1000 classes'
    # positives, and the macro AUROC of such a child is NaN in both packages
    boot_diff = max(tree_max_diff(torch, stats[k], want_stats[k]) for k in stats)
    # so the statistics per class of the same states hold the finite values compared
    per_class_stats = build_boot(dev, None).apply_compute(state, process_group=None)
    want_per_class = build_boot("cpu", None).apply_compute(cpu_state, process_group=None)
    per_class_diff, compared = finite_max_diff(torch, "[sketched keyed] (d) the bootstrap statistics per class",
                                               [per_class_stats[k] for k in sorted(want_per_class)],
                                               [want_per_class[k] for k in sorted(want_per_class)])
    boot_diff = max(boot_diff, per_class_diff)
    if boot_diff > 1e-6:
        fail(f"[sketched keyed] (d) the bootstrap statistics differ from the CPU replay's by {boot_diff}")
    print(f"[sketched keyed] (d) BootStrapper(AUROC(num_classes={NUM_CLASSES}, sketched=True), {BOOTSTRAPS}) pure "
          f"over {SKETCH_BOOT_BATCHES} ImageNet-1k batches: launches "
          f"{ {k: v for k, v in pure_launches.items() if v} }, 0 plain B5 dispatches; apply_update median "
          f"{statistics.median(pure_ms):.3f} ms, apply_compute {boot_compute_ms:.3f} ms; children's histograms == "
          f"the CPU replay of the card's index matrices exactly, statistics within {boot_diff:.1e} ({compared} "
          f"finite statistics per class of the same states compared): mean "
          f"{float(stats['mean']):.6f} std {float(stats['std']):.6f}")
    record["bootstrap"] = {"launches": pure_launches, "apply_update_ms": pure_ms, "apply_compute_ms": boot_compute_ms,
                           "max_abs_diff_vs_cpu": boot_diff, "finite_values_compared": compared,
                           "mean": float(stats["mean"]), "std": float(stats["std"])}
    idx = matrices[0]
    preds0, target0 = boot_batches[0]
    timing["bootstrap"] = hist_batched_timing(torch, dev, "bootstrap resamples", preds0[idx].contiguous(),
                                              target0[idx].contiguous())
    record["timing"] = timing
    del pure, state, cpu_pure, cpu_state
    return record


def sketched_keyed_phase_main(record_path: str = "") -> int:
    """Run :func:`sketched_keyed_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(sketched_keyed_phase, record_path)


def _merge_inputs(torch, dev, gen, dtype, ids_dtype=None):
    """The merge's inputs at the keyed path's shapes: ids (-2 and ids past S
    among them), Accuracy's rows as the columns of one (R, 5) tensor (tp, fp,
    tn, fn, mode_code), the macro bundle's (R, 4, 10) rows as B1's batched
    entry gives them, non-zero defaults (0-d and (10,)) and the eleven
    (S, ...) states; float rows hold NaN, -0.0 and +0.0 in the max leaf."""
    ids = torch.randint(-2, KEYED_TENANTS + 8, (KEYED_ROWS,), generator=gen, device=dev)
    ids = ids if ids_dtype is None else ids.to(ids_dtype)
    acc = torch.randint(-1, 3, (KEYED_ROWS, 5), generator=gen, device=dev).to(dtype)
    if dtype.is_floating_point:
        acc[:3, 4] = torch.tensor([float("nan"), -0.0, 0.0], device=dev)
    macro = torch.randint(0, 3, (KEYED_ROWS, 4, KEYED_CLASSES), generator=gen, device=dev).to(dtype)
    d0, d10 = torch.ones((), dtype=dtype, device=dev), torch.ones(KEYED_CLASSES, dtype=dtype, device=dev)
    states = [torch.randint(-5, 6, (KEYED_TENANTS,) + shape, generator=gen, device=dev).to(dtype)
              for shape in [()] * 7 + [(KEYED_CLASSES,)] * 4]
    r = KEYED_ROWS
    rows = [acc[:, k] for k in range(4)] + [d0.expand(r), d0.expand(r), acc[:, 4]] + [macro[:, k] for k in range(4)]
    ops = ["sum"] * 6 + ["max"] + ["sum"] * 4
    return ids, [(x, st, d, op) for x, st, d, op in zip(rows, states, [d0] * 7 + [d10] * 4, ops)]


def _per_leaf_chain(torch, leaves, ids, s, dev):
    """One bundle's route before the merge, through B3 and B4 on the card:
    its sum leaves' ``rows - default`` cast to float32, packed by ``cat``
    into one B3 launch, the columns sliced, cast back and added to the
    states; each extremal leaf through one B4 launch, then ``maximum`` or
    ``minimum`` against its state where its count is non-zero; the dropped
    ids summed."""
    from metrics_tpu_torch.kernels.segment_scatter import (
        segment_scatter_add_cuda,
        segment_scatter_max_cuda,
        segment_scatter_min_cuda,
    )

    outs, counts = [None] * len(leaves), None
    sums = [i for i, leaf in enumerate(leaves) if leaf[3] == "sum"]
    if sums:
        columns = [(leaves[i][0] - leaves[i][2]).reshape(ids.shape[0], -1).to(torch.float32) for i in sums]
        packed, counts = segment_scatter_add_cuda(torch.cat(columns, dim=1).contiguous(), ids, s, device=dev)
        offset = 0
        for i, column in zip(sums, columns):
            state = leaves[i][1]
            width = column.shape[1]
            outs[i] = state + packed[:, offset:offset + width].reshape(state.shape).to(state.dtype)
            offset += width
    for i, (rows, state, _, op) in enumerate(leaves):
        if op == "sum":
            continue
        kernel = segment_scatter_max_cuda if op == "max" else segment_scatter_min_cuda
        seg, seg_counts = kernel(rows.reshape(ids.shape[0], -1).to(torch.float32).contiguous(), ids, s, device=dev)
        counts = seg_counts if counts is None else counts
        pick = torch.maximum if op == "max" else torch.minimum
        has_rows = (seg_counts > 0).reshape((s,) + (1,) * (state.ndim - 1))
        outs[i] = torch.where(has_rows, pick(state, seg.reshape(state.shape).to(state.dtype)), state)
    return outs, counts, torch.sum((ids < 0) | (ids >= s)).to(torch.int32)


def merge_phase(torch, M, dev, card, keyed_batches=None) -> dict:
    """Phase 3q: the merge (``segment_merge``), the keyed update's one launch.
    (a) At the keyed path's shapes (R = 4096, S = 10,000, the keyed cell's
    eleven leaves, strided and broadcast rows, non-zero defaults), int32,
    float32, bfloat16, int16 and int8, int64 and int32 ids: the kernel == its
    plain version on the CPU bit for bit, one launch each. (b) Phase 3b's real leaves (the two bundles' row
    states of its first cohort): the kernel == the plain version == the
    per-leaf chain through B3 and B4 it replaced, bit for bit. (c) A keyed
    regression bundle's leaves (float32 sums of real-valued rows over a large
    state, an int32 count): the count exactly, the sums within rtol 1e-6 of
    the plain version's. (d) Phase 3b's collection over its 50 cohorts,
    eager and compiled (``warmup``): the merge 50 launches each, B3 and B4
    none, the compiled states == the eager ones exactly; a keyed bundle of
    narrow leaves (:func:`_narrow_leaf_metrics`) over the padding band and
    dropped ids, alone (a ``KeyedMetric``) and beside a second bundle (a
    ``MultiTenantCollection``), eager and compiled: the card's states == the
    CPU's bit for bit, the merge once an update, B3 and B4 none. (e) Times
    at (b)'s
    leaves: the merge and the chain (two bundles: B3 and B4, B3) by CUDA
    events, device time, 50 in a replayed graph, and host time per call
    (1000 calls back to back), beside the plain version and the bound."""
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.segment_scatter import segment_merge_cuda, segment_merge_torch

    if keyed_batches is None:
        keyed_batches = make_keyed_batches(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 47)
    s = KEYED_TENANTS
    out = {"parity": []}

    def exact(got, want):
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                return False
            gf, wf = g.double(), w.double()
            same = (gf == wf) | (gf.isnan() & wf.isnan())
            signs = torch.signbit(gf) == torch.signbit(wf)
            if not bool((same & (signs | gf.isnan())).all()):
                return False
        return True

    def flat(result):
        outs, counts, invalid = result
        return list(outs) + [counts, invalid]

    # (a) the kernel against its plain version
    for dtype in (torch.int32, torch.float32, torch.bfloat16, torch.int16, torch.int8):
        for ids_dtype in (torch.int64, torch.int32):
            ids, leaves = _merge_inputs(torch, dev, gen, dtype, ids_dtype)
            _common.reset_dispatch_counters()
            got = [t.cpu() for t in flat(segment_merge_cuda(leaves, ids, s, device=dev))]
            launches = {op: _common.launch_count(op) for op in KERNEL_OPS}
            # the plain version on the CPU: the card's scatter_reduce_ need not take int8/int16
            host = [(x.cpu(), st.cpu(), d.cpu(), op) for x, st, d, op in leaves]
            want = flat(segment_merge_torch(host, ids.cpu(), s))
            ok = exact(got, want) and launches == {op: int(op == "segment_merge") for op in KERNEL_OPS}
            out["parity"].append({"dtype": str(dtype), "ids": str(ids_dtype), "exact": ok, "launches": launches})
            if not ok:
                fail(f"[merge] (a) {dtype} rows, {ids_dtype} ids: the kernel differs from its plain version or "
                     f"launched {launches}")
    # (b) phase 3b's real leaves: kernel == plain == the chain through B3 and B4
    keyed = build_keyed(M, dev)
    keyed.build()
    ids, preds, target = keyed_batches[0]
    bundles = [(km, km._get_states(), km._bundle_rows((preds, target), {})) for km in keyed._keyed.values()]
    real = [[(per_row[name], state[name], default, fx) for name, fx, default in km._scatter_plan().merged]
            for km, state, per_row in bundles]
    leaves = [leaf for bundle in real for leaf in bundle]
    strides = [leaf[0].stride() for leaf in leaves]
    got = flat(segment_merge_cuda(leaves, ids, s, device=dev))
    want = flat(segment_merge_torch(leaves, ids, s))
    chain = [_per_leaf_chain(torch, bundle, ids, s, dev) for bundle in real]
    chain_flat = chain[0][0] + chain[1][0] + [chain[0][1], chain[0][2]]
    torch.cuda.synchronize()
    if len(leaves) != 11 or not exact(got, want) or not exact(got, chain_flat):
        fail(f"[merge] (b) phase 3b's {len(leaves)} leaves: the kernel, its plain version and the per-leaf chain "
             "through B3 and B4 differ")
    # (c) a keyed regression bundle
    err = torch.randn(KEYED_ROWS, generator=gen, device=dev)
    big = 1e6 * torch.rand(s, generator=gen, device=dev)
    zero_f, zero_i = torch.zeros((), device=dev), torch.zeros((), dtype=torch.int32, device=dev)
    reg = [(err * err, big, zero_f, "sum"), (err.abs(), big.clone(), zero_f, "sum"),
           (torch.ones((), dtype=torch.int32, device=dev).expand(KEYED_ROWS),
            torch.randint(0, 9, (s,), generator=gen, device=dev, dtype=torch.int32), zero_i, "sum")]
    reg_ids = keyed_batches[1][0]
    got_r = segment_merge_cuda(reg, reg_ids, s, device=dev)
    want_r = segment_merge_torch(reg, reg_ids, s)
    torch.cuda.synchronize()
    reg_diff = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()) for g, w in zip(got_r[0][:2], want_r[0][:2]))
    if reg_diff > 1e-6 or not (torch.equal(got_r[0][2], want_r[0][2]) and torch.equal(got_r[1], want_r[1])
                               and torch.equal(got_r[2], want_r[2])):
        fail(f"[merge] (c) the regression bundle: sums within {reg_diff:.2e} (limit 1e-6), count or counts differ")
    # (d) the keyed collection eager and compiled: one merge an update, no B3, no B4
    eager, compiled = build_keyed(M, dev), build_keyed(M, dev)
    compiled.warmup(*keyed_batches[0])
    update_launches = {}
    for label, obj in (("eager", eager), ("compiled", compiled)):
        torch.cuda.synchronize()
        _common.reset_dispatch_counters()
        for batch in keyed_batches:
            obj.update(*batch)
        torch.cuda.synchronize()
        update_launches[label] = {op: _common.launch_count(op) for op in KERNEL_OPS}
        want_l = {op: (KEYED_UPDATES if op in ("segment_merge", "stat_scores_counts") else 0) for op in KERNEL_OPS}
        if update_launches[label] != want_l:
            fail(f"[merge] (d) the {label} keyed collection launched {update_launches[label]}, expected {want_l}")
    for owner, km in eager._keyed.items():
        _states_equal(torch, f"merge (d) compiled {owner}", compiled._keyed[owner], km)
    small, beside = _narrow_leaf_metrics(torch, M)
    narrow_batches = _narrow_leaf_batches(torch)
    narrow_kw = dict(validate_ids=False, capacity=2 * s)
    makers = {"KeyedMetric": lambda d: M.KeyedMetric(small(device=d), s, device=d, **narrow_kw),
              "MultiTenantCollection": lambda d: M.MultiTenantCollection(
                  {"small": small(device=d), "merged": beside(device=d)}, s, device=d, **narrow_kw)}
    narrow_launches = {}
    for label, make in makers.items():
        host = make("cpu")
        for batch in narrow_batches:
            host.update(*batch)
        for path in ("eager", "compiled"):
            card_obj = make(dev)
            if path == "compiled":  # both row counts captured before counting
                for batch in (narrow_batches[0], narrow_batches[-1]):
                    card_obj.warmup(*[b.to(dev) for b in batch])
            torch.cuda.synchronize()
            _common.reset_dispatch_counters()
            for batch in narrow_batches:
                card_obj.update(*[b.to(dev) for b in batch])
            torch.cuda.synchronize()
            launches = narrow_launches[f"{label} {path}"] = {op: _common.launch_count(op) for op in KERNEL_OPS}
            if launches != {op: (len(narrow_batches) if op == "segment_merge" else 0) for op in KERNEL_OPS}:
                fail(f"[merge] (d) the {path} {label} of narrow leaves launched {launches}: expected the merge once "
                     "an update and nothing else")
            bundles = (lambda o: list(o._keyed.values())) if label == "MultiTenantCollection" else (lambda o: [o])
            for got, want in zip(bundles(card_obj), bundles(host)):
                for name, value in want._get_states().items():
                    if not exact([getattr(got, name).cpu()], [value]):
                        fail(f"[merge] (d) the {path} {label}'s narrow leaf {name} differs from the CPU's")
    # (e) times: the merge against the chain it replaced, at (b)'s leaves
    nbytes = (sum(leaf[0].shape[0] * max(leaf[2].numel(), 1) * 4 for leaf in leaves) + KEYED_ROWS * 8
              + 2 * sum(leaf[1].numel() * 4 for leaf in leaves) + s * 4)
    merge_call = (lambda: segment_merge_cuda(leaves, ids, s, device=dev))
    chain_call = (lambda: [_per_leaf_chain(torch, bundle, ids, s, dev) for bundle in real])
    plain_call = (lambda: segment_merge_torch(leaves, ids, s))
    times = {"bound": bound(nbytes, sum(leaf[0].shape[0] * max(leaf[2].numel(), 1) for leaf in leaves))}
    for key, fn in (("ms", merge_call), ("chain_ms", chain_call), ("plain_ms", plain_call)):
        times[key] = cuda_ms(fn)
        times[key.replace("ms", "device_ms")] = device_ms(fn)
    times["graph_ms"] = graph_ms(merge_call)
    times["chain_graph_ms"] = graph_ms(chain_call)
    times["host_us"] = host_us([("merge", merge_call), ("chain", chain_call)])
    out.update({"real_leaves": len(leaves), "real_row_strides": strides, "regression_rel_diff": reg_diff,
                "update_launches": update_launches, "narrow_leaf_launches": narrow_launches, "times": times})

    def fmt(ms):
        return "none" if ms is None else f"{ms:.4f} ms"

    print(f"[merge] (a) the kernel == its plain version bit for bit at ({KEYED_ROWS} rows, {s} tenants, 11 leaves), "
          f"int32, float32, bfloat16, int16 and int8 rows, int64 and int32 ids, one launch each; (b) phase 3b's real "
          f"leaves (row strides "
          f"{strides}): kernel == plain == the per-leaf chain through B3/B4; (c) the regression bundle within "
          f"{reg_diff:.2e}; (d) {KEYED_UPDATES} keyed updates eager and compiled: launches {update_launches['eager']} "
          f"and {update_launches['compiled']} (compiled states == eager); narrow leaves == the CPU, "
          f"launches {narrow_launches} on {card}")
    print(f"[merge] (e) at phase 3b's leaves: merge {fmt(times['ms'])} (device {fmt(times['device_ms'])}; "
          f"graph {fmt(times['graph_ms'])}; host {times['host_us']['merge']:.3f} us a call) against the chain "
          f"through B3/B4 {fmt(times['chain_ms'])} (device {fmt(times['chain_device_ms'])}; graph "
          f"{fmt(times['chain_graph_ms'])}; host {times['host_us']['chain']:.3f} us); plain {fmt(times['plain_ms'])} "
          f"({fmt(times['plain_device_ms'])}); bound {times['bound'][0]:.5f} ms ({times['bound'][1]})")
    return out


def _narrow_leaf_metrics(torch, M):
    """Two metrics updated with ``(x, z, k)``: the first holds narrow leaves
    (a bfloat16 sum, an int8 sum, an int16 max, an int8 min, a bfloat16
    max), the second an int32 count and a float32 max."""

    class SmallLeaves(M.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("s", torch.zeros((2,), dtype=torch.bfloat16), dist_reduce_fx="sum")
            self.add_state("c8", torch.tensor(0, dtype=torch.int8), dist_reduce_fx="sum")
            self.add_state("hi16", torch.tensor(-(2**15), dtype=torch.int16), dist_reduce_fx="max")
            self.add_state("lo8", torch.tensor(127, dtype=torch.int8), dist_reduce_fx="min")
            self.add_state("hib", torch.tensor(-float("inf"), dtype=torch.bfloat16), dist_reduce_fx="max")

        def update(self, x, z, k):
            self.s = self.s + torch.stack([x.sum(), (2 * x).sum()])
            self.c8 = self.c8 + k.sum().to(torch.int8)
            self.hi16 = torch.maximum(self.hi16, k.max())
            self.lo8 = torch.minimum(self.lo8, k.min().to(torch.int8))
            self.hib = torch.maximum(self.hib, z.max())

        def compute(self):
            return self.s[0].float() + self.hib.float()

    class MergedBeside(M.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("n", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("z32", torch.tensor(-float("inf")), dist_reduce_fx="max")

        def update(self, x, z, k):
            self.n = self.n + (k != 0).sum(dtype=torch.int32)
            self.z32 = torch.maximum(self.z32, z.float().max())

        def compute(self):
            return self.z32 + self.n

    return SmallLeaves, MergedBeside


def _narrow_leaf_batches(torch, updates=10):
    """``(ids, x, z, k)`` CPU batches for :func:`_narrow_leaf_metrics`: two
    where tenants 0 and 1 hold one signed zero and meet the other and
    tenants 2 and 4 meet a NaN, then ``updates`` of the keyed path's rows
    with ids over the padding band ``[10,000, 20,000)`` and outside it,
    integer-valued ``x`` (its bfloat16 sums exact in any order)."""
    ids = torch.tensor([0, 1, 2, 4])
    k = torch.tensor([7, -3, 100, -100], dtype=torch.int16)
    nan = float("nan")
    batches = [(ids, torch.ones(4), torch.tensor([-0.0, 0.0, nan, -1.0]), k),
               (ids, -torch.ones(4), torch.tensor([0.0, -0.0, -1.0, nan]), -k)]
    gen = torch.Generator()
    gen.manual_seed(SEED + 53)
    for _ in range(updates):
        z = torch.tensor([0.0, -0.0, -1.0, -0.5])[torch.randint(0, 4, (KEYED_ROWS,), generator=gen)]
        z[torch.rand(KEYED_ROWS, generator=gen) < 0.01] = nan
        batches.append((torch.randint(-2, 2 * KEYED_TENANTS + 2, (KEYED_ROWS,), generator=gen),
                        torch.randint(-4, 5, (KEYED_ROWS,), generator=gen).float(), z,
                        torch.randint(-120, 121, (KEYED_ROWS,), generator=gen, dtype=torch.int16)))
    return [(i, x.to(torch.bfloat16), z.to(torch.bfloat16), k) for i, x, z, k in batches]


def merge_phase_main(record_path: str = "") -> int:
    """Run :func:`merge_phase` alone (see :func:`_phase_alone`)."""
    return _phase_alone(merge_phase, record_path)


def compute_async_phase(torch, M, dev, batches, card) -> dict:
    """Phase 3h-c: ``compute_async`` of the ImageNet-1k collection after 25 of
    its 49 forwards against a synchronous ``compute()`` at that point."""
    coll = build_collection(M, dev)
    for preds, target in batches[:25]:
        coll(preds, target)
    torch.cuda.synchronize()
    # the snapshot compute_async takes on the caller's thread: a clone (a
    # deepcopy of the collection), timed alone over five calls
    clone_ms = []
    for _ in range(5):
        start = time.perf_counter()
        coll.clone()
        torch.cuda.synchronize()
        clone_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    future = coll.compute_async()
    async_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    want = coll.compute()
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - start) * 1e3
    for preds, target in batches[25:]:
        coll(preds, target)
    got = future.result(timeout=120)
    if got.keys() != want.keys() or not all(same_bits(got[k], want[k]) for k in want):
        fail(f"compute_async {dict((k, float(v)) for k, v in got.items() if v.ndim == 0)} != compute() at the "
             f"snapshot {dict((k, float(v)) for k, v in want.items() if v.ndim == 0)}")
    moved = sorted(k for k, v in coll.compute().items() if not same_bits(v, want[k]))
    print(f"[compute_async] after 25 of 49 forwards on {card}: the future == compute() at the snapshot, unmoved by "
          f"the 24 forwards after it (the live values moved for {len(moved)} members); caller's time "
          f"{async_ms:.3f} ms in compute_async against {sync_ms:.3f} ms in compute(); a clone alone, median of 5: "
          f"{statistics.median(clone_ms):.3f} ms")
    return {"compute_async_ms": async_ms, "compute_ms": sync_ms, "clone_ms": clone_ms, "generation": future.generation,
            "members_moved_after": moved}


def make_kl_targets(torch, device):
    """Phase 3f's seeded target distributions, one ``(n, 1000)`` softmax per
    ImageNet-1k batch."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    sizes = [min(BATCH, NUM_SAMPLES - start) for start in range(0, NUM_SAMPLES, BATCH)]
    return [torch.softmax(torch.randn((n, NUM_CLASSES), generator=gen, device=device), dim=1) for n in sizes]


def build_leftovers(M, device):
    """Phase 3f's metrics: the leftovers, the meter and the composition
    ``2 * P * R / (P + R)`` of macro Precision and Recall."""
    macro = dict(average="macro", num_classes=NUM_CLASSES, device=device)
    p, r = M.Precision(**macro), M.Recall(**macro)
    return {
        "HammingDistance": M.HammingDistance(device=device),
        "Hinge": M.Hinge(multiclass_mode="crammer-singer", device=device),
        "KLDivergence": M.KLDivergence(device=device),
        "AverageMeter": M.AverageMeter(device=device),
        "F1ofPR": 2 * p * r / (p + r),
    }


def leftovers_step(metrics, preds, target, q):
    """One 3f step: the forwards of the leftovers and the meter (of the
    batch's mean top-1 confidence), one update of the composition."""
    metrics["HammingDistance"](preds, target)
    metrics["Hinge"](preds, target)
    metrics["KLDivergence"](preds, q)
    metrics["AverageMeter"](preds.max(dim=1).values)
    metrics["F1ofPR"].update(preds, target)


def same_bits(a, b) -> bool:
    """Equal values, NaN where NaN (of either sign: a NaN's sign bit and
    payload carry nothing), and the same sign of zero."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a.isnan(), b.isnan()))
            and bool(torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)))
            and bool(torch.equal(torch.signbit(a) & ~a.isnan(), torch.signbit(b) & ~b.isnan())))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", help="also write the full record to this JSON file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 1

    import metrics_tpu_torch as M
    from metrics_tpu_torch.kernels import _common
    from metrics_tpu_torch.kernels.binned_counts import (
        _label_score_histograms_onevsrest,
        _onevsrest_torch,
        histogram_plan,
        label_score_histograms_cuda,
        label_score_histograms_torch,
    )
    from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_cuda, confmat_counts_torch
    from metrics_tpu_torch.kernels.segment_scatter import (
        segment_scatter_add_cuda,
        segment_scatter_add_torch,
        segment_scatter_max_cuda,
        segment_scatter_max_torch,
        segment_scatter_min_cuda,
        segment_scatter_min_torch,
        vector_width,
    )
    from metrics_tpu_torch.kernels.stat_scores import stat_scores_counts_cuda, stat_scores_counts_torch
    from metrics_tpu_torch.utilities.checks import _input_format_classification

    record = {}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
          f"capability {torch.cuda.get_device_capability(0)}")
    record["card"] = card

    # -- 1. build --------------------------------------------------------
    start = time.perf_counter()
    lib_path, log = _common.build_library()
    build_s = time.perf_counter() - start
    print(f"[build] {lib_path.name} in {build_s:.2f} s")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")
    record["build_s"] = build_s
    dev = torch.device("cuda", 0)

    # -- 2. kernel vs plain on the card --------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    errors = {"stat_scores_counts": 0, "confmat_counts": 0}
    parity = []
    for n, c in [(1024, 1000), (1, 1), (1023, 129), (4096, 2048)]:
        preds = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        target = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        got = stat_scores_counts_cuda(preds, target, device=dev)
        torch.cuda.synchronize()
        want = stat_scores_counts_torch(preds, target)
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        ok = all(torch.equal(g, w) and g.dtype == torch.int32 for g, w in zip(got, want))
        errors["stat_scores_counts"] = max(errors["stat_scores_counts"], err)
        parity.append({"kernel": "stat_scores_counts", "shape": [n, c], "equal": ok})
        print(f"[parity] stat_scores_counts N={n} C={c}: {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fail(f"stat_scores_counts differs from its plain version at N={n}, C={c}")
    for n, c, dtype, low, high in [
        (1024, 1000, torch.int64, 0, 1000), (1024, 3, torch.int64, 0, 3), (1024, 64, torch.int64, 0, 64),
        (1, 1000, torch.int64, 0, 1000), (4099, 64, torch.int32, 0, 64),
        (4099, 1000, torch.int32, -2, 1002),  # out-of-range pairs are dropped by both
    ]:
        preds = torch.randint(low, high, (n,), generator=gen, device=dev, dtype=dtype)
        target = torch.randint(low, high, (n,), generator=gen, device=dev, dtype=dtype)
        got = confmat_counts_cuda(preds, target, c, device=dev)
        torch.cuda.synchronize()
        want = confmat_counts_torch(preds, target, c)
        err = int((got.long() - want.long()).abs().max())
        ok = torch.equal(got, want) and got.dtype == torch.int32
        errors["confmat_counts"] = max(errors["confmat_counts"], err)
        parity.append({"kernel": "confmat_counts", "n": n, "num_classes": c, "dtype": str(dtype),
                       "labels": [low, high], "equal": ok})
        print(f"[parity] confmat_counts N={n} C={c} {dtype} labels in [{low}, {high}): "
              f"{'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fail(f"confmat_counts differs from its plain version at N={n}, C={c}")
    # the batched forms: B1's short-slice layout (the keyed rows' stack, past
    # the z form's 65,535 slices, a mid shape, empty slices) and its z form;
    # B2's batched entry on both sides of the 48 KB line and of the shared
    # route's limit (C = 241), with out-of-range pairs, int32 and int64
    from metrics_tpu_torch.kernels.confusion_matrix import confmat_counts_batched_cuda, confmat_counts_batched_torch

    errors.update(stat_scores_counts_batched=0, confmat_counts_batched=0)
    for b, n, c in [(KEYED_ROWS, 1, KEYED_CLASSES), (70_000, 1, 3), (3, 5, 1000), (5, 0, 7), (20, 1024, 1000)]:
        preds, target = (torch.randint(0, 3, (b, n, c), generator=gen, device=dev, dtype=torch.int32) for _ in range(2))
        got = stat_scores_counts_cuda(preds, target, device=dev)
        torch.cuda.synchronize()
        want = stat_scores_counts_torch(preds, target)
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        ok = all(torch.equal(g, w) and g.dtype == torch.int32 for g, w in zip(got, want))
        errors["stat_scores_counts_batched"] = max(errors["stat_scores_counts_batched"], err)
        parity.append({"kernel": "stat_scores_counts_batched", "shape": [b, n, c], "equal": ok})
        print(f"[parity] stat_scores_counts batched B={b} N={n} C={c}: {'equal' if ok else 'DIFFERENT'}")
        if not ok:
            fail(f"stat_scores_counts' batched form differs from its plain version at ({b}, {n}, {c})")
    for b, n, c in [(2 * CKPT_TENANTS, 1, CKPT_CLASSES), (CKPT_FLIGHT_ROWS, 1, CKPT_CLASSES), (40, 3, 110),
                    (40, 3, 111), (5, 20, 241), (5, 20, 242), (BOOTSTRAPS, BATCH, NUM_CLASSES)]:
        for dtype in (torch.int64, torch.int32):
            preds, target = (torch.randint(-1, c + 1, (b, n), generator=gen, device=dev, dtype=dtype)
                             for _ in range(2))
            got = confmat_counts_batched_cuda(preds, target, c, device=dev)
            torch.cuda.synchronize()
            want = confmat_counts_batched_torch(preds, target, c)
            err = int((got.long() - want.long()).abs().max())
            ok = torch.equal(got, want) and got.dtype == torch.int32
            errors["confmat_counts_batched"] = max(errors["confmat_counts_batched"], err)
            parity.append({"kernel": "confmat_counts_batched", "shape": [b, n, c], "dtype": str(dtype), "equal": ok})
            print(f"[parity] confmat_counts batched B={b} N={n} C={c} {dtype}, labels in [-1, C]: "
                  f"{'equal' if ok else 'DIFFERENT'}")
            if not ok:
                fail(f"confmat_counts' batched form differs from its plain version at ({b}, {n}), C={c}")

    scatter = {"segment_scatter_add": (segment_scatter_add_cuda, segment_scatter_add_torch),
               "segment_scatter_max": (segment_scatter_max_cuda, segment_scatter_max_torch),
               "segment_scatter_min": (segment_scatter_min_cuda, segment_scatter_min_torch)}
    # the keyed path's shapes at every vector width B3 takes, ragged shapes;
    # each with int64 and int32 ids, and rows 16-, 4- and 8-byte aligned
    scatter_cases = [(KEYED_ROWS, KEYED_TENANTS, d) for d in (40, 8, 6, 4, 2, 1)] + [
        (1, 1, 1), (4099, 100_000, 3), (300, 64, 16)]
    for op, (kernel, plain) in scatter.items():
        errors[op] = 0.0
        for r, s, d in scatter_cases:
            widths = set()
            for ids_dtype in (torch.int64, torch.int32):
                for offset in (0, 1, 2):
                    rows, ids = scatter_inputs(torch, gen, dev, r, s, d, ids_dtype=ids_dtype, offset=offset)
                    got = kernel(rows, ids, s, device=dev)
                    torch.cuda.synchronize()
                    want = plain(rows, ids, s)
                    ok = all(same_bits(g, w) for g, w in zip(got, want))
                    width = vector_width(d, rows.data_ptr() | got[0].data_ptr()) if op == "segment_scatter_add" else 1
                    widths.add(width)
                    parity.append({"kernel": op, "shape": [r, s, d], "rows": "integer-valued", "ids": str(ids_dtype),
                                   "row_offset_bytes": 4 * offset, "vector_width": width, "equal": ok})
                    if not ok:
                        fail(f"{op} differs from its plain version at R={r}, S={s}, D={d}, {ids_dtype} ids, rows "
                             f"{4 * offset} bytes into their buffer")
            print(f"[parity] {op} R={r} S={s} D={d} integer-valued rows, invalid ids; int64 and int32 ids, rows at "
                  f"byte offsets 0, 4 and 8 (vector widths {sorted(widths)}): equal")
        if op == "segment_scatter_add":
            rows, ids = scatter_inputs(torch, gen, dev, KEYED_ROWS, KEYED_TENANTS, 40, floats=True)
            first, counts = kernel(rows, ids, KEYED_TENANTS, device=dev)
            second, _ = kernel(rows, ids, KEYED_TENANTS, device=dev)
            want, want_counts = plain(rows, ids, KEYED_TENANTS)
            torch.cuda.synchronize()
            err = float((first - want).abs().max())
            rerun = float((first - second).abs().max())
            ok = torch.allclose(first, want, rtol=1e-5, atol=1e-5) and torch.equal(counts, want_counts)
            errors[op] = max(errors[op], err)
            parity.append({"kernel": op, "shape": [KEYED_ROWS, KEYED_TENANTS, 40], "rows": "float",
                           "max_abs_err": err, "run_to_run_max_abs_diff": rerun, "equal": ok})
            print(f"[parity] {op} R={KEYED_ROWS} S={KEYED_TENANTS} D=40 float rows: max |kernel - plain| {err:.3e} "
                  f"(rtol=atol=1e-5), run-to-run max |diff| {rerun:.3e}")
            if not ok:
                fail(f"{op} float sums differ from the plain version beyond the tolerance")
        else:
            rows, ids, s = special_rows(torch, dev)
            got = kernel(rows, ids, s, device=dev)
            torch.cuda.synchronize()
            ok = all(same_bits(g, w) for g, w in zip(got, plain(rows, ids, s)))
            parity.append({"kernel": op, "rows": "NaN, +-0.0, +-inf, invalid ids", "equal": ok})
            print(f"[parity] {op} NaN, +-0.0 and +-inf rows, empty segments: {'equal' if ok else 'DIFFERENT'}")
            if not ok:
                fail(f"{op} differs from its plain version on NaN, signed-zero or infinite rows")

    # B5: kernel == plain on the card == plain on the CPU, bit for bit
    errors["label_score_histograms"] = 0.0
    hist_cases = []
    for n, c, b in [(BATCH, NUM_CLASSES, NUM_BINS), (STREAM_CHUNK, 1, NUM_BINS), (1, 3, 4096), (7, 3, 4096),
                    (1023, 3, 4096)]:
        scores = torch.rand((n, c), generator=gen, device=dev)
        labels = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        hist_cases.append((f"N={n} C={c} B={b} uniform scores", scores, labels, b, 0.0, 1.0))
    for b, lo, hi in [(NUM_BINS, 0.0, 1.0), (1000, 0.0, 1.0), (4096, 0.1, 0.7)]:
        scores = edge_scores(torch, dev, b, lo, hi).reshape(-1, 1)
        labels = (torch.arange(scores.shape[0], device=dev) % 2).int().reshape(-1, 1)
        hist_cases.append((f"every edge of B={b} over ({lo}, {hi}) with neighbours, NaN, +-inf, subnormals",
                           scores, labels, b, lo, hi))
    scores = torch.randn((4096, 3), generator=gen, device=dev) * 3
    scores[::101] = float("nan")
    scores[1::103] = float("inf")
    hist_cases.append(("N=4096 C=3 B=32 over (-2, 2), out of range, NaN, inf", scores,
                       torch.randint(0, 2, (4096, 3), generator=gen, device=dev), 32, -2.0, 2.0))
    hist_cases.append(("N=1024 C=1000 B=2048 bf16 scores, float32 targets",
                       torch.rand((BATCH, NUM_CLASSES), generator=gen, device=dev).bfloat16(),
                       torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=dev).float(), NUM_BINS, 0.0,
                       1.0))
    # ragged last tiles, one row, many chunks times tiles, a grid too wide for
    # shared memory, one hot bin; scores 4 and 8 bytes into their buffer
    for n, c, b in [(300, 7, NUM_BINS), (64, 1001, NUM_BINS), (1, NUM_CLASSES, NUM_BINS), (1, 1, NUM_BINS),
                    (100_000, 10, NUM_BINS), (16, 4, 65536)]:
        scores = torch.rand((n, c), generator=gen, device=dev)
        labels = torch.randint(0, 2, (n, c), generator=gen, device=dev, dtype=torch.int32)
        hist_cases.append((f"N={n} C={c} B={b} uniform scores", scores, labels, b, 0.0, 1.0))
    hist_cases.append((f"N={BATCH} C={NUM_CLASSES} B={NUM_BINS} all scores equal",
                       torch.full((BATCH, NUM_CLASSES), 0.25, device=dev),
                       torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=dev, dtype=torch.int32),
                       NUM_BINS, 0.0, 1.0))
    for offset in (1, 2):
        buf = torch.rand(BATCH * NUM_CLASSES + offset, generator=gen, device=dev)
        hist_cases.append((f"N={BATCH} C={NUM_CLASSES} B={NUM_BINS} scores {4 * offset} bytes into their buffer",
                           buf[offset:].view(BATCH, NUM_CLASSES),
                           torch.randint(0, 2, (BATCH, NUM_CLASSES), generator=gen, device=dev, dtype=torch.int32),
                           NUM_BINS, 0.0, 1.0))
    # the labels as one class id per row (ids outside [0, C) among them)
    for n, c, b, ids_dtype in [(BATCH, NUM_CLASSES, NUM_BINS, torch.int64), (BATCH, NUM_CLASSES, NUM_BINS, torch.int32),
                               (848, NUM_CLASSES, NUM_BINS, torch.int64), (64, 1001, NUM_BINS, torch.int32),
                               (100_000, 10, NUM_BINS, torch.int64), (300, 7, NUM_BINS, torch.int32),
                               (16, 4, 65536, torch.int64)]:
        scores = torch.rand((n, c), generator=gen, device=dev) * 1.2 - 0.1
        ids = torch.randint(-1, c + 1, (n,), generator=gen, device=dev).to(ids_dtype)
        hist_cases.append((f"N={n} C={c} B={b} class ids {ids_dtype}, some outside [0, C)", scores, ids, b, 0.0, 1.0))
    for label, scores, labels, b, lo, hi in hist_cases:
        if labels.ndim == 1:  # class ids against the one-hot of the ids
            kernel, plain = _label_score_histograms_onevsrest, _onevsrest_torch
        else:
            kernel = (lambda *a: label_score_histograms_cuda(*a, device=dev))
            plain = label_score_histograms_torch
        before = _common.launch_count("label_score_histograms")
        got = kernel(scores, labels, b, lo, hi)
        torch.cuda.synchronize()
        if _common.launch_count("label_score_histograms") != before + 1:
            fail(f"label_score_histograms did not count one launch: {label}")
        want = plain(scores, labels, b, lo, hi)
        want_cpu = plain(scores.cpu(), labels.cpu(), b, lo, hi)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = trees_equal(torch, got, want_cpu) and all(torch.equal(g, w) for g, w in zip(got, want))
        errors["label_score_histograms"] = max(errors["label_score_histograms"], err)
        parity.append({"kernel": "label_score_histograms", "case": label, "equal": ok, "max_abs_err": err,
                       "clipped": float(got[2])})
        plan = histogram_plan(scores.shape[0], scores.shape[1], b, _common.sm_count(dev))
        mode = ("store", "add", "global")[plan.mode]
        print(f"[parity] label_score_histograms {label}: {'equal' if ok else 'DIFFERENT'} "
              f"(kernel == plain on the card == plain on the CPU; clipped {float(got[2]):.0f}; {mode}, "
              f"{plan.tiles} tiles of {plan.k} x {plan.chunks} chunks)")
        if not ok:
            fail(f"label_score_histograms differs from its plain version: {label}")
    errors["label_score_histograms_batched"] = hist_batched_parity(torch, dev, gen, parity)
    record["parity"] = parity

    # -- 2b. each kernel captured into a CUDA graph and replayed ------------------
    record["graph_probe"] = graph_probe(torch, dev)

    # -- 3. the main path -------------------------------------------------
    batches = make_batches(torch, dev)
    if len(batches) != 49 or batches[-1][0].shape[0] != 848:
        fail("the epoch is not 48 batches of 1024 and one of 848")
    gpu = build_collection(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    step_ms = []
    for preds, target in batches:
        start = time.perf_counter()
        gpu(preds, target)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    gpu_out = gpu.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - start) * 1e3
    launches = {op: _common.launch_count(op) for op in ("stat_scores_counts", "confmat_counts")}
    print(f"[main] 49 forward + compute on {kind}: launches {launches}; forward median "
          f"{statistics.median(step_ms):.3f} ms (first {step_ms[0]:.3f} ms), compute {compute_ms:.3f} ms")
    for op, count in launches.items():
        if count != len(batches):
            fail(f"{op} launched {count} times on the main path, expected {len(batches)}")

    cpu = build_collection(M, "cpu")
    for preds, target in batches:
        cpu(preds.cpu(), target.cpu())
    cpu_out = cpu.compute()
    diffs = {}
    for name, value in gpu_out.items():
        got, want = value.cpu(), cpu_out[name]
        if got.shape != want.shape or got.dtype != want.dtype or not torch.isfinite(got.float()).all():
            fail(f"{name}: {tuple(got.shape)} {got.dtype} on the card against {tuple(want.shape)} {want.dtype}")
        if name == "ConfusionMatrix":
            if not torch.equal(got, want):
                fail("the confusion matrix on the card differs from the CPU's")
            diffs[name] = 0.0
        else:
            diffs[name] = float((got - want).abs().max())
            if diffs[name] > 1e-6:
                fail(f"{name}: {got.item()} on the card, {want.item()} on the CPU")
    confmat = gpu_out["ConfusionMatrix"]
    if int(confmat.sum()) != NUM_SAMPLES:
        fail("the confusion matrix does not count every sample once")
    top1 = float(confmat.diagonal().sum()) / NUM_SAMPLES
    if abs(top1 - float(gpu_out["Accuracy"])) > 1e-6:
        fail(f"Accuracy {float(gpu_out['Accuracy'])} disagrees with the confusion matrix's {top1}")
    values = {k: float(v) for k, v in gpu_out.items() if v.ndim == 0}
    print(f"[main] card == CPU (max |diff| {diffs}); values {values}")
    main_telemetry = check_telemetry("main", [(n, gpu[n], cpu[n]) for n in gpu.keys(keep_base=True)])
    record["main"] = {"launches": launches, "forward_ms": step_ms, "compute_ms": compute_ms,
                      "values": values, "max_abs_diff_vs_cpu": diffs, "telemetry": main_telemetry}

    # where a forward's time goes: device busy share over 10 steady forwards
    from torch.profiler import ProfilerActivity, profile

    probe = build_collection(M, dev)
    probe(*batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for preds, target in batches[1:11]:
            probe(preds, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms = _device_us(prof) / 1e3
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:10]
    breakdown = [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total} for e in top]
    print(f"[main] 10 forwards under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for row in breakdown:
        print(f"[main]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["main"]["profile"] = {"forwards": 10, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                 "top_device": breakdown}

    # -- 3b. the keyed path ------------------------------------------------------
    keyed_batches = make_keyed_batches(torch, dev)
    real_rows = (KEYED_UPDATES - 1) * KEYED_ROWS + KEYED_LAST_REAL
    keyed_gpu = build_keyed(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    update_ms = []
    for ids, preds, target in keyed_batches:
        start = time.perf_counter()
        keyed_gpu.update(ids, preds, target)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    keyed_out = keyed_gpu.compute()
    torch.cuda.synchronize()
    keyed_compute_ms = (time.perf_counter() - start) * 1e3
    keyed_ops = ("segment_merge", "segment_scatter_add", "segment_scatter_max", "segment_scatter_min",
                 "stat_scores_counts", "confmat_counts")
    keyed_launches = {op: _common.launch_count(op) for op in keyed_ops}
    print(f"[keyed] {KEYED_UPDATES} update of {KEYED_ROWS} rows into {KEYED_TENANTS} tenants + compute on {kind}: "
          f"launches {keyed_launches}; update median {statistics.median(update_ms):.3f} ms "
          f"(first {update_ms[0]:.3f} ms), compute {keyed_compute_ms:.3f} ms")
    # B1 once an update: the macro bundle's (4096, 1, 10) stack of rows
    expected = {"segment_merge": KEYED_UPDATES, "segment_scatter_add": 0, "segment_scatter_max": 0,
                "segment_scatter_min": 0, "stat_scores_counts": KEYED_UPDATES, "confmat_counts": 0}
    for op, count in expected.items():
        if keyed_launches[op] != count:
            fail(f"{op} launched {keyed_launches[op]} times on the keyed path, expected {count}")
    if keyed_gpu.state_bundles != 2:
        fail(f"the keyed collection holds {keyed_gpu.state_bundles} state bundles, expected 2")
    acc = keyed_gpu._keyed["Accuracy"]
    counted = int((acc.tp.long() + acc.fn.long()).sum())
    if counted != real_rows:
        fail(f"the Accuracy bundle counts {counted} rows, expected the {real_rows} real rows")

    keyed_cpu = build_keyed(M, "cpu")
    for ids, preds, target in keyed_batches:
        keyed_cpu.update(ids.cpu(), preds.cpu(), target.cpu())
    cpu_out = keyed_cpu.compute()
    for owner, km in keyed_gpu._keyed.items():
        for name, value in km._get_states().items():
            want = getattr(keyed_cpu._keyed[owner], name)
            if value.dtype != want.dtype or not torch.equal(value.cpu(), want):
                fail(f"keyed state {owner}.{name} on the card differs from the CPU's")
    keyed_diffs = {}
    for name, value in keyed_out.items():
        got, want = value.cpu(), cpu_out[name]
        if got.shape != (KEYED_TENANTS,) or got.dtype != want.dtype or not torch.equal(got.isnan(), want.isnan()):
            fail(f"keyed {name}: {tuple(got.shape)} {got.dtype} on the card, NaN where the CPU's is not, or the reverse")
        keyed_diffs[name] = float(torch.nan_to_num(got - want).abs().max())
        if keyed_diffs[name] > 1e-6:
            fail(f"keyed {name} differs from the CPU's by {keyed_diffs[name]}")
    means = {name: float(value[~value.isnan()].mean()) for name, value in keyed_out.items()}
    print(f"[keyed] card == CPU (states exact; values max |diff| {keyed_diffs}); tp + fn over tenants = "
          f"{counted} real rows; tenant means {means}")
    keyed_pairs = [("MultiTenantCollection", keyed_gpu, keyed_cpu),
                   ("MetricCollection", keyed_gpu._collection, keyed_cpu._collection)]
    keyed_pairs += [(f"KeyedMetric[{o}]", km, keyed_cpu._keyed[o]) for o, km in keyed_gpu._keyed.items()]
    keyed_telemetry = check_telemetry("keyed", keyed_pairs)
    invalid = keyed_telemetry["MultiTenantCollection"].get("invalid_tenant_ids")
    if invalid != KEYED_ROWS - KEYED_LAST_REAL:
        fail(f"the keyed collection counts {invalid} invalid tenant ids, expected the "
             f"{KEYED_ROWS - KEYED_LAST_REAL} pad rows")
    record["keyed"] = {"launches": keyed_launches, "update_ms": update_ms, "compute_ms": keyed_compute_ms,
                       "real_rows": counted, "tenant_means": means, "max_abs_diff_vs_cpu": keyed_diffs,
                       "telemetry": keyed_telemetry}

    probe = build_keyed(M, dev)
    probe.update(*keyed_batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for ids, preds, target in keyed_batches[1:11]:
            probe.update(ids, preds, target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    busy_ms = _device_us(prof) / 1e3
    top = sorted(_device_events(prof), key=lambda e: -e.self_device_time_total)[:10]
    breakdown = [{"name": e.key[:80], "calls": e.count, "device_us": e.self_device_time_total} for e in top]
    print(f"[keyed] 10 updates under the profiler: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for row in breakdown:
        print(f"[keyed]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    record["keyed"]["profile"] = {"updates": 10, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                  "top_device": breakdown}

    # -- 3c. the sketched curve path ------------------------------------------
    all_ops = KERNEL_OPS
    curves_gpu = build_curves(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    curve_update_ms = []
    for preds, target in batches:
        start = time.perf_counter()
        curves_gpu.update(preds, target)
        torch.cuda.synchronize()
        curve_update_ms.append((time.perf_counter() - start) * 1e3)
    start = time.perf_counter()
    curves_out = curves_gpu.compute()
    torch.cuda.synchronize()
    curves_compute_ms = (time.perf_counter() - start) * 1e3
    curve_launches = {op: _common.launch_count(op) for op in all_ops}
    print(f"[curves] 49 update + compute of sketched AUROC + AveragePrecision (C={NUM_CLASSES}, B={NUM_BINS}) on "
          f"{kind}: launches {curve_launches}; update median {statistics.median(curve_update_ms):.3f} ms "
          f"(first {curve_update_ms[0]:.3f} ms), compute {curves_compute_ms:.3f} ms")
    for op, count in curve_launches.items():
        want = 2 * len(batches) if op == "label_score_histograms" else 0
        if count != want:
            fail(f"{op} launched {count} times on the curve path, expected {want}")

    curves_cpu = build_curves(M, "cpu")
    for preds, target in batches:
        curves_cpu.update(preds.cpu(), target.cpu())
    curves_cpu_out = curves_cpu.compute()
    for name in ("AUROC", "AveragePrecision"):
        for state in ("pos_hist", "neg_hist", "sketch_clipped"):
            if not trees_equal(torch, getattr(curves_gpu[name], state), getattr(curves_cpu[name], state)):
                fail(f"sketched state {name}.{state} on the card differs from the CPU's")
    curve_diffs = {name: tree_max_diff(torch, curves_out[name], curves_cpu_out[name]) for name in curves_out}
    if max(curve_diffs.values()) > 1e-6 or not all(bool(torch.isfinite(v).all()) for v in curves_out.values()):
        fail(f"sketched curve values differ from the CPU's by {curve_diffs} or are not finite")
    if curves_out["AveragePrecision"].shape != (NUM_CLASSES,):
        fail(f"AveragePrecision has the shape {tuple(curves_out['AveragePrecision'].shape)}")
    pos_total = float(curves_gpu["AUROC"].pos_hist.sum())
    neg_total = float(curves_gpu["AUROC"].neg_hist.sum())
    if pos_total != NUM_SAMPLES or neg_total != NUM_SAMPLES * (NUM_CLASSES - 1):
        fail(f"the histograms count {pos_total} positives and {neg_total} negatives")
    sketched_auroc = float(curves_out["AUROC"])
    mean_ap = float(curves_out["AveragePrecision"].mean())
    state_bytes = sum(getattr(curves_gpu[n], s).numel() * 4 for n in curves_out
                      for s in ("pos_hist", "neg_hist", "sketch_clipped"))
    print(f"[curves] card == CPU (histograms exact; values max |diff| {curve_diffs}); "
          f"macro AUROC {sketched_auroc:.6f}, "
          f"mean AP {mean_ap:.6f}; sketched state {state_bytes} bytes on the card")
    curve_telemetry = check_telemetry("curves", [(n, curves_gpu[n], curves_cpu[n]) for n in curves_out])
    curve_profile = profile_steps(torch, curves_gpu.update, batches[1:11])
    print(f"[curves] 10 updates under the profiler: wall {curve_profile['wall_ms']:.3f} ms, device busy "
          f"{curve_profile['device_busy_ms']:.3f} ms (idle share "
          f"{1 - curve_profile['device_busy_ms'] / curve_profile['wall_ms']:.3f})")
    for row in curve_profile["top_device"]:
        print(f"[curves]   {row['device_us']:10.1f} us  {row['calls']:4d} x  {row['name']}")
    exact = M.AUROC(num_classes=NUM_CLASSES, compute_on_step=False, device=dev)
    for preds, target in batches:
        exact.update(preds, target)
    start = time.perf_counter()
    exact_auroc = float(exact.compute())
    exact_compute_ms = (time.perf_counter() - start) * 1e3
    del exact
    print(f"[curves] exact list-mode macro AUROC {exact_auroc:.6f} (compute {exact_compute_ms:.1f} ms); "
          f"|sketched - exact| = {abs(sketched_auroc - exact_auroc):.3e}")
    record["curves"] = {"launches": curve_launches, "update_ms": curve_update_ms, "compute_ms": curves_compute_ms,
                        "auroc": sketched_auroc, "mean_ap": mean_ap, "max_abs_diff_vs_cpu": curve_diffs,
                        "state_bytes": state_bytes, "profile": curve_profile, "exact_auroc": exact_auroc,
                        "exact_compute_ms": exact_compute_ms, "sketched_minus_exact": sketched_auroc - exact_auroc,
                        "telemetry": curve_telemetry}

    # -- 3d. the binary scorer stream ----------------------------------------------
    chunks = make_stream(torch, dev)
    stream_gpu = build_stream(M, dev)
    stream_exact = M.AUROC(compute_on_step=False, device=dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    stream_update_ms = []
    for scores, labels in chunks:
        start = time.perf_counter()
        for m in stream_gpu.values():
            m.update(scores, labels)
        torch.cuda.synchronize()
        stream_update_ms.append((time.perf_counter() - start) * 1e3)
        stream_exact.update(scores, labels)
    stream_launches = {op: _common.launch_count(op) for op in all_ops}
    stream_out = {name: m.compute() for name, m in stream_gpu.items()}
    stream_exact_auroc = float(stream_exact.compute())
    print(f"[stream] {STREAM_UPDATES} updates of {STREAM_CHUNK} scores into sketched AUROC + ROC + "
          f"PrecisionRecallCurve on {kind}: launches {stream_launches}; update median (three metrics) "
          f"{statistics.median(stream_update_ms):.3f} ms")
    for op, count in stream_launches.items():
        want = 3 * STREAM_UPDATES if op == "label_score_histograms" else 0
        if count != want:
            fail(f"{op} launched {count} times on the binary stream, expected {want}")
    stream_cpu = build_stream(M, "cpu")
    for scores, labels in chunks:
        for m in stream_cpu.values():
            m.update(scores.cpu(), labels.cpu())
    for name, m in stream_gpu.items():
        for state in ("pos_hist", "neg_hist", "sketch_clipped"):
            if not trees_equal(torch, getattr(m, state), getattr(stream_cpu[name], state)):
                fail(f"sketched state {name}.{state} of the binary stream differs from the CPU's")
    stream_diffs = {name: tree_max_diff(torch, stream_out[name], stream_cpu[name].compute()) for name in stream_out}
    if max(stream_diffs.values()) > 1e-6:
        fail(f"binary stream values differ from the CPU's by {stream_diffs}")
    stream_auroc = float(stream_out["AUROC"])
    gap = abs(stream_auroc - stream_exact_auroc)
    stream_state_bytes = sum(getattr(stream_gpu["AUROC"], s).numel() * 4 for s in ("pos_hist", "neg_hist",
                                                                                    "sketch_clipped"))
    print(f"[stream] card == CPU (states exact; values max |diff| {stream_diffs}); sketched AUROC {stream_auroc:.6f}, "
          f"exact {stream_exact_auroc:.6f}, |diff| {gap:.3e} (limit 5e-3); sketched state {stream_state_bytes} bytes "
          f"per metric, whatever the count of scores (the exact state holds "
          f"{STREAM_UPDATES * STREAM_CHUNK * 12} bytes)")
    if gap > 5e-3:
        fail(f"the sketched AUROC of the binary stream is {gap} from the exact one")
    if stream_state_bytes != 2 * NUM_BINS * 4 + 4:
        fail(f"the sketched state holds {stream_state_bytes} bytes")
    del stream_exact
    stream_telemetry = check_telemetry("stream", [(n, m, stream_cpu[n]) for n, m in stream_gpu.items()])
    record["stream"] = {"launches": stream_launches, "update_ms": stream_update_ms, "auroc": stream_auroc,
                        "exact_auroc": stream_exact_auroc, "max_abs_diff_vs_cpu": stream_diffs,
                        "state_bytes_per_metric": stream_state_bytes, "telemetry": stream_telemetry}

    # -- 3i. the compiled step: CUDA graphs replayed over the metrics' state ------
    record["compiled"] = compiled_phase(torch, M, dev, card)

    # -- 3f. the leftovers, the meter and a composition at full width -----------
    kl_targets = make_kl_targets(torch, dev)
    left_gpu = build_leftovers(M, dev)
    torch.cuda.synchronize()
    _common.reset_dispatch_counters()
    left_ms = []
    for (preds, target), q in zip(batches, kl_targets):
        start = time.perf_counter()
        leftovers_step(left_gpu, preds, target, q)
        torch.cuda.synchronize()
        left_ms.append((time.perf_counter() - start) * 1e3)
    left_out = {name: m.compute() for name, m in left_gpu.items()}
    left_launches = {op: _common.launch_count(op) for op in all_ops}
    left_cpu = build_leftovers(M, "cpu")
    _common.reset_dispatch_counters()
    for (preds, target), q in zip(batches, kl_targets):
        leftovers_step(left_cpu, preds.cpu(), target.cpu(), q.cpu())
    cpu_b1 = _common.dispatch_count("stat_scores_counts", "torch")
    left_diffs = {}
    for name, m in left_cpu.items():
        want = m.compute()
        got = left_out[name].cpu()
        if got.shape != want.shape or got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
            fail(f"[leftovers] {name}: {tuple(got.shape)} {got.dtype} on the card, {tuple(want.shape)} {want.dtype} "
                 "on the CPU, or not finite")
        left_diffs[name] = float((got - want).abs().max())
        if left_diffs[name] > 1e-6:
            fail(f"[leftovers] {name}: {got} on the card, {want} on the CPU")
    print(f"[leftovers] 49 steps of HammingDistance, Hinge (crammer-singer), KLDivergence, AverageMeter forward + "
          f"2PR/(P+R) update at (1024, {NUM_CLASSES}) on {kind}: launches {left_launches}; step median "
          f"{statistics.median(left_ms):.3f} ms (first {left_ms[0]:.3f} ms); card == CPU (max |diff| {left_diffs}); "
          f"values { {k: float(v) for k, v in left_out.items()} }")
    # the expression tree holds P and R twice (in 2 * P * R and in P + R),
    # and each occurrence fans the update out: four B1 launches a step
    if left_launches["stat_scores_counts"] != cpu_b1 or cpu_b1 != 4 * len(batches):
        fail(f"[leftovers] B1 launched {left_launches['stat_scores_counts']} times; the CPU run counts {cpu_b1} "
             f"dispatches, expected {4 * len(batches)}")
    if any(count for op, count in left_launches.items() if op != "stat_scores_counts"):
        fail(f"[leftovers] an unexpected kernel launched: {left_launches}")
    comp_gpu, comp_cpu = left_gpu["F1ofPR"], left_cpu["F1ofPR"]
    left_pairs = [(n, m, left_cpu[n]) for n, m in left_gpu.items()]
    left_pairs += [("F1ofPR.P", comp_gpu.metric_a.metric_a.metric_b, comp_cpu.metric_a.metric_a.metric_b),
                   ("F1ofPR.R", comp_gpu.metric_a.metric_b, comp_cpu.metric_a.metric_b)]
    left_telemetry = check_telemetry("leftovers", left_pairs)
    record["leftovers"] = {"launches": left_launches, "cpu_stat_scores_dispatches": cpu_b1, "step_ms": left_ms,
                           "values": {k: float(v) for k, v in left_out.items()}, "max_abs_diff_vs_cpu": left_diffs,
                           "telemetry": left_telemetry}

    # -- 3g. what telemetry costs on the card ---------------------------------------
    record["telemetry_cost"] = telemetry_cost(torch, M, dev, batches, keyed_batches, card)

    # -- 3e. the epoch-end sync over NCCL --------------------------------------
    record["sync"] = sync_phase(torch, gpu, keyed_gpu, card)

    # -- 3h. the serving plane ----------------------------------------------------
    record["serving"] = {
        "replay": serving_replay(torch, M, dev, keyed_batches, keyed_gpu, keyed_out, statistics.median(update_ms),
                                 card),
        "soak_unstaged": serving_soak(torch, M, dev, False, card),
        "soak_staged": serving_soak(torch, M, dev, True, card),
        "compute_async": compute_async_phase(torch, M, dev, batches, card),
    }

    # -- 3j. the regression slice ---------------------------------------------------
    record["regression"] = regression_phase(torch, M, dev, card, keyed_batches, statistics.median(update_ms))

    # -- 3k. the retrieval slice ----------------------------------------------------
    record["retrieval"] = retrieval_phase(torch, M, dev, card)

    # -- 3l. the small metrics: audio, BLEU, similarity, gradients, bootstrap ---------
    record["small_metrics"] = small_metrics_phase(torch, M, dev, card, batches, keyed_batches)

    # -- 3m. the generative metrics: FID, KID, IS on InceptionV3 ------------------------
    record["generative"] = generative_phase(torch, M, dev, card)

    # -- 3n. the observability plane armed on the main paths ------------------------------
    record["observability"] = observability_phase(torch, M, dev, card, soak=record["serving"]["soak_staged"])

    # -- 3o. durability, resilience and transport -----------------------------------------
    record["durability"] = durability_phase(torch, M, dev, card)

    # -- 3p. the keyed and bootstrapped sketched curves: B5's batched form ---------------
    record["sketched_keyed"] = sketched_keyed_phase(torch, M, dev, card, batches, keyed_batches)

    # -- 3q. the merge: the keyed update's one launch -------------------------------------
    record["merge"] = merge_phase(torch, M, dev, card, keyed_batches)

    # -- 4. times at the main-path shapes ------------------------------------
    preds, target = batches[0]
    canon_p, canon_t, _ = _input_format_classification(preds, target)
    canon_p, canon_t = canon_p.contiguous(), canon_t.contiguous()
    labels_p, labels_t = canon_p.argmax(dim=1), canon_t.argmax(dim=1)
    n, c = canon_p.shape
    flat = labels_t * c + labels_p

    b1_bound = bound(2 * n * c * 4 + 4 * c * 4, 5 * n * c)
    b2_bound = bound(2 * n * 8 + c * c * 4, 6 * n)
    calls = {
        "stat_scores_counts": {
            "ms": lambda: stat_scores_counts_cuda(canon_p, canon_t, device=dev),
            "plain_ms": lambda: stat_scores_counts_torch(canon_p, canon_t),
            "library_ms": None,
        },
        "confmat_counts": {
            "ms": lambda: confmat_counts_cuda(labels_p, labels_t, c, device=dev),
            "plain_ms": lambda: confmat_counts_torch(labels_p, labels_t, c),
            "library_ms": lambda: torch.bincount(flat, minlength=c * c),
        },
    }
    timings = {
        "stat_scores_counts": {"bound": b1_bound, "shape": f"preds, target ({n}, {c}) int32"},
        "confmat_counts": {"bound": b2_bound, "shape": f"preds, target ({n},) int64, C={c}"},
    }
    # B1's batched form at the keyed rows' shape: phase 3b's first cohort in
    # canonical form as the (4096, 1, 10) stack the keyed update's vmap rule
    # hands over (its short-slice layout); no one library call counts it
    rows_p, rows_t, _ = _input_format_classification(keyed_batches[0][1], keyed_batches[0][2])
    rows_p, rows_t = (x.reshape(KEYED_ROWS, 1, KEYED_CLASSES).contiguous() for x in (rows_p, rows_t))
    calls["stat_scores_counts_batched"] = {
        "ms": lambda: stat_scores_counts_cuda(rows_p, rows_t, device=dev),
        "plain_ms": lambda: stat_scores_counts_torch(rows_p, rows_t),
        "library_ms": None,
    }
    row_cells = KEYED_ROWS * KEYED_CLASSES
    timings["stat_scores_counts_batched"] = {"bound": bound(2 * row_cells * 4 + 4 * row_cells * 4, 5 * row_cells),
                                             "shape": f"preds, target ({KEYED_ROWS}, 1, {KEYED_CLASSES}) int32"}
    # the keyed path's shapes: its ids, and rows of 0/1-valued deltas
    s_ = KEYED_TENANTS
    keyed_ids = keyed_batches[0][0]
    safe = torch.where((keyed_ids >= 0) & (keyed_ids < s_), keyed_ids, s_)
    for op, d in (("segment_scatter_add", 40), ("segment_scatter_add_d6", 6), ("segment_scatter_max", 1),
                  ("segment_scatter_min", 1)):
        kernel_op = op.replace("_d6", "")
        kernel, plain = scatter[kernel_op]
        rows = torch.randint(0, 2, (KEYED_ROWS, d), generator=gen, device=dev).float()
        buffer = torch.zeros((s_ + 1, d), device=dev)
        # library_ms: the one call into a buffer allocated once, the safe
        # index made outside the timed region; library_alloc_ms: the same
        # call with its own output (zeros or a -inf/+inf fill of (S+1, D))
        # and the safe index made per call, as a caller pays them (neither
        # counts the rows per segment, as the kernels also do)
        if kernel_op == "segment_scatter_add":
            library = (lambda buffer=buffer, rows=rows: buffer.index_add_(0, safe, rows))

            def library_alloc(rows=rows, d=d):
                ids = torch.where((keyed_ids >= 0) & (keyed_ids < s_), keyed_ids, s_)
                return torch.zeros((s_ + 1, d), device=dev).index_add_(0, ids, rows)
        else:
            index = safe.unsqueeze(1).expand(-1, d).contiguous()
            how = "amax" if kernel_op.endswith("max") else "amin"
            library = (lambda buffer=buffer, index=index, rows=rows, how=how:
                       buffer.scatter_reduce_(0, index, rows, how, include_self=True))

            def library_alloc(rows=rows, d=d, how=how):
                ids = torch.where((keyed_ids >= 0) & (keyed_ids < s_), keyed_ids, s_)
                out = torch.full((s_ + 1, d), float("-inf") if how == "amax" else float("inf"), device=dev)
                return out.scatter_reduce_(0, ids.unsqueeze(1).expand(-1, d), rows, how, include_self=True)
        nbytes = KEYED_ROWS * d * 4 + KEYED_ROWS * 8 + s_ * d * 4 + s_ * 4
        calls[op] = {
            "ms": lambda kernel=kernel, rows=rows: kernel(rows, keyed_ids, s_, device=dev),
            "plain_ms": lambda plain=plain, rows=rows: plain(rows, keyed_ids, s_),
            "library_ms": library,
            "library_alloc_ms": library_alloc,
        }
        timings[op] = {"bound": bound(nbytes, KEYED_ROWS * d), "shape": f"rows ({KEYED_ROWS}, {d}) float32, ids "
                       f"({KEYED_ROWS},) int64, S={s_}"}
    # B5 at the curve path's shape (one ImageNet-1k batch, one-hot int32
    # targets, as AUROC/AveragePrecision hand it over) and at the binary
    # stream's; the library call counts the flat (label, class, bin) index,
    # computed outside the timed region: no bucketize, no NaN rule, no
    # clipped count
    from metrics_tpu_torch.kernels.binned_counts import _bin_index

    # "label_score_histograms" is the form the curve path launches: the
    # (N,) class ids of the batch (it reads N * C * 4 bytes of labels less
    # than the dense form, "_dense", which the multilabel case still takes)
    class_ids = batches[0][1]
    onehot = (class_ids.unsqueeze(1) == torch.arange(NUM_CLASSES, device=dev)).to(torch.int32)
    for op, scores, labels in (("label_score_histograms", batches[0][0], class_ids),
                               ("label_score_histograms_dense", batches[0][0], onehot),
                               ("label_score_histograms_c1", chunks[0][0].reshape(-1, 1),
                                chunks[0][1].reshape(-1, 1).to(torch.int32))):
        n, c = scores.shape
        cells = c * NUM_BINS
        dense = labels.ndim == 2
        positive = labels == 1 if dense else labels.unsqueeze(1) == torch.arange(c, device=dev)
        flat = (torch.where(positive, 0, cells) + torch.arange(c, device=dev) * NUM_BINS
                + _bin_index(scores, NUM_BINS, 0.0, 1.0)).reshape(-1)
        if dense:
            kernel = (lambda scores=scores, labels=labels: label_score_histograms_cuda(scores, labels, NUM_BINS,
                                                                                       device=dev))
            plain = (lambda scores=scores, labels=labels: label_score_histograms_torch(scores, labels, NUM_BINS))
        else:
            kernel = (lambda scores=scores, labels=labels: _label_score_histograms_onevsrest(scores, labels,
                                                                                             NUM_BINS))
            plain = (lambda scores=scores, labels=labels: _onevsrest_torch(scores, labels, NUM_BINS))
        calls[op] = {"ms": kernel, "plain_ms": plain,
                     "library_ms": lambda flat=flat, cells=cells: torch.bincount(flat, minlength=2 * cells)}
        label_bytes = n * c * 4 if dense else n * labels.element_size()
        timings[op] = {"bound": bound(n * c * 4 + label_bytes + 2 * cells * 4 + 4, 4 * n * c),
                       "shape": f"scores ({n}, {c}) float32, "
                                + (f"targets ({n}, {c}) int32" if dense else f"class ids ({n},) {labels.dtype}")
                                + f", B={NUM_BINS}"}
    for op, fns in calls.items():
        t = timings[op]
        for key, fn in fns.items():
            t[key] = None if fn is None else cuda_ms(fn)
            t[key.replace("ms", "device_ms")] = None if fn is None else device_ms(fn)
        # the kernel's device time with the launch cost amortized: 50 calls in one replayed graph
        t["graph_ms"] = graph_ms(fns["ms"])

    def fmt(ms):
        return "none" if ms is None else f"{ms:.4f} ms"

    for op, t in timings.items():
        print(f"[time] {op} at {t['shape']}, per call (device only): kernel {fmt(t['ms'])} "
              f"({fmt(t['device_ms'])}; in a replayed graph of 50 calls {fmt(t['graph_ms'])}), "
              f"plain {fmt(t['plain_ms'])} ({fmt(t['plain_device_ms'])}), "
              f"library {fmt(t['library_ms'])} ({fmt(t['library_device_ms'])}), "
              f"library with its own output {fmt(t.get('library_alloc_ms'))} "
              f"({fmt(t.get('library_alloc_device_ms'))}), bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
    # the device time of B1, B2 and B5 by device operation: the wrappers'
    # fills and memsets apart from their kernels
    splits = {op: device_split(calls[op]["ms"]) for op in ("stat_scores_counts", "stat_scores_counts_batched",
                                                           "confmat_counts",
                                                           "label_score_histograms", "label_score_histograms_dense",
                                                           "label_score_histograms_c1")}
    for op, split in splits.items():
        parts = "; ".join(f"{us:.3f} us {name}" for name, us in sorted(split.items(), key=lambda kv: -kv[1]))
        print(f"[time] {op} device time by operation, per call: {sum(split.values()):.3f} us = {parts}")
        timings[op]["device_split_us"] = split
    # the same scores 4 bytes into a buffer: the kernel then takes 4-byte loads in place of 16-byte ones
    shifted = torch.empty(BATCH * NUM_CLASSES + 1, device=dev)[1:].view(BATCH, NUM_CLASSES).copy_(batches[0][0])
    for op, labels, kernel in (("label_score_histograms", class_ids, _label_score_histograms_onevsrest),
                               ("label_score_histograms_dense", onehot,
                                lambda *a: label_score_histograms_cuda(*a, device=dev))):
        split = device_split(lambda: kernel(shifted, labels, NUM_BINS))
        print(f"[time] {op} with 4-byte loads (scores 4 bytes into their buffer), device time per call: "
              f"{sum(split.values()):.3f} us against {sum(splits[op].values()):.3f} us with 16-byte loads")
        timings[op]["device_scalar_loads_us"] = sum(split.values())
    # the floor under B5's byte bound at the stream's shape: an empty kernel
    empty = _common.kernel_function("empty_kernel_launch", (ctypes.c_int, ctypes.c_void_p))
    raw_stream = _common.current_stream_handle(dev)
    empty_device_ms = device_ms(lambda: _common.check_launch("empty_kernel", empty(dev.index, raw_stream)))
    print(f"[time] an empty kernel's device time, the floor under label_score_histograms_c1's byte bound of "
          f"{timings['label_score_histograms_c1']['bound'][0]:.5f} ms: {fmt(empty_device_ms)}")
    record["empty_kernel_device_ms"] = empty_device_ms
    record["timings"] = timings
    # what the CUDA-event wrapper time counts when nothing runs between the
    # two events: a floor under every "ms" above
    floor_ms = cuda_ms(lambda: None)
    print(f"[time] CUDA-event floor (nothing between the two events): {fmt(floor_ms)}")
    record["cuda_event_floor_ms"] = floor_ms
    # where a B3/B4 wrapper call's host time goes, piece by piece
    pieces = host_us(scatter_host_pieces(torch, dev, keyed_ids))
    for name, us in pieces.items():
        print(f"[host] {us:8.3f} us per call  {name}")
    record["scatter_host_pieces_us"] = pieces
    # and a B5 wrapper call's
    pieces = host_us(hist_host_pieces(torch, dev, batches[0][0], onehot, class_ids))
    for name, us in pieces.items():
        print(f"[host] {us:8.3f} us per call  B5: {name}")
    record["hist_host_pieces_us"] = pieces

    # -- 5. report -------------------------------------------------------
    sources = {"stat_scores_counts": "metrics_tpu_torch/csrc/stat_scores.cu",
               "confmat_counts": "metrics_tpu_torch/csrc/confusion_matrix.cu",
               "segment_scatter_add": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "segment_scatter_max": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "segment_scatter_min": "metrics_tpu_torch/csrc/segment_scatter.cu",
               "label_score_histograms": "metrics_tpu_torch/csrc/binned_counts.cu"}
    replaces = {"stat_scores_counts": "metrics_tpu/kernels/stat_scores.py:73",
                "confmat_counts": "metrics_tpu/kernels/confusion_matrix.py:45",
                "segment_scatter_add": "metrics_tpu/kernels/segment_scatter.py:93",
                "segment_scatter_max": "metrics_tpu/kernels/segment_scatter.py:227",
                "segment_scatter_min": "metrics_tpu/kernels/segment_scatter.py:227",
                "label_score_histograms": "metrics_tpu/kernels/binned_counts.py:81"}
    # launches on each kernel's own path: the ImageNet-1k collection for B1
    # and B2, the keyed collection for B3 and B4 (where the merge took their
    # place: none; B3 and B4 are held against their plain versions in
    # phases 2 and 2b), the sketched curve collection for B5 (the binary
    # stream's 300 are in the record); times at each path's shape
    path_launches = {**launches, **{op: keyed_launches[op] for op in scatter},
                     "label_score_histograms": curve_launches["label_score_histograms"]}
    # launches counted through the replays of the compiled step (phase 3i)
    compiled = record["compiled"]
    compiled_launches = {op: compiled["collection"]["launches"][op] + compiled["keyed"]["launches"][op]
                         + compiled["curves"]["launches"][op] for op in (*sources, "segment_merge")}
    kernels = [
        {"name": op, "route": "cuda", "source": sources[op], "replaces": replaces[op],
         "launches": path_launches[op], "max_abs_err": errors[op], "ms": timings[op]["ms"],
         "plain_ms": timings[op]["plain_ms"], "bound_ms": timings[op]["bound"][0],
         "bound_by": timings[op]["bound"][1], "library_ms": timings[op]["library_ms"],
         "library_alloc_ms": timings[op].get("library_alloc_ms"), "device_ms": timings[op]["device_ms"],
         "plain_device_ms": timings[op]["plain_device_ms"], "library_device_ms": timings[op]["library_device_ms"],
         "library_alloc_device_ms": timings[op].get("library_alloc_device_ms"),
         "graph_ms": timings[op]["graph_ms"], "compiled_launches": compiled_launches[op]}
        for op in sources
    ]
    # B5's entry is the class-id form at the curve path's shape (its 98
    # launches); the dense form at that shape and the binary stream's shape
    # (300 launches there) ride along
    for suffix in ("dense", "c1"):
        t = timings[f"label_score_histograms_{suffix}"]
        kernels[-1].update({f"{suffix}_ms": t["ms"], f"{suffix}_device_ms": t["device_ms"],
                            f"{suffix}_library_device_ms": t["library_device_ms"],
                            f"{suffix}_graph_ms": t["graph_ms"],
                            f"{suffix}_plain_ms": t["plain_ms"], f"{suffix}_bound_ms": t["bound"][0],
                            f"{suffix}_library_ms": t["library_ms"]})
    kernels[-1]["c1_launches"] = stream_launches["label_score_histograms"]
    # the merge (phase 3q) at phase 3b's leaves, beside the per-leaf chain
    # through B3 and B4 it replaced; its launches on the keyed paths
    t = record["merge"]["times"]
    merge = {
        "name": "segment_merge", "route": "cuda", "source": sources["segment_scatter_add"],
        "replaces": "none: the keyed update's per-leaf chain around B3 and B4 (one XLA program in the JAX package)",
        "launches": keyed_launches["segment_merge"], "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None, "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"], "graph_ms": t["graph_ms"], "chain_ms": t["chain_ms"],
        "chain_device_ms": t["chain_device_ms"], "chain_graph_ms": t["chain_graph_ms"], "host_us": t["host_us"],
        "compiled_launches": compiled_launches["segment_merge"],
    }
    kernels.append(merge)
    # the merge on the serving path too: the replay's paths and the soaks
    serving = record["serving"]
    merge["serving_launches"] = {
        **{f"replay_{path}": serving["replay"][path]["launches"]["segment_merge"]
           for path in ("unstaged", "staged", "prefetched")},
        **{run: serving[run]["launches"]["segment_merge"] for run in ("soak_unstaged", "soak_staged")},
    }
    # on the regression slice's keyed path (phase 3j-b): eager and through the update_many replays
    regression = record["regression"]["keyed"]
    merge["regression_launches"] = {"eager": regression["launches"]["segment_merge"],
                                    "update_many": regression["update_many_launches"],
                                    "plain_scatters": regression["plain_scatters"]}
    # on the retrieval slice's keyed path (phase 3k-d): eager and through the update_many replays
    retrieval = record["retrieval"]["keyed"]
    merge["retrieval_launches"] = {"eager": retrieval["launches"]["segment_merge"],
                                   "update_many": retrieval["update_many_launches"]}
    # B1 under the eager BootStrapper (phase 3l-f) and the merge under the keyed audio collection (phase 3l-b)
    small = record["small_metrics"]
    for entry in kernels:
        if entry["name"] == "stat_scores_counts":
            entry["bootstrap_launches"] = {"eager": small["bootstrap"]["launches"]["stat_scores_counts"],
                                           "pure": small["bootstrap"]["pure_launches"]["stat_scores_counts"]}
            entry["batched"] = small["bootstrap"]["b1_batched"]
    merge["audio_keyed_launches"] = small["speech_keyed"]["launches"]["segment_merge"]
    # B1 and B2 under the armed compiled forward, the merge under the keyed
    # regression with health armed, eager, compiled and through the
    # quarantining queue (phase 3n)
    obs = record["observability"]
    for entry in kernels:
        if entry["name"] in ("stat_scores_counts", "confmat_counts"):
            entry["observability_launches"] = obs["armed"]["launches"][entry["name"]]
    merge["observability_launches"] = {
        "eager": obs["keyed_health"]["eager"]["launches"]["segment_merge"],
        "compiled": obs["keyed_health"]["compiled"]["launches"]["segment_merge"],
        "quarantined_queue": obs["quarantine"]["launches"],
    }
    # the merge on the durability paths (phase 3o), and B2's batched form on
    # the keyed ConfusionMatrix's rows (phase 3o-a)
    dur = record["durability"]
    for entry in kernels:
        if entry["name"] == "confmat_counts":
            entry["durability_launches"] = {"checkpoint": dur["checkpoint"]["launches"]["confmat_counts"]}
            entry["batched"] = dur["checkpoint"]["b2_batched"]
    merge["durability_launches"] = {
        "checkpoint": dur["checkpoint"]["launches"]["segment_merge"],
        "restart_eager": dur["collection"]["eager"]["launches"]["segment_merge"],
        "restart_compiled": dur["collection"]["compiled"]["launches"]["segment_merge"],
        "spill_collection": dur["spill"]["collection"]["launches"]["segment_merge"],
        "chaos": dur["chaos"]["window"]["launches"]["segment_merge"],
    }
    # the batched forms, each an entry of its own: B1's at the keyed rows'
    # shape (its launches those of phase 3b, and through phase 3i's keyed
    # update_many replays), B2's at the keyed ConfusionMatrix's rows (its
    # launches those of phase 3o-a; every stack of 3o-a in "stacks")
    t = timings["stat_scores_counts_batched"]
    kernels.append({
        "name": "stat_scores_counts_batched", "route": "cuda", "source": sources["stat_scores_counts"],
        "replaces": replaces["stat_scores_counts"], "launches": keyed_launches["stat_scores_counts"],
        "max_abs_err": errors["stat_scores_counts_batched"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None, "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"], "graph_ms": t["graph_ms"],
        "compiled_launches": compiled["keyed"]["launches"]["stat_scores_counts"], "shape": t["shape"],
    })
    # B5's batched form at the keyed binary rows' stack, its launches those of
    # phase 3p-a (3p-b, c and d in "path_launches"; every stack of 3p in "stacks")
    sk = record["sketched_keyed"]
    t = sk["timing"]["keyed_binary"]
    kernels.append({
        "name": "label_score_histograms_batched", "route": "cuda", "source": sources["label_score_histograms"],
        "replaces": replaces["label_score_histograms"], "launches": sk["binary"]["launches"]["label_score_histograms"],
        "max_abs_err": errors["label_score_histograms_batched"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"], "plain_device_ms": t["plain_device_ms"],
        "library_device_ms": t["library_device_ms"], "graph_ms": t["graph_ms"],
        "compiled_launches": sk["compiled"]["launches"]["label_score_histograms"], "shape": t["shape"],
        "path_launches": {"keyed_binary": sk["binary"]["launches"]["label_score_histograms"],
                          "keyed_classes": sk["multiclass"]["launches"]["label_score_histograms"],
                          "keyed_binary_update_many": sk["compiled"]["launches"]["label_score_histograms"],
                          "bootstrap_pure": sk["bootstrap"]["launches"]["label_score_histograms"]},
        "stacks": [{k: v for k, v in x.items() if k != "device_split_us"} for x in sk["timing"].values()],
    })
    stacks = dur["checkpoint"]["b2_batched"]
    keyed_stack = stacks[0]
    kernels.append({
        "name": "confmat_counts_batched", "route": "cuda", "source": sources["confmat_counts"],
        "replaces": replaces["confmat_counts"], "launches": dur["checkpoint"]["launches"]["confmat_counts"],
        "max_abs_err": max([errors["confmat_counts_batched"]] + [x["max_abs_err"] for x in stacks]),
        "ms": keyed_stack["ms"], "plain_ms": keyed_stack["plain_ms"], "bound_ms": keyed_stack["bound_ms"],
        "bound_by": keyed_stack["bound_by"], "library_ms": keyed_stack["library_ms"],
        "device_ms": keyed_stack["device_ms"], "plain_device_ms": keyed_stack["plain_device_ms"],
        "library_device_ms": keyed_stack["library_device_ms"], "shape": keyed_stack["shape"], "stacks": stacks,
    })
    record["kernels"] = kernels
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
