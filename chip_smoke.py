"""Drive the PyTorch port on one NVIDIA GPU: build, check, train, score.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Device: a CUDA GPU must be present; prints its name and power limit.
2. Build: compiles every kernel from ``mmlspark_tpu_torch/csrc``
   with ``nvcc -Xptxas -v`` (one process per source, all started
   together; the compiler's registers, shared memory and spills are
   printed): ``node_hist``, ``node_hist_int8``, ``hist_bf16``,
   ``node_hist_det``, ``quant_stats`` and ``lambdarank``, and
   beside them the host C++ engine ``native/mmlspark_native.cpp`` (host
   TreeSHAP, the CSV reader) with the host compiler. Then the
   geometry of kernels 1 and 2 at the main path's two passes, and how many
   of its clusters the card holds at once.
3. Kernel 1, ``node_hist`` (bf16 stats), against its plain version on the
   card, at the main path's shapes: F=28, n=1,000,000 (full-width root
   pass) and n=500,000 (the half-width smaller-child buffer), W in
   {1, 8, 16}, B in {255, 63}, and n=499,999 at W=8, B=255 (rows not a
   multiple of the 16-byte vector: misaligned feature rows and a ragged
   tail); bins int32/int16/uint8, some rows at pos -1. The count channel
   must be bit-equal; grad and hess within rtol 1e-4 / atol 1e-4 of the
   channel's largest magnitude (float atomics sum in another order).
   Times, on the device alone (the card spins while the host enqueues the
   timed calls): the kernel's wrapper (its zero-fill and launch), the
   plain version, and one ``index_add_`` over the flattened segment id as
   a library yardstick (timed here only; the port never calls it). At the
   two main-path rows (int32 bins, B=255: n=1,000,000 W=1 and n=500,000
   W=8) the wrapper is also timed with L2 cold: a 256 MB buffer is written
   before each launch, and each launch is timed alone with events. Then,
   warm and cold, kernel 1 at the shapes of phases 6 and 7 (``PATH_ROWS``,
   int32 bins, B=255): F=54 at n=581,012 (W=1) and n=290,506 (W=8), F=136
   at n=1,280,000 (W=1), on uniform bins, and the two F=54 rows again on
   phase 6's layout of bins (44 one-hot columns, most rows of a column in
   one bin), and at phase 8's shape (``CAT_ROWS``: F=12, 10 continuous
   columns and a 4-id and a 40-id categorical column, n=581,012 at W=1 and
   n=290,506 at W=8).
3b. Kernel 2, ``node_hist_int8`` (int8 stats, int32 sums), against
   ``node_hist_plain(acc_dtype=int32)``: F=28, n=1,000,000 at W=1,
   n=500,000 at W in {8, 15} and n=499,999 at W=8, B in {255, 63} (255
   only at n=499,999), bins int32/uint8, some rows at pos -1.
   ``torch.equal`` is required (integer sums do not depend on order).
   Same times as phase 3, cold at the same two rows; the yardstick on
   int32 values. Then, warm and cold, kernel 2 at phase 8's shape
   (``CAT_ROWS``) and at phase 6's one-hot bins (F=54, n=581,012 at W=1
   and n=290,506 at W=8).
3c. Kernel 3, ``hist_bf16``, through ``histogram_cols`` against
   ``hist_plain``, F=28, at the rows of ``COLS_ROWS``: n=1,000,000 with S
   in {1, 2, 3, 5, 48}, B in {63, 255, 4096}, int32, int16 and uint8 bins,
   ``stats_dtype`` bf16 and f32, and misaligned inputs (every array row
   one element past a 16-byte boundary); n=499,999 (a ragged tail) with
   int32, int16 and uint8 bins. Some ids lie at B, outside [0, B). The
   last channel is a count channel and must be bit-equal; every channel
   within 1e-4 of its largest magnitude plus 1e-4. Each row prints its
   geometry, times and % of bound; the main row (S=2, B=255, int32, bf16)
   is also timed cold. Two grids of more (feature group, channel) items
   than 65,535 (``COLS_WIDE``: F=28 x S=10,000, and F=300,000 x S=1 held
   against one ``index_add_``, since ``hist_plain`` loops over features)
   are checked the same way, untimed. Then the path of kernel 3, with its
   count reset just before and read just after: one call of the
   row-major ``histogram`` entry point at the tuner's calibration shape
   (16,384 x 28, S=2).
4. End to end at full width: ``LightGBMClassifier(...).fit`` on 1,000,000 x
   28 synthetic rows (HIGGS's shape, made from a seed with numpy), maxBin
   255, numLeaves 31, 10 boosting rounds, then ``transform`` on a
   200,000-row holdout, in three configurations: 4 the defaults (leafwise,
   bf16 histograms: kernel 1), 4b ``useQuantizedGrad=True`` (kernel 2) and
   4c the same with ``growthPolicy="depthwise"``. 4b and 4c set
   ``quantWarmupIters=0``: with the default two bf16 warmup trees, this
   data hits a defect of the reference (ROADMAP Queue 3): the warmup
   trees' drifted leaves saturate rows to a hessian of 0, a later
   quantized split passes ``minSumHessianInLeaf`` on an f32 cancellation
   residual, and its renewed leaf divides by 0 — infinite leaves and NaN
   margins on some runs. 4d is that default configuration,
   ``useQuantizedGrad=True`` alone (two warmup trees on kernel 1, then
   kernel 2), driven for its kernels and its cuda-vs-cpu agreement, with
   its holdout AUC and per-tree leaves printed but not held to the floor.
   The kernel counts are reset just before each fit and read just after:
   the fit's kernels must have launched and no plain version may have
   run; holdout probabilities must be finite and their AUC clear
   ``AUC_FLOOR`` (4, 4b, 4c); the booster's ``predict_raw`` on cuda and
   on cpu must agree to 1e-5, non-finite margins (4d) exactly.
5. The card against the CPU on a small input: a 20,000-row fit on cuda and
   on cpu must grow identical trees and margins within 1e-5. 5b: the same
   for quantized fits, leafwise and depthwise (the positional rounding
   uniforms and the exact int32 histograms make the int8 trees agree).
   5c: the same for every regression objective (l1, huber, fair,
   quantile, poisson, tweedie, mape), for multiclass with 3 classes at
   bf16 and quantized (``quantWarmupIters=1``), for LambdaRank on small
   query groups, and for a binary fit with a validation set,
   ``metric="auc"`` and ``improvementTolerance=0.01`` (it stops early and
   is cut to its best iteration), whose ``best_iteration`` and eval history
   must agree too (history within 1e-6 relative).
6. Multiclass at full width: ``LightGBMClassifier`` (10 rounds, 31 leaves,
   255 bins: 70 trees) on 581,012 Covertype-shaped rows (54 features: 10
   continuous, a one-hot of 4 and a one-hot of 40; 7 classes drawn
   through a softmax of a fixed seeded function), then ``transform`` on a
   100,000-row holdout. Kernel 1 must launch and no plain version run;
   the probabilities' rows sum to 1 within 1e-6; the holdout
   ``multi_logloss`` must be below the class prior's and the accuracy
   above the majority share by the floors of ``PERF.md``; cuda and cpu
   ``predict_raw`` within 1e-5.
7. LambdaRank at full width: ``LightGBMRanker`` on MSLR-WEB10K-shaped rows
   (136 features, relevance 0-4, 10,000 training queries of 16-128 rows,
   every row kept) and 2,000 holdout queries marked through
   ``validationIndicatorCol``, ``earlyStoppingRound=3``, 10 rounds. Kernel
   1 and the LambdaRank kernel must launch and no plain version run; it
   prints the eval history, ``best_iteration``, the peak device memory of
   the fit and the objective's grad/hess time at the fit's queries; the
   holdout NDCG@10 must beat a random order's on the same groups by the
   floor of ``PERF.md``; cuda and cpu margins within 1e-5.
8. Categorical multiclass at full width: phase 6's rows (581,012 and
   100,000 holdout, seeds 0 and 1) with the two one-hots collapsed to
   category ids, ``X = [cont(10), area, soil]`` (ids 0-3 and 0-39),
   ``LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
   categoricalSlotIndexes=[10, 11])``, then ``transform``. Kernel 1 must
   launch and no plain version run; some internal node must split on a
   bitset; probabilities finite, rows summing to 1 within 1e-6; the
   holdout ``multi_logloss`` and accuracy held to the floors of
   ``PERF.md`` (``CAT_LOGLOSS_SHARE``, ``CAT_ACCURACY_MARGIN``). On cuda:
   ``to_lightgbm_string`` -> ``from_lightgbm_string`` -> ``predict_raw``
   within 1e-5 of the model's margins; ``predict_leaf`` is ``[n, 70]`` and
   equals, tree by tree, the leaves ``growth.leaf_nodes_binned`` (the
   routing of ``predict_tree_binned``) reaches on the holdout's bins;
   ``feature_importances("split")`` sums to the forest's internal nodes;
   cuda and cpu ``predict_raw`` within 1e-5.
8b. Small categorical fits (20,000 of phase 8's rows, 3 classes) on cuda
   against cpu, as phase 5: bf16 leafwise (kernel 1), and
   ``useQuantizedGrad=True, quantWarmupIters=0`` leafwise and depthwise
   (kernel 2, which must launch): identical trees, bitsets included,
   margins within 1e-5.
9. The 12 LightGBM text models of ``tests/resources/lgbm_golden``:
   ``from_lightgbm_string``, ``predict_raw`` and ``predict`` on cuda
   against ``expected.json`` (rtol 1e-5, atol 1e-6) and against the cpu.
   Then one ``LightGBMClassifier`` fit on cuda with a scipy CSR features
   column against the same fit on its dense copy: identical trees and
   probabilities.

10. The training options at full width, on phase 4's rows (1,000,000 x
   28 and the 200,000-row holdout, 255 bins, 31 leaves, 10 rounds), each
   fit held as phase 4's (launches, no plain version, AUC floor from
   ``SAMPLING_AUC_FLOORS``, cuda and cpu margins within 1e-5) and
   printing its fit s, trees/s, peak device memory and largest |leaf|:
   ``boostingType="goss"``; ``"rf"`` with ``baggingFraction=0.8,
   baggingFreq=1, featureFraction=0.8``; ``"dart"`` (its defaults);
   ``baggingFraction=0.5, baggingFreq=5`` with ``useQuantizedGrad=True,
   quantWarmupIters=0`` (kernel 2 under a bag with zeros); stratified
   ``posBaggingFraction=0.9, negBaggingFraction=0.3, baggingFreq=1``;
   ``numBatches=2``; a ``modelString`` warm start from phase 4's model
   plus 10 rounds; a quantized fit with ``checkpointDir`` (every 5
   rounds, bagging 0.8) and the same fit again, which resumes from its
   iteration-4 checkpoint: the checkpoint's trees bit for bit, every
   tree's structure identical, margins within 1e-5. Then one refit on the cached
   binned dataset (timed), and the time of one iteration's per-row
   uniforms drawn on the card (phase 21a holds them to JAX's). Every
   timed fit empties the binned-dataset cache first, so its time includes
   its ingest.
10b. The same options at 20,000 rows on cuda against cpu, as phase 5:
   identical trees and margins within 1e-5.
11. The main path's extensions, on the models of phases 4, 4b, 6 and 8.
   11a, the predict lanes: phase 4b's model scores the 200,000-row
   holdout with ``predict_raw(predict_dtype=...)`` in f32, bf16 and int8,
   each on cuda and cpu (within 1e-5); int8's margins within half a
   quantization step per tree of f32's (routing is exact), bf16's mean
   |delta| under ``BF16_MEAN_DELTA_FLOOR``; rows/s and upload bytes per
   row of each lane (int8 uploads f32 rows and bins them on the card), and phase 4's model's int8 delta (printed, not held:
   its leaves near 1e4 flush its ordinary leaves to 0). 11b,
   contributions: ``predict_contrib`` on cuda (the device TreeSHAP
   engine, f64) over the holdout, each row summing to its margin within
   1e-4, and within 1e-4 of the host C++ engine on its first 2,000 rows;
   saabas summing to the margin within 1e-4; ``featuresShapCol`` through
   the transforms of phase 6's model (every class block sums within 1e-6
   to its margin summed in f64 on the host from the leaves the rows
   reach; its largest leaf and margin printed, and the f32 margin's own
   distance from that sum) and of phase 8's categorical model (device vs host on
   2,000 rows, 1e-4), on 20,000 rows each; rows/s per engine and method
   and the peak device memory. 11c, out of core: phase 4's rows written
   as 4 ``.npy`` shards under ``build/``, ``LightGBMDataset.construct(path=
   ..., label_path=...)`` against the in-memory construct at uint8 (bin
   bounds and bins bit-equal), a quantized 10-round ``train_booster`` on
   each (kernel 2 only; identical trees, margins within 1e-5),
   ``predict_streamed`` over the holdout's shards (65,536-row chunks) bit
   for bit ``predict``, ``predict_contrib_streamed`` over 20,000 rows bit
   for bit ``predict_contrib``; ingest seconds and streamed rows/s.

12. Serving, on the models of phases 4b and 6, over HTTP/1.1 keep-alive on
   ``localhost`` (the clients are threads of this process). 12a, the async
   engine on phase 4b's booster saved as ``.npz``: the worker wiring
   ``serving_main._build_async_query`` (``max_batch=32``, the rows path:
   requests decode into pinned slot tables) in the f32 lane, then with
   ``MMLSPARK_TPU_PREDICT_DTYPE=int8`` (rows quantized to uint8 bin ids at
   admission); 16 client threads x 250 one-row requests from the holdout;
   replies within 1e-6 of ``predict(rows, device="cuda",
   predict_dtype=lane)``, f32 also within 1e-5 of the cpu. 12b, the
   threaded engine: ``serve().engine("threaded").pipeline(...)`` on phase
   6's classification model, 8 x 100 requests, the 7-class probability
   vectors within 1e-6 of ``transform``. 12c, the contract on the async
   f32 worker: ``/healthz`` (ready, platform ``gpu``), the serving
   families on ``/metrics``, a burst past ``queue_limit`` shed with 429
   and ``Retry-After`` (the ``serving.batch`` failpoint holds the first
   batch 0.5 s), ``X-Request-Id`` from ``traceparent``, one
   ``serving.batch`` error answered through one requeue, and a drain under
   load (clients stop at deregistration, as behind a gateway) without a
   client-visible error. Every reply outside the fault steps must be 200
   and ``serving_batch_failures_total`` must read only the injected
   failure. The measured loads' clients are threads of a separate client
   process. Per engine and lane: requests/s, client p50/p99, the mean
   served batch, the device launches (``torch.profiler``, device
   activity) and host ms of one 32-row batch called as the scoring
   thread calls it, the peak device memory and the card line.
13. The predict plan, bundles, the fleet and the checkpoint modes, on the
   models of phases 4, 4b and 6 (13b runs first, alone on the host; the
   bundle build and the gateway then start while 13a and 13e run). 13a:
   phase 4b's and phase 6's boosters
   score 1, 7, 32, 100 and 8192 rows at every lane, all iterations and
   half of them, through ``predict`` (and f32 ``predict_raw``): each
   result bit-equal to the eager body (``predict_raw_tensor`` and the
   transform) on the card, f32 margins within 1e-5 of the cpu; a
   20,000-row exact-shape batch (no graph) alike; phases 4's and 4b's
   boosters, one plan key, scored in turn 10 times, each equal to its own
   eager result; cache misses equal the distinct keys, and every bucketed
   key on the card is one captured CUDA graph (capture seconds and the
   memory the graphs pin printed). 13b: one 32-row batch of each model as
   the scoring thread passes it (slot-table rows), eager against graph:
   host ms, CPU-side ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls and
   device ms (``torch.profiler``); one graph launch and no kernel launch
   per graph call is held. 13c: ``python -m mmlspark_tpu_torch.bundles
   build`` for phase 4b's ``.npz`` (``--max-batch 32``, f32 and int8) and
   an async ``serving_main worker --bundle`` subprocess: ``/healthz`` never
   ready before its prewarm completed, every entry loaded, no capture in
   its ring and ``gbdt_compiles_total`` unmoved across a load; a second
   worker on a copy of the bundle whose fingerprint was edited degrades
   loudly (a ``fingerprint_mismatch`` flight event) and serves correctly.
   13d: a ``serving_main gateway`` over those two workers on the one card
   takes phase 12's async f32 load (16 client threads in a client process
   x 250 one-row requests): requests/s and client p50/p99, replies within
   1e-6 of ``predict``; the gateway's ``/metrics`` carries both workers'
   families; 16 x 100 requests with the second worker SIGTERM'd mid-load,
   no client-visible error; and, while the two workers start, an
   in-process ``DistributedServing`` with 2 workers on one Booster under
   16 concurrent clients, every reply bit-equal to the eager body. 13e:
   on the card at 20,000 rows,
   ``MMLSPARK_TPU_STRICT_RESUME=1`` against a mismatched checkpoint raises
   ``CheckpointMismatchError``; with ``MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY
   =1`` a NaN validation loss injected at round 3 writes one emergency
   checkpoint (step 2, ``nan_loss``) that resumes to the same trees.

14. Multi-device training's paths at full width, the main path's
   telemetry and the pickled Booster (the models of phases 4, 4b and 6).
   14a, the deterministic blocked reduction: kernel 1's deterministic mode
   (``node_hist_det``: fixed-point int64 sums, one partial per row block)
   at phase 4's rows in 8 blocks, W=1 and W=16: bit for bit against
   ``node_hist_det_plain`` (the same fixed-point sums in int64
   ``index_add_``), against ``node_hist_blocked_plain`` (counts
   bit-equal, grad/hess as phase 3), and bit for bit against itself over
   20 launches; its ms per launch warm and L2 cold beside kernel 1's at
   the same shape, bound, plain and ``index_add_`` ms; bit for bit against
   ``node_hist_det_plain`` too where its shifts meet their edges (zero,
   subnormal, bf16-overflowing, inf and NaN blocks). Kernel 2's
   blocked route (the blocks as ``8 W`` nodes, permuted back and
   dequantized) on the same inputs quantized at the blocked ``q_max``,
   bit for bit against ``node_hist_blocked_plain`` summed in int32 times
   the scales, at W=1 and W=16. Then phase 4's
   fit and its quantized one (``useQuantizedGrad=True,
   quantWarmupIters=0``, stochastic rounding on) under
   ``MMLSPARK_TPU_HIST_BLOCKS=8``: each through its kernel alone (the
   deterministic mode; kernel 2 over the blocks as nodes), AUC floor;
   fitted twice, byte-equal ``model_string``; and at
   world size 2, two processes on the one card joined by gloo through a
   file rendezvous under ``build/``: both ranks' models byte-equal to
   these, and their deterministic mode bit-equal to this process's on the
   same seeded inputs. A blocked bf16 and a blocked quantized fit of
   20,000 rows on cuda vs cpu as phase 5. 14b: phase 6's fit with
   ``parallelism="voting_parallel", topK=20`` (40 of the 54 features per
   split search): its trees differ from phase 6's, phase 6's floors hold;
   20,000 of its rows on cuda vs cpu as phase 5. 14c: phase 4's fit with
   the metrics registry reset first publishes ``gbdt_fits_total``,
   ``gbdt_trained_iterations``, the stage row counters and the spans
   (``LightGBMClassifier``, ``LightGBMClassificationModel``,
   ``LightGBMClassifier.train_booster``); under
   ``MMLSPARK_TPU_BINNED_CACHE=0`` the binned-dataset cache stays empty.
   14d: phases 4's and 4b's boosters (one plan key) scored on the card and
   pickled; a fresh process unpickles and scores them in turn (the first
   captures the key's graph there), each bit-equal to its own eager
   result; a process with CUDA hidden unpickles 4b's and scores it on the
   CPU bit-equal to this process's CPU result.

15. The shared host stages, featurizers, TrainClassifier and the VW
   learners. 15a: ``VowpalWabbitClassifier(numBits=24, numPasses=2,
   batchSize=128)`` on 1,000,000 Criteo-shaped rows (13 log1p-scaled
   integer columns, 26 categorical columns with Criteo Kaggle's distinct
   counts, hashed in numpy; VW's constant feature: 40 features a row) and
   the transform of 200,000 more, held to ``VW_AUC_FLOOR``; a profiler
   window over 40 batch steps, eager and as the captured graph (launches,
   host and device ms, busy share; the graph's weights equal the eager
   step's); the deterministic scatter against ``index_add_`` at one
   batch, bit-equal over repeats. 15b: every fit of ``VW_SMALL_FITS`` at
   20,000 rows, ``numBits=18``, cuda against cpu on well-conditioned rows
   (``VW_WEIGHT_ATOL``), then on raw Criteo-shaped columns through
   ``VowpalWabbitFeaturizer`` (VW's defaults held to 8 times the margin
   spread one ulp of input makes on the CPU; the rest printed); a streamed
   fit and a resumed checkpointed fit bit-equal on the card. 15c: L-BFGS
   at 200,000 rows, 10 iterations, the objective must not rise. 15d: the
   contextual bandit over 10,000 events (8 actions, 32 + 16 dimensions),
   epsilon and bag, cuda against cpu, ``fit_multiple`` on two threads
   bit-equal to the fits in turn. 15e: ``TrainClassifier`` over
   ``LightGBMClassifier`` on 48,842 Adult-shaped rows (kernel 1 alone, its
   launches counted into the record; ``ADULT_AUC_FLOOR``; cuda against
   cpu 1e-5) and ``ComputeModelStatistics``; ``TextFeaturizer`` ->
   ``VowpalWabbitFeaturizer`` -> ``VowpalWabbitClassifier`` on 20,000
   documents, cuda against cpu. The phase's seconds print beside the
   card's name and power limit.
16. The isolation forest, exact KNN, SAR with the ranking tools and
   CyberML's AccessAnomaly, at full width; no histogram kernel runs here
   (their device work is torch ops; the counts are reset before and must
   read 0 after). 16a: ``IsolationForest`` (100 trees, 256 samples,
   ``contamination=0.01``) on phase 4's 1,000,000 x 28 rows with 1% moved
   far from the mass: fit s, transform rows/s, peak memory; AUC against
   the planted labels over ``IF_AUC_FLOOR``; trees bit-equal to a cpu
   fit; scores within 1e-6 of the cpu on 20,000 rows. 16b: ``KNN(k=100,
   blockSize=4096)`` at sift-128-euclidean's shape (1,000,000 x 128
   integer components in [0, 255], 10,000 queries): queries/s, peak
   memory, one block's product and top-k in device ms against its f32
   bound; on 100 queries against float64 brute force, every returned id
   within (1 + 1e-4) of the exact k-th distance, recall@100 >= 0.99,
   distances within 1e-4; ``ConditionalKNN`` (10 labels, 3 allowed a
   query) returns allowed ids only; ``BallTree.query_batch`` on 50,000 x
   16 rows equals brute force. 16c: ``SAR`` (jaccard, support 4, 30-day
   decay) at MovieLens-1M's shape (6,040 users, 3,706 items, 1,000,209
   ratings): fit, ``transform`` of every pair, ``recommend_for_all_users
   (10)``; similarity, affinity and seen equal to a cpu fit, scores within
   1e-5 relative, the top 10 equal to cpu's up to swaps inside near ties;
   ``RankingTrainValidationSplit`` over ``RankingAdapter(SAR)``, NDCG@10
   over ``SAR_NDCG_FLOOR`` and MAP@10; the sparse path
   (``DENSE_CELLS_MAX=0``) equal to the dense path. 16d:
   ``AccessAnomaly`` (implicit, rank 10, 25 sweeps) on about 1.1M
   ``DataFactory`` events: fit s, ALS s a sweep, a second ALS run
   bit-equal, transform rows/s, inter-department scores above
   intra-department ones by ``AA_MARGIN``; implicit and explicit
   (``complementsetFactor=2``) fits at one department's size, cuda
   against one-thread cpu within ``AA_SPREAD_FACTOR`` times the spread
   that two ulps on half the likelihoods make. ``tools/chip_phase16.py``
   runs this phase alone.
17. DNN scoring, with cuDNN's TF32 at PyTorch's default (on) for the
   phase: the port's f32 forward must turn it off itself. 17a: the catalog
   materialized from ``builtin://`` (the port's seeded draws) under
   ``build/chip_smoke_dnn``; ResNet-50's ``DNNModel`` (``miniBatchSize``
   64) over 4,096 seeded 224x224x3 inputs in f32 and in bf16: warm
   images/s, device ms a batch, peak memory; logits and ``pool`` on cuda
   against cpu on 4 inputs within ``DNN_SPREAD_FACTOR`` times the spread
   one ulp of input (a bf16 ulp for bf16) makes on the cpu; the same f32
   forward outside the port's scope (TF32 on) printed beside it; the TF32
   flag back on after each forward; ResNet-18/34/101/152 and AlexNet the
   same way in f32. 17b: ``ImageFeaturizer`` (resize -> normalize ->
   ResNet-50 ``pool``) on 5,120 seeded uint8 pictures at ImageNet's four
   common sizes with 1% None rows, both lanes: rows/s, then the f32
   lane's stages in turn (device resize, host normalize, forward; their
   features equal to the featurizer's); ``dropNa=False`` keeps the None
   rows in place, the other rows' features equal. 17c: the first 4,096
   f32 features (F=2,048) into ``LightGBMClassifier`` (10 rounds, 31
   leaves, 4 classes): kernel 1 must launch and no plain version run (the
   counts reset before 17a, read after the fit), holdout accuracy over
   ``DNN_ACCURACY_FLOOR``; kernel 1's root pass (n=4,096, W=1) and half
   pass (n=2,048, W=8) at F=2,048 against the plain version, timed with
   their bound and ``index_add_``. 17d: ``stream_transform`` over 3 shards
   of 1,024 inputs in chunks of 300 and ``stream_featurize_images`` over
   512 JPEG files and a corrupt one, each bit-equal to its in-memory run.
   17e: ``ImageLIME`` over the ResNet-50 ``DNNModel`` at its defaults on 2
   inputs (``LIME_IMAGES``): s an explanation, the model's share;
   coefficients cuda against cpu on one input within ``LIME_COEF_RTOL``. 17f: the DigitsConvNet
   fixture's pinned hash, its logits on 64 inputs of 32x32 as 17a. 17d-17f
   launch no histogram kernel. ``tools/chip_phase17.py`` runs this phase
   alone.
18. AutoML and the HTTP stages. 18a: ``TuneHyperparameters`` over the
   JAX sweep test's grid (``learningRate`` x ``lambdaL2``, 8 trials), 2
   folds of phase 4's rows, AUC, ``histSubtraction=False``, swept
   (``parallelism=8``) and sequential: wall s, s a trial fit, the binned
   cache's hits and misses, kernel 1's launches (counted into the
   record); histories within ``HISTORY_RTOL`` (kernel 1's float atomics
   may move the last bits); fold 0's swept trials byte-equal to their
   sequential fits under ``MMLSPARK_TPU_HIST_BLOCKS=8``; the default
   config falls back at this row count; the best model's holdout AUC
   over ``AUC_FLOOR``. 18b: the tuning on ``TUNE_SMALL_ROWS`` rows,
   cuda against cpu (identical trees, margins 1e-5, histories
   ``HISTORY_RTOL``), then ``FindBestModel`` over phases 4's and 4b's
   models and 18a's on phase 4's holdout. 18c: ``SimpleHTTPTransformer``
   against a ``serving_main`` worker on phase 4b's booster over 5,000
   holdout rows at concurrency 1 and 16 (replies within 1e-6 of
   ``predict``; a row of the wrong width in ``errorCol``), through a
   ``PortForwarder``, and a ``PowerBIWriter`` into a local stub. 18d:
   the DigitsConvNet payload fetched by ``http://`` (hash pinned, a
   tampered payload refused), scoring bit-equal to the ``file://`` route.
   ``tools/chip_phase18.py`` runs this phase alone.

19. The SPMD transformer's train step: ``TransformerConfig()``'s full
   width (vocab 32,000, d_model 512, 8 heads x 64, 4 layers, d_ff 2,048,
   bf16), no histogram kernel (the counts are reset before and must read
   0 after). 19a: each strategy (``ring``, ``ring_zigzag``, ``ulysses``) at
   world size 1 on the card, 8 x 2,048 seeded tokens, 5 AdamW steps on
   the same batch: every loss finite and the last below the first, the
   three first losses within ``TF_FIRST_LOSS_ATOL``; ms per step, tokens/s,
   peak device memory, one profiled step's device ms and the attention's
   share of it (the attention alone, forward and backward, profiled on
   one layer's q, k, v, times the layers), beside its bound. Then a narrow
   f32 config, each strategy on cuda and on ``device="cpu"``: the losses
   of 3 steps within ``TF_CPU_ATOL``. 19b: four processes on the one card
   joined by gloo through a file rendezvous under ``build/``, a
   ``{"data": 1, "seq": 2, "model": 2}`` mesh, full width with one layer,
   S=512, f32: each strategy's 3 losses within ``TF_RANK_ATOL`` of the
   same steps at world size 1 on the card; the calls and bytes each
   collective of rank 0 sent. ``tools/chip_phase19.py`` runs this phase
   alone.

20. Checkpoint/resume and out-of-core ingest over a data group: two
   processes on the one card joined by gloo through a file rendezvous
   under ``build/`` (three stages of ``P20_SRC``, each a new pair), phase
   4's rows and 15a's VW at their full widths. 20a: phase 4's fit under
   ``MMLSPARK_TPU_HIST_BLOCKS=8`` with a checkpoint every 2 rounds,
   killed on both ranks by ``gbdt.round:exit@7``, resumed on two ranks
   and on one (this process): both byte-equal to an uninterrupted
   two-rank fit, the resumes growing the last rounds only (the
   deterministic mode's launches); a checkpoint's seconds and bytes. 20b:
   phase 11c's four shards built out of core over the two ranks: each
   rank's bins, labels, weights and mask bit-equal to its slice of the
   in-memory two-rank construct, its file reads inside its row range
   (rank 0 also the binner's sample); quantized (kernel 2) and bf16
   (kernel 1) fits on both datasets with identical trees, margins within
   1e-5; ingest seconds a rank against one rank's in this process. 20c:
   ``VowpalWabbitClassifier(numBits=24, numPasses=2)`` on 15a's 1,000,000
   Criteo-shaped rows with ``checkpointDir``, the processes killed as
   pass 2 starts, resumed: weights bit-equal to an uninterrupted two-rank
   fit, the resume running pass 2 alone. Rank 1 names checkpoint
   directories of its own, which must never be created.
   ``tools/chip_phase20.py`` runs this phase alone.

21. The JAX package's random streams on the card
   (``mmlspark_tpu_torch/utils/prng.py``, threefry2x32 as torch integer
   ops). 21a: ``_row_uniforms`` over 1,000,000 rows, the stochastic
   rounding's uniforms at ``[3, 1,000,000]`` and a rank's slice of them
   from column 500,000, drawn on cuda and on cpu: bit-equal, and the
   sha256 of their f32 bits equal to ``PRNG_GOLDEN``, the hashes of
   ``jax.random``'s own draws under the same keys (a tier-1 test computes
   them with JAX), so the card draws JAX's stream without JAX; each
   draw's warm ms on the card; normals at [1,000,000] and a narrow
   transformer's init bit-equal on cuda and cpu. 21b:
   phase 4's rows fitted with ``baggingFraction=0.8, baggingFreq=1,
   featureFraction=0.8`` in bf16 (kernel 1) and quantized with
   stochastic rounding, warmup 0 (kernel 2); GOSS with
   ``featureFraction=0.8``; the quantized and bf16 bagged fits under
   ``MMLSPARK_TPU_HIST_BLOCKS=8`` (kernel 2's blocked route, the
   deterministic mode): each held as phase 4 (its kernels launch, no plain
   version, AUC floor 0.75, cuda and cpu margins within 1e-5), and its
   20,000-row twin on cuda against cpu as phase 5 (identical trees,
   margins within 1e-5). 21c: a quantized tree's int8 statistics
   through ``quant_stats`` (``growth._quantize_fused``: the amax launch,
   the scales, the fused mask-draw-round-pack launch) against the eager
   chain they replaced on the card (``growth._quantize_for`` over the
   stacked ``[3, n]`` statistics), int8 values and scales bit-equal
   (``torch.equal``) in every case of ``quant_cases``: n = 1, 1,000,
   1,048,577 and higgs-qgrad-fit's 10,500,000 rows; both ranks' slices
   (``start``, ``stride``) of a 2-rank draw over those rows; 20,000,000
   rows (``q_max`` 107); no key (round to nearest); the blocked mode's
   positional draws, alone, on a rank's slice and at ``q_max`` 107; NaN
   and +-inf statistics; an all-zero channel (scale 1). Then the kernel,
   the fused route and the eager chain at [3, 10,500,000], warm and L2
   cold, against the kernel's bound (15 bytes a row, or 80 int32
   operations a draw at ``PEAK_INT32_OPS_PER_S``). The quantized fits of
   phases 4b-4d, 5b and 21b must launch it. ``tools/chip_phase21.py``
   runs this phase alone.
22. The LambdaRank kernel, ``lambdarank`` (``csrc/lambdarank.cu``, one
   launch a round over query groups of any length), against its plain
   version (``objectives.lambdarank_plain``) on the card: at Yahoo LTR's
   queries (473,134 rows in 19,944 queries of 1-139 rows, the
   yahoo-rank-refit cell's shape), with MMLSpark's defaults and with a
   gain table, ``maxPosition`` 10, sigma 2 and a tenth of the rows at
   weight 0; at one query of 4,096 rows (past the kernel's shared-memory
   rows) and with short queries around it. Gradients and hessians within
   ``P22_TOL`` of the largest of their kind; two launches bit-equal. Then
   the kernel and the plain version at Yahoo LTR's queries and at the
   4,096-row query, warm and L2 cold, against the kernel's bound (21
   float32 operations a pair ``y_i > y_j``, or 20 bytes a row).
   ``tools/chip_phase22.py`` runs this phase alone.

The last lines are the kernels' JSON record (each kernel's main-path
row: launches, warm and cold ms, bound, % of bound, plain and
``index_add_`` ms; the deterministic mode's at 14a's W=16 pass, launches
from 14a's fit; ``quant_stats`` at 21c's [3, 10,500,000] with the eager
chain as its plain version, and its amax's launches; ``lambdarank`` at
22's Yahoo LTR queries, launches from phase 7's fit), the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import hashlib
import http.client
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.automl.core import (DiscreteHyperParam, FindBestModel,
                                            GridSpace, TuneHyperparameters,
                                            evaluate_metric)
from mmlspark_tpu_torch.automl.sweep import swept_fit
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.cyber import anomaly as anomaly_mod
from mmlspark_tpu_torch.cyber.anomaly import AccessAnomaly
from mmlspark_tpu_torch.cyber.dataset import DataFactory
from mmlspark_tpu_torch.featurize.text import TextFeaturizer
from mmlspark_tpu_torch.io import serving as serving_mod
from mmlspark_tpu_torch.io import serving_main
from mmlspark_tpu_torch.io.http import SimpleHTTPTransformer
from mmlspark_tpu_torch.io.port_forwarding import PortForwarder
from mmlspark_tpu_torch.io.powerbi import PowerBIWriter
from mmlspark_tpu_torch.io.aserve import SlotTable
from mmlspark_tpu_torch.models.gbdt import api as gbdt_api
from mmlspark_tpu_torch.models.gbdt.api import (LightGBMClassificationModel,
                                                LightGBMClassifier,
                                                LightGBMRanker,
                                                LightGBMRegressor,
                                                _pad_groups)
from mmlspark_tpu_torch.models.gbdt import quantize
from mmlspark_tpu_torch.models.gbdt import booster as booster_mod
from mmlspark_tpu_torch.models.gbdt import growth as growth_mod
from mmlspark_tpu_torch.models.gbdt.booster import (Booster, LightGBMDataset,
                                                    _row_uniforms,
                                                    train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import (GrowConfig, Tree,
                                                   leaf_nodes_binned)
from mmlspark_tpu_torch.models.gbdt.ingest import write_shards
from mmlspark_tpu_torch.models.gbdt.treeshap import shap_values
from mmlspark_tpu_torch.models.isolation_forest import IsolationForest
from mmlspark_tpu_torch.models.gbdt import objectives as objectives_mod
from mmlspark_tpu_torch.models.gbdt.objectives import (QueryGroups,
                                                       _ndcg_metric,
                                                       auc_weighted,
                                                       get_objective,
                                                       score_transform)
from mmlspark_tpu_torch.nn.knn import KNN, BallTree, ConditionalKNN
from mmlspark_tpu_torch.device import exact_f32
from mmlspark_tpu_torch.explain.lime import ImageLIME
from mmlspark_tpu_torch.image import (ImageTransformer, decode_image,
                                      normalize_image)
from mmlspark_tpu_torch.io.streaming import (stream_featurize_images,
                                             stream_transform)
from mmlspark_tpu_torch.models.dnn import (DNNModel, ImageFeaturizer,
                                          ModelDownloader)
from mmlspark_tpu_torch.models.dnn import transformer as tfm
from mmlspark_tpu_torch.models.dnn.cnn import apply_cnn
from mmlspark_tpu_torch.observability import flight as obs_flight
from mmlspark_tpu_torch.observability import metrics as obs_metrics
from mmlspark_tpu_torch.observability import roofline
from mmlspark_tpu_torch.observability import watchdog as obs_watchdog
from mmlspark_tpu_torch.ops import _build
from mmlspark_tpu_torch.ops import histogram as hist_ops
from mmlspark_tpu_torch.ops import lambdarank as rank_ops
from mmlspark_tpu_torch.ops.binning import bin_cols
from mmlspark_tpu_torch.models.vw import sgd as vw_sgd
from mmlspark_tpu_torch.models.vw.api import (VW_CONSTANT_INDEX,
                                              VowpalWabbitClassifier,
                                              VowpalWabbitRegressor)
from mmlspark_tpu_torch.models.vw.bandit import VowpalWabbitContextualBandit
from mmlspark_tpu_torch.models.vw.featurizer import VowpalWabbitFeaturizer
from mmlspark_tpu_torch.ops.murmur import hash_feature, hash_namespace
from mmlspark_tpu_torch.ops.topk import top_k
from mmlspark_tpu_torch.parallel import ring_attention, ulysses
from mmlspark_tpu_torch.parallel.mesh import make_mesh as make_tf_mesh
from mmlspark_tpu_torch.ops.histogram_scatter import (blocks_as_nodes,
                                                      hist_plain,
                                                      node_hist_blocked_plain,
                                                      node_hist_det_plain,
                                                      node_hist_plain)
from mmlspark_tpu_torch.recommendation import sar as sar_mod
from mmlspark_tpu_torch.recommendation.ranking import (
    RankingAdapter, RankingEvaluator, RankingTrainValidationSplit)
from mmlspark_tpu_torch.recommendation.sar import SAR, SARModel
from mmlspark_tpu_torch.robustness import failpoints
from mmlspark_tpu_torch.train.core import (ComputeModelStatistics,
                                           TrainClassifier)
from mmlspark_tpu_torch.utils import prng
from mmlspark_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                 CheckpointMismatchError,
                                                 data_fingerprint)

# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, f32 rate outside the tensor cores, int8 rate; one source with the
# roofline ledger's table
PEAK_BYTES_PER_S = roofline.PEAK_BYTES_PER_S
PEAK_F32_OPS_PER_S = roofline.PEAK_F32_OPS_PER_S
PEAK_INT8_OPS_PER_S = roofline.PEAK_INT8_OPS_PER_S
AUC_FLOOR = 0.75
# phase 10 holdout AUC floors, one per training option (PERF.md, set from a
# CPU rehearsal at a small size before its first chip run)
SAMPLING_AUC_FLOORS = {"goss": 0.75, "rf": 0.73, "dart": 0.745,
                       "bagging_int8": 0.75, "stratified": 0.75,
                       "warm_start": 0.75, "batches": 0.75,
                       "checkpoint": 0.75}
# phase 4 and 10 sizes: HIGGS-shaped training and holdout rows
HIGGS_ROWS, HIGGS_HOLDOUT = 1_000_000, 200_000
# where phase 10 writes its checkpoints (under the ignored build directory)
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")
# phase 6 and 7 quality floors (PERF.md, set from a CPU rehearsal at a
# small size before the first chip run): holdout multi_logloss at most
# this share of the class prior's, accuracy at least this far above the
# majority share, NDCG@10 at least this far above a random order's
MULTI_LOGLOSS_SHARE = 0.85
ACCURACY_MARGIN = 0.2
NDCG_MARGIN = 0.2
# phase 8 quality floors (PERF.md, set from a CPU rehearsal at a small size
# before its first chip run; no looser than phase 6's)
CAT_LOGLOSS_SHARE = 0.85
CAT_ACCURACY_MARGIN = 0.2
# phase 6 and 7 sizes: Covertype's rows, MSLR-WEB10K's query counts
COVERTYPE_ROWS, COVERTYPE_HOLDOUT = 581_012, 100_000
MSLR_QUERIES, MSLR_HOLDOUT_QUERIES, MSLR_GROUP = 10_000, 2_000, 128
# the device memory a LambdaRank fit may take at phase 7's shape before its
# pairwise lambdas would need chunking over groups
RANKER_MEMORY_BUDGET = 24 << 30
KERNELS = hist_ops.KERNELS + ("lambdarank",)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


_L2_FLUSH = None
# device cycles the card spins per call it is to run before the timed
# calls: longer than the host takes to enqueue one call (a wrapper call is
# tens of microseconds of Python), so the events time the device alone
_SPIN_CYCLES_PER_CALL = 1_000_000


def _queue_ahead(calls: int) -> None:
    """Keep the card busy while the host enqueues ``calls`` calls: without
    it a call shorter than its own host overhead leaves the card idle
    between launches, and the events would time the host."""
    torch.cuda._sleep(calls * _SPIN_CYCLES_PER_CALL)


def time_cold_ms(fn, reps: int = 10) -> float:
    """Mean device ms of ``fn`` with L2 cold: a 256 MB buffer (five times
    the 50 MB L2) is written before each call, and each call is timed alone
    between two events."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for i in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        _queue_ahead(1)
        _L2_FLUSH.fill_(float(i))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, enqueued
    while the card is busy (``_queue_ahead``)."""
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _queue_ahead(reps)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def hist_inputs(gen, n, F, W, B):
    """Bins, pos and f32 stats on the generator's device."""
    dev = gen.device
    binned = torch.randint(0, B, (F, n), generator=gen, device=dev,
                           dtype=torch.int32)
    pos = torch.randint(-1, W, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    grad = torch.randn(n, generator=gen, device=dev)
    mask = (torch.rand(n, generator=gen, device=dev) < 0.95).float()
    base = torch.stack([grad * mask, grad.abs() * 0.25 * mask, mask])
    return binned, pos, base.contiguous()


def covertype_bins(gen, n):
    """[54, n] int32 bins laid out as phase 6's: 10 continuous columns over
    all 255 bins, then a one-hot of 4 and a one-hot of 40 (bins 0 and 1)."""
    binned = torch.zeros((54, n), dtype=torch.int32, device="cuda")
    binned[:10] = torch.randint(0, 255, (10, n), generator=gen,
                                device="cuda", dtype=torch.int32)
    rows = torch.arange(n, device="cuda")
    for first, width in ((10, 4), (14, 40)):
        hot = torch.randint(0, width, (n,), generator=gen, device="cuda")
        binned[first + hot, rows] = 1
    return binned


def categorical_bins(gen, n):
    """[12, n] int32 bins laid out as phase 8's: 10 continuous columns over
    all 255 bins, then the area id (bins 0-3) and the soil id (0-39)."""
    binned = torch.randint(0, 255, (12, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    binned[10] = torch.randint(0, 4, (n,), generator=gen, device="cuda",
                               dtype=torch.int32)
    binned[11] = torch.randint(0, 40, (n,), generator=gen, device="cuda",
                               dtype=torch.int32)
    return binned


def path_bins(gen, F, n, W, bins):
    """Bins, pos and f32 stats of a path row: uniform bins, phase 6's
    one-hot layout or phase 8's categorical one."""
    binned, pos, base = hist_inputs(gen, n, F, W, 255)
    if bins == "one-hot":
        binned = covertype_bins(gen, n)
    elif bins == "categorical":
        binned = categorical_bins(gen, n)
    return binned, pos, base


def bound_ms(nbytes: int, ops: float, peak_ops: float) -> tuple:
    """Least time for the work: ``nbytes`` (each input read once, each
    output written once) at the memory rate against ``ops`` at
    ``peak_ops``; the larger one, and which it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def node_bound_ms(binned, pos, base, W, B) -> tuple:
    """Kernels 1 and 2: bins, pos and the stats (f32 or int8) read, the
    4-byte output cells written, against 3 adds per (valid row, feature)
    at the f32 or the int8 rate."""
    F, n = binned.shape
    nbytes = (binned.numel() * binned.element_size() + pos.numel() * 4
              + base.numel() * base.element_size() + F * 3 * W * B * 4)
    valid_rows = int((pos >= 0).sum())
    peak = (PEAK_INT8_OPS_PER_S if base.dtype == torch.int8
            else PEAK_F32_OPS_PER_S)
    return bound_ms(nbytes, 3.0 * F * valid_rows, peak)


def cols_bound_ms(binned, stats, B) -> tuple:
    """Kernel 3: bins and f32 stats read, the f32 output written, against
    S f32 adds per (row, feature)."""
    F, n = binned.shape
    S = stats.shape[0]
    nbytes = (binned.numel() * binned.element_size() + 4 * S * n
              + F * S * B * 4)
    return bound_ms(nbytes, float(S) * F * n, PEAK_F32_OPS_PER_S)


def library_index_add(binned, pos, base, W, B):
    """The yardstick: one ``index_add_`` over the flattened segment id
    ``f*(W*B+1) + pos*B + bin`` (overflow segment for pos -1), inputs
    prepared outside the timed call. f32 stats are rounded to bf16 first;
    int8 stats are summed as int32."""
    F, n = binned.shape
    seg_len = W * B + 1
    valid = pos >= 0
    node_off = torch.where(valid, pos.long() * B,
                           torch.full_like(pos, W * B, dtype=torch.long))
    seg = torch.where(valid[None, :], node_off[None, :] + binned.long(),
                      node_off[None, :])
    seg = (seg + torch.arange(F, device="cuda")[:, None] * seg_len).reshape(-1)
    if base.dtype == torch.int8:
        data = base.to(torch.int32).t().contiguous()             # [n, 3]
    else:
        data = base.to(torch.bfloat16).float().t().contiguous()
    data = data[None].expand(F, n, 3).reshape(F * n, 3).contiguous()
    out = torch.zeros(F * seg_len, 3, device="cuda", dtype=data.dtype)

    def call():
        out.zero_()
        out.index_add_(0, seg, data)
    return call


def cols_segments(binned, stats, B, stats_dtype):
    """The flattened segment id ``f*(B+1) + bin`` of every (feature, row)
    (overflow segment for ids outside [0, B)) and each one's rounded
    stats, ``[F*n, S]``."""
    F, n = binned.shape
    b = binned.long()
    seg = torch.where((b >= 0) & (b < B), b, B)
    seg = (seg + torch.arange(F, device="cuda")[:, None] * (B + 1)
           ).reshape(-1)
    data = stats.to(stats_dtype).float().t().contiguous()        # [n, S]
    data = data[None].expand(F, n, data.shape[1]).reshape(F * n, -1)
    return seg, data.contiguous()


def library_cols_index_add(binned, stats, B, stats_dtype=torch.bfloat16):
    """The yardstick of kernel 3: one ``index_add_`` of the rounded stats
    over :func:`cols_segments`'s segment ids."""
    seg, data = cols_segments(binned, stats, B, stats_dtype)
    out = torch.zeros(binned.shape[0] * (B + 1), data.shape[1],
                      device="cuda")

    def call():
        out.zero_()
        out.index_add_(0, seg, data)
    return call


def margin_diff(a, b) -> float:
    """Largest |a - b| over the finite margins; a non-finite margin (an
    infinite leaf reached) must be the same value, or NaN, on both sides,
    else the difference is infinite."""
    fin = np.isfinite(a) & np.isfinite(b)
    if not np.array_equal(a[~fin], b[~fin], equal_nan=True):
        return float("inf")
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def check_within(got, want, what) -> None:
    """``got`` within 1e-4 of ``want``'s largest magnitude, plus 1e-4."""
    err = float((got - want).abs().max())
    lim = 1e-4 * float(want.abs().max()) + 1e-4
    if err > lim:
        raise AssertionError(f"{what}: max error {err} > {lim}")


def check_hist(got, want) -> float:
    """Count channel bit-equal; grad/hess within 1e-4 relative to the
    channel's largest magnitude (plus 1e-4). Returns the max abs error."""
    if not torch.equal(got[:, 2::3], want[:, 2::3]):
        raise AssertionError("count channel differs from the plain version")
    for s in (0, 1):
        check_within(got[:, s::3], want[:, s::3], f"stat {s}")
    return float((got - want).abs().max())


# the two main-path rows of kernels 1 and 2: the root pass and the
# half-width smaller-child pass, int32 bins, 255 bins
MAIN_ROWS = ((1_000_000, 1, 255, "int32"), (500_000, 8, 255, "int32"))
# kernel 1 at the shapes of phases 6 and 7, (F, n, W, bins): the
# Covertype-shaped root and half passes, the MSLR-shaped ranker's root pass,
# on uniform bins, and the Covertype-shaped passes again on its bins (44
# one-hot columns: most rows of a column in one bin)
PATH_ROWS = ((54, 581_012, 1, "uniform"), (54, 290_506, 8, "uniform"),
             (136, 1_280_000, 1, "uniform"), (54, 581_012, 1, "one-hot"),
             (54, 290_506, 8, "one-hot"))
# phase 8's root and half passes (kernels 1 and 2), on its bins
CAT_ROWS = ((12, 581_012, 1, "categorical"), (12, 290_506, 8, "categorical"))
# kernel 2 on phase 6's one-hot bins
INT8_PATH_ROWS = CAT_ROWS + PATH_ROWS[3:]


def log_geometry():
    """The geometry of kernels 1 and 2 at the main-path rows, beside the
    clusters the card holds at once."""
    dev = torch.cuda.current_device()
    for kernel in ("node_hist", "node_hist_int8"):
        for n, W, B, _ in MAIN_ROWS:
            geo = hist_ops._geometry_on(kernel, dev, n, 28, W, B, 4)
            held = hist_ops._clusters_held(kernel, dev, 4, geo.smem,
                                           geo.cluster)
            blocks = geo.row_blocks * geo.groups * geo.tiles
            log(f"{kernel} n={n} W={W} B={B}: {geo}; grid {blocks} blocks "
                f"in clusters of {geo.cluster}; the card holds {held} such "
                f"clusters ({held * geo.cluster} blocks) at once, "
                f"{hist_ops._num_sms_of(dev)} SMs")
    for F, n, W, _ in PATH_ROWS[:3]:
        geo = hist_ops._geometry_on("node_hist", dev, n, F, W, 255, 4)
        log(f"node_hist F={F} n={n} W={W} B=255: {geo}; grid "
            f"{geo.row_blocks * geo.groups * geo.tiles} blocks")
    for W in (1, 16):
        geo = hist_ops._det_geometry(HIGGS_ROWS // HIST_BLOCKS, 28, W, 255,
                                     HIST_BLOCKS)
        held = hist_ops._clusters_held("node_hist_det", dev, 4, geo.smem,
                                       geo.cluster)
        log(f"node_hist_det n={HIGGS_ROWS} in {HIST_BLOCKS} blocks W={W} "
            f"B=255: {geo}; grid "
            f"{geo.row_blocks * geo.groups * geo.tiles * HIST_BLOCKS} blocks "
            f"(from the shape alone) in clusters of {geo.cluster}, "
            f"{'int64 partials' if hist_ops._det_staged(geo) else 'each cluster owning its item'}; "
            f"the card holds {held} such clusters at once")


def node_row(call, plain, binned, pos, base, W, B, cold: bool) -> dict:
    """Times of one kernel shape: the wrapper (warm; cold too where
    asked), the plain version, the ``index_add_`` yardstick, the bound."""
    ms = time_ms(call, reps=20)
    ms_cold = time_cold_ms(call) if cold else None
    plain_ms = time_ms(plain, reps=3, warm=1)
    lib = time_ms(library_index_add(binned, pos, base, W, B), reps=5, warm=1)
    bound, by = node_bound_ms(binned, pos, base, W, B)
    return dict(ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, library_ms=lib,
                bound_ms=bound, bound_by=by)


def log_row(name, key, r, check):
    cold = "" if r["ms_cold"] is None else f" (L2 cold {r['ms_cold']:.4f})"
    log(f"{name} n={key[0]} W={key[1]} B={key[2]} {key[3]}: kernel "
        f"{r['ms']:.4f} ms{cold}  bound {r['bound_ms'] * 1e3:.1f} us "
        f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%)  plain "
        f"{r['plain_ms']:.3f} ms  index_add_ {r['library_ms']:.3f} ms  "
        f"{check}")


def phase_kernels():
    log("== phase 3: node_hist kernel vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(1234)
    F = 28
    shapes = [(n, W, B) for n in (1_000_000, 500_000) for B in (255, 63)
              for W in (1, 8, 16)] + [(499_999, 8, 255)]
    rows, max_err = {}, 0.0
    for n, W, B in shapes:
        binned32, pos, base = hist_inputs(gen, n, F, W, B)
        for dt in (torch.int32, torch.int16, torch.uint8):
            binned = binned32.to(dt)
            want = node_hist_plain(binned, pos, base, W, B)
            got = hist_ops.node_histogram(binned, pos, base, W, B)
            torch.cuda.synchronize()
            err = check_hist(got, want)
            max_err = max(max_err, err)
            key = (n, W, B, str(dt).replace("torch.", ""))
            r = node_row(
                lambda: hist_ops.node_histogram(binned, pos, base, W, B),
                lambda: node_hist_plain(binned, pos, base, W, B),
                binned, pos, base, W, B, cold=key in MAIN_ROWS)
            rows[key] = dict(r, max_abs_err=err)
            log_row("node_hist", key, r, f"max_abs_err {err:.3g}")
            del binned, want, got
        del binned32, pos, base
    for F_, n, W, bins in PATH_ROWS + CAT_ROWS:
        binned, pos, base = path_bins(gen, F_, n, W, bins)
        want = node_hist_plain(binned, pos, base, W, 255)
        got = hist_ops.node_histogram(binned, pos, base, W, 255)
        torch.cuda.synchronize()
        err = check_hist(got, want)
        max_err = max(max_err, err)
        key = (n, W, 255, "int32", F_, bins)
        r = node_row(lambda: hist_ops.node_histogram(binned, pos, base, W,
                                                     255),
                     lambda: node_hist_plain(binned, pos, base, W, 255),
                     binned, pos, base, W, 255, cold=True)
        rows[key] = dict(r, max_abs_err=err)
        log_row(f"node_hist F={F_} {bins} bins", key, r,
                f"max_abs_err {err:.3g}")
        del binned, pos, base, want, got
    return rows, max_err


def phase_int8_kernel():
    log("== phase 3b: node_hist_int8 kernel vs plain version (int32 sums)")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    F = 28
    shapes = [(n, W, B) for B in (255, 63)
              for n, W in ((1_000_000, 1), (500_000, 8), (500_000, 15))
              ] + [(499_999, 8, 255)]
    rows, max_err = {}, 0.0
    for n, W, B in shapes:
        binned32, pos, base_f = hist_inputs(gen, n, F, W, B)
        base, _ = hist_ops.quantize_stats(base_f)
        for dt in (torch.int32, torch.uint8):
            binned = binned32.to(dt)
            want = node_hist_plain(binned, pos, base, W, B,
                                   acc_dtype=torch.int32)
            got = hist_ops._node_hist_int8_cuda(binned, pos, base, W, B)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"node_hist_int8 n={n} W={W} B={B} {dt}: not bit-equal "
                    "to the plain version")
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            key = (n, W, B, str(dt).replace("torch.", ""))
            r = node_row(
                lambda: hist_ops._node_hist_int8_cuda(binned, pos, base, W,
                                                      B),
                lambda: node_hist_plain(binned, pos, base, W, B,
                                        acc_dtype=torch.int32),
                binned, pos, base, W, B, cold=key in MAIN_ROWS)
            rows[key] = dict(r, max_abs_err=err)
            log_row("node_hist_int8", key, r, "bit-equal")
            del binned, want, got
        del binned32, pos, base, base_f
    for F_, n, W, bins in INT8_PATH_ROWS:
        binned, pos, base_f = path_bins(gen, F_, n, W, bins)
        base, _ = hist_ops.quantize_stats(base_f)
        want = node_hist_plain(binned, pos, base, W, 255,
                               acc_dtype=torch.int32)
        got = hist_ops._node_hist_int8_cuda(binned, pos, base, W, 255)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"node_hist_int8 F={F_} n={n} W={W} {bins} "
                                 "bins: not bit-equal to the plain version")
        key = (n, W, 255, "int32", F_, bins)
        r = node_row(
            lambda: hist_ops._node_hist_int8_cuda(binned, pos, base, W, 255),
            lambda: node_hist_plain(binned, pos, base, W, 255,
                                    acc_dtype=torch.int32),
            binned, pos, base, W, 255, cold=True)
        rows[key] = dict(r, max_abs_err=0.0)
        log_row(f"node_hist_int8 F={F_} {bins} bins", key, r, "bit-equal")
        del binned, pos, base, base_f, want, got
    return rows, max_err


# phase 3c rows of kernel 3, F=28: (n, S, B, bins, stats_dtype, layout).
# The first is the main row: the tuner's S=2 at full width, 255 bins.
COLS_MAIN = (1_000_000, 2, 255, "int32", "bf16", "aligned")
COLS_ROWS = (
    COLS_MAIN,
    (1_000_000, 3, 255, "int32", "bf16", "aligned"),
    (1_000_000, 2, 63, "int32", "bf16", "aligned"),
    (1_000_000, 3, 63, "int32", "bf16", "aligned"),
    (1_000_000, 1, 255, "int32", "bf16", "aligned"),
    (1_000_000, 5, 255, "int32", "bf16", "aligned"),
    (1_000_000, 48, 255, "int32", "bf16", "aligned"),
    (1_000_000, 2, 255, "int16", "bf16", "aligned"),
    (1_000_000, 2, 255, "uint8", "bf16", "aligned"),
    (1_000_000, 2, 4096, "int32", "bf16", "aligned"),
    (1_000_000, 3, 4096, "int16", "bf16", "aligned"),
    (1_000_000, 2, 255, "int32", "f32", "aligned"),
    (1_000_000, 2, 255, "int32", "bf16", "misaligned"),
    (499_999, 2, 255, "int32", "bf16", "aligned"),
    (499_999, 3, 63, "int16", "bf16", "aligned"),
    (499_999, 5, 255, "uint8", "f32", "misaligned"),
)
COLS_F = 28
# grids of more (feature group, channel) items than a grid's y extent
# (65,535) holds: (n, F, S, B, bins). F=28 x S=10,000 (7 groups of 4 x
# 10,000 channels), and F=300,000 x S=1 (75,000 groups of 4)
COLS_WIDE = ((20_000, 28, 10_000, 255, "int32"),
             (256, 300_000, 1, 63, "uint8"))
STATS_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary, so every array row takes scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def cols_inputs(gen, row):
    """Bins (some ids at B, outside [0, B)) and [S, n] f32 stats for a
    phase-3c row; the last channel is a count channel of 0s and 1s."""
    n, S, B, bins, _, layout = row
    binned = torch.randint(0, B, (COLS_F, n), generator=gen, device="cuda",
                           dtype=torch.int32)
    binned[0, ::97] = B
    binned = binned.to(getattr(torch, bins))
    stats = torch.randn(S, n, generator=gen, device="cuda")
    stats[-1] = (stats[-1] > -1.5).float()
    if layout == "misaligned":
        binned, stats = misaligned(binned), misaligned(stats)
    return binned, stats


def check_cols(got, want, what) -> float:
    """The count channel (the last) bit-equal, every channel within
    ``check_within``. Returns the max abs error."""
    if not torch.equal(got[:, -1], want[:, -1]):
        raise AssertionError(f"{what}: count channel differs from the plain "
                             "version")
    for s in range(got.shape[1]):
        check_within(got[:, s], want[:, s], f"{what} channel {s}")
    return float((got - want).abs().max())


def cols_key(row) -> str:
    n, S, B, bins, sd, layout = row
    return f"n={n} S={S} B={B} {bins} {sd} {layout}"


def phase_cols_kernel():
    log("== phase 3c: hist_bf16 kernel (histogram_cols) vs plain version")
    gen = torch.Generator(device="cuda").manual_seed(2468)
    dev = torch.cuda.current_device()
    rows, max_err = {}, 0.0
    for row in COLS_ROWS:
        n, S, B, bins, sd, _ = row
        binned, stats = cols_inputs(gen, row)
        stats_dtype = STATS_DTYPES[sd]
        want = hist_plain(binned, stats, B, stats_dtype)
        got = hist_ops.histogram_cols(binned, stats, B, stats_dtype)
        torch.cuda.synchronize()
        err = check_cols(got, want, f"hist_bf16 {cols_key(row)}")
        max_err = max(max_err, err)
        geo = hist_ops._cols_geometry_on(dev, n, COLS_F, S, B,
                                         binned.element_size(),
                                         stats_dtype == torch.bfloat16)
        ms = time_ms(lambda: hist_ops.histogram_cols(binned, stats, B,
                                                     stats_dtype), reps=20)
        plain = time_ms(lambda: hist_plain(binned, stats, B, stats_dtype),
                        reps=3, warm=1)
        lib = (time_ms(library_cols_index_add(binned, stats, B, stats_dtype),
                       reps=5, warm=1) if S <= 5 else None)
        ms_cold = (time_cold_ms(lambda: hist_ops.histogram_cols(
            binned, stats, B, stats_dtype)) if row == COLS_MAIN else None)
        bound, by = cols_bound_ms(binned, stats, B)
        rows[row] = dict(ms=ms, ms_cold=ms_cold, plain_ms=plain,
                         library_ms=lib, bound_ms=bound, bound_by=by,
                         max_abs_err=err)
        cold = "" if ms_cold is None else f" (L2 cold {ms_cold:.4f})"
        libs = "not run" if lib is None else f"{lib:.3f} ms"
        log(f"hist_bf16 {cols_key(row)}: kernel {ms:.4f} ms{cold}  bound "
            f"{bound * 1e3:.1f} us ({by}, {100 * bound / ms:.1f}%)  plain "
            f"{plain:.3f} ms  index_add_ {libs}  max_abs_err {err:.3g}  "
            f"[group {geo.group} x {geo.groups}, {geo.tiles} channels, "
            f"{geo.reps} copies of each cell, {geo.row_blocks} row blocks of "
            f"{geo.threads} threads in clusters of {geo.cluster}]")
        del binned, stats, want, got

    for n, F, S, B, bins in COLS_WIDE:
        binned = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                               dtype=torch.int32).to(getattr(torch, bins))
        stats = torch.randn(S, n, generator=gen, device="cuda")
        stats[-1] = (stats[-1] > -1.5).float()
        got = hist_ops.histogram_cols(binned, stats, B)
        if F <= COLS_F:
            want = hist_plain(binned, stats, B)
        else:   # hist_plain's loop over 300,000 features: one index_add_
            seg, data = cols_segments(binned, stats, B, torch.bfloat16)
            want = torch.zeros(F * (B + 1), S, device="cuda").index_add_(
                0, seg, data).view(F, B + 1, S)[:, :B].permute(0, 2, 1)
        torch.cuda.synchronize()
        what = f"hist_bf16 wide grid n={n} F={F} S={S} B={B} {bins}"
        max_err = max(max_err, check_cols(got, want, what))
        geo = hist_ops._cols_geometry_on(dev, n, F, S, B,
                                         binned.element_size(), True)
        log(f"{what}: matches ({geo.row_blocks * geo.groups * geo.tiles} "
            f"blocks: {geo.row_blocks} row blocks x {geo.groups} groups x "
            f"{geo.tiles} channels)")
        del binned, stats, got, want

    # the path of kernel 3: the row-major entry point at the tuner's
    # calibration shape, counted on its own
    rng = np.random.default_rng(11)
    Xb = torch.from_numpy(rng.integers(0, 255, size=(16_384, 28)).astype(
        np.int32)).cuda()
    st = torch.from_numpy(rng.normal(size=(16_384, 2)).astype(
        np.float32)).cuda()
    torch.cuda.synchronize()
    reset_counts()
    got = hist_ops.histogram(Xb, st, 255)
    torch.cuda.synchronize()
    launches = hist_ops.histogram_cols.launches
    plain_calls = node_hist_plain.calls + hist_plain.calls
    want = hist_plain(Xb.t().contiguous(), st.t().contiguous(), 255)
    for s in range(2):
        check_within(got[:, s], want[:, s], f"histogram (row-major) stat {s}")
    log(f"histogram 16384 x 28, S=2: hist_bf16 launches {launches}, plain "
        f"calls {plain_calls}; geometry "
        f"{hist_ops._cols_geometry_on(dev, 16_384, 28, 2, 255, 4, True)}")
    if launches <= 0 or plain_calls != 0:
        raise AssertionError("the row-major histogram did not go through "
                             "hist_bf16 alone")
    return rows, max_err, launches


def reset_counts():
    """Zero every kernel's launch count and every plain version's call
    count."""
    hist_ops.node_histogram.launches = 0
    hist_ops.node_histogram.int8_launches = 0
    hist_ops.node_histogram.det_launches = 0
    hist_ops.histogram_cols.launches = 0
    hist_ops.quantize_stats.launches = 0
    hist_ops.stats_amax_cuda.launches = 0
    rank_ops.lambdarank_cuda.launches = 0
    node_hist_plain.calls = 0
    hist_plain.calls = 0
    objectives_mod.lambdarank_plain.calls = 0


def read_counts() -> dict:
    return dict(node_hist_bf16=hist_ops.node_histogram.launches,
                node_hist_int8=hist_ops.node_histogram.int8_launches,
                hist_bf16=hist_ops.histogram_cols.launches,
                node_hist_det=hist_ops.node_histogram.det_launches,
                quant_stats=hist_ops.quantize_stats.launches,
                stats_amax=hist_ops.stats_amax_cuda.launches,
                lambdarank=rank_ops.lambdarank_cuda.launches,
                plain=(node_hist_plain.calls + hist_plain.calls
                       + objectives_mod.lambdarank_plain.calls))


def higgs_shaped(n, seed):
    """Synthetic rows of HIGGS's shape (28 float features, binary label):
    a fixed random signal with interactions, labels drawn through a
    sigmoid — learnable, not separable."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 28)).astype(np.float32)
    w = np.random.default_rng(7).normal(size=10).astype(np.float32)
    z = (X[:, :10] @ w * 0.4 + np.sin(2 * X[:, 10]) + X[:, 11] * X[:, 12]
         - 0.5 * np.abs(X[:, 13]))
    p = 1.0 / (1.0 + np.exp(-1.5 * z))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return X, y


def shown(params: dict) -> dict:
    """``params`` for the log, a long value (a model string) by its
    length."""
    return {k: v if len(str(v)) <= 80 else f"<{len(str(v)):,} characters>"
            for k, v in params.items()}


def phase_end_to_end(label, needs, data, check_quality=True,
                     auc_floor=AUC_FLOOR, prior_trees=0, **params):
    """One fit -> transform at full width; ``needs`` lists the kernels the
    fit must launch. ``check_quality=False`` (phase 4d) reports the
    holdout's non-finite rows and AUC without holding them to the floor.
    The binned-dataset cache is emptied first, so the fit's time includes
    its ingest. ``prior_trees``: trees of a warm start, not counted as
    trained. Returns (the counts, times, AUC, largest |leaf| and peak
    device memory; the booster)."""
    X, y, Xh, yh = data
    log(f"== phase {label}: LightGBMClassifier({shown(params)}) fit -> "
        "transform, "
        f"{len(y):,} x 28 x 255")
    est = LightGBMClassifier(**{**dict(numIterations=10, numLeaves=31,
                                       maxBin=255, device="cuda"),
                                **params})
    train = Dataset({"features": X, "label": y})
    hold = Dataset({"features": Xh, "label": yh})
    gbdt_api.clear_binned_dataset_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model = est.fit(train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    out = model.transform(hold)
    pred_s = time.perf_counter() - t0
    counts = read_counts()
    booster = model.booster
    trees = booster.num_trees - prior_trees
    log(f"fit {fit_s:.3f} s ({trees} trees, {trees / fit_s:.3f} trees/s), "
        f"transform {pred_s:.3f} s ({len(yh) / pred_s:.0f} rows/s); peak "
        f"device memory {peak / 2**30:.3f} GiB; launches {counts}")
    for k in needs:
        if counts[k] <= 0:
            raise AssertionError(f"the main path never launched {k}")
    if counts["plain"] != 0:
        raise AssertionError(f"a plain histogram ran {counts['plain']} times "
                             "on the main path")
    probs = out.array("probability")
    if probs.shape != (len(yh), 2):
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    finite = np.isfinite(probs).all(axis=1)
    a = auc_weighted(probs[finite, 1], yh[finite], None)
    log(f"holdout AUC {a:.5f} over {int(finite.sum())} rows with finite "
        f"probabilities of {len(yh)} (floor {auc_floor})")
    if check_quality and not finite.all():
        raise AssertionError(f"{int((~finite).sum())} rows have non-finite "
                             "probabilities")
    if check_quality and a <= auc_floor:
        raise AssertionError(f"holdout AUC {a} <= {auc_floor}")
    diff = margin_diff(booster.predict_raw(Xh, device="cuda"),
                       booster.predict_raw(Xh, device="cpu"))
    log(f"predict_raw cuda vs cpu: max abs diff {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"predict_raw cuda vs cpu differ by {diff}")
    t = booster.trees
    lv = np.where(t["is_leaf"], t["leaf_value"], 0.0)
    leaf = float(np.abs(lv).max())
    log(f"largest |leaf value| {leaf:.4g}")
    live = t["is_leaf"] & (t["node_cnt"] > 0)
    log("per tree: max |leaf| " + " ".join(
        f"{v:.4g}" for v in np.abs(lv).max(axis=1)) + "; non-finite leaves "
        + " ".join(str(int(v)) for v in (~np.isfinite(lv)).sum(axis=1))
        + "; least leaf hessian " + " ".join(
            f"{v:.4g}" for v in np.where(live, t["node_hess"],
                                         np.inf).min(axis=1)))
    return dict(counts=counts, fit_s=fit_s, trees_per_s=trees / fit_s,
                predict_rows_per_s=len(yh) / pred_s, auc=a, max_leaf=leaf,
                peak_gib=peak / 2**30), booster


def phase_small_agreement(label, estimator=LightGBMClassifier, cols=None,
                          needs=(), **params):
    """The card against the CPU on a small input: the same fit on cuda
    (the kernels: those of ``needs`` must launch, no plain version may run)
    and on cpu (the plain versions) grows the same trees, categorical
    bitsets included, and predicts the same margins; its best iteration and
    eval history (if it has a validation set) agree too. Leaves are kept at
    500+ rows so the f32 parent-minus-left totals, summed in another order
    on each device, move no leaf value past the 1e-5 tolerance. ``cols``
    defaults to 20,000 HIGGS-shaped rows."""
    log(f"== phase {label}: small {estimator.__name__} fit on cuda vs cpu "
        f"{shown(params)}")
    if cols is None:
        X, y = higgs_shaped(20_000, seed=2)
        cols = {"features": X, "label": y}
    kw = dict(numIterations=3, numLeaves=7, minDataInLeaf=500, maxBin=255)
    kw.update(params)
    boosters = {}
    torch.cuda.synchronize()
    reset_counts()
    for dev in ("cuda", "cpu"):
        boosters[dev] = estimator(device=dev, **kw).fit(
            Dataset(cols)).booster
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
    for k in needs:
        if counts[k] <= 0:
            raise AssertionError(f"the cuda fit never launched {k}: {counts}")
    if counts["plain"] != 0:
        raise AssertionError(f"a plain histogram ran on cuda: {counts}")
    g, c = boosters["cuda"], boosters["cpu"]
    for f in ("feat", "thr_bin", "cat_bitset", "left", "right", "is_leaf"):
        if not np.array_equal(g.trees[f], c.trees[f]):
            raise AssertionError(f"tree field {f} differs between cuda and "
                                 "cpu fits")
    diff = margin_diff(g.predict_raw(cols["features"], device="cpu"),
                       c.predict_raw(cols["features"], device="cpu"))
    log(f"same structure ({g.num_trees} trees); margins differ by "
        f"{diff:.3g} at most")
    if not diff <= 1e-5:
        raise AssertionError(f"cuda and cpu fits differ by {diff}")
    if g.best_iteration != c.best_iteration or sorted(
            g.eval_history) != sorted(c.eval_history):
        raise AssertionError(f"best iterations {g.best_iteration} / "
                             f"{c.best_iteration} or history keys differ")
    for key, hist in c.eval_history.items():
        if not np.allclose(g.eval_history[key], hist, rtol=1e-6, atol=0):
            raise AssertionError(f"{key}: cuda history {g.eval_history[key]}"
                                 f" against cpu {hist}")
    if any(c.eval_history.values()):
        log(f"best_iteration {g.best_iteration}; history {g.eval_history}")


def regression_labels(X, objective, seed):
    """Labels for a regression objective: counts for poisson and tweedie,
    a noisy smooth function of the first features for the others."""
    rng = np.random.default_rng(seed)
    z = X[:, 0] + 0.5 * X[:, 1] ** 2 - 0.7 * X[:, 2] * X[:, 3]
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.3 * z)).astype(np.float32)
    return (z + 0.1 * rng.normal(size=len(z))).astype(np.float32)


def phase_small_objectives():
    """Phase 5c: every objective of this slice, and a validation set, on
    cuda against cpu."""
    X, yb = higgs_shaped(20_000, seed=2)
    for objective, extra in (("regression_l1", {}),
                             ("huber", {"alpha": 0.5}), ("fair", {}),
                             ("quantile", {"alpha": 0.3}), ("poisson", {}),
                             ("tweedie", {"tweedieVariancePower": 1.3}),
                             ("mape", {})):
        phase_small_agreement(
            "5c", LightGBMRegressor,
            {"features": X, "label": regression_labels(X, objective, 3)},
            objective=objective, **extra)
    Xm, ym = covertype_shaped(20_000, seed=5, classes=3)
    for quant in ({}, dict(useQuantizedGrad=True, quantWarmupIters=1)):
        phase_small_agreement("5c", LightGBMClassifier,
                              {"features": Xm, "label": ym}, **quant)
    Xr, yr, gr = mslr_shaped(300, seed=6, largest=32)
    phase_small_agreement("5c", LightGBMRanker,
                          {"features": Xr, "label": yr, "query": gr},
                          groupCol="query")
    phase_small_agreement(
        "5c", LightGBMClassifier,
        {"features": X, "label": yb,
         "isVal": np.arange(len(yb)) >= 15_000},
        numIterations=8, validationIndicatorCol="isVal",
        earlyStoppingRound=2, improvementTolerance=0.01, metric="auc",
        learningRate=0.5)


def covertype_shaped(n, seed, classes=7):
    """Synthetic rows of UCI Covertype's shape: 10 continuous features, a
    one-hot of 4 (wilderness area) and a one-hot of 40 (soil type), the
    class drawn through a softmax of a fixed seeded function of them."""
    rng = np.random.default_rng(seed)
    cont = rng.normal(size=(n, 10)).astype(np.float32)
    area = rng.integers(0, 4, size=n)
    soil = rng.integers(0, 40, size=n)
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + area] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    f = np.random.default_rng(17)
    wc = f.normal(size=(10, classes)).astype(np.float32)
    wa = f.normal(size=(4, classes)).astype(np.float32)
    ws = f.normal(size=(40, classes)).astype(np.float32)
    logits = (0.7 * cont @ wc + wa[area] + 0.6 * ws[soil]
              + 0.5 * np.abs(cont[:, :classes]))
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    cum = np.cumsum(p / p.sum(axis=1, keepdims=True), axis=1)
    y = (rng.uniform(size=(n, 1)) > cum).sum(axis=1)
    return X, np.minimum(y, classes - 1).astype(np.float32)


def mslr_shaped(queries, seed, largest=MSLR_GROUP, first_query=0):
    """Synthetic rows of MSLR-WEB10K's shape: 136 features, relevance 0-4
    (about 52/32/13/2/1%), ``queries`` groups of 16 to ``largest`` rows.
    Relevance is a fixed seeded function of the features plus a per-query
    offset and noise. Returns (X, relevance, query id)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(16, largest + 1, size=queries)
    group = np.repeat(np.arange(first_query, first_query + queries), sizes)
    n = len(group)
    X = rng.normal(size=(n, 136)).astype(np.float32)
    w = np.random.default_rng(23).normal(size=20).astype(np.float32)
    rel = (0.3 * X[:, :20] @ w + X[:, 20] * X[:, 21]
           + 0.5 * rng.normal(size=queries)[group - first_query]
           + rng.normal(size=n))
    rel /= np.sqrt(0.09 * float(w @ w) + 1.0 + 0.25 + 1.0)
    y = np.digitize(rel, [0.05, 0.99, 1.88, 2.33]).astype(np.float32)
    return X, y, group


def multiclass_quality(probs, pred, y, yh, classes):
    """(holdout multi_logloss, the class prior's, accuracy, majority
    share, largest |row sum - 1|)."""
    pick = probs[np.arange(len(yh)), yh.astype(int)]
    logloss = float(-np.mean(np.log(np.clip(pick, 1e-15, 1.0))))
    prior = np.bincount(y.astype(int), minlength=classes) / len(y)
    prior_ll = float(-np.mean(np.log(prior[yh.astype(int)])))
    majority = float(np.bincount(yh.astype(int), minlength=classes).max()
                     / len(yh))
    acc = float((pred == yh).mean())
    row_err = float(np.abs(probs.sum(axis=1) - 1.0).max())
    return logloss, prior_ll, acc, majority, row_err


def phase_multiclass(label="6", **params):
    """Phase 6: the 7-class Covertype-shaped fit at full width (``params``
    added to the estimator's: phase 14b). Returns its record and its
    model."""
    log(f"== phase {label}: LightGBMClassifier({shown(params)}) multiclass "
        f"fit -> transform, {COVERTYPE_ROWS} x 54 x 255, 7 classes")
    X, y = covertype_shaped(COVERTYPE_ROWS, seed=0)
    Xh, yh = covertype_shaped(COVERTYPE_HOLDOUT, seed=1)
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             device="cuda", **params)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    model = est.fit(Dataset({"features": X, "label": y}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(Dataset({"features": Xh}))
    pred_s = time.perf_counter() - t0
    counts = read_counts()
    booster = model.booster
    log(f"fit {fit_s:.3f} s ({booster.num_trees / fit_s:.3f} trees/s, "
        f"{booster.num_trees} trees), transform {pred_s:.3f} s "
        f"({len(yh) / pred_s:.0f} rows/s); launches {counts} "
        f"({counts['node_hist_bf16'] / 10:.1f} of kernel 1 per round)")
    if counts["node_hist_bf16"] <= 0 or counts["plain"] != 0:
        raise AssertionError(f"phase {label} did not go through kernel 1 "
                             f"alone: {counts}")
    probs = out.array("probability")
    if probs.shape != (len(yh), 7) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    logloss, prior_ll, acc, majority, row_err = multiclass_quality(
        probs, out.array("prediction"), y, yh, 7)
    log(f"holdout multi_logloss {logloss:.5f} (class prior {prior_ll:.5f}, "
        f"floor {MULTI_LOGLOSS_SHARE} x prior); accuracy {acc:.5f} "
        f"(majority share {majority:.5f}, floor + {ACCURACY_MARGIN}); "
        f"probability rows sum to 1 within {row_err:.3g}")
    if row_err > 1e-6:
        raise AssertionError(f"probability rows off 1 by {row_err}")
    if logloss > MULTI_LOGLOSS_SHARE * prior_ll:
        raise AssertionError(f"holdout multi_logloss {logloss} above "
                             f"{MULTI_LOGLOSS_SHARE} x {prior_ll}")
    if acc < majority + ACCURACY_MARGIN:
        raise AssertionError(f"holdout accuracy {acc} below {majority} + "
                             f"{ACCURACY_MARGIN}")
    diff = margin_diff(booster.predict_raw(Xh, device="cuda"),
                       booster.predict_raw(Xh, device="cpu"))
    log(f"predict_raw cuda vs cpu: max abs diff {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"predict_raw cuda vs cpu differ by {diff}")
    return dict(counts=counts, fit_s=fit_s,
                trees_per_s=booster.num_trees / fit_s,
                predict_rows_per_s=len(yh) / pred_s, multi_logloss=logloss,
                prior_logloss=prior_ll, accuracy=acc, majority=majority), model


def holdout_ndcg(scores, y, group, k=10) -> float:
    """Mean NDCG@k over the query groups, through the port's own metric on
    the groups padded to MSLR_GROUP rows."""
    sp, yp, _, valid, _ = _pad_groups(scores[:, None].astype(np.float32),
                                      y, None, group, MSLR_GROUP)
    vals = _ndcg_metric(torch.from_numpy(sp[:, 0]), torch.from_numpy(yp),
                        torch.from_numpy(valid), MSLR_GROUP, k)
    return float(vals.reshape(-1, MSLR_GROUP)[:, 0].mean())


def phase_ranker():
    """Phase 7: LambdaRank on MSLR-WEB10K-shaped queries at full width."""
    log(f"== phase 7: LightGBMRanker fit -> transform, {MSLR_QUERIES} + "
        f"{MSLR_HOLDOUT_QUERIES} queries x 136 of 16-{MSLR_GROUP} rows, "
        f"every row kept")
    X, y, g = mslr_shaped(MSLR_QUERIES, seed=0)
    Xh, yh, gh = mslr_shaped(MSLR_HOLDOUT_QUERIES, seed=1,
                             first_query=MSLR_QUERIES)
    cols = {"features": np.concatenate([X, Xh]),
            "label": np.concatenate([y, yh]),
            "query": np.concatenate([g, gh]),
            "isVal": np.r_[np.zeros(len(y), bool), np.ones(len(yh), bool)]}
    est = LightGBMRanker(groupCol="query", validationIndicatorCol="isVal",
                         earlyStoppingRound=3, numIterations=10,
                         numLeaves=31, maxBin=255, maxGroupSize=MSLR_GROUP,
                         device="cuda")
    # the peak is this fit's alone: no earlier phase's binned dataset stays
    gbdt_api.clear_binned_dataset_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    model = est.fit(Dataset(cols))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    scores = model.transform(Dataset({"features": Xh})).array("prediction")
    pred_s = time.perf_counter() - t0
    counts = read_counts()
    booster = model.booster
    log(f"{len(y)} training rows in {MSLR_QUERIES} queries; fit "
        f"{fit_s:.3f} s ({booster.num_trees} trees kept); transform "
        f"{pred_s:.3f} s ({len(yh) / pred_s:.0f} rows/s); peak device "
        f"memory {peak / 2**30:.3f} GiB (budget "
        f"{RANKER_MEMORY_BUDGET / 2**30:.0f}); launches {counts}")
    log(f"eval history {booster.eval_history}; best_iteration "
        f"{booster.best_iteration}")
    if (counts["node_hist_bf16"] <= 0 or counts["lambdarank"] <= 0
            or counts["plain"] != 0):
        raise AssertionError(f"phase 7 did not go through kernel 1 and the "
                             f"LambdaRank kernel alone: {counts}")
    if peak > RANKER_MEMORY_BUDGET:
        raise AssertionError(f"peak device memory {peak} over the budget")
    ndcg = holdout_ndcg(scores, yh, gh)
    rand = holdout_ndcg(np.random.default_rng(9).uniform(size=len(yh)), yh,
                        gh)
    best = booster.eval_history["ndcg"][booster.best_iteration]
    log(f"holdout NDCG@10 {ndcg:.5f}, a random order's {rand:.5f} (floor + "
        f"{NDCG_MARGIN}); the history's at the best iteration {best:.5f}")
    if not ndcg >= rand + NDCG_MARGIN:
        raise AssertionError(f"holdout NDCG@10 {ndcg} not above {rand} + "
                             f"{NDCG_MARGIN}")
    if abs(ndcg - best) > 1e-4:
        raise AssertionError("the holdout NDCG@10 is not the history's at "
                             "the best iteration")
    diff = margin_diff(booster.predict_raw(Xh, device="cuda"),
                       booster.predict_raw(Xh, device="cpu"))
    log(f"predict_raw cuda vs cpu: max abs diff {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"predict_raw cuda vs cpu differ by {diff}")
    # the objective's pairwise grad/hess at the fit's queries (rows sorted
    # by query, as the fit sorts them)
    off = np.r_[0, np.cumsum(np.unique(g, return_counts=True)[1])]
    obj = get_objective("lambdarank", queries=QueryGroups(off, y),
                        **booster.objective_kwargs)
    y_d = torch.from_numpy(y).cuda()
    w_d = torch.ones_like(y_d)
    s_d = torch.randn(len(y), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    lam_ms = time_ms(lambda: obj.grad_hess(s_d, y_d, w_d), reps=5)
    lam_peak = torch.cuda.max_memory_allocated()
    log(f"lambdarank grad/hess over {MSLR_QUERIES} queries of 16-"
        f"{MSLR_GROUP} rows: {lam_ms:.3f} ms, peak device memory "
        f"{lam_peak / 2**30:.3f} GiB")
    return dict(counts=counts, fit_s=fit_s, trees=booster.num_trees,
                predict_rows_per_s=len(yh) / pred_s,
                best_iteration=booster.best_iteration,
                eval_history=booster.eval_history, ndcg_at_10=ndcg,
                random_ndcg_at_10=rand, peak_gib=peak / 2**30,
                lambdarank_grad_hess_ms=lam_ms)


def covertype_categorical(n, seed, classes=7):
    """Phase 6's Covertype-shaped rows with the two one-hots collapsed to
    category ids: ``[cont(10), area (0-3), soil (0-39)]``, same labels."""
    X, y = covertype_shaped(n, seed, classes)
    area = X[:, 10:14].argmax(axis=1)
    soil = X[:, 14:54].argmax(axis=1)
    return (np.column_stack([X[:, :10], area, soil]).astype(np.float32), y)


def device_tree(booster, t, dev):
    """Tree ``t`` of a booster as a growth ``Tree`` on ``dev`` (bitset words
    as int64)."""
    return Tree(**{f: torch.tensor(
        booster.trees[f][t].astype(np.int64) if f == "cat_bitset"
        else booster.trees[f][t], device=dev) for f in Tree._fields})


def phase_categorical():
    """Phase 8: categorical multiclass at full width, then the model's
    text round trip, leaves and importances on the card. Returns its record
    and its model."""
    log(f"== phase 8: LightGBMClassifier categorical multiclass fit -> "
        f"transform, {COVERTYPE_ROWS} x 12 (ids 0-3 and 0-39) x 255, 7 "
        "classes")
    X, y = covertype_categorical(COVERTYPE_ROWS, seed=0)
    Xh, yh = covertype_categorical(COVERTYPE_HOLDOUT, seed=1)
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             categoricalSlotIndexes=[10, 11], device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    model = est.fit(Dataset({"features": X, "label": y}))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(Dataset({"features": Xh}))
    pred_s = time.perf_counter() - t0
    counts = read_counts()
    booster = model.booster
    T = booster.num_trees
    t = booster.trees
    internal = ~t["is_leaf"]
    cat_nodes = int((internal & t["cat_bitset"].any(axis=-1)).sum())
    log(f"fit {fit_s:.3f} s ({T / fit_s:.3f} trees/s, {T} trees), transform "
        f"{pred_s:.3f} s ({len(yh) / pred_s:.0f} rows/s); launches {counts}; "
        f"{cat_nodes} of {int(internal.sum())} internal nodes split on a "
        "category bitset")
    if counts["node_hist_bf16"] <= 0 or counts["plain"] != 0:
        raise AssertionError(f"phase 8 did not go through kernel 1 alone: "
                             f"{counts}")
    if cat_nodes <= 0:
        raise AssertionError("no internal node split on a category bitset")
    probs = out.array("probability")
    if probs.shape != (len(yh), 7) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities: shape {probs.shape}")
    logloss, prior_ll, acc, majority, row_err = multiclass_quality(
        probs, out.array("prediction"), y, yh, 7)
    log(f"holdout multi_logloss {logloss:.5f} (class prior {prior_ll:.5f}, "
        f"floor {CAT_LOGLOSS_SHARE} x prior); accuracy {acc:.5f} (majority "
        f"share {majority:.5f}, floor + {CAT_ACCURACY_MARGIN}); probability "
        f"rows sum to 1 within {row_err:.3g}")
    if row_err > 1e-6:
        raise AssertionError(f"probability rows off 1 by {row_err}")
    if logloss > CAT_LOGLOSS_SHARE * prior_ll:
        raise AssertionError(f"holdout multi_logloss {logloss} above "
                             f"{CAT_LOGLOSS_SHARE} x {prior_ll}")
    if acc < majority + CAT_ACCURACY_MARGIN:
        raise AssertionError(f"holdout accuracy {acc} below {majority} + "
                             f"{CAT_ACCURACY_MARGIN}")
    margins = booster.predict_raw(Xh, device="cuda")
    diff = margin_diff(margins, booster.predict_raw(Xh, device="cpu"))
    log(f"predict_raw cuda vs cpu: max abs diff {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"predict_raw cuda vs cpu differ by {diff}")
    # LightGBM text and back, scored on the card
    t0 = time.perf_counter()
    text = booster.to_lightgbm_string()
    back = Booster.from_lightgbm_string(text)
    text_s = time.perf_counter() - t0
    diff = margin_diff(back.predict_raw(Xh, device="cuda"), margins)
    log(f"LightGBM text: {len(text)} characters, written and read in "
        f"{text_s:.3f} s; its margins differ by {diff:.3g} (strict routing "
        f"{back._cat_strict()})")
    if not diff <= 1e-5:
        raise AssertionError(f"the text round trip moved margins by {diff}")
    # predict_leaf against the binned routing of predict_tree_binned
    t0 = time.perf_counter()
    leaves = booster.predict_leaf(Xh, device="cuda")
    leaf_s = time.perf_counter() - t0
    if leaves.shape != (len(yh), T):
        raise AssertionError(f"predict_leaf shape {leaves.shape}")
    Xhb = bin_cols(torch.from_numpy(Xh).cuda(), torch.from_numpy(
        booster.binner_state["upper_bounds"])).t().contiguous()
    is_cat = torch.tensor(booster._is_cat(), device="cuda")
    for k in range(T):
        nodes = leaf_nodes_binned(device_tree(booster, k, "cuda"), Xhb,
                                  booster.depth_cap, is_cat)
        if not np.array_equal(nodes.cpu().numpy(), leaves[:, k]):
            raise AssertionError(f"tree {k}: predict_leaf differs from the "
                                 "binned routing")
    split = booster.feature_importances("split")
    log(f"predict_leaf [{len(yh)}, {T}] in {leaf_s:.3f} s, equal to the "
        f"binned routing of every tree; split importances {split.tolist()} "
        f"(sum {split.sum():.0f})")
    if split.sum() != internal.sum():
        raise AssertionError("split importances do not sum to the internal "
                             "nodes")
    return dict(counts=counts, fit_s=fit_s, trees_per_s=T / fit_s,
                predict_rows_per_s=len(yh) / pred_s, multi_logloss=logloss,
                prior_logloss=prior_ll, accuracy=acc, majority=majority,
                categorical_nodes=cat_nodes, text_chars=len(text)), model


def phase_small_categorical():
    """Phase 8b: small categorical fits, cuda against cpu."""
    Xc, yc = covertype_categorical(20_000, seed=5, classes=3)
    cols = {"features": Xc, "label": yc}
    kw = dict(categoricalSlotIndexes=[10, 11])
    phase_small_agreement("8b", LightGBMClassifier, cols,
                          needs=("node_hist_bf16",), **kw)
    for policy in ("leafwise", "depthwise"):
        phase_small_agreement("8b", LightGBMClassifier, cols,
                              needs=("node_hist_int8",),
                              useQuantizedGrad=True, quantWarmupIters=0,
                              growthPolicy=policy, **kw)


GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "resources", "lgbm_golden")


def phase_golden():
    """Phase 9: the LightGBM text corpus scored on the card, and a CSR
    features column fitted on the card."""
    log("== phase 9: the LightGBM text corpus on cuda; a CSR fit")
    names = sorted(os.listdir(GOLDEN_DIR))
    if len(names) != 12:
        raise AssertionError(f"the corpus holds {len(names)} models, not 12")
    worst = 0.0
    for name in names:
        with open(os.path.join(GOLDEN_DIR, name, "model.txt")) as f:
            b = Booster.from_lightgbm_string(f.read())
        with open(os.path.join(GOLDEN_DIR, name, "expected.json")) as f:
            exp = json.load(f)
        X = np.asarray(exp["X"], np.float32)
        for what, fn in (("raw", b.predict_raw), ("pred", b.predict)):
            got = fn(X, device="cuda")
            want = np.asarray(exp[what])
            if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"{name} {what}: {got} against {want}")
            cpu = fn(X, device="cpu")
            if not np.allclose(got, cpu, rtol=0, atol=1e-6):
                raise AssertionError(f"{name} {what}: cuda {got} against "
                                     f"cpu {cpu}")
            worst = max(worst, float(np.abs(got - want).max()))
        log(f"{name}: {b.num_trees} trees, depth cap {b.depth_cap}, "
            f"{'categorical' if b._is_cat() is not None else 'numeric'}, "
            f"missing routing {'stored' if b.missing_dec is not None else 'default'}"
            ": matches expected.json and the cpu")
    log(f"corpus: 12 models, largest |cuda - expected| {worst:.3g}")
    import scipy.sparse as sp
    X, y = higgs_shaped(20_000, seed=3)
    X[np.random.default_rng(4).uniform(size=X.shape) < 0.5] = 0.0
    est = LightGBMClassifier(numIterations=3, numLeaves=15, maxBin=255,
                             device="cuda")
    dense = est.fit(Dataset({"features": X, "label": y}))
    sparse = est.fit(Dataset({"features": sp.csr_matrix(X), "label": y}))
    for f in ("feat", "thr_bin", "left", "right", "is_leaf"):
        if not np.array_equal(dense.booster.trees[f],
                              sparse.booster.trees[f]):
            raise AssertionError(f"CSR fit: tree field {f} differs")
    # two fits on the card sum their histograms' floats in another order
    diff = margin_diff(
        dense.transform(Dataset({"features": X})).array("rawPrediction"),
        sparse.transform(Dataset({"features": sp.csr_matrix(X)})).array(
            "rawPrediction"))
    log(f"CSR features (20,000 x 28, half zeros): the same trees as the "
        f"dense copy, margins within {diff:.3g}")
    if not diff <= 1e-5:
        raise AssertionError(f"CSR fit: margins differ by {diff}")
    return dict(golden_max_abs_err=worst)


# phase 10: each training option at full width, (label, kernels that must
# launch, estimator params)
SAMPLING_FITS = (
    ("goss", ("node_hist_bf16",), dict(boostingType="goss")),
    ("rf", ("node_hist_bf16",), dict(boostingType="rf", baggingFraction=0.8,
                                     baggingFreq=1, featureFraction=0.8)),
    ("dart", ("node_hist_bf16",), dict(boostingType="dart")),
    ("bagging_int8", ("node_hist_int8",),
     dict(baggingFraction=0.5, baggingFreq=5, useQuantizedGrad=True,
          quantWarmupIters=0)),
    ("stratified", ("node_hist_bf16",),
     dict(posBaggingFraction=0.9, negBaggingFraction=0.3, baggingFreq=1)),
    ("batches", ("node_hist_bf16",), dict(numBatches=2)),
)


def time_row_draw(n: int, reps: int = 5) -> float:
    """Wall ms of one iteration's per-row uniforms (``_row_uniforms``)
    drawn on the card, synchronized, after one warm draw."""
    _row_uniforms(3, reps, n, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(reps):
        _row_uniforms(3, step, n, device="cuda")
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def check_resumed(whole: Booster, resumed: Booster, Xh, done: int) -> float:
    """A resumed fit against the uninterrupted one: its first ``done``
    trees (the checkpoint's) and its base score bit for bit; every tree's
    structure and thresholds identical; margins within 1e-5 (the leaf
    renewal sums exactly, so on the card the fits' leaves are expected
    bit-equal). Returns the largest leaf-value difference."""
    if resumed.num_trees != whole.num_trees:
        raise AssertionError(f"{resumed.num_trees} trees resumed, "
                             f"{whole.num_trees} uninterrupted")
    for f, a in whole.trees.items():
        if not np.array_equal(a[:done], resumed.trees[f][:done]):
            raise AssertionError(f"the checkpoint's trees differ in {f}")
    for f in ("feat", "thr_bin", "left", "right", "is_leaf", "cat_bitset"):
        if not np.array_equal(whole.trees[f], resumed.trees[f]):
            raise AssertionError(f"tree field {f} differs after resuming")
    if not (np.array_equal(whole.thr_raw, resumed.thr_raw)
            and np.array_equal(whole.base_score, resumed.base_score)):
        raise AssertionError("thresholds or base score differ")
    diff = margin_diff(whole.predict_raw(Xh, device="cuda"),
                       resumed.predict_raw(Xh, device="cuda"))
    if not diff <= 1e-5:
        raise AssertionError(f"resumed margins differ by {diff}")
    return float(np.abs(whole.trees["leaf_value"]
                        - resumed.trees["leaf_value"]).max())


def masked_stats(gen, n, kind):
    """[3, n] stats under one training option's row mask: ``goss`` at its
    defaults (weights 1, 8 and 0), ``goss_odd`` (topRate 0.3, otherRate
    0.25: weight 2.8, inexact in bf16) or ``bag`` (half the rows 0)."""
    grad = torch.randn(n, generator=gen, device="cuda")
    u = torch.rand(n, generator=gen, device="cuda")
    if kind == "bag":
        vm = (u < 0.5).float()
    else:
        top, amp = (0.2, 8.0) if kind == "goss" else (0.3, 2.8)
        vm = torch.where(u < top, 1.0, torch.where(u < top + 0.1, amp, 0.0))
    return torch.stack([grad * vm, grad.abs() * 0.25 * vm, vm]).contiguous()


def phase_masked_kernels():
    """Kernels 1 and 2 against their plain versions under the row masks of
    phase 10's options, at the main path's two passes."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    for n, W in ((1_000_000, 1), (500_000, 8)):
        binned = torch.randint(0, 255, (28, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        pos = torch.randint(-1, W, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        for kind in ("goss", "goss_odd", "bag"):
            base = masked_stats(gen, n, kind)
            want = node_hist_plain(binned, pos, base, W, 255)
            got = hist_ops.node_histogram(binned, pos, base, W, 255)
            torch.cuda.synchronize()
            if kind == "goss_odd":       # sums of 2.796875 round in f32
                for c in range(3):
                    check_within(got[:, c::3], want[:, c::3], f"stat {c}")
                err = float((got - want).abs().max())
            else:
                err = check_hist(got, want)
            q, _ = hist_ops.quantize_stats(base)
            want8 = node_hist_plain(binned, pos, q, W, 255,
                                    acc_dtype=torch.int32)
            got8 = hist_ops._node_hist_int8_cuda(binned, pos, q, W, 255)
            torch.cuda.synchronize()
            if not torch.equal(got8, want8):
                raise AssertionError(f"node_hist_int8 under a {kind} mask "
                                     f"(n={n} W={W}): not bit-equal")
            log(f"{kind} mask n={n} W={W}: node_hist max_abs_err {err:.3g}"
                ", node_hist_int8 bit-equal")
            del base, want, got, q, want8, got8


def phase_sampling(data, base: Booster) -> dict:
    """Phase 10: the training options at full width (phase 4's rows): each
    fit of ``SAMPLING_FITS``, a ``modelString`` warm start from phase 4's
    model, a checkpointed fit resumed from its middle checkpoint, and a
    refit that hits the binned-dataset cache."""
    X, y, Xh, yh = data
    log("== phase 10: kernels 1 and 2 vs plain versions under row masks")
    phase_masked_kernels()
    draw_ms = time_row_draw(len(y))
    t0 = time.perf_counter()
    data_fingerprint(X, y, None)
    fp_ms = 1e3 * (time.perf_counter() - t0)
    log(f"== phase 10: draw of {len(y):,} row uniforms on the card "
        f"{draw_ms:.3f} ms; the rows' content "
        f"fingerprint (the cache key and checkpoint identity) {fp_ms:.3f} ms")
    fits = {}
    for label, needs, params in SAMPLING_FITS:
        fits[f"10:{label}"] = phase_end_to_end(
            f"10 {label}", needs, data,
            auc_floor=SAMPLING_AUC_FLOORS[label], **params)[0]
    fits["10:warm_start"] = phase_end_to_end(
        "10 warm_start", ("node_hist_bf16",), data,
        auc_floor=SAMPLING_AUC_FLOORS["warm_start"],
        prior_trees=base.num_trees, modelString=base.model_string())[0]

    # quantized (kernel 2's integer sums do not depend on the order of its
    # atomics): with bf16 stats two uninterrupted fits on the card differ
    # past 1e-5 in the leaves of ROADMAP Queue 3 item 2, resumed or not
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    kw = dict(checkpointDir=CKPT_DIR, checkpointInterval=5,
              baggingFraction=0.8, baggingFreq=1, useQuantizedGrad=True,
              quantWarmupIters=0)
    fits["10:checkpoint"], whole = phase_end_to_end(
        "10 checkpoint", ("node_hist_int8",), data,
        auc_floor=SAMPLING_AUC_FLOORS["checkpoint"], **kw)
    files = sorted(os.listdir(CKPT_DIR))
    if len(files) != 1 or not files[0].endswith("_0000000004.pkl"):
        raise AssertionError(f"checkpoints {files}: one at iteration 4 "
                             "expected")
    # the same fit again resumes from iteration 4's checkpoint
    fits["10:resumed"], resumed = phase_end_to_end(
        "10 resumed", ("node_hist_int8",), data,
        auc_floor=SAMPLING_AUC_FLOORS["checkpoint"], prior_trees=5, **kw)
    leaf_diff = check_resumed(whole, resumed, Xh, done=5)
    log("resumed from iteration 4: the checkpoint's 5 trees bit for bit, "
        "every tree's structure and thresholds identical to the "
        f"uninterrupted fit's, leaf values within {leaf_diff:.3g}")
    # the spread of two uninterrupted fits, for scale
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    again = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                               device="cuda", **kw).fit(
        Dataset({"features": X, "label": y})).booster
    spread = np.abs(again.trees["leaf_value"]
                    - whole.trees["leaf_value"]).max()
    log(f"a second uninterrupted fit: leaf values within {spread:.3g} of "
        "the first")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)

    # a sweep's second fit on the same rows reuses the binned dataset
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             device="cuda", learningRate=0.2)
    train = Dataset({"features": X, "label": y})
    gbdt_api.clear_binned_dataset_cache()
    est.fit(train)
    (ds,) = gbdt_api._BINNED_CACHE.values()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(train)
    torch.cuda.synchronize()
    hit_s = time.perf_counter() - t0
    if list(gbdt_api._BINNED_CACHE.values()) != [ds]:
        raise AssertionError("the refit did not reuse the binned dataset")
    log(f"refit on the cached binned dataset: {hit_s:.3f} s "
        f"({10 / hit_s:.3f} trees/s)")
    gbdt_api.clear_binned_dataset_cache()
    fits["10:cache_hit"] = dict(fit_s=hit_s, trees_per_s=10 / hit_s,
                                device_draw_ms=draw_ms,
                                fingerprint_ms=fp_ms)
    return fits


def phase_small_sampling():
    """Phase 10b: the training options at 20,000 rows, cuda against
    cpu."""
    X, y = higgs_shaped(20_000, seed=2)
    base = LightGBMClassifier(numIterations=3, numLeaves=7, maxBin=255,
                              device="cpu").fit(
        Dataset({"features": X, "label": y})).booster
    for label, needs, params in SAMPLING_FITS:
        if label == "dart":
            params = dict(params, numIterations=6)
        phase_small_agreement("10b", needs=needs, **params)
    phase_small_agreement("10b", needs=("node_hist_bf16",),
                          modelString=base.model_string())


# phase 11a: the bf16 lane's mean |margin - f32 margin| on phase 4b's model
# may be at most this (PERF.md, set from a CPU rehearsal at a small size
# before its first chip run)
BF16_MEAN_DELTA_FLOOR = 5e-3
# phase 11c: where the shards of phase 4's rows are written (under the
# ignored build directory), and the streamed chunk
OOC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_ooc")
STREAM_CHUNK_ROWS = 65_536
CONTRIB_ROWS = 20_000
ENGINE_CHECK_ROWS = 2_000


def timed(fn):
    """``fn()`` and its seconds, the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def margin_f64(booster, X) -> np.ndarray:
    """``[n, K]`` raw margins summed in f64 on the host from the leaves
    ``predict_leaf`` routes each row to: ``predict_raw``'s f32 margin
    without its rounding."""
    nodes = booster.predict_leaf(X, device="cuda").astype(np.int64)
    leaf = booster.trees["leaf_value"].astype(np.float64)
    K = booster.num_class
    out = np.tile(np.asarray(booster.base_score, np.float64), (len(X), 1))
    for t in range(nodes.shape[1]):
        out[:, t % K] += leaf[t, nodes[:, t]]
    return out


def int8_bound(booster) -> np.ndarray:
    """Per class, the most the int8 lane's margins may differ from f32's:
    half a quantization step of every tree of the class (routing is
    exact; each leaf moves by at most ``scale_t / 2``)."""
    _, scale = quantize.quantize_leaves(booster.trees["leaf_value"])
    K = booster.num_class
    return np.array([scale[k::K].astype(np.float64).sum() / 2
                     for k in range(K)])


def phase_lanes(booster, base, Xh) -> dict:
    """Phase 11a: phase 4b's model scores the holdout in every lane on cuda
    and cpu; int8 within its leaf-quantization bound of f32, bf16's mean
    difference under ``BF16_MEAN_DELTA_FLOOR``."""
    log(f"== phase 11a: predict lanes f32 / bf16 / int8 on phase 4b's model, "
        f"{len(Xh):,} x 28 holdout rows")
    F = Xh.shape[1]
    out, margins = {}, {}
    for lane in ("f32", "bf16", "int8"):
        booster.predict_raw(Xh[:1000], device="cuda", predict_dtype=lane)
        m, s = timed(lambda: booster.predict_raw(Xh, device="cuda",
                                                 predict_dtype=lane))
        cpu = booster.predict_raw(Xh, device="cpu", predict_dtype=lane)
        diff = margin_diff(m, cpu)
        # host rows go up as bf16 in the bf16 lane, else as f32 (the
        # int8 lane bins them on the card)
        upload = (2 if lane == "bf16" else 4) * F
        log(f"{lane}: {len(Xh) / s:,.0f} rows/s ({s:.4f} s), upload {upload} "
            f"bytes per row; cuda vs cpu max abs diff {diff:.3g}")
        if not np.isfinite(m).all() or not diff <= 1e-5:
            raise AssertionError(f"lane {lane}: cuda vs cpu differ by {diff}")
        margins[lane] = m
        out[lane] = dict(rows_per_s=len(Xh) / s, upload_bytes_per_row=upload,
                         cuda_vs_cpu=diff)
    bound = int8_bound(booster)
    d8 = np.abs(margins["int8"] - margins["f32"]).max(axis=0)
    dbf = np.abs(margins["bf16"] - margins["f32"])
    log(f"int8 vs f32: max |delta| {d8.tolist()} against the bound "
        f"{bound.tolist()} (half a step of every tree); bf16 vs f32: mean "
        f"|delta| {dbf.mean():.4g} (floor {BF16_MEAN_DELTA_FLOOR}), max "
        f"{dbf.max():.4g}")
    if not (d8 <= bound + 1e-6).all():
        raise AssertionError(f"int8 margins off f32 by {d8} > {bound}")
    if not dbf.mean() <= BF16_MEAN_DELTA_FLOOR:
        raise AssertionError(f"bf16 mean |delta| {dbf.mean()} > "
                             f"{BF16_MEAN_DELTA_FLOOR}")
    # phase 4's bf16 model carries leaves near 1e4 (ROADMAP Queue 3): a
    # per-tree int8 scale of that size flushes its ordinary leaves to 0
    b8 = np.abs(base.predict_raw(Xh, device="cuda", predict_dtype="int8")
                - base.predict_raw(Xh, device="cuda")).max()
    log(f"phase 4's model (largest |leaf| {np.abs(base.trees['leaf_value']).max():.4g}): "
        f"int8 vs f32 max |delta| {b8:.4g} (bound {int8_bound(base)[0]:.4g};"
        " not held)")
    out.update(int8_max_delta=float(d8.max()), int8_bound=float(bound.max()),
               bf16_mean_delta=float(dbf.mean()),
               bf16_max_delta=float(dbf.max()),
               phase4_int8_max_delta=float(b8))
    return out


def class_sums(contrib, K, F):
    """``[n, K]``: each class block of a contributions matrix summed."""
    return np.stack([contrib[:, k * (F + 1):(k + 1) * (F + 1)].sum(axis=1)
                     for k in range(K)], axis=1)


def phase_contributions(booster, Xh, multiclass, categorical) -> dict:
    """Phase 11b: device TreeSHAP and saabas on phase 4b's model, against
    the margins and the host engine; ``featuresShapCol`` through the
    transforms of phase 6's and phase 8's models."""
    log(f"== phase 11b: contributions on phase 4b's model, {len(Xh):,} rows")
    F = Xh.shape[1]
    raw = booster.predict_raw(Xh, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    dev, s_dev = timed(lambda: booster.predict_contrib(Xh, device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    add = np.abs(class_sums(dev, 1, F) - raw).max()
    log(f"device TreeSHAP: {len(Xh) / s_dev:,.0f} rows/s ({s_dev:.3f} s), "
        f"peak device memory {peak / 2**30:.3f} GiB; rows sum to the margin "
        f"within {add:.3g}")
    if dev.shape != (len(Xh), F + 1) or not add <= 1e-4:
        raise AssertionError(f"device TreeSHAP sums off the margin by {add}")
    r = ENGINE_CHECK_ROWS
    host, s_host = timed(lambda: shap_values(booster, Xh[:r]))
    eng = np.abs(host - dev[:r]).max()
    log(f"host TreeSHAP (C++): {r / s_host:,.0f} rows/s ({s_host:.3f} s); "
        f"device vs host on {r:,} rows: max abs diff {eng:.3g}")
    if not eng <= 1e-4:
        raise AssertionError(f"device vs host TreeSHAP differ by {eng}")
    sa, s_sa = timed(lambda: booster.predict_contrib(Xh, method="saabas",
                                                     device="cuda"))
    add_sa = np.abs(class_sums(sa, 1, F) - raw).max()
    log(f"saabas: {len(Xh) / s_sa:,.0f} rows/s ({s_sa:.3f} s); rows sum to "
        f"the margin within {add_sa:.3g}")
    if not add_sa <= 1e-4:
        raise AssertionError(f"saabas sums off the margin by {add_sa}")

    n = CONTRIB_ROWS
    Xc, _ = covertype_shaped(n, seed=1)
    model = multiclass.copy({"featuresShapCol": "shap"})
    out, s6 = timed(lambda: model.transform(Dataset({"features": Xc})))
    c6 = out.array("shap")
    raw6 = margin_f64(multiclass.booster, Xc)
    add6 = np.abs(class_sums(c6, 7, Xc.shape[1]) - raw6).max()
    log(f"phase 6's model, transform with featuresShapCol on {n:,} rows: "
        f"{n / s6:,.0f} rows/s ({s6:.3f} s); every class block sums to its "
        f"margin summed in f64 within {add6:.3g}")
    if c6.shape != (n, 7 * 55) or not add6 <= 1e-6:
        raise AssertionError(f"phase 6's contributions off by {add6}")
    t6 = multiclass.booster.trees
    f32_off = np.abs(multiclass.booster.predict_raw(Xc, device="cuda")
                     - raw6).max()
    log(f"phase 6's model: largest |leaf| "
        f"{np.abs(np.where(t6['is_leaf'], t6['leaf_value'], 0)).max():.4g}, "
        f"largest |margin| {np.abs(raw6).max():.4g}; predict_raw's f32 "
        f"margin is {f32_off:.3g} off the f64 sum")
    Xk, _ = covertype_categorical(n, seed=1)
    model = categorical.copy({"featuresShapCol": "shap"})
    out, s8 = timed(lambda: model.transform(Dataset({"features": Xk})))
    c8 = out.array("shap")
    host8 = shap_values(categorical.booster, Xk[:r])
    eng8 = np.abs(c8[:r] - host8).max()
    add8 = np.abs(class_sums(c8, 7, Xk.shape[1])
                  - categorical.booster.predict_raw(Xk, device="cuda")).max()
    log(f"phase 8's model, transform with featuresShapCol on {n:,} rows: "
        f"{n / s8:,.0f} rows/s ({s8:.3f} s); device vs host on {r:,} rows "
        f"{eng8:.3g}; class blocks sum to the margins within {add8:.3g}")
    if not eng8 <= 1e-4:
        raise AssertionError(f"phase 8's device vs host differ by {eng8}")
    return dict(treeshap_device_rows_per_s=len(Xh) / s_dev,
                treeshap_host_rows_per_s=r / s_host,
                saabas_rows_per_s=len(Xh) / s_sa,
                multiclass_shap_rows_per_s=n / s6,
                categorical_shap_rows_per_s=n / s8,
                peak_gib=peak / 2**30, additivity=float(add),
                device_vs_host=float(eng), saabas_additivity=float(add_sa),
                multiclass_additivity=float(add6),
                multiclass_f32_margin_off=float(f32_off),
                categorical_device_vs_host=float(eng8))


def quantized_fit(dataset) -> tuple:
    """A quantized 10-round fit on a built dataset (kernel 2); returns the
    booster, its launch counts and seconds."""
    cfg = GrowConfig(num_leaves=31, quantized_grad=True, quant_warmup_iters=0)
    reset_counts()
    b, s = timed(lambda: train_booster(dataset=dataset, objective="binary",
                                       num_iterations=10, cfg=cfg))
    counts = read_counts()
    if counts["node_hist_int8"] <= 0 or counts["plain"] != 0:
        raise AssertionError(f"the quantized fit did not go through kernel 2 "
                             f"alone: {counts}")
    return b, counts, s


def phase_out_of_core(data) -> dict:
    """Phase 11c: phase 4's rows as ``.npy`` shards, built out of core and
    in memory; equal binners, bins and trees; streamed scores and
    contributions equal the in-memory ones."""
    X, y, Xh, _ = data
    log(f"== phase 11c: out-of-core ingest of {len(y):,} x 28 rows in 4 "
        f"shards, streamed scoring of {len(Xh):,}")
    shutil.rmtree(OOC_DIR, ignore_errors=True)
    x_dir, y_dir, h_dir, c_dir = (os.path.join(OOC_DIR, d)
                                  for d in ("x", "y", "h", "c"))
    q = len(y) // 4
    cuts = [(i * q, len(y) if i == 3 else (i + 1) * q) for i in range(4)]
    write_shards((X[a:b] for a, b in cuts), x_dir)
    write_shards((y[a:b] for a, b in cuts), y_dir)
    write_shards((Xh[i:i + 50_000] for i in range(0, len(Xh), 50_000)), h_dir)
    write_shards((Xh[:CONTRIB_ROWS // 2], Xh[CONTRIB_ROWS // 2:CONTRIB_ROWS]),
                 c_dir)
    mem, s_mem = timed(lambda: LightGBMDataset.construct(
        X, y, bin_dtype="uint8", device="cuda"))
    ooc, s_ooc = timed(lambda: LightGBMDataset.construct(
        path=x_dir, label_path=y_dir, device="cuda"))
    same_bounds = np.array_equal(mem.binner.upper_bounds,
                                 ooc.binner.upper_bounds)
    same_bins = bool(torch.equal(mem.Xbt, ooc.Xbt))
    log(f"ingest in memory {s_mem:.3f} s, out of core {s_ooc:.3f} s "
        f"({ooc.Xbt.dtype}); bin bounds bit-equal {same_bounds}, bins equal "
        f"{same_bins}")
    if not (same_bounds and same_bins and ooc.Xbt.dtype == torch.uint8
            and torch.equal(mem.y, ooc.y)):
        raise AssertionError("the out-of-core dataset differs from the "
                             "in-memory one")
    b_mem, c_mem, s_fit_mem = quantized_fit(mem)
    b_ooc, c_ooc, s_fit_ooc = quantized_fit(ooc)
    for f in ("feat", "thr_bin", "left", "right", "is_leaf", "cat_bitset"):
        if not np.array_equal(b_mem.trees[f], b_ooc.trees[f]):
            raise AssertionError(f"out-of-core fit: tree field {f} differs")
    leaf = float(np.abs(b_mem.trees["leaf_value"]
                        - b_ooc.trees["leaf_value"]).max())
    mdiff = margin_diff(b_mem.predict_raw(Xh, device="cuda"),
                        b_ooc.predict_raw(Xh, device="cuda"))
    log(f"quantized fits: {s_fit_mem:.3f} s in memory, {s_fit_ooc:.3f} s out "
        f"of core, launches {c_mem} / {c_ooc}; identical trees, leaf values "
        f"within {leaf:.3g}, margins within {mdiff:.3g}")
    if not mdiff <= 1e-5:
        raise AssertionError(f"out-of-core fit margins differ by {mdiff}")
    del mem, ooc
    want = b_ooc.predict(Xh, device="cuda")
    got, s_st = timed(lambda: b_ooc.predict_streamed(
        h_dir, chunk_rows=STREAM_CHUNK_ROWS, device="cuda"))
    log(f"predict_streamed ({STREAM_CHUNK_ROWS:,}-row chunks): "
        f"{len(Xh) / s_st:,.0f} rows/s ({s_st:.3f} s); bit-equal to predict "
        f"{np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("predict_streamed differs from predict")
    want = b_ooc.predict_contrib(Xh[:CONTRIB_ROWS], device="cuda")
    got, s_cs = timed(lambda: b_ooc.predict_contrib_streamed(
        c_dir, device="cuda"))
    log(f"predict_contrib_streamed: {CONTRIB_ROWS / s_cs:,.0f} rows/s "
        f"({s_cs:.3f} s); bit-equal to predict_contrib "
        f"{np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("predict_contrib_streamed differs from "
                             "predict_contrib")
    shutil.rmtree(OOC_DIR, ignore_errors=True)
    return dict(fits={"11c:in_memory": dict(counts=c_mem, fit_s=s_fit_mem),
                      "11c:out_of_core": dict(counts=c_ooc,
                                              fit_s=s_fit_ooc)},
                ingest_in_memory_s=s_mem, ingest_out_of_core_s=s_ooc,
                streamed_rows_per_s=len(Xh) / s_st,
                contrib_streamed_rows_per_s=CONTRIB_ROWS / s_cs,
                leaf_diff=leaf)


def phase_main_path_extensions(data, base, quantized, multiclass,
                               categorical) -> dict:
    """Phase 11: the predict lanes, contributions and the out-of-core
    ingest with streamed scoring."""
    t0 = time.perf_counter()
    Xh = data[2]
    out = dict(lanes=phase_lanes(quantized, base, Xh),
               contributions=phase_contributions(quantized, Xh, multiclass,
                                                 categorical))
    ooc = phase_out_of_core(data)
    out["fits"] = ooc.pop("fits")
    out["out_of_core"] = ooc
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11: {out['seconds']:.1f} s")
    return out


# phase 12: where the served model is saved (under the ignored build
# directory), the load of each engine, the bucket cap
SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_serve")
SERVE_MAX_BATCH = 32
ASYNC_CLIENTS, ASYNC_REQUESTS = 16, 250
THREADED_CLIENTS, THREADED_REQUESTS = 8, 100
# the families a worker's /metrics must carry
SERVING_FAMILIES = ("serving_responses_total", "serving_request_seconds",
                    "serving_batch_size", "serving_batches_total",
                    "serving_queue_depth", "serving_inflight_requests",
                    "serving_stage_seconds", "serving_transform_seconds")
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"


def http_call(host, port, path, body=None, headers=None):
    """One request on its own connection: (status, body, headers)."""
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("POST" if body is not None else "GET", path, body,
                     headers or {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


def serve_load(server, path, bodies, clients, stop=None):
    """POST ``bodies`` from ``clients`` threads, each on one keep-alive
    connection, request i on thread i % clients; a thread stops early
    once ``stop`` is set. Returns (statuses, bodies, client latencies in
    s, wall s); an unsent request reads status None."""
    n = len(bodies)
    statuses, replies, lat = [None] * n, [None] * n, [0.0] * n

    def client(k):
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=10)
        try:
            for i in range(k, n, clients):
                if stop is not None and stop.is_set():
                    return
                t0 = time.perf_counter()
                conn.request("POST", path, bodies[i],
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                replies[i] = r.read()
                lat[i] = time.perf_counter() - t0
                statuses[i] = r.status
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a serving client did not finish in 120 s")
    return statuses, replies, lat, time.perf_counter() - t0


# the measured loads' clients: threads of a separate process (stdlib
# only), so they take none of the serving process's interpreter lock. It
# reads {"host", "port", "path", "clients", "bodies"} as JSON on stdin and
# writes {"statuses", "replies", "latencies", "seconds"} on stdout.
CLIENT_SRC = r"""
import http.client, json, sys, threading, time
job = json.load(sys.stdin)
bodies = [b.encode() for b in job["bodies"]]
n, k = len(bodies), job["clients"]
statuses, replies, lat = [None] * n, [None] * n, [0.0] * n
def client(j):
    conn = http.client.HTTPConnection(job["host"], job["port"], timeout=10)
    try:
        for i in range(j, n, k):
            t0 = time.perf_counter()
            conn.request("POST", job["path"], bodies[i],
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            replies[i] = r.read().decode()
            lat[i] = time.perf_counter() - t0
            statuses[i] = r.status
    finally:
        conn.close()
threads = [threading.Thread(target=client, args=(j,)) for j in range(k)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump({"statuses": statuses, "replies": replies, "latencies": lat,
           "seconds": time.perf_counter() - t0}, sys.stdout)
"""


def serve_load_process(server, path, bodies, clients):
    """``serve_load`` from a client process: ``clients`` threads there,
    each on one keep-alive connection."""
    job = json.dumps({"host": server.host, "port": server.port,
                      "path": path, "clients": clients,
                      "bodies": [b.decode() for b in bodies]})
    r = subprocess.run([sys.executable, "-c", CLIENT_SRC], input=job,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"the client process failed: {r.stderr}")
    out = json.loads(r.stdout)
    return (out["statuses"], [b.encode() if b is not None else None
                              for b in out["replies"]],
            out["latencies"], out["seconds"])


def counter_total(name, **labels) -> float:
    """The sum of a family's series that carry ``labels``."""
    fam = obs_metrics.get_registry().snapshot().get(name)
    if fam is None:
        return 0.0
    return float(sum(r["value"] for r in fam["series"]
                     if all(r["labels"].get(k) == v
                            for k, v in labels.items())))


def wait_for(cond, timeout=10.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end and not cond():
        time.sleep(0.01)
    return cond()


def device_launches(prof) -> int:
    """Device work items (kernels, copies, fills) a profiler window saw."""
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def launches_per_batch(query, rows) -> dict:
    """Device launches and host ms of one served batch of a full 32-row
    bucket, called directly as the scoring thread calls it (a rows-path
    query's scorer on rows staged as its slot table stages them; a
    threaded query's transform on a batch of requests). Launches come
    from ``torch.profiler`` (device activity only); None where it saw no
    device work. A batch's launches do not depend on its rows."""
    from torch.profiler import ProfilerActivity, profile

    rows = rows[:SERVE_MAX_BATCH]
    scorer = getattr(query, "scorer", None)
    table = None
    if scorer is not None:
        spec = query.server.row_spec
        table = SlotTable(SERVE_MAX_BATCH, spec.width, spec.dtype,
                          spec.quantizer, pin_memory=spec.pin_memory)
        for i, x in enumerate(rows):
            table.write(i, x)
        view, _ = SlotTable.bucket_view(table.flip(), SERVE_MAX_BATCH)

        def call():
            scorer(view)
    else:
        ds = Dataset({"id": [str(i) for i in range(len(rows))],
                      "value": [[float(v) for v in x] for x in rows]})

        def call():
            query.transform(ds)
    call()
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    if table is not None:
        table.release_claim()
    n = device_launches(prof)
    return {"launches": n / 10 if n else None, "batch_ms": host_ms}


def load_summary(label, statuses, lat, secs, query, before,
                 mem) -> dict:
    """Requests/s, client p50/p99, the mean served batch and the device
    memory (``mem``: allocated at the start, peak) of one load; fails on
    any reply other than 200."""
    bad = [x for x in statuses if x != 200]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} replies were not 200: "
                             f"{sorted(set(map(str, bad)))}")
    batches = query.batches_served - before[0]
    served = query.requests_served - before[1]
    lat = np.asarray(lat)
    return dict(requests=len(statuses), seconds=secs,
                requests_per_s=len(statuses) / secs,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                mean_batch=served / batches if batches else None,
                batches=batches, peak_device_mib=mem[1] / 2**20,
                peak_above_start_mib=(mem[1] - mem[0]) / 2**20)


def row_bodies(X) -> list:
    return [json.dumps({"features": [float(v) for v in x]}).encode()
            for x in X]


def start_async_worker(path, lane, **overrides):
    """The async worker of ``serving_main`` for ``path`` in ``lane``,
    warmed and started, readiness flipped as the worker does."""
    os.environ["MMLSPARK_TPU_PREDICT_DTYPE"] = lane
    serving_mod.set_ready(False)
    args = serving_main.worker_args(path, host="localhost", port=0,
                                    api_name="higgs",
                                    max_batch=SERVE_MAX_BATCH, **overrides)
    query, booster = serving_main._build_async_query(args, device="cuda")
    query.start()
    serving_mod.set_ready(True)
    return query, booster


def phase_async_lane(path, lane, Xh, card) -> dict:
    """Phase 12a for one lane: the async worker under 16 x 250 one-row
    requests, replies against the port's own predict."""
    t0 = time.perf_counter()
    query, booster = start_async_worker(path, lane)
    steps = {"start_s": time.perf_counter() - t0}
    try:
        if query.server.row_spec.dtype != quantize.staging_dtype(lane):
            raise AssertionError(f"the {lane} worker stages "
                                 f"{query.server.row_spec.dtype}")
        rows = Xh[:ASYNC_CLIENTS * ASYNC_REQUESTS]
        bodies = row_bodies(rows)
        fails0 = counter_total("serving_batch_failures_total")
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        before = (query.batches_served, query.requests_served)
        st, replies, lat, secs = serve_load_process(
            query.server, "/higgs", bodies, ASYNC_CLIENTS)
        out = load_summary(f"12a {lane}", st, lat, secs, query, before,
                           (start, torch.cuda.max_memory_allocated()))
        got = np.asarray([json.loads(b)["prediction"] for b in replies])
        want = booster.predict(rows, device="cuda", predict_dtype=lane)
        diff = float(np.abs(got - want).max())
        out["max_abs_vs_predict"] = diff
        if got.shape != want.shape or not diff <= 1e-6:
            raise AssertionError(f"12a {lane}: replies {diff} off predict")
        if lane == "f32":
            cpu = float(np.abs(got - booster.predict(rows, device="cpu"))
                        .max())
            out["max_abs_vs_cpu"] = cpu
            if not cpu <= 1e-5:
                raise AssertionError(f"12a f32: replies {cpu} off the cpu")
        t0 = time.perf_counter()
        out["batch_32"] = launches_per_batch(query, rows)
        steps["profile_s"] = time.perf_counter() - t0
        out["steps"] = steps
        if counter_total("serving_batch_failures_total") != fails0:
            raise AssertionError(f"12a {lane}: a batch failed")
        log(f"phase 12a async {lane}: {out['requests_per_s']:,.1f} "
            f"requests/s ({out['requests']} in {secs:.3f} s), client p50 "
            f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms, mean "
            f"batch {out['mean_batch']:.2f} ({out['batches']} batches); a "
            f"32-row batch: {out['batch_32']['launches']} device launches, "
            f"{out['batch_32']['batch_ms']:.3f} ms of the scoring thread; peak "
            f"device memory {out['peak_device_mib']:.1f} MiB "
            f"({out['peak_above_start_mib']:.2f} above the load's start); "
            f"replies vs predict {diff:.3g}; steps {steps}; {card}")
        return out
    finally:
        query.stop()
        os.environ.pop("MMLSPARK_TPU_PREDICT_DTYPE", None)


def phase_threaded(multiclass, card) -> dict:
    """Phase 12b: the threaded engine serving phase 6's model through
    ``serve().pipeline``; replies against ``transform``."""
    n = THREADED_CLIENTS * THREADED_REQUESTS
    Xc, _ = covertype_shaped(n, seed=2)
    serving_mod.set_ready(False)
    multiclass.transform(Dataset({"features": Xc[:1]}))     # warm
    query = (serving_mod.serve().address("localhost", 0, "covertype")
             .batch(SERVE_MAX_BATCH, 5.0).engine("threaded")
             .pipeline(multiclass, input_col="features",
                       output_col="probability").start())
    serving_mod.set_ready(True)
    try:
        bodies = [json.dumps([float(v) for v in x]).encode() for x in Xc]
        fails0 = counter_total("serving_batch_failures_total")
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        before = (query.batches_served, query.requests_served)
        st, replies, lat, secs = serve_load_process(
            query.server, "/covertype", bodies, THREADED_CLIENTS)
        out = load_summary("12b threaded", st, lat, secs, query, before,
                           (start, torch.cuda.max_memory_allocated()))
        got = np.asarray([json.loads(b) for b in replies])
        want = np.asarray(multiclass.transform(
            Dataset({"features": Xc}))["probability"])
        diff = float(np.abs(got - want).max())
        out["max_abs_vs_transform"] = diff
        if got.shape != (n, 7) or not diff <= 1e-6:
            raise AssertionError(f"12b: replies {diff} off transform "
                                 f"({got.shape})")
        out["batch_32"] = launches_per_batch(query, Xc)
        if counter_total("serving_batch_failures_total") != fails0:
            raise AssertionError("12b: a batch failed")
        log(f"phase 12b threaded: {out['requests_per_s']:,.1f} requests/s "
            f"({n} in {secs:.3f} s), client p50 {out['p50_ms']:.3f} ms "
            f"p99 {out['p99_ms']:.3f} ms, mean batch "
            f"{out['mean_batch']:.2f} ({out['batches']} batches); a 32-row "
            f"batch: {out['batch_32']['launches']} device launches, "
            f"{out['batch_32']['batch_ms']:.3f} ms of the batch thread; "
            f"peak device memory {out['peak_device_mib']:.1f} MiB "
            f"({out['peak_above_start_mib']:.2f} above the load's start); "
            f"7-class replies vs transform {diff:.3g}; {card}")
        return out
    finally:
        query.stop()


def phase_contract(path, Xh) -> dict:
    """Phase 12c: health, metrics, shed, trace echo, requeue and drain on
    the async f32 worker."""
    bodies = row_bodies(Xh[:400])
    out = {}
    fails0 = counter_total("serving_batch_failures_total")
    query, _ = start_async_worker(path, "f32", max_queue_depth=4)
    try:
        srv = query.server
        st, body, _ = http_call(srv.host, srv.port, "/healthz")
        health = json.loads(body)
        if st != 200 or health.get("ready") is not True or \
                health.get("platform") != "gpu":
            raise AssertionError(f"12c: /healthz {st} {health}")
        st, body, _ = http_call(srv.host, srv.port, "/higgs", bodies[0],
                                {"traceparent":
                                 f"00-{TRACE_ID}-00f067aa0ba902b7-01"})
        st2, _, hdrs = http_call(srv.host, srv.port, "/higgs", bodies[1],
                                 {"traceparent":
                                  f"00-{TRACE_ID}-00f067aa0ba902b7-01"})
        if (st, st2) != (200, 200) or \
                hdrs.get("X-Request-Id") != TRACE_ID:
            raise AssertionError(f"12c: trace echo {st} {st2} {hdrs}")
        st, body, _ = http_call(srv.host, srv.port, "/metrics")
        text = body.decode()
        missing = [f for f in SERVING_FAMILIES
                   if f"# TYPE {f} " not in text]
        if st != 200 or missing:
            raise AssertionError(f"12c: /metrics {st} lacks {missing}")
        # a burst past queue_limit: the first batch is held 0.5 s, so the
        # 32 slots and 4 pending places fill and the rest shed
        failpoints.configure("serving.batch:delay:500ms@1", seed=0)
        shed0 = counter_total("serving_shed_total", reason="queue_full")
        burst = [None] * 64

        def one(i):
            burst[i] = http_call(srv.host, srv.port, "/higgs", bodies[i])

        ts = [threading.Thread(target=one, args=(i,), daemon=True)
              for i in range(64)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(15)
        failpoints.clear()
        codes = [b[0] if b else None for b in burst]
        shed = [b for b in burst if b and b[0] == 429]
        if not shed or set(codes) - {200, 429} or not all(
                int(b[2].get("Retry-After", 0)) >= 1 for b in shed):
            raise AssertionError(f"12c: burst statuses {codes}")
        out["burst"] = {"200": codes.count(200), "429": codes.count(429),
                        "retry_after": sorted({b[2]["Retry-After"]
                                               for b in shed})}
        if counter_total("serving_shed_total", reason="queue_full") - \
                shed0 != len(shed):
            raise AssertionError("12c: serving_shed_total disagrees with "
                                 "the 429s")
        # one injected batch error: the batch is requeued once and every
        # request answered 200
        rq0 = counter_total("serving_requeues_total")
        failpoints.configure("serving.batch:error@1", seed=0)
        st, body, _ = http_call(srv.host, srv.port, "/higgs", bodies[5])
        failpoints.clear()
        if st != 200 or not wait_for(
                lambda: counter_total("serving_requeues_total") - rq0 == 1):
            raise AssertionError(f"12c: requeue step answered {st}, "
                                 f"requeues "
                                 f"{counter_total('serving_requeues_total')}")
        injected = counter_total("serving_batch_failures_total") - fails0
        if injected != 1:
            raise AssertionError(f"12c: {injected} batch failures, "
                                 "expected the one injected")
        out["requeues"] = counter_total("serving_requeues_total") - rq0
        # drain under load: the clients stop at deregistration (as a
        # gateway stops routing), the settle window lets their in-flight
        # requests finish, then the worker refuses and drains
        deregistered = threading.Event()
        result = {}
        loader = threading.Thread(target=lambda: result.update(
            load=serve_load(srv, "/higgs", bodies, 8, stop=deregistered)),
            daemon=True)
        loader.start()
        time.sleep(0.3)
        deregistered.set()
        stats = query.drain(settle_seconds=0.5, timeout=10)
        loader.join(15)
        st = [x for x in result["load"][0] if x is not None]
        if not stats["clean"] or not st or set(st) != {200}:
            raise AssertionError(f"12c: drain {stats}, statuses "
                                 f"{sorted(set(map(str, st)))}")
        out["drain"] = dict(stats, requests=len(st))
    finally:
        failpoints.clear()
        query.stop()
        os.environ.pop("MMLSPARK_TPU_PREDICT_DTYPE", None)
    if counter_total("serving_batch_failures_total") - fails0 != 1:
        raise AssertionError("12c: batch failures besides the injected one")
    log(f"phase 12c: /healthz ready on gpu; serving families on /metrics; "
        f"burst {out['burst']}; trace id echoed; requeues "
        f"{out['requeues']:.0f} with every reply 200; drain {out['drain']}")
    return out


def phase_serving(quantized, multiclass, Xh, card) -> dict:
    """Phase 12: the async engine on phase 4b's booster in the f32 and
    int8 lanes, the threaded engine on phase 6's model, the contract."""
    t0 = time.perf_counter()
    log(f"== phase 12: serving phase 4b's booster (async, f32 / int8) and "
        f"phase 6's model (threaded) over HTTP on localhost")
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    path = os.path.join(SERVE_DIR, "higgs_4b.npz")
    quantized.save(path)
    obs_metrics.reset()
    out = {"async": {lane: phase_async_lane(path, lane, Xh, card)
                     for lane in ("f32", "int8")}}
    t1 = time.perf_counter()
    out["threaded"] = phase_threaded(multiclass, card)
    t2 = time.perf_counter()
    out["contract"] = phase_contract(path, Xh)
    out["threaded"]["phase_s"] = t2 - t1
    out["contract"]["phase_s"] = time.perf_counter() - t2
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 12: {out['seconds']:.1f} s")
    return out


# phase 13: the predict plan's graphs, bundles, the worker and gateway
# roles, the checkpoint modes (files under the ignored build directory)
P13_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_p13")
P13_SIZES = (1, 7, 32, 100, 8192)
P13_EXACT_ROWS = 20_000
P13_CKPT_ROWS = 20_000
FLEET_CLIENTS, FLEET_REQUESTS = 16, 250
# requests per client of the load a worker is SIGTERM'd in
SIGTERM_REQUESTS = 100


def eager_scores(booster, X, it, lane, transformed, dev) -> np.ndarray:
    """The eager body on ``dev``: ``predict_raw_tensor``, then the
    objective's transform, read back."""
    raw = booster.predict_raw_tensor(torch.from_numpy(X).to(dev), it,
                                     predict_dtype=lane)
    if transformed:
        raw = score_transform(booster.objective, booster.num_class,
                              **booster.objective_kwargs)(raw)
    return raw.cpu().numpy()


def same_bits(a, b, what) -> None:
    if a.shape != b.shape or a.tobytes() != b.tobytes():
        d = (float(np.nanmax(np.abs(a - b))) if a.shape == b.shape
             else "shape")
        raise AssertionError(f"{what}: plan route differs from the eager "
                             f"body ({d})")


def phase_graphs(base, quantized, multiclass, Xh, Xc) -> dict:
    """Phase 13a: every predict through the plan against the eager body on
    the card, bit for bit."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    booster_mod._PREDICT_CACHE.clear()
    obs_metrics.reset()
    obs_flight.clear()
    keys, checked = set(), 0          # (device, plan key) pairs
    # two boosters of one key, in turn: each must score with its own trees
    # (first, so no later key evicts theirs between their calls)
    if base.predict_plan(32).key != quantized.predict_plan(32).key:
        raise AssertionError("13a: phases 4 and 4b's models should share "
                             "a plan key")
    want = {id(b): eager_scores(b, Xh[:32], -1, "f32", True, dev)
            for b in (base, quantized)}
    for _ in range(10):
        for b in (base, quantized):
            same_bits(b.predict(Xh[:32], device="cuda"), want[id(b)],
                      "13a two boosters of one key")
    keys.add(("cuda", base.predict_plan(32).key))
    if want[id(base)].tobytes() == want[id(quantized)].tobytes():
        raise AssertionError("13a: the two models score alike")
    for label, b, X in (("4b", quantized, Xh), ("6", multiclass, Xc)):
        half = max(1, b.num_iterations // 2)
        for lane in ("f32", "bf16", "int8"):
            for n in P13_SIZES:
                for it in (-1, half):
                    Xn = X[:n]
                    outs = [(True, b.predict(Xn, it, device="cuda",
                                             predict_dtype=lane))]
                    if lane == "f32":
                        outs.append((False, b.predict_raw(
                            Xn, it, device="cuda", predict_dtype=lane)))
                    for tr, got in outs:
                        keys.add(("cuda", b.predict_plan(
                            len(Xn), it, tr, predict_dtype=lane).key))
                        same_bits(got, eager_scores(b, Xn, it, lane, tr,
                                                    dev),
                                  f"13a {label} {lane} n={n} it={it} "
                                  f"transformed={tr}")
                        checked += 1
                    if lane == "f32":
                        cpu = b.predict_raw(Xn, it, device="cpu")
                        keys.add(("cpu", b.predict_plan(len(Xn), it,
                                                        False).key))
                        diff = float(np.abs(outs[1][1] - cpu).max())
                        if not diff <= 1e-5:
                            raise AssertionError(f"13a {label} n={n}: cuda "
                                                 f"{diff} off the cpu")
    # an exact-shape batch past the buckets runs the body eagerly
    Xe = Xh[:P13_EXACT_ROWS]
    same_bits(quantized.predict(Xe, device="cuda"),
              eager_scores(quantized, Xe, -1, "f32", True, dev),
              f"13a {P13_EXACT_ROWS}-row exact batch")
    keys.add(("cuda", quantized.predict_plan(len(Xe)).key))
    misses = counter_total("gbdt_predict_cache_misses_total")
    if misses != len(keys):
        raise AssertionError(f"13a: {misses} cache misses for {len(keys)} "
                             "distinct keys")
    compiles = [e for e in obs_flight.events() if e.get("kind") == "compile"]
    graphs = [e for e in compiles if e.get("graph")]
    caps = [e["seconds"] for e in graphs] or [float("nan")]
    out = dict(checked=checked, keys=len(keys), misses=misses,
               graphs=len(graphs), capture_s_mean=float(np.mean(caps)),
               capture_s_max=float(np.max(caps)),
               pinned_mib=sum(e["pinned_bytes"] for e in graphs) / 2**20,
               seconds=time.perf_counter() - t0)
    # every bucketed key on the card is a graph; the exact batch is not
    bucketed = sum(1 for d, k in keys if d == "cuda" and k[3] <= 8192)
    if torch.cuda.is_available() and len(graphs) != bucketed:
        raise AssertionError(f"13a: {len(graphs)} graphs for {bucketed} "
                             "bucketed keys")
    log(f"phase 13a: {checked} plan-route results bit-equal to the eager "
        f"body on the card ({len(keys)} keys, {misses:.0f} misses, "
        f"{len(graphs)} graphs captured: mean {out['capture_s_mean']:.4f} s,"
        f" max {out['capture_s_max']:.4f} s, pinning "
        f"{out['pinned_mib']:.1f} MiB); the {P13_EXACT_ROWS}-row batch "
        f"and two boosters of one key x 10 alike; {out['seconds']:.1f} s")
    return out


def runtime_calls(prof) -> dict:
    """CPU-side CUDA runtime calls a profiler window saw."""
    names = [e.name for e in prof.events()]
    return {"cudaLaunchKernel": sum(n.startswith("cudaLaunchKernel")
                                    for n in names),
            "cudaGraphLaunch": sum(n.startswith("cudaGraphLaunch")
                                   for n in names)}


def device_ms(prof) -> float:
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def batch_costs(call, calls=20) -> dict:
    """Host ms on the calling thread, runtime calls and device ms per call
    of ``call``."""
    from torch.profiler import ProfilerActivity, profile

    call()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    rc = runtime_calls(prof)
    return {"host_ms": host_ms,
            "launch_kernel": rc["cudaLaunchKernel"] / 10,
            "graph_launch": rc["cudaGraphLaunch"] / 10,
            "device_ms": device_ms(prof) / 10}


def phase_batch_costs(quantized, multiclass, Xh, Xc, card) -> dict:
    """Phase 13b: one 32-row batch of each model, as the scoring thread
    passes it (slot-table rows in the lane's staged dtype), through the
    eager body and through the plan's graph."""
    dev = torch.device("cuda")
    out = {}
    for label, b, X, lane in (("4b f32", quantized, Xh, "f32"),
                              ("4b int8", quantized, Xh, "int8"),
                              ("6 f32", multiclass, Xc, "f32")):
        rows = X[:SERVE_MAX_BATCH]
        bounds = (quantize.feature_bounds(b.binner_state)
                  if lane == "int8" else None)
        table = SlotTable(SERVE_MAX_BATCH, rows.shape[1],
                          quantize.staging_dtype(lane),
                          quantize.row_quantizer(lane, bounds),
                          pin_memory=torch.cuda.is_available())
        for i, x in enumerate(rows):
            table.write(i, x)
        view, _ = SlotTable.bucket_view(table.flip(), SERVE_MAX_BATCH)
        transform = score_transform(b.objective, b.num_class,
                                    **b.objective_kwargs)

        def eager():
            Xd = b._rows_on(view, dev, lane)
            return transform(b.predict_raw_tensor(
                Xd, -1, predict_dtype=lane)).cpu().numpy()

        def graph():
            return b.predict(view, device="cuda", predict_dtype=lane)

        same_bits(graph(), eager(), f"13b {label}")
        row = {"eager": batch_costs(eager), "graph": batch_costs(graph)}
        table.release_claim()
        g = row["graph"]
        if torch.cuda.is_available() and (g["graph_launch"] != 1
                                          or g["launch_kernel"] != 0):
            raise AssertionError(f"13b {label}: {g['graph_launch']} graph "
                                 f"launches and {g['launch_kernel']} kernel "
                                 "launches per call")
        out[label] = row
        e = row["eager"]
        log(f"phase 13b {label}, one 32-row batch: eager {e['host_ms']:.3f}"
            f" ms host, {e['launch_kernel']:.1f} cudaLaunchKernel, "
            f"{e['device_ms']:.3f} ms device; graph {g['host_ms']:.3f} ms "
            f"host, {g['graph_launch']:.1f} cudaGraphLaunch + "
            f"{g['launch_kernel']:.1f} cudaLaunchKernel, "
            f"{g['device_ms']:.3f} ms device; {card}")
    return out


class Proc:
    """A subprocess of this repository's entry points with one reader
    thread on its standard output."""

    def __init__(self, args, env=None):
        import queue
        self.lines: "queue.Queue" = queue.Queue()
        self.seen = []
        e = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        e.update(env or {})
        self.p = subprocess.Popen(
            [sys.executable, *args], env=e, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.p.stdout:
            self.lines.put(line)

    def wait_line(self, pattern, timeout=120.0) -> "re.Match":
        import queue
        import re
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            try:
                line = self.lines.get(timeout=0.5)
            except queue.Empty:
                if self.p.poll() is not None:
                    break
                continue
            self.seen.append(line)
            m = re.search(pattern, line)
            if m:
                return m
        raise AssertionError(f"no line {pattern!r} from {self.p.args}: "
                             f"{''.join(self.seen)[-3000:]}")

    def stop(self, sig=None, timeout=30.0):
        import signal
        if self.p.poll() is None:
            self.p.send_signal(sig or signal.SIGTERM)
        try:
            return self.p.wait(timeout)
        except subprocess.TimeoutExpired:
            self.p.kill()
            return self.p.wait(10)


def http_json(host, port, path):
    st, body, _ = http_call(host, port, path)
    if st != 200:
        raise AssertionError(f"GET {path} on {port}: {st}")
    return json.loads(body)


def metric_value(text, name, **labels) -> float:
    """Sum of a family's samples in an exposition that carry ``labels``."""
    from mmlspark_tpu_torch.observability.federation import \
        parse_prometheus_text
    fam = parse_prometheus_text(text).get(name)
    if fam is None:
        return 0.0
    return float(sum(v for lb, v in fam[1]
                     if all(lb.get(k) == x for k, x in labels.items())))


def start_worker(model, bundle, registry, port, extra_env=None) -> Proc:
    return Proc(["-m", "mmlspark_tpu_torch.io.serving_main", "worker",
                 "--model", model, "--registry", registry, "--engine",
                 "async", "--bundle", bundle, "--host", "localhost",
                 "--advertise-host", "localhost", "--port", str(port),
                 "--api-name", "higgs", "--max-batch", str(SERVE_MAX_BATCH),
                 "--device", "cuda"], env=extra_env)


def free_port(avoid=()) -> int:
    """A port that no socket holds now and that is not in ``avoid``. It is
    released on return, so another socket can take it before its user
    binds it."""
    import socket
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in avoid:
            return port


def healthz_while_starting(proc, port) -> list:
    """``/healthz``'s ``ready`` of a starting worker, polled until it says
    ready or the process ends (None while nothing answers)."""
    early = []
    while proc.p.poll() is None:
        try:
            early.append(json.loads(http_call(
                "localhost", port, "/healthz")[1])["ready"])
            if early[-1]:
                break
        except OSError:
            early.append(None)
        time.sleep(0.05)
    return early


def start_fleet(quantized) -> dict:
    """Phase 13c's first steps, started early so their interpreters come
    up while the card runs 13a and 13e: phase 4b's model saved as ``.npz``,
    ``bundles build`` for it (f32 and int8, the 32-row cap) and the
    gateway over an empty file registry."""
    shutil.rmtree(P13_DIR, ignore_errors=True)
    os.makedirs(P13_DIR)
    model = os.path.join(P13_DIR, "higgs_4b.npz")
    quantized.save(model)
    bundle = os.path.join(P13_DIR, "higgs_4b.bundle")
    registry = os.path.join(P13_DIR, "registry")
    gw_port = free_port()
    gateway = Proc(["-m", "mmlspark_tpu_torch.io.serving_main", "gateway",
                    "--registry", registry, "--host", "localhost",
                    "--port", str(gw_port), "--api-name", "higgs"],
                   env={"MMLSPARK_TPU_FEDERATION_INTERVAL_SECONDS": "0.3"})
    build = Proc(["-m", "mmlspark_tpu_torch.bundles", "build", "--model",
                  model, "--out", bundle, "--max-batch",
                  str(SERVE_MAX_BATCH), "--predict-dtypes", "f32,int8",
                  "--device", "cuda"])
    return dict(model=model, bundle=bundle, registry=registry,
                gw_port=gw_port, gateway=gateway, build=build,
                t0=time.perf_counter())


def in_process_fleet(quantized, Xh) -> float:
    """Phase 13d's last step: two in-process workers on one Booster under
    16 concurrent clients; every reply must be the eager body's (the
    per-entry lock keeps concurrent replays of one program apart).
    Returns requests/s."""
    from mmlspark_tpu_torch.io.distributed_serving import DistributedServing
    eager = eager_scores(quantized, Xh[:800], -1, "f32", True,
                         torch.device("cuda"))

    def transform(ds):
        r = np.asarray([v["features"] for v in ds["value"]], np.float32)
        return ds.with_column("reply", [
            {"entity": {"p": float(p)}, "statusCode": 200}
            for p in quantized.predict(r, device="cuda")])

    d = DistributedServing(transform, num_workers=2,
                           api_name="higgs").start()
    try:
        st, replies, _, secs = serve_load(d.gateway, "/higgs",
                                          row_bodies(Xh[:800]), 16)
    finally:
        d.stop()
    got = np.asarray([json.loads(r)["p"] for r in replies], np.float32)
    # bit for bit on the card, where an elementwise result does not
    # depend on a row's place in its batch; the CPU's vectorized loops
    # round a row by its place (an ulp), so a rehearsal holds 1e-6
    same = (got.tobytes() == eager.tobytes() if torch.cuda.is_available()
            else float(np.abs(got - eager).max()) <= 1e-6)
    if set(st) != {200} or not same:
        raise AssertionError("13d: in-process workers on one Booster "
                             "differ from the eager body")
    return len(st) / secs


def phase_fleet(quantized, Xh, fleet, card) -> dict:
    """Phases 13c and 13d: two bundled async workers (the second on a copy
    of the bundle whose fingerprint was edited) behind the gateway, phase
    12's load through it, the load again with one worker SIGTERM'd
    mid-load; two in-process workers on one Booster while the two start."""
    t0 = fleet["t0"]
    model, bundle = fleet["model"], fleet["bundle"]
    registry, gw_port = fleet["registry"], fleet["gw_port"]
    gateway, build = fleet["gateway"], fleet["build"]
    procs = [gateway, build]
    out = {}
    try:
        build.wait_line(r"bundle written")
        if build.p.wait(120) != 0:
            raise AssertionError("13c: bundles build failed")
        manifest = json.load(open(os.path.join(bundle, "MANIFEST.json")))
        entries = len(manifest["entries"])
        skewed = bundle + ".skewed"
        shutil.copytree(bundle, skewed)
        manifest["fingerprint"]["torch_version"] = "0.0.0-edited"
        with open(os.path.join(skewed, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        ports = [free_port({gw_port})]
        ports.append(free_port({gw_port, ports[0]}))
        bundles = [bundle, skewed]
        t_start = time.perf_counter()
        workers = [start_worker(model, b, registry, port)
                   for b, port in zip(bundles, ports)]
        procs += workers
        out["in_process_requests_per_s"] = in_process_fleet(quantized, Xh)
        ids = []
        for i in (0, 1):
            for again in (False, True):
                if i == 0:
                    # /healthz while the first worker comes up: never
                    # ready before its prewarm is done (the socket binds
                    # after it)
                    early = healthz_while_starting(workers[0], ports[0])
                try:
                    ids.append(workers[i].wait_line(
                        r"worker (\w+) serving on").group(1))
                    break
                except AssertionError:
                    if again or not any("address already in use" in x
                                        for x in workers[i].seen):
                        raise
                # another socket took the port in the seconds between
                # free_port and the worker's bind: start it once more
                log(f"13c: port {ports[i]} was taken before worker {i} "
                    f"bound it; starting the worker again on another")
                ports[i] = free_port({gw_port, *ports})
                workers[i] = start_worker(model, bundles[i], registry,
                                          ports[i])
                procs.append(workers[i])
        out["worker_start_s"] = time.perf_counter() - t_start
        gateway.wait_line(r"gateway on")
        ring = http_json("localhost", ports[0], "/debug/flight")["events"]
        done = [e for e in ring if e.get("kind") == "bundle"
                and e.get("event") == "prewarm_complete"]
        loaded = [e for e in ring if e.get("kind") == "bundle"
                  and e.get("event") == "entry_loaded"]
        if (not done or done[0]["entries_loaded"] != entries
                or len(loaded) != entries or True in early[:-1]
                or early[-1] is not True):
            raise AssertionError(f"13c: prewarm {done} ({len(loaded)} of "
                                 f"{entries} loaded), healthz {early}")
        if any(e.get("kind") == "compile" for e in ring):
            raise AssertionError("13c: the bundled worker captured online")
        ring1 = http_json("localhost", ports[1], "/debug/flight")["events"]
        skew = [e for e in ring1 if e.get("kind") == "bundle"
                and e.get("event") == "fingerprint_mismatch"]
        if not skew or not any("torch_version" in m
                               for m in skew[0]["mismatches"]):
            raise AssertionError("13c: the edited bundle did not degrade "
                                 "loudly")
        metrics0 = [http_call("localhost", p, "/metrics")[1].decode()
                    for p in ports]
        # 13d: phase 12's async f32 load through the gateway
        gw = types.SimpleNamespace(host="localhost", port=gw_port)
        rows = Xh[:FLEET_CLIENTS * FLEET_REQUESTS]
        bodies = row_bodies(rows)
        st, replies, lat, secs = serve_load_process(gw, "/higgs", bodies,
                                                    FLEET_CLIENTS)
        bad = [x for x in st if x != 200]
        if bad:
            raise AssertionError(f"13d: {len(bad)} replies were not 200")
        got = np.asarray([json.loads(r)["prediction"] for r in replies])
        diff = float(np.abs(got - quantized.predict(rows,
                                                    device="cuda")).max())
        if not diff <= 1e-6:
            raise AssertionError(f"13d: replies {diff} off predict")
        lat = np.asarray(lat)
        out["fleet"] = dict(requests_per_s=len(st) / secs, seconds=secs,
                            p50_ms=float(np.percentile(lat, 50) * 1e3),
                            p99_ms=float(np.percentile(lat, 99) * 1e3),
                            max_abs_vs_predict=diff)
        metrics1 = [http_call("localhost", p, "/metrics")[1].decode()
                    for p in ports]
        comp = [metric_value(m, "gbdt_compiles_total") for m in metrics0 +
                metrics1]
        if comp[0] != comp[2]:
            raise AssertionError(f"13c: the bundled worker compiled under "
                                 f"load ({comp})")
        out["compiles"] = comp
        served = [metric_value(m, "serving_responses_total", code="200")
                  for m in metrics1]
        if min(served) <= 0:
            raise AssertionError(f"13d: a worker served nothing {served}")

        def federated():
            text = http_call("localhost", gw_port, "/metrics")[1].decode()
            return all(f'worker="localhost:{p}"' in text and
                       "cluster_serving_responses_total" in text
                       for p in ports)

        if not wait_for(federated, timeout=10):
            raise AssertionError("13d: the gateway's /metrics lacks a "
                                 "worker's families")
        # one worker SIGTERM'd mid-load: no client-visible error
        import signal
        killer = threading.Timer(0.5, lambda: workers[1].p.send_signal(
            signal.SIGTERM))
        killer.start()
        st, _, lat, secs = serve_load_process(
            gw, "/higgs", bodies[:FLEET_CLIENTS * SIGTERM_REQUESTS],
            FLEET_CLIENTS)
        killer.join()
        bad = [x for x in st if x != 200]
        drained = workers[1].wait_line(r"worker \w+ drained", timeout=60)
        if bad or workers[1].p.wait(30) != 0 or not drained:
            raise AssertionError(f"13d: {len(bad)} errors through the "
                                 "SIGTERM")
        out["sigterm"] = dict(requests=len(st), seconds=secs,
                              requests_per_s=len(st) / secs)
        out["worker_ids"] = ids
    finally:
        for p in procs:
            p.stop()
    out["seconds"] = time.perf_counter() - t0
    f = out["fleet"]
    log(f"phase 13c: bundle of {entries} plans; bundled worker ready after "
        f"its prewarm (healthz {early[-3:]}), no capture under load "
        f"(gbdt_compiles_total {comp}); the edited bundle degraded loudly "
        f"and served correctly")
    log(f"phase 13d: gateway over 2 workers: {f['requests_per_s']:,.1f} "
        f"requests/s, client p50 {f['p50_ms']:.3f} ms p99 "
        f"{f['p99_ms']:.3f} ms, replies vs predict {diff:.3g}; SIGTERM "
        f"mid-load: {out['sigterm']['requests']} replies all 200; both "
        f"workers' families on the gateway's /metrics; in-process workers "
        f"on one Booster bit-equal to eager "
        f"({out['in_process_requests_per_s']:,.1f} requests/s); "
        f"{out['seconds']:.1f} s; {card}")
    return out


def phase_checkpoint_modes(X, y, Xh, yh) -> dict:
    """Phase 13e: strict resume against a mismatched checkpoint, and an
    emergency checkpoint of the last good round on an injected NaN
    validation loss, on the card at 20,000 rows."""
    t0 = time.perf_counter()
    X, y = X[:P13_CKPT_ROWS], y[:P13_CKPT_ROWS]
    valid = (Xh[:5_000], yh[:5_000], None)
    d = os.path.join(P13_DIR, "ckpt")
    shutil.rmtree(d, ignore_errors=True)

    def fit(directory, leaves=31, **kw):
        return train_booster(X, y, objective="binary", max_bin=255,
                             cfg=GrowConfig(num_leaves=leaves),
                             checkpoint_dir=directory, device="cuda", **kw)

    fit(d, num_iterations=4, checkpoint_period=2)
    os.environ["MMLSPARK_TPU_STRICT_RESUME"] = "1"
    try:
        fit(d, leaves=15, num_iterations=4, checkpoint_period=2)
        raise AssertionError("13e: strict resume trained a mismatched run")
    except CheckpointMismatchError:
        pass
    finally:
        os.environ.pop("MMLSPARK_TPU_STRICT_RESUME", None)
    real = obs_watchdog.report_training_metric

    def report(model, iteration, loss=None, **kw):
        if loss is not None and iteration == 3:
            loss = float("nan")
        return real(model, iteration, loss=loss, **kw)

    d2 = os.path.join(P13_DIR, "ckpt_emergency")
    shutil.rmtree(d2, ignore_errors=True)
    os.environ["MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY"] = "1"
    obs_watchdog.report_training_metric = report
    try:
        whole = fit(d2, num_iterations=6, checkpoint_period=100,
                    valid_set=valid)
    finally:
        obs_watchdog.report_training_metric = real
        os.environ.pop("MMLSPARK_TPU_CHECKPOINT_ON_UNHEALTHY", None)
    mgr = CheckpointManager(d2)
    if len(mgr.steps()) != 1:
        raise AssertionError(f"13e: checkpoints {mgr.steps()}")
    step, payload = mgr.latest()
    if (step, payload.get("emergency"), payload.get("reason")) != \
            (2, True, "nan_loss"):
        raise AssertionError(f"13e: emergency checkpoint {step} "
                             f"{payload.get('reason')}")
    resumed = fit(d2, num_iterations=3, checkpoint_period=100,
                  valid_set=valid)
    dumped = Booster.from_string(payload["model"])
    for f in ("feat", "thr_bin", "left", "right", "is_leaf", "leaf_value"):
        if not (np.array_equal(resumed.trees[f], dumped.trees[f])
                and np.array_equal(dumped.trees[f], whole.trees[f][:3])):
            raise AssertionError(f"13e: resumed trees differ in {f}")
    out = {"seconds": time.perf_counter() - t0, "emergency_step": step}
    log(f"phase 13e: strict resume raised CheckpointMismatchError; the "
        f"injected NaN at round 3 wrote one emergency checkpoint (step "
        f"{step}, nan_loss) that resumes to its trees; "
        f"{out['seconds']:.1f} s")
    return out


def phase_plan_and_fleet(base, quantized, multiclass, data, card) -> dict:
    """Phase 13: the predict plan's graphs against the eager body, the
    costs of one batch both ways, bundles and the worker and gateway
    roles, the trainer's checkpoint modes."""
    t0 = time.perf_counter()
    X, y, Xh, yh = data
    log("== phase 13: the predict plan as CUDA graphs (phases 4, 4b and "
        "6's models), bundles, a gateway fleet, the checkpoint modes")
    Xc, _ = covertype_shaped(P13_EXACT_ROWS, seed=3)
    mc = multiclass.booster
    # 13b first, with nothing else on the host; the bundle build and the
    # gateway then start while the card runs 13a and 13e
    out = {"batch": phase_batch_costs(quantized, mc, Xh, Xc, card)}
    fleet = start_fleet(quantized)
    try:
        out["graphs"] = phase_graphs(base, quantized, mc, Xh, Xc)
        out["checkpoint"] = phase_checkpoint_modes(X, y, Xh, yh)
    except BaseException:
        for p in (fleet["gateway"], fleet["build"]):
            p.stop()
        raise
    out["fleet"] = phase_fleet(quantized, Xh, fleet, card)
    shutil.rmtree(P13_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 13: {out['seconds']:.1f} s")
    return out


# phase 14: the data group's paths. HIST_BLOCKS is the canonical block
# count of 14a's fits; P14_DIR holds its processes' files (ignored build
# directory); P14_SEED seeds the deterministic mode's inputs, the same in
# this process and in the two ranks
HIST_BLOCKS = 8
P14_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_p14")
P14_SEED = 1414
P14_CHILD_TIMEOUT = 300

# a rank of 14a's world-size-2 fit: joins gloo through a file rendezvous,
# runs the deterministic mode on P14_SEED's inputs, and fits phase 4's
# rows both ways under MMLSPARK_TPU_HIST_BLOCKS=8; writes the digests
RANK_SRC = r"""
import hashlib, json, os, sys, time
root, rank, world, init, n, device, out = sys.argv[1:8]
rank, world, n = int(rank), int(world), int(n)
sys.path.insert(0, root)
os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = "8"
import numpy as np
import torch
from chip_smoke import P14_SEED, higgs_shaped, hist_inputs
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.cyber import anomaly as anomaly_mod
from mmlspark_tpu_torch.cyber.anomaly import AccessAnomaly
from mmlspark_tpu_torch.cyber.dataset import DataFactory
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.ops import histogram as hist_ops
from mmlspark_tpu_torch.parallel import distributed
distributed.initialize(init, world, rank, backend="gloo", device=device)
res = {}
gen = torch.Generator(device=device).manual_seed(P14_SEED)
b, p, s = hist_inputs(gen, n, 28, 16, 255)
h = hist_ops.node_histogram(b, p, s, 16, 255, blocks=8)
res["det"] = hashlib.sha256(h.cpu().numpy().tobytes()).hexdigest()
del b, p, s, h
X, y = higgs_shaped(n, seed=0)
for name, params in (("bf16", {}), ("quantized", dict(
        useQuantizedGrad=True, quantWarmupIters=0))):
    t0 = time.perf_counter()
    m = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                           device=device, **params).fit(
        Dataset({"features": X, "label": y}))
    res[name] = hashlib.sha256(m.booster.model_string().encode()).hexdigest()
    res[name + "_s"] = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
"""

# 14d in a fresh process: unpickles two boosters of one plan key and
# scores each (the first captures the key's graph on a card), holding
# each to its eager result from the process that pickled them; with
# CUDA hidden it unpickles the second and scores it on the CPU
PICKLE_SRC = r"""
import json, os, pickle, sys
import numpy as np
import torch
root, d, device, mode = sys.argv[1:5]
sys.path.insert(0, root)
with open(os.path.join(d, "boosters.pkl"), "rb") as f:
    blobs = pickle.load(f)
want = np.load(os.path.join(d, "want.npz"))
X = want["X"]
out = {"cuda_available": torch.cuda.is_available()}
if mode == "alone":
    b = pickle.loads(blobs["quantized"])
    got = b.predict(X, device=device)
    out["quantized"] = bool(got.tobytes() == want["quantized_cpu"].tobytes())
else:
    for name in ("base", "quantized", "base"):
        b = pickle.loads(blobs[name])
        got = b.predict(X, device=device)
        out[name] = bool(got.tobytes() == want[name].tobytes())
print(json.dumps(out), flush=True)
"""


def det_bound_ms(binned, pos, base, W, B, blocks) -> tuple:
    """The deterministic mode's bound: kernel 1's bytes, with one output
    per block, against 3 adds per (valid row, feature) at the f32 rate."""
    F, n = binned.shape
    nbytes = (binned.numel() * binned.element_size() + pos.numel() * 4
              + base.numel() * 4 + blocks * F * 3 * W * B * 4)
    return bound_ms(nbytes, 3.0 * F * int((pos >= 0).sum()),
                    PEAK_F32_OPS_PER_S)


def det_library(binned, pos, base, W, B, blocks):
    """The yardstick of the blocked function: one ``index_add_`` with the
    blocks as ``blocks * W`` nodes."""
    return library_index_add(binned, blocks_as_nodes(pos, W, blocks), base,
                             blocks * W, B)


def phase_det_kernel() -> tuple:
    """14a's kernel checks: the deterministic mode at the blocked fit's
    two passes (the root, W=1; leafwise's children, W=16), n = phase 4's
    rows, F=28, B=255, 8 blocks: bit for bit against its plain version
    (:func:`node_hist_det_plain`, the same fixed-point sums), within the
    kernel-vs-plain contract of the f32 blocked plain version
    (``node_hist_blocked_plain``), and bit for bit against itself over 20
    launches; kernel 2's blocked route on the same inputs
    (:func:`check_blocked_int8`); first the shift edges
    (:func:`check_det_edges`). Returns (rows by W, max error against the
    f32 plain version, the W=16 result's digest)."""
    import hashlib
    log("== phase 14a: node_hist_det (kernel 1's deterministic mode) vs "
        f"plain, and vs itself over 20 launches; n={HIGGS_ROWS}, F=28, "
        f"B=255, {HIST_BLOCKS} blocks")
    rows, max_err, digest = {}, 0.0, None
    check_det_edges()
    for W in (1, 16):
        gen = torch.Generator(device="cuda").manual_seed(P14_SEED)
        binned, pos, base = hist_inputs(gen, HIGGS_ROWS, 28, W, 255)

        def call():
            return hist_ops.node_histogram(binned, pos, base, W, 255,
                                           blocks=HIST_BLOCKS)
        want = node_hist_blocked_plain(binned, pos, base, W, 255,
                                       HIST_BLOCKS)
        first = call()
        exact = node_hist_det_plain(binned, pos, base, W, 255, HIST_BLOCKS)
        torch.cuda.synchronize()
        if not torch.equal(first, exact):
            bad = int((first != exact).sum())
            raise AssertionError(f"node_hist_det W={W}: {bad} cells differ "
                                 "from node_hist_det_plain")
        err = max(check_hist(first[j], want[j]) for j in range(HIST_BLOCKS))
        max_err = max(max_err, err)
        for i in range(20):
            if not torch.equal(call(), first):
                raise AssertionError(f"node_hist_det W={W}: launch {i + 1} "
                                     "differs from the first")
        if W == 16:
            digest = hashlib.sha256(first.cpu().numpy().tobytes()).hexdigest()
        int8_blocked = check_blocked_int8(binned, pos, base, W)
        ms, cold = time_ms(call, reps=20), time_cold_ms(call)
        k1 = time_ms(lambda: hist_ops.node_histogram(binned, pos, base, W,
                                                     255), reps=20)
        plain_ms = time_ms(lambda: node_hist_det_plain(
            binned, pos, base, W, 255, HIST_BLOCKS), reps=3, warm=1)
        lib = time_ms(det_library(binned, pos, base, W, 255, HIST_BLOCKS),
                      reps=5, warm=1)
        bound, by = det_bound_ms(binned, pos, base, W, 255, HIST_BLOCKS)
        geo = hist_ops._det_geometry(HIGGS_ROWS // HIST_BLOCKS, 28, W, 255,
                                     HIST_BLOCKS)
        rows[W] = dict(ms=ms, ms_cold=cold, plain_ms=plain_ms,
                       library_ms=lib, bound_ms=bound, bound_by=by,
                       kernel1_ms=k1, max_abs_err=err,
                       int8_blocked=int8_blocked)
        log(f"node_hist_det W={W}: {geo}; {ms:.4f} ms per launch warm, "
            f"{cold:.4f} L2 cold, against kernel 1's {k1:.4f} ms at this "
            f"shape; bound {bound * 1e3:.1f} us ({by}, "
            f"{100 * bound / ms:.1f}%); plain (node_hist_det_plain) "
            f"{plain_ms:.3f} ms; index_add_ {lib:.3f} ms; bit-equal to "
            f"node_hist_det_plain; max_abs_err {err:.3g} against "
            "node_hist_blocked_plain; bit-equal over 20 launches")
        del binned, pos, base, want, first, exact
    return rows, max_err, digest


# (rows, blocks, W) of the shift-edge checks: each cluster owning its item
# (single blocks; clusters of 4), and int64 partials with a finish launch
# (clusters of 2, three to an item)
DET_EDGE_SHAPES = ((4096, 6, 3), (32768, 6, 1), (65536, 6, 1))


def check_det_edges() -> None:
    """The deterministic mode where its shifts (computed on the card from
    each block's largest |stat|) meet their edges: a block of zeros, a
    subnormal largest value, a finite value that rounds to inf in bf16, an
    inf, a NaN (in the hess channel of blocks 0-4), bit for bit against
    ``node_hist_det_plain`` with NaN where it has NaN, at each of
    ``DET_EDGE_SHAPES``: both of the kernel's flush routes, the clusters'
    conversion and the finish launch's."""
    B, routes = 255, set()
    for rows, blocks, W in DET_EDGE_SHAPES:
        geo = hist_ops._det_geometry(rows, 28, W, B, blocks)
        staged = hist_ops._det_staged(geo)
        routes.add(staged)
        gen = torch.Generator(device="cuda").manual_seed(P14_SEED + 1)
        binned, pos, base = hist_inputs(gen, rows * blocks, 28, W, B)
        hess = base[1].view(blocks, rows)
        hess[0] = 0.0
        hess[1] *= 3e-39
        hess[2, 3] = 3.4e38
        hess[3, 5] = -float("inf")
        hess[4, 7] = float("nan")
        got = hist_ops.node_histogram(binned, pos, base, W, B, blocks=blocks)
        want = node_hist_det_plain(binned, pos, base, W, B, blocks)
        torch.cuda.synchronize()
        nan = want.isnan()
        route = ("int64 partials and a finish launch" if staged else
                 "each cluster owning its item")
        if not (torch.equal(got.isnan(), nan) and torch.equal(got[~nan],
                                                              want[~nan])):
            raise AssertionError(
                f"node_hist_det differs from node_hist_det_plain at the "
                f"shift edges ({rows} rows x {blocks} blocks, W={W}; {route})")
        log(f"node_hist_det at the shift edges (zero, subnormal, bf16 "
            f"overflow, inf, NaN blocks), {rows} rows x {blocks} blocks, "
            f"W={W}, clusters of {geo.cluster}, {geo.row_blocks} row blocks "
            f"an item ({route}): bit-equal to node_hist_det_plain, "
            f"{int(nan.sum())} NaN cells")
    if routes != {False, True}:
        raise AssertionError("the shift-edge shapes no longer take both of "
                             "node_hist_det's flush routes: choose others")


def check_blocked_int8(binned, pos, base, W) -> dict:
    """Kernel 2's blocked route (``node_histogram(..., scales=,
    blocks=8)``: one launch over the blocks as ``8 W`` nodes, permuted back
    and dequantized) bit for bit against its plain version, the per-block
    int32 sums times the scales, on ``base`` quantized at the blocked
    ``q_max`` (from the rows per block, as a blocked fit quantizes).
    Returns the times of its launch (kernel 2 at ``8 W`` nodes, warm and
    L2 cold), the plain version, the ``index_add_`` yardstick and the
    bound."""
    B, blocks = 255, HIST_BLOCKS
    q, scales = hist_ops.quantize_stats(base, q_max=hist_ops.quant_q_max(
        binned.shape[1] // blocks))
    before = hist_ops.node_histogram.int8_launches
    got = hist_ops.node_histogram(binned, pos, q, W, B, scales=scales,
                                  blocks=blocks)
    if hist_ops.node_histogram.int8_launches != before + 1:
        raise AssertionError("the blocked quantized route did not launch "
                             "kernel 2 once")
    chan = scales[torch.arange(3 * W, device=scales.device) % 3]
    want = node_hist_blocked_plain(
        binned, pos, q, W, B, blocks, acc_dtype=torch.int32
    ).to(torch.float32) * chan[None, None, :, None]
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else -1
        raise AssertionError(f"kernel 2 blocked W={W}: {bad} cells differ "
                             "from the per-block int32 plain version")
    nodes = blocks_as_nodes(pos, W, blocks)
    rows = binned.shape[1] // blocks

    def launch():
        return hist_ops._node_hist_int8_cuda(binned, nodes, q, blocks * W, B,
                                             cell_rows=rows)
    bound, by = node_bound_ms(binned, nodes, q, blocks * W, B)
    r = dict(ms=time_ms(launch, reps=20), ms_cold=time_cold_ms(launch),
             plain_ms=time_ms(lambda: node_hist_blocked_plain(
                 binned, pos, q, W, B, blocks, acc_dtype=torch.int32),
                 reps=3, warm=1),
             library_ms=time_ms(library_index_add(binned, nodes, q,
                                                  blocks * W, B), reps=5,
                                warm=1),
             bound_ms=bound, bound_by=by)
    log(f"node_hist_int8 blocked W={W} ({blocks * W} nodes in one launch): "
        f"bit-equal to the per-block int32 plain version; kernel 2 at "
        f"{blocks * W} nodes {r['ms']:.4f} ms warm, {r['ms_cold']:.4f} L2 "
        f"cold; bound {bound * 1e3:.1f} us ({by}, "
        f"{100 * bound / r['ms']:.1f}%); plain {r['plain_ms']:.3f} ms; "
        f"index_add_ {r['library_ms']:.3f} ms")
    return r


def run_ranks(world: int, n: int, device: str) -> list:
    """14a's world-size-``world`` fit: ``world`` processes of ``RANK_SRC``
    joined through a file rendezvous under ``P14_DIR``. Returns each
    rank's record."""
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(P14_DIR, ignore_errors=True)
    os.makedirs(P14_DIR)
    init = f"file://{P14_DIR}/rendezvous"
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("MMLSPARK_TPU_BINNED_CACHE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SRC, root, str(r), str(world), init,
         str(n), device, os.path.join(P14_DIR, f"rank{r}.json")],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    failed = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=P14_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} of {world} timed out")
        if p.returncode != 0:
            failed.append(f"rank {r}: rc {p.returncode}\n{out[-3000:]}")
    if failed:
        raise AssertionError("\n".join(failed))
    recs = []
    for r in range(world):
        with open(os.path.join(P14_DIR, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def phase_blocked_fits(data) -> dict:
    """14a: phase 4's fit and its quantized one (stochastic rounding on,
    warmup 0) under ``MMLSPARK_TPU_HIST_BLOCKS=8`` (the estimator's
    ``hist_blocks`` resolves it): each through its kernel (the
    deterministic mode; kernel 2) alone, AUC floor; twice in this process,
    byte-equal; and at world size 2 (two processes on this card, gloo),
    byte-equal to these."""
    import hashlib
    out = {}
    rows, det_err, det_digest = phase_det_kernel()
    out["det_rows"], out["det_err"] = rows, det_err
    os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = str(HIST_BLOCKS)
    try:
        digests = {}
        for name, needs, params in (
                ("bf16", "node_hist_det", {}),
                ("quantized", "node_hist_int8",
                 dict(useQuantizedGrad=True, quantWarmupIters=0))):
            rec, b1 = phase_end_to_end(f"14a {name}", [needs], data,
                                       **params)
            others = [k for k in ("node_hist_bf16", "node_hist_int8",
                                  "node_hist_det") if k != needs]
            if any(rec["counts"][k] for k in others):
                raise AssertionError(f"14a {name}: other kernels ran: "
                                     f"{rec['counts']}")
            again = phase_end_to_end(f"14a {name} again", [needs], data,
                                     **params)[1]
            if again.model_string() != b1.model_string():
                raise AssertionError(f"14a {name}: two fits in one process "
                                     "differ")
            digests[name] = hashlib.sha256(
                b1.model_string().encode()).hexdigest()
            out[name] = rec
            log(f"14a {name}: fit {rec['fit_s']:.3f} s, "
                f"{rec['counts'][needs]} launches of {needs} per fit; two "
                "fits byte-equal")
        phase_small_agreement("14a", needs=("node_hist_det",))
        phase_small_agreement("14a", needs=("node_hist_int8",),
                              useQuantizedGrad=True, quantWarmupIters=0)
    finally:
        del os.environ["MMLSPARK_TPU_HIST_BLOCKS"]
    t0 = time.perf_counter()
    ranks = run_ranks(2, len(data[1]), "cuda")
    for r, rec in enumerate(ranks):
        if rec["det"] != det_digest:
            raise AssertionError(f"rank {r}: node_hist_det differs from this "
                                 "process's on the same inputs")
        for name, want in digests.items():
            if rec[name] != want:
                raise AssertionError(f"rank {r}: the world-size-2 {name} fit "
                                     "differs from the world-size-1 fit")
    out["world2_s"] = time.perf_counter() - t0
    out["world2_fit_s"] = {k: [r[k + "_s"] for r in ranks]
                           for k in digests}
    log(f"14a: world size 2 (two processes on the card, gloo): both fits "
        f"byte-equal to world size 1 on both ranks, node_hist_det bit-equal "
        f"across processes; fit s {out['world2_fit_s']}; "
        f"{out['world2_s']:.1f} s")
    return out


def phase_voting(multiclass) -> dict:
    """14b: phase 6's fit with ``parallelism="voting_parallel"``,
    ``topK=20``: 40 of the 54 features reach each split search, so the
    trees differ from phase 6's; phase 6's floors hold. Then 20,000 of its
    rows on cuda against cpu."""
    rec, model = phase_multiclass("14b", parallelism="voting_parallel",
                                  topK=20)
    t_v, t_6 = model.booster.trees, multiclass.booster.trees
    changed = int((t_v["feat"] != t_6["feat"]).any(axis=1).sum())
    log(f"14b: {changed} of {len(t_v['feat'])} trees differ from phase 6's")
    if changed == 0:
        raise AssertionError("voting grew phase 6's trees")
    X, y = covertype_shaped(20_000, seed=4)
    phase_small_agreement("14b", LightGBMClassifier,
                          cols={"features": X, "label": y},
                          needs=("node_hist_bf16",),
                          parallelism="voting_parallel", topK=20)
    return dict(rec, trees_changed=changed)


def phase_telemetry(data) -> dict:
    """14c: phase 4's fit with metrics on publishes the fit's families and
    the stage spans; under ``MMLSPARK_TPU_BINNED_CACHE=0`` the cache stays
    empty."""
    obs_metrics.reset()
    os.environ["MMLSPARK_TPU_BINNED_CACHE"] = "0"
    try:
        rec, _ = phase_end_to_end("14c", ["node_hist_bf16"], data)
    finally:
        del os.environ["MMLSPARK_TPU_BINNED_CACHE"]
    snap = obs_metrics.get_registry().snapshot()

    def series(name):
        return {json.dumps(s["labels"], sort_keys=True): s
                for s in snap.get(name, {}).get("series", [])}
    model = json.dumps({"model": "LightGBMClassifier"})
    fits = series("gbdt_fits_total").get(model, {}).get("value")
    iters = series("gbdt_trained_iterations").get(model, {}).get("value")
    names = {json.loads(k)["name"] for k in series("span_duration_seconds")}
    rows_in = series("stage_rows_in_total").get(json.dumps(
        {"op": "fit", "stage": "LightGBMClassifier"}), {}).get("value")
    log(f"14c: gbdt_fits_total {fits}, gbdt_trained_iterations {iters}, "
        f"stage rows in {rows_in}, spans {sorted(names)}; binned cache "
        f"entries {len(gbdt_api._BINNED_CACHE)}")
    want = {"LightGBMClassifier", "LightGBMClassificationModel",
            "LightGBMClassifier.train_booster"}
    if fits != 1 or iters != 10 or rows_in != len(data[1]) or \
            not want <= names:
        raise AssertionError("14c: the fit's telemetry is missing")
    if gbdt_api._BINNED_CACHE:
        raise AssertionError("MMLSPARK_TPU_BINNED_CACHE=0 left a cached "
                             "dataset")
    return rec


def phase_pickle(base, quantized, Xh) -> dict:
    """14d: phases 4's and 4b's boosters (one plan key), scored on the card
    and pickled; a fresh process unpickles and scores them in turn (the
    first captures the key's graph there), each bit-equal to its own eager
    result; a process without CUDA unpickles 4b's and scores it on the CPU
    bit-equal to this process's CPU result."""
    import pickle
    root = os.path.dirname(os.path.abspath(__file__))
    X = np.ascontiguousarray(Xh[:32])
    dev = torch.device("cuda")
    if base.predict_plan(32).key != quantized.predict_plan(32).key:
        raise AssertionError("phases 4 and 4b have other plan keys")
    want = {"X": X}
    for name, b in (("base", base), ("quantized", quantized)):
        b.predict(X, device="cuda")
        want[name] = eager_scores(b, X, -1, "f32", True, dev)
    want["quantized_cpu"] = quantized.predict(X, device="cpu")
    shutil.rmtree(P14_DIR, ignore_errors=True)
    os.makedirs(P14_DIR)
    with open(os.path.join(P14_DIR, "boosters.pkl"), "wb") as f:
        pickle.dump({"base": pickle.dumps(base),
                     "quantized": pickle.dumps(quantized)}, f)
    np.savez(os.path.join(P14_DIR, "want.npz"), **want)
    out = {}
    for label, device, mode in (("fresh", "cuda", "turns"),
                                ("no_cuda", "cpu", "alone")):
        env = dict(os.environ, PYTHONPATH=root)
        hide = mode == "alone"
        if hide:
            env["CUDA_VISIBLE_DEVICES"] = ""
        r = subprocess.run([sys.executable, "-c", PICKLE_SRC, root, P14_DIR,
                            device, mode], env=env, cwd=root,
                           capture_output=True, text=True,
                           timeout=P14_CHILD_TIMEOUT)
        if r.returncode != 0:
            raise AssertionError(f"14d {label}: rc {r.returncode}\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        if hide and res.pop("cuda_available"):
            raise AssertionError("14d: CUDA was visible in the CPU process")
        res.pop("cuda_available", None)
        if not all(res.values()):
            raise AssertionError(f"14d {label}: not bit-equal: {res}")
        out[label] = res
    shutil.rmtree(P14_DIR, ignore_errors=True)
    log(f"14d: unpickled in a fresh process, phases 4's and 4b's boosters "
        f"score bit-equal to their eager results in turn {out['fresh']}; "
        f"4b's unpickles and scores in a process without CUDA "
        f"{out['no_cuda']}")
    return out


def phase_data_group(base, quantized, multiclass, data) -> dict:
    """Phase 14: multi-device training's paths at full width, telemetry,
    the pickled Booster."""
    t0 = time.perf_counter()
    out = {"14a": phase_blocked_fits(data)}
    out["14b"] = phase_voting(multiclass)
    out["14c"] = phase_telemetry(data)
    out["14d"] = phase_pickle(base, quantized, data[2])
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 14: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the shared host stages, featurizers, TrainClassifier and the VW
# learners (hashed SGD, L-BFGS, contextual bandits)
# ---------------------------------------------------------------------------

# Criteo Kaggle Display Advertising Challenge's row shape: 13 integer
# columns and 26 categorical ones, these the distinct counts of its
# training set's categorical columns (about 33.8M values in all)
CRITEO_CARDINALITIES = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633,
                        3, 93145, 5683, 8351593, 3194, 27, 14992, 5461306,
                        10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
                        142572)
CRITEO_INTS = 13
CRITEO_POSITIVE_RATE = 0.25
CRITEO_ROWS, CRITEO_HOLDOUT = 1_000_000, 200_000
VW_BITS = 24
VW_SMALL_ROWS = 20_000
BFGS_ROWS = 200_000
BFGS_ITERS = 10
BANDIT_EVENTS, BANDIT_ACTIONS, BANDIT_SHARED, BANDIT_ACTION_DIM = (
    10_000, 8, 32, 16)
# Adult Census Income: 48,842 rows (its train and test splits), 6 numeric
# and 8 string columns, about 24% positives
ADULT_TRAIN, ADULT_TEST = 32_561, 16_281
TEXT_DOCS = 20_000
# phase 15 quality floors (PERF.md §2, set from a CPU rehearsal before the
# first chip run)
VW_AUC_FLOOR = 0.69
ADULT_AUC_FLOOR = 0.83
TEXT_ACCURACY_FLOOR = 0.70
# cuda against cpu, VW, on rows where the fit is stable: an f32 batch step
# sums the updates of the constant feature (and every shared index) in
# index order on the CPU and in sorted warp runs on the card, and margins
# in another order; one ulp of input moves these fits by 1e-6 to 5e-5
VW_WEIGHT_ATOL = 1e-3
# bandit: weights as VW's; the IPS/SNIPS counters move by one event's
# cost / p_log if a near-tied argmin falls the other way on one device
BANDIT_WEIGHT_ATOL = 1e-3
BANDIT_ESTIMATE_RTOL = 1e-2
VW_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_vw")


def _fmix32(h: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finalizer on uint64 values below 2^32."""
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    return h ^ (h >> np.uint64(16))


def _criteo_keys(ids: np.ndarray) -> np.ndarray:
    """[n, 26] uint64 keys of (column, id)."""
    cols = np.arange(len(CRITEO_CARDINALITIES), dtype=np.uint64)
    return (ids.astype(np.uint64) * np.uint64(0x9E3779B1)
            + cols * np.uint64(0x7F4A7C15)) & np.uint64(0xFFFFFFFF)


def criteo_raw(n: int, seed: int):
    """Criteo-shaped rows from a seed: ``[n, 13]`` integer counts, ``[n,
    26]`` category ids (skewed towards small ids, within each column's
    distinct count) and labels from one fixed logistic model at Criteo's
    positive rate of about 25%."""
    model = np.random.default_rng(1234)
    p = model.uniform(0.02, 0.4, size=CRITEO_INTS)
    w_int = model.normal(0.0, 0.35, size=CRITEO_INTS)
    scale = model.uniform(0.3, 1.2, size=len(CRITEO_CARDINALITIES))
    rng = np.random.default_rng(seed)
    counts = rng.geometric(p, size=(n, CRITEO_INTS)) - 1
    card = np.asarray(CRITEO_CARDINALITIES, np.float64)
    ids = np.floor(card * rng.random((n, len(card))) ** 3).astype(np.int64)
    eff = (_fmix32(_criteo_keys(ids) ^ np.uint64(0x5BD1E995))
           .astype(np.float64) / 2.0 ** 32 - 0.5) * 2.0 * scale
    score = np.log1p(counts) @ w_int + eff.sum(axis=1)
    score = (score - score.mean()) / score.std() * 1.6
    lo, hi = -10.0, 10.0                       # the offset of a 25% rate
    for _ in range(50):
        mid = (lo + hi) / 2
        if (1.0 / (1.0 + np.exp(-(score - mid)))).mean() > \
                CRITEO_POSITIVE_RATE:
            lo = mid
        else:
            hi = mid
    prob = 1.0 / (1.0 + np.exp(-(score - lo)))
    y = (rng.random(n) < prob).astype(np.float32)
    return counts, ids, y, score.astype(np.float32)


def criteo_hashed(counts, ids):
    """The pre-hashed ``features_indices`` / ``features_values`` columns of
    Criteo-shaped rows as VW hashes them: an integer column at the hash of
    its name with value ``log1p(count)``, a category at a hash of (column,
    id) with value 1 (VW's constant feature is the estimator's)."""
    n = counts.shape[0]
    ns = hash_namespace("", 0)
    int_idx = np.asarray([hash_feature(f"I{j}", ns) & 0x7FFFFFFF
                          for j in range(CRITEO_INTS)], np.int64)
    cat_idx = (_fmix32(_criteo_keys(ids)) & np.uint64(0x7FFFFFFF)).astype(
        np.int64)
    idx = np.concatenate([np.broadcast_to(int_idx, (n, CRITEO_INTS)),
                          cat_idx], axis=1).astype(np.int32)
    val = np.concatenate([np.log1p(counts).astype(np.float32),
                          np.ones(cat_idx.shape, np.float32)], axis=1)
    return idx, val


def criteo_columns(counts, ids, y):
    """The same rows as raw columns for ``VowpalWabbitFeaturizer``
    (integer columns log1p-scaled, categories as hex strings)."""
    cols = {f"I{j}": np.log1p(counts[:, j]) for j in range(CRITEO_INTS)}
    for j in range(ids.shape[1]):
        cols[f"C{j}"] = np.char.mod("%08x", ids[:, j]).astype(object)
    cols["label"] = y
    return cols


def vw_margins(model, ds) -> np.ndarray:
    out = model.transform(ds)
    if "rawPrediction" in out:
        return out.array("rawPrediction")[:, 1]
    return out.array("prediction")


def vw_step_costs(est, ds, steps: int = 40) -> dict:
    """Launches and host ms per batch step, and the device's busy share,
    from a profiler window over ``steps`` steps of the fit's own loop
    (``sgd._sgd_passes``) at the fit's shapes and table size: eager, and
    as the captured graph the fit runs on the card (its capture outside
    the window). The graph's weights must equal the eager loop's."""
    from torch.profiler import ProfilerActivity, profile

    cfg = est._sgd_config(est.get_or_default("lossFunction"))._replace(
        num_passes=1)
    rows = steps * cfg.batch_size
    idx, val = est._features(ds.take(np.arange(rows)))
    idx = idx & ((1 << cfg.num_bits) - 1)
    mesh = vw_sgd.meshlib.get_default_mesh()
    dev = torch.device("cuda")
    prepped = vw_sgd._prep_sgd_data(idx, val, ds.array("label")[:rows],
                                    None, cfg, mesh, dev)
    D = 1 << cfg.num_bits
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out, weights = {}, {}
    # a CPU rehearsal has no graph to capture
    modes = (("eager", False), ("graph", True))[
        :2 if torch.cuda.is_available() else 1]
    for mode, graph in modes:
        args = [torch.zeros(D, device=dev), torch.zeros(D, device=dev), 0.0,
                torch.zeros(1, device=dev)]
        step = None
        if graph:
            step = vw_sgd._StepGraph(prepped, cfg, args[0], args[1], args[3],
                                     0.0)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if step is None:
                vw_sgd._sgd_passes(prepped, cfg, mesh, *args, graph=False)
            else:
                step.run_pass()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        weights[mode] = args[0]
        rc = runtime_calls(prof)
        dms = device_ms(prof)
        out[mode] = {"launches_per_step": rc["cudaLaunchKernel"] / steps,
                     "graph_launches_per_step": rc["cudaGraphLaunch"] / steps,
                     "device_items_per_step": device_launches(prof) / steps,
                     "host_ms_per_step": wall_ms / steps,
                     "device_ms_per_step": dms / steps,
                     "device_busy_share": dms / wall_ms}
    diff = float((weights["eager"] - weights.get(
        "graph", weights["eager"])).abs().max())
    out["graph_vs_eager_max_abs"] = diff
    out["steps"] = steps
    if not diff <= 1e-5:
        raise AssertionError(f"the captured step differs from the eager "
                             f"step by {diff}")
    return out


def scatter_costs(nnz: int, bs: int = 128, bits: int = VW_BITS) -> dict:
    """The fit's deterministic scatter-add (``index_put_`` with
    ``accumulate``) against ``index_add_`` at one batch's shape: bs x nnz
    updates into a 2^bits table, every row's constant feature among
    them. Bit-equal over repeats is held; ``index_add_``'s float atomics
    promise no such thing."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, 1 << bits, (bs, nnz), device="cuda",
                        generator=gen)
    idx[:, -1] = VW_CONSTANT_INDEX & ((1 << bits) - 1)
    flat = idx.reshape(-1)
    upd = torch.randn(bs * nnz, device="cuda", generator=gen)
    table = torch.zeros(1 << bits, device="cuda")
    outs = [vw_sgd.scatter_add(table.clone(), flat, upd) for _ in range(5)]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("the deterministic scatter-add is not "
                             "bit-equal over repeats")
    plain = table.clone().index_add_(0, flat, upd)
    err = float((plain - outs[0]).abs().max())
    det_ms = time_ms(lambda: vw_sgd.scatter_add(table, flat, upd), reps=200)
    add_ms = time_ms(lambda: table.index_add_(0, flat, upd), reps=200)
    return {"index_put_accumulate_ms": det_ms, "index_add_ms": add_ms,
            "max_abs_diff": err, "updates": bs * nnz}


def auc_of(p, y) -> float:
    return float(auc_weighted(np.asarray(p, np.float64),
                              np.asarray(y, np.float64), None))


def phase_vw_full_width(train, hold) -> dict:
    """15a: ``VowpalWabbitClassifier(numBits=24, numPasses=2,
    batchSize=128)`` on Criteo-shaped rows, transform of the holdout."""
    (idx, val, y), (idx_h, val_h, y_h) = train, hold
    log(f"== phase 15a: VowpalWabbitClassifier(numBits={VW_BITS}, "
        f"numPasses=2, batchSize=128) fit on {len(y):,} Criteo-shaped rows "
        f"(13 + 26 + constant = {idx.shape[1] + 1} features), transform "
        f"{len(y_h):,}")
    ds = Dataset({"features_indices": idx, "features_values": val,
                  "label": y})
    dh = Dataset({"features_indices": idx_h, "features_values": val_h})
    est = VowpalWabbitClassifier(numBits=VW_BITS, numPasses=2, batchSize=128,
                                 device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = est.fit(ds)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the VW fit launched a histogram: {counts}")
    t0 = time.perf_counter()
    probs = model.transform(dh).array("probability")
    pred_s = time.perf_counter() - t0
    if not np.isfinite(probs).all():
        raise AssertionError("non-finite VW probabilities")
    a = auc_of(probs[:, 1], y_h)
    log(f"fit {fit_s:.3f} s ({2 * len(y) / fit_s:,.0f} rows/s per pass of "
        f"{len(y):,}); peak device memory {peak / 2**30:.3f} GiB; transform "
        f"{len(y_h) / pred_s:,.0f} rows/s; holdout AUC {a:.5f} (floor "
        f"{VW_AUC_FLOOR}); {model.stats['numWeights']:,} live weights")
    if not a > VW_AUC_FLOOR:
        raise AssertionError(f"VW holdout AUC {a} <= {VW_AUC_FLOOR}")
    steps = vw_step_costs(est, ds)
    log("one batch step: " + json.dumps(steps))
    scatter = scatter_costs(idx.shape[1] + 1)
    log("scatter-add at one batch's shape: " + json.dumps(scatter))
    return {"fit_s": fit_s, "rows_per_s_per_pass": 2 * len(y) / fit_s,
            "peak_gib": peak / 2 ** 30,
            "transform_rows_per_s": len(y_h) / pred_s, "auc": a,
            "step": steps, "scatter": scatter}


# 15b: (estimator, Params) fitted on cuda and on cpu
VW_SMALL_FITS = (
    ("VowpalWabbitClassifier", {}),
    ("VowpalWabbitClassifier", {"adaptive": False, "powerT": 0.4}),
    ("VowpalWabbitClassifier", {"l1": 1e-6}),
    ("VowpalWabbitClassifier", {"l2": 1e-6}),
    ("VowpalWabbitClassifier", {"lossFunction": "hinge"}),
    ("VowpalWabbitRegressor", {"lossFunction": "quantile"}),
    ("VowpalWabbitRegressor", {"lossFunction": "squared"}),
    ("VowpalWabbitClassifier", {"passThroughArgs": "--bfgs"}),
)


def well_conditioned(n: int, seed: int):
    """Rows on which a VW fit is stable: 8 normal features hashed at
    random into 2^18, labels from a linear model with noise. One ulp of
    input moves these fits' weights by 1e-6 (5e-5 for the squared loss) on
    the CPU (``tools/rehearse_chip_smoke.py p15``'s rows), so cuda against
    cpu is held tightly."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << 18, size=(n, 8)).astype(np.int32)
    val = rng.normal(size=(n, 8)).astype(np.float32)
    score = (val @ rng.normal(size=8)).astype(np.float32)
    y = (score + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return {"features_indices": idx, "features_values": val}, y, score


def vw_pair(name, params, base, label, devices=("cuda", "cpu")):
    """One VW fit of ``VW_SMALL_FITS`` per device: (weights, margins)."""
    cls = {"VowpalWabbitClassifier": VowpalWabbitClassifier,
           "VowpalWabbitRegressor": VowpalWabbitRegressor}[name]
    ds = Dataset(dict(base, label=label))
    out = []
    for dev in devices:
        m = cls(numBits=18, numPasses=2, device=dev, **params).fit(ds)
        out.append((m.weights, vw_margins(m, ds)))
    return out


def phase_vw_small() -> dict:
    """15b: each fit of ``VW_SMALL_FITS`` on cuda against cpu, first on
    well-conditioned rows (held tightly), then on raw Criteo-shaped columns
    through VowpalWabbitFeaturizer (VW's defaults held to the spread one
    ulp of input makes on the CPU: these fits amplify any rounding); on
    the card alone a
    streamed fit against the in-memory one and a resumed checkpointed fit
    against an uninterrupted one, bit for bit."""
    log(f"== phase 15b: VW fits on cuda vs cpu at {VW_SMALL_ROWS:,} rows "
        "(numBits=18, 2 passes): well-conditioned rows, then raw "
        "Criteo-shaped columns through VowpalWabbitFeaturizer")
    out = {"fits": []}
    base, y, score = well_conditioned(VW_SMALL_ROWS, seed=5)
    for name, params in VW_SMALL_FITS:
        label = y if name == "VowpalWabbitClassifier" else score
        (wg, mg), (wc, mc) = vw_pair(name, params, base, label)
        dw = float(np.abs(wg - wc).max())
        dm = float(np.abs(mg - mc).max())
        scale = max(1.0, float(np.abs(mc).max()))
        log(f"{name}({shown(params)}): weights differ by {dw:.3g}, margins "
            f"by {dm:.3g} (|margin| <= {scale:.3g}; tolerance "
            f"{VW_WEIGHT_ATOL})")
        if not (dw <= VW_WEIGHT_ATOL and dm <= VW_WEIGHT_ATOL * scale):
            raise AssertionError(f"{name}({params}) cuda vs cpu: weights "
                                 f"{dw}, margins {dm}")
        out["fits"].append({"fit": name, "params": params,
                            "weight_diff": dw, "margin_diff": dm})

    counts, ids, y, score = criteo_raw(VW_SMALL_ROWS, seed=7)
    cols = criteo_columns(counts, ids, y)
    t0 = time.perf_counter()
    feats = VowpalWabbitFeaturizer(
        inputCols=[c for c in cols if c != "label"]).transform(Dataset(cols))
    feat_s = time.perf_counter() - t0
    out["featurizer_rows_per_s"] = VW_SMALL_ROWS / feat_s
    log(f"featurizer {VW_SMALL_ROWS / feat_s:,.0f} rows/s "
        f"({len(cols) - 1} columns, per element on the host); "
        f"{feats.array('features_indices').shape[1]} slots a row")
    base = {"features_indices": feats.array("features_indices"),
            "features_values": feats.array("features_values")}
    nudged = dict(base, features_values=base["features_values"]
                  * np.float32(1 + 2 ** -23))
    for name, params in VW_SMALL_FITS:
        label = y if name == "VowpalWabbitClassifier" else score
        (wg, mg), (wc, mc) = vw_pair(name, params, base, label)
        ((wn, mn),) = vw_pair(name, params, nudged, label, devices=("cpu",))
        dm = float(np.median(np.abs(mg - mc)))
        spread = float(np.median(np.abs(mn - mc)))
        agree = float(((mg > 0) == (mc > 0)).mean())
        log(f"{name}({shown(params)}) on featurized rows: median |margin "
            f"delta| {dm:.3g} (one ulp of input on the cpu: {spread:.3g}); "
            f"weights {float(np.abs(wg - wc).max()):.3g} (one ulp: "
            f"{float(np.abs(wn - wc).max()):.3g}); signs agree on "
            f"{agree:.5f}")
        # VW's defaults (15a's fit) are held: the card's rounding differs
        # at every step, not once, so up to 8 times one ulp's spread. The
        # other options are read, not held: on these rows their fits turn
        # one ulp of input into margins apart by up to 5 (this phase on
        # an H100), so cuda and cpu have no pointwise answer to agree on; the
        # well-conditioned rows above hold each of them tightly
        if not params and not (dm <= 8 * spread + 1e-4 and agree >= 0.99):
            raise AssertionError(f"{name}({params}) on featurized rows: "
                                 f"median margin delta {dm} against one "
                                 f"ulp's {spread}, signs {agree}")
        out["fits"].append({"fit": name, "params": params,
                            "featurized": True, "median_margin_diff": dm,
                            "ulp_spread": spread, "sign_agreement": agree})

    ds = Dataset(dict(base, label=y))
    est = VowpalWabbitClassifier(numBits=18, numPasses=2, device="cuda")
    whole = est.fit(ds)
    idx, val = est._features(ds)
    shutil.rmtree(VW_DIR, ignore_errors=True)
    paths = []
    for k, a in (("idx", idx), ("val", val), ("y", y)):
        d = os.path.join(VW_DIR, k)
        os.makedirs(d)
        cuts = np.linspace(0, len(a), 4).astype(int)
        for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            np.save(os.path.join(d, f"part{i:03d}.npy"), a[lo:hi])
        paths.append(d)
    streamed = VowpalWabbitClassifier(
        numBits=18, numPasses=2, device="cuda").fit_streamed(
        *paths, chunk_rows=4096)
    if not np.array_equal(streamed.weights, whole.weights):
        raise AssertionError("the streamed VW fit differs from the "
                             "in-memory fit on the card")
    ck = os.path.join(VW_DIR, "ckpt")
    three = VowpalWabbitClassifier(numBits=18, numPasses=3,
                                   device="cuda").fit(ds)
    VowpalWabbitClassifier(numBits=18, numPasses=2, checkpointDir=ck,
                           device="cuda").fit(ds)
    resumed = VowpalWabbitClassifier(numBits=18, numPasses=3,
                                     checkpointDir=ck, device="cuda").fit(ds)
    if not np.array_equal(resumed.weights, three.weights):
        raise AssertionError("the resumed VW fit differs from the "
                             "uninterrupted fit on the card")
    shutil.rmtree(VW_DIR, ignore_errors=True)
    log("on the card: streamed == in-memory and resumed == uninterrupted, "
        "bit for bit")
    return out


def phase_vw_bfgs(train) -> dict:
    """15c: ``train_bfgs`` at 200,000 Criteo-shaped rows, numBits=18, 10
    iterations: the objective must not rise."""
    idx, val, y = (a[:BFGS_ROWS] for a in train)
    log(f"== phase 15c: L-BFGS at {len(y):,} rows, numBits=18, "
        f"{BFGS_ITERS} iterations")
    est = VowpalWabbitClassifier(numBits=18)
    idx, val = est._features(Dataset({"features_indices": idx,
                                      "features_values": val}))
    idx = idx & ((1 << 18) - 1)
    cfg = vw_sgd.SGDConfig(num_bits=18, loss="logistic",
                           num_passes=BFGS_ITERS, optimizer="bfgs")
    trace = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = vw_sgd.train_bfgs(idx, val, y, None, cfg, trace=trace,
                          device="cuda")
    secs = time.perf_counter() - t0
    obj = trace["objective"]
    log(f"{secs:.3f} s ({secs / BFGS_ITERS * 1e3:.1f} ms an iteration); "
        f"objective {obj[0]:.6f} -> {obj[-1]:.6f}; line-search read-backs "
        f"per iteration {trace['readbacks']}")
    if not np.isfinite(w).all():
        raise AssertionError("non-finite L-BFGS weights")
    for a, b in zip(obj, obj[1:]):
        if not b <= a + 1e-6 * abs(a):
            raise AssertionError(f"the L-BFGS objective rose: {obj}")
    return {"seconds": secs, "objective": obj,
            "readbacks": trace["readbacks"]}


def bandit_events(n, seed):
    """Logged events: shared contexts, 8 actions each, a uniform logging
    policy and costs from a hidden bilinear map of context and action."""
    rng = np.random.default_rng(seed)
    shared = rng.normal(size=(n, BANDIT_SHARED)).astype(np.float32)
    proj = rng.normal(size=(BANDIT_SHARED, BANDIT_ACTION_DIM)).astype(
        np.float32) / np.sqrt(BANDIT_SHARED)
    acts = rng.normal(size=(n, BANDIT_ACTIONS, BANDIT_ACTION_DIM)).astype(
        np.float32)
    chosen = rng.integers(0, BANDIT_ACTIONS, size=n)
    reward = np.einsum("nd,nd->n", shared @ proj, acts[np.arange(n), chosen])
    cost = (-reward + 0.1 * rng.normal(size=n)).astype(np.float64)
    return {"shared": shared, "features": [list(a) for a in acts],
            "chosenAction": chosen + 1, "label": cost,
            "probability": np.full(n, 1.0 / BANDIT_ACTIONS)}


def phase_bandit() -> dict:
    """15d: VowpalWabbitContextualBandit, epsilon and bag (4 policies),
    interactions on, cuda against cpu; fit_multiple on two threads against
    the same fits in turn."""
    log(f"== phase 15d: contextual bandit, {BANDIT_EVENTS:,} events x "
        f"{BANDIT_ACTIONS} actions, {BANDIT_SHARED} shared and "
        f"{BANDIT_ACTION_DIM} action dimensions")
    cols = bandit_events(BANDIT_EVENTS, seed=11)
    maps = [{"explorationPolicy": "epsilon"},
            {"explorationPolicy": "bag", "bagSize": 4}]
    out = {}
    cuda_models = []
    for pm in maps:
        models, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            models[dev] = VowpalWabbitContextualBandit(
                device=dev, useInteractions=True, **pm).fit(Dataset(cols))
            secs[dev] = time.perf_counter() - t0
        g, c = models["cuda"], models["cpu"]
        dw = max(float(np.abs(np.asarray(g.get_or_default(p))
                              - np.asarray(c.get_or_default(p))).max())
                 for p in ("sharedWeights", "actionWeights",
                           "interactionWeights"))
        ips = (g.metrics.get_ips_estimate(), c.metrics.get_ips_estimate())
        snips = (g.metrics.get_snips_estimate(),
                 c.metrics.get_snips_estimate())
        rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in (ips, snips))
        ms = secs["cuda"] / BANDIT_EVENTS * 1e3
        log(f"{pm['explorationPolicy']}: cuda {ms:.4f} ms an event (cpu "
            f"{secs['cpu'] / BANDIT_EVENTS * 1e3:.4f}); weights differ by "
            f"{dw:.3g}; IPS {ips[0]:.6f} / {ips[1]:.6f}, SNIPS "
            f"{snips[0]:.6f} / {snips[1]:.6f}")
        if not (dw <= BANDIT_WEIGHT_ATOL and rel <= BANDIT_ESTIMATE_RTOL):
            raise AssertionError(f"bandit {pm} cuda vs cpu: weights {dw}, "
                                 f"estimates {vars(g.metrics)} against "
                                 f"{vars(c.metrics)}")
        out[pm["explorationPolicy"]] = {"ms_per_event": ms,
                                        "cpu_ms_per_event": secs["cpu"]
                                        / BANDIT_EVENTS * 1e3,
                                        "weight_diff": dw, "ips": ips,
                                        "snips": snips}
        cuda_models.append(g)
    t0 = time.perf_counter()
    threaded = VowpalWabbitContextualBandit(
        useInteractions=True, parallelism=2, device="cuda").fit_multiple(
        Dataset(cols), maps)
    out["fit_multiple_s"] = time.perf_counter() - t0
    for a, b in zip(threaded, cuda_models):
        for p in ("sharedWeights", "actionWeights", "interactionWeights"):
            if not np.array_equal(a.get_or_default(p), b.get_or_default(p)):
                raise AssertionError(f"fit_multiple on two threads differs "
                                     f"from the fit in turn ({p})")
        if vars(a.metrics) != vars(b.metrics):
            raise AssertionError("fit_multiple's counters differ")
    log(f"fit_multiple(parallelism=2): {out['fit_multiple_s']:.2f} s, "
        "bit-equal to the fits in turn")
    return out


ADULT_CATEGORIES = {
    "workclass": 9, "education": 16, "marital_status": 7, "occupation": 15,
    "relationship": 6, "race": 5, "sex": 2, "native_country": 42}
ADULT_NUMERIC = ("age", "fnlwgt", "education_num", "capital_gain",
                 "capital_loss", "hours_per_week")


def adult_shaped(n: int, seed: int) -> dict:
    """Adult-Census-shaped rows: its 6 numeric and 8 string columns (each
    with its distinct count), labels '<=50K' / '>50K' from one fixed
    model at about 24% positives."""
    model = np.random.default_rng(4321)
    eff = {c: model.normal(0.0, 0.8, size=k)
           for c, k in ADULT_CATEGORIES.items()}
    rng = np.random.default_rng(seed)
    cols = {"age": rng.integers(17, 91, size=n).astype(np.float64),
            "fnlwgt": rng.lognormal(12.0, 0.5, size=n),
            "education_num": rng.integers(1, 17, size=n).astype(np.float64),
            "capital_gain": np.where(rng.random(n) < 0.08,
                                     rng.lognormal(8.0, 1.0, size=n), 0.0),
            "capital_loss": np.where(rng.random(n) < 0.05,
                                     rng.lognormal(7.0, 0.4, size=n), 0.0),
            "hours_per_week": np.clip(rng.normal(40, 12, size=n), 1, 99)}
    z = (0.04 * (cols["age"] - 38) + 0.25 * (cols["education_num"] - 10)
         + 0.4 * (cols["capital_gain"] > 0) + 0.03
         * (cols["hours_per_week"] - 40))
    for c, k in ADULT_CATEGORIES.items():
        # skewed levels: the first few carry most rows, as Adult's do
        p = 1.0 / np.arange(1, k + 1) ** 1.3
        lv = rng.choice(k, size=n, p=p / p.sum())
        cols[c] = np.asarray([f"{c}_{v}" for v in lv], dtype=object)
        z = z + eff[c][lv]
    z = z + rng.normal(0.0, 1.0, size=n)
    cut = np.quantile(z, 0.76)
    cols["income"] = np.where(z > cut, ">50K", "<=50K").astype(object)
    return cols


def text_docs(n: int, seed: int) -> dict:
    """Seeded documents over a 2,000-word vocabulary; the label is 1 when
    a document holds more of the 'positive' words than of the 'negative'."""
    rng = np.random.default_rng(seed)
    vocab = np.asarray([f"w{i:04d}" for i in range(2000)], dtype=object)
    pos, neg = set(range(0, 40)), set(range(40, 80))
    docs, labels = [], []
    for _ in range(n):
        words = rng.integers(0, 2000, size=rng.integers(8, 30))
        words[:3] = rng.integers(0, 80, size=3)
        s = sum(w in pos for w in words) - sum(w in neg for w in words)
        docs.append(" ".join(vocab[words]))
        labels.append(float(s > 0 or (s == 0 and rng.random() < 0.5)))
    return {"text": np.asarray(docs, dtype=object),
            "label": np.asarray(labels)}


def phase_train_classifier() -> dict:
    """15e: TrainClassifier over LightGBMClassifier on Adult-shaped rows
    (kernel 1 must launch, no plain version), ComputeModelStatistics,
    cuda against cpu; then TextFeaturizer -> VowpalWabbitFeaturizer ->
    VowpalWabbitClassifier on seeded documents, cuda against cpu."""
    log(f"== phase 15e: TrainClassifier(LightGBMClassifier(numIterations="
        f"10)) on {ADULT_TRAIN + ADULT_TEST:,} Adult-shaped rows (train "
        f"{ADULT_TRAIN:,}, test {ADULT_TEST:,}), ComputeModelStatistics")
    cols = adult_shaped(ADULT_TRAIN + ADULT_TEST, seed=21)
    train = {k: v[:ADULT_TRAIN] for k, v in cols.items()}
    test = {k: v[ADULT_TRAIN:] for k, v in cols.items()}
    models, fit_s = {}, {}
    for dev in ("cuda", "cpu"):
        # leaves of 500+ rows: f32 totals summed in another order on each
        # device then move no leaf value past the 1e-5 agreement
        est = TrainClassifier(model=LightGBMClassifier(
            numIterations=10, minDataInLeaf=500, device=dev),
            labelCol="income")
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts()
        t0 = time.perf_counter()
        models[dev] = est.fit(Dataset(dict(train)))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        fit_s[dev] = time.perf_counter() - t0
    if counts["node_hist_bf16"] <= 0 or counts["plain"] != 0:
        raise AssertionError(f"TrainClassifier's fit did not go through "
                             f"kernel 1 alone: {counts}")
    scored = {d: m.transform(Dataset(dict(test))) for d, m in models.items()}
    diff = float(np.abs(scored["cuda"].array("probability")
                        - scored["cpu"].array("probability")).max())
    stats = ComputeModelStatistics(labelCol="income").transform(
        scored["cuda"])
    auc = float(stats["AUC"][0])
    acc = float(stats["accuracy"][0])
    card_s, host_s = fit_s["cuda"], fit_s["cpu"]
    log(f"fit {card_s:.3f} s on cuda ({counts['node_hist_bf16']} "
        f"kernel 1 launches), {host_s:.3f} s on cpu; test AUC "
        f"{auc:.5f} (floor {ADULT_AUC_FLOOR}), accuracy {acc:.5f}; cuda vs "
        f"cpu probabilities differ by {diff:.3g}")
    if not auc > ADULT_AUC_FLOOR:
        raise AssertionError(f"Adult test AUC {auc} <= {ADULT_AUC_FLOOR}")
    if not diff <= 1e-5:
        raise AssertionError(f"TrainClassifier cuda vs cpu: {diff}")

    log(f"== phase 15e: TextFeaturizer -> VowpalWabbitFeaturizer -> "
        f"VowpalWabbitClassifier on {TEXT_DOCS:,} documents, cuda vs cpu")
    docs = text_docs(TEXT_DOCS, seed=23)
    t0 = time.perf_counter()
    tf = TextFeaturizer(inputCol="text", outputCol="tf",
                        numFeatures=256).fit(Dataset(docs))
    ds = VowpalWabbitFeaturizer(inputCols=["tf"], numBits=18).transform(
        tf.transform(Dataset(docs)))
    feat_s = time.perf_counter() - t0
    vw = {dev: VowpalWabbitClassifier(numBits=18, numPasses=3,
                                      device=dev).fit(ds)
          for dev in ("cuda", "cpu")}
    dw = float(np.abs(vw["cuda"].weights - vw["cpu"].weights).max())
    pg, pc = (vw[d].transform(ds).array("probability")[:, 1]
              for d in ("cuda", "cpu"))
    dp = float(np.abs(pg - pc).max())
    acc_t = float(((pg > 0.5) == (docs["label"] > 0)).mean())
    log(f"featurizers {feat_s:.2f} s on the host; weights differ by "
        f"{dw:.3g}, probabilities by {dp:.3g}; training accuracy "
        f"{acc_t:.5f} (floor {TEXT_ACCURACY_FLOOR})")
    if not (dw <= VW_WEIGHT_ATOL and dp <= VW_WEIGHT_ATOL):
        raise AssertionError(f"text VW cuda vs cpu: {dw}, {dp}")
    if not acc_t > TEXT_ACCURACY_FLOOR:
        raise AssertionError(f"text VW accuracy {acc_t}")
    return {"fit_s": card_s, "cpu_fit_s": host_s, "auc": auc,
            "accuracy": acc, "prob_diff": diff, "counts": counts,
            "text": {"host_s": feat_s, "weight_diff": dw, "prob_diff": dp,
                     "accuracy": acc_t}}


def phase_vw_and_host_stages(card) -> dict:
    """Phase 15: 15a-15e."""
    t0 = time.perf_counter()
    counts, ids, y, _ = criteo_raw(CRITEO_ROWS, seed=3)
    train = (*criteo_hashed(counts, ids), y)
    counts, ids, y, _ = criteo_raw(CRITEO_HOLDOUT, seed=4)
    hold = (*criteo_hashed(counts, ids), y)
    del counts, ids
    log(f"phase 15 data: {time.perf_counter() - t0:.1f} s on the host")
    out = {"15a": phase_vw_full_width(train, hold)}
    out["15b"] = phase_vw_small()
    out["15c"] = phase_vw_bfgs(train)
    del train, hold
    out["15d"] = phase_bandit()
    out["15e"] = phase_train_classifier()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 15: {out['seconds']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: isolation forest, exact KNN, SAR with the ranking tools, CyberML
# ---------------------------------------------------------------------------

# 16a: Liu et al.'s (and the reference's) defaults, on phase 4's rows with
# 1% of them moved far from the mass
IF_TREES, IF_SAMPLES, IF_OUTLIER_SHARE = 100, 256, 0.01
IF_CHECK_ROWS = 20_000
IF_SCORE_ATOL = 1e-6
# 16b: ANN-benchmarks' sift-128-euclidean: 1,000,000 base vectors of 128
# integer components in [0, 255], 10,000 queries, k = 100
SIFT_BASE, SIFT_QUERIES, SIFT_DIM = 1_000_000, 10_000, 128
KNN_K, KNN_BLOCK = 100, 4096
KNN_CHECK_QUERIES = 100
KNN_DIST_RTOL = 1e-4
KNN_RECALL_FLOOR = 0.99
KNN_LABELS, KNN_ALLOWED = 10, 3
BALL_ROWS, BALL_DIM, BALL_QUERIES, BALL_K = 50_000, 16, 500, 10
# 16c: MovieLens-1M: 6,040 users, 3,706 rated items, 1,000,209 ratings of
# 1-5 over about three years; its rating shares, 1 to 5
ML_USERS, ML_ITEMS, ML_RATINGS = 6_040, 3_706, 1_000_209
ML_RATING_SHARES = (0.056, 0.108, 0.261, 0.349, 0.226)
ML_GENRES = 18
ML_START, ML_SPAN = 956_703_932.0, 3 * 365 * 86_400.0
SAR_PARAMS = dict(similarityFunction="jaccard", supportThreshold=4,
                  timeDecayCoeff=30, timeCol="ts")
SAR_SCORE_RTOL = 1e-5
SAR_CHECK_PAIRS = 100_000
SAR_SPARSE_USERS = 512
# 16d: DataFactory's three departments at these sizes, ratio 0.25: about
# 1.1M access events; the small fits at one department's 2,000 users and
# 400 resources, split three ways so that inter-department pairs exist
AA_USERS = {"hr": 2_000, "fin": 1_500, "eng": 4_000}
AA_RESOURCES = {"hr": 400, "fin": 300, "eng": 800}
AA_SMALL_USERS = {"hr": 700, "fin": 500, "eng": 800}
AA_SMALL_RESOURCES = {"hr": 140, "fin": 100, "eng": 160}
AA_RATIO = 0.25
# cuda against cpu, AccessAnomaly: scores within this many times the
# spread that moving every other likelihood up two f32 ulps makes on the
# CPU (the larger of the even and the odd half; the batched solves and YtY
# round in another order on the card, and ALS carries that through its
# sweeps as it carries an ulp of input)
AA_SPREAD_FACTOR = 8.0
# phase 16 quality floors (PERF.md §2, set from a CPU rehearsal before the
# first chip run: AUC 0.96701 at 200,000 rows; NDCG@10 0.36649 at full
# size; inter - intra 12.85 at full size, 7.41 implicit and 1.75 explicit
# at the small size)
IF_AUC_FLOOR = 0.93
SAR_NDCG_FLOOR = 0.33
AA_MARGIN = 1.0


def plant_outliers(X, seed) -> np.ndarray:
    """Move ``IF_OUTLIER_SHARE`` of the rows of ``X`` (in place) far from
    the mass: 4 of their features each shifted by 3 to 6 standard
    deviations, either way. Returns the 0/1 outlier labels."""
    rng = np.random.default_rng(seed)
    n, F = X.shape
    rows = rng.choice(n, int(n * IF_OUTLIER_SHARE), replace=False)
    cols = np.argsort(rng.random((len(rows), F)), axis=1)[:, :4]
    shift = (rng.choice([-1.0, 1.0], size=cols.shape)
             * rng.uniform(3.0, 6.0, size=cols.shape)).astype(np.float32)
    X[rows[:, None], cols] += shift
    y = np.zeros(n, np.float32)
    y[rows] = 1.0
    return y


def phase_isolation_forest(card) -> dict:
    """16a: ``IsolationForest`` at 100 trees x 256 samples on phase 4's
    1,000,000 x 28 rows with 1% planted outliers."""
    X, _ = higgs_shaped(HIGGS_ROWS, seed=0)
    y = plant_outliers(X, seed=16)
    ds = Dataset({"features": X})
    params = dict(numEstimators=IF_TREES, maxSamples=float(IF_SAMPLES),
                  contamination=IF_OUTLIER_SHARE)
    log(f"== phase 16a: IsolationForest({params}) fit -> transform on "
        f"{len(X):,} x {X.shape[1]} rows, {int(y.sum()):,} planted outliers")
    torch.cuda.reset_peak_memory_stats()
    model, fit_s = timed(lambda: IsolationForest(device="cuda",
                                                 **params).fit(ds))
    out, tr_s = timed(lambda: model.transform(ds))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    scores = out.array("outlierScore")
    if not np.isfinite(scores).all():
        raise AssertionError("16a: non-finite outlier scores")
    auc = auc_of(scores, y)
    flagged = float(out.array("prediction").mean())
    t0 = time.perf_counter()
    host = IsolationForest(device="cpu", **dict(params, contamination=0.0)
                           ).fit(ds)
    build_s = time.perf_counter() - t0
    for a in ("feat", "thr", "is_leaf", "leaf_size"):
        if not np.array_equal(getattr(host, a), getattr(model, a)):
            raise AssertionError(f"16a: trees differ from a cpu fit ({a})")
    model.set(device="cpu")
    cpu = model.transform(Dataset({"features": X[:IF_CHECK_ROWS]})).array(
        "outlierScore")
    model.set(device="cuda")
    diff = float(np.abs(cpu - scores[:IF_CHECK_ROWS]).max())
    log(f"fit {fit_s:.3f} s (host build of {IF_TREES} trees alone "
        f"{build_s:.3f} s, then one score of every row), transform "
        f"{len(X) / tr_s:,.0f} rows/s ({tr_s:.3f} s), peak {peak:.3f} GiB; "
        f"AUC {auc:.5f} (floor {IF_AUC_FLOOR}), flagged {flagged:.5f} at "
        f"threshold {model.get_or_default('threshold'):.6f}; trees equal "
        f"to a cpu fit; cuda vs cpu scores on {IF_CHECK_ROWS:,} rows "
        f"{diff:.3g}; {card}")
    if not auc > IF_AUC_FLOOR:
        raise AssertionError(f"16a: AUC {auc} <= {IF_AUC_FLOOR}")
    if not diff <= IF_SCORE_ATOL:
        raise AssertionError(f"16a: cuda vs cpu scores differ by {diff}")
    return {"fit_s": fit_s, "host_build_s": build_s,
            "transform_rows_per_s": len(X) / tr_s, "peak_gib": peak,
            "auc": auc, "flagged": flagged, "cuda_vs_cpu": diff}


def sift_shaped(n, seed) -> np.ndarray:
    """Rows of sift-128-euclidean's shape: 128 integer components in
    [0, 255], gathered around 1,000 shared visual words (SIFT descriptors
    cluster so), skewed towards small values."""
    words = np.random.default_rng(1616).gamma(
        0.6, 30.0, size=(1000, SIFT_DIM)).astype(np.float32)
    rng = np.random.default_rng(seed)
    X = words[rng.integers(0, len(words), n)]
    X += rng.standard_normal((n, SIFT_DIM), dtype=np.float32) * 12.0
    return np.clip(np.rint(X), 0.0, 255.0)


def knn_exact_check(index, q, d2, ids) -> dict:
    """The returned neighbours of queries ``q`` against float64 brute force
    on the card: each returned id's exact squared distance within (1 +
    1e-4) of the exact k-th; recall@k (the share of returned ids at or
    inside the exact k-th distance); the returned f32 distances against
    the exact ones of the same ids."""
    x = torch.as_tensor(index, device="cuda", dtype=torch.float64)
    qq = torch.as_tensor(q, device="cuda", dtype=torch.float64)
    exact = ((qq * qq).sum(1, keepdim=True) - 2.0 * (qq @ x.T)
             + (x * x).sum(1)[None, :])       # integers: exact in f64
    kth = torch.topk(exact, ids.shape[1], dim=1, largest=False).values[:, -1:]
    got = exact.gather(1, torch.as_tensor(ids, device="cuda"))
    within = bool((got <= kth * (1.0 + 1e-4)).all())
    recall = float((got <= kth).double().mean())
    rel = float(((torch.as_tensor(d2, device="cuda", dtype=torch.float64)
                  - got).abs() / got.clamp(min=1.0)).max())
    return {"within_kth": within, "recall": recall, "dist_rel": rel}


def knn_block_costs(index, q) -> dict:
    """One full block of 16b, piece by piece, in device ms: the f32
    product into the ``[block, n]`` block (``addmm``, then ``+ x2``), the
    top-k in ``lax.top_k``'s order, and ``torch.topk`` alone; the rows of
    the block whose (k+1)-th distance ties the k-th (sorted whole); the
    block's bound: its f32 operations at the card's peak."""
    x = torch.as_tensor(index, device="cuda")
    qq = torch.as_tensor(q[:KNN_BLOCK], device="cuda")
    q2 = (qq * qq).sum(1, keepdim=True)
    x2 = (x * x).sum(1)[None, :]
    d2 = torch.empty((len(qq), len(x)), device="cuda")

    def product():
        torch.addmm(q2, qq, x.T, alpha=-2.0, out=d2)
        d2.add_(x2)

    out = {"product_ms": time_ms(product, reps=5, warm=1)}
    out["top_k_ms"] = time_ms(lambda: top_k(d2, KNN_K, largest=False),
                              reps=5, warm=1)
    out["torch_topk_ms"] = time_ms(
        lambda: torch.topk(d2, KNN_K + 1, dim=1, largest=False,
                           sorted=False), reps=5, warm=1)
    v = torch.topk(d2, KNN_K + 1, dim=1, largest=False).values
    out["crowded_rows"] = int((v[:, KNN_K] == v[:, KNN_K - 1]).sum())
    out["bound_ms"] = 1e3 * 2.0 * len(qq) * len(x) * SIFT_DIM / (
        PEAK_F32_OPS_PER_S)
    return out


def phase_knn(card) -> dict:
    """16b: ``KNN`` and ``ConditionalKNN`` at sift-128-euclidean's shape;
    ``BallTree`` on 50,000 x 16 rows."""
    t0 = time.perf_counter()
    index = sift_shaped(SIFT_BASE, seed=0)
    q = sift_shaped(SIFT_QUERIES, seed=1)
    log(f"== phase 16b: KNN(k={KNN_K}, blockSize={KNN_BLOCK}) on "
        f"{SIFT_BASE:,} x {SIFT_DIM} sift-shaped rows, {SIFT_QUERIES:,} "
        f"queries (data {time.perf_counter() - t0:.1f} s on the host)")
    model = KNN(k=KNN_K, blockSize=KNN_BLOCK, device="cuda").fit(
        Dataset({"features": index}))
    torch.cuda.reset_peak_memory_stats()
    (d2, ids), search_s = timed(lambda: model.kneighbors(q))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out, tr_s = timed(lambda: model.transform(Dataset({"features": q})))
    first = [m["value"] for m in out["matches"][0]]
    if first != ids[0].tolist() or len(out["matches"]) != len(q):
        raise AssertionError("16b: transform disagrees with kneighbors")
    chk = knn_exact_check(index, q[:KNN_CHECK_QUERIES],
                          d2[:KNN_CHECK_QUERIES], ids[:KNN_CHECK_QUERIES])
    costs = knn_block_costs(index, q)
    log(f"search {SIFT_QUERIES / search_s:,.0f} queries/s ({search_s:.3f} "
        f"s), transform {SIFT_QUERIES / tr_s:,.0f} queries/s, peak "
        f"{peak:.3f} GiB; against float64 brute force on "
        f"{KNN_CHECK_QUERIES} queries: within (1 + 1e-4) of the k-th "
        f"{chk['within_kth']}, recall@{KNN_K} {chk['recall']:.5f}, "
        f"distances {chk['dist_rel']:.3g} relative; one block of "
        f"{KNN_BLOCK}: product {costs['product_ms']:.3f} ms, top-k "
        f"{costs['top_k_ms']:.3f} ms (torch.topk alone "
        f"{costs['torch_topk_ms']:.3f}), {costs['crowded_rows']} rows tied "
        f"across the k-th, bound {costs['bound_ms']:.3f} ms; {card}")
    if not (chk["within_kth"] and chk["recall"] >= KNN_RECALL_FLOOR
            and chk["dist_rel"] <= KNN_DIST_RTOL):
        raise AssertionError(f"16b: exact check failed: {chk}")

    rng = np.random.default_rng(2)
    labels = rng.integers(0, KNN_LABELS, SIFT_BASE)
    conds = [list(rng.choice(KNN_LABELS, KNN_ALLOWED, replace=False))
             for _ in range(SIFT_QUERIES)]
    cmodel = ConditionalKNN(k=KNN_K, blockSize=KNN_BLOCK, device="cuda").fit(
        Dataset({"features": index, "label": labels}))
    torch.cuda.reset_peak_memory_stats()
    (cd2, cids), cond_s = timed(lambda: cmodel.kneighbors(q, conds))
    cpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    allowed = np.zeros((SIFT_QUERIES, KNN_LABELS), bool)
    np.put_along_axis(allowed, np.asarray(conds), True, axis=1)
    ok = bool(np.take_along_axis(allowed, labels[cids], axis=1).all()
              and np.isfinite(cd2).all())
    log(f"ConditionalKNN, {KNN_LABELS} labels, {KNN_ALLOWED} allowed a "
        f"query: {SIFT_QUERIES / cond_s:,.0f} queries/s, peak {cpeak:.3f} "
        f"GiB; every returned id allowed: {ok}")
    if not ok:
        raise AssertionError("16b: ConditionalKNN returned a disallowed id")
    del model, cmodel, index, d2, cd2

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(BALL_ROWS, BALL_DIM))
    bq = rng.normal(size=(BALL_QUERIES, BALL_DIM))
    t0 = time.perf_counter()
    tree = BallTree(pts)
    (bi, bd), ball_s = timed(lambda: tree.query_batch(bq, k=BALL_K))
    build_s = time.perf_counter() - t0 - ball_s
    exact = torch.cdist(torch.as_tensor(bq, device="cuda"),
                        torch.as_tensor(pts, device="cuda"),
                        compute_mode="donot_use_mm_for_euclid_dist")
    ev, ei = torch.topk(exact, BALL_K, dim=1, largest=False)
    same = bool(np.array_equal(bi, ei.cpu().numpy()))
    drel = float(np.abs(bd - ev.cpu().numpy()).max())
    log(f"BallTree on {BALL_ROWS:,} x {BALL_DIM}: build {build_s:.3f} s, "
        f"{BALL_QUERIES:,} queries k={BALL_K} {BALL_QUERIES / ball_s:,.0f} "
        f"queries/s on the host; ids equal to brute force {same}, "
        f"distances {drel:.3g}")
    if not (same and drel <= 1e-9):
        raise AssertionError("16b: BallTree differs from brute force")
    return {"queries_per_s": SIFT_QUERIES / search_s,
            "transform_queries_per_s": SIFT_QUERIES / tr_s,
            "peak_gib": peak, **chk, "block": costs,
            "conditional_queries_per_s": SIFT_QUERIES / cond_s,
            "conditional_peak_gib": cpeak,
            "ball_tree_queries_per_s": BALL_QUERIES / ball_s}


def movielens_shaped(seed) -> dict:
    """Ratings of MovieLens-1M's shape: 6,040 users with at least 20
    ratings each (a lognormal activity, 1,000,209 in all), 3,706 items of
    Zipf-skewed popularity in 18 genres, users drawn to their genre; the
    ratings' shares of 1-5 as ML-1M's; timestamps over three years."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, ML_ITEMS + 1) ** 0.9
    pop = pop[rng.permutation(ML_ITEMS)]
    item_genre = rng.integers(0, ML_GENRES, ML_ITEMS)
    user_genre = rng.integers(0, ML_GENRES, ML_USERS)
    act = rng.lognormal(4.3, 0.9, ML_USERS)
    counts = np.minimum(20 + np.floor(act * (ML_RATINGS - 20 * ML_USERS)
                                      / act.sum()), ML_ITEMS).astype(int)
    room = [i for i in np.argsort(-act) if counts[i] < ML_ITEMS]
    counts[room[:ML_RATINGS - counts.sum()]] += 1
    users, items = [], []
    logw = np.log(pop)
    for u in range(ML_USERS):
        key = (logw + np.log1p(4.0 * (item_genre == user_genre[u]))
               + rng.gumbel(size=ML_ITEMS))      # Gumbel top-k: a draw
        chosen = np.argpartition(-key, counts[u] - 1)[:counts[u]]
        users.append(np.full(counts[u], u, np.int32))
        items.append(chosen.astype(np.int32))
    n = int(counts.sum())
    return {"user_idx": np.concatenate(users),
            "item_idx": np.concatenate(items),
            "rating": (rng.choice(5, n, p=ML_RATING_SHARES) + 1).astype(
                np.float32),
            "ts": ML_START + rng.uniform(0.0, ML_SPAN, n)}


def recs_of(model, k):
    r = model.recommend_for_all_users(k)
    return np.stack(r["recommendations"]), np.stack(r["ratings"])


def same_ranking(ids, vals, ref_ids, ref_vals, ref_scores, rtol) -> int:
    """Hold ``(ids, vals)`` to the reference top-k: values within ``rtol``
    rank by rank, and wherever an id differs, its reference score within
    ``rtol`` of the reference's at that rank (a near tie that rounding may
    order either way; an exact tie orders by id on both). Returns the
    count of such swapped ranks."""
    both = np.isfinite(ref_vals)
    if not (np.array_equal(np.isfinite(vals), both) and np.allclose(
            vals[both], ref_vals[both], rtol=rtol, atol=0)):
        raise AssertionError("16c: recommended ratings differ")
    diff = ids != ref_ids
    rows, ranks = np.nonzero(diff)
    mine = ref_scores[rows, ids[rows, ranks]]
    if not np.allclose(mine, ref_vals[rows, ranks], rtol=rtol, atol=0):
        raise AssertionError(f"16c: {len(rows)} recommended ids differ "
                             "beyond a near tie")
    return int(diff.sum())


def phase_sar(card) -> dict:
    """16c: SAR at MovieLens-1M's shape: fit, transform, top 10 for every
    user, cuda against cpu, the ranking split and evaluation, the sparse
    path."""
    t0 = time.perf_counter()
    cols = movielens_shaped(seed=5)
    ds = Dataset(dict(cols))
    n = len(cols["rating"])
    log(f"== phase 16c: SAR({SAR_PARAMS}) on {ML_USERS:,} users x "
        f"{ML_ITEMS:,} items, {n:,} MovieLens-shaped ratings (data "
        f"{time.perf_counter() - t0:.1f} s on the host)")
    model, fit_s = timed(lambda: SAR(device="cuda", **SAR_PARAMS).fit(ds))
    scored, tr_s = timed(lambda: model.transform(ds))
    (ids, vals), rec_s = timed(lambda: recs_of(model, 10))
    scores = scored.array("prediction")
    cpu_model, cpu_s = timed(lambda: SAR(device="cpu", **SAR_PARAMS).fit(ds))
    for a in ("itemSimilarity", "userAffinity", "seen"):
        if not np.array_equal(getattr(cpu_model, a), getattr(model, a)):
            raise AssertionError(f"16c: {a} differs from a cpu fit")
    sub = {c: v[:SAR_CHECK_PAIRS] for c, v in cols.items()}
    cpu_scores = cpu_model.transform(Dataset(sub)).array("prediction")
    rel = float((np.abs(scores[:SAR_CHECK_PAIRS] - cpu_scores)
                 / np.maximum(np.abs(cpu_scores), 1e-30)).max())
    cids, cvals = recs_of(cpu_model, 10)
    full = (torch.as_tensor(cpu_model.userAffinity)
            @ torch.as_tensor(cpu_model.itemSimilarity))
    full.masked_fill_(torch.as_tensor(cpu_model.seen), float("-inf"))
    swaps = same_ranking(ids, vals, cids, cvals, full.numpy(),
                         SAR_SCORE_RTOL)
    zero_ties = int((cvals == 0).sum())
    log(f"fit {fit_s:.3f} s (cpu {cpu_s:.3f}), transform {n / tr_s:,.0f} "
        f"pairs/s ({tr_s:.3f} s), recommend_for_all_users(10) {rec_s:.3f} "
        f"s; similarity, affinity and seen equal to cpu's; scores within "
        f"{rel:.3g} relative on {SAR_CHECK_PAIRS:,} pairs; top 10 equal "
        f"to cpu's but {swaps} near-tie swaps ({zero_ties} zero-score "
        f"ties in the lists); {card}")
    if not rel <= SAR_SCORE_RTOL:
        raise AssertionError(f"16c: scores differ by {rel} relative")

    split = RankingTrainValidationSplit(
        estimator=RankingAdapter(SAR(device="cuda", **SAR_PARAMS), k=10),
        trainRatio=0.75, minRatingsPerUser=2, seed=0)
    fitted, split_s = timed(lambda: split.fit(ds))
    evald = fitted.transform(split.validation)
    ndcg = RankingEvaluator(metricName="ndcgAt", k=10).evaluate(evald)
    mapk = RankingEvaluator(metricName="map", k=10).evaluate(evald)
    rng = np.random.default_rng(6)
    rand = Dataset({"recommendations": [rng.choice(ML_ITEMS, 10,
                                                   replace=False)
                                        for _ in range(len(evald))],
                    "labels": list(evald["labels"])})
    ndcg_rand = RankingEvaluator(metricName="ndcgAt", k=10).evaluate(rand)
    log(f"RankingTrainValidationSplit(trainRatio=0.75) -> RankingAdapter"
        f"(SAR) {split_s:.3f} s; validation NDCG@10 {ndcg:.5f} (floor "
        f"{SAR_NDCG_FLOOR}; random {ndcg_rand:.5f}), MAP@10 {mapk:.5f}, "
        f"validationMetrics {split.get_or_default('validationMetrics')}")
    if not ndcg > SAR_NDCG_FLOOR:
        raise AssertionError(f"16c: NDCG@10 {ndcg} <= {SAR_NDCG_FLOOR}")
    if split.get_or_default("validationMetrics") != [ndcg]:
        raise AssertionError("16c: validationMetrics differ from NDCG@10")

    prev = sar_mod.DENSE_CELLS_MAX
    sar_mod.DENSE_CELLS_MAX = 0
    try:
        sparse, sp_s = timed(lambda: SAR(device="cuda", **SAR_PARAMS).fit(ds))
    finally:
        sar_mod.DENSE_CELLS_MAX = prev
    sim_diff = float(np.abs(sparse.itemSimilarity.toarray()
                            - model.itemSimilarity).max())
    sp_scores = sparse.transform(Dataset(sub)).array("prediction")
    sp_rel = float((np.abs(sp_scores - scores[:SAR_CHECK_PAIRS])
                    / np.maximum(np.abs(scores[:SAR_CHECK_PAIRS]),
                                 1e-30)).max())
    head = SARModel(itemSimilarity=sparse.itemSimilarity,
                    userAffinity=sparse.userAffinity[:SAR_SPARSE_USERS],
                    seen=sparse.seen[:SAR_SPARSE_USERS], device="cuda")
    (sids, svals), sp_rec_s = timed(lambda: recs_of(head, 10))
    sp_swaps = same_ranking(sids, svals, ids[:SAR_SPARSE_USERS],
                            vals[:SAR_SPARSE_USERS],
                            full.numpy()[:SAR_SPARSE_USERS], SAR_SCORE_RTOL)
    log(f"sparse path (DENSE_CELLS_MAX=0): fit {sp_s:.3f} s, similarity "
        f"{sim_diff:.3g} from the dense path's, scores {sp_rel:.3g} "
        f"relative, top 10 of {SAR_SPARSE_USERS} users in "
        f"{sp_rec_s:.3f} s equal but {sp_swaps} near-tie swaps")
    if not (sim_diff <= 1e-6 and sp_rel <= SAR_SCORE_RTOL):
        raise AssertionError(f"16c: sparse path differs: {sim_diff}, "
                             f"{sp_rel}")
    return {"fit_s": fit_s, "cpu_fit_s": cpu_s,
            "transform_pairs_per_s": n / tr_s, "recommend_s": rec_s,
            "score_rel": rel, "swaps": swaps, "zero_ties": zero_ties,
            "ndcg10": ndcg, "map10": mapk, "ndcg10_random": ndcg_rand,
            "split_s": split_s, "sparse_fit_s": sp_s,
            "sparse_recommend_s": sp_rec_s, "sparse_swaps": sp_swaps}


def access_scores(model, *sets):
    return [model.transform(s).array("anomaly_score") for s in sets]


def phase_access_anomaly(card) -> dict:
    """16d: ``AccessAnomaly`` (implicit, rank 10, 25 sweeps) on about 1.1M
    DataFactory access events; then implicit and explicit fits at one
    department's size, cuda against cpu."""
    t0 = time.perf_counter()
    f = DataFactory(num_users=AA_USERS, num_resources=AA_RESOURCES, seed=42)
    train = f.create_clustered_training_data(AA_RATIO)
    intra = f.create_clustered_intra_test_data(train)
    inter = f.create_clustered_inter_test_data()
    log(f"== phase 16d: AccessAnomaly(rankParam=10, maxIter=25) on "
        f"{len(train):,} access events of {sum(AA_USERS.values()):,} users "
        f"and {sum(AA_RESOURCES.values()):,} resources (data "
        f"{time.perf_counter() - t0:.1f} s on the host)")
    calls = []

    def recorded(*a, **kw):
        out, s = timed(lambda: real_als(*a, **kw))
        calls.append((a, kw, s, out))
        return out

    real_als = anomaly_mod.als_fit
    anomaly_mod.als_fit = recorded
    try:
        model, fit_s = timed(lambda: AccessAnomaly(device="cuda").fit(train))
    finally:
        anomaly_mod.als_fit = real_als
    (a, kw, als_s, (x, y)), = calls
    # the card's scatter-add is the sorted one: a second run is bit-equal
    # (the CPU's, on several threads, adds with atomics: checked on the
    # card only)
    x2, y2 = real_als(*a, **kw)
    same = bool(np.array_equal(x, x2) and np.array_equal(y, y2)
                or not torch.cuda.is_available())
    (s_intra, s_inter), tr_s = timed(lambda: access_scores(model, intra,
                                                           inter))
    gap = float(np.nanmean(s_inter) - np.nanmean(s_intra))
    rows = len(intra) + len(inter)
    log(f"fit {fit_s:.3f} s, of it ALS {als_s:.3f} s ({als_s / 25:.4f} s a "
        f"sweep, {len(a[0]):,} observations, {a[3]:,} x {a[4]:,}), "
        f"bit-equal on a second run: {same}; transform {rows / tr_s:,.0f} "
        f"rows/s; mean score inter {np.nanmean(s_inter):.4f} - intra "
        f"{np.nanmean(s_intra):.4f} = {gap:.4f} (floor {AA_MARGIN}); {card}")
    if not same:
        raise AssertionError("16d: two ALS runs on the card differ")
    if not gap > AA_MARGIN:
        raise AssertionError(f"16d: inter - intra {gap} <= {AA_MARGIN}")
    out = {"fit_s": fit_s, "als_s": als_s, "als_s_per_sweep": als_s / 25,
           "transform_rows_per_s": rows / tr_s, "gap": gap,
           "deterministic": same}

    fs = DataFactory(num_users=AA_SMALL_USERS,
                     num_resources=AA_SMALL_RESOURCES, seed=43)
    small = fs.create_clustered_training_data(AA_RATIO)
    probes = (small, fs.create_clustered_intra_test_data(small),
              fs.create_clustered_inter_test_data())
    moved = []
    for first in (0, 1):
        lik = small.array("likelihood").copy()
        lik[first::2] *= 1 + 2.0 ** -22
        moved.append(small.with_column("likelihood", lik))
    threads = torch.get_num_threads()
    for mode, kw in (("implicit", {}),
                     ("explicit", dict(applyImplicitCf=False,
                                       complementsetFactor=2))):
        fits = {}
        fits["card"], card_s = timed(
            lambda: AccessAnomaly(device="cuda", **kw).fit(small))
        # the CPU's scatter-add adds in index order on one thread (with
        # atomics on several): one thread makes the reference and its
        # spread repeatable
        torch.set_num_threads(1)
        try:
            t0 = time.perf_counter()
            fits["host"] = AccessAnomaly(device="cpu", **kw).fit(small)
            host_s = time.perf_counter() - t0
            for j, data in enumerate(moved):
                fits[j] = AccessAnomaly(device="cpu", **kw).fit(data)
        finally:
            torch.set_num_threads(threads)
        scores = {}
        for k, m in fits.items():
            m.preserve_history = False              # score training pairs
            scores[k] = np.concatenate(access_scores(m, *probes))
        got, want = scores["card"], scores["host"]
        fin = np.isfinite(want)
        spread = max(float(np.abs(scores[j] - want)[fin].max())
                     for j in (0, 1))
        diff = float(np.abs(got - want)[fin].max())
        same_rest = bool(np.array_equal(got[~fin], want[~fin],
                                        equal_nan=True))
        fits["card"].preserve_history = True
        _, s_in, s_out = access_scores(fits["card"], *probes)
        gap_s = float(np.nanmean(s_out) - np.nanmean(s_in))
        log(f"{mode} at {len(small):,} events: fit {card_s:.3f} s (cpu "
            f"{host_s:.3f}, one thread); scores cuda vs cpu {diff:.3g} (two "
            f"ulps on half the likelihoods move them {spread:.3g} on the "
            f"cpu; hold {AA_SPREAD_FACTOR:g}x), inter - intra {gap_s:.4f}")
        if not (same_rest and 0 < spread and diff <= AA_SPREAD_FACTOR
                * spread):
            raise AssertionError(f"16d {mode}: cuda vs cpu {diff} against "
                                 f"spread {spread}")
        if not gap_s > AA_MARGIN:
            raise AssertionError(f"16d {mode}: inter - intra {gap_s}")
        out[mode] = {"fit_s": card_s, "cpu_fit_s": host_s,
                     "diff": diff, "spread": spread, "gap": gap_s}
    return out


def phase_estimators(card) -> dict:
    """Phase 16: 16a-16d. No histogram kernel runs here (none of these
    modules had Pallas code: their device work is torch ops); the counts
    must stay at 0."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    out = {"16a": phase_isolation_forest(card), "16b": phase_knn(card),
           "16c": phase_sar(card), "16d": phase_access_anomaly(card)}
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 16 launched a histogram kernel: "
                             f"{counts}")
    out["kernels"] = "none: phase 16's device work is torch ops"
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 16: {out['seconds']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: DNN scoring: the ResNet/AlexNet catalog, DNNModel and
# ImageFeaturizer, the image ops, the model repository, streamed featurizing
# and LIME. The device work is torch's convolutions, pools and resizes; the
# one hand kernel it reaches is kernel 1, in 17c's GBDT head at F=2,048.
# ---------------------------------------------------------------------------

DNN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_dnn")
DNN_BATCH = 64
# 17a: preprocessed 224 x 224 images scored per lane, and the rows held
# cuda against cpu
DNN_LANE_IMAGES = 4096
DNN_CHECK_IMAGES = 4
DNN_OTHER_MODELS = ("ResNet18", "ResNet34", "ResNet101", "ResNet152",
                    "AlexNet")
# cuda against cpu: within this many times the spread that one ulp of
# input (an f32 ulp; a bf16 ulp for the bf16 lane) makes on the CPU.
# tools/dnn_tolerances.py (CPU, ResNet-50 at 224, 4 inputs) puts the CPU's
# own f32 error against an f64 forward at 0.74-1.12 times that spread
# (bf16: 0.54-1.11): two forwards of that accuracy differ by up to about
# twice it
DNN_SPREAD_FACTOR = 8.0
# ImageNet's common sizes (500x375, 375x500, 500x333, 333x500), as (H, W)
IMAGE_SHAPES = ((375, 500), (500, 375), (333, 500), (500, 333))
DNN_CLASSES = 4
# 17b-17c: images featurized (the first FEAT_TRAIN train the GBDT head, the
# rest are its holdout), and the share of None rows among them; the bf16
# lane and the f32 lane's stages in turn run on the first FEAT_SUBSET
FEAT_TRAIN, FEAT_HOLDOUT = 4096, 1024
FEAT_NONE_SHARE = 0.01
FEAT_SUBSET = 2048
# 17c's holdout accuracy floor (PERF.md §2, set from a CPU rehearsal at a
# reduced count before the first chip run)
DNN_ACCURACY_FLOOR = 0.95
# the two passes of kernel 1 timed at F=2,048: the root pass of FEAT_TRAIN
# rows and a half pass of half of them at the leaf batch
DNN_HIST_ROWS = ((FEAT_TRAIN, 1), (FEAT_TRAIN // 2, 8))
# 17d: rows streamed through stream_transform (chunks not a multiple of the
# batch), encoded images streamed from a directory
STREAM_ROWS, STREAM_CHUNK = 1024, 300
STREAM_FILES, STREAM_BATCH_FILES = 512, 256
# 17e: pictures explained at ImageLIME's defaults; the coefficients cuda
# against cpu within this share of their largest magnitude: 17a's hold
# lets the scores differ by 8 spreads, about 3e-6 of the largest logit,
# and the lasso on 1,000 masks of 150-196 superpixels moves its
# coefficients by 0.91-1.69 times a relative score change
# (tools/dnn_tolerances.py); two pictures keep the whole script inside
# its time (four took 68-79 s of it)
LIME_IMAGES = 2
LIME_COEF_RTOL = 1e-3
DIGITS_ROWS = 64


def dnn_images(n, seed):
    """``n`` uint8 pictures at ``IMAGE_SHAPES`` (one drawn per picture) and
    their labels in ``[0, DNN_CLASSES)``: a class's stripes (its own angle
    and frequency) and tint, shifted per picture, half-and-half with noise
    cut from one seeded pool."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, DNN_CLASSES, n)
    shapes = rng.integers(0, len(IMAGE_SHAPES), n)
    pool = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    patterns = {}
    for c in range(DNN_CLASSES):
        theta = np.pi * c / DNN_CLASSES
        tint = np.array([1.0, 0.6, 0.3])[np.roll(np.arange(3), c)]
        for s, (h, w) in enumerate(IMAGE_SHAPES):
            yy, xx = np.mgrid[0:2 * h, 0:2 * w].astype(np.float32)
            wave = np.sin(2 * np.pi * (6 + 3 * c) / 500.0
                          * (xx * np.cos(theta) + yy * np.sin(theta)))
            patterns[c, s] = np.clip(128 + 100 * wave[..., None] * tint,
                                     0, 255).astype(np.uint8)
    imgs = []
    for c, s in zip(labels, shapes):
        h, w = IMAGE_SHAPES[s]
        dy, dx = rng.integers(0, h), rng.integers(0, w)
        oy, ox = rng.integers(0, 1024 - h), rng.integers(0, 1024 - w)
        imgs.append((patterns[c, s][dy:dy + h, dx:dx + w] >> 1)
                    + (pool[oy:oy + h, ox:ox + w] >> 1))
    return imgs, labels


def preprocessed(n, seed) -> np.ndarray:
    """``n`` normalized 224 x 224 x 3 f32 inputs in [-1, 1)."""
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, 224, 224, 3)).astype(np.float32)


def ulp_up(x: np.ndarray, lane: str) -> np.ndarray:
    """``x`` moved up one ulp: of f32, or of the bf16 value the bf16 lane
    casts it to."""
    if lane == "f32":
        return np.nextafter(x, np.float32(np.inf))
    t = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16)
    return (t + 1).view(torch.bfloat16).float().numpy()


def fetch_on(model, x, dev, nodes):
    """``model``'s capture ``nodes`` of rows ``x`` on ``dev``: one pass
    through ``fetchDict`` in one batch of ``len(x)`` rows (the same batch
    shape on both devices, and no padded rows for the cpu to score)."""
    m = model.cloned_with_shared_params().clear("outputNode").set(
        inputCol="x", device=dev, fetchDict={n: n for n in nodes},
        miniBatchSize=len(x))
    out = m.transform(Dataset({"x": x}))
    return {n: out[n] for n in nodes}


def cuda_vs_cpu(model, x, lane, nodes, what) -> dict:
    """The model's nodes on cuda against cpu, held within
    ``DNN_SPREAD_FACTOR`` times the spread one ulp of input makes on the
    cpu, node by node."""
    got = fetch_on(model, x, "cuda", nodes)
    want = fetch_on(model, x, "cpu", nodes)
    moved = fetch_on(model, ulp_up(x, lane), "cpu", nodes)
    out = {}
    for n in nodes:
        diff = float(np.abs(got[n] - want[n]).max())
        spread = float(np.abs(moved[n] - want[n]).max())
        scale = float(np.abs(want[n]).max())
        log(f"{what} {n}: cuda vs cpu {diff:.4g}, one ulp of input "
            f"{spread:.4g} on the cpu (x{diff / max(spread, 1e-30):.3f}), "
            f"largest |value| {scale:.4g}")
        if not (np.isfinite(got[n]).all() and spread > 0
                and diff <= DNN_SPREAD_FACTOR * spread):
            raise AssertionError(f"{what} {n}: cuda vs cpu {diff} against "
                                 f"{DNN_SPREAD_FACTOR} x spread {spread}")
        out[n] = {"diff": diff, "spread": spread, "scale": scale}
    return out


def phase_dnn_models(card, x) -> tuple:
    """17a: ResNet-50 (``builtin://``, the port's draws) in f32 and bf16
    over ``x``; the rest of the catalog cuda against cpu. Returns the
    record and the two lanes' models."""
    dl = ModelDownloader(DNN_DIR)
    t0 = time.perf_counter()
    for name in ("ResNet50",) + DNN_OTHER_MODELS:
        dl.download_model(name)
    mat_s = time.perf_counter() - t0
    f32 = DNNModel.from_downloader(DNN_DIR, "ResNet50", device="cuda")
    spec = dict(f32.apply_spec)
    spec["config"] = dict(spec["config"], dtype="bfloat16")
    models = {"f32": f32, "bf16": DNNModel(f32.params, apply_spec=spec,
                                           device="cuda")}
    log(f"== phase 17a: DNNModel(builtin://ResNet50) at {len(x):,} x 224 x "
        f"224 x 3, miniBatchSize {DNN_BATCH}, f32 and bf16 (the catalog "
        f"materialized in {mat_s:.2f} s)")
    out = {"materialize_s": mat_s}
    xc = x[:DNN_CHECK_IMAGES]
    for lane, m in models.items():
        m.set(inputCol="x", outputCol="feat", outputNode="pool",
              miniBatchSize=DNN_BATCH)
        m.transform(Dataset({"x": x[:2 * DNN_BATCH]}))       # warm
        torch.cuda.reset_peak_memory_stats()
        feats, s = timed(lambda: m.transform(Dataset({"x": x}))["feat"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if feats.shape != (len(x), 2048) or not np.isfinite(feats).all():
            raise AssertionError(f"17a {lane}: features {feats.shape}, "
                                 "not all finite")
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("17a: the forward left TF32 off")
        dev = torch.device("cuda")
        fwd, params = m._forward("pool"), m._params_on(dev)
        xb = torch.from_numpy(x[:DNN_BATCH]).to(dev)

        def batch():
            with torch.inference_mode(), exact_f32(dev):
                fwd(params, xb)
        batch_ms = time_ms(batch, reps=10)
        log(f"{lane}: {len(x) / s:,.0f} images/s warm ({s:.3f} s), "
            f"{batch_ms:.3f} device ms a {DNN_BATCH}-image batch "
            f"({DNN_BATCH / batch_ms * 1e3:,.0f} images/s), peak "
            f"{peak:.3f} GiB; {card}")
        check = cuda_vs_cpu(m, xc, lane, ("logits", "pool"),
                            f"17a ResNet50 {lane}")
        out[lane] = {"images_per_s": len(x) / s, "seconds": s,
                     "batch_ms": batch_ms, "peak_gib": peak, "check": check}
    # what the scope keeps out: the same forward with cuDNN's default TF32
    with torch.inference_mode():
        raw = apply_cnn(models["f32"]._params_on(torch.device("cuda")),
                        torch.from_numpy(xc).cuda(),
                        models["f32"].apply_fn.cfg)[0].float().cpu().numpy()
    tf32 = float(np.abs(raw - fetch_on(models["f32"], xc, "cpu",
                                       ("logits",))["logits"]).max())
    log(f"the f32 forward outside exact_f32 (cuDNN's TF32 on): logits "
        f"{tf32:.4g} from the cpu's; inside: {out['f32']['check']['logits']['diff']:.4g}")
    out["tf32_logits_diff"] = tf32
    for name in DNN_OTHER_MODELS:
        m = DNNModel.from_downloader(DNN_DIR, name)
        node = "fc7" if name == "AlexNet" else "pool"
        out[name] = cuda_vs_cpu(m, xc, "f32", ("logits", node),
                                f"17a {name}")
    return out, models


def with_nones(imgs, labels, seed):
    """``imgs`` with ``FEAT_NONE_SHARE`` of None rows put among them (label
    -1)."""
    rng = np.random.default_rng(seed)
    n_none = int(round(len(imgs) * FEAT_NONE_SHARE))
    at = set(rng.choice(len(imgs) + n_none, n_none, replace=False).tolist())
    col, lab, it = [], [], iter(zip(imgs, labels))
    for i in range(len(imgs) + n_none):
        if i in at:
            col.append(None)
            lab.append(-1)
        else:
            img, y = next(it)
            col.append(img)
            lab.append(y)
    return col, np.asarray(lab)


def phase_featurizer(card, models, imgs, labels) -> tuple:
    """17b: ``ImageFeaturizer`` (resize -> normalize -> ResNet-50 pool) on
    ragged uint8 pictures with 1% None rows, both lanes; the f32 lane's time
    split into its stages. Returns the record and the f32 features."""
    col, lab = with_nones(imgs, labels, seed=172)
    log(f"== phase 17b: ImageFeaturizer(ResNet50) on {len(imgs):,} ragged "
        f"uint8 pictures at {IMAGE_SHAPES} and {len(col) - len(imgs)} None "
        f"rows (bf16 on the first {FEAT_SUBSET:,} pictures)")
    out, feats = {}, {}
    at = [i for i, v in enumerate(col) if v is not None]
    for lane, m in models.items():
        sub = len(imgs) if lane == "f32" else min(FEAT_SUBSET, len(imgs))
        upto = at[sub - 1] + 1 if sub < len(imgs) else len(col)
        ds = Dataset({"img": col[:upto], "label": lab[:upto]})
        f = ImageFeaturizer(m, input_hw=(224, 224), device="cuda").set(
            inputCol="img", outputCol="features", miniBatchSize=DNN_BATCH)
        f.transform(Dataset({"img": imgs[:DNN_BATCH]}))       # warm
        torch.cuda.reset_peak_memory_stats()
        res, s = timed(lambda: f.transform(ds))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = res["features"]
        if (len(res) != sub or got.shape != (sub, 2048)
                or not np.isfinite(got).all()
                or not np.array_equal(res["label"], labels[:sub])):
            raise AssertionError(f"17b {lane}: dropNa kept {len(res)} rows "
                                 f"of {sub}, features {got.shape}")
        log(f"{lane}: {sub / s:,.0f} rows/s ({s:.3f} s for {sub:,}), peak "
            f"{peak:.3f} GiB; {card}")
        out[lane] = {"rows_per_s": sub / s, "seconds": s, "rows": sub,
                     "peak_gib": peak}
        feats[lane] = (f, got)
    f, got = feats["f32"]
    n = min(FEAT_SUBSET, len(imgs))
    valid = Dataset({"img": imgs[:n]})
    resized, resize_s = timed(lambda: ImageTransformer(device="cuda").set(
        inputCol="img", outputCol="r").resize(224, 224).transform(valid)["r"])
    t0 = time.perf_counter()
    prepped = normalize_image(resized, f.norm_mean, f.norm_std)
    host_s = time.perf_counter() - t0
    inner = f._dnn_clone
    fwd_out, fwd_s = timed(lambda: inner.transform(
        Dataset({"_img_prepped": prepped}))["features"])
    if not np.array_equal(fwd_out, got[:n]):
        raise AssertionError("17b: the stages in turn differ from the "
                             "featurizer's features")
    log(f"f32 stages in turn on {n:,} pictures: resize on the device "
        f"{resize_s:.3f} s ({n / resize_s:,.0f} rows/s, uploads and "
        f"read-back included), normalize on the host {host_s:.3f} s "
        f"({n / host_s:,.0f} rows/s), forward {fwd_s:.3f} s "
        f"({n / fwd_s:,.0f} rows/s)")
    out["f32"].update(split_rows=n, resize_s=resize_s,
                      host_normalize_s=host_s, forward_s=fwd_s)
    head = Dataset({"img": col[:512]})
    kept = f.copy({}).set(dropNa=False).transform(head)["features"]
    dropped = f.transform(head)["features"]
    nones = [i for i, v in enumerate(col[:512]) if v is None]
    if ([i for i, v in enumerate(kept) if v is None] != nones
            or not np.array_equal(np.stack([v for v in kept
                                            if v is not None]), dropped)):
        raise AssertionError("17b: dropNa=False differs from dropNa=True")
    log(f"dropNa: {len(col) - len(imgs)} None rows dropped; kept as None at "
        f"{nones} of the first 512 with the other rows' features equal")
    return out, got


def phase_transfer(card, feats, labels) -> dict:
    """17c: the pooled features into ``LightGBMClassifier`` (10 rounds, 31
    leaves): kernel 1 at F=2,048, no plain version; then kernel 1's root
    and half pass at that width against their plain version, bound and
    ``index_add_``."""
    Xtr, ytr = feats[:FEAT_TRAIN], labels[:FEAT_TRAIN].astype(np.float64)
    Xte, yte = feats[FEAT_TRAIN:], labels[FEAT_TRAIN:]
    log(f"== phase 17c: LightGBMClassifier on {len(Xtr):,} x "
        f"{Xtr.shape[1]:,} pooled features, {DNN_CLASSES} classes, holdout "
        f"{len(Xte):,}")
    est = LightGBMClassifier(numIterations=10, numLeaves=31, device="cuda")
    gbdt_api.clear_binned_dataset_cache()
    torch.cuda.synchronize()
    reset_counts()
    model, fit_s = timed(lambda: est.fit(Dataset({"features": Xtr,
                                                  "label": ytr})))
    pred = model.transform(Dataset({"features": Xte})).array("prediction")
    counts = read_counts()
    acc = float((pred == yte).mean())
    log(f"fit {fit_s:.3f} s, holdout accuracy {acc:.5f} (floor "
        f"{DNN_ACCURACY_FLOOR}, majority "
        f"{np.bincount(yte).max() / len(yte):.5f}); launches {counts}; "
        f"{card}")
    if counts["node_hist_bf16"] <= 0 or counts["plain"] != 0:
        raise AssertionError(f"17c: kernel 1 must launch and no plain "
                             f"version run: {counts}")
    if not acc > DNN_ACCURACY_FLOOR:
        raise AssertionError(f"17c: accuracy {acc} <= {DNN_ACCURACY_FLOOR}")
    gen = torch.Generator(device="cuda").manual_seed(17)
    F = feats.shape[1]
    rows = {}
    for n, W in DNN_HIST_ROWS:
        b32, pos, base = hist_inputs(gen, n, F, W, 255)
        binned = b32.to(torch.uint8)
        want = node_hist_plain(binned, pos, base, W, 255)
        got = hist_ops.node_histogram(binned, pos, base, W, 255)
        torch.cuda.synchronize()
        err = check_hist(got, want)
        key = (n, W, 255, "uint8", F)
        r = node_row(lambda: hist_ops.node_histogram(binned, pos, base, W,
                                                     255),
                     lambda: node_hist_plain(binned, pos, base, W, 255),
                     binned, pos, base, W, 255, cold=True)
        rows[f"n={n} W={W}"] = dict(r, max_abs_err=err)
        log_row(f"node_hist F={F}", key, r, f"max_abs_err {err:.3g}")
        del b32, binned, pos, base, want, got
    return {"counts": counts, "fit_s": fit_s, "accuracy": acc,
            "kernel_rows": rows}


def write_jpegs(imgs, path) -> None:
    from PIL import Image
    os.makedirs(path, exist_ok=True)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(os.path.join(path, f"img{i:05d}.jpg"),
                                  quality=90)
    with open(os.path.join(path, "img99999.jpg"), "wb") as f:
        f.write(b"not a picture")


def phase_dnn_streaming(card, models, x, imgs) -> dict:
    """17d: ``stream_transform`` over ``.npy`` shards and
    ``stream_featurize_images`` over a directory of JPEG files (one
    corrupt), each bit-equal to its in-memory run on the card."""
    import PIL
    log(f"== phase 17d: streamed scoring; PIL {PIL.__version__}")
    root = os.path.join(DNN_DIR, "stream")
    shutil.rmtree(root, ignore_errors=True)
    m = models["f32"]
    xs = x[:STREAM_ROWS]
    write_shards([xs[:400], xs[400:401], xs[401:]], os.path.join(root, "x"))
    want = m.transform(Dataset({"x": xs}))["feat"]
    got, s = timed(lambda: stream_transform(m, os.path.join(root, "x"),
                                            chunk_rows=STREAM_CHUNK))
    if not np.array_equal(got, want):
        raise AssertionError("17d: stream_transform differs from transform: "
                             f"{float(np.abs(got - want).max())}")
    log(f"stream_transform: {STREAM_ROWS:,} rows in chunks of "
        f"{STREAM_CHUNK} over 3 shards, {STREAM_ROWS / s:,.0f} rows/s, "
        "bit-equal to transform")
    t0 = time.perf_counter()
    write_jpegs(imgs[:STREAM_FILES], os.path.join(root, "imgs"))
    enc_s = time.perf_counter() - t0
    f = ImageFeaturizer(m, input_hw=(224, 224), device="cuda").set(
        inputCol="img", outputCol="features", miniBatchSize=DNN_BATCH)
    (paths, feats), s2 = timed(lambda: stream_featurize_images(
        f, os.path.join(root, "imgs"), batch_files=STREAM_BATCH_FILES))
    decoded = []
    for p in paths:
        with open(p, "rb") as fh:
            decoded.append(decode_image(fh.read()))
    mem = f.transform(Dataset({"img": decoded}))["features"]
    if len(paths) != STREAM_FILES or not np.array_equal(feats, mem):
        raise AssertionError(f"17d: {len(paths)} files featurized; streamed "
                             "features differ from in-memory ones")
    log(f"stream_featurize_images: {STREAM_FILES} JPEGs (encoded in "
        f"{enc_s:.2f} s) and one corrupt file, batches of "
        f"{STREAM_BATCH_FILES}: {STREAM_FILES / s2:,.0f} files/s, the corrupt "
        "file skipped, features bit-equal to the in-memory featurizer's")
    return {"stream_transform_rows_per_s": STREAM_ROWS / s,
            "stream_featurize_files_per_s": STREAM_FILES / s2}


def phase_lime(card, models, x) -> dict:
    """17e: ``ImageLIME`` over the ResNet-50 ``DNNModel`` at its defaults
    on 224 x 224 pictures: s per explanation (the inner model's transforms
    timed apart), the coefficients cuda against cpu on one picture."""
    def inner(dev):
        m = models["f32"].cloned_with_shared_params().set(
            inputCol="img", outputCol="probability", outputNode="logits",
            miniBatchSize=DNN_BATCH, device=dev)
        spent = [0.0]
        scored = m.transform

        def transform(ds):
            out, s = timed(lambda: scored(ds))
            spent[0] += s
            return out
        m.transform = transform
        return m, spent

    imgs = list(x[:LIME_IMAGES])
    lime_cuda, dev_s = inner("cuda")
    log(f"== phase 17e: ImageLIME(DNNModel ResNet50) at its defaults on "
        f"{LIME_IMAGES} pictures of 224 x 224")
    out, s = timed(lambda: ImageLIME(model=lime_cuda).set(
        inputCol="img", outputCol="w").transform(Dataset({"img": imgs})))
    per = s / LIME_IMAGES
    dev_per = dev_s[0] / LIME_IMAGES
    coefs = out["w"]
    lime_cpu, _ = inner("cpu")
    t0 = time.perf_counter()
    want = ImageLIME(model=lime_cpu).set(inputCol="img", outputCol="w"
                                         ).transform(
        Dataset({"img": imgs[:1]}))["w"][0]
    cpu_s = time.perf_counter() - t0
    diff = float(np.abs(coefs[0] - want).max())
    scale = float(np.abs(want).max())
    log(f"{per:.3f} s an explanation: the DNNModel's transforms {dev_per:.3f}"
        f" s (1,000 masked pictures, upload and read-back included), the "
        f"host {per - dev_per:.3f} s (superpixels, masks, lasso); "
        f"{len(coefs[0])} superpixels; coefficients cuda vs cpu {diff:.4g} "
        f"of largest {scale:.4g} (the cpu's explanation {cpu_s:.1f} s); "
        f"{card}")
    if not (all(np.isfinite(c).all() for c in coefs) and scale > 0
            and diff <= LIME_COEF_RTOL * scale):
        raise AssertionError(f"17e: coefficients cuda vs cpu {diff} > "
                             f"{LIME_COEF_RTOL} x {scale}")
    return {"s_per_explanation": per, "device_s": dev_per,
            "host_s": per - dev_per, "coef_diff": diff, "coef_scale": scale,
            "cpu_explanation_s": cpu_s}


def phase_digits(card) -> dict:
    """17f: the DigitsConvNet fixture: pinned hash, then logits cuda
    against cpu on 32 x 32 inputs."""
    import hashlib
    from mmlspark_tpu_torch.models.dnn.downloader import _TRAINED_FIXTURES
    log("== phase 17f: the DigitsConvNet fixture")
    shutil.rmtree(os.path.join(DNN_DIR, "DigitsConvNet"), ignore_errors=True)
    schema = ModelDownloader(DNN_DIR).download_model("DigitsConvNet")
    with open(os.path.join(DNN_DIR, "DigitsConvNet", "model.pkl"),
              "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    pinned = _TRAINED_FIXTURES["DigitsConvNet"]["sha256"]
    if not schema.sha256 == digest == pinned:
        raise AssertionError(f"17f: fixture hash {digest} != {pinned}")
    m = DNNModel.from_downloader(DNN_DIR, "DigitsConvNet")
    x = np.random.default_rng(18).uniform(-1, 1, (DIGITS_ROWS, 32, 32, 3)
                                          ).astype(np.float32)
    check = cuda_vs_cpu(m, x, "f32", ("logits",), "17f DigitsConvNet")
    return {"sha256": digest, "check": check}


def phase_dnn(card) -> dict:
    """Phase 17: 17a-17f, with cuDNN's TF32 at PyTorch's default (on): the
    port's f32 forward must turn it off itself. The histogram counts are
    reset before 17a and read after 17c's fit: kernel 1 only, no plain
    version; 17d-17f launch none."""
    t0 = time.perf_counter()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = preprocessed(DNN_LANE_IMAGES, seed=17)
        imgs, labels = dnn_images(FEAT_TRAIN + FEAT_HOLDOUT, seed=171)
        log(f"phase 17 data: {time.perf_counter() - t0:.1f} s on the host")
        torch.cuda.synchronize()
        reset_counts()
        out = {"data_s": time.perf_counter() - t0, "sub_s": {}}

        def sub(key, fn):
            t1 = time.perf_counter()
            res = fn()
            out["sub_s"][key] = time.perf_counter() - t1
            return res
        out["17a"], models = sub("17a", lambda: phase_dnn_models(card, x))
        out["17b"], feats = sub("17b", lambda: phase_featurizer(
            card, models, imgs, labels))
        out["17c"] = sub("17c", lambda: phase_transfer(card, feats, labels))
        reset_counts()
        out["17d"] = sub("17d", lambda: phase_dnn_streaming(card, models, x,
                                                            imgs))
        out["17e"] = sub("17e", lambda: phase_lime(card, models, x))
        out["17f"] = sub("17f", lambda: phase_digits(card))
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts.values()):
            raise AssertionError(f"17d-17f launched a histogram kernel: "
                                 f"{counts}")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        shutil.rmtree(DNN_DIR, ignore_errors=True)    # about 1 GB of payloads
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 17: {out['seconds']:.1f} s (data {out['data_s']:.1f} s, "
        + ", ".join(f"{k} {v:.1f} s" for k, v in out["sub_s"].items())
        + f") on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 18: AutoML, and the HTTP stages against the port's own serving
# ---------------------------------------------------------------------------

P18_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_p18")
# the JAX package's sweep test grid (tests/test_classic_ml.py): 8 trials
TUNE_GRID = {"learningRate": [0.05, 0.1, 0.2, 0.4], "lambdaL2": [0.0, 1.0]}
TUNE_FOLDS = 2
TUNE_PARAMS = dict(numIterations=10, numLeaves=31, maxBin=255)
# 18b's rows: a fold trains on 2,000, inside the sweep's envelope (under
# 8,192 rows). A fold's AUC over 2,000 rows moves 1e-6 when one pair of
# near-equal margins swaps, and the margins' right-child cancellation
# grows with the rows (PERF.md, PR 16)
TUNE_SMALL_ROWS = 4_000
TUNE_SMALL_LEAF = 100        # phase 5's rule: leaves of 100+ rows at small n
HISTORY_RTOL = 1e-6
HTTP_ROWS = 5_000
HTTP_CONCURRENCY = (1, 16)
HTTP_BAD_ROWS = 1_000        # the wrong-width check's rows
HTTP_FORWARD_ROWS = 2_000
HTTP_ATOL = 1e-6
POWERBI_BATCH = 1_000
DIGITS_HTTP_ROWS = 64


def tune_space():
    return GridSpace({k: DiscreteHyperParam(v) for k, v in TUNE_GRID.items()})


def fold_train(ds, i=0):
    """The training rows of ``TuneHyperparameters``' fold ``i``: its
    split of ``ds``, every fold but ``i`` in order."""
    folds = ds.split([1.0 / TUNE_FOLDS] * TUNE_FOLDS, seed=0)
    train = None
    for j, f in enumerate(folds):
        if j != i:
            train = f if train is None else train.union(f)
    return train


class FitClock:
    """While installed, the wall seconds of every ``train_booster`` call
    (the sweep's trials and the estimators' fits), each ended by a device
    synchronize. Nothing else of a fit changes."""

    def __enter__(self):
        self.seconds = []
        self._saved = (booster_mod.train_booster, gbdt_api.train_booster)
        real = self._saved[0]

        def timed(*a, **k):
            t0 = time.perf_counter()
            b = real(*a, **k)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return b
        booster_mod.train_booster = gbdt_api.train_booster = timed
        return self

    def __exit__(self, *exc):
        booster_mod.train_booster, gbdt_api.train_booster = self._saved


def sweep_against_fits(est, maps, train) -> dict:
    """Each trial of ``swept_fit`` against ``est.copy(pm).fit`` on the
    same rows: how many boosters are byte-equal and how many trees have
    the same structure, and the largest margin difference on the first
    20,000 rows."""
    swept = swept_fit(est, maps, train)
    Xc = train.array("features", np.float32)[:20_000]
    same_bytes = same_trees = 0
    worst = 0.0
    for pm, model in zip(maps, swept):
        ref = est.copy(pm).fit(train)
        a, b = model.booster, ref.booster
        same_bytes += a.model_string() == b.model_string()
        same_trees += all(np.array_equal(a.trees[f], b.trees[f]) for f in
                          ("feat", "thr_bin", "left", "right", "is_leaf"))
        worst = max(worst, margin_diff(a.predict_raw(Xc, device="cuda"),
                                       b.predict_raw(Xc, device="cuda")))
    return dict(trials=len(maps), byte_equal=same_bytes,
                same_structure=same_trees, margin_diff=worst)


def phase_tune(data) -> tuple:
    """18a: ``TuneHyperparameters`` over the 8-trial grid, 2 folds of
    phase 4's rows, AUC, both routes with ``histSubtraction=False``, on
    kernel 1: histories within ``HISTORY_RTOL`` (kernel 1 sums with float
    atomics, so two runs of one fit may differ in the last bits); kernel 1
    launches and no plain version runs. Fold 0's swept trials against
    their sequential fits: byte-equal under the deterministic mode
    (``MMLSPARK_TPU_HIST_BLOCKS=8``), and on kernel 1 read as equal
    bytes, equal structure and the largest margin difference. The default
    config falls back at this row count; the best model is over
    ``AUC_FLOOR`` on the holdout. Returns (readings, fits, the tuned
    model)."""
    X, y, Xh, yh = data
    trials = len(list(tune_space().param_maps()))
    log(f"== phase 18a: TuneHyperparameters, {trials} trials x "
        f"{TUNE_FOLDS} folds of {len(y):,} x 28 rows (a fold's fit on "
        f"{len(y) - len(y) // TUNE_FOLDS:,}; {shown(TUNE_PARAMS)}, "
        "histSubtraction=False), swept and sequential")
    est = LightGBMClassifier(histSubtraction=False, device="cuda",
                             **TUNE_PARAMS)
    train = Dataset({"features": X, "label": y})
    out, fits, tuned = {}, {}, {}
    for route, par in (("swept", trials), ("sequential", 1)):
        gbdt_api.clear_binned_dataset_cache()
        gbdt_api.binned_cache_stats(reset=True)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with FitClock() as clock:
            tuned[route] = TuneHyperparameters(
                models=[est], evaluationMetric="AUC", numFolds=TUNE_FOLDS,
                paramSpace=tune_space(), parallelism=par).fit(train)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        cache = gbdt_api.binned_cache_stats()
        # the last fit is the best params' refit on every row
        trial_s = clock.seconds[:-1]
        if len(trial_s) != trials * TUNE_FOLDS:
            raise AssertionError(f"18a {route}: {len(trial_s)} trial fits, "
                                 f"not {trials * TUNE_FOLDS}")
        if counts["node_hist_bf16"] <= 0 or counts["plain"] != 0:
            raise AssertionError(f"18a {route}: launches {counts}")
        t = tuned[route]
        out[route] = dict(
            wall_s=wall, trial_fits=len(trial_s),
            s_per_trial_fit=float(np.mean(trial_s)),
            trial_fit_s_min=float(np.min(trial_s)),
            trial_fit_s_max=float(np.max(trial_s)),
            refit_s=clock.seconds[-1], cache=cache,
            cv_auc=t.get_or_default("bestMetric"),
            best_params=t.get_or_default("bestParams"))
        fits[f"18a_{route}"] = dict(counts=counts, fit_s=wall)
        log(f"18a {route}: {wall:.3f} s, {len(trial_s)} trial fits "
            f"{np.mean(trial_s):.3f} s each ({np.min(trial_s):.3f}-"
            f"{np.max(trial_s):.3f}), refit {clock.seconds[-1]:.3f} s; "
            f"binned cache {cache}; launches {counts}; CV AUC "
            f"{t.get_or_default('bestMetric'):.6f} at "
            f"{t.get_or_default('bestParams')}")
    hs = tuned["swept"].get_or_default("history")
    hq = tuned["sequential"].get_or_default("history")
    rel = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in zip(hs, hq))
    out["history_rel"] = rel
    out["history_bit_equal"] = sum(a[2] == b[2] for a, b in zip(hs, hq))
    if [a[:2] for a in hs] != [b[:2] for b in hq] or rel > HISTORY_RTOL:
        raise AssertionError(f"18a: the routes' histories differ (rel "
                             f"{rel}): {hs} != {hq}")
    # fold 0's swept trials against their sequential fits
    train0 = fold_train(train)
    maps = list(tune_space().param_maps())
    out["kernel1_fold0"] = sweep_against_fits(est, maps, train0)
    os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = str(HIST_BLOCKS)
    try:
        reset_counts()
        det = sweep_against_fits(est, maps, train0)
        det["counts"] = read_counts()
    finally:
        del os.environ["MMLSPARK_TPU_HIST_BLOCKS"]
    out["det_fold0"] = det
    fits["18a_det_fold0"] = dict(counts=det["counts"])
    if (det["byte_equal"] != len(maps) or det["counts"]["node_hist_det"] <= 0
            or det["counts"]["node_hist_bf16"] or det["counts"]["plain"]):
        raise AssertionError(f"18a: under the deterministic mode {det}")
    default = LightGBMClassifier(device="cuda", **TUNE_PARAMS)
    if swept_fit(default, maps, train0) is not None:
        raise AssertionError("18a: the default config swept at "
                             f"{len(train0):,} rows (subtraction engages)")
    best = tuned["swept"]
    probs = best.transform(Dataset({"features": Xh, "label": yh})
                           ).array("probability")
    out["holdout_auc"] = auc_of(probs[:, 1], yh)
    if not out["holdout_auc"] > AUC_FLOOR:
        raise AssertionError(f"18a: holdout AUC {out['holdout_auc']} <= "
                             f"{AUC_FLOOR}")
    k1 = out["kernel1_fold0"]
    log(f"18a: histories {out['history_bit_equal']} of {len(hs)} bit-equal,"
        f" within {rel:.3g} relative; fold 0 on kernel 1: {k1['byte_equal']}"
        f" of {len(maps)} swept trials byte-equal to their sequential fits, "
        f"{k1['same_structure']} the same structure, margins within "
        f"{k1['margin_diff']:.3g}; under MMLSPARK_TPU_HIST_BLOCKS="
        f"{HIST_BLOCKS}: {det['byte_equal']} of {len(maps)} byte-equal "
        f"({det['counts']['node_hist_det']} node_hist_det launches); the "
        f"default config falls back at {len(train0):,} rows; holdout AUC "
        f"{out['holdout_auc']:.5f} (floor {AUC_FLOOR})")
    return out, fits, best


def phase_tune_small(base, quantized, best, Xh, yh) -> dict:
    """18b: the same tuning on a few thousand rows at the default config
    (the sweep's envelope), cuda against cpu: trees identical, margins
    within 1e-5, histories within ``HISTORY_RTOL``; then
    ``FindBestModel`` over phases 4's and 4b's models and 18a's on phase
    4's holdout."""
    log(f"== phase 18b: the tuning on {TUNE_SMALL_ROWS:,} rows cuda vs cpu;"
        " FindBestModel over three models")
    X, y = higgs_shaped(TUNE_SMALL_ROWS, seed=18)
    ds = Dataset({"features": X, "label": y})
    train0 = fold_train(ds)
    maps = list(tune_space().param_maps())
    runs = {}
    for dev in ("cuda", "cpu"):
        est = LightGBMClassifier(minDataInLeaf=TUNE_SMALL_LEAF, device=dev,
                                 **TUNE_PARAMS)
        tuned = TuneHyperparameters(
            models=[est], evaluationMetric="AUC", numFolds=TUNE_FOLDS,
            paramSpace=tune_space(), parallelism=len(maps)).fit(ds)
        models = swept_fit(est, maps, train0)
        if models is None:
            raise AssertionError(f"18b: no sweep at {len(train0):,} rows")
        runs[dev] = (tuned.get_or_default("history"), models)
    (hc, mc), (hp, mp) = runs["cuda"], runs["cpu"]
    worst = 0.0
    for a, b in zip(mc, mp):
        ta, tb = a.booster.trees, b.booster.trees
        for f in ("feat", "thr_bin", "left", "right", "is_leaf"):
            if not np.array_equal(ta[f], tb[f]):
                raise AssertionError(f"18b: trees differ in {f}")
        worst = max(worst, margin_diff(
            a.booster.predict_raw(X, device="cuda"),
            b.booster.predict_raw(X, device="cpu")))
    if not worst <= 1e-5:
        raise AssertionError(f"18b: margins cuda vs cpu differ by {worst}")
    rel = max(abs(a[2] - b[2]) / max(abs(b[2]), 1e-12)
              for a, b in zip(hc, hp))
    if [a[:2] for a in hc] != [b[:2] for b in hp] or rel > HISTORY_RTOL:
        raise AssertionError(f"18b: histories differ (rel {rel})")
    hold = Dataset({"features": Xh, "label": yh})
    candidates = [LightGBMClassificationModel(b, numClasses=2, device="cuda")
                  for b in (base, quantized)] + [best]
    fb = FindBestModel(models=candidates, evaluationMetric="AUC").fit(hold)
    each = [evaluate_metric(m.transform(hold), "AUC") for m in candidates]
    table = [float(v) for v in fb.get_evaluation_results().array("AUC")]
    pick = int(np.argmax(each))
    if (table != each or fb.get_or_default("bestMetric") != each[pick]
            or fb.get_or_default("bestModel") is not candidates[pick]):
        raise AssertionError(f"18b: FindBestModel table {table}, best "
                             f"{fb.get_or_default('bestMetric')}; each "
                             f"{each}")
    log(f"18b: {len(mc)} trials' trees identical, margins within "
        f"{worst:.3g}, histories within {rel:.3g} relative; FindBestModel "
        f"AUCs {each}, picked {pick}")
    return dict(margin_diff=worst, history_rel=rel, find_best_auc=each,
                find_best_pick=pick)


class _Collector:
    """A local stub of the Power BI push endpoint: keeps every POSTed
    body."""

    def __init__(self):
        import http.server
        bodies = self.bodies = []
        lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n)
                with lock:
                    bodies.append(body)
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("localhost", 0),
                                                     Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://localhost:{self.httpd.server_address[1]}/rows"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def http_replies(out, want, what) -> float:
    """The largest |reply - predict| over rows that succeeded; every row
    must have."""
    err = list(out["err"])
    bad = [i for i, e in enumerate(err) if e is not None]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} rows failed, first "
                             f"{err[bad[0]]}")
    got = np.asarray([r["prediction"] for r in out["reply"]], np.float64)
    return float(np.abs(got - want.reshape(got.shape)).max())


def start_http_worker(quantized) -> Proc:
    """18c's ``serving_main worker`` on phase 4b's booster saved as
    ``.npz``, started before 18a so that its interpreter comes up while
    the card tunes."""
    shutil.rmtree(P18_DIR, ignore_errors=True)
    os.makedirs(P18_DIR)
    path = os.path.join(P18_DIR, "higgs_4b.npz")
    quantized.save(path)
    return Proc(["-m", "mmlspark_tpu_torch.io.serving_main", "worker",
                 "--model", path, "--registry",
                 os.path.join(P18_DIR, "registry"), "--engine", "async",
                 "--host", "localhost", "--port", "0", "--api-name",
                 "higgs", "--max-batch", str(SERVE_MAX_BATCH),
                 "--device", "cuda"])


def phase_http(quantized, Xh, worker, card) -> dict:
    """18c: the worker of :func:`start_http_worker`, driven by
    ``SimpleHTTPTransformer`` (JSON parsers) over ``HTTP_ROWS`` holdout
    rows at each of ``HTTP_CONCURRENCY``: replies within ``HTTP_ATOL`` of
    ``predict`` on cuda; a row of the wrong width in ``errorCol``; the
    same through a ``PortForwarder``; a ``PowerBIWriter`` delivering every
    row once to a local stub."""
    log(f"== phase 18c: SimpleHTTPTransformer against a serving_main worker"
        f" on phase 4b's booster, {HTTP_ROWS:,} rows")
    collector = _Collector()
    out = {"rows_per_s": {}}
    try:
        port = int(worker.wait_line(r"serving on [^:\s]+:(\d+)").group(1))
        url = f"http://localhost:{port}/higgs"
        rows = Xh[:HTTP_ROWS]
        want = quantized.predict(rows, device="cuda")
        ds = Dataset({"value": [{"features": [float(v) for v in r]}
                                for r in rows]})

        def client(u, conc):
            return SimpleHTTPTransformer().set(
                inputCol="value", outputCol="reply", errorCol="err",
                url=u, concurrency=conc, backoffs=[])

        replies = {}
        for conc in HTTP_CONCURRENCY:
            t0 = time.perf_counter()
            res = client(url, conc).transform(ds)
            secs = time.perf_counter() - t0
            out["rows_per_s"][conc] = len(rows) / secs
            d = http_replies(res, want, f"18c concurrency {conc}")
            if not d <= HTTP_ATOL:
                raise AssertionError(f"18c concurrency {conc}: replies "
                                     f"{d} from predict")
            replies[conc] = list(res["reply"])
            log(f"18c concurrency {conc}: {len(rows) / secs:,.1f} rows/s, "
                f"replies within {d:.3g} of predict")
        if replies[HTTP_CONCURRENCY[0]] != replies[HTTP_CONCURRENCY[-1]]:
            raise AssertionError("18c: replies differ by concurrency")
        bad_vals = list(ds["value"][:HTTP_BAD_ROWS])
        bad_vals[13] = {"features": [1.0, 2.0]}
        res = client(url, HTTP_CONCURRENCY[-1]).transform(
            Dataset({"value": bad_vals}))
        err = list(res["err"])
        if (err[13] is None or not 400 <= err[13]["statusCode"] < 500
                or res["reply"][13] is not None):
            raise AssertionError(f"18c: the wrong-width row gave {err[13]}")
        if any(e is not None for i, e in enumerate(err) if i != 13) or (
                [r for i, r in enumerate(res["reply"]) if i != 13]
                != [r for i, r in enumerate(replies[HTTP_CONCURRENCY[-1]]
                                            [:HTTP_BAD_ROWS]) if i != 13]):
            raise AssertionError("18c: rows beside the wrong-width one "
                                 "failed or changed")
        with PortForwarder("localhost", port) as fwd:
            res = client(f"http://localhost:{fwd.local_port}/higgs",
                         HTTP_CONCURRENCY[-1]).transform(
                Dataset({"value": ds["value"][:HTTP_FORWARD_ROWS]}))
        if (list(res["reply"]) != replies[HTTP_CONCURRENCY[-1]]
                [:HTTP_FORWARD_ROWS] or any(e is not None
                                            for e in res["err"])):
            raise AssertionError("18c: replies through the forwarder "
                                 "differ")
        t0 = time.perf_counter()
        writer = PowerBIWriter(collector.url, batch_size=POWERBI_BATCH)
        writer.write(Dataset({"id": np.arange(len(rows)),
                              "prediction": want.reshape(len(rows), -1)[:, 0]
                              .astype(np.float64)}))
        writer.flush()
        pbi_s = time.perf_counter() - t0
        got = [r for b in collector.bodies for r in json.loads(b)]
        ids = sorted(r["id"] for r in got)
        if ids != list(range(len(rows))):
            raise AssertionError(f"18c: Power BI got {len(ids)} rows, "
                                 f"{len(set(ids))} distinct")
        out.update(powerbi_batches=len(collector.bodies),
                   powerbi_rows_per_s=len(rows) / pbi_s,
                   forwarded_rows=HTTP_FORWARD_ROWS)
        log(f"18c: wrong-width row in errorCol ({err[13]['statusCode']}), "
            f"the rest served; {HTTP_FORWARD_ROWS:,} rows through the "
            f"forwarder equal; Power BI {len(collector.bodies)} batches, "
            f"every row once, {len(rows) / pbi_s:,.0f} rows/s; {card}")
    finally:
        collector.close()
    return out


def phase_model_http() -> dict:
    """18d: the DigitsConvNet payload served by a local ``http.server``:
    ``download_model`` fetches it by ``http://`` with its pinned hash, a
    tampered payload is refused, and the model scores bit-equal on the
    card to the one downloaded by ``file://``."""
    import hashlib
    import http.server
    from mmlspark_tpu_torch.models.dnn.downloader import (
        _TRAINED_FIXTURES, ModelSchema, deserialize_payload,
        serialize_payload)
    log("== phase 18d: ModelDownloader over http://")
    src = os.path.join(P18_DIR, "src")
    ModelDownloader(src).download_model("DigitsConvNet")
    payload = os.path.join(src, "DigitsConvNet", "model.pkl")
    with open(payload, "rb") as f:
        data = f.read()
    pinned = _TRAINED_FIXTURES["DigitsConvNet"]["sha256"]
    d = deserialize_payload(data, allow_pickle=False)
    leaf = d["params"]
    while isinstance(leaf, dict):
        leaf = leaf[sorted(leaf)[0]]
    leaf.flat[0] += 1.0
    bodies = {"/digits.npz": data,
              "/tampered.npz": serialize_payload(d["params"], d["config"])}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = bodies.get(self.path, b"")
            self.send_response(200 if self.path in bodies else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("localhost", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://localhost:{httpd.server_address[1]}"
    try:
        repos = {k: os.path.join(P18_DIR, k) for k in ("file", "http",
                                                       "tampered")}
        t0 = time.perf_counter()
        got = ModelDownloader(repos["http"]).download_model(ModelSchema(
            name="digits", uri=f"{base}/digits.npz", sha256=pinned))
        fetch_s = time.perf_counter() - t0
        ModelDownloader(repos["file"]).download_model(ModelSchema(
            name="digits", uri=f"file://{payload}", sha256=pinned))
        if got.sha256 != pinned:
            raise AssertionError(f"18d: fetched hash {got.sha256}")
        try:
            ModelDownloader(repos["tampered"]).download_model(ModelSchema(
                name="digits", uri=f"{base}/tampered.npz", sha256=pinned))
        except IOError as e:
            if "hash mismatch" not in str(e):
                raise
        else:
            raise AssertionError("18d: a tampered payload was accepted")
        if os.path.exists(os.path.join(repos["tampered"], "digits",
                                       "model.pkl")):
            raise AssertionError("18d: the tampered payload was written")
    finally:
        httpd.shutdown()
        httpd.server_close()
    x = np.random.default_rng(181).uniform(
        -1, 1, (DIGITS_HTTP_ROWS, 32, 32, 3)).astype(np.float32)
    scores = [fetch_on(DNNModel.from_downloader(repos[k], "digits"), x,
                       "cuda", ("logits",))["logits"] for k in ("http",
                                                                "file")]
    if not np.array_equal(np.asarray(scores[0]), np.asarray(scores[1])):
        raise AssertionError("18d: http:// and file:// models score apart")
    digest = hashlib.sha256(data).hexdigest()
    log(f"18d: fetched {len(data):,} bytes by http:// in {fetch_s:.3f} s, "
        f"sha256 {digest[:12]}... pinned; tampered payload refused; "
        f"logits of {len(x)} inputs bit-equal to the file:// model's")
    return dict(payload_bytes=len(data), fetch_s=fetch_s)


def phase_automl_and_http(data, base, quantized, card) -> dict:
    """Phase 18: 18a-18d. Returns the readings, with 18a's fits (their
    kernel counts) under ``fits``."""
    t0 = time.perf_counter()
    out = {"sub_s": {}}

    def sub(key, fn):
        t1 = time.perf_counter()
        res = fn()
        out["sub_s"][key] = time.perf_counter() - t1
        return res
    X, y, Xh, yh = data
    worker = start_http_worker(quantized)
    try:
        out["18a"], out["fits"], best = sub("18a", lambda: phase_tune(data))
        out["18b"] = sub("18b", lambda: phase_tune_small(
            base, quantized, best, Xh, yh))
        out["18c"] = sub("18c", lambda: phase_http(quantized, Xh, worker,
                                                   card))
        out["18d"] = sub("18d", phase_model_http)
    finally:
        worker.stop()
        shutil.rmtree(P18_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 18: {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in out["sub_s"].items())
        + f") on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 19: the SPMD transformer's train step (sequence and tensor
# parallelism). No TPU kernel was on this path (the JAX attention and
# projections are XLA einsums), so its device work is torch ops: no
# histogram kernel may launch.
# ---------------------------------------------------------------------------

P19_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_p19")
TF_SEED = 19
TF_CONFIG = tfm.TransformerConfig()       # the repo's full width, bf16
TF_BATCH = 8
TF_SEQ = 2048                   # TransformerConfig().max_len
TF_STEPS = 5
TF_LR = 1e-3
TF_STRATEGIES = ("ring", "ring_zigzag", "ulysses")
TF_PROFILE_REPS = 3              # the attention's profiled runs, median
# the three strategies' first losses (same params, same tokens, exact
# attention each) within a quarter of a bf16 ulp at the loss's magnitude
# (losses in [8, 16): ulp 2^-4): they differ only in the order of f32 sums
# and where bf16 rounding lands (tests/test_torch_transformer.py)
TF_FIRST_LOSS_ATOL = 2.0 ** -6
# 19a's narrow f32 config, cuda against cpu
TF_NARROW = dict(vocab_size=512, d_model=64, n_heads=4, d_head=16,
                 n_layers=2, d_ff=256, max_len=256, dtype=torch.float32)
TF_NARROW_BATCH, TF_NARROW_SEQ, TF_NARROW_STEPS = 2, 128, 3
TF_CPU_ATOL = 1e-5
# 19b: four gloo ranks on the one card, TF_CONFIG cut to one layer, f32
TF_RANK_SHAPE = {"data": 1, "seq": 2, "model": 2}
TF_RANK_CONFIG = TF_CONFIG._replace(n_layers=1, dtype=torch.float32)
TF_RANK_BATCH = 4
TF_RANK_SEQ = 512
TF_RANK_STEPS = 3
TF_RANK_ATOL = 1e-4
TF_RANK_TIMEOUT = 300


def tf_tokens(batch, seq, vocab, seed):
    """Seeded ids and their next-token targets, ``[batch, seq]`` int64."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (batch, seq)).astype(np.int64)
    return toks, np.roll(toks, -1, axis=1)


def tf_run(cfg, mesh, params, toks, tgts, steps, device) -> tuple:
    """``steps`` train steps from ``params``: the losses, each step's wall
    ms (the loss's read waits for the step), the last params and optimizer
    state, and the step function."""
    step = tfm.make_train_step(cfg, mesh, lr=TF_LR, device=device)
    opt = tfm.adamw_init(params)
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks, tgts)
        losses.append(float(loss))          # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, params, opt, step


def attention_pairs(mode, S, block=512) -> int:
    """Query-key pairs one (batch, head) computes at world size 1."""
    if mode == "ring":
        return S * S                        # no skip on the plain ring
    if mode == "ring_zigzag":
        return 3 * (S // 2) ** 2            # 3 of its 4 chunk pairs
    nb = -(-S // block)
    return nb * (nb + 1) // 2 * block * block


def attention_profile(cfg, mode, B, S) -> dict:
    """The attention alone, forward and backward, on one layer's q, k, v:
    the median device ms of ``TF_PROFILE_REPS`` profiled runs
    (``torch.profiler``) and of as many runs between two CUDA events, and
    its bound: 12 f32 operations a (query, key, head dim) of the pairs
    computed, at the f32 rate, or the bytes of q, k, v, the output and
    their gradients, whichever is longer."""
    from torch.profiler import ProfilerActivity, profile
    mesh = make_tf_mesh({"data": 1, "seq": 1, "model": 1})
    fn = {"ring": ring_attention.ring_attention,
          "ring_zigzag": ring_attention.zigzag_ring_attention,
          "ulysses": ulysses.ulysses_attention}[mode]
    gen = torch.Generator(device="cuda").manual_seed(TF_SEED)
    shape = (B, cfg.n_heads, S, cfg.d_head)
    qkv = [torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)
           .requires_grad_() for _ in range(3)]
    dout = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype)

    def run():
        out = fn(*qkv, mesh, "seq", causal=True)
        torch.autograd.grad(out, qkv, dout)

    run()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    prof_ms, event_ms = [], []
    for _ in range(TF_PROFILE_REPS):
        with profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        prof_ms.append(device_ms(prof))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        event_ms.append(e0.elapsed_time(e1))
    ops = 12.0 * B * cfg.n_heads * attention_pairs(mode, S) * cfg.d_head
    nbytes = 8 * B * cfg.n_heads * S * cfg.d_head * qkv[0].element_size()
    # the matmuls run in f32 (no TF32), as the JAX package's do
    b_ms, by = bound_ms(nbytes, ops, PEAK_F32_OPS_PER_S)
    return dict(ms=float(np.median(prof_ms)), prof_ms=prof_ms,
                event_ms=float(np.median(event_ms)), events_ms=event_ms,
                bound_ms=b_ms, bound_by=by, ops=ops)


def phase_transformer_full_width(card) -> dict:
    """19a: each strategy at ``TransformerConfig()``'s full width, world
    size 1, ``TF_STEPS`` steps on the same seeded batch; then the narrow
    f32 config on cuda against cpu."""
    from torch.profiler import ProfilerActivity, profile
    cfg0 = TF_CONFIG
    mesh = make_tf_mesh({"data": 1, "seq": 1, "model": 1})
    toks, tgts = tf_tokens(TF_BATCH, TF_SEQ, cfg0.vocab_size, TF_SEED)
    out = {"config": {k: str(v) for k, v in cfg0._asdict().items()},
           "batch": TF_BATCH, "seq": TF_SEQ}
    first = {}
    for mode in TF_STRATEGIES:
        cfg = cfg0._replace(seq_attention=mode)
        t_init = time.perf_counter()
        params = tfm.init_params(cfg, TF_SEED, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        n_params = sum(t.numel() for t in tfm.tree_leaves(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, params, opt, step = tf_run(
            cfg, mesh, params, toks, tgts, TF_STEPS, "cuda")
        peak = torch.cuda.max_memory_allocated()
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"19a {mode}: losses {losses} not finite "
                                 "and falling")
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            params, opt, loss = step(params, opt, toks, tgts)
            torch.cuda.synchronize()
        step_dev = device_ms(prof)
        del params, opt, step, prof
        att = attention_profile(cfg, mode, TF_BATCH, TF_SEQ)
        warm = ms[1:]
        rec = dict(init_s=init_s, losses=losses, step_ms=ms,
                   warm_ms=float(np.mean(warm)),
                   tokens_per_s=TF_BATCH * TF_SEQ / (np.mean(warm) / 1e3),
                   peak_bytes=peak, params=n_params, step_device_ms=step_dev,
                   attention_ms=att["ms"] * cfg.n_layers,
                   attention_share=att["ms"] * cfg.n_layers / step_dev,
                   attention_runs_ms=att["prof_ms"],
                   attention_event_ms=att["event_ms"] * cfg.n_layers,
                   attention_event_runs_ms=att["events_ms"],
                   attention_bound_ms=att["bound_ms"] * cfg.n_layers,
                   attention_bound_by=att["bound_by"])
        first[mode] = losses[0]
        out[mode] = rec
        log(f"19a {mode}: {n_params:,} params drawn on the card in "
            f"{init_s:.3f} s, B={TF_BATCH} S={TF_SEQ}: "
            f"losses {[round(x, 5) for x in losses]}; step ms "
            f"{[round(x, 2) for x in ms]} (warm mean {rec['warm_ms']:.2f}, "
            f"{rec['tokens_per_s']:,.0f} tokens/s); peak "
            f"{peak / 2**30:.2f} GiB; profiled step {step_dev:.2f} device "
            f"ms, attention {rec['attention_ms']:.2f} ms "
            f"({100 * rec['attention_share']:.1f}%; events "
            f"{rec['attention_event_ms']:.2f} ms, "
            f"{100 * rec['attention_event_ms'] / rec['warm_ms']:.1f}% of "
            f"the warm step; per layer "
            f"{[round(x, 2) for x in att['prof_ms']]} profiled, "
            f"{[round(x, 2) for x in att['events_ms']]} events; bound "
            f"{rec['attention_bound_ms']:.2f} ms by {att['bound_by']}) on "
            f"{card}")
        torch.cuda.empty_cache()
    spread = max(first.values()) - min(first.values())
    if spread > TF_FIRST_LOSS_ATOL:
        raise AssertionError(f"19a: first losses {first} spread {spread} > "
                             f"{TF_FIRST_LOSS_ATOL}")
    out["first_loss_spread"] = spread
    narrow = {}
    for mode in TF_STRATEGIES:
        cfg = tfm.TransformerConfig(seq_attention=mode, **TF_NARROW)
        toks_n, tgts_n = tf_tokens(TF_NARROW_BATCH, TF_NARROW_SEQ,
                                   cfg.vocab_size, TF_SEED)
        got = {dev: tf_run(cfg, mesh, tfm.init_params(cfg, TF_SEED,
                                                      device=dev),
                           toks_n, tgts_n, TF_NARROW_STEPS, dev)[0]
               for dev in ("cuda", "cpu")}
        diff = float(np.max(np.abs(np.subtract(got["cuda"], got["cpu"]))))
        if diff > TF_CPU_ATOL:
            raise AssertionError(f"19a narrow {mode}: cuda {got['cuda']} "
                                 f"vs cpu {got['cpu']}")
        narrow[mode] = dict(losses=got["cuda"], max_abs_diff=diff)
    out["narrow_cuda_vs_cpu"] = narrow
    log(f"19a: first losses {first} (spread {spread:.3g} <= "
        f"{TF_FIRST_LOSS_ATOL}); narrow f32 cuda vs cpu over "
        f"{TF_NARROW_STEPS} steps: "
        + ", ".join(f"{m} {r['max_abs_diff']:.3g}" for m, r in
                    narrow.items()))
    return out


# a rank of 19b: joins gloo through a file rendezvous, builds the data x
# seq x model mesh, and runs each strategy's steps on its shards of the
# seeded params on the card; writes its losses and the bytes each of its
# collectives sent
TF_RANK_SRC = r"""
import json, sys, time
root, rank, world, init, spec, out = sys.argv[1:7]
rank, world, spec = int(rank), int(world), json.loads(spec)
sys.path.insert(0, root)
import numpy as np
import torch
from chip_smoke import tf_tokens
from mmlspark_tpu_torch.models.dnn import transformer as tfm
from mmlspark_tpu_torch.parallel import collectives, distributed
from mmlspark_tpu_torch.parallel.mesh import make_mesh
from mmlspark_tpu_torch.parallel.ring_attention import zigzag_permute
distributed.initialize(init, world, rank, backend="gloo", device="cuda")
mesh = make_mesh(spec["shape"])
res = {"axes": {a: mesh.axis_index(a) for a in spec["shape"]}}
for mode in spec["strategies"]:
    cfg = tfm.TransformerConfig(**spec["cfg"], dtype=torch.float32,
                                seq_attention=mode)
    toks, tgts = tf_tokens(spec["batch"], spec["seq"], cfg.vocab_size,
                           spec["seed"])
    if mode == "ring_zigzag":
        n = spec["shape"]["seq"]
        toks, tgts = (zigzag_permute(a, n, axis=1) for a in (toks, tgts))
    params = tfm.shard_params(tfm.init_params(cfg, spec["seed"],
                                              device="cuda"),
                              cfg, mesh, device="cuda")
    opt = tfm.adamw_init(params)
    step = tfm.make_train_step(cfg, mesh, lr=spec["lr"], device="cuda")
    collectives.reset_stats()
    losses, t0 = [], time.perf_counter()
    for _ in range(spec["steps"]):
        params, opt, loss = step(params, opt, toks, tgts)
        losses.append(float(loss))
    res[mode] = {"losses": losses, "s": time.perf_counter() - t0,
                 "collectives": collectives.stats()}
with open(out, "w") as f:
    json.dump(res, f)
torch.distributed.destroy_process_group()
"""


def run_tf_ranks(world: int) -> list:
    """19b's ``world`` processes of ``TF_RANK_SRC`` joined through a file
    rendezvous under ``P19_DIR``. Returns each rank's record."""
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(P19_DIR, ignore_errors=True)
    os.makedirs(P19_DIR)
    init = f"file://{P19_DIR}/rendezvous"
    env = dict(os.environ, PYTHONPATH=root)
    cfg = {k: v for k, v in TF_RANK_CONFIG._asdict().items()
           if k not in ("dtype", "seq_attention")}
    spec = json.dumps(dict(shape=TF_RANK_SHAPE, strategies=TF_STRATEGIES,
                           cfg=cfg, batch=TF_RANK_BATCH, seq=TF_RANK_SEQ,
                           steps=TF_RANK_STEPS, seed=TF_SEED, lr=TF_LR))
    procs = [subprocess.Popen(
        [sys.executable, "-c", TF_RANK_SRC, root, str(r), str(world), init,
         spec, os.path.join(P19_DIR, f"rank{r}.json")],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    failed = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=TF_RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise AssertionError(f"19b rank {r} of {world} timed out")
        if p.returncode != 0:
            failed.append(f"rank {r}: rc {p.returncode}\n{out[-3000:]}")
    if failed:
        raise AssertionError("\n".join(failed))
    recs = []
    for r in range(world):
        with open(os.path.join(P19_DIR, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def tf_losses_with_factor(cfg, params, toks, tgts, steps, factor) -> list:
    """World-size-1 steps whose gradients are multiplied by ``factor``
    before AdamW: the reference's tensor-parallel step on one rank (its
    gradients carry the ``model`` shard count; ROADMAP Queue 3)."""
    mesh = make_tf_mesh({"data": 1, "seq": 1, "model": 1})
    tok = tfm.local_block(toks, mesh, "cuda")
    tgt = tfm.local_block(tgts, mesh, "cuda")
    opt = tfm.adamw_init(params)
    losses = []
    for _ in range(steps):
        with exact_f32("cuda"):
            loss, grads = tfm.loss_and_grads(params, tok, tgt, cfg, mesh)
        with torch.no_grad():
            grads = tfm.tree_map(lambda g: g * factor, grads)
            params, opt = tfm.adamw_update(grads, opt, params, lr=TF_LR)
        losses.append(float(loss))
    return losses


def phase_transformer_ranks(card) -> dict:
    """19b: the four-rank mesh of ``TF_RANK_SHAPE`` (gloo, one card) at
    ``TF_RANK_CONFIG`` (full width, one layer, f32), S=``TF_RANK_SEQ``: each
    strategy's losses within ``TF_RANK_ATOL`` of world size 1 on the card
    with the reference's gradient factor. With 2 model shards every
    gradient is twice the true one (ROADMAP Queue 3); AdamW's step is
    invariant to that but for its epsilon, which at 32,000 vocab columns
    (most of the head's gradients near 1e-7) moves the later losses, so the
    world-size-1 run multiplies its gradients by the shard count too. The
    plain world-size-1 losses print beside them, not held."""
    world = int(np.prod(list(TF_RANK_SHAPE.values())))
    t0 = time.perf_counter()
    ranks = run_tf_ranks(world)
    spawn_s = time.perf_counter() - t0
    mesh = make_tf_mesh({"data": 1, "seq": 1, "model": 1})
    out = {"shape": TF_RANK_SHAPE, "ranks_s": spawn_s}
    for mode in TF_STRATEGIES:
        cfg = TF_RANK_CONFIG._replace(seq_attention=mode)
        toks, tgts = tf_tokens(TF_RANK_BATCH, TF_RANK_SEQ, cfg.vocab_size,
                               TF_SEED)
        want = tf_losses_with_factor(
            cfg, tfm.init_params(cfg, TF_SEED, device="cuda"), toks, tgts,
            TF_RANK_STEPS, TF_RANK_SHAPE["model"])
        plain = tf_run(cfg, mesh, tfm.init_params(cfg, TF_SEED,
                                                  device="cuda"),
                       toks, tgts, TF_RANK_STEPS, "cuda")[0]
        diff = max(float(np.max(np.abs(np.subtract(r[mode]["losses"],
                                                   want))))
                   for r in ranks)
        plain_diff = float(np.max(np.abs(np.subtract(
            ranks[0][mode]["losses"], plain))))
        if diff > TF_RANK_ATOL or not np.isfinite(want).all():
            raise AssertionError(
                f"19b {mode}: ranks {[r[mode]['losses'] for r in ranks]} "
                f"vs world size 1 {want}")
        out[mode] = dict(losses=ranks[0][mode]["losses"], world1=want,
                         max_abs_diff=diff, world1_plain=plain,
                         plain_max_abs_diff=plain_diff,
                         s=[r[mode]["s"] for r in ranks],
                         collectives=ranks[0][mode]["collectives"])
        log(f"19b {mode}: {TF_RANK_STEPS} steps at {TF_RANK_SHAPE} "
            f"(B={TF_RANK_BATCH}, S={TF_RANK_SEQ}, "
            f"{TF_RANK_CONFIG.n_layers} layer, f32): losses "
            f"{ranks[0][mode]['losses']} vs world size 1 with the factor "
            f"{want} (max diff {diff:.3g}; without it {plain}, "
            f"{plain_diff:.3g}); "
            f"{max(out[mode]['s']):.2f} s; rank 0 sent "
            + ", ".join(f"{k} {v['calls']} calls {v['bytes']:,} B"
                        for k, v in sorted(out[mode]["collectives"].items()))
            + f" on {card}")
    shutil.rmtree(P19_DIR, ignore_errors=True)
    return out


def phase_transformer(card) -> dict:
    """Phase 19: 19a and 19b; no histogram kernel may launch."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    out = {"19a": phase_transformer_full_width(card)}
    t1 = time.perf_counter()
    out["19b"] = phase_transformer_ranks(card)
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 19 launched a histogram kernel: "
                             f"{counts}")
    out["kernels"] = "none: phase 19's device work is torch ops"
    out["sub_s"] = {"19a": t1 - t0, "19b": time.perf_counter() - t1}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 19: {out['seconds']:.1f} s (19a {out['sub_s']['19a']:.1f} "
        f"s, 19b {out['sub_s']['19b']:.1f} s) on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 20: checkpoint/resume and out-of-core ingest over a data group of
# two ranks (GBDT and VW)
# ---------------------------------------------------------------------------

# P20_DIR holds the phase's shards, rows, checkpoints and rank records
# (ignored build directory); its two ranks share the card through gloo
P20_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_p20")
P20_WORLD = 2
P20_CKPT_INTERVAL = 2
# every rank dies at the top of round 7 (the 7th evaluation of the site,
# iteration 6), after the checkpoint of rounds 0-5: a preempted job
P20_KILL = "gbdt.round:exit@7"
P20_EXIT = 17                   # the failpoint's exit status
P20_VW_ROWS = 1_000_000         # 15a's Criteo-shaped rows, nothing cut
P20_CHILD_TIMEOUT = 300

# a rank of phase 20, in three stages, each its own pair of processes
# joined by gloo through a file rendezvous: "a" builds phase 4's rows out
# of core and in memory over the group and fits both (20b), fits phase 4's
# fit under MMLSPARK_TPU_HIST_BLOCKS=8 uninterrupted, then again with a
# checkpoint every 2 rounds until P20_KILL ends the process (20a); "b"
# resumes that fit, fits 15a's VW uninterrupted, then checkpointed until
# the process dies as pass 2 starts (20c); "c" resumes the VW fit. Rank 1
# names checkpoint directories of its own, which must never be created
P20_SRC = r"""
import hashlib, json, os, sys, time
root, rank, world, init, stage, d, n, device, out = sys.argv[1:10]
rank, world, n = int(rank), int(world), int(n)
sys.path.insert(0, root)
import numpy as np
import torch
from chip_smoke import (P20_CKPT_INTERVAL, P20_EXIT, P20_KILL, VW_BITS,
                        higgs_shaped, read_counts, reset_counts)
from mmlspark_tpu_torch.core.dataset import Dataset
from mmlspark_tpu_torch.models.gbdt import booster as booster_mod
from mmlspark_tpu_torch.models.gbdt import ingest
from mmlspark_tpu_torch.models.gbdt.api import LightGBMClassifier
from mmlspark_tpu_torch.models.gbdt.booster import (LightGBMDataset,
                                                    train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
from mmlspark_tpu_torch.models.vw import sgd
from mmlspark_tpu_torch.models.vw.api import VowpalWabbitClassifier
from mmlspark_tpu_torch.parallel import distributed
from mmlspark_tpu_torch.robustness import failpoints
distributed.initialize(init, world, rank, backend="gloo", device=device)
res = {}


def sync():
    if device != "cpu":
        torch.cuda.synchronize()


# the process's CUDA context, before anything is timed
torch.zeros(1, device=device)
sync()


def record():
    with open(out, "w") as f:
        json.dump(res, f)


def own(name):
    return os.path.join(d, name + ("" if rank == 0 else "_rank1"))


def clock(name, fn, **extra):
    sync()
    reset_counts()
    t0 = time.perf_counter()
    got = fn()
    sync()
    res[name] = dict(s=time.perf_counter() - t0, counts=read_counts(),
                     **extra)
    return got


# each checkpoint's seconds on this rank: the gathers, the state check
# and, on rank 0, the write
saves = res.setdefault("saves", [])
real_save = booster_mod._save_checkpoint


def timed_save(*a, **k):
    sync()
    t0 = time.perf_counter()
    real_save(*a, **k)
    saves.append(time.perf_counter() - t0)
    record()


booster_mod._save_checkpoint = timed_save


def gbdt(name, ckpt):
    kw = {} if ckpt is None else dict(checkpointDir=own(ckpt),
                                      checkpointInterval=P20_CKPT_INTERVAL)
    est = LightGBMClassifier(numIterations=10, numLeaves=31, maxBin=255,
                             device=device, **kw)
    b = clock(name, lambda: est.fit(Dataset({"features": X,
                                             "label": y})).booster)
    res[name]["model"] = hashlib.sha256(
        b.model_string().encode()).hexdigest()


def vw(name, ckpt):
    kw = {} if ckpt is None else dict(checkpointDir=own(ckpt))
    est = VowpalWabbitClassifier(numBits=VW_BITS, numPasses=2,
                                 batchSize=128, device=device, **kw)
    m = clock(name, lambda: est.fit(vw_rows))
    res[name]["weights"] = hashlib.sha256(
        np.asarray(m.weights, np.float32).tobytes()).hexdigest()


def load_vw():
    return Dataset({"features_indices": np.load(d + "/vw_idx.npy"),
                    "features_values": np.load(d + "/vw_val.npy"),
                    "label": np.load(d + "/vw_y.npy")})


passes = []
real_train_sgd = sgd.train_sgd


def one_pass(*a, **k):
    # the checkpointed VW fit runs one call a pass; this process dies as
    # the pass after its first checkpoint starts where DIE_AT is set
    passes.append(1)
    if len(passes) == DIE_AT:
        os._exit(P20_EXIT)
    return real_train_sgd(*a, **k)


DIE_AT = 0
sgd.train_sgd = one_pass
if stage == "a":
    reads = []
    src = ingest.ShardedMatrixSource
    real_read, real_gather = src.read_into, src.gather

    def read_into(self, o, a, b):
        reads.append([os.path.basename(os.path.dirname(self.paths[0])),
                      int(a), int(min(b, self.n))])
        return real_read(self, o, a, b)

    def gather(self, idx):
        reads.append(["sample", int(len(idx))])
        return real_gather(self, idx)

    src.read_into, src.gather = read_into, gather
    ooc = clock("ingest", lambda: LightGBMDataset.construct(
        path=d + "/x", label_path=d + "/y", device=device))
    src.read_into, src.gather = real_read, real_gather
    res["reads"] = reads
    X, y = higgs_shaped(n, seed=0)
    mem = LightGBMDataset.construct(X, y, bin_dtype="uint8", device=device)
    res["same"] = {k: bool(torch.equal(getattr(ooc, k), getattr(mem, k)))
                   for k in ("Xbt", "y", "w", "vmask")}
    res["same"]["bounds"] = bool(np.array_equal(ooc.binner.upper_bounds,
                                                mem.binner.upper_bounds))
    res["layout"] = [ooc.n, ooc.n_pad, ooc.n_local, str(ooc.Xbt.dtype)]
    for name, cfg in (("quantized", GrowConfig(
            num_leaves=31, quantized_grad=True, quant_warmup_iters=0)),
            ("bf16", GrowConfig(num_leaves=31))):
        for kind, ds in (("ooc", ooc), ("mem", mem)):
            b = clock(f"{name}_{kind}", lambda: train_booster(
                dataset=ds, objective="binary", num_iterations=10, cfg=cfg))
            res[f"{name}_{kind}"]["model"] = b.model_string()
    del ooc, mem
    os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = "8"
    gbdt("full", None)
    saves.clear()
    record()
    failpoints.configure(P20_KILL)
    gbdt("killed", "gbdt_ck")
    raise SystemExit("20a: the fit ran past its failpoint")
if stage == "b":
    os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = "8"
    X, y = higgs_shaped(n, seed=0)
    gbdt("resumed", "gbdt_ck")
    res["resumed"]["saves"] = list(saves)
    del X, y
    vw_rows = load_vw()
    vw("vw_full", None)
    record()
    DIE_AT = 2
    vw("vw_killed", "vw_ck")
    raise SystemExit("20c: the VW fit ran past its second pass")
vw_rows = load_vw()
vw("vw_resumed", "vw_ck")
res["vw_resumed"]["passes"] = len(passes)
record()
torch.distributed.destroy_process_group()
"""


def run_p20(stage: str, rc: int) -> list:
    """Stage ``stage`` of ``P20_SRC`` on ``P20_WORLD`` processes; each must
    exit with ``rc``. Returns each rank's record."""
    root = os.path.dirname(os.path.abspath(__file__))
    init = f"file://{P20_DIR}/rendezvous_{stage}"
    env = dict(os.environ, PYTHONPATH=root)
    for k in ("MMLSPARK_TPU_BINNED_CACHE", "MMLSPARK_TPU_HIST_BLOCKS",
              "MMLSPARK_TPU_FAILPOINTS"):
        env.pop(k, None)
    outs = [os.path.join(P20_DIR, f"{stage}_rank{r}.json")
            for r in range(P20_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", P20_SRC, root, str(r), str(P20_WORLD), init,
         stage, P20_DIR, str(HIGGS_ROWS), "cuda", outs[r]],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(P20_WORLD)]
    failed = []
    for r, p in enumerate(procs):
        try:
            text, _ = p.communicate(timeout=P20_CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"phase 20 stage {stage}: rank {r} timed "
                                 "out")
        if p.returncode != rc:
            failed.append(f"rank {r}: rc {p.returncode}, not {rc}\n"
                          f"{text[-3000:]}")
    if failed:
        raise AssertionError(f"phase 20 stage {stage}:\n" + "\n".join(failed))
    recs = []
    for path in outs:
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def summed_counts(recs, name) -> dict:
    """``name``'s launch counts summed over the ranks."""
    return {k: sum(r[name]["counts"][k] for r in recs)
            for k in recs[0][name]["counts"]}


def check_launches(counts, needs, what) -> None:
    """``needs`` launched and no plain version ran (on a card: the CPU's
    rank processes run the plain versions, which they do not count)."""
    if not torch.cuda.is_available():
        return
    if counts["plain"] or any(counts[k] <= 0 for k in needs):
        raise AssertionError(f"{what}: launches {counts}, needs {needs}")


def same_on_ranks(recs, name, key) -> str:
    values = {r[name][key] for r in recs}
    if len(values) != 1:
        raise AssertionError(f"{name}: the ranks' {key} differ")
    return values.pop()


def check_reads(recs, n, sample_rows=200_000) -> None:
    """20b: every file read of a rank lies in its padded row range and
    together they cover it once per source; rank 0 alone reads the
    binner's sample (``construct``'s ``bin_sample_count``: a gather of
    that many rows, or one read of every row where there are no more)."""
    per = -(-n // len(recs))
    for r, rec in enumerate(recs):
        lo, hi = r * per, min((r + 1) * per, n)
        reads = list(rec["reads"])
        sample = [g for g in reads if g[0] == "sample"]
        if n <= sample_rows and r == 0:
            reads.remove(["x", 0, n])
            sample = [["sample", n]]
        if sample != ([["sample", min(n, sample_rows)]] if r == 0 else []):
            raise AssertionError(f"20b rank {r}: sample reads {sample}")
        for src in ("x", "y"):
            spans = sorted((g[1], g[2]) for g in reads if g[0] == src)
            if not (spans and all(lo <= a < b <= hi for a, b in spans)
                    and sum(b - a for a, b in spans) == hi - lo):
                raise AssertionError(f"20b rank {r}: {src} reads {spans} "
                                     f"outside or short of [{lo}, {hi})")


def phase_ooc_group(recs, Xh, s_one) -> dict:
    """20b's holds on stage a's records."""
    for r, rec in enumerate(recs):
        if not all(rec["same"].values()):
            raise AssertionError(f"20b rank {r}: the out-of-core slice "
                                 f"differs from the in-memory one: "
                                 f"{rec['same']}")
        if rec["layout"] != [HIGGS_ROWS, HIGGS_ROWS,
                             HIGGS_ROWS // P20_WORLD, "torch.uint8"]:
            raise AssertionError(f"20b rank {r}: layout {rec['layout']}")
    check_reads(recs, HIGGS_ROWS)
    out = {"ingest_s": [rec["ingest"]["s"] for rec in recs],
           "one_rank_ingest_s": s_one}
    for name, needs in (("quantized", "node_hist_int8"),
                        ("bf16", "node_hist_bf16")):
        models = {}
        for kind in ("ooc", "mem"):
            key = f"{name}_{kind}"
            same_on_ranks(recs, key, "model")
            check_launches(summed_counts(recs, key), [needs], f"20b {key}")
            models[kind] = Booster.from_string(recs[0][key]["model"])
            out[key] = dict(fit_s=[rec[key]["s"] for rec in recs],
                            counts=summed_counts(recs, key))
        for f in ("feat", "thr_bin", "left", "right", "is_leaf",
                  "cat_bitset"):
            if not np.array_equal(models["ooc"].trees[f],
                                  models["mem"].trees[f]):
                raise AssertionError(f"20b {name}: tree field {f} differs")
        diff = margin_diff(models["ooc"].predict_raw(Xh, device="cuda"),
                           models["mem"].predict_raw(Xh, device="cuda"))
        if not diff <= 1e-5:
            raise AssertionError(f"20b {name}: margins differ by {diff}")
        out[name + "_byte_equal"] = (recs[0][f"{name}_ooc"]["model"]
                                     == recs[0][f"{name}_mem"]["model"])
        log(f"20b {name}: fits out of core {out[name + '_ooc']['fit_s']} s, "
            f"in memory {out[name + '_mem']['fit_s']} s a rank; identical "
            f"trees, margins within {diff:.3g} (byte-equal "
            f"{out[name + '_byte_equal']}); launches "
            f"{out[name + '_ooc']['counts']}")
    log(f"20b: each rank read only its {HIGGS_ROWS // P20_WORLD:,} rows "
        f"(rank 0 also the binner's sample); its bins, labels, weights and mask "
        f"bit-equal to its slice of the in-memory construct; ingest "
        f"{out['ingest_s'][0]:.3f} / {out['ingest_s'][1]:.3f} s on ranks 0 "
        f"/ 1 against {s_one:.3f} s on one rank")
    return out


def phase_group_resume(card) -> dict:
    """Phase 20: 20a-20c over two ranks sharing the card."""
    t0 = time.perf_counter()
    log(f"== phase 20: checkpoint/resume and out-of-core ingest over "
        f"{P20_WORLD} ranks on the card (gloo): phase 4's rows, 15a's VW")
    shutil.rmtree(P20_DIR, ignore_errors=True)
    os.makedirs(P20_DIR)
    X, y = higgs_shaped(HIGGS_ROWS, seed=0)
    Xh, _ = higgs_shaped(HIGGS_HOLDOUT, seed=1)
    q = len(y) // 4
    cuts = [(i * q, len(y) if i == 3 else (i + 1) * q) for i in range(4)]
    write_shards((X[a:b] for a, b in cuts), os.path.join(P20_DIR, "x"))
    write_shards((y[a:b] for a, b in cuts), os.path.join(P20_DIR, "y"))
    one, s_one = timed(lambda: LightGBMDataset.construct(
        path=os.path.join(P20_DIR, "x"), label_path=os.path.join(P20_DIR,
                                                                 "y"),
        device="cuda"))
    del one
    counts, ids, vy, _ = criteo_raw(P20_VW_ROWS, seed=3)
    idx, val = criteo_hashed(counts, ids)
    for name, a in (("idx", idx), ("val", val), ("y", vy)):
        np.save(os.path.join(P20_DIR, f"vw_{name}.npy"), a)
    del counts, ids, idx, val, vy
    log(f"20: data and shards {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    a = run_p20("a", P20_EXIT)
    out = {"20b": phase_ooc_group(a, Xh, s_one)}
    ck = os.path.join(P20_DIR, "gbdt_ck")
    files = sorted(glob.glob(os.path.join(ck, "ckpt_*.pkl")))
    if not files or len(a[0]["saves"]) != 3:
        raise AssertionError(f"20a: the killed fit left {files}, saves "
                             f"{a[0]['saves']}")
    payload = os.path.getsize(files[-1])
    shutil.copytree(ck, ck + "_one")
    b = run_p20("b", P20_EXIT)
    c = run_p20("c", 0)
    t_ranks = time.perf_counter() - t1

    # 20a: the resume on one rank, in this process
    full = same_on_ranks(a, "full", "model")
    os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = str(HIST_BLOCKS)
    try:
        gbdt_api.clear_binned_dataset_cache()
        torch.cuda.synchronize()
        reset_counts()
        t2 = time.perf_counter()
        m = LightGBMClassifier(
            numIterations=10, numLeaves=31, maxBin=255, device="cuda",
            checkpointDir=ck + "_one",
            checkpointInterval=P20_CKPT_INTERVAL).fit(
            Dataset({"features": X, "label": y}))
        torch.cuda.synchronize()
        s_one_resume = time.perf_counter() - t2
        one_counts = read_counts()
    finally:
        del os.environ["MMLSPARK_TPU_HIST_BLOCKS"]
    one_model = hashlib.sha256(
        m.booster.model_string().encode()).hexdigest()
    if same_on_ranks(b, "resumed", "model") != full or one_model != full:
        raise AssertionError("20a: a resumed fit differs from the "
                             "uninterrupted two-rank fit")
    full_counts = summed_counts(a, "full")
    resumed_counts = summed_counts(b, "resumed")
    for what, cnt in (("uninterrupted", full_counts),
                      ("resumed on 2 ranks", resumed_counts),
                      ("resumed on 1 rank", one_counts)):
        check_launches(cnt, ["node_hist_det"], f"20a {what}")
    # the resumes grew rounds 6-9 only
    if torch.cuda.is_available() and not (
            0 < resumed_counts["node_hist_det"]
            < full_counts["node_hist_det"]
            and 0 < one_counts["node_hist_det"]
            < full_counts["node_hist_det"] // P20_WORLD):
        raise AssertionError(f"20a: a resume grew every round: "
                             f"{resumed_counts} / {one_counts} against "
                             f"{full_counts}")
    for name in ("gbdt_ck", "vw_ck"):
        if os.path.exists(os.path.join(P20_DIR, name + "_rank1")):
            raise AssertionError(f"20: rank 1 created {name}_rank1")
    save_s = a[0]["saves"]
    out["20a"] = dict(full_s=[r["full"]["s"] for r in a],
                      resumed_s=[r["resumed"]["s"] for r in b],
                      one_rank_resume_s=s_one_resume,
                      save_s_rank0=save_s, save_s_rank1=a[1]["saves"],
                      payload_bytes=payload)
    log(f"20a: phase 4's fit (hist_blocks=8) on 2 ranks killed at round 7 "
        f"({P20_KILL}), resumed on 2 ranks and on 1: all three byte-equal "
        f"to the uninterrupted 2-rank fit; a checkpoint "
        f"{np.mean(save_s):.3f} s on rank 0 ({save_s}), payload "
        f"{payload:,} bytes; fits {out['20a']['full_s']} s uninterrupted, "
        f"{out['20a']['resumed_s']} s resumed, {s_one_resume:.3f} s resumed "
        f"on one rank; launches {full_counts} / {resumed_counts} / "
        f"{one_counts}")

    # 20c
    vw_full = same_on_ranks(b, "vw_full", "weights")
    if same_on_ranks(c, "vw_resumed", "weights") != vw_full:
        raise AssertionError("20c: the resumed VW weights differ from the "
                             "uninterrupted two-rank fit's")
    if any(r["vw_resumed"]["passes"] != 1 for r in c):
        raise AssertionError("20c: the resume did not start at pass 2")
    for r in b + c:
        for k in ("vw_full", "vw_resumed"):
            if k in r and any(r[k]["counts"].values()):
                raise AssertionError(f"20c: {k} launched a histogram")
    vw_ck = sorted(glob.glob(os.path.join(P20_DIR, "vw_ck", "ckpt_*.pkl")))
    out["20c"] = dict(full_s=[r["vw_full"]["s"] for r in b],
                      resumed_s=[r["vw_resumed"]["s"] for r in c],
                      payload_bytes=os.path.getsize(vw_ck[-1]))
    log(f"20c: VowpalWabbitClassifier(numBits={VW_BITS}, numPasses=2) on "
        f"{P20_VW_ROWS:,} Criteo-shaped rows over 2 ranks, killed as pass 2 "
        f"started, resumed: weights bit-equal to the uninterrupted fit; "
        f"fits {out['20c']['full_s']} s, resumed pass "
        f"{out['20c']['resumed_s']} s; payload "
        f"{out['20c']['payload_bytes']:,} bytes")
    out["fits"] = {"20a:full": dict(counts=full_counts),
                   "20a:resumed": dict(counts=resumed_counts),
                   "20a:one_rank": dict(counts=one_counts),
                   **{f"20b:{k}": dict(counts=out["20b"][k]["counts"])
                      for k in ("quantized_ooc", "quantized_mem",
                                "bf16_ooc", "bf16_mem")}}
    shutil.rmtree(P20_DIR, ignore_errors=True)
    out["rank_stages_s"] = t_ranks
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 20: {out['seconds']:.1f} s ({t_ranks:.1f} s in the three "
        f"rank stages) on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the JAX package's random streams on the card
# ---------------------------------------------------------------------------

P21_SEED = 21
P21_ROWS = 1_000_000            # phase 4's rows
P21_BAG_STEP = 3
P21_ROUND = (4, 1)              # the rounding key's (iteration, class)
P21_RANK_START = 500_000        # rank 1 of 2 over P21_ROWS
P21_TIME_REPS = 20
# sha256 of the little-endian f32 bits of jax.random's own draws (jax
# 0.9.0, partitionable threefry, on the CPU) under 21a's keys:
# uniform(fold_in(fold_in(PRNGKey(21), 1_000_006), 0), (1_000_000,)),
# uniform(fold_in(fold_in(PRNGKey(21), 4), 14), (3, 1_000_000)) and its
# columns from 500,000; tests/test_torch_prng.py computes them with JAX
PRNG_GOLDEN = {
    "row_uniforms":
        "5ed56e10cd14e2d6901ca16a1deba251bbf6cafc6e5bcdcd1507e8db8f08ffa3",
    "round_uniforms":
        "ec3339675ea3e1aa73c8c1f45245ab5441333a0991bd5308a27b2f4e65ee7b53",
    "rank_slice":
        "750435afa79fb92247a78a8c0cd298d89f2144779672c64dd4f2cecc08bd5cd9",
}
P21_BAG = dict(baggingFraction=0.8, baggingFreq=1, featureFraction=0.8)
P21_INT8 = dict(useQuantizedGrad=True, quantWarmupIters=0)
# 21b: (label, the kernels the fit must launch, estimator params, blocked)
P21_FITS = (
    ("bagged", ("node_hist_bf16",), P21_BAG, False),
    ("bagged_int8", ("node_hist_int8", "quant_stats"),
     {**P21_BAG, **P21_INT8}, False),
    ("goss", ("node_hist_bf16",), dict(boostingType="goss",
                                       featureFraction=0.8), False),
    ("blocked_int8", ("node_hist_int8", "quant_stats"),
     {**P21_BAG, **P21_INT8}, True),
    ("blocked_bf16", ("node_hist_det",), P21_BAG, True),
)


def prng_draws(dev) -> dict:
    """21a's three draws on ``dev``: phase 4's row uniforms, the rounding
    uniforms and rank 1's slice of them."""
    key = hist_ops.quant_key(P21_SEED, *P21_ROUND)
    return {"row_uniforms": _row_uniforms(P21_SEED, P21_BAG_STEP, P21_ROWS,
                                          device=dev),
            "round_uniforms": prng.uniform(key, (3, P21_ROWS), device=dev),
            "rank_slice": prng.uniform(key, (3, P21_ROWS - P21_RANK_START),
                                       start=P21_RANK_START,
                                       stride=P21_ROWS, device=dev)}


def draw_sha(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        t.cpu().numpy(), dtype="<f4").tobytes()).hexdigest()


def phase_prng_draws(card) -> dict:
    """21a: the card's draws bit-equal to the CPU's and to JAX's hashes;
    their warm ms; normals and an init bit-equal on cuda and cpu."""
    log("== phase 21a: the JAX package's threefry stream on the card")
    # (a list, not a dict by device: the CPU rehearsal renames the card)
    on_card, on_cpu = (prng_draws(dev) for dev in ("cuda", "cpu"))
    out = {}
    for name, want in PRNG_GOLDEN.items():
        cuda, cpu = on_card[name], on_cpu[name]
        if cuda.device.type != "cuda" or not torch.equal(cuda.cpu(), cpu):
            raise AssertionError(f"21a {name}: the card's draws differ from "
                                 "the cpu's")
        sha = draw_sha(cuda)
        if sha != want:
            raise AssertionError(f"21a {name}: sha256 {sha}, JAX's {want}")
        out[name] = sha
    if not torch.equal(on_card["rank_slice"],
                       on_card["round_uniforms"][:, P21_RANK_START:]):
        raise AssertionError("21a: the rank's slice is not the one-device "
                             "draw's columns")
    key = hist_ops.quant_key(P21_SEED, *P21_ROUND)
    ms = {"row_uniforms_1m": time_ms(lambda: _row_uniforms(
              P21_SEED, P21_BAG_STEP, P21_ROWS, device="cuda"),
              P21_TIME_REPS),
          "round_uniforms_3x1m": time_ms(lambda: prng.uniform(
              key, (3, P21_ROWS), device="cuda"), P21_TIME_REPS)}
    t0 = time.perf_counter()
    prng.uniform(key, (3, P21_ROWS), device="cpu")
    ms["round_uniforms_3x1m_cpu"] = 1e3 * (time.perf_counter() - t0)
    ms["normal_1m"] = time_ms(lambda: prng.normal(
        key, (P21_ROWS,), device="cuda"), P21_TIME_REPS)
    a, b = (prng.normal(key, (P21_ROWS,), device=dev).cpu()
            for dev in ("cuda", "cpu"))
    if not torch.equal(a, b):
        raise AssertionError(f"21a: normals differ on cuda and cpu at "
                             f"{int((a != b).sum())} of {P21_ROWS}")
    cfg = tfm.TransformerConfig(**TF_NARROW)
    inits = [tfm.tree_leaves(tfm.init_params(cfg, TF_SEED, device=dev))
             for dev in ("cuda", "cpu")]
    if not all(torch.equal(g.cpu(), c) for g, c in zip(*inits)):
        raise AssertionError("21a: the narrow transformer's init differs on "
                             "cuda and cpu")
    out["ms"] = ms
    log(f"21a: row uniforms, rounding uniforms and the rank's slice "
        f"bit-equal on cuda and cpu and to JAX's sha256; warm ms on the "
        f"card {ms['row_uniforms_1m']:.4f} at [1M], "
        f"{ms['round_uniforms_3x1m']:.4f} at [3, 1M] (cpu "
        f"{ms['round_uniforms_3x1m_cpu']:.1f} ms), normals "
        f"{ms['normal_1m']:.4f} at [1M]; normals and a transformer init "
        f"bit-equal on cuda and cpu on {card}")
    return out


# 21c: the fused int8 statistics (csrc/quant_stats.cu) against the eager
# chain they replaced on the card. P21C_ROWS is higgs-qgrad-fit's rows;
# P21C_Q_MAX_ROWS rows take quant_q_max 107, below 127
P21C_ROWS = 10_500_000
P21C_Q_MAX_ROWS = 20_000_000
# the card's int32 rate, which the data sheet does not give (132 SMs, 64
# int32 lanes an SM, 1,980 MHz), and the int32 operations of one draw
# (threefry2x32's 20 rounds and key injections, the uniform, the rounding)
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
QUANT_OPS_PER_DRAW = 80


class QuantRank:
    """One rank of a data group as the quantization reads it: its rank,
    the group's size, and an amax maximum over the group that is this
    rank's own."""

    def __init__(self, rank: int, size: int):
        self.rank, self.size = rank, size

    def all_reduce(self, t, op="sum"):
        return t


def quant_cases() -> dict:
    """21c's cases, name: (rows, key, group, blocks_local, rows_per_block,
    n_rows, special)."""
    key = hist_ops.quant_key(P21_SEED, *P21_ROUND)
    half = P21C_ROWS // 2
    return {
        "n1": (1, key, None, 0, 0, None, None),
        "n1000": (1000, key, None, 0, 0, None, None),
        "n1048577": (1_048_577, key, None, 0, 0, None, None),
        "higgs": (P21C_ROWS, key, None, 0, 0, None, None),
        "rank0_of_2": (half, key, QuantRank(0, 2), 0, 0, P21C_ROWS, None),
        "rank1_of_2": (half, key, QuantRank(1, 2), 0, 0, P21C_ROWS, None),
        "q_max_small": (P21C_Q_MAX_ROWS, key, None, 0, 0, None, None),
        "nearest": (1_048_577, None, None, 0, 0, None, None),
        "positional": (1_048_576, key, None, 8, 131_072, None, None),
        "positional_rank1": (524_288, key, QuantRank(1, 2), 4, 131_072, None,
                             None),
        "positional_q_max_small": (1_048_576, key, None, 8, P21C_Q_MAX_ROWS,
                                   None, None),
        "nan_inf": (1_048_577, key, None, 0, 0, None, "nan_inf"),
        "nan_grad": (1000, key, None, 0, 0, None, "nan_grad"),
        "zero_channel": (1000, key, None, 0, 0, None, "zero_grad"),
    }


def quant_rows(n: int, special=None, seed: int = 0) -> tuple:
    """A binary logloss round's statistics on the card (``grad = p - y``,
    ``hess = p (1 - p)``) and a bagging mask with GOSS-like weights;
    ``special`` puts NaN and +-inf in them or zeroes the gradients."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.rand(n, generator=g, device="cuda")
    y = (torch.rand(n, generator=g, device="cuda") < 0.5).float()
    grad, hess = p - y, p * (1.0 - p)
    u = torch.rand(n, generator=g, device="cuda")
    vm = torch.where(u < 0.8, 1.0, torch.where(u < 0.9, 2.5, 0.0))
    if special == "zero_grad":
        grad.zero_()
    elif special == "nan_grad":
        grad[::97] = float("nan")
    elif special == "nan_inf":
        grad[::1001] = float("nan")
        grad[5::2003] = float("-inf")
        hess[7::4001] = float("inf")
    return grad.contiguous(), hess.contiguous(), vm.contiguous()


def quant_eager(grad, hess, vm, case) -> tuple:
    """The card's route before the kernel: the stack, ``_quantize_for``."""
    _, key, group, bl, rpb, n_rows, _ = case
    base = torch.stack([grad * vm, hess * vm, vm], dim=0).contiguous()
    return growth_mod._quantize_for(base, key, group, bl, rpb, n_rows)


def quant_fused(grad, hess, vm, case) -> tuple:
    _, key, group, bl, rpb, n_rows, _ = case
    return growth_mod._quantize_fused(grad, hess, vm, key, group, bl, rpb,
                                      n_rows)


def phase_quant_stats(card) -> dict:
    """21c: the fused route bit-equal to the eager chain in every case of
    ``quant_cases``; the kernel, the route and the chain timed at [3,
    P21C_ROWS] against the kernel's bound."""
    log("== phase 21c: quant_stats (a quantized tree's int8 statistics) "
        "vs the eager chain on the card")
    cases = {}
    for name, case in quant_cases().items():
        grad, hess, vm = quant_rows(case[0], case[6], seed=len(name))
        q_e, s_e = quant_eager(grad, hess, vm, case)
        q_f, s_f = quant_fused(grad, hess, vm, case)
        torch.cuda.synchronize()
        diff = int((q_f != q_e).sum())
        if q_f.device.type != "cuda" or diff or not torch.equal(s_f, s_e):
            raise AssertionError(
                f"21c {name}: the fused route differs from the eager chain "
                f"at {diff} of {q_e.numel()} int8 values, scales "
                f"{s_f.tolist()} against {s_e.tolist()}")
        cases[name] = dict(rows=case[0], scales=s_f.tolist(),
                           q_abs_max=int(q_f.to(torch.int16).abs().max()))
        del grad, hess, vm, q_e, s_e, q_f, s_f
        torch.cuda.empty_cache()
    log(f"21c: int8 statistics and scales bit-equal to the eager chain in "
        f"{len(cases)} cases: " + ", ".join(
            f"{k} (n={v['rows']:,}, |q| max {v['q_abs_max']})"
            for k, v in cases.items()))
    n = P21C_ROWS
    case = quant_cases()["higgs"]
    grad, hess, vm = quant_rows(n)
    amax = hist_ops.stats_amax_cuda(grad, hess, vm)
    q_max = hist_ops.quant_q_max(n)

    def kernel():
        hist_ops.quantize_stats_cuda(
            grad, hess, vm, amax, q_max=q_max, mode=hist_ops.QUANT_THREEFRY,
            qkey=case[1], start=0, stride=n)

    def route():
        quant_fused(grad, hess, vm, case)

    def chain():
        quant_eager(grad, hess, vm, case)

    bound, bound_by = bound_ms(15 * n, 3.0 * QUANT_OPS_PER_DRAW * n,
                               PEAK_INT32_OPS_PER_S)
    row = dict(ms=time_ms(kernel, P21_TIME_REPS),
               ms_cold=time_cold_ms(kernel),
               route_ms=time_ms(route, P21_TIME_REPS),
               route_ms_cold=time_cold_ms(route),
               amax_ms=time_ms(lambda: hist_ops.stats_amax_cuda(
                   grad, hess, vm), P21_TIME_REPS),
               plain_ms=time_ms(chain, 5, warm=1),
               plain_ms_cold=time_cold_ms(chain, 3),
               bound_ms=bound, bound_by=bound_by, library_ms=None)
    log(f"21c [3, {n:,}]: kernel {row['ms']:.4f} ms warm / "
        f"{row['ms_cold']:.4f} L2 cold, {100 * bound / row['ms']:.1f}% / "
        f"{100 * bound / row['ms_cold']:.1f}% of its {bound:.4f} ms bound "
        f"({bound_by}); the route (amax, scales, kernel) "
        f"{row['route_ms']:.4f} / {row['route_ms_cold']:.4f} (amax "
        f"{row['amax_ms']:.4f}); the eager chain {row['plain_ms']:.3f} / "
        f"{row['plain_ms_cold']:.3f} on {card}")
    return dict(cases=cases, row=row, max_abs_err=0)


def phase_prng_fits() -> dict:
    """21b: phase 4's rows under the sampled and stochastically rounded
    options, and their 20,000-row twins on cuda against cpu."""
    X, y = higgs_shaped(HIGGS_ROWS, seed=0)
    Xh, yh = higgs_shaped(HIGGS_HOLDOUT, seed=1)
    data = (X, y, Xh, yh)
    fits = {}
    for label, needs, params, blocked in P21_FITS:
        if blocked:
            os.environ["MMLSPARK_TPU_HIST_BLOCKS"] = str(HIST_BLOCKS)
        try:
            floor = (SAMPLING_AUC_FLOORS["goss"] if label == "goss"
                     else AUC_FLOOR)
            rec = phase_end_to_end(f"21b {label}", needs, data,
                                   auc_floor=floor, **params)[0]
            others = [k for k in ("node_hist_bf16", "node_hist_int8",
                                  "node_hist_det") if k not in needs]
            if any(rec["counts"][k] for k in others):
                raise AssertionError(f"21b {label}: other kernels ran: "
                                     f"{rec['counts']}")
            phase_small_agreement(f"21b {label}", needs=needs, **params)
        finally:
            os.environ.pop("MMLSPARK_TPU_HIST_BLOCKS", None)
        fits[f"21b:{label}"] = rec
    return fits


def phase_prng(card) -> dict:
    """Phase 21: 21a, 21c, then 21b."""
    t0 = time.perf_counter()
    out = {"21a": phase_prng_draws(card)}
    t1 = time.perf_counter()
    out["21c"] = phase_quant_stats(card)
    t2 = time.perf_counter()
    out["fits"] = phase_prng_fits()
    out["sub_s"] = {"21a": t1 - t0, "21c": t2 - t1,
                    "21b": time.perf_counter() - t2}
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 21: {out['seconds']:.1f} s (21a {out['sub_s']['21a']:.1f} "
        f"s, 21c {out['sub_s']['21c']:.1f} s, 21b "
        f"{out['sub_s']['21b']:.1f} s) on {card}")
    return out

# Phase 22: the LambdaRank kernel (csrc/lambdarank.cu) against its plain
# version on the card. P22 is the yahoo-rank-refit cell's shape (Yahoo
# LTR's train split: 473,134 rows in 19,944 queries, log-normal lengths
# of 1 to 139 rows) and one query of P22_LONG rows, past the kernel's
# shared-memory rows. P22_TOL is the ragged lambdas' tolerance against the
# float64 reference in tests/test_torch_lambdarank_ragged.py (a share of
# the largest gradient and of the largest hessian)
P22_ROWS, P22_QUERIES, P22_LONGEST, P22_LONG = 473_134, 19_944, 139, 4096
P22_TOL = 2e-6
P22_TIME_REPS = 20
# the formula's float32 operations a pair y_i > y_j, and the bytes a row
# (score, grade, weight in; gradient, hessian out): perfbench/rank_work.py
RANK_OPS_PER_PAIR, RANK_ROW_BYTES = 21, 20


def rank_lengths(rows: int, queries: int, seed: int) -> np.ndarray:
    """``queries`` lengths of 1 to P22_LONGEST rows adding up to ``rows``,
    log-normal (sigma 0.8) about their mean."""
    rng = np.random.default_rng(seed)
    n = np.clip(np.rint(np.exp(rng.normal(np.log(rows / queries) - 0.32,
                                          0.8, size=queries))), 1,
                P22_LONGEST).astype(np.int64)
    while n.sum() != rows:
        step = 1 if n.sum() < rows else -1
        room = np.flatnonzero((n < P22_LONGEST) if step > 0 else (n > 1))
        n[rng.choice(room, size=min(abs(int(rows - n.sum())), room.size),
                     replace=False)] += step
    return n


def rank_rows(lengths, seed: int, masked: bool = False):
    """Scores, grades 0-4 and weights (a tenth at 0 when ``masked``) on the
    card, and the rows' QueryGroups."""
    off = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    n = int(off[-1])
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 5, n).astype(np.float32)
    w = (np.where(rng.uniform(size=n) < 0.1, 0.0, 1.0) if masked
         else np.ones(n)).astype(np.float32)
    s = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    return (s, torch.from_numpy(y).cuda(), torch.from_numpy(w).cuda(),
            QueryGroups(off, y, w))


def rank_gap(g, h, want_g, want_h) -> float:
    """The widest gap of the gradients and of the hessians, each against
    the largest magnitude of its kind."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in ((g, want_g), (h, want_h)))


def phase_lambdarank(card) -> dict:
    """Phase 22: the kernel against its plain version in every case, two
    launches bit-equal; then both timed at Yahoo LTR's queries and at the
    long query against the kernel's bound."""
    log("== phase 22: lambdarank (LambdaRank's lambdas over query groups "
        "of any length) vs its plain version on the card")
    yahoo = rank_lengths(P22_ROWS, P22_QUERIES, seed=22)
    cases = {
        "yahoo": (yahoo, False, dict(max_position=20, sigma=1.0)),
        "yahoo_gain_table_masked": (yahoo, True, dict(
            max_position=10, sigma=2.0,
            label_gain=(0.0, 1.0, 3.0, 7.0, 15.0))),
        "long": (np.array([P22_LONG]), False, dict(max_position=20,
                                                   sigma=1.0)),
        "long_among_short": (np.array([5, P22_LONG, 1, 2, 139]), True,
                             dict(max_position=20, sigma=1.0)),
    }
    out, rows = {}, {}
    for name, (lengths, masked, kw) in cases.items():
        s, y, w, groups = rank_rows(lengths, seed=len(name), masked=masked)
        obj = get_objective("lambdarank", queries=groups, **kw)
        before = rank_ops.lambdarank_cuda.launches
        g1, h1 = obj.grad_hess(s, y, w)
        g2, h2 = obj.grad_hess(s, y, w)
        pg, ph = objectives_mod.lambdarank_plain(
            s, y, w, groups, kw["max_position"], kw["sigma"],
            kw.get("label_gain"))
        torch.cuda.synchronize()
        if rank_ops.lambdarank_cuda.launches != before + 2:
            raise AssertionError(f"22 {name}: the objective did not launch "
                                 f"the kernel once a call")
        if not (torch.equal(g1, g2) and torch.equal(h1, h2)):
            raise AssertionError(f"22 {name}: two launches differ")
        err = rank_gap(g1, h1, pg, ph)
        if not err <= P22_TOL:
            raise AssertionError(f"22 {name}: the kernel is {err} from its "
                                 f"plain version (tolerance {P22_TOL})")
        out[name] = dict(rows=groups.n, queries=groups.count,
                         longest=groups.longest, pairs=groups.pairs,
                         gap=err)
        if name in ("yahoo", "long"):
            def kernel():
                obj.grad_hess(s, y, w)

            def plain():
                objectives_mod.lambdarank_plain(
                    s, y, w, groups, kw["max_position"], kw["sigma"], None)
            bound, bound_by = bound_ms(
                RANK_ROW_BYTES * groups.n + 8 * (groups.count + 1),
                RANK_OPS_PER_PAIR * groups.pairs, PEAK_F32_OPS_PER_S)
            rows[name] = dict(
                ms=time_ms(kernel, P22_TIME_REPS),
                ms_cold=time_cold_ms(kernel),
                plain_ms=time_ms(plain, 3, warm=1),
                bound_ms=bound, bound_by=bound_by, library_ms=None)
            r = rows[name]
            log(f"22 {name} ({groups.n:,} rows, {groups.count:,} queries, "
                f"longest {groups.longest}, {groups.pairs:,} pairs): kernel "
                f"{r['ms']:.4f} ms warm / {r['ms_cold']:.4f} L2 cold, "
                f"{100 * bound / r['ms']:.2f}% of its {bound:.5f} ms bound "
                f"({bound_by}); the plain version {r['plain_ms']:.3f} ms")
        del s, y, w, g1, h1, g2, h2, pg, ph, obj
        torch.cuda.empty_cache()
    log("22: the kernel within " + ", ".join(
        f"{k} {v['gap']:.3g}" for k, v in out.items())
        + f" of its plain version (tolerance {P22_TOL}), two launches "
        f"bit-equal in every case, on {card}")
    return dict(cases=out, rows=rows,
                max_abs_err=max(v["gap"] for v in out.values()))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU is available")
    card = card_line()
    log(f"== phase 1: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 2: build " + ", ".join(KERNELS) + " and the host engine "
        + native.NAME)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        host = ex.submit(_build.build_host, native.NAME)
        libs = _build.build_all(KERNELS, verbose=True)
        libs[native.NAME] = host.result()
    for name in KERNELS:
        _build.load(name)
    native.get_lib()
    log(f"built {libs} in {time.perf_counter() - t0:.2f} s")
    log_geometry()

    rows, max_err = phase_kernels()
    rows8, max_err8 = phase_int8_kernel()
    rows3, max_err3, launches3 = phase_cols_kernel()
    X, y = higgs_shaped(HIGGS_ROWS, seed=0)
    Xh, yh = higgs_shaped(HIGGS_HOLDOUT, seed=1)
    data = (X, y, Xh, yh)
    fits = {}
    fits["4"], base = phase_end_to_end("4", ["node_hist_bf16"], data)
    fits["4b"], quantized = phase_end_to_end(
        "4b", ["node_hist_int8", "quant_stats"], data, useQuantizedGrad=True,
        quantWarmupIters=0)
    fits["4c"] = phase_end_to_end("4c", ["node_hist_int8", "quant_stats"],
                                  data, useQuantizedGrad=True,
                                  quantWarmupIters=0,
                                  growthPolicy="depthwise")[0]
    fits["4d"] = phase_end_to_end(
        "4d", ["node_hist_bf16", "node_hist_int8", "quant_stats"], data,
        check_quality=False, useQuantizedGrad=True)[0]
    phase_small_agreement("5")
    for policy in ("leafwise", "depthwise"):
        phase_small_agreement("5b", needs=("node_hist_int8", "quant_stats"),
                              numIterations=4, quantWarmupIters=1,
                              useQuantizedGrad=True, growthPolicy=policy)
    phase_small_objectives()
    fits["6"], multiclass = phase_multiclass()
    fits["7"] = phase_ranker()
    fits["8"], categorical = phase_categorical()
    phase_small_categorical()
    golden = phase_golden()
    fits.update(phase_sampling(data, base))
    phase_small_sampling()
    p11 = phase_main_path_extensions(data, base, quantized, multiclass,
                                     categorical)
    fits.update(p11.pop("fits"))
    p12 = phase_serving(quantized, multiclass, Xh, card)
    p13 = phase_plan_and_fleet(base, quantized, multiclass, data, card)
    p14 = phase_data_group(base, quantized, multiclass, data)
    del X, y, Xh, yh, data
    p15 = phase_vw_and_host_stages(card)
    p16 = phase_estimators(card)
    p17 = phase_dnn(card)
    X, y = higgs_shaped(HIGGS_ROWS, seed=0)
    Xh, yh = higgs_shaped(HIGGS_HOLDOUT, seed=1)
    p18 = phase_automl_and_http((X, y, Xh, yh), base, quantized, card)
    del X, y, Xh, yh
    p19 = phase_transformer(card)
    p20 = phase_group_resume(card)
    fits.update(p20.pop("fits"))
    p21 = phase_prng(card)
    fits.update(p21.pop("fits"))
    p22 = phase_lambdarank(card)
    fits.update(p18.pop("fits"))
    fits["17c"] = p17["17c"]
    fits["15e"] = p15.pop("15e")
    for k in ("bf16", "quantized"):
        fits[f"14a_{k}"] = p14["14a"].pop(k)
    fits["14b"] = p14.pop("14b")
    fits["14c"] = p14.pop("14c")
    det_rows = p14["14a"].pop("det_rows")
    log("14a kernel rows: " + json.dumps(det_rows))
    log("fits: " + json.dumps(fits) + "; " + json.dumps(golden)
        + "; phase 11: " + json.dumps(p11) + "; phase 12: "
        + json.dumps(p12) + "; phase 13: " + json.dumps(p13)
        + "; phase 14: " + json.dumps(p14) + "; phase 15: "
        + json.dumps(p15) + "; phase 16: " + json.dumps(p16)
        + "; phase 17: " + json.dumps(p17) + "; phase 18: "
        + json.dumps(p18) + "; phase 19: " + json.dumps(p19)
        + "; phase 20: " + json.dumps(p20) + "; phase 21: "
        + json.dumps(p21) + "; phase 22: " + json.dumps(p22))

    def launches(kernel):
        return sum(f["counts"][kernel] for f in fits.values()
                   if "counts" in f)

    def entry(name, source, replaces, n_launch, err, r):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": r["ms"], "ms_cold": r["ms_cold"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "pct_of_bound": 100.0 * r["bound_ms"] / r["ms"],
                "library_ms": r["library_ms"]}

    # each kernel's record carries its most frequent main-path shape: the
    # half-width smaller-child pass (W = leafBatch = 8) over int32 bins at
    # 255 bins for the node kernels, the full-width S=2 pass for kernel 3
    record = {"kernels": [
        entry("node_hist_bf16", "mmlspark_tpu_torch/csrc/node_hist.cu",
              "mmlspark_tpu/ops/histogram.py:679", launches("node_hist_bf16"),
              max_err, rows[(500_000, 8, 255, "int32")]),
        entry("node_hist_int8", "mmlspark_tpu_torch/csrc/node_hist_int8.cu",
              "mmlspark_tpu/ops/histogram.py:679",
              launches("node_hist_int8"), max_err8,
              rows8[(500_000, 8, 255, "int32")]),
        entry("hist_bf16", "mmlspark_tpu_torch/csrc/hist_bf16.cu",
              "mmlspark_tpu/ops/histogram.py:647", launches3, max_err3,
              rows3[COLS_MAIN]),
        # kernel 1's deterministic mode at 14a's most frequent pass: all
        # phase 4's rows in 8 blocks, leafwise's 16 children (no half pass
        # on the blocked reduction)
        entry("node_hist_det", "mmlspark_tpu_torch/csrc/node_hist_det.cu",
              "mmlspark_tpu/ops/histogram.py:679", launches("node_hist_det"),
              p14["14a"]["det_err"], det_rows[16]),
        # a quantized tree's int8 statistics at higgs-qgrad-fit's [3,
        # 10,500,000] (21c), the eager chain as its plain version; it
        # replaces XLA elementwise code, no pallas_call
        {**entry("quant_stats", "mmlspark_tpu_torch/csrc/quant_stats.cu",
                 "mmlspark_tpu/models/gbdt/growth.py:286",
                 launches("quant_stats"), p21["21c"]["max_abs_err"],
                 p21["21c"]["row"]),
         "amax_launches": launches("stats_amax"),
         "route_ms": p21["21c"]["row"]["route_ms"]},
        # LambdaRank's lambdas at the yahoo-rank-refit cell's queries (22),
        # launches from phase 7's fit; it replaces XLA code over padded
        # groups, no pallas_call
        entry("lambdarank", "mmlspark_tpu_torch/csrc/lambdarank.cu",
              "mmlspark_tpu/models/gbdt/objectives.py:164",
              launches("lambdarank"), p22["max_abs_err"],
              p22["rows"]["yahoo"]),
    ]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
