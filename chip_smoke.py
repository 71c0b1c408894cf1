#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (mfx_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and nvcc, and
imports nothing of JAX and nothing of the JAX package mfx. Phases, each
printed as it ends:

1. card: the GPU's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every kernel from mfx_torch/csrc, beside the ML-25M data and
   phase 29's NMF and learnable iALS cell (no hand-written kernel);
3. kernels against their plain PyTorch versions at the ml25m_rank64
   preset's shapes (su = si = 1024, T = 256, rank 64, int4; the rank-64
   instances of the two kernels that phase 11 runs at rank 128): the first
   2,048 tiles of the first non-empty sparse sweep and the first 64
   strata of the first dense group, max abs difference <= 1e-4, two
   kernel runs bitwise equal, and the time of each; then dense_phase on
   the first 256 strata of group 0 once on one block and twice on the
   card's count (tables and SSE bitwise equal), and the whole of group 0
   and the whole dense phase of an epoch on the card's count; then the
   same 2,048 tiles through sgd_sweep_tile and sgd_sweep_step_u (tpg = 4) on the
   plain tables of the same model, so that the lane, tile-bias and
   step-batched bodies are timed on one tile stream; then sgd_sweep on
   the whole first sweep from the untrained tables, once on one block
   and twice on as many as the card holds: tables and SSE bitwise equal,
   the times, the sweep's tiles and the tiles on its longest dependency
   chain, and the blocks launched;
4. main path: two epochs of mfx_torch.solvers.blocked.train_epochs_blocked
   on the full ML-25M-shaped synthetic with the preset unchanged, through
   both kernels (launch counters > 0), held-out RMSE (unclipped) <= 0.406
   after epoch 2;
5. tile_topk against its plain version at 1,000,000 items, rank 64,
   B = 256, tile 1024 (seeded random tables): f32 at depth 2 and 8, bf16
   and int8 at depth 2, values within 1e-4, lanes equal except near-ties,
   two kernel runs bitwise equal, and the time of each beside the stock
   path's (matmul_f32, then torch.topk over each tile);
6. serving path: the phase-4 model through a checkpoint (bitwise round
   trip), the stock, fused and certified-exact fused recommenders with
   the training ratings excluded (exact == stock; the fused contract and
   its recall@10), the HTTP server (every endpoint 200, answers equal to
   direct calls) and the CLI, with tile_topk launched (counter > 0);
7. bpr_sweep against its plain version at the BPR cell's shapes (su =
   si = 512, T = 256, rank 64): the first 2,048 tiles of segment 0 of
   epoch 0, max abs difference <= 1e-4, two kernel runs bitwise equal,
   and the time of each; then the whole of segment 0 once on one block
   and twice on as many as the card holds (bitwise);
8. the BPR path: mfx_torch.parallel.bpr_sharded.train_epochs_bpr_ring with
   the billion_bpr_sharded preset unchanged but for parallel.model_axis=1,
   its 5 epochs on the billion-implicit synthetic cut to 1/10 of its users,
   items and positives (seed 104, test_frac 0.001): the loss falls every
   epoch and ends below ln 2, bpr_sweep launched (counter > 0), and as a
   smoke check, not a quality gate (this synthetic is barely learnable at
   the cell's density), the held-out sampled AUC ends above the untrained
   model's; HR/NDCG/MRR@10 (sampled protocol, on the first 10,000 held-out
   positives) are printed;
9. sgd_sweep_tile and sgd_sweep_step_u against their plain versions at the
   ml1m_rank32_biased preset's shapes (su = si = 512, T = 256, rank 32,
   tpg = 4): the first 2,048 tiles of epoch 0 of the ML-1M-shaped
   synthetic, same checks and times; then each over the whole sweep
   once on one block and twice on the card's count (tables, biases and
   SSE bitwise equal);
10. the tile-bias path: train_epochs_blocked with the ml1m_rank32_biased
   preset unchanged, its 30 epochs on the full ML-1M-shaped synthetic
   (seed 101), through sgd_sweep_tile; then again with
   sgd.step_user_batch=true, through sgd_sweep_step_u (each launch counter
   > 0 in its run). The train RMSE falls, the held-out RMSE (unclipped)
   ends <= 0.530 and below the untrained model's, the two runs end within
   1e-3 of each other, and a second step_user_batch run of 2 epochs
   repeats the first's state after 2 epochs bit for bit;
11. sgd_sweep at rank 128 and dense_phase with int8 codes at rank 128
   against their plain versions at the netflix100m_rank128_dp preset's
   shapes (su = si = 512, T = 256, rank 128, lane biases, auto carving)
   on the full netflix synthetic (480,189 x 17,770, 100,480,507 ratings,
   seed 103, whole stars): the first 2,048 tiles of the sparse sweep and
   the first 64 strata of dense group 0, same checks and times; the
   whole sweep and the whole of group 0 once on one block and twice on
   the card's count (tables and SSE bitwise equal); then each dense group
   and the sweep on the card's count, the split of an epoch;
12. the netflix path: train_epochs_blocked with netflix100m_rank128_dp and
   parallel.mode=single, 3 of its 15 epochs (epochs are depth, cut for
   time): both kernels launched, the train RMSE falls every epoch and the
   held-out RMSE (unclipped) lies below the untrained model's after every
   epoch (the reference's own held-out RMSE on this synthetic is lowest
   after the first epoch: tests/test_torch_slice.py::
   test_netflix_cut_follows_the_reference_trainer), peak memory <= 80 GB,
   and a second run of 1 epoch repeats the first run's state after epoch
   1 bit for bit;
13. Java parity on the card: mfx_torch.solvers.sgd.train_epochs with
   partitioner='fixed' and batch_size = 1, 2 epochs on a seeded synthetic
   of 2,000 ratings (60 x 80, seed 105, rank 8, biases) from tables shared
   through model_from_numpy: the tables and biases within 5e-5 (the
   reference's own tolerance) of the float64 sequential oracle
   (mfx_torch.oracle); a second run bitwise equal; conflict-free batches
   of 32 and 128 give bitwise-equal tables;
14. the minibatch path: the ml100k_rank16 preset unchanged (rank 16, no
   biases, conflict-free batches of 2,048, 30 epochs) on the full
   ML-100K-shaped synthetic (943 x 1,682, 100,000 ratings): one epoch's
   plan (batches, real ratings), the epoch dispatched op by op and replayed
   as a CUDA graph (the trainer's form on the card) bitwise equal, their
   times, a graph-replayed epoch with no host sync (sync debug mode
   'error'), a kernel breakdown of 256 batches; then the 30 epochs through
   mfx_torch.train.driver.train with log_path and checkpoints: the train
   RMSE falls every epoch, the held-out RMSE ends <= 0.533 and below the
   untrained model's, one JSONL record an epoch; the run resumed from its
   epoch-26 checkpoint (its last 3 epochs, a cut for the script's time)
   equals it bit for bit; the CLI's update with a
   seeded delta of 2,000 ratings (10 new users, 10 new items) grows the
   tables by 10 and 10 as step 30, and recommend --fused on it launches
   tile_topk (counter > 0); each of those launches is made again on the
   inputs recommend gave it (rank 16, tile 128, depth 2) and held against
   tile_topk_plain as in phase 5;
15. the time form of sgd_sweep (blocked timeSVD) against its plain
   version on phase 4's ML-25M-shaped synthetic made temporal (the
   reference tests' recipe: seeded timestamps in [0, 1e6), a N(0, 0.35)
   shift per (item, bin) on 30 bins, ratings clipped to [0.5, 5]; seed
   102) at the blocked timeSVD trainer's shapes (rank 64, 30 bins, su = si
   = 512, T = 256, tpg 4): the first 2,048 tiles of the first sweep of
   epoch 0, max abs difference <= 1e-4, two kernel runs bitwise equal, the
   time of each; the whole first sweep once on one block and twice on
   the card's count (tables and SSE bitwise equal); the rank-128 form on
   the same 2,048 tiles and the whole sweep, checked the same way;
16. the timeSVD path: mfx_torch.train.driver.train with solver='timesvd',
   timesvd.kernel='pallas', rank 64 and TimeSVDConfig's defaults but
   reg_alpha = reg and TIME_PATH_EPOCHS (6) of its 20 epochs (a depth cut
   for the script's time), on phase 15's data handed to the driver
   through data.root as the loader's synthetic cache: the time form
   launched (counter > 0, the lane form not at all), the train RMSE falls
   every epoch, the held-out time-aware RMSE ends below the untrained
   model's and below lane-biased MF's (sgd_sweep, no dense phase) with
   the same storage rank, blocks, epochs, lr and reg on the same split,
   and a second run of 2 epochs repeats the first's state after 2 epochs
   (its checkpoint) bit for bit; then timesvd.kernel='jnp' (the
   snapshot-minibatch trainer, with timesvd.dup_trust=16: without it the
   reference's own trainer reaches NaN on this skew; JNP_TIME_EPOCHS (6) of
   its 20 epochs, a depth cut for the script's time)
   through the driver on the ML-1M-shaped synthetic made temporal the
   same way (seed 101):
   the train RMSE falls every epoch, and the held-out RMSE is the
   time-aware one of the trainer's model;
17. (run after phase 6, on phase 4's data, plan and trained tables, whose
   biases are not 0) the epoch form of sgd_sweep_tile.cu
   (sgd_sweep_epoch) against its plain version on the first 2,048 tiles
   of the first sweep: tables and residuals within 1e-4, two kernel runs
   bitwise equal, its time beside the tile form's on the same tiles; the
   whole first sweep once on one block and twice on the card's count
   (tables, residuals and SSE bitwise equal); then the frozen-bias and
   bias-free forms of dense_phase.cu (int4, rank 64) on the first 64
   strata of group 0 (tables within 1e-4, the frozen form's row and
   column sums of E within sqrt(terms) ulps of the largest and 1e-4,
   bitwise across runs), 256 strata on one block and on the
   card's count (bitwise; then ten more timed runs on the card's count,
   and one whose launch order the wrapper works out inside the timed
   call), group 0 and the epoch's dense phase on the
   card's count with their times and the frozen form's batched bias
   updates; then the frozen form's int8 instances at ranks 64 and 128
   on this data carved at the netflix cell's blocks (su = si = 512),
   checked the same way;
18. the ml25m_rank64 preset's 2 epochs through train_epochs_blocked in
   each other bias mode, on phase 4's split: (a) sgd.bias_mode=epoch, (b)
   sgd.bias_mode=tile, (c) model.use_bias=false. Each launches its
   kernels ((a) sgd_sweep_epoch and the frozen dense form, (b)
   sgd_sweep_tile and the frozen form, (c) sgd_sweep_tile and the
   bias-free form; sgd_sweep and the lane form never), the train RMSE
   falls, the held-out RMSE (unclipped) after epoch 2 lies below the
   untrained model's and, for (a) and (b), within 0.03 of phase 4's lane
   run (the reference's own tolerance between bias modes,
   tests/unit/test_bias_epoch.py); each epoch's seconds split into dense,
   sparse and batched-bias time, and the peak memory; a second run of (a)
   for 1 epoch repeats the first's state after epoch 1 bit for bit; then
   python -m mfx_torch.cli train --preset ml25m_rank64 --set
   sgd.bias_mode=epoch --set sgd.epochs=1 (on phase 23's dataset cache,
   removed after it) prints the reference's JSON;
19. the rank-32 forms against their plain versions. On ml1m_rank32_biased
   and the full ML-1M-shaped synthetic, as phase 20's runs plan and carve
   it (su = si = 512, T = 256): sgd_sweep (lane) on the first 2,048 tiles
   of the first sweep of run (a)'s plan (no dense phase), within 1e-5,
   its time beside the rank-64 lane form's on the same tiles, and the
   whole sweep once on one block and twice on the card's count
   (bitwise); dense_phase in the lane, frozen-bias and bias-free forms
   with int4 codes on all of group 0 of the carving of runs (b)-(d)
   (within 1e-5; the frozen form's row and column sums of E as phase
   17's), the same strata on one
   block and on the card's count (bitwise), group 0 and the epoch's dense
   phase; the lane and frozen forms with int8 codes on the same strata
   (within 1e-4). The same checks on phase 4's data at the ml25m_rank64
   preset's shapes (su = si = 1024; 64 strata against plain, 256 on one
   block and the card's count), which no preset runs at rank 32, run
   after phase 18. After phase 15, the time form at rank 32 on the first
   2,048 tiles of phase 15's data at the blocked timeSVD trainer's shapes
   (su = si = 512, T = 256) with 16 bins and with 28 (the most rank 32
   holds), within 1e-5, and with 16 the whole first sweep on one block
   and the card's count;
20. ml1m_rank32_biased on the full ML-1M-shaped synthetic, its 30 epochs
   through train_epochs_blocked in four runs: (a) sgd.bias_mode=lane (the
   lane sweep at rank 32, no dense phase), (b) sgd.dense_span=full
   sgd.dense_chi=-1 (every stratum dense: the frozen dense form), (c) (b)
   with sgd.bias_mode=lane (the lane dense form), (d) (b) with
   model.use_bias=false (the bias-free form). Each launches its rank-32
   form and no other kernel, the train RMSE falls, the held-out RMSE
   (unclipped) ends below the untrained model's and, for (a), <= 0.530,
   for (b)-(d) within RANK32_RUNS' range (the JAX trainer's full-size CPU
   run, tools/bias_mode_check.py, within 0.003); each run's epoch seconds,
   split into dense, sparse and batched-bias time, and peak memory. Then
   (e) solver=timesvd timesvd.kernel=pallas model.rank=32
   timesvd.n_bins=16 through mfx_torch.train.driver on phase 16's temporal
   ML-1M synthetic: the time form at rank 32 launched, the train RMSE
   falls every epoch, the time-aware held-out RMSE ends below the
   untrained model's, a 2-epoch repeat is bitwise; then python -m
   mfx_torch.cli train on run (c) for 2 epochs prints the reference's
   JSON;
21. the rank-128 forms of sgd_sweep_tile.cu and sgd_sweep_step_u.cu, the
   frozen and bias-free int8 rank-128 forms of dense_phase.cu and
   bpr_sweep.cu at ranks 32 and 128 against their plain versions. Run
   after phase 11, on its netflix plan and carving, with the untrained
   model's plain tables and seeded N(0, 0.1) biases: the tile form with
   and without biases, the epoch form (its residuals compared too) and
   step_u (tpg 4) on the first 2,048 tiles of the sparse sweep (within
   1e-4, two kernel runs bitwise), each over the whole sweep once on one
   block and twice on the card's count (tables, biases, residuals and SSE
   bitwise); the two dense forms on group 0 as phase 17 holds them (64
   strata within 1e-4, the frozen sums within sqrt(terms) ulps; 256 on
   one block and the card's count, bitwise), and group 0 and the epoch's
   dense phase on the card's count. Run after phase 7, on its data:
   bpr_sweep at ranks 32 and 128 as phase 7 holds rank 64 (2,048 tiles of
   segment 0, then the whole segment 0 on one block and on the card's
   count);
22. the paths of phase 21's forms. After phase 12: netflix100m_rank128_dp
   with parallel.mode=single, 2 epochs each from phase 12's untrained
   model with (a) sgd.bias_mode=tile, (b) sgd.bias_mode=epoch, (c)
   sgd.bias_mode=tile sgd.step_user_batch=true, (d) model.use_bias=false:
   each launches its rank-128 sweep form and its int8 rank-128 dense form
   (frozen, or none in (d)) and no other kernel, the train RMSE falls
   every epoch, the held-out RMSE (unclipped) lies below the untrained
   model's after every epoch, (a), (b) and (d) end within 0.03 of phase
   12's lane run after the same epoch and (c) within 0.03 of (a), peak
   memory <= 80 GB; a second run of (c) for 1 epoch repeats its state
   after epoch 1 bit for bit. After phase 8: billion_bpr_sharded with
   parallel.model_axis=1 and model.rank=32, then =128, on phase 8's data
   for the preset's 5 epochs: bpr_sweep launched, the loss falls every
   epoch and ends below ln 2, and (a smoke check, as phase 8's) the
   sampled AUC ends above the untrained model's;
23. (run after phase 6, on phase 4's model, data and split) the deep form
   of tile_topk (depth > 32 or tile > 2048) bitwise equal to its plain
   version on tables whose scores are exact in any order (the serving
   shapes, a split into many pieces a tile, depth 300), then against its
   plain version at 1,000,000 items x 256 users (seeded random tables, as
   phase 5): f32 at
   depths 33, 64 and 256 on tiles of 1024, depth 64 on tiles of 4096,
   depth 2 on tiles of 8192, bf16 and int8 at depth 64, and at the serving
   path's shapes (the trained catalog, 256 users, depth 64, tiles of
   4096): values within 1e-4, lanes equal but at near-ties, two runs
   bitwise, each time in turns with the stock path (stock, kernel,
   kernel, stock) and beside the bound; then the
   serving path through it, its launches counted alone (> 0): certified
   exact at exact_depth 64 on tiles of 4096 (k = 100 on 1,024 users equal
   to the stock exact scorer, the phase-6 gate) and the approximate
   recommender on tiles of 4096; then the CLI on the phase-4 checkpoint
   and data (written as the loader's cache): eval in the full and user
   protocols on the uniform split's whole test split (RMSE and MAE equal
   the trained model's clipped held-out values within 1e-6) and in the
   sampled protocol on the leave-one-out split, serve --fused
   --fused-exact --exact-depth 64 --tile 4096 (k = 100 equal to a direct
   call and to stock exact), serve --mmr 0.7 (equal to a direct call and
   to rerank_mmr on CPU copies of the same pools) and recommend --fused
   --tile 4096, the processes side by side; the full protocol's ranks of
   2,048 positives against a float64 host recount, and the CLI's full
   hr/ndcg/mrr@10 against full_hr_ndcg_at_k in this process (1e-6);
24. ml100k_rank16 with model.dtype=bfloat16 through the training driver for 15
   of its 30 epochs (a cut for the script's time): bf16 tables, the train
   RMSE falls every epoch, the held-out RMSE ends within 0.003 of the
   reference trainer's bf16 run over as many epochs on the CPU
   (tools/bf16_check.py --epochs 15), the last checkpoint loads back bf16 bit for
   bit; before it, the bf16 tables' scatter-add kernel (bf16_row_add,
   csrc/row_add_bf16.cu) against its plain version on CPU copies at the
   step's shapes (2,048 slots into the rank-16 table; distinct rows and
   64 hot rows), bitwise, its time beside index_put_'s; then one
   ml25m_rank64 epoch with profile_phases on phase 23's data, whose
   record carries plan_ms, dense_ms, sparse_ms and eval_ms;
25. the forms of the last reference branches of the trainer's kernels
   against their plain versions: the bf16 form (sgd.mxu='bf16') of every
   SGD sweep body (lane, tile biases, none, epoch-frozen, step_u) on the
   first BF16_CELL_TILES (512) of phase 3's tiles (rank 64, plain
   tables with seeded N(0, 0.1) biases; a cut for the script's time),
   tables bitwise equal to the plain version's (it sums in the kernel's
   order; the SSE within 1e-4) and the f32 form from the same state not,
   each beside the f32 form's time on the same tiles, and on the whole
   first sweep once on one block and twice on the card's count
   (bitwise); echo=2 of dense_phase in the lane and bias-free forms on
   the first 64 strata of phase 3's group 0 (int4, rank 64), the first
   256 on one block and the card's count (bitwise), group 0 and the
   epoch's dense phase at echo 2. The same at rank 32 on phase 19's
   ML-1M plan and carving (all of group 0) and at rank 128 on phase 21's
   netflix plan (the lane echo form on group 0, int8); each echo form
   within 1e-4 of its plain version, each bf16 form as above;
26. (after phase 18, on phase 4's data and untrained model) the
   ml25m_rank64 preset for 2 epochs through train_epochs_blocked in each
   of nine runs: (a) sgd.dense_echo=2, (b) sgd.dense_spg=2, (c)
   sgd.mxu=bf16, (d) sgd.dense_chi=0.0025 sgd.dense_span=head, (e)
   sgd.mxu=bf16 sgd.bias_mode=tile sgd.step_user_batch=true, (f) bf16 with
   sgd.bias_mode=epoch, (g) bf16 with sgd.bias_mode=tile, (h) bf16 with
   model.use_bias=false, (i) sgd.dense_echo=2 with model.use_bias=false.
   Each launches its kernels and no other, the train RMSE falls, the
   held-out RMSE (unclipped) ends below the untrained model's; (a), (b),
   (d) <= 0.406, (c) <= 0.406 and within 0.003 of phase 4's, (e)-(g)
   within 0.03 of phase 4's (the bias modes' tolerance); (b) ends with
   phase 4's tables and held-out RMSE bit for bit and pads its carving;
   each run's epoch seconds split into dense, sparse and bias time, its
   dense_info and held-out RMSE after each epoch;
27. ranks 16, 8, 4, 2 and 1 of the four sweep kernels against their plain
   versions. On ml1m_rank32_biased's plan (su = si = 512, T = 256, the
   full ML-1M-shaped synthetic), from seeded tables with N(0, 0.1)
   biases at each rank: the lane (not at rank 1: no lane model there),
   tile, bias-free, epoch and step_u (tpg 4) forms on the first 256
   tiles of the first sweep (within 1e-4, two kernel runs bitwise), each
   bf16 form on the first 128 (bitwise to its
   kernel-order plain version, the f32 form from the same state the
   control that must land off), every form over the whole sweep once on
   one block and twice on the card's count (bitwise). The time form on
   phase 15's data at the blocked timeSVD trainer's shapes, rank 16 with
   12 bins and rank 8 with 4 (256 tiles, then the whole first sweep once
   on one block and twice on the card's count).
   bpr_sweep on the BPR cell's segment 0 (256 tiles, then its first
   131,072 tiles once on one block and twice on the card's count). Times,
   bounds and critical paths printed;
28. the paths through them, each from the seeded untrained model of its
   rank: ml1m_rank32_biased unchanged but for (a) model.rank=16, (b) =8,
   (c) =4 (tile biases, through sgd_sweep_tile), (d) rank 16 with
   sgd.bias_mode=lane (sgd_sweep), (e) rank 16 with
   sgd.step_user_batch=true (sgd_sweep_step_u), (f) rank 16 with
   sgd.mxu=bf16, and (a2), (a1), (d2), (e2), (f2) the same at ranks 2 and
   1 ((d2): the baseline predictor mu + bu + bi): each its 30 epochs, its
   kernel launched and no other, the train RMSE falls every epoch, the
   held-out RMSE (unclipped) below the untrained model's after every
   epoch, (a), (b), (a2) and (a1) within 0.003 of the JAX trainer's CPU
   run at full size (tools/bias_mode_check.py --rank), (f) within 0.003
   of (d), (f2) of (a2); (d)'s model through the stock, fused and
   certified-exact recommenders (tile_topk at the augmented width 24;
   exact == stock within 1e-4 modulo near-ties); (a2)'s model through the
   CLI's recommend --fused (tile_topk at the augmented width 8, each launch
   held against tile_topk_plain on its inputs: the "rank2_recommend" of
   tile_topk's entry). (g) ml25m_rank64 unchanged but for model.rank=16,
   then =2, 2 epochs on phase 4's data, every rating through the lane
   sweep: held-out below the untrained model's, a second run bit for bit.
   (h) solver=timesvd at rank 16 with 12 bins, 20 epochs on phase 15's
   data: the time form launched, the train RMSE falls every epoch, the
   time-aware held-out RMSE below the untrained model's and
   lane MF's at rank 16. (i) billion_bpr_sharded as phase 8 runs it at
   model.rank=16, =8, =2 and =1: the loss falls every epoch, and at 16
   and 8 ends below ln 2 (at 2 and 1 it starts above 0.70 and is printed;
   the AUC printed). Both phases' wall times are printed at the end;
29. the Gram-engine solvers (mfx_torch/solvers/als.py, ials.py, nmf.py:
   stock torch ops, as the reference computes them outside any Pallas
   kernel; TF32 asserted off). (a) After phase 22, on phase 12's data:
   netflix100m_rank128_dp with solver=als and parallel.mode=single through
   mfx_torch.train.driver.train (the synthetic as the loader's cache,
   written by make_data), 2 of the preset's 8 sweeps at rank 128 with
   biases: ALS-WR's regularized objective never rises (1e-6 relative; the
   train RMSE is printed, ALS-WR need not lower it), the held-out RMSE
   (unclipped) ends below the untrained model's, printed beside phase
   12's; one sweep repeated from the same tables bit for bit; the first
   8,192 users' rows of a user half-sweep on the card within 3e-3 of the
   port's CPU solve (in a thread); an item half-sweep with no host sync
   (sync debug mode 'error'); each half-sweep's split (gather + Gram,
   scatter, solve, host loop) beside its bound; the checkpoint through
   the CLI's recommend (the fused recommenders take rank < 128, as the
   reference's: --fused must refuse it). (b) After phase 22's BPR runs, on
   phase 8's data: one iALS sweep (IALSConfig's defaults, rank 64) timed
   and repeated bit for bit, each half-sweep's split; and, while the
   kernels build (it runs none), a learnable make_implicit_synthetic
   (50,000 x 5,000, 10,000,000 positives, true rank 8, seed 107): rank
   32, alpha 30, reg 0.5, 4 sweeps, the sampled AUC on 1,000,000 of the
   training positives above max(0.70, untrained + 0.1)
   (tests/unit/test_ials.py:95), and fold_in_implicit of 256 users'
   histories within 2e-4 of their rows of a user half-sweep. (c) While
   the kernels build, on phase 4's data: NMF (NMFConfig's defaults, rank
   64, no biases): the objective never rises from its start, the factors
   stay >= 0, the held-out RMSE ends below the untrained model's, each
   half-sweep's split; after phase 19's extra cell, ALS at rank 64 (2
   sweeps), checkpointed and served by the CLI's recommend --fused:
   tile_topk launched (counter > 0), each launch made again on its inputs
   and held against tile_topk_plain as in phase 14. Phase 29's records
   are one JSON line ({"gram_engine": ...}) before the total time;
30. SVD++ and timeSVD++ (mfx_torch/solvers/svdpp.py, timesvdpp.py). While
   the kernels build (neither launches a hand-written kernel): (c)
   solver=timesvdpp timesvdpp.kernel=jnp timesvdpp.dup_trust=16 through
   the driver on phase 16's temporal ML-1M (its recipe and seed, written
   as the loader's cache), 5 of 20 epochs: the train RMSE falls every
   epoch, the time-aware held-out RMSE ends below the untrained model's;
   then (a) python -m mfx_torch.cli train --preset ml1m_rank32_biased with
   solver=svdpp svdpp.dup_trust=16 (its 20 epochs, the ML-1M-shaped
   synthetic) and, side by side, the preset's minibatch biased MF
   (solver=sgd sgd.partitioner=fixed sgd.kernel=jnp, 20 epochs, dup_trust
   16: without it the reference's trainers reach NaN on this skew,
   tools/svdpp_check.py), each with a JSONL log, both done before any
   kernel is timed: the train RMSE falls every epoch, the held-out RMSE
   (clipped, the CLI's) ends below the untrained model's, at most
   minibatch MF's + 0.01 (the reference's margin) and within 0.003 of the
   JAX trainer's CPU run (tools/svdpp_check.py). After phase 28 (h): (b)
   solver=timesvdpp timesvdpp.kernel=pallas at rank 64 with 30 bins
   (ml25m_rank64's model, TimeSVDPPConfig's defaults but reg_alpha = reg,
   2 of its 20 epochs) through the driver on phase 15's data (phase 16's
   data root): sgd_sweep_time launched and no other kernel, the train RMSE
   falls every epoch, the time-aware held-out RMSE ends below the
   untrained model's; the run again through the trainer (with capture and
   timings) gives the driver's model and train RMSEs bit for bit, and each
   epoch's Y step and S refresh in CUDA events; train_epochs_timesvdpp
   with lr_y = 0 equals train_epochs_timesvd_blocked over 2 epochs from
   the driver's model, split and features (torch.equal tables every
   epoch, equal train RMSEs); the time form against its plain version on
   the first 2,048 tiles of the path's plan from the tables after one Y
   step (S != 0), within 1e-4, two kernel runs bitwise;
31. the snapshot-minibatch BPR trainers (mfx_torch/solvers/bpr.py,
   parallel/data_parallel.py, the 'jnp' path of parallel/bpr_sharded.py:
   stock torch ops, as the reference computes them outside any Pallas
   kernel; bf16 tables scatter through bf16_row_add). After phase 29 (b),
   on phase 8's data: (a) billion_bpr_sharded with parallel.mode=single
   bpr.kernel=jnp (rank 64, batch 131,072, lr 0.05, reg 0.002), sampling
   on the card, 2 of its 5 epochs: the loss falls, epoch 1 (the sampler
   and the batch loop, one CUDA-graph replay a batch) under
   torch.cuda.set_sync_debug_mode('error'), epoch 0 again from a second
   trainer bit for bit; epoch s, peak memory, the sampled AUC and HR@10
   beside the untrained model's. On phase 29 (b)'s learnable cell at rank
   64: (b) bpr.neg_weighting=popularity with device sampling, 2 epochs:
   no drawn negative is a positive of its user, the loss falls; (c) the
   ring's 'jnp' path of one shard with device sampling, 2 epochs: the loss
   falls, the held-out sampled AUC ends above the untrained model's; (d)
   model.dtype=bfloat16 on (a)'s path, 2 epochs: bf16_row_add launched,
   the loss falls, and the kernel bit for bit its plain version on a
   batch's Q scatter at the positives (131,072 rows, rank 64). The
   host-sampled runs, on the learnable cell cut to 1/10 of its users and
   positives, from the CPU-seeded init, 2 epochs: (d) f32 and bf16, each
   epoch's loss within 1e-7 of the port's CPU run
   (tools/bpr_minibatch_check.py --cut 10); (b) parallel.mode=dp bit for
   bit (d)'s f32 run; (c) the 'jnp' ring with host sampling, gated as
   with device sampling. Phase 31's
   records are one JSON line ({"bpr_minibatch": ...}) before the total
   time.

Each phase prints its wall time. The second-to-last line is a JSON object
describing each kernel (times, launches on the main path, and the bound:
the least time the card could take for the same bytes and operations; for
the sweeps also the whole-sweep times on one block and on the card's
count; for dense_phase those of 256 strata and the times of group 0 and
of the epoch's dense phase, for dense_phase_int8_r128 those of the whole
group 0; for tile_topk every variant's times and the stock path's, whose
f32 depth-2 time is its library_ms, and phase 14's and phase 29(c)'s
launches and checks).
The rank-128 forms are entries of
their own (sgd_sweep_r128, dense_phase_int8_r128), their launches from
phase 12; sgd_sweep_time's launches are phase 16's and phase 30 (b)'s
(its "launches_by_path"), its check on timeSVD++'s path and phase 30's
records are its entry's "timesvdpp", and its rank-128 form, which no
path runs, is its entry's "r128"; sgd_sweep_epoch and
dense_phase_frozen (the frozen form at int4 and rank 64) take their
launches from phase 18's mode (a), and dense_phase_frozen's "variants"
hold the bias-free form and the frozen int8 instances; the rank-32 forms
(sgd_sweep_r32, sgd_sweep_time_r32, dense_phase_r32 (lane, int4; its
"variants" the int8 instances), dense_phase_frozen_r32,
dense_phase_none_r32) take their launches from phase 20's runs (a), (e),
(c), (b) and (d), and hold phase 19's checks at the ml25m_rank64 cell's
shapes as their "ml25m_cell"; the forms of phases 21-22 are entries of
their own (bpr_sweep_r32, bpr_sweep_r128, sgd_sweep_tile_r128,
sgd_sweep_tile_none_r128, sgd_sweep_epoch_r128, sgd_sweep_step_u_r128,
dense_phase_frozen_int8_r128, dense_phase_none_int8_r128), their
launches from phase 22's runs; tile_topk_deep (the deep form, phase
23) takes its launches from phase 23's serving path, its time and bound
from the serving path's shapes, the stock path's time as its library_ms,
and holds the 1M-item cases as its "variants"; bf16_row_add (phase 24)
takes its launches from the bf16 training-driver run and phase 31
(d)'s bf16 runs (its "launches_by_path"; the wrapper's outside a graph
capture, plus the launches a captured step holds times its replays,
counted by the step runners: kernels/packing.py GRAPH_LAUNCHES), its
plain_ms from the host CPU and its library_ms from index_put_, and holds
phase 31 (d)'s check at that path's shape among its "variants". The forms of phase 25 are entries of their own at rank 64
(sgd_sweep_bf16, sgd_sweep_tile_bf16, sgd_sweep_tile_none_bf16,
sgd_sweep_epoch_bf16, sgd_sweep_step_u_bf16, dense_phase_echo,
dense_phase_none_echo), their launches from phase 26's runs (c), (g),
(h), (f), (e), (a) and (i), with the rank-32 and rank-128 checks as their
"variants". The forms of phase 27 that phase 28 runs are entries of their
own (sgd_sweep_r16, sgd_sweep_tile_r16, _r8 and _r4,
sgd_sweep_step_u_r16, sgd_sweep_tile_bf16_r16, sgd_sweep_time_r16,
bpr_sweep_r16 and _r8; sgd_sweep_r2, sgd_sweep_tile_r2 and _r1,
sgd_sweep_step_u_r2, sgd_sweep_tile_bf16_r2, bpr_sweep_r2 and _r1),
their launches from runs (d), (a)-(c), (e), (f), (h) and (i), and (d2),
(a2), (a1), (e2), (f2) and (i); each holds the forms of its kernel that
no path runs as its "variants" (NARROW_ENTRIES). The BPR and netflix
phases' host data are made in processes of their own from the end of the
build (make_data); stderr repeats each line after the seconds since the
start. The script's
total seconds are printed before the card's line; the last is
{"ok": true, "device": {...}}. Any failure
exits non-zero with no such line, and so does a machine without a CUDA
device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

RMSE_GATE = 0.406  # the reference's quality gate on this synthetic
# ML-1M-shaped synthetic, 30 epochs: the reference trainer ends at 0.52532
# from an untrained 0.55114 (whole-star rounding sets a floor near 0.5)
ML1M_RMSE_GATE = 0.530
ML1M_BODIES_TOL = 1e-3  # final held-out RMSE, per tile vs step_user_batch
TOL = 1e-4
# the BPR cell: billion-implicit cut to 1/10 of BILLION_SHAPE, one shard
BPR_CUT = 10
# phase 8's printed HR/NDCG/MRR@10: the first held-out positives (of
# 100,000; a cut for the script's time)
BPR_RANK_POSITIVES = 10_000
# the card's published peaks (H100 SXM data sheet): HBM bytes/s and f32
# FLOP/s outside the tensor cores; every kernel here does f32 FMA
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SWEEP_TILES = 2048
DENSE_STRATA = 64
DENSE_WHOLE = 256  # strata of group 0 run on 1 block and on the card's count
DENSE_REPEATS = 10  # further runs of those strata on the card's count
NETFLIX_EPOCHS = 3  # of netflix100m_rank128_dp's 15: depth, cut for time
K = 10
# phase 13: the Java-parity synthetic and the reference's own tolerance
# (tests/parity/test_java_parity.py)
JAVA_SHAPE = (60, 80, 2_000)
JAVA_TOL = 5e-5
# ml100k_rank16, 30 epochs: the JAX trainer ends at 0.53151 and the port
# on the CPU at 0.53173 (each from its own seeded init)
ML100K_GATE = 0.533
PROFILE_BATCHES = 256  # phase 14's kernel breakdown
# phase 14's resumed run starts at this epoch of the 30 (from the
# checkpoint of the one before): the last 3, a cut for the script's time
ML100K_RESUME = 27
# phases 15-16: the temporal recipe of tests/unit/test_timesvd_blocked.py
# on TimeSVDConfig's 30 bins; the bin shift's spread
TIME_BINS, TIME_SHIFT = 30, 0.35
# phase 16's minibatch timeSVD run on the temporal ML-1M: 6 of
# TimeSVDConfig's 20 epochs, a cut for the script's time
JNP_TIME_EPOCHS = 6
# phase 16's blocked timeSVD path (and its lane-MF comparison): 6 of
# TimeSVDConfig's 20 epochs, a cut for the script's time
TIME_PATH_EPOCHS = 6


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on stdout; on stderr its head after the seconds since the
    script started (where a run's time goes)."""
    print(msg, flush=True)
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg[:120]}",
          file=sys.stderr, flush=True)


# host data of the BPR and netflix phases: numpy on the host takes minutes
# for each, so each is made, split and saved from the end of the build in a
# process of its own (make_data), and its phase loads it (wait_data)
DATA_JOBS = ("bpr", "netflix")
_CHILDREN: list = []


def make_data(kind: str, out: str) -> None:
    """The train and test splits of ``kind``'s seeded synthetic, as its
    phase would make them, saved under ``out`` (in a child process)."""
    from pathlib import Path

    from mfx_torch.config import preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import (BILLION_SHAPE, NETFLIX_SHAPE,
                                          make_implicit_synthetic,
                                          make_synthetic)

    t0 = time.perf_counter()
    out = Path(out)
    if kind == "bpr":  # billion-implicit cut to 1/BPR_CUT
        data = preset("billion_bpr_sharded").data
        split = (data.test_frac, data.seed)
        coo = make_implicit_synthetic(*(x // BPR_CUT for x in BILLION_SHAPE),
                                      rank=64, seed=104)
    else:  # the netflix entry of mfx_torch/data/loaders.py
        from mfx_torch.data.loaders import GENERATOR_VERSION

        data = preset("netflix100m_rank128_dp").data
        split = (data.test_frac, data.seed)
        coo = make_synthetic(*NETFLIX_SHAPE, rank=128, seed=103,
                             star_step=1.0, user_zipf_s=0.6)
        # phase 29(a)'s driver reads it as the loader's cache
        root = out.parent / "chip_smoke_root_netflix"
        root.mkdir(parents=True, exist_ok=True)
        coo.save_npz(root / f"netflix.v{GENERATOR_VERSION}.synthetic.npz")
    train, test = train_test_split(coo, split[0], seed=split[1])
    train.save_npz(out / "train.npz")
    test.save_npz(out / "test.npz")
    (out / "seconds").write_text(f"{time.perf_counter() - t0:.1f}")


def start_data() -> None:
    """Starts a make_data process for each of DATA_JOBS."""
    import shutil
    from pathlib import Path

    here = Path(__file__).resolve().parent
    shutil.rmtree(here / "build" / "chip_smoke_root_netflix",
                  ignore_errors=True)
    for kind in DATA_JOBS:
        out = here / "build" / f"chip_smoke_data_{kind}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        _CHILDREN.append((kind, out, subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.make_data(sys.argv[1], sys.argv[2])", kind,
             str(out)], cwd=here, stderr=subprocess.PIPE, text=True)))


def wait_data(kind: str):
    """``kind``'s (train, test), once its process has made them; the
    files are removed."""
    import shutil

    from mfx_torch.data.coo import RatingsCOO

    t0 = time.perf_counter()
    _, out, proc = next(c for c in _CHILDREN if c[0] == kind)
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"making the {kind} data failed:\n"
                             f"{err[-3000:]}")
    train = RatingsCOO.load_npz(out / "train.npz")
    test = RatingsCOO.load_npz(out / "test.npz")
    made = (out / "seconds").read_text()
    shutil.rmtree(out)
    log(f"[data] {kind}: made and split in {made} s in a process of its "
        f"own from the end of the build; waited for and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    return train, test


def stop_children() -> None:
    for _, _, proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def cuda_ms(fn, reps: int = 1) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what sets it): the least time for ``nbytes`` of device memory
    traffic and ``flops`` f32 operations at the card's peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sweep_bound(tl, sa, tc, su, si, tpg, rank, row_sides, flops_per_slot,
                bias=None, slot_ops=None, slot_bytes=0):
    """Bound of a sparse sweep: the tile stream and ids read once, and every
    distinct table row its real slots touch read once and written once.
    ``row_sides`` lists (table, tile row) pairs: 'P' rows come from tile
    row 0 and the user block, 'Q' rows from the given row and the window.
    A real slot does ``flops_per_slot`` operations a lane, or ``slot_ops``
    in all where that is given.
    ``bias='update'`` (the tile form): each of those rows also has a
    4-byte bias, read once and written once, and a real slot does 6 more
    operations (two adds into the prediction, two bias deltas of two
    each). ``bias='read'`` (the epoch form): the bias is read once and
    never written, and a real slot does 2 more operations (bu + bi, and
    its add into the prediction). ``slot_bytes``: each slot of the stream
    also writes that many bytes (the epoch form's residual)."""
    import torch

    real = tl[:, 0, :] < su
    t_of = torch.arange(tl.shape[0], device=tl.device)[:, None].expand_as(real)
    rows = {"P": [], "Q": []}
    for table, r in row_sides:
        if table == "P":
            ids = sa.long()[t_of // tpg] * su + tl[:, 0, :].long()
        else:
            ids = tc.long()[t_of] * si + tl[:, r, :].long()
        rows[table].append(ids[real])
    n_rows = sum(int(torch.unique(torch.cat(v)).numel())
                 for v in rows.values() if v)
    bias_bytes, bias_ops = {None: (0, 0), "update": (8, 6),
                            "read": (4, 2)}[bias]
    nbytes = ((tl.numel() + sa.numel() + tc.numel()) * 4
              + n_rows * (2 * rank * 4 + bias_bytes)
              + slot_bytes * tl.shape[0] * tl.shape[2])
    if slot_ops is None:
        slot_ops = flops_per_slot * rank + bias_ops
    return bound(nbytes, slot_ops * int(real.sum()))


def time_slot_ops(rank, n_bins):
    """Operations a real slot of the time form needs, with L = rank - 3 -
    n_bins factor lanes: the prediction, 2 for each of the L factor lanes
    and of its four scalar terms (bu, bi, bt at the slot's bin, alpha *
    dev); then 4 for each lane the step updates (P: L, alpha, bu; Q: L, the
    n_bins bt, bi). Lanes that hold constants or injections add nothing."""
    L = rank - 3 - n_bins
    return 2 * (L + 4) + 4 * (L + 2) + 4 * (L + n_bins + 1)


def ulps(t) -> float:
    """The spacing of float32 values at the largest magnitude in ``t``."""
    import torch

    m = t.abs().max().float()
    return float(torch.nextafter(m, torch.full_like(m, float("inf"))) - m)


def sums_limit(plain, terms) -> float:
    """How far a kernel's sums of ``terms`` terms each, added in another
    order, may lie from ``plain``'s: sqrt(terms) ulps of the largest (the
    spread of a reordered sum's rounding), at most TOL."""
    return min(TOL, math.sqrt(terms) * ulps(plain))


def compare(name, run_kernel, run_plain, state, tol=TOL, sums=(),
            sse_tol=None, control=None):
    """Kernel twice from the same state (bitwise equal), plain once, within
    ``tol`` of it (the scalar within ``sse_tol``, default ``tol``, of
    plain's, relative above 1). ``control``: another kernel run from the
    same state that must land farther than ``tol`` from plain (a form the
    check must tell apart). The last len(``sums``) entries of ``state``
    are sums of ``sums[k]`` terms each (the frozen dense form's row and column sums of
    E, added in another order than plain's): each within sqrt(terms) ulps
    of its largest magnitude (the spread of a reordered sum's rounding)
    and within TOL. Returns (max_abs_err over every entry, kernel ms,
    plain ms); the plain version runs once, and its time is that run's."""
    import torch

    outs = []
    for _ in range(2):
        tabs = [t.clone() for t in state]
        sse = run_kernel(*tabs)
        torch.cuda.synchronize()
        outs.append((tabs, float(sse)))
    (k1, s1), (k2, s2) = outs
    if s1 != s2 or any(not torch.equal(a, b) for a, b in zip(k1, k2)):
        raise AssertionError(f"{name}: two kernel runs differ")
    tabs = [t.clone() for t in state]
    first_ms = cuda_ms(lambda: outs.append(run_plain(*tabs)))
    sse_p = float(outs[-1])
    errs = [float((a - b).abs().max()) for a, b in zip(k1, tabs)]
    n = len(errs) - len(sums)
    spacing = [ulps(b) for b in tabs[n:]]
    limits = [sums_limit(b, t) for b, t in zip(tabs[n:], sums)]
    if not all(bool(torch.isfinite(t).all()) for t in k1):
        raise AssertionError(f"{name}: non-finite tables")
    sse_tol = tol if sse_tol is None else sse_tol
    if (max(errs[:n]) > tol or any(e > x for e, x in zip(errs[n:], limits))
            or abs(s1 - sse_p) > sse_tol * max(1.0, abs(sse_p))):
        raise AssertionError(
            f"{name}: max abs err {errs} (sse {s1} vs {sse_p}) above {tol} "
            f"(the last {len(sums)} above {limits})")
    tabs = [t.clone() for t in state]
    ms = cuda_ms(lambda: run_kernel(*tabs), reps=3)
    plain_ms = first_ms
    held = f"tol {tol}"
    if control is not None:
        ctl = [t.clone() for t in state]
        control(*ctl)
        c_err = max(float((a - b).abs().max()) for a, b in zip(ctl, tabs))
        if not c_err > tol:
            raise AssertionError(f"{name}: the control run is {c_err} from "
                                 f"plain, not above {tol}")
        held += f"; control {c_err:.3e} from plain"
    if sums:
        held = f"tables {max(errs[:n]):.3e} ({held}), sums " + ", ".join(
            f"{e:.3e} = {e / x:g} ulps of {x:.3e} (limit {lim:.3e})"
            for e, x, lim in zip(errs[n:], spacing, limits))
    log(f"[kernel] {name}: max_abs_err={max(errs):.3e} ({held}) sse={s1} "
        f"plain_sse={sse_p} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return max(errs), ms, plain_ms


def whole_sweep(name, run, state, deps, max_blocks, grid=None,
                unit="tiles"):
    """``run(*tables, blocks)`` over a whole sweep (or dense strata) from
    ``state``, once on one block and then twice on as many as the card
    holds: tables and scalar must be bitwise equal between the three runs.
    Returns the times, the blocks launched, the sweep's tiles (strata) and
    its critical path. ``grid``: the blocks the wrapper launches at the
    card's count (default: one a run, at most ``max_blocks``)."""
    import torch

    outs = []
    for blocks in (1, None, None):
        tabs = [t.clone() for t in state]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        scalar = run(*tabs, blocks)
        end.record()
        end.synchronize()
        outs.append((tabs, float(scalar), start.elapsed_time(end)))
    first = outs[0]
    for k, (tabs, s, _) in enumerate(outs[1:], 1):
        if s != first[1] or any(not torch.equal(a, b)
                                for a, b in zip(tabs, first[0])):
            raise AssertionError(
                f"{name}: run {k} (the card's grid) differs from the "
                f"one-block run ({s} vs {first[1]})")
    if not all(bool(torch.isfinite(t).all()) for t in outs[-1][0]):
        raise AssertionError(f"{name}: non-finite tables")
    ms_one, ms_many, ms_again = (o[2] for o in outs)
    if grid is None:
        grid = min(max_blocks, deps.runs.shape[0])
    log(f"[kernel] {name} whole: {deps.n_tiles} {unit} in "
        f"{deps.runs.shape[0]} runs, critical path {deps.critical} {unit} "
        f"(x{deps.n_tiles / deps.critical:.2f} at most); 1 block "
        f"{ms_one:.4f} ms, {grid} blocks {ms_many:.4f} and {ms_again:.4f} ms "
        f"(x{ms_one / ms_many:.2f}); tables and scalar bitwise equal across "
        f"the three runs (scalar {outs[-1][1]})")
    return {"sweep_tiles": deps.n_tiles,
            "sweep_critical_tiles": deps.critical, "sweep_blocks": grid,
            "sweep_ms_1_block": ms_one, "sweep_ms": ms_many,
            "sweep_ms_again": ms_again}


def dense_bound(groups, su, si, rank, frozen=False, echo=1):
    """Bound of the dense phase over ``groups``: every group tensor read
    once, each distinct P block and Q window of a group read and written
    once, and three (su x si x rank) products a stratum, ``echo`` times
    (each pass's operations, the codes read once). ``frozen``: the
    frozen-bias form also reads a bias a row of each block and window,
    writes a row and a column sum a stratum, and does about 4 more
    operations a cell (two bias subtractions, two sums)."""
    nbytes = flops = 0.0
    for grp in groups:
        nd = grp["sa"].shape[0]
        nbytes += sum(grp[k].numel() * grp[k].element_size()
                      for k in ("sa", "sc", "R", "du_s", "di_s"))
        rows = (grp["sa"].unique().numel() * su
                + grp["sc"].unique().numel() * si)
        nbytes += 2 * rank * 4 * rows
        flops += 6.0 * su * si * rank * nd * echo
        if frozen:
            nbytes += 4 * rows + 4 * nd * (su + si)
            flops += 4.0 * su * si * nd
    return bound(nbytes, flops)


def _true_scores(P_aug, Q_aug, sb, rows, items):
    """f64 scores of (row, item) pairs of the augmented tables."""
    s = (P_aug[rows].double() * Q_aug[items].double()).sum(1)
    if sb is not None:
        flat = sb.transpose(0, 1).reshape(2, -1).double()
        s = s * flat[0, items] + flat[1, items]
    return s


def hold_topk(what, got, P_aug, Q_aug, sb, tile, depth):
    """Holds tile_topk's result ``got`` against its plain version on the
    same inputs: every value within TOL, and a lane that differs only
    where the two lanes' true scores tie within TOL. Returns (max abs
    err, lane swaps, their largest score gap)."""
    import torch

    from mfx_torch.kernels.serve_topk import tile_topk_plain

    want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)
    err, swaps, swap_gap = 0.0, 0, 0.0
    for j in range(0, 2 * depth, 2):
        (m_k, a_k), (m_p, a_p) = got[j:j + 2], want[j:j + 2]
        if not bool(torch.isfinite(m_k).all()):
            raise AssertionError(f"{what}: non-finite values")
        err = max(err, float((m_k - m_p).abs().max()))
        bad = a_k != a_p
        if bool(bad.any()):
            b, t = bad.nonzero(as_tuple=True)
            base = t * tile
            gap = (_true_scores(P_aug, Q_aug, sb, b, base + a_k[bad])
                   - _true_scores(P_aug, Q_aug, sb, b, base + a_p[bad]))
            swaps += int(bad.sum())
            swap_gap = max(swap_gap, float(gap.abs().max()))
    if err > TOL or swap_gap > TOL:
        raise AssertionError(
            f"{what} depth {depth}: max abs err {err}, lane swaps {swaps} "
            f"with score gap {swap_gap} (tol {TOL})")
    return err, swaps, swap_gap


def topk_phase(dev):
    """Phase 5: tile_topk against its plain version at the serving shape;
    returns ((max abs err over the variants, f32 depth-2 ms, its plain
    ms), the f32 depth-2 bound, each variant's record)."""
    import torch

    from mfx_torch.kernels.serve_topk import (aug_width, tile_topk,
                                              tile_topk_plain)
    from mfx_torch.measure_topk import (PHASE5_VARIANTS, RANK, SERVE_B,
                                        SERVE_ITEMS, SERVE_TILE,
                                        serving_tables, stock_topk)

    rank, tile = RANK, SERVE_TILE
    log(f"[kernel] tile_topk: {SERVE_ITEMS} items, rank {rank}, B {SERVE_B}, "
        f"tile {tile}, augmented width {aug_width(rank)}")
    worst, head, variants = 0.0, None, []
    for dtype, depth in PHASE5_VARIANTS:
        P_aug, Q_aug, sb = serving_tables(dev, SERVE_B, SERVE_ITEMS, dtype)

        def run():
            return tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)

        def stock():  # the yardstick: two PyTorch calls (three for int8)
            return stock_topk(P_aug, Q_aug, sb, tile, depth)

        outs = [run(), run()]
        torch.cuda.synchronize()
        if any(not torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"tile_topk {dtype}: two kernel runs differ")
        err, swaps, swap_gap = hold_topk(f"tile_topk {dtype}", outs[0], P_aug,
                                         Q_aug, sb, tile, depth)
        ms = cuda_ms(run, reps=5)
        plain_ms = cuda_ms(lambda: tile_topk_plain(P_aug, Q_aug, tile=tile,
                                                   depth=depth, sb=sb))
        stock()  # warm-up
        stock_ms = cuda_ms(stock, reps=5)
        log(f"[kernel] tile_topk {dtype} depth {depth}: max_abs_err={err:.3e} "
            f"(tol {TOL}) lane swaps {swaps} (near-ties, gap <= "
            f"{swap_gap:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"stock_ms={stock_ms:.4f}")
        variants.append({"dtype": dtype, "depth": depth, "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms,
                         "stock_ms": stock_ms})
        worst = max(worst, err)
        if head is None:
            # f32 FMA over the rank + 1 lanes that carry a value (the
            # augmented width's zero lanes and the pad items not counted)
            # for every (row, item) pair; the tables read once, each
            # tile's depth (value, lane) written
            out_bytes = sum(x.numel() * x.element_size() for x in outs[0])
            head = (ms, plain_ms, bound(
                P_aug.numel() * P_aug.element_size()
                + Q_aug.numel() * Q_aug.element_size() + out_bytes,
                2.0 * SERVE_B * SERVE_ITEMS * (rank + 1)))
            log(f"[kernel] tile_topk f32 depth {depth} bound "
                f"{head[2][0]:.4f} ms ({head[2][1]})")
        del outs, Q_aug, P_aug, sb
        torch.cuda.empty_cache()
    return (worst, head[0], head[1]), head[2], variants


def _post(port, path, body=None):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        raw = r.read()
    return raw.decode() if path == "/metrics" else json.loads(raw)


def _batch_ms(rec, users):
    t0 = time.perf_counter()
    rec.recommend(users, k=K)
    n = -(-len(users) // rec.batch)
    return (time.perf_counter() - t0) * 1e3 / n


def serve_phase(model, train, dev, seed):
    """Phase 6: the trained model through a checkpoint, the recommenders,
    the HTTP server and the CLI. Returns tile_topk's launches."""
    import tempfile
    import threading
    from pathlib import Path

    import numpy as np
    import torch

    from mfx_torch.kernels.serve_topk import tile_topk
    from mfx_torch.serve import (FusedTopKRecommender, TopKRecommender,
                                 recommend_cold, similar_items_fused)
    from mfx_torch.serve.server import RecServer
    from mfx_torch.train.checkpoint import load_checkpoint, save_checkpoint

    tile_topk.launches = 0
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as ckdir:
        t0 = time.perf_counter()
        save_checkpoint(ckdir, 1, model, seed=seed)
        served, epoch, _ = load_checkpoint(ckdir, device=dev)
        same = all(torch.equal(getattr(served, k), getattr(model, k))
                   for k in ("P", "Q", "bu", "bi"))
        if not same or np.float32(served.mu) != np.float32(model.mu):
            raise AssertionError("checkpoint round trip is not bitwise")
        log(f"[serve] checkpoint saved and loaded bitwise in "
            f"{time.perf_counter() - t0:.2f} s (epoch {epoch})")

        t0 = time.perf_counter()
        stock = TopKRecommender(served, train=train, device=dev)
        approx = FusedTopKRecommender(served, train=train, device=dev)
        exact = FusedTopKRecommender(served, train=train, exact=True,
                                     exact_tiles=16, device=dev)
        log(f"[serve] recommenders built in {time.perf_counter() - t0:.2f} s")

        counts = np.bincount(train.user, minlength=served.num_users)
        p99 = float(np.percentile(counts[counts > 0], 99))
        rng = np.random.default_rng(seed)
        light = rng.choice(np.flatnonzero((counts > 0) & (counts <= p99)),
                           4096, replace=False).astype(np.int32)
        heavy = np.argsort(counts, kind="stable")[-256:].astype(np.int32)
        log(f"[serve] users: 4096 drawn with 1..{p99:g} training ratings "
            f"(the 99th percentile; drawn max {counts[light].max()}), and "
            f"the 256 heaviest ({counts[heavy].min()}..{counts[heavy].max()})"
            " for stock and exact")

        both = np.concatenate([light, heavy])
        si, ss = stock.recommend(both, k=K)
        ei, es = exact.recommend(both, k=K)
        diff = ei != si
        gap = np.abs(es - ss)
        if not np.all(gap <= TOL) or not np.all(np.isfinite(es)):
            raise AssertionError(f"exact != stock: score gap {gap.max()}")
        log(f"[serve] exact == stock on {len(both)} users: {int(diff.sum())} "
            f"item swaps, all near-ties (score gap <= {gap.max():.3e}); "
            f"exact_fallbacks {exact.exact_fallbacks} of "
            f"{-(-len(both) // exact.batch)} batches")

        ai, as_ = approx.recommend(light, k=K)
        csr = stock._seen
        u_t = torch.as_tensor(light, device=dev).long()[:, None]
        i_t = torch.as_tensor(ai, device=dev).long()
        true = (served.mu + served.bu[u_t] + served.bi[i_t]
                + (served.P[u_t] * served.Q[i_t]).sum(-1)).double()
        err = float((true - torch.as_tensor(as_, device=dev)).abs().max())
        seen_hit = sum(np.isin(ai[b], csr.items[csr.offsets[u]:
                                                 csr.offsets[u + 1]]).any()
                       for b, u in enumerate(light))
        if (seen_hit or (ai >= served.num_items).any() or err > TOL
                or (np.diff(as_, axis=1) > 0).any()):
            raise AssertionError(
                f"fused contract broken: {seen_hit} users served seen items, "
                f"score error {err}")
        recall = np.mean([len(set(ai[b]) & set(si[b])) / K
                          for b in range(len(light))])
        log(f"[serve] fused (approximate) contract holds on {len(light)} "
            f"users: no seen or pad items, scores within {err:.3e} of the "
            f"true scores, sorted; recall@{K} against stock {recall:.4f}")
        # the approximate path can miss only where > 2 of a user's true
        # top-K share a tile
        tiles = si[:len(light)] // approx.tile
        crowded = np.mean([np.bincount(t).max() > 2 for t in tiles])
        log(f"[serve] stock top-{K} of those users: {(tiles == 0).mean():.4f} "
            f"of the items in tile 0, {crowded:.4f} of the users with more "
            "than 2 in one tile")
        log(f"[serve] ms per batch of {stock.batch} (host clock, warm): "
            f"stock {_batch_ms(stock, light):.3f}, fused "
            f"{_batch_ms(approx, light):.3f}, exact "
            f"{_batch_ms(exact, light):.3f}")

        srv = RecServer(
            approx,
            similar=lambda q, k: similar_items_fused(served, q, k=k,
                                                     device=dev),
            cold=lambda hs, k: recommend_cold(served, hs, k=k),
            host="127.0.0.1", port=0)
        srv.start()
        try:
            bodies = [{"users": light[:3].tolist(), "k": K},
                      {"users": light[3:5].tolist(), "k": K}]
            answers = [None, None]

            def post(n):
                answers[n] = _post(srv.port, "/recommend", bodies[n])

            threads = [threading.Thread(target=post, args=(n,))
                       for n in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for body, ans in zip(bodies, answers):
                items, scores = approx.recommend(body["users"], k=K)
                if (ans is None or ans["items"] != items.tolist()
                        or ans["scores"] != scores.tolist()):
                    raise AssertionError("/recommend != a direct call")
            q = [0, 1, 500]
            sim = _post(srv.port, "/similar", {"items": q, "k": K})
            want = similar_items_fused(served, q, k=K, device=dev)
            if sim["similar"] != want[0].tolist():
                raise AssertionError("/similar != a direct call")
            hist = [[[0, 5.0], [3, 4.0], [70, 1.0]], [[12, 3.5]]]
            cold = _post(srv.port, "/recommend_cold",
                         {"histories": hist, "k": K})
            want = recommend_cold(
                served, [(np.array([p[0] for p in h], np.int32),
                          np.array([p[1] for p in h], np.float32))
                         for h in hist], k=K)
            if cold["items"] != want[0].tolist():
                raise AssertionError("/recommend_cold != a direct call")
            health = _post(srv.port, "/healthz")
            metrics = _post(srv.port, "/metrics")
            if 'path="/recommend",code="200"} 2' not in metrics:
                raise AssertionError("/metrics did not count the requests")
        finally:
            srv.stop()
        log(f"[serve] HTTP: /recommend x2 (concurrent), /similar, "
            f"/recommend_cold, /healthz ({health['recommender']}), /metrics "
            "all 200 and equal to direct calls")

        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "mfx_torch.cli", "recommend",
             "--checkpoint", ckdir, "--users", "0,1,2", "--fused",
             "--device", "cuda"],
            capture_output=True, text=True, timeout=300)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or len(lines) != 3 or any(
                len(json.loads(x)["items"]) != K for x in lines):
            raise AssertionError(f"CLI recommend failed:\n{res.stderr[-2000:]}")
        log(f"[serve] CLI recommend --fused --device cuda: 3 users in "
            f"{time.perf_counter() - t0:.1f} s (process included)")
    launches = tile_topk.launches
    log(f"[serve] launches {{'tile_topk': {launches}}}")
    if launches < 1:
        raise AssertionError("tile_topk never launched on the serving path")
    return launches


def bpr_form_check(name, st, bpr, seed, results, bounds, sweeps,
                   tiles=SWEEP_TILES, whole_tiles=None):
    """bpr_sweep at the ring state ``st``'s rank against its plain version
    on the first ``tiles`` tiles of segment 0 of epoch 0 from its tables
    (within TOL, two kernel runs bitwise), the same tiles on one block in
    plan order, then the whole of segment 0 (its first ``whole_tiles``
    tiles, if given) once on one block and twice on as many as the card
    holds (bitwise). Fills ``results``, ``bounds`` and ``sweeps`` under
    ``name``."""
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.bpr_sweep import bpr_sweep, bpr_sweep_plain
    from mfx_torch.parallel import bpr_sharded as ring
    from mfx_torch.solvers.blocked import TPG

    rank = st.P.shape[1]
    tls = ring.ring_epoch_tiles(st, bpr, seed, 0)
    win0, nw, sa_all, tc_all, deps_all = st.segments()[0]
    nt = min(tiles, tls[0].shape[2])
    tl = tls[0][0, 0, :nt].contiguous()
    sa, tc = sa_all[:nt // TPG].contiguous(), tc_all[:nt].contiguous()
    deps = deps_all.prefix(nt)
    si = bpr.iblock
    seg = slice(win0 * si, (win0 + nw) * si)
    log(f"[kernel] {name}: {nt} tiles of segment 0 ({len(tls)} segments "
        f"of {[x.shape[2] for x in tls]} tiles; T={bpr.tile}, rank {rank}); "
        f"they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    kw = dict(su=bpr.ublock, si=si, tpg=TPG)
    results[name] = compare(
        name,
        lambda Pt, Qt: bpr_sweep(Pt, Qt[seg], sa, tc, tl, bpr.lr, bpr.reg,
                                 deps=deps, **kw),
        lambda Pt, Qt: bpr_sweep_plain(Pt, Qt[seg], sa, tc, tl, bpr.lr,
                                       bpr.reg, **kw),
        (st.P, st.Q),
    )
    # per real slot: q_i - q_j (rank), the dot (2 rank), three deltas
    # (4 rank each) and three row adds (rank each)
    bounds[name] = sweep_bound(tl, sa, tc, bpr.ublock, si, TPG, rank,
                               [("P", 0), ("Q", 1), ("Q", 2)], 18)
    log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
        f"({bounds[name][1]})")
    Pt, Qt = st.P.clone(), st.Q.clone()
    ms_one = cuda_ms(lambda: bpr_sweep(Pt, Qt[seg], sa, tc, tl, bpr.lr,
                                       bpr.reg, **kw), reps=3)
    log(f"[kernel] {name}: the same {nt} tiles on one block in plan "
        f"order (no dependency table) {ms_one:.4f} ms")
    del Pt, Qt
    # the whole of segment 0 (or its head), on one block and on the card's
    # count
    whole = tls[0][0, 0]
    if whole_tiles is not None and whole_tiles < whole.shape[0]:
        whole = whole[:whole_tiles].contiguous()
        sa_all = sa_all[:whole_tiles // TPG].contiguous()
        tc_all = tc_all[:whole_tiles].contiguous()
        deps_all = deps_all.prefix(whole_tiles)
    sweeps[name] = whole_sweep(
        name,
        lambda Pt, Qt, blocks: bpr_sweep(Pt, Qt[seg], sa_all, tc_all, whole,
                                         bpr.lr, bpr.reg, deps=deps_all,
                                         blocks=blocks, **kw),
        (st.P, st.Q), deps_all,
        _build.load_library().mfx_bpr_sweep_max_blocks(bpr.tile, rank))
    sweeps[name]["tiles"] = nt
    sweeps[name]["critical_tiles"] = deps.critical


def bpr_phases(dev, results, bounds, sweeps, forms, learn):
    """Phases 7 and 8: bpr_sweep against its plain version at the BPR
    cell's shapes and on a whole segment, then the BPR path's 5 epochs;
    and the BPR parts of phases 21 and 22 on the same data: the same
    checks and the path at ranks 32 and 128. Fills ``results``,
    ``bounds`` and ``sweeps`` for bpr_sweep, bpr_sweep_r32 and
    bpr_sweep_r128; returns their launches on the path. Then the BPR parts
    of phases 27 and 28: ranks 16 to 1 against plain on NARROW_TILES tiles
    and segment 0 (once on one block, twice on the card's count), into
    ``forms``; the path at ranks 16, 8, 2 and 1, their launches returned
    too. Then phase 31 on the same data and on ``learn``, phase 29 (b)'s
    learnable cell; its bf16_row_add launches and the kernel's check at its
    shape are returned as ``bf16_row_add_mb``."""
    import math

    import numpy as np
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.bpr import build_positive_index
    from mfx_torch.data.synthetic import BILLION_SHAPE
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.eval.ranking import hr_ndcg_at_k
    from mfx_torch.kernels.bpr_sweep import bpr_sweep
    from mfx_torch.models.mf import init_model
    from mfx_torch.parallel import bpr_sharded as ring

    cfg = apply_overrides(preset("billion_bpr_sharded"),
                          ["parallel.model_axis=1"])
    bpr, seed = cfg.bpr, cfg.data.seed
    shape = tuple(x // BPR_CUT for x in BILLION_SHAPE)
    log(f"[bpr] cell: billion_bpr_sharded with parallel.model_axis=1 (1 "
        f"shard instead of {preset('billion_bpr_sharded').parallel.model_axis}"
        f"); billion-implicit cut to 1/{BPR_CUT} of BILLION_SHAPE "
        f"{BILLION_SHAPE}: {shape[0]} users x {shape[1]} items x {shape[2]} "
        f"positives; widths unchanged (rank {cfg.model.rank}, su = si = "
        f"{bpr.ublock}, T = {bpr.tile})")
    train, test = wait_data("bpr")  # make_data: seed 104, as before
    log(f"[data] {train.num_users} x {train.num_items}, {train.n_ratings} "
        f"train / {test.n_ratings} test positives")
    U, I, rank = train.num_users, train.num_items, cfg.model.rank

    def fresh_model(rk=rank):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rk, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale)

    # 7. bpr_sweep against its plain version: the first tiles of segment
    # 0 of epoch 0, from the untrained tables; then (phase 21) the same at
    # ranks 32 and 128 on the same data
    t_phase = time.perf_counter()
    for rk in (rank, 32, 128):
        bpr_form_check("bpr_sweep" if rk == rank else f"bpr_sweep_r{rk}",
                       ring.ring_state(fresh_model(rk), train, bpr, seed=seed,
                                       device=dev), bpr, seed,
                       results, bounds, sweeps)
        torch.cuda.empty_cache()
        if rk == rank:
            log(f"[time] phase 7 {time.perf_counter() - t_phase:.1f} s")
            t_phase = time.perf_counter()
    log(f"[time] phase 21 (bpr_sweep at ranks 32 and 128) "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 8. the BPR path, through the kernel
    t_phase = time.perf_counter()
    keys = np.concatenate([build_positive_index(train),
                           build_positive_index(test)])
    keys.sort()
    model = fresh_model()
    auc0 = sampled_auc(model, test, seed=seed, pos_keys=keys)
    log(f"[bpr] untrained held-out sampled AUC {auc0:.5f} "
        f"({test.n_ratings} positives; keys built in "
        f"{time.perf_counter() - t_phase:.1f} s)")
    bpr_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    losses, auc = [], None
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for epoch, m, loss in ring.train_epochs_bpr_ring(
            model, train, bpr, shards=1, seed=seed, device=dev,
            timings=timings):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prev
        if epoch == 0:
            log(f"[bpr] prep {timings['prep_s']:.3f} s (positive index, "
                "window bounds, plan skeleton); (tiles, critical path) of "
                f"each segment {timings['segment_tiles']}")
            wall -= timings["prep_s"]
        t_eval = time.perf_counter()
        auc = sampled_auc(m, test, seed=seed, pos_keys=keys)
        losses.append(loss)
        log(f"[bpr] epoch {epoch}: epoch_s {wall:.4f} (negatives "
            f"{timings['neg_s']:.4f}, plan {timings['plan_s']:.4f}, sweeps "
            f"{wall - timings['neg_s'] - timings['plan_s']:.4f}) mean_loss "
            f"{loss:.6f} test_auc {auc:.5f} (eval "
            f"{time.perf_counter() - t_eval:.1f} s)")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q"))
        if not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank):
            raise AssertionError("BPR tables not finite or mis-shaped")
        t_prev = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = bpr_sweep.launches
    # held-out positives whose (user, item) pair also occurs in training
    tk = build_positive_index(train)
    q = test.user.astype(np.int64) * I + test.item
    dup = tk[np.minimum(np.searchsorted(tk, q), len(tk) - 1)] == q
    new = test.select(np.flatnonzero(~dup))
    log(f"[bpr] {dup.mean():.5f} of the held-out positives also occur in "
        f"training; AUC over the others: untrained "
        f"{sampled_auc(model, new, seed=seed, pos_keys=keys):.5f}, final "
        f"{sampled_auc(m, new, seed=seed, pos_keys=keys):.5f}")
    t_eval = time.perf_counter()
    ranked = test.select(np.arange(min(BPR_RANK_POSITIVES, test.n_ratings)))
    rk = hr_ndcg_at_k(m, ranked, k=cfg.ranking_k, seed=seed, pos_keys=keys)
    log(f"[bpr] test " + " ".join(f"{n}@{cfg.ranking_k} {v:.5f}"
                                   for n, v in rk.items())
        + f" (sampled protocol, 100 negatives, the first "
        f"{ranked.n_ratings} held-out positives; "
        f"{time.perf_counter() - t_eval:.1f} s)")
    log(f"[bpr] launches {{'bpr_sweep': {launches}}}, peak memory allocated "
        f"{peak} bytes")
    if launches < 1:
        raise AssertionError("bpr_sweep never launched on the BPR path")
    if len(losses) != bpr.epochs or any(
            b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the BPR loss did not fall every epoch: "
                             f"{losses}")
    if not losses[-1] < math.log(2):
        raise AssertionError(f"final BPR loss {losses[-1]} not below ln 2")
    # a smoke check, not a quality gate: on this synthetic the final AUC
    # sits within about one standard error of the untrained model's
    if not auc > auc0:
        raise AssertionError(f"AUC {auc} not above the untrained {auc0}")
    log(f"[bpr] AUC smoke check (not a quality gate): final {auc:.5f} > "
        f"untrained {auc0:.5f}")
    log(f"[time] phase 8 {time.perf_counter() - t_phase:.1f} s")

    # 22 (BPR). the path at ranks 32 and 128, the preset otherwise as above
    t_phase = time.perf_counter()
    out = {"bpr_sweep": launches}
    for rk in (32, 128):
        out[f"bpr_sweep_r{rk}"] = bpr_rank_run(
            dev, fresh_model(rk), train, test, bpr, seed, keys)
    log(f"[time] phase 22 (the BPR path at ranks 32 and 128) "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 27-28 (BPR). ranks 16 to 1 against plain; the path at 16, 8, 2 and 1
    t_phase = time.perf_counter()
    checks = ({}, {}, {})
    for rk in NARROW_RANKS:
        name = f"bpr_sweep_r{rk}"
        bpr_form_check(name, ring.ring_state(fresh_model(rk), train, bpr,
                                             seed=seed, device=dev),
                       bpr, seed, *checks, tiles=NARROW_TILES,
                       whole_tiles=NARROW_BPR_WHOLE)
        forms[name] = tuple(c[name] for c in checks)
        torch.cuda.empty_cache()
    narrow_time("27", t_phase, "bpr_sweep at ranks 16 to 1")
    t_phase = time.perf_counter()
    for rk in NARROW_PATH_BPR:
        out[f"bpr_sweep_r{rk}"] = bpr_rank_run(
            dev, fresh_model(rk), train, test, bpr, seed, keys,
            auc_check=False, ln2_check=rk in NARROW_BPR_LN2)
    narrow_time("28", t_phase, "(i) the BPR path at ranks "
                + ", ".join(map(str, NARROW_PATH_BPR)))
    # 29 (b). iALS on the same data, at the preset's rank
    torch.cuda.empty_cache()
    GRAM["ials"] = ials_bpr_phase(dev, train, test, fresh_model(), keys)
    # 31. the snapshot-minibatch BPR trainers, on the same data and on the
    # learnable cell
    torch.cuda.empty_cache()
    out["bf16_row_add_mb"] = bpr_minibatch_phase(dev, train, test, keys,
                                                 auc0, fresh_model, learn)
    return out


def bpr_rank_run(dev, model, train, test, bpr, seed, keys, auc_check=True,
                 ln2_check=True):
    """Phase 22, the BPR part: train_epochs_bpr_ring from ``model`` (a
    rank other than the preset's) for the preset's epochs: bpr_sweep
    launched, the loss falls every epoch and ends below ln 2 (with
    ``ln2_check=False``, as phase 28 runs ranks 2 and 1, printed only),
    the sampled AUC ends above the untrained model's (a smoke check, as
    phase 8's; with ``auc_check=False``, as in phase 28, printed only).
    Returns bpr_sweep's launches."""
    import math

    import torch

    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.kernels.bpr_sweep import bpr_sweep
    from mfx_torch.parallel import bpr_sharded as ring

    tag = f"bpr r{model.rank}"
    auc0 = sampled_auc(model, test, seed=seed, pos_keys=keys)
    bpr_sweep.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    losses, walls = [], []
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for epoch, m, loss in ring.train_epochs_bpr_ring(
            model, train, bpr, shards=1, seed=seed, device=dev,
            timings=timings):
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t_prev
                     - (timings["prep_s"] if epoch == 0 else 0.0))
        losses.append(loss)
        if not all(bool(torch.isfinite(getattr(m, k)).all())
                   for k in ("P", "Q")):
            raise AssertionError(f"{tag}: tables not finite")
        t_prev = time.perf_counter()
    auc = sampled_auc(m, test, seed=seed, pos_keys=keys)
    launches = bpr_sweep.launches
    log(f"[{tag}] prep {timings['prep_s']:.3f} s; (tiles, critical path) of "
        f"each segment {timings['segment_tiles']}; epoch_s "
        + " ".join(f"{x:.4f}" for x in walls)
        + "; mean_loss " + " ".join(f"{x:.6f}" for x in losses)
        + f"; held-out sampled AUC {auc0:.5f} untrained, {auc:.5f} final; "
        f"launches {launches}, peak memory allocated "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    if launches < 1:
        raise AssertionError(f"{tag}: bpr_sweep never launched")
    if len(losses) != bpr.epochs or any(
            b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{tag}: the loss did not fall every epoch: "
                             f"{losses}")
    if not losses[-1] < math.log(2):
        if ln2_check:
            raise AssertionError(f"{tag}: final loss {losses[-1]} not below "
                                 "ln 2")
        log(f"[{tag}] the loss fell every epoch and ends at {losses[-1]!r}, "
            f"above ln 2 = {math.log(2)!r}")
    if auc_check and not auc > auc0:
        raise AssertionError(f"{tag}: AUC {auc} not above the untrained "
                             f"{auc0}")
    return launches


# phase 31: the snapshot-minibatch BPR trainers (solvers/bpr.py,
# parallel/data_parallel.py, parallel/bpr_sharded.py's 'jnp' ring)
BPR_MB_EPOCHS = 2  # of billion_bpr_sharded's 5: depth, cut for time
BPR_MB_CUT = 10  # the host-sampled runs' cell: the learnable cell's users
# and positives / 10, where the host sampler and the CPU runs are cheap
# tools/bpr_minibatch_check.py --cut 10 (the port's CPU run; the JAX
# trainer's f32 losses are the same to the last digit, its bf16 ones within
# 4.4e-7): each epoch's mean loss from the CPU-seeded init, host sampling
BPR_MB_CPU = {"float32": (0.696141351010101, 0.6726486111111111),
              "bfloat16": (0.6962630050505051, 0.6727754419191919)}
# of each epoch's loss: about one f32 ulp of the epoch's loss sum (6.9e5,
# ulp 0.0625) over its 990,000 positives, 6.3e-8; the card has read a
# difference of 0 at both dtypes in every run so far
BPR_MB_TOL = {"float32": 1e-7, "bfloat16": 1e-7}
BPR_MB: dict = {}  # phase 31's records, printed as one JSON line
_LEARN_CELL: dict = {}  # phase 31's positive keys and untrained AUC there


def _falls(what, losses):
    if any(b >= a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{what}: the loss did not fall every epoch: "
                             f"{losses}")


def _finite(what, m, shape):
    import torch

    if not all(bool(torch.isfinite(getattr(m, k).float()).all())
               for k in ("P", "Q")) or (
            tuple(m.P.shape), tuple(m.Q.shape)) != shape:
        raise AssertionError(f"{what}: tables not finite or mis-shaped")


def _mb_epochs(dev, what, make, epochs, check=None):
    """Run a trainer's epochs (``make()`` returns a SnapshotTrainer),
    timing each on the host's clock with the card synchronized; ``check``
    sees each epoch's batches before they train. Returns (trainer, mean
    losses, epoch seconds, prep seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = make()
    torch.cuda.synchronize()
    prep = time.perf_counter() - t0
    losses, walls = [], []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        b = tr.batches(epoch)
        if check is not None:
            check(epoch, b)
        losses.append(float(tr.run.run(b)) / tr.train.n_ratings)
        del b
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[bpr-mb] {what}: prep {prep:.3f} s; epoch_s "
        + " ".join(f"{x:.4f}" for x in walls) + "; mean_loss "
        + " ".join(f"{x:.6f}" for x in losses))
    return tr, losses, walls, prep


def _learn_cell(dev, learn):
    """Phase 31 (b)-(d)'s setup on ``learn``, phase 29 (b)'s learnable
    cell: the preset's bpr section as phase 31 runs it (bpr.kernel=jnp,
    device sampling, BPR_MB_EPOCHS epochs), a maker of the seeded rank-64
    model, the positive keys of both splits, the untrained held-out
    sampled AUC (both made once) and the preset's data seed."""
    import dataclasses

    import numpy as np
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.bpr import build_positive_index
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.models.mf import init_model

    cfg = apply_overrides(preset("billion_bpr_sharded"),
                          ["parallel.mode=single", "bpr.kernel=jnp"])
    bpr = dataclasses.replace(cfg.bpr, epochs=BPR_MB_EPOCHS,
                              sample_device="device")
    ltrain, ltest = learn

    def lmodel(dtype="float32"):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, ltrain.num_users, ltrain.num_items,
                          cfg.model.rank, init_scale=cfg.model.init_scale,
                          dtype=dtype)

    if "keys" not in _LEARN_CELL:  # the same cell every call
        _LEARN_CELL["keys"] = np.sort(np.concatenate([
            build_positive_index(ltrain), build_positive_index(ltest)]))
        _LEARN_CELL["auc0"] = sampled_auc(lmodel(), ltest,
                                          seed=cfg.data.seed,
                                          pos_keys=_LEARN_CELL["keys"])
    return (bpr, lmodel, _LEARN_CELL["keys"], _LEARN_CELL["auc0"],
            cfg.data.seed)


def _ring_jnp_run(dev, cell, make_model, keys, auc0, bpr, seed,
                  sample_device):
    """Phase 31 (c): the ring's 'jnp' path of one shard on ``cell`` (train,
    held-out) from ``make_model()``, ``bpr``'s epochs: the loss falls, the
    held-out sampled AUC ends above the untrained model's (``auc0``)."""
    import dataclasses

    import torch

    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.parallel import bpr_sharded as ring

    ctrain, ctest = cell
    rcfg = dataclasses.replace(bpr, sample_device=sample_device)
    t0 = time.perf_counter()
    out = []
    for _, rm, loss in ring.train_epochs_bpr_ring(
            make_model(), ctrain, rcfg, shards=1, seed=seed, device=dev):
        torch.cuda.synchronize()
        out.append((loss, time.perf_counter() - t0))
        t0 = time.perf_counter()
    rl = [x for x, _ in out]
    rank = rm.rank
    _finite(f"(c) {sample_device}", rm, ((ctrain.num_users, rank),
                                         (ctrain.num_items, rank)))
    rauc = sampled_auc(rm, ctest, seed=seed, pos_keys=keys)
    log(f"[bpr-mb] (c) ring bpr.kernel=jnp, {sample_device} sampling, "
        f"{ctrain.num_users} x {ctrain.num_items}, {ctrain.n_ratings} "
        "positives: epoch_s " + " ".join(f"{t:.4f}" for _, t in out)
        + " (the first with the prep); mean_loss "
        + " ".join(f"{x:.6f}" for x in rl)
        + f"; held-out AUC {auc0:.5f} -> {rauc:.5f}")
    _falls(f"(c) {sample_device}", rl)
    if not rauc > auc0:
        raise AssertionError(f"(c) {sample_device}: held-out AUC {rauc} not "
                             f"above the untrained {auc0}")
    BPR_MB.setdefault("c", {})[sample_device] = {
        "positives": ctrain.n_ratings, "mean_loss": rl,
        "epoch_s": [t for _, t in out], "auc": rauc, "auc_untrained": auc0}


def bpr_minibatch_cut_runs(dev, bpr, rank, init_scale, model_seed):
    """Phase 31's host-sampled runs, which spend their time in the
    reference's NumPy sampler, on the learnable cell cut to 1/BPR_MB_CUT of
    its users and positives, from the CPU-seeded init (seed 0, bpr's
    epochs): (d) the single trainer with f32 and bf16 tables, each epoch's
    loss within BPR_MB_TOL of the port's CPU run (BPR_MB_CPU); (b)
    parallel.mode=dp bit for bit (d)'s f32 run, tables and losses; (c) the
    'jnp' ring with host sampling."""
    import dataclasses

    import numpy as np
    import torch

    from mfx_torch.data.bpr import build_positive_index
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import make_implicit_synthetic
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.models.mf import init_model
    from mfx_torch.parallel.data_parallel import train_epochs_bpr_dp
    from mfx_torch.solvers import bpr as mb

    t_part = time.perf_counter()
    U_c, I_c, n_c, true_rank = IALS_LEARN
    ctrain, ctest = train_test_split(make_implicit_synthetic(
        U_c // BPR_MB_CUT, I_c, n_c // BPR_MB_CUT, rank=true_rank, seed=107),
        0.01, seed=0)
    g = torch.Generator()
    g.manual_seed(model_seed)
    cpu_init = init_model(g, ctrain.num_users, ctrain.num_items, rank,
                          init_scale=init_scale, device="cpu")
    host = dataclasses.replace(bpr, sample_device="host")
    what = (f"the cut cell ({ctrain.num_users} x {ctrain.num_items}, "
            f"{ctrain.n_ratings} positives)")
    cut, last = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        runs = [(loss, m) for _, m, loss in mb.train_epochs_bpr(
            cpu_init.astype(dtype), ctrain, host, seed=0, device=dev)]
        wall = time.perf_counter() - t0
        got = [loss for loss, _ in runs]
        last[dtype] = runs[-1][1]
        want = BPR_MB_CPU[dtype]
        err = max(abs(a - b) for a, b in zip(got, want))
        log(f"[bpr-mb] (d) {what}, {dtype}, host sampling from the "
            f"CPU-seeded init ({wall:.3f} s): mean_loss "
            + " ".join(f"{x!r}" for x in got) + f"; the port's CPU run "
            f"{want}; max difference {err:.3e} (tol {BPR_MB_TOL[dtype]})")
        if not err <= BPR_MB_TOL[dtype]:
            raise AssertionError(f"(d) {dtype}: the card's losses {got} not "
                                 f"within {BPR_MB_TOL[dtype]} of the CPU's "
                                 f"{want}")
        cut[dtype] = {"mean_loss": got, "cpu": list(want), "max_diff": err,
                      "s": wall}
    t0 = time.perf_counter()
    dp = [(loss, m) for _, m, loss in train_epochs_bpr_dp(
        cpu_init, ctrain, bpr, seed=0, device=dev)]
    dp_s = time.perf_counter() - t0
    m_dp, m_single = dp[-1][1], last["float32"]
    if [x for x, _ in dp] != cut["float32"]["mean_loss"] or not all(
            torch.equal(getattr(m_dp, k), getattr(m_single, k))
            for k in ("P", "Q")):
        raise AssertionError("(b): dp differs from the host-sampled single "
                             "run")
    log(f"[bpr-mb] (b) parallel.mode=dp on {what}, {len(dp)} epochs "
        f"({dp_s:.3f} s): tables and every epoch's mean loss bit for bit "
        f"the single trainer's with sample_device=host "
        f"({cut['float32']['s']:.3f} s)")
    BPR_MB["b"] = {"dp_bitwise": True, "dp_positives": ctrain.n_ratings,
                   "dp_s": dp_s, "single_host_s": cut["float32"]["s"]}
    del dp, last, m_dp, m_single
    keys = np.sort(np.concatenate([build_positive_index(ctrain),
                                   build_positive_index(ctest)]))
    auc0 = sampled_auc(cpu_init, ctest, seed=0, pos_keys=keys)
    _ring_jnp_run(dev, (ctrain, ctest), lambda: cpu_init, keys, auc0, bpr, 0,
                  "host")
    log(f"[time] phase 31 (b)-(d): the host-sampled runs on the cut cell "
        f"{time.perf_counter() - t_part:.1f} s of it")
    return cut


def bpr_minibatch_phase(dev, train, test, keys, auc0, fresh_model, learn):
    """Phase 31, the snapshot-minibatch BPR trainers. (a) On phase 8's
    data (billion-implicit / BPR_CUT): billion_bpr_sharded with
    parallel.mode=single bpr.kernel=jnp, rank 64, batch 131,072, device
    sampling, BPR_MB_EPOCHS of its 5 epochs through SnapshotTrainer: the
    loss falls; epoch 1, sampler and batch loop, under
    torch.cuda.set_sync_debug_mode('error'); epoch 0 again from a second
    trainer bit for bit; epoch s, peak memory and the sampled AUC and
    HR@10 beside the untrained model's. (b) On ``learn`` (phase 29 (b)'s
    learnable cell), rank 64: popularity negatives, device sampling, 2
    epochs: no drawn negative is a positive of its user, the loss falls.
    (c) The ring's 'jnp' path there with device sampling. (d) bf16 tables
    on (a)'s path there, 2 epochs: bf16_row_add launched, the loss falls,
    and the kernel held bit for bit against its plain version on a batch's
    Q scatter at the positives (131,072 rows of 5,000 items, rank 64).
    Then bpr_minibatch_cut_runs: (b)'s dp run, (c)'s host-sampled ring and
    (d)'s comparison with the CPU, on the cell cut to 1/BPR_MB_CUT.
    Returns bf16_row_add's launches in (d), and the kernel's check."""
    import dataclasses

    import numpy as np
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.bpr import members_2key
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.eval.ranking import hr_ndcg_at_k
    from mfx_torch.kernels.packing import GRAPH_LAUNCHES, bf16_row_add
    from mfx_torch.solvers import bpr as mb

    t_phase = time.perf_counter()
    cfg = apply_overrides(preset("billion_bpr_sharded"),
                          ["parallel.mode=single", "bpr.kernel=jnp"])
    seed = cfg.data.seed
    bpr = dataclasses.replace(cfg.bpr, epochs=BPR_MB_EPOCHS,
                              sample_device="device")
    U, I, rank = train.num_users, train.num_items, cfg.model.rank
    log(f"[bpr-mb] (a) billion_bpr_sharded with parallel.mode=single "
        f"bpr.kernel=jnp on phase 8's data ({U} x {I}, {train.n_ratings} "
        f"positives): rank {rank}, batch {bpr.batch_size}, lr {bpr.lr}, reg "
        f"{bpr.reg}, device sampling, {bpr.epochs} of "
        f"{cfg.bpr.epochs} epochs")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = mb.SnapshotTrainer(fresh_model(), train, bpr, seed=seed, device=dev)
    torch.cuda.synchronize()
    losses, walls, m0 = [], [], None
    for epoch in range(bpr.epochs):
        t0 = time.perf_counter()
        if epoch == 0:
            loss_t = tr.epoch(epoch)
        else:
            torch.cuda.set_sync_debug_mode("error")  # a host sync raises
            try:
                loss_t = tr.epoch(epoch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        losses.append(float(loss_t) / train.n_ratings)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if epoch == 0:
            m0 = tr.model()
    peak = torch.cuda.max_memory_allocated(dev)
    m = tr.model()
    _finite("(a)", m, ((U, rank), (I, rank)))
    log(f"[bpr-mb] (a) epoch_s " + " ".join(f"{x:.4f}" for x in walls)
        + " (sampling on the card and the batch loop, one graph replay a "
        f"batch of {-(-train.n_ratings // bpr.batch_size)}); mean_loss "
        + " ".join(f"{x:.6f}" for x in losses) + f"; peak memory allocated "
        f"{peak} bytes; epoch 1 (sampler and batch loop) under "
        "set_sync_debug_mode('error'): no host sync")
    _falls("(a)", losses)
    del tr
    tr2 = mb.SnapshotTrainer(fresh_model(), train, bpr, seed=seed, device=dev)
    again = float(tr2.epoch(0)) / train.n_ratings
    if again != losses[0] or not all(
            torch.equal(getattr(tr2.run, k), getattr(m0, k))
            for k in ("P", "Q")):
        raise AssertionError("(a): epoch 0 again differs from the first run")
    del tr2, m0
    log("[bpr-mb] (a) epoch 0 from a second trainer: tables and loss bit "
        "for bit")
    ranked = test.select(np.arange(min(BPR_RANK_POSITIVES, test.n_ratings)))
    auc = sampled_auc(m, test, seed=seed, pos_keys=keys)
    rk0 = hr_ndcg_at_k(fresh_model(), ranked, k=cfg.ranking_k, seed=seed,
                       pos_keys=keys)
    rk = hr_ndcg_at_k(m, ranked, k=cfg.ranking_k, seed=seed, pos_keys=keys)
    log(f"[bpr-mb] (a) held-out sampled AUC {auc0:.5f} untrained, "
        f"{auc:.5f} after {bpr.epochs} epochs; HR@{cfg.ranking_k} "
        f"{rk0['hr']:.5f} -> {rk['hr']:.5f} (the first {ranked.n_ratings} "
        "held-out positives, 100 sampled negatives each)")
    BPR_MB["a"] = {"epoch_s": walls, "mean_loss": losses, "peak_bytes": peak,
                   "auc_untrained": auc0, "auc": auc, "hr10_untrained":
                   rk0["hr"], "hr10": rk["hr"]}
    del m
    torch.cuda.empty_cache()

    # (b)-(d): the learnable cell, rank 64
    _, lmodel, lkeys, lauc0, _ = _learn_cell(dev, learn)
    log(f"[bpr-mb] (b)-(d) the learnable cell: {learn[0].num_users} x "
        f"{learn[0].num_items}, {learn[0].n_ratings} train / "
        f"{learn[1].n_ratings} held-out positives; untrained held-out "
        f"sampled AUC {lauc0:.5f}")
    pop = dataclasses.replace(bpr, neg_weighting="popularity")
    hits = []

    def no_positive(epoch, b):
        real = b["weights"].reshape(-1) > 0
        u, j = b["users"].reshape(-1)[real], b["neg"].reshape(-1)[real]
        i = b["pos"].reshape(-1)[real]
        hit = members_2key(tr_pop.pu, tr_pop.pi, u, j)
        hits.append((int(hit.sum()), int((hit & (j == i)).sum())))

    tr_pop = None

    def make_pop():
        nonlocal tr_pop
        tr_pop = mb.SnapshotTrainer(lmodel(), learn[0], pop, seed=seed,
                                    device=dev)
        return tr_pop

    _, pl, pw, _ = _mb_epochs(dev, "(b) neg_weighting=popularity, device "
                              "sampling", make_pop, pop.epochs, no_positive)
    log(f"[bpr-mb] (b) drawn negatives that are positives of their user, "
        f"per epoch (of them the positive itself, the fallback): {hits}")
    if any(h for h, _ in hits):
        raise AssertionError(f"(b): popularity negatives hold positives: "
                             f"{hits}")
    _falls("(b) popularity", pl)
    pop_rec = {"popularity_loss": pl, "popularity_epoch_s": pw,
               "positive_negatives": hits}
    del tr_pop

    # (c) the ring's 'jnp' path, one shard, sampling on the card
    _ring_jnp_run(dev, learn, lmodel, lkeys, lauc0, bpr, seed, "device")

    # (d) bf16 tables on (a)'s path
    bf16_row_add.launches = 0
    GRAPH_LAUNCHES.update(captured=0, replayed=0)
    tr_bf, bl, bw, _ = _mb_epochs(
        dev, "(d) model.dtype=bfloat16, device sampling",
        lambda: mb.SnapshotTrainer(lmodel("bfloat16"), learn[0], bpr,
                                   seed=seed, device=dev), bpr.epochs)
    torch.cuda.synchronize()
    launches = (bf16_row_add.launches - GRAPH_LAUNCHES["captured"]
                + GRAPH_LAUNCHES["replayed"])
    bauc = sampled_auc(tr_bf.model(), learn[1], seed=seed, pos_keys=lkeys)
    log(f"[bpr-mb] (d) bf16_row_add launches {launches} (the wrapper's "
        f"{bf16_row_add.launches}, {GRAPH_LAUNCHES['captured']} captured, "
        f"{GRAPH_LAUNCHES['replayed']} replayed); held-out AUC {lauc0:.5f} "
        f"-> {bauc:.5f}")
    if launches < 1 or tr_bf.run.P.dtype != torch.bfloat16:
        raise AssertionError("(d): bf16_row_add never launched")
    _falls("(d) bf16", bl)
    # the kernel at this path's shape, its counts read above: the first
    # batch of an epoch, Q's scatter at the positives (duplicate rows)
    run, b = tr_bf.run, tr_bf.batches(bpr.epochs)
    b = {k: v[0] for k, v in b.items()}
    users, pos, neg = (b[k].long() for k in ("users", "pos", "neg"))
    d_qi = mb.bpr_compute_deltas(run.P, run.Q, users, pos, neg,
                                 b["weights"], run.lr, run.reg)[1]
    check = bf16_add_check(dev, "phase 31 (d), a batch's Q scatter at the "
                           "positives", run.Q, pos, d_qi.to(torch.bfloat16))
    del tr_bf, run, b, users, pos, neg, d_qi
    cut = bpr_minibatch_cut_runs(dev, bpr, rank, cfg.model.init_scale,
                                 cfg.model.seed)
    BPR_MB["b"].update(pop_rec)
    BPR_MB["d"] = {"mean_loss": bl, "epoch_s": bw, "auc": bauc,
                   "bf16_row_add": launches, "row_add_check": check,
                   "cut": cut}
    log(f"[time] phase 31 {time.perf_counter() - t_phase:.1f} s")
    return launches, check


def tile_bias_compare(results, bounds, state, seg, sa, tc, tl, lr, reg, mu,
                      su, si, tpg, tag, deps):
    """sgd_sweep_tile and sgd_sweep_step_u (on the card's count, ordered
    by ``deps``) against their plain versions on one tile stream from the
    plain tables ``state`` = (P, Q, bu, bi); fills ``results`` and
    ``bounds`` under the kernels' names plus ``tag``."""
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_step_u,
                                             sgd_sweep_step_u_plain,
                                             sgd_sweep_tile,
                                             sgd_sweep_tile_plain)

    rank = state[0].shape[1]
    log(f"[kernel] tile-bias sweeps{tag}: {tl.shape[0]} tiles (T="
        f"{tl.shape[2]}, rank {rank}, su={su}, si={si}, tpg={tpg})")
    kw = dict(su=su, si=si, tpg=tpg)
    for kernel, plain in ((sgd_sweep_tile, sgd_sweep_tile_plain),
                          (sgd_sweep_step_u, sgd_sweep_step_u_plain)):
        name = kernel.__name__ + tag
        results[name] = compare(
            name,
            lambda P, Q, bu, bi: kernel(P, Q[seg], bu, bi[seg], sa, tc, tl,
                                        lr, reg, mu, **kw, deps=deps),
            lambda P, Q, bu, bi: plain(P, Q[seg], bu, bi[seg], sa, tc, tl,
                                       lr, reg, mu, **kw),
            state,
        )
        # per real slot as sgd_sweep (10 rank), plus the bias terms
        bounds[name] = sweep_bound(tl, sa, tc, su, si, tpg, rank,
                                   [("P", 0), ("Q", 1)], 10, bias="update")
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})")


def tile_bias_phases(dev, sweeps):
    """Phases 9 and 10: the tile-bias kernels against their plain versions
    at the ml1m_rank32_biased preset's shapes and sgd_sweep_tile over the
    whole sweep (into ``sweeps``), then the preset's 30 epochs per tile and
    with sgd.step_user_batch. Returns the two kernels' launches, each from
    its own run."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.packing import plain_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_step_u, sgd_sweep_tile
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked

    cfg = preset("ml1m_rank32_biased")
    sgd, seed = cfg.sgd, cfg.data.seed
    t0 = time.perf_counter()
    # the ml-1m entry of mfx_torch/data/loaders.py (its seeded synthetic)
    coo = make_synthetic(*ML1M_SHAPE, rank=32, seed=101, star_step=1.0,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac, seed=seed)
    log(f"[tile] cell: ml1m_rank32_biased unchanged (rank {cfg.model.rank}, "
        f"bias_mode={sgd.bias_mode!r}, su = si = {sgd.ublock}, T = "
        f"{sgd.tile}, lr {sgd.lr}, decay {sgd.lr_decay}, reg {sgd.reg}, "
        f"{sgd.epochs} epochs, no dense phase) on the ml-1m synthetic")
    log(f"[data] {coo.num_users} x {coo.num_items}, {coo.n_ratings} ratings "
        f"({train.n_ratings} train / {test.n_ratings} test) in "
        f"{time.perf_counter() - t0:.1f} s")
    U, I, rank = coo.num_users, coo.num_items, cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG
    mu = float(train.global_mean)

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)

    # 9. the kernels against their plain versions at the preset's shapes
    t_phase = time.perf_counter()
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl = pdv.epoch_tiles_device(skel, u, i, r, seed, 0)
    sw = next(s for s in skel.sweeps if s.t1 > s.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    log(f"[tile] plan: {len(skel.sweeps)} sweep(s), {tl.shape[0]} tiles an "
        f"epoch, {sw.nwin} windows in the first")
    state = plain_tables(fresh_model(), su, si, dev)
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    tile_bias_compare(
        {}, {}, state, seg, sw.sa[:nt // tpg].contiguous(),
        sw.tc[:nt].contiguous(), tl[sw.t0:sw.t0 + nt], sgd.lr, sgd.reg, mu,
        su, si, tpg, "[rank32]", sw.deps.prefix(nt))
    # the whole first sweep, to set beside phase 10's epoch seconds: each
    # kernel on one block and on the card's count (step_user_batch plans
    # the same sweeps here: sweep_geometry gives 8 windows either way)
    if blocked.sweep_geometry(I, rank, si, step_u=(su, T)) != sw.nwin:
        raise AssertionError("step_user_batch plans other sweeps here")
    lib = _build.load_library()
    for kernel, card in (
            (sgd_sweep_tile, lib.mfx_sgd_sweep_tile_max_blocks(T, rank)),
            (sgd_sweep_step_u,
             lib.mfx_sgd_sweep_step_u_max_blocks(T, rank, su))):
        sweeps[kernel.__name__] = whole_sweep(
            kernel.__name__,
            lambda P, Q, bu, bi, blocks, kernel=kernel: kernel(
                P, Q[seg], bu, bi[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1],
                sgd.lr, sgd.reg, mu, su=su, si=si, tpg=tpg, deps=sw.deps,
                blocks=blocks),
            state, sw.deps, card)
    # the whole sweep's bound, as tile_bias_compare counts it
    whole = sweep_bound(tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                        [("P", 0), ("Q", 1)], 10, bias="update")
    log(f"[tile] the whole sweep's bound {whole[0]:.4f} ms ({whole[1]})")
    for name in ("sgd_sweep_tile", "sgd_sweep_step_u"):
        sweeps[name]["sweep_bound_ms"] = whole[0]
    del state
    del skel, tl, u, i, r
    torch.cuda.empty_cache()
    log(f"[time] phase 9 {time.perf_counter() - t_phase:.1f} s")

    # 10. the path: 30 epochs per tile, then 30 with step_user_batch
    t_phase = time.perf_counter()
    base_rmse, base_mae = rmse_mae(fresh_model(), test)
    log(f"[tile] untrained held-out rmse {base_rmse:.5f} mae {base_mae:.5f}")
    launches, finals, after2 = {}, {}, None
    for step_u in (False, True):
        kernel = sgd_sweep_step_u if step_u else sgd_sweep_tile
        tag = "step_u" if step_u else "per-tile"
        run_sgd = apply_overrides(
            cfg, [f"sgd.step_user_batch={str(step_u).lower()}"]).sgd
        sgd_sweep_tile.launches = sgd_sweep_step_u.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        trains, epoch_ss, plan_seen = [], [], 0.0
        torch.cuda.synchronize()
        t_prev = time.perf_counter()
        for epoch, m, tr in blocked.train_epochs_blocked(
                fresh_model(), train, run_sgd, cfg.model.use_bias, seed=seed,
                device=dev, timings=timings):
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_prev
            plan_s = timings["plan_s"] - plan_seen
            plan_seen = timings["plan_s"]
            epoch_ss.append(wall - plan_s
                            - (timings["prep_s"] if epoch == 0 else 0.0))
            trains.append(float(tr))
            if step_u and epoch == 1:
                after2 = m
            t_prev = time.perf_counter()
        counts = {"sgd_sweep_tile": sgd_sweep_tile.launches,
                  "sgd_sweep_step_u": sgd_sweep_step_u.launches}
        launches[kernel.__name__] = kernel.launches
        peak = torch.cuda.max_memory_allocated(dev)
        test_rmse, test_mae = rmse_mae(m, test)
        finals[tag] = test_rmse
        steady = sorted(epoch_ss[1:])[len(epoch_ss[1:]) // 2]
        log(f"[tile] {tag}: prep {timings['prep_s']:.4f} s, plan "
            f"{timings['plan_s']:.4f} s in all, epoch_s first "
            f"{epoch_ss[0]:.4f} median of the others {steady:.4f} sum "
            f"{sum(epoch_ss):.4f}")
        log(f"[tile] {tag}: train_rmse " + " ".join(f"{x:.5f}" for x in trains))
        log(f"[tile] {tag}: held-out rmse {test_rmse:.5f} mae {test_mae:.5f} "
            f"after epoch {len(trains)} (unclipped); launches {counts}, peak "
            f"memory allocated {peak} bytes")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if (not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank)
                or m.bu.shape != (U,) or m.bi.shape != (I,)):
            raise AssertionError(f"{tag}: tables not finite or mis-shaped")
        if kernel.launches < 1:
            raise AssertionError(f"{tag}: {kernel.__name__} never launched")
        if len(trains) != sgd.epochs or not trains[-1] < trains[0]:
            raise AssertionError(f"{tag}: the train RMSE did not fall: {trains}")
        if not (test_rmse <= ML1M_RMSE_GATE and test_rmse < base_rmse):
            raise AssertionError(
                f"{tag}: held-out RMSE {test_rmse} above the {ML1M_RMSE_GATE} "
                f"gate or the untrained {base_rmse}")
    gap = abs(finals["per-tile"] - finals["step_u"])
    if gap > ML1M_BODIES_TOL:
        raise AssertionError(f"the two bodies end {gap} apart: {finals}")
    log(f"[tile] the two bodies end {gap:.3e} apart (tol {ML1M_BODIES_TOL})")
    run_sgd = dataclasses.replace(run_sgd, epochs=2)
    for _, again, _ in blocked.train_epochs_blocked(
            fresh_model(), train, run_sgd, cfg.model.use_bias, seed=seed,
            device=dev):
        pass
    if not all(torch.equal(getattr(again, k), getattr(after2, k))
               for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("step_user_batch: a second run of 2 epochs differs")
    log("[tile] step_u: a second run of 2 epochs repeats the first bit for bit")
    log(f"[time] phase 10 {time.perf_counter() - t_phase:.1f} s")
    return launches


def netflix_phases(dev, results, bounds, sweeps):
    """Phases 11 and 12: the rank-128 lane sgd_sweep and the int8 rank-128
    dense_phase against their plain versions at the netflix100m_rank128_dp
    preset's shapes, each over a whole sweep / group 0 on one block and on
    the card's count, and the epoch's split; then the preset's path, 3
    epochs of its 15 (epochs are depth: cut for time), and a 1-epoch
    repeat; and the netflix parts of phases 21 (netflix_forms, after phase
    11, on its plan and carving) and 22 (netflix_bias_runs, after phase
    12). Fills ``results``, ``bounds`` and ``sweeps`` under
    ``sgd_sweep_r128``, ``dense_phase_int8_r128`` and the forms of
    NETFLIX_LAUNCHES; returns their launches on the path."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.synthetic import NETFLIX_SHAPE
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.dense_phase import (dense_phase, dense_phase_plain,
                                               group_prefix, plan_launch)
    from mfx_torch.kernels.packing import lane_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    cfg = apply_overrides(preset("netflix100m_rank128_dp"),
                          ["parallel.mode=single"])
    sgd, seed = cfg.sgd, cfg.data.seed
    U, I, rank = NETFLIX_SHAPE[0], NETFLIX_SHAPE[1], cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG
    shards = preset("netflix100m_rank128_dp").parallel.model_axis
    log(f"[netflix] cell: netflix100m_rank128_dp with parallel.mode=single "
        f"(one card instead of the preset's {shards}-shard ring); rank "
        f"{rank}, bias_mode={sgd.bias_mode!r}, su = si = "
        f"{su}, T = {T}, dense_chi={sgd.dense_chi} dense_span="
        f"{sgd.dense_span!r}, lr {sgd.lr}, decay {sgd.lr_decay}, reg "
        f"{sgd.reg}; {NETFLIX_EPOCHS} of its {sgd.epochs} epochs")
    # the netflix entry of mfx_torch/data/loaders.py (its seeded synthetic)
    train, test = wait_data("netflix")
    log(f"[data] {train.num_users} x {train.num_items}, "
        f"{train.n_ratings + test.n_ratings} ratings ({train.n_ratings} "
        f"train / {test.n_ratings} test)")
    mu, lr, reg = float(train.global_mean), sgd.lr, sgd.reg

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)

    # 11. the kernels at the preset's shapes
    t_phase = time.perf_counter()
    rfmt = blocked.dense_rfmt(sgd, rank, train.rating)
    nwd = blocked.dense_group_windows(rank, si)
    nwin = blocked.sweep_geometry(I, rank, si)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    meta, groups, (u, i, r), info = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi, nwd=nwd, rfmt=rfmt)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg, nwin)
    tl = pdv.epoch_tiles_device(skel, u, i, r, seed, 0)
    sws = [s for s in skel.sweeps if s.t1 > s.t0]
    A, C = -(-U // su), -(-I // si)
    log(f"[netflix] geometry: {A} user blocks x {C} windows = {A * C} "
        f"strata; {nwin} windows a sparse sweep ({len(sws)} sweep(s)), "
        f"{nwd} a dense group ({len(groups)} groups); {rfmt} codes; "
        f"{info['num_strata']} dense strata "
        f"({[g['sa'].shape[0] for g in groups]} a group), dense_frac "
        f"{info['dense_frac']:.4f}, R image {info['r_stream_bytes']} bytes; "
        f"{tl.shape[0]} tiles an epoch")
    if (A, C, nwin, nwd, rfmt) != (938, 35, 35, 16, "int8"):
        raise AssertionError("the netflix geometry is not the reference's")
    for g in groups:
        plan_launch(g, su, si, rank)  # the launch orders, on the host
    P, Q = lane_tables(fresh_model(), su, si, dev)
    lib = _build.load_library()

    win0, nw = meta[0]
    seg = slice(win0 * si, (win0 + nw) * si)
    grp = group_prefix(groups[0], DENSE_STRATA)
    log(f"[kernel] dense_phase_int8_r128: {grp['sa'].shape[0]} strata of "
        f"group 0 ({rfmt}, {su}x{si}, rank {rank}); critical path "
        f"{grp['deps'].critical} strata")
    results["dense_phase_int8_r128"] = compare(
        "dense_phase_int8_r128",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, lr, reg, mu, su=su,
                                   si=si, deps=grp["deps"]),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, lr, reg, mu,
                                         su=su, si=si),
        (P, Q))
    bounds["dense_phase_int8_r128"] = dense_bound([grp], su, si, rank)
    dense_card = lib.mfx_dense_phase_max_blocks(rank, 1, 0)  # lane form
    g0 = groups[0]
    sweeps["dense_phase_int8_r128"] = whole_sweep(
        "dense_phase_int8_r128 (group 0)",
        lambda Pt, Qt, blocks: dense_phase(Pt, Qt[seg], g0, lr, reg, mu,
                                           su=su, si=si, deps=g0["deps"],
                                           blocks=blocks),
        (P, Q), g0["deps"], dense_card, grid=dense_card, unit="strata")
    sweeps["dense_phase_int8_r128"]["sweep_bound_ms"] = dense_bound(
        [g0], su, si, rank)[0]

    sw = sws[0]
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    deps = sw.deps.prefix(nt)
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    log(f"[kernel] sgd_sweep_r128: {nt} tiles of the sweep (T={T}, rank "
        f"{rank}); they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    results["sgd_sweep_r128"] = compare(
        "sgd_sweep_r128",
        lambda Pt, Qt: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg, mu,
                                 su=su, si=si, tpg=tpg, deps=deps),
        lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg),
        (P, Q))
    # per real slot, as sgd_sweep: 10 rank
    bounds["sgd_sweep_r128"] = sweep_bound(tls, sa, tc, su, si, tpg, rank,
                                           [("P", 0), ("Q", 1)], 10)
    sweeps["sgd_sweep_r128"] = whole_sweep(
        "sgd_sweep_r128",
        lambda Pt, Qt, blocks: sgd_sweep(
            Pt, Qt[seg_s], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
            su=su, si=si, tpg=tpg, deps=sw.deps, blocks=blocks),
        (P, Q), sw.deps, lib.mfx_sgd_sweep_max_blocks(T, rank))
    sweeps["sgd_sweep_r128"]["sweep_bound_ms"] = sweep_bound(
        tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
        [("P", 0), ("Q", 1)], 10)[0]
    for name in ("dense_phase_int8_r128", "sgd_sweep_r128"):
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}); whole {sweeps[name]['sweep_bound_ms']:.4f}"
            " ms")

    # where an epoch goes: each dense group, then the sparse sweep(s), in
    # the trainer's order on the card's grid, from the untrained tables
    # (the kernels' work does not depend on the values)
    Pt, Qt = P.clone(), Q.clone()
    split = []
    for k, ((w0, n), g) in enumerate(zip(meta, groups)):
        def run_group(g=g, w0=w0, n=n):
            dense_phase(Pt, Qt[w0 * si:(w0 + n) * si], g, lr, reg, mu, su=su,
                        si=si, deps=g["deps"])
        run_group()  # warm-up
        ms = cuda_ms(run_group, reps=2)
        b = dense_bound([g], su, si, rank)
        split.append((f"dense group {k}", g["deps"].n_tiles,
                      g["deps"].critical, ms, b[0]))
    for k, s in enumerate(sws):
        sg = slice(s.win0 * si, (s.win0 + s.nwin) * si)

        def run_sweep(s=s, sg=sg):
            sgd_sweep(Pt, Qt[sg], s.sa, s.tc, tl[s.t0:s.t1], lr, reg, mu,
                      su=su, si=si, tpg=tpg, deps=s.deps)
        ms = cuda_ms(run_sweep, reps=2)
        b = sweep_bound(tl[s.t0:s.t1], s.sa, s.tc, su, si, tpg, rank,
                        [("P", 0), ("Q", 1)], 10)
        split.append((f"sparse sweep {k}", s.deps.n_tiles, s.deps.critical,
                      ms, b[0]))
    for what, n, crit, ms, b in split:
        unit = "strata" if what.startswith("dense") else "tiles"
        log(f"[netflix] epoch split, {what}: {n} {unit}, critical path "
            f"{crit}: {ms:.4f} ms (mean of 2) against a bound of {b:.4f} ms")
    dense_ms = sum(x[3] for x in split if x[0].startswith("dense"))
    sparse_ms = sum(x[3] for x in split if x[0].startswith("sparse"))
    log(f"[netflix] epoch split: dense {dense_ms:.4f} ms + sparse "
        f"{sparse_ms:.4f} ms = {dense_ms + sparse_ms:.4f} ms of kernels")
    sweeps["dense_phase_int8_r128"]["epoch_dense_ms"] = dense_ms
    sweeps["sgd_sweep_r128"]["epoch_sparse_ms"] = sparse_ms
    del Pt, Qt, P, Q, grp, g0, tls, u, i, r
    torch.cuda.empty_cache()
    log(f"[time] phase 11 {time.perf_counter() - t_phase:.1f} s")

    # 21 (netflix). the rank-128 tile-bias, epoch and step_u sweeps and the
    # frozen and bias-free int8 rank-128 dense forms on this plan
    netflix_forms(dev, sgd, fresh_model, sws[0], tl, meta, groups, mu,
                  results, bounds, sweeps)
    del meta, groups, skel, tl, sws
    torch.cuda.empty_cache()

    # 12. the path, through the trainer
    t_phase = time.perf_counter()
    base_rmse, _ = rmse_mae(fresh_model(), test)
    log(f"[netflix] untrained held-out rmse {base_rmse:.5f} (unclipped)")
    run_sgd = dataclasses.replace(sgd, epochs=NETFLIX_EPOCHS)
    sgd_sweep.launches = 0
    dense_phase.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    trains, tests, epoch_ss, after1, plan_seen = [], [], [], None, 0.0
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for epoch, m, tr in blocked.train_epochs_blocked(
            fresh_model(), train, run_sgd, cfg.model.use_bias, seed=seed,
            device=dev, timings=timings):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prev
        plan_s = timings["plan_s"] - plan_seen
        plan_seen = timings["plan_s"]
        epoch_s = wall - plan_s - (timings["prep_s"] if epoch == 0 else 0.0)
        if epoch == 0:
            info = timings["dense_info"]
            log(f"[netflix] prep {timings['prep_s']:.3f} s: dense_frac "
                f"{info['dense_frac']:.4f}, {info['num_strata']} strata in "
                f"{info['num_groups']} groups, R image "
                f"{info['r_stream_bytes']} bytes; (tiles, critical path) "
                f"of each sparse sweep {timings['sweep_tiles']}")
            after1 = {k: getattr(m, k).clone() for k in ("P", "Q", "bu", "bi")}
            after1["train"] = float(tr)
        test_rmse, test_mae = rmse_mae(m, test)
        trains.append(float(tr))
        tests.append(test_rmse)
        epoch_ss.append(epoch_s)
        log(f"[netflix] epoch {epoch}: epoch_s {epoch_s:.4f} plan_s "
            f"{plan_s:.4f} train_rmse {float(tr):.5f} test_rmse "
            f"{test_rmse:.5f} test_mae {test_mae:.5f}")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank):
            raise AssertionError("netflix: tables not finite or mis-shaped")
        t_prev = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {"sgd_sweep_r128": sgd_sweep.launches,
                "dense_phase_int8_r128": dense_phase.launches}
    log(f"[netflix] launches {launches}, peak memory allocated {peak} bytes")
    log(f"[netflix] steady epoch_s {epoch_ss[-1]:.4f} against phase 11's "
        f"kernels {(dense_ms + sparse_ms) / 1e3:.4f} s (dense "
        f"{dense_ms / 1e3:.4f}, sparse {sparse_ms / 1e3:.4f})")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if peak > 80e9:
        raise AssertionError(f"peak memory {peak} above 80 GB")
    # the reference's own held-out RMSE on this synthetic is lowest after
    # the first epoch and rises after it, while the train RMSE falls
    # (tests/test_torch_slice.py::
    # test_netflix_cut_follows_the_reference_trainer, at 1/200 of the
    # shape): so every epoch's held-out RMSE must lie below the untrained
    # model's and the train RMSE must fall every epoch
    if (len(tests) != NETFLIX_EPOCHS or max(tests) >= base_rmse
            or any(b >= a for a, b in zip(trains, trains[1:]))):
        raise AssertionError(
            f"netflix: held-out RMSE {tests} not below the untrained "
            f"{base_rmse} after every epoch, or the train RMSE {trains} "
            "did not fall every epoch")
    log(f"[netflix] held-out RMSE below the untrained {base_rmse:.5f} after "
        f"every epoch ({' '.join(f'{x:.5f}' for x in tests)}; lowest after "
        f"epoch {1 + tests.index(min(tests))}); train RMSE falls every epoch")
    del m
    for _, again, tr in blocked.train_epochs_blocked(
            fresh_model(), train, dataclasses.replace(sgd, epochs=1),
            cfg.model.use_bias, seed=seed, device=dev):
        pass
    if float(tr) != after1["train"] or not all(
            torch.equal(getattr(again, k), after1[k])
            for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("netflix: a second run of 1 epoch differs")
    log("[netflix] a second run of 1 epoch repeats the first run's state "
        "after epoch 1 bit for bit")
    log(f"[time] phase 12 {time.perf_counter() - t_phase:.1f} s")

    # 22 (netflix). the other bias modes through the trainer
    launches.update(netflix_bias_runs(dev, cfg, train, test, fresh_model,
                                      tests))
    # 29 (a). ALS on the cell, through the driver
    torch.cuda.empty_cache()
    from pathlib import Path

    GRAM["als"] = als_netflix_phase(
        dev, cfg, train, test, fresh_model, tests,
        Path(__file__).resolve().parent / "build" / "chip_smoke_root_netflix")
    return launches


# phase 22's netflix runs: each form's entry in the kernels line, the run
# whose launches it reports, and the count it reads there
NETFLIX_RUNS = {
    "a": ["sgd.bias_mode=tile"],
    "b": ["sgd.bias_mode=epoch"],
    "c": ["sgd.bias_mode=tile", "sgd.step_user_batch=true"],
    "d": ["model.use_bias=false"],
}
NETFLIX_RUN_EPOCHS = 2
NETFLIX_LAUNCHES = {
    "sgd_sweep_tile_r128": ("a", "sgd_sweep_tile"),
    "sgd_sweep_epoch_r128": ("b", "sgd_sweep_epoch"),
    "sgd_sweep_step_u_r128": ("c", "sgd_sweep_step_u"),
    "sgd_sweep_tile_none_r128": ("d", "sgd_sweep_tile"),
    "dense_phase_frozen_int8_r128": ("a", "dense_phase:frozen"),
    "dense_phase_none_int8_r128": ("d", "dense_phase:none"),
}
BIAS_MODES_TOL = 0.03  # between bias modes: tests/unit/test_bias_epoch.py


def netflix_forms(dev, sgd, fresh_model, sw, tl, meta, groups, mu, results,
                  bounds, sweeps):
    """Phase 21, the netflix part, on phase 11's plan and carving: the
    rank-128 forms of sgd_sweep_tile.cu (tile biases, none, epoch) and
    sgd_sweep_step_u.cu (tpg 4) against their plain versions on the first
    SWEEP_TILES tiles of the sparse sweep ``sw`` (within TOL, the epoch
    form's residuals too; two kernel runs bitwise), then each over the
    whole sweep once on one block and twice on the card's count (tables,
    biases, residuals and SSE bitwise); then the frozen and bias-free int8
    rank-128 dense forms on group 0 (dense_form_check, dense_group_times).
    The tables are phase 11's untrained model on plain tables with seeded
    N(0, 0.1) biases, so that every bias term is live. Fills ``results``,
    ``bounds`` and ``sweeps``."""
    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels.packing import lane_tables, plain_tables
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                             sgd_sweep_epoch_plain,
                                             sgd_sweep_step_u,
                                             sgd_sweep_step_u_plain,
                                             sgd_sweep_tile,
                                             sgd_sweep_tile_plain)
    from mfx_torch.solvers.blocked import TPG

    t_phase = time.perf_counter()
    su, si, T, lr, reg = sgd.ublock, sgd.iblock, sgd.tile, sgd.lr, sgd.reg
    model = fresh_model()
    rank = model.rank
    g = torch.Generator(device=dev).manual_seed(rank)
    model.bu.copy_(torch.randn(model.bu.shape, device=dev, generator=g) * 0.1)
    model.bi.copy_(torch.randn(model.bi.shape, device=dev, generator=g) * 0.1)
    state = plain_tables(model, su, si, dev)
    del model
    lib = _build.load_library()
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    head = (sw.sa[:nt // TPG].contiguous(), sw.tc[:nt].contiguous(),
            tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt))
    whole = (sw.sa, sw.tc, tl[sw.t0:sw.t1], sw.deps)
    kw = dict(su=su, si=si, tpg=TPG)
    # name: (kernel, plain, use_bias, sweep_bound's bias, slot bytes, grid)
    forms = {
        "sgd_sweep_tile_r128": (sgd_sweep_tile, sgd_sweep_tile_plain, True,
                                "update", 0,
                                lib.mfx_sgd_sweep_tile_max_blocks(T, rank)),
        "sgd_sweep_tile_none_r128": (sgd_sweep_tile, sgd_sweep_tile_plain,
                                     False, None, 0,
                                     lib.mfx_sgd_sweep_tile_max_blocks(
                                         T, rank)),
        "sgd_sweep_epoch_r128": (sgd_sweep_epoch, sgd_sweep_epoch_plain,
                                 True, "read", 4,
                                 lib.mfx_sgd_sweep_tile_max_blocks(T, rank)),
        "sgd_sweep_step_u_r128": (sgd_sweep_step_u, sgd_sweep_step_u_plain,
                                  True, "update", 0,
                                  lib.mfx_sgd_sweep_step_u_max_blocks(
                                      T, rank, su)),
    }

    def run_form(name, tiles, kernel=True, blocks=None):
        """run(P, Q, bu, bi[, e]) of the named form over ``tiles`` (sa,
        tc, tl, deps): through the kernel on ``blocks`` or its plain
        version; returns the SSE."""
        fn, plain, use_bias = forms[name][:3]
        sa, tc, tls, deps = tiles
        extra = dict(deps=deps, blocks=blocks) if kernel else {}
        call = fn if kernel else plain

        def run(P, Q, bu, bi, e=None):
            if e is not None:  # the epoch form: its residuals' output
                return call(P, Q[seg], bu, bi[seg], sa, tc, tls, e, lr, reg,
                            mu, **kw, **extra)
            return call(P, Q[seg], bu, bi[seg], sa, tc, tls, lr, reg, mu,
                        **kw, use_bias=use_bias, **extra)
        return run

    log(f"[kernel] netflix rank-128 tile-bias forms: {nt} tiles of the "
        f"sweep (T={T}, su = si = {su}, tpg {TPG}); critical path "
        f"{head[3].critical} tiles; the whole sweep {sw.t1 - sw.t0} tiles, "
        f"critical path {sw.deps.critical}")
    for name, (_, _, _, bias, slot_bytes, card) in forms.items():
        epoch = name.startswith("sgd_sweep_epoch")
        st_head = tuple(state) + ((torch.zeros(nt, T, device=dev),)
                                  if epoch else ())
        results[name] = compare(
            name, run_form(name, head), run_form(name, head, kernel=False),
            st_head)
        bounds[name] = sweep_bound(head[2], head[0], head[1], su, si, TPG,
                                   rank, [("P", 0), ("Q", 1)], 10, bias=bias,
                                   slot_bytes=slot_bytes)
        st_whole = tuple(state) + ((torch.zeros(sw.t1 - sw.t0, T,
                                                device=dev),)
                                   if epoch else ())
        sweeps[name] = whole_sweep(
            name, lambda *t, name=name: run_form(name, whole,
                                                 blocks=t[-1])(*t[:-1]),
            st_whole, sw.deps, card)
        sweeps[name]["sweep_bound_ms"] = sweep_bound(
            whole[2], whole[0], whole[1], su, si, TPG, rank,
            [("P", 0), ("Q", 1)], 10, bias=bias, slot_bytes=slot_bytes)[0]
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]}); whole sweep "
            f"{sweeps[name]['sweep_bound_ms']:.4f} ms")
        del st_head, st_whole
        torch.cuda.empty_cache()

    # the frozen and bias-free int8 rank-128 dense forms on group 0
    for name, bias in (("dense_phase_frozen_int8_r128", "frozen"),
                       ("dense_phase_none_int8_r128", "none")):
        err, ms, plain_ms, runs, b = dense_form_check(
            name, bias, groups, meta, state, lr, reg, mu, su, si, rank,
            "int8")
        runs.update(dense_group_times(name, bias, groups, meta, state, lr,
                                      reg, mu, su, si, rank))
        results[name], bounds[name] = (err, ms, plain_ms), b
        sweeps[name] = runs
    log(f"[time] phase 21 (the netflix rank-128 forms) "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 25 (netflix). the bf16 sweeps at rank 128 on this plan, and echo 2 in
    # the lane form (int8, rank 128) on group 0
    t_phase = time.perf_counter()
    lane = lane_tables(fresh_model(), su, si, dev)
    store_forms(bf16_forms("_r128", lane, state, sw, tl, lr, reg, mu, su, si,
                           TPG, tiles=VARIANT_TILES), results, bounds, sweeps,
                "rank 128, the netflix cell's plan")
    store_forms(echo_forms("_int8_r128", groups, meta, lane, state, lr, reg,
                           mu, su, si, "int8", DENSE_STRATA, DENSE_WHOLE,
                           biases=("lane",)), results, bounds, sweeps,
                "lane, int8 codes, rank 128, the netflix cell's group 0")
    del state, lane
    torch.cuda.empty_cache()
    log(f"[time] phase 25 (the netflix cell) "
        f"{time.perf_counter() - t_phase:.1f} s")


def netflix_bias_runs(dev, cfg, train, test, fresh_model, lane_tests):
    """Phase 22, the netflix part: netflix100m_rank128_dp with
    parallel.mode=single in NETFLIX_RUNS (a) sgd.bias_mode=tile, (b)
    sgd.bias_mode=epoch, (c) tile with sgd.step_user_batch=true, (d)
    model.use_bias=false, NETFLIX_RUN_EPOCHS epochs each from phase 12's
    untrained model, through train_runs (its kernels and no other, the
    train RMSE falls every epoch, the held-out RMSE below the untrained
    model's after every epoch, peak memory <= 80 GB); (a), (b) and (d)
    end within BIAS_MODES_TOL of phase 12's lane run after the same epoch
    (``lane_tests``), (c) within BIAS_MODES_TOL of (a); a second run of
    (c) for 1 epoch repeats its state after epoch 1 bit for bit. Returns
    each rank-128 form's launches (NETFLIX_LAUNCHES)."""
    import torch

    from mfx_torch.config import apply_overrides
    from mfx_torch.solvers import blocked

    t_phase = time.perf_counter()
    e = NETFLIX_RUN_EPOCHS
    lane = lane_tests[e - 1]
    near = (lane - BIAS_MODES_TOL, lane + BIAS_MODES_TOL)
    frozen = "dense_phase:frozen"
    want = {"a": ({"sgd_sweep_tile", frozen}, near),
            "b": ({"sgd_sweep_epoch", frozen}, near),
            "c": ({"sgd_sweep_step_u", frozen}, None),
            "d": ({"sgd_sweep_tile", "dense_phase:none"}, near)}
    log(f"[netflix] the other bias modes, {e} epochs each; lane's held-out "
        f"RMSE after epoch {e}: {lane:.5f}")
    _, runs = train_runs(dev, cfg, train, test, fresh_model, {
        k: (ov + [f"sgd.epochs={e}"], *want[k])
        for k, ov in NETFLIX_RUNS.items()}, "netflix", every_epoch=True)
    gap = abs(runs["c"][2][-1] - runs["a"][2][-1])
    if gap > BIAS_MODES_TOL:
        raise AssertionError(f"(c) ends {gap} from (a)")
    log(f"[netflix] (c) ends {gap:.5f} from (a) (tol {BIAS_MODES_TOL})")
    run_cfg = apply_overrides(cfg, NETFLIX_RUNS["c"] + ["sgd.epochs=1"])
    (_, again, _), = blocked.train_epochs_blocked(
        fresh_model(), train, run_cfg.sgd, True, seed=cfg.data.seed,
        device=dev)
    if not all(torch.equal(getattr(again, k), getattr(runs["c"][1], k))
               for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("(c): a second run of 1 epoch differs")
    log("[netflix] (c): a second run of 1 epoch repeats the first run's "
        "state after epoch 1 bit for bit (its pools in device memory)")
    log(f"[time] phase 22 (the netflix bias modes) "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {name: runs[run][0][key]
            for name, (run, key) in NETFLIX_LAUNCHES.items()}


def dense_form_run(bias, grp, seg, lr, reg, mu, su, si, kernel=True,
                   blocks=None, table=True):
    """``run(P, Q, bu, bi, dbu, dbi)``: the dense group ``grp`` (item
    segment ``seg``) in the given bias form through the kernel on
    ``blocks`` (ordered by the group's table, or with ``table=False`` by
    none) or through its plain version, with the frozen form's row and
    column sums of E copied into ``dbu`` / ``dbi``; returns the SSE. The
    card tests use it too."""
    from mfx_torch.kernels.dense_phase import dense_phase, dense_phase_plain

    def run(P, Q, bu, bi, dbu, dbi):
        kw = dict(su=su, si=si, bias=bias)
        if bias == "frozen":
            kw.update(bu=bu, bi=bi[seg])
        if kernel:
            out = dense_phase(P, Q[seg], grp, lr, reg, mu, **kw,
                              deps=grp["deps"] if table else None,
                              blocks=blocks)
        else:
            out = dense_phase_plain(P, Q[seg], grp, lr, reg, mu, **kw)
        if bias != "frozen":
            return out
        dbu.copy_(out[1][0])
        dbi.copy_(out[1][1])
        return out[0]
    return run


def dense_form_check(name, bias, groups, meta, state, lr, reg, mu, su, si,
                     rank, rfmt, tol=TOL, strata=DENSE_STRATA,
                     whole=DENSE_WHOLE):
    """A dense form against its plain version on the first ``strata``
    strata of group 0 (within ``tol``), then the first ``whole`` once on
    one block and twice on the card's count, bitwise. ``state`` is (P, Q,
    bu, bi). Returns (max_abs_err, ms, plain_ms, whole-run dict,
    bound)."""
    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels.dense_phase import (BIAS_FORMS, group_prefix,
                                               plan_launch)

    win0, nw = meta[0]
    seg = slice(win0 * si, (win0 + nw) * si)
    dev = state[0].device
    grp = group_prefix(groups[0], strata)

    def outs(g):
        n = g["sa"].shape[0]
        return (torch.zeros(n, su, device=dev), torch.zeros(n, si, device=dev))

    log(f"[bias] {name}: {grp['sa'].shape[0]} strata of group 0 ({rfmt}, "
        f"{su}x{si}, rank {rank}, bias={bias!r})")
    err, ms, plain_ms = compare(
        name, dense_form_run(bias, grp, seg, lr, reg, mu, su, si),
        dense_form_run(bias, grp, seg, lr, reg, mu, su, si, kernel=False),
        tuple(state) + outs(grp), tol,
        sums=(si, su) if bias == "frozen" else ())
    card = _build.load_library().mfx_dense_phase_max_blocks(
        rank, int(rfmt == "int8"), BIAS_FORMS.index(bias))

    def on_card(head):
        """One timed run of ``head`` on the card's count: events around
        the wrapper's call, host work included."""
        tabs = tuple(t.clone() for t in tuple(state) + outs(head))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dense_form_run(bias, head, seg, lr, reg, mu, su, si,
                       blocks=card)(*tabs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    # a run whose launch order is not yet worked out: the wrapper then
    # list-schedules the strata on the host between the two events
    cold = on_card(group_prefix(groups[0], whole))
    head = group_prefix(groups[0], whole)
    plan_launch(head, su, si, rank, bias)  # the launch order, untimed
    runs = whole_sweep(
        name, lambda *t: dense_form_run(bias, head, seg, lr, reg, mu, su,
                                         si, blocks=t[-1])(*t[:-1]),
        tuple(state) + outs(head), head["deps"], card, grid=card,
        unit="strata")
    reps = [on_card(head) for _ in range(DENSE_REPEATS)]
    log(f"[kernel] {name} whole: {DENSE_REPEATS} more runs on {card} blocks "
        f"(ms): {' '.join(f'{x:.4f}' for x in reps)}; with the launch order "
        f"worked out inside the timed call {cold:.4f} ms")
    runs.update({"sweep_ms_repeats": reps, "sweep_ms_order_unplanned": cold})
    return err, ms, plain_ms, runs, dense_bound([grp], su, si, rank,
                                                 frozen=bias == "frozen")


def dense_group_times(name, bias, groups, meta, state, lr, reg, mu, su, si,
                      rank):
    """Group 0 and the epoch's dense phase (every group in turn) in the
    given bias form on the card's count, from ``state`` = (P, Q, bu, bi),
    kernels only, and for the frozen form then the groups' batched bias
    updates: their times (mean of 3, tables copied in) and bounds."""
    from mfx_torch.kernels.dense_phase import dense_bias_update, dense_phase

    out = {}
    for key, grps in (("group0", list(zip(meta, groups))[:1]),
                      ("epoch_dense", list(zip(meta, groups)))):
        def run_groups(grps=grps):
            tabs = [x.clone() for x in state]
            outs = []
            for (w0, n), g in grps:
                sg = slice(w0 * si, (w0 + n) * si)
                extra = (dict(bu=tabs[2], bi=tabs[3][sg])
                         if bias == "frozen" else {})
                outs.append(dense_phase(
                    tabs[0], tabs[1][sg], g, lr, reg, mu, su=su, si=si,
                    bias=bias, deps=g["deps"], **extra))
            return tabs, outs

        run_groups()  # warm-up
        gms = cuda_ms(run_groups, reps=3)
        gb = dense_bound([g for _, g in grps], su, si, rank,
                         frozen=bias == "frozen")
        out.update({f"{key}_ms": gms, f"{key}_bound_ms": gb[0]})
        msg = ""
        if bias == "frozen" and key == "epoch_dense":
            tabs, outs = run_groups()

            def updates(tabs=tabs, outs=outs, grps=grps):
                for ((w0, n), g), (_, (dbu, dbi)) in zip(grps, outs):
                    dense_bias_update(tabs[2], tabs[3][w0 * si:(w0 + n) * si],
                                      g, dbu, dbi, lr, reg, su=su, si=si)
            out["epoch_bias_update_ms"] = cuda_ms(updates)
            msg = (f"; the groups' batched bias updates "
                   f"{out['epoch_bias_update_ms']:.4f} ms")
        log(f"[bias] {name}, {key}: {len(grps)} group(s), "
            f"{sum(g['deps'].n_tiles for _, g in grps)} strata: "
            f"{gms:.4f} ms (mean of 3, tables copied in); bound "
            f"{gb[0]:.4f} ms ({gb[1]}){msg}")
    return out


TRAIN_KERNELS = ("sgd_sweep", "sgd_sweep_tile", "sgd_sweep_step_u",
                 "sgd_sweep_epoch", "sgd_sweep_time")


BF16_KERNELS = ("sgd_sweep", "sgd_sweep_tile", "sgd_sweep_step_u",
                "sgd_sweep_epoch")


def kernel_counts(reset=False):
    """The training kernels' launch counts, the bf16 forms' again as
    '<kernel>:bf16', dense_phase's by bias form ('dense_phase:<form>') and
    those with echo > 1 again as 'dense_phase:<form>:echo'; with ``reset``
    they are set to 0 first."""
    from mfx_torch.kernels import sgd_sweep as sweeps
    from mfx_torch.kernels.dense_phase import BIAS_FORMS, dense_phase

    if reset:
        for k in TRAIN_KERNELS:
            getattr(sweeps, k).launches = 0
        for k in BF16_KERNELS:
            getattr(sweeps, k).bf16_launches = 0
        dense_phase.launches = 0
        dense_phase.form_launches = dict.fromkeys(BIAS_FORMS, 0)
        dense_phase.echo_launches = dict.fromkeys(BIAS_FORMS, 0)
    return {**{k: getattr(sweeps, k).launches for k in TRAIN_KERNELS},
            **{f"{k}:bf16": getattr(sweeps, k).bf16_launches
               for k in BF16_KERNELS},
            **{f"dense_phase:{f}": n
               for f, n in dense_phase.form_launches.items()},
            **{f"dense_phase:{f}:echo": n
               for f, n in dense_phase.echo_launches.items()}}


def expect_kernels(what, counts, want):
    """Every kernel of ``want`` launched, and no other."""
    if any(counts[k] < 1 for k in want) or any(
            n for k, n in counts.items() if k not in want):
        raise AssertionError(f"{what}: not the expected kernels "
                             f"{sorted(want)}: {counts}")


def train_runs(dev, cfg, train, test, fresh_model, runs, tag,
               every_epoch=False, last=None):
    """Each run of ``runs`` ({key: (overrides of ``cfg``, the kernels it
    launches and no other, (lo, hi) that its last held-out RMSE lies in,
    or None)}) through train_epochs_blocked from ``fresh_model()``: the
    train RMSE falls, the held-out RMSE (unclipped) ends below the
    untrained model's, the tables are finite, the peak memory is at most
    80 GB; with ``every_epoch`` the train RMSE falls every epoch and the
    held-out RMSE lies below the untrained model's after every epoch.
    Logs each epoch's seconds (plan and the first epoch's prep left out),
    the split of the median one after the first into dense, sparse and
    batched-bias time, the carving's dense_info, the peak memory and the
    RMSEs. Returns (untrained RMSE, {key: (launch counts, the model after
    the first epoch, the held-out RMSE after each epoch)}); ``last``, if
    given, takes {key: (the model after the last epoch, dense_info)}."""
    import torch

    from mfx_torch.config import apply_overrides
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.solvers import blocked

    base = rmse_mae(fresh_model(), test)[0]
    out = {}
    for key, (ov, want, window) in runs.items():
        run_cfg = apply_overrides(cfg, ov)
        kernel_counts(reset=True)
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        trains, tests, epoch_ss, parts, first = [], [], [], [], None
        seen = dict.fromkeys(("plan_s", "dense_s", "sparse_s", "bias_s"), 0.0)
        torch.cuda.synchronize()
        t_prev = time.perf_counter()
        for epoch, m, tr in blocked.train_epochs_blocked(
                fresh_model(), train, run_cfg.sgd, run_cfg.model.use_bias,
                seed=run_cfg.data.seed, device=dev, timings=timings):
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_prev
            part = {k: timings[k] - seen[k] for k in seen}
            seen = {k: timings[k] for k in seen}
            epoch_ss.append(wall - part["plan_s"]
                            - (timings["prep_s"] if epoch == 0 else 0.0))
            parts.append(part)
            trains.append(float(tr))
            tests.append(rmse_mae(m, test)[0])
            first = m if first is None else first
            t_prev = time.perf_counter()
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        mid = sorted(range(1, len(epoch_ss)), key=epoch_ss.__getitem__)[
            (len(epoch_ss) - 1) // 2]
        info = timings.get("dense_info", {})
        log(f"[{tag}] ({key}) {' '.join(ov)}: prep {timings['prep_s']:.4f} "
            f"s; dense_frac {info.get('dense_frac', 0.0):.4f} "
            f"({info.get('num_strata', 0)} strata); epoch_s "
            + " ".join(f"{x:.4f}" for x in epoch_ss)
            + f" (sum {sum(epoch_ss):.4f}; the median after the first, epoch "
            f"{mid}: " + " ".join(f"{k} {parts[mid][k]:.4f}" for k in seen)
            + f"); peak memory allocated {peak} bytes")
        if info:
            log(f"[{tag}] ({key}) dense_info {json.dumps(info)}")
        log(f"[{tag}] ({key}) train_rmse "
            + " ".join(f"{x:.5f}" for x in trains))
        log(f"[{tag}] ({key}) held-out rmse "
            + " ".join(f"{x:.5f}" for x in tests)
            + f" (untrained {base:.5f}); launches {counts}")
        expect_kernels(f"({key})", counts, want)
        falls = (any(b >= a for a, b in zip(trains, trains[1:]))
                 if every_epoch else not trains[-1] < trains[0])
        if len(trains) != run_cfg.sgd.epochs or falls:
            raise AssertionError(f"({key}): the train RMSE did not fall: "
                                 f"{trains}")
        lo, hi = window or (-float("inf"), float("inf"))
        if not (max(tests if every_epoch else tests[-1:]) < base
                and lo <= tests[-1] <= hi):
            raise AssertionError(
                f"({key}): held-out RMSE {tests} not below the untrained "
                f"{base} or outside [{lo}, {hi}] at the end")
        if peak > 80e9:
            raise AssertionError(f"({key}): peak memory {peak} above 80 GB")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if not finite or m.P.shape != (train.num_users, run_cfg.model.rank):
            raise AssertionError(f"({key}): tables not finite or mis-shaped")
        out[key] = (counts, first, tests)
        if last is not None:
            last[key] = (m, info)
    return base, out


def cli_train(preset_name, overrides, epochs):
    """python -m mfx_torch.cli train --preset ``preset_name`` with
    ``overrides`` for ``epochs`` epochs: its last line must be the
    reference's JSON, with that many epochs run."""
    t0 = time.perf_counter()
    args = [sys.executable, "-m", "mfx_torch.cli", "train", "--preset",
            preset_name]
    for o in overrides + [f"sgd.epochs={epochs}"]:
        args += ["--set", o]
    res = subprocess.run(args, capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if res.returncode == 0 and lines else {}
    if set(out) != {"preset", "epochs_run", "updates_per_sec", "test_rmse",
                    "test_mae"} or out["epochs_run"] != epochs:
        raise AssertionError(f"CLI {' '.join(args[2:])} failed:\n"
                             f"{res.stdout[-1000:]}{res.stderr[-2000:]}")
    log(f"[cli] {' '.join(args[2:])}: {lines[-1]} "
        f"({time.perf_counter() - t0:.1f} s, process and data included)")


def timesvd_driver_run(dev, cfg, again, tcoo, tag):
    """Blocked timeSVD through mfx_torch.train.driver with ``cfg`` (which
    loads ``tcoo`` from its data root and keeps a checkpoint every 2
    epochs): sgd_sweep_time launches and no other kernel, the train RMSE
    falls every epoch, the time-aware held-out RMSE (clipped, as the
    driver's) ends below the untrained model's; then ``again`` (the same
    run for 2 epochs) repeats the checkpoint after 2 epochs bit for bit.
    Returns (the driver's result, the untrained RMSE, the driver's initial
    model as a function, train split, test split, launches)."""
    import torch

    from mfx_torch.data.split import train_test_split
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers.timesvd import rmse_mae_time
    from mfx_torch.train.checkpoint import load_checkpoint
    from mfx_torch.train.driver import train as drive

    tc = cfg.timesvd
    train, test = train_test_split(tcoo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    U, I, rank = tcoo.num_users, tcoo.num_items, cfg.model.rank

    def fresh_model():  # the driver's initial model
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale)

    feats = fit_time_features(train, n_bins=tc.n_bins, beta=tc.beta)
    base, _ = rmse_mae_time(
        init_timesvd(None, U, I, rank, tc.n_bins, base=fresh_model()), feats,
        test, clip=(0.5, 5.0))
    kernel_counts(reset=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = drive(cfg, device=dev, resume=False)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    trains = [x["train_metric"] for x in res.history]
    epoch_s = [x["epoch_s"] for x in res.history]
    log(f"[{tag}] driver: solver='timesvd' kernel='pallas', rank {rank}, "
        f"{tc.n_bins} bins, lr {tc.lr} decay {tc.lr_decay} reg {tc.reg} = "
        f"reg_alpha: {res.epochs_run} epochs in {wall:.1f} s (load, split, "
        f"features, plan and evals included); epoch_s first {epoch_s[0]} "
        f"median of the others {sorted(epoch_s[1:])[len(epoch_s[1:]) // 2]} "
        f"(the driver's, without the eval); launches {counts}; peak memory "
        f"allocated {torch.cuda.max_memory_allocated(dev)} bytes")
    log(f"[{tag}] train_rmse " + " ".join(f"{x:.5f}" for x in trains))
    log(f"[{tag}] held-out time-aware rmse " + " ".join(
        f"{x['test_rmse']:.5f}" for x in res.history)
        + f" (untrained {base:.5f}, clipped as the driver's)")
    expect_kernels(tag, counts, {"sgd_sweep_time"})
    if len(trains) != tc.epochs or any(b >= a for a, b in
                                       zip(trains, trains[1:])):
        raise AssertionError(f"{tag}: the train RMSE did not fall every "
                             f"epoch: {trains}")
    if not res.test_rmse < base:
        raise AssertionError(f"{tag}: held-out {res.test_rmse} not below the "
                             f"untrained {base}")
    after2, step, _ = load_checkpoint(cfg.checkpoint_dir, step=1, device=dev)
    rerun = drive(again, device=dev, resume=False)
    if step != 1 or not all(torch.equal(getattr(rerun.model, k),
                                        getattr(after2, k))
                            for k in ("P", "Q", "bu", "bi")):
        raise AssertionError(f"{tag}: a second run of 2 epochs differs from "
                             "the first run's state after 2 epochs")
    log(f"[{tag}] a second run of 2 epochs repeats the first run's state "
        "after 2 epochs (its checkpoint) bit for bit")
    return res, base, fresh_model, train, test, counts["sgd_sweep_time"]


def bias_form_phases(dev, cfg, train, test, fresh_model, trained, lane_rmse,
                     results, bounds, sweeps, data_root):
    """Phases 17 and 18: the epoch form of sgd_sweep_tile.cu and the
    frozen and bias-free forms of dense_phase.cu against their plain
    versions at the ml25m_rank64 cell's shapes (phase 4's data and plan,
    the tables of the model ``trained`` there), then the preset's 2
    epochs in each bias mode through the trainer and mode (a) through the
    CLI (on the dataset's cache under ``data_root``, phase 23's). Fills
    ``results``, ``bounds`` and ``sweeps`` under
    sgd_sweep_epoch and dense_phase_frozen and returns their launches,
    from the run of mode (a)."""
    import torch

    from mfx_torch.config import apply_overrides
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.packing import plain_tables
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep_epoch,
                                             sgd_sweep_epoch_plain,
                                             sgd_sweep_tile)
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    sgd, seed = cfg.sgd, cfg.data.seed
    U, I, rank = train.num_users, train.num_items, cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG
    mu, lr, reg = float(train.global_mean), sgd.lr, sgd.reg
    lib = _build.load_library()

    # 17. the new forms against their plain versions
    t_phase = time.perf_counter()
    rfmt = blocked.dense_rfmt(sgd, rank, train.rating)
    u0, i0, r0 = (torch.as_tensor(x).to(dev) for x in
                  (train.user, train.item, train.rating))
    meta, groups, (u, i, r), info = prepare_dense_full(
        u0.int(), i0.int(), r0.float(), U, I, su, si, chi_min=sgd.dense_chi,
        nwd=blocked.dense_group_windows(rank, si), rfmt=rfmt)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl, d, _, _ = pdv.epoch_tiles_device(skel, u, i, r, seed, 0,
                                         with_slots=True)
    state = plain_tables(trained, su, si, dev)
    if not float(state[2].abs().max()) > 0:
        raise AssertionError("phase 4's model has no biases to freeze")
    log(f"[bias] cell: ml25m_rank64's data and plan (phase 4; {rfmt}, "
        f"dense_frac {info['dense_frac']:.4f}, {info['num_strata']} strata, "
        f"{tl.shape[0]} tiles, {d.shape[0]} sparse ratings) on the tables "
        f"phase 4 trained (biases up to {float(state[2].abs().max()):.4f})")
    sw = next(x for x in skel.sweeps if x.t1 > x.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls, deps = tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt)
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    kw = dict(su=su, si=si, tpg=tpg)
    log(f"[bias] sgd_sweep_epoch: {nt} tiles of the first sweep (T={T}, "
        f"rank {rank}); critical path {deps.critical} tiles")
    results["sgd_sweep_epoch"] = compare(
        "sgd_sweep_epoch",
        lambda P, Q, bu, bi, e: sgd_sweep_epoch(
            P, Q[seg_s], bu, bi[seg_s], sa, tc, tls, e, lr, reg, mu, **kw,
            deps=deps),
        lambda P, Q, bu, bi, e: sgd_sweep_epoch_plain(
            P, Q[seg_s], bu, bi[seg_s], sa, tc, tls, e, lr, reg, mu, **kw),
        tuple(state) + (torch.zeros(nt, T, device=dev),))
    # the tile form on the same tiles and tables, in this run
    tabs = [x.clone() for x in state]
    tile_ms = cuda_ms(lambda: sgd_sweep_tile(
        tabs[0], tabs[1][seg_s], tabs[2], tabs[3][seg_s], sa, tc, tls, lr,
        reg, mu, **kw, deps=deps), reps=3)
    del tabs
    # the factor rows as the tile form counts them, the biases read only,
    # and the residual a slot writes
    bounds["sgd_sweep_epoch"] = sweep_bound(
        tls, sa, tc, su, si, tpg, rank, [("P", 0), ("Q", 1)], 10,
        bias="read", slot_bytes=4)
    log(f"[bias] sgd_sweep_epoch: {results['sgd_sweep_epoch'][1]:.4f} ms, "
        f"sgd_sweep_tile on the same tiles {tile_ms:.4f} ms; bound "
        f"{bounds['sgd_sweep_epoch'][0]:.4f} ms "
        f"({bounds['sgd_sweep_epoch'][1]})")
    sweeps["sgd_sweep_epoch"] = whole_sweep(
        "sgd_sweep_epoch",
        lambda P, Q, bu, bi, e, blocks: sgd_sweep_epoch(
            P, Q[seg_s], bu, bi[seg_s], sw.sa, sw.tc, tl[sw.t0:sw.t1], e, lr,
            reg, mu, **kw, deps=sw.deps, blocks=blocks),
        tuple(state) + (torch.zeros(sw.t1 - sw.t0, T, device=dev),),
        sw.deps, lib.mfx_sgd_sweep_tile_max_blocks(T, rank))
    whole_b = sweep_bound(tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                          [("P", 0), ("Q", 1)], 10, bias="read",
                          slot_bytes=4)
    sweeps["sgd_sweep_epoch"].update({"sweep_bound_ms": whole_b[0],
                                      "tile_form_ms": tile_ms})

    # the dense forms at int4, rank 64, on group 0
    variants = []
    for bias in ("frozen", "none"):
        name = "dense_phase_frozen" if bias == "frozen" else "dense_phase_none"
        err, ms, plain_ms, whole, b = dense_form_check(
            name, bias, groups, meta, state, lr, reg, mu, su, si, rank, rfmt)
        whole.update(dense_group_times(name, bias, groups, meta, state, lr,
                                       reg, mu, su, si, rank))
        if bias == "frozen":
            results[name], bounds[name] = (err, ms, plain_ms), b
            sweeps[name] = whole
        else:
            variants.append({"variant": "no biases, int4, rank 64",
                             "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b[0],
                             "bound_by": b[1], **whole})
    del groups, skel, tl, d, u, i, r
    torch.cuda.empty_cache()
    # the frozen form's int8 instances at the netflix cell's blocks (su =
    # si = 512) on this data carved with int8 codes: no path runs them
    for rk in (64, 128):
        meta5, groups5, _, _ = prepare_dense_full(
            u0.int(), i0.int(), r0.float(), U, I, 512, 512,
            chi_min=sgd.dense_chi, nwd=blocked.dense_group_windows(rk, 512),
            rfmt="int8")
        if rk == rank:
            tabs5 = plain_tables(trained, 512, 512, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(rk)
            m5 = init_model(g, U, I, rk, global_mean=train.global_mean,
                            device=dev)
            m5.bu.copy_(torch.randn(U, device=dev, generator=g) * 0.1)
            m5.bi.copy_(torch.randn(I, device=dev, generator=g) * 0.1)
            tabs5 = plain_tables(m5, 512, 512, dev)
        err, ms, plain_ms, whole, b = dense_form_check(
            f"dense_phase_frozen int8 rank {rk}", "frozen", groups5, meta5,
            tabs5, lr, reg, mu, 512, 512, rk, "int8")
        variants.append({"variant": f"frozen biases, int8, rank {rk}, su = "
                                    "si = 512", "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
                         "bound_by": b[1], **whole})
        del meta5, groups5, tabs5
        torch.cuda.empty_cache()
    sweeps["dense_phase_frozen"]["variants"] = variants
    del u0, i0, r0, state
    log(f"[time] phase 17 {time.perf_counter() - t_phase:.1f} s")

    # 18. the three modes at full width, through the trainer
    t_phase = time.perf_counter()
    near_lane = (lane_rmse - 0.03, lane_rmse + 0.03)
    _, runs = train_runs(dev, cfg, train, test, fresh_model, {
        "a": (["sgd.bias_mode=epoch", "sgd.epochs=2"],
              {"sgd_sweep_epoch", "dense_phase:frozen"}, near_lane),
        "b": (["sgd.bias_mode=tile", "sgd.epochs=2"],
              {"sgd_sweep_tile", "dense_phase:frozen"}, near_lane),
        "c": (["model.use_bias=false", "sgd.epochs=2"],
              {"sgd_sweep_tile", "dense_phase:none"}, None)}, "bias")
    counts, after1, _ = runs["a"]
    launches = {"sgd_sweep_epoch": counts["sgd_sweep_epoch"],
                "dense_phase_frozen": counts["dense_phase:frozen"]}
    run_cfg = apply_overrides(cfg, ["sgd.bias_mode=epoch", "sgd.epochs=1"])
    (_, again, _), = blocked.train_epochs_blocked(
        fresh_model(), train, run_cfg.sgd, True, seed=seed, device=dev)
    if not all(torch.equal(getattr(again, k), getattr(after1, k))
               for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("(a): a second run of 1 epoch differs")
    log("[bias] (a): a second run of 1 epoch repeats the first run's state "
        "after epoch 1 bit for bit")
    cli_train("ml25m_rank64", ["sgd.bias_mode=epoch", "data.dataset=ml-25m",
                               f"data.root={data_root}"], 1)
    log(f"[time] phase 18 {time.perf_counter() - t_phase:.1f} s")
    return launches


def java_parity_phase(dev):
    """Phase 13: the minibatch trainer with batch_size = 1 on the card
    against the float64 sequential oracle (the Java rule); conflict-free
    rounds chunk-invariant; a second run bitwise equal."""
    import numpy as np
    import torch

    from mfx_torch.config import SGDConfig
    from mfx_torch.convert import model_from_numpy
    from mfx_torch.data.split import epoch_permutation
    from mfx_torch.data.synthetic import make_synthetic
    from mfx_torch.oracle import (init_oracle_from_arrays,
                                  train_epoch_sequential)
    from mfx_torch.solvers.sgd import train_epochs

    t_phase = time.perf_counter()
    coo = make_synthetic(*JAVA_SHAPE, rank=4, seed=105)
    U, I, rank = coo.num_users, coo.num_items, 8
    rng = np.random.default_rng(105)
    arrays = {"P": rng.normal(size=(U, rank)) / np.sqrt(rank),
              "Q": rng.normal(size=(I, rank)) / np.sqrt(rank),
              "bu": np.zeros(U), "bi": np.zeros(I),
              "mu": np.float32(coo.global_mean)}
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    keys = ("P", "Q", "bu", "bi")

    def run(**kw):
        cfg = SGDConfig(epochs=2, **kw)
        model = model_from_numpy(arrays, device=dev)
        for _, model, _ in train_epochs(model, coo, cfg, use_bias=True,
                                        seed=0):
            pass
        return model

    seq = dict(lr=0.02, reg=0.05, batch_size=1, partitioner="fixed")
    t0 = time.perf_counter()
    model = run(**seq)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    oracle = init_oracle_from_arrays(*(arrays[k] for k in keys),
                                     float(arrays["mu"]))
    for epoch in range(2):
        train_epoch_sequential(oracle, coo,
                               epoch_permutation(coo.n_ratings, 0, epoch),
                               lr=seq["lr"], reg=seq["reg"])
    err = max(float(np.abs(getattr(model, k).cpu().numpy()
                           - getattr(oracle, k)).max()) for k in keys)
    log(f"[java] {coo.n_ratings} ratings ({U} x {I}, seed 105), rank "
        f"{rank}, batch_size 1, 2 epochs ({2 * coo.n_ratings} batches) on "
        f"the card in {card_s:.2f} s: max |table - float64 oracle| "
        f"{err:.3e} (tolerance {JAVA_TOL})")
    if not err <= JAVA_TOL:
        raise AssertionError(f"Java parity: {err} > {JAVA_TOL}")
    again = run(**seq)
    if not all(torch.equal(getattr(again, k), getattr(model, k))
               for k in keys):
        raise AssertionError("Java parity: a second run differs")
    chunked = [run(lr=0.03, reg=0.02, batch_size=bs,
                   partitioner="conflict_free") for bs in (32, 128)]
    if not all(torch.equal(getattr(chunked[0], k), getattr(chunked[1], k))
               for k in keys):
        raise AssertionError("conflict-free batches of 32 and 128 differ")
    log("[java] a second run bitwise equal; conflict-free batches of 32 "
        "and 128 give bitwise-equal tables")
    log(f"[time] phase 13 {time.perf_counter() - t_phase:.1f} s")


def ml100k_phase(dev):
    """Phase 14: the ml100k_rank16 preset unchanged through the driver,
    resume, the CLI's update and recommend (tile_topk launched, then held
    against its plain version on the inputs recommend gave it). Returns
    tile_topk's launches in recommend and that check's record."""
    import contextlib
    import io
    import shutil
    import tempfile
    import warnings
    from pathlib import Path

    import numpy as np
    import torch

    from mfx_torch import cli
    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.coo import RatingsCOO
    from mfx_torch.data.loaders import load_dataset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels.serve_topk import tile_topk
    from mfx_torch.models.mf import init_model
    from mfx_torch.serve import fused
    from mfx_torch.solvers import sgd
    from mfx_torch.train.driver import train as drive

    t_phase = time.perf_counter()
    cfg = preset("ml100k_rank16")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded synthetic stand-in
        coo = load_dataset(cfg.data.dataset, cache=False)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    clip = (0.5, 5.0) if cfg.clip_predictions else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.model.seed)
    m0 = init_model(gen, coo.num_users, coo.num_items, cfg.model.rank,
                    global_mean=train.global_mean)
    base = rmse_mae(m0, test, clip=clip)
    log(f"[ml100k] {coo.num_users} x {coo.num_items}, {coo.n_ratings} "
        f"ratings ({train.n_ratings} train / {test.n_ratings} test); "
        f"untrained held-out RMSE {base[0]:.5f} MAE {base[1]:.5f}")

    # one epoch apart: the plan on the host, then its batches through the
    # step dispatched op by op and replayed as a CUDA graph (the trainer's
    # form on the card), bitwise equal, with the host syncs of each
    t0 = time.perf_counter()
    plan = sgd.plan_epoch(train, cfg.sgd, cfg.data.seed, 0, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    nb = plan.num_batches
    real = int((plan.batches["weights"] > 0).sum())
    log(f"[ml100k] epoch 0 plan: {nb} batches of {plan.batch_size} slots, "
        f"{real} real ratings ({real / (nb * plan.batch_size):.4%} of the "
        f"slots), planned and uploaded in {plan_s:.3f} s on the host")
    fns = {"eager": sgd.make_epoch_fn(cfg.sgd, cfg.model.use_bias,
                                      graph=False),
           "graph": sgd.make_epoch_fn(cfg.sgd, cfg.model.use_bias)}
    out = {}
    for name, fn in fns.items():
        first_s = None
        if name == "graph":  # warm-up: the graph's capture
            t0 = time.perf_counter()
            fn(m0, plan, cfg.sgd.lr)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        m1, sse = fn(m0, plan, cfg.sgd.lr)
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
        dev_ms = start.elapsed_time(end)
        out[name] = (m1, float(sse))
        log(f"[ml100k] one epoch, {name}: {dev_ms:.1f} ms on the card "
            f"({dev_ms / nb * 1e3:.1f} us a batch), {host_s:.3f} s to dispatch "
            f"on the host ("
            + ("its first call" if first_s is None else
               f"after a first call of {first_s:.3f} s") + ")")
    # the trainer's form makes no host sync inside an epoch: any would
    # raise here
    torch.cuda.set_sync_debug_mode("error")
    try:
        fns["graph"](m0, plan, cfg.sgd.lr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[ml100k] a whole graph-replayed epoch under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")
    (me, se), (mg, sg) = out["eager"], out["graph"]
    if se != sg or not all(torch.equal(getattr(me, k), getattr(mg, k))
                           for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("graph replay and eager loop differ")
    log(f"[ml100k] graph replay == eager loop, tables and sse ({sg:.3f}) "
        "bitwise")
    # the device time of the step by kernel, over the plan's first batches
    from torch.profiler import ProfilerActivity, profile

    head = sgd.EpochPlan({k: v[:PROFILE_BATCHES]
                          for k, v in plan.batches.items()}, real)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fns["graph"](m0, head, cfg.sgd.lr)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_time_total", 0) > 0 and e.device_type.name
           == "CUDA"]
    total = sum(e.device_time_total for e in evs)
    top = sorted(evs, key=lambda e: -e.device_time_total)[:6]
    log(f"[ml100k] profile of {PROFILE_BATCHES} graph-replayed batches: "
        f"{total / PROFILE_BATCHES:.1f} us of kernels a batch; "
        + "; ".join(f"{e.key[:60]} x{e.count // PROFILE_BATCHES} "
                    f"{e.device_time_total / PROFILE_BATCHES:.1f} us"
                    for e in top))

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        run_cfg = apply_overrides(cfg, [
            f"log_path={tmp / 'log.jsonl'}", f"checkpoint_dir={tmp / 'ck'}",
            f"checkpoint_every={ML100K_RESUME}"])
        t0 = time.perf_counter()
        res = drive(run_cfg, device=dev)
        wall = time.perf_counter() - t0
        hist = res.history
        trains = [h["train_metric"] for h in hist]
        epoch_s = sorted(h["epoch_s"] for h in hist)
        log(f"[ml100k] driver: {res.epochs_run} epochs in {wall:.1f} s, "
            f"epoch_s median {epoch_s[len(epoch_s) // 2]:.3f} (min "
            f"{epoch_s[0]:.3f}, max {epoch_s[-1]:.3f}), "
            f"{res.updates_per_sec:.0f} updates/s in the last; train RMSE "
            f"{trains[0]:.5f} -> {trains[-1]:.5f}; held-out RMSE "
            f"{res.test_rmse:.5f} MAE {res.test_mae:.5f}")
        if res.epochs_run != cfg.sgd.epochs:
            raise AssertionError(f"{res.epochs_run} epochs run")
        if any(b >= a for a, b in zip(trains, trains[1:])):
            raise AssertionError(f"train RMSE did not fall: {trains}")
        if not res.test_rmse < base[0] or not res.test_rmse <= ML100K_GATE:
            raise AssertionError(
                f"held-out RMSE {res.test_rmse} (untrained {base[0]}, gate "
                f"{ML100K_GATE})")
        recs = (tmp / "log.jsonl").read_text().splitlines()
        if [json.loads(x)["epoch"] for x in recs] != list(range(30)):
            raise AssertionError("the JSONL log is not one record an epoch")
        fin = [getattr(res.model, k) for k in ("P", "Q", "bu", "bi")]
        if not all(bool(torch.isfinite(t).all()) for t in fin):
            raise AssertionError("model tables not finite")

        # resume from the checkpoint of epoch ML100K_RESUME - 1
        last = ML100K_RESUME - 1
        (tmp / "ck2").mkdir()
        shutil.copy(tmp / "ck" / f"{last}.npz", tmp / "ck2" / f"{last}.npz")
        t0 = time.perf_counter()
        res2 = drive(apply_overrides(run_cfg, [
            f"checkpoint_dir={tmp / 'ck2'}", f"log_path={tmp / 'log2.jsonl'}"
        ]), device=dev)
        if ([h["epoch"] for h in res2.history]
                != list(range(ML100K_RESUME, cfg.sgd.epochs))):
            raise AssertionError(f"the resumed run did not start at epoch "
                                 f"{ML100K_RESUME}")
        if not all(torch.equal(getattr(res2.model, k), t)
                   for k, t in zip(("P", "Q", "bu", "bi"), fin)):
            raise AssertionError("the resumed run differs from the unbroken")
        log(f"[ml100k] resumed from the epoch-{last} checkpoint: epochs "
            f"{ML100K_RESUME}-{cfg.sgd.epochs - 1} in "
            f"{time.perf_counter() - t0:.1f} s, tables bitwise those of the "
            "unbroken run")

        # the CLI's update with a seeded delta, then recommend
        rng = np.random.default_rng(106)
        U, I = coo.num_users, coo.num_items
        n = 2000
        du = rng.integers(0, U + 10, n).astype(np.int32)
        di = rng.integers(0, I + 10, n).astype(np.int32)
        du[:10] = np.arange(U, U + 10)
        di[10:20] = np.arange(I, I + 10)
        dr = rng.integers(1, 6, n).astype(np.float32)
        RatingsCOO(user=du, item=di, rating=dr, num_users=U + 10,
                   num_items=I + 10).save_npz(tmp / "delta.npz")

        def cli_run(args):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(args) != 0:
                    raise AssertionError(f"cli {args[0]} failed")
            return buf.getvalue().strip().splitlines()

        t0 = time.perf_counter()
        out = json.loads(cli_run([
            "update", "--checkpoint", str(tmp / "ck"), "--delta",
            str(tmp / "delta.npz"), "--device", dev.type])[-1])
        if (out["grew_users"], out["grew_items"], out["step"]) != (10, 10, 30):
            raise AssertionError(f"update: {out}")
        log(f"[ml100k] CLI update in {time.perf_counter() - t0:.2f} s: {out}")
        # the kernel's inputs as the recommender hands them over, kept
        # for the check against its plain version below
        calls = []

        def keep(P_aug, Q_aug, **kw):
            calls.append((P_aug.clone(), Q_aug.clone(), kw))
            return tile_topk(P_aug, Q_aug, **kw)

        tile_topk.launches = 0
        fused.tile_topk = keep
        t0 = time.perf_counter()
        try:
            lines = cli_run(["recommend", "--checkpoint", str(tmp / "ck"),
                             "--users", f"0,1,{U + 9}", "--fused", "--tile",
                             "128", "--device", dev.type])
        finally:
            fused.tile_topk = tile_topk
        rec_s = time.perf_counter() - t0
        launches = tile_topk.launches
        recs = [json.loads(x) for x in lines]
        if len(recs) != 3 or any(len(r["items"]) != K for r in recs) or any(
                max(r["items"]) >= I + 10 for r in recs):
            raise AssertionError(f"CLI recommend: {lines}")
        if launches < 1:
            raise AssertionError("recommend never launched tile_topk")
        log(f"[ml100k] CLI recommend --fused --tile 128 on the updated "
            f"checkpoint ({U + 10} x {I + 10}): 3 users in {rec_s:.2f} s, "
            f"launches {{'tile_topk': {launches}}}")
        # each of those launches again on the same inputs, held against
        # the plain version (these launches are not counted above)
        err = 0.0
        for P_aug, Q_aug, kw in calls:
            got = tile_topk(P_aug, Q_aug, **kw)
            e, swaps, gap = hold_topk("tile_topk (recommend)", got, P_aug,
                                      Q_aug, kw.get("sb"), kw["tile"],
                                      kw["depth"])
            err = max(err, e)
            log(f"[kernel] tile_topk at recommend's shapes: P_aug "
                f"{tuple(P_aug.shape)} {P_aug.dtype}, Q_aug "
                f"{tuple(Q_aug.shape)}, tile {kw['tile']}, depth "
                f"{kw['depth']}: max_abs_err={e:.3e} (tol {TOL}), lane swaps "
                f"{swaps} (gap <= {gap:.3e}); launches on the path "
                f"{launches}")
    log(f"[time] phase 14 {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": err,
            "P_aug": list(calls[0][0].shape), "Q_aug": list(calls[0][1].shape),
            "tile": calls[0][2]["tile"], "depth": calls[0][2]["depth"]}


def temporal(coo, seed, n_bins=TIME_BINS):
    """``coo`` with seeded timestamps in [0, 1e6), each rating shifted by a
    N(0, TIME_SHIFT) draw of its (item, calendar bin) on ``n_bins`` bins,
    and clipped to [0.5, 5]. The JAX package's dataset classes take it
    too: ``tools/timesvd_recipe_check.py`` and the card tests use it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 1_000_000, coo.n_ratings)
    shift = rng.normal(0, TIME_SHIFT, (coo.num_items, n_bins)).astype(
        np.float32)
    r = coo.rating + shift[coo.item, ts * n_bins // 1_000_000]
    return dataclasses.replace(
        coo, rating=np.clip(r, 0.5, 5.0).astype(np.float32),
        timestamp=ts.astype(np.int64))


def timesvd_config(root, *extra):
    """The phase-16 configuration: ml25m_rank64's model and data with
    solver='timesvd', timesvd.kernel='pallas', TimeSVDConfig's defaults but
    reg_alpha = reg, the dataset read from ``root``, no early stop."""
    from mfx_torch.config import TimeSVDConfig, apply_overrides, preset

    reg = TimeSVDConfig().reg
    cfg = apply_overrides(preset("ml25m_rank64"), [
        "solver=timesvd", "timesvd.kernel=pallas", f"timesvd.reg_alpha={reg}",
        f"data.root={root}", *extra])
    return dataclasses.replace(cfg, target_rmse=None)


def time_kernel_phase(dev, tcoo, results, bounds, sweeps):
    """Phase 15: sgd_sweep_time (ranks 64 and 128) against its plain
    version on the first sweep of epoch 0 of the temporal ML-25M-shaped
    synthetic ``tcoo``, at the blocked timeSVD trainer's shapes. Fills
    ``results``, ``bounds`` and ``sweeps`` under sgd_sweep_time."""
    import torch

    from mfx_torch.data.split import train_test_split
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.packing import pad_rows, to_tlane_model
    from mfx_torch.kernels.sgd_sweep import (sgd_sweep, sgd_sweep_plain,
                                             sgd_sweep_time)
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.blocked import TPG, sweep_geometry

    t_phase = time.perf_counter()
    cfg = timesvd_config(None)
    tc, seed = cfg.timesvd, cfg.data.seed
    train, _ = train_test_split(tcoo, cfg.data.test_frac, seed=seed)
    U, I, nb = tcoo.num_users, tcoo.num_items, tc.n_bins
    su = si = tsb.BLOCK
    T, tpg, lr, reg = tsb.TILE, TPG, tc.lr, tc.reg
    mu = float(train.global_mean)
    feats = fit_time_features(train, n_bins=nb, beta=tc.beta)
    tb, dv = feats.features(train.user, train.timestamp)
    plan = tsb.build_temporal_plan_skeleton(
        train, tb, dv, su=su, si=si, tile=T, tpg=tpg,
        nwin=sweep_geometry(I, cfg.model.rank, si), device=dev)
    tl, sws = tsb.plan_temporal_epoch_device(*plan, seed, 0)
    log(f"[time] cell: blocked timeSVD (rank {cfg.model.rank}, {nb} bins, "
        f"su = si = {su}, T = {T}, tpg {tpg}, lr {lr}, reg {reg}) on the "
        f"ML-25M-shaped synthetic made temporal ({train.n_ratings} train "
        f"ratings); {len(sws)} sweep(s) of {[s.t1 - s.t0 for s in sws]} "
        f"tiles, critical paths {[s.deps.critical for s in sws]}; data, "
        f"features and plan in {time.perf_counter() - t_phase:.1f} s")
    lib = _build.load_library()

    def tables(rank):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        base = init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)
        lane = to_tlane_model(init_timesvd(None, U, I, rank, nb, base=base),
                              nb)
        return pad_rows(lane.P, su), pad_rows(lane.Q, si)

    sw = sws[0]
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tcs = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    deps = sw.deps.prefix(nt)
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    kw = dict(su=su, si=si, tpg=tpg, n_bins=nb)
    whole = {}
    for rank, name in ((64, "sgd_sweep_time"), (128, "sgd_sweep_time_r128")):
        P, Q = tables(rank)
        log(f"[kernel] {name}: {nt} tiles of the first sweep (T={T}, rank "
            f"{rank}, {nb} bins); they hold {deps.runs.shape[0]} runs, "
            f"critical path {deps.critical} tiles")
        res = compare(
            name,
            lambda Pt, Qt: sgd_sweep_time(Pt, Qt[seg], sa, tcs, tls, lr, reg,
                                          mu, **kw, deps=deps),
            lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], sa, tcs, tls, lr,
                                           reg, mu, **kw),
            (P, Q))
        # the stream's 5 rows are read once
        bnd = sweep_bound(tls, sa, tcs, su, si, tpg, rank,
                          [("P", 0), ("Q", 1)], None,
                          slot_ops=time_slot_ops(rank, nb))
        card = lib.mfx_sgd_sweep_time_max_blocks(T, rank)
        # the lane form on the same tiles (rows 0-2) and tables: what the
        # two stream rows, the injections and the kept lanes cost
        tl3 = tls[:, :3].contiguous()
        Pt, Qt = P.clone(), Q.clone()
        lane_ms = cuda_ms(lambda: sgd_sweep(Pt, Qt[seg], sa, tcs, tl3, lr,
                                            reg, mu, su=su, si=si, tpg=tpg,
                                            deps=deps), reps=3)
        del Pt, Qt
        log(f"[kernel] {name}: the lane form (sgd_sweep) on the same "
            f"{nt} tiles {lane_ms:.4f} ms")
        if rank == 64:
            results[name], bounds[name] = res, bnd
            whole = whole_sweep(
                name,
                lambda Pt, Qt, blocks: sgd_sweep_time(
                    Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
                    **kw, deps=sw.deps, blocks=blocks),
                (P, Q), sw.deps, card)
            whole["sweep_bound_ms"], whole["sweep_bound_by"] = sweep_bound(
                tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                [("P", 0), ("Q", 1)], None,
                slot_ops=time_slot_ops(rank, nb))
            whole["lane_form_ms"] = lane_ms
        else:
            # no path runs the rank-128 form: its numbers go in the rank-64
            # entry, with the whole sweep on 1 block and the card's count
            again = whole_sweep(
                name,
                lambda Pt, Qt, blocks: sgd_sweep_time(
                    Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
                    **kw, deps=sw.deps, blocks=blocks),
                (P, Q), sw.deps, card)
            whole["r128"] = {"tiles": nt, "max_abs_err": res[0],
                             "ms": res[1], "plain_ms": res[2],
                             "lane_form_ms": lane_ms,
                             "bound_ms": bnd[0], "bound_by": bnd[1],
                             **again}
        log(f"[kernel] {name} bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"{time_slot_ops(rank, nb)} operations a real slot)")
        del P, Q
    log(f"[kernel] sgd_sweep_time whole sweep bound "
        f"{whole['sweep_bound_ms']:.4f} ms ({whole['sweep_bound_by']})")
    sweeps["sgd_sweep_time"] = whole
    del plan, tl, sws
    torch.cuda.empty_cache()
    log(f"[time] phase 15 {time.perf_counter() - t_phase:.1f} s")


def time_path_phase(dev, tcoo):
    """Phase 16: blocked timeSVD through the driver on ``tcoo`` (the
    loader's synthetic cache under a data root in build/), its gates
    against the untrained model and lane MF, a 2-epoch repeat; then the
    minibatch timeSVD trainer through the driver on the temporal ML-1M
    synthetic. Returns the time form's launches in the first run and the
    data root, which holds both datasets' caches for phase 30."""
    import shutil

    import torch

    from mfx_torch.config import SGDConfig, apply_overrides, preset
    from mfx_torch.data.loaders import GENERATOR_VERSION
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.timesvd import rmse_mae_time, train_epochs_timesvd
    from mfx_torch.train.driver import train as drive

    t_phase = time.perf_counter()
    root = _build.BUILD_DIR.parent / "chip_smoke_timesvd"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tcoo.save_npz(root / f"ml-25m.v{GENERATOR_VERSION}.synthetic.npz")
    cfg = timesvd_config(root, f"checkpoint_dir={root / 'ckpt'}",
                         "checkpoint_every=2",
                         f"timesvd.epochs={TIME_PATH_EPOCHS}")
    tc, seed, clip = cfg.timesvd, cfg.data.seed, (0.5, 5.0)
    log(f"[time] path: {tc.epochs} of TimeSVDConfig's 20 epochs, su = si "
        f"= {tsb.BLOCK}, T = {tsb.TILE}")
    res, base_rmse, fresh_model, train, test, launches = timesvd_driver_run(
        dev, cfg, timesvd_config(root, "timesvd.epochs=2"), tcoo, "time")

    # lane-biased MF: the same storage rank, blocks, epochs, lr and reg on
    # the same split, through sgd_sweep with no dense phase
    mf_cfg = SGDConfig(
        lr=tc.lr, reg=tc.reg, lr_decay=tc.lr_decay, epochs=tc.epochs,
        partitioner="blocked", kernel="pallas", ublock=tsb.BLOCK,
        iblock=tsb.BLOCK, tile=tsb.TILE, bias_mode="lane", dense_chi=0,
        plan_device="device")
    for _, mf, _ in blocked.train_epochs_blocked(fresh_model(), train, mf_cfg,
                                                 True, seed=seed, device=dev):
        pass
    mf_rmse, _ = rmse_mae(mf, test, clip=clip)
    log(f"[time] held-out RMSE: timeSVD (time-aware) {res.test_rmse:.5f}, "
        f"lane MF {mf_rmse:.5f}, untrained {base_rmse:.5f}")
    if not res.test_rmse < min(mf_rmse, base_rmse):
        raise AssertionError(
            f"timesvd: held-out {res.test_rmse} not below lane MF's "
            f"{mf_rmse} and the untrained {base_rmse}")
    del mf
    t1 = time.perf_counter()

    # the minibatch trainer (timesvd.kernel='jnp') on the temporal ML-1M
    coo1 = temporal(make_synthetic(*ML1M_SHAPE, rank=32, seed=101,
                                   star_step=1.0, user_zipf_s=0.6), 101)
    coo1.save_npz(root / f"ml-1m.v{GENERATOR_VERSION}.synthetic.npz")
    cfg1 = apply_overrides(preset("ml1m_rank32_biased"), [
        "solver=timesvd", "timesvd.dup_trust=16",
        f"timesvd.epochs={JNP_TIME_EPOCHS}", f"data.root={root}"])
    res1 = drive(cfg1, device=dev, resume=False)
    trains1 = [r["train_metric"] for r in res1.history]
    tr1, te1 = train_test_split(coo1, cfg1.data.test_frac,
                                seed=cfg1.data.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg1.model.seed)
    m1 = init_model(g, coo1.num_users, coo1.num_items, cfg1.model.rank,
                    global_mean=tr1.global_mean,
                    init_scale=cfg1.model.init_scale)
    feats1 = fit_time_features(tr1, n_bins=cfg1.timesvd.n_bins,
                               beta=cfg1.timesvd.beta)
    *_, (_, ts1, _) = train_epochs_timesvd(m1, tr1, cfg1.timesvd,
                                           seed=cfg1.data.seed, feats=feats1)
    want = rmse_mae_time(ts1, feats1, te1, clip=clip)
    static, _ = rmse_mae(res1.model, te1, clip=clip)
    log(f"[time] jnp (ML-1M-shaped, dup_trust 16): {res1.epochs_run} epochs; "
        f"train_rmse " + " ".join(f"{x:.5f}" for x in trains1))
    log(f"[time] jnp: held-out time-aware RMSE {res1.test_rmse:.5f} (the "
        f"trainer's model through rmse_mae_time: {want[0]:.5f}; the MF view "
        f"at the end of the train window: {static:.5f}); "
        f"{time.perf_counter() - t1:.1f} s")
    if any(b >= a for a, b in zip(trains1, trains1[1:])):
        raise AssertionError(f"timesvd jnp: the train RMSE did not fall "
                             f"every epoch: {trains1}")
    if (res1.test_rmse, res1.test_mae) != want:
        raise AssertionError(f"timesvd jnp: the driver's eval "
                             f"{res1.test_rmse} is not the time-aware one "
                             f"{want}")
    log(f"[time] phase 16 {time.perf_counter() - t_phase:.1f} s")
    return launches, root


# the rank-32 runs of ml1m_rank32_biased (phase 20): the overrides of each,
# the kernels it launches, and the range its held-out RMSE after 30 epochs
# must end in. (a): the preset's gate. (b)-(d): the JAX trainer on the same
# full data on a CPU (tools/bias_mode_check.py --preset ml1m_rank32_biased
# --cut 1: 0.52711, 0.52917, 0.52533 from its own seeded init) within
# 0.003, the spread its init may add
RANK32_DENSE = ["sgd.dense_span=full", "sgd.dense_chi=-1"]
RANK32_RUNS = {
    "a": (["sgd.bias_mode=lane"], {"sgd_sweep"}, (0.0, ML1M_RMSE_GATE)),
    "b": (RANK32_DENSE, {"dense_phase:frozen"}, (0.52411, 0.53011)),
    "c": (["sgd.bias_mode=lane"] + RANK32_DENSE, {"dense_phase:lane"},
          (0.52617, 0.53217)),
    "d": (["model.use_bias=false"] + RANK32_DENSE, {"dense_phase:none"},
          (0.52233, 0.52833)),
}
# each rank-32 form's entry: the run and the count its launches come from
RANK32_LAUNCHES = {"sgd_sweep_r32": ("a", "sgd_sweep"),
                   "dense_phase_frozen_r32": ("b", "dense_phase:frozen"),
                   "dense_phase_r32": ("c", "dense_phase:lane"),
                   "dense_phase_none_r32": ("d", "dense_phase:none")}
RANK32_TOL = 1e-5  # the rank-32 forms against plain; int8 dense: TOL
RANK32_BINS = 16  # run (e)'s time bins (L = 13 latent lanes at rank 32)


def rank32_forms(dev, sweep_sgd, dense_sgd, train, seed, cell, results,
                 bounds, sweeps, strata=None, new_forms=False):
    """Phase 19: the rank-32 forms of sgd_sweep.cu (lane) and
    dense_phase.cu (lane, frozen and bias-free with the carving's codes;
    lane and frozen with int8 codes) against their plain versions on
    ``train`` as train_epochs_blocked plans it with ``sweep_sgd`` (the
    ratings its carving leaves, if it has one) and carves it with
    ``dense_sgd``, from seeded rank-32 tables with biases: the first
    SWEEP_TILES tiles of the first sweep, then the whole sweep on one
    block and on the card's count (bitwise); the first ``strata[0]``
    strata of group 0 (all of them by default), then ``strata[1]`` on one
    block and on the card's count (bitwise), group 0 and the epoch's dense
    phase. Fills ``results``, ``bounds`` and ``sweeps`` under
    sgd_sweep_r32, dense_phase_r32 (the int8 runs as its "variants"),
    dense_phase_frozen_r32 and dense_phase_none_r32. With ``new_forms``
    (phase 25 at rank 32) also the bf16 sweeps on the same plan and echo
    2 in the lane and bias-free forms on all of group 0, as "variants" of
    their rank-64 entries."""
    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.dense_phase import group_prefix
    from mfx_torch.kernels.packing import lane_tables, plain_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    t_phase = time.perf_counter()
    rank, U, I = 32, train.num_users, train.num_items
    su, si, T, tpg = sweep_sgd.ublock, sweep_sgd.iblock, sweep_sgd.tile, \
        blocked.TPG
    mu, lr, reg = float(train.global_mean), sweep_sgd.lr, sweep_sgd.reg
    u0, i0, r0 = (torch.as_tensor(x).to(dev) for x in
                  (train.user, train.item, train.rating))

    def carve(sgd, rfmt, chi=None):
        """The trainer's dense carving of ``train`` with ``sgd``."""
        return prepare_dense_full(
            u0.int(), i0.int(), r0.float(), U, I, su, si,
            chi_min=sgd.dense_chi if chi is None else chi,
            nwd=sgd.dense_nwd or blocked.dense_group_windows(rank, si),
            rfmt=rfmt)

    u, i, r = u0.int(), i0.int(), r0.float()
    if sweep_sgd.dense_chi != 0:
        _, _, (u, i, r), _ = carve(
            sweep_sgd, blocked.dense_rfmt(sweep_sgd, rank, train.rating))
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl = pdv.epoch_tiles_device(skel, u, i, r, seed, 0)
    g = torch.Generator(device=dev).manual_seed(rank)
    model = init_model(g, U, I, rank, global_mean=train.global_mean,
                       device=dev)
    model.bu.copy_(torch.randn(U, device=dev, generator=g) * 0.1)
    model.bi.copy_(torch.randn(I, device=dev, generator=g) * 0.1)
    lane, plain = lane_tables(model, su, si, dev), plain_tables(model, su, si,
                                                                dev)
    sw = next(x for x in skel.sweeps if x.t1 > x.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls, deps = tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt)
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    kw = dict(su=su, si=si, tpg=tpg)
    lib = _build.load_library()
    log(f"[rank32] {cell}: {U} x {I}, {train.n_ratings} train ratings, su = "
        f"si = {su}, T = {T}; the sweep's plan: {u.shape[0]} sparse ratings, "
        f"{tl.shape[0]} tiles in {len(skel.sweeps)} sweep(s); seeded rank-32 "
        f"tables, biases N(0, 0.1)")
    log(f"[kernel] sgd_sweep_r32: {nt} tiles of the first sweep (T={T}, "
        f"rank 32); they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    results["sgd_sweep_r32"] = compare(
        "sgd_sweep_r32",
        lambda P, Q: sgd_sweep(P, Q[seg_s], sa, tc, tls, lr, reg, mu, **kw,
                               deps=deps),
        lambda P, Q: sgd_sweep_plain(P, Q[seg_s], sa, tc, tls, lr, reg, mu,
                                     **kw),
        lane, RANK32_TOL)
    bounds["sgd_sweep_r32"] = sweep_bound(tls, sa, tc, su, si, tpg, rank,
                                          [("P", 0), ("Q", 1)], 10)
    # the rank-64 lane form on the same tiles, timed in this run
    m64 = init_model(torch.Generator(device=dev).manual_seed(64), U, I, 64,
                     global_mean=train.global_mean, device=dev)
    P64, Q64 = lane_tables(m64, su, si, dev)
    r64_ms = cuda_ms(lambda: sgd_sweep(P64, Q64[seg_s], sa, tc, tls, lr, reg,
                                       mu, **kw, deps=deps), reps=3)
    del m64, P64, Q64
    log(f"[kernel] sgd_sweep_r32: {results['sgd_sweep_r32'][1]:.4f} ms, the "
        f"rank-64 lane form on the same tiles {r64_ms:.4f} ms; bound "
        f"{bounds['sgd_sweep_r32'][0]:.4f} ms ({bounds['sgd_sweep_r32'][1]})")
    whole = whole_sweep(
        "sgd_sweep_r32",
        lambda P, Q, blocks: sgd_sweep(
            P, Q[seg_s], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu, **kw,
            deps=sw.deps, blocks=blocks),
        lane, sw.deps, lib.mfx_sgd_sweep_max_blocks(T, rank))
    whole["sweep_bound_ms"], whole["sweep_bound_by"] = sweep_bound(
        tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
        [("P", 0), ("Q", 1)], 10)
    whole["rank64_lane_ms"] = r64_ms
    sweeps["sgd_sweep_r32"] = whole
    if new_forms:
        store_forms(bf16_forms("_r32", lane, plain, sw, tl, lr, reg, mu, su,
                               si, tpg, tiles=VARIANT_TILES), results,
                    bounds, sweeps,
                    f"rank 32, {cell}")
    del skel, tl, tls, u, i, r

    # the dense forms on group 0: the lane form on the lane tables, the
    # frozen and bias-free forms on the plain ones
    rfmt = blocked.dense_rfmt(dense_sgd, rank, train.rating)
    meta, groups, _, info = carve(dense_sgd, rfmt)
    n0 = groups[0]["sa"].shape[0]
    head, n_whole = strata or (n0, n0)
    log(f"[rank32] {cell}: the dense carving ({rfmt}, dense_frac "
        f"{info['dense_frac']:.4f}, {info['num_strata']} strata in "
        f"{len(groups)} groups, {n0} in group 0)")
    for bias, name in (("lane", "dense_phase_r32"),
                       ("frozen", "dense_phase_frozen_r32"),
                       ("none", "dense_phase_none_r32")):
        state = (lane + plain[2:]) if bias == "lane" else plain
        err, ms, plain_ms, whole, b = dense_form_check(
            name, bias, groups, meta, state, lr, reg, mu, su, si, rank, rfmt,
            RANK32_TOL, strata=head, whole=n_whole)
        whole.update(dense_group_times(name, bias, groups, meta, state, lr,
                                       reg, mu, su, si, rank))
        results[name], bounds[name], sweeps[name] = (err, ms, plain_ms), b, \
            whole
    if new_forms:
        store_forms(echo_forms("_r32", groups, meta, lane, plain, lr, reg, mu,
                               su, si, rfmt, head, n_whole), results, bounds,
                    sweeps, f"{rfmt} codes, rank 32, all of group 0 of "
                    f"{cell}")
    del groups, meta
    torch.cuda.empty_cache()
    # int8 codes at rank 32 (the same threshold): no path runs them
    meta8, groups8, _, _ = carve(dense_sgd, "int8", info["chi_effective"])
    w0, n = meta8[0]
    grp8 = group_prefix(groups8[0], head)
    variants = []
    for bias in ("lane", "frozen"):
        state = (lane + plain[2:]) if bias == "lane" else plain
        nd = grp8["sa"].shape[0]
        extra = (torch.zeros(nd, su, device=dev),
                 torch.zeros(nd, si, device=dev))
        err, ms, plain_ms = compare(
            f"dense_phase {bias} int8 rank 32",
            dense_form_run(bias, grp8, slice(w0 * si, (w0 + n) * si), lr,
                           reg, mu, su, si),
            dense_form_run(bias, grp8, slice(w0 * si, (w0 + n) * si), lr,
                           reg, mu, su, si, kernel=False),
            tuple(state) + extra, sums=(si, su) if bias == "frozen" else ())
        b = dense_bound([grp8], su, si, rank, frozen=bias == "frozen")
        variants.append({"variant": f"{bias}, int8, rank 32",
                         "strata": nd, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b[0],
                         "bound_by": b[1]})
    sweeps["dense_phase_r32"]["variants"] = variants
    del groups8, grp8, lane, plain, u0, i0, r0
    torch.cuda.empty_cache()
    log(f"[time] phase 19 ({cell}) {time.perf_counter() - t_phase:.1f} s")


def rank32_time_phase(dev, tcoo, results, bounds, sweeps):
    """Phase 19, second part: the time form of sgd_sweep.cu at rank 32
    against its plain version on phase 15's temporal data at the blocked
    timeSVD trainer's shapes (su = si = 512, T = 256), with RANK32_BINS
    bins and with 28 (the most rank 32 holds): 2,048 tiles of the first
    sweep, and with RANK32_BINS the whole first sweep on one block and on
    the card's count, bitwise. Fills ``results``, ``bounds`` and
    ``sweeps`` under sgd_sweep_time_r32."""
    import torch

    from mfx_torch.config import TimeSVDConfig
    from mfx_torch.data.split import train_test_split
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.packing import pad_rows, to_tlane_model
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_plain, sgd_sweep_time
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.blocked import TPG, sweep_geometry

    t_phase = time.perf_counter()
    cfg = timesvd_config(None)
    tc, seed, rank = cfg.timesvd, cfg.data.seed, 32
    train, _ = train_test_split(tcoo, cfg.data.test_frac, seed=seed)
    U, I = tcoo.num_users, tcoo.num_items
    su = si = tsb.BLOCK
    T, tpg, lr, reg = tsb.TILE, TPG, tc.lr, tc.reg
    mu = float(train.global_mean)
    card = _build.load_library().mfx_sgd_sweep_time_max_blocks(T, rank)
    entry = {}
    for nb in (RANK32_BINS, rank - 4):
        feats = fit_time_features(train, n_bins=nb, beta=TimeSVDConfig().beta)
        tb, dv = feats.features(train.user, train.timestamp)
        plan = tsb.build_temporal_plan_skeleton(
            train, tb, dv, su=su, si=si, tile=T, tpg=tpg,
            nwin=sweep_geometry(I, rank, si), device=dev)
        tl, sws = tsb.plan_temporal_epoch_device(*plan, seed, 0)
        g = torch.Generator(device=dev).manual_seed(cfg.model.seed)
        base = init_model(g, U, I, rank, global_mean=train.global_mean,
                          device=dev)
        ts = init_timesvd(None, U, I, rank, nb, base=base)
        ts.bt.copy_(torch.randn(I, nb, device=dev, generator=g) * 0.1)
        ts.alpha.copy_(torch.randn(U, device=dev, generator=g) * 0.1)
        lanes = to_tlane_model(ts, nb)
        P, Q = pad_rows(lanes.P, su), pad_rows(lanes.Q, si)
        sw = sws[0]
        nt = min(SWEEP_TILES, sw.t1 - sw.t0)
        sa, tcs = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
        tls, deps = tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt)
        seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
        kw = dict(su=su, si=si, tpg=tpg, n_bins=nb)
        name = f"sgd_sweep_time_r32 ({nb} bins)"
        log(f"[kernel] {name}: {nt} tiles of the first sweep (T={T}, rank "
            f"32, L = {rank - 3 - nb} latent lanes); {len(sws)} sweep(s), "
            f"critical path of the tiles {deps.critical}")
        res = compare(
            name,
            lambda Pt, Qt: sgd_sweep_time(Pt, Qt[seg], sa, tcs, tls, lr, reg,
                                          mu, **kw, deps=deps),
            lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], sa, tcs, tls, lr,
                                           reg, mu, **kw),
            (P, Q), RANK32_TOL)
        bnd = sweep_bound(tls, sa, tcs, su, si, tpg, rank,
                          [("P", 0), ("Q", 1)], None,
                          slot_ops=time_slot_ops(rank, nb))
        log(f"[kernel] {name} bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"{time_slot_ops(rank, nb)} operations a real slot)")
        if nb == RANK32_BINS:
            results["sgd_sweep_time_r32"], bounds["sgd_sweep_time_r32"] = \
                res, bnd
            entry = whole_sweep(
                "sgd_sweep_time_r32",
                lambda Pt, Qt, blocks: sgd_sweep_time(
                    Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
                    **kw, deps=sw.deps, blocks=blocks),
                (P, Q), sw.deps, card)
            entry["sweep_bound_ms"], entry["sweep_bound_by"] = sweep_bound(
                tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                [("P", 0), ("Q", 1)], None, slot_ops=time_slot_ops(rank, nb))
        else:
            entry[f"bins{nb}"] = {"tiles": nt, "max_abs_err": res[0],
                                  "ms": res[1], "plain_ms": res[2],
                                  "bound_ms": bnd[0], "bound_by": bnd[1]}
        del plan, tl, sws, P, Q, lanes, ts, base
        torch.cuda.empty_cache()
    sweeps["sgd_sweep_time_r32"] = entry
    log(f"[time] phase 19 (time form) {time.perf_counter() - t_phase:.1f} s")


def rank32_path_phase(dev, results, bounds, sweeps):
    """Phases 19 and 20 on ml1m_rank32_biased and the full ML-1M-shaped
    synthetic: the rank-32 lane sweep and dense forms against their plain
    versions on the plan of run (a) and the carving of runs (b)-(d)
    (rank32_forms, into ``results``, ``bounds`` and ``sweeps``); then the
    runs RANK32_RUNS (a)-(d), each its 30 epochs through
    train_epochs_blocked, (e) blocked timeSVD at rank 32 with RANK32_BINS
    bins through the driver on the temporal ML-1M synthetic, and the CLI
    on run (c). Returns the launches of each rank-32 form on its run."""
    import shutil

    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.loaders import GENERATOR_VERSION
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.kernels import _build
    from mfx_torch.models.mf import init_model

    cfg = preset("ml1m_rank32_biased")
    coo = make_synthetic(*ML1M_SHAPE, rank=32, seed=101, star_step=1.0,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    U, I, rank = coo.num_users, coo.num_items, cfg.model.rank
    rank32_forms(dev, apply_overrides(cfg, RANK32_RUNS["a"][0]).sgd,
                 apply_overrides(cfg, RANK32_RUNS["c"][0]).sgd, train,
                 cfg.data.seed, "ml1m_rank32_biased's runs", results, bounds,
                 sweeps, new_forms=True)

    t_phase = time.perf_counter()

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)

    log(f"[rank32] path: ml1m_rank32_biased (rank {rank}, su = si = "
        f"{cfg.sgd.ublock}, T = {cfg.sgd.tile}, {cfg.sgd.epochs} epochs) on "
        f"the ml-1m synthetic ({train.n_ratings} train ratings)")
    _, runs = train_runs(dev, cfg, train, test, fresh_model, RANK32_RUNS,
                         "rank32")
    launches = {name: runs[tag][0][key]
                for name, (tag, key) in RANK32_LAUNCHES.items()}

    # (e) blocked timeSVD at rank 32 through the driver
    root = _build.BUILD_DIR.parent / "chip_smoke_rank32"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    tcoo = temporal(coo, 101)
    tcoo.save_npz(root / f"ml-1m.v{GENERATOR_VERSION}.synthetic.npz")
    over = ["solver=timesvd", "timesvd.kernel=pallas", "model.rank=32",
            f"timesvd.n_bins={RANK32_BINS}", f"data.root={root}"]
    *_, launches["sgd_sweep_time_r32"] = timesvd_driver_run(
        dev, apply_overrides(cfg, over + [f"checkpoint_dir={root / 'ckpt'}",
                                          "checkpoint_every=2"]),
        apply_overrides(cfg, over + ["timesvd.epochs=2"]), tcoo, "rank32 (e)")
    shutil.rmtree(root, ignore_errors=True)

    cli_train("ml1m_rank32_biased", RANK32_RUNS["c"][0], 2)
    log(f"[time] phase 20 {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 23: the deep form of tile_topk at 1M items (depth, tile, dtype)
DEEP_CASES = (("f32", 33, 1024), ("f32", 64, 1024), ("f32", 256, 1024),
              ("f32", 64, 4096), ("f32", 2, 8192), ("bf16", 64, 1024),
              ("int8", 64, 1024))
# the serving path's certified-exact settings and its k
EXACT_DEPTH, DEEP_TILE, DEEP_K = 64, 4096, 100
FULL_RECOUNT = 2048  # full protocol's positives recounted in float64
# phase 24: the reference's minibatch trainer with bf16 tables on the full
# ml100k_rank16 cell after BF16_EPOCHS of the preset's 30 (a cut for the
# script's time; after 30 it ends at 0.537165) ends at this
# held-out RMSE (tools/bf16_check.py --epochs 15, on the CPU); the port's
# run must end within BF16_TOL of it
BF16_EPOCHS, BF16_REF, BF16_TOL = 15, 0.541155, 0.003


def deep_case(what, P_aug, Q_aug, sb, tile, depth, items, rank):
    """The deep form against its plain version on these tables (values
    within TOL, lanes equal but at near-ties, two runs bitwise), its time
    beside the plain version's, the stock path's and the bound, counted as
    phase 5 counts it: f32 FMA over the rank + 1 lanes that carry a value
    for every (user row, real item) pair, 2 B items (rank + 1) operations
    (the augmented width's zero lanes and the pad items not counted),
    against those lanes of the user rows and of the real items read once
    (with int8 their scale and bias) and depth B n_tiles (value, lane)
    pairs written."""
    import torch

    from mfx_torch.kernels.serve_topk import tile_topk, tile_topk_plain
    from mfx_torch.measure_topk import stock_topk

    def run():
        return tile_topk(P_aug, Q_aug, tile=tile, depth=depth, sb=sb)

    outs = [run(), run()]
    torch.cuda.synchronize()
    if any(not torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"{what}: two kernel runs differ")
    err, swaps, gap = hold_topk(what, outs[0], P_aug, Q_aug, sb, tile, depth)
    del outs
    plain_ms = cuda_ms(lambda: tile_topk_plain(P_aug, Q_aug, tile=tile,
                                               depth=depth, sb=sb))
    stock_topk(P_aug, Q_aug, sb, tile, depth)  # warm-up
    # in turns: stock, kernel, kernel, stock (3 calls each time)
    stock_ms, ms = in_turns(
        lambda: stock_topk(P_aug, Q_aug, sb, tile, depth), run, reps=3)
    B, K = P_aug.shape
    ipad = Q_aug.shape[0]
    nbytes = ((B * P_aug.element_size() + items * Q_aug.element_size())
              * (rank + 1) + (items * 8 if sb is not None else 0)
              + depth * B * (ipad // tile) * 8)
    b = bound(nbytes, 2.0 * B * items * (rank + 1))
    log(f"[deep] {what}: B {B}, I_pad {ipad}, K {K}, tile {tile}, depth "
        f"{depth}: max_abs_err={err:.3e} (tol {TOL}), lane swaps {swaps} "
        f"(gap <= {gap:.3e}); in turns with the stock path: ms={ms:.4f} "
        f"stock_ms={stock_ms:.4f} ({stock_ms / ms:.2f}x); "
        f"plain_ms={plain_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}, "
        f"{b[0] / ms:.1%} of it)")
    return {"dtype": str(Q_aug.dtype).removeprefix("torch."), "B": B,
            "items_padded": ipad, "tile": tile, "depth": depth,
            "max_abs_err": err, "lane_swaps": swaps, "ms": ms,
            "plain_ms": plain_ms, "stock_ms": stock_ms, "bound_ms": b[0],
            "bound_by": b[1]}


def in_turns(a, b, reps=3):
    """(ms of a, ms of b), each the mean of two timings of ``reps`` calls
    taken in turns: a, b, b, a."""
    ta = cuda_ms(a, reps)
    tb = cuda_ms(b, reps)
    tb += cuda_ms(b, reps)
    ta += cuda_ms(a, reps)
    return ta / 2, tb / 2


# phase 23: tables whose scores are exact in any summation order, at the
# serving shapes (two pieces a tile) and with many pieces a tile: (B,
# items, rank, tile, depth)
DEEP_EXACT = ((256, 59_047, 64, 4096, 64), (16, 9_000, 64, 4096, 64),
              (17, 3_000, 32, 512, 300))


def deep_exact_case(dev, B, items, rank, tile, depth):
    """The deep form against its plain version on integer and quarter
    tables (every product and sum exact in f32, many equal scores):
    values and lanes bitwise equal, whatever order either sums in."""
    import torch

    from mfx_torch.kernels.serve_topk import (aug_width, tile_topk,
                                              tile_topk_plain)
    from mfx_torch.serve.fused import _augment_catalog, _augment_rows

    g = torch.Generator(device=dev).manual_seed(depth)
    P = torch.randint(-3, 4, (B, rank), device=dev, generator=g).float()
    Q = torch.randint(-3, 4, (items, rank), device=dev,
                      generator=g).float() / 4
    bi = torch.randint(-4, 5, (items,), device=dev, generator=g).float() / 2
    ipad = -(-items // tile) * tile
    P_aug = _augment_rows(P, torch.float32, aug_width(rank))
    Q_aug = _augment_catalog(Q, bi, ipad, torch.float32)
    got = tile_topk(P_aug, Q_aug, tile=tile, depth=depth)
    want = tile_topk_plain(P_aug, Q_aug, tile=tile, depth=depth)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"[deep] exact scores, B {B}, {items} items, rank {rank}, tile "
        f"{tile}, depth {depth}: bitwise equal to plain: {same}")
    if not same:
        raise AssertionError("the deep form differs from its plain version "
                             "on exact scores")


def _spawn(args):
    return subprocess.Popen([sys.executable, "-m", "mfx_torch.cli", *args,
                             "--device", "cuda"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, what, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"CLI {what} failed:\n{err[-3000:]}")
    return out.strip().splitlines()


def deep_serve_phase(dev, model, coo, train, test, cfg, results, bounds,
                     sweeps, library):
    """Phase 23: the deep form against its plain version at 1M items and
    at the serving path's shapes; the serving path through it (certified
    exact at depth 64 on tiles of 4096, the approximate recommender on
    tiles of 4096), its launches counted; then the CLI on phase 4's
    checkpoint and data: eval in the three protocols, serve
    --fused-exact --exact-depth 64 --tile 4096, serve --mmr 0.7,
    recommend --fused --tile 4096. Returns the deep form's launches and
    the data root (the dataset's cache) for phase 24."""
    import urllib.request
    from pathlib import Path

    import numpy as np
    import torch

    from mfx_torch.data.loaders import GENERATOR_VERSION
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.eval.ranking import full_hr_ndcg_at_k, full_ranks
    from mfx_torch.kernels.serve_topk import aug_width, tile_topk
    from mfx_torch.measure_topk import (RANK, SERVE_B, SERVE_ITEMS,
                                        serving_tables)
    from mfx_torch.serve import (FusedTopKRecommender, MMRRecommender,
                                 TopKRecommender, rerank_mmr)
    from mfx_torch.serve.fused import _augment_catalog, _augment_rows
    from mfx_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    for case in DEEP_EXACT:
        deep_exact_case(dev, *case)
    variants = []
    for dtype, depth, tile in DEEP_CASES:
        P_aug, Q_aug, sb = serving_tables(dev, SERVE_B, SERVE_ITEMS, dtype,
                                          tile=tile)
        variants.append(deep_case(f"1M items, {dtype}", P_aug, Q_aug, sb,
                                  tile, depth, SERVE_ITEMS, RANK))
        del P_aug, Q_aug, sb
        torch.cuda.empty_cache()
    # the serving path's own shapes: the trained model's catalog, a batch
    # of 256 users
    rng = np.random.default_rng(cfg.data.seed)
    users = rng.choice(model.num_users, 1024, replace=False).astype(np.int32)
    ipad = -(-model.num_items // DEEP_TILE) * DEEP_TILE
    P_aug = _augment_rows(model.P[torch.as_tensor(users[:SERVE_B],
                                                  device=dev).long()],
                          torch.float32, aug_width(model.rank))
    Q_aug = _augment_catalog(model.Q, model.bi, ipad, torch.float32)
    head = deep_case("the trained ML-25M model", P_aug, Q_aug, None,
                     DEEP_TILE, EXACT_DEPTH, model.num_items, model.rank)
    del P_aug, Q_aug
    results["tile_topk_deep"] = (max([head["max_abs_err"]] + [
        v["max_abs_err"] for v in variants]), head["ms"], head["plain_ms"])
    bounds["tile_topk_deep"] = (head["bound_ms"], head["bound_by"])
    library["tile_topk_deep"] = head["stock_ms"]
    sweeps["tile_topk_deep"] = {"serving_case": head, "variants": variants}

    # the serving path through the deep form, its launches counted alone
    tile_topk.launches = tile_topk.deep_launches = 0
    t0 = time.perf_counter()
    exact = FusedTopKRecommender(model, train=coo, exact=True,
                                 exact_depth=EXACT_DEPTH, tile=DEEP_TILE,
                                 device=dev)
    approx = FusedTopKRecommender(model, train=coo, tile=DEEP_TILE,
                                  device=dev)
    ei, es = exact.recommend(users, k=DEEP_K)
    ai, as_ = approx.recommend(users[:SERVE_B], k=K)
    torch.cuda.synchronize()
    launches = tile_topk.deep_launches
    path_s = time.perf_counter() - t0
    log(f"[deep] serving path: exact (depth {EXACT_DEPTH}, tile "
        f"{DEEP_TILE}, max_k {exact.max_k}) k={DEEP_K} for {len(users)} "
        f"users and approximate (tile {DEEP_TILE}, max_k {approx.max_k}) "
        f"k={K} for {SERVE_B} in {path_s:.2f} s; exact_fallbacks "
        f"{exact.exact_fallbacks}; launches {{'tile_topk_deep': {launches}, "
        f"'tile_topk': {tile_topk.launches}}}")
    if launches < 1 or tile_topk.launches:
        raise AssertionError("the serving path did not run the deep form "
                             "alone")
    stock = TopKRecommender(model, train=coo, device=dev)
    si, ss = stock.recommend(users, k=DEEP_K)
    gap = np.abs(es - ss)
    if not np.all(np.isfinite(es)) or not np.all(gap <= TOL):
        raise AssertionError(f"exact != stock at k={DEEP_K}: {gap.max()}")
    if ((np.diff(as_, axis=1) > 0).any() or (ai >= model.num_items).any()
            or not np.isfinite(as_).all()):
        raise AssertionError("approximate recommender at tile 4096 broken")
    log(f"[deep] exact == stock at k={DEEP_K} on {len(users)} users: "
        f"{int((ei != si).sum())} item swaps, all near-ties (score gap <= "
        f"{gap.max():.3e}); approximate recall@{K} against stock "
        f"{np.mean([len(set(ai[b]) & set(si[b, :K])) / K for b in range(SERVE_B)]):.4f}")

    # the CLI on the trained model and the same data (a cache the loader
    # reads under --root)
    work = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"
    root = work / "data"
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # the loader's cache of a synthetic stand-in (a cache under the real
    # name is renamed to this one by the first process that reads it)
    coo.save_npz(root / f"ml-25m.v{GENERATOR_VERSION}.synthetic.npz")
    ck = work / "ck"
    save_checkpoint(ck, 1, model, seed=cfg.data.seed)
    log(f"[cli] dataset cache and checkpoint written in "
        f"{time.perf_counter() - t0:.1f} s ({work})")
    src = ["--checkpoint", str(ck), "--dataset", "ml-25m", "--root",
           str(root)]
    t0 = time.perf_counter()
    procs = {
        "eval full": _spawn(["eval", *src, "--test-frac",
                             str(cfg.data.test_frac), "--ranking-k", "10",
                             "--ranking-protocol", "full"]),
        "eval user": _spawn(["eval", *src, "--test-frac",
                             str(cfg.data.test_frac), "--ranking-k", "10",
                             "--ranking-protocol", "user"]),
        # the sampled protocol's 100 host draws a positive: on the
        # leave-one-out split (one positive a user), its usual pairing
        "eval sampled": _spawn(["eval", *src, "--split", "loo",
                                "--ranking-k", "10", "--ranking-protocol",
                                "sampled"]),
        "recommend": _spawn(["recommend", *src, "--users", "0,1,2",
                             "--fused", "--tile", str(DEEP_TILE)]),
    }
    servers = {
        "exact": _spawn(["serve", *src, "--port", "0", "--fused",
                         "--fused-exact", "--exact-depth", str(EXACT_DEPTH),
                         "--tile", str(DEEP_TILE)]),
        "mmr": _spawn(["serve", *src, "--port", "0", "--mmr", "0.7"]),
    }
    try:
        urls = {}
        for key, proc in servers.items():
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"serve {key} did not start:\n"
                                     f"{proc.stderr.read()[-3000:]}")
            urls[key] = json.loads(line)["serving"]
        q = users[:8].tolist()

        def post(url, k):
            req = urllib.request.Request(
                url + "/recommend", data=json.dumps({"users": q, "k": k})
                .encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                return json.loads(r.read())

        ans = post(urls["exact"], DEEP_K)
        d_i, d_s = exact.recommend(q, k=DEEP_K)  # the server's batch
        if ans["items"] != d_i.tolist() or ans["scores"] != d_s.tolist():
            raise AssertionError("serve --fused-exact != a direct call")
        if not np.all(np.abs(d_s - ss[:8]) <= TOL):
            raise AssertionError("serve --fused-exact != stock exact")
        log(f"[cli] serve --fused --fused-exact --exact-depth {EXACT_DEPTH} "
            f"--tile {DEEP_TILE}: /recommend k={DEEP_K} for 8 users equals "
            "the direct exact call on the same batch, and stock exact; "
            f"exact_fallbacks {exact.exact_fallbacks}")
        ans = post(urls["mmr"], K)
        direct = MMRRecommender(stock, lam=0.7).recommend(q, k=K)
        pools = stock.recommend(q, k=4 * K)
        cpu_q = model.Q.detach().cpu()
        on_cpu = rerank_mmr(cpu_q, *pools, k=K, lam=0.7)
        if (ans["items"] != direct[0].tolist()
                or ans["items"] != on_cpu[0].tolist()
                or ans["scores"] != direct[1].tolist()):
            raise AssertionError("serve --mmr != direct call / CPU rerank")
        log(f"[cli] serve --mmr 0.7: /recommend k={K} for 8 users equals "
            "the direct MMRRecommender call and rerank_mmr on CPU copies "
            "of the same pools")
    finally:
        for proc in servers.values():
            proc.kill()
            proc.wait(timeout=60)
    # the full protocol in this process, on the same model and split,
    # while the CLI's processes run
    t1 = time.perf_counter()
    full = full_hr_ndcg_at_k(model, test, train=train, k=10)
    full_s = time.perf_counter() - t1
    outs = {key: _finish(proc, key) for key, proc in procs.items()}
    log(f"[cli] eval x3 and recommend, run side by side, in "
        f"{time.perf_counter() - t0:.1f} s (processes and data included)")
    recs = [json.loads(x) for x in outs["recommend"]]
    if len(recs) != 3 or any(len(r["items"]) != K for r in recs):
        raise AssertionError(f"recommend --fused --tile {DEEP_TILE}: {recs}")
    held = rmse_mae(model, test, clip=(0.5, 5.0))
    for key in ("eval full", "eval user", "eval sampled"):
        got = json.loads(outs[key][-1])
        log(f"[cli] {key}: {outs[key][-1]}")
        if got["checkpoint_epoch"] != 1:
            raise AssertionError(f"{key}: {got}")
        if key != "eval sampled" and (abs(got["rmse"] - held[0]) > 1e-6
                                      or abs(got["mae"] - held[1]) > 1e-6):
            raise AssertionError(f"{key}: RMSE {got['rmse']} != the "
                                 f"trainer's held-out {held[0]}")
        if key == "eval full":
            gap = max(abs(got[f"{m}@10"] - full[m]) for m in full)
            if not gap <= 1e-6:
                raise AssertionError(f"eval full's ranking metrics {got} != "
                                     f"full_hr_ndcg_at_k's {full}")
            log(f"[cli] eval full's hr/ndcg/mrr@10 equal full_hr_ndcg_at_k "
                f"on the same model and split in this process (largest gap "
                f"{gap:.3e}, limit 1e-6; {full_s:.1f} s)")
    # the full protocol's ranks of the first positives against a float64
    # recount on the host
    u, p = test.user[:FULL_RECOUNT], test.item[:FULL_RECOUNT]
    seen = train.seen_csr()
    ranks = full_ranks(model, u, p, seen).cpu().numpy()
    P64, Q64 = model.P.double().cpu().numpy(), model.Q.double().cpu().numpy()
    bi64 = model.bi.double().cpu().numpy()
    off, worst = 0, 0
    for a in range(0, FULL_RECOUNT, 256):
        s = P64[u[a:a + 256]] @ Q64.T + bi64
        rows = np.arange(s.shape[0])
        s_pos = s[rows, p[a:a + 256]].copy()
        for b, uu in enumerate(u[a:a + 256]):
            s[b, seen.items[seen.offsets[uu]:seen.offsets[uu + 1]]] = -np.inf
        s[rows, p[a:a + 256]] = -np.inf
        r64 = 1 + (s > s_pos[:, None]).sum(1) + 0.5 * (s == s_pos[:, None]
                                                       ).sum(1)
        near = (np.abs(s - s_pos[:, None]) <= 1e-5).sum(1)
        d = np.abs(ranks[a:a + 256] - r64)
        if (d > near).any():
            raise AssertionError("full protocol ranks != the f64 recount")
        off += int((d > 0).sum())
        worst = max(worst, float(d.max()))
    log(f"[cli] full protocol: the ranks of {FULL_RECOUNT} positives equal "
        f"a float64 host recount ({off} differ, by at most {worst}, each "
        "within its competitors 1e-5 from the positive's score)")
    log(f"[time] phase 23 {time.perf_counter() - t_phase:.1f} s")
    return launches, root


def bf16_add_check(dev, what, table, rows, delta):
    """bf16_row_add (csrc/row_add_bf16.cu) against its plain version on CPU
    copies of the same inputs (bitwise: the same adds in the same order),
    two runs bitwise; its time (the rows' sort included, and with the
    sorted rows handed in) beside the plain version's (on the host) and
    index_put_(accumulate=True)'s on the card, and its bound: the row
    ids (8 B each) and the deltas read once, the touched elements read
    and written once, one add a delta element."""
    import torch

    from mfx_torch.kernels.packing import bf16_order, bf16_row_add

    want = table.cpu()
    bf16_row_add(want, rows.cpu(), delta.cpu())
    outs = []
    for _ in range(2):
        t = table.clone()
        bf16_row_add(t, rows, delta)
        outs.append(t)
    torch.cuda.synchronize()
    if not (torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
            and torch.equal(outs[0].cpu().view(torch.int16),
                            want.view(torch.int16))):
        raise AssertionError(f"bf16_row_add {what}: not the plain version's "
                             "bits or not repeatable")
    t = table.clone()
    ms = cuda_ms(lambda: bf16_row_add(t, rows, delta), reps=20)
    order = bf16_order(t, rows)  # as the minibatch step shares it
    sorted_ms = cuda_ms(lambda: bf16_row_add(t, rows, delta, order), reps=20)
    tc, rc, dc = table.cpu(), rows.cpu(), delta.cpu()
    t0 = time.perf_counter()
    for _ in range(5):
        bf16_row_add(tc, rc, dc)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 5
    flat = table.view(-1)
    w = table.shape[1] if table.dim() > 1 else 1
    idx = ((rows[:, None] * w + torch.arange(w, device=dev)).reshape(-1)
           if table.dim() > 1 else rows)
    put = flat.clone()
    put.index_put_((idx,), delta.reshape(-1), accumulate=True)
    off = int((put.cpu() != want.view(-1)).sum())
    lib_ms = cuda_ms(lambda: put.index_put_((idx,), delta.reshape(-1),
                                            accumulate=True), reps=20)
    n = idx.numel()
    touched = int(torch.unique(idx).numel())
    b = bound(rows.numel() * 8 + n * 2 + touched * 2 * 2, n)
    log(f"[bf16] bf16_row_add, {what}: {rows.numel()} rows, {n} deltas into "
        f"{touched} elements: bitwise the plain version's (slot order, each "
        f"sum rounded), ms={ms:.4f} (with the rows sorted beforehand "
        f"{sorted_ms:.4f}) plain_ms (host) {plain_ms:.4f} index_put_ ms="
        f"{lib_ms:.4f} (its result differs at {off} elements) bound_ms="
        f"{b[0]:.6f} ({b[1]})")
    return {"what": what, "rows": rows.numel(), "deltas": n,
            "elements": touched, "index_put_differs_at": off, "ms": ms,
            "presorted_ms": sorted_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b[0],
            "bound_by": b[1]}


def bf16_profile_phase(dev, root, results, bounds, sweeps, library):
    """Phase 24: bf16_row_add against its plain version at the minibatch
    path's shapes; ml100k_rank16 with bf16 tables through the training driver
    (BF16_EPOCHS of its 30; bf16_row_add's launches counted) and their checkpoint bit
    for bit; one ml25m_rank64 epoch with profile_phases on phase 23's
    data. Returns bf16_row_add's launches."""
    import tempfile
    import warnings
    from pathlib import Path

    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.train.checkpoint import load_checkpoint
    from mfx_torch.train.driver import train as drive

    t_phase = time.perf_counter()
    # the minibatch step's scatter at the preset's shapes: a batch of
    # 2,048 slots into the rank-16 user table with its 2,048 sink rows
    # (conflict-free: distinct rows), and the same slots over 64 hot rows
    # as a fixed partitioner's batch can hold them
    g = torch.Generator(device=dev).manual_seed(24)
    table = (torch.randn(943 + 2048, 16, device=dev, generator=g)
             * 0.3).bfloat16()
    delta = (torch.randn(2048, 16, device=dev, generator=g)
             * 0.01).bfloat16()
    cases = [bf16_add_check(dev, "distinct rows", table,
                            torch.randperm(943 + 2048, device=dev,
                                           generator=g)[:2048], delta),
             bf16_add_check(dev, "64 hot rows", table,
                            torch.randint(0, 64, (2048,), device=dev,
                                          generator=g), delta)]
    results["bf16_row_add"] = (0.0, cases[0]["ms"], cases[0]["plain_ms"])
    bounds["bf16_row_add"] = (cases[0]["bound_ms"], cases[0]["bound_by"])
    library["bf16_row_add"] = cases[0]["library_ms"]
    sweeps["bf16_row_add"] = {"plain_on": "the host CPU", "variants": cases}

    from mfx_torch.kernels.packing import GRAPH_LAUNCHES, bf16_row_add

    build = Path(__file__).resolve().parent / "build"
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        cfg = apply_overrides(preset("ml100k_rank16"), [
            "model.dtype=bfloat16", f"sgd.epochs={BF16_EPOCHS}",
            f"checkpoint_dir={Path(tmp) / 'ck'}"])
        t0 = time.perf_counter()
        bf16_row_add.launches = 0
        GRAPH_LAUNCHES.update(captured=0, replayed=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded synthetic stand-in
            res = drive(cfg, device=dev)
        # the wrapper counts the launches it makes and those it records
        # into the step's graph; the epochs' replays launch the recorded
        # ones again, counted by the step runner that replays them
        wrapper, graph = bf16_row_add.launches, dict(GRAPH_LAUNCHES)
        launches = wrapper - graph["captured"] + graph["replayed"]
        log(f"[bf16] launches {{'bf16_row_add': {launches}}}: "
            f"{wrapper - graph['captured']} from the wrapper outside a "
            f"capture, {graph['replayed']} by graph replays "
            f"({graph['captured']} recorded into captured steps)")
        if graph["replayed"] < 1 or wrapper < 1:
            raise AssertionError("the bf16 path never launched bf16_row_add")
        trains = [h["train_metric"] for h in res.history]
        tests = [h["test_rmse"] for h in res.history if "test_rmse" in h]
        epoch_s = sorted(h["epoch_s"] for h in res.history)
        log(f"[bf16] ml100k_rank16 model.dtype=bfloat16: {res.epochs_run} "
            f"epochs in {time.perf_counter() - t0:.1f} s (epoch_s median "
            f"{epoch_s[len(epoch_s) // 2]:.3f}); train RMSE "
            + " ".join(f"{x:.5f}" for x in trains) + "; held-out RMSE "
            + " ".join(f"{x:.5f}" for x in tests)
            + f"; the reference's bf16 run ends at {BF16_REF}")
        if (res.model.P.dtype != torch.bfloat16
                or res.epochs_run != BF16_EPOCHS):
            raise AssertionError(f"not a {BF16_EPOCHS}-epoch bf16 run")
        if any(b >= a for a, b in zip(trains, trains[1:])):
            raise AssertionError(f"train RMSE did not fall: {trains}")
        if abs(res.test_rmse - BF16_REF) > BF16_TOL:
            raise AssertionError(f"held-out {res.test_rmse} not within "
                                 f"{BF16_TOL} of {BF16_REF}")
        saved, epoch, _ = load_checkpoint(Path(tmp) / "ck", device=dev)
        same = all(getattr(saved, k).dtype == torch.bfloat16
                   and torch.equal(getattr(saved, k).view(torch.int16),
                                   getattr(res.model, k).view(torch.int16))
                   for k in ("P", "Q", "bu", "bi"))
        if not same or saved.mu != res.model.mu or epoch != BF16_EPOCHS - 1:
            raise AssertionError("the bf16 checkpoint lost its bits")
        log(f"[bf16] checkpoint of epoch {epoch} loaded back bf16, bit for "
            "bit")
    cfg = apply_overrides(preset("ml25m_rank64"), [
        "data.dataset=ml-25m", f"data.root={root}", "sgd.epochs=1",
        "profile_phases=true"])
    t0 = time.perf_counter()
    res = drive(cfg, device=dev)
    rec = res.history[0]
    log(f"[profile] ml25m_rank64, 1 epoch with profile_phases in "
        f"{time.perf_counter() - t0:.1f} s (data, prep and eval included): "
        + json.dumps(rec, sort_keys=True))
    if not {"plan_ms", "dense_ms", "sparse_ms", "eval_ms"} <= set(rec) or (
            rec["dense_ms"] <= 0 or rec["sparse_ms"] <= 0):
        raise AssertionError(f"profile_phases record: {rec}")
    log(f"[time] phase 24 {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phases 25-26: the bf16 sweeps, the dense echo passes, and the main
# path under every dense and MXU setting -----------------------------------

# the bf16 forms, each named at rank 64: (body, sweep_bound's bias, slot
# bytes); the bound is the f32 form's
BF16_FORMS = {
    "sgd_sweep_bf16": ("lane", None, 0),
    "sgd_sweep_tile_bf16": ("tile", "update", 0),
    "sgd_sweep_tile_none_bf16": ("none", None, 0),
    "sgd_sweep_epoch_bf16": ("epoch", "read", 4),
    "sgd_sweep_step_u_bf16": ("step_u", "update", 0),
}
# tiles of the bf16 forms' check against plain at the rank-32 and rank-128
# cells (SWEEP_TILES at ml25m_rank64's): the plain version takes each sum
# in the kernel's order, which costs time on hot rows
VARIANT_TILES = 256  # a cut for the script's time
# and at ml25m_rank64's cell: 512 tiles, a cut for the script's time
BF16_CELL_TILES = 512
# the echo forms (echo 2), named at rank 64 with int4 codes
ECHO_FORMS = {"dense_phase_echo": "lane", "dense_phase_none_echo": "none"}
ECHO = 2


def sweep_form_run(body, tiles, seg, lr, reg, mu, su, si, tpg, kernel=True,
                   blocks=None, bf16=True):
    """``run(*tables)`` of a sweep body ('lane', 'tile', 'none', 'epoch',
    'step_u') over ``tiles`` = (sa, tc, tl, deps) on the item segment
    ``seg``: through its kernel on ``blocks``, or its plain version; the
    tables are (P, Q) for 'lane', (P, Q, bu, bi) for the others and the
    epoch form's residual output after them. Returns the SSE."""
    from mfx_torch.kernels import sgd_sweep as ss

    sa, tc, tls, deps = tiles
    kw = dict(su=su, si=si, tpg=tpg, bf16=bf16)
    if kernel:
        kw.update(deps=deps, blocks=blocks)
    if body == "lane":
        fn = ss.sgd_sweep if kernel else ss.sgd_sweep_plain
        return lambda P, Q: fn(P, Q[seg], sa, tc, tls, lr, reg, mu, **kw)
    if body == "epoch":
        fn = ss.sgd_sweep_epoch if kernel else ss.sgd_sweep_epoch_plain
        return lambda P, Q, bu, bi, e: fn(P, Q[seg], bu, bi[seg], sa, tc, tls,
                                          e, lr, reg, mu, **kw)
    fn = {("step_u", True): ss.sgd_sweep_step_u,
          ("step_u", False): ss.sgd_sweep_step_u_plain}.get(
        (body, kernel), ss.sgd_sweep_tile if kernel
        else ss.sgd_sweep_tile_plain)
    return lambda P, Q, bu, bi: fn(P, Q[seg], bu, bi[seg], sa, tc, tls, lr,
                                   reg, mu, use_bias=body != "none", **kw)


def bf16_forms(tag, lane_state, plain_state, sw, tl, lr, reg, mu, su, si,
               tpg, bodies=tuple(BF16_FORMS), tiles=SWEEP_TILES):
    """Phase 25's bf16 sweeps at one cell: each of ``bodies`` (names of
    BF16_FORMS) against its plain version with ``bf16=True`` on the first
    ``tiles`` tiles of the sweep ``sw``: the plain version takes every sum
    in the kernel's order, so the tables must be bitwise equal (the SSE,
    summed in another order, within TOL), two kernel runs bitwise, and the
    f32 form from the same state must differ from that plain version (a
    kernel that ignored the flag would fail); the f32 form on the same
    tiles timed beside it, then the whole sweep once on one block and
    twice on the card's count (tables, biases, residuals and SSE bitwise).
    ``lane_state`` = (P, Q) lane tables, ``plain_state`` = (P, Q, bu, bi).
    Returns {name: ((err, ms, plain_ms), bound, whole-run dict)}."""
    import torch

    from mfx_torch.kernels import _build

    lib = _build.load_library()
    rank, T, dev = lane_state[0].shape[1], tl.shape[2], tl.device
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    nt = min(tiles, sw.t1 - sw.t0)
    head = (sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous(),
            tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt))
    whole = (sw.sa, sw.tc, tl[sw.t0:sw.t1], sw.deps)
    card = {"lane": lib.mfx_sgd_sweep_max_blocks(T, rank),
            "step_u": lib.mfx_sgd_sweep_step_u_max_blocks(T, rank, su)}
    out = {}
    for name in bodies:
        body, bias, slot_bytes = BF16_FORMS[name]
        label = name + tag

        def state(n, body=body):
            if body == "lane":
                return tuple(lane_state)
            return tuple(plain_state) + ((torch.zeros(n, T, device=dev),)
                                         if body == "epoch" else ())

        args = (lr, reg, mu, su, si, tpg)
        res = compare(label, sweep_form_run(body, head, seg, *args),
                      sweep_form_run(body, head, seg, *args, kernel=False),
                      state(nt), tol=0.0, sse_tol=TOL,
                      control=sweep_form_run(body, head, seg, *args,
                                             bf16=False))
        tabs = state(nt)
        tabs = tuple(t.clone() for t in tabs)
        f32_ms = cuda_ms(lambda: sweep_form_run(body, head, seg, *args,
                                                bf16=False)(*tabs), reps=3)
        b = sweep_bound(head[2], head[0], head[1], su, si, tpg, rank,
                        [("P", 0), ("Q", 1)], 10, bias=bias,
                        slot_bytes=slot_bytes)
        runs = whole_sweep(
            label, lambda *t, body=body: sweep_form_run(
                body, whole, seg, *args, blocks=t[-1])(*t[:-1]),
            state(sw.t1 - sw.t0), sw.deps,
            card.get(body, lib.mfx_sgd_sweep_tile_max_blocks(T, rank)))
        runs.update({"f32_form_ms": f32_ms, "sweep_bound_ms": sweep_bound(
            whole[2], whole[0], whole[1], su, si, tpg, rank,
            [("P", 0), ("Q", 1)], 10, bias=bias, slot_bytes=slot_bytes)[0]})
        log(f"[kernel] {label}: {nt} tiles {res[1]:.4f} ms, the f32 form on "
            f"the same tiles {f32_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
        runs["tiles"] = nt
        out[name] = (res, b, runs)
        del tabs
        torch.cuda.empty_cache()
    return out


def echo_forms(tag, groups, meta, lane_state, plain_state, lr, reg, mu, su,
               si, rfmt, strata, whole, biases=("lane", "none"), tol=TOL,
               times=False):
    """Phase 25's dense echo passes at one cell: echo=2 in each bias form
    of ``biases`` against dense_phase_plain(echo=2) on the first
    ``strata`` strata of group 0 (within ``tol``, two kernel runs
    bitwise), the echo=1 form on them timed beside it, then the first
    ``whole`` strata (2 ``whole`` slots) once on one block and twice on
    the card's count (bitwise); with ``times`` also group 0 and the
    epoch's dense phase at echo 2 on the card's count. Returns {name:
    ((err, ms, plain_ms), bound, whole-run dict)}."""
    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels.dense_phase import (BIAS_FORMS, dense_phase,
                                               dense_phase_plain,
                                               group_prefix, plan_launch)

    lib = _build.load_library()
    rank = lane_state[0].shape[1]
    win0, nw = meta[0]
    seg = slice(win0 * si, (win0 + nw) * si)

    def echoed(g):  # the group with its slots' table
        return dict(g, deps=g["deps"].repeat(ECHO))

    n0 = groups[0]["sa"].shape[0]
    strata, whole = min(strata, n0), min(whole, n0)
    grp, head = (echoed(group_prefix(groups[0], n)) for n in (strata, whole))
    out = {}
    for name, bias in ECHO_FORMS.items():
        if bias not in biases:
            continue
        label = name + tag
        st = tuple(lane_state) if bias == "lane" else tuple(plain_state[:2])
        kw = dict(su=su, si=si, bias=bias)
        log(f"[kernel] {label}: {grp['sa'].shape[0]} strata of group 0, "
            f"echo {ECHO} ({rfmt}, {su}x{si}, rank {rank}, bias={bias!r}); "
            f"critical path {grp['deps'].critical} slots")
        res = compare(
            label,
            lambda P, Q: dense_phase(P, Q[seg], grp, lr, reg, mu, **kw,
                                     echo=ECHO, deps=grp["deps"]),
            lambda P, Q: dense_phase_plain(P, Q[seg], grp, lr, reg, mu, **kw,
                                           echo=ECHO), st, tol)
        one = group_prefix(groups[0], strata)
        plan_launch(one, su, si, rank, bias)  # untimed, as for ``grp``
        tabs = tuple(t.clone() for t in st)

        def echo1():
            dense_phase(tabs[0], tabs[1][seg], one, lr, reg, mu, **kw,
                        deps=one["deps"])
        echo1()  # warm-up
        echo1_ms = cuda_ms(echo1, reps=3)
        b = dense_bound([grp], su, si, rank, echo=ECHO)
        card = lib.mfx_dense_phase_max_blocks(rank, int(rfmt == "int8"),
                                              BIAS_FORMS.index(bias))
        plan_launch(head, su, si, rank, bias, ECHO)  # untimed
        runs = whole_sweep(
            label, lambda P, Q, blocks: dense_phase(
                P, Q[seg], head, lr, reg, mu, **kw, echo=ECHO,
                deps=head["deps"], blocks=blocks),
            st, head["deps"], card, grid=card, unit="slots")
        runs["echo1_ms"] = echo1_ms
        log(f"[kernel] {label}: {res[1]:.4f} ms, echo 1 on the same strata "
            f"{echo1_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
        if times:
            for key, grps in (("group0", list(zip(meta, groups))[:1]),
                              ("epoch_dense", list(zip(meta, groups)))):
                grps = [(m, echoed(g)) for m, g in grps]
                for _, g in grps:
                    plan_launch(g, su, si, rank, bias, ECHO)

                def run_groups(grps=grps):
                    t = [x.clone() for x in st]
                    for (w0, n), g in grps:
                        dense_phase(t[0], t[1][w0 * si:(w0 + n) * si], g, lr,
                                    reg, mu, **kw, echo=ECHO,
                                    deps=g["deps"])
                run_groups()  # warm-up
                gms = cuda_ms(run_groups, reps=3)
                gb = dense_bound([g for _, g in grps], su, si, rank,
                                 echo=ECHO)
                runs.update({f"{key}_ms": gms, f"{key}_bound_ms": gb[0]})
                log(f"[kernel] {label}, {key}: {len(grps)} group(s), "
                    f"{sum(g['deps'].n_tiles for _, g in grps)} slots: "
                    f"{gms:.4f} ms (mean of 3, tables copied in); bound "
                    f"{gb[0]:.4f} ms ({gb[1]})")
        out[name] = (res, b, runs)
        del tabs
        torch.cuda.empty_cache()
    return out


def store_forms(forms, results, bounds, sweeps, variant=None):
    """Phase 25's checks into the kernels line: at ml25m_rank64's cell (no
    ``variant``) as entries of their own, at another cell as "variants" of
    that entry of the same form, described by ``variant`` (no path runs
    them)."""
    for name, (res, b, runs) in forms.items():
        if variant is None:
            results[name], bounds[name], sweeps[name] = res, b, runs
            continue
        sweeps[name].setdefault("variants", []).append({
            "variant": variant, "max_abs_err": res[0], "ms": res[1],
            "plain_ms": res[2], "bound_ms": b[0], "bound_by": b[1], **runs})


# phase 26: ml25m_rank64 with each dense and MXU setting, from phase 4's
# untrained model: (overrides, the kernels it launches and no other, its
# held-out window: 'gate' <= RMSE_GATE, 'bf16' within BF16_TOL of phase 4
# and <= RMSE_GATE, 'modes' within BIAS_MODES_TOL of phase 4, None below
# the untrained model's only)
VARIANT_RUNS = {
    "a": (["sgd.dense_echo=2"],
          {"sgd_sweep", "dense_phase:lane", "dense_phase:lane:echo"}, "gate"),
    "b": (["sgd.dense_spg=2"], {"sgd_sweep", "dense_phase:lane"}, "gate"),
    "c": (["sgd.mxu=bf16"], {"sgd_sweep", "sgd_sweep:bf16",
                             "dense_phase:lane"}, "bf16"),
    "d": (["sgd.dense_chi=0.0025", "sgd.dense_span=head"],
          {"sgd_sweep", "dense_phase:lane"}, "gate"),
    "e": (["sgd.mxu=bf16", "sgd.bias_mode=tile", "sgd.step_user_batch=true"],
          {"sgd_sweep_step_u", "sgd_sweep_step_u:bf16",
           "dense_phase:frozen"}, "modes"),
    "f": (["sgd.mxu=bf16", "sgd.bias_mode=epoch"],
          {"sgd_sweep_epoch", "sgd_sweep_epoch:bf16", "dense_phase:frozen"},
          "modes"),
    "g": (["sgd.mxu=bf16", "sgd.bias_mode=tile"],
          {"sgd_sweep_tile", "sgd_sweep_tile:bf16", "dense_phase:frozen"},
          "modes"),
    "h": (["sgd.mxu=bf16", "model.use_bias=false"],
          {"sgd_sweep_tile", "sgd_sweep_tile:bf16", "dense_phase:none"},
          None),
    "i": (["sgd.dense_echo=2", "model.use_bias=false"],
          {"sgd_sweep_tile", "dense_phase:none", "dense_phase:none:echo"},
          None),
}
VARIANT_EPOCHS = 2
VARIANT_LAUNCHES = {
    "dense_phase_echo": ("a", "dense_phase:lane:echo"),
    "sgd_sweep_bf16": ("c", "sgd_sweep:bf16"),
    "sgd_sweep_step_u_bf16": ("e", "sgd_sweep_step_u:bf16"),
    "sgd_sweep_epoch_bf16": ("f", "sgd_sweep_epoch:bf16"),
    "sgd_sweep_tile_bf16": ("g", "sgd_sweep_tile:bf16"),
    "sgd_sweep_tile_none_bf16": ("h", "sgd_sweep_tile:bf16"),
    "dense_phase_none_echo": ("i", "dense_phase:none:echo"),
}
BF16_TOL = 0.003  # of the f32 run's held-out RMSE


def variant_runs(dev, cfg, train, test, fresh_model, trained, lane_rmse):
    """Phase 26: the ml25m_rank64 preset for VARIANT_EPOCHS epochs in each
    run of VARIANT_RUNS through train_epochs_blocked, from phase 4's
    untrained model on its split. Each launches its kernels and no other,
    its train RMSE falls and its held-out RMSE (unclipped) ends below the
    untrained model's and in its window; (b) ends with the tables and
    held-out RMSE of phase 4's run (``trained``, ``lane_rmse``) bit for
    bit and counts the reference's padding (strata_padded > num_strata).
    Returns the
    launches of VARIANT_LAUNCHES."""
    import torch

    t_phase = time.perf_counter()
    runs, last = {}, {}
    for key, (ov, want, window) in VARIANT_RUNS.items():
        lo, hi = {"gate": (-float("inf"), RMSE_GATE),
                  "bf16": (lane_rmse - BF16_TOL,
                           min(RMSE_GATE, lane_rmse + BF16_TOL)),
                  "modes": (lane_rmse - BIAS_MODES_TOL,
                            lane_rmse + BIAS_MODES_TOL)}.get(window,
                                                             (None, None))
        runs[key] = (ov + [f"sgd.epochs={VARIANT_EPOCHS}"], want,
                     None if lo is None else (lo, hi))
    _, out = train_runs(dev, cfg, train, test, fresh_model, runs, "variant",
                        last=last)
    model_b, info_b = last["b"]
    if not (all(torch.equal(getattr(model_b, k), getattr(trained, k))
                for k in ("P", "Q", "bu", "bi"))
            and out["b"][2][-1] == lane_rmse):
        raise AssertionError("(b) dense_spg=2: not phase 4's tables and "
                             f"held-out RMSE ({out['b'][2][-1]} vs "
                             f"{lane_rmse})")
    if not info_b["strata_padded"] > info_b["num_strata"]:
        raise AssertionError(f"(b): no padding counted {info_b}")
    log(f"[variant] (b) dense_spg=2: tables and held-out RMSE "
        f"{out['b'][2][-1]:.5f} bit for bit phase 4's; {info_b['num_strata']}"
        f" strata (the reference pads them to {info_b['strata_padded']})")
    log("[variant] held-out RMSE after each epoch, unrounded: " + "; ".join(
        f"({k}) {' '.join(repr(x) for x in v[2])}" for k, v in out.items())
        + f"; phase 4's {lane_rmse!r}")
    log(f"[variant] (d) the head carving: dense_frac "
        f"{last['d'][1]['dense_frac']:.4f} ({last['d'][1]['num_strata']} "
        "strata)")
    log(f"[time] phase 26 {time.perf_counter() - t_phase:.1f} s")
    return {name: out[run][0][k]
            for name, (run, k) in VARIANT_LAUNCHES.items()}


# ---- phases 27-28: ranks 16 to 1 of the four sweep kernels ---------------

NARROW_RANKS = (16, 8, 4, 2, 1)
# phase 27: the f32 forms against plain (tiles), and its bf16 forms (the
# plain sums in kernel order); cut for the script's time
NARROW_TILES = 256
NARROW_BF16_TILES = 128
NARROW_BINS = {16: 12, 8: 4}  # the time form's bins: the most each holds
# phase 27's bpr_sweep forms on one block and the card's count: the first
# 131,072 of segment 0's 624,376 tiles (a cut for the script's time)
NARROW_BPR_WHOLE = 131_072
# phase 27's f32 sweep forms at each rank: (body, bias traffic, residual
# bytes a slot), as BF16_FORMS
NARROW_FORMS = {"sgd_sweep": ("lane", None, 0),
                "sgd_sweep_tile": ("tile", "update", 0),
                "sgd_sweep_tile_none": ("none", None, 0),
                "sgd_sweep_epoch": ("epoch", "read", 4),
                "sgd_sweep_step_u": ("step_u", "update", 0)}
# phase 28 on ml1m_rank32_biased: (rank, overrides, the kernels it launches
# and no other, the kernels-line entry its launches go to, that entry's
# count); (a2), (a1), (d2), (e2) and (f2) are (a), (d), (e) and (f) at
# ranks 2 and 1 (the lane form has none at rank 1)
NARROW_RUNS = {
    "a": (16, [], {"sgd_sweep_tile"}, "sgd_sweep_tile_r16", "sgd_sweep_tile"),
    "b": (8, [], {"sgd_sweep_tile"}, "sgd_sweep_tile_r8", "sgd_sweep_tile"),
    "c": (4, [], {"sgd_sweep_tile"}, "sgd_sweep_tile_r4", "sgd_sweep_tile"),
    "d": (16, ["sgd.bias_mode=lane"], {"sgd_sweep"}, "sgd_sweep_r16",
          "sgd_sweep"),
    "e": (16, ["sgd.step_user_batch=true"], {"sgd_sweep_step_u"},
          "sgd_sweep_step_u_r16", "sgd_sweep_step_u"),
    "f": (16, ["sgd.mxu=bf16"], {"sgd_sweep_tile", "sgd_sweep_tile:bf16"},
          "sgd_sweep_tile_bf16_r16", "sgd_sweep_tile:bf16"),
    "a2": (2, [], {"sgd_sweep_tile"}, "sgd_sweep_tile_r2", "sgd_sweep_tile"),
    "a1": (1, [], {"sgd_sweep_tile"}, "sgd_sweep_tile_r1", "sgd_sweep_tile"),
    "d2": (2, ["sgd.bias_mode=lane"], {"sgd_sweep"}, "sgd_sweep_r2",
           "sgd_sweep"),
    "e2": (2, ["sgd.step_user_batch=true"], {"sgd_sweep_step_u"},
           "sgd_sweep_step_u_r2", "sgd_sweep_step_u"),
    "f2": (2, ["sgd.mxu=bf16"], {"sgd_sweep_tile", "sgd_sweep_tile:bf16"},
           "sgd_sweep_tile_bf16_r2", "sgd_sweep_tile:bf16"),
}
# (a), (b), (a2) and (a1): the JAX trainer's run of the same configuration
# on the same full data on a CPU (tools/bias_mode_check.py --preset
# ml1m_rank32_biased --cut 1 --rank R, from its own seeded init), held-out
# RMSE after 30 epochs; the port's run must end within NARROW_JAX_TOL of it
NARROW_JAX = {16: 0.52536, 8: 0.52582, 2: 0.52586, 1: 0.52511}
NARROW_JAX_TOL = 0.003
# each bf16 run and the f32 run it must end within NARROW_BF16_TOL of
NARROW_BF16_OF = {"f": "d", "f2": "a2"}
NARROW_BF16_TOL = 0.003
NARROW_PATH_BPR = (16, 8, 2, 1)  # phase 28 (i)
# (i)'s ranks whose loss must also end below ln 2 in the preset's 5
# epochs; at ranks 2 and 1 it starts at 0.70-0.71 (the untrained model's
# logits are wider than at rank 8) and falls every epoch, which is their
# gate, but 5 epochs leave it above ln 2 (printed)
NARROW_BPR_LN2 = (16, 8)
NARROW_SERVE_TILE = 256  # (d)'s model served
# phase 28 (g): ml25m_rank64 at these ranks (the lane form)
NARROW_ML25M = (16, 2)
# the kernels line: each entry of phases 27-28 that a path of phase 28
# runs, and the forms no path runs, held as its "variants"
NARROW_ENTRIES = {
    "sgd_sweep_r16": ("sgd_sweep_r8", "sgd_sweep_r4"),
    "sgd_sweep_tile_r16": ("sgd_sweep_tile_none_r16", "sgd_sweep_epoch_r16"),
    "sgd_sweep_tile_r8": ("sgd_sweep_tile_none_r8", "sgd_sweep_epoch_r8"),
    "sgd_sweep_tile_r4": ("sgd_sweep_tile_none_r4", "sgd_sweep_epoch_r4"),
    "sgd_sweep_step_u_r16": ("sgd_sweep_step_u_r8", "sgd_sweep_step_u_r4"),
    "sgd_sweep_tile_bf16_r16": tuple(
        f"{n}_r{r}" for r in (16, 8, 4) for n in BF16_FORMS
        if (n, r) != ("sgd_sweep_tile_bf16", 16)),
    "sgd_sweep_time_r16": ("sgd_sweep_time_r8",),
    "bpr_sweep_r16": (),
    "bpr_sweep_r8": ("bpr_sweep_r4",),
    "sgd_sweep_r2": (),
    "sgd_sweep_tile_r2": ("sgd_sweep_tile_none_r2", "sgd_sweep_epoch_r2"),
    "sgd_sweep_tile_r1": ("sgd_sweep_tile_none_r1", "sgd_sweep_epoch_r1"),
    "sgd_sweep_step_u_r2": ("sgd_sweep_step_u_r1",),
    "sgd_sweep_tile_bf16_r2": tuple(
        f"{n}_r{r}" for r in (2, 1) for n in BF16_FORMS
        if (n, r) != ("sgd_sweep_tile_bf16", 2)
        and (r > 1 or BF16_FORMS[n][0] != "lane")),
    "bpr_sweep_r2": (),
    "bpr_sweep_r1": (),
}
_NARROW_S = {"27": 0.0, "28": 0.0}


def narrow_time(phase, t0, what):
    """Adds the seconds since ``t0`` to phase 27's or 28's wall time and
    prints them."""
    dt = time.perf_counter() - t0
    _NARROW_S[phase] += dt
    log(f"[time] phase {phase} ({what}) {dt:.1f} s")


def narrow_sweep_forms(dev, cfg, train, forms):
    """Phase 27 on ``cfg``'s (ml1m_rank32_biased's) plan of ``train`` (su
    = si = 512, T = 256): at each rank of NARROW_RANKS, from seeded tables
    with N(0, 0.1) biases, each f32 form of NARROW_FORMS against its plain
    version on the first NARROW_TILES tiles of the first sweep (within
    TOL, two kernel runs bitwise) and each bf16 form of BF16_FORMS on the
    first NARROW_BF16_TILES (bf16_forms: bitwise, the f32 form from the
    same state the control that must land off); every form then over the
    whole sweep once on one block and twice on the card's count
    (bitwise). The lane forms are left out at rank 1, which has no lane
    model. Fills ``forms`` {name_r<rank>: ((err, ms, plain_ms), bound,
    whole-run dict)}."""
    import torch

    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.packing import lane_tables, plain_tables
    from mfx_torch.models.mf import init_model
    from mfx_torch.solvers import blocked

    sgd, seed = cfg.sgd, cfg.data.seed
    U, I = train.num_users, train.num_items
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG
    args = (sgd.lr, sgd.reg, float(train.global_mean), su, si, tpg)
    u, i, r = (torch.as_tensor(x).to(dev) for x in
               (train.user, train.item, train.rating))
    u, i, r = u.int(), i.int(), r.float()
    lib = _build.load_library()
    for rank in NARROW_RANKS:
        skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                       blocked.sweep_geometry(I, rank, si))
        tl = pdv.epoch_tiles_device(skel, u, i, r, seed, 0)
        g = torch.Generator(device=dev).manual_seed(rank)
        model = init_model(g, U, I, rank, global_mean=train.global_mean,
                           device=dev)
        model.bu.copy_(torch.randn(U, device=dev, generator=g) * 0.1)
        model.bi.copy_(torch.randn(I, device=dev, generator=g) * 0.1)
        lane = lane_tables(model, su, si, dev)
        plain = plain_tables(model, su, si, dev)
        sw = next(x for x in skel.sweeps if x.t1 > x.t0)
        seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
        nt = min(NARROW_TILES, sw.t1 - sw.t0)
        head = (sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous(),
                tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt))
        whole = (sw.sa, sw.tc, tl[sw.t0:sw.t1], sw.deps)
        log(f"[narrow] rank {rank}: {len(skel.sweeps)} sweep(s) of "
            f"{tl.shape[0]} tiles; the first {sw.t1 - sw.t0} tiles in "
            f"{sw.deps.runs.shape[0]} runs, critical path {sw.deps.critical}"
            f"; its first {nt}: critical path {head[3].critical}; seeded "
            f"rank-{rank} tables, biases N(0, 0.1)")
        card = {"lane": lib.mfx_sgd_sweep_max_blocks(T, rank),
                "step_u": lib.mfx_sgd_sweep_step_u_max_blocks(T, rank, su)}
        for name, (body, bias, slot_bytes) in NARROW_FORMS.items():
            if body == "lane" and rank < 2:
                continue
            label = f"{name}_r{rank}"

            def state(n, body=body):
                if body == "lane":
                    return tuple(lane)
                return tuple(plain) + ((torch.zeros(n, T, device=dev),)
                                       if body == "epoch" else ())

            res = compare(
                label, sweep_form_run(body, head, seg, *args, bf16=False),
                sweep_form_run(body, head, seg, *args, kernel=False,
                               bf16=False), state(nt))
            b = sweep_bound(head[2], head[0], head[1], su, si, tpg, rank,
                            [("P", 0), ("Q", 1)], 10, bias=bias,
                            slot_bytes=slot_bytes)
            runs = whole_sweep(
                label, lambda *t, body=body: sweep_form_run(
                    body, whole, seg, *args, blocks=t[-1],
                    bf16=False)(*t[:-1]),
                state(sw.t1 - sw.t0), sw.deps,
                card.get(body, lib.mfx_sgd_sweep_tile_max_blocks(T, rank)))
            runs.update({"tiles": nt, "critical_tiles": head[3].critical,
                         "sweep_bound_ms": sweep_bound(
                             whole[2], whole[0], whole[1], su, si, tpg, rank,
                             [("P", 0), ("Q", 1)], 10, bias=bias,
                             slot_bytes=slot_bytes)[0]})
            log(f"[kernel] {label}: {nt} tiles {res[1]:.4f} ms, plain "
                f"{res[2]:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
            forms[label] = (res, b, runs)
        bodies = tuple(n for n, f in BF16_FORMS.items()
                       if rank > 1 or f[0] != "lane")
        for name, out in bf16_forms(f"_r{rank}", lane, plain, sw, tl, *args,
                                    bodies=bodies,
                                    tiles=NARROW_BF16_TILES).items():
            out[2]["critical_tiles"] = sw.deps.prefix(out[2]["tiles"]).critical
            forms[f"{name}_r{rank}"] = out
        del skel, tl, lane, plain, model, head, whole
        torch.cuda.empty_cache()


def narrow_ml1m_phases(dev, forms):
    """Phases 27 and 28 on ml1m_rank32_biased and the full ML-1M-shaped
    synthetic: narrow_sweep_forms, then the runs of NARROW_RUNS, each its
    30 epochs through train_epochs_blocked from the seeded untrained model
    of its rank: its kernels and no other launched, the train RMSE falls
    every epoch and the held-out RMSE (unclipped) lies below the untrained
    model's after every epoch; (a), (b), (a2) and (a1) end within
    NARROW_JAX_TOL of the JAX trainer's run (NARROW_JAX), each bf16 run
    within NARROW_BF16_TOL of its f32 run (NARROW_BF16_OF). Then (d)'s
    rank-16 model through the stock, fused and certified-exact
    recommenders (narrow_serve), and (a2)'s rank-2 model through the
    CLI's recommend --fused (narrow_cli_serve). Returns each run's
    launches under its kernels-line entry, and (e)'s record."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.models.mf import init_model

    t_phase = time.perf_counter()
    cfg = preset("ml1m_rank32_biased")
    coo = make_synthetic(*ML1M_SHAPE, rank=32, seed=101, star_step=1.0,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    narrow_sweep_forms(dev, cfg, train, forms)
    narrow_time("27", t_phase, "the ML-1M forms at ranks 16 to 1")

    t_phase = time.perf_counter()
    log(f"[narrow] path: ml1m_rank32_biased (su = si = {cfg.sgd.ublock}, T "
        f"= {cfg.sgd.tile}, {cfg.sgd.epochs} epochs, bias_mode "
        f"{cfg.sgd.bias_mode!r}) at ranks {NARROW_RANKS} on the ml-1m "
        f"synthetic ({train.n_ratings} train ratings)")
    launches, finals, last = {}, {}, {}
    for key, (rank, ov, want, entry, count) in NARROW_RUNS.items():
        def fresh_model(rank=rank):
            g = torch.Generator(device=dev)
            g.manual_seed(cfg.model.seed)
            return init_model(g, coo.num_users, coo.num_items, rank,
                              global_mean=train.global_mean,
                              init_scale=cfg.model.init_scale, device=dev)

        window = None
        if NARROW_JAX.get(rank) is not None and not ov:
            window = (NARROW_JAX[rank] - NARROW_JAX_TOL,
                      NARROW_JAX[rank] + NARROW_JAX_TOL)
        if key in NARROW_BF16_OF:
            f32 = finals[NARROW_BF16_OF[key]]
            window = (f32 - NARROW_BF16_TOL, f32 + NARROW_BF16_TOL)
        _, out = train_runs(dev, cfg, train, test, fresh_model,
                            {key: ([f"model.rank={rank}"] + ov, want,
                                   window)},
                            "narrow", every_epoch=True, last=last)
        launches[entry] = out[key][0][count]
        finals[key] = out[key][2][-1]
        if window is not None:
            log(f"[narrow] ({key}) held-out {finals[key]:.5f} within "
                f"[{window[0]:.5f}, {window[1]:.5f}]")
    log(f"[narrow] held-out RMSE after 30 epochs, unrounded: " + "; ".join(
        f"({k}) {v!r}" for k, v in finals.items())
        + "".join(f"; ({k}) - ({f}) {finals[k] - finals[f]:.3e}"
                  for k, f in NARROW_BF16_OF.items()))
    narrow_serve(dev, last["d"][0], train)
    served = narrow_cli_serve(dev, last["a2"][0], cfg)
    narrow_time("28", t_phase, "(a)-(f2) on ML-1M, (d) and (a2) served")
    return launches, served


def narrow_cli_serve(dev, model, cfg):
    """Phase 28 (e): (a2)'s rank-2 model (mu + bu + bi + p.q with two
    latent lanes) checkpointed and served by the CLI's recommend --fused:
    tile_topk at the augmented width 8 launched (counter > 0), each launch
    made again on its inputs and held against tile_topk_plain (hold_topk;
    the largest difference printed). Returns the check's record."""
    import shutil
    from pathlib import Path

    from mfx_torch.kernels.serve_topk import aug_width
    from mfx_torch.train.checkpoint import save_checkpoint

    if aug_width(model.rank) != 8:
        raise AssertionError(f"rank {model.rank}: augmented width "
                             f"{aug_width(model.rank)}, not 8")
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_rank2"
    shutil.rmtree(ck, ignore_errors=True)
    save_checkpoint(ck, cfg.sgd.epochs - 1, model, cfg.data.seed)
    # tiles of NARROW_SERVE_TILE, as narrow_serve's: the CLI's default
    # 1,024 leaves ML-1M's 3,706 items 4 tiles, 8 candidates < K
    rec, recs = fused_cli_check("(e) rank 2", dev, ck, "0,1,2,3",
                                tile=NARROW_SERVE_TILE)
    shutil.rmtree(ck)
    log(f"[narrow] (e) (a2)'s rank-2 model through the CLI's recommend "
        f"--fused: launches {{'tile_topk': {rec['launches']}}}, each held "
        f"against tile_topk_plain on its inputs (P_aug {rec['P_aug']}, "
        f"Q_aug {rec['Q_aug']}, tile {rec['tile']}, depth {rec['depth']}): "
        f"max abs err {rec['max_abs_err']!r}, lane swaps "
        f"{rec['lane_swaps']}; first user's items {recs[0]['items']}")
    return rec


def narrow_serve(dev, model, train):
    """Phase 28 (d)'s rank-16 model through the stock, fused and
    certified-exact fused recommenders (tile_topk at the augmented width
    24): exact == stock within TOL modulo near-ties on 1,024 drawn users
    and the 256 heaviest; the fused contract as phase 6 holds it;
    tile_topk launched."""
    import numpy as np
    import torch

    from mfx_torch.kernels.serve_topk import aug_width, tile_topk
    from mfx_torch.serve import FusedTopKRecommender, TopKRecommender

    if aug_width(model.rank) != 24:
        raise AssertionError(f"rank {model.rank}: augmented width "
                             f"{aug_width(model.rank)}, not 24")
    tile_topk.launches = 0
    stock = TopKRecommender(model, train=train, device=dev)
    # tiles of NARROW_SERVE_TILE: ML-1M's 3,706 items make 15, whose
    # depth-2 pool holds the K = 10 the approximate path returns
    approx = FusedTopKRecommender(model, train=train, tile=NARROW_SERVE_TILE,
                                  device=dev)
    exact = FusedTopKRecommender(model, train=train, tile=NARROW_SERVE_TILE,
                                 exact=True, exact_tiles=16, device=dev)
    counts = np.bincount(train.user, minlength=model.num_users)
    rng = np.random.default_rng(16)
    users = np.concatenate([
        rng.choice(np.flatnonzero(counts > 0), 1024, replace=False),
        np.argsort(counts, kind="stable")[-256:]]).astype(np.int32)
    si, ss = stock.recommend(users, k=K)
    ei, es = exact.recommend(users, k=K)
    gap = np.abs(es - ss)
    if not np.all(gap <= TOL) or not np.all(np.isfinite(es)):
        raise AssertionError(f"rank 16: exact != stock: gap {gap.max()}")
    ai, as_ = approx.recommend(users[:1024], k=K)
    u_t = torch.as_tensor(users[:1024], device=dev).long()[:, None]
    i_t = torch.as_tensor(ai, device=dev).long()
    true = (model.mu + model.bu[u_t] + model.bi[i_t]
            + (model.P[u_t] * model.Q[i_t]).sum(-1)).double()
    err = float((true - torch.as_tensor(as_, device=dev)).abs().max())
    if (err > TOL or (ai >= model.num_items).any()
            or (np.diff(as_, axis=1) > 0).any()):
        raise AssertionError(f"rank 16: fused contract broken ({err})")
    recall = np.mean([len(set(ai[b]) & set(si[b])) / K
                      for b in range(1024)])
    log(f"[narrow] serve (d)'s rank-16 model (augmented width 24, tiles of "
        f"{NARROW_SERVE_TILE}): exact == "
        f"stock on {len(users)} users, {int((ei != si).sum())} item swaps, "
        f"all near-ties (score gap <= {gap.max():.3e}), exact_fallbacks "
        f"{exact.exact_fallbacks}; fused scores within {err:.3e} of the "
        f"true scores, recall@{K} against stock {recall:.4f}; tile_topk "
        f"launches {tile_topk.launches}")
    if tile_topk.launches < 1:
        raise AssertionError("rank 16: tile_topk never launched")


def narrow_ml25m_run(dev, cfg, train, test):
    """Phase 28 (g): ml25m_rank64 unchanged but for model.rank (each of
    NARROW_ML25M: 16, and 2, the baseline predictor mu + bu + bi), 2
    epochs on phase 4's data from the seeded untrained model of the rank:
    every rating through the lane sweep (no dense phase runs below rank
    32), held-out RMSE (unclipped) below the untrained model's, and a
    second run bit for bit the first; each run's epoch seconds logged."""
    import torch

    from mfx_torch.models.mf import init_model

    t_phase = time.perf_counter()
    for rank in NARROW_ML25M:
        def fresh_model(rank=rank):
            g = torch.Generator(device=dev)
            g.manual_seed(cfg.model.seed)
            return init_model(g, train.num_users, train.num_items, rank,
                              global_mean=train.global_mean, device=dev)

        key = "g" if rank == 16 else f"g{rank}"
        runs = {key: ([f"model.rank={rank}", "sgd.epochs=2"], {"sgd_sweep"},
                      None)}
        firsts, lasts = [], []
        for _ in range(2):
            last: dict = {}
            _, out = train_runs(dev, cfg, train, test, fresh_model, runs,
                                "narrow", last=last)
            firsts.append(out[key])
            lasts.append(last[key])
        (m1, info), (m2, _) = lasts
        if info.get("num_strata", 0) or not all(
                torch.equal(getattr(m1, k), getattr(m2, k))
                for k in ("P", "Q", "bu", "bi")) or (
                    firsts[0][2] != firsts[1][2]):
            raise AssertionError(f"({key}): a dense phase ran, or a second "
                                 "run differs from the first")
        log(f"[narrow] ({key}) ml25m_rank64 at rank {rank}: a second run "
            f"repeats the tables and held-out RMSEs {firsts[0][2]} bit for "
            f"bit; lane sweep launches {firsts[0][0]['sgd_sweep']}")
    narrow_time("28", t_phase, "(g) ml25m_rank64 at ranks "
                + " and ".join(map(str, NARROW_ML25M)))


def narrow_time_phase(dev, tcoo, forms):
    """Phase 27's time form on phase 15's temporal data ``tcoo`` at the
    blocked timeSVD trainer's shapes (su = si = 512, T = 256): at rank 16
    with 12 bins and at rank 8 with 4 (NARROW_BINS), NARROW_TILES tiles of
    the first sweep against plain (within TOL, two kernel runs bitwise)
    and the whole first sweep once on one block and twice on the card's
    count (bitwise), into ``forms``. Then phase 28 (h): solver=timesvd at
    rank 16 with 12 bins, TimeSVDConfig's epochs through
    train_epochs_timesvd_blocked from the seeded rank-16 model: the time
    form launched and no other kernel, the train RMSE falls every epoch,
    the time-aware held-out RMSE (clipped to [0.5, 5], as the driver's)
    ends below the untrained model's and below lane MF's at rank 16 (the
    same blocks, epochs, lr and reg through sgd_sweep, as phase 16's).
    Returns the time form's launches in (h)."""
    import torch

    from mfx_torch.config import SGDConfig
    from mfx_torch.data.split import train_test_split
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels.packing import pad_rows, to_tlane_model
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_plain, sgd_sweep_time
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.timesvd import rmse_mae_time

    t_phase = time.perf_counter()
    cfg = timesvd_config(None)
    tc, seed = cfg.timesvd, cfg.data.seed
    train, test = train_test_split(tcoo, cfg.data.test_frac, seed=seed)
    U, I = tcoo.num_users, tcoo.num_items
    su = si = tsb.BLOCK
    T, tpg, lr, reg = tsb.TILE, blocked.TPG, tc.lr, tc.reg
    mu = float(train.global_mean)
    lib = _build.load_library()

    def fresh_model(rank):
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale, device=dev)

    for rank, nb in NARROW_BINS.items():
        feats = fit_time_features(train, n_bins=nb, beta=tc.beta)
        tb, dv = feats.features(train.user, train.timestamp)
        plan = tsb.build_temporal_plan_skeleton(
            train, tb, dv, su=su, si=si, tile=T, tpg=tpg,
            nwin=blocked.sweep_geometry(I, rank, si), device=dev)
        tl, sws = tsb.plan_temporal_epoch_device(*plan, seed, 0)
        g = torch.Generator(device=dev).manual_seed(rank)
        ts = init_timesvd(None, U, I, rank, nb, base=fresh_model(rank))
        ts.bt.copy_(torch.randn(I, nb, device=dev, generator=g) * 0.1)
        ts.alpha.copy_(torch.randn(U, device=dev, generator=g) * 0.1)
        lanes = to_tlane_model(ts, nb)
        P, Q = pad_rows(lanes.P, su), pad_rows(lanes.Q, si)
        sw = sws[0]
        nt = min(NARROW_TILES, sw.t1 - sw.t0)
        sa, tcs = sw.sa[:nt // tpg].contiguous(), sw.tc[:nt].contiguous()
        tls, deps = tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt)
        seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
        kw = dict(su=su, si=si, tpg=tpg, n_bins=nb)
        name = f"sgd_sweep_time_r{rank}"
        log(f"[kernel] {name}: {nt} tiles of the first sweep (T={T}, rank "
            f"{rank}, {nb} bins, L = {rank - 3 - nb} latent lanes); "
            f"{len(sws)} sweep(s), critical path of the tiles "
            f"{deps.critical}")
        res = compare(
            name,
            lambda Pt, Qt: sgd_sweep_time(Pt, Qt[seg], sa, tcs, tls, lr, reg,
                                          mu, **kw, deps=deps),
            lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], sa, tcs, tls, lr,
                                           reg, mu, **kw),
            (P, Q))
        bnd = sweep_bound(tls, sa, tcs, su, si, tpg, rank,
                          [("P", 0), ("Q", 1)], None,
                          slot_ops=time_slot_ops(rank, nb))
        runs = whole_sweep(
            name,
            lambda Pt, Qt, blocks: sgd_sweep_time(
                Pt, Qt[seg], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu,
                **kw, deps=sw.deps, blocks=blocks),
            (P, Q), sw.deps, lib.mfx_sgd_sweep_time_max_blocks(T, rank))
        runs.update({"tiles": nt, "critical_tiles": deps.critical,
                     "n_bins": nb, "sweep_bound_ms": sweep_bound(
                         tl[sw.t0:sw.t1], sw.sa, sw.tc, su, si, tpg, rank,
                         [("P", 0), ("Q", 1)], None,
                         slot_ops=time_slot_ops(rank, nb))[0]})
        log(f"[kernel] {name} bound {bnd[0]:.4f} ms ({bnd[1]}; "
            f"{time_slot_ops(rank, nb)} operations a real slot)")
        forms[name] = (res, bnd, runs)
        del plan, tl, sws, P, Q, lanes, ts
        torch.cuda.empty_cache()
    narrow_time("27", t_phase, "the time form at ranks 16 and 8")

    # 28 (h). blocked timeSVD at rank 16, 12 bins, against lane MF
    t_phase = time.perf_counter()
    rank, nb, clip = 16, NARROW_BINS[16], (0.5, 5.0)
    tc = dataclasses.replace(tc, n_bins=nb)
    feats = fit_time_features(train, n_bins=nb, beta=tc.beta)
    base, _ = rmse_mae_time(init_timesvd(None, U, I, rank, nb,
                                         base=fresh_model(rank)),
                            feats, test, clip=clip)
    kernel_counts(reset=True)
    trains, walls = [], []
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    for _, ts, tr in tsb.train_epochs_timesvd_blocked(
            fresh_model(rank), train, tc, seed=seed, feats=feats,
            device=dev):
        trains.append(float(tr))
        walls.append(time.perf_counter() - t_prev)
        t_prev = time.perf_counter()
    counts = kernel_counts()
    got, _ = rmse_mae_time(ts, feats, test, clip=clip)
    mf_cfg = SGDConfig(
        lr=tc.lr, reg=tc.reg, lr_decay=tc.lr_decay, epochs=tc.epochs,
        partitioner="blocked", kernel="pallas", ublock=su, iblock=si,
        tile=T, bias_mode="lane", dense_chi=0, plan_device="device")
    for _, mf, _ in blocked.train_epochs_blocked(fresh_model(rank), train,
                                                 mf_cfg, True, seed=seed,
                                                 device=dev):
        pass
    mf_rmse, _ = rmse_mae(mf, test, clip=clip)
    log(f"[narrow] (h) blocked timeSVD, rank {rank}, {nb} bins, "
        f"{tc.epochs} epochs: epoch s (first, median of the others) "
        f"{walls[0]:.4f}, {sorted(walls[1:])[len(walls[1:]) // 2]:.4f}; "
        f"train_rmse " + " ".join(f"{x:.5f}" for x in trains)
        + f"; held-out time-aware {got:.5f}, lane MF at rank {rank} "
        f"{mf_rmse:.5f}, untrained {base:.5f}; launches {counts}")
    expect_kernels("(h)", counts, {"sgd_sweep_time"})
    if len(trains) != tc.epochs or any(b >= a for a, b in
                                       zip(trains, trains[1:])):
        raise AssertionError(f"(h): the train RMSE did not fall every "
                             f"epoch: {trains}")
    if not got < min(mf_rmse, base):
        raise AssertionError(f"(h): held-out {got} not below lane MF's "
                             f"{mf_rmse} and the untrained {base}")
    narrow_time("28", t_phase, "(h) blocked timeSVD at rank 16")
    return counts["sgd_sweep_time"]


def store_narrow(forms, results, bounds, sweeps):
    """Phases 27-28 into the kernels line: each entry of NARROW_ENTRIES
    with its check, bound and whole-sweep runs, the forms no path runs as
    its "variants"."""
    for name, others in NARROW_ENTRIES.items():
        res, b, runs = forms[name]
        results[name], bounds[name], sweeps[name] = res, b, dict(runs)
        sweeps[name]["variants"] = [
            {"variant": other, "max_abs_err": forms[other][0][0],
             "ms": forms[other][0][1], "plain_ms": forms[other][0][2],
             "bound_ms": forms[other][1][0], "bound_by": forms[other][1][1],
             **forms[other][2]} for other in others]
    log(f"[time] phase 27 {_NARROW_S['27']:.1f} s, phase 28 "
        f"{_NARROW_S['28']:.1f} s")


# phase 29: the Gram-engine solvers (mfx_torch/solvers/als.py, ials.py,
# nmf.py). The reference computes them outside any Pallas kernel, so their
# port is stock torch ops: no kernel of theirs is in the kernels line
ALS_CHECK_ROWS = 8192  # the first user range, solved on the card and the CPU
ALS_CPU_TOL = 3e-3  # rank 128 with bias: tests/unit/test_als.py:102
ALS_CPU_THREADS = 4  # the CPU solve's threads, beside the card's host loop
# 29(a)'s sweeps: 2 of the preset's 8, a cut for the script's time (its
# gate, that the objective never rises, holds sweep by sweep)
ALS_SWEEPS = 2
# ALS-WR's and NMF's regularized objectives never rise (relative):
# tests/unit/test_nmf.py:88
RISE_TOL = 1e-6
# 29(b): the learnable implicit synthetic (users, items, positives, its
# true rank; seed 107), iALS at IALS_LEARN_RANK with the reference test's
# settings and gate (tests/unit/test_ials.py:86-95), and fold-in
IALS_LEARN = (50_000, 5_000, 10_000_000, 8)
IALS_LEARN_RANK = 32
IALS_LEARN_CFG = {"alpha": 30.0, "reg": 0.5, "sweeps": 4}
IALS_AUC_GATE = 0.70
IALS_AUC_SAMPLE = 1_000_000  # training positives the AUC is taken on
FOLD_USERS, FOLD_TOL = 256, 2e-4
ALS64_SWEEPS = 2  # the rank-64 ALS model that is served through tile_topk
_GRAM_S = {"a": 0.0, "b": 0.0, "c": 0.0}
GRAM: dict = {}  # phase 29's records, printed as one JSON line


def gram_time(part, t0, what):
    """Adds the seconds since ``t0`` to phase 29 (part)'s wall time."""
    dt = time.perf_counter() - t0
    _GRAM_S[part] += dt
    log(f"[time] phase 29 ({part}: {what}) {dt:.1f} s")


def precision_check():
    """The Grams and solves are true f32, as the reference's on the CPU:
    TF32 off for matmuls, f32 matmul precision 'highest'."""
    import torch

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError(
            "TF32 or a float32 matmul precision below 'highest' is on: the "
            "Gram engine's parity assumes true f32")
    log("[gram] torch.backends.cuda.matmul.allow_tf32 is False, float32 "
        "matmul precision 'highest'")


def gram_bound(n, rows_target, rows_other, d):
    """(ms, what sets it, ops ms, bytes ms) for one half-sweep: the Gram's
    2 n d² FLOPs at the f32 peak; the bytes of each rating's column and
    value read once, the fixed table read once and the solved table read
    and written once, at the HBM peak."""
    nbytes = n * 8 + rows_other * d * 4 + 2 * rows_target * d * 4
    flops = 2.0 * n * d * d
    return (*bound(nbytes, flops), flops / PEAK_F32 * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def span_kernels(prof, spans):
    """The card's kernel time (ms) in a ``torch.profiler`` trace: adds to
    ``spans[name]`` the kernels launched by ops that start inside a span
    of that name, returns the whole. Read from the trace's raw events (a
    kernel names the op that launched it by correlation id), without the
    profiler's event tree, which takes tens of seconds to build for a
    half-sweep's tens of thousands of ops. The spans' own device-side
    annotations are not kernels."""
    import bisect

    events = prof.profiler.kineto_results.events()
    opens, closes, names, op_start, launched = [], [], [], {}, []
    for e in events:
        name = e.name()
        if e.device_type().name == "CPU":
            if name in spans:
                opens.append(e.start_ns())
                closes.append(e.end_ns())
                names.append(name)
            elif e.linked_correlation_id() == 0:
                op_start[e.correlation_id()] = e.start_ns()
        elif name not in spans and not e.is_user_annotation():
            launched.append((e.linked_correlation_id(), e.duration_ns()))
    order = sorted(range(len(opens)), key=opens.__getitem__)
    opens = [opens[i] for i in order]
    closes = [closes[i] for i in order]
    names = [names[i] for i in order]
    total = 0.0
    for corr, ns in launched:
        total += ns / 1e6
        t = op_start.get(corr)
        if t is None:
            continue
        j = bisect.bisect_right(opens, t) - 1
        if j >= 0 and t <= closes[j]:
            spans[names[j]] += ns / 1e6
    return total


def half_sweep_split(tag, run, n, rows_target, rows_other, d):
    """One half-sweep ``run()`` between CUDA events (the card's time from
    its start to its end) and on the host's clock (the time to issue it),
    under sync debug mode 'error' (a host sync inside it raises), then
    ``run()`` again under ``torch.profiler`` for the split: the card's
    time in the kernels under each of the solvers' spans (``als.SPANS``:
    gather + Gram, scatter, solve) and in the rest (:func:`span_kernels`).
    Prints and returns it beside the bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mfx_torch.solvers.als import SPANS

    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
    try:
        t0 = time.perf_counter()
        ev0.record()
        run()
        ev1.record()
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ev1.synchronize()
    split = {"device_ms": ev0.elapsed_time(ev1), "host_ms": host_ms}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = dict.fromkeys(SPANS, 0.0)
    kernels = span_kernels(prof, spans)
    if not all(spans.values()):
        raise AssertionError(f"{tag}: the trace holds no kernel time in a "
                             f"span: {spans}")
    for s, ms in spans.items():
        split[s.split(".")[1] + "_ms"] = ms
    split["kernels_ms"] = kernels
    split["other_ms"] = kernels - sum(spans.values())
    b = gram_bound(n, rows_target, rows_other, d)
    split.update(bound_ms=b[0], bound_by=b[1], ops_ms=b[2], bytes_ms=b[3])
    split["busy"] = kernels / split["device_ms"]
    log(f"[gram] {tag}: {split['device_ms']:.3f} ms a half-sweep on the card "
        f"(CUDA events; {n} ratings, {rows_target} rows, d = {d}), issued "
        f"in {host_ms:.3f} ms on the host with no host sync; kernels "
        f"(torch.profiler) {kernels:.3f} ms, {split['busy']:.1%} of it: "
        f"gather + Gram {split['gather_gram_ms']:.3f}, "
        f"scatter {split['scatter_ms']:.3f}, solve {split['solve_ms']:.3f}, "
        f"other {split['other_ms']:.3f}; bound {b[0]:.4f} ms ({b[1]}; FLOPs "
        f"{b[2]:.4f} ms, bytes {b[3]:.4f} ms)")
    return split


class Ratings:
    """A split's ratings on the card, for its RMSE and the regularized
    objectives in float64 (in chunks of 2^20 ratings) without a host copy
    a call."""

    CHUNK = 1 << 20

    def __init__(self, coo, dev):
        import torch

        self.u = torch.as_tensor(coo.user).to(dev, torch.int64)
        self.i = torch.as_tensor(coo.item).to(dev, torch.int64)
        self.r = torch.as_tensor(coo.rating).to(dev, torch.float64)
        self.deg_u = torch.bincount(self.u, minlength=coo.num_users).double()
        self.deg_i = torch.bincount(self.i, minlength=coo.num_items).double()

    def sse(self, m):
        import torch

        out = torch.zeros((), dtype=torch.float64, device=self.r.device)
        bu, bi = m.bu.double(), m.bi.double()
        for s in range(0, self.r.shape[0], self.CHUNK):
            u, i = self.u[s:s + self.CHUNK], self.i[s:s + self.CHUNK]
            e = (self.r[s:s + self.CHUNK] - m.mu - bu[u] - bi[i]
                 - (m.P[u].double() * m.Q[i].double()).sum(1))
            out += (e * e).sum()
        return out

    def rmse(self, m) -> float:
        return math.sqrt(float(self.sse(m)) / self.r.shape[0])

    def objective(self, m, reg) -> tuple[float, float]:
        """(Σ e² + reg Σ_u n_u (‖p_u‖² + b_u²) + reg Σ_i n_i (‖q_i‖² + b_i²),
        the RMSE) in one pass: ALS-WR's objective (each half-sweep its
        exact block minimizer), and weighted NMF's (no biases, μ = 0)."""
        sse = self.sse(m)
        pu = (m.P.double() ** 2).sum(1) + m.bu.double() ** 2
        qi = (m.Q.double() ** 2).sum(1) + m.bi.double() ** 2
        obj = sse + reg * ((self.deg_u * pu).sum() + (self.deg_i * qi).sum())
        return float(obj), math.sqrt(float(sse) / self.r.shape[0])


def tables(m):
    return tuple(getattr(m, k).clone() for k in ("P", "Q", "bu", "bi"))


def same_tables(a, b):
    import torch

    return all(torch.equal(x, y) for x, y in zip(tables(a), tables(b)))


def als_netflix_phase(dev, cfg0, train, test, fresh_model, sgd_tests, root):
    """Phase 29(a): netflix100m_rank128_dp with solver=als and
    parallel.mode=single through mfx_torch.train.driver.train on the full
    netflix synthetic (the loader's cache under ``root``), the preset's
    als.sweeps; the run observed sweep by sweep (ALS-WR's objective, train
    and held-out RMSE, unclipped; each sweep's device time from CUDA
    events). Gates: the objective never rises (RISE_TOL; the train RMSE is
    printed: ALS-WR need not lower it), the held-out RMSE ends below the
    untrained model's; one sweep repeated from the same tables bit for
    bit; the first ALS_CHECK_ROWS users' half-sweep rows on the card
    within ALS_CPU_TOL of the port's CPU solve (run in a thread beside the
    card's work); the half-sweeps' split, each with no host sync;
    then the checkpoint through the CLI's recommend. Returns the record."""
    import contextlib
    import io
    import shutil
    import threading

    import numpy as np
    import torch

    from mfx_torch import cli
    from mfx_torch.config import apply_overrides
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.models.mf import MFModel
    from mfx_torch.solvers import als
    from mfx_torch.train.driver import train as drive

    t_phase = time.perf_counter()
    precision_check()
    cfg = apply_overrides(cfg0, ["solver=als", f"data.root={root}",
                                 f"checkpoint_dir={root / 'ck'}",
                                 f"als.sweeps={ALS_SWEEPS}"])
    acfg, rank = cfg.als, cfg.model.rank
    U, I, d = train.num_users, train.num_items, rank + 1
    init = fresh_model()  # the driver's initial tables (same seed and init)
    base, _ = rmse_mae(init, test)
    log(f"[als] cell: netflix100m_rank128_dp with solver=als "
        f"parallel.mode=single (one card instead of the preset's ring); "
        f"rank {rank} with biases (d = {d}), reg {acfg.reg}, {acfg.sweeps} "
        f"sweeps (of the preset's {cfg0.als.sweeps}), user_chunk {acfg.user_chunk} (rows a "
        f"solve {als.gram_rowchunk(d, acfg.user_chunk)}); untrained held-out "
        f"RMSE {base:.5f} (unclipped)")

    # the port's CPU solve of the first user range, in a thread (with
    # ALS_CPU_THREADS of the host's cores: the card's host loop keeps one)
    cpu: dict = {}
    P0, Q0, bu0, bi0 = (t.cpu() for t in tables(init))

    def cpu_solve():
        try:
            t0 = time.perf_counter()
            sel = np.flatnonzero(train.user < ALS_CHECK_ROWS)
            sel = sel[np.argsort(train.user[sel], kind="stable")]
            cpu["rows"] = als.als_half_sweep(
                P0[:ALS_CHECK_ROWS], bu0[:ALS_CHECK_ROWS], Q0, bi0, init.mu,
                train.user[sel], train.item[sel], train.rating[sel],
                acfg.reg, True, row_chunk=acfg.user_chunk)
            cpu["n"], cpu["s"] = sel.shape[0], time.perf_counter() - t0
        except Exception as exc:  # raised again in the main thread
            cpu["error"] = exc

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, ALS_CPU_THREADS))
    worker = threading.Thread(target=cpu_solve)
    worker.start()

    # the driver, observed: its initial tables, each sweep's device time
    # and model
    seen = {"ms": [], "models": []}
    orig = als.train_sweeps_als

    def observed(model, tr, c, use_bias=True, row_chunk=None, start_sweep=0):
        seen["init"] = MFModel(*tables(model), model.mu)
        it = orig(model, tr, c, use_bias, row_chunk, start_sweep)
        while True:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            try:
                sweep, m = next(it)
            except StopIteration:
                return
            t1.record()
            t1.synchronize()
            seen["ms"].append(t0.elapsed_time(t1))
            seen["models"].append(m)
            yield sweep, m

    torch.cuda.reset_peak_memory_stats(dev)
    als.train_sweeps_als = observed
    t0 = time.perf_counter()
    try:
        res = drive(cfg, device=dev)
    finally:
        als.train_sweeps_als = orig
    drive_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if (res.epochs_run != acfg.sweeps or len(res.history) != acfg.sweeps
            or not all(math.isnan(r["train_metric"]) for r in res.history)):
        raise AssertionError(f"als: {res.epochs_run} sweeps, history "
                             f"{res.history}")
    if not same_tables(seen["init"], init):
        raise AssertionError("als: the driver started from other tables")
    tr_d, te_d = Ratings(train, dev), Ratings(test, dev)
    objs, trains = zip(*(tr_d.objective(m, acfg.reg) for m in seen["models"]))
    objs, trains = list(objs), list(trains)
    tests = [te_d.rmse(m) for m in seen["models"]]
    obj0 = tr_d.objective(init, acfg.reg)[0]
    after0 = seen["models"][0]
    seen["models"] = []
    del tr_d, te_d
    for s, (ms, a, b, o) in enumerate(zip(seen["ms"], trains, tests, objs)):
        log(f"[als] sweep {s}: {ms / 1e3:.4f} s on the card, objective "
            f"{o:.6e}, train_rmse {a:.5f} test_rmse {b:.5f} (unclipped; the "
            f"driver's clipped {res.history[s]['test_rmse']:.5f})")
    log(f"[als] driver: {drive_s:.1f} s in all (load, split, init, plan, "
        f"sweeps, evals, checkpoint); peak memory allocated {peak} bytes")
    # each half-sweep minimizes ALS-WR's objective exactly over its block:
    # the objective falls; the unregularized train RMSE need not (here it
    # rises after sweep 0 while the objective falls)
    if any(b > a * (1 + RISE_TOL) for a, b in zip([obj0] + objs, objs)):
        raise AssertionError(f"als: the objective rose: {obj0} {objs}")
    if not tests[-1] < base:
        raise AssertionError(f"als: held-out {tests[-1]} not below the "
                             f"untrained {base}")
    log(f"[als] the objective never rises (untrained {obj0:.6e}); held-out "
        f"{tests[-1]:.5f} below the untrained {base:.5f}; phase 12's SGD "
        f"after each of its {len(sgd_tests)} epochs (of the preset's 15; "
        "for information): " + " ".join(f"{x:.5f}" for x in sgd_tests))

    # one sweep again from the same tables
    for _, again in orig(seen["init"], train,
                         dataclasses.replace(acfg, sweeps=1)):
        pass
    if not same_tables(again, after0):
        raise AssertionError("als: a sweep repeated from the same tables "
                             "differs")
    del again, after0
    log("[als] one sweep repeated from the same tables: bit for bit")

    # the half-sweeps' split, from the untrained tables; the card's first
    # user range against the CPU's
    (uc, uv, up, uch), (ic, iv, ip, ich) = als.sort_sides(
        init, train, als.gram_rowchunk(d, acfg.user_chunk))
    n = train.n_ratings
    log(f"[als] plan: {sum(len(c) for *_, c in uch)} user chunks in "
        f"{len(uch)} ranges, {sum(len(c) for *_, c in ich)} item chunks in "
        f"{len(ich)} ranges; pieces by cap (users / items): "
        + ", ".join(f"{cap}: {len(up[0][cap][0])} / {len(ip[0][cap][0])}"
                    for cap in als.BUCKET_CAPS))
    out: dict = {}

    def user_half():
        out["u"] = als.als_half_sweep(
            init.P, init.bu, init.Q, init.bi, init.mu, None, uc, uv,
            acfg.reg, True, plan=up, chunks=uch)

    def item_half():
        als.als_half_sweep(init.Q, init.bi, init.P, init.bu, init.mu, None,
                           ic, iv, acfg.reg, True, plan=ip, chunks=ich)

    split = {"user": half_sweep_split("als user half-sweep", user_half, n, U,
                                      I, d),
             "item": half_sweep_split("als item half-sweep", item_half, n, I,
                                      U, d)}
    worker.join()
    torch.set_num_threads(threads)
    if "error" in cpu:
        raise cpu["error"]
    got = out["u"][0][:ALS_CHECK_ROWS].cpu(), out["u"][1][:ALS_CHECK_ROWS].cpu()
    err = 0.0
    for g, w in zip(got, cpu["rows"]):
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=ALS_CPU_TOL, atol=ALS_CPU_TOL):
            raise AssertionError(f"als: the card's first {ALS_CHECK_ROWS} "
                                 f"users differ from the CPU's by {err}")
    log(f"[als] the first {ALS_CHECK_ROWS} users' half-sweep rows ({cpu['n']}"
        f" ratings, the hottest users) on the card against the port's CPU "
        f"solve ({cpu['s']:.1f} s in a thread): max abs err {err:.3e} (tol "
        f"{ALS_CPU_TOL})")
    del uc, uv, ic, iv, uch, ich, out

    # serving the checkpoint: stock recommend through the CLI; the fused
    # recommenders take rank < 128 in both packages (AUG_LANES)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if cli.main(["recommend", "--checkpoint", str(root / "ck"),
                     "--users", "0,1,2", "--device", dev.type]) != 0:
            raise AssertionError("cli recommend failed")
    recs = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    if len(recs) != 3 or any(len(r["items"]) != K or max(r["items"]) >= I
                             for r in recs):
        raise AssertionError(f"als: CLI recommend: {recs}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["recommend", "--checkpoint", str(root / "ck"),
                      "--users", "0", "--fused", "--device", dev.type])
        raise AssertionError("als: recommend --fused took a rank-128 model")
    except ValueError as exc:
        if "rank < 128" not in str(exc):
            raise
    log(f"[als] CLI recommend on the checkpoint: 3 users in "
        f"{time.perf_counter() - t0:.2f} s; --fused refuses rank {rank} "
        "(fused serving takes rank < 128, as the reference's)")
    shutil.rmtree(root)
    gram_time("a", t_phase, "ALS on the netflix cell")
    return {"sweeps": acfg.sweeps, "sweep_s": [x / 1e3 for x in seen["ms"]],
            "objective": objs, "train_rmse": trains, "test_rmse": tests,
            "untrained": base,
            "peak_bytes": peak, "cpu_max_abs_err": err, "split": split}


def ials_bpr_phase(dev, train, test, model, keys):
    """Phase 29(b), on phase 8's data: one iALS sweep (IALSConfig's
    defaults) at rank 64 from ``model``, timed, its half-sweeps' split, a
    repeat from the same tables bit for bit; the sampled AUC printed."""
    import torch

    from mfx_torch.config import IALSConfig
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.models.mf import MFModel
    from mfx_torch.solvers import ials
    from mfx_torch.solvers.als import gram_rowchunk, sort_sides

    t_phase = time.perf_counter()
    precision_check()
    cfg = dataclasses.replace(IALSConfig(), sweeps=1)
    U, I, k = model.num_users, model.num_items, model.rank
    n = train.n_ratings
    init = tables(model)
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _, m in ials.train_sweeps_ials(MFModel(*init, model.mu), train,
                                           cfg):
            torch.cuda.synchronize()
        runs.append((m, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(dev)
    if not same_tables(runs[0][0], runs[1][0]):
        raise AssertionError("ials: a sweep repeated from the same tables "
                             "differs")
    times = [t for _, t in runs]
    auc0 = sampled_auc(model, test, seed=0, pos_keys=keys)
    auc = sampled_auc(runs[0][0], test, seed=0, pos_keys=keys)
    log(f"[ials] phase 8's data ({U} x {I}, {n} positives), rank {k}, alpha "
        f"{cfg.alpha}, reg {cfg.reg}: one sweep {runs[0][1]:.3f} s, again "
        f"{runs[1][1]:.3f} s (each with its sort and plan), bit for bit; "
        f"held-out sampled AUC {auc0:.5f} -> {auc:.5f}; peak memory "
        f"allocated {peak} bytes")
    del runs
    (uc, uv, up, uch), (ic, iv, ip, ich) = sort_sides(
        model, train, gram_rowchunk(k, cfg.user_chunk))
    P, Q = init[0], init[1]
    split = {
        "user": half_sweep_split(
            "ials user half-sweep", lambda: ials.ials_half_sweep(
                P, Q, None, uc, uv, cfg.alpha, cfg.reg, plan=up, chunks=uch),
            n, U, I, k),
        "item": half_sweep_split(
            "ials item half-sweep", lambda: ials.ials_half_sweep(
                Q, P, None, ic, iv, cfg.alpha, cfg.reg, plan=ip, chunks=ich),
            n, I, U, k)}
    gram_time("b", t_phase, "iALS on phase 8's data")
    return {"sweep_s": times, "peak_bytes": peak, "auc": auc,
            "auc_untrained": auc0, "split": split}


def ials_learn_phase(dev):
    """Phase 29(b), the learnable cell (run while the kernels build: it
    needs none): make_implicit_synthetic(IALS_LEARN, seed 107), iALS at IALS_LEARN_RANK with IALS_LEARN_CFG: the sampled
    AUC on the training positives (as tests/unit/test_ials.py:95 measures
    it) ends above max(IALS_AUC_GATE, untrained + 0.1); the held-out AUC
    printed. Then fold_in_implicit of the first FOLD_USERS users' training
    histories against their rows of a user half-sweep from the trained
    tables, within FOLD_TOL."""
    import numpy as np
    import torch

    from mfx_torch.config import IALSConfig
    from mfx_torch.data.bpr import build_positive_index
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import make_implicit_synthetic
    from mfx_torch.eval.metrics import sampled_auc
    from mfx_torch.models.mf import init_model
    from mfx_torch.serve import fold_in_implicit
    from mfx_torch.solvers import ials
    from mfx_torch.solvers.als import sort_side

    t_phase = time.perf_counter()
    U, I, n, true_rank = IALS_LEARN
    train, test = train_test_split(
        make_implicit_synthetic(U, I, n, rank=true_rank, seed=107), 0.01,
        seed=0)
    log(f"[ials] learnable cell: make_implicit_synthetic({U}, {I}, {n}, "
        f"rank={true_rank}, seed=107), 1% held out (split seed 0); made in "
        f"{time.perf_counter() - t_phase:.1f} s")
    cfg = IALSConfig(**IALS_LEARN_CFG)
    keys = np.concatenate([build_positive_index(train),
                           build_positive_index(test)])
    keys.sort()
    sample = train.select(np.arange(IALS_AUC_SAMPLE))  # the split shuffled

    def auc(m, coo):
        return sampled_auc(m, coo, seed=0, pos_keys=keys)

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    model = init_model(g, U, I, IALS_LEARN_RANK)
    auc0 = auc(model, sample)
    t0 = time.perf_counter()
    for _, m in ials.train_sweeps_ials(model, train, cfg):
        pass
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    auc1, auc_test = auc(m, sample), auc(m, test)
    log(f"[ials] rank {IALS_LEARN_RANK}, {cfg.sweeps} sweeps (alpha "
        f"{cfg.alpha}, reg {cfg.reg}) in {train_s:.2f} s (with the sort and "
        f"plan): sampled AUC on {IALS_AUC_SAMPLE} of the training positives "
        f"{auc0:.5f} -> {auc1:.5f} (gate > max({IALS_AUC_GATE}, untrained + "
        f"0.1)); held-out {auc_test:.5f}")
    if not auc1 > max(IALS_AUC_GATE, auc0 + 0.1):
        raise AssertionError(f"ials: AUC {auc1} not above max("
                             f"{IALS_AUC_GATE}, {auc0} + 0.1)")
    # fold-in against a user half-sweep from the trained tables
    c, v, plan = sort_side(train.user, train.item, train.rating, U, dev)
    rows = ials.ials_half_sweep(m.P, m.Q, None, c, v, cfg.alpha, cfg.reg,
                                plan=plan)
    starts = plan[1][:FOLD_USERS + 1]
    c, v = c[:starts[-1]].cpu().numpy(), v[:starts[-1]].cpu().numpy()
    hists = [(c[a:b], v[a:b]) for a, b in zip(starts[:-1], starts[1:])]
    folded = fold_in_implicit(m, hists, cfg.alpha, cfg.reg, gram=m.Q.T @ m.Q)
    want = rows[:FOLD_USERS]
    err = float((folded - want).abs().max())
    if not torch.allclose(folded, want, rtol=FOLD_TOL, atol=FOLD_TOL):
        raise AssertionError(f"fold_in_implicit: max abs err {err} against "
                             "the half-sweep rows")
    log(f"[ials] fold_in_implicit of {FOLD_USERS} users' histories "
        f"({int(starts[-1])} positives) against their half-sweep rows: max "
        f"abs err {err:.3e} (tol {FOLD_TOL})")
    gram_time("b", t_phase, "the learnable iALS cell and fold-in")
    return {"auc_train": auc1, "auc_untrained": auc0, "auc_test": auc_test,
            "sweeps": cfg.sweeps, "train_s": train_s,
            "fold_max_abs_err": err}, (train, test)


def nmf_phase(dev, cfg0, train, test, fresh_model):
    """Phase 29(c), on phase 4's data (run while the kernels build: it
    needs none): NMF (NMFConfig's defaults, rank 64, model.use_bias=false)
    from phase 4's untrained tables: the objective never rises (RISE_TOL),
    the factors stay >= 0, the held-out RMSE ends below the untrained
    model's; the half-sweeps' split. Returns the record."""
    import torch

    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.solvers import nmf
    from mfx_torch.solvers.als import gram_rowchunk, sort_sides

    t_phase = time.perf_counter()
    precision_check()
    ncfg = cfg0.nmf
    U, I, k = train.num_users, train.num_items, cfg0.model.rank
    init = fresh_model()
    base, _ = rmse_mae(init, test)
    tr_d, te_d = Ratings(train, dev), Ratings(test, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # the objective from NMF's start (the init folded onto the orthant)
    objs, tests, sweep_s = [tr_d.objective(nmf.fold_nonneg(init),
                                           ncfg.reg)[0]], [], []
    t0 = time.perf_counter()
    for s, m in nmf.train_sweeps_nmf(init, train, ncfg, use_bias=False):
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
        if not (bool((m.P >= 0).all()) and bool((m.Q >= 0).all())):
            raise AssertionError(f"nmf: negative factors after sweep {s}")
        objs.append(tr_d.objective(m, ncfg.reg)[0])
        tests.append(te_d.rmse(m))
        t0 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    del tr_d, te_d
    log(f"[nmf] ml25m_rank64 with solver=nmf model.use_bias=false on phase "
        f"4's data: rank {k}, reg {ncfg.reg}, {ncfg.sweeps} sweeps of "
        f"{ncfg.inner_iters} inner updates; seconds a sweep "
        + " ".join(f"{x:.3f}" for x in sweep_s)
        + "; objective from the start " + " ".join(f"{x:.6e}" for x in objs)
        + f"; held-out RMSE (unclipped) " + " ".join(f"{x:.5f}" for x in tests)
        + f"; peak memory allocated {peak} bytes")
    if any(b > a * (1 + RISE_TOL) for a, b in zip(objs, objs[1:])):
        raise AssertionError(f"nmf: the objective rose: {objs}")
    if not tests[-1] < base:
        raise AssertionError(f"nmf: held-out {tests[-1]} not below the "
                             f"untrained {base}")
    log(f"[nmf] the objective never rises, the factors stay >= 0, held-out "
        f"{tests[-1]:.5f} below the untrained {base:.5f} (the folded start "
        f"{rmse_mae(nmf.fold_nonneg(init), test)[0]:.5f})")
    folded = nmf.fold_nonneg(init)
    (uc, uv, up, uch), (ic, iv, ip, ich) = sort_sides(
        folded, train, gram_rowchunk(k, ncfg.user_chunk))
    n = train.n_ratings
    split = {
        "user": half_sweep_split(
            "nmf user half-sweep", lambda: nmf.nmf_half_sweep(
                folded.P, folded.Q, None, uc, uv, ncfg.reg,
                inner_iters=ncfg.inner_iters, plan=up, chunks=uch),
            n, U, I, k),
        "item": half_sweep_split(
            "nmf item half-sweep", lambda: nmf.nmf_half_sweep(
                folded.Q, folded.P, None, ic, iv, ncfg.reg,
                inner_iters=ncfg.inner_iters, plan=ip, chunks=ich),
            n, I, U, k)}
    del uc, uv, ic, iv, uch, ich
    gram_time("c", t_phase, "NMF on phase 4's data")
    return {"sweeps": ncfg.sweeps, "sweep_s": sweep_s, "objective": objs,
            "test_rmse": tests, "untrained": base, "peak_bytes": peak,
            "split": split}


def als64_serve_phase(dev, cfg0, train, test, fresh_model):
    """Phase 29(c), on phase 4's data: ALS at rank 64 (ml25m_rank64's als
    block, ALS64_SWEEPS sweeps) checkpointed and served by the CLI's
    recommend --fused: tile_topk launched (counter > 0), each launch made
    again on its inputs and held against its plain version. Returns the
    check."""
    import shutil
    from pathlib import Path

    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.solvers.als import train_sweeps_als
    from mfx_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    acfg = dataclasses.replace(cfg0.als, sweeps=ALS64_SWEEPS)
    for _, m in train_sweeps_als(fresh_model(), train, acfg):
        pass
    a_rmse = rmse_mae(m, test)[0]
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_als64"
    shutil.rmtree(ck, ignore_errors=True)
    save_checkpoint(ck, ALS64_SWEEPS - 1, m, cfg0.data.seed)
    rec, _ = fused_cli_check("als rank 64", dev, ck, "0,1,2")
    shutil.rmtree(ck)
    log(f"[als] rank 64 (ml25m_rank64's als block, {ALS64_SWEEPS} sweeps) on "
        f"phase 4's data: held-out {a_rmse:.5f} (unclipped); CLI recommend "
        f"--fused on its checkpoint: launches {{'tile_topk': "
        f"{rec['launches']}}}, each held against tile_topk_plain on its "
        f"inputs (P_aug {rec['P_aug']}, Q_aug {rec['Q_aug']}, tile "
        f"{rec['tile']}, depth {rec['depth']}): max abs err "
        f"{rec['max_abs_err']:.3e} (tol {TOL})")
    gram_time("c", t_phase, "ALS at rank 64 served through tile_topk")
    return {**rec, "als_test_rmse": a_rmse}


def fused_cli_check(what, dev, ck, users, tile=None):
    """The CLI's recommend --fused on the checkpoint ``ck`` for ``users``
    (comma-separated; ``--tile`` where given): K items each, tile_topk
    launched (counter > 0), each launch made again on its inputs and held
    against its plain version (hold_topk). Returns (the check's record,
    the recommendations)."""
    import contextlib
    import io

    from mfx_torch import cli
    from mfx_torch.kernels.serve_topk import tile_topk
    from mfx_torch.serve import fused

    calls = []

    def keep(P_aug, Q_aug, **kw):
        calls.append((P_aug.clone(), Q_aug.clone(), kw))
        return tile_topk(P_aug, Q_aug, **kw)

    args = ["recommend", "--checkpoint", str(ck), "--users", users,
            "--fused", "--device", dev.type]
    tile_topk.launches = 0
    fused.tile_topk = keep
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            if cli.main(args + (["--tile", str(tile)] if tile else [])) != 0:
                raise AssertionError(f"{what}: cli recommend --fused failed")
    finally:
        fused.tile_topk = tile_topk
    launches = tile_topk.launches
    recs = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    if (len(recs) != len(users.split(","))
            or any(len(x["items"]) != K for x in recs)):
        raise AssertionError(f"{what}: CLI recommend --fused: {recs}")
    if launches < 1:
        raise AssertionError(f"{what}: recommend --fused never launched "
                             "tile_topk")
    err, swaps = 0.0, 0
    for P_aug, Q_aug, kw in calls:
        e, n, _ = hold_topk(f"tile_topk ({what})",
                            tile_topk(P_aug, Q_aug, **kw), P_aug, Q_aug,
                            kw.get("sb"), kw["tile"], kw["depth"])
        err, swaps = max(err, e), swaps + n
    return {"launches": launches, "max_abs_err": err, "lane_swaps": swaps,
            "P_aug": list(calls[0][0].shape),
            "Q_aug": list(calls[0][1].shape), "tile": calls[0][2]["tile"],
            "depth": calls[0][2]["depth"]}, recs

# ---- phase 30: SVD++ and timeSVD++ (mfx_torch/solvers/svdpp.py,
# timesvdpp.py). Their only hand-written kernel is the time form of
# sgd_sweep.cu, on timeSVD++'s blocked epoch; the rest is stock torch ops,
# as the reference's XLA
# 30(a): ml1m_rank32_biased with solver=svdpp through the CLI, SVDPPConfig's
# 20 epochs, beside the preset's minibatch biased MF for as many. Without
# dup_trust both of the reference's trainers reach NaN in the first epoch
# on this synthetic (tools/svdpp_check.py --dup-trust 0), so both take 16,
# as phase 16's minibatch timeSVD
SVDPP_OVERRIDES = ["solver=svdpp", "svdpp.dup_trust=16"]
SVDPP_MF_OVERRIDES = ["solver=sgd", "sgd.partitioner=fixed", "sgd.kernel=jnp",
                      "sgd.epochs=20", "sgd.dup_trust=16"]
# the JAX trainer's held-out RMSE (clipped, as the driver's) on the same
# data and epochs on a CPU (tools/svdpp_check.py --epochs 20, from its own
# seeded init); the port's must end within SVDPP_JAX_TOL of it
SVDPP_JAX_RMSE, SVDPP_JAX_TOL = 0.527031, 0.003
# the reference's own margin over minibatch MF (tests/unit/test_svdpp.py:136)
SVDPP_MF_MARGIN = 0.01
# 30(b): the blocked timeSVD++ path on phase 15's data, TIMESVDPP_EPOCHS of
# TimeSVDPPConfig's 20 (a cut for the script's time); its lr_y = 0 run and
# the timeSVD run it must equal, TIMESVDPP_COLLAPSE_EPOCHS each
TIMESVDPP_EPOCHS, TIMESVDPP_COLLAPSE_EPOCHS = 2, 2
# 30(c): the minibatch timeSVD++ path on phase 16's temporal ML-1M, 5 of
# the 20 epochs (a cut for the script's time), dup_trust 16 as phase 16's
TIMESVDPP_JNP_EPOCHS = 5


def timesvdpp_config(root, *extra):
    """Phase 30 (b)'s configuration: ml25m_rank64's model and data with
    solver='timesvdpp', timesvdpp.kernel='pallas', TimeSVDPPConfig's
    defaults but reg_alpha = reg, the dataset read from ``root``, no early
    stop."""
    from mfx_torch.config import TimeSVDPPConfig, apply_overrides, preset

    reg = TimeSVDPPConfig().reg
    cfg = apply_overrides(preset("ml25m_rank64"), [
        "solver=timesvdpp", "timesvdpp.kernel=pallas",
        f"timesvdpp.reg_alpha={reg}", f"data.root={root}", *extra])
    return dataclasses.replace(cfg, target_rmse=None)


def _log_records(path):
    with open(path) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    return [r for r in recs if "train_metric" in r]


def falls_every_epoch(what, trains, epochs):
    if len(trains) != epochs or any(b >= a for a, b in zip(trains,
                                                           trains[1:])):
        raise AssertionError(f"{what}: the train RMSE did not fall every "
                             f"epoch: {trains}")


SVDPP_RUNS = {"svdpp": SVDPP_OVERRIDES, "mf": SVDPP_MF_OVERRIDES}


def svdpp_cli_start(root):
    """Phase 30 (a), its processes: SVD++ and the minibatch biased MF it is
    held to, python -m mfx_torch.cli train side by side on the card (each
    with a JSONL log under ``root``). They launch no hand-written kernel,
    so they run while the kernels build. Returns {key: process}."""
    procs = {}
    for key, ov in SVDPP_RUNS.items():
        args = ["train", "--preset", "ml1m_rank32_biased"]
        for o in ov + [f"log_path={root / (key + '.jsonl')}"]:
            args += ["--set", o]
        procs[key] = _spawn(args)
        _CHILDREN.append((key, None, procs[key]))
    return procs


def svdpp_cli_phase(dev, root, procs, t0):
    """Phase 30 (a): waits for ``procs`` (svdpp_cli_start's, started at
    ``t0``) and holds their results to the gates."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.loaders import load_dataset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.models.mf import init_model

    runs = SVDPP_RUNS
    outs = {k: json.loads(_finish(p, f"train {k}")[-1])
            for k, p in procs.items()}
    wall = time.perf_counter() - t0
    cfg = apply_overrides(preset("ml1m_rank32_biased"), SVDPP_OVERRIDES)
    coo = load_dataset("ml-1m", cache=False)  # the CLI's data
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg.model.seed)
    base, _ = rmse_mae(init_model(g, coo.num_users, coo.num_items,
                                  cfg.model.rank,
                                  global_mean=train.global_mean,
                                  init_scale=cfg.model.init_scale),
                       test, clip=(0.5, 5.0))
    recs = {k: _log_records(root / f"{k}.jsonl") for k in runs}
    for k in runs:
        log(f"[svdpp] (a) {k} ({' '.join(runs[k])}): {outs[k]}; train_rmse "
            + " ".join(f"{r['train_metric']:.5f}" for r in recs[k])
            + "; held-out rmse " + " ".join(f"{r['test_rmse']:.5f}"
                                          for r in recs[k])
            + "; epoch_s " + " ".join(f"{r['epoch_s']}" for r in recs[k]))
    pp, mf = outs["svdpp"]["test_rmse"], outs["mf"]["test_rmse"]
    log(f"[svdpp] (a) held-out (clipped): SVD++ {pp:.6f}, minibatch MF "
        f"{mf:.6f}, untrained {base:.6f}, the JAX trainer's SVD++ on the "
        f"CPU {SVDPP_JAX_RMSE} (tools/svdpp_check.py); {wall:.1f} s, the "
        "two processes side by side while the kernels built")
    falls_every_epoch("svdpp (a)", [r["train_metric"] for r in recs["svdpp"]],
                      cfg.svdpp.epochs)
    if not (pp < base and pp <= mf + SVDPP_MF_MARGIN
            and abs(pp - SVDPP_JAX_RMSE) <= SVDPP_JAX_TOL):
        raise AssertionError(
            f"svdpp (a): held-out {pp} not below the untrained {base}, above "
            f"minibatch MF's {mf} + {SVDPP_MF_MARGIN}, or not within "
            f"{SVDPP_JAX_TOL} of the JAX trainer's {SVDPP_JAX_RMSE}")
    return {"held_out": pp, "mf_held_out": mf, "untrained": base,
            "jax_cpu": SVDPP_JAX_RMSE,
            "epoch_s": [r["epoch_s"] for r in recs["svdpp"]]}


def timesvdpp_kernel_check(dev, state, train, cfg, feats):
    """The time form against its plain version on the first SWEEP_TILES
    tiles of the first sweep of timeSVD++'s plan, on the time-lane tables
    of ``state`` (a TimeSVDppState after one Y step, so S != 0) packed as
    the trainer packs X = P + S. Returns (tiles, max abs err, ms, plain
    ms)."""
    import torch

    from mfx_torch.models.svdpp import implicit_scale, implicit_sums
    from mfx_torch.models.timesvd import TimeSVDModel
    from mfx_torch.kernels.sgd_sweep import sgd_sweep_plain, sgd_sweep_time
    from mfx_torch.solvers import timesvd_blocked as tsb
    from mfx_torch.solvers.blocked import TPG, sweep_geometry

    tc, nb = cfg.timesvdpp, feats.n_bins
    su = si = tsb.BLOCK
    t = {k: torch.as_tensor(getattr(state, k), device=dev)
         for k in ("P", "Q", "Y", "bu", "bi", "bt", "alpha")}
    nu = implicit_scale(train.user, train.num_users, device=dev)
    S = implicit_sums(t["Y"], train.user, train.item, nu)
    ts = TimeSVDModel(t["P"] + S, t["Q"], t["bu"], t["bi"],
                      float(state.mu), t["bt"], t["alpha"])
    P, Q = tsb._tables(ts, nb, su, si, dev)
    tb, dv = feats.features(train.user, train.timestamp)
    plan = tsb.build_temporal_plan_skeleton(
        train, tb, dv, su=su, si=si, tile=tsb.TILE, tpg=TPG,
        nwin=sweep_geometry(train.num_items, cfg.model.rank, si), device=dev)
    tl, sws = tsb.plan_temporal_epoch_device(*plan, cfg.data.seed, 0)
    sw = sws[0]
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tcs = sw.sa[:nt // TPG].contiguous(), sw.tc[:nt].contiguous()
    tls, deps = tl[sw.t0:sw.t0 + nt], sw.deps.prefix(nt)
    seg = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    kw = dict(su=su, si=si, tpg=TPG, n_bins=nb)
    lr, reg, mu = tc.lr, tc.reg, ts.mu
    log(f"[timesvdpp] (b) sgd_sweep_time: {nt} tiles of the first sweep of "
        f"the path's plan, from the tables after one Y step (|S| max "
        f"{float(S.abs().max()):.4f}); critical path {deps.critical} tiles")
    return (nt,) + compare(
        "sgd_sweep_time (timeSVD++)",
        lambda Pt, Qt: sgd_sweep_time(Pt, Qt[seg], sa, tcs, tls, lr, reg, mu,
                                      **kw, deps=deps),
        lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg], sa, tcs, tls, lr, reg,
                                       mu, **kw),
        (P, Q))


def timesvdpp_blocked_phase(dev, tcoo, root):
    """Phase 30 (b): blocked timeSVD++ through the driver on phase 15's
    data (``tcoo``, the loader's cache under ``root``): its gates, a repeat
    through the trainer (bitwise, with the Y step's CUDA-event times), the
    lr_y = 0 run against solver='timesvd' timesvd.kernel='pallas', and the
    time form against its plain version on the path's plan. Returns (the
    time form's launches in the driver's run, the kernel check's entry)."""
    import torch

    from mfx_torch.data.split import train_test_split
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers.timesvd import rmse_mae_time
    from mfx_torch.solvers.timesvd_blocked import train_epochs_timesvd_blocked
    from mfx_torch.solvers.timesvdpp import train_epochs_timesvdpp
    from mfx_torch.train.driver import train as drive

    t0 = time.perf_counter()
    cfg = timesvdpp_config(root, f"timesvdpp.epochs={TIMESVDPP_EPOCHS}")
    tc, seed = cfg.timesvdpp, cfg.data.seed
    train, test = train_test_split(tcoo, cfg.data.test_frac, seed=seed)
    U, I, rank = tcoo.num_users, tcoo.num_items, cfg.model.rank
    feats = fit_time_features(train, n_bins=tc.n_bins, beta=tc.beta)

    def fresh_model():  # the driver's initial model
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          init_scale=cfg.model.init_scale)

    base, _ = rmse_mae_time(
        init_timesvd(None, U, I, rank, tc.n_bins, base=fresh_model()), feats,
        test, clip=(0.5, 5.0))
    kernel_counts(reset=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    res = drive(cfg, device=dev, resume=False)
    wall = time.perf_counter() - t1
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    trains = [r["train_metric"] for r in res.history]
    epoch_s = [r["epoch_s"] for r in res.history]
    log(f"[timesvdpp] (b) driver: solver='timesvdpp' kernel='pallas', rank "
        f"{rank}, {tc.n_bins} bins, lr {tc.lr} decay {tc.lr_decay} reg "
        f"{tc.reg} = reg_alpha, lr_y = lr, y_trust {tc.y_trust}: "
        f"{res.epochs_run} epochs in {wall:.1f} s (load, split, features, "
        f"plan and evals included); epoch_s {epoch_s} (the driver's, without "
        f"the eval); launches {counts}; peak memory allocated {peak} bytes")
    log(f"[timesvdpp] (b) train_rmse " + " ".join(f"{x:.5f}" for x in trains)
        + "; held-out time-aware rmse " + " ".join(
            f"{r['test_rmse']:.5f}" for r in res.history)
        + f" (untrained {base:.5f}, clipped as the driver's)")
    expect_kernels("timesvdpp (b)", counts, {"sgd_sweep_time"})
    falls_every_epoch("timesvdpp (b)", trains, tc.epochs)
    if not res.test_rmse < base:
        raise AssertionError(f"timesvdpp (b): held-out {res.test_rmse} not "
                             f"below the untrained {base}")

    # the repeat, through the trainer: the driver's model bit for bit, and
    # the Y step's share of each epoch (CUDA events)
    timings, cap, first = {}, {}, None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for epoch, ts, tr in train_epochs_timesvdpp(
            fresh_model(), train, tc, seed=seed, feats=feats, device=dev,
            capture=cap, timings=timings):
        first = cap["state"] if first is None else first
        if round(tr, 6) != trains[epoch]:
            raise AssertionError(f"timesvdpp (b): the repeat's train RMSE "
                                 f"{tr} is not the driver's {trains[epoch]}")
    torch.cuda.synchronize()
    rep_s = time.perf_counter() - t1
    view = ts.as_mf(feats)
    if not all(torch.equal(getattr(view, k), getattr(res.model, k))
               for k in ("P", "Q", "bu", "bi")):
        raise AssertionError("timesvdpp (b): a second run differs from the "
                             "driver's run")
    y_ms = timings["y_ms"]
    log(f"[timesvdpp] (b) a second run (the trainer) repeats the driver's "
        f"model bit for bit: {rep_s:.2f} s with its prep "
        f"{timings['prep_s']:.2f} s; the Y step and S refresh each epoch "
        + " ".join(f"{x:.2f}" for x in y_ms) + " ms (CUDA events), "
        + " ".join(f"{100 * y / (1e3 * e):.1f}%" for y, e in zip(y_ms,
                                                                 epoch_s))
        + " of the driver's epochs")

    # lr_y = 0: the timeSVD path's tables and train RMSE bit for bit (the
    # two trainers on the driver's split, features and initial model)
    e = TIMESVDPP_COLLAPSE_EPOCHS
    zero = [(tr, m) for _, m, tr in train_epochs_timesvdpp(
        fresh_model(), train, dataclasses.replace(tc, epochs=e, lr_y=0.0),
        seed=seed, feats=feats, device=dev)]
    tsvd_cfg = timesvd_config(root, f"timesvd.epochs={e}")
    tsvd = [(float(tr), m) for _, m, tr in train_epochs_timesvd_blocked(
        fresh_model(), train, tsvd_cfg.timesvd, seed=seed, feats=feats,
        device=dev)]
    keys = ("P", "Q", "bu", "bi", "bt", "alpha")
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for (_, a), (_, b) in zip(zero, tsvd) for k in keys)
    tr0, tr1 = [x for x, _ in zero], [x for x, _ in tsvd]
    log(f"[timesvdpp] (b) timesvdpp.lr_y=0 (train_epochs_timesvdpp) against "
        f"timesvd.kernel=pallas (train_epochs_timesvd_blocked), {e} epochs "
        f"from the driver's model, split and features: train_rmse {tr0} / "
        f"{tr1}, tables equal every epoch {same}")
    if len(zero) != e or not same or tr0 != tr1:
        raise AssertionError("timesvdpp (b): the lr_y = 0 run is not the "
                             "timeSVD run")
    nt, err, ms, plain_ms = timesvdpp_kernel_check(dev, first, train, cfg,
                                                   feats)
    log(f"[time] phase 30 (b) {time.perf_counter() - t0:.1f} s")
    return counts["sgd_sweep_time"], {
        "tiles": nt, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "epoch_s": epoch_s, "y_step_ms": y_ms,
        "peak_bytes": peak, "held_out": res.test_rmse, "untrained": base}


def timesvdpp_jnp_phase(dev, root):
    """Phase 30 (c): the minibatch timeSVD++ trainer through the driver on
    phase 16's temporal ML-1M (its recipe and seed), written as the
    loader's cache under ``root``. It launches no hand-written kernel, so
    it runs while the kernels build."""
    import torch

    from mfx_torch.config import apply_overrides, preset
    from mfx_torch.data.loaders import GENERATOR_VERSION, load_dataset
    from mfx_torch.data.synthetic import ML1M_SHAPE, make_synthetic
    from mfx_torch.data.split import train_test_split
    from mfx_torch.models.mf import init_model
    from mfx_torch.models.timesvd import fit_time_features, init_timesvd
    from mfx_torch.solvers.timesvd import rmse_mae_time
    from mfx_torch.train.driver import train as drive

    t0 = time.perf_counter()
    temporal(make_synthetic(*ML1M_SHAPE, rank=32, seed=101, star_step=1.0,
                            user_zipf_s=0.6), 101).save_npz(
        root / f"ml-1m.v{GENERATOR_VERSION}.synthetic.npz")
    cfg = apply_overrides(preset("ml1m_rank32_biased"), [
        "solver=timesvdpp", "timesvdpp.dup_trust=16",
        f"timesvdpp.epochs={TIMESVDPP_JNP_EPOCHS}", f"data.root={root}"])
    tc = cfg.timesvdpp
    coo = load_dataset("ml-1m", root=root)  # the driver's data
    train, test = train_test_split(coo, cfg.data.test_frac,
                                   seed=cfg.data.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg.model.seed)
    m0 = init_model(g, coo.num_users, coo.num_items, cfg.model.rank,
                    global_mean=train.global_mean,
                    init_scale=cfg.model.init_scale)
    feats = fit_time_features(train, n_bins=tc.n_bins, beta=tc.beta)
    base, _ = rmse_mae_time(init_timesvd(None, coo.num_users, coo.num_items,
                                         cfg.model.rank, tc.n_bins, base=m0),
                            feats, test, clip=(0.5, 5.0))
    kernel_counts(reset=True)
    res = drive(cfg, device=dev, resume=False)
    counts = kernel_counts()
    trains = [r["train_metric"] for r in res.history]
    log(f"[timesvdpp] (c) jnp (ML-1M-shaped, dup_trust 16): "
        f"{res.epochs_run} epochs, epoch_s "
        f"{[r['epoch_s'] for r in res.history]}; train_rmse "
        + " ".join(f"{x:.5f}" for x in trains) + "; held-out time-aware rmse "
        + " ".join(f"{r['test_rmse']:.5f}" for r in res.history)
        + f" (untrained {base:.5f}); launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    expect_kernels("timesvdpp (c)", counts, set())
    falls_every_epoch("timesvdpp (c)", trains, tc.epochs)
    if not res.test_rmse < base:
        raise AssertionError(f"timesvdpp (c): held-out {res.test_rmse} not "
                             f"below the untrained {base}")
    return {"held_out": res.test_rmse, "untrained": base,
            "epoch_s": [r["epoch_s"] for r in res.history]}


def svdpp_early(dev, root):
    """Phase 30 (c) and the start of (a), while the kernels build (neither
    launches a hand-written kernel). Returns (c)'s records and (a)'s
    processes with their start time."""
    t0 = time.perf_counter()
    rec_c = timesvdpp_jnp_phase(dev, root)
    log(f"[time] phase 30 (c) {time.perf_counter() - t0:.1f} s")
    return rec_c, svdpp_cli_start(root), time.perf_counter()

def main() -> int:
    import shutil
    import threading

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels run only on a GPU")
    t_start = time.perf_counter()
    from mfx_torch.config import preset
    from mfx_torch.data.split import train_test_split
    from mfx_torch.data.synthetic import ML25M_SHAPE, make_synthetic
    from mfx_torch.eval.metrics import rmse_mae
    from mfx_torch.kernels import _build
    from mfx_torch.kernels import plan_device as pdv
    from mfx_torch.kernels.dense_phase import (dense_phase, dense_phase_plain,
                                               group_prefix, plan_launch)
    from mfx_torch.kernels.packing import lane_tables, plain_tables
    from mfx_torch.kernels.sgd_sweep import sgd_sweep, sgd_sweep_plain
    from mfx_torch.models.mf import MFModel, init_model
    from mfx_torch.solvers import blocked
    from mfx_torch.solvers.dense_prep import prepare_dense_full

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # 2. build, in a thread beside the ML-25M data below (nvcc runs in
    # processes of its own; the thread only waits on them)
    t0 = time.perf_counter()
    build: dict = {}

    def build_kernels():
        try:
            _build.load_library()
        except Exception as exc:  # raised again in the main thread
            build["error"] = exc
        build["s"] = time.perf_counter() - t0

    build_thread = threading.Thread(target=build_kernels)
    build_thread.start()

    # data: the ml-25m entry of mfx/data/loaders.py (its seeded synthetic)
    cfg = preset("ml25m_rank64")
    sgd = cfg.sgd
    coo = make_synthetic(*ML25M_SHAPE, rank=64, seed=102, star_step=0.5,
                         user_zipf_s=0.6)
    train, test = train_test_split(coo, cfg.data.test_frac, seed=cfg.data.seed)
    log(f"[data] {coo.num_users} x {coo.num_items}, {coo.n_ratings} ratings "
        f"({train.n_ratings} train / {test.n_ratings} test) in "
        f"{time.perf_counter() - t0:.1f} s, beside the build")
    U, I, rank = coo.num_users, coo.num_items, cfg.model.rank
    su, si, T, tpg = sgd.ublock, sgd.iblock, sgd.tile, blocked.TPG

    def fresh_model():
        g = torch.Generator(device=dev)
        g.manual_seed(cfg.model.seed)
        return init_model(g, U, I, rank, global_mean=train.global_mean,
                          device=dev)

    # 29 (c) NMF and (b) the learnable iALS cell launch no hand-written
    # kernel: they run here, while the kernels build
    GRAM["nmf"] = nmf_phase(dev, cfg, train, test, fresh_model)
    GRAM["ials_learn"], learn = ials_learn_phase(dev)  # and phase 31's
    # 30 (c) minibatch timeSVD++, and (a)'s SVD++ processes: no
    # hand-written kernel either
    svdpp_root = _build.BUILD_DIR.parent / "chip_smoke_svdpp"
    shutil.rmtree(svdpp_root, ignore_errors=True)
    svdpp_root.mkdir(parents=True)
    timesvdpp_jnp, svdpp_procs, svdpp_t0 = svdpp_early(dev, svdpp_root)
    build_thread.join()
    if "error" in build:
        raise build["error"]
    # (a)'s processes end before any kernel is timed
    t0 = time.perf_counter()
    svdpp_cli = svdpp_cli_phase(dev, svdpp_root, svdpp_procs, svdpp_t0)
    shutil.rmtree(svdpp_root, ignore_errors=True)
    log(f"[time] phase 30 (a) after the build {time.perf_counter() - t0:.1f} "
        "s")
    log(f"[build] all kernels built and loaded in {build['s']:.1f} s "
        f"({_build.BUILD_DIR})")
    # the BPR and netflix data from here: beside the build they slow it,
    # and their phases need them minutes later
    start_data()

    # 3. kernels against plain versions at the preset's shapes
    rfmt = blocked.dense_rfmt(sgd, rank, train.rating)
    u = torch.as_tensor(train.user).to(dev, torch.int32)
    i = torch.as_tensor(train.item).to(dev, torch.int32)
    r = torch.as_tensor(train.rating).to(dev, torch.float32)
    meta, groups, (u, i, r), info3 = prepare_dense_full(
        u, i, r, U, I, su, si, chi_min=sgd.dense_chi,
        nwd=blocked.dense_group_windows(rank, si), rfmt=rfmt)
    skel = pdv.build_plan_skeleton(u, i, U, I, su, si, T, tpg,
                                   blocked.sweep_geometry(I, rank, si))
    tl = pdv.epoch_tiles_device(skel, u, i, r, cfg.data.seed, 0)
    P, Q = lane_tables(fresh_model(), su, si, dev)
    mu, lr, reg = float(train.global_mean), sgd.lr, sgd.reg
    results, bounds = {}, {}
    t_phase = time.perf_counter()

    win0, nw = meta[0]
    grp = group_prefix(groups[0], DENSE_STRATA)
    seg = slice(win0 * si, (win0 + nw) * si)
    log(f"[kernel] dense_phase: {grp['sa'].shape[0]} strata of group 0 "
        f"({rfmt}, {su}x{si}, rank {rank}); critical path "
        f"{grp['deps'].critical} strata")
    results["dense_phase"] = compare(
        "dense_phase",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp, lr, reg, mu, su=su,
                                   si=si, deps=grp["deps"]),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp, lr, reg, mu,
                                         su=su, si=si),
        (P, Q),
    )
    bounds["dense_phase"] = dense_bound([grp], su, si, rank)
    # the first DENSE_WHOLE strata of group 0 on one block and on the
    # card's count; then group 0 and the dense phase of an epoch
    head = group_prefix(groups[0], DENSE_WHOLE)
    plan_launch(head, su, si, rank)  # the launch order, on the host, untimed
    dense_card = _build.load_library().mfx_dense_phase_max_blocks(
        rank, int(rfmt == "int8"), 0)  # the lane form
    sweeps = {"dense_phase": whole_sweep(
        "dense_phase",
        lambda Pt, Qt, blocks: dense_phase(Pt, Qt[seg], head, lr, reg, mu,
                                           su=su, si=si, deps=head["deps"],
                                           blocks=blocks),
        (P, Q), head["deps"], dense_card, grid=dense_card, unit="strata")}

    def dense_groups(grps):
        Pt, Qt = P.clone(), Q.clone()
        for (w0, n), g in grps:
            dense_phase(Pt, Qt[w0 * si:(w0 + n) * si], g, lr, reg, mu, su=su,
                        si=si, deps=g["deps"])

    for key, grps in (("group0", list(zip(meta, groups))[:1]),
                      ("epoch_dense", list(zip(meta, groups)))):
        dense_groups(grps)  # warm-up
        ms = cuda_ms(lambda: dense_groups(grps), reps=3)
        b = dense_bound([g for _, g in grps], su, si, rank)
        strata = sum(g["deps"].n_tiles for _, g in grps)
        crit = sum(g["deps"].critical for _, g in grps)
        sweeps["dense_phase"].update({
            f"{key}_strata": strata, f"{key}_critical_strata": crit,
            f"{key}_ms": ms, f"{key}_bound_ms": b[0]})
        log(f"[kernel] dense_phase, {key}: {len(grps)} group(s), {strata} "
            f"strata, critical path {crit} strata, {dense_card} blocks: "
            f"{ms:.4f} ms (mean of 3, tables copied in); bound {b[0]:.4f} "
            f"ms ({b[1]})")

    # the int8 codes' rank-64 instance on the same strata (the int4 run's
    # threshold): no preset's path runs it (ml25m_rank64's half-star
    # ratings take int4), so it is timed here beside int4 and holds no
    # launch count
    _, groups8, _, _ = prepare_dense_full(
        *(torch.as_tensor(x).to(dev) for x in (train.user, train.item,
                                                train.rating)),
        U, I, su, si, chi_min=info3["chi_effective"],
        nwd=blocked.dense_group_windows(rank, si), rfmt="int8")
    grp8 = group_prefix(groups8[0], DENSE_STRATA)
    if not torch.equal(grp8["sa"], grp["sa"]):
        raise AssertionError("the int8 carving took other strata")
    err8, ms8, plain8 = compare(
        "dense_phase int8 rank 64",
        lambda Pt, Qt: dense_phase(Pt, Qt[seg], grp8, lr, reg, mu, su=su,
                                   si=si, deps=grp8["deps"]),
        lambda Pt, Qt: dense_phase_plain(Pt, Qt[seg], grp8, lr, reg, mu,
                                         su=su, si=si),
        (P, Q))
    sweeps["dense_phase"]["int8_rank64"] = {
        "strata": DENSE_STRATA, "max_abs_err": err8, "ms": ms8,
        "plain_ms": plain8, "bound_ms": dense_bound([grp8], su, si, rank)[0]}
    del groups8, grp8

    sw = next(s for s in skel.sweeps if s.t1 > s.t0)
    nt = min(SWEEP_TILES, sw.t1 - sw.t0)
    sa, tc = sw.sa[: nt // tpg].contiguous(), sw.tc[:nt].contiguous()
    tls = tl[sw.t0:sw.t0 + nt]
    deps = sw.deps.prefix(nt)
    seg_s = slice(sw.win0 * si, (sw.win0 + sw.nwin) * si)
    log(f"[kernel] sgd_sweep: {nt} tiles of the first sweep (T={T}, "
        f"rank {rank}); they hold {deps.runs.shape[0]} runs, critical path "
        f"{deps.critical} tiles")
    results["sgd_sweep"] = compare(
        "sgd_sweep",
        lambda Pt, Qt: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg, mu,
                                 su=su, si=si, tpg=tpg, deps=deps),
        lambda Pt, Qt: sgd_sweep_plain(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg),
        (P, Q),
    )
    # per real slot: the residual's dot (2 rank), two deltas (3 rank each)
    # and two row adds (rank each)
    bounds["sgd_sweep"] = sweep_bound(tls, sa, tc, su, si, tpg, rank,
                                      [("P", 0), ("Q", 1)], 10)
    Pt, Qt = P.clone(), Q.clone()
    ms_one = cuda_ms(lambda: sgd_sweep(Pt, Qt[seg_s], sa, tc, tls, lr, reg,
                                       mu, su=su, si=si, tpg=tpg), reps=3)
    log(f"[kernel] sgd_sweep: the same {nt} tiles on one block in plan "
        f"order (no dependency table) {ms_one:.4f} ms")
    del Pt, Qt
    # the whole first sweep, on one block and on the card's count
    sweeps["sgd_sweep"] = whole_sweep(
        "sgd_sweep",
        lambda Pt, Qt, blocks: sgd_sweep(
            Pt, Qt[seg_s], sw.sa, sw.tc, tl[sw.t0:sw.t1], lr, reg, mu, su=su,
            si=si, tpg=tpg, deps=sw.deps, blocks=blocks),
        (P, Q), sw.deps,
        _build.load_library().mfx_sgd_sweep_max_blocks(T, rank))
    # the same tiles through the tile-bias and step-batched bodies, on
    # the plain tables of the same model
    tile_bias_compare(results, bounds, plain_tables(fresh_model(), su, si, dev),
                      seg_s, sa, tc, tls, lr, reg, mu, su, si, tpg, "", deps)
    # 25 (ml25m_rank64's cell). the bf16 sweeps on these tiles and the
    # echo passes on group 0, from the same untrained tables (the plain
    # ones with seeded N(0, 0.1) biases, so that every bias term is live)
    t25 = time.perf_counter()
    g25 = torch.Generator(device=dev).manual_seed(25)
    m25 = fresh_model()
    m25.bu.copy_(torch.randn(U, device=dev, generator=g25) * 0.1)
    m25.bi.copy_(torch.randn(I, device=dev, generator=g25) * 0.1)
    plain25 = plain_tables(m25, su, si, dev)
    store_forms(bf16_forms("", (P, Q), plain25, sw, tl, lr, reg, mu, su, si,
                           tpg, tiles=BF16_CELL_TILES), results, bounds,
                sweeps)
    store_forms(echo_forms("", groups, meta, (P, Q), plain25, lr, reg, mu, su,
                           si, rfmt, DENSE_STRATA, DENSE_WHOLE, times=True),
                results, bounds, sweeps)
    del m25, plain25
    log(f"[time] phase 25 (ml25m_rank64's cell) "
        f"{time.perf_counter() - t25:.1f} s")
    for name in ("dense_phase", "sgd_sweep"):
        log(f"[kernel] {name} bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})")
    log(f"[time] phase 3 {time.perf_counter() - t_phase:.1f} s")
    del meta, groups, grp, skel, tl, tls, P, Q, u, i, r
    torch.cuda.empty_cache()

    # 4. the main path, through the kernels
    t_phase = time.perf_counter()
    sgd_sweep.launches = 0
    dense_phase.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    model = fresh_model()
    torch.cuda.synchronize()
    gen = blocked.train_epochs_blocked(
        model, train, dataclasses.replace(sgd, epochs=2), cfg.model.use_bias,
        seed=cfg.data.seed, device=dev, timings=timings)
    test_rmse = None
    plan_seen = 0.0
    t_prev = time.perf_counter()
    for epoch, m, tr in gen:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_prev
        plan_s = timings["plan_s"] - plan_seen
        plan_seen = timings["plan_s"]
        epoch_s = wall - plan_s - (timings["prep_s"] if epoch == 0 else 0.0)
        if epoch == 0:
            info = timings["dense_info"]
            log(f"[main] prep {timings['prep_s']:.3f} s: dense_frac "
                f"{info['dense_frac']:.4f}, {info['num_strata']} strata in "
                f"{info['num_groups']} groups, R image "
                f"{info['r_stream_bytes']} bytes; (tiles, critical path) of "
                f"each sparse sweep {timings['sweep_tiles']}")
        test_rmse, test_mae = rmse_mae(m, test)
        train_rmse = float(tr)
        log(f"[main] epoch {epoch}: epoch_s {epoch_s:.4f} plan_s {plan_s:.4f} "
            f"train_rmse {train_rmse:.5f} test_rmse {test_rmse:.5f} "
            f"test_mae {test_mae:.5f}")
        finite = all(bool(torch.isfinite(getattr(m, k)).all())
                     for k in ("P", "Q", "bu", "bi"))
        if not finite or m.P.shape != (U, rank) or m.Q.shape != (I, rank):
            raise AssertionError("model tables not finite or mis-shaped")
        t_prev = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {"sgd_sweep": sgd_sweep.launches,
                "dense_phase": dense_phase.launches}
    m4 = MFModel(*(getattr(m, k).clone() for k in ("P", "Q", "bu", "bi")),
                 m.mu)  # for phase 26's (b)
    log(f"[main] launches {launches}, peak memory allocated {peak} bytes")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if not test_rmse <= RMSE_GATE:
        raise AssertionError(f"test RMSE {test_rmse} above the {RMSE_GATE} gate")
    log(f"[time] phase 4 {time.perf_counter() - t_phase:.1f} s")

    # 5. tile_topk against its plain version at the serving shape
    t_phase = time.perf_counter()
    results["tile_topk"], bounds["tile_topk"], topk_variants = topk_phase(dev)
    log(f"[time] phase 5 {time.perf_counter() - t_phase:.1f} s")

    # 6. the serving path, on the model phase 4 trained
    t0 = time.perf_counter()
    launches["tile_topk"] = serve_phase(m, train, dev, cfg.data.seed)
    log(f"[time] phase 6 {time.perf_counter() - t0:.1f} s")
    library = {"tile_topk": topk_variants[0]["stock_ms"]}

    # 23-24. the deep form of tile_topk, evaluating and serving the
    # phase-4 model through the CLI; bf16 tables and profile_phases
    launches["tile_topk_deep"], data_root = deep_serve_phase(
        dev, m, coo, train, test, cfg, results, bounds, sweeps, library)
    launches["bf16_row_add"] = bf16_profile_phase(dev, data_root, results,
                                                  bounds, sweeps, library)

    # 17-18. the other bias modes of the main path, on phase 4's data
    launches.update(bias_form_phases(dev, cfg, train, test, fresh_model, m,
                                     test_rmse, results, bounds, sweeps,
                                     data_root))
    shutil.rmtree(data_root.parent)  # phase 23's dataset cache

    # 26. the main path under each dense and MXU setting, on phase 4's data
    launches.update(variant_runs(dev, cfg, train, test, fresh_model, m4,
                                 test_rmse))
    # 28 (g). the main path's preset at ranks 16 and 2, on phase 4's data
    narrow_ml25m_run(dev, cfg, train, test)

    # 19 (its extra cell). the rank-32 lane sweep and dense forms on phase
    # 4's data at ml25m_rank64's shapes, which no preset runs at rank 32
    cell25 = ({}, {}, {})
    rank32_forms(dev, sgd, sgd, train, cfg.data.seed,
                 "ml25m_rank64's cell at rank 32", *cell25,
                 strata=(DENSE_STRATA, DENSE_WHOLE))
    # 29 (c). ALS at rank 64 on phase 4's data, served through tile_topk
    torch.cuda.empty_cache()
    topk_als = als64_serve_phase(dev, cfg, train, test, fresh_model)
    del m, model, train, test  # coo: phases 15-16 make it temporal
    torch.cuda.empty_cache()

    # 7-8. the BPR path; 21-22 at ranks 32 and 128; 27-28 at 16 to 1
    narrow: dict = {}  # phase 27's forms, stored with store_narrow
    launches.update(bpr_phases(dev, results, bounds, sweeps, narrow, learn))
    del learn
    # 31 (d)'s bf16 runs: bf16_row_add's second caller
    mb_launches, mb_check = launches.pop("bf16_row_add_mb")
    sweeps["bf16_row_add"]["launches_by_path"] = {
        "minibatch_sgd": launches["bf16_row_add"],
        "bpr_minibatch": mb_launches}
    sweeps["bf16_row_add"]["variants"].append(mb_check)
    launches["bf16_row_add"] += mb_launches

    # 9-10. the tile-bias path
    launches.update(tile_bias_phases(dev, sweeps))

    # 11-12. the netflix path (rank 128, int8 codes); 21-22 in the other
    # bias modes
    launches.update(netflix_phases(dev, results, bounds, sweeps))

    # 13-14. the minibatch path: Java parity, then ml100k_rank16
    java_parity_phase(dev)
    topk_ml100k = ml100k_phase(dev)

    # 15-16. blocked timeSVD, on phase 4's synthetic made temporal
    t0 = time.perf_counter()
    tcoo = temporal(coo, 102)
    del coo
    log(f"[time] the temporal ML-25M-shaped synthetic in "
        f"{time.perf_counter() - t0:.1f} s")
    time_kernel_phase(dev, tcoo, results, bounds, sweeps)
    # 19 (second part). the rank-32 time form, on phase 15's data
    rank32_time_phase(dev, tcoo, results, bounds, sweeps)
    launches["sgd_sweep_time"], time_root = time_path_phase(dev, tcoo)
    # 27-28 (timeSVD). the time form at ranks 16 and 8; the path at 16
    launches["sgd_sweep_time_r16"] = narrow_time_phase(dev, tcoo, narrow)
    # 30. SVD++ through the CLI; timeSVD++, blocked on phase 15's data
    # (through the time form) and minibatch on phase 16's temporal ML-1M
    time_paths = {"timesvd": launches["sgd_sweep_time"]}
    time_paths["timesvdpp"], timesvdpp = timesvdpp_blocked_phase(dev, tcoo,
                                                                time_root)
    timesvdpp.update(svdpp_cli=svdpp_cli, jnp_ml1m=timesvdpp_jnp)
    launches["sgd_sweep_time"] = sum(time_paths.values())
    sweeps["sgd_sweep_time"].update(launches_by_path=time_paths,
                                    timesvdpp=timesvdpp)
    shutil.rmtree(time_root, ignore_errors=True)
    del tcoo

    # 19-20. ml1m_rank32_biased: the rank-32 forms against plain on its
    # runs' plan and carving, then the runs through them
    launches.update(rank32_path_phase(dev, results, bounds, sweeps))
    # 27-28 (ML-1M). ranks 16 to 1 of the SGD sweeps against plain on
    # ml1m_rank32_biased's plan, then its paths at those ranks
    narrow_launches, topk_r2 = narrow_ml1m_phases(dev, narrow)
    launches.update(narrow_launches)
    store_narrow(narrow, results, bounds, sweeps)
    for name, (err, ms, plain_ms) in cell25[0].items():
        sweeps[name]["ml25m_cell"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": cell25[1][name][0], "bound_by": cell25[1][name][1],
            **cell25[2][name]}

    replaces = {"sgd_sweep": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase": "mfx/kernels/dense_pallas.py:86",
                "tile_topk": "mfx/kernels/serve_pallas.py:42",
                "bpr_sweep": "mfx/kernels/bpr_pallas.py:47",
                "sgd_sweep_tile": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_step_u": "mfx/kernels/sgd_pallas.py:363",
                "sgd_sweep_r128": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase_int8_r128": "mfx/kernels/dense_pallas.py:86",
                "sgd_sweep_time": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_epoch": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase_frozen": "mfx/kernels/dense_pallas.py:86",
                "sgd_sweep_r32": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_time_r32": "mfx/kernels/sgd_pallas.py:63",
                "dense_phase_r32": "mfx/kernels/dense_pallas.py:86",
                "dense_phase_frozen_r32": "mfx/kernels/dense_pallas.py:86",
                "dense_phase_none_r32": "mfx/kernels/dense_pallas.py:86",
                "bpr_sweep_r32": "mfx/kernels/bpr_pallas.py:47",
                "bpr_sweep_r128": "mfx/kernels/bpr_pallas.py:47",
                "sgd_sweep_tile_r128": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_tile_none_r128": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_epoch_r128": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_step_u_r128": "mfx/kernels/sgd_pallas.py:363",
                "dense_phase_frozen_int8_r128":
                    "mfx/kernels/dense_pallas.py:86",
                "dense_phase_none_int8_r128":
                    "mfx/kernels/dense_pallas.py:86",
                "tile_topk_deep": "mfx/kernels/serve_pallas.py:42",
                # not a Pallas kernel: the reference's XLA bf16 scatter
                "bf16_row_add": "mfx/kernels/jnp_ref.py:109",
                # the mxu_bf16 branch of _kernel_body (:63) and of
                # _kernel_body_step_u (:363)
                "sgd_sweep_bf16": "mfx/kernels/sgd_pallas.py:121",
                "sgd_sweep_tile_bf16": "mfx/kernels/sgd_pallas.py:121",
                "sgd_sweep_tile_none_bf16": "mfx/kernels/sgd_pallas.py:121",
                "sgd_sweep_epoch_bf16": "mfx/kernels/sgd_pallas.py:121",
                "sgd_sweep_step_u_bf16": "mfx/kernels/sgd_pallas.py:392",
                # the echo branch of dense_pallas.py's _kernel_body (:86)
                "dense_phase_echo": "mfx/kernels/dense_pallas.py:237",
                "dense_phase_none_echo": "mfx/kernels/dense_pallas.py:237",
                # ranks 16, 8 and 4 (pack 8, 16, 32) of the same bodies
                "sgd_sweep_r16": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_tile_r16": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_tile_r8": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_tile_r4": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_step_u_r16": "mfx/kernels/sgd_pallas.py:363",
                "sgd_sweep_tile_bf16_r16": "mfx/kernels/sgd_pallas.py:121",
                "sgd_sweep_time_r16": "mfx/kernels/sgd_pallas.py:63",
                "bpr_sweep_r16": "mfx/kernels/bpr_pallas.py:47",
                "bpr_sweep_r8": "mfx/kernels/bpr_pallas.py:47",
                # ranks 2 and 1 (pack 64 and 128) of the same bodies
                "sgd_sweep_r2": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_tile_r2": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_tile_r1": "mfx/kernels/sgd_pallas.py:63",
                "sgd_sweep_step_u_r2": "mfx/kernels/sgd_pallas.py:363",
                "sgd_sweep_tile_bf16_r2": "mfx/kernels/sgd_pallas.py:121",
                "bpr_sweep_r2": "mfx/kernels/bpr_pallas.py:47",
                "bpr_sweep_r1": "mfx/kernels/bpr_pallas.py:47"}
    sources = {"sgd_sweep_r128": "sgd_sweep", "dense_phase_int8_r128":
               "dense_phase", "sgd_sweep_time": "sgd_sweep",
               "sgd_sweep_epoch": "sgd_sweep_tile",
               "dense_phase_frozen": "dense_phase",
               "sgd_sweep_r32": "sgd_sweep", "sgd_sweep_time_r32": "sgd_sweep",
               "dense_phase_r32": "dense_phase",
               "dense_phase_frozen_r32": "dense_phase",
               "dense_phase_none_r32": "dense_phase",
               "bpr_sweep_r32": "bpr_sweep", "bpr_sweep_r128": "bpr_sweep",
               "sgd_sweep_tile_r128": "sgd_sweep_tile",
               "sgd_sweep_tile_none_r128": "sgd_sweep_tile",
               "sgd_sweep_epoch_r128": "sgd_sweep_tile",
               "sgd_sweep_step_u_r128": "sgd_sweep_step_u",
               "dense_phase_frozen_int8_r128": "dense_phase",
               "dense_phase_none_int8_r128": "dense_phase",
               "tile_topk_deep": "tile_topk",
               "bf16_row_add": "row_add_bf16",
               "sgd_sweep_bf16": "sgd_sweep",
               "sgd_sweep_tile_bf16": "sgd_sweep_tile",
               "sgd_sweep_tile_none_bf16": "sgd_sweep_tile",
               "sgd_sweep_epoch_bf16": "sgd_sweep_tile",
               "sgd_sweep_step_u_bf16": "sgd_sweep_step_u",
               "dense_phase_echo": "dense_phase",
               "dense_phase_none_echo": "dense_phase",
               "sgd_sweep_r16": "sgd_sweep",
               "sgd_sweep_tile_r16": "sgd_sweep_tile",
               "sgd_sweep_tile_r8": "sgd_sweep_tile",
               "sgd_sweep_tile_r4": "sgd_sweep_tile",
               "sgd_sweep_step_u_r16": "sgd_sweep_step_u",
               "sgd_sweep_tile_bf16_r16": "sgd_sweep_tile",
               "sgd_sweep_time_r16": "sgd_sweep",
               "bpr_sweep_r16": "bpr_sweep", "bpr_sweep_r8": "bpr_sweep",
               "sgd_sweep_r2": "sgd_sweep",
               "sgd_sweep_tile_r2": "sgd_sweep_tile",
               "sgd_sweep_tile_r1": "sgd_sweep_tile",
               "sgd_sweep_step_u_r2": "sgd_sweep_step_u",
               "sgd_sweep_tile_bf16_r2": "sgd_sweep_tile",
               "bpr_sweep_r2": "bpr_sweep", "bpr_sweep_r1": "bpr_sweep"}
    variants = {"sgd_sweep": "bias_mode='lane', rank 64",
                "sgd_sweep_tile": "bias_mode='tile'",
                "dense_phase": "lane, int4 codes, rank 64",
                "sgd_sweep_r128": "bias_mode='lane', rank 128",
                "dense_phase_int8_r128": "lane, int8 codes, rank 128",
                "sgd_sweep_time": "time_mode=True (bias_mode='lane'), rank "
                                  f"64, {TIME_BINS} bins",
                "sgd_sweep_epoch": "bias_mode='epoch', rank 64",
                "dense_phase_frozen": "frozen biases, int4, rank 64",
                "sgd_sweep_r32": "bias_mode='lane', rank 32",
                "sgd_sweep_time_r32": "time_mode=True (bias_mode='lane'), "
                                      f"rank 32, {RANK32_BINS} bins",
                "dense_phase_r32": "lane, int4 codes, rank 32",
                "dense_phase_frozen_r32": "frozen biases, int4, rank 32",
                "dense_phase_none_r32": "no biases, int4, rank 32",
                "bpr_sweep_r32": "rank 32", "bpr_sweep_r128": "rank 128",
                "sgd_sweep_tile_r128": "bias_mode='tile', rank 128",
                "sgd_sweep_tile_none_r128": "no biases, rank 128",
                "sgd_sweep_epoch_r128": "bias_mode='epoch', rank 128",
                "sgd_sweep_step_u_r128": "bias_mode='tile', "
                                         "step_user_batch, rank 128, tpg 4",
                "dense_phase_frozen_int8_r128": "frozen biases, int8, "
                                                "rank 128",
                "dense_phase_none_int8_r128": "no biases, int8, rank 128",
                "tile_topk_deep": "the deep form (depth > 32 or tile > "
                                  f"2048): depth {EXACT_DEPTH}, tile "
                                  f"{DEEP_TILE}, the trained ML-25M catalog",
                "bf16_row_add": "bf16 tables' scatter-add in slot order "
                                "(minibatch SGD and the snapshot-minibatch "
                                "BPR trainers, model.dtype=bfloat16); "
                                "library_ms: index_put_(accumulate=True)",
                "sgd_sweep_bf16": "bias_mode='lane', mxu='bf16', rank 64",
                "sgd_sweep_tile_bf16": "bias_mode='tile', mxu='bf16', "
                                       "rank 64",
                "sgd_sweep_tile_none_bf16": "no biases, mxu='bf16', rank 64",
                "sgd_sweep_epoch_bf16": "bias_mode='epoch', mxu='bf16', "
                                        "rank 64",
                "sgd_sweep_step_u_bf16": "bias_mode='tile', step_user_batch, "
                                         "mxu='bf16', rank 64, tpg 4",
                "dense_phase_echo": f"lane, echo {ECHO}, int4 codes, rank 64",
                "dense_phase_none_echo": f"no biases, echo {ECHO}, int4 "
                                         "codes, rank 64",
                "sgd_sweep_r16": "bias_mode='lane', rank 16",
                "sgd_sweep_tile_r16": "bias_mode='tile', rank 16",
                "sgd_sweep_tile_r8": "bias_mode='tile', rank 8",
                "sgd_sweep_tile_r4": "bias_mode='tile', rank 4",
                "sgd_sweep_step_u_r16": "bias_mode='tile', step_user_batch, "
                                        "rank 16, tpg 4",
                "sgd_sweep_tile_bf16_r16": "bias_mode='tile', mxu='bf16', "
                                           "rank 16",
                "sgd_sweep_time_r16": "time_mode=True (bias_mode='lane'), "
                                      f"rank 16, {NARROW_BINS[16]} bins",
                "bpr_sweep_r16": "rank 16", "bpr_sweep_r8": "rank 8",
                "sgd_sweep_r2": "bias_mode='lane', rank 2: the baseline "
                                "predictor mu + bu + bi",
                "sgd_sweep_tile_r2": "bias_mode='tile', rank 2",
                "sgd_sweep_tile_r1": "bias_mode='tile', rank 1",
                "sgd_sweep_step_u_r2": "bias_mode='tile', step_user_batch, "
                                       "rank 2, tpg 4",
                "sgd_sweep_tile_bf16_r2": "bias_mode='tile', mxu='bf16', "
                                          "rank 2",
                "bpr_sweep_r2": "rank 2", "bpr_sweep_r1": "rank 1"}
    log(json.dumps({"gram_engine": GRAM}))
    log(json.dumps({"bpr_minibatch": BPR_MB}))
    log(f"[time] phase 29 (the Gram-engine solvers) "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in _GRAM_S.items()))
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    log(f"[card] {card}")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"mfx_torch/csrc/{sources.get(name, name)}.cu",
         "replaces": replaces[name],
         **({"variant": variants[name]} if name in variants else {}),
         "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes any of these functions; for
         # tile_topk's forms the stock path's two calls stand in
         "library_ms": library.get(name),
         **({"library": "torch.matmul (TF32 off) then torch.topk over "
                        "each tile"} if name.startswith("tile_topk") else {}),
         **({"variants": topk_variants, "ml100k_recommend": topk_ml100k,
             "als_recommend": topk_als, "rank2_recommend": topk_r2}
            if name == "tile_topk" else {}),
         # the sweeps (the tile-bias ones on ML-1M): a whole sweep on 1
         # block and on the card's count; dense_phase: DENSE_WHOLE strata
         # so, then group 0 and the epoch's dense phase on the card's count
         **sweeps.get(name, {})}
        for name, (err, ms, plain_ms) in results.items()
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr)
        sys.exit(1)
    finally:
        stop_children()
