#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dca_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``: an earlier commit of the repo unpacked at DIR
(``git archive``), whose whole loss backward phase 2 then times in turns
with this one's (``load_parent``).

Phases, each of which must pass:

1. Build and launch: build the CUDA kernels from ``dca_tpu_torch/csrc``
   and hold each one against its plain PyTorch version, on the same CUDA
   tensors, at the shapes of the main paths: the full and trailing training
   batches (32, 3451) and (25, 3451), the validation split (273, 3451), and
   a ragged (7, 50) with 10% NaN targets and clipped theta.  K1/K2: at each shape:
   NB with theta (B, G), (1, G) and (B, 1); ZINB with theta/pi (B, G)/(B, G)
   at ridge 0 and 0.1, and the broadcast pairs (1, G)/(B, G), (B, 1)/(B, 1),
   (1, G)/(1, G), (B, 1)/(1, G) at ridge 0.1; and at a rank's (rows, gene
   shard) of the model-parallel fits (``MP_SHAPES``): (32, 1725), (25,
   1725) and (273, 1725) at 3450 genes on 1 x 2, (16, 1724), (13, 1724)
   and (12, 1724) at 3448 on 2 x 2, (32, 862), (25, 862) and (273, 862)
   at 3448 on 1 x 4.  Tolerances: loss relative
   error <= 1e-5 (the kernel sums in another order than torch.sum) and the
   denominator's count exact; gradients, taken with an incoming gradient
   g = 0.37 (``G_BWD``) that K2 divides by the denominator itself,
   elementwise, stated on the unscaled gradient (the path's gradients
   carry g / denom, about 1e-6 at (273, 3451)): rtol 1e-4, atol 1e-6 plus
   4 float32 ulps of the sum of the
   magnitudes of the terms the formula adds
   (``fused_loss.grad_term_magnitudes``), since both sides round those
   terms in float32 and, where they cancel, the result is far smaller.  A
   broadcast operand's gradient is a sum of n such elements: its tolerance
   is the sum of theirs plus 2 ceil(log2 n) ulps of the summed magnitudes
   for the two reductions' rounding.  K1 must give the same bits twice.
   K1w/K2w (the weighted variants) at the validation block of one of two
   ranks (137, 3451), the batch (32, 3451), the ragged (7, 50) and a
   2 x 2 grid's validation block (137, 1724), with
   the same theta/pi cases, each with padding weights (ones, the last row
   0), fractional weights (two rows 0) and all-zero weights (denominator
   1): the same tolerances, the total weight exact for 0/1 weights, each
   element's gradient tolerance times its weight, and gradients of
   exactly 0 on zero-weight rows and at NaN targets.
   K4 (the fused dense block) at the shapes of the denoise path
   (``DENSE_CASES``), through both tilings of its plan
   (``fused_dense.plan``: whole K in shared memory for K <= 64, split-K
   across a cluster above): the encoder (2730, 3451) -> 64 with BN and
   relu (split-K), the heads (2730, 64) -> 3451 with the mean, disp and
   sigmoid epilogues (whole K), the decoder layer 32 -> 64 at 2730 and 64
   rows, a ragged (33, 200) -> 70 with BN, size factors and all 8
   epilogues, (16, 1500) -> 96, a ragged last slice (33, 1000) -> 70, K =
   65 in 3 one-step slices, K = 20 with all 8 epilogues, a head of N = 200,
   and the encoder, heads, ragged case and small head again under
   DCA_TPU_MATMUL=bf16.
   Tolerances: the ``linear`` output against the plain version within
   2 K 2^-24 (|x| @ |W| + |b|) elementwise, times |s| with BN, plus 4
   ulps (two float32 sums of K products in different orders); each
   activated output within 4 ulps of the plain activation applied to the
   kernel's own linear output (times sf); the pre-activation the same bits
   for every epilogue (relu, elu and linear outputs equal to the linear
   output where it is positive); a NaN in a row of x gives a NaN row
   under every epilogue and leaves the other rows' bits as they were; two
   runs give the same bits.  K1 and K1w also give (sum, count, loss,
   denom) in one launch: the loss and denominator come from the kernel.
   graph_if (``csrc/graph_if.cu``, the kernel that sets the whole-fit
   graph's IF node, no TPU counterpart) in a graph of 3 IF nodes replayed
   with the flag false and true: each body runs exactly where its plain
   version (``conditional.if_reference``) is true; then its time, a node
   with its body skipped in a graph of 100, against ``logical_not`` of
   the flag, in turns (``phase_graph_if``).
   K5 (``csrc/fused_optim.cu``, RMSprop's whole update in one launch, no
   TPU counterpart) against the plain loop (``train/optim.py::
   _rmsprop_loop``) over 20 updates from the same state, the rate cut
   after 10: at the leaves of nb-conddisp and zinb-conddisp at 3451
   genes, at odd sizes (1, 3, 3451, 1725, 862) on fresh tensors and on
   misaligned views into flat buffers, and with gradients of +-inf, NaN,
   exactly +-5 and past it, clipped and not: the same bits after every
   update; then its time at both configurations' leaves, a graph replay,
   beside its bound (20 bytes an element) and the plain loop's
   (``phase_optim``).
2. Kernel timings at (32, 3451), NB and ZINB: median device time of 50
   launches after a warm-up, each launch a CUDA graph replay between CUDA
   events (see ``_device_ms``); beside them the plain version's time and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s float32).  K1 also at the validation split (273, 3451).
   One whole loss backward (``_FusedNLL.backward``: K2 alone), and with
   ``--parent`` the parent's (its division, then its K2), in turns.
   K1w at (137, 3451) and K2w at (32, 3451), NB and ZINB, likewise; K1
   and K2 at the model-parallel shards (32, 1725) and (32, 862), and K1w
   and K2w at (137, 1724) (``mp_shard_timings``); ZINB
   K2 at (273, 3451) and K2w at (137, 3451), the shapes of the TensorBoard
   gradient (phases 4, 7 and 11).
   K4 at the encoder and head shapes, with its plan, its bound, the plain
   version's time and, for the ``linear`` epilogue, ``torch.addmm``'s,
   timed in turns with K4 on the same inputs (x warm in the 50 MB L2 for
   both).
3. Zoo: every architecture of ``AE_types``, and zinb-elempi with
   sharedpi, trains 2 epochs at 200 cells x 60 genes, (16, 8, 16), on the
   CPU (the eager loop) and on the card (the steps replayed from CUDA
   graphs, ``train/graphs.py``) from the same weights; the losses must
   agree epoch by epoch within rtol 1e-3 (matrix products and sums run in
   another order on the two devices, and the difference grows over the
   RMSprop steps), and the card run must launch the kernel family of its
   likelihood and no other (normal and poisson launch none), its warm-up
   steps included.
4. API runs: ``dca_tpu_torch.dca`` on a 2730 x 3451 Paul15-shaped matrix,
   64-32-64, batch 32, on the card: zinb-conddisp for 5 epochs (the main
   path), after a 1-epoch latent-mode run, then nb-conddisp for 2; each
   through the CUDA-graph path and then eagerly on the card
   (``training_kwds={"_graphs": False}``): outputs finite and of the right
   shapes, the kernels' launch counters, set to 0 just before each run,
   equal to what that run must launch (the graph run's two warm-up steps
   included), and the two histories equal within rtol 1e-6 (whether they
   are the same bits is printed).  Then the per-epoch wall time of
   ``train()`` zinb-conddisp, eager and graph, three 3-epoch fits each in
   turns, and the graph fits' capture times; the graph epoch must be the
   faster (``epoch_timings``).  Then zinb-conddisp once more through the
   graphs with ``tensorboard=True`` (``_tb_run``): the plain graph fit's
   history bit for bit, every scalar and histogram tag at every epoch, a
   profiler trace beside the events, and one more K1 and K2 an epoch.
5. CLI runs: ``python -m dca_tpu_torch counts.tsv out/ -e 2`` on the card
   with the default nb-conddisp, ``--type zinb-conddisp`` and ``--type
   zinb``, and the output contract (mean, mean_norm, latent, reduced,
   dispersion, and for ZINB dropout and pi TSVs, and model.pickle, all
   values finite); then zinb-conddisp again through the streaming write
   (DCA_TPU_HOST_DENSE_BYTES=1) with K4 on (DCA_TPU_FUSED_DENSE=1).
6. The denoise tier on phase 4's trained zinb-conddisp network at
   2730 x 3451: the forward's 7 outputs fetched through the page-locked
   ring (``network.fetch_to_host``, the main path) the same bits as
   pageable copies, into pageable arrays, both fetches timed in turns; the
   page-locked memory of the block forward at 32768-row blocks (nothing
   beyond the ring), and the resident memory;
   ``forward`` with K4 off and on
   (outputs within the error bound propagated through the layers,
   ``_forward_tolerance``; 4 K4 launches: encoder, mean, dispersion and pi
   heads; both timed in turns), then ``write_streaming(mode="full",
   return_info=True, chunk_rows=1024)`` with DCA_TPU_WRITE_ALIASES=0 in 3
   blocks, formatted by the native tier (12 K4 launches; every block
   format native; file shapes; the first genes of mean.tsv equal to the
   in-memory output of the same blocks printed to 6 decimals; its time),
   and again through pandas (DCA_TPU_NO_NATIVE=1: the same bytes in every
   file; its time); and phase 4's nb-conddisp network's
   ``predict(return_info=True)`` (4 K4 launches: encoder and mean head for
   the denoise, encoder and dispersion head for the dispersion after it).
7. The data-parallel fit: 2 ranks, spawned, both on the one card over
   gloo (asked for explicitly; NCCL refuses ranks that share a device),
   each running ``dca(devices="all")`` on phase 4's matrix and seed:
   zinb-conddisp for 2 epochs, the same again with ``tensorboard=True``,
   then nb-conddisp for 1.  Loss and val_loss the same on both ranks and
   within rtol 1e-3 of phase 4's first two epochs; per-rank launches 154 /
   154 K1/K2 and 2 K1w (the padded validation, 273 rows to 274) for
   zinb-conddisp, 77 / 77 and 1 K1w for nb-conddisp; the TensorBoard fit
   the plain fit's history bit for bit on every rank, with 2 more K1w and
   2 K2w a rank (its gradient on the padded block, once an epoch), and
   one event file (rank 0's), whose last ``grads/``
   histograms (min, max, num, sum, sum of squares) match within rtol 1e-3
   (the sum within 1e-3 sqrt(num x sum of squares), the elementwise rtol
   carried through the sum) the one-card gradient of rank 0's final
   parameters on the same 273 validation rows (``_one_card_grad_stats``); their distance from phase
   4's TensorBoard fit is printed, not held: the Dense bias before each
   BatchNorm has a training gradient of exactly 0, which RMSprop turns
   into learning-rate-sized steps of rounding noise, different on one
   card and on two ranks, and the eval-mode gradient reads those biases
   (val_loss is 4e-4 to 8e-4 apart for the same reason);
   the denoised matrices equal on both ranks and finite; rank 0 alone
   writes (its model.pickle).  Then nb-conddisp with ``tensorboard=True``
   for 1 epoch on the first 546 cells and the genes they express (16 steps,
   55 validation rows padded to 56): the same history on both ranks,
   16 / 16 K1/K2, 2 K1w and 1 K2w a rank (the NB K2w's launch in a fit),
   rank 0's event file.  Then zinb-conddisp with ``compiled=True`` for 2
   epochs on the first 2720 cells (2448 train and 272 validation rows,
   which divide the ranks: the whole fit, its epochs from Python over
   gloo, from the whole-fit graph over NCCL in ``chip_dp.py``): the same
   history on both ranks, within rtol 1e-3 of phase 13's one-card
   compiled fit of the same cells, 156 / 154 K1/K2 a rank (234 / 231 with
   the graph's warm-up epoch) and no weighted kernel.  Then the streaming
   trainer under the group: phase 10 (a)'s
   zinb-conddisp fit from its weights, ``train(devices="all",
   max_device_cells=512)`` for 2 epochs through the host and the
   padded-payload tiers, each rank staging its block of each batch, with
   a checkpoint an epoch: the same history on both ranks and in both
   tiers, within rtol 1e-3 (loss) and 1e-2 (val_loss, the BatchNorm-bias
   noise) of phase 10's one-card host-tier fit, 154 / 154 K1/K2 and 2 K1w
   a rank (273 validation rows padded to 274, once an epoch), rank 0 alone
   printing its epochs and writing checkpoints; its epoch time beside
   phase 10's one-card one.  Then gene-dim model parallelism
   (``phase_model_parallel``): 2 spawned ranks on the card over gloo run
   ``dca(devices="all", model_parallel=2)``, a grid of 1 x 2, on phase 4's
   cells: zinb-conddisp on the first 3450 genes for 2 epochs (every gene
   tensor sharded), and nb-conddisp on all 3451 for 1 epoch (nothing
   divides 2: every tensor whole on both ranks).  Each: the same history
   on both ranks, within rtol 1e-3 (loss) and 1e-2 (val_loss, the
   BatchNorm-bias noise) of the one-card fit of the same genes; the
   gathered parameters and the denoised matrices the same on both ranks,
   whole and finite; rank 0 alone writes; per-rank launches 156 / 154
   K1/K2 and no K1w for zinb-conddisp (the validation of a grid with one
   data index is not padded), 78 / 77 for nb-conddisp
   (``want_mp_launches``).  Then the streaming trainer on that grid: the
   zinb-conddisp fit at 3450 genes from fresh weights,
   ``train(devices="all", model_parallel=2, max_device_cells=512)`` for 2
   epochs through the host and the padded-payload tiers, both ranks
   staging the same rows whole and stepping on their gene columns: the
   same history on both ranks and in both tiers, within rtol 1e-3 (loss)
   and 1e-2 (val_loss) of the one-card host-tier streamed fit of the same
   genes and weights (CUDA graphs), 156 / 154 K1/K2 and no K1w a rank
   (``want_group_stream_launches`` at one data index), rank 0 alone
   printing its epochs.  Then the launcher (``phase_launch``):
   ``dca(devices=2)`` from this process, its two ranks (this process and
   a worker it starts) sharing the card over gloo (``_one_card``): the
   zinb-conddisp fit of the spawned ranks above, history within rtol 1e-4
   of theirs, rank 0's launches theirs (154 / 154 and 2 K1w), no process
   group left; its start-up and shared bytes printed.  A rank that fails
   or outlives its time limit fails the phase.  The data-parallel and
   model-parallel epoch times are printed: two ranks sharing one card
   measure no scaling.  These ranks share the card over gloo, so their
   steps run eagerly (gloo's collectives cannot be captured); over NCCL
   (``chip_dp.py``, phase 14) the same steps are replayed from CUDA
   graphs, and each fit then launches K1/K2 once more for each captured
   step's warm-up (``want_mp_launches``, ``want_group_stream_launches``
   with ``captured``).

8. The native IO tier (``dca_tpu_torch/native``, g++ at first use) must
   build on the card's host; ``read_text`` of the 3451 x 2730 gene x cell
   count TSV through it and through pandas gives the same matrix and
   names, and the %.6f format of a 3451 x 2730 float matrix the bytes of
   pandas ``to_csv``; each timed.
9. The fit's options: each of the seven optimizers (SGD, RMSprop, Adam,
   Adamax, Nadam, Adagrad, Adadelta), and PReLU with RMSprop and with
   Adam, in a zinb-conddisp (16, 8, 16) fit of 200 x 60 for 2 epochs on
   the CPU, on the card through the CUDA graphs and on the card eagerly,
   from the same weights: the graph history the eager one's bits, the
   step count of Adam, Adamax and Nadam the steps taken, the K1/K2
   launches exact (warm-ups included), the card within rtol 1e-3 of the
   CPU.  Then ``dca()`` zinb-conddisp 64-32-64 with PReLU and Adam at
   2730 x 3451 for 2 epochs through the graphs (launches exact, step count,
   outputs finite, the alphas trained), and the graph epoch of
   ``train()`` with RMSprop and with Adam, three 3-epoch fits each in
   turns.

10. The streaming trainer (``train/loop.py::_train_streaming``), on
   zinb-conddisp 64-32-64 fits through the CUDA graphs, the data read and
   normalized with the z-scale deferred (``normalize(lazy_scale=True)``).
   (a) At phase 4's 2730 x 3451 with ``max_device_cells=512`` (an epoch
   is 6 staged parts, the last chunk's 12 full batches and its 25-row
   trailing batch apart, and one 273-row validation chunk), 2 epochs
   through each staging tier: host densify, padded, flat and flat8
   payloads, the derived input and the resident corpus (forced with
   DCA_TPU_RESIDENT=1).  Held against the in-memory graph fit from the
   same weights: host, padded, flat and flat8 its history bit for bit;
   the derived input within rtol 2e-3 (``DERIVED_RTOL``: its input is
   log1p on the device, held within 2 ulps of the host's); the resident
   tier the derived tier's
   bits; each fit's K1/K2 launches exact, the warm-ups of its 3 captured
   steps included.  Then every device scatter (padded, flat, flat8, and
   flat into a kept buffer) of a 512-row part, with the z-scale on the
   normalized X and without it on the raw counts, the bits of
   ``native.densify_rows``; and the block forward's payload branch
   (DCA_TPU_DEVICE_DENSIFY=1, blocks of 1024 rows) the host forward's bits
   with K4 off, and with K4 on within ``_forward_tolerance`` (4 K4
   launches a block).
   (b) At corpus scale: 262,144 cells x 3451 genes, 345 nonzeros a cell
   (~10%; ``synthetic_sparse_counts``), which streams by the default gate
   (7.24e9 bytes > 6e9): parts of 131,072 cells, 7,372 full steps, a
   25-row trailing step and one 26,215-row validation chunk an epoch.  2
   epochs on the host tier, then 2 with the resident corpus, which the
   auto gate engages: each epoch's time, training rows/s, the device
   memory peak against the estimate (part buffers, and the resident
   payload and a part's transient), the host's peak resident memory, and
   the main stream's busy share of each epoch (DCA_TPU_TIMELINE, written
   to chip_smoke_out/timeline_*.jsonl); launches exact.  One resident part
   target rebuilt by the slice (unfold) gather ``ops/resident.py`` uses and
   by the element-wise gather, the same bits, timed in turns; the whole
   part's time and its transient device memory a padded slot.  ZINB K1 at the
   validation chunk's (26215, 3451) against its plain version (loss rel
   err <= 1e-5), both timed.

11. The fit's artefacts: zinb-conddisp 64-32-64 at phase 4's 2730 x 3451,
   dropout 0.1, ``train()`` through the CUDA graphs.  (a) A 4-epoch fit
   with ``checkpoint_every=1`` against 2 epochs and then ``resume=True``
   to 4: epochs 3-4 and the final parameters the same bits, each
   segment's K1/K2 launches exact (replays and warm-ups); the time of
   each checkpoint save (read-back and npz), its bytes, the resume's
   restore.  (b) ``load_model`` of the fit's ``model.pickle`` rebuilds the
   trained network on the card; where h5py imports, the fit also ran with
   ``save_weights=True`` and ``weights.hdf5`` holds the best epoch's
   parameters, and ``load_weights`` into a fresh network on the card then
   predicts the fit's bits (the best epoch being the last); without h5py
   that is printed as not run.  (c) ``tensorboard=True``: the history of
   (a)'s 4-epoch fit bit for bit, every tag at every epoch, a profiler
   trace, one more K1 and K2 an epoch, and each K2 of the gradient at
   (273, 3451) against the plain version on the same tensors at K2's
   tolerance (``check_k2_call``); the epoch times with and without
   TensorBoard.  (d) Phase 10 (a)'s streamed fit (parts of 512) for 2
   epochs against 1 epoch with a checkpoint and a resume to 2, on the host
   and the resident tiers: the same bits.

12. The hyperparameter search, the diagnostics and the quality oracle, on
   the card.  (a) One trial's objective (``hyper._objective``: zinb-conddisp
   64-32-64, relu, BN, dropout 0, ridge 0.01, lr 1e-3, 2 epochs, a 20% tail
   validation) on phase 4's 2730 x 3451 matrix: the bits of min(val_loss)
   of ``train()`` called directly with the same arguments, and exactly the
   K1/K2 of 2 epochs of 69 steps (68 full, a trailing 8 rows) and their 2
   warm-ups; ZINB K1 at the trial's validation shape (546, 3451) against
   its plain version (loss rel err <= 1e-5, count exact), timed beside its
   byte bound.  (b) ``hyper_search`` on the same matrix, reference_space(2),
   seed 0, 3 trials and the pre-flight, sequential and with 2 threads on
   the one card in turns (sequential, 2, 2, sequential): the same configs,
   every loss finite and within rtol 1e-5 (whether they are the same bits
   is printed), the same ``best.json`` where they are, both artefacts
   written, the K1/K2 of the 4 trials' schedules exactly; each search's
   wall time and the ratio.  (c) ``python -m dca_tpu_torch counts.tsv out
   --hyper --hypern 2 --hyperepoch 1``: exit 0 and both artefacts.  (d)
   ``fit_zinb``, ``zero_inflation_test`` and ``optimize_zinb`` on the
   samples of tests/test_diagnostics.py on the card and on the CPU, within
   the CPU tests' tolerances of each other, that file's assertions on the
   card's (the plots where matplotlib imports); each timed.  (e)
   tests/test_quality.py's two checks through ``dca()`` on the card at
   their sizes, seeds and thresholds (silhouettes by sklearn where it
   imports, else by this file's numpy PCA and silhouette), and the
   ``sim-drop3-group2`` case of ``simulation_grid`` through ``to_anndata``
   and ``dca()``, its silhouettes printed.

13. The whole fit on the device (``train(compiled=True)``,
   ``train/compiled.py``): zinb-conddisp and nb-conddisp 64-32-64 at
   phase 4's 2730 x 3451, batch 32, 10% validation, RMSprop, dropout 0.1,
   from one seed's weights.  (a) 5 epochs: the fit from its whole-epoch
   CUDA graph (``train/graphs.py::GraphFit``) the bits of the same fit
   from Python on the card (``_graphs=False``): histories, epochs run,
   final parameters.  (b) Against the Python-epoch loop's graph fit
   (phase 4's path) under the same row orders, where no callback fires:
   the final parameters the same bits or within rtol 1e-6, val_loss the
   same bits, loss within rtol 1e-6 (its sums in float32, the loop's in
   float64).  (c) ``early_stop=2``, ``reduce_lr=0``, lr 0.01 over 300
   epochs: it stops early after as many epochs as from Python, the same
   bits, NaN history past the stop; an epoch's time and one after the
   stop (device time between the replays' events) printed.  (d)
   ``save_weights=True``: the state the fit hands ``save_weights`` (its
   file write replaced: the card's machine has no h5py) is the bits of
   the same fit cut at its best epoch, and the network keeps the final
   state.  (e) The launches, set to 0 just before each graph fit: K1 a
   step and one for the validation, K2 a step, for each epoch run and
   the warm-up epoch (468 / 462 for 5 epochs), never for an epoch after
   the stop; graph_if once a replay (5; 300 with the early stop).  Then
   the compiled epoch against the Python-epoch loop's graph epoch, three
   5-epoch fits each in turns (medians of epochs 2-5), and the capture
   times; and the one-card ``dca()`` compiled fit on the first 2720 cells
   that phase 7 holds its ranks to.

14. The sharded step replayed from CUDA graphs under NCCL
   (``phase_nccl_one_rank``): a process group of one rank over NCCL on the
   card, in which ``train(devices="all")`` runs the sharded step of
   ``parallel/step.py`` over a mesh of one rank, its collectives NCCL's,
   captured inside the step's CUDA graphs.  zinb-conddisp 64-32-64 at
   phase 4's 2730 x 3451 from one seed's weights, 3 epochs in memory,
   captured and eager (``_graphs=False``) in turns (captured, eager,
   eager, captured), then streamed (parts of 512, 2 epochs, host tier)
   both ways, and the fit with no group's mesh for its epoch: captured and
   eager the same bits (histories and final parameters), a capture
   recorded under the group and none eager, the K1/K2 launches of each fit
   those of its schedule (the captured in-memory fit the no-group graph
   fit's, 2 warm-ups included; streamed 3); capture seconds and epoch
   times printed beside the no-group graph epoch.  Then ``compiled=True``
   under the group (``_nccl_one_compiled``): phase 13's zinb-conddisp fit,
   5 epochs, from the whole-fit graph (its collectives in the graph's
   epoch), from Python (``_graphs=False``) and with no group, the same
   bits (histories, epochs run, final parameters); the early-stopped fit
   (``early_stop=2`` over 300 epochs) both ways under the group, the same
   bits, NaN past the stop; K1/K2 launches as phase 13's (468 / 462 with
   the warm-up epoch); graph_if 5 without the group and none under it,
   whose graph has no IF node (CUDA refuses NCCL's collectives in a
   conditional body: ``train/graphs.py::GraphFit``), its replays ending
   with the fit; the epochs beside the no-group whole-fit graph's.

The phases run in the order 1-3, 13, 4, 10, 11, 12, 9, 8, 5-7, 14: phase 13
before any profiler session (phase 4's TensorBoard fit), which leaves
each later launch of its whole-epoch graph milliseconds of host time.  Prints the card's name and
power limit, then one ``{"kernels": [...]}``
line, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero, with no result line, when there is no CUDA device or a phase
fails.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import types
from io import StringIO

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # on the unscaled gradient
GRAD_ULPS = 4  # float32 ulps of the gradient's summed term magnitudes
F32_EPS = 2.0 ** -23
N_TIMED = 50
# the incoming gradient of the loss in the checks of K2: not 1, so that a
# kernel that dropped g would fail them
G_BWD = 0.37


class SmokeFailure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_paul15_like(n_cells=2730, n_genes=3451, seed=42):
    """Synthetic counts at the Paul15 scale and sparsity (~75% zeros), the
    shape of the reference's Figure 9 workload; the same generator as the
    JAX package's bench.py."""
    rs = np.random.RandomState(seed)
    base = rs.gamma(0.5, 1.0, size=(1, n_genes))
    depth = rs.lognormal(0.0, 0.5, size=(n_cells, 1))
    mu = base * depth * 1.2
    counts = rs.negative_binomial(0.7, 0.7 / (0.7 + mu)).astype(np.float32)
    counts[:, counts.sum(0) == 0] += 1.0
    counts[counts.sum(1) == 0, 0] += 1.0
    return counts


def _loss_inputs(B, G, seed, nan_frac=0.0, n_clipped=0, th_shape=None,
                 pi_shape=None):
    """y, mu, theta and pi as the main paths give them: NB counts with
    dropout, means, dispersions and dropout probabilities inside the output
    heads' clips; theta of ``th_shape`` and pi of ``pi_shape`` (None: no
    pi), each (B, G) by default."""
    rs = np.random.RandomState(seed)
    mu = rs.lognormal(0.0, 1.0, size=(B, G)).clip(1e-5, 1e6).astype(np.float32)
    th = rs.lognormal(0.5, 1.0, size=th_shape or (B, G)).clip(1e-4, 1e4).astype(np.float32)
    y = rs.negative_binomial(th, th / (th + mu)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.2] = 0.0
    if nan_frac:
        y[rs.uniform(size=y.shape) < nan_frac] = np.nan
    if n_clipped:
        flat = th.reshape(-1)
        flat[rs.choice(flat.size, min(n_clipped, flat.size - 1), replace=False)] = 2e6
    pi = None
    if pi_shape is not None:
        pi = (1.0 / (1.0 + np.exp(-rs.normal(-1.0, 1.5, size=pi_shape)))).astype(np.float32)
    return y, mu, th, pi


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def _pushes(x):
    """Recurrence steps the Stirling functions take at x (z < 8 tests)."""
    import torch

    return torch.clamp(torch.ceil(8.0 - x), 0.0, 8.0)


def _k1_ops(y, mu, th, with_pi=False):
    """Operations of K1 on these inputs, counted from the kernel source
    with a transcendental as one: 22 + 3 k per log Gamma (k recurrence
    steps), 27 around them, and 25 more for the ZINB terms."""
    import torch

    y0 = torch.nan_to_num(y, nan=0.0)
    t = torch.clamp(th, max=1e6).expand(y.shape)
    k = _pushes(t + 1e-10) + _pushes(y0 + 1.0) + _pushes(y0 + t + 1e-10)
    return float(y.numel() * (27 + 3 * 22 + (25 if with_pi else 0)) + 3 * k.sum().item())


def _k2_ops(y, mu, th, with_pi=False):
    """Operations of K2: 21 + 3 k per digamma, 28 around the two, and 43
    more for the ZINB terms."""
    import torch

    y0 = torch.nan_to_num(y, nan=0.0)
    t = torch.clamp(th, max=1e6).expand(y.shape) + 1e-10
    k = _pushes(t) + _pushes(y0 + t)
    return float(y.numel() * (28 + 2 * 21 + (43 if with_pi else 0)) + 3 * k.sum().item())


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# operations of K4's epilogue per output beyond the bias: the activation
# (a transcendental counted as one), as csrc/fused_dense.cu computes it
K4_ACT_OPS = {"mean": 3, "disp": 8, "sigmoid": 4, "relu": 1, "selu": 4, "elu": 2,
              "tanh": 1, "linear": 0}


def k4_bound(rows, k, n, bn=False, activation="linear", sf=False):
    """The bound of K4 (``dca_tpu/ops/fused_dense.py::_kernel``) for
    act((x @ W + b) s + t) sf on (rows, k) @ (k, n).  Bytes: x, W, b, the
    folded BN's s and t, sf read once, the (rows, n) output written once;
    operations: 2 per multiply-add of the product, 1 for the bias, 2 for
    the BN affine, the activation's, 1 for sf, per output.  Returns (bound
    ms, bound by, bytes, operations)."""
    n_bytes = 4 * (rows * k + k * n + n + (2 * n if bn else 0) + (rows if sf else 0)
                   + rows * n)
    n_ops = 2.0 * rows * k * n + rows * n * (1 + (2 if bn else 0) + K4_ACT_OPS[activation]
                                             + (1 if sf else 0))
    ms, by = _bound_ms(n_bytes, n_ops)
    return ms, by, n_bytes, n_ops


def _device_ms(fn, n=N_TIMED, warmup=10):
    """Median device time of ``n`` calls of ``fn``.  One call is captured
    in a CUDA graph, so its launches run back to back on the device; each
    replay is timed with CUDA events, and a sleep kernel holds the device
    while the host queues the replays, so host enqueue time is not
    counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from dca_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"phase 1: kernels built and loaded in {secs:.2f} s: {lib_path}")
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)
                    or "spill" in line):
                print("  " + line.strip())


def _grad_check(name, got, want, want_full, mag, scale):
    """Hold a K2 gradient against its plain version on the unscaled values
    (see the module docstring); return (max abs error, max error / tol).
    ``want_full`` (unscaled) and ``mag`` are (B, G); ``want`` may be
    reduced to a broadcast operand's shape, and the elements' tolerances
    are then summed alike, plus the rounding of two float32 sums of n
    terms."""
    import torch

    from dca_tpu_torch.ops.fused_loss import _reduce_to

    _check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    _check(bool(torch.isfinite(got).all()), f"{name} not finite")
    err = (got - want).abs() / scale
    elem = GRAD_ATOL + GRAD_ULPS * F32_EPS * mag + GRAD_RTOL * want_full.abs()
    tol = _reduce_to(elem, want.shape)
    summed = mag.numel() // want.numel()
    if summed > 1:
        tol = tol + (2 * int(np.ceil(np.log2(summed))) * F32_EPS
                     * _reduce_to(want_full.abs(), want.shape))
    bad = err > tol
    _check(not bool(bad.any()),
           f"{name}: {int(bad.sum())} elements outside rtol {GRAD_RTOL}, atol "
           f"{GRAD_ATOL} + {GRAD_ULPS} ulps of the terms (summed over {summed}); max "
           f"unscaled error {err.max().item():.3e}")
    return err.max().item(), (err / tol).max().item()


def check_k2_call(what, args, out):
    """Hold one K2 or K2w launch of a path (``args`` as the wrapper
    ``fused_loss._bwd_kernel`` took them: y, mu, theta, pi, ridge, g, denom
    and w; ``out`` its gradients) against the plain version on the same
    tensors, at K2's tolerance (``_grad_check``; weighted: each element's
    terms times its weight, exactly 0 on zero-weight rows).  Returns the
    largest error over its tolerance."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    y, mu, th, pi, ridge, g, denom, w = args
    B, G = mu.shape
    with torch.no_grad():
        refs = fl._bwd_reference(y, mu, th, pi, ridge, g, denom, w)
        w_eff = 1.0 if w is None else torch.where(torch.isnan(y), 0.0, w)
        fulls = [d * w_eff for d in fl._elem_grads(y, mu, th, pi, ridge) if d is not None]
        mags = [m * w_eff for m in fl.grad_term_magnitudes(y, mu, th, pi, ridge)
                if m is not None]
    worst = 0.0
    for gname, got, want, full, mag in zip(("d mu", "d theta", "d pi"), out, refs, fulls,
                                           mags):
        if w is not None and got.shape == (B, G):
            _check(bool((got[(w_eff == 0.0).expand(B, G)] == 0.0).all()),
                   f"{what}: {gname} not exactly 0 on zero-weight rows")
        worst = max(worst, _grad_check(f"{what}: {gname}", got, want, full.expand(B, G),
                                       mag.expand(B, G), g / denom)[1])
    return worst


@contextlib.contextmanager
def recording_k2():
    """Record every call of K2's wrapper in the block: a list of (args,
    gradients)."""
    from dca_tpu_torch.ops import fused_loss as fl

    calls, real = [], fl._bwd_kernel

    def rec(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    fl._bwd_kernel = rec
    try:
        yield calls
    finally:
        fl._bwd_kernel = real


# the batch, the trailing batch and the validation of the 2730 x 3451 fits,
# a small ragged case with NaN and clipped entries, and each of 2 ranks'
# blocks of the batch and the trailing batch (phase 7)
COMPARE_SHAPES = [((32, 3451), 0.0, 0), ((25, 3451), 0.0, 0), ((273, 3451), 0.0, 0),
                  ((7, 50), 0.1, 3), ((16, 3451), 0.0, 0), ((13, 3451), 0.0, 0),
                  ((12, 3451), 0.0, 0)]
# and a rank's (rows, gene shard) of the model-parallel fits: 3450 genes on
# 1 x 2 (phase 7), 3448 on 2 x 2 and 1 x 4 (chip_dp.py)
MP_SHAPES = [((32, 1725), 0.0, 0), ((25, 1725), 0.0, 0), ((273, 1725), 0.0, 0),
             ((16, 1724), 0.0, 0), ((13, 1724), 0.0, 0), ((12, 1724), 0.0, 0),
             ((32, 862), 0.0, 0), ((25, 862), 0.0, 0), ((273, 862), 0.0, 0)]
COMPARE_SHAPES += MP_SHAPES


def _compare_cases(B, G):
    """(theta shape, pi shape or None, ridge) of each check at (B, G)."""
    full, row, col = (B, G), (1, G), (B, 1)
    return ([(full, None, 0.0), (row, None, 0.0), (col, None, 0.0),
             (full, full, 0.0), (full, full, 0.1)]
            + [(th, pi, 0.1) for th, pi in ((row, full), (col, col), (row, row), (col, row))])


def phase_compare(dev):
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    worst = {k: {"fwd_abs": 0.0, "fwd_rel": 0.0, "bwd_abs": 0.0, "bwd_tol": 0.0}
             for k in ("nb", "zinb")}
    n_checks = 0
    for seed, ((B, G), nan_frac, n_clipped) in enumerate(COMPARE_SHAPES):
        for case, (th_shape, pi_shape, ridge) in enumerate(_compare_cases(B, G)):
            y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(B, G, 100 * seed + case, nan_frac,
                                                   n_clipped, th_shape, pi_shape))
            fam = "nb" if pi is None else "zinb"
            what = f"{fam} K1/K2 at {(B, G)}, theta {th_shape}, pi {pi_shape}, ridge {ridge}"
            ops = (mu, th) if pi is None else (mu, th, pi)
            for t in ops:
                t.requires_grad_(True)
            if pi is None:
                loss = fl.nb_nll_fused(y, mu, th)  # K1
                again = fl.nb_nll_fused(y, mu, th)
                _, denom = fl.nb_nll_fwd_kernel(y, mu, th)
            else:
                loss = fl.zinb_nll_fused(y, mu, th, pi, ridge)
                again = fl.zinb_nll_fused(y, mu, th, pi, ridge)
                _, denom = fl.zinb_nll_fwd_kernel(y, mu, th, pi, ridge)
            g = torch.tensor(G_BWD, device=dev)
            grads = torch.autograd.grad(loss, ops, g)  # K2
            _check(torch.equal(loss, again), f"{what}: K1 is not deterministic")
            with torch.no_grad():
                ref, rdenom = fl._fwd_reference(y, mu, th, pi, ridge)
                scale = g / rdenom  # what the path multiplies the gradients by
                refs = fl._bwd_reference(y, mu, th, pi, ridge, g, rdenom)
                fulls = fl._elem_grads(y, mu, th, pi, ridge)
                mags = fl.grad_term_magnitudes(y, mu, th, pi, ridge)
            _check(torch.equal(denom, rdenom),
                   f"{what}: K1 count {denom.item()} vs plain {rdenom.item()}")
            fwd_abs = abs(loss.item() - ref.item())
            fwd_rel = fwd_abs / abs(ref.item())
            _check(np.isfinite(loss.item()), f"{what}: loss not finite")
            _check(fwd_rel <= LOSS_RTOL,
                   f"{what}: loss {loss.item()!r} vs plain {ref.item()!r}, relative "
                   f"error {fwd_rel:.3e} > {LOSS_RTOL}")
            w = worst[fam]
            for gname, got, want, full, mag in zip(("d mu", "d theta", "d pi"), grads,
                                                   refs, fulls, mags):
                e_abs, e_tol = _grad_check(f"{what}: {gname}", got, want,
                                           full.expand(B, G), mag.expand(B, G), scale)
                w["bwd_abs"] = max(w["bwd_abs"], e_abs)
                w["bwd_tol"] = max(w["bwd_tol"], e_tol)
            w["fwd_abs"] = max(w["fwd_abs"], fwd_abs)
            w["fwd_rel"] = max(w["fwd_rel"], fwd_rel)
            n_checks += 1
        print(f"phase 1: {(B, G)}: {len(_compare_cases(B, G))} NB/ZINB cases agree")
    for fam, w in worst.items():
        print(f"phase 1: {fam}: worst K1 loss error {w['fwd_abs']:.3e} abs, "
              f"{w['fwd_rel']:.3e} rel; worst K2 unscaled gradient error "
              f"{w['bwd_abs']:.3e} abs, {w['bwd_tol']:.3f} of its tolerance "
              f"({n_checks} cases in all)")
    return worst


# K1w/K2w: the validation block of one of 2 ranks (273 rows padded to 274),
# the training batch, and the ragged case with NaN targets and clipped theta
WEIGHTED_SHAPES = [((137, 3451), 0.0, 0), ((32, 3451), 0.0, 0), ((7, 50), 0.1, 3),
                   ((137, 1724), 0.0, 0)]  # a rank's validation block on 2 x 2
WEIGHT_KINDS = ("padding", "fractional", "zero")


def _weights(B, kind, seed):
    """A (B, 1) weight column: ``padding`` ones with the last row at 0 (a
    padded validation block), ``fractional`` in [0.2, 2) with two rows at
    0, ``zero`` all 0 (the denominator is then 1)."""
    w = np.ones((B, 1), np.float32)
    if kind == "padding":
        w[-1] = 0.0
    elif kind == "fractional":
        w = np.random.RandomState(seed).uniform(0.2, 2.0, size=(B, 1)).astype(np.float32)
        w[[0, B // 2]] = 0.0
    else:
        w[:] = 0.0
    return w


def check_weighted_case(dev, B, G, nan_frac, n_clipped, th_shape, pi_shape, ridge, kind,
                        seed):
    """Hold K1w/K2w against their plain versions on one case: the loss
    within LOSS_RTOL (exactly 0 for all-zero weights), the total weight
    exact where the weights are 0 and 1 and within LOSS_RTOL otherwise,
    the unscaled gradients as K2's (``_grad_check``, with each element's
    terms times its weight), and exactly 0 on zero-weight rows and at NaN
    targets; K1w the same bits twice.  Returns (loss abs error, loss rel
    error, max unscaled gradient error, worst gradient error over its
    tolerance)."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in _loss_inputs(B, G, seed, nan_frac, n_clipped, th_shape, pi_shape))
    w = torch.from_numpy(_weights(B, kind, seed)).to(dev)
    what = (f"{'nb' if pi is None else 'zinb'} K1w/K2w at {(B, G)}, theta {th_shape}, pi "
            f"{pi_shape}, ridge {ridge}, {kind} weights")
    ops = [t.requires_grad_(True) for t in (mu, th, pi) if t is not None]
    if pi is None:
        loss = fl.nb_nll_fused_w(y, mu, th, w)
        again = fl.nb_nll_fused_w(y, mu, th, w)
    else:
        loss = fl.zinb_nll_fused_w(y, mu, th, pi, w, ridge)
        again = fl.zinb_nll_fused_w(y, mu, th, pi, w, ridge)
    g = torch.tensor(G_BWD, device=dev)
    grads = torch.autograd.grad(loss, ops, g)
    _, denom = fl._fwd_kernel(y, mu, th, pi, ridge, w)
    _check(torch.equal(loss, again), f"{what}: K1w is not deterministic")
    with torch.no_grad():
        ref, rdenom = fl._fwd_reference(y, mu, th, pi, ridge, w)
        scale = g / rdenom
        refs = fl._bwd_reference(y, mu, th, pi, ridge, g, rdenom, w)
        w_eff = torch.where(torch.isnan(y), 0.0, w)  # what each element weighs
        fulls = [g * w_eff for g in fl._elem_grads(y, mu, th, pi, ridge) if g is not None]
        mags = [m * w_eff for m in fl.grad_term_magnitudes(y, mu, th, pi, ridge)
                if m is not None]
    _check(np.isfinite(loss.item()), f"{what}: loss not finite")
    if kind == "zero":
        _check(loss.item() == 0.0 and denom.item() == 1.0 and ref.item() == 0.0,
               f"{what}: loss {loss.item()!r}, total weight {denom.item()!r}, expected 0 and 1")
        fwd_abs = fwd_rel = 0.0
    else:
        fwd_abs = abs(loss.item() - ref.item())
        fwd_rel = fwd_abs / abs(ref.item())
        _check(fwd_rel <= LOSS_RTOL, f"{what}: loss {loss.item()!r} vs plain {ref.item()!r}, "
               f"relative error {fwd_rel:.3e} > {LOSS_RTOL}")
        if kind == "padding":
            _check(torch.equal(denom, rdenom),
                   f"{what}: total weight {denom.item()} vs plain {rdenom.item()}")
        else:
            _check(abs(denom.item() - rdenom.item()) <= LOSS_RTOL * rdenom.item(),
                   f"{what}: total weight {denom.item()} vs plain {rdenom.item()}")
    zero = (w_eff == 0.0).expand(B, G)
    e_abs = e_tol = 0.0
    for gname, got, want, full, mag in zip(("d mu", "d theta", "d pi"), grads, refs, fulls,
                                           mags):
        if got.shape == (B, G):
            _check(bool((got[zero] == 0.0).all()),
                   f"{what}: {gname} not exactly 0 on zero-weight rows or NaN targets")
        a, t = _grad_check(f"{what}: {gname}", got, want, full.expand(B, G),
                           mag.expand(B, G), scale)
        e_abs, e_tol = max(e_abs, a), max(e_tol, t)
    return fwd_abs, fwd_rel, e_abs, e_tol


def phase_weighted_compare(dev):
    """K1w/K2w against their plain versions at every shape of
    WEIGHTED_SHAPES, every theta/pi case of ``_compare_cases`` and every
    kind of weights."""
    worst = {k: {"fwd_abs": 0.0, "fwd_rel": 0.0, "bwd_abs": 0.0, "bwd_tol": 0.0}
             for k in ("nb", "zinb")}
    n = 0
    for s_i, ((B, G), nan_frac, n_clipped) in enumerate(WEIGHTED_SHAPES):
        for case, (th_shape, pi_shape, ridge) in enumerate(_compare_cases(B, G)):
            for k_i, kind in enumerate(WEIGHT_KINDS):
                r = check_weighted_case(dev, B, G, nan_frac, n_clipped, th_shape, pi_shape,
                                        ridge, kind, 3000 + 100 * s_i + 10 * case + k_i)
                w = worst["nb" if pi_shape is None else "zinb"]
                for key, v in zip(("fwd_abs", "fwd_rel", "bwd_abs", "bwd_tol"), r):
                    w[key] = max(w[key], v)
                n += 1
        print(f"phase 1: K1w/K2w at {(B, G)}: {len(_compare_cases(B, G)) * len(WEIGHT_KINDS)} "
              "NB/ZINB cases agree")
    for fam, w in worst.items():
        print(f"phase 1: weighted {fam}: worst K1w loss error {w['fwd_abs']:.3e} abs, "
              f"{w['fwd_rel']:.3e} rel; worst K2w unscaled gradient error {w['bwd_abs']:.3e} "
              f"abs, {w['bwd_tol']:.3f} of its tolerance ({n} cases in all); zero-weight rows "
              "and NaN targets exactly 0")
    return worst


ALL_ACTS = ("mean", "disp", "sigmoid", "relu", "selu", "elu", "tanh", "linear")
# name, (rows, K, N), BN, epilogues, size factors, checked again in bf16
# mode; the plan (fused_dense.plan) takes K <= 64 through the whole-K tiling
# and longer K through split-K
DENSE_CASES = [
    ("encoder", (2730, 3451, 64), True, ("relu",), False, True),  # split-K, 6 splits
    ("heads", (2730, 64, 3451), False, ("mean", "disp", "sigmoid"), False, True),  # whole K
    ("decoder", (2730, 32, 64), True, ("relu",), False, False),
    ("decoder rows 64", (64, 32, 64), True, ("relu",), False, False),
    ("ragged", (33, 200, 70), True, ALL_ACTS, True, True),  # 7 splits of one step
    ("long K", (16, 1500, 96), True, ("relu",), False, False),
    # the last step of the last slice 8 deep (1000 = 31 x 32 + 8), 8 splits
    ("ragged last slice", (33, 1000, 70), True, ("linear",), True, False),
    # 3 steps in 3 splits, the last 1 deep; and K shorter than one step
    ("K 65", (100, 65, 64), False, ("relu",), False, False),
    ("K 20", (40, 20, 300), True, ALL_ACTS, True, False),
    ("head N 200", (300, 64, 200), False, ("mean",), True, True),  # N not a multiple of 128
]


def dense_inputs(B, K, N, seed, bn=True, sf=False, nonneg=False):
    """x, W, b, (moving_mean, moving_var, beta) or None, sf or None as the
    denoise path gives them: z-scaled inputs (or relu outputs with
    ``nonneg``), Glorot-sized weights, moving statistics of O(1)."""
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, K)).astype(np.float32)
    if nonneg:
        x = np.abs(x)
    w = (rs.normal(size=(K, N)) * np.sqrt(2.0 / (K + N))).astype(np.float32)
    b = (rs.normal(size=(N,)) * 0.1).astype(np.float32)
    stats = None
    if bn:
        stats = ((rs.normal(size=(N,)) * 0.1).astype(np.float32),
                 rs.uniform(0.5, 2.0, size=(N,)).astype(np.float32),
                 (rs.normal(size=(N,)) * 0.1).astype(np.float32))
    sfv = rs.uniform(0.5, 2.0, size=(B,)).astype(np.float32) if sf else None
    return x, w, b, stats, sfv


def _on(dev, arrays):
    """The numpy arrays (or tuples of them, or None) as tensors on ``dev``."""
    import torch

    return [None if a is None else tuple(_on(dev, a)) if isinstance(a, tuple)
            else torch.from_numpy(a).to(dev) for a in arrays]


def _ulps(v, n=4):
    """n float32 ulps at |v|, elementwise."""
    import torch

    a = v.abs()
    return n * (torch.nextafter(a, torch.full_like(a, float("inf"))) - a)


def check_dense_case(dev, name, shape, bn, acts, with_sf, seed, bf16=False):
    """Hold K4 against its plain version on one case (see the module
    docstring's tolerances).  Returns (max abs error of the activated
    outputs against the whole plain version, the worst error over its
    tolerance)."""
    import torch

    from dca_tpu_torch.ops import fused_dense as fd

    B, K, N = shape
    what = f"K4 {name} {shape}{' bf16' if bf16 else ''}"
    x, w, b, stats, sf = _on(dev, dense_inputs(B, K, N, seed, bn, with_sf,
                                               nonneg=name == "heads"))
    prev = os.environ.get("DCA_TPU_MATMUL")
    os.environ["DCA_TPU_MATMUL"] = "bf16" if bf16 else "f32"
    try:
        lin = fd.fused_dense_block(x, w, b, bn=stats, activation="linear")
        want_lin = fd.fused_dense_reference(x, w, b, bn=stats, activation="linear")
        xr, wr = (x.bfloat16().float(), w.bfloat16().float()) if bf16 else (x, w)
        tol = 2 * K * 2.0 ** -24 * (xr.abs() @ wr.abs() + b.abs())
        if stats is not None:
            tol = tol * fd.fold_bn(stats)[0].abs()
        tol = tol + _ulps(want_lin)
        err = (lin - want_lin).abs()
        _check(bool(torch.isfinite(lin).all()), f"{what}: linear output not finite")
        _check(torch.equal(fd.fused_dense_block(x, w, b, bn=stats, activation="linear"), lin),
               f"{what}: two runs gave other bits")
        _check(bool((err <= tol).all()),
               f"{what}: linear output off by {err.max().item():.3e}, "
               f"{(err / tol).max().item():.3f} of its tolerance")
        worst = (err / tol).max().item()
        max_err = err.max().item()
        sfc = 1.0 if sf is None else sf.reshape(-1, 1)
        for act in acts:
            got = fd.fused_dense_block(x, w, b, bn=stats, activation=act, size_factors=sf)
            want = fd.EPILOGUES[act](lin) * sfc
            nan = torch.isnan(want)
            _check(torch.equal(torch.isnan(got), nan), f"{what} {act}: NaN where the plain "
                   "activation of the linear output has none, or the reverse")
            e = (got - want).abs()[~nan]
            t = _ulps(want)[~nan]
            _check(bool((e <= t).all()), f"{what} {act}: {int((e > t).sum())} outputs more "
                   f"than 4 ulps from the plain activation of the kernel's linear output")
            if act in ("relu", "elu", "linear"):
                # identity where positive: the pre-activation is the same bits
                pos = lin > 0
                _check(torch.equal(got[pos], (lin * sfc)[pos] if sf is not None else lin[pos]),
                       f"{what} {act}: pre-activation bits differ from the linear epilogue's")
            full = fd.fused_dense_reference(x, w, b, bn=stats, activation=act, size_factors=sf)
            max_err = max(max_err, (got - full).abs()[~nan].max().item())
        # a NaN in one row of x: that row NaN under every epilogue, the other
        # rows' bits unchanged
        xn = x.clone()
        xn[3, 10] = float("nan")
        for act in acts:
            clean = fd.fused_dense_block(x, w, b, bn=stats, activation=act, size_factors=sf)
            got = fd.fused_dense_block(xn, w, b, bn=stats, activation=act, size_factors=sf)
            _check(bool(torch.isnan(got[3]).all()), f"{what} {act}: NaN row not NaN")
            rest = torch.arange(B, device=dev) != 3
            _check(torch.equal(got[rest], clean[rest]),
                   f"{what} {act}: a NaN in row 3 changed other rows")
    finally:
        if prev is None:
            os.environ.pop("DCA_TPU_MATMUL", None)
        else:
            os.environ["DCA_TPU_MATMUL"] = prev
    return max_err, worst


def _plan_text(B, K, N):
    """K4's plan on the card at (B, K) @ (K, N), in words."""
    import torch

    from dca_tpu_torch.ops import fused_dense as fd

    p = fd.device_plan(B, K, N, torch.device("cuda"))
    if p.kind == fd.WIDE:
        return f"whole K in shared memory, {p.bm} x {p.bn} tiles"
    return f"split-K, {p.bm} x {p.bn} tiles, {p.splits} splits a cluster"


def phase_dense_compare(dev):
    """K4 against its plain version at every case of DENSE_CASES."""
    max_err = worst = 0.0
    n = 0
    for seed, (name, shape, bn, acts, with_sf, also_bf16) in enumerate(DENSE_CASES):
        for bf16 in (False, True) if also_bf16 else (False,):
            e, r = check_dense_case(dev, name, shape, bn, acts, with_sf, 500 + seed, bf16)
            max_err, worst = max(max_err, e), max(worst, r)
            n += 1
            print(f"phase 1: K4 {name} {shape}{' bf16' if bf16 else ''}, BN {bn}, sf "
                  f"{with_sf}, {', '.join(acts)}, {_plan_text(*shape)}: agrees (max abs "
                  f"error {e:.3e}, linear {r:.3f} of its tolerance; the same bits twice, for "
                  "every epilogue, and beside a NaN row)")
    print(f"phase 1: K4: {n} cases agree; worst linear error {worst:.3f} of its tolerance, "
          f"max abs error against the whole plain version {max_err:.3e}")
    return max_err


K4_TIMED = [  # name, (rows, K, N), BN, epilogue: the denoise path's layers
    ("encoder", (2730, 3451, 64), True, "relu"),
    ("encoder", (2730, 3451, 64), False, "linear"),
    ("head", (2730, 64, 3451), False, "mean"),
    ("head", (2730, 64, 3451), False, "disp"),
    ("head", (2730, 64, 3451), False, "sigmoid"),
    ("head", (2730, 64, 3451), False, "linear"),
]


def dense_timings(dev):
    """K4, its plain version and (linear, no BN) torch.addmm at the denoise
    path's shapes; {(name, activation): (ms, plain ms, bound ms, bound by,
    library ms or None, plan)}.  K4 and addmm are timed in turns, K4,
    addmm, addmm, K4, each a median of graph replays, and each time is the
    mean of its two medians.  The replays run back to back on the same
    inputs, so x (37.7 MB at the encoder, the heads' output as large) stays
    warm in the 50 MB L2 for K4 and addmm alike; the denoise path meets x
    fresh from its upload."""
    import torch

    from dca_tpu_torch.ops import fused_dense as fd

    print("phase 2: K4 and addmm are graph replays on the same inputs: x stays warm in the "
          "50 MB L2 for both")
    out = {}
    for i, (name, (B, K, N), bn, act) in enumerate(K4_TIMED):
        x, w, b, stats, _ = _on(dev, dense_inputs(B, K, N, 700 + i, bn, nonneg=name == "head"))

        def kernel():
            return fd._kernel(x, w, b, stats, act, None)

        plain_ms = _device_ms(lambda: fd.fused_dense_reference(x, w, b, bn=stats,
                                                               activation=act))
        lib_ms = None
        if act == "linear" and not bn:
            k1 = _device_ms(kernel)
            l1 = _device_ms(lambda: torch.addmm(b, x, w))
            l2 = _device_ms(lambda: torch.addmm(b, x, w))
            k2 = _device_ms(kernel)
            ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
            turns = (f" (in turns: K4 {k1 * 1e3:.2f}, addmm {l1 * 1e3:.2f}, "
                     f"{l2 * 1e3:.2f}, K4 {k2 * 1e3:.2f} us)")
        else:
            ms = _device_ms(kernel)
            turns = ""
        bound, by, n_bytes, n_ops = k4_bound(B, K, N, bn, act)
        plan = fd.device_plan(B, K, N, dev)
        out[(name, act)] = (ms, plain_ms, bound, by, lib_ms, plan)
        lib = "no single PyTorch call" if lib_ms is None else f"addmm {lib_ms * 1e3:.2f} us"
        print(f"phase 2: K4 {name} ({B}, {K}) x ({K}, {N}), BN {bn}, {act}, "
              f"{_plan_text(B, K, N)}: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
              f"{lib}; bound {bound * 1e3:.2f} us by {by}: {n_bytes / 1e6:.1f} MB, "
              f"{n_ops / 1e9:.3f} GFLOP){turns}")
    return out


# K5: the updates each comparison runs, the odd leaf sizes, the gradients
# that test clamp's edges (clip 5)
RMSPROP_STEPS = 20
RMSPROP_ODD = ((1,), (3,), (3451,), (1725,), (862,), (64, 3451), (32, 1725))
RMSPROP_SPECIALS = (np.inf, -np.inf, np.nan, 5.0, -5.0, np.nextafter(np.float32(5), np.inf),
                    -np.nextafter(np.float32(5), np.inf), 1e30, -1e30, 0.0, -0.0)
RMSPROP_CASES = [
    ("nb-conddisp leaves", "nb-conddisp", "fresh", False, 5.0, "tensor"),
    ("zinb-conddisp leaves", "zinb-conddisp", "fresh", False, 5.0, "tensor"),
    ("nb-conddisp leaves, flat views", "nb-conddisp", "flat", False, 5.0, "tensor"),
    ("odd sizes", "odd", "fresh", False, 5.0, "float"),
    ("odd sizes, flat views", "odd", "flat", False, 5.0, "tensor"),
    ("edge gradients", "odd", "flat", True, 5.0, "tensor"),
    ("edge gradients, no clip", "odd", "fresh", True, None, "float"),
]


def rmsprop_shapes(leaves, genes=3451):
    """The parameters' shapes of ``leaves``: a configuration's network
    (64-32-64 at ``genes``) or ``"odd"`` (``RMSPROP_ODD``)."""
    from dca_tpu_torch.models.network import get_ae_type

    if leaves == "odd":
        return list(RMSPROP_ODD)
    net = get_ae_type(leaves)(input_size=genes, hidden_size=(64, 32, 64), device="cpu").build()
    return [tuple(p.shape) for p in net.model.parameters()]


def _placed_leaves(dev, arrays, flat_offset=None):
    """Float32 tensors on ``dev`` of ``arrays``: each its own allocation,
    or with ``flat_offset`` contiguous views one after another into one
    flat buffer from that many floats in, as the gradients of a flat
    all-reduce are (misaligned where an offset is not a multiple of 4)."""
    import torch

    if flat_offset is None:
        return [torch.from_numpy(a).to(dev) for a in arrays]
    flat = torch.zeros(flat_offset + sum(a.size for a in arrays), device=dev)
    out, off = [], flat_offset
    for a in arrays:
        out.append(flat[off:off + a.size].view(a.shape))
        out[-1].copy_(torch.from_numpy(a))
        off += a.size
    return out


def _rmsprop_grads(rs, shapes, specials):
    """Gradients of ``shapes``, a fifth of them past the clip value 5;
    with ``specials`` each leaf holds ``RMSPROP_SPECIALS`` at random
    places too."""
    grads = [(rs.normal(size=s) * 4.0).astype(np.float32) for s in shapes]
    if specials:
        vals = np.array(RMSPROP_SPECIALS, np.float32)
        for g in grads:
            flat = g.reshape(-1)
            k = min(flat.size, vals.size)
            flat[rs.choice(flat.size, size=k, replace=False)] = vals[:k]
    return grads


def check_rmsprop_case(dev, leaves, layout, specials, clip, lr_kind, seed=0,
                       steps=RMSPROP_STEPS):
    """K5 (``fused_optim.rmsprop``) and the plain loop
    (``optim._rmsprop_loop``) on ``dev`` from the same parameters and
    accumulators, ``steps`` updates on the same gradients, the rate (a 0-d
    tensor rewritten in place, or a float) cut tenfold halfway: the same
    bits after every update, NaN included, or SmokeFailure.  ``layout``
    "flat": the gradients views into one flat buffer at an odd offset, the
    parameters and accumulators into others.  Returns the elements a
    side."""
    import torch

    from dca_tpu_torch.ops import fused_optim
    from dca_tpu_torch.train import optim

    shapes = rmsprop_shapes(leaves)
    rs = np.random.RandomState(seed)
    p0 = [rs.normal(size=s).astype(np.float32) for s in shapes]
    a0 = [rs.uniform(0.0, 2.0, size=s).astype(np.float32) for s in shapes]
    flat = layout == "flat"
    sides = [(_placed_leaves(dev, p0, 1 if flat else None),
              _placed_leaves(dev, a0, 3 if flat else None)) for _ in range(2)]
    lr = torch.tensor(1e-3, device=dev) if lr_kind == "tensor" else 1e-3
    for step in range(steps):
        if step == steps // 2:
            lr = lr.fill_(1e-4) if torch.is_tensor(lr) else 1e-4
        g = _placed_leaves(dev, _rmsprop_grads(rs, shapes, specials), 2 if flat else None)
        with torch.no_grad():
            fused_optim.rmsprop(sides[0][0], g, sides[0][1], lr, clip)
            optim._rmsprop_loop(sides[1][0], g, sides[1][1], lr, clip, 0.9, 1e-7)
        for i, (k, want) in enumerate(zip(sides[0][0] + sides[0][1], sides[1][0] + sides[1][1])):
            what = "parameter" if i < len(shapes) else "accumulator"
            if not bits_equal(k, want):
                bad = (k.view(torch.int32) != want.view(torch.int32)).nonzero()[:3].tolist()
                raise SmokeFailure(
                    f"K5 ({leaves}, {layout}, clip {clip}, lr {lr_kind}): {what} "
                    f"{i % len(shapes)} {tuple(k.shape)} differs from the plain loop after "
                    f"update {step + 1} at {bad}: {k.view(-1)[:4].tolist()} against "
                    f"{want.view(-1)[:4].tolist()}")
    return sum(int(np.prod(s)) for s in shapes)


def bits_equal(a, b):
    """The same float32 bits, NaN included, where ``torch.equal`` calls
    two NaNs unequal."""
    import torch

    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.int32),
                                              b.reshape(-1).view(torch.int32))


def rmsprop_bound_ms(n_elements):
    """K5's least time: p, g and a read and p and a written once, 20
    bytes an element; a dozen operations an element take far less."""
    return _bound_ms(20 * n_elements, 12 * n_elements)


def phase_optim(dev):
    """K5 against the plain loop (``RMSPROP_CASES``), then its time at both
    configurations' leaves: replays of a graph of one update (the 13.5 /
    18.0 MB stay in the 50 MB L2 from replay to replay), and the same with
    a 128 MB buffer written between updates, against the plain loop's
    replays and the bound.  Returns {name: entry}."""
    import torch

    from dca_tpu_torch.ops import fused_optim
    from dca_tpu_torch.train import optim

    n_checked = 0
    for name, leaves, layout, specials, clip, lr_kind in RMSPROP_CASES:
        n = check_rmsprop_case(dev, leaves, layout, specials, clip, lr_kind,
                               seed=len(name))
        n_checked += n
        print(f"phase 1: K5 {name}: the plain loop's bits after each of {RMSPROP_STEPS} "
              f"updates ({n} elements)")
    out = {"cases": len(RMSPROP_CASES), "elements": n_checked}
    flush = torch.empty(32 << 20, device=dev)  # 128 MB, past the L2
    for leaves in ("nb-conddisp", "zinb-conddisp"):
        shapes = rmsprop_shapes(leaves)
        rs = np.random.RandomState(7)
        params = _placed_leaves(dev, [rs.normal(size=s).astype(np.float32) for s in shapes])
        accs = _placed_leaves(dev, [np.zeros(s, np.float32) for s in shapes])
        grads = _placed_leaves(dev, _rmsprop_grads(rs, shapes, False))
        lr = torch.tensor(1e-3, device=dev)
        n = sum(p.numel() for p in params)

        def kernel():
            fused_optim.rmsprop(params, grads, accs, lr, 5.0)

        def plain():
            optim._rmsprop_loop(params, grads, accs, lr, 5.0, 0.9, 1e-7)

        def cold():
            flush.fill_(1.0)
            kernel()

        with torch.no_grad():
            k1, p1, p2, k2 = (_device_ms(kernel), _device_ms(plain), _device_ms(plain),
                              _device_ms(kernel))
            fill = _device_ms(lambda: flush.fill_(1.0))
            cold_ms = _device_ms(cold) - fill
        bound, by = rmsprop_bound_ms(n)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        out[leaves] = {"leaves": len(shapes), "elements": n, "ms": ms, "plain_ms": plain_ms,
                       "cold_ms": cold_ms, "bound_ms": bound, "bound_by": by,
                       "roofline_pct": 100 * bound / ms, "cold_roofline_pct": 100 * bound / cold_ms}
        print(f"phase 2: K5 {leaves} ({len(shapes)} leaves, {n} elements): {ms * 1e3:.2f} us "
              f"warm (in turns {k1 * 1e3:.2f}, {k2 * 1e3:.2f}), {cold_ms * 1e3:.2f} us after a "
              f"128 MB write (its {fill * 1e3:.2f} us taken off); plain loop "
              f"{plain_ms * 1e3:.2f} us ({p1 * 1e3:.2f}, {p2 * 1e3:.2f}); bound "
              f"{bound * 1e3:.2f} us by {by} ({20 * n / 1e6:.2f} MB)")
    return out


def load_parent(path, name="dca_parent"):
    """``dca_tpu_torch/ops/fused_loss.py`` of another checkout of the repo
    at ``path`` (an earlier commit, unpacked), imported as the package
    ``name`` beside this checkout's, so that the two are timed in one
    process on the same inputs; its kernels build into its own tree."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(path), "dca_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.fused_loss")


def backward_ctx(y, mu, th, pi, w, ridge, denom):
    """What ``_FusedNLL.forward`` saves, so that its backward, one whole
    loss backward, can be called (and graph-captured) alone."""
    return types.SimpleNamespace(saved_tensors=(y, mu, th, pi, w, denom), ridge=ridge)


def phase_timings(dev, parent=None):
    """K1 and K2 at the step shape, NB and ZINB, and one whole loss
    backward (``_FusedNLL.backward``: K2 and whatever its wrapper
    launches); with ``parent`` (``load_parent``), the parent's whole
    backward too, in turns with this one: parent, change, change, parent."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    B, G = 32, 3451
    n = B * G
    g = torch.tensor(G_BWD, device=dev)
    out = {}
    for fam, seed in (("nb", 11), ("zinb", 13)):
        y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                         for a in _loss_inputs(B, G, seed,
                                               pi_shape=(B, G) if fam == "zinb" else None))
        yv, muv, thv, piv = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(273, G, seed + 1,
                                                   pi_shape=(273, G) if fam == "zinb" else None))
        with_pi = pi is not None
        n_in = 4 if with_pi else 3  # y, mu, theta and pi, each read once
        _, denom = fl._fwd_kernel(y, mu, th, pi, 0.1)
        k1_ms = _device_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1))
        k1_plain_ms = _device_ms(lambda: fl._fwd_reference(y, mu, th, pi, 0.1))
        k2_ms = _device_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom))
        k2_plain_ms = _device_ms(lambda: fl._bwd_reference(y, mu, th, pi, 0.1, g, denom))
        ctx = backward_ctx(y, mu, th, pi, None, 0.1, denom)
        back = [lambda: fl._FusedNLL.backward(ctx, g)]
        if parent is not None:
            back = [lambda: parent._FusedNLL.backward(ctx, g)] + back * 2 + \
                [lambda: parent._FusedNLL.backward(ctx, g)]
        turns = [_device_ms(fn) for fn in back]
        back_ms = float(np.mean(turns[1:3] if parent is not None else turns))
        parent_back_ms = None if parent is None else (turns[0] + turns[3]) / 2
        # K1 on the validation split, once per epoch on the main path
        k1_val_ms = _device_ms(lambda: fl._fwd_kernel(yv, muv, thv, piv, 0.1))
        # each input read once, each output written once: K1's sum, count,
        # loss and denominator; K2 also reads g and the denominator and
        # writes 2 or 3 (B, G) gradients
        k1_bound, k1_by = _bound_ms(n_in * 4 * n + 4 * 4, _k1_ops(y, mu, th, with_pi))
        k2_bound, k2_by = _bound_ms(n_in * 4 * n + 2 * 4 + (n_in - 1) * 4 * n,
                                    _k2_ops(y, mu, th, with_pi))
        k1_val_bound, _ = _bound_ms(n_in * 4 * yv.numel() + 4 * 4,
                                    _k1_ops(yv, muv, thv, with_pi))
        vs_parent = "" if parent is None else (
            f", the parent's (its division, then its K2) {parent_back_ms * 1e3:.2f} us (in "
            f"turns: parent {turns[0] * 1e3:.2f}, change {turns[1] * 1e3:.2f}, "
            f"{turns[2] * 1e3:.2f}, parent {turns[3] * 1e3:.2f} us)")
        print(f"phase 2: {fam} K1 {k1_ms * 1e3:.2f} us, one launch, loss and denominator "
              f"included (plain "
              f"{k1_plain_ms * 1e3:.2f} us, bound {k1_bound * 1e3:.2f} us by {k1_by}); "
              f"K2 {k2_ms * 1e3:.2f} us (plain {k2_plain_ms * 1e3:.2f} us, bound "
              f"{k2_bound * 1e3:.2f} us by {k2_by}); one whole loss backward "
              f"{back_ms * 1e3:.2f} us{vs_parent}; K1 at (273, {G}) "
              f"{k1_val_ms * 1e3:.2f} us (bound {k1_val_bound * 1e3:.2f} us); no single "
              "PyTorch call computes either function")
        out[f"{fam}_fwd"] = (k1_ms, k1_plain_ms, k1_bound, k1_by,
                             {"val_ms": k1_val_ms, "val_bound_ms": k1_val_bound})
        out[f"{fam}_bwd"] = (k2_ms, k2_plain_ms, k2_bound, k2_by,
                             {"whole_backward_ms": back_ms,
                              "parent_whole_backward_ms": parent_back_ms})
    return out


def weighted_timings(dev):
    """K1w at the validation block of one of 2 ranks (137, 3451) and K2w at
    the training batch (32, 3451), NB and ZINB, padding weights, with the
    plain versions' times and the bounds; {name: (ms, plain ms, bound ms,
    bound by, extra)}."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    G = 3451
    out = {}
    for fam, seed in (("nb", 21), ("zinb", 23)):
        with_pi = fam == "zinb"
        n_in = 4 if with_pi else 3  # y, mu, theta and pi, each read once
        for kind, B in (("fwd", 137), ("bwd", 32)):
            n = B * G
            y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(B, G, seed, pi_shape=(B, G) if with_pi
                                                   else None))
            w = torch.from_numpy(_weights(B, "padding", seed)).to(dev)
            if kind == "fwd":
                ms = _device_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1, w))
                plain_ms = _device_ms(lambda: fl._fwd_reference(y, mu, th, pi, 0.1, w))
                # the inputs and the weight column read once, the sum, the
                # total weight, the loss and the denominator written; one
                # more multiply per element
                bound, by = _bound_ms(n_in * 4 * n + 4 * B + 4 * 4,
                                      _k1_ops(y, mu, th, with_pi) + n)
            else:
                g = torch.tensor(G_BWD, device=dev)
                _, denom = fl._fwd_kernel(y, mu, th, pi, 0.1, w)
                ms = _device_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom, w))
                plain_ms = _device_ms(
                    lambda: fl._bwd_reference(y, mu, th, pi, 0.1, g, denom, w))
                # also g and the denominator read and 2 or 3 (B, G)
                # gradients written; w * scale once more per element
                bound, by = _bound_ms(n_in * 4 * n + 4 * B + 2 * 4 + (n_in - 1) * 4 * n,
                                      _k2_ops(y, mu, th, with_pi) + n)
            out[f"{fam}_{kind}_w"] = (ms, plain_ms, bound, by, {"timed_shape": [B, G]})
            print(f"phase 2: {fam} K{1 if kind == 'fwd' else 2}w at {(B, G)}: "
                  f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} "
                  f"us by {by}); no single PyTorch call computes it")
    return out


def mp_shard_timings(dev):
    """K1 and K2, NB and ZINB, at a rank's (rows, gene shard) of the
    model-parallel step, (32, 1725) on 1 x 2 and (32, 862) on 1 x 4, and
    K1w/K2w at a 2 x 2 grid's validation block (137, 1724), padding
    weights, with the plain versions' times and the bounds; {(name,
    shape): (ms, plain ms, bound ms, bound by)}."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    g = torch.tensor(G_BWD, device=dev)
    out = {}
    for fam, seed in (("nb", 41), ("zinb", 43)):
        with_pi = fam == "zinb"
        n_in = 4 if with_pi else 3  # y, mu, theta and pi, each read once
        for B, G, weighted in ((32, 1725, False), (32, 862, False), (137, 1724, True)):
            n = B * G
            y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(B, G, seed + G, pi_shape=(B, G) if with_pi
                                                   else None))
            w = torch.from_numpy(_weights(B, "padding", seed)).to(dev) if weighted else None
            _, denom = fl._fwd_kernel(y, mu, th, pi, 0.1, w)
            extra_in, extra_ops = (4 * B, n) if weighted else (0, 0)
            # as phase_timings and weighted_timings count them
            times = {
                "fwd": (lambda: fl._fwd_kernel(y, mu, th, pi, 0.1, w),
                        lambda: fl._fwd_reference(y, mu, th, pi, 0.1, w),
                        _bound_ms(n_in * 4 * n + extra_in + 4 * 4,
                                  _k1_ops(y, mu, th, with_pi) + extra_ops)),
                "bwd": (lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom, w),
                        lambda: fl._bwd_reference(y, mu, th, pi, 0.1, g, denom, w),
                        _bound_ms(n_in * 4 * n + extra_in + 2 * 4 + (n_in - 1) * 4 * n,
                                  _k2_ops(y, mu, th, with_pi) + extra_ops)),
            }
            for kind, (kernel, plain, (bound, by)) in times.items():
                ms, plain_ms = _device_ms(kernel), _device_ms(plain)
                name = f"{fam}_nll_{kind}{'_w' if weighted else ''}"
                out[(name, (B, G))] = (ms, plain_ms, bound, by)
                print(f"phase 2: {name} at a model-parallel shard {(B, G)}: {ms * 1e3:.2f} us "
                      f"(plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us by {by})")
    return out


def tb_k2_timings(dev):
    """ZINB K2 at phase 4's validation split (273, 3451) and K2w at a rank's
    padded validation block of phase 7 (137, 3451), the shapes of the
    TensorBoard gradient, with the plain versions' times and the bounds;
    {name: (ms, plain ms, bound ms, bound by)}."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    G = 3451
    g = torch.tensor(G_BWD, device=dev)
    out = {}
    for name, B, weighted in (("zinb_bwd", 273, False), ("zinb_bwd_w", 137, True)):
        y, mu, th, pi = (torch.from_numpy(a).to(dev)
                         for a in _loss_inputs(B, G, 31 + B, pi_shape=(B, G)))
        w = torch.from_numpy(_weights(B, "padding", B)).to(dev) if weighted else None
        _, denom = fl._fwd_kernel(y, mu, th, pi, 0.1, w)
        ms = _device_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom, w))
        plain_ms = _device_ms(lambda: fl._bwd_reference(y, mu, th, pi, 0.1, g, denom, w))
        # y, mu, theta, pi (and w) read, g and the denominator read, three
        # (B, G) gradients written; w * scale once more an element
        n = B * G
        bound, by = _bound_ms(4 * 4 * n + (4 * B if weighted else 0) + 2 * 4 + 3 * 4 * n,
                              _k2_ops(y, mu, th, True) + (n if weighted else 0))
        out[name] = (ms, plain_ms, bound, by)
        print(f"phase 2: zinb K2{'w' if weighted else ''} at {(B, G)} (the TensorBoard "
              f"gradient's shape): {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.2f} us by {by})")
    return out


def _small_counts(n_cells, n_genes, seed):
    rs = np.random.RandomState(seed)
    mu = rs.gamma(2.0, 1.0, size=(1, n_genes)) * rs.lognormal(0.0, 0.3, (n_cells, 1)) * 5
    counts = rs.negative_binomial(2.0, 2.0 / (2.0 + mu)).astype(np.float32)
    counts[rs.uniform(size=counts.shape) < 0.3] = 0.0
    counts[0, :] += 1
    counts[:, 0] += 1
    return counts


LAUNCH_NAMES = [f"{fam}_nll_{kind}{w}" for fam in ("nb", "zinb") for kind in ("fwd", "bwd")
                for w in ("", "_w")]


def _want_launches(likelihood, epochs, steps, warmups=0):
    """What train() on one device launches: per epoch one K1 per step and
    one for the validation split, one K2 per step (train/loop.py), of the
    likelihood's kernel family, and no weighted kernel; normal and poisson
    launch none.  ``warmups``: the steps the CUDA-graph path runs eagerly
    before capturing (one for each captured step, train/graphs.py), real
    launches that move nothing of the fit."""
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    if likelihood in ("nb", "zinb"):
        want[f"{likelihood}_nll_fwd"] = epochs * (steps + 1) + warmups
        want[f"{likelihood}_nll_bwd"] = epochs * steps + warmups
    return want


def _steps(n_cells, batch=32, val_split=0.1):
    n_full, rem = divmod(int(n_cells * (1.0 - val_split)), batch)
    return n_full + (rem > 0)


def _warmups(n_cells, batch=32, val_split=0.1):
    """The graph path's warm-up steps: one for each of the full and the
    trailing step that the split has."""
    n_full, rem = divmod(int(n_cells * (1.0 - val_split)), batch)
    return (n_full > 0) + (rem > 0)


ZOO = ["normal", "poisson", "nb", "nb-conddisp", "nb-shared", "nb-fork", "zinb",
       "zinb-conddisp", "zinb-shared", "zinb-fork", "zinb-elempi", "zinb-elempi/sharedpi"]


def phase_zoo():
    """Every architecture: a small fit on the CPU (the kernels' plain
    versions, the eager loop) and on the card (the kernels, the steps
    replayed from CUDA graphs) from the same weights."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models import core
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    epochs, n_cells = 2, 200
    for arch in ZOO:
        name, _, variant = arch.partition("/")
        kw = {"sharedpi": True} if variant == "sharedpi" else {}
        hist = {}
        state = None
        for dev in ("cpu", "cuda"):
            adata = io.normalize(io.read_dataset(AnnData(_small_counts(n_cells, 60, 3))))
            net = AE_types[name](input_size=60, hidden_size=(16, 8, 16), ridge=0.05,
                                 device=dev, **kw).build()
            if state is None:
                state = {k: v.clone() for k, v in net.model.state_dict().items()}
            else:
                net.model.load_state_dict(state)
            fl.reset_launches()
            fit = train(adata, net, epochs=epochs, verbose=False)
            hist[dev] = fit.history
        _check(fit.capture_s is not None, f"zoo {arch}: the card fit replayed no graph")
        launches = dict(fl.launches)
        want = _want_launches(core.LIKELIHOODS[name], epochs, _steps(n_cells),
                              _warmups(n_cells))
        _check(launches == want, f"zoo {arch}: launches {launches}, expected {want}")
        for key in ("loss", "val_loss"):
            _check(np.allclose(hist["cuda"][key], hist["cpu"][key], rtol=1e-3, atol=0.0),
                   f"zoo {arch}: {key} on the card {hist['cuda'][key]} vs the CPU "
                   f"{hist['cpu'][key]}, beyond rtol 1e-3")
        print(f"phase 3: zoo {arch}: card loss {hist['cuda']['loss']} vs CPU "
              f"{hist['cpu']['loss']}; launches {launches}")


def phase_api(ae_type, epochs, tensorboard=False):
    """``dca()`` of ``ae_type`` at 2730 x 3451, ``epochs`` epochs, through
    the CUDA-graph path (the main path), then the same fit eagerly on the
    card (``training_kwds={"_graphs": False}``); the two histories must be
    equal within rtol 1e-6, and each run's launches exact.  With
    ``tensorboard`` a third run through the graphs logs to TensorBoard
    (``_tb_run``).  Returns (the graph run's launches, the trained network,
    its loss history, whether the two histories are the same bits, the
    TensorBoard run's histograms and launches or None)."""
    import torch

    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models import core
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.ops import fused_optim

    counts = make_paul15_like()
    n_cells, n_genes = counts.shape
    kw = dict(ae_type=ae_type, hidden_size=(64, 32, 64), batch_size=32, copy=True,
              return_info=True)
    if core.LIKELIHOODS[ae_type] == "zinb":
        lat = dca_tpu_torch.dca(AnnData(counts.copy()), mode="latent", epochs=1, **kw)
        _check(lat.obsm["X_dca"].shape == (n_cells, 32),
               f"X_dca has shape {lat.obsm['X_dca'].shape}, not {(n_cells, 32)}")
        _check(bool(np.isfinite(lat.obsm["X_dca"]).all()), "X_dca is not finite")

    steps = _steps(n_cells)
    runs = {}
    for graphs in (True, False):
        fl.reset_launches()
        fused_optim.reset_launches()
        t0 = time.perf_counter()
        ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), epochs=epochs, verbose=graphs,
                                     return_model=True, training_kwds={"_graphs": graphs}, **kw)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = dict(fl.launches)
        path = "graph" if graphs else "eager"

        hist = ret.uns["dca_loss_history"]
        _check(len(hist["loss"]) == epochs, f"ran {len(hist['loss'])} epochs, not {epochs}")
        _check(np.all(np.isfinite(hist["loss"])) and np.all(np.isfinite(hist["val_loss"])),
               f"loss history not finite: {hist}")
        outputs = [("X", ret.X), ("X_dca_dispersion", ret.obsm["X_dca_dispersion"])]
        if core.LIKELIHOODS[ae_type] == "zinb":
            outputs.append(("X_dca_dropout", ret.obsm["X_dca_dropout"]))
        for name, arr in outputs:
            _check(arr.shape == (n_cells, n_genes),
                   f"{ae_type} {name} has shape {arr.shape}, not {(n_cells, n_genes)}")
            _check(bool(np.isfinite(arr).all()), f"{ae_type} {name} is not finite")
        want = _want_launches(core.LIKELIHOODS[ae_type], epochs, steps,
                              _warmups(n_cells) if graphs else 0)
        _check(launches == want,
               f"{ae_type} ({path}): kernel launches {launches}, expected {want}")
        # RMSprop, dca()'s optimizer: K5 once a step and once a warm-up step
        launches["rmsprop"] = fused_optim.launches["rmsprop"]
        want_k5 = want[f"{core.LIKELIHOODS[ae_type]}_nll_bwd"]
        _check(launches["rmsprop"] == want_k5,
               f"{ae_type} ({path}): K5 launches {launches['rmsprop']}, expected {want_k5}")
        print(f"phase 4: dca() {ae_type} {n_cells} x {n_genes} ({path}), {epochs} epochs in "
              f"{t_run:.3f} s, {steps} steps each; launches {launches}")
        runs[graphs] = (launches, net, hist)

    graph_hist, eager_hist = runs[True][2], runs[False][2]
    for key in ("loss", "val_loss"):
        _check(np.allclose(graph_hist[key], eager_hist[key], rtol=1e-6, atol=0.0),
               f"{ae_type}: {key} of the graph fit {graph_hist[key]} vs the eager fit "
               f"{eager_hist[key]}, beyond rtol 1e-6")
    _check(graph_hist["lr"] == eager_hist["lr"], f"{ae_type}: lr histories differ")
    same_bits = all(graph_hist[k] == eager_hist[k] for k in ("loss", "val_loss"))
    print(f"phase 4: {ae_type} graph fit against the eager fit: within rtol 1e-6; "
          f"{'the same bits' if same_bits else 'not the same bits'}: loss "
          f"{graph_hist['loss']} vs {eager_hist['loss']}")
    launches, net, hist = runs[True]
    tb = None
    if tensorboard:
        tb = _tb_run(ae_type, counts, epochs, kw, graph_hist)
    return launches, net, hist, same_bits, tb


TB_STATS = ("min", "max", "num", "sum", "sum_squares")


def _tb_events(out, epochs, paths, val=True):
    """The one event file under ``out/tb``: every scalar (loss, val_loss,
    lr) and every histogram (weights/ and grads/ of each parameter path of
    ``paths``) at every epoch.  Returns {(step, tag): histogram
    statistics}."""
    import glob

    from dca_tpu_torch.tbevents import read_events, read_histograms

    files = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    _check(len(files) == 1, f"{len(files)} event files under {out}/tb, expected 1")
    scalars = {(st, t) for st, d in read_events(files[0]) for t, v in d.items()
               if v != "histogram"}
    hists = read_histograms(files[0])
    names = ("loss", "lr") + (("val_loss",) if val else ())
    for step in range(epochs):
        missing = [t for t in names if (step, t) not in scalars]
        missing += [pre + p for p in paths for pre in ("weights/", "grads/")
                    if (step, pre + p) not in hists]
        _check(not missing, f"{out}: epoch {step} lacks {missing}")
    return hists


def _tb_run(ae_type, counts, epochs, kw, graph_hist):
    """``dca()`` of phase 4 through the graphs with ``tensorboard=True``:
    the history the plain graph fit's bits, every tag at every epoch, a
    profiler trace beside the events, and one more K1 and K2 an epoch
    (the gradient on the 273 validation rows, eager)."""
    import glob

    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models import core
    from dca_tpu_torch.ops import fused_loss as fl

    out = os.path.join(OUT_DIR, f"tb-{ae_type}")
    shutil.rmtree(out, ignore_errors=True)
    fl.reset_launches()
    ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), epochs=epochs, return_model=True,
                                 training_kwds={"output_dir": out, "tensorboard": True}, **kw)
    launches = dict(fl.launches)
    hist = ret.uns["dca_loss_history"]
    _check(hist == graph_hist, f"phase 4: {ae_type}: the TensorBoard fit's history {hist} is "
                               f"not the plain graph fit's {graph_hist}")
    lk = core.LIKELIHOODS[ae_type]
    want = _want_launches(lk, epochs, _steps(counts.shape[0]), _warmups(counts.shape[0]))
    want[f"{lk}_nll_fwd"] += epochs
    want[f"{lk}_nll_bwd"] += epochs
    _check(launches == want, f"phase 4: {ae_type} TensorBoard fit: launches {launches}, "
                             f"expected {want}")
    paths = [n.replace(".", "/") for n, _ in net.model.named_parameters()]
    hists = _tb_events(out, epochs, paths)
    _check(bool(glob.glob(os.path.join(out, "tb", "*.pt.trace.json"))),
           f"phase 4: no profiler trace under {out}/tb")
    print(f"phase 4: {ae_type} TensorBoard fit ({epochs} epochs, graphs): the plain fit's "
          f"bits; every tag at every epoch ({len(hists)} histograms); launches {launches}")
    return {"launches": launches, "histograms": hists}


IN_TURNS = (False, True, True, False, False, True)  # A, B, B, A, A, B: two ways timed in turns


def epoch_timings(ae_type="zinb-conddisp", epochs=3):
    """The per-epoch wall time of ``train()`` on the 2730 x 3451 matrix,
    64-32-64, batch 32, eager and from CUDA graphs, three fits each, in
    turns (``IN_TURNS``), each fit from the same initial weights;
    the epoch time of a fit is the mean of its epochs' walls
    (``History.epoch_s``: steps, validation and the losses' read-back),
    and a graph fit's capture time (warm-up and capture, before its first
    epoch) is printed apart.  Returns {"eager": [ms, ...], "graph": [ms,
    ...], "capture": [s, ...]}."""
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train.loop import train

    adata = _prepped_paul15()
    out = {"eager": [], "graph": [], "capture": []}
    for graphs in IN_TURNS:
        net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                   device="cuda").build()
        hist = train(adata, net, epochs=epochs, verbose=False, _graphs=graphs)
        ms = float(np.mean(hist.epoch_s)) * 1e3
        out["graph" if graphs else "eager"].append(ms)
        if graphs:
            out["capture"].append(hist.capture_s)
        print(f"phase 4: {ae_type} {'graph' if graphs else 'eager'} fit: epochs "
              f"{[round(t * 1e3, 2) for t in hist.epoch_s]} ms, mean {ms:.2f} ms"
              + (f"; capture {hist.capture_s * 1e3:.1f} ms" if graphs else ""))
    _check(np.median(out["graph"]) < np.median(out["eager"]),
           f"the graph epoch ({out['graph']} ms) is not faster than the eager one "
           f"({out['eager']} ms)")
    return out


def _prepped_paul15():
    """The 2730 x 3451 matrix preprocessed as dca() preprocesses it."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    return io.normalize(io.read_dataset(AnnData(make_paul15_like())),
                        filter_min_counts=False)


def _forward_tolerance(net, x, sf):
    """Elementwise bound on |forward with K4 - forward without| for a
    network of dense relu layers and dense heads (zinb-conddisp): each
    product of K terms is off by at most 2 K 2^-24 (|x| @ |W| + |b|) on the
    two paths together, the error carried in from the layer before goes
    through |W|, the BN scale multiplies both, each elementwise step adds
    4 ulps; relu passes the error on, MeanAct multiplies it by
    mean (e^dz - 1), DispAct's softplus by at most 1, sigmoid by 1/4, and
    the output is mean times sf.  Returns {output key: tolerance}."""
    import torch

    from dca_tpu_torch.models import core

    u = 2.0 ** -24
    d, m = net.definition, net.model
    with torch.no_grad():
        h = torch.tensor(np.asarray(x, np.float32), device=net.device)
        sfc = torch.tensor(sf, device=net.device).reshape(-1, 1)
        err = torch.zeros_like(h)
        tol, val = {}, {}
        for layer in d.shared:
            p = m.trunk[layer.name]
            aw = p.kernel.abs()
            z = h @ p.kernel + p.bias
            dz = err @ aw + 2 * p.kernel.shape[0] * u * (h.abs() @ aw + p.bias.abs())
            if layer.name == "center":
                tol["latent"] = dz + _ulps(z)
            if layer.batchnorm:
                s = torch.rsqrt(p.moving_var + core.BN_EPS)
                dz = dz * s + _ulps(z * s) + _ulps(p.moving_mean * s) + _ulps(p.bn_beta)
                z = (z - p.moving_mean) * s + p.bn_beta
            h, err = torch.relu(z), dz
        for head, key in (("mean", "mean_norm"), ("dispersion", "disp"), ("pi", "pi")):
            p = m.heads[head]
            aw = p.kernel.abs()
            z = h @ p.kernel + p.bias
            dz = err @ aw + 2 * p.kernel.shape[0] * u * (h.abs() @ aw + p.bias.abs()) + _ulps(z)
            v = val[key] = core._HEAD_ACTS[d.heads[head].activation](z)
            gain = {"mean": v * torch.expm1(dz), "disp": dz, "sigmoid": 0.25 * dz}
            tol[key] = gain[d.heads[head].activation] + _ulps(v)
        tol["output"] = tol["mean_norm"] * sfc + _ulps(val["mean_norm"] * sfc)
    return {k: t.cpu().numpy() for k, t in tol.items()}


@contextlib.contextmanager
def _counting(module, name):
    """Counts the calls of ``module.name`` while the block runs: yields
    [calls, calls that returned something other than None]."""
    real = getattr(module, name)
    counts = [0, 0]

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        counts[0] += 1
        counts[1] += out is not None
        return out

    setattr(module, name, counted)
    try:
        yield counts
    finally:
        setattr(module, name, real)


def _rss_bytes():
    """This process's resident memory (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _pinned_fetch(net, x, sf):
    """The forward's outputs on the card fetched as the main path fetches
    them, through the page-locked ring (``network.fetch_to_host``), and by
    pageable copies (``.cpu()``): the same bits, in pageable arrays; both
    fetches timed in turns (pageable, ring, ring, pageable, pageable,
    ring)."""
    import torch

    from dca_tpu_torch.models.network import fetch_to_host

    with torch.no_grad():
        out, _ = net.apply(torch.tensor(x, device=net.device),
                           torch.tensor(sf, device=net.device))
    out = {k: v for k, v in out.items() if v is not None}
    fetched = fetch_to_host(out)
    pageable = {k: v.cpu().numpy() for k, v in out.items()}
    for k, v in pageable.items():
        _check(fetched[k].dtype == v.dtype == np.float32 and fetched[k].shape == v.shape
               and np.array_equal(fetched[k].view(np.uint32), v.view(np.uint32)),
               f"fetch: {k} fetched through page-locked memory differs from the pageable copy")
        _check(not torch.from_numpy(fetched[k]).is_pinned(),
               f"fetch: {k} handed out in page-locked memory")
    del fetched, pageable
    secs = {True: [], False: []}
    for ring in IN_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if ring:
            fetch_to_host(out)
        else:
            {k: v.cpu().numpy() for k, v in out.items()}
        secs[ring].append(time.perf_counter() - t0)
    n_bytes = sum(v.numel() * v.element_size() for v in out.values())
    res = {"fetch_pinned_s": float(np.median(secs[True])),
           "fetch_pageable_s": float(np.median(secs[False])),
           "fetch_bytes": n_bytes, "fetch_copies": len(out),
           "fetch_threads": torch.get_num_threads()}
    print(f"phase 6: fetch of the forward's {len(out)} outputs ({n_bytes / 1e6:.1f} MB): "
          f"through the page-locked ring the same bits as pageable; ring "
          f"{res['fetch_pinned_s'] * 1e3:.2f} ms ({[round(t * 1e3, 2) for t in secs[True]]}), "
          f"pageable {res['fetch_pageable_s'] * 1e3:.2f} ms "
          f"({[round(t * 1e3, 2) for t in secs[False]]}), in turns; {res['fetch_threads']} "
          "torch threads")
    return res


def _pinned_memory(net, rows=32768, n_blocks=2):
    """The host memory of the pipelined block forward at its largest block,
    ``rows`` rows (the most ``_auto_chunk_rows`` gives), over ``n_blocks``
    blocks of random input, each block's arrays dropped once read, as the
    streaming writer drops them: torch's host allocator holds no more
    page-locked bytes at the peak and after than before (the fetch ring,
    made at the first fetch); and the resident memory at each block against
    before."""
    import torch

    from dca_tpu_torch.models import network

    x = np.random.default_rng(7).random((rows * n_blocks, net.input_size),
                                        dtype=np.float32)
    sf = np.ones((rows * n_blocks,), np.float32)
    torch.cuda.reset_peak_host_memory_stats()
    base = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    ring_bytes = sum(c.numel() for c in network._ring(network.FETCH_CHUNK_BYTES))
    rss0 = _rss_bytes()
    rss_peak, block_bytes = rss0, 0
    t0 = time.perf_counter()
    for lo, hi, out in net.iter_forward_blocks(x, sf, chunk_rows=rows):
        arrays = [a for a in out.values() if a is not None]
        _check(all(np.isfinite(a).all() and not torch.from_numpy(a).is_pinned()
                   for a in arrays), f"block forward [{lo}, {hi}): outputs not finite "
               "or page-locked")
        block_bytes = max(block_bytes, sum(a.nbytes for a in arrays))
        rss_peak = max(rss_peak, _rss_bytes())
        del out, arrays
    secs = time.perf_counter() - t0
    stats = torch.cuda.host_memory_stats()
    res = {"pin_rows": rows, "pin_blocks": n_blocks, "pin_s": secs,
           "pin_block_bytes": block_bytes, "pin_ring_bytes": ring_bytes,
           "pin_base_bytes": base, "pin_peak_bytes": stats["allocated_bytes.peak"],
           "pin_after_bytes": stats["allocated_bytes.current"],
           "pin_rss_before_bytes": rss0, "pin_rss_peak_bytes": rss_peak,
           "pin_input_bytes": x.nbytes}
    _check(res["pin_peak_bytes"] == res["pin_after_bytes"] == base,
           f"block forward at {rows} rows: {res['pin_peak_bytes']} bytes page-locked at the "
           f"peak and {res['pin_after_bytes']} after, {base} before")
    print(f"phase 6: block forward over {n_blocks} blocks of {rows} x {net.input_size} in "
          f"{secs:.2f} s: page-locked {base / 2**20:.1f} MiB before, at the peak and after "
          f"(the ring {ring_bytes / 2**20:.1f} MiB; one block's outputs "
          f"{block_bytes / 2**20:.1f} MiB); resident {rss0 / 2**20:.1f} MiB before, "
          f"{rss_peak / 2**20:.1f} MiB at the peak block (input {x.nbytes / 2**20:.1f} MiB)")
    return res


def phase_denoise(zinb_net, nb_net):
    """The denoise tier at 2730 x 3451 (module docstring, phase 6)."""
    import pandas as pd
    import torch

    from dca_tpu_torch.data import io
    from dca_tpu_torch.ops import fused_dense as fd

    from dca_tpu_torch import native

    saved = {k: os.environ.get(k) for k in ("DCA_TPU_FUSED_DENSE", "DCA_TPU_WRITE_ALIASES",
                                            "DCA_TPU_NO_NATIVE")}
    res = {}
    try:
        adata = _prepped_paul15()
        x, sf = adata.X, io.size_factors(adata)
        n_cells, n_genes = x.shape
        outs = {}
        for mode in ("0", "1"):
            os.environ["DCA_TPU_FUSED_DENSE"] = mode
            zinb_net.forward(x, sf)  # warm-up
            torch.cuda.synchronize()
            fd.reset_launches()
            outs[mode] = zinb_net.forward(x, sf)  # the main path: counted
            res[f"forward_launches_{mode}"] = fd.launches["fused_dense"]
            res["forward_wide"], res["forward_splitk"] = fd.launches["wide"], fd.launches["splitk"]
        secs = {"0": [], "1": []}
        for k4 in IN_TURNS:  # off, on, on, off, off, on
            mode = "1" if k4 else "0"
            os.environ["DCA_TPU_FUSED_DENSE"] = mode
            t0 = time.perf_counter()
            zinb_net.forward(x, sf)
            secs[mode].append(time.perf_counter() - t0)
        for mode, t in secs.items():
            res[f"forward_s_{mode}"] = float(np.median(t))
            res[f"forward_all_s_{mode}"] = t
        _check(res["forward_launches_0"] == 0 and res["forward_launches_1"] == 4
               and (res["forward_splitk"], res["forward_wide"]) == (1, 3),
               f"forward: K4 launches {res['forward_launches_0']} with the switch off "
               f"and {res['forward_launches_1']} on ({res['forward_splitk']} split-K, "
               f"{res['forward_wide']} whole-K), expected 0 and 4 (the encoder split-K; "
               "the mean, dispersion and pi heads whole-K)")
        os.environ["DCA_TPU_FUSED_DENSE"] = "0"  # the default path
        res.update(_pinned_fetch(zinb_net, x, sf))
        res.update(_pinned_memory(zinb_net))
        tol = _forward_tolerance(zinb_net, x, sf)
        worst = 0.0
        for key, t in tol.items():
            on, off = outs["1"][key], outs["0"][key]
            _check(on.shape == off.shape and bool(np.isfinite(on).all()),
                   f"forward with K4: {key} of shape {on.shape} or not finite")
            err = np.abs(on - off)
            _check(bool((err <= t).all()), f"forward with K4: {key} off by {err.max():.3e}, "
                   f"{(err / t).max():.3f} of the propagated tolerance")
            worst = max(worst, float((err / t).max()))
        res["forward_worst"] = worst
        print(f"phase 6: forward zinb-conddisp {n_cells} x {n_genes}, outputs fetched through "
              f"the page-locked ring: K4 off {res['forward_s_0'] * 1e3:.1f} ms, on "
              f"{res['forward_s_1'] * 1e3:.1f} ms (median of 3, each run "
              f"{IN_TURNS.count(True)} times in turns with the other); K4 launches "
              f"{res['forward_launches_1']}; outputs agree, worst {worst:.3f} of the "
              "propagated tolerance")

        # the streaming write, in 3 blocks of at most 1024 rows, with K4,
        # formatted by the native tier (the main path), then by pandas
        os.environ["DCA_TPU_FUSED_DENSE"] = "1"
        os.environ["DCA_TPU_WRITE_ALIASES"] = "0"
        out_dir = os.path.join(OUT_DIR, "stream")
        pandas_dir = os.path.join(OUT_DIR, "stream_pandas")
        for d in (out_dir, pandas_dir):
            shutil.rmtree(d, ignore_errors=True)
        ad = _prepped_paul15()
        fd.reset_launches()
        with _counting(native, "format_matrix") as formats:
            t0 = time.perf_counter()
            zinb_net.write_streaming(ad, out_dir, mode="full", return_info=True,
                                     chunk_rows=1024)
            res["stream_s"] = time.perf_counter() - t0
        res["stream_launches"] = fd.launches["fused_dense"]
        res["stream_wide"], res["stream_splitk"] = fd.launches["wide"], fd.launches["splitk"]
        _check(formats[0] > 0 and formats[1] == formats[0],
               f"write_streaming: {formats[1]} of {formats[0]} block formats went through "
               "the native tier")
        os.environ["DCA_TPU_NO_NATIVE"] = "1"
        t0 = time.perf_counter()
        zinb_net.write_streaming(_prepped_paul15(), pandas_dir, mode="full", return_info=True,
                                 chunk_rows=1024)
        res["stream_pandas_s"] = time.perf_counter() - t0
        os.environ.pop("DCA_TPU_NO_NATIVE")
        for fname in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, fname), "rb") as a, \
                    open(os.path.join(pandas_dir, fname), "rb") as b:
                _check(a.read() == b.read(),
                       f"write_streaming {fname}: the native and the pandas bytes differ")
        _check(sorted(os.listdir(out_dir)) == sorted(os.listdir(pandas_dir)),
               "write_streaming: the native and the pandas runs wrote other files")
        shutil.rmtree(pandas_dir)
        print(f"phase 6: write_streaming native {res['stream_s']:.2f} s ({formats[1]} block "
              f"formats through the native tier), pandas {res['stream_pandas_s']:.2f} s; "
              "the same bytes in every file")
        _check(res["stream_launches"] == 12
               and (res["stream_splitk"], res["stream_wide"]) == (3, 9),
               f"write_streaming: K4 launches {res['stream_launches']} "
               f"({res['stream_splitk']} split-K), expected 12 (3 blocks x encoder, mean, "
               "dispersion, pi; 3 split-K)")
        files = [("mean.tsv", 0, (n_genes, n_cells)), ("dispersion.tsv", None, (n_genes, n_cells)),
                 ("dropout.tsv", None, (n_genes, n_cells)), ("latent.tsv", None, (n_cells, 32))]
        _check(sorted(os.listdir(out_dir)) == sorted(f for f, _, _ in files),
               f"write_streaming wrote {sorted(os.listdir(out_dir))}")
        for fname, header, shape in files:
            df = pd.read_csv(os.path.join(out_dir, fname), sep="\t", index_col=0, header=header)
            _check(df.shape == shape and bool(np.isfinite(df.to_numpy()).all()),
                   f"write_streaming {fname}: shape {df.shape}, expected {shape}, or not finite")
        # the first genes of mean.tsv: the in-memory output of the same
        # blocks, printed to 6 decimals
        ref = zinb_net.forward(x, sf, chunk_rows=1024, keys=("output",))["output"]
        with open(os.path.join(out_dir, "mean.tsv")) as f:
            f.readline()
            for g in range(5):
                fields = f.readline().rstrip("\n").split("\t")
                _check(fields[0] == ad.var_names[g]
                       and fields[1:] == ["%.6f" % v for v in ref[:, g]],
                       f"mean.tsv gene {g} differs from the in-memory output")
        print(f"phase 6: write_streaming zinb-conddisp full, 3 blocks of <= 1024 rows, "
              f"no aliases: {res['stream_s']:.2f} s; K4 launches {res['stream_launches']}; "
              f"{', '.join(f for f, _, _ in files)} of the right shapes, finite, and the "
              "first 5 genes of mean.tsv equal to the in-memory output to 6 decimals")
        shutil.rmtree(out_dir)

        # nb-conddisp predict: the denoise, then the dispersion from it
        os.environ["DCA_TPU_FUSED_DENSE"] = "1"
        ad = _prepped_paul15()
        fd.reset_launches()
        nb_net.predict(ad, mode="denoise", return_info=True)
        res["nb_predict_launches"] = fd.launches["fused_dense"]
        res["nb_predict_wide"] = fd.launches["wide"]
        res["nb_predict_splitk"] = fd.launches["splitk"]
        _check(res["nb_predict_launches"] == 4 and res["nb_predict_splitk"] == 2,
               f"nb-conddisp predict: K4 launches {res['nb_predict_launches']}, expected 4 "
               "(encoder and mean head, then encoder and dispersion head)")
        for name, arr in (("X", ad.X), ("X_dca_dispersion", ad.obsm["X_dca_dispersion"])):
            _check(arr.shape == (n_cells, n_genes) and bool(np.isfinite(arr).all()),
                   f"nb-conddisp predict {name}: shape {arr.shape} or not finite")
        print(f"phase 6: nb-conddisp predict(return_info=True) with K4: launches "
              f"{res['nb_predict_launches']}, outputs finite")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return res


def phase_cli():
    import pandas as pd

    work = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counts = _small_counts(300, 120, 5)  # cells x genes
    tsv = os.path.join(work, "counts.tsv")
    pd.DataFrame(counts.T.astype(int), index=[f"gene{i}" for i in range(120)],
                 columns=[f"cell{i}" for i in range(300)]).to_csv(tsv, sep="\t")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the last run goes through the streaming write, with K4
    stream_env = {"DCA_TPU_HOST_DENSE_BYTES": "1", "DCA_TPU_FUSED_DENSE": "1"}
    for ae_type, label, extra in (("nb-conddisp", "nb-conddisp", {}),
                                  ("zinb-conddisp", "zinb-conddisp", {}),
                                  ("zinb", "zinb", {}),
                                  ("zinb-conddisp", "zinb-conddisp-stream", stream_env)):
        out = os.path.join(work, label)
        proc = subprocess.run([sys.executable, "-m", "dca_tpu_torch", tsv, out, "-e", "2",
                               "--type", ae_type],
                              cwd=REPO, env=dict(env, **extra), capture_output=True,
                              text=True, timeout=600)
        _check(proc.returncode == 0, f"CLI {label} exited {proc.returncode}:\n"
               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        _check(("[streaming]" in proc.stdout) == bool(extra),
               f"CLI {label}: the streaming write ran where it should not, or the reverse")
        files = [("mean.tsv", 0, (120, 300)), ("mean_norm.tsv", 0, (120, 300)),
                 ("dispersion.tsv", None, (120, 1 if ae_type == "zinb" else 300)),
                 ("latent.tsv", None, (300, 32)), ("reduced.tsv", None, (300, 32))]
        if ae_type != "nb-conddisp":
            files += [("dropout.tsv", None, (120, 300)), ("pi.tsv", None, (120, 300))]
        for fname, header, shape in files:
            df = pd.read_csv(os.path.join(out, fname), sep="\t", index_col=0, header=header)
            _check(df.shape == shape, f"CLI {label} {fname} has shape {df.shape}, "
                   f"not {shape}")
            _check(bool(np.isfinite(df.to_numpy()).all()),
                   f"CLI {label} {fname} is not finite")
        _check(os.path.exists(os.path.join(out, "model.pickle")),
               f"CLI {label}: no model.pickle")
        print(f"phase 5: CLI {label}{' ' + str(extra) if extra else ''} on the card wrote "
              f"{', '.join(f for f, _, _ in files)} and model.pickle, all finite")
    shutil.rmtree(work)


def phase_native():
    """Phase 8: the native IO tier on the card machine, at 2730 x 3451.  It
    must build there (``native.available()``); the CLI's read of the gene
    x cell count TSV (``io.read_text``) through it and through pandas
    (DCA_TPU_NO_NATIVE=1) gives the same matrix and names, and the %.6f
    format of a (3451, 2730) float matrix with row and column names the
    same bytes as pandas ``to_csv``; each timed once, native first."""
    import io

    import pandas as pd

    from dca_tpu_torch import native
    from dca_tpu_torch.data.io import read_text

    _check(native.available(), "the native IO tier did not build or load (g++ -fopenmp)")
    work = os.path.join(OUT_DIR, "native")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counts = make_paul15_like()
    n_cells, n_genes = counts.shape
    genes = [f"gene{i}" for i in range(n_genes)]
    cells = [f"cell{i}" for i in range(n_cells)]
    tsv = os.path.join(work, "counts.tsv")
    pd.DataFrame(counts.T.astype(int), index=genes, columns=cells).to_csv(tsv, sep="\t")
    res = {"threads": native.n_threads()}
    reads = {}
    for mode in ("native", "pandas"):
        if mode == "pandas":
            os.environ["DCA_TPU_NO_NATIVE"] = "1"
        try:
            t0 = time.perf_counter()
            reads[mode] = read_text(tsv)
            res[f"read_{mode}_s"] = time.perf_counter() - t0
        finally:
            os.environ.pop("DCA_TPU_NO_NATIVE", None)
    a, b = reads["native"], reads["pandas"]
    _check(np.array_equal(a.X, b.X) and a.X.dtype == b.X.dtype == np.float32
           and a.X.shape == (n_genes, n_cells) and np.array_equal(a.X, counts.T),
           "read_text: the native and the pandas matrices differ")
    _check(list(a.obs_names) == list(b.obs_names) == genes
           and list(a.var_names) == list(b.var_names) == cells,
           "read_text: the native and the pandas names differ")
    values = np.random.RandomState(8).lognormal(0.0, 2.0, (n_genes, n_cells)).astype(np.float32)
    t0 = time.perf_counter()
    got = native.format_matrix(values, rownames=genes, colnames=cells)
    res["format_native_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf = io.StringIO()
    pd.DataFrame(values, index=genes, columns=cells).to_csv(buf, sep="\t",
                                                            float_format="%.6f")
    want = buf.getvalue().encode()
    res["format_pandas_s"] = time.perf_counter() - t0
    _check(got == want, "format_matrix: the native bytes differ from pandas to_csv")
    res["format_bytes"] = len(got)
    shutil.rmtree(work)
    print(f"phase 8: native IO tier built ({res['threads']} OpenMP threads); read_text of the "
          f"{n_genes} x {n_cells} count TSV: native {res['read_native_s']:.3f} s, pandas "
          f"{res['read_pandas_s']:.3f} s, the same matrix and names; %.6f format of a "
          f"{n_genes} x {n_cells} float matrix ({len(got) / 1e6:.1f} MB): native "
          f"{res['format_native_s']:.3f} s, pandas {res['format_pandas_s']:.3f} s, the same "
          "bytes")
    return res


OPTIMIZERS = ("SGD", "RMSprop", "Adam", "Adamax", "Nadam", "Adagrad", "Adadelta")
# (optimizer, hidden activation) of the options phase
OPTIONS = tuple((name, "relu") for name in OPTIMIZERS) + (("RMSprop", "PReLU"),
                                                          ("Adam", "PReLU"))
STEP_COUNTED = ("Adam", "Adamax", "Nadam")  # the optimizers with a step count t


@contextlib.contextmanager
def _optimizer_states():
    """Yields a list that receives the state of every optimizer ``train()``
    creates while the block runs (the step count ``t`` is read from it)."""
    from dca_tpu_torch.train import loop

    real = loop.get_optimizer
    states = []

    def recording(name, clipvalue=None):
        opt = real(name, clipvalue=clipvalue)

        def init(params):
            states.append(opt.init(params))
            return states[-1]

        return opt._replace(init=init)

    loop.get_optimizer = recording
    try:
        yield states
    finally:
        loop.get_optimizer = real


def options_fit(optimizer, activation, device, graphs=True, state=None, n_cells=200,
                n_genes=60, epochs=2, dropout=0.0):
    """A zinb-conddisp (16, 8, 16) fit of ``n_cells`` x ``n_genes`` with
    ``optimizer`` and hidden ``activation``, from ``state`` (the initial
    weights of the first fit when None).  Returns (history, the loss
    kernels' launches, the optimizer state after the fit, the initial
    weights)."""
    import torch

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    adata = io.normalize(io.read_dataset(AnnData(_small_counts(n_cells, n_genes, 3))))
    net = get_ae_type("zinb-conddisp")(input_size=n_genes, hidden_size=(16, 8, 16),
                                       ridge=0.05, activation=activation,
                                       hidden_dropout=dropout, device=device).build()
    if state is None:
        state = {k: v.detach().cpu().clone() for k, v in net.model.state_dict().items()}
    net.model.load_state_dict(state)
    fl.reset_launches()
    with _optimizer_states() as states:
        hist = train(adata, net, optimizer=optimizer, epochs=epochs, verbose=False,
                     _graphs=graphs)
    if device != "cpu":
        torch.cuda.synchronize()
    return hist, dict(fl.launches), states[0], state


def phase_options(n_cells=200, epochs=2):
    """Phase 9: each of the seven optimizers, and PReLU with RMSprop and with
    Adam, in a small zinb-conddisp fit on the CPU (the eager loop, the
    kernels' plain versions), on the card through the CUDA graphs and on the
    card eagerly, from the same weights: graph and eager histories the same
    bits; the step count of Adam, Adamax and Nadam after the fit the steps
    taken (the graph warm-up's two steps restored); the K1/K2 launches exact,
    warm-ups included; the card within rtol 1e-3 of the CPU, as phase 3
    holds the zoo."""
    steps, warmups = _steps(n_cells), _warmups(n_cells)
    for optimizer, activation in OPTIONS:
        cpu, _, _, state = options_fit(optimizer, activation, "cpu", epochs=epochs)
        graph, graph_launches, graph_opt, _ = options_fit(optimizer, activation, "cuda", True,
                                                          state, epochs=epochs)
        eager, eager_launches, eager_opt, _ = options_fit(optimizer, activation, "cuda",
                                                          False, state, epochs=epochs)
        label = f"{optimizer} {activation}"
        _check(graph.capture_s is not None and eager.capture_s is None,
               f"options {label}: the card fit replayed no graph, or the eager one did")
        for key in ("loss", "val_loss", "lr"):
            _check(graph.history[key] == eager.history[key],
                   f"options {label}: {key} of the graph fit {graph.history[key]} is not the "
                   f"eager fit's {eager.history[key]} bit for bit")
        for key in ("loss", "val_loss"):
            _check(np.allclose(graph.history[key], cpu.history[key], rtol=1e-3, atol=0.0),
                   f"options {label}: {key} on the card {graph.history[key]} vs the CPU "
                   f"{cpu.history[key]}, beyond rtol 1e-3")
        if optimizer in STEP_COUNTED:
            for path, opt_state in (("graph", graph_opt), ("eager", eager_opt)):
                _check(int(opt_state["t"]) == epochs * steps,
                       f"options {label} ({path}): step count {int(opt_state['t'])} after "
                       f"the fit, {epochs * steps} steps taken")
        _check(eager_launches == _want_launches("zinb", epochs, steps),
               f"options {label} (eager): launches {eager_launches}")
        _check(graph_launches == _want_launches("zinb", epochs, steps, warmups),
               f"options {label} (graph): launches {graph_launches}")
        print(f"phase 9: {label}: graph fit the eager fit's bits, loss {graph.history['loss']}"
              f" (CPU {cpu.history['loss']}); K1/K2 launches "
              f"{graph_launches['zinb_nll_fwd']}/{graph_launches['zinb_nll_bwd']}"
              + (f"; t = {int(graph_opt['t'])}" if optimizer in STEP_COUNTED else ""))


def phase_prelu_adam_full(epochs=2):
    """Phase 9 at full width: ``dca()`` zinb-conddisp 64-32-64 with PReLU
    and Adam on the 2730 x 3451 matrix through the CUDA graphs: outputs
    finite and of the right shapes, launches exact, Adam's step count the
    steps taken, and the alphas trained.  Returns the run's launches."""
    import torch

    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.ops import fused_loss as fl

    counts = make_paul15_like()
    n_cells, n_genes = counts.shape
    steps = _steps(n_cells)
    fl.reset_launches()
    t0 = time.perf_counter()
    with _optimizer_states() as states:
        ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), ae_type="zinb-conddisp",
                                     activation="PReLU", optimizer="Adam", epochs=epochs,
                                     hidden_size=(64, 32, 64), batch_size=32, copy=True,
                                     return_info=True, return_model=True, verbose=False)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(fl.launches)
    want = _want_launches("zinb", epochs, steps, _warmups(n_cells))
    _check(launches == want, f"PReLU + Adam dca(): launches {launches}, expected {want}")
    _check(int(states[0]["t"]) == epochs * steps,
           f"PReLU + Adam dca(): step count {int(states[0]['t'])}, {epochs * steps} steps")
    for name, arr in (("X", ret.X), ("X_dca_dispersion", ret.obsm["X_dca_dispersion"]),
                      ("X_dca_dropout", ret.obsm["X_dca_dropout"])):
        _check(arr.shape == (n_cells, n_genes) and bool(np.isfinite(arr).all()),
               f"PReLU + Adam dca(): {name} of shape {arr.shape} or not finite")
    hist = ret.uns["dca_loss_history"]
    _check(len(hist["loss"]) == epochs and np.all(np.isfinite(hist["val_loss"])),
           f"PReLU + Adam dca(): history {hist}")
    alphas = [p for k, p in net.model.named_parameters() if k.endswith("prelu_alpha")]
    _check(len(alphas) == 3 and all(bool((a != 0).any()) for a in alphas),
           "PReLU + Adam dca(): the alphas did not train")
    print(f"phase 9: dca() zinb-conddisp PReLU + Adam {n_cells} x {n_genes}, {epochs} epochs "
          f"through the CUDA graphs in {t_run:.3f} s: loss {hist['loss']}, val_loss "
          f"{hist['val_loss']}; launches {launches['zinb_nll_fwd']}/"
          f"{launches['zinb_nll_bwd']}; t = {int(states[0]['t'])}; outputs finite")
    return launches


def optimizer_epoch_timings(epochs=3):
    """The per-epoch wall time of ``train()`` zinb-conddisp on the 2730 x
    3451 matrix through the CUDA graphs with RMSprop and with Adam, three
    3-epoch fits each, in turns (RMSprop, Adam, Adam, RMSprop, RMSprop,
    Adam), from the same initial weights.  Returns {name: [ms, ...]}."""
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train.loop import train

    adata = _prepped_paul15()
    out = {"RMSprop": [], "Adam": []}
    state = None
    for adam in IN_TURNS:
        name = "Adam" if adam else "RMSprop"
        net = get_ae_type("zinb-conddisp")(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                           device="cuda").build()
        if state is None:
            state = {k: v.clone() for k, v in net.model.state_dict().items()}
        net.model.load_state_dict(state)
        hist = train(adata, net, optimizer=name, epochs=epochs, verbose=False)
        out[name].append(float(np.mean(hist.epoch_s)) * 1e3)
        print(f"phase 9: zinb-conddisp graph fit with {name}: epochs "
              f"{[round(t * 1e3, 2) for t in hist.epoch_s]} ms; capture "
              f"{hist.capture_s * 1e3:.1f} ms")
    return out


DP_RANKS = 2
DP_TIMEOUT = 480  # seconds for both ranks, start-up included
DP_RUNS = (("zinb-conddisp", 2), ("nb-conddisp", 1))
DP_NB_TB_CELLS = 546  # 16 steps (15 full, a trailing 11 rows) and 55 validation rows
# the streamed fit under the group: phase 10 (a)'s, from its weights
DP_STREAM_TIERS = ("host", "padded")
DP_STREAM_EPOCHS = 2
STREAM_MAX_CELLS = 512
STREAM_VAL_RTOL = 1e-2  # the BatchNorm-bias noise (ROADMAP.md, Queue 3)


def _dp_rank(rank, world, port, out_dir, backend):
    """One rank of phase 7, in a process of its own: join the group (gloo
    on the one card, or NCCL with a card a rank), run
    ``dca(devices="all")`` for each of DP_RUNS
    (zinb-conddisp after an untimed warm-up fit and a timed epochs=0 run), save
    the model on rank 0, and leave the history, launches, times and the
    denoised matrix in ``out_dir``."""
    import torch

    sys.path.insert(0, REPO)
    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
    counts = make_paul15_like()
    kw = dict(hidden_size=(64, 32, 64), batch_size=32, copy=True, return_info=True,
              return_model=True, devices="all")
    res = {}
    for ae_type, epochs in DP_RUNS:
        files = os.path.join(out_dir, f"{ae_type}-rank{rank}")
        t_zero = None
        if ae_type == "zinb-conddisp":
            # a warm-up fit first: the collectives' and the libraries' set-up
            # is paid there, not in the epochs=0 run that is subtracted
            dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=1, **kw)
            t0 = time.perf_counter()
            dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=0, **kw)
            torch.cuda.synchronize()
            t_zero = time.perf_counter() - t0
        fl.reset_launches()
        t0 = time.perf_counter()
        ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=epochs,
                                     network_kwds={"file_path": files}, **kw)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = dict(fl.launches)
        net.save()  # with the trained parameters: rank 0 alone writes
        np.save(os.path.join(out_dir, f"denoised-{ae_type}-rank{rank}.npy"), ret.X)
        res[ae_type] = {"history": ret.uns["dca_loss_history"], "launches": launches,
                        "t_run": t_run, "t_zero": t_zero}
        if ae_type == "zinb-conddisp":
            # the same fit logging to TensorBoard: its gradient on the
            # padded validation block goes through K1w/K2w
            fl.reset_launches()
            t0 = time.perf_counter()
            ret, net = dca_tpu_torch.dca(
                AnnData(counts.copy()), ae_type=ae_type, epochs=epochs,
                training_kwds={"output_dir": os.path.join(out_dir, "tb"), "tensorboard": True},
                **kw)
            torch.cuda.synchronize()
            res["tensorboard"] = {"history": ret.uns["dca_loss_history"],
                                  "launches": dict(fl.launches),
                                  "t_run": time.perf_counter() - t0}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{ae_type}-params.npz"),
                         **{k: v.cpu().numpy() for k, v in net.model.state_dict().items()})
    # the whole fit on the device (compiled=True) on a split that divides
    # the ranks: eager under the group, one read of the stop flag an epoch
    fl.reset_launches()
    ret, _ = dca_tpu_torch.dca(AnnData(counts[:DP_COMPILED_CELLS].copy()),
                               ae_type="zinb-conddisp", epochs=2,
                               training_kwds={"compiled": True}, **kw)
    torch.cuda.synchronize()
    res["compiled"] = {"history": ret.uns["dca_loss_history"], "launches": dict(fl.launches)}
    # nb-conddisp logging to TensorBoard, on the first DP_NB_TB_CELLS cells
    # and the genes they express (a traced data-parallel epoch is slow): its
    # gradient on the padded validation block is the NB K2w's launch in a fit
    sub = counts[:DP_NB_TB_CELLS]
    fl.reset_launches()
    ret, _ = dca_tpu_torch.dca(
        AnnData(sub[:, sub.sum(0) > 0].copy()), ae_type="nb-conddisp", epochs=1,
        training_kwds={"output_dir": os.path.join(out_dir, "tb_nb"), "tensorboard": True}, **kw)
    torch.cuda.synchronize()
    res["tensorboard_nb"] = {"history": ret.uns["dca_loss_history"],
                             "launches": dict(fl.launches)}
    state_path = os.path.join(out_dir, "stream_state.npz")
    if os.path.exists(state_path):
        res["stream"] = _dp_stream_fits(rank, out_dir, state_path, counts,
                                        torch.device("cuda"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _dp_stream_fits(rank, out_dir, state_path, counts, dev):
    """Phase 7's streamed fits on this rank, on ``dev``: ``train(devices="all")`` from
    phase 10 (a)'s weights at ``max_device_cells=STREAM_MAX_CELLS`` through
    each of DP_STREAM_TIERS, with a checkpoint an epoch into a directory of
    the rank's (rank 0 alone writes into it); {tier: history, launches,
    epoch times, the streamed epochs printed, the checkpoint files}."""
    import torch

    adata = _lazy_adata(counts)
    state = {k: torch.from_numpy(v) for k, v in np.load(state_path).items()}
    out = {}
    for tier in DP_STREAM_TIERS:
        run_dir = os.path.join(out_dir, f"stream-{tier}-rank{rank}")
        with _switches(STREAM_TIERS[tier]):
            text = StringIO()
            with contextlib.redirect_stdout(text):
                hist, launches, _ = _stream_fit(dev, adata, state, DP_STREAM_EPOCHS,
                                                verbose=True, devices="all",
                                                max_device_cells=STREAM_MAX_CELLS,
                                                output_dir=run_dir, checkpoint_every=1)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        out[tier] = {"history": hist.history, "launches": launches, "epoch_s": hist.epoch_s,
                     "printed": _streamed_epochs(text.getvalue()),
                     "wrote": sorted(os.listdir(os.path.join(run_dir, "checkpoints")))}
    return out


TB_DP_RTOL = 1e-3


def _one_card_grad_stats(state):
    """{grads/<path>: histogram statistics} of the TensorBoard gradient on
    the one card: zinb-conddisp 64-32-64 carrying ``state`` on phase 4's
    273 validation rows, as ``dca()`` preprocesses them."""
    import torch

    from dca_tpu_torch.data.io import densify, size_factors
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train.loop import _tb_grads

    adata = _prepped_paul15()
    split = int(adata.n_obs * 0.9)
    dev = torch.device("cuda")
    net = get_ae_type("zinb-conddisp")(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                       device=dev).build()
    net.model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    x, t = (torch.tensor(densify(a)[split:], device=dev) for a in (adata.X, adata.raw.X))
    sf = torch.tensor(size_factors(adata)[split:], device=dev)
    stats = {}
    for path, g in _tb_grads(net, x, sf, t).items():
        v = g.detach().cpu().numpy().astype(np.float64).ravel()
        v = v[np.isfinite(v)]
        stats["grads/" + path] = dict(zip(TB_STATS, (v.min(), v.max(), float(v.size), v.sum(),
                                                     np.square(v).sum())))
    return stats


def _check_dp_stream(ranks, single, n_ranks, backend):
    """Phase 7's streamed fits (``_dp_stream_fits``) against each other and
    against the one-card streamed fit ``single``; returns their per-rank
    launches and epoch times."""
    out = {"launches": {}, "epoch_s": {}}
    for tier in DP_STREAM_TIERS:
        runs = [r["stream"][tier] for r in ranks]
        hist = runs[0]["history"]
        for rk, run in enumerate(runs):
            want = want_group_stream_launches(DP_STREAM_EPOCHS, 2730, STREAM_MAX_CELLS, n_ranks,
                                              rk, captured=backend == "nccl")
            _check(run["history"] == hist, f"phase 7 streamed {tier}: rank {rk}'s history "
                   f"{run['history']} differs from rank 0's {hist}")
            _check(run["launches"] == want, f"phase 7 streamed {tier}: rank {rk} launched "
                   f"{run['launches']}, expected {want}")
            _check(run["printed"] == (DP_STREAM_EPOCHS if rk == 0 else 0)
                   and bool(run["wrote"]) == (rk == 0), f"phase 7 streamed {tier}: rank {rk} "
                   f"printed {run['printed']} streamed epochs and wrote {run['wrote']}")
        _check(hist == ranks[0]["stream"][DP_STREAM_TIERS[0]]["history"],
               f"phase 7 streamed {tier}: history {hist} is not the "
               f"{DP_STREAM_TIERS[0]} tier's")
        rel = {}
        for key, rtol in (("loss", 1e-3), ("val_loss", STREAM_VAL_RTOL)):
            ref = np.asarray(single["history"][key])
            rel[key] = float(np.max(np.abs(np.asarray(hist[key]) - ref) / np.abs(ref)))
            _check(rel[key] <= rtol, f"phase 7 streamed {tier}: {key} {hist[key]} vs the "
                   f"one-card streamed fit's {ref.tolist()}, relative difference "
                   f"{rel[key]:.3e} > {rtol}")
        out["launches"][tier] = [run["launches"] for run in runs]
        out["epoch_s"][tier] = runs[0]["epoch_s"]
        print(f"phase 7: streamed {tier} zinb-conddisp {DP_STREAM_EPOCHS} epochs, parts of "
              f"{STREAM_MAX_CELLS}, on {n_ranks} ranks over {backend}: loss {hist['loss']}, "
              f"val_loss {hist['val_loss']}, the same on every rank; against the one-card "
              f"streamed fit largest relative differences {rel['loss']:.3e} (loss), "
              f"{rel['val_loss']:.3e} (val_loss); launches {runs[0]['launches']} a rank; "
              f"epochs {[round(t * 1e3, 1) for t in runs[0]['epoch_s']]} ms on rank 0 against "
              f"{[round(t * 1e3, 1) for t in single['epoch_s']]} ms on one card; rank 0 alone "
              "printed and wrote")
    return out


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target, n_ranks, args, timeout, what):
    """Run ``target(rank, n_ranks, port, *args)`` in ``n_ranks`` spawned
    processes (CUDA does not survive fork); a rank that fails or outlives
    ``timeout`` seconds fails ``what``, and none is left running."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, n_ranks, port, *args)) for r in range(n_ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, timeout - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        _check(not hung, f"{what}: ranks {hung} still running after {timeout} s")
        codes = [p.exitcode for p in procs]
        _check(codes == [0] * n_ranks, f"{what}: ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def phase_data_parallel(single_hist, single_tb, n_ranks=DP_RANKS, backend="gloo",
                        val_rtol=1e-3, single_compiled=None, single_stream=None):
    """Phase 7: the data-parallel fit, by default 2 ranks on the one card
    over gloo (module docstring; ``chip_dp.py`` runs it with a card a rank
    over NCCL).  ``single_hist``: phase 4's zinb-conddisp history, which
    the loss must match within rtol 1e-3 and val_loss within
    ``val_rtol``; ``single_tb``: phase 4's TensorBoard histograms, whose
    ``grads/`` statistics (min, max, num, sum, sum of squares) rank 0's
    must match within ``val_rtol`` too; ``single_compiled``: the one-card
    ``compiled=True`` history on the first DP_COMPILED_CELLS cells (phase
    13), which the ranks' compiled fit must match likewise;
    ``single_stream``: phase 10 (a)'s one-card streamed fit (its weights,
    history and epoch times, ``stream_reference``), which the ranks'
    streamed fits start from and must match, the loss within rtol 1e-3 and
    val_loss within STREAM_VAL_RTOL.  Returns each run's per-rank
    launches, the per-epoch times and the gradients' largest relative
    difference."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"phase 7: compute mode {mode!r}; {n_ranks} ranks, backend {backend}")
    out_dir = os.path.join(OUT_DIR, "dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    if single_stream is not None:
        np.savez(os.path.join(out_dir, "stream_state.npz"), **single_stream["state"])
    run_ranks(_dp_rank, n_ranks, (out_dir, backend), DP_TIMEOUT, "phase 7")
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # every rank has rows in every step (the trailing 25 rows split 13/12,
    # or 7/7/7/4 on 4 ranks); 273 validation rows need padding for 2 or 4;
    # over NCCL the steps are captured, after a warm-up of the full and the
    # trailing step
    warm = 2 if backend == "nccl" else 0
    want = {"zinb-conddisp": {"zinb_nll_fwd": 154 + warm, "zinb_nll_bwd": 154 + warm,
                              "zinb_nll_fwd_w": 2},
            "nb-conddisp": {"nb_nll_fwd": 77 + warm, "nb_nll_bwd": 77 + warm,
                            "nb_nll_fwd_w": 1}}
    out = {}
    for ae_type, epochs in DP_RUNS:
        runs = [rk[ae_type] for rk in ranks]
        hist = runs[0]["history"]
        for rk, run in enumerate(runs[1:], 1):
            _check(run["history"] == hist,
                   f"phase 7 {ae_type}: rank {rk}'s history {run['history']} differs from rank "
                   f"0's {hist}")
        expect = dict(dict.fromkeys(LAUNCH_NAMES, 0), **want[ae_type])
        for rk, run in enumerate(runs):
            _check(run["launches"] == expect, f"phase 7 {ae_type}: rank {rk} launched "
                   f"{run['launches']}, expected {expect}")
        _check(len(hist["loss"]) == epochs and np.all(np.isfinite(hist["loss"]))
               and np.all(np.isfinite(hist["val_loss"])), f"phase 7 {ae_type}: history {hist}")
        if ae_type == "zinb-conddisp":
            # same seed and initial weights as phase 4; the sums run in
            # another order over the ranks, and the difference grows over
            # the RMSprop steps
            rel = {}
            for key, rtol in (("loss", 1e-3), ("val_loss", val_rtol)):
                ref = np.asarray(single_hist[key][:epochs])
                rel[key] = float(np.max(np.abs(np.asarray(hist[key]) - ref) / np.abs(ref)))
                _check(rel[key] <= rtol, f"phase 7: {key} {hist[key]} vs phase 4's "
                       f"{ref.tolist()}, relative difference {rel[key]:.3e} > {rtol}")
            print(f"phase 7: zinb-conddisp against phase 4's first {epochs} epochs "
                  f"{single_hist['loss'][:epochs]} / {single_hist['val_loss'][:epochs]}: largest "
                  f"relative difference {rel['loss']:.3e} (loss), {rel['val_loss']:.3e} (val_loss)")
        den = [np.load(os.path.join(out_dir, f"denoised-{ae_type}-rank{r}.npy"))
               for r in range(n_ranks)]
        _check(den[0].shape == (2730, 3451) and bool(np.isfinite(den[0]).all()),
               f"phase 7 {ae_type}: denoised matrix of shape {den[0].shape} or not finite")
        _check(all(np.array_equal(d, den[0]) for d in den[1:]),
               f"phase 7 {ae_type}: the ranks' denoised matrices differ")
        written = [os.path.exists(os.path.join(out_dir, f"{ae_type}-rank{r}"))
                   for r in range(n_ranks)]
        _check(os.path.exists(os.path.join(out_dir, f"{ae_type}-rank0", "model.pickle"))
               and not any(written[1:]), f"phase 7 {ae_type}: written by ranks {written}")
        out[ae_type] = [run["launches"] for run in runs]
        print(f"phase 7: {ae_type} {epochs} epochs on {n_ranks} ranks: loss {hist['loss']}, "
              f"val_loss {hist['val_loss']}, the same on every rank; per-rank launches "
              f"{runs[0]['launches']}; denoised matrices equal and finite; rank 0 alone wrote")
    # the TensorBoard fit: the plain fit's history on every rank, and its
    # gradient one more K1w and one K2w a rank an epoch
    epochs = DP_RUNS[0][1]
    tb_want = dict(dict.fromkeys(LAUNCH_NAMES, 0), zinb_nll_fwd=154 + warm,
                   zinb_nll_bwd=154 + warm, zinb_nll_fwd_w=2 + epochs, zinb_nll_bwd_w=epochs)
    for rk, r in enumerate(ranks):
        _check(r["tensorboard"]["history"] == r["zinb-conddisp"]["history"],
               f"phase 7: rank {rk}'s TensorBoard fit's history {r['tensorboard']['history']} "
               f"is not its plain fit's {r['zinb-conddisp']['history']}")
        _check(r["tensorboard"]["launches"] == tb_want,
               f"phase 7: rank {rk}'s TensorBoard fit launched {r['tensorboard']['launches']}, "
               f"expected {tb_want}")
    out["tensorboard"] = [r["tensorboard"]["launches"] for r in ranks]
    # the nb-conddisp TensorBoard fit: the 55 validation rows padded to 56,
    # one K1w an epoch, and the gradient's K1w and K2w
    nb_tb = [r["tensorboard_nb"] for r in ranks]
    nb_want = dict(dict.fromkeys(LAUNCH_NAMES, 0), nb_nll_fwd=16 + warm, nb_nll_bwd=16 + warm,
                   nb_nll_fwd_w=2, nb_nll_bwd_w=1)
    for rk, r in enumerate(nb_tb):
        _check(r["history"] == nb_tb[0]["history"]
               and bool(np.all(np.isfinite(r["history"]["val_loss"]))),
               f"phase 7: the nb-conddisp TensorBoard fit's history on rank {rk}: "
               f"{r['history']}, rank 0's {nb_tb[0]['history']}")
        _check(r["launches"] == nb_want, f"phase 7: rank {rk}'s nb-conddisp TensorBoard fit "
               f"launched {r['launches']}, expected {nb_want}")
    _check(any(n.startswith("events.out.tfevents.")
               for n in os.listdir(os.path.join(out_dir, "tb_nb", "tb"))),
           "phase 7: the nb-conddisp TensorBoard fit wrote no event file")
    out["tensorboard_nb"] = [r["launches"] for r in nb_tb]
    # the compiled fit: 2448 train rows (76 full steps, a trailing 16) and
    # 272 validation rows, which divide the ranks: no weighted kernel;
    # over NCCL from the whole-fit graph, whose warm-up runs an epoch more
    comp = [r["compiled"] for r in ranks]
    runs = 3 if backend == "nccl" else 2
    comp_want = dict(dict.fromkeys(LAUNCH_NAMES, 0), zinb_nll_fwd=78 * runs,
                     zinb_nll_bwd=77 * runs)
    for rk, r in enumerate(comp):
        _check(r["history"] == comp[0]["history"] and len(r["history"]["loss"]) == 2,
               f"phase 7: the compiled fit's history on rank {rk}: {r['history']}, rank 0's "
               f"{comp[0]['history']}")
        _check(r["launches"] == comp_want, f"phase 7: rank {rk}'s compiled fit launched "
                                           f"{r['launches']}, expected {comp_want}")
    rel = {}
    if single_compiled is not None:
        for key, rtol in (("loss", 1e-3), ("val_loss", val_rtol)):
            ref = np.asarray(single_compiled[key])
            rel[key] = float(np.max(np.abs(np.asarray(comp[0]["history"][key]) - ref)
                                    / np.abs(ref)))
            _check(rel[key] <= rtol, f"phase 7: the compiled fit's {key} "
                   f"{comp[0]['history'][key]} vs the one-card compiled fit's {ref.tolist()}, "
                   f"relative difference {rel[key]:.3e} > {rtol}")
    out["compiled"] = [r["launches"] for r in comp]
    print(f"phase 7: compiled=True zinb-conddisp on the first {DP_COMPILED_CELLS} cells, 2 "
          f"epochs: the same history on every rank {comp[0]['history']}; against the one-card "
          f"compiled fit {single_compiled}: largest relative differences {rel}; launches "
          f"{comp[0]['launches']} a rank")
    print(f"phase 7: nb-conddisp with tensorboard=True on the first {DP_NB_TB_CELLS} cells, "
          f"1 epoch: the same history on every rank, launches {nb_tb[0]['launches']} a rank "
          "(the NB K2w in a fit)")
    out["tb_per_epoch_s"] = (ranks[0]["tensorboard"]["t_run"]
                             - ranks[0]["zinb-conddisp"]["t_zero"]) / epochs
    # rank 0 alone wrote the events; its gradients are the global batch's:
    # its last epoch's against the one-card gradient of its final
    # parameters on the same 273 validation rows
    hists = _tb_events(os.path.join(out_dir, "tb"), epochs,
                       sorted({t.split("/", 1)[1] for _, t in single_tb
                               if t.startswith("grads/")}))
    params = dict(np.load(os.path.join(out_dir, "zinb-conddisp-params.npz")))
    same = {}
    for tag, stats in _one_card_grad_stats(params).items():
        got = hists[(epochs - 1, tag)]
        for k in TB_STATS:
            d = abs(got[k] - stats[k])
            # an elementwise rtol carried through the sum bounds its error
            # by rtol * sum |g| <= rtol * sqrt(num * sum g^2)
            scale = (np.sqrt(stats["num"] * stats["sum_squares"]) if k == "sum"
                     else abs(stats[k]))
            _check(d <= TB_DP_RTOL * scale,
                   f"phase 7: {tag}: {k} {got[k]!r} vs {stats[k]!r}, the one-card gradient of "
                   f"the same parameters, beyond rtol {TB_DP_RTOL}")
            same[k] = max(same.get(k, 0.0), d / abs(stats[k]) if stats[k] else 0.0)
    # and against phase 4's one-card fit, whose parameters have drifted
    # from the data-parallel fit's (see the module docstring): measured
    drift = {}
    for (step, tag), stats in hists.items():
        if tag.startswith("grads/"):
            ref = single_tb[(step, tag)]
            for k in TB_STATS:
                d = abs(stats[k] - ref[k])
                drift[k] = max(drift.get(k, 0.0), d / abs(ref[k]) if ref[k] else 0.0)
    out["grads_rel_same_params"], out["grads_rel_phase4"] = same, drift
    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())  # noqa: E731
    print(f"phase 7: rank 0's grads/ histograms (one event file) at epoch {epochs} against the "
          f"one-card gradient of the same parameters, largest relative differences: "
          f"{fmt(same)} (rtol {TB_DP_RTOL}); against phase 4's one-card TensorBoard fit at "
          f"epochs 1-{epochs}: {fmt(drift)} (measured, not held: the fits' parameters differ)")
    if single_stream is not None:
        out["stream"] = _check_dp_stream(ranks, single_stream, n_ranks, backend)
    zinb = ranks[0]["zinb-conddisp"]
    out["per_epoch_s"] = (zinb["t_run"] - zinb["t_zero"]) / DP_RUNS[0][1]
    out["zinb_history"] = zinb["history"]
    print(f"phase 7: data-parallel zinb-conddisp epoch {out['per_epoch_s'] * 1e3:.1f} ms on "
          f"rank 0 ({n_ranks} ranks over {backend}"
          f"{': sharing one card, this measures no scaling' if backend == 'gloo' else ''}); "
          f"with TensorBoard {out['tb_per_epoch_s'] * 1e3:.1f} ms; the TensorBoard fit the "
          f"plain fit's bits on every rank, launches {out['tensorboard'][0]} a rank")
    shutil.rmtree(out_dir)
    return out


# gene-dim model parallelism: (name, ae_type, genes, epochs) of each fit;
# every gene tensor shards over 2 at 3450 genes, none at 3451 (= 7 x 17 x 29)
MP_RUNS = (("zinb-conddisp", "zinb-conddisp", 3450, 2), ("nb-conddisp", "nb-conddisp", 3451, 1))
MP_TIMEOUT = 600  # seconds for the ranks, start-up included


def _mp_fit(counts, ae_type, epochs, **kw):
    """``dca()`` of ``ae_type`` 64-32-64, batch 32, on ``counts`` on the
    card, with ``kw`` (``devices``, ``model_parallel``, ``network_kwds``);
    returns (the annotated copy, the network, the fit's ``History``, taken
    from the ``train`` that ``dca`` calls, for its epoch times)."""
    import dca_tpu_torch
    import dca_tpu_torch.api as api
    from dca_tpu_torch.data.adata import AnnData

    fits = []
    inner = api.train

    def recording(*args, **kwargs):
        fits.append(inner(*args, **kwargs))
        return fits[-1]

    api.train = recording
    try:
        ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=epochs,
                                     hidden_size=(64, 32, 64), batch_size=32, copy=True,
                                     return_info=True, return_model=True, **kw)
    finally:
        api.train = inner
    return ret, net, fits[0]


def want_mp_launches(likelihood, epochs, n_cells, n_data, data_index, batch=32,
                     val_split=0.1, captured=False):
    """The K1/K2 launches of one rank of a ``dca()`` fit over a grid of
    ``n_data`` data indices: a step where its block of the batch is not
    empty, and the validation once an epoch, through K1w where the
    validation rows do not divide the data indices (padded), else K1.
    ``captured`` (over NCCL): the steps replayed from CUDA graphs, whose
    warm-up runs the full and the trailing step once each, the trailing
    one launching nothing where this rank's block of it is empty."""
    n_train = int(n_cells * (1.0 - val_split))
    n_val = n_cells - n_train
    n_full, rem = divmod(n_train, batch)
    per = -(-rem // n_data)
    trailing = 1 if rem and data_index * per < rem else 0
    steps = n_full + trailing
    warm = ((n_full > 0) + trailing) if captured else 0
    out = dict.fromkeys(LAUNCH_NAMES, 0)
    out[f"{likelihood}_nll_fwd"] = epochs * steps + warm
    out[f"{likelihood}_nll_bwd"] = epochs * steps + warm
    out[f"{likelihood}_nll_fwd" + ("_w" if n_val % n_data else "")] += epochs
    return out


def _mp_rank(rank, world, port, out_dir, backend, models, runs):
    """One rank of the model-parallel fits, in a process of its own: join
    the group, then for each model-axis width of ``models`` and each run of
    ``runs`` fit through ``dca(devices="all", model_parallel=M)``; leave
    the histories, launches, epoch times, gathered parameters and denoised
    matrix in ``out_dir`` (rank 0 alone writes its model.pickle).  Then,
    for each M > 1, the streamed fits under the grid (``_mp_stream_fits``)."""
    import torch

    sys.path.insert(0, REPO)
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
    counts = make_paul15_like()
    res = {}
    for model in models:
        for name, ae_type, genes, epochs in runs:
            key = f"{name}-{world // model}x{model}"
            files = os.path.join(out_dir, f"{key}-rank{rank}")
            fl.reset_launches()
            ret, net, hist = _mp_fit(counts[:, :genes], ae_type, epochs, devices="all",
                                     model_parallel=model, network_kwds={"file_path": files})
            torch.cuda.synchronize()
            launches = dict(fl.launches)
            net.save()  # the gathered network: rank 0 alone writes
            np.save(os.path.join(out_dir, f"denoised-{key}-rank{rank}.npy"), ret.X)
            np.savez(os.path.join(out_dir, f"params-{key}-rank{rank}.npz"),
                     **{k: v.cpu().numpy() for k, v in net.model.state_dict().items()})
            res[key] = {"history": ret.uns["dca_loss_history"], "launches": launches,
                        "epoch_s": hist.epoch_s}
    state_path = os.path.join(out_dir, "stream_state.npz")
    for model in models:
        if model > 1:
            res.update(_mp_stream_fits(out_dir, state_path, counts[:, :runs[0][2]], world,
                                       model))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _mp_stream_fits(out_dir, state_path, counts, world, model, **kw):
    """The streamed zinb-conddisp fits on this rank under the (world / M) x
    M grid: ``train(devices="all", model_parallel=M,
    max_device_cells=STREAM_MAX_CELLS)`` for DP_STREAM_EPOCHS from the
    weights at ``state_path``, through each of DP_STREAM_TIERS (``kw`` to
    ``train`` besides); {key: history, launches, epoch times, the streamed
    epochs printed}."""
    import torch

    adata = _lazy_adata(counts)
    state = {k: torch.from_numpy(v) for k, v in np.load(state_path).items()}
    out = {}
    for tier in DP_STREAM_TIERS:
        with _switches(STREAM_TIERS[tier]):
            text = StringIO()
            with contextlib.redirect_stdout(text):
                hist, launches, _ = _stream_fit(torch.device("cuda"), adata, state,
                                                DP_STREAM_EPOCHS, verbose=True, devices="all",
                                                model_parallel=model,
                                                max_device_cells=STREAM_MAX_CELLS, **kw)
            torch.cuda.synchronize()
        out[f"stream-{tier}-{world // model}x{model}"] = {
            "history": hist.history, "launches": launches, "epoch_s": hist.epoch_s,
            "printed": _streamed_epochs(text.getvalue())}
    return out


def mp_references(runs):
    """The one-card ``dca()`` fit of each run of ``runs`` (the steps
    replayed from CUDA graphs): {name: (history, epoch times)}."""
    counts = make_paul15_like()
    out = {}
    for name, ae_type, genes, epochs in runs:
        ret, _, hist = _mp_fit(counts[:, :genes], ae_type, epochs)
        out[name] = (ret.uns["dca_loss_history"], hist.epoch_s)
    return out


def phase_model_parallel(n_ranks=DP_RANKS, backend="gloo", models=(2,), runs=MP_RUNS):
    """Phase 7's model-parallel fits: ``n_ranks`` spawned ranks (by
    default 2 on the one card over gloo) fit each run of ``runs`` through
    ``dca(devices="all", model_parallel=M)`` for each M of ``models``, on
    the grid of (n_ranks / M) x M.  Each fit: the same history on every
    rank, within rtol 1e-3 (loss) and STREAM_VAL_RTOL (val_loss: the
    BatchNorm-bias noise, ROADMAP.md Queue 3) of the one-card fit of the
    same genes; the gathered parameters and the denoised matrix the same
    on every rank, finite, of the whole shapes; rank 0 alone writes; each
    rank's K1/K2 launches those of ``want_mp_launches``.  Then, for each
    M > 1, the streamed zinb-conddisp fit at the first run's genes under
    the grid (``_mp_stream_fits``, host and padded-payload tiers), held to
    the one-card streamed fit of the same genes and weights (host tier, the
    steps replayed from CUDA graphs): the same history on every rank and in
    both tiers, loss within rtol 1e-3 and val_loss within STREAM_VAL_RTOL,
    each rank's launches those of its data index's schedule
    (``want_group_stream_launches``), rank 0 alone printing its epochs.
    Returns {fit: {history on rank 0, launches a rank, epoch times on rank
    0, the one card's}}."""
    import torch

    from dca_tpu_torch.models import core

    refs = mp_references(runs)
    out_dir = os.path.join(OUT_DIR, "mp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    # the streamed fits' weights and one-card reference, at the first run's genes
    stream_genes = runs[0][2]
    dev = torch.device("cuda")
    state = _stream_state(dev, stream_genes)
    np.savez(os.path.join(out_dir, "stream_state.npz"),
             **{k: v.cpu().numpy() for k, v in state.items()})
    with _switches(STREAM_TIERS["host"]):
        stream_one, _, _ = _stream_fit(dev, _lazy_adata(make_paul15_like()[:, :stream_genes]),
                                       state, DP_STREAM_EPOCHS, verbose=False,
                                       max_device_cells=STREAM_MAX_CELLS)
    run_ranks(_mp_rank, n_ranks, (out_dir, backend, tuple(models), tuple(runs)), MP_TIMEOUT,
              "phase 7 (model parallel)")
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = {}
    for model in models:
        n_data = n_ranks // model
        for name, ae_type, genes, epochs in runs:
            key = f"{name}-{n_data}x{model}"
            what = f"phase 7 model parallel {key} ({genes} genes)"
            fits = [r[key] for r in ranks]
            hist = fits[0]["history"]
            for rk, fit in enumerate(fits):
                _check(fit["history"] == hist, f"{what}: rank {rk}'s history {fit['history']} "
                       f"differs from rank 0's {hist}")
                want = want_mp_launches(core.LIKELIHOODS[ae_type], epochs, 2730, n_data,
                                        rk // model, captured=backend == "nccl")
                _check(fit["launches"] == want,
                       f"{what}: rank {rk} launched {fit['launches']}, expected {want}")
            ref, ref_epoch_s = refs[name]
            rel = {}
            for k, rtol in (("loss", 1e-3), ("val_loss", STREAM_VAL_RTOL)):
                got, want = np.asarray(hist[k]), np.asarray(ref[k])
                _check(len(got) == epochs and bool(np.isfinite(got).all()),
                       f"{what}: {k} {hist[k]}")
                rel[k] = float(np.max(np.abs(got - want) / np.abs(want)))
                _check(rel[k] <= rtol, f"{what}: {k} {hist[k]} vs the one-card fit's "
                       f"{ref[k]}, relative difference {rel[k]:.3e} > {rtol}")
            params = [dict(np.load(os.path.join(out_dir, f"params-{key}-rank{r}.npz")))
                      for r in range(n_ranks)]
            _check(params[0]["trunk.enc0.kernel"].shape == (genes, 64)
                   and params[0]["heads.mean.kernel"].shape == (64, genes),
                   f"{what}: the gathered network is not whole")
            for rk, p in enumerate(params[1:], 1):
                _check(all(np.array_equal(p[k], params[0][k]) for k in p),
                       f"{what}: rank {rk}'s gathered parameters differ from rank 0's")
            den = [np.load(os.path.join(out_dir, f"denoised-{key}-rank{r}.npy"))
                   for r in range(n_ranks)]
            _check(den[0].shape == (2730, genes) and bool(np.isfinite(den[0]).all()),
                   f"{what}: denoised matrix of shape {den[0].shape} or not finite")
            _check(all(np.array_equal(d, den[0]) for d in den[1:]),
                   f"{what}: the ranks' denoised matrices differ")
            written = [os.path.exists(os.path.join(out_dir, f"{key}-rank{r}"))
                       for r in range(n_ranks)]
            _check(os.path.exists(os.path.join(out_dir, f"{key}-rank0", "model.pickle"))
                   and not any(written[1:]), f"{what}: written by ranks {written}")
            out[key] = {"history": hist, "launches": [f["launches"] for f in fits],
                        "epoch_s": fits[0]["epoch_s"], "one_card_epoch_s": ref_epoch_s,
                        "rel": rel}
            print(f"{what}, {epochs} epochs on {n_ranks} ranks over {backend}: loss "
                  f"{hist['loss']}, val_loss {hist['val_loss']}, the same on every rank; "
                  f"against the one-card fit largest relative differences {rel['loss']:.3e} "
                  f"(loss), {rel['val_loss']:.3e} (val_loss); per-rank launches "
                  f"{[{k: v for k, v in f['launches'].items() if v} for f in fits]}; gathered "
                  f"parameters and denoised matrices equal; rank 0 alone wrote; epochs "
                  f"{[round(t * 1e3, 1) for t in fits[0]['epoch_s']]} ms on rank 0 against "
                  f"{[round(t * 1e3, 1) for t in ref_epoch_s]} ms on one card")
    for model in (m for m in models if m > 1):
        out.update(_check_mp_stream(ranks, stream_one, n_ranks, model, stream_genes, backend))
    shutil.rmtree(out_dir)
    return out


def _check_mp_stream(ranks, one, n_ranks, model, genes, backend):
    """The streamed fits of ``_mp_stream_fits`` on the grid of (n_ranks /
    ``model``) x ``model`` against each other and against the one-card
    streamed fit ``one`` (a ``History``); {key: history, launches a rank,
    epoch times on rank 0, the one card's}."""
    n_data = n_ranks // model
    out = {}
    first = None
    for tier in DP_STREAM_TIERS:
        key = f"stream-{tier}-{n_data}x{model}"
        what = f"phase 7 streamed {tier} under model parallelism {n_data}x{model} ({genes} genes)"
        fits = [r[key] for r in ranks]
        hist = fits[0]["history"]
        first = first or hist
        for rk, fit in enumerate(fits):
            want = want_group_stream_launches(DP_STREAM_EPOCHS, 2730, STREAM_MAX_CELLS, n_data,
                                              rk // model, captured=backend == "nccl")
            _check(fit["history"] == hist, f"{what}: rank {rk}'s history {fit['history']} "
                   f"differs from rank 0's {hist}")
            _check(fit["launches"] == want,
                   f"{what}: rank {rk} launched {fit['launches']}, expected {want}")
            _check(fit["printed"] == (DP_STREAM_EPOCHS if rk == 0 else 0),
                   f"{what}: rank {rk} printed {fit['printed']} streamed epochs")
        _check(hist == first, f"{what}: history {hist} is not the {DP_STREAM_TIERS[0]} "
               f"tier's {first}")
        rel = {}
        for k, rtol in (("loss", 1e-3), ("val_loss", STREAM_VAL_RTOL)):
            got, ref = np.asarray(hist[k]), np.asarray(one.history[k])
            _check(len(got) == DP_STREAM_EPOCHS and bool(np.isfinite(got).all()),
                   f"{what}: {k} {hist[k]}")
            rel[k] = float(np.max(np.abs(got - ref) / np.abs(ref)))
            _check(rel[k] <= rtol, f"{what}: {k} {hist[k]} vs the one-card streamed fit's "
                   f"{one.history[k]}, relative difference {rel[k]:.3e} > {rtol}")
        out[f"zinb-conddisp-{key}"] = {
            "history": hist, "launches": [f["launches"] for f in fits],
            "epoch_s": fits[0]["epoch_s"], "one_card_epoch_s": one.epoch_s, "rel": rel}
        print(f"{what}, {DP_STREAM_EPOCHS} epochs, parts of {STREAM_MAX_CELLS}, on {n_ranks} "
              f"ranks over {backend}: loss {hist['loss']}, val_loss {hist['val_loss']}, the "
              f"same on every rank and in both tiers; against the one-card streamed fit "
              f"largest relative differences {rel['loss']:.3e} (loss), {rel['val_loss']:.3e} "
              f"(val_loss); per-rank launches "
              f"{[{k: v for k, v in f['launches'].items() if v} for f in fits]}; epochs "
              f"{[round(t * 1e3, 1) for t in fits[0]['epoch_s']]} ms on rank 0 against "
              f"{[round(t * 1e3, 1) for t in one.epoch_s]} ms on one card")
    return out


LAUNCH_RTOL = 1e-4  # the launcher's fits against the same fits on spawned ranks


def phase_launch(dp, mp=None, n_ranks=DP_RANKS, one_card=True, runs=MP_RUNS):
    """Phase 7's fits again, their ranks started by the fit itself from this
    process (``parallel/launch.py``): ``dca(devices=n_ranks)`` of
    zinb-conddisp for DP_RUNS' epochs on phase 4's matrix, on one card
    through ``_one_card`` (the ranks share it over gloo), else one card a
    rank over NCCL; with ``mp`` (``phase_model_parallel``'s results on
    ``runs``) also ``dca(devices=n_ranks, model_parallel=2)`` at the genes
    of the first of ``runs`` and the streamed fit on that grid from the
    same weights.  Each: rank 0's
    history (this process's) within LAUNCH_RTOL of the spawned ranks' fit,
    its launches exactly rank 0's there, no process group left after it.
    Returns {fit: history, launches, epoch times, start-up and shared
    bytes (``History.launch``), the spawned fit's epoch times}."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    kw = {"training_kwds": {"_one_card": True}} if one_card else {}
    counts = make_paul15_like()
    epochs = DP_RUNS[0][1]
    fits = [("dp", lambda: _mp_fit(counts, "zinb-conddisp", epochs, devices=n_ranks, **kw)[2],
             dp["zinb_history"], dp["zinb-conddisp"][0], [dp["per_epoch_s"]])]
    if mp is not None:
        name, ae_type, genes, mp_epochs = runs[0]
        grid = f"{n_ranks // 2}x2"
        ref = mp[f"{name}-{grid}"]
        fits.append((f"{name} {grid} at {genes} genes", lambda: _mp_fit(
            counts[:, :genes], ae_type, mp_epochs, devices=n_ranks, model_parallel=2,
            **kw)[2], ref["history"], ref["launches"][0], ref["epoch_s"]))
        dev = torch.device("cuda")

        def streamed():
            with _switches(STREAM_TIERS["host"]):
                return _stream_fit(dev, _lazy_adata(counts[:, :genes]),
                                   _stream_state(dev, genes), DP_STREAM_EPOCHS, verbose=False,
                                   devices=n_ranks, model_parallel=2,
                                   max_device_cells=STREAM_MAX_CELLS,
                                   **kw.get("training_kwds", {}))[0]

        ref = mp[f"zinb-conddisp-stream-host-{grid}"]
        fits.append((f"streamed {grid} at {genes} genes", streamed, ref["history"],
                     ref["launches"][0], ref["epoch_s"]))
    out = {}
    for name, fit, ref_hist, ref_launches, ref_epoch_s in fits:
        fl.reset_launches()
        hist = fit()
        torch.cuda.synchronize()
        launches = dict(fl.launches)
        what = f"phase 7 launched {name} ({n_ranks} ranks from this process)"
        _check(not torch.distributed.is_initialized() and hist.launch is not None
               and hist.launch["ranks"] == n_ranks, f"{what}: {hist.launch}, a group left "
               f"{torch.distributed.is_initialized()}")
        rel = {}
        for k in ("loss", "val_loss"):
            got, ref = np.asarray(hist.history[k]), np.asarray(ref_hist[k])
            _check(got.shape == ref.shape and bool(np.isfinite(got).all()),
                   f"{what}: {k} {hist.history[k]}")
            rel[k] = float(np.max(np.abs(got - ref) / np.abs(ref)))
            _check(rel[k] <= LAUNCH_RTOL, f"{what}: {k} {hist.history[k]} vs the spawned "
                   f"ranks' {ref_hist[k]}, relative difference {rel[k]:.3e} > {LAUNCH_RTOL}")
        _check(launches == ref_launches, f"{what}: rank 0 launched {launches}, the spawned "
               f"rank 0 {ref_launches}")
        out[name] = {"history": hist.history, "launches": launches, "epoch_s": hist.epoch_s,
                     "launch": hist.launch, "rel": rel, "spawned_epoch_s": ref_epoch_s}
        print(f"{what}: loss {hist.history['loss']}, val_loss {hist.history['val_loss']}; "
              f"against the spawned ranks' fit largest relative differences {rel['loss']:.3e} "
              f"(loss), {rel['val_loss']:.3e} (val_loss); rank 0's launches "
              f"{ {k: v for k, v in launches.items() if v} }; group formed after "
              f"{hist.launch['group_s']:.2f} s, {hist.launch['shared_bytes']} bytes shared, "
              f"backend {hist.launch['backend']}; epochs "
              f"{[round(t * 1e3, 1) for t in hist.epoch_s]} ms on rank 0")
    return out


# ---------------------------------------------------------------------------
# phase 10: the streaming trainer
# ---------------------------------------------------------------------------

STREAM_TIERS = {
    "host": {"DCA_TPU_DEVICE_DENSIFY": "0"},
    "padded": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
               "DCA_TPU_PAYLOAD": "padded"},
    "flat": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
             "DCA_TPU_PAYLOAD": "flat"},
    "flat8": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
              "DCA_TPU_PAYLOAD": "flat8"},
    "derived": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT": "0"},
    "resident": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT": "1"},
}
STREAM_SWITCHES = ("DCA_TPU_DEVICE_DENSIFY", "DCA_TPU_DERIVE_INPUT", "DCA_TPU_PAYLOAD",
                   "DCA_TPU_RESIDENT", "DCA_TPU_TIMELINE", "DCA_TPU_FUSED_DENSE")
# the streamed tiers whose parts are the in-memory fit's bits (the CPU tests
# show them equal: tests/test_torch_streaming.py)
SAME_BITS_TIERS = ("host", "padded", "flat", "flat8")
CORPUS = (262_144, 3451, 345)  # cells, genes, nonzeros a cell: ~10% density
# the derived input is log1p(t * m) on the device, within 2 ulps of the
# host's normalized input (checked apart, ``_check_derived_input``); the
# Dense biases before BatchNorm, whose exact gradient is 0, turn such
# differences into learning-rate-sized RMSprop steps, which the running
# means carry into the history: the JAX package holds its derived tier to
# its host tier at this tolerance (tests/test_densify.py)
DERIVED_RTOL = 2e-3


@contextlib.contextmanager
def _switches(env):
    """Set the streaming switches to ``env`` (the others unset) for the
    block, and restore them after."""
    saved = {k: os.environ.get(k) for k in STREAM_SWITCHES}
    for k in STREAM_SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _lazy_adata(X):
    """``X`` (cells x genes) read and normalized as ``dca()`` does, with the
    z-scale deferred (``normalize(lazy_scale=True)``), X kept sparse."""
    import scipy.sparse as sp

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    return io.normalize(io.read_dataset(AnnData(sp.csr_matrix(X)), check_counts=False),
                        lazy_scale=True)


def _stream_schedule(n_cells, max_cells, batch=32, val_split=0.1, n_genes=0):
    """(train steps, validation launches, captured graphs) of one streamed
    epoch, as ``train/loop.py::_train_streaming`` stages it: the full
    batches of each chunk of ``chunk`` rows as one part and its trailing
    rows as another, the parts alternating between two buffers, then the
    validation chunks, each evaluated in blocks of ``n_genes``-wide rows
    (``_val_blocks``; one block where ``n_genes`` is 0); one graph for
    each (buffer, full or trailing) the schedule uses."""
    from dca_tpu_torch.train.loop import _val_blocks

    n_train = int(n_cells * (1.0 - val_split))
    chunk = max((min(max_cells, n_train) // batch) * batch, batch)
    kinds = []
    for lo in range(0, n_train, chunk):
        n = min(chunk, n_train - lo)
        kinds += ["full"] * (n >= batch) + ["rem"] * (n % batch > 0)
    graphs = {(i % 2, k) for i, k in enumerate(kinds)}
    n_val = n_cells - n_train
    val_chunks = sum(len(_val_blocks(min(chunk, n_val - lo), n_genes)) if n_genes else 1
                     for lo in range(0, n_val, chunk))
    return n_train // batch + (n_train % batch > 0), val_chunks, len(graphs)


def want_group_stream_launches(epochs, n_cells, max_cells, n_ranks, rank, batch=32,
                                val_split=0.1, captured=False):
    """``rank``'s launches in a streamed zinb fit under a group of
    ``n_ranks``: K1 and K2 once a step, but for the trailing batch where
    this rank's share of it is empty (blocks of ceil(rows / ranks),
    ``process_row_range``), and each validation chunk through K1, or
    through K1w where it is padded to a multiple of the ranks.  Eager (a
    gloo group) it runs no warm-up; ``captured`` (NCCL) one for each
    captured step, the trailing one launching nothing where this rank's
    share is empty."""
    from dca_tpu_torch.parallel.multihost import process_row_range

    steps, _, graphs = _stream_schedule(n_cells, max_cells, batch, val_split)
    n_train = int(n_cells * (1.0 - val_split))
    lo, hi = process_row_range(n_train % batch, rank, n_ranks)
    empty = int(n_train % batch > 0 and lo == hi)
    steps -= empty
    warm = graphs - empty if captured else 0
    chunk = max((min(max_cells, n_train) // batch) * batch, batch)
    n_val = n_cells - n_train
    padded = [min(chunk, n_val - lo) % n_ranks > 0 for lo in range(0, n_val, chunk)]
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    want["zinb_nll_fwd"] = epochs * (steps + padded.count(False)) + warm
    want["zinb_nll_fwd_w"] = epochs * padded.count(True)
    want["zinb_nll_bwd"] = epochs * steps + warm
    return want


def _streamed_epochs(text):
    """The epochs a verbose fit printed as streamed."""
    return sum(line.startswith("Epoch ") and line.endswith("[streaming]")
               for line in text.splitlines())


def _want_stream_launches(epochs, n_cells, max_cells, n_genes=0):
    steps, val_chunks, graphs = _stream_schedule(n_cells, max_cells, n_genes=n_genes)
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    want["zinb_nll_fwd"] = epochs * (steps + val_chunks) + graphs
    want["zinb_nll_bwd"] = epochs * steps + graphs
    return want


def synthetic_sparse_counts(n_cells, n_genes=3451, k=345, seed=0):
    """Sparse count matrix at ~10% density built directly in CSR, only its
    nonzeros sampled: k nonzeros a cell on a strided column pattern,
    values Poisson(3) + 1 (the generator of the JAX package's
    ``examples/large_scale.py``, copied, with the row offsets running over
    every column the stride leaves, so that no gene is empty and
    ``normalize`` keeps all n_genes)."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    step = n_genes // k
    offsets = n_genes - (k - 1) * step
    idx = (np.arange(k, dtype=np.int32)[None, :] * step
           + (np.arange(n_cells, dtype=np.int32)[:, None] % offsets))
    data = (rs.poisson(3.0, size=n_cells * k) + 1.0).astype(np.float32)
    indptr = np.arange(n_cells + 1, dtype=np.int64) * k
    return sp.csr_matrix((data, idx.ravel(), indptr), shape=(n_cells, n_genes))


class _PeakRSS:
    """The process's peak resident memory while the block runs, sampled
    every 20 ms on a thread."""

    def __enter__(self):
        import threading

        self.peak = _rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, _rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_bytes())


def _stream_fit(dev, adata, state, epochs, **kw):
    """``train()`` zinb-conddisp 64-32-64 on ``dev`` from ``state``;
    returns (history, launches, network)."""
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    net = get_ae_type("zinb-conddisp")(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                       device=dev).build()
    net.model.load_state_dict(state)
    fl.reset_launches()
    hist = train(adata, net, epochs=epochs, **kw)
    return hist, dict(fl.launches), net


def _check_scatters(dev, adata):
    """Every device scatter of a 512-row part of ``adata`` (its normalized
    X with the fused z-scale, its raw counts without) against the host
    tier's ``native.densify_rows``: the same bits."""
    import torch

    from dca_tpu_torch import native
    from dca_tpu_torch.data.loader import Flat8Chunk
    from dca_tpu_torch.data.io import scale_stats
    from dca_tpu_torch.ops import densify as dz

    mean, std = scale_stats(adata)
    mean_d, std_d = torch.from_numpy(mean).to(dev), torch.from_numpy(std).to(dev)
    rows = np.random.RandomState(3).permutation(adata.n_obs)[:512]
    n = 0
    for M, scaled in ((adata.X, True), (adata.raw.X, False)):
        G = M.shape[1]
        want = native.densify_rows(M.indptr, M.indices, M.data, rows, G)
        if scaled:
            want = (want - mean) / std
        int_vals = not scaled
        sc = (mean_d, std_d) if scaled else (None, None)
        L = dz.flat_slots_for(M, rows)
        out = torch.full((600 * G + 1,), 7.0, device=dev)  # a kept, dirty buffer
        got = {
            "padded": dz.device_densify(*dz.payload_from_csr(M, rows, int_vals=int_vals), G,
                                        *sc, device=dev),
            "flat": dz.device_densify_flat(*dz.flat_payload_from_csr(M, rows, L,
                                                                     int_vals=int_vals),
                                           len(rows), G, *sc, device=dev),
            "flat8": dz.device_densify_flat8(
                Flat8Chunk(*dz.flat8_payload_from_csr(M, rows, L, L, L), len(rows), G),
                *sc, device=dev),
            "flat into a kept buffer": dz.device_densify_flat(
                *dz.flat_payload_from_csr(M, rows, L, int_vals=int_vals), len(rows), G, *sc,
                out=out),
        }
        for name, t in got.items():
            _check(t.device.type == dev.type and np.array_equal(t.cpu().numpy(), want),
                   f"phase 10: the {name} scatter{' with the z-scale' if scaled else ''} "
                   f"differs from densify_rows at {int((t.cpu().numpy() != want).sum())} "
                   "elements")
            n += 1
        _check(bool((out[len(rows) * G:-1] == 7.0).all()),
               "phase 10: a scatter wrote past its part into the kept buffer")
    return n


def _check_derived_input(dev, adata):
    """The derived input of every row (``ops.resident.derive_input`` on the
    device, from the raw counts and ``_derivable_row_scale``'s m): its
    log1p(t * m) within 4 ulps of the host's normalized log counts (m is
    recovered through expm1, so t * m may round apart from the host's
    scaled counts, and the two log1p are different functions), and the
    z-scaled input within that error through 1/std plus 2 ulps; returns the
    worst log1p error, in ulps."""
    import torch

    from dca_tpu_torch.data.io import scale_stats
    from dca_tpu_torch.ops.resident import derive_input

    from dca_tpu_torch.train.loop import _derivable_row_scale

    mean, std = scale_stats(adata)
    m = _derivable_row_scale(adata.X, adata.raw.X)
    _check(m is not None, "phase 10: the input is not derivable from the raw counts")
    t = torch.from_numpy(adata.raw.X.toarray()).to(dev)
    m_d = torch.from_numpy(m).to(dev)
    G = t.shape[1]
    l1p = derive_input(t, m_d, torch.zeros(G, device=dev), torch.ones(G, device=dev))
    got = derive_input(t, m_d, torch.from_numpy(mean).to(dev),
                       torch.from_numpy(std).to(dev)).cpu().numpy()
    host = adata.X.toarray()
    ulps = np.abs(l1p.cpu().numpy() - host) / np.spacing(np.abs(host))
    worst = float(ulps.max())
    _check(worst <= 4, f"phase 10: the derived log counts are {worst} ulps off the host's")
    want = (host - mean) / std
    tol = 4 * np.spacing(np.abs(host)) / std + 2 * np.spacing(np.abs(want))
    _check(bool((np.abs(got - want) <= tol).all()),
           "phase 10: the derived, z-scaled input is off the host's beyond its tolerance")
    return worst


def _stream_state(dev, n_genes):
    """Phase 10's initial weights: a fresh zinb-conddisp 64-32-64 network's."""
    from dca_tpu_torch.models.network import get_ae_type

    return {k: v.clone() for k, v in get_ae_type("zinb-conddisp")(
        input_size=n_genes, hidden_size=(64, 32, 64), device=dev).build()
        .model.state_dict().items()}


def _dp_reference(state, hist):
    """What phase 7's streamed fits are held to (``phase_data_parallel``)."""
    return {"state": {k: v.cpu().numpy() for k, v in state.items()},
            "history": hist.history, "epoch_s": hist.epoch_s}


def stream_reference(dev, epochs=DP_STREAM_EPOCHS, max_cells=STREAM_MAX_CELLS):
    """Phase 10 (a)'s host-tier streamed fit alone, on one card, for
    ``chip_dp.py``: its weights, history and epoch times."""
    adata = _lazy_adata(make_paul15_like())
    state = _stream_state(dev, adata.n_vars)
    with _switches(STREAM_TIERS["host"]):
        hist, _, _ = _stream_fit(dev, adata, state, epochs, verbose=False,
                                 max_device_cells=max_cells)
    return _dp_reference(state, hist)


def phase_stream_small(dev, epochs=DP_STREAM_EPOCHS, max_cells=STREAM_MAX_CELLS):
    """Phase 10 (a): the streaming trainer at 2730 x 3451 through every
    staging tier, against the in-memory fit (module docstring)."""
    import torch

    from dca_tpu_torch.data.io import scale_stats, size_factors
    from dca_tpu_torch.ops import fused_dense as fd

    counts = make_paul15_like()
    adata = _lazy_adata(counts)
    n_cells = adata.n_obs
    state = _stream_state(dev, adata.n_vars)
    with _switches({}):
        ref, _, ref_net = _stream_fit(dev, adata, state, epochs, verbose=False)
    _check(ref.capture_s is not None, "phase 10: the in-memory fit replayed no graph")
    want = _want_stream_launches(epochs, n_cells, max_cells)
    res = {"launches": dict.fromkeys(LAUNCH_NAMES, 0), "same_bits": {}}
    hists = {}
    for tier, env in STREAM_TIERS.items():
        with _switches(env):
            out = StringIO()
            with contextlib.redirect_stdout(out):
                hist, launches, _ = _stream_fit(dev, adata, state, epochs, verbose=True,
                                                max_device_cells=max_cells)
        text = out.getvalue()
        n_epochs = _streamed_epochs(text)
        _check(n_epochs == epochs, f"phase 10: {tier}: {n_epochs} streamed epochs printed")
        _check(("corpus resident" in text) == (tier == "resident"),
               f"phase 10: {tier}: the resident corpus {'not ' if tier == 'resident' else ''}"
               "engaged")
        _check(hist.capture_s is not None, f"phase 10: {tier}: no graph replayed")
        _check(launches == want, f"phase 10: {tier}: launches {launches}, expected {want}")
        for k, v in launches.items():
            res["launches"][k] += v
        hists[tier] = hist.history
        if tier == "host":
            res["dp_reference"] = _dp_reference(state, hist)
        same = hist.history == ref.history
        res["same_bits"][tier] = same
        if tier in SAME_BITS_TIERS:
            _check(same, f"phase 10: {tier}: history {hist.history} is not the in-memory "
                         f"fit's {ref.history}")
        elif tier == "derived":
            for key in ("loss", "val_loss"):
                _check(np.allclose(hist.history[key], ref.history[key], rtol=DERIVED_RTOL,
                                   atol=0.0),
                       f"phase 10: derived: {key} {hist.history[key]} vs the in-memory "
                       f"{ref.history[key]}, beyond rtol {DERIVED_RTOL}")
        else:
            _check(hist.history == hists["derived"],
                   f"phase 10: resident: {hist.history} is not the derived tier's "
                   f"{hists['derived']}")
        print(f"phase 10 (a): {tier}: loss {hist.history['loss']}, val_loss "
              f"{hist.history['val_loss']}; epochs {[round(t * 1e3, 2) for t in hist.epoch_s]} "
              f"ms; capture {hist.capture_s * 1e3:.1f} ms; launches {launches}; the "
              f"in-memory fit's bits: {same}")

    res["scatters"] = _check_scatters(dev, adata)
    res["derived_ulps"] = _check_derived_input(dev, adata)

    # the block forward's payload branch, K4 off and on
    mean, std = scale_stats(adata)
    sf = size_factors(adata)
    x_dense = (adata.X.toarray() - mean) / std
    outs = {}
    for name, env in (("host", {"DCA_TPU_DEVICE_DENSIFY": "0"}),
                      ("payload", {"DCA_TPU_DEVICE_DENSIFY": "1"}),
                      ("payload K4", {"DCA_TPU_DEVICE_DENSIFY": "1",
                                      "DCA_TPU_FUSED_DENSE": "1"})):
        with _switches(env):
            fd.reset_launches()
            outs[name] = ref_net.forward(adata.X, sf, mean, std, chunk_rows=1024)
            torch.cuda.synchronize()
            res[f"k4_{name}"] = dict(fd.launches)
    for key, v in outs["host"].items():
        _check(np.array_equal(outs["payload"][key], v),
               f"phase 10: the payload forward's {key} is not the host forward's bits")
    tol = _forward_tolerance(ref_net, x_dense, sf)
    worst = 0.0
    for key, t in tol.items():
        err = np.abs(outs["payload K4"][key] - outs["host"][key])
        _check(bool((err <= t).all()), f"phase 10: the payload forward with K4: {key} off "
                                       f"by {(err / t).max():.3f} of its tolerance")
        worst = max(worst, float((err / t).max()))
    blocks = -(-n_cells // 1024)
    _check(res["k4_payload K4"]["fused_dense"] == 4 * blocks and
           res["k4_payload"]["fused_dense"] == 0,
           f"phase 10: K4 launches {res['k4_payload K4']} through the payload forward, "
           f"expected {4 * blocks} ({blocks} blocks of encoder, mean, dispersion, pi)")
    res["k4_worst"] = worst
    print(f"phase 10 (a): {res['scatters']} device scatters the bits of densify_rows; the "
          f"payload forward the host forward's bits, with K4 within {worst:.3f} of its "
          f"tolerance ({res['k4_payload K4']['fused_dense']} K4 launches); the derived input "
          f"within {res['derived_ulps']:.1f} ulps of the host's; K1/K2 launches "
          f"of the 6 streamed fits {res['launches']['zinb_nll_fwd']}/"
          f"{res['launches']['zinb_nll_bwd']}")
    return res


def _resident_elementwise_target(r, rows, t_out):
    """``ResidentCSR.target`` rebuilt with the other gather form: the
    B x K offsets ``starts[rows, None] + arange(K)`` written out, then one
    element-wise gather of the columns and one of the values at them."""
    import torch

    B, G = rows.shape[0], r.G
    t_out[:B * G].zero_()
    trash = t_out.numel() - 1
    offs = r.starts_d[rows].view(B, 1) + r._k
    mask = r._k < r.lens_d[rows].view(B, 1)
    flat = r.col_d[offs].to(torch.int64)
    flat += torch.arange(B, device=rows.device, dtype=torch.int64).mul_(G).view(B, 1)
    flat.masked_fill_(~mask, trash)
    vals = r.val_d[offs]
    vals = (vals.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32) if r.uint16
            else vals.float())
    t_out.index_put_((flat.view(-1),), vals.view(-1))
    return t_out[:B * G].view(B, G)


def _stage_sums(rows, epoch):
    """Seconds a timeline (``DCA_TPU_TIMELINE``) spent in each stage of one
    epoch."""
    sums = {}
    for r in rows:
        if r["epoch"] == epoch:
            sums[r["stage"]] = sums.get(r["stage"], 0.0) + r["dur"]
    return {k: round(v, 4) for k, v in sorted(sums.items())}


def _events_ms(fn, n=5):
    """Median wall of ``n`` calls of ``fn`` on the device (CUDA events)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _big_loss_inputs(dev, B, G, seed=5):
    """y, mu, theta, pi at (B, G) drawn on the device (the distributions of
    ``_loss_inputs``, with NB counts as a Poisson of a Gamma)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn(B, G, device=dev, generator=g).exp_().clamp_(1e-5, 1e6)
    th = (torch.randn(B, G, device=dev, generator=g) + 0.5).exp_().clamp_(1e-4, 1e4)
    lam = torch._standard_gamma(th, generator=g) * (mu / th)
    y = torch.poisson(lam, generator=g)
    y[torch.rand(B, G, device=dev, generator=g) < 0.2] = 0.0
    pi = torch.sigmoid(torch.randn(B, G, device=dev, generator=g) * 1.5 - 1.0)
    return y, mu, th, pi


def phase_stream_corpus(dev, epochs=2, corpus=CORPUS, max_cells=None):
    """Phase 10 (b): the streaming trainer at corpus scale on one card
    (module docstring).  ``max_cells``: ``train()``'s ``max_device_cells``,
    None for the default gate and parts (131072 cells)."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.ops.resident import PART_BYTES_PER_SLOT, ResidentCSR

    n_cells, n_genes, k = corpus
    t0 = time.perf_counter()
    adata = _lazy_adata(synthetic_sparse_counts(n_cells, n_genes, k, seed=7))
    t_prep = time.perf_counter() - t0
    _check(adata.n_obs == n_cells and adata.n_vars == n_genes,
           f"phase 10 (b): normalize kept {adata.shape}")
    _check(max_cells is not None or n_cells * n_genes * 8 > int(
        os.environ.get("DCA_TPU_DEVICE_BYTES", 6_000_000_000)),
        "phase 10 (b): the corpus does not pass the gate")
    from dca_tpu_torch.models.network import get_ae_type

    state = {kk: v.clone() for kk, v in get_ae_type("zinb-conddisp")(
        input_size=n_genes, hidden_size=(64, 32, 64), device=dev).build()
        .model.state_dict().items()}
    n_train = int(n_cells * 0.9)
    chunk = max_cells or 131072
    kmax = int(np.diff(adata.raw.X.indptr).max())
    buffers = 2 * chunk * 2 * n_genes * 4
    payload = ResidentCSR.payload_bytes(adata.raw.X)
    transient = chunk * kmax * PART_BYTES_PER_SLOT
    want = _want_stream_launches(epochs, n_cells, chunk, n_genes)
    res = {"prep_s": t_prep, "launches": dict.fromkeys(LAUNCH_NAMES, 0)}
    for tier, env in (("host", {"DCA_TPU_DEVICE_DENSIFY": "0"}), ("resident", {})):
        tl = os.path.join(OUT_DIR, f"timeline_{tier}.jsonl")
        if os.path.exists(tl):
            os.remove(tl)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _switches({**env, "DCA_TPU_TIMELINE": tl}), _PeakRSS() as rss:
            out = StringIO()
            with contextlib.redirect_stdout(out):
                hist, launches, _ = _stream_fit(dev, adata, state, epochs, verbose=True,
                                                max_device_cells=max_cells)
        text = out.getvalue()
        print(text, end="")
        _check(_streamed_epochs(text) == epochs,
               f"phase 10 (b): {tier}: {_streamed_epochs(text)} streamed epochs")
        _check(("corpus resident" in text) == (tier == "resident"),
               f"phase 10 (b): {tier}: the resident corpus engaged or not as expected")
        _check(launches == want, f"phase 10 (b): {tier}: launches {launches}, expected {want}")
        _check(np.all(np.isfinite(hist.history["loss"] + hist.history["val_loss"])),
               f"phase 10 (b): {tier}: history not finite {hist.history}")
        for kk, v in launches.items():
            res["launches"][kk] += v
        peak = torch.cuda.max_memory_allocated() - base
        estimate = buffers + (payload + transient if tier == "resident" else 0)
        rows = [json.loads(line) for line in open(tl)]
        busy = []
        for e in range(epochs):
            ev = [r for r in rows if r["epoch"] == e]
            wall = sum(r["dur"] for r in ev if r["stage"] == "epoch")
            busy.append(sum(r["dur"] for r in ev if r["stage"] == "device") / wall)
        res[tier] = {"epoch_s": hist.epoch_s, "rows_per_s": [n_train / t for t in hist.epoch_s],
                     "capture_s": hist.capture_s, "peak_bytes": peak, "estimate_bytes": estimate,
                     "rss_peak_bytes": rss.peak, "busy": busy, "history": hist.history,
                     "wait_s": [sum(r["dur"] for r in rows if r["epoch"] == e
                                    and r["stage"] == "wait") for e in range(epochs)],
                     "stages": [_stage_sums(rows, e) for e in range(epochs)]}
        print(f"phase 10 (b): {tier}: {n_cells} x {n_genes} ({adata.raw.X.nnz} nonzeros), "
              f"epochs {[round(t, 3) for t in hist.epoch_s]} s, "
              f"{[round(v) for v in res[tier]['rows_per_s']]} training rows/s, capture "
              f"{hist.capture_s:.3f} s; device memory peak {peak / 2**30:.2f} GiB against the "
              f"estimate {estimate / 2**30:.2f} GiB (part buffers {buffers / 2**30:.2f}"
              + (f", payload {payload / 2**30:.2f}, part transient {transient / 2**30:.2f}"
                 if tier == "resident" else "") +
              f"); host RSS peak {rss.peak / 2**30:.2f} GiB; main stream busy "
              f"{[round(b, 4) for b in busy]} of each epoch; main thread waited on staging "
              f"{[round(w, 3) for w in res[tier]['wait_s']]} s; launches {launches}; seconds "
              f"by timeline stage {res[tier]['stages']}")

    # the resident part: the slice gather ops/resident.py uses against the
    # element-wise one, and its transient memory
    r = ResidentCSR(adata.raw.X, np.ones(n_cells, np.float32), np.ones(n_cells, np.float32),
                    np.zeros(n_genes, np.float32), np.ones(n_genes, np.float32), dev)
    rows_d = torch.from_numpy(np.random.RandomState(1).permutation(n_train)[:chunk]).to(dev)
    x_buf = torch.zeros(chunk * n_genes + 1, device=dev)
    t_buf = torch.zeros(chunk * n_genes + 1, device=dev)
    s_buf = torch.zeros(chunk, device=dev)
    t_slice = r.target(rows_d, t_buf).clone()
    t_elem = _resident_elementwise_target(r, rows_d, t_buf).clone()
    _check(torch.equal(t_elem, t_slice), "phase 10 (b): the two gather forms differ")
    del t_elem, t_slice
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    r.part(rows_d, x_buf, t_buf, s_buf)
    torch.cuda.synchronize()
    res["part_transient_bytes_per_slot"] = (torch.cuda.max_memory_allocated() - before) / (
        chunk * r.K)
    forms = {"target_slice_ms": lambda: r.target(rows_d, t_buf),
             "target_elementwise_ms": lambda: _resident_elementwise_target(r, rows_d, t_buf)}
    for slice_form in IN_TURNS[:4]:  # element-wise, slice, slice, element-wise
        name = "target_slice_ms" if slice_form else "target_elementwise_ms"
        res.setdefault(name, []).append(_events_ms(forms[name]))
    res["part_ms"] = _events_ms(lambda: r.part(rows_d, x_buf, t_buf, s_buf))
    del r, x_buf, t_buf, s_buf
    print(f"phase 10 (b): one resident part of {chunk} rows (K = {kmax}): the target by the "
          f"slice gather (ops/resident.py) {res['target_slice_ms']} ms, by the element-wise "
          f"gather {res['target_elementwise_ms']} ms (in turns), the same bits; the whole part "
          f"(the derive and sf too) {res['part_ms']:.2f} ms; its transient "
          f"{res['part_transient_bytes_per_slot']:.1f} bytes a padded slot (the gate counts "
          f"{PART_BYTES_PER_SLOT})")

    # K1 at the validation chunk's shape
    B = n_cells - n_train
    y, mu, th, pi = _big_loss_inputs(dev, B, n_genes)
    got = fl._fwd_out_kernel(y, mu, th, pi, 0.0)
    ref = fl._fwd_out_reference(y, mu, th, pi, 0.0)
    rel = abs(got[2].item() - ref[2].item()) / abs(ref[2].item())
    _check(rel <= LOSS_RTOL, f"phase 10 (b): K1 at {(B, n_genes)}: loss rel err {rel:.3e} "
                             f"above {LOSS_RTOL}")
    ms = _device_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.0), n=20, warmup=3)
    plain_ms = _device_ms(lambda: fl._fwd_reference(y, mu, th, pi, 0.0), n=5, warmup=1)
    bound, by = _bound_ms(4 * 4 * y.numel() + 4 * 4, _k1_ops(y, mu, th, True))
    res["k1_val"] = {"shape": [B, n_genes], "rel_err": rel,
                     "abs_err": abs(got[2].item() - ref[2].item()),
                     "count": [got[1].item(), ref[1].item()], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by}
    print(f"phase 10 (b): ZINB K1 at ({B}, {n_genes}): loss {got[2].item():.7f} against the "
          f"plain {ref[2].item():.7f}, rel err {rel:.3e}; count {got[1].item():.0f} against "
          f"{ref[1].item():.0f}; {ms * 1e3:.1f} us (plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound * 1e3:.1f} us by {by})")
    del y, mu, th, pi
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 11: the fit's artefacts
# ---------------------------------------------------------------------------

ART_DROPOUT = 0.1


def _art_fit(dev, adata, state, epochs, **kw):
    """``train()`` zinb-conddisp 64-32-64 at dropout 0.1 on ``dev`` from
    ``state``, through the CUDA graphs; returns (history, launches,
    network)."""
    import torch

    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    net = get_ae_type("zinb-conddisp")(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                       hidden_dropout=ART_DROPOUT, device=dev).build()
    net.model.load_state_dict(state)
    fl.reset_launches()
    hist = train(adata, net, epochs=epochs, verbose=False, **kw)
    torch.cuda.synchronize()
    _check(hist.capture_s is not None, "phase 11: a fit replayed no graph")
    return hist, dict(fl.launches), net


def _same_state(a, b):
    import torch

    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def _initial_state(dev, n_genes):
    from dca_tpu_torch.models.network import get_ae_type

    return {k: v.clone() for k, v in get_ae_type("zinb-conddisp")(
        input_size=n_genes, hidden_size=(64, 32, 64), hidden_dropout=ART_DROPOUT,
        device=dev).build().model.state_dict().items()}


def phase_artefacts(dev, card):
    """Phase 11: the fit's artefacts at 2730 x 3451, zinb-conddisp 64-32-64,
    dropout 0.1, through the CUDA graphs (module docstring)."""
    import glob
    import importlib.util

    import torch

    from dca_tpu_torch.data.io import scale_stats, size_factors
    from dca_tpu_torch.models.network import get_ae_type, load_model

    out = os.path.join(OUT_DIR, "artefacts")
    shutil.rmtree(out, ignore_errors=True)
    adata = _prepped_paul15()
    n_cells = adata.n_obs
    state = _initial_state(dev, adata.n_vars)
    has_h5 = importlib.util.find_spec("h5py") is not None
    res = {}

    # (a) checkpoints and resume
    whole_dir, seg_dir = os.path.join(out, "whole"), os.path.join(out, "segments")
    whole, l_whole, whole_net = _art_fit(dev, adata, state, 4, output_dir=whole_dir,
                                         checkpoint_every=1, save_weights=has_h5)
    seg1, l_seg1, _ = _art_fit(dev, adata, state, 2, output_dir=seg_dir, checkpoint_every=1)
    seg2, l_seg2, seg_net = _art_fit(dev, adata, state, 4, output_dir=seg_dir,
                                     checkpoint_every=1, resume=True)
    for key in ("loss", "val_loss", "lr"):
        _check(seg1.history[key] + seg2.history[key] == whole.history[key],
               f"phase 11 (a): {key}: 2 epochs {seg1.history[key]} and the resumed "
               f"{seg2.history[key]} are not the uninterrupted fit's {whole.history[key]}")
    _check(_same_state(seg_net, whole_net),
           "phase 11 (a): the resumed fit's final parameters are not the uninterrupted fit's")
    steps, warm = _steps(n_cells), _warmups(n_cells)
    for name, launches, epochs in (("4 epochs", l_whole, 4), ("2 epochs", l_seg1, 2),
                                   ("resumed to 4", l_seg2, 2)):
        want = _want_launches("zinb", epochs, steps, warm)
        _check(launches == want, f"phase 11 (a): {name}: launches {launches}, expected {want}")
    npz = os.path.join(whole_dir, "checkpoints", "ckpt_3.npz")
    res["ckpt_bytes"] = os.path.getsize(npz)
    res["ckpt_s"] = whole.checkpoint_s
    res["restore_s"] = seg2.restore_s
    res["resume_capture_s"] = seg2.capture_s
    res["launches"] = {"4 epochs": l_whole, "2 epochs": l_seg1, "resumed to 4": l_seg2}
    print(f"phase 11 (a) on {card}: 2 epochs + resume=True to 4 give the uninterrupted "
          f"fit's bits (history and parameters) at dropout {ART_DROPOUT}; K1/K2 launches "
          f"{l_whole['zinb_nll_fwd']}/{l_whole['zinb_nll_bwd']} (4 epochs), "
          f"{l_seg1['zinb_nll_fwd']}/{l_seg1['zinb_nll_bwd']} + {l_seg2['zinb_nll_fwd']}/"
          f"{l_seg2['zinb_nll_bwd']} (the segments; {warm} warm-ups each); a checkpoint "
          f"{res['ckpt_bytes']} bytes, saved in "
          f"{[round(t * 1e3, 2) for t in whole.checkpoint_s]} ms (read-back and npz); the "
          f"resume's restore {seg2.restore_s * 1e3:.2f} ms, its capture "
          f"{seg2.capture_s * 1e3:.1f} ms")

    # (b) model.pickle and weights.hdf5
    whole_net.file_path = whole_dir
    whole_net.save()
    loaded = load_model(os.path.join(whole_dir, "model.pickle"))
    _check(next(loaded.model.parameters()).is_cuda and _same_state(loaded, whole_net),
           "phase 11 (b): load_model did not rebuild the trained network on the card")
    res["weights"] = None
    if has_h5:
        best = int(np.argmin(whole.history["val_loss"]))
        fresh = get_ae_type("zinb-conddisp")(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                             device=dev).build()
        fresh.load_weights(os.path.join(whole_dir, "weights.hdf5"))
        if best == 3:
            _check(_same_state(fresh, whole_net),
                   "phase 11 (b): weights.hdf5 does not hold the best (last) epoch's weights")
            sf, (mean, std) = size_factors(adata), scale_stats(adata)
            got = fresh.forward(adata.X, sf, mean, std)
            want = whole_net.forward(adata.X, sf, mean, std)
            _check(all(np.array_equal(got[k], want[k]) for k in want),
                   "phase 11 (b): the loaded network's predict is not the fit's bits")
        res["weights"] = {"best_epoch": best + 1, "save_s": whole.weights_s,
                          "bytes": os.path.getsize(os.path.join(whole_dir, "weights.hdf5"))}
        compared = ("the fit's bits" if best == 3
                    else "not compared (the best epoch is not the last)")
        print(f"phase 11 (b) on {card}: load_model on the card; weights.hdf5 "
              f"({res['weights']['bytes']} "
              f"bytes, saved at {len(whole.weights_s)} improved epochs in "
              f"{[round(t * 1e3, 2) for t in whole.weights_s]} ms) holds the best epoch "
              f"({best + 1}); load_weights and the forward: {compared}")
    else:
        print("phase 11 (b): save_weights and load_weights not run: h5py is not installed "
              "on this machine (weights.hdf5 needs it, as in the JAX package); load_model "
              "rebuilt the trained network on the card")

    # (c) TensorBoard
    tb_dir = os.path.join(out, "tb")
    with recording_k2() as calls:
        tb, l_tb, tb_net = _art_fit(dev, adata, state, 4, output_dir=tb_dir, tensorboard=True)
    _check(tb.history == whole.history,
           f"phase 11 (c): the TensorBoard fit's history {tb.history} is not the plain fit's "
           f"{whole.history}")
    want = _want_launches("zinb", 4, steps, warm)
    want["zinb_nll_fwd"] += 4
    want["zinb_nll_bwd"] += 4
    _check(l_tb == want, f"phase 11 (c): launches {l_tb}, expected {want}")
    val_calls = [c for c in calls if c[0][1].shape[0] == n_cells - int(n_cells * 0.9)]
    _check(len(val_calls) == 4, f"phase 11 (c): {len(val_calls)} K2 launches at the "
                                "validation shape, expected 4")
    res["tb_k2_tol"] = max(check_k2_call("phase 11 (c): K2 of the TensorBoard gradient", *c)
                           for c in val_calls)
    paths = [n.replace(".", "/") for n, _ in tb_net.model.named_parameters()]
    _tb_events(tb_dir, 4, paths)
    _check(bool(glob.glob(os.path.join(tb_dir, "tb", "*.pt.trace.json"))),
           "phase 11 (c): no profiler trace")
    res["epoch_ms"] = [t * 1e3 for t in whole.epoch_s]
    res["tb_epoch_ms"] = [t * 1e3 for t in tb.epoch_s]
    res["tb_log_ms"] = [t * 1e3 for t in tb.tb_s]
    print(f"phase 11 (c) on {card}: the TensorBoard fit is the plain fit's bits; every tag "
          f"at every epoch; K2 of its gradient at (273, 3451) within "
          f"{res['tb_k2_tol']:.3f} of K2's tolerance; launches {l_tb}; epochs "
          f"{[round(t, 2) for t in res['tb_epoch_ms']]} ms (profiled) + logging "
          f"{[round(t, 2) for t in res['tb_log_ms']]} ms, against "
          f"{[round(t, 2) for t in res['epoch_ms']]} ms without TensorBoard")

    # (d) the streaming trainer's resume, host and resident tiers
    lazy = _lazy_adata(make_paul15_like())
    sstate = _initial_state(dev, lazy.n_vars)
    res["stream"] = {}
    for tier in ("host", "resident"):
        d = os.path.join(out, f"stream-{tier}")
        with _switches(STREAM_TIERS[tier]):
            ref, _, ref_net = _art_fit(dev, lazy, sstate, 2, max_device_cells=512)
            a, _, _ = _art_fit(dev, lazy, sstate, 1, max_device_cells=512, output_dir=d,
                               checkpoint_every=1)
            b, lb, b_net = _art_fit(dev, lazy, sstate, 2, max_device_cells=512, output_dir=d,
                                    checkpoint_every=1, resume=True)
        for key in ("loss", "val_loss", "lr"):
            _check(a.history[key] + b.history[key] == ref.history[key],
                   f"phase 11 (d): {tier}: {key} {a.history[key]} + {b.history[key]} is not "
                   f"the uninterrupted streamed fit's {ref.history[key]}")
        _check(_same_state(b_net, ref_net),
               f"phase 11 (d): {tier}: the resumed parameters are not the uninterrupted fit's")
        want = _want_stream_launches(1, n_cells, 512)
        _check(lb == want, f"phase 11 (d): {tier}: resumed launches {lb}, expected {want}")
        res["stream"][tier] = {"restore_s": b.restore_s, "checkpoint_s": a.checkpoint_s}
        print(f"phase 11 (d) on {card}: streamed ({tier} tier, parts of 512): 1 epoch + "
              f"resume=True to 2 give the uninterrupted fit's bits; restore "
              f"{b.restore_s * 1e3:.2f} ms")
    shutil.rmtree(out, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phase 12: the hyperparameter search, the diagnostics, the quality oracle
# ---------------------------------------------------------------------------

# phase 12 (a)'s trial: the main path's network under the search's fit
HYPER_CFG = {"norm_input_log": True, "norm_input_zeromean": True, "norm_input_sf": True,
             "lr": 1e-3, "ridge": 0.01, "l1_enc_coef": 0.0, "hidden_size": (64, 32, 64),
             "activation": "relu", "aetype": "zinb-conddisp", "batchnorm": True,
             "dropout": 0.0, "input_dropout": 0.0, "epochs": 2}
HYPER_TRIALS = 3
HYPER_RTOL = 1e-5  # the JAX package's parallel-against-sequential test
# the diagnostics' CPU-against-card tolerances, those of the CPU tests
# against the JAX package (tests/test_torch_diagnostics.py)
DIAG_PARAM_RTOL, DIAG_NLL_RTOL, DIAG_OBJ_RTOL = 1e-3, 1e-5, 1e-5


def pvalue_log_tol(res, n):
    """The bound on |log p - log p'| of two ``zero_inflation_test`` p-values
    whose NLLs agree within DIAG_NLL_RTOL: p is chi2's tail at 2 n (nb_nll
    - zinb nll), whose log moves by n times the NLLs' difference."""
    return n * DIAG_NLL_RTOL * (abs(res["zinb"]["nll"]) + abs(res["nb_nll"]))


def _trial_launches(n_cells, epochs):
    """K1/K2 of one trial's fit: ZINB (every aetype of the space), a 20%
    tail validation, the graph path's warm-ups."""
    return _want_launches("zinb", epochs, _steps(n_cells, val_split=0.2),
                          _warmups(n_cells, val_split=0.2))


def _read_search(out):
    import pickle

    results = os.path.join(out, "hyperopt_results")
    with open(os.path.join(results, "trials.pickle"), "rb") as f:
        trials = pickle.load(f)
    with open(os.path.join(results, "best.json")) as f:
        best = f.read()
    return trials, best


def phase_hyper(dev, card):
    """Phase 12 (a)-(c): a trial's objective at full width against a direct
    ``train()``, K1 at the trial's validation shape, the search sequential
    and with 2 threads on the one card in turns, and the CLI's search."""
    import torch

    from dca_tpu_torch import hyper as H
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.data.io import normalize
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    counts = make_paul15_like()
    n_cells, n_genes = counts.shape
    adata = AnnData(counts)
    res = {}

    # (a) one trial against the same fit called directly
    fl.reset_launches()
    t0 = time.perf_counter()
    loss = H._objective(adata, HYPER_CFG, seed=0, device=dev)
    res["trial_s"] = time.perf_counter() - t0
    res["trial_launches"] = dict(fl.launches)
    want = _trial_launches(n_cells, HYPER_CFG["epochs"])
    _check(res["trial_launches"] == want, f"phase 12 (a): the trial launched "
           f"{res['trial_launches']}, expected {want}")
    c = HYPER_CFG
    ad = normalize(adata.copy(), filter_min_counts=True, size_factors=c["norm_input_sf"],
                   logtrans_input=c["norm_input_log"], normalize_input=c["norm_input_zeromean"])
    net = AE_types[c["aetype"]](
        input_size=ad.n_vars, hidden_size=c["hidden_size"], l2_coef=0.0, l1_coef=0.0,
        l2_enc_coef=0.0, l1_enc_coef=c["l1_enc_coef"], ridge=c["ridge"],
        hidden_dropout=c["dropout"], input_dropout=c["input_dropout"],
        batchnorm=c["batchnorm"], activation=c["activation"], init="glorot_uniform",
        seed=0, device=dev).build()
    hist = train(ad, net, optimizer="RMSprop", learning_rate=c["lr"], epochs=c["epochs"],
                 batch_size=32, clip_grad=5.0, validation_split=0.2, reduce_lr=0,
                 early_stop=0, verbose=False, seed=0)
    direct = min(hist.history["val_loss"])
    _check(loss == direct, f"phase 12 (a): the trial's loss {loss!r} is not the direct "
                           f"train()'s min(val_loss) {direct!r}")
    print(f"phase 12 (a) on {card}: the trial (zinb-conddisp 64-32-64, {n_cells} x {n_genes}, "
          f"2 epochs) {loss!r} = min(val_loss) of train() called directly, the same bits; "
          f"{res['trial_s']:.3f} s; launches {res['trial_launches']}")

    # K1 at the trial's validation shape
    B = n_cells - int(n_cells * 0.8)
    y, mu, th, pi = _big_loss_inputs(dev, B, n_genes)
    ridge = c["ridge"]
    got = fl._fwd_out_kernel(y, mu, th, pi, ridge)
    ref = fl._fwd_out_reference(y, mu, th, pi, ridge)
    rel = abs(got[2].item() - ref[2].item()) / abs(ref[2].item())
    _check(rel <= LOSS_RTOL and got[1].item() == ref[1].item(),
           f"phase 12 (a): K1 at {(B, n_genes)}: loss rel err {rel:.3e} (at most {LOSS_RTOL}), "
           f"count {got[1].item()} against {ref[1].item()}")
    ms = _device_ms(lambda: fl._fwd_kernel(y, mu, th, pi, ridge))
    plain_ms = _device_ms(lambda: fl._fwd_reference(y, mu, th, pi, ridge), n=10, warmup=2)
    n_bytes = 4 * 4 * y.numel() + 4 * 4
    bound, by = _bound_ms(n_bytes, _k1_ops(y, mu, th, True))
    res["k1_trial_val"] = {"shape": [B, n_genes], "rel_err": rel,
                           "abs_err": abs(got[2].item() - ref[2].item()), "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                           "bytes": n_bytes}
    print(f"phase 12 (a) on {card}: ZINB K1 at ({B}, {n_genes}) (the trial's validation): "
          f"loss rel err {rel:.3e}, count {got[1].item():.0f} exact; {ms * 1e3:.2f} us "
          f"(plain {plain_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us by {by}, "
          f"{n_bytes / 1e6:.1f} MB)")
    del y, mu, th, pi

    # (b) the search, sequential and 2 threads on the one card, in turns
    searches = []
    for k, n_par in enumerate((1, 2, 2, 1)):
        out = os.path.join(OUT_DIR, f"hyper{k}")
        shutil.rmtree(out, ignore_errors=True)
        fl.reset_launches()
        t0 = time.perf_counter()
        best_cfg, best_loss, trials = H.hyper_search(
            adata, n_trials=HYPER_TRIALS, output_dir=out, seed=0,
            space=H.reference_space(HYPER_CFG["epochs"]), verbose=False, n_parallel=n_par,
            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fl.launches)
        saved, best = _read_search(out)
        _check(saved == trials, f"phase 12 (b): trials.pickle holds {saved}, not {trials}")
        searches.append({"n_parallel": n_par, "wall_s": wall, "launches": launches,
                         "trials": trials, "best": best})
        shutil.rmtree(out)
    first = searches[0]
    cfgs = [t["config"] for t in first["trials"]]
    losses = np.array([t["loss"] for t in first["trials"]])
    _check(len(cfgs) == HYPER_TRIALS + 1 and bool(np.isfinite(losses).all()),
           f"phase 12 (b): the search's losses {losses.tolist()}: a trial failed")
    want = {k: v * len(cfgs) for k, v in _trial_launches(n_cells, HYPER_CFG["epochs"]).items()}
    dist = 0.0
    for s in searches:
        _check([t["config"] for t in s["trials"]] == cfgs,
               f"phase 12 (b): n_parallel={s['n_parallel']} suggested other configs")
        got_l = np.array([t["loss"] for t in s["trials"]])
        dist = max(dist, float(np.max(np.abs(got_l - losses) / np.abs(losses))))
        _check(np.allclose(got_l, losses, rtol=HYPER_RTOL, atol=0.0),
               f"phase 12 (b): n_parallel={s['n_parallel']} losses {got_l.tolist()} against "
               f"{losses.tolist()}, beyond rtol {HYPER_RTOL}")
        _check(s["launches"] == want, f"phase 12 (b): n_parallel={s['n_parallel']} launched "
               f"{s['launches']}, expected the trials' {want}")
    same_bits = all([t["loss"] for t in s["trials"]] == losses.tolist() for s in searches)
    _check(all(s["best"] == first["best"] for s in searches) or not same_bits,
           "phase 12 (b): best.json differs between the searches")
    seq = [s["wall_s"] for s in searches if s["n_parallel"] == 1]
    par = [s["wall_s"] for s in searches if s["n_parallel"] == 2]
    res.update(search_launches=first["launches"], search_seq_s=seq, search_par_s=par,
               search_ratio=float(np.median(seq) / np.median(par)), search_same_bits=same_bits,
               search_rel_dist=dist, search_losses=losses.tolist(),
               search_configs=[(c["aetype"], list(c["hidden_size"]), c["activation"],
                                c["batchnorm"]) for c in cfgs])
    print(f"phase 12 (b) on {card}: hyper_search reference_space(2), seed 0, {HYPER_TRIALS} "
          f"trials + the pre-flight on {n_cells} x {n_genes}: configs {res['search_configs']}, "
          f"losses {losses.tolist()}; sequential and 2 threads on the one card "
          f"{'the same bits' if same_bits else f'within rel {dist:.3e}'}, best.json "
          f"{'the same' if same_bits else 'compared by loss'}; wall sequential {seq} s, "
          f"2 threads {par} s, ratio {res['search_ratio']:.3f}; launches a search "
          f"{first['launches']}")

    # (c) the CLI's search
    import pandas as pd

    work = os.path.join(OUT_DIR, "hyper_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    small = _small_counts(300, 120, 5)
    tsv = os.path.join(work, "counts.tsv")
    pd.DataFrame(small.T.astype(int), index=[f"gene{i}" for i in range(120)],
                 columns=[f"cell{i}" for i in range(300)]).to_csv(tsv, sep="\t")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = os.path.join(work, "out")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dca_tpu_torch", tsv, out, "--hyper",
                           "--hypern", "2", "--hyperepoch", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    res["cli_s"] = time.perf_counter() - t0
    _check(proc.returncode == 0, f"phase 12 (c): the CLI's --hyper exited {proc.returncode}:\n"
           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    trials, best = _read_search(out)
    _check(len(trials) == 3 and json.loads(best)["config"] is not None,
           f"phase 12 (c): the CLI's search wrote {trials} and {best}")
    print(f"phase 12 (c) on {card}: python -m dca_tpu_torch counts.tsv out --hyper --hypern 2 "
          f"--hyperepoch 1 exited 0 in {res['cli_s']:.1f} s and wrote "
          f"hyperopt_results/trials.pickle (3 trials) and best.json")
    shutil.rmtree(work)
    return res


def _diag_samples():
    """The samples of tests/test_diagnostics.py: a ZINB sample, a
    zero-inflated NB sample, and NB counts without and with extra zeros."""
    rs = np.random.RandomState(1)
    y = rs.negative_binomial(2.0, 2.0 / 6.0, size=5000)
    y = np.where(rs.uniform(size=y.shape) < 0.3, 0, y).astype(np.float32)
    rs = np.random.RandomState(2)
    y_zi = rs.negative_binomial(2.0, 2.0 / 6.0, size=3000)
    y_zi = np.where(rs.uniform(size=y_zi.shape) < 0.4, 0, y_zi).astype(np.float32)

    def sim(pi, n=2000, g=200, seed=5):
        rs = np.random.RandomState(seed)
        mu = rs.gamma(3.0, 1.5, size=(1, g))
        c = rs.negative_binomial(2.0, 2.0 / (2.0 + mu), size=(n, g))
        if pi > 0:
            c = np.where(rs.uniform(size=c.shape) < pi, 0, c)
        return c.astype(np.float32)

    return y, y_zi, sim(0.0), sim(0.35)


def _zero_model_loss(mu, dropout, a, b, t):
    """optimize_zinb's objective in float64 at (a, b, t)."""
    mu, dropout = mu.astype(np.float64), dropout.astype(np.float64)
    pi = 1.0 / (1.0 + np.exp(-(np.log(mu + 1e-7) * a + b)))
    pred = pi + (1.0 - pi) * (t / (mu + t)) ** t
    return float(-np.mean(dropout * np.log(pred + 1e-7)
                          + (1.0 - dropout) * np.log(1.0 - pred + 1e-7)))


def phase_diagnostics(dev, card):
    """Phase 12 (d): ``fit_zinb``, ``zero_inflation_test`` and
    ``optimize_zinb`` on the samples of tests/test_diagnostics.py on the card
    and on the CPU: within the CPU tests' tolerances of each other, and the
    test file's assertions on the card's; each timed."""
    import torch

    from dca_tpu_torch import diagnostics as dg

    y, y_zi, nb_counts, zi_counts = _diag_samples()
    cpu = torch.device("cpu")
    res = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn(dev)
        res[name + "_s"] = time.perf_counter() - t0
        return out, fn(cpu)

    fit, fit_cpu = timed("fit_zinb", lambda d: dg.fit_zinb(y, maxiter=1500, device=d))
    _check(abs(fit["mu"] - 4.0) / 4.0 < 0.15 and abs(fit["pi"] - 0.3) < 0.1
           and abs(fit["theta"] - 2.0) / 2.0 < 0.5, f"phase 12 (d): fit_zinb {fit}")
    for k, rtol in (("mu", DIAG_PARAM_RTOL), ("theta", DIAG_PARAM_RTOL),
                    ("pi", DIAG_PARAM_RTOL), ("nll", DIAG_NLL_RTOL)):
        _check(abs(fit[k] - fit_cpu[k]) <= rtol * abs(fit_cpu[k]),
               f"phase 12 (d): fit_zinb {k} {fit[k]!r} on the card, {fit_cpu[k]!r} on the CPU")
    zi, zi_cpu = timed("zero_inflation_test",
                       lambda d: dg.zero_inflation_test(y_zi, maxiter=1200, device=d))
    _check(zi["pvalue"] < 0.01, f"phase 12 (d): zero_inflation_test {zi}")
    log_d = abs(np.log(zi["pvalue"]) - np.log(zi_cpu["pvalue"]))
    res["pvalue_rel"] = abs(zi["pvalue"] - zi_cpu["pvalue"]) / zi_cpu["pvalue"]
    _check(log_d <= pvalue_log_tol(zi_cpu, y_zi.size),
           f"phase 12 (d): p-value {zi['pvalue']!r} on the card, {zi_cpu['pvalue']!r} on "
           f"the CPU: log distance {log_d:.3e} beyond {pvalue_log_tol(zi_cpu, y_zi.size):.3e}")
    fits = {}
    for label, c in (("nb", nb_counts), ("zi", zi_counts)):
        mu, dropout = c.mean(0), (c == 0).mean(0)
        theta = dg.estimate_theta_moments(c)
        got, want = timed(f"optimize_zinb_{label}",
                          lambda d: dg.optimize_zinb(mu, dropout, theta=theta, device=d))
        close = all(abs(g - w) <= DIAG_PARAM_RTOL * abs(w) for g, w in zip(got, want))
        obj, obj_cpu = (_zero_model_loss(mu, dropout, *p) for p in (got, want))
        _check(close or abs(obj - obj_cpu) <= DIAG_OBJ_RTOL * obj_cpu,
               f"phase 12 (d): optimize_zinb ({label}) {got} on the card, {want} on the CPU, "
               f"objective {obj!r} against {obj_cpu!r}")
        fits[label] = float(dg.sigmoid(np.log(np.median(mu) + 1e-7) * got[0] + got[1]))
        res[f"optimize_zinb_{label}"] = {"card": got, "cpu": want, "params_close": close,
                                         "objective_rel": abs(obj - obj_cpu) / obj_cpu}
    _check(fits["zi"] > 0.1 and fits["nb"] < 0.05 and fits["zi"] > fits["nb"] + 0.08,
           f"phase 12 (d): fitted pi {fits}")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        res["plots"] = "not run: no matplotlib on this machine"
    else:
        from dca_tpu_torch.data.adata import AnnData

        ret_zi = dg.plot_mean_dropout(AnnData(zi_counts), device=dev)
        ret_nb = dg.plot_mean_dropout(AnnData(nb_counts), device=dev)
        _check(ret_zi["pvalue"] < 0.01 and ret_zi["zinb_ll"] < ret_zi["nb_ll"]
               and ret_zi["nb_ll"] - ret_zi["zinb_ll"] > ret_nb["nb_ll"] - ret_nb["zinb_ll"],
               f"phase 12 (d): plot_mean_dropout {ret_zi} / {ret_nb}")
        res["plots"] = "plot_mean_dropout's assertions held"
    print(f"phase 12 (d) on {card}: fit_zinb {fit} (CPU {fit_cpu}) in {res['fit_zinb_s']:.2f} "
          f"s; zero_inflation_test p {zi['pvalue']:.4e} (CPU {zi_cpu['pvalue']:.4e}, rel "
          f"{res['pvalue_rel']:.2e}) in "
          f"{res['zero_inflation_test_s']:.2f} s; optimize_zinb nb {res['optimize_zinb_nb']} "
          f"in {res['optimize_zinb_nb_s']:.2f} s, zi {res['optimize_zinb_zi']} in "
          f"{res['optimize_zinb_zi_s']:.2f} s; fitted pi {fits}; plots: {res['plots']}")
    return res


def make_grouped_counts(n_cells=600, n_genes=120, seed=42, dropout=0.35):
    """tests/test_quality.py's generator, copied (that file imports the JAX
    package): two cell groups with differential genes and dropout."""
    rs = np.random.RandomState(seed)
    n_half = n_cells // 2
    base = rs.gamma(2.0, 1.0, size=(1, n_genes))
    de = np.ones((2, n_genes))
    de_genes = rs.choice(n_genes, n_genes // 4, replace=False)
    de[0, de_genes[: len(de_genes) // 2]] = 5.0
    de[1, de_genes[len(de_genes) // 2:]] = 5.0
    groups = np.repeat([0, 1], [n_half, n_cells - n_half])
    depth = rs.lognormal(0.0, 0.3, size=(n_cells, 1))
    mu = base * de[groups] * depth * 3.0
    theta = 2.0
    true_counts = rs.negative_binomial(theta, theta / (theta + mu)).astype(np.float32)
    drop = rs.uniform(size=true_counts.shape) < dropout
    noisy = np.where(drop, 0.0, true_counts).astype(np.float32)
    noisy[:, noisy.sum(0) == 0] += 1.0
    noisy[noisy.sum(1) == 0, 0] += 1.0
    return noisy, true_counts, groups


def silhouette_score(X, labels):
    """sklearn.metrics.silhouette_score (Euclidean), in numpy: the card's
    machine may lack sklearn."""
    X = np.asarray(X, np.float64)
    labels = np.asarray(labels)
    d = np.sqrt(np.maximum(np.square(X).sum(1)[:, None] + np.square(X).sum(1)[None, :]
                           - 2.0 * X @ X.T, 0.0))
    np.fill_diagonal(d, 0.0)
    ids = np.unique(labels)
    sums = np.stack([d[:, labels == k].sum(1) for k in ids], 1)
    sizes = np.array([(labels == k).sum() for k in ids], np.float64)
    own = np.searchsorted(ids, labels)
    n_own = sizes[own]
    a = sums[np.arange(len(X)), own] / np.maximum(n_own - 1.0, 1.0)
    means = sums / sizes
    means[np.arange(len(X)), own] = np.inf
    b = means.min(1)
    s = np.where(n_own > 1, (b - a) / np.maximum(a, b), 0.0)
    return float(s.mean())


def pca(X, n_components=10):
    """The projection onto the top principal components by an exact SVD
    (sklearn's PCA takes its randomized solver at 600 x 120, whose
    silhouettes are within 2e-3 of these: tests/test_torch_quality.py)."""
    X = np.asarray(X, np.float64)
    Xc = X - X.mean(0)
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    return Xc @ vt[:n_components].T


def _sil(X, labels):
    """sklearn's silhouette_score where it imports, else this file's."""
    try:
        from sklearn.metrics import silhouette_score as sk_silhouette
    except ImportError:
        return silhouette_score(X, labels)
    return float(sk_silhouette(X, labels))


def _silhouette(X, groups):
    """tests/test_quality.py's silhouette of PCA(log1p X) (sklearn's PCA
    where it imports, else this file's)."""
    Xl = np.log1p(X)
    try:
        from sklearn.decomposition import PCA
    except ImportError:
        return _sil(pca(Xl), groups)
    return _sil(PCA(n_components=10, random_state=0).fit_transform(Xl), groups)


def phase_quality(dev, card):
    """Phase 12 (e): tests/test_quality.py's two checks through the port's
    ``dca()`` on the card, at their sizes, seeds and thresholds, then one
    case of ``simulation_grid`` through ``to_anndata`` and ``dca()``."""
    import pandas as pd

    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.data.simulate import simulation_grid, to_anndata

    try:
        import sklearn  # noqa: F401
        res = {"silhouette_by": "sklearn"}
    except ImportError:
        res = {"silhouette_by": "numpy, exact PCA (no sklearn on this machine)"}
    noisy, true_counts, groups = make_grouped_counts()
    adata = AnnData(noisy.copy(), pd.DataFrame(index=[f"c{i}" for i in range(noisy.shape[0])]),
                    pd.DataFrame(index=[f"g{i}" for i in range(noisy.shape[1])]))
    t0 = time.perf_counter()
    ret = dca_tpu_torch.dca(adata, mode="denoise", ae_type="zinb-conddisp", copy=True,
                            epochs=80, verbose=False, random_state=0, device=dev)
    res["denoise_s"] = time.perf_counter() - t0
    sil = {"noisy": _silhouette(noisy, groups), "denoised": _silhouette(ret.X, groups),
           "true": _silhouette(true_counts, groups)}
    res["silhouettes"] = sil
    _check(sil["denoised"] > sil["noisy"] + 0.15 and sil["denoised"] > 0.8 * sil["true"],
           f"phase 12 (e): silhouettes {sil}: the denoised matrix must exceed the noisy one "
           "by 0.15 and 0.8 of the true one (tests/test_quality.py)")
    noisy, _, groups = make_grouped_counts(seed=7)
    t0 = time.perf_counter()
    ret = dca_tpu_torch.dca(AnnData(noisy.copy()), mode="latent", copy=True, epochs=80,
                            verbose=False, random_state=0, device=dev)
    res["latent_s"] = time.perf_counter() - t0
    res["latent"] = _sil(ret.obsm["X_dca"], groups)
    _check(res["latent"] > 0.06, f"phase 12 (e): latent silhouette {res['latent']} not above "
                                 "0.06 (tests/test_quality.py)")
    name, sim = next((n, s) for n, s in simulation_grid() if n == "sim-drop3-group2")
    t0 = time.perf_counter()
    ret = dca_tpu_torch.dca(to_anndata(sim), mode="denoise", ae_type="zinb-conddisp", copy=True,
                            epochs=80, verbose=False, random_state=0, device=dev)
    res["grid_s"] = time.perf_counter() - t0
    res["grid"] = {"case": name, "noisy": _silhouette(sim.counts, sim.groups),
                   "denoised": _silhouette(ret.X, sim.groups),
                   "true": _silhouette(sim.true_counts, sim.groups)}
    print(f"phase 12 (e) on {card}: silhouettes by {res['silhouette_by']}: noisy "
          f"{sil['noisy']:.4f}, denoised {sil['denoised']:.4f}, true {sil['true']:.4f} "
          f"(600 x 120, 80 epochs, {res['denoise_s']:.2f} s); latent {res['latent']:.4f} "
          f"({res['latent_s']:.2f} s); {name} ({sim.counts.shape[0]} x {sim.counts.shape[1]}, "
          f"80 epochs, {res['grid_s']:.2f} s): noisy {res['grid']['noisy']:.4f}, denoised "
          f"{res['grid']['denoised']:.4f}, true {res['grid']['true']:.4f}")
    return res


# ---------------------------------------------------------------------------
# phase 13: the whole fit on the device (compiled=True)
# ---------------------------------------------------------------------------

COMPILED_DROPOUT = 0.1
COMPILED_EPOCHS = 5
COMPILED_STOP = dict(epochs=300, early_stop=2, reduce_lr=0, learning_rate=0.01)
DP_COMPILED_CELLS = 2720  # 2448 train and 272 validation rows: no padding on 2 or 4 ranks


def graph_if_graph(dev, n_nodes):
    """A CUDA graph of ``n_nodes`` IF nodes (``ops/conditional.py``), each
    read from one ``stop`` flag and each with a body that adds 1 to its
    own element of ``counts``.  Returns (graph, stop, counts)."""
    import torch

    from dca_tpu_torch.ops.conditional import if_body
    from dca_tpu_torch.ops import counters
    from dca_tpu_torch.train.graphs import _own_stream

    stop = torch.zeros(1, dtype=torch.bool, device=dev)
    counts = torch.zeros(n_nodes, device=dev)
    stream, inner = _own_stream(dev), _own_stream(dev, "body")
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    with counters.capturing(stream.cuda_stream), counters.capturing(inner.cuda_stream):
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            for i in range(n_nodes):
                with if_body(stop, stream, inner, pool):
                    counts[i:i + 1].add_(1.0)
    return graph, stop, counts


def phase_graph_if(dev):
    """The kernel that sets the IF node's condition (``csrc/graph_if.cu``)
    against its plain version (``conditional.if_reference``): over replays
    with ``stop`` false, true and false again, each body runs exactly where
    the plain condition is true (every count equal, error 0).  Then its
    time: the median replay of a graph of 100 IF nodes with ``stop`` set
    (each the kernel and a skipped body) over 100, against a graph of 100
    ``torch.logical_not`` of the flag (the plain version) over 100, in
    turns.  Returns {max_abs_err, ms, plain_ms, bound_ms, bound_by}."""
    import torch

    from dca_tpu_torch.ops.conditional import if_reference

    graph, stop, counts = graph_if_graph(dev, 3)
    want = torch.zeros_like(counts)
    for flag in (False, True, False, True, True):
        stop.fill_(flag)
        graph.replay()
        want += if_reference(stop).float()
    torch.cuda.synchronize()
    err = float((counts - want).abs().max())
    _check(err == 0.0, f"phase 1: the IF nodes ran {counts.tolist()} times, the plain "
                       f"condition {want.tolist()}")

    n = 100
    graph, stop, counts = graph_if_graph(dev, n)
    stop.fill_(True)
    out = torch.empty(1, dtype=torch.bool, device=dev)
    plain = torch.cuda.CUDAGraph()
    with torch.cuda.graph(plain):
        for _ in range(n):
            torch.logical_not(stop, out=out)

    def timed(g):
        for _ in range(5):
            g.replay()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(N_TIMED)]
        torch.cuda._sleep(50_000_000)
        for s, e in events:
            s.record()
            g.replay()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events])) / n

    times = {True: [], False: []}
    for kernel in IN_TURNS:
        times[kernel].append(timed(graph if kernel else plain))
    torch.cuda.synchronize()
    _check(float(counts.sum()) == 0.0, "phase 1: a body ran with stop set")
    bound_ms, bound_by = _bound_ms(1, 1)  # one byte read, one comparison
    res = {"max_abs_err": err, "ms": float(np.median(times[True])),
           "plain_ms": float(np.median(times[False])), "bound_ms": bound_ms,
           "bound_by": bound_by}
    print(f"phase 1: graph_if (the IF node's condition) the plain condition's over 5 replays "
          f"of 3 nodes; {res['ms'] * 1e3:.2f} us a node with its body skipped against "
          f"{res['plain_ms'] * 1e3:.2f} us a plain logical_not (medians of {N_TIMED} replays of "
          f"{n}, in turns)")
    return res


def _compiled_fit(adata, state, ae_type, graphs=True, compiled=True, **kw):
    """``train()`` of ``ae_type`` 64-32-64 at dropout 0.1 on the card from
    ``state``; returns (History, launches of K1/K2 and graph_if, network)."""
    import torch

    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.ops import conditional
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                               hidden_dropout=COMPILED_DROPOUT, device="cuda").build()
    net.model.load_state_dict(state)
    fl.reset_launches()
    conditional.reset_launches()
    kw.setdefault("epochs", COMPILED_EPOCHS)
    hist = train(adata, net, verbose=False, compiled=compiled, _graphs=graphs, **kw)
    torch.cuda.synchronize()
    launches = {**fl.launches, **conditional.launches}
    return hist, launches, net


def _state_of(net):
    return {k: v.detach().clone() for k, v in net.model.state_dict().items()}


def phase_compiled(dev, card):
    """Phase 13: the whole fit on the device (``train(compiled=True)``,
    ``train/compiled.py``), zinb-conddisp and nb-conddisp 64-32-64 at
    2730 x 3451, batch 32, 10% validation, RMSprop, dropout 0.1 (module
    docstring).  Returns the numbers the result lines print."""
    import torch

    from dca_tpu_torch.models.network import get_ae_type

    adata = _prepped_paul15()
    steps = _steps(adata.n_obs)
    res = {"launches": {}, "capture_s": {}}
    for ae_type in ("zinb-conddisp", "nb-conddisp"):
        lk = ae_type.split("-")[0]
        state = _state_of(get_ae_type(ae_type)(input_size=adata.n_vars,
                                                hidden_size=(64, 32, 64), device=dev).build())
        # (a) the graph against the same fit from Python on the card, and
        # (e) the graph fit's launches: each epoch run's, and the warm-up's
        graph, launches, g_net = _compiled_fit(adata, state, ae_type)
        eager, _, e_net = _compiled_fit(adata, state, ae_type, graphs=False)
        _check(graph.fit is not None and graph.capture_s is not None,
               f"phase 13 {ae_type}: the fit did not run the whole-fit graph")
        _check(graph.history == eager.history and graph.fit.epochs_run == eager.fit.epochs_run
               == COMPILED_EPOCHS and _same_state(g_net, e_net),
               f"phase 13 {ae_type}: the graph fit {graph.history} is not the bits of the "
               f"same fit from Python {eager.history}")
        want = _want_launches(lk, COMPILED_EPOCHS + 1, steps)  # + the warm-up epoch
        want["graph_if"] = COMPILED_EPOCHS
        _check(launches == want, f"phase 13 {ae_type}: launches {launches}, expected {want}")
        res["launches"][ae_type] = launches
        res["capture_s"][ae_type] = graph.capture_s
        # (b) the Python-epoch loop's graph fit: the same row orders and
        # steps, and no callback fires in 5 epochs
        loop, _, l_net = _compiled_fit(adata, state, ae_type, compiled=False)
        same = _same_state(g_net, l_net)
        worst = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                    for a, b in zip(_state_of(g_net).values(), _state_of(l_net).values())
                    if a.is_floating_point())
        _check(same or worst <= 1e-6, f"phase 13 {ae_type}: final parameters {worst:.3e} "
               "from the Python-epoch loop's graph fit, beyond rtol 1e-6")
        _check(graph.history["val_loss"] == loop.history["val_loss"]
               and np.allclose(graph.history["loss"], loop.history["loss"], rtol=1e-6, atol=0),
               f"phase 13 {ae_type}: history {graph.history} vs the loop's {loop.history}")
        print(f"phase 13: {ae_type} {COMPILED_EPOCHS} epochs compiled=True: the graph fit the "
              f"bits of the same fit from Python (histories, {COMPILED_EPOCHS} epochs run, "
              f"final parameters); against the Python-epoch loop's graph fit: parameters "
              f"{'the same bits' if same else f'within {worst:.2e}'}, val_loss the same bits, "
              f"loss within rtol 1e-6 (float32 against float64 sums); capture "
              f"{graph.capture_s:.2f} s; launches {launches}")
        if ae_type != "zinb-conddisp":
            continue
        # (c) an early stop: the same epochs as from Python, NaN past them
        stop_g, stop_launches, sg_net = _compiled_fit(adata, state, ae_type, **COMPILED_STOP)
        stop_e, _, se_net = _compiled_fit(adata, state, ae_type, graphs=False, **COMPILED_STOP)
        n_run = stop_g.fit.epochs_run
        _check(n_run < COMPILED_STOP["epochs"] and n_run == stop_e.fit.epochs_run
               and stop_g.history == stop_e.history
               and _same_state(sg_net, se_net),
               f"phase 13: the early-stopped graph fit ran {n_run} epochs {stop_g.history}, "
               f"from Python {stop_e.fit.epochs_run} {stop_e.history}")
        _check(bool(np.isnan(stop_g.fit.loss[n_run:]).all()
                    and np.isnan(stop_g.fit.val_loss[n_run:]).all()),
               "phase 13: history written past the early stop")
        want = _want_launches(lk, n_run + 1, steps)
        want["graph_if"] = COMPILED_STOP["epochs"]
        _check(stop_launches == want, f"phase 13: early-stopped fit launches {stop_launches}, "
                                      f"expected {want} (the epochs run and the warm-up)")
        res["stop"] = {"epochs_run": n_run, "epoch_ms": float(np.median(stop_g.epoch_s)) * 1e3,
                       "after_stop_us": float(np.median(stop_g.fit.after_stop_s)) * 1e6,
                       "all_after_stop_ms": float(np.sum(stop_g.fit.after_stop_s)) * 1e3,
                       "enqueue_ms": stop_g.fit.enqueue_s * 1e3, "launches": stop_launches}
        print(f"phase 13: early_stop=2 over 300 epochs (lr 0.01): stopped after {n_run} epochs, "
              f"the same as from Python, the same bits, NaN past the stop; an epoch "
              f"{res['stop']['epoch_ms']:.2f} ms, an epoch after the stop "
              f"{res['stop']['after_stop_us']:.2f} us ({300 - n_run} of them "
              f"{res['stop']['all_after_stop_ms']:.2f} ms in all, device time between the "
              f"replays' events); the host enqueued the 300 replays in "
              f"{res['stop']['enqueue_ms']:.2f} ms; on {card}; launches {stop_launches}")
        # (d) the state the fit hands save_weights: the best epoch's, the
        # bits of the same fit cut at that epoch
        best = int(np.argmin(stop_g.history["val_loss"]))
        saved = {}
        net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                   hidden_dropout=COMPILED_DROPOUT, device=dev).build()
        net.model.load_state_dict(state)
        net.save_weights = lambda path: saved.update(_state_of(net))
        from dca_tpu_torch.train.loop import train

        out = os.path.join(OUT_DIR, "compiled-weights")
        hist = train(adata, net, verbose=False, compiled=True, save_weights=True,
                     output_dir=out, **COMPILED_STOP)
        cut, _, c_net = _compiled_fit(adata, state, ae_type,
                                      **dict(COMPILED_STOP, epochs=best + 1))
        _check(hist.history == stop_g.history and _same_state(net, sg_net),
               "phase 13: the save_weights fit is not the early-stopped fit's bits, or the "
               "network did not keep its final state")
        cut_state = c_net.model.state_dict()
        _check(bool(saved) and all(torch.equal(v, cut_state[k]) for k, v in saved.items()),
               f"phase 13: the state handed to save_weights is not epoch {best + 1}'s")
        print(f"phase 13: save_weights=True: the state written is the best epoch's ({best + 1} "
              f"of {n_run}), the bits of the fit cut there, and the network keeps the final "
              f"state; the write took {hist.weights_s[0] * 1e3:.2f} ms")
        shutil.rmtree(out, ignore_errors=True)

    # the compiled epoch against the Python-epoch loop's graph epoch, in turns
    times = {True: [], False: []}
    state = _state_of(get_ae_type("zinb-conddisp")(input_size=adata.n_vars,
                                                   hidden_size=(64, 32, 64), device=dev).build())
    first = []
    for compiled in IN_TURNS:
        hist, _, _ = _compiled_fit(adata, state, "zinb-conddisp", compiled=compiled)
        times[compiled].append(float(np.median(hist.epoch_s[1:])) * 1e3)
        if compiled:
            first.append(hist.epoch_s[0] * 1e3)
    res["epoch_ms"], res["first_epoch_ms"] = times, first
    print(f"phase 13: zinb-conddisp epoch on {card}, {COMPILED_EPOCHS}-epoch fits in turns, the "
          f"median of epochs 2-{COMPILED_EPOCHS} of each: compiled "
          f"{[round(t, 3) for t in times[True]]} ms (device time between the replays; the first "
          f"replay, which uploads the graph, {[round(t, 2) for t in first]} ms), the "
          f"Python-epoch loop's graphs {[round(t, 3) for t in times[False]]} ms (host wall with "
          f"the eager validation and the losses' read-back); medians "
          f"{np.median(times[True]):.3f} against {np.median(times[False]):.3f} ms")

    res["dp_reference"] = dp_compiled_reference()
    return res


def dp_compiled_reference():
    """The one-card history that phase 7 holds its ranks' compiled fit to:
    ``dca()`` zinb-conddisp 64-32-64, ``compiled=True``, 2 epochs on the
    first DP_COMPILED_CELLS cells of phase 4's matrix."""
    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData

    ret = dca_tpu_torch.dca(AnnData(make_paul15_like()[:DP_COMPILED_CELLS].copy()),
                            ae_type="zinb-conddisp", epochs=2, hidden_size=(64, 32, 64),
                            batch_size=32, copy=True, return_info=True,
                            training_kwds={"compiled": True})
    return ret.uns["dca_loss_history"]


NCCL_ONE_EPOCHS = 3  # phase 14's in-memory fits
NCCL_ONE_TURNS = ("captured", "eager", "eager", "captured")  # A, B, B, A


def phase_nccl_one_rank(dev):
    """Phase 14: the sharded step replayed from CUDA graphs under NCCL, on
    the one card: a process group of one rank over NCCL (NCCL allows a
    world of one), in which ``train(devices=make_mesh(1))`` takes the
    sharded step over a mesh of one rank, its collectives NCCL's (a group
    of one rank with ``devices="all"`` is the single-device path).  zinb-conddisp
    64-32-64 at phase 4's 2730 x 3451 (normalized with the z-scale
    deferred) from one seed's weights, NCCL_ONE_EPOCHS epochs in memory,
    captured (the default) and eager (``_graphs=False``) in turns
    (NCCL_ONE_TURNS), then the same fit streamed (parts of
    STREAM_MAX_CELLS, DP_STREAM_EPOCHS epochs, host tier) both ways; and
    the fit with no group's mesh (``devices=None``, the one-card graph
    path) for its epoch.  Held: captured and eager the same bits (the
    histories and the final parameters); a capture recorded under the
    group (``History.capture_s``) and none eager; the K1/K2 launches of
    each fit those of its schedule, the captured ones the no-group graph
    fit's (its warm-ups included).  Returns the launches, capture seconds
    and epoch times."""
    import torch
    import torch.distributed as dist

    from dca_tpu_torch.parallel import multihost
    from dca_tpu_torch.parallel.mesh import make_mesh

    _check(not dist.is_initialized(), "phase 14: a process group is already initialized")
    adata = _lazy_adata(make_paul15_like())
    state = _stream_state(dev, adata.n_vars)
    steps, warm = _steps(2730), _warmups(2730)
    out = {"epoch_ms": {}, "capture_s": {}, "launches": {}}

    def fit(name, **kw):
        hist, launches, net = _stream_fit(dev, adata, state, kw.pop("epochs", NCCL_ONE_EPOCHS),
                                          verbose=False, **kw)
        torch.cuda.synchronize()
        out["epoch_ms"].setdefault(name, []).append([t * 1e3 for t in hist.epoch_s])
        out["capture_s"].setdefault(name, []).append(hist.capture_s)
        out["launches"][name] = launches
        return hist, launches, {k: v.detach().cpu().numpy() for k, v in
                                net.model.state_dict().items()}

    multihost.initialize(f"localhost:{_free_port()}", 1, 0, backend="nccl", device=dev)
    try:
        _check(dist.get_backend() == "nccl", f"phase 14: backend {dist.get_backend()}")
        one, one_launches, _ = fit("no group", devices=None)
        _check(one.capture_s is not None, "phase 14: the no-group fit captured nothing")
        mesh, fits = make_mesh(1), {}
        for turn in NCCL_ONE_TURNS:
            fits[turn] = fit(turn, devices=mesh, _graphs=turn == "captured")
        with _switches(STREAM_TIERS["host"]):
            for turn in ("captured", "eager"):
                fits["streamed " + turn] = fit("streamed " + turn, devices=mesh,
                                               _graphs=turn == "captured",
                                               epochs=DP_STREAM_EPOCHS,
                                               max_device_cells=STREAM_MAX_CELLS)
        out["compiled"] = _nccl_one_compiled(dev, mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for kind in ("", "streamed "):
        (gh, gl, gp), (eh, el, ep) = fits[kind + "captured"], fits[kind + "eager"]
        what = f"phase 14 {kind or 'in memory '}under a one-rank NCCL group"
        _check(gh.capture_s is not None and gh.capture_s > 0 and eh.capture_s is None,
               f"{what}: capture_s {gh.capture_s} captured, {eh.capture_s} eager")
        _check(gh.history == eh.history, f"{what}: captured history {gh.history} is not the "
               f"eager one's {eh.history}")
        _check(all(np.array_equal(gp[k], ep[k]) for k in gp),
               f"{what}: the final parameters differ captured and eager")
        _check(bool(np.isfinite(gh.history["loss"] + gh.history["val_loss"]).all()),
               f"{what}: history {gh.history}")
        if kind:
            want = {t: want_group_stream_launches(DP_STREAM_EPOCHS, 2730, STREAM_MAX_CELLS, 1,
                                                  0, captured=t == "captured")
                    for t in ("captured", "eager")}
        else:
            want = {"captured": _want_launches("zinb", NCCL_ONE_EPOCHS, steps, warm),
                    "eager": _want_launches("zinb", NCCL_ONE_EPOCHS, steps)}
            _check(one_launches == want["captured"], f"phase 14: the no-group graph fit "
                   f"launched {one_launches}, expected {want['captured']}")
        for t, got in (("captured", gl), ("eager", el)):
            _check(got == want[t], f"{what}: {t} launched {got}, expected {want[t]}")
    out["one_rel"] = {k: float(np.max(np.abs(np.asarray(fits["captured"][0].history[k])
                                             - one.history[k]) / np.abs(one.history[k])))
                      for k in ("loss", "val_loss")}
    ms = {k: [[round(t, 2) for t in fit] for fit in v] for k, v in out["epoch_ms"].items()}
    print(f"phase 14: one-rank NCCL group, zinb-conddisp 2730 x 3451: in memory "
          f"{NCCL_ONE_EPOCHS} epochs captured and eager the same bits, launches "
          f"{ {k: v for k, v in out['launches']['captured'].items() if v} } captured, "
          f"{ {k: v for k, v in out['launches']['eager'].items() if v} } eager; capture "
          f"{out['capture_s']['captured']} s; epochs captured {ms['captured']} ms, eager "
          f"{ms['eager']} ms, the no-group graph fit {ms['no group']} ms (capture "
          f"{out['capture_s']['no group']} s; its history from the one-rank mesh's, largest "
          f"relative differences {out['one_rel']}); streamed {DP_STREAM_EPOCHS} epochs, parts "
          f"of {STREAM_MAX_CELLS}: the same bits, capture {out['capture_s']['streamed captured']}"
          f" s, epochs captured {ms['streamed captured']} ms, eager {ms['streamed eager']} ms")
    return out


def _nccl_one_compiled(dev, mesh):
    """Phase 14's whole fit on the device (``compiled=True``) under the
    one-rank NCCL group's ``mesh``: phase 13's zinb-conddisp fit (2730 x
    3451 preprocessed as ``dca()`` does, dropout 0.1) from one seed's
    weights, COMPILED_EPOCHS epochs through the whole-fit graph
    (``GraphFit``: an epoch a replay, its collectives in the graph), the
    same fit with the epochs run from Python (``_graphs=False``) and the
    no-group fit (phase 13's whole-fit graph); then the early-stopped fit
    (COMPILED_STOP) both ways under the group.  Held: the three 5-epoch
    fits the same bits (histories, epochs run, final parameters), a
    capture under the group and none from Python; the early-stopped fits
    the same bits, stopped before their last epoch, NaN past the stop;
    K1/K2 launches those of the epochs run and the warm-up epoch; graph_if
    once a replay without the group, never under it (its graph has no IF
    node: ``GraphFit``), where the replays stop with the fit.  Returns the
    launches, capture seconds and epoch times (device time between the
    replays' events)."""
    from dca_tpu_torch.models.network import get_ae_type

    adata = _prepped_paul15()
    steps = _steps(adata.n_obs)
    state = _state_of(get_ae_type("zinb-conddisp")(input_size=adata.n_vars,
                                                   hidden_size=(64, 32, 64), device=dev).build())
    fits = {"group graph": dict(devices=mesh), "group eager": dict(devices=mesh, graphs=False),
            "no group graph": {}}
    res = {name: _compiled_fit(adata, state, "zinb-conddisp", **kw) for name, kw in fits.items()}
    (gh, gl, gn), (eh, el, en), (oh, ol, on) = res.values()
    what = "phase 14 compiled=True under a one-rank NCCL group"
    _check(gh.fit is not None and gh.capture_s is not None and eh.fit is not None
           and eh.capture_s is None, f"{what}: capture {gh.capture_s} graph, {eh.capture_s} "
                                     "from Python")
    _check(gh.history == eh.history == oh.history
           and gh.fit.epochs_run == eh.fit.epochs_run == oh.fit.epochs_run == COMPILED_EPOCHS
           and _same_state(gn, en) and _same_state(gn, on),
           f"{what}: the graph fit {gh.history} is not the bits of the same fit from Python "
           f"{eh.history} and of the no-group graph fit {oh.history}")
    want = dict(_want_launches("zinb", COMPILED_EPOCHS + 1, steps), graph_if=0)  # + warm-up
    want_one = dict(want, graph_if=COMPILED_EPOCHS)
    want_eager = dict(_want_launches("zinb", COMPILED_EPOCHS, steps), graph_if=0)
    _check(gl == want and ol == want_one and el == want_eager,
           f"{what}: launches {gl} graph, {el} from Python, {ol} without the group; expected "
           f"{want}, {want_eager}, {want_one}")
    sg, sgl, sgn = _compiled_fit(adata, state, "zinb-conddisp", devices=mesh, **COMPILED_STOP)
    se, _, sen = _compiled_fit(adata, state, "zinb-conddisp", devices=mesh, graphs=False,
                               **COMPILED_STOP)
    n_run = sg.fit.epochs_run
    _check(n_run < COMPILED_STOP["epochs"] and n_run == se.fit.epochs_run
           and sg.history == se.history and _same_state(sgn, sen)
           and bool(np.isnan(sg.fit.loss[n_run:]).all())
           and bool(np.isnan(sg.fit.val_loss[n_run:]).all()),
           f"{what}: the early-stopped graph fit ran {n_run} epochs {sg.history}, from Python "
           f"{se.fit.epochs_run} {se.history}")
    want_stop = dict(_want_launches("zinb", n_run + 1, steps), graph_if=0)
    _check(sgl == want_stop and len(sg.epoch_s) == n_run and not sg.fit.after_stop_s,
           f"{what}: early-stopped launches {sgl}, expected {want_stop}; {len(sg.epoch_s)} "
           f"replays timed, {len(sg.fit.after_stop_s)} after the stop")
    out = {"launches": {"5 epochs": gl, "early stop": sgl}, "epochs_run": n_run,
           "capture_s": {"group": gh.capture_s, "no group": oh.capture_s},
           "epoch_ms": {k: [t * 1e3 for t in r[0].epoch_s] for k, r in res.items()}}
    ms = {k: [round(t, 2) for t in v] for k, v in out["epoch_ms"].items()}
    print(f"phase 14: compiled=True under the one-rank NCCL group (zinb-conddisp 2730 x 3451, "
          f"{COMPILED_EPOCHS} epochs): the whole-fit graph the bits of the same fit from Python "
          f"and of the no-group whole-fit graph (histories, epochs run, final parameters); "
          f"early_stop=2 over 300 epochs stopped after {n_run} both ways, NaN past it; launches "
          f"{gl} ({sgl} early-stopped); capture {gh.capture_s:.2f} s under the group, "
          f"{oh.capture_s:.2f} s without; epochs (device time between the replays' events, "
          f"host wall from Python) {ms} ms")
    return out


def _shard_entries(mp_times, name):
    """``mp_shard_timings``' entries of kernel ``name``, for its record."""
    return [dict(zip(("shape", "ms", "plain_ms", "bound_ms", "bound_by"), (list(shape), *t)))
            for (n, shape), t in mp_times.items() if n == name]


def _card():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    _check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main():
    sys.path.insert(0, REPO)
    try:
        import dca_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        if e.name != "dca_tpu_torch":
            raise
        print(f"chip_smoke: no dca_tpu_torch package beside this script in {REPO}; run it "
              "from a checkout of the repo", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = load_parent(sys.argv[2])
    elif len(sys.argv) > 1:
        print("usage: python3 chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    try:
        phase_build()
        worst = phase_compare(dev)
        worst_w = phase_weighted_compare(dev)
        dense_err = phase_dense_compare(dev)
        k5 = phase_optim(dev)
        graph_if = phase_graph_if(dev)
        times = phase_timings(dev, parent)
        times.update(weighted_timings(dev))
        tb_times = tb_k2_timings(dev)
        mp_times = mp_shard_timings(dev)
        dense_times = dense_timings(dev)
        phase_zoo()
        # before any profiler runs (phase 4's TensorBoard fit, phase 11):
        # a torch.profiler session leaves each later launch of the
        # whole-epoch graph milliseconds of host time (PERF.md)
        card = _card()
        t13 = time.perf_counter()
        comp = phase_compiled(dev, card)
        t13 = time.perf_counter() - t13
        launches, zinb_net, zinb_hist, zinb_bits, zinb_tb = phase_api("zinb-conddisp", 5,
                                                                      tensorboard=True)
        nb_launches, nb_net, _, nb_bits, _ = phase_api("nb-conddisp", 2)
        stream_small = phase_stream_small(dev)
        stream_corpus = phase_stream_corpus(dev)
        art = phase_artefacts(dev, card)
        t12 = time.perf_counter()
        hyp = phase_hyper(dev, card)
        diag = phase_diagnostics(dev, card)
        qual = phase_quality(dev, card)
        t12 = time.perf_counter() - t12
        epochs = epoch_timings()
        launches.update({k: v for k, v in nb_launches.items() if k.startswith("nb_")})
        phase_options()
        full_launches = phase_prelu_adam_full()
        opt_epochs = optimizer_epoch_timings()
        nat = phase_native()
        phase_cli()
        den = phase_denoise(zinb_net, nb_net)
        dp = phase_data_parallel(zinb_hist, zinb_tb["histograms"],
                                 single_compiled=comp["dp_reference"],
                                 single_stream=stream_small["dp_reference"])
        mp = phase_model_parallel()
        launched = phase_launch(dp)
        nccl_one = phase_nccl_one_rank(dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    shapes = ", ".join(str(s) for s, _, _ in COMPARE_SHAPES)
    kernels = []
    for fam in ("nb", "zinb"):
        cases = ("theta (B, G), (1, G), (B, 1)" if fam == "nb" else
                 "theta/pi (B, G)/(B, G) at ridge 0 and 0.1, (1, G)/(B, G), "
                 "(B, 1)/(B, 1), (1, G)/(1, G), (B, 1)/(1, G) at ridge 0.1")
        for kind, line, err, tol in (
            ("fwd", 143, worst[fam]["fwd_abs"], f"loss rel err <= {LOSS_RTOL}, count exact"),
            ("bwd", 177, worst[fam]["bwd_abs"],
             f"unscaled grads rtol {GRAD_RTOL}, atol {GRAD_ATOL} + {GRAD_ULPS} ulps "
             "of the terms, summed for broadcast operands"),
        ):
            ms, plain_ms, bound_ms, bound_by, extra = times[f"{fam}_{kind}"]
            name = f"{fam}_nll_{kind}"
            streamed = {"launches_streaming": {
                "phase 10 (a)": stream_small["launches"][name],
                "phase 10 (b)": stream_corpus["launches"][name],
                "phase 7 streamed under the group, per rank": {
                    tier: [r[name] for r in runs]
                    for tier, runs in dp["stream"]["launches"].items()}}}
            if name == "zinb_nll_fwd":
                streamed["validation_chunk"] = stream_corpus["k1_val"]
                streamed["trial_validation"] = hyp["k1_trial_val"]
            streamed["launches_compiled"] = {
                "phase 13 compiled=True, 5 epochs + the warm-up epoch":
                    comp["launches"][f"{fam}-conddisp"][name]}
            streamed["launches_model_parallel"] = {
                f"phase 7 {key}, per rank": [r[name] for r in v["launches"]]
                for key, v in mp.items() if key.startswith(f"{fam}-")}
            streamed["launches_launcher"] = {
                f"phase 7 launched {key}, rank 0": v["launches"][name]
                for key, v in launched.items()}
            if fam == "zinb":
                streamed["launches_nccl_one_rank"] = {
                    f"phase 14 {key}": v[name] for key, v in nccl_one["launches"].items()}
            if fam == "zinb":
                streamed["launches_compiled"]["phase 13 early stop"] = \
                    comp["stop"]["launches"][name]
                streamed["launches_compiled"]["phase 7 compiled, per rank"] = \
                    [r[name] for r in dp["compiled"]]
                for key, v in nccl_one["compiled"]["launches"].items():
                    streamed["launches_compiled"][
                        f"phase 14 compiled under the one-rank NCCL group, {key}"] = v[name]
                streamed["launches_tensorboard"] = {
                    "phase 4 (tensorboard)": zinb_tb["launches"][name],
                    "phase 11": {k: v[name] for k, v in art["launches"].items()}}
                streamed["launches_hyper"] = {
                    "phase 12 (a) trial": hyp["trial_launches"][name],
                    "phase 12 (b) search (4 trials)": hyp["search_launches"][name]}
            if name == "zinb_nll_bwd":
                ms_v, plain_v, bound_v, by_v = tb_times["zinb_bwd"]
                streamed["tensorboard_gradient"] = {
                    "shape": [273, 3451], "ms": ms_v, "plain_ms": plain_v,
                    "bound_ms": bound_v, "bound_by": by_v,
                    "max_err_over_tol": art["tb_k2_tol"]}
            streamed["model_parallel_shapes"] = _shard_entries(mp_times, name)
            kernels.append({**streamed,
                "name": name, "route": "cuda",
                "source": "dca_tpu_torch/csrc/fused_nll.cu",
                "replaces": f"dca_tpu/ops/fused_loss.py:{line}",
                "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "timed_shape": [32, 3451],
                "main_path": "phase 4: dca() zinb-conddisp 5 epochs, nb-conddisp 2, the steps "
                             "replayed from CUDA graphs (each replay's launches counted, and "
                             "the 2 warm-up steps of each fit)",
                "checked_shapes": f"{shapes}; {cases}", "tolerance": tol, "card": card,
                **extra,
            })
    for fam in ("nb", "zinb"):
        dp_launches = dp[f"{fam}-conddisp"]
        for kind, line, err, tol in (
            ("fwd", 158, worst_w[fam]["fwd_abs"],
             f"loss rel err <= {LOSS_RTOL}; total weight exact for 0/1 weights, rel err <= "
             f"{LOSS_RTOL} for fractional ones, 1 for all-zero weights"),
            ("bwd", 191, worst_w[fam]["bwd_abs"],
             f"unscaled grads rtol {GRAD_RTOL}, atol {GRAD_ATOL} + {GRAD_ULPS} ulps of the "
             "weighted terms; exactly 0 on zero-weight rows and at NaN targets"),
        ):
            ms, plain_ms, bound_ms, bound_by, extra = times[f"{fam}_{kind}_w"]
            name = f"{fam}_nll_{kind}_w"
            per_rank = [a[name] + b[name] + c[name]
                        + sum(dp["stream"]["launches"][t][r][name] for t in DP_STREAM_TIERS)
                        for r, (a, b, c) in enumerate(zip(dp_launches, dp["tensorboard"],
                                                          dp["tensorboard_nb"]))]
            entry = {
                "name": name, "route": "cuda", "source": "dca_tpu_torch/csrc/fused_nll.cu",
                "replaces": f"dca_tpu/ops/fused_loss.py:{line}",
                "launches": sum(per_rank), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "launches_per_rank": per_rank,
                "launches_launcher": {f"phase 7 launched {key}, rank 0": v["launches"][name]
                                      for key, v in launched.items()},
                "model_parallel_shapes": _shard_entries(mp_times, name),
                "main_path": f"phase 7: {fam}-conddisp data parallel on {DP_RANKS} ranks",
                "checked_shapes": f"{', '.join(str(sh) for sh, _, _ in WEIGHTED_SHAPES)}; the "
                                  f"theta/pi cases of K1/K2; weights {', '.join(WEIGHT_KINDS)}",
                "tolerance": tol, "card": card, **extra,
            }
            if fam == "zinb" and kind == "fwd":
                entry["main_path"] += (", then the streamed fits under the group (tiers "
                                       f"{', '.join(DP_STREAM_TIERS)}): each rank's block of "
                                       "the padded validation chunk, once an epoch")
            if fam == "nb":
                entry["main_path"] += (f", then nb-conddisp on the first {DP_NB_TB_CELLS} cells "
                                       "with tensorboard=True: the gradient of each rank's "
                                       "padded validation block, once an epoch")
            if kind == "bwd" and fam == "zinb":
                ms_v, plain_v, bound_v, by_v = tb_times["zinb_bwd_w"]
                entry["main_path"] += (", then zinb-conddisp again with tensorboard=True: "
                                       "the gradient of each rank's padded validation block, "
                                       "once an epoch")
                entry["tensorboard_gradient"] = {
                    "shape": [137, 3451], "ms": ms_v, "plain_ms": plain_v,
                    "bound_ms": bound_v, "bound_by": by_v,
                    "grads_rel_same_params": dp["grads_rel_same_params"],
                    "grads_rel_phase4": dp["grads_rel_phase4"]}
            kernels.append(entry)
    kernels.append({
        "name": "rmsprop", "route": "cuda", "source": "dca_tpu_torch/csrc/fused_optim.cu",
        "replaces": "dca_tpu/train/optim.py:rmsprop", "tpu_kernel": None,
        "note": "no TPU kernel: XLA fuses the JAX package's update; here the 11 PyTorch "
                "kernels a leaf of the plain loop in one launch for up to 64 leaves",
        "launches": launches["rmsprop"], "max_abs_err": 0.0,
        "ms": k5["nb-conddisp"]["ms"], "plain_ms": k5["nb-conddisp"]["plain_ms"],
        "bound_ms": k5["nb-conddisp"]["bound_ms"], "bound_by": k5["nb-conddisp"]["bound_by"],
        "library_ms": None, "timed": {k: k5[k] for k in ("nb-conddisp", "zinb-conddisp")},
        "main_path": "phase 4: dca() zinb-conddisp 5 epochs, each step's update (2 warm-ups)",
        "checked": [c[0] for c in RMSPROP_CASES],
        "tolerance": f"the same bits after each of {RMSPROP_STEPS} updates",
        "card": card,
    })
    kernels.append({
        "name": "graph_if", "route": "cuda", "source": "dca_tpu_torch/csrc/graph_if.cu",
        "replaces": "dca_tpu/train/compiled.py:153",
        "tpu_kernel": None,
        "note": "no TPU kernel: the condition of the whole-fit lax.while_loop, set on the "
                "device at every replay of the whole-fit graph",
        "launches": comp["launches"]["zinb-conddisp"]["graph_if"],
        "launches_by_run": {f"phase 13 {k}": v["graph_if"]
                            for k, v in comp["launches"].items()}
                           | {"phase 13 early stop (300 replays)":
                              comp["stop"]["launches"]["graph_if"]}
                           | {f"phase 14 under the one-rank NCCL group, {k}": v["graph_if"]
                              for k, v in nccl_one["compiled"]["launches"].items()},
        "max_abs_err": graph_if["max_abs_err"], "ms": graph_if["ms"],
        "plain_ms": graph_if["plain_ms"], "bound_ms": graph_if["bound_ms"],
        "bound_by": graph_if["bound_by"], "library_ms": None,
        "timed": "a node with its body skipped, in a graph of 100; plain: logical_not",
        "main_path": "phase 13: train(compiled=True) zinb-conddisp 5 epochs",
        "tolerance": "exact: each body runs where the plain condition is true",
        "card": card,
    })
    timings = {f"{name} {act}": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms"), t[:5]), plan=t[5]._asdict())
               for (name, act), t in dense_times.items()}
    for name, entry, shape, kind in (("fused_dense", "head", [2730, 64, 3451], "wide"),
                                     ("fused_dense_encoder", "encoder", [2730, 3451, 64],
                                      "splitk")):
        ms, plain_ms, bound_ms, bound_by, library_ms, plan = dense_times[(entry, "linear")]
        kernels.append({
            "name": name, "route": "cuda", "source": "dca_tpu_torch/csrc/fused_dense.cu",
            "replaces": "dca_tpu/ops/fused_dense.py:63",
            "launches": den[f"forward_{kind}"] + den[f"stream_{kind}"],
            "max_abs_err": dense_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timed_shape": shape, "timed_epilogue": "linear (library: torch.addmm)",
            "plan": plan._asdict(), "timings": timings,
            "launches_by_run": {"forward": den[f"forward_{kind}"],
                                "write_streaming": den[f"stream_{kind}"],
                                "nb_predict": den[f"nb_predict_{kind}"],
                                "payload_forward (phase 10)":
                                    stream_small["k4_payload K4"][kind]},
            "checked_shapes": "; ".join(f"{n} {sh}" for n, sh, *_ in DENSE_CASES),
            "tolerance": "linear: 2 K 2^-24 (|x|@|W| + |b|) |s| + 4 ulps; activations: 4 "
                         "ulps of the plain activation of the kernel's linear output",
            "card": card,
        })
    print(f"per-epoch time (train() 2730 x 3451, zinb-conddisp 64-32-64, batch 32, 3 fits "
          f"of 3 epochs each, in turns) on {card}: graph {epochs['graph']} ms, eager "
          f"{epochs['eager']} ms, medians {np.median(epochs['graph']):.2f} against "
          f"{np.median(epochs['eager']):.2f} ms; capture {epochs['capture']} s; graph "
          f"histories the same bits as eager: zinb-conddisp {zinb_bits}, nb-conddisp {nb_bits}")
    print(f"data-parallel per-epoch time {dp['per_epoch_s'] * 1e3:.1f} ms on rank 0 (the same "
          f"fit on {DP_RANKS} ranks sharing the one card through gloo: no scaling measured) "
          f"on {card}")
    for key, v in mp.items():
        print(f"model-parallel epoch ({key}, 2730 cells, 64-32-64) on {card}: "
              f"{[round(t * 1e3, 1) for t in v['epoch_s']]} ms on rank 0 of {DP_RANKS} "
              f"sharing the card through gloo, against "
              f"{[round(t * 1e3, 1) for t in v['one_card_epoch_s']]} ms on one card (CUDA "
              "graphs)")
    for key, v in launched.items():
        print(f"launched {key} epoch (2730 cells, zinb-conddisp 64-32-64) on {card}: "
              f"{[round(t * 1e3, 1) for t in v['epoch_s']]} ms on rank 0 of {DP_RANKS} "
              f"started by dca() from this process, sharing the card through gloo; group "
              f"formed {v['launch']['group_s']:.2f} s after the call, "
              f"{v['launch']['shared_bytes']} bytes of shared inputs")
    one = stream_small["dp_reference"]["epoch_s"]
    for tier, ep in dp["stream"]["epoch_s"].items():
        print(f"streamed epoch (2730 x 3451 zinb-conddisp, parts of {STREAM_MAX_CELLS}) on "
              f"{card}: {tier} tier under the group {[round(t * 1e3, 1) for t in ep]} ms on "
              f"rank 0 of {DP_RANKS} sharing the card through gloo, against "
              f"{[round(t * 1e3, 1) for t in one]} ms on one card (phase 10 (a), host tier, "
              "CUDA graphs)")
    print(f"denoise tier (2730 x 3451, zinb-conddisp) on {card}: forward "
          f"{den['forward_s_0'] * 1e3:.1f} ms without K4, {den['forward_s_1'] * 1e3:.1f} ms "
          f"with (medians in turns {den['forward_all_s_0']} / {den['forward_all_s_1']} s); "
          f"fetch of its {den['fetch_copies']} outputs {den['fetch_pinned_s'] * 1e3:.2f} ms "
          f"through the page-locked ring against {den['fetch_pageable_s'] * 1e3:.2f} ms "
          f"pageable; at {den['pin_rows']}-row blocks {den['pin_peak_bytes'] / 2**20:.1f} MiB "
          f"page-locked at the peak (the ring {den['pin_ring_bytes'] / 2**20:.1f} MiB), "
          f"resident {(den['pin_rss_peak_bytes'] - den['pin_rss_before_bytes']) / 2**20:.1f} "
          "MiB above the start; write_streaming "
          f"{den['stream_s']:.2f} s native, {den['stream_pandas_s']:.2f} s pandas")
    print(f"native IO tier on {card} ({nat['threads']} OpenMP threads): read_text of the "
          f"3451 x 2730 count TSV {nat['read_native_s']:.3f} s native, "
          f"{nat['read_pandas_s']:.3f} s pandas; format of a 3451 x 2730 float matrix "
          f"{nat['format_native_s']:.3f} s native, {nat['format_pandas_s']:.3f} s pandas")
    print(f"graph epoch (train() 2730 x 3451 zinb-conddisp, 3 fits of 3 epochs each, in turns) "
          f"on {card}: RMSprop {opt_epochs['RMSprop']} ms, Adam {opt_epochs['Adam']} ms, "
          f"medians {np.median(opt_epochs['RMSprop']):.2f} against "
          f"{np.median(opt_epochs['Adam']):.2f} ms; PReLU + Adam dca() launches "
          f"{full_launches['zinb_nll_fwd']}/{full_launches['zinb_nll_bwd']}")
    print(f"artefacts (phase 11, 2730 x 3451 zinb-conddisp, RMSprop) on {card}: a checkpoint "
          f"{art['ckpt_bytes']} bytes, saved in {[round(t * 1e3, 2) for t in art['ckpt_s']]} ms; "
          f"restore {art['restore_s'] * 1e3:.2f} ms; epoch "
          f"{[round(t, 2) for t in art['epoch_ms']]} ms plain, "
          f"{[round(t, 2) for t in art['tb_epoch_ms']]} ms with TensorBoard (profiled) + "
          f"{[round(t, 2) for t in art['tb_log_ms']]} ms of logging")
    print(f"phase 12 on {card} in {t12:.1f} s: a trial of the search (2730 x 3451, 2 epochs) "
          f"{hyp['trial_s']:.3f} s; the search of 4 trials {hyp['search_seq_s']} s sequential, "
          f"{hyp['search_par_s']} s with 2 threads on the one card (sequential over 2 threads "
          f"{hyp['search_ratio']:.3f}); the CLI's search {hyp['cli_s']:.1f} s; diagnostics "
          f"fit_zinb {diag['fit_zinb_s']:.2f} s, zero_inflation_test "
          f"{diag['zero_inflation_test_s']:.2f} s; silhouettes noisy / denoised / true "
          f"{qual['silhouettes']}, latent {qual['latent']:.4f}, {qual['grid']}")
    print(f"phase 13 on {card} in {t13:.1f} s: the whole fit on the device (compiled=True), "
          f"zinb-conddisp epoch {np.median(comp['epoch_ms'][True]):.3f} ms against the "
          f"Python-epoch loop's graph epoch {np.median(comp['epoch_ms'][False]):.3f} ms; capture "
          f"{comp['capture_s']['zinb-conddisp']:.2f} s (zinb-conddisp), "
          f"{comp['capture_s']['nb-conddisp']:.2f} s (nb-conddisp); early stop after "
          f"{comp['stop']['epochs_run']} epochs, an epoch after it "
          f"{comp['stop']['after_stop_us']:.2f} us")
    for tier in ("host", "resident"):
        c = stream_corpus[tier]
        print(f"streaming trainer at {CORPUS[0]} x {CORPUS[1]} ({tier}) on {card}: epochs "
              f"{[round(t, 3) for t in c['epoch_s']]} s, "
              f"{[round(v) for v in c['rows_per_s']]} training rows/s, device memory peak "
              f"{c['peak_bytes'] / 2**30:.2f} GiB (estimate {c['estimate_bytes'] / 2**30:.2f}), "
              f"host RSS peak {c['rss_peak_bytes'] / 2**30:.2f} GiB, main stream busy "
              f"{[round(b, 4) for b in c['busy']]}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
