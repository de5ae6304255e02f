#!/usr/bin/env python3
"""Build the PyTorch port's kernels and drive its main path on one H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing its last line:

1. device: a CUDA card of compute capability 9.0; prints nvidia-smi's
   name and power limit;
2. build: compiles ode_rl_torch/csrc with nvcc into build/ode_rl_torch/
   and loads it; prints the build seconds and ptxas' register use;
3. kernels: K1 (forward and as dx), K2, K3 and K4 against their plain
   PyTorch versions at the flagship shapes (B=128), in fp32 and bf16, with
   TF32 off, and the autograd Functions' gradients against autograd of the
   plain versions. In bf16 both K1 kernels (tensor-core and SIMT) and the
   plain version, forward and as dx, against the fp64 conv of the same
   inputs rounded to bf16: every output within one bf16 ulp, and the share
   one ulp off within its limit; the tensor-core K1 bit-equal over 20 calls;
   the two K1 kernels and cuDNN timed in one run (CUDA events and device
   time under torch.profiler). Likewise K2 in bf16: both K2 kernels and
   cuDNN's weight gradient against the fp64 patches^T . g of the same
   inputs (relative L2), the tensor-core K2 bit-equal over 20 calls, the
   three timed in one run. Likewise K3 and K4 in bf16: the one-sample
   kernels, the two-pass kernels and the plain versions against the Pallas
   formula in fp64 on the same inputs (one bf16 ulp for the kernels), the
   one-sample kernels bit-equal over 20 calls, the three timed in one run;
   and the device time and launches of one K3 and one K4 backward
   (autograd of the plain formula). The host time a call of the K1-K4
   wrappers at B=1: tensor-core and SIMT, one-sample and two-pass. Then
   K5-K7 (correlation forward and its two gradients)
   at the FlowNetC bench shape (features (256, 8, 8, 256), d=20, stride 2)
   and the FlyingChairs feature shape (8, 48, 64, 256), in fp32 and bf16
   (bf16 SIMT K6 and K7 bit-equal to their plain versions, K5 and the
   tensor-core K6 and K7 to 1e-4 relative L2; every SIMT call 20 times
   bit-equal to the first); each shape and dtype
   routed as tc_plan says (the bench shape in bf16 to the tensor-core
   K5-K7, the rest to SIMT). At the bench shape in bf16 the tensor-core
   K5-K7, the SIMT ones and the plain versions against fp64 of the same
   inputs (one bf16 ulp), the tensor-core kernels bit-equal over 20 calls,
   the three timed in one run, and the host time a call at B=1. K8
   (channelnorm) at FlowNet2's (8, 64, 64, 3) and (8, 64, 64, 2), in fp32
   and bf16, bit-equal to the plain version, and in fp32 timed in one run
   at each shape with two controls on its grid (an empty kernel, the
   launch floor, and one that reads the same bytes and writes one value a
   pixel), the plain version and torch.linalg.vector_norm; the wrapper's
   host time a call. CorrelationFn's gradients against
   fp64 autograd in fp32 and, at the bench shape, in bf16 (the
   tensor-core K6 and K7 through autograd), and ChannelNormFn's; prints
   each error beside its tolerance, the median time of each kernel and its
   plain version (CUDA events) and K5-K8's device time a call;
4. slice: ten fused training steps of the flagship configuration (bf16,
   B=128, 10 -> 10 frames, dopri5 'fast') from the port's own init, seed 0;
   every loss and grad_norm finite, every kernel's launch count above
   zero over these steps, every K1 and K2 launch a tensor-core one, and
   every K3 and K4 launch a one-sample one;
5. reference: one fp32 step at B=8 through the kernels (every K1 and K2
   launch a SIMT one, as fp32 is; K3 and K4 on their one-sample kernels)
   against the same
   step on the plain versions (same weights, same batch): equal NFE and
   accepted/rejected counts, loss to 1e-5 relative, every gradient leaf to
   1e-3 relative L2;
6. FlowNetC: ten fused training steps of FlowNetCBenchConfig (bf16,
   B=256, synthetic chairs made on the card, multiscale L1), seed 0; every
   loss, EPE and grad_norm finite, K5-K7 launched in these steps, and
   every K5, K6 and K7 launch a tensor-core one;
7. FlowNet2: three single-scale L1 steps of the stacked FlowNet2
   (FlowNet2Config, fp32, B=8); finite, K5-K8 launched in these steps,
   and no launch of a tensor-core K5-K7 (fp32 stays on SIMT);
8. FlowNet reference: one fp32 FlowNetC step at B=8 through the kernels
   against the same step on the plain versions: loss to 1e-5 relative,
   every gradient leaf to 1e-3 relative L2;
9. recipe: the port's own entry point, ``ode_rl_torch.main.main``, on
   ``defaults`` + ``train_mmnist_odecgru_len20_1ch`` at full width (fp32,
   B=4, 64 channels, 3 ODE layers, dopri5 'scan' with remat), on a frozen
   corpus of 100-frame videos written from the port's generator into a
   temporary directory: 20 training steps (checkpoints at 10 and 20),
   every logged loss and grad_norm finite, K1-K4 launched, every K1/K2
   launch a SIMT one and every K3/K4 launch a one-sample one; then the
   test block, 10 -> 90 frames from the step-20 checkpoint over 2 batches,
   90 finite MSE, PSNR and SSIM values in per_horizon.json, and the
   metric-vs-horizon plot beside it (metrics_vs_horizon.json equal to
   per_horizon.json, the PNG 1320 x 330: three panels); then one recipe
   step on a frozen batch with the trained weights through the kernels
   (profiled: device time a launch of K1-K4, every K1 and K2 launch in the
   trace one of the SIMT kernels) against the same step on the plain
   versions (equal NFE and accepted/rejected counts, loss to 1e-5 relative,
   every gradient leaf to 1e-3 relative L2); and K1's SIMT kernel (forward
   and as dx) and K2's at the recipe's fp32 shape (4, 16, 16, 64) against
   fp64 (1e-4 max abs, 1e-5 relative L2), bit-equal over 20 calls, timed in
   one run with their plain versions and cuDNN's fp32 conv and weight
   gradient. Prints step_ms (median over steps 2-20) and the mean NFE.
   (An older checkout's SIMT kernels are timed beside these by
   ``python -m ode_rl_torch.simt_conv_times`` run from both checkouts.)
10. recurrent family: ``ode_rl_torch.main`` on each of ``defaults`` +
   ``train_mmnist_cgru_len20`` (ConvGRU), ``train_mmnist_cgrudecODE``,
   ``train_mmnist_odecgrumem_len20_1ch`` (nru),
   ``train_mmnist_odecgrumem2_len20_1ch`` (nru2) and
   ``train_mmnist_sample_odecgru`` (sampled z0, KL term, nan_guard) at
   their own widths and frames (fp32, B=4), 10 steps each on a frozen
   corpus with 200-frame test videos: every logged loss and grad_norm
   finite, a checkpoint at step 10; ConvGRU launches K3 and K4 and no K1
   or K2, the others K1-K4 with every K1/K2 launch a SIMT one; every
   K3/K4 launch a one-sample one. Then ``test_mmnist_cgru_len20`` (10 ->
   190: 190 finite values of each metric) and
   ``test_mmnist_odecgrumem_len20_1ch`` (10 -> 90; it says n_ode_layers
   2 and builds the train run's 3 from the saved config, as JAX does);
   one step of each block from its initial weights through the kernels
   (profiled: device ms and busy share) against the same step on the
   plain versions,
   with the same batch and z0 noise (equal stats, loss 1e-5 relative,
   prediction 1e-4 max abs, every gradient leaf 1e-3 relative L2; the
   sampled block with its KL term on the leaves that term does not reach,
   then with its KL weight at 0 on every leaf, see
   ``_recurrent_reference``); ``--configs defaults`` alone for two steps
   (ConvGRU at 256 channels: K3 at (4, 16, 16, 512) in 16 groups and K4
   at (4, 16, 16, 256) in 8, their ``sample_plan`` printed and each held
   to its plain version, 1e-5 max abs); and the recipe with the z0
   encoder's hoisted projections off and on, 5 steps each way in the
   turns off, on, on, off (step_ms and device ms; each turn's losses
   held to the first's, 1e-5 relative). Prints each block's
   median step_ms over steps 2-10 and mean NFE.
11. S3VAE family: ``ode_rl_torch.main`` on each of its 13 train blocks
   (``defaults`` + ``train_mmnist_{recon,extrap}_s3vae``,
   ``{recon,extrap}_cs3vae``, ``s3vae_odecgru``, ``s3vaeode``,
   ``{recon,extrap}_s4vae``, ``{recon,extrap}_cs4vae``, ``recon_rims4vae``,
   ``recon_cgrurims3vae``, ``recon_rimconvs4vae``) at their own widths and
   frames (fp32, B=4), 4 steps each on the frozen corpus with 200-frame
   test videos, with TF32 turned on before each call and ``main`` turning
   it off: the eight S3VAE metrics, loss and grad_norm finite at every
   step, a checkpoint at step 4 whose BatchNorm buffers all moved; the
   'default' blocks launch none of K1-K4, 'cgru', 'cgru_sa' and
   'cgru_rim' K3 and K4 (one-sample) and no K1/K2, 'odecgru' K1-K4 with
   every K1/K2 launch a SIMT one; median step_ms over steps 2-4 and the
   rollout's NFE. Then ``test_mmnist_recon_s3vae``, ``_cs3vae``,
   ``_cs4vae`` and ``_rims4vae`` (20 -> 180, one batch: 200 finite values
   of each metric) from their train runs' checkpoints; one step of
   ``recon_cs3vae``, ``s3vae_odecgru`` and ``recon_cs4vae`` from the seed's
   weights through the kernels (profiled) against the same step under
   ``force_plain()`` with the same weights, buffers, batch and noise (loss
   1e-5 relative, prediction 1e-4 max abs, every gradient leaf within 1e-3
   of its norm plus 1e-5 of the whole norm, BatchNorm buffers 1e-5, equal
   NFE); and K1/K2 at (4, 4, 4, 32->64) and (4, 4, 4, 128->64), K3/K4 at
   (12, 4, 4, 128), (12, 8, 8, 512) and (4, 4, 4, 256) alone against their
   plain versions, each with its route, device µs and bound.
12. Vid-ODE family: ``ode_rl_torch.main`` on ``defaults`` +
   ``train_mmnist_vidode_len20`` (the latent (4, 16, 16, 128), the ODE
   field 128 -> 64 -> 64 -> 64 -> 128, the z0 ConvGRU at 128 channels),
   ``_irregular`` (window sampling with observation masks), ``_gan``
   (the GAN loop) and ``_slots`` (B * S = 16 programs of 32 channels) on
   the frozen corpus, and the six corpus blocks ``train_{kth, mgif, penn,
   hurricane, phyre, minerl}_vidode`` (mgif and penn at 128x128: the
   latent (4, 32, 32, 128)) on corpora of 4 train and 4 test videos that
   the port's commands write as a user runs them, all six at once
   (``python -m ode_rl_torch.make_synthetic_corpus --dataset <d>``, and
   ``python -m ode_rl_torch.generate_phyre_dataset --synthetic`` for
   phyre), each file's sha256 equal to that of the JAX repo's scripts
   run on the CPU host with the same flags (``VIDODE_CORPUS_BYTES``;
   else the first file that differs is named, with the byte where one
   differs), fp32, B=4, 5 steps each: every logged loss finite (and
   grad_norm, or for the GAN D's and G's losses), no step skipped by
   ``nan_guard``, a checkpoint whose BatchNorm buffers all moved, K1-K4
   launched with every K1/K2 launch a SIMT one and every K3/K4 launch a
   one-sample one, TF32 off after each ``main``; median step_ms over
   steps 2-5, the NFE and K1-K4's launches a step. Then the test phase of
   ``len20`` (20 -> 180), of ``kth`` (10 -> 30) and of ``penn`` (10 -> 20
   at 128x128) from their checkpoints, one batch: finite MSE, PSNR, SSIM
   and ``lpips_uncalibrated`` at every horizon; one step of ``len20`` and
   of ``slots`` from the seed's weights through the kernels (profiled:
   device ms and busy share) against the same step under
   ``force_plain()`` (loss 1e-5 relative, prediction 1e-4 max abs, every
   gradient leaf within 1e-3 of its norm plus 1e-5 of the whole norm,
   BatchNorm buffers 1e-5, equal NFE); and K1/K2 at (4, 16, 16,
   128->64), (4, 16, 16, 64->64), (4, 16, 16, 64->128), (16, 16, 16,
   32->32) and the same three at (4, 32, 32), K3 at (4, 16, 16, 256),
   (16, 16, 16, 64) and (4, 32, 32, 256), K4 at (4, 16, 16, 128), (16,
   16, 16, 32) and (4, 32, 32, 128) alone against their plain versions,
   each with its plan, route, device µs and bound.
13. ConvLSTM, the S2VAE family and the Sprites DS-VAE: ``ode_rl_torch.main``
   on ``defaults`` + ``train_mmnist_convlstm``, ``train_mmnist_s2vae``,
   ``_cs2vae`` (3 slots of 128: K3 at (4, 4, 4, 256) in 8 groups and K4
   at (4, 4, 4, 128) in 4, once a slot a step), ``_ds2vae`` and
   ``train_sprite_dsvae`` (procedural clips made on the card), 4 steps
   each at their own widths (fp32, B=4) on the frozen corpus, and
   ``train_mmnist_convlstm_sched`` with lr 0, plateau patience 0 and
   early stopping after 2 epochs, over up to eight epochs of 2 steps:
   loss and grad_norm finite at every step, a checkpoint whose BatchNorm
   buffers all moved (ConvLSTM has none), CS2VAE's K3/K4 launched (every
   launch one-sample, no K1/K2) and the other blocks launching none of
   K1-K4, the plateau block stopped early with the stop epoch and the lr
   scale of its checkpoint (below 1) those of the plateau's and early
   stopping's state machines replayed on its logged ``val_mse``; median
   step_ms. Then ``test_mmnist_s2vae``, ``_cs2vae`` and ``_ds2vae`` (20
   -> 20, one batch) from their train runs' checkpoints; one CS2VAE step
   from the seed's weights through the kernels (profiled) against the
   same step under ``force_plain()`` (as phase 11's); one profiled
   forward and backward of each other block (device ms and busy share);
   a ConvLSTM step with ``debug_nans`` on a batch holding one NaN, which
   must raise ``FloatingPointError``; and K3/K4 at CS2VAE's shapes alone;
14. world models: ``train_mmnist_dreamer``, ``_dreamer_discrete`` and
    ``_dreamer_spatial`` through ``ode_rl_torch.main`` at their blocks'
    widths (fp32, B=4; 5 steps each, cut from 25 epochs; every logged
    loss, KL and grad_norm finite, a checkpoint at step 5; step_ms the
    median of steps 2-5), their test phase from it (one batch; 10 -> 90
    frames for Dreamer, 10 -> 10 for the other two, cut from the
    blocks' epochs of batches; every per-horizon value finite);
    ``train_cater_classifier`` cut to one epoch of 6 steps on the corpus
    it writes at the block's 120 + 40 episodes of 40 frames (val_mAP,
    val_top5 and random_mAP_baseline finite) and
    ``test_cater_classifier`` from its checkpoint (ckpt_step 6); one
    fp32 forward and backward of each Dreamer block on the card against
    the same on the CPU (the same weights, batch and draws, recorded on
    the CPU and replayed; loss to 1e-5 relative, every gradient leaf to
    1e-3 relative L2; TF32 and cuDNN's choice of algorithm show here),
    profiled (device ms and busy share), likewise one CATER step;
    ``ode_rl_torch.rl_demo --wm_steps 50 --behavior_steps 20
    --eval_episodes 16`` (cut from 2000, 600 and 64) into a temporary
    report, every number finite. No K1-K8 launch over the phase
    (``phase14_launches`` in the kernels line).
15. FlowNet's user paths, fp32 (K5-K7 on SIMT): ``ode_rl_torch.
    train_flownetc --net C`` (200 steps, cut from 2000, B=8; the trained
    held-out EPE below the random-init one; K5-K7 launched), ``--net S``
    (50 steps; no K5-K8) and ``--net 2 --warm_start`` (3 steps; JAX's
    graft counts 48/0, 41/1, 41/1; K5-K8 launched) into a temporary
    ``logs/flow``; the saved ``flownetc.msgpack`` read back on the card
    (parameters and, with cuDNN deterministic, the forward bit-equal to
    the writer's); one FlowNetC step from those weights on a
    FlyingChairs-layout batch against ``force_plain()``, cuDNN
    deterministic in both (loss and EPE 1e-5 relative, worst gradient
    leaf 1e-3 relative L2), profiled;
    ``ode_rl_torch.train_flownetc_highres`` (320x448, B=8, its 300 steps:
    the mean EPE of the last 10 below that of the first 10) and K5-K7 at
    its features (8, 40, 56, 256) alone against their plain versions
    (1e-5 max abs), 20 calls bit-equal, with median ms, device µs, bound
    and the share of it reached, each row naming its SIMT kernel, and a
    profiled step; ``defaults`` +
    ``train_mmnist_recon_s3vae``
    with ``--flow_label_source flownet`` and the trained weights through
    ``ode_rl_torch.main`` (4 steps on phase 10's corpus; labels in {0, 1};
    K5 launched, no K6/K7) and its test block (one batch); one batch's
    labels through the kernels against ``force_plain()`` (the upsampled
    flow 1e-4 max abs, the labels equal on every cell more than 1e-4 from
    its k-th value), a profiled labelled step, and K5 at the labels'
    (156, 8, 8, 256) alone; K5-K7 alone likewise at FlyingChairs'
    features (8, 48, 64, 256) in fp32 and bf16 (bf16 K5 1e-4 relative L2,
    K6 and K7 bit-equal) and the FlowNetC trainers' (8, 8, 8, 256) in
    fp32, each row naming its SIMT kernel (tiles, or the pair view on maps
    of at most 32 cells a class);
    ``ode_rl_torch.get_labels_from_pred_flow`` on the corpus's train
    split ((16, 100, 9), row 0 zero, at least 3 ones in every other row). Each path's launches (``phase15_launches``) and
    the new shapes' rows (``phase15_shapes``) go into the kernels line.
16. the evaluation tools and the last helpers, fp32:
    ``ode_rl_torch.make_frozen_mmnist --videos 256 --frames 200
    --train_split 0.75`` with the native generator built on this host
    (its build seconds and flags printed; each shard's sha256 equal to
    ``CORPUS_SHA256``, the CPU host's, else the first video that differs
    is named); ``ode_rl_torch.parity_eval`` on the corpus's first 4 test
    videos with the recipe's seed weights saved as a checkpoint (JAX's
    keys, 10 and 90 finite values of each metric); ``checked_odeint``
    over the recipe's decode field at (4, 16, 16, 64) bit-equal to
    ``odeint_aux`` with its K1 launches (all SIMT) counted, and raising
    ``FloatingPointError`` naming t=0.5 on a field that turns NaN there;
    ``StepTimer(warmup=3)`` over 10 fused recipe steps (K1-K4 launched)
    and a 2-step ``trace`` whose Chrome trace holds the ``annotate``
    spans and K1 kernel events; two one-digit ``train_mmnist_recon_s3vae``
    runs (4 steps; the second with l1 = l2 = l3 = 0) and
    ``ode_rl_torch.mmnist_disentangle`` cut (judge 1000 steps): the judge
    above chance on real videos (sprite > 1/16, both quadrants > 1/4); a
    4-step ``train_sprite_dsvae`` run, ``sprite_probe_grids`` (six PNGs)
    and ``sprite_disagreement`` cut (100 judge steps, 2 batches): JAX's
    keys, finite scores, accuracies in [0, 1]; the CEM plan's predicted
    return at least its first iteration's mean proposal's and the
    gradient planner's objective after 50 steps at most its first,
    through rl_demo's action-conditioned world model trained 50 steps;
    ``ImpalaCNN`` on the card against the CPU (1e-5, cuDNN
    deterministic); ``EpisodeLoader``'s shapes (JAX's short batch pinned).
    Each path's launches (``phase16_launches``) go into the kernels line.
17. data parallelism (ode_rl_torch/parallel): the recipe through
    ``ode_rl_torch.main`` for 10 steps on a frozen corpus, once alone and
    once under ``torch.distributed.run --standalone --nproc_per_node 1``
    with ``--use_mesh True`` (NCCL at one rank), cuDNN deterministic in
    both: losses and grad_norms bit-equal, the same launches, the median
    step_ms of each and the gradient all-reduce's bytes; which gloo
    collectives take CUDA tensors (all three must); then
    ``flagship_bench`` (the fused bench step, B=128 bf16, 64 rows a rank)
    and ``flownetc_bench`` (B=256 bf16, 128 a rank) over two gloo ranks
    sharing this card against the one-rank step on the same weights and
    global batch (``parallel/dryrun.py``): loss, grad_norm and EPE within
    DP_TOL, NFE equal, parameters bit-equal across the ranks, K1-K4 on
    each rank with every K1/K2 launch a tensor-core one, K5-K7 on each
    rank; step_ms of two ranks and of one (two processes on one card:
    not a multi-card figure). Each rank's launches
    (``phase17_launches``) go into the kernels line.
18. the 'model' and 'space' axes (parallel/tp.py, parallel/sp.py):
    ``flagship_bench_tp`` (the fused bench step, B=128 bf16, on a 1 x 2
    ('data', 'model') mesh: the 13 wide kernels' output channels split,
    the channels all-gathered) and ``flagship_bench_sp`` (on a 1 x 2
    ('data', 'space') mesh: 32 of the 64 frame rows a rank, halo rows
    exchanged, K3/K4's moments all-reduced) over two gloo ranks sharing
    this card against the one-rank step on the same weights and batch:
    loss and grad_norm within AXIS_BENCH_TOL, NFE equal, parameters
    after the step bit-equal across the ranks (the 'model' slices
    gathered) and their update within BENCH_PARAM_TOL relative L2 of the
    one-rank update; each rank's K1-K4 launches and routes (every K1
    and K2 launch a tensor-core one on both axes, the 'model' rank's
    Cout 32 K2 and fp32-output dx partials included; under 'space' every
    K1/K2 launch on the rank's own 8 rows with a halo operand, none under
    'model', and every K3/K4 launch a moments-in one, each with its
    moments pass, and every moments pass and moments-in K3 and K4 on its
    vector kernel; every 'model' K1 launch at Cout 32 in one 32-channel
    column block, and no K1 launch of either axis in 16-channel blocks),
    the bytes
    each axis moved in a step, and one more step profiled on each rank:
    rank 0's device ms by kernel group and its K1-K8 kernels' µs a launch
    (``phase18_rank0_profiled`` for K1 and K2). Then the dry run's
    flagship dp x tp and dp x sp steps at four gloo ranks on this card
    (fp32, its shapes): with the convs outside K1-K4 on cuDNN, printed,
    then on PyTorch's own CUDA convolution, held at its tolerances
    (cuDNN's fp32 algorithms differ by shape, and at the one-process
    shapes read grad_norm 1.1e-4 off the others). Each rank's launches
    (``phase18_launches``) go into the kernels line; the moments-in
    K3/K4 and their moments pass take their launches from the 'space'
    run's rank 0, K1's 32-channel blocks (``conv3x3_fwd_nt32``) from the
    'model' run's. Two or four processes on one card: not a multi-card
    figure.
19. the reference's mp4 corpus layout, where cv2 is installed (else one
    line says that the layout is held on the CPU only): ``python -m
    ode_rl_torch.make_mp4_mmnist`` writes 16 train and 8 test videos of
    100 frames; the recipe's first batch from ``parse_datasets`` equal
    to one sampled by hand from ``read_video_file``'s decodes with the
    same RandomState draws; the recipe through ``ode_rl_torch.main`` for
    5 steps on the corpus (losses and grad_norms finite, K1-K4 launched
    with every K1/K2 launch a SIMT one and every K3/K4 launch a
    one-sample one) and its test block (one batch, 10 -> 90; 90 finite
    values of each metric and the plot checked as in phase 9). Its
    launches (``phase19_launches``) go into the kernels line;
20. parity init: the committed JAX inits of the ConvGRU twin
    (``results/port_parity/convgru_init.npz``) and of the recipe
    (``odecgru_init.npz``), each through ``python -m
    ode_rl_torch.parity_init``, then 20 steps of ``defaults`` +
    ``train_mmnist_cgru_len20`` and of the recipe through
    ``ode_rl_torch.main`` on the corpus phase 16 wrote (the bytes of
    ``datasets/parity``), resumed at step 0: each step's loss (and the
    recipe's NFE) printed beside JAX's recorded from the same init and
    batches (``results/port_parity/jax_first20``,
    ``results/port_parity/recipe/jax_first20``) and their relative gap.
    The twin: step 1's gap within PARITY_STEP1_RTOL, step 1's grad_norm
    within PARITY_GRAD_RTOL of JAX's, the largest gap over steps 2-20
    within PARITY_LATER_RTOL, every loss finite, and K3/K4 launched 20
    times a step each, every launch a one-sample one, no K1/K2. The
    recipe: step 1's gap within PARITY_STEP1_RTOL, step 1's grad_norm and
    steps 2-20 within PARITY_GRAD_RTOL and PARITY_LATER_RTOL, the NFE
    equal to JAX's at every step, K1-K4 on the recipe's routes (fp32
    SIMT K1/K2, one-sample K3/K4) and K3/K4 launched 10 times a step
    each. Their launches (``phase20_launches``,
    ``phase20_recipe_launches``) go into the kernels line.

Phase 3 also holds the kernels at the shapes of phase 18: K1 and K2 on a
'model' rank's Cout slice (128, 16, 16, 64) -> 32 and on a 'space'
rank's rows (128, 8, 16, 64) -> 64 with a (128, 2, 16, 64) halo operand
at the top, the bottom and inside the frame, in bf16 against fp64, all
on the tensor cores (K1 and K2 at Cout 32 in blocks of 32 output
channels, K1 against fp64 and 20 calls bit-equal and timed beside its
NT-16 plan, whose bit-equality with it is printed; K2 20 calls
bit-equal; the 'space' kernels timed beside the cat-tile-crop
composition they replaced and cuDNN on the 10-row tile, and the fp32
SIMT K1/K2 with a halo held against their plain versions at (2, 5, 7,
16) -> 24 and (4, 8, 16, 64) -> 64), the column-parallel dx partial (K1
with bf16 in and fp32 out, (128, 16, 16, 32) -> 64, on the tensor cores)
against its plain version
and 20 calls bit-equal, each timed in one run beside the SIMT route it
replaced and cuDNN's call (the fp32 F.conv2d for the dx partial), with
host µs a call and the 'model' forward read three more times; and the
moments-in K3 and K4 with their moments pass at a
'space' rank's rows (128, 8, 16, 128 / 64), each on its vector kernel:
the moments pass on the gates and on the candidate within 1e-5 of the
largest sum of the plain version and of fp64 sums, the epilogues against
their plain versions on the same moments (fp32, 1e-5; bf16, one ulp of
the fp64 formula) and bit-equal to the scalar kernels they replaced,
each bit-equal over 20 calls and timed in one run beside its scalar
kernel and its plain version, with host µs a call; the moments pass also
beside torch.var_mean over the same (B, HW, G, C/G) view (mean and
variance, not sums) and at other plans (512 and 1024 threads, clusters
of 2 and 4 blocks a sample).

TF32 is off for matmul and cuDNN throughout, so the fp32 steps (phases 5,
7-20) run their convs in strict fp32. Then one JSON line
with each kernel's launches, error, times, bound (the larger of its
operations over the peak rate of their type and its bytes over the memory
rate, at the shape timed) and the time of the one PyTorch call that
computes the same function where there is one (cuDNN's conv for K1,
cuDNN's weight gradient for K2, torch.linalg.vector_norm for K8; the port
never calls them), and as the last line {"ok": true, "device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ode_rl_torch import main as port_main
from ode_rl_torch.config import (FlagshipConfig, FlowNet2Config,
                                 FlowNetCBenchConfig)
from ode_rl_torch.core.checkpoint import CheckpointManager, find_checkpoint
from ode_rl_torch.core.config import load_config, resolve_run_id
from ode_rl_torch.data.frozen import FrozenMovingMNIST, read_video_file
from ode_rl_torch.data.mmnist import generate_moving_mnist, parse_datasets
from ode_rl_torch.data.protocol import make_batch_dict
from ode_rl_torch.data.sprites import get_sprite_bank
from ode_rl_torch.data.video_corpus import corpus_sha256
from ode_rl_torch.data.flow_labels import (flow_grid_labels,
                                          make_flownet_label_fn)
from ode_rl_torch.flow.data import FlyingChairsCorpus, write_synthetic_chairs
from ode_rl_torch.flow.flownets import FlowNet2, FlowNetC
from ode_rl_torch.flow.train import (flow_loss_and_grads, load_flax_params,
                                     load_flownet_params,
                                     make_flow_train_step,
                                     make_fused_flow_train_step,
                                     synthetic_flow_batch)
from ode_rl_torch.ops.resize import resize_bilinear
from ode_rl_torch.nn import s3vae_nets
from ode_rl_torch.parallel import dryrun
from ode_rl_torch.ops import _build, common
from ode_rl_torch.ops.channelnorm import (ChannelNormFn, channelnorm_fwd,
                                          channelnorm_plain)
from ode_rl_torch.ops.conv3x3 import (Conv3x3Fn, _conv3x3_fwd_simt,
                                      _conv3x3_fwd_tc, _conv3x3_wgrad_simt,
                                      _conv3x3_wgrad_tc, conv3x3_fwd,
                                      conv3x3_fwd_plain, conv3x3_wgrad,
                                      conv3x3_wgrad_plain, flip_transpose,
                                      simt_plan, uses_tensor_cores,
                                      wgrad_simt_plan,
                                      wgrad_uses_tensor_cores)
from ode_rl_torch.ops.correlation import (CorrelationFn,
                                          _correlation_bwd_f1_simt,
                                          _correlation_bwd_f1_tc,
                                          _correlation_bwd_f2_simt,
                                          _correlation_bwd_f2_tc,
                                          _correlation_fwd_simt,
                                          _correlation_fwd_tc,
                                          correlation_bwd_f1,
                                          correlation_bwd_f1_plain,
                                          correlation_bwd_f2,
                                          correlation_bwd_f2_plain,
                                          correlation_fwd,
                                          correlation_fwd_plain,
                                          n_displacements,
                                          pair_displacements)
from ode_rl_torch.ops.gru_gates import (_blend_plain, _gates_plain,
                                        _gru_blend_2pass, _gru_blend_sample,
                                        _gru_gates_2pass, _gru_gates_sample,
                                        blend_f64, blend_from_moments,
                                        fused_gru_blend, fused_gru_gates,
                                        gates_f64, gates_from_moments,
                                        gru_moments, sample_plan,
                                        SamplePlan)
from ode_rl_torch.profile_step import _KERNEL_IDS, _KERNEL_NAME
from ode_rl_torch.train import loop as train_loop
from ode_rl_torch.core.noise import Noise
from ode_rl_torch.sprite.data import sprites_batch
from ode_rl_torch.train.schedulers import (EarlyStopping, ReduceLROnPlateau,
                                           lr_scale)
from ode_rl_torch.train.step import (create_train_state, loss_and_grads,
                                     make_fused_train_step, make_train_step)

KERNELS = {
    "conv3x3_fwd": ("ode_rl_torch/csrc/conv3x3.cu",
                    "ode_rl_tpu/ops/conv3x3.py:84"),
    "conv3x3_wgrad": ("ode_rl_torch/csrc/conv3x3.cu",
                      "ode_rl_tpu/ops/conv3x3.py:96"),
    "gru_gates": ("ode_rl_torch/csrc/gru_gates.cu",
                  "ode_rl_tpu/ops/gru_gates.py:103"),
    "gru_blend": ("ode_rl_torch/csrc/gru_gates.cu",
                  "ode_rl_tpu/ops/gru_gates.py:184"),
    "correlation_fwd": ("ode_rl_torch/csrc/correlation.cu",
                        "ode_rl_tpu/ops/correlation.py:64"),
    "correlation_bwd_f1": ("ode_rl_torch/csrc/correlation.cu",
                           "ode_rl_tpu/ops/correlation.py:116"),
    "correlation_bwd_f2": ("ode_rl_torch/csrc/correlation.cu",
                           "ode_rl_tpu/ops/correlation.py:136"),
    "channelnorm": ("ode_rl_torch/csrc/channelnorm.cu",
                    "ode_rl_tpu/ops/channelnorm.py:30"),
    # The moments-in K3 and K4 under a 'space' axis, and their moments
    # pass (which takes the GroupNorm sums of both Pallas kernels).
    "gru_gates_mom": ("ode_rl_torch/csrc/gru_gates.cu",
                      "ode_rl_tpu/ops/gru_gates.py:103"),
    "gru_blend_mom": ("ode_rl_torch/csrc/gru_gates.cu",
                      "ode_rl_tpu/ops/gru_gates.py:184"),
    "gru_moments": ("ode_rl_torch/csrc/gru_gates.cu",
                    "ode_rl_tpu/ops/gru_gates.py:103"),
    # Routes of the mesh axes redesigned since: K1 in 32-channel column
    # blocks (a 'model' rank's Cout 32 slice), and the vector kernels of a
    # 'space' rank's moments-in K3 and K4 epilogues and moments pass.
    "conv3x3_fwd_nt32": ("ode_rl_torch/csrc/conv3x3.cu",
                         "ode_rl_tpu/ops/conv3x3.py:84"),
    "gru_gates_mom_vec": ("ode_rl_torch/csrc/gru_gates.cu",
                          "ode_rl_tpu/ops/gru_gates.py:103"),
    "gru_blend_mom_vec": ("ode_rl_torch/csrc/gru_gates.cu",
                          "ode_rl_tpu/ops/gru_gates.py:184"),
    "gru_moments_vec": ("ode_rl_torch/csrc/gru_gates.cu",
                        "ode_rl_tpu/ops/gru_gates.py:103"),
}
AXIS_KERNELS = ("gru_gates_mom", "gru_gates_mom_vec", "gru_blend_mom",
                "gru_blend_mom_vec", "gru_moments", "gru_moments_vec")
FLAGSHIP_KERNELS = ("conv3x3_fwd", "conv3x3_wgrad", "gru_gates", "gru_blend")
# The shards of ``python -m ode_rl_torch.make_frozen_mmnist --videos 256
# --frames 200 --train_split 0.75`` (seed 0, 3 digits), as the native
# generator wrote them on the CPU host the port is tested on; phase 16
# holds the card's host to the same bytes.
CORPUS_SHA256 = {
    "train/shard_0000.npy":
        "7269415d720f7acf6c089842473ac46b4a885e7def5eca9804619d67498a6bfd",
    "test/shard_0001.npy":
        "b4ddaef073f752afca14e52d82e2938348840e37ee7bf728f4073856ac5ff045",
}
FLOWNETC_KERNELS = ("correlation_fwd", "correlation_bwd_f1",
                    "correlation_bwd_f2")
# Flagship shapes: the field state (B, 16, 16, 64); gates 2C = 128 in 4
# groups, candidate C = 64 in 2 groups.
B, HW, C = 128, 16, 64


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm()
            / b.float().norm().clamp_min(1e-30)).item()


def check(label: str, err: float, tol: float, kind: str) -> float:
    ok = err <= tol
    print(f"  {label:<34} {kind} {err:.3e} (tolerance {tol:.1e}) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{label}: {kind} {err} > {tol}")
    return err


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_a_call(counts) -> int:
    """The device events one call launches, from traces of it: ``counts``
    holds (calls, events) of each trace. A trace can lose events but
    never gains any, and one that lost some may divide by its calls no
    more, so the count is the most whole number of events a call that any
    trace shows (0 where every trace lost all)."""
    return max((events // calls for calls, events in counts
                if events % calls == 0), default=0)


def window_complete(events: int, traces, reps: int) -> bool:
    """A profiler window of ``reps`` calls that held ``events`` device
    events is whole when that is ``reps`` times the events of one call
    (events_a_call over ``traces``, the (calls, events) of the other
    traces of the same function, and this window), at least one, and
    another trace shows the same count a call. The tracer drops events
    at times: a window of phase 12's fp32 K1 at (4, 32, 32, 64->64) once
    read 8.85 µs a call, below the kernel's shared-memory floor of about
    9 (whole windows read 22); after phase 3, traces of 1, 2 and 5 calls
    of a one-kernel function read 0 while its windows of 20 read 20."""
    a_call = events_a_call([*traces, (reps, events)])
    return (a_call > 0 and events == reps * a_call
            and any(events_t == calls * a_call for calls, events_t in traces))


def _traced(fn, calls: int) -> tuple:
    """(device events, device µs) of ``calls`` calls of fn, in the active
    step of a torch.profiler window after a warm-up step of as many calls
    that is traced and thrown away."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows))


# The calls of the short traces that count one call's device events.
SHORT_TRACES = (1, 2, 5)


def device_us(fns: dict, reps: int = 20, windows: int = 5) -> dict:
    """Device time of one call of each fn, in µs: every device kernel and
    copy in a torch.profiler window of `reps` calls (_traced), over
    `reps`. Traces of SHORT_TRACES calls count one call's events first.
    A window that is not whole (window_complete: not `reps` times the
    most events a call that any trace of the function shows, or shown by
    no other trace) is taken again, up to `windows` times; after that
    the CUDA-event median of one call stands in, and the line says so."""
    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        traces = [(n, _traced(fn, n)[0]) for n in SHORT_TRACES]
        for _ in range(windows):
            events, total = _traced(fn, reps)
            if window_complete(events, traces, reps):
                out[label] = total / reps
                break
            print(f"  {label}: a window of {reps} calls held {events} "
                  f"device events, not whole beside the traces (calls, "
                  f"events) {traces}; taken again")
            traces.append((reps, events))
        else:
            out[label] = median_ms(fn, reps=reps) * 1e3
            print(f"  {label}: no whole profiler window in {windows}; "
                  f"CUDA-event µs a call instead: {out[label]:.2f}")
    return out


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call, in µs: `reps` calls enqueued back to back and
    timed on the host's clock, the synchronize outside it. 200 calls of at
    most two launches each stay well inside the launch queue, so no call
    waits for the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


# The library yardsticks: one PyTorch call that computes a kernel's
# function, timed here and never called by the port.
def oihw(w2d: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    return w2d.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def conv_library(x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """K1's function as one cuDNN call on NHWC memory (NCHW views)."""
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)


def wgrad_library(x: torch.Tensor, g: torch.Tensor,
                  w_oihw: torch.Tensor) -> torch.Tensor:
    """K2's function as one cuDNN weight-gradient call, (Cout, Cin, 3, 3)
    in the inputs' dtype (bf16 in, bf16 out: its own rounding)."""
    return torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, None, [1, 1],
        [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])[1]


def wgrad_library_2d(dw_oihw: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (9*Cin, Cout), K2's layout."""
    cout, cin = dw_oihw.shape[:2]
    return dw_oihw.permute(2, 3, 1, 0).reshape(9 * cin, cout)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need an H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"{torch.cuda.get_device_name(0)} is sm_"
                           f"{cap[0]}{cap[1]}; the kernels are built for "
                           "sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print("[1] device (nvidia-smi name, power.limit):")
    print(smi.strip().splitlines()[0])
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}")
    return torch.cuda.get_device_name(0)


def phase_build() -> float:
    t0 = time.perf_counter()
    log = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    print(f"[2] build: {seconds:.2f} s -> {_build.library_path()}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())
    return seconds


def _inputs(dtype, gen):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)
    return dict(
        x=rnd(B, HW, HW, C), g=rnd(B, HW, HW, C),
        w2d=rnd(9 * C, C, scale=1.0 / 24.0),
        # The ConvGRU state is a convex blend of tanh values: |h| < 1.
        gates=rnd(B, HW, HW, 2 * C), h=torch.tanh(rnd(B, HW, HW, C)),
        cand=rnd(B, HW, HW, C), z=torch.sigmoid(rnd(B, HW, HW, C)),
        gs=(1.0 + 0.1 * torch.randn(2 * C, generator=gen)).cuda(),
        gb=(0.1 * torch.randn(2 * C, generator=gen)).cuda(),
        cs=(1.0 + 0.1 * torch.randn(C, generator=gen)).cuda(),
        cb=(0.1 * torch.randn(C, generator=gen)).cuda())


def _ops(t):
    w_t = flip_transpose(t["w2d"], C, C)
    return {
        "conv3x3_fwd": lambda: conv3x3_fwd(t["x"], t["w2d"]),
        "conv3x3_fwd as dx": lambda: conv3x3_fwd(t["g"], w_t),
        "conv3x3_wgrad": lambda: conv3x3_wgrad(t["x"], t["g"]),
        "gru_gates": lambda: fused_gru_gates(t["gates"], t["h"], t["gs"],
                                             t["gb"], 4),
        "gru_blend": lambda: fused_gru_blend(t["cand"], t["z"], t["h"],
                                             t["cs"], t["cb"], 2),
    }


# (fp32 tolerance, bf16 tolerance, metric): see README's port section. K1,
# K3 and K4 in bf16 are held to fp64 instead (_check_k1_bf16,
# _check_gru_bf16). bf16 K2 against its plain version (both sum exact bf16
# products in fp32, in other orders): readings 6.8e-7 (tensor cores,
# flagship shape) to 2.6e-7 (SIMT).
_TOL = {
    "conv3x3_fwd": (1e-4, None), "conv3x3_fwd as dx": (1e-4, None),
    "conv3x3_wgrad": (1e-5, 5e-6), "gru_gates": (1e-5, None),
    "gru_blend": (1e-5, None),
}
# bf16 K1 against the fp64 conv rounded to bf16 (common.bf16_ulps): every
# output within one ulp, and at most this share of outputs one ulp off.
# Readings at the flagship shape (my chip runs): 1.1e-4 (SIMT), 2.7e-4
# (tensor cores), 2.8e-4 to 3.0e-4 (cuDNN); 5.5e-4 for the tensor cores at
# 96 channels. A kernel that truncated instead of rounding would read
# about 0.5.
K1_BF16_ULPS, K1_BF16_SHARE = 1.0, 2e-3
# bf16 K2 against the fp64 patches^T . g of the same bf16 inputs, relative
# L2. A bf16 product is exact in fp32, so the two K2 kernels differ from
# fp64 by fp32 rounding of 32,768-deep sums: readings (H100 80GB HBM3, 700 W)
# 5e-8 to 6.8e-7 at the flagship and card-test shapes (tensor cores),
# 5.9e-8 to 2.6e-7 (SIMT). cuDNN's weight gradient returns bf16, whose
# rounding alone reads 1.65e-3 to 1.67e-3.
K2_BF16_REL_L2, K2_CUDNN_REL_L2 = 5e-6, 3e-3
# bf16 K3 and K4 (both kernels) against the Pallas formula in fp64 on the
# same bf16 inputs (gates_f64, blend_f64), rounded to bf16
# (common.bf16_ulps): every output within one ulp, and at most this share
# of outputs one ulp off. The kernels round once from fp32, so only
# outputs whose fp64 value lies within fp32 noise of a rounding boundary
# can differ. Readings at the flagship shape (H100 80GB HBM3, 700 W):
# K3 9.5e-6 (one-sample), 7.6e-6 (two-pass); K4 3.4e-5 and 3.1e-5. A
# kernel that truncated would read about 0.5. The plain versions round r,
# z and cand to bf16 first, and the blend at every bf16 operation, so near
# a zero of the blend they lie many of its fine ulps off (readings: K3 1
# ulp, 0.26 of outputs off; K4 547 ulps, 0.44 off): printed, not held.
K34_BF16_ULPS, K34_BF16_SHARE = 1.0, 5e-4


def _metric(name: str, dtype) -> str:
    if name.startswith("gru"):
        return "max_abs"
    if name == "conv3x3_wgrad" or dtype == torch.bfloat16:
        return "rel_l2"
    return "max_abs"


def _time_turns(fns: dict) -> dict:
    """CUDA-event median ms of each fn, the least of two runs in the turns
    a, b, ..., ..., b, a; then device µs a call of each."""
    runs = {}
    for label in [*fns, *reversed(fns)]:
        runs.setdefault(label, []).append(median_ms(fns[label]))
    us = device_us(fns)
    return {label: (min(runs[label]), us[label]) for label in fns}


def _check_k1_bf16(t) -> dict:
    """Both K1 kernels and the plain version in bf16, forward and as dx,
    against the fp64 conv of the same bf16 inputs; the tensor-core kernel
    bit-equal over 20 calls; times of the two kernels, the plain version
    and cuDNN's conv from this run."""
    w_t = flip_transpose(t["w2d"], C, C)
    cases = {"forward": (t["x"], t["w2d"]), "as dx": (t["g"], w_t)}
    variants = {"tensor cores": _conv3x3_fwd_tc, "SIMT": _conv3x3_fwd_simt,
                "plain (cuDNN)": conv3x3_fwd_plain}
    worst = {}
    for case, (x, w) in cases.items():
        ref = conv3x3_fwd_plain(x.double(), w.double())
        for label, fn in variants.items():
            out = fn(x, w)
            ulps, share = common.bf16_ulps(out, ref)
            check(f"K1 {case} bf16, {label}: ulps", ulps, K1_BF16_ULPS,
                  "max")
            check(f"K1 {case} bf16, {label}: share 1 ulp off", share,
                  K1_BF16_SHARE, "share")
            if label == "tensor cores":
                worst[case] = out
                if not all(torch.equal(out, fn(x, w)) for _ in range(20)):
                    raise AssertionError(f"tensor-core K1 {case}: 20 calls "
                                         "are not bit-equal")
    x, w = cases["forward"]
    with common.force_plain():
        plain = conv3x3_fwd(x, w)
    w_oihw = oihw(w, C, C)
    times = _time_turns({"tc": lambda: _conv3x3_fwd_tc(x, w),
                         "simt": lambda: _conv3x3_fwd_simt(x, w),
                         "plain": lambda: conv3x3_fwd_plain(x, w),
                         "library": lambda: conv_library(x, w_oihw)})
    result = {"max_abs_err": max_abs(worst["forward"], plain)}
    for label, (ms, us) in times.items():
        result["ms" if label == "tc" else f"{label}_ms"] = ms
        result[f"{label}_device_us"] = us
    print("  K1 bf16 forward at (128, 16, 16, 64) -> 64, one run: CUDA-event "
          f"median ms tc {result['ms']:.4f} simt {result['simt_ms']:.4f} "
          f"plain {result['plain_ms']:.4f} cuDNN {result['library_ms']:.4f}; "
          "device us a call tc "
          f"{result['tc_device_us']:.2f} simt {result['simt_device_us']:.2f} "
          f"cuDNN {result['library_device_us']:.2f}")
    return result


def _check_k2_bf16(t) -> dict:
    """Both K2 kernels and cuDNN's weight gradient in bf16 against the fp64
    patches^T . g of the same bf16 inputs; the tensor-core kernel bit-equal
    over 20 calls; times of the two kernels, the plain version and cuDNN
    from this run."""
    x, g = t["x"], t["g"]
    w_oihw = oihw(t["w2d"], C, C)
    ref = conv3x3_wgrad_plain(x.double(), g.double())
    tc = _conv3x3_wgrad_tc(x, g)
    for label, out, tol in (
            ("tensor cores", tc, K2_BF16_REL_L2),
            ("SIMT", _conv3x3_wgrad_simt(x, g), K2_BF16_REL_L2),
            ("cuDNN (bf16 out)",
             wgrad_library_2d(wgrad_library(x, g, w_oihw)), K2_CUDNN_REL_L2)):
        check(f"K2 bf16 vs fp64, {label}", rel_l2(out, ref), tol, "rel_l2")
    if not all(torch.equal(tc, _conv3x3_wgrad_tc(x, g)) for _ in range(20)):
        raise AssertionError("tensor-core K2: 20 calls are not bit-equal")
    with common.force_plain():
        plain = conv3x3_wgrad(x, g)
    times = _time_turns({"tc": lambda: _conv3x3_wgrad_tc(x, g),
                         "simt": lambda: _conv3x3_wgrad_simt(x, g),
                         "plain": lambda: conv3x3_wgrad_plain(x, g),
                         "library": lambda: wgrad_library(x, g, w_oihw)})
    result = {"max_abs_err": max_abs(tc, plain)}
    for label, (ms, us) in times.items():
        result["ms" if label == "tc" else f"{label}_ms"] = ms
        result[f"{label}_device_us"] = us
    print("  K2 bf16 at (128, 16, 16, 64) x (128, 16, 16, 64), one run: "
          f"CUDA-event median ms tc {result['ms']:.4f} simt "
          f"{result['simt_ms']:.4f} plain {result['plain_ms']:.4f} cuDNN "
          f"{result['library_ms']:.4f}; device us a call tc "
          f"{result['tc_device_us']:.2f} simt {result['simt_device_us']:.2f} "
          f"cuDNN {result['library_device_us']:.2f}")
    return result


def _check_gru_bf16(t) -> dict:
    """K3 and K4 in bf16 at the flagship shape: the one-sample kernels, the
    two-pass kernels and the plain versions against the fp64 Pallas
    formula on the same bf16 inputs; the one-sample kernels bit-equal over
    20 calls; the three timed in one run."""
    cases = {
        "gru_gates": ((t["gates"], t["h"], t["gs"], t["gb"], 4), gates_f64,
                      _gru_gates_sample, _gru_gates_2pass, _gates_plain),
        "gru_blend": ((t["cand"], t["z"], t["h"], t["cs"], t["cb"], 2),
                      blend_f64, _gru_blend_sample, _gru_blend_2pass,
                      _blend_plain),
    }
    results = {}
    for name, (args, f64, sample, two_pass, plain) in cases.items():
        refs = _as_tuple(f64(*args))
        outs = {}
        for label, fn in (("one-sample", sample), ("two-pass", two_pass),
                          ("plain", plain)):
            outs[label] = _as_tuple(fn(*args))
            readings = [common.bf16_ulps(o, r)
                        for o, r in zip(outs[label], refs)]
            ulps = max(u for u, _ in readings)
            share = max(s for _, s in readings)
            if label == "plain":
                print(f"  {name} bf16, plain (a reading): {ulps:.0f} ulps "
                      f"at most, share {share:.3e} off")
                continue
            check(f"{name} bf16, {label}: ulps", ulps, K34_BF16_ULPS, "max")
            check(f"{name} bf16, {label}: share 1 ulp off", share,
                  K34_BF16_SHARE, "share")
        first = outs["one-sample"]
        if not all(all(torch.equal(a, b) for a, b in
                       zip(first, _as_tuple(sample(*args))))
                   for _ in range(20)):
            raise AssertionError(f"one-sample {name}: 20 calls are not "
                                 "bit-equal")
        times = _time_turns({"sample": lambda: sample(*args),
                             "2pass": lambda: two_pass(*args),
                             "plain": lambda: plain(*args)})
        result = {"max_abs_err": max(max_abs(a, b) for a, b in
                                     zip(first, outs["plain"]))}
        for label, (ms, us) in times.items():
            result["ms" if label == "sample" else f"{label}_ms"] = ms
            result[f"{label}_device_us"] = us
        print(f"  {name} bf16 at the flagship shape, one run: CUDA-event "
              f"median ms one-sample {result['ms']:.4f} two-pass "
              f"{result['2pass_ms']:.4f} plain {result['plain_ms']:.4f}; "
              f"device us a call one-sample {result['sample_device_us']:.2f}"
              f" two-pass {result['2pass_device_us']:.2f} plain "
              f"{result['plain_device_us']:.2f}")
        results[name] = result
    return results


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _gru_backward_cost(gen) -> dict:
    """Device time and device launches of one backward of FusedGRUGatesFn
    and FusedGRUBlendFn at the flagship shape in bf16: autograd of the
    plain formula, recomputed from the saved inputs (20 calls under
    torch.profiler)."""
    t = _inputs(torch.bfloat16, gen)
    cases = {"gru_gates": (fused_gru_gates, ("gates", "h", "gs", "gb"), 4),
             "gru_blend": (fused_gru_blend, ("cand", "z", "h", "cs", "cb"),
                           2)}
    out = {}
    for name, (fn, keys, groups) in cases.items():
        leaves = [t[k].clone().requires_grad_(True) for k in keys]
        outs = _as_tuple(fn(*leaves, groups))
        cots = [torch.randn(o.shape, generator=gen).to("cuda", o.dtype)
                for o in outs]

        def backward():
            torch.autograd.grad(outs, leaves, cots, retain_graph=True)

        backward()
        torch.cuda.synchronize()
        reps = 20
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                backward()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        out[name] = {
            "backward_device_ms":
                sum(e.self_device_time_total for e in events) / reps / 1e3,
            "backward_launches": sum(e.count for e in events) / reps}
        print(f"  {name} backward (autograd of the plain formula), bf16 "
              f"flagship shape: device ms a call "
              f"{out[name]['backward_device_ms']:.4f}, device launches a "
              f"call {out[name]['backward_launches']:.1f}")
    return out


def _host_times(gen) -> dict:
    """Host µs a call of the K1-K4 wrappers at B=1 (16 x 16 x 64, bf16):
    K1's and K2's public wrapper, which takes the tensor cores, beside the
    SIMT one (which every K2 call took before the tensor-core K2); K3's and
    K4's one-sample kernel (the rule's choice) beside the two-pass one
    (which every call took before), both called as the autograd Function
    calls them. Ten runs of each, five rounds of the turns a, b, ..., ...,
    b, a: the host's clock is noisy (other work shares its cores), so the
    least run stands for the wrapper's own cost, with the median beside
    it."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)

    x, g, h, cand, z = (rnd(1, HW, HW, C) for _ in range(5))
    gates = rnd(1, HW, HW, 2 * C)
    w2d = (torch.randn(9 * C, C, generator=gen) / 24.0).to("cuda",
                                                           torch.bfloat16)
    gs, gb, cs, cb = (torch.ones(n, device="cuda") for n in (2 * C, 2 * C,
                                                              C, C))
    return _host_turns({
        ("conv3x3_fwd", "host_us", "tensor cores"):
            lambda: conv3x3_fwd(x, w2d),
        ("conv3x3_fwd", "simt_host_us", "SIMT"):
            lambda: _conv3x3_fwd_simt(x, w2d),
        ("conv3x3_wgrad", "host_us", "tensor cores"):
            lambda: conv3x3_wgrad(x, g),
        ("conv3x3_wgrad", "simt_host_us", "SIMT"):
            lambda: _conv3x3_wgrad_simt(x, g),
        ("gru_gates", "host_us", "one-sample"):
            lambda: _gru_gates_sample(gates, h, gs, gb, 4),
        ("gru_gates", "2pass_host_us", "two-pass"):
            lambda: _gru_gates_2pass(gates, h, gs, gb, 4),
        ("gru_blend", "host_us", "one-sample"):
            lambda: _gru_blend_sample(cand, z, h, cs, cb, 2),
        ("gru_blend", "2pass_host_us", "two-pass"):
            lambda: _gru_blend_2pass(cand, z, h, cs, cb, 2),
    })


def _host_turns(fns: dict, where: str = "B=1 bf16") -> dict:
    """Host µs a call of each fn keyed (kernel name, result key, label) on
    the inputs ``where`` names: ten runs each, five rounds of the turns a,
    b, ..., ..., b, a; the least run is kept, the median printed beside
    it."""
    runs = {key: [] for key in fns}
    for _ in range(5):
        for key in [*fns, *reversed(fns)]:
            runs[key].append(host_us(fns[key]))
    out = {}
    for (name, label, kind), times in runs.items():
        out.setdefault(name, {})[label] = min(times)
        print(f"  {name} {where}, {kind}: host us a call, least "
              f"{min(times):.2f}, median {statistics.median(times):.2f} "
              f"of {len(times)} runs")
    return out


def phase_kernels() -> dict:
    print("[3] kernels vs plain versions at B=128 (TF32 off for matmul and "
          "cuDNN)")
    gen = torch.Generator().manual_seed(0)
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            print(f"  -- {dtype}")
            t = _inputs(dtype, gen)
            for name, fn in _ops(t).items():
                if dtype == torch.bfloat16 and name.startswith(
                        ("conv3x3_fwd", "gru")):
                    continue
                out = fn()
                with common.force_plain():
                    ref = fn()
                outs = out if isinstance(out, tuple) else (out,)
                refs = ref if isinstance(ref, tuple) else (ref,)
                kind = _metric(name, dtype)
                metric = max_abs if kind == "max_abs" else rel_l2
                tol = _TOL[name][dtype == torch.bfloat16]
                err = max(metric(o, r) for o, r in zip(outs, refs))
                check(f"{name} {str(dtype)[6:]}", err, tol, kind)
                if dtype == torch.bfloat16 and name in KERNELS:
                    results[name] = {"max_abs_err": max(
                        max_abs(o, r) for o, r in zip(outs, refs))}
                    results[name]["ms"] = median_ms(fn)
                    with common.force_plain():
                        results[name]["plain_ms"] = median_ms(fn)
            if dtype == torch.bfloat16:
                results["conv3x3_fwd"] = _check_k1_bf16(t)
                results["conv3x3_wgrad"] = _check_k2_bf16(t)
                results.update(_check_gru_bf16(t))
        for name, host in _host_times(gen).items():
            results[name].update(host)
    print("  median ms over 30 reps, bf16, B=128 (kernel / plain):")
    for name, r in results.items():
        print(f"    {name:<14} {r['ms']:.4f} / {r['plain_ms']:.4f}")
    _check_gradients(gen)
    for name, cost in _gru_backward_cost(gen).items():
        results[name].update(cost)
    results.update(_check_flow_kernels(gen))
    axes = _check_axis_shapes(gen)
    for name in ("conv3x3_fwd", "conv3x3_wgrad"):
        results[name]["axis_shapes"] = axes.pop(name)
    results.update(axes)
    # The NT-32 route's own row of the kernels line: the 'model' slice.
    results["conv3x3_fwd_nt32"] = {
        k: v for k, v in results["conv3x3_fwd"]["axis_shapes"]["tp"].items()
        if k not in ("route", "dx")}
    for name, bound in _bounds().items():
        results[name].update(bound)
    for name in results:
        results[name].setdefault("library_ms", None)
    return results


# A 'model' rank's Cout slice and a 'space' rank's rows at the flagship's
# lines of two (phase 18): Cout 32 of 64; 8 of the latent's 16 rows, with
# the rows across the cuts in a (B, 2, W, C) halo operand.
TP_COUT, SP_ROWS = C // 2, HW // 2


def _axis_conv_bound(shape, cout: int, which: str, halo: bool = False
                     ) -> dict:
    """K1 (``forward``) or K2 (``wgrad``) in bf16 on a (B, H, W, 64) map
    to ``cout`` channels, as ``_bounds`` counts them: the products of the
    H output rows at the tensor-core rate; x (and its (B, 2, W, 64) halo
    operand where ``halo``) and w in, out (K1), or x, the halo and g in, dW
    in fp32 out (K2)."""
    b, h, w, cin = shape
    px = b * h * w
    flops = 2 * px * 9 * cin * cout
    x_bytes = (px + (b * 2 * w if halo else 0)) * cin * 2
    if which == "forward":
        nbytes = x_bytes + 9 * cin * cout * 2 + px * cout * 2
    else:
        nbytes = x_bytes + px * cout * 2 + 9 * cin * cout * 4
    return _bound(flops, nbytes, PEAK_BF16)


def _check_axis_k12(gen) -> dict:
    """K1 and K2 in bf16 at the 'model' shape against fp64, by the route
    the rule picks, which must be the tensor cores (K1 in one 32-channel
    column block, NT 32), K1 and K2 20 calls bit-equal, and whether K1 at
    NT 32 is bit-equal to the NT-16 plan (two 16-channel blocks) printed;
    the column-parallel dx partial (K1 with bf16 in and fp32 out, on the
    slice's cotangent and flipped weights) on the tensor cores against its
    plain version (F.conv2d of the values in fp32), 20 calls bit-equal.
    Each timed in one run beside the route it replaced (the SIMT K2 at
    Cout 32; the fp32 SIMT K1 on the dx partial's values) and the library
    call (cuDNN's bf16 conv and weight gradient; the fp32 F.conv2d for the
    dx partial), with its plain version's ms, its bound and each wrapper's
    host µs a call (K1 also beside its NT-16 plan, which it replaced);
    the 'model' slice's forward read three more times (device µs of 50
    calls). Then the 'space' shape (``_check_space_k12``)."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            "cuda", torch.bfloat16)
    x, w2d, g = (rnd(B, HW, HW, C), rnd(9 * C, TP_COUT, scale=1 / 24),
                 rnd(B, HW, HW, TP_COUT))
    cout = w2d.shape[1]
    w_oihw = oihw(w2d, C, cout)
    k1 = {"shape": f"{tuple(x.shape)} -> {cout}"}
    k2 = {"shape": f"{tuple(x.shape)} x {tuple(g.shape)}"}
    if not (uses_tensor_cores(x.dtype, C, cout, HW)
            and wgrad_uses_tensor_cores(x.dtype, C, cout, HW)):
        raise AssertionError("K1/K2 at the tp shape off the tensor cores")
    k1["route"] = "tensor cores, 32-channel column blocks"
    k2["route"] = "tensor cores"
    common.reset_launches()
    y = conv3x3_fwd(x, w2d)
    if (common.launches["conv3x3_fwd_tc"],
            common.launches["conv3x3_fwd_nt32"]) != (1, 1):
        raise AssertionError("K1 at the tp shape: not one NT-32 launch")
    ref = conv3x3_fwd_plain(x.double(), w2d.double())
    ulps, share = common.bf16_ulps(y, ref)
    check("K1 bf16 tp (tensor cores, NT 32): ulps", ulps, K1_BF16_ULPS,
          "max")
    check("K1 bf16 tp: share 1 ulp off", share, K1_BF16_SHARE, "share")
    if not all(torch.equal(y, conv3x3_fwd(x, w2d)) for _ in range(20)):
        raise AssertionError("K1 at the tp shape (NT 32): 20 calls are not "
                             "bit-equal")
    y16 = _conv3x3_fwd_tc(x, w2d, nt=16)
    k1["nt16_ulps"], k1["nt16_share"] = common.bf16_ulps(y16, ref)
    k1["bit_equal_to_nt16"] = torch.equal(y, y16)
    print(f"  tp: K1 at NT 32 bit-equal to the NT-16 plan on the same "
          f"inputs: {k1['bit_equal_to_nt16']} (max abs "
          f"{max_abs(y, y16):.3e}; NT 16 {k1['nt16_ulps']:.0f} ulps, share "
          f"{k1['nt16_share']:.2e})")
    dw = conv3x3_wgrad(x, g)
    k2["rel_l2"] = check(
        "K2 bf16 tp (tensor cores) vs fp64",
        rel_l2(dw, conv3x3_wgrad_plain(x.double(), g.double())),
        K2_BF16_REL_L2, "rel_l2")
    if not all(torch.equal(dw, conv3x3_wgrad(x, g)) for _ in range(20)):
        raise AssertionError("tensor-core K2 at the tp shape: 20 calls are "
                             "not bit-equal")
    with common.force_plain():
        k1["max_abs_err"] = max_abs(y, conv3x3_fwd(x, w2d))
        k2["max_abs_err"] = max_abs(dw, conv3x3_wgrad(x, g))
    k1["ulps"], k1["share"] = ulps, share
    k1_fns = {"kernel": lambda: conv3x3_fwd(x, w2d),
              "nt16": lambda: _conv3x3_fwd_tc(x, w2d, nt=16),
              "library": lambda: conv_library(x, w_oihw)}
    k2_fns = {"kernel": lambda: conv3x3_wgrad(x, g),
              "library": lambda: wgrad_library(x, g, w_oihw),
              "simt": lambda: _conv3x3_wgrad_simt(x, g)}
    for row, fns in ((k1, k1_fns), (k2, k2_fns)):
        _timed_row(row, fns)
    host = {("K1", "host_us", "K1 tensor cores, NT 32"): k1_fns["kernel"],
            ("K1", "nt16_host_us", "K1 tensor cores, NT 16"):
                k1_fns["nt16"],
            ("K2", "host_us", "K2 tensor cores"): k2_fns["kernel"],
            ("K2", "simt_host_us", "K2 SIMT"): k2_fns["simt"]}
    k1["device_us_reads"] = [
        device_us({"k1": k1_fns["kernel"]}, reps=50)["k1"] for _ in range(3)]
    _check_dx_partial(k1, w2d, g, host)
    times = _host_turns(host, "at the tp shape")
    k1.update(times["K1"])
    k2.update(times["K2"])
    k1["dx"].update(times["dx"])
    k1.update(_axis_conv_bound(x.shape, cout, "forward"))
    k2.update(_axis_conv_bound(x.shape, cout, "wgrad"))
    _print_axis_row("tp", "K1", k1, (
        f"; the NT-16 plan it replaced {k1['nt16_ms']:.4f} ms, "
        f"{k1['nt16_device_us']:.2f} device us, host "
        f"{k1['nt16_host_us']:.2f} us"))
    _print_axis_row("tp", "K2", k2, (
        f"; the SIMT K2 it replaced {k2['simt_ms']:.4f} ms, "
        f"{k2['simt_device_us']:.2f} device us, host "
        f"{k2['simt_host_us']:.2f} us"))
    print(f"  tp: K1 forward at Cout 32, device us of 50 calls, three more "
          f"reads: {', '.join(f'{u:.2f}' for u in k1['device_us_reads'])}")
    dx = k1["dx"]
    print(f"  tp: the dx partial {dx['shape']}, bf16 in, fp32 out, on the "
          f"tensor cores {dx['ms']:.4f} ms, {dx['device_us']:.2f} device "
          f"us, host {dx['host_us']:.2f} us (plain {dx['plain_ms']:.4f} ms;"
          f" fp32 F.conv2d {dx['library_ms']:.4f} ms, "
          f"{dx['library_device_us']:.2f} device us; bound "
          f"{dx['bound_ms'] * 1e3:.2f} us by {dx['bound_by']}); the fp32 "
          f"SIMT K1 it replaced {dx['simt_ms']:.4f} ms, "
          f"{dx['simt_device_us']:.2f} device us, host "
          f"{dx['simt_host_us']:.2f} us")
    k1_sp, k2_sp = _check_space_k12(rnd)
    return {"conv3x3_fwd": {"tp": k1, "sp": k1_sp},
            "conv3x3_wgrad": {"tp": k2, "sp": k2_sp}}


def _timed_row(row: dict, fns: dict) -> None:
    """Into ``row``: each fn's CUDA-event ms and device µs from one run of
    turns (keys ``ms``/``device_us`` for "kernel", else prefixed with the
    fn's name), and the kernel's plain version's ms."""
    for key, (ms, us) in _time_turns(fns).items():
        prefix = "" if key == "kernel" else f"{key}_"
        row[f"{prefix}ms"], row[f"{prefix}device_us"] = ms, us
    with common.force_plain():
        row["plain_ms"] = median_ms(fns["kernel"])


def _print_axis_row(label: str, kernel: str, row: dict,
                    more: str = "") -> None:
    print(f"  {label}: {kernel} {row['shape']} on the tensor cores "
          f"{row['ms']:.4f} ms, {row['device_us']:.2f} device us, host "
          f"{row['host_us']:.2f} us (plain {row['plain_ms']:.4f} ms; cuDNN "
          f"{row['library_ms']:.4f} ms, {row['library_device_us']:.2f} "
          f"device us; bound {row['bound_ms'] * 1e3:.2f} us by "
          f"{row['bound_by']}){more}")


# A 'space' rank's halo operand: at the top of the frame (its row 0 the
# frame's zero padding), at the bottom (row 1) or inside.
HALO_WHERE = ("top", "bottom", "interior")


def _check_space_k12(rnd) -> tuple:
    """K1 and K2 at a 'space' rank's shape, x (B, 8, 16, 64) with a (B, 2,
    16, 64) halo operand and g (B, 8, 16, 64), on the tensor cores (the
    rule's route), at the top, the bottom and inside the frame: K1 within
    one bf16 ulp of the fp64 conv of the 10 rows (at most
    ``K1_BF16_SHARE`` one off), K2 within ``K2_BF16_REL_L2`` of fp64 and
    20 calls bit-equal. Inside the frame, each timed in one run beside
    the composition it replaces (cat the halo rows onto x, K1/K2 on the
    10-row tile, crop K1's first and last rows; K2's cotangent zero-padded
    to 10 rows, as the crop's backward made it), cuDNN on the 10-row tile,
    with host µs and the bound of the 8 rows and the halo. Then the SIMT
    K1/K2 with a halo in fp32 against their plain versions (1e-4 max abs,
    1e-5 relative L2) at (2, 5, 7, 16) -> 24 (ragged) and the rank's
    shape at B = 4."""
    x, w2d, g = (rnd(B, SP_ROWS, HW, C), rnd(9 * C, C, scale=1 / 24),
                 rnd(B, SP_ROWS, HW, C))
    k1 = {"shape": f"{tuple(x.shape)} + halo (B, 2, {HW}, {C}) -> {C}",
          "route": "tensor cores", "cases": {}}
    k2 = {"shape": f"{tuple(x.shape)} + halo x {tuple(g.shape)}",
          "route": "tensor cores", "cases": {}}
    if not (uses_tensor_cores(x.dtype, C, C, HW)
            and wgrad_uses_tensor_cores(x.dtype, C, C, HW)):
        raise AssertionError("K1/K2 at the sp shape off the tensor cores")
    for where in HALO_WHERE:
        halo = rnd(B, 2, HW, C)
        if where != "interior":
            halo[:, 0 if where == "top" else 1] = 0
        common.reset_launches()
        y = conv3x3_fwd(x, w2d, halo=halo)
        dw = conv3x3_wgrad(x, g, halo=halo)
        if (common.launches["conv3x3_fwd_tc"], common.launches[
                "conv3x3_wgrad_tc"], common.launches["conv3x3_fwd_halo"],
                common.halo_heights) != (1, 1, 1, {SP_ROWS}):
            raise AssertionError(f"K1/K2 at the sp shape ({where}): not "
                                 f"the tensor cores' halo route")
        ulps, share = common.bf16_ulps(y, conv3x3_fwd_plain(
            x.double(), w2d.double(), halo=halo.double()))
        check(f"K1 bf16 sp {where} (tc, halo): ulps", ulps, K1_BF16_ULPS,
              "max")
        check(f"K1 bf16 sp {where}: share 1 ulp off", share,
              K1_BF16_SHARE, "share")
        err = check(f"K2 bf16 sp {where} (tc, halo) vs fp64", rel_l2(
            dw, conv3x3_wgrad_plain(x.double(), g.double(), halo.double())),
            K2_BF16_REL_L2, "rel_l2")
        if not all(torch.equal(dw, conv3x3_wgrad(x, g, halo=halo))
                   for _ in range(20)):
            raise AssertionError(f"tensor-core K2 at the sp shape "
                                 f"({where}): 20 calls are not bit-equal")
        with common.force_plain():
            k1["cases"][where] = {"ulps": ulps, "share": share,
                                  "max_abs_err": max_abs(y, conv3x3_fwd(
                                      x, w2d, halo=halo))}
            k2["cases"][where] = {"rel_l2": err, "max_abs_err": max_abs(
                dw, conv3x3_wgrad(x, g, halo=halo))}
    for row in (k1, k2):
        row["max_abs_err"] = max(c["max_abs_err"]
                                 for c in row["cases"].values())
    # The interior case, timed.
    tile = torch.cat([halo[:, :1], x, halo[:, 1:]], dim=1)
    g_tile = F.pad(g, (0, 0, 0, 0, 1, 1))
    w_oihw = oihw(w2d, C, C)
    k1_fns = {"kernel": lambda: conv3x3_fwd(x, w2d, halo=halo),
              "composition": lambda: conv3x3_fwd(torch.cat(
                  [halo[:, :1], x, halo[:, 1:]], dim=1), w2d)[:, 1:-1],
              "library": lambda: conv_library(tile, w_oihw)}
    k2_fns = {"kernel": lambda: conv3x3_wgrad(x, g, halo=halo),
              "composition": lambda: conv3x3_wgrad(torch.cat(
                  [halo[:, :1], x, halo[:, 1:]], dim=1),
                  F.pad(g, (0, 0, 0, 0, 1, 1))),
              "library": lambda: wgrad_library(tile, g_tile, w_oihw)}
    for row, fns in ((k1, k1_fns), (k2, k2_fns)):
        _timed_row(row, fns)
    times = _host_turns(
        {("K1", "host_us", "K1 tensor cores, halo"): k1_fns["kernel"],
         ("K2", "host_us", "K2 tensor cores, halo"): k2_fns["kernel"]},
        "at the sp shape")
    k1.update(times["K1"])
    k2.update(times["K2"])
    k1.update(_axis_conv_bound(x.shape, C, "forward", halo=True))
    k2.update(_axis_conv_bound(x.shape, C, "wgrad", halo=True))
    for kernel, row in (("K1", k1), ("K2", k2)):
        _print_axis_row("sp", kernel, row, (
            f"; the cat-tile-crop composition it replaced "
            f"{row['composition_ms']:.4f} ms, "
            f"{row['composition_device_us']:.2f} device us; cuDNN on the "
            f"10-row tile"))
    k1["simt_fp32"], k2["simt_fp32"] = _check_space_simt_fp32()
    return k1, k2


def _check_space_simt_fp32() -> tuple:
    """The SIMT K1 and K2 with a halo in fp32 (the rule's route) against
    their plain versions on the card (TF32 off): max abs / relative L2 by
    shape."""
    gen = torch.Generator().manual_seed(1)
    k1, k2 = {}, {}
    for b, h, w, cin, cout in ((2, 5, 7, 16, 24), (4, SP_ROWS, HW, C, C)):
        x, halo, g = (torch.randn(*shape, generator=gen).cuda() for shape in
                      ((b, h, w, cin), (b, 2, w, cin), (b, h, w, cout)))
        w2d = (torch.randn(9 * cin, cout, generator=gen)
               / (9 * cin) ** 0.5).cuda()
        common.reset_launches()
        y, dw = conv3x3_fwd(x, w2d, halo=halo), conv3x3_wgrad(x, g, halo=halo)
        if (common.launches["conv3x3_fwd_simt"],
                common.launches["conv3x3_wgrad_simt"]) != (1, 1):
            raise AssertionError("the fp32 halo K1/K2 off SIMT")
        with common.force_plain():
            y_ref = conv3x3_fwd(x, w2d, halo=halo)
            dw_ref = conv3x3_wgrad(x, g, halo=halo)
        label = f"({b}, {h}, {w}, {cin}) -> {cout}"
        k1[label] = check(f"K1 fp32 SIMT, halo, {label}", max_abs(y, y_ref),
                          _TOL["conv3x3_fwd"][0], "max_abs")
        k2[label] = check(f"K2 fp32 SIMT, halo, {label}",
                          rel_l2(dw, dw_ref), _TOL["conv3x3_wgrad"][0],
                          "rel_l2")
    return k1, k2


def _check_dx_partial(k1: dict, w2d: torch.Tensor, g: torch.Tensor,
                      host: dict) -> None:
    """A 'model' rank's dx partial (parallel/tp.py): K1 with bf16 in and
    fp32 out on the Cout slice's cotangent and flipped weights, on the
    tensor cores, against its plain version (``_TOL["conv3x3_fwd as
    dx"]``) and 20 calls bit-equal; timed beside the fp32 SIMT K1 on the
    same values (the route it replaced) and the fp32 F.conv2d; into
    ``k1["dx"]``, its wrappers into ``host``."""
    cout = g.shape[3]
    w_t = flip_transpose(w2d, C, cout)
    if not uses_tensor_cores(g.dtype, cout, C, HW, torch.float32):
        raise AssertionError("the dx partial is off the tensor cores")
    gf, wf = g.float(), w_t.float()
    wf_oihw = oihw(wf, cout, C)
    fns = {"kernel": lambda: conv3x3_fwd(g, w_t, out_dtype=torch.float32),
           "simt": lambda: _conv3x3_fwd_simt(gf, wf),
           "library": lambda: conv_library(gf, wf_oihw)}
    dx = fns["kernel"]()
    with common.force_plain():
        plain = fns["kernel"]()
    row = {"shape": f"{tuple(g.shape)} -> {C}", "route": "tensor cores",
           "max_abs_err": check("K1 bf16 -> fp32, the dx partial",
                                max_abs(dx, plain),
                                _TOL["conv3x3_fwd as dx"][0], "max_abs")}
    if dx.dtype != torch.float32 or not all(
            torch.equal(dx, fns["kernel"]()) for _ in range(20)):
        raise AssertionError("the dx partial: not fp32, or 20 calls are "
                             "not bit-equal")
    for key, (ms, us) in _time_turns(fns).items():
        prefix = "" if key == "kernel" else f"{key}_"
        row[f"{prefix}ms"], row[f"{prefix}device_us"] = ms, us
    with common.force_plain():
        row["plain_ms"] = median_ms(fns["kernel"])
    px = B * HW * HW
    # bf16 cotangent and weights in, fp32 out.
    row.update(_bound(2 * px * 9 * cout * C,
                      px * cout * 2 + 9 * cout * C * 2 + px * C * 4,
                      PEAK_BF16))
    k1["dx"] = row
    host[("dx", "host_us", "the dx partial, tensor cores")] = fns["kernel"]
    host[("dx", "simt_host_us", "the dx partial, fp32 SIMT")] = fns["simt"]


def _moments_f64(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The moments pass's sums in fp64."""
    b, h, w, ct = x.shape
    xd = x.double().reshape(b, h * w, groups, ct // groups)
    return torch.stack([xd.sum(dim=(1, 3)), (xd * xd).sum(dim=(1, 3))], -1)


def _of_largest_sum(mom: torch.Tensor, ref: torch.Tensor) -> float:
    return max_abs(mom, ref) / ref.double().abs().max().item()


def _moments_vec_at(x: torch.Tensor, groups: int,
                    plan: SamplePlan) -> torch.Tensor:
    """The vector moments pass at ``plan`` rather than the rule's, not
    counted: the cluster sizes the rule was chosen among."""
    b, h, w, ct = x.shape
    mom = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
    err = _build.library().odek_gru_moments_vec(
        x.data_ptr(), mom.data_ptr(), b, h * w, ct, groups, *plan,
        common.DTYPE_CODES[x.dtype], common.stream_handle(x))
    if err:
        raise RuntimeError(f"gru_moments_vec at {plan}: CUDA error {err}")
    return mom


def _var_mean(x: torch.Tensor, groups: int):
    """torch.var_mean over the moments pass's (B, HW, G, C/G) view: the
    same statistics as mean and variance, the moments pass's yardstick."""
    b, h, w, ct = x.shape
    return torch.var_mean(x.view(b, h * w, groups, ct // groups),
                          dim=(1, 3))


def _check_axis_gru(gen) -> dict:
    """The moments-in K3 and K4 and their moments pass at a 'space'
    rank's rows, each on the vector kernel its rule names: the moments
    pass on the gates (G 4) and the candidate (G 2) within 1e-5 of the
    largest sum of the plain version and of fp64 sums; the epilogues on
    those moments against their plain versions on the same moments (fp32
    1e-5; bf16 one ulp of the fp64 formula, whose moments are the same
    rows') and bit-equal to the scalar kernels they replaced; each
    bit-equal over 20 calls. Then each alone in bf16, timed in one run
    beside its scalar kernel (and the moments pass beside torch.var_mean),
    with its plain version's time and each wrapper's host µs a call; and
    the moments pass on the gates at other plans (512 and 1024 threads a
    block, clusters of 2 and 4 blocks a sample). One rank: the moments
    are its own, as a line of one's."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    base = {"gates": rnd(B, SP_ROWS, HW, 2 * C),
            "h": torch.tanh(rnd(B, SP_ROWS, HW, C)),
            "cand": rnd(B, SP_ROWS, HW, C),
            "z": torch.sigmoid(rnd(B, SP_ROWS, HW, C))}
    gs, gb = 1.0 + 0.1 * rnd(2 * C), 0.1 * rnd(2 * C)
    cs, cb = 1.0 + 0.1 * rnd(C), 0.1 * rnd(C)
    n_g, n_c = float(SP_ROWS * HW * (2 * C // 4)), float(
        SP_ROWS * HW * (C // 2))

    def bit_equal_calls(label, out, fn):
        if not all(all(torch.equal(a, b) for a, b in
                       zip(out, _as_tuple(fn()))) for _ in range(20)):
            raise AssertionError(f"{label}: 20 calls are not bit-equal")

    def epilogues(t, mom_g, mom_c):
        return {
            "gru_gates_mom": (
                lambda kernel="rule": gates_from_moments(
                    t["gates"], t["h"], mom_g, gs, gb, 4, n_g,
                    kernel=kernel),
                lambda: gates_f64(t["gates"], t["h"], gs, gb, 4)),
            "gru_blend_mom": (
                lambda kernel="rule": blend_from_moments(
                    t["cand"], t["z"], t["h"], mom_c, cs, cb, 2, n_c,
                    kernel=kernel),
                lambda: blend_f64(t["cand"], t["z"], t["h"], cs, cb, 2))}

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = {k: v.to(dtype) for k, v in base.items()}
        kind = str(dtype)[6:]
        moments = {"gates": (t["gates"], 4), "candidate": (t["cand"], 2)}
        for what, (x, groups) in moments.items():
            label = f"gru_moments {kind} on the {what}"
            common.reset_launches()
            mom = gru_moments(x, groups)
            if (common.launches["gru_moments_vec"],
                    common.launches["gru_moments_scalar"]) != (1, 0):
                raise AssertionError(f"{label}: not the vector kernel")
            with common.force_plain():
                plain = gru_moments(x, groups)
            err = check(f"{label} (of the largest sum)",
                        _of_largest_sum(mom, plain), 1e-5, "max_abs")
            check(f"{label}, fp64 (of the largest sum)",
                  _of_largest_sum(mom, _moments_f64(x, groups)), 1e-5,
                  "max_abs")
            bit_equal_calls(label, (mom,),
                            lambda x=x, g=groups: gru_moments(x, g))
            if dtype == torch.bfloat16 and what == "gates":
                results["gru_moments"] = {"max_abs_err": err}
        ops = epilogues(t, gru_moments(t["gates"], 4),
                        gru_moments(t["cand"], 2))
        for name, (fn, f64) in ops.items():
            label = f"{name} {kind}"
            common.reset_launches()
            out = _as_tuple(fn())
            if (common.launches[f"{name}_vec"],
                    common.launches[f"{name}_scalar"]) != (1, 0):
                raise AssertionError(f"{label}: not the vector kernel")
            if not all(torch.equal(a, b)
                       for a, b in zip(out, _as_tuple(fn("scalar")))):
                raise AssertionError(f"{label}: the vector kernel is not "
                                     "bit-equal to the scalar one")
            print(f"  {label}: the vector kernel bit-equal to the scalar "
                  "kernel")
            with common.force_plain():
                ref = _as_tuple(fn())
            if dtype == torch.float32:
                err = check(label, max(max_abs(o, r) for o, r in
                                       zip(out, ref)), 1e-5, "max_abs")
            else:
                readings = [common.bf16_ulps(o, r) for o, r in
                            zip(out, _as_tuple(f64()))]
                check(f"{label}: ulps", max(u for u, _ in readings),
                      K34_BF16_ULPS, "max")
                check(f"{label}: share 1 ulp off",
                      max(v for _, v in readings), K34_BF16_SHARE, "share")
                err = max(max_abs(o, r) for o, r in zip(out, ref))
            bit_equal_calls(label, out, fn)
            if dtype == torch.bfloat16:
                results[name] = {"max_abs_err": err}
    # Each kernel alone, on its inputs' moments taken once: the moments
    # pass on the gates (its row) and on the candidate.
    t = {k: v.to(torch.bfloat16) for k, v in base.items()}
    results["gru_moments"]["candidate"] = {}
    for row, x, groups in ((results["gru_moments"], t["gates"], 4),
                           (results["gru_moments"]["candidate"], t["cand"],
                            2)):
        _timed_row(row, {
            "kernel": lambda x=x, g=groups: gru_moments(x, g),
            "scalar": lambda x=x, g=groups: gru_moments(x, g, "scalar"),
            "library": lambda x=x, g=groups: _var_mean(x, g)})
    ops = epilogues(t, gru_moments(t["gates"], 4), gru_moments(t["cand"], 2))
    for name, (fn, _) in ops.items():
        _timed_row(results[name], {"kernel": fn,
                                   "scalar": lambda fn=fn: fn("scalar")})
    # The plan's alternatives on the gates' 128 pixels: one block of 256
    # (the rule's), 512 or 1024 threads a sample, or clusters of 2 and 4
    # blocks of 256.
    sweep = _time_turns({
        f"{threads}x{ranks}": lambda n=threads, r=ranks: _moments_vec_at(
            t["gates"], 4, SamplePlan(n, r, SP_ROWS * HW // r))
        for threads, ranks in ((256, 1), (512, 1), (1024, 1), (256, 2),
                               (256, 4))})
    results["gru_moments"]["plan_device_us"] = {
        plan: us for plan, (_, us) in sweep.items()}
    print("  gru_moments bf16 on the gates, threads x blocks a sample: "
          + ", ".join(f"{plan} {ms:.4f} ms {us:.2f} device us"
                      for plan, (ms, us) in sweep.items()))
    (fg, _), (fc, _) = ops["gru_gates_mom"], ops["gru_blend_mom"]
    host = _host_turns({
        ("gru_moments", "host_us", "the moments pass, vector"):
            lambda: gru_moments(t["gates"], 4),
        ("gru_moments", "scalar_host_us", "the moments pass, scalar"):
            lambda: gru_moments(t["gates"], 4, "scalar"),
        ("gru_gates_mom", "host_us", "K3 moments in, vector"): fg,
        ("gru_gates_mom", "scalar_host_us", "K3 moments in, scalar"):
            lambda: fg("scalar"),
        ("gru_blend_mom", "host_us", "K4 moments in, vector"): fc,
        ("gru_blend_mom", "scalar_host_us", "K4 moments in, scalar"):
            lambda: fc("scalar")}, "at a 'space' rank's rows")
    for name, row in host.items():
        results[name].update(row)
    px = B * SP_ROWS * HW
    results["gru_moments"].update(_bound(
        2 * px * 2 * C, px * 2 * C * 2 + B * 4 * 2 * 4, PEAK_FP32))
    results["gru_moments"]["candidate"].update(_bound(
        2 * px * C, px * C * 2 + B * 2 * 2 * 4, PEAK_FP32))
    results["gru_gates_mom"].update(_bound(
        10 * px * 2 * C, px * 5 * C * 2 + 4 * C * 4 + B * 4 * 2 * 4,
        PEAK_FP32))
    results["gru_blend_mom"].update(_bound(
        10 * px * C, px * 4 * C * 2 + 2 * C * 4 + B * 2 * 2 * 4, PEAK_FP32))
    rows = {"gru_moments on the gates": results["gru_moments"],
            "gru_moments on the candidate":
                results["gru_moments"]["candidate"],
            "gru_gates_mom": results["gru_gates_mom"],
            "gru_blend_mom": results["gru_blend_mom"]}
    for name, r in rows.items():
        host = ("" if "host_us" not in r else
                f"; host {r['host_us']:.2f} us, scalar "
                f"{r['scalar_host_us']:.2f} us")
        library = ("" if "library_ms" not in r else
                   f"; torch.var_mean (mean and variance) "
                   f"{r['library_ms']:.4f} ms, "
                   f"{r['library_device_us']:.2f} device us")
        print(f"  {name} bf16 at a 'space' rank's rows, vector kernel: "
              f"{r['ms']:.4f} ms ({r['device_us']:.2f} device us; plain "
              f"{r['plain_ms']:.4f} ms), bound {r['bound_ms'] * 1e3:.2f} "
              f"us by {r['bound_by']}; the scalar kernel it replaced "
              f"{r['scalar_ms']:.4f} ms, {r['scalar_device_us']:.2f} "
              f"device us{host}{library}")
    # The vector kernels' own rows of the kernels line: the rule's routes.
    for name in ("gru_gates_mom", "gru_blend_mom", "gru_moments"):
        results[f"{name}_vec"] = dict(results[name])
    return results


def _check_axis_shapes(gen) -> dict:
    print("  -- the shapes of phase 18 ('model' and 'space' lines of 2)")
    with torch.no_grad():
        return {**_check_axis_k12(gen), **_check_axis_gru(gen)}


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): bf16
# on the tensor cores, fp32 off them, HBM3 bytes.
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def _bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations
    over their peak rate and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def _bounds() -> dict:
    """Each kernel's bound at the shape phase 3 times it: K1-K4 at the
    flagship shapes in bf16, K5-K7 at the FlowNetC bench shape in bf16, K8
    at (8, 64, 64, 3) in fp32. Products that a matrix unit could do (K1,
    K2, the correlation dot products) count against the bf16 tensor-core
    rate; elementwise work (about 10 operations an element for the
    GroupNorm tails, 2 a channel for the norm) against fp32.

    K5-K7 count only the (pixel, displacement) pairs whose window lies in
    the map (1,024 of a sample's 28,224 at the bench shape): the other
    outputs are zeros, and the cotangent there enters no gradient. K5
    still writes its whole (B, H, W, n*n) output; K6 and K7 need only the
    cotangent's in-map entries."""
    px = B * HW * HW
    conv_flops = 2 * px * 9 * C * C
    b, h, w, c = CORR_SHAPES["bench"]
    n = n_displacements(CORR_D, CORR_STRIDE) ** 2
    pairs = b * int((pair_displacements(h, w, CORR_D, CORR_STRIDE)
                     >= 0).sum())
    corr_flops = 2 * pairs * c
    feature_bytes = b * h * w * c * 2
    # f1, f2 in, the cost volume out; a feature map and the in-map
    # cotangent in, a gradient out.
    fwd_bytes = 2 * feature_bytes + b * h * w * n * 2
    bwd_bytes = 2 * feature_bytes + pairs * 2
    nb, nh, nw, nc = NORM_SHAPES[0]
    return {
        # x and w in, out; x and g in, dW (fp32) out.
        "conv3x3_fwd": _bound(conv_flops, 2 * px * C * 2 + 9 * C * C * 2,
                              PEAK_BF16),
        "conv3x3_wgrad": _bound(conv_flops, 2 * px * C * 2 + 9 * C * C * 4,
                                PEAK_BF16),
        # gates (2C) and h in, z and r*h out; cand, z, h in, out; bf16,
        # with fp32 scale and bias.
        "gru_gates": _bound(10 * px * 2 * C, px * 5 * C * 2 + 4 * C * 4,
                            PEAK_FP32),
        "gru_blend": _bound(10 * px * C, px * 4 * C * 2 + 2 * C * 4,
                            PEAK_FP32),
        "correlation_fwd": _bound(corr_flops, fwd_bytes, PEAK_BF16),
        "correlation_bwd_f1": _bound(corr_flops, bwd_bytes, PEAK_BF16),
        "correlation_bwd_f2": _bound(corr_flops, bwd_bytes, PEAK_BF16),
        "channelnorm": _bound(2 * nb * nh * nw * nc,
                              nb * nh * nw * (nc + 1) * 4, PEAK_FP32),
    }


# FlowNetC bench features, FlyingChairs features, correlation geometry.
CORR_SHAPES = {"bench": (256, 8, 8, 256), "chairs": (8, 48, 64, 256)}
CORR_D, CORR_STRIDE = 20, 2
NORM_SHAPES = ((8, 64, 64, 3), (8, 64, 64, 2))


def _flow_tol(name: str, dtype, tc: bool = False) -> tuple:
    """(tolerance, metric) of K5-K7 against their plain versions; ``tc``
    where the call took a tensor-core kernel.

    fp32: the kernel and the plain version sum the same fp32 products in
    another order. bf16: a product of two bf16 values is exact in fp32.
    The SIMT K6 and K7 add those products in the same order as their plain
    versions, divide as IEEE does, and round once to nearest, so they are
    bit-equal. K5, and the tensor-core K6 and K7, sum their products in
    another order than the plain version, so the two round differently
    where their fp32 sums straddle a bf16 rounding boundary: 1e-4 relative
    L2. A kernel that truncated, or rounded its accumulator partway, would
    read about 2e-3."""
    if dtype == torch.float32:
        return 1e-5, "max_abs"
    if name == "correlation_fwd" or tc:
        return 1e-4, "rel_l2"
    return 0.0, "max_abs"


# bf16 K5-K7 at the bench shape (tensor-core, SIMT and plain) against
# fp64 of the same bf16 inputs rounded to bf16 (common.bf16_ulps): every
# output within one ulp, and at most this share of outputs one ulp off.
# Each rounds an fp32 sum once, so only outputs whose fp64 value lies
# within fp32 noise of a rounding boundary can differ; a kernel that
# truncated would read about 0.5 of the nonzero outputs.
CORR_BF16_ULPS, CORR_BF16_SHARE = 1.0, 1e-3
CORR_TC = ("correlation_fwd", "correlation_bwd_f1", "correlation_bwd_f2")


def _check_corr_route(label: str, dtype, tc: bool) -> None:
    """Since the last reset, every K5, K6 and K7 launch took the
    tensor-core kernel (``tc``) or none did."""
    counts = common.launches
    for name in CORR_TC:
        want = counts[name] if tc else 0
        if counts[name] == 0 or counts[f"{name}_tc"] != want:
            raise AssertionError(
                f"{name} {label} {dtype}: {counts[f'{name}_tc']} of "
                f"{counts[name]} launches on the tensor cores, expected "
                f"{want}")
    print(f"    {label} {str(dtype)[6:]}: K5-K7 routed to "
          f"{'the tensor cores' if tc else 'SIMT'} (" + ", ".join(
              f"{k} {counts[k]}" for k in counts
              if k.startswith(CORR_TC)) + ")")


def _flow_ops(shape, dtype, gen):
    def rnd(*s):
        return torch.randn(*s, generator=gen).to("cuda", dtype)
    b, h, w, c = shape
    f1, f2, g = rnd(b, h, w, c), rnd(b, h, w, c), rnd(b, h, w, 441)
    return {
        "correlation_fwd": lambda: correlation_fwd(f1, f2, CORR_D,
                                                   CORR_STRIDE),
        "correlation_bwd_f1": lambda: correlation_bwd_f1(g, f2, CORR_D,
                                                         CORR_STRIDE),
        "correlation_bwd_f2": lambda: correlation_bwd_f2(g, f1, CORR_D,
                                                         CORR_STRIDE),
    }


def _check_flow_kernels(gen) -> dict:
    """K5-K8 against their plain versions; returns the bf16 bench-shape
    (K5-K7) and fp32 FlowNet2-shape (K8) errors and median times."""
    print("  FlowNet kernels vs plain versions (d=20, stride 2):")
    results = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for label, shape in CORR_SHAPES.items():
                tc = dtype == torch.bfloat16 and label == "bench"
                common.reset_launches()
                for name, fn in _flow_ops(shape, dtype, gen).items():
                    out = fn()
                    with common.force_plain():
                        ref = fn()
                    tol, kind = _flow_tol(name, dtype, tc)
                    metric = max_abs if kind == "max_abs" else rel_l2
                    check(f"{name} {label} {str(dtype)[6:]}",
                          metric(out, ref), tol, kind)
                    if not tc:
                        check(f"{name} {label} {str(dtype)[6:]}: 20 calls",
                              float(sum(not torch.equal(out, fn())
                                        for _ in range(20))), 0.0, "unequal")
                    # The tensor-core K5-K7 are timed beside the SIMT ones
                    # in _check_corr_tc.
                    if dtype == torch.bfloat16 and not tc:
                        ms = median_ms(fn)
                        with common.force_plain():
                            plain_ms = median_ms(fn)
                        us = device_us({name: fn})[name]
                        print(f"    {name} {label} bf16 median ms: kernel "
                              f"{ms:.4f} plain {plain_ms:.4f}; kernel device "
                              f"us a call {us:.2f}")
                _check_corr_route(label, dtype, tc)
        results["channelnorm"] = _check_channelnorm(gen)
        for name, result in _check_corr_tc(gen).items():
            results.setdefault(name, {}).update(result)
    _check_flow_gradients(gen)
    return results


def _k8_control(x: torch.Tensor | None, out: torch.Tensor | None,
                n_pix: int, c: int) -> None:
    """A control kernel on K8's grid (a thread a pixel, blocks of 256):
    with ``x`` None the empty kernel, the floor no launch goes below; else
    one that reads all of x with whole-warp loads and writes one value a
    pixel to ``out``, with no squares and no square root."""
    err = _build.library().odek_channelnorm_control(
        None if x is None else x.data_ptr(),
        None if out is None else out.data_ptr(), n_pix, c,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"channelnorm control: launch failed with CUDA "
                           f"error {err}")


def _check_channelnorm(gen) -> dict:
    """K8 at FlowNet2's shapes, with exact-zero pixels: in fp32 and bf16
    one launch, bit-equal to the plain version. Then in fp32, in one run
    at each shape, K8, the empty kernel and the read-then-write control on
    its grid (``_k8_control``), the plain version and
    torch.linalg.vector_norm. Returns C = 3's numbers, C = 2's under
    "c2_", and the wrapper's host µs a call."""
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in NORM_SHAPES:
            label = f"channelnorm {shape} {str(dtype)[6:]}"
            x = torch.randn(*shape, generator=gen).to("cuda", dtype)
            x[0, :4] = 0.0
            ref = channelnorm_plain(x)
            common.reset_launches()
            out = channelnorm_fwd(x)
            if common.launches["channelnorm"] != 1:
                raise AssertionError(f"{label}: {common.launches} launches")
            err = check(label, max_abs(out, ref), 0.0, "max_abs")
            if dtype == torch.bfloat16:
                continue
            n_pix, c = x[..., 0].numel(), shape[-1]
            sink = torch.empty(n_pix, device="cuda")
            times = _time_turns({
                "kernel": lambda: channelnorm_fwd(x),
                "floor": lambda: _k8_control(None, None, n_pix, c),
                "control": lambda: _k8_control(x, sink, n_pix, c),
                "plain": lambda: channelnorm_plain(x),
                "library": lambda: torch.linalg.vector_norm(
                    x, dim=-1, keepdim=True)})
            print(f"    {label}, one run, CUDA-event median ms / device us "
                  "a call: " + ", ".join(f"{k} {ms:.4f} / {us:.2f}"
                                         for k, (ms, us) in times.items()))
            prefix = "" if shape == NORM_SHAPES[0] else "c2_"
            for k, (ms, us) in times.items():
                key = "" if k == "kernel" else f"{k}_"
                result[f"{prefix}{key}ms"] = ms
                result[f"{prefix}{key}device_us"] = us
            if shape == NORM_SHAPES[0]:
                result["max_abs_err"] = err
    x = torch.randn(*NORM_SHAPES[0], generator=gen).cuda()
    result.update(_host_turns({
        ("channelnorm", "host_us", f"at {NORM_SHAPES[0]}"):
            lambda: channelnorm_fwd(x),
    }, "fp32")["channelnorm"])
    return result


def _check_corr_tc(gen) -> dict:
    """The tensor-core K5-K7 at the FlowNetC bench shape in bf16: they, the
    SIMT kernels and the plain versions against fp64 of the same bf16
    inputs (common.bf16_ulps), the tensor-core kernels also against the
    bf16 plain versions (relative L2) and bit-equal over 20 calls; the
    three timed in one run; then the host time a call at B=1 of the public
    K5-K7 wrappers (which take the tensor cores) and of their SIMT
    ones."""
    def rnd(*s):
        return torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)

    geometry = (CORR_D, CORR_STRIDE)
    b, h, w, c = CORR_SHAPES["bench"]
    n2 = n_displacements(*geometry) ** 2
    f1, f2, g = rnd(b, h, w, c), rnd(b, h, w, c), rnd(b, h, w, n2)
    cases = {
        "correlation_fwd": ((f1, f2), _correlation_fwd_tc,
                            _correlation_fwd_simt, correlation_fwd_plain),
        "correlation_bwd_f1": ((g, f2), _correlation_bwd_f1_tc,
                               _correlation_bwd_f1_simt,
                               correlation_bwd_f1_plain),
        "correlation_bwd_f2": ((g, f1), _correlation_bwd_f2_tc,
                               _correlation_bwd_f2_simt,
                               correlation_bwd_f2_plain),
    }
    results = {}
    for name, (args, tc, simt, plain) in cases.items():
        ref = plain(*(a.double() for a in args), *geometry)
        outs = {}
        for label, fn in (("tensor cores", tc), ("SIMT", simt),
                          ("plain", plain)):
            outs[label] = fn(*args, *geometry)
            ulps, share = common.bf16_ulps(outs[label], ref)
            check(f"{name} bench bf16, {label}: ulps", ulps, CORR_BF16_ULPS,
                  "max")
            check(f"{name} bench bf16, {label}: share 1 ulp off", share,
                  CORR_BF16_SHARE, "share")
        first = outs["tensor cores"]
        check(f"{name} bench bf16, tensor cores vs plain",
              rel_l2(first, outs["plain"]), 1e-4, "rel_l2")
        if not all(torch.equal(first, tc(*args, *geometry))
                   for _ in range(20)):
            raise AssertionError(f"tensor-core {name}: 20 calls are not "
                                 "bit-equal")
        times = _time_turns({"tc": lambda: tc(*args, *geometry),
                             "simt": lambda: simt(*args, *geometry),
                             "plain": lambda: plain(*args, *geometry)})
        result = {"max_abs_err": max_abs(first, outs["plain"])}
        for label, (ms, us) in times.items():
            result["ms" if label == "tc" else f"{label}_ms"] = ms
            result[f"{label}_device_us"] = us
        print(f"  {name} bf16 at (256, 8, 8, 256), one run: CUDA-event "
              f"median ms tc {result['ms']:.4f} simt {result['simt_ms']:.4f} "
              f"plain {result['plain_ms']:.4f}; device us a call tc "
              f"{result['tc_device_us']:.2f} simt "
              f"{result['simt_device_us']:.2f} plain "
              f"{result['plain_device_us']:.2f}")
        results[name] = result
    x, y = rnd(1, h, w, c), rnd(1, h, w, c)
    g1 = rnd(1, h, w, n2)
    host = _host_turns({
        ("correlation_fwd", "host_us", "tensor cores"):
            lambda: correlation_fwd(x, y, *geometry),
        ("correlation_fwd", "simt_host_us", "SIMT"):
            lambda: _correlation_fwd_simt(x, y, *geometry),
        ("correlation_bwd_f2", "host_us", "tensor cores"):
            lambda: correlation_bwd_f2(g1, x, *geometry),
        ("correlation_bwd_f2", "simt_host_us", "SIMT"):
            lambda: _correlation_bwd_f2_simt(g1, x, *geometry),
        ("correlation_bwd_f1", "host_us", "tensor cores"):
            lambda: correlation_bwd_f1(g1, y, *geometry),
        ("correlation_bwd_f1", "simt_host_us", "SIMT"):
            lambda: _correlation_bwd_f1_simt(g1, y, *geometry),
    })
    for name, times in host.items():
        results.setdefault(name, {}).update(times)
    return results


def _check_flow_gradients(gen) -> None:
    print("  CorrelationFn and ChannelNormFn gradients (fp32) vs autograd "
          "of the fp64 plain versions:")
    for label, shape in CORR_SHAPES.items():
        f1, f2, g = (torch.randn(*s, generator=gen).cuda()
                     for s in (shape, shape, (*shape[:3], 441)))

        def grads(fn, dtype):
            leaves = [t.to(dtype).requires_grad_(True) for t in (f1, f2)]
            return torch.autograd.grad(fn(*leaves, CORR_D, CORR_STRIDE),
                                       leaves, g.to(dtype))

        k = grads(CorrelationFn.apply, torch.float32)
        p = grads(correlation_fwd_plain, torch.float64)
        check(f"CorrelationFn df1 {label}", max_abs(k[0], p[0]), 1e-5,
              "max_abs")
        check(f"CorrelationFn df2 {label}", max_abs(k[1], p[1]), 1e-5,
              "max_abs")
    _check_corr_grad_bf16(gen)
    x = torch.randn(*NORM_SHAPES[0], generator=gen).cuda()
    x[0, :4] = 0.0
    g = torch.randn(*NORM_SHAPES[0][:3], 1, generator=gen).cuda()
    leaf = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(ChannelNormFn.apply(leaf), leaf, g)
    x64 = x.double()
    norm = x64.norm(dim=-1, keepdim=True)
    expect = torch.where(norm > 0, x64 * g.double() / norm.clamp_min(1e-12),
                         torch.zeros_like(x64))
    check("ChannelNormFn dx vs fp64", max_abs(gx, expect), 1e-6, "max_abs")
    if not torch.equal(gx[0, :4], torch.zeros_like(gx[0, :4])):
        raise AssertionError("ChannelNormFn: gradient at zero norm is not 0")


def _check_corr_grad_bf16(gen) -> None:
    """CorrelationFn's gradients in bf16 at the bench shape (the tensor-core
    K5 forward, the tensor-core K6 and K7 backward) against autograd of the
    fp64 plain forward on the same bf16 values: one bf16 ulp, as
    _check_corr_tc."""
    shape = CORR_SHAPES["bench"]
    f1, f2, g = (torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
                 for s in (shape, shape, (*shape[:3], 441)))

    def grads(fn, dtype):
        leaves = [t.to(dtype).requires_grad_(True) for t in (f1, f2)]
        return torch.autograd.grad(fn(*leaves, CORR_D, CORR_STRIDE), leaves,
                                   g.to(dtype))

    common.reset_launches()
    k = grads(CorrelationFn.apply, torch.bfloat16)
    if (common.launches["correlation_bwd_f1_tc"] != 1
            or common.launches["correlation_bwd_f2_tc"] != 1):
        raise AssertionError(f"bf16 CorrelationFn did not run the "
                             f"tensor-core K6 and K7: {common.launches}")
    p = grads(correlation_fwd_plain, torch.float64)
    for which, a, r in (("df1", k[0], p[0]), ("df2", k[1], p[1])):
        ulps, share = common.bf16_ulps(a, r)
        check(f"CorrelationFn bf16 {which} bench vs fp64: ulps", ulps,
              CORR_BF16_ULPS, "max")
        check(f"CorrelationFn bf16 {which} bench: share 1 ulp off", share,
              CORR_BF16_SHARE, "share")


def _check_gradients(gen) -> None:
    print("  gradients of the autograd Functions (fp32) vs autograd of the "
          "plain versions:")
    t = _inputs(torch.float32, gen)

    def grads(fn, args, leaves, dtype=torch.float32):
        leaves = [a.detach().to(dtype).requires_grad_(True) for a in leaves]
        outs = fn(*leaves, *args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        total = sum((o * torch.linspace(-1, 1, o.numel(), device="cuda",
                                        dtype=dtype).reshape(o.shape)).sum()
                    for o in outs)
        return torch.autograd.grad(total, leaves)

    # The conv reference runs in fp64: dW sums 32,768 rows, and cuDNN's
    # fp32 order of summation alone drifts by about 1e-5 relative.
    conv_args = (t["x"], t["w2d"])
    k = grads(Conv3x3Fn.apply, (), conv_args)
    p = grads(conv3x3_fwd_plain, (), conv_args, torch.float64)
    p32 = grads(conv3x3_fwd_plain, (), conv_args)
    check("Conv3x3Fn dx vs fp64", max_abs(k[0], p[0]), 1e-4, "max_abs")
    check("Conv3x3Fn dw vs fp64", rel_l2(k[1], p[1]), 1e-5, "rel_l2")
    print(f"  (cuDNN fp32 vs fp64: dx max_abs {max_abs(p32[0], p[0]):.3e}, "
          f"dw rel_l2 {rel_l2(p32[1], p[1]):.3e})")
    gate_args = (t["gates"], t["h"], t["gs"], t["gb"])
    k = grads(fused_gru_gates, (4,), gate_args)
    p = grads(_gates_plain, (4,), gate_args)
    check("fused_gru_gates grads", max(max_abs(a, b) for a, b in zip(k, p)),
          1e-5, "max_abs")
    blend_args = (t["cand"], t["z"], t["h"], t["cs"], t["cb"])
    k = grads(fused_gru_blend, (2,), blend_args)
    p = grads(_blend_plain, (2,), blend_args)
    check("fused_gru_blend grads", max(max_abs(a, b) for a, b in zip(k, p)),
          1e-5, "max_abs")


def phase_slice(bank: torch.Tensor) -> dict:
    cfg = FlagshipConfig()
    print(f"[4] slice: 10 fused training steps, B={cfg.batch_size}, "
          f"{cfg.compute_dtype}, {cfg.train_in_seq}->{cfg.train_out_seq} "
          f"frames, dopri5 {cfg.ode_solver}, seed 0")
    state = create_train_state(cfg, torch.device("cuda"))
    step = make_fused_train_step(cfg, bank)
    gen = torch.Generator(device="cuda").manual_seed(1)
    step_ms, nfes = [], []
    torch.cuda.synchronize()
    common.reset_launches()
    for i in range(10):
        t0 = time.perf_counter()
        m = step(state, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        nfes.append(m["nfe"])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"  step {i}: loss {loss:.6f} mse {float(m['mse']):.6f} "
              f"nfe {m['nfe']} accepted {m['ode_accepted']} rejected "
              f"{m['ode_rejected']} converged {m['ode_converged']} "
              f"grad_norm {gnorm:.6f} step_ms {step_ms[-1]:.2f}")
        if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {i}: loss or grad_norm not finite")
    counts = dict(common.launches)
    print(f"  launches over the 10 steps: {counts}")
    missing = [k for k in FLAGSHIP_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    for name in ("conv3x3_fwd", "conv3x3_wgrad"):
        if counts[f"{name}_tc"] != counts[name]:
            raise AssertionError(
                f"{counts[name] - counts[f'{name}_tc']} of {counts[name]} "
                f"{name} launches missed the tensor cores")
    _check_gru_sample(counts)
    print(f"  median step_ms over steps 1-9: "
          f"{statistics.median(step_ms[1:]):.2f}; mean nfe "
          f"{statistics.mean(nfes):.1f}")
    return counts


def _check_gru_sample(counts: dict) -> None:
    """Every K3 and K4 launch took its one-sample kernel."""
    for name in ("gru_gates", "gru_blend"):
        if counts[f"{name}_sample"] != counts[name]:
            raise AssertionError(
                f"{counts[name] - counts[f'{name}_sample']} of {counts[name]} "
                f"{name} launches missed the one-sample kernel")


def phase_reference(bank: torch.Tensor) -> None:
    cfg = dataclasses.replace(FlagshipConfig(), batch_size=8,
                              compute_dtype="float32")
    print("[5] fp32 step at B=8: kernels vs plain versions, same weights "
          "and batch")
    state = create_train_state(cfg, torch.device("cuda"))
    video = generate_moving_mnist(
        torch.Generator(device="cuda").manual_seed(2), bank, cfg.batch_size,
        cfg.train_in_seq + cfg.train_out_seq, cfg.num_digits)
    batch = make_batch_dict(video, cfg.train_in_seq)
    model = state.model

    def run():
        metrics, pred = loss_and_grads(model, batch)
        return metrics, pred, {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    common.reset_launches()
    m_k, pred_k, g_k = run()
    counts = dict(common.launches)
    if (counts["conv3x3_wgrad"] == 0 or counts["conv3x3_fwd"] == 0
            or counts["conv3x3_wgrad_simt"] != counts["conv3x3_wgrad"]
            or counts["conv3x3_fwd_simt"] != counts["conv3x3_fwd"]):
        raise AssertionError(f"the fp32 step did not run K1 and K2 on "
                             f"their SIMT kernels: {counts}")
    _check_gru_sample(counts)
    with common.force_plain():
        m_p, pred_p, g_p = run()
    shape = (cfg.batch_size, cfg.train_out_seq, 64, 64, 1)
    if tuple(pred_k.shape) != shape or not torch.isfinite(pred_k).all():
        raise AssertionError(f"prediction {tuple(pred_k.shape)} is not a "
                             f"finite {shape}")
    for stat in ("nfe", "ode_accepted", "ode_rejected"):
        print(f"  {stat}: kernels {m_k[stat]} plain {m_p[stat]}")
        if m_k[stat] != m_p[stat]:
            raise AssertionError(f"{stat} differs")
    check("loss (relative)", abs(float(m_k["loss"]) / float(m_p["loss"])
                                 - 1.0), 1e-5, "rel")
    check("prediction", max_abs(pred_k, pred_p), 1e-4, "max_abs")
    worst = max(g_k, key=lambda n: rel_l2(g_k[n], g_p[n]))
    check(f"worst grad leaf ({worst})", rel_l2(g_k[worst], g_p[worst]), 1e-3,
          "rel_l2")


def _run_flow_steps(label: str, model, cfg, bank, n_steps: int,
                    expected: tuple) -> tuple:
    """n fused training steps from seed 1 with the launch counts reset
    just before; returns (counts, median step_ms over steps 1..n-1)."""
    init_fn, step_fn = make_fused_flow_train_step(
        model, bank, batch=cfg.batch, lr=cfg.lr, loss_norm=cfg.loss_norm,
        single_scale=cfg.single_scale)
    state = init_fn()
    gen = torch.Generator(device="cuda").manual_seed(1)
    step_ms = []
    torch.cuda.synchronize()
    common.reset_launches()
    for i in range(n_steps):
        t0 = time.perf_counter()
        m = step_fn(state, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"  step {i}: loss {float(m['loss']):.6f} epe "
              f"{float(m['epe']):.6f} grad_norm {float(m['grad_norm']):.6f} "
              f"step_ms {step_ms[-1]:.2f}")
        if not all(torch.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label} step {i}: a metric is not finite")
    counts = dict(common.launches)
    print(f"  launches over the {n_steps} steps: {counts}")
    missing = [k for k in expected if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} path: "
                             f"{missing}")
    median = statistics.median(step_ms[1:])
    print(f"  median step_ms over steps 1-{n_steps - 1}: {median:.2f}")
    return counts, median


def phase_flownetc(bank: torch.Tensor) -> dict:
    cfg = FlowNetCBenchConfig()
    print(f"[6] FlowNetC: 10 fused training steps, B={cfg.batch}, "
          f"{cfg.dtype}, 64x64, d={cfg.max_displacement}, "
          f"stride {cfg.corr_stride}, seed {cfg.seed}")
    model = FlowNetC(cfg.max_displacement, cfg.corr_stride,
                     dtype=getattr(torch, cfg.dtype),
                     generator=torch.Generator().manual_seed(cfg.seed))
    counts, _ = _run_flow_steps("FlowNetC", model.cuda(), cfg, bank, 10,
                                FLOWNETC_KERNELS)
    for name in CORR_TC:
        if counts[f"{name}_tc"] != counts[name]:
            raise AssertionError(
                f"{counts[name] - counts[f'{name}_tc']} of {counts[name]} "
                f"{name} launches missed the tensor cores")
    return counts


def phase_flownet2(bank: torch.Tensor) -> dict:
    cfg = FlowNet2Config()
    model = FlowNet2(cfg.rgb_max, dtype=getattr(torch, cfg.dtype),
                     generator=torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[7] FlowNet2: 3 single-scale {cfg.loss_norm} steps, "
          f"B={cfg.batch}, {cfg.dtype}, {n_params:,} parameters")
    counts, _ = _run_flow_steps("FlowNet2", model.cuda(), cfg, bank, 3,
                                (*FLOWNETC_KERNELS, "channelnorm"))
    if any(counts[f"{name}_tc"] for name in CORR_TC):
        raise AssertionError(f"fp32 FlowNet2 launched a tensor-core K5-K7: "
                             f"{counts}")
    return counts


def phase_flow_reference(bank: torch.Tensor) -> None:
    print("[8] FlowNetC fp32 step at B=8: kernels vs plain versions, same "
          "weights and batch")
    model = FlowNetC(generator=torch.Generator().manual_seed(0)).cuda()
    img1, img2, flow = synthetic_flow_batch(
        torch.Generator(device="cuda").manual_seed(2), bank, batch=8)

    def run():
        metrics = flow_loss_and_grads(model, (img1, img2), flow)
        return metrics, {n: p.grad.clone()
                         for n, p in model.named_parameters()}

    m_k, g_k = run()
    with common.force_plain():
        m_p, g_p = run()
    for key in ("loss", "epe"):
        check(f"{key} (relative)", abs(float(m_k[key]) / float(m_p[key])
                                       - 1.0), 1e-5, "rel")
    worst = max(g_k, key=lambda n: rel_l2(g_k[n], g_p[n]))
    check(f"worst grad leaf ({worst})", rel_l2(g_k[worst], g_p[worst]), 1e-3,
          "rel_l2")


# The recipe (configs.yaml): ODEConv, fp32, B=4, dopri5 'scan' with remat,
# frozen batches; its field state is (4, 16, 16, 64).
RECIPE = ("defaults", "train_mmnist_odecgru_len20_1ch")
RECIPE_TEST = ("defaults", "test_mmnist_odecgru_len20_1ch")
RECIPE_B, RECIPE_STEPS = 4, 20


def _write_frozen_corpus(root: pathlib.Path, bank: torch.Tensor,
                         test_frames: int = 100) -> None:
    """uint8 shard_0000.npy under train/ and test/ (16 videos of 100
    frames and 8 of ``test_frames``, 3 digits) from the port's generator,
    and meta.json."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for split, n, n_frames in (("train", 16, 100), ("test", 8, test_frames)):
        video = generate_moving_mnist(gen, bank, batch=n, n_frames=n_frames,
                                      num_digits=3)
        frames = torch.round((video[..., 0] + 0.5) * 255.0).to(torch.uint8)
        (root / split).mkdir(parents=True)
        np.save(root / split / "shard_0000.npy", frames.cpu().numpy())
    (root / "meta.json").write_text(json.dumps(
        {"videos": 24, "frames": 100, "test_frames": test_frames,
         "digits": 3, "train_videos": 16}))


class _TimedTrainStep:
    """Stands in for the loop's ``make_train_step`` (or another step
    factory, ``make_gan_train_step``): the same step, with each step's
    host time (closed by a synchronize) and NFE recorded."""

    def __init__(self, factory=make_train_step):
        self.factory = factory
        self.ms, self.nfe = [], []

    def __call__(self, *args, **kwargs):
        step = self.factory(*args, **kwargs)

        def timed(state, batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if "nfe" in metrics:
                self.nfe.append(int(metrics["nfe"]))
            return metrics

        return timed


def _check_recipe_routes(counts: dict, where: str) -> None:
    """K1-K4 launched; every K1 and K2 launch a SIMT one (fp32), every K3
    and K4 launch a one-sample one."""
    missing = [k for k in FLAGSHIP_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the {where}: "
                             f"{missing}")
    for name in ("conv3x3_fwd", "conv3x3_wgrad"):
        if counts[f"{name}_simt"] != counts[name]:
            raise AssertionError(
                f"{counts[name] - counts[f'{name}_simt']} of {counts[name]} "
                f"{name} launches in the fp32 {where} missed the SIMT "
                f"kernel: {counts}")
    _check_gru_sample(counts)


def _recipe_train(root: pathlib.Path, logs: pathlib.Path) -> dict:
    argv = ["--configs", *RECIPE, "--data_dir", str(root), "--logdir",
            str(logs), "--steps_per_epoch", str(RECIPE_STEPS), "--epochs",
            "1", "--loss_log_freq", "5", "--ckpt_save_freq", "10"]
    print(f"  python -m ode_rl_torch.main {' '.join(argv)}")
    timer = _TimedTrainStep()
    train_loop.make_train_step = timer
    torch.cuda.synchronize()
    common.reset_launches()
    try:
        out = port_main.main(argv)
    finally:
        train_loop.make_train_step = make_train_step
    torch.cuda.synchronize()
    counts = dict(common.launches)
    print(f"  launches over the {RECIPE_STEPS} steps: {counts}")
    _check_recipe_routes(counts, "recipe's training run")
    if out["final_step"] != RECIPE_STEPS or len(timer.ms) != RECIPE_STEPS:
        raise AssertionError(f"the run took {out['final_step']} steps, "
                             f"{len(timer.ms)} timed")
    run = logs / "ODEConv" / "ODEConv_mmnist_train_10_10"
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    if [m["step"] for m in logged] != [1, 5, 10, 15, 20]:
        raise AssertionError(f"logged steps {[m['step'] for m in logged]}")
    for m in logged:
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {m['step']}: loss or grad_norm not "
                                 "finite")
    steps = CheckpointManager(run / "checkpoints",
                              tag="train_mmnist_odecgru_len20_1ch").all_steps()
    if steps != [10, 20]:
        raise AssertionError(f"checkpoints at steps {steps}, not [10, 20]")
    median = statistics.median(timer.ms[1:])
    print(f"  step_ms: {[round(t, 2) for t in timer.ms]}")
    print(f"  nfe: {timer.nfe}")
    print(f"  median step_ms over steps 2-{RECIPE_STEPS}: {median:.2f}; "
          f"mean nfe {statistics.mean(timer.nfe):.2f}")
    return {"counts": counts, "step_ms": median,
            "mean_nfe": statistics.mean(timer.nfe), "run": run}


def _check_plot(run: pathlib.Path, per_horizon: dict) -> None:
    """The test phase's metric-vs-horizon plot: its JSON the curves of
    per_horizon.json, its PNG a 440 x 330 panel a metric (MSE, PSNR,
    SSIM), as JAX's figure."""
    plotted = json.loads((run / "metrics_vs_horizon.json").read_text())
    if plotted != per_horizon:
        raise AssertionError("metrics_vs_horizon.json is not "
                             "per_horizon.json's curves")
    png = (run / "metrics_vs_horizon.png").read_bytes()
    size = tuple(int.from_bytes(png[i:i + 4], "big") for i in (16, 20))
    if png[12:16] != b"IHDR" or size != (1320, 330):
        raise AssertionError(f"metrics_vs_horizon.png is {size}, not the "
                             "1320 x 330 of three panels")
    print(f"  metrics_vs_horizon.png {size[0]}x{size[1]} and its .json "
          "(equal to per_horizon.json) written")


def _recipe_test(root: pathlib.Path, logs: pathlib.Path) -> None:
    argv = ["--configs", *RECIPE_TEST, "--data_dir", str(root), "--logdir",
            str(logs), "--eval_batches", "2"]
    print(f"  python -m ode_rl_torch.main {' '.join(argv)}")
    out = port_main.main(argv)
    per_horizon = json.loads((logs / "ODEConv" / "ODEConv_mmnist_test_10_90"
                              / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        v = per_horizon[k]
        if len(v) != 90 or not np.all(np.isfinite(v)):
            raise AssertionError(f"per_horizon {k}: {len(v)} values, "
                                 "not 90 finite ones")
    _check_plot(logs / "ODEConv" / "ODEConv_mmnist_test_10_90",
                per_horizon)
    print("  per-horizon at frames 1, 10, 45, 90: " + "; ".join(
        f"{k} " + " ".join(f"{per_horizon[k][i]:.4f}" for i in (0, 9, 44, 89))
        for k in ("mse", "psnr", "ssim")))
    print(f"  final: mse {out['final_mse']:.6f} psnr {out['final_psnr']:.4f} "
          f"ssim {out['final_ssim']:.4f}")


def _tracer_warmup() -> None:
    """One small kernel and a sync at the start of a profiler window,
    before the step it traces: a trace of phase 9's step that began at
    once with the window lacked the step's first five K1 launches."""
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def _launch_us(prof) -> dict:
    """Launches and device µs a launch of each K1-K4 kernel in a trace
    (a kernel's template instances together)."""
    launches, us = {}, {}
    for e in prof.key_averages():
        found = _KERNEL_NAME.search(e.key)
        if e.device_type.name == "CUDA" and found and _KERNEL_IDS[
                found.group(1)] in ("K1", "K2", "K3", "K4"):
            name = found.group(1)
            launches[name] = launches.get(name, 0) + e.count
            us[name] = us.get(name, 0.0) + e.self_device_time_total
    return {name: (n, us[name] / n) for name, n in launches.items()}


def _recipe_reference(root: pathlib.Path, run: pathlib.Path) -> dict:
    """One recipe step on a frozen batch with the step-20 weights, through
    the kernels (profiled) and on the plain versions."""
    cfg = load_config(RECIPE, overrides={"data_dir": str(root)})
    state = create_train_state(cfg, torch.device("cuda"))
    snapshot = {"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}
    restored = CheckpointManager(
        run / "checkpoints", tag=cfg.ckpt_id).restore(snapshot, step=20)
    model = state.model
    model.load_state_dict(restored["state"]["model"])
    video = next(FrozenMovingMNIST(root, cfg.batch_size, cfg.train_in_seq,
                                   cfg.train_out_seq, seed=5,
                                   device=torch.device("cuda")))
    batch = make_batch_dict(video, cfg.train_in_seq)

    def run_step():
        metrics, pred = loss_and_grads(model, batch)
        return metrics, pred, {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    torch.cuda.synchronize()
    common.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        m_k, pred_k, g_k = run_step()
        torch.cuda.synchronize()
    counts = dict(common.launches)
    _check_recipe_routes(counts, "recipe's reference step")
    with common.force_plain():
        m_p, pred_p, g_p = run_step()
    shape = (cfg.batch_size, cfg.train_out_seq, 64, 64, 1)
    if tuple(pred_k.shape) != shape or not torch.isfinite(pred_k).all():
        raise AssertionError(f"prediction {tuple(pred_k.shape)} is not a "
                             f"finite {shape}")
    for stat in ("nfe", "ode_accepted", "ode_rejected"):
        print(f"  {stat}: kernels {m_k[stat]} plain {m_p[stat]}")
        if m_k[stat] != m_p[stat]:
            raise AssertionError(f"{stat} differs")
    check("loss (relative)", abs(float(m_k["loss"]) / float(m_p["loss"])
                                 - 1.0), 1e-5, "rel")
    check("prediction", max_abs(pred_k, pred_p), 1e-4, "max_abs")
    worst = max(g_k, key=lambda n: rel_l2(g_k[n], g_p[n]))
    check(f"worst grad leaf ({worst})", rel_l2(g_k[worst], g_p[worst]), 1e-3,
          "rel_l2")
    per_launch = _launch_us(prof)
    print(f"  launches in this step: {counts}")
    # The trace agrees with the wrappers' counts: every K1 and K2 launch
    # ran the SIMT kernels (the sum only where a call has splits).
    for name, kernel in (("conv3x3_fwd", "conv3x3_fwd_simt"),
                         ("conv3x3_wgrad", "conv3x3_wgrad_simt")):
        traced = per_launch.get(kernel, (0, 0.0))[0]
        if traced != counts[name]:
            raise AssertionError(f"the trace holds {traced} {kernel} "
                                 f"launches, the wrappers {counts[name]}")
    for name, (n, us) in sorted(per_launch.items()):
        print(f"  {_KERNEL_IDS[name]} {name}: {n} launches, {us:.2f} device "
              "us a launch")
    return {"counts": counts, "per_launch": per_launch}


def _recipe_fp32_convs() -> dict:
    """K1's SIMT kernel (forward and as dx) and K2's at the recipe's fp32
    shape against fp64, bit-equal over 20 calls, and timed in one run with
    their plain versions and cuDNN's fp32 conv and weight gradient (TF32
    off), each with its bound at this shape."""
    gen = torch.Generator().manual_seed(4)
    b, hw, c = RECIPE_B, HW, C
    x = torch.randn(b, hw, hw, c, generator=gen).cuda()
    g = torch.randn(b, hw, hw, c, generator=gen).cuda()
    w = (torch.randn(9 * c, c, generator=gen) / 24.0).cuda()
    w_t = flip_transpose(w, c, c)
    w_oihw = oihw(w, c, c)
    calls = {"K1 SIMT fp32": lambda: _conv3x3_fwd_simt(x, w),
             "K1 SIMT fp32 as dx": lambda: _conv3x3_fwd_simt(g, w_t),
             "K2 SIMT fp32": lambda: _conv3x3_wgrad_simt(x, g)}
    refs = {"K1 SIMT fp32": conv3x3_fwd_plain(x.double(), w.double()),
            "K1 SIMT fp32 as dx": conv3x3_fwd_plain(g.double(),
                                                    w_t.double()),
            "K2 SIMT fp32": conv3x3_wgrad_plain(x.double(), g.double())}
    errs = {}
    for label, fn in calls.items():
        first = fn()
        if label.startswith("K2"):
            errs[label] = check(f"{label} vs fp64 (recipe shape)",
                                rel_l2(first, refs[label]), 1e-5, "rel_l2")
        else:
            errs[label] = check(f"{label} vs fp64 (recipe shape)",
                                max_abs(first, refs[label]), 1e-4, "max_abs")
        for _ in range(20):
            if not torch.equal(first, fn()):
                raise AssertionError(f"{label}: two calls differ")
        print(f"  {label}: bit-equal over 20 calls")
    px = b * hw * hw
    flops = 2 * px * 9 * c * c
    rows = {
        "conv3x3_fwd": (_time_turns({
            "simt": calls["K1 SIMT fp32"],
            "simt_dx": calls["K1 SIMT fp32 as dx"],
            "plain": lambda: conv3x3_fwd_plain(x, w),
            "library": lambda: conv_library(x, w_oihw)}),
            _bound(flops, (2 * px * c + 9 * c * c) * 4, PEAK_FP32),
            max(errs["K1 SIMT fp32"], errs["K1 SIMT fp32 as dx"])),
        "conv3x3_wgrad": (_time_turns({
            "simt": calls["K2 SIMT fp32"],
            "plain": lambda: conv3x3_wgrad_plain(x, g),
            "library": lambda: wgrad_library(x, g, w_oihw)}),
            _bound(flops, (2 * px * c + 9 * c * c) * 4, PEAK_FP32),
            errs["K2 SIMT fp32"]),
    }
    out = {}
    for name, (times, bound, err) in rows.items():
        out[name] = {"shape": [b, hw, hw, c], "fp64_err": err, **bound}
        for label, (ms, us) in times.items():
            out[name][f"{label}_ms"] = ms
            out[name][f"{label}_device_us"] = us
        dx = (f" (as dx {out[name]['simt_dx_device_us']:.2f})"
              if "simt_dx_ms" in out[name] else "")
        print(f"  {name} fp32 at ({b}, {hw}, {hw}, {c}), one run: CUDA-event "
              f"median ms SIMT {out[name]['simt_ms']:.4f} plain "
              f"{out[name]['plain_ms']:.4f} cuDNN "
              f"{out[name]['library_ms']:.4f}; device us a call SIMT "
              f"{out[name]['simt_device_us']:.2f}{dx} cuDNN "
              f"{out[name]['library_device_us']:.2f}; bound "
              f"{bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})")
    return out


def phase_recipe(bank: torch.Tensor) -> dict:
    print(f"[9] recipe: python -m ode_rl_torch.main --configs {' '.join(RECIPE)}"
          f" (fp32, B={RECIPE_B}, 64 channels, dopri5 scan, remat), "
          f"{RECIPE_STEPS} steps on a frozen corpus, then the test block")
    with tempfile.TemporaryDirectory() as tmp:
        root, logs = pathlib.Path(tmp) / "frozen", pathlib.Path(tmp) / "logs"
        _write_frozen_corpus(root, bank)
        train = _recipe_train(root, logs)
        _recipe_test(root, logs)
        ref = _recipe_reference(root, train["run"])
    convs = _recipe_fp32_convs()
    return {**train, "reference": ref, "fp32_convs": convs}


# The Moving MNIST recurrent family (configs.yaml), each block at its own
# widths and frames (fp32, B=4): ConvGRU (10 -> 10), cgrudecODE (50 -> 50,
# the decode field 64 -> 64 in 2 layers), the ODE-ConvGRU memory modes
# nru and nru2 (10 -> 10, 3 layers) and the sampled z0 with its KL term
# and nan_guard (50 -> 50, 2 layers).
RECURRENT = ("train_mmnist_cgru_len20", "train_mmnist_cgrudecODE",
             "train_mmnist_odecgrumem_len20_1ch",
             "train_mmnist_odecgrumem2_len20_1ch",
             "train_mmnist_sample_odecgru")
# (test block, the train block whose checkpoint it restores, frames out)
RECURRENT_TESTS = (("test_mmnist_cgru_len20", "train_mmnist_cgru_len20",
                    190),
                   ("test_mmnist_odecgrumem_len20_1ch",
                    "train_mmnist_odecgrumem_len20_1ch", 90))
RECURRENT_STEPS, HOIST_STEPS = 10, 5
STATS = ("nfe", "ode_accepted", "ode_rejected", "ode_converged")


def _run_dir(argv: list) -> tuple:
    """(config, run directory) that ``ode_rl_torch.main`` uses for argv."""
    cfg, _ = port_main.get_cfg(argv)
    logdir = pathlib.Path(cfg.get("logdir", "logs"))
    return cfg, logdir / cfg.model / resolve_run_id(cfg)


def _check_recurrent_routes(model: str, counts: dict, where: str) -> None:
    """ConvGRU: K3 and K4 launched (every launch a one-sample one), no K1
    or K2. The ODE blocks: as the recipe (_check_recipe_routes)."""
    if model != "ConvGRU":
        _check_recipe_routes(counts, where)
        return
    if counts["gru_gates"] == 0 or counts["gru_blend"] == 0:
        raise AssertionError(f"K3/K4 never launched in the {where}: {counts}")
    if counts["conv3x3_fwd"] or counts["conv3x3_wgrad"]:
        raise AssertionError(f"K1/K2 launched in the {where}: {counts}")
    _check_gru_sample(counts)


def _recurrent_train(block: str, root: pathlib.Path,
                     logs: pathlib.Path) -> dict:
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs / block), "--steps_per_epoch",
            str(RECURRENT_STEPS), "--epochs", "1", "--loss_log_freq", "1",
            "--ckpt_save_freq", str(RECURRENT_STEPS)]
    cfg, run = _run_dir(argv)
    print(f"  python -m ode_rl_torch.main --configs defaults {block} "
          f"({cfg.model}, {cfg.train_in_seq}->{cfg.train_out_seq} frames, "
          f"{RECURRENT_STEPS} steps)")
    timer = _TimedTrainStep()
    train_loop.make_train_step = timer
    torch.cuda.synchronize()
    common.reset_launches()
    try:
        out = port_main.main(argv)
    finally:
        train_loop.make_train_step = make_train_step
    torch.cuda.synchronize()
    counts = dict(common.launches)
    _check_recurrent_routes(cfg.model, counts, f"{block} run")
    if out["final_step"] != RECURRENT_STEPS:
        raise AssertionError(f"{block}: {out['final_step']} steps")
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    if [m["step"] for m in logged] != list(range(1, RECURRENT_STEPS + 1)):
        raise AssertionError(f"{block}: logged steps "
                             f"{[m['step'] for m in logged]}")
    for m in logged:
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"{block} step {m['step']}: loss or "
                                 "grad_norm not finite")
    steps = CheckpointManager(run / "checkpoints",
                              tag=cfg.ckpt_id).all_steps()
    if steps != [RECURRENT_STEPS]:
        raise AssertionError(f"{block}: checkpoints at {steps}")
    median = statistics.median(timer.ms[1:])
    nfe = statistics.mean(timer.nfe) if timer.nfe else None
    per_step = {k: counts[k] / RECURRENT_STEPS for k in FLAGSHIP_KERNELS}
    print(f"    losses {[round(m['loss'], 5) for m in logged]}")
    print(f"    median step_ms over steps 2-{RECURRENT_STEPS}: {median:.2f}; "
          f"mean nfe {'-' if nfe is None else f'{nfe:.1f}'}; K1-K4 "
          f"launches a step {per_step}")
    return {"counts": counts, "step_ms": median, "mean_nfe": nfe,
            "logs": logs / block}


def _recurrent_test(block: str, logs: pathlib.Path, root: pathlib.Path,
                    n_out: int) -> None:
    """The test block from its train run's checkpoint (under ``logs``),
    over 2 batches: n_out finite MSE, PSNR and SSIM values."""
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs), "--eval_batches", "2"]
    cfg, _ = port_main.get_cfg(argv)
    ckpt = CheckpointManager(find_checkpoint(logs, cfg.model, cfg.ckpt_id),
                             tag=cfg.ckpt_id)
    merged = train_loop._resurrect_train_config(cfg, ckpt.load_config())
    print(f"  python -m ode_rl_torch.main --configs defaults {block} "
          f"({cfg.test_in_seq}->{cfg.test_out_seq} frames): the block says "
          f"n_ode_layers {cfg.get('n_ode_layers')}, the train run's saved "
          f"config builds {merged.get('n_ode_layers')}")
    t0 = time.perf_counter()
    out = port_main.main(argv)
    seconds = time.perf_counter() - t0
    per_horizon = json.loads((logs / merged.model / resolve_run_id(merged)
                              / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        v = per_horizon[k]
        if len(v) != n_out or not np.all(np.isfinite(v)):
            raise AssertionError(f"{block} per_horizon {k}: {len(v)} "
                                 f"values, not {n_out} finite ones")
    print(f"    {seconds:.2f} s; mse at frames 1, 10, {n_out}: "
          + " ".join(f"{per_horizon['mse'][i]:.4f}"
                     for i in (0, 9, n_out - 1))
          + f"; final psnr {out['final_psnr']:.4f} ssim "
          f"{out['final_ssim']:.4f}")


def _device_ms(prof) -> float:
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3


def _min_std(model, batch) -> float:
    """The smallest std of the ODE-ConvGRU z0 head on ``batch``."""
    with torch.no_grad():
        x = batch["observed_data"] + 0.5
        b, t = x.shape[:2]
        enc = model.conv_encoder(x.reshape(b * t, *x.shape[2:]))
        _, std = model.z0_encoder(enc.reshape(b, t, *enc.shape[1:]),
                                  batch["observed_tp"])
    return float(std.min())


def _kernels_vs_plain(model, batch) -> dict:
    """One loss and its gradients through the kernels (profiled, the
    launch counts read around it, and timed on the host's clock) and on
    the plain versions, each drawing the z0 noise from a generator seeded
    alike."""
    def run_step():
        gen = torch.Generator(device="cuda").manual_seed(7)
        metrics, pred = loss_and_grads(model, batch, gen)
        return metrics, pred, {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    torch.cuda.synchronize()
    common.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        t0 = time.perf_counter()
        m_k, pred_k, g_k = run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(common.launches)
    with common.force_plain():
        m_p, pred_p, g_p = run_step()
    errs = {n: rel_l2(g_k[n], g_p[n]) for n in g_k}
    worst = max(errs, key=errs.get)
    return {"counts": counts, "device_ms": _device_ms(prof),
            "wall_ms": wall_ms, "m_k": m_k,
            "m_p": m_p, "pred_k": pred_k, "pred_p": pred_p, "errs": errs,
            "worst": worst, "worst_err": errs[worst]}


# The leaves upstream of the z0 head's std, which the sampled z0's KL
# term reaches through its gradient -1/(std + 1e-6).
KL_REACHES = ("conv_encoder.", "z0_encoder.")


def _check_step(label: str, r: dict) -> None:
    """Equal solver stats, loss to 1e-5 relative and prediction to 1e-4
    max abs between the kernels' and the plain versions' step."""
    m_k, m_p = r["m_k"], r["m_p"]
    stats = [k for k in STATS if k in m_k]
    print(f"  {label}: " + ", ".join(
        f"{k} kernels {m_k[k]} plain {m_p[k]}" for k in stats))
    for k in stats:
        if m_k[k] != m_p[k]:
            raise AssertionError(f"{label}: {k} differs")
    check(f"{label[:20]} loss (relative)",
          abs(float(m_k["loss"]) / float(m_p["loss"]) - 1.0), 1e-5, "rel")
    check(f"{label[:20]} prediction", max_abs(r["pred_k"], r["pred_p"]),
          1e-4, "max_abs")


def _recurrent_reference(block: str, root: pathlib.Path) -> dict:
    """One step of ``block`` from its training run's initial weights (the
    seed's) on a frozen batch, through the kernels (profiled: the step's
    device time and host time) against the same step on the plain
    versions, with the same z0 noise. The initial weights: after 10 steps
    at the defaults' lr 8e-4 the nru block has fallen into the blank
    attractor ``configs.yaml`` describes for the memory modes (predictions
    of 1e-22), where a comparison would hold nothing.

    The sampled z0's step is held twice. With its KL term: solver stats,
    loss and prediction, and every gradient leaf the KL term does not
    reach. The KL term's gradient in std is -1/(std + 1e-6), so where a
    std lies near zero (stds of 7e-6 to 5e-5 seen) it multiplies the fp32
    rounding of std, which kernels and plain versions reach by other
    orders of summation, by up to 1e6; the leaves it reaches (the conv
    encoder's and the z0 encoder's) are printed, not held. Then with
    ``z_kl_weight`` 0, the noise, the kernels and every other term as
    they are: every leaf. The KL term itself is plain PyTorch, held
    against JAX on the CPU (tests/test_torch_port_recurrent.py)."""
    cfg = load_config(["defaults", block], overrides={"data_dir": str(root)})
    model = create_train_state(cfg, torch.device("cuda")).model
    video = next(FrozenMovingMNIST(root, cfg.batch_size, cfg.train_in_seq,
                                   cfg.train_out_seq, seed=5,
                                   device=torch.device("cuda")))
    batch = make_batch_dict(video, cfg.train_in_seq)
    if getattr(model, "z_sample", False):
        r = _kernels_vs_plain(model, batch)
        errs = r["errs"]
        print(f"  {block} with its KL term (z_kl_weight "
              f"{model.z_kl_weight}, smallest std "
              f"{_min_std(model, batch):.3e})")
        _check_step("KL " + block, r)
        held = [n for n in errs if not n.startswith(KL_REACHES)]
        reached = [n for n in errs if n.startswith(KL_REACHES)]
        worst = max(held, key=errs.get)
        check(f"KL worst grad ({worst[:17]})", errs[worst], 1e-3, "rel_l2")
        worst = max(reached, key=errs.get)
        print(f"    the leaves the KL term reaches: worst ({worst}) rel_l2 "
              f"{errs[worst]:.3e}, printed, not held; held below with "
              "z_kl_weight 0")
        model.z_kl_weight = 0.0
    r = _kernels_vs_plain(model, batch)
    counts, m_k = r["counts"], r["m_k"]
    _check_recurrent_routes(cfg.model, counts, f"{block} reference step")
    shape = (cfg.batch_size, cfg.train_out_seq, 64, 64, 1)
    if (tuple(r["pred_k"].shape) != shape
            or not torch.isfinite(r["pred_k"]).all()):
        raise AssertionError(f"{block}: prediction "
                             f"{tuple(r['pred_k'].shape)} is not a finite "
                             f"{shape}")
    _check_step(block, r)
    check(f"{block[:20]} worst grad ({r['worst'][:14]})", r["worst_err"],
          1e-3, "rel_l2")
    print(f"    the step (forward and backward), profiled: device ms "
          f"{r['device_ms']:.3f} of {r['wall_ms']:.2f} ms (busy "
          f"{100 * r['device_ms'] / r['wall_ms']:.1f}%); launches "
          f"{({k: counts[k] for k in FLAGSHIP_KERNELS})}")
    return {"counts": counts, "device_ms": r["device_ms"],
            "wall_ms": r["wall_ms"], "nfe": m_k.get("nfe")}


def _defaults_run(root: pathlib.Path, logs: pathlib.Path) -> dict:
    """``--configs defaults`` alone: ConvGRU at convgru_out_ch 256, 50 ->
    50 frames, two steps; K3 at (4, 16, 16, 512) in 16 groups and K4 at
    (4, 16, 16, 256) in 8, routed by sample_plan and held to their plain
    versions at those shapes."""
    argv = ["--configs", "defaults", "--data_dir", str(root), "--logdir",
            str(logs / "defaults"), "--steps_per_epoch", "2", "--epochs",
            "1", "--loss_log_freq", "1"]
    cfg, _ = port_main.get_cfg(argv)
    print(f"  python -m ode_rl_torch.main --configs defaults ({cfg.model}, "
          f"convgru_out_ch {cfg.convgru_out_ch}, {cfg.train_in_seq}->"
          f"{cfg.train_out_seq} frames, 2 steps)")
    torch.cuda.synchronize()
    common.reset_launches()
    out = port_main.main(argv)
    torch.cuda.synchronize()
    counts = dict(common.launches)
    _check_recurrent_routes(cfg.model, counts, "defaults run")
    if out["final_step"] != 2 or not np.isfinite(out["loss"]):
        raise AssertionError(f"defaults: {out}")
    c = cfg.convgru_out_ch
    gen = torch.Generator().manual_seed(8)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    h = torch.tanh(rnd(RECIPE_B, HW, HW, c))
    gs, gb = 1.0 + 0.1 * rnd(2 * c), 0.1 * rnd(2 * c)
    cs, cb = 1.0 + 0.1 * rnd(c), 0.1 * rnd(c)
    gates, cand = rnd(RECIPE_B, HW, HW, 2 * c), rnd(RECIPE_B, HW, HW, c)
    z = torch.sigmoid(rnd(RECIPE_B, HW, HW, c))
    groups_g, groups_c = max(2 * c // 32, 1), max(c // 32, 1)
    for name, cin, groups, plan, kernel, plain in (
            ("K3", 2 * c, groups_g, sample_plan(RECIPE_B, HW * HW, c,
                                                groups_g, torch.float32, 16),
             lambda: fused_gru_gates(gates, h, gs, gb, groups_g),
             lambda: _gates_plain(gates, h, gs, gb, groups_g)),
            ("K4", c, groups_c, sample_plan(RECIPE_B, HW * HW, c, groups_c,
                                            torch.float32, 16, blend=True),
             lambda: fused_gru_blend(cand, z, h, cs, cb, groups_c),
             lambda: _blend_plain(cand, z, h, cs, cb, groups_c))):
        print(f"    {name} at ({RECIPE_B}, {HW}, {HW}, {cin}) fp32, {groups} "
              f"groups: sample_plan {plan}")
        err = max(max_abs(a, b) for a, b in zip(_as_tuple(kernel()),
                                                 _as_tuple(plain())))
        check(f"{name} at the defaults' width", err, 1e-5, "max_abs")
    print(f"    losses: step 2 {out['loss']:.6f}; launches "
          f"{({k: counts[k] for k in FLAGSHIP_KERNELS})}")
    return {"counts": counts}


def _hoist_times(root: pathlib.Path) -> dict:
    """The recipe with the z0 encoder's hoisted projections off and on:
    HOIST_STEPS steps each way on the same frozen batches from the same
    init, in the turns off, on, on, off; step_ms the least median of the
    two turns over steps 2-5, device ms of one more profiled step. Every
    turn's losses agree with the first turn's to 1e-5 relative."""
    cfg = load_config(RECIPE, overrides={"data_dir": str(root)})
    loader = FrozenMovingMNIST(root, cfg.batch_size, cfg.train_in_seq,
                               cfg.train_out_seq, seed=6,
                               device=torch.device("cuda"))
    batches = [make_batch_dict(next(loader), cfg.train_in_seq)
               for _ in range(HOIST_STEPS)]
    step = make_train_step()
    runs, first = {}, None
    for hoist in (False, True, True, False):
        state = create_train_state(cfg, torch.device("cuda"))
        state.model.z0_encoder.hoist_projections = hoist
        ms, nfe, losses = [], [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            nfe.append(m["nfe"])
            losses.append(float(m["loss"]))
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"hoist {hoist}: losses {losses}")
        first = first or losses
        err = max(abs(a / b - 1.0) for a, b in zip(losses, first))
        check(f"hoist {hoist} losses (relative)", err, 1e-5, "rel")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _tracer_warmup()
            step(state, batches[0])
            torch.cuda.synchronize()
        run = runs.setdefault(hoist, {"step_ms": [], "device_ms": []})
        run["step_ms"].append(statistics.median(ms[1:]))
        run["device_ms"].append(_device_ms(prof))
        run.update(nfe=nfe, losses=losses)
    out = {}
    for hoist, run in runs.items():
        out["on" if hoist else "off"] = {
            "step_ms": min(run["step_ms"]),
            "device_ms": min(run["device_ms"]), "nfe": run["nfe"],
            "losses": run["losses"]}
        print(f"  hoist_projections {hoist}: step_ms {run['step_ms']} "
              f"device ms {[round(v, 3) for v in run['device_ms']]} nfe "
              f"{run['nfe']} losses {[round(v, 6) for v in run['losses']]}")
    return out


def phase_recurrent(bank: torch.Tensor) -> dict:
    print(f"[10] recurrent family: {', '.join(RECURRENT)} through "
          f"ode_rl_torch.main (fp32, B={RECIPE_B}), {RECURRENT_STEPS} steps "
          "each on a frozen corpus (200-frame test videos), the test blocks, "
          "a reference step each, --configs defaults, the hoist off and on")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, logs = pathlib.Path(tmp) / "frozen", pathlib.Path(tmp) / "logs"
        _write_frozen_corpus(root, bank, test_frames=200)
        trains = {block: _recurrent_train(block, root, logs)
                  for block in RECURRENT}
        for block, train_block, n_out in RECURRENT_TESTS:
            _recurrent_test(block, trains[train_block]["logs"], root, n_out)
        refs = {block: _recurrent_reference(block, root)
                for block in RECURRENT}
        defaults = _defaults_run(root, logs)
        hoist = _hoist_times(root)
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s")
    return {"train": trains, "reference": refs, "defaults": defaults,
            "hoist": hoist}


S3VAE_TRAIN = (
    "train_mmnist_recon_s3vae", "train_mmnist_extrap_s3vae",
    "train_mmnist_recon_cs3vae", "train_mmnist_extrap_cs3vae",
    "train_mmnist_s3vae_odecgru", "train_mmnist_s3vaeode",
    "train_mmnist_recon_s4vae", "train_mmnist_extrap_s4vae",
    "train_mmnist_recon_cs4vae", "train_mmnist_extrap_cs4vae",
    "train_mmnist_recon_rims4vae", "train_mmnist_recon_cgrurims3vae",
    "train_mmnist_recon_rimconvs4vae")
# (test block, the train block whose checkpoint it loads).
S3VAE_TESTS = (("test_mmnist_recon_s3vae", "train_mmnist_recon_s3vae"),
               ("test_mmnist_recon_cs3vae", "train_mmnist_recon_cs3vae"),
               ("test_mmnist_recon_cs4vae", "train_mmnist_recon_cs4vae"),
               ("test_mmnist_recon_rims4vae", "train_mmnist_recon_rims4vae"))
S3VAE_REFERENCE = ("train_mmnist_recon_cs3vae", "train_mmnist_s3vae_odecgru",
                   "train_mmnist_recon_cs4vae")
S3VAE_STEPS = 4
S3VAE_METRICS = ("loss", "vae_loss", "recon_loss", "kl_zf", "kl_zt",
                 "scc_loss", "dfp_loss", "mi_loss")
# A gradient leaf of S3VAE's reference step: its error within 1e-3 of its
# norm plus 1e-5 of the whole gradient's norm. The biases of the convs
# before a training-mode BatchNorm have no gradient in exact arithmetic;
# each side's is rounding (tests/test_torch_port_s3vae.py).
S3VAE_GRAD_RTOL, S3VAE_GRAD_ATOL = 1e-3, 1e-5


class _NfeRecorder:
    """Stands in for ``odeint_aux`` in nn/s3vae_nets.py ('odecgru'
    rollouts): the same solve, each call's NFE recorded."""

    def __init__(self):
        self.nfe = []

    def __enter__(self):
        self.real = s3vae_nets.odeint_aux

        def solve(*args, **kwargs):
            ys, stats = self.real(*args, **kwargs)
            self.nfe.append(int(stats.nfe))
            return ys, stats

        s3vae_nets.odeint_aux = solve
        return self

    def __exit__(self, *exc):
        s3vae_nets.odeint_aux = self.real


def _check_tf32_off(where: str) -> None:
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError(f"TF32 left on after {where}")


def _check_s3vae_routes(encoder: str, counts: dict, where: str) -> None:
    """'default': no K1-K4 launch. 'cgru', 'cgru_sa', 'cgru_rim': K3/K4
    (one-sample) and no K1/K2. 'odecgru': K1-K4, as the recipe."""
    if encoder == "odecgru":
        _check_recipe_routes(counts, where)
        return
    gru = counts["gru_gates"] + counts["gru_blend"]
    conv = counts["conv3x3_fwd"] + counts["conv3x3_wgrad"]
    if encoder == "default":
        if gru or conv:
            raise AssertionError(f"K1-K4 launched in the {where}: {counts}")
        return
    if counts["gru_gates"] == 0 or counts["gru_blend"] == 0 or conv:
        raise AssertionError(f"the {where} did not run K3/K4 alone: "
                             f"{counts}")
    _check_gru_sample(counts)


def _s3vae_train(block: str, root: pathlib.Path, logs: pathlib.Path) -> dict:
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs / block), "--steps_per_epoch",
            str(S3VAE_STEPS), "--epochs", "1", "--loss_log_freq", "1",
            "--ckpt_save_freq", str(S3VAE_STEPS)]
    cfg, run = _run_dir(argv)
    timer = _TimedTrainStep()
    train_loop.make_train_step = timer
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.synchronize()
    common.reset_launches()
    try:
        with _NfeRecorder() as nfe:
            out = port_main.main(argv)
    finally:
        train_loop.make_train_step = make_train_step
    torch.cuda.synchronize()
    _check_tf32_off(f"main on {block}")
    counts = dict(common.launches)
    _check_s3vae_routes(cfg.encoder, counts, f"{block} run")
    if out["final_step"] != S3VAE_STEPS:
        raise AssertionError(f"{block}: {out['final_step']} steps")
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    if [m["step"] for m in logged] != list(range(1, S3VAE_STEPS + 1)):
        raise AssertionError(f"{block}: logged steps "
                             f"{[m['step'] for m in logged]}")
    for m in logged:
        bad = [k for k in (*S3VAE_METRICS, "grad_norm")
               if not np.isfinite(m.get(k, np.nan))]
        if bad:
            raise AssertionError(f"{block} step {m['step']}: {bad} missing "
                                 "or not finite")
    ckpt = CheckpointManager(run / "checkpoints", tag=cfg.ckpt_id)
    if ckpt.all_steps() != [S3VAE_STEPS]:
        raise AssertionError(f"{block}: checkpoints at {ckpt.all_steps()}")
    # BatchNorm starts at mean 0 and var 1.
    saved = ckpt.restore({"model": {}})["state"]["model"]
    bn = {k: v for k, v in saved.items() if k.endswith((".mean", ".var"))}
    still = [k for k, v in bn.items()
             if torch.all(v == (0.0 if k.endswith(".mean") else 1.0))]
    if not bn or still:
        raise AssertionError(f"{block}: BatchNorm buffers that did not move "
                             f"({len(still)} of {len(bn)}): {still[:4]}")
    median = statistics.median(timer.ms[1:])
    per_step = {k: counts[k] / S3VAE_STEPS for k in FLAGSHIP_KERNELS}
    mean_nfe = statistics.mean(nfe.nfe) if nfe.nfe else None
    print(f"  {block} ({cfg.encoder}, {cfg.train_in_seq}->"
          f"{cfg.train_out_seq}): losses "
          f"{[round(m['loss'], 3) for m in logged]}; median step_ms over "
          f"steps 2-{S3VAE_STEPS} {median:.2f}; nfe "
          f"{nfe.nfe or '-'}; {len(bn)} BatchNorm buffers moved; K1-K4 "
          f"a step {per_step}")
    return {"counts": counts, "step_ms": median, "mean_nfe": mean_nfe,
            "logs": logs / block, "encoder": cfg.encoder}


def _s3vae_test(block: str, logs: pathlib.Path, root: pathlib.Path) -> None:
    """One eval batch of the test block from its train run's checkpoint:
    t_in + n_out finite values of every per-horizon metric."""
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs), "--eval_batches", "1"]
    cfg, _ = port_main.get_cfg(argv)
    n = cfg.test_in_seq + cfg.test_out_seq
    t0 = time.perf_counter()
    out = port_main.main(argv)
    seconds = time.perf_counter() - t0
    _check_tf32_off(f"main on {block}")
    run = logs / cfg.model / resolve_run_id(cfg)
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        v = per_horizon[k]
        if len(v) != n or not np.all(np.isfinite(v)):
            raise AssertionError(f"{block} per_horizon {k}: {len(v)} "
                                 f"values, not {n} finite ones")
    print(f"  {block} ({cfg.test_in_seq}->{cfg.test_out_seq}, {n} frames "
          f"predicted): {seconds:.2f} s; mse at frames 1, 20, 21, {n}: "
          + " ".join(f"{per_horizon['mse'][i]:.4f}"
                     for i in (0, 19, 20, n - 1))
          + f"; final ssim {out['final_ssim']:.4f}")


def _s3vae_reference(block: str, root: pathlib.Path) -> dict:
    """S3VAE predicts the observed frames in training."""
    return _bn_reference(block, root, lambda cfg, counts, where:
                         _check_s3vae_routes(cfg.encoder, counts, where),
                         "observed_data")


def _bn_reference(block: str, root: pathlib.Path, check_routes,
                  predicts: str) -> dict:
    """One step of ``block`` (a model with BatchNorm) at B=4 in fp32 from
    its seed's weights on a frozen batch, through the kernels (profiled,
    its launches held by ``check_routes(cfg, counts, where)``) and under
    ``force_plain()``: the same weights, BatchNorm buffers, batch and
    noise (a generator seeded alike). The prediction finite and of the
    shape of ``batch[predicts]``, loss to 1e-5 relative, prediction 1e-4
    max abs, every gradient leaf within 1e-3 of its norm plus 1e-5 of the
    whole norm, every BatchNorm buffer after the step 1e-5 relative L2,
    equal NFE (the model's metric, or each 'odecgru' rollout's)."""
    cfg = load_config(["defaults", block], overrides={"data_dir": str(root)})
    model = create_train_state(cfg, torch.device("cuda")).model
    video = next(FrozenMovingMNIST(root, cfg.batch_size, cfg.train_in_seq,
                                   cfg.train_out_seq, seed=5,
                                   device=torch.device("cuda")))
    batch = make_batch_dict(video, cfg.train_in_seq, with_flow_labels=True)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def run_step():
        model.load_state_dict(start)
        model.train()
        gen = torch.Generator(device="cuda").manual_seed(7)
        with _NfeRecorder() as rec:
            metrics, pred = loss_and_grads(model, batch, gen)
        nfe = int(metrics["nfe"]) if "nfe" in metrics else rec.nfe
        return (metrics, pred,
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: b.clone() for n, b in model.named_buffers()}, nfe)

    torch.cuda.synchronize()
    common.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        t0 = time.perf_counter()
        m_k, pred_k, g_k, b_k, nfe_k = run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(common.launches)
    check_routes(cfg, counts, f"{block} reference step")
    with common.force_plain():
        m_p, pred_p, g_p, b_p, nfe_p = run_step()
    shape = tuple(batch[predicts].shape)
    if tuple(pred_k.shape) != shape or not torch.isfinite(pred_k).all():
        raise AssertionError(f"{block}: prediction {tuple(pred_k.shape)} "
                             f"is not a finite {shape}")
    print(f"  {block} ({cfg.get('encoder', cfg.model)}): nfe kernels "
          f"{nfe_k} plain {nfe_p}")
    if nfe_k != nfe_p:
        raise AssertionError(f"{block}: NFE differs")
    label = block[12:30]
    check(f"{label} loss (relative)",
          abs(float(m_k["loss"]) / float(m_p["loss"]) - 1.0), 1e-5, "rel")
    check(f"{label} prediction", max_abs(pred_k, pred_p), 1e-4, "max_abs")
    total = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                 for g in g_p.values())))
    ratio = {n: float((g_k[n] - g_p[n]).double().norm())
             / (S3VAE_GRAD_RTOL * float(g_p[n].double().norm())
                + S3VAE_GRAD_ATOL * total) for n in g_k}
    worst = max(ratio, key=ratio.get)
    print(f"    worst gradient leaf {worst}: rel_l2 "
          f"{rel_l2(g_k[worst], g_p[worst]):.3e}, {ratio[worst]:.3f} of its "
          f"bound (1e-3 of its norm + 1e-5 of the whole norm {total:.4g})")
    check(f"{label} worst grad / bound", ratio[worst], 1.0, "ratio")
    worst_b = max(b_k, key=lambda n: rel_l2(b_k[n], b_p[n]))
    check(f"{label} BatchNorm buffers",
          rel_l2(b_k[worst_b], b_p[worst_b]), 1e-5, "rel_l2")
    device = _device_ms(prof)
    print(f"    the step (forward and backward), profiled: device ms "
          f"{device:.3f} of {wall_ms:.2f} ms (busy "
          f"{100 * device / wall_ms:.1f}%); launches "
          f"{({k: counts[k] for k in FLAGSHIP_KERNELS})}")
    return {"counts": counts, "device_ms": device, "wall_ms": wall_ms,
            "nfe": nfe_k}


def _s3vae_shapes() -> dict:
    """K1-K4 alone at the shapes S3VAE gives them (_shapes_alone)."""
    # K1/K2: the 'odecgru' field at 4x4. K3/K4 (B, H=W, the gates' 2C):
    # the static heads of 'cgru'/'odecgru' (3B rows, d_zf 64) and of
    # 'cgru_sa' (d_zf 256), the 'odecgru' z0 cell.
    return _shapes_alone(((4, 4, 32, 64), (4, 4, 128, 64)),
                         ((12, 4, 128), (12, 8, 512), (4, 4, 256)))


def _shapes_alone(convs, grus) -> dict:
    """K1/K2 at each (B, H=W, Cin, Cout) of ``convs`` and K3/K4 at each
    (B, H=W, the gates' 2C) of ``grus``, fp32, alone: each against its
    plain version (K1 1e-4 max abs, K2 1e-5 relative L2, K3 and K4 1e-5
    max abs), its route and plan printed, and its device µs beside its
    plain version's and its bound, its CUDA-event median ms and its host
    µs a call."""
    gen = torch.Generator().manual_seed(9)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for b, hw, cin, cout in convs:
        x, g = rnd(b, hw, hw, cin), rnd(b, hw, hw, cout)
        w = rnd(9 * cin, cout) / (3.0 * cin ** 0.5)
        label = f"({b}, {hw}, {hw}, {cin}->{cout})"
        print(f"  K1/K2 at {label} fp32: simt_plan "
              f"{simt_plan(b, hw, hw, cin, cout, sms)}, wgrad_simt_plan "
              f"{wgrad_simt_plan(b, hw, hw, cin, cout, sms)}")
        common.reset_launches()
        y, dw = conv3x3_fwd(x, w), conv3x3_wgrad(x, g)
        counts = dict(common.launches)
        if (counts["conv3x3_fwd_simt"] != 1
                or counts["conv3x3_wgrad_simt"] != 1):
            raise AssertionError(f"K1/K2 at {label} missed SIMT: {counts}")
        k1 = check(f"K1 at {label}", max_abs(y, conv3x3_fwd_plain(x, w)),
                   1e-4, "max_abs")
        k2 = check(f"K2 at {label}", rel_l2(dw, conv3x3_wgrad_plain(x, g)),
                   1e-5, "rel_l2")
        us = device_us({"K1": lambda: conv3x3_fwd(x, w),
                        "K1 plain": lambda: conv3x3_fwd_plain(x, w),
                        "K2": lambda: conv3x3_wgrad(x, g),
                        "K2 plain": lambda: conv3x3_wgrad_plain(x, g)})
        px = b * hw * hw
        flops = 2 * px * 9 * cin * cout
        for name, err, fn in (("K1", k1, lambda: conv3x3_fwd(x, w)),
                              ("K2", k2, lambda: conv3x3_wgrad(x, g))):
            out[f"{name} {label}"] = {
                "route": "simt", "err": err, "dev_us": us[name],
                "plain_dev_us": us[f"{name} plain"], "ms": median_ms(fn),
                "host_us": host_us(fn),
                **_bound(flops, (px * (cin + cout) + 9 * cin * cout) * 4,
                         PEAK_FP32)}
    for b, hw, c2 in grus:
        c = c2 // 2
        gg, gc = max(2 * c // 32, 1), max(c // 32, 1)
        h = torch.tanh(rnd(b, hw, hw, c))
        gs, gb = 1.0 + 0.1 * rnd(2 * c), 0.1 * rnd(2 * c)
        cs, cb = 1.0 + 0.1 * rnd(c), 0.1 * rnd(c)
        gates, cand = rnd(b, hw, hw, 2 * c), rnd(b, hw, hw, c)
        z = torch.sigmoid(rnd(b, hw, hw, c))
        px = b * hw * hw
        for name, plan, kernel, plain, flops, nbytes in (
                ("K3", sample_plan(b, hw * hw, c, gg, torch.float32, 16),
                 lambda: fused_gru_gates(gates, h, gs, gb, gg),
                 lambda: _gates_plain(gates, h, gs, gb, gg),
                 10 * px * 2 * c, (px * 5 * c + 4 * c) * 4),
                ("K4", sample_plan(b, hw * hw, c, gc, torch.float32, 16,
                                   blend=True),
                 lambda: fused_gru_blend(cand, z, h, cs, cb, gc),
                 lambda: _blend_plain(cand, z, h, cs, cb, gc),
                 10 * px * c, (px * 4 * c + 2 * c) * 4)):
            cin = 2 * c if name == "K3" else c
            label = f"({b}, {hw}, {hw}, {cin})"
            print(f"  {name} at {label} fp32: sample_plan {plan}")
            common.reset_launches()
            err = max(max_abs(p, q) for p, q in zip(_as_tuple(kernel()),
                                                     _as_tuple(plain())))
            counts = dict(common.launches)
            kind = "gru_gates" if name == "K3" else "gru_blend"
            route = "sample" if counts[f"{kind}_sample"] else "2pass"
            if (plan is None) == (route == "sample"):
                raise AssertionError(f"{name} at {label}: route {route}, "
                                     f"plan {plan}")
            check(f"{name} at {label}", err, 1e-5, "max_abs")
            us = device_us({"kernel": kernel, "plain": plain})
            out[f"{name} {label}"] = {
                "route": route, "err": err, "dev_us": us["kernel"],
                "plain_dev_us": us["plain"], "ms": median_ms(kernel),
                "host_us": host_us(kernel),
                **_bound(flops, nbytes, PEAK_FP32)}
    for label, row in out.items():
        print(f"    {label}: {row['route']}, dev µs {row['dev_us']:.2f} "
              f"(plain {row['plain_dev_us']:.2f}), ms {row['ms']:.4f}, host "
              f"µs {row['host_us']:.2f}, bound {row['bound_ms'] * 1e3:.3f} "
              f"µs by {row['bound_by']}")
    return out


def phase_s3vae(bank: torch.Tensor) -> dict:
    print(f"[11] S3VAE family: the {len(S3VAE_TRAIN)} train blocks through "
          f"ode_rl_torch.main (fp32, B={RECIPE_B}), {S3VAE_STEPS} steps "
          "each on a frozen corpus, the test blocks (20 -> 180), reference "
          "steps against the plain versions, the kernels at S3VAE's shapes")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, logs = pathlib.Path(tmp) / "frozen", pathlib.Path(tmp) / "logs"
        _write_frozen_corpus(root, bank, test_frames=200)
        trains = {block: _s3vae_train(block, root, logs)
                  for block in S3VAE_TRAIN}
        for block, train_block in S3VAE_TESTS:
            _s3vae_test(block, trains[train_block]["logs"], root)
        refs = {block: _s3vae_reference(block, root)
                for block in S3VAE_REFERENCE}
    shapes = _s3vae_shapes()
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    return {"train": trains, "reference": refs, "shapes": shapes}


# The Vid-ODE family (configs.yaml): the four Moving MNIST blocks and the
# six corpus blocks at their own widths (fp32, B=4, base_ch 32, n_downs 2:
# the latent (4, 16, 16, 128), and (4, 32, 32, 128) at mgif's and penn's
# 128x128), each corpus written by the port's commands.
VIDODE_CORPORA = ("kth", "mgif", "penn", "hurricane", "phyre", "minerl")
VIDODE_TRAIN = ("train_mmnist_vidode_len20", "train_mmnist_vidode_irregular",
                "train_mmnist_vidode_gan", "train_mmnist_vidode_slots",
                *(f"train_{d}_vidode" for d in VIDODE_CORPORA))
VIDODE_REFERENCE = ("train_mmnist_vidode_len20", "train_mmnist_vidode_slots")
VIDODE_STEPS = 5
VIDODE_METRICS = ("loss", "recon_l1", "diff_l1", "nfe")
# Each corpus: B=4 train videos and one test batch, at the commands'
# seed. phyre's rollouts are 40 frames, its block's test window.
VIDODE_CORPUS_FLAGS = ("--train_videos", "4", "--test_videos", "4",
                       "--seed", "0")
VIDODE_PHYRE_FLAGS = ("--synthetic", "--frames", "40")
# The files of each corpus as the JAX repo's scripts wrote them on the CPU
# host the port is tested on, with the same flags
# (``scripts/make_synthetic_corpus.py --dataset <d>``,
# ``scripts/generate_phyre_dataset.py``): the file's sha256, and the sum
# of the array's bytes and of each byte times its flat index (int64),
# which name the byte where a single one differs.
VIDODE_CORPUS_BYTES = {
    "kth/train/video_00000.npy": (
        "90c56e9719ec9ff59135e1c75f5b5dc445b17ea69f5b6d7b3198b877141155f1",
        20979352, 16634069014082),
    "kth/train/video_00001.npy": (
        "0591920e31934df5e868f1ef46232e8581e9d4d22365c1b6aec85803e9ab623f",
        16609806, 12252990313378),
    "kth/train/video_00002.npy": (
        "efacfb010e09156c6680885cc951c50d9107ed26aad446c2b03863006cfa4f19",
        13169545, 9063920381017),
    "kth/train/video_00003.npy": (
        "8224bc6ef7a8a1f1ba5fb78d695623282799a78c90b9852aa6a14e46028b9d75",
        4506415, 2472360308883),
    "kth/test/video_00000.npy": (
        "565e866993f69de3421b2ad2c1552f577a9aa30ffbee59e45d3935a989f85ab3",
        11579678, 5600908395493),
    "kth/test/video_00001.npy": (
        "7617734f9a4a434cc6982a283f0bc46c82168fe1d1a31b0d3cfc761305176f4e",
        18963235, 16177876188761),
    "kth/test/video_00002.npy": (
        "25be870f5ae0b46185e34f19fede75e76d78571b5c1e4635faa1f269e3b1f8d4",
        8065040, 3054203526338),
    "kth/test/video_00003.npy": (
        "8befce7c634e6a0147d924a62402daaf5e5af8fde7f8085fbded6b4f8a722625",
        19772911, 22775671997297),
    "mgif/train/video_00000.npy": (
        "22703752f83560ee6f4725964808c613dd49862057c88d1ae5c2f5d663490d13",
        44261205, 59258382471097),
    "mgif/train/video_00001.npy": (
        "9e245acda1d3791ac047410587fc3bd977a68b2332f34d1634a02626e57f28ea",
        9629319, 6717098191838),
    "mgif/train/video_00002.npy": (
        "a7f1c79cbba4041c5ab33f9cf257aeeaafd7acc81bf251554c85cedf62596e9b",
        17108388, 19327631536611),
    "mgif/train/video_00003.npy": (
        "7e0641b24c470500ede0f0653283e09c9a25d877eac58b3fff85b1bb8db5e98d",
        10026612, 3215404341325),
    "mgif/test/video_00000.npy": (
        "814ee2a82ca4347b20d15934db6f4b8f540c0ad1323d0774facd45d76bf96278",
        25558357, 20251520873788),
    "mgif/test/video_00001.npy": (
        "7971c6576ab3fd8ddd84422ccbb42f772c10f38d677ec74a44a82e391c4fda60",
        18643963, 13457749919741),
    "mgif/test/video_00002.npy": (
        "aec5535bf7e4a3fe553e4ba1d58e4396887f57fee9dc227f29424ea81cf42f7b",
        25715698, 23621862793482),
    "mgif/test/video_00003.npy": (
        "d727289ea149286eb6e749e1f773e2e806e56d8747f0ed782ca170d8b3d0461b",
        16754755, 11087995074698),
    "penn/train/video_00000.npy": (
        "22bf55beebc9bf8357b108511421a045e01de8d1345b4fff2de7b6808a274827",
        59001562, 164143102769353),
    "penn/train/video_00001.npy": (
        "ab35d735f3958017ca99b8452481bd0350965ca25f2320ce693043691dd2cd98",
        16066568, 28625908043861),
    "penn/train/video_00002.npy": (
        "115b5d6acce73677dd95fefa4a16a400f4705f60b4cbc8e01831b2df32df1436",
        23967031, 58826141701131),
    "penn/train/video_00003.npy": (
        "5fca26e32f0747e8debd11ee0e7e0086a481d9e2a593edf63186e353b7f0b4cc",
        23727130, 27949521075273),
    "penn/test/video_00000.npy": (
        "9e5866d092553bd3042c24a8805eab6abf16220db83bb6bc7e2c268153dfd10d",
        40046564, 77155659041085),
    "penn/test/video_00001.npy": (
        "8d8b33c519bb50faaa3d71bf9402f429c4cbf037175a1ee5cd7c218fbacbbc4c",
        29912806, 54339074965324),
    "penn/test/video_00002.npy": (
        "e90c00ef29f80b77a03e512084d22cec5b76e59ab465965bfc9a14094212b3fc",
        38324857, 81561565043842),
    "penn/test/video_00003.npy": (
        "4f71c87ad599e51ab53f908f12065f1eda3f0f97cdfef0c8cb45816fe20edba9",
        27923662, 48221354162369),
    "hurricane/train/video_00000.npy": (
        "0f346ebf6d34eb7dc3ab23103d0c4cad2ea2344dc06645c0538111b22aa633f5",
        63675382, 32616794495232),
    "hurricane/train/video_00001.npy": (
        "b8ec58692e31b6932aea1f2b3e6c75d6df510902df461f95dd97f8eb3418f895",
        67568222, 48332477822294),
    "hurricane/train/video_00002.npy": (
        "9f919ac1b365fff8c491894f5bf9dc55482bdce8a88cc021f2a4b0f8107cfb95",
        30536971, 12887194685057),
    "hurricane/train/video_00003.npy": (
        "df2547465c155ae062b25e19554daa0ac8787e5ce2ead68b3f280f7db3c842dd",
        98425690, 57237231112449),
    "hurricane/test/video_00000.npy": (
        "f0f7ff15044b67c6752e4d660bd2cfe1b7ecbaa2f892a941f7b17c223c1a40ba",
        145285379, 104505531226847),
    "hurricane/test/video_00001.npy": (
        "426cd0f233651d02ce2895908e1d34aeb82637302fd574d935e27766c3f1a4cf",
        41229136, 23075707935766),
    "hurricane/test/video_00002.npy": (
        "e40b091c799fd831c199b8b753b89730306ac21ab4f983031f1f54dc455f3a9e",
        82049836, 56215763797932),
    "hurricane/test/video_00003.npy": (
        "0755f3d34b0454e21c8975a5ad8101de076bb37d23f76c6ba47cdbc5c3ca3b4d",
        88324158, 61957132418230),
    "phyre/train/rollout_00000.npy": (
        "69dfdaf3ba84bc97ae67885f8e5552ccf21c47efd986ea7999ab043b7f6e367b",
        123055000, 30235368306035),
    "phyre/train/rollout_00001.npy": (
        "94b6c0a67dc778f04650f5ad582203c4308c52869cd2150a8ad446c48faf5db6",
        120433630, 29578901463770),
    "phyre/train/rollout_00002.npy": (
        "59551f85d7b088e187287fa1fa440101b224512405d7bc46f2b843a42aa156e5",
        124328610, 30552270502605),
    "phyre/train/rollout_00003.npy": (
        "9976b2e79ee1afe3a35108a715228d550172a79d7e0a842509805465cfd73ee5",
        123602550, 30371562800790),
    "phyre/test/rollout_00000.npy": (
        "cbad0ae238db3b98c7ebf541859208bddb59b084613bd07f8f3e51bc5b6eba2c",
        124322045, 30550675172515),
    "phyre/test/rollout_00001.npy": (
        "37c475b0365cea2d37abc1e4b0ad93b2661d214b86d2ee32174f7297b06e6d97",
        122967295, 30218036815460),
    "phyre/test/rollout_00002.npy": (
        "fcde5eb47e57d75fb4687fba9026088c090a519b5b6f4e8220d35d4722631b18",
        123458480, 30338848081930),
    "phyre/test/rollout_00003.npy": (
        "be79c018ef1284cfc5fc0c91313c7970aaaeafa28ccac827ba91a48ece00771f",
        124060135, 30485119494920),
    "minerl/train/video_00000.npy": (
        "5bad42487d5ebc11704faf3083e61640b4e6546417733029015c670583e25920",
        32270462, 19940121254409),
    "minerl/train/video_00001.npy": (
        "f2798e40fb311a307315be15c785368ff27fbb9efcc15b911974c3208330a438",
        14090752, 8648637319613),
    "minerl/train/video_00002.npy": (
        "380229c09341d66824ea4fa0b650189f39740c09642531ea511dac2a605a6741",
        13475694, 8292244180099),
    "minerl/train/video_00003.npy": (
        "3ea6f777a5b0ef0587cb840c6c6d5676c6e13fc3f42de2cfdcfc401d31cbd4a4",
        24911856, 15324557574619),
    "minerl/test/video_00000.npy": (
        "6b250c278214023c99f27d2335cbedb5467ac7c466c3bc41f8b397ac4e80fd15",
        34569938, 21156130753202),
    "minerl/test/video_00001.npy": (
        "9d1b70eefc9ed3f407c7ff1d9f545b80ffb113a8123e8499163cd7bfdd1a62c0",
        68562648, 42211820638665),
    "minerl/test/video_00002.npy": (
        "61e3299e04b90c2e49e832f98c1ef32f8fbb12c67b58b7999dfa44041505b843",
        80656813, 49562966746299),
    "minerl/test/video_00003.npy": (
        "79439f2cc2e60770ee73ad0ee3c226cea0ae1fc2e5b59314c68dfaf2e4a73f26",
        68007553, 41968432831460),
}


def _bn_moved(state: dict, block: str) -> int:
    """The BatchNorm buffers of a saved state dict all moved from their
    start (mean 0, var 1); returns how many there are."""
    bn = {k: v for k, v in state.items() if k.endswith((".mean", ".var"))}
    still = [k for k, v in bn.items()
             if torch.all(v == (0.0 if k.endswith(".mean") else 1.0))]
    if not bn or still:
        raise AssertionError(f"{block}: BatchNorm buffers that did not move "
                             f"({len(still)} of {len(bn)}): {still[:4]}")
    return len(bn)


def _vidode_train(block: str, data: pathlib.Path,
                  logs: pathlib.Path) -> dict:
    """``block`` through ``ode_rl_torch.main`` for VIDODE_STEPS steps: every
    logged loss finite (and grad_norm, which the GAN loop does not log:
    there D's and G's losses), no step skipped where ``nan_guard`` is on,
    a checkpoint whose BatchNorm buffers moved, K1-K4 launched (K1/K2 on
    SIMT, K3/K4 one-sample)."""
    argv = ["--configs", "defaults", block, "--data_dir", str(data),
            "--logdir", str(logs / block), "--steps_per_epoch",
            str(VIDODE_STEPS), "--epochs", "1", "--loss_log_freq", "1",
            "--ckpt_save_freq", str(VIDODE_STEPS)]
    cfg, run = _run_dir(argv)
    gan = cfg.get("gan", False)
    name = "make_gan_train_step" if gan else "make_train_step"
    real = getattr(train_loop, name)
    timer = _TimedTrainStep(real)
    setattr(train_loop, name, timer)
    torch.cuda.synchronize()
    common.reset_launches()
    try:
        out = port_main.main(argv)
    finally:
        setattr(train_loop, name, real)
    torch.cuda.synchronize()
    _check_tf32_off(f"main on {block}")
    counts = dict(common.launches)
    _check_recipe_routes(counts, f"{block} run")
    if out["final_step"] != VIDODE_STEPS:
        raise AssertionError(f"{block}: {out['final_step']} steps")
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    if [m["step"] for m in logged] != list(range(1, VIDODE_STEPS + 1)):
        raise AssertionError(f"{block}: logged steps "
                             f"{[m['step'] for m in logged]}")
    keys = (*VIDODE_METRICS, *(("d_loss", "g_loss", "g_adv_loss") if gan
                               else ("grad_norm",)))
    guard = bool(cfg.get("nan_guard", False))
    for m in logged:
        bad = [k for k in keys if not np.isfinite(m.get(k, np.nan))]
        if bad:
            raise AssertionError(f"{block} step {m['step']}: {bad} missing "
                                 "or not finite")
        if guard and m.get("nan_skipped") != 0:
            raise AssertionError(f"{block} step {m['step']}: nan_skipped "
                                 f"{m.get('nan_skipped')}")
    ckpt = CheckpointManager(run / "checkpoints", tag=cfg.ckpt_id)
    if ckpt.all_steps() != [VIDODE_STEPS]:
        raise AssertionError(f"{block}: checkpoints at {ckpt.all_steps()}")
    field = "gen_model_state" if gan else "model"
    n_bn = _bn_moved(ckpt.restore({field: {}})["state"][field], block)
    median = statistics.median(timer.ms[1:])
    per_step = {k: counts[k] / VIDODE_STEPS for k in FLAGSHIP_KERNELS}
    ws = int(cfg.get("window_size", 0))
    frames = (f"a {ws}-frame window split {ws // 2}->{ws // 2}"
              if cfg.get("vidode_sampling", False)
              else f"{cfg.train_in_seq}->{cfg.train_out_seq}")
    print(f"  {block} ({cfg.get('dataset')}, {frames}): losses "
          f"{[round(m['loss'], 4) for m in logged]}; step_ms "
          f"{[round(t, 2) for t in timer.ms]}, median over steps "
          f"2-{VIDODE_STEPS} {median:.2f}; nfe {timer.nfe}; {n_bn} "
          f"BatchNorm buffers moved; K1-K4 a step {per_step}")
    return {"counts": counts, "step_ms": median,
            "mean_nfe": statistics.mean(timer.nfe), "logs": logs / block}


def _vidode_test(block: str, data: pathlib.Path, logs: pathlib.Path,
                 frames: int) -> None:
    """The test phase of ``block`` from its train run's checkpoint, one
    batch: ``frames`` finite values of MSE, PSNR, SSIM and
    ``lpips_uncalibrated`` a horizon."""
    argv = ["--configs", "defaults", block, "--data_dir", str(data),
            "--logdir", str(logs), "--phase", "test", "--load_model", "True",
            "--eval_batches", "1"]
    t0 = time.perf_counter()
    out = port_main.main(argv)
    seconds = time.perf_counter() - t0
    _check_tf32_off(f"main on {block} (test)")
    cfg, _ = port_main.get_cfg(argv)
    run = logs / cfg.model / resolve_run_id(cfg)
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim", "lpips_uncalibrated"):
        v = per_horizon.get(k, [])
        if len(v) != frames or not np.all(np.isfinite(v)):
            raise AssertionError(f"{block} test per_horizon {k}: {len(v)} "
                                 f"values, not {frames} finite ones")
    print(f"  {block} test ({frames} frames predicted): {seconds:.2f} s; "
          f"final mse {out['final_mse']:.4f} ssim {out['final_ssim']:.4f} "
          f"lpips_uncalibrated {out['final_lpips_uncalibrated']:.4f}")


def _byte_sums(video: np.ndarray) -> tuple:
    """(sum of the bytes, sum of each byte times its flat index)."""
    flat = video.reshape(-1).astype(np.int64)
    return int(flat.sum()), int(np.dot(np.arange(flat.size), flat))


def _check_corpus_bytes(dataset: str, root: pathlib.Path) -> None:
    """The corpus's files are VIDODE_CORPUS_BYTES's; else the first file
    that differs is named, with the byte that differs where one does."""
    want = {name.split("/", 1)[1]: v for name, v in
            VIDODE_CORPUS_BYTES.items() if name.startswith(f"{dataset}/")}
    got = corpus_sha256(root)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{dataset}: files {sorted(got)}, expected "
                             f"{sorted(want)}")
    for name, (digest, s0, s1) in want.items():
        if got[name] == digest:
            continue
        video = np.load(root / name)
        d0, d1 = (a - b for a, b in zip(_byte_sums(video), (s0, s1)))
        where = "the array's bytes sum alike: the file's header differs"
        if d0 and d1 % d0 == 0 and 0 <= d1 // d0 < video.size:
            at = np.unravel_index(d1 // d0, video.shape)
            where = (f"if one byte differs, it is byte {d1 // d0} (frame, "
                     f"row, column, channel {tuple(int(i) for i in at)}): "
                     f"{int(video[at])} here, {int(video[at]) - d0} on the "
                     "CPU host")
        elif d0 or d1:
            where = (f"several bytes differ (byte sum {d0:+d}, index-"
                     f"weighted sum {d1:+d} off)")
        raise AssertionError(f"{dataset}/{name} {video.shape} is the first "
                             f"file that differs: sha256 {got[name]}, "
                             f"expected {digest}; {where}")


def _vidode_corpora(tmp: pathlib.Path) -> dict:
    """Each corpus block's corpus, written by the port's commands as a user
    runs them (``python -m``, the six at once) and held to the bytes of the
    JAX repo's scripts (VIDODE_CORPUS_BYTES)."""
    env = {**os.environ,
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent)}
    roots, procs = {}, {}
    t0 = time.perf_counter()
    for d in VIDODE_CORPORA:
        roots[d] = tmp / d
        command = (("ode_rl_torch.generate_phyre_dataset",
                    *VIDODE_PHYRE_FLAGS) if d == "phyre" else
                   ("ode_rl_torch.make_synthetic_corpus", "--dataset", d))
        argv = ["-m", *command, "--out", str(roots[d]), *VIDODE_CORPUS_FLAGS]
        print(f"  python {' '.join(argv)}")
        procs[d] = subprocess.Popen([sys.executable, *argv], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    try:
        for d, proc in procs.items():
            out, _ = proc.communicate(timeout=300)
            if proc.returncode:
                raise AssertionError(f"the {d} corpus command exited "
                                     f"{proc.returncode}: {out[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    for d, root in roots.items():
        _check_corpus_bytes(d, root)
    print(f"  the six corpora: {seconds:.2f} s, {len(VIDODE_CORPUS_BYTES)} "
          "files, every sha256 equal to the JAX repo's scripts' on the CPU "
          "host")
    return roots


def phase_vidode(bank: torch.Tensor) -> dict:
    print(f"[12] Vid-ODE family: {', '.join(VIDODE_TRAIN)} through "
          f"ode_rl_torch.main (fp32, B={RECIPE_B}), {VIDODE_STEPS} steps "
          "each (frozen Moving MNIST, the irregular block's own windows, the "
          "six corpora written by the port's commands), three test phases, "
          "reference steps against the plain versions, the kernels at "
          "Vid-ODE's shapes")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, logs = pathlib.Path(tmp) / "frozen", pathlib.Path(tmp) / "logs"
        _write_frozen_corpus(root, bank, test_frames=200)
        corpora = _vidode_corpora(pathlib.Path(tmp) / "corpora")
        trains = {block: _vidode_train(
            block, corpora.get(block.split("_")[1], root), logs)
            for block in VIDODE_TRAIN}
        # defaults test 20 -> 180; kth's block 10 -> 30; penn's 10 -> 20
        # at 128x128.
        for block, data, frames in (
                ("train_mmnist_vidode_len20", root, 180),
                ("train_kth_vidode", corpora["kth"], 30),
                ("train_penn_vidode", corpora["penn"], 20)):
            _vidode_test(block, data, trains[block]["logs"], frames)
        refs = {block: _bn_reference(
            block, root, lambda cfg, counts, where: _check_recipe_routes(
                counts, where), "data_to_predict")
            for block in VIDODE_REFERENCE}
    # K1/K2: the field's in, mid and out convs at (4, 16, 16) and at
    # mgif's and penn's (4, 32, 32), the slots' at (16, 16, 16). K3/K4:
    # the z0 cell, B x 256 gates at 16x16 and 32x32, and the slots' (B*S =
    # 16, slot_dim 32).
    shapes = _shapes_alone(((4, 16, 128, 64), (4, 16, 64, 64),
                            (4, 16, 64, 128), (16, 16, 32, 32),
                            (4, 32, 128, 64), (4, 32, 64, 64),
                            (4, 32, 64, 128)),
                           ((4, 16, 256), (16, 16, 64), (4, 32, 256)))
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s")
    return {"train": trains, "reference": refs, "shapes": shapes}


# The last video-prediction families (configs.yaml), each block at its own
# widths (fp32, B=4): ConvLSTM (10 -> 10; stages 16/64/96), with the plateau
# LR and early stopping; S2VAE, CS2VAE and DS2VAE (20 -> 20, 64x64, d_zf
# 256, 3 slots of 128, DS2VAE's RIM of 3 blocks of 100); the Sprites DS-VAE
# (8 frames of 64x64x3, procedural clips made on the card).
FAMILIES13_TRAIN = ("train_mmnist_convlstm", "train_mmnist_convlstm_sched",
                    "train_mmnist_s2vae", "train_mmnist_cs2vae",
                    "train_mmnist_ds2vae", "train_sprite_dsvae")
# (test block, the train block whose checkpoint it loads), 20 -> 20.
FAMILIES13_TESTS = (("test_mmnist_s2vae", "train_mmnist_s2vae"),
                    ("test_mmnist_cs2vae", "train_mmnist_cs2vae"),
                    ("test_mmnist_ds2vae", "train_mmnist_ds2vae"))
FAMILIES13_STEPS = 4
# The plateau block: lr 0, so the weights stay and the validation MSE
# moves only by the card's rounding (cuDNN's transposed convs are not
# deterministic: about 3e-5 relative between epochs on an H100 80GB HBM3
# at 700 W); plateau
# patience 0 and early stopping after 2 epochs without a new best, over up
# to eight epochs of 2 steps.
SCHED_OVERRIDES = ("--lr", "0.0", "--plateau_patience", "0",
                   "--early_stop_patience", "2", "--steps_per_epoch", "2",
                   "--epochs", "8")


def _check_families13_routes(model: str, counts: dict, where: str) -> None:
    """CS2VAE: K3 and K4 (every launch a one-sample one), no K1/K2. The
    others run none of K1-K4."""
    gru = counts["gru_gates"] + counts["gru_blend"]
    conv = counts["conv3x3_fwd"] + counts["conv3x3_wgrad"]
    if model != "CS2VAE":
        if gru or conv:
            raise AssertionError(f"K1-K4 launched in the {where}: {counts}")
        return
    if counts["gru_gates"] == 0 or counts["gru_blend"] == 0 or conv:
        raise AssertionError(f"the {where} did not run K3/K4 alone: "
                             f"{counts}")
    _check_gru_sample(counts)


def _families13_train(block: str, root: pathlib.Path,
                      logs: pathlib.Path) -> dict:
    """``block`` through ``ode_rl_torch.main``: FAMILIES13_STEPS steps (the
    plateau block: SCHED_OVERRIDES), loss and grad_norm finite at every
    step, the checkpoint at the last step (its BatchNorm buffers all
    moved where the model has any), the kernels' routes. The plateau
    block: a ``val_mse`` an epoch, the same at every epoch (lr 0, cuDNN's
    deterministic algorithms), the run stopped early, and the two state
    machines replayed on the logged ``val_mse`` stop at its last epoch
    with the lr scale its checkpoint holds, below 1."""
    sched = block.endswith("_sched")
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs / block), "--loss_log_freq", "1"]
    argv += (list(SCHED_OVERRIDES) if sched else [
        "--steps_per_epoch", str(FAMILIES13_STEPS), "--epochs", "1",
        "--ckpt_save_freq", str(FAMILIES13_STEPS)])
    cfg, run = _run_dir(argv)
    timer = _TimedTrainStep()
    train_loop.make_train_step = timer
    # At lr 0 the validation MSE stalls only if cuDNN repeats it bit for
    # bit: its default transposed-conv algorithm does not, and its noise
    # of about 1e-5 relative can count as improvement for the whole run.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = sched
    torch.cuda.synchronize()
    common.reset_launches()
    try:
        out = port_main.main(argv)
    finally:
        train_loop.make_train_step = make_train_step
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    _check_tf32_off(f"main on {block}")
    counts = dict(common.launches)
    _check_families13_routes(cfg.model, counts, f"{block} run")
    steps = out["final_step"]
    if steps != FAMILIES13_STEPS and not sched:
        raise AssertionError(f"{block}: {steps} steps, not "
                             f"{FAMILIES13_STEPS}")
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    train_logs = [m for m in logged if "loss" in m]
    if [m["step"] for m in train_logs] != list(range(1, steps + 1)):
        raise AssertionError(f"{block}: logged steps "
                             f"{[m['step'] for m in train_logs]}")
    for m in train_logs:
        bad = [k for k in ("loss", "grad_norm")
               if not np.isfinite(m.get(k, np.nan))]
        if bad:
            raise AssertionError(f"{block} step {m['step']}: {bad} missing "
                                 "or not finite")
    ckpt = CheckpointManager(run / "checkpoints", tag=cfg.ckpt_id)
    if ckpt.all_steps() != [steps]:
        raise AssertionError(f"{block}: checkpoints at {ckpt.all_steps()}")
    saved = ckpt.restore({"model": {}, "optimizer": {}})["state"]
    n_bn = (_bn_moved(saved["model"], block) if cfg.model != "ConvLSTM"
            else 0)
    note = ""
    if sched:
        vals = [m["val_mse"] for m in logged if "val_mse" in m]
        plateau = ReduceLROnPlateau(
            float(cfg.get("plateau_factor", 0.5)),
            int(cfg.get("plateau_patience", 4)),
            float(cfg.get("plateau_min_scale", 1e-3)))
        early = EarlyStopping(int(cfg.early_stop_patience))
        stops = []
        for v in vals:
            plateau.step(v)
            stops.append(early.step(v))
        scale = lr_scale(saved["optimizer"])
        if (not np.all(np.isfinite(vals)) or len(set(vals)) != 1
                or steps != 2 * len(vals)
                or steps >= 2 * cfg.epochs or True not in stops
                or stops.index(True) != len(vals) - 1
                or scale != plateau.scale or scale >= 1.0):
            raise AssertionError(
                f"{block}: {steps} steps, val_mse {vals}, stops {stops}, "
                f"lr scale {scale} (replayed {plateau.scale}): val_mse "
                "moved at lr 0, or the loop's plateau and early stopping "
                "disagree with their state machines, or did not fire")
        note = (f"; val_mse {vals}, lr scale {scale}, early stop after "
                f"epoch {len(vals)} of {cfg.epochs}")
    median = statistics.median(timer.ms[1:])
    per_step = {k: counts[k] / steps for k in ("gru_gates", "gru_blend")}
    print(f"  {block} ({cfg.model}, {cfg.train_in_seq}->"
          f"{cfg.train_out_seq}): losses "
          f"{[round(m['loss'], 4) for m in train_logs]}; step_ms "
          f"{[round(t, 2) for t in timer.ms]}, median over steps 2-{steps} "
          f"{median:.2f}; {n_bn} BatchNorm buffers moved; K3/K4 a step "
          f"{per_step}{note}")
    return {"counts": counts, "step_ms": median, "steps": steps,
            "logs": logs / block, "model": cfg.model}


def _families13_test(block: str, logs: pathlib.Path,
                     root: pathlib.Path) -> None:
    """One batch of the test block (20 -> 20) from its train run's
    checkpoint: 20 finite values of each per-horizon metric."""
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs), "--eval_batches", "1", "--test_out_seq",
            "20"]
    cfg, _ = port_main.get_cfg(argv)
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    common.reset_launches()
    out = port_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_tf32_off(f"main on {block}")
    _check_families13_routes(cfg.model, dict(common.launches),
                             f"{block} test")
    run = logs / cfg.model / resolve_run_id(cfg)
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        v = per_horizon[k]
        if len(v) != 20 or not np.all(np.isfinite(v)):
            raise AssertionError(f"{block} per_horizon {k}: {len(v)} "
                                 "values, not 20 finite ones")
    print(f"  {block} ({cfg.test_in_seq}->{cfg.test_out_seq}): "
          f"{seconds:.2f} s; mse at frames 1, 10, 20: "
          + " ".join(f"{per_horizon['mse'][i]:.4f}" for i in (0, 9, 19))
          + f"; final ssim {out['final_ssim']:.4f}")


def _families13_batch(cfg, root: pathlib.Path) -> dict:
    if cfg.dataset == "sprites":
        gen = torch.Generator(device="cuda").manual_seed(5)
        video, _, _ = sprites_batch(Noise(gen), cfg.batch_size,
                                    cfg.train_in_seq + cfg.train_out_seq)
    else:
        video = next(FrozenMovingMNIST(root, cfg.batch_size,
                                       cfg.train_in_seq, cfg.train_out_seq,
                                       seed=5, device=torch.device("cuda")))
    return make_batch_dict(video, cfg.train_in_seq)


def _families13_profile(block: str, root: pathlib.Path) -> dict:
    """One forward and backward of ``block`` from its seed's weights on a
    fixed batch, after one unprofiled: device ms of its wall ms."""
    cfg = load_config(["defaults", block])
    model = create_train_state(cfg, torch.device("cuda")).model.train()
    batch = _families13_batch(cfg, root)
    gen = torch.Generator(device="cuda").manual_seed(7)
    loss_and_grads(model, batch, gen)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        t0 = time.perf_counter()
        loss_and_grads(model, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = _device_ms(prof)
    print(f"  {block}: a profiled forward and backward, device ms "
          f"{device:.3f} of {wall_ms:.2f} (busy "
          f"{100 * device / wall_ms:.1f}%)")
    return {"device_ms": device, "wall_ms": wall_ms}


def _check_debug_nans(root: pathlib.Path) -> None:
    """A ConvLSTM step with ``debug_nans`` on a batch holding one NaN must
    raise ``FloatingPointError``; without the flag it runs."""
    cfg = load_config(["defaults", "train_mmnist_convlstm"])
    state = create_train_state(cfg, torch.device("cuda"))
    batch = _families13_batch(cfg, root)
    batch["observed_data"] = batch["observed_data"].clone()
    batch["observed_data"][0, 3, 30, 30, 0] = float("nan")
    try:
        make_train_step(debug_nans=True)(state, batch)
    except FloatingPointError as e:
        print(f"  debug_nans on a batch with one NaN raised: {e}")
    else:
        raise AssertionError("debug_nans did not raise on a NaN batch")
    metrics = make_train_step()(state, batch)
    if np.isfinite(float(metrics["loss"])):
        raise AssertionError("the NaN batch gave a finite loss")


def phase_families13(bank: torch.Tensor) -> dict:
    print(f"[13] ConvLSTM, S2VAE/CS2VAE/DS2VAE and the Sprites DS-VAE: "
          f"{len(FAMILIES13_TRAIN)} train blocks through ode_rl_torch.main "
          f"(fp32, B={RECIPE_B}), the three test blocks (20 -> 20), a "
          "CS2VAE step against the plain versions, debug_nans, K3/K4 at "
          "CS2VAE's shapes")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, logs = pathlib.Path(tmp) / "frozen", pathlib.Path(tmp) / "logs"
        _write_frozen_corpus(root, bank, test_frames=200)
        trains = {block: _families13_train(block, root, logs)
                  for block in FAMILIES13_TRAIN}
        for block, train_block in FAMILIES13_TESTS:
            _families13_test(block, trains[train_block]["logs"], root)
        ref = _bn_reference(
            "train_mmnist_cs2vae", root, lambda cfg, counts, where:
            _check_families13_routes(cfg.model, counts, where),
            "data_to_predict")
        profiles = {block: _families13_profile(block, root)
                    for block in FAMILIES13_TRAIN if block not in (
                        "train_mmnist_convlstm_sched", "train_mmnist_cs2vae")}
        profiles["train_mmnist_cs2vae"] = ref
        _check_debug_nans(root)
    # K3 at CS2VAE's gates (4, 4, 4, 256) in 8 groups, K4 at its candidate
    # (4, 4, 4, 128) in 4 groups: one call a slot a step.
    shapes = _shapes_alone((), ((4, 4, 256),))
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s")
    return {"train": trains, "reference": ref, "profiles": profiles,
            "shapes": shapes}


# The world models (configs.yaml), each block at its own widths (fp32,
# B=4, 64x64 frames): Dreamer (depth 32, stoch 50 Gaussian, sigmoid2,
# min_std 0.1, deter/hidden 200, the LayerNorm cell; 20 frames), its
# discrete variant (32 x 32 classes) and the spatial RSSM (stoch 16,
# deter/hidden/embed 64 on 16x16 maps, stochastic ConvGRU gates, clip
# 100), on phase 10's frozen corpus; the CATER classifier (B=4, 40-frame
# 64x64x3 episodes in chunks of 20, deter 200, stoch 32, classifier 256)
# on a corpus it writes at the block's 120 + 40 episodes.
WM_TRAIN = ("train_mmnist_dreamer", "train_mmnist_dreamer_discrete",
            "train_mmnist_dreamer_spatial")
# Frames the test phase predicts after 10: Dreamer's test protocol is 10
# -> 90 (the corpus's test videos hold 200 frames).
WM_TEST_OUT = {"train_mmnist_dreamer": 90,
               "train_mmnist_dreamer_discrete": 10,
               "train_mmnist_dreamer_spatial": 10}
WM_STEPS, CATER_STEPS = 5, 6
# The RL loop, cut: its flags.
RL_CUT = ("--wm_steps", "50", "--behavior_steps", "20", "--eval_episodes",
          "16")
# A step on the card against the same step on the CPU (same weights,
# batch and draws): loss relative, every gradient leaf relative L2.
WM_LOSS_TOL, WM_GRAD_TOL = 1e-5, 1e-3


def _check_no_kernels(counts: dict, where: str) -> None:
    launched = {k: counts[k] for k in KERNELS if counts.get(k, 0)}
    if launched:
        raise AssertionError(f"K1-K8 launched in the {where}: {launched}")


def _wm_train(block: str, root: pathlib.Path, logs: pathlib.Path) -> dict:
    """``block`` through ``ode_rl_torch.main``: WM_STEPS steps, every
    logged loss, KL and grad_norm finite, the checkpoint at the last
    step, no K1-K8 launch; step_ms the median of steps 2-5."""
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs / block), "--loss_log_freq", "1",
            "--steps_per_epoch", str(WM_STEPS), "--epochs", "1",
            "--ckpt_save_freq", str(WM_STEPS)]
    cfg, run = _run_dir(argv)
    timer = _TimedTrainStep()
    train_loop.make_train_step = timer
    try:
        out = port_main.main(argv)
    finally:
        train_loop.make_train_step = make_train_step
    _check_tf32_off(f"main on {block}")
    if out["final_step"] != WM_STEPS:
        raise AssertionError(f"{block}: {out['final_step']} steps")
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()
              if "loss" in json.loads(line)]
    kl = "kl" if cfg.model == "Dreamer" else "kl_loss"
    if [m["step"] for m in logged] != list(range(1, WM_STEPS + 1)):
        raise AssertionError(f"{block}: logged steps "
                             f"{[m['step'] for m in logged]}")
    for m in logged:
        bad = [k for k in ("loss", kl, "grad_norm", "image_loss")
               if not np.isfinite(m.get(k, np.nan))]
        if bad:
            raise AssertionError(f"{block} step {m['step']}: {bad} missing "
                                 "or not finite")
    ckpt = CheckpointManager(run / "checkpoints", tag=cfg.ckpt_id)
    if ckpt.all_steps() != [WM_STEPS]:
        raise AssertionError(f"{block}: checkpoints at {ckpt.all_steps()}")
    median = statistics.median(timer.ms[1:])
    print(f"  {block} ({cfg.model}, {cfg.train_in_seq}+"
          f"{cfg.train_out_seq} frames): losses "
          f"{[round(m['loss'], 2) for m in logged]}, {kl} "
          f"{[round(m[kl], 4) for m in logged]}; step_ms "
          f"{[round(t, 2) for t in timer.ms]}, median over steps "
          f"2-{WM_STEPS} {median:.2f}")
    return {"step_ms": median, "logs": logs / block, "model": cfg.model}


def _wm_test(block: str, logs: pathlib.Path, root: pathlib.Path) -> None:
    """The test phase from the train run's checkpoint, one batch, 10 ->
    WM_TEST_OUT frames: every per-horizon value finite."""
    n_out = WM_TEST_OUT[block]
    argv = ["--configs", "defaults", block, "--phase", "test",
            "--load_model", "True", "--data_dir", str(root), "--logdir",
            str(logs), "--eval_batches", "1", "--test_in_seq", "10",
            "--test_out_seq", str(n_out)]
    cfg, run = _run_dir(argv)
    t0 = time.perf_counter()
    out = port_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    _check_tf32_off(f"main on {block} --phase test")
    per_horizon = json.loads((run / "per_horizon.json").read_text())
    for k in ("mse", "psnr", "ssim"):
        v = per_horizon[k]
        if len(v) != n_out or not np.all(np.isfinite(v)):
            raise AssertionError(f"{block} test per_horizon {k}: {len(v)} "
                                 f"values, not {n_out} finite ones")
    print(f"  {block} --phase test (10 -> {n_out}): {seconds:.2f} s; mse "
          f"at frames 1 and {n_out}: {per_horizon['mse'][0]:.4f} "
          f"{per_horizon['mse'][-1]:.4f}; final ssim "
          f"{out['final_ssim']:.4f}")


class _RecordNoise(Noise):
    """The port's ``Noise`` on the CPU, each draw recorded in order."""

    def __init__(self, seed: int):
        super().__init__(torch.Generator().manual_seed(seed))
        self.draws = []

    def _keep(self, kind: str, a: torch.Tensor) -> torch.Tensor:
        self.draws.append((kind, a.detach().clone()))
        return a

    def normal(self, shape, like):
        return self._keep("normal", super().normal(shape, like))

    def gumbel(self, shape, like):
        return self._keep("gumbel", super().gumbel(shape, like))

    def uniform(self, shape, device, low=0.0, high=1.0):
        return self._keep("uniform", super().uniform(shape, device, low,
                                                     high))


class _ReplayNoise(Noise):
    """A ``_RecordNoise``'s draws, in order, on the card."""

    def __init__(self, draws):
        super().__init__(None)
        self.draws = list(draws)

    def _next(self, kind: str, shape) -> torch.Tensor:
        got, a = self.draws.pop(0)
        if got != kind or tuple(a.shape) != tuple(shape):
            raise AssertionError(f"replay: asked {kind} {tuple(shape)}, "
                                 f"recorded {got} {tuple(a.shape)}")
        return a.cuda()

    def normal(self, shape, like):
        return self._next("normal", shape).to(like.dtype)

    def gumbel(self, shape, like):
        return self._next("gumbel", shape).to(like.dtype)

    def uniform(self, shape, device, low=0.0, high=1.0):
        return self._next("uniform", shape)


def _wm_batch(cfg, root: pathlib.Path, device: torch.device) -> dict:
    video = next(FrozenMovingMNIST(root, cfg.batch_size, cfg.train_in_seq,
                                   cfg.train_out_seq, seed=5,
                                   device=device))
    return make_batch_dict(video, cfg.train_in_seq)


def _wm_card_vs_cpu(block: str, root: pathlib.Path) -> dict:
    """One fp32 forward and backward of ``block`` from its seed's weights
    on the card against the same on the CPU: the same weights, batch and
    draws (recorded on the CPU, replayed on the card). The card's step is
    profiled: device ms of its wall ms."""
    cfg = load_config(["defaults", block], overrides={"data_dir": str(root)})
    cpu = torch.device("cpu")
    model = create_train_state(cfg, cpu).model.train()
    batch = _wm_batch(cfg, root, cpu)
    rec = _RecordNoise(7)
    m_c, _ = loss_and_grads(model, batch, rec)
    g_c = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.cuda()
    batch = {k: v.cuda() if torch.is_tensor(v) else v
             for k, v in batch.items()}
    loss_and_grads(model, batch, _ReplayNoise(rec.draws))   # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        t0 = time.perf_counter()
        replay = _ReplayNoise(rec.draws)
        m_g, pred = loss_and_grads(model, batch, replay)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if replay.draws or not torch.isfinite(pred).all():
        raise AssertionError(f"{block}: draws left over, or the prediction "
                             "is not finite")
    label = block[12:]
    check(f"{label} loss card vs CPU (relative)",
          abs(float(m_g["loss"]) / float(m_c["loss"]) - 1.0), WM_LOSS_TOL,
          "rel")
    worst = max(((rel_l2(p.grad.cpu(), g_c[n]), n)
                 for n, p in model.named_parameters()))
    check(f"{label} worst gradient leaf card vs CPU ({worst[1]})", worst[0],
          WM_GRAD_TOL, "rel_l2")
    device = _device_ms(prof)
    print(f"  {block}: draws {len(rec.draws)}; a profiled forward and "
          f"backward, device ms {device:.3f} of {wall_ms:.2f} (busy "
          f"{100 * device / wall_ms:.1f}%)")
    return {"device_ms": device, "wall_ms": wall_ms}


def _cater(root: pathlib.Path, logs: pathlib.Path) -> dict:
    """``train_cater_classifier`` through ``ode_rl_torch.main``, cut to
    one epoch of CATER_STEPS steps, on the corpus it writes at the
    block's size; then ``test_cater_classifier`` from its checkpoint; one
    profiled forward and backward of the classifier step."""
    from ode_rl_torch.core import logging as port_logging
    from ode_rl_torch.wm.cater import CaterClassifierModel, CaterEpisodes
    from ode_rl_torch.wm.classifier import multilabel_bce

    common_argv = ["--data_dir", str(root), "--logdir", str(logs)]
    stamps = []
    log = port_logging.MetricLogger.log

    def stamped(self, step, metrics, prefix=""):
        # Each step logs (loss_log_freq 1) after its metrics reach the
        # host, so the stamps are a synced step clock.
        stamps.append(time.perf_counter())
        return log(self, step, metrics, prefix)

    t0 = time.perf_counter()
    port_logging.MetricLogger.log = stamped
    try:
        out = port_main.main(["--configs", "defaults",
                              "train_cater_classifier", *common_argv,
                              "--epochs", "1", "--steps_per_epoch",
                              str(CATER_STEPS), "--loss_log_freq", "1"])
    finally:
        port_logging.MetricLogger.log = log
    seconds = time.perf_counter() - t0
    _check_tf32_off("main on train_cater_classifier")
    n_videos = len(list((root / "videos").iterdir()))
    bad = [k for k in ("val_mAP", "val_top5", "random_mAP_baseline")
           if not np.isfinite(out[k])]
    if bad or out["steps"] != CATER_STEPS or n_videos != 160:
        raise AssertionError(f"train_cater_classifier: {out}, {n_videos} "
                             "episodes")
    step_ms = [1e3 * (b - a) for a, b in zip(stamps[:CATER_STEPS - 1],
                                             stamps[1:CATER_STEPS])]
    test = port_main.main(["--configs", "defaults", "test_cater_classifier",
                           *common_argv])
    if test["ckpt_step"] != CATER_STEPS or not np.isfinite(test["val_mAP"]):
        raise AssertionError(f"test_cater_classifier: {test}")
    print(f"  train_cater_classifier ({CATER_STEPS} steps, {n_videos} "
          f"episodes written, {seconds:.1f} s with the corpus): val_mAP "
          f"{out['val_mAP']:.4f}, val_top5 {out['val_top5']:.4f}, "
          f"random_mAP_baseline {out['random_mAP_baseline']:.4f}; step_ms "
          f"{[round(t, 2) for t in step_ms]} (median over steps "
          f"2-{CATER_STEPS} {statistics.median(step_ms):.2f}); "
          f"test_cater_classifier: ckpt_step {test['ckpt_step']}, val_mAP "
          f"{test['val_mAP']:.4f}")
    cfg = load_config(["defaults", "train_cater_classifier"])
    model = CaterClassifierModel(
        cfg, generator=torch.Generator().manual_seed(0)).cuda().train()
    batch = next(CaterEpisodes(root, "train", cfg.batch_size, 20, seed=5,
                               device=torch.device("cuda")))
    gen = torch.Generator(device="cuda").manual_seed(7)

    def step():
        model.zero_grad(set_to_none=True)
        loss, (metrics, _) = model.wm.loss({"image": batch["image"]}, gen,
                                           return_features=True)
        logits = model.classify(metrics.pop("_features"), batch["n_chunks"])
        (loss + multilabel_bce(logits, batch["label"])).backward()

    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _tracer_warmup()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = _device_ms(prof)
    print(f"  train_cater_classifier: a profiled forward and backward, "
          f"device ms {device:.3f} of {wall_ms:.2f} (busy "
          f"{100 * device / wall_ms:.1f}%)")
    return {"step_ms": statistics.median(step_ms), "device_ms": device,
            "wall_ms": wall_ms}


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (int, float)):
        return bool(np.isfinite(tree))
    return True


def _rl_loop(tmp: pathlib.Path) -> dict:
    """``ode_rl_torch.rl_demo`` cut (RL_CUT) into a temporary report:
    every number in it finite."""
    from ode_rl_torch import rl_demo

    t0 = time.perf_counter()
    report = rl_demo.main([*RL_CUT, "--report", str(tmp / "rl.json")])
    seconds = time.perf_counter() - t0
    saved = json.loads((tmp / "rl.json").read_text())
    if not _finite(saved) or saved != json.loads(json.dumps(report)):
        raise AssertionError(f"rl_demo report: {saved}")
    print(f"  rl_demo {' '.join(RL_CUT)}: {seconds:.1f} s (wm "
          f"{saved['wm_seconds']} s, behavior {saved['behavior_seconds']} "
          f"s); eval mean reward actor "
          f"{saved['eval_mean_reward_actor']:.4f}, random "
          f"{saved['eval_mean_reward_random']:.4f}")
    return saved


def phase_world_models(bank: torch.Tensor) -> dict:
    print("[14] the world models: Dreamer (Gaussian, discrete) and the "
          f"spatial RSSM through ode_rl_torch.main ({WM_STEPS} steps, fp32, "
          "B=4) and their tests, the CATER classifier (train "
          f"{CATER_STEPS} steps, test), a step of each card vs CPU, the RL "
          "loop cut")
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    common.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        root, logs = tmp / "frozen", tmp / "logs"
        _write_frozen_corpus(root, bank, test_frames=200)
        trains = {block: _wm_train(block, root, logs) for block in WM_TRAIN}
        for block in WM_TRAIN:
            _wm_test(block, trains[block]["logs"], root)
        profiles = {block: _wm_card_vs_cpu(block, root)
                    for block in WM_TRAIN}
        cater = _cater(tmp / "cater", logs / "cater")
        rl = _rl_loop(tmp)
    torch.cuda.synchronize()
    counts = {k: common.launches[k] for k in KERNELS}
    _check_no_kernels(counts, "world models' phase")
    print(f"  K1-K8 launches over phase 14: {counts}")
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    return {"train": trains, "profiles": profiles, "cater": cater,
            "rl": rl, "counts": counts}


# FlowNet's user paths (PR 15), fp32, on the SIMT K5-K7: the FlowNetC,
# FlowNetS and FlowNet2 trainers (steps cut from 2000), the highres
# trainer (steps cut from 300), S3VAE with FlowNet labels (steps cut from
# 50 epochs) and the label script.
FLOW_C_STEPS, FLOW_S_STEPS, FLOW_2_STEPS = 200, 50, 3
HIGHRES_STEPS = 300
# The highres trainer's frames and its correlation's features (1/8).
HIGHRES_SIZE, HIGHRES_SHAPE = (320, 448), (8, 40, 56, 256)
# S3VAE's labels: B=4 x 39 transitions of its 40 frames, 64x64 pairs.
LABEL_SHAPE = (156, 8, 8, 256)
# FlyingChairs' features (384x512 frames), and the FlowNetC trainers'
# (64x64 frames, B=8).
CHAIRS_SHAPE, TRAINER_SHAPE = (8, 48, 64, 256), (8, 8, 8, 256)
FLOW_LABEL_BLOCK = ("train_mmnist_recon_s3vae", "test_mmnist_recon_s3vae")
# FlowNet2's warm start as JAX counts it: [grafted, shape-skipped] (the
# stacked FlowNetS's 12-channel conv1 kernel is skipped).
GRAFTS = {"flownetc": [48, 0], "flownets1": [41, 1], "flownets2": [41, 1]}
# Cells whose mean lies within this of the k-th value may flip with fp32
# noise; the rest must agree exactly.
LABEL_MARGIN = 1e-4
FLOW_KERNELS = (*FLOWNETC_KERNELS, "channelnorm")


def _counted(fn):
    """(fn(), the launches of every kernel counted while it ran), with
    the counts set to 0 just before."""
    torch.cuda.synchronize()
    common.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(common.launches)


def _check_simt_corr(counts: dict, names, where: str) -> None:
    """Each of ``names`` launched, no K5-K7 launch on the tensor cores
    (fp32), and each kernel's pair-view launches ("<name>_pairs", on maps
    of at most 32 cells a class) among its launches."""
    missing = [k for k in names if counts[k] == 0]
    tc = {k: counts[f"{k}_tc"] for k in CORR_TC if counts[f"{k}_tc"]}
    pairs = {k: counts[f"{k}_pairs"] for k in CORR_TC
             if counts[f"{k}_pairs"] > counts[k]}
    if missing or tc or pairs:
        raise AssertionError(f"{where}: not launched {missing}, tensor-core "
                             f"launches {tc}, pair-view launches beyond the "
                             f"kernel's {pairs}: {counts}")


def _profiled(fn) -> dict:
    """Device ms and wall ms of one call of fn under torch.profiler, after
    a call that is not traced."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"device_ms": _device_ms(prof), "wall_ms": wall_ms}


def _flow_trainer(net: str, steps: int, tmp: pathlib.Path,
                  extra: tuple = ()) -> tuple:
    from ode_rl_torch import train_flownetc

    argv = ["--net", net, "--steps", str(steps), "--batch", "8",
            "--flow_dir", str(tmp / "logs" / "flow"), "--report",
            str(tmp / "results" / f"flownet{net}.json"), *extra]
    print(f"  python -m ode_rl_torch.train_flownetc {' '.join(argv)}")
    t0 = time.perf_counter()
    (report, model), counts = _counted(
        lambda: train_flownetc.run(train_flownetc.parse_args(argv)))
    seconds = time.perf_counter() - t0
    if not _finite(report):
        raise AssertionError(f"FlowNet{net} report: {report}")
    per_step = {k: counts[k] / steps for k in FLOW_KERNELS}
    print(f"  FlowNet{net}: {seconds:.1f} s; val EPE random-init "
          f"{report['val_epe_random_init']:.4f} -> trained "
          f"{report['val_epe_trained']:.4f}; train loss "
          f"{report['final_train_loss']:.4f}; {steps} steps in "
          f"{report['train_seconds']} s; launches "
          f"{ {k: counts[k] for k in FLOW_KERNELS} }, a step {per_step}")
    return report, model, counts


def _trainer_step(model, batch) -> dict:
    """One fp32 FlowNetC step on a corpus batch: the kernels against
    ``force_plain()``, same weights and batch, with cuDNN's deterministic
    algorithms so that the kernels are the only difference (loss and EPE
    1e-5 relative, worst gradient leaf 1e-3 relative L2; on a miss the
    five worst leaves are printed beside a second kernels run), then a
    profiled step."""
    img1, img2, flow = batch

    def run():
        metrics = flow_loss_and_grads(model, (img1, img2), flow)
        return metrics, {n: p.grad.clone()
                         for n, p in model.named_parameters()}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m_k, g_k = run()
        with common.force_plain():
            m_p, g_p = run()
        errs = {n: rel_l2(g_k[n], g_p[n]) for n in g_k}
        worst = max(errs, key=errs.get)
        if errs[worst] > 1e-3:
            _, g_k2 = run()
            for n in sorted(errs, key=errs.get, reverse=True)[:5]:
                print(f"    {n}: kernels vs plain rel_l2 {errs[n]:.3e}, "
                      f"kernels twice {rel_l2(g_k2[n], g_k[n]):.3e}, "
                      f"|plain grad| {g_p[n].norm().item():.3e}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for key in ("loss", "epe"):
        check(f"{key} (relative)", abs(float(m_k[key]) / float(m_p[key])
                                       - 1.0), 1e-5, "rel")
    check(f"worst grad leaf ({worst})", errs[worst], 1e-3, "rel_l2")
    opt = torch.optim.Adam(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                           eps=1e-8)

    def step():
        flow_loss_and_grads(model, (img1, img2), flow)
        opt.step()

    return _profiled(step)


def _corr_bounds(shape, dtype=torch.float32) -> dict:
    """K5-K7's bounds at ``shape``, counting the (pixel, displacement)
    pairs whose window lies in the map, as ``_bounds`` does: the products
    against the fp32 units' peak in fp32 and the tensor cores' in bf16 (a
    matrix unit could do them), bytes at the dtype's size."""
    b, h, w, c = shape
    n = n_displacements(CORR_D, CORR_STRIDE)
    offsets = [i * CORR_STRIDE - CORR_D for i in range(n)]
    pairs = b * (sum(max(h - abs(o), 0) for o in offsets)
                 * sum(max(w - abs(o), 0) for o in offsets))
    flops = 2 * pairs * c
    size = 4 if dtype == torch.float32 else 2
    peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
    feature_bytes = b * h * w * c * size
    return {
        "correlation_fwd": _bound(flops, 2 * feature_bytes
                                  + b * h * w * n * n * size, peak),
        "correlation_bwd_f1": _bound(flops, 2 * feature_bytes + pairs * size,
                                     peak),
        "correlation_bwd_f2": _bound(flops, 2 * feature_bytes + pairs * size,
                                     peak),
    }


# K5-K7, whose SIMT kernels take tiles or, on maps of at most 32 cells a
# class, the pair view (counted apart as "<name>_pairs").
SIMT_CORR = ("correlation_fwd", "correlation_bwd_f1", "correlation_bwd_f2")


def _corr_alone(shape, names, gen, dtype=torch.float32) -> dict:
    """K5-K7 (``names``) alone at ``shape`` in ``dtype``, on the SIMT
    kernels: against their plain versions (fp32 1e-5 max abs; bf16 K5 1e-4
    relative L2, K6 and K7 bit-equal), 20 calls bit-equal to the first,
    median ms of the kernel and the plain version, device µs a call, the
    bound and the share of it reached, and the SIMT kernel the call took
    (tiles, or the pair view)."""
    label = str(dtype)[6:]
    bounds = _corr_bounds(shape, dtype)
    rows = {}
    with torch.no_grad():
        ops = _flow_ops(shape, dtype, gen)
        for name in names:
            fn = ops[name]
            common.reset_launches()
            out = fn()
            route = "pairs" if common.launches[f"{name}_pairs"] else "tiles"
            if common.launches[f"{name}_tc"]:
                raise AssertionError(f"{name} {shape} {label}: took the "
                                     f"tensor cores")
            with common.force_plain():
                ref = fn()
            tol, kind = _flow_tol(name, dtype)
            metric = max_abs if kind == "max_abs" else rel_l2
            err = check(f"{name} {shape} {label}", metric(out, ref), tol,
                        kind)
            check(f"{name} {shape} {label}: 20 calls", float(sum(
                not torch.equal(out, fn()) for _ in range(20))), 0.0,
                "unequal")
            del out, ref
            ms = median_ms(fn)
            with common.force_plain():
                plain_ms = median_ms(fn, reps=10)
            us = device_us({name: fn})[name]
            bound = bounds[name]
            rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "device_us": us, **bound, "library_ms": None,
                          "simt_kernel": route}
            print(f"    {name} {shape} {label} (SIMT {route}): median ms "
                  f"kernel {ms:.4f} plain {plain_ms:.4f}; device us a call "
                  f"{us:.2f}; bound {bound['bound_ms'] * 1e3:.2f} us "
                  f"({bound['bound_by']}), "
                  f"{100 * bound['bound_ms'] * 1e3 / us:.1f}% of it reached")
    return rows


def _highres_profile(bank: torch.Tensor) -> dict:
    """A profiled step of the highres trainer's FlowNetC (batch and
    step as ``train_flownetc_highres``)."""
    from ode_rl_torch.train_flownetc_highres import highres_batch_from

    gen = torch.Generator(device="cuda").manual_seed(0)
    video = generate_moving_mnist(gen, bank, batch=8, n_frames=1,
                                  num_digits=3) + 0.5
    coarse = torch.randn((8, 5, 7, 2), generator=gen, device="cuda") * 8.0
    img1, img2, flow = highres_batch_from(video[:, 0], coarse,
                                          *HIGHRES_SIZE)
    model = FlowNetC(generator=torch.Generator().manual_seed(1)).cuda()
    init_fn, step_fn = make_flow_train_step(model)
    state = init_fn()
    prof = _profiled(lambda: step_fn(state, (img1, img2), flow))
    print(f"  a profiled highres step: device ms {prof['device_ms']:.3f} of "
          f"{prof['wall_ms']:.2f} (busy "
          f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}%)")
    return prof


class _LabelRecorder:
    """Stands in for the loop's ``make_train_step``: the same step, with
    each step's host time (closed by a synchronize) and its batch's
    ``in_flow_labels`` recorded."""

    def __init__(self):
        self.ms, self.labels = [], []

    def __call__(self, *args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def recorded(state, batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.labels.append(batch["in_flow_labels"].cpu())
            return metrics

        return recorded


def _label_flows(net, video01: torch.Tensor) -> torch.Tensor:
    """The flow ``make_flownet_label_fn`` takes its labels from:
    FlowNetC's finest flow between consecutive frames, resized to the
    frame and scaled by 4, (B, T-1, H, W, 2)."""
    b, t, h, w, _ = video01.shape
    img = video01.expand(-1, -1, -1, -1, 3)
    i1 = img[:, :-1].reshape(b * (t - 1), h, w, 3)
    i2 = img[:, 1:].reshape(b * (t - 1), h, w, 3)
    with torch.no_grad():
        full = resize_bilinear(net(i1, i2)[0], h, w) * 4.0
    return full.reshape(b, t - 1, h, w, 2)


def _check_labels_vs_plain(net, video01: torch.Tensor) -> dict:
    """S3VAE's FlowNet labels of one batch through the kernels against
    ``force_plain()``: the upsampled flow to 1e-4 max abs, the labels
    exactly on every cell more than LABEL_MARGIN from its transition's
    k-th value; the label function's labels equal those of the flow."""
    label_fn = make_flownet_label_fn(net)
    labels = label_fn(video01)
    flow = _label_flows(net, video01)
    with common.force_plain():
        labels_p = label_fn(video01)
        flow_p = _label_flows(net, video01)
    if not torch.equal(labels, flow_grid_labels(flow)):
        raise AssertionError("the label function's labels are not those of "
                             "its flow")
    check("label flow vs plain", max_abs(flow, flow_p), 1e-4, "max_abs")
    b, t, h, w, _ = flow.shape
    mag = torch.sqrt(torch.sum(flow * flow, dim=-1))
    g = h // 3
    m = mag[:, :, :3 * g, :3 * g].reshape(b, t, 3, g, 3, g).mean(
        dim=(3, 5)).reshape(b, t, 9)
    kth = torch.sort(m, dim=-1).values[..., -3, None]
    clear = (m - kth).abs() > LABEL_MARGIN
    differ = int(((labels != labels_p) & clear).sum())
    check(f"labels vs plain ({int(clear.sum())} of {clear.numel()} cells "
          f"beyond {LABEL_MARGIN:g})", float(differ), 0.0, "cells")
    return {"cells": clear.numel(), "clear": int(clear.sum()),
            "flow_err": max_abs(flow, flow_p)}


def _s3vae_flow_labels(root: pathlib.Path, logs: pathlib.Path,
                       params: pathlib.Path) -> dict:
    """``train_mmnist_recon_s3vae`` with FlowNet labels through
    ``ode_rl_torch.main`` (S3VAE_STEPS steps on the frozen corpus), its
    test block (one batch), one batch's labels against force_plain() and
    a profiled step (labels and training step)."""
    from ode_rl_torch.data.mmnist import parse_datasets

    block, test_block = FLOW_LABEL_BLOCK
    argv = ["--configs", "defaults", block, "--data_dir", str(root),
            "--logdir", str(logs), "--steps_per_epoch", str(S3VAE_STEPS),
            "--epochs", "1", "--loss_log_freq", "1", "--ckpt_save_freq",
            str(S3VAE_STEPS), "--flow_label_source", "flownet",
            "--flownet_params_path", str(params)]
    print(f"  python -m ode_rl_torch.main {' '.join(argv)}")
    cfg, run = _run_dir(argv)
    recorder = _LabelRecorder()
    train_loop.make_train_step = recorder
    try:
        out, counts = _counted(lambda: port_main.main(argv))
    finally:
        train_loop.make_train_step = make_train_step
    if out["final_step"] != S3VAE_STEPS:
        raise AssertionError(f"{block}: {out['final_step']} steps")
    logged = [json.loads(line) for line in
              (run / "metrics.jsonl").read_text().splitlines()]
    for m in logged:
        bad = [k for k in (*S3VAE_METRICS, "grad_norm")
               if not np.isfinite(m.get(k, np.nan))]
        if bad:
            raise AssertionError(f"{block} step {m['step']}: {bad}")
    labels = torch.cat(recorder.labels)
    if not torch.all((labels == 0) | (labels == 1)):
        raise AssertionError(f"{block}: labels outside {{0, 1}}")
    if counts["correlation_fwd"] == 0 or counts["correlation_bwd_f1"] \
            or counts["correlation_bwd_f2"] or counts["correlation_fwd_tc"]:
        raise AssertionError(f"{block} with FlowNet labels: K5 must launch "
                             f"(SIMT) and K6/K7 must not: {counts}")
    per_step = counts["correlation_fwd"] / S3VAE_STEPS
    step_ms = statistics.median(recorder.ms[1:])
    print(f"  {block} with FlowNet labels: losses "
          f"{[round(m['loss'], 3) for m in logged]}; labels "
          f"{tuple(labels.shape)} in {{0, 1}}, {float(labels.sum(-1).mean()):.2f} ones a "
          f"transition; K5 {counts['correlation_fwd']} launches "
          f"({per_step:g} a step), K6 {counts['correlation_bwd_f1']}, K7 "
          f"{counts['correlation_bwd_f2']}; median train step_ms (labels "
          f"made before it) over steps 2-{S3VAE_STEPS} {step_ms:.2f}")
    _s3vae_test(test_block, logs, root)

    device = torch.device("cuda")
    net = FlowNetC(generator=torch.Generator().manual_seed(0)).to(device)
    net.requires_grad_(False)
    load_flax_params(net, load_flownet_params(params)["params"])
    video = next(parse_datasets(cfg, device)["train_dataloader"])
    plain = _check_labels_vs_plain(net, video + 0.5)
    state = create_train_state(cfg, device)
    step = make_train_step()
    label_fn = make_flownet_label_fn(net)
    gen = torch.Generator(device=device).manual_seed(0)

    def labelled_step():
        step(state, make_batch_dict(video, n_in=cfg.train_in_seq,
                                    with_flow_labels=True,
                                    flow_label_fn=label_fn), gen)

    prof = _profiled(labelled_step)
    labels_only = _profiled(lambda: label_fn(video + 0.5))
    print(f"  a profiled step (labels + train step): device ms "
          f"{prof['device_ms']:.3f} of {prof['wall_ms']:.2f} (busy "
          f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}%); the labels "
          f"alone: device ms {labels_only['device_ms']:.3f} of "
          f"{labels_only['wall_ms']:.2f}")
    return {"counts": counts, "step_ms": step_ms, "k5_a_step": per_step,
            "profile": prof, "labels_profile": labels_only, **plain}


def _label_script(root: pathlib.Path, params: pathlib.Path) -> dict:
    """``ode_rl_torch.get_labels_from_pred_flow`` on the corpus's train
    split: (N, T, 9) labels, row 0 zero, every other row at least 3
    ones."""
    from ode_rl_torch import get_labels_from_pred_flow

    argv = ["--data", str(root), "--splits", "train", "--flownet_params",
            str(params), "--batch_videos", "8"]
    print(f"  python -m ode_rl_torch.get_labels_from_pred_flow "
          f"{' '.join(argv)}")
    t0 = time.perf_counter()
    written, counts = _counted(lambda: get_labels_from_pred_flow.main(argv))
    seconds = time.perf_counter() - t0
    videos = np.load(root / "train" / "shard_0000.npy", mmap_mode="r")
    n, t = videos.shape[:2]
    for path in written:
        labels = np.load(path)
        ones = labels[:, 1:].sum(-1)
        if (labels.shape != (n, t, 9) or np.any(labels[:, 0])
                or not np.all((labels == 0) | (labels == 1))
                or ones.min() < 3):
            raise AssertionError(f"{path}: shape {labels.shape}, row 0 "
                                 f"{labels[:, 0].sum()}, fewest ones "
                                 f"{ones.min()}")
    if counts["correlation_fwd"] == 0 or counts["correlation_bwd_f1"]:
        raise AssertionError(f"label script launches: {counts}")
    print(f"  label script: {seconds:.1f} s; {len(written)} file of ({n}, "
          f"{t}, 9), row 0 zero, every other row 3-{int(ones.max())} ones "
          f"(mean {ones.mean():.2f}); K5 {counts['correlation_fwd']} "
          "launches, no K6/K7")
    return {"counts": counts, "seconds": seconds}


def phase_flow_users(bank: torch.Tensor) -> dict:
    from ode_rl_torch import train_flownetc_highres

    print(f"[15] FlowNet's user paths (fp32): train_flownetc --net C "
          f"({FLOW_C_STEPS} steps), --net S ({FLOW_S_STEPS}), --net 2 "
          f"--warm_start ({FLOW_2_STEPS}); the weights file on the card; a "
          f"trainer step vs plain; train_flownetc_highres ({HIGHRES_STEPS} "
          f"steps, 320x448); {FLOW_LABEL_BLOCK[0]} with FlowNet labels; "
          "get_labels_from_pred_flow")
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(15)
    counts, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        params = tmp / "logs" / "flow" / "flownetc.msgpack"

        report_c, model_c, counts["train_flownetc C"] = _flow_trainer(
            "C", FLOW_C_STEPS, tmp)
        _check_simt_corr(counts["train_flownetc C"], FLOWNETC_KERNELS,
                         "train_flownetc --net C")
        if not report_c["val_epe_trained"] < report_c["val_epe_random_init"]:
            raise AssertionError(
                f"FlowNetC: trained val EPE {report_c['val_epe_trained']} "
                f"not below random-init {report_c['val_epe_random_init']}")
        times["train_flownetc C"] = (report_c["train_seconds"] * 1e3
                                     / FLOW_C_STEPS)

        report_s, model_s, counts["train_flownetc S"] = _flow_trainer(
            "S", FLOW_S_STEPS, tmp)
        if any(counts["train_flownetc S"][k] for k in FLOW_KERNELS):
            raise AssertionError(f"FlowNetS launched K5-K8: "
                                 f"{counts['train_flownetc S']}")
        times["train_flownetc S"] = (report_s["train_seconds"] * 1e3
                                     / FLOW_S_STEPS)
        del model_s

        report_2, model_2, counts["train_flownetc 2"] = _flow_trainer(
            "2", FLOW_2_STEPS, tmp, ("--warm_start",))
        _check_simt_corr(counts["train_flownetc 2"], FLOW_KERNELS,
                         "train_flownetc --net 2 --warm_start")
        grafts = {k: report_2["warm_start"][k] for k in GRAFTS}
        if grafts != GRAFTS:
            raise AssertionError(f"warm start grafts {grafts}, JAX's "
                                 f"{GRAFTS}")
        print(f"  FlowNet2 warm start: grafts {grafts} (JAX's counts); "
              f"val EPE random-init {report_2['val_epe_random_init']:.4f}, "
              f"warm {report_2['warm_start']['val_epe_warm_start']:.4f}, "
              f"after {FLOW_2_STEPS} steps {report_2['val_epe_trained']:.4f}")
        times["train_flownetc 2"] = (report_2["train_seconds"] * 1e3
                                     / FLOW_2_STEPS)
        del model_2

        # The weights file read back on the card.
        loaded = FlowNetC(generator=torch.Generator().manual_seed(5)).cuda()
        load_flax_params(loaded, load_flownet_params(params)["params"])
        chairs = tmp / "chairs"
        write_synthetic_chairs(chairs, n_pairs=16, seed=7,
                               device=torch.device("cuda"))
        batch = tuple(torch.from_numpy(a).cuda() for a in next(
            FlyingChairsCorpus(chairs, batch_size=8, seed=0)))
        written, read = model_c.state_dict(), loaded.state_dict()
        check("weights file: parameters vs writer's",
              max(max_abs(written[k], read[k]) for k in written), 0.0,
              "max_abs")
        # cuDNN's deterministic algorithms, so that equal weights give
        # equal outputs.
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with torch.no_grad():
                ours, theirs = model_c(*batch[:2]), loaded(*batch[:2])
        finally:
            torch.backends.cudnn.deterministic = deterministic
        check("weights file: forward vs writer's",
              max(max_abs(a, b) for a, b in zip(ours, theirs)), 0.0,
              "max_abs")
        del model_c
        print("  one fp32 FlowNetC step on a FlyingChairs-layout batch (B=8) "
              "from the trained weights: kernels vs plain")
        trainer_prof = _trainer_step(loaded, batch)
        busy = 100 * trainer_prof["device_ms"] / trainer_prof["wall_ms"]
        print(f"  a profiled FlowNetC trainer step: device ms "
              f"{trainer_prof['device_ms']:.3f} of "
              f"{trainer_prof['wall_ms']:.2f} (busy {busy:.1f}%)")

        report_h, counts["train_flownetc_highres"] = _counted(
            lambda: train_flownetc_highres.main(
                ["--steps", str(HIGHRES_STEPS), "--report",
                 str(tmp / "results" / "highres.json")]))
        _check_simt_corr(counts["train_flownetc_highres"], FLOWNETC_KERNELS,
                         "train_flownetc_highres")
        epe = report_h["epe"]
        first10, last10 = statistics.mean(epe[:10]), statistics.mean(epe[-10:])
        if not (_finite(report_h) and last10 < first10):
            raise AssertionError(f"highres EPE: first 10 {first10}, last 10 "
                                 f"{last10}")
        times["train_flownetc_highres"] = report_h["step_ms"]
        n_h = HIGHRES_STEPS + 1
        print(f"  train_flownetc_highres: {n_h} steps at 320x448, B=8; EPE "
              f"mean of the first 10 {first10:.4f}, of the last 10 "
              f"{last10:.4f}; step_ms {report_h['step_ms']}; launches a step "
              + str({k: counts["train_flownetc_highres"][k] / n_h
                     for k in FLOWNETC_KERNELS}))
        highres_rows = _corr_alone(HIGHRES_SHAPE, CORR_TC, gen)
        highres_prof = _highres_profile(bank)

        root, logs = tmp / "frozen", tmp / "logs"
        _write_frozen_corpus(root, bank, test_frames=200)
        s3vae = _s3vae_flow_labels(root, logs, params)
        counts["s3vae flownet labels"] = s3vae["counts"]
        times["s3vae flownet labels"] = s3vae["step_ms"]
        label_rows = _corr_alone(LABEL_SHAPE, ("correlation_fwd",), gen)
        more_rows = {
            f"{CHAIRS_SHAPE} fp32": _corr_alone(CHAIRS_SHAPE, SIMT_CORR, gen),
            f"{CHAIRS_SHAPE} bf16": _corr_alone(CHAIRS_SHAPE, SIMT_CORR, gen,
                                                torch.bfloat16),
            f"{TRAINER_SHAPE} fp32": _corr_alone(TRAINER_SHAPE, SIMT_CORR,
                                                 gen)}
        script = _label_script(root, params)
        counts["get_labels_from_pred_flow"] = script["counts"]
    print(f"  step_ms by path: {times}")
    print(f"  phase 15: {time.perf_counter() - t0:.1f} s")
    shapes = {name: {f"{HIGHRES_SHAPE} fp32": row}
              for name, row in highres_rows.items()}
    shapes["correlation_fwd"][f"{LABEL_SHAPE} fp32"] = label_rows[
        "correlation_fwd"]
    for key, rows in more_rows.items():
        for name, row in rows.items():
            shapes[name][key] = row
    return {"counts": counts, "times": times, "shapes": shapes,
            "trainer_profile": trainer_prof, "highres_profile": highres_prof,
            "s3vae": s3vae,
            "highres": {"first10": first10, "last10": last10}}


# The evaluation tools and the last helpers, fp32. The first 8 hex
# digits of the sha256 of each video of the corpus CORPUS_SHA256 names,
# train then test, 8 videos a line: where a shard differs, the first video
# that differs is named.
CORPUS_VIDEO_SHA256_8 = (
    "0ed2b7ec703fe8ee2c7537b51ff3bc606e8905893aa01318b5073a4c7934bb1f"
    "9fa9c9bc0666119bee9ef4e19889071808ad40e2e595d80218ddfbb05a88f251"
    "a0bc290bb4a1d941b8d27336151da5d333ca7ce74b86d66c2de9d022442a8b0a"
    "3461550e7da2cda01bac908331441beba5cc6c407220a9edf710da76249799c5"
    "9eef34ddd7d485dc3ea82c144f1585bab2e8ceefc0aae23d825dab42fe65788d"
    "a15e7d3559c21e83e9c1df10f80fd3fc238d086e9f5e6ecfce6ef29c4af506b9"
    "e3c938177c8871b3bfcc0de534c8f7bc069b996d7948187f24ace95c75c68d1e"
    "be4fde3457a945bf1c135effe4bb246147259920cfd5b367eea65a86cd57577f"
    "a169e4105b4b503121744492b9c05bd9ada0f7bf25265fef91d37f2e1d11b353"
    "1e1370635caa11db88a897a8488e497d8590a01d6e43349c989bcde987b81a95"
    "48d64dc87f4d26cd2020fa8843d64646b7b20380bc8b2a0cde3d78c5bd516a45"
    "e0da0dea8f6387b1b2cbc472550bd7684af9d093893b0fd13166e8d025ebdf5d"
    "97d0a0a9b9f1cb270138c98406df487cc5db7c2ce727fa10f898a2b6de19e6cf"
    "dc969b51570ea4639225cb5a4925b2513266ce97fe66a23e5c62f6baedccb9b0"
    "8c36f9878c6b519d40193f3d1e661dc7fdd50f4ffa7d1a351c5027257fb74017"
    "35f14009977b112e20e899a7719d2dc3c024bf497c9bb187634d12b9dac5c155"
    "89dff99a3062c15927d3ced3e472b39502ec5eeecf3ba8ae3634b0f3a79ae149"
    "ed4726b9d1faf20d6ec4169d622d54d6d9e56fd61d1472ac84023e0d4391eee3"
    "2d753a95e8725528a480b8b2a0d148fd095d5cf80dabde1ee80ddb459dd9bd5d"
    "c5806b45f53b74e16c7832f6ca0a83d10eac085c867e3aa9600f141bbcae436f"
    "9bc2ed93e82c93e0202bb67d3aee0bb8ce560f6469dc72d718b2ca731a007f68"
    "b96d75aaf77ad89e819390068d91384f0c6b659216338013c312637cdfd6593b"
    "5f61a1c12546f628c8620cdb575191a8f358647fc4aa70006817104d28ef3562"
    "27691c7186f7a21f29b112797c2797960fa14325ee48bee79bece15257c49058"
    "8a09de0e2426d1b58cfe7ffe0fa6130bdf4eb225dc6b928accb05c75e4c09d65"
    "b4d62ad49b227088b769b11e652931dbbf605a951cbc08e883134e5104e80d12"
    "4227f1434ddc9b0bd15e1dacfc687635ccdc3becd186a779aa3ba1ada840900a"
    "62832ceb0ed060fbbb3fcef7c4daafee12744f4c6219be26c6e22fe022491071"
    "72b5f2da1c1c9fd3c56f58af4207d18ebf287af8a8e2c324fb839b842131088e"
    "f4ed931ab2f31026ba45e2b2d158785fa33405cc7cb803b02ebb52d369821b96"
    "49ee3cb30ae30f317019e06a0289204ac23d68a73a2c424731e036bcd4a7c4d7"
    "bb99eaa528ae84e84902ef8d48363dc7c9160c14f24fa3e24e9159d4dce5b0f4"
)
CORPUS_ARGS = ("--videos", "256", "--frames", "200", "--train_split", "0.75")
PARITY_VIDEOS = 4
# mmnist_disentangle, cut: the judge's steps (from 1500; on an H100 80GB
# HBM3 at 700 W its batch accuracy on the sprite read 0.23, 0.44, 0.80 and
# 0.89 at steps 500, 750, 1000 and 1250), the swaps' batches (from 16),
# the probes' batches and steps (from 64 + 16, 600).
JUDGE_CUT = ("--judge_steps", "1000", "--eval_batches", "2",
             "--probe_train_batches", "8", "--probe_eval_batches", "2",
             "--probe_steps", "200")
# sprite_disagreement, cut: the judge's steps (from 400), the batches of
# each sweep (from 8).
DISAGREE_CUT = ("--steps", "100", "--batches", "2")
JUDGE_TRAIN_STEPS = 4
# The planners on an action-conditioned world model (rl_demo's widths),
# trained this many steps on random episodes first.
PLAN_WM_STEPS, PLAN_HORIZON = 50, 12


def _corpus_writer(tmp: pathlib.Path) -> tuple:
    """The native generator built on this host, then the corpus written
    and held to the bytes the CPU host wrote."""
    from ode_rl_torch import make_frozen_mmnist
    from ode_rl_torch.data import native_gen

    gen = native_gen.native_generator()
    # The library's name holds this host's key: one built elsewhere and
    # copied with the tree is not loaded (0.00 s: built here before).
    print(f"  native generator: {' '.join((native_gen.CXX, *native_gen.FLAGS))}"
          f"; built on this host in {gen.build_seconds:.2f} s ({gen.path.name})")
    root = tmp / "corpus"
    t0 = time.perf_counter()
    digests = make_frozen_mmnist.main(["--out", str(root), *CORPUS_ARGS])
    seconds = time.perf_counter() - t0
    if digests != CORPUS_SHA256:
        videos = [v for name in CORPUS_SHA256 for v in np.load(root / name)]
        ref = "".join(CORPUS_VIDEO_SHA256_8)
        for i, v in enumerate(videos):
            ours = hashlib.sha256(v.tobytes()).hexdigest()[:8]
            if ours != ref[8 * i:8 * i + 8]:
                raise AssertionError(
                    f"corpus: shard digests {digests}, expected "
                    f"{CORPUS_SHA256}; video {i} (in corpus order) differs "
                    f"first: {ours} against {ref[8 * i:8 * i + 8]}")
        raise AssertionError(f"corpus: shard digests {digests}, expected "
                             f"{CORPUS_SHA256}, every video equal")
    print(f"  corpus {' '.join(CORPUS_ARGS)}: {seconds:.2f} s, every shard "
          "sha256 equal to the CPU host's")
    return root, {"build_s": gen.build_seconds, "write_s": seconds}


def _parity_eval(corpus: pathlib.Path, tmp: pathlib.Path) -> dict:
    """ode_rl_torch.parity_eval on the corpus's first test videos, the
    recipe model from the seed's weights saved as a checkpoint."""
    from ode_rl_torch import parity_eval

    cfg = load_config(RECIPE)
    state = create_train_state(cfg, torch.device("cuda"))
    CheckpointManager(tmp / "logs" / cfg.model / "parity" / "checkpoints",
                      tag="parity_port").save(
        0, {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}, config=cfg.to_dict())
    del state
    results = parity_eval.main([
        "--data", str(corpus), "--ckpt_id", "parity_port", "--logdir",
        str(tmp / "logs"), "--eval_videos", str(PARITY_VIDEOS), "--batch",
        str(PARITY_VIDEOS), "--out", str(tmp / "parity")])
    # The keys of scripts/jax_parity_eval.py's metrics.json.
    if set(results) != {"ckpt_id", "step", "10to10", "10to90"}:
        raise AssertionError(f"parity_eval keys {sorted(results)}")
    for horizon, n in (("10to10", 10), ("10to90", 90)):
        row = results[horizon]
        if set(row) != {"mse", "psnr", "ssim"} or not all(
                len(v) == n and np.all(np.isfinite(v)) for v in row.values()):
            raise AssertionError(f"parity_eval {horizon}: {row}")
    print(f"  parity_eval on {PARITY_VIDEOS} test videos: final mse "
          f"10to10 {results['10to10']['mse'][-1]:.5f}, 10to90 "
          f"{results['10to90']['mse'][-1]:.5f}; keys as JAX's script's")
    return results


def _checked_odeint() -> dict:
    """checked_odeint over the recipe's decode field on the card: bit-equal
    to odeint_aux on a clean run, FloatingPointError at t=0.5 on a field
    that turns NaN there."""
    from ode_rl_torch.core.debug import checked_odeint
    from ode_rl_torch.ode.solvers import odeint_aux

    cfg = load_config(RECIPE)
    model = create_train_state(cfg, torch.device("cuda")).model
    field = lambda t, y: model.ode_decoder_func(y).float()
    gen = torch.Generator(device="cuda").manual_seed(16)
    y0 = 0.5 * torch.randn((RECIPE_B, 16, 16, 64), generator=gen,
                           device="cuda")
    ts = np.linspace(0.0, 1.0, 11).astype(np.float32)
    kw = dict(method="dopri5", rtol=float(cfg.get("odeint_rtol", 1e-4)),
              atol=float(cfg.get("odeint_atol", 1e-5)),
              max_steps=int(cfg.get("ode_max_steps", 128)))
    with torch.no_grad():
        (ys, stats), counts = _counted(lambda: checked_odeint(field, y0, ts,
                                                              **kw))
        ref, ref_stats = odeint_aux(field, y0, ts, **kw)
    if not (torch.equal(ys, ref) and stats == ref_stats):
        raise AssertionError(f"checked_odeint vs odeint_aux: max abs "
                             f"{max_abs(ys, ref)}, stats {stats} vs "
                             f"{ref_stats}")
    if not counts["conv3x3_fwd"] or (counts["conv3x3_fwd_simt"]
                                     != counts["conv3x3_fwd"]):
        raise AssertionError(f"checked_odeint's K1 launches: {counts}")
    nan_at = lambda t, y: field(t, y) * (float("nan") if t >= 0.5 else 1.0)
    try:
        with torch.no_grad():
            checked_odeint(nan_at, y0, np.linspace(0.0, 1.0, 5).astype(
                np.float32), method="euler")
    except FloatingPointError as e:
        if "t=0.5" not in str(e):
            raise AssertionError(f"checked_odeint named another time: {e}")
        print(f"  a field NaN from t=0.5: FloatingPointError({e})")
    else:
        raise AssertionError("checked_odeint passed a NaN field")
    print(f"  checked_odeint (dopri5, (4, 16, 16, 64), 11 times): bit-equal "
          f"to odeint_aux, nfe {stats.nfe}, K1 launches "
          f"{counts['conv3x3_fwd']} (all SIMT)")
    return counts


def _profiler_paths(bank: torch.Tensor, tmp: pathlib.Path) -> dict:
    """StepTimer over 10 fused recipe steps, then a 2-step trace."""
    from ode_rl_torch.core.profiler import StepTimer, annotate, trace

    cfg = load_config(RECIPE)
    state = create_train_state(cfg, torch.device("cuda"))
    step = make_fused_train_step(cfg, bank)
    gen = torch.Generator(device="cuda").manual_seed(16)
    timer = StepTimer(warmup=3, device=torch.device("cuda"))

    def timed():
        timer.tick()
        for _ in range(10):
            step(state, gen)
            timer.tick()

    _, counts = _counted(timed)
    summary = timer.summary()
    if set(summary) != {"mean_ms", "p50_ms", "p95_ms", "steps_per_sec"}:
        raise AssertionError(f"StepTimer summary {summary}")
    _check_recipe_routes(counts, "StepTimer's recipe steps")
    print(f"  StepTimer(warmup=3) over 10 recipe steps: "
          + ", ".join(f"{k} {v:.2f}" for k, v in summary.items()))
    _tracer_warmup()
    with trace(tmp / "trace"):
        for _ in range(2):
            with annotate("recipe_step"):
                step(state, gen)
        torch.cuda.synchronize()
    events = json.loads((tmp / "trace" / "trace.json").read_text())[
        "traceEvents"]
    names = [e.get("name", "") for e in events]
    spans = names.count("recipe_step")
    k1 = sum(1 for n in names if _KERNEL_NAME.search(n)
             and _KERNEL_IDS[_KERNEL_NAME.search(n).group(1)] == "K1")
    if spans < 2 or not k1:
        raise AssertionError(f"trace: {spans} recipe_step spans, {k1} K1 "
                             "kernel events")
    print(f"  trace: {len(events)} events, {spans} recipe_step spans, {k1} K1 "
          "kernel events")
    return {"summary": summary, "counts": counts}


def _s3vae_judge(tmp: pathlib.Path) -> dict:
    """Two one-digit S3VAE runs (the four terms, l1 = l2 = l3 = 0), then
    mmnist_disentangle cut; the judge beats chance on real videos."""
    from ode_rl_torch import mmnist_disentangle

    logs = tmp / "s3vae_logs"
    base = ["--configs", "defaults", "train_mmnist_recon_s3vae",
            "--num_digits", "1", "--num_sprites", "16", "--logdir", str(logs),
            "--steps_per_epoch", str(JUDGE_TRAIN_STEPS), "--epochs", "1",
            "--ckpt_save_freq", str(JUDGE_TRAIN_STEPS), "--quiet", "True"]
    port_main.main([*base, "--id", "s3vae_full", "--ckpt_id", "s3vae_full"])
    port_main.main([*base, "--id", "s3vae_abl", "--ckpt_id", "s3vae_abl",
                    "--l1", "0", "--l2", "0", "--l3", "0"])
    t0 = time.perf_counter()
    report = mmnist_disentangle.main([
        "--ckpt_full", "s3vae_full", "--ckpt_abl", "s3vae_abl", "--logdir",
        str(logs), "--out", str(tmp / "s3vae_disentangle.json"), *JUDGE_CUT])
    seconds = time.perf_counter() - t0
    for tag, row in report["models"].items():
        real = row["real"]
        if not (real["sprite"] > 1 / 16 and real["q0"] > 0.25
                and real["q1"] > 0.25):
            raise AssertionError(f"{tag}: the judge on real videos {real}, "
                                 "not above chance (1/16, 1/4, 1/4)")
        print(f"  mmnist_disentangle {tag}: judge on real videos {real}; "
              f"recon {row['recon']}; probes {row['latent_probes']}")
    print(f"  mmnist_disentangle ({' '.join(JUDGE_CUT)}): {seconds:.1f} s; "
          f"judge's last step {report['judge_train_final']}")
    return report


def _dsvae_tools(tmp: pathlib.Path) -> dict:
    """train_sprite_dsvae, then sprite_probe_grids and sprite_disagreement
    cut."""
    from ode_rl_torch import sprite_disagreement, sprite_probe_grids

    logs = tmp / "dsvae_logs"
    port_main.main(["--configs", "defaults", "train_sprite_dsvae",
                    "--logdir", str(logs), "--steps_per_epoch",
                    str(JUDGE_TRAIN_STEPS), "--epochs", "1",
                    "--ckpt_save_freq", str(JUDGE_TRAIN_STEPS), "--data_dir",
                    str(tmp / "no_sprites"), "--quiet", "True"])
    paths = sprite_probe_grids.main(["--logdir", str(logs), "--out",
                                     str(tmp / "grids")])
    if len(paths) != 6 or not all(p.stat().st_size for p in paths):
        raise AssertionError(f"sprite_probe_grids wrote {paths}")
    report = sprite_disagreement.main([
        "--logdir", str(logs), "--out", str(tmp / "disagreement.json"),
        *DISAGREE_CUT])
    sweeps = ("fixed_action_resampled_content",
              "fixed_content_resampled_motion")
    if set(report) != {"ckpt_step", "judge_steps", *sweeps}:
        raise AssertionError(f"sprite_disagreement keys {sorted(report)}")
    for name in sweeps:
        row = report[name]
        if (set(row) != {"acc", "kl", "IS", "H_yx", "H_y"}
                or not _finite(row) or not 0.0 <= row["acc"] <= 1.0):
            raise AssertionError(f"sprite_disagreement {name}: {row}")
    print(f"  sprite_probe_grids: {len(paths)} PNGs; sprite_disagreement "
          f"({' '.join(DISAGREE_CUT)}): " + "; ".join(
              f"{n} {report[n]}" for n in sweeps))
    return report


def _wm_helpers(bank: torch.Tensor) -> dict:
    """The CEM and gradient planners through an action-conditioned world
    model (rl_demo's), ImpalaCNN on the card against the CPU, and
    EpisodeLoader's shapes."""
    from ode_rl_torch.nn.impala import ImpalaCNN
    from ode_rl_torch.wm import envs
    from ode_rl_torch.wm.datasets import EpisodeLoader
    from ode_rl_torch.wm.planners import cem_planner, grad_planner
    from ode_rl_torch.wm.world_model import WorldModel, world_model_optimizer

    cuda = torch.device("cuda")
    wm = WorldModel(image_shape=(64, 64, 1), cnn_depth=16, stoch=16,
                    deter=128, hidden=128, discrete=16, pred_reward=True,
                    action_dim=2,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    opt = world_model_optimizer(wm.parameters(), lr=3e-4)
    collect = Noise(torch.Generator(device="cuda").manual_seed(42))
    sample = Noise(torch.Generator(device="cuda").manual_seed(43))
    for _ in range(PLAN_WM_STEPS):
        opt.zero_grad()
        loss, _ = wm.loss(envs.collect_random(collect, bank, 16, 12), sample)
        loss.backward()
        opt.step()
    wm.requires_grad_(False)
    with torch.no_grad():
        ep = envs.collect_random(collect, bank, 1, 12)
        post, _ = wm.dynamics.observe(wm.encoder(ep["image"]), sample,
                                      actions=ep["action"])
    start = {k: v[:, -1] for k, v in post.items()}
    seen = []

    def rollout_fn(actions: torch.Tensor, noise) -> torch.Tensor:
        """Predicted return of (P, H, 2) actions: the prior's mode rolled
        from the start state, the reward head summed."""
        p = actions.shape[0]
        state = {k: v.expand(p, *v.shape[1:]) for k, v in start.items()}
        total = torch.zeros(p, device=cuda)
        for h in range(actions.shape[1]):
            state = wm.dynamics.img_step(state, None, sample=False,
                                         action=actions[:, h])
            total = total + wm.reward_head(wm.dynamics.get_feat(state))
        seen.append(float(total.detach().mean()))
        return total

    plan = cem_planner(rollout_fn, torch.Generator(device="cuda")
                       .manual_seed(5), PLAN_HORIZON, 2, device=cuda)
    first = seen[0]
    with torch.no_grad():
        planned = float(rollout_fn(plan[None], None))
    if not planned >= first:
        raise AssertionError(f"CEM: the plan's return {planned} below the "
                             f"first iteration's mean proposal {first}")
    seen.clear()
    actions = grad_planner(rollout_fn, torch.Generator(device="cuda")
                           .manual_seed(6), PLAN_HORIZON, 2, device=cuda)
    first_obj = -seen[0]
    with torch.no_grad():
        final_obj = -float(rollout_fn(actions[None], None))
    if not final_obj <= first_obj:
        raise AssertionError(f"grad planner: objective {final_obj} after, "
                             f"{first_obj} first")
    print(f"  CEM (10 x 1000 proposals, top 100, H={PLAN_HORIZON}): plan "
          f"return {planned:.4f} >= first mean proposal {first:.4f}; grad "
          f"planner (50 steps, lr 0.1): objective {first_obj:.4f} -> "
          f"{final_obj:.4f}")

    x = torch.randn((8, 64, 64, 3), generator=torch.Generator().manual_seed(
        16))
    net = ImpalaCNN(3, out_features=256, in_hw=(64, 64),
                    generator=torch.Generator().manual_seed(16))
    with torch.no_grad():
        on_cpu = net(x)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            on_card = net.to(cuda)(x.to(cuda))
        finally:
            torch.backends.cudnn.deterministic = deterministic
    check("ImpalaCNN (8, 64, 64, 3) -> 256: card vs CPU",
          max_abs(on_card.cpu(), on_cpu), 1e-5, "max_abs")

    shapes = {}
    for batch, rows in ((6, 4), (8, 8)):
        image = next(EpisodeLoader(batch, 200, 50, device=cuda))["image"]
        shapes[batch] = tuple(image.shape)
        if (shapes[batch] != (rows, 50, 64, 64, 1)
                or image.device.type != "cuda"):
            raise AssertionError(f"EpisodeLoader({batch}, 200, 50): "
                                 f"{shapes[batch]} on {image.device}")
    print(f"  EpisodeLoader (200-frame episodes in chunks of 50): batch 6 -> "
          f"{shapes[6]} (JAX's short batch), batch 8 -> {shapes[8]}")
    return {"cem": (first, planned), "grad": (first_obj, final_obj)}


def phase_eval_tools(bank: torch.Tensor, corpus_dir: pathlib.Path) -> dict:
    print("[16] the evaluation tools and the last helpers: the native corpus "
          "writer, parity_eval, checked_odeint, the profiler, the two "
          "judges' scripts, the planners, ImpalaCNN, EpisodeLoader")
    t0 = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        corpus, corpus_s = _corpus_writer(corpus_dir)
        parity, counts["parity_eval"] = _counted(
            lambda: _parity_eval(corpus, tmp))
        counts["checked_odeint"] = _checked_odeint()
        profiler = _profiler_paths(bank, tmp)
        counts["StepTimer"] = profiler["counts"]
        judge, counts["mmnist_disentangle"] = _counted(
            lambda: _s3vae_judge(tmp))
        disagreement, counts["dsvae tools"] = _counted(
            lambda: _dsvae_tools(tmp))
        planners, counts["wm helpers"] = _counted(lambda: _wm_helpers(bank))
    _check_tf32_off("phase 16")
    seconds = time.perf_counter() - t0
    print(f"  K1-K8 launches by path: " + str({
        path: {k: run[k] for k in KERNELS if run[k]}
        for path, run in counts.items()}))
    print(f"  phase 16: {seconds:.1f} s")
    return {"counts": counts, "corpus": corpus_s, "corpus_root": corpus,
            "parity": parity,
            "profiler": profiler["summary"], "judge": judge,
            "disagreement": disagreement, "planners": planners,
            "seconds": seconds}


# Phase 17: data parallelism (ode_rl_torch/parallel). The recipe's run
# under torchrun at one NCCL rank against the same run without the mesh,
# with cuDNN deterministic: one process each, step times taken around the
# loop's train step.
DP_STEPS = 10
DP_RUNNER = """
import json, os, pathlib, sys, time
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
from ode_rl_torch.main import main
from ode_rl_torch.ops import common
from ode_rl_torch.parallel import mesh
from ode_rl_torch.train import loop

out, argv = sys.argv[1], sys.argv[2:]
times, moved = [], []
make = loop.make_train_step

def timed_factory(*args, **kwargs):
    step = make(*args, **kwargs)
    def timed(state, batch, generator=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch, generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return metrics
    return timed

reduce = mesh.Mesh.all_reduce_grads

def counted(self, params):
    reduce(self, params)
    moved.append(self.grad_bytes)

loop.make_train_step = timed_factory
mesh.Mesh.all_reduce_grads = counted
common.reset_launches()
main(argv)
if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
if int(os.environ.get("RANK", "0")) == 0:
    pathlib.Path(out).write_text(json.dumps({
        "step_ms": times, "grad_bytes": moved,
        "launches": dict(common.launches)}))
"""
# The two gloo ranks on one card against one rank: the gradients' sums
# split in two (K2's bf16 weight gradient rounded once a rank, then
# added), so loss and grad_norm are held to these, not bit for bit.
DP_TOL = (f"(rtol, atol) flagship_bench {dryrun.BENCH_TOL}, "
          f"flownetc_bench {dryrun.FLOW_BENCH_TOL}")


def _dp_recipe(tmp: pathlib.Path, root: pathlib.Path) -> dict:
    """The recipe through ``ode_rl_torch.main``, DP_STEPS steps, once
    without the mesh and once under ``torch.distributed.run
    --nproc_per_node 1`` with ``--use_mesh True`` (NCCL): per-step losses
    and grad_norms bit-equal, the same launches."""
    runner = tmp / "dp_runner.py"
    runner.write_text(DP_RUNNER)
    env = {**os.environ,
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent)}
    runs = {}
    for label, launcher, extra in (
            ("plain", [sys.executable], []),
            ("mesh", [sys.executable, "-m", "torch.distributed.run",
                      "--standalone", "--nproc_per_node", "1"],
             ["--use_mesh", "True"])):
        logs = tmp / f"dp_{label}"
        out = tmp / f"dp_{label}.json"
        argv = ["--configs", *RECIPE, "--data_dir", str(root), "--logdir",
                str(logs), "--steps_per_epoch", str(DP_STEPS), "--epochs",
                "1", "--loss_log_freq", "1", "--ckpt_save_freq", "1000",
                "--quiet", "True", *extra]
        cmd = [*launcher, str(runner), str(out), *argv]
        print(f"  {label}: {' '.join(cmd[len(launcher):])}")
        subprocess.run(cmd, check=True, env=env, timeout=600)
        logged = [json.loads(line) for line in (
            logs / "ODEConv" / "ODEConv_mmnist_train_10_10" /
            "metrics.jsonl").read_text().splitlines()]
        runs[label] = {**json.loads(out.read_text()), "logged": logged}
    plain, mesh = runs["plain"], runs["mesh"]
    for key in ("loss", "grad_norm"):
        a = [m[key] for m in plain["logged"]]
        b = [m[key] for m in mesh["logged"]]
        if len(a) != DP_STEPS or a != b:
            raise AssertionError(f"recipe {key} under one NCCL rank {b} "
                                 f"is not the plain run's {a}")
    if plain["launches"] != mesh["launches"]:
        raise AssertionError(f"launches differ: {plain['launches']} vs "
                             f"{mesh['launches']}")
    _check_recipe_routes(mesh["launches"], "recipe under one NCCL rank")
    if len(set(mesh["grad_bytes"])) != 1:
        raise AssertionError(f"all-reduce bytes {mesh['grad_bytes']}")
    out = {label: statistics.median(run["step_ms"][1:])
           for label, run in runs.items()}
    print(f"  losses and grad_norms of the {DP_STEPS} steps bit-equal; "
          f"median step_ms over steps 2-{DP_STEPS}: plain {out['plain']:.2f}"
          f", one NCCL rank {out['mesh']:.2f}; gradient all-reduce "
          f"{mesh['grad_bytes'][0]} bytes a step")
    return {"step_ms": out, "grad_bytes": mesh["grad_bytes"][0],
            "launches": mesh["launches"]}


def _dp_gloo() -> dict:
    """flagship_bench and flownetc_bench over two gloo ranks on cuda:0
    against the one-rank step on the same weights and global batch."""
    probe = dryrun.gloo_device_probe("cuda:0")
    print(f"  gloo with CUDA tensors: {probe}")
    if set(probe.values()) != {"accepted"}:
        raise AssertionError(f"the mesh hands gloo CUDA tensors: {probe}")
    names = ("flagship_bench", "flownetc_bench")
    results = dryrun.run(names, ranks=2, device="cuda:0", backend="gloo",
                         timed_steps=3, threads=4, timeout=600)
    for name in names:
        res = results[name]
        bad = dryrun.misses(name, res, res["single"])
        print(f"  {name}: two ranks {_short(res['sharded'])}; one rank "
              f"{_short(res['single'])}; parameters bit-equal across the "
              f"ranks {res['params_equal']}; all-reduce "
              f"{res['grad_bytes']} bytes; step_ms two ranks "
              f"{[round(t, 2) for t in res['step_ms']]}, one rank "
              f"{[round(t, 2) for t in res['single_step_ms']]}")
        if bad:
            raise AssertionError(f"{name}: {bad}")
        for rank, counts in enumerate(res["rank_launches"]):
            print(f"    rank {rank} launches: "
                  f"{ {k: v for k, v in counts.items() if v} }")
            if name == "flagship_bench":
                missing = [k for k in FLAGSHIP_KERNELS if counts[k] == 0]
                tc = all(counts[f"{k}_tc"] == counts[k]
                         for k in ("conv3x3_fwd", "conv3x3_wgrad"))
            else:
                missing = [k for k in FLOWNETC_KERNELS if counts[k] == 0]
                tc = True
            if missing or not tc:
                raise AssertionError(f"{name} rank {rank}: missing "
                                     f"{missing}, K1/K2 all tensor-core {tc}")
    return {"probe": probe, **results}


def _short(metrics: dict) -> str:
    return " ".join(f"{k} {metrics[k]!r}" for k in
                    ("loss", "grad_norm", "epe", "nfe") if k in metrics)


def phase_data_parallel(bank: torch.Tensor) -> dict:
    print(f"[17] data parallelism: the recipe at one NCCL rank under "
          f"torchrun vs without the mesh; flagship_bench and "
          f"flownetc_bench over two gloo ranks on this one card vs one "
          f"rank ({DP_TOL}); not a multi-card figure")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        root = tmp / "frozen"
        _write_frozen_corpus(root, bank)
        recipe = _dp_recipe(tmp, root)
    gloo = _dp_gloo()
    _check_tf32_off("phase 17")
    seconds = time.perf_counter() - t0
    print(f"  phase 17: {seconds:.1f} s")
    return {"recipe": recipe, "gloo": gloo, "seconds": seconds}


# Phase 18: the 'model' and 'space' axes (parallel/tp.py, parallel/sp.py).
AXIS_TOL = (f"(rtol, atol) {dryrun.AXIS_BENCH_TOL}, update "
            f"{dryrun.BENCH_PARAM_TOL} relative L2")
# K1-K4 on each rank: under 'space' K3 and K4 are the moments-in ones.
AXIS_ROUTES = {
    "flagship_bench_tp": (*FLAGSHIP_KERNELS, "conv3x3_fwd_nt32"),
    "flagship_bench_sp": ("conv3x3_fwd", "conv3x3_wgrad", *AXIS_KERNELS)}


def _axis_bench(baseline: float) -> dict:
    """``baseline``: the update's relative L2 of phase 17's two-rank
    ``flagship_bench`` (a 'data' line) against one rank. Every K1 and K2
    launch on every rank must take the tensor cores (the 'model' rank's
    Cout 32 K2 and fp32-output dx partials included), and on a 'space'
    rank its own 8 rows with a halo operand; one more step on
    each rank is profiled, and rank 0's device ms by kernel group and
    each K1-K8 kernel's µs a launch are printed."""
    names = tuple(AXIS_ROUTES)
    results = dryrun.run(names, ranks=2, device="cuda:0", backend="gloo",
                         timed_steps=1, threads=4, timeout=600, profile=True)
    print(f"  (phase 17's flagship_bench over a 'data' line of two: update "
          f"{baseline!r} relative L2 from the one-rank update)")
    for name in names:
        res = results[name]
        bad = dryrun.misses(name, res, res["single"])
        print(f"  {name}: two ranks {_short(res['sharded'])}; one rank "
              f"{_short(res['single'])}; parameters bit-equal across the "
              f"ranks {res['params_equal']}; update "
              f"{res['update_rel_l2']!r} relative L2 from the one-rank "
              f"update; bytes sent a rank in the step {res['moved_bytes']}"
              f" (gradient all-reduce {res['grad_bytes']}); step_ms two "
              f"ranks {[round(t, 2) for t in res['step_ms']]}, one rank "
              f"{[round(t, 2) for t in res['single_step_ms']]}")
        if bad:
            raise AssertionError(f"{name}: {bad}")
        for rank, counts in enumerate(res["rank_launches"]):
            print(f"    rank {rank} launches: "
                  f"{ {k: v for k, v in counts.items() if v} }")
            missing = [k for k in AXIS_ROUTES[name] if counts[k] == 0]
            missing += [f"a {k} launch off the tensor cores"
                        for k in ("conv3x3_fwd", "conv3x3_wgrad")
                        if counts[f"{k}_tc"] != counts[k]]
            # Under 'space' every K1/K2 launch takes the rank's own rows
            # (half the latent's) and a halo operand; none elsewhere.
            heights = res["rank_halo_heights"][rank]
            sp = name.endswith("_sp")
            missing += [f"a {k} launch {'without' if sp else 'with'} a halo"
                        for k in ("conv3x3_fwd", "conv3x3_wgrad")
                        if counts[f"{k}_halo"] != (counts[k] if sp else 0)]
            if heights != ([SP_ROWS] if sp else []):
                missing.append(f"halo launches at H {heights}")
            print(f"    rank {rank}: K1/K2 launches with a halo at H "
                  f"{heights}")
            if sp and (
                    counts["gru_gates"] != counts["gru_gates_mom"]
                    or counts["gru_blend"] != counts["gru_blend_mom"]
                    or counts["gru_moments"] != counts["gru_gates_mom"]
                    + counts["gru_blend_mom"]):
                missing.append("a K3/K4 launch off the moments-in kernels")
            # A 'space' rank's moments passes and K3 and K4 epilogues take
            # their vector kernels; a 'model' rank's K1 at Cout 32 one
            # 32-channel column block (its other K1 launches, the dx
            # partials to 64, take blocks of 64).
            missing += [f"a {k} launch off its vector kernel"
                        for k in ("gru_moments", "gru_gates_mom",
                                  "gru_blend_mom")
                        if sp and counts[f"{k}_vec"] != counts[k]]
            if counts["conv3x3_fwd_nt16"] or (
                    counts["conv3x3_fwd_nt32"] == 0) != sp:
                missing.append("a K1 launch in 16-channel blocks, or NT-32 "
                               "launches where Cout is not 32")
            print(f"    rank {rank}: K1 launches in 32 / 16-channel blocks "
                  f"{counts['conv3x3_fwd_nt32']} / "
                  f"{counts['conv3x3_fwd_nt16']}; vector / scalar "
                  "kernels: moments pass "
                  f"{counts['gru_moments_vec']} / "
                  f"{counts['gru_moments_scalar']}, K3 moments in "
                  f"{counts['gru_gates_mom_vec']} / "
                  f"{counts['gru_gates_mom_scalar']}, K4 moments in "
                  f"{counts['gru_blend_mom_vec']} / "
                  f"{counts['gru_blend_mom_scalar']}")
            if missing:
                raise AssertionError(f"{name} rank {rank}: missing "
                                     f"{missing}")
        prof = res["profile"]
        print(f"    rank 0, one more step profiled (the other rank shares "
              f"the card): device ms {prof['device_ms']:.3f}; by group "
              + ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(
                  prof["groups"].items(), key=lambda kv: -kv[1])))
        for kernel, (n, us) in sorted(prof["kernels"].items()):
            print(f"    rank 0 {kernel}: {n} launches, {us:.2f} device us "
                  "a launch")
    return results


def _axis_dryrun() -> dict:
    """The dry run's flagship dp x tp and dp x sp steps at four gloo
    ranks on this card, against the one-process step: with the convs
    outside K1-K4 on cuDNN (a reading), then on PyTorch's own CUDA
    convolution (held at the dry run's tolerances). cuDNN's fp32
    algorithms at the one-process step's shapes read 1.1e-4 of grad_norm
    off that convolution's (H100 80GB HBM3, 700 W), past the dry run's
    1e-4, while the 'space' tiles' shapes take other algorithms."""
    out = {}
    for cudnn in (True, False):
        results = dryrun.run(dryrun.DRYRUN_AXES, ranks=4, device="cuda:0",
                             backend="gloo", threads=2, timeout=600,
                             cudnn=cudnn)
        for name in dryrun.DRYRUN_AXES:
            res = results[name]
            bad = dryrun.misses(name, res, res["single"])
            print(f"  dry run {name} at 4 ranks, convs outside K1-K4 on "
                  f"{'cuDNN' if cudnn else 'PyTorch own'}: "
                  f"{_short(res['sharded'])}; one process "
                  f"{_short(res['single'])}; update "
                  f"{res['update_rel_l2']!r} relative L2; parameters "
                  f"bit-equal across the ranks {res['params_equal']}"
                  f"{'; ' + '; '.join(bad) if bad else ''}")
            if bad and not cudnn:
                raise AssertionError(f"dry run {name}: {bad}")
        out["cudnn" if cudnn else "native"] = results
    return out


def phase_axes(data_parallel: dict) -> dict:
    print(f"[18] the 'model' and 'space' axes: flagship_bench on a 1x2 "
          f"('data', 'model') and a 1x2 ('data', 'space') mesh, two gloo "
          f"ranks on this one card, vs one rank ({AXIS_TOL}); the dry "
          f"run's flagship dp x tp and dp x sp at four gloo ranks; not a "
          f"multi-card figure")
    t0 = time.perf_counter()
    bench = _axis_bench(
        data_parallel["gloo"]["flagship_bench"]["update_rel_l2"])
    dry = _axis_dryrun()
    _check_tf32_off("phase 18")
    seconds = time.perf_counter() - t0
    print(f"  phase 18: {seconds:.1f} s")
    return {"bench": bench, "dry": dry, "seconds": seconds}


# ---------------------------------------------------------------------------
# [19] the reference's mp4 corpus layout.
# 16 train and 8 test videos of 100 frames: the test block takes 10 + 90.
MP4_ARGS = ("--videos", "16", "--test_videos", "8", "--frames", "100",
            "--seed", "3")
MP4_STEPS = 5


def _mp4_corpus(root: pathlib.Path) -> None:
    """The corpus, written by the port's command as a user runs it."""
    argv = ["-m", "ode_rl_torch.make_mp4_mmnist", "--out", str(root),
            *MP4_ARGS]
    print(f"  python {' '.join(argv)}")
    env = {**os.environ,
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], env=env,
                          capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"make_mp4_mmnist exited {proc.returncode}: "
                             f"{(proc.stdout + proc.stderr)[-2000:]}")
    n = {split: len(list((root / split).glob("video_*.mp4")))
         for split in ("train", "test")}
    if n != {"train": 16, "test": 8}:
        raise AssertionError(f"make_mp4_mmnist wrote {n} videos")
    print(f"  {n['train']} + {n['test']} videos in {seconds:.2f} s")


def _check_mp4_batch(root: pathlib.Path) -> None:
    """The recipe's first training batch, as parse_datasets gives it,
    against one built from read_video_file's decodes of the train split
    in sorted order, cut to the shortest, with the same RandomState
    draws (videos, then window starts)."""
    cfg = load_config(RECIPE, overrides={"data_dir": str(root)})
    loaders = parse_datasets(cfg, torch.device("cuda"))
    if not loaders.get("frozen"):
        raise AssertionError("parse_datasets did not take the mp4 corpus "
                             "as a frozen one")
    batch = next(loaders["train_dataloader"])
    decoded = [read_video_file(p)
               for p in sorted((root / "train").glob("video_*.mp4"))]
    t_min = min(v.shape[0] for v in decoded)
    n_total = cfg.train_in_seq + cfg.train_out_seq
    rng = np.random.RandomState(cfg.get("seed", 0))
    vids = rng.randint(0, len(decoded), cfg.batch_size)
    starts = rng.randint(0, t_min - n_total + 1, cfg.batch_size)
    want = np.stack([decoded[v][s:s + n_total] for v, s in zip(vids, starts)])
    want = torch.from_numpy(want.astype(np.float32)[..., None] / 255.0 - 0.5)
    if batch.device.type != "cuda" or not torch.equal(batch.cpu(), want):
        raise AssertionError("the mp4 loader's first batch differs from "
                             "the decodes sampled by hand")
    print(f"  first batch {tuple(batch.shape)} equal to read_video_file's "
          f"decodes ({len(decoded)} videos of {t_min} frames) sampled with "
          f"the same draws; mean {batch.mean().item():.4f}")


def phase_mp4() -> dict:
    """The recipe through ``ode_rl_torch.main`` on an mp4 corpus that
    ``python -m ode_rl_torch.make_mp4_mmnist`` writes; needs cv2."""
    print(f"[19] the mp4 corpus: make_mp4_mmnist, then {MP4_STEPS} recipe "
          "steps and the test block through ode_rl_torch.main")
    spec = importlib.util.find_spec("cv2")
    if spec is None:
        print("  cv2 is not installed on this host: the mp4 layout is held "
              "on the CPU only (tests/test_torch_port_frozen_mp4.py)")
        return {"counts": None}
    print(f"  cv2 from {spec.origin}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, logs = pathlib.Path(tmp) / "mp4", pathlib.Path(tmp) / "logs"
        _mp4_corpus(root)
        _check_mp4_batch(root)
        argv = ["--configs", *RECIPE, "--data_dir", str(root), "--logdir",
                str(logs), "--steps_per_epoch", str(MP4_STEPS), "--epochs",
                "1", "--loss_log_freq", "1", "--ckpt_save_freq",
                str(MP4_STEPS)]
        print(f"  python -m ode_rl_torch.main {' '.join(argv)}")
        torch.cuda.synchronize()
        common.reset_launches()
        out = port_main.main(argv)
        torch.cuda.synchronize()
        counts = dict(common.launches)
        print(f"  launches over the {MP4_STEPS} steps: {counts}")
        _check_recipe_routes(counts, "mp4 corpus's training run")
        logged = [json.loads(line) for line in
                  (logs / "ODEConv" / "ODEConv_mmnist_train_10_10"
                   / "metrics.jsonl").read_text().splitlines()]
        if (out["final_step"] != MP4_STEPS
                or [m["step"] for m in logged] != list(range(1, MP4_STEPS + 1))
                or not all(np.isfinite(m["loss"])
                           and np.isfinite(m["grad_norm"]) for m in logged)):
            raise AssertionError(f"the mp4 run took {out['final_step']} "
                                 f"steps, logged {logged}")
        print("  losses " + " ".join(f"{m['loss']:.5f}" for m in logged)
              + "; grad_norms " + " ".join(f"{m['grad_norm']:.4f}"
                                           for m in logged))
        argv = ["--configs", *RECIPE_TEST, "--data_dir", str(root),
                "--logdir", str(logs), "--eval_batches", "1"]
        print(f"  python -m ode_rl_torch.main {' '.join(argv)}")
        out = port_main.main(argv)
        run = logs / "ODEConv" / "ODEConv_mmnist_test_10_90"
        per_horizon = json.loads((run / "per_horizon.json").read_text())
        for k in ("mse", "psnr", "ssim"):
            v = per_horizon[k]
            if len(v) != 90 or not np.all(np.isfinite(v)):
                raise AssertionError(f"mp4 per_horizon {k}: {len(v)} values, "
                                     "not 90 finite ones")
        _check_plot(run, per_horizon)
        print(f"  final: mse {out['final_mse']:.6f} psnr "
              f"{out['final_psnr']:.4f} ssim {out['final_ssim']:.4f}")
    _check_tf32_off("phase 19")
    print(f"  phase 19: {time.perf_counter() - t0:.1f} s")
    return {"counts": counts}


# [20] parity init: the ConvGRU twin and the recipe, each from its
# committed JAX init.
PARITY_BLOCKS = ("defaults", "train_mmnist_cgru_len20")
PARITY_DIR = pathlib.Path(__file__).resolve().parent / "results" / "port_parity"
PARITY_STEPS = 20
# K3 and K4 launches a ConvGRU 10 -> 10 step: one each a frame, 10
# encoded and 10 decoded.
PARITY_GRU_A_STEP = 20
# K3 and K4 launches a recipe step: one each an observed frame, in the
# z0 encoder's ConvGRU steps (the decode is the ODE field's K1/K2).
PARITY_RECIPE_GRU_A_STEP = 10
# Step 1's loss against JAX's from the same init and batch: the CPU host
# reads 7.5e-7 relative, the H100 8.8e-7 (tests/test_torch_port_parity_init.py
# holds it to 1e-5, as the port's one-step tests against JAX are held).
PARITY_STEP1_RTOL = 1e-5
# Step 1's grad_norm against JAX's, and the largest loss gap over steps
# 2-20 (the gradient, the Adam update and the loop). The twin: the H100
# read grad_norm gaps of 4.9e-7 to 5.6e-7 and largest loss gaps of
# 2.8e-6 to 7.2e-6 relative, the CPU host loss gaps up to 4.2e-6. The
# recipe, through dopri5 with K1/K2 in the field: the CPU host reads
# 3.3e-7 and 2.1e-5 (a 1e-7 noise run parts from the port by 1.2e-5 over
# the same steps), the H100 6.6e-8 and 1.0e-5.
PARITY_GRAD_RTOL = 1e-4
PARITY_LATER_RTOL = 1e-4


def _parity_steps(name: str, blocks, init: str, first20: str, model: str,
                  corpus: pathlib.Path) -> dict:
    """``init`` through parity_init, then PARITY_STEPS steps of ``blocks``
    through main, each step's loss and NFE beside JAX's in ``first20``;
    the launches over the steps, the loss gaps and step 1's grad_norm
    gap, relative."""
    from ode_rl_torch import parity_init

    print(f"  {name}: {init} through parity_init, then {PARITY_STEPS} "
          "steps through ode_rl_torch.main, each loss beside JAX's")
    jax_logged = [json.loads(line) for line in
                  (PARITY_DIR / first20 / "train_metrics.jsonl")
                  .read_text().splitlines()]
    with tempfile.TemporaryDirectory() as tmp:
        logs = pathlib.Path(tmp) / "logs"
        run = ["--configs", *blocks, "--frozen", "True", "--data_dir",
               str(corpus), "--logdir", str(logs), "--ckpt_id",
               f"parity_{name}_port"]
        argv = ["--params", str(PARITY_DIR / init), *run]
        print(f"  python -m ode_rl_torch.parity_init {' '.join(argv)}")
        parity_init.main(argv)
        argv = [*run, "--steps_per_epoch", str(PARITY_STEPS), "--epochs",
                "1", "--loss_log_freq", "1"]
        print(f"  python -m ode_rl_torch.main {' '.join(argv)}")
        torch.cuda.synchronize()
        common.reset_launches()
        out = port_main.main(argv)
        torch.cuda.synchronize()
        counts = dict(common.launches)
        logged = [json.loads(line) for line in
                  (logs / model / f"{model}_mmnist_train_10_10"
                   / "metrics.jsonl").read_text().splitlines()]
    print(f"  launches over the {PARITY_STEPS} steps: "
          f"{ {k: v for k, v in counts.items() if v} }")
    losses = [m["loss"] for m in logged]
    if (out["final_step"] != PARITY_STEPS
            or [m["step"] for m in logged] != list(range(1, PARITY_STEPS + 1))
            or not np.all(np.isfinite(losses))):
        raise AssertionError(f"the {name} run took {out['final_step']} "
                             f"steps, logged {logged}")
    gaps = [a / b["loss"] - 1 for a, b in zip(losses, jax_logged)]
    for step, (m, j, gap) in enumerate(zip(logged, jax_logged, gaps), 1):
        nfe = (f" nfe {m['nfe']:g} JAX {j['nfe']:g}" if "nfe" in j else "")
        print(f"  step {step:2d}: loss {m['loss']:.8f} JAX {j['loss']:.8f} "
              f"gap {gap:+.3e}{nfe}")
    return {"counts": counts, "gaps": gaps, "logged": logged,
            "jax_logged": jax_logged,
            "grad_norm_gap": logged[0]["grad_norm"]
            / jax_logged[0]["grad_norm"] - 1}


def _check_gru_a_step(counts: dict, a_step: int, where: str) -> None:
    for name in ("gru_gates", "gru_blend"):
        if counts[name] != a_step * PARITY_STEPS:
            raise AssertionError(
                f"{name}: {counts[name]} launches in {PARITY_STEPS} steps "
                f"of the {where}, not {a_step} a step")


def phase_parity_init(corpus: pathlib.Path) -> dict:
    """The committed JAX inits of the ConvGRU twin and of the recipe
    through parity_init, then the first steps of each through main, each
    loss beside JAX's."""
    print(f"[20] parity init: the ConvGRU twin, then the recipe, from "
          f"{PARITY_DIR.name}/'s JAX inits")
    t0 = time.perf_counter()
    twin = _parity_steps("cgru", PARITY_BLOCKS, "convgru_init.npz",
                         "jax_first20", "ConvGRU", corpus)
    _check_recurrent_routes("ConvGRU", twin["counts"], "parity run")
    _check_gru_a_step(twin["counts"], PARITY_GRU_A_STEP, "twin")
    check("parity step 1 loss against JAX's", abs(twin["gaps"][0]),
          PARITY_STEP1_RTOL, "relative")
    check("parity step 1 grad_norm, JAX's", abs(twin["grad_norm_gap"]),
          PARITY_GRAD_RTOL, "relative")
    check(f"parity steps 2-{PARITY_STEPS} loss, JAX's",
          max(abs(g) for g in twin["gaps"][1:]), PARITY_LATER_RTOL,
          "relative")
    twin_s = time.perf_counter() - t0

    recipe = _parity_steps("odecgru", RECIPE, "odecgru_init.npz",
                           "recipe/jax_first20", "ODEConv", corpus)
    _check_recipe_routes(recipe["counts"], "recipe's parity run")
    _check_gru_a_step(recipe["counts"], PARITY_RECIPE_GRU_A_STEP, "recipe")
    nfe = [m["nfe"] for m in recipe["logged"]]
    jax_nfe = [m["nfe"] for m in recipe["jax_logged"]]
    if nfe != jax_nfe:
        first = next(i for i, (a, b) in enumerate(zip(nfe, jax_nfe), 1)
                     if a != b)
        raise AssertionError(f"the recipe's NFE parts from JAX's at step "
                             f"{first}: {nfe} against {jax_nfe}")
    print(f"  recipe NFE equal to JAX's at all {PARITY_STEPS} steps: {nfe}")
    print(f"  recipe K1 / K2 launches a step: "
          f"{recipe['counts']['conv3x3_fwd'] / PARITY_STEPS:g} / "
          f"{recipe['counts']['conv3x3_wgrad'] / PARITY_STEPS:g}")
    check("recipe step 1 loss against JAX's", abs(recipe["gaps"][0]),
          PARITY_STEP1_RTOL, "relative")
    check("recipe step 1 grad_norm, JAX's", abs(recipe["grad_norm_gap"]),
          PARITY_GRAD_RTOL, "relative")
    check(f"recipe steps 2-{PARITY_STEPS} loss, JAX's",
          max(abs(g) for g in recipe["gaps"][1:]), PARITY_LATER_RTOL,
          "relative")
    _check_tf32_off("phase 20")
    seconds = time.perf_counter() - t0
    print(f"  phase 20: {seconds:.1f} s (the twin {twin_s:.1f} s)")
    return {"twin": twin, "recipe": recipe, "seconds": seconds}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = phase_device()
    build_s = phase_build()
    timings = phase_kernels()
    bank = torch.from_numpy(
        get_sprite_bank(FlagshipConfig().data_dir)).float().cuda()
    counts = {k: v for k, v in phase_slice(bank).items()
              if k in (*FLAGSHIP_KERNELS, "conv3x3_fwd_tc",
                       "conv3x3_wgrad_tc", "gru_gates_sample",
                       "gru_blend_sample")}
    phase_reference(bank)
    counts.update({k: v for k, v in phase_flownetc(bank).items()
                   if k in (*FLOWNETC_KERNELS,
                            *(f"{name}_tc" for name in CORR_TC))})
    flownet2 = phase_flownet2(bank)
    counts["channelnorm"] = flownet2["channelnorm"]
    phase_flow_reference(bank)
    recipe = phase_recipe(bank)
    recurrent = phase_recurrent(bank)
    s3vae = phase_s3vae(bank)
    vidode = phase_vidode(bank)
    families13 = phase_families13(bank)
    world_models = phase_world_models(bank)
    flow_users = phase_flow_users(bank)
    # Phase 16 writes the parity corpus; phase 20 trains on it.
    parity_tmp = tempfile.TemporaryDirectory()
    eval_tools = phase_eval_tools(bank, pathlib.Path(parity_tmp.name))
    data_parallel = phase_data_parallel(bank)
    axes = phase_axes(data_parallel)
    mp4 = phase_mp4()
    parity = phase_parity_init(eval_tools["corpus_root"])
    parity_tmp.cleanup()
    print(f"build_s {build_s:.2f}")
    for name in ("conv3x3_fwd", "conv3x3_wgrad"):
        timings[name]["tc_launches"] = counts[f"{name}_tc"]
    for name in ("gru_gates", "gru_blend"):
        timings[name]["sample_launches"] = counts[f"{name}_sample"]
    for name in CORR_TC:
        timings[name]["tc_launches"] = counts[f"{name}_tc"]
    # Phase 9 read the counts around its own run.
    kernel_names = {"conv3x3_fwd": ("conv3x3_fwd_simt",),
                    "conv3x3_wgrad": ("conv3x3_wgrad_simt",
                                      "conv3x3_wgrad_sum"),
                    "gru_gates": ("gru_gates_sample",),
                    "gru_blend": ("gru_blend_sample",)}
    for name, kernels in kernel_names.items():
        timings[name]["recipe_launches"] = recipe["counts"][name]
        timings[name]["recipe_step_launches"] = recipe["reference"][
            "counts"][name]
        timings[name]["recipe_device_us_a_launch"] = {
            k: recipe["reference"]["per_launch"][k][1] for k in kernels
            if k in recipe["reference"]["per_launch"]}
    for name, row in recipe["fp32_convs"].items():
        timings[name]["recipe_fp32"] = row
    # Phase 10 read the counts around each of its runs.
    for name in FLAGSHIP_KERNELS:
        timings[name]["recurrent_launches"] = {
            block: run["counts"][name]
            for block, run in recurrent["train"].items()}
        timings[name]["recurrent_step_launches"] = {
            block: run["counts"][name]
            for block, run in recurrent["reference"].items()}
        timings[name]["defaults_launches"] = recurrent["defaults"]["counts"][
            name]
    # Phase 11 read the counts around each of its runs.
    for name in FLAGSHIP_KERNELS:
        timings[name]["s3vae_launches"] = {
            block: run["counts"][name]
            for block, run in s3vae["train"].items()}
        timings[name]["s3vae_step_launches"] = {
            block: run["counts"][name]
            for block, run in s3vae["reference"].items()}
    for label, row in s3vae["shapes"].items():
        kernel = {"K1": "conv3x3_fwd", "K2": "conv3x3_wgrad",
                  "K3": "gru_gates", "K4": "gru_blend"}[label[:2]]
        timings[kernel].setdefault("s3vae_shapes", {})[label[3:]] = row
    # Phase 12 read the counts around each of its runs.
    for name in FLAGSHIP_KERNELS:
        timings[name]["vidode_launches"] = {
            block: run["counts"][name]
            for block, run in vidode["train"].items()}
        timings[name]["vidode_step_launches"] = {
            block: run["counts"][name]
            for block, run in vidode["reference"].items()}
    for label, row in vidode["shapes"].items():
        kernel = {"K1": "conv3x3_fwd", "K2": "conv3x3_wgrad",
                  "K3": "gru_gates", "K4": "gru_blend"}[label[:2]]
        timings[kernel].setdefault("vidode_shapes", {})[label[3:]] = row
    # Phase 13 read the counts around each of its runs.
    for name in FLAGSHIP_KERNELS:
        timings[name]["phase13_launches"] = {
            block: run["counts"][name]
            for block, run in families13["train"].items()}
        timings[name]["phase13_step_launches"] = {
            "train_mmnist_cs2vae": families13["reference"]["counts"][name]}
    for label, row in families13["shapes"].items():
        kernel = {"K3": "gru_gates", "K4": "gru_blend"}[label[:2]]
        timings[kernel].setdefault("cs2vae_shapes", {})[label[3:]] = row
    # Phase 14 read the counts around the whole phase.
    for name in KERNELS:
        timings[name]["phase14_launches"] = world_models["counts"][name]
    # Phase 15 read the counts around each of its paths.
    for name in KERNELS:
        timings[name]["phase15_launches"] = {
            path: run[name] for path, run in flow_users["counts"].items()}
    for name, rows in flow_users["shapes"].items():
        timings[name]["phase15_shapes"] = rows
    # Phase 16 read the counts around each of its paths.
    for name in KERNELS:
        timings[name]["phase16_launches"] = {
            path: run[name] for path, run in eval_tools["counts"].items()}
    # Phase 17 read the counts around each of its runs, on each rank.
    for name in KERNELS:
        timings[name]["phase17_launches"] = {
            "recipe_one_nccl_rank": data_parallel["recipe"]["launches"][name],
            **{f"{path}_by_rank": [c[name] for c in
                                   data_parallel["gloo"][path]["rank_launches"]]
               for path in ("flagship_bench", "flownetc_bench")}}
    # Phase 18 read the counts around each of its runs, on each rank; the
    # moments-in K3/K4 and their moments pass run on its 'space' path.
    for name in KERNELS:
        timings[name]["phase18_launches"] = {
            f"{path}_by_rank": [c[name] for c in run["rank_launches"]]
            for path, run in axes["bench"].items()}
    # Phase 18's profiled step on rank 0: K1's and K2's launches and
    # device µs a launch, by template instance.
    for name in ("conv3x3_fwd", "conv3x3_wgrad"):
        timings[name]["phase18_rank0_profiled"] = {
            path: {k: v for k, v in run["profile"]["kernels"].items()
                   if k.startswith(name)}
            for path, run in axes["bench"].items()}
    # Phase 19 read the counts around its training run (None without cv2).
    for name in FLAGSHIP_KERNELS:
        timings[name]["phase19_launches"] = (
            None if mp4["counts"] is None else mp4["counts"][name])
    # Phase 20 read the counts around each of its training runs.
    for name in FLAGSHIP_KERNELS:
        timings[name]["phase20_launches"] = parity["twin"]["counts"][name]
        timings[name]["phase20_recipe_launches"] = parity["recipe"][
            "counts"][name]
    for name in AXIS_KERNELS:
        counts[name] = axes["bench"]["flagship_bench_sp"]["rank_launches"][
            0][name]
    counts["conv3x3_fwd_nt32"] = axes["bench"]["flagship_bench_tp"][
        "rank_launches"][0]["conv3x3_fwd_nt32"]
    for path, run in axes["bench"].items():
        print(f"{path}: step_ms {run['step_ms'][0]:.2f} (two gloo ranks on "
              f"one card), one rank {run['single_step_ms'][0]:.2f}")
    for path, ms in flow_users["times"].items():
        print(f"{path}: step_ms {ms:.2f}")
    for block, run in world_models["train"].items():
        prof = world_models["profiles"][block]
        print(f"{block}: step_ms {run['step_ms']:.2f} (median over steps "
              f"2-{WM_STEPS}); a profiled forward and backward from its "
              f"initial weights: device ms {prof['device_ms']:.3f} of "
              f"{prof['wall_ms']:.2f} (busy "
              f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}%)")
    cater = world_models["cater"]
    print(f"train_cater_classifier: step_ms {cater['step_ms']:.2f} (median "
          f"over steps 2-{CATER_STEPS}); a profiled forward and backward: "
          f"device ms {cater['device_ms']:.3f} of {cater['wall_ms']:.2f} "
          f"(busy {100 * cater['device_ms'] / cater['wall_ms']:.1f}%)")
    for block, run in families13["train"].items():
        prof = families13["profiles"].get(block)
        busy = ("" if prof is None else
                f"; a profiled forward and backward from its initial "
                f"weights: device ms {prof['device_ms']:.3f} of "
                f"{prof['wall_ms']:.2f} (busy "
                f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}%)")
        print(f"{block}: step_ms {run['step_ms']:.2f} (median over steps "
              f"2-{run['steps']}){busy}")
    for block, run in vidode["train"].items():
        print(f"{block}: step_ms {run['step_ms']:.2f} (median over steps "
              f"2-{VIDODE_STEPS}), mean nfe {run['mean_nfe']:.2f}")
    for block, ref in vidode["reference"].items():
        print(f"{block}: a forward and backward from its initial weights, "
              f"profiled: device ms {ref['device_ms']:.3f} of "
              f"{ref['wall_ms']:.2f} (busy "
              f"{100 * ref['device_ms'] / ref['wall_ms']:.1f}%) at nfe "
              f"{ref['nfe']}")
    for block, run in s3vae["train"].items():
        nfe = run["mean_nfe"]
        print(f"{block}: step_ms {run['step_ms']:.2f} (median over steps "
              f"2-{S3VAE_STEPS}), mean nfe "
              f"{'-' if nfe is None else f'{nfe:.2f}'}")
    for block, run in recurrent["train"].items():
        nfe = run["mean_nfe"]
        ref = recurrent["reference"][block]
        print(f"{block}: step_ms {run['step_ms']:.2f} (median over steps "
              f"2-{RECURRENT_STEPS}), mean nfe "
              f"{'-' if nfe is None else f'{nfe:.2f}'}; a forward and "
              f"backward from its initial weights, profiled: device ms "
              f"{ref['device_ms']:.3f} of {ref['wall_ms']:.2f} at nfe "
              f"{ref['nfe']}")
    for setting, run in recurrent["hoist"].items():
        print(f"recipe, hoist_projections {setting}: step_ms "
              f"{run['step_ms']:.2f} device ms {run['device_ms']:.3f}")
    print(f"recipe: step_ms {recipe['step_ms']:.2f} (median over steps "
          f"2-{RECIPE_STEPS}), mean nfe {recipe['mean_nfe']:.2f}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": tpu,
         "launches": counts[name], **timings[name]}
        for name, (source, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
