#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. Preflight: find the card (exit non-zero without one), print its name,
   the device count and nvidia-smi's name and power limit.
2. Build the kernels from psgd_torch_tpu_torch/ops/csrc with nvcc (sm_90a)
   and print the -Xptxas -v report (registers, shared memory, spills), the
   tensor-core GEMM's entries one by one.
3. Hold each kernel against its plain PyTorch version on the same inputs at
   the main paths' shapes, and time kernel, plain version and (where one
   PyTorch call computes the same function or its dominant product) that
   call with CUDA events:
   - the noise kernel bit for bit (GPT-2 124M's, GPT-2 774M's (36, 1280,
     5120) bf16, the ViT's (4, 256, 1024) f32 and LLaMA's largest stacks on
     the vector kernel, (3, 97, 33) on the scalar one), its bound the
     larger of its bytes and its instructions (the loop's SASS counted by
     ``ops/sass.py``, the SM clock read under load), both terms
     logged for unit and fused mode, ``torch.rand`` as the library call;
     its complex mode and float64 instantiation bit for bit at
     ``CX_NOISE_CHECKS``, the complex mode timed at (12, 768, 2304)
     complex64 beside ``torch.randn(..., dtype=torch.complex64)``
     (``check_noise_complex``);
   - each instantiation of the transpose-subtract bit for bit, R and R16,
     at (12, 768) f32, (22, 2048) and (22, 2560) bf16 (``check_transpose_sub``),
     timed against its bytes bound; ``procrustes`` also logs its share;
   - the single NS route at GPT-2's widths and batches (12 x 768, 1 x 768
     and 1 x 1024 in bf16, on the tensor cores; 2 x 768 in f32), GPT-2
     774M's (36 x 1280 and 1 x 1280 in bf16), the ViT's (4 x 256, 1 x
     10, 1 x 48 and 1 x 65 in f32 on the FFMA chain, k = 32) (``NS_CHECKS``)
     and the examples' (1 x 6, 16, 30, 33, 84, 120 and 121 in f32, k = 32)
     (``NS_CHECKS_A10B``), within
     ``kernels.ROUTE_TOL`` and, in bf16, within twice the FFMA chain's
     logged error (``kernels.FFMA_SINGLE_REL``); its profiler split at
     12 x 768 fails on any FFMA ``gemm_kernel``;
   - the split route at LLaMA's 2048 and the tiled route at LLaMA's 2560
     in bf16, and both in f32, within the tolerances stated in
     ``check_routes``, each bound at most 1.001 x the true norm, each
     problem taking both branches of the procrustes step (clamped at 1/8,
     and the trace ratio);
   - each piece of the split and tiled routes alone (``check_split`` and
     ``check_tiled``): transpose-subtract and combine bit for bit, the
     products (ns_step's q1 too) to f32 accumulation order, the tiled bound
     within ``kernels.norm_bound_rtol`` of its plain version.  The six rows
     on the tensor-core GEMM in bf16 (``TC_ROWS``) also log their rate, their
     share of the bound, a ``torch.bmm`` yardstick and the GEMM's
     registers, shared memory and spills; the single route, ``ns_step``,
     ``procrustes``, ``norm_bound`` and ``tiled_step`` log their kernels
     one by one (torch.profiler), and all but ``ns_step`` fail if an FFMA
     ``gemm_kernel`` ran or no ``tc_gemm_kernel`` did.
   - the step-matrix variant (the TPU kernels' has_step_mat, which the
     Newton fit launches: S = A - B beside the bound's matrix A + B) of the
     single route at the GPT-2 Newton path's f32 stacks (12, 768), (1, 768)
     and (1, 1024), at (2, 768) f32 and (12, 768) bf16, at the examples'
     KronNewton factors (1, 10) and (1, 33) f32 (k = 32), the split route at
     (22, 2048) bf16 and the tiled route at (22, 2560) bf16, within
     ``kernels.ROUTE_TOL`` of the plain route given the same S
     (``check_step_mat``), each timed with its piece (the single route,
     ``ns_step``, ``tiled_step``) beside the rows above.
   The tiled route and its pieces are also held (and the pieces timed) at
   B = 1 and the widths 2304 and 3072 in bf16, the shapes the shared GPT-2
   stacks of 5b give it, and at (1, 2560) bf16, each LLaMA tp rank's wqkv
   factor (``LLAMA_TP_TILED``); ``norm_bound`` at the shapes the geometries of 9
   give it ((12, 768), (1, 768), (1, 1024) in bf16 and f32), at
   (3, 100) bf16, a width it takes on the FFMA GEMM, and at GPT-2 774M's
   (36, 1280) and (1, 1280) bf16 (``A10A_BOUND_SHAPES``)
   (``check_norm_bound_shapes``); PRO4P's Procrustes loop on the card
   against the CPU's (``check_procrustes_loop``).
4. A tiny GPT-2 trained 3 steps on the card against the CPU's plain path,
   by KronWhiten and by KronNewton, plainly, with each option the port
   takes (share_fit_apply, cache_p, pipelined_fit, shared_layers; Newton
   cache_p, shared_layers) and in each of the six other geometries
   (``dq``; PRO4P's Procrustes loop taking the same steps on both); by
   LRAWhiten and LRANewton; the small tensor-rank problem (n = 24) by
   DenseNewton in each of the seven geometries; the tiny GPT-2 with f64
   Q by KronWhiten and KronNewton (the XLA tail and the f64 noise); a
   tiny complex least squares (``CX_TINY``) by both in complex64 (rtol
   1e-4) and complex128 (1e-9) (``check_complex_small``).
5. GPT-2 124M, batch 4 x 1024, bf16 compute, trained by KronWhiten in the
   bench configuration for 5 steps at update probability 1.0 and 5 at 0.1,
   on one fixed batch; one fit and one no-fit step profiled.
5b. The options path: GPT-2 124M as in 5, three arms, each a fresh model
   and optimizer (``ARM_OPTIONS``): B, pipelined_fit at a literal p = 1.0
   for 6 steps (step 0 fits nothing and launches nothing); C,
   shared_layers (every NS update at B = 1, the tiled route for the 2304
   and 3072 wide factors; ``GPT2_SHARED_PER_FIT``); A, the production
   recipe share_fit_apply with update_preconditioner_first=False and
   cache_p; C and A 3 steps at p = 1.0 and 3 at 0.1.  C's fit step is
   profiled (no FFMA GEMM in it).  A is held against
   its twins from one state (``check_twins``: the unshared fit step
   within a bound derived from the bf16 damping noise carried through P,
   the uncached no-fit step within bf16 rounding, the cache equal to
   Q^T Q in f32); its fit and no-fit steps are profiled and their cuBLAS
   launches logged beside the plain path's.  Each arm logs its Q and
   cache sizes.
6. LLaMA-1.1B (TinyLlama widths, all 22 layers), batch 1 x 1024, bf16
   compute, f32 parameters, trained by KronWhiten in the configuration of
   tools/bench_llama.py for 3 steps at p = 1.0 and 3 at 0.1; one fit step
   profiled.  The GPT-2 state is freed first.
6b. GPT-2 774M (36 x 1280, 20 heads, vocab 50304; 774.1M parameters) at
   full width and depth with remat, batch 1 x 1024, bf16 compute, f32
   parameters, trained by KronWhiten in tools/bench_gpt2_large.py:91-98's
   configuration (the bench one) for 3 steps at p = 1.0 and 3 at 0.1,
   ``GPT2_PER_FIT`` per fit step (the same plan at 1280); one fit step
   profiled.
6c. The ViT path (``vit_path``): examples/vit_cifar10.py's ``main`` on the
   card at the JAX configuration (dim 256, depth 4, 8 heads, batch 128,
   ``vit.synthetic_cifar``: the card has no scikit-learn), Adam and
   KronWhiten, ``VIT_EPOCHS`` x ``VIT_STEPS`` steps each: each arm's epoch
   losses below its first step's, the KronWhiten arm launching
   ``VIT_PER_FIT`` per fit step (row 1 in f32 at (4, 256) and B = 1 at 10,
   48 and 65; 20 dampings).
7. GPT-2 124M, batch 2 x 1024, bf16 compute, f32 Q, trained by KronNewton
   (exact Hvp) in the Newton arm of tools/measure_cache_p_tpu.py:134-140
   for 3 steps at p = 1.0 and 3 at 0.1; one fit and one no-fit step
   profiled; the Hvp pass timed alone.
8. LLaMA-1.1B as in 6, trained by KronNewton in that Newton arm with bf16
   Q (the split and tiled routes), 3 steps at p = 1.0 and 3 at 0.1; one
   fit step profiled; the Hvp pass timed alone.  The exact Hvp's double
   backward runs attention on PyTorch's math backend
   (``optim.hvp.HVP_ATTENTION``), which the log names.
9. The geometries path: GPT-2 124M as in 5, one arm per geometry besides
   Q0.5EQ1.5 (``GEOMETRIES``, a fresh model and optimizer each), KronWhiten
   in the bench configuration with ``dq`` (bf16 Q, f32 for QUAD4P and
   PRO4P), 3 steps at p = 1.0 and 2 at 0.1; each arm's fit step profiled.
10. The Newton geometries path: GPT-2 124M as in 7 (f32 Q, batch 2 x
   1024), one arm per geometry, 2 steps at p = 1.0 and 3 at 0.1.
   Each path fails on a non-finite loss, a last loss not below the first,
   or other launch counts per fit step than ``GPT2_PER_FIT``,
   ``LLAMA_PER_FIT``, their Newton counterparts (the same NS plans, plus
   one probe draw per leaf) and ``GPT2_GEOMETRY_PER_FIT`` and its Newton
   counterpart (no NS kernel; 8 spd bounds; PRO4P 80 skew bounds and 80
   ``tsub``, its loop's masked steps); a Newton path also fails unless
   every NS launch of its route took the step matrix.  Counts are reset just
   before each path and read just after it; the launches made by the
   checks of step 3 count nowhere.  The profiled fit steps of the bf16
   paths fail if they launched any FFMA ``gemm_kernel``: every product
   there belongs on the tensor cores (the f32 Newton GPT-2 path's products
   stay on the FFMA GEMM by the precision rule).
11. The LRA path (``lra_gpt2_path``): GPT-2 124M at its published widths
   with one rank-10 LRA preconditioner (f32) over its whole parameter
   vector (n = 124.5M; U and V 4.98 GB each), by LRAWhiten (the JAX class
   defaults with __graft_entry__.py:164-167's momentum 0.9, lr 1e-3, init
   scale 1; batch 4 x 1024, 3 steps at p = 1 then 3 at 0.1) and by
   LRANewton (lr 1e-3, clip 10, exact Hvp; batch 2 x 1024, 2 + 3 steps),
   each with its peak memory, a profiled fit and no-fit step, and the fit
   step's (n, r) passes at the HBM rate beside its bytes bound.
12. The tensor-rank path (``cp_path``): the reference showcase's rank-10
   CP decomposition of a 20 x 50 x 100 tensor (n = 1700, f32) with the
   example's settings by DenseNewton in the six geometries besides
   Q0.5EQ1.5, 20 steps each; the loss falls on every arm.
13. The Rosenbrock path (``rosenbrock_path``, examples/hello_psgd.py): the
   ``DenseNewton`` closure class on the 100-variable coupled Rosenbrock
   function, f32, 1200 steps; the loss falls by 1e4 or more from 50.
13b. The examples path (``examples_path``, ROADMAP A10b): the five
   examples the port takes from examples/, each ``main`` on the card at
   its published sizes with its steps cut (``EXAMPLE_*``): hello_psgd
   (``dense_newton``, 2000 iterations, f falls by 1e4 or more),
   tensor_rank_decomposition (SGD, L-BFGS, DenseNewton, LRANewton,
   KronNewton, ``CP_STEPS`` each; DenseNewton and KronNewton fall by
   ``CP_FALL`` or more), logistic_regression (SGD, L-BFGS, LRAWhiten over
   331,530 parameters, 2 epochs of 50 steps), flat_minima_mdl (Adam and
   KronWhiten on LeNet5, then the rank-10 LRA log-det fit at each
   solution; both log-dets finite) and xor_rnn (the RNN by KronWhiten,
   the LSTM by KronNewton, capped at ``EXAMPLE_XOR_ITERS``); every PSGD
   arm's loss finite and falling (the XOR cells' last window not above
   chance, and the LSTM's below its first: ``XOR_WINDOW``), exact launches
   per fit step (the Kron arms' from their leaf plans,
   ``_geometry_per_fit``).
13c. The NS-width sweep path (``ns_widths_path``): tools/
   bench_ns_widths_torch.py's ``sweep`` at ``NS_WIDTHS`` (bf16 1536 single,
   4096 tiled, 5120 single above the caps; f32 1280 single, 3072 tiled,
   4096 single above the caps), every route within ``kernels.ROUTE_TOL``
   of its plain version and its bound at most 1.001 x the true norm, each
   width's ms, TFLOP/s, bound and plain ms logged; step 3 holds row 5 and
   the tiled route's pieces at its tiled widths (``NS_WIDTHS_BOUND_SHAPES``:
   (2, 4096) bf16, timed, and (3, 3072) f32).
   Paths 11-13 hold their counts per fit step exactly (``_flat_per_fit``:
   the probes per leaf, one damping, Q0.5EQ1.5's procrustes, PRO4P's
   loop), and step 3 also holds rows 2, 4, 5 and 7 at their shapes
   (``check_lra_dense_shapes``) and step 4 the tiny GPT-2 by LRAWhiten and
   LRANewton and the small tensor-rank problem by DenseNewton in all seven
   geometries, card against CPU.
14. The resumable-training path (``resume_path``): GPT-2 124M at its
   published widths through the ported trainer's PSGD recipe
   (``examples/train_gpt2.py``: bf16 Q and momentum, p from 1.0 to 0.1
   over counts 0-3), batch 4 x 1024 from the committed corpus, 8 steps:
   run A unbroken, checkpointed at step 4 (``utils.save_checkpoint`` into
   OUT_DIR, deleted after the phase); A' the same again; B restored into a
   fresh model and optimizer (``utils.restore_checkpoint``) and trained on
   the same batches, the three under CUDA's deterministic algorithms:
   per parameter |B - A| <= |A' - A|, B's state in its
   saved dtypes, its fit steps exactly ``GPT2_PER_FIT`` and no FFMA GEMM in
   its profiled fit step; a second restored optimizer fed A's recorded
   gradients equal to A bit for bit (parameters, every state tensor, count,
   key, fit_steps).  Then ``utils.FailsafeLoop`` around
   ``utils.make_guarded_step`` on the same model and recipe, snapshots
   every 2 steps, an infinite loss scale at step 5: the loop returns None,
   falls back to step 4 at lr scale 0.5 with the model and the optimizer
   equal to the snapshot bit for bit, and trains 3 more finite steps.
   LLaMA-1.1B as in 6 at p = 1, checkpointed after 3 steps (about 7 GB):
   the optimizer-only continuation bit for bit, the dtypes kept,
   ``LLAMA_PER_FIT`` exact per restored fit step.  The tensor-rank problem
   by each of the five closure classes at p = 0.5, checkpointed at step
   10 of 20: resumed no further from unbroken than two unbroken runs.
   After GPT-2's and LLaMA's unbroken runs ``utils.psgd_metrics`` is
   finite, ``utils.state_memory_report``'s total equals the state tensors'
   bytes and the allocated memory grew by that total within 2 % over the
   optimizer's construction and first step.  Checkpoint bytes, save and
   restore times and the rollback's time are logged; every path's
   ``train`` logs its StepTimer (CUDA events) median beside the host
   clock's.
15. The complex fixed-point path (``complex_fixed_point_path``): the
   reference's verification problem on a stack of 12 complex64 Kronecker
   Hessians on (768, 2304), the Newton fit below 0.30 RMS error, the
   whitening fit below half of P = I's, their trajectories logged; the
   JAX test's complex128 sizes in each geometry (kron_matrix_matrix; the
   8 forms are held on the CPU) below 0.30 at its N = 1500 (14 host-bound
   runs side by side in 7 processes, started before the stack and
   waited for after the resumable-training path, so they run beside 15,
   16 and 14);
   exact counts (one complex damping and two XLA tails per fit step).
16. The complex optimizer path (``complex_optimizer_path``): complex least
   squares over 12 layers of complex64 parameters in GPT-2 124M's
   attention shapes by KronWhiten and KronNewton, 200 steps each: the
   loss falls, exact counts per fit step (the complex noise mode, the XLA
   tail and its starts; no other row), fit and no-fit step times and peak
   memory, a state_dict round trip keeping Q complex64 bit for bit.
17. The distributed paths (ranks: processes on cuda:0 joined by gloo, the
   kernel library built by this process before any starts, kept for the
   next path while the world size stays, so the order is stack (3 ranks),
   pair and trainer (2), factor (2, then 4), vector (4) and tp (4); ranks
   sharing one H100 over gloo, so their times are not scaling figures).
   ``stack_sharded_path``: GPT-2 124M by KronWhiten (as 5), GPT-2 124M by
   KronNewton (as 7) and LLaMA-1.1B by KronWhiten (as 6), 1 step at p =
   1 and 2 at 0.1, on 2 ranks with ``stack_sharding`` beside a 1-rank
   reference, all three stepping from rank 0's gradients: every rank's
   parameters and Q (its layers of the reference's for the sharded
   stacks) equal the reference's bit for bit (SHA-256 per tensor), each
   rank's launches per fit step are the path's (row 1 at B = 6, rows
   3-9 at B = 11) and its stacked Q half the reference's; step 3 holds
   the split and tiled routes at B = 11.  ``pair_paths``: GPT-2 124M on 2
   ranks with distinct 2 x 1024 micro-batches, gradients averaged by
   all_reduce, stack sharding over ``make_mesh``'s fsdp dim, 6 steps:
   ``drift_check`` exactly 0 on every parameter, momentum and replicated
   Q and L; then GPT-2 124M's parameters as DTensors on a 1-D fsdp mesh
   (``gpt2_partition_specs``) by ``per_shard_kron_whiten`` in 5's
   settings: each rank's shards and Q equal the same shards run in one
   process (``on_shards``) bit for bit.  ``factor_sharded_path`` (the
   embeddings' ``factor_sharding``, one global preconditioner over
   sharded dims): A, GPT-2 124M as 5 on a 1-D fsdp mesh of 2 laid out by
   ``sharding_recipe`` (the blocks stack-sharded; wte's 768 dim moved onto
   its vocab dim by ``all_to_all``, wpe's gathered), 3 steps at p = 1 and
   3 at 0.1; B, LLaMA-1.1B's wte and lm_head at full size on 2 ranks by
   KronWhiten and by KronNewton (bf16 Q; the 2048 factor on the split
   route at B = 1), 3 fit steps each; C, GPT-2's wte and wpe on fsdp 2 x
   tp 2 (wte's two axes meet on its vocab dim) in QUAD and QEQ, 3 fit
   steps each.  Each arm beside a 1-rank reference on rank 0 stepping from
   the same gradients: ``drift_check`` exactly 0 on the replicated tensors
   (dense Q, L, the other leaves), ``state_memory_report`` over the mesh
   (each routed block times its shard count) equal to the reference's and
   each rank's momentum less, every routed leaf's update within cosine
   ``FACTOR_COS`` and relative error ``FACTOR_REL`` of the reference's
   (``tools/factor_fault_margin.py`` reads both against planted faults),
   exact launches per fit step
   (``FACTOR_PER_FIT``), A's loss falling and its other leaves the
   reference's bit for bit; step 3 holds the noise at the arms' B = 1
   blocks (``FACTOR_NOISE_SHAPES``) and the split route at B = 1.
   ``vector_sharded_path`` (``vector_sharding``: one LRA or dense
   preconditioner, its rows over the ranks): A, GPT-2 124M by LRAWhiten
   in __graft_entry__.py:164-167's recipe (rank 4, momentum 0.9) on 2
   ranks, 3 fit steps from the reference's gradients; B, by LRANewton
   (rank 4, batch 2 x 1024), 2 fit steps through the closure (rank 0's
   pass broadcast); each beside a 1-rank reference run first on rank 0
   and fed the shards' draws (``_ShardProbes``), its readings kept on the
   host: each step's update and the U, V, d rows within ``VECTOR_COS`` and
   ``VECTOR_REL`` (``vector_fault_margin`` reads both against planted
   faults), ``drift_check`` 0 on the parameters and lu, lv, ld, the
   per-rank state 1/k of the reference's, exact launches per fit
   (``VECTOR_PER_FIT``), each step's collectives the update's all-gather
   (n x 4 bytes) and under ``VECTOR_SMALL_BYTES`` else
   (``utils.collective_bytes``); C, the tensor-rank problem: dense QEQ on
   4 ranks within ``VECTOR_CP_REL`` of a 1-rank run, its loss falling as
   that run's, then dense QEQ and LRANewton on 3 ranks (n_pad 1701),
   their pad rows exact after every step.  Step 3 holds the noise at the
   path's shapes and keys (``check_vector_noise``).  ``sharded_trainer_path``
   (examples/train_gpt2_sharded.py's functions): GPT-2 124M at full width
   and depth, batch 4 x 1024, bf16, on 2 ranks (``make_multihost_mesh``'s
   one-host mesh, the blocks' stacks ``Shard(0)`` by layer through
   ``gpt2.shard_model`` under ``stack_sharding``, the embeddings
   factor-sharded) and on 1, 3 steps with a checkpoint
   after 2, under CUDA's deterministic algorithms: the 2-rank resume bit
   for bit its unbroken run; its checkpoint gathered (``gather_checkpoint``)
   and resumed on 1 rank, and the 1-rank checkpoint cut for 2 ranks, each
   step held against the unbroken run that wrote the checkpoint: every
   parameter but the embeddings bit for bit, their updates within
   ``FACTOR_COS`` and ``FACTOR_REL``; per-rank parameter and state bytes
   about half, ``drift_check`` 0.0, ``GPT2_PER_FIT`` launches of rows 1
   and 2 per fit step.  ``tp_trainer_path`` (ROADMAP A8c; after the
   vector path, in its 4 kept ranks): the same trainer on 4 ranks as
   ``make_mesh(4)``'s (dp 1, fsdp 2, tp 2), JAX's production layout (the
   blocks ``(None, fsdp, tp)`` by ``gpt2.shard_model``, its forward
   tensor-parallel, ``stack_sharding`` over fsdp resharding each rank's 3
   layers, Q replicated over tp; GPT-2 124M's widths at ``TP_LAYERS`` 6 of
   its 12 layers, the cut that pays for the LLaMA path), beside 1 rank: (a) the optimizer alone
   from the same gradients, every non-routed block and Q bit for bit, the
   embeddings within ``FACTOR_COS`` / ``FACTOR_REL``, drift 0.0 over tp;
   (b) 3 steps with a checkpoint after 2, the first loss within
   ``TP_LOSS_REL`` of 1 rank's, the first batch's loss lower after the
   steps, the layout's launches of rows 1 and 2 per fit step exactly,
   parameter and momentum bytes about a quarter of 1 rank's and Q about a
   half; (c) the 4-rank resume bit for bit, the checkpoint gathered and
   resumed on 1 rank within ``TP_COS`` / ``TP_REL`` of the unbroken step,
   limits set against planted faults (``tp_fault_margin``).
   ``llama_tp_path`` (ROADMAP A8c, in the same kept ranks): LLaMA-1.1B at
   its full widths (n_embd 2048, 32 query and 4 kv heads, SwiGLU 5632,
   vocab 32000, untied ``lm_head``), depth cut 22 -> ``LLAMA_TP_LAYERS``
   2, placed by ``llama.shard_model`` over ``llama_partition_specs`` on
   the same mesh, tools/bench_llama.py:108-114's optimizer with
   ``stack_sharding`` over fsdp (each rank's layer resharded, wte and
   lm_head factor-sharded), 1 x 1024 tokens in bf16, beside 1 rank: (a)
   the optimizer alone as above; (b) 3 fit steps on one batch, the first
   loss within ``TP_LOSS_REL`` of 1 rank's and the first step's gradients
   within ``LLAMA_TP_GRAD_COS`` / ``LLAMA_TP_GRAD_REL``, the batch's loss
   lower after the steps, the launches of rows 1-9 per fit step exactly
   as the layout derives them (``_tp_per_fit``: the split route on the
   2048 factors, the tiled one on wqkv's 2560), the bytes a quarter and Q
   about a half, drift 0.0.  The ranks' launch counts come back to this
   process and count toward the kernels' line.
17b. The legacy families path (``legacy_path``, ROADMAP A7, after the
   complex fixed-point runs are waited for and before the distributed
   paths): every legacy family (the dense P, the seven Kron kind pairs,
   newton_inv and newton_tri, UVd's two normalizers and coin branches,
   XMat at even and odd n, SPLU, Affine with and without v on each side
   combination) on the card against the same code on the CPU from the
   same inputs, two updates (the second taking the balances) and an
   apply, in float64 within ``LEGACY_F64_REL`` and float32 within
   ``LEGACY_F32_REL``; the JAX tests' nine convergence cases
   (tests/test_legacy_transforms.py:24-38, 500 steps) each below 1e-3;
   the reference demos at their widths (``legacy_demos``: LeNet5 by
   examples/mnist_lenet5.py's functional Kron step, by Affine whitening
   and by XMat, SPLU and UVd; the 30-unit XOR RNN by Affine and NewtonInv
   Newton); GPT-2 124M by Affine whitening at bench.py's operating point
   (``legacy_gpt2``: each leaf's plan, the step, the peak memory).  Fails
   on a non-finite loss, and if it launched any of the nine kernels.
18. Prints the kernels' JSON line (``launches`` is the sum over the
   paths; row 5 also carries ``geometry_shapes``, its times at 3's
   geometry shapes; rows 1, 2 and 5 carry ``a10a_shapes``, their times at
   GPT-2 774M's and the ViT's shapes; row 1 carries ``a10b_shapes`` and
   ``step_mat_a10b_shapes``, its times at the examples' factors, and
   ``ns_widths``, the sweep's single-route records; the split and tiled
   rows carry ``ns_widths_route``, the sweep's records of their route, its
   whole time (``route_ms``), and rows 5-9 ``ns_widths_shapes`` and
   ``a8c_llama_tp_shapes`` (the LLaMA tp ranks' (1, 2560) bf16); rows 2,
   4, 5 and 7 carry ``lra_dense_shapes``, their
   times at the LRA and dense paths' shapes, row 2 ``vector_shapes`` at
   the vector-sharded path's; rows 1, 3 and 6 also carry
   ``step_mat_launches`` and the step
   matrix variant's ``step_mat_ms`` and ``step_mat_bound_ms`` at the
   ``step_mat_shape`` its Newton path gives it: (12, 768) f32, (22, 2048)
   and (22, 2560) bf16; row 2 also carries its complex mode's
   ``complex_launches`` (fused; ``complex_unit_launches`` unit) and its
   ``complex_*`` times and bound at (12, 768, 2304) complex64; the run
   fails if a row's count is 0 or the complex mode's is), the card's name
   and power limit, then the fixed last line.

Any failed phase raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import functools
import gc
import hashlib
import json
import math
import multiprocessing
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
import zlib
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from psgd_torch_tpu_torch.examples import (affine_wrapped_layers, flat_minima_mdl, hello_psgd,
                                           logistic_regression, mnist_lenet5,
                                           tensor_rank_decomposition, train_gpt2,
                                           vit_cifar10, xor_rnn)
from psgd_torch_tpu_torch.models import gpt2, lenet5, llama, rnn, vit
from psgd_torch_tpu_torch.ops import fastrand, kernels, linalg, sass
from psgd_torch_tpu_torch.ops.linalg import width_norm_k
from psgd_torch_tpu_torch.optim import (DenseNewton, KronNewton, KronWhiten,
                                        LRANewton, LRAWhiten, classes, hvp)
from psgd_torch_tpu_torch.optim import legacy_transforms as legacy_optim
from psgd_torch_tpu_torch.optim import transforms as _transforms
from psgd_torch_tpu_torch.precond import affine as affine_p
from psgd_torch_tpu_torch.precond import dense as dense_p
from psgd_torch_tpu_torch.precond import kron as kron_p
from psgd_torch_tpu_torch.precond import legacy as legacy_p
from psgd_torch_tpu_torch.precond import lra as lra_p
from psgd_torch_tpu_torch.precond import splu as splu_p
from psgd_torch_tpu_torch.precond import xmat as xmat_p
from psgd_torch_tpu_torch.utils import (FailsafeLoop, StepTimer, collective_bytes,
                                        count_collectives, make_guarded_step,
                                        psgd_metrics, restore_checkpoint,
                                        save_checkpoint, state_memory_report)

_OWN_PASS = _transforms._newton_pass

# H100 SXM published peaks (dense): bf16 tensor cores, float32 without
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# kernel launches per fit step on each path
GPT2_PER_FIT = {"fused_ns_update": 8, "damped_noise": 16}
LLAMA_PER_FIT = {"ns_step": 7, "procrustes": 7, "norm_bound": 2,
                 "tiled_step": 1, "tsub": 1, "scaled_matmul_trace": 2,
                 "combine": 1, "fused_ns_update": 0, "damped_noise": 9}
# the Newton fit: the same NS plans and damping (on h), plus the probe v,
# one unit-noise draw per leaf (GPT-2 16 leaves, LLaMA 9)
GPT2_NEWTON_PER_FIT = dict(GPT2_PER_FIT, unit_noise=16)
LLAMA_NEWTON_PER_FIT = dict(LLAMA_PER_FIT, unit_noise=9)
# GPT-2 124M with shared_layers (max_skew 2): every stack is one tensor, so
# every NS update runs at B = 1; the eight dense factors 768 and 1024 wide
# take the single route, the three 2304 and 3072 wide (qkv, fc, proj) the
# tiled one (two bounds and two scaled products each)
SHARED_TILED_WIDTHS = (2304, 3072)
GPT2_SHARED_PER_FIT = {"fused_ns_update": 8, "damped_noise": 16, "norm_bound": 6,
                       "tiled_step": 3, "tsub": 3, "scaled_matmul_trace": 6,
                       "combine": 3, "ns_step": 0, "procrustes": 0}
# GPT-2 774M (max_skew 2) makes GPT-2 124M's plan at 1280: its five dense
# stacks at (36, 1280), wpe's 1024 and 1280 and wte's 1280 at B = 1, and
# 16 leaves damped: GPT2_PER_FIT.  The ViT (dim 256, depth 4) by the
# example's KronWhiten: its five dense stacks at (4, 256) and head_w's 10,
# patch_w's 48 and pos_emb's 65 at B = 1, f32 on the single route, and 20
# leaves damped; no other kernel
VIT_PER_FIT = {"fused_ns_update": 8, "damped_noise": 20, "unit_noise": 0,
               "ns_step": 0, "procrustes": 0, "norm_bound": 0, "tiled_step": 0,
               "tsub": 0, "scaled_matmul_trace": 0, "combine": 0}
VIT_EPOCHS = 2
VIT_STEPS = 100
# the six geometries besides Q0.5EQ1.5 on GPT-2 124M (max_skew 2): per fit
# step each of the 8 dense factors is bounded once by norm_bound (spd) and
# every leaf damped by damped_noise (16), but EQ whitening, which draws its
# probe by unit_noise instead; the Newton fit adds the probe v (unit_noise,
# 16) and damps h (EQ too).  PRO4P's Procrustes loop runs LOOP3_STEPS masked
# steps per dense factor, a tsub and a skew norm_bound each.  No NS kernel.
GEOMETRIES = ("EQ", "QEP", "QEQ", "QUAD", "QUAD4P", "PRO4P")
LOOP3_STEPS = 10
GPT2_DENSE = 8
GPT2_LEAVES = 16


def _geometry_per_fit(dq: str, newton: bool, dense: int = GPT2_DENSE,
                      leaves: int = GPT2_LEAVES) -> dict:
    """Launches per fit step of a Kron optimizer in geometry ``dq`` over
    ``leaves`` unstacked leaves with ``dense`` dense factors (GPT-2 124M's
    by default).  Q0.5EQ1.5 (the examples' Kron arms, every dense factor
    under 128 wide) runs one NS update per dense factor, on the single
    route, and no other bound."""
    loop = dense * LOOP3_STEPS if dq == "PRO4P" else 0
    probe = newton or dq == "EQ"
    ns = dq == "Q0.5EQ1.5"
    return {"fused_ns_update": dense if ns else 0, "ns_step": 0, "procrustes": 0,
            "tiled_step": 0, "scaled_matmul_trace": 0, "combine": 0, "tsub": loop,
            "norm_bound": 0 if ns else dense + loop,
            "damped_noise": leaves if newton or dq != "EQ" else 0,
            "unit_noise": leaves if probe else 0}


GPT2_GEOMETRY_PER_FIT = {dq: _geometry_per_fit(dq, False) for dq in GEOMETRIES}
GPT2_NEWTON_GEOMETRY_PER_FIT = {dq: _geometry_per_fit(dq, True) for dq in GEOMETRIES}
# Q's dtype per whitening arm: the fit-P geometries in f32, as the JAX
# package's advisory recommends
GEOMETRY_QDTYPE = {dq: torch.float32 if dq in ("QUAD4P", "PRO4P") else torch.bfloat16
                   for dq in GEOMETRIES}
# the LRA and dense paths: one preconditioner over the whole parameter
# vector, no NS kernel.  Per fit step LRAWhiten draws its probe
# (unit_noise) and damps the gradient (damped_noise) from one key;
# LRANewton and DenseNewton draw one probe per parameter leaf
# (hvp.rand_like: GPT-2's 16, the tensor-rank problem's 3, Rosenbrock's 1)
# and damp h once; DenseNewton's Q0.5EQ1.5 adds one procrustes on the
# (1, n, n) stack and PRO4P its Procrustes loop's LOOP3_STEPS masked steps
# (a tsub and a skew norm_bound each)
CP_LEAVES = 3
LRA_RANK = 10


def _flat_per_fit(probes: int, dq: str | None = None) -> dict:
    loop = LOOP3_STEPS if dq == "PRO4P" else 0
    return {"fused_ns_update": 0, "ns_step": 0, "tiled_step": 0,
            "scaled_matmul_trace": 0, "combine": 0, "unit_noise": probes,
            "damped_noise": 1, "procrustes": int(dq == "Q0.5EQ1.5"),
            "tsub": loop, "norm_bound": loop}


LRA_WHITEN_PER_FIT = _flat_per_fit(1)
# an LRA state's construction (``lra.init_lra``): U and V, a unit-noise
# launch each
LRA_INIT = {"unit_noise": 2}
GPT2_LRA_NEWTON_PER_FIT = _flat_per_fit(GPT2_LEAVES)
# (n, r) passes of one LRA fit, counted from precond/lra.py update_lra
# (rank > 0): the balancing 6 (the two Gram products, each rotation read
# and written), Q h and P h 4, I + V^T U 2, the LU solves' four products
# 4, then the U step 6 (a^T V, b^T V, V atv^T, V btv^T, U read and
# written) or the V step 8 (four products with U, two with V, V read and
# written); the apply (precond_grad) 4
LRA_FIT_PASSES = (22, 24)
LRA_APPLY_PASSES = 4
# the tensor-rank decomposition of examples/tensor_rank_decomposition.py
# (R, (I, J, K)): n = R (I + J + K) = 1700, its arms' steps, and the small
# problem the card is held against the CPU on
CP_FULL = (10, (20, 50, 100))
CP_SMALL = (2, (3, 4, 5))
CP_STEPS = 200
CP_GEOMETRY_STEPS = 20
# Q0.5EQ1.5's least fall over CP_STEPS: the JAX package's dense_newton
# brings the example's own problem down 3.0x in its first 200 steps and
# 8.6x in 400 on the CPU (tools/cp_fall_jax.py), so a 10x fall in 200
# steps is not what the reference does
CP_FALL = 2.0
ROSENBROCK_N = 100
ROSENBROCK_STEPS = 2000
# the closure class's run (``rosenbrock_path``; hello_psgd's own 2000 run
# in ``examples_path``): f falls 5e5x in 1200 steps on an H100
ROSENBROCK_CLASS_STEPS = 1200
ROSENBROCK_FALL = 1e4
# the five examples on the card (``examples_path``), at their published
# sizes, their steps cut to keep the smoke's time: logistic regression's
# epochs (of 20), flat minima's training and log-det fit steps (of 400 and
# 300), the XOR cells' iterations (of 100000; each stops at a loss below
# 0.1).  On an H100 the RNN step takes ~15 ms and the LSTM's, a double
# backward through 50 steps, ~104-118 ms; neither cell was solved within
# 6000 and 3000 iterations (PERF.md §6).  In its first
# hundreds of iterations each cell sits at chance (ln 2), the JAX
# example's too (tools/xor_fall_jax.py): every loss finite, the mean of the
# last XOR_WINDOW below ln 2 + XOR_CHANCE_MARGIN, and the LSTM's below
# that of its first XOR_WINDOW (the offset of its initial output fitted
# away; so in every later window of the JAX example's first 1000
# iterations on the CPU).  The RNN's window means cross (the JAX example's
# later windows are below its first in 93% of them), so no fall is gated
# there
EXAMPLE_LOGISTIC_EPOCHS = 2
EXAMPLE_MDL_STEPS = (100, 100)
EXAMPLE_XOR_ITERS = {"rnn": 100, "lstm": 100}
XOR_WINDOW = 50
XOR_CHANCE_MARGIN = 0.01
XOR_FALLS = ("lstm",)
# their Kron arms' launches per fit step, from the leaf plans (dims of
# size^2 > max_skew x numel diagonal; max_size inf), every dense factor f32
# and under 128 wide, so on the single route at B = 1:
# - KronNewton over the CP factors (10, 20), (10, 50), (10, 100), max_skew
#   1: the 10 dense in each, the other dim diagonal; 3 probes, 3 dampings
# - KronWhiten over LeNet5's [W; b] (26, 6), (151, 16), (401, 120),
#   (121, 84), (85, 10), max_skew 2: dense 6, 16, 120, 121 and 84, 10
# - the RNN's w1 (33, 30) (30 dense) and w2 (31, 1) (diagonal), max_skew 1
# - the LSTM's w_gates (33, 120) (33 dense) and w_out (31, 1) (diagonal)
# (every NS launch of a Newton arm takes the step matrix, none of a
# whitening arm's)


def _example_kron_per_fit(newton: bool, dense: int, leaves: int) -> dict:
    return dict(_geometry_per_fit("Q0.5EQ1.5", newton, dense, leaves),
                **{"fused_ns_update.step_mat": dense if newton else 0})


CP_KRON_PER_FIT = _example_kron_per_fit(True, dense=3, leaves=CP_LEAVES)
MDL_KRON_PER_FIT = _example_kron_per_fit(False, dense=6, leaves=5)
XOR_PER_FIT = {"rnn": _example_kron_per_fit(False, dense=1, leaves=2),
               "lstm": _example_kron_per_fit(True, dense=1, leaves=2)}
# the NS-width sweep (``ns_widths_path``): the widths and routes no other
# path holds on the card; above the caps (bf16 5120, f32 4096) the single
# route, where the JAX package runs its XLA tail
NS_WIDTHS = {torch.bfloat16: (1536, 4096, 5120), torch.float32: (1280, 3072, 4096)}
# the options path's arms: options over the bench configuration
ARM_OPTIONS = {
    # the production recipe (__graft_entry__.py:69-79) with the cache
    "A": dict(share_fit_apply=True, update_preconditioner_first=False,
              cache_p=True),
    "B": dict(pipelined_fit=True, preconditioner_update_probability=1.0),
    "C": dict(shared_layers=True),
}
# bf16: the damping's eps(dtype) and the unit roundoff
EPS_BF16 = 2.0 ** -7
U_BF16 = 2.0 ** -8
# the largest relative difference a twin gate allows (the bound of the JAX
# package's test_shared_noise_bounded_in_bf16)
TWIN_CAP = 0.05
# the JSON line's rows: wrapper, source, the TPU kernel it replaces
SRC = "psgd_torch_tpu_torch/ops/csrc/"
TPU = "psgd_torch_tpu/ops/pallas_kernels.py:"
ROWS = (("fused_ns_update", "ns_update.cu", 142),
        ("damped_noise", "noise.cu", 626),
        ("ns_step", "ns_update.cu", 221),
        ("procrustes", "ns_update.cu", 255),
        ("norm_bound", "ns_tiled.cu", 369),
        ("tiled_step", "ns_tiled.cu", 427),
        ("tsub", "ns_tiled.cu", 436),
        ("scaled_matmul_trace", "ns_tiled.cu", 441),
        ("combine", "ns_tiled.cu", 457))
# the rows that take the step matrix (kernels.STEP_MAT_KERNELS)
STEP_MAT_ROWS = ("fused_ns_update", "ns_step", "tiled_step")
# the rows whose bf16 products run on the tensor-core GEMM (ns_gemm_sm90.cuh)
TC_ROWS = ("fused_ns_update", "ns_step", "procrustes", "norm_bound", "tiled_step",
           "scaled_matmul_trace")
# its epilogues by template argument (ns_common.cuh's Epilogue)
TC_EPILOGUES = {"0": "kDiv", "1": "kStep", "2": "kDivTrace", "3": "kMulTrace"}
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"  # git-ignored
# the resumable-training path: GPT-2 124M through the ported trainer's
# recipe for RESUME_STEPS steps on the corpus, checkpointed at RESUME_AT;
# the optimizer's key is seed 1, whose gate under the recipe's schedule (p
# from 1.0 to 0.1 over counts 0-3) fits at counts 0, 2 and 4: fit and
# no-fit steps on both sides of the checkpoint (seed 0's fits 0-3 only)
RESUME_STEPS = 8
RESUME_AT = 4
RESUME_SEED = 1
RESUME_BATCH = 4
# LLaMA-1.1B: steps before and after its checkpoint, at p = 1
LLAMA_RESUME = (3, 3)
# the five optimizers on the tensor-rank problem through their classes:
# steps before and after the checkpoint, a gated schedule p = 0.5
CP_RESUME = (10, 10)
CP_RESUME_P = 0.5
# the failsafe loop on GPT-2 124M: snapshots every 2 steps, the gradient
# poisoned (an infinite loss scale) on the step after step 5
FAILSAFE_EVERY = 2
FAILSAFE_POISON = 5
FAILSAFE_AFTER = 3
# how far the growth of allocated memory over an optimizer's first step
# may stray from its state's bytes (the allocator rounds each block)
MEMORY_SLACK = 0.02
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"== {name} (t = {time.perf_counter() - T0:.1f} s)")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn in ms, from CUDA events around iters calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time for the work: max(operations / peak, bytes / HBM)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def preflight() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}  count: {torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, smi


def ptxas_entries(report: str) -> dict:
    """Registers, static shared memory and spill stores of each kernel entry
    in nvcc's -Xptxas -v report, keyed by its (mangled) name."""
    entries, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            entries[name] = {"registers": 0, "smem": 0, "spill": 0}
            continue
        if name is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores", line):
            entries[name]["spill"] = int(m.group(1))
        if m := re.search(r"Used (\d+) registers", line):
            entries[name]["registers"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                entries[name]["smem"] = int(s.group(1))
    return entries


# the redesigned bytes-bound kernels' template arguments in mangled names:
# noise_kernel<T, kFused, kOct> and transpose_sub_kernel<TI, TO, V>
_MANGLED_T = r"(f|13__nv_bfloat16)"
_REDESIGNED = (
    (rf"noise_kernelI{_MANGLED_T}Lb([01])ELb([01])E",
     lambda m: f"noise_kernel<{_ctype(m[1])}, {'fused' if m[2] == '1' else 'unit'}, "
               f"{'vector' if m[3] == '1' else 'scalar'}>"),
    (rf"transpose_sub_kernelI{_MANGLED_T}{_MANGLED_T}Li(\d+)E",
     lambda m: f"transpose_sub_kernel<{_ctype(m[1])}, {_ctype(m[2])}, V = {m[3]}>"))


def _ctype(mangled: str) -> str:
    return "float" if mangled == "f" else "bf16"


def build() -> tuple[Path, list[str]]:
    """Build and bind the kernels; summarize nvcc's -Xptxas -v report
    (the whole report goes to OUT_DIR/chip_smoke_ptxas.txt) and log the
    noise and transpose-subtract kernels' registers, shared memory and
    spills.  Returns the library's path and the tensor-core GEMM's lines
    (registers, shared memory, spills), which its rows log again."""
    t0 = time.perf_counter()
    path, report = kernels.build()
    lib = kernels.library()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    if not report:
        return path, []
    dyn, tc_lines, seen = lib.psgd_tc_gemm_smem_bytes(), [], set()
    for name, e in ptxas_entries(report).items():
        for pattern, show in _REDESIGNED:
            if (m := re.search(pattern, name)) and show(m) not in seen:
                seen.add(show(m))
                log(f"  ptxas: {show(m)}: {e['registers']} registers, {e['smem']} "
                    f"bytes static shared memory, {e['spill']} bytes spill stores")
        if "tc_gemm_kernel" not in name:
            continue
        # tc_gemm_kernel<epilogue, C type>: ILi<epilogue>E then f or bf16
        m = re.search(r"tc_gemm_kernelILi(\d+)E(f|13__nv_bfloat16)", name)
        epi = TC_EPILOGUES.get(m.group(1), "?") if m else "?"
        ctype = ("float" if m.group(2) == "f" else "bf16") if m else "?"
        line = (f"tc_gemm_kernel<{epi}, {ctype}>: {e['registers']} registers, "
                f"{e['smem']} bytes static + {dyn} bytes dynamic shared memory, "
                f"{e['spill']} bytes spill stores")
        if line not in tc_lines:   # each unit that launches it builds its own
            tc_lines.append(line)
            log(f"  ptxas: {line}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_ptxas.txt").write_text(report)
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", report))
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", report)]
    log(f"  ptxas: {len(regs)} kernels, registers max {max(regs, default=0)}, "
        f"static shared memory max {max(smem, default=0)} bytes, spill stores "
        f"{spills} bytes in all")
    for line in report.splitlines():
        if "error" in line.lower() or "warning" in line.lower():
            log(f"  {line.strip()}")
    return path, tc_lines


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _seeds(b, gen, dev):
    return torch.randint(-2**31, 2**31 - 1, (b, 2), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _noise_loops(lib_path: str) -> dict:
    """``sass.noise_loops`` of the built library, read once (cuobjdump)."""
    return sass.noise_loops(lib_path)


def sm_clock_hz(fn, launches: int = 300) -> float:
    """The SM clock nvidia-smi reports while the card runs ``launches``
    calls of fn (queued before the query, waited for after it)."""
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(mhz.split()[0]) * 1e6


def instruction_ms(numel: int, counts: dict, clock_hz: float) -> float:
    """The least time to issue a kernel's loop over numel elements: its
    instructions per element (``ops/sass.py``), one warp-instruction
    per 32 elements, 4 issued per SM per clock; IMAD.WIDE and IMAD.HI run on
    the half-rate pipe, so they alone take two issue slots each."""
    slots = max(counts["per_element"], 2 * counts["imad_per_element"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return numel * slots / 32 / (4 * sms * clock_hz) * 1e3


# the noise at GPT-2 774M's and the ViT's largest stacks (timed; the row
# stays LLaMA's)
NOISE_A10A = (((36, 1280, 5120), torch.bfloat16), ((4, 256, 1024), torch.float32))


def check_noise(dev, lib_path) -> dict:
    """Noise kernel, unit and fused mode, bit-exact against plain, at GPT-2
    124M's, GPT-2 774M's, the ViT's and LLaMA-1.1B's largest stacks and at
    (3, 97, 33), whose length (not a multiple of 8) takes the scalar
    kernel; the row is LLaMA's, ``a10a_shapes`` the 774M's and the ViT's.  The
    bound is max(bytes / HBM rate, instructions / issue rate), the loop's
    SASS counted by ``ops/sass.py`` and the SM clock read under
    load; both terms are logged for both modes."""
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_noise_sass.txt", "w") as fh:
        for name, lines in sass.functions(str(lib_path)).items():
            if "noise_kernel" in name:
                fh.write(f"Function : {name}\n" + "\n".join(lines) + "\n")
    loops = _noise_loops(str(lib_path))
    for (dtype, fused, vec), c in sorted(loops.items(), key=str):
        log(f"noise_kernel<{dtype}, {'fused' if fused else 'unit'}, "
            f"{'vector' if vec else 'scalar'}> main loop: {c['instructions']} "
            f"instructions, {c['imad_wide_hi']} IMAD.WIDE/HI per {c['elements']:g} "
            f"elements: {c['per_element']:.2f} and {c['imad_per_element']:.2f} per element")
    row, a10a = None, []
    gen = torch.Generator(device=dev).manual_seed(7)
    for shape, dtype in (((3, 97, 33), torch.float32),
                         ((3, 97, 33), torch.bfloat16),
                         ((12, 768, 2304), torch.bfloat16),
                         ((1, 1024, 768), torch.float32),
                         *((s, torch.bfloat16) for s in FACTOR_NOISE_SHAPES),
                         *NOISE_A10A,
                         ((22, 2048, 11264), torch.bfloat16)):
        b = shape[0]
        seeds = _seeds(b, gen, dev)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        unit_k = kernels.unit_noise(seeds, shape[1:], dtype)
        unit_p = kernels.unit_noise_plain(seeds, shape[1:], dtype)
        damp_k = kernels.damped_noise(g, seeds, 1e-9)
        damp_p = kernels.damped_noise_plain(g, seeds, 1e-9)
        torch.cuda.synchronize()
        for what, k, p in (("unit", unit_k, unit_p), ("fused", damp_k, damp_p)):
            if not torch.equal(_bits(k), _bits(p)):
                bad = int((_bits(k) != _bits(p)).sum())
                raise AssertionError(f"noise {what} {shape} {dtype}: {bad} "
                                     "elements differ from the plain version")
        fused_err = _max_abs(damp_k, damp_p)
        u = unit_k.float()
        numel, size = math.prod(shape), torch.finfo(dtype).bits // 8
        vec = numel // b % 8 == 0
        log(f"noise {shape} {dtype} ({'vector' if vec else 'scalar'} kernel): unit "
            f"and fused bit-exact; unit mean {u.mean().item():.2e} var "
            f"{u.var().item():.4f} range [{u.min().item():.4f}, {u.max().item():.4f}]")
        del unit_k, unit_p, damp_k, damp_p, u
        if not vec or shape in FACTOR_NOISE_SHAPES:
            continue
        unit = lambda: kernels.unit_noise(seeds, shape[1:], dtype)
        fused = lambda: kernels.damped_noise(g, seeds, 1e-9)
        ms_unit = cuda_ms(unit, 20)
        ms_fused = cuda_ms(fused, 20)
        ms_rand = cuda_ms(lambda: torch.rand(shape, dtype=dtype, device=dev), 20)
        ms_plain_unit = cuda_ms(
            lambda: kernels.unit_noise_plain(seeds, shape[1:], dtype), 2, 1)
        ms_plain_fused = cuda_ms(
            lambda: kernels.damped_noise_plain(g, seeds, 1e-9), 2, 1)
        clock = sm_clock_hz(fused, max(300, int(500 / ms_fused)))   # ~0.5 s busy
        terms = {}
        for mode, nbytes in (("unit", numel * size), ("fused", 2 * numel * size)):
            counts = loops[(str(dtype).removeprefix("torch."), mode == "fused", vec)]
            terms[mode] = (nbytes / PEAK_BYTES * 1e3,
                           instruction_ms(numel, counts, clock))
        for mode, ms, extra in (("unit", ms_unit, f"  torch.rand {ms_rand:.4f} ms"),
                                ("fused", ms_fused, "")):
            t_bytes, t_instr = terms[mode]
            log(f"  {mode:5s} kernel {ms:.4f} ms  plain "
                f"{ms_plain_unit if mode == 'unit' else ms_plain_fused:.3f} ms{extra}  "
                f"bound {max(t_bytes, t_instr):.4f} ms: bytes {t_bytes:.4f} ms, "
                f"instructions {t_instr:.4f} ms (SM clock under load "
                f"{clock / 1e6:.0f} MHz); {max(t_bytes, t_instr) / ms:.3f} of the bound")
        t_bytes, t_instr = terms["fused"]
        timed = dict(ms=ms_fused, plain_ms=ms_plain_fused, bound_ms=max(t_bytes, t_instr),
                     bound_by="bytes" if t_bytes >= t_instr else "operations",
                     max_abs_err=fused_err, library_ms=ms_rand,
                     bound_terms_ms={"bytes": t_bytes, "instructions": t_instr},
                     unit_ms=ms_unit, unit_bound_terms_ms=dict(zip(
                         ("bytes", "instructions"), terms["unit"])))
        if (shape, dtype) in NOISE_A10A:
            a10a.append(dict(shape=f"{shape} {str(dtype)[6:]}", **timed))
        else:
            row = timed
        del g
        torch.cuda.empty_cache()
    row["a10a_shapes"] = a10a
    return row


def _ns_problem(b, n, dtype, seed, dev):
    """A whitening-like NS input: term1 = X X^T / m (m = 3n), Q = I + noise,
    L = 0, term2 = 1.  The noise is 1e-2 on even batch entries and 1e-3 on
    odd ones: the procrustes step a, about the norm of Q's skew part, is
    then clamped at 1/8 on the first and the trace ratio on the second."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n, 3 * n), generator=gen, device=dev)
    term1 = (x @ x.mT / (3 * n)).to(dtype)
    del x
    noise = torch.tensor([1e-2, 1e-3], device=dev).repeat(b)[:b, None, None]
    q = (torch.eye(n, device=dev) + noise * torch.randn(
        (b, n, n), generator=gen, device=dev)).to(dtype)
    return (term1, q, torch.zeros(b, device=dev),
            torch.full((b,), 1.0, device=dev), _seeds(b, gen, dev))


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _step_a(q1, seeds):
    """The procrustes step a of q1 from the plain pieces in f32: the step
    the split and tiled routes take, up to their storage points."""
    f = q1.float()
    r = kernels.tsub_plain(f)
    inv = 1.0 / (kernels.norm_bound_plain(r, seeds, "skh", kernels.SKH_TAG,
                                          k=128) + torch.finfo(f.dtype).tiny)
    rq, tr = kernels.scaled_matmul_trace_plain(r, f, inv)
    _, tr2 = kernels.scaled_matmul_trace_plain(r, rq, inv)
    return kernels.step_size(tr, tr2)


def _branches(a) -> tuple[str, bool]:
    """a for logging, and whether both branches of the step were taken
    (some a clamped at 1/8, some a trace ratio below it)."""
    shown = [round(x, 5) for x in a.tolist()[:4]]
    return f"a = {shown}...", bool((a == 0.125).any() and (a < 0.125).any())


def _true_norm(mat, mode):
    """Spectral norm of each matrix: the top eigenvalue (spd), or the root
    of the top eigenvalue of R^T R (skew)."""
    m = mat.float()
    if mode == "spd":
        return torch.linalg.eigvalsh(m)[:, -1]
    return torch.linalg.eigvalsh(m.mT @ m)[:, -1].clamp(min=0).sqrt()


# (B, n, dtype, k) of the single route's checks: GPT-2 124M's stacks, wte
# and wpe in bf16 and an f32 stack; GPT-2 774M's stacks and B = 1 factors
# in bf16 (k = 128, the paths' norm_k); the ViT's stacks and its head_w,
# patch_w and pos_emb factors in f32 on the FFMA chain (k = 32, the
# example's default norm_k for f32 Q)
NS_CHECKS = ((12, 768, torch.bfloat16, 128), (1, 768, torch.bfloat16, 128),
             (1, 1024, torch.bfloat16, 128), (2, 768, torch.float32, 128),
             (36, 1280, torch.bfloat16, 128), (1, 1280, torch.bfloat16, 128),
             (4, 256, torch.float32, 32), (1, 10, torch.float32, 32),
             (1, 48, torch.float32, 32), (1, 65, torch.float32, 32))
# the checks whose times the kernels' line carries beside the row's
NS_LINE_SHAPES = NS_CHECKS[4:]
# the examples' f32 factors at B = 1 on the FFMA chain (k = 32, KronWhiten's
# and KronNewton's norm_k): LeNet5's 6, 16, 84, 120 and 121 (flat minima),
# the RNN's 30 and the LSTM's 33 (``examples_path``; 10 is in NS_CHECKS)
NS_CHECKS_A10B = tuple((1, n, torch.float32, 32) for n in (6, 16, 30, 33, 84, 120, 121))


def check_ns(dev, tc_lines=(), checks=NS_CHECKS,
             line_shapes=NS_LINE_SHAPES) -> tuple[dict | None, list]:
    """The single route at ``checks`` against its plain version: q' and
    L' within ROUTE_TOL (bf16 q' also within twice the FFMA chain's error
    where it was logged), the norm bound (L' - term2 with L = 0) at most
    1.001 x the true norm, both branches of the procrustes step where B >
    1.  In bf16 (tensor cores) it logs the rate, the share of the bound and
    a ``bmm`` of its step product; at 12 x 768, the GPT-2 path's stacked
    shape and the JSON row, its kernel split, which fails on any FFMA
    ``gemm_kernel``.  Returns (the row, None without a bf16 check; the
    timings at ``line_shapes``)."""
    row, shapes = None, []
    for b, n, dtype, k in checks:
        args = _ns_problem(b, n, dtype, 11, dev) + (0.1, 0.9)
        assert kernels.ns_route(n, dtype) == "single"
        run = lambda: kernels.fused_ns_update(*args, k=k)
        run_p = lambda: kernels.fused_ns_update_plain(*args, k=k)
        (qk, lk), (qp, lp) = run(), run_p()
        shown, both = _branches(_step_a(kernels.ns_step_plain(*args, k=k)[0],
                                        args[4]))
        torch.cuda.synchronize()
        if not (torch.isfinite(qk.float()).all() and torch.isfinite(lk).all()):
            raise AssertionError(f"NS kernel {b}x{n} {dtype}: non-finite output")
        q_err, l_err = _rel(qk, qp), ((lk - lp).abs() / lp.abs()).max().item()
        ratio = ((lk - args[3]) / _true_norm(args[0], "spd")).max().item()
        tol_q, tol_l = kernels.ROUTE_TOL[dtype]
        if dtype == torch.bfloat16 and (b, n) in kernels.FFMA_SINGLE_REL:
            tol_q = min(tol_q, 2 * kernels.FFMA_SINGLE_REL[b, n])
        max_abs = _max_abs(qk, qp)
        log(f"ns single {b}x{n}x{n} {dtype} k={k}: q rel err {q_err:.2e} (tol "
            f"{tol_q:.3g}), L rel err {l_err:.2e} (tol {tol_l}), bound/true max "
            f"{ratio:.5f}, max abs err {max_abs:.3e}, {shown}")
        if q_err > tol_q or l_err > tol_l or ratio > 1.001 or (b > 1 and not both):
            raise AssertionError(f"NS kernel {b}x{n} {dtype} disagrees with "
                                 "the plain version")
        ms = cuda_ms(run, 10)
        ms_plain = cuda_ms(run_p, 5, 1)
        kk = width_norm_k(k, n)
        # three n x n x n products, two bounds of four thin k x n x n each
        flops = b * (6 * n ** 3 + 16 * kk * n * n)
        size = torch.finfo(dtype).bits // 8
        nbytes = b * (3 * n * n * size + 3 * 4)
        bf16 = dtype == torch.bfloat16
        r = _row(ms, ms_plain, flops, nbytes, PEAK_BF16 if bf16 else PEAK_F32, max_abs)
        if bf16:
            # no one PyTorch call computes the route: its step product is
            # the yardstick of its three full products
            bmm = ("torch.bmm(term1, q)",
                   cuda_ms(lambda: torch.bmm(args[0], args[1]), 10))
            _log_row("fused_ns_update", (b, n, n), r, flops, tc_lines, bmm)
            if row is None:   # the GPT-2 path's stacked shape
                row = r
                require_tensor_cores("the single route",
                                     log_kernel_split("fused_ns_update", run))
        else:
            log(f"  kernel {ms:.3f} ms  plain {ms_plain:.3f} ms  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {flops / 1e9:.3f} GFLOP)  "
                f"kernel rate {flops / ms / 1e9:.2f} TFLOP/s")
        if (b, n, dtype, k) in line_shapes:
            shapes.append(dict(shape=f"{(b, n, n)} {str(dtype)[6:]}", **r))
        del args, qk, qp
    torch.cuda.empty_cache()
    return row, shapes


def check_routes(dev) -> None:
    """The split and tiled routes, chosen by the width rule, against their
    plain versions at LLaMA-1.1B's widths in bf16 and at the routes' f32
    widths, with kernels.ROUTE_TOL; each spd bound at most 1.001 x the true
    norm.  Each problem with B > 1 takes both branches of the procrustes
    step (``_ns_problem``), read from the plain pieces on the plain q1; the
    tiled route at B = 1 (2304 and 3072, the shared GPT-2 stacks of the
    options path) takes the clamped one."""
    for route, b, n, dtype in (("split", 22, 2048, torch.bfloat16),
                               ("tiled", 22, 2560, torch.bfloat16),
                               ("split", 2, 1536, torch.float32),
                               ("tiled", 2, 2048, torch.float32),
                               # the shared GPT-2 stacks' 2304 and 3072
                               ("tiled", 1, 2304, torch.bfloat16),
                               ("tiled", 1, 3072, torch.bfloat16)):
        if kernels.ns_route(n, dtype) != route:
            raise AssertionError(f"{n} {dtype} routes to "
                                 f"{kernels.ns_route(n, dtype)}, not {route}")
        args = _ns_problem(b, n, dtype, n, dev) + (0.1, 0.9)
        kernels.reset_launch_counts()
        qk, lk = kernels.fused_ns_update(*args, k=128)
        used = {f.__name__: f.launches for f in
                kernels.SPLIT_KERNELS + kernels.TILED_KERNELS if f.launches}
        qp, lp = kernels.fused_ns_update_plain(*args, k=128)
        shown, both = _branches(_step_a(kernels.ns_step_plain(*args, k=128)[0],
                                        args[4]))
        torch.cuda.synchronize()
        if not (torch.isfinite(qk.float()).all() and torch.isfinite(lk).all()):
            raise AssertionError(f"{route} {b}x{n} {dtype}: non-finite output")
        q_err, l_err = _rel(qk, qp), ((lk - lp).abs() / lp.abs()).max().item()
        ratio = ((lk - args[3]) / _true_norm(args[0], "spd")).max().item()
        tol_q, tol_l = kernels.ROUTE_TOL[dtype]
        ms = cuda_ms(lambda: kernels.fused_ns_update(*args, k=128), 3, 1)
        ms_plain = cuda_ms(lambda: kernels.fused_ns_update_plain(*args, k=128),
                           2, 1)
        log(f"ns {route} {b}x{n}x{n} {dtype}: launches {used}; q rel err "
            f"{q_err:.2e} (tol {tol_q}), L rel err {l_err:.2e} (tol {tol_l}), "
            f"bound/true max {ratio:.5f}, max abs err {_max_abs(qk, qp):.3e}, "
            f"{shown}; route {ms:.2f} ms, plain {ms_plain:.2f} ms")
        if q_err > tol_q or l_err > tol_l or ratio > 1.001 or (b > 1 and not both):
            raise AssertionError(f"{route} route {b}x{n} {dtype} disagrees "
                                 "with the plain version")
        del args, qk, qp
        torch.cuda.empty_cache()


def _newton_problem(b, n, dtype, seed, dev):
    """The Newton fit's NS call: ``_ns_problem``'s term1 as A, a Wishart B
    of the same scale, the bound's matrix A + B and the step matrix
    S = A - B, both stored in Q's dtype, term2 = 0."""
    term1, q, lips, _, seeds = _ns_problem(b, n, torch.float32, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn((b, n, 3 * n), generator=gen, device=dev)
    bb = x @ x.mT / (3 * n)
    del x
    return ((term1 + bb).to(dtype), q.to(dtype), lips, torch.zeros(b, device=dev),
            seeds), (term1 - bb).to(dtype)


# the examples' KronNewton factors with the step matrix, f32 at B = 1 on
# the FFMA chain (k = 32): the CP factors' 10 and the LSTM's 33
STEP_MAT_A10B = (("fused_ns_update", 1, 10, torch.float32, 32),
                 ("fused_ns_update", 1, 33, torch.float32, 32))


def check_step_mat(dev) -> dict:
    """The step-matrix variant of each route at the Newton paths' shapes,
    chosen by the width rule, against the plain route given the same S:
    q' and L' within kernels.ROUTE_TOL, the bound at most 1.001 x the true
    norm of A + B, and S moving q' (it is not term1).  Times the route and
    the piece that takes S (the single route itself, ``ns_step``,
    ``tiled_step``) with CUDA events, against the piece without S on the
    same inputs.  The single route is held at the GPT-2 Newton path's f32
    stacks (12, 768), (1, 768), (1, 1024), at (2, 768) f32, at (12, 768)
    bf16 (tensor cores, which no Newton path launches with S) and at the
    examples' KronNewton factors (``STEP_MAT_A10B``).  Returns {row: the
    JSON row's step-matrix fields}: its piece's time and bound (S read in
    place of term1, or beside it for the bound's matrix) at the row's first
    shape, the shape and dtype its Newton path gives it with S; row 1's
    also ``step_mat_a10b_shapes``, the route's and the plain version's
    times at ``STEP_MAT_A10B``."""
    fields = {}
    for row, b, n, dtype, k in (("fused_ns_update", 12, 768, torch.float32, 128),
                                ("fused_ns_update", 1, 768, torch.float32, 128),
                                ("fused_ns_update", 1, 1024, torch.float32, 128),
                                ("fused_ns_update", 2, 768, torch.float32, 128),
                                ("fused_ns_update", 12, 768, torch.bfloat16, 128),
                                ("ns_step", 22, 2048, torch.bfloat16, 128),
                                ("tiled_step", 22, 2560, torch.bfloat16, 128)) \
            + STEP_MAT_A10B:
        route = kernels.ns_route(n, dtype)
        args, s = _newton_problem(b, n, dtype, 7 * n, dev)
        args = args + (0.1, 0.9)
        run = lambda: kernels.fused_ns_update(*args, k=k, step_mat=s)
        run_p = lambda: kernels.fused_ns_update_plain(*args, k=k, step_mat=s)
        (qk, lk), (qp, lp) = run(), run_p()
        q_wo = kernels.fused_ns_update_plain(*args, k=k)[0]
        torch.cuda.synchronize()
        if not (torch.isfinite(qk.float()).all() and torch.isfinite(lk).all()):
            raise AssertionError(f"step_mat {route} {b}x{n} {dtype}: non-finite output")
        q_err, l_err = _rel(qk, qp), ((lk - lp).abs() / lp.abs()).max().item()
        ratio = (lk / _true_norm(args[0], "spd")).max().item()
        moved = _rel(q_wo, qp)
        tol_q, tol_l = kernels.ROUTE_TOL[dtype]
        log(f"step_mat {route} {b}x{n}x{n} {dtype}: q rel err {q_err:.2e} (tol "
            f"{tol_q}), L rel err {l_err:.2e} (tol {tol_l}), bound/true max "
            f"{ratio:.5f}, max abs err {_max_abs(qk, qp):.3e}; S moves q' by "
            f"{moved:.3f}")
        if q_err > tol_q or l_err > tol_l or ratio > 1.001 or moved < 2 * tol_q:
            raise AssertionError(f"step_mat {route} {b}x{n} {dtype} disagrees "
                                 "with the plain version")
        coeff = torch.full((b,), 0.01, device=dev)
        piece = {
            "fused_ns_update": lambda sm: kernels.fused_ns_update(
                *args, k=k, step_mat=sm),
            "ns_step": lambda sm: kernels.ns_step(*args, k=k, step_mat=sm),
            "tiled_step": lambda sm: kernels.tiled_step(
                args[0] if sm is None else sm, args[1], coeff, args[3],
                sm is not None),
        }[row]
        ms_s, ms_t1 = (cuda_ms(lambda: piece(sm), 10, 2) for sm in (s, None))
        ms_route = cuda_ms(run, 3, 1)
        ms_plain = cuda_ms(run_p, 2, 1)
        kk, size, nn = width_norm_k(k, n), torch.finfo(dtype).bits // 8, n * n
        flops, nbytes = {
            "fused_ns_update": (b * (6 * n ** 3 + 16 * kk * nn), b * (4 * nn * size + 12)),
            "ns_step": (b * (2 * n ** 3 + 8 * kk * nn), b * 4 * nn * size),
            "tiled_step": (b * 2 * n ** 3, b * 3 * nn * size)}[row]
        bound, by = bound_ms(flops, nbytes, PEAK_BF16 if dtype == torch.bfloat16
                             else PEAK_F32)
        log(f"  {row} {(b, n, n)}: with S {ms_s:.3f} ms, without {ms_t1:.3f} ms, "
            f"bound with S {bound:.4f} ms ({by}); route with S {ms_route:.3f} ms, "
            f"plain {ms_plain:.3f} ms")
        fields.setdefault(row, dict(step_mat_ms=ms_s, step_mat_bound_ms=bound,
                                    step_mat_shape=f"{(b, n, n)} {dtype}"))
        if (row, b, n, dtype, k) in STEP_MAT_A10B:
            fields[row].setdefault("step_mat_a10b_shapes", []).append(dict(
                shape=f"{(b, n, n)} {str(dtype)[6:]}",
                **_row(ms_route, ms_plain, flops, nbytes, PEAK_F32, _max_abs(qk, qp))))
        del args, s, qk, qp, q_wo
        torch.cuda.empty_cache()
    return fields


def _within_order(got, ref) -> bool:
    """Products accumulated in f32 in another order: within 1e-5 of the
    largest entry, plus one unit in the last place of each bf16 entry (a
    reordered sum may round to the neighbouring bf16 value)."""
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    r = ref.float()
    tol = ulp * r.abs() + 1e-5 * r.abs().max()
    return bool(((got.float() - r).abs() <= tol).all())


def _row(ms, plain_ms, flops, nbytes, peak, err, library_ms=None):
    bound, by = bound_ms(flops, nbytes, peak)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                max_abs_err=err, library_ms=library_ms)


def _log_row(name, shape, row, flops, tc_lines, bmm=None):
    """Log a row; a tensor-core row also its rate, its share of the bound
    and its time over ``bmm`` = (what, ms), by default its library call."""
    lib = "" if row["library_ms"] is None else \
        f"  library {row['library_ms']:.3f} ms"
    log(f"  {name} {shape}: kernel {row['ms']:.3f} ms  plain "
        f"{row['plain_ms']:.3f} ms{lib}  bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})  max abs err {row['max_abs_err']:.3e}")
    if name in TC_ROWS:
        what, ms = bmm or ("torch.bmm", row["library_ms"])
        log(f"    tensor cores: {flops / row['ms'] / 1e9:.1f} TFLOP/s, "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound, "
            f"{row['ms'] / ms:.2f}x {what} ({ms:.3f} ms at {shape})")
        for line in tc_lines:
            log(f"    {line}")


def _device_us(event) -> float:
    return (getattr(event, "self_device_time_total", 0.0) or
            getattr(event, "self_cuda_time_total", 0.0))


def _short(key: str) -> str:
    """A profiler kernel key without return type, namespace or arguments."""
    return key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


# windows profiled before a phase that saw no device events fails, and the
# pause before the first retry, doubled before each next (three empty
# windows in a row, then none, seen on one machine; five in a row within
# 5 s, at 1 s each, on another)
PROFILE_TRIES = 7
PROFILE_RETRY_S = 1.0
# host time inside each window before and after the profiled call: the
# profiler drops device events whose converted timestamps fall outside its
# window, and a short window that ends as its last kernel does can lose
# them all
PROFILE_PAD_S = 0.025


def _profiled(fn, cpu: bool = False):
    """(CUDA kernel events with device time, wall ms) of one profiled call
    of fn.  torch.profiler now and then hands back a window without device
    events (one of four runs of the same smoke); such a window measured
    nothing, so it is profiled again, and after PROFILE_TRIES empty
    windows the phase fails rather than pass a gate on no data."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for i in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and _device_us(e) > 0]
        if kern:
            return kern, wall_ms
        log("    the profiler saw no device time")
        if i + 1 < PROFILE_TRIES:
            time.sleep(PROFILE_RETRY_S * 2 ** i)
    raise RuntimeError(f"torch.profiler saw no device time in {PROFILE_TRIES} "
                       "windows")


def log_kernel_split(name, fn, calls: int = 3) -> dict[str, float]:
    """Where one call of fn spends its device time: each kernel's ms per
    call and launches per call, from torch.profiler's CUDA events.  Returns
    {kernel short name: ms per call}."""
    fn()
    kern, _ = _profiled(lambda: [fn() for _ in range(calls)])
    total = sum(_device_us(e) for e in kern) / 1e3 / calls
    log(f"    {name} per call: {total:.3f} ms of kernels")
    split = {}
    for e in sorted(kern, key=lambda e: -_device_us(e)):
        short, ms = _short(e.key), _device_us(e) / 1e3 / calls
        split[short] = split.get(short, 0.0) + ms
        log(f"      {ms:8.3f} ms  {e.count // calls:2d}x  {short}")
    return split


def require_tensor_cores(name, kernel_names) -> None:
    """Fail unless a bf16 entry's products ran on the tensor-core GEMM
    alone: some tc_gemm_kernel, no FFMA gemm_kernel."""
    ffma = [k for k in kernel_names if k.startswith("gemm_kernel<")]
    if ffma or not any(k.startswith("tc_gemm_kernel") for k in kernel_names):
        raise AssertionError(f"{name} in bf16 ran {kernel_names}: expected "
                             "tc_gemm_kernel and no FFMA gemm_kernel")


def check_split(dev, b, n, dtype, timed, tc_lines=(), branches=True) -> dict:
    """ns_step and procrustes alone against their plain versions (procrustes
    on the kernel's q1): q1 to f32 accumulation order (``_within_order``),
    L' and q' with kernels.ROUTE_TOL; with ``branches`` the procrustes
    step takes both branches (a batch of one shows only one)."""
    term1, q, lips, term2, seeds = _ns_problem(b, n, dtype, 3 * n, dev)
    step = lambda: kernels.ns_step(term1, q, lips, term2, seeds, 0.1, 0.9, k=128)
    step_p = lambda: kernels.ns_step_plain(term1, q, lips, term2, seeds, 0.1,
                                           0.9, k=128)
    (q1, lk), (q1p, lp) = step(), step_p()
    proc = lambda: kernels.procrustes(q1, seeds, k=128)
    proc_p = lambda: kernels.procrustes_plain(q1, seeds, k=128)
    qk, qp = proc(), proc_p()
    shown, both = _branches(_step_a(q1, seeds))
    torch.cuda.synchronize()
    tol_q, tol_l = kernels.ROUTE_TOL[dtype]
    q1_ok = _within_order(q1, q1p)
    errs = (_rel(q1, q1p), ((lk - lp).abs() / lp.abs()).max().item(), _rel(qk, qp))
    log(f"split stages {b}x{n}x{n} {dtype}: ns_step q1 to accumulation order "
        f"{q1_ok} (rel err {errs[0]:.2e}), L rel err {errs[1]:.2e} (tol "
        f"{tol_l}); procrustes q' rel err {errs[2]:.2e} (tol {tol_q}), {shown}")
    if not q1_ok or errs[1] > tol_l or errs[2] > tol_q or (branches and not both) \
            or q1.dtype != dtype or qk.dtype != dtype:
        raise AssertionError(f"split stages {b}x{n} {dtype} disagree with "
                             "their plain versions")
    if not timed:
        return {}
    k, size, shape = width_norm_k(128, n), 2, (b, n, n)
    flops = {"ns_step": b * (2 * n ** 3 + 8 * k * n * n),
             "procrustes": b * (4 * n ** 3 + 8 * k * n * n)}
    rows = {
        "ns_step": _row(cuda_ms(step, 10, 2), cuda_ms(step_p, 2, 1),
                        flops["ns_step"], b * 3 * n * n * size,
                        PEAK_BF16, _max_abs(q1, q1p),
                        cuda_ms(lambda: torch.bmm(term1, q), 10)),
        "procrustes": _row(cuda_ms(proc, 10, 2), cuda_ms(proc_p, 2, 1),
                           flops["procrustes"], b * 2 * n * n * size,
                           PEAK_BF16, _max_abs(qk, qp)),
    }
    # no one PyTorch call computes procrustes: its first product, R16 q1,
    # is the yardstick of its two
    r16 = kernels.tsub_plain(q1)
    bmm = ("torch.bmm(r16, q1)", cuda_ms(lambda: torch.bmm(r16, q1), 10))
    for name, row in rows.items():
        _log_row(name, shape, row, flops[name], tc_lines,
                 bmm if name == "procrustes" else None)
    log_kernel_split("ns_step", step)
    split = log_kernel_split("procrustes", proc)
    require_tensor_cores("procrustes", split)
    tsub_ms = sum(ms for k, ms in split.items() if k.startswith("transpose_sub_kernel"))
    tsub_bound = b * n * n * (size + 4 + 2) / PEAK_BYTES * 1e3
    log(f"    procrustes: its transpose-subtract (bf16 q1 -> f32 R + bf16 R16) "
        f"{tsub_ms:.4f} ms of {sum(split.values()):.3f}, bound {tsub_bound:.4f} ms (bytes)")
    return rows


def check_tiled(dev, b, n, dtype, timed, tc_lines=()) -> dict:
    """The five tiled pieces alone against their plain versions, chained as
    the route chains them: norm_bound within ``kernels.norm_bound_rtol`` of
    the plain bound (the same start, the same storage-dtype energies; 1e-5,
    plus in bf16 how far the plain bound moves when summed in the tensor
    cores' order) and at most 1.001 x the true norm (spd and skew);
    tiled_step and scaled_matmul_trace to f32 accumulation order
    (``_within_order``), traces within 1e-4 of the sum of |diagonal| (they
    cancel); tsub and combine bit for bit, with a step that takes both
    branches where B > 1."""
    term1, q, lips, term2, seeds = _ns_problem(b, n, dtype, 5 * n, dev)
    bad = []

    def bound_check(mat, mode, tag):
        bk = kernels.norm_bound(mat, seeds, mode, tag, k=128)
        bp = kernels.norm_bound_plain(mat, seeds, mode, tag, k=128)
        rel = ((bk - bp).abs() / bp).max().item()
        tol = kernels.norm_bound_rtol(mat, seeds, mode, tag, k=128)
        ratio = (bk / _true_norm(mat, mode)).max().item()
        log(f"  norm_bound {mode}: rel err vs plain {rel:.2e} (tol {tol:.2e}: "
            f"{kernels.BOUND_RTOL} + {tol - kernels.BOUND_RTOL:.2e}, how far the "
            f"plain bound moves summed as the tensor cores sum), bound/true max "
            f"{ratio:.5f}")
        if rel > tol or ratio > 1.001:
            bad.append(f"norm_bound {mode}")
        return bk, bp

    bk, bp = bound_check(term1, "spd", 0)
    coeff = (0.1 / (bk + term2)).contiguous()
    q1 = kernels.tiled_step(term1, q, coeff, term2)
    q1p = kernels.tiled_step_plain(term1, q, coeff, term2)
    r = kernels.tsub(q1)
    rp = kernels.tsub_plain(q1)
    rk, _ = bound_check(r, "skh", kernels.SKH_TAG)
    inv = 1.0 / (rk + torch.finfo(torch.float32).tiny)
    (rq, tr), (rqp, trp) = (kernels.scaled_matmul_trace(r, q1, inv),
                            kernels.scaled_matmul_trace_plain(r, q1, inv))
    rrq, tr2 = kernels.scaled_matmul_trace(r, rq, inv)
    a = kernels.step_size(tr, tr2)
    out = kernels.combine(q1, rq, rrq, a)
    outp = kernels.combine_plain(q1, rq, rrq, a)
    torch.cuda.synchronize()
    shown, both = _branches(a)
    scale = torch.diagonal(r.float() @ q1.float(), dim1=-2,
                           dim2=-1).abs().sum(-1) * inv
    tr_err = ((tr - trp).abs() / scale).max().item()
    checks = {"tiled_step": _within_order(q1, q1p), "tsub": torch.equal(r, rp),
              "scaled_matmul_trace": _within_order(rq, rqp) and tr_err <= 1e-4,
              "combine": torch.equal(out, outp)}
    if b > 1:   # one matrix takes one branch
        checks["both step branches"] = both
    log(f"tiled pieces {b}x{n}x{n} {dtype}: {checks}; trace err / sum|diag| "
        f"{tr_err:.2e}; {shown}")
    bad += [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"tiled pieces {b}x{n} {dtype} disagree with "
                             f"their plain versions: {bad}")
    if not timed:
        return {}
    k, size, nn, shape = width_norm_k(128, n), 2, n * n, (b, n, n)
    bound = lambda: kernels.norm_bound(term1, seeds, "spd", 0, k=128)
    flops = {name: b * 2 * n ** 3 for name in ("tiled_step", "scaled_matmul_trace")}
    flops["norm_bound"] = b * 8 * k * nn
    rows = {
        "norm_bound": _row(
            cuda_ms(bound, 10, 2),
            cuda_ms(lambda: kernels.norm_bound_plain(term1, seeds, "spd", 0,
                                                     k=128), 2, 1),
            flops["norm_bound"], b * (nn * size + 4), PEAK_BF16, _max_abs(bk, bp)),
        "tiled_step": _row(
            cuda_ms(lambda: kernels.tiled_step(term1, q, coeff, term2), 10, 2),
            cuda_ms(lambda: kernels.tiled_step_plain(term1, q, coeff, term2), 2, 1),
            b * 2 * n ** 3, b * 3 * nn * size, PEAK_BF16, _max_abs(q1, q1p),
            cuda_ms(lambda: torch.bmm(term1, q), 5)),
        "tsub": _row(
            cuda_ms(lambda: kernels.tsub(q1), 10),
            cuda_ms(lambda: kernels.tsub_plain(q1), 3, 1),
            0, b * 2 * nn * size, PEAK_BF16, 0.0,
            cuda_ms(lambda: torch.sub(q1.mT, q1), 10)),
        "scaled_matmul_trace": _row(
            cuda_ms(lambda: kernels.scaled_matmul_trace(r, q1, inv), 10, 2),
            cuda_ms(lambda: kernels.scaled_matmul_trace_plain(r, q1, inv), 2, 1),
            b * 2 * n ** 3, b * 3 * nn * size, PEAK_BF16, _max_abs(rq, rqp),
            cuda_ms(lambda: torch.bmm(r, q1), 10)),
        "combine": _row(
            cuda_ms(lambda: kernels.combine(q1, rq, rrq, a), 10),
            cuda_ms(lambda: kernels.combine_plain(q1, rq, rrq, a), 3, 1),
            0, b * 4 * nn * size, PEAK_BF16, 0.0),
    }
    # no one PyTorch call computes the bound: one of its four thin products,
    # a (k, n) bf16 block times the matrix, is its yardstick
    v16 = torch.randn((b, k, n), device=term1.device).to(dtype)
    thin = (f"torch.bmm(v16, term1) (k = {k})",
            cuda_ms(lambda: torch.bmm(v16, term1), 10))
    for name, row in rows.items():
        _log_row(name, shape, row, flops.get(name, 0), tc_lines,
                 thin if name == "norm_bound" else None)
    # the chain reads the matrix five times (row statistics, four thin
    # products); its bound counts each input byte once
    passes = 5 * b * nn * size
    log(f"    norm_bound: its five passes over the matrix move {passes / 1e9:.3f} GB, "
        f"{passes / PEAK_BYTES * 1e3:.4f} ms at {PEAK_BYTES / 1e12:.2f} TB/s, "
        f"{passes / PEAK_BYTES * 1e3 / rows['norm_bound']['ms']:.3f} of its time")
    require_tensor_cores("norm_bound", log_kernel_split("norm_bound", bound))
    require_tensor_cores("tiled_step", log_kernel_split(
        "tiled_step", lambda: kernels.tiled_step(term1, q, coeff, term2)))
    return rows


# the shapes the geometries' fits give norm_bound (GPT-2 124M's dense
# factors: the five (12, 768) stacks, wte's 768, wpe's 1024 and 768), in the
# whitening arms' bf16 and the fit-P and Newton arms' f32, and a bf16 width
# TMA cannot load, which the bound takes on the FFMA GEMM
GEOMETRY_BOUND_SHAPES = tuple((b, n, dt) for b, n in ((12, 768), (1, 768), (1, 1024))
                              for dt in (torch.bfloat16, torch.float32)) + (
    (3, 100, torch.bfloat16),)


# the 774M's widths, where the tolerance's model was not yet held
A10A_BOUND_SHAPES = ((36, 1280, torch.bfloat16), (1, 1280, torch.bfloat16))
# the tiled route's new widths in the NS-width sweep (``NS_WIDTHS``)
NS_WIDTHS_BOUND_SHAPES = ((2, 4096, torch.bfloat16), (3, 3072, torch.float32))


def check_norm_bound_shapes(dev, shapes=GEOMETRY_BOUND_SHAPES) -> list:
    """Row 5 at ``shapes`` (k = 128, the paths' norm_k): the
    bound of a Wishart stack within ``kernels.norm_bound_rtol`` of its plain
    version (in bf16 at n % 8 == 0 plus the tensor cores' summation; on the
    FFMA GEMM, in f32 and at (3, 100) bf16, ``BOUND_RTOL``) and at most
    1.001 x the true norm; timed (CUDA events) against its bound (four
    thin k x n x n products at the dtype's peak; the matrix read once) and
    its plain version.  The bf16 (12, 768) call's kernel split fails on an
    FFMA ``gemm_kernel``, the (3, 100) one's on a tensor-core one.
    Returns the timings for the JSON row."""
    out = []
    for b, n, dtype in shapes:
        term1, _, _, _, seeds = _ns_problem(b, n, dtype, 17 * n + b, dev)
        run = lambda: kernels.norm_bound(term1, seeds, "spd", 0, k=128)
        run_p = lambda: kernels.norm_bound_plain(term1, seeds, "spd", 0, k=128)
        bk, bp = run(), run_p()
        rel = ((bk - bp).abs() / bp).max().item()
        tol = kernels.norm_bound_rtol(term1, seeds, "spd", 0, k=128)
        ratio = (bk / _true_norm(term1, "spd")).max().item()
        k, size = width_norm_k(128, n), torch.finfo(dtype).bits // 8
        bf16 = dtype == torch.bfloat16
        bound, by = bound_ms(b * 8 * k * n * n, b * (n * n * size + 4),
                             PEAK_BF16 if bf16 else PEAK_F32)
        ms, ms_plain = cuda_ms(run, 20, 3), cuda_ms(run_p, 3, 1)
        gemm = "tensor cores" if bf16 and n % 8 == 0 else "FFMA GEMM"
        log(f"norm_bound ({b}, {n}, {n}) {dtype} ({gemm}): rel err vs plain "
            f"{rel:.2e} (tol {tol:.2e}), bound/true max {ratio:.5f}; kernel "
            f"{ms:.4f} ms  plain {ms_plain:.3f} ms  bound {bound:.4f} ms ({by}), "
            f"{bound / ms:.3f} of the bound")
        if rel > tol or ratio > 1.001:
            raise AssertionError(f"norm_bound ({b}, {n}) {dtype} disagrees with "
                                 "its plain version")
        if bf16 and (b, n) in ((12, 768), (3, 100)):
            split = log_kernel_split("norm_bound", run)
            tc = any(k.startswith("tc_gemm_kernel") for k in split)
            ffma = any(k.startswith("gemm_kernel<") for k in split)
            if (n % 8 == 0) != (tc and not ffma):
                raise AssertionError(f"norm_bound ({b}, {n}) bf16 ran {sorted(split)}")
        out.append(dict(shape=f"{(b, n, n)} {str(dtype)[6:]}", ms=ms,
                        plain_ms=ms_plain, bound_ms=bound, bound_by=by,
                        max_abs_err=_max_abs(bk, bp)))
        del term1
    torch.cuda.empty_cache()
    return out


def check_procrustes_loop(dev) -> None:
    """PRO4P's Procrustes loop (``linalg.procrustes_loop3``: per masked
    step a ``tsub`` and a skew ``norm_bound``, 10 steps) on the card
    against the CPU's plain loop from the same stack and keys: (3, 768,
    768) f32, I plus a symmetric part plus a skew part scaled 0, 0.05 and
    0.5, so the first layer leaves before any step and the others after
    one or more, each on its own test.  The steps taken agree, q' within
    1e-4 (Frobenius-relative: f32 sums in another order), the first layer
    untouched and the others nearer symmetric.  The GPT-2 paths' loops
    take no step (their Q stays symmetric to 1e-3, PERF.md), so this is
    where the loop's steps run on the card."""
    n = 768
    gen = torch.Generator().manual_seed(23)
    a = torch.randn((3, n, n), generator=gen) / n ** 0.5
    skew = torch.tensor([0.0, 0.05, 0.5])[:, None, None]
    q = torch.eye(n) + 0.05 * (a + a.mT) + skew * (a - a.mT)
    keys = fastrand.split(fastrand.prng_key(5), 3)
    runs = {}
    for device in (dev, torch.device("cpu")):
        linalg.procrustes_loop3.layer_steps = 0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = linalg.procrustes_loop3(q.to(device), keys, norm_k=128)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[device.type] = (out.cpu(), int(linalg.procrustes_loop3.layer_steps), ms,
                             kernels.norm_bound.launches, kernels.tsub.launches)
    (qk, steps_k, ms_k, nb, ts), (qp, steps_p, ms_p, _, _) = runs["cuda"], runs["cpu"]
    asym = lambda m: (m.mT - m).abs().amax(dim=(-2, -1))
    rel = _rel(qk, qp)
    log(f"procrustes_loop3 (3, {n}, {n}) f32: steps taken card {steps_k}, CPU {steps_p}; "
        f"q' rel err {rel:.2e} (tol 1e-4); max|Q^T - Q| {asym(q).tolist()} -> "
        f"{asym(qk).tolist()}; card {ms_k:.1f} ms ({nb} norm_bound, {ts} tsub "
        f"launches), CPU plain {ms_p:.0f} ms")
    if (steps_k != steps_p or not steps_k or rel > 1e-4 or not torch.equal(qk[0], q[0])
            or not (asym(qk)[1:] < asym(q)[1:]).all() or (nb, ts) != (10, 10)):
        raise AssertionError("procrustes_loop3 on the card disagrees with the plain loop")


def check_transpose_sub(dev) -> None:
    """Each instantiation of the transpose-subtract at the main paths'
    shapes, R and R16 bit for bit against ``kernels.transpose_sub_plain``,
    timed against its bytes bound (Q1 read once, R and R16 written once):
    (12, 768) f32 -> f32 (the f32 single route) and f32 -> f32 + R16 (the
    bf16 single route's f32 q1), (22, 2048) bf16 -> f32 + R16 (the split
    ``procrustes``), (22, 2560) bf16 -> bf16 (``tsub``)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    for b, n, in_dtype, out_dtype, copy16 in (
            (12, 768, torch.float32, torch.float32, False),
            (12, 768, torch.float32, torch.float32, True),
            (22, 2048, torch.bfloat16, torch.float32, True),
            (22, 2560, torch.bfloat16, torch.bfloat16, False)):
        x = torch.randn((b, n, n), generator=gen, device=dev).to(in_dtype)
        run = lambda: kernels.transpose_sub(x, out_dtype, copy16)
        (r, r16), (rp, r16p) = run(), kernels.transpose_sub_plain(x, out_dtype, copy16)
        torch.cuda.synchronize()
        same = torch.equal(_bits(r), _bits(rp)) and (
            r16 is None or torch.equal(_bits(r16), _bits(r16p)))
        nbytes = b * n * n * (x.element_size() + r.element_size() + 2 * copy16)
        ms = cuda_ms(run, 20)
        bound = nbytes / PEAK_BYTES * 1e3
        what = (f"{str(in_dtype)[6:]} -> {str(out_dtype)[6:]}"
                f"{' + R16' if copy16 else ''}")
        log(f"transpose_sub {(b, n, n)} {what}: bit-exact {same}; kernel {ms:.4f} ms  "
            f"bound {bound:.4f} ms (bytes, {nbytes / 1e9:.3f} GB), "
            f"{bound / ms:.3f} of the bound")
        if not same:
            raise AssertionError(f"transpose_sub {(b, n, n)} {what} differs from "
                                 "its plain version")
        del x, r, r16, rp, r16p
        torch.cuda.empty_cache()


def gpt2_numel() -> int:
    """GPT-2 124M's parameter count, the LRA paths' vector length n."""
    model = gpt2.GPT2(gpt2.gpt2_124m(), device="cpu")
    return sum(p.numel() for p in model.parameters())


def check_lra_dense_shapes(dev, lib_path) -> dict:
    """The kernels at the shapes the LRA and dense paths give them, against
    their plain versions, timed (CUDA events) beside their bounds:

    * row 2 at (1, n) f32, n = GPT-2 124M's parameter count (the LRA
      whitening probe and damping): unit and fused mode bit for bit, and
      the fused output g + (damping + eps|g|) v with the unit draw's v (one
      v from one key); bound max(bytes, the loop's SASS instructions at the
      SM clock under load), ``torch.rand`` the library call;
    * row 4 at (1, 1700) and (1, 100) f32 (dense Q0.5EQ1.5 on the
      tensor-rank problem and on Rosenbrock, norm_k 32): q' within
      ROUTE_TOL f32; bound the two full products 4 n^3 and the skew
      bound's 8 k n^2 at 67 TFLOP/s;
    * rows 5 and 7 at (1, 1700) f32 (dense PRO4P's Procrustes loop): the
      skew bound within ``kernels.norm_bound_rtol`` and at most 1.001 x the
      true norm, ``tsub`` bit for bit.

    Returns {row: [entries]} for the JSON line's ``lra_dense_shapes``."""
    out = {k: [] for k in ("damped_noise", "procrustes", "norm_bound", "tsub")}
    gen = torch.Generator(device=dev).manual_seed(29)
    n = gpt2_numel()
    seeds = _seeds(1, gen, dev)
    g = torch.randn((1, n), generator=gen, device=dev)
    v = kernels.unit_noise(seeds, (n,), torch.float32)
    fused = kernels.damped_noise(g, seeds, 1e-9)
    d = torch.tensor(1e-9, device=dev) + torch.finfo(torch.float32).eps * g.abs()
    one_v = torch.equal(_bits(fused), _bits(g + d * v))
    del d
    plain_v = kernels.unit_noise_plain(seeds, (n,), torch.float32)
    plain_fused = kernels.damped_noise_plain(g, seeds, 1e-9)
    same = torch.equal(_bits(v), _bits(plain_v)) and torch.equal(_bits(fused),
                                                                  _bits(plain_fused))
    errs = {"unit": _max_abs(v, plain_v), "fused": _max_abs(fused, plain_fused)}
    del v, fused, plain_v, plain_fused
    unit = lambda: kernels.unit_noise(seeds, (n,), torch.float32)
    damp = lambda: kernels.damped_noise(g, seeds, 1e-9)
    ms = {"unit": cuda_ms(unit, 10), "fused": cuda_ms(damp, 10)}
    plain = {"unit": cuda_ms(lambda: kernels.unit_noise_plain(seeds, (n,), torch.float32), 2, 1),
             "fused": cuda_ms(lambda: kernels.damped_noise_plain(g, seeds, 1e-9), 2, 1)}
    rand_ms = cuda_ms(lambda: torch.rand((1, n), device=dev), 10)
    loops = _noise_loops(str(lib_path))
    clock = sm_clock_hz(damp, max(100, int(500 / ms["fused"])))
    for mode, nbytes in (("unit", 4 * n), ("fused", 8 * n)):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_instr = instruction_ms(n, loops[("float32", mode == "fused", True)], clock)
        entry = dict(shape=f"(1, {n}) float32 {mode}", ms=ms[mode], plain_ms=plain[mode],
                     bound_ms=max(t_bytes, t_instr),
                     bound_by="bytes" if t_bytes >= t_instr else "operations",
                     max_abs_err=errs[mode], library_ms=rand_ms)
        out["damped_noise"].append(entry)
        log(f"noise (1, {n}) f32 {mode} (the LRA whitening fit): bit-exact {same}, one v "
            f"from one key {one_v}; kernel {ms[mode]:.4f} ms  plain {plain[mode]:.3f} ms  "
            f"torch.rand {rand_ms:.4f} ms  bound {entry['bound_ms']:.4f} ms (bytes "
            f"{t_bytes:.4f}, instructions {t_instr:.4f} at {clock / 1e6:.0f} MHz), "
            f"{entry['bound_ms'] / ms[mode]:.3f} of the bound")
    if not (same and one_v):
        raise AssertionError(f"noise at (1, {n}) f32 differs from its plain version "
                             "or draws another v in fused mode")
    del g
    torch.cuda.empty_cache()
    tol = kernels.ROUTE_TOL[torch.float32][0]
    for n in (1700, 100):
        a = torch.randn((1, n, n), generator=gen, device=dev) / n ** 0.5
        q1 = torch.eye(n, device=dev) + 0.05 * (a + a.mT) + 0.02 * (a - a.mT)
        del a
        seeds = _seeds(1, gen, dev)
        run = lambda: kernels.procrustes(q1, seeds, k=32)
        run_p = lambda: kernels.procrustes_plain(q1, seeds, k=32)
        qk, qp = run(), run_p()
        rel = _rel(qk, qp)
        k = width_norm_k(32, n)
        r = kernels.tsub_plain(q1)
        row = _row(cuda_ms(run, 10, 2), cuda_ms(run_p, 2, 1),
                   4 * n ** 3 + 8 * k * n * n, 2 * n * n * 4, PEAK_F32,
                   _max_abs(qk, qp))
        bmm_ms = cuda_ms(lambda: torch.bmm(r, q1), 10)
        row.update(shape=f"(1, {n}, {n}) float32")
        out["procrustes"].append(row)
        log(f"procrustes (1, {n}, {n}) f32 (dense Q0.5EQ1.5, FFMA GEMM): q' rel err "
            f"{rel:.2e} (tol {tol}); kernel {row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms"
            f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound; yardstick torch.bmm(r, q1) "
            f"{bmm_ms:.3f} ms")
        if not rel < tol:
            raise AssertionError(f"procrustes (1, {n}) f32 disagrees with its plain version")
        if n != 1700:
            continue
        rk, rp = kernels.tsub(q1), kernels.tsub_plain(q1)
        bk = kernels.norm_bound(rk, seeds, "skh", 0, k=32)
        bp = kernels.norm_bound_plain(rk, seeds, "skh", 0, k=32)
        brel = ((bk - bp).abs() / bp).max().item()
        btol = kernels.norm_bound_rtol(rk, seeds, "skh", 0, k=32)
        ratio = (bk / _true_norm(rk, "skh")).max().item()
        same_r = torch.equal(_bits(rk), _bits(rp))
        brow = _row(cuda_ms(lambda: kernels.norm_bound(rk, seeds, "skh", 0, k=32), 10, 2),
                    cuda_ms(lambda: kernels.norm_bound_plain(rk, seeds, "skh", 0, k=32), 2, 1),
                    8 * k * n * n, n * n * 4 + 4, PEAK_F32, _max_abs(bk, bp))
        trow = _row(cuda_ms(lambda: kernels.tsub(q1), 10),
                    cuda_ms(lambda: kernels.tsub_plain(q1), 3, 1),
                    0, 2 * n * n * 4, PEAK_F32, 0.0,
                    cuda_ms(lambda: torch.sub(q1.mT, q1), 10))
        for name, row in (("norm_bound", brow), ("tsub", trow)):
            row.update(shape=f"(1, {n}, {n}) float32" + (" skh" if name == "norm_bound" else ""))
            out[name].append(row)
            lib = "" if row["library_ms"] is None else f"  library {row['library_ms']:.4f} ms"
            log(f"  {name} (1, {n}, {n}) f32: kernel {row['ms']:.4f} ms  plain "
                f"{row['plain_ms']:.3f} ms{lib}  bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), {row['bound_ms'] / row['ms']:.3f} of the bound")
        log(f"  dense PRO4P loop pieces (1, {n}, {n}) f32: tsub bit-exact {same_r}; skew "
            f"norm_bound rel err vs plain {brel:.2e} (tol {btol:.2e}), bound/true {ratio:.5f}")
        if not same_r or brel > btol or ratio > 1.001:
            raise AssertionError(f"the PRO4P loop's pieces at (1, {n}) f32 disagree with "
                                 "their plain versions")
        del rk, rp
    del q1, qk, qp, r
    torch.cuda.empty_cache()
    return out


def vector_noise_seeds(fits_splits: int, world: int, folded: bool = True) -> list:
    """The first fit's noise keys of a vector-sharded optimizer seeded 0
    (key chain split(key, ``fits_splits``), k_fit the last; kv or kd =
    split(k_fit)[0]), folded with each shard's index, or k_fit itself
    (dense, unfolded)."""
    k_fit = fastrand.split(fastrand.prng_key(0), fits_splits)[-1]
    if not folded:
        return [k_fit]
    kv = fastrand.split(k_fit)[0]
    return [fastrand.fold_in(kv, r) for r in range(world)]


def check_vector_noise(dev, lib_path) -> list:
    """Row 2 at the vector-sharded path's shapes and seeds, bit for bit
    against its plain version: arm A's probe and damping (unit and fused)
    and arm B's damping at (1, n/2) f32 under each shard's folded key, n
    GPT-2 124M's parameter count; arm C's dense damping at (1, 1700) and
    (1, 1701) under the unfolded key and LRANewton's at (1, 567) under the
    3 shards' keys.  The (1, n/2) launches are timed (CUDA events) beside
    the bound (bytes or the loop's SASS at the SM clock under load, as
    ``check_lra_dense_shapes``) and ``torch.rand``.  Returns the JSON
    line's ``vector_shapes`` entries."""
    gen = torch.Generator(device=dev).manual_seed(31)
    n_loc = gpt2_numel() // 2
    cases = [(n_loc, s, "unit") for s in vector_noise_seeds(3, 2)] + \
        [(n_loc, s, "fused") for s in vector_noise_seeds(3, 2) + vector_noise_seeds(4, 2)] + \
        [(n, s, "fused") for n in (1700, 1701) for s in vector_noise_seeds(4, 1, False)] + \
        [(567, s, "fused") for s in vector_noise_seeds(4, 3)]
    g = torch.randn((1, n_loc), generator=gen, device=dev)
    same = []
    for n, key, mode in cases:
        seeds = kernels.key_seed_words(key[None], dev)
        if mode == "unit":
            a = kernels.unit_noise(seeds, (n,), torch.float32)
            b = kernels.unit_noise_plain(seeds, (n,), torch.float32)
        else:
            a = kernels.damped_noise(g[:, :n], seeds, 1e-9)
            b = kernels.damped_noise_plain(g[:, :n], seeds, 1e-9)
        same.append(torch.equal(_bits(a), _bits(b)))
        del a, b
    if not all(same):
        raise AssertionError(f"noise at the vector-sharded shapes differs from its plain "
                             f"version: {[c[::2] for c, ok in zip(cases, same) if not ok]}")
    seeds = kernels.key_seed_words(vector_noise_seeds(3, 2)[0][None], dev)
    unit = lambda: kernels.unit_noise(seeds, (n_loc,), torch.float32)
    damp = lambda: kernels.damped_noise(g, seeds, 1e-9)
    ms = {"unit": cuda_ms(unit, 10), "fused": cuda_ms(damp, 10)}
    plain = {"unit": cuda_ms(lambda: kernels.unit_noise_plain(seeds, (n_loc,),
                                                              torch.float32), 2, 1),
             "fused": cuda_ms(lambda: kernels.damped_noise_plain(g, seeds, 1e-9), 2, 1)}
    rand_ms = cuda_ms(lambda: torch.rand((1, n_loc), device=dev), 10)
    loops = _noise_loops(str(lib_path))
    clock = sm_clock_hz(damp, max(100, int(500 / ms["fused"])))
    out = []
    for mode, nbytes in (("unit", 4 * n_loc), ("fused", 8 * n_loc)):
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_instr = instruction_ms(n_loc, loops[("float32", mode == "fused", True)], clock)
        out.append(dict(shape=f"(1, {n_loc}) float32 {mode}, a shard of 2", ms=ms[mode],
                        plain_ms=plain[mode], bound_ms=max(t_bytes, t_instr),
                        bound_by="bytes" if t_bytes >= t_instr else "operations",
                        max_abs_err=0.0, library_ms=rand_ms))
        log(f"noise (1, {n_loc}) f32 {mode} (a vector-sharded LRA fit's shard of 2): "
            f"kernel {ms[mode]:.4f} ms  plain {plain[mode]:.3f} ms  torch.rand "
            f"{rand_ms:.4f} ms  bound {out[-1]['bound_ms']:.4f} ms (bytes {t_bytes:.4f}, "
            f"instructions {t_instr:.4f} at {clock / 1e6:.0f} MHz), "
            f"{out[-1]['bound_ms'] / ms[mode]:.3f} of the bound")
    log(f"noise bit for bit at the vector-sharded path's {len(cases)} (shape, key, mode) "
        f"launches: (1, {n_loc}) unit and fused under each shard's folded key (arms A, "
        f"B), (1, 1700) and (1, 1701) fused unfolded, (1, 567) fused under 3 keys (C)")
    del g
    torch.cuda.empty_cache()
    return out


def _train_tiny(device, name: str, steps: int = 3, **options):
    """A tiny GPT-2 trained by optimizer ``name`` (f32 Q, p = 1, with
    ``options``) on ``device``; the same seeds on every device, so the
    Philox draws are the same.  Returns the parameters' total change."""
    cfg = gpt2.tiny_config(n_layer=2, n_head=4, n_embd=128, block_size=64,
                           vocab_size=512, compute_dtype=torch.float32)
    model = gpt2.GPT2(cfg, device="cpu").to(device)   # same weights everywhere
    x, y = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(2), 2, 64,
                                   512, device=device)
    p0 = [p.detach().clone() for p in model.parameters()]
    mask = gpt2.scanned_layers_mask(model)
    if name == "KronNewton":
        opt = KronNewton(model.named_parameters(), lr=1e-2,
                         preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
                         norm_k=32, grad_clip_max_norm=10.0, device=device,
                         scanned_layers=mask, **options)
    elif name == "KronWhiten":
        opt = KronWhiten(model.named_parameters(), lr=1e-3, momentum=0.9,
                         whiten_grad=False, preconditioner_max_skew=2.0,
                         preconditioner_init_scale=1.0, norm_k=32,
                         weight_decay=0.01, device=device, scanned_layers=mask,
                         **options)
    elif name == "LRAWhiten":
        opt = LRAWhiten(model.named_parameters(), lr=1e-3, momentum=0.9,
                        rank_of_approximation=LRA_RANK,
                        preconditioner_init_scale=1.0, device=device)
    else:
        opt = LRANewton(model.named_parameters(), lr=1e-2,
                        rank_of_approximation=LRA_RANK, grad_clip_max_norm=10.0,
                        preconditioner_init_scale=1.0, device=device)
    for _ in range(steps):
        _one_step(model, gpt2.loss_gpt2, opt, x, y)
    return torch.cat([(p.detach() - q).flatten().cpu()
                      for p, q in zip(model.parameters(), p0)])


def cp_problem(rank: int, sizes, device, seed: int = 0):
    """The tensor-rank (CP) decomposition of the port's
    examples/tensor_rank_decomposition.py (``make_problem``: a target T =
    sum_r x_r (x) y_r (x) z_r from random factors, and random starting
    factors (R, I), (R, J), (R, K), drawn on the CPU from ``seed``).
    Returns (params, loss) with loss() = |T - sum_r x_r (x) y_r (x) z_r|^2."""
    loss_fn, init = tensor_rank_decomposition.make_problem(
        torch.Generator().manual_seed(seed), rank, sizes, device)
    params = [x.requires_grad_() for x in init]
    return params, lambda: loss_fn(params)


def _cp_opt(params, device, dq=None, **kw):
    """The example's Newton optimizers (lr 0.2, lr_preconditioner 0.5,
    momentum 0.9, global-norm clip 10, init scale on the fly): DenseNewton
    in geometry ``dq``, or LRANewton (rank 10) with ``dq`` None."""
    args = dict(lr=0.2, lr_preconditioner=0.5, momentum=0.9,
                grad_clip_max_norm=10.0, device=device, **kw)
    if dq is None:
        return LRANewton(params, rank_of_approximation=LRA_RANK, **args)
    return DenseNewton(params, dq=dq, **args)


def _train_cp_small(device, dq, steps: int = 3):
    """The small tensor-rank problem (``CP_SMALL``, n = 24) by DenseNewton
    in geometry ``dq`` (f32 Q, the example's settings) on ``device``;
    returns the parameters' total change."""
    params, loss = cp_problem(*CP_SMALL, device)
    p0 = [p.detach().clone() for p in params]
    opt = _cp_opt(params, device, dq)
    for _ in range(steps):
        opt.step(loss)
    return torch.cat([(p.detach() - q).flatten().cpu() for p, q in zip(params, p0)])


# the options held on the small path: (optimizer, options)
SMALL_OPTIONS = (
    ("KronWhiten", {}),
    ("KronWhiten", dict(share_fit_apply=True, update_preconditioner_first=False)),
    ("KronWhiten", dict(cache_p=True)),
    ("KronWhiten", dict(pipelined_fit=True)),
    ("KronWhiten", dict(shared_layers=True)),
    ("KronNewton", {}),
    ("KronNewton", dict(cache_p=True)),
    ("KronNewton", dict(shared_layers=True)),
) + tuple((name, dict(dq=dq)) for dq in GEOMETRIES
          for name in ("KronWhiten", "KronNewton")) + (
    ("LRAWhiten", {}), ("LRANewton", {})) + tuple(
    ("DenseNewton", dict(dq=dq)) for dq in kron_p.ALL_DQ) + (
    # float64 Q: the XLA tail and the noise kernel's float64 instantiation
    ("KronWhiten", dict(preconditioner_dtype=torch.float64)),
    ("KronNewton", dict(preconditioner_dtype=torch.float64)))


def check_small_path(dev) -> None:
    """The whole optimizer on the card (kernels) against the CPU (plain
    versions, which the CPU tests hold against the JAX package): 3 steps of
    a tiny GPT-2 with f32 Q, by KronWhiten and by KronNewton (exact Hvp),
    plainly and with each option the port takes, and by LRAWhiten and
    LRANewton; 3 steps of the small tensor-rank problem (``CP_SMALL``) by
    DenseNewton in each of the seven geometries (``SMALL_OPTIONS``).
    Same seeds and draws on both sides; the total parameter change agrees
    within 1e-3 (Frobenius-relative: f32 sums in another order, in the
    model, the Hvp and the kernels)."""
    for name, options in SMALL_OPTIONS:
        steps = []
        for device in (dev, torch.device("cpu")):
            linalg.procrustes_loop3.layer_steps = 0
            steps.append(_train_cp_small(device, **options) if name == "DenseNewton"
                         else _train_tiny(device, name, **options))
            steps[-1] = (steps[-1], int(linalg.procrustes_loop3.layer_steps))
        (on_card, card_steps), (on_cpu, cpu_steps) = steps
        rel = ((on_card - on_cpu).norm() / on_cpu.norm()).item()
        loop = (f"; Procrustes loop steps taken card {card_steps}, CPU {cpu_steps}"
                if options.get("dq") == "PRO4P" else "")
        qdt = str(options.get("preconditioner_dtype", "f32")).removeprefix("torch.")
        what = ("small tensor-rank problem, 3 steps, f32 Q" if name == "DenseNewton"
                else f"tiny GPT-2, 3 steps, {qdt} Q")
        log(f"small path ({what}, {name} {options or 'plain'}): card vs CPU plain, "
            f"parameter change rel err {rel:.2e} (tol 1e-3){loop}")
        if not rel < 1e-3 or card_steps != cpu_steps:
            raise AssertionError(f"the card's {name} {options} disagrees with "
                                 "the plain path on a small input")


def _median(xs):
    return round(sorted(xs)[len(xs) // 2], 2) if xs else None


# the optimizers whose step takes the closure (and runs the Hvp pass)
NEWTON_OPTIMIZERS = (KronNewton, LRANewton, DenseNewton)


def _one_step(model, loss_fn, opt, tokens, targets, before_step=None):
    """One training step: a Newton optimizer takes the closure (its step
    runs the forward and the backward or the Hvp pass); a whitening one
    the usual zero_grad, backward, step, with ``before_step()`` called
    between the backward and the optimizer step."""
    if isinstance(opt, NEWTON_OPTIMIZERS):
        return opt.step(lambda: loss_fn(model, tokens, targets))
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, targets)
    loss.backward()
    if before_step is not None:
        before_step()
    opt.step()
    return loss


def _launched(names) -> int:
    return sum(getattr(kernels, name).launches for name in names)


def train(label, model, loss_fn, opt, tokens, targets, steps_p1, steps_p01,
          per_fit, card, idle_first: bool = False) -> dict:
    """Train on one fixed batch, with the launch counts reset just before
    and read just after; check finite, falling loss and the launch counts
    per fit step (and for KronNewton that every NS launch took the step
    matrix); with ``idle_first`` (pipelined_fit) also that the first step
    fitted nothing and launched none of these kernels.  Times the
    optimizer step apart for KronWhiten; KronNewton's step holds the
    forward and backward, so its step is the train step.  Returns the
    counts (with ``<name>.step_mat`` for the step-matrix counts) and the
    median fit step's time (optimizer step, or KronNewton's whole step)."""
    newton = isinstance(opt, NEWTON_OPTIMIZERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms, opt_ms, fitted = [], [], [], []
    timer = StepTimer(warmup=1, device=opt.device)
    timer.start()
    for step in range(steps_p1 + steps_p01):
        if idle_first and step == 1 and (fitted[0] or _launched(per_fit)):
            raise AssertionError(f"{label}: step 0 fitted {fitted[0]} times "
                                 f"and launched {_launched(per_fit)} kernels")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits0 = opt.fit_steps
        marks = [t0]      # KronWhiten's optimizer step starts after backward

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        loss = _one_step(model, loss_fn, opt, tokens, targets, mark)
        t1 = marks[-1]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        timer.mark()
        losses.append(loss.item())
        step_ms.append((t2 - t0) * 1e3)
        opt_ms.append((t2 - t1) * 1e3)
        fitted.append(opt.fit_steps - fits0)
        log(f"  step {step:2d} p={'1.0' if step < steps_p1 else '0.1'} "
            f"fit={fitted[-1]} loss {losses[-1]:.4f}  step {step_ms[-1]:.1f} ms"
            f"  optimizer {opt_ms[-1]:.1f} ms")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fits = sum(fitted)
    launches = {name: getattr(kernels, name).launches for name in per_fit}
    step_mat = {f.__name__: f.step_mat_launches for f in kernels.STEP_MAT_KERNELS}
    log(f"  {label}: fit steps {fits}; launches {launches}; step-matrix "
        f"launches {step_mat}; peak memory {peak_gb:.2f} GB")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    if fits == 0 or any(launches[k] != n * fits for k, n in per_fit.items()):
        raise AssertionError(f"{label}: launch counts {launches} for {fits} "
                             f"fit steps, expected {per_fit} per fit step")
    expected = {f.__name__: f.launches if newton else 0
                for f in kernels.STEP_MAT_KERNELS}
    if step_mat != expected:
        raise AssertionError(f"{label}: step-matrix launches {step_mat}, "
                             f"expected {expected}")
    fit_opt = [t for t, f in zip(opt_ms[1:], fitted[1:]) if f]
    nofit_opt = [t for t, f in zip(opt_ms[1:], fitted[1:]) if not f]
    what = "train step, Newton" if newton else "optimizer step"
    log(f"  [{card}] {label} {what} (median, first step excluded): "
        f"fit {_median(fit_opt)} ms, no fit {_median(nofit_opt)} ms")
    log(f"  [{card}] {label} train step (median): p=1.0 "
        f"{_median(step_ms[1:steps_p1])} ms, p=0.1 "
        f"{_median(step_ms[steps_p1:])} ms; peak memory {peak_gb:.2f} GB")
    log(f"  [{card}] {label} train step (median, first step excluded): host clock "
        f"{_median(step_ms[1:])} ms, CUDA events (StepTimer) "
        f"{_median([t * 1e3 for t in timer.times])} ms")
    launches.update({f"{k}.step_mat": v for k, v in step_mat.items()})
    return launches, _median(fit_opt)


def _bench_opt(model, mask, steps_p1, dev, **options):
    """KronWhiten in the bench configuration (bench.py:170-177,
    tools/bench_llama.py:108-114), with ``options`` over it."""
    kw = dict(
        lr=1e-3 / 4, weight_decay=0.01,
        momentum=0.9, whiten_grad=False, preconditioner_max_skew=2.0,
        preconditioner_init_scale=1.0,
        preconditioner_update_probability=lambda c: 1.0 if c < steps_p1 else 0.1,
        preconditioner_dtype=torch.bfloat16, momentum_dtype=torch.bfloat16,
        norm_k=128, scanned_layers=mask, device=dev)
    kw.update(options)
    return KronWhiten(model.named_parameters(), **kw)


def gpt2_path(dev, card: str, steps_p1: int = 5, steps_p01: int = 5):
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 4, cfg.block_size, cfg.vocab_size,
        device=dev)
    opt = _bench_opt(model, gpt2.scanned_layers_mask(model), steps_p1, dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"GPT-2 124M ({n_params / 1e6:.1f}M params), batch 4 x "
        f"{cfg.block_size}, bf16 compute, KronWhiten bench configuration")
    launches, _ = train("GPT-2 124M", model, gpt2.loss_gpt2, opt, tokens,
                        targets, steps_p1, steps_p01, GPT2_PER_FIT, card)
    return launches, (model, gpt2.loss_gpt2, opt, tokens, targets)


def llama_path(dev, card: str, steps_p1: int = 3, steps_p01: int = 3):
    cfg = llama.llama_1b(compute_dtype=torch.bfloat16)
    model = llama.Llama(cfg, device=dev, seed=0)
    tokens, targets = llama.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 1, cfg.block_size, cfg.vocab_size,
        device=dev)
    opt = _bench_opt(model, llama.scanned_layers_mask(model), steps_p1, dev)
    log(f"LLaMA-1.1B ({llama.count_params(model) / 1e6:.1f}M params, "
        f"{cfg.n_layer} x {cfg.n_embd}, GQA {cfg.n_head}q/{cfg.n_kv_head}kv, "
        f"SwiGLU {cfg.hidden_dim}, vocab {cfg.vocab_size}), batch 1 x "
        f"{cfg.block_size}, bf16 compute, f32 params, KronWhiten "
        f"bench_llama configuration")
    launches, _ = train("LLaMA-1.1B", model, llama.loss_llama, opt, tokens,
                        targets, steps_p1, steps_p01, LLAMA_PER_FIT, card)
    return launches, (model, llama.loss_llama, opt, tokens, targets)


def gpt2_774m_path(dev, card: str, steps_p1: int = 3, steps_p01: int = 3):
    """GPT-2 774M (36 x 1280, 20 heads) at full width and depth with remat,
    batch 1 x 1024, bf16 compute, f32 parameters, by KronWhiten in
    tools/bench_gpt2_large.py:91-98's configuration (the bench
    configuration: bf16 Q and momentum, norm_k 128)."""
    cfg = gpt2.gpt2_774m(compute_dtype=torch.bfloat16, remat=True)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 1, cfg.block_size, cfg.vocab_size,
        device=dev)
    opt = _bench_opt(model, gpt2.scanned_layers_mask(model), steps_p1, dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"GPT-2 774M ({n_params / 1e6:.1f}M params, {cfg.n_layer} x {cfg.n_embd}, "
        f"{cfg.n_head} heads, remat), batch 1 x {cfg.block_size}, bf16 compute, "
        f"f32 params, KronWhiten bench_gpt2_large configuration")
    launches, _ = train("GPT-2 774M", model, gpt2.loss_gpt2, opt, tokens, targets,
                        steps_p1, steps_p01, GPT2_PER_FIT, card)
    return launches, (model, gpt2.loss_gpt2, opt, tokens, targets)


def vit_path(dev, card: str) -> dict:
    """The ViT example (``examples/vit_cifar10.main``) on the card at its
    JAX configuration (dim 256, depth 4, 8 heads, batch 128), both arms,
    ``VIT_EPOCHS`` x ``VIT_STEPS`` steps on the data the card has (no
    scikit-learn: ``vit.synthetic_cifar``), with the launch counts reset
    just before and read just after: each arm's train loss falls (every
    epoch's mean finite and below its first step's loss), and the
    KronWhiten arm launches ``VIT_PER_FIT`` per fit step exactly (Adam
    none).  Logs each arm's step time and accuracy.  At the example's lr
    1e-3 in bf16 compute the KronWhiten arm can lose its fit in epoch 2
    and regain it or not, with the kernels and with their plain versions
    alike (``vit_stability``; PERF.md, Findings), so the loss is not held
    to fall from epoch to epoch."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = vit_cifar10.main(["--device", str(dev), "--epochs", str(VIT_EPOCHS),
                            "--steps_per_epoch", str(VIT_STEPS)])
    torch.cuda.synchronize()
    launches = {name: getattr(kernels, name).launches for name in VIT_PER_FIT}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fits = 0
    for name, res in out.items():
        losses = res["epoch_losses"]
        log(f"  [{card}] ViT {name}: first loss {res['first_loss']:.4f}, epoch train "
            f"losses {losses}, test accuracy {res['test_acc']:.3f}, step (median, "
            f"host clock) {res['step_ms']:.2f} ms, fit steps {res['fit_steps']}")
        if not all(math.isfinite(x) and x < res["first_loss"] for x in losses):
            raise AssertionError(f"ViT {name}: the train loss did not fall from "
                                 f"{res['first_loss']}: {losses}")
        fits += res["fit_steps"] or 0
    log(f"  ViT: launches {launches} over {fits} fit steps; peak memory {peak_gb:.2f} GB")
    if fits == 0 or any(launches[k] != n * fits for k, n in VIT_PER_FIT.items()):
        raise AssertionError(f"ViT: launch counts {launches} for {fits} fit "
                             f"steps, expected {VIT_PER_FIT} per fit step")
    return launches


# the ViT's KronWhiten arm per step (``vit_stability``): (label, compute
# dtype, lr, plain versions in place of the kernels)
VIT_STABILITY_ARMS = (("kernels", torch.bfloat16, 1e-3, False),
                      ("plain", torch.bfloat16, 1e-3, True),
                      ("kernels, f32 compute", torch.float32, 1e-3, False),
                      ("kernels, lr 3e-4", torch.bfloat16, 3e-4, False))


def vit_stability(dev, card: str) -> dict:
    """Not a gate: the ViT example's KronWhiten arm (seed 42, batches from
    a generator seeded 0, batch 128) for ``VIT_EPOCHS`` x ``VIT_STEPS``
    steps in each of ``VIT_STABILITY_ARMS``, logging every step's loss and
    the test accuracy every 50 steps: whether a loss of fit comes with the
    kernels, with their plain versions on the card, in bf16 compute only,
    or at lr 1e-3 only.  Run it with tools/smoke_paths.py."""
    kernels_of = (kernels.fused_ns_update, kernels.damped_noise)
    test = vit.synthetic_cifar(torch.Generator().manual_seed(999), 1000, device=dev)
    out = {}
    for label, cd, lr, plain in VIT_STABILITY_ARMS:
        if plain:
            kernels.fused_ns_update = kernels.fused_ns_update_plain
            kernels.damped_noise = kernels.damped_noise_plain
        try:
            model = vit.ViT(vit.ViTConfig(compute_dtype=cd), device=dev, seed=42)
            opt = KronWhiten(model.named_parameters(), lr=lr, momentum=0.9,
                             preconditioner_max_skew=2.0, device=dev,
                             scanned_layers=vit.scanned_layers_mask(model))
            gen, losses, accs = torch.Generator().manual_seed(0), [], []
            for i in range(VIT_EPOCHS * VIT_STEPS):
                x, y = vit.synthetic_cifar(gen, vit_cifar10.BATCH, device=dev)
                opt.zero_grad(set_to_none=True)
                loss = vit.loss_vit(model, x, y)
                loss.backward()
                opt.step()
                losses.append(loss.item())
                if (i + 1) % 50 == 0:
                    with torch.no_grad():
                        accs.append(float((model(test[0]).argmax(1) == test[1])
                                          .float().mean()))
        finally:
            kernels.fused_ns_update, kernels.damped_noise = kernels_of
        means = [round(float(np.mean(losses[i:i + 20])), 4) for i in range(0, len(losses), 20)]
        log(f"  [{card}] ViT KronWhiten ({label}): means of 20 steps {means}; test "
            f"accuracy every 50 steps {accs}; every step's loss: "
            + " ".join(f"{x:.4f}" for x in losses))
        out[label] = losses
    return out


def _state_size(opt, key: str) -> tuple[int, int]:
    """(entries, bytes) of the optimizer state's ``key`` tensors."""
    ts = [t for p in opt.param_groups[0]["params"] for t in opt.state[p].get(key, ())]
    return sum(t.numel() for t in ts), sum(t.numel() * t.element_size() for t in ts)


def _copied(tree):
    """A state_dict with every tensor cloned (a step updates some in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _copied(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copied(v) for v in tree)
    return tree


def _snapshot(opt) -> dict:
    """Copies of the parameters and of the optimizer's whole state
    (``state_dict()``: per-parameter state, count, key, fit_steps)."""
    params = opt.param_groups[0]["params"]
    return dict(params=[p.detach().clone() for p in params],
                opt=_copied(opt.state_dict()))


@torch.no_grad()
def _restore(opt, snap) -> None:
    """The parameters and the optimizer's state as in the snapshot
    (``load_state_dict`` copies it again).  A twin without cache_p (the
    uncached one) reads the snapshot's Q and drops its cache."""
    for p, p0 in zip(opt.param_groups[0]["params"], snap["params"]):
        p.copy_(p0)
    state = snap["opt"]
    if state["psgd"]["layout"]["cache_p"] and not opt.cache_p:
        psgd = dict(state["psgd"], layout=dict(state["psgd"]["layout"], cache_p=False))
        state = dict(state, psgd=psgd, state={
            i: {k: v for k, v in st.items() if k != "pcache"}
            for i, st in state["state"].items()})
    opt.load_state_dict(state)


def _update_from(opt, snap, grads, prob) -> list:
    """One step of ``opt`` from the snapshot on ``grads`` at update
    probability ``prob``, with lr 1 and no weight decay: each parameter
    then moves by minus its preconditioned, clipped update, which is
    returned."""
    _restore(opt, snap)
    params = opt.param_groups[0]["params"]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt.param_groups[0].update(lr=1.0, weight_decay=0.0,
                               preconditioner_update_probability=prob)
    opt.step()
    return [p0 - p.detach() for p, p0 in zip(params, snap["params"])]


def _amplification(opt, i, pc, m) -> tuple[float, float]:
    """How the shared update's damping noise n = (damping + eps|m|) v (v
    unit normal, bf16 eps) passes through P = the pre-update cached P_i
    of leaf i: E||P n||^2 = sum_j (damping + eps|m_j|)^2 c_j exactly, c_j
    the product over dims of the squared column norms of P_i at j's index
    (squared entries for a diagonal P_i).  Returns (r_n, a): the expected
    noise over ||P m||, and how much P lifts the noise's relative size over
    its size at the input (at least 1), the larger over the layers of a
    stack (whose layers are clipped apart)."""
    plan, stacked = opt.plans[i], opt.scanned[i]
    lead = (m.shape[0],) if stacked else ()
    mf = m.float().reshape(lead + plan.shape)
    pcf = tuple(f.float() for f in pc)
    apply = (kron_p.precond_grad_cached_stacked if stacked
             else kron_p.precond_grad_cached)
    cols = tuple(f * f if diag else (f * f).sum(-2)
                 for f, diag in zip(pcf, plan.is_diag))
    s = (1e-9 + EPS_BF16 * mf.abs()) ** 2
    dims = tuple(range(len(lead), mf.ndim))
    noise = apply(cols, plan, s).sum(dims)       # diagonal factors: products
    signal = (apply(pcf, plan, mf) ** 2).sum(dims)
    r_n = (noise / signal).sqrt()
    r_in = (s.sum(dims) / (mf ** 2).sum(dims)).sqrt()
    return r_n.max().item(), max(1.0, (r_n / r_in).max().item())


def check_twins(model, loss_fn, opt, tokens, targets, mask, dev) -> None:
    """Arm A against its twins from one state (its own after training), on
    one gradient, with lr 1 and no decay so the step's update is read off
    the parameters.

    Fit step (p = 1): A's update is the fit's P (m + (damping + eps|m|) v)
    where the unshared twin (no share_fit_apply) applies P m through the
    cache; the fit itself is the same on both (same Q', bit for bit).  Per
    leaf the difference is the noise carried through P, expected r_n =
    sqrt(E||P n||^2) / ||P m|| (``_amplification``; eps = 2^-7 makes r_n
    about 0.8 % where P treats the noise as it treats m), plus bf16
    rounding: k = 4 order + 1 roundings to bf16 on the two chains (the
    damped input; 2 order products on A's Q then Q^T chain; order P_i and
    order products on the twin's), each a relative error of RMS u / sqrt(3)
    (u = 2^-8), lifted by P at most as the noise is (a).  The gate is 3
    sigma of their sum, 3 sqrt(r_n^2 + k (a u)^2 / 3), and never above
    TWIN_CAP (the JAX package's test_shared_noise_bounded_in_bf16 bound).

    No-fit step (p = 0): A applies through the cached P_i where the
    uncached twin (no cache_p) takes Q then Q^T: 4 order roundings, no
    noise, gate sqrt(3 * 4 order) a u (at most TWIN_CAP).

    After A's fit its cache equals Q^T Q recomputed in f32 to bf16
    rounding (``_within_order``)."""
    params = opt.param_groups[0]["params"]
    group = dict(opt.param_groups[0])
    opt.zero_grad(set_to_none=True)
    loss_fn(model, tokens, targets).backward()
    grads = [p.grad.detach().clone() for p in params]
    snap = _snapshot(opt)
    unshared = _bench_opt(model, mask, 0, dev, **dict(ARM_OPTIONS["A"],
                                                      share_fit_apply=False))
    uncached = _bench_opt(model, mask, 0, dev, **dict(ARM_OPTIONS["A"],
                                                      cache_p=False))
    fit_a = _update_from(opt, snap, grads, 1.0)
    moms = [opt.state[p]["mu"].clone() for p in params]
    after = {k: [opt.state[p][k] for p in params] for k in ("q", "pcache")}
    bad_cache = [i for i, (qs, pcs) in enumerate(zip(after["q"], after["pcache"]))
                 if not all(_within_order(pc, q.float() ** 2 if diag else
                                          q.float().mT @ q.float())
                            for q, pc, diag in zip(qs, pcs, opt.plans[i].is_diag))]
    fit_u = _update_from(unshared, snap, grads, 1.0)
    same_fit = all(torch.equal(a, b) for p, qa in zip(params, after["q"])
                   for a, b in zip(qa, unshared.state[p]["q"]))
    nofit_a = _update_from(opt, snap, grads, 0.0)
    nofit_n = _update_from(uncached, snap, grads, 0.0)
    worst, bad = {}, []
    for i, p in enumerate(params):
        r_n, amp = _amplification(opt, i, snap["opt"]["state"][i]["pcache"], moms[i])
        order = opt.plans[i].order
        bounds = {"fit": min(TWIN_CAP, 3 * math.sqrt(
                      r_n ** 2 + (4 * order + 1) * (amp * U_BF16) ** 2 / 3)),
                  "no fit": min(TWIN_CAP, math.sqrt(12 * order) * amp * U_BF16)}
        for what, (a, b) in (("fit", (fit_a[i], fit_u[i])),
                             ("no fit", (nofit_a[i], nofit_n[i]))):
            rel = _rel(a, b)
            if rel > bounds[what]:
                bad.append((what, i, rel, bounds[what]))
            if rel / bounds[what] > worst.get(what, (0,))[0]:
                worst[what] = (rel / bounds[what], i, rel, bounds[what], r_n, amp)
    for what, (share, i, rel, bound, r_n, amp) in worst.items():
        log(f"  arm A {what} step vs its {'unshared' if what == 'fit' else 'uncached'} "
            f"twin: largest share of the gate {share:.3f} at leaf {i} "
            f"(plan {opt.plans[i].shape}): rel diff {rel:.3e}, gate {bound:.3e} "
            f"(r_n {r_n:.3e}, a {amp:.2f})")
    log(f"  arm A after its fit: cache = Q^T Q (f32) to bf16 rounding on every "
        f"leaf {not bad_cache}; the unshared twin fitted the same Q' bit for bit "
        f"{same_fit}")
    if bad or bad_cache or not same_fit:
        raise AssertionError(f"arm A against its twins: {bad}, cache off on leaves "
                             f"{bad_cache}, same fit {same_fit}")
    _restore(opt, snap)      # arm A as it was, for the profile
    opt.param_groups[0].update(group)


def options_path(dev, card: str, steps_p1: int = 3, steps_p01: int = 3):
    """GPT-2 124M at full width and depth, batch 4 x 1024, bf16 compute,
    the bench configuration with the production recipe's options
    (``ARM_OPTIONS``), a fresh model and optimizer each: C (shared_layers)
    and A (share_fit_apply, apply first, cache_p) at p = 1 for steps_p1
    steps and 0.1 for steps_p01, B (pipelined_fit) at a literal p = 1.0 for
    as many steps in all.  B, C, then A, whose state the profile reads.
    Returns the three arms' launch counts summed and A's state."""
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 4, cfg.block_size, cfg.vocab_size,
        device=dev)
    total, sizes = {}, {}
    for arm, per_fit in (("B", GPT2_PER_FIT), ("C", GPT2_SHARED_PER_FIT),
                         ("A", GPT2_PER_FIT)):
        model = gpt2.GPT2(cfg, device=dev, seed=0)
        mask = gpt2.scanned_layers_mask(model)
        opt = _bench_opt(model, mask, steps_p1, dev, **ARM_OPTIONS[arm])
        label = f"GPT-2 124M options arm {arm}"
        log(f"{label}: bench configuration with {ARM_OPTIONS[arm]}")
        literal = arm == "B"
        launches, _ = train(label, model, gpt2.loss_gpt2, opt, tokens, targets,
                            steps_p1 + steps_p01 if literal else steps_p1,
                            0 if literal else steps_p01, per_fit, card,
                            idle_first=literal)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        sizes[arm] = {key: _state_size(opt, key) for key in ("q", "pcache")}
        log(f"  [{card}] {label} state: Q {sizes[arm]['q'][0] / 1e6:.2f}M entries, "
            f"{sizes[arm]['q'][1] / 1e6:.1f} MB; cache {sizes[arm]['pcache'][0] / 1e6:.2f}M "
            f"entries, {sizes[arm]['pcache'][1] / 1e6:.1f} MB")
        if arm == "C":
            if any(opt.scanned):
                raise AssertionError("arm C: a stack was fitted per layer")
            profile_steps(label, (model, gpt2.loss_gpt2, opt, tokens, targets),
                          card, (1.0,))
        if arm == "A":
            check_twins(model, gpt2.loss_gpt2, opt, tokens, targets, mask, dev)
            return total, (model, gpt2.loss_gpt2, opt, tokens, targets)
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()


def _newton_opt(model, mask, steps_p1, dev, qdtype=None, dq="Q0.5EQ1.5", **options):
    """KronNewton in the Newton arm of tools/measure_cache_p_tpu.py:134-140
    (lr 1e-3, max_skew 2, init scale 1, norm_k 128, global-norm clip 10,
    one preconditioner per layer), p = 1 for the first steps_p1 steps and
    0.1 after; Q in ``qdtype`` (None: the parameters' f32), geometry
    ``dq``."""
    return KronNewton(
        model.named_parameters(), lr=1e-3, preconditioner_max_skew=2.0,
        preconditioner_init_scale=1.0,
        preconditioner_update_probability=lambda c: 1.0 if c < steps_p1 else 0.1,
        norm_k=128, grad_clip_max_norm=10.0, preconditioner_dtype=qdtype,
        scanned_layers=mask, device=dev, dq=dq, **options)


def time_hvp(label, state, card: str, fit_ms) -> None:
    """The exact Hvp pass alone (gradient and H v, math attention) and one
    plain gradient pass, host clock around synchronized calls, best of 2;
    the Hvp's share of the median fit step."""
    model, loss_fn, opt, tokens, targets = state
    params = opt.param_groups[0]["params"]
    vs = hvp.rand_like(opt.key, params)
    closure = lambda: loss_fn(model, tokens, targets)

    def best(fn):
        out = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return min(out)

    hvp_ms = best(lambda: hvp.hvp_exact(closure, params, vs))
    with torch.enable_grad():
        grad_ms = best(lambda: hvp.gradients(closure(), params))
    share = f"{hvp_ms / fit_ms:.3f}" if fit_ms else "not measured"
    log(f"  [{card}] {label} Hvp pass (gradient + H v, {hvp.HVP_ATTENTION.name} "
        f"attention) {hvp_ms:.1f} ms, plain gradient pass {grad_ms:.1f} ms; "
        f"Hvp share of the fit step {share}")
    del vs


def newton_path(name, dev, card: str, steps_p1: int = 3, steps_p01: int = 3):
    """Newton path B (GPT-2 124M, f32 Q, batch 2 x 1024, the single route)
    or A (LLaMA-1.1B, bf16 Q, batch 1 x 1024, the split and tiled routes)."""
    if name == "gpt2":
        cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
        model = gpt2.GPT2(cfg, device=dev, seed=0)
        batch, loss_fn, mask = 2, gpt2.loss_gpt2, gpt2.scanned_layers_mask(model)
        label, per_fit, qdtype = "GPT-2 124M Newton", GPT2_NEWTON_PER_FIT, None
        make_batch = gpt2.synthetic_lm_batch
    else:
        cfg = llama.llama_1b(compute_dtype=torch.bfloat16)
        model = llama.Llama(cfg, device=dev, seed=0)
        batch, loss_fn, mask = 1, llama.loss_llama, llama.scanned_layers_mask(model)
        label, per_fit, qdtype = ("LLaMA-1.1B Newton", LLAMA_NEWTON_PER_FIT,
                                  torch.bfloat16)
        make_batch = llama.synthetic_lm_batch
    tokens, targets = make_batch(torch.Generator().manual_seed(1), batch,
                                 cfg.block_size, cfg.vocab_size, device=dev)
    opt = _newton_opt(model, mask, steps_p1, dev, qdtype)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{label} ({n_params / 1e6:.1f}M params), batch {batch} x "
        f"{cfg.block_size}, bf16 compute, {qdtype or torch.float32} Q, KronNewton "
        f"(Newton arm of tools/measure_cache_p_tpu.py), exact Hvp by double "
        f"backward with attention on the {hvp.HVP_ATTENTION.name} backend for "
        f"that pass")
    # one plain gradient pass first, untimed: the fit steps run the math
    # attention, so the first no-fit step would otherwise build the default
    # attention's plans for this shape inside its timing
    with torch.enable_grad():
        hvp.gradients(loss_fn(model, tokens, targets), list(model.parameters()))
    launches, fit_ms = train(label, model, loss_fn, opt, tokens, targets,
                             steps_p1, steps_p01, per_fit, card)
    state = (model, loss_fn, opt, tokens, targets)
    time_hvp(label, state, card, fit_ms)
    return launches, state


def geometry_path(dev, card: str, newton: bool) -> dict:
    """The six geometries besides Q0.5EQ1.5 on GPT-2 124M at full width and
    depth, one arm each (a fresh model and optimizer): KronWhiten in the
    bench configuration (``_bench_opt``, batch 4 x 1024, bf16 Q but f32
    for QUAD4P and PRO4P), 3 steps at p = 1 then 2 at 0.1, or KronNewton
    in the Newton arm (``_newton_opt``, f32 Q, batch 2 x 1024, exact Hvp),
    2 steps at p = 1 then 3 at 0.1 (seed 0's gate fits at counts 2 and 3,
    so the fifth step is the one without a fit).  Each arm holds its launch counts per
    fit step exactly (``GPT2_GEOMETRY_PER_FIT``,
    ``GPT2_NEWTON_GEOMETRY_PER_FIT``) and logs its Q size and, for PRO4P,
    the Procrustes loop's steps that changed a layer (its 10 masked steps
    per dense factor are the tsub and skew norm_bound launches); a
    whitening arm's fit step is profiled, the bf16 arms failing on any
    FFMA ``gemm_kernel``.  Returns the arms' launch counts summed."""
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    batch = 2 if newton else 4
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(1), batch, cfg.block_size, cfg.vocab_size,
        device=dev)
    steps_p1, steps_p01 = (2, 3) if newton else (3, 2)
    total = {}
    for dq in GEOMETRIES:
        model = gpt2.GPT2(cfg, device=dev, seed=0)
        mask = gpt2.scanned_layers_mask(model)
        if newton:
            qdt, per_fit = torch.float32, GPT2_NEWTON_GEOMETRY_PER_FIT[dq]
            opt = _newton_opt(model, mask, steps_p1, dev, dq=dq)
            label = f"GPT-2 124M Newton {dq}"
            with torch.enable_grad():   # untimed, as newton_path's
                hvp.gradients(gpt2.loss_gpt2(model, tokens, targets),
                              list(model.parameters()))
        else:
            qdt, per_fit = GEOMETRY_QDTYPE[dq], GPT2_GEOMETRY_PER_FIT[dq]
            opt = _bench_opt(model, mask, steps_p1, dev, dq=dq,
                             preconditioner_dtype=qdt)
            label = f"GPT-2 124M {dq}"
        log(f"{label}: batch {batch} x {cfg.block_size}, bf16 compute, {qdt} Q, "
            f"{'KronNewton Newton arm' if newton else 'KronWhiten bench configuration'}"
            f" with dq={dq!r}")
        linalg.procrustes_loop3.layer_steps = 0
        launches, _ = train(label, model, gpt2.loss_gpt2, opt, tokens, targets,
                            steps_p1, steps_p01, per_fit, card)
        entries, nbytes = _state_size(opt, "q")
        loop = ""
        if dq == "PRO4P":
            taken = int(linalg.procrustes_loop3.layer_steps)
            loop = (f"; Procrustes loop: {launches['tsub']} masked steps run "
                    f"(stack-wide), {taken} steps taken by a layer")
        log(f"  [{card}] {label} state: Q {entries / 1e6:.2f}M entries, "
            f"{nbytes / 1e6:.1f} MB{loop}")
        if not newton:
            profile_steps(label, (model, gpt2.loss_gpt2, opt, tokens, targets),
                          card, (1.0,), tensor_cores=qdt == torch.bfloat16)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
    return total


def lra_gpt2_path(dev, card: str) -> dict:
    """GPT-2 124M at its published widths (random weights from seed 0, f32
    parameters, bf16 compute) with one LRA preconditioner (rank 10, f32)
    over the whole parameter vector, n its parameter count: LRAWhiten with
    the JAX class defaults and the recipe of __graft_entry__.py:164-167
    (momentum 0.9, lr 1e-3, init scale 1), batch 4 x 1024, 3 steps at p =
    1 then 3 at 0.1; LRANewton (lr 1e-3, global-norm clip 10, init scale 1,
    exact Hvp), batch 2 x 1024, 2 steps at p = 1 then 3 at 0.1.  A fresh
    model each; exact counts (``LRA_WHITEN_PER_FIT``,
    ``GPT2_LRA_NEWTON_PER_FIT``), peak memory, a profiled fit step, and the
    fit step's (n, r) passes (``LRA_FIT_PASSES``) at the HBM rate beside
    the step's bytes bound (U and V read and written once).  Returns the
    two arms' launch counts summed."""
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    total = {}
    for name, batch, (p1, p01) in (("LRAWhiten", 4, (3, 3)), ("LRANewton", 2, (2, 3))):
        model = gpt2.GPT2(cfg, device=dev, seed=0)
        tokens, targets = gpt2.synthetic_lm_batch(
            torch.Generator().manual_seed(1), batch, cfg.block_size,
            cfg.vocab_size, device=dev)
        n = sum(p.numel() for p in model.parameters())
        prob = lambda c, p1=p1: 1.0 if c < p1 else 0.1
        if name == "LRAWhiten":
            opt = LRAWhiten(model.named_parameters(), lr=1e-3, momentum=0.9,
                            rank_of_approximation=LRA_RANK,
                            preconditioner_init_scale=1.0,
                            preconditioner_update_probability=prob, device=dev)
            per_fit = LRA_WHITEN_PER_FIT
        else:
            opt = LRANewton(model.named_parameters(), lr=1e-3,
                            rank_of_approximation=LRA_RANK, grad_clip_max_norm=10.0,
                            preconditioner_init_scale=1.0,
                            preconditioner_update_probability=prob, device=dev)
            per_fit = GPT2_LRA_NEWTON_PER_FIT
            with torch.enable_grad():   # untimed, as newton_path's
                hvp.gradients(gpt2.loss_gpt2(model, tokens, targets),
                              list(model.parameters()))
        label = f"GPT-2 124M {name}"
        st = opt.precond
        state_gb = sum(t.numel() * t.element_size() for t in st) / 1e9
        log(f"{label}: n = {n} parameters ({n / 1e6:.2f}M) in one vector, rank "
            f"{st.rank}, U and V {st.u.numel() * st.u.element_size() / 1e9:.2f} GB "
            f"each ({state_gb:.2f} GB of LRA state, {st.u.dtype}), batch {batch} x "
            f"{cfg.block_size}, bf16 compute")
        launches, fit_ms = train(label, model, gpt2.loss_gpt2, opt, tokens, targets,
                                 p1, p01, per_fit, card)
        nr = n * st.rank * st.u.element_size()
        lo, hi = ((LRA_FIT_PASSES[0] + LRA_APPLY_PASSES) * nr,
                  (LRA_FIT_PASSES[1] + LRA_APPLY_PASSES) * nr)
        least = 4 * nr
        log(f"  [{card}] {label} fit step: (n, r) passes {LRA_FIT_PASSES[0]}-"
            f"{LRA_FIT_PASSES[1]} (fit) + {LRA_APPLY_PASSES} (apply) move "
            f"{lo / 1e9:.1f}-{hi / 1e9:.1f} GB, {lo / PEAK_BYTES * 1e3:.1f}-"
            f"{hi / PEAK_BYTES * 1e3:.1f} ms at {PEAK_BYTES / 1e12:.2f} TB/s; the "
            f"step's bytes bound (U and V read and written once) {least / 1e9:.1f} GB, "
            f"{least / PEAK_BYTES * 1e3:.1f} ms; median fit "
            f"{'train' if name == 'LRANewton' else 'optimizer'} step {fit_ms} ms")
        profile_steps(label, (model, gpt2.loss_gpt2, opt, tokens, targets), card,
                      (1.0, 0.0), tensor_cores=False)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del model, opt, st
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _closure_arm(label, opt, loss, steps, per_fit, card, fall=1.0) -> tuple:
    """Drive a closure optimizer ``steps`` steps, the launch counts reset
    just before and read just after; fail on a non-finite loss, a last loss
    not ``fall`` times below the first, or other counts than ``per_fit``
    per fit step.  Returns (counts, first loss, last loss, ms per step)."""
    core = getattr(opt, "optimizer", opt)   # a closure class wraps one
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fits0, losses = core.fit_steps, []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(opt.step(loss).detach())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    fits = core.fit_steps - fits0
    counts = {k: getattr(kernels, k).launches for k in per_fit}
    first, last = losses[0].item(), losses[-1].item()
    log(f"  [{card}] {label}: loss {first:.6g} -> {last:.6g} in {steps} steps "
        f"({first / last:.3g}x), {ms:.2f} ms per step; fit steps {fits}; launches {counts}")
    _falls(label, first, last, fall)
    if fits == 0 or any(counts[k] != v * fits for k, v in per_fit.items()):
        raise AssertionError(f"{label}: launch counts {counts} for {fits} fit steps, "
                             f"expected {per_fit} per fit step")
    return counts, first, last, ms


def cp_path(dev, card: str) -> dict:
    """The reference showcase (examples/tensor_rank_decomposition.py:20-37,
    demo_usage_of_all_preconditioners.py): the rank-10 CP decomposition of
    a 20 x 50 x 100 tensor, n = 1700, f32, with the example's settings
    (``_cp_opt``), by DenseNewton in each of the six geometries besides
    Q0.5EQ1.5 for CP_GEOMETRY_STEPS; every arm from the same start, every
    step a fit (the example's own arms, Q0.5EQ1.5 among them, run in
    ``examples_path``).  Gates: the loss falls on every arm; exact counts
    (``_flat_per_fit``).  Returns the arms' launch counts summed."""
    total = {}
    for dq in GEOMETRIES:
        params, loss = cp_problem(*CP_FULL, dev)
        n = sum(p.numel() for p in params)
        opt = _cp_opt(params, dev, dq)
        counts, *_ = _closure_arm(f"tensor-rank (n = {n}) DenseNewton {dq}", opt, loss,
                                  CP_GEOMETRY_STEPS, _flat_per_fit(CP_LEAVES, dq), card)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del params, opt
    torch.cuda.empty_cache()
    return total


def rosenbrock_path(dev, card: str) -> dict:
    """examples/hello_psgd.py: the coupled Rosenbrock function of
    ROSENBROCK_N = 100 variables from 0 (f(0) = 50), f32, by the
    ``DenseNewton`` class of optim.classes (lr_params 1, lr_preconditioner
    0.5, momentum 0.9), ROSENBROCK_CLASS_STEPS steps; gate: the loss falls by
    ROSENBROCK_FALL or more.  Returns its launch counts."""
    x = torch.zeros(ROSENBROCK_N, device=dev, requires_grad=True)
    opt = classes.DenseNewton([x], lr_params=1.0, lr_preconditioner=0.5,
                              momentum=0.9, device=dev)
    counts, first, last, _ = _closure_arm(
        f"Rosenbrock (n = {ROSENBROCK_N}) DenseNewton class", opt,
        lambda: hello_psgd.rosenbrock(x), ROSENBROCK_CLASS_STEPS,
        _flat_per_fit(1, "Q0.5EQ1.5"),
        card, ROSENBROCK_FALL)
    log(f"  [{card}] Rosenbrock final loss {last:.3e} (from {first:g})")
    return counts


def _arm_counts(per_fit: dict, fits) -> dict:
    """The launches ``per_fit`` per fit step over ``fits`` fit steps."""
    return {k: v * (fits or 0) for k, v in per_fit.items()}


def _expect(label: str, counted: dict, expected: list) -> dict:
    """Fail unless the launches counted over a run equal the sum of its
    arms' ``_arm_counts`` (and it launched something); returns them."""
    want = {}
    for arm in expected:
        for k, v in arm.items():
            want[k] = want.get(k, 0) + v
    got = {k: counted.get(k, 0) for k in want}
    log(f"  {label}: launches {got}")
    if not any(want.values()) or got != want:
        raise AssertionError(f"{label}: launch counts {got}, expected {want}")
    return got


def _falls(label: str, first: float, last: float, fall: float = 1.0) -> None:
    if not (math.isfinite(first) and math.isfinite(last) and last * fall < first):
        raise AssertionError(f"{label}: loss {first} -> {last}, expected a finite "
                             f"fall of at least {fall}x")


def _example(label: str, run, per_arm, card: str) -> tuple:
    """Run an example's ``main`` (``run()``), the launch counts reset just
    before and read just after; ``per_arm(result)`` lists the launches its
    arms should have made.  Returns (its result, the launches)."""
    phase(f"examples path: {label}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, _expect(f"[{card}] {label}", _all_counts(), per_arm(out))


def examples_path(dev, card: str) -> dict:
    """The five examples of psgd_torch_tpu_torch/examples ported from the
    JAX examples, each ``main`` on the card at its published sizes, only
    its steps cut (``EXAMPLE_*``), the launch counts reset just before and
    read just after each: per example its arms' launches per fit step
    exactly (``_flat_per_fit``, ``_geometry_per_fit``).
    - hello_psgd: ``dense_newton`` on the 100-variable Rosenbrock function,
      2000 iterations; f falls by ROSENBROCK_FALL or more.
    - tensor_rank_decomposition: its five arms, CP_STEPS steps each after
      one outside the clock; every PSGD arm's loss finite and falling,
      DenseNewton's and KronNewton's by CP_FALL or more.
    - logistic_regression: its three arms, EXAMPLE_LOGISTIC_EPOCHS epochs
      of 50 steps of 256 (W (33153, 10), 331,530 parameters); the PSGD
      arm's epoch losses finite and below its first step's.
    - flat_minima_mdl: Adam and KronWhiten on LeNet5, then the rank-10 LRA
      log-det fit at each solution (``EXAMPLE_MDL_STEPS``); the KronWhiten
      arm's loss finite and falling, both log-dets finite.
    - xor_rnn: the RNN by KronWhiten and the LSTM by KronNewton, each to at
      most ``EXAMPLE_XOR_ITERS`` iterations; every loss finite, the mean of
      the last ``XOR_WINDOW`` not above chance (ln 2 + XOR_CHANCE_MARGIN),
      the LSTM's below that of its first ``XOR_WINDOW``.
    Logged, not gated: whether the XOR cells were solved, the PSGD arms
    beside SGD, L-BFGS and Adam, each arm's ms per iteration (host clock).
    Returns the launches summed."""
    total = {}
    dev_arg = ["--device", str(dev)]
    res, counts = _example("hello_psgd", lambda: hello_psgd.main(
        dev_arg + ["--iters", str(ROSENBROCK_STEPS)]),
        lambda r: [_arm_counts(_flat_per_fit(1, "Q0.5EQ1.5"), r["fit_steps"])], card)
    _add(total, counts)
    log(f"  [{card}] hello_psgd: f {res['first']:g} -> {res['final']:.3e}, "
        f"{res['ms_per_it']:.2f} ms/it")
    _falls("hello_psgd", res["first"], res["final"], ROSENBROCK_FALL)

    per = {"DenseNewton": _flat_per_fit(CP_LEAVES, "Q0.5EQ1.5"),
           "LRANewton": _flat_per_fit(CP_LEAVES), "KronNewton": CP_KRON_PER_FIT}
    res, counts = _example("tensor_rank_decomposition", lambda: tensor_rank_decomposition.main(
        dev_arg + ["--iters", str(CP_STEPS)]),
        lambda r: [_arm_counts(p, r[name]["fit_steps"]) for name, p in per.items()]
        + [LRA_INIT], card)
    _add(total, counts)
    for name, r in res.items():
        log(f"  [{card}] tensor-rank {name}: loss {r['start']:.6g} -> {r['final']:.6g} "
            f"({r['start'] / r['final']:.3g}x; min {r['min']:.6g}), "
            f"{r['ms_per_it']:.2f} ms/it")
    for name in per:
        _falls(f"tensor-rank {name}", res[name]["start"], res[name]["final"],
               1.0 if name == "LRANewton" else CP_FALL)

    res, counts = _example("logistic_regression", lambda: logistic_regression.main(
        dev_arg + ["--epochs", str(EXAMPLE_LOGISTIC_EPOCHS)]),
        lambda r: [_arm_counts(LRA_WHITEN_PER_FIT, r["psgd-lra"]["fit_steps"]), LRA_INIT],
        card)
    _add(total, counts)
    for name, r in res.items():
        log(f"  [{card}] logistic {name}: first loss {r['first']:.4f}, epoch losses "
            f"{[round(x, 4) for x in r['epoch_losses']]}, best test err "
            f"{r['best_err']:.4f}, {r['ms_per_it']:.2f} ms/it")
    for x in res["psgd-lra"]["epoch_losses"]:
        _falls("logistic psgd-lra", res["psgd-lra"]["first"], x)

    train_steps, hess_steps = EXAMPLE_MDL_STEPS
    res, counts = _example("flat_minima_mdl", lambda: flat_minima_mdl.main(
        dev_arg + ["--train_steps", str(train_steps), "--hess_steps", str(hess_steps)]),
        lambda r: [_arm_counts(MDL_KRON_PER_FIT, r["psgd-kron"]["fit_steps"]),
                   _arm_counts(_flat_per_fit(1), 2 * hess_steps), LRA_INIT, LRA_INIT],
        card)
    _add(total, counts)
    for name, r in res.items():
        log(f"  [{card}] flat minima {name}: loss {r['first_loss']:.4f} -> "
            f"{r['train_loss']:.4f}, log det(H) ~ {r['logdet_h']:.1f}, "
            f"{r['ms_per_it']:.2f} ms/step, log-det fit {r['fit_ms']:.2f} ms/fit")
        if not math.isfinite(r["logdet_h"]):
            raise AssertionError(f"flat minima {name}: log det {r['logdet_h']}")
    _falls("flat minima psgd-kron", res["psgd-kron"]["first_loss"],
           res["psgd-kron"]["train_loss"])

    for cell, iters in EXAMPLE_XOR_ITERS.items():
        res, counts = _example(f"xor_rnn --cell {cell}", lambda: xor_rnn.main(
            dev_arg + ["--cell", cell, "--max_iters", str(iters)]),
            lambda r: [_arm_counts(XOR_PER_FIT[cell], r["fit_steps"])], card)
        _add(total, counts)
        solved = (f"solved at iteration {res['solved_at']}" if res["solved_at"] is not None
                  else f"not solved in {iters} iterations")
        ls = res["losses"]
        first, last = (sum(w) / len(w) for w in (ls[:XOR_WINDOW], ls[-XOR_WINDOW:]))
        log(f"  [{card}] xor_rnn {cell}: {solved}; loss {res['first']:.4f} -> "
            f"{res['final']:.4f} (means of the first and last {XOR_WINDOW}: "
            f"{first:.4f}, {last:.4f}), {res['ms_per_it']:.2f} ms/it")
        if not all(map(math.isfinite, ls)) or last >= math.log(2) + XOR_CHANCE_MARGIN:
            raise AssertionError(f"xor_rnn {cell}: the losses are not finite or sit "
                                 f"above chance (the last {XOR_WINDOW}'s mean {last})")
        if cell in XOR_FALLS:
            _falls(f"xor_rnn {cell} (means of the first and last {XOR_WINDOW})",
                   first, last)
    return total


def _bench_ns_widths():
    """tools/bench_ns_widths_torch.py as a module (tools/ is no package)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "tools" / "bench_ns_widths_torch.py"
    spec = importlib.util.spec_from_file_location("bench_ns_widths_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ns_widths_path(dev, card: str, records: list | None = None) -> dict:
    """tools/bench_ns_widths_torch.py's ``sweep`` at the widths no other
    path holds (``NS_WIDTHS``), once in bf16 and once in f32, each width on
    the route ``kernels.ns_route`` picks (single, split or tiled; the
    single route above the caps), the launch counts reset just before and
    read just after.  Gates: every width ran its route, q' and L' within
    ``kernels.ROUTE_TOL`` of the plain version and the spd bound at most
    1.001 x the true norm.  Logs each width's ms, TFLOP/s, share of the
    peak, bound and plain ms, and appends the records to ``records``.
    Returns the launches."""
    bench = _bench_ns_widths()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    records = [] if records is None else records
    for dtype, sizes in NS_WIDTHS.items():
        for rec in bench.sweep(sizes, dtype, dev):
            log("  " + bench.describe(rec, card))
            if rec["error"] or rec["route"] != kernels.ns_route(rec["n"], dtype) \
                    or not rec["within"]:
                raise AssertionError(f"NS sweep n = {rec['n']} {dtype}: {rec}")
            records.append(rec)
    torch.cuda.synchronize()
    launches = _all_counts()
    log(f"  NS sweep: launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the legacy families (ROADMAP A7)
# ---------------------------------------------------------------------------

# card against CPU, one update chain and one apply from the same inputs:
# float64 within LEGACY_F64_REL, float32 within LEGACY_F32_REL, 12x the
# worst float32 reading of the first card run (8.0e-7, Affine drop-v
# dense/dense; the worst float64 one 1.8e-15; PERF.md §6, the legacy
# families' entry)
LEGACY_F64_REL = 1e-10
LEGACY_F32_REL = 1e-5
LEGACY_SHAPE = (401, 120)     # LeNet5's fc1 [W; b]
LEGACY_DENSE_N = 512
LEGACY_N = 4096               # the vector families' n (4097: the odd XMat)
LEGACY_RANK = 10
# the JAX tests' own convergence cases (tests/test_legacy_transforms.py:24-38)
LEGACY_CASES = (("xmat-whiten", "xmat", {}, False, (32,)),
                ("xmat-newton", "xmat", {"preconditioner_type": "Newton"}, True, (32,)),
                ("splu-whiten", "splu", {"rank": 5}, False, (32,)),
                ("splu-newton", "splu", {"rank": 5, "preconditioner_type": "Newton"},
                 True, (32,)),
                ("newton_inv", "newton_inv", {"preconditioner_type": "Newton"}, True,
                 (32,)),
                ("uvd-whiten", "uvd", {"rank": 5}, False, (32,)),
                ("uvd-newton", "uvd", {"rank": 5, "preconditioner_type": "Newton"},
                 True, (32,)),
                ("affine-whiten", "affine", {}, False, (8, 4)),
                ("affine-newton", "affine", {"preconditioner_type": "Newton"}, True,
                 (8, 4)))
LEGACY_CASE_STEPS = 500
LEGACY_CASE_LOSS = 1e-3
LEGACY_DEMO_STEPS = 30
LEGACY_GPT2_STEPS = 5


def _legacy_inputs(gen, *shapes) -> list:
    """Standard normals on the CPU in float64 from ``gen``."""
    return [torch.randn(s, generator=gen, dtype=torch.float64) for s in shapes]


def _legacy_families(gen) -> list:
    """(label, inputs, run): ``run(dev, dtype, inputs)`` one update chain
    (two updates, the second taking the balances that draw) and one apply
    of a family, returning every tensor it made; ``inputs`` CPU float64."""
    n, m, (a, b) = LEGACY_N, LEGACY_DENSE_N, LEGACY_SHAPE
    out = []

    def dense_p(dev, dt, x):
        q = torch.eye(m, dtype=dt, device=dev) + 0.01 * torch.triu(x[0])
        q = legacy_p.update_precond_dense(q, x[1], x[2], lr=0.1)
        q = legacy_p.update_precond_dense(q, x[3], x[4], lr=0.1)
        return [q, legacy_p.precond_grad_dense(q, x[5])]

    out.append((f"dense P (n = {m})", _legacy_inputs(gen, (m, m), *[(m,)] * 5), dense_p))
    for kinds in (("dense", "dense"), ("dense", "norm"), ("dense", "scale"),
                  ("norm", "dense"), ("norm", "scale"), ("scale", "dense"),
                  ("scale", "norm")):
        def kron(dev, dt, x, kinds=kinds):
            ql, qr = legacy_p.init_kron_legacy(LEGACY_SHAPE, *kinds, dtype=dt,
                                               device=dev)
            ql, qr = legacy_p.update_precond_kron(ql, qr, x[0], x[1], lr=0.1)
            ql, qr = legacy_p.update_precond_kron(ql, qr, x[2], x[3], lr=0.1)
            return [ql, qr, legacy_p.precond_grad_kron(ql, qr, x[4])]
        out.append((f"Kron {kinds[0]}/{kinds[1]} {LEGACY_SHAPE}",
                    _legacy_inputs(gen, *[LEGACY_SHAPE] * 5), kron))
    for norm in ("1st", "2nd"):
        def newton(dev, dt, x, norm=norm):
            st = legacy_p.init_newton_inv(m, 1.0, dt, dev)
            q = torch.eye(m, dtype=dt, device=dev)
            for v, h in ((x[0], x[1]), (x[2], x[3])):
                st = legacy_p.update_newton_inv(st, v, h, lr=0.1, step_normalizer=norm)
                q = legacy_p.update_newton_tri(q, v, h, lr=0.1, step_normalizer=norm)
            return [*st, q, legacy_p.precond_grad_newton_inv(st, x[4])]
        out.append((f"newton_inv and newton_tri {norm} (n = {m})",
                    _legacy_inputs(gen, *[(m,)] * 5), newton))
        for coin in (0.25, 0.75):
            def uvd(dev, dt, x, norm=norm, coin=coin):
                st = legacy_p.init_uvd(n, LEGACY_RANK, 1.0, dt, dev, u=x[0], v=x[1])
                st = legacy_p.update_uvd(st, x[2], x[3], u_balance=0.5, u_coin=coin,
                                         lr=0.1, step_normalizer=norm)
                st = legacy_p.update_uvd(st, x[4], x[5], u_balance=0.005, u_coin=coin,
                                         lr=0.1, step_normalizer=norm)
                return [*st, legacy_p.precond_grad_uvd(st, x[6])]
            out.append((f"UVd {norm} {'U' if coin < 0.5 else 'V'} (n = {n}, r = "
                        f"{LEGACY_RANK})", _legacy_inputs(
                            gen, *[(n, LEGACY_RANK)] * 2, *[(n,)] * 5), uvd))
        for size in (n, n + 1):
            def xm(dev, dt, x, norm=norm, size=size):
                st = xmat_p.init_xmat(size, 1.0, dt, dev)
                st = xmat_p.update_xmat(st, x[0], x[1], lr=0.1, step_normalizer=norm)
                st = xmat_p.update_xmat_whiten(st, x[2], lr=0.1, step_normalizer=norm,
                                               v=x[3])
                return [*st, xmat_p.precond_grad_xmat(st, x[4])]
            out.append((f"XMat {norm} (n = {size})", _legacy_inputs(
                gen, *[(size,)] * 5), xm))

    def splu(dev, dt, x):
        st = splu_p.init_splu(n, LEGACY_RANK, 1.0, dt, dev)
        st = splu_p.update_splu(st, x[0], x[1], lr=0.1)
        st = splu_p.update_splu(st, x[2], x[3], lr=0.1)
        return [*st, splu_p.precond_grad_splu(st, x[4])]

    out.append((f"SPLU (n = {n}, r = {LEGACY_RANK})", _legacy_inputs(
        gen, *[(n,)] * 5), splu))
    # Affine: (matrix shape, max_size) for each side combination
    sides = {"dense/dense": ((a, b), float("inf")), "dense/diag": ((b, a), 200),
             "diag/dense": ((a, b), 200), "diag/diag": ((a, b), 100)}
    for label, (shape, max_size) in sides.items():
        for dropv in (False, True):
            def aff(dev, dt, x, shape=shape, max_size=max_size, dropv=dropv):
                st = affine_p.init_affine(shape, 1.0, max_size, dtype=dt, device=dev)
                for i, ub in enumerate((0.5, 0.005)):
                    if dropv:
                        st = affine_p.update_affine_dropv(
                            st, x[2 * i + 1], u_balance=ub, lr=0.1, v=x[2 * i])
                    else:
                        st = affine_p.update_affine(st, x[2 * i], x[2 * i + 1],
                                                    u_balance=ub, lr=0.1)
                return [*st, affine_p.precond_grad_affine(st, x[4])]
            out.append((f"Affine {'drop-v' if dropv else 'with v'} {label} {shape}",
                        _legacy_inputs(gen, *[shape] * 5), aff))
    return out


def check_legacy_families(dev, card: str) -> None:
    """Every legacy family on the card against the same code on the CPU,
    from the same inputs, in float64 (gate LEGACY_F64_REL) and float32
    (LEGACY_F32_REL): the largest |card - CPU| over the largest |CPU| of
    each output, the worst output's."""
    worst = {torch.float64: 0.0, torch.float32: 0.0}
    for label, inputs, run in _legacy_families(torch.Generator().manual_seed(17)):
        rels = []
        for dt, limit in ((torch.float64, LEGACY_F64_REL), (torch.float32, LEGACY_F32_REL)):
            got = run(dev, dt, [x.to(dev, dt) for x in inputs])
            ref = run(torch.device("cpu"), dt, [x.to(dt) for x in inputs])
            rel = max(float(torch.max(torch.abs(g.cpu() - r)) / torch.max(torch.abs(r)))
                      for g, r in zip(got, ref))
            if not all(torch.isfinite(r).all() for r in ref) or not rel <= limit:
                raise AssertionError(f"legacy {label} {dt}: card against CPU "
                                     f"{rel:.3e} (limit {limit:g})")
            worst[dt] = max(worst[dt], rel)
            rels.append(rel)
        log(f"  {label}: card against CPU f64 {rels[0]:.3e}, f32 {rels[1]:.3e}")
    log(f"  [{card}] legacy families, card against CPU: worst f64 "
        f"{worst[torch.float64]:.3e} (gate {LEGACY_F64_REL:g}), worst f32 "
        f"{worst[torch.float32]:.3e} (gate {LEGACY_F32_REL:g})")


def _legacy_case(dev, factory, kw, newton, shape) -> tuple:
    """The JAX test's case on the card: the ill-conditioned quadratic,
    linear_schedule(0.5, 0, 500), momentum 0.9, clip 10, 500 steps.
    Returns (final loss, ms per step)."""
    h = torch.diag(10.0 ** torch.linspace(-1, 1, 32, device=dev))
    w_star = torch.randn(32, generator=torch.Generator().manual_seed(0)).to(dev)
    w = torch.zeros(shape, device=dev, requires_grad=True)

    def loss():
        d = w.reshape(-1) - w_star
        return 0.5 * torch.sum(d * (h @ d))

    opt = getattr(legacy_optim, factory)(
        [w], lambda c: 0.5 * (1.0 - min(c, LEGACY_CASE_STEPS) / LEGACY_CASE_STEPS),
        momentum=0.9, grad_clip_max_norm=10.0, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LEGACY_CASE_STEPS):
        if newton:
            opt.step(loss)
        else:
            opt.zero_grad()
            loss().backward()
            opt.step()
    final = float(loss().detach())
    return final, (time.perf_counter() - t0) * 1e3 / LEGACY_CASE_STEPS


def _legacy_demo(label, step, steps, card) -> None:
    """``steps`` calls of ``step()`` (which returns the loss): the first and
    last loss, the median step (host clock to a synchronize); fails on a
    non-finite loss."""
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  [{card}] {label}: loss {losses[0]:.4f} -> {losses[-1]:.4f} in {steps} "
        f"steps, median step {_median(ms[1:])} ms")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")


def _closure_step(opt, loss):
    return lambda: opt.step(loss).detach()


def _grad_step(opt, loss):
    def step():
        opt.zero_grad()
        out = loss()
        out.backward()
        opt.step()
        return out.detach()
    return step


def legacy_demos(dev, card: str) -> None:
    """The reference demos at their own widths, LEGACY_DEMO_STEPS steps
    each: examples/mnist_lenet5.py's functional Kron step on LeNet5
    (synthetic_mnist, batch 64), Affine whitening on LeNet5 and Affine
    Newton on the 30-unit XOR RNN (batch 128, sequence 16) with
    examples/affine_wrapped_layers.py's settings, XMat, SPLU and UVd (rank
    10) whitening over LeNet5's 61,706 parameters, NewtonInv over the RNN's
    1,021."""
    data = torch.Generator().manual_seed(100)
    batch = {}

    def lenet_batch():
        batch["x"], batch["y"] = lenet5.synthetic_mnist(data, 64, device=dev)

    params = lenet5.init_lenet5(torch.Generator().manual_seed(0), device=dev)
    qs = mnist_lenet5.init_preconditioners(params)
    gen_v = torch.Generator(device=dev).manual_seed(2)

    def kron_step():
        nonlocal qs
        lenet_batch()
        qs, loss = mnist_lenet5.kron_step(params, qs, 0.1, batch["x"], batch["y"], gen_v)
        return loss

    _legacy_demo("LeNet5 legacy Kron (5 dense pairs, exact Hvp), batch 64",
                 kron_step, LEGACY_DEMO_STEPS, card)

    def lenet_loss(ps):
        def loss():
            lenet_batch()
            return lenet5.loss_lenet5(ps, batch["x"], batch["y"])
        return loss

    # the vector families with the Affine arm's lr and trust region
    arms = [("Affine whitening", affine_wrapped_layers.lenet5_affine)] + [
        (f"{cls.__name__} whitening", functools.partial(
            lambda ps, device, cls, kw: cls(ps, lr=0.05, grad_clip_max_norm=10.0,
                                            device=device, **kw), cls=cls, kw=kw))
        for cls, kw in ((legacy_optim.XMat, {}),
                        (legacy_optim.SPLU, {"rank": LEGACY_RANK}),
                        (legacy_optim.UVd, {"rank": LEGACY_RANK}))]
    for name, make in arms:
        ps = lenet5.init_lenet5(torch.Generator().manual_seed(0), device=dev)
        opt = make(ps, dev)
        _legacy_demo(f"LeNet5 {name}, batch 64", _grad_step(opt, lenet_loss(ps)),
                     LEGACY_DEMO_STEPS, card)
    for name in ("Affine Newton", "NewtonInv Newton"):
        ps = rnn.init_rnn(torch.Generator().manual_seed(1), device=dev)
        opt = (affine_wrapped_layers.rnn_affine(ps, dev) if name.startswith("Affine")
               else legacy_optim.NewtonInv(ps.items(), lr=0.01,
                                           preconditioner_type="Newton",
                                           lr_preconditioner=0.01,
                                           grad_clip_max_norm=1.0, device=dev))
        xor = torch.Generator().manual_seed(10)

        def loss():
            xs, target = rnn.xor_batch(xor, 128, 16, device=dev)
            return rnn.xor_loss(rnn.apply_rnn(ps, xs), target)

        _legacy_demo(f"XOR RNN (30 units) {name}, batch 128 x 16",
                     _closure_step(opt, loss), LEGACY_DEMO_STEPS, card)


def legacy_gpt2(dev, card: str) -> None:
    """Affine whitening over GPT-2 124M at its published widths: batch 4 x
    1024, bf16 compute, bench.py:170-177's operating point (max_skew 2,
    init scale 1, momentum 0.9, lr 2.5e-4, weight decay 0.01), float32
    preconditioner, LEGACY_GPT2_STEPS steps; each leaf's plan and dense
    sides, the median step, the peak memory; fails on a non-finite loss."""
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(1), 4, cfg.block_size, cfg.vocab_size,
        device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = legacy_optim.Affine(model.named_parameters(), lr=2.5e-4, weight_decay=0.01,
                              preconditioner_max_skew=2.0,
                              preconditioner_init_scale=1.0, momentum=0.9,
                              preconditioner_dtype=torch.float32, device=dev)
    for p, plan in zip(opt.param_groups[0]["params"], opt.plans):
        name = next(k for k, v in model.named_parameters() if v is p)
        sides = "/".join("dense" if opt.state[p][s].ndim == 2 else "diag"
                         for s in ("ql", "qr"))
        log(f"  Affine plan {name} {tuple(p.shape)}: perm {plan.perm} -> "
            f"{plan.matrix_shape}, {sides}")
    _legacy_demo("GPT-2 124M Affine whitening, batch 4 x 1024, bf16 compute",
                 _grad_step(opt, lambda: gpt2.loss_gpt2(model, tokens, targets)),
                 LEGACY_GPT2_STEPS, card)
    log(f"  [{card}] GPT-2 124M Affine whitening: peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model, opt
    torch.cuda.empty_cache()


def legacy_path(dev, card: str) -> dict:
    """The legacy families (ROADMAP A7): ``check_legacy_families``, the JAX
    tests' nine convergence cases on the card (each final loss below
    LEGACY_CASE_LOSS), ``legacy_demos`` and ``legacy_gpt2``.  The counts
    are reset before and read after: the path launches none of the nine
    kernels (it fails if it did).  Returns no counts."""
    marks = [time.perf_counter()]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    check_legacy_families(dev, card)
    marks.append(time.perf_counter())
    for label, factory, kw, newton, shape in LEGACY_CASES:
        final, ms = _legacy_case(dev, factory, kw, newton, shape)
        log(f"  [{card}] {label}: final loss {final:.3e} after {LEGACY_CASE_STEPS} "
            f"steps ({ms:.2f} ms per step)")
        if not final < LEGACY_CASE_LOSS:
            raise AssertionError(f"{label}: final loss {final} (limit "
                                 f"{LEGACY_CASE_LOSS})")
    marks.append(time.perf_counter())
    legacy_demos(dev, card)
    marks.append(time.perf_counter())
    legacy_gpt2(dev, card)
    marks.append(time.perf_counter())
    launched = {k: v for k, v in _all_counts().items() if v}
    if launched:
        raise AssertionError(f"the legacy path launched kernels: {launched}")
    parts = ", ".join(f"{what} {b - a:.1f} s" for what, a, b in zip(
        ("card against CPU", "cases", "demos", "GPT-2"), marks, marks[1:]))
    log(f"  [{card}] legacy path: {marks[-1] - marks[0]:.1f} s ({parts}); none "
        "of the nine kernels launched")
    return {}


def _state_leaves(tree, where: str = "") -> list:
    """(path, tensor) of every tensor of a state_dict, in order."""
    if isinstance(tree, torch.Tensor):
        return [(where, tree)]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _state_leaves(v, f"{where}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _state_leaves(v, f"{where}/{i}")]
    return []


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _state_differences(a: dict, b: dict) -> list:
    """Where two optimizer state_dicts differ: a tensor's bits or dtype,
    count or fit_steps (the key is one of the tensors)."""
    la, lb = _state_leaves(a), _state_leaves(b)
    bad = [k for (k, x), (_, y) in zip(la, lb) if not _same_bits(x, y)]
    if [k for k, _ in la] != [k for k, _ in lb]:
        bad.append("the tensors' paths")
    bad += [k for k in ("count", "fit_steps") if a["psgd"][k] != b["psgd"][k]]
    return bad


def _param_differences(a, b) -> list:
    return [n for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters())
            if not _same_bits(x.detach(), y.detach())]


def _gaps(a, b) -> dict:
    """max |a - b| per parameter of two models (or parameter lists)."""
    named = lambda m: (list(m.named_parameters()) if hasattr(m, "named_parameters")
                       else list(enumerate(m)))
    return {n: (x.detach().double() - y.detach().double()).abs().max().item()
            for (n, x), (_, y) in zip(named(a), named(b))}


@contextlib.contextmanager
def _deterministic():
    """CUDA's deterministic algorithms for the runs a resumed run is held
    against (the attention backward's deterministic variant; cuBLAS on a
    fixed workspace configuration, which torch requires in this mode), so
    two unbroken runs differ only where the card leaves no choice."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def _timed_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _all_counts() -> dict:
    """Every row's launch count (and unit_noise's, and the step-matrix
    counts), as ``train`` returns them."""
    out = {name: getattr(kernels, name).launches for name, _, _ in ROWS}
    out["unit_noise"] = kernels.unit_noise.launches
    out.update({f"{f.__name__}.step_mat": f.step_mat_launches
                for f in kernels.STEP_MAT_KERNELS})
    return out


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _train_step(model, loss_fn, opt, batch, record=None) -> tuple:
    """One step (zero_grad, backward, step) on ``batch``; with ``record``
    the gradients are cloned into it before the optimizer reads them.
    Returns (loss, host ms to the step's end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, *batch)
    loss.backward()
    if record is not None:
        record.append([p.grad.detach().clone() for p in opt.param_groups[0]["params"]])
    opt.step()
    torch.cuda.synchronize()
    return loss.item(), (time.perf_counter() - t0) * 1e3


def _feed(opt, grads) -> None:
    """Optimizer steps from recorded gradients (no model pass)."""
    for gs in grads:
        for p, g in zip(opt.param_groups[0]["params"], gs):
            p.grad = g
        opt.step()


def _unbroken_run(label, model, loss_fn, opt_fn, batches, save_at, ckdir, card):
    """The unbroken run: ``opt_fn(model)`` built after one untimed forward
    and backward (so allocated memory holds no gradient and no first-use
    workspace), trained on ``batches`` and checkpointed before step
    ``save_at``, its gradients from there on recorded on the device.  The
    growth of allocated memory over the optimizer's construction and first
    step is held against its state's bytes, its metrics after the run
    against finiteness.  Returns (optimizer, recorded gradients)."""
    loss_fn(model, *batches[0]).backward()
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    opt = opt_fn(model)
    params = opt.param_groups[0]["params"]
    timer = StepTimer(warmup=1, device=opt.device)
    timer.start()
    grads, losses, ms, save_ms, growth, before = [], [], [], None, None, None
    for i, batch in enumerate(batches):
        if i == save_at:
            _, save_ms = _timed_ms(lambda: save_checkpoint(
                str(ckdir), i, model, opt, extra={"data_step": i}))
        if i == len(batches) - 1:
            before = [p.detach().clone() for p in params]
        loss, t = _train_step(model, loss_fn, opt, batch,
                              grads if i >= save_at else None)
        timer.mark()
        losses.append(loss)
        ms.append(t)
        if i == 0:
            opt.zero_grad(set_to_none=True)
            growth = torch.cuda.memory_allocated() - m0
    nbytes = (ckdir / f"step_{save_at}" / "state.pt").stat().st_size
    fits = opt.fit_steps
    log(f"  [{card}] {label}, unbroken run: losses {[round(x, 4) for x in losses]}, fit "
        f"steps {fits}; train step median (first excluded) host clock "
        f"{_median(ms[1:])} ms, CUDA events (StepTimer) "
        f"{_median([t * 1e3 for t in timer.times])} ms")
    log(f"  [{card}] {label} checkpoint at step {save_at}: {nbytes / 1e9:.3f} GB on "
        f"disk, saved in {save_ms:.0f} ms")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    updates = [p.detach() - b for p, b in zip(params, before)]
    check_state_metrics(label, opt, updates, growth, card)
    return opt, grads


def check_state_metrics(label, opt, updates, growth: int, card: str) -> None:
    """``psgd_metrics`` of the state and the last update all finite;
    ``state_memory_report``'s total equal to the bytes of the state
    tensors counted from ``state_dict()`` (all but the key, which the port
    keeps on the host); the growth of
    allocated memory over the optimizer's construction and first step
    within MEMORY_SLACK of that total."""
    metrics = psgd_metrics(opt, updates, per_leaf=True)
    bad = [k for k, v in metrics.items() if not torch.isfinite(v.float()).item()]
    report = state_memory_report(opt)
    direct = sum(t.numel() * t.element_size() for k, t in _state_leaves(opt.state_dict())
                 if k != "/psgd/key")
    shown = {k: round(float(metrics[k]), 6) for k in metrics if "/" not in k}
    log(f"  [{card}] {label} metrics: {shown} ({len(metrics)} values, per leaf "
        f"included; non-finite: {bad or 'none'})")
    log(f"  [{card}] {label} state memory report (bytes): {report}; state tensors "
        f"counted directly {direct}; allocated-memory growth over the optimizer's "
        f"construction and first step {growth} ({growth / direct - 1:+.4%})")
    if bad or report["total"] != direct or abs(growth - direct) > MEMORY_SLACK * direct:
        raise AssertionError(f"{label}: metrics non-finite {bad}, report {report['total']} "
                             f"against {direct} bytes, growth {growth}")


def check_dtypes(label, opt, reference: dict, param_dtype, q_dtype) -> None:
    """Every restored tensor has the dtype of the same tensor in the
    unbroken run's state (``reference``); Q and momentum ``q_dtype``, the
    Lipschitz estimates f32, the parameters ``param_dtype``."""
    got = _state_leaves(opt.state_dict())
    bad = [k for k, t in got if t.dtype != reference[k]]
    for i, p in enumerate(opt.param_groups[0]["params"]):
        st = opt.state[p]
        if (p.dtype != param_dtype or {q.dtype for q in st["q"]} != {q_dtype}
                or {x.dtype for x in st["lips"]} != {torch.float32}
                or st["mu"].dtype != q_dtype):
            bad.append(f"leaf {i}")
    log(f"  {label} restored dtypes: parameters {param_dtype}, Q and momentum "
        f"{q_dtype}, Lipschitz estimates float32 on every leaf: {not bad}")
    if bad:
        raise AssertionError(f"{label}: restored dtypes differ at {bad}")


def gpt2_resume(dev, card: str) -> dict:
    """GPT-2 124M at its published widths (random weights from seed 0, f32
    parameters, bf16 compute) trained by the ported trainer's PSGD recipe
    (``train_gpt2.psgd_optimizer``: bf16 Q and momentum, p from 1.0 to 0.1
    over counts 0-3, key seed RESUME_SEED) on batches of RESUME_BATCH x
    1024 from the corpus (``train_gpt2.batch_source``), RESUME_STEPS steps:
    run A unbroken, checkpointed at RESUME_AT (``save_checkpoint``); A'
    the same again; B restored from A's checkpoint into a fresh model and
    optimizer (``restore_checkpoint``) and trained on the same batches.
    Gates: B's state keeps its dtypes; its fit steps launch exactly
    GPT2_PER_FIT; per parameter |B - A| <= |A' - A|, with A, A' and B
    under CUDA's deterministic algorithms (``_deterministic``), so the
    tolerance is what the card still leaves to chance; a second restored optimizer fed A's
    recorded gradients equals A bit for bit (parameters, every state
    tensor, count, key, fit_steps); B's profiled fit step runs no FFMA GEMM.
    Then the failsafe loop (``failsafe_gpt2``).  Returns the launch counts."""
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    batch_fn = train_gpt2.batch_source("corpus", cfg, RESUME_BATCH, dev, log=log)
    batches = [batch_fn(i) for i in range(RESUME_STEPS)]
    loss_fn = gpt2.loss_gpt2
    label = "GPT-2 124M resumable"
    total = {}

    def fresh(seed):
        model = gpt2.GPT2(cfg, device=dev, seed=seed)
        return model, train_gpt2.psgd_optimizer(model, RESUME_STEPS, dev,
                                                seed=RESUME_SEED)

    log(f"{label}: the trainer's PSGD recipe, batch {RESUME_BATCH} x {cfg.block_size} "
        f"from the corpus, {RESUME_STEPS} steps, checkpoint at {RESUME_AT}")
    ckdir = OUT_DIR / "checkpoint_gpt2"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        model_a = gpt2.GPT2(cfg, device=dev, seed=0)
        kernels.reset_launch_counts()
        with _deterministic():
            opt_a, grads = _unbroken_run(
                label, model_a, loss_fn,
                lambda m: train_gpt2.psgd_optimizer(m, RESUME_STEPS, dev,
                                                    seed=RESUME_SEED),
                batches, RESUME_AT, ckdir, card)
            _add(total, _all_counts())
            model_p, opt_p = fresh(0)
            for batch in batches:
                _train_step(model_p, loss_fn, opt_p, batch)
        dtypes = {k: t.dtype for k, t in _state_leaves(opt_a.state_dict())}
        gap = _gaps(model_p, model_a)
        model_b, opt_b = fresh(7)
        (step, extra), restore_ms = _timed_ms(
            lambda: restore_checkpoint(str(ckdir), model_b, opt_b))
        if step != RESUME_AT or extra != {"data_step": RESUME_AT} or opt_b.count != RESUME_AT:
            raise AssertionError(f"{label}: restored step {step}, extra {extra}, count "
                                 f"{opt_b.count}")
        log(f"  [{card}] {label} restored in {restore_ms:.0f} ms")
        check_dtypes(label, opt_b, dtypes, torch.float32, torch.bfloat16)
        fits0 = opt_b.fit_steps
        kernels.reset_launch_counts()
        with _deterministic():
            losses_b = [_train_step(model_b, loss_fn, opt_b, batch)[0]
                        for batch in batches[RESUME_AT:]]
        counts = _all_counts()
        _add(total, counts)
        fits = opt_b.fit_steps - fits0
        resumed = _gaps(model_b, model_a)
        worse = [n for n in gap if resumed[n] > gap[n]]
        log(f"  [{card}] {label} train continuation (deterministic algorithms): B's "
            f"losses {[round(x, 4) for x in losses_b]}, fit steps {fits} (before the "
            f"checkpoint {fits0}); max |A' - A| {max(gap.values()):.3e}, max |B - A| "
            f"{max(resumed.values()):.3e}, max |B - A'| "
            f"{max(_gaps(model_b, model_p).values()):.3e}; parameters with "
            f"|B - A| > |A' - A|: {worse or 'none'}")
        del model_p, opt_p
        per_fit = {k: counts[k] for k in GPT2_PER_FIT}
        if not 0 < fits < len(batches) - RESUME_AT or any(
                per_fit[k] != n * fits for k, n in GPT2_PER_FIT.items()) or worse:
            raise AssertionError(f"{label}: resumed launches {per_fit} for {fits} fit "
                                 f"steps, parameters further than A' {worse}")
        model_o, opt_o = fresh(9)
        restore_checkpoint(str(ckdir), model_o, opt_o)
        kernels.reset_launch_counts()
        _feed(opt_o, grads)
        _add(total, _all_counts())
        bad = _param_differences(model_o, model_a) + _state_differences(
            opt_o.state_dict(), opt_a.state_dict())
        log(f"  [{card}] {label} optimizer-only continuation ({len(grads)} steps from "
            f"A's gradients): parameters, every state tensor, count, key and fit_steps "
            f"equal to A's bit for bit: {not bad}")
        if bad:
            raise AssertionError(f"{label}: optimizer-only continuation differs at {bad}")
        del grads, model_o, opt_o, model_a, opt_a
        gc.collect()
        torch.cuda.empty_cache()
        profile_steps(f"{label} B", (model_b, loss_fn, opt_b, *batches[0]), card, (1.0,))
        del model_b, opt_b
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    _add(total, failsafe_gpt2(dev, card, cfg, batches))
    return total


def failsafe_gpt2(dev, card: str, cfg, batches) -> dict:
    """``FailsafeLoop`` around ``make_guarded_step`` on GPT-2 124M with the
    trainer's recipe, snapshots every FAILSAFE_EVERY steps: FAILSAFE_POISON
    good steps, then one whose loss is scaled by inf (its gradient and
    update non-finite).  Gates: the loop returns None, its step falls back
    to the last snapshot's and its lr scale to 0.5; the model's and the
    optimizer's state equal the snapshot bit for bit; FAILSAFE_AFTER more
    steps with a finite loss.  Returns the launch counts."""
    label = "GPT-2 124M failsafe"
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    opt = train_gpt2.psgd_optimizer(model, RESUME_STEPS, dev, seed=RESUME_SEED)
    loss_fn = lambda m, tokens, targets, scale: gpt2.loss_gpt2(m, tokens, targets) * scale
    loop = FailsafeLoop(make_guarded_step(opt, loss_fn), model, opt,
                        snapshot_every=FAILSAFE_EVERY)
    kernels.reset_launch_counts()
    losses = [loop.run_step(*batches[i], 1.0) for i in range(FAILSAFE_POISON)]
    out, step_ms = _timed_ms(lambda: loop.run_step(*batches[FAILSAFE_POISON], math.inf))
    snap, back, scale = loop._good, loop.step, loop.lr_scale
    bad = [k for k, v in model.state_dict().items() if not _same_bits(v, snap.model[k])]
    bad += _state_differences(opt.state_dict(), snap.optimizer)
    _, rollback_ms = _timed_ms(lambda: (model.load_state_dict(snap.model),
                                        opt.load_state_dict(snap.optimizer)))
    after = [loop.run_step(*batches[(FAILSAFE_POISON + i) % len(batches)], 1.0)
             for i in range(FAILSAFE_AFTER)]
    counts = _all_counts()
    log(f"  [{card}] {label}: losses {[round(x, 4) for x in losses]}, poisoned step "
        f"returned {out} in {step_ms:.0f} ms, back at step {back} with lr scale "
        f"{scale}; model and optimizer equal to the snapshot bit for bit: "
        f"{not bad}; the rollback's load {rollback_ms:.1f} ms; then losses "
        f"{[None if x is None else round(x, 4) for x in after]}")
    if (out is not None or back != FAILSAFE_POISON - FAILSAFE_POISON % FAILSAFE_EVERY
            or snap.step != back or scale != 0.5 or bad
            or not all(x is not None and math.isfinite(x) for x in losses + after)):
        raise AssertionError(f"{label}: returned {out}, back at step {back}, snapshot "
                             f"{snap.step}, lr scale {scale}, differs at {bad}, "
                             f"losses {losses} {after}")
    del loop, snap, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def llama_resume(dev, card: str) -> dict:
    """LLaMA-1.1B (batch 1 x 1024, bf16 compute, f32 parameters) by the
    optimizer of tools/bench_llama.py:108-114 at p = 1: LLAMA_RESUME[0]
    steps, a checkpoint (about 7 GB), LLAMA_RESUME[1] more with their
    gradients recorded.  A fresh model and optimizer restored from the
    checkpoint and fed those gradients equal the unbroken run bit for bit,
    keep their dtypes (f32 parameters, bf16 Q and momentum) and launch
    exactly LLAMA_PER_FIT per fit step on the split and tiled routes.
    The checkpoint is deleted at the end.  Returns the launch counts."""
    cfg = llama.llama_1b(compute_dtype=torch.bfloat16)
    batch = llama.synthetic_lm_batch(torch.Generator().manual_seed(1), 1,
                                     cfg.block_size, cfg.vocab_size, device=dev)
    before, after = LLAMA_RESUME
    steps = before + after
    label = "LLaMA-1.1B resumable"
    ckdir = OUT_DIR / "checkpoint_llama"
    shutil.rmtree(ckdir, ignore_errors=True)
    total = {}
    log(f"{label}: batch 1 x {cfg.block_size}, the bench_llama optimizer at p = 1, "
        f"{steps} steps, checkpoint at {before}")
    try:
        model_a = llama.Llama(cfg, device=dev, seed=0)
        kernels.reset_launch_counts()
        opt_a, grads = _unbroken_run(
            label, model_a, llama.loss_llama,
            lambda m: _bench_opt(m, llama.scanned_layers_mask(m), steps, dev),
            [batch] * steps, before, ckdir, card)
        _add(total, _all_counts())
        dtypes = {k: t.dtype for k, t in _state_leaves(opt_a.state_dict())}
        model_o = llama.Llama(cfg, device=dev, seed=1)
        opt_o = _bench_opt(model_o, llama.scanned_layers_mask(model_o), steps, dev)
        _, restore_ms = _timed_ms(lambda: restore_checkpoint(str(ckdir), model_o, opt_o))
        log(f"  [{card}] {label} restored in {restore_ms:.0f} ms")
        check_dtypes(label, opt_o, dtypes, torch.float32, torch.bfloat16)
        fits0 = opt_o.fit_steps
        kernels.reset_launch_counts()
        _feed(opt_o, grads)
        counts = _all_counts()
        _add(total, counts)
        fits = opt_o.fit_steps - fits0
        per_fit = {k: counts[k] for k in LLAMA_PER_FIT}
        bad = _param_differences(model_o, model_a) + _state_differences(
            opt_o.state_dict(), opt_a.state_dict())
        log(f"  [{card}] {label} optimizer-only continuation ({len(grads)} steps): "
            f"launches {per_fit} for {fits} fit steps; equal to the unbroken run bit "
            f"for bit: {not bad}")
        if fits != after or any(per_fit[k] != n * fits for k, n in LLAMA_PER_FIT.items()) \
                or bad:
            raise AssertionError(f"{label}: launches {per_fit} for {fits} fit steps, "
                                 f"differs at {bad}")
        del grads, model_o, opt_o, model_a, opt_a
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return total


class _Tensors:
    """``state_dict`` and ``load_state_dict`` over a list of parameter
    tensors: the model interface ``save_checkpoint`` reads."""

    def __init__(self, tensors):
        self.tensors = tensors

    def state_dict(self) -> dict:
        return {str(i): t.detach() for i, t in enumerate(self.tensors)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for i, t in enumerate(self.tensors):
            t.copy_(state[str(i)])


# the five optimizers through their closure classes on the tensor-rank
# problem: the example's Newton settings, whitening at lr 0.01
_CP_NEWTON = dict(lr_params=0.2, lr_preconditioner=0.5, momentum=0.9,
                  grad_clip_max_norm=10.0)
CP_RESUME_CLASSES = (("KronWhiten", dict(lr_params=0.01, momentum=0.9)),
                     ("KronNewton", _CP_NEWTON),
                     ("LRAWhiten", dict(lr_params=0.01, momentum=0.9,
                                        rank_of_approximation=LRA_RANK)),
                     ("LRANewton", dict(_CP_NEWTON, rank_of_approximation=LRA_RANK)),
                     ("DenseNewton", _CP_NEWTON))


def cp_resume(dev, card: str) -> dict:
    """The tensor-rank problem (``CP_FULL``, n = 1700, f32) by each of the
    five closure classes with a gated schedule (p = CP_RESUME_P): two
    unbroken runs of sum(CP_RESUME) steps, and one checkpointed after
    CP_RESUME[0], restored into a fresh class and continued.  Gate: per
    parameter |resumed - unbroken| <= |unbroken' - unbroken|.  Returns the
    launch counts of the resumed continuations."""
    before, after = CP_RESUME
    total = {}
    for name, kw in CP_RESUME_CLASSES:
        label = f"tensor-rank {name} class resumable"

        def fresh():
            params, loss = cp_problem(*CP_FULL, dev)
            opt = getattr(classes, name)(
                params, device=dev, preconditioner_update_probability=lambda c: CP_RESUME_P,
                **kw)
            return params, loss, opt

        unbroken = []
        for _ in range(2):
            params, loss, opt = fresh()
            for _ in range(before + after):
                opt.step(loss)
            unbroken.append((params, loss().item(), opt.optimizer.fit_steps))
        params, loss, opt = fresh()
        for _ in range(before):
            opt.step(loss)
        ckdir = OUT_DIR / "checkpoint_cp"
        save_checkpoint(str(ckdir), before, _Tensors(params), opt)
        params, loss, opt = fresh()
        restore_checkpoint(str(ckdir), _Tensors(params), opt)
        shutil.rmtree(ckdir)
        kernels.reset_launch_counts()
        for _ in range(after):
            opt.step(loss)
        _add(total, _all_counts())
        (u1, final, fits), (u2, _, _) = unbroken
        gap, resumed = _gaps(u2, u1), _gaps(params, u1)
        worse = [n for n in gap if resumed[n] > gap[n]]
        log(f"  [{card}] {label}: loss {loss().item():.6g} resumed, {final:.6g} "
            f"unbroken, fit steps {fits} of {before + after}; max |U' - U| "
            f"{max(gap.values()):.3e}, max |R - U| {max(resumed.values()):.3e}")
        if worse or not 0 < fits < before + after or not math.isfinite(final):
            raise AssertionError(f"{label}: resumed further than two unbroken runs at "
                                 f"{worse}, fit steps {fits}, loss {final}")
    torch.cuda.empty_cache()
    return total


def resume_path(dev, card: str) -> dict:
    """The resumable-training path: GPT-2 124M through the trainer with its
    failsafe loop (``gpt2_resume``), LLaMA-1.1B (``llama_resume``) and the
    five optimizers on the tensor-rank problem (``cp_resume``).  Returns
    the launch counts summed."""
    total = {}
    for drive in (gpt2_resume, llama_resume, cp_resume):
        _add(total, drive(dev, card))
    log(f"  resumable path launches: {total}")
    return total


# ---------------------------------------------------------------------------
# complex and float64 Kron: the noise's complex mode and the XLA tail
# ---------------------------------------------------------------------------

# the noise's complex mode: its row-2 shape (path B's qkv stack), and the
# shapes held bit for bit (vector and scalar kernels, complex64, complex128,
# and the real float64 instantiation)
CX_NOISE_SHAPE = (12, 768, 2304)
CX_NOISE_CHECKS = (((12, 768, 2304), torch.complex64), ((12, 768, 768), torch.complex64),
                   ((3, 97, 33), torch.complex64), ((3, 97, 33), torch.complex128),
                   ((2, 1024, 768), torch.complex128), ((3, 97, 33), torch.float64),
                   ((1, 1024, 768), torch.float64))
# path A: the reference's verification problem (misc/psgd_kron_verification.py,
# tests/test_kron_fixed_point.py): a complex64 stack of Kronecker Hermitian
# positive definite Hessians H1 (x) H2 (cond >= 100 each) on GPT-2 124M's
# qkv leaf, Q0.5EQ1.5, both factors dense, lr annealed (1 - i/N) / 2,
# damping 0; then the JAX test's own sizes in complex128
FP_STACK = (12, 768, 2304)
FP_NEWTON_STEPS = 200
FP_WHITEN_STEPS = 50
FP_TOL = 0.30
FP_PROBES = 8
FP_SMALL_STEPS = 1500      # the JAX test's N, for the geometries
# the complex128 runs are host-bound (a few ms of launches per fit): they run
# side by side in this many processes, each driving the card
FP_WORKERS = 7
# one complex128 case per geometry and mode on the card: the JAX test's
# sweep over its 8 forms is held on the CPU (tests/test_torch_complex_kron.py)
FP_SMALL_FORM = "kron_matrix_matrix"
# path B: complex least squares 0.5 |W X - Y|^2 / batch over a 12-layer
# stack of complex64 parameters in GPT-2 124M's attention shapes
CX_LAYERS = 12
CX_SHAPES = ((768, 2304), (768, 768))
CX_BATCH = 4096
CX_STEPS = 150            # 200 before the complex LRA, dense and legacy path
CX_STEPS_P1 = 10          # then p = 0.1
CX_TINY = (2, ((8, 24), (8, 8)), 64)
# per fit step: one damping per leaf, one XLA tail per dense factor (the
# (768, 2304) leaf's 2304 dim is diagonal at max_skew 2) and its two starts
CX_WHITEN_PER_FIT = {"damped_noise": 2, "xla_ns_update": 3, "philox_start": 6}
CX_NEWTON_PER_FIT = dict(CX_WHITEN_PER_FIT, unit_noise=2)
# rows that no complex path may launch (every row but the noise)
CX_IDLE_ROWS = tuple(name for name, _, _ in ROWS if name != "damped_noise")


def check_noise_complex(dev, lib_path) -> dict:
    """The noise kernel's complex mode (complex64, complex128) and its float64
    instantiation, unit and fused, bit for bit against the plain versions
    (two real plain draws from the (B, 4) seed words) at ``CX_NOISE_CHECKS``;
    at ``CX_NOISE_SHAPE`` complex64 the times of both modes, their plain
    versions and ``torch.randn(..., dtype=torch.complex64)``, and the
    bound: max(bytes at the HBM rate, the loop's SASS instructions at the
    issue rate).  Returns row 2's complex-mode entries."""
    loops = _noise_loops(str(lib_path))
    for (dtype, fused, vec), c in sorted(loops.items(), key=str):
        if dtype.startswith("complex"):
            log(f"noise_complex_kernel<{dtype}, {'fused' if fused else 'unit'}, "
                f"{'vector' if vec else 'scalar'}> main loop: {c['instructions']} "
                f"instructions, {c['imad_wide_hi']} IMAD.WIDE/HI per {c['elements']:g} "
                f"complex elements: {c['per_element']:.2f} and "
                f"{c['imad_per_element']:.2f} per element")
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for shape, dtype in CX_NOISE_CHECKS:
        b = shape[0]
        seeds = torch.randint(-2**31, 2**31 - 1, (b, kernels.seed_width(dtype)),
                              generator=gen, device=dev, dtype=torch.int64).to(torch.int32)
        g = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        pairs = ((kernels.unit_noise(seeds, shape[1:], dtype),
                  kernels.unit_noise_plain(seeds, shape[1:], dtype)),
                 (kernels.damped_noise(g, seeds, 1e-9),
                  kernels.damped_noise_plain(g, seeds, 1e-9)))
        for what, (k, p) in zip(("unit", "fused"), pairs):
            if not _same_bits(k, p):
                raise AssertionError(f"noise {what} {shape} {dtype}: differs from "
                                     "the plain version")
        fused_err = (pairs[1][0] - pairs[1][1]).abs().max().item()
        power = torch.mean(torch.abs(pairs[0][0].to(torch.complex128)) ** 2).item()
        log(f"noise {shape} {dtype}: unit and fused bit-exact; mean |v|^2 {power:.4f}")
        del pairs
        if (shape, dtype) != (CX_NOISE_SHAPE, torch.complex64):
            continue
        numel = math.prod(shape)
        unit = lambda: kernels.unit_noise(seeds, shape[1:], dtype)
        fused = lambda: kernels.damped_noise(g, seeds, 1e-9)
        ms = {"unit": cuda_ms(unit, 20), "fused": cuda_ms(fused, 20)}
        plain = {"unit": cuda_ms(lambda: kernels.unit_noise_plain(seeds, shape[1:], dtype),
                                 2, 1),
                 "fused": cuda_ms(lambda: kernels.damped_noise_plain(g, seeds, 1e-9), 2, 1)}
        lib_ms = cuda_ms(lambda: torch.randn(shape, dtype=dtype, device=dev), 20)
        clock = sm_clock_hz(fused, max(300, int(500 / ms["fused"])))
        terms = {mode: (nbytes / PEAK_BYTES * 1e3,
                        instruction_ms(numel, loops[("complex64", mode == "fused", True)],
                                       clock))
                 for mode, nbytes in (("unit", numel * 8), ("fused", 2 * numel * 8))}
        for mode in ("unit", "fused"):
            t_bytes, t_instr = terms[mode]
            log(f"  complex64 {mode:5s} kernel {ms[mode]:.4f} ms  plain {plain[mode]:.3f} ms"
                f"{f'  torch.randn {lib_ms:.4f} ms' if mode == 'unit' else ''}  bound "
                f"{max(t_bytes, t_instr):.4f} ms: bytes {t_bytes:.4f} ms, instructions "
                f"{t_instr:.4f} ms (SM clock under load {clock / 1e6:.0f} MHz); "
                f"{max(t_bytes, t_instr) / ms[mode]:.3f} of the bound")
        t_bytes, t_instr = terms["fused"]
        out = dict(complex_shape=list(shape), complex_dtype="complex64",
                   complex_ms=ms["fused"], complex_plain_ms=plain["fused"],
                   complex_bound_ms=max(t_bytes, t_instr),
                   complex_bound_by="bytes" if t_bytes >= t_instr else "operations",
                   complex_library_ms=lib_ms, complex_max_abs_err=fused_err,
                   complex_unit_ms=ms["unit"], complex_unit_plain_ms=plain["unit"],
                   complex_unit_bound_ms=max(terms["unit"]))
        del g
        torch.cuda.empty_cache()
    return out


def _spread_diag(gen, shape, dev):
    """A spectrum 10^(2u - 1), u uniform: cond ~ 100 (``_spread_diag``)."""
    u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
    return 10.0 ** (2.0 * u - 1.0)


def _spread_hpd(gen, b, n, dtype, dev):
    """(b, n, n) Hermitian positive definite matrices Q diag(10^(2u - 1)) Q^H,
    Q the unitary factor of a complex Gaussian (``_spread_spd``)."""
    a = torch.randn((b, n, n), generator=gen, device=dev, dtype=torch.complex128)
    qm, _ = torch.linalg.qr(a)
    ev = _spread_diag(gen, (b, 1, n), dev).to(torch.complex128)
    return ((qm * ev) @ qm.mH).to(dtype)


def _fp_form(name, gen, dtype, dev):
    """The JAX test's synthetic Hessians (tests/test_kron_fixed_point.py
    ``_case``): (shape, H applied to a probe, max_size, max_skew)."""
    diag = lambda shape: _spread_diag(gen, shape, dev).to(dtype)   # noqa: E731
    hpd = lambda n: _spread_hpd(gen, 1, n, dtype, dev)[0]           # noqa: E731
    if name == "scalar":
        return (), (lambda v: 3.7 * v), 0.0, 0.0
    if name == "diag":
        h = diag((10,))
        return (10,), (lambda v: h * v), 0.0, 0.0
    if name == "matrix":
        h = hpd(5)
        return (5,), (lambda v: h @ v), math.inf, math.inf
    if name == "kron_diag_diag":
        h1, h2 = diag((10, 1)), diag((1, 3))
        return (10, 3), (lambda v: h1 * v * h2), 0.0, 0.0
    if name == "kron_diag_matrix":
        h1, h2 = diag((10, 1)), hpd(5)
        return (10, 5), (lambda v: h1 * (v @ h2)), 7.0, math.inf
    if name == "kron_matrix_diag":
        h1, h2 = hpd(5), diag((1, 10))
        return (5, 10), (lambda v: (h1 @ v) * h2), 7.0, math.inf
    if name == "kron_matrix_matrix":
        h1, h2 = hpd(5), hpd(7)
        return (5, 7), (lambda v: h1 @ v @ h2), math.inf, math.inf
    h1, h2, h3 = hpd(3), hpd(4), hpd(5)
    return (3, 4, 5), (lambda v: torch.einsum("li,mj,nk,ijk->lmn", h1, h2, h3, v)), \
        math.inf, math.inf


def _fp_run(shape, h_apply, plan, state, mode, steps, gen, dtype, dev, seed,
            stack=None, every=None):
    """The fixed-point drive: per step a probe v, g = H v, and the whitening
    fit on g or the Newton fit on (v, g) at lr (1 - i/N)/2, damping 0;
    ``stack``: B layers in one stacked call.  Returns (state, [(step,
    error)] every ``every`` steps and at the end)."""
    lead = () if stack is None else (stack,)
    root = fastrand.prng_key(seed)
    trail = []
    for i in range(steps):
        v = torch.randn(lead + shape, generator=gen, device=dev, dtype=dtype)
        g = h_apply(v)
        lr = (1.0 - i / steps) / 2.0
        key = fastrand.fold_in(root, i)
        keys = key if stack is None else fastrand.split(key, stack)
        if mode == "whiten":
            fit = (kron_p.update_kron_whiten if stack is None
                   else kron_p.update_kron_whiten_stacked)
            state = fit(state, plan, g, keys, lr=lr, damping=0.0)
        else:
            fit = (kron_p.update_kron_newton if stack is None
                   else kron_p.update_kron_newton_stacked)
            state = fit(state, plan, v, g, keys, lr=lr, damping=0.0)
        if every and (i + 1) % every == 0 and i + 1 < steps:
            trail.append((i + 1, _fp_error(state, plan, h_apply, shape, gen, dtype,
                                           dev, stack)))
    trail.append((steps, _fp_error(state, plan, h_apply, shape, gen, dtype, dev,
                                   stack)))
    return state, trail


def _fp_error(state, plan, h_apply, shape, gen, dtype, dev, stack, identity=False):
    """RMS relative error |P H v - v| / |v| over FP_PROBES fresh probes (P = I
    with ``identity``), over every layer of a stack."""
    lead = () if stack is None else (stack,)
    err = scale = 0.0
    for _ in range(FP_PROBES):
        v = torch.randn(lead + shape, generator=gen, device=dev, dtype=dtype)
        g = h_apply(v)
        if identity:
            pg = g
        elif stack is None:
            pg = kron_p.precond_grad(state, plan, g)
        else:
            pg = kron_p.precond_grad_stacked(state, plan, g)
        err += torch.sum(torch.abs(pg - v) ** 2).item()
        scale += torch.sum(torch.abs(v) ** 2).item()
    return (err / scale) ** 0.5


def _fp_small_run(run) -> tuple:
    """One fixed-point run at the JAX test's sizes in complex128 (its form,
    geometry, mode and N; its seed from their names), in a worker process:
    (form, dq, mode, steps, RMS relative error, seconds)."""
    form, dq, mode, steps, device = run
    torch.set_num_threads(1)
    dev = torch.device(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(
        zlib.crc32(f"{form}/{dq}/{mode}".encode()))
    shape, h_apply, max_size, max_skew = _fp_form(form, gen, torch.complex128, dev)
    st, plan = kron_p.init_kron(shape, 1.0, max_size, max_skew, dq,
                                dtype=torch.complex128, device=dev)
    _, trail = _fp_run(shape, h_apply, plan, st, mode, steps, gen, torch.complex128,
                       dev, 23)
    return form, dq, mode, steps, trail[-1][1], time.perf_counter() - t0


def start_fp_small_runs(dev) -> tuple:
    """The JAX test's sizes in complex128, started in the background: each
    of the seven geometries on kron_matrix_matrix, whitening and Newton,
    FP_SMALL_STEPS steps each (the JAX test's N); these 14 runs,
    host-bound, run side by side in FP_WORKERS processes
    (``_fp_small_run``) while this process goes on with the next paths.
    Returns what ``fp_small_results`` takes."""
    runs = [(form, dq, mode, FP_SMALL_STEPS, str(dev))
            # PRO4P's runs, the longest, first
            for form, dq in [(FP_SMALL_FORM, dq) for dq in
                             sorted(GEOMETRIES + ("Q0.5EQ1.5",), key=lambda d: d != "PRO4P")]
            for mode in ("whiten", "newton")]
    pool = multiprocessing.get_context("spawn").Pool(FP_WORKERS)
    return runs, pool, pool.map_async(_fp_small_run, runs, chunksize=1), time.perf_counter()


def fp_small_results(card: str, started: tuple) -> dict:
    """Waits for ``start_fp_small_runs``'s runs (their processes ended):
    every error below FP_TOL.  Returns no counts (the runs' launches stay
    in their processes)."""
    runs, pool, pending, t0 = started
    t_wait = time.perf_counter()
    try:
        results = pending.get(timeout=DIST_TIMEOUT_S)
    finally:
        pool.terminate()
        pool.join()
    for form, dq, mode, steps, err, seconds in results:
        log(f"  [{card}] fixed point complex128 {form} {dq} {mode}: error "
            f"{err:.4f} after {steps} steps ({seconds:.1f} s)")
        if not err < FP_TOL:
            raise AssertionError(f"fixed point {form}/{dq}/{mode}: error {err}")
    log(f"  [{card}] fixed point complex128: {len(runs)} runs in {FP_WORKERS} "
        f"processes, worst error {max(r[4] for r in results):.4f} (tol {FP_TOL}), "
        f"{time.perf_counter() - t0:.1f} s from their start, "
        f"{time.perf_counter() - t_wait:.1f} s of it waited for here")
    return {}


def complex_fixed_point_path(dev, card: str, small: list | None = None) -> dict:
    """Path A.  The JAX test's complex128 sizes started in the background
    (``start_fp_small_runs``, appended to ``small``; without it, waited
    for at the end of this path); then the full-width
    stack (``FP_STACK``, complex64, B layers each with its own H1 (x) H2):
    the Newton fit must bring the RMS relative error below FP_TOL within
    FP_NEWTON_STEPS steps, the whitening fit below half of P = I's within
    FP_WHITEN_STEPS; both trajectories logged.
    Returns the launch counts."""
    started = start_fp_small_runs(dev)
    if small is not None:
        small.append(started)
    b, m, n = FP_STACK
    gen = torch.Generator(device=dev).manual_seed(21)
    h1 = _spread_hpd(gen, b, m, torch.complex64, dev)
    h2 = _spread_hpd(gen, b, n, torch.complex64, dev)
    h_apply = lambda v: h1 @ v @ h2      # noqa: E731
    plan = kron_p.make_kron_plan((m, n), max_size=math.inf, max_skew=math.inf)
    ident = _fp_error(None, plan, h_apply, (m, n), gen, torch.complex64, dev, b, True)
    kernels.reset_launch_counts()
    for mode, steps in (("newton", FP_NEWTON_STEPS), ("whiten", FP_WHITEN_STEPS)):
        st, _ = kron_p.init_kron((m, n), 1.0, math.inf, math.inf,
                                 dtype=torch.complex64, device=dev)
        st = kron_p.KronState(tuple(f.expand((b,) + f.shape).clone() for f in st.q),
                              tuple(l.expand(b).clone() for l in st.lips))
        t0 = time.perf_counter()
        st, trail = _fp_run((m, n), h_apply, plan, st, mode, steps, gen,
                            torch.complex64, dev, 22, stack=b, every=max(steps // 6, 1))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        err = trail[-1][1]
        limit = FP_TOL if mode == "newton" else ident / 2
        log(f"  [{card}] fixed point {FP_STACK} complex64 {mode}: P = I error "
            f"{ident:.4f}; trajectory {[(s, round(e, 4)) for s, e in trail]}; "
            f"{ms:.1f} ms per fit step (probe, H v and fit)")
        if not err < limit:
            raise AssertionError(f"fixed point {mode}: error {err} not below {limit}")
        del st
    counts = _all_counts()
    counts["xla_ns_update"] = kernels.xla_ns_update.launches
    counts["philox_start"] = kernels.philox_start.launches
    counts["damped_noise.complex"] = kernels.damped_noise.complex_launches
    expect = 2 * FP_NEWTON_STEPS + 2 * FP_WHITEN_STEPS
    log(f"  fixed point launches: {counts}")
    if counts["xla_ns_update"] != expect or counts["philox_start"] != 2 * expect or \
            counts["damped_noise.complex"] != FP_NEWTON_STEPS + FP_WHITEN_STEPS or \
            any(counts[k] for k in CX_IDLE_ROWS):
        raise AssertionError(f"fixed point: launch counts {counts}, expected "
                             f"{expect} XLA tails (two starts each) and one complex "
                             "damping per step")
    del h1, h2
    torch.cuda.empty_cache()
    if small is None:
        fp_small_results(card, started)
    return counts


def _cx_problem(layers, shapes, batch, dtype, dev, gen):
    """Complex least squares per layer and leaf: W (layers, m, d) from 0,
    X (d, batch) with its rows scaled by 10^[-1, 1] (cond 100 in X X^H),
    Y = W* X + 0.01 noise, W* Gaussian / sqrt(d), drawn from ``gen`` on
    its device.  Returns (params, loss) with loss() = sum 0.5 |W X - Y|^2 /
    batch; ``loss.data`` is the (X, Y) of each leaf."""
    params, data = [], []
    for m, d in shapes:
        gdev = gen.device
        s = 10.0 ** torch.linspace(-1.0, 1.0, d, dtype=torch.float64, device=gdev)
        x = torch.randn((d, batch), generator=gen, device=gdev, dtype=dtype) * s[:, None].to(dtype)
        w_true = torch.randn((layers, m, d), generator=gen, device=gdev, dtype=dtype) / d ** 0.5
        y = w_true @ x + 0.01 * torch.randn((layers, m, batch), generator=gen,
                                            device=gdev, dtype=dtype)
        params.append(torch.zeros((layers, m, d), dtype=dtype, device=dev).requires_grad_())
        data.append((x.to(dev), y.to(dev)))
    return params, _cx_loss(params, data)


def _cx_loss(params, data):
    """loss() = sum 0.5 |W X - Y|^2 / batch over the leaves and their
    (X, Y) in ``data``; ``loss.data`` is ``data``."""
    def loss():
        total = 0.0
        for w, (x, y) in zip(params, data):
            r = w @ x - y
            total = total + 0.5 * torch.sum(torch.real(r * r.conj())) / x.shape[-1]
        return total

    loss.data = data
    return loss


def _cx_opt(name, params, dev, steps_p1=None):
    """Path B's optimizers: KronWhiten with the main path's settings
    (Q0.5EQ1.5, momentum 0.9, momentum whitening, max_skew 2, scanned
    layers; Q and momentum in the parameters' complex dtype) or KronNewton
    (exact Hvp), p = 1 for ``steps_p1`` steps, then 0.1."""
    prob = 1.0 if steps_p1 is None else (lambda c: 1.0 if c < steps_p1 else 0.1)
    common = dict(preconditioner_max_skew=2.0, preconditioner_init_scale=None,
                  preconditioner_update_probability=prob,
                  scanned_layers=[True] * len(params), device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the advisories
        if name == "KronWhiten":
            return KronWhiten(params, lr=1e-3, momentum=0.9, whiten_grad=False, **common)
        return KronNewton(params, lr=0.2, **common)


def _cx_step(opt, loss):
    if isinstance(opt, KronNewton):
        return opt.step(loss)
    opt.zero_grad(set_to_none=True)
    out = loss()
    out.backward()
    opt.step()
    return out


def check_complex_small(dev) -> None:
    """Path B at a tiny width (``CX_TINY``) on the card against the CPU: 3
    steps of KronWhiten and of KronNewton from the same data and seeds (the
    same Philox noise on both), parameters within rtol 1e-4 in complex64
    and 1e-9 in complex128 (Frobenius-relative)."""
    layers, shapes, batch = CX_TINY
    for dtype, tol in ((torch.complex64, 1e-4), (torch.complex128, 1e-9)):
        for name in ("KronWhiten", "KronNewton"):
            finals = []
            for device in (dev, torch.device("cpu")):
                gen = torch.Generator().manual_seed(31)
                params, loss = _cx_problem(layers, shapes, batch, dtype, device, gen)
                opt = _cx_opt(name, params, device)
                for _ in range(3):
                    _cx_step(opt, loss)
                finals.append(torch.cat([p.detach().cpu().flatten() for p in params]))
            rel = ((finals[0] - finals[1]).norm() / finals[1].norm()).item()
            log(f"complex small path ({name}, {dtype}, layers {layers}, shapes {shapes}, "
                f"3 steps): card vs CPU rel err {rel:.2e} (tol {tol:g})")
            if not rel < tol:
                raise AssertionError(f"complex small path {name} {dtype}: {rel}")


def complex_optimizer_path(dev, card: str) -> dict:
    """Path B.  KronWhiten and KronNewton (``_cx_opt``) on the complex least
    squares (``_cx_problem``) over CX_LAYERS layers of complex64 parameters
    in ``CX_SHAPES``, batch CX_BATCH, CX_STEPS steps each (p = 1 for
    CX_STEPS_P1, then 0.1): the loss falls (by how much is logged), each
    fit step launches exactly ``CX_WHITEN_PER_FIT`` / ``CX_NEWTON_PER_FIT``
    (the complex noise mode and the XLA tail) and no other row; fit and
    no-fit step times and peak memory logged; after a state_dict round
    trip (torch.save / torch.load(weights_only=True)) into a fresh
    optimizer Q and the momentum are still complex64 and bitwise equal.
    Returns the launch counts (with the complex mode's)."""
    import io
    total = {}
    for name, per_fit in (("KronWhiten", CX_WHITEN_PER_FIT),
                          ("KronNewton", CX_NEWTON_PER_FIT)):
        gen = torch.Generator(device=dev).manual_seed(32)
        params, loss = _cx_problem(CX_LAYERS, CX_SHAPES, CX_BATCH, torch.complex64,
                                   dev, gen)
        opt = _cx_opt(name, params, dev, CX_STEPS_P1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, fit_ms, nofit_ms = [], [], []
        for step in range(CX_STEPS):
            fits0 = opt.fit_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(_cx_step(opt, loss).item())
            torch.cuda.synchronize()
            (fit_ms if opt.fit_steps > fits0 else nofit_ms).append(
                (time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        fits = opt.fit_steps
        counts = {k: getattr(kernels, k).launches for k in per_fit}
        cx = {k: getattr(kernels, k).complex_launches for k in ("damped_noise", "unit_noise")}
        idle = {k: getattr(kernels, k).launches for k in CX_IDLE_ROWS}
        what = "train step (closure: forward, Hvp or backward, fit, apply)" \
            if name == "KronNewton" else "train step (forward, backward, optimizer)"
        log(f"  [{card}] complex least squares {CX_LAYERS} x {CX_SHAPES} complex64, batch "
            f"{CX_BATCH}, {name}: loss {losses[0]:.6g} -> {losses[-1]:.6g} in {CX_STEPS} "
            f"steps ({losses[0] / losses[-1]:.3g}x; at step 50 {losses[49]:.6g}); "
            f"{what} median fit {_median(fit_ms[1:])} ms, no fit {_median(nofit_ms)} ms; "
            f"peak memory {peak:.2f} GB; fit steps {fits}; launches {counts}, complex "
            f"mode {cx}, other rows {idle}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"complex {name}: loss {losses[0]} -> {losses[-1]}")
        if fits == 0 or any(counts[k] != v * fits for k, v in per_fit.items()) or \
                cx["damped_noise"] != counts["damped_noise"] or \
                cx["unit_noise"] != counts.get("unit_noise", 0) or any(idle.values()):
            raise AssertionError(f"complex {name}: launches {counts} {cx} {idle} for "
                                 f"{fits} fit steps, expected {per_fit} per fit step")
        buf = io.BytesIO()
        torch.save(opt.state_dict(), buf)
        buf.seek(0)
        twin = _cx_opt(name, params, dev, CX_STEPS_P1)
        twin.load_state_dict(torch.load(buf, weights_only=True))
        for p in params:
            for a, b in zip(twin.state[p]["q"] + (twin.state[p].get("mu", p),),
                            opt.state[p]["q"] + (opt.state[p].get("mu", p),)):
                if a.dtype != torch.complex64 or not _same_bits(a, b):
                    raise AssertionError(f"complex {name}: state_dict round trip gave "
                                         f"{a.dtype}, bits equal {_same_bits(a, b)}")
        log(f"  complex {name}: state_dict round trip ({buf.getbuffer().nbytes / 1e6:.1f} "
            "MB) keeps Q and the momentum complex64, bit for bit")
        _add(total, counts)
        total["damped_noise.complex"] = total.get("damped_noise.complex", 0) + cx["damped_noise"]
        total["unit_noise.complex"] = total.get("unit_noise.complex", 0) + cx["unit_noise"]
        del params, loss, opt, twin, buf
        gc.collect()
        torch.cuda.empty_cache()
    return total


# the complex LRA, dense and legacy path (ROADMAP A3b): complex64 throughout,
# the JAX package's forms (transposes where a Hermitian preconditioner would
# conjugate; Affine conjugates).  Arm: (label, JAX factory, port optimizer,
# Newton, problem, lr, options).  Problems: "full" path B's least squares
# over CX_LAYERS x CX_SHAPES (n = 28,311,552); "dense" one (17, 100) leaf,
# n = 1700 (the tensor-rank case's dense width); "pair" one layer of
# CX_SHAPES (Affine's (768, 2304) and (768, 768) leaves).
CXL_ARMS = (
    ("LRAWhiten", "lra_whiten", "LRAWhiten", False, "full", 1e-3,
     dict(rank_of_approximation=LRA_RANK, momentum=0.9)),
    ("LRANewton", "lra_newton", "LRANewton", True, "full", 0.2,
     dict(rank_of_approximation=LRA_RANK)),
    ("DenseNewton Q0.5EQ1.5", "dense_newton", "DenseNewton", True, "dense", 0.2,
     dict(dq="Q0.5EQ1.5")),
    ("DenseNewton PRO4P", "dense_newton", "DenseNewton", True, "dense", 0.2,
     dict(dq="PRO4P")),
    ("XMat", "xmat", "XMat", False, "dense", 1e-3, dict()),
    ("NewtonInv", "newton_inv", "NewtonInv", True, "dense", 0.2,
     dict(preconditioner_type="Newton")),
    ("SPLU", "splu", "SPLU", False, "full", 1e-3, dict(rank=LRA_RANK)),
    # the '1st' normalizer: JAX's UVd '2nd' normalizer takes the least real
    # part of a complex minimum and leaves the loss non-finite in 2 steps
    # (tools/complex_fall_jax.py; the port follows it)
    ("UVd", "uvd", "UVd", False, "full", 1e-3,
     dict(rank=LRA_RANK, step_normalizer="1st")),
    ("Affine", "affine", "Affine", False, "pair", 1e-3, dict()),
)
CXL_PROBLEMS = {"full": (CX_LAYERS, CX_SHAPES, CX_BATCH),
                "dense": (1, ((17, 100),), 512),
                "pair": (1, CX_SHAPES, CX_BATCH)}
# the same arms at a small size: the card against the CPU, and the JAX
# package's own run (tools/complex_fall_jax.py)
CXL_SMALL = {"full": CX_TINY, "dense": (1, ((5, 20),), 64),
             "pair": (1, CX_TINY[1], CX_TINY[2])}
CXL_STEPS = 4
CXL_SMALL_STEPS = 3
# card against CPU after CXL_SMALL_STEPS steps (Frobenius-relative, the
# parameters), each arm with an explicit init scale of 1: the on-the-fly
# scale is a float32 sum, taken in another order on the card, and the dense
# arms' first steps move their complex128 result 100-200 times as far as
# that scale moves (on the CPU 4.6e-5 and 1.4e-5 for 2^-22 of it; card
# against CPU with it 2.3e-5 and 6.8e-6 on an H100).  In complex128 within
# CXL_SMALL_REL_128, the check of the code path (LRAWhiten's amplitude clip
# still sums in float32: 1.14e-9 on an H100, as CLIP_RTOL in
# tests/test_torch_lra_dense_optim.py allows for the same sum); in
# complex64 within CXL_SMALL_REL (check_complex_small's gate) or, where the
# arm's steps amplify float32 rounding more, CXL_ROUNDING times the
# distance of the CPU's own complex64 run from its complex128 run on the
# same data and draws (the non-Hermitian dense forms: the CPU's complex64
# PRO4P 8.9e-6 from its complex128).  A fault in a kernel or a form (a
# dropped conjugate) moves them by 1e-2 or more
CXL_SMALL_REL = 1e-4
CXL_SMALL_REL_128 = 1e-6
CXL_ROUNDING = 10.0
# the arms whose loss the JAX package's own run brings down at every one of
# CXL_STEPS steps at the small size (tools/complex_fall_jax.py): gated to
# fall.  Its DenseNewton Q0.5EQ1.5 rises by step 4 and its XMat after step
# 2 (both diverge by step 50): not gated
CXL_FALLS = ("LRAWhiten", "LRANewton", "DenseNewton PRO4P", "NewtonInv", "SPLU", "UVd",
             "Affine")
# per fit step: the LRA whitening probe and damping; the Newton probes (one
# per parameter) and damping; the dense Q0.5EQ1.5 rotation in PyTorch
# operations and its start; PRO4P's 10 loop starts; the legacy families
# launch nothing
CXL_PER_FIT = {
    "LRAWhiten": {"unit_noise": 1, "damped_noise": 1},
    "LRANewton": {"unit_noise": len(CX_SHAPES), "damped_noise": 1},
    "DenseNewton Q0.5EQ1.5": {"unit_noise": 1, "damped_noise": 1, "xla_procrustes": 1,
                              "philox_start": 1},
    "DenseNewton PRO4P": {"unit_noise": 1, "damped_noise": 1, "philox_start": 10},
}
CXL_COUNTED = ("unit_noise", "damped_noise", "xla_procrustes", "philox_start",
               "xla_ns_update")
# row 2's complex mode at this path's shapes: the LRA vector and the dense width
CXL_NOISE_SHAPES = ((1, 28311552), (1, 1700))


def check_noise_complex_shapes(dev, lib_path, shapes=CXL_NOISE_SHAPES) -> list:
    """Row 2's complex mode (complex64) at ``shapes``, unit and fused, bit
    for bit against the plain versions, each timed beside its plain
    version and ``torch.randn(..., dtype=torch.complex64)``, its bound the
    larger of its bytes (unit: 8 bytes written per element; fused: 8 read
    and 8 written) and its loop's SASS instructions at the issue rate.
    Returns the entries for the ``kernels`` line's row 2."""
    loops = _noise_loops(str(lib_path))
    gen = torch.Generator(device=dev).manual_seed(13)
    out, clock = [], None
    for shape in shapes:
        b, numel = shape[0], math.prod(shape)
        dtype = torch.complex64
        seeds = torch.randint(-2**31, 2**31 - 1, (b, 4), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)
        g = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        unit = lambda: kernels.unit_noise(seeds, shape[1:], dtype)
        fused = lambda: kernels.damped_noise(g, seeds, 1e-9)
        for what, k, p in (("unit", unit(), kernels.unit_noise_plain(seeds, shape[1:], dtype)),
                           ("fused", fused(), kernels.damped_noise_plain(g, seeds, 1e-9))):
            if not _same_bits(k, p):
                raise AssertionError(f"noise {what} {shape} complex64: differs from "
                                     "the plain version")
            del k, p
        vec = shape[-1] % 8 == 0
        iters = 20 if numel > 1e6 else 50
        ms = {"unit": cuda_ms(unit, iters), "fused": cuda_ms(fused, iters)}
        plain = {"unit": cuda_ms(lambda: kernels.unit_noise_plain(seeds, shape[1:], dtype),
                                 2, 1),
                 "fused": cuda_ms(lambda: kernels.damped_noise_plain(g, seeds, 1e-9), 2, 1)}
        lib_ms = cuda_ms(lambda: torch.randn(shape, dtype=dtype, device=dev), iters)
        # the SM clock under the first (largest) shape's load: a launch-bound
        # shape would take thousands of launches to hold the card busy
        clock = clock or sm_clock_hz(fused, max(300, int(500 / ms["fused"])))
        row = dict(shape=list(shape), dtype="complex64", max_abs_err=0.0,
                   library_ms=lib_ms, kernel=("vector" if vec else "scalar"))
        for mode, nbytes in (("unit", numel * 8), ("fused", 2 * numel * 8)):
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_instr = instruction_ms(numel, loops[("complex64", mode == "fused", vec)], clock)
            bound = max(t_bytes, t_instr)
            pre = "" if mode == "fused" else "unit_"
            row.update({f"{pre}ms": ms[mode], f"{pre}plain_ms": plain[mode],
                        f"{pre}bound_ms": bound,
                        f"{pre}bound_by": "bytes" if t_bytes >= t_instr else "operations"})
            log(f"  noise complex64 {shape} {mode:5s} ({row['kernel']} kernel): bit-exact; "
                f"kernel {ms[mode]:.4f} ms  plain {plain[mode]:.3f} ms"
                f"{f'  torch.randn {lib_ms:.4f} ms' if mode == 'unit' else ''}  bound "
                f"{bound:.4f} ms: bytes {t_bytes:.4f} ms, instructions {t_instr:.4f} ms "
                f"(SM clock under load {clock / 1e6:.0f} MHz); {bound / ms[mode]:.3f} of "
                "the bound")
        out.append(row)
        del g
        torch.cuda.empty_cache()
    return out


# row 2's complex mode at the vector-sharded complex arms' shapes (ROADMAP
# A3c): a shard of 2 of the least squares' vector (arms D and E) and the
# dense arm's padded n over 3 ranks (F)
CX_VECTOR_NOISE_SHAPES = ((1, CX_LAYERS * sum(m * d for m, d in CX_SHAPES) // 2), (1, 1701))


def check_vector_noise_complex(dev, lib_path) -> list:
    """Row 2's complex mode (complex64) bit for bit against its plain
    version at the keys arms D, E and F launch it under on their first
    fit: D's probe and damping (unit and fused) and E's damping at (1, n/2)
    under each shard's folded key, F's damping at (1, 1701) under the
    unfolded key; then both shapes timed and bounded as
    ``check_noise_complex_shapes`` does (beside ``torch.randn`` in
    complex64).  Returns the entries for the ``kernels`` line's row 2."""
    dtype = torch.complex64
    (_, n_loc), (_, n_pad) = CX_VECTOR_NOISE_SHAPES
    gen = torch.Generator(device=dev).manual_seed(37)
    g = torch.randn((1, n_loc), generator=gen, device=dev, dtype=dtype)
    cases = [(n_loc, key, mode) for key in vector_noise_seeds(3, 2) for mode in ("unit", "fused")] \
        + [(n_loc, key, "fused") for key in vector_noise_seeds(4, 2)] \
        + [(n_pad, key, "fused") for key in vector_noise_seeds(4, 1, False)]
    differ = []
    for n, key, mode in cases:
        seeds = kernels.key_seed_words(fastrand.noise_keys(key[None], dtype), dev)
        if mode == "unit":
            a = kernels.unit_noise(seeds, (n,), dtype)
            b = kernels.unit_noise_plain(seeds, (n,), dtype)
        else:
            a = kernels.damped_noise(g[:, :n], seeds, 1e-9)
            b = kernels.damped_noise_plain(g[:, :n], seeds, 1e-9)
        if not _same_bits(a, b):
            differ.append((n, mode))
        del a, b
    del g
    if differ:
        raise AssertionError(f"complex noise at the vector-sharded arms' keys differs from "
                             f"its plain version: {differ}")
    log(f"noise complex64 bit for bit at the vector-sharded complex arms' {len(cases)} "
        f"(shape, key, mode) launches: (1, {n_loc}) unit and fused under each shard's "
        f"folded key (arms D, E), (1, {n_pad}) fused unfolded (F)")
    return check_noise_complex_shapes(dev, lib_path, CX_VECTOR_NOISE_SHAPES)


_CXL_OPTIMIZERS = {cls.__name__: cls for cls in (
    LRAWhiten, LRANewton, DenseNewton, legacy_optim.XMat, legacy_optim.SPLU,
    legacy_optim.NewtonInv, legacy_optim.UVd, legacy_optim.Affine)}


def _cxl_opt(arm, params, device, draw=None, **options):
    """An arm's optimizer over ``params`` on ``device`` (the advisories
    silenced), ``options`` over the arm's; Affine takes (name, parameter)
    pairs."""
    label, _, cls_name, _, kind, lr, kw = arm
    kw = dict(kw, **options)
    cls = _CXL_OPTIMIZERS[cls_name]
    if cls_name == "Affine":
        params = [(f"w{i}", p) for i, p in enumerate(params)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(params, lr=lr, device=device, draw=draw, **kw)


def _cxl_step(arm, opt, loss):
    """One step: Newton by the closure, whitening by backward and step()."""
    if arm[3]:
        return opt.step(loss)
    opt.zero_grad(set_to_none=True)
    out = loss()
    out.backward()
    opt.step()
    return out


def _cpu_normal(kind, keys, shape, dtype):
    """A replay hook that draws the legacy families' normals on the CPU
    (``torch.randn`` from the key's generator, in complex128 or float64,
    then cast) and their uniforms as the optimizers do, so the card and
    the CPU, and the complex64 and complex128 runs, see the same draws."""
    if kind == "uniform":
        return torch.from_numpy(fastrand.uniform01(keys).astype(np.float64))
    gen = fastrand.generator(keys[0], "cpu")
    wide = torch.complex128 if dtype.is_complex else torch.float64
    return torch.randn((len(keys),) + tuple(shape), dtype=wide,
                       generator=gen).to(dtype)


def _cxl_small_run(arm, device, dtype) -> tuple:
    """An arm's CXL_SMALL_STEPS steps at its small size in ``dtype`` on
    ``device``, from the same data (drawn in complex128, cast) and seeds:
    (its parameters flat on the CPU, the optimizer, the parameters)."""
    draw = None if arm[2] in ("LRAWhiten", "LRANewton", "DenseNewton") else _cpu_normal
    gen = torch.Generator().manual_seed(41)
    ref, ref_loss = _cx_problem(*CXL_SMALL[arm[4]], torch.complex128,
                                torch.device("cpu"), gen)
    params = [torch.zeros(p.shape, dtype=dtype, device=device, requires_grad=True)
              for p in ref]
    loss = _cx_loss(params, [(x.to(device, dtype), y.to(device, dtype))
                             for x, y in ref_loss.data])
    opt = _cxl_opt(arm, params, device, draw, preconditioner_init_scale=1.0)
    for _ in range(CXL_SMALL_STEPS):
        _cxl_step(arm, opt, loss)
    return torch.cat([p.detach().cpu().flatten() for p in params]), opt, params


def _cx_rel(a, b) -> float:
    """|a - b| / |b| (Frobenius), complex."""
    return ((a.to(torch.complex128) - b.to(torch.complex128)).norm() / b.norm()).item()


def check_complex_lra_dense_small(dev) -> float:
    """Every arm of ``CXL_ARMS`` at its small size (``CXL_SMALL``) on the
    card against the CPU, CXL_SMALL_STEPS steps from the same data and
    seeds (the LRA and dense noise is the same Philox on both; the legacy
    families' normals come from ``_cpu_normal`` on both): the parameters
    within CXL_SMALL_REL_128 in complex128, and in complex64 within the
    larger of CXL_SMALL_REL and CXL_ROUNDING times the CPU's own
    complex64-to-complex128 distance (Frobenius-relative).  The card's
    complex64 optimizer then takes its state_dict round trip
    (``_cxl_round_trip``).  Returns the worst complex64 gap."""
    worst, failed = 0.0, []
    for arm in CXL_ARMS:
        (card64, opt, params), (cpu64, _, _), (card128, _, _), (cpu128, _, _) = (
            _cxl_small_run(arm, device, dtype)
            for dtype in (torch.complex64, torch.complex128)
            for device in (dev, torch.device("cpu")))
        mb = _cxl_round_trip(arm, opt, params)
        rel64, rel128 = _cx_rel(card64, cpu64), _cx_rel(card128, cpu128)
        rounding = _cx_rel(cpu64, cpu128)
        gate = max(CXL_SMALL_REL, CXL_ROUNDING * rounding)
        log(f"  complex small {arm[0]} ({CXL_SMALL[arm[4]]}, {CXL_SMALL_STEPS} steps): "
            f"card against CPU complex64 {rel64:.2e} (gate {gate:.2e}; the CPU's complex64 "
            f"from its complex128 {rounding:.2e}), complex128 {rel128:.2e} (gate "
            f"{CXL_SMALL_REL_128:g}); the card's state_dict round trip ({mb:.2f} MB) "
            "bit for bit")
        if not (torch.isfinite(torch.view_as_real(card64)).all() and rel64 < gate
                and rel128 < CXL_SMALL_REL_128):
            failed.append((arm[0], rel64, rel128))
        worst = max(worst, rel64)
    if failed:
        raise AssertionError(f"complex small, card against CPU: {failed}")
    return worst


def _cxl_round_trip(arm, opt, params) -> float:
    """The optimizer's state through torch.save / torch.load(weights_only=
    True) into a fresh optimizer: every tensor of the state comes back
    complex64 (or its real dtype) bit for bit.  Returns the MB moved."""
    import io
    buf = io.BytesIO()
    sd = opt.state_dict()
    torch.save(sd, buf)
    buf.seek(0)
    twin = _cxl_opt(arm, params, params[0].device)
    twin.load_state_dict(torch.load(buf, weights_only=True))
    mine, theirs = _state_leaves(sd), _state_leaves(twin.state_dict())
    cx = [w for w, t in mine if t.dtype == torch.complex64]
    if [w for w, _ in mine] != [w for w, _ in theirs] or not cx or any(
            a.dtype != b.dtype or not _same_bits(a, b)
            for (_, a), (_, b) in zip(mine, theirs)):
        raise AssertionError(f"{arm[0]}: the state_dict round trip changed the state")
    del twin, sd
    return buf.getbuffer().nbytes / 1e6


def complex_lra_dense_path(dev, card: str) -> dict:
    """ROADMAP A3b on the card, complex64: each arm of ``CXL_ARMS`` on its
    problem at full size, CXL_STEPS steps, every step a fit.  Gates: the
    losses finite, and falling where the JAX package's own run falls
    (``CXL_FALLS``, from tools/complex_fall_jax.py); exactly
    ``CXL_PER_FIT`` launches per fit step (all of the noise's in its
    complex mode), no launch of any other row nor of the XLA tail; and,
    first, every arm at its small size on the card against the CPU, with
    a state_dict round trip bit for bit (``check_complex_lra_dense_small``;
    at full size LRAWhiten's 4983 MB state took 10.6 s to go through
    ``torch.save`` on an H100 host).
    Returns the launch counts (with the complex mode's)."""
    t_start = time.perf_counter()
    worst = check_complex_lra_dense_small(dev)
    t_small = time.perf_counter() - t_start
    total = {}
    for arm in CXL_ARMS:
        label, _, _, newton, kind, _, _ = arm
        gen = torch.Generator(device=dev).manual_seed(33)
        params, loss = _cx_problem(*CXL_PROBLEMS[kind], torch.complex64, dev, gen)
        n = sum(p.numel() for p in params)
        t0 = time.perf_counter()
        opt = _cxl_opt(arm, params, dev)
        torch.cuda.synchronize()
        init_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        core = getattr(opt, "optimizer", opt)
        losses, ms = [], []
        for _ in range(CXL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(_cxl_step(arm, opt, loss).item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 1e9
        fits = core.fit_steps
        counts = {k: getattr(kernels, k).launches for k in CXL_COUNTED}
        cx = {k: getattr(kernels, k).complex_launches for k in ("damped_noise", "unit_noise")}
        idle = {k: getattr(kernels, k).launches for k in CX_IDLE_ROWS}
        want = {k: CXL_PER_FIT.get(label, {}).get(k, 0) * fits for k in CXL_COUNTED}
        log(f"  [{card}] {label} (n = {n}, {'Newton' if newton else 'whitening'}): loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g} in {CXL_STEPS} steps "
            f"({losses[0] / losses[-1]:.4g}x); init {init_ms:.1f} ms, steps "
            f"{', '.join(f'{x:.1f}' for x in ms)} ms; peak memory {peak:.2f} GB; fit "
            f"steps {fits}; launches {counts}, complex mode {cx}, other rows {idle}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: loss {losses}")
        if label in CXL_FALLS:
            _falls(label, losses[0], losses[-1])
        if fits != CXL_STEPS or counts != want or any(idle.values()) or \
                cx["damped_noise"] != counts["damped_noise"] or \
                cx["unit_noise"] != counts["unit_noise"]:
            raise AssertionError(f"{label}: launches {counts} {cx} {idle} for {fits} "
                                 f"fit steps, expected {want}")
        _add(total, counts)
        total["damped_noise.complex"] = total.get("damped_noise.complex", 0) + cx["damped_noise"]
        total["unit_noise.complex"] = total.get("unit_noise.complex", 0) + cx["unit_noise"]
        del params, loss, opt, core
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  [{card}] complex LRA, dense and legacy path: "
        f"{time.perf_counter() - t_start:.1f} s (card against CPU {t_small:.1f} s, worst "
        f"{worst:.2e})")
    return total


_NS_KERNELS = ("gemm_kernel", "tc_gemm_kernel", "row_stats_kernel", "select_kernel",
               "start_kernel", "row_norm_kernel", "bound_scalars_kernel",
               "transpose_sub_kernel", "combine_kernel", "trace_sum_kernel")


def _category(kernel: str) -> str:
    if any(k in kernel for k in _NS_KERNELS):
        return "NS and norm-bound kernels (ours)"
    if "noise_kernel" in kernel:
        return "noise (ours)"
    # cuBLAS's f32 GEMMs without tensor cores (TF32 is off here): the f32
    # P apply of an f32 Q, and f32 products of the Hvp pass's math attention
    if "f32f32_f32f32" in kernel or "simt_sgemm" in kernel:
        return "cuBLAS f32 matmuls (FFMA units)"
    # its matrix-vector products: the LRA fit's U^T x and V^T x at n = 124.5M
    if "gemv" in kernel:
        return "cuBLAS matrix-vector products"
    if "nvjet" in kernel or "gemm" in kernel.lower() or "cutlass" in kernel:
        return "cuBLAS matmuls (model, P apply, term1)"
    if "sdpa" in kernel or "flash" in kernel or "fmha" in kernel:
        return "attention (cuDNN)"
    if "reduce_kernel" in kernel or "SoftMax" in kernel:
        return "PyTorch reductions and softmax"
    return "PyTorch elementwise and copies"


def profile_steps(label, state, card: str, probs, tensor_cores: bool = True):
    """Where one training step's device time goes, for each update
    probability in ``probs`` (1: a fit step, 0: none), from
    torch.profiler's CUDA kernel events.  The full tables go to the
    git-ignored OUT_DIR.  With ``tensor_cores`` (the bf16 paths, widths
    n % 8 == 0, where every NS product runs on the tensor cores) a fit step
    fails if it launched an FFMA ``gemm_kernel``.  Returns {prob: {category:
    (device us, launches)}}."""
    model, loss_fn, opt, tokens, targets = state
    OUT_DIR.mkdir(exist_ok=True)
    group = opt.param_groups[0]
    out = {}
    for prob in probs:
        what = "fit step (p=1)" if prob else "no-fit step (p=0)"
        group["preconditioner_update_probability"] = prob
        kern, wall_ms = _profiled(
            lambda: _one_step(model, loss_fn, opt, tokens, targets), cpu=True)
        # kernels only: user ranges such as Optimizer.step#... span kernels
        dev_us = {e.key: (_device_us(e), e.count) for e in kern
                  if "#" not in e.key and not e.key.startswith("Optimizer.")}
        total_ms = sum(t for t, _ in dev_us.values()) / 1e3
        cats = {}
        for k, (t, c) in dev_us.items():
            tt, cc = cats.get(_category(k), (0.0, 0))
            cats[_category(k)] = (tt + t, cc + c)
        ns_ms = cats.get(_category("gemm_kernel"), (0.0, 0))[0] / 1e3
        log(f"  [{card}] profile {label} {what}: wall {wall_ms:.1f} ms "
            f"(profiler on), kernels {total_ms:.1f} ms, device idle share "
            f"{max(0.0, 1 - total_ms / wall_ms):.2f}, NS share of kernel time "
            f"{ns_ms / total_ms:.3f}")
        for cat, (t, c) in sorted(cats.items(), key=lambda x: -x[1][0]):
            log(f"    {t / 1e3:8.2f} ms  {c:5d} launches  {cat}")
        tag = re.sub(r"[^a-z0-9]+", "_", label.lower()).strip("_")
        fname = OUT_DIR / f"chip_smoke_profile_{tag}_{'fit' if prob else 'nofit'}.txt"
        with open(fname, "w") as fh:
            fh.write(f"{card}\n{label} {what}\n")
            for k, (t, c) in sorted(dev_us.items(), key=lambda x: -x[1][0]):
                fh.write(f"{t / 1e3:10.3f} ms {c:6d}  {k}\n")
        ffma = sorted({_short(k) for k in dev_us
                       if _short(k).startswith("gemm_kernel<")})
        log(f"    FFMA gemm_kernel launches: {ffma or 'none'}")
        if prob and ffma and tensor_cores:
            raise AssertionError(f"{label} {what} ran the FFMA GEMM: {ffma}")
        out[prob] = cats
    return out


# ---------------------------------------------------------------------------
# The distributed paths: ranks are processes on cuda:0 joined by gloo
# ---------------------------------------------------------------------------

# p = 1.0, then 0.1 (once 3 and 3): seed 0's gate at p = 0.1 closes
# at step 1 and opens at 2, so 3 steps keep a fit and a no-fit step after
# the first
DIST_STEPS = (1, 2)
DIST_DP_STEPS = 6
DIST_TIMEOUT_S = 600
DIST_LABEL = "2 ranks sharing one H100 over gloo; not a scaling figure"
# (model, optimizer) of the stack-sharded arms, LLaMA's first: its three
# processes take ~66 GB, which the card holds only before the others' caches
# grow; LLaMA's Newton arm stays out (two ranks at its 34.2 GB peak do not
# fit beside the reference)
DIST_ARMS = ("llama", "gpt2", "gpt2_newton")


def _digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its dtype and shape prefixed)."""
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _bcast(t: torch.Tensor, src: int = 0, group=None) -> None:
    """Rank ``src``'s tensor into every rank's (of ``group``, default the
    world), bit for bit (its bytes)."""
    dist.broadcast(t.reshape(-1).view(torch.uint8), src=src, group=group)


def _no_nvcc():
    raise RuntimeError("a rank found no built kernel library: the parent "
                       "builds it before any rank starts")


def _dist_main(rank: int, world: int, store: str, jobs, done, out: str) -> None:
    """One rank: cuda:0, the main path's matmul settings, joined to the
    others through the file store once; runs each job it is handed
    (``jobs``, None ends it) in turn, saves its result and reports it
    (``done``), its memory and the Newton pass freed between jobs.
    Its allocator grows segments in place: three LLaMA-1.1B processes
    take ~66 GB of the card, and split cached blocks would not fit."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    faulthandler.enable()      # a crashed rank prints its Python stack
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels._nvcc = _no_nvcc
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))
    try:
        for n, job in iter(jobs.get, None):
            name, arg = job.split(":", 1) if ":" in job else (job, None)
            result = _DIST_JOBS[name](rank, world, arg)
            dist.barrier()
            torch.save(result, f"{out}.{n}.{rank}")
            del result
            _own_newton_pass()
            gc.collect()
            torch.cuda.empty_cache()
            done.put((n, rank))
    finally:
        dist.destroy_process_group()


def _host_memory() -> str:
    """This process's resident set and the host's available memory, from
    /proc (Linux)."""
    def field(path, key):
        with open(path) as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) / 2 ** 20
        return float("nan")
    return (f"RSS {field('/proc/self/status', 'VmRSS'):.1f} GiB, available "
            f"{field('/proc/meminfo', 'MemAvailable'):.1f} GiB")


class _Ranks:
    """``world`` spawned rank processes on this card, kept for the jobs
    that follow while the world size stays: each path's job runs in
    them in turn, so consecutive paths of one size pay one spawn, one
    CUDA start and one process group."""

    def __init__(self, world: int):
        OUT_DIR.mkdir(exist_ok=True)
        self.world, self.n = world, 0
        self.tmp = Path(tempfile.mkdtemp(prefix="dist_", dir=OUT_DIR))
        ctx = multiprocessing.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.done = ctx.Queue()
        # daemons: a process that exits without close() takes them along
        self.procs = [ctx.Process(target=_dist_main, daemon=True, args=(
            r, world, str(self.tmp / "store"), self.jobs[r], self.done,
            str(self.tmp / "result"))) for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, job: str) -> list:
        """``job`` on every rank; their results in rank order.  Fails if a
        rank fails or the job outlasts DIST_TIMEOUT_S."""
        self.n += 1
        for q in self.jobs:
            q.put((self.n, job))
        deadline, left = time.monotonic() + DIST_TIMEOUT_S, set(range(self.world))
        # a failed rank ends the run at once: the others would wait in a
        # collective until the group's timeout
        while left:
            if any(p.exitcode is not None for p in self.procs) or \
                    time.monotonic() > deadline:
                raise AssertionError(f"{job}: rank exit codes "
                                     f"{[p.exitcode for p in self.procs]}")
            try:
                n, rank = self.done.get(timeout=0.2)
            except queue.Empty:
                continue
            if n == self.n:
                left.discard(rank)
        out = []
        for r in range(self.world):
            path = self.tmp / f"result.{self.n}.{r}"
            out.append(torch.load(path, weights_only=False))
            path.unlink()
        return out

    def close(self) -> None:
        """End every rank (terminated if it does not end by itself)."""
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


_RANKS: list = []      # the open _Ranks, at most one


def close_ranks() -> None:
    """End the open rank processes, if any."""
    while _RANKS:
        _RANKS.pop().close()


def _spawn(job: str, world: int) -> list:
    """Run ``job`` in ``world`` rank processes (the parent's memory freed
    first): the open ones when they are ``world``, else new ones, started
    after the open ones end.  Their results in rank order.  Fails, ending
    the ranks, if a rank fails."""
    gc.collect()
    torch.cuda.empty_cache()
    if _RANKS and _RANKS[0].world != world:
        close_ranks()
    log(f"  {job}: {world} ranks ({'kept' if _RANKS else 'spawned'}); this "
        f"process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; host {_host_memory()}")
    if not _RANKS:
        _RANKS.append(_Ranks(world))
    try:
        return _RANKS[0].run(job)
    except BaseException:
        close_ranks()
        raise


def _dist_arm(arm: str, dev, **options):
    """(label, model, loss_fn, optimizer, batch, per_fit) of a stack-sharded
    arm: the main paths' models and optimizers (``gpt2_path``,
    ``newton_path`` B, ``llama_path``), with ``options`` over them."""
    if arm == "llama":
        cfg = llama.llama_1b(compute_dtype=torch.bfloat16)
        model = llama.Llama(cfg, device=dev, seed=0)
        mask, loss_fn, make, batch = (llama.scanned_layers_mask(model), llama.loss_llama,
                                      llama.synthetic_lm_batch, 1)
        opt = _bench_opt(model, mask, DIST_STEPS[0], dev, **options)
        label, per_fit = "LLaMA-1.1B", LLAMA_PER_FIT
    else:
        cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
        model = gpt2.GPT2(cfg, device=dev, seed=0)
        mask, loss_fn, make = (gpt2.scanned_layers_mask(model), gpt2.loss_gpt2,
                               gpt2.synthetic_lm_batch)
        if arm == "gpt2":
            batch, label, per_fit = 4, "GPT-2 124M", GPT2_PER_FIT
            opt = _bench_opt(model, mask, DIST_STEPS[0], dev, **options)
        else:
            batch, label, per_fit = 2, "GPT-2 124M Newton", GPT2_NEWTON_PER_FIT
            opt = _newton_opt(model, mask, DIST_STEPS[0], dev, **options)
    tokens, targets = make(torch.Generator().manual_seed(1), batch, cfg.block_size,
                           cfg.vocab_size, device=dev)
    return label, model, loss_fn, opt, (tokens, targets), per_fit


def _newton_pass_from(rank: int, group=None):
    """The Newton step's autograd pass as rank 0 takes it, broadcast to the
    other ranks of ``group`` (default the world; their gradients and H v
    equal rank 0's bit for bit, as the ranks' of a data-parallel run are
    after their all-reduce)."""
    from psgd_torch_tpu_torch.optim import transforms
    own = _OWN_PASS

    def shared(closure, params, do_fit, k_v, exact, draw):
        if rank == 0:
            loss, grads, vs, hvs = own(closure, params, do_fit, k_v, exact, draw)
        else:
            loss = torch.zeros((), device=params[0].device)
            grads = [torch.empty_like(p) for p in params]
            vs, hvs = ((None, None) if not do_fit else
                       ([torch.empty_like(p) for p in params],
                        [torch.empty_like(p) for p in params]))
        loss = loss.detach().float().reshape(1)
        for t in [loss] + grads + (vs + hvs if do_fit else []):
            _bcast(t, group=group)
        return loss[0], grads, vs, hvs

    transforms._newton_pass = shared


def _own_newton_pass() -> None:
    """Undo ``_newton_pass_from``: each rank takes its own pass."""
    from psgd_torch_tpu_torch.optim import transforms
    transforms._newton_pass = _OWN_PASS


def _sharded_leaves(opt) -> list:
    """The leaves that stack sharding shards (or would shard): scanned,
    unshared, with a dense factor."""
    return [i for i, (f, plan) in enumerate(zip(opt.scanned, opt.plans))
            if f and not all(plan.is_diag)]


def _stack_job(rank: int, world: int, _) -> list:
    """Each arm of ``DIST_ARMS`` in turn (``_stack_arm``), its memory
    freed before the next."""
    pair = dist.new_group([0, 1])
    out = []
    for arm in DIST_ARMS:
        t0 = time.perf_counter()
        out.append(_stack_arm(rank, arm, pair))
        out[-1]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _stack_arm(rank: int, arm: str, pair) -> dict:
    """Ranks 0 and 1 train ``arm`` with stack_sharding over their group,
    rank 2 without (the 1-rank reference).  Rank 0 takes the forward and
    backward on the arm's batch and broadcasts the gradients, so all three
    step from the same ones."""
    dev = torch.device("cuda", 0)
    label, model, loss_fn, opt, batch, per_fit = _dist_arm(
        arm, dev, stack_sharding=pair if rank < 2 else None)
    params = opt.param_groups[0]["params"]
    newton = isinstance(opt, KronNewton)
    if newton:
        _newton_pass_from(rank)
        if rank:      # the probes are drawn where the pass runs
            per_fit = dict(per_fit, unit_noise=0)
    else:
        grads = [torch.zeros_like(p) for p in params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, opt_ms, fitted = [], [], []
    for _ in range(sum(DIST_STEPS)):
        fits0 = opt.fit_steps
        if newton:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = opt.step(lambda: loss_fn(model, *batch))
        else:
            if rank == 0:
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, *batch)
                loss.backward()
                grads = [p.grad for p in params]
            for p, g in zip(params, grads):
                _bcast(g)
                p.grad = g
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        fitted.append(opt.fit_steps - fits0)
        if rank == 0:
            losses.append(loss.item())
    counts = _all_counts()
    sharded = _sharded_leaves(opt)
    layers = [params[i].shape[0] for i in sharded]
    q = {i: opt.state[params[i]]["q"] for i in range(len(params))}
    out = dict(label=label, per_fit=per_fit, losses=losses, opt_ms=opt_ms, fitted=fitted,
               counts=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               q_bytes=sum(f.numel() * f.element_size() for i in sharded for f in q[i]),
               params=[_digest(p) for p in params], sharded=sharded)
    if rank < 2:
        out["q"] = {i: [_digest(f) for f in q[i]] for i in range(len(params))}
    else:   # the reference's Q, cut as each rank holds it
        out["q"] = {i: [_digest(f) for f in q[i]] for i in range(len(params))
                    if i not in sharded}
        out["q_slices"] = {r: {i: [_digest(f[r * n // 2:(r + 1) * n // 2]) for f in q[i]]
                               for i, n in zip(sharded, layers)} for r in (0, 1)}
    return out


def _dist_times(label: str, res: dict, card: str) -> None:
    fit = [t for t, f in zip(res["opt_ms"][1:], res["fitted"][1:]) if f]
    nofit = [t for t, f in zip(res["opt_ms"][1:], res["fitted"][1:]) if not f]
    log(f"  [{card}; {DIST_LABEL}] {label}: optimizer step (train step for "
        f"Newton; median, first step excluded) fit {_median(fit)} ms, no fit "
        f"{_median(nofit)} ms; peak memory {res['peak_gb']:.2f} GB allocated, "
        f"{res['reserved_gb']:.2f} GB reserved")


def stack_sharded_path(dev, card: str) -> dict:
    """Each arm of ``DIST_ARMS`` on 2 stack-sharded ranks beside a 1-rank
    reference fed the same gradients: every rank's parameters equal the
    reference's, each rank's Q of the sharded stacks equals its layers of
    the reference's and the replicated Q the reference's, bit for bit
    (SHA-256 per tensor); each rank's launches per fit step are the arm's
    (the kernels at half the batch: row 1 at B = 6, LLaMA's rows 3-9 at
    B = 11) and its stacked Q about half the reference's."""
    total = {}
    t0 = time.perf_counter()
    arms = _spawn("stack", 3)
    for j in range(len(DIST_ARMS)):
        ranks = [arms[r][j] for r in range(3)]
        ref, label = ranks[2], ranks[0]["label"]
        losses = ranks[0]["losses"]
        log(f"{label} stack-sharded over 2 ranks (and a 1-rank reference), "
            f"{sum(DIST_STEPS)} steps: losses {[round(x, 4) for x in losses]}")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError(f"{label} stack-sharded: losses {losses}")
        for r in (0, 1):
            res = ranks[r]
            if res["params"] != ref["params"]:
                bad = [i for i, (a, b) in enumerate(zip(res["params"], ref["params"]))
                       if a != b]
                raise AssertionError(f"{label}: rank {r}'s parameters {bad} differ "
                                     "from the 1-rank run's")
            for i, ds in res["q"].items():
                want = ref["q_slices"][r][i] if i in ref["sharded"] else ref["q"][i]
                if ds != want:
                    raise AssertionError(f"{label}: rank {r}'s Q of leaf {i} differs "
                                         "from the 1-rank run's")
            fits = sum(res["fitted"])
            per = {k: res["counts"][k] / max(fits, 1) for k in res["per_fit"]}
            if fits == 0 or any(res["counts"][k] != n * fits
                                for k, n in res["per_fit"].items()):
                raise AssertionError(f"{label}: rank {r} launched {per} per fit "
                                     f"step, expected {res['per_fit']}")
            if not 0.4 < res["q_bytes"] / ref["q_bytes"] < 0.6:
                raise AssertionError(f"{label}: rank {r} holds {res['q_bytes']} "
                                     f"bytes of stacked Q, the reference {ref['q_bytes']}")
            log(f"  rank {r}: parameters and Q bit for bit the 1-rank run's; "
                f"launches per fit step {per}; stacked Q {res['q_bytes'] / 1e6:.2f} "
                f"MB (1-rank {ref['q_bytes'] / 1e6:.2f} MB)")
            _dist_times(f"{label} rank {r}", res, card)
            _add(total, res["counts"])
        _dist_times(f"{label} 1-rank reference", ref, card)
        log(f"  [{card}] {label} arm {ranks[0]['seconds']:.1f} s in the ranks")
    log(f"  [{card}] stack-sharded path {time.perf_counter() - t0:.1f} s")
    return total


def _dp_job(rank: int, world: int, _) -> dict:
    """The production layout: GPT-2 124M stack-sharded over the mesh's
    fsdp dim, each rank on its own micro-batch, gradients averaged by
    all_reduce; the drift of every replicated tensor after the steps."""
    from psgd_torch_tpu_torch.parallel import drift_check, make_mesh
    dev = torch.device("cuda", 0)
    mesh = make_mesh(axis_names=("dp", "fsdp"))
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    opt = _bench_opt(model, gpt2.scanned_layers_mask(model), DIST_DP_STEPS // 2, dev,
                     stack_sharding=(mesh, "fsdp"))
    tokens, targets = gpt2.synthetic_lm_batch(
        torch.Generator().manual_seed(10 + rank), 2, cfg.block_size, cfg.vocab_size,
        device=dev)
    kernels.reset_launch_counts()
    losses = []
    for _ in range(DIST_DP_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = gpt2.loss_gpt2(model, tokens, targets)
        loss.backward()
        for p in opt.param_groups[0]["params"]:
            dist.all_reduce(p.grad)
            p.grad.div_(world)
        opt.step()
        losses.append(loss.item())
    params = opt.param_groups[0]["params"]
    names = [n for n, _ in sorted(model.named_parameters(),
                                  key=lambda kv: tuple(kv[0].split(".")))]
    tensors = {f"param {n}": p for n, p in zip(names, params)}
    tensors.update({f"momentum {n}": opt.state[p]["mu"] for n, p in zip(names, params)})
    for i, (n, p) in enumerate(zip(names, params)):
        if not opt.sharded[i]:
            for j, f in enumerate(opt.state[p]["q"] + opt.state[p]["lips"]):
                tensors[f"Q/L {n}[{j}]"] = f
    return dict(drift=drift_check(tensors), losses=losses, counts=_all_counts(),
                fits=opt.fit_steps)


def _dp_drift_check(ranks: list, card: str) -> dict:
    """GPT-2 124M on 2 ranks, distinct 2 x 1024 micro-batches, gradients
    averaged by all_reduce, stack sharding on: ``drift_check`` exactly 0
    on the parameters, the momentum and every replicated Q and L."""
    drift = ranks[0]["drift"]
    worst = max(drift.values())
    log(f"GPT-2 124M, 2 ranks ({DIST_LABEL}), distinct micro-batches, all_reduce "
        f"mean, stack sharding: {len(drift)} replicated tensors, largest drift "
        f"{worst}; rank losses {[round(r['losses'][-1], 4) for r in ranks]}; "
        f"{ranks[0]['seconds']:.1f} s in the ranks")
    if worst != 0.0 or ranks[1]["drift"] != drift:
        raise AssertionError(f"data-parallel drift: {[k for k, v in drift.items() if v]}")
    total = {}
    for r in ranks:
        _add(total, r["counts"])
    return total


def _whole(p) -> torch.Tensor:
    """A DTensor's global value from every rank's block: one all_gather
    of the blocks' bytes over the world (the collective gloo takes CUDA
    tensors for), each block put in place by its rank's mesh coordinate."""
    mesh, local = p.device_mesh, p.to_local().detach().contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather([x.reshape(-1).view(torch.uint8) for x in parts],
                    local.reshape(-1).view(torch.uint8))
    out = torch.empty(p.shape, dtype=local.dtype, device=local.device)
    sizes = mesh.mesh.shape
    for r, part in enumerate(parts):
        coord = [int(i) for i in (mesh.mesh == r).nonzero()[0]]
        index = []
        for d in range(p.ndim):
            k, i = 1, 0
            for md, pl in enumerate(p.placements):
                if pl.is_shard(d):
                    k, i = k * sizes[md], i * sizes[md] + coord[md]
            n = p.shape[d] // k
            index.append(slice(i * n, (i + 1) * n))
        out[tuple(index)] = part
    return out


def _per_shard_job(rank: int, world: int, _) -> dict:
    """GPT-2 124M's parameters as DTensors on a 1-D fsdp mesh
    (``gpt2_partition_specs``), trained by ``per_shard_kron_whiten`` in the
    main path's settings.  Rank 0 takes the forward and backward on the
    whole model and broadcasts the gradients; each rank hands the optimizer
    its shard as a DTensor (what FSDP2 would hand it), then the shards are
    gathered back into the model.  Rank 0 also runs each rank's shards in
    one process (``on_shards``) from the same gradients."""
    from torch.distributed.tensor import DTensor, Shard
    from psgd_torch_tpu_torch.parallel import (PerShardKronWhiten, gpt2_partition_specs,
                                               make_mesh)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(axis_names=("fsdp",))
    specs = gpt2_partition_specs(mesh)
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    tokens, targets = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(1), 4,
                                              cfg.block_size, cfg.vocab_size, device=dev)
    named = list(model.named_parameters())

    def shard_of(full, pl, r):
        return (full.chunk(mesh.size(), dim=pl.dim)[r] if isinstance(pl, Shard)
                else full).detach().clone().contiguous()

    kw = dict(lr=1e-3 / 4, weight_decay=0.01, momentum=0.9, whiten_grad=False,
              preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
              preconditioner_update_probability=lambda c: 1.0 if c < DIST_STEPS[0] else 0.1,
              preconditioner_dtype=torch.bfloat16, momentum_dtype=torch.bfloat16,
              norm_k=128, device=dev)
    dparams = [(n, torch.nn.Parameter(DTensor.from_local(
        shard_of(p, specs[n][0], rank), mesh, specs[n], run_check=False)))
        for n, p in named]
    opt = PerShardKronWhiten(dparams, mesh, **kw)
    refs = []
    if rank == 0:
        for r in range(mesh.size()):
            shards = [(n, shard_of(p, specs[n][0], r),
                       {specs[n][0].dim: r} if isinstance(specs[n][0], Shard) else {})
                      for n, p in named]
            refs.append((PerShardKronWhiten.on_shards(shards, **kw), shards))
    kernels.reset_launch_counts()
    losses, opt_ms = [], []
    grads = [torch.zeros_like(p) for _, p in named]
    for _ in range(sum(DIST_STEPS)):
        if rank == 0:
            model.zero_grad(set_to_none=True)
            loss = gpt2.loss_gpt2(model, tokens, targets)
            loss.backward()
            losses.append(loss.item())
            grads = [p.grad for _, p in named]
        for (n, p), (_, dp), g in zip(named, dparams, grads):
            _bcast(g)
            dp.grad = DTensor.from_local(shard_of(g, specs[n][0], rank), mesh, specs[n],
                                         run_check=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        if rank == 0:
            for (ref, shards), r in zip(refs, range(mesh.size())):
                for (n, t, _), g in zip(shards, grads):
                    t.grad = shard_of(g, specs[n][0], r)
                ref.step()
        with torch.no_grad():
            for (n, p), (_, dp) in zip(named, dparams):
                p.copy_(_whole(dp))
    counts = _all_counts()
    local = {n: _digest(dp.to_local()) for n, dp in dparams}
    q = {n: [_digest(f) for f in opt.state[loc]["q"]]
         for (n, _), loc in zip(sorted(dparams, key=lambda kv: tuple(kv[0].split("."))),
                                opt.param_groups[0]["params"])}
    out = dict(losses=losses, opt_ms=opt_ms, counts=counts, local=local, q=q,
               fits=opt.fit_steps, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if rank == 0:
        out["refs"] = []
        for ref, shards in refs:
            locs = {n: _digest(t) for n, t, _ in shards}
            qs = {n: [_digest(f) for f in ref.state[t]["q"]] for n, t, _ in shards}
            out["refs"].append((locs, qs))
    return out


def _per_shard_check(ranks: list, card: str) -> dict:
    """GPT-2 124M by ``per_shard_kron_whiten`` on a 1-D mesh of 2: each
    rank's shards and their Q equal the same shards preconditioned in one
    process with the same keys, bit for bit; the loss falls."""
    losses = ranks[0]["losses"]
    for r, res in enumerate(ranks):
        locs, qs = ranks[0]["refs"][r]
        if res["local"] != locs or res["q"] != qs:
            bad = [n for n in locs if res["local"][n] != locs[n] or res["q"][n] != qs[n]]
            raise AssertionError(f"per-shard: rank {r}'s shards {bad} differ from "
                                 "the one-process run's")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"per-shard: losses {losses}")
    log(f"GPT-2 124M per-shard whitening on a 1-D mesh of 2 ({DIST_LABEL}): losses "
        f"{[round(x, 4) for x in losses]}; each rank's shards and Q bit for bit the "
        f"one-process run's; {ranks[0]['seconds']:.1f} s in the ranks")
    total = {}
    for r, res in enumerate(ranks):
        log(f"  [{card}; {DIST_LABEL}] rank {r}: optimizer step (median, first "
            f"excluded) {_median(res['opt_ms'][1:])} ms over {res['fits']} fit steps; "
            f"launches {{{', '.join(f'{k}: {v}' for k, v in res['counts'].items() if v)}}}; "
            f"peak memory {res['peak_gb']:.2f} GB")
        _add(total, res["counts"])
    return total


def _pair_job(rank: int, world: int, _) -> dict:
    """The two-rank jobs in one spawn: the drift, then the per-shard run."""
    out = {}
    for name, job in (("dp", _dp_job), ("per_shard", _per_shard_job)):
        t0 = time.perf_counter()
        out[name] = job(rank, world, None)
        out[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pair_paths(dev, card: str) -> dict:
    """The data-parallel drift path and the per-shard path, one pair of
    rank processes for both."""
    t0 = time.perf_counter()
    ranks = _spawn("pair", 2)
    total = _dp_drift_check([r["dp"] for r in ranks], card)
    _add(total, _per_shard_check([r["per_shard"] for r in ranks], card))
    log(f"  [{card}] data-parallel and per-shard paths {time.perf_counter() - t0:.1f} s")
    return total


# the factor-sharded path (ROADMAP A8b): per fit step each rank launches
# what one rank would, every routed leaf on its blocks (arm A: GPT-2's
# counts, wte's 768 and wpe's 1024 and 768 factors at B = 1 on row 1; arm
# B: LLaMA's wte and lm_head, the 2048 factor on the split route, rows 3
# and 4, at B = 1, Newton's probes drawn whole on every rank; arm C:
# GPT-2's wte and wpe in QUAD and QEQ, row 5 on the three dense factors)
_FACTOR_B = {"ns_step": 2, "procrustes": 2, "damped_noise": 2, "fused_ns_update": 0,
             "norm_bound": 0}
_FACTOR_C = {"norm_bound": 3, "damped_noise": 2, "fused_ns_update": 0, "ns_step": 0,
             "procrustes": 0}
FACTOR_PER_FIT = {"gpt2": GPT2_PER_FIT, "llama_whiten": _FACTOR_B,
                  "llama_newton": dict(_FACTOR_B, unit_noise=2,
                                       **{"ns_step.step_mat": 2}),
                  "QUAD": _FACTOR_C, "QEQ": _FACTOR_C}
FACTOR_LABELS = {"llama_whiten": "LLaMA-1.1B wte and lm_head by KronWhiten",
                 "llama_newton": "LLaMA-1.1B wte and lm_head by KronNewton",
                 "QUAD": "GPT-2 wte and wpe in QUAD", "QEQ": "GPT-2 wte and wpe in QEQ"}
FACTOR_STEPS = (3, 3)      # arm A: p = 1.0, then 0.1
FACTOR_FITS = 3            # arms B and C, each optimizer
# every routed leaf's update against the 1-rank reference's: cosine and
# |u_k - u_1| / |u_1|.  JAX's contract is cosine > 0.99
# (tests/test_parallel.py:421-445), which no planted fault of
# tools/factor_fault_margin.py fails; on an H100 sound arms read at most
# 4.9e-6 and 3.1e-3, a skipped psum 1.7e-4 and 0.042 or more in arms B and
# C (PERF.md, PR 14 call 6)
FACTOR_COS = 1 - 5e-5
FACTOR_REL = 1e-2
FACTOR_LABEL = "2 ranks (4 in arm C) sharing one H100 over gloo, not scaling figures"
LLAMA_VOCAB = (32000, 2048)
# the damping's B = 1 blocks in the compute layout: GPT-2's wte on 2 ranks
# (arm A) and on 4 (C), LLaMA's wte on 2 (B; its lm_head's is the transpose)
FACTOR_NOISE_SHAPES = ((1, 25152, 768), (1, 12576, 768), (1, 16000, 2048))


def _blocks_of(x, mesh, placements):
    """This rank's block of a tensor every rank holds whole, as a DTensor
    (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def _counted(fn, total: dict) -> float:
    """fn()'s host ms to the card's end; its launches added to ``total``."""
    before = _all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _add(total, {k: v - before[k] for k, v in _all_counts().items()})
    return ms


def _agree(a, b) -> tuple:
    """(1 - cosine, relative error |a - b| / |b|) of an update a against
    the reference's b, in float64 (complex values as ``_real64`` pairs)."""
    a, b = _real64(a), _real64(b)
    return (float(1 - a @ b / (a.norm() * b.norm())),
            float((a - b).norm() / b.norm()))


def _replicated(opt, names) -> dict:
    """What the mesh holds equal on every rank: the non-routed parameters
    and their Q and L (a stack-sharded leaf's are its layers: out), the
    routed leaves' dense Q factors and L."""
    out = {}
    for n, p, r, sh in zip(names, opt.param_groups[0]["params"], opt.routed,
                           opt.sharded):
        st = opt.state[p]
        if r is None:
            out[f"param {n}"] = p
        if sh:
            continue
        for j, f in enumerate(st["q"]):
            if r is None or f.ndim == 2:
                out[f"Q {n}[{j}]"] = f
        for j, f in enumerate(st["lips"]):
            out[f"L {n}[{j}]"] = f
    return out


def _factor_result(label, opt, names, counts, opt_ms, fitted, agree, ref,
                   **extra) -> dict:
    """One rank's readings of an arm; ``state_memory_report`` of the
    optimizer per rank and over the mesh, and of the 1-rank reference
    (rank 0's)."""
    from psgd_torch_tpu_torch.parallel import drift_check
    return dict(label=label, counts=counts, opt_ms=opt_ms, fitted=fitted, agree=agree,
                drift=drift_check(_replicated(opt, names)),
                mine=state_memory_report(opt, per_device=True),
                whole=state_memory_report(opt),
                ref=None if ref is None else state_memory_report(ref),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9, **extra)


def _factor_gpt2(rank: int) -> dict:
    """Arm A: GPT-2 124M in the main path's settings on a 1-D fsdp mesh of
    2, laid out by ``sharding_recipe``: the blocks stack-sharded, wte (its
    768 dim moved onto the vocab dim) and wpe (no diagonal dim: 768
    gathered) factor-sharded.  Rank 0 takes the forward and backward and
    broadcasts the gradients; each rank hands the optimizer its blocks of
    the routed leaves' as DTensors and gathers them back into the model.
    Rank 0 also steps a 1-rank reference from the same gradients."""
    from psgd_torch_tpu_torch.parallel import (gpt2_partition_specs, make_mesh,
                                               sharding_recipe)
    dev = torch.device("cuda", 0)
    mesh = make_mesh(axis_names=("fsdp",))
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    mask = gpt2.scanned_layers_mask(model)
    rec = sharding_recipe(mesh, gpt2_partition_specs(mesh), model.named_parameters(),
                          scanned_layers=mask)
    routed = sorted(rec.routed())
    if rec.stack_axis != "fsdp" or routed != ["wpe", "wte"]:
        raise AssertionError(f"recipe: stack axis {rec.stack_axis}, routed {routed}")
    kw = dict(lr=1e-3 / 4, weight_decay=0.01, momentum=0.9, whiten_grad=False,
              preconditioner_max_skew=2.0, preconditioner_init_scale=1.0,
              preconditioner_update_probability=lambda c: 1.0 if c < FACTOR_STEPS[0]
              else 0.1, preconditioner_dtype=torch.bfloat16,
              momentum_dtype=torch.bfloat16, norm_k=128, device=dev)
    named = dict(model.named_parameters())
    placed = dict(rec.place(model.named_parameters()))
    opt = KronWhiten(list(placed.items()), **kw, **rec.transform_kwargs)
    ref = refp = None
    if rank == 0:
        refp = {n: torch.nn.Parameter(p.detach().clone()) for n, p in named.items()}
        ref = KronWhiten(list(refp.items()), scanned_layers=mask, **kw)
    tokens, targets = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(1), 4,
                                              cfg.block_size, cfg.vocab_size, device=dev)
    grads = {n: torch.zeros_like(p) for n, p in named.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, losses, opt_ms, fitted, agree = {}, [], [], [], []
    for _ in range(sum(FACTOR_STEPS)):
        if rank == 0:
            model.zero_grad(set_to_none=True)
            loss = gpt2.loss_gpt2(model, tokens, targets)
            loss.backward()
            losses.append(loss.item())
            grads = {n: p.grad for n, p in named.items()}
        for n in named:
            _bcast(grads[n])
            placed[n].grad = (_blocks_of(grads[n], mesh, placed[n].placements)
                              if n in routed else grads[n])
        before = {n: named[n].detach().clone() for n in routed}
        fits0 = opt.fit_steps
        opt_ms.append(_counted(opt.step, counts))
        fitted.append(opt.fit_steps - fits0)
        with torch.no_grad():
            for n in routed:
                named[n].copy_(_whole(placed[n]))
        if rank == 0:
            was = {n: refp[n].detach().clone() for n in routed}
            for n, p in refp.items():
                p.grad = grads[n]
            ref.step()
            agree.append({n: _agree(named[n] - before[n], refp[n] - was[n])
                          for n in routed})
    names = sorted(named, key=lambda n: tuple(n.split(".")))
    out = _factor_result("GPT-2 124M", opt, names, counts, opt_ms, fitted, agree, ref,
                         per_fit=FACTOR_PER_FIT["gpt2"], losses=losses)
    if rank == 0:     # the non-routed leaves: stack sharding, bit for bit
        out["unequal"] = [n for n in names if n not in routed
                          and not torch.equal(named[n], refp[n])]
    return out


def _factor_leaves(rank: int, mesh, arm: str, shapes: dict, placements: dict,
                   newton: bool, **kw) -> dict:
    """Arms B and C: ``shapes``' leaves as DTensors on ``mesh`` by KronWhiten
    (or KronNewton), bf16 Q, FACTOR_FITS fit steps from gradients drawn
    from seed 0 (Newton: h = c v, c from seed 0, v the optimizer's probes);
    rank 0 steps a 1-rank reference from the same ones (Newton through a
    closure whose gradient is g and whose Hessian is diag(c))."""
    dev = torch.device("cuda", 0)
    names = sorted(shapes)
    gen = torch.Generator().manual_seed(0)
    init = {n: (0.02 * torch.randn(shapes[n], generator=gen)).to(dev) for n in names}
    c = {n: (10.0 ** (2 * torch.rand(shapes[n], generator=gen) - 1)).to(dev)
         for n in names}
    cls = KronNewton if newton else KronWhiten
    kw = dict(kw, lr=1e-3, preconditioner_init_scale=1.0, momentum=0.9,
              preconditioner_dtype=torch.bfloat16, momentum_dtype=torch.bfloat16,
              norm_k=128, device=dev)
    params = {n: torch.nn.Parameter(_blocks_of(init[n], mesh, placements[n]))
              for n in names}
    opt = cls(list(params.items()), factor_sharding=(mesh, placements), **kw)
    ref = refp = None
    if rank == 0:
        refp = {n: torch.nn.Parameter(init[n].clone()) for n in names}
        ref = cls(list(refp.items()), **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts, opt_ms, fitted, agree = {}, [], [], []
    for _ in range(FACTOR_FITS):
        g = {n: torch.randn(shapes[n], generator=gen).to(dev) for n in names}
        for n, p in params.items():
            p.grad = _blocks_of(g[n], mesh, placements[n])
        before = {n: _whole(p) for n, p in params.items()}
        fits0 = opt.fit_steps
        if newton:
            step = functools.partial(opt.step, hvp_fn=lambda vs: [
                c[n] * v for n, v in zip(names, vs)])
        else:
            step = opt.step
        opt_ms.append(_counted(step, counts))
        fitted.append(opt.fit_steps - fits0)
        after = {n: _whole(p) for n, p in params.items()}
        if rank == 0:
            was = {n: p.detach().clone() for n, p in refp.items()}
            if newton:
                ref.step(lambda: sum(torch.sum(g[n] * p + 0.5 * c[n] * (p - was[n]) ** 2)
                                     for n, p in refp.items()))
            else:
                for n, p in refp.items():
                    p.grad = g[n]
                ref.step()
            agree.append({n: _agree(after[n] - before[n], refp[n] - was[n])
                          for n in names})
    return _factor_result(FACTOR_LABELS[arm], opt, names, counts, opt_ms, fitted, agree,
                          ref, per_fit=FACTOR_PER_FIT[arm])


def _factor_job(rank: int, world: int, arg) -> list:
    """Arms A and B on 2 ranks (``arg`` "ab"), or arm C on 4 ("c"), each
    arm's memory freed before the next."""
    from types import SimpleNamespace
    from psgd_torch_tpu_torch.parallel import (gpt2_partition_specs, llama_partition_specs,
                                               make_mesh)
    if arg == "ab":
        mesh = make_mesh(axis_names=("fsdp",))
        specs = llama_partition_specs(mesh, SimpleNamespace(lm_head=True))
        pl = {n: specs[n] for n in ("wte", "lm_head")}
        shapes = {"wte": LLAMA_VOCAB, "lm_head": LLAMA_VOCAB[::-1]}
        arms = [lambda: _factor_gpt2(rank)] + [
            (lambda newton=newton: _factor_leaves(
                rank, mesh, "llama_newton" if newton else "llama_whiten", shapes, pl,
                newton)) for newton in (False, True)]
    else:
        mesh = make_mesh(axis_names=("fsdp", "tp"), axis_sizes=(2, 2))
        specs = gpt2_partition_specs(mesh)
        pl = {n: specs[n] for n in ("wte", "wpe")}
        shapes = {"wte": (50304, 768), "wpe": (1024, 768)}
        arms = [(lambda dq=dq: _factor_leaves(rank, mesh, dq, shapes, pl, False, dq=dq,
                                              preconditioner_max_skew=2.0))
                for dq in ("QUAD", "QEQ")]
    out = []
    for arm in arms:
        t0 = time.perf_counter()
        out.append(arm())
        out[-1]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _factor_check(arms: list, card: str) -> dict:
    """The gates of one spawn's arms (``arms[r][j]``: rank r, arm j)."""
    total = {}
    for j in range(len(arms[0])):
        ranks = [a[j] for a in arms]
        label, k = ranks[0]["label"], len(ranks)
        head = ranks[0]
        if "losses" in head:
            losses = head["losses"]
            log(f"{label} factor-sharded over {k} ranks: losses "
                f"{[round(x, 4) for x in losses]}")
            if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
                raise AssertionError(f"{label} factor-sharded: losses {losses}")
            if head["unequal"]:
                raise AssertionError(f"{label}: non-routed {head['unequal']} differ from "
                                     "the 1-rank reference")
        worst = [max(v[j] for a in head["agree"] for v in a.values()) for j in (0, 1)]
        if not (worst[0] < 1 - FACTOR_COS and worst[1] < FACTOR_REL):
            raise AssertionError(f"{label}: updates against the 1-rank reference "
                                 f"(1 - cosine, relative error) {head['agree']}, need "
                                 f"< {1 - FACTOR_COS:g} and < {FACTOR_REL:g}")
        for r, res in enumerate(ranks):
            drift = res["drift"]
            if set(drift.values()) != {0.0}:
                raise AssertionError(f"{label}: rank {r} drift "
                                     f"{[n for n, v in drift.items() if v]}")
            fits = sum(res["fitted"])
            per = {key: res["counts"].get(key, 0) / max(fits, 1) for key in res["per_fit"]}
            if fits == 0 or any(res["counts"].get(key, 0) != n * fits
                                for key, n in res["per_fit"].items()):
                raise AssertionError(f"{label}: rank {r} launched {per} per fit step, "
                                     f"expected {res['per_fit']}")
            mine, whole = res["mine"], res["whole"]
            # over the mesh each routed block counts times its shard count:
            # equal to the reference's only if every rank holds 1/k
            if whole != head["ref"] or not mine["momentum"] < whole["momentum"]:
                raise AssertionError(f"{label}: rank {r}'s state {mine} bytes, over the "
                                     f"mesh {whole}, the 1-rank reference's {head['ref']}")
            fit = [t for t, f in zip(res["opt_ms"][1:], res["fitted"][1:]) if f]
            nofit = [t for t, f in zip(res["opt_ms"][1:], res["fitted"][1:]) if not f]
            log(f"  [{card}; {FACTOR_LABEL}] {label} rank {r}: optimizer step (median, "
                f"first excluded) fit {_median(fit) if fit else 'none'} ms, no fit "
                f"{_median(nofit) if nofit else 'none'} ms; peak {res['peak_gb']:.2f} GB "
                f"allocated, {res['reserved_gb']:.2f} GB reserved; state_memory_report "
                f"per rank / replicated: momentum {mine['momentum'] / 1e6:.2f} / "
                f"{whole['momentum'] / 1e6:.2f} MB, Q {mine['q'] / 1e6:.2f} / "
                f"{whole['q'] / 1e6:.2f} MB, total {mine['total'] / whole['total']:.3f}; "
                f"launches per fit step {per}; drift 0.0 on {len(drift)} tensors")
            _add(total, res["counts"])
        log(f"  {label}: updates against the 1-rank reference per step, (1 - cosine, "
            f"relative error) {head['agree']}; worst {worst}; "
            f"{head['seconds']:.1f} s in the ranks")
    return total


def factor_sharded_path(dev, card: str) -> dict:
    """Arms A and B on 2 ranks, arm C on 4 (``_factor_job``): every
    replicated tensor equal on every rank (``drift_check`` 0.0), the state
    over the mesh the 1-rank reference's (``state_memory_report``), every
    routed leaf's update within ``FACTOR_COS`` and ``FACTOR_REL`` of the
    1-rank reference's, exact launches per fit step
    (``FACTOR_PER_FIT``); arm A's loss falls and its non-routed leaves
    equal the reference's bit for bit."""
    t0 = time.perf_counter()
    total = _factor_check(_spawn("factor:ab", 2), card)
    _add(total, _factor_check(_spawn("factor:c", 4), card))
    log(f"  [{card}] factor-sharded path {time.perf_counter() - t0:.1f} s; its "
        f"launches (ranks summed) {{{', '.join(f'{k}: {v}' for k, v in total.items() if v)}}}")
    return total




# the vector-sharded path (ROADMAP A8b): one LRA preconditioner over GPT-2
# 124M's whole parameter vector, its rows over 2 ranks (arm A by
# LRAWhiten, B by LRANewton, __graft_entry__.py:159-186's recipe at rank
# 4), and on the tensor-rank problem (n = 1700) dense QEQ over 4 ranks and
# 3 (n_pad 1701) and LRANewton over 3 (arm C); complex64 (ROADMAP A3c): the
# complex LRA path's least squares (CXL_PROBLEMS["full"], n = 28,311,552)
# by LRAWhiten (arm D) and LRANewton (E) over 2 ranks, and its dense
# problem (n = 1700) by DenseNewton QEQ over 3 ranks, n_pad 1701 (F)
VECTOR_RANK = 4
VECTOR_FITS = {"whiten": 3, "newton": 2, "cx_whiten": 3, "cx_newton": 2}
VECTOR_BATCH = {"whiten": 4, "newton": 2}
VECTOR_LABELS = {"whiten": "GPT-2 124M LRAWhiten", "newton": "GPT-2 124M LRANewton",
                 "cx_whiten": "complex64 least squares LRAWhiten",
                 "cx_newton": "complex64 least squares LRANewton"}
VECTOR_CP_STEPS = 6
VECTOR_CX_DENSE_STEPS = 4
VECTOR_LABEL = ("2 ranks (4 and 3 in arms C and F) sharing one H100 over gloo, not "
                "scaling figures")
# per fit step and rank: whitening's probe and damping at (1, n/k) f32;
# Newton's damping at (1, n/k) and GPT-2's 16 probes (rand_like, unfolded,
# drawn by rank 0's pass, ``_newton_pass_from``); on the tensor-rank
# problem the damping and its 3 probes; the complex arms' the same draws,
# every one in the noise kernel's complex mode (".complex")
_CX_MODE = lambda per_fit: dict(per_fit, **{f"{k}.complex": v for k, v in per_fit.items()})
VECTOR_PER_FIT = {"whiten": {"unit_noise": 1, "damped_noise": 1},
                  "newton": {"unit_noise": GPT2_LEAVES, "damped_noise": 1},
                  "cp": {"unit_noise": CP_LEAVES, "damped_noise": 1},
                  "cx_whiten": _CX_MODE({"unit_noise": 1, "damped_noise": 1}),
                  "cx_newton": _CX_MODE({"unit_noise": len(CX_SHAPES), "damped_noise": 1}),
                  "cx_dense": _CX_MODE({"unit_noise": 1, "damped_noise": 1})}
# arms A and B against their 1-rank references fed the same per-shard
# draws, per step update and per state field (U, V, d): 1 - cosine and
# |x_k - x_1| / |x_1|; the limits sit between the sound arms' readings and
# the planted faults' (``vector_fault_margin``): on an H100 sound arms read
# at most 1.2e-11 and 5.2e-6, the smallest fault (A without the sum of
# V^T x) 1.7e-8 and 1.9e-4 (PERF.md, the vector-sharded slice's call 1)
VECTOR_COS = 1e-9
VECTOR_REL = 5e-5
# arms D and E (complex64) likewise, on the complex values (1 - Re<a, b> /
# (|a| |b|)), and arm F's updates and Q rows against its 1-rank run, each
# ~10x over its sound reading and under its planted faults' (an H100 80GB
# HBM3 at 700 W, PERF.md §6, the complex vector-sharded arms): D sound 9.4e-12 / 4.6e-6, "vtx" 3.1e-10 / 2.5e-5, "unfolded"
# 0.55 / 1.2, "unconj" 0.30 / 190; E sound 7.1e-11 / 2.0e-5, "unfolded"
# 5.0e-6 / 3.5e-3, "unconj" 0.80 / 259 ("vtx" 2.2e-10 / 2.3e-5 is not
# apart from sound there: arm B and the CPU tests hold it); F sound 3.1e-11 /
# 1.3e-5, "densesum" 1.3 / 266 ("unmasked" reads on the pad gate)
VECTOR_LIMITS = {"whiten": (VECTOR_COS, VECTOR_REL), "newton": (VECTOR_COS, VECTOR_REL),
                 "cx_whiten": (1e-10, 5e-5), "cx_newton": (1e-9, 2e-4),
                 "cx_dense": (1e-9, 2e-4)}
# arm C's dense QEQ against the 1-rank run: the parameters after each step
VECTOR_CP_REL = 1e-3
# a fit step's collectives per rank but the update's all_gather: the fit's
# r x r and r-sized sums and its scalars, a few hundred bytes at r = 4 (a
# few thousand at the complex arms' rank 10 in complex64)
VECTOR_SMALL_BYTES = {"whiten": 4096, "newton": 4096, "cx_whiten": 8192,
                      "cx_newton": 8192}
VECTOR_FAULTS = ("none", "vtx", "unfolded", "unmasked", "unconj", "densesum")


def _plant_vector_fault() -> str:
    """The fault ``VECTOR_FAULT`` names (``vector_fault_margin``), planted in
    this rank's precond.lra and precond.dense: "vtx" drops the sum of V^T x
    over the rows, "unfolded" keys every shard's probe alike, "unmasked"
    leaves the probe and h on the pad rows (LRA) and the damping on them
    (dense), "unconj" takes the row-sharded norm's squares as x x without
    the conjugate, "densesum" drops the row-sharded QEQ fit's sum of
    Q^T Q h over the ranks."""
    fault = os.environ.get("VECTOR_FAULT", "none")
    if fault == "vtx":
        own = lra_p.ip_uvt_matvec
        lra_p.ip_uvt_matvec = lambda u, v, x, reduce=None: own(u, v, x)
    elif fault == "unfolded":
        lra_p.shard_key = lambda key, reduce: key
    elif fault == "unmasked":
        lra_p._pad_zero = lambda h, mask: h
        lra_p._masked = lambda v, h, mask: (v, h)
        own_dense = dense_p.update_dense_qeq_row_sharded
        dense_p.update_dense_qeq_row_sharded = (
            lambda q, lips, v, h, key, reduce, n_true, **kw:
            own_dense(q, lips, v, h, key, reduce, h.shape[0], **kw))
    elif fault == "unconj":
        own_norm = lra_p._norm
        lra_p._norm = lambda x, reduce: (own_norm(x, reduce) if reduce is None else
                                         torch.sqrt(reduce.sum(torch.sum(x * x))))
    elif fault == "densesum":
        own_dense = dense_p.update_dense_qeq_row_sharded
        own_sum = types.SimpleNamespace(sum=lambda x: x)
        dense_p.update_dense_qeq_row_sharded = (
            lambda q, lips, v, h, key, reduce, n_true, **kw:
            own_dense(q, lips, v, h, key, own_sum, n_true, **kw))
    return fault


class _ShardProbes:
    """A 1-rank LRA optimizer's draw hook that feeds it what k row shards
    draw: the probe (or damping) of key kv at (n, 1) is each shard's own
    draw under fold_in(kv, shard) at (n_loc, 1), joined and cut to n; every
    other draw (U and V, the coin, Newton's probes) the port's own."""

    def __init__(self, n: int, k: int, dev):
        self.n, self.k, self.dev = n, k, dev

    def __call__(self, kind, keys, shape, dtype):
        key = np.asarray(keys, np.uint32).reshape(2)
        if kind == "uniform":
            return torch.from_numpy(np.asarray(fastrand.uniform01(key[None]))).to(dtype)
        if tuple(shape) != (self.n, 1):
            return fastrand.unit_noise(key, shape, dtype, self.dev)[None]
        n_loc = -(-self.n // self.k)
        parts = [fastrand.unit_noise(fastrand.fold_in(key, r), (n_loc, 1), dtype, self.dev)
                 for r in range(self.k)]
        return torch.cat(parts)[:self.n][None]


def _vector_kw(arm: str, dev) -> tuple:
    """(optimizer class, options) of arm A or B: the recipe of
    __graft_entry__.py:164-167 (rank 4, lr 1e-3, init scale 1; whitening
    with momentum 0.9), Newton with ``lra_gpt2_path``'s norm clip 10 and a
    damping of 1e-3, large enough beside H v that each shard's damping
    draw shows in the fit (at 1e-9 a wrongly keyed draw would not)."""
    kw = dict(lr=1e-3, rank_of_approximation=VECTOR_RANK, preconditioner_init_scale=1.0,
              device=dev)
    if arm == "whiten":
        return LRAWhiten, dict(kw, momentum=0.9)
    if arm == "newton":
        return LRANewton, dict(kw, grad_clip_max_norm=10.0, damping=1e-3)
    # arms D and E: the complex LRA path's arms (CXL_ARMS: rank 10, the init
    # scale on the fly), E with B's norm clip and a damping of 0.1: beside
    # this problem's H v a damping of 1e-3 hid a wrongly keyed shard's draw
    # (a CPU rehearsal read the "unfolded" fault at 1.2e-5, the sound arm
    # at 5e-7; at 0.1, 1.2e-3)
    kw = dict(rank_of_approximation=LRA_RANK, device=dev)
    if arm == "cx_whiten":
        return LRAWhiten, dict(kw, lr=1e-3, momentum=0.9)
    return LRANewton, dict(kw, lr=0.2, grad_clip_max_norm=10.0, damping=0.1)


def _vector_problem(arm: str, dev) -> tuple:
    """(parameters, as (name, tensor) pairs for GPT-2, and loss()) of an
    arm: GPT-2 124M (seed 0) on its batch, or the complex least squares
    of ``CXL_PROBLEMS["full"]`` in complex64 (generator seed 33 on the
    card, so every rank draws the same)."""
    if arm.startswith("cx_"):
        gen = torch.Generator(device=dev).manual_seed(33)
        return _cx_problem(*CXL_PROBLEMS["full"], torch.complex64, dev, gen)
    cfg = gpt2.gpt2_124m(compute_dtype=torch.bfloat16)
    model = gpt2.GPT2(cfg, device=dev, seed=0)
    tokens, targets = gpt2.synthetic_lm_batch(torch.Generator().manual_seed(1),
                                              VECTOR_BATCH[arm], cfg.block_size,
                                              cfg.vocab_size, device=dev)
    return list(model.named_parameters()), lambda: gpt2.loss_gpt2(model, tokens, targets)


def _is_whiten(arm: str) -> bool:
    return arm.endswith("whiten")


def _counted_modes(fn, total: dict) -> float:
    """``_counted``, with the noise's complex-mode launches as
    "damped_noise.complex" and "unit_noise.complex"."""
    noise = (kernels.damped_noise, kernels.unit_noise)
    before = [f.complex_launches for f in noise]
    ms = _counted(fn, total)
    _add(total, {f"{f.__name__}.complex": f.complex_launches - b
                 for f, b in zip(noise, before)})
    return ms


def _flat_update(params, before) -> torch.Tensor:
    return torch.cat([(p.detach() - b).flatten() for p, b in zip(params, before)])


def _vector_reference(arm: str, k: int, dev) -> dict:
    """Rank 0's 1-rank reference of arm A, B, D or E, fed the shards' draws
    (``_ShardProbes``): its gradients (whitening), per-step updates,
    losses, final U, V, d and state bytes, kept on the card (at rank 4 they
    fit beside the sharded run; the host copies cost more than the room),
    the rest of it freed."""
    named, loss_fn = _vector_problem(arm, dev)
    n = sum(p.numel() for p in (x[1] if isinstance(x, tuple) else x for x in named))
    cls, kw = _vector_kw(arm, dev)
    ref = cls(named, draw=_ShardProbes(n, k, dev), **kw)
    params = ref.param_groups[0]["params"]
    out = dict(grads=[], updates=[], losses=[], ms=[])
    torch.cuda.reset_peak_memory_stats()
    for _ in range(VECTOR_FITS[arm]):
        before = [p.detach().clone() for p in params]
        if _is_whiten(arm):
            ref.zero_grad(set_to_none=True)
            loss = loss_fn()
            loss.backward()
            out["grads"].append([p.grad for p in params])
            out["ms"].append(_counted(ref.step, {}))
        else:
            losses = []
            out["ms"].append(_counted(lambda: losses.append(ref.step(loss_fn)), {}))
            loss = losses[0]
        out["losses"].append(loss.item())
        out["updates"].append(_flat_update(params, before))
    out["state"] = {f: getattr(ref.precond, f) for f in ("u", "v", "d")}
    out["memory"] = state_memory_report(ref)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["n"] = n
    del named, loss_fn, ref, params, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _real64(x: torch.Tensor) -> torch.Tensor:
    """x flat in float64, a complex x as its (re, im) pairs: dot products
    of these are Re<a, b>, so cosines and norms are the complex values'."""
    x = x.detach()
    return (torch.view_as_real(x.contiguous()) if x.is_complex() else x).double().flatten()


def _rows_agree(mine: torch.Tensor, ref, rank: int, group, n=None, cols=None) -> tuple:
    """(1 - cosine, relative error) of the ranks' row blocks joined against
    the reference's whole (rank 0's), in float64 (complex values as their
    (re, im) pairs), from each rank's partial sums: rank 0 sends every
    other rank its block of the reference by one broadcast each, and the
    sums are added over ``group``.  Rows at or past ``n`` (pad rows) and,
    with ``cols``, columns past it are left out."""
    k = dist.get_world_size(group)
    n_loc = mine.shape[0]
    n = k * n_loc if n is None else n
    true = [max(0, min((r + 1) * n_loc, n) - r * n_loc) for r in range(k)]
    cut = lambda x, t: x[:t] if cols is None else x[:t, :cols]
    mine, theirs = cut(mine, true[rank]), None
    for r in range(1, k):
        block = (cut(ref[r * n_loc:], true[r]).contiguous() if rank == 0 else
                 torch.empty_like(mine) if rank == r else
                 torch.empty((true[r],) + mine.shape[1:], dtype=mine.dtype,
                             device=mine.device))
        _bcast(block, group=group)
        theirs = block if rank == r else theirs
    a = _real64(mine)
    b = _real64(cut(ref, true[0]) if rank == 0 else theirs)
    sums = torch.stack([a @ b, a @ a, b @ b, (a - b) @ (a - b)])
    dist.all_reduce(sums, group=group)
    dot, aa, bb, dd = sums.tolist()
    return 1 - dot / math.sqrt(aa * bb), math.sqrt(dd / bb)


def _vector_arm(rank: int, arm: str, pair) -> dict:
    """Arm A (``arm`` "whiten"), B ("newton"), D ("cx_whiten") or E
    ("cx_newton") on the ranks of ``pair`` (0 and 1): rank 0 runs the
    reference first (``_vector_reference``); then each builds the arm's
    problem (``_vector_problem``) and the optimizer with
    vector_sharding=pair and takes the reference's steps: whitening from
    the reference's gradients (broadcast by rank 0), Newton through the
    closure, rank 0's autograd pass broadcast (``_newton_pass_from``).
    Returns the readings the gates read, the phases' seconds and the
    host's load."""
    from psgd_torch_tpu_torch.parallel import drift_check
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phases, load = {}, [os.getloadavg()[0]]
    k = dist.get_world_size(pair)
    ref = _vector_reference(arm, k, dev) if rank == 0 else None
    dist.barrier(group=pair)
    phases["reference"] = time.perf_counter() - t0
    named, loss_fn = _vector_problem(arm, dev)
    cls, kw = _vector_kw(arm, dev)
    opt = cls(named, vector_sharding=pair, **kw)
    if opt.n_pad != opt.n or k != 2:
        raise AssertionError(f"arms A, B, D and E take 2 ranks and an even n: {k}, {opt.n}")
    params = opt.param_groups[0]["params"]
    per_fit = dict(VECTOR_PER_FIT[arm])
    if not _is_whiten(arm):
        _newton_pass_from(rank, pair)
        if rank:     # the probes are drawn where the pass runs
            per_fit.update({key: 0 for key in per_fit if key.startswith("unit_noise")})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases["build"] = time.perf_counter() - t0 - phases["reference"]
    counts, opt_ms, agree, step_bytes, losses = {}, [], [], [], []
    kernels.reset_launch_counts()
    for i in range(VECTOR_FITS[arm]):
        before = [p.detach().clone() for p in params]
        if _is_whiten(arm):
            for j, p in enumerate(params):
                g = ref["grads"][i][j] if rank == 0 else torch.empty_like(p)
                _bcast(g, group=pair)
                p.grad = g
            step = opt.step
        else:
            step = lambda: losses.append(opt.step(loss_fn).item())
        with count_collectives() as calls:
            opt_ms.append(_counted_modes(step, counts))
        step_bytes.append(collective_bytes(calls, per_op=True))
        if rank == 0:
            agree.append(_agree(_flat_update(params, before), ref["updates"][i]))
    del before
    if not _is_whiten(arm):
        _own_newton_pass()
    phases["steps"] = time.perf_counter() - t0 - phases["reference"] - phases["build"]
    st = opt.precond
    drift = drift_check(dict({f"param {i}": p for i, p in enumerate(params)},
                             lu=st.lu, lv=st.lv, ld=st.ld), group=pair)
    rows = {f: _rows_agree(getattr(st, f), None if ref is None else ref["state"][f],
                           rank, pair) for f in ("u", "v", "d")}
    load.append(os.getloadavg()[0])
    out = dict(arm=arm, label=VECTOR_LABELS[arm], counts=counts, per_fit=per_fit,
               fits=opt.fit_steps, opt_ms=opt_ms, step_bytes=step_bytes, drift=drift,
               n=opt.n, n_pad=opt.n_pad, item=torch.empty((), dtype=opt.vec_dtype).element_size(),
               dtype=str(st.u.dtype), mine=state_memory_report(opt, per_device=True),
               whole=state_memory_report(opt), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               reserved_gb=torch.cuda.max_memory_reserved() / 1e9, load=load)
    if rank == 0:
        out.update(agree=agree, rows=rows, ref_memory=ref["memory"], ref_ms=ref["ms"],
                   ref_peak_gb=ref["peak_gb"], losses=ref["losses"] if _is_whiten(arm)
                   else losses, ref_losses=ref["losses"])
    del named, loss_fn, opt, params, st, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    phases["checks"] = out["seconds"] - sum(phases.values())
    out["phases"] = phases
    return out


def _pad_report(opt, seen) -> dict:
    """Where arm C's pad rows stand on this rank, each 0.0 when exact: LRA's
    largest |U|, |V|, |momentum| and |update| on them (``seen``: the row
    blocks ``_unvec`` received) and |d - 1|; dense's largest |Q - I| on
    its pad rows and on the pad columns.  Zeros where the rank holds no
    pad row (LRA)."""
    pads = max(opt.lo + opt.n_loc - opt.n, 0)
    if hasattr(opt.precond, "u"):
        if not pads:
            return dict(uv=0.0, d=0.0, mu=0.0, update=0.0)
        tail = slice(opt.n_loc - pads, opt.n_loc)
        st = opt.precond
        return dict(uv=float(torch.cat([st.u[tail], st.v[tail]]).abs().max()),
                    d=float((st.d[tail] - 1).abs().max()),
                    mu=0.0 if opt.mu is None else float(opt.mu[tail].abs().max()),
                    update=max([float(x[tail].abs().max()) for x in seen] or [0.0]))
    q = opt.precond.q
    cols = torch.arange(opt.n_pad, device=q.device)
    rows = opt.lo + torch.arange(opt.n_loc, device=q.device)
    off = (q - (rows[:, None] == cols[None, :]).to(q.dtype)).abs()
    worst = lambda x: float(x.max()) if x.numel() else 0.0
    return dict(q_rows=worst(off[rows >= opt.n]), q_cols=worst(off[:, cols >= opt.n]))


def _vector_cp(rank: int, world: int) -> dict:
    """Arm C on the tensor-rank problem (``cp_problem``, n = 1700, the
    example's settings, ``VECTOR_CP_STEPS`` steps): dense QEQ over the 4
    ranks beside a 1-rank vector_sharding run on rank 0 (taken first; every
    rank draws the same damping, 4 divides n); dense QEQ and LRANewton
    (rank 10) over ranks 0-2, n_pad 1701, the pad rows read after every
    step.  Rank 0 takes each step's autograd pass and broadcasts it over
    the arm's group."""
    from psgd_torch_tpu_torch.parallel import drift_check
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    ones = [dist.new_group([r]) for r in range(world)]
    three = dist.new_group([0, 1, 2])
    ref = None
    if rank == 0:
        params, loss = cp_problem(*CP_FULL, dev)
        opt = _cp_opt(params, dev, "QEQ", vector_sharding=ones[0])
        ref = dict(losses=[], params=[])
        for _ in range(VECTOR_CP_STEPS):
            ref["losses"].append(opt.step(loss).item())
            ref["params"].append(torch.cat([p.detach().flatten() for p in params]))
        del params, opt
    dist.barrier()
    out = {}
    for label, group, members, dq in (("dense QEQ, 4 ranks", dist.group.WORLD, (0, 1, 2, 3),
                                       "QEQ"),
                                      ("dense QEQ, 3 ranks", three, (0, 1, 2), "QEQ"),
                                      ("LRANewton, 3 ranks", three, (0, 1, 2), None)):
        if rank in members:
            params, loss = cp_problem(*CP_FULL, dev)
            opt = _cp_opt(params, dev, dq, vector_sharding=group)
            _newton_pass_from(rank, group)
            seen, unvec = [], opt._unvec

            def keep(pre, unvec=unvec, seen=seen):
                seen.append(pre.detach().clone())
                return unvec(pre)

            opt._unvec = keep
            counts, losses, pads, rel = {}, [], [], []
            kernels.reset_launch_counts()
            for i in range(VECTOR_CP_STEPS):
                seen.clear()
                _counted(lambda: losses.append(opt.step(loss).item()), counts)
                pads.append(_pad_report(opt, seen))
                if ref is not None and len(members) == world:
                    x = torch.cat([p.detach().flatten() for p in params])
                    rel.append(float((x - ref["params"][i]).norm() / ref["params"][i].norm()))
            _own_newton_pass()
            st = opt.precond
            shared = {"parameters": torch.cat([p.detach().flatten() for p in params])}
            shared.update({f: getattr(st, f) for f in ("lips", "lu", "lv", "ld")
                           if hasattr(st, f)})
            if dq is not None and opt.mu is not None:
                shared["momentum"] = opt.mu
            out[label] = dict(
                counts=counts, fits=opt.fit_steps, losses=losses, pads=pads, rel=rel,
                drift=drift_check(shared, group=group), k=len(members), n_pad=opt.n_pad,
                per_fit=dict(VECTOR_PER_FIT["cp"],
                             unit_noise=CP_LEAVES if rank == 0 else 0),
                ref_losses=None if ref is None or len(members) < world else ref["losses"])
            del params, opt, st, shared
        dist.barrier()
    out["seconds"] = time.perf_counter() - t0
    return out


def _vector_cx_dense(rank: int, world: int) -> dict:
    """Arm F: DenseNewton QEQ (the complex path's dense arm's settings, lr
    0.2) on ``CXL_PROBLEMS["dense"]`` in complex64 (n = 1700) over ranks
    0-2, n_pad 1701 (rank 2 holds the pad row), ``VECTOR_CX_DENSE_STEPS``
    steps through the closure, rank 0's autograd pass broadcast; beside a
    1-rank vector_sharding run on rank 0 (taken first), which draws the
    same damping on the true rows (each entry of a noise draw is a
    function of its key and index, not of the length).  Per step the
    update against the 1-rank run's, at the end Q's true rows and columns
    against its Q, the pad rows and columns after every step."""
    from psgd_torch_tpu_torch.parallel import drift_check
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    one, three = dist.new_group([0]), dist.new_group([0, 1, 2])
    problem = lambda: _cx_problem(*CXL_PROBLEMS["dense"], torch.complex64, dev,
                                  torch.Generator(device=dev).manual_seed(33))
    make = lambda params, group: DenseNewton(params, lr=0.2, dq="QEQ", vector_sharding=group,
                                             device=dev)
    ref = None
    if rank == 0:
        params, loss = problem()
        opt = make(params, one)
        ref = dict(losses=[], updates=[], memory=state_memory_report(opt))
        for _ in range(VECTOR_CX_DENSE_STEPS):
            before = [p.detach().clone() for p in params]
            ref["losses"].append(opt.step(loss).item())
            ref["updates"].append(_flat_update(params, before))
        ref["q"] = opt.precond.q
        del params, opt
    dist.barrier()
    out = None
    if rank < 3:
        params, loss = problem()
        opt = make(params, three)
        _newton_pass_from(rank, three)
        seen, unvec = [], opt._unvec

        def keep(pre):
            seen.append(pre.detach().clone())
            return unvec(pre)

        opt._unvec = keep
        counts, losses, pads, agree = {}, [], [], []
        kernels.reset_launch_counts()
        for i in range(VECTOR_CX_DENSE_STEPS):
            seen.clear()
            before = [p.detach().clone() for p in params]
            _counted_modes(lambda: losses.append(opt.step(loss).item()), counts)
            pads.append(_pad_report(opt, seen))
            if rank == 0:
                agree.append(_agree(_flat_update(params, before), ref["updates"][i]))
        _own_newton_pass()
        st = opt.precond
        rows = _rows_agree(st.q, None if ref is None else ref["q"], rank, three,
                           n=opt.n, cols=opt.n)
        drift = drift_check({"parameters": torch.cat([p.detach().flatten() for p in params]),
                             "lips": st.lips}, group=three)
        out = dict(counts=counts, fits=opt.fit_steps, losses=losses, pads=pads,
                   agree=agree, rows=rows, drift=drift, k=3, n=opt.n, n_pad=opt.n_pad,
                   dtype=str(st.q.dtype), mine=state_memory_report(opt, per_device=True),
                   whole=state_memory_report(opt),
                   per_fit=dict(VECTOR_PER_FIT["cx_dense"],
                                **({} if rank == 0 else {"unit_noise": 0,
                                                         "unit_noise.complex": 0})))
        if rank == 0:
            out.update(ref_losses=ref["losses"], ref_memory=ref["memory"])
        del params, opt, st
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if out is not None:
        out["seconds"] = time.perf_counter() - t0
    return out


def _vector_job(rank: int, world: int, _) -> dict:
    """Arms A, B, D and E on ranks 0 and 1 (the others wait), then arm C on
    all 4 and arm F on ranks 0-2, with the fault ``VECTOR_FAULT`` names
    planted first."""
    _plant_vector_fault()
    pair = dist.new_group([0, 1])
    ab, cx = [], []
    for arm, into in (("whiten", ab), ("newton", ab), ("cx_whiten", cx), ("cx_newton", cx)):
        into.append(_vector_arm(rank, arm, pair) if rank < 2 else None)
        dist.barrier()
    return dict(ab=ab, cx=cx, c=_vector_cp(rank, world), f=_vector_cx_dense(rank, world))


def _vector_readings(arms: list) -> list:
    """Per arm A and B (or D and E) of one spawn (``arms[r][j]``) its worst
    (1 - cosine, relative error) of the updates and of the U, V and d rows
    against the 1-rank reference, its largest drift and non-gather bytes."""
    out = []
    for j in range(len(arms[0])):
        head = arms[0][j]
        pairs = head["agree"] + list(head["rows"].values())
        out.append(dict(arm=head["arm"], label=head["label"],
                        one_minus_cos=max(a[0] for a in pairs),
                        rel_err=max(a[1] for a in pairs),
                        drift=max(max(a[j]["drift"].values()) for a in arms),
                        small_bytes=max(sum(v for k, v in b.items() if k != "all-gather")
                                        for a in arms for b in a[j]["step_bytes"])))
    return out


def _cp_readings(ranks: list) -> dict:
    """Arm C's worst parameter gap to the 1-rank run and largest pad-row
    reading over ranks and steps, per sub-arm."""
    out = {}
    for label in ranks[0]:
        if label == "seconds":
            continue
        res = [r[label] for r in ranks if label in r]
        out[label] = dict(rel=max(res[0]["rel"] or [0.0]),
                          pad=max(max(p.values()) for r in res for p in r["pads"]),
                          drift=max(max(r["drift"].values()) for r in res))
    return out


def _vector_check(arms: list, card: str) -> dict:
    """The gates of arms A and B, or D and E (``arms[r][j]``: rank r, arm
    j); the complex arms' losses also fall, as the JAX package's own
    complex LRA runs do (``CXL_FALLS``)."""
    total = {}
    for j, reading in enumerate(_vector_readings(arms)):
        ranks = [a[j] for a in arms]
        head, k = ranks[0], len(ranks)
        label, arm = head["label"], head["arm"]
        cos_limit, rel_limit = VECTOR_LIMITS[arm]
        losses = head["losses"]
        log(f"{label} vector-sharded over {k} ranks (n = {head['n']}, {head['dtype']}): "
            f"losses {[round(x, 4) for x in losses]}; the 1-rank reference's "
            f"{[round(x, 4) for x in head['ref_losses']]}")
        if not all(math.isfinite(x) for x in losses + head["ref_losses"]):
            raise AssertionError(f"{label}: losses {losses}, reference {head['ref_losses']}")
        if arm.startswith("cx_"):
            _falls(label, losses[0], losses[-1])
        log(f"  updates against the reference per step, (1 - cosine, relative error) "
            f"{head['agree']}; U, V, d rows {head['rows']}; worst "
            f"{(reading['one_minus_cos'], reading['rel_err'])}")
        if not (reading["one_minus_cos"] < cos_limit and reading["rel_err"] < rel_limit):
            raise AssertionError(f"{label}: against the 1-rank reference "
                                 f"{(reading['one_minus_cos'], reading['rel_err'])}, need "
                                 f"< {cos_limit:g} and < {rel_limit:g}")
        ref = head["ref_memory"]
        for r, res in enumerate(ranks):
            if set(res["drift"].values()) != {0.0}:
                raise AssertionError(f"{label}: rank {r} drift "
                                     f"{[n for n, v in res['drift'].items() if v]}")
            fits = res["fits"]
            per = {key: res["counts"].get(key, 0) / max(fits, 1) for key in res["per_fit"]}
            if fits != VECTOR_FITS[arm] or any(
                    res["counts"].get(key, 0) != n * fits for key, n in res["per_fit"].items()):
                raise AssertionError(f"{label}: rank {r} launched {per} per fit step over "
                                     f"{fits} fits, expected {res['per_fit']}")
            mine = res["mine"]
            if not (mine["q"] * k == ref["q"] and mine["momentum"] * k == ref["momentum"]
                    and res["whole"]["q"] == ref["q"]):
                raise AssertionError(f"{label}: rank {r}'s state {mine}, the reference's {ref}")
            gather, small_limit = res["n_pad"] * res["item"], VECTOR_SMALL_BYTES[arm]
            for b in res["step_bytes"]:
                small = sum(v for key, v in b.items() if key != "all-gather")
                if b.get("all-gather") != gather or small >= small_limit:
                    raise AssertionError(f"{label}: rank {r}'s collectives in a step {b}; "
                                         f"need the update's gather, {gather} "
                                         f"bytes, and < {small_limit} bytes else")
            log(f"  [{card}; {VECTOR_LABEL}] rank {r}: optimizer step (median, first "
                f"excluded) {_median(res['opt_ms'][1:])} ms (the 1-rank reference's "
                f"{_median(head['ref_ms'][1:])} ms); peak {res['peak_gb']:.2f} GB allocated, "
                f"{res['reserved_gb']:.2f} GB reserved (the reference {head['ref_peak_gb']:.2f}"
                f" GB); state per rank U, V, d {mine['q'] / 1e9:.3f} GB, momentum "
                f"{mine['momentum'] / 1e9:.3f} GB (the reference {ref['q'] / 1e9:.3f} and "
                f"{ref['momentum'] / 1e9:.3f}); collectives per step {res['step_bytes']}; "
                f"launches per fit {per}; drift 0.0 on {len(res['drift'])} tensors")
            _add(total, res["counts"])
        log(f"  {label}: {head['seconds']:.1f} s in the ranks (rank 0: "
            f"{', '.join(f'{k} {v:.1f} s' for k, v in head['phases'].items())}; the "
            f"host's load average {head['load'][0]:.1f} -> {head['load'][1]:.1f})")
    return total


def _cp_check(ranks: list, card: str) -> dict:
    """The gates of arm C (``ranks[r]``: rank r's sub-arms)."""
    total = {}
    readings = _cp_readings(ranks)
    for label, reading in readings.items():
        res = [r[label] for r in ranks if label in r]
        head = res[0]
        log(f"tensor-rank (n = 1700) {label} vector-sharded (n_pad {head['n_pad']}): loss "
            f"{head['losses'][0]:.6g} -> {head['losses'][-1]:.6g} in {VECTOR_CP_STEPS} "
            f"steps" + ("" if head["ref_losses"] is None else
                         f"; the 1-rank run's {head['ref_losses'][0]:.6g} -> "
                         f"{head['ref_losses'][-1]:.6g}, parameters' gap per step "
                         f"{head['rel']}") + f"; pad rows, worst {reading['pad']!r}")
        if not head["losses"][-1] < head["losses"][0]:
            raise AssertionError(f"{label}: loss {head['losses']}")
        if head["ref_losses"] is not None and not (
                reading["rel"] < VECTOR_CP_REL and head["ref_losses"][-1] < head["ref_losses"][0]):
            raise AssertionError(f"{label}: parameters' gap to the 1-rank run {head['rel']} "
                                 f"(need < {VECTOR_CP_REL:g}), its losses {head['ref_losses']}")
        if reading["pad"] != 0.0 or reading["drift"] != 0.0:
            raise AssertionError(f"{label}: pad rows {[r['pads'] for r in res]}, drift "
                                 f"{[r['drift'] for r in res]}")
        for r, one in enumerate(res):
            fits = one["fits"]
            if fits != VECTOR_CP_STEPS or any(one["counts"].get(key, 0) != n * fits
                                              for key, n in one["per_fit"].items()):
                raise AssertionError(f"{label}: rank {r} launched {one['counts']} in {fits} "
                                     f"fits, expected {one['per_fit']} per fit")
            _add(total, one["counts"])
    log(f"  arm C: {ranks[0]['seconds']:.1f} s in the ranks")
    return total


def _cx_dense_readings(ranks: list) -> dict:
    """Arm F's worst (1 - cosine, relative error) of the updates and Q's
    rows against the 1-rank run, largest pad-row reading and drift."""
    head = ranks[0]
    pairs = head["agree"] + [head["rows"]]
    return dict(one_minus_cos=max(a[0] for a in pairs), rel_err=max(a[1] for a in pairs),
                pad=max(max(p.values()) for r in ranks for p in r["pads"]),
                drift=max(max(r["drift"].values()) for r in ranks))


def _cx_dense_check(ranks: list, card: str) -> dict:
    """The gates of arm F (``ranks[r]``: rank r of 0-2): the losses finite
    and falling, as the JAX package's own vector-sharded complex dense QEQ
    falls at each of its first 4 steps on the small problem
    (``tools/complex_fall_jax.py --vector``), the updates and Q's true rows within
    ``VECTOR_LIMITS["cx_dense"]`` of the 1-rank run, the pad row and
    columns exact and no drift after every step, exact launches (all in
    the complex mode), each rank's Q a third of the padded whole."""
    total, head = {}, ranks[0]
    reading = _cx_dense_readings(ranks)
    cos_limit, rel_limit = VECTOR_LIMITS["cx_dense"]
    label = "complex64 dense QEQ, 3 ranks"
    log(f"{label} (n = {head['n']}, n_pad {head['n_pad']}, {head['dtype']}): losses "
        f"{[round(x, 6) for x in head['losses']]}; the 1-rank run's "
        f"{[round(x, 6) for x in head['ref_losses']]}; updates against it per step "
        f"{head['agree']}, Q's rows {head['rows']}; pad row and columns, worst "
        f"{reading['pad']!r}; drift {reading['drift']!r}")
    if not all(math.isfinite(x) for x in head["losses"] + head["ref_losses"]):
        raise AssertionError(f"{label}: losses {head['losses']}, the 1-rank run's "
                             f"{head['ref_losses']}")
    _falls(label, head["losses"][0], head["losses"][-1])
    if not (reading["one_minus_cos"] < cos_limit and reading["rel_err"] < rel_limit):
        raise AssertionError(f"{label}: against the 1-rank run "
                             f"{(reading['one_minus_cos'], reading['rel_err'])}, need "
                             f"< {cos_limit:g} and < {rel_limit:g}")
    if reading["pad"] != 0.0 or reading["drift"] != 0.0:
        raise AssertionError(f"{label}: pad rows {[r['pads'] for r in ranks]}, drift "
                             f"{[r['drift'] for r in ranks]}")
    item = 8     # complex64
    for r, one in enumerate(ranks):
        fits = one["fits"]
        if fits != VECTOR_CX_DENSE_STEPS or any(one["counts"].get(key, 0) != n * fits
                                                for key, n in one["per_fit"].items()):
            raise AssertionError(f"{label}: rank {r} launched {one['counts']} in {fits} "
                                 f"fits, expected {one['per_fit']} per fit")
        if not (one["mine"]["q"] * one["k"] == one["whole"]["q"] == one["n_pad"] ** 2 * item
                and head["ref_memory"]["q"] == one["n"] ** 2 * item):
            raise AssertionError(f"{label}: rank {r}'s Q {one['mine']}, the whole "
                                 f"{one['whole']}, the 1-rank run's {head['ref_memory']}")
        _add(total, one["counts"])
    log(f"  arm F: {head['seconds']:.1f} s in the ranks; Q per rank "
        f"{head['mine']['q'] / 1e6:.2f} MB of {head['whole']['q'] / 1e6:.2f} MB")
    return total


def vector_sharded_path(dev, card: str) -> dict:
    """Arms A, B, D and E on 2 ranks, C on 4, F on 3, in one spawn of 4
    ranks (``_vector_job``): A, B, D and E's
    updates and U, V, d rows within ``VECTOR_LIMITS`` of
    their 1-rank references fed the same per-shard draws, drift 0.0 on the
    parameters and the estimates, per-rank state 1/k of the reference's,
    exact launches per fit (D and E's all in the noise's complex mode),
    each step's collectives the update's gather and under
    ``VECTOR_SMALL_BYTES`` else, D and E's losses falling; C's dense QEQ within
    ``VECTOR_CP_REL`` of the 1-rank run and its loss falling, its pad rows
    (and LRANewton's) exact after every step; F's gates
    (``_cx_dense_check``).  The complex arms' losses fall as the JAX
    package's own vector-sharded runs do (``tools/complex_fall_jax.py
    --vector``).  Returns the launches."""
    t0 = time.perf_counter()
    ranks = _spawn("vector", 4)
    total = _vector_check([r["ab"] for r in ranks[:2]], card)
    _add(total, _vector_check([r["cx"] for r in ranks[:2]], card))
    _add(total, _cp_check([r["c"] for r in ranks], card))
    _add(total, _cx_dense_check([r["f"] for r in ranks[:3]], card))
    log(f"  [{card}] vector-sharded path {time.perf_counter() - t0:.1f} s; its launches "
        f"(ranks summed) {{{', '.join(f'{k}: {v}' for k, v in total.items() if v)}}}")
    return total


def vector_fault_margin(dev, card: str) -> dict:
    """How far the vector-sharded path's gates sit from a planted fault:
    arms A to F once per ``VECTOR_FAULTS`` entry (planted in every
    rank, ``_plant_vector_fault``), each arm's worst readings logged, no
    gate applied; the last log line one JSON object of them all.  Run it
    alone: ``python3 tools/smoke_paths.py vector_fault_margin``."""
    result = {}
    for fault in VECTOR_FAULTS:
        close_ranks()          # the fault is read from the environment at spawn
        os.environ["VECTOR_FAULT"] = fault
        ranks = _spawn("vector", 4)
        rows = (_vector_readings([r["ab"] for r in ranks[:2]])
                + _vector_readings([r["cx"] for r in ranks[:2]]))
        cp = _cp_readings([r["c"] for r in ranks])
        dense = _cx_dense_readings([r["f"] for r in ranks[:3]])
        for row in rows:
            log(f"[{card}] fault {fault}: {row['label']}: worst 1 - cosine "
                f"{row['one_minus_cos']!r}, relative error {row['rel_err']!r}, drift "
                f"{row['drift']!r}, non-gather bytes {row['small_bytes']}")
        for label, row in cp.items():
            log(f"[{card}] fault {fault}: tensor-rank {label}: gap to 1 rank {row['rel']!r}, "
                f"pad rows {row['pad']!r}, drift {row['drift']!r}")
        log(f"[{card}] fault {fault}: complex64 dense QEQ, 3 ranks: worst 1 - cosine "
            f"{dense['one_minus_cos']!r}, relative error {dense['rel_err']!r}, pad rows "
            f"{dense['pad']!r}, drift {dense['drift']!r}")
        result[fault] = dict(ab=rows, c=cp, f=dense)
    close_ranks()
    os.environ.pop("VECTOR_FAULT")
    log(json.dumps(result))
    return {}


# the sharded trainer's path: GPT-2 124M through examples/train_gpt2_sharded
# (layer-sharded blocks by gpt2.shard_model, stack_sharding, the routed
# embeddings) on 2 ranks of cuda:0 and on 1; TRAINER_STEPS steps, the
# checkpoint after TRAINER_AT; the schedule's length keeps p >= 0.99 over
# them (every step a fit step, as the smoke checks)
TRAINER_STEPS = 3
TRAINER_AT = 2
TRAINER_SCHEDULE = 200
TRAINER_BATCH = 4
# the trainer's default (the JAX example's gradient whitening, fit then
# apply); with --share-fit-apply a step's update is the fit's P(m +
# damping noise), whose bf16 damping (eps|m| v) each rank of a routed leaf
# draws under its own block's key: 1 - cosine 8.4e-5 and relative error
# 0.013 from 1 rank on wte (PERF.md §6), over FACTOR_COS/FACTOR_REL,
# which hold P m
TRAINER_LABEL = "2 ranks sharing one H100 over gloo; not a scaling figure"


def _trainer_digests(s) -> dict:
    """SHA-256 of every parameter block of a trainer's model (its local
    one when sharded) with the dim that shards it (None: whole), and of
    every tensor of its optimizer's state_dict."""
    from torch.distributed.tensor import DTensor, Shard
    params = {}
    for n, p in s.model.named_parameters():
        if isinstance(p, DTensor):
            dims = [pl.dim for pl in p.placements if isinstance(pl, Shard)]
            params[n] = (_digest(p.to_local()), dims[0] if dims else None)
        else:
            params[n] = (_digest(p), None)
    state = {}

    def walk(x, where):
        if isinstance(x, torch.Tensor):
            state[where] = _digest(x)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{where}/{k}")
        elif isinstance(x, (tuple, list)):
            for j, v in enumerate(x):
                walk(v, f"{where}/{j}")
    walk(s.opt.state_dict(), "")
    return dict(params=params, state=state)


def _embeddings(s) -> dict:
    """The routed embeddings' blocks (this rank's, or whole), on the host."""
    out = {}
    for n, p in s.model.named_parameters():
        if n in ("wte", "wpe"):
            out[n] = (p.to_local() if hasattr(p, "to_local") else p).detach().float().cpu().clone()
    return out


def _trainer_steps(s, make, steps, record=None) -> tuple:
    """``steps`` trainer steps (their indices): (losses, host ms per step,
    fits per step); ``record``: the launches of rows 1 and 2 added to it."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    losses, ms, fits = [], [], []
    for i in steps:
        before = _all_counts()
        f0 = s.opt.fit_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.train_step(s, *make(i)).item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        fits.append(s.opt.fit_steps - f0)
        if record is not None:
            _add(record, {k: v - before[k] for k, v in _all_counts().items()})
    return losses, ms, fits


def _trainer_bytes(s) -> dict:
    """This rank's parameter bytes (its blocks) and optimizer state bytes
    (``state_memory_report`` per device)."""
    params = sum((p.to_local() if hasattr(p, "to_local") else p).numel()
                 * p.element_size() for p in s.model.parameters())
    state = state_memory_report(s.opt, per_device=True)
    return dict(params=params, state=sum(state.values()))


def _trainer_replicated(s) -> dict:
    """What every rank holds whole: the replicated parameters and their
    state, the gathered (diagonal) stacks' Q and L, the routed leaves'
    dense Q and L."""
    out = {}
    opt = s.opt
    for i, p in enumerate(opt.param_groups[0]["params"]):
        st = opt.state[p]
        if opt.dtensors[i] is None:
            out[f"param {i}"] = p
            out[f"momentum {i}"] = st["mu"]
        if opt.owned[i]:
            continue
        for j, f in enumerate(st["q"]):
            if opt.routed[i] is None or f.ndim == 2:
                out[f"Q {i}[{j}]"] = f
        for j, f in enumerate(st["lips"]):
            out[f"L {i}[{j}]"] = f
    return out


def _trainer_job(rank: int, world: int, base: str) -> dict:
    """The 2-rank runs of ``sharded_trainer_path`` under CUDA's
    deterministic algorithms: the unbroken run (checkpoint A after
    TRAINER_AT steps, rank 0 then gathers it), its resume from A, and the
    resume from the 1-rank checkpoint B (cut to each rank)."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    from psgd_torch_tpu_torch.parallel import drift_check
    from psgd_torch_tpu_torch.utils import gather_checkpoint
    dev = torch.device("cuda", 0)
    a, b = os.path.join(base, "a"), os.path.join(base, "b")
    out = {}
    with _deterministic(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = tr.make_config("124m", dev)
        make = tr.batch_fn(cfg, TRAINER_BATCH, dev)
        s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
        out["mesh"] = tr.mesh_sizes(s.mesh)
        out["kinds"] = dict(owned=sum(s.opt.owned),
                            whole=sum(w is not None for w in s.opt.whole),
                            routed=sum(r is not None for r in s.opt.routed))
        kernels.reset_launch_counts()
        counts = {}
        torch.cuda.reset_peak_memory_stats()
        losses, ms, fits = _trainer_steps(s, make, range(TRAINER_AT), counts)
        t0 = time.perf_counter()
        save_checkpoint(a, TRAINER_AT, s.model, s.opt)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = _trainer_bytes(s)
        out["at"] = _embeddings(s)
        more = _trainer_steps(s, make, range(TRAINER_AT, TRAINER_STEPS), counts)
        out.update(losses=losses + more[0], ms=ms + more[1], fits=fits + more[2],
                   counts=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   unbroken=_trainer_digests(s), after=_embeddings(s),
                   drift=drift_check(_trainer_replicated(s)))
        del s
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:
            t0 = time.perf_counter()
            gather_checkpoint(a, device=dev)
            out["gather_s"] = time.perf_counter() - t0
            out["file_bytes"] = {f: os.path.getsize(os.path.join(a, f"step_{TRAINER_AT}", f))
                                 for f in os.listdir(os.path.join(a, f"step_{TRAINER_AT}"))}
        dist.barrier()
        for tag, src in (("same", a), ("cut", b)):
            s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
            t0 = time.perf_counter()
            step, _ = restore_checkpoint(src, s.model, s.opt)
            out[f"{tag}_restore_s"] = time.perf_counter() - t0
            before = _embeddings(s)
            res = _trainer_steps(s, make, range(step, TRAINER_STEPS))
            out[tag] = dict(step=step, losses=res[0], fits=res[2], before=before,
                            after=_embeddings(s), digests=_trainer_digests(s))
            del s
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _trainer_one_rank(make_s, src, make) -> dict:
    """A 1-rank trainer run (this process, no process group): restored
    from ``src`` (or from the start, checkpointed to ``make_s``'s
    directory after TRAINER_AT steps), to TRAINER_STEPS; its readings."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    dev = torch.device("cuda", 0)
    cfg = tr.make_config("124m", dev)
    s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
    out, counts = {}, {}
    kernels.reset_launch_counts()
    if src is not None:
        t0 = time.perf_counter()
        start, _ = restore_checkpoint(src, s.model, s.opt)
        out["restore_s"] = time.perf_counter() - t0
    else:
        res = _trainer_steps(s, make, range(TRAINER_AT), counts)
        out.update(losses=res[0], ms=res[1], fits=res[2])
        t0 = time.perf_counter()
        save_checkpoint(make_s, TRAINER_AT, s.model, s.opt)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = _trainer_bytes(s)
        start = TRAINER_AT
    out["at"] = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    res = _trainer_steps(s, make, range(start, TRAINER_STEPS), counts)
    out["losses"] = out.get("losses", []) + res[0]
    out["ms"] = out.get("ms", []) + res[1]
    out["fits"] = out.get("fits", []) + res[2]
    out["counts"] = counts
    out["after"] = {n: p.detach().clone() for n, p in s.model.named_parameters()}
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _blocks_agree(label, one, ranks, tag, card) -> None:
    """A 1-rank run's step TRAINER_STEPS (``one``: its parameters at the
    checkpoint and after) against the 2-rank run's (``tag``: its unbroken
    run, or its resume "cut"): every parameter but the routed embeddings
    bit for bit, block by block (the stack-sharded blocks, as k ranks
    equal 1), the embeddings' updates within ``FACTOR_COS`` and
    ``FACTOR_REL``."""
    worst = (0.0, 0.0)
    for r, res in enumerate(ranks):
        if tag == "unbroken":
            digests, before, after = res["unbroken"]["params"], res["at"], res["after"]
        else:
            run = res[tag]
            digests, before, after = run["digests"]["params"], run["before"], run["after"]
        for n, (d, dim) in digests.items():
            if n in before:
                continue
            whole = one["after"][n]
            block = whole if dim is None else whole.chunk(len(ranks), dim)[r]
            if _digest(block) != d:
                raise AssertionError(f"{label}: rank {r}'s block of {n} differs "
                                     "from the 1-rank run's")
        for n in before:
            mine = (one["after"][n] - one["at"][n]).float().cpu()
            cos_gap, rel = _agree(after[n] - before[n], mine.chunk(len(ranks), 1)[r])
            worst = (max(worst[0], cos_gap), max(worst[1], rel))
            if not (1 - cos_gap > FACTOR_COS and rel < FACTOR_REL):
                raise AssertionError(f"{label}: rank {r}'s {n} update 1 - cosine "
                                     f"{cos_gap:.3g}, relative error {rel:.3g} from "
                                     "the 1-rank run's")
    log(f"  [{card}] {label}: every other parameter bit for bit; the wte and wpe "
        f"updates' worst 1 - cosine {worst[0]!r}, relative error {worst[1]!r}")


def sharded_trainer_path(dev, card: str) -> dict:
    """GPT-2 124M through ``examples/train_gpt2_sharded``'s functions at
    full width and depth, batch TRAINER_BATCH x 1024, bf16: on 2 ranks of
    this card (gloo; the layer-sharded blocks of ``gpt2.shard_model``,
    stack_sharding over its
    fsdp dim, the embeddings factor-sharded) and on 1, each TRAINER_STEPS
    steps with a checkpoint after TRAINER_AT, under CUDA's deterministic
    algorithms.  (a) The 2-rank run resumed on 2 ranks equals its unbroken
    step bit for bit (parameters and every state tensor); gathered
    (``gather_checkpoint``) and resumed on 1 rank, its step holds against
    the unbroken 2-rank step: every parameter but the embeddings bit for
    bit, the embeddings' updates within ``FACTOR_COS`` / ``FACTOR_REL``.
    (b) The 1-rank checkpoint cut for 2 ranks, held the same way against
    the unbroken 1-rank run.  (c) Per-rank parameter and state bytes about
    half the 1-rank run's, drift_check 0.0 on the replicated entries,
    GPT2_PER_FIT launches of rows 1 and 2 per fit step on each rank,
    finite losses; the step times, the gather's and the cut's seconds and
    the checkpoint bytes logged.  Returns the 2-rank run's launches."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    t0 = time.perf_counter()
    base = OUT_DIR / "sharded_trainer"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    cfg = tr.make_config("124m", dev)
    make = tr.batch_fn(cfg, TRAINER_BATCH, dev)
    try:
        with _deterministic(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one = _trainer_one_rank(str(base / "b"), None, make)
        ranks = _spawn(f"trainer:{base}", 2)
        with _deterministic(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            resumed = _trainer_one_rank(None, str(base / "a"), make)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    total = {}
    log(f"GPT-2 124M by the sharded trainer on mesh {ranks[0]['mesh']} ({TRAINER_LABEL}); "
        f"{ranks[0]['kinds']} leaves owned by layer / gathered whole / routed; losses "
        f"{[round(x, 4) for x in ranks[0]['losses']]} (1 rank "
        f"{[round(x, 4) for x in one['losses']]})")
    for r, res in enumerate(ranks):
        if not all(math.isfinite(x) for x in res["losses"]) or res["fits"] != [1] * TRAINER_STEPS:
            raise AssertionError(f"sharded trainer rank {r}: losses {res['losses']}, "
                                 f"fits {res['fits']}")
        if res["same"]["digests"] != res["unbroken"]:
            raise AssertionError(f"sharded trainer: rank {r}'s 2-rank resume differs "
                                 "from the unbroken run")
        if res["cut"]["step"] != TRAINER_AT or res["same"]["step"] != TRAINER_AT:
            raise AssertionError(f"sharded trainer: rank {r} resumed at "
                                 f"{res['cut']['step']}, {res['same']['step']}")
        per = {k: res["counts"].get(k, 0) / TRAINER_STEPS for k in GPT2_PER_FIT}
        if any(res["counts"].get(k, 0) != n * TRAINER_STEPS for k, n in GPT2_PER_FIT.items()):
            raise AssertionError(f"sharded trainer: rank {r} launched {per} per fit step, "
                                 f"expected {GPT2_PER_FIT}")
        drift = set(res["drift"].values())
        if drift != {0.0}:
            raise AssertionError(f"sharded trainer: rank {r} drift {res['drift']}")
        share = {k: res["bytes"][k] / one["bytes"][k] for k in ("params", "state")}
        if not all(0.4 < v < 0.6 for v in share.values()):
            raise AssertionError(f"sharded trainer: rank {r} holds {res['bytes']} bytes, "
                                 f"the 1-rank run {one['bytes']}")
        _add(total, res["counts"])
        log(f"  rank {r}: resumed on 2 ranks bit for bit the unbroken run (parameters and "
            f"{len(res['unbroken']['state'])} state tensors); launches per fit step {per}; "
            f"drift 0.0 on {len(res['drift'])} replicated tensors; parameters "
            f"{res['bytes']['params'] / 1e6:.1f} MB, optimizer state "
            f"{res['bytes']['state'] / 1e6:.1f} MB (1 rank {one['bytes']['params'] / 1e6:.1f}, "
            f"{one['bytes']['state'] / 1e6:.1f}: {share['params']:.3f}, {share['state']:.3f}); "
            f"peak {res['peak_gb']:.2f} GB")
        log(f"  [{card}; {TRAINER_LABEL}] rank {r}: train step (forward, backward, "
            f"optimizer; fit) ms {[round(x, 2) for x in res['ms']]}, median after the "
            f"first {_median(res['ms'][1:])}; 1-rank run {[round(x, 2) for x in one['ms']]}, "
            f"median after the first {_median(one['ms'][1:])}")
    for label, run in (("1-rank", one), ("1-rank resumed", resumed)):
        if not all(math.isfinite(x) for x in run["losses"]) or \
                any(f != 1 for f in run["fits"]):
            raise AssertionError(f"sharded trainer {label}: losses {run['losses']}, "
                                 f"fits {run['fits']}")
    _blocks_agree("(a) 2 ranks -> gathered -> 1 rank, step 3 against the unbroken "
                  "2-rank run", resumed, ranks, "unbroken", card)
    _blocks_agree("(b) 1 rank -> cut -> 2 ranks, step 3 against the unbroken 1-rank run",
                  one, ranks, "cut", card)
    files = ranks[0]["file_bytes"]
    log(f"  [{card}] checkpoint A (2 ranks, step {TRAINER_AT}): "
        f"{', '.join(f'{k} {v / 1e9:.3f} GB' for k, v in sorted(files.items()))}; save "
        f"{[round(r['save_s'], 2) for r in ranks]} s per rank; gather (rank 0, on the card) "
        f"{ranks[0]['gather_s']:.2f} s; 2-rank restore of its own files "
        f"{[round(r['same_restore_s'], 2) for r in ranks]} s, of the 1-rank file cut "
        f"{[round(r['cut_restore_s'], 2) for r in ranks]} s; 1-rank restore of the gathered "
        f"file {resumed['restore_s']:.2f} s; 1-rank save {one['save_s']:.2f} s")
    log(f"  [{card}] sharded trainer path {time.perf_counter() - t0:.1f} s; its launches "
        f"(2 ranks summed) {{{', '.join(f'{k}: {v}' for k, v in total.items() if v)}}}")
    return total


# the tensor-parallel path (ROADMAP A8c): GPT-2 124M's widths in JAX's
# production layout, examples/train_gpt2_sharded.py's functions on 4 ranks
# of cuda:0 over gloo as make_mesh(4)'s (dp 1, fsdp 2, tp 2): the blocks
# (None, fsdp, tp) by gpt2.shard_model (tp forward, the fsdp blocks
# gathered in it), stack_sharding over fsdp (each rank's TP_LAYERS / 2
# layers resharded by bytes, Q replicated over tp), the embeddings
# factor-sharded; TRAINER_BATCH x 1024, bf16, TRAINER_SCHEDULE's gate
# (every step a fit step).  Its cut: depth 12 -> TP_LAYERS, which pays for
# the LLaMA tp path after it
TP_LAYERS = 6
TP_WORLD = 4
TP_STEPS = 3           # (a)'s fit steps and (b)'s trainer steps
TP_AT = 2              # (b)'s checkpoint, before its last step
TP_GRAD_SCALE = 1e-3   # (a)'s gradients: N(0, 1) times this
# (b)'s first loss against the 1-rank model's on the same tokens (bf16: the
# tp partial sums round to bf16 before their float32 sum), and (c) the step
# after the 4-rank checkpoint, gathered and resumed on 1 rank, against the
# unbroken 4-rank step: each leaf's update within 1 - cosine TP_COS and
# relative error TP_REL.  Set against planted faults (tp_fault_margin, its
# readings in PERF.md §6, on an H100 80GB HBM3 at 700 W): sound, loss gap
# 4.6e-6 and worst update 1.9e-3 / 0.062 (the LayerNorm scales; every
# other leaf under 2e-4 / 0.02); one head off, 5.0e-4 and 0.37 / 0.87; the
# reshard one layer off, 1.0 / 1.4; a skipped tp all-reduce, the gather
# refuses the replicas that drifted
TP_LOSS_REL = 1e-4
TP_COS = 2e-2
TP_REL = 0.3
# planted faults: a skipped row-parallel all-reduce over tp, the reshard's
# layers one layer off, the q/k/v regroup one head off
TP_FAULTS = ("none", "allreduce", "layers", "heads")
TP_LABEL = "4 ranks sharing one H100 over gloo; not a scaling figure"


def _tp_config(dev):
    """GPT-2 124M's widths at TP_LAYERS layers, as the trainer computes."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    return dataclasses.replace(tr.make_config("124m", dev), n_layer=TP_LAYERS)


def _plant_tp_fault(fault: str):
    """Plant ``fault`` in this process; returns the undo."""
    from psgd_torch_tpu_torch.parallel import mesh as pmesh
    from psgd_torch_tpu_torch.parallel import tensor_parallel
    lay = tensor_parallel.TPLayout
    saved = (lay.reduce, gpt2._heads, pmesh.LayerReshard.to_layers)

    def undo():
        lay.reduce, gpt2._heads, pmesh.LayerReshard.to_layers = saved

    if fault == "allreduce":
        # the row-parallel products' sums over tp, the only ones in bf16
        # (the embedding's and the cross-entropy's are float32)
        own = saved[0]
        lay.reduce = lambda self, x: x if x.dtype == torch.bfloat16 else own(self, x)
    elif fault == "heads":
        def shifted(n_head, tp, index):
            k = n_head // tp
            return [(index * k + j + 1) % n_head for j in range(k)]
        gpt2._heads = shifted
    elif fault == "layers":
        own = saved[2]
        pmesh.LayerReshard.to_layers = lambda self, block: own(self, block).roll(1, 0)
    elif fault != "none":
        raise ValueError(f"unknown fault {fault}")
    return undo


def _tp_grads(step: int, model, dev) -> dict:
    """(a)'s gradients at ``step``: name -> a global tensor, the same on
    every process (a card generator seeded by the step, the names sorted)."""
    gen = torch.Generator(device=dev).manual_seed(1000 + step)
    return {n: TP_GRAD_SCALE * torch.randn(tuple(p.shape), generator=gen, device=dev)
            for n, p in sorted(model.named_parameters())}


def _tp_box(p) -> list:
    """Where a DTensor parameter's block sits: [start, stop] per dim."""
    from psgd_torch_tpu_torch.utils.checkpoint import _dtensor_index
    return _dtensor_index(p)


def _cut(x, box) -> torch.Tensor:
    return x[tuple(slice(a, b) for a, b in box)]


def _tp_kinds(opt) -> dict:
    """Leaf name -> how the optimizer holds it."""
    return {n: ("resharded" if opt.resharded[i] is not None else
                "owned" if opt.owned[i] else "routed" if opt.routed[i] is not None
                else "whole" if opt.whole[i] is not None else "plain")
            for i, n in enumerate(opt._names)}


def _tp_state(opt) -> dict:
    """name -> (Q factors, L, this rank's layers or None) on the host."""
    out = {}
    for i, (n, p) in enumerate(zip(opt._names, opt.param_groups[0]["params"])):
        st, s = opt.state[p], opt.layers[i]
        out[n] = ([f.detach().clone() for f in st["q"]],
                  [f.detach().clone() for f in st["lips"]],
                  None if s is None else (s.start, s.stop))
    return out


def _tp_alike(opt) -> dict:
    """What the tp ranks hold alike: every Q and L (a resharded stack's
    the same layers on both tp ranks) but a routed leaf's diagonal
    factors, its blocks."""
    out = {}
    for n, p, r in zip(opt._names, opt.param_groups[0]["params"], opt.routed):
        st = opt.state[p]
        for j, f in enumerate(st["q"]):
            if r is None or f.ndim == 2:
                out[f"{n} Q {j}"] = f
        for j, f in enumerate(st["lips"]):
            out[f"{n} L {j}"] = f
    return out


# each NS route's launches per call (``kernels._dispatch``)
ROUTE_LAUNCHES = {"single": {"fused_ns_update": 1},
                  "split": {"ns_step": 1, "procrustes": 1},
                  "tiled": {"norm_bound": 2, "tiled_step": 1, "tsub": 1,
                            "scaled_matmul_trace": 2, "combine": 1}}


def _tp_per_fit(opt) -> dict:
    """Rows 1-9's launches per fit step on this rank, from the layout: one
    damped noise per leaf, and per dense factor of each leaf (a stack's at
    its B layers, a routed leaf's whole on every rank) one call of the NS
    route its width and Q's dtype take (``kernels.ns_route``), whose
    launches ``ROUTE_LAUNCHES`` gives."""
    out = dict.fromkeys((name for name, _, _ in ROWS), 0)
    out["damped_noise"] = len(opt.plans)
    for p, plan in zip(opt.param_groups[0]["params"], opt.plans):
        for n, diag, q in zip(plan.shape, plan.is_diag, opt.state[p]["q"]):
            if not diag:
                for k, c in ROUTE_LAUNCHES[kernels.ns_route(n, q.dtype)].items():
                    out[k] += c
    return out


def _tp_bytes(s) -> dict:
    """This rank's parameter bytes (its blocks) and optimizer state bytes
    by role (``state_memory_report`` per device)."""
    params = sum(_local_of(p).numel() * p.element_size() for p in s.model.parameters())
    return dict(params=params, **state_memory_report(s.opt, per_device=True))


def _local_of(p) -> torch.Tensor:
    return p.to_local() if hasattr(p, "to_local") else p


def _tp_blocks(s) -> dict:
    """Every parameter's block (float32, on the host) and where it sits."""
    return {n: (_local_of(p).detach().float().cpu().clone(), _tp_box(p))
            for n, p in s.model.named_parameters()}


def _tp_alone(s, dev) -> dict:
    """(a): the optimizer alone, TP_STEPS fit steps from ``_tp_grads``
    (each rank its blocks, as DTensor gradients); its readings."""
    from torch.distributed.tensor import DTensor
    from psgd_torch_tpu_torch.parallel import drift_check
    t0 = time.perf_counter()
    for i in range(TP_STEPS):
        grads = _tp_grads(i, s.model, dev)
        for n, p in s.model.named_parameters():
            p.grad = DTensor.from_local(_cut(grads[n], _tp_box(p)).contiguous(),
                                        p.device_mesh, p.placements, run_check=False)
        del grads
        s.opt.step()
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, fits=s.opt.fit_steps,
                kinds=_tp_kinds(s.opt), state=_tp_state(s.opt), blocks=_tp_blocks(s),
                drift=drift_check(_tp_alike(s.opt), group=s.mesh.get_group("tp")))


def _tp_job(rank: int, world: int, arg: str) -> dict:
    """The 4-rank runs of ``tp_trainer_path`` (``arg``: "base|fault"),
    under CUDA's deterministic algorithms: (a) the optimizer alone; (b)
    the trainer, checkpoint A after TP_AT steps, its readings; (c) A
    resumed on the 4 ranks, then gathered by rank 0."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    from psgd_torch_tpu_torch.parallel import drift_check
    from psgd_torch_tpu_torch.utils import gather_checkpoint
    base, fault = arg.split("|")
    dev = torch.device("cuda", 0)
    a = os.path.join(base, "a")
    undo = _plant_tp_fault(fault)
    out = {}
    try:
        with _deterministic(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = _tp_config(dev)
            make = tr.batch_fn(cfg, TRAINER_BATCH, dev)
            s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
            out["mesh"] = tr.mesh_sizes(s.mesh)
            out["alone"] = _tp_alone(s, dev)
            del s
            gc.collect()
            torch.cuda.empty_cache()
            s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
            out["per_fit"] = _tp_per_fit(s.opt)
            kernels.reset_launch_counts()
            counts = {}
            torch.cuda.reset_peak_memory_stats()
            losses, ms, fits = _trainer_steps(s, make, range(TP_AT), counts)
            t0 = time.perf_counter()
            save_checkpoint(a, TP_AT, s.model, s.opt)
            out["save_s"] = time.perf_counter() - t0
            out["bytes"] = _tp_bytes(s)
            out["at"] = _tp_blocks(s)
            more = _trainer_steps(s, make, range(TP_AT, TP_STEPS), counts)
            out.update(losses=losses + more[0], ms=ms + more[1], fits=fits + more[2],
                       counts=counts, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       unbroken=_trainer_digests(s), after=_tp_blocks(s),
                       drift=drift_check(_tp_alike(s.opt), group=s.mesh.get_group("tp")))
            with torch.no_grad():    # the first batch again, after the steps
                out["first_again"] = gpt2.loss_gpt2(s.model, *make(0)).item()
            del s
            gc.collect()
            torch.cuda.empty_cache()
            s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
            t0 = time.perf_counter()
            step, _ = restore_checkpoint(a, s.model, s.opt)
            out["restore_s"] = time.perf_counter() - t0
            _trainer_steps(s, make, range(step, TP_STEPS))
            out["same"] = dict(step=step, digests=_trainer_digests(s))
            del s
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
            if rank == 0:
                t0 = time.perf_counter()
                gather_checkpoint(a, device=dev)
                out["gather_s"] = time.perf_counter() - t0
                d = os.path.join(a, f"step_{TP_AT}")
                out["file_bytes"] = {f: os.path.getsize(os.path.join(d, f))
                                     for f in os.listdir(d)}
            dist.barrier()
    finally:
        undo()
    return out


def _tp_one_alone(cfg, dev, make) -> dict:
    """The 1-rank runs before the ranks' (this process, no process group):
    (a)'s optimizer alone from the same gradients, the first loss on (b)'s
    first batch."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
    out = {"init": {n: p.detach().float().cpu().clone()
                    for n, p in s.model.named_parameters()}}
    with torch.no_grad():
        out["first_loss"] = gpt2.loss_gpt2(s.model, *make(0)).item()
    params = dict(s.model.named_parameters())
    for i in range(TP_STEPS):
        for n, g in _tp_grads(i, s.model, dev).items():
            params[n].grad = g
        s.opt.step()
    out["alone"] = dict(fits=s.opt.fit_steps, state=_tp_state(s.opt),
                        params={n: p.detach().clone() for n, p in params.items()})
    out["bytes"] = _tp_bytes(s)
    return out


def _tp_one_resume(cfg, dev, make, a) -> dict:
    """(c) on 1 rank: the gathered checkpoint ``a`` restored, its last
    step; the parameters at the checkpoint and after it."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
    t0 = time.perf_counter()
    step, _ = restore_checkpoint(a, s.model, s.opt)
    out = {"restore_s": time.perf_counter() - t0,
           "at": {n: p.detach().float().cpu().clone() for n, p in s.model.named_parameters()}}
    res = _trainer_steps(s, make, range(step, TP_STEPS))
    out.update(step=step, losses=res[0], after={
        n: p.detach().float().cpu().clone() for n, p in s.model.named_parameters()})
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(os.path.dirname(a), "b"), TP_STEPS, s.model, s.opt)
    out["save_s"] = time.perf_counter() - t0
    return out


def _tp_cut_job(rank: int, world: int, base: str) -> dict:
    """The 1-rank checkpoint B (after the resumed step) cut for this rank:
    the restore's seconds and every parameter block."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    dev = torch.device("cuda", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = _tp_config(dev)
        s = tr.setup(cfg, TRAINER_SCHEDULE, dev)
        t0 = time.perf_counter()
        step, _ = restore_checkpoint(os.path.join(base, "b"), s.model, s.opt)
        return dict(step=step, cut_s=time.perf_counter() - t0, blocks=_tp_blocks(s))


def _tp_alone_check(one, ranks, check: bool) -> dict:
    """(a): every non-routed leaf's parameter block and Q (a resharded
    stack's its layers) the 1-rank run's bit for bit; the routed
    embeddings' updates within FACTOR_COS and FACTOR_REL; drift 0.0 over
    tp.  Returns the readings (the number of tensors held bit for bit and
    the routed leaves' worst gaps)."""
    same = bad = 0
    worst = (0.0, 0.0)
    for r, res in enumerate(ranks):
        got = res["alone"]
        if check and (got["fits"] != TP_STEPS or set(got["drift"].values()) != {0.0}):
            raise AssertionError(f"tp path (a): rank {r} fits {got['fits']}, drift "
                                 f"{got['drift']}")
        for n, (block, box) in got["blocks"].items():
            if got["kinds"][n] == "routed":
                u = block - _cut(one["init"][n], box)
                ref = _cut(one["alone"]["params"][n].float().cpu() - one["init"][n], box)
                cos_gap, rel = _agree(u, ref)
                worst = (max(worst[0], cos_gap), max(worst[1], rel))
                if check and not (1 - cos_gap > FACTOR_COS and rel < FACTOR_REL):
                    raise AssertionError(f"tp path (a): rank {r}'s {n} update 1 - cosine "
                                         f"{cos_gap:.3g}, relative error {rel:.3g}")
                continue
            pairs = [(block, _cut(one["alone"]["params"][n].float().cpu(), box))]
            qs, ls, cut = got["state"][n]
            rq, rl, _ = one["alone"]["state"][n]
            layers = slice(None) if cut is None else slice(*cut)
            pairs += [(f, g[layers] if g.ndim and cut is not None else g)
                      for f, g in zip(qs + ls, rq + rl)]
            for mine, theirs in pairs:
                if _same_bits(mine.cpu(), theirs.cpu()):
                    same += 1
                else:
                    bad += 1
                    if check:
                        raise AssertionError(f"tp path (a): rank {r}'s {n} differs from "
                                             "the 1-rank run's")
    return dict(same=same, bad=bad, routed=worst)


def _tp_resume_check(one, ranks, check: bool) -> dict:
    """(c): the gathered checkpoint restored on 1 rank holds every 4-rank
    block bit for bit; its step's update (each leaf, each rank's block)
    against the unbroken 4-rank step's, the worst 1 - cosine and relative
    error over the leaves within TP_COS and TP_REL."""
    worst, per = (0.0, 0.0), {}
    for r, res in enumerate(ranks):
        for n, (block, box) in res["at"].items():
            if check and not torch.equal(block, _cut(one["at"][n], box)):
                raise AssertionError(f"tp path (c): rank {r}'s {n} at the checkpoint "
                                     "differs from the gathered file's")
            u = res["after"][n][0] - block
            ref = _cut(one["after"][n] - one["at"][n], box)
            cos_gap, rel = _agree(u, ref)
            worst = (max(worst[0], cos_gap), max(worst[1], rel))
            p = per.get(n, (0.0, 0.0))
            per[n] = (max(p[0], cos_gap), max(p[1], rel))
    if check and not (worst[0] < TP_COS and worst[1] < TP_REL):
        raise AssertionError(f"tp path (c): the resumed step's worst 1 - cosine {worst[0]:.3g}, "
                             f"relative error {worst[1]:.3g} (limits {TP_COS}, {TP_REL}); "
                             f"per leaf {per}")
    for r, res in enumerate(ranks):
        cut = res["cut"]
        same = cut["step"] == TP_STEPS and all(
            torch.equal(block, _cut(one["after"][n], box))
            for n, (block, box) in cut["blocks"].items())
        if check and not same:
            raise AssertionError(f"tp path (c): rank {r}'s cut of the 1-rank checkpoint "
                                 "differs from the 1-rank run's blocks")
    return dict(worst=worst, per=per)


def _tp_run(dev, card: str, fault: str, check: bool) -> tuple:
    """The 1-rank runs and the 4-rank job with ``fault`` planted in the
    ranks; the readings of (a), (b) and (c), gated when ``check``."""
    from psgd_torch_tpu_torch.examples import train_gpt2_sharded as tr
    base = OUT_DIR / "tp_trainer"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    cfg = _tp_config(dev)
    make = tr.batch_fn(cfg, TRAINER_BATCH, dev)
    try:
        with _deterministic(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one = _tp_one_alone(cfg, dev, make)
        gc.collect()
        torch.cuda.empty_cache()
        ranks = _spawn(f"tp:{base}|{fault}", TP_WORLD)
        with _deterministic(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            one.update(_tp_one_resume(cfg, dev, make, str(base / "a")))
        gc.collect()
        torch.cuda.empty_cache()
        cuts = _spawn(f"tpcut:{base}", TP_WORLD)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    for r, cut in enumerate(cuts):
        ranks[r]["cut"] = cut
    first = ranks[0]["losses"][0]
    readings = dict(alone=_tp_alone_check(one, ranks, check),
                    loss_rel=abs(first - one["first_loss"]) / abs(one["first_loss"]),
                    resume=_tp_resume_check(one, ranks, check))
    return one, ranks, readings


def tp_trainer_path(dev, card: str) -> dict:
    """GPT-2 124M at full width, TP_LAYERS of its 12 layers, in JAX's
    production layout (ROADMAP A8c) through ``examples/train_gpt2_sharded``'s functions on
    TP_WORLD ranks of this card (gloo) as (dp 1, fsdp 2, tp 2), beside 1
    rank, under CUDA's deterministic algorithms.  (a) The optimizer alone
    from the same gradients: every non-routed leaf's parameter blocks and
    Q (a resharded stack's its 3 layers) the 1-rank run's bit for bit after
    TP_STEPS fit steps, the routed embeddings' updates within FACTOR_COS /
    FACTOR_REL, ``drift_check`` 0.0 over the tp replicas.  (b) The
    trainer, TP_STEPS steps at TRAINER_BATCH x 1024 bf16 with a checkpoint
    after TP_AT: its first loss within TP_LOSS_REL of the 1-rank model's
    on the same tokens, finite losses, the first batch's loss lower after
    the steps (each step takes another batch), each rank's launches of
    rows 1 and 2 per fit step the count its layout gives
    (``_tp_per_fit``), per-rank parameter bytes about a quarter of the
    1-rank run's and Q bytes about a half (replicated over tp), drift 0.0
    over tp; the step times, the save, the gather and the restores
    logged.  (c) Checkpoint A resumed on the 4 ranks bit for bit the
    unbroken run; gathered and resumed on 1 rank, every block at A bit for
    bit and the step's updates within TP_COS / TP_REL of the unbroken
    4-rank step (``tp_fault_margin`` reads the gaps against planted
    faults); that run's checkpoint B cut for the 4 ranks, every block bit
    for bit.  Returns the 4 ranks' launches."""
    t0 = time.perf_counter()
    one, ranks, readings = _tp_run(dev, card, "none", check=True)
    total = {}
    log(f"GPT-2 124M widths, {TP_LAYERS} of 12 layers, by the sharded trainer on mesh "
        f"{ranks[0]['mesh']} ({TP_LABEL}); "
        f"leaves {sorted(set(ranks[0]['alone']['kinds'].values()))}: "
        f"{ {k: list(ranks[0]['alone']['kinds'].values()).count(k) for k in set(ranks[0]['alone']['kinds'].values())} }")
    a = readings["alone"]
    log(f"  (a) the optimizer alone, {TP_STEPS} fit steps on {TP_WORLD} ranks "
        f"({[round(r['alone']['seconds'], 2) for r in ranks]} s): {a['same']} parameter "
        f"blocks, Q and L bit for bit the 1-rank run's; the routed embeddings' updates "
        f"worst 1 - cosine {a['routed'][0]!r}, relative error {a['routed'][1]!r}; drift "
        f"0.0 over tp on {len(ranks[0]['alone']['drift'])} Q and L")
    losses1 = one["losses"]
    for r, res in enumerate(ranks):
        # each step takes another batch, whose loss the first updates
        # raise at this operating point, as on 1 rank (the sharded trainer's
        # 2- and 1-rank runs read 10.9678, 10.9893, 10.9849 on an H100 80GB
        # HBM3 at 700 W): the loss that falls is the first batch's, read
        # again after the steps
        if not all(math.isfinite(x) for x in res["losses"]) or \
                res["fits"] != [1] * TP_STEPS or not res["first_again"] < res["losses"][0]:
            raise AssertionError(f"tp path (b): rank {r} losses {res['losses']}, on the "
                                 f"first batch after them {res['first_again']}, fits "
                                 f"{res['fits']}")
        want = {k: n * TP_STEPS for k, n in res["per_fit"].items()}
        got = {k: res["counts"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"tp path (b): rank {r} launched {got} in {TP_STEPS} fit "
                                 f"steps, its layout gives {want}")
        if set(res["drift"].values()) != {0.0}:
            raise AssertionError(f"tp path (b): rank {r} drift {res['drift']}")
        share = {k: res["bytes"][k] / one["bytes"][k] for k in ("params", "momentum", "q")}
        if not (0.24 < share["params"] < 0.27 and 0.24 < share["momentum"] < 0.27
                and 0.45 < share["q"] < 0.6):
            raise AssertionError(f"tp path (b): rank {r} holds {res['bytes']} bytes, the "
                                 f"1-rank run {one['bytes']}")
        if res["same"]["step"] != TP_AT or res["same"]["digests"] != res["unbroken"]:
            raise AssertionError(f"tp path (c): rank {r}'s 4-rank resume differs from the "
                                 "unbroken run")
        _add(total, res["counts"])
        log(f"  (b) rank {r}: losses {[round(x, 4) for x in res['losses']]}, the first "
            f"batch's after them {res['first_again']:.4f}; launches per "
            f"fit step {res['per_fit']} (the layout's); parameters "
            f"{res['bytes']['params'] / 1e6:.1f} MB ({share['params']:.3f} of 1 rank's), "
            f"momentum {res['bytes']['momentum'] / 1e6:.1f} MB ({share['momentum']:.3f}), "
            f"Q {res['bytes']['q'] / 1e6:.1f} MB ({share['q']:.3f}, replicated over tp), "
            f"state {res['bytes']['total'] / 1e6:.1f} MB "
            f"({res['bytes']['total'] / one['bytes']['total']:.3f}); peak {res['peak_gb']:.2f} GB; "
            f"drift 0.0 over tp on {len(res['drift'])} Q and L")
        log(f"  [{card}; {TP_LABEL}] rank {r}: train step (forward, backward, optimizer; fit) "
            f"ms {[round(x, 2) for x in res['ms']]}, median after the first "
            f"{_median(res['ms'][1:])}")
    if readings["loss_rel"] > TP_LOSS_REL:
        raise AssertionError(f"tp path (b): first loss {ranks[0]['losses'][0]!r}, 1 rank "
                             f"{one['first_loss']!r}: relative {readings['loss_rel']:.3g}")
    if not all(math.isfinite(x) for x in losses1):
        raise AssertionError(f"tp path (c): the 1-rank resume's losses {losses1}")
    res = readings["resume"]
    log(f"  (b) first loss {ranks[0]['losses'][0]!r} against the 1-rank model's "
        f"{one['first_loss']!r}: relative {readings['loss_rel']!r} (limit {TP_LOSS_REL})")
    log(f"  (c) checkpoint A resumed on {TP_WORLD} ranks bit for bit the unbroken run; "
        f"gathered and resumed on 1 rank: every block at A bit for bit, its step's "
        f"updates worst 1 - cosine {res['worst'][0]!r}, relative error {res['worst'][1]!r} "
        f"(limits {TP_COS}, {TP_REL}); per leaf {res['per']}")
    files = ranks[0]["file_bytes"]
    log(f"  [{card}] checkpoint A ({TP_WORLD} ranks, step {TP_AT}): "
        f"{', '.join(f'{k} {v / 1e9:.3f} GB' for k, v in sorted(files.items()))}; save "
        f"{[round(r['save_s'], 2) for r in ranks]} s per rank; gather (rank 0, on the card) "
        f"{ranks[0]['gather_s']:.2f} s; {TP_WORLD}-rank restore "
        f"{[round(r['restore_s'], 2) for r in ranks]} s; 1-rank restore of the gathered "
        f"file {one['restore_s']:.2f} s; the 1-rank checkpoint B (step {TP_STEPS}) saved in "
        f"{one['save_s']:.2f} s, cut for {TP_WORLD} ranks in "
        f"{[round(r['cut']['cut_s'], 2) for r in ranks]} s, every block bit for bit")
    log(f"  [{card}] tp trainer path {time.perf_counter() - t0:.1f} s; its launches "
        f"({TP_WORLD} ranks summed) {{{', '.join(f'{k}: {v}' for k, v in total.items() if v)}}}")
    return total


def tp_fault_margin(dev, card: str) -> dict:
    """``tp_trainer_path``'s runs sound and with each planted fault of
    TP_FAULTS in the 4 ranks, ungated: each run's first-loss gap, (a)'s
    tensors held bit for bit and not, and (c)'s worst update gaps, for
    the path's limits (a run that raises, as the gather does on drifted
    replicas, is logged as such).  Run alone: ``python3
    tools/smoke_paths.py tp_fault_margin``."""
    result = {}
    for fault in TP_FAULTS:
        try:
            _, ranks, readings = _tp_run(dev, card, fault, check=False)
        except Exception as e:        # a refusal is a reading here
            result[fault] = dict(raised=f"{type(e).__name__}: {str(e)[-600:]}")
            log(f"[{card}] fault {fault}: the run raised {result[fault]['raised']}")
            continue
        result[fault] = dict(loss_rel=readings["loss_rel"], alone=readings["alone"],
                             resume=readings["resume"]["worst"],
                             per_leaf=readings["resume"]["per"],
                             losses=ranks[0]["losses"],
                             drift=max(max(r["drift"].values()) for r in ranks),
                             ms=ranks[0]["ms"])
        log(f"[{card}] fault {fault}: first loss gap {readings['loss_rel']!r}; (a) "
            f"{readings['alone']}; (c) worst 1 - cosine, relative error "
            f"{readings['resume']['worst']}; per leaf {readings['resume']['per']}; "
            f"losses {ranks[0]['losses']}; drift over tp {result[fault]['drift']!r}; "
            f"rank 0 step ms {ranks[0]['ms']}")
    close_ranks()
    log(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "per_leaf"}
                    for k, v in result.items()}))
    return {}


# the tensor-parallel LLaMA path (ROADMAP A8c): LLaMA-1.1B at its full
# widths (n_embd 2048, 32 query and 4 kv heads, SwiGLU 5632, vocab 32000,
# untied lm_head) in JAX's production layout, on TP_WORLD ranks of cuda:0
# over gloo as make_mesh(4)'s (dp 1, fsdp 2, tp 2): the blocks (None, fsdp,
# tp) by llama.shard_model (tp forward, the fsdp blocks gathered in it),
# stack_sharding over fsdp (each rank's layer resharded by bytes, Q
# replicated over tp), wte and lm_head factor-sharded (the recipe's);
# tools/bench_llama.py:108-114's optimizer with every step a fit step;
# 1 x 1024 tokens, bf16 compute, f32 parameters.  The one cut: depth 22 ->
# LLAMA_TP_LAYERS (each fsdp rank's stacks one layer)
LLAMA_TP_LAYERS = 2
# (b): the first step's gradient blocks on the ranks against the 1-rank
# model's on the same batch, each leaf within 1 - cosine LLAMA_TP_GRAD_COS
# and relative error LLAMA_TP_GRAD_REL (bf16: the tp partial sums round to
# bf16 before their float32 sum), where the first loss alone may not see a
# fault in one rank's hidden block
LLAMA_TP_GRAD_COS = 1e-3
LLAMA_TP_GRAD_REL = 5e-2
# the per-rank shape the path adds to the kernel phase: wqkv's 2560 factor
# at each rank's one layer, the tiled route (rows 5-9)
LLAMA_TP_TILED = (1, 2560, torch.bfloat16)


def _llama_tp_setup(dev, mesh=None):
    """The path's model and optimizer on this rank (``mesh`` None: the
    unsharded model on one rank); (model, opt, mesh) as attributes."""
    from types import SimpleNamespace
    from psgd_torch_tpu_torch.parallel import llama_partition_specs, sharding_recipe
    cfg = llama.llama_1b(compute_dtype=torch.bfloat16, n_layer=LLAMA_TP_LAYERS)
    model = llama.Llama(cfg, device=dev, seed=0)
    mask = llama.scanned_layers_mask(model)
    sharding = {}
    if mesh is not None:
        rec = sharding_recipe(mesh, llama_partition_specs(mesh, model),
                              model.named_parameters(), scanned_layers=mask,
                              stack_axis="fsdp")
        llama.shard_model(model, mesh, rec.model_placements())
        sharding = rec.transform_kwargs
    return SimpleNamespace(model=model, opt=_bench_opt(model, mask, TP_STEPS, dev,
                                                       **sharding), mesh=mesh)


def _llama_tp_batch(dev) -> tuple:
    """(b)'s batch, every step's: 1 x 1024 tokens of the synthetic stream."""
    return llama.synthetic_lm_batch(torch.Generator().manual_seed(1), 1, 1024,
                                    32000, device=dev)


def _llama_tp_job(rank: int, world: int, _) -> dict:
    """The 4-rank runs of ``llama_tp_path``, under CUDA's deterministic
    algorithms: (a) the optimizer alone; (b) TP_STEPS train steps on one
    batch, their readings and the first step's gradient blocks."""
    from psgd_torch_tpu_torch.parallel import drift_check, make_mesh
    dev = torch.device("cuda", 0)
    out = {}
    with _deterministic(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = make_mesh(device_type="cuda")
        out["mesh"] = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
        s = _llama_tp_setup(dev, mesh)
        out["alone"] = _tp_alone(s, dev)
        del s
        gc.collect()
        torch.cuda.empty_cache()
        s = _llama_tp_setup(dev, mesh)
        out["per_fit"] = _tp_per_fit(s.opt)
        batch = _llama_tp_batch(dev)
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, fits = [], [], []
        for i in range(TP_STEPS):
            fits0 = s.opt.fit_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.opt.zero_grad(set_to_none=True)
            loss = llama.loss_llama(s.model, *batch)
            loss.backward()
            if i == 0:
                out["grads"] = {n: (_local_of(p.grad).float().cpu(), _tp_box(p))
                                for n, p in s.model.named_parameters()}
            s.opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            fits.append(s.opt.fit_steps - fits0)
        out.update(losses=losses, ms=ms, fits=fits, counts=_all_counts(),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, bytes=_tp_bytes(s),
                   drift=drift_check(_tp_alike(s.opt), group=mesh.get_group("tp")))
        with torch.no_grad():    # the batch again, after the steps
            out["first_again"] = llama.loss_llama(s.model, *batch).item()
    return out


def _llama_tp_one(dev) -> dict:
    """The 1-rank runs (this process, no process group): the first loss on
    (b)'s batch and its gradients, (a)'s optimizer alone from the same
    gradients as the ranks'."""
    with _deterministic(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = _llama_tp_setup(dev)
        out = {"init": {n: p.detach().float().cpu().clone()
                        for n, p in s.model.named_parameters()}}
        loss = llama.loss_llama(s.model, *_llama_tp_batch(dev))
        loss.backward()
        out["first_loss"] = loss.item()
        params = dict(s.model.named_parameters())
        out["grads"] = {n: p.grad.float().cpu() for n, p in params.items()}
        for i in range(TP_STEPS):
            for n, g in _tp_grads(i, s.model, dev).items():
                params[n].grad = g
            s.opt.step()
        out["alone"] = dict(fits=s.opt.fit_steps, state=_tp_state(s.opt),
                            params={n: p.detach().clone() for n, p in params.items()})
        out["bytes"] = _tp_bytes(s)
    return out


def _llama_tp_run(dev, job: str = "llamatp") -> tuple:
    """The 1-rank runs, then ``job`` on the TP_WORLD ranks; (1 rank's
    readings, the ranks', and (a)'s readings, the first-loss gap and the
    first step's gradient gaps per leaf (worst over the ranks))."""
    one = _llama_tp_one(dev)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _spawn(job, TP_WORLD)
    first = ranks[0]["losses"][0]
    grads = {}
    for res in ranks:
        for n, (block, box) in res.pop("grads").items():
            gaps = _agree(block, _cut(one["grads"][n], box))
            grads[n] = tuple(max(x) for x in zip(grads.get(n, (0.0, 0.0)), gaps))
    return one, ranks, dict(alone=_tp_alone_check(one, ranks, check=False),
                            loss_rel=abs(first - one["first_loss"]) / abs(one["first_loss"]),
                            grads=grads)


def llama_tp_path(dev, card: str) -> dict:
    """LLaMA-1.1B at its full widths, depth cut to LLAMA_TP_LAYERS, in JAX's
    production layout (ROADMAP A8c): ``llama.shard_model`` over
    ``llama_partition_specs`` and ``stack_sharding`` over fsdp on
    TP_WORLD ranks of this card (gloo) as (dp 1, fsdp 2, tp 2), beside 1
    rank, under CUDA's deterministic algorithms.  (a) The optimizer alone
    from the same gradients: every non-routed leaf's parameter blocks and
    Q (a resharded stack's its layer) the 1-rank run's bit for bit after
    TP_STEPS fit steps, the routed wte and lm_head's updates within
    FACTOR_COS / FACTOR_REL, ``drift_check`` 0.0 over tp.  (b) TP_STEPS
    train steps, each a fit step, on one 1 x 1024 batch in bf16: the first
    loss within TP_LOSS_REL of the 1-rank model's and the first step's
    gradient blocks within LLAMA_TP_GRAD_COS / LLAMA_TP_GRAD_REL of its
    gradients, each leaf, on the same batch; finite losses, the
    batch's loss lower after the steps, each rank's launches of rows 1-9
    per fit step exactly the count its layout gives (``_tp_per_fit``),
    per-rank parameter and momentum bytes about a quarter of the 1-rank
    run's and Q bytes about a half, drift 0.0 over tp; the step times
    logged.  Returns the ranks' launches, summed."""
    t0 = time.perf_counter()
    one, ranks, readings = _llama_tp_run(dev)
    a = readings["alone"]
    kinds = ranks[0]["alone"]["kinds"]
    log(f"LLaMA-1.1B widths, {LLAMA_TP_LAYERS} of 22 layers, on mesh {ranks[0]['mesh']} "
        f"({TP_LABEL}); leaves { {k: list(kinds.values()).count(k) for k in sorted(set(kinds.values()))} }")
    for r, res in enumerate(ranks):
        got = res["alone"]
        if got["fits"] != TP_STEPS or set(got["drift"].values()) != {0.0}:
            raise AssertionError(f"LLaMA tp path (a): rank {r} fits {got['fits']}, drift "
                                 f"{got['drift']}")
    if a["bad"] or not (1 - a["routed"][0] > FACTOR_COS and a["routed"][1] < FACTOR_REL):
        raise AssertionError(f"LLaMA tp path (a): {a['bad']} tensors differ from the 1-rank "
                             f"run's; the routed updates' worst 1 - cosine {a['routed'][0]!r}, "
                             f"relative error {a['routed'][1]!r}")
    log(f"  (a) the optimizer alone, {TP_STEPS} fit steps on {TP_WORLD} ranks "
        f"({[round(r['alone']['seconds'], 2) for r in ranks]} s): {a['same']} parameter "
        f"blocks, Q and L bit for bit the 1-rank run's; wte's and lm_head's updates worst "
        f"1 - cosine {a['routed'][0]!r}, relative error {a['routed'][1]!r}; drift 0.0 over "
        f"tp on {len(ranks[0]['alone']['drift'])} Q and L")
    total = {}
    for r, res in enumerate(ranks):
        if not all(math.isfinite(x) for x in res["losses"]) or \
                res["fits"] != [1] * TP_STEPS or not res["first_again"] < res["losses"][0]:
            raise AssertionError(f"LLaMA tp path (b): rank {r} losses {res['losses']}, on the "
                                 f"batch after them {res['first_again']}, fits {res['fits']}")
        want = {k: n * TP_STEPS for k, n in res["per_fit"].items()}
        got = {k: res["counts"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"LLaMA tp path (b): rank {r} launched {got} in {TP_STEPS} "
                                 f"fit steps, its layout gives {want}")
        if set(res["drift"].values()) != {0.0}:
            raise AssertionError(f"LLaMA tp path (b): rank {r} drift {res['drift']}")
        share = {k: res["bytes"][k] / one["bytes"][k] for k in ("params", "momentum", "q")}
        if not (0.24 < share["params"] < 0.27 and 0.24 < share["momentum"] < 0.27
                and 0.45 < share["q"] < 0.6):
            raise AssertionError(f"LLaMA tp path (b): rank {r} holds {res['bytes']} bytes, "
                                 f"the 1-rank run {one['bytes']}")
        _add(total, res["counts"])
        log(f"  (b) rank {r}: losses {[round(x, 4) for x in res['losses']]}, the batch's after "
            f"them {res['first_again']:.4f}; launches per fit step "
            f"{ {k: v for k, v in res['per_fit'].items() if v} } (the layout's); parameters "
            f"{res['bytes']['params'] / 1e6:.1f} MB ({share['params']:.3f} of 1 rank's), "
            f"momentum {res['bytes']['momentum'] / 1e6:.1f} MB ({share['momentum']:.3f}), "
            f"Q {res['bytes']['q'] / 1e6:.1f} MB ({share['q']:.3f}); peak "
            f"{res['peak_gb']:.2f} GB; drift 0.0 over tp on {len(res['drift'])} Q and L")
        log(f"  [{card}; {TP_LABEL}] rank {r}: train step (forward, backward, optimizer; "
            f"fit) ms {[round(x, 2) for x in res['ms']]}, median after the first "
            f"{_median(res['ms'][1:])}")
    if readings["loss_rel"] > TP_LOSS_REL:
        raise AssertionError(f"LLaMA tp path (b): first loss {ranks[0]['losses'][0]!r}, 1 rank "
                             f"{one['first_loss']!r}: relative {readings['loss_rel']:.3g}")
    worst = tuple(max(x) for x in zip(*readings["grads"].values()))
    if not (worst[0] < LLAMA_TP_GRAD_COS and worst[1] < LLAMA_TP_GRAD_REL):
        raise AssertionError(f"LLaMA tp path (b): the first step's gradients against the "
                             f"1-rank model's, per leaf (1 - cosine, relative error) "
                             f"{readings['grads']}")
    log(f"  (b) first loss {ranks[0]['losses'][0]!r} against the 1-rank model's "
        f"{one['first_loss']!r}: relative {readings['loss_rel']!r} (limit {TP_LOSS_REL}); "
        f"the first step's gradients worst 1 - cosine {worst[0]!r}, relative error "
        f"{worst[1]!r} (limits {LLAMA_TP_GRAD_COS}, {LLAMA_TP_GRAD_REL}); per leaf "
        f"{readings['grads']}")
    log(f"  [{card}] LLaMA tp path {time.perf_counter() - t0:.1f} s; its launches "
        f"({TP_WORLD} ranks summed) {{{', '.join(f'{k}: {v}' for k, v in total.items() if v)}}}")
    return total


_DIST_JOBS = {"stack": _stack_job, "pair": _pair_job, "factor": _factor_job,
              "vector": _vector_job, "trainer": _trainer_job, "tp": _tp_job,
              "tpcut": _tp_cut_job, "llamatp": _llama_tp_job}


def log_apply_launches(profiles, card: str) -> None:
    """The cuBLAS launches (and ms) of a profiled fit and no-fit step of
    arm A against the plain GPT-2 path's: what the shared fit skips (the
    apply chain) and what the cache skips (Q^T after Q)."""
    cat = _category("nvjet")
    for prob, what in ((1.0, "fit"), (0.0, "no-fit")):
        (plain_us, plain_n), (arm_us, arm_n) = (
            profiles[tag][prob].get(cat, (0.0, 0))
            for tag in ("GPT-2 124M", "GPT-2 124M options arm A"))
        log(f"  [{card}] {what} step, {cat}: plain path {plain_n} launches "
            f"{plain_us / 1e3:.2f} ms, arm A {arm_n} launches {arm_us / 1e3:.2f} ms")


def attach_sweep(rows: dict, sweep: list) -> None:
    """The sweep's records in the kernels' rows: a single-route width under
    row 1 (``ns_widths``), its kernel's time; a split or tiled width under
    each kernel of its route (``ns_widths_route``), the whole route's time
    (``route_ms`` and the rest)."""
    route_rows = {"single": (kernels.fused_ns_update,), "split": kernels.SPLIT_KERNELS,
                  "tiled": kernels.TILED_KERNELS}
    for rec in sweep:
        single = rec["route"] == "single"
        entry = {("" if single or k in ("n", "b", "dtype", "route") else "route_") + k:
                 rec[k] for k in ("n", "b", "dtype", "route", "ms", "tflops", "bound_ms",
                                  "bound_by", "plain_ms", "q_rel_err", "bound_over_true")}
        for f in route_rows[rec["route"]]:
            rows[f.__name__].setdefault("ns_widths" if single else "ns_widths_route",
                                        []).append(entry)


def main() -> int:
    name, smi = preflight()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full float32 products in every plain version and in the model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("build")
    lib_path, tc_lines = build()
    phase("kernels against their plain versions")
    rows = {"damped_noise": check_noise(dev, lib_path)}
    rows["fused_ns_update"], ns_shapes = check_ns(dev, tc_lines)
    rows["fused_ns_update"]["a10a_shapes"] = ns_shapes
    rows["fused_ns_update"]["a10b_shapes"] = check_ns(
        dev, checks=NS_CHECKS_A10B, line_shapes=NS_CHECKS_A10B)[1]
    rows["damped_noise"].update(check_noise_complex(dev, lib_path))
    check_transpose_sub(dev)
    check_routes(dev)
    step_mat_rows = check_step_mat(dev)
    rows.update(check_split(dev, 22, 2048, torch.bfloat16, timed=True,
                            tc_lines=tc_lines))
    check_split(dev, 2, 1536, torch.float32, timed=False)
    rows.update(check_tiled(dev, 22, 2560, torch.bfloat16, timed=True,
                            tc_lines=tc_lines))
    check_tiled(dev, 2, 2048, torch.float32, timed=False)
    # the batch of LLaMA's stacks on each of 2 stack-sharded ranks, and of
    # its factor-sharded vocab leaves' 2048 factor
    check_split(dev, 11, 2048, torch.bfloat16, timed=False)
    check_split(dev, 1, 2048, torch.bfloat16, timed=False, branches=False)
    check_tiled(dev, 11, 2560, torch.bfloat16, timed=False)
    for n in SHARED_TILED_WIDTHS:   # timed and logged; the rows stay LLaMA's
        check_tiled(dev, 1, n, torch.bfloat16, timed=True)
    # each tp rank's wqkv factor (the LLaMA tp path's layer), timed
    for k, row in check_tiled(dev, *LLAMA_TP_TILED, timed=True).items():
        rows[k]["a8c_llama_tp_shapes"] = [dict(shape=f"{LLAMA_TP_TILED[:2]} bfloat16", **row)]
    rows["norm_bound"]["geometry_shapes"] = check_norm_bound_shapes(dev)
    rows["norm_bound"]["a10a_shapes"] = check_norm_bound_shapes(dev, A10A_BOUND_SHAPES)
    rows["norm_bound"]["ns_widths_shapes"] = check_norm_bound_shapes(
        dev, NS_WIDTHS_BOUND_SHAPES)
    # the tiled route's pieces at the sweep's new widths: bf16 timed, f32 held
    for k, row in check_tiled(dev, *NS_WIDTHS_BOUND_SHAPES[0], timed=True).items():
        rows[k].setdefault("ns_widths_shapes", []).append(
            dict(shape=f"{(2, 4096, 4096)} bfloat16", **row))
    check_tiled(dev, *NS_WIDTHS_BOUND_SHAPES[1], timed=False)
    check_procrustes_loop(dev)
    for k, entries in check_lra_dense_shapes(dev, lib_path).items():
        rows[k]["lra_dense_shapes"] = entries
    rows["damped_noise"]["vector_shapes"] = check_vector_noise(dev, lib_path)
    rows["damped_noise"]["a3b_complex_shapes"] = check_noise_complex_shapes(dev, lib_path)
    rows["damped_noise"]["a3c_complex_shapes"] = check_vector_noise_complex(dev, lib_path)
    torch.cuda.empty_cache()
    phase("small path")
    check_small_path(dev)
    check_complex_small(dev)
    launches = {}
    # (phase, drive, profiled probabilities, tensor-core gate, profile label)
    paths = (("GPT-2 124M path", lambda: gpt2_path(dev, smi), (1.0, 0.0), True,
              "GPT-2 124M"),
             ("GPT-2 124M options path", lambda: options_path(dev, smi), (1.0, 0.0),
              True, "GPT-2 124M options arm A"),
             ("LLaMA-1.1B path", lambda: llama_path(dev, smi), (1.0,), True,
              "LLaMA-1.1B"),
             ("GPT-2 774M path", lambda: gpt2_774m_path(dev, smi), (1.0,), True,
              "GPT-2 774M"),
             ("ViT path", lambda: (vit_path(dev, smi), None), (), False, None),
             ("GPT-2 124M Newton path", lambda: newton_path("gpt2", dev, smi),
              (1.0, 0.0), False, "GPT-2 124M Newton"),
             ("LLaMA-1.1B Newton path", lambda: newton_path("llama", dev, smi),
              (1.0,), True, "LLaMA-1.1B Newton"),
             # each arm profiles its own fit step
             ("GPT-2 124M geometries path",
              lambda: (geometry_path(dev, smi, newton=False), None), (), True, None),
             ("GPT-2 124M Newton geometries path",
              lambda: (geometry_path(dev, smi, newton=True), None), (), True, None),
             # each arm profiles its own steps
             ("GPT-2 124M LRA path", lambda: (lra_gpt2_path(dev, smi), None), (),
              False, None),
             ("Tensor-rank decomposition path", lambda: (cp_path(dev, smi), None), (),
              False, None),
             ("Rosenbrock path", lambda: (rosenbrock_path(dev, smi), None), (), False,
              None),
             ("Examples path", lambda: (examples_path(dev, smi), None), (), False, None),
             ("NS-width sweep path",
              lambda: (ns_widths_path(dev, smi, sweep), None), (), False, None),
             # its complex128 runs go on in their own processes beside the
             # next two paths
             ("Complex fixed-point path",
              lambda: (complex_fixed_point_path(dev, smi, fp_small), None), (), False,
              None),
             ("Complex optimizer path",
              lambda: (complex_optimizer_path(dev, smi), None), (), False, None),
             # GPT-2 124M's resumed run profiles its own fit step
             ("Resumable training path", lambda: (resume_path(dev, smi), None), (),
              False, None),
             ("Complex LRA, dense and legacy path",
              lambda: (complex_lra_dense_path(dev, smi), None), (), False, None),
             ("Complex fixed-point path: the JAX test's sizes",
              lambda: (fp_small_results(smi, fp_small.pop()), None), (), False, None),
             ("Legacy families path", lambda: (legacy_path(dev, smi), None), (), False,
              None),
             # rank processes on this card: their counts come back to the
             # parent; the paths of one world size in a row share them
             ("Stack-sharded path", lambda: (stack_sharded_path(dev, smi), None), (),
              False, None),
             ("Data-parallel drift and per-shard paths",
              lambda: (pair_paths(dev, smi), None), (), False, None),
             ("Sharded trainer path",
              lambda: (sharded_trainer_path(dev, smi), None), (), False, None),
             ("Factor-sharded path",
              lambda: (factor_sharded_path(dev, smi), None), (), False, None),
             ("Vector-sharded path",
              lambda: (vector_sharded_path(dev, smi), None), (), False, None),
             ("Tensor-parallel trainer path",
              lambda: (tp_trainer_path(dev, smi), None), (), False, None),
             ("Tensor-parallel LLaMA path",
              lambda: (llama_tp_path(dev, smi), None), (), False, None))
    profiles, fp_small, sweep = {}, [], []
    try:
        for label, drive, probs, tensor_cores, tag in paths:
            phase(label)
            counted, state = drive()
            for k, v in counted.items():
                launches[k] = launches.get(k, 0) + v
            if state is not None:
                profiles[tag] = profile_steps(tag, state, smi, probs, tensor_cores)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            if tag == "GPT-2 124M options arm A":
                log_apply_launches(profiles, smi)
    finally:
        close_ranks()
        for _, pool, _, _ in fp_small:
            pool.terminate()
            pool.join()
    phase("done")
    attach_sweep(rows, sweep)
    out = [dict(name=k, route="cuda", source=SRC + src, replaces=f"{TPU}{line}",
                launches=launches.get(k, 0), **rows[k]) for k, src, line in ROWS]
    for row in out:
        if row["name"] in STEP_MAT_ROWS:
            row["step_mat_launches"] = launches[f"{row['name']}.step_mat"]
            row.update(step_mat_rows[row["name"]])
        if row["name"] == "damped_noise":
            row["complex_launches"] = launches.get("damped_noise.complex", 0)
            row["complex_unit_launches"] = launches.get("unit_noise.complex", 0)
        if row["launches"] == 0 or row.get("step_mat_launches", 1) == 0 or \
                row.get("complex_launches", 1) == 0:
            raise AssertionError(f"{row['name']} was launched on no path "
                                 "(or never with the step matrix, or the complex mode)")
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
