#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--only nccl|lm|train|shard]

Run from the root of a checkout; needs a CUDA card and ``nvcc``, and
exits non-zero otherwise.  Every phase prints one JSON line (each with
``at_s``, its seconds since the script started); any failed check
raises, so the exit code is not 0.  With no arguments every phase
runs and one card suffices; ``--only nccl`` runs phases 1, 2, the matrix
and 6m, then the kernels of 6m's path (at its shapes, against their plain
versions) and the last lines, for a run on several cards; ``--only lm``
(``--only train``) runs phases 1 and 6n (6o), then the ``nvidia-smi``
line and the last line; ``--only shard`` runs phase 1 and phase 6p's
full-width path on four cards (sharded training, serving and the
dry-run's four-card cells), then the same two lines.

1. device   the card's name and power limit (``nvidia-smi``) and the
            rates the bounds use (3.35 TB/s and 67 TFLOP/s f32 for H100
            SXM, 2.0 TB/s and 51.2 TFLOP/s for PCIe);
2. build    ``nvcc`` builds ``src/repro_torch/kernels/csrc/spmv.cu`` for
            ``sm_90a`` (with ``-Xptxas -v``);
3. kernels  each kernel against its plain PyTorch version on the card, at
            the full-size plans' shapes (B1/B2 on the 4x2 plans, B3/B4 on
            the halo-free 1x8 plans), f32 and bf16 storage; median times of
            20 runs (CUDA events) of kernel and plain version, and the
            bound of each: the larger of its bytes over the memory rate
            and its flops over the f32 rate.  The ELL kernel reads only
            each row's real entries (its row lengths), so its bytes are
            the real entries' values and columns, the lengths, x and y,
            and its flops two per real entry; ``bound_stored_ms`` beside
            it counts every stored slot, padding included.  SELL counts
            its stored entries (about nnz) and slice descriptors.  Then
            (``kernel_onto``) the split two-phase SpMV of the overlapped
            schedule on the 4x2 plans, single-column and at k = 4, f32
            and bf16: the diag pass (B3's / B4's launch on the diag
            stream) then the offd pass onto its ``y`` (``ONTO``), bit for
            bit the fused kernel (B1, B2, batched B1, B2) and within
            2e-5·max|y| of the plain version; the offd pass's ms (in
            place), the plain onto's, the diag pass's, both together and
            the fused kernel's; its bound (the offd stream, the ghosts and
            ``y`` read and written) and the library's ``addmv`` /
            ``addmm`` of the offd blocks onto the partial;
3b. balanced the single-device kernel path on the full-size matrix of
            phase 5: ``BalancedCOO`` (``partition_balanced`` and
            ``partition_equal_rows`` bounds, 16, 64 and 8 x SM-count bins)
            -> ``balanced_spmv`` (B5), and the global ``ELLMatrix`` -> flat
            ``ell_spmv`` with its ``row_lens`` (B3's kernel as one shard;
            its bound counts real entries, as in phase 3), each against the
            host float64 CSR matvec (rel <= 1e-5).  Launch counts are
            zeroed just before this path and read just after it.  Then each
            kernel against its plain version (2e-5·max|y|), two launches
            bit for bit equal, and timed, f32 and bf16 storage, with its
            padding, imbalance and bound.  B5 reads the real entries'
            values and columns, the row lengths and the warp map (and x,
            y); ``bound_coo_ms`` beside it counts the binned COO's value,
            column and bin-local row per entry, the bin lengths and the row
            map, as the TPU kernel's layout does.  Each B5 line also has its
            launched warps and the host seconds of its warp map;
4. golden   CG (jacobi, tol 1e-6, maxiter 400) on the golden matrix at 4x2,
            ell and sell: iterations within ±1 of the fixture's
            (``tests/golden_square_hashes.json``);
5. full     the main path at full size: ``graded_extruded_mesh_matrix(
            20_000, 64)`` (1.28M rows, 28.7M nnz) -> ``build_spmv_plan``
            (4x2 and 1x8, ell and sell, a2a) -> ``to_dist`` -> SpMV
            (against a host float64 CSR matvec, rel <= 1e-5) -> fused CG
            (``make_solver``, jacobi, tol 1e-6, maxiter 10,000; true
            relative residual < 1e-4) -> ``from_dist``; the unfused
            ``make_cg`` too on the 4x2 plans.  ``ms_per_iter`` divides by
            the iterations run: whole blocks of ``CHECK_EVERY``, so the
            gated no-op tail after convergence counts.  Launch counts are
            zeroed just before this phase and read just after it: every
            kernel must have launched;
6. profile  ``torch.profiler`` device time by kernel over 64 fused-CG
            iterations on the 4x2 plans, against phase 5's unprofiled
            ms/iteration (the device's busy share);
6b. transports  the halo-exchange layer on the full-size 4x2 ell and sell
            plans (B1, B2): every registered transport x wire dtype (f32,
            bf16, int8).  The ``make_exchange`` ghost buffer must be bit
            for bit ``a2a``'s at the same wire dtype at every real slot,
            and its ``host_exchange``'s; lossy ghosts within
            ``rel_bound·max|x|`` of the f32 ghosts; ``make_spmv`` bit for
            bit ``a2a``'s.  With f32 wire, the fused CG (jacobi, tol 1e-6)
            gives ``a2a``'s iterations and ``x`` bit for bit.  Each line
            has the SpMV's median ms (20 CUDA-event runs), the CG's
            ms/iteration where run, the census's predicted wire bytes and
            collective counts (as if each node were its own device: one
            card has no wire) and the device launches per SpMV
            (``torch.profiler``).  ``faulty`` (registered, then
            unregistered) must fail the ghost and SpMV checks.
            ``autotune_transport`` on each plan: its winner, min and
            median times, and ``make_spmv(transport="auto")`` giving the
            winner's output.  Launch counts are zeroed just before and
            read just after;
6c. refine   ``make_refine`` (cg + jacobi, inner tol 1e-4, tol 1e-7 against
            the host f64 matvec; at most 2,000 inner iterations and 20
            cycles) for each wire dtype on the full-size sell 4x2 plan:
            cycles, inner iterations, the true residual and its history,
            seconds.  f32 wire must converge; bf16/int8 at full
            size are reported.  Then at ``refine_check``'s size (graded
            80x6, 4x2, ell, its inner tolerances) every wire dtype must
            reach 1e-7 and the f64 CG oracle.  Launch counts as in 6b;
6d. solvers  the registry solvers ``cg``, ``pipelined_cg`` and ``chebyshev``
            (jacobi, a2a, f32) on the full-size ell and sell 4x2 plans at
            tol 1e-5: iterations, wall ms/iteration (host clock around the
            solve, blocks of ``CHECK_EVERY``), device ms/iteration and device
            launches per iteration (``torch.profiler`` over 64 iterations),
            the reduction census (one loop body), the true relative
            residual; for chebyshev its bounds and the host seconds of the
            f64 Lanczos estimate (made once, on the first plan, and passed
            to the second as ``options``).  cg and pipelined_cg must reach
            tol; chebyshev must run its a-priori budget (at this size the
            estimated bounds miss the bottom of the spectrum and the budget
            ends above tol).  Then the golden matrix at 4x2, ell and sell,
            with the RHS ``default_rng(7).normal``: chebyshev exactly 906 /
            994 iterations at 1e-5 / 3e-6 with the reference's bounds, cg
            within ±1 of 39 / 40, every solver converged with a true
            residual on the f32 plateau (< 1e-3).  pipelined_cg's counts
            are printed beside the reference's 84 / 86 (ell) and 84 / 85
            (sell) and not gated: below the plateau its count is set by
            rounding (the reference's own moves by 3 between its plans).
            Launch counts as in 6b;
6e. resilience  ``resilient_solve`` on the full-size sell 4x2 plan with
            ``check_every`` 50, per solver: the clean chunked ``x`` bit for
            bit the monolithic ``make_solver``'s, ``nan@60`` rolled back and
            converged, one ``bitflip`` chunk (``FaultyTransport`` on the
            card) caught and converged (chebyshev: at the clean run's
            residual), and chunked against monolithic ms/iteration.  The guard reads the chunk's device probe (no
            host matrix: a host f64 matvec per chunk would dominate).  Then
            ``python -m repro_torch.testing.resilience_check --device cuda``
            (48x6, victim SIGKILLed, resume on 2x2 sell ring) must print
            ``OK``.  Launch counts as in 6b, for the in-process part;
6f. example  ``examples/cg_solve_torch.py --device cuda`` at its default size
            as a subprocess: its closing assert holds and its JSON line
            parses;
6g. rect     rectangular plans at full size: ``check_plan`` and
            ``check_kernel_streams`` (what ``verify=True`` runs) on the 4x2
            ell and sell plans with no error; the agg-16 restriction R
            (80,000 x 1.28M, columns pinned to A's row space) and P = Rᵀ
            (rows pinned to A's, columns to R's) built with
            ``verify=True``, each against a host f64 CSR matvec (rel <=
            1e-5), every transport bit for bit ``a2a``, a pinned rebuild
            bit for bit; ``rect_check --device cuda`` at 4x2 and
            halo-free 1x8 printing ``OK``.  Launch counts are zeroed
            before and read after that path: every kernel must have
            launched.  Then the kernel at each of R's and P's shapes
            against its plain version (2e-5·max|y|), timed as in phase 3,
            with the library's time for the same R or P;
6h. precond  (TF32 matmuls must be off) ``precond_check --device cuda`` on
            graded, single and halofree printing ``OK``, and failing with
            ``--include-faulty``; ``--scaling`` with its counts beside the
            reference's (two_level gated within ±1 of 24 / 26 / 25 and
            flat; block_jacobi's, on the f32 plateau at the first mesh,
            printed); cg to tol 1e-6 with jacobi, block_jacobi and
            two_level (agg 8, block_jacobi smoother) on
            ``graded_extruded_mesh_matrix(500, 64)`` (32,000 rows) at 4x2
            ell and sell, and jacobi then two_level (agg 256, jacobi
            smoother) on the full sell 4x2 plan.  Each solve: iterations,
            wall and device ms/iteration, launches per iteration, the
            census (2), the true residual (< 1e-4), the host seconds of
            the build; for two_level one apply's device time by kernel,
            and the coarse correction's device ms per iteration (its
            solve's less its smoother's alone) and share.  Launch counts
            as in 6b;
6i. serve    the batched kernels (B1-B4 under ``vmap``: one launch for k
            right-hand sides) on the full-size 4x2 and 1x8 plans at k = 1,
            3, 4, 8 and 16, f32 and bf16 storage: every column bit for bit
            the single-column kernel on that column, the whole within
            2e-5·max|y| of the batched plain version; in f32 the median ms
            of 20 CUDA-event runs of the wrapper (its interleave copy of x
            included), the same per call of 20 back to back
            (``loop_ms``: no host gaps between them) and the copy alone
            (``interleave_ms``), the bound
            (matrix bytes once + k x (x_local + x_ghost + y bytes) over the
            memory rate) and cuSPARSE SpMM (``torch.sparse`` CSR x dense
            (n, k)) as the library; the batched shard body on the 4x2
            plans, each column bit for bit the unbatched body for every
            transport x wire dtype.  Then the serving path, launch counts
            zeroed just before it and read just after (every batched
            kernel must have launched): ``make_solver(nrhs=4)`` (cg +
            jacobi, tol 1e-5) on each full plan, each column within ±1 of
            its ``nrhs=None`` solve and a true residual < 2e-4, and on
            sell 4x2 wall and
            device ms and launches per iteration against four sequential
            solves; the service (``SolveService``, sell 4x2, a2a f32, cg +
            jacobi, nrhs 4, check_every 25) on 16 requests with tols
            cycling 1e-5 / 3e-5 / 1e-4: all converge with a host-f64 true
            residual < 2e-4, makespan at least 1.05x the same requests one
            at a time through a warm ``make_solver``, p50/p99 latency,
            ``recompiles == 0``, a second service over the same cache a
            pure hit, one splice leaving the survivors' per-chunk iterates
            byte-identical; ``serve_check --device cuda`` (2x4, 48x8)
            printing ``OK``;
6j. analyze  the collective-contract verifier (``repro_torch.testing.
            analyze``) at its defaults (graded 32x4, 4x2) on the card with
            ``--hlo`` (each solver's live ``check_every`` block through
            B1/B2): exit 0, its checks and errors printed; with
            ``--include-faulty``: exit 1, ``J_PAYLOAD_TRANSFORM`` among its
            codes.  Then the recorded census of ``make_spmv`` on the
            full-size ell and sell 4x2 plans for every transport x wire
            dtype beside ``predicted_cost``: the census equals the
            prediction plus the one core-axis assembly ``all_gather``, and
            the wire bytes derived from the payloads handed to the
            collectives equal the predicted bytes (one card has no wire:
            the bytes are those each node would send as its own device).
            Launch counts zeroed before and read after: B1 and B2 must
            have launched;
6k. cli      the test CLIs on the card, in this process: ``dist_check``
            (4x2 balanced, ``--fused --solver all --nrhs 4``; the same
            with ``--check-every 25 --inject-fault nan@30``; halo-free
            1x8 sell ``--cg``) printing ``OK``; ``square_golden --check
            tests/golden_square_hashes.json``: every plan hash matches,
            the 16 spmv/cg hashes ``SKIP`` (the fixture is the JAX
            package's); ``bench_spmv`` on the full graded matrix at 4x2
            sell, the transport sweep a2a,ring,pairwise,hier (traced wire
            bytes equal to predicted) and ``--cg --fused`` to tol 1e-6,
            printed beside phase ``full``'s ``spmv_ms`` and ms/iteration;
            ``examples/quickstart_torch.py``.  Launch counts zeroed before
            and read after: B1-B4 and the batched B1 must have launched;
6l. procmesh the process mesh (``repro_torch.launch.mesh``): 8 gloo
            ranks on this one card, each holding one shard of the full 4x2
            ell and sell plans of phase 5 (written once here, each rank
            reading its own rows through ``plan_from_arrays``; the rank
            loop and its report are phase 6m's, ``mesh_rank`` and
            ``mesh_report``), and the sell 4x2 plan on equal rows
            (``sell/4x2/rows``), where ``vector`` and ``task`` alternate.
            The balanced plans run the overlapped schedule (``task``'s):
            the diag pass while the exchange is in flight, the offd pass
            onto it.  Per plan, mode and rank: one a2a f32 SpMV, ``y``
            and ghosts bit for bit its row of the virtual mesh's at 4x2,
            one batched SpMV (k = 4) each column bit for bit the
            single-column body, the schedule, the diag pass's ms, the
            wire's ms per SpMV and its exposed part (``procmesh_modes``:
            ``y``, ghosts, iterations and ``x`` bit for bit across
            ``vector`` and ``task``, whose cg runs to 1e-2),
            then, on the sell plan, fused cg + jacobi to
            ``PROCMESH_TOL`` (1e-3) after a warm block (iterations equal on every rank and within ±1 of
            the virtual mesh's at that tol, true relative residual <
            10·tol, iterates held to the
            virtual mesh's bit for bit and reported), with the rank's
            launch counts zeroed just before and read just after (the
            kernels of the mode's schedule, ``path_kernels``, every
            rank); ms per SpMV (median of 20
            CUDA-event runs, the ranks released together by a barrier)
            and per CG iteration beside the virtual mesh's, and the
            wire's ms by kind and share.  The halo-free 1x8 ell and sell
            plans (B3, B4 on every rank) at one SpMV, and
            the golden 48x6 4x2 plans over every transport x wire dtype
            (``transport_check``'s process sweep: ghosts and ``y`` bit for
            bit, each rank's census equal to ``predicted_cost`` + 1
            ``all_gather``).  Then ms per ``psum`` and per core-axis
            ``all_gather`` of an ``x`` shard, on host tensors against the
            card's (gloo alone, and the staging the card adds).  Then
            the layers above the solvers on the same ranks:
            ``transport="auto"`` on both 4x2 plans (one winner on every
            rank, each candidate's µs); two_level (agg 256, jacobi
            smoother) cg to 1e-6 on the sell plan (iterations equal on
            every rank and within ±1 of phase 6h's, the ELL offd pass
            launched at R's and P's shapes on every rank, per-rank host
            build seconds);
            the resilient driver there in chunks of 50, to the
            monolithic solve's tol (every rank's
            rows of the whole ``x`` bit for bit its monolithic shard,
            ``nan@60`` rolled back once with one trajectory on every
            rank); the service (nrhs 4, the first 5 of phase 6i's
            requests, one spliced in mid-solve: iterations equal on
            every rank and within ±1 of phase 6i's, ``recompiles == 0``
            and the batched SELL offd pass launched on every rank, true
            residuals
            under 1e-4, 2e-4 at tol 1e-4; makespan reported, not gated);
            and ``resilience_check --mesh process --device cuda`` (two
            spawns since PR 28: the victim's 8 ranks, then 4 ranks that
            resume and then solve the clean baseline).  Eight processes share one card and
            their wire is host memory: no inter-node wire is measured;
6m. nccl     the process mesh on NCCL, one rank per card (rank ``r`` on
            ``cuda:r``, every card of this host; the first line names
            NCCL's version and the cards, and which grids ran and which
            need more cards).  A mesh of one rank more than the cards
            must be refused before any process starts.  On the full
            matrix of phase 5, ell and sell, a2a: 1x1 on one card; 2x1
            and 1x2 on two; 4x1 ("MPI"), 2x2 (hybrid) and 1x4
            (halo-free, B3/B4) on four, a further mesh of each grid over
            one spawned group.  Per grid and plan against the virtual
            mesh at that grid (on card 0): every rank's ``y`` and a2a
            ghosts bit for bit its row; ms per SpMV (median of 20
            CUDA-event runs, the ranks released together by a barrier);
            cg + jacobi to 1e-6 with iterations equal on every rank
            (and to the virtual mesh's at 1x1, ±1 elsewhere), a true
            relative residual < 1e-4, wall ms per iteration, device ms
            and NCCL-kernel ms per iteration and device launches per
            iteration (``torch.profiler``, 32 iterations a rank), the
            wire's ms by kind (CUDA events) and share; every rank
            launched its kernel.  At world 1 no collective moves data.
            Per grid the wire probe of 6l on the cards, and
            ``host_split``: the host's CPUs, each rank's affinity and
            threads, a bare c10d ``all_gather_into_tensor`` loop (no port
            code), and both again with each rank's threads pinned to its
            own share of the CPUs.  Then ``nccl_scaling``: speedup and
            efficiency per card of ms per SpMV and per CG iteration
            against the 1x1 NCCL mesh.  On 2x1, 4x1 and 2x2 also the
            plans on equal rows, ``vector`` and ``task`` alternated in one
            call beside ``balanced`` on its own plan (``nccl_grid`` per
            mode, ``nccl_modes``): the same bit gates, ``y`` and ``x``
            bit for bit across the two, iterations equal, ms per SpMV and
            per CG iteration, the diag pass's ms and the exposed wire per
            SpMV and per iteration; on 2x2 ``ring`` and ``hier`` under
            ``task`` bit for bit ``a2a``.  At 1x1 the modes coincide (no
            collective moves data, no halo).
            On four cards, on the 2x2 plans of the same ranks:
            ``transport_check``'s sweep on the full sell plan (every
            transport x wire dtype bit for bit the virtual mesh's
            ``a2a``, census = ``predicted_cost`` + 1), ``auto`` (one
            winner), two_level agg 256 (±1 of the virtual 2x2's, equal
            on every rank), the resilient driver (chunks of 50 bit for
            bit monolithic, ``nan@60`` rolled back once on every rank)
            and the service (phase ``procmesh``'s 5 requests: iterations
            ±1 of the virtual 2x2 service's, ``recompiles`` 0).  Nothing
            falls back to gloo: a failed NCCL start fails the phase;
6n. lm      the LM serving path (``repro_torch.models``), which runs no
            kernel of the port: its products are ``torch.matmul``, its
            scans and elementwise work PyTorch's own kernels.  Three
            archs at full width and depth, one after the other, each
            freed before the next: qwen2.5-3b (36 layers, d 2048, 16/2
            heads, QKV bias, tied embeddings, vocab 151,936 padded to
            153,600), xlstm-350m (21 mLSTM + 3 sLSTM blocks, d 1024, 4
            heads of 512, no FFN) and zamba2-1.2b (32 Mamba2 blocks of 64
            heads × 64, state 64, and one shared attention + SwiGLU block
            applied 6 times, d 2048); f32 weights, bf16 compute, bf16 KV
            and conv caches, f32 recurrent states.  Each: ``get_config``
            → ``init_params`` (a seeded generator on the card; its
            parameter count beside ``cfg.n_params()``) → ``init_cache``
            (4 × 576) → ``prefill`` of 4 seeded prompts of 512 tokens →
            16 greedy ``decode_step``s with a ``(B,)`` ``pos``.  Gates:
            prefill's last logits bit for bit ``forward_train``'s last
            position, else within 1e-5; the first step, once with the
            ``(B,)`` ``pos`` and once with the scalar, bit for bit (logits
            and every cache tensor) and within 2e-2·max(1, max|ref|) of
            ``forward_train`` on the 513 tokens (xlstm, zamba: a fixed
            1e-1, ``LM_BF16_RECURRENT``); the same step at f32 compute
            with every cache tensor in f32, prefill and one step, within
            1e-4·max(1, max|ref|) of the f32 ``forward_train``; every
            logit finite.
            Printed: prefill ms (median of 3, CUDA events) and tokens/s,
            its device ms, launches and top five device ops; decode ms per
            step (median of the 32, CUDA events, with min and max), wall
            and device ms per step, its bound (the parameters as stored,
            the KV caches read and the recurrent states read and written,
            over phase 1's memory rate), launches per step and the top
            five device ops (``torch.profiler``, one step),
            ``max_memory_allocated``, the card's name and power limit.
            Then every arch at ``reduced()`` (B 2, S 32), one seeded
            weight set made on the CPU and copied to the card:
            ``forward_train``, ``prefill`` and ``decode_step`` (from the
            CPU's prefill cache) on the card within 1e-4·max(1,
            max|ref|) of the CPU's at f32 compute (TF32 off) with MoE
            routing equal, and within 2e-2 at bf16 (xlstm, zamba 1e-1;
            MoE at capacity factor 64), where a routing swap must be a
            near-tie (log-ratio of the k-th and (k+1)-th probabilities
            ≤ 2^-7) and each row is held up to its first swapped token;
            the recurrent states
            (float32) at that bound, the bf16 caches (KV, conv) within it
            or one bf16 step.  No port kernel may launch in the phase.
            Its tensors are freed before phase 6l's ranks spawn;
6o. train   the training path (``launch/train.py``, ``optim``, ``data``,
            ``_remat``, the flash backward): no port kernel either.
            (a) ``flash_attention``'s backward (``_Flash``) at qwen2.5-3b's
            shape (B 4 × S 512, 16 / 2 heads of 128, causal) and
            whisper's encoder's (B 4 × 1500 frames, 20 heads of 64, not
            causal), f32 and bf16: dq / dk / dv against autograd through
            the plain forward within 1e-4 / 2e-2 of max|ref|, and fwd+bwd
            ms beside ``scaled_dot_product_attention``'s (a yardstick).
            (b) Every arch at ``reduced()`` (B 2, S 32) in the
            deterministic mode: ``loss_fn``'s f32 gradient card against
            CPU on one seeded weight set (TF32 off), per reference leaf
            within 1e-4·max|g leaf| + 1e-6·max|g|; ``remat_policy``
            ``full`` / ``dots`` / ``none`` bit for bit on the card; every
            bf16 gradient finite.  The trainer's CLI in this process
            (xlstm-350m ``--reduced``, B 2, S 64, ``--device cuda``): 8
            steps with a checkpoint every 4, then only ``step_000000004``
            resumed to 8: losses 5-8 and the step-8 checkpoint's arrays
            bit for bit.  (c) qwen2.5-3b at full width (3,089,346,560
            parameters, f32 weights from a seeded generator on the card,
            bf16 compute, ``remat`` ``full``), the port's
            ``TokenPipeline`` at B 4 × S 512: a step of 1e-2 along
            -g/|g| at init lowers the loss by 1e-2·|g| within 10%; then
            ``make_train_step`` with AdamW (lr 3e-5, warmup 1) for 8
            steps: every loss and grad norm finite, the last loss below
            the first, a second run of steps 1-3 from the seed equal bit
            for bit (losses and each parameter's int64 sum of its f32
            bits), continued 6 steps that alternate without and with the
            deterministic mode (its cost, within one run).
            Printed: ms per step (median of steps 2-8, CUDA events),
            tokens/s, device ms, launches and top five device ops over
            one step (``torch.profiler``), the bound (8·N·T at the bf16
            peak plus AdamW's 28·N bytes at phase 1's rate), 6·N·T over
            ms × the bf16 peak, ``max_memory_allocated``, the card's name
            and power limit.  Its tensors are freed before phase 6l;
6p. shard   sharded training and the ring collective matmul
            (``runtime/sharding.py``, ``runtime/sharded.py``,
            ``runtime/overlap.py``), which run no kernel of the port
            either.  ``param_pspecs`` of every arch on both production
            meshes (16x16, 2x16x16; meta-device stand-ins, host only):
            every spec splits its dims evenly, and each card's share of
            the f32 parameters.  A mesh of one NCCL rank more than the
            cards is refused before any process starts.  In the default
            run: one spawned NCCL rank (a 1x1 mesh), where qwen2.5-3b at
            ``reduced()`` (B 2, S 32, 3 AdamW steps) trains bit for bit
            as the one-device trainer (losses, grad norms, each
            parameter's bit sum).  Under ``--only shard``, four NCCL
            ranks, one a card, a 2x2 ``data x model`` mesh: (a)
            qwen2.5-3b at full width and f32 compute, B 4 x S 512, remat
            ``full``, AdamW lr 3e-5 (warmup 1), 3 steps, first by the
            one-card trainer on rank 0 (its parameters kept on the host),
            then twice on the mesh: every rank's losses equal, losses and
            grad norms within 1e-5 / 1e-4 relative of the one-card run,
            every leaf's gradient block after step 1 on every rank within
            1e-3 (2-norm, relative) of the one-card gradient's (read as
            AdamW's first moment; rank 0 broadcasts the one-card leaves
            one at a time), the parameters after step 3 within 0.5·lr,
            each block its spec's shard, the second mesh run bit for bit
            the first; (b) granite-3-8b at full width (bf16
            compute, the ``TokenPipeline`` at B 4 x S 512): a step of
            1e-2 along -g/|g| lowers the loss by 1e-2·|g| within 10%,
            then 8 steps (and a ninth, profiled on rank 0): every loss
            finite, the last below the first, every rank's
            ``max_memory_allocated`` under 80 GB; printed: ms per step
            (median of steps 2-8, CUDA events), tokens/s, device ms and
            launches per step (``torch.profiler``), the wire's ms by kind
            per step (``WIRE``: CUDA events around each collective), the
            bound (8·N·T at the bf16 peak over four cards plus AdamW's
            28·N bytes over four cards' memory rate) and 6·N·T over the
            step as the share of four cards' peak; (c) the ring at
            qwen2.5-3b's MLP up-projection, x (2048, 2048) · W (2048,
            11008), K split over the four ranks, f32 and bf16 storage:
            each rank within 1e-5·max|y| of the float64 product; the
            ring's ms, its wire's and exposed wire's ms, against the
            all-gather-then-one-``torch.matmul`` form's (median of 10,
            CUDA events, the ranks released together by a barrier).
            Also under ``--only shard`` (sharded serving and the
            dry-run, ``launch/dryrun.py``): (b2) one more granite step
            measured as the dry-run measures its train cell (flops by
            ``FlopCounterMode``, the allocator's peak less what lies
            beside the step's arguments) against ``dryrun.predict`` on a
            fake 2x2 process group, made before the spawn: flops equal,
            peak within 10%; (d) qwen2.5-3b at full width, f32 compute
            and caches, bf16 weights, 4 prompts x 512 and 16 greedy
            steps on each rank's card alone and on the 2x2 mesh
            (weights split over ``model``, KV caches as each rank's
            slice of the sequence): tokens equal, logits and every cache
            block within 1e-5·max|ref|, a second mesh run bit for bit;
            (e) yi-34b at full width and bf16 on the 2x2 mesh (34.4 GB of
            weights a rank; one card cannot hold the 68.8 GB): a decode
            step of the dry-run's cell (4 rows, 528 slots) against its
            prediction (flops equal, peak within 10%), its wire by kind
            and device ms and launches (``torch.profiler``, rank 0), then
            4 prompts x 512 and 16 greedy steps: prefill ms, decode ms
            a step, tokens/s, tokens in vocab, logits finite, every
            rank's peak under 80 GB; then ``localsgd_check`` (2 ranks)
            and ``elastic_check`` (4 then 2 ranks) over NCCL, ``OK``;
6q. dryrun  sharded serving on the 1x1 NCCL mesh (phase shard's rank,
            after its trainer: qwen2.5-3b at ``reduced()``, f32: tokens,
            logits and cache bit for bit the non-mesh path's), then two
            cells one card runs, each
            predicted by ``dryrun.predict`` on a 1x1 mesh (fake tensors)
            and run for real on the card by ``dryrun.build_cell``:
            qwen2.5-3b decode at phase lm's shape (4 rows, 576 slots,
            bf16) and train at phase train's (B 4 x S 512, remat
            ``full``): flops equal, the predicted peak within 10% of
            ``max_memory_allocated`` over the step (less what lies beside
            its arguments), with ``total_memory``;
7. the ``kernels`` line (B1-B4, B5 and the flat ELL, then B1/B2 at R's
   and P's shapes with phase 6g's launches and the library's time on R or
   P, then the batched B1-B4 at k = 4 with phase 6i's launches and SpMM's
   time, then the offd passes (ELL, SELL, batched ELL and SELL at k = 4)
   with their launches over phase 6l's ranks and the library's ``addmv``
   / ``addmm``), the ``nvidia-smi`` line, and the last line ``{"ok": true,
   "device": {...}}``.  Under ``--only nccl`` the kernels line holds the
   kernels of 6m's path, each held to its plain version and timed at the
   shapes 6m gave it, with its launches over every rank: on one card B3
   and B4 (1x1); on four B1-B4 (2x2, 1x4), the offd passes at the 2x2
   shapes (single and k = 4; the grids', two_level's and the service's
   launches) and the ELL offd pass at the 2x2 two_level's R and P (that
   run's launches): on the ranks two_level and the service run balanced
   plans, so the overlapped schedule.

``library_ms`` is one ``torch.sparse`` CSR matvec of the same global
matrix (cuSPARSE) — the yardstick only; the port never calls it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections.abc import Mapping
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
N_SURFACE, LAYERS, SEED = 20_000, 64, 0
DEVICE = "cuda"
REPS = 20
CHECK_EVERY = 16          # gated CG iterations per host sync
KERNELS = {   # name -> (plan key, TPU kernel it replaces)
    "fused_ell_spmv": ("ell/4x2", "src/repro/kernels/spmv_bcsr.py:103"),
    "fused_sell_spmv": ("sell/4x2", "src/repro/kernels/spmv_bcsr.py:211"),
    "ell_spmv": ("ell/1x8", "src/repro/kernels/spmv_bcsr.py:58"),
    "sell_spmv": ("sell/1x8", "src/repro/kernels/spmv_bcsr.py:189"),
}
#: the single-device path's kernels; B5's row on the ``kernels`` line is
#: the 64-bin nnz-balanced f32 one, the flat ELL's the global ELLMatrix's
BALANCED = ("balanced_spmv", "src/repro/kernels/spmv_bcsr.py:268",
            "balanced/64")
FLAT_ELL = ("ell_spmv/flat", "src/repro/kernels/spmv_bcsr.py:58",
            "ell/global")
SOURCE = "src/repro_torch/kernels/csrc/spmv.cu"
#: plan -> the kernel its single-column SpMV launches
KERNELS_OF = {key: name for name, (key, _) in KERNELS.items()}


def kernel_of(fmt: str, halo: bool) -> str:
    """The single-column kernel a plan of format ``fmt`` launches, with
    a halo or without."""
    return {("ell", True): "fused_ell_spmv", ("ell", False): "ell_spmv",
            ("sell", True): "fused_sell_spmv",
            ("sell", False): "sell_spmv"}[(fmt, halo)]


def path_kernels(fmt: str, halo: bool, mode: str, batched: bool = False
                 ) -> tuple[str, ...]:
    """The kernels one SpMV of a rank-local plan launches in ``mode``: the
    fused kernel under ``vector``'s barrier; the diag pass and the offd
    pass onto it under ``task`` / ``balanced`` (the overlapped schedule);
    the halo-free kernel alone without a halo.  ``batched``: the batched
    kernels' names."""
    tag = "_batched" if batched else ""
    if not halo:
        return (kernel_of(fmt, False) + tag,)
    if mode == "vector":
        return (kernel_of(fmt, True) + tag,)
    return (kernel_of(fmt, False) + tag, f"{fmt}_spmv_onto{tag}")


#: the script's start (``time.perf_counter``): every line carries its
#: seconds since, so each phase's time is the gap between its lines
START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "at_s": round(time.perf_counter() - START, 3)}),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` on the current
    stream, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def loop_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Per call, ``reps`` calls of ``fn()`` back to back between two CUDA
    events, after ``warmup`` calls: the host's launch gaps hide behind the
    device's work, as in a solve's loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def read_fields(fmt, x_ghost) -> tuple[str, ...]:
    """The plan arrays a kernel reads: values, columns and (ELL) row
    lengths or (SELL) slice descriptors of the diag stream, and of the offd
    stream with a halo.  The SELL ``rows`` streams are never read."""
    streams = ("d", "o") if x_ghost is not None else ("d",)
    if fmt.name == "ell":
        names = {"d": "diag", "o": "offd"}
        return tuple(f"{names[s]}_{f}" for s in streams
                     for f in ("vals", "cols", "len"))
    return tuple(f"sell_{s}{f}" for s in streams
                 for f in ("vals", "cols", "start", "width"))


def ell_bytes(vals, cols, lens, xs) -> tuple[int, int, int]:
    """ELL inputs as the kernel reads them: ``(bytes, flops, stored
    bytes)``.  Only each row's real entries are read (value and column),
    with the row lengths and x; the stored bytes count every slot."""
    real = sum(int(n.sum()) for n in lens)
    per = vals[0].element_size() + cols[0].element_size()
    return (real * per + nbytes(*lens, *xs), 2 * real,
            nbytes(*vals, *cols, *xs))


def kernel_cost(fmt, F, xl, xg) -> tuple[int, int, int | None]:
    """``(bytes, flops, stored bytes or None)`` of one local matvec on
    ``F``: ELL as ``ell_bytes`` counts it; SELL its stored entries and
    slice descriptors, one multiply and one add per stored entry (f32,
    outside the tensor cores)."""
    fields = read_fields(fmt, xg)
    if fmt.name == "ell":
        return ell_bytes(*([F[k] for k in fields if k.endswith(f)]
                           for f in ("vals", "cols", "len")), [xl, xg])
    return (nbytes(*(F[k] for k in fields), xl, xg),
            2 * sum(F[k].numel() for k in fields if k.endswith("vals")),
            None)


def run_cli(main, argv) -> tuple[int, list[str]]:
    """A checker's ``main(argv)`` in this process: ``(exit code, stdout
    lines)``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines()


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #
def phase_device() -> tuple[str, float, float]:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    pcie = "pcie" in name.lower()
    bw = 2.0e12 if pcie else 3.35e12
    f32_peak = 51.2e12 if pcie else 67e12
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(),
         bandwidth_tb_s=bw / 1e12, f32_tflop_s=f32_peak / 1e12,
         peaks_source="H100 PCIe data sheet" if pcie
         else "H100 SXM data sheet",
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi, bw, f32_peak


def phase_build() -> None:
    from repro_torch.kernels import spmv_cuda

    t0 = time.perf_counter()
    path, log = spmv_cuda.build(verbose=True)
    spmv_cuda.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(path.relative_to(ROOT)),
         flags=" ".join(spmv_cuda.NVCC_FLAGS),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])


def build_plans(A) -> dict:
    from repro_torch.core import build_spmv_plan

    plans = {}
    for key in ("ell/4x2", "sell/4x2", "ell/1x8", "sell/1x8"):
        fmt, grid = key.split("/")
        n_node, n_core = (int(v) for v in grid.split("x"))
        t0 = time.perf_counter()
        plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                       format=fmt, transport="a2a",
                                       device=DEVICE)
        plans[key] = (plan, layout)
        emit("plan", plan=key, seconds=round(time.perf_counter() - t0, 3),
             rc_pad=plan.rc_pad, nl_pad=plan.nl_pad, g_pad=plan.g_pad,
             hs=plan.hs, nnz_stored=plan.nnz_stored(),
             padding_waste=layout["stats"]["padding_waste"],
             fields={k: list(v.shape) for k, v in plan.fmt_data.items()})
    return plans


def measure(phase: str, row: dict, kern, plain, in_bytes: int, flops: int,
            bw: float, f32_peak: float, other_bytes: dict | None = None
            ) -> dict:
    """Hold ``kern()`` against ``plain()`` on the same inputs and time both;
    emit ``row`` with the results as one ``phase`` line and return it.

    Both accumulate in f32 on the same values, whatever the storage dtype,
    so only the summation order differs: the limit is 2e-5·max|y|.  The
    bound is the larger of the bytes moved (``in_bytes`` read once, the
    output written once) over the memory rate and ``flops`` over the f32
    rate.  Each entry ``name: bytes`` of ``other_bytes`` (ELL's every
    stored slot, B5's COO layout) adds ``bound_<name>_ms``, those bytes and
    the output over the memory rate.  Two launches of ``kern`` must give the
    same bits."""
    import torch

    y, want = kern(), plain()
    same = torch.equal(kern(), y)
    torch.cuda.synchronize()
    err = float((y - want).abs().max())
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    byts = in_bytes + nbytes(y)
    bytes_ms, flops_ms = byts / bw * 1e3, flops / f32_peak * 1e3
    row = {**row, "max_abs_err": err, "tol": tol, "ms": time_ms(kern),
           "plain_ms": time_ms(plain), "bytes": byts, "flops": flops,
           "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    for name, b in (other_bytes or {}).items():
        row[f"bound_{name}_ms"] = (b + nbytes(y)) / bw * 1e3
    row["bitwise_repeat"] = same
    emit(phase, **row)
    what = (f"{row['kernel']} {row.get('plan', row.get('matrix'))} "
            f"{row['dtype']}")
    check(y.shape == want.shape and err <= tol,
          f"{what}: max|err| {err} > {tol}")
    check(same, f"{what}: two launches differ")
    return row


def phase_kernels(plans, x, bw, f32_peak, keys: dict | None = None) -> dict:
    """Each kernel vs its plain version on its plan's main-path inputs
    (``keys``: kernel -> plan key, by default ``KERNELS``'s)."""
    import torch

    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.sparse import get_format

    if keys is None:
        keys = {name: key for name, (key, _) in KERNELS.items()}
    results = {}
    for name, key in keys.items():
        plan, layout = plans[key]
        fmt = get_format(plan.format)
        body = make_shard_body(plan)
        xl, xg = body.inputs(to_dist(x, layout, plan))
        for dtype in (torch.float32, torch.bfloat16):
            F = {k: (v.to(dtype) if v.is_floating_point() else v)
                 for k, v in plan.fmt_data.items()}
            byts, flops, stored = kernel_cost(fmt, F, xl, xg)
            row = measure(
                "kernel", {"kernel": name, "plan": key,
                           "dtype": str(dtype)[6:]},
                lambda: fmt.matvec_kernel(F, xl, xg, plan.rc_pad),
                lambda: fmt.matvec_plain(F, xl, xg, plan.rc_pad),
                byts, flops, bw, f32_peak,
                None if stored is None else {"stored": stored})
            results.setdefault(name, row)        # f32 first: the main path
            del F
    return results


def phase_balanced(A, x, bw, f32_peak) -> tuple[dict, dict]:
    """The single-device kernel path on the full-size matrix; returns the
    path's launch counts and the f32 rows of ``balanced_spmv`` and of the
    flat ``ell_spmv`` by label."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.partition import (imbalance, partition_balanced,
                                            partition_equal_rows)
    from repro_torch.kernels import (LAUNCHES, balanced_spmv, ell_spmv, ref,
                                     reset_launches)
    from repro_torch.sparse import BalancedCOO, ELLMatrix, balanced_warp_map

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    y_host = A.matvec(x.astype(np.float64))
    scale = float(np.abs(y_host).max())
    xd = torch.from_numpy(x).to(DEVICE)
    built = {}
    reset_launches()
    for nbins in (16, 64, 8 * sms):
        for kind in ("balanced", "rows"):
            bounds = (partition_balanced(A.row_nnz, nbins)
                      if kind == "balanced"
                      else partition_equal_rows(A.n_rows, nbins))
            t0 = time.perf_counter()
            bcoo = BalancedCOO.from_csr(A, bounds, device=DEVICE)
            build_s = time.perf_counter() - t0
            y = balanced_spmv(bcoo, xd).cpu().numpy()
            rel = float(np.abs(y - y_host).max() / scale)
            check(y.shape == (A.n_rows,) and rel <= 1e-5,
                  f"balanced {kind}/{nbins}: rel err {rel} > 1e-5")
            # the warp map alone, again from the host arrays
            host = [t.cpu().numpy() for t in (bcoo.lrows, bcoo.bin_starts,
                                              bcoo.out_gather)]
            t0 = time.perf_counter()
            balanced_warp_map(host[0], np.asarray(bcoo.bin_nnz), host[1],
                              host[2], bcoo.n_rows, bcoo.rows_pad)
            map_s = time.perf_counter() - t0
            del host
            built[f"{kind}/{nbins}"] = (bcoo, {
                "nbins": nbins, "bounds": kind, "build_s": build_s,
                "map_s": map_s, "warps": bcoo.warp_map.shape[0],
                "blocks": -(-bcoo.warp_map.shape[0] // 8),
                "imbalance": imbalance(A.row_nnz, bounds),
                "host_rel_err": rel})
    t0 = time.perf_counter()
    ell = ELLMatrix.from_csr(A, device=DEVICE)
    build_s = time.perf_counter() - t0
    y = ell_spmv(ell.vals, ell.cols, xd,
                 lens=ell.row_lens)[:A.n_rows].cpu().numpy()
    rel = float(np.abs(y - y_host).max() / scale)
    check(rel <= 1e-5, f"flat ell_spmv: rel err {rel} > 1e-5")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    emit("balanced_launches", **launches)
    check(launches["balanced_spmv"] > 0 and launches["ell_spmv"] > 0,
          "the single-device path never launched its kernels")

    rows = {}
    for label, (bcoo, info) in built.items():
        for dtype in (torch.float32, torch.bfloat16):
            B = dataclasses.replace(bcoo, vals=bcoo.vals.to(dtype))
            per = B.vals.element_size() + 4       # value + int32 column
            # the real entries only (the kernel never reads the padding):
            # value and column each, the row lengths, the warp map and x;
            # the COO count adds the bin-local row per entry, the bin
            # lengths and the row map, and drops the map and row lengths
            row = measure(
                "balanced", {"kernel": "balanced_spmv", "matrix": label,
                             **info, "dtype": str(dtype)[6:],
                             "padding_waste": B.padding_waste,
                             "nnz_pad": B.nnz_pad, "rows_pad": B.rows_pad,
                             "bytes_stored": nbytes(B.vals, B.cols,
                                                    B.lrows)},
                lambda: balanced_spmv(B, xd),
                lambda: ref.balanced_spmv_ref(B, xd),
                A.nnz * per + nbytes(B.row_lens, B.warp_map, xd),
                2 * A.nnz, bw, f32_peak,
                {"coo": A.nnz * (per + 4) + 4 * B.nbins
                 + nbytes(B.out_gather, xd)})
            rows.setdefault(label, row)          # f32 first
            del B
    # balanced against equal-row bins of one count, timed in turns
    # (balanced, rows, rows, balanced, twice) so that a drift of the card
    # falls on both
    for nbins in (16, 64, 8 * sms):
        for dtype in (torch.float32, torch.bfloat16):
            Bs = {kind: dataclasses.replace(
                built[f"{kind}/{nbins}"][0],
                vals=built[f"{kind}/{nbins}"][0].vals.to(dtype))
                for kind in ("balanced", "rows")}
            times = {"balanced": [], "rows": []}
            for kind in ("balanced", "rows", "rows", "balanced") * 2:
                times[kind].append(time_ms(
                    lambda: balanced_spmv(Bs[kind], xd)))
            bal, eq = (statistics.median(times[k])
                       for k in ("balanced", "rows"))
            emit("balanced_vs_rows", nbins=nbins, dtype=str(dtype)[6:],
                 balanced_ms=bal, rows_ms=eq, ratio=bal / eq,
                 balanced_runs=times["balanced"], rows_runs=times["rows"],
                 warps={k: B.warp_map.shape[0] for k, B in Bs.items()})
            del Bs
    del built
    for dtype in (torch.float32, torch.bfloat16):
        vals = ell.vals.to(dtype)
        byts, flops, stored = ell_bytes([vals], [ell.cols], [ell.row_lens],
                                        [xd])
        row = measure(
            "balanced", {"kernel": "ell_spmv", "matrix": FLAT_ELL[2],
                         "dtype": str(dtype)[6:], "build_s": build_s,
                         "host_rel_err": rel, "width": ell.width,
                         "padding_waste": 1.0 - A.nnz / vals.numel()},
            lambda: ell_spmv(vals, ell.cols, xd, lens=ell.row_lens),
            lambda: ref.ell_spmv_ref(vals, ell.cols, xd),
            byts, flops, bw, f32_peak, {"stored": stored})
        rows.setdefault(FLAT_ELL[2], row)        # f32 first
        del vals
    del ell
    return launches, rows


def phase_golden() -> None:
    import numpy as np

    from repro_torch.core import build_spmv_plan, to_dist
    from repro_torch.solvers import make_solver
    from repro_torch.sparse import graded_extruded_mesh_matrix

    fixture = json.loads((ROOT / "tests" / "golden_square_hashes.json")
                         .read_text())
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    rng.standard_normal(A.n_rows)                      # the fixture's x
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(
            A, fixture["n_node"], fixture["n_core"], mode="balanced",
            format=fmt, device=DEVICE)
        _, iters, rel = make_solver(plan)(to_dist(b, layout, plan),
                                          tol=1e-6, maxiter=400)
        want = fixture["entries"][f"{fmt}/a2a"]["cg"]["iters"]
        emit("golden", format=fmt, iters=int(iters), fixture_iters=want,
             rel=float(rel))
        check(abs(int(iters) - want) <= 1,
              f"golden {fmt}: {int(iters)} iterations, fixture {want} ±1")


def solve_timed(solve, bd, tol: float = 1e-6):
    """One solve to ``tol``: ``(x, iters, rel, wall ms, iterations
    run)``.  Whole blocks of ``CHECK_EVERY`` gated iterations run, so up
    to ``CHECK_EVERY - 1`` no-op iterations follow convergence."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, iters, rel = solve(bd, tol=tol, maxiter=10_000)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    iters_run = -(-int(iters) // CHECK_EVERY) * CHECK_EVERY
    return xs, int(iters), float(rel), ms, iters_run


def phase_full(A, plans, x, b) -> tuple[dict, dict]:
    """The main path at full size; returns the launch counts and each
    plan's row of results."""
    import numpy as np
    import torch

    from repro_torch.core import from_dist, make_cg, make_spmv, to_dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.solvers import make_solver

    y_host = A.matvec(x.astype(np.float64))
    b64 = b.astype(np.float64)
    rows = {}
    reset_launches()
    for key, (plan, layout) in plans.items():
        spmv = make_spmv(plan)
        xd = to_dist(x, layout, plan)
        y = from_dist(spmv(xd), layout, plan)
        spmv_rel = float(np.abs(y - y_host).max() / np.abs(y_host).max())
        check(spmv_rel <= 1e-5, f"{key}: SpMV rel err {spmv_rel} > 1e-5")
        row = {"plan": key, "spmv_rel_err": spmv_rel,
               "spmv_ms": time_ms(lambda: spmv(xd))}
        bd = to_dist(b, layout, plan)
        solvers = {"fused": make_solver(plan, solver="cg", precond="jacobi",
                                        check_every=CHECK_EVERY)}
        if key.endswith("4x2"):
            solvers["unfused"] = make_cg(plan, fused=False,
                                         check_every=CHECK_EVERY)
        for kind, solve in solvers.items():
            xs, iters, rel, ms, iters_run = solve_timed(solve, bd)
            xg = from_dist(xs, layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                             / np.linalg.norm(b64))
            row[kind] = {"iters": iters, "iters_run": iters_run,
                         "rel": rel, "true_rel": true_rel, "ms": ms,
                         "ms_per_iter": ms / max(iters_run, 1)}
            check(np.isfinite(xg).all() and xg.shape == (A.n_rows,),
                  f"{key} {kind}: non-finite or misshapen solution")
            check(float(rel) <= 1e-6, f"{key} {kind}: CG stopped at "
                  f"{int(iters)} iterations, rel {float(rel)}")
            check(true_rel < 1e-4, f"{key} {kind}: true rel {true_rel}")
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        emit("full", **row)
        rows[key] = row
    launches = dict(LAUNCHES)
    emit("launches", **launches)
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    return launches, rows


def device_profile(fn, host: dict | None = None,
                   cpu: bool = True) -> tuple[dict, int]:
    """``torch.profiler`` over one call of ``fn`` (then a synchronise):
    device ms by kernel name and the number of device launches (kernels,
    copies and fills on the card); ``host``, where given, gathers the
    host ms of the process-group calls by name (the ``c10d::``
    operators).  ``cpu=False`` traces the card alone (a training step's
    ~100k host operators take the profiler longer than the step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.device_time_total / 1e3)
            launches += 1
        elif host is not None and ev.name.startswith("c10d::"):
            host[ev.name] = host.get(ev.name, 0.0) + ev.cpu_time_total / 1e3
    return by_name, launches


def profile_solve(solve, bd, iters: int = 64,
                  host: dict | None = None) -> tuple[dict, int]:
    """Device time by kernel and launches over exactly ``iters``
    iterations of ``solve`` (tol 0, after a warm block); ``host`` as in
    ``device_profile``."""
    solve(bd, tol=0.0, maxiter=CHECK_EVERY)             # warm
    box = {}

    def run():
        box["k"] = int(solve(bd, tol=0.0, maxiter=iters)[1])
    by_name, launches = device_profile(run, host)
    check(box["k"] == iters, f"profile: {box['k']} != {iters} iterations")
    return by_name, launches


def phase_profile(plans, b, full_rows, iters: int = 64) -> None:
    """Device time by kernel over ``iters`` fused-CG iterations of each 4x2
    plan (``torch.profiler``), against the unprofiled ms/iteration of
    phase ``full``: their ratio is the device's busy share."""
    from repro_torch.core import to_dist
    from repro_torch.solvers import make_solver

    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        solve = make_solver(plan, check_every=CHECK_EVERY)
        by_name, launches = profile_solve(solve, to_dist(b, layout, plan),
                                          iters)
        device_ms = sum(by_name.values()) / iters
        wall = full_rows[key]["fused"]["ms_per_iter"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit("profile", plan=key, iters=iters,
             device_ms_per_iter=device_ms, ms_per_iter_unprofiled=wall,
             busy_share=device_ms / wall,
             kernels_ms_per_iter={n[:60]: t / iters for n, t in top},
             launches_per_iter=launches / iters)


def device_launches(fn, calls: int = 5) -> float:
    """Device launches per call of ``fn`` (``torch.profiler``: kernels,
    copies and fills on the card)."""
    fn()
    _, launches = device_profile(lambda: [fn() for _ in range(calls)])
    return launches / calls


def phase_transports(plans, x, b) -> None:
    """Every transport x wire dtype on the full-size 4x2 plans, held bit
    for bit against a2a at the same wire dtype; faulty caught; autotune."""
    from repro_torch.core import (make_exchange, make_spmv,
                                  resolve_transport, to_dist)
    from repro_torch.core.transport import (FaultyTransport,
                                            autotune_transport,
                                            available_transports,
                                            available_wire_dtypes, get_codec,
                                            register_transport,
                                            transport_census,
                                            unregister_transport)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.solvers import make_solver
    from repro_torch.testing.transport_check import bits_equal

    reset_launches()
    wires = ("f32",) + tuple(w for w in available_wire_dtypes()
                             if w != "f32")
    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        xd, bd = to_dist(x, layout, plan), to_dist(b, layout, plan)
        g = plan.g_pad
        x_max = float(xd.abs().max())
        exact = make_exchange(plan, transport="a2a",
                              wire_dtype="f32")(xd)[..., :g]
        cg_ref = None
        for wd in wires:
            codec = get_codec(wd)
            ghost_ref = make_exchange(plan, transport="a2a",
                                      wire_dtype=wd)(xd)[..., :g]
            y_ref = make_spmv(plan, transport="a2a", wire_dtype=wd)(xd)
            err = float((ghost_ref - exact).abs().max())
            check(err == 0.0 if codec.exact
                  else err <= codec.rel_bound * x_max,
                  f"{key} {wd}: ghost error {err} over the codec's bound")
            census = transport_census(plan, wire_dtype=wd)
            for name in available_transports():
                spmv = make_spmv(plan, transport=name, wire_dtype=wd)
                ghost = make_exchange(plan, transport=name,
                                      wire_dtype=wd)(xd)
                tr, state = resolve_transport(name, plan, wire_dtype=wd)
                host = tr.host_exchange(
                    xd.cpu().numpy(), plan.send_own.cpu().numpy(),
                    plan.recv_own.cpu().numpy(), g, state)
                row = {"plan": key, "transport": name, "wire_dtype": wd,
                       "ghost_bitwise": bits_equal(ghost[..., :g], ghost_ref),
                       "host_bitwise": host[..., :g].tobytes()
                       == ghost[..., :g].cpu().numpy().tobytes(),
                       "spmv_bitwise": bits_equal(spmv(xd), y_ref),
                       "ghost_err": err,
                       "ghost_bound": codec.rel_bound * x_max,
                       "spmv_ms": time_ms(lambda: spmv(xd)),
                       "launches_per_spmv": device_launches(
                           lambda: spmv(xd)),
                       **{f"census_{k}": v
                          for k, v in census[name].items()}}
                if wd == "f32":
                    solve = make_solver(plan, solver="cg", precond="jacobi",
                                        transport=name,
                                        check_every=CHECK_EVERY)
                    xs, iters, rel, ms, iters_run = solve_timed(solve, bd)
                    if cg_ref is None:
                        cg_ref = (xs, iters)
                    row.update(cg_iters=iters, cg_rel=rel,
                               cg_ms_per_iter=ms / max(iters_run, 1),
                               cg_x_bitwise=bits_equal(xs, cg_ref[0]))
                    check(iters == cg_ref[1] and row["cg_x_bitwise"],
                          f"{key} {name}: CG {iters} iterations / x differ "
                          f"from a2a's {cg_ref[1]}")
                    check(rel <= 1e-6, f"{key} {name}: CG rel {rel}")
                emit("transports", **row)
                for k in ("ghost_bitwise", "host_bitwise", "spmv_bitwise"):
                    check(row[k], f"{key} {name} {wd}: {k} fails")
            register_transport(FaultyTransport())
            try:
                bad_ghost = make_exchange(plan, transport="faulty",
                                          wire_dtype=wd)(xd)[..., :g]
                bad_y = make_spmv(plan, transport="faulty",
                                  wire_dtype=wd)(xd)
            finally:
                unregister_transport("faulty")
            caught = {"ghost": not bits_equal(bad_ghost, ghost_ref),
                      "spmv": not bits_equal(bad_y, y_ref)}
            emit("transports_faulty", plan=key, wire_dtype=wd, caught=caught,
                 registered_after=sorted(available_transports()))
            check(all(caught.values()), f"{key} {wd}: faulty not caught")
        res = autotune_transport(plan)
        stamped = plan.transport
        # "auto" tunes again and stamps that run's winner
        auto = make_spmv(plan, transport="auto")
        same = (auto.transport == plan.transport
                and bits_equal(auto(xd), make_spmv(
                    plan, transport=auto.transport)(xd))
                and bits_equal(auto(xd), res.spmv(xd)))
        emit("autotune", plan=key, winner=res.winner, stamped=stamped,
             min_us=res.timings_min_us, median_us=res.timings_us,
             reps_us=res.reps_us, auto_winner=auto.transport,
             auto_is_winner=same)
        check(stamped == res.winner and same,
              f"{key}: transport='auto' is not the autotune winner")
        plan.transport = "a2a"          # later phases run the a2a stamp
    launches = dict(LAUNCHES)
    emit("transports_launches", **launches)
    for name in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in transports")


def refine_row(A, plan, layout, b, wd, inner_tol, maxiter_inner,
               max_cycles, xh=None) -> dict:
    """One ``make_refine`` solve to 1e-7; the emitted row."""
    import numpy as np
    import torch

    from repro_torch.solvers import make_refine

    refine = make_refine(plan, solver="cg", precond="jacobi", A=A,
                         layout=layout, inner_tol=inner_tol,
                         maxiter_inner=maxiter_inner, wire_dtype=wd,
                         check_every=CHECK_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = refine(b, tol=1e-7, max_cycles=max_cycles)
    seconds = time.perf_counter() - t0
    true_rel = float(np.linalg.norm(b - A.matvec(res.x))
                     / np.linalg.norm(b))
    row = {"rows": A.n_rows, "plan": f"{plan.format}/{plan.n_node}x"
           f"{plan.n_core}", "wire_dtype": wd, "inner_tol": inner_tol,
           "cycles": res.cycles, "inner_iters": res.inner_iters,
           "rel": res.rel, "true_rel": true_rel, "converged": res.converged,
           "history": [r for _, r in res.history], "seconds": seconds}
    if xh is not None:
        row["dx_host"] = float(np.linalg.norm(res.x - xh)
                               / np.linalg.norm(xh))
    check(np.isfinite(res.x).all(), f"refine {wd}: non-finite solution")
    return row


def phase_refine(A, plans, b) -> None:
    """f64 refinement over each wire dtype: full size on the sell 4x2
    plan (f32 must converge), and at refine_check's size (all must)."""
    import numpy as np

    from repro_torch.core import build_spmv_plan
    from repro_torch.core.transport import available_wire_dtypes
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sparse import graded_extruded_mesh_matrix
    from repro_torch.testing.refine_check import host_cg, inner_tol_for

    reset_launches()
    plan, layout = plans["sell/4x2"]
    b64 = b.astype(np.float64)
    for wd in available_wire_dtypes():
        row = refine_row(A, plan, layout, b64, wd, 1e-4, 2000, 20)
        emit("refine", size="full", **row)
        if wd == "f32":
            check(row["converged"] and row["true_rel"] <= 1e-7,
                  f"refine f32 at full size: rel {row['rel']}")
    # refine_check's size, where the reference set its bf16/int8 gate
    As = graded_extruded_mesh_matrix(80, 6, seed=0)
    bs = np.random.default_rng(1).normal(size=As.n_rows)
    xh = host_cg(As, bs, tol=1e-12, maxiter=40_000)
    for wd in available_wire_dtypes():
        ps, ls = build_spmv_plan(As, 4, 2, wire_dtype=wd, device=DEVICE)
        row = refine_row(As, ps, ls, bs, wd, inner_tol_for(wd), 1000, 40,
                         xh=xh)
        emit("refine", size="refine_check", **row)
        check(row["converged"] and row["dx_host"] < 100 * 1e-7,
              f"refine {wd} at refine_check size: rel {row['rel']}, "
              f"dx {row['dx_host']}")
    launches = dict(LAUNCHES)
    emit("refine_launches", **launches)
    for name in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in refine")


SOLVERS = ("cg", "pipelined_cg", "chebyshev")
#: the reference's iteration counts on the golden matrix (4x2, jacobi,
#: RHS default_rng(7).normal) at tol 1e-5 / 3e-6, and its bounds
GOLDEN_REF = {"ell": {"cg": (39, 40), "pipelined_cg": (84, 86),
                      "chebyshev": (906, 994)},
              "sell": {"cg": (39, 40), "pipelined_cg": (84, 85),
                       "chebyshev": (906, 994)}}
#: the gate on each count; pipelined_cg's is reported and not gated: below
#: the f32 plateau its count is set by rounding (PERF.md, Findings)
GOLDEN_SLACK = {"cg": 1, "pipelined_cg": None, "chebyshev": 0}
GOLDEN_BOUNDS = (1.127487e-4, 1.703558)


def phase_solvers(A, plans, b) -> dict:
    """The three registry solvers on the full-size 4x2 plans, then the
    golden gates; returns Chebyshev's options (its bounds) for later
    phases."""
    import numpy as np

    from repro_torch.core import build_spmv_plan, from_dist, to_dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.solvers import (chebyshev_iters_for_tol, make_solver,
                                     reduction_census)
    from repro_torch.sparse import graded_extruded_mesh_matrix

    b64 = b.astype(np.float64)
    cheb_opts = None
    reset_launches()
    for key in ("sell/4x2", "ell/4x2"):
        plan, layout = plans[key]
        bd = to_dist(b, layout, plan)
        for name in SOLVERS:
            t0 = time.perf_counter()
            solve = make_solver(plan, solver=name, precond="jacobi", A=A,
                                layout=layout, check_every=CHECK_EVERY,
                                options=(cheb_opts if name == "chebyshev"
                                         else None))
            build_s = time.perf_counter() - t0
            xs, iters, rel, ms, iters_run = solve_timed(solve, bd, tol=1e-5)
            xg = from_dist(xs, layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                             / np.linalg.norm(b64))
            by_name, launches = profile_solve(solve, bd)
            row = {"plan": key, "solver": name, "iters": iters,
                   "iters_run": iters_run, "rel": rel, "true_rel": true_rel,
                   "ms": ms, "ms_per_iter": ms / max(iters_run, 1),
                   "device_ms_per_iter": sum(by_name.values()) / 64,
                   "launches_per_iter": launches / 64,
                   "census": reduction_census(solve, bd, tol=1e-5),
                   "build_s": build_s}
            if name == "chebyshev":
                row.update(lmin=solve.options["lmin"],
                           lmax=solve.options["lmax"],
                           estimate_s=build_s if cheb_opts is None else None)
                cheb_opts = dict(solve.options)
            emit("solvers", **row)
            check(np.isfinite(xg).all(), f"{key} {name}: non-finite x")
            if name == "chebyshev":
                # the a-priori budget; where the estimated bounds miss the
                # bottom of the spectrum it ends above tol (PERF.md)
                want = chebyshev_iters_for_tol(row["lmin"], row["lmax"],
                                               1e-5)
                check(iters == want, f"{key} chebyshev: {iters} iterations, "
                      f"budget {want}")
            else:
                check(rel <= 1e-5, f"{key} {name}: {iters} iterations, "
                      f"rel {rel}")
            check(row["census"] == {"cg": 2, "pipelined_cg": 1,
                                    "chebyshev": 0}[name],
                  f"{key} {name}: census {row['census']}")
            check(true_rel < (1.0 if name == "chebyshev" else 1e-3),
                  f"{key} {name}: true rel {true_rel}")
    launches = dict(LAUNCHES)
    emit("solvers_launches", **launches)
    for kname in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[kname] > 0, f"{kname} never launched in solvers")

    # the golden matrix, against the reference's counts
    Ag = graded_extruded_mesh_matrix(48, 6, seed=0)
    bg = np.random.default_rng(7).normal(size=Ag.n_rows)
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(Ag, 4, 2, mode="balanced",
                                       node_partition="nnz", format=fmt,
                                       device=DEVICE)
        bd = to_dist(bg, layout, plan)
        for name in SOLVERS:
            solve = make_solver(plan, solver=name, precond="jacobi", A=Ag,
                                layout=layout)
            runs = [solve(bd, tol=tol, maxiter=2000) for tol in (1e-5, 3e-6)]
            iters = [int(it) for _, it, _ in runs]
            rels = [float(rel) for _, _, rel in runs]
            xg = from_dist(runs[0][0], layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(Ag.matvec(xg) - bg)
                             / np.linalg.norm(bg))
            want, slack = GOLDEN_REF[fmt][name], GOLDEN_SLACK[name]
            emit("solvers_golden", format=fmt, solver=name, iters=iters,
                 reference_iters=list(want), slack=slack, rel=rels,
                 true_rel=true_rel,
                 **({"lmin": solve.options["lmin"],
                     "lmax": solve.options["lmax"]}
                    if name == "chebyshev" else {}))
            check(slack is None or all(abs(i - w) <= slack
                                       for i, w in zip(iters, want)),
                  f"golden {fmt} {name}: {iters} vs the reference's {want} "
                  f"± {slack}")
            check(all(r <= t for r, t in zip(rels, (1e-5, 3e-6)))
                  and true_rel < 1e-3,
                  f"golden {fmt} {name}: rel {rels}, true rel {true_rel}")
            if name == "chebyshev":
                for got, ref in zip((solve.options["lmin"],
                                     solve.options["lmax"]), GOLDEN_BOUNDS):
                    check(abs(got - ref) <= 1e-6 * ref,
                          f"golden {fmt} chebyshev bound {got} vs {ref}")
    return cheb_opts


def phase_resilience(plans, b, cheb_opts) -> None:
    """Chunked solves on the full sell 4x2 plan against the monolithic
    ones, NaN and bitflip faults caught, then the kill-and-resume CLI."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import from_dist, to_dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.solvers import (make_resilient, make_solver,
                                     resilient_solve)

    plan, layout = plans["sell/4x2"]
    bd = to_dist(b, layout, plan)
    b64 = b.astype(np.float64)
    every = 50
    reset_launches()
    for name in SOLVERS:
        opts = cheb_opts if name == "chebyshev" else None
        solve = make_solver(plan, solver=name, options=opts,
                            check_every=CHECK_EVERY)
        xs, iters, _, mono_ms, _ = solve_timed(solve, bd, tol=1e-5)
        rs = make_resilient(plan, solver=name, layout=layout, options=opts)
        kw = dict(layout=layout, tol=1e-5, maxiter=10_000,
                  check_every=every, programs=rs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = resilient_solve(plan, b64, **kw)
        chunk_ms = (time.perf_counter() - t0) * 1e3
        same = (int(clean.iters) == iters
                and np.array_equal(clean.x, from_dist(xs, layout, plan)))
        nan = resilient_solve(plan, b64, injector=FaultInjector.parse(
            "nan@60", shard=(1, 1)), **kw)
        flip = resilient_solve(plan, b64, injector=FaultInjector.parse(
            "bitflip@60"), **kw)
        row = {"plan": "sell/4x2", "solver": name, "check_every": every,
               "iters": iters, "chunks": clean.chunks, "rel": float(clean.rel),
               "converged": clean.converged,
               "x_bitwise_monolithic": same,
               "chunked_ms_per_iter": chunk_ms / max(iters, 1),
               "monolithic_ms_per_iter": mono_ms / max(iters, 1),
               "nan_rollbacks": nan.rollbacks, "nan_converged": nan.converged,
               "nan_rel": float(nan.rel),
               "nan_iters": int(nan.iters), "nan_true_rel": nan.true_rel,
               "bitflip_rollbacks": flip.rollbacks,
               "bitflip_converged": flip.converged, "bitflip_rel": float(flip.rel),
               "bitflip_iters": int(flip.iters),
               "bitflip_true_rel": flip.true_rel}
        emit("resilience", **row)
        check(same, f"resilience {name}: chunked x/iterations differ from "
              f"the monolithic solve's ({int(clean.iters)} vs {iters})")
        for kind, res in (("nan@60", nan), ("bitflip@60", flip)):
            # Chebyshev's budget may end above tol at this size (its
            # bounds): a faulted run is held to the clean run's residual
            ok = res.converged or (name == "chebyshev"
                                   and res.rel <= 1.01 * clean.rel)
            check(res.rollbacks >= 1 and ok,
                  f"resilience {name}: {kind} not rolled back, or rel "
                  f"{res.rel} (clean {clean.rel})")
    launches = dict(LAUNCHES)
    emit("resilience_launches", **launches)
    check(launches["fused_sell_spmv"] > 0,
          "fused_sell_spmv never launched in resilience")

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.resilience_check",
         "--device", "cuda"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    lines = res.stdout.strip().splitlines()
    emit("resilience_check", rc=res.returncode, seconds=time.perf_counter()
         - t0, lines=lines, stderr_tail=res.stderr[-2000:])
    check(res.returncode == 0 and lines and lines[-1] == "OK",
          "resilience_check --device cuda did not print OK")


def phase_example() -> None:
    """``examples/cg_solve_torch.py --device cuda`` at its default size."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "cg_solve_torch.py"),
         "--device", "cuda"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=900)
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    check(res.returncode == 0 and lines,
          f"example failed ({res.returncode}): {res.stderr[-3000:]}")
    results = json.loads(lines[-1])
    emit("example", seconds=seconds, lines=lines[:-1], results=results)
    check(results["resilient/cg"]["faulted_rollbacks"] > 0
          and results["resilient/cg"]["faulted_converged"],
          "example: nan@60 not rolled back")
    check([results[f"solver/{n}"]["allreduce_per_iter"] for n in SOLVERS]
          == [2, 1, 0], "example: reduction census is not 2 / 1 / 0")


#: fine rows per aggregate of phase rect's restriction R (80,000 x 1.28M)
RECT_AGG = 16


def restriction(n: int, agg: int):
    """The two-level preconditioner's 0/1 restriction: row ``a`` sums
    fine rows ``[a * agg, (a + 1) * agg)``."""
    import numpy as np

    from repro_torch.sparse import CSRMatrix

    agg_of = np.arange(n, dtype=np.int64) // agg
    return CSRMatrix.from_coo(agg_of, np.arange(n, dtype=np.int64),
                              np.ones(n), (int(agg_of[-1]) + 1, n))


def phase_rect(A, plans, bw, f32_peak) -> tuple[dict, dict]:
    """Rectangular plans at full size: the static checks on A's 4x2 plans,
    R (agg 16, columns pinned to A's rows) and P = Rᵀ (rows pinned to A's,
    columns to R's) built with ``verify=True``, each against a host f64
    matvec, every transport bit for bit a2a, a pinned rebuild bit for bit;
    then ``rect_check --device cuda``.  Launch counts are zeroed before
    and read after that path.  Then each kernel at R's and P's shapes
    against its plain version, timed, with its bound and the library's
    time for the same matrix.  Returns the path's launch counts and the
    kernel rows by label."""
    import numpy as np

    from repro_torch.analysis import check_kernel_streams, check_plan
    from repro_torch.core import (available_transports, build_spmv_plan,
                                  from_dist, make_spmv, to_dist)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.testing import rect_check
    from repro_torch.testing.transport_check import bits_equal

    R = restriction(A.n_rows, RECT_AGG)
    mats = {"R": R, "P": R.transpose()}
    rng = np.random.default_rng(SEED + 2)
    xs = {k: rng.standard_normal(M.n_cols).astype(np.float32)
          for k, M in mats.items()}
    built = {}
    reset_launches()
    for fmt in ("ell", "sell"):
        plan_A, layout_A = plans[f"{fmt}/4x2"]
        t0 = time.perf_counter()
        rep = check_plan(plan_A, layout_A)
        rep.extend(check_kernel_streams(plan_A).violations)
        emit("rect_verify", plan=f"{fmt}/4x2", checks=rep.checks,
             errors=len(rep.errors), warnings=len(rep.warnings),
             seconds=time.perf_counter() - t0)
        check(not rep.errors, f"{fmt}/4x2: {rep.summary()}")
        pins = {"R": {"col_space": layout_A["row_space"]}}
        for key in ("R", "P"):
            M, x = mats[key], xs[key]
            if key == "P":
                pins["P"] = {"row_space": layout_A["row_space"],
                             "col_space": built[(fmt, "R")][1]["row_space"]}
            t0 = time.perf_counter()
            plan, layout = build_spmv_plan(
                M, 4, 2, mode="balanced", node_partition="nnz", format=fmt,
                verify=True, device=DEVICE, **pins[key])
            build_s = time.perf_counter() - t0
            built[(fmt, key)] = (plan, layout)
            xd = to_dist(x, layout, plan, space="col")
            y_ref = make_spmv(plan, transport="a2a")(xd)
            y_host = M.matvec(x.astype(np.float64))
            y = from_dist(y_ref, layout, plan, space="row")
            rel = float(np.abs(y - y_host).max() / np.abs(y_host).max())
            xident = {t: bits_equal(make_spmv(plan, transport=t)(xd), y_ref)
                      for t in available_transports()}
            t0 = time.perf_counter()
            plan2, layout2 = build_spmv_plan(
                M, 4, 2, mode="balanced", node_partition="nnz", format=fmt,
                row_space=layout["row_space"],
                col_space=layout["col_space"], device=DEVICE)
            pin_s = time.perf_counter() - t0
            pin = bits_equal(make_spmv(plan2)(
                to_dist(x, layout2, plan2, space="col")), y_ref)
            del plan2, layout2
            emit("rect", plan=f"{fmt}/4x2", matrix=key, shape=list(M.shape),
                 nnz=M.nnz, rc_pad=plan.rc_pad, cc_pad=plan.cc_pad,
                 nl_pad=plan.nl_pad, g_pad=plan.g_pad, hs=plan.hs,
                 fields={k: list(v.shape) for k, v in plan.fmt_data.items()},
                 build_verify_s=build_s, pinned_build_s=pin_s,
                 host_rel_err=rel, xident=xident, pinned_bitwise=pin)
            check(rel <= 1e-5, f"rect {fmt} {key}: rel err {rel} > 1e-5")
            check(all(xident.values()), f"rect {fmt} {key}: {xident}")
            check(pin, f"rect {fmt} {key}: pinned rebuild differs")
    # rect_check's grid, then halo-free (1x8: B3, B4)
    for grid in ((4, 2), (1, 8)):
        t0 = time.perf_counter()
        rc, lines = run_cli(rect_check.main, [
            "--device", "cuda", "--n-node", str(grid[0]),
            "--n-core", str(grid[1])])
        emit("rect_check", grid=list(grid), rc=rc,
             seconds=time.perf_counter() - t0,
             lines=[ln for ln in lines if not ln.startswith("  ")])
        check(rc == 0 and lines and lines[-1] == "OK",
              f"rect_check --device cuda at {grid} did not print OK")
    launches = dict(LAUNCHES)
    emit("rect_launches", **launches)
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched in rect")

    rows = rect_kernels({f"{fmt}/{key}": (f"{fmt}/4x2/{key}", *pl,
                                          mats[key], xs[key])
                         for (fmt, key), pl in built.items()}, bw, f32_peak)
    del built
    return launches, rows


def rect_kernels(built: dict, bw, f32_peak) -> dict:
    """The kernel at each rectangular plan's shapes against its plain
    version, timed as in phase 3, with the library's time for the same
    matrix (``built``: label -> (plan name, plan, layout, host matrix,
    x)); the rows by label."""
    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.sparse import get_format

    rows = {}
    for label, (name, plan, layout, M, x) in built.items():
        fobj = get_format(plan.format)
        xl, xg = make_shard_body(plan).inputs(
            to_dist(x, layout, plan, space="col"))
        F = plan.fmt_data
        byts, flops, stored = kernel_cost(fobj, F, xl, xg)
        row = measure(
            "rect_kernel", {"kernel": kernel_of(plan.format, xg is not None),
                            "plan": name, "dtype": "float32",
                            "x_local": list(xl.shape),
                            "x_ghost": None if xg is None else list(xg.shape)},
            lambda: fobj.matvec_kernel(F, xl, xg, plan.rc_pad),
            lambda: fobj.matvec_plain(F, xl, xg, plan.rc_pad),
            byts, flops, bw, f32_peak,
            None if stored is None else {"stored": stored})
        row["library_ms"] = library_ms(M, x)
        emit("rect_library", plan=name, ms=row["library_ms"])
        rows[label] = row
    return rows


#: the reference's scaling counts under jax 0.9.0 (ROADMAP A0): CG tol
#: 1e-6 on graded (48, 6/12/24), 4x2 rows-partition ell
SCALING_REF = {"block_jacobi": [43, 37, 41], "two_level": [24, 26, 25]}


def precond_solve(A, plan, layout, b, label: str, pname: str,
                  po: dict | None, base: dict | None = None) -> dict:
    """One cg solve to 1e-6 with a preconditioner: the emitted row.  For
    two_level, the device time of one apply by kernel (10 warm calls),
    and, given ``base`` (the row of its smoother alone on the same plan),
    the coarse correction's device ms per iteration: the difference of
    the two solves' device ms per iteration, and its share."""
    import numpy as np

    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import make_solver, reduction_census

    t0 = time.perf_counter()
    solve = make_solver(plan, solver="cg", precond=pname, A=A,
                        layout=layout, precond_options=po,
                        check_every=CHECK_EVERY)
    build_s = time.perf_counter() - t0
    bd = to_dist(b, layout, plan)
    xs, iters, rel, ms, iters_run = solve_timed(solve, bd)
    xg = from_dist(xs, layout, plan).astype(np.float64)
    b64 = b.astype(np.float64)
    true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                     / np.linalg.norm(b64))
    by_name, launches = profile_solve(solve, bd)
    device_ms = sum(by_name.values()) / 64
    row = {"plan": label, "precond": pname, "options": po, "iters": iters,
           "iters_run": iters_run, "rel": rel, "true_rel": true_rel,
           "ms_per_iter": ms / max(iters_run, 1),
           "device_ms_per_iter": device_ms,
           "launches_per_iter": launches / 64,
           "census": reduction_census(solve, bd, tol=1e-6),
           "build_s": build_s,
           "host_s": getattr(solve.papply, "host_seconds", None)}
    if pname == "two_level":
        r = bd[None]

        def apply():
            return solve.papply(solve.pdata, r)
        apply()
        per, _ = device_profile(lambda: [apply() for _ in range(10)])
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        row.update(apply_device_ms=sum(per.values()) / 10,
                   apply_kernels_ms={n[:60]: t / 10 for n, t in top},
                   nc=int(solve.pdata["ainv_c"].shape[-1]),
                   **{f"{k}_plan": {"rc_pad": pl.rc_pad, "cc_pad": pl.cc_pad,
                                    "hs": pl.hs, "g_pad": pl.g_pad}
                      for k, (pl, _) in solve.papply.plans.items()})
        if base is not None:
            coarse = device_ms - base["device_ms_per_iter"]
            row.update(coarse_device_ms=coarse,
                       coarse_share=coarse / device_ms if device_ms else None,
                       coarse_against=base["precond"])
    emit("precond", **row)
    check(np.isfinite(xg).all(), f"precond {label} {pname}: non-finite x")
    check(rel <= 1e-6, f"precond {label} {pname}: {iters} iterations, "
          f"rel {rel}")
    check(true_rel < 1e-4, f"precond {label} {pname}: true rel {true_rel}")
    check(row["census"] == 2, f"precond {label} {pname}: census "
          f"{row['census']}")
    return row


def phase_precond(A, plans, b) -> dict:
    """The preconditioners on the card: ``precond_check`` (graded, single,
    halofree; faulty caught), the scaling regression beside the
    reference's counts, cg with jacobi / block_jacobi / two_level on the
    32,000-row 4x2 plans, and jacobi then two_level (agg 256, jacobi
    smoother) on the full sell 4x2 plan.  Launch counts are zeroed before
    and read after.  Returns the full plan's two_level row."""
    import numpy as np
    import torch

    from repro_torch.core import build_spmv_plan
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sparse import graded_extruded_mesh_matrix
    from repro_torch.testing import precond_check

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the dense products must run in f32")
    reset_launches()
    for case in precond_check.CASES:
        t0 = time.perf_counter()
        rc, lines = run_cli(precond_check.main,
                            ["--device", "cuda", "--case", case])
        emit("precond_check", case=case, rc=rc, lines=lines,
             seconds=time.perf_counter() - t0)
        check(rc == 0 and lines[-1] == "OK",
              f"precond_check --case {case} did not print OK")
    rc, lines = run_cli(precond_check.main,
                        ["--device", "cuda", "--include-faulty"])
    emit("precond_check", case="graded", include_faulty=True, rc=rc,
         lines=[ln for ln in lines if "faulty" in ln or ln == lines[-1]])
    check(rc == 1 and lines[-1] == "FAIL",
          "precond_check --include-faulty did not fail")

    rc, lines = run_cli(precond_check.main, ["--device", "cuda",
                                             "--scaling"])
    sc = json.loads(next(ln for ln in lines
                         if ln.startswith("SCALING "))[len("SCALING "):])
    emit("precond_scaling", rc=rc, last=lines[-1],
         block_jacobi=sc["block_jacobi"]["iters"],
         two_level=sc["two_level"]["iters"], reference=SCALING_REF,
         tl_flat_ratio=sc["tl_flat_ratio"])
    check(sc["tl_flat_ratio"] <= sc["flat_bound"]
          and all(abs(i - w) <= 1 for i, w in
                  zip(sc["two_level"]["iters"], SCALING_REF["two_level"])),
          f"scaling: two_level {sc['two_level']['iters']} against "
          f"{SCALING_REF['two_level']} ± 1")

    Am = graded_extruded_mesh_matrix(500, 64, seed=0)
    bm = np.random.default_rng(SEED + 3).standard_normal(
        Am.n_rows).astype(np.float32)
    for fmt in ("ell", "sell"):
        t0 = time.perf_counter()
        plan, layout = build_spmv_plan(Am, 4, 2, mode="balanced",
                                       node_partition="rows", format=fmt,
                                       device=DEVICE)
        emit("precond_plan", plan=f"{fmt}/4x2", rows=Am.n_rows, nnz=Am.nnz,
             rc_pad=plan.rc_pad, seconds=time.perf_counter() - t0)
        rows = {}
        for pname, po in (("jacobi", None), ("block_jacobi", None),
                          ("two_level", {"agg_size": 8,
                                         "smoother": "block_jacobi"})):
            rows[pname] = precond_solve(Am, plan, layout, bm,
                                        f"{fmt}/4x2/{Am.n_rows}", pname, po,
                                        base=rows.get("block_jacobi"))
        del plan, layout
    plan, layout = plans["sell/4x2"]
    jacobi = precond_solve(A, plan, layout, b, "sell/4x2", "jacobi", None)
    row = precond_solve(A, plan, layout, b, "sell/4x2", "two_level",
                        {"agg_size": 256, "smoother": "jacobi"}, base=jacobi)
    emit("precond_full", two_level_iters=row["iters"],
         jacobi_iters=jacobi["iters"], ratio=row["iters"] / jacobi["iters"],
         time_to_tol_ms={"jacobi": jacobi["ms_per_iter"]
                         * jacobi["iters_run"],
                         "two_level": row["ms_per_iter"] * row["iters_run"]})
    launches = dict(LAUNCHES)
    emit("precond_launches", **launches)
    # two_level's R and P are ELL plans, halo-free on halofree's 1x8 grid;
    # the solves run A's own kernel (sell_spmv runs on no plan here)
    for name in ("fused_ell_spmv", "ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in precond")
    return row


#: the batched kernels (B1-B4 under vmap): name -> (plan key, the TPU
#: kernel it replaces, batched by vmap over the shard body)
BATCHED = {
    "fused_ell_spmv_batched": (
        "ell/4x2", "src/repro/kernels/spmv_bcsr.py:103 via "
        "src/repro/solvers/base.py:419"),
    "fused_sell_spmv_batched": (
        "sell/4x2", "src/repro/kernels/spmv_bcsr.py:211 via "
        "src/repro/solvers/base.py:419"),
    "ell_spmv_batched": (
        "ell/1x8", "src/repro/kernels/spmv_bcsr.py:58 via "
        "src/repro/solvers/base.py:419"),
    "sell_spmv_batched": (
        "sell/1x8", "src/repro/kernels/spmv_bcsr.py:189 via "
        "src/repro/solvers/base.py:419"),
}
#: the service's batch (nrhs) and chunk; its rows of the ``kernels`` line
#: are the batched kernels at this k
SERVE_NRHS, SERVE_CHECK_EVERY = 4, 25
#: the batch sizes the batched kernels are checked and timed at: every
#: column tile (4, 8, 16), full and with pad columns
SERVE_KS = (1, 3, 4, 8, 16)
SERVE_TOLS = (1e-5, 3e-5, 1e-4)


def spmm_ms(A, k: int) -> float:
    """One torch.sparse CSR x dense (n, k) product of the global matrix
    (cuSPARSE SpMM) — the batched kernels' yardstick only."""
    import torch

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr), torch.from_numpy(A.indices),
        torch.from_numpy(A.data.astype("float32")), size=A.shape,
        device=DEVICE)
    X = torch.randn((A.n_cols, k), device=DEVICE)
    return time_ms(lambda: csr @ X)


def serve_kernels(A, plans, bw, f32_peak, keys: dict | None = None,
                  ks=SERVE_KS) -> dict:
    """Each batched kernel at each k of ``ks`` on its full-size plan
    (``keys``: kernel -> plan key, by default ``BATCHED``'s), f32 and
    bf16: every column bit for bit the single-column kernel, the whole
    within 2e-5·max|y| of the plain version; f32 timed, with the
    interleave copy alone beside it.  Returns the k = SERVE_NRHS rows by
    kernel name."""
    import numpy as np
    import torch

    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.kernels import ops
    from repro_torch.sparse import get_format

    if keys is None:
        keys = {name: key for name, (key, _) in BATCHED.items()}
    rng = np.random.default_rng(SEED + 5)
    lib = {k: spmm_ms(A, k) for k in ks}
    rows = {}
    for name, key in keys.items():
        plan, layout = plans[key]
        fmt = get_format(plan.format)
        body = make_shard_body(plan)
        for k in ks:
            X = torch.stack([to_dist(rng.standard_normal(A.n_rows), layout,
                                     plan) for _ in range(k)])
            xl, xg = body.inputs(X)
            for dtype in (torch.float32, torch.bfloat16):
                F = {kk: (v.to(dtype) if v.is_floating_point() else v)
                     for kk, v in plan.fmt_data.items()}
                y = fmt.matvec_kernel(F, xl, xg, plan.rc_pad)
                same = all(torch.equal(y[j], fmt.matvec_kernel(
                    F, xl[j], None if xg is None else xg[j], plan.rc_pad))
                    for j in range(k))
                torch.cuda.synchronize()
                what = f"{name} k={k} {str(dtype)[6:]}"
                check(same, f"{what}: a column differs from the "
                      "single-column kernel")
                if dtype == torch.bfloat16:
                    want = fmt.matvec_plain(F, xl, xg, plan.rc_pad)
                    err = float((y - want).abs().max())
                    tol = 2e-5 * max(1.0, float(want.abs().max()))
                    emit("serve_kernel", kernel=name, plan=key,
                         dtype="bfloat16", k=k, columns_bitwise_single=same,
                         max_abs_err=err, tol=tol)
                    check(err <= tol, f"{what}: max|err| {err} > {tol}")
                    continue
                x1 = (xl[0], None if xg is None else xg[0])
                one_bytes, one_flops, _ = kernel_cost(fmt, F, *x1)
                mat_bytes = one_bytes - nbytes(*x1)
                inter_ms = time_ms(lambda: (ops.interleave_rhs(xl),
                                            None if xg is None
                                            else ops.interleave_rhs(xg)))
                row = measure(
                    "serve_kernel",
                    {"kernel": name, "plan": key, "dtype": "float32",
                     "k": k, "columns_bitwise_single": same,
                     "interleave_ms": inter_ms,
                     "loop_ms": loop_ms(lambda: fmt.matvec_kernel(
                         F, xl, xg, plan.rc_pad)),
                     "library_ms": lib[k],
                     "library": "torch.sparse CSR x dense (n, k), global "
                                "matrix (cuSPARSE SpMM)"},
                    lambda: fmt.matvec_kernel(F, xl, xg, plan.rc_pad),
                    lambda: fmt.matvec_plain(F, xl, xg, plan.rc_pad),
                    mat_bytes + k * nbytes(*x1), k * one_flops, bw,
                    f32_peak)
                if k == SERVE_NRHS:
                    rows[name] = row
                del F
    return rows


#: the offd passes onto the diag partial (the second launch of the
#: overlapped schedule on a rank): name -> (plan key, columns (``None``:
#: one), the TPU kernel whose offd phase it takes over)
ONTO = {
    "ell_spmv_onto": ("ell/4x2", None,
                      "src/repro/kernels/spmv_bcsr.py:103 (offd phase)"),
    "sell_spmv_onto": ("sell/4x2", None,
                       "src/repro/kernels/spmv_bcsr.py:211 (offd phase)"),
    "ell_spmv_onto_batched": (
        "ell/4x2", SERVE_NRHS, "src/repro/kernels/spmv_bcsr.py:103 (offd "
        "phase) via src/repro/solvers/base.py:419"),
    "sell_spmv_onto_batched": (
        "sell/4x2", SERVE_NRHS, "src/repro/kernels/spmv_bcsr.py:211 (offd "
        "phase) via src/repro/solvers/base.py:419"),
}


def offd_cost(fmt, F, xg) -> tuple[int, int]:
    """``(bytes, flops)`` the offd pass reads from the offd stream and
    one column's ``xg``, as ``kernel_cost`` counts them."""
    if fmt.name == "ell":
        byts, flops, _ = ell_bytes([F["offd_vals"]], [F["offd_cols"]],
                                   [F["offd_len"]], [xg])
        return byts, flops
    names = ("sell_ovals", "sell_ocols", "sell_ostart", "sell_owidth")
    return (nbytes(*(F[k] for k in names), xg),
            2 * F["sell_ovals"].numel())


def offd_csr(plan, F):
    """Every shard's offd block as one torch.sparse CSR on the card, row
    ``shard * rc_pad + slot``, column ``node * (g_pad + 1) + ghost``: the
    library's yardstick for the offd pass (``addmv`` / ``addmm`` onto the
    partial), never called by the port."""
    import numpy as np
    import torch

    shards = plan.shard_shape[0] * plan.shard_shape[1]
    if plan.format == "ell":
        vals = F["offd_vals"].float().cpu().numpy().reshape(
            shards, plan.rc_pad, -1)
        cols = F["offd_cols"].cpu().numpy().reshape(vals.shape)
        s, r, k = np.nonzero(vals)
        rows, col, v = s * plan.rc_pad + r, cols[s, r, k], vals[s, r, k]
    else:
        vals = F["sell_ovals"].float().cpu().numpy().reshape(shards, -1)
        cols = F["sell_ocols"].cpu().numpy().reshape(vals.shape)
        slots = F["sell_orows"].cpu().numpy().reshape(vals.shape)
        s, e = np.nonzero(vals)
        rows, col, v = s * plan.rc_pad + slots[s, e], cols[s, e], vals[s, e]
    col = col + (s // plan.shard_shape[1]) * (plan.g_pad + 1)
    coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, col]).astype(np.int64)),
        torch.from_numpy(v.astype(np.float32)),
        size=(shards * plan.rc_pad, plan.shard_shape[0] * (plan.g_pad + 1)))
    return coo.coalesce().to_sparse_csr().to(DEVICE)


def onto_row(phase: str, name: str, label: str, plan, X, bw: float,
             f32_peak: float) -> dict:
    """The offd pass onto the diag partial at ``plan``'s shapes (``X``:
    one input in the plan's column layout, or a batch of them), f32 and
    bf16 storage: the diag pass then the offd pass bit for bit the fused
    kernel, within 2e-5·max|y| of the plain version.  In f32 the offd
    pass's ms (in place on one partial, 20 CUDA-event runs), the plain
    onto's, the diag pass's, the two passes together and the fused
    kernel's; the bound of the offd pass's bytes (the offd stream, the
    ghosts, ``y`` read and written) and the library's ``addmv`` /
    ``addmm`` of the offd blocks onto the partial.  One ``phase`` line per
    dtype; returns the f32 row."""
    import torch

    from repro_torch.core import make_shard_body
    from repro_torch.sparse import get_format

    fmt, rc = get_format(plan.format), plan.rc_pad
    xl, xg = make_shard_body(plan).inputs(X)
    k = None if X.dim() == 3 else X.shape[0]
    out = None
    for dtype in (torch.float32, torch.bfloat16):
        F = {kk: (v.to(dtype) if v.is_floating_point() else v)
             for kk, v in plan.fmt_data.items()}
        fused = fmt.matvec_kernel(F, xl, xg, rc)
        got = fmt.matvec_offd_onto(F, fmt.matvec_diag(F, xl, rc), xg, rc)
        want = fmt.matvec_plain(F, xl, xg, rc)
        torch.cuda.synchronize()
        bitwise = torch.equal(got.view(torch.int32), fused.view(torch.int32))
        err = float((got - want).abs().max())
        tol = 2e-5 * max(1.0, float(want.abs().max()))
        row = {"kernel": name, "plan": label, "dtype": str(dtype)[6:],
               "k": k, "bitwise_fused": bitwise, "max_abs_err": err,
               "tol": tol}
        if dtype == torch.float32:
            y0 = fmt.matvec_diag(F, xl, rc)
            yp = y0.clone()
            xg1 = xg if k is None else xg[0]
            one_bytes, one_flops = offd_cost(fmt, F, xg1)
            byts = (one_bytes - nbytes(xg1) + nbytes(xg) + 2 * nbytes(y0))
            flops = one_flops * (k or 1)
            bytes_ms, flops_ms = byts / bw * 1e3, flops / f32_peak * 1e3
            csr = offd_csr(plan, F)
            if k is None:
                yf, xf = y0.reshape(-1), xg.reshape(-1)
                lib_y = torch.addmv(yf, csr, xf)
                lib = time_ms(lambda: torch.addmv(yf, csr, xf))
            else:
                yf = y0.reshape(k, -1).T.contiguous()
                xf = xg.reshape(k, -1).T.contiguous()
                lib_y = torch.addmm(yf, csr, xf).T
                lib = time_ms(lambda: torch.addmm(yf, csr, xf))
            lib_err = float((lib_y.reshape(want.shape) - want).abs().max())
            check(lib_err <= tol, f"{name} {label}: the library's addmv/"
                  f"addmm is off the plain version by {lib_err} > {tol}")
            row.update(
                ms=time_ms(lambda: fmt.matvec_offd_onto(F, y0, xg, rc)),
                plain_ms=time_ms(lambda: fmt.matvec_offd_onto(
                    F, yp, xg, rc, "plain")),
                diag_ms=time_ms(lambda: fmt.matvec_diag(F, xl, rc)),
                split_ms=time_ms(lambda: fmt.matvec_offd_onto(
                    F, fmt.matvec_diag(F, xl, rc), xg, rc)),
                fused_ms=time_ms(lambda: fmt.matvec_kernel(F, xl, xg, rc)),
                bytes=byts, flops=flops, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                library_ms=lib, library_max_abs_err=lib_err,
                library="torch.addmv / addmm of the offd blocks as one "
                        "torch.sparse CSR onto the partial (cuSPARSE)")
            out = row
        emit(phase, **row)
        what = f"{name} {label} {row['dtype']}"
        check(bitwise, f"{what}: diag + offd passes differ from the fused "
              "kernel")
        check(got.shape == want.shape and err <= tol,
              f"{what}: max|err| {err} > {tol}")
        del F
    return out


def phase_onto(A, plans, x, bw, f32_peak) -> dict:
    """Phase 3's split two-phase SpMV at the full 4x2 shapes (``ONTO``):
    :func:`onto_row` for each offd pass, single-column on ``x`` and
    batched on ``SERVE_NRHS`` seeded columns; the f32 rows by name."""
    import numpy as np
    import torch

    from repro_torch.core import to_dist

    rng = np.random.default_rng(SEED + 6)
    rows = {}
    for name, (key, k, _) in ONTO.items():
        plan, layout = plans[key]
        X = (to_dist(x, layout, plan) if k is None else torch.stack(
            [to_dist(rng.standard_normal(A.n_rows), layout, plan)
             for _ in range(k)]))
        rows[name] = onto_row("kernel_onto", name, key, plan, X, bw,
                              f32_peak)
    return rows


def serve_bodies(plans) -> None:
    """The batched shard body on the full 4x2 plans: each column bit for
    bit the unbatched body, every transport x wire dtype."""
    import numpy as np
    import torch

    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.core.transport import (available_transports,
                                            available_wire_dtypes)

    rng = np.random.default_rng(SEED + 6)
    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        X = torch.stack([to_dist(rng.standard_normal(plan.n), layout, plan)
                         for _ in range(SERVE_NRHS)])
        bad = []
        for tr in available_transports():
            for wd in available_wire_dtypes():
                body = make_shard_body(plan, transport=tr, wire_dtype=wd)
                y = body(X)
                if not all(torch.equal(y[j], body(X[j]))
                           for j in range(SERVE_NRHS)):
                    bad.append(f"{tr}/{wd}")
        emit("serve_body", plan=key, k=SERVE_NRHS,
             transports=list(available_transports()),
             wire_dtypes=list(available_wire_dtypes()), differ=bad)
        check(not bad, f"{key}: batched body columns differ from the "
              f"unbatched body for {bad}")


def batched_cg(A, plans, B) -> None:
    """make_solver(nrhs=SERVE_NRHS) (cg + jacobi, tol 1e-5) on each
    full-size plan: each column's count within ±1 of its nrhs=None solve,
    true residuals, and (sell 4x2) wall and device ms and launches per
    iteration against SERVE_NRHS sequential solves."""
    import numpy as np
    import torch

    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import make_solver
    from repro_torch.solvers.base import from_dist_batch, to_dist_batch

    k = SERVE_NRHS
    for key, (plan, layout) in plans.items():
        solve_b = make_solver(plan, nrhs=k, check_every=CHECK_EVERY)
        solve_1 = make_solver(plan, check_every=CHECK_EVERY)
        bd = to_dist_batch(B, layout, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xb, ib, rb = solve_b(bd, tol=1e-5, maxiter=10_000)
        torch.cuda.synchronize()
        wall_b = (time.perf_counter() - t0) * 1e3
        ib = [int(v) for v in ib]
        seq = [solve_timed(solve_1, to_dist(B[j], layout, plan), tol=1e-5)
               for j in range(k)]
        X = from_dist_batch(xb, layout, plan).astype(np.float64)
        true_rel = [float(np.linalg.norm(A.matvec(X[j]) - B[j])
                          / np.linalg.norm(B[j])) for j in range(k)]
        seq_true = [float(np.linalg.norm(
            A.matvec(from_dist(x, layout, plan).astype(np.float64)) - B[j])
            / np.linalg.norm(B[j])) for j, (x, *_rest) in enumerate(seq)]
        row = {"plan": key, "nrhs": k, "iters": ib,
               "iters_single": [it for _, it, *_ in seq],
               "true_rel": true_rel, "true_rel_single": seq_true,
               "wall_ms": wall_b,
               "iters_run": -(-max(ib) // CHECK_EVERY) * CHECK_EVERY,
               "sequential_wall_ms": sum(r[3] for r in seq),
               "sequential_iters_run": sum(r[4] for r in seq)}
        row["ms_per_iter"] = wall_b / row["iters_run"]
        row["sequential_ms_per_iter"] = (row["sequential_wall_ms"]
                                         / row["sequential_iters_run"])
        if key == "sell/4x2":
            dev = {}
            for tag, solve, b0 in (("batched", solve_b, bd),
                                   ("single", solve_1,
                                    to_dist(B[0], layout, plan))):
                solve(b0, tol=0.0, maxiter=CHECK_EVERY)          # warm
                box = {}

                def run():
                    box["it"] = solve(b0, tol=0.0, maxiter=64)[1]
                by_name, launches = device_profile(run)
                check(bool((box["it"] == 64).all()),
                      f"{key} {tag} profile: {box['it']} != 64")
                dev[tag] = (sum(by_name.values()) / 64, launches / 64)
            row.update(device_ms_per_iter=dev["batched"][0],
                       launches_per_iter=dev["batched"][1],
                       single_device_ms_per_iter=dev["single"][0],
                       single_launches_per_iter=dev["single"][1])
        emit("serve_batched_cg", **row)
        for j in range(k):
            check(abs(ib[j] - row["iters_single"][j]) <= 1,
                  f"{key} batched cg column {j}: {ib[j]} iterations, alone "
                  f"{row['iters_single'][j]}")
            check(true_rel[j] < 2e-4, f"{key} batched cg column {j}: true "
                  f"rel {true_rel[j]}")
        check(bool((rb <= 1e-5).all()), f"{key} batched cg rel {rb}")


def serve_engine(A, B, N: int) -> dict:
    """The service at full size: N requests (tols cycling SERVE_TOLS)
    through SolveService (sell 4x2, a2a f32, cg + jacobi, nrhs
    SERVE_NRHS, check_every SERVE_CHECK_EVERY) against the same requests
    one at a time through a warm make_solver; a second service over the
    same cache; one splice's survivors against a run without it.
    Returns the service's row."""
    import numpy as np
    import torch

    from repro_torch.core import to_dist
    from repro_torch.serve import EngineConfig, PlanCache, SolveService
    from repro_torch.solvers import make_solver

    tols = [SERVE_TOLS[i % 3] for i in range(N)]
    cache = PlanCache()
    cfg = EngineConfig(nrhs=SERVE_NRHS, n_node=4, n_core=2, format="sell",
                       transport="a2a", wire_dtype="f32", solver="cg",
                       precond="jacobi", check_every=SERVE_CHECK_EVERY)
    t0 = time.perf_counter()
    svc = SolveService(A, cfg, cache=cache, device=DEVICE)
    build_s = time.perf_counter() - t0
    engine = svc.engine
    plan, layout = engine.plan, engine.layout
    seq = make_solver(plan, A=A, layout=layout,
                      neighbor_offsets=layout["neighbor_offsets"])
    seq(to_dist(B[0], layout, plan), tol=1e-5, maxiter=50)       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq_iters = []
    for i in range(N):
        seq_iters.append(seq(to_dist(B[i], layout, plan), tol=tols[i],
                             maxiter=cfg.maxiter)[1])
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    seq_iters = [int(v) for v in seq_iters]

    futs = [svc.submit(B[i], tol=tols[i]) for i in range(N)]
    t0 = time.perf_counter()
    results = svc.drain()
    torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    res = [f.result() for f in futs]
    st = svc.stats()
    latency = [r.queue_s + r.solve_s for r in res]
    row = {"requests": N, "nrhs": SERVE_NRHS,
           "check_every": SERVE_CHECK_EVERY, "tols": list(SERVE_TOLS),
           "build_s": build_s, "served": len(results),
           "iters": [r.iterations for r in res], "iters_sequential":
           seq_iters, "true_rel": [r.residual for r in res],
           "sequential_s": t_seq, "continuous_s": t_cont,
           "speedup": t_seq / t_cont,
           "latency_p50_s": float(np.percentile(latency, 50)),
           "latency_p99_s": float(np.percentile(latency, 99)),
           "solve_p50_s": float(np.percentile([r.solve_s for r in res], 50)),
           "solve_p99_s": float(np.percentile([r.solve_s for r in res], 99)),
           **{k: st[k] for k in ("splices", "chunks", "retired", "failed",
                                 "recompiles", "executables", "cache")}}
    before = dict(cache.stats.as_dict())
    SolveService(A, cfg, cache=cache, device=DEVICE)
    after = cache.stats.as_dict()
    row["second_service_cache"] = after
    hit = (after["plan_hits"] == before["plan_hits"] + 1
           and after["program_hits"] == before["program_hits"] + 1
           and after["plan_misses"] == before["plan_misses"]
           and after["program_misses"] == before["program_misses"]
           and after["compile_s"] == before["compile_s"])
    row["splice_survivors_bitwise"], row["splice_chunks"] = splice_check(
        A, cache, cfg, B)
    emit("serve", **row)
    check(len(results) == N and all(r.iterations > 0 for r in res),
          f"served {len(results)} of {N}")
    check(max(row["true_rel"]) < 2e-4,
          f"service true rel {max(row['true_rel'])}")
    check(st["splices"] >= N, f"{st['splices']} splices for {N} requests")
    check(row["speedup"] >= 1.05, f"continuous {t_cont:.3f} s against "
          f"sequential {t_seq:.3f} s: {row['speedup']:.3f}x < 1.05x")
    check(st["recompiles"] == 0, f"recompiles {st['recompiles']}")
    check(hit, f"second service not a pure cache hit: {before} -> {after}")
    check(row["splice_survivors_bitwise"], "a splice moved a survivor")
    return row


def splice_check(A, cache, cfg, B) -> tuple[bool, int]:
    """Three requests (slot 0's tol loose, so it retires first), with and
    without a fourth spliced into slot 0 mid-solve: the survivors' (slots
    1 and 2) per-chunk iterates must be byte-identical."""
    import torch

    from repro_torch.serve import SolveEngine

    def run(splice: bool) -> list:
        e = SolveEngine(A, cfg, device=DEVICE, cache=cache)
        for i, tol in enumerate((1e-2, 1e-5, 3e-5)):
            e.submit(B[i], tol=tol)
        snaps, added = [], False
        while not e.idle():
            retired = e.step()
            if splice and retired and not added:
                e.submit(B[3], tol=1e-5)
                added = True
            snaps.append(e._state["x"][1:3].clone())
        check(not splice or added, "the splice never happened")
        return snaps

    base, spl = run(False), run(True)
    n = min(len(base), len(spl))
    return all(torch.equal(base[c], spl[c]) for c in range(n)), n


def phase_serve(A, plans, bw, f32_peak) -> tuple[dict, dict]:
    """The batched kernels and body against their single-column versions,
    then the serving path — batched CG on every full-size plan, the
    service, its splice, ``serve_check --device cuda`` — with launch
    counts zeroed just before it and read just after.  Returns the
    batched kernels' launches on that path, their k = SERVE_NRHS rows and
    the service's row."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.testing import serve_check

    rows = serve_kernels(A, plans, bw, f32_peak)
    serve_bodies(plans)
    rng = np.random.default_rng(SEED + 7)
    N = 4 * SERVE_NRHS
    B = rng.standard_normal((N, A.n_rows))
    reset_launches()
    batched_cg(A, plans, B[:SERVE_NRHS])
    service = serve_engine(A, B, N)
    rc, lines = run_cli(serve_check.main, ["--device", "cuda"])
    launches = dict(LAUNCHES)
    emit("serve_check", rc=rc, lines=lines)
    emit("serve_launches", **launches)
    check(rc == 0 and lines[-1] == "OK", f"serve_check: rc {rc}, {lines}")
    for name in BATCHED:
        check(launches[name] > 0, f"{name} never launched on the serving "
              "path")
    return launches, rows, service


def phase_analyze(plans) -> None:
    """The verifier's sweep on the card, then the recorded census of the
    full-size 4x2 plans against ``predicted_cost``; launch counts zeroed
    just before and read just after."""
    import torch

    from repro_torch.analysis.trace_pass import derived_wire_bytes
    from repro_torch.core import make_spmv
    from repro_torch.core.collectives import (COLLECTIVE_OPS, census,
                                              record_collectives)
    from repro_torch.core.transport import (available_transports,
                                            available_wire_dtypes,
                                            resolve_transport)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.testing import analyze

    reset_launches()
    t_phase = time.perf_counter()
    for flags, want_rc in ((["--hlo"], 0), (["--include-faulty"], 1)):
        t0 = time.perf_counter()
        rc, lines = run_cli(analyze.main, ["--device", DEVICE, *flags])
        rep = json.loads(lines[-1])
        emit("analyze", flags=flags, rc=rc, checks=rep["checks"],
             errors=rep["errors"], warnings=rep["warnings"],
             summary=rep["summary"], sweep_seconds=rep["wall_s"],
             seconds=round(time.perf_counter() - t0, 3), verdict=lines[-2])
        check(rc == want_rc, f"analyze {flags}: rc {rc}, want {want_rc}")
        if want_rc:
            check("J_PAYLOAD_TRANSFORM" in rep["summary"],
                  "analyze --include-faulty: faulty not flagged")
        else:
            check(rep["errors"] == 0, f"analyze: {rep['summary']}")
    t_census = time.perf_counter()
    for key in ("ell/4x2", "sell/4x2"):
        plan, _ = plans[key]
        for name in available_transports():
            for wd in available_wire_dtypes():
                spmv = make_spmv(plan, transport=name, wire_dtype=wd)
                with record_collectives() as log:
                    spmv(plan.mask_col)
                torch.cuda.synchronize()
                got = census(log)
                tr, state = resolve_transport(name, plan, wire_dtype=wd)
                pred = tr.predicted_cost(plan, state)
                want = {k: int(pred.get(k, 0)) + (k == "all-gather")
                        for k in COLLECTIVE_OPS}
                wire = derived_wire_bytes(log, plan.n_node, plan.n_core)
                emit("analyze", census_of=key, transport=name,
                     wire_dtype=wd, census={k: v for k, v in got.items()
                                            if v},
                     predicted=pred, derived_wire_bytes=wire)
                check(got == want, f"{key} {name} {wd}: census {got}, "
                      f"predicted {want}")
                check(wire == pred["wire_bytes"], f"{key} {name} {wd}: "
                      f"derived {wire} != predicted {pred['wire_bytes']}")
    launches = dict(LAUNCHES)
    now = time.perf_counter()
    emit("analyze_launches", seconds=round(now - t_phase, 3),
         census_seconds=round(now - t_census, 3), **launches)
    for name in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in phase analyze")


def phase_cli(full_rows) -> None:
    """The test CLIs and the quickstart on the card, in this process, with
    launch counts zeroed just before and read just after."""
    import contextlib
    import io
    import runpy

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.testing import bench_spmv, dist_check, square_golden

    reset_launches()
    t_phase = time.perf_counter()
    grid = ["--device", DEVICE, "--n-node", "4", "--n-core", "2"]
    solve = [*grid, "--mode", "balanced", "--fused", "--solver", "all",
             "--nrhs", "4"]
    for argv in (solve, [*solve, "--check-every", "25", "--inject-fault",
                         "nan@30"],
                 ["--device", DEVICE, "--n-node", "1", "--n-core", "8",
                  "--format", "sell", "--cg"]):
        t0 = time.perf_counter()
        rc, lines = run_cli(dist_check.main, argv)
        emit("cli", cli="dist_check", argv=argv, rc=rc, lines=lines,
             seconds=round(time.perf_counter() - t0, 3))
        check(rc == 0 and lines[-1] == "OK", f"dist_check {argv}: {lines}")

    rc, lines = run_cli(square_golden.main, [
        "--device", DEVICE, "--check",
        str(ROOT / "tests" / "golden_square_hashes.json")])
    skips = [ln for ln in lines if ln.startswith("SKIP")]
    emit("cli", cli="square_golden", rc=rc, verdict=lines[-1],
         skipped=len(skips), fails=[ln for ln in lines
                                    if ln.startswith("FAIL")])
    check(rc == 0 and lines[-1].endswith("0 failures, 16 skipped")
          and len(skips) == 16, f"square_golden: {lines[-3:]}")

    full = [*grid, "--matrix", "graded", "--n-surface", str(N_SURFACE),
            "--layers", str(LAYERS), "--format", "sell"]
    bench = {}
    for what, flags in (("sweep", ["--transport", "a2a,ring,pairwise,hier"]),
                        ("cg", ["--cg", "--fused", "--tol", "1e-6",
                                "--iters", "10000"])):
        t0 = time.perf_counter()
        rc, lines = run_cli(bench_spmv.main, [*full, *flags])
        bench[what] = out = json.loads(lines[-1])
        emit("cli", cli="bench_spmv", what=what, rc=rc, result=out,
             seconds=round(time.perf_counter() - t0, 3))
        check(rc == 0, f"bench_spmv {what}: rc {rc}")
    for name, row in bench["sweep"]["transports"].items():
        check(row["traced_wire_bytes"] == row["predicted"]["wire_bytes"],
              f"bench_spmv {name}: traced != predicted wire bytes")
    cg, ref = bench["cg"], full_rows["sell/4x2"]
    emit("cli", bench_vs_full="sell/4x2",
         bench_us_per_spmv=bench["sweep"]["transports"]["a2a"][
             "us_per_spmv"],
         full_spmv_ms=ref["spmv_ms"], bench_us_per_iter=cg["us_per_iter"],
         bench_cg_iters=cg["cg_iters"],
         full_ms_per_iter=ref["fused"]["ms_per_iter"],
         full_iters=ref["fused"]["iters"])
    check(cg["cg_rel"] <= 1e-6, f"bench_spmv --cg: {cg['cg_iters']} "
          f"iterations, rel {cg['cg_rel']}")

    out, argv = io.StringIO(), sys.argv
    sys.argv = ["quickstart_torch.py", "--device", DEVICE]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    lines = out.getvalue().strip().splitlines()
    emit("cli", cli="quickstart_torch", lines=lines)
    errs = [float(ln.split()[-1]) for ln in lines if "SpMV max err" in ln]
    check(len(errs) == 3 and max(errs) < 1e-4 and len(lines) == 9,
          f"quickstart: {lines}")

    launches = dict(LAUNCHES)
    emit("cli_launches", seconds=round(time.perf_counter() - t_phase, 3),
         **launches)
    for name in (*KERNELS, "fused_ell_spmv_batched"):
        check(launches[name] > 0, f"{name} never launched in phase cli")


#: phase lm: the full-width models it serves, one after the other, and
#: the requests each gets (16 greedy steps: 32 put the whole script near
#: its time limit once phase train came)
LM_ARCHS = ("qwen2.5-3b", "xlstm-350m", "zamba2-1.2b")
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = 4, 512, 576, 16
#: phase lm's reduced-size parity, card against CPU: every arch the
#: port serves, and the request shape
LM_REDUCED = ("yi-34b", "stablelm-1.6b", "qwen2.5-3b", "granite-3-8b",
              "chameleon-34b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
              "whisper-large-v3", "xlstm-350m", "zamba2-1.2b")
LM_B, LM_S = 2, 32
LM_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
#: the bf16-compute bound of the recurrent stacks (xlstm, zamba), card
#: against CPU at reduced() and the first step against forward_train at
#: full width: about twice the largest reading (4.7e-2, zamba's first
#: step at full width on an H100; 4.2e-2, xlstm's forward against the
#: reference's on the CPU; 2.7e-2, xlstm's forward card against CPU).
#: Two bf16 runs of a deep recurrence on random weights drift a few %
#: apart; the f32 checks beside each (1e-4) are what a wrong step fails
LM_BF16_RECURRENT = 1e-1
#: the cache groups that hold recurrent states (read and written whole at
#: every step); every other cache tensor is a KV cache (read)
LM_STATES = ("mlstm", "slstm", "mamba")


def lm_bound(cfg, compute: str) -> float:
    """The relative bound of an arch's outputs at one compute dtype."""
    if compute == "bfloat16" and cfg.block_pattern in ("xlstm", "zamba"):
        return LM_BF16_RECURRENT
    return LM_BOUND[compute]


def lm_err(got, want, what: str) -> float:
    """``max|got - want| / max(1, max|want|)`` on host float32 copies."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{what}: {got.shape} != {want.shape}")
    check(finite(got), f"{what}: non-finite values")
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def lm_close(got, want, rel: float, what: str) -> float:
    """``lm_err`` over ``rel``, raising when above 1."""
    err = lm_err(got, want, what)
    check(err <= rel, f"{what}: relative error {err} > {rel}")
    return err / rel


def finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def lm_leaves(cache: dict, path: tuple = ()):
    """``(path, tensor)`` for every tensor of a (nested) cache."""
    for key, v in cache.items():
        if isinstance(v, dict):
            yield from lm_leaves(v, path + (key,))
        else:
            yield path + (key,), v


def lm_clone(cache: dict, device=None, dtype=None) -> dict:
    """A copy of every tensor of a (nested) cache, on ``device`` and in
    ``dtype`` (each tensor's own when None)."""
    return {k: (lm_clone(v, device, dtype) if isinstance(v, dict)
                else v.to(device=device, dtype=dtype).clone())
            for k, v in cache.items()}


def lm_rows(cache: dict, rows: list, end: int | None = None) -> dict:
    """Batch rows ``rows`` of every cache group (layer dim first, batch
    second): a KV tensor up to position ``end`` (whole when None), a
    recurrent state whole.  Whisper's cross caches (top-level tensors) are
    left out."""
    return {g: {k: (v[:, rows] if g in LM_STATES or end is None
                    else v[:, rows, :end]) for k, v in group.items()}
            for g, group in cache.items() if isinstance(group, dict)}


def lm_close_cache(got: dict, want: dict, rel: float, what: str) -> int:
    """Every float32 cache tensor (a recurrent state) within
    ``rel·max(1, max|want|)``.  Every bf16 one (KV caches, the mamba conv
    state) within one bf16 step at its largest magnitude (the storage's
    resolution: a rounding flip in an early layer's written slot moves
    later layers' keys and values by ~1e-4 of their size), and at most
    1e-3 of its elements past ``rel·max(1, max|want|)``.  Returns the
    bf16 elements past the bound."""
    import torch

    from repro_torch.testing.tolerance import bf16_step

    gl, wl = list(lm_leaves(got)), list(lm_leaves(want))
    check([p for p, _ in gl] == [p for p, _ in wl], f"{what}: layout")
    flips = 0
    for (path, g), (_, w) in zip(gl, wl):
        name = ".".join((what, *path))
        check(g.dtype == w.dtype, f"{name}: dtype")
        if w.dtype == torch.float32:
            lm_close(g, w, rel, name)
            continue
        g, w = g.float().cpu(), w.float().cpu()
        check(g.shape == w.shape, f"{name}: shape")
        if not w.numel():
            continue
        top = float(w.abs().max())
        bound = rel * max(1.0, top)
        diff = (g - w).abs()
        n = int((diff > bound).sum())
        check(float(diff.max()) <= max(bound, bf16_step(top)),
              f"{name}: max {float(diff.max())} past one bf16 step at {top}")
        check(n <= 1e-3 * w.numel(), f"{name}: {n} elements past {bound}")
        flips += n
    return flips


def lm_run(model, cfg, toks, nxt, frames, cache=None) -> dict:
    """forward_train, prefill and decode_step (scalar ``pos`` = S) on the
    model's device, each with its routing; the decode starts from
    ``cache`` when given (a prefill cache of the other device), else from
    this run's prefill."""
    from repro_torch.models import model as lm
    from repro_torch.models.moe import record_routing

    dev = next(model.parameters()).device
    t, n = toks.to(dev), nxt.to(dev)
    f = None if frames is None else frames.to(dev)
    out = {}
    with record_routing() as log:
        out["forward"] = lm.forward_train(model, cfg, t, frames=f)
    out["forward_routes"] = log
    with record_routing() as log:
        pre, last = lm.prefill(model, cfg, t, lm.init_cache(
            cfg, LM_B, LM_S + 8, device=dev), frames=f)
    out["prefill"], out["prefill_routes"] = (pre, last), log
    start = lm_clone(pre if cache is None else cache, dev)
    with record_routing() as log:
        out["decode"] = lm.decode_step(model, cfg, n, start, LM_S)
    out["decode_routes"] = log
    return out


def lm_parity(name: str, compute: str, seed: int) -> dict:
    """One reduced arch at one compute dtype, card against CPU on one
    seeded weight set (made on the CPU, copied to the card)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm
    from repro_torch.models.moe import NEAR_TIE, first_divergence, top_k_gap

    cfg = dataclasses.replace(get_config(name).reduced(),
                              compute_dtype=compute)
    if cfg.moe is not None and compute == "bfloat16":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=64.0))
    host = lm.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    card = copy.deepcopy(host).to(DEVICE)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_B, LM_S)))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_B, 1)))
    frames = (torch.from_numpy(rng.standard_normal(
        (LM_B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
        if cfg.is_encdec else None)
    want = lm_run(host, cfg, toks, nxt, frames)
    got = lm_run(card, cfg, toks, nxt, frames, cache=want["prefill"][0])
    rel = lm_bound(cfg, compute)
    row = {"arch": name, "compute": compute}
    # where the routing parts (bf16 only), each row is held up to its
    # first swapped token, and the swap must be a near-tie
    keep = {}
    for which in ("forward", "prefill", "decode"):
        first = [None] * LM_B
        if cfg.moe is not None:
            K = cfg.moe.top_k
            w = [r.gate_idx.reshape(LM_B, -1, K).cpu().numpy()
                 for r in want[f"{which}_routes"]]
            g = [r.gate_idx.reshape(LM_B, -1, K).cpu().numpy()
                 for r in got[f"{which}_routes"]]
            first = first_divergence(w, g)
            for b, hit in enumerate(first):
                if hit is None:
                    continue
                check(compute == "bfloat16", f"lm {name} {compute} "
                      f"{which}: routing differs at row {b}, {hit}")
                tok, layer = hit
                probs = want[f"{which}_routes"][layer].probs
                gap = float(top_k_gap(probs.reshape(LM_B, -1, probs.shape[-1])
                                      [b, tok].cpu(), K))
                check(gap <= NEAR_TIE, f"lm {name} {which}: routing "
                      f"swap at row {b} {hit} with gap {gap}")
            row[f"{which}_swaps"] = [h for h in first if h is not None]
        keep[which] = [LM_S if h is None else h[0] for h in first]
    errs = {}
    (lg, aux), (lw, auxw) = got["forward"], want["forward"]
    check(all(keep["forward"]), f"lm {name} {compute}: a row's first "
          "token routed differently")
    if not any(row.get("forward_swaps", ())):
        for k in auxw:
            lm_close(aux[k], auxw[k], rel, f"lm {name} {compute} {k}")
    (cg, lastg), (cw, lastw) = got["prefill"], want["prefill"]
    (dg, dcg), (dw, dcw) = got["decode"], want["decode"]
    what = f"lm {name} {compute}"
    errs["forward"] = max(lm_close(lg[b, :e], lw[b, :e], rel,
                                   f"{what} forward row {b}")
                          for b, e in enumerate(keep["forward"]))
    flips = 0
    for b, e in enumerate(keep["prefill"]):
        if e == LM_S:
            errs["prefill"] = max(errs.get("prefill", 0.0), lm_close(
                lastg[b], lastw[b], rel, f"{what} prefill"))
        flips += lm_close_cache(lm_rows(cg, [b], e), lm_rows(cw, [b], e),
                                rel, f"{what} prefill cache")
    if cfg.is_encdec:
        flips += lm_close_cache({k: cg[k] for k in ("cross_k", "cross_v")},
                                {k: cw[k] for k in ("cross_k", "cross_v")},
                                rel, f"{what} cross cache")
    rows = [b for b, e in enumerate(keep["decode"]) if e == LM_S]
    check(bool(rows), f"{what}: every decode row swapped")
    errs["decode"] = max(lm_close(dg[b], dw[b], rel, f"{what} decode")
                         for b in rows)
    # the cache the step wrote into, row by row
    flips += lm_close_cache(lm_rows(dcg, rows), lm_rows(dcw, rows), rel,
                            f"{what} decode cache")
    row.update(errors=errs, cache_flips=flips, bound=rel)
    return row


def lm_full(name: str, bw: float, smi: str) -> None:
    """One arch at full width and depth through ``init_params`` →
    ``init_cache`` → ``prefill`` → greedy ``decode_step``, with its gates
    and lines; frees its tensors before returning."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    cfg = get_config(name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    emit("lm", what="init", arch=name, params=n_params,
         n_params_cfg=cfg.n_params(), param_bytes=param_bytes,
         param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
         seconds=round(time.perf_counter() - t0, 3))

    B, P = LM_BATCH, LM_PROMPT
    rng = np.random.default_rng(SEED + 7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).to(DEVICE)
    cache = lm.init_cache(cfg, B, LM_MAX_LEN, device=DEVICE)
    state_bytes = nbytes(*(t for path, t in lm_leaves(cache)
                           if path[0] in LM_STATES))
    kv_bytes = nbytes(*(t for path, t in lm_leaves(cache)
                        if path[0] not in LM_STATES))
    prefill_ms = time_ms(lambda: lm.prefill(params, cfg, toks, cache),
                         reps=3, warmup=1)
    by_name, pre_launches = device_profile(
        lambda: lm.prefill(params, cfg, toks, cache))
    pre_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    cache, last = lm.prefill(params, cfg, toks, cache)
    full, _ = lm.forward_train(params, cfg, toks)
    check(finite(last) and finite(full),
          f"lm {name}: non-finite prefill / forward logits")
    same = torch.equal(last[:, 0], full[:, -1])
    diff = float((last[:, 0].float() - full[:, -1].float()).abs().max())
    emit("lm", what="prefill", arch=name, batch=B, prompt=P,
         max_len=LM_MAX_LEN, ms=prefill_ms,
         tokens_per_s=B * P / (prefill_ms / 1e3),
         device_ms=sum(by_name.values()), launches=pre_launches,
         top5_device_ms={k[:80]: v for k, v in pre_top},
         last_equals_forward_bits=same, last_vs_forward_max_abs=diff)
    check(same or diff <= 1e-5, f"lm {name}: prefill's last logits differ "
          f"from forward_train's by {diff} (> 1e-5)")
    del full

    # the first greedy step twice, (B,) pos and scalar pos, same bits
    nt = last[:, 0, :cfg.vocab].argmax(-1, keepdim=True)
    pos = torch.full((B,), P, dtype=torch.int32, device=DEVICE)
    other = lm_clone(cache)
    first, cache = lm.decode_step(params, cfg, nt, cache, pos)
    first_s, other = lm.decode_step(params, cfg, nt, other, P)
    same = (torch.equal(first, first_s)
            and all(torch.equal(a, b) for (_, a), (_, b)
                    in zip(lm_leaves(cache), lm_leaves(other))))
    del other
    ext = torch.cat([toks, nt], 1)
    full, _ = lm.forward_train(params, cfg, ext)
    err = lm_err(first, full[:, -1], f"lm {name} first step")
    rel = lm_bound(cfg, cfg.compute_dtype)
    del full
    # the peak memory of serving: the f32 check below is left out of it
    peak = torch.cuda.max_memory_allocated()
    # the same step at f32 compute with every cache tensor in f32 (the KV
    # caches and the conv state serve in bf16): prefill and one step
    # against forward_train on the 513 tokens, all at f32, where the two
    # forms of the model agree to f32 rounding
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    c32, _ = lm.prefill(params, cfg32, toks, lm_clone(
        lm.init_cache(cfg, B, LM_MAX_LEN, device=DEVICE),
        dtype=torch.float32))
    step32, _ = lm.decode_step(params, cfg32, nt, c32, pos)
    del c32
    full, _ = lm.forward_train(params, cfg32, ext)
    err32 = lm_err(step32, full[:, -1], f"lm {name} f32 first step")
    rel32 = LM_BOUND["float32"]
    del full, step32
    torch.cuda.reset_peak_memory_stats()
    emit("lm", what="first_step", arch=name,
         scalar_pos_equals_vector_bits=same, vs_forward_rel=err, bound=rel,
         f32_vs_forward_rel=err32, f32_bound=rel32)
    check(same, f"lm {name}: scalar-pos decode differs from (B,)-pos "
          "decode")
    check(finite(first) and err <= rel,
          f"lm {name}: first decode step vs forward_train {err} > {rel}")
    check(err32 <= rel32, f"lm {name}: f32 first decode step vs "
          f"forward_train {err32} > {rel32}")

    # the rest of the greedy steps, each between two CUDA events
    events, logits = [], first
    ok = torch.isfinite(first).all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_STEPS - 1):
        nt = logits[:, :cfg.vocab].argmax(-1, keepdim=True)
        pos = pos + 1
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        logits, cache = lm.decode_step(params, cfg, nt, cache, pos)
        ev[1].record()
        events.append(ev)
        ok &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = [s.elapsed_time(e) for s, e in events]
    check(bool(ok), f"lm {name}: non-finite decode logits")
    nt = logits[:, :cfg.vocab].argmax(-1, keepdim=True)
    by_name, launches = device_profile(
        lambda: lm.decode_step(params, cfg, nt, cache, pos + 1))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    decode_ms = statistics.median(steps)
    device_ms = sum(by_name.values())
    # a step reads the parameters as stored and the KV caches, and reads
    # and writes every recurrent state
    bound_bytes = param_bytes + 2 * state_bytes + kv_bytes
    bound_ms = bound_bytes / bw * 1e3
    emit("lm", what="decode", arch=name, steps=LM_STEPS,
         ms_per_step=decode_ms, ms_min=min(steps), ms_max=max(steps),
         wall_ms_per_step=wall / (LM_STEPS - 1) * 1e3,
         device_ms_per_step=device_ms,
         tokens_per_s=B / (decode_ms / 1e3), bound_ms=bound_ms,
         bound_bytes=bound_bytes, state_bytes=state_bytes,
         kv_bytes=kv_bytes, bound_by="bytes",
         of_bound=decode_ms / bound_ms, launches_per_step=launches,
         top5_device_ms={k[:80]: v for k, v in top},
         max_memory_allocated=max(peak, torch.cuda.max_memory_allocated()),
         nvidia_smi=smi)
    del params, cache, logits, first, last
    torch.cuda.empty_cache()


def phase_lm(bw: float, smi: str) -> None:
    """6n: the LM serving path.  Each of ``LM_ARCHS`` at full width in
    turn (``lm_full``); then every arch at ``reduced()``, card against
    CPU.  Frees its tensors before returning (phase procmesh spawns ranks
    on this card next)."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the f32 parity (and the sLSTM's f32 "
          "recurrent product) must run in f32")
    reset_launches()
    t_phase = time.perf_counter()
    for name in LM_ARCHS:
        lm_full(name, bw, smi)

    # every arch runs; the phase fails after the last if any failed
    failed = []
    for name in LM_REDUCED:
        for compute in ("float32", "bfloat16"):
            try:
                emit("lm_reduced", **lm_parity(name, compute, SEED))
            except RuntimeError as e:
                emit("lm_reduced", arch=name, compute=compute,
                     failed=str(e))
                failed.append(str(e))
    torch.cuda.empty_cache()
    check(not failed, f"lm: {len(failed)} reduced runs failed: {failed}")
    port = {k: v for k, v in LAUNCHES.items() if v}
    emit("lm", what="port_kernels", launched=port,
         seconds=round(time.perf_counter() - t_phase, 3),
         statement="the LM path launches none of the port's CUDA kernels: "
                   "its products are torch.matmul (cuBLAS) and its "
                   "elementwise work and scans PyTorch's own kernels")
    check(not port, f"lm: the port's SpMV kernels launched: {port}")


#: phase train: the arch trained at full width, its batch (B x S tokens
#: from the port's TokenPipeline), steps, learning rate, the steps a
#: second run repeats (bit for bit), and whether each of the steps it
#: runs after them is in the deterministic mode: alternated, in ABBA
#: order, so that the mode's cost is read within one run.  The gated
#: run's rate is 3e-5: at 3e-4 the loss of the randomly initialised
#: 36-layer model rose over the 8 steps (12.0 → 13.8 on an H100; 3e-5
#: falls to 8.3)
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 512, 8, 3e-5
TRAIN_REPEAT = 3
TRAIN_ALTERNATE = (False, True, True, False, False, True)
#: the step along -g/|g| of the full-width gradient check, and how far
#: the loss's drop may be from TRAIN_EPS·|g| (relative)
TRAIN_EPS, TRAIN_EPS_BOUND = 1e-2, 0.1
#: phase train's flash-attention shapes: (B, S, H, KV, dh, causal) of
#: qwen2.5-3b's attention at the trained batch, and whisper's encoder
TRAIN_FLASH = {"qwen2.5-3b": (4, 512, 16, 2, 128, True),
               "whisper-large-v3/encoder": (4, 1500, 20, 20, 64, False)}
TRAIN_FLASH_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
#: phase train's gradient bound, card against CPU at f32: per reference
#: leaf, of its own max|g| plus of the tree's
TRAIN_GRAD_LEAF, TRAIN_GRAD_TREE = 1e-4, 1e-6
#: the CLI resume check: arch (at reduced()), batch, sequence, steps and
#: the checkpoint it resumes from
TRAIN_CLI = ("xlstm-350m", 2, 64, 8, 4)


def bf16_peak(name: str) -> float:
    """The card's dense bf16 rate (data sheets: H100 SXM 989 TFLOP/s,
    PCIe 756)."""
    return 756e12 if "pcie" in name.lower() else 989e12


def train_flash(smi: str) -> None:
    """6o (a): ``flash_attention``'s backward at full width against
    autograd through its plain forward, at f32 and bf16, with fwd+bwd ms
    beside ``scaled_dot_product_attention``'s (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import common as pc

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for label, (B, S, H, KV, dh, causal) in TRAIN_FLASH.items():
        for dtype, rel in TRAIN_FLASH_BOUND.items():
            dt = getattr(torch, dtype)
            q, k, v, do = (torch.randn(s, generator=gen, device=DEVICE)
                           .to(dt) for s in ((B, S, H, dh), (B, S, KV, dh),
                                             (B, S, KV, dh), (B, S, H, dh)))
            for t in (q, k, v):
                t.requires_grad_(True)
            # the model's chunking (attention_train's chunk_q / chunk_k)
            cq, ck = pc._pick_chunk(S, 512), pc._pick_chunk(S, 1024)

            def fn():
                out = pc.flash_attention(q, k, v, causal=causal,
                                         chunk_q=512, chunk_k=1024)
                return torch.autograd.grad(out, (q, k, v), do)

            def plain():
                out = pc._flash_fwd_impl(q, k, v, causal, 0, cq, ck)[0]
                return torch.autograd.grad(out, (q, k, v), do)

            def sdpa():
                out = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True)
                return torch.autograd.grad(out, (q, k, v),
                                           do.transpose(1, 2))

            got, want = fn(), plain()
            errs = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                check(finite(g), f"train flash {label} {dtype}: {name} "
                      "not finite")
                top = float(w.float().abs().max())
                errs[name] = float((g.float() - w.float()).abs().max()) / top
                check(errs[name] <= rel, f"train flash {label} {dtype}: "
                      f"{name} {errs[name]} of max|ref| > {rel}")
            emit("train_flash", shape=label, batch=B, seq=S, heads=H,
                 kv_heads=KV, d_head=dh, causal=causal, dtype=dtype,
                 tiles=[S // cq, S // ck], rel_err=errs, bound=rel,
                 fwd_bwd_ms=time_ms(fn, reps=5, warmup=1),
                 plain_fwd_bwd_ms=time_ms(plain, reps=5, warmup=1),
                 sdpa_fwd_bwd_ms=time_ms(sdpa, reps=5, warmup=1),
                 nvidia_smi=smi)
            del q, k, v, do, got, want
    torch.cuda.empty_cache()


def train_grads(model, cfg, batch) -> dict:
    """``loss_fn``'s gradient in the reference's layout (numpy float32)
    and the loss."""
    import numpy as np
    import torch

    from repro_torch.models import model as lm

    dev = next(model.parameters()).device
    for p in model.parameters():
        p.grad = None
    loss, _ = lm.loss_fn(model, cfg, {k: v.to(dev) for k, v in
                                      batch.items()})
    loss.backward()
    grads = lm.to_reference({k: p.grad for k, p in
                             model.named_parameters()})
    for p in model.parameters():
        p.grad = None
    return {"loss": float(loss.detach()), "grads": grads,
            "finite": all(bool(np.isfinite(a).all())
                          for _, a in lm_leaves(grads))}


def train_reduced(name: str) -> dict:
    """6o (b) for one arch at ``reduced()``: the f32 gradient card against
    CPU on one seeded weight set; ``full`` / ``dots`` / ``none`` bit for
    bit on the card; every bf16 gradient finite."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as lm

    base = get_config(name).reduced()
    cfg = dataclasses.replace(base, compute_dtype="float32")
    host = lm.init_params(cfg, torch.Generator().manual_seed(SEED),
                          device="cpu", trainable=True)
    card = copy.deepcopy(host).to(DEVICE)
    rng = np.random.default_rng(SEED + 11)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     (LM_B, LM_S)))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (LM_B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    want = train_grads(host, cfg, batch)
    runs = {}
    for policy in ("full", "dots", "none"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        runs[policy] = train_grads(card, c, batch)
    got = runs[cfg.remat_policy]
    wl = [a for _, a in lm_leaves(want["grads"])]
    gl = [a for _, a in lm_leaves(got["grads"])]
    check(len(wl) == len(gl), f"train {name}: gradient trees differ")
    top = max(float(np.abs(w).max()) for w in wl)
    worst = 0.0
    for w, g in zip(wl, gl):
        check(bool(np.isfinite(g).all()), f"train {name}: non-finite f32 "
              "gradient on the card")
        bound = TRAIN_GRAD_LEAF * float(np.abs(w).max()) \
            + TRAIN_GRAD_TREE * top
        worst = max(worst, float(np.abs(g - w).max()) / bound)
    check(worst <= 1.0, f"train {name}: f32 gradient card vs CPU at "
          f"{worst} of its bound")
    same = {p: all(np.array_equal(a, b) for (_, a), b in zip(
        lm_leaves(runs[p]["grads"]), gl)) for p in runs}
    check(all(same.values()), f"train {name}: remat policies differ on the "
          f"card: {same}")
    bf = train_grads(card, dataclasses.replace(
        cfg, compute_dtype="bfloat16"), batch)
    check(bf["finite"] and np.isfinite(bf["loss"]),
          f"train {name}: non-finite bf16 gradient")
    del host, card
    return {"arch": name, "remat_policy": cfg.remat_policy,
            "f32_loss_card": got["loss"], "f32_loss_cpu": want["loss"],
            "f32_grad_of_bound": worst, "remat_bits_equal": same,
            "bf16_loss": bf["loss"], "bf16_grads_finite": bf["finite"]}


def train_resume_cli() -> dict:
    """6o (b): the trainer's CLI on the card (in process): an
    uninterrupted run with a checkpoint every 4 steps, then only the
    step-4 checkpoint resumed to the end; losses and the last
    checkpoint's arrays bit for bit."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.train import main as train_main

    arch, B, S, steps, at = TRAIN_CLI
    with tempfile.TemporaryDirectory() as tmp:
        def argv(d, extra=()):
            return ["--arch", arch, "--reduced", "--steps", str(steps),
                    "--batch", str(B), "--seq", str(S),
                    "--ckpt-dir", f"{tmp}/{d}/ckpt",
                    "--ckpt-every", str(at), "--log-every", str(steps),
                    "--metrics-out", f"{tmp}/{d}.json", "--device", DEVICE,
                    *extra]
        t0 = time.perf_counter()
        rc, _ = run_cli(train_main, argv("whole"))
        check(rc == 0, f"train cli: uninterrupted run exit {rc}")
        step_dir = f"step_{at:09d}"
        shutil.copytree(f"{tmp}/whole/ckpt/{step_dir}",
                        f"{tmp}/part/ckpt/{step_dir}")
        rc, out = run_cli(train_main, argv("part", ["--resume"]))
        check(rc == 0, f"train cli: resumed run exit {rc}")
        check(any(f"resumed from step {at}" in ln for ln in out),
              "train cli: the run did not resume")
        with open(f"{tmp}/whole.json") as f:
            whole = json.load(f)
        with open(f"{tmp}/part.json") as f:
            part = json.load(f)
        last = f"step_{steps:09d}"
        a = np.load(f"{tmp}/whole/ckpt/{last}/arrays.npz")
        b = np.load(f"{tmp}/part/ckpt/{last}/arrays.npz")
        arrays_same = a.files == b.files and all(
            a[k].tobytes() == b[k].tobytes() for k in a.files)
        losses_same = whole["losses"][at:] == part["losses"]
        n_arrays = len(a.files)
    check(losses_same, f"train cli: resumed losses {part['losses']} != "
          f"{whole['losses'][at:]}")
    check(arrays_same, "train cli: the resumed run's last checkpoint "
          "differs from the uninterrupted run's")
    check(whole["loss_decreased"], "train cli: the loss did not fall")
    return {"arch": arch, "batch": B, "seq": S, "steps": steps,
            "resumed_from": at, "losses": whole["losses"],
            "losses_bits_equal": losses_same,
            "checkpoint_bits_equal": arrays_same, "arrays": n_arrays,
            "seconds": round(time.perf_counter() - t0, 3)}


def train_checksums(model) -> list:
    """Each parameter's int64 sum of its float32 bits."""
    import torch

    return torch.stack([p.detach().view(torch.int32).to(torch.int64).sum()
                        for p in model.parameters()]).tolist()


def train_full(bw: float, smi: str) -> None:
    """6o (c): qwen2.5-3b trained at full width.  First the gradient at
    init along its own direction (the loss must fall by ``eps·|g|`` for a
    step of ``eps`` along ``-g/|g|``); then 8 steps of ``make_train_step``
    (AdamW) in the deterministic mode; a second run of the first steps
    from the same seed, bit for bit, continued with steps that alternate
    without and with the deterministic mode (its cost)."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import deterministic, make_train_step
    from repro_torch.models import model as lm
    from repro_torch.optim import AdamWConfig, global_norm, init_opt

    cfg = get_config(TRAIN_ARCH)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=TRAIN_B,
                         seq_len=TRAIN_S, seed=SEED)
    batches = [torch.from_numpy(pipe.batch_at(i)).to(DEVICE)
               for i in range(TRAIN_STEPS + 1)]

    def init():
        return lm.init_params(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(SEED), device=DEVICE,
                              trainable=True)

    def start():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init()
        opt = init_opt(dict(model.named_parameters()))
        torch.cuda.synchronize()
        return model, opt, time.perf_counter() - t0

    def run(step_fn, model, opt, first, n):
        """Steps ``first`` .. ``first + n - 1``: losses, grad norms and
        CUDA-event ms of each."""
        losses, norms, ms = [], [], []
        for i in range(first, first + n):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            model, opt, loss, met = step_fn(model, opt,
                                            {"tokens": batches[i]})
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
            norms.append(float(met["grad_norm"]))
        return model, opt, losses, norms, ms

    # the gradient at full width: a step of TRAIN_EPS along -g/|g| lowers
    # the loss by TRAIN_EPS·|g| to first order
    clock = {"start": time.perf_counter()}

    def lap(name):
        now = time.perf_counter()
        clock[name], clock["start"] = now - clock["start"], now
    with deterministic():
        model = init()
        first = {"tokens": batches[0]}
        # the loss alone: its metrics' graph would keep the parameters
        loss0 = lm.loss_fn(model, cfg, first)[0]
        loss0.backward()
        gnorm = float(global_norm({k: p.grad for k, p in
                                   model.named_parameters()}))
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(TRAIN_EPS / gnorm * p.grad)
                p.grad = None
            loss1 = float(lm.loss_fn(model, cfg, first)[0])
        loss0 = float(loss0.detach())
    del model
    torch.cuda.empty_cache()
    lap("direction")
    drop, predicted = loss0 - loss1, TRAIN_EPS * gnorm
    emit("train", what="direction", arch=TRAIN_ARCH, loss=loss0,
         grad_norm=gnorm, eps=TRAIN_EPS, loss_drop=drop,
         predicted_drop=predicted, bound=TRAIN_EPS_BOUND)
    check(abs(drop - predicted) <= TRAIN_EPS_BOUND * predicted,
          f"train {TRAIN_ARCH}: a step of {TRAIN_EPS} along the gradient "
          f"lowered the loss by {drop}, not {predicted}")

    step_fn = make_train_step(cfg, AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, opt, init_s = start()
    n_params = sum(p.numel() for p in model.parameters())
    with deterministic():
        model, opt, losses, norms, ms = run(step_fn, model, opt, 0,
                                            TRAIN_REPEAT)
        sums = train_checksums(model)
        model, opt, l2, n2, ms2 = run(step_fn, model, opt, TRAIN_REPEAT,
                                      TRAIN_STEPS - TRAIN_REPEAT)
        losses, norms, ms = losses + l2, norms + n2, ms + ms2
        peak = torch.cuda.max_memory_allocated()
        lap("run")
        box = {}

        def one_step():
            box["r"] = step_fn(model, opt, {"tokens": batches[TRAIN_STEPS]})
        by_name, launches = device_profile(one_step, cpu=False)
        lap("profile")
    del box, model, opt
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train {TRAIN_ARCH}: non-finite loss or grad norm: {losses} "
          f"{norms}")
    check(losses[-1] < losses[0], f"train {TRAIN_ARCH}: the loss did not "
          f"fall: {losses}")

    # the same seed again: the first steps bit for bit, then on with and
    # without the deterministic mode in turn, for its cost
    model, opt, _ = start()
    with deterministic():
        model, opt, again, _, _ = run(step_fn, model, opt, 0, TRAIN_REPEAT)
    sums_again = train_checksums(model)
    alt = {True: [], False: []}
    for i, det in enumerate(TRAIN_ALTERNATE, TRAIN_REPEAT):
        with deterministic() if det else contextlib.nullcontext():
            model, opt, _, _, (t,) = run(step_fn, model, opt, i, 1)
        alt[det].append(t)
    del model, opt
    torch.cuda.empty_cache()
    lap("repeat")
    check(again == losses[:TRAIN_REPEAT], f"train {TRAIN_ARCH}: a second "
          f"run's losses {again} != {losses[:TRAIN_REPEAT]}")
    check(sums_again == sums, f"train {TRAIN_ARCH}: a second run's "
          "parameter checksums differ")

    tokens = TRAIN_B * TRAIN_S
    step_ms = statistics.median(ms[1:])
    peak_bf16 = bf16_peak(torch.cuda.get_device_name(0))
    flops_ms = 8 * n_params * tokens / peak_bf16 * 1e3
    adamw_ms = 28 * n_params / bw * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    emit("train", what="full", arch=TRAIN_ARCH, params=n_params,
         remat=cfg.remat, remat_policy=cfg.remat_policy,
         compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
         batch=TRAIN_B, seq=TRAIN_S, tokens_per_step=tokens, lr=TRAIN_LR,
         warmup_steps=1, init_seconds=round(init_s, 3), losses=losses,
         grad_norms=norms, loss_decreased=losses[-1] < losses[0],
         step_ms=ms, ms_per_step=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3),
         repeat_losses_bits_equal=again == losses[:TRAIN_REPEAT],
         repeat_checksums_equal=sums_again == sums,
         repeat_steps=TRAIN_REPEAT,
         alternate_steps=list(range(TRAIN_REPEAT + 1, TRAIN_REPEAT + 1
                                    + len(TRAIN_ALTERNATE))),
         alternate_deterministic=list(TRAIN_ALTERNATE),
         deterministic_ms=alt[True], nondeterministic_ms=alt[False],
         deterministic_cost=statistics.median(alt[True])
         / statistics.median(alt[False]) - 1,
         device_ms_per_step=sum(by_name.values()),
         launches_per_step=launches,
         top5_device_ms=dict(top),
         bound_ms=flops_ms + adamw_ms, bound_flops_ms=flops_ms,
         bound_adamw_ms=adamw_ms, bf16_peak_tflop_s=peak_bf16 / 1e12,
         share_of_peak=6 * n_params * tokens / (step_ms / 1e3 * peak_bf16),
         max_memory_allocated=peak, nvidia_smi=smi,
         seconds={k: round(v, 3) for k, v in clock.items() if k != "start"})


def phase_train(bw: float, smi: str) -> None:
    """6o: training.  (a) the flash backward at full width; (b) every
    arch at ``reduced()``: the f32 gradient card against CPU, the remat
    policies bit for bit, bf16 gradients finite, and the trainer's CLI
    resumed bit for bit; (c) qwen2.5-3b trained at full width.  No port
    kernel may launch.  Frees its tensors before returning."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import deterministic

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the f32 gradient parity must run in f32")
    reset_launches()
    t_phase = time.perf_counter()
    train_flash(smi)
    emit("train", what="flash_seconds",
         seconds=round(time.perf_counter() - t_phase, 3))
    failed = []
    with deterministic():
        for name in LM_REDUCED:
            try:
                t0 = time.perf_counter()
                row = train_reduced(name)
                emit("train_reduced", **row,
                     seconds=round(time.perf_counter() - t0, 3))
            except RuntimeError as e:
                emit("train_reduced", arch=name, failed=str(e))
                failed.append(str(e))
    torch.cuda.empty_cache()
    check(not failed, f"train: {len(failed)} reduced archs failed: "
          f"{failed}")
    emit("train_cli", **train_resume_cli())
    train_full(bw, smi)
    port = {k: v for k, v in LAUNCHES.items() if v}
    emit("train", what="port_kernels", launched=port,
         seconds=round(time.perf_counter() - t_phase, 3),
         statement="the training path launches none of the port's CUDA "
                   "kernels: its products are torch.matmul (cuBLAS), the "
                   "rest PyTorch's own kernels")
    check(not port, f"train: the port's SpMV kernels launched: {port}")


#: phase procmesh's plans, run on 8 ranks of one card
PROCMESH_PLANS = ("ell/4x2", "sell/4x2")
PROCMESH_HALOFREE = ("ell/1x8", "sell/1x8")
#: phase procmesh's service: the first requests of phase serve's queue
#: (five, so that one is spliced in mid-solve; eight made the script run
#: past its time)
PROCMESH_REQUESTS = 5
#: phase procmesh's two_level: phase precond's full-plan options
PROCMESH_TWO_LEVEL = {"agg_size": 256, "smoother": "jacobi"}
#: phase procmesh's alternated modes: the full sell 4x2 plan on equal
#: rows (``vector`` and ``task`` share it; ``balanced`` runs on its own
#: nnz plan, ``sell/4x2``), and the tol of its cg per mode: 1e-2 keeps
#: the two solves well under the 1e-6 one's 515 iterations (1e-3 took
#: 254; gloo's loopback costs ~37 ms an iteration), so the phase's added
#: time stays under 15%
PROCMESH_MODES = {"sell/4x2/rows": ("vector", "task")}
PROCMESH_MODES_TOL = 1e-2
#: phase procmesh's cg: on the balanced sell plan only (the one its layers
#: build on; the ell plan runs its SpMV), to 1e-3 (~250 iterations, not
#: 1e-6's 515 at gloo's 40-140 ms), and its resilient driver to the same
#: tol: they keep the default run near 900 s with phase dryrun added
PROCMESH_SOLVE, PROCMESH_TOL = "sell/4x2", 1e-3


def rows_plan(A, key: str, device):
    """The plan of a ``<format>/<grid>/rows`` key: the grid on equal rows
    (mode ``vector``; ``task`` shares its partition), a2a."""
    from repro_torch.core import build_spmv_plan

    fmt, grid, _ = key.split("/")
    t0 = time.perf_counter()
    plan, layout = build_spmv_plan(A, *(int(v) for v in grid.split("x")),
                                   mode="vector", format=fmt,
                                   transport="a2a", device=device)
    emit("plan", plan=key, seconds=round(time.perf_counter() - t0, 3),
         rc_pad=plan.rc_pad, hs=plan.hs)
    return plan, layout


def sum_launches(rows) -> dict:
    """Kernel launches summed over ``rows`` (each with ``launches``)."""
    total = {}
    for r in rows:
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def report_modes(phase: str, A, b64, smi, plans: dict, ranks: list,
                 want: dict) -> tuple[dict, dict]:
    """``mesh_report`` for every plan of ``plans`` in every mode it ran,
    ``modes_report`` where it ran more than one: ``(the lines by key and
    mode, the launches summed over every rank, plan and mode)``."""
    lines, runs = {}, []
    for key, (plan, layout) in plans.items():
        res = {mode: [r[key][mode] for r in ranks] for mode in ranks[0][key]}
        for mode, rr in res.items():
            lines[key, mode] = mesh_report(phase, A, b64, smi, key, plan,
                                           layout, rr, want[key], mode)
            runs += rr
        if len(res) > 1:
            modes_report(phase, smi, key,
                         {m: lines[key, m] for m in res}, res)
    return lines, sum_launches(runs)


def mesh_rank(mesh, job: dict) -> dict:
    """One rank of a process-mesh phase (``procmesh`` on gloo, ``nccl``
    one rank per card).  For each of ``job["keys"]`` (its grid a further
    mesh over the spawned group where it differs), in each of its modes
    (``job["modes"][key]``, alternated; by default the plan's own): one
    SpMV (``y``, the a2a ghosts, launches, the schedule), one batched
    SpMV of ``SERVE_NRHS`` columns (each column bit for bit the
    single-column body) and ms per SpMV (median of ``REPS`` CUDA-event
    runs, each started with every card idle and the ranks released
    together by a barrier, host control, not timed; the modes in turns),
    with the wire's ms by kind and its exposed ms, and the diag pass's ms
    alone; ``job["transports"][key]`` more transports under the last
    mode, each ``y`` against a2a's; for those in ``job["solve"]`` cg +
    jacobi to ``job["tol"]`` (default 1e-6) after a warm block (wall ms,
    the wire, launches, ``x``) and, with ``job["profile"]``, its device
    profile.  ``out[key][mode]``.  Then the wire probe on each mesh that
    solved (``job["wheres"]``; ``job["host_split"]`` adds
    ``host_split``), ``job["sweep"]`` (``transport_check``'s process
    sweep) and ``job["layers"]``, the layers above the solvers
    (``procmesh_layers``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import make_exchange, make_shard_body, make_spmv
    from repro_torch.core.collectives import (CONTROL, WIRE, reset_wire,
                                              wire_seconds)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_cg_mesh, read_plan
    from repro_torch.solvers import make_solver
    from repro_torch.sparse import get_format
    from repro_torch.testing.transport_check import rank_sweep

    def sync():
        torch.cuda.synchronize(mesh.device)

    def vec(key, name, m):
        a = np.load(f"{job['vecs'][key]}/{name}.npy", mmap_mode="r")
        return torch.from_numpy(np.array(
            a[m.node:m.node + 1, m.core:m.core + 1])).to(m.device)

    def wire_ms(by_kind) -> dict:
        return {k: v * 1e3 for k, v in by_kind.items() if k != CONTROL}

    def timed_runs(m, fns: dict) -> dict:
        """``REPS`` timed calls of each of ``fns`` (name -> call), in
        turns: ms, the wire's ms by kind and the wire's and exposed ms of
        each call."""
        got = {n: {"times": [], "by_kind": {}, "wire": [], "exposed": []}
               for n in fns}
        for _ in range(REPS):
            for n, fn in fns.items():
                sync()
                m.barrier()
                reset_wire()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                g = got[n]
                g["times"].append(start.elapsed_time(end))
                for k, v in WIRE["by_kind"].items():
                    g["by_kind"][k] = g["by_kind"].get(k, 0.0) + v
                w, e = wire_seconds()
                g["wire"].append(w * 1e3)
                g["exposed"].append(e * 1e3)
        return {n: {"spmv_ms": statistics.median(g["times"]),
                    "spmv_wire_ms_by_kind": {
                        k: v / REPS for k, v in wire_ms(g["by_kind"]).items()},
                    "spmv_wire_ms": statistics.median(g["wire"]),
                    "spmv_exposed_ms": statistics.median(g["exposed"])}
                for n, g in got.items()}

    meshes = {(mesh.n_node, mesh.n_core): mesh}
    solved = []
    out = {"device": str(mesh.device)}
    for key in job["keys"]:
        shape = tuple(int(v) for v in key.split("/")[1].split("x"))
        if shape not in meshes:
            meshes[shape] = make_cg_mesh(*shape, device=mesh.device,
                                         backend=mesh.backend,
                                         rank=mesh.rank,
                                         world_size=mesh.world_size)
        m = meshes[shape]
        base = read_plan(job["dirs"][key], m)
        modes = tuple(job.get("modes", {}).get(key, (base.mode,)))
        plans = {mode: dataclasses.replace(base, mode=mode)
                 for mode in modes}
        x, b = vec(key, "x", m), vec(key, "b", m)
        X = torch.stack([x, b, -x, 2 * b])
        ghost = make_exchange(base, "a2a")(x) if base.hs else None
        rows = {}
        for mode, plan in plans.items():
            body = make_shard_body(plan)
            reset_launches()
            y = body(x)
            Y = body(X)
            sync()
            launches = dict(LAUNCHES)
            rows[mode] = {
                "y": y.cpu().numpy(), "launches": launches,
                "ghost": None if ghost is None else ghost.cpu().numpy(),
                "schedule": [" ".join(st) for st in body.schedule],
                "batched_bitwise": all(torch.equal(Y[j], body(X[j]))
                                       for j in range(len(X)))}
        spmvs = {mode: make_spmv(plan) for mode, plan in plans.items()}
        for _ in range(3):
            for spmv in spmvs.values():
                spmv(x)
        for mode, t in timed_runs(m, {mode: (lambda f=f: f(x))
                                      for mode, f in spmvs.items()}).items():
            rows[mode].update(t)
        if base.hs:
            fmt = get_format(base.format)
            xl, _ = make_shard_body(base).inputs(x)
            diag_ms = time_ms(lambda: fmt.matvec_diag(base.fmt_data, xl,
                                                      base.rc_pad))
            for row in rows.values():
                row["diag_ms"] = diag_ms
        last = modes[-1]
        extra = {t: make_spmv(plans[last], transport=t)
                 for t in job.get("transports", {}).get(key, ())}
        for t, spmv in extra.items():
            yt = spmv(x)
            rows[last].setdefault("transports", {})[t] = {
                "bitwise_a2a": np.array_equal(
                    yt.cpu().numpy().view(np.int32),
                    rows[last]["y"].view(np.int32)),
                **timed_runs(m, {t: lambda f=spmv: f(x)})[t]}
        if key in job["solve"]:
            tol = job.get("tol", {}).get(key, 1e-6)
            for mode, plan in plans.items():
                row = rows[mode]
                solve = make_solver(plan, solver="cg", precond="jacobi",
                                    check_every=CHECK_EVERY)
                solve(b, tol=0.0, maxiter=CHECK_EVERY)          # warm
                sync()
                m.barrier()
                reset_wire()
                reset_launches()
                t0 = time.perf_counter()
                xs, iters, rel = solve(b, tol=tol, maxiter=10_000)
                sync()
                w, e = wire_seconds()
                row.update(ms=(time.perf_counter() - t0) * 1e3, tol=tol,
                           wire={"calls": WIRE["calls"],
                                 "bytes": WIRE["bytes"],
                                 "ms_by_kind": wire_ms(WIRE["by_kind"]),
                                 "ms": w * 1e3, "exposed_ms": e * 1e3},
                           iters=int(iters), rel=float(rel),
                           x=xs.cpu().numpy())
                for k, v in LAUNCHES.items():
                    row["launches"][k] = row["launches"].get(k, 0) + v
                if job.get("profile"):
                    host = {}
                    prof, dev = profile_solve(solve, b, NCCL_PROFILE_ITERS,
                                              host=host)
                    row.update(
                        device_ms_per_iter=sum(prof.values())
                        / NCCL_PROFILE_ITERS,
                        nccl_ms_per_iter=sum(t for n, t in prof.items()
                                             if "nccl" in n.lower())
                        / NCCL_PROFILE_ITERS,
                        device_launches_per_iter=dev / NCCL_PROFILE_ITERS,
                        host_c10d_ms_per_iter={k: v / NCCL_PROFILE_ITERS
                                               for k, v in host.items()})
                del solve
            if shape not in solved:
                solved.append(shape)
        out[key] = rows
        del base, plans, spmvs, extra
    out["wire_probe"] = {}
    for n, c in solved:
        probe = wire_probe(meshes[(n, c)], sync, wheres=job["wheres"])
        if job.get("host_split"):
            probe.update(host_split(meshes[(n, c)], sync))
        out["wire_probe"][f"{n}x{c}"] = probe
    if job.get("sweep"):
        shape = tuple(job["sweep"][0]["shape"])
        out["sweep"] = rank_sweep(meshes.get(shape, mesh), job["sweep"])
    if job.get("layers"):
        lj = job["layers"]
        layers = dict(lj, dirs=job["dirs"], b={
            k: np.load(f"{job['vecs'][k]}/b.npy", mmap_mode="r")
            for k in lj["keys"]})
        shape = tuple(int(v) for v in lj["sell"].split("/")[1].split("x"))
        mono = next(iter(out[lj["sell"]].values()))
        out["layers"] = procmesh_layers(meshes[shape], layers, sync, mono)
    return out


def procmesh_layers(mesh, job, sync, mono: dict) -> dict:
    """The layers above the solvers on one rank of a process mesh (phase
    ``procmesh``, or ``nccl``'s 2x2): the autotuner on ``job["keys"]``'s
    plans, then on the sell plan ``job["sell"]`` two_level and the
    resilient driver (chunks of 50: clean, against ``mono``, this rank's
    monolithic solve, and with ``nan@60`` at ``job["nan_shard"]``), then
    the service on the mesh's grid.  Launch counts and the wire are zeroed
    just before each run and read just after."""
    import numpy as np
    import torch

    from repro_torch.core.collectives import WIRE, reset_wire
    from repro_torch.core.transport import autotune_transport
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import read_plan
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.serve import EngineConfig, PlanCache, SolveService
    from repro_torch.solvers import make_solver, resilient_solve

    def start():
        sync()
        reset_launches()
        reset_wire()
        return time.perf_counter()

    def done(t0) -> dict:
        sync()
        return {"ms": (time.perf_counter() - t0) * 1e3,
                "launches": dict(LAUNCHES), "wire": dict(WIRE)}

    out = {"auto": {}}
    A, layout, b = job["A"], job["layout"], job["b_global"]
    for key in job["keys"]:
        plan = read_plan(job["dirs"][key], mesh)
        t0 = time.perf_counter()
        res = autotune_transport(plan, iters=5, reps=3)
        out["auto"][key] = {"winner": res.winner, "us": res.timings_us,
                            "min_us": res.timings_min_us,
                            "seconds": time.perf_counter() - t0}
        del plan

    plan = read_plan(job["dirs"][job["sell"]], mesh)
    bd = torch.from_numpy(np.array(job["b"][job["sell"]][
        mesh.node:mesh.node + 1, mesh.core:mesh.core + 1])).to(mesh.device)
    t0 = time.perf_counter()
    solve = make_solver(plan, solver="cg", precond="two_level", A=A,
                        layout=layout, precond_options=PROCMESH_TWO_LEVEL,
                        check_every=CHECK_EVERY)
    build_s = time.perf_counter() - t0
    t0 = start()
    xs, iters, rel = solve(bd, tol=1e-6, maxiter=10_000)
    out["two_level"] = {"iters": int(iters), "rel": float(rel),
                        "x": xs.cpu().numpy(), "build_s": build_s,
                        "host_s": solve.papply.host_seconds, **done(t0)}
    del solve

    # chunked = monolithic: every rank holds the whole x, and its rows
    # must be its monolithic shard's bits (the verdicts read the chunks'
    # device probe; resilience_check below reads the host residual)
    kw = dict(layout=layout, tol=mono["tol"], maxiter=10_000,
              check_every=50)
    t0 = start()
    clean = resilient_solve(plan, b, **kw)
    row = done(t0)
    g = layout["global_row_of"][mesh.node, mesh.core]
    row.update(
        iters=int(clean.iters), chunks=clean.chunks, rel=float(clean.rel),
        true_rel=clean.true_rel, rollbacks=clean.rollbacks,
        x_bitwise_monolithic=bool(int(clean.iters) == mono["iters"]
                                  and np.array_equal(
                                      clean.x[g[g >= 0]].view(np.int32),
                                      mono["x"][0, 0][g >= 0].view(
                                          np.int32))))
    nan = resilient_solve(plan, b, injector=FaultInjector.parse(
        "nan@60", shard=job["nan_shard"]), **kw)
    row.update(nan_rollbacks=nan.rollbacks, nan_iters=int(nan.iters),
               nan_converged=nan.converged, nan_rel=float(nan.rel),
               nan_trajectory=nan.trajectory)
    out["resilient"] = row
    del plan

    cfg = EngineConfig(nrhs=SERVE_NRHS, n_node=mesh.n_node,
                       n_core=mesh.n_core, format="sell",
                       transport="a2a", wire_dtype="f32", solver="cg",
                       precond="jacobi", check_every=SERVE_CHECK_EVERY)
    t0 = time.perf_counter()
    svc = SolveService(A, cfg, cache=PlanCache(), mesh=mesh)
    build_s = time.perf_counter() - t0
    if mesh.rank == 0:          # phase serve's first requests, its tols
        B = np.random.default_rng(SEED + 7).standard_normal(
            (4 * SERVE_NRHS, A.n_rows))
        for i in range(PROCMESH_REQUESTS):
            svc.submit(B[i], tol=SERVE_TOLS[i % 3])
    t0 = start()
    res = svc.drain()
    row = done(t0)
    st = svc.stats()
    row.update(build_s=build_s, iters=[r.iterations for r in res],
               true_rel=[r.residual for r in res],
               **{k: st[k] for k in ("splices", "chunks", "retired",
                                     "recompiles")})
    out["serve"] = row
    return out


def wire_probe(mesh, sync, calls: int = 50,
               wheres=("host", "card")) -> dict:
    """ms per call of the process mesh's collectives on host tensors and
    on the card's, same payloads: what gloo's loopback costs alone, and
    what staging through the host adds on the card (an NCCL mesh takes
    card tensors only).  A ``psum`` of one float over the world; a
    core-axis ``all_gather`` of one ``x`` shard of the full 4x2 plans
    (353,760 floats).  ``<op>_<where>_ms``: ``calls`` calls back to back
    between two syncs; on the card also ``<op>_card_issue_us``, the
    host's time to issue one call (before the closing sync), and
    ``<op>_card_sync_ms``, one call followed by a sync, each started from
    a barrier."""
    import torch

    from repro_torch.core.collectives import all_gather, psum

    def per_call(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        issued = time.perf_counter()
        sync()
        return ((time.perf_counter() - t0) * 1e3 / calls,
                (issued - t0) * 1e6 / calls)

    def round_trip(fn):
        times = []
        for _ in range(REPS):
            sync()
            mesh.barrier()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {}
    for where in wheres:
        dev = "cpu" if where == "host" else mesh.device
        one = torch.ones((1, 1), device=dev)
        x = torch.ones((1, 1, 353_760), device=dev)
        for op, fn in (("psum", lambda: psum(one, mesh=mesh)),
                       ("gather", lambda: all_gather(x, "core",
                                                     mesh=mesh))):
            out[f"{op}_{where}_ms"], issue = per_call(fn)
            if where == "card":
                out[f"{op}_card_issue_us"] = issue
                out[f"{op}_card_sync_ms"] = round_trip(fn)
    return out


def host_split(mesh, sync, calls: int = 50) -> dict:
    """What a collective costs the issuing host apart from the port, each
    ``calls`` times back to back, issued (µs a call, before the closing
    sync) and done (ms a call): ``launch_*`` one elementwise kernel (the
    host's launch cost), ``direct_*`` NCCL without c10d (an
    ``all_gather`` of one float on a one-card communicator of this
    rank's card, ``torch.cuda.nccl``), ``bare_*`` c10d alone (an
    ``all_gather_into_tensor`` of one float a rank over the world group;
    no events, no port code).  Also the host's CPUs and this rank's
    affinity and threads; then ``bare_*`` and ``wire_probe``'s card
    probe again with every thread of each rank pinned to its own share
    of the CPUs (``pinned_*``), and the affinity put back."""
    import os

    import torch
    import torch.distributed as dist

    inp = torch.ones(1, device=mesh.device)
    got = torch.empty(mesh.world_size, device=mesh.device)
    one = torch.empty(1, device=mesh.device)

    def per_call(fn):
        fn()
        sync()
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        issued = time.perf_counter()
        sync()
        return ((issued - t0) * 1e6 / calls,
                (time.perf_counter() - t0) * 1e3 / calls)

    def bare():
        return per_call(lambda: dist.all_gather_into_tensor(
            got, inp, group=mesh.world))

    def pin(cpus):
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), cpus)
            except ProcessLookupError:      # a thread that has ended
                pass

    cpus = sorted(os.sched_getaffinity(0))
    out = {"cpus": os.cpu_count(), "affinity": len(cpus),
           "threads": len(os.listdir("/proc/self/task")),
           "torch_threads": torch.get_num_threads()}
    out["launch_issue_us"], out["launch_ms"] = per_call(lambda: inp.mul_(1))
    if mesh.device.type == "cuda":
        out["direct_issue_us"], out["direct_ms"] = per_call(
            lambda: torch.cuda.nccl.all_gather([inp], [one]))
    out["bare_gather_issue_us"], out["bare_gather_ms"] = bare()
    share = len(cpus) // mesh.world_size
    mine = cpus[mesh.rank * share:(mesh.rank + 1) * share] or cpus
    pin(mine)
    try:
        out["pinned_cpus"] = len(mine)
        (out["pinned_bare_gather_issue_us"],
         out["pinned_bare_gather_ms"]) = bare()
        out.update({f"pinned_{k}": v for k, v in wire_probe(
            mesh, sync, calls, wheres=("card",)).items()})
    finally:
        pin(cpus)
    return out


def write_job(plans: dict, x, b, d: str) -> dict:
    """Write each of ``plans`` (key -> (plan, layout)) and its
    distributed ``x`` and ``b`` under ``d``, for the ranks of a spawned
    mesh to read their rows of: the job's ``keys``, ``dirs`` and
    ``vecs``."""
    import numpy as np

    from repro_torch.core import to_dist
    from repro_torch.launch.mesh import write_plan

    job = {"keys": list(plans), "dirs": {}, "vecs": {}}
    for key, (plan, layout) in plans.items():
        tag = key.replace("/", "_")
        job["dirs"][key] = str(write_plan(plan, f"{d}/{tag}"))
        job["vecs"][key] = f"{d}/{tag}_vec"
        Path(job["vecs"][key]).mkdir(parents=True)
        for name, v in (("x", x), ("b", b)):
            np.save(f"{job['vecs'][key]}/{name}.npy",
                    to_dist(v, layout, plan).cpu().numpy())
    return job


def virtual_row(plan, layout, x, b, solve: bool = True,
                tol: float = 1e-6) -> dict:
    """The virtual mesh at a process mesh's grid, on this process's card:
    one SpMV (``y``, the a2a ghosts) and its ms, and with ``solve`` cg +
    jacobi to ``tol`` (``x``, iterations, ms/iteration)."""
    import torch

    from repro_torch.core import make_exchange, make_spmv, to_dist
    from repro_torch.solvers import make_solver
    from repro_torch.testing.transport_check import plan_on

    vplan = plan_on(plan, DEVICE)
    xv = to_dist(x, layout, vplan)
    spmv = make_spmv(vplan)
    y = spmv(xv)
    ghost = make_exchange(vplan, "a2a")(xv) if vplan.hs else None
    row = {"y": y.cpu().numpy(),
           "ghost": None if ghost is None else ghost.cpu().numpy(),
           "spmv_ms": time_ms(lambda: spmv(xv))}
    if solve:
        xs, iters, rel, ms, iters_run = solve_timed(
            make_solver(vplan, solver="cg", precond="jacobi",
                        check_every=CHECK_EVERY),
            to_dist(b, layout, vplan), tol)
        row.update(x=xs.cpu().numpy(), iters=iters, rel=rel,
                   ms_per_iter=ms / iters_run)
    torch.cuda.synchronize()
    return row


def mesh_report(phase: str, A, b64, smi, key, plan, layout, res: list,
                want: dict, mode: str | None = None) -> dict:
    """One plan of a process-mesh phase in one mode on every rank (``res``,
    rank order; ``mode`` default the plan's own) against the virtual
    mesh at that grid (``want``, ``virtual_row``'s): ``y`` and ghosts bit
    for bit, every rank launched the kernels of its schedule
    (``path_kernels``, single-column and batched) and its batched SpMV's
    columns are the single-column body's bits; where the ranks solved,
    cg's iterations equal on every rank (and to the virtual mesh's on one
    rank, within ±1 elsewhere), the true residual, the iterates against
    the virtual mesh's (reported); one ``phase`` line, returned."""
    import numpy as np
    import torch

    from repro_torch.core import from_dist

    mode = mode or plan.mode
    grid, world = plan.n_core, len(res)
    y_ok = all(np.array_equal(r["y"][0, 0].view(np.int32),
                              want["y"][divmod(i, grid)].view(np.int32))
               for i, r in enumerate(res))
    g = plan.g_pad
    ghost_ok = None if want["ghost"] is None else all(
        np.array_equal(r["ghost"][0, 0, :g].view(np.int32),
                       want["ghost"][divmod(i, grid)][:g].view(np.int32))
        for i, r in enumerate(res))
    kernels = (path_kernels(plan.format, bool(plan.hs), mode)
               + path_kernels(plan.format, bool(plan.hs), mode, True))
    row = {"plan": key, "mode": mode, "ranks": world, "spmv_bitwise": y_ok,
           "ghosts_bitwise": ghost_ok, "schedule": res[0]["schedule"],
           "batched_bitwise": all(r["batched_bitwise"] for r in res),
           "spmv_ms": max(r["spmv_ms"] for r in res),
           "spmv_ms_by_rank": [r["spmv_ms"] for r in res],
           "spmv_wire_ms": max(r["spmv_wire_ms"] for r in res),
           "spmv_exposed_ms": max(r["spmv_exposed_ms"] for r in res),
           "spmv_wire_ms_by_kind_rank0": res[0]["spmv_wire_ms_by_kind"],
           "diag_ms": max((r.get("diag_ms", 0.0) for r in res)),
           "virtual_spmv_ms": want["spmv_ms"], "kernels": kernels,
           "kernel_launches_per_rank": {
               k: [r["launches"].get(k, 0) for r in res] for k in kernels}}
    if "transports" in res[0]:
        row["transports"] = {
            t: {"bitwise_a2a": all(r["transports"][t]["bitwise_a2a"]
                                   for r in res),
                **{k: max(r["transports"][t][k] for r in res)
                   for k in ("spmv_ms", "spmv_wire_ms", "spmv_exposed_ms")}}
            for t in res[0]["transports"]}
    if "iters" in res[0]:
        its = [r["iters"] for r in res]
        xg = from_dist(torch.from_numpy(np.concatenate(
            [r["x"] for r in res]).reshape(plan.cg_shape)), layout,
            plan).astype(np.float64)
        true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                         / np.linalg.norm(b64))
        iters_run = -(-its[0] // CHECK_EVERY) * CHECK_EVERY
        ms = max(r["ms"] for r in res)
        wire_ms = {k: max(r["wire"]["ms_by_kind"].get(k, 0.0) for r in res)
                   for k in res[0]["wire"]["ms_by_kind"]}
        row.update(
            tol=res[0]["tol"], iters=its[0], virtual_iters=want["iters"],
            rel=res[0]["rel"], true_rel=true_rel, ms=ms,
            ms_per_iter=ms / iters_run,
            virtual_ms_per_iter=want["ms_per_iter"],
            wire_ms_per_iter_by_kind={k: v / iters_run
                                      for k, v in wire_ms.items()},
            wire_share=sum(wire_ms.values()) / ms,
            exposed_ms_per_iter=max(r["wire"]["exposed_ms"]
                                    for r in res) / iters_run,
            wire_calls_per_iter_rank0=res[0]["wire"]["calls"] / iters_run,
            wire_bytes_per_iter_rank0=res[0]["wire"]["bytes"] / iters_run,
            iterates_bitwise=all(np.array_equal(
                r["x"][0, 0].view(np.int32),
                want["x"][divmod(i, grid)].view(np.int32))
                for i, r in enumerate(res)))
        if "device_ms_per_iter" in res[0]:
            row.update(
                device_ms_per_iter=max(r["device_ms_per_iter"]
                                       for r in res),
                nccl_kernel_ms_per_iter=max(r["nccl_ms_per_iter"]
                                            for r in res),
                device_launches_per_iter=[r["device_launches_per_iter"]
                                          for r in res],
                host_c10d_ms_per_iter_rank0=res[0]["host_c10d_ms_per_iter"])
    emit(phase, nvidia_smi=smi, **row)
    what = f"{phase} {key} {mode}"
    check(y_ok, f"{what}: a rank's y differs from its row of the virtual "
          "mesh's")
    check(ghost_ok is not False, f"{what}: a rank's ghosts differ from its "
          "row of the virtual mesh's")
    check(row["batched_bitwise"], f"{what}: a batched column differs from "
          "the single-column body's")
    for k, n in row["kernel_launches_per_rank"].items():
        check(all(v > 0 for v in n),
              f"{what}: {k} did not launch on every rank ({n})")
    check(all(r["spmv_exposed_ms"] <= r["spmv_wire_ms"] + 1e-9 for r in res),
          f"{what}: exposed wire above the wire")
    for t, tr in row.get("transports", {}).items():
        check(tr["bitwise_a2a"], f"{what}: {t}'s y differs from a2a's")
    if "iters" in row:
        its = [r["iters"] for r in res]
        slack = 0 if world == 1 else 1
        check(all(i == its[0] for i in its),
              f"{what}: iterations differ across ranks {its}")
        check(abs(its[0] - want["iters"]) <= slack,
              f"{what}: {its[0]} iterations, the virtual mesh "
              f"{want['iters']} (±{slack})")
        check(row["rel"] <= row["tol"] and np.isfinite(xg).all(),
              f"{what}: CG stopped at rel {row['rel']}")
        check(row["true_rel"] < 1e-4 if row["tol"] <= 1e-6
              else row["true_rel"] < 10 * row["tol"],
              f"{what}: true rel {row['true_rel']}")
    return row


def modes_report(phase: str, smi, key, rows: dict, res: dict) -> None:
    """The modes one plan ran in (``rows``: ``mesh_report``'s line by
    mode, ``res``: every rank's rows by mode): ``y``, ghosts and cg's every
    iterate bit for bit across the modes on every rank, iterations equal
    across the modes; one ``<phase>_modes`` line with ms per SpMV and per
    CG iteration, the wire and its exposed part per mode."""
    import numpy as np

    modes = list(rows)
    first = res[modes[0]]

    def same(name):
        return all(np.array_equal(r[name].view(np.int32),
                                  f[name].view(np.int32))
                   for mode in modes[1:] for r, f in zip(res[mode], first)
                   if r.get(name) is not None)

    its = {mode: [r.get("iters") for r in res[mode]] for mode in modes}
    row = {"plan": key, "modes": modes, "spmv_bitwise": same("y"),
           "ghosts_bitwise": same("ghost"),
           "iterates_bitwise": same("x") if "x" in first[0] else None,
           "iters": {mode: v[0] for mode, v in its.items()},
           "per_mode": {mode: {k: r.get(k) for k in (
               "schedule", "spmv_ms", "spmv_wire_ms", "spmv_exposed_ms",
               "diag_ms", "ms_per_iter", "exposed_ms_per_iter",
               "wire_share", "device_ms_per_iter", "transports")}
               for mode, r in rows.items()}}
    emit(f"{phase}_modes", nvidia_smi=smi, **row)
    check(row["spmv_bitwise"] and row["ghosts_bitwise"],
          f"{phase} {key}: y or ghosts differ across the modes {modes}")
    check(row["iterates_bitwise"] is not False,
          f"{phase} {key}: cg's iterates differ across the modes {modes}")
    check(all(v == its[modes[0]] for v in its.values()),
          f"{phase} {key}: iterations differ across the modes {its}")


def emit_wire(phase: str, smi, ranks: list) -> None:
    """Each probed grid's ``wire_probe`` (and ``host_split``) over the
    ranks, the largest of each number: one ``<phase>_wire`` line each."""
    for grid in ranks[0]["wire_probe"]:
        probe = [r["wire_probe"][grid] for r in ranks]
        emit(f"{phase}_wire", nvidia_smi=smi, grid=grid, calls=50,
             **{k: max(p[k] for p in probe) for k in probe[0]})


def phase_procmesh(A, plans, x, b, smi, two_level: dict,
                   service: dict) -> dict:
    """The full 4x2 plans on a process mesh of 8 ranks of this card (see
    the module docstring, 6l), held to the virtual mesh's rows at the
    same grids, to each other across the modes and to phases ``precond``
    (``two_level``) and ``serve`` (``service``).  Returns every kernel's
    launches over the ranks."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from repro_torch.core.transport import available_wire_dtypes
    from repro_torch.launch.mesh import spawn_cg_mesh
    from repro_torch.testing import transport_check

    t_phase = time.perf_counter()
    keys = (*PROCMESH_PLANS, *PROCMESH_HALOFREE)
    mplans = {k: plans[k] for k in keys}
    mplans.update({k: rows_plan(A, k, DEVICE) for k in PROCMESH_MODES})
    solve = (PROCMESH_SOLVE, *PROCMESH_MODES)
    tols = {k: PROCMESH_MODES_TOL for k in PROCMESH_MODES}
    tols[PROCMESH_SOLVE] = PROCMESH_TOL
    with tempfile.TemporaryDirectory(prefix="procmesh_") as d:
        t0 = time.perf_counter()
        job = write_job(mplans, x, b, d)
        want = {k: virtual_row(*mplans[k], x, b, solve=k in solve,
                               tol=tols.get(k, 1e-6)) for k in mplans}
        golden, job["sweep"] = transport_check.prepare_process(
            ("graded",), ("ell", "sell"), 4, 2, DEVICE, f"{d}/golden",
            wire_dtypes=available_wire_dtypes())
        # the host matrix, the sell plan's whole layout and b: two_level,
        # the resilient driver and the service build from them on each
        # rank
        job.update(solve=solve, modes=PROCMESH_MODES, tol=tols,
                   wheres=("host", "card"), layers={
            "keys": PROCMESH_PLANS, "sell": "sell/4x2", "nan_shard": (2, 1),
            "A": A, "layout": plans["sell/4x2"][1], "b_global": b})
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_cg_mesh(mesh_rank, 4, 2, DEVICE, args=(job,),
                              timeout=900)
        spawn_s = time.perf_counter() - t0

    b64 = b.astype(np.float64)
    _, launches = report_modes("procmesh", A, b64, smi, mplans, ranks, want)
    for layer in ("two_level", "resilient", "serve"):
        for k, n in sum_launches(r["layers"][layer]
                                 for r in ranks).items():
            launches[k] = launches.get(k, 0) + n
    del mplans
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        g_ok = transport_check.report_process(
            golden, [r["sweep"] for r in ranks])
    lines = out.getvalue().strip().splitlines()
    emit("procmesh_golden", ok=g_ok, lines=lines)
    check(g_ok, "procmesh golden: a rank's ghosts, y or census differ "
          "from the virtual mesh's")
    emit_wire("procmesh", smi, ranks)
    procmesh_layers_report(A, plans, b, smi, [r["layers"] for r in ranks],
                           two_level, service, "procmesh", PROCMESH_PLANS,
                           "sell/4x2")

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.resilience_check",
         "--mesh", "process", "--device", "cuda"], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=600)
    lines = res.stdout.strip().splitlines()
    emit("procmesh_resilience_check", rc=res.returncode,
         seconds=time.perf_counter() - t0, lines=lines,
         stderr_tail=res.stderr[-2000:])
    check(res.returncode == 0 and lines and lines[-1] == "OK",
          "resilience_check --mesh process --device cuda did not print OK")
    emit("procmesh_seconds", write_s=write_s, spawn_s=spawn_s,
         seconds=time.perf_counter() - t_phase)
    return launches


def procmesh_layers_report(A, plans, b, smi, ranks: list, two_level: dict,
                           service: dict, phase: str, keys, sell: str
                           ) -> None:
    """A process mesh's layers (``procmesh_layers`` on every rank: phase
    ``procmesh``'s, or ``nccl``'s on ``keys`` with ``sell``) against each
    other and against the virtual mesh's rows: one line and its gates per
    layer, each line named ``<phase>_<layer>``."""
    import numpy as np
    import torch

    from repro_torch.core import from_dist

    for key in keys:
        got = [r["auto"][key] for r in ranks]
        winners = [g["winner"] for g in got]
        emit(f"{phase}_auto", nvidia_smi=smi, plan=key, winners=winners,
             us=got[0]["us"], min_us=got[0]["min_us"],
             seconds=max(g["seconds"] for g in got))
        check(all(w == winners[0] for w in winners),
              f"{phase} auto {key}: ranks picked {winners}")

    plan, layout = plans[sell]
    tl = [r["two_level"] for r in ranks]
    its = [t["iters"] for t in tl]
    iters_run = -(-its[0] // CHECK_EVERY) * CHECK_EVERY
    xg = from_dist(torch.from_numpy(np.concatenate(
        [t["x"] for t in tl]).reshape(plan.cg_shape)), layout,
        plan).astype(np.float64)
    b64 = b.astype(np.float64)
    true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                     / np.linalg.norm(b64))
    # two_level's R and P are balanced plans: on a rank, diag + offd passes
    b1 = [t["launches"]["ell_spmv_onto"] for t in tl]
    ms = max(t["ms"] for t in tl)
    emit(f"{phase}_two_level", nvidia_smi=smi, plan=sell,
         options=PROCMESH_TWO_LEVEL, iters=its[0],
         virtual_iters=two_level["iters"], rel=tl[0]["rel"],
         true_rel=true_rel, ms=ms, ms_per_iter=ms / iters_run,
         virtual_ms_per_iter=two_level["ms_per_iter"],
         wire_share=max(t["wire"]["seconds"] for t in tl) * 1e3 / ms,
         wire_ms_per_iter_by_kind_rank0={
             k: v * 1e3 / iters_run
             for k, v in tl[0]["wire"]["by_kind"].items()},
         build_s_per_rank=[t["build_s"] for t in tl],
         host_s_rank0=tl[0]["host_s"], ell_spmv_onto_per_rank=b1,
         sell_spmv_onto_per_rank=[t["launches"]["sell_spmv_onto"]
                                  for t in tl])
    check(all(i == its[0] for i in its),
          f"{phase} two_level: iterations differ across ranks {its}")
    check(abs(its[0] - two_level["iters"]) <= 1,
          f"{phase} two_level: {its[0]} iterations, phase precond "
          f"{two_level['iters']}")
    check(tl[0]["rel"] <= 1e-6 and true_rel < 1e-4,
          f"{phase} two_level: rel {tl[0]['rel']}, true rel {true_rel}")
    check(all(n > 0 for n in b1), f"{phase} two_level: ell_spmv_onto "
          f"(R and P) did not launch on every rank ({b1})")

    rs = [r["resilient"] for r in ranks]
    ms = max(r["ms"] for r in rs)
    emit(f"{phase}_resilient", nvidia_smi=smi, plan=sell,
         check_every=50, iters=rs[0]["iters"], chunks=rs[0]["chunks"],
         rel=rs[0]["rel"], true_rel=rs[0]["true_rel"], ms=ms,
         ms_per_iter=ms / max(rs[0]["iters"], 1),
         x_bitwise_monolithic=[r["x_bitwise_monolithic"] for r in rs],
         wire_ms_by_kind_rank0={k: v * 1e3 for k, v in
                                rs[0]["wire"]["by_kind"].items()},
         nan_rollbacks=[r["nan_rollbacks"] for r in rs],
         nan_iters=rs[0]["nan_iters"], nan_rel=rs[0]["nan_rel"],
         nan_converged=rs[0]["nan_converged"],
         sell_spmv_onto_per_rank=[r["launches"]["sell_spmv_onto"]
                                  for r in rs])
    check(all(r["x_bitwise_monolithic"] for r in rs),
          f"{phase} resilient: a rank's chunked x differs from its "
          "monolithic solve's")
    check(all(r["nan_rollbacks"] == 1 and r["nan_converged"]
              and r["nan_trajectory"] == rs[0]["nan_trajectory"]
              for r in rs), f"{phase} resilient: nan@60 not rolled back "
          "once with one trajectory on every rank")
    check(all(r["launches"]["sell_spmv_onto"] > 0 for r in rs),
          f"{phase} resilient: sell_spmv_onto did not launch on every rank")

    sv = [r["serve"] for r in ranks]
    its = [s["iters"] for s in sv]
    want = service["iters"][:PROCMESH_REQUESTS]
    b2 = [s["launches"]["sell_spmv_onto_batched"] for s in sv]
    ms = max(s["ms"] for s in sv)
    emit(f"{phase}_serve", nvidia_smi=smi, plan=sell,
         requests=PROCMESH_REQUESTS, nrhs=SERVE_NRHS, tols=SERVE_TOLS,
         iters=its[0], virtual_iters=want, true_rel=sv[0]["true_rel"],
         makespan_s=ms / 1e3, chunks=sv[0]["chunks"],
         splices=sv[0]["splices"], build_s=max(s["build_s"] for s in sv),
         recompiles=[s["recompiles"] for s in sv],
         wire_ms_by_kind_rank0={k: v * 1e3 for k, v in
                                sv[0]["wire"]["by_kind"].items()},
         sell_spmv_onto_batched_per_rank=b2)
    check(all(i == its[0] for i in its) and len(its[0]) == len(want),
          f"{phase} serve: iterations differ across ranks {its}")
    check(all(abs(a - w) <= 1 for a, w in zip(its[0], want)),
          f"{phase} serve: iterations {its[0]}, phase serve {want}")
    check(all(s["recompiles"] == 0 for s in sv),
          f"{phase} serve: a rank recompiled while serving")
    check(all(n > 0 for n in b2), f"{phase} serve: sell_spmv_onto_batched "
          f"did not launch on every rank ({b2})")
    # a request at tol 1e-4 stops just under it: its true residual is
    # held to twice its tol (phase serve's 2e-4), the others to 1e-4
    tols = [SERVE_TOLS[i % 3] for i in range(PROCMESH_REQUESTS)]
    check(all(r < max(1e-4, 2 * t) for r, t in zip(sv[0]["true_rel"],
                                                    tols)),
          f"{phase} serve: true rel {sv[0]['true_rel']}")


# ---------------------------------------------------------------------- #
# phase nccl: one rank per card
# ---------------------------------------------------------------------- #
#: phase nccl's grids by ranks, one rank per card: pure "MPI" (n x 1),
#: hybrid (2 x 2) and halo-free (1 x n)
NCCL_GRIDS = {1: ((1, 1),), 2: ((2, 1), (1, 2)),
              4: ((4, 1), (2, 2), (1, 4))}
NCCL_FORMATS = ("ell", "sell")
#: the plans phase nccl runs the layers above the solvers on (4 cards)
NCCL_LAYERS = ("ell/2x2", "sell/2x2")
#: the plans whose shapes the kernels line times under ``--only nccl``:
#: 4 cards (B1, B2 with a halo; B3, B4 halo-free), else 1 (B3, B4)
NCCL_KERNELS = {4: {"fused_ell_spmv": "ell/2x2",
                    "fused_sell_spmv": "sell/2x2",
                    "ell_spmv": "ell/1x4", "sell_spmv": "sell/1x4"},
                1: {"ell_spmv": "ell/1x1", "sell_spmv": "sell/1x1"}}
#: fused-CG iterations ``torch.profiler`` traces on each rank
NCCL_PROFILE_ITERS = 32
#: the modes phase nccl alternates on each halo grid's rows plan, and the
#: transports it adds under the last of them on the 2x2 plans
NCCL_MODES = ("vector", "task")
NCCL_TRANSPORTS = ("ring", "hier")


def nccl_layers_virtual(A, plan, layout, b) -> tuple[dict, dict, dict]:
    """The virtual mesh's yardsticks for phase ``nccl``'s layers on the
    2x2 sell plan: two_level's iterations and ms/iteration, and the
    service's iterations on the same requests as the ranks'; and
    two_level's R and P (``(plan, layout)`` by name, on the card), whose
    shapes the kernels line times."""
    import numpy as np

    from repro_torch.core import to_dist
    from repro_torch.serve import EngineConfig, PlanCache, SolveService
    from repro_torch.solvers import make_solver
    from repro_torch.testing.transport_check import plan_on

    vplan = plan_on(plan, DEVICE)
    solve = make_solver(vplan, solver="cg", precond="two_level", A=A,
                        layout=layout, precond_options=PROCMESH_TWO_LEVEL,
                        check_every=CHECK_EVERY)
    _, iters, _, ms, iters_run = solve_timed(solve,
                                             to_dist(b, layout, vplan))
    two_level = {"iters": iters, "ms_per_iter": ms / iters_run}
    rp = solve.papply.plans
    del solve, vplan
    cfg = EngineConfig(nrhs=SERVE_NRHS, n_node=plan.n_node,
                       n_core=plan.n_core, format="sell", transport="a2a",
                       wire_dtype="f32", solver="cg", precond="jacobi",
                       check_every=SERVE_CHECK_EVERY)
    svc = SolveService(A, cfg, cache=PlanCache(), device=DEVICE)
    B = np.random.default_rng(SEED + 7).standard_normal(
        (4 * SERVE_NRHS, A.n_rows))
    for i in range(PROCMESH_REQUESTS):
        svc.submit(B[i], tol=SERVE_TOLS[i % 3])
    service = {"iters": [r.iterations for r in svc.drain()]}
    return two_level, service, rp


def phase_nccl(A, x, b, smi) -> dict:
    """The process mesh on NCCL, one rank per card (see the module
    docstring, 6m).  Returns what the kernels line of ``--only nccl``
    needs: the virtual plans whose shapes it times (``plans``, by
    ``keys``: kernel -> plan key) and every kernel's launches over the
    ranks' grids (``launches``); on four cards also two_level's R and P
    (``rp``) and the launches of the 2x2 two_level and service runs
    (``layer_launches``)."""
    import contextlib
    import io
    import multiprocessing
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import build_spmv_plan, to_dist
    from repro_torch.core.transport import available_wire_dtypes
    from repro_torch.launch.mesh import spawn_cg_mesh
    from repro_torch.testing import transport_check
    from repro_torch.testing.transport_check import plan_on

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    worlds = [w for w in NCCL_GRIDS if w <= cards]
    version = torch.cuda.nccl.version()
    emit("nccl", nccl_version=list(version) if isinstance(version, tuple)
         else version, cards=cards, nvidia_smi=smi,
         grids_run=[f"{n}x{c}" for w in worlds for n, c in NCCL_GRIDS[w]],
         grids_needing_more_cards={
             f"{n}x{c}": w for w in NCCL_GRIDS if w > cards
             for n, c in NCCL_GRIDS[w]},
         wire="none: one rank moves no data in a collective" if cards == 1
         else f"card to card over this host's links, {max(worlds)} cards")

    # one rank more than cards: refused before any process starts
    before = len(multiprocessing.active_children())
    try:
        spawn_cg_mesh(mesh_rank, cards + 1, 1, DEVICE, backend="nccl",
                      args=({"keys": []},))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    started = len(multiprocessing.active_children()) - before
    emit("nccl_refusal", ranks=cards + 1, cards=cards, error=refusal,
         processes_started=started)
    check(refusal is not None and f"{cards + 1} card(s)" in refusal
          and f"{cards} present" in refusal and started == 0,
          f"nccl: {cards + 1} ranks on {cards} card(s) not refused before "
          f"a spawn ({refusal!r}, {started} started)")

    b64 = b.astype(np.float64)
    kernel_keys = NCCL_KERNELS[4 if cards >= 4 else 1]
    got = {"plans": {}, "keys": kernel_keys, "launches": {}, "rp": None,
           "layer_launches": {}}
    rows = {}
    with tempfile.TemporaryDirectory(prefix="nccl_") as d:
        for w in worlds:
            t0 = time.perf_counter()
            plans = {}
            for n_node, n_core in NCCL_GRIDS[w]:
                for fmt in NCCL_FORMATS:
                    plans[f"{fmt}/{n_node}x{n_core}"] = build_spmv_plan(
                        A, n_node, n_core, mode="balanced", format=fmt,
                        transport="a2a", device="cpu")
            # vector and task, alternated, on each halo grid's rows plan
            modes = {f"{fmt}/{n}x{c}/rows": NCCL_MODES
                     for n, c in NCCL_GRIDS[w] if n > 1
                     for fmt in NCCL_FORMATS}
            plans.update({k: rows_plan(A, k, "cpu") for k in modes})
            job = write_job(plans, x, b, f"{d}/{w}")
            job.update(solve=job["keys"], profile=True, wheres=("card",),
                       host_split=True, modes=modes, transports={
                           k: NCCL_TRANSPORTS for k in modes
                           if k.split("/")[1] == "2x2"})
            if w == 1:
                emit("nccl_modes", grid="1x1", modes=list(NCCL_MODES),
                     note="one rank: no collective moves data and the "
                          "plan has no halo, so every mode runs the one "
                          "halo-free launch and the modes coincide")
            want = {k: virtual_row(*plans[k], x, b) for k in plans}
            for key in set(kernel_keys.values()) & set(plans):
                got["plans"][key] = (plan_on(plans[key][0], DEVICE),
                                     plans[key][1])
            virtual = None
            if w == 4:
                plan, layout = plans["sell/2x2"]
                two_level, service, got["rp"] = nccl_layers_virtual(
                    A, plan, layout, b)
                # the sweep reads the plan the ranks read (written again)
                vw, sweep = transport_check.prepare_plan(
                    plan, to_dist(x, layout, plan), DEVICE,
                    job["dirs"]["sell/2x2"],
                    wire_dtypes=available_wire_dtypes())
                virtual = [("full", "sell", plan, vw)]
                job.update(sweep=[sweep], layers={
                    "keys": NCCL_LAYERS, "sell": "sell/2x2",
                    "nan_shard": (1, 1), "A": A, "layout": layout,
                    "b_global": b})
            prep_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranks = spawn_cg_mesh(mesh_rank, *NCCL_GRIDS[w][0], DEVICE,
                                  backend="nccl", args=(job,), timeout=900)
            spawn_s = time.perf_counter() - t0
            check([r["device"] for r in ranks]
                  == [f"cuda:{r}" for r in range(w)],
                  f"nccl: ranks ran on {[r['device'] for r in ranks]}")
            lines, launches = report_modes("nccl_grid", A, b64, smi, plans,
                                           ranks, want)
            rows.update({key: line for (key, mode), line in lines.items()
                         if key not in modes})
            for k, n in launches.items():
                got["launches"][k] = got["launches"].get(k, 0) + n
            if virtual is not None:
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    g_ok = transport_check.report_process(
                        virtual, [r["sweep"] for r in ranks])
                emit("nccl_sweep", plan="sell/2x2", ok=g_ok,
                     lines=out.getvalue().strip().splitlines())
                check(g_ok, "nccl sweep: a rank's ghosts, y or census "
                      "differ from the virtual mesh's")
                procmesh_layers_report(
                    A, plans, b, smi, [r["layers"] for r in ranks],
                    two_level, service, "nccl", NCCL_LAYERS, "sell/2x2")
                for layer in ("two_level", "serve"):
                    total = got["layer_launches"].setdefault(layer, {})
                    for r in ranks:
                        for k, n in r["layers"][layer]["launches"].items():
                            total[k] = total.get(k, 0) + n
            emit_wire("nccl", smi, ranks)
            emit("nccl_seconds", ranks=w, prep_s=prep_s, spawn_s=spawn_s)
            del plans, want, ranks
            shutil.rmtree(f"{d}/{w}")       # a world's plans, off the disk
    nccl_scaling(rows, smi)
    emit("nccl_seconds", seconds=time.perf_counter() - t_phase)
    return got


def nccl_scaling(rows: dict, smi) -> None:
    """Strong scaling of phase ``nccl``'s grids against its 1x1 mesh: ms
    per SpMV and per CG iteration, speedup and efficiency per card."""
    for fmt in NCCL_FORMATS:
        base = rows.get(f"{fmt}/1x1")
        if base is None:
            continue
        grids = {}
        for key, row in rows.items():
            if not key.startswith(f"{fmt}/"):
                continue
            cards = row["ranks"]
            grids[key.split("/")[1]] = {
                "cards": cards, "spmv_ms": row["spmv_ms"],
                "ms_per_iter": row["ms_per_iter"],
                "spmv_speedup": base["spmv_ms"] / row["spmv_ms"],
                "spmv_efficiency": base["spmv_ms"] / row["spmv_ms"] / cards,
                "iter_speedup": base["ms_per_iter"] / row["ms_per_iter"],
                "iter_efficiency": base["ms_per_iter"] / row["ms_per_iter"]
                / cards}
        emit("nccl_scaling", nvidia_smi=smi, format=fmt, against="1x1",
             grids=grids)


# --------------------------------------------------------------------- #
# phase shard: sharded training and the ring collective matmul
# --------------------------------------------------------------------- #
#: the f32 parity run against the one-card trainer, and the arch whose
#: state one card cannot hold
SHARD_CHECK, SHARD_ARCH = "qwen2.5-3b", "granite-3-8b"
SHARD_B, SHARD_S, SHARD_LR = 4, 512, 3e-5
SHARD_CHECK_STEPS, SHARD_STEPS = 3, 8
#: the full-width path's ranks (2x2: data x model)
SHARD_RANKS = 4
#: the ring at qwen2.5-3b's MLP up-projection: x (M, K) @ W (K, N), K
#: split over the ranks; its gate and timing repetitions
SHARD_RING = (2048, 2048, 11008)
SHARD_RING_GATE, SHARD_RING_REPS = 1e-5, 10
#: a card's memory: each rank's peak must stay under it
SHARD_MEMORY = 80e9
#: the full-width f32 parity gates beside ``train_mesh_check``'s loss and
#: norm gates: each leaf's gradient block after step 1 (relative, 2-norm)
#: and the parameters after the last step in units of lr.  Set from the
#: readings on four H100s, 0.158 lr for the parameters (PERF.md §6), with
#: the margin of the longer sums at full width; a missed or doubled sync
#: moves a leaf's gradient by 50% or more
SHARD_GRAD_REL, SHARD_PARAM_LR = 1e-3, 0.5


def shard_rules() -> dict:
    """``param_pspecs`` of every arch on both production meshes and on
    the four-card 2x2 host mesh (host only, meta-device stand-ins): every
    leaf's spec splits its dims evenly (``shard_shape``), each card's
    share of the f32 parameters (train and serving specs; a trainer's
    state, parameters, gradients and two moments, is four times the train
    share) and the largest whole leaf of the port's model (one layer's),
    which is all a rank holds beyond its blocks while ``init_sharded``
    draws."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.model import Model
    from repro_torch.runtime.sharding import (MeshShape, NamedSharding,
                                              param_pspecs)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    out = {}
    for arch in list_archs():
        cfg = get_config(arch)
        params = param_specs(cfg)
        row = {"params": sum(t.numel() for t in leaves(params)),
               "largest_leaf_gb": max(t.numel() for t in Model(
                   cfg, "meta").parameters()) * 4 / 1e9}
        for name, mesh in (("16x16", make_production_mesh()),
                           ("2x16x16", make_production_mesh(multi_pod=True)),
                           ("2x2", MeshShape(("data", "model"), (2, 2)))):
            for serving in (False, True):
                specs = param_pspecs(cfg, mesh, params, serving=serving)
                per_card = sum(
                    math.prod(NamedSharding(mesh, s).shard_shape(t.shape))
                    for s, t in zip(leaves(specs), leaves(params)))
                key = name + ("/serving" if serving else "")
                row[key] = per_card * 4 / 1e9
        out[arch] = row
    return out


def shard_loss(model, cfg, mesh, batch, shards: int):
    """``(this rank's loss, the mesh's)`` on ``batch``, this rank's rows
    of ``shards``."""
    from repro_torch.models.common import use_mesh
    from repro_torch.models.model import loss_fn
    from repro_torch.runtime.sharded import mean_over_mesh

    with use_mesh(mesh, shards):
        loss = loss_fn(model, cfg, batch)[0]
    return loss, mean_over_mesh(loss, mesh)


def shard_direction(cfg, mesh, tok, shards: int) -> dict:
    """A step of ``TRAIN_EPS`` along -g/|g| on the mesh at init lowers the
    loss by ``TRAIN_EPS·|g|`` (phase train's check, on the blocks)."""
    import torch

    from repro_torch.launch.train import deterministic
    from repro_torch.runtime import sharded

    with deterministic():
        model = sharded.init_sharded(cfg, torch.Generator(
            device=mesh.device).manual_seed(SEED), mesh, mesh.device)
        st = model.sharding
        local, loss0 = shard_loss(model, cfg, mesh, {"tokens": tok}, shards)
        local.backward()
        grads = {k: p.grad for k, p in st.params.items()}
        sharded.sync_grads(st, grads)
        gnorm = float(sharded.global_norm(st, grads))
        with torch.no_grad():
            for p in st.params.values():
                p.sub_(TRAIN_EPS / gnorm * p.grad)
                p.grad = None
            loss1 = float(shard_loss(model, cfg, mesh, {"tokens": tok},
                                     shards)[1])
    del model, st, grads, local
    torch.cuda.empty_cache()
    return {"loss": float(loss0), "grad_norm": gnorm, "eps": TRAIN_EPS,
            "loss_drop": float(loss0) - loss1,
            "predicted_drop": TRAIN_EPS * gnorm}


def shard_ring(mesh, dtype) -> dict:
    """The ring at ``SHARD_RING`` with ``dtype`` storage on a ``model``
    mesh of every rank: each rank's ``y`` against the float64 product,
    the ring's ms and its exposed wire against the all-gather form's."""
    import numpy as np
    import torch

    from repro_torch.core.collectives import WIRE, reset_wire
    from repro_torch.runtime.overlap import ring_linear_ag
    from repro_torch.runtime.sharded import all_gather_dim
    from repro_torch.runtime.sharding import NamedSharding, P

    M, K, N = SHARD_RING
    rng = np.random.default_rng(SEED + 40)
    dev = mesh.device
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(dev)
    x, w = x.to(dtype), w.to(dtype)
    want = x.double() @ w.double()
    xs = NamedSharding(mesh, P(None, "model")).shard(x).contiguous()
    ws = NamedSharding(mesh, P("model", None)).shard(w).contiguous()
    del x, w
    n, group = mesh.shape["model"], mesh.group(("model",))

    def ring():
        return ring_linear_ag(xs, ws, mesh)

    def gathered():
        xf = all_gather_dim(xs, mesh, group, n, 1)
        wf = all_gather_dim(ws, mesh, group, n, 0)
        return torch.matmul(xf.float(), wf.float())

    y = ring()
    top = float(want.abs().max())
    err = float((y.double() - want).abs().max()) / top
    ag_err = float((gathered().double() - want).abs().max()) / top
    checksum = int(y.view(torch.int32).to(torch.int64).sum())
    del want

    def timed_ms(fn):
        out = []
        for _ in range(SHARD_RING_REPS):
            mesh.barrier()
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            out.append(ev[0].elapsed_time(ev[1]))
        return statistics.median(out)

    ring()
    reset_wire()
    ring_ms = timed_ms(ring)
    wire = dict(WIRE)
    gathered()
    reset_wire()
    ag_ms = timed_ms(gathered)
    ag_wire = dict(WIRE)
    local_ms = timed_ms(lambda: torch.matmul(xs.float(), ws.float()))
    reps = SHARD_RING_REPS
    return {"dtype": str(dtype).split(".")[-1], "rel_err": err,
            "allgather_rel_err": ag_err, "checksum": checksum,
            "ring_ms": ring_ms, "allgather_matmul_ms": ag_ms,
            "chunk_product_ms": local_ms,
            "ring_wire_ms": wire["seconds"] * 1e3 / reps,
            "ring_exposed_wire_ms": wire["exposed"] * 1e3 / reps,
            "allgather_wire_ms": ag_wire["seconds"] * 1e3 / reps,
            "ring_hops": n - 1}


class _FromRankZero(Mapping):
    """Rank 0's whole tensors by name, each broadcast to every rank of
    ``mesh`` when it is read (every rank reads the same names in the same
    order): the one-card run's leaves, one on the card at a time."""

    def __init__(self, mesh, tensors, shapes: dict):
        self.mesh, self.tensors, self.shapes = mesh, tensors, shapes

    def __getitem__(self, k):
        import torch
        import torch.distributed as dist

        dev = self.mesh.device
        t = (self.tensors[k].to(dev) if self.mesh.rank == 0 else
             torch.empty(self.shapes[k], dtype=torch.float32, device=dev))
        dist.broadcast(t, 0, group=self.mesh.world)
        return t

    def __iter__(self):
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)


def shard_rank(mesh, job: dict) -> dict:
    """One rank of phase shard (see the module docstring, 6p)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import WIRE, reset_wire
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import batch_rows
    from repro_torch.runtime.sharded import model_params
    from repro_torch.testing import train_mesh_check as tm

    dev = mesh.device
    out = {"rank": mesh.rank, "mesh": mesh.shape}
    clock = {"start": time.perf_counter()}

    def lap(name):
        now = time.perf_counter()
        clock[name], clock["start"] = now - clock["start"], now

    if job["kind"] == "one":
        # the 1x1 NCCL mesh against the one-device trainer, bit for bit
        cfg = get_config(SHARD_CHECK).reduced()
        kw = dict(steps=SHARD_CHECK_STEPS, batch=LM_B, seq=LM_S,
                  lr=SHARD_LR)
        m1, _, one = tm.run_steps(cfg, dev, **kw)
        m2, _, got = tm.run_steps(cfg, dev, mesh=mesh, **kw)
        out.update(one=one, mesh_row=got,
                   bits_equal=(one["losses"] == got["losses"]
                               and one["grad_norms"] == got["grad_norms"]
                               and tm.checksums(m1) == tm.checksums(m2)))
        del m1, m2
        t0 = time.perf_counter()
        out["serve"] = dryrun_rank(mesh)     # phase dryrun's 1x1 server
        out["serve"]["seconds"] = round(time.perf_counter() - t0, 3)
        out["port_kernels"] = {k: v for k, v in LAUNCHES.items() if v}
        return out

    # (a) qwen2.5-3b at f32: the one-card trainer on rank 0, its
    # parameters kept on the host, then the 2x2 mesh twice
    cfg = dataclasses.replace(get_config(SHARD_CHECK),
                              compute_dtype="float32")
    kw = dict(steps=SHARD_CHECK_STEPS, batch=SHARD_B, seq=SHARD_S,
              lr=SHARD_LR)
    ref = m1 = None
    if mesh.rank == 0:
        m1 = {}

        def keep_m1(i, model, opt):
            if i == 0:
                m1.update((k, m.detach().cpu()) for k, m in opt.m.items())
        model, opt, out["one"] = tm.run_steps(cfg, dev, after=keep_m1, **kw)
        ref = {k: t.detach().cpu() for k, t in model_params(model).items()}
        del model, opt
        torch.cuda.empty_cache()
    lap("one_card")
    mesh.barrier()
    runs = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        seen = {}

        def grad_check(i, model, opt):
            if i == 0 and not runs:
                st = model.sharding
                seen["grad"] = tm.grad_diff(
                    model, opt, _FromRankZero(mesh, m1, st.shapes))
        model, opt, row = tm.run_steps(cfg, dev, mesh=mesh,
                                       after=grad_check, **kw)
        row["grad"] = seen.get("grad")
        row["checksums"] = tm.checksums(model)
        row["shapes_ok"] = tm.block_shapes(model)[0]
        row["param_diff"] = tm.param_diff(model, ref) if not runs else None
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        runs.append(row)
        del model, opt
        torch.cuda.empty_cache()
    del ref, m1
    out["check"] = runs
    lap("check")

    # (b) granite-3-8b at full width, bf16 compute
    cfg = get_config(SHARD_ARCH)
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=SHARD_B,
                         seq_len=SHARD_S, seed=SEED)
    rows = batch_rows(cfg, mesh, SHARD_B, SHARD_S)
    tok = torch.from_numpy(rows.shard(pipe.batch_at(0))).to(dev)
    out["direction"] = shard_direction(
        cfg, mesh, tok, SHARD_B // rows.shard_shape((SHARD_B, SHARD_S))[0])
    lap("direction")
    torch.cuda.reset_peak_memory_stats(dev)
    model, opt, first = tm.run_steps(cfg, dev, steps=1, batch=SHARD_B,
                                     seq=SHARD_S, lr=SHARD_LR, mesh=mesh)
    reset_wire()
    model, opt, rest = tm.run_steps(cfg, dev, steps=SHARD_STEPS - 1,
                                    batch=SHARD_B, seq=SHARD_S, lr=SHARD_LR,
                                    mesh=mesh, first=1, model=model,
                                    opt=opt)
    wire = dict(WIRE)
    steps = SHARD_STEPS - 1
    out["granite"] = {
        "losses": first["losses"] + rest["losses"],
        "grad_norms": first["grad_norms"] + rest["grad_norms"],
        "step_ms": first["step_ms"] + rest["step_ms"],
        "params_local": sum(t.numel()
                            for t in model_params(model).values()),
        "wire_ms_per_step": {k: v * 1e3 / steps
                             for k, v in wire["by_kind"].items()},
        "wire_calls_per_step": wire["calls"] / steps,
        "wire_bytes_per_step": wire["bytes"] / steps}
    lap("granite")
    if mesh.rank == 0 or job.get("profile_all"):
        box = {}

        def one_step():
            box["r"] = tm.run_steps(cfg, dev, steps=1, batch=SHARD_B,
                                    seq=SHARD_S, lr=SHARD_LR, mesh=mesh,
                                    first=SHARD_STEPS, model=model, opt=opt)
        by_name, launches = device_profile(one_step, cpu=False)
        del box
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out["granite"].update(device_ms_per_step=sum(by_name.values()),
                              launches_per_step=launches,
                              top5_device_ms=dict(top))
    else:
        # the profiled step's collectives, on the other ranks unprofiled
        tm.run_steps(cfg, dev, steps=1, batch=SHARD_B, seq=SHARD_S,
                     lr=SHARD_LR, mesh=mesh, first=SHARD_STEPS, model=model,
                     opt=opt)
    out["granite"]["max_memory_allocated"] = \
        torch.cuda.max_memory_allocated(dev)
    lap("profile")

    # (b2) one more granite step measured against the dry-run's cell
    out["granite"]["measured"] = train_measure(cfg, mesh, model, opt, tok,
                                               SHARD_B, SHARD_S)
    del model, opt
    torch.cuda.empty_cache()
    lap("granite_measured")

    # (d) sharded serving: qwen2.5-3b f32 against one card, then yi-34b
    out["serve_check"] = serve_parity(mesh)
    lap("serve_check")
    out["serve_big"] = serve_big(mesh)
    lap("serve_big")

    # (c) the ring over every rank (model = 4), f32 and bf16 storage
    ring_mesh = make_host_mesh(model=mesh.size, device=dev,
                               backend=mesh.backend, rank=mesh.rank,
                               world_size=mesh.size)
    out["ring"] = [shard_ring(ring_mesh, dt)
                   for dt in (torch.float32, torch.bfloat16)]
    lap("ring")
    out["seconds"] = {k: round(v, 3) for k, v in clock.items()
                      if k != "start"}
    out["port_kernels"] = {k: v for k, v in LAUNCHES.items() if v}
    return out


def phase_shard(smi: str, bw: float, full: bool) -> dict | None:
    """6p: the sharded trainer and the ring (see the module docstring).
    ``full``: the full-width path on ``SHARD_RANKS`` cards; else the 1x1
    NCCL mesh against the one-device trainer."""
    import multiprocessing

    import torch

    from repro_torch.launch.mesh import spawn_mesh

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rules = shard_rules()
    emit("shard_rules", meshes=["16x16", "2x16x16", "2x2"],
         per_card_f32_gb=rules,
         seconds=round(time.perf_counter() - t0, 3))

    cards = torch.cuda.device_count()
    before = len(multiprocessing.active_children())
    try:
        spawn_mesh(shard_rank, cards + 1, DEVICE, backend="nccl",
                   args=({"kind": "one"},))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    started = len(multiprocessing.active_children()) - before
    emit("shard_refusal", ranks=cards + 1, cards=cards, error=refusal,
         processes_started=started)
    check(refusal is not None and started == 0,
          f"shard: {cards + 1} NCCL ranks on {cards} card(s) not refused "
          f"before a spawn ({refusal!r}, {started} started)")

    served = None
    if not full:
        t0 = time.perf_counter()
        (r,) = spawn_mesh(shard_rank, 1, DEVICE, backend="nccl",
                          args=({"kind": "one"},), timeout=600)
        emit("shard_1x1", arch=SHARD_CHECK + " reduced", batch=LM_B,
             seq=LM_S, steps=SHARD_CHECK_STEPS, one=r["one"],
             mesh_row=r["mesh_row"], bits_equal=r["bits_equal"],
             seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
        check(r["bits_equal"], "shard: the 1x1 NCCL mesh trainer differs "
              "from the one-device trainer")
        ranks, served = [r], r["serve"]
    else:
        check(cards >= SHARD_RANKS, f"shard: the full-width path needs "
              f"{SHARD_RANKS} cards, this host has {cards}")
        t0 = time.perf_counter()
        preds = {"granite": predicted(SHARD_ARCH, "train", SHARD_B, SHARD_S,
                                      (2, 2)),
                 "yi": predicted(SERVE_BIG, "decode", SERVE_B,
                                 SERVE_S + SERVE_STEPS, (2, 2))}
        predict_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_mesh(shard_rank, SHARD_RANKS, DEVICE, backend="nccl",
                           args=({"kind": "full"},), timeout=1500)
        spawn_s = time.perf_counter() - t0
        shard_report(ranks, smi, bw, spawn_s)
        serve_report(ranks, preds, smi, predict_s)
        shard_checks(smi)
    port = {}
    for r in ranks:
        for k, v in r["port_kernels"].items():
            port[k] = port.get(k, 0) + v
    emit("shard", what="port_kernels", launched=port,
         seconds=round(time.perf_counter() - t_phase, 3),
         statement="sharded training, serving and the ring launch none "
                   "of the port's CUDA kernels: their products are "
                   "torch.matmul (cuBLAS), their collectives NCCL's")
    check(not port, f"shard: the port's SpMV kernels launched: {port}")
    return served


def shard_report(ranks: list, smi: str, bw: float, spawn_s: float) -> None:
    """The lines and gates of the full-width path from its ranks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.testing import train_mesh_check as tm

    one = ranks[0]["one"]
    a, b = (ranks[0]["check"][i] for i in (0, 1))
    same = all(r["check"][0]["losses"] == a["losses"]
               and r["check"][0]["grad_norms"] == a["grad_norms"]
               for r in ranks)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                        one["losses"]))
    norm_rel = max(abs(x - y) / abs(y) for x, y in zip(a["grad_norms"],
                                                        one["grad_norms"]))
    diff_lr = a["param_diff"] / SHARD_LR
    repeat = all(r["check"][0]["checksums"] == r["check"][1]["checksums"]
                 and r["check"][0]["losses"] == r["check"][1]["losses"]
                 for r in ranks)
    shapes = all(r["check"][0]["shapes_ok"] for r in ranks)
    grad_rel, grad_leaf = max(tuple(r["check"][0]["grad"]) for r in ranks)
    emit("shard_check", arch=SHARD_CHECK, compute_dtype="float32",
         mesh=ranks[0]["mesh"], batch=SHARD_B, seq=SHARD_S, lr=SHARD_LR,
         steps=SHARD_CHECK_STEPS, one_card=one, mesh_losses=a["losses"],
         mesh_grad_norms=a["grad_norms"], ranks_agree=same,
         loss_rel=loss_rel, loss_bound=tm.LOSS_REL, grad_norm_rel=norm_rel,
         grad_norm_bound=tm.NORM_REL, grad_rel=grad_rel, grad_leaf=grad_leaf,
         grad_rel_by_rank=[r["check"][0]["grad"][0] for r in ranks],
         grad_bound=SHARD_GRAD_REL, param_diff_lr=diff_lr,
         param_bound_lr=SHARD_PARAM_LR, repeat_bits_equal=repeat,
         shapes_ok=shapes, mesh_step_ms=a["step_ms"],
         one_card_step_ms=one["step_ms"],
         max_memory_allocated=[r["check"][0]["max_memory_allocated"]
                               for r in ranks], nvidia_smi=smi)
    check(same, "shard check: the ranks' losses differ")
    check(loss_rel <= tm.LOSS_REL and norm_rel <= tm.NORM_REL,
          f"shard check: mesh against one card: loss {loss_rel}, grad "
          f"norm {norm_rel}")
    check(grad_rel <= SHARD_GRAD_REL, f"shard check: leaf {grad_leaf}'s "
          f"gradient after step 1 is {grad_rel} off the one card's")
    check(diff_lr <= SHARD_PARAM_LR, f"shard check: parameters after step "
          f"{SHARD_CHECK_STEPS} differ by {diff_lr} lr > {SHARD_PARAM_LR}")
    check(shapes, "shard check: a block is not its spec's shard")

    cfg = get_config(SHARD_ARCH)
    g = [r["granite"] for r in ranks]
    d = ranks[0]["direction"]
    emit("shard_direction", arch=SHARD_ARCH, **d, bound=TRAIN_EPS_BOUND)
    check(abs(d["loss_drop"] - d["predicted_drop"])
          <= TRAIN_EPS_BOUND * d["predicted_drop"],
          f"shard {SHARD_ARCH}: a step of {TRAIN_EPS} along the gradient "
          f"lowered the loss by {d['loss_drop']}, not {d['predicted_drop']}")
    losses, norms = g[0]["losses"], g[0]["grad_norms"]
    n_params = cfg.n_params()
    tokens = SHARD_B * SHARD_S
    step_ms = statistics.median(g[0]["step_ms"][1:])
    peak = bf16_peak(torch.cuda.get_device_name(0))
    flops_ms = 8 * n_params * tokens / (SHARD_RANKS * peak) * 1e3
    adamw_ms = 28 * n_params / (SHARD_RANKS * bw) * 1e3
    mem = [r["max_memory_allocated"] for r in g]
    emit("shard_train", arch=SHARD_ARCH, mesh=ranks[0]["mesh"],
         n_params=n_params, params_local=[r["params_local"] for r in g],
         compute_dtype=cfg.compute_dtype, remat_policy=cfg.remat_policy,
         batch=SHARD_B, seq=SHARD_S, tokens_per_step=tokens, lr=SHARD_LR,
         losses=losses, grad_norms=norms, step_ms=g[0]["step_ms"],
         ms_per_step=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
         device_ms_per_step=g[0].get("device_ms_per_step"),
         launches_per_step=g[0].get("launches_per_step"),
         top5_device_ms=g[0].get("top5_device_ms"),
         wire_ms_per_step=[r["wire_ms_per_step"] for r in g],
         wire_calls_per_step=g[0]["wire_calls_per_step"],
         wire_bytes_per_step=g[0]["wire_bytes_per_step"],
         max_memory_allocated=mem, bound_ms=flops_ms + adamw_ms,
         bound_flops_ms=flops_ms, bound_adamw_ms=adamw_ms,
         share_of_peak=6 * n_params * tokens
         / (step_ms / 1e3 * SHARD_RANKS * peak),
         seconds=ranks[0]["seconds"], spawn_s=spawn_s, nvidia_smi=smi)
    check(all(math.isfinite(v) for v in losses + norms),
          f"shard {SHARD_ARCH}: non-finite loss or grad norm")
    check(all(r["losses"] == losses for r in g),
          f"shard {SHARD_ARCH}: the ranks' losses differ")
    check(losses[-1] < losses[0], f"shard {SHARD_ARCH}: the loss did not "
          f"fall: {losses}")
    check(max(mem) < SHARD_MEMORY, f"shard {SHARD_ARCH}: a rank peaked at "
          f"{max(mem)} bytes")

    for i, row in enumerate(ranks[0]["ring"]):
        rows = [r["ring"][i] for r in ranks]
        errs = [r["rel_err"] for r in rows]
        emit("shard_ring", shape=list(SHARD_RING), ranks=len(ranks),
             dtype=row["dtype"], rel_err=errs, gate=SHARD_RING_GATE,
             ranks_bits_equal=len({r["checksum"] for r in rows}) == 1,
             allgather_rel_err=[r["allgather_rel_err"] for r in rows],
             ring_ms=[r["ring_ms"] for r in rows],
             allgather_matmul_ms=[r["allgather_matmul_ms"] for r in rows],
             chunk_product_ms=[r["chunk_product_ms"] for r in rows],
             ring_wire_ms=[r["ring_wire_ms"] for r in rows],
             ring_exposed_wire_ms=[r["ring_exposed_wire_ms"] for r in rows],
             allgather_wire_ms=[r["allgather_wire_ms"] for r in rows],
             nvidia_smi=smi)
        check(max(errs) < SHARD_RING_GATE, f"shard ring {row['dtype']}: "
              f"{max(errs)} of max|y| >= {SHARD_RING_GATE}")


# ---------------------------------------------------------------------- #
# sharded serving and the dry-run against the card
# ---------------------------------------------------------------------- #
#: the dry-run's predicted peak against the allocator's (relative)
DRYRUN_PEAK_REL = 0.10
#: the 1x1 NCCL serving check, and the arch whose cells one card runs
DRYRUN_ARCH = "qwen2.5-3b"
#: ``--only shard``'s serving: the f32 parity arch and the arch no card
#: holds alone; prompts x length, greedy steps; a second run bit for bit
SERVE_CHECK, SERVE_BIG = "qwen2.5-3b", "yi-34b"
SERVE_B, SERVE_S, SERVE_STEPS = 4, 512, 16
SERVE_GATE = 1e-5


def sync_all(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def real_measure(cell) -> tuple[dict, int]:
    """``dryrun.measure`` of a cell built for real on the card, and the
    allocator's peak over the step: ``max_memory_allocated`` after a
    reset, less what was allocated beside the cell's arguments."""
    import torch

    from repro_torch.launch import dryrun

    dev = next(t.device for t in cell.arguments)
    sync_all(dev)
    args = sum(dryrun._storages(cell.arguments).values())
    beside = torch.cuda.memory_allocated(dev) - args
    torch.cuda.reset_peak_memory_stats(dev)
    got = dryrun.measure(cell)
    sync_all(dev)
    got.pop("result")
    got.pop("census")
    return got, torch.cuda.max_memory_allocated(dev) - beside


def predicted(arch: str, kind: str, batch: int, seq: int, sizes: tuple,
              remat: str | None = None) -> dict:
    """``dryrun.predict`` of rank 0 of a ``data x model`` mesh of
    ``sizes``, in a process of its own (a mesh of more than one rank
    joins a fake process group)."""
    kw = dict(arch=arch, kind=kind, batch=batch, seq=seq, sizes=sizes,
              axes=("data", "model"), remat_policy=remat)
    code = ("import json, sys; from repro_torch.launch.dryrun import "
            "predict; print(json.dumps(predict(**json.loads(sys.argv[1]))))")
    r = subprocess.run([sys.executable, "-c", code, json.dumps(kw)],
                       capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    check(r.returncode == 0, f"dryrun predict {kw}: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def against(pred: dict, flops: float, peak: int) -> dict:
    """A prediction's flops and peak against a measured step's."""
    p = pred["per_device"]
    return {"predicted_flops": p["hlo_flops"], "measured_flops": flops,
            "flops_equal": p["hlo_flops"] == flops,
            "predicted_peak": p["peak_bytes"], "measured_peak": peak,
            "peak_rel": abs(p["peak_bytes"] - peak) / peak,
            "predicted_argument": p["argument_bytes"],
            "predicted_dominant": pred["roofline"]["dominant"]}


def train_measure(cfg, mesh, model, opt, tok, batch: int, seq: int) -> dict:
    """One more training step of the mesh trainer's ``model``/``opt`` on
    the rank's rows ``tok``, measured as the dry-run measures its train
    cell (``make_train_step(cfg, AdamWConfig(), 1)``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import use_mesh
    from repro_torch.optim import AdamWConfig

    step = make_train_step(cfg, AdamWConfig(), accum=1)
    shards = batch // tok.shape[0]

    def train_step(model, opt, data):
        with use_mesh(mesh, shards):
            model, opt, loss, _ = step(model, opt, data)
        return model, opt, loss

    data = {"tokens": tok}
    cell = dryrun.Cell(cfg, None, mesh, train_step, (model, opt, data))
    got, peak = real_measure(cell)
    return {"flops": got["hlo_flops"], "peak": peak,
            "argument_bytes": got["argument_bytes"]}


def serve_parity(mesh) -> dict:
    """``--only shard`` (d): qwen2.5-3b at full width, f32 compute and
    caches, ``SERVE_B`` prompts of ``SERVE_S`` and ``SERVE_STEPS`` greedy
    steps on this rank's card alone and on the 2x2 mesh, twice."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import batch_rows
    from repro_torch.testing import serve_mesh_check as sm

    dev = mesh.device
    cfg = dataclasses.replace(get_config(SERVE_CHECK),
                              compute_dtype="float32")
    kw = dict(batch=SERVE_B, seq=SERVE_S, steps=SERVE_STEPS,
              slots=SERVE_S + SERVE_STEPS, seed=SEED)
    one = sm.serve_steps(cfg, dev, **kw)
    del one["model"]
    torch.cuda.empty_cache()
    first = sm.serve_steps(cfg, dev, mesh=mesh, **kw)
    second = sm.serve_steps(cfg, dev, mesh=mesh, model=first["model"], **kw)
    rows = batch_rows(cfg, mesh, SERVE_B, SERVE_S)
    cmp = sm.compare(one, first, rows, first["placements"])
    out = {"tokens_equal": cmp["tokens_equal"], "logit_rel": cmp["logit_rel"],
           "cache_rel": cmp["cache_rel"],
           "repeat_bits_equal": sm._same_bits(first, second),
           "one_card_prefill_ms": one["prefill_ms"],
           "one_card_step_ms": one["step_ms"],
           "mesh_prefill_ms": first["prefill_ms"],
           "mesh_step_ms": first["step_ms"]}
    del one, first, second
    torch.cuda.empty_cache()
    return out


def serve_big(mesh) -> dict:
    """``--only shard`` (e): yi-34b at full width and bf16 on the 2x2
    mesh, its weights split over ``model`` (34.4 GB a rank): one decode
    step of the dry-run's cell measured (flops, peak, the wire by kind,
    device ms and launches), then ``SERVE_B`` prompts of ``SERVE_S`` and
    ``SERVE_STEPS`` greedy steps on the same weights."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.collectives import WIRE, reset_wire
    from repro_torch.launch import dryrun
    from repro_torch.testing import serve_mesh_check as sm

    dev = mesh.device
    cfg = get_config(SERVE_BIG)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cell = dryrun.build_cell(SERVE_BIG, mesh=mesh, shape=ShapeConfig(
        "decode", SERVE_S + SERVE_STEPS, SERVE_B, "decode"), device=dev,
        generator=gen)
    model = cell.args[0]
    params_local = sum(t.numel() * t.element_size()
                       for t in model.sharding.params.values())
    init_peak = torch.cuda.max_memory_allocated(dev)
    cell.fn(*cell.args)                       # warm the step once
    reset_wire()
    got, peak = real_measure(cell)
    wire = dict(WIRE)
    out = {"measured": {"flops": got["hlo_flops"], "peak": peak,
                        "argument_bytes": got["argument_bytes"]},
           "params_bytes_local": params_local, "init_peak": init_peak,
           "wire_ms_per_step": {k: v * 1e3 for k, v in
                                wire["by_kind"].items()},
           "wire_calls_per_step": wire["calls"],
           "wire_bytes_per_step": wire["bytes"]}
    if mesh.rank == 0:
        by_name, launches = device_profile(lambda: cell.fn(*cell.args),
                                           cpu=False)
        out.update(device_ms_per_step=sum(by_name.values()),
                   launches_per_step=launches,
                   top5_device_ms=dict(sorted(
                       by_name.items(), key=lambda kv: -kv[1])[:5]))
    else:
        cell.fn(*cell.args)                   # the profiled step's calls
    run = sm.serve_steps(cfg, dev, batch=SERVE_B, seq=SERVE_S,
                         steps=SERVE_STEPS, slots=SERVE_S + SERVE_STEPS,
                         seed=SEED, mesh=mesh, model=model,
                         kv_dtype=torch.bfloat16, keep_cache=False)
    out.update(tokens=run["tokens"].tolist(),
               tokens_ok=bool(((run["tokens"] >= 0)
                               & (run["tokens"] < cfg.vocab)).all()),
               logits_finite=bool(np.isfinite(run["logits"]).all()),
               prefill_ms=run["prefill_ms"], step_ms=run["step_ms"],
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    del cell, model, run
    torch.cuda.empty_cache()
    return out


def dryrun_rank(mesh) -> dict:
    """Phase dryrun's 1x1 NCCL rank (phase shard's): sharded serving of
    ``DRYRUN_ARCH`` at ``reduced()`` against the non-mesh path, bit for
    bit."""
    from repro_torch.testing import serve_mesh_check as sm

    cfg = sm._cfg(DRYRUN_ARCH)
    kw = dict(batch=LM_B, seq=LM_S, steps=4, slots=LM_S + 8, seed=SEED)
    one = sm.serve_steps(cfg, mesh.device, **kw)
    got = sm.serve_steps(cfg, mesh.device, mesh=mesh, **kw)
    return {"bits_equal": sm._same_bits(one, got),
            "tokens": got["tokens"].tolist()}


def dryrun_cell(name: str, kind: str, batch: int, seq: int,
                remat: str | None, smi: str) -> None:
    """A cell one card runs: the dry-run's prediction on a 1x1 mesh, then
    the same step for real (``build_cell`` on the card)."""
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    pred = dryrun.predict(DRYRUN_ARCH, kind, batch, seq, (1, 1),
                          ("data", "model"), remat_policy=remat)
    t_pred = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cell = dryrun.build_cell(DRYRUN_ARCH, cfg=get_config(DRYRUN_ARCH),
                             remat_policy=remat,
                             mesh=make_host_mesh(device=DEVICE),
                             shape=ShapeConfig(kind, seq, batch, kind),
                             device=DEVICE, generator=gen)
    got, peak = real_measure(cell)
    del cell
    torch.cuda.empty_cache()
    row = against(pred, got["hlo_flops"], peak)
    emit("dryrun_cell", cell=name, arch=DRYRUN_ARCH, kind=kind,
         batch=batch, seq=seq, remat_policy=remat, **row,
         predicted_hlo_bytes=pred["per_device"]["hlo_bytes"],
         measured_hlo_bytes=got["hlo_bytes"],
         predicted_roofline=pred["roofline"], fake_device=pred["fake_device"],
         total_memory=torch.cuda.get_device_properties(0).total_memory,
         predict_s=round(t_pred, 3),
         seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
    check(row["flops_equal"], f"dryrun {name}: predicted flops "
          f"{row['predicted_flops']} != measured {row['measured_flops']}")
    check(row["peak_rel"] <= DRYRUN_PEAK_REL, f"dryrun {name}: predicted "
          f"peak {row['predicted_peak']} vs measured {peak}")


def phase_dryrun(smi: str, r: dict) -> None:
    """6q: sharded serving on the 1x1 NCCL mesh (``r``: ``dryrun_rank``'s
    row, run on phase shard's 1x1 rank after its trainer), then the
    dry-run against the card (see the module docstring)."""
    emit("dryrun_serve_1x1", arch=DRYRUN_ARCH + " reduced", batch=LM_B,
         seq=LM_S, steps=4, bits_equal=r["bits_equal"], tokens=r["tokens"],
         seconds=r["seconds"], nvidia_smi=smi)
    check(r["bits_equal"], "dryrun: sharded serving on the 1x1 NCCL mesh "
          "differs from the non-mesh path")
    dryrun_cell("decode", "decode", LM_BATCH, LM_MAX_LEN, None, smi)
    dryrun_cell("train", "train", TRAIN_B, TRAIN_S, "full", smi)


def serve_report(ranks: list, preds: dict, smi: str,
                 predict_s: float) -> None:
    """The lines and gates of ``--only shard``'s serving and dry-run
    comparisons (d, e, b2) from its ranks."""
    import torch

    from repro_torch.configs import get_config

    c = [r["serve_check"] for r in ranks]
    emit("shard_serve_check", arch=SERVE_CHECK, compute_dtype="float32",
         cache_dtype="float32", weights="bfloat16", mesh=ranks[0]["mesh"],
         batch=SERVE_B, prompt=SERVE_S, steps=SERVE_STEPS,
         tokens_equal=[x["tokens_equal"] for x in c],
         logit_rel=[x["logit_rel"] for x in c],
         cache_rel=[x["cache_rel"] for x in c], gate=SERVE_GATE,
         repeat_bits_equal=[x["repeat_bits_equal"] for x in c],
         one_card_prefill_ms=c[0]["one_card_prefill_ms"],
         one_card_step_ms=c[0]["one_card_step_ms"],
         mesh_prefill_ms=c[0]["mesh_prefill_ms"],
         mesh_step_ms=c[0]["mesh_step_ms"], nvidia_smi=smi)
    check(all(x["tokens_equal"] for x in c), "shard serve: 2x2 tokens "
          "differ from one card's")
    check(max(x["logit_rel"] for x in c) <= SERVE_GATE
          and max(x["cache_rel"] for x in c) <= SERVE_GATE,
          f"shard serve: logits {[x['logit_rel'] for x in c]}, caches "
          f"{[x['cache_rel'] for x in c]} over {SERVE_GATE}")
    check(all(x["repeat_bits_equal"] for x in c), "shard serve: a second "
          "2x2 run differs")

    cfg = get_config(SERVE_BIG)
    y = [r["serve_big"] for r in ranks]
    steps = statistics.median(y[0]["step_ms"][1:])
    vs = [against(preds["yi"], r["measured"]["flops"],
                  r["measured"]["peak"]) for r in y]
    mem = [max(r["init_peak"], r["max_memory_allocated"]) for r in y]
    emit("shard_serve_big", arch=SERVE_BIG, n_params=cfg.n_params(),
         weights="bfloat16", mesh=ranks[0]["mesh"], batch=SERVE_B,
         prompt=SERVE_S, steps=SERVE_STEPS,
         params_bytes_local=[r["params_bytes_local"] for r in y],
         prefill_ms=[r["prefill_ms"] for r in y],
         decode_ms_per_step=steps, step_ms=y[0]["step_ms"],
         tokens_per_s=SERVE_B / (steps / 1e3),
         prefill_tokens_per_s=SERVE_B * SERVE_S / (y[0]["prefill_ms"] / 1e3),
         wire_ms_per_step=[r["wire_ms_per_step"] for r in y],
         wire_calls_per_step=y[0]["wire_calls_per_step"],
         wire_bytes_per_step=y[0]["wire_bytes_per_step"],
         device_ms_per_step=y[0].get("device_ms_per_step"),
         launches_per_step=y[0].get("launches_per_step"),
         top5_device_ms=y[0].get("top5_device_ms"),
         max_memory_allocated=mem, init_peak=[r["init_peak"] for r in y],
         tokens_ok=all(r["tokens_ok"] for r in y),
         logits_finite=all(r["logits_finite"] for r in y),
         tokens=y[0]["tokens"], nvidia_smi=smi)
    emit("shard_dryrun", cell=f"{SERVE_BIG} decode 2x2", batch=SERVE_B,
         seq=SERVE_S + SERVE_STEPS, by_rank=vs,
         predicted_roofline=preds["yi"]["roofline"],
         predicted_collectives=preds["yi"]["per_device"]["collective_by_kind"],
         predict_s=round(predict_s, 3), nvidia_smi=smi)
    check(all(r["tokens_ok"] and r["logits_finite"] for r in y),
          f"shard {SERVE_BIG}: tokens out of vocab or logits not finite")
    check(max(mem) < SHARD_MEMORY, f"shard {SERVE_BIG}: a rank peaked at "
          f"{max(mem)} bytes")
    g = [against(preds["granite"], r["granite"]["measured"]["flops"],
                 r["granite"]["measured"]["peak"]) for r in ranks]
    emit("shard_dryrun", cell=f"{SHARD_ARCH} train 2x2", batch=SHARD_B,
         seq=SHARD_S, by_rank=g,
         predicted_roofline=preds["granite"]["roofline"],
         predicted_collectives=preds["granite"]["per_device"][
             "collective_by_kind"],
         total_memory=torch.cuda.get_device_properties(0).total_memory,
         nvidia_smi=smi)
    for name, rows in ((SERVE_BIG, vs), (SHARD_ARCH, g)):
        check(all(r["flops_equal"] for r in rows), f"shard dryrun {name}: "
              f"flops {[(r['predicted_flops'], r['measured_flops']) for r in rows]}")
        check(max(r["peak_rel"] for r in rows) <= DRYRUN_PEAK_REL,
              f"shard dryrun {name}: peaks "
              f"{[(r['predicted_peak'], r['measured_peak']) for r in rows]}")


def shard_checks(smi: str) -> None:
    """``localsgd_check`` and ``elastic_check`` on NCCL ranks."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.testing import elastic_check, localsgd_check

    for name, mod, argv in (
            ("localsgd_check", localsgd_check, ()),
            ("elastic_check", elastic_check, ("path",))):
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="elastic_")
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                ok = mod.report(mod.run(*([tmp] if argv else []), DEVICE,
                                        "nccl"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        emit("shard_" + name, dist_backend="nccl", ok=ok,
             lines=buf.getvalue().splitlines(),
             seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
        check(ok, f"{name} --dist-backend nccl: {buf.getvalue()}")


def library_ms(A, x) -> float:
    """One torch.sparse CSR matvec of the global matrix (the yardstick)."""
    import torch

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr), torch.from_numpy(A.indices),
        torch.from_numpy(A.data.astype("float32")), size=A.shape,
        device=DEVICE)
    xv = torch.from_numpy(x).to(DEVICE)
    return time_ms(lambda: csr @ xv)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["nccl", "lm", "train", "shard"],
                    default=None,
                    help="nccl: the device, build and matrix phases, phase "
                         "nccl, then the kernels and ok lines; lm / train: "
                         "the device phase and phase lm / train, then the "
                         "nvidia-smi and ok lines (the LM path has no "
                         "kernel of its own); shard: the device phase and "
                         "phase shard's full-width path on four cards, "
                         "then the nvidia-smi and ok lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.launch.train import CUBLAS_WORKSPACE
    from repro_torch.sparse import graded_extruded_mesh_matrix

    # before the process's first cuBLAS call: the trainer's deterministic
    # mode (phase train) needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    smi, bw, f32_peak = phase_device()
    if args.only in ("lm", "train"):
        (phase_lm if args.only == "lm" else phase_train)(bw, smi)
        last_lines(smi)
        return 0
    if args.only == "shard":
        phase_shard(smi, bw, full=True)
        last_lines(smi)
        return 0
    phase_build()
    t0 = time.perf_counter()
    A = graded_extruded_mesh_matrix(N_SURFACE, LAYERS, seed=SEED)
    emit("matrix", rows=A.n_rows, nnz=A.nnz,
         seconds=round(time.perf_counter() - t0, 3))
    plans = build_plans(A) if args.only is None else None
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    if args.only == "nccl":
        return only_nccl(A, x, b, smi, bw, f32_peak)
    kern = phase_kernels(plans, x, bw, f32_peak)
    onto = phase_onto(A, plans, x, bw, f32_peak)
    bal_launches, bal = phase_balanced(A, x, bw, f32_peak)
    lib = library_ms(A, x)
    emit("library", what="torch.sparse CSR matvec, global matrix, f32",
         ms=lib)
    phase_golden()
    launches, rows = phase_full(A, plans, x, b)
    phase_profile(plans, b, rows)
    phase_transports(plans, x, b)
    phase_refine(A, plans, b)
    cheb_opts = phase_solvers(A, plans, b)
    phase_resilience(plans, b, cheb_opts)
    phase_example()
    rect_launches, rect = phase_rect(A, plans, bw, f32_peak)
    two_level = phase_precond(A, plans, b)
    serve_launches, serve_rows, service = phase_serve(A, plans, bw,
                                                      f32_peak)
    phase_analyze(plans)
    phase_cli(rows)
    phase_lm(bw, smi)
    phase_train(bw, smi)
    mesh_launches = phase_procmesh(A, plans, x, b, smi, two_level, service)
    phase_nccl(A, x, b, smi)
    phase_dryrun(smi, phase_shard(smi, bw, full=False))
    entries = [(name, KERNELS[name][1], launches[name], kern[name])
               for name in KERNELS]
    # the batched kernels at the service's k, with their serving launches
    entries += [(name, BATCHED[name][1], serve_launches[name],
                 serve_rows[name]) for name in BATCHED]
    # each kernel at R's and P's shapes, with its launches in phase rect
    for label, row in rect.items():
        name = row["kernel"]
        entries.append((f"{name}/{label}", KERNELS[name][1],
                        rect_launches[name], row))
    entries.append((BALANCED[0], BALANCED[1], bal_launches[BALANCED[0]],
                    bal[BALANCED[2]]))
    entries.append((FLAT_ELL[0], FLAT_ELL[1], bal_launches["ell_spmv"],
                    bal[FLAT_ELL[2]]))
    # the offd passes run on the process mesh's ranks (phase procmesh)
    for name, (_, _, replaces) in ONTO.items():
        check(mesh_launches.get(name, 0) > 0,
              f"{name} never launched on phase procmesh's ranks")
        entries.append((name, replaces, mesh_launches[name], onto[name]))
    finish(entries, lib, smi)
    return 0


def finish(entries: list, lib: float, smi: str) -> None:
    """The ``kernels`` line (``entries``: name, the TPU kernel it replaces,
    launches on the main path, its measured row), the ``nvidia-smi`` line
    and the last line."""
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": n,
         **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by")},
         "library_ms": row.get("library_ms", lib)}
        for name, replaces, n, row in entries]}),
          flush=True)
    last_lines(smi)


def last_lines(smi: str) -> None:
    """The ``nvidia-smi`` line and the last line."""
    import torch

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def only_nccl(A, x, b, smi, bw, f32_peak) -> int:
    """``--only nccl``: phase nccl, then each kernel of its path held to
    its plain version and timed at the shapes phase nccl gave it (its
    virtual plans), with its launches over every rank: B1-B4 on the
    grids; on four cards also the offd passes (``ONTO``) at the 2x2
    shapes, single-column and at the service's k, with the grids', the
    2x2 two_level's and the service's launches, and the ELL offd pass at
    two_level's R and P (two_level's launches).  two_level's R and P and
    the service are balanced plans: on the ranks they run the overlapped
    schedule, so the fused kernels do not launch there."""
    import numpy as np
    import torch

    from repro_torch.core import to_dist

    got = phase_nccl(A, x, b, smi)
    kern = phase_kernels(got["plans"], x, bw, f32_peak, keys=got["keys"])
    lib = library_ms(A, x)
    emit("library", what="torch.sparse CSR matvec, global matrix, f32",
         ms=lib)
    entries = [(name, KERNELS[name][1], got["launches"].get(name, 0),
                kern[name]) for name in got["keys"]]
    if got["rp"] is not None:
        launches = dict(got["launches"])
        for layer in ("two_level", "serve"):
            for k, n in got["layer_launches"][layer].items():
                launches[k] = launches.get(k, 0) + n
        rng = np.random.default_rng(SEED + 6)
        for name, (key, k, replaces) in ONTO.items():
            key = key.replace("4x2", "2x2")
            plan, layout = got["plans"][key]
            X = (to_dist(x, layout, plan) if k is None else torch.stack(
                [to_dist(rng.standard_normal(A.n_rows), layout, plan)
                 for _ in range(k)]))
            row = onto_row("nccl_kernel_onto", name, key, plan, X, bw,
                           f32_peak)
            check(launches.get(name, 0) > 0, f"nccl: {name} never launched")
            entries.append((name, replaces, launches[name], row))
        two_level = got["layer_launches"]["two_level"]
        rng = np.random.default_rng(SEED + 2)
        for label in ("R", "P"):
            plan, layout = got["rp"][label]
            X = to_dist(rng.standard_normal(plan.n_cols).astype(np.float32),
                        layout, plan, space="col")
            name = "ell_spmv_onto"
            row = onto_row("nccl_rect_onto", name,
                           f"sell/2x2/two_level/{label}", plan, X, bw,
                           f32_peak)
            check(two_level.get(name, 0) > 0,
                  f"nccl two_level: {name} never launched")
            entries.append((f"{name}/sell/2x2/{label}", ONTO[name][2],
                            two_level[name], row))
    finish(entries, lib, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
