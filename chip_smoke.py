#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the node-aware SpMV,
the multi-step exchange, wire integrity, the float64 simulate backend,
the distributed SpGEMM and the AMG solver path, the solver service, the
multi-process mesh, the MoE token dispatch, the hierarchical collectives,
the gemma2-2b serving path, gemma2-2b's prefill and training,
serving and training the MoE LMs (qwen3-moe-235b-a22b, deepseek-v2-236b),
serving whisper-small, zamba2-2.7b and rwkv6-3b, data-parallel training
across processes, and rwkv6-3b's chunked WKV.

    python3 chip_smoke.py            # full size; needs one CUDA GPU and nvcc

Phases, each fatal on failure:

1. environment: the card's name and power limit, torch and CUDA versions;
2. the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, all sources in parallel) and its seconds;
3. each SpMV kernel against its plain PyTorch version at the main path's
   shapes: max error, kernel / plain / library ms (CUDA events, median of
   20 single calls), the kernel's device time per launch (``device_ms``:
   events around 20 back-to-back launches) and the least time the card
   could take (bound).  The library is ``torch.sparse.mm`` on a CSR
   tensor of the real nonzeros and, for the BSR kernels, on a BSR tensor
   of the live blocks (the same bytes; a refusal by torch is printed and
   recorded as null).  The padded BSR kernel (``bsr_spmm_padded``) runs
   on ``BSR.from_csr`` of the main-path matrix with (8, 128) blocks and
   of the BSR-path matrix with (128, 128) blocks, each first driven
   through ``bsr_spmv`` and held against the float64 host CSR matvec.
   Every BSR layout is also held at nv = 3 and 8 and with its slots
   permuted within each block row (padding inside the rows), and three
   ragged block shapes ((4, 24), (12, 20), (5, 6); 37 slots a row) go
   through all three BSR entry points; packed and concatenated stay
   bit-equal;
4. the main path at full size: the paper's rotated anisotropic diffusion
   (FE 9-point, eps 0.001, theta pi/6) on a 2024 x 2024 grid (4,096,576
   rows) over Topology(32, 16), 512 ranks: ``op @ v`` for nv = 1 and 8,
   then ``op.T @ u``, held against a float64 host CSR matvec at rtol 1e-4
   / atol 1e-5, through the ELL kernel;
5. the fused-BSR forward on a 512 x 512 grid over the same topology,
   packed and concatenated x bit-equal, both against the float64 oracle;
6. the standard method (Algorithm 1, the paper's baseline) on the main
   path's matrix and topology: forward nv = 1 and 8, then the transpose
   (the live-slot scatter, and the literal adjoint timed beside it),
   against the same oracle, through the ELL kernel; padded vs effective
   exchange bytes and the paper's Blue Waters message model for both
   methods; then the standard fused-BSR forward at the BSR path's size;
7. the multi-step exchange on the main path's matrix and topology:
   ``choose_comm``'s verdicts with every candidate's injected inter-node
   bytes, then ``method="multistep"`` forward nv = 1 and 8 and the
   transpose against the same oracle, through the ELL kernel (held
   against its plain version at this plan's shapes), the direct
   exchange's padded vs live bytes, its live-slot and literal padded
   forms bit-equal and timed side by side, and ``threshold=1`` bit-equal
   to the node-aware operator of phase 4 (transposes in PyTorch's
   deterministic mode);
8. wire integrity on the main path's matrix and topology, for the nap,
   multistep and standard methods (``integrity="detect"``, ELL): clean
   detect applies at nv = 1 and 8 in both directions, bit-equal to the
   uninstrumented program (transposes in deterministic mode) with zero
   wire and ABFT mismatches; for every message phase and direction one
   real edge whose payload is neither all zero nor constant (from a
   recorded clean run; each kind's sender in the first or the second
   half of the ranks by turns, the bitflips of the inter, pair and
   direct exchanges from the first half to the second, so phase 9h
   can replay them across two processes), every fault kind on it
   detected with the receiver, slot, phase and scope ``scope_for``
   gives, and a compute bitflip on bit 30 of a value in [0.1, 1)
   caught by ABFT (the last rank forward, the first transposed);
   device-program ms (median of 5) and peak memory, bare and
   instrumented; then
   ``integrity="recover"`` bit-equal to the clean result after one retry
   each way, one detect apply of the fused-BSR forward at the BSR path's
   grid, and the float64 simulate backend: all three methods at the BSR
   path's grid against the device programs and the float64 host product,
   the node-aware method at full size against phase 4's device results,
   and one scripted wire fault attributed as on the device;
9. the AMG solver path on the same operator family at the AMG grid
   (``--amg-n``, 1024 x 1024: 1,048,576 rows, over Topology(32, 16), a
   quarter of the main path's rows: the hierarchy, the level operators
   and the service's CG are host work that grows with them): the
   smoothed-aggregation
   hierarchy (theta 0.1, coarse_size 2 x ranks), ``level_operators(...,
   comm="auto", materialize=True, spgemm_backend="torch")``: every
   coarse A is the product of two device SpGEMMs (``A @ P``, then
   ``R @ AP``), held against the host assembly at the reference's
   chained float32 tolerance (rtol 5e-5 x depth), and the SpGEMM run
   counter must rise by 2 x (levels - 1); per product the host compile
   seconds, ``exp_pad``, ``c_nnz_pad``, the value pads, padded vs live
   value bytes per phase, the inter-node value bytes of the nap and
   standard plans (the paper's setup traffic), device-program ms (CUDA
   events, median of 10), peak memory and a bound (the expansion read
   once, C written once, the live values exchanged once, at 3.35 TB/s);
   per level the rows, nnz, both directions' exchange and local-format
   verdicts and the host seconds of chooser and compile; every
   distributed level's ``A @ v``, ``A.T @ u``, ``P @ x``, ``R @ r`` and
   lazy ``(R @ A @ P) @ x`` against float64 host products (rtol 1e-4,
   atol 1e-5 of max |ref|), the ELL kernel against its plain version on
   each level's arrays, each level's device programs timed; level 0's
   two products in float64 against host ``csr_matmul`` (rtol 1e-12, atol
   1e-13 x max |ref|), its ``galerkin(materialize=True)`` against the
   lazy chain (one apply each, timed side by side) and its standard
   ``A @ P`` from the live slots of the pair exchange (the literal
   table's bytes printed); then 5 iterations of AMG-preconditioned CG
   through the device operators beside the same solver on float64 host
   matvecs, the true residual of each iteration side by side, and the
   V-cycle's wall and ELL launches (``level_operators``, the device PCG
   and the V-cycle in deterministic mode, so phase 9h can hold two
   processes to them bit for bit);
9b. the distributed SpGEMM at the BSR path's grid: level 0's ``A @ P``
   on the simulate backend bit-equal to ``csr_matmul`` (nap and
   standard), the device program in float32 (rtol 1e-4, atol 1e-4) and
   float64 (rtol 1e-12, atol 1e-13),
   ``smoothed_aggregation_hierarchy(rap=distributed_rap(backend=
   "torch", cross_check=True))`` with every level's structure equal to
   the host hierarchy's, and ``integrity="detect"`` with every fault
   kind on a live edge of every message phase (nap: full, init, inter,
   final; standard: pair) detected with its ``(phase, node, proc,
   slot)``, ``"recover"`` bit-equal to the clean product and the clean
   detect run bit-equal to off (deterministic mode; for the standard
   method that holds the instrumented program's literal padded pair
   exchange against the bare program's live slots);
9c. the port's three examples, ``repro_torch.examples.quickstart``,
   ``amg_spmv`` and ``moe_nap_dispatch``, on the card to their final
   checks;
9d. the solver service (``repro_torch.serve.SolverService``, backend
   torch, checkpoints every 4 CG iterations) on phase 9's matrix and
   the main path's topology: 8 spmv requests run as ONE nv = 8 apply (the ELL
   launches of one direct ``op @ V``, one plan-cache miss) within rtol
   1e-4 / atol 1e-5 of the float64 host product; ``update_values`` with
   an integer SPD matrix of the same structure hot-swaps (no program
   build, the staged ELL values written in place: same ``data_ptr()``),
   its products exact, the swap's host seconds beside a fresh
   ``compile_nap``; each column of an nv = 8 apply against its own
   nv = 1 apply (printed); node5 dies at CG iteration 8 of two solves
   and node21 at the next step (phase 9h's plan; this run is the one
   phase 9h's processes are held to): the service evicts both at once,
   lands on Topology(30, 16) with an elastic partition, releases the
   old plan's tensors, restores the iteration-8
   checkpoint and finishes every request, the spmv bit-equal to the
   uninterrupted run and the exact product, each solve bit-equal to
   ``batched_cg`` on an operator compiled on its own on the survivor
   layout from the restored iterate; rebuild, checkpoint and CG
   iteration numbers; then at the BSR path's grid a seeded random fault
   plan (message faults under ``integrity="recover"``) replayed twice
   with identical logs, stats and results, and a torn checkpoint after
   which the previous committed step stands;
9e. the multi-process mesh on the main path's matrix and topology: two
   processes started by ``repro_torch.mesh.launcher.launch`` (this
   script re-entered with ``--mesh-child``; started after phase 8's
   device programs, they run while this process runs the simulate
   backend and phase 9's hierarchy, level operators and float64 host
   twins, work that times nothing on the card, and phase 9 waits for
   them before its first timing; their checks follow phase 9d) share
   the card over gloo,
   each owning 16 of the 32 nodes (256 ranks); per process the NAP
   forward at nv = 1 and 8 and transpose, the multistep forward and
   transpose and the standard forward at nv = 1, each bit-equal to the
   single-process results of phases 4, 7 and 6 (transposes in
   deterministic mode on both sides) and to the other process's, and
   within rtol 1e-4 / atol 1e-5 of the float64 host product; then
   ``operator(a)`` with no topology (discovered Topology(2, 16)); per
   process and apply the wall, ELL launches, peak, bytes sent to the
   other process and staged through pinned host memory, device-program
   ms (CUDA events, the median of as many calls as fit in ~1 s) beside
   the single-process ones, host compile s; one process over NCCL (run in
   phase 4, while its plan is live: this process attached as a 1-process
   NCCL job, the nap forward bit-equal to phase 4's, NCCL's node and
   split all-to-alls and a stage / all-gather round trip on device
   tensors against the one-process permutations); last
   ``measure_phase_walls`` over the two processes (the main path's
   plans and the discovered one) and ``PostalParams.calibrated`` fitted
   to them per process (one exchange of the process's buffer a record)
   beside the Blue Waters constants, with the card's name and power
   limit;
9h. the stack across processes, in the children of 9e's launch (each
   owning 16 of Topology(32, 16)'s nodes): (a) integrity on each
   method's plan (``integrity="detect"``, the compile cache handing over
   9e's plan): the NAP forward at nv = 1 and 8 and its transpose, the
   multistep forward and transpose and the standard forward at nv = 1,
   bit-equal to phases 4, 6 and 7, with no mismatch; bare and
   instrumented device ms, peak and bytes to the other process and
   staged (checksum words included); phase 8's faults replayed, each
   raising phase 8's one-process mismatch list in both processes; one
   cross-process bitflip a run under ``"recover"``, bit-equal to the clean
   result with equal counters; (b) ``level_operators(materialize=True)``
   from phase 9's hierarchy (an npz, at the AMG grid), 5 PCG
   iterations and one V-cycle
   in deterministic mode, every residual and the V-cycle
   bit-equal to phase 9's, and one iteration's device busy share; (c) phase 9d's
   service scenario (the AMG grid) over the node blocks (process 0 writes the
   checkpoints): log, stats, plan-cache counters, tickets, results and
   checkpoint digests equal 9d's, then one node lost raises
   ``DiscoveryError`` in both; per-process walls beside the one-process
   ones, with the card's name and power limit;
9f. MoE token dispatch at qwen3-moe-235b-a22b's full width (d_model 4096,
   128 experts, top-8, moe_dff 1536, capacity factor 1.25; weights in
   bf16 from the seed on the card) on Topology(4, 8), 32 ranks batched
   on the card, x [16, 512, 4096] bf16 (4 prompts of 512 tokens a pod):
   (a) the CUDA wire codecs (``encode_torch`` / ``decode_torch``) word
   for word against the numpy copy over ``codec_sweep`` (every bf16
   value and midpoint, every fp8 value, midpoint and subnormal step,
   +-inf, NaN, +-449 to +-1e30, seeded draws, bf16 tokens to fp8), and
   what the card's raw ``.to(float8_e4m3fn)`` does out of range; (b) the
   island in float32 (weights upcast, the capacity factor doubled until
   no copy drops) for flat, nap and auto against ``moe_apply_local``
   (chunks of 256 tokens), max abs error / max |oracle| <= 1e-4; (c) at
   bf16 and capacity factor 1.25 every mode x wire (f32, bf16, fp8):
   device ms (events, median of 10), peak, dropped copies per stage,
   the inter-pod bytes counted at the communicator (tokens equal to the
   buffer arithmetic, meta, combine) beside ``dispatch_traffic`` of the
   island's own routing, auto's resolved mode, and the quantized
   outputs within ``wire_error_bound`` of the same mode's f32 wire; nap
   below flat and fp8 below bf16 in counted bytes; (d) ``dispatch_operator``
   on the host at the same geometry (8192 tokens of a representative
   routing, nv = 4): ``op @ X`` and ``op.T @ Y`` per mode x wire within
   the wire budgets, and an fp8 bitflip on an ``inter`` message detected
   and attributed; (e) two gloo processes sharing the card (this script
   re-entered with ``--moe-child``), 2 pods each, flat and nap at bf16,
   bit-equal to the one-process island, with the token bytes each sends
   the other beside the buffer arithmetic;
9g. the hierarchical collectives (``repro_torch.core.hier_collectives``)
   on one gemma2-2b decoder layer's gradient (q, k, v, o, the gated FFN's
   three matrices and four norms, shapes from the model's ``block_init``:
   77,865,984 f32 values a rank, drawn from the seed on the card) over
   Topology(4, 8), 32 ranks batched on the card (9.97 GB): (a)
   ``nap_psum_tree`` and ``flat_psum_tree``: device ms (events, median of
   10), the bound (input read and output written once at 3.35 TB/s),
   peak, the inter-pod bytes counted at the communicator against the
   buffer arithmetic (nap exactly 1/8 of flat), each within 1e-5 of max
   |float64 sum| (numpy on the host) and of each other, nap's replicas
   bit-equal; (b) ``nap_reduce_scatter`` then ``nap_all_gather`` on the
   same bucket, rank (o, i) holding chunk i * 4 + o of nap_psum's result
   bit for bit and the gather equal to it; (c) ``nap_all_to_all``
   against ``flat_all_to_all`` with the bucket as [32, 2,433,312] a rank,
   bit-equal, ms and counted bytes; (d) ``nap_psum_compressed`` within
   the reference's 0.02 of max |sum|, replicas bit-equal, a second step
   fed the residual and the two-step mean's error, int8 bytes against the
   f32 nap's; (e) ``nap_moe_dispatch`` with the qwen3-moe router on x
   [16, 512, 4096] bf16, 256 tokens a rank, top-8 experts on chip
   expert // 4, capacity 256: every (token, chip) pair delivered once
   with its payload bit-exact or dropped at a full buffer, ms, padded vs
   live inter-pod bytes; (f) two gloo processes sharing the card (this
   script re-entered with ``--coll-child``) on Topology(2, 4), one pod a
   process, the same layer's bucket: the psums, the int8 psum and the
   all-to-all bit-equal to one process (sha256 of every rank's block),
   the bytes each process sends the other against the blocks' arithmetic,
   and the walls;
10. the decode-attention kernel against its plain version at gemma2-2b's
   decode_32k shapes: B = 8, S = 32768, Hkv = 4, g = 2, D = 256, softcap
   50, lengths ragged in [1, S] (1, 17, 4096, 4097, S and three drawn
   from the seed); the bf16 [B, S, Hkv, D] cache read in place with
   window 0 and with window 4096, then a float32 [B, Hkv, S, D] copy.
   Max error against a per-sequence tolerance that scales with the
   sequence's output (``attn_tolerance``: a dropped partial or skipped
   rows of a long sequence fail it), kernel /
   plain / ``scaled_dot_product_attention`` ms (softcap 0 for the
   library, where it computes the same function), the profiler's device
   time of the kernel's launches, the bound over the k/v rows inside the
   masks and the partials' scratch beside the k/v bytes; then
   chameleon-34b's heads (Hkv 8, g 8, D 128, bf16) at phase 20's
   decode_32k lengths, timed the same way; one query row a kv head (g =
   1): zamba2-2.7b's heads (Hkv 32, D 80) and whisper-small's (Hkv 12, D
   64) at the same lengths, and whisper's cross-attention as served (B
   4, all 1500 encoder rows), timed the same way on the g = 1 kernel
   (units of a run of positions and a group of kv heads, one launch; its
   plan printed beside the k/v bytes); then the kernel's other
   instantiations (one and two M-tiles of 16 rows, a group of more than
   32 rows, both D buckets, both types, and g = 1 in float32) at small
   shapes, each split over blocks (with the combine at g >= 2, merged by
   each group's last unit at g = 1) and in one block, untimed;
11. the serving path at full width: gemma2-2b, all 26 layers, bf16,
   weights drawn from the seed on the card, through
   ``repro_torch.launch.serve.generate``: batch 4, a 256-token prompt
   (512 before a cut for the time limit; the first half of phase 14's)
   teacher-forced through ``decode_step``, then 32 greedy tokens,
   max_seq 1024.  Median step ms, the kernel's launches (must equal
   layers x steps), peak memory, the profiler's busy share of a step,
   the step's bound (every parameter byte and the cache rows read once),
   finite logits; then the kernel against its plain version on the
   served bf16 cache (read in place, 288 of 1024 positions) of an even
   layer (window 4096) and an odd one (window 1024), with a query drawn
   from the seed, at the same tolerance and timed;
12. the whole decode step checked on the card: the same config with 2
   layers in float32, 8 steps through the kernel, then the same steps
   with the plain version swapped into ``models.attention`` by this
   script, logits compared at atol 1e-3;
13. prefill held on the card, on phase 12's config and weights:
    ``LM.prefill`` of a seeded [4, 64] prompt, its last logits and its
    k / v against the teacher-forced ``decode_step`` at atol 1e-3, and
    ``LM.hidden`` + the head against every teacher-forced step at rtol
    2e-2 / atol 2e-3;
14. prefill at full width on phase 11's weights (26 layers, bf16, 4 x
    512 tokens, whose first 256 phase 11 served): device ms (CUDA
    events, median of 5) beside phase 11's teacher-forced prompt, peak
    memory, busy share; the prefill of the first 256 tokens, its last
    logits' max |diff| against the teacher-forced ones and whether the
    greedy ids agree (recorded); finite logits (gated);
15. (run inside phase 9, while it waits for the 9e / 9h children,
    after phase 25's first serving runs, 25a; its
    CPU half in a thread from phase 8 on, its results kept on the card)
    training held on the card, phase 12's config (``grad_accum`` 1):
    3 ``make_train_step`` steps of seeded bigram batches on the card and
    the same 3 on the CPU from the same weights, for float32 and int8
    moments: losses within rtol 1e-4, parameters within 2 lr x steps
    and 99% of them within 1e-6 of max |p|, int8 codes within +-1;
    ``grad_accum`` 2 against 1 on the same batches at the same
    tolerance; in deterministic mode 3 steps of
    ``repro_torch.launch.train.train`` straight against 2 steps, the
    checkpoint, ``resume`` and 1 step, bit-equal parameters, state and
    losses;
16. ``repro_torch.launch.train.main`` at full width (``--arch gemma2-2b
    --full --steps 8 --batch 4 --seq 512``: 26 layers, bf16 weights,
    fp32 masters and moments, remat): the driver's own decrease rule and
    finite losses and grad norms gated; step ms (CUDA events, median of
    steps 2-8) split into forward + backward and the AdamW update,
    tokens/s, the share of the bf16 peak (6 N T), peak memory and the
    profiler's busy share of one more step;
17. (run inside phase 9 after phase 15) the port's training example,
    ``repro_torch.examples.train_lm``, at its defaults but 150 of its 300
    steps, to its 0.5 loss-drop assertion;
19. the MoE LMs held on the card, their reduced configs in float32
    with weights from the seed: (a) qwen3-moe's 8 decode steps through
    the kernel, then with the plain version swapped in, logits at atol
    1e-3 (phase 12's check); (b) both archs' ``LM.prefill`` of a seeded
    [4, 64] prompt against the teacher-forced ``decode_step``, last
    logits and every cache tensor (``k`` / ``v`` or MLA's ``c_kv`` /
    ``k_rope``, deepseek's dense layer too) at atol 1e-3, and ``hidden``
    + head against every step at rtol 2e-2 / atol 2e-3 (phase 13's
    check); (c) both archs on ``mesh=Topology(2, 2)`` (flat and nap, the
    f32 wire, the capacity factor doubled until no copy drops): prefill
    logits within 1e-4 of max |logits| of the local path's;
20. the MoE LMs at full width, their depth cut to ``--moe-layers`` (4:
    qwen3-moe 4 of 94 layers, 22.39 GB; deepseek-v2 its dense first
    layer and 3 MoE layers of 60, 26.61 GB), bf16 weights from the seed
    on the card, one model at a time: ``serve.generate`` with batch 4, a
    32-token prompt teacher-forced and 32 greedy tokens, max_seq 128
    (median step ms, the decode kernel's launches: layers x 64 for
    qwen3-moe and none for deepseek's MLA, which decodes in plain
    float32 as the reference does; peak, busy share, the step's bound
    of every parameter byte and the cache rows read once, the cache
    bytes a token and layer, finite logits); for qwen3-moe the kernel
    against its plain version on the served bf16 cache (g = 16, D =
    128), timed beside SDPA; then ``LM.prefill`` of a seeded [4, 512]
    prompt through the local path (the dense-masked oracle in chunks of
    256 tokens) and through the island on Topology(4, 8) with the
    config's own dispatch, wire and capacity factor (one sequence a
    pod): device ms (CUDA events, median of 3), peak, the island's
    dropped copies, finite logits (gated), the island's max |diff| from
    the local path and whether the greedy ids agree (recorded);
22. training the MoE LMs through the island, held on the card: the
    reduced configs in float32 on Topology(2, 2) with the f32 wire and
    capacity factor 4, in deterministic mode, for flat (float32 moments)
    and nap (int8 moments): the island LM's gradients against the local
    LM's on the same weights (drawn on the CPU) and bigram batch, every
    leaf within 1e-5 of its max |grad| with no copy dropped; 3
    ``make_train_step`` steps on the card against the same 3 on the CPU
    (losses rtol 1e-4, parameters as phase 15 holds them); a bf16-wire
    island raising under grad;
23. training the MoE LMs at full width through the island on
    Topology(4, 8), one after the other: qwen3-moe cut to 1 layer
    (3.732 B parameters), deepseek-v2 to its dense first layer and one
    MoE layer (5.359 B), bf16 weights from the seed, fp32 masters, the
    configs' int8 moments, remat, grad_accum 1, each config's dispatch,
    the f32 wire (qwen3-moe's config ships bf16, which has no gradient):
    first a gradient check against the local oracle on the same weights
    and a 4 x 512 bigram batch, at the capacity factor (doubled from 1.25)
    at which the island drops nothing, each leaf's max |diff| over its
    max |grad| gated at ``MOE_GRAD_GATE``; then 4 steps at capacity
    factor 1.25: step ms (median of steps 2-4) split into forward +
    backward and the update, tokens/s, the share of the bf16 peak, peak
    memory, busy share, drops per stage and the counted inter-pod bytes
    of a forward and of a backward, finite losses and grad norms gated;
24. the last three families held on the card: whisper-small,
    zamba2-2.7b and rwkv6-3b, reduced configs in float32, weights from the
    seed on the card and copied to the CPU: prefill logits of a seeded [4,
    32] prompt (whisper over seeded frames) and 8 teacher-forced decode
    steps (whisper's cross caches from ``cross_cache``) on the card
    against the CPU within rtol 1e-4 / atol 1e-4, the card's decode
    through the kernel (whisper two launches a layer and step, its
    cross-attention among them; zamba2 one a shared-block application;
    rwkv6 none), the CPU's through the plain version;
25. the three at full width and depth, bf16 weights from the seed on the
    card (whisper-small 294,683,904 parameters, zamba2-2.7b 2,340,162,720,
    rwkv6-3b 2,900,298,240), one at a time: ``serve.generate`` with batch
    4, a 32-token prompt teacher-forced and 32 greedy tokens, max_seq 128
    (whisper's cross caches from frames [4, 1500, 768] drawn from the
    seed), run twice (the first run, 25a, inside phase 9's wait for
    phase 15's CPU half, untimed): the kernel's launches in both
    (whisper 2 x 12 x 64, zamba2 9 x 64, rwkv6 none), finite logits and
    the same greedy tokens both times (gated); median step ms against its bound (the weights a step
    reads, the attention rows and the recurrent states read and written
    once, at 3.35 TB/s), busy share, peak; the kernel on the served
    caches (whisper's self and cross, zamba2's first application) against
    its plain version; then ``prefill`` of 4 x 512 seeded tokens (zamba2;
    rwkv6 through the stepwise recurrence its config ships) or 4 x 448
    over 4 x 1500 frames (whisper): ms (median of 3) against its bound
    (the products' FLOPs at the bf16 peak, or the weights' bytes), peak,
    finite logits;
26. (run inside phase 9's wait, after phase 17) training the three held
    on the card: reduced configs in float32, weights drawn on the CPU, 3
    ``make_train_step`` steps of the driver's batches (whisper over
    ``data.step_frames``) on the card against the same on the CPU, float32
    and int8 moments (losses rtol 1e-4, parameters as phase 15 holds
    them); zamba2 also at its full config's ``ssm_chunk`` 128 over [2,
    256] tokens, where the unmasked exponent's gradient is NaN: grads
    finite, card against CPU within 1e-4 of each leaf's max |grad|;
27. training the three at full width, one at a time (whisper-small 4 x
    448 over 4 x 1500 frames and zamba2-2.7b 4 x 512 at full depth,
    rwkv6-3b 4 x 512 cut to 4 of 32 layers, its stepwise recurrence),
    bf16 weights from the seed, fp32 masters, the configs' float32
    moments, remat, grad_accum 1, 3 steps (rwkv6 2; 4 before phases 29
    and 31): step ms (median of the steps after the first)
    split into forward + backward and the update, tokens/s, 6 N T's share
    of the bf16 peak beside the products' FLOPs x 3, peak memory and busy
    share (rwkv6's from a 4 x 64 step), finite losses and grad norms
    gated;
28. the operator counter and the dry run's roofline
    (``repro_torch.core.op_analysis``, ``launch.dryrun``): (a) in a
    child process started with phase 8 (host work, ``--count-child``),
    meta counts of gemma2-2b's train_4k, prefill_32k and decode_32k on
    16x16, qwen3-moe's decode_32k on 2x16x16 through the island (its
    pod-crossing bytes > 0) and zamba2-2.7b's long_500k, each cell's
    roofline row; (b) gemma2-2b's greedy step (phase 11's batch and
    cache), its 4 x 512 prefill (phase 14) and its training step (phase
    16) counted once on the card inside those phases and once on meta in
    the child: dot FLOPs, bytes and the kernels' declared work equal
    (gated), then the one-card roofline time against the median those
    phases measured, as a share (no gate); (c) in phase 4, one NAP
    forward counted on the card: its exchanges' node-crossing bytes per
    axis equal ``inter_node_bytes()`` over the same apply and its ELL
    calls the launches (gated);
29. data-parallel training across two gloo processes sharing the card
    (children of this script, ``--dp-child``, started with phase 9's
    host work and waited for before its first timing on the card; the
    checks here): (a) ``repro_torch.launch.train.train`` over the job's
    data axis, whisper-small at full width (bf16, fp32 masters, remat),
    phase 27's 4 x 448 tokens over 4 x 1500 frames split 2 + 2, 3
    steps: each step's ms split into forward + backward, the all-reduce
    (its wall beside it) and AdamW, bytes staged and sent to the other
    process, peak memory a process; the processes' parameter digests
    equal every step, finite losses, and step 1 against process 0's
    one-process step on the whole batch from the same weights (loss
    rtol 1e-3, the reduced gradient within 2^-6 of each leaf's max
    |grad|), all gated; (b) held: reduced gemma2-2b and qwen3-moe as
    replicas, qwen3-moe and deepseek-v2 on the island over Topology(2,
    2) across the processes (flat and nap, f32 wire), float32, 3 steps
    each against its one-process run on the card (losses rtol 1e-4,
    digests equal), gated;
30. rwkv6-3b's chunked WKV (``rwkv_chunk`` 64, the dry run's form): (a)
    inside phase 9's wait, before phase 15 (nothing timed): the reduced
    config in float32 with every ``w0`` at 4.7 (every decay below
    float32's normal range: where the decay underflows), weights drawn on
    the CPU, at chunk 8 over 4 x 32 bigram tokens: step 1's gradient on
    the card against the CPU (1e-4 of each leaf's max |grad|) and against
    the stepwise form on the card (1e-5; differences under 2^-126 not
    counted), every gradient finite, then 3 ``make_train_step`` steps on
    both (losses rtol 1e-4, finite grad norms, parameters as phase 15
    holds them); and phase 27's cut (4 of 32 layers, full width) with its
    bf16 weights cast up to float32: step 1's chunked gradient against the
    stepwise one within 1e-4 of each leaf's max; (b) ``LM.prefill`` of
    phase 25's 4 x 512 prompt at full width and depth on phase 25's
    weights: ms (median of 3) against phase 25's stepwise prefill, its
    bound, the operator-boundary bytes of one call (``count_ops``), busy
    share, peak; logits and every layer's final state against phase 25's
    stepwise prefill (layer 0's S within 1e-5, layer i's within 2 i x
    2^-8, the logits within 32 x 2^-8 of their max: bf16 roundings of
    each layer's output carried down the stack), finite logits; (c) step
    1's bf16 gradient on phase 27's cut against phase 27's stepwise step
    1, each against the float32 gradient of the same weights (the chunked
    form's worst leaf within 2x the stepwise form's), then 2 steps at
    full depth (32 layers; bf16, fp32 masters, float32 moments, remat, 4
    x 512 bigram tokens; 3 before phase 31): step 2's ms split into
    forward + backward and the
    update, tokens/s, 6 N T's share of the bf16 peak, peak memory, busy
    share, finite losses and grad norms gated;
31. zamba2-2.7b's long_500k decode (``configs/shapes.py``: one token
    against a 524,288-position cache, batch 1), last and alone on the
    card: full width and depth, bf16 weights from the seed,
    ``init_cache(1, 524288)`` with each of the 9 shared-block
    applications' k and v drawn from the seed in place (48.318 GB),
    ``length`` and ``pos`` at 524,287; one ``decode_step``, the kernel
    held against its plain version at that length on the step's own q
    (first application, ``attn_tolerance``, with ms, plain and SDPA
    beside it), then 5 timed steps (``length`` / ``pos`` reset before
    each): the step's wall, the 9 kernels' device time against their
    14.42 ms bound, the card's busy share of a profiled step, peak
    memory, launches (9 a step), finite logits, all gated;
21. the whole script's seconds with every phase's, a JSON line of every
    kernel (with ``device_ms`` and, for the BSR kernels,
    ``library_bsr_ms``; the decode kernel again at qwen3-moe's served
    shapes, at zamba2's heads, at whisper's cross-attention and at
    long_500k's first application, each with its own path's launches),
    then the result line.

Launch counts are reset right before each path is driven and read right
after, and the peak of allocated device memory is reset and read around
it.  Each phase frees its tensors before the next.  TF32 is switched off,
so the plain versions' products are f32.  Each phase prints its
seconds.  ``--n``, ``--bsr-n`` and ``--amg-n`` shrink the grids of the
SpMV, BSR and AMG / service phases, ``--lm-layers`` the depth of phase
11 and ``--moe-layers`` that of phase 20, for a short first call after a
kernel change.
"""
import argparse
import atexit
import dataclasses
import gc
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script needs a GPU")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.amg import (LevelOperators, amg_vcycle, cg_solve,  # noqa: E402
                             level_operators, smoothed_aggregation_hierarchy)
from repro_torch.api import operator  # noqa: E402
from repro_torch.comm import choose_comm  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.cost_model import (BLUE_WATERS,  # noqa: E402
                                         BLUE_WATERS_POSTAL, PostalParams)
from repro_torch.core.integrity import (FAULT_KINDS, IntegrityError,  # noqa: E402
                                        MessageFault, message_phases, scope_for)
from repro_torch.core.partition import contiguous_partition  # noqa: E402
import repro_torch.core.spmv_torch as spmv_torch  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.kernels import build_all, launches, reset_launches  # noqa: E402
from repro_torch.kernels.bsr_spmv import (bsr_spmm_padded,  # noqa: E402
                                          bsr_spmm_padded_ref, bsr_spmv,
                                          fused_bsr_spmm,
                                          fused_bsr_spmm_packed,
                                          fused_bsr_spmm_packed_ref,
                                          fused_bsr_spmm_ref)
from repro_torch.kernels.decode_attn import (decode_attention_grouped,  # noqa: E402
                                             decode_attention_ref)
from repro_torch.kernels.decode_attn.kernel import (TILE,  # noqa: E402
                                                    g1_launch, g1_scratch, g1_units,
                                                    launch_blocks, scratch_floats,
                                                    split_units)
from repro_torch.kernels.ell_spmv import (ell_spmm_packed,  # noqa: E402
                                          ell_spmm_packed_ref)
from repro_torch.launch.serve import Clock, generate  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
import repro_torch.optim.adamw as adamw_mod  # noqa: E402
from repro_torch.optim.adamw import tree_at, tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.amg.matmul import csr_matmul  # noqa: E402
from repro_torch.examples import (amg_spmv, moe_nap_dispatch, quickstart,  # noqa: E402
                                  train_lm)
import repro_torch.spgemm.spgemm_torch as spgemm_torch  # noqa: E402
from repro_torch.spgemm import (assert_matches_host, build_spgemm_plan,  # noqa: E402
                                clear_spgemm_cache, compile_spgemm,
                                distributed_rap, distributed_spgemm,
                                pack_b_values, spgemm_program,
                                torch_spgemm_runs, unpack_c_values)
from repro_torch.spgemm.plan import message_value_size  # noqa: E402
from repro_torch.core.hier_collectives import (flat_all_to_all,  # noqa: E402
                                               flat_psum_tree, nap_all_gather,
                                               nap_all_to_all, nap_moe_dispatch,
                                               nap_psum_compressed, nap_psum_tree,
                                               nap_reduce_scatter)
from repro_torch.models import (attention, build_model,  # noqa: E402
                                count_active_params, count_params)
from repro_torch.models.common import dense_init, head_logits  # noqa: E402
from repro_torch.models.transformer import MOE_CHUNK, block_init  # noqa: E402
from repro_torch.models.moe import (_router as moe_router,  # noqa: E402
                                    moe_apply_local, moe_init)
from repro_torch.moe import (build_dispatch_plans, codec_sweep,  # noqa: E402
                             decode_np, decode_torch, dispatch_error_budget,
                             dispatch_partitions, dispatch_traffic, encode_np,
                             encode_torch, routing_matrix, wire_bytes, wire_eps,
                             wire_error_bound)
from repro_torch.moe.dispatch import (EPInfo, dispatch_operator,  # noqa: E402
                                      moe_apply_sharded)
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.core.spmv_torch import clear_compile_cache  # noqa: E402
from repro_torch.mesh import (DiscoveryError, attach,  # noqa: E402
                              default_registry, detach,
                              fetch_mesh_array, job_barrier, launch, mesh_env,
                              mesh_for, pick_coordinator, stage_mesh_array)
from repro_torch.mesh.comm import (inter_node_bytes,  # noqa: E402
                                   live_all_to_all, node_all_to_all,
                                   reset_inter_node_bytes)
from repro_torch.mesh.scaling import measure_phase_walls  # noqa: E402
from repro_torch.serve import (FaultPlan, SolverService, batched_cg,  # noqa: E402
                               dead_node, torn_checkpoint)
from repro_torch.sparse import BSR, CSR, rotated_anisotropic_2d  # noqa: E402
from repro_torch.core.op_analysis import count_ops  # noqa: E402
from repro_torch.core.roofline import HEADER, build_roofline, model_flops_for  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.registry import param_shapes  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor
# cores (all kernels run f32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
U32 = 2.0 ** -24            # f32 unit roundoff
TOL = dict(rtol=1e-4, atol=1e-5)
DEV = torch.device("cuda")
T_START = time.perf_counter()


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings, in ms."""
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


def device_ms(fn, n=20, warmup=3):
    """Device time per launch: CUDA events around ``n`` back-to-back calls
    (after a warm-up), divided by ``n``.  The wrapper's host work overlaps
    the device's queue unless it is longer than the kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def host_apply(a, v, transpose=False):
    """float64 CSR matvec on the host, one bincount per rhs column."""
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    src, dst = (rows, a.indices) if transpose else (a.indices, rows)
    v2 = v.reshape(v.shape[0], -1)
    out = np.stack([np.bincount(dst, weights=a.data * v2[src, j],
                                minlength=a.shape[0])
                    for j in range(v2.shape[1])], axis=1)
    return out.reshape(v.shape)


def csr_from_coo(rows, cols, vals, shape):
    """A torch sparse CSR tensor on the card (the library yardstick)."""
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def check_close(name, got, want, slots, scale):
    """|kernel - plain| <= 2 * slots * u * max_i sum_k |a_ik x_k|: two
    summation orders of the same f32 products (slots = terms per sum)."""
    err = float((got - want).abs().max())
    tol = 2.0 * slots * U32 * scale
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_oracle(label, got, want, ref="float64 host CSR"):
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: bad result {got.shape}")
    np.testing.assert_allclose(got, want, **TOL)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"  {label}: matches {ref} (max abs err / max |ref| {rel:.3e})")


def free():
    """Drop the compile cache's plans with the phase's operators (the
    cache would keep their staged tensors alive), then the allocator's
    cached blocks."""
    clear_compile_cache()
    gc.collect()
    torch.cuda.empty_cache()


def ell_case(name, source, replaces, cols, vals, xs):
    """Kernel vs plain at one ELL call site; returns the kernels-line entry."""
    out = ell_spmm_packed(cols, vals, xs)
    plain = ell_spmm_packed_ref(cols, vals, xs)
    scale = float(ell_spmm_packed_ref(cols, vals.abs(),
                                      tuple(x.abs() for x in xs)).max())
    err = check_close(name, out, plain, cols.shape[-1], scale)
    nv = xs[0].shape[-1]
    p, n_rows = cols.shape[:2]
    n_x = sum(x.shape[1] for x in xs)
    live = cols >= 0
    a = csr_from_coo(
        (torch.arange(p * n_rows, device=cols.device).reshape(p, n_rows, 1)
         .expand_as(cols))[live],
        (cols.long() + (torch.arange(p, device=cols.device) * n_x)[:, None, None])[live],
        vals[live], (p * n_rows, p * n_x))
    x_cat = torch.cat(xs, dim=1).reshape(p * n_x, nv)
    lib = torch.sparse.mm(a, x_cat).reshape(p, n_rows, nv)
    print(f"  {name}: library result max_abs_err {float((lib - plain).abs().max()):.3e}")
    nbytes = (cols.nbytes + vals.nbytes + sum(x.nbytes for x in xs)
              + out.nbytes)
    bms, by = bound_ms(nbytes, 2.0 * int(live.sum()) * nv)
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=0, max_abs_err=err,
                 ms=time_ms(lambda: ell_spmm_packed(cols, vals, xs)),
                 device_ms=device_ms(lambda: ell_spmm_packed(cols, vals, xs)),
                 plain_ms=time_ms(lambda: ell_spmm_packed_ref(cols, vals, xs)),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(a, x_cat)))
    print(f"  {name}: shapes cols {tuple(cols.shape)} segments "
          f"{[tuple(x.shape) for x in xs]}; {nbytes / 1e6:.1f} MB; kernel "
          f"{entry['ms']:.4f} ms (device {entry['device_ms']:.4f}), bound {bms:.4f} ms "
          f"({by}), plain {entry['plain_ms']:.4f} ms, torch.sparse.mm CSR "
          f"{entry['library_ms']:.4f} ms")
    return entry


def bsr_library(label, crow, col, vals, size, x, want):
    """The same-format yardstick: ``torch.sparse.mm`` on a BSR tensor of
    the live blocks, which reads the kernel's bytes.  Its ms, or None
    (printed with torch's message) where torch on the card refuses it."""
    try:
        a = torch.sparse_bsr_tensor(crow, col, vals, size=size)
        got = torch.sparse.mm(a, x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, ValueError) as exc:
        print(f"  {label}: torch.sparse.mm on a BSR tensor of {tuple(vals.shape[1:])} "
              f"blocks refused: {' '.join(str(exc).split())[:300]}")
        return None
    print(f"  {label}: BSR library result max_abs_err "
          f"{float((got.reshape(want.shape) - want).abs().max()):.3e}")
    return time_ms(lambda: torch.sparse.mm(a, x))


def fmt_ms(ms):
    return "refused" if ms is None else f"{ms:.4f} ms"


def bsr_held(label, kernel, plain, cols, blocks, xs):
    """One BSR kernel call against its plain version (``check_close``);
    ``kernel`` and ``plain`` take (cols, blocks, xs).  Returns both
    results and the max error."""
    out, want = kernel(cols, blocks, xs), plain(cols, blocks, xs)
    scale = float(plain(cols, blocks.abs(), [x.abs() for x in xs]).max())
    err = check_close(label, out, want, cols.shape[-1] * blocks.shape[-1], scale)
    return out, want, err


def cat(xs):
    """The concatenated x (no copy when there is one segment, so that a
    timed call of the concatenated kernel times the kernel alone)."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)


# the three BSR entry points over (cols, blocks, xs) and their plain versions
BSR_PACKED = (lambda c, b, xs: fused_bsr_spmm_packed(c, b, xs),
              lambda c, b, xs: fused_bsr_spmm_packed_ref(c, b, xs))
BSR_CONCAT = (lambda c, b, xs: fused_bsr_spmm(c, b, cat(xs)),
              lambda c, b, xs: fused_bsr_spmm_ref(c, b, cat(xs)))
BSR_PADDED = (lambda c, b, xs: bsr_spmm_padded(c, b, xs[0]),
              lambda c, b, xs: bsr_spmm_padded_ref(c, b, xs[0]))


def permute_slots(cols, blocks, gen):
    """The same matrix with the slots of every block row in a random order,
    cols and blocks together, so that padding slots land inside rows."""
    ktot = cols.shape[-1]
    perm = torch.rand(cols.shape, generator=gen, device=DEV).reshape(-1, ktot).argsort(-1)
    flat = (torch.arange(perm.shape[0], device=DEV)[:, None] * ktot + perm).reshape(-1)
    return (cols.reshape(-1)[flat].reshape(cols.shape),
            blocks.reshape(cols.numel(), -1)[flat].reshape(blocks.shape))


def bsr_variants(label, fused, cols, blocks, xs1, gen):
    """The cases the kernel design must survive on one layout: nv = 3 and
    8, then nv = 1 with the slots permuted; each kernel against its plain
    version, the packed and concatenated kernels bit-equal.  ``fused``:
    the rank-batched layout (packed and concatenated), else the padded
    one of one matrix."""
    for case in ("nv=3", "nv=8", "permuted slots"):
        c, b, xs = cols, blocks, xs1
        if case == "permuted slots":
            c, b = permute_slots(cols, blocks, gen)
            print(f"  {label} permuted: {int(((c[..., :-1] < 0) & (c[..., 1:] >= 0)).sum())}"
                  f" padding slots before a live one")
        else:
            xs = [torch.randn((*x.shape[:-1], int(case[3:])), generator=gen, device=DEV)
                  for x in xs1]
        if fused:
            o_p = bsr_held(f"{label} packed {case}", *BSR_PACKED, c, b, xs)[0]
            o_c = bsr_held(f"{label} concatenated {case}", *BSR_CONCAT, c, b, xs)[0]
            if not torch.equal(o_p, o_c):
                raise AssertionError(f"{label} {case}: packed and concatenated kernels differ")
            del o_p, o_c
        else:
            bsr_held(f"{label} {case}", *BSR_PADDED, c, b, xs)
        del c, b, xs
        free()


def ragged_bsr_cases(gen):
    """Block shapes off the 16-byte path and off the 8-row band, on small
    matrices of 3 ranks, 7 block rows and 37 slots (past one 32-id load),
    padding anywhere (block row 0 all padding): every entry point against
    its plain version at nv = 1, 3 and 8."""
    p, nbr, ktot, seg = 3, 7, 37, (5, 3, 4)
    for bm, bn in ((4, 24), (12, 20), (5, 6)):
        cols = torch.randint(0, sum(seg), (p, nbr, ktot), generator=gen, device=DEV,
                             dtype=torch.int32)
        pad = torch.rand((p, nbr, ktot), generator=gen, device=DEV) < 0.4
        pad[:, 0] = True
        pad[..., 1] = True
        cols[pad] = -1
        blocks = torch.randn((p, nbr, ktot, bm, bn), generator=gen, device=DEV)
        blocks[pad] = 0.0
        for nv in (1, 3, 8):
            xs = [torch.randn((p, n, bn, nv), generator=gen, device=DEV) for n in seg]
            label = f"ragged ({bm}, {bn}) nv={nv}"
            o_p = bsr_held(f"{label} packed", *BSR_PACKED, cols, blocks, xs)[0]
            o_c = bsr_held(f"{label} concatenated", *BSR_CONCAT, cols, blocks, xs)[0]
            if not torch.equal(o_p, o_c):
                raise AssertionError(f"{label}: packed and concatenated kernels differ")
            # one rank's operands as fresh (16-byte aligned) tensors
            bsr_held(f"{label} padded", *BSR_PADDED, cols[1].clone(), blocks[1].clone(),
                     [torch.cat(xs, dim=1)[1].clone()])


def bsr_case(name, replaces, cols, blocks, xs, packed):
    """Kernel vs plain for one fused-BSR wrapper; the kernels-line entry."""
    kernel, plain = BSR_PACKED if packed else BSR_CONCAT
    run = lambda: kernel(cols, blocks, xs)  # noqa: E731
    plain_fn = lambda: plain(cols, blocks, xs)  # noqa: E731
    out, want, err = bsr_held(name, kernel, plain, cols, blocks, xs)
    p, nbr, ktot, bm, bn = blocks.shape
    nv = xs[0].shape[-1]
    n_bc = sum(x.shape[1] for x in xs)
    live = cols >= 0
    dense = blocks[live]                                  # [n_live, bm, bn]
    b_idx = live.nonzero()                                # (rank, brow, slot)
    nz = dense.nonzero()                                  # (block, m, n)
    blk = b_idx[nz[:, 0]]
    rows = (blk[:, 0] * nbr + blk[:, 1]) * bm + nz[:, 1]
    ccol = (blk[:, 0] * n_bc + cols[live].long()[nz[:, 0]]) * bn + nz[:, 2]
    size = (p * nbr * bm, p * n_bc * bn)
    a = csr_from_coo(rows, ccol, dense[nz[:, 0], nz[:, 1], nz[:, 2]], size)
    x_cat = torch.cat(xs, dim=1).reshape(p * n_bc * bn, nv)
    lib = torch.sparse.mm(a, x_cat).reshape(out.shape)
    print(f"  {name}: library result max_abs_err {float((lib - want).abs().max()):.3e}")
    # the live blocks as a BSR tensor: block rows rank * nbr + i, block
    # columns rank * n_bc + cols, sorted within each block row
    brow = b_idx[:, 0] * nbr + b_idx[:, 1]
    bcol = b_idx[:, 0] * n_bc + cols[live].long()
    order = (brow * (p * n_bc) + bcol).argsort()
    crow = torch.zeros(p * nbr + 1, dtype=torch.long, device=DEV)
    crow[1:] = torch.bincount(brow, minlength=p * nbr).cumsum(0)
    lib_bsr = bsr_library(name, crow, bcol[order], dense[order], size, x_cat, want)
    n_live = int(live.sum())
    nbytes = (cols.nbytes + n_live * bm * bn * 4 + sum(x.nbytes for x in xs)
              + out.nbytes)
    bms, by = bound_ms(nbytes, 2.0 * n_live * bm * bn * nv)
    entry = dict(name=name, route="cuda", source="src/repro_torch/csrc/bsr_spmm.cu",
                 replaces=replaces, launches=0, max_abs_err=err,
                 ms=time_ms(run), device_ms=device_ms(run), plain_ms=time_ms(plain_fn),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(a, x_cat)),
                 library_bsr_ms=lib_bsr)
    print(f"  {name}: blocks {tuple(blocks.shape)} ({n_live} live) segments "
          f"{[tuple(x.shape) for x in xs]}; {nbytes / 1e6:.1f} MB; kernel "
          f"{entry['ms']:.4f} ms (device {entry['device_ms']:.4f}, "
          f"{100 * bms / entry['device_ms']:.1f}% of bound), bound {bms:.4f} ms ({by}), "
          f"plain {entry['plain_ms']:.4f} ms, torch.sparse.mm CSR "
          f"{entry['library_ms']:.4f} ms, BSR {fmt_ms(lib_bsr)}")
    return entry


def padded_bsr_case(label, a, bm, bn, v, want, gen):
    """The padded BSR kernel on ``BSR.from_csr(a)``: first the user's path
    ``bsr_spmv`` (counted, against the float64 oracle ``want``), then
    the kernel against its plain version, timed beside the CSR and BSR
    library calls, then the variants; the kernels-line entry."""
    t0 = time.perf_counter()
    b = BSR.from_csr(a, bm=bm, bn=bn)
    t_conv = time.perf_counter() - t0
    w, counts = drive(f"{label} bsr_spmv", lambda: bsr_spmv(b, v))
    check_oracle(f"{label} bsr_spmv", w.cpu().numpy()[: a.shape[0]], want)
    del w
    cols_np, blocks_np, _ = b.padded_uniform()
    cols = torch.from_numpy(cols_np).to(DEV)
    blocks = torch.from_numpy(blocks_np).to(DEV)
    del cols_np, blocks_np
    x = torch.zeros(b.shape[1], device=DEV)
    x[: a.shape[1]] = torch.from_numpy(v).to(DEV, torch.float32)
    x = x.reshape(-1, bn, 1)
    run = lambda: bsr_spmm_padded(cols, blocks, x)  # noqa: E731
    out, plain, err = bsr_held(label, *BSR_PADDED, cols, blocks, [x])
    lib_a = torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr), torch.from_numpy(a.indices),
        torch.from_numpy(a.data.astype(np.float32)), size=a.shape).to(DEV)
    x_lib = x.reshape(-1, 1)[: a.shape[1]]
    lib = torch.sparse.mm(lib_a, x_lib)
    print(f"  {label}: library result max_abs_err "
          f"{float((lib - plain.reshape(-1, 1)[: a.shape[0]]).abs().max()):.3e}")
    n_live, n_slots = b.n_blocks, cols.numel()
    tail = cols.nbytes + x.nbytes + out.nbytes
    bms, by = bound_ms(tail + n_live * bm * bn * 4, 2.0 * n_live * bm * bn)
    pad_ms, pad_by = bound_ms(tail + blocks.nbytes, 2.0 * n_slots * bm * bn)
    entry = dict(name="bsr_spmm_padded", route="cuda",
                 source="src/repro_torch/csrc/bsr_spmm.cu",
                 replaces="src/repro/kernels/bsr_spmv/kernel.py:57",
                 launches=counts.get("bsr_spmm_padded", 0), max_abs_err=err,
                 ms=time_ms(run), device_ms=device_ms(run),
                 plain_ms=time_ms(lambda: bsr_spmm_padded_ref(cols, blocks, x)),
                 bound_ms=bms, bound_by=by,
                 library_ms=time_ms(lambda: torch.sparse.mm(lib_a, x_lib)))
    del lib_a, lib, out
    vals = torch.from_numpy(b.data).to(DEV)
    entry["library_bsr_ms"] = bsr_library(
        label, torch.from_numpy(b.indptr).to(DEV, torch.long),
        torch.from_numpy(b.indices).to(DEV, torch.long), vals, b.shape,
        x.reshape(-1, 1), plain.reshape(-1, 1))
    del vals, b, plain
    free()
    print(f"  {label}: BSR.from_csr {t_conv:.2f} s; blocks {tuple(blocks.shape)} "
          f"({n_live} live, {n_live * bm * bn * 4 / 1e9:.3f} GB; padded "
          f"{blocks.nbytes / 1e9:.3f} GB); kernel {entry['ms']:.4f} ms (device "
          f"{entry['device_ms']:.4f}, {100 * bms / entry['device_ms']:.1f}% of bound), "
          f"bound {bms:.4f} ms ({by}) over the live blocks, {pad_ms:.4f} ms ({pad_by}) "
          f"with the padding; plain {entry['plain_ms']:.4f} ms, torch.sparse.mm "
          f"CSR {entry['library_ms']:.4f} ms, BSR {fmt_ms(entry['library_bsr_ms'])}")
    bsr_variants(label, False, cols, blocks, [x], gen)
    return entry


def profile_program(label, fn, wall_ms, host_ops=True):
    """One traced call: device kernel time by operator, and the device's
    busy share of the call's CUDA-event wall time.  ``host_ops=False``
    traces the card's activity alone (a call of ~10^5 kernels takes
    minutes to process with the host's operators), and traces both again
    if that records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("Activity Buffer")]
    if not kernels and not host_ops:
        return profile_program(label, fn, wall_ms)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  profile {label}: kernels busy {busy:.4f} ms of a {wall_ms:.4f} ms "
          f"call ({100 * busy / wall_ms:.1f}%), {sum(e.count for e in kernels)} "
          f"kernels; top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms x{e.count}"
              for e in top))
    return busy


def drive(label, fn):
    """Run one path with the launch counts and the device-memory peak
    reset just before it."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(launches)
    print(f"  {label}: launches {counts}; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return out, counts


def time_programs(ex, calls, profile=True):
    """Device-program ms (median of 10, pack/unpack excluded) and one
    profile of each ``(label, direction, operand, options)``; ``ex`` is
    one executor or a ``{direction: executor}`` map."""
    out = {}
    for lbl, direction, v, opts in calls:
        e = ex[direction] if isinstance(ex, dict) else ex
        shards = e.packed(direction, v)
        prog = e.program(direction, **opts)
        out[lbl] = time_ms(lambda: prog(shards), reps=10)
        if profile:
            profile_program(lbl, lambda: prog(shards), out[lbl])
        del shards
    print(f"  device program ms (median of 10, pack/unpack excluded): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def traffic_bytes(stats):
    """Padded and effective forward exchange bytes over all phases."""
    padded = sum(v for k, v in stats.items() if k.endswith("_padded"))
    effective = sum(v for k, v in stats.items() if k.endswith("_effective")
                    and not k.endswith("max_rank_effective"))
    return padded, effective


def phase_kernels(c, cb, a, a_b, oracles, gen):
    """[3] every kernel against its plain version."""
    print("[3] kernels against plain PyTorch versions")
    p = c.topo.n_procs

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV)

    t = c.tensors(["ell_cols", "ell_vals", "ell_t_cols", "ell_t_vals"])
    seg_lens = (c.cols_pad, c.pads["bnode"], c.pads["boff"])
    ell_src = "src/repro_torch/csrc/ell_spmm.cu"
    ell_ref = "src/repro/kernels/ell_spmv/kernel.py:79"
    entries = [
        ell_case("ell_spmm_packed", ell_src, ell_ref, t["ell_cols"],
                 t["ell_vals"], tuple(randn(p, L, 1) for L in seg_lens)),
        ell_case("ell_spmm_packed:transpose", ell_src, ell_ref, t["ell_t_cols"],
                 t["ell_t_vals"], (randn(p, c.rows_pad, 1),)),
    ]
    xs8 = tuple(randn(p, L, 8) for L in seg_lens)
    check_close("ell_spmm_packed nv=8",
                ell_spmm_packed(t["ell_cols"], t["ell_vals"], xs8),
                ell_spmm_packed_ref(t["ell_cols"], t["ell_vals"], xs8), c.ell_kmax,
                float(ell_spmm_packed_ref(t["ell_cols"], t["ell_vals"].abs(),
                                          tuple(x.abs() for x in xs8)).max()))
    print(f"  ell_spmm_packed nv=8: kernel "
          f"{time_ms(lambda: ell_spmm_packed(t['ell_cols'], t['ell_vals'], xs8)):.4f}"
          f" ms, plain "
          f"{time_ms(lambda: ell_spmm_packed_ref(t['ell_cols'], t['ell_vals'], xs8)):.4f} ms")

    tb = cb.tensors(["fused_cols", "fused_blocks"])
    bn = cb.block_shape[1]
    bsegs = tuple(randn(p, L // bn, bn, 1)
                  for L in (cb.cols_pad, cb.pads["bnode"], cb.pads["boff"]))
    entries.append(bsr_case("fused_bsr_spmm_packed",
                            "src/repro/kernels/bsr_spmv/fused.py:154",
                            tb["fused_cols"], tb["fused_blocks"], bsegs, True))
    entries.append(bsr_case("fused_bsr_spmm",
                            "src/repro/kernels/bsr_spmv/fused.py:57",
                            tb["fused_cols"], tb["fused_blocks"],
                            (torch.cat(bsegs, dim=1),), False))
    bsr_variants(f"fused n={int(np.sqrt(a_b.shape[0]))} {cb.block_shape}", True,
                 tb["fused_cols"], tb["fused_blocks"], bsegs, gen)
    del t, tb, xs8, bsegs
    free()
    ragged_bsr_cases(gen)
    free()

    n_ab = a_b.shape[0]
    entries.append(padded_bsr_case(f"bsr_spmm_padded n={int(np.sqrt(a.shape[0]))} "
                                   f"(8,128)", a, 8, 128, oracles["v1"],
                                   oracles["w1"], gen))
    free()
    padded_bsr_case(f"bsr_spmm_padded n={int(np.sqrt(n_ab))} (128,128)", a_b,
                    128, 128, oracles["vb"], oracles["wb"], gen)
    free()
    return entries


def phase_nap(op, a, oracles):
    """[4] the node-aware main path at full size."""
    print(f"[4] main path: n={int(np.sqrt(a.shape[0]))}, Topology(32, 16), "
          f"local_compute={op.spec.local_compute!r}")
    ex = op.executor
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    t0 = time.perf_counter()
    (w1, w8), fwd = drive("forward nv=1 and nv=8", lambda: (op @ v1, op @ v8))
    t_fwd = time.perf_counter() - t0
    (z1,), tr = drive("transpose nv=1", lambda: (op.T @ u1,))
    if op.local_compute != "ell" or op.T.local_compute != "ell":
        raise AssertionError(f"main path did not resolve to ell: "
                             f"{op.local_compute}, {op.T.local_compute}")
    check_oracle("forward nv=1", w1, oracles["w1"])
    check_oracle("forward nv=8", w8, oracles["w8"])
    check_oracle("transpose nv=1", z1, oracles["z1"])
    ms = time_programs(ex, [("forward nv=1", "forward", v1, {}),
                            ("forward nv=8", "forward", v8, {}),
                            ("transpose nv=1", "transpose", u1, {})])
    print(f"  host: first forward pair (pack + program + unpack, nv=1 and "
          f"nv=8) {t_fwd:.2f} s")
    # the NAP results phase 7 holds multistep with threshold=1 against:
    # the forward at nv=1 and the transpose with index_add_ deterministic
    torch.use_deterministic_algorithms(True)
    try:
        z1_det = op.T @ u1
    finally:
        torch.use_deterministic_algorithms(False)
    nap_count(op, v1, oracles["w1"])
    return fwd, tr, dict(w1=w1, w8=w8, z1=z1_det, ms=ms,
                         nccl=nccl_one_process(op, v1, w1))


def nap_count(op, v1, want):
    """[28c] one NAP forward counted on the card: its exchanges'
    node-crossing bytes per axis are what ``inter_node_bytes()`` counts
    over the same apply, and its ELL calls the kernel's launches."""
    reset_inter_node_bytes()
    reset_launches()
    with count_ops() as cost:
        w = op @ v1
    torch.cuda.synchronize()
    check_oracle("counted forward nv=1", w, want)
    counted = {k: float(v) for k, v in inter_node_bytes().items() if ":" not in k}
    ell = cost.kernels.get("ell_spmm_packed", {}).get("calls", 0)
    if cost.dci_by_axis != counted or cost.dci_bytes != sum(counted.values()) \
            or cost.dci_bytes <= 0:
        raise AssertionError(f"NAP forward: counted crossing bytes {cost.dci_by_axis} "
                             f"(total {cost.dci_bytes}) against the communicator's "
                             f"{counted}")
    if ell != launches.get("ell_spmm_packed", 0) or ell < 1:
        raise AssertionError(f"NAP forward: {ell} counted ELL calls, "
                             f"{launches.get('ell_spmm_packed', 0)} launches")
    COUNTED["nap"] = cost
    print(f"[28c] NAP forward nv=1 counted on the card: exchanges "
          f"{ {k: int(v) for k, v in cost.collective_bytes.items()} } bytes in "
          f"{ {k: int(v) for k, v in cost.collective_counts.items()} } calls, "
          f"groups {sorted(set(sum(cost.group_sizes.values(), [])))}; node-crossing "
          f"{ {k: int(v) for k, v in cost.dci_by_axis.items()} } = inter_node_bytes() "
          f"{ {k: int(v) for k, v in counted.items()} }; ELL calls {int(ell)} = launches; "
          f"declared ELL work {cost.kernels['ell_spmm_packed']['bytes'] / 1e6:.1f} MB; "
          f"{cost.operators} operators, {cost.hbm_bytes / 1e9:.3f} GB at operator "
          f"boundaries")


def phase_bsr(op_b, a_b, oracles):
    """[5] the node-aware fused-BSR forward."""
    print(f"[5] bsr forward: n={int(np.sqrt(a_b.shape[0]))}, Topology(32, 16)")
    vb = oracles["vb"][:, None]
    wp, cnt_p = drive("packed x", lambda: op_b @ vb)
    wc, cnt_c = drive("materialize_x", lambda: op_b(vb, materialize_x=True))
    if not np.array_equal(wp, wc):
        raise AssertionError("packed and materialized BSR forwards differ")
    check_oracle("packed x", wp[:, 0], oracles["wb"])
    shards = op_b.executor.packed("forward", vb)
    ms_p = time_ms(lambda: op_b.executor.program("forward")(shards), reps=10)
    ms_c = time_ms(lambda: op_b.executor.program("forward", materialize_x=True)(shards),
                   reps=10)
    print(f"  packed and materialized bit-equal; device program ms packed "
          f"{ms_p:.4f}, materialized {ms_c:.4f}")
    return cnt_p, cnt_c


def phase_standard(a, a_b, topo, part, oracles, nap_summary, full_size, keep):
    """[6] Algorithm 1 at full size, then its fused-BSR forward.  ``keep``
    receives the forward at nv = 1 and the device-program ms (phase 9e)."""
    print(f"[6] standard method: n={int(np.sqrt(a.shape[0]))}, Topology(32, 16)")
    op = operator(a, topo, part, method="standard")
    t0 = time.perf_counter()
    c = op.executor.compiled
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    c.ensure_ell()
    c.ensure_ell_t()
    t_ell = time.perf_counter() - t0
    rep = op.autotune_report()
    verdict = (rep["resolved"], rep["transpose_resolved"])
    print(f"[plan] compile_standard {t_compile:.2f} s, ensure_ell + ensure_ell_t "
          f"{t_ell:.2f} s (host plan build {t_compile + t_ell:.2f} s); rows_pad "
          f"{c.rows_pad}, buf_pad {c.buf_pad}, pair_pad {c.pair_pad}, nnz_pad "
          f"{c.nnz_pad}; ell {c.arrays['ell_cols'].shape}, ell_t "
          f"{c.arrays['ell_t_cols'].shape}; send_idx {c.arrays['send_idx'].shape} "
          f"({c.arrays['send_idx'].nbytes / 1e9:.2f} GB); {int(c.send_counts.sum())} "
          f"live slots in {int((c.send_counts > 0).sum())} messages")
    print(f"[plan] autotune verdict forward={verdict[0]} transpose={verdict[1]} "
          f"(times {rep['times']}, transpose {rep['transpose']['times']})")
    if verdict != ("ell", "ell"):
        if full_size:
            raise AssertionError(f"standard plan did not resolve to ell: {verdict}")
        print(f"[plan] verdict is not ell in both directions at this reduced "
              f"size; the phase runs with local_compute='ell'")
        op = operator(a, topo, part, method="standard", local_compute="ell")
        c = op.executor.compiled
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    w1, fwd1 = drive("forward nv=1", lambda: op @ v1)
    check_oracle("forward nv=1", w1, oracles["w1"])
    keep["w1"] = w1
    w8, fwd8 = drive("forward nv=8", lambda: op @ v8)
    check_oracle("forward nv=8", w8, oracles["w8"])
    del w8
    z1, tr = drive("transpose nv=1", lambda: op.T @ u1)
    check_oracle("transpose nv=1", z1, oracles["z1"])
    del z1
    zl, _ = drive("transpose nv=1 literal adjoint",
                  lambda: op.executor.transpose(u1, live_scatter=False))
    check_oracle("transpose nv=1 literal adjoint", zl, oracles["z1"])
    del zl
    ell = [d.get("ell_spmm_packed", 0) for d in (fwd1, fwd8, tr)]
    if min(ell) < 1:
        raise AssertionError(f"the standard path did not launch the ELL kernel: {ell}")
    keep["ms"] = time_programs(op.executor, [
        ("forward nv=1", "forward", v1, {}),
        ("forward nv=8", "forward", v8, {}),
        ("transpose nv=1", "transpose", u1, {}),
        ("transpose nv=1 literal adjoint", "transpose", u1,
         {"live_scatter": False})])
    v_flat = op.executor.packed("forward", v1).reshape(-1)
    send_idx = c.flat_index("send_idx", c.cols_pad)
    print(f"  send gather alone (nv=1, {send_idx.numel()} slots, CUDA events): "
          f"{time_ms(lambda: v_flat.index_select(0, send_idx), reps=10):.4f} ms")
    del v_flat, send_idx
    padded, effective = traffic_bytes(op.stats())
    print(f"  exchange bytes per forward (f32): standard padded {padded} vs "
          f"effective {effective} ({padded / max(effective, 1):.1f}x); nap padded "
          f"{nap_summary['padded']} vs effective {nap_summary['effective']} "
          f"({nap_summary['padded'] / max(nap_summary['effective'], 1):.1f}x)")
    cost = op.cost(BLUE_WATERS)
    print(f"  Blue Waters model (paper Tables 3-4; a model of that Cray machine, "
          f"not a time on this card): standard total {cost['total']:.6e} s "
          f"(inter {cost['inter']:.6e}, intra {cost['intra']:.6e}); nap total "
          f"{nap_summary['cost']['total']:.6e} s")
    del op, c
    free()

    op_b = operator(a_b, topo, method="standard", local_compute="bsr")
    t0 = time.perf_counter()
    op_b.executor.compiled.ensure_fused()
    print(f"  standard bsr n={int(np.sqrt(a_b.shape[0]))}: compile + ensure_fused "
          f"{time.perf_counter() - t0:.2f} s, fused_blocks "
          f"{op_b.executor.compiled.arrays['fused_blocks'].nbytes / 1e9:.3f} GB")
    vb = oracles["vb"][:, None]
    wp, cnt_p = drive("standard bsr packed x", lambda: op_b @ vb)
    wc, cnt_c = drive("standard bsr materialize_x", lambda: op_b(vb, materialize_x=True))
    if not np.array_equal(wp, wc):
        raise AssertionError("standard packed and materialized BSR forwards differ")
    if cnt_p.get("fused_bsr_spmm_packed", 0) < 1 or cnt_c.get("fused_bsr_spmm", 0) < 1:
        raise AssertionError("the standard BSR path did not launch its kernels")
    check_oracle("standard bsr packed x", wp[:, 0], oracles["wb"])
    shards = op_b.executor.packed("forward", vb)
    ms_p = time_ms(lambda: op_b.executor.program("forward")(shards), reps=10)
    ms_c = time_ms(lambda: op_b.executor.program("forward", materialize_x=True)(shards),
                   reps=10)
    print(f"  standard bsr packed and materialized bit-equal; device program ms "
          f"packed {ms_p:.4f}, materialized {ms_c:.4f}")
    return fwd1, fwd8, tr

# the multi-step exchange and the AMG solver path (phases 7 and 9) ----------------

def ell_held(label, c, direction, gen):
    """The ELL kernel against its plain version on one compiled plan's own
    arrays and segment lengths (forward over the packed x, transpose over
    u_loc), nv = 1: the shapes its path gives the kernel."""
    p = c.topo.n_procs
    if direction == "forward":
        c.ensure_ell()
        t = c.tensors(["ell_cols", "ell_vals"])
        cols, vals = t["ell_cols"], t["ell_vals"]
        lens = ((c.cols_pad, c.pads["bnode"], c.pads["boff"]) if hasattr(c, "pads")
                else (c.cols_pad, c.buf_pad))
    else:
        c.ensure_ell_t()
        t = c.tensors(["ell_t_cols", "ell_t_vals"])
        cols, vals, lens = t["ell_t_cols"], t["ell_t_vals"], (c.rows_pad,)
    xs = tuple(torch.randn((p, n, 1), generator=gen, device=DEV) for n in lens)
    scale = float(ell_spmm_packed_ref(cols, vals.abs(), tuple(x.abs() for x in xs)).max())
    check_close(f"{label} ell_spmm_packed {direction} {tuple(cols.shape)}",
                ell_spmm_packed(cols, vals, xs), ell_spmm_packed_ref(cols, vals, xs),
                cols.shape[-1], scale)


def print_verdict(label, verdict, seconds):
    for d in ("forward", "transpose"):
        v = verdict[d]
        print(f"  {label} {d}: {v['chosen']} (injected inter-node bytes "
              + ", ".join(f"{k} {c['injected_inter_bytes']}"
                          for k, c in v["candidates"].items())
              + "; postal s " + ", ".join(f"{k} {c['postal_time_s']:.6e}"
                                          for k, c in v["candidates"].items())
              + f"; {v['postal_params']}); {seconds:.2f} s")


def phase_multistep(a, topo, part, oracles, nap_ref, gen, full_size, keep):
    """[7] the multi-step exchange on the main path's matrix.  ``nap_ref``
    holds phase 4's NAP results (forward nv=1, deterministic transpose)
    and the NAP operator's ``local_compute``; ``keep`` receives the
    forward at nv = 1, a deterministic transpose and the device-program
    ms (phase 9e)."""
    print(f"[7] multistep: n={int(np.sqrt(a.shape[0]))}, Topology(32, 16)")
    t0 = time.perf_counter()
    verdict = choose_comm(a.indptr, a.indices, part, topo)
    print_verdict("choose_comm", verdict, time.perf_counter() - t0)
    del verdict
    op = operator(a, topo, part, method="multistep", device=DEV)
    t0 = time.perf_counter()
    c = op.executor.compiled
    t_compile = time.perf_counter() - t0
    formats = (op.local_compute, op.T.local_compute)
    if formats != ("ell", "ell"):
        if full_size:
            raise AssertionError(f"multistep plan did not resolve to ell: {formats}")
        print(f"  verdict {formats} at this reduced size; the phase runs ell")
        op = operator(a, topo, part, method="multistep", local_compute="ell", device=DEV)
        c = op.executor.compiled
    t0 = time.perf_counter()
    c.ensure_ell()
    c.ensure_ell_t()
    c.ensure_live_direct()
    t_ell = time.perf_counter() - t0
    st = op.stats()
    p, dpad = topo.n_procs, c.pads["direct"]
    n_live = c.arrays["direct_live_src"].size
    print(f"[plan] compile_multistep {t_compile:.2f} s, ensure_ell + ensure_ell_t + "
          f"live direct slots {t_ell:.2f} s; threshold {c.ms_plan.threshold}; pads "
          f"{c.pads}; ell_kmax {c.ell_kmax}, ell_t_kmax {c.ell_t_kmax}")
    print(f"  direct exchange per forward (f32, nv=1): padded {st['direct_padded']} B "
          f"([{p}, {p}, {dpad}] slots) vs live {st['direct_effective']} B ({n_live} "
          f"values in {st['messages_direct'].total_msgs} messages, "
          f"{st['direct_padded'] / max(st['direct_effective'], 1):.0f}x); inter "
          f"padded {st['inter_padded']} vs effective {st['inter_effective']}; host "
          f"direct_send {c.arrays['direct_send'].nbytes / 1e9:.2f} GB (never staged)")
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    (w1, w8), fwd = drive("forward nv=1 and nv=8", lambda: (op @ v1, op @ v8))
    (z1,), tr = drive("transpose nv=1", lambda: (op.T @ u1,))
    check_oracle("forward nv=1", w1, oracles["w1"])
    check_oracle("forward nv=8", w8, oracles["w8"])
    check_oracle("transpose nv=1", z1, oracles["z1"])
    if fwd.get("ell_spmm_packed", 0) < 2 or tr.get("ell_spmm_packed", 0) < 1:
        raise AssertionError(f"the multistep path did not launch the ELL kernel: {fwd}, {tr}")
    del w8, z1
    with deterministic():
        keep.update(w1=w1, z1=op.T @ u1)
    ell_held("multistep", c, "forward", gen)
    ell_held("multistep", c, "transpose", gen)
    # the literal padded exchange, run once and timed beside the live one
    ex = op.executor
    shards = ex.packed("forward", v1)
    w_lit, lit = drive("forward nv=1, literal padded direct exchange",
                       lambda: ex.program("forward", live_direct=False)(shards))
    if not torch.equal(w_lit, ex.program("forward")(shards)):
        raise AssertionError("live and literal direct exchanges differ")
    print("  live-slot and literal direct exchanges bit-equal (forward nv=1)")
    del w_lit, shards
    keep["ms"] = time_programs(ex, [("forward nv=1", "forward", v1, {}),
                                    ("forward nv=8", "forward", v8, {}),
                                    ("transpose nv=1", "transpose", u1, {}),
                                    ("forward nv=1 literal direct", "forward", v1,
                                     {"live_direct": False})])
    print(f"  Blue Waters model (not a card time): multistep total "
          f"{op.cost(BLUE_WATERS)['total']:.6e} s")
    del op, ex, c
    free()
    # threshold=1 sends nothing direct: the NAP plan, bit for bit on the card
    # (the transposes' index_add_ in its deterministic form)
    op1 = operator(a, topo, part, method="multistep", threshold=1,
                   local_compute=nap_ref["local_compute"], device=DEV)
    if op1.executor.compiled.pads["direct"] != 1 or op1.stats()["direct_effective"]:
        raise AssertionError("threshold=1 left a direct share")
    w_ms = op1 @ v1
    torch.use_deterministic_algorithms(True)
    try:
        z_ms = op1.T @ u1
    finally:
        torch.use_deterministic_algorithms(False)
    if not (np.array_equal(w_ms, nap_ref["w1"]) and np.array_equal(z_ms, nap_ref["z1"])):
        raise AssertionError("multistep with threshold=1 differs from nap")
    print("  threshold=1: forward and transpose bit-equal to nap on the card")
    del op1
    free()
    return fwd, tr


# wire integrity on the main path (phase 8) ------------------------------------

class deterministic:
    """PyTorch's deterministic algorithms for the block (``index_add_`` of
    the transposes then sums in a fixed order), when ``on``.  With
    ``warn_only`` an op without a deterministic form warns instead of
    raising: cuBLAS's matmuls, which raise without a
    ``CUBLAS_WORKSPACE_CONFIG`` though they are deterministic on one
    stream."""

    def __init__(self, on=True, warn_only=False):
        self.on = on
        self.warn_only = warn_only

    def __enter__(self):
        if self.on:
            torch.use_deterministic_algorithms(True, warn_only=self.warn_only)

    def __exit__(self, *exc):
        if self.on:
            torch.use_deterministic_algorithms(False)


def record_messages(ex, direction, v):
    """One clean instrumented run of ``ex``'s program with every message
    buffer recorded just before its fault boundary: ``{phase: [P, slots,
    words]}`` (int32 words of each message, row-major), ``"compute"`` the
    local result or packed contributions the compute fault would hit."""
    rec = {}
    orig_fault, orig_pair = spmv_torch._Wire.fault, spmv_torch._fault_pair

    def fault(self, phase, buf):
        rec[phase] = buf.reshape(buf.shape[0], buf.shape[1], -1).clone()
        return orig_fault(self, phase, buf)

    def fault_pair(send, spec):
        nv, p, n_r, pad = send.shape
        rec["pair"] = send.permute(1, 2, 3, 0).reshape(p, n_r, pad * nv).clone()
        return orig_pair(send, spec)

    spmv_torch._Wire.fault, spmv_torch._fault_pair = fault, fault_pair
    try:
        ex.program(direction, fault_spec=zero_spec(ex))(ex.packed(direction, v))
    finally:
        spmv_torch._Wire.fault, spmv_torch._fault_pair = orig_fault, orig_pair
    torch.cuda.synchronize()
    return rec


def zero_spec(ex):
    """A clean fault spec for the executor's plan (its node block's rows
    for a plan of a multi-process job)."""
    n = len(message_phases(ex.method)) + 1
    mesh = ex.compiled.mesh
    nodes = ex.topo.n_nodes if mesh is None else mesh.n_local_nodes
    return torch.zeros((nodes, ex.topo.ppn, n, 4), dtype=torch.int32, device=DEV)


def pick_edges(buf, regions=None):
    """Per fault kind, one real edge ``(sender, slot, element)`` of a
    message phase whose payload is neither all zero nor constant (the
    median such edge), the fault then changing its bits: ``duplicate``
    also needs the next slot's payload to differ.  None where no edge
    qualifies (the documented undetectable classes).  ``regions(kind)``
    lists the ``((s0, s1), (k0, k1))`` sender and slot ranges to look in,
    in order (default: the whole buffer)."""
    w = buf.view(torch.int32) if buf.dtype != torch.int32 else buf
    good = (w != 0).any(-1) & (w != w[..., :1]).any(-1)
    dup = good & (w != torch.roll(w, -1, 1)).any(-1)
    whole = [((0, w.shape[0]), (0, w.shape[1]))]

    def median(mask, region):
        (s0, s1), (k0, k1) = region
        idx = torch.nonzero(mask[s0:s1, k0:k1].reshape(-1)).reshape(-1)
        if idx.numel() == 0:
            return None
        flat = int(idx[idx.numel() // 2])
        s, k = divmod(flat, k1 - k0)
        s, k = s + s0, k + k0
        return s, k, int(torch.nonzero(w[s, k])[0])

    out = {}
    for kind in FAULT_KINDS:
        mask = dup if kind == "duplicate" else good
        out[kind] = next((e for e in (median(mask, r) for r in
                                      (regions(kind) if regions else whole))
                          if e is not None), None)
    return out


def stack_regions(phase, n_procs, n_slots):
    """Where phase 8 looks for each kind's edge, so that phase 9h can replay
    its faults across two processes: the senders of kind i in the block of
    process i mod 2 (the other block where that one has no edge), and the
    bitflip of an exchange that crosses processes (``inter``, ``pair``,
    ``direct``) from a rank of process 0 to a node or rank of process 1."""
    half = n_procs // MESH_PROCS
    blocks = [((b * half, (b + 1) * half), (0, n_slots)) for b in range(MESH_PROCS)]

    def regions(kind):
        if kind == "bitflip" and phase in ("inter", "pair", "direct"):
            return [(blocks[0][0], (n_slots // MESH_PROCS, n_slots))]
        i = FAULT_KINDS.index(kind) % MESH_PROCS
        return [blocks[i], blocks[1 - i]]

    return regions


def expected_mismatch(phase, s, k, ppn):
    """(node, proc, slot) where the receiver reports a fault that sender
    rank ``s`` put on its message slot ``k``."""
    node, proc = divmod(s, ppn)
    if phase == "inter":
        return k, proc, node
    if phase in ("pair", "direct"):
        return k // ppn, k % ppn, s
    return node, k, proc


def expect_detected(view, v, label, fault, want):
    """Inject ``fault``; the next apply of ``view`` to ``v`` must raise
    with exactly the mismatch ``want``."""
    view.queue_fault(fault)
    try:
        view @ v
    except IntegrityError as e:
        got = [(m.check, m.phase, m.scope, m.node, m.proc, m.slot, m.direction)
               for m in e.mismatches]
        if got != [want]:
            raise AssertionError(f"{label}: mismatches {got}, expected [{want}]")
        return
    raise AssertionError(f"{label}: {fault} not detected")


def fault_sweep(op, method, direction, v, ppn, replay):
    """Every fault kind on a real edge of every message phase (senders in
    both halves of the ranks, see :func:`stack_regions`), then a compute
    bitflip on a high exponent bit, each detected with the reference's
    attribution; appends each ``(fault, mismatch)`` to ``replay`` (phase
    9h replays them across processes) and returns the number of faults
    detected."""
    view = op.T if direction == "transpose" else op
    rec = record_messages(op.executor, direction, v)
    n = 0
    for phase in message_phases(method):
        edges = pick_edges(rec[phase], stack_regions(phase, op.topo.n_procs,
                                                     rec[phase].shape[1]))
        for kind in FAULT_KINDS:
            edge = edges[kind]
            if edge is None and kind == "bitflip":
                edge = (0, 0, 0)    # no live edge: a flip in padding is still seen
            if edge is None:
                print(f"    {method} {direction} {phase}: no edge carries a payload "
                      f"{kind} changes (documented undetectable class), skipped")
                continue
            s, k, elem = edge
            node, proc, slot = expected_mismatch(phase, s, k, ppn)
            fault = MessageFault(phase=phase, kind=kind, node=s // ppn, proc=s % ppn,
                                 slot=k, element=elem, bit=20, direction=direction)
            want = ("wire", phase, scope_for(phase, node, proc, slot, ppn),
                    node, proc, slot, direction)
            expect_detected(view, v, f"{method} {direction} {phase} {kind}", fault, want)
            replay.append((fault, want))
            n += 1
        print(f"    {method} {direction} {phase}: edge {edges['bitflip']}, "
              f"{sum(e is not None for e in edges.values())} kinds on live edges")
    # ABFT: bit 30 of a value in [0.1, 1) makes it ~2^128 times larger and
    # still finite, far above the tolerance (a flip to inf would not be);
    # the last rank forward, the first transposed (one in each half)
    r = op.topo.n_procs - 1 if direction == "forward" else 0
    vals = rec["compute"][r, 0]
    idx = torch.nonzero((vals.abs() >= 0.1) & (vals.abs() < 1.0)).reshape(-1)
    elem = int(idx[idx.numel() // 2])
    fault = MessageFault(phase="compute", kind="bitflip", node=r // ppn, proc=r % ppn,
                         element=elem, bit=30, direction=direction)
    want = ("abft", "compute", "on_proc", r // ppn, r % ppn, 0, direction)
    expect_detected(view, v, f"{method} {direction} compute", fault, want)
    replay.append((fault, want))
    del rec
    free()
    return n + 1


def bare_apply(ex, direction, v):
    """The uninstrumented program on the same compiled plan, unpacked: the
    ``integrity="off"`` result."""
    w = ex.program(direction)(ex.packed(direction, v))
    part = ex.row_part if direction == "forward" else ex.col_part
    return spmv_torch.unpack_vector(w.cpu().numpy(), part, ex.topo)


def phase_integrity(a, topo, part, oracles, a_b, keep):
    """[8] wire integrity on the main path: nap, standard and multistep.
    ``keep["faults"]`` takes each method and direction's scripted faults
    with their mismatches, for phase 9h."""
    n = int(np.sqrt(a.shape[0]))
    print(f"[8] integrity: n={n}, Topology(32, 16), nap / multistep / standard, "
          f"integrity='detect'")
    ppn = topo.ppn
    v1, v8, u1 = oracles["v1"], oracles["v8"], oracles["u1"]
    ell = {"forward": 0, "transpose": 0}
    nap_op = None
    for method in ("multistep", "standard", "nap"):   # nap last: it stays alive
        t0 = time.perf_counter()
        op = operator(a, topo, part, method=method, local_compute="ell",
                      integrity="detect", device=DEV)
        ex = op.executor
        c = ex.compiled
        c.ensure_ell()
        c.ensure_ell_t()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        c.ensure_abft()
        st = op.stats()
        print(f"  {method}: compile + formats {t_compile:.2f} s, ensure_abft "
              f"{time.perf_counter() - t0:.2f} s; checksum words per apply "
              f"{st['checksum_total'] // 4} ({st['checksum_total']} B)")
        # 1. clean detect applies, bit-equal to the bare program, no mismatch
        nvs = (1, 8)
        for direction in ("forward", "transpose"):
            view = op.T if direction == "transpose" else op
            for nv in nvs:
                v = (v1 if direction == "forward" else u1) if nv == 1 else v8
                with deterministic(direction == "transpose"):
                    got, cnt = drive(f"{method} detect {direction} nv={nv}",
                                     lambda: view @ v)
                    want = bare_apply(ex, direction, v)
                if not np.array_equal(got, want):
                    raise AssertionError(f"{method} {direction} nv={nv}: detect != off")
                ell[direction] += cnt.get("ell_spmm_packed", 0)
                if nv == 1:
                    check_oracle(f"{method} detect {direction} nv=1", got,
                                 oracles["w1" if direction == "forward" else "z1"])
                del got, want
        rep = op.integrity_report()
        if rep["wire_mismatches"] or rep["abft_mismatches"] or not rep["wire_checks"]:
            raise AssertionError(f"{method}: clean applies reported {rep}")
        print(f"  {method}: {rep['applies']} clean detect applies bit-equal to off, "
              f"{rep['wire_checks']} wire checks, {rep['abft_checks']} ABFT checks, "
              f"0 mismatches")
        # 2. scripted faults on real edges, both directions
        n_faults = 0
        for direction in ("forward", "transpose"):
            replay = keep["faults"][f"{method}/{direction}"] = []
            with deterministic(direction == "transpose"):
                n_faults += fault_sweep(op, method, direction,
                                        v1 if direction == "forward" else u1, ppn,
                                        replay)
        rep = op.integrity_report()
        print(f"  {method}: {n_faults} scripted faults detected with the expected "
              f"attribution; strikes {rep['strikes']}")
        # 3. device-program times and peaks, bare and instrumented
        spec = zero_spec(ex)
        for direction in ("forward", "transpose"):
            for nv in nvs:
                v = (v1 if direction == "forward" else u1) if nv == 1 else v8
                shards = ex.packed(direction, v)
                row = dict(method=method, direction=direction, nv=nv)
                for label, prog in (("bare", ex.program(direction)),
                                    ("instrumented",
                                     ex.program(direction, fault_spec=spec))):
                    free()
                    torch.cuda.reset_peak_memory_stats()
                    out = prog(shards)
                    torch.cuda.synchronize()
                    row[f"{label}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                    del out
                    row[f"{label}_ms"] = time_ms(lambda: prog(shards), reps=5,
                                                 warmup=1)
                keep["integrity_ms"][f"{method}/{direction}/{nv}"] = row
                print(f"  {method} {direction} nv={nv}: bare {row['bare_ms']:.4f} ms "
                      f"(peak {row['bare_peak_gb']:.3f} GB), instrumented "
                      f"{row['instrumented_ms']:.4f} ms (peak "
                      f"{row['instrumented_peak_gb']:.3f} GB), ratio "
                      f"{row['instrumented_ms'] / row['bare_ms']:.2f}")
                if nv == 1:
                    profile_program(f"{method} {direction} nv=1 instrumented",
                                    lambda: prog(shards), row["instrumented_ms"])
                del shards
        if method == "nap":
            nap_op = op
        else:
            del op
        del ex, c
        free()
    # 4. recover: one fault, the clean result bit for bit after one retry
    rec_op = operator(a, topo, part, local_compute="ell", integrity="recover",
                      device=DEV)
    y_off = bare_apply(nap_op.executor, "forward", v1)
    s, k, elem = pick_edges(record_messages(rec_op.executor, "forward", v1)["inter"])["bitflip"]
    rec_op.inject_fault("inter", "bitflip", node=s // ppn, proc=s % ppn, slot=k,
                        element=elem, bit=20)
    if not np.array_equal(rec_op @ v1, y_off):
        raise AssertionError("recover forward is not the clean result")
    rep = rec_op.integrity_report()
    if not rep["retries"] == rep["recovered"] == 1:
        raise AssertionError(f"recover forward: {rep}")
    with deterministic():
        z_off = bare_apply(nap_op.executor, "transpose", u1)
        s, k, elem = pick_edges(record_messages(rec_op.executor, "transpose",
                                                u1)["final"])["zero"]
        rec_op.T.inject_fault("final", "zero", node=s // ppn, proc=s % ppn, slot=k,
                              element=elem)
        if not np.array_equal(rec_op.T @ u1, z_off):
            raise AssertionError("recover transpose is not the clean result")
    rep = rec_op.integrity_report()
    if not rep["retries"] == rep["recovered"] == 2:
        raise AssertionError(f"recover transpose: {rep}")
    print(f"  recover: forward and transpose faults retried once each, results "
          f"bit-equal to off (retries {rep['retries']}, recovered "
          f"{rep['recovered']}, strikes {rep['strikes']})")
    del rec_op, y_off, z_off
    free()
    # 5. the fused-BSR forward at the BSR path's size, one detect apply
    op_b = operator(a_b, topo, local_compute="bsr", integrity="detect", device=DEV)
    vb = oracles["vb"][:, None]
    wb, cnt_b = drive("bsr detect forward", lambda: op_b @ vb)
    if not np.array_equal(wb, bare_apply(op_b.executor, "forward", vb)):
        raise AssertionError("bsr detect != off")
    check_oracle("bsr detect forward", wb[:, 0], oracles["wb"])
    if cnt_b.get("fused_bsr_spmm_packed", 0) < 1:
        raise AssertionError("the BSR detect apply did not launch its kernel")
    print(f"  bsr n={int(np.sqrt(a_b.shape[0]))}: detect apply bit-equal to off, "
          f"{op_b.integrity_report()['wire_checks']} wire checks, 0 mismatches")
    del op_b, wb
    free()
    return ell, cnt_b, nap_op


def phase_simulate(a, topo, part, oracles, a_b, nap_op, nap_w1, nap_z1):
    """[8, simulate] the float64 simulate backend: every method at the BSR
    path's grid against the device programs and the float64 host product;
    the node-aware method at the main path's size against phase 4's device
    results, and one scripted wire fault on both backends."""
    nb = int(np.sqrt(a_b.shape[0]))
    print(f"  simulate: n={nb} all methods, then n={int(np.sqrt(a.shape[0]))} "
          f"node-aware (host float64)")
    rng = np.random.default_rng(16)
    vb = oracles["vb"]
    ub = rng.standard_normal(a_b.shape[0])
    wb, zb = host_apply(a_b, vb), host_apply(a_b, ub, transpose=True)
    for method in ("nap", "standard", "multistep"):
        t0 = time.perf_counter()
        sim = operator(a_b, topo, method=method, backend="simulate")
        w, z = sim @ vb, sim.T @ ub
        t_sim = time.perf_counter() - t0
        dev = operator(a_b, topo, method=method, local_compute="ell", device=DEV)
        check_oracle(f"device {method} n={nb} forward", dev @ vb, w, "float64 simulate")
        check_oracle(f"device {method} n={nb} transpose", dev.T @ ub, z,
                     "float64 simulate")
        for label, got, want in (("forward", w, wb), ("transpose", z, zb)):
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            if not rel <= 1e-12:
                raise AssertionError(f"simulate {method} {label}: {rel:.3e} off float64")
        print(f"  simulate {method} n={nb}: forward + transpose {t_sim:.2f} s host, "
              f"float64 within 1e-12 of the host product")
        del sim, dev
    t0 = time.perf_counter()
    sim = operator(a, topo, part, backend="simulate", integrity="detect")
    w, z = sim @ oracles["v1"], sim.T @ oracles["u1"]
    t_sim = time.perf_counter() - t0
    for label, got, want, dev in (("forward", w, oracles["w1"], nap_w1),
                                  ("transpose", z, oracles["z1"], nap_z1)):
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        if not rel <= 1e-12:
            raise AssertionError(f"simulate nap {label}: {rel:.3e} off float64")
        check_oracle(f"device nap {label} (phase 4)", dev, got, "float64 simulate")
    print(f"  simulate nap n={int(np.sqrt(a.shape[0]))}: forward + transpose "
          f"{t_sim:.2f} s host, within 1e-12 of the host product")
    # one scripted fault on both backends: the device's inter edge
    rec = record_messages(nap_op.executor, "forward", oracles["v1"])
    s, k, elem = pick_edges(rec["inter"])["bitflip"]
    del rec
    fault = dict(phase="inter", kind="bitflip", node=s // topo.ppn,
                 proc=s % topo.ppn, slot=k, element=elem, bit=20)
    got = []
    for view in (nap_op, sim):
        view.inject_fault(**fault)
        try:
            view @ oracles["v1"]
            raise AssertionError(f"{view.spec.backend}: fault not detected")
        except IntegrityError as e:
            got.append([(m.check, m.phase, m.scope, m.node, m.proc, m.slot)
                        for m in e.mismatches])
    if got[0] != got[1]:
        raise AssertionError(f"simulate and device attribute differently: {got}")
    print(f"  simulate wire: fault {fault} attributed as on the device: {got[0]}")


class HostOp:
    """A float64 scipy CSR matrix with the operators' call and ``@``: the
    host-matvec twin of a level's distributed operators."""

    def __init__(self, m):
        self.m = m

    def __call__(self, x):
        return self.m @ x

    __matmul__ = __call__


def scipy_of(m):
    return sp.csr_matrix((m.data, m.indices, m.indptr), shape=m.shape)


def check_level(label, got, want):
    """``check_oracle``'s tolerance on a coarse level, whose entries grow
    with the Galerkin products: rtol 1e-4 and atol 1e-5 of max |ref|."""
    scale = float(np.abs(want).max())
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: bad result {got.shape}")
    np.testing.assert_allclose(got / scale, want / scale, **TOL)
    return float(np.abs(got - want).max()) / scale


AMG_PCG = 5      # PCG iterations of phases 9 and 9h (10 before the time limit forced a cut)


def amg_pcg(levels, ops, b, a0, iterations=AMG_PCG):
    """AMG-preconditioned CG iterations from zero; the true relative
    residual ||b - A x|| / ||b|| (float64 host A) of each iterate."""
    b_norm = float(np.linalg.norm(b))
    hist = []
    cg_solve(levels[0].a, b, tol=0.0, maxiter=iterations, spmv=ops[0].a,
             precond=lambda r: amg_vcycle(levels, r, operators=ops),
             callback=lambda it, x: hist.append(
                 float(np.linalg.norm(b - a0 @ x)) / b_norm))
    return hist


def phase_amg(a, topo, gen, seed, full_size, keep, levels_file=None,
              children=None, host_work=None):
    """[9] the AMG solver path on the main path's matrix.  The device
    SpGEMM, the PCG and the V-cycle run in deterministic mode (their
    ``index_add_`` sums in a fixed order), so that phase 9h's processes can
    be held to them bit for bit; ``keep["amg"]`` takes the device
    residuals, the host twin's, the V-cycle's output digest and the walls.
    With ``levels_file`` the hierarchy and the right-hand side are written
    there for 9h's children (and ``levels_file + ".ready"`` when done);
    ``children`` (``start_mesh_children``'s ``finish``) is waited for after
    ``level_operators``, the float64 host twins and ``host_work`` (host
    work of a later phase that needs no card), before the first timing on
    the card, its result kept as ``keep["children"]``."""
    import repro_torch.api as api_mod
    rng = np.random.default_rng(seed + 8)
    print(f"[9] AMG: n={int(np.sqrt(a.shape[0]))}, smoothed aggregation theta 0.1, "
          f"coarse_size {2 * topo.n_procs}, Topology(32, 16), comm='auto'")
    t0 = time.perf_counter()
    levels = smoothed_aggregation_hierarchy(a, theta=0.1, coarse_size=2 * topo.n_procs)
    t_h = time.perf_counter() - t0
    print(f"  hierarchy {t_h:.2f} s (host, float64): {len(levels)} levels, rows "
          f"{[lv.a.shape[0] for lv in levels]}, nnz {[lv.a.nnz for lv in levels]}, "
          f"P nnz {[lv.p.nnz for lv in levels if lv.p is not None]}")
    b = np.random.default_rng(seed + 18).standard_normal(levels[0].a.shape[0])
    if levels_file is not None:
        save_levels(levels_file, levels, b)
        Path(f"{levels_file}.ready").touch()
    chooser = []
    choose = api_mod.choose_comm

    def timed_choose(*args, **kw):
        t = time.perf_counter()
        out = choose(*args, **kw)
        chooser.append(time.perf_counter() - t)
        return out

    products = []
    compile_fn = spgemm_torch.compile_spgemm

    def recorded_compile(a_, b_, *args, **kw):
        t = time.perf_counter()
        out = compile_fn(a_, b_, *args, **kw)
        # host arrays only: the product's device tensors go with ``out``
        products.append(dict(a=a_, b=b_, compiled=out.unstaged(),
                             seconds=time.perf_counter() - t))
        return out

    api_mod.choose_comm = timed_choose
    spgemm_torch.compile_spgemm = recorded_compile
    runs0 = torch_spgemm_runs()
    t0 = time.perf_counter()
    try:
        with deterministic():
            ops = level_operators(levels, topo, comm="auto", materialize=True,
                                  spgemm_backend="torch", device=DEV)
    finally:
        api_mod.choose_comm = choose
        spgemm_torch.compile_spgemm = compile_fn
    t_ops = time.perf_counter() - t0
    n_products = 2 * (len(levels) - 1)
    if torch_spgemm_runs() - runs0 != n_products or len(products) != n_products:
        raise AssertionError(f"materialize=True ran {torch_spgemm_runs() - runs0} "
                             f"device SpGEMMs, expected {n_products}")
    print(f"  level_operators(materialize=True, spgemm_backend='torch') {t_ops:.2f} s "
          f"(chooser {sum(chooser):.2f} s, SpGEMM compile "
          f"{sum(r['seconds'] for r in products):.2f} s); {n_products} device SpGEMM "
          f"runs, every coarse A held against the host assembly at rtol 5e-5 x depth"
          + ("" if children is None else
             " (hierarchy and level_operators ran beside 9e / 9h's children)"))
    # float64 host work that needs no card, done while the children run:
    # the host-matvec twin of the PCG, its V-cycle, level 0's host A @ P
    a0 = scipy_of(levels[0].a)
    host_ops = [LevelOperators(a=HostOp(scipy_of(lv.a)),
                               p=None if lv.p is None else HostOp(scipy_of(lv.p)),
                               r=None if lv.r is None else HostOp(scipy_of(lv.r)))
                for lv in levels]
    t0 = time.perf_counter()
    res_host = amg_pcg(levels, host_ops, b, a0)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    z_host = amg_vcycle(levels, b, operators=host_ops)
    t_vc_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    ap_host = csr_matmul(levels[0].a, levels[0].p)
    t_ap_host = time.perf_counter() - t0
    if host_work is not None:
        host_work()
    if children is not None:
        t0 = time.perf_counter()
        keep["children"] = children()
        print(f"  waited {time.perf_counter() - t0:.1f} s for 9e / 9h's children "
              f"(they ran {keep['children']['wall_s']:.1f} s); nothing on the card "
              f"was timed while they ran")
    for i in range(1, len(levels)):
        if ops[i].a is not None:
            got, want = ops[i].a.a, levels[i].a
            print(f"  level {i} A from the device products: max abs err / max |host| "
                  f"{np.abs(got.data - want.data).max() / np.abs(want.data).max():.3e} "
                  f"(limit: rtol {5e-5 * i:.1e}, atol 0.1 rtol max(1, max |host|))")
    spgemm_report(products, topo)
    n_dist = sum(e.a is not None for e in ops)
    k = 0
    for i, (lv, e) in enumerate(zip(levels, ops)):
        if e.a is None:
            print(f"  level {i}: {lv.a.shape[0]} rows, {lv.a.nnz} nnz: host (fewer "
                  f"rows than ranks)")
            continue
        for name in ("a", "p"):
            op = getattr(e, name)
            if op is None:
                continue
            t0 = time.perf_counter()
            execs = [op.executor] + ([op.transpose_executor]
                                     if op.transpose_executor is not None else [])
            for ex in execs:
                c = ex.compiled
                if getattr(c, "comm", "nap") == "multistep":
                    c.ensure_live_direct()
            if op.local_compute == "ell":
                op.executor.compiled.ensure_ell()
            if op.T.local_compute == "ell":
                (op.transpose_executor or op.executor).compiled.ensure_ell_t()
            rep = op.autotune_report()["comm"]
            mat = lv.a if name == "a" else lv.p
            print(f"  level {i} {name.upper()} {mat.shape} nnz {mat.nnz}: comm forward "
                  f"{rep['resolved']}, transpose {rep['transpose_resolved']}; local "
                  f"{op.local_compute} / {op.T.local_compute}; chooser "
                  f"{chooser[k]:.2f} s, compile {time.perf_counter() - t0:.2f} s")
            k += 1
    def held_and_timed(label, op, x, y, profile):
        """The ELL kernel against its plain version where a direction of
        ``op`` resolved to it, then both directions' programs timed."""
        execs = {"forward": op.executor,
                 "transpose": op.transpose_executor or op.executor}
        for direction, view in (("forward", op), ("transpose", op.T)):
            if view.local_compute == "ell":
                ell_held(label, execs[direction].compiled, direction, gen)
        time_programs(execs, [(f"{label} forward", "forward", x, {}),
                              (f"{label}.T", "transpose", y, {})], profile=profile)

    errs = []
    for i, (lv, e) in enumerate(zip(levels, ops)):
        if e.a is None:
            continue
        # the float64 oracle of each SpMV is the matrix its operator holds:
        # on the coarse levels the device SpGEMM product, held against the
        # host assembly by level_operators
        sa = scipy_of(e.a.a)
        v, u = rng.standard_normal(sa.shape[1]), rng.standard_normal(sa.shape[0])
        errs.append(check_level(f"level {i} A @ v", e.a @ v, sa @ v))
        errs.append(check_level(f"level {i} A.T @ u", e.a.T @ u, sa.T @ u))
        held_and_timed(f"level {i} A", e.a, v, u, i == 0)
        if e.p is None:
            continue
        sp_, sr = scipy_of(lv.p), scipy_of(lv.r)
        x, r = rng.standard_normal(sp_.shape[1]), rng.standard_normal(sp_.shape[0])
        errs.append(check_level(f"level {i} P @ x", e.p @ x, sp_ @ x))
        errs.append(check_level(f"level {i} R @ r", e.r @ r, sr @ r))
        errs.append(check_level(f"level {i} (R @ A @ P) @ x", e.galerkin() @ x,
                                sr @ (sa @ (sp_ @ x))))
        held_and_timed(f"level {i} P", e.p, x, r, i == 0)
    print(f"  every distributed level ({n_dist}) matches the float64 host products of "
          f"its operators' matrices: max abs err / max |ref| {max(errs):.3e}")
    gal_counts = spgemm_level0(levels, ops, products, topo, rng, ap_host, t_ap_host)
    del products
    free()

    # AMG-preconditioned CG, AMG_PCG iterations, on the card (the host-matvec
    # twin ran above)
    t0 = time.perf_counter()
    with deterministic():
        res_dev, counts = drive(f"PCG, {AMG_PCG} iterations, device operators",
                                lambda: amg_pcg(levels, ops, b, a0))
    t_dev = time.perf_counter() - t0
    print("  PCG true relative residual ||b - A x|| / ||b|| (float64 host A), device "
          "operators vs host float64 matvecs:")
    for it, (rd, rh) in enumerate(zip(res_dev, res_host), 1):
        print(f"    iteration {it}: {rd:.6e}  {rh:.6e}  (ratio {rd / rh:.6f})")
    # Both runs take the same steps.  CG's step length divides by p . A p,
    # which for the smooth p the V-cycle returns is a small fraction of
    # |p| |A p| (0.6% at n = 2024), so the f32 rounding of the device's
    # A p (~4e-5 of |A p|) moves it by ~0.5% and the residuals by up to
    # ~2% (the z . A z comparison below).  The limit is 5%, 2.5x that.
    if len(res_dev) != AMG_PCG or not all(
            abs(rd / rh - 1.0) <= 0.05 or max(rd, rh) <= 1e-5
            for rd, rh in zip(res_dev, res_host)):
        raise AssertionError("device PCG does not track the host-matvec PCG")
    if full_size and not res_dev[-1] < 0.5 * res_dev[0]:
        raise AssertionError("device PCG did not reduce the residual")
    r0 = b - a0 @ np.zeros_like(b)
    t0 = time.perf_counter()
    with deterministic():
        z_dev, vc = drive("one V-cycle, device operators",
                          lambda: amg_vcycle(levels, r0, operators=ops))
    t_vc = time.perf_counter() - t0
    keep["amg"] = dict(res=res_dev, res_host=res_host, vcycle=digest(z_dev),
                       vcycle_s=t_vc, pcg_s=t_dev, level_operators_s=t_ops)
    profile_program("one V-cycle, device operators",
                    lambda: amg_vcycle(levels, r0, operators=ops), t_vc * 1e3)
    az, az_dev = a0 @ z_host, ops[0].a @ z_host
    print(f"  V-cycle wall {t_vc:.3f} s with device operators ({vc.get('ell_spmm_packed', 0)}"
          f" ELL launches), {t_vc_host:.3f} s with host float64 matvecs; PCG "
          f"{t_dev:.2f} s device, {t_host:.2f} s host (the host runs beside 9e / "
          f"9h's children); one V-cycle's output, device "
          f"vs host: ||dz|| / ||z|| {np.linalg.norm(z_dev - z_host) / np.linalg.norm(z_host):.3e}"
          f", ||A dz|| / ||A z|| {np.linalg.norm(a0 @ (z_dev - z_host)) / np.linalg.norm(a0 @ z_host):.3e}"
          f"; device A z vs float64 A z on that z: ||d(Az)|| / ||A z|| "
          f"{np.linalg.norm(az_dev - az) / np.linalg.norm(az):.3e}, z . A z / (||z|| "
          f"||A z||) {z_host @ az / (np.linalg.norm(z_host) * np.linalg.norm(az)):.3e}, "
          f"z . d(Az) / z . A z {z_host @ (az_dev - az) / (z_host @ az):.3e}")
    if counts.get("ell_spmm_packed", 0) < 1:
        raise AssertionError("the AMG path did not launch the ELL kernel")
    del ops, host_ops, levels
    clear_spgemm_cache()
    free()
    return {k: counts.get(k, 0) + gal_counts.get(k, 0) for k in {**counts, **gal_counts}}


def spgemm_phase_values(c):
    """Per exchange phase of a compiled SpGEMM: (padded, live) values."""
    topo, plan = c.topo, c.plan
    if c.method == "standard":
        lists = {"pair": (plan.comm.sends, topo.n_procs)}
    else:
        lists = {"full": (plan.comm.local_full_sends, topo.ppn),
                 "init": (plan.comm.local_init_sends, topo.ppn),
                 "inter": (plan.comm.inter_sends, topo.n_nodes),
                 "final": (plan.comm.local_final_sends, topo.ppn)}
    return {ph: (topo.n_procs * slots * c.vpads[ph],
                 sum(message_value_size(m, plan.b_counts) for ms in msgs for m in ms))
            for ph, (msgs, slots) in lists.items()}


def spgemm_bound(a, c, itemsize):
    """The least time of one product: every live expanded product reads its
    position, output slot and A value (int32, int32, payload) and one
    value of the domain once, every live C value is written once, and
    every live exchanged value is read and written once, at 3.35 TB/s."""
    n_exp = int(c.plan.b_counts[a.indices].sum())
    live = sum(v for _, v in spgemm_phase_values(c).values())
    nbytes = n_exp * (8 + 2 * itemsize) + sum(c.c_nnz) * itemsize + 2 * live * itemsize
    return bound_ms(nbytes, n_exp * 2)[0], n_exp


def time_spgemm(c, b, dtype=torch.float32):
    """Device-program ms (median of 10, B staged on the card) and the peak
    of allocated memory over one run, in GB, and the run's output.  The
    product's arrays are staged on a copy of ``c``, freed on return."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    c = c.unstaged()
    b_dev = torch.from_numpy(pack_b_values(b, c, np_dtype)).to(DEV)
    run = spgemm_program(c, dtype=dtype)
    out = run(b_dev)
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats()
    out = run(b_dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = time_ms(lambda: run(b_dev), reps=10)
    return ms, peak, out


def spgemm_report(products, topo):
    """Per device SpGEMM product of ``level_operators``: host compile s,
    pads, padded vs live value bytes per phase, the paper's inter-node
    value bytes for nap and standard, device-program ms, peak and bound."""
    print("  device SpGEMM products (float32 payloads; bytes at 4 B a value; "
          "ms: CUDA events, median of 10, B already on the card):")
    for j, rec in enumerate(products):
        c, a_, b_ = rec["compiled"], rec["a"], rec["b"]
        label = f"level {j // 2} {'A @ P' if j % 2 == 0 else 'R @ AP'}"
        phases = spgemm_phase_values(c)
        t0 = time.perf_counter()
        std = build_spgemm_plan(a_, b_, c.row_part, c.mid_part, topo,
                                method="standard").stats()["inter"]
        t_std = time.perf_counter() - t0
        nap = c.plan.stats()["inter"]
        ms, peak, _ = time_spgemm(c, b_)
        bound, n_exp = spgemm_bound(a_, c, 4)
        print(f"  {label} {c.shape} nnz(C) {sum(c.c_nnz)}: compile {rec['seconds']:.2f} s; "
              f"exp_pad {c.exp_pad} ({n_exp} live products), c_nnz_pad {c.c_nnz_pad}, "
              f"b_nnz_pad {c.b_nnz_pad}, vpads {c.vpads}; value bytes padded / live "
              + ", ".join(f"{ph} {4 * pv} / {4 * lv}" for ph, (pv, lv) in phases.items())
              + f"; inter-node value bytes (8 B a value, the paper's setup traffic) "
              f"nap {nap.total_bytes} in {nap.total_msgs} messages, standard "
              f"{std.total_bytes} in {std.total_msgs} ({t_std:.2f} s to plan); "
              f"device {ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%), "
              f"peak {peak:.3f} GB")
        free()


def spgemm_level0(levels, ops, products, topo, rng, ap_host, t_ap_host):
    """Level 0's products in float64 against host ``csr_matmul`` (its
    ``A @ P``, ``ap_host``, took ``t_ap_host`` s), its materialized
    Galerkin operator against the lazy chain, and its standard-method
    ``A @ P`` through the live-slot pair exchange."""
    a0, p0 = levels[0].a, levels[0].p
    print(f"  level 0 host csr_matmul A @ P {t_ap_host:.2f} s")
    for rec, b_, want, label in ((products[0], p0, ap_host, "A @ P"),
                                 (products[1], ap_host, levels[1].a, "R @ AP")):
        c = rec["compiled"]
        ms, peak, out = time_spgemm(c, b_, torch.float64)
        got = unpack_c_values(out, c)
        del out
        if not (np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"level 0 float64 {label}: structure differs")
        scale = float(np.abs(want.data).max())
        np.testing.assert_allclose(got.data, want.data, rtol=1e-12, atol=1e-13 * scale)
        bound, _ = spgemm_bound(rec["a"], c, 8)
        print(f"  level 0 {label} float64 on the card: max abs err / max |ref| "
              f"{np.abs(got.data - want.data).max() / scale:.3e} (rtol 1e-12, atol "
              f"1e-13 x max |ref|); device {ms:.4f} ms, bound {bound:.4f} ms "
              f"({100 * bound / ms:.1f}%), peak {peak:.3f} GB")
        free()

    # materialized against lazy Galerkin operator, one apply each
    t0 = time.perf_counter()
    gal_m = ops[0].galerkin(materialize=True)
    t_mat = time.perf_counter() - t0
    gal_l = ops[0].galerkin()
    x = rng.standard_normal(gal_m.shape[1])
    t0 = time.perf_counter()
    y_m, counts = drive("level 0 materialized R @ A @ P, first apply", lambda: gal_m @ x)
    t_first = time.perf_counter() - t0
    y_l = gal_l @ x
    want = scipy_of(levels[1].a) @ x
    e_ml = check_level("level 0 materialized vs lazy (R @ A @ P) @ x", y_m, y_l)
    e_m = check_level("level 0 materialized (R @ A @ P) @ x", y_m, want)
    ms_m = time_ms(lambda: gal_m @ x, reps=10)
    ms_l = time_ms(lambda: gal_l @ x, reps=10)
    print(f"  level 0 R @ A @ P materialized {gal_m.shape}, nnz {gal_m.a.nnz} "
          f"({gal_m.method}, {gal_m.local_compute}): materialize {t_mat:.2f} s, first "
          f"apply (with its plan compile) {t_first:.2f} s; one apply (pack + program + "
          f"unpack, CUDA events, median of 10) materialized {ms_m:.4f} ms vs lazy "
          f"{ms_l:.4f} ms; results apart by {e_ml:.3e} of max |lazy|, materialized "
          f"vs float64 host {e_m:.3e}")
    time_programs(gal_m.executor, [("level 0 materialized R @ A @ P", "forward", x, {})],
                  profile=False)
    del gal_m, gal_l
    free()

    # the standard method's A @ P: its literal [P, P, vpad] table vs live slots
    fine = products[0]["compiled"].row_part
    t0 = time.perf_counter()
    cs = compile_spgemm(a0, p0, fine, fine, topo, method="standard", device=DEV)
    t_cs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.ensure_live_pair()
    t_live = time.perf_counter() - t0
    p_, vpad = topo.n_procs, cs.vpads["pair"]
    live = int(cs.arrays["pair_live_src"].size)
    c_std = distributed_spgemm(a0, p0, fine, fine, topo, method="standard", device=DEV)
    assert_matches_host(c_std, ap_host, "torch", "level 0 standard A @ P")
    ms, peak, _ = time_spgemm(cs, p0)
    bound, _ = spgemm_bound(a0, cs, 4)
    print(f"  level 0 standard A @ P: compile {t_cs:.2f} s + live slots {t_live:.2f} s; "
          f"the literal pair table [{p_}, {p_}, {vpad}] is {4 * p_ * p_ * vpad / 1e9:.3f} "
          f"GB of float32 (+ {8 * p_ * p_ * vpad / 1e9:.3f} GB of int64 gather index) "
          f"for {live} live values ({4 * live / 1e9:.4f} GB), so it runs from its live "
          f"slots (recv pad {cs.live_pad}); matches host csr_matmul at rtol 5e-5; "
          f"device {ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.1f}%), peak "
          f"{peak:.3f} GB")
    del cs, c_std
    free()
    return counts


def record_spgemm_messages(c, b):
    """One clean instrumented run of compiled SpGEMM ``c`` on ``b`` with
    every message buffer recorded at its fault boundary: ``{phase: [P,
    slots, words]}``."""
    rec = {}
    orig = spmv_torch._Wire.fault

    def fault(self, phase, buf):
        rec[phase] = buf.reshape(buf.shape[0], buf.shape[1], -1).clone()
        return orig(self, phase, buf)

    spmv_torch._Wire.fault = fault
    try:
        n = len(message_phases(c.method)) + 1
        spgemm_program(c, integrity=True)(pack_b_values(b, c, np.float32),
                                          np.zeros((c.topo.n_nodes, c.topo.ppn, n, 4),
                                                   dtype=np.int32))
    finally:
        spmv_torch._Wire.fault = orig
    torch.cuda.synchronize()
    return rec


def same_csr(x, y):
    return (np.array_equal(x.indptr, y.indptr) and np.array_equal(x.indices, y.indices)
            and np.array_equal(x.data, y.data))


def phase_spgemm_small(a_b, topo, seed):
    """[9b] the distributed SpGEMM at the BSR path's grid: simulate bit-equal
    to ``csr_matmul``, the device program in float32 and float64, the
    hierarchy assembled by ``distributed_rap`` on the card, and scripted
    faults on every message phase detected and recovered, the clean
    instrumented run (for the standard method its literal pair exchange)
    bit-equal to the bare one (its live slots)."""
    nb = int(np.sqrt(a_b.shape[0]))
    print(f"[9b] distributed SpGEMM at n={nb}, Topology(32, 16)")
    t0 = time.perf_counter()
    host = smoothed_aggregation_hierarchy(a_b, theta=0.1, coarse_size=2 * topo.n_procs)
    a, p = host[0].a, host[0].p
    fine = contiguous_partition(a.shape[0], topo.n_procs)
    want = csr_matmul(a, p)
    scale = float(np.abs(want.data).max())
    print(f"  hierarchy {time.perf_counter() - t0:.2f} s: rows "
          f"{[lv.a.shape[0] for lv in host]}; level 0 A @ P {a.shape} @ {p.shape}")
    for method in ("nap", "standard"):
        t0 = time.perf_counter()
        sim = distributed_spgemm(a, p, fine, fine, topo, method=method,
                                 backend="simulate")
        if not same_csr(sim, want):
            raise AssertionError(f"simulate {method}: not bit-equal to csr_matmul")
        print(f"  simulate {method}: bit-equal to csr_matmul ({time.perf_counter() - t0:.2f}"
              f" s host)")
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                           (torch.float64, dict(rtol=1e-12, atol=1e-13))):
            got = distributed_spgemm(a, p, fine, fine, topo, method=method,
                                     device=DEV, dtype=dtype)
            if not np.array_equal(got.indices, want.indices):
                raise AssertionError(f"device {method} {dtype}: structure differs")
            np.testing.assert_allclose(got.data, want.data, **tol)
            print(f"  device {method} {str(dtype)[6:]}: max abs err "
                  f"{np.abs(got.data - want.data).max():.3e} (max |ref| {scale:.3e}; "
                  f"rtol {tol['rtol']:.0e}, atol {tol['atol']:.0e})")
    # the whole hierarchy assembled by the device SpGEMM (float32)
    runs0 = torch_spgemm_runs()
    t0 = time.perf_counter()
    dev = smoothed_aggregation_hierarchy(
        a_b, theta=0.1, coarse_size=2 * topo.n_procs,
        rap=distributed_rap(topo, backend="torch", device=DEV, cross_check=True))
    runs = torch_spgemm_runs() - runs0
    if len(dev) != len(host) or runs != 2 * (len(host) - 1) or not all(
            np.array_equal(x.a.indptr, y.a.indptr) and np.array_equal(x.a.indices, y.a.indices)
            for x, y in zip(dev, host)):
        raise AssertionError("distributed_rap hierarchy: structure differs from host")
    print(f"  smoothed_aggregation_hierarchy(rap=distributed_rap(backend='torch', "
          f"cross_check=True)) {time.perf_counter() - t0:.2f} s: {runs} device products, "
          f"every level's structure equal to the host hierarchy's; values drift "
          + ", ".join(f"{np.abs(x.a.data - y.a.data).max() / np.abs(y.a.data).max():.2e}"
                      for x, y in zip(dev[1:], host[1:]))
          + " of max |host| (float32 products feed the next level's aggregation)")
    del dev
    free()

    # integrity: every fault kind on a live edge of every message phase
    torch.use_deterministic_algorithms(True)
    try:
        for method in ("nap", "standard"):
            off = distributed_spgemm(a, p, fine, fine, topo, method=method, device=DEV)
            clean = distributed_spgemm(a, p, fine, fine, topo, method=method, device=DEV,
                                       integrity="detect")
            if not same_csr(clean, off):
                raise AssertionError(f"{method}: clean detect run differs from off")
            c = compile_spgemm(a, p, fine, fine, topo, method=method, device=DEV)
            rec = record_spgemm_messages(c, p)
            n = 0
            for phase in message_phases(method):
                edges = pick_edges(rec[phase])
                for kind in FAULT_KINDS:
                    if edges[kind] is None:
                        raise AssertionError(f"{method} {phase}: no live edge for {kind}")
                    s, k, elem = edges[kind]
                    node, proc, slot = expected_mismatch(phase, s, k, topo.ppn)
                    fault = MessageFault(phase=phase, kind=kind, node=s // topo.ppn,
                                         proc=s % topo.ppn, slot=k, element=elem, bit=20)
                    want_m = [("wire", phase, scope_for(phase, node, proc, slot, topo.ppn),
                               node, proc, slot, "forward")]
                    try:
                        distributed_spgemm(a, p, fine, fine, topo, method=method,
                                           device=DEV, integrity="detect", faults=[fault])
                        raise AssertionError(f"{method} {phase} {kind}: not detected")
                    except IntegrityError as e:
                        got = [(m.check, m.phase, m.scope, m.node, m.proc, m.slot,
                                m.direction) for m in e.mismatches]
                        if got != want_m:
                            raise AssertionError(f"{method} {phase} {kind}: {got}, "
                                                 f"expected {want_m}")
                    rep = {}
                    rc = distributed_spgemm(a, p, fine, fine, topo, method=method,
                                            device=DEV, integrity="recover",
                                            faults=[fault], report=rep)
                    if not same_csr(rc, clean) or rep["recovered"] != 1:
                        raise AssertionError(f"{method} {phase} {kind}: recover {rep}")
                    n += 1
                print(f"    {method} {phase}: edge {edges['bitflip']}, every kind detected "
                      f"with its (phase, node, proc, slot) and recovered bit-equal")
            print(f"  integrity {method}: clean detect bit-equal to off"
                  + (" (the literal pair exchange vs its live slots)"
                     if method == "standard" else "")
                  + f", {n} faults detected and recovered")
            del rec, c
            clear_spgemm_cache()
            free()
    finally:
        torch.use_deterministic_algorithms(False)


def phase_examples():
    """[9c] the port's three examples on the card, each to its final check."""
    print("[9c] torch examples on the card")
    for name, example in (("quickstart", quickstart), ("amg_spmv", amg_spmv),
                          ("moe_nap_dispatch", moe_nap_dispatch)):
        t0 = time.perf_counter()
        example.main([])
        print(f"  example {name}: ran to its final check, {time.perf_counter() - t0:.2f} s")
    free()


# the solver service (phase 9d) ------------------------------------------------

def int_spd(a):
    """``a``'s structure with integer values: -1 off the diagonal, 9 on
    it.  The stencil's rows hold at most 9 entries, so the matrix is
    symmetric, diagonally dominant and SPD (CG applies), and with integer
    operands every product is exact in float32."""
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    data = np.where(rows == a.indices, 9.0, -1.0)
    return type(a)(indptr=a.indptr, indices=a.indices, data=data, shape=a.shape)


class timed_calls:
    """Wrap ``owner.name`` for the block, recording each call's host seconds."""

    def __init__(self, owner, name):
        self.owner, self.name, self.seconds = owner, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.owner, self.name)

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds.append(time.perf_counter() - t0)
        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def service_op(svc):
    """The service's one cached operator (read without touching the plan
    cache's hit counters)."""
    (entry,) = svc.plans._entries.values()
    return entry["op"]


def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def cg_iteration(op, P, X, R):
    """The body of one ``batched_cg`` iteration (the shared apply, then
    per-column reductions and updates on the host), for its wall and
    busy share."""
    AP = op @ P
    alpha = (R * R).sum(axis=0) / (P * AP).sum(axis=0)
    return X + alpha * P, R - alpha * AP


def phase_service(a, a_b, topo, seed, keep):
    """[9d] the solver service at full size: batching, a hot value swap,
    node5 lost mid-solve and node21 at the next step (phase 9h's fault
    plan: this is the one-process run its processes are held to, in
    ``keep["service"]`` and ``keep["service_walls"]``), then scripted
    scenarios at the BSR grid."""
    n = int(np.sqrt(a.shape[0]))
    print(f"[9d] solver service: n={n} ({a.shape[0]} rows, {a.nnz} nnz), "
          f"Topology({topo.n_nodes}, {topo.ppn}), backend torch, checkpoint "
          f"every 4 iterations, {STACK_DEAD[0]} scripted to die at CG iteration 8 "
          f"and {STACK_DEAD[1]} at the next step")
    rng = np.random.default_rng(seed + 9)
    clear_compile_cache()
    reg = default_registry()
    ell_launches = 0
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        svc = SolverService(topo, backend="torch", checkpoint_dir=tmp,
                            checkpoint_every=4, max_attempts=6, device=DEV,
                            fault_plan=stack_fault_plan())
        svc.register_matrix("diffusion", a)

        # 1. eight spmv requests, one nv = 8 apply
        V = rng.standard_normal((a.shape[0], 8))
        tickets = [svc.submit(f"tenant{i % 3}", "diffusion", V[:, i])
                   for i in range(8)]
        every = list(tickets)
        with timed_calls(spmv_torch, "compile_nap") as comp:
            t0 = time.perf_counter()
            rep, cnt = drive("service step: 8 spmv requests", svc.step)
            t_step = walls["step_s"] = time.perf_counter() - t0
        if rep["executed"] != 8 or svc.plans.stats["misses"] != 1:
            raise AssertionError(f"8 requests did not run as one batch: {rep}, "
                                 f"{svc.plans.stats}")
        want = host_apply(a, V)
        got = np.stack([t.result() for t in tickets], axis=1)
        check_oracle("8 batched spmv requests", got, want)
        op = service_op(svc)
        w_direct, cnt_direct = drive("direct op @ V nv=8", lambda: op @ V)
        if cnt.get("ell_spmm_packed", 0) != cnt_direct.get("ell_spmm_packed", -1):
            raise AssertionError(f"the batch is not one nv=8 apply: {cnt} vs "
                                 f"{cnt_direct}")
        if not np.array_equal(w_direct, got):
            raise AssertionError("the direct apply differs from the service's")
        ell_launches += cnt.get("ell_spmm_packed", 0)
        ms = time_programs(op.executor, [("service nv=8", "forward", V, {})],
                           profile=False)
        print(f"  step 1: 8 requests in one nv=8 apply ({cnt['ell_spmm_packed']} "
              f"ELL launches, as one direct apply); first compile_nap "
              f"{comp.seconds[0]:.2f} s; step wall {t_step:.2f} s; device "
              f"program {ms['service nv=8']:.4f} ms")
        del w_direct

        # 2. a hot value swap at full size
        a_int = int_spd(a)
        V_int = rng.integers(-8, 9, size=(a.shape[0], 8)).astype(np.float64)
        builds = op.trace_counts()
        vals = op.executor.compiled._tensors["ell_vals"]
        ptr = vals.data_ptr()
        svc.update_values("diffusion", a_int)
        tickets = [svc.submit(f"tenant{i % 3}", "diffusion", V_int[:, i])
                   for i in range(8)]
        every += tickets
        with timed_calls(spmv_torch.CompiledNAP, "swap_values") as swap:
            t0 = time.perf_counter()
            _, cnt = drive("service step: hot swap + 8 spmv requests", svc.step)
            t_step = walls["swap_step_s"] = time.perf_counter() - t0
        walls["swap_s"] = swap.seconds[0]
        ell_launches += cnt.get("ell_spmm_packed", 0)
        st = svc.plans.stats
        if (st["hot_swaps"], st["misses"]) != (1, 1) or op.trace_counts() != builds:
            raise AssertionError(f"the value update recompiled: {st}, builds "
                                 f"{builds} -> {op.trace_counts()}")
        now = op.executor.compiled._tensors["ell_vals"]
        if now is not vals or now.data_ptr() != ptr:
            raise AssertionError("the swap replaced the staged ELL values")
        got = np.stack([t.result() for t in tickets], axis=1)
        if not np.array_equal(got, host_apply(a_int, V_int)):
            raise AssertionError("the swapped values' product is not exact")
        t0 = time.perf_counter()
        fresh = spmv_torch.compile_nap(a_int, svc.matrices["diffusion"]["row_part"],
                                       topo, cache=False, device=DEV)
        fresh.ensure_ell()
        t_fresh = time.perf_counter() - t0
        del fresh
        print(f"  step 2: hot swap {swap.seconds[0]:.2f} s of host time (values, "
              f"ELL refresh, in-place copy) vs a fresh compile_nap + ensure_ell "
              f"{t_fresh:.2f} s; builds {builds} flat; ell_vals data_ptr "
              f"unchanged; 8 integer products exact; step wall {t_step:.2f} s")
        # batched equals solo: each column of the nv=8 apply against its own
        # nv=1 apply (float operands, so the summation order shows)
        w8 = op @ V
        diff = max(float(np.abs(w8[:, i] - op @ V[:, i]).max()) for i in range(8))
        print(f"  batched vs solo (float operands, nv=8 columns vs nv=1 "
              f"applies): {'bit-equal' if diff == 0 else f'max |diff| {diff:.3e}'}")
        del w8

        # 3. node loss mid-solve
        b_int = rng.integers(-8, 9, size=a.shape[0]).astype(np.float64)
        B = rng.integers(-8, 9, size=(a.shape[0], 2)).astype(np.float64)
        w_ref = op @ b_int                  # the uninterrupted run, 32 x 16
        if not np.array_equal(w_ref, host_apply(a_int, b_int)):
            raise AssertionError("the uninterrupted spmv is not exact")
        old_ns = op.executor.compiled._tensors
        held_before = reg.resident_bytes()
        t_spmv = svc.submit("tenant0", "diffusion", b_int, kind="spmv")
        solves = [svc.submit(f"tenant{1 + i}", "diffusion", B[:, i], kind="solve",
                             tol=1e-5, maxiter=40, deadline=1e6) for i in range(2)]
        every += [t_spmv] + solves
        ck = svc.ckpt
        with timed_calls(ck, "save") as saves, timed_calls(ck, "restore") as restores:
            t0 = time.perf_counter()
            _, cnt = drive("service run: node loss mid-solve",
                           lambda: svc.run(max_steps=40))
            t_run = walls["run_s"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ell_launches += cnt.get("ell_spmm_packed", 0)
        print("  service log:\n    " + "\n    ".join(svc.log))
        new_topo = svc.topo
        part = svc.matrices["diffusion"]["row_part"]
        if not (t_spmv.status == "done" and all(t.status == "done" for t in solves)
                and svc.stats["recoveries"] == 1
                and not set(STACK_DEAD) & set(svc.nodes)
                and (new_topo.n_nodes, new_topo.ppn) == (topo.n_nodes - 2, topo.ppn)
                and part.kind == "elastic"):
            raise AssertionError(f"recovery failed: {svc.report()['stats']}, "
                                 f"{[t.status for t in [t_spmv] + solves]}")
        if not any("restored checkpointed iterates (iteration 8)" in line
                   for line in svc.log):
            raise AssertionError("the iteration-8 checkpoint was not restored")
        if not (np.array_equal(t_spmv.result(), w_ref)
                and np.array_equal(t_spmv.result(), host_apply(a_int, b_int))):
            raise AssertionError("the spmv across the node loss is not bit-equal")
        if not (old_ns.released and old_ns.resident_bytes() == 0):
            raise AssertionError("the evicted plan still holds device tensors")
        held_after = reg.resident_bytes()
        X0 = np.stack([t.request.x0 for t in solves], axis=1)
        got = np.stack([t.result() for t in solves], axis=1)
        iters = [t.request.iters for t in solves]
        # the oracle: compiled on its own, natively on the survivor layout,
        # from the restored iterate
        clear_compile_cache()
        op_o = operator(a_int, new_topo, row_part=part, device=DEV)
        X, it_o, rel = batched_cg(op_o, B, tol=1e-5, maxiter=40, X0=X0)
        if not np.array_equal(got, X):
            raise AssertionError("the recovered solves differ from the survivor "
                                 f"oracle (max |diff| {np.abs(got - X).max():.3e})")
        true_rel = [float(np.linalg.norm(host_apply(a_int, X[:, i]) - B[:, i])
                          / np.linalg.norm(B[:, i])) for i in range(2)]
        print(f"  step 3: {' and '.join(STACK_DEAD)} evicted, Topology({new_topo.n_nodes}, "
              f"{new_topo.ppn}) kind {part.kind}; spmv bit-equal to the "
              f"uninterrupted run and the exact product; solves bit-equal to the "
              f"survivor oracle ({iters} iterations after the restore, true "
              f"relative residuals {true_rel[0]:.3e} {true_rel[1]:.3e}); run "
              f"{t_run:.2f} s wall")
        ckpt_bytes = dir_bytes(max(Path(tmp).glob("step_*")))
        keep["service"] = service_summary(svc, every, tmp)
        walls.update(saves=len(saves.seconds), save_s=statistics.median(saves.seconds),
                     restore_s=statistics.median(restores.seconds),
                     recover_rebuild_s=svc.stats["last_recover_rebuild_s"])
        print(f"  last_recover_rebuild_s {svc.stats['last_recover_rebuild_s']:.2f} "
              f"(survivor partition, plan release, compile_nap on the survivors, "
              f"restore); checkpoint save {statistics.median(saves.seconds):.3f} s "
              f"median of {len(saves.seconds)}, restore "
              f"{statistics.median(restores.seconds):.3f} s, "
              f"{ckpt_bytes} bytes in the last step on disk; peak memory allocated "
              f"{peak:.3f} GB; registry resident {held_before / 1e9:.3f} GB "
              f"before the rebuild, {held_after / 1e9:.3f} GB after; released "
              f"{svc.plans.stats.get('buffer_bytes_released', 0) / 1e9:.3f} GB")
        op_s = service_op(svc)
        P = rng.standard_normal((a.shape[0], 2))
        t0 = time.perf_counter()
        cg_iteration(op_s, P, P, P)
        wall = (time.perf_counter() - t0) * 1e3
        walls["cg_iteration_s"] = wall / 1e3
        profile_program("one CG iteration (nv=2 apply + host updates)",
                        lambda: cg_iteration(op_s, P, P, P), wall)
        # the profiler may drop kernels late in the script (PERF.md §7): the
        # apply's device program by CUDA events, as a share of the wall
        ms = time_programs(op_s.executor, [("CG apply nv=2", "forward", P, {})],
                           profile=False)["CG apply nv=2"]
        walls["cg_apply_ms"] = ms
        keep["service_walls"] = walls
        print(f"  one CG iteration: {wall:.2f} ms of wall, its device program "
              f"{ms:.4f} ms by CUDA events ({100 * ms / wall:.2f}%; pack / "
              f"unpack copies and float64 host updates take the rest)")
        print(f"  report: {json.dumps(svc.report()['stats'])}; plan cache "
              f"{json.dumps(svc.plans.stats)}")
        del svc, op, op_s, op_o, old_ns, vals, now, X, X0, got
    free()
    service_scenarios(a_b, topo, seed)
    return ell_launches


def scenario(a, topo, plan, tmp, integrity):
    """One scripted scenario at the BSR grid: spmv and solve requests
    from three tenants, run to the end."""
    rng = np.random.default_rng(17)
    svc = SolverService(topo, backend="torch", checkpoint_dir=tmp,
                        checkpoint_every=3, fault_plan=plan, integrity=integrity,
                        max_attempts=6, device=DEV)
    svc.register_matrix("m", a)
    tickets = [svc.submit(f"t{i % 3}", "m",
                          rng.integers(-8, 9, a.shape[0]).astype(np.float64),
                          kind="spmv" if i % 2 else "solve", tol=1e-5, maxiter=30)
               for i in range(6)]
    svc.run(max_steps=60)
    stats = dict(svc.report()["stats"])
    stats.pop("last_recover_rebuild_s")
    return svc, tickets, stats


def service_scenarios(a_b, topo, seed):
    """Phase 9d, part 4: a seeded random fault plan (message faults under
    integrity="recover" included) replayed twice, and a torn checkpoint."""
    a = int_spd(a_b)
    nodes = [f"node{i}" for i in range(topo.n_nodes)]
    runs = []
    for _ in range(2):
        plan = FaultPlan.random(seed, nodes, n_steps=6, n_events=4, ppn=topo.ppn)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            svc, tickets, stats = scenario(a, topo, plan, tmp, "recover")
            runs.append((list(svc.log), stats,
                         [(t.status, t.reason) for t in tickets],
                         service_op(svc).integrity_report(),
                         [t.result() if t.status == "done" else None
                          for t in tickets]))
        del svc
    (log1, st1, tk1, ir1, res1), (log2, st2, tk2, ir2, res2) = runs
    same = (log1 == log2 and st1 == st2 and tk1 == tk2 and ir1 == ir2 and all(
        (x is None and y is None) or (x is not None and y is not None
                                      and np.array_equal(x, y))
        for x, y in zip(res1, res2)))
    if not same:
        raise AssertionError("the replayed fault scenario differs")
    print(f"  scripted plan (seed {seed}, {len(plan)} events: "
          f"{[(e.step, e.kind, e.node) for e in plan.events]}) replayed twice "
          f"at n={int(np.sqrt(a.shape[0]))}: logs, stats, integrity reports and "
          f"results identical; tickets {tk1}; stats {json.dumps(st1)}; the "
          f"serving operator's integrity counters "
          f"{ {k: ir1[k] for k in ('applies', 'faults_injected', 'retries', 'recovered')} }")
    # a torn checkpoint: the previous committed step stands
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        svc = SolverService(topo, backend="torch", checkpoint_dir=tmp,
                            checkpoint_every=4, device=DEV,
                            fault_plan=FaultPlan.of(torn_checkpoint(2)))
        svc.register_matrix("m", a)
        b = np.random.default_rng(seed).integers(-8, 9, a.shape[0]).astype(np.float64)
        first = svc.submit("t", "m", b, kind="solve", tol=1e-30, maxiter=8)
        svc.step()                   # saves 1 and 2 commit (iterations 4, 8)
        second = svc.submit("t", "m", b, kind="solve", tol=1e-30, maxiter=4)
        svc.step()                   # save 3 tears before _COMMITTED
        _, extra = svc.ckpt.restore()
        try:
            load_checkpoint(tmp, step=3)
            torn_loads = True
        except FileNotFoundError:
            torn_loads = False
        if not (first.status == second.status == "done"
                and svc.stats["torn_saves"] == 1 and extra["iteration"] == 8
                and not torn_loads):
            raise AssertionError(f"torn checkpoint: {svc.stats}, {extra}")
        print(f"  torn checkpoint: save 3 tore before _COMMITTED, restore "
              f"returns the committed step (iteration {extra['iteration']}), "
              f"both solves done")
        del svc
    free()


# the multi-process mesh (phase 9e) ----------------------------------------------

MESH_PROCS = 2
#: what each process of the gloo run applies per method, bare (9e) and
#: instrumented (9h): forwards at nv = 1 and 8, the transpose
#: (deterministic); the standard method's padded [512, 512, 2025] pair
#: table only at nv = 1 (the instrumented nv = 8 program peaked at 39.268
#: GB in one process, PERF.md §5)
MESH_RUNS = {"nap": ("f1", "f8", "t1"), "multistep": ("f1", "t1"),
             "standard": ("f1",)}


def draw_operands(rng, n):
    """The main path's operands in the order main draws them: the mesh
    phase's children draw them again from the seed."""
    return dict(v1=rng.standard_normal(n), v8=rng.standard_normal((n, 8)),
                u1=rng.standard_normal(n))


def digest(x):
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def all_max(x):
    """The largest of every process's ``x``: a decision all take alike."""
    import torch.distributed as dist
    vals = [None] * dist.get_world_size()
    dist.all_gather_object(vals, x)
    return max(vals)


def mesh_apply(pid, label, mesh, fn):
    """One apply in a child of the mesh phase: its ELL launches, the
    process's device-memory peak, the host wall (pack, program with the
    host staging, all-gather, unpack) and what the communicator sent to
    the other process and staged through pinned host memory."""
    before = dict(mesh.stats)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
           "launches": dict(launches),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           **{k: mesh.stats[k] - before[k] for k in mesh.stats}}
    print(f"  [p{pid}] {label}: wall {rec['wall_ms']:.2f} ms, launches "
          f"{rec['launches']}, peak {rec['peak_gb']:.3f} GB, sent across "
          f"processes node {rec['sent_bytes_node']} B + node x proc "
          f"{rec['sent_bytes_nodexproc']} B, staged {rec['staged_bytes']} B, "
          f"{rec['collectives']} collectives", flush=True)
    return out, rec


def mesh_program_ms(pid, op, runs, x):
    """Device-program ms per run (CUDA events, pack/unpack excluded), in
    lockstep across the processes (each program holds collectives):
    :func:`stack_program_ms`'s median of as many calls as fit in ~1 s."""
    out = {}
    for run in runs:
        direction = "transpose" if run == "t1" else "forward"
        ex = op.executor
        shards = ex.packed(direction, x[{"f1": "v1", "f8": "v8", "t1": "u1"}[run]])
        out[run], out[f"{run}_reps"] = stack_program_ms(ex.program(direction), shards)
        del shards
    print(f"  [p{pid}] device program ms (CUDA events, pack/unpack excluded): "
          + ", ".join(f"{r} {out[r]:.4f} (x{out[f'{r}_reps']})" for r in runs),
          flush=True)
    return out


def exit_with_parent():
    """The launching script runs on beside this child process; if it dies,
    this process stops too instead of outliving it."""
    parent = os.getppid()

    def watchdog():
        while True:
            time.sleep(2)
            if os.getppid() != parent:
                os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()


def mesh_child(spec_file):
    """One process of phases 9e and 9h, started by ``launch`` with the
    REPRO_MESH_* variables: attach, build the main path's operators over
    the node block this process owns, apply, time, calibrate, and (phase
    9h, when the spec names its inputs) run integrity on each method's
    plan, then the AMG path and the service; write the results (process
    0) and a report with the digests of every result (each process)."""
    spec = json.loads(Path(spec_file).read_text())
    exit_with_parent()
    info = attach(verbose=True)
    pid = info["process_id"]
    torch.backends.cuda.matmul.allow_tf32 = False
    a = load_csr(spec["matrix"])
    topo = Topology(32, 16)
    part = contiguous_partition(a.shape[0], topo.n_procs)
    x = draw_operands(np.random.default_rng(spec["seed"]), a.shape[0])
    mesh = mesh_for(topo)
    print(f"  [p{pid}] {info['backend']} on {info['device']} "
          f"({torch.cuda.get_device_name()}), owns nodes {mesh.nodes} = ranks "
          f"{mesh.ranks} of {topo}", flush=True)
    results, report = {}, {"pid": pid, "methods": {}, "walls": {}}
    stack = "faults" in spec
    if stack:
        report.update(integrity={}, ell={"forward": [], "transpose": []})
    for method, runs in spec["runs"].items():
        t0 = time.perf_counter()
        op = operator(a, topo, part, method=method)
        c = op.executor.compiled
        if (op.local_compute, op.T.local_compute) != ("ell", "ell"):
            op = operator(a, topo, part, method=method, local_compute="ell")
            c = op.executor.compiled
        c.ensure_ell()
        if "t1" in runs:
            c.ensure_ell_t()
        rec = {"compile_s": time.perf_counter() - t0}
        print(f"  [p{pid}] {method}: host compile {rec['compile_s']:.2f} s",
              flush=True)
        for run in runs:
            v = x[{"f1": "v1", "f8": "v8", "t1": "u1"}[run]]
            with deterministic(run == "t1"):
                w, rec[run] = mesh_apply(pid, f"{method} {run}", mesh,
                                         (lambda: op.T @ v) if run == "t1"
                                         else (lambda: op @ v))
            results[f"{method}/{run}"] = w
        rec["device_ms"] = mesh_program_ms(pid, op, runs, x)
        plan = c.ms_plan if method == "multistep" else c.plan
        report["walls"][method] = measure_phase_walls(plan, topo, device=DEV)
        report["methods"][method] = rec
        if stack:       # 9h (a), on this plan (the compile cache hands it over)
            report["integrity"][method] = stack_integrity(
                pid, a, topo, part, x, spec["faults"], mesh, method,
                op.spec.local_compute, op.executor.device, report["ell"])
        del op, c
        free()
    t0 = time.perf_counter()
    op = operator(a)                      # Topology(processes, REPRO_MESH_LOCAL_DEVICES)
    op.executor.compiled.ensure_ell()
    report["discovered"] = [op.topo.n_nodes, op.topo.ppn]
    print(f"  [p{pid}] discovered {op.topo}: host compile "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    results["discovered/f1"], report["discovered_f1"] = mesh_apply(
        pid, f"discovered {op.topo} f1", mesh_for(op.topo), lambda: op @ x["v1"])
    # its small exchanges (32 ranks) widen the calibration's range of sizes
    report["walls"]["discovered"] = measure_phase_walls(
        op.executor.compiled.plan, op.topo, device=DEV)
    del op
    free()
    if stack:
        stack_rest(pid, load_csr(spec["amg_matrix"]), topo, spec, report)
    report["digests"] = {k: digest(w) for k, w in results.items()}
    out = Path(spec["out"])
    if pid == 0:
        np.savez(out / "results.npz", **results)
    (out / f"report_{pid}.json").write_text(json.dumps(report))
    detach()
    print(f"  [p{pid}] done", flush=True)


def save_csr(path, a):
    np.savez(path, indptr=a.indptr, indices=a.indices, data=a.data,
             shape=np.asarray(a.shape))


def load_csr(path):
    with np.load(path) as z:
        return CSR(z["indptr"], z["indices"], z["data"], tuple(int(d) for d in z["shape"]))


def start_mesh_children(tmp, a, a_amg, seed, keep):
    """Start the gloo children of phases 9e and 9h (this script with
    ``--mesh-child``) on the card, in the background, with the main path's
    matrix (a file, so they need not generate it again) and 9h's inputs:
    phase 8's fault replays now, phase 9's hierarchy once
    :func:`phase_amg` has written it (the children wait for it), a shared
    checkpoint directory.  They run while this process builds phase 9's
    hierarchy and level operators, host work that times nothing on the
    card.  Returns ``finish()``: it waits for them, echoes their lines and
    returns their reports, process 0's results and the digests of the
    checkpoints they wrote.  A child that fails fails the phase
    (LaunchError, raised by ``finish``)."""
    tmp = Path(tmp)
    matrix = tmp / "a.npz"
    save_csr(matrix, a)
    amg_matrix = matrix if a_amg is a else tmp / "a_amg.npz"
    if a_amg is not a:
        save_csr(amg_matrix, a_amg)
    (tmp / "ckpt").mkdir()
    faults = {k: [(dataclasses.asdict(f), list(w)) for f, w in v]
              for k, v in keep["faults"].items()}
    spec_file = tmp / "spec.json"
    spec_file.write_text(json.dumps(dict(
        matrix=str(matrix), amg_matrix=str(amg_matrix), seed=seed, runs=MESH_RUNS,
        out=str(tmp),
        faults=faults, levels=str(tmp / "levels.npz"), ckpt=str(tmp / "ckpt"))))
    box = {}

    def run():
        try:
            box["res"] = launch(str(Path(__file__).resolve()), MESH_PROCS,
                                args=["--mesh-child", str(spec_file)],
                                local_devices=16,
                                env={"REPRO_MESH_BACKEND": "gloo"}, timeout_s=1200)
        except BaseException as e:      # re-raised by finish()
            box["err"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    print(f"[9e/9h] {MESH_PROCS} gloo children started in the background; they run "
          f"phases 9e and 9h while this process runs the simulate backend and "
          f"phase 9's hierarchy, level operators and host twins (their checks "
          f"follow phase 9d)")

    def finish():
        thread.join()
        if "err" in box:
            raise box["err"]
        res = box["res"]
        for pid in range(MESH_PROCS):
            for line in res.output(pid).splitlines():
                if line.startswith(("  [p", "[mesh.attach]", "  profile p")):
                    print(line)
        reports = [json.loads((tmp / f"report_{pid}.json").read_text())
                   for pid in range(MESH_PROCS)]
        with np.load(tmp / "results.npz") as z:
            results = {k: z[k] for k in z.files}
        for k, w in results.items():
            if any(r["digests"][k] != digest(w) for r in reports):
                raise AssertionError(f"{k}: the processes returned different results")
        return dict(reports=reports, results=results, wall_s=time.perf_counter() - t0,
                    ckpt=checkpoint_digests(tmp / "ckpt"))

    return finish


def nccl_one_process(op, v1, w1):
    """Phase 9e's NCCL check, run in this process while phase 4's plan is
    live (a child would compile it again): attach as a 1-process NCCL job
    through ``repro_torch.mesh.attach``, apply the operator again (one
    process owns every node: no collective, the one-process program) and
    run the communicator's NCCL calls on device tensors in this 1-rank
    group: the node all-to-all (float32, and uint8 words as the MoE
    island ships them) against the in-device permutation, the
    split all-to-all of the multistep direct phase against its input,
    and a stage / all-gather fetch round trip; then leave the group.
    NCCL across processes needs one card a process (not here)."""
    env = mesh_env(pick_coordinator(), 1, 0, op.topo.ppn)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        info = attach(backend="nccl")
        reset_launches()
        w = op @ v1
        ell = launches["ell_spmm_packed"]
        mesh = mesh_for(op.topo)
        g = torch.randn((op.topo.n_procs, op.topo.n_nodes, 254, 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(1))
        equal = torch.equal(node_all_to_all(g, op.topo, mesh),
                            node_all_to_all(g, op.topo))
        # the MoE island's payloads cross as uint8 words
        words = g.view(torch.uint8)
        equal &= torch.equal(node_all_to_all(words, op.topo, mesh),
                             node_all_to_all(words, op.topo))
        rows = g.reshape(-1, 254)
        equal &= torch.equal(live_all_to_all(rows, [rows.shape[0]],
                                             [rows.shape[0]], mesh), rows)
        host = g.cpu().numpy().reshape(op.topo.n_nodes, op.topo.ppn, -1)
        equal &= np.array_equal(
            fetch_mesh_array(stage_mesh_array(host, mesh, device=DEV), mesh), host)
        out = dict(backend=info["backend"], bit_equal=np.array_equal(w, w1),
                   a2a_equal=equal, stats=dict(mesh.stats), ell=ell)
    finally:
        detach()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def phase_mesh(a, keep):
    """[9e] the main path over two processes sharing the card (gloo), the
    discovered topology, phase 4's NCCL check, and the postal model fitted
    to exchange walls measured here: the checks of what the children
    started by :func:`start_mesh_children` returned (``keep["children"]``,
    phase 9h's work included).  ``keep`` holds phases 4, 6 and 7's
    single-process results (and phase 4's NCCL check) and the float64
    oracles.  Returns the ELL launches of the phase's applies, forward and
    transpose, summed over the processes."""
    print(f"[9e] mesh: {MESH_PROCS} processes share the card over gloo, each "
          f"owning 16 of Topology(32, 16)'s nodes (256 ranks); "
          f"n={int(np.sqrt(a.shape[0]))}; the same children ran phase 9h")
    t0 = time.perf_counter()
    ell = {"forward": 0, "transpose": 0}
    oracles = keep["oracles"]
    want = {"nap/f1": keep["nap"]["w1"], "nap/f8": keep["nap"]["w8"],
            "nap/t1": keep["nap"]["z1"], "multistep/f1": keep["multistep"]["w1"],
            "multistep/t1": keep["multistep"]["z1"],
            "standard/f1": keep["standard"]["w1"]}
    exact = {"f1": "w1", "f8": "w8", "t1": "z1"}
    names = {"f1": "forward nv=1", "f8": "forward nv=8", "t1": "transpose nv=1"}
    reports, results = keep["children"]["reports"], keep["children"]["results"]
    for key, w in want.items():
        got = results[key]
        if not np.array_equal(got, w):
            raise AssertionError(f"{key}: {MESH_PROCS} processes differ from the "
                                 f"single-process result (max abs "
                                 f"{np.abs(got - w).max():.3e})")
        check_oracle(f"{MESH_PROCS} processes {key}", got,
                     oracles[exact[key.split('/')[1]]])
    print(f"  {MESH_PROCS} processes: nap f1 / f8 / t1, multistep f1 / t1 and "
          f"standard f1 bit-equal to phases 4, 7 and 6 (transposes in "
          f"deterministic mode on both sides), on every process")
    for r in reports:
        if r["discovered"] != [MESH_PROCS, 16]:
            raise AssertionError(f"p{r['pid']} discovered {r['discovered']}")
    check_oracle(f"discovered Topology({MESH_PROCS}, 16) f1",
                 results["discovered/f1"], oracles["w1"])
    for r in reports:
        counts = [r["methods"][m][run]["launches"].get("ell_spmm_packed", 0)
                  for m, runs in MESH_RUNS.items() for run in runs]
        counts.append(r["discovered_f1"]["launches"].get("ell_spmm_packed", 0))
        if min(counts) < 1:
            raise AssertionError(f"p{r['pid']}: an apply did not launch the ELL "
                                 f"kernel: {counts}")
        for m, runs in MESH_RUNS.items():
            for run in runs:
                ell["transpose" if run == "t1" else "forward"] += \
                    r["methods"][m][run]["launches"]["ell_spmm_packed"]
        ell["forward"] += r["discovered_f1"]["launches"]["ell_spmm_packed"]
        for m, runs in MESH_RUNS.items():
            ms = r["methods"][m]["device_ms"]
            print(f"  p{r['pid']} {m} device program ms, {MESH_PROCS} processes vs "
                  f"one (phases 4/6/7): " + ", ".join(
                      f"{run} {ms[run]:.4f}{' (one call)' if ms[f'{run}_reps'] == 1 else ''}"
                      f" vs {keep[m]['ms'][names[run]]:.4f}" for run in runs))

    # one process over NCCL (checked in phase 4, while its plan was live)
    nccl = keep["nap"]["nccl"]
    if nccl["backend"] != "nccl" or not nccl["bit_equal"]:
        raise AssertionError(f"one NCCL process differs from phase 4: {nccl}")
    if not nccl["a2a_equal"]:
        raise AssertionError("NCCL's all-to-alls or all-gather differ from the "
                             "one-process permutations")
    if nccl["ell"] < 1:
        raise AssertionError("the NCCL process's apply did not launch the ELL kernel")
    ell["forward"] += nccl["ell"]
    print(f"  one NCCL process (phase 4's plan): nap f1 bit-equal to phase 4, "
          f"{nccl['ell']} ELL launch; NCCL's node (float32, uint8 words) and split all-to-alls and "
          f"the stage / all-gather round trip bit-equal on device tensors in "
          f"the 1-rank group ({nccl['stats']}; NCCL across processes needs "
          f"one card a process: not run here)")

    # the postal model fitted to walls measured across the two processes.
    # A record's n_msgs / nbytes charge one bottleneck rank, as the
    # reference's do, but its wall times a whole process exchanging its
    # ranks' padded buffer in one call; so the fit charges what the
    # process moves: one exchange (alpha is its start-up) of proc_bytes.
    walls = [w for ws in reports[0]["walls"].values() for w in ws]
    fit = PostalParams.calibrated(
        [dict(w, n_msgs=1, nbytes=w["proc_bytes"]) for w in walls],
        name="h100_gloo_2proc")
    for w in walls:
        across = 0 if w["axis"] == "proc" else w["proc_bytes"] // MESH_PROCS
        level = "inter" if w["inter"] else "intra"
        model = (getattr(fit, f"alpha_{level}")
                 + w["proc_bytes"] / getattr(fit, f"beta_{level}"))
        print(f"  wall {w['phase']:>6} ({level}, axis {w['axis']}, "
              f"{w['n_slots']} slots x pad {w['pad']}): bottleneck rank n_msgs "
              f"{w['n_msgs']}, nbytes {w['nbytes']}; {w['seconds'] * 1e3:.4f} ms "
              f"(fit {model * 1e3:.4f}); per process {w['proc_bytes']} B "
              f"exchanged ({w['proc_bytes'] / w['seconds'] / 1e9:.3f} GB/s), "
              f"{across} B across")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    for p in (fit, BLUE_WATERS_POSTAL):
        print(f"  postal {p.name}: " + ", ".join(
            f"{k} {getattr(p, k):.6e}"
            + (" (fit not positive: the Blue Waters default, not fitted)"
               if p is fit and getattr(p, k) == getattr(BLUE_WATERS_POSTAL, k)
               else "")
            for k in ("alpha_inter", "beta_inter", "alpha_intra", "beta_intra"))
            + (" (alpha s a process's exchange, beta B/s of its buffer)"
               if p is fit else " (alpha s a message, beta B/s a rank)"))
    print(f"  (fitted on {smi}: inter = across the two processes, intra = "
          f"inside one; Blue Waters is the paper's Cray model)")
    stack_s = max(sum(r["integrity"][m]["s"] for m in MESH_RUNS) + r["amg_s"]
                  + r["service_s"] for r in reports)
    print(f"  phase 9e checks {time.perf_counter() - t0:.1f} s; the children ran "
          f"{keep['children']['wall_s']:.1f} s from their start (during phase 9), "
          f"{stack_s:.1f} s of it phase 9h's work")
    return ell


# the node-aware stack across processes (phase 9h) -------------------------------

#: one node of each process's block: the survivors, Topology(30, 16),
#: leave each process its own 15 nodes
STACK_DEAD = ("node5", "node21")
RUN_OPERAND = {"f1": "v1", "f8": "v8", "t1": "u1"}


def run_direction(run):
    return "transpose" if run == "t1" else "forward"


def save_levels(path, levels, b):
    """The AMG hierarchy (host float64 CSR matrices) and right-hand side
    in one npz, for the children of phase 9h."""
    arrays = {"b": b, "n_levels": np.asarray(len(levels))}
    for i, lv in enumerate(levels):
        for name in ("a", "p", "r"):
            m = getattr(lv, name)
            if m is not None:
                arrays.update({f"{i}/{name}/indptr": m.indptr,
                               f"{i}/{name}/indices": m.indices,
                               f"{i}/{name}/data": m.data,
                               f"{i}/{name}/shape": np.asarray(m.shape)})
    np.savez(path, **arrays)


def load_levels(path):
    from repro_torch.amg import Level
    with np.load(path) as z:
        def csr(i, name):
            if f"{i}/{name}/indptr" not in z.files:
                return None
            return CSR(z[f"{i}/{name}/indptr"], z[f"{i}/{name}/indices"],
                       z[f"{i}/{name}/data"],
                       tuple(int(d) for d in z[f"{i}/{name}/shape"]))
        levels = [Level(a=csr(i, "a"), p=csr(i, "p"), r=csr(i, "r"))
                  for i in range(int(z["n_levels"]))]
        return levels, z["b"]


def checkpoint_digests(path):
    """Each committed step's shard digests and extra, from its manifest."""
    out = {}
    for step in sorted(Path(path).glob("step_*")):
        if (step / "_COMMITTED").exists():
            man = json.loads((step / "manifest.json").read_text())
            out[step.name] = [man["shard_digests"], man["extra"]]
    return out


def timed_step(fn):
    """One service step (or run) with its ELL launches and host wall."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launches.get("ell_spmm_packed", 0)


def stack_fault_plan():
    """Phase 9h's node loss: node5 dies at CG iteration 8, node21 at the
    next step; both fall silent from the same step, so one recovery
    evicts both (Topology(30, 16): each process keeps its 15 nodes)."""
    return FaultPlan.of(dead_node(1, STACK_DEAD[0], at_iteration=8),
                        dead_node(4, STACK_DEAD[1]))


def service_summary(svc, tickets, ckpt):
    """What a run of the service scenario must give alike in one process
    and in every process of the job: log, stats (but the rebuild's wall),
    plan-cache counters (but the bytes a plan released: a block plan holds
    fewer), ticket states, result digests and the checkpoints' digests."""
    stats = dict(svc.report()["stats"])
    stats.pop("last_recover_rebuild_s")
    return dict(log=list(svc.log), stats=stats,
                plan_cache={k: v for k, v in svc.plans.stats.items()
                            if k != "buffer_bytes_released"},
                tickets=[[t.status, t.reason, t.request.iters] for t in tickets],
                topo=[svc.topo.n_nodes, svc.topo.ppn], nodes=list(svc.nodes),
                results={str(i): digest(t.result()) for i, t in enumerate(tickets)
                         if t.status == "done"},
                checkpoints=checkpoint_digests(ckpt))


def stack_service(a, topo, ckpt, seed):
    """(c) of a child: phase 9d's requests, operands (the same draws) and
    fault plan over the node block: 8 spmv requests in one batch, a hot
    swap to an integer SPD matrix of the same structure and 8 more, a spmv
    and two solves through the loss of node5 and node21; then one CG
    iteration's body.  Returns the summary, the walls and the ELL
    launches of each step."""
    rng = np.random.default_rng(seed + 9)
    n = a.shape[0]
    svc = SolverService(topo, backend="torch", checkpoint_dir=ckpt,
                        checkpoint_every=4, max_attempts=6, device=DEV,
                        fault_plan=stack_fault_plan())
    svc.register_matrix("diffusion", a)
    walls, ell = {}, []
    V = rng.standard_normal((n, 8))
    tickets = [svc.submit(f"tenant{i % 3}", "diffusion", V[:, i]) for i in range(8)]
    _, walls["step_s"], k = timed_step(svc.step)
    ell.append(k)
    a_int = int_spd(a)
    V_int = rng.integers(-8, 9, size=(n, 8)).astype(np.float64)
    svc.update_values("diffusion", a_int)
    tickets += [svc.submit(f"tenant{i % 3}", "diffusion", V_int[:, i]) for i in range(8)]
    with timed_calls(spmv_torch.CompiledNAP, "swap_values") as swap:
        _, walls["swap_step_s"], k = timed_step(svc.step)
    walls["swap_s"] = swap.seconds[0]
    ell.append(k)
    b_int = rng.integers(-8, 9, size=n).astype(np.float64)
    B = rng.integers(-8, 9, size=(n, 2)).astype(np.float64)
    tickets.append(svc.submit("tenant0", "diffusion", b_int, kind="spmv"))
    tickets += [svc.submit(f"tenant{1 + i}", "diffusion", B[:, i], kind="solve",
                           tol=1e-5, maxiter=40, deadline=1e6) for i in range(2)]
    ck = svc.ckpt
    with timed_calls(ck, "save") as saves, timed_calls(ck, "restore") as restores:
        _, walls["run_s"], k = timed_step(lambda: svc.run(max_steps=40))
    ell.append(k)
    walls["saves"] = len(saves.seconds)
    walls["save_s"] = statistics.median(saves.seconds) if saves.seconds else None
    walls["restore_s"] = statistics.median(restores.seconds)
    walls["recover_rebuild_s"] = svc.stats["last_recover_rebuild_s"]
    summary = service_summary(svc, tickets, ckpt)
    # one CG iteration's body on the survivors' operator
    op = service_op(svc)
    P = rng.standard_normal((n, 2))
    _, walls["cg_iteration_s"], k = timed_step(lambda: cg_iteration(op, P, P, P))
    ell.append(k)
    shards = op.executor.packed("forward", P)
    walls["cg_apply_ms"], _ = stack_program_ms(op.executor.program("forward"), shards)
    del svc, op, shards
    free()
    return summary, walls, ell


def stack_lists(view, faults, v, transpose):
    """Replay phase 8's ``(fault, mismatch)`` pairs on ``view`` one apply
    each: the mismatch lists raised ([] when none), the ELL launches of
    each apply."""
    lists, counts = [], []
    for fault, _ in faults:
        view.queue_fault(MessageFault(**fault))
        reset_launches()
        with deterministic(transpose):
            try:
                view @ v
                lists.append([])
            except IntegrityError as e:
                lists.append([[m.check, m.phase, m.scope, m.node, m.proc, m.slot,
                               m.direction] for m in e.mismatches])
        counts.append(launches.get("ell_spmm_packed", 0))
    return lists, counts


def stack_program_ms(prog, shards):
    """Device ms of one program in lockstep across the processes (each
    call holds collectives): the median of up to 10 calls, as many as fit
    in ~1 s on the slower process (one call above 1 s)."""
    once = time_ms(lambda: prog(shards), reps=1, warmup=1)
    reps = max(1, min(10, int(1e3 / max(all_max(once), 1e-3))))
    if reps == 1:
        return once, 1
    return time_ms(lambda: prog(shards), reps=reps, warmup=0), reps


def stack_integrity(pid, a, topo, part, x, faults, mesh, method, local_compute,
                    device, ell):
    """(a) of a child for one method, on phase 9e's compiled plan (the
    compile cache hands the instrumented operator the bare operator's
    plan): the clean detect applies (digests, wall, peak, bytes), bare vs
    instrumented device ms, peak and bytes, phase 8's faults replayed,
    then one fault under recover per run.  Adds the ELL launches of every
    apply to ``ell``."""
    runs = MESH_RUNS[method]
    t_start = t0 = time.perf_counter()
    op = operator(a, topo, part, method=method, local_compute=local_compute,
                  integrity="detect", device=device)
    ex = op.executor
    ex.compiled.ensure_abft()
    rec = {"abft_s": time.perf_counter() - t0, "digests": {}}
    for run in runs:
        view = op.T if run == "t1" else op
        v = x[RUN_OPERAND[run]]
        with deterministic(run == "t1"):
            w, rec[run] = mesh_apply(pid, f"{method} detect {run}", mesh,
                                     lambda: view @ v)
        rec["digests"][run] = digest(w)
        ell[run_direction(run)].append(rec[run]["launches"].get("ell_spmm_packed", 0))
        del w
    rep = op.integrity_report()
    rec["clean_mismatches"] = rep["wire_mismatches"] + rep["abft_mismatches"]
    rec["wire_checks"] = rep["wire_checks"]
    spec = zero_spec(ex)
    for run in runs:
        direction = run_direction(run)
        shards = ex.packed(direction, x[RUN_OPERAND[run]])
        for label, prog in (("bare", ex.program(direction)),
                            ("instrumented", ex.program(direction, fault_spec=spec))):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = dict(mesh.stats)
            with deterministic(run == "t1"):
                y = prog(shards)
                torch.cuda.synchronize()
                moved = {k: mesh.stats[k] - before[k] for k in mesh.stats}
                del y
                peak = torch.cuda.max_memory_allocated() / 1e9
                ms, reps = stack_program_ms(prog, shards)
            rec[f"{run}/{label}"] = dict(ms=ms, reps=reps, peak_gb=peak, **moved)
        del shards
        b, i = rec[f"{run}/bare"], rec[f"{run}/instrumented"]
        print(f"  [p{pid}] {method} {run}: bare {b['ms']:.4f} ms (x{b['reps']}, "
              f"peak {b['peak_gb']:.3f} GB, {b['sent_bytes_node'] + b['sent_bytes_nodexproc']}"
              f" B to the other process, {b['staged_bytes']} B staged), "
              f"instrumented {i['ms']:.4f} ms (x{i['reps']}, peak {i['peak_gb']:.3f} GB, "
              f"{i['sent_bytes_node'] + i['sent_bytes_nodexproc']} B to the other "
              f"process, {i['staged_bytes']} B staged)", flush=True)
    t0 = time.perf_counter()
    for direction in sorted({run_direction(run) for run in runs}):
        view = op.T if direction == "transpose" else op
        v = x["u1" if direction == "transpose" else "v1"]
        rec[f"lists/{direction}"], counts = stack_lists(
            view, faults[f"{method}/{direction}"], v, direction == "transpose")
        ell[direction] += counts
    rec["faults_s"] = time.perf_counter() - t0
    rep = op.integrity_report()
    rec["detect_report"] = {k: rep[k] for k in ("applies", "faults_injected",
                                                "wire_mismatches", "abft_mismatches")}
    n = sum(len(rec.get(f"lists/{d}", [])) for d in ("forward", "transpose"))
    print(f"  [p{pid}] {method}: {n} faults of phase 8 replayed in {rec['faults_s']:.1f} s;"
          f" {rec['detect_report']}", flush=True)
    rec_op = operator(a, topo, part, method=method, local_compute=local_compute,
                      integrity="recover", device=device)
    for run in runs:
        direction = run_direction(run)
        view = rec_op.T if run == "t1" else rec_op
        fault = next(f for f, _ in faults[f"{method}/{direction}"]
                     if f["kind"] == "bitflip" and f["phase"] in ("inter", "pair", "direct"))
        view.queue_fault(MessageFault(**fault))
        reset_launches()
        with deterministic(run == "t1"):
            w = view @ x[RUN_OPERAND[run]]
        ell[direction].append(launches.get("ell_spmm_packed", 0))
        rec[f"recovered/{run}"] = digest(w)
        del w
    rec["recover_report"] = {k: v for k, v in rec_op.integrity_report().items()
                             if k != "last_mismatches"}
    rec["s"] = time.perf_counter() - t_start
    return rec


def stack_amg(pid, levels_file, topo):
    """(b) of a child: ``level_operators(materialize=True)`` over the node
    block, ``AMG_PCG`` PCG iterations and one V-cycle (deterministic
    mode, as phase 9), their walls, the ELL launches and one PCG
    iteration's busy share."""
    levels, b = load_levels(levels_file)
    a0 = scipy_of(levels[0].a)
    t0 = time.perf_counter()
    with deterministic():
        ops = level_operators(levels, topo, comm="auto", materialize=True,
                              spgemm_backend="torch", device=DEV)
    rec = {"level_operators_s": time.perf_counter() - t0}
    print(f"  [p{pid}] level_operators(materialize=True) {rec['level_operators_s']:.2f} s",
          flush=True)
    with deterministic():
        res, rec["pcg_s"], rec["pcg_ell"] = timed_step(
            lambda: amg_pcg(levels, ops, b, a0, AMG_PCG))
        z, rec["vcycle_s"], rec["vcycle_ell"] = timed_step(
            lambda: amg_vcycle(levels, b, operators=ops))

        # one PCG iteration's device work: an A apply and a V-cycle
        def iteration():
            return amg_vcycle(levels, ops[0].a @ b, operators=ops)

        _, rec["iteration_s"], _ = timed_step(iteration)
        rec["iteration_busy_ms"] = profile_program(
            f"p{pid} one PCG iteration's A apply and V-cycle", iteration,
            rec["iteration_s"] * 1e3)
    rec["res"], rec["vcycle"] = res, digest(z)
    rec["distributed"] = sum(e.a is not None for e in ops)
    print(f"  [p{pid}] PCG {rec['pcg_s']:.2f} s ({rec['pcg_ell']} ELL launches), "
          f"V-cycle {rec['vcycle_s']:.3f} s, residuals {res}", flush=True)
    del ops, levels, z
    clear_spgemm_cache()
    free()
    return rec


def stack_rest(pid, a, topo, spec, report):
    """(b) and (c) of a child, after phase 9e's and (a)'s per-method work:
    the AMG path, the service scenario, then one node lost, whose 31
    survivors split into no block of whole nodes."""
    ready = Path(f"{spec['levels']}.ready")      # written by the parent's phase 9
    t0 = time.perf_counter()
    while not ready.exists():
        if time.perf_counter() - t0 > 900:
            raise TimeoutError(f"no hierarchy at {spec['levels']} after 900 s")
        time.sleep(1)
    report["levels_wait_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["amg"] = stack_amg(pid, spec["levels"], topo)
    report["amg_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["service"], report["service_walls"], report["service_ell"] = stack_service(
        a, topo, spec["ckpt"], spec["seed"])
    svc = SolverService(topo, backend="torch", device=DEV,
                        fault_plan=FaultPlan.of(dead_node(1, STACK_DEAD[0])))
    try:
        for _ in range(8):          # silent past the heartbeat timeout
            svc.step()
        report["ragged"] = "no error"
    except DiscoveryError as e:
        report["ragged"] = f"DiscoveryError: {e}"
    report["service_s"] = time.perf_counter() - t0
    print(f"  [p{pid}] service scenario and one-node loss {report['service_s']:.1f} s",
          flush=True)


def stack_compare_integrity(reports, keep):
    """(a)'s checks: every clean and recovered apply bit-equal to the
    one-process results, every fault's mismatch list in both processes
    equal to phase 8's one-process list, no false positive."""
    want = {"nap/f1": keep["nap"]["w1"], "nap/f8": keep["nap"]["w8"],
            "nap/t1": keep["nap"]["z1"], "multistep/f1": keep["multistep"]["w1"],
            "multistep/t1": keep["multistep"]["z1"],
            "standard/f1": keep["standard"]["w1"]}
    want = {k: digest(w) for k, w in want.items()}
    n = 0
    for r in reports:
        for method, runs in MESH_RUNS.items():
            rec = r["integrity"][method]
            if rec["clean_mismatches"] or not rec["wire_checks"]:
                raise AssertionError(f"p{r['pid']} {method}: clean detect applies "
                                     f"reported {rec['clean_mismatches']} mismatches")
            for run in runs:
                for label, got in (("clean", rec["digests"][run]),
                                   ("recovered", rec[f"recovered/{run}"])):
                    if got != want[f"{method}/{run}"]:
                        raise AssertionError(f"p{r['pid']} {method} {run}: the {label} "
                                             f"detect apply differs from one process")
            rep = rec["recover_report"]
            if not rep["retries"] == rep["recovered"] == len(runs):
                raise AssertionError(f"p{r['pid']} {method} recover: {rep}")
            for direction in ("forward", "transpose"):
                lists = rec.get(f"lists/{direction}")
                if lists is None:
                    continue
                wants = [[list(w)] for _, w in keep["faults"][f"{method}/{direction}"]]
                if lists != wants:
                    bad = next(i for i, (g, w) in enumerate(zip(lists, wants)) if g != w)
                    raise AssertionError(
                        f"p{r['pid']} {method} {direction} fault {bad}: mismatches "
                        f"{lists[bad]}, one process {wants[bad]}")
                n += len(lists)
    for method in MESH_RUNS:
        reps = [r["integrity"][method]["recover_report"] for r in reports]
        if any(rep != reps[0] for rep in reps):
            raise AssertionError(f"{method}: the processes' recover reports differ")
    return n // len(reports)


def phase_stack(keep, smi):
    """[9h] integrity, the AMG path and the solver service over the two
    processes of phase 9e's launch (gloo, each owning 16 of Topology(32,
    16)'s nodes), held against phases 4, 6-9 and 9d (the one-process run
    of the same service scenario).  Returns the ELL launches of the
    phase's applies, forward and transpose, over the processes."""
    t_phase = time.perf_counter()
    reports, ckpt_written = keep["children"]["reports"], keep["children"]["ckpt"]
    print(f"[9h] the stack across processes: the {MESH_PROCS} processes of 9e's "
          f"launch (each owning 16 of Topology(32, 16)'s nodes, 256 ranks); "
          f"integrity, AMG, the solver service ({smi})")
    ell = {"forward": 0, "transpose": 0}
    # (a) integrity
    n_faults = stack_compare_integrity(reports, keep)
    print(f"  (a) integrity: clean detect applies (nap f1 / f8 / t1, multistep f1 / t1, "
          f"standard f1) and one recovered fault a run bit-equal to phases 4, 6 and 7 "
          f"in both processes; {n_faults} faults of phase 8 a process (every kind on "
          f"a live edge of every phase, senders in both blocks, inter / pair / direct "
          f"bitflips from process 0 to process 1, ABFT bit-30 flips) raised phase 8's "
          f"one-process mismatch list in both; recover reports equal [{smi}]")
    for method, runs in MESH_RUNS.items():
        for run in runs:
            nv = 8 if run == "f8" else 1
            one = keep["integrity_ms"][f"{method}/{run_direction(run)}/{nv}"]
            cells = []
            for label in ("bare", "instrumented"):
                per = [r["integrity"][method][f"{run}/{label}"] for r in reports]
                cells.append(
                    f"{label} " + " / ".join(f"{p['ms']:.4f}" for p in per)
                    + f" ms vs {one[f'{label}_ms']:.4f}, peak "
                    + " / ".join(f"{p['peak_gb']:.3f}" for p in per)
                    + f" vs {one[f'{label}_peak_gb']:.3f} GB, to the other process "
                    + " / ".join(str(p["sent_bytes_node"] + p["sent_bytes_nodexproc"])
                                 for p in per)
                    + " B, staged " + " / ".join(str(p["staged_bytes"]) for p in per)
                    + " B")
            walls = " / ".join(f"{r['integrity'][method][run]['wall_ms']:.1f}"
                               for r in reports)
            print(f"  {method} {run} p0 / p1 vs one process: " + "; ".join(cells)
                  + f"; detect apply wall {walls} ms [{smi}]")
    # (b) AMG
    amg_one = keep["amg"]
    for r in reports:
        rec = r["amg"]
        if rec["res"] != amg_one["res"]:
            raise AssertionError(f"p{r['pid']}: PCG residuals {rec['res']} differ from "
                                 f"phase 9's {amg_one['res']}")
        if rec["vcycle"] != amg_one["vcycle"]:
            raise AssertionError(f"p{r['pid']}: the V-cycle differs from phase 9's")
        if not all(abs(rd / rh - 1.0) <= 0.05 or max(rd, rh) <= 1e-5
                   for rd, rh in zip(rec["res"], amg_one["res_host"])):
            raise AssertionError(f"p{r['pid']}: PCG does not track the host twin")
        if min(rec["pcg_ell"], rec["vcycle_ell"]) < 1:
            raise AssertionError(f"p{r['pid']}: the AMG path launched no ELL kernel")
        ell["forward"] += rec["pcg_ell"] + rec["vcycle_ell"]
    per = [r["amg"] for r in reports]
    print(f"  (b) AMG: {AMG_PCG} PCG residuals and "
          f"the V-cycle bit-equal to phase 9's in both "
          f"processes ({per[0]['distributed']} distributed levels); level_operators "
          + " / ".join(f"{p['level_operators_s']:.2f}" for p in per)
          + f" s vs {amg_one['level_operators_s']:.2f}; V-cycle "
          + " / ".join(f"{p['vcycle_s']:.3f}" for p in per)
          + f" s vs {amg_one['vcycle_s']:.3f}; PCG iteration "
          + " / ".join(f"{p['pcg_s'] / AMG_PCG:.3f}" for p in per)
          + f" s vs {amg_one['pcg_s'] / 10:.3f}, device busy "
          + " / ".join(f"{p['iteration_busy_ms']:.2f} ms of {1e3 * p['iteration_s']:.1f} ("
                       f"{100 * p['iteration_busy_ms'] / 1e3 / p['iteration_s']:.2f}%)"
                       for p in per)
          + f" of its A apply and V-cycle [{smi}]")
    # (c) the service, against phase 9d's run of the same scenario
    one = keep["service"]
    for r in reports:
        got = r["service"]
        for key in one:
            if got[key] != one[key]:
                raise AssertionError(f"p{r['pid']} service: {key} differs from one "
                                     f"process: {got[key]} vs {one[key]}")
        if min(r["service_ell"]) < 1:
            raise AssertionError(f"p{r['pid']}: a service step launched no ELL kernel")
        ell["forward"] += sum(r["service_ell"])
        if "multiple of the process count" not in r["ragged"]:
            raise AssertionError(f"p{r['pid']}: one node lost did not raise: {r['ragged']}")
    if ckpt_written != one["checkpoints"]:
        raise AssertionError("the job's checkpoint directory differs from one process's")
    saves = [r["service_walls"]["saves"] for r in reports]
    if not (saves[0] > 0 and saves[1:] == [0] * (MESH_PROCS - 1)):
        raise AssertionError(f"checkpoint saves per process {saves}: process 0 alone writes")
    print(f"  (c) service: node5 and node21 lost, resumed on Topology(30, 16); logs, "
          f"stats, plan-cache counters, tickets, results and checkpoint digests "
          f"({len(one['checkpoints'])} committed steps) equal phase 9d's in both "
          f"processes; saves by process 0 only ({saves}); one node lost raises "
          f"DiscoveryError in both")
    w = [r["service_walls"] for r in reports] + [keep["service_walls"]]
    for key, unit in (("step_s", "s"), ("swap_s", "s"), ("swap_step_s", "s"),
                      ("save_s", "s"), ("restore_s", "s"), ("recover_rebuild_s", "s"),
                      ("run_s", "s"), ("cg_iteration_s", "s"), ("cg_apply_ms", "ms")):
        vals = " / ".join("-" if x[key] is None else f"{x[key]:.4f}" for x in w[:-1])
        print(f"  service {key.rsplit('_', 1)[0]} {vals} {unit} vs {w[-1][key]:.4f} "
              f"one process (9d) [{smi}]")
    for r in reports:
        if min(r["ell"]["forward"] + r["ell"]["transpose"]) < 1:
            raise AssertionError(f"p{r['pid']}: an integrity apply launched no ELL kernel")
        ell["forward"] += sum(r["ell"]["forward"])
        ell["transpose"] += sum(r["ell"]["transpose"])
        own = sum(r["integrity"][m]["s"] for m in MESH_RUNS) + r["amg_s"] + r["service_s"]
        print(f"  p{r['pid']}: ELL launches forward {sum(r['ell']['forward'])}, transpose "
              f"{sum(r['ell']['transpose'])} (integrity), AMG "
              f"{r['amg']['pcg_ell'] + r['amg']['vcycle_ell']}, service "
              f"{sum(r['service_ell'])}; 9h's share of the process: integrity "
              + " + ".join(f"{r['integrity'][m]['s']:.1f}" for m in MESH_RUNS)
              + f" s, AMG {r['amg_s']:.1f} s, service {r['service_s']:.1f} s, "
              f"{own:.1f} s in all")
    print(f"  ELL launches of phase 9h: forward {ell['forward']}, transpose "
          f"{ell['transpose']} (both processes); checks {time.perf_counter() - t_phase:.1f} s"
          f" [{smi}]")
    return ell


# MoE token dispatch (phase 9f) ----------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_TOPO = (4, 8)            # 4 pods of 8 GPUs, 32 ranks batched on the card
MOE_BATCH = (16, 512)        # 4 prompts of 512 tokens per pod: a prefill batch
MOE_MODES = ("flat", "nap", "auto")
MOE_WIRES = ("f32", "bf16", "fp8_e4m3")
MOE_EP = EPInfo(inner_axis="model", pod_axis="pod")
#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate
BF16_FLOPS = 989e12
#: what each process of the two-process island runs (bf16 wire)
MOE_PROC_MODES = ("flat", "nap")


def moe_inputs(cfg, seed):
    """The weights (bf16, from the seed, on the card) and the prefill
    batch [16, 512, 4096]: the children of 9f draw them again alike."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    p = moe_init(gen, cfg, torch.bfloat16)
    x = torch.randn(MOE_BATCH + (cfg.d_model,), generator=gen, device=DEV)
    return p, x.to(torch.bfloat16)


def words_of(t):
    """The wire words of an encoded tensor, as numpy."""
    return t.view(torch.uint8 if t.element_size() == 1 else torch.int16) \
        .cpu().numpy().view(np.uint8 if t.element_size() == 1 else np.uint16)


def moe_codecs():
    """(a) The CUDA codecs against the numpy copy over the whole sweep."""
    sweep = codec_sweep()
    n, nan_words = 0, {}
    for wd in ("bf16", "fp8_e4m3"):
        cases = [(name, x, torch.float32) for name, x in sweep.items()]
        if wd == "fp8_e4m3":   # the dispatch encodes bf16 tokens
            cases.append(("bf16_values as bf16", sweep["bf16_values"], torch.bfloat16))
        for name, x, dtype in cases:
            with np.errstate(over="ignore"):
                x32 = x.astype(np.float32)
            t = torch.from_numpy(x32).to(DEV).to(dtype)
            q = encode_torch(t, wd)
            got, want = words_of(q), encode_np(x32, wd)
            nan = np.isnan(x32)
            bad = np.flatnonzero(got[~nan] != want[~nan])
            if bad.size:
                raise AssertionError(f"{wd} {name}: {bad.size} words differ, first "
                                     f"x={x32[~nan][bad[0]]!r} card "
                                     f"{got[~nan][bad[0]]:#x} numpy {want[~nan][bad[0]]:#x}")
            if nan.any():
                if not np.isnan(decode_np(got[nan], wd)).all():
                    raise AssertionError(f"{wd} {name}: a NaN input gave a number")
                nan_words.setdefault(wd, set()).update(
                    f"{w:#x}" for w in np.unique(got[nan]))
            back = decode_torch(q, wd).cpu().numpy()
            if not np.array_equal(back[~nan], decode_np(want, wd, np.float32)[~nan]):
                raise AssertionError(f"{wd} {name}: decode differs")
            n += int((~nan).sum())
    print(f"  (a) codecs: encode_torch / decode_torch on the card equal the numpy "
          f"copy word for word on {n} non-NaN inputs (every bf16 value and "
          f"midpoint, every fp8 value, midpoint and subnormal step, +-inf, "
          f"+-449 to +-1e30, seeded draws; bf16 tokens to fp8); NaN inputs give "
          f"NaN words, on the card {nan_words} (numpy: sign | 0x7fc0 / 0x7f)")
    probe = [448.0, 449.0, 464.0, 479.0, 480.0, 1e30, float("inf"), -449.0,
             -480.0, -1e30, float("-inf"), float("nan")]
    for dtype in (torch.float32, torch.bfloat16):
        raw = torch.tensor(probe, device=DEV).to(dtype).to(torch.float8_e4m3fn)
        print(f"  raw {str(dtype)[6:]}.to(float8_e4m3fn) on the card, no clip: "
              + ", ".join(f"{v:g} -> {w:#04x} ({raw.float()[i].item():g})"
                          for i, (v, w) in enumerate(zip(probe, words_of(raw)))))


def moe_island(p, cfg, x, topo, **kw):
    """The island's float32 sums (not cast to the model's bf16: a quantized
    wire is compared with the f32 wire before that rounding)."""
    return moe_apply_sharded(p, cfg, x, MOE_EP, topo, out_dtype=torch.float32, **kw)


def moe_route_flips(p, cfg, x, chunk):
    """Tokens whose top-k expert set differs when the router's matmul runs
    over 256 tokens at a time instead of ``chunk``."""
    x2 = x.reshape(-1, cfg.d_model)
    sets = []
    for step in (chunk, 256):
        ids = torch.cat([moe_router(p, cfg, c)[1] for c in x2.split(step)])
        sets.append(ids.sort(-1).values)
    return int((sets[0] != sets[1]).any(-1).sum())


def moe_f32(p, x, cfg, topo):
    """(b) Float32 at full width against the dense oracle, no drops."""
    t0 = time.perf_counter()
    p32 = {k: v.float() for k, v in p.items()}
    x32 = x.float()
    cfg32 = cfg.replace(dtype="float32", wire_dtype="f32")
    cf = cfg.capacity_factor
    while True:
        drops = {}
        for mode in ("flat", "nap"):
            st = {}
            moe_island(p32, cfg32.replace(moe_dispatch=mode, capacity_factor=cf),
                       x32, topo, stats=st)
            drops[mode] = st["dropped"]
        if not any(v for d in drops.values() for v in d.values()):
            break
        print(f"  (b) capacity factor {cf}: drops {drops}; doubled")
        cf *= 2
    # the oracle routes each pod's tokens in one matmul of the island's
    # shape: a top-k near-tie can flip between matmuls of other shapes
    tokens_per_pod = MOE_BATCH[0] // topo.n_nodes * MOE_BATCH[1]
    flips = moe_route_flips(p32, cfg32, x32, tokens_per_pod)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = moe_apply_local(p32, cfg32, x32, chunk=tokens_per_pod)
    torch.cuda.synchronize()
    t_oracle = time.perf_counter() - t1
    scale = float(want.abs().max())
    for mode in MOE_MODES:
        st = {}
        got = moe_island(p32, cfg32.replace(moe_dispatch=mode, capacity_factor=cf),
                         x32, topo, stats=st)
        rel = float((got - want).abs().max()) / scale
        if not (rel <= 1e-4 and torch.isfinite(got).all()):
            raise AssertionError(f"(b) {mode} f32: {rel:.3e} of max |oracle| > 1e-4")
        print(f"  (b) f32 {mode} (resolved {st['mode']}), capacity factor {cf}: "
              f"max abs err / max |moe_apply_local| {rel:.3e} (gate 1e-4), "
              f"dropped {st['dropped']}, capacities {st['capacities']}")
    print(f"  (b) weights upcast to float32 ({sum(v.numel() for v in p32.values()) * 4 / 1e9:.3f} GB); "
          f"oracle (dense-masked, chunks of one pod's {tokens_per_pod} tokens) "
          f"{t_oracle:.2f} s; routed in chunks of 256 tokens instead, {flips} "
          f"tokens pick another expert set (near-ties); (b) "
          f"{time.perf_counter() - t0:.1f} s")
    del p32, x32, want, got
    free()
    return cf


def moe_arithmetic(cfg, topo, mode, wd, tokens_per_pod):
    """Padded inter-pod token bytes of one apply from the buffer shapes."""
    n_out, n_in = topo.n_nodes, topo.ppn
    tc, k = tokens_per_pod // n_in, cfg.top_k
    width = 2 if wd == "f32" else wire_bytes(wd)          # bf16 model tokens
    if mode == "flat":
        cap = max(1, int(tc * k * cfg.capacity_factor / topo.n_procs))
        return topo.n_procs * (topo.n_procs - n_in) * cap * cfg.d_model * width
    return topo.n_procs * (n_out - 1) * tc * cfg.d_model * width


def moe_modeled(p, cfg, x, topo):
    """The plans of the island's own routing (per pod, as the island
    routes), for ``dispatch_traffic``."""
    n_pods = topo.n_nodes
    ids = []
    for xp in x.chunk(n_pods):
        w, i = moe_router(p, cfg, xp.reshape(-1, cfg.d_model))
        ids.append(i.cpu().numpy())
    ids = np.concatenate(ids)
    r = routing_matrix(ids, np.ones(ids.shape), cfg.n_experts)
    ep, tp = dispatch_partitions(cfg.n_experts, r.shape[1], topo)
    return build_dispatch_plans(r, ep, tp, topo)


def moe_bf16(p, x, cfg, topo):
    """(c) bf16 at the config's capacity factor: every mode x wire."""
    t0 = time.perf_counter()
    tokens_per_pod = MOE_BATCH[0] // topo.n_nodes * MOE_BATCH[1]
    plans = moe_modeled(p, cfg, x, topo)
    flops = 0
    results, rows = {}, {}
    for mode in MOE_MODES:
        for wd in MOE_WIRES:
            c = cfg.replace(moe_dispatch=mode, wire_dtype=wd)
            st = {}
            reset_inter_node_bytes()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            y = moe_island(p, c, x, topo, stats=st)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            counted = inter_node_bytes()
            ms = time_ms(lambda: moe_island(p, c, x, topo), reps=10, warmup=1)
            resolved = st["mode"]
            axis = "nodexproc" if resolved == "flat" else "node"
            tokens = counted[f"{axis}:tokens"]
            want = moe_arithmetic(c, topo, resolved, wd, tokens_per_pod)
            if tokens != want:
                raise AssertionError(f"(c) {mode} {wd}: counted {tokens} token bytes, "
                                     f"the buffers hold {want}")
            modeled = dispatch_traffic(plans[resolved], wire_dtype=wd,
                                       nv=cfg.d_model)["injected_inter_bytes"]
            if not torch.isfinite(y).all():
                raise AssertionError(f"(c) {mode} {wd}: non-finite output")
            results[(mode, wd)] = y
            results[(mode, wd, "ms")] = ms
            if wd == "f32":
                err = ""
            else:
                ref = results[(mode, "f32")]
                rel = float((y - ref).abs().max()) / float(ref.abs().max())
                bound = wire_error_bound(c)
                if not rel <= bound:
                    raise AssertionError(f"(c) {mode} {wd}: {rel:.3e} > {bound:.3e}")
                err = f"; vs the f32 wire {rel:.3e} of max |out| (budget {bound:.4e})"
            if wd == "bf16" and mode != "auto":
                profile_program(f"(c) {mode} bf16", lambda: moe_island(p, c, x, topo), ms)
            caps = st["capacities"]
            e_flops = 2 * 3 * cfg.n_experts * caps["expert"] * cfg.d_model * cfg.moe_dff
            flops = max(flops, e_flops)
            rows[(mode, wd)] = dict(ms=ms, tokens=tokens, counted=counted)
            print(f"  (c) {mode:>4} -> {resolved:>4}, wire {wd:>8}: {ms:.4f} ms (events, "
                  f"median of 10), peak {peak:.3f} GB, dropped {st['dropped']} "
                  f"(capacities {caps}); inter-pod bytes counted: tokens {tokens} "
                  f"(buffers {want}), meta {counted[f'{axis}:meta']}, combine "
                  f"{counted[f'{axis}:combine']}; dispatch_traffic of this routing "
                  f"{modeled}{err}")
    for wd in MOE_WIRES:
        if not rows[("nap", wd)]["tokens"] < rows[("flat", wd)]["tokens"]:
            raise AssertionError(f"(c) nap does not send fewer inter-pod bytes at {wd}")
    for mode in MOE_MODES:
        if not rows[(mode, "fp8_e4m3")]["tokens"] < rows[(mode, "bf16")]["tokens"]:
            raise AssertionError(f"(c) fp8 does not shrink {mode}'s inter-pod bytes")
    print(f"  (c) expert FLOPs over the padded buffers {flops / 1e12:.3f} TFLOP an apply: "
          f"{flops / BF16_FLOPS * 1e3:.4f} ms at the dense bf16 peak; nap < flat and "
          f"fp8 < bf16 in counted inter-pod bytes; (c) {time.perf_counter() - t0:.1f} s")
    return results


def moe_operator(cfg, topo):
    """(d) The dispatch operator on the host at the same geometry."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    n_tok, nv = MOE_BATCH[0] * MOE_BATCH[1], 4
    X = rng.standard_normal((n_tok, nv))
    Y = rng.standard_normal((cfg.n_experts, nv))
    exact, stats = {}, {}
    for mode in MOE_MODES:
        for wd in MOE_WIRES:
            op = dispatch_operator(cfg.replace(moe_dispatch=mode, wire_dtype=wd),
                                   topo=topo, n_tokens=n_tok, seed=0)
            w, z = op @ X, op.T @ Y
            r = op.a
            if wd == "f32":
                exact[mode] = (w, z)
                if mode != "flat":
                    np.testing.assert_allclose(w, exact["flat"][0], rtol=1e-12, atol=1e-13)
                    np.testing.assert_allclose(z, exact["flat"][1], rtol=1e-12, atol=1e-13)
            else:
                u, dd = wire_eps(wd)
                ra = sp.csr_matrix((np.abs(r.data), r.indices, r.indptr), shape=r.shape)
                fwd = dispatch_error_budget(r, X, wd, hops=1)
                bwd = u * (ra.T @ np.abs(Y)) + dd * (ra.T @ np.ones_like(Y)) + 1e-12
                if not (np.abs(w - exact[mode][0]) <= fwd).all() \
                        or not (np.abs(z - exact[mode][1]) <= bwd).all():
                    raise AssertionError(f"(d) {mode} {wd}: outside the wire budget")
            stats[(mode, wd)] = op.stats()
    for wd in MOE_WIRES:
        f, n = (stats[(m, wd)]["dispatch_injected_inter_bytes"] for m in ("flat", "nap"))
        if not n < f:
            raise AssertionError(f"(d) nap models no fewer inter-pod bytes at {wd}")
    op = dispatch_operator(cfg.replace(moe_dispatch="nap", wire_dtype="fp8_e4m3"),
                           topo=topo, n_tokens=n_tok, seed=0, integrity="detect")
    op @ X
    # a real inter-pod message: node 1 proc 0's first, to node `dst`
    dst = op.executor.plan.inter_sends[topo.ppn][0].dst // topo.ppn
    op.inject_fault("inter", kind="bitflip", node=1, proc=0, slot=dst, element=2,
                    bit=6)
    try:
        op @ X
        raise AssertionError("(d) a flipped fp8 inter word went unseen")
    except IntegrityError as e:
        m = e.mismatches[0]
        rep = op.integrity_report()
        if (m.phase, m.node, m.slot, m.scope) != ("inter", dst, 1, "off_node") \
                or rep["wire_mismatches"] != 1 or rep["faults_injected"] != 1:
            raise AssertionError(f"(d) misattributed: {e.mismatches} {rep}")
    print(f"  (d) dispatch_operator, {n_tok} tokens of a representative routing "
          f"({r.nnz} copies), nv = {nv}, on {topo}: op @ X and op.T @ Y for every "
          f"mode x wire (flat = nap = auto in f32 to 1e-12; quantized within "
          f"dispatch_error_budget); modeled dispatch inter-pod bytes (nv = 1) "
          + ", ".join(f"{m} {wd} {stats[(m, wd)]['dispatch_injected_inter_bytes']}"
                      for m in ("flat", "nap") for wd in MOE_WIRES)
          + f"; auto -> {stats[('auto', 'bf16')]['dispatch_resolved']} / "
          f"{stats[('auto', 'bf16')]['combine_resolved']}; an fp8 bitflip on the "
          f"nap inter message of node 1 proc 0 to node {dst} detected: {m} (host "
          f"{time.perf_counter() - t0:.1f} s)")


def moe_child(spec_file):
    """One process of 9f's two-process island, started by ``launch``:
    attach over gloo, draw the inputs, run its block of pods."""
    spec = json.loads(Path(spec_file).read_text())
    info = attach(verbose=True)
    pid, world = info["process_id"], info["num_processes"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    topo = Topology(*MOE_TOPO)
    p, x = moe_inputs(cfg, spec["seed"])
    mesh = mesh_for(topo)
    shard = x.shape[0] // world
    xs = x[pid * shard:(pid + 1) * shard]
    report = {"pid": pid, "nodes": list(mesh.nodes)}
    for mode in MOE_PROC_MODES:
        c = cfg.replace(moe_dispatch=mode, wire_dtype="bf16")
        before = dict(mesh.stats)
        reset_inter_node_bytes()
        y = moe_island(p, c, xs, mesh)
        torch.cuda.synchronize()
        report[mode] = {"stats": {k: v - before.get(k, 0) for k, v in mesh.stats.items()},
                        "counted": inter_node_bytes(),
                        "ms": time_ms(lambda: moe_island(p, c, xs, mesh), reps=3,
                                      warmup=0)}
        torch.save(y.cpu(), Path(spec["out"]) / f"moe_{mode}_{pid}.pt")
        print(f"  [p{pid}] {mode}: {report[mode]['ms']:.2f} ms", flush=True)
    (Path(spec["out"]) / f"moe_report_{pid}.json").write_text(json.dumps(report))
    detach()
    print(f"  [p{pid}] done", flush=True)


def moe_processes(cfg, topo, seed, one):
    """(e) Two gloo processes sharing the card, 2 pods each, against the
    one-process island ``one`` (mode -> bf16-wire output)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        spec_file = Path(tmp) / "spec.json"
        spec_file.write_text(json.dumps({"seed": seed, "out": tmp}))
        res = launch(str(Path(__file__).resolve()), MESH_PROCS,
                     args=["--moe-child", str(spec_file)], local_devices=MOE_TOPO[1],
                     env={"REPRO_MESH_BACKEND": "gloo"}, timeout_s=600)
        for pid in range(MESH_PROCS):
            for line in res.output(pid).splitlines():
                if line.startswith(("  [p", "[mesh.attach]")):
                    print(line)
        reports = [json.loads((Path(tmp) / f"moe_report_{pid}.json").read_text())
                   for pid in range(MESH_PROCS)]
        outs = {m: torch.cat([torch.load(Path(tmp) / f"moe_{m}_{pid}.pt")
                              for pid in range(MESH_PROCS)]) for m in MOE_PROC_MODES}
    tokens_per_pod = MOE_BATCH[0] // topo.n_nodes * MOE_BATCH[1]
    for mode in MOE_PROC_MODES:
        want = one[(mode, "bf16")].cpu()
        if not torch.equal(outs[mode], want):
            diff = float((outs[mode].float() - want.float()).abs().max())
            raise AssertionError(f"(e) {mode}: two processes differ from one "
                                 f"(max abs {diff:.3e})")
        c = cfg.replace(moe_dispatch=mode, wire_dtype="bf16")
        axis = "nodexproc" if mode == "flat" else "node"
        # the token rows each process sends to the other's chips (pods)
        if mode == "flat":
            n = topo.n_procs // MESH_PROCS
            cap = max(1, int(tokens_per_pod // topo.ppn * c.top_k * c.capacity_factor
                             / topo.n_procs))
            across = n * n * cap * c.d_model * 2
        else:
            across = topo.n_procs // MESH_PROCS * (topo.n_nodes // MESH_PROCS) \
                * (tokens_per_pod // topo.ppn) * c.d_model * 2
        for r in reports:
            st = r[mode]["stats"]
            if st[f"sent_bytes_{axis}:tokens"] != across:
                raise AssertionError(f"(e) p{r['pid']} {mode}: sent "
                                     f"{st[f'sent_bytes_{axis}:tokens']} token bytes, "
                                     f"the buffers give {across}")
            print(f"  (e) p{r['pid']} {mode} bf16 (nodes {r['nodes']}): {r[mode]['ms']:.2f} ms "
                  f"(events, median of 3; one process {one[(mode, 'bf16', 'ms')]:.4f}); sent to "
                  f"the other process: tokens {st[f'sent_bytes_{axis}:tokens']} (buffer "
                  f"arithmetic {across}), meta {st[f'sent_bytes_{axis}:meta']}, combine "
                  f"{st[f'sent_bytes_{axis}:combine']}, all {st[f'sent_bytes_{axis}']}; "
                  f"staged {st['staged_bytes']}; inter-pod (own ranks, both sides "
                  f"of the process boundary) {st[f'inter_node_bytes_{axis}']}")
    print(f"  (e) two gloo processes, 2 pods each: flat and nap bit-equal to the "
          f"one-process island; (e) {time.perf_counter() - t0:.1f} s")


def phase_moe(seed):
    """[9f] MoE token dispatch at qwen3-moe-235b-a22b's full width."""
    cfg = get_config(MOE_ARCH)
    topo = Topology(*MOE_TOPO)
    print(f"[9f] moe: {MOE_ARCH} (d_model {cfg.d_model}, {cfg.n_experts} experts, "
          f"top-{cfg.top_k}, moe_dff {cfg.moe_dff}, capacity factor "
          f"{cfg.capacity_factor}, dispatch {cfg.moe_dispatch}, wire {cfg.wire_dtype}) "
          f"on {topo} (one pod a node of 8 GPUs), x {MOE_BATCH + (cfg.d_model,)} bf16")
    moe_codecs()
    p, x = moe_inputs(cfg, seed)
    print(f"  weights {sum(v.numel() for k, v in p.items() if k != 'router')} expert "
          f"parameters in bf16, from the seed on the card")
    cf = moe_f32(p, x, cfg, topo)
    one = moe_bf16(p, x, cfg, topo)
    keep = {k: v for k, v in one.items() if k[0] in MOE_PROC_MODES and k[1] == "bf16"}
    del p, x, one
    free()
    moe_operator(cfg, topo)
    moe_processes(cfg, topo, seed, keep)
    del keep
    free()
    print(f"  9f's f32 island ran at capacity factor {cf}")


# the hierarchical collectives (phase 9g) ----------------------------------------
COLL_ARCH = "gemma2-2b"
COLL_TOPO = (4, 8)           # 4 pods of an 8-GPU machine, 32 ranks batched on the card
COLL_PROC_TOPO = (2, 4)      # the reference's own mesh, one pod a process
COLL_REPS = 10
COLL_GATE = 1e-5             # of max |float64 sum|
COLL_INT8_GATE = 0.02        # the reference's gate (tests/multidev/collectives_prog.py)
COLL_MOE_TOKENS = 256        # tokens a rank: x [16, 512, 4096] over 32 ranks
COLL_MOE_CAPACITY = 256


def layer_grad_shapes(cfg):
    """The parameter shapes of one decoder layer of ``cfg`` (q, k, v, o,
    the gated FFN's three matrices, the norms), from the model's own
    ``block_init`` at that width."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    block = block_init(gen, cfg, torch.float32, d_ff=cfg.d_ff)

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) \
            else tuple(t.shape)
    out = shapes(block)
    del block
    return out


def grad_bucket(shapes, n_ranks, seed):
    """``[n_ranks, N]`` float32 from the seed on the card."""
    n = sum(math.prod(s) for s in tree_leaves(shapes, tuple))
    gen = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn((n_ranks, n), generator=gen, device=DEV)


def bucket_tree(flat, shapes):
    """The gradient tree as views of the bucket ``flat [P, N]``, leaves in
    sorted-key order (the order the collectives flatten them in)."""
    off = 0

    def build(t):
        nonlocal off
        if isinstance(t, tuple):
            n = math.prod(t)
            off += n
            return flat[:, off - n:off].view((flat.shape[0],) + t)
        return {k: build(t[k]) for k in sorted(t)}
    return build(shapes)


def tree_leaves(tree, leaf=torch.Tensor):
    """The leaves of a nested dict in sorted-key order."""
    if isinstance(tree, leaf):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k], leaf)]


def tree_flat(tree):
    """A result tree back to one ``[P, N]`` bucket (leaves in sorted-key
    order)."""
    leaves = tree_leaves(tree)
    return torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=1)


def f64_sum(flat):
    """The float64 sum over the ranks, by numpy on the host in column
    blocks, back on the card."""
    return torch.from_numpy(np.concatenate([
        c.cpu().numpy().astype(np.float64).sum(0)
        for c in flat.split(1 << 22, dim=1)])).to(DEV)


def max_abs_diff(got, want):
    """max |got[r] - want| over every rank, in column blocks (float64)."""
    return max(float((g.double() - w).abs().max())
               for g, w in zip(got.split(1 << 22, dim=1), want.split(1 << 22)))


def replicas_equal(out):
    return all(torch.equal(out[r], out[0]) for r in range(1, out.shape[0]))


def timed(fn):
    """(result, device ms of that call, the peak of device memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), torch.cuda.max_memory_allocated() / 1e9


def coll_counted(fn):
    """Run ``fn`` with the communicator's inter-pod counts reset; return
    (result, counts)."""
    reset_inter_node_bytes()
    out = fn()
    return out, inter_node_bytes()


def coll_psums(flat, tree, topo, want, scale):
    """(a) nap_psum_tree and flat_psum_tree on the layer's gradient;
    returns nap's result bucket and its counted inter-pod bytes."""
    nbytes = flat.numel() * 4
    bound, by = bound_ms(2 * nbytes, 0)
    n_in, n_out, P = topo.ppn, topo.n_nodes, topo.n_procs
    per_rank = flat.shape[1] * 4
    want_bytes = {"nap": 2 * P * (n_out - 1) * per_rank // (n_in * n_out),
                  "flat": 2 * P * (P - n_in) * per_rank // P}
    rows = {}
    for name, fn, axis in (("nap", nap_psum_tree, "node"),
                           ("flat", flat_psum_tree, "nodexproc")):
        (out, first_ms, peak), counted = coll_counted(lambda: timed(
            lambda: fn(tree, topo)))
        got = counted.get(f"{axis}:psum", 0)
        if got != want_bytes[name] or counted.get(axis) != got:
            raise AssertionError(f"(a) {name}: counted {counted}, the buffers give "
                                 f"{want_bytes[name]}")
        out_flat = tree_flat(out)
        del out
        err = max_abs_diff(out_flat, want) / scale
        if not err <= COLL_GATE:
            raise AssertionError(f"(a) {name}: {err:.3e} of max |float64 sum| > "
                                 f"{COLL_GATE}")
        same = replicas_equal(out_flat)
        if name == "nap" and not same:
            raise AssertionError("(a) nap: the replicas differ")
        ms = time_ms(lambda: fn(tree, topo), reps=COLL_REPS, warmup=1)
        rows[name] = dict(ms=ms, bytes=got, out=out_flat)
        print(f"  (a) {name}_psum_tree: {ms:.4f} ms (events, median of {COLL_REPS}; "
              f"first call {first_ms:.4f}), bound {bound:.4f} ms ({by}; share "
              f"{bound / ms:.1%}), peak {peak:.3f} GB (the {nbytes / 1e9:.2f} GB "
              f"input included); inter-pod bytes counted {got:,} (buffers "
              f"{want_bytes[name]:,}); max err {err:.3e} of max |float64 sum| "
              f"(gate {COLL_GATE}); replicas bit-equal {same}")
    diff = max_abs_diff(rows["flat"]["out"], rows["nap"]["out"][0]) / scale
    if not diff <= COLL_GATE:
        raise AssertionError(f"(a) nap and flat differ by {diff:.3e} of max |sum|")
    ratio = rows["flat"]["bytes"] / rows["nap"]["bytes"]
    if rows["nap"]["bytes"] * n_in != rows["flat"]["bytes"]:
        raise AssertionError(f"(a) nap moves 1/{ratio:.4f} of flat's bytes, not 1/{n_in}")
    print(f"  (a) nap vs flat: {diff:.3e} of max |sum| apart; nap moves 1/{ratio:g} "
          f"of flat's inter-pod bytes (1/|inner| = 1/{n_in})")
    return rows["nap"]["out"], rows["nap"]["bytes"]


def coll_fsdp(flat, topo, nap_out):
    """(b) nap_reduce_scatter then nap_all_gather on the same bucket."""
    n_in, n_out, P = topo.ppn, topo.n_nodes, topo.n_procs
    (rs, rs_ms, _), c_rs = coll_counted(lambda: timed(
        lambda: nap_reduce_scatter(flat, topo)))
    (ag, ag_ms, peak), c_ag = coll_counted(lambda: timed(
        lambda: nap_all_gather(rs, topo)))
    # rank (o, i) holds chunk i * n_out + o: nap_psum's result in that order
    chunks = nap_out[0].view(n_in, n_out, -1).transpose(0, 1).reshape(P, -1)
    if not torch.equal(rs, chunks):
        raise AssertionError("(b) the reduce-scatter's chunks are not nap_psum's "
                             "in the (o, i) -> i * n_pods + o order")
    if not torch.equal(ag, nap_out):
        raise AssertionError("(b) the all-gather of the scattered chunks is not "
                             "nap_psum's result")
    rs_ms = time_ms(lambda: nap_reduce_scatter(flat, topo), reps=COLL_REPS, warmup=1)
    ag_ms = time_ms(lambda: nap_all_gather(rs, topo), reps=COLL_REPS, warmup=1)
    print(f"  (b) nap_reduce_scatter {rs_ms:.4f} ms, inter-pod bytes "
          f"{c_rs['node:scatter']:,}; nap_all_gather {ag_ms:.4f} ms, "
          f"{c_ag['node:gather']:,} (peak {peak:.3f} GB); rank (o, i) holds "
          f"chunk i * {n_out} + o, bit-equal to nap_psum's, and the gather "
          f"of the chunks bit-equal to nap_psum's result")


def coll_all_to_all(flat, topo):
    """(c) nap_all_to_all against flat_all_to_all, the bucket as [P, N/P]
    a rank."""
    P = topo.n_procs
    x = flat.view(P, P, -1)
    outs, rows = {}, {}
    for name, fn, axis in (("nap", nap_all_to_all, "node"),
                           ("flat", flat_all_to_all, "nodexproc")):
        (out, _, peak), counted = coll_counted(lambda: timed(lambda: fn(x, topo)))
        outs[name] = out
        ms = time_ms(lambda: fn(x, topo), reps=COLL_REPS, warmup=1)
        rows[name] = (ms, counted[f"{axis}:all_to_all"], peak)
    if not (torch.equal(outs["nap"], outs["flat"])
            and torch.equal(outs["nap"], x.transpose(0, 1))):
        raise AssertionError("(c) nap_all_to_all differs from flat_all_to_all "
                             "or from out[d][s] = x[s][d]")
    bound, _ = bound_ms(2 * flat.numel() * 4, 0)
    print(f"  (c) all-to-all of [{P}, {x.shape[2]:,}] a rank: "
          + "; ".join(f"{n} {ms:.4f} ms (share {bound / ms:.1%}), inter-pod "
                      f"bytes {b:,}, peak {pk:.3f} GB" for n, (ms, b, pk) in rows.items())
          + "; nap bit-equal to flat")
    del outs, x


def coll_compressed(flat, topo, want, scale, f32_bytes):
    """(d) nap_psum_compressed: int8 pod stage, error feedback."""
    n_in, n_out, P = topo.ppn, topo.n_nodes, topo.n_procs
    ((out, res), first_ms, peak), counted = coll_counted(lambda: timed(
        lambda: nap_psum_compressed(flat, topo)))
    err = max_abs_diff(out[:1], want) / scale
    if not err <= COLL_INT8_GATE:
        raise AssertionError(f"(d) int8 psum: {err:.3e} of max |sum| > {COLL_INT8_GATE}")
    if not replicas_equal(out):
        raise AssertionError("(d) int8 psum: the replicas differ")
    shard = flat.shape[1] // n_in
    want_bytes = P * 2 * (n_out - 1) * (-(-shard // n_out) + 4)
    if counted["node:int8"] != want_bytes:
        raise AssertionError(f"(d) counted {counted['node:int8']} int8 bytes, the "
                             f"ring gives {want_bytes}")
    out2, res2 = nap_psum_compressed(flat, topo, residual=res)
    mean = torch.stack([out[0], out2[0]]).mean(0)
    err2 = max_abs_diff(out2[:1], want) / scale
    err_mean = max_abs_diff(mean[None], want) / scale
    ms = time_ms(lambda: nap_psum_compressed(flat, topo), reps=COLL_REPS, warmup=1)
    print(f"  (d) nap_psum_compressed: {ms:.4f} ms (events, median of {COLL_REPS}; "
          f"first call {first_ms:.4f}), peak {peak:.3f} GB; err {err:.3e} of max "
          f"|float64 sum| (gate {COLL_INT8_GATE}), replicas bit-equal; a second "
          f"step fed the residual {err2:.3e}, the two-step mean {err_mean:.3e}; "
          f"int8 inter-pod bytes {want_bytes:,} against the f32 nap's {f32_bytes:,} "
          f"({want_bytes / f32_bytes:.4f}x); residual {tuple(res.shape)}")
    del out, res, out2, res2, mean


def coll_moe(topo, seed):
    """(e) nap_moe_dispatch at phase 9f's geometry."""
    cfg = get_config(MOE_ARCH)
    P, n_in, n_out = topo.n_procs, topo.ppn, topo.n_nodes
    gen = torch.Generator(device=DEV).manual_seed(seed)
    router = {"router": dense_init(gen, cfg.d_model, cfg.n_experts, torch.float32)}
    x = torch.randn(MOE_BATCH + (cfg.d_model,), generator=gen, device=DEV) \
        .to(torch.bfloat16)
    e_loc = cfg.n_experts // P
    tokens = x.reshape(P, COLL_MOE_TOKENS, cfg.d_model)
    ids = moe_router(router, cfg, x.reshape(-1, cfg.d_model))[1]
    dest = (ids // e_loc).to(torch.int32).reshape(P, COLL_MOE_TOKENS, cfg.top_k)
    cap, T, D = COLL_MOE_CAPACITY, COLL_MOE_TOKENS, cfg.d_model
    ((recv, src, valid), first_ms, peak), counted = coll_counted(lambda: timed(
        lambda: nap_moe_dispatch(tokens, dest, topo, cap)))
    # every (token, chip) pair: delivered exactly once, or dropped where the
    # gateway's buffer for that chip is full
    d_np = dest.cpu().numpy().reshape(P * T, -1).astype(np.int64)
    gid = np.repeat(np.arange(P * T), d_np.shape[1])
    wanted = np.unique(gid * P + d_np.reshape(-1))
    src_np, valid_np = src.cpu().numpy(), valid.cpu().numpy()
    chip = np.repeat(np.arange(P), src_np.shape[1]).reshape(src_np.shape)
    got = src_np[valid_np].astype(np.int64) * P + chip[valid_np]
    if np.unique(got).size != got.size:
        raise AssertionError("(e) a (token, chip) pair arrived twice")
    if not np.isin(got, wanted).all():
        raise AssertionError("(e) a token arrived where it was not sent")
    dropped = np.setdiff1d(wanted, got)
    full = valid_np.reshape(P, n_in, cap).all(-1)              # [chip, gateway]
    if dropped.size and not full[dropped % P, (dropped // P // T) % n_in].all():
        raise AssertionError("(e) a pair was dropped from a buffer with room")
    flat_tok = tokens.reshape(-1, D)
    if not torch.equal(recv[valid], flat_tok[src[valid].long()]):
        raise AssertionError("(e) a delivered payload differs from its token")
    ms = time_ms(lambda: nap_moe_dispatch(tokens, dest, topo, cap), reps=COLL_REPS,
                 warmup=1)
    # the live deduplicated traffic: (token, remote pod) pairs, bf16 rows
    pods = d_np // n_in
    own = (np.arange(P * T) // T // n_in)[:, None]
    live = sum(int(((pods == o) & (own != o)).any(1).sum()) for o in range(n_out))
    padded = {k: counted[f"node:{k}"] for k in ("tokens", "meta", "srcs")}
    want_tok = P * (n_out - 1) * cap * D * 2
    if padded["tokens"] != want_tok:
        raise AssertionError(f"(e) counted {padded['tokens']} token bytes, the "
                             f"buffers give {want_tok}")
    print(f"  (e) nap_moe_dispatch: {MOE_ARCH} router on x {MOE_BATCH + (D,)} bf16, "
          f"{T} tokens a rank, top-{cfg.top_k} experts on chip expert // {e_loc}, "
          f"capacity {cap}: {got.size:,} (token, chip) pairs delivered once each "
          f"with bit-exact payloads, {dropped.size} dropped at full buffers; "
          f"{ms:.4f} ms (events, median of {COLL_REPS}; first {first_ms:.4f}), peak "
          f"{peak:.3f} GB; padded inter-pod bytes counted {padded} against the live "
          f"deduplicated tokens {live:,} x {D} x 2 = {live * D * 2:,}")
    del recv, src, valid, tokens, x


def coll_child(spec_file):
    """One process of 9g's two-process run, started by ``launch``: attach
    over gloo, draw the layer's bucket for the reference's mesh, run its
    pod's block through the collectives, report digests and walls."""
    spec = json.loads(Path(spec_file).read_text())
    info = attach(verbose=True)
    pid = info["process_id"]
    topo = Topology(*COLL_PROC_TOPO)
    mesh = mesh_for(topo)
    shapes = layer_grad_shapes(get_config(COLL_ARCH))
    full = grad_bucket(shapes, topo.n_procs, spec["seed"])
    r0, r1 = mesh.ranks
    flat = full[r0:r1].clone()
    del full
    torch.cuda.empty_cache()
    report = {"pid": pid, "ranks": [r0, r1]}
    for name, fn in coll_proc_cases(flat, shapes, topo, mesh).items():
        before = dict(mesh.stats)
        reset_inter_node_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        report[name] = {"wall_ms": wall, "digests": coll_digests(out),
                        "stats": {k: v - before.get(k, 0) for k, v in mesh.stats.items()}}
        print(f"  [p{pid}] {name}: wall {wall:.1f} ms", flush=True)
        del out
    (Path(spec["out"]) / f"coll_report_{pid}.json").write_text(json.dumps(report))
    detach()
    print(f"  [p{pid}] done", flush=True)


def coll_proc_cases(flat, shapes, topo, mesh):
    """What 9g runs in one process and in each of two: name -> thunk."""
    n = flat.shape[0]
    tree = bucket_tree(flat, shapes)
    return {
        "nap_psum_tree": lambda: nap_psum_tree(tree, topo, mesh),
        "flat_psum_tree": lambda: flat_psum_tree(tree, topo, mesh),
        "nap_psum_compressed": lambda: nap_psum_compressed(flat, topo, mesh),
        "nap_all_to_all": lambda: nap_all_to_all(
            flat.view(n, topo.n_procs, -1), topo, mesh),
    }


def coll_digests(out):
    """sha256 of each rank's block of every output (a tree as its bucket),
    from the host."""
    outs = (tree_flat(out),) if isinstance(out, dict) else \
        out if isinstance(out, tuple) else (out,)
    return [[hashlib.sha256(t[r].contiguous().cpu().numpy()).hexdigest()
             for r in range(t.shape[0])] for t in outs]


def coll_processes(seed):
    """(f) Two gloo processes sharing the card, Topology(2, 4), one pod a
    process: bit-equal to one process, bytes to the other process."""
    t0 = time.perf_counter()
    topo = Topology(*COLL_PROC_TOPO)
    shapes = layer_grad_shapes(get_config(COLL_ARCH))
    flat = grad_bucket(shapes, topo.n_procs, seed)
    one = {}
    for name, fn in coll_proc_cases(flat, shapes, topo, None).items():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        one[name] = {"wall_ms": (time.perf_counter() - t1) * 1e3,
                     "digests": coll_digests(out)}
        del out
    per_rank = flat.shape[1] * 4
    del flat
    free()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_coll_") as tmp:
        spec_file = Path(tmp) / "spec.json"
        spec_file.write_text(json.dumps({"seed": seed, "out": tmp}))
        res = launch(str(Path(__file__).resolve()), MESH_PROCS,
                     args=["--coll-child", str(spec_file)],
                     local_devices=COLL_PROC_TOPO[1],
                     env={"REPRO_MESH_BACKEND": "gloo"}, timeout_s=600)
        for pid in range(MESH_PROCS):
            for line in res.output(pid).splitlines():
                if line.startswith(("  [p", "[mesh.attach]")):
                    print(line)
        reports = [json.loads((Path(tmp) / f"coll_report_{pid}.json").read_text())
                   for pid in range(MESH_PROCS)]
    P = topo.n_procs
    p_loc, n_far = P // MESH_PROCS, topo.n_nodes - topo.n_nodes // MESH_PROCS
    # bytes each process sends the other: its ranks' messages to far pods
    # (ranks), in the reduce-scatter and in the all-gather
    across = {"nap_psum_tree": ("node", "psum", 2 * p_loc * n_far * per_rank
                                // (topo.ppn * topo.n_nodes)),
              "flat_psum_tree": ("nodexproc", "psum",
                                 2 * p_loc * (P - p_loc) * per_rank // P)}
    for name in one:
        for r in reports:
            got = [d[r["ranks"][0]:r["ranks"][1]] for d in one[name]["digests"]]
            if r[name]["digests"] != got:
                raise AssertionError(f"(f) {name}: process {r['pid']} differs from "
                                     f"one process")
        if name in across:
            axis, label, want = across[name]
            for r in reports:
                sent = r[name]["stats"].get(f"sent_bytes_{axis}:{label}", 0)
                if sent != want:
                    raise AssertionError(f"(f) {name}: p{r['pid']} sent {sent} bytes "
                                         f"to the other process, the blocks give {want}")
        st = [r[name]["stats"] for r in reports]
        print(f"  (f) {name}: two processes bit-equal to one; walls p0 / p1 "
              f"{reports[0][name]['wall_ms']:.1f} / {reports[1][name]['wall_ms']:.1f} "
              f"ms (one process {one[name]['wall_ms']:.1f}); sent to the other process "
              f"node {st[0]['sent_bytes_node']:,} / {st[1]['sent_bytes_node']:,}, "
              f"node x proc {st[0]['sent_bytes_nodexproc']:,} / "
              f"{st[1]['sent_bytes_nodexproc']:,}; staged {st[0]['staged_bytes']:,}")
    print(f"  (f) {topo}, {MESH_PROCS} gloo processes, one pod each; (f) "
          f"{time.perf_counter() - t0:.1f} s")


def phase_collectives(seed):
    """[9g] the hierarchical collectives at a gemma2-2b layer's gradient."""
    cfg = get_config(COLL_ARCH)
    topo = Topology(*COLL_TOPO)
    shapes = layer_grad_shapes(cfg)
    flat = grad_bucket(shapes, topo.n_procs, seed)
    tree = bucket_tree(flat, shapes)
    print(f"[9g] hierarchical collectives: one {COLL_ARCH} decoder layer's gradient "
          f"({flat.shape[1]:,} f32 values, {flat.shape[1] * 4 / 1e6:.2f} MB a rank: "
          f"{shapes}) on {topo}, {topo.n_procs} ranks batched on the card, "
          f"{flat.numel() * 4 / 1e9:.2f} GB in all, from the seed")
    want = f64_sum(flat)
    scale = float(want.abs().max())
    nap_out, f32_bytes = coll_psums(flat, tree, topo, want, scale)
    coll_fsdp(flat, topo, nap_out)
    del nap_out
    free()
    coll_all_to_all(flat, topo)
    free()
    coll_compressed(flat, topo, want, scale, f32_bytes)
    del flat, tree, want
    free()
    coll_moe(topo, seed)
    free()
    coll_processes(seed)
    free()


# gemma2-2b serving (phases 10-12) ------------------------------------------------
ATTN_REPLACES = "src/repro/kernels/decode_attn/kernel.py:71"
ATTN_SOURCE = "src/repro_torch/csrc/decode_attn.cu"


def attn_tolerance(q, k, plain, lengths, window, scale, softcap):
    """Per-sequence limit on |kernel - plain|: the same f32 inputs summed
    in two orders, under the random-rounding model (n roundings grow as
    sqrt(n) u, not n u; u = 2^-24).
    - A score's error is about delta = u (sqrt(D) smax + 4 cap): the
      D-term dot product (smax = scale max|q| max|k|, Cauchy-Schwarz),
      then the scaling and tanhf.
    - Relative errors delta_s of the softmax weights move out by
      sum_s p_s delta_s (v_s - out), independent terms, so about
      delta sqrt(sum_s p_s^2 (v_s - out)^2): delta times the spread of
      out itself, which the largest of its Hkv g D entries, max|plain_b|,
      exceeds.
    - The running sums over the sequence's n_b valid rows and the
      partials add about u sqrt(n_b) max|plain_b|.
    The limit is 8 times u (sqrt(D) smax + 4 cap + sqrt(n_b)) max|plain_b|
    (two versions, two kinds of error, a factor 2 for the model).  It
    scales with the output, so a combine that drops one partial or a
    chunk that skips rows of a long sequence (a change of order
    max|plain_b| / partials) fails it."""
    d = q.shape[-1]
    norm = lambda t: float(torch.linalg.vector_norm(  # noqa: E731
        t, dim=-1, dtype=torch.float32).max())
    smax = scale * norm(q) * norm(k)
    n = lengths.long().clamp(min=0, max=k.shape[2])
    if window:
        n = n.clamp(max=window)
    out_b = plain.abs().amax(dim=(1, 2, 3)).double()
    return 8.0 * U32 * (d ** 0.5 * smax + 4.0 * softcap + n.double().sqrt()) * out_b


def attn_case(label, q, k, v, lengths, window, softcap, scale, timed=True):
    """Kernel vs plain (and the library at softcap 0) on one layout;
    the kernels-line numbers of this case."""
    run = lambda: decode_attention_grouped(q, k, v, lengths, scale=scale,  # noqa: E731
                                           softcap=softcap, window=window)
    plain_fn = lambda: decode_attention_ref(q, k, v, lengths, scale=scale,  # noqa: E731
                                            softcap=softcap, window=window)
    out, plain = run(), plain_fn()
    torch.cuda.synchronize()
    tol = attn_tolerance(q, k, plain, lengths, window, scale, softcap)
    err_b = (out - plain).abs().amax(dim=(1, 2, 3)).double()
    err = float(err_b.max())
    ratio = err_b / tol.clamp_min(1e-300)
    worst = int(ratio.argmax())
    print(f"  {label}: max_abs_err {err:.3e} (per-sequence tolerance "
          f"{float(tol.min()):.3e} .. {float(tol.max()):.3e}); worst err / "
          f"tolerance {float(ratio[worst]):.3e} (sequence {worst}, length "
          f"{int(lengths[worst])}: err {float(err_b[worst]):.3e}, tolerance "
          f"{float(tol[worst]):.3e}); max |out| {float(plain.abs().max()):.3f}")
    if not bool((err_b <= tol).all()) or not torch.isfinite(out).all():
        print(f"  {label}: by sequence, lengths {lengths.tolist()}, err "
              f"{[f'{e:.3e}' for e in err_b.tolist()]}, tolerance "
              f"{[f'{t:.3e}' for t in tol.tolist()]}")
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    b, hkv, g, d = q.shape
    n = lengths.long().clamp(min=0, max=k.shape[2])
    n = n.clamp(max=window) if window else n
    rows = int(n.sum())
    nbytes = (2 * rows * hkv * d * k.element_size() + q.nbytes
              + b * hkv * g * d * 4 + lengths.nbytes)
    bms, by = bound_ms(nbytes, 4.0 * rows * hkv * g * d)
    entry = dict(max_abs_err=err, bound_ms=bms, bound_by=by, library_ms=None)
    if not timed:
        return entry
    pos = torch.arange(k.shape[2], device=DEV)[None]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos >= lengths[:, None] - window
    q4, mask4 = q.reshape(b, hkv * g, 1, d), mask[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k, v, attn_mask=mask4, scale=scale, enable_gqa=True)
    lib_err = float((library().float().reshape(out.shape) - decode_attention_grouped(
        q, k, v, lengths, scale=scale, window=window)).abs().max())
    entry.update(ms=time_ms(run), device_ms=device_ms(run), plain_ms=time_ms(plain_fn),
                 library_ms=time_ms(library))
    ms0 = time_ms(lambda: decode_attention_grouped(q, k, v, lengths, scale=scale,
                                                   window=window))
    profile_program(label, run, entry["ms"])
    print(f"  {label}: {attn_split(q, k, n, window)}, beside "
          f"{2 * rows * hkv * d * k.element_size() / 1e6:.3f} MB of k/v rows")
    print(f"  {label}: {rows} k/v rows of {k.shape[2]} x {b}, {nbytes / 1e9:.4f} GB; "
          f"kernel {entry['ms']:.4f} ms (device {entry['device_ms']:.4f}; softcap 0: "
          f"{ms0:.4f}), bound {bms:.4f} ms "
          f"({by}), plain {entry['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"(softcap 0) {entry['library_ms']:.4f} ms, its result vs the kernel "
          f"at softcap 0: max_abs_err {lib_err:.3e}")
    return entry


def attn_split(q, k, n, window):
    """The work's split of a call on the card (``n``: each sequence's
    positions inside the masks): g = 1's units of a run of positions and
    a group of kv heads, one launch, the partials' scratch (kept for the
    shape) and the bytes of it written; g >= 2's one block a (b, kv head),
    or the units of its split and the partials' scratch allocated and
    written (one slot a unit) with the combine."""
    b, hkv, g, d = q.shape
    if g == 1:
        hg, phases, grid = g1_launch(q)
        run, units = g1_units(n.tolist(), hkv, hg, grid)
        floats, ints = g1_scratch(b, hkv, d, hg, grid)
        split = sum(u[5] > 1 for u in units)
        return (f"g = 1: {len(units)} units of {hg} kv heads x up to {run} positions "
                f"({max(u[4] for u in units) * hg} rows; the even share "
                f"{hkv * int(n.sum()) / grid:.0f} a block) on {grid} blocks, {phases} "
                f"lane groups a head, one launch; partials {4 * floats / 1e6:.3f} MB kept "
                f"for the shape, {4 * split * hg * (d + 2) / 1e6:.3f} MB written and "
                f"merged by each group's last unit")
    n_blocks = launch_blocks(q, k, window)
    units = split_units((-(-n // TILE)).tolist(), hkv, n_blocks) if n_blocks else []
    if not n_blocks:
        return "one block a (b, kv head), one launch (no combine)"
    return (f"{len(units)} units of up to {max(u[3] for u in units)} tiles on {n_blocks} "
            f"blocks, and the combine; partials "
            f"{4 * scratch_floats(b * hkv, g, d, n_blocks) / 1e6:.3f} MB allocated, "
            f"{4 * len(units) * g * (d + 2) / 1e6:.3f} MB written and read back")


DECODE_32K_LENGTHS = (1, 17, 4096, 4097, 9000, 20000, 30000, 32768)   # 99,979 rows


def heads_case(arch, seed, b, s, lengths, what):
    """The decode kernel at ``arch``'s heads on bf16 [B, S, Hkv, D] caches
    drawn from the seed, at ``lengths``; the kernels-line numbers."""
    cfg = get_config(arch)
    hkv, d = cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    lengths = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    kv = [torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
          for gen in (torch.Generator(device=DEV).manual_seed(seed + i) for i in (1, 2))]
    q = torch.randn((b, hkv, g, d), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(seed + 3)
                    ).to(torch.bfloat16)
    entry = attn_case(f"{arch} {what}: B {b}, S {s}, Hkv {hkv}, g {g}, D {d}, bf16 "
                      f"[B,S,Hkv,D]", q, kv[0].transpose(1, 2), kv[1].transpose(1, 2),
                      lengths, 0, cfg.attn_softcap, d ** -0.5)
    del kv, q
    free()
    return entry


def decode_32k_case(arch, seed):
    """The decode kernel at ``arch``'s heads, B 8, S 32768, at decode_32k's
    ragged lengths."""
    return heads_case(arch, seed, 8, 32768, DECODE_32K_LENGTHS, "heads")


def kernel_entry(arch, entry, launches=0):
    """A kernels-line entry of the decode kernel at ``arch``'s heads."""
    return dict(name="decode_attention_grouped:" + arch, route="cuda", source=ATTN_SOURCE,
                replaces=ATTN_REPLACES, launches=launches, **entry)


def phase_decode_attn(rng, gen, seed=0):
    """[10] the decode-attention kernel at gemma2-2b's decode_32k shapes,
    chameleon-34b's, zamba2's and whisper's heads, and the small
    instantiations.  Returns the kernels-line entry and those at zamba2's
    and whisper's heads (g = 1)."""
    cfg = get_config("gemma2-2b")
    b, s, hkv, d = 8, 32768, cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_heads // hkv
    print(f"[10] decode attention: B {b}, S {s}, Hkv {hkv}, g {g}, D {d}, softcap "
          f"{cfg.attn_softcap}")
    lengths = np.concatenate([[1, 17, 4096, 4097], rng.integers(1, s + 1, 3), [s]])
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(DEV)
    q = torch.randn((b, hkv, g, d), generator=gen, device=DEV).to(torch.bfloat16)
    kc = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    vc = torch.randn((b, s, hkv, d), generator=gen, device=DEV).to(torch.bfloat16)
    scale, cap = 1.0 / d ** 0.5, cfg.attn_softcap
    print(f"  lengths {lengths.tolist()}; cache [B, S, Hkv, D] bf16, k+v "
          f"{(kc.nbytes + vc.nbytes) / 1e9:.3f} GB")
    main = attn_case("bf16 [B,S,Hkv,D] window 0", q, kc.transpose(1, 2),
                     vc.transpose(1, 2), lengths, 0, cap, scale)
    attn_case(f"bf16 [B,S,Hkv,D] window {cfg.sliding_window}", q, kc.transpose(1, 2),
              vc.transpose(1, 2), lengths, cfg.sliding_window, cap, scale)
    k32 = kc.transpose(1, 2).float().contiguous()
    del kc
    v32 = vc.transpose(1, 2).float().contiguous()
    del vc
    attn_case("f32 [B,Hkv,S,D] window 0", q.float(), k32, v32, lengths, 0, cap, scale)
    del k32, v32
    free()
    # chameleon-34b's heads: g = 8 at D = 128
    decode_32k_case("chameleon-34b", seed)
    # one query row a kv head (g = 1): zamba2's heads (D 80) and whisper's
    # (D 64) at decode_32k's lengths, and whisper's cross-attention as it is
    # served: 4 sequences over all 1500 encoder rows
    late = {"zamba2-2.7b": decode_32k_case("zamba2-2.7b", seed)}
    decode_32k_case("whisper-small", seed)
    enc = get_config("whisper-small").encoder_seq
    late["whisper-small"] = heads_case("whisper-small", seed, 4, enc, (enc,) * 4,
                                       "cross-attention")
    # the kernel's other instantiations (one and two M-tiles, rows past 32
    # in a second launch, D buckets 128 / 256 with D % 16 = 8, both
    # types), untimed at small shapes: S = 1000 in one block a pair (window
    # 0 and 100), S = 3000 split over blocks with the combine
    for gg, dd, dtype in ((1, 64, torch.float32), (3, 128, torch.bfloat16),
                          (8, 256, torch.bfloat16), (16, 96, torch.float32),
                          (16, 128, torch.bfloat16), (4, 256, torch.bfloat16),
                          (6, 56, torch.bfloat16), (24, 120, torch.bfloat16),
                          (40, 40, torch.float32), (40, 200, torch.bfloat16)):
        qs = torch.randn((2, 2, gg, dd), generator=gen, device=DEV).to(dtype)
        ks, vs = (torch.randn((2, 3000, 2, dd), generator=gen, device=DEV).to(dtype)
                  for _ in range(2))
        for s_len, w, ls in ((1000, 0, [1000, 333]), (1000, 100, [1000, 333]),
                             (3000, 0, [3000, 1500])):
            attn_case(f"g {gg} D {dd} {str(dtype)[6:]} S {s_len} window {w}", qs,
                      ks[:, :s_len].transpose(1, 2), vs[:, :s_len].transpose(1, 2),
                      torch.tensor(ls, dtype=torch.int32, device=DEV), w, 30.0,
                      dd ** -0.5, timed=False)
    return (dict(name="decode_attention_grouped", route="cuda", source=ATTN_SOURCE,
                 replaces=ATTN_REPLACES, launches=0, **main),
            {arch: kernel_entry(arch, e) for arch, e in late.items()})


SERVE_PROMPT = 256           # phase 11's teacher-forced prompt
SERVE_BATCH, SERVE_GEN, SERVE_MAX_SEQ = 4, 32, 1024
SERVE_POS = SERVE_PROMPT + SERVE_GEN    # the served cache's position after generate
PREFILL_LEN = 512            # phase 14's prompt: 512 of prefill_32k's 32768 tokens


def phase_serve(n_layers, seed):
    """[11] gemma2-2b serving at full width through serve.generate."""
    cfg = get_config("gemma2-2b").replace(n_layers=n_layers)
    # the first SERVE_PROMPT of phase 14's 512 tokens (512 before a cut for the time limit)
    batch, prompt_len, gen_len, max_seq = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_MAX_SEQ
    print(f"[11] serve: {cfg.name}, {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}; batch {batch}, prompt {prompt_len}, gen "
          f"{gen_len}, max_seq {max_seq}")
    t0 = time.perf_counter()
    model = build_model(cfg).init(seed)
    torch.cuda.synchronize()
    n_params = count_params(model)
    param_bytes = sum(p.nbytes for p in model.parameters())
    print(f"  init from seed {seed} on the card {time.perf_counter() - t0:.2f} s; "
          f"{n_params} parameters, {param_bytes / 1e9:.3f} GB")
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, PREFILL_LEN))
    res, counts = drive("generate", lambda: generate(model, prompts[:, :prompt_len],
                                                     gen_len, max_seq))
    steps = prompt_len + gen_len
    n_launch = counts.get("decode_attention_grouped", 0)
    if n_launch != cfg.n_layers * steps:
        raise AssertionError(f"decode_attention_grouped launched {n_launch} times, "
                             f"not layers x steps = {cfg.n_layers * steps}")
    if not torch.isfinite(res.logits).all():
        raise AssertionError("serve: non-finite logits")
    step = statistics.median(res.step_ms)
    # bound of the median greedy step: every parameter byte and the cache
    # rows it reads (count c = tokens stored; even layers capped at the window)
    c = prompt_len + gen_len // 2 + 1
    rows = sum(min(c, cfg.sliding_window if i % 2 == 0 else max_seq)
               for i in range(cfg.n_layers))
    cache_bytes = rows * batch * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    step_bound = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"  kernel launches {n_launch} = {cfg.n_layers} layers x {steps} steps; "
          f"prompt {res.prefill_ms:.1f} ms ({res.prefill_ms / prompt_len:.3f} ms/step); "
          f"greedy step median {step:.4f} ms (min {min(res.step_ms):.4f}, max "
          f"{max(res.step_ms):.4f}), {batch * 1e3 / step:.1f} tok/s; step bound "
          f"{step_bound:.4f} ms (params {param_bytes / 1e9:.3f} GB + cache rows "
          f"{cache_bytes / 1e6:.1f} MB at 3.35 TB/s); logits finite; greedy ids "
          f"[batch 0] {res.tokens[0, :8].tolist()}...")
    cache, tok = res.cache, res.tokens[:, -1:]
    # [28b] one more greedy step counted on the card (the meta twin of
    # phase 28 takes the same cache position)
    if cache["pos"] != SERVE_POS:
        raise AssertionError(f"served cache at {cache['pos']}, not {SERVE_POS}")
    with count_ops() as counted:
        model.decode_step(cache, tok)
    torch.cuda.synchronize()
    COUNTED["decode"] = (counted, step)
    # the kernel against its plain version at the serve path's own shapes:
    # the served cache read in place, its lengths after the last step,
    # the windows of an even and an odd layer, a query drawn from the seed
    g = cfg.n_heads // cfg.n_kv_heads
    q = torch.randn((batch, cfg.n_kv_heads, g, cfg.head_dim), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(seed)
                    ).to(cache["layers"]["k"].dtype)
    for i in range(min(2, cfg.n_layers)):
        w = cfg.sliding_window if i % 2 == 0 else max_seq
        attn_case(f"served cache, layer {i}, window {w}", q,
                  cache["layers"]["k"][i].transpose(1, 2),
                  cache["layers"]["v"][i].transpose(1, 2), cache["length"], w,
                  cfg.attn_softcap, cfg.head_dim ** -0.5)
    profile_program("serve: 4 greedy decode steps",
                    lambda: [model.decode_step(cache, tok) for _ in range(4)], 4 * step)
    # the model and the prompts' teacher-forced result, for phase 14
    served = dict(model=model, prompts=prompts, prefill_ms=res.prefill_ms,
                  prompt_logits=res.prompt_logits[:, 0], first_ids=res.tokens[:, 0])
    del res, cache
    free()
    return n_launch, served


def step_check(label, cfg, seed, batch=4, n_steps=8):
    """``n_steps`` decode steps through the kernel, then the same steps
    with the plain version swapped into ``models.attention``: the logits,
    the kernel's launches (layers x steps) and the plain run's (none)."""
    model = build_model(cfg).init(seed)
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (batch, n_steps))).to(DEV)

    def run():
        cache, out = model.init_cache(batch, 64), []
        for t in range(n_steps):
            logits, cache = model.decode_step(cache, toks[:, t:t + 1])
            out.append(logits)
        return torch.stack(out)

    reset_launches()
    got = run()
    n_launch = launches["decode_attention_grouped"]
    kernel = attention.decode_attention_grouped
    attention.decode_attention_grouped = decode_attention_ref
    try:
        reset_launches()
        want = run()
        plain_launches = launches["decode_attention_grouped"]
    finally:
        attention.decode_attention_grouped = kernel
    err = float((got - want).abs().max())
    # Both runs do the same f32 products on the card and differ only in the
    # attention's summation order (<= 8 rows: ~1e-6 relative); through the
    # layers and the head that stays below 1e-4 on logits of tens, so 1e-3
    # leaves a wide margin.
    tol = 1e-3
    print(f"{label} decode step, {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
          f"{n_steps} steps: kernel ({n_launch} launches) vs plain ({plain_launches}) "
          f"logits max_abs_err {err:.3e} (tolerance {tol:.0e}), max |logit| "
          f"{float(want.abs().max()):.2f}")
    if n_launch != cfg.n_layers * n_steps or plain_launches != 0 or not err <= tol \
            or not torch.isfinite(got).all():
        raise AssertionError(f"{label} decode step through the kernel disagrees "
                             f"with the plain one")
    del model, got, want
    free()


def phase_step_check(seed):
    """[12] the decode step through the kernel vs through the plain version."""
    step_check("[12]", get_config("gemma2-2b").replace(n_layers=2, dtype="float32"),
               seed)


# gemma2-2b prefill and training (phases 13-17) ------------------------------------
BF16_FLOPS = 989e12          # H100 SXM dense bf16 (NVIDIA's data sheet)
# the held training steps (4 before phases 22-23 needed the time: 3 cut
# ~52 s of CPU time that phase 9 waits for)
HELD = dict(batch=4, seq=64, steps=3, lr=1e-3)


def held_config():
    """Phase 12's config: gemma2-2b at full width, 2 layers, float32."""
    return get_config("gemma2-2b").replace(n_layers=2, dtype="float32")


def within(got, want, rtol, atol):
    """max of |got - want| - (atol + rtol |want|): <= 0 when allclose."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def prefill_check(label, cfg, seed, batch=4, s=64):
    """``LM.prefill`` of a seeded [batch, s] prompt against the
    teacher-forced ``decode_step`` (last logits and every cache tensor,
    the dense layers' too, at atol 1e-3) and ``LM.hidden`` + the head
    against every step (rtol 2e-2 / atol 2e-3)."""
    model = build_model(cfg).init(seed)
    toks = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (batch, s))).to(DEV)
    logits, cache = model.prefill(toks)
    dcache, steps = model.init_cache(batch, s), []
    for t in range(s):
        out, dcache = model.decode_step(dcache, toks[:, t:t + 1])
        steps.append(out[:, 0])
    steps = torch.stack(steps, 1)
    with torch.no_grad():
        full = head_logits(model.hidden(toks), model.head_matrix(), cfg.final_softcap)
    torch.cuda.synchronize()
    err = dict(logits=float((logits - steps[:, -1]).abs().max()))
    for group in (g for g in ("dense_layers", "layers") if g in cache):
        for name, t in cache[group].items():
            err[f"{group}/{name}"] = float((t - dcache[group][name]).abs().max())
    over = within(full, steps, 2e-2, 2e-3)
    print(f"{label} prefill, {cfg.name} {cfg.n_layers} layers {cfg.dtype}, [{batch}, "
          f"{s}] prompt: last logits and caches vs teacher-forced decode_step max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + " (tolerance 1e-3); "
          f"hidden + head vs every decode step: max excess over rtol 2e-2 / atol 2e-3 "
          f"{over:.3e} (<= 0 passes); cache length {cache['length'].tolist()}, pos "
          f"{cache['pos']}")
    if not (max(err.values()) <= 1e-3 and over <= 0 and torch.isfinite(logits).all()
            and cache["pos"] == s):
        raise AssertionError(f"{label} prefill disagrees with the teacher-forced "
                             f"decode step")
    del model, cache, dcache, steps, full
    free()


def phase_prefill_held(seed):
    """[13] ``LM.prefill`` against the teacher-forced ``decode_step`` and
    against ``hidden`` + head, on phase 12's config and weights."""
    prefill_check("[13]", held_config(), seed)


def phase_prefill_full(served):
    """[14] ``LM.prefill`` at full width on phase 11's weights and prompts."""
    model = served["model"]
    cfg = model.cfg
    toks = torch.from_numpy(served["prompts"]).to(DEV)
    b, s = toks.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, cache = model.prefill(toks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(logits).all():
        raise AssertionError("full-width prefill: non-finite logits")
    del cache
    # phase 11 teacher-forced the first SERVE_PROMPT tokens: the prefill of
    # those against its logits
    head, cache = model.prefill(toks[:, :SERVE_PROMPT])
    diff = float((head - served["prompt_logits"]).abs().max())
    same_ids = bool((head.argmax(-1) == served["first_ids"]).all())
    del cache, head
    ms = time_ms(lambda: model.prefill(toks), reps=5, warmup=1)
    with count_ops() as counted:        # [28b] one prefill counted on the card
        model.prefill(toks)
    torch.cuda.synchronize()
    COUNTED["prefill"] = (counted, ms)
    busy = profile_program("prefill", lambda: model.prefill(toks), ms)
    # matmul FLOPs of the layers (the embedding is a lookup), the head at
    # the last position, and the attention blocks as computed (full
    # [S, S] blocks: S <= block_q)
    n_layer = count_params(model) - cfg.vocab * cfg.d_model
    flops = 2 * n_layer * b * s + 2 * cfg.d_model * cfg.vocab * b \
        + 4 * b * s * s * cfg.n_heads * cfg.head_dim * cfg.n_layers
    print(f"[14] prefill at full width: {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, "
          f"{b} x {s} prompts (phase 11's, extended): {ms:.4f} ms (CUDA events, median "
          f"of 5), phase 11's teacher-forced {SERVE_PROMPT} tokens took "
          f"{served['prefill_ms']:.1f} ms; peak memory {peak / 1e9:.3f} GB; "
          f"{flops / 1e12:.2f} TFLOP, {100 * flops / (ms / 1e3) / BF16_FLOPS:.1f}% of "
          f"the bf16 peak; busy {100 * busy / ms:.1f}%; the prefill of the first "
          f"{SERVE_PROMPT} tokens vs their teacher-forced last logits max_abs_err "
          f"{diff:.3e} (bf16, recorded), greedy ids agree: {same_ids}; logits finite")


def release():
    """Drop the freed tensors' cached blocks (``free`` without clearing the
    SpMV compile cache, which phase 9's operators still use)."""
    gc.collect()
    torch.cuda.empty_cache()


def held_setup(seed):
    """Phase 15's config (phase 12's, one microbatch) and bigram batches."""
    cfg = held_config().replace(grad_accum=1)
    ds = SyntheticLM(cfg.vocab, HELD["seq"], seed=seed)
    return cfg, [ds.batch(i, HELD["batch"]) for i in range(HELD["steps"])]


def held_opt(dtype):
    return AdamWConfig(lr=HELD["lr"], warmup_steps=1, total_steps=HELD["steps"],
                       state_dtype=dtype)


def int8_codes(state, device=None):
    """A copy of the int8 moment codes, by path, on ``device`` (the
    state's own by default)."""
    return {(key,) + path: t.detach().to(device or t.device, copy=True)
            for key in ("m", "v") for path, t in tree_leaves_with_path(state[key])
            if t.dtype == torch.int8}


def run_steps(model, opt_cfg, batches):
    """Steps of ``make_train_step`` on ``model``'s device: the losses, the
    state, and the int8 codes after the first step (None for float32)."""
    opt_state = adamw_init(model.param_tree(), opt_cfg)
    step_fn, losses, first = make_train_step(model, opt_cfg), [], None
    for b in batches:
        loss, _ = step_fn(opt_state, train.to_device(b, model.device))
        losses.append(float(loss))
        if first is None and opt_cfg.state_dtype == "int8":
            first = int8_codes(opt_state)
    return losses, opt_state, first


def row_slices(t, rows=8192):
    """Slices of ``t``'s leading axis (all of a 1-D tensor): the int8
    blocks run along the last axis, so a slice of rows holds whole blocks
    and its scales are the same rows of theirs."""
    if t.dim() < 2:
        return [slice(None)]
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def code_flips(got, want):
    """(max |code difference|, codes that differ, codes) of two code sets."""
    worst, flips, total = 0, 0, 0
    for k, w in want.items():
        for sl in row_slices(w):
            d = (got[k][sl].to(torch.int16) - w[sl].to(torch.int16)).abs()
            worst, flips, total = max(worst, int(d.max())), \
                flips + int((d > 0).sum()), total + d.numel()
    return worst, flips, total


def held_cpu_twin(seed, threads=None):
    """Phase 15's host half: the 4 steps on the CPU for both moment dtypes,
    from weights drawn from the seed on the CPU, on ``threads`` threads
    (all by default).  The starting weights and the results (weights,
    codes) move to the card, so the host holds none of them while the
    script runs on."""
    cfg, batches = held_setup(seed)
    before = torch.get_num_threads()
    threads = threads or before
    torch.set_num_threads(threads)
    out = {}
    try:
        start = build_model(cfg, device="cpu").init(seed).param_tree()
        out["start"] = tree_map(lambda t: t.detach().to(DEV, copy=True), start)
        for dtype in ("float32", "int8"):
            t0 = time.perf_counter()
            host = build_model(cfg.replace(opt_state_dtype=dtype), device="cpu").load(start)
            losses, state, first = run_steps(host, held_opt(dtype), batches)
            out[dtype] = dict(
                losses=losses, seconds=time.perf_counter() - t0,
                params=tree_map(lambda t: t.detach().to(DEV), host.param_tree()),
                first=first and {k: t.to(DEV) for k, t in first.items()},
                last=int8_codes(state, DEV) if dtype == "int8" else None)
            del host, state
        del start
    finally:
        torch.set_num_threads(before)
    print(f"  [15] the CPU half of phase 15 ({threads} threads): {HELD['steps']} steps "
          f"float32 {out['float32']['seconds']:.1f} s, int8 {out['int8']['seconds']:.1f} s")
    return out


def start_cpu_twin(seed, threads=3):
    """Phase 15's CPU half in a background thread, beside the 9e / 9h
    children and the host work of phases 8-9 (it runs no kernel on the
    card); returns ``finish()``, which waits for it and returns its
    result."""
    box = {}

    def work():
        try:
            box["out"] = held_cpu_twin(seed, threads)
        except BaseException as e:      # re-raised by finish()
            box["err"] = e

    thread = threading.Thread(target=work, daemon=True)
    thread.start()

    def finish():
        t0 = time.perf_counter()
        thread.join()
        if "err" in box:
            raise box["err"]
        print(f"  waited {time.perf_counter() - t0:.1f} s for phase 15's CPU half")
        return box.pop("out")     # held nowhere else once phase 15 is done

    return finish


def int8_codec_check(state, first, host):
    """The card's int8 codecs against the CPU's on the card's own moments
    (each leaf dequantized on the card, then quantized on the card and on
    the CPU): codes within +-1, the scales within 1e-6 relative.  The
    free-running codes of the two devices are recorded, not gated: the
    steps' float32 moments differ at round-off, and in a block whose values
    all sit at round-off (the saturated softcap makes many) the codes
    differ freely."""
    worst, flips, total, scale_rel = 0, 0, 0, 0.0
    for key, deq, quant in (("m", adamw_mod._q8_dequant, adamw_mod._q8_quant),
                            ("v", adamw_mod._q8l_dequant, adamw_mod._q8l_quant)):
        for path, q in tree_leaves_with_path(state[key]):
            if path[-1] != "q":
                continue
            st = tree_at(state[key], path[:-1])
            for sl in row_slices(q):
                x = deq({part: t[sl] for part, t in st.items()})
                on_card, on_cpu = quant(x), quant(x.cpu())
                d = (on_card["q"].cpu().to(torch.int16) - on_cpu["q"].to(torch.int16)).abs()
                worst, flips, total = max(worst, int(d.max())), \
                    flips + int((d > 0).sum()), total + d.numel()
                for part in on_cpu:
                    if part != "q":
                        a, b = on_card[part].cpu(), on_cpu[part]
                        scale_rel = max(scale_rel, float(((a - b).abs() / b.abs().clamp_min(
                            1e-30)).max()))
                del x, on_card, on_cpu
    if worst > 1 or scale_rel > 1e-6:
        raise AssertionError(f"int8 codecs on the card vs the CPU: codes differ by "
                             f"{worst}, scales by {scale_rel:.3e} relative")
    c1 = code_flips(first, host["first"])
    c4 = code_flips(int8_codes(state), host["last"])
    return (f"; the card's int8 codecs against the CPU's on the card's moments: codes "
            f"within +-{worst} ({flips} of {total} differ), scales within "
            f"{scale_rel:.1e} relative; the free-running codes (recorded) after step 1 "
            f"max |diff| {c1[0]} ({c1[1]} differ), after step {HELD['steps']} "
            f"{c4[0]} ({c4[1]} differ)")


def held_close(label, got, want, moved):
    """Parameters of two runs: every element within ``2 moved`` (AdamW moves
    an element by about +-lr a step wherever its gradient sits at
    round-off level) and 99% within 1e-6 of max |p|; returns the worst.
    Compared on ``got``'s device, a leaf at a time."""
    pairs = list(zip([t for _, t in tree_leaves_with_path(got)],
                     [t for _, t in tree_leaves_with_path(want)]))
    scale = max(float(w.detach().abs().max()) for _, w in pairs)
    worst, outside, n = 0.0, 0, 0
    for g, w in pairs:
        d = (g.detach().float() - w.detach().to(g.device).float()).abs()
        worst = max(worst, float(d.max()))
        outside += int((d > 1e-6 * scale).sum())
        n += d.numel()
        del d
    if not (worst <= 2 * moved and outside <= 0.01 * n):
        raise AssertionError(f"{label}: parameters differ by {worst:.3e} (limit "
                             f"{2 * moved:.3e}), {outside} of {n} beyond 1e-6 of max |p|")
    return worst, outside / n


def phase_train_held(seed, twin=None):
    """[15] training held on the card: card against CPU for both moment
    dtypes (``twin``: ``held_cpu_twin``'s result, computed here when
    None), grad_accum 2 against 1, and a resumed run bit-equal to a
    straight one, on phase 12's config.  It times nothing on the card (a
    few seconds of kernels; the rest is comparisons on the card and
    checkpoint I/O), so the script runs it while phase 9 waits for the
    9e / 9h children; it leaves the SpMV compile cache, which phase 9's
    operators use, alone."""
    t0 = time.perf_counter()
    cfg, batches = held_setup(seed)
    twin = twin or held_cpu_twin(seed)
    moved = HELD["lr"] * HELD["steps"]
    start = twin.pop("start")
    print(f"[15] training held on the card: {cfg.name}, 2 layers, float32, "
          f"{count_params(build_model(cfg, device='cpu'))} parameters drawn from the "
          f"seed on the CPU; {HELD['steps']} steps of {HELD['batch']} x {HELD['seq']} "
          f"bigram tokens, lr {HELD['lr']}")
    for dtype in ("float32", "int8"):
        host = twin[dtype]
        card = build_model(cfg.replace(opt_state_dtype=dtype)).load(start)
        t1 = time.perf_counter()
        losses, state, first = run_steps(card, held_opt(dtype), batches)
        t_card = time.perf_counter() - t1
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, host["losses"]))
        worst, share = held_close(f"card vs CPU ({dtype})", card.param_tree(),
                                  host["params"], moved)
        codes = ""
        if dtype == "int8":
            codes = int8_codec_check(state, first, host)
        print(f"  card vs CPU, {dtype} moments: losses {[round(x, 4) for x in losses]} "
              f"max rel diff {rel:.3e} (rtol 1e-4); parameters max |diff| {worst:.3e} "
              f"(limit {2 * moved:.1e}), {100 * share:.4f}% beyond 1e-6 of max |p|{codes}; "
              f"card {t_card:.1f} s, CPU {host['seconds']:.1f} s")
        if not rel <= 1e-4:
            raise AssertionError(f"card vs CPU losses ({dtype}) differ by {rel:.3e}")
        del card, state
        release()
    del start, twin
    # grad_accum = 2 against 1 on the same global batches
    one = build_model(cfg).init(seed)
    one_losses, _, _ = run_steps(one, held_opt("float32"), batches)
    two = build_model(cfg.replace(grad_accum=2)).init(seed)
    two_losses, _, _ = run_steps(two, held_opt("float32"), batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(two_losses, one_losses))
    worst, share = held_close("grad_accum 2 vs 1", two.param_tree(), one.param_tree(), moved)
    print(f"  grad_accum 2 vs 1 on the card: losses max rel diff {rel:.3e} (rtol 1e-4); "
          f"parameters max |diff| {worst:.3e}, {100 * share:.4f}% beyond 1e-6 of max |p|")
    if not rel <= 1e-4:
        raise AssertionError("grad_accum 2 disagrees with 1")
    del one, two
    release()
    # a resumed run against a straight one, deterministic mode; int8 moments
    # (their codes and scales go through the checkpoint too, at half the
    # bytes of float32 ones)
    cfg = cfg.replace(opt_state_dtype="int8")
    kw = dict(steps=HELD["steps"], batch=HELD["batch"], seq=HELD["seq"], lr=HELD["lr"],
              seed=seed, device=DEV, log_every=HELD["steps"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp, \
            deterministic(warn_only=True):
        t1 = time.perf_counter()
        straight = train.train(cfg, ckpt_dir=f"{tmp}/a", ckpt_every=2, **kw)
        t_straight = time.perf_counter() - t1
        # the run as if it stopped after step 2's checkpoint
        shutil.copytree(f"{tmp}/a/step_00000002", f"{tmp}/b/step_00000002")
        t1 = time.perf_counter()
        resumed = train.train(cfg, ckpt_dir=f"{tmp}/b", ckpt_every=0, resume=True, **kw)
        t_resumed = time.perf_counter() - t1
        ckpt_gb = dir_bytes(f"{tmp}/b/step_00000002") / 1e9
    same = [torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path((straight.model.param_tree(), straight.opt_state)),
        tree_leaves_with_path((resumed.model.param_tree(), resumed.opt_state)))
        if isinstance(a, torch.Tensor)]
    ok = all(same) and resumed.losses == straight.losses[2:] and \
        resumed.opt_state["step"] == straight.opt_state["step"] == HELD["steps"]
    print(f"  resume (deterministic mode, int8 moments): {HELD['steps']} steps straight "
          f"({t_straight:.1f} s, checkpoints at 2 and {HELD['steps']}) against 2 steps, "
          f"checkpoint ({ckpt_gb:.3f} "
          f"GB), --resume, {HELD['steps'] - 2} steps ({t_resumed:.1f} s): {sum(same)} of {len(same)} "
          f"parameter and state tensors bit-equal, losses equal {resumed.losses == straight.losses[2:]}")
    if not ok:
        raise AssertionError("a resumed run is not bit-equal to the straight one")
    del straight, resumed
    release()
    print(f"  phase 15 {time.perf_counter() - t0:.1f} s")


TRAIN_FULL = (4, 512, 8)     # phase 16's batch, tokens and steps


def phase_train_full(seed, smi):
    """[16] ``repro_torch.launch.train.main`` at gemma2-2b's full width."""
    b, s, n_steps = TRAIN_FULL
    args = ["--arch", "gemma2-2b", "--full", "--steps", str(n_steps), "--batch", str(b),
            "--seq", str(s), "--seed", str(seed)]
    print(f"[16] training at full width: python -m repro_torch.launch.train "
          f"{' '.join(args)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        run = train.main(args)
    except SystemExit as e:
        raise AssertionError(f"full-width training: {e}") from e
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(run.losses).all() and np.isfinite(run.grad_norms).all()):
        raise AssertionError("full-width training: a loss or grad norm is not finite")
    cfg = run.model.cfg
    fb, up = run.fwd_bwd_ms[1:], run.update_ms[1:]
    step = statistics.median([x + y for x, y in zip(fb, up)])
    tokens = b * s
    n_active = count_active_params(run.model)
    share = 6 * n_active * tokens / (step / 1e3 * BF16_FLOPS)
    # attention scores and values as computed (full [S, S] blocks),
    # forward, backward (2x) and the remat recompute of the forward
    attn = 4 * 4 * b * s * s * cfg.n_heads * cfg.head_dim * cfg.n_layers
    state_gb = sum(t.nbytes for _, t in tree_leaves_with_path(run.opt_state)
                   if isinstance(t, torch.Tensor)) / 1e9
    param_gb = sum(p.nbytes for p in run.model.parameters()) / 1e9
    batch = train.to_device(SyntheticLM(cfg.vocab, s, seed=seed).batch(n_steps, b), DEV)
    with count_ops() as counted:        # [28b] one step counted on the card
        run.step_fn(run.opt_state, batch)
    torch.cuda.synchronize()
    COUNTED["train"] = (counted, step)
    busy = profile_program("one full-width train step",
                           lambda: run.step_fn(run.opt_state, batch), step)
    masters = "fp32 masters and " if "master" in run.opt_state else ""
    print(f"  {cfg.n_layers} layers, {cfg.dtype} weights ({param_gb:.3f} GB), {masters}"
          f"{cfg.opt_state_dtype} moments ({state_gb:.3f} GB), remat "
          f"{cfg.remat}, grad_accum {cfg.grad_accum}; losses "
          f"{[round(x, 4) for x in run.losses]}, grad norms "
          f"{[round(x, 3) for x in run.grad_norms]} (finite); the driver's rule passed")
    print(f"  step {step:.2f} ms (CUDA events, median of steps 2-{n_steps}; min "
          f"{min(x + y for x, y in zip(fb, up)):.2f}, max {max(x + y for x, y in zip(fb, up)):.2f}"
          f"): forward + backward {statistics.median(fb):.2f} ms, AdamW update "
          f"{statistics.median(up):.2f} ms; {tokens / (step / 1e3):.0f} tokens/s; "
          f"6 N T / (step x 989 TFLOP/s) = {100 * share:.2f}% of the bf16 peak (N "
          f"{n_active} active parameters, T {tokens} tokens; attention "
          f"{attn / 1e12:.2f} TFLOP a step beside 6 N T = {6 * n_active * tokens / 1e12:.2f}); "
          f"peak memory {peak / 1e9:.3f} GB; busy {100 * busy / step:.1f}% of a step; "
          f"first step {run.fwd_bwd_ms[0] + run.update_ms[0]:.1f} ms; wall {wall:.1f} s "
          f"[{smi}]")
    del run, batch
    free()


EXAMPLE_STEPS = 150          # of the example's 300 (cut for the time limit: ~22 s)


def phase_example_train(cleanup=free):
    """[17] the port's training example on the card at its defaults but
    ``EXAMPLE_STEPS`` steps (its seconds are a wall; the script runs it
    inside phase 9's wait, beside the 9e / 9h children, so ``cleanup`` is
    ``release`` there)."""
    t0 = time.perf_counter()
    out = train_lm.main(["--steps", str(EXAMPLE_STEPS)])
    print(f"[17] repro_torch.examples.train_lm: loss {out['first']:.3f} -> "
          f"{out['last']:.3f} (drop > 0.5 asserted; floor {out['floor']:.3f}), "
          f"{time.perf_counter() - t0:.1f} s")
    cleanup()


# the MoE LMs (phases 19-20) -------------------------------------------------------
MOE_LM_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
MOE_LM_TOPO = (2, 2)         # phase 19's island: 2 pods of 2 chips
MOE_LM_SERVE = dict(batch=4, prompt=32, gen=32, max_seq=128)
MOE_LM_PREFILL = (4, 512)    # one 512-token sequence a pod of MOE_TOPO


def island_drops(stats):
    """Copies the island dropped over its calls, by stage."""
    out = {}
    for st in stats:
        for k, v in st["dropped"].items():
            out[k] = out.get(k, 0) + v
    return out


def island_held(arch, seed):
    """The LM on ``Topology(*MOE_LM_TOPO)`` with the f32 wire against its
    local path: prefill logits within 1e-4 of max |logits|, for flat and
    nap, the capacity factor doubled until no copy drops."""
    base = get_reduced(arch).replace(wire_dtype="f32")
    toks = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        0, base.vocab, (4, 64))).to(DEV)
    local = build_model(base).init(seed)
    want, _ = local.prefill(toks)
    scale = float(want.abs().max())
    for mode in ("flat", "nap"):
        cf = base.capacity_factor
        while True:
            cfg = base.replace(moe_dispatch=mode, capacity_factor=cf)
            island = build_model(cfg, mesh=Topology(*MOE_LM_TOPO))
            island.load(local.param_tree())
            island.moe_stats = []
            got, _ = island.prefill(toks)
            drops = island_drops(island.moe_stats)
            if not any(drops.values()) or cf >= 64:
                break
            cf *= 2
        err = float((got - want).abs().max())
        print(f"  island {arch} {mode} on Topology{MOE_LM_TOPO}, f32 wire, capacity "
              f"factor {cf}: prefill logits max_abs_err {err:.3e} (limit 1e-4 x max "
              f"|logits| {scale:.3f}); dropped {drops}; modes "
              f"{sorted({st['mode'] for st in island.moe_stats})}")
        if any(drops.values()) or not err <= 1e-4 * scale:
            raise AssertionError(f"{arch} {mode}: the island LM disagrees with the "
                                 f"local path")
        del island
    del local
    free()


def phase_moe_lm_held(seed):
    """[19] the MoE LMs held on the card: reduced configs in float32."""
    print("[19] the MoE LMs held on the card (reduced configs, float32)")
    step_check("  [19a]", get_reduced(MOE_LM_ARCHS[0]), seed)
    for arch in MOE_LM_ARCHS:
        prefill_check("  [19b]", get_reduced(arch), seed)
    for arch in MOE_LM_ARCHS:
        island_held(arch, seed)


def cache_bytes_per_token(cfg):
    """KV-cache bytes a token and layer in the model's dtype: MLA's latent
    and rope key, or GQA's k and v."""
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    if cfg.mla_kv_lora:
        return (cfg.mla_kv_lora + cfg.mla_rope_dim) * item
    return 2 * cfg.n_kv_heads * cfg.head_dim * item


def prefill_timed(label, model, toks):
    """One ``LM.prefill`` with its peak and the island's drops, then its
    device ms (CUDA events, median of 3)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.moe_stats = [] if model.mesh is not None else None
    logits, cache = model.prefill(toks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    drops = island_drops(model.moe_stats) if model.moe_stats is not None else None
    modes = sorted({st["mode"] for st in model.moe_stats or []})
    model.moe_stats = None
    del cache
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: non-finite logits")
    ms = time_ms(lambda: model.prefill(toks), reps=3, warmup=1)
    print(f"  prefill {label}: {ms:.4f} ms (CUDA events, median of 3); peak memory "
          f"{peak / 1e9:.3f} GB" + (f"; island {modes}, dropped copies {drops}"
                                    if drops is not None else "") + "; logits finite")
    return logits


def moe_lm_full(arch, n_layers, seed, smi):
    """One MoE LM at full width, cut to ``n_layers``: ``serve.generate``,
    the decode kernel on the served cache (GQA), ``LM.prefill`` through
    the local path and through the island on ``Topology(*MOE_TOPO)``."""
    t0 = time.perf_counter()
    cfg = get_config(arch).replace(n_layers=n_layers)
    sv = MOE_LM_SERVE
    batch, prompt_len, gen_len, max_seq = sv["batch"], sv["prompt"], sv["gen"], sv["max_seq"]
    model = build_model(cfg).init(seed)
    torch.cuda.synchronize()
    param_bytes = sum(p.nbytes for p in model.parameters())
    n_moe = cfg.n_layers - cfg.first_dense_layers
    print(f"[20] {arch} at full width: d {cfg.d_model}, {cfg.n_experts} experts top-"
          f"{cfg.top_k}, moe_dff {cfg.moe_dff}, shared {cfg.n_shared_experts}, "
          f"{'MLA r_kv ' + str(cfg.mla_kv_lora) if cfg.mla_kv_lora else 'GQA Hkv ' + str(cfg.n_kv_heads)}"
          f", {cfg.n_layers} layers ({cfg.first_dense_layers} dense + {n_moe} MoE) of "
          f"{get_config(arch).n_layers}, {cfg.dtype}; init from seed {seed} on the card "
          f"{time.perf_counter() - t0:.2f} s, {count_params(model)} parameters, "
          f"{param_bytes / 1e9:.3f} GB")
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, prompt_len))
    res, counts = drive("generate", lambda: generate(model, prompts, gen_len, max_seq))
    steps = prompt_len + gen_len
    n_launch = counts.get("decode_attention_grouped", 0)
    # MLA decodes in plain PyTorch (its scores are r_kv + rope wide, as in
    # the reference); GQA through the kernel, once a layer and step
    want = 0 if cfg.mla_kv_lora else cfg.n_layers * steps
    if n_launch != want:
        raise AssertionError(f"{arch}: decode_attention_grouped launched {n_launch} "
                             f"times, not {want}")
    if not torch.isfinite(res.logits).all():
        raise AssertionError(f"{arch} serve: non-finite logits")
    step = statistics.median(res.step_ms)
    per_token = cache_bytes_per_token(cfg)
    c = prompt_len + gen_len // 2 + 1         # tokens stored at the median step
    cache_bytes = c * batch * per_token * cfg.n_layers
    step_bound = (param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
    tok = res.tokens[:, -1:]
    cache = res.cache
    busy = profile_program(f"{arch}: 4 greedy decode steps",
                           lambda: [model.decode_step(cache, tok) for _ in range(4)],
                           4 * step)
    gqa_bytes = 2 * cfg.n_heads * cfg.head_dim * 2 if cfg.mla_kv_lora else per_token
    print(f"  kernel launches {n_launch} (= {want}); prompt {res.prefill_ms:.1f} ms "
          f"({res.prefill_ms / prompt_len:.3f} ms/step); greedy step median {step:.4f} "
          f"ms (min {min(res.step_ms):.4f}, max {max(res.step_ms):.4f}), "
          f"{batch * 1e3 / step:.1f} tok/s; step bound {step_bound:.4f} ms (params "
          f"{param_bytes / 1e9:.3f} GB + cache rows {cache_bytes / 1e6:.2f} MB at 3.35 "
          f"TB/s), {100 * step_bound / step:.2f}% of it; busy {100 * busy / (4 * step):.1f}% "
          f"of 4 steps; cache {per_token} bytes a token and layer"
          + (f" (an equivalent GQA cache, {cfg.n_heads} heads of k and v: {gqa_bytes})"
             if cfg.mla_kv_lora else "")
          + f"; logits finite; greedy ids [batch 0] {res.tokens[0, :8].tolist()}... [{smi}]")
    entry = None
    if not cfg.mla_kv_lora:
        # the kernel against its plain version on the served cache, read in
        # place, its lengths after the last step, a query from the seed
        g = cfg.n_heads // cfg.n_kv_heads
        q = torch.randn((batch, cfg.n_kv_heads, g, cfg.head_dim), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(seed)
                        ).to(cache["layers"]["k"].dtype)
        entry = attn_case(f"served cache, layer 0, g {g}", q,
                          cache["layers"]["k"][0].transpose(1, 2),
                          cache["layers"]["v"][0].transpose(1, 2), cache["length"], 0,
                          cfg.attn_softcap, cfg.head_dim ** -0.5)
        entry = kernel_entry(arch, entry, n_launch)
    del res, cache
    if not cfg.mla_kv_lora:
        # the same heads at decode_32k's lengths
        decode_32k_case(arch, seed)
    free()
    toks = torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab, MOE_LM_PREFILL)).to(DEV)
    local = prefill_timed(f"{list(MOE_LM_PREFILL)} local (dense-masked oracle, chunks of "
                          f"{MOE_CHUNK} tokens)", model, toks)
    # the same weights with the MoE blocks on the island, the config's own
    # dispatch and wire (the batch splits as one sequence a pod)
    model.mesh = Topology(*MOE_TOPO)
    island = prefill_timed(f"{list(MOE_LM_PREFILL)} island Topology{MOE_TOPO} "
                           f"{cfg.moe_dispatch} / {cfg.wire_dtype} wire, capacity factor "
                           f"{cfg.capacity_factor}", model, toks)
    model.mesh = None
    diff = float((island - local).abs().max())
    same = bool((island.argmax(-1) == local.argmax(-1)).all())
    print(f"  island vs local prefill: last logits max_abs_err {diff:.3e} (max |logits| "
          f"{float(local.abs().max()):.3f}; recorded), greedy ids agree: {same}; "
          f"phase 20 {arch} {time.perf_counter() - t0:.1f} s")
    del model, local, island, toks
    free()
    return entry


def phase_moe_lm_full(n_layers, seed, smi):
    """[20] the MoE LMs at full width, one after the other; the kernels
    line's entry of the decode kernel at qwen3-moe's shapes."""
    entries = [moe_lm_full(arch, n_layers, seed, smi) for arch in MOE_LM_ARCHS]
    return [e for e in entries if e is not None]


# training the MoE LMs through the island (phases 22-23) --------------------------
MOE_TRAIN_HELD = dict(batch=4, seq=64, steps=3, lr=1e-3)
# phase 23's depth: qwen3-moe one MoE layer, deepseek-v2 its dense first
# layer and one MoE layer
MOE_TRAIN_LAYERS = {"qwen3-moe-235b-a22b": 1, "deepseek-v2-236b": 2}
MOE_TRAIN_FULL = dict(batch=4, seq=512, steps=4, lr=3e-4)
# island against local gradients in bf16, of each leaf's max |grad|: each
# path rounds a gradient element after bf16 GEMMs whose inputs were
# rounded in up to three earlier bf16 steps (activation, gated product,
# down projection) forward and as many backward; 8 roundings of half a
# bf16 ulp (2^-9) each
MOE_GRAD_GATE = 8 * 2.0 ** -9


def leaf_grads(model, batch):
    """The loss and each weight's gradient of it, by path (None where a
    weight gets none)."""
    leaves = list(tree_leaves_with_path(model.param_tree()))
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, [t for _, t in leaves], allow_unused=True)
    return loss.detach(), {path: g for (path, _), g in zip(leaves, grads)}


def grad_errors(got, want, floor=0.0):
    """Each leaf's max |got - want| over its max |want|, by path, with
    differences below ``floor`` counted as 0; raises where a leaf of
    ``got`` has no gradient."""
    missing = [p for p, g in got.items() if g is None]
    if missing:
        raise AssertionError(f"{len(missing)} leaves get no gradient on the island: "
                             f"{missing[:4]}")
    out = {}
    for path, w in want.items():
        d = (got[path].float() - w.float()).abs()
        if floor:
            d = torch.where(d < floor, torch.zeros_like(d), d)
        out[path] = float(d.max() / w.float().abs().max().clamp_min(1e-30))
    return out


def worst_leaf(errs):
    path = max(errs, key=errs.get)
    return f"{'.'.join(map(str, path))} {errs[path]:.3e}"


def moe_train_held(arch, seed):
    """One reduced MoE LM in float32 on ``Topology(*MOE_LM_TOPO)``, f32
    wire, capacity factor 4: island against local grads on the card per
    mode (no copy dropped), 3 train steps on the card against the same
    on the CPU (flat with float32 moments, nap with int8), and a bf16-wire
    island that raises under grad."""
    h = MOE_TRAIN_HELD
    base = get_reduced(arch).replace(wire_dtype="f32", capacity_factor=4.0)
    ds = SyntheticLM(base.vocab, h["seq"], seed=seed)
    batches = [ds.batch(i, h["batch"]) for i in range(h["steps"])]
    start = build_model(base, device="cpu").init(seed).param_tree()
    topo = Topology(*MOE_LM_TOPO)
    moved = h["lr"] * h["steps"]
    for mode, dtype in (("flat", "float32"), ("nap", "int8")):
        cfg = base.replace(moe_dispatch=mode, opt_state_dtype=dtype)
        batch = train.to_device(batches[0], DEV)
        with deterministic(warn_only=True):
            local = build_model(cfg).load(start)
            island = build_model(cfg, mesh=topo).load(start)
            island.moe_stats = []
            want_loss, want = leaf_grads(local, batch)
            got_loss, got = leaf_grads(island, batch)
            errs = grad_errors(got, want)
            drops = island_drops(island.moe_stats)
            del local, want, got
            opt = AdamWConfig(lr=h["lr"], warmup_steps=1, total_steps=h["steps"],
                              state_dtype=dtype)
            card = build_model(cfg, mesh=topo).load(start)
            t0 = time.perf_counter()
            card_losses, _, _ = run_steps(card, opt, batches)
            t_card = time.perf_counter() - t0
        host = build_model(cfg, device="cpu", mesh=topo).load(start)
        t0 = time.perf_counter()
        host_losses, _, _ = run_steps(host, opt, batches)
        t_host = time.perf_counter() - t0
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, host_losses))
        worst, share = held_close(f"{arch} {mode} card vs CPU", card.param_tree(),
                                  host.param_tree(), moved)
        print(f"  [22] {arch} {mode}: island vs local on the card: loss "
              f"{float(got_loss):.6f} vs {float(want_loss):.6f}, {len(errs)} leaves, "
              f"worst {worst_leaf(errs)} of its max |grad| (limit 1e-5); dropped "
              f"{drops}; {h['steps']} steps ({dtype} moments) card vs CPU: losses "
              f"{[round(x, 5) for x in card_losses]} max rel diff {rel:.3e} (rtol "
              f"1e-4), parameters max |diff| {worst:.3e} (limit {2 * moved:.1e}), "
              f"{100 * share:.4f}% beyond 1e-6 of max |p|; card {t_card:.1f} s, "
              f"CPU {t_host:.1f} s")
        if max(errs.values()) > 1e-5 or any(drops.values()):
            raise AssertionError(f"{arch} {mode}: island grads disagree with the "
                                 f"local LM's, or a copy dropped")
        if not rel <= 1e-4:
            raise AssertionError(f"{arch} {mode}: card vs CPU losses differ by {rel:.3e}")
        del island, card, host
    narrow = build_model(base.replace(wire_dtype="bf16"), mesh=topo).load(start)
    try:
        narrow.loss(train.to_device(batches[0], DEV))
    except ValueError as e:
        print(f"  [22] {arch} bf16 wire under grad raises: {e}")
    else:
        raise AssertionError(f"{arch}: a bf16-wire island trained under grad")
    del narrow, start
    free()


def phase_moe_train_held(seed):
    """[22] training the MoE LMs through the island, held on the card."""
    print(f"[22] MoE training held on the card: reduced configs, float32, "
          f"Topology{MOE_LM_TOPO}, f32 wire, capacity factor 4, deterministic mode; "
          f"{MOE_TRAIN_HELD['steps']} steps of {MOE_TRAIN_HELD['batch']} x "
          f"{MOE_TRAIN_HELD['seq']} bigram tokens, lr {MOE_TRAIN_HELD['lr']}")
    for arch in MOE_LM_ARCHS:
        moe_train_held(arch, seed)


def island_bytes(counted):
    """(forward, backward) inter-pod bytes of the counted labels (the
    backward's end in ``:grad``)."""
    fwd = sum(v for k, v in counted.items() if k.count(":") == 1)
    bwd = sum(v for k, v in counted.items() if k.endswith(":grad"))
    return fwd, bwd


def moe_train_full(arch, seed, smi):
    """One MoE LM at full width, cut to ``MOE_TRAIN_LAYERS[arch]`` layers,
    on the island ``Topology(*MOE_TOPO)`` with the config's dispatch, the
    f32 wire and capacity factor 1.25: a gradient check against the local
    oracle on the same weights, then ``MOE_TRAIN_FULL['steps']`` steps."""
    t0 = time.perf_counter()
    f = MOE_TRAIN_FULL
    full = get_config(arch)
    cfg = full.replace(n_layers=MOE_TRAIN_LAYERS[arch], grad_accum=1, wire_dtype="f32",
                       capacity_factor=1.25)
    model = build_model(cfg, mesh=Topology(*MOE_TOPO)).init(seed)
    n_params, n_active = count_params(model), count_active_params(model)
    ds = SyntheticLM(cfg.vocab, f["seq"], seed=seed)
    batches = [train.to_device(ds.batch(i, f["batch"]), DEV) for i in range(f["steps"] + 1)]
    print(f"[23] {arch} training at full width: {cfg.n_layers} layers "
          f"({cfg.first_dense_layers} dense) of {full.n_layers}, {cfg.dtype} weights from "
          f"the seed, {n_params} parameters ({n_active} active), island Topology"
          f"{MOE_TOPO} {cfg.moe_dispatch}, f32 wire (the config's {full.wire_dtype}), "
          f"remat {cfg.remat}; {f['batch']} x {f['seq']} bigram tokens")
    # the gradient check, before any optimizer state: the capacity factor
    # doubled from 1.25 until the island drops nothing
    cf = cfg.capacity_factor
    while True:
        model.cfg = cfg.replace(capacity_factor=cf)
        model.moe_stats = []
        with torch.no_grad():
            model.hidden(batches[0]["tokens"])
        drops = island_drops(model.moe_stats)
        if not any(drops.values()) or cf >= 64:
            break
        cf *= 2
    model.moe_stats = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, got = leaf_grads(model, batches[0])
    torch.cuda.synchronize()
    t_island = time.perf_counter() - t1
    check_drops = island_drops(model.moe_stats)
    model.mesh, model.moe_stats = None, None
    t1 = time.perf_counter()
    _, want = leaf_grads(model, batches[0])
    torch.cuda.synchronize()
    t_local = time.perf_counter() - t1
    errs = grad_errors(got, want)
    del got, want
    print(f"  gradient check at capacity factor {cf} (dropped {check_drops}): island "
          f"vs local oracle, {len(errs)} leaves, worst {worst_leaf(errs)} of its max "
          f"|grad|, median {statistics.median(errs.values()):.3e} (limit "
          f"{MOE_GRAD_GATE:.3e}, bf16 rounding); island {t_island:.1f} s, local "
          f"{t_local:.1f} s (walls, first calls) [{smi}]")
    print("  each leaf's max |island - local| / max |local grad|: " + ", ".join(
        f"{'.'.join(map(str, path))} {err:.2e}" for path, err in errs.items()))
    if any(check_drops.values()) or max(errs.values()) > MOE_GRAD_GATE:
        raise AssertionError(f"{arch}: island grads disagree with the local oracle's")
    free()
    # the training steps at the config's capacity factor
    model.mesh, model.cfg = Topology(*MOE_TOPO), cfg
    model.moe_stats = []
    reset_inter_node_bytes()
    with torch.no_grad():
        model.hidden(batches[0]["tokens"])
    fwd_bytes, _ = island_bytes(inter_node_bytes())
    opt_cfg = AdamWConfig(lr=f["lr"], total_steps=f["steps"], warmup_steps=1,
                          state_dtype=cfg.opt_state_dtype, master_fp32=cfg.opt_master_fp32)
    opt_state = adamw_init(model.param_tree(), opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, fb, up, drops, bwd_bytes = [], [], [], [], {}, 0
    for i in range(f["steps"]):
        model.moe_stats = []
        reset_inter_node_bytes()
        clock = Clock(DEV)
        clock.mark()
        loss, grads = step_fn.loss_and_grad(batches[i])
        clock.mark()
        gnorm = step_fn.update(grads, opt_state)
        clock.mark()
        del grads
        a, b = clock.intervals_ms()
        fb.append(a)
        up.append(b)
        losses.append(float(loss))
        norms.append(float(gnorm))
        bwd_bytes = island_bytes(inter_node_bytes())[1]
        for k, v in island_drops(model.moe_stats).items():
            drops[k] = drops.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{arch}: a loss or grad norm is not finite")
    steps = [x + y for x, y in zip(fb, up)]
    step = statistics.median(steps[1:])
    tokens = f["batch"] * f["seq"]
    share = 6 * n_active * tokens / (step / 1e3 * BF16_FLOPS)
    model.moe_stats = None
    busy = profile_program(f"one {arch} train step",
                           lambda: step_fn(opt_state, batches[-1]), step)
    state_gb = sum(t.nbytes for _, t in tree_leaves_with_path(opt_state)
                   if isinstance(t, torch.Tensor)) / 1e9
    param_gb = sum(p.nbytes for p in model.parameters()) / 1e9
    print(f"  {cfg.dtype} weights {param_gb:.3f} GB, fp32 masters and "
          f"{cfg.opt_state_dtype} moments {state_gb:.3f} GB, capacity factor "
          f"{cfg.capacity_factor}, grad_accum 1; losses {[round(x, 4) for x in losses]}, "
          f"grad norms {[round(x, 3) for x in norms]} (finite) [{smi}]")
    print(f"  step {step:.2f} ms (CUDA events, median of steps 2-{f['steps']}; min "
          f"{min(steps[1:]):.2f}, max {max(steps[1:]):.2f}): forward + backward "
          f"{statistics.median(fb[1:]):.2f} ms, AdamW update "
          f"{statistics.median(up[1:]):.2f} ms; {tokens / (step / 1e3):.0f} tokens/s; "
          f"6 N T / (step x 989 TFLOP/s) = {100 * share:.2f}% of the bf16 peak (N "
          f"{n_active} active, T {tokens}: {6 * n_active * tokens / 1e12:.2f} TFLOP); "
          f"peak memory {peak / 1e9:.3f} GB; busy {100 * busy / step:.1f}% of a step; "
          f"dropped copies over {f['steps']} steps {drops}; counted inter-pod bytes: "
          f"forward {fwd_bytes} (one pass; remat recomputes it in the backward), "
          f"backward {bwd_bytes}; first step {steps[0]:.1f} ms; phase 23 {arch} "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del model, opt_state, step_fn, batches
    free()


def phase_moe_train_full(seed, smi):
    """[23] training the MoE LMs through the island at full width, one
    after the other."""
    for arch in MOE_LM_ARCHS:
        moe_train_full(arch, seed, smi)


# serving the last three families (phases 24-25) -------------------------------
LATE_ARCHS = ("whisper-small", "zamba2-2.7b", "rwkv6-3b")
LATE_HELD_STEPS = 8
LATE_SERVE = dict(batch=4, prompt=32, gen=32, max_seq=128)
# prefill shapes: whisper's decoder holds 448 tokens (its text context)
# over 1500 frames; the others take phase 14's 4 x 512
LATE_PREFILL = {"whisper-small": (4, 448), "zamba2-2.7b": (4, 512), "rwkv6-3b": (4, 512)}


def late_frames(cfg, batch, seed, device):
    """whisper's stubbed frontend output, frame embeddings [B,
    encoder_seq, d] float32 drawn from the seed on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=device)


def late_launches(cfg, steps):
    """The decode kernel's launches over ``steps`` decode steps: whisper
    two a layer (its self-attention and its cross-attention), zamba2 one
    a shared-block application, rwkv6 none (it has no attention)."""
    if cfg.is_encoder_decoder:
        return 2 * cfg.n_layers * steps
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every * steps
    return 0


def prefill_args(toks, frames):
    """``prefill``'s arguments: whisper's take the frames too."""
    return (toks,) if frames is None else (toks, frames)


def late_decode(model, toks, frames, n_steps, max_seq):
    """``n_steps`` teacher-forced decode steps of ``toks`` (whisper's
    cross caches filled from ``frames`` first): the logits, stacked."""
    cache = model.init_cache(toks.shape[0], max_seq)
    if frames is not None:
        cache.update(model.cross_cache(frames))
    out = []
    for t in range(n_steps):
        logits, cache = model.decode_step(cache, toks[:, t:t + 1])
        out.append(logits)
    return torch.stack(out)


def late_held(arch, seed):
    """One reduced config in float32 on the card and on the CPU with the
    same weights: prefill logits and ``LATE_HELD_STEPS`` teacher-forced
    decode steps within rtol 1e-4 / atol 1e-4, the card's decode through
    the kernel (its launches counted), the CPU's through the plain
    version."""
    cfg = get_reduced(arch)
    card = build_model(cfg).init(seed)
    host = build_model(cfg, device="cpu").load(card.param_tree())
    batch, s = 4, 32
    toks = torch.from_numpy(np.random.default_rng(seed + 6).integers(0, cfg.vocab,
                                                                     (batch, s)))
    frames = late_frames(cfg, batch, seed, "cpu") if cfg.is_encoder_decoder else None
    toks_d, frames_d = toks.to(DEV), None if frames is None else frames.to(DEV)
    got, _ = card.prefill(*prefill_args(toks_d, frames_d))
    want, _ = host.prefill(*prefill_args(toks, frames))
    reset_launches()
    steps = late_decode(card, toks_d, frames_d, LATE_HELD_STEPS, 16)
    torch.cuda.synchronize()
    n_launch = launches["decode_attention_grouped"]
    ref = late_decode(host, toks, frames, LATE_HELD_STEPS, 16)
    over = dict(prefill=within(got.cpu(), want, 1e-4, 1e-4),
                decode=within(steps.cpu(), ref, 1e-4, 1e-4))
    print(f"  {arch} ({cfg.n_layers} layers, d {cfg.d_model}, float32): card vs CPU, "
          f"prefill logits of [{batch}, {s}] and {LATE_HELD_STEPS} teacher-forced decode "
          f"steps: max excess over rtol 1e-4 / atol 1e-4 "
          + ", ".join(f"{k} {v:.3e}" for k, v in over.items())
          + f" (<= 0 passes), max |logit| {float(ref.abs().max()):.3f}; kernel launches "
          f"{n_launch} (= {late_launches(cfg, LATE_HELD_STEPS)})")
    if max(over.values()) > 0 or n_launch != late_launches(cfg, LATE_HELD_STEPS) \
            or not torch.isfinite(steps).all():
        raise AssertionError(f"{arch}: the card disagrees with the CPU")
    del card, host, steps
    free()


def phase_late_held(seed):
    """[24] whisper-small, zamba2-2.7b and rwkv6-3b held on the card."""
    print("[24] the last three families held on the card (reduced configs, float32)")
    for arch in LATE_ARCHS:
        late_held(arch, seed)


def decode_read_bytes(model, cfg, batch, stored):
    """Bytes one decode step must read at ``stored`` cached tokens a
    sequence: the weights it uses (whisper's decoder and tied head, not
    its encoder or the cross k / v projections, whose output is cached),
    the attention rows (whisper: self and cross, every layer; zamba2: one
    cache a shared-block application), and the recurrent states read and
    written (float32)."""
    weights = sum(p.nbytes for name, p in model.named_parameters()
                  if not name.startswith("enc_")
                  and not name.endswith(("xattn.wk", "xattn.wv")))
    row = 2 * cfg.n_kv_heads * cfg.head_dim * 2 if cfg.family != "ssm" else 0
    if cfg.is_encoder_decoder:
        rows, state = cfg.n_layers * (stored + cfg.encoder_seq), 0
    elif cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        rows = cfg.n_layers // cfg.shared_attn_every * stored
        state = cfg.n_layers * (d_in * cfg.ssm_state * 4 + (cfg.ssm_conv - 1) * d_in * 2)
    else:
        n = cfg.rwkv_head_size
        rows, state = 0, cfg.n_layers * (cfg.d_model * n * 4 + 2 * cfg.d_model * 2)
    return weights, rows * batch * row, 2 * state * batch


def prefill_flops(model, cfg, b, s):
    """The matmul FLOPs of a prefill of [b, s] tokens: 2 x the weights
    each token's products use x the tokens (zamba2's shared block once an
    application; whisper's encoder and cross-attention k / v over its b x
    encoder_seq frames), the attention blocks as computed (4 b Sq Skv H dh
    a layer: full blocks), the head at the last position.  Left out:
    Mamba2's chunk products and rwkv6's recurrence (elementwise and small
    products: ~2.3% of the rest at zamba2's widths, ~0.6% at rwkv6's)."""
    size = lambda prefix, ends=("",): sum(  # noqa: E731
        p.numel() for name, p in model.named_parameters()
        if name.startswith(prefix) and name.endswith(ends))
    hd = cfg.n_heads * cfg.head_dim
    flops = 2 * b * cfg.d_model * cfg.vocab
    if cfg.is_encoder_decoder:
        t = cfg.encoder_seq
        kv = size("dec_layers", ("xattn.wk", "xattn.wv"))
        return (flops + 2 * b * t * (size("enc_layers") + kv)
                + 2 * b * s * (size("dec_layers") - kv)
                + 4 * b * hd * (cfg.encoder_layers * t * t + cfg.n_layers * (s * s + s * t)))
    if cfg.family == "hybrid":
        apps = cfg.n_layers // cfg.shared_attn_every
        return (flops + 2 * b * s * (size("mamba_layers") + apps * size("shared"))
                + 4 * b * s * s * hd * apps)
    return flops + 2 * b * s * size("layers")


def late_model(arch, seed):
    """One of the three at full width and depth: the model (bf16 weights
    from the seed on the card), its prompts and whisper's frames."""
    cfg = get_config(arch)
    sv = LATE_SERVE
    model = build_model(cfg).init(seed)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (sv["batch"], sv["prompt"]))
    frames = (late_frames(cfg, sv["batch"], seed, DEV) if cfg.is_encoder_decoder
              else None)
    return model, prompts, frames


def late_generate(model, prompts, frames):
    """``serve.generate`` of the phase's shape: the launch counts reset
    just before it; (result, the decode kernel's launches)."""
    reset_launches()
    res = generate(model, prompts, LATE_SERVE["gen"], LATE_SERVE["max_seq"], frames=frames)
    torch.cuda.synchronize()
    return res, launches["decode_attention_grouped"]


def late_first_runs(seed):
    """[25a] the first of phase 25's two serving runs of each model (run
    inside phase 9 while it waits for phase 15's CPU half: the card is
    shared with the 9e / 9h children, so nothing is timed): the greedy
    tokens, whether the logits are finite, the kernel's launches."""
    out = {}
    for arch in LATE_ARCHS:
        t0 = time.perf_counter()
        model, prompts, frames = late_model(arch, seed)
        res, n_launch = late_generate(model, prompts, frames)
        out[arch] = dict(tokens=res.tokens.cpu(), launches=n_launch,
                         finite=bool(torch.isfinite(res.logits).all()))
        print(f"  [25a] {arch}: first serving run (untimed, beside 9e / 9h's children) "
              f"{time.perf_counter() - t0:.1f} s, kernel launches {n_launch}")
        del model, res, frames
        gc.collect()             # not free(): phase 9's plans stay cached
        torch.cuda.empty_cache()
    return out


def late_prompt(cfg, seed, shape):
    """The timed prefill's prompt: ``shape`` seeded tokens on the card."""
    return torch.from_numpy(np.random.default_rng(seed + 4).integers(
        0, cfg.vocab, shape)).to(DEV)


def late_full(arch, seed, smi, first, keep=None):
    """One of the three at full width and depth, bf16 weights from the
    seed: the timed ``serve.generate`` (finite greedy tokens equal to
    ``first``'s run, both runs' kernel launches as counted), the kernel on
    the served caches, then a timed prefill; ``keep`` (a dict) takes the
    prefill's logits and final states.  Returns the decode kernel's
    launches over the timed generate."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    sv = LATE_SERVE
    batch, prompt_len, gen_len = sv["batch"], sv["prompt"], sv["gen"]
    model, prompts, frames = late_model(arch, seed)
    torch.cuda.synchronize()
    print(f"[25] {arch} at full width: {cfg.family}, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}; init from seed {seed} on the "
          f"card {time.perf_counter() - t0:.2f} s, {count_params(model)} parameters, "
          f"{sum(p.nbytes for p in model.parameters()) / 1e9:.3f} GB")
    torch.cuda.reset_peak_memory_stats()
    res, n_launch = late_generate(model, prompts, frames)
    peak = torch.cuda.max_memory_allocated()
    steps = prompt_len + gen_len
    want = late_launches(cfg, steps)
    if not n_launch == first["launches"] == want:
        raise AssertionError(f"{arch}: decode_attention_grouped launched {n_launch} and "
                             f"{first['launches']} times, not {want}")
    same = bool(torch.equal(res.tokens.cpu(), first["tokens"]))
    if not (torch.isfinite(res.logits).all() and first["finite"] and same):
        raise AssertionError(f"{arch} serve: non-finite logits or greedy tokens that "
                             f"differ between two runs")
    step = statistics.median(res.step_ms)
    weights, rows, state = decode_read_bytes(model, cfg, batch,
                                             prompt_len + gen_len // 2 + 1)
    step_bound = (weights + rows + state) / HBM_BYTES_PER_S * 1e3
    cache, tok = res.cache, res.tokens[:, -1:]
    busy = profile_program(f"{arch}: 4 greedy decode steps",
                           lambda: [model.decode_step(cache, tok) for _ in range(4)],
                           4 * step)
    print(f"  kernel launches {n_launch} (= {want}; phase 9's first run {first['launches']}); prompt "
          f"{res.prefill_ms:.1f} ms ({res.prefill_ms / prompt_len:.3f} ms/step"
          + (", the encoder's cross caches included" if frames is not None else "")
          + f"); greedy step median {step:.4f} ms (min {min(res.step_ms):.4f}, max "
          f"{max(res.step_ms):.4f}), {batch * 1e3 / step:.1f} tok/s; step bound "
          f"{step_bound:.4f} ms (weights read {weights / 1e9:.3f} GB + attention rows "
          f"{rows / 1e6:.2f} MB + states read and written {state / 1e6:.2f} MB at 3.35 "
          f"TB/s), {100 * step_bound / step:.2f}% of it; busy {100 * busy / (4 * step):.1f}% "
          f"of 4 steps; peak memory {peak / 1e9:.3f} GB; logits finite, greedy ids equal "
          f"to phase 9's first run: {same}; [batch 0] {res.tokens[0, :8].tolist()}... "
          f"[{smi}]")
    # the kernel against its plain version on the served caches, read in
    # place at their lengths after the last step, a query from the seed
    served = []
    if cfg.is_encoder_decoder:
        served = [("self-attention", cache["layers"], cache["length"]),
                  ("cross-attention", {"k": cache["xk"], "v": cache["xv"]},
                   torch.full_like(cache["length"], cfg.encoder_seq))]
    elif cfg.family == "hybrid":
        served = [("shared block, first application", cache["shared"], cache["length"])]
    g = cfg.n_heads // cfg.n_kv_heads
    for what, kv, lengths in served:
        q = torch.randn((batch, cfg.n_kv_heads, g, cfg.head_dim), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(seed)
                        ).to(kv["k"].dtype)
        attn_case(f"served {what} cache, layer 0, g {g}", q, kv["k"][0].transpose(1, 2),
                  kv["v"][0].transpose(1, 2), lengths, 0, cfg.attn_softcap,
                  cfg.head_dim ** -0.5, timed=False)
    del res, cache
    free()
    # the prefill: rwkv6 runs the stepwise recurrence its config ships
    # (rwkv_chunk 0), zamba2 the chunked SSD, whisper its encoder first
    shape = LATE_PREFILL[arch]
    toks = late_prompt(cfg, seed, shape)
    args = prefill_args(toks, None if frames is None else
                        late_frames(cfg, shape[0], seed + 1, DEV))
    out = {}

    def run():
        out.clear()                  # the last call's cache freed first
        out["logits"], out["cache"] = model.prefill(*args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # rwkv6's stepwise prefill (3-4.5 s a call) is timed once: the cut that
    # made room for phase 27
    reps = 1 if cfg.family == "ssm" else 3
    ms = time_ms(run, reps=reps, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    logits, cache = out.pop("logits"), out.pop("cache")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch} prefill: non-finite logits")
    if keep is not None:
        keep.update(logits=logits, state=cache["state"], ms=ms)
    del cache
    tokens = shape[0] * shape[1]
    flops = prefill_flops(model, cfg, *shape)
    weights = sum(p.nbytes for p in model.parameters())       # a prefill reads them all
    bound, by = max((weights / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (flops / BF16_FLOPS * 1e3, "operations"))
    print(f"  prefill {list(shape)}"
          + (f" over {shape[0]} x {cfg.encoder_seq} frames" if frames is not None else "")
          + (f" (rwkv_chunk {cfg.rwkv_chunk}: the stepwise recurrence)"
             if cfg.family == "ssm" else "")
          + f": {ms:.4f} ms (CUDA events, median of {reps} call(s), the first included), "
          f"{tokens / (ms / 1e3):.0f} tokens/s; bound {bound:.4f} ms ({by}: "
          f"{flops / 1e12:.3f} TFLOP at 989 TFLOP/s bf16, weights {weights / 1e9:.3f} GB "
          f"at 3.35 TB/s), {100 * bound / ms:.2f}% of it; peak memory {peak / 1e9:.3f} "
          f"GB; logits finite; phase 25 {arch} {time.perf_counter() - t0:.1f} s [{smi}]")
    del model, toks, args, logits
    free()
    return n_launch


def phase_late_full(seed, smi, first, rwkv_prefill):
    """[25] whisper-small, zamba2-2.7b and rwkv6-3b at full width and
    depth, one after the other (``first``: ``late_first_runs``'s
    results): the decode kernel's launches by arch.  ``rwkv_prefill``
    takes rwkv6's stepwise prefill (phase 30 holds the chunked one to it)."""
    return {arch: late_full(arch, seed, smi, first[arch],
                            keep=rwkv_prefill if arch == RWKV_ARCH else None)
            for arch in LATE_ARCHS}


# training the last three families (phases 26-27) -----------------------------
FAMILY_HELD = dict(batch=4, seq=32, steps=3, lr=1e-3)
FAMILY_SSD = (2, 256, 128)   # zamba2's held batch, tokens and its full config's chunk
# phase 27: (batch, tokens, layers); rwkv6 cut to 4 of its 32 layers (its
# stepwise recurrence a token at a time), the others at full depth
FAMILY_FULL = {"whisper-small": (4, 448, 12), "zamba2-2.7b": (4, 512, 54),
               "rwkv6-3b": (4, 512, 4)}
# steps of each (the first is warm-up); rwkv6 cut from 4 to 2 for the time
# limit when phase 29 came (~4.2 s a step), whisper and zamba2 from 4 to 3
# when phase 31 came (~0.9-1.1 s a step)
FAMILY_STEPS = {"whisper-small": 3, "zamba2-2.7b": 3, "rwkv6-3b": 2}
# rwkv6's busy share is read from a step of 4 x 64 tokens: the profiler
# took ~2 min to process a 4 x 512 step's ~100 k kernels (the time limit)
FAMILY_PROFILE_SEQ = {"rwkv6-3b": 64}


def family_batches(cfg, seed, batch, seq, steps):
    """Host batches of the driver's pipeline: bigram tokens and, for
    whisper, ``data.step_frames`` of each step."""
    ds = SyntheticLM(cfg.vocab, seq, seed=seed)
    return [train.step_batch(cfg, ds, i, batch) for i in range(steps)]


def family_held(arch, seed):
    """One reduced config in float32, weights drawn on the CPU: 3
    ``make_train_step`` steps on the card against the same on the CPU for
    float32 and int8 moments (losses rtol 1e-4, parameters as phase 15
    holds them); zamba2 also at its full config's chunk, grads finite and
    card against CPU."""
    h = FAMILY_HELD
    cfg = get_reduced(arch).replace(grad_accum=1)
    batches = family_batches(cfg, seed, h["batch"], h["seq"], h["steps"])
    start = build_model(cfg, device="cpu").init(seed).param_tree()
    moved = h["lr"] * h["steps"]
    for dtype in ("float32", "int8"):
        c = cfg.replace(opt_state_dtype=dtype)
        opt = AdamWConfig(lr=h["lr"], warmup_steps=1, total_steps=h["steps"],
                          state_dtype=dtype)
        card = build_model(c).load(start)
        host = build_model(c, device="cpu").load(start)
        card_losses, _, _ = run_steps(card, opt, batches)
        host_losses, _, _ = run_steps(host, opt, batches)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, host_losses))
        worst, share = held_close(f"{arch} {dtype} card vs CPU", card.param_tree(),
                                  host.param_tree(), moved)
        print(f"  [26] {arch} ({cfg.n_layers} layers, d {cfg.d_model}), {dtype} moments: "
              f"losses {[round(x, 5) for x in card_losses]} max rel diff {rel:.3e} (rtol "
              f"1e-4); parameters max |diff| {worst:.3e} (limit {2 * moved:.1e}), "
              f"{100 * share:.4f}% beyond 1e-6 of max |p|")
        if not rel <= 1e-4:
            raise AssertionError(f"{arch} ({dtype}): card vs CPU losses differ by {rel:.3e}")
        del card, host
    if cfg.family == "hybrid":
        b, s, chunk = FAMILY_SSD
        c = cfg.replace(ssm_chunk=chunk)
        batch = SyntheticLM(c.vocab, s, seed=seed).batch(0, b)
        _, got = leaf_grads(build_model(c).load(start), train.to_device(batch, DEV))
        _, want = leaf_grads(build_model(c, device="cpu").load(start),
                             train.to_device(batch, "cpu"))
        finite = all(bool(torch.isfinite(g).all()) for g in got.values())
        errs = grad_errors({k: g.cpu() for k, g in got.items()}, want)
        print(f"  [26] {arch} at ssm_chunk {chunk}, [{b}, {s}] tokens (the unmasked "
              f"exponent's gradient is NaN here): grads finite {finite}; card vs CPU "
              f"{len(errs)} leaves, worst {worst_leaf(errs)} of its max |grad| (limit 1e-4)")
        if not (finite and max(errs.values()) <= 1e-4):
            raise AssertionError(f"{arch} at chunk {chunk}: grads not finite or card "
                                 f"and CPU disagree")
    del start
    release()


def phase_family_train_held(seed):
    """[26] training whisper-small, zamba2-2.7b and rwkv6-3b held on the
    card (run inside phase 9's wait: it times nothing)."""
    t0 = time.perf_counter()
    h = FAMILY_HELD
    print(f"[26] training the last three families held on the card: reduced configs, "
          f"float32, {h['steps']} steps of {h['batch']} x {h['seq']} bigram tokens "
          f"(whisper over the driver's frames), lr {h['lr']}")
    for arch in LATE_ARCHS:
        family_held(arch, seed)
    print(f"  phase 26 {time.perf_counter() - t0:.1f} s")


def train_flops(model, cfg, b, s):
    """The products' FLOPs of a training step: 3 x a forward's (one
    forward, a backward of two; the remat recompute left out), the
    forward counted as ``prefill_flops`` counts a prefill's but with the
    head over every position."""
    head = 2 * b * cfg.d_model * cfg.vocab
    return 3 * (prefill_flops(model, cfg, b, s) - head + s * head)


def train_timed(label, arch, cfg, seed, smi, b, s, n_steps, profile_seq=None,
                keep=None):
    """``n_steps`` steps of ``make_train_step`` on ``cfg`` (bf16 weights from
    the seed, fp32 masters, the config's moments, remat) over the driver's
    b x s batches: step ms (median of the steps after the first) split
    into forward + backward and the update, tokens/s, the bf16 peak's
    share, peak memory and the busy share of a step traced over
    ``profile_seq`` tokens (all of them by default); finite losses and
    grad norms gated.  ``keep`` (a dict) takes step 1's loss and a copy of
    its gradient by path, taken before the update."""
    t0 = time.perf_counter()
    full = get_config(arch)
    model = build_model(cfg).init(seed)
    n_params = count_params(model)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=n_steps, warmup_steps=1,
                          state_dtype=cfg.opt_state_dtype, master_fp32=cfg.opt_master_fp32)
    opt_state = adamw_init(model.param_tree(), opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    batches = [train.to_device(x, DEV) for x in family_batches(cfg, seed, b, s, n_steps + 1)]
    print(f"[{label}] {arch} training at full width: {cfg.n_layers} of {full.n_layers} "
          f"layers, {cfg.dtype} weights from the seed, {n_params} parameters, remat "
          f"{cfg.remat}" + (f", rwkv_chunk {cfg.rwkv_chunk}" if cfg.family == "ssm" else "")
          + f"; {b} x {s} bigram tokens" + (f" over {b} x {cfg.encoder_seq} frames"
                                            if cfg.is_encoder_decoder else ""))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, fb, up = [], [], [], []
    for i in range(n_steps):
        clock = Clock(DEV)
        clock.mark()
        loss, grads = step_fn.loss_and_grad(batches[i])
        clock.mark()
        if keep is not None and i == 0:
            keep.update(loss=float(loss), grads={path: g.detach().clone() for path, g
                                                 in tree_leaves_with_path(grads)})
        gnorm = step_fn.update(grads, opt_state)
        clock.mark()
        del grads
        x, y = clock.intervals_ms()
        fb.append(x)
        up.append(y)
        losses.append(float(loss))
        norms.append(float(gnorm))
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{arch}: a loss or grad norm is not finite: {losses}, {norms}")
    steps = [x + y for x, y in zip(fb, up)]
    step = statistics.median(steps[1:])
    tokens = b * s
    share = 6 * n_params * tokens / (step / 1e3 * BF16_FLOPS)
    flops = train_flops(model, cfg, b, s)
    ps = profile_seq or s
    prof_batch = {k: v[:, :ps] if k != "frames" else v for k, v in batches[-1].items()}
    prof_ms = step if ps == s else time_ms(lambda: step_fn(opt_state, prof_batch), reps=1,
                                           warmup=0)
    busy = profile_program(f"one {arch} train step of {b} x {ps} tokens",
                           lambda: step_fn(opt_state, prof_batch), prof_ms, host_ops=False)
    state_gb = sum(t.nbytes for _, t in tree_leaves_with_path(opt_state)
                   if isinstance(t, torch.Tensor)) / 1e9
    param_gb = sum(p.nbytes for p in model.parameters()) / 1e9
    print(f"  {cfg.dtype} weights {param_gb:.3f} GB, fp32 masters and "
          f"{cfg.opt_state_dtype} moments {state_gb:.3f} GB; losses "
          f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]} "
          f"(finite)")
    print(f"  step {step:.2f} ms (CUDA events, median of steps 2-{n_steps}; min "
          f"{min(steps[1:]):.2f}, max {max(steps[1:]):.2f}): forward + backward "
          f"{statistics.median(fb[1:]):.2f} ms, AdamW update {statistics.median(up[1:]):.2f} "
          f"ms; {tokens / (step / 1e3):.0f} tokens/s; 6 N T / (step x 989 TFLOP/s) = "
          f"{100 * share:.2f}% of the bf16 peak (N {n_params}, T {tokens}); the products' "
          f"FLOPs x 3 {flops / 1e12:.3f} TFLOP: {100 * flops / (step / 1e3 * BF16_FLOPS):.2f}% "
          f"of it; peak memory {peak / 1e9:.3f} GB; busy {100 * busy / prof_ms:.1f}% of a step"
          + (f" of {b} x {ps} tokens ({prof_ms:.2f} ms)" if ps != s else "")
          + f"; first step {steps[0]:.1f} ms; phase {label} {arch} "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del model, opt_state, step_fn, batches
    free()


def family_full(arch, seed, smi, keep=None):
    """One of the three at full width (rwkv6 cut to 4 layers), bf16
    weights from the seed, fp32 masters, the config's moments, remat,
    grad_accum 1: ``FAMILY_STEPS[arch]`` steps of the driver's batches
    (``train_timed``; ``keep`` takes step 1's gradient)."""
    b, s, layers = FAMILY_FULL[arch]
    cfg = get_config(arch).replace(grad_accum=1, n_layers=layers)
    train_timed("27", arch, cfg, seed, smi, b, s, FAMILY_STEPS[arch],
                profile_seq=FAMILY_PROFILE_SEQ.get(arch), keep=keep)


def phase_family_train_full(seed, smi):
    """[27] training whisper-small, zamba2-2.7b and rwkv6-3b at full
    width, one model at a time; returns rwkv6's step-1 loss and gradient
    (its stepwise recurrence), which phase 30 holds the chunked form to."""
    rwkv_step1 = {}
    for arch in LATE_ARCHS:
        family_full(arch, seed, smi, keep=rwkv_step1 if arch == RWKV_ARCH else None)
    return rwkv_step1


# ---------------------------------------------------------------------------
# 30. rwkv6-3b's chunked WKV on the card
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-3b"
RWKV_CHUNK = 64              # the dry run's form (launch/dryrun.py): 512 / 64 = 8 chunks
# 30a: the reduced config in float32 with every w0 at 4.7, where exp(w0) ~ 110
# puts every decay exp(-exp(w0 + LoRA)) below float32's normal range (most
# at 0), where the log of the decay would be -inf; steps of 4 x 32 bigram
# tokens at chunk 8
RWKV_HELD = dict(batch=4, seq=32, steps=3, lr=1e-3, chunk=8, w0=4.7)
# 30a's chunked against stepwise gradient on the card, of each leaf's max
# |grad|: two float32 summation orders of the same products (the gate of
# tests/test_torch_rwkv_chunk.py)
RWKV_HELD_GATE = 1e-5
# gradient differences below float32's smallest normal number are not
# counted: at w0 = 4.7 the decay leaves' gradients are carried by subnormal
# decays alone, which one device may flush to zero and another keep
NORMAL32 = torch.finfo(torch.float32).tiny
# 30b: the chunked prefill against the stepwise one on the same bf16
# weights.  Layer 0's inputs are the same embedding in both forms, so its
# final state S (float32) agrees to float32 summation orders: 1e-5 of its
# max.  Every layer rounds its time mix's output y to bf16, and where the
# two forms' float32 y (equal to ~1e-6) straddle a rounding boundary they
# round one bf16 ulp (2^-8 of |y|) apart; the residual stream carries these
# on, so layer i's inputs differ by up to i such roundings, its S (bilinear
# in them) by 2 i x 2^-8 of its max, and the logits (linear in the last
# hidden state) by n_layers x 2^-8 of max |logit|.  30a holds the two forms
# to each other in float32 at full width.
RWKV_S0_GATE = 1e-5
BF16_ULP = 2.0 ** -8
# 30a at full width (4 of 32 layers, float32): chunked against stepwise
# step-1 gradients, of each leaf's max |grad|: phase 26's card-vs-CPU gate
# (3.9e-6 measured; sums over 2048 tokens and d 2560)
RWKV_F32_GATE = 1e-4
# 30c in bf16: each form's step-1 gradient against the float32 one of the
# same weights (cast up exactly); the chunked form's worst leaf within 2x
# the stepwise form's (both ~2.6e-2 at 4 layers: bf16's own error, which
# the two forms draw apart, so they differ from each other by ~sqrt(2) x it)
RWKV_BF16_RATIO = 2.0
RWKV_TRAIN_STEPS = 2         # 30c at full depth: step 2 timed (3 before phase 31's cut)


def rwkv_held_tree(cfg, seed, w0):
    """The reduced model's weights drawn on the CPU, every layer's ``w0``
    filled."""
    tree = build_model(cfg, device="cpu").init(seed).param_tree()
    with torch.no_grad():
        for layer in tree["layers"]:
            layer["block"]["w0"].fill_(w0)
    return tree


def rwkv_held_steps(model, opt, batches):
    """``make_train_step`` over ``batches``: (losses, grad norms)."""
    state = adamw_init(model.param_tree(), opt)
    step_fn = make_train_step(model, opt)
    out = [step_fn(state, train.to_device(b, model.device)) for b in batches]
    return [float(x) for x, _ in out], [float(n) for _, n in out]


def phase_rwkv_chunk_held(seed):
    """[30a] (run inside phase 9's wait: it times nothing) rwkv6's chunked
    WKV where the decay underflows: the reduced config in float32, every
    ``w0`` at 4.7, weights drawn on the CPU; step 1's gradient at chunk 8
    on the card against the CPU (1e-4 of each leaf's max |grad|) and
    against the stepwise form on the card (``RWKV_HELD_GATE``), every
    gradient finite; then ``RWKV_HELD["steps"]`` steps on both (losses
    rtol 1e-4, finite grad norms, parameters as phase 15 holds them)."""
    t0 = time.perf_counter()
    h = RWKV_HELD
    cfg = get_reduced(RWKV_ARCH).replace(grad_accum=1, rwkv_chunk=h["chunk"])
    start = rwkv_held_tree(cfg, seed, h["w0"])
    batches = family_batches(cfg, seed, h["batch"], h["seq"], h["steps"])
    card = build_model(cfg).load(start)
    host = build_model(cfg, device="cpu").load(start)
    _, g_card = leaf_grads(card, train.to_device(batches[0], DEV))
    _, g_host = leaf_grads(host, train.to_device(batches[0], "cpu"))
    _, g_step = leaf_grads(build_model(cfg.replace(rwkv_chunk=0)).load(start),
                           train.to_device(batches[0], DEV))
    finite = all(g is not None and bool(torch.isfinite(g).all())
                 for grads in (g_card, g_host, g_step) for g in grads.values())
    vs_cpu = grad_errors({k: g.cpu() for k, g in g_card.items()}, g_host, NORMAL32)
    vs_step = grad_errors(g_card, g_step, NORMAL32)
    opt = AdamWConfig(lr=h["lr"], warmup_steps=1, total_steps=h["steps"])
    card_losses, card_norms = rwkv_held_steps(card, opt, batches)
    host_losses, host_norms = rwkv_held_steps(host, opt, batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, host_losses))
    steps_finite = bool(np.isfinite(card_losses + host_losses + card_norms
                                    + host_norms).all())
    moved = h["lr"] * h["steps"]
    worst, share = held_close(f"{RWKV_ARCH} chunked card vs CPU", card.param_tree(),
                              host.param_tree(), moved)
    print(f"[30a] {RWKV_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}), float32, every w0 "
          f"{h['w0']} (every decay below 2^-126, most 0), rwkv_chunk {h['chunk']} over "
          f"{h['batch']} x {h['seq']} bigram tokens (inside phase 9's wait): step-1 grads "
          f"finite (card, CPU, stepwise on the card) {finite}; card vs CPU {len(vs_cpu)} "
          f"leaves, worst {worst_leaf(vs_cpu)} of its max |grad| (limit 1e-4); chunked vs "
          f"stepwise on the card, worst {worst_leaf(vs_step)} (limit {RWKV_HELD_GATE:g}; "
          f"differences under 2^-126 not counted); {h['steps']} steps: losses "
          f"{[round(x, 5) for x in card_losses]} max rel diff {rel:.3e} (rtol 1e-4), grad "
          f"norms {[round(x, 4) for x in card_norms]} finite {steps_finite}; parameters "
          f"max |diff| {worst:.3e} (limit {2 * moved:.1e}), {100 * share:.4f}% beyond 1e-6 "
          f"of max |p|; phase 30a {time.perf_counter() - t0:.1f} s")
    if not (finite and steps_finite and max(vs_cpu.values()) <= 1e-4
            and max(vs_step.values()) <= RWKV_HELD_GATE and rel <= 1e-4):
        raise AssertionError(f"{RWKV_ARCH} chunked in the fault's regime: a gradient "
                             f"or loss is not finite, or a gate failed")
    del card, host, start
    release()
    rwkv_full_f32_held(seed)


def rwkv_cut(seed, dtype, chunk, tree=None):
    """Phase 27's cut of rwkv6-3b (4 of 32 layers, full width) at
    ``chunk`` in ``dtype``: weights from the seed (phase 27's) or ``tree``
    (cast to ``dtype``), and phase 27's first batch on the card."""
    b, s, layers = FAMILY_FULL[RWKV_ARCH]
    cfg = get_config(RWKV_ARCH).replace(grad_accum=1, n_layers=layers, rwkv_chunk=chunk,
                                        dtype=dtype)
    model = build_model(cfg).init(seed) if tree is None else build_model(cfg).load(tree)
    return model, train.to_device(family_batches(cfg, seed, b, s, 1)[0], DEV)


def rwkv_full_f32_held(seed):
    """[30a] at full width: phase 27's cut with its bf16 weights cast up to
    float32 (exactly), phase 27's first batch: step 1's gradient at
    ``RWKV_CHUNK`` against the stepwise form's on the card, every leaf
    finite and within ``RWKV_F32_GATE`` of its max |grad|."""
    t0 = time.perf_counter()
    bf16, _ = rwkv_cut(seed, "bfloat16", 0)
    tree = bf16.param_tree()
    out = {}
    for chunk in (RWKV_CHUNK, 0):
        model, batch = rwkv_cut(seed, "float32", chunk, tree)
        out[chunk] = leaf_grads(model, batch)
        del model
        release()
    (l_c, g_c), (l_s, g_s) = out[RWKV_CHUNK], out[0]
    finite = all(bool(torch.isfinite(g).all()) for g in list(g_c.values()) + list(g_s.values()))
    errs = grad_errors(g_c, g_s)
    print(f"[30a] {RWKV_ARCH} at full width, {len(bf16.layers)} of "
          f"{get_config(RWKV_ARCH).n_layers} layers, phase 27's bf16 weights cast up to float32, "
          f"its first batch: step 1 at rwkv_chunk {RWKV_CHUNK} against the stepwise form on the "
          f"card: loss {float(l_c):.6f} / {float(l_s):.6f}; grads finite {finite}; {len(errs)} "
          f"leaves, worst "
          f"{worst_leaf(errs)} of its max |grad| (limit {RWKV_F32_GATE:g}); "
          f"{time.perf_counter() - t0:.1f} s")
    if not (finite and max(errs.values()) <= RWKV_F32_GATE):
        raise AssertionError(f"{RWKV_ARCH} at full width in float32: the chunked gradient "
                             f"disagrees with the stepwise one")
    del bf16, tree, out, g_c, g_s
    release()


def rwkv_chunk_prefill(seed, smi, ref):
    """[30b] ``LM.prefill`` at ``RWKV_CHUNK``, full width and depth, bf16
    weights from the seed (phase 25's), phase 25's prompt: ms (median of
    3), peak, busy share, the operator-boundary bytes of one call
    (``count_ops``) at the HBM rate beside phase 25's bound; logits and
    every layer's final state S against phase 25's stepwise prefill
    (``ref``) within the gates above ``RWKV_S0_GATE``, logits finite."""
    cfg = get_config(RWKV_ARCH).replace(rwkv_chunk=RWKV_CHUNK)
    shape = LATE_PREFILL[RWKV_ARCH]
    model = build_model(cfg).init(seed)
    toks = late_prompt(cfg, seed, shape)
    out = {}

    def run():
        out.clear()
        out["logits"], out["cache"] = model.prefill(toks)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    logits, s_all = out.pop("logits"), out.pop("cache")["state"]["S"]
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{RWKV_ARCH} chunked prefill: non-finite logits")
    rel = lambda got, want: float((got - want).abs().max() / want.abs().max())  # noqa: E731
    s_rel = [rel(s_all[i], ref["state"]["S"][i]) for i in range(cfg.n_layers)]
    s_gate = [RWKV_S0_GATE] + [2 * i * BF16_ULP for i in range(1, cfg.n_layers)]
    l_rel, l_gate = rel(logits, ref["logits"]), cfg.n_layers * BF16_ULP
    same_ids = bool((logits.argmax(-1) == ref["logits"].argmax(-1)).all())
    del logits, s_all
    with count_ops() as counted:
        model.prefill(toks)
    torch.cuda.synchronize()
    busy = profile_program(f"{RWKV_ARCH} prefill at rwkv_chunk {RWKV_CHUNK}",
                           lambda: model.prefill(toks), ms, host_ops=False)
    flops = prefill_flops(model, cfg, *shape)
    weights = sum(p.nbytes for p in model.parameters())
    bound, by = max((weights / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (flops / BF16_FLOPS * 1e3, "operations"))
    t_boundary = counted.hbm_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[30b] {RWKV_ARCH} prefill {list(shape)} at rwkv_chunk {RWKV_CHUNK} ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.dtype}, {count_params(model)} parameters, phase "
          f"25's weights and prompt): {ms:.4f} ms (CUDA events, median of 3 after one "
          f"warm-up), {shape[0] * shape[1] / (ms / 1e3):.0f} tokens/s, against the stepwise "
          f"{ref['ms']:.4f} ms of phase 25 ({ref['ms'] / ms:.1f}x); bound {bound:.4f} ms "
          f"({by}, as phase 25's), {100 * bound / ms:.2f}% of it; operator-boundary bytes "
          f"{counted.hbm_bytes / 1e9:.3f} GB ({counted.operators} operators, count_ops) at "
          f"3.35 TB/s {t_boundary:.4f} ms, {100 * t_boundary / ms:.1f}% of the call; busy "
          f"{100 * busy / ms:.1f}%; peak memory {peak / 1e9:.3f} GB [{smi}]")
    print(f"  against the stepwise prefill, max |diff| / max |stepwise|: logits {l_rel:.3e} "
          f"(limit {cfg.n_layers} x 2^-8 = {l_gate:.3e}), greedy ids equal {same_ids}; "
          f"layer 0's S {s_rel[0]:.3e} (limit {RWKV_S0_GATE:g}); layers 1-{cfg.n_layers - 1}'s "
          f"S over their limits 2 i x 2^-8 at most {max(r / g for r, g in zip(s_rel[1:], s_gate[1:])):.3f} "
          f"(<= 1 passes; S by layer " + ", ".join(f"{r:.2e}" for r in s_rel)
          + "); logits finite")
    if l_rel > l_gate or any(r > g for r, g in zip(s_rel, s_gate)):
        raise AssertionError(f"{RWKV_ARCH}: the chunked prefill disagrees with the stepwise")
    del model, toks, out
    free()


def rwkv_chunk_grad(seed, step1):
    """[30c] step 1's gradient at ``RWKV_CHUNK`` on phase 27's cut (its
    bf16 weights and first batch) against phase 27's stepwise step 1
    (``step1``): every leaf finite, and each form's gradient against the
    float32 one of the same weights (``RWKV_BF16_RATIO``; 30a holds the
    two forms to each other in float32)."""
    model, batch = rwkv_cut(seed, "bfloat16", RWKV_CHUNK)
    loss, got = leaf_grads(model, batch)
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    f32, batch = rwkv_cut(seed, "float32", RWKV_CHUNK, model.param_tree())
    del model
    _, exact = leaf_grads(f32, batch)
    del f32
    release()
    e_chunk, e_step = grad_errors(got, exact), grad_errors(step1["grads"], exact)
    direct = grad_errors(got, step1["grads"])
    ratio = max(e_chunk.values()) / max(e_step.values())
    print(f"[30c] {RWKV_ARCH} step 1 at rwkv_chunk {RWKV_CHUNK}, bf16, {len(e_chunk)} leaves of "
          f"phase 27's cut (its weights and first batch): loss {float(loss):.6f} against the "
          f"stepwise {step1['loss']:.6f}; grads finite {finite}; against the float32 gradient "
          f"of the same weights, worst leaf chunked {worst_leaf(e_chunk)}, stepwise "
          f"{worst_leaf(e_step)}: ratio {ratio:.3f} (limit {RWKV_BF16_RATIO:g}); chunked "
          f"against stepwise directly {worst_leaf(direct)} (recorded: 2^-6 would not hold two "
          f"bf16 draws of ~2.6e-2 each)")
    if not (finite and ratio <= RWKV_BF16_RATIO):
        raise AssertionError(f"{RWKV_ARCH}: the chunked bf16 gradient is further from the "
                             f"float32 one than the stepwise form's")
    del got, exact, batch
    free()


def phase_rwkv_chunk(seed, smi, prefill_ref, step1):
    """[30] rwkv6-3b's chunked WKV at full width (30a ran in phase 9's
    wait): the prefill (30b), then step 1's gradient at phase 27's cut and
    ``RWKV_TRAIN_STEPS`` training steps at full depth (30c)."""
    rwkv_chunk_prefill(seed, smi, prefill_ref)
    rwkv_chunk_grad(seed, step1)
    cfg = get_config(RWKV_ARCH).replace(grad_accum=1, rwkv_chunk=RWKV_CHUNK)
    b, s, _ = FAMILY_FULL[RWKV_ARCH]
    train_timed("30c", RWKV_ARCH, cfg, seed, smi, b, s, RWKV_TRAIN_STEPS)


# ---------------------------------------------------------------------------
# 28. the operator counter and the dry run's roofline
# ---------------------------------------------------------------------------

# the dry-run cells phase 28 counts on meta: (arch, shape, mesh)
COUNT_CELLS = (("gemma2-2b", "train_4k", "16x16"), ("gemma2-2b", "prefill_32k", "16x16"),
               ("gemma2-2b", "decode_32k", "16x16"),
               ("qwen3-moe-235b-a22b", "decode_32k", "2x16x16"),
               ("zamba2-2.7b", "long_500k", "16x16"))
COUNTED = {}    # the card's counts: phase 4's NAP forward; phases 11, 14, 16 with their ms


def meta_twins(lm_layers, seed):
    """Phases 11, 14 and 16's programs on meta: gemma2-2b's greedy step on
    phase 11's cache at its position, its 4 x 512 prefill, and phase 16's
    training step on the driver's config, optimizer and batch.  Returns
    ``{kind: (OpCost, active parameters, tokens)}``."""
    cfg = get_config("gemma2-2b")
    m = build_model(cfg.replace(n_layers=lm_layers), "meta")
    m.load(param_shapes(m))
    cache = m.init_cache(SERVE_BATCH, SERVE_MAX_SEQ)
    cache.update(pos=SERVE_POS, length=torch.full((SERVE_BATCH,), SERVE_POS,
                                                  dtype=torch.int32, device="meta"))
    out = {}
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int64, device="meta")
    prompts = torch.zeros((SERVE_BATCH, PREFILL_LEN), dtype=torch.int64, device="meta")
    with count_ops() as out["decode"]:
        m.decode_step(cache, tok)
    with count_ops() as out["prefill"]:
        m.prefill(prompts)
    n_serve = count_active_params(m)
    b, s, n_steps = TRAIN_FULL
    tcfg = cfg.replace(grad_accum=1)             # as train.main sets it
    tm = build_model(tcfg, "meta")
    tm.load(param_shapes(tm))
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=n_steps, warmup_steps=max(n_steps // 20, 1),
                          state_dtype=tcfg.opt_state_dtype, master_fp32=tcfg.opt_master_fp32)
    state = adamw_init(tm.param_tree(), opt_cfg)
    batch = train.to_device(SyntheticLM(tcfg.vocab, s, seed=seed).batch(n_steps, b), "meta")
    with count_ops() as out["train"]:
        make_train_step(tm, opt_cfg)(state, batch)
    return {"decode": (out["decode"], n_serve, SERVE_BATCH),
            "prefill": (out["prefill"], n_serve, SERVE_BATCH * PREFILL_LEN),
            "train": (out["train"], count_active_params(tm), b * s)}


def count_child(spec_file):
    """[28a] the child of phase 28 (host work on meta, no card): the
    dry-run cells of ``COUNT_CELLS`` and the meta twins of phases 11, 14
    and 16, written as JSON."""
    spec = json.loads(Path(spec_file).read_text())
    # host work beside the timed phases and the 9e / 9h children: one
    # thread, the lowest priority, so it takes only idle time
    os.nice(19)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cells = {dryrun.cell_key(arch, shape, mesh): dryrun.run_cell(arch, shape, mesh)
             for arch, shape, mesh in COUNT_CELLS}
    twins = {k: dict(cost=c.as_dict(), n_active=n, tokens=tok)
             for k, (c, n, tok) in meta_twins(spec["lm_layers"], spec["seed"]).items()}
    Path(spec["out"]).write_text(json.dumps(dict(cells=cells, twins=twins,
                                                 seconds=time.perf_counter() - t0)))


def start_count_child(tmp, lm_layers, seed):
    """Start phase 28's child (this script with ``--count-child``); it
    counts on meta while this process works.  Returns ``finish()``, which
    waits for it and returns its JSON.  The child is killed if this
    process exits first."""
    tmp = Path(tmp)
    spec = tmp / "count_spec.json"
    out, log = tmp / "count_out.json", tmp / "count_log.txt"
    spec.write_text(json.dumps(dict(lm_layers=lm_layers, seed=seed, out=str(out))))
    logf = open(log, "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--count-child", str(spec)], stdout=logf,
                            stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    t0 = time.perf_counter()
    print("[28a] the meta-count child started in the background")

    def finish():
        t1 = time.perf_counter()
        code = proc.wait(timeout=900)
        logf.close()
        if code != 0:
            raise AssertionError(f"phase 28's child exited {code}:\n"
                                 f"{log.read_text()[-4000:]}")
        res = json.loads(out.read_text())
        print(f"  phase 28's child: {res['seconds']:.1f} s of counting, ended "
              f"{time.perf_counter() - t0:.1f} s after its start; waited "
              f"{time.perf_counter() - t1:.1f} s for it")
        return res

    return finish


def phase_counts(finish, smi):
    """[28] the meta counts' roofline rows, the card's counts against their
    meta twins, the one-card roofline against the measured medians."""
    res = finish()
    print("[28a] dry-run cells counted on meta (roofline: NVIDIA H100 SXM constants, "
          "989 TFLOP/s bf16, 3.35 TB/s; per chip = global / chips)")
    print("  " + HEADER.replace("\n", "\n  "))
    for key, rec in res["cells"].items():
        if not rec["ok"] or rec.get("skipped"):
            raise AssertionError(f"dry-run cell {key}: {rec.get('error', rec.get('reason'))}")
        ops = rec["ops"]
        print(f"  {rec['roofline']['row']} counted in {rec['t_count_s']} s: "
              f"{ops['operators']} operators, dot {ops['dot_flops']:.4e} FLOP, "
              f"{ops['hbm_bytes']:.4e} B, exchanges {ops['collective_bytes']}, "
              f"node-crossing {ops['dci_bytes']:.4e} B; kernels "
              + ", ".join(f"{k} x{int(v['calls'])} {v['bytes'] / 1e9:.3f} GB"
                          for k, v in ops["kernels"].items())
              + f"; analytic {rec['memory']['analytic']['total']:.3f} GB/chip")
    moe = res["cells"]["qwen3-moe-235b-a22b|decode_32k|2x16x16"]
    if not moe["ops"]["dci_bytes"] > 0:
        raise AssertionError("qwen3-moe decode_32k on 2x16x16: no pod-crossing bytes")
    print(f"[28b] card against meta, gemma2-2b [{smi}]")
    for kind in ("decode", "prefill", "train"):
        card, ms = COUNTED[kind]
        twin = res["twins"][kind]
        meta = twin["cost"]
        for f in ("dot_flops", "hbm_bytes"):
            if getattr(card, f) != meta[f]:
                raise AssertionError(f"{kind}: {f} on the card {getattr(card, f)} "
                                     f"!= on meta {meta[f]}")
        if card.kernels != meta["kernels"]:
            raise AssertionError(f"{kind}: kernels' declared work on the card "
                                 f"{card.kernels} != on meta {meta['kernels']}")
        mf = model_flops_for(kind, twin["n_active"], twin["tokens"])
        roof = build_roofline("gemma2-2b", kind, "1", 1, card, mf)
        t_ms = roof.step_time * 1e3
        print(f"  {kind}: card = meta: dot {card.dot_flops:.6e} FLOP, {card.hbm_bytes:.6e} B "
              f"at operator boundaries, kernels {card.kernels}; operators card "
              f"{card.operators} / meta {meta['operators']}; one-card roofline "
              f"{t_ms:.4f} ms ({roof.dominant}; compute {roof.t_compute * 1e3:.4f}, memory "
              f"{roof.t_memory * 1e3:.4f}) against the measured median {ms:.4f} ms: "
              f"{100 * t_ms / ms:.1f}% [{smi}]")
    nap = COUNTED["nap"]
    print(f"[28c] phase 4's NAP forward: node-crossing {nap.dci_bytes:.0f} B = "
          f"inter_node_bytes() (checked in phase 4)")


# ---------------------------------------------------------------------------
# 29. data-parallel training across processes
# ---------------------------------------------------------------------------

DP_PROCS = 2
DP_ARCH = "whisper-small"
# 29a: phase 27's whisper batch, 4 x 448 tokens over 4 x 1500 frames, split
# over the two processes
DP_FULL = dict(batch=4, seq=448, steps=3, lr=3e-4)
DP_GRAD_GATE = 2.0 ** -6     # of each leaf's max |grad|: bf16 gradients
DP_HELD = dict(batch=4, seq=32, steps=3, lr=1e-3)
# 29b: (arch, config overrides, on the island over Topology(2, 2) across
# the processes); the capacity holds every copy, so the one-process run
# (batch 4 on one island) and the job's (2 a process) drop nothing
DP_MOE = dict(wire_dtype="f32", capacity_factor=8.0)
DP_HELD_CASES = {
    "gemma2-2b": ("gemma2-2b", {}, False),
    "qwen3-moe replicas": ("qwen3-moe-235b-a22b", DP_MOE, False),
    **{f"{arch.split('-')[0]} island {mode}": (arch, dict(DP_MOE, moe_dispatch=mode), True)
       for arch in MOE_LM_ARCHS for mode in ("flat", "nap")}}
DP_ISLAND = (2, 2)


def dp_control(model, cfg, seed, got_loss, got_grads):
    """Process 0's one-process step 1 on the whole batch from the same
    weights (before the update): its loss and each leaf's max |diff| over
    the control's max |grad|."""
    h = DP_FULL
    batch = train.to_device(train.step_batch(
        cfg, SyntheticLM(cfg.vocab, h["seq"], seed=seed), 0, h["batch"]), model.device)
    loss, grads = make_train_step(model, AdamWConfig()).loss_and_grad(batch)
    errs = {}
    for (path, g), (_, w) in zip(tree_leaves_with_path(got_grads),
                                 tree_leaves_with_path(grads)):
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        errs["/".join(map(str, path))] = err / scale if scale else (0.0 if err == 0 else
                                                                     math.inf)
    return dict(loss=float(loss), got_loss=float(got_loss), errs=errs)


def dp_child(spec_file):
    """One process of phase 29's job, started by ``launch``: 29a, whisper-
    small at full width trained by ``launch.train.train`` over the job's
    data axis (process 0 also runs the one-process control of step 1),
    then 29b's held cases, each followed on process 0 by its one-process
    run; a report as JSON."""
    spec = json.loads(Path(spec_file).read_text())
    exit_with_parent()
    pid = attach(verbose=True)["process_id"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = mesh_for(Topology(DP_PROCS, 1))
    seed, h = spec["seed"], DP_FULL
    report = {"pid": pid}
    cfg = get_config(DP_ARCH).replace(grad_accum=1)
    control = {}

    def on_grads(step, model, batch, loss, grads):
        if step == 0 and pid == 0:
            control.update(dp_control(model, cfg, seed, loss, grads))

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.train(cfg, steps=h["steps"], batch=h["batch"], seq=h["seq"], lr=h["lr"],
                      seed=seed, log_every=1, mesh=data, on_grads=on_grads)
    report["a"] = dict(
        seconds=time.perf_counter() - t0, losses=run.losses, grad_norms=run.grad_norms,
        fwd_bwd_ms=run.fwd_bwd_ms, allreduce_ms=run.allreduce_ms,
        allreduce_wall_ms=run.allreduce_wall_ms, update_ms=run.update_ms,
        sync_stats=run.sync_stats, digests=run.digests,
        host_s=list(run.detector.times["local"]), peak=torch.cuda.max_memory_allocated(),
        n_params=count_params(run.model), control=control)
    del run, control
    gc.collect()
    torch.cuda.empty_cache()
    hh = DP_HELD
    report["b"] = {}
    for name, (arch, over, on_island) in DP_HELD_CASES.items():
        c = get_reduced(arch).replace(grad_accum=1, **over)
        kw = dict(steps=hh["steps"], batch=hh["batch"], seq=hh["seq"], lr=hh["lr"],
                  seed=seed, log_every=hh["steps"])
        run = train.train(c, mesh=data, island=mesh_for(Topology(*DP_ISLAND))
                          if on_island else None, **kw)
        rec = dict(losses=run.losses, digests=run.digests,
                   sent=[st["sent_bytes_nodexproc"] for st in run.sync_stats])
        del run
        if pid == 0:         # the same training in one process, the whole batch
            one = train.train(c, island=Topology(*DP_ISLAND) if on_island else None, **kw)
            rec["one"] = one.losses
            del one
        job_barrier(data)
        report["b"][name] = rec
    (Path(spec["out"]) / f"dp_report_{pid}.json").write_text(json.dumps(report))
    detach()
    print(f"  [p{pid}] done", flush=True)


def start_dp_children(tmp, seed):
    """Start phase 29's two gloo children (this script with
    ``--dp-child``) on the card, in the background.  Returns ``finish()``:
    it waits for them (once) and returns their reports, output and
    seconds (LaunchError if a child failed)."""
    tmp = Path(tmp)
    spec_file = tmp / "dp_spec.json"
    spec_file.write_text(json.dumps(dict(seed=seed, out=str(tmp))))
    box = {}

    def run():
        try:
            box["res"] = launch(str(Path(__file__).resolve()), DP_PROCS,
                                args=["--dp-child", str(spec_file)],
                                env={"REPRO_MESH_BACKEND": "gloo"}, timeout_s=900)
        except BaseException as e:      # re-raised by finish()
            box["err"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    print(f"[29] {DP_PROCS} gloo children started in the background: data-parallel "
          f"training of {DP_ARCH} at full width (29a), then 29b's held cases")

    def finish():
        if "out" not in box:
            t1 = time.perf_counter()
            thread.join()
            if "err" in box:
                raise box["err"]
            box["out"] = dict(
                reports=[json.loads((tmp / f"dp_report_{pid}.json").read_text())
                         for pid in range(DP_PROCS)],
                outputs=[box["res"].output(pid) for pid in range(DP_PROCS)],
                wall_s=time.perf_counter() - t0, waited_s=time.perf_counter() - t1)
        return box["out"]

    return finish


def phase_dp_train(finish, smi):
    """[29] data-parallel training across two gloo processes on the card:
    the checks and figures of what ``start_dp_children`` ran."""
    res = finish()
    reports = res["reports"]
    for pid, out in enumerate(res["outputs"]):
        for line in out.splitlines():
            if line.startswith(("step ", "training ", "  [p", "[mesh.attach]")):
                print(f"  p{pid}| {line}")
    a = [r["a"] for r in reports]
    h = DP_FULL
    print(f"[29a] {DP_ARCH} at full width ({a[0]['n_params']} parameters, bf16 weights, "
          f"fp32 masters, remat), trained by launch.train over a job of {DP_PROCS} gloo "
          f"processes on the card: global batch {h['batch']} x {h['seq']} tokens over "
          f"{h['batch']} x 1500 frames from the seed, {h['batch'] // DP_PROCS} rows a "
          f"process, {h['steps']} steps; the children ran {res['wall_s']:.1f} s (to "
          f"the wait for them, {res['waited_s']:.1f} s) [{smi}]")
    if a[0]["losses"] != a[1]["losses"] or a[0]["digests"] != a[1]["digests"]:
        raise AssertionError("29a: the processes' losses or parameter digests differ")
    if len(a[0]["digests"]) != h["steps"] or not np.isfinite(a[0]["losses"]).all():
        raise AssertionError(f"29a: {len(a[0]['digests'])} digests, losses {a[0]['losses']}")
    for i in range(h["steps"]):
        parts = []
        for pid, r in enumerate(a):
            st = r["sync_stats"][i]
            step = r["fwd_bwd_ms"][i] + r["allreduce_ms"][i] + r["update_ms"][i]
            parts.append(
                f"p{pid} {step:.2f} ms = forward + backward {r['fwd_bwd_ms'][i]:.2f} + "
                f"all-reduce {r['allreduce_ms'][i]:.2f} (wall {r['allreduce_wall_ms'][i]:.2f}) "
                f"+ AdamW {r['update_ms'][i]:.2f}, host {r['host_s'][i]:.3f} s; staged "
                f"{st['staged_bytes']:,} B, sent to the other process "
                f"{st['sent_bytes_nodexproc']:,} B")
        print(f"  step {i}: loss {a[0]['losses'][i]:.5f}, grad norm "
              f"{a[0]['grad_norms'][i]:.4f}; digests equal ({a[0]['digests'][i][:16]}); "
              + "; ".join(parts))
    print("  peak memory " + ", ".join(f"p{pid} {r['peak'] / 1e9:.3f} GB"
                                       for pid, r in enumerate(a)))
    ctl = a[0]["control"]
    rel = abs(ctl["got_loss"] - ctl["loss"]) / abs(ctl["loss"])
    worst = max(ctl["errs"], key=ctl["errs"].get)
    print(f"  control, process 0's one-process step 1 on the whole batch from the same "
          f"weights: loss {ctl['loss']:.6f} against the job's {ctl['got_loss']:.6f} (rel "
          f"{rel:.3e}, rtol 1e-3); reduced gradient against the control's, "
          f"{len(ctl['errs'])} leaves, worst {ctl['errs'][worst]:.3e} of its max |grad| "
          f"({worst}; limit 2^-6)")
    if not (rel <= 1e-3 and ctl["errs"][worst] <= DP_GRAD_GATE):
        raise AssertionError("29a: the job's step 1 disagrees with the one-process control")
    hh = DP_HELD
    print(f"[29b] held: reduced configs in float32, {hh['steps']} steps of "
          f"{hh['batch']} x {hh['seq']} tokens, lr {hh['lr']}; each job against process "
          f"0's one-process run of it on the card (losses rtol 1e-4)")
    for name in DP_HELD_CASES:
        got = [r["b"][name] for r in reports]
        one = got[0]["one"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(got[0]["losses"], one))
        print(f"  {name}: losses {[round(x, 6) for x in got[0]['losses']]} against one "
              f"process {[round(x, 6) for x in one]} (max rel {rel:.3e}); digests equal "
              f"{got[0]['digests'] == got[1]['digests']}; sent to the other process "
              f"{got[0]['sent'][0]:,} B a step")
        if not (rel <= 1e-4 and got[0]["losses"] == got[1]["losses"]
                and got[0]["digests"] == got[1]["digests"]):
            raise AssertionError(f"29b {name}: the job disagrees with one process or "
                                 f"its replicas differ")


# zamba2-2.7b's long_500k decode (phase 31) ----------------------------------
LONG_ARCH = "zamba2-2.7b"
LONG_SEQ = 524_288           # configs/shapes.py long_500k: one token against this cache, batch 1
LONG_REPS = 5                # timed decode steps after the first


def long_cache(model, seq, seed):
    """``init_cache(1, seq)`` with every application's k and v drawn from
    the seed in place, one at a time in bf16 (no float32 copy of the
    cache), and ``length`` / ``pos`` at seq - 1: the next step writes slot
    seq - 1 and attends over the whole cache."""
    cache = model.init_cache(1, seq)
    gen = torch.Generator(device=DEV).manual_seed(seed + 31)
    for a in range(model.n_apps):
        for name in ("k", "v"):
            cache["shared"][name][a].normal_(generator=gen)
    cache["length"].fill_(seq - 1)
    cache["pos"] = seq - 1
    return cache


def recording_attention(record):
    """A stand-in for ``models.attention``'s decode kernel call that
    records each call's arguments and output into ``record``."""
    real = decode_attention_grouped

    def call(q, k, v, lengths, **kw):
        out = real(q, k, v, lengths, **kw)
        record.append(dict(q=q, lengths=lengths, kw=kw, out=out))
        return out
    return call


def phase_long_500k(seed, smi):
    """[31] zamba2-2.7b's long_500k decode at full width and depth, bf16
    weights from the seed: one token against a 524,288-position cache of
    its 9 shared-block applications (48.318 GB of k/v).  One step, the
    decode kernel held against its plain version on the step's own q at
    the first application, then LONG_REPS timed steps, ``length`` and
    ``pos`` reset to S - 1 before each (a full cache raises); the last
    step's 9 kernel calls re-timed back to back on their own inputs (events
    around one call in the step would count the wrapper's host time too:
    the card waits for the host there), and one step profiled.  Returns
    the kernels-line entry of the kernel at this length."""
    t0 = time.perf_counter()
    cfg = get_config(LONG_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg).init(seed)
    cache = long_cache(model, LONG_SEQ, seed)
    torch.cuda.synchronize()
    kv_bytes = sum(t.nbytes for t in cache["shared"].values())
    weights = sum(t.nbytes for t in model.parameters())
    print(f"[31] {LONG_ARCH} long_500k: {cfg.n_layers} layers, {model.n_apps} shared-block "
          f"applications, one token against a {LONG_SEQ}-position cache, batch 1, "
          f"{cfg.dtype}; weights {weights / 1e9:.3f} GB and k/v {kv_bytes / 1e9:.3f} GB "
          f"([{model.n_apps}, 1, {LONG_SEQ}, {cfg.n_kv_heads}, {cfg.head_dim}] each) from "
          f"seed {seed} in {time.perf_counter() - t0:.2f} s")
    tok = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (1, 1))).to(DEV)
    record = []
    attention.decode_attention_grouped = recording_attention(record)
    try:
        reset_launches()
        logits, cache = model.decode_step(cache, tok)
        torch.cuda.synchronize()
        first_launches = launches["decode_attention_grouped"]
        first = record[0]
        q, lengths = first["q"], first["lengths"]
        k = cache["shared"]["k"][0].transpose(1, 2)
        v = cache["shared"]["v"][0].transpose(1, 2)
        again = decode_attention_grouped(q, k, v, lengths, **first["kw"])
        if not (torch.isfinite(logits).all() and torch.equal(again, first["out"])):
            raise AssertionError("long_500k: non-finite logits, or the kernel's output "
                                 "in the step differs from a second call on its inputs")
        print(f"  step 1: {len(record)} decode kernel calls, {first_launches} launches; "
              f"first application: lengths {lengths.tolist()}, q {list(q.shape)}")
        entry = attn_case(f"{LONG_ARCH} long_500k, first application, the step's own q: "
                          f"B 1, S {LONG_SEQ}, Hkv {cfg.n_kv_heads}, g 1, D {cfg.head_dim}, "
                          f"{cfg.dtype} [B,S,Hkv,D]", q, k, v, lengths, first["kw"]["window"],
                          first["kw"]["softcap"], first["kw"]["scale"])
        del q, lengths, k, v, again, first, record[:]
        free()                      # the plain version's float32 copies
        peak_check = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        reset_launches()
        for _ in range(LONG_REPS):
            cache["length"].fill_(LONG_SEQ - 1)
            cache["pos"] = LONG_SEQ - 1
            record.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            if not torch.isfinite(logits).all():
                raise AssertionError("long_500k: non-finite logits")
        n_launch = launches["decode_attention_grouped"]
    finally:
        attention.decode_attention_grouped = decode_attention_grouped
    wall = statistics.median(walls)
    # the last step's calls, application a on cache application a
    attn_ms = [device_ms(lambda r=r, a=a: decode_attention_grouped(
        r["q"], cache["shared"]["k"][a].transpose(1, 2), cache["shared"]["v"][a].transpose(1, 2),
        r["lengths"], **r["kw"]), n=5, warmup=1) for a, r in enumerate(record)]
    cache["length"].fill_(LONG_SEQ - 1)
    cache["pos"] = LONG_SEQ - 1
    busy = profile_program(f"{LONG_ARCH} long_500k: one decode step",
                           lambda: model.decode_step(cache, tok), wall, host_ops=False)
    peak_steps = torch.cuda.max_memory_allocated()
    want = model.n_apps * LONG_REPS
    if n_launch != want or first_launches != model.n_apps:
        raise AssertionError(f"long_500k: {first_launches} + {n_launch} decode kernel "
                             f"launches, not {model.n_apps} + {want}")
    attn_bound = kv_bytes / HBM_BYTES_PER_S * 1e3
    step_bound = (kv_bytes + weights) / HBM_BYTES_PER_S * 1e3
    attn = sum(attn_ms)
    print(f"  {LONG_REPS} timed steps: wall median {wall:.4f} ms (min {min(walls):.4f}, "
          f"max {max(walls):.4f}; host clock around a synchronized step); the "
          f"{model.n_apps} attention kernels' device time (the last step's calls again, "
          f"events around 5 back-to-back launches each) {attn:.4f} ms a step ("
          f"{min(attn_ms):.4f} .. {max(attn_ms):.4f} an application) against their bound "
          f"{attn_bound:.4f} ms ({kv_bytes / 1e9:.3f} GB of k/v at 3.35 TB/s): "
          f"{100 * attn_bound / attn:.1f}%; the step's bound {step_bound:.4f} ms (the "
          f"weights too), {100 * step_bound / wall:.1f}% of its wall; the card busy "
          f"{busy:.4f} ms of the profiled step ({100 * busy / wall:.1f}% of the median "
          f"wall); launches {first_launches} + {n_launch} (= {model.n_apps} a step); peak "
          f"memory {peak_check / 1e9:.3f} GB with the plain version's check, "
          f"{peak_steps / 1e9:.3f} GB over the timed steps; logits finite; phase 31 "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    del model, cache, logits
    free()
    entry["launches"] = first_launches + n_launch
    return dict(name=f"decode_attention_grouped:{LONG_ARCH}:long_500k", route="cuda",
                source=ATTN_SOURCE, replaces=ATTN_REPLACES, **entry)


class PhaseClock:
    """Seconds of each phase of ``main``, printed as each ends (a phase
    run inside another's wait counts in that one's)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = {}

    def done(self, label):
        t = time.perf_counter()
        self.seconds[label] = t - self.t0
        print(f"  phase {label} {t - self.t0:.1f} s")
        self.t0 = t


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2024, help="main-path grid side")
    ap.add_argument("--bsr-n", type=int, default=512, help="BSR-path grid side")
    ap.add_argument("--amg-n", type=int, default=1024,
                    help="grid side of the AMG path and the solver service (9, 9d, 9h)")
    ap.add_argument("--lm-layers", type=int, default=26,
                    help="gemma2-2b depth of the serving phase")
    ap.add_argument("--moe-layers", type=int, default=4,
                    help="depth of phase 20's MoE LMs (deepseek: 1 dense + the rest MoE)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register and shared-memory report")
    ap.add_argument("--mesh-child", metavar="SPEC",
                    help="run one process of phases 9e and 9h (set by its launcher)")
    ap.add_argument("--moe-child", metavar="SPEC",
                    help="run one process of phase 9f (set by its launcher)")
    ap.add_argument("--coll-child", metavar="SPEC",
                    help="run one process of phase 9g (set by its launcher)")
    ap.add_argument("--count-child", metavar="SPEC",
                    help="run phase 28's meta counts (set by its launcher)")
    ap.add_argument("--dp-child", metavar="SPEC",
                    help="run one process of phase 29 (set by its launcher)")
    args = ap.parse_args()
    if args.dp_child:
        dp_child(args.dp_child)
        return
    if args.count_child:
        count_child(args.count_child)
        return
    if args.mesh_child:
        mesh_child(args.mesh_child)
        return
    if args.moe_child:
        moe_child(args.moe_child)
        return
    if args.coll_child:
        coll_child(args.coll_child)
        return
    global T_START
    T_START = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=DEV).manual_seed(args.seed)

    # 1. environment ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}, count {torch.cuda.device_count()}; TF32 off")

    # 2. build ----------------------------------------------------------------
    clock = PhaseClock()
    info = build_all(ptxas_verbose=args.ptxas)
    print(f"[2] built {info['built']} in {info['seconds']:.2f} s")
    if args.ptxas:
        for src, log in info["log"].items():
            print(f"[2] nvcc {src}:\n{log}")

    clock.done("2")
    # host plans of the NAP paths and the float64 oracles -------------------
    topo = Topology(32, 16)
    t0 = time.perf_counter()
    a = rotated_anisotropic_2d(args.n)
    t_gen = time.perf_counter() - t0
    part = contiguous_partition(a.shape[0], topo.n_procs)
    op = operator(a, topo, part)
    t0 = time.perf_counter()
    c = op.executor.compiled
    t_compile = time.perf_counter() - t0
    rep = op.autotune_report()
    verdict = (rep["resolved"], rep["transpose_resolved"])
    print(f"[plan] n={args.n}: {a.shape[0]} rows, {a.nnz} nnz, "
          f"{topo.n_procs} ranks; generate {t_gen:.2f} s, compile_nap "
          f"{t_compile:.2f} s; rows_pad {c.rows_pad}, pads {c.pads}")
    print(f"[plan] autotune verdict forward={verdict[0]} transpose={verdict[1]} "
          f"(times {rep['times']}, transpose {rep['transpose']['times']})")
    if verdict != ("ell", "ell"):
        print(f"[plan] verdict is not ell in both directions {verdict}; the "
              f"ell phase runs with local_compute='ell'")
        op = operator(a, topo, part, local_compute="ell")
        c = op.executor.compiled
    t0 = time.perf_counter()
    c.ensure_ell()
    c.ensure_ell_t()
    t_ell = time.perf_counter() - t0
    print(f"[plan] ensure_ell + ensure_ell_t {t_ell:.2f} s (host plan build "
          f"{t_compile + t_ell:.2f} s): ell_kmax {c.ell_kmax}, ell_t_kmax "
          f"{c.ell_t_kmax}")

    a_b = rotated_anisotropic_2d(args.bsr_n)
    op_b = operator(a_b, topo, local_compute="bsr")
    t0 = time.perf_counter()
    cb = op_b.executor.compiled
    cb.ensure_fused()
    print(f"[plan] bsr n={args.bsr_n}: {a_b.shape[0]} rows; compile + "
          f"ensure_fused {time.perf_counter() - t0:.2f} s; layout {cb.bsr_layout}, "
          f"fused_blocks {cb.arrays['fused_blocks'].nbytes / 1e9:.3f} GB")

    t0 = time.perf_counter()
    oracles = dict(draw_operands(rng, a.shape[0]),
                   vb=rng.standard_normal(a_b.shape[0]))
    oracles.update(w1=host_apply(a, oracles["v1"]), w8=host_apply(a, oracles["v8"]),
                   z1=host_apply(a, oracles["u1"], transpose=True),
                   wb=host_apply(a_b, oracles["vb"]))
    print(f"[plan] float64 host oracles {time.perf_counter() - t0:.2f} s")
    clock.done("plan")

    # 3-9. the phases ---------------------------------------------------------
    entries = phase_kernels(c, cb, a, a_b, oracles, gen)
    by_name = {e["name"]: e for e in entries}
    clock.done("3")
    fwd, tr, nap_ref = phase_nap(op, a, oracles)
    # phases 4, 6 and 7's results and the float64 oracles, for phase 9e
    keep = dict(nap=nap_ref, standard={}, multistep={}, faults={}, integrity_ms={},
                oracles={k: oracles[k] for k in ("w1", "w8", "z1")})
    nap_ref["local_compute"] = op.spec.local_compute
    nap_padded, nap_effective = traffic_bytes(op.stats())
    nap_summary = dict(padded=nap_padded, effective=nap_effective,
                       cost=op.cost(BLUE_WATERS))
    del op, c
    free()
    clock.done("4")
    cnt_p, cnt_c = phase_bsr(op_b, a_b, oracles)
    del op_b, cb
    free()
    clock.done("5")
    s_fwd1, s_fwd8, s_tr = phase_standard(a, a_b, topo, part, oracles,
                                          nap_summary, args.n == 2024,
                                          keep["standard"])
    free()
    clock.done("6")
    m_fwd, m_tr = phase_multistep(a, topo, part, oracles, nap_ref, gen,
                                  args.n == 2024, keep["multistep"])
    free()
    clock.done("7")
    i_ell, i_bsr, nap_det = phase_integrity(a, topo, part, oracles, a_b, keep)
    # phases 9e and 9h's children, and phase 15's CPU half in a thread of
    # this process, run while this process does work that times nothing on
    # the card: the simulate backend, phase 9's hierarchy, level operators
    # and host twins; their checks follow phase 9d
    mesh_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    # phases 9, 9d and 9h's AMG path and service run on the AMG grid
    a_amg = a if args.amg_n == args.n else rotated_anisotropic_2d(args.amg_n)
    children = start_mesh_children(mesh_tmp.name, a, a_amg, args.seed, keep)
    cpu_twin = start_cpu_twin(args.seed)
    count_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_count_")
    counts = start_count_child(count_tmp.name, args.lm_layers, args.seed)
    phase_simulate(a, topo, part, oracles, a_b, nap_det, nap_ref["w1"],
                   nap_ref["z1"])
    del oracles, nap_ref, nap_det
    free()
    clock.done("8")
    # phase 25's first serving runs, then phases 15 (its CPU half done by
    # then) and 17 run while phase 9 waits for the children: they time
    # nothing on the card
    # phase 29's children start with that work and are waited for before
    # phase 9's first timing on the card; their checks come last (phase 29)
    late_first = {}
    dp_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dp_")
    dp = {}
    amg = phase_amg(a_amg, topo, gen, args.seed, args.n == 2024, keep,
                    levels_file=str(Path(mesh_tmp.name) / "levels.npz"),
                    children=children,
                    host_work=lambda: (dp.update(finish=start_dp_children(dp_tmp.name,
                                                                          args.seed)),
                                       late_first.update(late_first_runs(args.seed)),
                                       phase_rwkv_chunk_held(args.seed),
                                       phase_train_held(args.seed, cpu_twin()),
                                       phase_example_train(release),
                                       phase_family_train_held(args.seed),
                                       dp["finish"]()))
    free()
    clock.done("9 (with 25a, 30a, 15, 17, 26 and 29's children in its wait)")
    phase_spgemm_small(a_b, topo, args.seed)
    clock.done("9b")
    phase_examples()
    clock.done("9c")
    svc_ell = phase_service(a_amg, a_b, topo, args.seed, keep)
    free()
    clock.done("9d")
    mesh_ell = phase_mesh(a, keep)
    clock.done("9e")
    stack_ell = phase_stack(keep, smi)
    mesh_tmp.cleanup()
    del a, a_b, a_amg, keep
    free()
    clock.done("9h")
    phase_moe(args.seed)
    clock.done("9f")
    phase_collectives(args.seed)
    clock.done("9g")

    # 10-12. gemma2-2b serving ---------------------------------------------------
    attn_main, attn_late = phase_decode_attn(rng, gen, args.seed)
    entries.append(attn_main)
    entries.extend(attn_late.values())
    by_name["decode_attention_grouped"] = attn_main
    clock.done("10")
    by_name["decode_attention_grouped"]["launches"], served = phase_serve(
        args.lm_layers, args.seed)
    clock.done("11")
    phase_step_check(args.seed)
    clock.done("12")

    # 13-17. prefill and training ---------------------------------------------------
    phase_prefill_held(args.seed)
    clock.done("13")
    phase_prefill_full(served)
    del served
    free()
    clock.done("14")
    phase_train_full(args.seed, smi)
    clock.done("16")

    # 19-20. the MoE LMs ---------------------------------------------------------------
    phase_moe_lm_held(args.seed)
    clock.done("19")
    entries.extend(phase_moe_lm_full(args.moe_layers, args.seed, smi))
    clock.done("20")

    # 22-23. training the MoE LMs through the island ------------------------------
    phase_moe_train_held(args.seed)
    clock.done("22")
    phase_moe_train_full(args.seed, smi)
    clock.done("23")

    # 24-25. serving whisper-small, zamba2-2.7b and rwkv6-3b ---------------------
    phase_late_held(args.seed)
    clock.done("24")
    rwkv_prefill = {}
    late = phase_late_full(args.seed, smi, late_first, rwkv_prefill)
    clock.done("25")
    # the decode kernel's entry counts the gemma2-2b path and these; each
    # g = 1 entry its own arch's serving
    by_name["decode_attention_grouped"]["launches"] += sum(late.values())
    for arch, e in attn_late.items():
        e["launches"] = late[arch]

    # 26-27. training them (26 ran inside phase 9's wait) --------------------------
    rwkv_step1 = phase_family_train_full(args.seed, smi)
    clock.done("27")

    # 30. rwkv6-3b's chunked WKV (30a ran in phase 9's wait) -------------------
    phase_rwkv_chunk(args.seed, smi, rwkv_prefill, rwkv_step1)
    del rwkv_prefill, rwkv_step1
    free()
    clock.done("30")

    # 28. the operator counter (28a in a child since phase 8, 28b's card
    # counts inside phases 11, 14 and 16, 28c inside phase 4) -------------
    phase_counts(counts, smi)
    count_tmp.cleanup()
    clock.done("28")

    # 29. data-parallel training across processes (its children ran in
    # phase 9's wait) ----------------------------------------------------
    phase_dp_train(dp["finish"], smi)
    dp_tmp.cleanup()
    clock.done(f"29 (its children {dp['finish']()['wall_s']:.1f} s in phase 9's wait)")

    # 31. zamba2-2.7b's long_500k decode (~53 GB: last, alone on the card) ----
    entries.append(phase_long_500k(args.seed, smi))
    clock.done("31")

    # launches of each kernel over the paths that run it (each path's
    # counts were reset just before it); the AMG solve's launches, forward
    # and transpose together, the materialized Galerkin operator's apply
    # and the solver service's applies count with the forward entry; the
    # mesh phases' are those of their child processes (9h's AMG and service
    # applies with the forward entry too)
    by_name["ell_spmm_packed"]["launches"] = sum(
        d.get("ell_spmm_packed", 0) for d in (fwd, s_fwd1, s_fwd8, m_fwd, amg)) \
        + i_ell["forward"] + svc_ell + mesh_ell["forward"] + stack_ell["forward"]
    by_name["ell_spmm_packed:transpose"]["launches"] = sum(
        d.get("ell_spmm_packed", 0) for d in (tr, s_tr, m_tr)) + i_ell["transpose"] \
        + mesh_ell["transpose"] + stack_ell["transpose"]
    by_name["fused_bsr_spmm_packed"]["launches"] = (
        cnt_p.get("fused_bsr_spmm_packed", 0) + i_bsr.get("fused_bsr_spmm_packed", 0))
    by_name["fused_bsr_spmm"]["launches"] = cnt_c.get("fused_bsr_spmm", 0)
    for e in entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on its path")
    print(f"[21] whole script {time.perf_counter() - T_START:.1f} s; phases: "
          + ", ".join(f"{k} {v:.1f}" for k, v in clock.seconds.items()))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
