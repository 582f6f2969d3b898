#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, in order (any failure raises and exits nonzero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once, with an empty kernel of this
     script's own for phase 3's launch floor) and print each kernel's
     registers, spills and shared memory from ``-Xptxas -v``;
  2. K1 matmul against its plain version at every GEMM shape of
     tinyllama-1.1b's decode and prefill: f32 through the simt route,
     bf16 through both the tc (wgmma + TMA) and the decode (split-K)
     route, every activation, with and without bias; then the times of
     the route the path takes, the other bf16 route, the simt kernel,
     the plain version and ``torch.matmul`` beside the bound; and every
     GEMM of zamba2-1.2b's decode step (M = 8, ``Z_DECODE_GEMMS``) in
     bf16 through the decode route, which ``route`` must pick for each,
     and every GEMM of xlstm-350m (``X_GEMMS``, w_if's N = 8 among them)
     at M = 8 (decode route) and M = 8192 (tc route), and every K1 GEMM
     of mixtral-8x7b and Moonlight (``MIX_GEMMS``, ``MOON_GEMMS``) at M =
     8 through the decode route, and deepseek-v3's serving GEMMs at its
     decode step's M = 8 (``DS_DECODE_GEMMS``, decode route) and its
     prefill's M = 4096 (``DS_PREFILL_GEMMS``, tc route; w_dkv's N = 576
     among them), and whisper's and internvl2's decode steps' GEMMs at M =
     8 (``W_DECODE_GEMMS``, ``V_DECODE_GEMMS``, decode route; the heads of
     51872 and 92560 among them);
 2t. the decode threshold: both bf16 routes timed at M in {8, 16, 32,
     64, 128} over a decode step's GEMMs, and the crossover printed
     beside ``kernels/matmul.py:DECODE_MAX_M``;
 2c. K1 at every local GEMM shape of a (2,2,2) rank and of a dp2 x
     (2,2,1) rank of tinyllama-1.1b's training step (``rank_gemms``,
     from the weights' specs): the tc route against the plain version,
     timed beside ``torch.matmul`` and the bound;
 2b. the same at a 1d(4) and a 2d(q2) rank's GEMMs (``BASE_LAYOUTS``);
  3. K4 paged decode against its plain version at the tinyllama shape
     (32 q heads, 4 kv heads, d = 64, block 16), bf16 through both routes
     (split and simt), f32 through simt: ragged contexts of 64-1024 tokens,
     a windowed case, null and recycled blocks, residuals, the serve shape,
     a slot with no valid entry and slots that end inside the first split,
     64 slots of 1024-2048 tokens, 16 of them at d 128 in blocks of 32,
     mixtral's serve step (32/8 heads of 128, its window) and Moonlight's
     heads (16/16 of 128), and the step entry that folds in the current
     token; each within
     ``K4_NORM_TOL`` of the plain version's norm, the split route
     repeating bit for bit.  Then device times (CUDA graph) of both routes
     at the serve, the long and the d 128 shape beside the bound, the
     plain version, one empty kernel (the launch floor) and SDPA over
     contiguous K/V (not the same function); and, under torch.profiler,
     at mixtral's serve shape too, and, under torch.profiler,
     that one decode layer's attention launches K4's two passes and no
     other kernel (a profiler that sees no kernel fails the phase).  Last,
     K4 at the contiguous caches' shapes under the identity block table
     (``K4_CONTIG``: zamba2's shared block, 8 slots, 32/32 heads, L 512,
     contexts 32-96 and a wrapped ring; the speculative draft's cache of
     528; the self attention of whisper, 16/16 of 64, and of internvl2,
     16/8 of 128, as 7w and 7v serve them), both routes to
     ``K4_NORM_TOL``, timed beside the bound and SDPA
     with the position mask, which computes the same function there; and,
     under torch.profiler, that a contiguous decode layer's attention
     launches K4's two passes and no PyTorch attention;
 3w. K4 over whisper's static cross k/v (``K4_CROSS``: 8 slots, all
     1504 frames valid, 16/16 heads of 64, the identity table, no fold)
     as phase 3 holds the contiguous caches, timed beside its bytes bound
     and SDPA (the same function); and the model's ``cross_decode``
     against the reference's unmasked f32 softmax, one split launch;
 3d. K4 on MLA's latent decode (``K4_LATENT``): 128 query rows in f32
     over one kv head of 576 (v 512) in bf16, block 16, at the serve shape
     (B 8, contexts 275-279) and 64 slots of 1024-2048, through the simt
     route against the plain version, the residuals and the fold of the
     current token, to ``K4_NORM_TOL["float32"]``; device times beside the
     bytes bound and the f32 operations bound (``k4_latent_bound``), the
     plain version and SDPA over
     contiguous K/V;
  4. K3 RMSNorm forward and backward against their plain versions at the
     training shape (8192 rows x 2048), bf16 and f32, with and without a
     zero-centred gain, and at 1024 (xlstm's ln), 3072 and 4096 (zamba2's
     gate_ln) in bf16, and at deepseek-v3's 2048 rows of 512 (kv_ln), 1536
     (q_ln) and 7168 (d_model) in bf16:
     within 1e-4 (f32) or 3e-2 (bf16) of 1 + max and within
     ``K3_NORM_TOL`` of the plain version's norm, dg repeating bit for
     bit; then device times at each width beside ``F.rms_norm``'s forward
     and its backward (the backward's kernels summed by torch.profiler);
 4c. K3 in two phases (``K3_SPLIT_CASES``): 8192 rows of 2048 and 2560
     cut in 2 and 4, as ranks of the cube hold them, the pieces' partial
     sums added on the card as the all-reduce adds them; y, dx and dg
     against the plain phases and against the one-phase K3 on the whole
     rows, within ``K3_NORM_TOL``; one piece's device time beside its
     bytes bound and ``F.rms_norm`` on the whole rows;
 4b. K3 in one phase at a 1d(4) rank's norm, 4096 whole rows of 2048,
     against the plain version, timed as phase 4 times it;
  5. K2 flash attention forward and backward against their plain versions
     at the main paths' attention shapes, all causal: at d = 64 the
     tinyllama training layer (4 x 2048, 32/4 heads), zamba2's shared
     attention (4 x 2048, 32/32 heads, window 4096) and the serving
     prefill (8 x 512, 32/4); at d = 128 mixtral's training layer (4 x
     2048, 32/8, window 4096), Moonlight's (4 x 2048, 16/16) and
     internvl2's (4 x 2048, 16/8): bf16
     through the tc route (wgmma + TMA) at all six and through the simt
     route at the training shape, out, lse,
     dq, dk and dv within 3e-2 of 1 + max (lse 1e-5) and out, dq, dk and
     dv within ``K2_NORM_TOL`` of the plain version's norm, two backward
     runs giving the same bits, and the cost of the tc kernels' bf16 dS
     measured by the plain backward with dS rounded; f32 through the simt
     route at 1e-4.  Then the times of both routes, the plain version and
     ``F.scaled_dot_product_attention`` at each shape, beside the bound.
     Last, the head dims only the simt route takes (``K2_WIDE_SHAPES``):
     the paper's model, 4 x 512, 64/64 heads of 48, and gemma-2b, 4 x
     2048, 8/1 heads of 256, f32 and bf16 (bf16 also to ``K2_NORM_TOL``),
     timed beside SDPA and the bound;
 5w. K2 at whisper's shapes (``K2_WHISPER``, 16/16 heads of 64): the
     encoder's 4 x 1504 and the cross attention's 4 x 448 over 1504
     frames, both non-causal, and the decoder's 4 x 448 causal; bf16
     through tc to ``K2_NORM_TOL``, f32 through simt at the cross shape;
     forward and backward times beside the bound and SDPA;
 5d. K2 at deepseek-v3's training attention: 1 x 2048, 128 heads, q and k
     at 192, v at 128, through the simt route, f32 (to
     ``K2_F32_NORM_TOL``) and bf16 (to ``K2_NORM_TOL``), timed beside SDPA
     and the bound;
 5c. K2 at a (2,2,2) rank's attention (``K2_RANK_SHAPES``): 2 x 1024 q
     rows at positions 0 and 1024 over 2048 keys, 16/2 heads, causal,
     through tc, and gemma-2b's replicated-kv slice (4/1 heads of 256)
     through simt, against the plain version, timed beside SDPA with the
     same mask;
 5b. K2 at a 1d(4) rank's attention (``K2_BASE_SHAPES``): 2 x 2048 rows,
     8/1 heads, no offset, through tc, the same way;
  6. full-width two-layer tinyllama in f32 (K1's simt route) and in bf16
     (its tc and decode routes): CPU (plain versions) against the card
     (kernels), serving prefill and the first fused decode step's logits,
     then one f32 training step's loss and gradients (batch 2 x 512),
     also of the paper's model (d 48) and gemma-2b (d 256) cut to two
     layers, with K2's launches on the card counted;
  7. the serving run: ``repro_torch.launch.serve`` serves 8 requests of
     tinyllama-1.1b at full depth and width in bf16 (weights from a seed),
     with the kernels' launch counters reset just before and read after;
     no bf16 K1 GEMM and no bf16 K2 attention, forward or backward, may
     take the simt route, and the routes add up to the totals (also in
     phases 8 and 13);
 7p. the prefix cache: the same 8 requests served twice on one engine with
     ``prefix_cache=True`` (tails prefill through ``transformer.extend``
     over the gathered view); the warm pass must hit 8 times, and its
     TTFT is printed beside phase 7's; bf16 prints the share of tokens
     equal to the plain engine's, and full-width tinyllama cut to 4 layers
     in f32 (4 requests x 8 new tokens) must give the plain engine's
     tokens on both passes;
 7g. the gather-view decode (``fused_decode=False``): the same requests,
     every decode attention K4 split over the gathered views under the
     identity table (exact launches), and the f32 4-layer check;
 7s. speculative decoding, γ = 4, with the target itself and the target
     cut to its first 20 of 22 layers as drafts: accepted drafts, the
     verified chains by outcome (the cut draft must see chains rejected
     in their middle), tok/s and K4's launches by path (every one the
     draft's contiguous decode, exact), every request complete with finite
     logits in bf16, and the f32 4-layer check with the target and its
     first 3 layers as drafts, the latter with mid-chain rejections;
 7z. zamba2-1.2b served at full depth and width in bf16 through
     ``repro_torch.launch.serve``: 8 requests in batch 8, prompts of 43-47
     tokens fed one a step, 32 new tokens, max_len 512; the launches per
     step exact (``Z_SERVE_STEP``: K1 decode route, K3, K4 split with its
     combine for each of the 6 shared-block uses, no K2 or K5), then TTFT,
     TPOT and tok/s beside the step's bound on average over the run
     (weights, the f32 state and conv tails read and written, the kv
     entries K4 attends); then one decode step on the same engine's
     weights broken down by kernel group under torch.profiler, with the
     device's idle share;
  8. the training run: ``repro_torch.launch.train`` trains tinyllama-1.1b at
     full depth and width in bf16 (batch 4 x 2048, remat, AdamW, synthetic
     tokens from seed 0) for a few steps, counters reset before and read
     after; every loss must be finite and the launches as expected;
  9. where the time of one such training step goes: torch.profiler's
     device time by kernel group, and the device's idle share;
 10. K1 at training shapes: the tc route against the plain version at
     every GEMM shape of a tinyllama, a zamba2, a mixtral (2 layers) and
     a Moonlight ([dense, moe]) training step (Moonlight's 11264-wide
     dense layer, its 2816-wide shared experts and its 163840-word head
     among them) and a deepseek-v3 ([dense, moe] with the mtp head, 1 x
     2048: ``DS_TRAIN_GEMMS`` and its 129280-word head in chunks of 512),
     a whisper (``W_TRAIN_GEMMS``: the encoder's linears and the cross
     k/v over 4 x 1504 frame rows, the decoder's and the 51872-word head
     over 4 x 448) and an internvl2 step (``V_TRAIN_GEMMS``, its 92560-word
     head in 2 chunks), each step's GEMMs summing to its K1 launches where
     the script counts them; then the route, the simt kernel, the plain
     version and ``torch.matmul`` summed over the GEMMs of one step of
     each;
 11. K5 SSD scan forward and backward against their plain versions at
     zamba2's training shape (4 x 2048, 64 heads of 64, 2 groups, d_state
     64, chunk 256), bf16 and f32 B/C, a ragged T (a chunk of 250 steps),
     a strongly negative log-decay, each within its scaled limit and
     ``K5_NORM_TOL``, and two backward runs that must give the same bits;
 12. full-width zamba2 cut to [mamba, mamba, attn] in f32: one training
     step's loss and gradients, CPU (plain versions) against the card;
 12s. the same model through the decode path: a 16-token sequential
     prefill and 8 greedy steps of 2 slots, the logits within 1e-4 of 1 +
     max at every step and the same greedy tokens, CPU against the card;
 13. the zamba2 training run: ``repro_torch.launch.train`` trains
     zamba2-1.2b at full depth and width in bf16 (batch 4 x 2048, remat,
     AdamW, synthetic tokens from seed 0), counters reset before and read
     after; every loss finite and the launches exact;
 14. where the time of one zamba2 training step goes (as phase 9);
 15. K1 against ``torch.matmul`` summed over each path's GEMMs;
 16. full-width xlstm-350m cut to [mlstm, slstm] in f32: one training
     step's loss and every gradient leaf (1 x 512, two mLSTM chunks),
     CPU (plain versions) against the card, K1 and K3 launches exact;
 16s. the same model through the decode path from a fresh cache: a
     16-token sequential prefill and 8 greedy steps of 2 slots, the
     logits within 1e-4 of 1 + max at every step, the same tokens;
 7x. xlstm-350m served at full depth and width in bf16 through
     ``repro_torch.launch.serve`` as 7z serves zamba2 (8 requests,
     prompts of 43-47 tokens fed one a step, 32 new tokens): launches per
     step exact (``X_SERVE_STEP``: K1 decode route, K3; no K2, K4, K5),
     TTFT, TPOT and tok/s beside the step's bytes bound
     (``xlstm_step_bytes``: the weights and the f32 mLSTM/sLSTM state
     read and written);
 17. the xlstm training run: ``repro_torch.launch.train`` trains
     xlstm-350m at full depth and width in bf16 (batch 4 x 2048, remat,
     AdamW), launches exact (``X_LAUNCHES``), step time, tok/s, MFU (the
     reference's SSM formula, which undercounts) and peak memory;
 18. one xlstm training step at 4 x 256 under torch.profiler (as phase
     9), then one mLSTM and one sLSTM block timed at 4 x 2048: forward,
     forward + backward, and both under remat as the step runs them, and
     their share of phase 17's step;
 19. the checkpoint round trip at full width and depth (xlstm-350m, 2 x
     256): the train launcher saves step 2, resumes from it (every leaf
     bit for bit what was saved) and saves step 4, and the serve launcher
     restores step 4 (bit for bit) and serves;
 20. full-width moonshot-v1-16b-a3b (Moonlight) cut to [dense, moe] in
     f32, which runs every branch of ``models/moe.py`` (64 experts top-6,
     2 shared experts, the dense first layer of 11264, the 163840-word
     head): one training step at 1 x 256, capacity 30 a expert so that
     choices drop; CPU (plain versions) against the card (kernels): the
     loss, aux and every gradient leaf within 1e-4, the same choices
     dropped, launches exact;
 20s. the same model through the paged engine: a 16-token chunked
     prefill and 8 greedy fused decode steps of 2 slots, the logits
     within 1e-4 of 1 + max at every step and the same tokens, CPU
     against the card, launches exact;
 7m. mixtral-8x7b served through ``repro_torch.launch.serve`` at full
     width in bf16, cut to ``MIX_SERVE_LAYERS`` (16) of its 32 layers,
     with phase 7's traffic: launches per step exact (K1 tc and decode,
     K2 tc, K3, K4 split with its combine; no simt), the share of routed
     choices dropped at capacity per step, TTFT, TPOT and tok/s beside a
     decode step's bytes bound (``mixtral_step_bytes``: every expert's
     weights, the attention's, the head, the kv K4 reads), peak memory;
 21. the mixtral training run: ``repro_torch.launch.train`` at full
     width cut to 2 layers, bf16, 4 x 2048, remat, AdamW, 3 steps:
     launches exact (``MIX_LAUNCHES``), losses finite, step time, tok/s,
     MFU (the reference's formula, active parameters) and peak memory;
 22. one such step under torch.profiler, device time by group: K1, K2,
     K3, the experts' ``torch.matmul`` (the kernels ``aten::bmm``
     launched), the other ``torch.matmul``, the dispatch and combine
     (sorts, index and scatter ops), AdamW (the train step's "optimizer"
     range), the rest, and the device's idle share;
 23. full-width deepseek-v3-671b cut to [dense, moe] with 16 routed
     experts (top 8, the shared one, MLA, the mtp head) in f32: one
     training step at 1 x 128, the kernels against their plain versions
     on the card (``plain_kernels``): loss, xent, aux, mtp and every
     gradient leaf within 1e-4, the same choices dropped, launches exact
     (``DS_LAUNCHES``);
 23s. the same model through the paged engine: a 16-token chunked
     prefill and 8 greedy fused decode steps of 2 slots (K4 simt on the
     latent pool), the logits within 1e-4 of 1 + max at every step and
     the same tokens, kernels against plain versions; the gather-view
     decode's tokens equal;
 7d. deepseek-v3-671b served through ``repro_torch.launch.serve`` at full
     width in bf16, cut to its 3 dense layers and one MoE layer of 256
     experts, with phase 7's traffic: launches per step exact (K1 tc and
     decode, K2 and K4 simt), the routed choices dropped, TTFT, TPOT and
     tok/s beside a decode step's bytes bound (``deepseek_step_bytes``),
     peak memory; one decode step of that run under torch.profiler by
     group (K1, K3, K4, the absorbed einsums, the experts' bmm, dispatch
     and combine) with the idle share; and the gather-view decode's share
     of equal tokens;
 24. the deepseek training run: ``repro_torch.launch.train`` at full
     width cut to [dense, moe] with 16 routed experts and the mtp head,
     bf16, 1 x 2048, remat, AdamW, 3 steps: launches exact, xent, aux and
     mtp by step, step time, tok/s, MFU and peak memory;
 25. one such step under torch.profiler, device time by group (as 22;
     each kernel in exactly one group);
 26. full-width whisper-medium cut to 2 encoder and 2 decoder layers over
     all 1504 frames, f32: one training step's loss and every gradient
     leaf (1 x 128 text tokens), CPU (plain versions) against the card,
     K1 and K2 launches exact (simt);
 26s. the same model through the decode path with each layer's cross k/v
     filled from the encoder (``encdec.encoder_kv``): 8 prompt tokens fed
     one a step and 8 greedy steps of 2 slots, the logits within 1e-4 of
     1 + max, the same tokens, K1 and K4 launches exact;
 7w. whisper-medium served at full depth and width in bf16 through
     ``repro_torch.launch.serve`` with 7z's traffic: launches per step
     exact (``W_SERVE_STEP``: K1 decode route, K4 split with its combine
     for each block's self and cross attention; no K2, K3), TTFT, TPOT
     and tok/s beside a decode step's bytes bound (``state_step_bytes``:
     the decoder's weights, the self kv, the cross k/v), peak memory;
 27. the whisper training run: ``repro_torch.launch.train`` at full width
     and depth, bf16, 4 x 448 text tokens and 1504 frames a row, remat,
     AdamW, 3 steps: launches exact (``W_LAUNCHES``), step time, tok/s
     (text tokens), MFU (the reference's formula, which leaves out the
     encoder) and peak memory; 27p, one such step under torch.profiler by
     kernel group, the kernels outside K1-K5 and the library's GEMMs
     grouped by the op that launched them (``launching_op_group``), then
     3 steps without the profiler timed by the wall clock and by the
     process's CPU time;
 7v. internvl2-2b served as 7w (``V_SERVE_STEP``: K1, K3, K4 split; the
     state path feeds the prompt's text one token a step, no patches);
 28. the internvl2 training run: 4 x 2048 (1024 patch embeddings and 1024
     text tokens a row), remat, AdamW, 3 steps, launches exact
     (``V_LAUNCHES``); 28p, one such step profiled and timed as 27p.
 29. the paper's cube across ranks, 8 ranks sharing the one card over
     gloo, every collective staged through the host (NCCL refuses two
     ranks on a device; the times are no measure of the paper's
     communication claim): tinyllama-1.1b cut to 2 layers at full width
     in f32, 4 x 512, one forward and backward on 8 ranks at (2,2,2) and
     at dp2 x (2,2,1) (``RANK_LAYOUTS``), and in the same world at pp2 x
     (1,2,2) with 4 microbatches (``PP_LAYOUTS``: one layer a stage, the
     activations crossing by send/recv), and again at (2,2,2) and pp2
     with each 3-D island in ``OVERLAP_CHUNKS`` chunks (async-TP,
     ``OVERLAP_LAYOUTS``), against one rank on the card: the loss and
     every rank's gradient shard within 1e-4 of each leaf's largest
     value (a stage's slab against the one-rank leaf re-cut by
     ``repartition_stack``);
     Then, in the same world, Moonlight cut to [dense, moe] at full
     width (64 experts of 1408, 2 shared, vocab 163840) in f32, 4 x 512,
     at (2,2,2) and dp2 x (2,2,1) (``R29M_LAYOUTS``; expert parallelism,
     ep ('x', 'y') and ('dp', 'x', 'y')) at capacity factor
     ``R29M_CF``, held the same way to its one-rank run, no choice
     dropped on one rank or a rank (asserted: a rank's capacity is its
     own tokens', so a drop would differ by design), its all-to-all
     bytes a rank printed;
 30r. phase 8's run cut to ``RANK_TRAIN_LAYERS`` (2 of 22) layers,
     ``RANK_STEPS`` (2) steps: the losses that 30 and 33 are held to;
     and Moonlight cut to [dense, moe] the same way (``moon_launches``),
     the losses that 30's Moonlight run is held to;
 30. ``repro_torch.launch.train`` under torchrun, 8 ranks at each layout:
     tinyllama-1.1b at full width in bf16, cut to ``RANK_TRAIN_LAYERS``
     layers, 4 x 2048,
     remat, AdamW (at dp2 on ZeRO-1 shards, the launcher's default),
     ``RANK_CUT_STEPS`` (1) step, its loss within 3e-2 of 30r's, and
     Moonlight's [dense, moe] cut at (2,2,2) for 2 steps against 30r's
     Moonlight run, the choices dropped printed; each rank's
     K1/K2/K3 launches exact (``rank_train_launches``: K3 in its two
     phases where 'z' splits the hidden dim), every K1 and K2 launch on
     tc; each rank's step time, tokens/s, peak memory and collective
     bytes a step (``core/comm.py``'s counter); at (2,2,2) the launcher
     runs again with ``--overlap --overlap-chunks 4`` ("overlap": K1 once
     a chunk, ``chunked_k1``).  The runs of 30, 37 and 33 are one
     torchrun world of 8 ranks, the launcher called once a run
     (``phase_ranks_train``);
 31. the paper's 1-D and 2-D baselines at 1d(4) and 2d(q2)
     (``BASE_LAYOUTS``, ``tests/test_multidev.py:68-69``), 8 ranks
     sharing the card over gloo: phase 29's f32 two-layer model, the loss
     within 1e-4 of one rank's, every gradient shard within 1e-4 of its
     leaf's max against one rank's at 1d and against the same layout on
     the machine's CPU ranks at 2d (ROADMAP Queue 3 fault 6: neither
     package's 2-D gradient is one rank's);
 32. the comm check (``repro_torch.obs.commcheck``) at the reference's
     defaults (paper-transformer, d_ff = d_model, vocab 4096, 12 x 512,
     bf16; 2 layers of its 4, to fit the time limit): the 1d and 3d plans of 8 ranks in 31's world, the
     2d plan of 4 under torchrun; measured and analytic bytes per plan,
     the measured ordering 3d < 2d < 1d;
 33. phase 30 at 1d(4) and 2d(q2), ``RANK_CUT_STEPS`` (1) step: the
     loss within 3e-2 of 30r's (the 2-D one drifts after its first step:
     fault 6);
 34. ZeRO 0, 1 and 2 across ranks (``rank_zero``): phase 30's dp2 x
     (2,2,1) layout on 8 ranks, tinyllama-1.1b cut to
     ``RANK_TRAIN_LAYERS`` layers, bf16,
     ``ZERO_B`` x 2048, 2 microbatches, ``ZERO_STEPS`` (1) step a stage
     from one seed:
     the stages' losses and gnorms within 1e-2 of one another, launches
     exact, every rank's moment bytes at stage 0 over stage 1 within
     ``ZERO_RATIO``, stage 2's f32 accumulation on the ZeRO blocks
     (counted from their specs); step time and peak memory a rank;
 35. checkpoints across layouts: 34's stage-1 state saved (every rank's
     shards bit for bit the files), restored at dp4 x (1,1,2) on the
     same 8 ranks (every leaf bit for bit), then resumed by
     ``repro_torch.launch.train --ckpt-dir`` at dp 4 (4 ranks, the model
     whole) under torchrun and on one rank: the next step's loss within
     1e-2 of the dp2 run's on both;
 36. Adafactor on one card: phase 8's run under ``--optimizer
     adafactor`` beside its AdamW (step time, peak memory, the state's
     bytes, the optimizer range's device time in one profiled step of
     each), then mixtral-8x7b cut to ``ADA_MIX_LAYERS`` (4) layers, 3
     steps, the depth whose AdamW moments alone would take 48.6 GB;
 37. pipeline stages: phase 30 at pp2 x (1,2,2) (``PP_LAYOUTS``,
     ``--pp 2 --microbatch 4``), one of the 2 layers a stage,
     ``RANK_CUT_STEPS`` (1) step: its loss within 3e-2 of 30r's, each rank's K1/K2/K3 launches exact
     for its stage (``rank_train_launches``: the head and ``ln_f`` on the
     last stage, 4 microbatches a step), every K1 and K2 launch on tc;
     each rank's step time, peak memory and bytes a step by kind, the
     stage boundary's ``collective-permute`` among them;
 38. the dry run (``repro_torch.launch.dryrun``): ``python -m
     repro_torch.launch.dryrun --arch all --shape train_4k``, started in
     a subprocess of its own on the CPU (no card visible, one thread)
     right after phase 1 and read here, every line printed, exit 0, no
     FAIL and an OK line (a trace at 256 ranks) for each arch the port
     trains above one device (``DRY_TRACED``); then, with no new training
     run, the trace (``dryrun.trace_step``) at the plan, depth, batch and
     dtype of each launcher run of 30, 33 and 37 predicts its rank's
     collective bytes and counts a step by kind exactly (at pp 2 each
     stage's first rank), the memory model's ``opt`` line at phase 34's
     dp2 x (2,2,1) plans is within ``DRY_TOL`` of the moment bytes each
     rank measured at each ZeRO stage, and its ``param`` line within
     ``DRY_TOL`` of what ``torch.cuda.memory_allocated`` grew by while
     the launcher built the parameters in 30r (each rank of 30's runs
     likewise).

The lines before the last carry one JSON object of the serving paths'
numbers (7p, 7g, 7s, 7z, 7x), one of xlstm's training numbers (17, 18,
19), one of the MoE family's (7m, 21, 22), one of deepseek's (7d, 24,
25), one of the modality families' (7w, 27, 7v, 28), one of the cube
across ranks (29, 30), one of the baselines across ranks (31, 32, 33),
one of ZeRO and the checkpoints across layouts (34, 35), one of
Adafactor (36), one of the dry run (38), one of per-kernel numbers and
the card's name and
power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero and
prints no result.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

# tinyllama-1.1b (configs/tinyllama_1_1b.py)
D, NQ, NKV, DH, FF, VOCAB, LAYERS = 2048, 32, 4, 64, 5632, 32000, 22
# (name, K, N, launches per layer) of the decode step's GEMMs; the LM head
# runs once per step
LAYER_GEMMS = [("wq,wo", D, NQ * DH, 2), ("wk,wv", D, NKV * DH, 2),
               ("w_up,w_gate", D, FF, 2), ("w_down", FF, D, 1)]
HEAD_GEMM = ("head", D, VOCAB, 1)
DECODE_M, PREFILL_M = 8, 8 * 512     # batch 8; prefill pads 259-263 -> 512
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5    # the training run (phase 8)
# launches per training step: K1 runs the 7 linears of each layer twice
# (forward and its recompute under remat) and the head's 2 loss chunks
# twice; K2 runs each layer's attention forward twice and backward once;
# K3 the 2 norms of each layer twice and ln_f once, backward once each


def step_launches(layers, head=True):
    """One tinyllama-1.1b training step's launches at ``layers`` deep
    (``head=False``: a pipeline stage's without ``ln_f`` and the head)."""
    h = int(head)
    return {"K1": 2 * 7 * layers + 2 * 2 * h, "K2": 2 * layers,
            "K2 bwd": layers, "K3": 2 * 2 * layers + h,
            "K3 bwd": 2 * layers + h, "K5": 0, "K5 bwd": 0}


TRAIN_LAUNCHES = step_launches(LAYERS)
# training GEMMs of tinyllama: (name, K, N, launches per step), forward and
# its recompute; the head runs in 2 chunks of 4 x 1024 rows
TRAIN_GEMMS = [("wq,wo", D, NQ * DH, 2 * 2 * LAYERS),
               ("wk,wv", D, NKV * DH, 2 * 2 * LAYERS),
               ("w_up,w_gate", D, FF, 2 * 2 * LAYERS),
               ("w_down", FF, D, 2 * LAYERS)]

# zamba2-1.2b (configs/zamba2_1_2b.py): 38 Mamba2 layers (d_inner 4096,
# 64 SSM heads of 64, 2 groups, d_state 64, chunk 256, conv 4) and one shared
# attention block (32/32 heads, gated-GELU MLP of 8192) after every 6
Z_LAYERS, Z_SHARED, Z_FF = 38, 6, 8192
Z_HEADS, Z_WINDOW = 32, 4096      # the shared block's attention: 32/32 heads
Z_DIN, Z_NH, Z_G, Z_N, Z_CHUNK, Z_CONV = 4096, 64, 2, 64, 256, 4
Z_STEPS = 4
# launches per zamba2 training step: K1 runs the 5 linears of each Mamba
# layer, the 7 of each shared-block use and the 2 head chunks twice
# (forward and remat recompute); K3 the 2 norms of each Mamba layer and of
# each shared-block use twice and ln_f once, backward once each; K2 the 6
# shared attentions and K5 the 38 scans twice forward, once backward
Z_LAUNCHES = {"K1": 2 * (5 * Z_LAYERS + 7 * Z_SHARED + 2),
              "K2": 2 * Z_SHARED, "K2 bwd": Z_SHARED,
              "K3": 2 * (2 * Z_LAYERS + 2 * Z_SHARED) + 1,
              "K3 bwd": 2 * Z_LAYERS + 2 * Z_SHARED + 1,
              "K5": 2 * Z_LAYERS, "K5 bwd": Z_LAYERS}
Z_GEMMS = [("w_x,w_z", D, Z_DIN, 2 * 2 * Z_LAYERS),
           ("w_bc", D, 2 * Z_G * Z_N, 2 * Z_LAYERS),
           ("w_dt", D, Z_NH, 2 * Z_LAYERS),
           ("w_out", Z_DIN, D, 2 * Z_LAYERS),
           ("wq,wk,wv,wo", D, D, 2 * 4 * Z_SHARED),
           ("w_up,w_gate", D, Z_FF, 2 * 2 * Z_SHARED),
           ("w_down", Z_FF, D, 2 * Z_SHARED)]
# zamba2's decode step (phase 7z) runs the same GEMMs at M = 8 on the
# decode route, and its head
Z_DECODE_GEMMS = [(name, k, n) for name, k, n, _ in Z_GEMMS] + \
    [("head", D, VOCAB)]

# xlstm-350m (configs/xlstm_350m.py, arXiv:2405.04517): 24 layers, 21
# mLSTM blocks (d_in 2048, 4 heads of 512, an f32 C of 4 x 512 x 512 a
# slot) and 3 sLSTM blocks (4 heads of 256, R 4 x 4 x 256 x 256), d_model
# 1024, vocab 50304
X_D, X_DIN, X_NH, X_VOCAB, X_MLSTM, X_SLSTM = 1024, 2048, 4, 50304, 21, 3
# 2 steps, the first a warm-up: the script's time limit binds
X_STEPS = 2
# (name, K, N) of its GEMMs, run at a decode step's M = 8 and a training
# step's M = 8192 in phase 2; w_if's N = 8 (the input and forget gates of
# 4 heads) is narrower than one 64-column tile
X_GEMMS = [("w_q,w_k,w_v,w_z", X_D, X_DIN), ("w_if", X_D, 2 * X_NH),
           ("w_gates", X_D, 4 * X_D), ("slstm w_out", X_D, X_D),
           ("mlstm w_out", X_DIN, X_D), ("head", X_D, X_VOCAB)]
# launches per xlstm training step: K1 runs the 6 linears of each mLSTM
# block, the 2 of each sLSTM block and the head's 2 loss chunks twice
# (forward and remat recompute); K3 the 2 norms of each mLSTM block and
# the 1 of each sLSTM block twice and ln_f once, backward once each
X_LAUNCHES = {"K1": 2 * (6 * X_MLSTM + 2 * X_SLSTM + 2), "K2": 0,
              "K2 bwd": 0, "K3": 2 * (2 * X_MLSTM + X_SLSTM) + 1,
              "K3 bwd": 2 * X_MLSTM + X_SLSTM + 1, "K5": 0, "K5 bwd": 0}
# xlstm served (phase 7x): every step a decode step; K1 the 8 kinds of
# linear above once and the head, K3 each norm once and ln_f
X_SERVE_STEP = {"K1": 6 * X_MLSTM + 2 * X_SLSTM + 1, "K2": 0, "K2 bwd": 0,
                "K3": 2 * X_MLSTM + X_SLSTM + 1, "K3 bwd": 0, "K4": 0,
                "K4 combine": 0, "K5": 0, "K5 bwd": 0}
# the checkpoint round trip (phase 19) trains at full width and depth on
# sequences of this length: it checks bits, not speed
X_CKPT_B, X_CKPT_S = 2, 256

# mixtral-8x7b (configs/mixtral_8x7b.py, arXiv:2401.04088): 32 layers of
# 32/8 heads of 128 (window 4096) and 8 experts (top 2) of 14336, d_model
# 4096, vocab 32000.  Its 32 layers are 93.4 GB in bf16: it serves cut to
# the 16 that leave more than 10 GB of an 80 GB card free (phase 7m) and
# trains cut to 2 with AdamW (phase 21)
MIX_D, MIX_NQ, MIX_NKV, MIX_DH, MIX_FF, MIX_E = 4096, 32, 8, 128, 14336, 8
MIX_VOCAB, MIX_WINDOW = 32000, 4096
MIX_SERVE_LAYERS, MIX_TRAIN_LAYERS, MIX_STEPS = 16, 2, 3
# its K1 GEMMs (name, K, N): the attention's; the experts' products and
# the router are torch.matmul (models/moe.py)
MIX_GEMMS = [("wq,wo", MIX_D, MIX_NQ * MIX_DH), ("wk,wv", MIX_D,
                                                   MIX_NKV * MIX_DH),
             ("head", MIX_D, MIX_VOCAB)]
# mixtral served (phase 7m), per step: K1 the 4 attention linears of each
# layer and the head, K3 the 2 norms of each layer and ln_f; a prefill
# step adds K2 for each layer, a decode step K4 (with its combine)
MIX_SERVE_STEP = {"K1": 4 * MIX_SERVE_LAYERS + 1, "K2 bwd": 0,
                  "K3": 2 * MIX_SERVE_LAYERS + 1, "K3 bwd": 0, "K5": 0,
                  "K5 bwd": 0}
# launches per mixtral training step (phase 21), as TRAIN_LAUNCHES counts
# them: 4 linears a layer and the head's 2 chunks twice, K2 twice forward
# and once backward, K3 the 2 norms twice and ln_f once
MIX_LAUNCHES = {"K1": 2 * 4 * MIX_TRAIN_LAYERS + 2 * 2,
                "K2": 2 * MIX_TRAIN_LAYERS, "K2 bwd": MIX_TRAIN_LAYERS,
                "K3": 2 * 2 * MIX_TRAIN_LAYERS + 1,
                "K3 bwd": 2 * MIX_TRAIN_LAYERS + 1, "K5": 0, "K5 bwd": 0}
# moonshot-v1-16b-a3b (configs/moonshot_v1_16b_a3b.py, Moonlight-16B-A3B):
# 16/16 heads of 128, d_model 2048, a dense first layer of 11264, then 64
# experts (top 6) of 1408 and 2 shared ones (one MLP of 2816), vocab
# 163840.  Phases 20 and 20s run it cut to [dense, moe] in f32; its K1
# GEMMs (name, K, N, launches in one forward of that cut) are checked at
# every bf16 shape in phases 2 and 10
MOON_D, MOON_NH, MOON_DH, MOON_VOCAB = 2048, 16, 128, 163840
MOON_GEMMS = [("wq,wk,wv,wo", MOON_D, MOON_NH * MOON_DH, 8),
              ("dense w_up,w_gate", MOON_D, 11264, 2),
              ("dense w_down", 11264, MOON_D, 1),
              ("shared w_up,w_gate", MOON_D, 2816, 2),
              ("shared w_down", 2816, MOON_D, 1),
              ("head", MOON_D, MOON_VOCAB, 1)]


# ---------------------------------------------------------------------------
# The modality families: whisper-medium (the encoder-decoder) and
# internvl2-2b (the VLM frontend)
# ---------------------------------------------------------------------------
# whisper-medium (configs/whisper_medium.py, arXiv:2212.04356): a 24-layer
# encoder over 1504 frames and 24 decoder blocks (self attention, cross
# attention over the encoder's states, a gelu_mlp of 4096), d_model 1024,
# 16/16 heads of 64, LayerNorm (PyTorch; K3 is RMSNorm's), vocab 51872.
# Phase 27 trains it on 448 text tokens a row
W_D, W_NH, W_DH, W_FF, W_VOCAB = 1024, 16, 64, 4096, 51872
W_LAYERS, W_ENC, W_FRAMES, W_TEXT, W_STEPS = 24, 24, 1504, 448, 3
# launches per whisper training step: K1 runs the encoder blocks' 6
# linears, the decoder blocks' 10 (self q/k/v/o, cross q/k/v/o, MLP up and
# down) and the head's one loss chunk twice (forward and remat
# recompute); K2 each encoder block's attention and each decoder block's
# two twice forward and once backward; no K3 (LayerNorm)
W_LAUNCHES = {"K1": 2 * (6 * W_ENC + 10 * W_LAYERS + 1),
              "K2": 2 * (W_ENC + 2 * W_LAYERS),
              "K2 bwd": W_ENC + 2 * W_LAYERS, "K3": 0, "K3 bwd": 0,
              "K5": 0, "K5 bwd": 0}
# whisper served (phase 7w), per decode step: K1 each block's self q/k/v/o,
# cross q and o and MLP (the cross k/v are the cache's) and the head; K4
# the self attention and the cross attention of each block, each with its
# combine pass
W_SERVE_STEP = {"K1": 8 * W_LAYERS + 1, "K2": 0, "K2 bwd": 0, "K3": 0,
                "K3 bwd": 0, "K4": 2 * W_LAYERS,
                "K4 combine": 2 * W_LAYERS, "K5": 0, "K5 bwd": 0}
# internvl2-2b (configs/internvl2_2b.py, arXiv:2404.16821): 24 dense
# layers of 16/8 heads of 128, SwiGLU of 8192, d_model 2048, vocab 92560,
# 1024 patch embeddings ahead of the text; trained 4 x 2048 (1024 patches
# + 1024 text tokens), the head in 2 loss chunks
V_D, V_NQ, V_NKV, V_DH, V_FF, V_VOCAB = 2048, 16, 8, 128, 8192, 92560
V_LAYERS, V_PATCHES, V_STEPS = 24, 1024, 3
V_LAUNCHES = {"K1": 2 * 7 * V_LAYERS + 2 * 2, "K2": 2 * V_LAYERS,
              "K2 bwd": V_LAYERS, "K3": 2 * 2 * V_LAYERS + 1,
              "K3 bwd": 2 * V_LAYERS + 1, "K5": 0, "K5 bwd": 0}
V_SERVE_STEP = {"K1": 7 * V_LAYERS + 1, "K2": 0, "K2 bwd": 0,
                "K3": 2 * V_LAYERS + 1, "K3 bwd": 0, "K4": V_LAYERS,
                "K4 combine": V_LAYERS, "K5": 0, "K5 bwd": 0}
# K2 at whisper's attention shapes (phase 5w): (label, batch, q length,
# k length, causal), 16/16 heads of 64
K2_WHISPER = [("whisper encoder", 4, W_FRAMES, W_FRAMES, False),
              ("whisper cross", 4, W_TEXT, W_FRAMES, False),
              ("whisper decoder", 4, W_TEXT, W_TEXT, True)]
# K4 over whisper's static cross k/v (phase 3w): 8 slots, every one of the
# 1504 frames valid (positions arange(F), cur F - 1), the identity table
K4_CROSS = [("whisper cross", [W_FRAMES - 1] * 8, W_FRAMES, W_NH, W_NH, 0)]
# whisper's and internvl2's K1 GEMMs.  A decode step (phases 7w, 7v; M = 8,
# the decode route): (name, K, N); whisper's runs its self attention's
# four projections and the cross attention's wq and wo at d x d
W_DECODE_GEMMS = [("wq,wk,wv,wo", W_D, W_NH * W_DH), ("w_up", W_D, W_FF),
                  ("w_down", W_FF, W_D), ("head", W_D, W_VOCAB)]
V_DECODE_GEMMS = [("wq,wo", V_D, V_NQ * V_DH), ("wk,wv", V_D, V_NKV * V_DH),
                  ("w_up,w_gate", V_D, V_FF), ("w_down", V_FF, V_D),
                  ("head", V_D, V_VOCAB)]
# a training step (phases 27, 28; the tc route): (name, rows, K, N,
# launches a step, forward and remat recompute), summing to W_LAUNCHES and
# V_LAUNCHES.  Whisper's encoder linears and the cross attention's wk and
# wv run over the 4 x 1504 frames, the decoder's other linears and the
# head (one loss chunk) over the 4 x 448 text rows; internvl2's linears
# over 4 x 2048 rows and its head in 2 chunks of 4 x 1024
W_ENC_M, W_DEC_M = TRAIN_B * W_FRAMES, TRAIN_B * W_TEXT
W_TRAIN_GEMMS = [("encoder wq,wk,wv,wo", W_ENC_M, W_D, W_D, 2 * 4 * W_ENC),
                 ("encoder w_up", W_ENC_M, W_D, W_FF, 2 * W_ENC),
                 ("encoder w_down", W_ENC_M, W_FF, W_D, 2 * W_ENC),
                 ("self wq,wk,wv,wo, cross wq,wo", W_DEC_M, W_D, W_D,
                  2 * 6 * W_LAYERS),
                 ("cross wk,wv", W_ENC_M, W_D, W_D, 2 * 2 * W_LAYERS),
                 ("w_up", W_DEC_M, W_D, W_FF, 2 * W_LAYERS),
                 ("w_down", W_DEC_M, W_FF, W_D, 2 * W_LAYERS),
                 ("head", W_DEC_M, W_D, W_VOCAB, 2)]
V_M = TRAIN_B * TRAIN_S
V_TRAIN_GEMMS = [("wq,wo", V_M, V_D, V_NQ * V_DH, 2 * 2 * V_LAYERS),
                 ("wk,wv", V_M, V_D, V_NKV * V_DH, 2 * 2 * V_LAYERS),
                 ("w_up,w_gate", V_M, V_D, V_FF, 2 * 2 * V_LAYERS),
                 ("w_down", V_M, V_FF, V_D, 2 * V_LAYERS),
                 ("head", V_M // 2, V_D, V_VOCAB, 2 * 2)]


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def capture_stream():
    """The one side stream every graph is captured on: cuBLAS keeps a
    workspace for each stream it has run on, so a stream per capture
    would hold 32 MiB each for the rest of the run."""
    import torch
    return torch.cuda.Stream()


def graph_ms(fn, reps):
    """Mean device time of ``fn`` with the host taken out: ``reps`` calls
    captured in one CUDA graph, replayed between CUDA events (after one
    warm-up call and one warm-up replay)."""
    import torch
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got, want):
    """max |got - want| / (1 + |want|), elementwise, in f32."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (1 + w.abs())).max().item()


def scaled_err(got, want):
    """max |got - want| / (1 + max |want|), in f32: for gradients, whose
    entries span many magnitudes."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / (1 + w.abs().max())).item()


def leaf_err(got, want):
    """max |got - want| / max |want|, in f32: one gradient leaf against
    its own scale."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


# An empty kernel, built beside the port's kernels (into the ignored
# build/ directory, not into the port): the launch floor that K4's times
# are read against in phase 3.
EMPTY_KERNEL = """#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
EMPTY_LIB = ROOT / "build" / "chip_smoke" / "empty_kernel.so"


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    EMPTY_LIB.parent.mkdir(parents=True, exist_ok=True)
    src = EMPTY_LIB.with_suffix(".cu")
    src.write_text(EMPTY_KERNEL)
    empty = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(EMPTY_LIB), str(src)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        logs = _build.build()
    finally:
        text = empty.communicate()[0]
    check(empty.returncode == 0, f"the empty kernel did not build:\n{text}")
    print(f"[1] built {sorted(logs) or 'nothing (up to date)'} and the "
          f"empty kernel in {time.perf_counter() - t0:.1f}s")
    for name, text in sorted(logs.items()):
        kernel = "?"
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = demangle(entry.group(1))
            elif "Used" in line or "spill" in line:
                print(f"    {name}: {kernel}: {line.strip()}")


def demangle(symbol: str) -> str:
    """A kernel's name and template arguments from its mangled symbol, by
    c++filt where the toolkit's host compiler brought it, else the
    symbol."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    if not out or out == symbol:
        return symbol
    out = out.replace("(anonymous namespace)::", "").split("(")[0]
    return out.removeprefix("void ").strip()


def k1_inputs(gen, dev, m, k, n, dtype=None):
    import torch
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    b = torch.randn(n, generator=gen, device=dev)
    if dtype is not None:
        x, w, b = (t.to(dtype) for t in (x, w, b))
    return x, w, b


def k1_check(k1, x, w, b, force=None):
    """Worst (relative, absolute) error of K1 against its plain version over
    every activation, with and without bias."""
    worst, worst_abs = 0.0, 0.0
    for act in k1.ACTS:
        for bias in (None, b):
            got = k1.matmul(x, w, bias, act=act, force=force)
            want = k1.matmul_plain(x, w, bias, act=act)
            worst = max(worst, rel_err(got, want))
            worst_abs = max(worst_abs, abs_err(got, want))
    return worst, worst_abs


def k1_time(k1, dev, gen, m, k, n, reps, routes, with_plain=True,
            device=False):
    """Times of the bf16 product at the path's case (no bias, no
    activation): each named route forced, the plain version and
    ``torch.matmul``, as calls from the host (CUDA events around a loop of
    calls); with ``device``, also each route's and ``torch.matmul``'s
    device time (``graph_ms``: the same calls replayed from a CUDA graph),
    under keys ending in ``device_ms``.  The weights rotate over enough
    copies to exceed the 50 MB L2 cache, as a step finds them."""
    import torch
    copies = max(1, min(64, math.ceil(120e6 / (k * n * 2))))
    ws = [(torch.randn(k, n, generator=gen, device=dev)
           / math.sqrt(k)).to(torch.bfloat16) for _ in range(copies)]
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    it = iter(range(1 << 30))

    def pick():
        return ws[next(it) % copies]
    t = {}
    for name, r in routes.items():
        t[name] = time_ms(lambda: k1.matmul(x, pick(), force=r),
                          reps if r != "simt" else max(1, reps // 20))
    if with_plain:
        t["plain_ms"] = time_ms(lambda: k1.matmul_plain(x, pick()),
                                max(1, reps // 4))
    t["library_ms"] = time_ms(lambda: torch.matmul(x, pick()), reps)
    if device:
        for name, r in routes.items():
            if r != "simt":
                t[name[:-2] + "device_ms"] = graph_ms(
                    lambda: k1.matmul(x, pick(), force=r), reps)
        t["library_device_ms"] = graph_ms(lambda: torch.matmul(x, pick()),
                                          reps)
    t["bound_ms"], t["bound_by"] = bound_ms(
        2 * (m * k + k * n + m * n), 2 * m * n * k, H100_BF16_FLOPS)
    return t


def phase_k1(dev):
    """K1 at every GEMM shape of tinyllama-1.1b's decode step (M = 8) and
    prefill (M = 4096): f32 through the simt route, bf16 through both the
    tc and the decode route, each against the plain version; then the
    times of the route the path takes, of the other bf16 route, of the
    simt kernel (the first K1 design), the plain version and
    ``torch.matmul``."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(DECODE_M, k, n, name) for name, k, n, _ in
              LAYER_GEMMS + [HEAD_GEMM]]
    shapes += [(PREFILL_M, k, n, name) for name, k, n, _ in LAYER_GEMMS]
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    times, path_err = {}, {"tc": 0.0, "decode": 0.0}
    for m, k, n, name in shapes:
        path = k1.route(m, n, k, torch.bfloat16, True)
        check(path != "simt", f"K1 {name} ({m},{k},{n}) would take simt")
        cases = [(torch.float32, "simt"), (torch.bfloat16, "tc"),
                 (torch.bfloat16, "decode")]
        for dtype, force in cases:
            x, w, b = k1_inputs(gen, dev, m, k, n, dtype)
            worst, worst_abs = k1_check(k1, x, w, b, force)
            print(f"[2] K1 {name:12s} ({m},{k})@({k},{n}) {str(dtype)[6:]:8s}"
                  f" {force:6s} max rel err {worst:.2e} (tol "
                  f"{tol[dtype]:.0e}), max abs err {worst_abs:.2e}")
            check(worst <= tol[dtype], f"K1 {name} {dtype} {force}: {worst}")
            if dtype == torch.bfloat16 and force == path:
                path_err[path] = max(path_err[path], worst_abs)
        other = "tc" if path == "decode" else "decode"
        t = k1_time(k1, dev, gen, m, k, n, 60 if m == DECODE_M else 5,
                    {"ms": path, f"{other}_ms": other, "simt_ms": "simt"},
                    device=True)
        times[(m, name)] = t
        dm = t["device_ms"]
        print(f"    time bf16 ({m},{k})@({k},{n}), called from the host: "
              f"{path} {t['ms']:.4f} ms, {other} {t[other + '_ms']:.4f}, "
              f"simt {t['simt_ms']:.4f}, plain {t['plain_ms']:.4f}, "
              f"torch.matmul {t['library_ms']:.4f}; device (CUDA graph): "
              f"{path} {dm:.4f} ms ({2 * m * n * k / dm / 1e9:.1f} TFLOP/s, "
              f"{2 * k * n / dm / 1e6:.0f} GB/s of weight), {other} "
              f"{t[other + '_device_ms']:.4f}, torch.matmul "
              f"{t['library_device_ms']:.4f}; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    keys = ("ms", "device_ms", "simt_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms")
    step = dict.fromkeys(keys, 0.0)
    prefill = dict(step)
    for name, k, n, per_layer in LAYER_GEMMS:
        for key in keys:
            step[key] += LAYERS * per_layer * times[(DECODE_M, name)][key]
            prefill[key] += LAYERS * per_layer * times[(PREFILL_M, name)][key]
    for key in keys:
        step[key] += times[(DECODE_M, "head")][key]
        prefill[key] += times[(DECODE_M, "head")][key]
    for label, agg, m in (("decode step", step, DECODE_M),
                          ("prefill of 8x512", prefill, PREFILL_M)):
        flops = 2 * DECODE_M * D * VOCAB + sum(
            2 * m * k * n * LAYERS * per_layer
            for _, k, n, per_layer in LAYER_GEMMS)
        print(f"[2] K1 per {label} (155 launches, bf16): called from the "
              f"host {agg['ms']:.3f} ms, {agg['ms'] / agg['library_ms']:.2f}x "
              f"torch.matmul {agg['library_ms']:.3f} ms (target 1.5x, limit "
              f"3x); device {agg['device_ms']:.3f} ms ("
              f"{flops / agg['device_ms'] / 1e9:.2f} TFLOP/s), "
              f"{agg['device_ms'] / agg['library_device_ms']:.2f}x "
              f"torch.matmul {agg['library_device_ms']:.3f} ms; simt "
              f"{agg['simt_ms']:.3f} ms, plain {agg['plain_ms']:.3f} ms, "
              f"bound {agg['bound_ms']:.3f} ms")
    by = {times[(DECODE_M, name)]["bound_by"]
          for name, *_ in LAYER_GEMMS + [HEAD_GEMM]}
    step["bound_by"] = by.pop() if len(by) == 1 else "bytes and operations"
    by = {times[(PREFILL_M, name)]["bound_by"] for name, *_ in LAYER_GEMMS}
    prefill["bound_by"] = by.pop() if len(by) == 1 else \
        "bytes and operations"
    for name, k, n in Z_DECODE_GEMMS:
        path = k1.route(DECODE_M, n, k, torch.bfloat16, True)
        check(path == "decode", f"K1 zamba2 {name} ({DECODE_M},{k},{n}) "
              f"would take {path}, not decode")
        x, w, b = k1_inputs(gen, dev, DECODE_M, k, n, torch.bfloat16)
        worst, worst_abs = k1_check(k1, x, w, b, "decode")
        print(f"[2] K1 zamba2 {name:12s} ({DECODE_M},{k})@({k},{n}) bfloat16"
              f" decode max rel err {worst:.2e} (tol 1e-02), max abs err "
              f"{worst_abs:.2e}")
        check(worst <= 1e-2, f"K1 zamba2 {name} bf16 decode: {worst}")
        path_err["decode"] = max(path_err["decode"], worst_abs)
    for m in (DECODE_M, TRAIN_B * TRAIN_S):
        want = "decode" if m == DECODE_M else "tc"
        for name, k, n in X_GEMMS:
            path = k1.route(m, n, k, torch.bfloat16, True)
            check(path == want, f"K1 xlstm {name} ({m},{k},{n}) would take "
                  f"{path}, not {want}")
            x, w, b = k1_inputs(gen, dev, m, k, n, torch.bfloat16)
            worst, worst_abs = k1_check(k1, x, w, b, path)
            print(f"[2] K1 xlstm {name:15s} ({m},{k})@({k},{n}) bfloat16 "
                  f"{path:6s} max rel err {worst:.2e} (tol 1e-02), max abs "
                  f"err {worst_abs:.2e}")
            check(worst <= 1e-2, f"K1 xlstm {name} ({m}) bf16 {path}: "
                  f"{worst}")
            path_err[path] = max(path_err[path], worst_abs)
            del x, w, b
    # the decode steps of mixtral (phase 7m), Moonlight, whisper (7w) and
    # internvl2 (7v)
    for arch, gemms in (("mixtral", MIX_GEMMS),
                        ("moonlight", [g[:3] for g in MOON_GEMMS]),
                        ("whisper", W_DECODE_GEMMS),
                        ("internvl2", V_DECODE_GEMMS)):
        for name, k, n in gemms:
            path = k1.route(DECODE_M, n, k, torch.bfloat16, True)
            check(path == "decode", f"K1 {arch} {name} ({DECODE_M},{k},{n})"
                  f" would take {path}, not decode")
            x, w, b = k1_inputs(gen, dev, DECODE_M, k, n, torch.bfloat16)
            worst, worst_abs = k1_check(k1, x, w, b, "decode")
            print(f"[2] K1 {arch} {name:18s} ({DECODE_M},{k})@({k},{n}) "
                  f"bfloat16 decode max rel err {worst:.2e} (tol 1e-02), "
                  f"max abs err {worst_abs:.2e}")
            check(worst <= 1e-2, f"K1 {arch} {name} bf16 decode: {worst}")
            path_err["decode"] = max(path_err["decode"], worst_abs)
            del x, w, b
    # deepseek-v3's serving path (phase 7d): its decode step's GEMMs and
    # its prefill's, each on the route it must take there
    for m, want, gemms in ((DECODE_M, "decode", DS_DECODE_GEMMS),
                           (PREFILL_M, "tc", DS_PREFILL_GEMMS)):
        for name, k, n in gemms:
            path = k1.route(m, n, k, torch.bfloat16, True)
            check(path == want, f"K1 deepseek {name} ({m},{k},{n}) would "
                  f"take {path}, not {want}")
            x, w, b = k1_inputs(gen, dev, m, k, n, torch.bfloat16)
            worst, worst_abs = k1_check(k1, x, w, b, path)
            print(f"[2] K1 deepseek {name:18s} ({m},{k})@({k},{n}) bfloat16 "
                  f"{path:6s} max rel err {worst:.2e} (tol 1e-02), max abs "
                  f"err {worst_abs:.2e}")
            check(worst <= 1e-2, f"K1 deepseek {name} ({m}) bf16 {path}: "
                  f"{worst}")
            path_err[path] = max(path_err[path], worst_abs)
            del x, w, b
    step["max_abs_err"] = path_err["decode"]
    prefill["max_abs_err"] = path_err["tc"]
    return {"decode": step, "tc": prefill}


def phase_k1_threshold(dev):
    """The decode threshold: both bf16 routes timed at M in {8, 16, 32, 64,
    128}, summed over the GEMMs of one tinyllama decode step (155
    launches), as device time (``graph_ms``) and as calls from the host.
    The crossover is the largest M up to which the decode route's device
    time is not above the tc route's; ``kernels/matmul.py:DECODE_MAX_M``
    holds the measured value.  Device time decides: the host's cost of a
    call is the same for every M and belongs to the caller's loop."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(12)
    gemms = [(k, n, LAYERS * per) for _, k, n, per in LAYER_GEMMS] + \
        [(D, VOCAB, 1)]
    crossover = 4
    for m in (8, 16, 32, 64, 128):
        tot = dict.fromkeys(("tc_ms", "decode_ms", "tc_device_ms",
                             "decode_device_ms"), 0.0)
        for k, n, count in gemms:
            t = k1_time(k1, dev, gen, m, k, n, 20,
                        {"tc_ms": "tc", "decode_ms": "decode"},
                        with_plain=False, device=True)
            for key in tot:
                tot[key] += count * t[key]
        if tot["decode_device_ms"] <= tot["tc_device_ms"] and \
                crossover == m // 2:
            crossover = m      # decode not slower at every M up to here
        print(f"[2t] K1 routes at M = {m:3d}, summed over a decode step's "
              f"GEMMs: device decode {tot['decode_device_ms']:.3f} ms, tc "
              f"{tot['tc_device_ms']:.3f} ms; called from the host decode "
              f"{tot['decode_ms']:.3f} ms, tc {tot['tc_ms']:.3f} ms")
    crossover = crossover if crossover > 4 else None
    print(f"[2t] K1 threshold: the decode route's device time is not above "
          f"the tc route's up to M = {crossover or 'none'}; "
          f"kernels/matmul.py:DECODE_MAX_M = {k1.DECODE_MAX_M}")
    return crossover


def k4_case(dev, lens, nb, dtype, seed, d=DH, block=16, nq=NQ, nkv=NKV):
    """A pool of ``nq`` / ``nkv`` heads of ``d`` (tinyllama's by default),
    ``block`` entries a block: each slot's blocks at shuffled physical
    ids, unused columns on the null block 0, and slot 0's first unused
    column on a recycled block 1 whose stale positions lie past every
    cur; then the step's own k_new and v_new (B, nkv, d).  A slot of
    length 0 has no valid entry (cur = -1)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    n_used = sum(-(-n // block) for n in lens)
    n_blocks = 2 + n_used
    perm = (torch.randperm(n_used, generator=g) + 2).tolist()
    pos_pool = torch.full((n_blocks * block,), -1, dtype=torch.int32)
    tables = torch.zeros((len(lens), nb), dtype=torch.int32)
    cur = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    e = torch.arange(block, dtype=torch.int32)
    for b, n in enumerate(lens):
        for j in range(-(-n // block)):
            blk = perm.pop()
            tables[b, j] = blk
            pos_pool[blk * block:(blk + 1) * block] = torch.where(
                j * block + e < n, j * block + e, -1)
    pos_pool[block:2 * block] = max(lens) + 100
    tables[0, -(-lens[0] // block)] = 1
    phys = n_blocks * block
    B = len(lens)
    q = torch.randn(B, nq, d, generator=g)
    k_pool = torch.randn(phys, nkv, d, generator=g)
    v_pool = torch.randn(phys, nkv, d, generator=g)
    k_new = torch.randn(B, nkv, d, generator=g)
    v_new = torch.randn(B, nkv, d, generator=g)
    return ([t.to(dev, dtype) for t in (q, k_pool, v_pool)]
            + [t.to(dev) for t in (pos_pool, tables, cur)],
            [t.to(dev, dtype) for t in (k_new, v_new)])


def k4_bound(lens, nb, window, elt, step=False, d=DH, block=16, nq=NQ,
             nkv=NKV):
    """(ms, "bytes" or "operations") of one K4 call: q in and out, the
    valid K and V entries, every column's positions, the tables and cur;
    with ``step`` also k_new and v_new and their products."""
    B = len(lens)
    valid = [min(n, window) if window else n for n in lens]
    nbytes = (B * nq * d * elt * 2                       # q in, out
              + sum(valid) * nkv * 2 * d * elt           # valid K and V
              + B * nb * (block + 1) * 4 + B * 4)  # positions, tables, cur
    flops = sum(2 * nq * v * 2 * d for v in valid)
    if step:
        nbytes += B * nkv * 2 * d * elt
        flops += B * nq * 2 * 2 * d
    return bound_ms(nbytes, flops, H100_BF16_FLOPS)


# K4's cases (phase 3): (label, contexts, table columns, window, what is
# compared: the normalised output, the residuals (acc, m, l) or the step
# entry with the current token folded in[, head dim, block[, q heads, kv
# heads]]).  Tinyllama's heads, d 64 and block 16 unless given.
K4_RAGGED = [64, 200, 333, 512, 640, 777, 900, 1024]
K4_SERVE = [n + 16 for n in (259, 260, 261, 262, 263, 259, 260, 261)]
# a slot with no valid entry, and contexts that end inside the first split
K4_SHORT = [0, 5, 40, 300, 1000, 64, 17, 1]
# 64 slots, ragged 1024-2048: ~100 MB of bf16 K/V, twice the L2
K4_LONG = [1024 + (i * 523) % 1025 for i in range(64)]
# 16 of them at d 128 in blocks of 32: a ring of 128 KB, one CTA an SM
K4_WIDE = K4_LONG[:16]
K4_CASES = [("ragged 64-1024", K4_RAGGED, 64, 0, "out"),
            ("window 256", K4_RAGGED, 64, 256, "out"),
            ("residuals", K4_RAGGED, 64, 0, "residuals"),
            ("serve shape", K4_SERVE, 32, 0, "residuals"),
            ("serve step", K4_SERVE, 32, 0, "step"),
            ("short, empty", K4_SHORT, 64, 0, "residuals"),
            ("short, empty step", K4_SHORT, 64, 0, "step"),
            ("long context", K4_LONG, 128, 0, "residuals"),
            ("d 128, block 32", K4_WIDE, 64, 0, "step", 128, 32),
            # mixtral's serve step (32/8 heads of 128, its window) and
            # Moonlight's heads (16/16), phases 7m and 20s
            ("mixtral serve step", K4_SERVE, 32, MIX_WINDOW, "step",
             MIX_DH, 16, MIX_NQ, MIX_NKV),
            ("moonlight step", K4_SERVE, 32, 0, "step", MOON_DH, 16,
             MOON_NH, MOON_NH)]
# K4: the limits on ||got - want|| / ||want|| against the plain version,
# per dtype and tensor (m over the rows with a valid entry; rows with none
# must match exactly), 3-5x the readings over these cases on an H100: bf16
# out 2e-5-1.1e-4 (split; a bf16 rounding that flips), acc 1.7-2.6e-6, m
# 1.0e-7, l 2.0-2.6e-7; f32 (simt) out 3.8e-7, acc 7.4e-7, m 0, l 1.6e-7.
# A dropped entry or split reads 1e-3 or more
# (tools/k4_planted_faults.py)
K4_NORM_TOL = {"float32": {"out": 1.5e-6, "acc": 3e-6, "m": 5e-7,
                           "l": 6e-7},
               "bfloat16": {"out": 5e-4, "acc": 1e-5, "m": 5e-7,
                            "l": 1e-6}}


def k4_call(k4, args, new, window, kind, force=None, plain=False,
            block=16):
    """One K4 call of ``kind`` on ``args`` (+ ``new`` for a step), by the
    route ``force`` or by the plain version: {name: tensor}."""
    kw = dict(block=block, window=window)
    if kind == "step":
        if plain:
            return {"out": k4.paged_flash_decode_step_plain(
                args[0], *new, *args[1:], **kw)}
        return {"out": k4.paged_flash_decode_step(args[0], *new, *args[1:],
                                                  force=force, **kw)}
    res = kind == "residuals"
    fn = (k4.paged_flash_decode_plain if plain else
          functools.partial(k4.paged_flash_decode, force=force))
    got = fn(*args, return_residuals=res, **kw)
    return dict(zip(("acc", "m", "l"), got)) if res else {"out": got}


def k4_errs(got, want):
    """{tensor: ||got - want|| / ||want||}; m over the rows with a valid
    entry, its other rows (-1e30 in both) checked exactly."""
    import torch
    errs = {}
    for name, w in want.items():
        g = got[name]
        if name == "m":
            live = w > -1e29
            check(torch.equal(g[~live], w[~live]),
                  "K4: m of a row with no valid entry is not -1e30")
            g, w = g[live], w[live]
        errs[name] = norm_err(g, w)
    return errs


def k4_checks(dev, cases=None, dtypes=("float32", "bfloat16"), tag="[3]"):
    """Every case of ``K4_CASES`` on each route that takes it (f32: simt;
    bf16: split and simt) against the plain version, to ``K4_NORM_TOL``;
    the split route twice, bit for bit.  Returns the worst max |error| of
    the split route, by case."""
    import torch
    from repro_torch.kernels import paged_decode as k4
    worst = {}
    for label, lens, nb, window, kind, *dims in cases or K4_CASES:
        d, block, nq, nkv = (list(dims) + [DH, 16, NQ, NKV][len(dims):])
        for dname in dtypes:
            dtype = getattr(torch, dname)
            args, new = k4_case(dev, lens, nb, dtype, seed=len(label), d=d,
                                block=block, nq=nq, nkv=nkv)
            call = functools.partial(k4_call, k4, args, new, window, kind,
                                     block=block)
            want = call(plain=True)
            routes = ("split", "simt") if dname == "bfloat16" else ("simt",)
            for way in routes:
                got = call(force=way)
                torch.cuda.synchronize()
                errs = k4_errs(got, want)
                absd = max(abs_err(got[n], want[n]) for n in want)
                print(f"{tag} K4 {label:17s} {dname:8s} {way:5s} "
                      + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
                      + f" (max abs {absd:.2e})")
                tol = K4_NORM_TOL[dname]
                check(all(e <= tol[n] for n, e in errs.items()),
                      f"K4 {label} {dname} {way}: {errs} above {tol}")
                if way == "split":
                    again = call(force=way)
                    check(all(torch.equal(got[n], again[n]) for n in got),
                          f"K4 {label} split: two runs differ")
                    worst[label] = absd
            if dname == "float32":
                try:
                    call(force="split")
                except ValueError:
                    pass
                else:
                    raise SmokeFailure("K4: the split route took float32")
    return worst


def k4_sdpa_ms(dev, lens, reps, d=DH, nq=NQ, nkv=NKV):
    """F.scaled_dot_product_attention of one query per slot over
    contiguous K/V of the same lengths (padding masked): what a contiguous
    cache would cost, not the same function (no block table, no
    positions)."""
    import torch
    import torch.nn.functional as F
    B, L = len(lens), max(lens)
    q = torch.randn(B, nq, 1, d, device=dev, dtype=torch.bfloat16)
    k = torch.randn(B, nkv, L, d, device=dev, dtype=torch.bfloat16)
    v = torch.randn(B, nkv, L, d, device=dev, dtype=torch.bfloat16)
    mask = (torch.arange(L, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])[:, None, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), reps)


def launch_floor_ms(reps):
    """Device time of one empty kernel (``EMPTY_KERNEL``), by
    ``graph_ms``."""
    import ctypes
    import torch
    fn = ctypes.CDLL(str(EMPTY_LIB)).empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        check(fn(torch.cuda.current_stream().cuda_stream) == 0,
              "the empty kernel did not launch")
    return graph_ms(launch, reps)


def k4_layer_kernels(dev):
    """The device kernels that one decode layer's attention
    (``models/blocks.py:attention_decode_paged``) launches at the serve
    shape, under torch.profiler: K4's two passes and nothing else, the
    current token folded in by the combine pass.  A profiler that sees no
    device kernel fails the check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.blocks import PageInfo, attention_decode_paged
    args, (k_new, v_new) = k4_case(dev, K4_SERVE, 32, torch.bfloat16,
                                   seed=11)
    q, k_pool, v_pool, pos_pool, tables, cur = args
    cache = {"k": k_pool, "v": v_pool, "pos": pos_pool}
    page = PageInfo(tables, torch.ones(len(K4_SERVE), dtype=torch.bool,
                                       device=dev), 16)

    def layer():
        return attention_decode_paged(None, None, None, q[:, None],
                                      k_new[:, None], v_new[:, None], cache,
                                      cur, page)
    layer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        layer()
        torch.cuda.synchronize()
    names = [e.name.replace("(anonymous namespace)::", "").split("(")[0]
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(names, "torch.profiler saw no device kernel of the decode layer: "
                 "what attention_decode_paged launches is not checked")
    print(f"[3] kernels of one decode layer's attention on the card: "
          f"{names}")
    check(len(names) == 2 and "k4_split" in names[0]
          and "k4_combine" in names[1],
          f"attention_decode_paged launched {names}, not K4's two passes")
    return len(names)


# K4 at the contiguous caches' shapes (phase 3): (label, each slot's
# current position, cache length L, q heads, kv heads, window[, d]), d 64
# unless given.  The cache (B, L, nkv, d) is K4's pool laid out flat under
# the identity block table (models/blocks.py:attention_decode): zamba2's
# shared block (32/32 heads, contexts 32-96, and a wrapped ring whose
# positions run past L), the speculative draft's cache of 512 + 4 entries
# rounded up to 528, and the self attention of whisper (16/16 of 64) and
# internvl2 (16/8 of 128) as phases 7w and 7v serve them (L 512,
# positions 42-77 of prompts of 43-47 and 32 new tokens).
K4_STATE_CURS = [42 + 5 * i for i in range(8)]
K4_CONTIG = [("contiguous zamba2", [31 + (i * 9) % 65 for i in range(8)],
              512, Z_HEADS, Z_HEADS, Z_WINDOW),
             ("contiguous zamba2, wrapped ring",
              [600 + 97 * i for i in range(8)], 512, Z_HEADS, Z_HEADS,
              Z_WINDOW),
             ("contiguous draft", [n + 3 for n in K4_SERVE], 528, NQ, NKV,
              0),
             ("contiguous whisper self", K4_STATE_CURS, 512, W_NH, W_NH, 0),
             ("contiguous internvl2", K4_STATE_CURS, 512, V_NQ, V_NKV, 0,
              V_DH)]


def k4_contig_case(dev, curs, L, nq, nkv, dtype, seed, d=DH, block=16):
    """A contiguous cache as decode leaves it: each slot's last L
    positions up to its cur at slot p % L (a ring once cur >= L), the rest
    -1; q, and the cache flattened into K4's pool with the identity
    table."""
    import torch
    g = torch.Generator().manual_seed(seed)
    B = len(curs)
    cpos = torch.full((B, L), -1, dtype=torch.int32)
    for b, c in enumerate(curs):
        p = torch.arange(max(0, c - L + 1), c + 1, dtype=torch.int32)
        cpos[b, p % L] = p
    q = torch.randn(B, nq, d, generator=g)
    k = torch.randn(B * L, nkv, d, generator=g)
    v = torch.randn(B * L, nkv, d, generator=g)
    tables = torch.arange(B * L // block, dtype=torch.int32).view(B, -1)
    cur = torch.tensor(curs, dtype=torch.int32)
    return ([t.to(dev, dtype) for t in (q, k, v)]
            + [t.to(dev) for t in (cpos.reshape(-1), tables, cur)])


def k4_contig_sdpa(args, L, window):
    """F.scaled_dot_product_attention over the same contiguous cache with
    the position mask: the same function as K4 here."""
    import torch.nn.functional as F
    q, k, v, pos, _, cur = args
    B, nq, d = q.shape
    nkv = k.shape[1]
    kc = k.view(B, L, nkv, d).transpose(1, 2)
    vc = v.view(B, L, nkv, d).transpose(1, 2)
    cp = pos.view(B, L)
    mask = (cp >= 0) & (cp <= cur[:, None])
    if window:
        mask &= (cur[:, None] - cp) < window
    mask = mask[:, None, None, :]
    qs = q[:, :, None]
    return lambda: F.scaled_dot_product_attention(
        qs, kc, vc, attn_mask=mask, enable_gqa=nq != nkv)[:, :, 0]


def k4_contig_layer_kernels(dev):
    """The device kernels that one contiguous decode layer's attention
    (``models/blocks.py:attention_decode``) launches at zamba2's
    shared-block shape, under torch.profiler: the writes of the new entry,
    the identity table, K4's two passes, and no PyTorch attention (no
    GEMM, softmax or reduction).  A profiler that sees no device kernel
    fails the check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.blocks import attention_decode
    label, curs, L, nq, nkv, window = K4_CONTIG[0]
    q, k, v, pos, _, cur = k4_contig_case(dev, curs, L, nq, nkv,
                                          torch.bfloat16, seed=13)
    B = len(curs)
    cache = {"k": k.view(B, L, nkv, -1), "v": v.view(B, L, nkv, -1),
             "pos": pos.view(B, L)}
    new = torch.randn(2, B, 1, nkv, q.shape[-1], device=dev,
                      dtype=torch.bfloat16)

    def layer():
        return attention_decode(None, None, None, q[:, None], new[0],
                                new[1], cache, cur + 1, window=window)
    layer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        layer()
        torch.cuda.synchronize()
    names = [e.name.replace("(anonymous namespace)::", "").split("(")[0]
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(names, "torch.profiler saw no device kernel of the contiguous "
                 "decode layer: what attention_decode launches is not "
                 "checked")
    print(f"[3] kernels of one contiguous decode layer's attention on the "
          f"card ({label}): {names}")
    k4_names = [n for n in names if "k4_" in n]
    check(len(k4_names) == 2 and "k4_split" in k4_names[0]
          and "k4_combine" in k4_names[1],
          f"attention_decode launched K4 as {k4_names}, not its two passes")
    attn = [n for n in names if re.search(
        r"gemm|softmax|reduce|sdpa|flash|fmha|attention|xmma|nvjet", n,
        re.I)]
    check(not attn, f"attention_decode launched PyTorch attention: {attn}")
    return len(names)


def phase_k4_contiguous(dev, cases=K4_CONTIG, tag="3"):
    """K4 at ``cases`` (``K4_CONTIG``): both routes against the plain version to
    ``K4_NORM_TOL`` (f32 through simt), the split route twice bit for bit;
    then device times (graph_ms) of the split route, the plain version and
    SDPA with the position mask (the same function here) beside the
    bound.  Returns {label: numbers} for the K4 row's ``shapes``."""
    import torch
    from repro_torch.kernels import paged_decode as k4
    shapes = {}
    for label, curs, L, nq, nkv, window, *dims in cases:
        d = dims[0] if dims else DH
        for dname in ("float32", "bfloat16"):
            args = k4_contig_case(dev, curs, L, nq, nkv,
                                  getattr(torch, dname), seed=len(label), d=d)
            call = functools.partial(k4_call, k4, args, None, window, "out")
            want = call(plain=True)
            for way in (("split", "simt") if dname == "bfloat16"
                        else ("simt",)):
                got = call(force=way)
                torch.cuda.synchronize()
                errs = k4_errs(got, want)
                print(f"[{tag}] K4 {label:32s} {dname:8s} {way:5s} "
                      f"out {errs['out']:.2e} (max abs "
                      f"{abs_err(got['out'], want['out']):.2e})")
                check(errs["out"] <= K4_NORM_TOL[dname]["out"],
                      f"K4 {label} {dname} {way}: {errs}")
                if way == "split":
                    again = call(force=way)
                    check(torch.equal(got["out"], again["out"]),
                          f"K4 {label} split: two runs differ")
                    worst = abs_err(got["out"], want["out"])
        check(k4.route_for(args[0], args[1], args[2], args[3], 16)
              == "split", f"K4 {label}: bf16 does not take the split route")
        sdpa = k4_contig_sdpa(args, L, window)
        sdpa_err = norm_err(sdpa(), want["out"])
        check(sdpa_err <= 1e-2, f"K4 {label}: SDPA with the position mask "
              f"is not the same function ({sdpa_err:.2e})")
        valid = [min(c + 1, L, window or L) for c in curs]
        t = {"ms": graph_ms(lambda: k4.paged_flash_decode(
                 *args, block=16, window=window), 200),
             "plain_ms": graph_ms(lambda: k4.paged_flash_decode_plain(
                 *args, block=16, window=window), 20),
             "library_ms": graph_ms(sdpa, 200), "max_abs_err": worst,
             "sdpa_norm_err": sdpa_err}
        t["bound_ms"], t["bound_by"] = k4_bound(valid, L // 16, 0, 2,
                                                d=d, nq=nq, nkv=nkv)
        shapes[label] = t
        print(f"[{tag}] K4 {label} (B {len(curs)}, {nq}/{nkv} heads of {d}, "
              f"L {L}, positions {min(curs)}-{max(curs)}, bf16, identity "
              f"table): "
              f"device ms (graph_ms) split {t['ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, SDPA with the position mask (the same "
              f"function; ||SDPA - plain|| / ||plain|| {sdpa_err:.1e}) "
              f"{t['library_ms']:.4f}; bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}, {t['bound_ms'] / t['ms'] * 100:.1f}% of "
              f"it)")
    return shapes


def phase_k4(dev):
    import torch
    from repro_torch.kernels import paged_decode as k4
    worst = k4_checks(dev)
    layer_kernels = k4_layer_kernels(dev)
    floor = launch_floor_ms(200)
    print(f"[3] launch floor: one empty kernel {floor:.4f} ms (graph_ms)")
    shapes = {}
    for label, lens, nb, reps, d, block, nq, nkv in (
            ("serve", K4_SERVE, 32, 200, DH, 16, NQ, NKV),
            ("long", K4_LONG, 128, 50, DH, 16, NQ, NKV),
            ("long, d 128, block 32", K4_WIDE, 64, 50, 128, 32, NQ, NKV),
            ("mixtral serve", K4_SERVE, 32, 200, MIX_DH, 16, MIX_NQ,
             MIX_NKV)):
        args, new = k4_case(dev, lens, nb, torch.bfloat16, seed=len(label),
                            d=d, block=block, nq=nq, nkv=nkv)
        kw = dict(block=block)

        def step(way):
            return lambda: k4.paged_flash_decode_step(args[0], *new,
                                                      *args[1:], force=way,
                                                      **kw)

        def resid(way):
            return lambda: k4.paged_flash_decode(*args, force=way,
                                                 return_residuals=True, **kw)
        t = {"split_ms": graph_ms(step("split"), reps),
             "split_residuals_ms": graph_ms(resid("split"), reps),
             "simt_ms": graph_ms(resid("simt"), reps),
             "simt_step_ms": graph_ms(step("simt"), reps),
             "split_host_ms": time_ms(step("split"), reps),
             "simt_host_ms": time_ms(resid("simt"), reps),
             "plain_ms": graph_ms(lambda: k4.paged_flash_decode_step_plain(
                 args[0], *new, *args[1:], **kw), max(5, reps // 10)),
             "sdpa_contiguous_ms": k4_sdpa_ms(dev, lens, reps, d, nq, nkv)}
        t["bound_ms"], t["bound_by"] = k4_bound(lens, nb, 0, 2, step=True,
                                                d=d, block=block, nq=nq,
                                                nkv=nkv)
        t["splits"], t["cols"], _, t["ctas_per_sm"] = k4.split_grid(
            args[0], args[1], args[4], block)
        shapes[label] = t
        print(f"[3] K4 {label} shape (B {len(lens)}, contexts "
              f"{min(lens)}-{max(lens)}, {nq}/{nkv} heads of {d}, block "
              f"{block}, {nb} columns,"
              f" bf16; {t['splits']} splits of {t['cols']}, "
              f"{t['ctas_per_sm']} CTAs an SM), device ms (graph_ms): split "
              f"step {t['split_ms']:.4f} (residuals "
              f"{t['split_residuals_ms']:.4f}), simt {t['simt_ms']:.4f} "
              f"(step with the PyTorch fold {t['simt_step_ms']:.4f}), plain "
              f"{t['plain_ms']:.4f}; bound {t['bound_ms']:.4f} "
              f"({t['bound_by']}, {t['bound_ms'] / t['split_ms'] * 100:.1f}%"
              f" of it), launch floor {floor:.4f}; from the host split "
              f"{t['split_host_ms']:.4f}, simt {t['simt_host_ms']:.4f}; "
              f"contiguous SDPA, not the same function, "
              f"{t['sdpa_contiguous_ms']:.4f}")
    shapes.update(phase_k4_contiguous(dev))
    contig_kernels = k4_contig_layer_kernels(dev)
    serve = shapes["serve"]
    return {"ms": serve["split_ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": None, "simt_ms": serve["simt_ms"],
            "launch_floor_ms": floor, "max_abs_err": max(worst.values()),
            "decode_layer_kernels": layer_kernels,
            "contiguous_layer_kernels": contig_kernels, "shapes": shapes}


# K3: the limits on ||got - want|| / ||want|| against the plain version,
# per dtype, 3-5x the readings of the redesign (on an H100: f32 y 4-6e-8,
# dx 6-8e-8, dg 2-4e-7; bf16 y 0.4-1.6e-5, dx 0.5-2.4e-5).  bf16 dg is one
# rounding of an f32 sum over the rows: it reads 0 where no rounding
# flips, and one flipped entry of H = 4096 reads up to ~6e-5, so its
# limit is 3e-4.  One row's share of dg dropped reads ~1e-2 at 8192 rows
# (tools/k3k5_planted_faults.py)
K3_NORM_TOL = {"float32": {"y": 3e-7, "dx": 3e-7, "dg": 1.5e-6},
               "bfloat16": {"y": 6e-5, "dx": 1e-4, "dg": 3e-4}}
# K3's widths on the main paths: every norm of tinyllama and zamba2 (2048),
# zamba2's gate_ln over d_inner (4096), the 3072 instance, and xlstm's
# ln and ln_f (1024, a block per row; its out_ln is 2048)
K3_WIDTHS = (1024, 2048, 3072, 4096)
# deepseek-v3's, at its training step's 2048 rows: kv_ln (512), q_ln
# (1536) and every norm over d_model (7168), each its own instance
K3_DS_WIDTHS = (512, 1536, 7168)


def kernels_by_name(fn, reps):
    """{kernel name: device ms per call of ``fn``}, largest first, summed
    by torch.profiler over ``reps`` calls (after one warm-up call); the
    names without their arguments and anonymous namespace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / reps for k, v in sorted(out.items(),
                                           key=lambda kv: -kv[1])}


def kernel_ms(fn, reps):
    """Device time of ``fn``, its kernels' durations summed (see
    ``kernels_by_name``), or None when the profiler sees no kernel: for
    calls that cannot be captured in a CUDA graph, such as an autograd
    backward."""
    return sum(kernels_by_name(fn, reps).values()) or None


def k3_case(k3, dev, gen, m, h, dtype, zc, tag="[4]"):
    """K3's forward and backward against the plain version at (m, h):
    y, rstd, dx and dg within the scaled limit (1e-4 f32, 3e-2 bf16, of
    1 + max) and within ``K3_NORM_TOL`` of the plain version's norm, and
    two backward runs giving the same dg bits.  Returns the inputs, rstd
    and the worst absolute error."""
    import torch
    x = torch.randn(m, h, generator=gen, device=dev).to(dtype)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(m, h, generator=gen, device=dev).to(dtype)
    y, rstd = k3.rmsnorm_fwd(x, g, zero_centered=zc)
    dx, dg = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)
    again = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)[1]
    y2, rstd2 = k3.rmsnorm_plain(x, g, zero_centered=zc)
    dx2, dg2 = k3.rmsnorm_bwd_plain(dy, x, g, rstd2, zero_centered=zc)
    pairs = (("y", y, y2), ("rstd", rstd, rstd2), ("dx", dx, dx2),
             ("dg", dg, dg2))
    errs = {n: scaled_err(a, b) for n, a, b in pairs}
    norms = {n: norm_err(a, b) for n, a, b in pairs if n != "rstd"}
    name = str(dtype)[6:]
    tol, ntol = {"float32": 1e-4, "bfloat16": 3e-2}[name], K3_NORM_TOL[name]
    same = torch.equal(dg, again)
    print(f"{tag} K3 ({m},{h}) {name:8s} zc={zc!s:5s} errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {tol:.0e}, relative to 1 + max); ||error|| / ||plain|| "
          + ", ".join(f"{k} {v:.2e}" for k, v in norms.items())
          + " (tol " + ", ".join(f"{k} {v:.0e}" for k, v in ntol.items())
          + f"); dg repeats bit for bit: {same}")
    check(all(norms[k] <= ntol[k] for k in ntol),
          f"K3 ({m},{h}) {dtype} zc={zc}: ||error|| / ||plain|| {norms}")
    check(max(errs.values()) <= tol, f"K3 ({m},{h}) {dtype} zc={zc}: {errs}")
    check(same, f"K3 ({m},{h}) {dtype} zc={zc}: dg does not repeat")
    worst = max(abs_err(a, b) for n, a, b in pairs if n != "rstd")
    return (x, g, dy), rstd, worst, norms


def k3_times(k3, x, g, dy, rstd, norms, worst, tag="4"):
    """The device times of K3's forward and backward on (x, g, dy) in
    bf16, called from the host too, beside its bound, the plain version
    and ``F.rms_norm``'s."""
    import torch
    import torch.nn.functional as F
    m, h = x.shape
    xr = x.detach().requires_grad_()
    gr = g.detach().requires_grad_()
    lib_out = F.rms_norm(xr, (h,), gr, 1e-6)

    def lib_bwd():
        torch.autograd.grad(lib_out, (xr, gr), dy, retain_graph=True)
    t = {"fwd_ms": graph_ms(lambda: k3.rmsnorm_fwd(x, g), 50),
         "bwd_ms": graph_ms(lambda: k3.rmsnorm_bwd(dy, x, g, rstd), 50),
         "fwd_host_ms": time_ms(lambda: k3.rmsnorm_fwd(x, g), 50),
         "bwd_host_ms": time_ms(lambda: k3.rmsnorm_bwd(dy, x, g, rstd),
                                50),
         "bwd_kernels_ms": kernel_ms(
             lambda: k3.rmsnorm_bwd(dy, x, g, rstd), 20),
         "plain_fwd_ms": time_ms(lambda: k3.rmsnorm_plain(x, g), 10),
         "plain_bwd_ms": time_ms(
             lambda: k3.rmsnorm_bwd_plain(dy, x, g, rstd), 10),
         "library_fwd_ms": graph_ms(
             lambda: F.rms_norm(x, (h,), g, 1e-6), 50),
         "library_bwd_ms": kernel_ms(lib_bwd, 20),
         "norm_err": norms, "max_abs_err": worst}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    t["library_ms"] = (t["library_fwd_ms"] + t["library_bwd_ms"]
                       if t["library_bwd_ms"] is not None else None)
    fb, fo = bound_ms(2 * m * h * 2 + h * 2 + m * 4, 4 * m * h,
                      H100_F32_FLOPS)
    bb, bo = bound_ms(3 * m * h * 2 + 2 * h * 2 + m * 4, 10 * m * h,
                      H100_F32_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations")
    lb = t["library_bwd_ms"]
    print(f"[{tag}] K3 bf16 ({m},{h}), device time: forward {t['fwd_ms']:.4f}"
          f" ms ({fb / t['fwd_ms'] * 100:.0f}% of its bound {fb:.4f} {fo};"
          f" F.rms_norm {t['library_fwd_ms']:.4f}, "
          f"{t['fwd_ms'] / t['library_fwd_ms']:.2f}x); backward "
          f"{t['bwd_ms']:.4f} ms ({bb / t['bwd_ms'] * 100:.0f}% of its "
          f"bound {bb:.4f} {bo}; its kernels summed by the profiler "
          f"{t['bwd_kernels_ms'] or float('nan'):.4f}; F.rms_norm's "
          f"backward, its kernels summed by the profiler, "
          + (f"{lb:.4f}, {t['bwd_kernels_ms'] / lb:.2f}x"
             if lb and t["bwd_kernels_ms"] else "not measured")
          + f"); called from the host {t['fwd_host_ms']:.4f} + "
          f"{t['bwd_host_ms']:.4f} ms; plain {t['plain_fwd_ms']:.4f} + "
          f"{t['plain_bwd_ms']:.4f} ms")
    return t


def phase_k3(dev):
    """K3 at the training shape: every norm of a step sees 8192 rows, of
    2048 (tinyllama, zamba2, xlstm's out_ln), 4096 (zamba2's gate_ln) or
    1024 (xlstm's ln and ln_f); the 3072 instance too; and deepseek-v3's
    step 2048 rows of 512, 1536 and 7168 (``K3_DS_WIDTHS``).  Checked in
    f32 and bf16, with and without zero-centring at 2048, in bf16 at the
    other widths; then the device times of the kernels, the plain versions and
    ``F.rms_norm``'s forward and backward at each width in bf16.  Returns
    the 2048 case's numbers (bf16, no zero-centring), the kernel's time
    as forward + backward of one norm (device time), the other widths
    under ``shapes``."""
    import torch
    from repro_torch.kernels import rmsnorm as k3
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(TRAIN_B * TRAIN_S, D, dtype, zc)
             for dtype in (torch.float32, torch.bfloat16)
             for zc in (False, True)]
    cases += [(TRAIN_B * TRAIN_S, h, torch.bfloat16, False)
              for h in K3_WIDTHS if h != D]
    cases += [(DS_TRAIN_B * TRAIN_S, h, torch.bfloat16, False)
              for h in K3_DS_WIDTHS]
    out = {}
    for m, h, dtype, zc in cases:
        (x, g, dy), rstd, worst, norms = k3_case(k3, dev, gen, m, h, dtype,
                                                 zc)
        if dtype != torch.bfloat16 or zc:
            continue
        out[(m, h)] = k3_times(k3, x, g, dy, rstd, norms, worst)
    return dict(out[(TRAIN_B * TRAIN_S, D)],
                shapes={f"{m}x{h}": t for (m, h), t in out.items()})


# the attention shapes of the main paths (phase 5): (label, batch, seq, q
# heads, kv heads, window[, d]), all causal, d = 64 unless given
K2_SHAPES = [("train", TRAIN_B, TRAIN_S, NQ, NKV, 0),
             ("zamba2", TRAIN_B, TRAIN_S, Z_HEADS, Z_HEADS, Z_WINDOW),
             ("prefill", 8, 512, NQ, NKV, 0),
             ("mixtral", TRAIN_B, TRAIN_S, MIX_NQ, MIX_NKV, MIX_WINDOW,
              MIX_DH),
             ("moonlight", TRAIN_B, TRAIN_S, MOON_NH, MOON_NH, 0, MOON_DH),
             ("internvl2", TRAIN_B, TRAIN_S, V_NQ, V_NKV, 0, V_DH)]
# the head dims the tc route does not take, at their configs' training
# shapes (phase 5): (label, batch, seq, q heads, kv heads, d), causal: the
# paper's model (configs/paper_transformer.py, seq 512) and gemma-2b
# (configs/gemma_2b.py, MQA)
K2_WIDE_SHAPES = [("paper d48", 4, 512, 64, 64, 48),
                  ("gemma d256", 4, 2048, 8, 1, 256)]


def k2_work(q_pos, k_pos, b, nq, nkv, d, elt, window=0, dv=None,
            causal=True):
    """(fwd bytes, fwd flops, bwd bytes, bwd flops) of one attention call,
    causal or not, the flops counted over the allowed (query, key) pairs
    of these positions: 2 products a pair forward (QK over d, PV over dv),
    5 backward (S and dQ and dK over d, dP and dV over dv); q and k of d,
    v and out of ``dv`` (d when None)."""
    dv = dv or d
    qp, kp = q_pos[:, :, None], k_pos[None, None, :]
    allowed = (kp >= 0).expand(*q_pos.shape, k_pos.shape[0])
    if causal:
        allowed = allowed & (qp >= kp)
        if window:
            allowed &= qp - kp < window
    pairs = int(allowed.sum().item()) * nq
    sq, sk = q_pos.shape[1], k_pos.shape[0]
    q_bytes = b * sq * nq * (d + dv) * elt          # q in, out (or dq, dout)
    kv_bytes = b * sk * nkv * (d + dv) * elt
    lse = b * nq * sq * 4
    pos = (b * sq + sk) * 4
    fwd = (q_bytes + kv_bytes + lse + pos, 2 * (d + dv) * pairs)
    bwd = (2 * q_bytes + 2 * kv_bytes + lse + pos, (6 * d + 4 * dv) * pairs)
    return (*fwd, *bwd)


# K2 in bf16: the limits on ||got - want|| / ||want|| (the whole tensor's
# L2 norm) against the plain version.  The tc route reads out 1.1-1.4e-3,
# dq and dk 2.5-2.7e-3 (as much as rounding dS to bf16 alone gives) and
# dv 1.7-3.4e-4 at the main paths' shapes; a dropped key tile or GQA head,
# or a wrong k16 slice of a product, even on one q tile or one key tile of
# the 32, reads 1.6e-2 or more (tools/k2_planted_faults.py)
K2_NORM_TOL = {"out": 5e-3, "dq": 1e-2, "dk": 1e-2, "dv": 1.5e-3}


def norm_err(got, want):
    """||got - want|| / ||want|| over the whole tensor, in f64."""
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm().clamp_min(1e-300)).item()


def k2_bwd_ds_rounded(q, k, v, out, dout, lse, q_pos, k_pos, window,
                      causal=True):
    """``(dq, dk)`` of the plain backward (the default scale) with dS
    rounded to q's dtype before its two products, as the tc kernels round
    it: held against the plain version, it measures what that rounding
    alone costs."""
    import torch
    f32 = torch.float32
    b, sq, nq, d = q.shape
    nkv, dv = k.shape[2], v.shape[-1]
    g, scale = nq // nkv, d ** -0.5
    qf = (q.to(f32) * scale).reshape(b, sq, nkv, g, d)
    dof = dout.to(f32).reshape(b, sq, nkv, g, dv)
    qp = q_pos[:, None, None, :, None]
    allowed = (k_pos >= 0) & ((qp >= k_pos) if causal else True)
    if window and causal:
        allowed &= qp - k_pos < window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(f32))
    p = torch.where(allowed, torch.exp(s - lse.reshape(b, nkv, g, sq, 1)),
                    0.0)
    delta = (dof * out.to(f32).reshape(b, sq, nkv, g, dv)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.to(f32))
    ds = (p * (dp - delta.permute(0, 2, 3, 1)[..., None])).to(q.dtype)
    del s, p, dp
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(f32), k.to(f32)) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(f32), qf)
    return dq.reshape(b, sq, nq, d).to(q.dtype), dk.to(k.dtype)


def k2_case(k2, dev, gen, b, s, nq, nkv, window, dtype, routes, label,
            d=DH, dv=None, tag="5", f32_tol=None, sk=None, causal=True,
            q0=0):
    """K2's routes against the plain version at one shape: out, lse, dq,
    dk and dv, and two backward runs of each route that must give the same
    bits.  In bf16 each of out, dq, dk and dv is also held to
    ``K2_NORM_TOL``, and the plain backward with dS rounded to bf16 shows
    what the tc kernels' rounding of dS costs by itself.  Returns the
    inputs, the path route's (out, lse), its worst absolute error (lse
    apart) and each route's norm errors (with ``"dS in bf16"``: the
    rounded plain backward's).  ``dv``: v's head dim (d when None);
    ``f32_tol``: norm limits for f32 too; ``sk``: the keys' length (s when
    None); ``causal``: the mask; ``q0``: the position of the first q row
    (a rank's rows of the 3-D cube)."""
    import torch
    dv = dv or d
    sk = sk or s
    q_pos = (q0 + torch.arange(s, dtype=torch.int32, device=dev)) \
        .expand(b, s).contiguous()
    k_pos = torch.arange(sk, dtype=torch.int32, device=dev)
    q = torch.randn(b, s, nq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, nkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, nkv, dv, generator=gen, device=dev).to(dtype)
    dout = torch.randn(b, s, nq, dv, generator=gen, device=dev).to(dtype)
    kw = dict(window=window, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-5
    bf16 = dtype == torch.bfloat16
    out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos, **kw)
    path = k2.route_for(q, k, v, out2)
    worst, kept, norms = 0.0, None, {}
    norm_tol = K2_NORM_TOL if bf16 else f32_tol
    tag = (f"[{tag}] K2 {label} ({b},{s}{f'x{sk}' if sk != s else ''}"
           f"{f' from {q0}' if q0 else ''},"
           f"{nq}/{nkv},{d if dv == d else f'{d}/{dv}'}) "
           f"{'causal' if causal else 'non-causal'}"
           f"{f' window {window}' if window else ''} {str(dtype)[6:]:8s}")
    for r in routes:
        out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force=r,
                                          **kw)
        grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                       force=r, **kw)
        again = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                       force=r, **kw)
        grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                              k_pos, **kw)
        pairs = [("out", out, out2), ("lse", lse, lse2)] + list(
            zip(("dq", "dk", "dv"), grads, grads2))
        errs = {n: scaled_err(x, y) for n, x, y in pairs}
        norms[r] = {n: norm_err(x, y) for n, x, y in pairs if n != "lse"}
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        print(f"{tag} {r:4s} errors "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (tol {tol:.0e}, lse {lse_tol:.0e}, relative to 1 + max); "
              "||error|| / ||plain|| "
              + ", ".join(f"{n} {e:.2e}" for n, e in norms[r].items())
              + (" (tol " + ", ".join(f"{n} {e:.1e}" for n, e in
                                      norm_tol.items()) + ")"
                 if norm_tol else "")
              + f"; backward repeats bit for bit: {same}")
        check(errs["lse"] <= lse_tol and max(errs.values()) <= tol,
              f"K2 {label} {dtype} {r}: {errs}")
        check(not norm_tol or all(norms[r][n] <= norm_tol[n]
                                  for n in norm_tol),
              f"K2 {label} {dtype} {r}: ||error|| / ||plain|| {norms[r]}")
        check(same, f"K2 {label} {dtype} {r}: the backward does not repeat")
        if r == path:
            worst = max(abs_err(x, y) for n, x, y in pairs if n != "lse")
            kept = (out, lse, grads, grads2)
        del again
    if bf16:
        out, lse, grads, grads2 = kept
        rounded = k2_bwd_ds_rounded(q, k, v, out, dout, lse, q_pos, k_pos,
                                    window, causal)
        norms["dS in bf16"] = {n: norm_err(x, y) for n, x, y in
                               zip(("dq", "dk"), rounded, grads2)}
        near = {n: norm_err(x, y) for n, x, y in
                zip(("dq", "dk"), grads, rounded)}
        print(f"{tag} dS in bf16: the plain backward with dS rounded to bf16"
              " against the plain version, ||error|| / ||plain|| "
              + ", ".join(f"{n} {e:.2e}" for n, e in
                          norms["dS in bf16"].items())
              + f"; the {path} route against the rounded one "
              + ", ".join(f"{n} {e:.2e}" for n, e in near.items()))
        del rounded, grads2
    return (q, k, v, dout, q_pos, k_pos), kept[:2], worst, norms


def phase_k2(dev):
    """K2 at the main paths' attention shapes (K2_SHAPES): tinyllama's
    training layer, which is also the serving prefill's kernel at another
    batch, zamba2's shared attention and the serving prefill.  In bf16 the
    tc route (and at the training shape the simt route too) against the
    plain version; in f32 the simt route at the training shape.  Then the
    times of each route, the plain version and SDPA at each shape.  Returns
    the training shape's numbers (bf16, causal) at the top, the kernel's
    time as one tc forward + one tc backward, and every shape's under
    ``shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    gen = torch.Generator(device=dev).manual_seed(4)
    label, b, s, nq, nkv, _ = K2_SHAPES[0]
    k2_case(k2, dev, gen, b, s, nq, nkv, 0, torch.float32, ["simt"], label)
    t_all, worst_path_err = {}, 0.0
    for label, b, s, nq, nkv, window, *dims in K2_SHAPES:
        d = dims[0] if dims else DH
        routes = ["tc", "simt"] if label == "train" else ["tc"]
        (q, k, v, dout, q_pos, k_pos), (out, lse), worst, norms = k2_case(
            k2, dev, gen, b, s, nq, nkv, window, torch.bfloat16, routes,
            label, d)
        check(k2.route_for(q, k, v, out, dout) == "tc",
              f"K2 {label}: the bf16 path does not take the tc route")
        worst_path_err = max(worst_path_err, worst)
        kw = dict(window=window)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dt = dout.transpose(1, 2)

        def sdpa():
            # the window never binds at these shapes (4096 >= the sequence)
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dt)

        def fwd(r):
            return lambda: k2.flash_attention_fwd(q, k, v, q_pos, k_pos,
                                                  force=r, **kw)

        def bwd(r):
            return lambda: k2.flash_attention_bwd(q, k, v, out, dout, lse,
                                                  q_pos, k_pos, force=r, **kw)
        t = {"fwd_ms": time_ms(fwd("tc"), 20),
             "bwd_ms": time_ms(bwd("tc"), 10),
             "simt_fwd_ms": time_ms(fwd("simt"), 3),
             "simt_bwd_ms": time_ms(bwd("simt"), 2),
             "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
                 q, k, v, q_pos, k_pos, **kw), 2),
             "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
                 q, k, v, out, dout, lse, q_pos, k_pos, **kw), 2),
             "library_fwd_ms": time_ms(sdpa, 20),
             "library_ms": time_ms(sdpa_fwd_bwd, 20),
             # device time (CUDA graph): at the prefill's shape a call's
             # host cost is of the order of its kernels' time
             "fwd_device_ms": graph_ms(fwd("tc"), 20),
             "bwd_device_ms": graph_ms(bwd("tc"), 10),
             "library_fwd_device_ms": graph_ms(
                 lambda: F.scaled_dot_product_attention(
                     qt.detach(), kt.detach(), vt.detach(), is_causal=True,
                     enable_gqa=True), 20)}
        t["ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["norm_err"] = norms
        t["simt_ms"] = t["simt_fwd_ms"] + t["simt_bwd_ms"]
        t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
        fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, nq, nkv, d, 2, window)
        fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
        bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
        t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
                 bound_by=fo if fo == bo else "bytes and operations")
        print(f"[5] K2 bf16 {label} ({b},{s},{nq}/{nkv},{d}) causal: tc "
              f"forward {t['fwd_ms']:.4f} ms ({ffl / t['fwd_ms'] / 1e9:.1f} "
              f"TFLOP/s), backward {t['bwd_ms']:.4f} ms "
              f"({bfl / t['bwd_ms'] / 1e9:.1f} TFLOP/s); simt "
              f"{t['simt_fwd_ms']:.3f} + {t['simt_bwd_ms']:.3f}; plain "
              f"{t['plain_fwd_ms']:.3f} + {t['plain_bwd_ms']:.3f}; sdpa fwd "
              f"{t['library_fwd_ms']:.4f}, fwd+bwd {t['library_ms']:.4f}; "
              f"bound {fb:.4f} + {bb:.4f} ({fo}); tc / sdpa: forward "
              f"{t['fwd_ms'] / t['library_fwd_ms']:.2f}x (target 1.5x), "
              f"forward + backward {t['ms'] / t['library_ms']:.2f}x "
              f"(target 2x); device time (CUDA graph): tc "
              f"{t['fwd_device_ms']:.4f} + {t['bwd_device_ms']:.4f} ms, sdpa "
              f"forward {t['library_fwd_device_ms']:.4f} "
              f"({t['fwd_device_ms'] / t['library_fwd_device_ms']:.2f}x)")
        t_all[label] = t
        del q, k, v, dout, out, lse, qt, kt, vt
    for label, b, s_, nq, nkv, d in K2_WIDE_SHAPES:
        t_all[label] = k2_wide(k2, dev, gen, b, s_, nq, nkv, d, label)
    return dict(t_all["train"], shapes=t_all, max_abs_err=worst_path_err)


def k2_wide(k2, dev, gen, b, s, nq, nkv, d, label, dv=None, tag="5",
            f32_tol=None):
    """K2 at a head dim only the simt route takes: f32 and bf16 against
    the plain version (bf16 also to ``K2_NORM_TOL``, f32 to ``f32_tol``),
    then the simt route's, the plain version's and SDPA's times in bf16
    beside the bound."""
    import torch
    import torch.nn.functional as F
    kw = dict(d=d, dv=dv, tag=tag)
    *_, f32_norms = k2_case(k2, dev, gen, b, s, nq, nkv, 0, torch.float32,
                            ["simt"], label, f32_tol=f32_tol, **kw)
    (q, k, v, dout, q_pos, k_pos), (out, lse), worst, norms = k2_case(
        k2, dev, gen, b, s, nq, nkv, 0, torch.bfloat16, ["simt"], label,
        **kw)
    norms["float32"] = f32_norms["simt"]
    check(k2.route_for(q, k, v, out, dout) == "simt",
          f"K2 {label}: the bf16 path does not take the simt route")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    t = {"fwd_ms": time_ms(lambda: k2.flash_attention_fwd(
             q, k, v, q_pos, k_pos), 3),
         "bwd_ms": time_ms(lambda: k2.flash_attention_bwd(
             q, k, v, out, dout, lse, q_pos, k_pos), 2),
         "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
             q, k, v, q_pos, k_pos), 2),
         "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
             q, k, v, out, dout, lse, q_pos, k_pos), 2),
         "library_fwd_ms": time_ms(sdpa, 20),
         "library_ms": time_ms(
             lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt), 20),
         "norm_err": norms, "max_abs_err": worst}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, nq, nkv, d, 2, dv=dv)
    fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
    bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations")
    print(f"[{tag}] K2 bf16 {label} ({b},{s},{nq}/{nkv},"
          f"{f'{d}/{dv}' if dv else d}) causal, simt route:"
          f" forward {t['fwd_ms']:.3f} ms ({ffl / t['fwd_ms'] / 1e9:.1f} "
          f"TFLOP/s), backward {t['bwd_ms']:.3f} ms "
          f"({bfl / t['bwd_ms'] / 1e9:.1f} TFLOP/s); plain "
          f"{t['plain_fwd_ms']:.3f} + {t['plain_bwd_ms']:.3f}; sdpa fwd "
          f"{t['library_fwd_ms']:.4f}, fwd+bwd {t['library_ms']:.4f} "
          f"({t['ms'] / t['library_ms']:.1f}x); bound {fb:.4f} + {bb:.4f} "
          f"({fo})")
    return t


def phase_two_layer(dev, dtype_name="float32"):
    """Full-width tinyllama cut to two layers, the same seeded weights on
    the CPU (plain versions) and on the card (kernels): serving prefill's
    and the first fused decode step's logits.  In f32 every K1 call takes
    the simt route; in bf16 the tc and decode routes, and the limit is set
    by bf16 rounding."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import matmul as k1
    from repro_torch.models import blocks, transformer
    from repro_torch.serve import kvcache
    dtype = getattr(torch, dtype_name)
    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2,
                              dtype=dtype_name)
    layout = ParallelPlan().validate(mode="serve").build()
    params = {"cpu": init_params(transformer.abstract_params(cfg),
                                 torch.Generator().manual_seed(0),
                                 "cpu", dtype)}
    params["cuda"] = tree_map(lambda t: t.to(dev), params["cpu"])
    lens, S, L, blk = [48, 33], 64, 128, 16
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(lens), S), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, cfg.vocab, n)
    length = np.asarray(lens, np.int32)
    p = np.arange(S)[None, :]
    pos2d = np.where(p < length[:, None], p, -1).astype(np.int32)
    out, nxt = {}, None
    for where in ("cpu", "cuda"):
        d = "cpu" if where == "cpu" else dev
        routes_before = dict(k1.launches_by_route)
        kv = kvcache.PagedKVCache(cfg, len(lens), L, block=blk,
                                  dtype=dtype)
        for i, n in enumerate(lens):
            check(kv.admit(i, n + 8), "two-layer: admission failed")
        pool = kv.init_pool(d)
        pl, col = transformer.prefill(
            cfg, layout, params[where],
            {"tokens": torch.from_numpy(tokens).to(d),
             "length": torch.from_numpy(length).to(d)})
        kvcache.scatter_prefill(
            pool, transformer.pack_prefill_cache(
                cfg, col, torch.from_numpy(pos2d).to(d)),
            torch.from_numpy(kv.prefill_phys_map(dict(enumerate(lens)), S))
            .to(d))
        if nxt is None:                   # both sides decode the CPU's tokens
            nxt = pl.argmax(-1).cpu()[:, None]
        page = blocks.PageInfo(tables=kv.tables_device(d),
                               active=torch.ones(len(lens), dtype=torch.bool,
                                                 device=d), block=blk)
        dl, _ = transformer.forward(
            cfg, layout, params[where],
            {"token": nxt.to(d), "pos": torch.from_numpy(length).to(d)},
            mode="decode", cache=pool, page=page)
        out[where] = (pl.float().cpu(), dl.float().cpu())
        routes = {r: k1.launches_by_route[r] - routes_before[r]
                  for r in k1.ROUTES}
    if dtype == torch.float32:
        # f32 on both; only the order of the sums differs
        tol, limit = 1e-3, "1e-03"
    else:
        # bf16 on both: each side rounds every activation to 8 bits of
        # mantissa, and a sum taken in another order may round a value to
        # its other neighbour; over two layers a handful of such flips
        # move a logit by a few bf16 ulps, so the limit is 16 ulps
        # (16 * 2**-8) of the largest logit
        tol, limit = None, "16 bf16 ulps of max |logit|"
    print(f"[6] two-layer full width {dtype_name}: K1 launches on the card "
          f"by route {routes}")
    want_routes = ({"simt"} if dtype == torch.float32 else {"tc", "decode"})
    check({r for r, c in routes.items() if c} <= want_routes
          and routes["simt" if dtype == torch.float32 else "decode"] > 0,
          f"two-layer {dtype_name}: K1 routes {routes}")
    for i, name in enumerate(("prefill last-position", "first decode step")):
        err = (out["cpu"][i] - out["cuda"][i]).abs().max().item()
        scale = out["cpu"][i].abs().max().item()
        lim = tol if tol is not None else 16 * 2 ** -8 * scale
        print(f"[6] two-layer full width {dtype_name} {name} logits: max abs "
              f"err {err:.2e} (tol {lim:.2e}: {limit}; |logits| up to "
              f"{scale:.2f})")
        check(err <= lim and math.isfinite(err), f"two-layer {name}: {err}")


def phase_two_layer_train(dev, arch="tinyllama-1.1b", seed=1, rows=2,
                          seq=512):
    """One training step's loss and gradients of a full-width model cut
    to two layers, f32, batch 2 x 512 (or ``rows`` x ``seq``): CPU (plain
    versions) against the card (kernels), the same seeded weights and
    tokens.  K2 must have run on the card, forward and backward:
    tinyllama-1.1b, and the paper's model (d 48) and gemma-2b (d 256),
    whose head dims only K2's simt route takes."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get(arch), n_layers=2, dtype="float32")
    layout = ParallelPlan().validate(mode="train").build()
    # drawn on the card (a CPU generator takes seconds for gemma's
    # 256000-word embedding), then copied: both sides start from these
    cpu = tree_map(lambda t: t.cpu(), init_params(
        transformer.abstract_params(cfg),
        torch.Generator(device=dev).manual_seed(seed), dev, torch.float32))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][-1, -7:] = -1
    res = {}
    for d in ("cpu", dev):
        before = (dict(k2.launches_by_route), dict(k2.launches_bwd_by_route))
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, _ = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        routes = {r: (k2.launches_by_route[r] - before[0][r],
                      k2.launches_bwd_by_route[r] - before[1][r])
                  for r in k2.ROUTES}
        res[str(d)] = (loss.item(), [g.cpu() for g in grads], routes)
        del live, loss, grads
    (l_cpu, g_cpu, r_cpu), (l_dev, g_dev, r_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    worst = max(scaled_err(a, b) for a, b in zip(g_dev, g_cpu))
    shown = {n: scaled_err(a, b) for n, a, b in zip(names, g_dev, g_cpu)
             if n in ("embed", "head", "ln_f.g", "stack.dense.ln1.g",
                      "stack.dense.attn.wq", "stack.dense.mlp.w_down")}
    tol = 1e-3      # f32 on both; the order of the sums differs
    print(f"[6] two-layer full width {arch} (d {cfg.d_head}, "
          f"{cfg.n_heads}/{cfg.n_kv} heads) f32 train step "
          f"({rows}x{seq}): loss cpu "
          f"{l_cpu:.6f} card {l_dev:.6f}; gradient errors relative to "
          f"1 + max: " + ", ".join(f"{k} {v:.1e}" for k, v in shown.items())
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"K2 launches (forward, backward) by route on the card {r_dev}")
    check(all(c == (0, 0) for c in r_cpu.values()),
          f"two-layer train {arch}: K2 counted CPU calls {r_cpu}")
    check(r_dev["simt"][0] > 0 and r_dev["simt"][1] > 0,
          f"two-layer train {arch}: K2 did not run on the card {r_dev}")
    check(abs(l_cpu - l_dev) <= 1e-4 and math.isfinite(l_dev),
          f"two-layer train {arch} loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer train {arch} gradients: {worst}")


def phase_k1_train(dev):
    """K1 at the training shapes: every GEMM of one training step of
    tinyllama, zamba2, mixtral cut to 2 layers and Moonlight cut to
    [dense, moe] (M = 4 x 2048 rows; the head's chunks 4 x 1024, or 4 x
    512 for Moonlight's 4), of deepseek-v3 cut to [dense, moe] with the
    mtp head (M = 1 x 2048; the head's chunks 512 rows), of whisper
    (``W_TRAIN_GEMMS``: 4 x 1504 frame rows and 4 x 448 text rows) and of
    internvl2 (``V_TRAIN_GEMMS``), through the route the step takes (tc),
    held against the plain version in bf16 with every activation, with and
    without bias; then timed as that route, the simt kernel (the first K1
    design), the plain version and ``torch.matmul``, each times its
    launches a step (forward and remat recompute), which must sum to the
    step's K1 launches where the script counts them."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(10)
    m = TRAIN_B * TRAIN_S
    ds_m = DS_TRAIN_B * TRAIN_S

    def at(rows, gemms):
        return [(name, rows, k, n, per) for name, k, n, per in gemms]
    mix = [(name, k, n, 2 * 2 * MIX_TRAIN_LAYERS) for name, k, n in
           MIX_GEMMS if name != "head"]
    moon = [(name, k, n, 2 * per) for name, k, n, per in MOON_GEMMS
            if name != "head"]
    # (arch, (name, rows, K, N, launches a step), the step's K1 launches)
    archs = (("tinyllama", at(m, TRAIN_GEMMS) + [("head", m // 2, D, VOCAB,
                                                  2 * 2)],
              TRAIN_LAUNCHES["K1"]),
             ("zamba2", at(m, Z_GEMMS) + [("head", m // 2, D, VOCAB, 2 * 2)],
              Z_LAUNCHES["K1"]),
             ("mixtral", at(m, mix) + [("head", m // 2, MIX_D, MIX_VOCAB,
                                         2 * 2)], MIX_LAUNCHES["K1"]),
             ("moonlight", at(m, moon) + [("head", m // 4, MOON_D,
                                           MOON_VOCAB, 2 * 4)], None),
             ("deepseek", at(ds_m, DS_TRAIN_GEMMS) + [
                 ("head", ds_m // 4, DS_D, DS_VOCAB, 2 * 2 * 4)],
              DS_LAUNCHES["K1"]),
             ("whisper", W_TRAIN_GEMMS, W_LAUNCHES["K1"]),
             ("internvl2", V_TRAIN_GEMMS, V_LAUNCHES["K1"]))
    seen, out, worst_err = {}, {}, 0.0
    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms")
    for arch, gemms, want in archs:
        tot = dict.fromkeys(keys, 0.0)
        launches = flops = 0
        for name, rows, k, n, per_step in gemms:
            key = (rows, k, n)
            if key not in seen:
                path = k1.route(rows, n, k, torch.bfloat16, True)
                check(path == "tc", f"K1 train {arch} {name} ({rows},{k},"
                      f"{n}): route {path}")
                x, w, b = k1_inputs(gen, dev, rows, k, n, torch.bfloat16)
                worst, worst_abs = k1_check(k1, x, w, b)
                worst_err = max(worst_err, worst_abs)
                check(worst <= 1e-2, f"K1 train {arch} {name} tc: {worst}")
                del x, w, b
                t = k1_time(k1, dev, gen, rows, k, n, 10,
                            {"ms": path, "simt_ms": "simt"})
                seen[key] = t
                print(f"[10] K1 train GEMM ({rows},{k})@({k},{n}) bf16 tc "
                      f"(tile 128x{k1.tile_n(rows, n)}): max rel err "
                      f"{worst:.2e} (tol 1e-02); {t['ms']:.3f} ms "
                      f"({2 * rows * k * n / t['ms'] / 1e9:.1f} TFLOP/s), "
                      f"simt {t['simt_ms']:.3f}, plain {t['plain_ms']:.3f}, "
                      f"torch.matmul {t['library_ms']:.3f}, bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']})")
            for key2 in tot:
                tot[key2] += per_step * seen[key][key2]
            launches += per_step
            flops += per_step * 2 * rows * k * n
        check(want is None or launches == want,
              f"K1 {arch} train GEMMs: {launches} a step, not {want}")
        print(f"[10] K1 per {arch} training step ({launches} GEMMs, bf16): "
              f"kernel {tot['ms']:.1f} ms ({flops / tot['ms'] / 1e9:.1f} "
              f"TFLOP/s), {tot['ms'] / tot['library_ms']:.2f}x torch.matmul "
              f"{tot['library_ms']:.1f} ms (target 1.5x, limit 3x); simt "
              f"{tot['simt_ms']:.1f} ms, plain {tot['plain_ms']:.1f} ms, "
              f"bound {tot['bound_ms']:.1f} ms")
        out[arch] = tot
    return out, worst_err


def k5_work(b, T, Q, bc_elt):
    """(fwd bytes, fwd flops, bwd bytes, bwd flops) of one SSD scan at
    zamba2's heads: each input read once and each output written once;
    the flops over the allowed (i >= j) pairs of each chunk (forward C.B
    and S.xbar; backward dy.xbar, S^T dy, dS B and dS^T C, not the kernel's
    recompute of C.B) plus the carried-state products of every row (2
    forward, 4 backward)."""
    nc = T // Q
    pairs = b * Z_NH * nc * Q * (Q + 1) // 2
    rows = b * T * Z_NH
    io = b * T * Z_NH * DH * 4                 # xbar, y, dy, dxbar: f32
    small = b * T * Z_NH * 4 + 2 * b * T * Z_G * Z_N * bc_elt
    fwd = (2 * io + small, pairs * (2 * Z_N + 2 * DH) + rows * 4 * Z_N * DH)
    bwd = (3 * io + 2 * small,
           pairs * (4 * Z_N + 4 * DH) + rows * 8 * Z_N * DH)
    return (*fwd, *bwd)


# K5: the limits on ||got - want|| / ||want|| against the plain version
# (set in k5_case's comment from the readings); "la << 0" is the case of
# log-decays near -200 a step, where the decays differ by up to ~1%
K5_NORM_TOL = {
    "float32": dict.fromkeys(("y", "states", "dxbar", "dla", "dB", "dC"),
                             5e-6),
    "bfloat16": dict(dict.fromkeys(("y", "states", "dxbar", "dla"), 5e-6),
                     dB=2.5e-4, dC=2.5e-4),
    "la << 0": dict(y=1e-4, states=3e-4, dxbar=1e-4, dla=3e-3, dB=1e-4,
                    dC=1e-4)}


def k5_case(k5, dev, gen, label, b, T, dtype, la_scale, tag="[11]"):
    """K5's forward and backward against the plain version at zamba2's
    heads (b, T): y, states, dxbar, dla, dB and dC within the scaled limit
    and within ``K5_NORM_TOL`` of the plain version's norm, every output
    finite, and two backward runs giving the same bits.  Returns the
    inputs, the states and the worst absolute error."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    xbar = 0.5 * rnd(b, T, Z_NH, DH)
    la = -la_scale * rnd(b, T, Z_NH).abs()
    B = (0.3 * rnd(b, T, Z_G, Z_N)).to(dtype)
    C = (0.3 * rnd(b, T, Z_G, Z_N)).to(dtype)
    dy = rnd(b, T, Z_NH, DH)
    y, st = k5.ssd_scan_fwd(xbar, la, B, C, Z_CHUNK)
    grads = k5.ssd_scan_bwd(dy, xbar, la, B, C, st, Z_CHUNK)
    y2, st2 = k5.ssd_scan_plain(xbar, la, B, C, Z_CHUNK)
    grads2 = k5.ssd_scan_bwd_plain(dy, xbar, la, B, C, st2, Z_CHUNK)
    pairs = [("y", y, y2), ("states", st, st2)] + list(
        zip(("dxbar", "dla", "dB", "dC"), grads, grads2))
    errs = {n: scaled_err(a, c) for n, a, c in pairs}
    norms = {n: norm_err(a, c) for n, a, c in pairs}
    finite = all(bool(torch.isfinite(t).all()) for t in (y, *grads))
    again = k5.ssd_scan_bwd(dy, xbar, la, B, C, st, Z_CHUNK)
    same = all(torch.equal(a, g) for a, g in zip(again, grads))
    # f32 everywhere but dB and dC in bf16, which round once.  With la
    # near -160 a step, cum reaches -4e4 in a chunk, where one f32 ulp is
    # 4e-3: a decay exp(cum_i - cum_j) between neighbours is the difference
    # of two such sums, and the kernel's and torch.cumsum's orders may
    # differ by an ulp or two, so those decays may differ by ~1%: 1e-2
    # there (the case is for the masked exponent, NaN-free).  The norm
    # limits are 3-6x the readings of the redesign (on an H100): f32
    # 0.8-1.4e-6, bf16 B/C dB and dC 5.5-5.9e-5; la << 0, over three
    # seeds, y and dxbar 1.1-2.9e-5, states 0-7.8e-5, dla 4.7-7.2e-4, dB
    # and dC 0.5-3.3e-5
    tol = 1e-4 if dtype == torch.float32 and la_scale < 1 else 1e-2
    ntol = K5_NORM_TOL["la << 0" if la_scale >= 1 else str(dtype)[6:]]
    print(f"{tag} K5 {label:13s} ({b},{T},{Z_NH},{DH}) B/C "
          f"{str(dtype)[6:]:8s} errors " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {tol:.0e}, relative to 1 + max); ||error|| / ||plain|| "
          + ", ".join(f"{k} {v:.2e}" for k, v in norms.items())
          + " (tol " + ", ".join(f"{k} {v:.1e}" for k, v in ntol.items())
          + f"); finite {finite}; backward repeats bit for bit {same}")
    check(all(norms[k] <= ntol[k] for k in ntol),
          f"K5 {label} {dtype}: ||error|| / ||plain|| {norms}")
    check(finite, f"K5 {label} {dtype}: a non-finite output")
    check(same, f"K5 {label} {dtype}: backward not deterministic")
    check(max(errs.values()) <= tol, f"K5 {label} {dtype}: {errs}")
    worst = max(abs_err(a, c) for n, a, c in pairs)
    return (xbar, la, B, C, dy), st, worst, norms


# (label, b, T, B/C dtype, log-decay scale): T 2000 gives Q = 250, a chunk
# of 3 whole and one 58-row sub-chunk; la near -200 a step would overflow
# any exponent formed above the diagonal
K5_CASES = [("train shape", TRAIN_B, TRAIN_S, "float32", 0.1),
            ("train shape", TRAIN_B, TRAIN_S, "bfloat16", 0.1),
            ("ragged T=2000", 1, 2000, "float32", 0.1),
            ("la << 0", 1, TRAIN_S, "float32", 200.0)]


def phase_k5(dev):
    """K5 at zamba2's training shape of one layer.  The model's B and C are
    f32 (the SiLU of the conv runs in f32), so the path case is f32; bf16
    B/C is checked too.  Returns the path case's numbers, the kernel's
    time as one forward + one backward."""
    import torch
    from repro_torch.kernels import ssd_scan as k5
    gen = torch.Generator(device=dev).manual_seed(5)
    worst_path_err, path = 0.0, None
    for label, b, T, dtype, scale in K5_CASES:
        inputs, st, worst, norms = k5_case(k5, dev, gen, label, b, T,
                                           getattr(torch, dtype), scale)
        if label == "train shape" and dtype == "float32":
            worst_path_err, path, path_norms = worst, (*inputs, st), norms
        del inputs, st
    xbar, la, B, C, dy, st = path
    t = {"fwd_ms": time_ms(lambda: k5.ssd_scan_fwd(xbar, la, B, C, Z_CHUNK),
                           10),
         "bwd_ms": time_ms(lambda: k5.ssd_scan_bwd(dy, xbar, la, B, C, st,
                                                   Z_CHUNK), 5),
         "plain_fwd_ms": time_ms(lambda: k5.ssd_scan_plain(xbar, la, B, C,
                                                           Z_CHUNK), 3),
         "plain_bwd_ms": time_ms(lambda: k5.ssd_scan_bwd_plain(
             dy, xbar, la, B, C, st, Z_CHUNK), 3),
         "library_ms": None}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    t["kernels_ms"] = kernels_by_name(
        lambda: (k5.ssd_scan_fwd(xbar, la, B, C, Z_CHUNK),
                 k5.ssd_scan_bwd(dy, xbar, la, B, C, st, Z_CHUNK)), 3)
    print("[11] K5 kernels, device time of one forward and one backward "
          "(torch.profiler): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in t["kernels_ms"].items()))
    fby, ffl, bby, bfl = k5_work(TRAIN_B, TRAIN_S, Z_CHUNK, 4)
    # the operations at the dense bf16 peak, as K2's: the least time the
    # card could take; the f32 rate outside the tensor cores is printed
    fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
    bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations",
             max_abs_err=worst_path_err, norm_err=path_norms)
    fw, bw = t["fwd_ms"], t["bwd_ms"]
    print(f"[11] K5 f32 B/C ({TRAIN_B},{TRAIN_S}, {Z_NH} heads of {DH}, "
          f"{Z_G} groups, N {Z_N}, Q {Z_CHUNK}): forward {fw:.3f} ms "
          f"({ffl / fw / 1e9:.2f} TFLOP/s, {fby / fw / 1e6:.1f} GB/s; plain "
          f"{t['plain_fwd_ms']:.3f}; bound {fb:.4f} {fo}: {fby / 1e9:.3f} GB "
          f"and {ffl / 1e9:.2f} GFLOP, {ffl / H100_F32_FLOPS * 1e3:.4f} ms "
          f"at the f32 rate); backward {bw:.3f} ms ({bfl / bw / 1e9:.2f} "
          f"TFLOP/s; plain {t['plain_bwd_ms']:.3f}; bound {bb:.4f} {bo}: "
          f"{bby / 1e9:.3f} GB and {bfl / 1e9:.2f} GFLOP, "
          f"{bfl / H100_F32_FLOPS * 1e3:.4f} ms at the f32 rate); no PyTorch "
          "call computes this scan")
    return t


def phase_two_layer_zamba2(dev):
    """One training step's loss and gradients of full-width zamba2 cut to
    the plan [mamba, mamba, attn] (n_layers 2, attn_every 2), f32, batch 1
    x 512: CPU (plain versions) against the card (kernels), the same
    seeded weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import ssd_scan as k5
    from repro_torch.models import transformer
    base = get("zamba2-1.2b")
    cfg = dataclasses.replace(base, n_layers=2, dtype="float32",
                              ssm=dataclasses.replace(base.ssm, attn_every=2))
    layout = ParallelPlan().validate(mode="train").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(2), "cpu",
                      torch.float32)
    rng = np.random.default_rng(2)
    m = cpu["stack"]["mamba"]        # the init leaves these 0 and 1
    for k in ("dt_bias", "A_log", "D"):
        m[k] += torch.from_numpy(0.3 * rng.standard_normal(m[k].shape)
                                 .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 513)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, -9:] = -1
    res = {}
    for d in ("cpu", dev):
        before = k5.launches_bwd
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, _ = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[str(d)] = (loss.item(), [g.cpu() for g in grads],
                       k5.launches_bwd - before)
    (l_cpu, g_cpu, n_cpu), (l_dev, g_dev, n_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    # each leaf against its own largest entry, so that a fault in a leaf
    # of small gradients (w_bc through dB and dC) shows as plainly as one
    # in a large leaf
    errs = {n: (leaf_err(a, b), b.abs().max().item())
            for n, a, b in zip(names, g_dev, g_cpu)}
    worst = max(e for e, _ in errs.values())
    tol = 1e-4      # f32 on both; the order of the sums differs
    print(f"[12] zamba2 [mamba, mamba, attn] full width f32 train step "
          f"(1x512): loss cpu {l_cpu:.6f} card {l_dev:.6f}; gradient "
          f"max |card - cpu| / max |cpu| per leaf, worst first (max |cpu| "
          f"in brackets): " + ", ".join(
              f"{k} {e:.1e} [{g:.1e}]" for k, (e, g) in sorted(
                  errs.items(), key=lambda kv: -kv[1][0])[:8])
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"K5 backward launches cpu {n_cpu}, card {n_dev}")
    check(n_cpu == 0 and n_dev == 2, f"two-layer zamba2: K5 backward "
          f"launches cpu {n_cpu}, card {n_dev}")
    check(abs(l_cpu - l_dev) <= 1e-4 and math.isfinite(l_dev),
          f"two-layer zamba2 train loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer zamba2 train gradients: {worst}")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def reset_launches():
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.kernels import ssd_scan as k5
    k1.launches = k2.launches = k2.launches_bwd = k3.launches = 0
    k3.launches_bwd = k4.launches = k5.launches = k5.launches_bwd = 0
    k3.launches_moments = k3.launches_apply = 0
    k3.launches_bwd_dot = k3.launches_bwd_apply = 0
    k4.launches_combine = 0
    k1.launches_by_route = dict.fromkeys(k1.ROUTES, 0)
    k4.launches_by_route = dict.fromkeys(k4.ROUTES, 0)
    k2.launches_by_route = dict.fromkeys(k2.ROUTES, 0)
    k2.launches_bwd_by_route = dict.fromkeys(k2.ROUTES, 0)


def check_k2_routes(launches, tag, label, route="tc"):
    """The K2 launches of a main-path run by route, forward and backward:
    every bf16 attention takes ``route`` (tc; simt at MLA's dk 192 / dv
    128), and the routes add up to the totals."""
    from repro_torch.kernels import flash_attention as k2
    routes = {"K2": dict(k2.launches_by_route),
              "K2 bwd": dict(k2.launches_bwd_by_route)}
    print(f"[{tag}] K2 launches by route in the {label}: {routes}")
    for key, by in routes.items():
        other = sum(n for r, n in by.items() if r != route)
        check(other == 0, f"{label}: {other} bf16 {key} launches took "
              f"another route than {route}")
        check(sum(by.values()) == launches[key],
              f"{label}: {key} routes {by} != total {launches[key]}")
    return routes


def check_k1_routes(launches, tag, label):
    """The K1 launches of a main-path run by route: every bf16 GEMM takes
    tc or decode, none simt, and the routes add up to the total."""
    from repro_torch.kernels import matmul as k1
    routes = dict(k1.launches_by_route)
    print(f"[{tag}] K1 launches by route in the {label}: {routes}")
    check(routes["simt"] == 0, f"{label}: {routes['simt']} bf16 K1 GEMMs "
          "took the simt route")
    check(sum(routes.values()) == launches["K1"],
          f"{label}: K1 routes {routes} != total {launches['K1']}")
    return routes


def read_launches():
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.kernels import ssd_scan as k5
    return {"K1": k1.launches, "K2": k2.launches, "K2 bwd": k2.launches_bwd,
            "K3": k3.launches, "K3 bwd": k3.launches_bwd, "K4": k4.launches,
            "K4 combine": k4.launches_combine, "K5": k5.launches,
            "K5 bwd": k5.launches_bwd}


def check_k4_routes(launches, label, tag="7", route="split"):
    """The K4 launches of a serving run by route: every bf16 decode step
    takes ``route``: split, each with its combine pass, or (MLA's latent
    decode, q in f32) simt, with none."""
    from repro_torch.kernels import paged_decode as k4
    routes = dict(k4.launches_by_route)
    print(f"[{tag}] K4 launches by route in the {label}: {routes}, combine "
          f"passes {launches['K4 combine']}")
    other = sum(n for r, n in routes.items() if r != route)
    check(other == 0, f"{label}: {other} K4 launches took another route "
          f"than {route}")
    combines = launches["K4"] if route == "split" else 0
    check(routes[route] == launches["K4"]
          and launches["K4 combine"] == combines,
          f"{label}: K4 routes {routes} != total {launches['K4']}")
    return routes


def phase_serve(card, k4_serve_ms):
    import torch
    from repro_torch.launch import serve
    reset_launches()
    stats = serve.main(["--arch", "tinyllama-1.1b", "--device", "cuda",
                        "--requests", "8", "--batch-size", "8",
                        "--shared-prefix", "256", "--max-new", "32",
                        "--max-len", "512", "--block-size", "16"])
    torch.cuda.synchronize()
    launches = read_launches()
    steps = stats["prefill_steps"] + stats["decode_steps"]
    want = {"K1": 155 * steps, "K2": LAYERS * stats["prefill_steps"],
            "K2 bwd": 0, "K3": (2 * LAYERS + 1) * steps, "K3 bwd": 0,
            "K4": LAYERS * stats["decode_steps"],
            "K4 combine": LAYERS * stats["decode_steps"], "K5": 0,
            "K5 bwd": 0}
    print(f"[7] launches in the serving run: {launches} over "
          f"{stats['prefill_steps']} prefill + {stats['decode_steps']} decode "
          f"steps (expected {want})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"serving run: {stats['tokens']} tokens, {stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"serving run: {stats['nonfinite_rows']} non-finite logit rows")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")),
          f"serving run skipped a kernel: {launches}")
    check(launches == want, f"serving run launches {launches} != {want}")
    routes = check_k1_routes(launches, "7", "serving run")
    check(routes["tc"] > 0 and routes["decode"] > 0,
          f"serving run: K1 routes {routes}")
    k2_routes = check_k2_routes(launches, "7", "serving run")
    k4_routes = check_k4_routes(launches, "serving run")
    print(f"[7] K4 device time per decode step: {LAYERS} layers x "
          f"{k4_serve_ms:.4f} ms (the split step at the serve shape, phase "
          f"3) = {LAYERS * k4_serve_ms:.4f} ms")
    print(f"[7] serving tinyllama-1.1b bf16, 8 requests x 32 new tokens on "
          f"{card}: TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{stats['tpot_p50_s'] * 1e3:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} tok/s")
    return launches, routes, k2_routes, k4_routes, stats["ttft_p50_s"] * 1e3


def serve_requests(n, shared=256, max_new=32):
    """``launch/serve.py``'s synthetic requests: a common prefix of
    ``shared`` tokens and a tail of 3-7."""
    from repro_torch.serve import Request
    common = [3 + j % 13 for j in range(shared)]
    return [Request(uid=i, prompt=common + [2 + (i + j) % 17
                                            for j in range(3 + i % 5)],
                    max_new=max_new) for i in range(n)]


def served_model(dev, dtype_name="bfloat16", n_layers=None, n=8,
                 max_new=32):
    """Full-width tinyllama-1.1b (cut to ``n_layers``) with weights from
    seed 0, as ``launch/serve.py`` draws them, an engine factory of batch
    8 and max_len 512 over them, and the plain engine's tokens for
    ``serve_requests(n, max_new=max_new)``: (cfg, layout, params,
    engine(**kw), tokens).  Built once and shared by phases 7p, 7g and
    7s."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(get("tinyllama-1.1b"),
                              n_layers=n_layers or LAYERS, dtype=dtype_name)
    layout = ParallelPlan().validate(mode="serve").build()
    params = init_params(transformer.abstract_params(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         getattr(torch, dtype_name))

    def engine(**kw):
        return Engine(cfg, layout, params, batch_size=8, max_len=512, **kw)
    plain = serve_requests(n, max_new=max_new)
    engine().run(plain)
    return cfg, layout, params, engine, [r.out for r in plain]


def equal_share(got, want):
    """The share of emitted tokens equal to the plain engine's, position by
    position."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    return same / max(1, sum(len(w) for w in want))


# zamba2 served (phase 7z): every step is a decode step (sequential
# prefill); per step K1 runs the 5 linears of each Mamba layer, the 7 of
# each shared-block use and the head, K3 the 2 norms of each Mamba layer
# and of each use and ln_f, K4 the attention of each use (with its combine
# pass)
Z_SERVE_STEP = {"K1": 5 * Z_LAYERS + 7 * Z_SHARED + 1,
                "K2": 0, "K2 bwd": 0,
                "K3": 2 * Z_LAYERS + 2 * Z_SHARED + 1, "K3 bwd": 0,
                "K4": Z_SHARED, "K4 combine": Z_SHARED, "K5": 0,
                "K5 bwd": 0}


def param_bytes(tree):
    """Bytes of a tree of Params, bf16 where a leaf pins no dtype."""
    import torch
    from repro_torch.core.params import tree_leaves
    return sum(math.prod(p.shape) * (p.dtype or torch.bfloat16).itemsize
               for p in tree_leaves(tree))


def zamba2_step_bytes(prompts, max_new, block=16, L=512):
    """(bytes per step on average, steps, parts) of 7z's decode steps,
    each input read once and each output written once: the weights (of the
    embedding only the slots' rows), and for each slot still running its
    f32 recurrent state and conv tails read and written and, in each use
    of the shared block, the kv entries K4 attends (as ``k4_bound`` counts
    them: q in and out, the valid K and V, the positions of the table's
    columns, the table and cur) with the new entry written.  A slot of
    prompt p runs p + max_new - 1 steps, its context t + 1 at step t."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    params = transformer.abstract_params(get("zamba2-1.2b"))
    weights = param_bytes(params) - param_bytes({"e": params["embed"]})
    state = Z_LAYERS * Z_NH * 64 * Z_N * 4
    conv = Z_LAYERS * (Z_CONV - 1) * (Z_DIN + 2 * Z_G * Z_N) * 4
    entry = Z_HEADS * DH * 2 * 2                 # one position's K and V
    runs = [p + max_new - 1 for p in prompts]
    steps, slot_steps = max(runs), sum(runs)
    kv = Z_SHARED * sum(
        Z_HEADS * DH * 2 * 2 + t * entry + entry
        + (L // block) * (block + 1) * 4 + 4
        for n in runs for t in range(1, n + 1))
    parts = {"weights": steps * weights, "embed rows": slot_steps * D * 2,
             "state": slot_steps * 2 * state, "conv tails":
             slot_steps * 2 * conv, "shared-block kv": kv}
    return sum(parts.values()) / steps, steps, {
        k: v / steps for k, v in parts.items()}


def phase_serve_zamba2(card):
    """``repro_torch.launch.serve`` serves zamba2-1.2b at full depth and
    width in bf16, weights from a seed: 8 requests in batch 8, prompts of
    43-47 tokens fed one a step, 32 new tokens each, max_len 512, greedy.
    The launch counters reset just before and read just after; the
    launches per step are exact, and no bf16 GEMM or decode attention
    takes simt.  Returns the launcher's engine too, for the breakdown."""
    import torch
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.launch import serve
    from repro_torch.serve import Engine
    built, run = [], Engine.run

    def keep(self, *args, **kw):                 # the launcher's engine
        built.append(self)
        return run(self, *args, **kw)
    Engine.run = keep
    reset_launches()
    try:
        stats = serve.main(["--arch", "zamba2-1.2b", "--device", "cuda",
                            "--requests", "8", "--batch-size", "8",
                            "--shared-prefix", "40", "--max-new", "32",
                            "--max-len", "512"])
        torch.cuda.synchronize()
    finally:
        Engine.run = run
    launches = read_launches()
    steps = stats["decode_steps"]
    want = {k: n * steps for k, n in Z_SERVE_STEP.items()}
    print(f"[7z] launches in the zamba2 serving run: {launches} over "
          f"{stats['prefill_steps']} prefill + {steps} decode steps "
          f"(expected {want})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"zamba2 serving run: {stats['tokens']} tokens, "
          f"{stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"zamba2 serving run: {stats['nonfinite_rows']} non-finite rows")
    check(stats["prefill_steps"] == 0 and launches == want,
          f"zamba2 serving run launches {launches} != {want}")
    routes = check_k1_routes(launches, "7z", "zamba2 serving run")
    k4_routes = dict(k4.launches_by_route)
    check(k4_routes["simt"] == 0 and k4_routes["split"] == launches["K4"],
          f"zamba2 serving run: K4 routes {k4_routes}")
    step_bytes, want_steps, parts = zamba2_step_bytes(
        [len(r.prompt) for r in serve_requests(8, shared=40)], 32)
    check(steps == want_steps, f"zamba2 serving run: {steps} decode steps, "
          f"the bound counts {want_steps}")
    bound = step_bytes / H100_BYTES_PER_S * 1e3
    print(f"[7z] serving zamba2-1.2b bf16, 8 requests (prompts 43-47 fed one "
          f"a step) x 32 new tokens on {card}: TTFT p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{stats['tpot_p50_s'] * 1e3:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} "
          f"tok/s; a step's bound on average {bound:.3f} ms ("
          + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in parts.items())
          + " a step, at 3.35 TB/s)")
    return launches, routes, k4_routes, built[0], {
        "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "tpot_p50_ms": stats["tpot_p50_s"] * 1e3,
        "tok_per_s": stats["tok_per_s"], "step_bound_ms": bound}


def phase_two_layer_zamba2_serve(dev):
    """Phase 12's model (full-width zamba2 cut to [mamba, mamba, attn],
    f32, the same seeded weights) through the decode path: a 16-token
    sequential prefill and 8 greedy decode steps of 2 slots, CPU (plain
    versions) against the card (kernels): logits within 1e-4 of 1 + max
    at every step, the same greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.models import transformer
    from repro_torch.serve.kvcache import cache_with_dtype
    base = get("zamba2-1.2b")
    cfg = dataclasses.replace(base, n_layers=2, dtype="float32",
                              ssm=dataclasses.replace(base.ssm, attn_every=2))
    layout = ParallelPlan().validate(mode="serve").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(2), "cpu", torch.float32)
    rng = np.random.default_rng(2)
    m = cpu["stack"]["mamba"]
    for k in ("dt_bias", "A_log", "D"):
        m[k] += torch.from_numpy(0.3 * rng.standard_normal(m[k].shape)
                                 .astype(np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    tree = cache_with_dtype(transformer.abstract_cache(cfg, layout, 2, 512),
                            torch.float32)
    res = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), cpu)
        cache = init_params(tree, None, d)
        before = k4.launches
        logits, toks = [], []
        tok = prompt[:, :1]
        for t in range(16 + 8):
            lg, cache = transformer.forward(
                cfg, layout, params, {"token": tok.to(d),
                                      "pos": torch.full((2,), t,
                                                        dtype=torch.int32,
                                                        device=d)},
                mode="decode", cache=cache)
            lg = lg.float().cpu()
            logits.append(lg)
            nxt = lg.argmax(-1)[:, None]
            toks.append(nxt)
            tok = prompt[:, t + 1:t + 2] if t + 1 < 16 else nxt
        res[str(d)] = (torch.stack(logits), torch.cat(toks, 1),
                       k4.launches - before)
    (l_cpu, t_cpu, n_cpu), (l_dev, t_dev, n_dev) = res["cpu"], res[str(dev)]
    err = ((l_dev - l_cpu).abs().amax(dim=(1, 2))
           / (1 + l_cpu.abs().amax(dim=(1, 2))))
    print(f"[12s] zamba2 [mamba, mamba, attn] full width f32 decode path (2 "
          f"slots, 16 prompt tokens one a step, 8 greedy steps): logits max "
          f"|card - cpu| / (1 + max |cpu|) per step, worst "
          f"{err.max().item():.1e} (tol 1e-4); greedy tokens equal "
          f"{torch.equal(t_cpu[:, 15:], t_dev[:, 15:])}; K4 launches cpu "
          f"{n_cpu}, card {n_dev}")
    check(n_cpu == 0 and n_dev == 24, f"zamba2 decode path: K4 launches "
          f"cpu {n_cpu}, card {n_dev} (expected 0 and 24)")
    check(err.max().item() <= 1e-4 and torch.isfinite(l_dev).all(),
          f"zamba2 decode path logits: {err.tolist()}")
    check(torch.equal(t_cpu[:, 15:], t_dev[:, 15:]),
          f"zamba2 decode path greedy tokens differ: {t_cpu} vs {t_dev}")


def check_equal_tokens(f32, tag, label, passes=1, draft_layers=False,
                       mid_chain=False, **kw):
    """The f32 equality check on ``f32`` (``served_model``'s full-width
    tinyllama cut to 4 layers, 4 requests with a shared 256-token prefix x
    8 new tokens): the engine of ``kw``, with a draft of ``draft_layers``
    layers (None: the target itself; False: none), run ``passes`` times,
    gives the plain engine's tokens; with ``mid_chain``, some verify also
    rejects a draft after accepting the one before it."""
    cfg, layout, params, engine, base = f32
    if draft_layers is not False:
        kw["draft"] = draft_for(cfg, layout, params, draft_layers)
    eng = engine(**kw)
    rounds = spec_rounds(eng) if "draft" in kw else None
    for i in range(passes):
        reqs = serve_requests(4, max_new=8)
        st = eng.run(reqs)
        same = [r.out for r in reqs] == base
        print(f"[{tag}] f32 4-layer {label}, pass {i + 1}: tokens equal to "
              f"the plain engine's: {same}"
              + (f" (prefix hits {st['prefix_hits']})" if kw.get(
                  "prefix_cache") else "")
              + (f" (accepted mean {st['accepted_mean']:.2f}; chains by "
                 f"outcome {chains(rounds, kw['draft'].gamma)})"
                 if rounds is not None else ""))
        check(same, f"{label} pass {i + 1}: {[r.out for r in reqs]} != "
              f"{base}")
    if mid_chain:
        by = chains(rounds, kw["draft"].gamma)
        check(by["rejected mid-chain"] > 0, f"{label}: no verify rejected "
              f"a draft after accepting the one before it: {by}")


def spec_rounds(eng):
    """Records (accepted, limit) of each active row of every verify the
    engine runs."""
    rec, verify = [], eng._verify

    def recording(*args):
        out = verify(*args)
        length, limit = args[6], args[9]
        rec.extend((a, lim) for a, lim, n in zip(
            out[0].tolist(), limit.tolist(), length.tolist()) if n)
        return out
    eng._verify = recording
    return rec


def chains(rounds, gamma):
    """Verified chains by outcome: every draft within the limit accepted,
    the first rejected, or one rejected after the one before it was
    accepted (0 < accepted < min(γ, limit))."""
    by = dict.fromkeys(("all accepted", "first rejected",
                        "rejected mid-chain"), 0)
    for a, lim in rounds:
        by["all accepted" if a == min(gamma, lim) else
           "first rejected" if a == 0 else "rejected mid-chain"] += 1
    return by


def draft_for(cfg, layout, params, n_layers, gamma=4):
    """The target itself (``n_layers`` None) or the target cut to its
    first ``n_layers`` layers, sharing embed and head, as a draft."""
    from repro_torch.core.params import tree_map
    from repro_torch.serve.speculate import DraftSpec
    if n_layers is None:
        return DraftSpec(cfg, layout, params, gamma=gamma)
    cut = dict(params, stack=tree_map(lambda t: t[:n_layers],
                                      params["stack"]))
    return DraftSpec(dataclasses.replace(cfg, n_layers=n_layers), layout,
                     cut, gamma=gamma)


def phase_prefix(bf16, f32, card, ttft7_ms):
    """The prefix cache: tinyllama-1.1b bf16 (``bf16``, from
    ``served_model``) serves phase 7's 8 requests (a shared 256-token
    prefix) twice on one engine with prefix_cache=True; the second pass
    must hit 8 times.  Tails prefill through extend over the gathered view
    (PyTorch attention, so no K2), decode through K4 split.  Then the f32
    equality check."""
    import torch
    *_, engine, plain = bf16
    eng = engine(prefix_cache=True)
    out = []
    reset_launches()
    for i in range(2):
        reqs = serve_requests(8)
        st = eng.run(reqs)
        check(st["tokens"] == 8 * 32 and st["nonfinite_rows"] == 0,
              f"prefix pass {i + 1}: {st['tokens']} tokens, "
              f"{st['nonfinite_rows']} non-finite rows")
        share = equal_share([r.out for r in reqs], plain)
        out.append({"ttft_p50_ms": st["ttft_p50_s"] * 1e3,
                    "tok_per_s": st["tok_per_s"],
                    "prefix_hits": st["prefix_hits"],
                    "tokens_reused": st["prefix_tokens_reused"],
                    "equal_share": share})
        print(f"[7p] prefix cache pass {i + 1} on {card}: prefix hits "
              f"{st['prefix_hits']}/{st['prefix_lookups']}, "
              f"{st['prefix_tokens_reused']} tokens reused; TTFT p50 "
              f"{st['ttft_p50_s'] * 1e3:.1f} ms (phase 7 without the cache "
              f"{ttft7_ms:.1f} ms), TPOT p50 {st['tpot_p50_s'] * 1e3:.2f} "
              f"ms, {st['tok_per_s']:.1f} tok/s; bf16 tokens equal to the "
              f"plain engine's: {share * 100:.1f}%")
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[7p] launches over both passes: {launches}")
    check(out[1]["prefix_hits"] == 8,
          f"prefix cache: warm pass hit {out[1]['prefix_hits']} of 8")
    check(launches["K2"] == 0 and launches["K4"] > 0,
          f"prefix cache: launches {launches}")
    check_k1_routes(launches, "7p", "prefix-cache runs")
    check_k4_routes(launches, "prefix-cache runs", tag="7p")
    check_equal_tokens(f32, "7p", "prefix cache", prefix_cache=True,
                       passes=2)
    return out


def phase_gather(bf16, f32, card):
    """The gather-view decode (``fused_decode=False``): tinyllama-1.1b bf16
    serves phase 7's 8 requests decoding over each slot's gathered view
    as a contiguous cache, so every decode attention is K4 split through
    the identity table (exactly LAYERS a step); then the f32 equality
    check."""
    import torch
    *_, engine, fused = bf16
    reqs = serve_requests(8)
    reset_launches()
    st = engine(fused_decode=False).run(reqs)
    torch.cuda.synchronize()
    launches = read_launches()
    share = equal_share([r.out for r in reqs], fused)
    print(f"[7g] gather-view decode on {card}: TTFT p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
          f"{st['tpot_p50_s'] * 1e3:.2f} ms, {st['tok_per_s']:.1f} tok/s; "
          f"bf16 tokens equal to the fused decode's: {share * 100:.1f}%; "
          f"launches {launches}")
    check(st["tokens"] == 8 * 32 and st["nonfinite_rows"] == 0,
          f"gather-view decode: {st['tokens']} tokens, "
          f"{st['nonfinite_rows']} non-finite rows")
    check(launches["K4"] == LAYERS * st["decode_steps"],
          f"gather-view decode: K4 launches {launches['K4']} != "
          f"{LAYERS} x {st['decode_steps']}")
    check_k1_routes(launches, "7g", "gather-view run")
    check_k4_routes(launches, "gather-view run", tag="7g")
    check_equal_tokens(f32, "7g", "gather-view decode", fused_decode=False)
    return {"tpot_p50_ms": st["tpot_p50_s"] * 1e3,
            "tok_per_s": st["tok_per_s"], "equal_share": share,
            "k4": launches["K4"]}


def phase_spec(bf16, f32, card):
    """Speculative decoding: tinyllama-1.1b bf16 serves phase 7's 8
    requests with γ = 4 and two drafts, the target itself and the target
    cut to its first LAYERS - 2 layers (sharing embed and head), which
    agrees with it in part, so that chains are rejected in their middle.
    Every decode step is a round: the draft's γ + 1 contiguous decode steps
    (K4 split through the identity table) and the target's verify (an
    extend: no paged decode).  Then the f32 equality check with the target
    itself and with its first 3 of 4 layers as drafts, the latter with
    mid-chain rejections."""
    import torch
    cfg, layout, params, engine, _ = bf16
    gamma, out = 4, {}
    for label, n in (("self", None), (f"{LAYERS - 2}-layer", LAYERS - 2)):
        eng = engine(draft=draft_for(cfg, layout, params, n, gamma))
        rounds = spec_rounds(eng)
        reqs = serve_requests(8)
        reset_launches()
        st = eng.run(reqs)
        torch.cuda.synchronize()
        launches = read_launches()
        steps = st["decode_steps"]
        want_k4 = steps * (gamma + 1) * (n or LAYERS)
        # the draft's γ + 1 contiguous decode steps a round; the rest of
        # the run's K4 launches would be the target's paged decode
        by_path = {"spec_draft": want_k4,
                   "target_paged_decode": launches["K4"] - want_k4}
        by_outcome = chains(rounds, gamma)
        print(f"[7s] speculative, draft {label} on {card}: accepted mean "
              f"{st['accepted_mean']:.2f} of {gamma} over {st['spec_steps']}"
              f" verifies in {steps} rounds, chains by outcome {by_outcome}; "
              f"{st['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{st['ttft_p50_s'] * 1e3:.1f} ms, TPOT p50 "
              f"{st['tpot_p50_s'] * 1e3:.2f} ms; K4 launches by path "
              f"{by_path} (expected {want_k4} from the draft); all "
              f"launches {launches}")
        check(st["tokens"] == 8 * 32 and st["completed"] == 8
              and st["nonfinite_rows"] == 0,
              f"speculative {label}: {st['tokens']} tokens, "
              f"{st['nonfinite_rows']} non-finite rows")
        check(by_path["target_paged_decode"] == 0,
              f"speculative {label}: K4 launches {launches['K4']} != "
              f"{want_k4} (the draft's)")
        check_k1_routes(launches, "7s", f"speculative run ({label})")
        check_k4_routes(launches, f"speculative run ({label})", tag="7s")
        out[label] = {"accepted_mean": st["accepted_mean"],
                      "chains": by_outcome, "tok_per_s": st["tok_per_s"],
                      "k4_by_path": by_path}
    # the clamp to max_new caps the last round of each request, and bf16
    # decode and extend may round an argmax apart, so not every draft of
    # the target's own is accepted
    check(out["self"]["accepted_mean"] >= 1.0,
          f"the target as its own draft accepted only "
          f"{out['self']['accepted_mean']:.2f} of {gamma}")
    cut = out[f"{LAYERS - 2}-layer"]["chains"]
    check(cut["rejected mid-chain"] > 0, f"the {LAYERS - 2}-layer draft: "
          f"no chain was rejected in its middle: {cut}")
    check_equal_tokens(f32, "7s", "speculative, draft self",
                       draft_layers=None)
    check_equal_tokens(f32, "7s", "speculative, 3-layer draft",
                       draft_layers=3, mid_chain=True)
    return out


def phase_train(card, arch="tinyllama-1.1b", steps=TRAIN_STEPS,
                per_step=TRAIN_LAUNCHES, tag="8", layers=0, batch=TRAIN_B,
                cut=(), k2_route="tc", seq=TRAIN_S):
    """``repro_torch.launch.train`` at full width in bf16 (full depth, or
    cut to ``layers`` and by the launcher flags ``cut``), batch ``batch``
    x ``seq``, remat, AdamW, synthetic tokens from seed 0; the launch
    counters reset just before and read just after.  Returns the launches,
    the K1 and K2 routes and the telemetry summary."""
    import torch
    from repro_torch.launch import train
    tel_path = ROOT / "build" / f"chip_smoke_train_{arch}_telemetry.json"
    tel_path.parent.mkdir(parents=True, exist_ok=True)
    reset_launches()
    out = train.main(["--arch", arch, "--device", "cuda",
                      "--steps", str(steps), "--batch", str(batch),
                      "--seq", str(seq), "--lr", "3e-4", "--warmup", "20",
                      "--log-every", "1", "--telemetry", str(tel_path)]
                     + (["--layers", str(layers)] if layers else [])
                     + list(cut))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: steps * n for k, n in per_step.items()}
    want["K4"] = want["K4 combine"] = 0
    tel = out["telemetry"]
    print(f"[{tag}] launches in the {arch} training run: {launches} over "
          f"{steps} steps (expected {want})")
    losses = tel["series"]["loss"]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"{arch} training run: losses {losses}")
    check(tel["nonfinite"] is None, f"{arch} training run: {tel['nonfinite']}")
    check(launches == want, f"{arch} training run launches {launches} != "
          f"{want}")
    split = read_split_launches()
    check(not any(split.values()), f"{arch} training run on one card: K3's "
          f"two phases launched {split}")
    routes = check_k1_routes(launches, tag, f"{arch} training run")
    check(routes["tc"] == launches["K1"],
          f"{arch} training run: K1 routes {routes}")
    k2_routes = check_k2_routes(launches, tag, f"{arch} training run",
                                k2_route)
    mfu = (f"MFU {tel['mfu'] * 100:.3f}% of {tel['peak_flops']:.3g} FLOP/s"
           if tel["mfu"] is not None else "MFU not reported")
    print(f"[{tag}] training {arch}"
          f"{f' cut to {layers} layers' if layers else ''}"
          f"{' ' + ' '.join(cut) if cut else ''} bf16, batch "
          f"{batch} x {seq}, remat, "
          f"{'Adafactor' if 'adafactor' in cut else 'AdamW'} on {card}: "
          "losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step times " + " ".join(f"{x:.3f}" for x in
                                        tel["series"]["t_step"])
          + f" s (first = warm-up); steady {tel['t_step_s']:.3f} s/step, "
          f"{tel['tokens_per_s']:.0f} tok/s, {mfu}; peak memory "
          f"{tel['mem_peak_bytes'] / 2 ** 30:.2f} GiB")
    return launches, routes, k2_routes, tel


def kernel_group(name: str) -> str:
    """The part of a training step a device kernel belongs to."""
    low = name.lower()
    # K5's backward runs the forward's first two passes again (with true);
    # its ssd_cb is the forward's kernel and is counted with it
    if re.search(r"ssd_(state|pass)<[^>]*true>", name) or \
            "ssd_bwd" in name or "group_sum" in name:
        return "K5 backward"
    if "ssd_" in name:
        return "K5 forward (and its recompute)"
    # every K1 kernel's name starts with k1_ (matmul_kernel is the simt
    # route's kernel); matched before the library's gemm names
    if re.search(r"(^|[^A-Za-z0-9_])k1_", name) or "matmul_kernel" in name:
        return "K1 matmul (forward linears and their recompute)"
    if "k4_" in name or "paged_decode" in name:
        return "K4 decode attention"
    # the tc route's kernels (k2_tc_*) and the simt route's (fa_*)
    if "k2_tc_fwd" in name or "fa_fwd" in name:
        return "K2 forward (and its recompute)"
    if "k2_tc_bwd" in name or "fa_bwd" in name:
        return "K2 backward"
    if "rms_" in name:
        return "K3 forward and backward"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "torch.matmul (dx, dw)"
    return "other (elementwise, reductions, AdamW, copies)"


def phase_breakdown(dev, card, arch="tinyllama-1.1b", tag="9",
                    seq=TRAIN_S, layers=0, op_group=None, rows=TRAIN_B,
                    change=None, host_steps=0):
    """Where the time of one training step goes: torch.profiler over the
    second step of the phase 8 (or 13, 17, 21) configuration, at ``seq``
    tokens a row (cut to ``layers``), device time summed by kernel group
    (``kernel_group``, then moved by ``op_group`` where it names the
    launching op's part) against the step's wall time (host clock,
    synchronised), ``rows`` a batch, the config changed by ``change``.  A
    profiler that sees no device kernel leaves the breakdown unmeasured;
    it does not fail the run.  With ``host_steps``, that many more steps
    run without the profiler, each timed by the wall clock and by the
    process's CPU time (every thread's: the autograd engine runs the
    backward on a thread of its own), so that a host-bound step's time is
    split into the host's work and its waits."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if change:
        cfg = change(cfg)
    layout = ParallelPlan().validate(mode="train").build()
    abstract = transformer.abstract_params(cfg)
    params = init_params(abstract, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    state = adamw_init(params, layout, abstract)
    step = make_train_step(cfg, layout, OptimConfig(
        lr=3e-4, warmup=20, total_steps=TRAIN_STEPS))
    data = TokenStream(cfg, ShapeConfig("smoke", seq, rows, "train"),
                       DataConfig(seed=0), dev)
    sync = (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else lambda: None)
    params, state, _ = step(params, state, next(data))     # warm-up
    batch = next(data)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(met["loss"].item()), "breakdown step: loss")
    cut = f" cut to {layers} layers" if layers else ""
    out = report_breakdown(prof, wall_ms, tag, f"one {arch}{cut} training "
                           f"step (batch {rows} x {seq})", card, op_group)
    del prof
    if host_steps:
        wall, cpu = [], []
        for _ in range(host_steps):
            batch = next(data)
            sync()
            t0, c0 = time.perf_counter(), time.process_time()
            params, state, met = step(params, state, batch)
            sync()
            wall.append(time.perf_counter() - t0)
            cpu.append(time.process_time() - c0)
        n = sum(n for n, _ in out["groups"].values()) if out else None
        print(f"[{tag}] {host_steps} steps without the profiler on {card}: "
              "wall " + " ".join(f"{x:.3f}" for x in wall) + " s, the "
              "process's CPU time " + " ".join(f"{x:.3f}" for x in cpu)
              + " s (CPU / wall " + " ".join(f"{c / w:.2f}" for c, w in
                                            zip(cpu, wall)) + ")"
              + (f"; {n} kernels a step: {min(wall) / n * 1e6:.1f}-"
                 f"{max(wall) / n * 1e6:.1f} us of wall and "
                 f"{min(cpu) / n * 1e6:.1f}-{max(cpu) / n * 1e6:.1f} us of "
                 "CPU a kernel" if n else ""))
        if out:
            out["host"] = {"wall_s": wall, "cpu_s": cpu, "kernels": n}
    return out


# record_function ranges of the port, which torch.profiler also lists on
# the device's timeline: not kernels
RANGES = ("optimizer",)


def union_ms(spans):
    """The length of the union of (start, end) intervals in us, in ms."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


NCCL_KINDS = ("AllGather", "ReduceScatter", "AllReduce", "SendRecv")


def step_split(prof, span="train_step"):
    """Where the last ``span`` of a profiled launcher run went on the card
    (the launcher's tracer range under ``--trace``; its telemetry syncs
    the card before the span ends, so each kernel of the step starts
    inside it): device time by kernel group (``kernel_group``; NCCL's
    kernels by collective, whose time includes the wait for the other
    ranks), the span's wall, the union of the other kernels (busy), the
    collectives' time outside that union (exposed) and the largest
    kernels of "other"."""
    from torch.autograd import DeviceType
    events = prof.events()
    last = [e for e in events if e.name == span
            and e.device_type == DeviceType.CPU][-1]
    a, b = last.time_range.start, last.time_range.end
    groups = collections.defaultdict(lambda: [0, 0.0])
    others, comp, coll = collections.Counter(), [], []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation \
                or e.name in (*RANGES, span, "data_next") \
                or not a <= e.time_range.start < b:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        nccl = "nccl" in e.name.lower()
        g = ("NCCL " + next((k for k in NCCL_KINDS if k in e.name), "other")
             if nccl else kernel_group(e.name))
        groups[g][0] += 1
        groups[g][1] += ms
        (coll if nccl else comp).append((e.time_range.start,
                                         e.time_range.end))
        if g.startswith("other"):
            others[e.name[:90]] += ms
    busy = union_ms(comp)
    return {"wall_ms": (b - a) / 1e3, "busy_ms": busy,
            "exposed_comm_ms": union_ms(comp + coll) - busy,
            "groups": {g: {"kernels": n, "ms": ms}
                       for g, (n, ms) in sorted(groups.items(),
                                                key=lambda kv: -kv[1][1])},
            "other_top": dict(others.most_common(6))}


def report_breakdown(prof, wall_ms, tag, what, card, op_group=None):
    """Device time of a profiled window by kernel group (``kernel_group``
    of the kernel's name; with ``op_group``, the kernels of each CPU op it
    names move to that op's group), the union of the kernels' intervals
    (device busy) and the idle share against the window's wall time.  A
    profiler that saw no device kernel leaves it unmeasured (None)."""
    from torch.autograd import DeviceType
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in RANGES]
    if not kernels:
        print(f"[{tag}] torch.profiler saw no device kernels on {card}: "
              f"{what}'s breakdown is not measured")
        return None
    # the ops' groups for their kernels, by (name, duration); torch.profiler
    # may list one kernel under more than one CPU op, so each (name,
    # duration) takes at most as many op groups as it ran, and each of the
    # device's kernels below lands in exactly one group
    left = collections.Counter(
        (e.name, e.time_range.elapsed_us()) for e in kernels)
    to = collections.defaultdict(list)
    for op in events if op_group else ():
        kerns = getattr(op, "kernels", None) if \
            op.device_type == DeviceType.CPU else None
        g = op_group(op) if kerns else None
        for kn in kerns if g else ():
            key = (kn.name, kn.duration)
            if left[key] and not kernel_group(kn.name).startswith("K"):
                left[key] -= 1
                to[key].append(g)
    groups, spans, names, moved = {}, [], {}, 0
    for e in kernels:
        us = e.time_range.elapsed_us()
        g = to[(e.name, us)].pop() if to.get((e.name, us)) else None
        moved += g is not None
        g = g or kernel_group(e.name)
        n, ms = groups.get(g, (0, 0.0))
        groups[g] = (n + 1, ms + us / 1e3)
        spans.append((e.time_range.start, e.time_range.end))
        if g.startswith("other"):
            names[e.name] = names.get(e.name, 0.0) + us / 1e3
    if op_group:
        print(f"[{tag}] {moved} kernels regrouped by the op that launched "
              "them")
    busy_ms = union_ms(spans)
    print(f"[{tag}] {what} under torch.profiler on {card}: wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {g}: {ms:.1f} ms in {n} kernels "
              f"({ms / wall_ms * 100:.1f}% of the step)")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:4]:
        print(f"    largest in other: {name[:90]}: {ms:.1f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": groups}


def phase_decode_breakdown_zamba2(eng, card):
    """Where the time of one zamba2-1.2b decode step goes, on phase 7z's
    engine's weights (8 slots, bf16, weights from seed 0) and a fresh
    cache 40 tokens in: torch.profiler's device time by kernel group
    against the step's synchronised wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.params import init_params
    from repro_torch.models import transformer
    from repro_torch.serve.kvcache import cache_with_dtype
    cfg, layout, params, dev = eng.cfg, eng.layout, eng.params, eng.device
    cache = init_params(cache_with_dtype(
        transformer.abstract_cache(cfg, layout, 8, 512), torch.bfloat16),
        None, dev)
    tok = torch.full((8, 1), 7, dtype=torch.long, device=dev)

    def step(t):
        pos = torch.full((8,), t, dtype=torch.int32, device=dev)
        return transformer.forward(cfg, layout, params,
                                   {"token": tok, "pos": pos},
                                   mode="decode", cache=cache)[0]
    for t in range(40):
        step(t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits = step(40)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(torch.isfinite(logits).all().item(), "zamba2 decode step: logits")
    return report_breakdown(prof, wall_ms, "7z", "one zamba2-1.2b decode "
                            "step (8 slots)", card)


def xlstm_two_layer_cfg():
    """Full-width xlstm-350m cut to the plan [mlstm, slstm], f32."""
    from repro_torch.configs.registry import get
    base = get("xlstm-350m")
    return dataclasses.replace(base, n_layers=2, dtype="float32",
                               ssm=dataclasses.replace(base.ssm,
                                                       slstm_every=2))


def phase_two_layer_xlstm(dev):
    """One training step's loss and gradients of full-width xlstm cut to
    [mlstm, slstm], f32, batch 1 x 512 (two mLSTM chunks of 256, 512
    sLSTM steps), remat on: CPU (plain versions) against the card
    (kernels), the same seeded weights and tokens; K1 and K3 launch on
    the card only, as many times as the plan says."""
    import numpy as np
    import torch
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.models import transformer
    cfg = xlstm_two_layer_cfg()
    layout = ParallelPlan().validate(mode="train").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(3), "cpu", torch.float32)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 513)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, -9:] = -1
    res = {}
    for d in ("cpu", dev):
        before = (k1.launches, k3.launches, k3.launches_bwd)
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, _ = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[str(d)] = (loss.item(), [g.cpu() for g in grads], tuple(
            a - b for a, b in zip((k1.launches, k3.launches,
                                   k3.launches_bwd), before)))
    (l_cpu, g_cpu, n_cpu), (l_dev, g_dev, n_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    errs = {n: (leaf_err(a, b), b.abs().max().item())
            for n, a, b in zip(names, g_dev, g_cpu)}
    worst = max(e for e, _ in errs.values())
    tol = 1e-4
    # K1: 8 linears twice (forward, recompute) and the head's one chunk
    # twice; K3: 3 norms twice and ln_f, backward once each
    want = (2 * 8 + 2, 2 * 3 + 1, 3 + 1)
    print(f"[16] xlstm [mlstm, slstm] full width f32 train step (1x512): "
          f"loss cpu {l_cpu:.6f} card {l_dev:.6f}; gradient max |card - "
          f"cpu| / max |cpu| per leaf, worst first (max |cpu| in "
          f"brackets): " + ", ".join(
              f"{k} {e:.1e} [{g:.1e}]" for k, (e, g) in sorted(
                  errs.items(), key=lambda kv: -kv[1][0])[:8])
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"(K1, K3, K3 backward) launches cpu {n_cpu}, card {n_dev}")
    check(n_cpu == (0, 0, 0) and n_dev == want, f"two-layer xlstm: "
          f"launches cpu {n_cpu}, card {n_dev} (expected {want})")
    check(abs(l_cpu - l_dev) <= tol * (1 + abs(l_cpu))
          and math.isfinite(l_dev),
          f"two-layer xlstm train loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer xlstm train gradients: {worst}")


def phase_two_layer_xlstm_serve(dev):
    """Phase 16's model (the same seeded weights) through the decode path
    from a fresh cache: a 16-token sequential prefill and 8 greedy decode
    steps of 2 slots, CPU (plain versions) against the card (kernels):
    logits within 1e-4 of 1 + max at every step, the same greedy tokens,
    K1 and K3 launched on the card only."""
    import numpy as np
    import torch
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.models import transformer
    from repro_torch.serve.kvcache import cache_with_dtype
    cfg = xlstm_two_layer_cfg()
    layout = ParallelPlan().validate(mode="serve").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(3), "cpu", torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)))
    tree = cache_with_dtype(transformer.abstract_cache(cfg, layout, 2, 64),
                            torch.float32)
    res = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), cpu)
        cache = init_params(tree, None, d)
        before = (k1.launches, k3.launches)
        logits, toks = [], []
        tok = prompt[:, :1]
        for t in range(16 + 8):
            lg, cache = transformer.forward(
                cfg, layout, params, {"token": tok.to(d),
                                      "pos": torch.full((2,), t,
                                                        dtype=torch.int32,
                                                        device=d)},
                mode="decode", cache=cache)
            lg = lg.float().cpu()
            logits.append(lg)
            nxt = lg.argmax(-1)[:, None]
            toks.append(nxt)
            tok = prompt[:, t + 1:t + 2] if t + 1 < 16 else nxt
        res[str(d)] = (torch.stack(logits), torch.cat(toks, 1), (
            k1.launches - before[0], k3.launches - before[1]))
    (l_cpu, t_cpu, n_cpu), (l_dev, t_dev, n_dev) = res["cpu"], res[str(dev)]
    err = ((l_dev - l_cpu).abs().amax(dim=(1, 2))
           / (1 + l_cpu.abs().amax(dim=(1, 2))))
    want = (24 * (8 + 1), 24 * (3 + 1))
    print(f"[16s] xlstm [mlstm, slstm] full width f32 decode path (2 slots, "
          f"16 prompt tokens one a step, 8 greedy steps): logits max |card "
          f"- cpu| / (1 + max |cpu|) per step, worst {err.max().item():.1e} "
          f"(tol 1e-4); greedy tokens equal "
          f"{torch.equal(t_cpu[:, 15:], t_dev[:, 15:])}; (K1, K3) launches "
          f"cpu {n_cpu}, card {n_dev}")
    check(n_cpu == (0, 0) and n_dev == want, f"xlstm decode path: launches "
          f"cpu {n_cpu}, card {n_dev} (expected {want})")
    check(err.max().item() <= 1e-4 and torch.isfinite(l_dev).all(),
          f"xlstm decode path logits: {err.tolist()}")
    check(torch.equal(t_cpu[:, 15:], t_dev[:, 15:]),
          f"xlstm decode path greedy tokens differ: {t_cpu} vs {t_dev}")


def xlstm_step_bytes(prompts, max_new):
    """(bytes per step on average, steps, parts) of 7x's decode steps,
    each input read once and each output written once: the weights (of
    the embedding only the slots' rows) and, for each slot still running,
    its f32 recurrent state read and written: the mLSTM's C (4 x 512 x
    512), n and m in each of 21 layers, the sLSTM's c, n, h, m in each of
    3.  A slot of prompt p runs p + max_new - 1 steps."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    params = transformer.abstract_params(get("xlstm-350m"))
    weights = param_bytes(params) - param_bytes({"e": params["embed"]})
    dm, ds = X_DIN // X_NH, X_D // X_NH
    mstate = X_MLSTM * X_NH * (dm * dm + dm + 1) * 4
    sstate = X_SLSTM * 4 * X_NH * ds * 4
    runs = [p + max_new - 1 for p in prompts]
    steps, slot_steps = max(runs), sum(runs)
    parts = {"weights": steps * weights, "embed rows": slot_steps * X_D * 2,
             "mLSTM state": slot_steps * 2 * mstate,
             "sLSTM state": slot_steps * 2 * sstate}
    return sum(parts.values()) / steps, steps, {
        k: v / steps for k, v in parts.items()}


def phase_xlstm_blocks(dev, card, step_s):
    """How much of an xlstm-350m training step each block kind takes: one
    mLSTM and one sLSTM block at the training shape (bf16, 4 x 2048, seed
    weights) on the host clock between synchronisations: the forward
    alone, the forward with its backward, and the two as a remat step runs
    them (``torch.utils.checkpoint``: a forward whose saved tensors are
    dropped, then in the backward the forward again and the backward).
    21 mLSTM and 3 sLSTM blocks' remat times against phase 17's steady
    step give each kind's share."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer, xlstm
    cfg = get("xlstm-350m")
    layout = ParallelPlan().validate(mode="train").build()
    dirs = transformer.entry_dirs()
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(TRAIN_B, TRAIN_S, X_D, generator=gen, device=dev) \
        .to(torch.bfloat16).requires_grad_()
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)
    per = {}
    for kind, n in (("mlstm", X_MLSTM), ("slstm", X_SLSTM)):
        p = init_params(getattr(xlstm, f"{kind}_params")(cfg), gen, dev,
                        torch.bfloat16)
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_()
        apply = getattr(xlstm, f"{kind}_apply")

        def block(xx, *ws):
            return apply(layout, cfg, dirs, xx,
                         dict(zip(p, ws)) if ws else p)[0]

        def fwd():
            with torch.no_grad():
                block(x)

        def fwd_bwd():
            torch.autograd.grad(block(x), [x] + leaves, dy)

        def remat():
            y = checkpoint(block, x, *leaves, use_reentrant=False)
            torch.autograd.grad(y, [x] + leaves, dy)
        t = {}
        for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd),
                         ("remat", remat)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
        per[kind] = (n, t)
    print(f"[18] xlstm-350m blocks at {TRAIN_B} x {TRAIN_S} bf16 on {card}, "
          "host clock: " + "; ".join(
              f"{k} forward {t['fwd'] * 1e3:.1f} ms, forward + backward "
              f"{t['fwd_bwd'] * 1e3:.1f} ms, under remat "
              f"{t['remat'] * 1e3:.1f} ms, x {n} blocks "
              f"{n * t['remat']:.3f} s ({n * t['remat'] / step_s * 100:.1f}% "
              f"of the {step_s:.3f} s step)" for k, (n, t) in per.items()))
    return {k: {**{f"{name}_ms": v * 1e3 for name, v in t.items()},
                "share_of_step": n * t["remat"] / step_s}
            for k, (n, t) in per.items()}


def phase_ckpt_roundtrip(card):
    """The checkpoint store on the card at full width and depth
    (xlstm-350m, bf16, batch 2 x 256): the train launcher trains 2 steps
    and saves step 2; run again to 4 steps it restores step 2 (every
    parameter, moment and the step bit for bit what was saved), trains on
    and saves step 4; the serve launcher restores step 4 (bit for bit) and
    serves 8 requests.  The directory is removed afterwards."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core.params import tree_leaves
    from repro_torch.launch import serve, train
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    saved, restored = {}, {}
    save, restore = store.save, store.restore

    def copies(params, opt_state):
        """The leaves' values now: AdamW updates them in place later."""
        return ([t.clone() for t in tree_leaves(params)], opt_state and (
            opt_state.step, [t.clone() for t in tree_leaves(opt_state.m)
                             + tree_leaves(opt_state.v)]))

    def keep_save(ckpt_dir, step, params, opt_state, **kw):
        saved[step] = copies(params, opt_state)
        return save(ckpt_dir, step, params, opt_state, **kw)

    def keep_restore(ckpt_dir, step, *args, **kw):
        out = restore(ckpt_dir, step, *args, **kw)
        restored[step] = copies(out[0], out[1])
        return out

    def run(fn, argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        print("\n".join("    | " + line
                        for line in buf.getvalue().splitlines()))
        return out, buf.getvalue(), sec

    def same(got, want):
        return len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want))
    argv = ["--arch", "xlstm-350m", "--device", "cuda", "--batch",
            str(X_CKPT_B), "--seq", str(X_CKPT_S), "--log-every", "1",
            "--ckpt-dir", str(ck), "--ckpt-every", "2"]
    store.save, store.restore = keep_save, keep_restore
    try:
        out1, text1, s1 = run(train.main, argv + ["--steps", "2"])
        out2, text2, s2 = run(train.main, argv + ["--steps", "4"])
        stats, text3, s3 = run(serve.main, [
            "--arch", "xlstm-350m", "--device", "cuda", "--requests", "8",
            "--batch-size", "8", "--max-new", "8", "--ckpt-dir", str(ck)])
    finally:
        store.save, store.restore = save, restore
    size = sum(f.stat().st_size for f in ck.rglob("*.npy"))
    shutil.rmtree(ck, ignore_errors=True)
    check(out1["start"] == 0 and sorted(saved) == [2, 4],
          f"checkpoint round trip: saved steps {sorted(saved)}")
    check(f"saved {ck / 'step_00000002'}" in text1,
          "checkpoint round trip: the first run printed no saved line")
    check(f"restoring step 2 from {ck}" in text2 and out2["start"] == 2
          and len(out2["losses"]) == 2 and all(
              map(math.isfinite, out1["losses"] + out2["losses"])),
          f"checkpoint round trip: resume {out2['start']}, losses "
          f"{out1['losses']} {out2['losses']}")
    params2, (step2, moments2) = restored[2]
    check(same(params2, saved[2][0]),
          "checkpoint round trip: restored parameters differ from saved")
    check(step2 == saved[2][1][0] == 2 and same(moments2, saved[2][1][1]),
          "checkpoint round trip: restored AdamW state differs from saved")
    check("restored checkpoint step 4" in text3
          and same(restored[4][0], saved[4][0]),
          "checkpoint round trip: the server's parameters differ from step 4")
    check(stats["tokens"] == 64 and stats["nonfinite_rows"] == 0,
          f"checkpoint round trip: served {stats['tokens']} tokens, "
          f"{stats['nonfinite_rows']} non-finite rows")
    n = len(saved[2][0])
    print(f"[19] checkpoint round trip, xlstm-350m bf16 at full width and "
          f"depth on {card}: train 2 steps and save {s1:.1f} s, restore "
          f"step 2 + 2 steps + save {s2:.1f} s, restore step 4 and serve 8 "
          f"x 8 tokens {s3:.1f} s; {n} parameters, {2 * n} moments and the "
          f"step restored bit for bit; {size / 2 ** 30:.2f} GiB on disk for "
          "two steps")
    return {"train_save_s": s1, "resume_s": s2, "serve_restore_s": s3}


def moon_two_layer_cfg():
    """Full-width moonshot-v1-16b-a3b cut to the plan [dense, moe], f32:
    the dense first layer (MLP 11264), then 64 experts top-6 with the 2
    shared ones and the 163840-word head."""
    from repro_torch.configs.registry import get
    return dataclasses.replace(get("moonshot-v1-16b-a3b"), n_layers=2,
                               dtype="float32")


def routed_and_dropped(fn):
    """Run ``fn`` with ``models/moe.py``'s drop counter on: (its result,
    [(routed, dropped)] one pair per MoE call, in call order)."""
    import torch
    from repro_torch.models import moe
    moe.DROPS = []
    try:
        out = fn()
        pairs = [tuple(int(v) for v in t) for t in
                 (torch.stack(moe.DROPS).cpu() if moe.DROPS else [])]
    finally:
        moe.DROPS = None
    return out, pairs


def phase_two_layer_moe(dev):
    """One training step of Moonlight cut to [dense, moe] at full width,
    f32, batch 1 x 256, remat on: the capacity is ceil(256 * 6 * 1.25 /
    64) = 30 a expert, so some choices drop.  CPU (plain versions) against
    the card (kernels), the same seeded weights and tokens: the loss, aux
    and every gradient leaf within 1e-4 (of 1 + |loss|, of each leaf's
    max), the same choices dropped, and K1, K2 and K3 launched on the card
    only, as many times as the plan says."""
    import numpy as np
    import torch
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    cfg = moon_two_layer_cfg()
    layout = ParallelPlan().validate(mode="train").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(20), "cpu",
                      torch.float32)
    rng = np.random.default_rng(20)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 257)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, -9:] = -1
    res = {}
    for d in ("cpu", dev):
        reset_launches()
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        (loss, met), drops = routed_and_dropped(lambda: transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train"))
        grads = torch.autograd.grad(loss, tree_leaves(live))
        launches = read_launches()
        res[str(d)] = (loss.item(), met["aux"].item(),
                       [g.cpu() for g in grads], drops, launches)
        del live, grads
    (l_cpu, a_cpu, g_cpu, d_cpu, n_cpu), (l_dev, a_dev, g_dev, d_dev, n_dev) \
        = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    errs = {n: (leaf_err(a, b), b.abs().max().item())
            for n, a, b in zip(names, g_dev, g_cpu)}
    worst = max(e for e, _ in errs.values())
    tol = 1e-4
    # K1: 7 linears a layer (q, k, v, o and the dense MLP's or the shared
    # experts' 3) twice (forward, recompute) and the head's 4 chunks
    # twice; K2 twice forward, once backward; K3 4 norms twice and ln_f,
    # backward once each
    want = {"K1": 2 * 14 + 2 * 4, "K2": 4, "K2 bwd": 2, "K3": 9,
            "K3 bwd": 5, "K4": 0, "K4 combine": 0, "K5": 0, "K5 bwd": 0}
    print(f"[20] Moonlight [dense, moe] full width f32 train step (1x256, "
          f"capacity 30): loss cpu {l_cpu:.6f} card {l_dev:.6f}, aux cpu "
          f"{a_cpu:.6e} card {a_dev:.6e}; (routed, dropped) choices per MoE "
          f"call cpu {d_cpu} card {d_dev}; gradient max |card - cpu| / max "
          f"|cpu| per leaf, worst first (max |cpu| in brackets): "
          + ", ".join(f"{k} {e:.1e} [{g:.1e}]" for k, (e, g) in sorted(
              errs.items(), key=lambda kv: -kv[1][0])[:8])
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"launches on the card {n_dev}")
    check(all(v == 0 for v in n_cpu.values()),
          f"Moonlight two-layer: kernels launched for CPU tensors {n_cpu}")
    check(n_dev == want, f"Moonlight two-layer launches {n_dev} != {want}")
    check(d_cpu == d_dev and d_dev and d_dev[0][1] > 0,
          f"Moonlight two-layer drops: cpu {d_cpu}, card {d_dev}")
    check(abs(l_cpu - l_dev) <= tol * (1 + abs(l_cpu))
          and math.isfinite(l_dev),
          f"Moonlight two-layer train loss: {l_cpu} vs {l_dev}")
    check(abs(a_cpu - a_dev) <= tol * (1 + abs(a_cpu)) and a_dev > 0,
          f"Moonlight two-layer aux: {a_cpu} vs {a_dev}")
    check(worst <= tol, f"Moonlight two-layer train gradients: {worst}")


def phase_two_layer_moe_serve(dev):
    """Phase 20's model (the same seeded weights) through the engine's
    paged path: 2 requests of 16 prompt tokens in 2 slots, one chunked
    prefill and 8 greedy fused decode steps (max_len 64, block 16), CPU
    (plain versions) against the card (kernels): the logits of every step
    within 1e-4 of 1 + max, the same tokens, and on the card K1, K2, K3
    and K4 launched as the plan says."""
    import numpy as np
    import torch
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    from repro_torch.serve import Engine, Request
    cfg = moon_two_layer_cfg()
    layout = ParallelPlan().validate(mode="serve").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(20), "cpu",
                      torch.float32)
    prompts = np.random.default_rng(21).integers(0, cfg.vocab, (2, 16))
    res = {}
    for d in ("cpu", dev):
        eng = Engine(cfg, layout, tree_map(lambda t: t.to(d), cpu),
                     batch_size=2, max_len=64, block_size=16)
        logs, sample = [], eng._sample

        def recording(logits, sample=sample, logs=logs):
            logs.append(logits.detach().float().cpu())
            return sample(logits)
        eng._sample = recording
        reqs = [Request(uid=i, prompt=[int(t) for t in p], max_new=9)
                for i, p in enumerate(prompts)]
        reset_launches()
        stats = eng.run(reqs)
        res[str(d)] = (torch.stack(logs), [r.out for r in reqs],
                       read_launches(), stats)
        del eng
    (l_cpu, t_cpu, n_cpu, s_cpu), (l_dev, t_dev, n_dev, s_dev) = \
        res["cpu"], res[str(dev)]
    err = ((l_dev - l_cpu).abs().amax(dim=(1, 2))
           / (1 + l_cpu.abs().amax(dim=(1, 2))))
    steps = s_dev["prefill_steps"] + s_dev["decode_steps"]
    # per step K1: 14 linears and the head, K3: 4 norms and ln_f; K2 per
    # prefill layer, K4 per decode layer (f32: simt, no combine pass)
    want = {"K1": 15 * steps, "K2": 2 * s_dev["prefill_steps"], "K2 bwd": 0,
            "K3": 5 * steps, "K3 bwd": 0, "K4": 2 * s_dev["decode_steps"],
            "K4 combine": 0, "K5": 0, "K5 bwd": 0}
    print(f"[20s] Moonlight [dense, moe] full width f32 through the paged "
          f"engine (2 slots, 16 prompt tokens, 1 prefill + "
          f"{s_dev['decode_steps']} decode steps): logits max |card - cpu| "
          f"/ (1 + max |cpu|) per step, worst {err.max().item():.1e} (tol "
          f"1e-4); greedy tokens equal {t_cpu == t_dev}; launches on the "
          f"card {n_dev} (expected {want})")
    check(all(v == 0 for v in n_cpu.values()),
          f"Moonlight decode path: kernels launched on the CPU {n_cpu}")
    check(s_dev["prefill_steps"] == 1 and s_dev["decode_steps"] == 8
          and n_dev == want, f"Moonlight decode path launches {n_dev} "
          f"over {s_dev} != {want}")
    check(err.max().item() <= 1e-4 and torch.isfinite(l_dev).all(),
          f"Moonlight decode path logits: {err.tolist()}")
    check(t_cpu == t_dev, f"Moonlight decode path tokens: {t_cpu} vs "
          f"{t_dev}")


def mixtral_step_bytes(prompts, max_new, layers=MIX_SERVE_LAYERS, block=16,
                       L=512):
    """(bytes of one decode step on average, steps, parts) of 7m's decode
    steps, each input read once and each output written once: every
    weight of the cut model (every expert runs its capacity buffer every
    step, so all 8 are read; of the embedding only the slots' rows), and
    in each layer the kv entries K4 attends for each slot (as
    ``k4_bound`` counts them: q in and out, the valid K and V, the
    positions of the table's columns, the table and cur, and the step's
    own entry folded in and written).  After the one prefill step every
    slot decodes in lockstep: decode step j of a slot of prompt p attends
    p + j entries and its own."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get("mixtral-8x7b"), n_layers=layers)
    params = transformer.abstract_params(cfg)
    weights = param_bytes(params) - param_bytes({"e": params["embed"]})
    entry = MIX_NKV * MIX_DH * 2 * 2             # one position's K and V
    steps = max_new - 1
    kv = layers * sum(
        MIX_NQ * MIX_DH * 2 * 2 + (p + j) * entry + 2 * entry
        + (L // block) * (block + 1) * 4 + 4
        for p in prompts for j in range(steps))
    parts = {"weights": steps * weights,
             "embed rows": steps * len(prompts) * MIX_D * 2, "kv": kv}
    return sum(parts.values()) / steps, steps, {
        k: v / steps for k, v in parts.items()}


def phase_serve_mixtral(card):
    """``repro_torch.launch.serve`` serves mixtral-8x7b cut to 16 layers at
    full width in bf16, weights from a seed drawn on the card, with phase
    7's traffic: 8 requests in batch 8, a shared 256-token prefix and 3-7
    more, 32 new tokens each, max_len 512, block 16, greedy.  The launch
    counters reset just before and read just after: launches per step
    exact, no bf16 GEMM, prefill attention or decode attention on simt.
    Then the share of routed choices dropped at capacity per step (decode
    steps have 8 tokens: ceil(8 * 2 * 1.25 / 8) = 3 a expert), TTFT, TPOT
    and tok/s beside a decode step's bytes bound."""
    import torch
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats, drops = routed_and_dropped(lambda: serve.main([
        "--arch", "mixtral-8x7b", "--layers", str(MIX_SERVE_LAYERS),
        "--device", "cuda", "--requests", "8", "--batch-size", "8",
        "--shared-prefix", "256", "--max-new", "32", "--max-len", "512",
        "--block-size", "16"]))
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pre, dec = stats["prefill_steps"], stats["decode_steps"]
    L = MIX_SERVE_LAYERS
    want = {k: n * (pre + dec) for k, n in MIX_SERVE_STEP.items()}
    want.update({"K2": L * pre, "K4": L * dec, "K4 combine": L * dec})
    print(f"[7m] launches in the mixtral serving run: {launches} over {pre} "
          f"prefill + {dec} decode steps (expected {want})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"mixtral serving run: {stats['tokens']} tokens, "
          f"{stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"mixtral serving run: {stats['nonfinite_rows']} non-finite rows")
    check(launches == want, f"mixtral serving run launches {launches} != "
          f"{want}")
    routes = check_k1_routes(launches, "7m", "mixtral serving run")
    k2_routes = check_k2_routes(launches, "7m", "mixtral serving run")
    k4_routes = check_k4_routes(launches, "mixtral serving run", tag="7m")
    check(len(drops) == L * (pre + dec), f"mixtral serving run: "
          f"{len(drops)} MoE calls for {pre + dec} steps of {L} layers")
    share = [sum(dr for _, dr in drops[i * L:(i + 1) * L])
             / sum(r for r, _ in drops[i * L:(i + 1) * L])
             for i in range(pre + dec)]
    step_bytes, want_steps, parts = mixtral_step_bytes(
        [len(r.prompt) for r in serve_requests(8)], 32)
    check(pre == 1 and dec == want_steps, f"mixtral serving run: {pre} "
          f"prefill + {dec} decode steps, the bound counts 1 + {want_steps}")
    bound = step_bytes / H100_BYTES_PER_S * 1e3
    tpot = stats["tpot_p50_s"] * 1e3
    print(f"[7m] routed choices dropped at capacity: prefill "
          f"{share[0]:.4f}, decode steps mean "
          f"{sum(share[1:]) / max(1, dec):.4f}, max {max(share[1:]):.4f}, "
          f"per step " + " ".join(f"{x:.3f}" for x in share))
    print(f"[7m] serving mixtral-8x7b cut to {L} layers, bf16, 8 requests x "
          f"32 new tokens on {card}: TTFT p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 {tpot:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} "
          f"tok/s; a decode step's bound {bound:.3f} ms ("
          + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in parts.items())
          + f" a step, at 3.35 TB/s), TPOT / bound {tpot / bound:.2f}x; "
          f"peak memory {peak:.2f} GiB")
    return launches, routes, k2_routes, k4_routes, {
        "layers": L, "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "tpot_p50_ms": tpot, "tok_per_s": stats["tok_per_s"],
        "step_bound_ms": bound, "drop_share_prefill": share[0],
        "drop_share_decode_mean": sum(share[1:]) / max(1, dec),
        "drop_share_decode_max": max(share[1:]), "mem_peak_gib": peak}


# the ops whose kernels are library GEMMs (torch.matmul's group)
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
              "aten::linear")


def launching_op_group(op):
    """The optimizer's kernels (the train step's "optimizer" range) as
    AdamW, and every other kernel outside K1-K5 and the library's GEMMs
    under the op that launched it ("other: aten::..."): the "other" group
    split by launching op, which tells which ops make a step's kernels."""
    chain, o = [], op
    while o is not None:
        chain.append(o.name)
        o = o.cpu_parent
    if "optimizer" in chain:
        return "AdamW (the optimizer range)"
    if op.name in MATMUL_OPS:
        return None
    return f"other: {op.name}"


# ops whose kernels move tokens between the batch and the expert buffers:
# the router's sorts, the dispatch's and combine's index and scatter ops
# (and their backward's); the embedding's row gather is an index too
MOE_DISPATCH_OPS = ("sort", "searchsorted", "index", "scatter", "one_hot")


def moe_op_group(op):
    """The part of a MoE training step a CPU op belongs to, by the op and
    its callers (torch.profiler links each kernel to the op that launched
    it): the optimizer (the train step's "optimizer" range), the experts'
    batched products (``aten::bmm``), the dispatch and combine (sorts,
    index and scatter ops); None for the rest, which keeps its kernels'
    ``kernel_group``."""
    chain = []
    while op is not None:
        chain.append(op.name)
        op = op.cpu_parent
    if "optimizer" in chain:
        return "AdamW (the optimizer range)"
    if chain[0] == "aten::bmm":
        return "experts' torch.matmul (bmm)"
    if any(k in n for n in chain[:3] for k in MOE_DISPATCH_OPS):
        return "MoE dispatch and combine (sorts, index, scatter)"
    return None


# deepseek-v3-671b (configs/deepseek_v3_671b.py, arXiv:2412.19437): d_model
# 7168, 128 heads of MLA (q_lora 1536, kv_lora 512; q and k of 128 + 64
# rope dims, v of 128), 3 dense layers of 18432, then 256 routed experts
# (top 8) of 2048 and one shared, vocab 129280, the mtp head.  It serves
# cut to DS_SERVE_LAYERS (the 3 dense layers and one MoE layer of all 256
# experts: 15.8B parameters, 31.6 GB in bf16, phase 7d) and trains cut to
# [dense, moe] with DS_TRAIN_EXPERTS routed experts (4.06B parameters,
# phases 23 and 24)
DS_NH, DS_DK, DS_DV, DS_R, DS_DR = 128, 192, 128, 512, 64
DS_D, DS_QL, DS_DENSE_FF, DS_EXPERT_FF, DS_VOCAB = 7168, 1536, 18432, 2048, \
    129280
DS_SERVE_LAYERS, DS_STEPS, DS_TRAIN_B = 4, 3, 1
DS_TRAIN_LAYERS, DS_TRAIN_EXPERTS = 2, 16
DS_TRAIN_CUT = ("--dense-layers", "1", "--experts", str(DS_TRAIN_EXPERTS))
# launches per deepseek training step (phase 24, [dense, moe]), as
# TRAIN_LAUNCHES counts them: K1 the 8 linears of each layer (MLA's w_dq,
# w_uq, w_dkv, w_ukv and w_o, the dense MLP's or the shared expert's 3)
# twice (forward, recompute) and the head's 4 chunks twice, then the mtp
# head's proj and its block's 8 linears once and its head's 4 chunks
# twice; K2 each layer twice and the mtp block once forward, each once
# backward; K3 the 4 norms of each layer (ln1, ln2, q_ln, kv_ln) twice
# and once backward, ln_f, and the mtp head's 7 (ln_h, ln_e, its block's
# 4, ln_f again) once forward and once backward
DS_LAUNCHES = {"K1": 2 * 8 * 2 + 2 * 4 + 9 + 2 * 4, "K2": 2 * 2 + 1,
               "K2 bwd": 3, "K3": 2 * 4 * 2 + 1 + 7,
               "K3 bwd": 4 * 2 + 1 + 7, "K5": 0, "K5 bwd": 0}
# its K1 GEMMs (name, K, N): MLA's down projections (w_dkv's N = 576 ends
# inside the tc route's last column tile), its up projections and w_o, the
# dense MLP (the dense layers and the mtp block), the shared expert, the
# mtp head's proj and the head; the routed experts, the router and the
# absorbed decode's w_uk and w_uv are torch.matmul and einsums
DS_MLA_GEMMS = [("w_dq", DS_D, DS_QL), ("w_uq", DS_QL, DS_NH * DS_DK),
                ("w_dkv", DS_D, DS_R + DS_DR),
                ("w_ukv", DS_R, DS_NH * (DS_DK - DS_DR + DS_DV)),
                ("w_o", DS_NH * DS_DV, DS_D)]
DS_MLP_GEMMS = [("dense w_up,w_gate", DS_D, DS_DENSE_FF),
                ("dense w_down", DS_DENSE_FF, DS_D),
                ("shared w_up,w_gate", DS_D, DS_EXPERT_FF),
                ("shared w_down", DS_EXPERT_FF, DS_D)]
# the serving path's (phase 7d): a decode step (M = 8) runs every MLA GEMM
# but w_ukv (absorbed), the MLPs and the head; the prefill (8 x 512 =
# 4096 rows) the five MLA GEMMs and the MLPs, its head at the 8 last
# positions (M = 8)
DS_DECODE_GEMMS = [g for g in DS_MLA_GEMMS if g[0] != "w_ukv"] + \
    DS_MLP_GEMMS + [("head", DS_D, DS_VOCAB)]
DS_PREFILL_GEMMS = DS_MLA_GEMMS + DS_MLP_GEMMS
# the training path's (phase 24), launches a step as DS_LAUNCHES counts
# them: MLA's five GEMMs twice in each of the 2 layers and once in the mtp
# block, the dense MLP twice in the dense layer and once in the mtp block,
# the shared expert twice, the mtp proj once; the head (its 4 chunks of
# 512 rows twice, for the main loss and for mtp's) apart
DS_TRAIN_GEMMS = [(name, k, n, 2 * DS_TRAIN_LAYERS + 1)
                  for name, k, n in DS_MLA_GEMMS] + [
    ("dense w_up,w_gate", DS_D, DS_DENSE_FF, 2 * 2 + 2),
    ("dense w_down", DS_DENSE_FF, DS_D, 2 + 1),
    ("shared w_up,w_gate", DS_D, DS_EXPERT_FF, 2 * 2),
    ("shared w_down", DS_EXPERT_FF, DS_D, 2),
    ("mtp proj", 2 * DS_D, DS_D, 1)]
# K2 in f32 at MLA's pair (phase 5d): the limits on ||got - want|| /
# ||want|| against the plain version, 3-6x the readings on an H100 (out
# 3.1e-7, dq 8.0e-8, dk 9.6e-8; dv 0, the kernel's sum over q in the
# order cuBLAS takes); tools/k2_planted_faults.py --mla's faults read
# far above them
K2_F32_NORM_TOL = {"out": 1.5e-6, "dq": 5e-7, "dk": 5e-7, "dv": 5e-7}
# K4 on the latent decode (phase 3d): (label, contexts, table columns),
# 128 query rows over one kv head of 576 (v 512), q f32, pools bf16
K4_LATENT = [("latent serve step", K4_SERVE, 32),
             ("latent long", K4_LONG, 128)]


def ds_cfg(layers, experts=0, dense=None, dtype="bfloat16"):
    """deepseek-v3-671b at full width cut to ``layers`` (the first
    ``dense`` of them dense, ``experts`` routed experts), in ``dtype``."""
    from repro_torch.configs.registry import get
    cfg = get("deepseek-v3-671b")
    moe = dataclasses.replace(
        cfg.moe, n_experts=experts or cfg.moe.n_experts,
        first_k_dense=cfg.moe.first_k_dense if dense is None else dense)
    return dataclasses.replace(cfg, n_layers=layers, moe=moe, dtype=dtype)


def ds_train_cfg(dtype="bfloat16"):
    return ds_cfg(DS_TRAIN_LAYERS, DS_TRAIN_EXPERTS, 1, dtype)


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper runs its plain version, on the card's tensors
    too: the reference run of phases 23 and 23s, whose model is too large
    for a CPU run within the script's time.  The launch counters do not
    move in it."""
    from repro_torch.kernels import _build
    real = _build.on_cuda
    _build.on_cuda = lambda kernel, *tensors: False
    try:
        yield
    finally:
        _build.on_cuda = real


def ds_op_group(op):
    """``moe_op_group``, and MLA's absorbed decode einsums (``w_uk`` into
    q, ``w_uv`` out of the latent) apart: an ``aten::einsum`` among the
    kernel's first three callers (its bmm, the einsum, the caller)."""
    chain, o = [], op
    while o is not None and len(chain) < 3:
        chain.append(o.name)
        o = o.cpu_parent
    if "aten::einsum" in chain:
        return "MLA's absorbed einsums"
    return moe_op_group(op)


def phase_k2_mla(dev):
    """K2 at deepseek-v3's training attention: 1 x 2048, 128 heads, q and
    k at 192, v at 128, causal, through the simt route, f32 (to
    ``K2_F32_NORM_TOL``) and bf16 (to ``K2_NORM_TOL``) against the plain
    version, then times beside SDPA and the bound."""
    import torch
    from repro_torch.kernels import flash_attention as k2
    gen = torch.Generator(device=dev).manual_seed(5)
    return k2_wide(k2, dev, gen, DS_TRAIN_B, TRAIN_S, DS_NH, DS_NH, DS_DK,
                   "mla", dv=DS_DV, tag="5d", f32_tol=K2_F32_NORM_TOL)


def k4_latent_case(dev, lens, nb, seed):
    """``k4_case`` on MLA's latent shape: q (B, 128, 576) f32, the k pool
    (c_kv, k_rope) 576 wide and the v pool c_kv (its first 512) in bf16,
    one kv head; the step's own latent entry in f32."""
    import torch
    (q, k_pool, _, pos, tables, cur), (k_new, _) = k4_case(
        dev, lens, nb, torch.float32, seed, d=DS_R + DS_DR, nq=DS_NH, nkv=1)
    k_pool = k_pool.bfloat16()
    return ((q, k_pool, k_pool[:, :, :DS_R].contiguous(), pos, tables, cur),
            (k_new, k_new[:, :, :DS_R].contiguous()))


def k4_latent_bound(lens, nb, block=16):
    """The bounds of one latent K4 call with its fold, in ms: the bytes
    bound (q in, f32; the residuals out, f32; each valid latent entry read
    once, c_kv and k_rope in bf16, 1152 B, v being k's first 512; the
    positions of the table's columns, the tables and cur; the step's own
    entry), the operations bound of the QK (576) and PV (512) products at
    the f32 rate outside the tensor cores (q is f32, as the reference
    computes it), and their larger with its name."""
    B, nq, dk = len(lens), DS_NH, DS_R + DS_DR
    nbytes = (B * nq * dk * 4 + B * nq * (DS_R + 2) * 4
              + (sum(lens) + B) * dk * 2 + B * nb * (block + 1) * 4 + B * 4)
    flops = sum(n + 1 for n in lens) * nq * 2 * (dk + DS_R)
    bound, by = bound_ms(nbytes, flops, H100_F32_FLOPS)
    return {"bound_ms": bound, "bound_by": by,
            "bytes_bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "ops_bound_ms": flops / H100_F32_FLOPS * 1e3}


def phase_k4_latent(dev):
    """K4 on MLA's latent decode (``K4_LATENT``): B 8 at contexts 275-279
    and 64 slots of 1024-2048, block 16, through the simt route (q in
    f32, never cast to bf16) against the plain version, the residuals and
    the current token folded in, to ``K4_NORM_TOL["float32"]``; then
    device times (CUDA graph) of the kernel and of the step with its fold,
    the plain version and SDPA over contiguous bf16 K/V of the same
    lengths (not the same function), beside the bytes bound and the f32
    operations bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_decode as k4
    tol = K4_NORM_TOL["float32"]
    out = {}
    for label, lens, nb in K4_LATENT:
        args, new = k4_latent_case(dev, lens, nb, seed=len(label))
        check(args[0].dtype == torch.float32
              and k4.route_for(*args[:4], 16) == "simt",
              f"K4 {label}: not the simt route with q in f32")

        def kern(fn=k4.paged_flash_decode, args=args):
            return fn(*args, block=16, return_residuals=True)

        def step(fn=k4.paged_flash_decode, args=args, new=new):
            return k4.fold_current_token(args[0], *new, *kern(fn, args))
        got = dict(zip(("acc", "m", "l"), kern()), out=step())
        want = dict(zip(("acc", "m", "l"), kern(k4.paged_flash_decode_plain)),
                    out=step(k4.paged_flash_decode_plain))
        torch.cuda.synchronize()
        errs = k4_errs(got, want)
        absd = max(abs_err(got[n], want[n]) for n in want)
        print(f"[3d] K4 {label} (B {len(lens)}, {DS_NH} q f32 over 1 kv head "
              f"of {DS_R + DS_DR}/{DS_R} bf16) simt "
              + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (max abs {absd:.2e}; tol {tol})")
        check(all(e <= tol[n] for n, e in errs.items()),
              f"K4 {label}: {errs} above {tol}")
        # SDPA with the 128 heads as the query length of one head, which
        # is MQA over the one latent kv head without repeating it
        B, L = len(lens), max(lens)
        qs = torch.randn(B, 1, DS_NH, DS_R + DS_DR, device=dev,
                         dtype=torch.bfloat16)
        ks = torch.randn(B, 1, L, DS_R + DS_DR, device=dev,
                         dtype=torch.bfloat16)
        vs = ks[..., :DS_R]
        mask = (torch.arange(L, device=dev)[None, :]
                < torch.tensor(lens, device=dev)[:, None])[:, None, None, :]
        bounds = k4_latent_bound(lens, nb)
        t = {"ms": graph_ms(kern, 10), "step_ms": graph_ms(step, 10),
             "plain_ms": time_ms(lambda: kern(k4.paged_flash_decode_plain),
                                 3),
             "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                 qs, ks, vs, attn_mask=mask), 10),
             **bounds, "norm_err": errs, "max_abs_err": absd}
        print(f"[3d] K4 {label} device time: simt {t['ms']:.4f} ms, with "
              f"the fold {t['step_ms']:.4f}; plain {t['plain_ms']:.3f}; sdpa "
              f"over contiguous bf16 K/V {t['library_ms']:.4f}; bytes bound "
              f"{t['bytes_bound_ms']:.4f} ms (1152 B a token and q): "
              f"{t['bytes_bound_ms'] / t['ms'] * 100:.2f}% of it; f32 "
              f"operations bound {t['ops_bound_ms']:.4f} ms: "
              f"{t['ops_bound_ms'] / t['ms'] * 100:.2f}%; bound "
              f"{t['bound_ms']:.4f} ({t['bound_by']})")
        out[label] = t
        del args, new, got, want, qs, ks, vs
    return out


def phase_two_layer_deepseek(dev):
    """One training step of deepseek-v3 at full width cut to [dense, moe]
    with 16 routed experts (top 8, the shared one, the mtp head), f32,
    1 x 128, remat on: the kernels against their plain versions on the
    card (``plain_kernels``; a CPU run of the 16 GB of f32 weights and
    their gradients would not fit the script's time), the same seeded
    weights and tokens: loss, xent, aux, mtp and every gradient leaf
    within 1e-4 (of 1 + |loss|, of each leaf's max), the same choices
    dropped, the kernels launched by the kernel run only and as the plan
    says (``DS_LAUNCHES``; K1 on simt in f32, K2 on simt)."""
    import numpy as np
    import torch
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    cfg = ds_train_cfg("float32")
    layout = ParallelPlan().validate(mode="train").build()
    params = init_params(transformer.abstract_params(cfg),
                         torch.Generator(device=dev).manual_seed(23), dev,
                         torch.float32)
    rng = np.random.default_rng(23)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 129))).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, -9:] = -1
    res = {}
    for name, ctx in (("card", contextlib.nullcontext()),
                      ("plain", plain_kernels())):
        reset_launches()
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        with ctx:
            (loss, met), drops = routed_and_dropped(
                lambda: transformer.forward(cfg, layout, live, batch,
                                            mode="train"))
            grads = torch.autograd.grad(loss, tree_leaves(live))
        torch.cuda.synchronize()
        res[name] = ({k: v.item() for k, v in dict(met, loss=loss).items()},
                     grads, drops, read_launches())
        del live, loss, met
    (m_dev, g_dev, d_dev, n_dev), (m_pl, g_pl, d_pl, n_pl) = \
        res["card"], res["plain"]
    names = [".".join(p) for p in _paths(params)]
    errs = {n: (leaf_err(a, b), b.abs().max().item())
            for n, a, b in zip(names, g_dev, g_pl)}
    worst = max(e for e, _ in errs.values())
    tol = 1e-4
    want = dict(DS_LAUNCHES, **{"K4": 0, "K4 combine": 0})
    print(f"[23] deepseek-v3 [dense, moe] full width, {DS_TRAIN_EXPERTS} "
          f"experts, the mtp head, f32 train step (1x128), kernels against "
          f"their plain versions on the card: "
          + ", ".join(f"{k} {m_dev[k]:.6f} / {m_pl[k]:.6f}"
                      for k in ("loss", "xent", "aux", "mtp"))
          + f"; (routed, dropped) per MoE call {d_dev} / {d_pl}; gradient "
          f"max |kernels - plain| / max |plain| per leaf, worst first: "
          + ", ".join(f"{k} {e:.1e} [{g:.1e}]" for k, (e, g) in sorted(
              errs.items(), key=lambda kv: -kv[1][0])[:8])
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"launches {n_dev} (the plain run {n_pl})")
    check(all(v == 0 for v in n_pl.values()),
          f"deepseek two-layer: the plain run launched kernels {n_pl}")
    check(n_dev == want, f"deepseek two-layer launches {n_dev} != {want}")
    check(d_dev == d_pl and d_dev, f"deepseek two-layer drops: {d_dev} vs "
          f"{d_pl}")
    for k in ("loss", "xent", "aux", "mtp"):
        check(abs(m_dev[k] - m_pl[k]) <= tol * (1 + abs(m_pl[k]))
              and math.isfinite(m_dev[k]),
              f"deepseek two-layer {k}: {m_dev[k]} vs {m_pl[k]}")
    check(worst <= tol, f"deepseek two-layer train gradients: {worst}")
    del res, g_dev, g_pl
    return cfg, params


def phase_two_layer_deepseek_serve(dev, model):
    """Phase 23's model (the same f32 weights) through the engine's paged
    path: 2 requests of 16 prompt tokens in 2 slots, one chunked prefill
    and 8 greedy fused decode steps (max_len 64, block 16), the kernels
    against their plain versions on the card: the logits of every step
    within 1e-4 of 1 + max, the same tokens, and the kernels launched as
    the plan says (K2 and K4 on simt); then the gather-view decode's
    tokens, equal to the fused decode's."""
    import numpy as np
    import torch
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.serve import Engine, Request
    cfg, params = model
    layout = ParallelPlan().validate(mode="serve").build()
    prompts = np.random.default_rng(24).integers(0, cfg.vocab, (2, 16))
    res = {}
    for name, ctx, kw in (("card", contextlib.nullcontext(), {}),
                          ("plain", plain_kernels(), {}),
                          ("gather", contextlib.nullcontext(),
                           {"fused_decode": False})):
        eng = Engine(cfg, layout, params, batch_size=2, max_len=64,
                     block_size=16, **kw)
        logs, sample = [], eng._sample

        def recording(logits, sample=sample, logs=logs):
            logs.append(logits.detach().float())
            return sample(logits)
        eng._sample = recording
        reqs = [Request(uid=i, prompt=[int(t) for t in p], max_new=9)
                for i, p in enumerate(prompts)]
        reset_launches()
        with ctx:
            stats = eng.run(reqs)
        torch.cuda.synchronize()
        res[name] = (torch.stack(logs), [r.out for r in reqs],
                     read_launches(), dict(k4.launches_by_route), stats)
        del eng
    (l_dev, t_dev, n_dev, r_dev, s_dev), (l_pl, t_pl, n_pl, _, _), \
        (l_ga, t_ga, n_ga, r_ga, _) = res["card"], res["plain"], res["gather"]
    err = ((l_dev - l_pl).abs().amax(dim=(1, 2))
           / (1 + l_pl.abs().amax(dim=(1, 2))))
    pre, dec = s_dev["prefill_steps"], s_dev["decode_steps"]
    L = DS_TRAIN_LAYERS
    # per step K3 the 4 norms of each layer and ln_f; K1 the prefill's 8
    # linears a layer and the head, a decode step's 7 (w_ukv is absorbed)
    # and the head; K2 per prefill layer, K4 per decode layer, both simt
    want = {"K1": (8 * L + 1) * pre + (7 * L + 1) * dec, "K2": L * pre,
            "K2 bwd": 0, "K3": (4 * L + 1) * (pre + dec), "K3 bwd": 0,
            "K4": L * dec, "K4 combine": 0, "K5": 0, "K5 bwd": 0}
    print(f"[23s] deepseek-v3 [dense, moe] full width f32 through the paged "
          f"engine (2 slots, 16 prompt tokens, {pre} prefill + {dec} decode "
          f"steps), kernels against plain versions on the card: logits max "
          f"|kernels - plain| / (1 + max |plain|) per step, worst "
          f"{err.max().item():.1e} (tol 1e-4); greedy tokens equal "
          f"{t_dev == t_pl}; the gather-view decode's equal {t_ga == t_dev}; "
          f"launches {n_dev} (expected {want}), K4 by route {r_dev}; gather "
          f"view {n_ga}, K4 by route {r_ga}")
    check(all(v == 0 for v in n_pl.values()),
          f"deepseek decode path: the plain run launched kernels {n_pl}")
    check(pre == 1 and dec == 8 and n_dev == want,
          f"deepseek decode path launches {n_dev} over {s_dev} != {want}")
    check(r_dev["simt"] == L * dec and r_ga["simt"] == L * dec
          and n_ga["K4"] == L * dec,
          f"deepseek decode path: K4 routes {r_dev}, gather view {r_ga}")
    check(err.max().item() <= 1e-4 and torch.isfinite(l_dev).all(),
          f"deepseek decode path logits: {err.tolist()}")
    check(t_dev == t_pl, f"deepseek decode path tokens: {t_dev} vs {t_pl}")
    check(t_ga == t_dev, f"deepseek gather-view tokens: {t_ga} vs {t_dev}")


def deepseek_step_bytes(prompts, max_new, layers=DS_SERVE_LAYERS, block=16,
                        L=512):
    """(bytes of one decode step on average, steps, parts) of 7d's decode
    steps, each input read once and each output written once: every
    weight of the cut model but the mtp head's (every routed expert runs
    its capacity buffer every step, so all 256 are read; of the embedding
    only the slots' rows), and in each layer what K4 reads and writes for
    each slot (``k4_latent_bound``: q and the residuals in f32, each
    valid latent entry's 1152 bytes, the positions and tables) and the
    step's own latent entry written back."""
    from repro_torch.models import transformer
    cfg = ds_cfg(layers)
    params = transformer.abstract_params(cfg)
    weights = param_bytes(params) - param_bytes(
        {"e": params["embed"], "m": params["mtp"]})
    dk = DS_R + DS_DR
    steps = max_new - 1
    kv = layers * sum(
        DS_NH * dk * 4 + DS_NH * (DS_R + 2) * 4 + (p + j + 1) * dk * 2
        + (L // block) * (block + 1) * 4 + 4 + dk * 2
        for p in prompts for j in range(steps))
    parts = {"weights": steps * weights,
             "embed rows": steps * len(prompts) * cfg.d_model * 2, "kv": kv}
    return sum(parts.values()) / steps, steps, {
        k: v / steps for k, v in parts.items()}


def phase_serve_deepseek(card):
    """``repro_torch.launch.serve`` serves deepseek-v3-671b cut to its 3
    dense layers and one MoE layer of 256 experts, at full width in bf16,
    weights from a seed drawn on the card, with phase 7's traffic: 8
    requests in batch 8, a shared 256-token prefix and 3-7 more, 32 new
    tokens each, max_len 512, block 16, greedy.  The launch counters reset
    just before and read just after: launches per step exact, K1 on tc and
    decode, K2 (dk 192 / dv 128) and K4 (the latent decode) on simt.  Then
    the share of routed choices dropped at capacity in the prefill and per
    decode step, TTFT, TPOT and tok/s beside a decode step's bytes bound,
    peak memory; last, the same requests through the gather-view decode
    (``--no-fused-decode``) and the share of its tokens equal to the fused
    run's."""
    import gc

    import torch
    from repro_torch.launch import serve
    from repro_torch.serve import Engine
    argv = ["--arch", "deepseek-v3-671b", "--layers", str(DS_SERVE_LAYERS),
            "--device", "cuda", "--requests", "8", "--batch-size", "8",
            "--shared-prefix", "256", "--max-new", "32", "--max-len", "512",
            "--block-size", "16"]
    built, run = [], Engine.run

    def keep(self, *args, **kw):                 # the launcher's engine
        built.append(self)
        return run(self, *args, **kw)
    torch.cuda.reset_peak_memory_stats()
    Engine.run = keep
    reset_launches()
    try:
        stats, drops = routed_and_dropped(lambda: serve.main(argv))
        torch.cuda.synchronize()
    finally:
        Engine.run = run
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pre, dec = stats["prefill_steps"], stats["decode_steps"]
    L = DS_SERVE_LAYERS
    want = {"K1": (8 * L + 1) * pre + (7 * L + 1) * dec, "K2": L * pre,
            "K2 bwd": 0, "K3": (4 * L + 1) * (pre + dec), "K3 bwd": 0,
            "K4": L * dec, "K4 combine": 0, "K5": 0, "K5 bwd": 0}
    print(f"[7d] launches in the deepseek serving run: {launches} over {pre} "
          f"prefill + {dec} decode steps (expected {want})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"deepseek serving run: {stats['tokens']} tokens, "
          f"{stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"deepseek serving run: {stats['nonfinite_rows']} non-finite rows")
    check(launches == want, f"deepseek serving run launches {launches} != "
          f"{want}")
    routes = check_k1_routes(launches, "7d", "deepseek serving run")
    k2_routes = check_k2_routes(launches, "7d", "deepseek serving run",
                                route="simt")
    k4_routes = check_k4_routes(launches, "deepseek serving run", tag="7d",
                                route="simt")
    from repro_torch.models.registry import layer_plan
    moe_layers = layer_plan(ds_cfg(L)).count("moe")
    check(len(drops) == moe_layers * (pre + dec), f"deepseek serving run: "
          f"{len(drops)} MoE calls for {pre + dec} steps")
    share = [sum(dr for _, dr in drops[i * moe_layers:(i + 1) * moe_layers])
             / sum(r for r, _ in drops[i * moe_layers:(i + 1) * moe_layers])
             for i in range(pre + dec)]
    step_bytes, want_steps, parts = deepseek_step_bytes(
        [len(r.prompt) for r in serve_requests(8)], 32)
    check(pre == 1 and dec == want_steps, f"deepseek serving run: {pre} "
          f"prefill + {dec} decode steps, the bound counts 1 + {want_steps}")
    bound = step_bytes / H100_BYTES_PER_S * 1e3
    tpot = stats["tpot_p50_s"] * 1e3
    print(f"[7d] routed choices dropped at capacity: prefill "
          f"{share[0]:.4f}, decode steps mean "
          f"{sum(share[1:]) / max(1, dec):.4f}, max {max(share[1:]):.4f}")
    print(f"[7d] serving deepseek-v3-671b cut to {L} layers (3 dense, 1 MoE "
          f"of 256 experts), bf16, 8 requests x 32 new tokens on {card}: "
          f"TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 {tpot:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} "
          f"tok/s; a decode step's bound {bound:.3f} ms ("
          + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in parts.items())
          + f" a step, at 3.35 TB/s), TPOT / bound {tpot / bound:.2f}x; "
          f"peak memory {peak:.2f} GiB")
    fused = stats["outputs"]
    breakdown = phase_decode_breakdown_deepseek(built.pop(), card)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    gstats = serve.main(argv + ["--no-fused-decode"])
    torch.cuda.synchronize()
    glaunch = read_launches()
    gshare = equal_share(gstats["outputs"], fused)
    print(f"[7d] the gather-view decode: TPOT p50 "
          f"{gstats['tpot_p50_s'] * 1e3:.2f} ms, {gstats['tok_per_s']:.1f} "
          f"tok/s, bf16 tokens equal to the fused run's: "
          f"{gshare * 100:.1f}%; K4 launches {glaunch['K4']}")
    check(gstats["tokens"] == 8 * 32 and gstats["nonfinite_rows"] == 0
          and glaunch["K4"] == L * gstats["decode_steps"],
          f"deepseek gather-view run: {gstats['tokens']} tokens, "
          f"{glaunch}")
    return launches, routes, k2_routes, k4_routes, {
        "layers": L, "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "tpot_p50_ms": tpot, "tpot_p95_ms": stats["tpot_p95_s"] * 1e3,
        "tok_per_s": stats["tok_per_s"], "step_bound_ms": bound,
        "step_bytes": step_bytes, "drop_share_prefill": share[0],
        "drop_share_decode_mean": sum(share[1:]) / max(1, dec),
        "drop_share_decode_max": max(share[1:]), "mem_peak_gib": peak,
        "gather_view_tpot_p50_ms": gstats["tpot_p50_s"] * 1e3,
        "gather_view_equal_share": gshare, "decode_breakdown": breakdown}


def phase_decode_breakdown_deepseek(eng, card, at=16):
    """Where the time of one of 7d's fused decode steps goes: 7d's engine
    (its weights and pool) serves the same 8 requests again, and its
    ``at``-th decode step runs under torch.profiler: device time by
    kernel group, the absorbed einsums, the experts' bmm and the dispatch
    regrouped by the op that launched them (``ds_op_group``), against the
    step's synchronised wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    real, calls, out = eng._decode_step, [0], {}

    def step(*args):
        calls[0] += 1
        if calls[0] != at:
            return real(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = real(*args)
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["prof"] = prof
        return res
    eng._decode_step = step
    try:
        stats = eng.run(serve_requests(8))
    finally:
        del eng._decode_step
    check(stats["tokens"] == 8 * 32 and "prof" in out,
          f"deepseek decode breakdown: {stats['tokens']} tokens, "
          f"{calls[0]} decode steps")
    return report_breakdown(out["prof"], out["wall_ms"], "7d",
                            f"deepseek-v3's decode step {at} of "
                            f"{calls[0]} (8 slots, fused)", card,
                            op_group=ds_op_group)


def phase_k2_whisper(dev):
    """K2 at whisper's shapes (``K2_WHISPER``) in bf16 through the tc
    route against the plain version (``K2_NORM_TOL``, the backward
    repeating bit for bit), and in f32 through simt at the cross shape;
    then tc's forward and backward times beside the bound (``k2_work``,
    non-causal where the mask is) and SDPA's, which computes the same
    function (no mask where non-causal).  Returns {label: numbers}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    gen = torch.Generator(device=dev).manual_seed(26)
    k2_case(k2, dev, gen, 1, W_TEXT, W_NH, W_NH, 0, torch.float32,
            ["simt"], "whisper cross", tag="5w", sk=W_FRAMES, causal=False)
    out_all = {}
    for label, b, sq, sk, causal in K2_WHISPER:
        (q, k, v, dout, q_pos, k_pos), (out, lse), worst, norms = k2_case(
            k2, dev, gen, b, sq, W_NH, W_NH, 0, torch.bfloat16, ["tc"],
            label, tag="5w", sk=sk, causal=causal)
        check(k2.route_for(q, k, v, out, dout) == "tc",
              f"K2 {label}: the bf16 path does not take the tc route")
        kw = dict(causal=causal)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dt = dout.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
        sdpa_err = norm_err(sdpa().detach().transpose(1, 2), out)
        check(sdpa_err <= K2_NORM_TOL["out"], f"K2 {label}: SDPA is not "
              f"the same function ({sdpa_err:.2e})")
        t = {"fwd_ms": time_ms(lambda: k2.flash_attention_fwd(
                 q, k, v, q_pos, k_pos, **kw), 20),
             "bwd_ms": time_ms(lambda: k2.flash_attention_bwd(
                 q, k, v, out, dout, lse, q_pos, k_pos, **kw), 10),
             "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
                 q, k, v, q_pos, k_pos, **kw), 2),
             "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
                 q, k, v, out, dout, lse, q_pos, k_pos, **kw), 2),
             "library_fwd_ms": time_ms(sdpa, 20),
             "library_ms": time_ms(
                 lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt), 20),
             "norm_err": norms, "max_abs_err": worst,
             "sdpa_norm_err": sdpa_err}
        t["ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
        fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, W_NH, W_NH, W_DH, 2,
                                     causal=causal)
        fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
        bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
        t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
                 bound_by=fo if fo == bo else "bytes and operations",
                 fwd_gflop=ffl / 1e9)
        print(f"[5w] K2 bf16 {label} ({b},{sq}x{sk},{W_NH}/{W_NH},{W_DH}) "
              f"{'causal' if causal else 'non-causal'}, tc route: forward "
              f"{t['fwd_ms']:.4f} ms ({ffl / 1e9:.1f} GFLOP, "
              f"{ffl / t['fwd_ms'] / 1e9:.1f} TFLOP/s), backward "
              f"{t['bwd_ms']:.4f} ms ({bfl / t['bwd_ms'] / 1e9:.1f} "
              f"TFLOP/s); plain {t['plain_fwd_ms']:.3f} + "
              f"{t['plain_bwd_ms']:.3f}; sdpa fwd {t['library_fwd_ms']:.4f},"
              f" fwd+bwd {t['library_ms']:.4f} (tc / sdpa: forward "
              f"{t['fwd_ms'] / t['library_fwd_ms']:.2f}x, forward + backward "
              f"{t['ms'] / t['library_ms']:.2f}x); bound {fb:.4f} + "
              f"{bb:.4f} ({fo})")
        out_all[label] = t
        del q, k, v, dout, out, lse, qt, kt, vt
    return out_all


def phase_k4_cross(dev):
    """K4 over whisper's static cross k/v (``K4_CROSS``) as phase 3 holds
    the contiguous caches, and the model's own wrapper
    (``models/blocks.py:cross_decode``) against the reference's unmasked
    f32 softmax (``blocks.py:_cross_decode``) in bf16: the split route,
    one launch and its combine pass."""
    import torch
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.models.blocks import cross_decode
    shapes = phase_k4_contiguous(dev, K4_CROSS, "3w")
    label, curs, L, nq, nkv, _ = K4_CROSS[0]
    B = len(curs)
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((B, 1, nq, W_DH), (B, L, nkv, W_DH),
                             (B, L, nkv, W_DH)))
    before = (k4.launches_by_route["split"], k4.launches_combine)
    got = cross_decode(None, None, None, q, k, v)
    torch.cuda.synchronize()
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float() * W_DH ** -0.5,
                     k.float())
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (torch.einsum("bhk,bkhd->bhd", p, v.float())
            / p.sum(-1)[..., None]).to(q.dtype)[:, None]
    err = norm_err(got, want)
    print(f"[3w] blocks.cross_decode (B {B}, {L} frames, {nq}/{nkv} heads "
          f"of {W_DH}, bf16) against the reference's unmasked f32 softmax: "
          f"||error|| / ||want|| {err:.2e} (tol "
          f"{K4_NORM_TOL['bfloat16']['out']:.0e}); split launches "
          f"{k4.launches_by_route['split'] - before[0]}, combine "
          f"{k4.launches_combine - before[1]}")
    check(err <= K4_NORM_TOL["bfloat16"]["out"],
          f"cross_decode against the reference's softmax: {err}")
    check((k4.launches_by_route["split"] - before[0],
           k4.launches_combine - before[1]) == (1, 1),
          "cross_decode did not launch K4's split route once")
    shapes[label]["model_norm_err"] = err
    return shapes


def whisper_two_layer_cfg():
    """Full-width whisper-medium cut to 2 encoder and 2 decoder layers
    over all 1504 frames, f32."""
    from repro_torch.configs.registry import get
    base = get("whisper-medium")
    return dataclasses.replace(
        base, n_layers=2, dtype="float32",
        encoder=dataclasses.replace(base.encoder, n_layers=2))


def phase_two_layer_whisper(dev):
    """One training step's loss and every gradient leaf of full-width
    whisper cut to 2 + 2 layers, f32, 1 x 128 text tokens over 1504
    frames, remat on: CPU (plain versions) against the card (kernels: K1
    and K2 on simt), the same seeded weights, tokens and frames; the card
    launches exactly what the plan says and the CPU nothing.  Returns the
    CPU weights for phase 26s."""
    import numpy as np
    import torch
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    cfg = whisper_two_layer_cfg()
    layout = ParallelPlan().validate(mode="train").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(26), "cpu",
                      torch.float32)
    rng = np.random.default_rng(26)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 129)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone(),
             "frames": torch.from_numpy(rng.standard_normal(
                 (1, W_FRAMES, W_D)).astype(np.float32))}
    batch["labels"][0, -9:] = -1
    res = {}
    for d in ("cpu", dev):
        reset_launches()
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, met = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[str(d)] = (loss.item(), [g.cpu() for g in grads],
                       read_launches())
        del live, loss, met
    (l_cpu, g_cpu, n_cpu), (l_dev, g_dev, n_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    errs = {n: (leaf_err(a, b), b.abs().max().item())
            for n, a, b in zip(names, g_dev, g_cpu)}
    worst = max(e for e, _ in errs.values())
    tol = 1e-4
    # K1: the 2 encoder blocks' 6 linears, the 2 decoder blocks' 10 and
    # the head's one chunk, twice; K2: 2 + 2 x 2 attentions twice forward,
    # once backward
    want = dict(dict.fromkeys(n_dev, 0), K1=2 * (6 * 2 + 10 * 2 + 1),
                K2=2 * (2 + 2 * 2), **{"K2 bwd": 2 + 2 * 2})
    print(f"[26] whisper 2 + 2 layers full width f32 train step (1 x 128 "
          f"text, {W_FRAMES} frames): loss cpu {l_cpu:.6f} card "
          f"{l_dev:.6f}; gradient max |card - cpu| / max |cpu| per leaf, "
          f"worst first (max |cpu| in brackets): " + ", ".join(
              f"{k} {e:.1e} [{g:.1e}]" for k, (e, g) in sorted(
                  errs.items(), key=lambda kv: -kv[1][0])[:8])
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"launches card {n_dev}")
    check(all(v == 0 for v in n_cpu.values()) and n_dev == want,
          f"two-layer whisper: launches cpu {n_cpu}, card {n_dev} "
          f"(expected {want})")
    check(abs(l_cpu - l_dev) <= tol * (1 + abs(l_cpu))
          and math.isfinite(l_dev),
          f"two-layer whisper train loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer whisper train gradients: {worst}")
    return cpu, batch


def phase_two_layer_whisper_decode(dev, cpu, batch):
    """Phase 26's model through the decode path with its cross k/v filled:
    the encoder over phase 26's frames, each layer's ``xk``/``xv`` written
    from ``encdec.encoder_kv``, then 8 prompt tokens fed one a step and 8
    greedy steps of 2 slots, CPU against the card: the logits within 1e-4
    of 1 + max at every step, the same tokens, and on the card each
    step's K1 (decode route is not f32's: simt) and K4 (self and cross
    attention of each block, simt) launches exact."""
    import torch
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import encdec, transformer
    from repro_torch.serve.kvcache import cache_with_dtype
    cfg = whisper_two_layer_cfg()
    layout = ParallelPlan().validate(mode="serve").build()
    frames = batch["frames"].expand(2, -1, -1)
    prompt = batch["tokens"][:, :8].expand(2, -1) + \
        torch.tensor([[0], [1]])
    tree = cache_with_dtype(transformer.abstract_cache(cfg, layout, 2, 64),
                            torch.float32)
    res = {}
    for d in ("cpu", dev):
        params = tree_map(lambda t: t.to(d), cpu)
        cache = init_params(tree, None, d)
        with torch.no_grad():
            enc = encdec.encoder_apply(layout, cfg, transformer.entry_dirs(),
                                       frames.to(d), params["encoder"])
            for i in range(cfg.n_layers):
                xattn = tree_map(lambda t: t[i],
                                 params["stack"]["xdec"]["xattn"])
                k, v = encdec.encoder_kv(layout, cfg,
                                         transformer.entry_dirs(), enc, xattn)
                cache["xdec"]["xk"][i].copy_(k)
                cache["xdec"]["xv"][i].copy_(v)
            reset_launches()
            logits, toks = [], []
            tok = prompt[:, :1]
            for t in range(8 + 8):
                lg, cache = transformer.forward(
                    cfg, layout, params, {"token": tok.to(d), "pos": torch.full(
                        (2,), t, dtype=torch.int32, device=d)},
                    mode="decode", cache=cache)
                lg = lg.float().cpu()
                logits.append(lg)
                nxt = lg.argmax(-1)[:, None]
                toks.append(nxt)
                tok = prompt[:, t + 1:t + 2] if t + 1 < 8 else nxt
        launches = read_launches()
        res[str(d)] = (torch.stack(logits), torch.cat(toks, 1),
                       (launches["K1"], launches["K4"]))
    (l_cpu, t_cpu, n_cpu), (l_dev, t_dev, n_dev) = res["cpu"], res[str(dev)]
    err = ((l_dev - l_cpu).abs().amax(dim=(1, 2))
           / (1 + l_cpu.abs().amax(dim=(1, 2))))
    want = (16 * (8 * cfg.n_layers + 1), 16 * 2 * cfg.n_layers)
    print(f"[26s] whisper 2 + 2 layers full width f32 decode path, the "
          f"cross k/v filled from the encoder (2 slots, 8 prompt tokens one "
          f"a step, 8 greedy steps): logits max |card - cpu| / (1 + max "
          f"|cpu|) per step, worst {err.max().item():.1e} (tol 1e-4); "
          f"greedy tokens equal {torch.equal(t_cpu[:, 7:], t_dev[:, 7:])}; "
          f"(K1, K4) launches cpu {n_cpu}, card {n_dev}")
    check(n_cpu == (0, 0) and n_dev == want, f"whisper decode path: "
          f"launches cpu {n_cpu}, card {n_dev} (expected {want})")
    check(err.max().item() <= 1e-4 and torch.isfinite(l_dev).all(),
          f"whisper decode path logits: {err.tolist()}")
    check(torch.equal(t_cpu[:, 7:], t_dev[:, 7:]),
          f"whisper decode path greedy tokens differ: {t_cpu} vs {t_dev}")


def state_step_bytes(arch, prompts, max_new, L=512):
    """(bytes per step on average, steps, parts) of a state-path serving
    run's decode steps (phases 7v, 7w), each input read once and each
    output written once: the weights a decode step reads (not the
    embedding table, only the slots' rows; not whisper's encoder, nor its
    cross attention's wk and wv, whose k/v the cache holds), the kv
    entries each running slot's self attentions read and write, and
    whisper's cross k/v, every frame of each running slot in each layer.
    A slot of prompt p runs p + max_new - 1 steps."""
    from repro_torch.configs.registry import get
    from repro_torch.models import transformer
    cfg = get(arch)
    params = transformer.abstract_params(cfg)
    skip = {"embed": params["embed"]}
    if cfg.encoder:
        xattn = params["stack"]["xdec"]["xattn"]
        skip.update(encoder=params["encoder"], wk=xattn["wk"],
                    wv=xattn["wv"])
    weights = param_bytes(params) - param_bytes(skip)
    runs = [p + max_new - 1 for p in prompts]
    steps, slot_steps = max(runs), sum(runs)
    entry = cfg.n_layers * cfg.n_kv * cfg.head_dim * 2 * 2   # k and v, bf16
    # the step at position t reads t + 1 entries (its own just written)
    kv = sum(min(t + 1, L) for r in runs for t in range(r)) * entry
    parts = {"weights": steps * weights,
             "embed rows": slot_steps * cfg.d_model * 2,
             "self kv": kv + slot_steps * entry}
    if cfg.encoder:
        parts["cross k/v"] = slot_steps * cfg.encoder.n_frames * entry
    return sum(parts.values()) / steps, steps, {
        k: v / steps for k, v in parts.items()}


def phase_serve_state(card, arch, tag, per_step, step_bytes):
    """``repro_torch.launch.serve`` serves ``arch`` at full depth and width
    in bf16 with the state families' traffic (as 7z: 8 requests in batch
    8, prompts of 43-47 tokens fed one a step, 32 new, max_len 512,
    greedy); counters reset just before and read just after: launches per
    step exact (``per_step``), K1 on the decode route, every K4 on split
    with its combine; TTFT, TPOT and tok/s beside a decode step's bytes
    bound (``step_bytes(prompts, max_new)``: ``xlstm_step_bytes``,
    ``state_step_bytes``) and peak memory.  Phases 7x, 7w and 7v.
    Returns (launches, K1 routes, K4 routes, numbers)."""
    import torch
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = serve.main(["--arch", arch, "--device", "cuda",
                        "--requests", "8", "--batch-size", "8",
                        "--shared-prefix", "40", "--max-new", "32",
                        "--max-len", "512"])
    torch.cuda.synchronize()
    launches = read_launches()
    steps = stats["decode_steps"]
    want = {k: n * steps for k, n in per_step.items()}
    print(f"[{tag}] launches in the {arch} serving run: {launches} over "
          f"{stats['prefill_steps']} prefill + {steps} decode steps "
          f"(expected {want})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"{arch} serving run: {stats['tokens']} tokens, "
          f"{stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"{arch} serving run: {stats['nonfinite_rows']} non-finite rows")
    check(stats["prefill_steps"] == 0 and launches == want,
          f"{arch} serving run launches {launches} != {want}")
    routes = check_k1_routes(launches, tag, f"{arch} serving run")
    check(routes["decode"] == launches["K1"],
          f"{arch} serving run: K1 routes {routes}")
    k4_routes = check_k4_routes(launches, f"{arch} serving run", tag)
    nbytes, want_steps, parts = step_bytes(
        [len(r.prompt) for r in serve_requests(8, shared=40)], 32)
    check(steps == want_steps, f"{arch} serving run: {steps} decode steps, "
          f"the bound counts {want_steps}")
    bound = nbytes / H100_BYTES_PER_S * 1e3
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{tag}] serving {arch} bf16, 8 requests (prompts 43-47 fed one "
          f"a step) x 32 new tokens on {card}: TTFT p50 "
          f"{stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{stats['tpot_p50_s'] * 1e3:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} "
          f"tok/s; a step's bound on average {bound:.3f} ms ("
          + ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in parts.items())
          + f" a step, at 3.35 TB/s); peak memory {mem:.2f} GiB")
    return launches, routes, k4_routes, {
        "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "ttft_p95_ms": stats["ttft_p95_s"] * 1e3,
        "tpot_p50_ms": stats["tpot_p50_s"] * 1e3,
        "tpot_p95_ms": stats["tpot_p95_s"] * 1e3,
        "tok_per_s": stats["tok_per_s"], "step_bound_ms": bound,
        "mem_peak_gib": mem}


# ---------------------------------------------------------------------------
# The paper's 3-D cube across ranks.  The card's machine has one H100 and
# NCCL refuses two ranks on a device, so the multi-rank phases run 8 ranks
# on the one card over gloo: the kernels run on the card and every
# collective is staged through the host (core/comm.py).  Their times
# measure the kernels and that staging; they are no measure of the
# paper's communication claim.
# ---------------------------------------------------------------------------
# the layouts (tests/test_multidev.py:66-67): name -> (dp, model, cube[,
# strategy]); the 3-D strategy where none is named
RANK_LAYOUTS = {"cube": (1, 8, (2, 2, 2)), "dp2": (2, 4, (2, 2, 1))}
# pipeline stages (tests/test_pipeline.py:66-67): -> (dp, model, cube,
# strategy, pp, microbatches)
PP_LAYOUTS = {"pp2": (1, 4, (1, 2, 2), "3d", 2, 4)}
# the paper's baselines (tests/test_multidev.py:68-69): 1d(4) and 2d(q2)
BASE_LAYOUTS = {"1d": (2, 4, None, "1d"), "2d": (2, 4, None, "2d")}
# async-TP: phase 29 runs these layouts again with each 3-D island in
# OVERLAP_CHUNKS chunks (--overlap), in its one world; phase 30 its
# (2,2,2) run, in the same torchrun world as the plain one
OVERLAP_LAYOUTS = {"cube_overlap": "cube", "pp2_overlap": "pp2"}
OVERLAP_CHUNKS = 4
OVERLAP_ARGV = ["--overlap", "--overlap-chunks", str(OVERLAP_CHUNKS)]
# 30r and phase 30's Moonlight run take 2 steps, the first a warm-up;
# the tinyllama runs of 30, 33 and 37 take ``RANK_CUT_STEPS`` (the
# warm-up alone, beside the MoE rank runs): the script's time limit
# binds
RANKS, RANK_STEPS, RANK_TIMEOUT_S = 8, 2, 600
# phases 30 and 33 train tinyllama-1.1b cut to this many of its 22 layers:
# each world of 8 ranks stages its steps' collectives through the host,
# and the script's time limit binds
RANK_TRAIN_LAYERS, RANK_CUT_STEPS = 2, 1
RANK_DEVICE = "cuda"            # "cpu" to rehearse the rank phases
RANK_SCRIPT = ROOT / "chip_smoke.py"    # each rank runs its --rank-job
# phase 29: tinyllama cut to 2 layers at full width in f32, 4 x 512
R29_SEED, R29_B, R29_S = 29, 4, 512
# phase 29's MoE: moonshot-v1-16b-a3b cut to [dense, moe] (phase 20's cut)
# at these layouts in the same world, at a capacity factor at which no
# choice drops on one rank or on a rank (asserted): the capacity is a
# rank's own (models/moe.py, the reference's moe.py:132), so a drop would
# make the two runs differ by design
R29M_LAYOUTS, R29M_CF = ("cube", "dp2"), 4.0
# phase 30's MoE run: that cut in bf16 through the launcher at (2,2,2)
MOON = "moonshot-v1-16b-a3b"


def rank_layout(lname, rank=0, layouts=None):
    """Rank ``rank``'s Layout of ``layouts[lname]``: (dp, model, cube[,
    strategy[, pp, microbatches]])."""
    from repro_torch.core.topology import make_layout
    n_dp, n_model, cube, *more = (layouts or RANK_LAYOUTS)[lname]
    strategy, n_pp, mb = more + ["3d", 1, 1][len(more):]
    return make_layout(1, n_dp, n_model, strategy, cube, rank=rank,
                       n_pp=n_pp, microbatches=mb)


def rank_flags(lname, layouts=None):
    n_dp, n_model, cube, *more = (layouts or RANK_LAYOUTS)[lname]
    return (["--dp", str(n_dp), "--model", str(n_model)]
            + (["--cube", ",".join(map(str, cube))] if cube else [])
            + (["--strategy", more[0]] if more else [])
            + (["--pp", str(more[1]), "--microbatch", str(more[2])]
               if len(more) > 1 else []))


def rank_gemms(lname, layouts=None):
    """(name, M, K, N, launches a step) of one rank's K1 GEMMs in a
    tinyllama-1.1b training step (4 x 2048, remat) at layout ``lname``,
    from the weights' specs; the head in 2 loss chunks.  3d: x gathered
    over in_ax (its batch stays split over pod, dp and x) times the
    weight's columns gathered over 'x', so K is the hidden dim split over
    out_ax and N the features split over in_ax, the axes swapped for wo
    and w_down.  2d: the rank's rows of the sequence (over 'y') with x
    gathered over 'z' and w over 'y', so K is whole and N split over 'z'.
    1d: every row, K whole for the column linears and split over 'z' for
    the row linears (wo, w_down), N the other way."""
    lay = rank_layout(lname, layouts=layouts)
    y, z = lay.size("y"), lay.size("z")
    m = TRAIN_B // lay.size(lay.batch_axes) * TRAIN_S
    if lay.strategy != "3d":
        m //= y
        kz = z if lay.strategy == "1d" else 1       # the row linears' K
        return [("wq", m, D, NQ * DH // z, 2 * LAYERS),
                ("wk,wv", m, D, NKV * DH // z, 2 * 2 * LAYERS),
                ("wo", m, NQ * DH // kz, D // (z // kz), 2 * LAYERS),
                ("w_up,w_gate", m, D, FF // z, 2 * 2 * LAYERS),
                ("w_down", m, FF // kz, D // (z // kz), 2 * LAYERS),
                ("head", m // 2, D, VOCAB // z, 2 * 2)]
    return [("wq", m, D // z, NQ * DH // y, 2 * LAYERS),
            ("wk,wv", m, D // z, NKV * DH // y, 2 * 2 * LAYERS),
            ("wo", m, NQ * DH // y, D // z, 2 * LAYERS),
            ("w_up,w_gate", m, D // z, FF // y, 2 * 2 * LAYERS),
            ("w_down", m, FF // y, D // z, 2 * LAYERS),
            ("head", m // 2, D // z, VOCAB // y, 2 * 2)]


def phase_k1_ranks(dev, layouts=None, tag="2c"):
    """2c: K1 at every local GEMM shape of a (2,2,2) rank and of a dp2 x
    (2,2,1) rank of tinyllama-1.1b's training step (``rank_gemms``; 2b:
    of a 1d(4) and a 2d(q2) rank, ``layouts=BASE_LAYOUTS``): the tc
    route, which ``route`` must pick, against the plain version in bf16
    with every activation, with and without bias; then timed as tc, the
    plain version and ``torch.matmul``, each times its launches a step,
    which sum to the step's K1 launches."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(31)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    seen, out, worst_err = {}, {}, 0.0
    for lname in (layouts or RANK_LAYOUTS):
        tot = dict.fromkeys(keys, 0.0)
        launches = 0
        for name, m, k, n, per in rank_gemms(lname, layouts):
            key = (m, k, n)
            if key not in seen:
                path = k1.route(m, n, k, torch.bfloat16, True)
                check(path == "tc", f"K1 rank {lname} {name} ({m},{k},{n}):"
                      f" route {path}")
                x, w, b = k1_inputs(gen, dev, m, k, n, torch.bfloat16)
                worst, worst_abs = k1_check(k1, x, w, b)
                worst_err = max(worst_err, worst_abs)
                check(worst <= 1e-2, f"K1 rank {lname} {name}: {worst}")
                del x, w, b
                t = seen[key] = k1_time(k1, dev, gen, m, k, n, 10,
                                        {"ms": path})
                print(f"[{tag}] K1 {lname} rank GEMM {name} ({m},{k})@"
                      f"({k},{n})"
                      f" bf16 tc: max rel err {worst:.2e} (tol 1e-02); "
                      f"{t['ms']:.4f} ms ({2 * m * k * n / t['ms'] / 1e9:.1f}"
                      f" TFLOP/s), plain {t['plain_ms']:.4f}, torch.matmul "
                      f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} "
                      f"({t['bound_by']})")
            for kk in keys:
                tot[kk] += per * seen[key][kk]
            launches += per
        check(launches == TRAIN_LAUNCHES["K1"],
              f"K1 {lname} rank GEMMs: {launches} a step")
        print(f"[{tag}] K1 per {lname} rank's training step ({launches} GEMMs,"
              f" bf16): kernel {tot['ms']:.2f} ms, torch.matmul "
              f"{tot['library_ms']:.2f} ms "
              f"({tot['ms'] / tot['library_ms']:.2f}x), plain "
              f"{tot['plain_ms']:.2f} ms, bound {tot['bound_ms']:.2f} ms")
        out[f"rank_{lname}"] = tot
    return out, worst_err


# K3 in two phases (phase 4c): (label, the norm's width, pieces a row is
# cut in) at 8192 rows: the (2,2,2) cube cuts tinyllama's and gemma-2b's
# 2048 and qwen3-4b's 2560 in 2, a z of 4 in 4
K3_SPLIT_CASES = [("tinyllama, gemma-2b", D, 2), ("tinyllama, gemma-2b", D, 4),
                  ("qwen3-4b", 2560, 2), ("qwen3-4b", 2560, 4)]


def read_split_launches():
    from repro_torch.kernels import rmsnorm as k3
    return {"K3 moments": k3.launches_moments, "K3 apply": k3.launches_apply,
            "K3 bwd dot": k3.launches_bwd_dot,
            "K3 bwd apply": k3.launches_bwd_apply}


def k3_split_case(k3, dev, gen, m, h, n, dtype, zc, label):
    """K3's two phases on rows of ``h`` cut in ``n`` pieces, the pieces'
    partial sums added on the device in piece order as the all-reduce
    adds them: y, dx and dg (the pieces' own, side by side) against the
    plain versions of the phases and against the one-phase K3 on the whole
    rows, each within ``K3_NORM_TOL``.  Returns one piece's inputs and
    the all-reduced ss and dot, and the norm errors."""
    import torch
    x = torch.randn(m, h, generator=gen, device=dev).to(dtype)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(m, h, generator=gen, device=dev).to(dtype)
    xs, gs, dys = ([t.contiguous() for t in a.chunk(n, -1)]
                   for a in (x, g, dy))
    ss = sum(k3.rmsnorm_moments(p) for p in xs)
    fw = [k3.rmsnorm_apply(p, gp, ss, h, zero_centered=zc)
          for p, gp in zip(xs, gs)]
    dot = sum(k3.rmsnorm_bwd_dot(d, p, gp, zc)
              for d, p, gp in zip(dys, xs, gs))
    bw = [k3.rmsnorm_bwd_apply(d, p, gp, rstd, dot, h, zc)
          for d, p, gp, (_, rstd) in zip(dys, xs, gs, fw)]
    ss2 = sum(k3.rmsnorm_moments_plain(p) for p in xs)
    fw2 = [k3.rmsnorm_apply_plain(p, gp, ss2, h, zero_centered=zc)
           for p, gp in zip(xs, gs)]
    dot2 = sum(k3.rmsnorm_bwd_dot_plain(d, p, gp, zc)
               for d, p, gp in zip(dys, xs, gs))
    bw2 = [k3.rmsnorm_bwd_apply_plain(d, p, gp, rstd, dot2, h, zc)
           for d, p, gp, (_, rstd) in zip(dys, xs, gs, fw2)]
    y1, rstd1 = k3.rmsnorm_fwd(x, g, zero_centered=zc)
    dx1, dg1 = k3.rmsnorm_bwd(dy, x, g, rstd1, zero_centered=zc)
    got = {"y": torch.cat([a for a, _ in fw], -1),
           "dx": torch.cat([a for a, _ in bw], -1),
           "dg": torch.cat([b for _, b in bw], -1)}
    plain = {"y": torch.cat([a for a, _ in fw2], -1),
             "dx": torch.cat([a for a, _ in bw2], -1),
             "dg": torch.cat([b for _, b in bw2], -1)}
    whole = {"y": y1, "dx": dx1, "dg": dg1}
    name = str(dtype)[6:]
    ntol = K3_NORM_TOL[name]
    norms = {"plain": {k: norm_err(got[k], plain[k]) for k in got},
             "one-phase": {k: norm_err(got[k], whole[k]) for k in got}}
    print(f"[4c] K3 two phases {label} ({m},{h}) cut in {n} {name:8s} "
          f"zc={zc!s:5s} ||error|| / ||want||: against the plain phases "
          + ", ".join(f"{k} {v:.2e}" for k, v in norms["plain"].items())
          + "; against the one-phase K3 on whole rows "
          + ", ".join(f"{k} {v:.2e}" for k, v in norms["one-phase"].items())
          + " (tol " + ", ".join(f"{k} {v:.0e}" for k, v in ntol.items())
          + ")")
    for what, errs in norms.items():
        check(all(errs[k] <= ntol[k] for k in ntol),
              f"K3 two phases ({m},{h})/{n} {name} zc={zc} against {what}: "
              f"{errs}")
    worst = max(abs_err(got[k], plain[k]) for k in got)
    return (xs[0], gs[0], dys[0], fw[0][1], ss, dot), norms, worst


def phase_k3_split(dev):
    """4c: K3 in two phases (``K3_SPLIT_CASES``) at 8192 rows, forward
    and backward, in bf16, and at the (2,2,2) cube's cut also in f32 and
    zero-centred (gemma-2b); then one rank's device time of the two
    phases (moments + apply, dot + apply) on its piece beside their bytes
    bound, the plain versions and ``F.rms_norm``'s time on the whole
    row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as k3
    gen = torch.Generator(device=dev).manual_seed(33)
    m = TRAIN_B * TRAIN_S
    out, worst_err = {}, 0.0
    for dtype, zc in ((torch.float32, False), (torch.bfloat16, True)):
        k3_split_case(k3, dev, gen, m, D, 2, dtype, zc,
                      "tinyllama, gemma-2b")
    for label, h, n in K3_SPLIT_CASES:
        (x, g, dy, rstd, ss, dot), norms, worst = k3_split_case(
            k3, dev, gen, m, h, n, torch.bfloat16, False, label)
        worst_err = max(worst_err, worst)
        hl = h // n
        xw = torch.randn(m, h, generator=gen, device=dev).to(torch.bfloat16)
        gw = torch.ones(h, device=dev, dtype=torch.bfloat16)
        xr = xw.detach().requires_grad_()
        gr = gw.detach().requires_grad_()
        lib_out = F.rms_norm(xr, (h,), gr, 1e-6)
        dyw = torch.randn(m, h, generator=gen, device=dev).to(torch.bfloat16)

        def lib_bwd():
            torch.autograd.grad(lib_out, (xr, gr), dyw, retain_graph=True)
        t = {"fwd_ms": graph_ms(lambda: k3.rmsnorm_apply(
                 x, g, k3.rmsnorm_moments(x), h), 50),
             "bwd_ms": graph_ms(lambda: k3.rmsnorm_bwd_apply(
                 dy, x, g, rstd, k3.rmsnorm_bwd_dot(dy, x, g), h), 50),
             "plain_fwd_ms": time_ms(lambda: k3.rmsnorm_apply_plain(
                 x, g, k3.rmsnorm_moments_plain(x), h), 10),
             "plain_bwd_ms": time_ms(lambda: k3.rmsnorm_bwd_apply_plain(
                 dy, x, g, rstd, k3.rmsnorm_bwd_dot_plain(dy, x, g), h), 10),
             "library_fwd_ms": graph_ms(
                 lambda: F.rms_norm(xw, (h,), gw, 1e-6), 50),
             "library_bwd_ms": kernel_ms(lib_bwd, 20),
             "norm_err": norms, "max_abs_err": worst}
        t["ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
        t["library_ms"] = (t["library_fwd_ms"] + t["library_bwd_ms"]
                           if t["library_bwd_ms"] is not None else None)
        # one rank's piece: x (and dy) read once, y (dx) written once, the
        # gains, rstd, and the row sums written by phase 1 and read back
        fb, fo = bound_ms(2 * m * hl * 2 + hl * 2 + m * 4 + 2 * m * 4,
                          4 * m * hl, H100_F32_FLOPS)
        bb, bo = bound_ms(3 * m * hl * 2 + 2 * hl * 2 + m * 4 + 2 * m * 4,
                          10 * m * hl, H100_F32_FLOPS)
        t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
                 bound_by=fo if fo == bo else "bytes and operations")
        lib = t["library_ms"]
        print(f"[4c] K3 two phases bf16 {label}, one rank's piece ({m},{hl}) "
              f"of rows of {h}, device time: moments + apply "
              f"{t['fwd_ms']:.4f} ms ({fb / t['fwd_ms'] * 100:.0f}% of its "
              f"bound {fb:.4f} {fo}), dot + apply {t['bwd_ms']:.4f} ms "
              f"({bb / t['bwd_ms'] * 100:.0f}% of its bound {bb:.4f} {bo});"
              f" plain {t['plain_fwd_ms']:.4f} + {t['plain_bwd_ms']:.4f} ms;"
              f" F.rms_norm on the whole rows {t['library_fwd_ms']:.4f} + "
              + (f"{t['library_bwd_ms']:.4f} ms" if lib else "not measured"))
        out[f"{m}x{h}/{n}"] = t
        del xw, gw, xr, gr, lib_out, dyw
    return dict(out[f"{m}x{D}/2"], shapes=out, max_abs_err=worst_err)


# K2 at a (2,2,2) rank's attention (phase 5c): (label, batch, q rows,
# keys, the first q row's position, q heads, kv heads, d), causal: a
# tinyllama rank's 1024 rows of 16 heads at both offsets over the 2048
# gathered keys of its 2 kv heads, and gemma-2b's replicated-kv slice (4
# of 8 q heads, its one kv head, d 256: the simt route)
K2_RANK_SHAPES = [("tinyllama rank", TRAIN_B // 2, TRAIN_S // 2, TRAIN_S, 0,
                   NQ // 2, NKV // 2, DH),
                  ("tinyllama rank", TRAIN_B // 2, TRAIN_S // 2, TRAIN_S,
                   TRAIN_S // 2, NQ // 2, NKV // 2, DH),
                  ("gemma-2b rank", TRAIN_B // 2, TRAIN_S // 2, TRAIN_S,
                   TRAIN_S // 2, 4, 1, 256)]


def phase_k2_ranks(dev, shapes=None, tag="5c"):
    """5c: K2 at the (2,2,2) rank shapes (``K2_RANK_SHAPES``; 5b: a 1d(4)
    rank's, ``K2_BASE_SHAPES``), forward and backward, the route the path
    takes (tc at d 64, simt at gemma's d 256) against the plain version
    in bf16 (and the simt route in f32 at d 256); then the route's, the
    plain version's and SDPA's (with the same boolean mask) times beside
    the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    gen = torch.Generator(device=dev).manual_seed(35)
    out, worst_err = {}, 0.0
    for label, b, sq, sk, q0, nq, nkv, d in (shapes or K2_RANK_SHAPES):
        route = "tc" if d == DH else "simt"
        if route == "simt":
            k2_case(k2, dev, gen, b, sq, nq, nkv, 0, torch.float32,
                    ["simt"], label, d=d, sk=sk, q0=q0, tag=tag)
        (q, k, v, dout, q_pos, k_pos), (o, lse), worst, norms = k2_case(
            k2, dev, gen, b, sq, nq, nkv, 0, torch.bfloat16, [route], label,
            d=d, sk=sk, q0=q0, tag=tag)
        check(k2.route_for(q, k, v, o, dout) == route,
              f"K2 {label}: the bf16 path does not take {route}")
        worst_err = max(worst_err, worst)
        mask = (q_pos[0][:, None] >= k_pos[None, :])
        qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                      for a in (q, k, v))
        dt = dout.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        reps = (10, 5) if route == "tc" else (2, 1)
        t = {"fwd_ms": time_ms(lambda: k2.flash_attention_fwd(
                 q, k, v, q_pos, k_pos), reps[0]),
             "bwd_ms": time_ms(lambda: k2.flash_attention_bwd(
                 q, k, v, o, dout, lse, q_pos, k_pos), reps[1]),
             "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
                 q, k, v, q_pos, k_pos), 1),
             "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
                 q, k, v, o, dout, lse, q_pos, k_pos), 1),
             "library_fwd_ms": time_ms(sdpa, 10),
             "library_ms": time_ms(
                 lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt), 10),
             "norm_err": norms, "route": route}
        t["ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
        fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, nq, nkv, d, 2)
        fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
        bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
        t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
                 bound_by=fo if fo == bo else "bytes and operations")
        print(f"[{tag}] K2 bf16 {label} ({b},{sq}x{sk} from {q0},{nq}/{nkv},"
              f"{d}) causal, {route}: forward {t['fwd_ms']:.4f} ms "
              f"({ffl / t['fwd_ms'] / 1e9:.1f} TFLOP/s), backward "
              f"{t['bwd_ms']:.4f} ms ({bfl / t['bwd_ms'] / 1e9:.1f} "
              f"TFLOP/s); plain {t['plain_fwd_ms']:.3f} + "
              f"{t['plain_bwd_ms']:.3f}; sdpa with the mask fwd "
              f"{t['library_fwd_ms']:.4f}, fwd+bwd {t['library_ms']:.4f}; "
              f"bound {fb:.4f} + {bb:.4f} ({fo})")
        out[f"{label} {b}x{sq}x{sk}@{q0} {nq}/{nkv} d{d}"] = t
        del q, k, v, dout, o, lse, qt, kt, vt
    return out, worst_err


def run_rank_job(job, torchrun=False, nranks=RANKS):
    """Run ``job`` on ``nranks`` ranks (``chip_smoke.py
    --rank-job``): under torchrun (``python -m torch.distributed.run
    --standalone``, which gives each rank RANK, WORLD_SIZE and LOCAL_RANK
    and a rendezvous on localhost) or ``launch/ranks.spawn_local`` (a
    file rendezvous).  A rank that fails, or a world that outlives
    ``RANK_TIMEOUT_S``, fails the phase; every rank is stopped.  Returns
    each rank's result."""
    import os
    import shutil
    import signal
    d = ROOT / "build" / "chip_smoke_ranks" / f"{job['kind']}_{job['layout']}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    job = dict(job, out=str(d))
    (d / "job.json").write_text(json.dumps(job))
    tail = [str(RANK_SCRIPT), "--rank-job", str(d / "job.json")]
    sys.stdout.flush()
    if torchrun:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nranks), *tail],
            start_new_session=True)
        try:
            rc = proc.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise SmokeFailure(f"{job['kind']} {job['layout']}: the ranks "
                               f"outlived {RANK_TIMEOUT_S} s")
        check(rc == 0, f"{job['kind']} {job['layout']}: torchrun exited {rc}")
    else:
        from repro_torch.launch import ranks
        try:
            outs = ranks.spawn_local([sys.executable, *tail], nranks,
                                     timeout=RANK_TIMEOUT_S)
        except RuntimeError as e:
            raise SmokeFailure(str(e)) from e
        print(outs[0], end="")
    return [json.loads((d / f"rank{r}.json").read_text())
            for r in range(nranks)]


def rank_job(path):
    """One rank of a multi-rank phase (``chip_smoke.py --rank-job JOB``):
    runs the job and writes the rank's result beside it."""
    job = json.loads(Path(path).read_text())
    sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import ranks
    me = ranks.rank_env()
    res = {"grads": rank_grads, "train": rank_train,
           "base": rank_base, "zero": rank_zero}[job["kind"]](job, me)
    (Path(job["out"]) / f"rank{me.rank}.json").write_text(json.dumps(res))
    return 0


def r29_cfg():
    from repro_torch.configs.registry import get
    return dataclasses.replace(get("tinyllama-1.1b"), n_layers=2,
                               dtype="float32")


def r29_batch(vocab):
    import numpy as np
    rng = np.random.default_rng(R29_SEED)
    toks = rng.integers(0, vocab, (R29_B, R29_S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[-1, -7:] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def r29m_cfg():
    """Phase 29's MoE model: phase 20's Moonlight [dense, moe] in f32 at
    the capacity factor ``R29M_CF``."""
    cfg = moon_two_layer_cfg()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=R29M_CF))


def rank_grads(job, me):
    """Phase 29's rank, at each layout of ``job["layouts"]`` in turn in
    one world: the f32 two-layer model's loss and gradient shards (the
    train step's leaf sync included), each leaf held to the one-rank
    run's block at the rank's coordinates; then the same for Moonlight's
    [dense, moe] at each of ``job["moe_layouts"]`` (named ``moe_<layout>``
    in the result), with the choices routed and dropped."""
    import torch.distributed as dist
    from repro_torch.launch import ranks
    dev = ranks.device_for(me, job["device"])
    ranks.init_world(me, "gloo", dev)
    out = {}
    for lname in job["layouts"]:
        out[lname] = rank_grads_at(dev, me, r29_cfg(), job["ref"], lname)
    for lname in job.get("moe_layouts", ()):
        out[f"moe_{lname}"] = rank_grads_at(dev, me, r29m_cfg(),
                                            job["moe_ref"], lname)
    dist.destroy_process_group()
    return out


def rank_grads_at(dev, me, cfg, ref_path, lname):
    """One layout of ``rank_grads``: the loss, each gradient leaf's error
    against the reference's block, the launches, bytes and (for an MoE
    model) the (routed, dropped) choices summed over its MoE calls."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core.params import init_params, shard, tree_leaves
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.models import transformer
    from repro_torch.models.registry import repartition_stack
    from repro_torch.train.step import loss_and_grads
    # mapped, not read: each rank reads only its blocks of the leaves
    ref = torch.load(ref_path, mmap=True)
    t = time.perf_counter()
    base = OVERLAP_LAYOUTS.get(lname, lname)
    n_dp, n_model, cube, *more = {**RANK_LAYOUTS, **PP_LAYOUTS}[base]
    _, n_pp, mb = more + ["3d", 1, 1][len(more):]
    lay = comm.init(ParallelPlan(
        n_dp=n_dp, n_model=n_model, cube=tuple(cube), n_stages=n_pp,
        microbatches=mb, overlap=base != lname,
        overlap_chunks=OVERLAP_CHUNKS).validate().build(me.rank), "gloo")
    abstract = transformer.abstract_params(cfg, lay)
    # at pp 2 the stage slabs of the same draws (the one-rank leaves
    # re-cut: the plan is homogeneous)
    params = init_params(abstract, torch.Generator(
        device=dev).manual_seed(R29_SEED), dev, torch.float32, layout=lay)
    batch = to_device(shard_batch(r29_batch(cfg.vocab), lay), dev)
    reset_launches()
    comm.reset_bytes()
    (loss, _, grads), drops = routed_and_dropped(
        lambda: loss_and_grads(cfg, lay, params, batch))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(read_launches(), **read_split_launches())
    names = ["/".join(p) for p in _paths(params)]

    def want(n):
        g = ref["grads"][n]
        if n_pp > 1 and n.startswith("stack/"):
            kind = n.split("/")[1]
            g = repartition_stack(cfg, {kind: g}, 1, n_pp)[kind]
        return g
    errs = {n: leaf_err(g, shard(want(n), p.spec, lay).to(dev))
            for n, g, p in zip(names, grads, tree_leaves(abstract))}
    return {"loss": loss.item(), "ref_loss": ref["loss"], "errs": errs,
            "launches": launches, "bytes": comm.bytes_moved(),
            "drops": [sum(d[0] for d in drops), sum(d[1] for d in drops)],
            "wall_s": time.perf_counter() - t}


def one_rank_grads(dev, cfg, ref):
    """The one-rank run that phase 29 holds the ranks to: ``cfg``'s f32
    loss and gradients at ``R29_SEED``'s weights and batch, saved to
    ``ref``; returns (loss, [(routed, dropped)] of its MoE calls)."""
    import torch
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import to_device
    from repro_torch.models import transformer
    lay = ParallelPlan().validate().build()
    params = init_params(transformer.abstract_params(cfg),
                         torch.Generator(device=dev).manual_seed(R29_SEED),
                         dev, torch.float32)
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    (loss, _), drops = routed_and_dropped(lambda: transformer.forward(
        cfg, lay, live, to_device(r29_batch(cfg.vocab), dev), mode="train"))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    ref.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"loss": loss.item(), "grads": {
        "/".join(p): g.cpu() for p, g in zip(_paths(params), grads)}}, ref)
    one = loss.item()
    del params, live, loss, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return one, drops


def phase_ranks_grads(dev):
    """29: tinyllama-1.1b cut to 2 layers at full width, f32, 4 x 512, one
    forward and backward on 8 ranks at each layout (and at (2,2,2) and
    pp2 with the islands in ``OVERLAP_CHUNKS`` chunks) against the
    one-rank run on the same card: the loss within 1e-4, and every rank's
    shard of every gradient leaf within 1e-4 of the leaf's largest value
    (after the train step's leaf sync); K1, K2 and K3 (two phases at
    (2,2,2)) must have run on every rank.  Then, in the same world,
    Moonlight cut to [dense, moe] at full width (``r29m_cfg``: 64 experts
    of 1408, 2 shared, vocab 163840), f32, 4 x 512, at ``R29M_LAYOUTS``
    (expert parallelism: ep ('x', 'y') at (2,2,2), ('dp', 'x', 'y') at
    dp2 x (2,2,1)), held the same way to its one-rank run, no choice
    dropped on one rank or on any rank; its all-to-all bytes a rank
    printed."""
    cfg = r29_cfg()
    ref = ROOT / "build" / "chip_smoke_ranks" / "ref29.pt"
    one, _ = one_rank_grads(dev, cfg, ref)
    moe_ref = ROOT / "build" / "chip_smoke_ranks" / "ref29m.pt"
    one_moe, one_drops = one_rank_grads(dev, r29m_cfg(), moe_ref)
    check(one_drops and not any(d for _, d in one_drops),
          f"29 moe: one rank dropped choices {one_drops}")
    out = {}
    # the layouts, and (2,2,2) and pp2 again with the islands chunked, in
    # one world of 8 ranks
    layouts = {**RANK_LAYOUTS, **PP_LAYOUTS}
    layouts.update({o: layouts[b] for o, b in OVERLAP_LAYOUTS.items()})
    t = time.perf_counter()
    world = run_rank_job({"kind": "grads", "layout": "_".join(layouts),
                          "layouts": list(layouts),
                          "moe_layouts": list(R29M_LAYOUTS),
                          "device": RANK_DEVICE, "ref": str(ref),
                          "moe_ref": str(moe_ref)})
    print(f"[29] one world of {RANKS} ranks for the {len(layouts)} "
          f"layouts and Moonlight's {len(R29M_LAYOUTS)}: "
          f"{time.perf_counter() - t:.1f} s")
    for lname, spec in layouts.items():
        res = [r[lname] for r in world]
        wall = res[0]["wall_s"]
        worst = max(max(r["errs"].values()) for r in res)
        dl = max(abs(r["loss"] - r["ref_loss"]) for r in res)
        split = spec[2][2] > 1      # 'z' splits the hidden dim
        print(f"[29] {lname} ({RANKS} ranks on one card, gloo through the "
              f"host) f32 2-layer tinyllama {R29_B}x{R29_S}: loss "
              f"{res[0]['loss']:.6f} against one rank's {one:.6f} (worst "
              f"rank {dl:.2e}, tol 1e-4); worst gradient shard error "
              f"{worst:.2e} of its leaf's max over {len(res[0]['errs'])} "
              f"leaves x {RANKS} ranks (tol 1e-4); rank 0's launches "
              f"{res[0]['launches']}; bytes by kind, rank 0 "
              f"{res[0]['bytes']['by_kind']}, rank {RANKS - 1} "
              f"{res[-1]['bytes']['by_kind']}; {wall:.1f} s")
        check(dl <= 1e-4, f"29 {lname}: loss {dl}")
        check(worst <= 1e-4, f"29 {lname}: gradient shards {worst}")
        for r, rr in enumerate(res):
            la = rr["launches"]
            norms = (la["K3 moments"] if split else la["K3"])
            check(la["K1"] > 0 and la["K2"] > 0 and la["K2 bwd"] > 0
                  and norms > 0, f"29 {lname} rank {r}: launches {la}")
        out[lname] = {"loss_err": dl, "grad_err": worst, "wall_s": wall,
                      "bytes_by_kind_rank0": res[0]["bytes"]["by_kind"]}
    for lname in R29M_LAYOUTS:
        res = [r[f"moe_{lname}"] for r in world]
        worst = max(max(r["errs"].values()) for r in res)
        dl = max(abs(r["loss"] - r["ref_loss"]) for r in res)
        a2a = [r["bytes"]["by_kind"]["all-to-all"] for r in res]
        print(f"[29] moe {lname} f32 Moonlight [dense, moe] (64 experts of "
              f"1408, capacity factor {R29M_CF}) {R29_B}x{R29_S}: loss "
              f"{res[0]['loss']:.6f} against one rank's {one_moe:.6f} "
              f"(worst rank {dl:.2e}, tol 1e-4); worst gradient shard "
              f"error {worst:.2e} of its leaf's max over "
              f"{len(res[0]['errs'])} leaves x {RANKS} ranks (tol 1e-4); "
              f"(routed, dropped) choices per rank "
              f"{[tuple(r['drops']) for r in res]}, one rank's "
              f"{one_drops}; all-to-all bytes a rank "
              f"{min(a2a):.6g}-{max(a2a):.6g}; bytes by kind, rank 0 "
              f"{res[0]['bytes']['by_kind']}; rank 0's launches "
              f"{res[0]['launches']}; {res[0]['wall_s']:.1f} s")
        check(dl <= 1e-4, f"29 moe {lname}: loss {dl}")
        check(worst <= 1e-4, f"29 moe {lname}: gradient shards {worst}")
        check(all(r["drops"][0] > 0 and r["drops"][1] == 0 for r in res),
              f"29 moe {lname}: drops {[r['drops'] for r in res]}")
        check(min(a2a) > 0, f"29 moe {lname}: all-to-all bytes {a2a}")
        for r, rr in enumerate(res):
            la = rr["launches"]
            check(la["K1"] > 0 and la["K2"] > 0 and la["K2 bwd"] > 0
                  and la["K3 moments" if lname == "cube" else "K3"] > 0,
                  f"29 moe {lname} rank {r}: launches {la}")
        out[f"moe_{lname}"] = {
            "loss_err": dl, "grad_err": worst, "wall_s": res[0]["wall_s"],
            "drops_by_rank": [r["drops"] for r in res],
            "all_to_all_bytes_by_rank": a2a,
            "bytes_by_kind_rank0": res[0]["bytes"]["by_kind"]}
    return out


def rank_train(job, me):
    """Phase 30's rank: ``repro_torch.launch.train`` as this rank (its
    environment names it) once for each argv of ``job["argvs"]``, in the
    one world this job joins (the launcher keeps a world it did not
    join), the launch counters reset just before each run and read just
    after, with the MoE choices routed and dropped counted and the bytes
    its parameters took on the card (``param_alloc``); a run flagged in
    ``job["profile"]`` runs under torch.profiler and adds its last step's
    ``step_split``.  A list of the runs' results."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.launch import ranks, train
    ranks.init_world(me, job["backend"], ranks.device_for(me, job["device"]))
    from torch.profiler import ProfilerActivity, profile
    out = []
    flags = job.get("profile") or [False] * len(job["argvs"])
    for argv, prof_on in zip(job["argvs"], flags):
        reset_launches()
        comm.reset_bytes()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if prof_on
              else contextlib.nullcontext()) as prof, \
                param_alloc() as alloc:
            res, drops = routed_and_dropped(lambda: train.main(argv))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        split = {"profile": step_split(prof)} if prof_on else {}
        out.append({**split,
                    "drops": [sum(d[0] for d in drops),
                              sum(d[1] for d in drops)],
                    "launches": dict(read_launches(), **read_split_launches()),
                    "k1_routes": dict(k1.launches_by_route),
                    "k2_routes": dict(k2.launches_by_route),
                    "k2_bwd_routes": dict(k2.launches_bwd_by_route),
                    "bytes": comm.bytes_moved(),
                    "param_alloc": alloc[0] if alloc else None,
                    "losses": res["losses"], "telemetry": res["telemetry"]})
    dist.destroy_process_group()
    return out


def largest_divisor(n, most):
    """The largest divisor of ``n`` that is at most ``most`` (the chunks
    of an island whose local contraction dim is ``n``)."""
    return max(k for k in range(1, min(n, most) + 1) if n % k == 0)


def chunked_k1(lay, layers, head, chunks):
    """K1 launches of one tinyllama step (forward and its remat
    recompute) at ``layers`` deep on a 3-D layout whose islands each run
    K1 once a chunk of their local contraction dim: wq, wk, wv, w_up and
    w_gate contract the hidden dim split over 'z', wo the heads' and
    w_down the MLP's split over 'y', the head's 2 loss chunks the hidden
    dim."""
    y, z = lay.size("y"), lay.size("z")
    ks = [D // z] * 5 + [NQ * DH // y, FF // y]
    return (2 * layers * sum(largest_divisor(k, chunks) for k in ks)
            + 2 * 2 * int(head) * largest_divisor(D // z, chunks))


def rank_train_launches(lname, layouts=None, layers=LAYERS,
                        steps=RANK_STEPS, rank=0, chunks=1,
                        arch="tinyllama-1.1b"):
    """Rank ``rank``'s launches in phase 30's (33's, 37's) run:
    tinyllama's step at ``layers`` deep as one rank runs it
    (``step_launches``; Moonlight's [dense, moe] cut, ``moon_launches``,
    for ``arch`` MOON), at pp > 1 its stage's layers (the head and
    ``ln_f`` on the last stage) once a microbatch; its norms in K3's two
    phases where the hidden dim is split (over out_ax, 'z', at 3d; 'z' at
    2d; never at 1d); with the islands in ``chunks`` chunks
    (``--overlap``) K1 once a chunk (``chunked_k1``)."""
    from repro_torch.core.linear3d import act_axes
    from repro_torch.core.topology import entry_dirs
    lay = rank_layout(lname, rank, layouts)
    pp = lay.size("pp")
    n, head, mb = layers, True, 1
    if pp > 1:
        lo, hi = lay.stage_bounds(layers)[lay.index("pp")]
        n, head, mb = hi - lo, lay.index("pp") == pp - 1, lay.microbatches
    one = moon_launches if arch == MOON else step_launches
    per = {k: v * mb for k, v in one(n, head).items()}
    if chunks > 1:
        per["K1"] = mb * chunked_k1(lay, n, head, chunks)
    fwd, bwd = per["K3"], per["K3 bwd"]
    split = lay.size(act_axes(lay, entry_dirs())[1]) > 1
    per.update({"K3": 0 if split else fwd, "K3 bwd": 0 if split else bwd,
                "K3 moments": fwd if split else 0,
                "K3 apply": fwd if split else 0,
                "K3 bwd dot": bwd if split else 0,
                "K3 bwd apply": bwd if split else 0,
                "K4": 0, "K4 combine": 0})
    return {k: steps * n for k, n in per.items()}


# one launcher run of the rank phases 30, 33 and 37: its name in the
# results, its layout (a key of ``layouts``), the phase's tag, the limit
# of its later losses (None: finite only), its steps and its islands'
# chunks (1: plain; else ``OVERLAP_ARGV``), whether it runs under
# torch.profiler (``step_split``), its arch, and the one-rank losses it
# is held to (None: ``phase_ranks_train``'s)
RankRun = collections.namedtuple(
    "RankRun",
    "name lname layouts tag later_tol steps chunks profile arch ref",
    defaults=(False, "tinyllama-1.1b", None))


def rank_runs(layouts, tag="30", later_tol=3e-2, steps=RANK_STEPS,
              overlap=(), arch="tinyllama-1.1b", ref=None, prefix=""):
    """The ``RankRun``s of ``layouts`` for ``arch`` (named ``prefix`` +
    the layout), each layout named in ``overlap`` followed by its run with
    the islands in ``OVERLAP_CHUNKS`` chunks, named "overlap"."""
    runs = []
    for lname in layouts:
        runs.append(RankRun(prefix + lname, lname, layouts, tag, later_tol,
                            steps, 1, False, arch, ref))
        if lname in overlap:
            runs.append(RankRun("overlap", lname, layouts, tag, later_tol,
                                steps, OVERLAP_CHUNKS, False, arch, ref))
    return runs


def phase_ranks_train(card, one_rank_losses, runs, nranks=RANKS,
                      backend="gloo", layers=0):
    """30, 33, 37: tinyllama-1.1b (or a run's ``arch``: 30's Moonlight
    [dense, moe] at (2,2,2), expert parallelism) at full width in bf16
    (cut to ``layers`` deep, 0: full depth), 4 x 2048, remat, AdamW,
    through ``repro_torch.launch.train`` under torchrun, each of ``runs``
    in turn in one world of ``nranks`` ranks over ``backend`` (30: (2,2,2),
    again with the islands chunked, and dp2 x (2,2,1); 37: pp2 x (1,2,2);
    33: 1d(4) and 2d(q2)), against the one-rank run of the same depth
    (``one_rank_losses``, or the run's ``ref``; the same seed, data and lr
    at these steps): the first loss within 3e-2
    (tests/test_multidev.py:92), the later ones within the run's
    ``later_tol`` (None: finite only, as the 2-D baseline's gradients
    carry ROADMAP Queue 3 fault 6), each rank's K1/K2/K3 launches exact
    (K1 once a chunk in a chunked run), every K1 and K2 launch on the tc
    route; each rank's step time, tokens/s, peak memory and collective
    bytes a step (``comm.bytes_moved``) and the MoE choices dropped.  The
    results by run name."""
    where = (f"{nranks} ranks sharing {card} (gloo, collectives staged "
             "through the host: no measure of the paper's communication)"
             if backend == "gloo" else
             f"{nranks} ranks, one a card, over {backend}")

    def argv(run):
        tel = ROOT / "build" / f"chip_smoke_ranks_{run.name}_telemetry.json"
        return (["--arch", run.arch, "--device", RANK_DEVICE,
                 "--backend", backend, *rank_flags(run.lname, run.layouts),
                 "--steps", str(run.steps), "--batch", str(TRAIN_B),
                 "--seq", str(TRAIN_S), "--lr", "3e-4", "--warmup", "20",
                 "--log-every", "1", "--telemetry", str(tel)]
                + (["--layers", str(layers)] if layers else [])
                + (OVERLAP_ARGV if run.chunks > 1 else [])
                + (["--trace", str(tel.with_suffix(".trace.json"))]
                   if run.profile else []))
    t = time.perf_counter()
    world = run_rank_job({"kind": "train",
                          "layout": "_".join(r.name for r in runs),
                          "argvs": [argv(r) for r in runs],
                          "profile": [r.profile for r in runs],
                          "backend": backend, "device": RANK_DEVICE},
                         torchrun=RANK_DEVICE == "cuda", nranks=nranks)
    wall = time.perf_counter() - t
    print(f"[30] one world of {nranks} ranks for the launcher's "
          f"{len(runs)} runs: {wall:.1f} s")
    return {run.name: ranks_train_run(
        [w[i] for w in world], run, layers,
        one_rank_losses if run.ref is None else run.ref, where)
        for i, run in enumerate(runs)}


def ranks_train_run(res, run, layers, one_rank_losses, where):
    """Phase 30's (33's, 37's) checks and numbers of one launcher run
    (``run``, a ``RankRun``) on the ranks (``res``: each rank's
    result); a run of one step reports that step's time, its warm-up."""
    lname, layouts, steps, chunks = run.lname, run.layouts, run.steps, \
        run.chunks
    later_tol, tag = run.later_tol, f"{run.tag} {run.name}"
    losses = res[0]["losses"]
    ref = one_rank_losses[:steps]
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    for r, rr in enumerate(res):
        want = rank_train_launches(lname, layouts, layers or LAYERS, steps,
                                   rank=r, chunks=chunks, arch=run.arch)
        check(rr["losses"] == losses, f"{tag}: rank {r} losses "
              f"{rr['losses']} != rank 0's {losses}")
        check(rr["launches"] == want, f"{tag} rank {r}: "
              f"launches {rr['launches']} != {want}")
        check(rr["k1_routes"]["tc"] == want["K1"]
              and rr["k2_routes"]["tc"] == want["K2"]
              and rr["k2_bwd_routes"]["tc"] == want["K2 bwd"],
              f"{tag} rank {r}: routes {rr['k1_routes']} "
              f"{rr['k2_routes']} {rr['k2_bwd_routes']}")
    tels = [rr["telemetry"] for rr in res]
    mem = [tl["mem_peak_bytes"] / 2 ** 30 for tl in tels]
    step_bytes = [rr["bytes"]["bytes_per_device"] / steps for rr in res]
    by_kind = [{k: v / steps for k, v in rr["bytes"]["by_kind"].items()
                if v} for rr in res]
    # one step is the warm-up alone: its time stands for the step's
    t_rank = [tl["t_step_s"] if steps > 1 else tl["series"]["t_step"][0]
              for tl in tels]
    print(f"[{tag}]: per rank, "
          + ("steady s/step " if steps > 1 else "s for the one step ")
          + " ".join(f"{t:.3f}" for t in t_rank)
          + "; bytes a step by kind "
          + "; ".join(f"rank {r} " + ", ".join(
              f"{k} {v:.4g}" for k, v in bk.items())
              for r, bk in enumerate(by_kind)))
    depth = f"cut to {layers} layers" if layers else "full depth"
    chunked = (f", each 3-D island in {chunks} chunks (--overlap)"
               if chunks > 1 else "")
    drops = [rr["drops"] for rr in res]
    if any(routed for routed, _ in drops):
        print(f"[{tag}]: (routed, dropped) MoE choices per rank over "
              f"{steps} steps " + " ".join(f"{a}/{b}" for a, b in drops)
              + " (" + " ".join(f"{b / a:.4f}" for a, b in drops)
              + " dropped)")
    print(f"[{tag}]: {run.arch} full width, {depth}, bf16 "
          f"{TRAIN_B}x{TRAIN_S}, remat, AdamW{chunked} on {where}: losses "
          + " ".join(f"{x:.4f}" for x in losses) + " against one "
          "rank's " + " ".join(f"{x:.4f}" for x in ref)
          + f" (first {diffs[0]:.2e}, tol 3e-2; "
          + ("no later step" if steps == 1 else "later " + (
              " ".join(f"{x:.2e}" for x in diffs[1:]) + f", tol "
              f"{later_tol:.0e}" if later_tol else "finite only"))
          + "); rank 0's step times "
          + " ".join(f"{x:.3f}" for x in tels[0]["series"]["t_step"])
          + " s (first = warm-up)"
          + (f", steady {tels[0]['t_step_s']:.3f} s/step, "
             f"{tels[0]['tokens_per_s']:.0f} tok/s" if steps > 1 else "")
          + "; peak memory "
          f"per rank " + " ".join(f"{x:.2f}" for x in mem)
          + " GiB; collective bytes a rank a step (ring model, "
          f"comm.bytes_moved) {min(step_bytes):.4g}-{max(step_bytes):.4g}"
          f" ({res[0]['bytes']['counts']} started by rank 0 in "
          f"{steps} steps); launches per rank {res[0]['launches']}")
    prof = [rr["profile"] for rr in res if "profile" in rr]
    if prof:
        print(f"[{tag}]: the last step under torch.profiler, per rank: wall "
              + " ".join(f"{p['wall_ms']:.1f}" for p in prof)
              + " ms, compute kernels' union "
              + " ".join(f"{p['busy_ms']:.1f}" for p in prof)
              + " ms, collectives outside it "
              + " ".join(f"{p['exposed_comm_ms']:.1f}" for p in prof)
              + " ms; rank 0 by group (ms, kernels) " + ", ".join(
                  f"{g} {v['ms']:.1f} ({v['kernels']})"
                  for g, v in prof[0]["groups"].items())
              + "; largest in other " + ", ".join(
                  f"{n} {ms:.1f}" for n, ms in prof[0]["other_top"].items()))
    check(all(map(math.isfinite, losses)), f"{tag}: {losses}")
    check(diffs[0] <= 3e-2, f"{tag}: first loss {losses} vs {ref}")
    if later_tol:
        check(max(diffs) <= later_tol, f"{tag}: losses {losses} vs {ref}")
    return {"losses": losses, "one_rank_losses": ref,
            "layers": layers or LAYERS, "chunks": chunks,
            "t_step_s": t_rank[0],
            "t_step": tels[0]["series"]["t_step"],
            "tokens_per_s": tels[0]["tokens_per_s"],
            "mem_peak_gib_by_rank": mem,
            "bytes_per_rank_step": max(step_bytes),
            "bytes_by_kind_per_rank_step": by_kind,
            "counts_by_kind_per_rank_step": [
                {k: v / steps for k, v in rr["bytes"]["counts"].items()
                 if v} for rr in res],
            "param_alloc_by_rank": [rr["param_alloc"] for rr in res],
            "t_step_s_by_rank": t_rank,
            "launches_per_rank": res[0]["launches"],
            "drops_by_rank": drops if any(a for a, _ in drops) else None,
            "profile_by_rank": prof or None,
            "launches_world": {k: sum(rr["launches"][k] for rr in res)
                               for k in res[0]["launches"]}}


# K2 at a 1d(4) rank's attention (phase 5b): 2 x 2048 rows of 8 of the 32
# q heads over the one kv head of 4 that is the rank's, no offset (the
# 2d(q2) rank's shape is 5c's (2,2,2) one: 2 x 1024 rows at both offsets)
K2_BASE_SHAPES = [("tinyllama 1d rank", TRAIN_B // 2, TRAIN_S, TRAIN_S, 0,
                   NQ // 4, NKV // 4, DH)]
# the comm check at the reference's defaults (obs/commcheck.py): paper-
# transformer, d_ff = d_model, vocab 4096, 12 x 512, bf16, but 2 layers
# of the defaults' 4: the script's time limit binds
CC_ARGS = dict(arch="paper-transformer", n_layers=2, d_ff=0, vocab=4096,
               reduced=False, changes=None)
CC_BATCH, CC_SEQ = 12, 512


def phase_k3_base(dev):
    """4b: K3 in one phase at a 1d(4) rank's norm, whole rows of 2048 for
    the rank's 2 x 2048 tokens (the 2d(q2) rank's two phases are 4c's),
    against the plain version, then timed as phase 4 times it."""
    import torch
    from repro_torch.kernels import rmsnorm as k3
    gen = torch.Generator(device=dev).manual_seed(37)
    m = TRAIN_B // 2 * TRAIN_S
    (x, g, dy), rstd, worst, norms = k3_case(k3, dev, gen, m, D,
                                             torch.bfloat16, False, "[4b]")
    return {f"{m}x{D}": k3_times(k3, x, g, dy, rstd, norms, worst, "4b")}


def rank_base(job, me):
    """Phase 31's rank: the f32 two-layer model's loss and gradient shards
    at 1d(4) and 2d(q2) (the train step's leaf sync included), launches
    and collective bytes counted; 1d's shards held to the one-rank run's
    blocks, 2d's to the same layout's run on the CPU in the same world
    (the plain versions); then the comm check's 8-rank plans (1d, 3d) at
    the reference's defaults."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.params import (init_params, shard, tree_leaves,
                                         tree_map)
    from repro_torch.core.topology import make_layout
    from repro_torch.data.pipeline import shard_batch, to_device
    from repro_torch.launch import ranks
    from repro_torch.models import transformer
    from repro_torch.obs import commcheck
    from repro_torch.train.step import loss_and_grads
    dev = ranks.device_for(me, job["device"])
    ranks.init_world(me, "gloo", dev)
    torch.set_num_threads(1)
    cfg = r29_cfg()
    ref = torch.load(job["ref"], mmap=True)
    out = {}
    for lname in BASE_LAYOUTS:
        lay = comm.init(rank_layout(lname, me.rank, BASE_LAYOUTS), "gloo")
        abstract = transformer.abstract_params(cfg, lay)
        params = init_params(abstract, torch.Generator(
            device=dev).manual_seed(R29_SEED), dev, torch.float32, layout=lay)
        host = shard_batch(r29_batch(cfg.vocab), lay)
        reset_launches()
        comm.reset_bytes()
        loss, _, grads = loss_and_grads(cfg, lay, params,
                                        to_device(host, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        res = {"loss": loss.item(), "ref_loss": ref["loss"],
               "launches": dict(read_launches(), **read_split_launches()),
               "bytes": comm.bytes_moved()}
        names = ["/".join(p) for p in _paths(params)]
        if lname == "1d":
            res["errs"] = {n: leaf_err(g, shard(ref["grads"][n], p.spec,
                                                lay).to(dev))
                           for n, g, p in zip(names, grads,
                                              tree_leaves(abstract))}
        else:
            cpu_loss, _, cpu_grads = loss_and_grads(
                cfg, lay, tree_map(lambda t: t.cpu(), params),
                to_device(host, "cpu"))
            res["cpu_loss"] = cpu_loss.item()
            res["errs"] = {n: leaf_err(g.cpu(), c)
                           for n, g, c in zip(names, grads, cpu_grads)}
        out[lname] = res
        del params, grads
    ccfg = commcheck.plan_config(**CC_ARGS)
    for strat in ("1d", "3d"):
        lay = comm.init(make_layout(1, 1, RANKS, strat, rank=me.rank), "gloo")
        out["cc_" + strat] = dict(commcheck.measure(ccfg, lay, CC_BATCH,
                                                    CC_SEQ, dev),
                                  cube=list(lay.cube))
    dist.destroy_process_group()
    return out


def phase_base_grads(dev):
    """31: the paper's baselines on 8 ranks sharing the card over gloo:
    tinyllama-1.1b cut to 2 layers at full width, f32, 4 x 512 (phase
    29's model, data and one-rank gradients), one forward and backward at
    1d(4) and 2d(q2): the loss within 1e-4 of one rank's at both; every
    gradient shard within 1e-4 of its leaf's max against one rank's at
    1d, and at 2d against the same layout on the CPU ranks of this
    machine (the plain versions), since neither package's 2-D gradient is
    one rank's (ROADMAP.md Queue 3, fault 6); K1, K2 and K3 (two phases
    at 2d) launched on every rank.  32: the comm check at the reference's
    defaults: the 1d and 3d plans of 8 ranks measured in 31's world, the
    2d plan of 4 ranks under torchrun (``commcheck.check``); measured and
    analytic bytes per plan, and the measured ordering 3d < 2d < 1d."""
    from repro_torch.obs import commcheck
    ref = ROOT / "build" / "chip_smoke_ranks" / "ref29.pt"
    t = time.perf_counter()
    res = run_rank_job({"kind": "base", "layout": "1d_2d",
                        "device": RANK_DEVICE, "ref": str(ref)})
    wall = time.perf_counter() - t
    out = {}
    for lname in BASE_LAYOUTS:
        rs = [r[lname] for r in res]
        worst = max(max(r["errs"].values()) for r in rs)
        dl = max(abs(r["loss"] - r["ref_loss"]) for r in rs)
        split = lname == "2d"
        against = ("one rank's" if lname == "1d" else
                   "the same layout's on the CPU ranks (plain versions)")
        print(f"[31] {lname} ({RANKS} ranks on one card, gloo through the "
              f"host) f32 2-layer tinyllama {R29_B}x{R29_S}: loss "
              f"{rs[0]['loss']:.6f} against one rank's "
              f"{rs[0]['ref_loss']:.6f} (worst rank {dl:.2e}, tol 1e-4)"
              + (f", the CPU ranks' {rs[0]['cpu_loss']:.6f}" if split
                 else "")
              + f"; worst gradient shard error {worst:.2e} of its leaf's "
              f"max against {against} over {len(rs[0]['errs'])} leaves x "
              f"{RANKS} ranks (tol 1e-4); rank 0's launches "
              f"{rs[0]['launches']}; its collective bytes (ring model) "
              f"{rs[0]['bytes']['bytes_per_device']:.4g} "
              f"{rs[0]['bytes']['counts']}")
        check(dl <= 1e-4, f"31 {lname}: loss {dl}")
        check(worst <= 1e-4, f"31 {lname}: gradient shards {worst}")
        for r, rr in enumerate(rs):
            la = rr["launches"]
            norms = la["K3 moments"] if split else la["K3"]
            check(la["K1"] > 0 and la["K2"] > 0 and la["K2 bwd"] > 0
                  and norms > 0, f"31 {lname} rank {r}: launches {la}")
        out[lname] = {"loss_err": dl, "grad_err": worst}
    out["wall_s"] = wall
    cfg = commcheck.plan_config(**CC_ARGS)
    plans = {}
    for strat in ("1d", "3d"):
        top = max(range(RANKS),
                  key=lambda r: res[r]["cc_" + strat]["bytes_per_device"])
        plans[strat] = commcheck.plan_report(
            cfg, strat, dict(res[top]["cc_" + strat], rank=top,
                             n_model=RANKS), CC_BATCH, CC_SEQ)
    t = time.perf_counter()
    two = commcheck.check(
        CC_ARGS["arch"], CC_BATCH, CC_SEQ, CC_ARGS["n_layers"],
        CC_ARGS["d_ff"], CC_ARGS["vocab"], {"2d": commcheck.PLANS["2d"]},
        device=RANK_DEVICE, host_devices=commcheck.PLANS["2d"],
        reduced=CC_ARGS["reduced"], changes=CC_ARGS["changes"])
    plans["2d"] = two["plans"]["2d"]
    rep = commcheck.report(cfg, CC_BATCH, CC_SEQ, RANK_DEVICE, plans)
    print("[32] " + commcheck.format_report(rep).replace("\n", "\n[32] ")
          + f" ({time.perf_counter() - t:.1f} s for the 2d plan's world)")
    check(rep["ordering_measured_3d_2d_1d"],
          f"32: measured ordering violated {plans}")
    out["commcheck"] = rep
    return out


# phases 34-36: the optimizer state over dp (ZeRO 1/2), checkpoints across
# layouts, Adafactor.  34 trains phase 30's dp2 x (2,2,1) layout at each
# ZeRO stage in one world of 8 ranks: tinyllama-1.1b at full width cut to
# RANK_TRAIN_LAYERS, ZERO_B x TRAIN_S, ZERO_MB microbatches, ZERO_STEPS
# steps; 35 saves its stage-1 state and restores it at ZERO_DP4 (8 ranks)
# and on one rank; 36 trains under Adafactor on one card
ZERO_DP4 = (4, 2, (1, 1, 2))
# the launcher's resume above one device: dp 4 on 4 ranks, the model whole
ZERO_RESUME = (4, 1, (1, 1, 1))
# 8 rows: one a rank and microbatch at dp2 x (2,2,1)
# one step a stage: the script's time limit binds
ZERO_B, ZERO_MB, ZERO_STEPS = 8, 2, 1
ZERO_RATIO = (1.6, 2.2)          # stage 0's moment bytes over stage 1's
ADA_MIX_LAYERS, ADA_MIX_STEPS = 4, 3
# phase 38: the dry run's flags, its time limit, the archs whose trace at
# the production layout must be OK, and the memory model's tolerance
DRY_ARGV = ["--arch", "all", "--shape", "train_4k"]
DRY_TIMEOUT_S = 900
DRY_TRACED = ("gemma-2b", "qwen3-4b", "tinyllama-1.1b", "mixtral-8x7b",
              "moonshot-v1-16b-a3b")
DRY_TOL = 0.01


def mix_launches(layers):
    """One mixtral training step's launches at ``layers`` deep, as
    MIX_LAUNCHES counts them."""
    return {"K1": 2 * 4 * layers + 2 * 2, "K2": 2 * layers,
            "K2 bwd": layers, "K3": 2 * 2 * layers + 1,
            "K3 bwd": 2 * layers + 1, "K5": 0, "K5 bwd": 0}


def moon_launches(layers, head=True):
    """One training step's launches of Moonlight cut to ``layers`` of
    [dense, moe] at 4 x 2048 (``head=False``: without ``ln_f`` and the
    head), as phase 20 counts them: 7 K1 linears a layer (the attention's
    4 and the dense MLP's or the shared experts' 3) and the head's 4 loss
    chunks (163840 // 32000 = 5 cut to the 4 that divide the sequence)
    twice, forward and recompute; K2 twice forward and once backward; K3
    the 2 norms of each layer twice and ln_f once, backward once each."""
    h = int(head)
    return {"K1": 2 * 7 * layers + 2 * 4 * h, "K2": 2 * layers,
            "K2 bwd": layers, "K3": 2 * 2 * layers + h,
            "K3 bwd": 2 * layers + h, "K5": 0, "K5 bwd": 0}


def zero_cfg():
    from repro_torch.configs.registry import get
    return dataclasses.replace(get("tinyllama-1.1b"),
                               n_layers=RANK_TRAIN_LAYERS)


def held_to_files(ckpt, step, params, state, abstract, opt_abstract, lay):
    """Whether every leaf of a rank's ``params`` and optimizer ``state``
    is bit for bit its block, under its spec in ``lay``, of the global
    ``.npy`` the checkpoint holds (read through a memory map); the names
    of the leaves that differ."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.core.params import shard
    d = Path(ckpt) / f"step_{step:08d}"
    index = json.loads((d / "index.json").read_text())["leaves"]
    ints = {2: torch.int16, 4: torch.int32}

    def walk(tree, specs, key):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], specs[k], f"{key}/{k}")
        else:
            yield key, tree, specs
    leaves = [*walk(params, abstract, "params"),
              *walk(state.m or {}, opt_abstract.m or {}, "opt/.m"),
              *walk(state.v, opt_abstract.v, "opt/.v")]
    bad = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a read-only memory map
        for key, t, p in leaves:
            entry = index[key]
            arr = np.load(d / entry["file"], mmap_mode="r")
            if entry["dtype"] == "bfloat16":
                g = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                g = torch.from_numpy(arr)
            want = shard(g, p.spec, lay)
            got = t.detach().cpu()
            if got.dtype != want.dtype or not torch.equal(
                    got.view(ints[got.element_size()]),
                    want.view(ints[want.element_size()])):
                bad.append(key)
    return bad


def rank_zero(job, me):
    """Phases 34 and 35's rank: the ZeRO stages in turn, each from seed 0
    on the same data (the launch counters reset just before a stage's
    steps and read just after); the stage-1 state saved (every rank's
    shards then held to the files) and one more step on the first batch
    of a fresh stream (what a resumed launcher trains on); then the
    checkpoint restored at ZERO_DP4 and held to the files."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import store
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.core import comm
    from repro_torch.core.params import (init_params, sharded_bytes,
                                         tree_leaves)
    from repro_torch.core.topology import make_layout
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.launch import ranks
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    from repro_torch.optim.optimizers import opt_state_abstract
    from repro_torch.train.step import make_train_step
    dev = ranks.device_for(me, job["device"])
    ranks.init_world(me, "gloo", dev)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg = zero_cfg()
    opt = OptimConfig(lr=3e-4, warmup=20, total_steps=ZERO_STEPS + 1)
    shape = ShapeConfig("smoke", TRAIN_S, ZERO_B, "train")

    def layout(n_dp, n_model, cube, stage, mb=1):
        return comm.init(make_layout(1, n_dp, n_model, "3d", cube,
                                     rank=me.rank, zero_stage=stage,
                                     microbatches=mb), "gloo")

    def stream(lay):
        return TokenStream(cfg, shape, DataConfig(seed=0), dev, layout=lay)
    out = {}
    # one set of process groups for the three stages
    dp2 = layout(*RANK_LAYOUTS["dp2"], 0, ZERO_MB)
    for stage in (0, 1, 2):
        lay = dataclasses.replace(dp2, zero_stage=stage)
        abstract = transformer.abstract_params(cfg, lay)
        params = init_params(abstract, torch.Generator(
            device=dev).manual_seed(0), dev, torch.bfloat16, layout=lay)
        state = adamw_init(params, lay, abstract, opt)
        step = make_train_step(cfg, lay, opt)
        data = stream(lay)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        res = {"losses": [], "gnorms": [], "t_step": []}
        for _ in range(ZERO_STEPS):
            batch = next(data)
            sync()
            t = time.perf_counter()
            params, state, met = step(params, state, batch)
            res["losses"].append(float(met["loss"]))
            res["gnorms"].append(float(met["gnorm"]))
            sync()
            res["t_step"].append(time.perf_counter() - t)
        res.update(
            launches=dict(read_launches(), **read_split_launches()),
            k1_routes=dict(k1.launches_by_route),
            k2_routes=dict(k2.launches_by_route),
            k2_bwd_routes=dict(k2.launches_bwd_by_route),
            moment_bytes=sum(t.nbytes for t in tree_leaves(state.m)
                             + tree_leaves(state.v)),
            # the f32 accumulation buffer: the moments' blocks at stage
            # 2, the parameter shards below it
            acc_bytes=sharded_bytes(opt_state_abstract(
                abstract, lay if stage >= 2 else
                dataclasses.replace(lay, zero_stage=0), opt).m, lay),
            param_bytes=sum(t.nbytes for t in tree_leaves(params)),
            mem_peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if cuda else None))
        if stage == 1:
            oab = opt_state_abstract(abstract, lay, opt)
            t = time.perf_counter()
            store.save(job["ckpt"], ZERO_STEPS, params, state, layout=lay,
                       abstract=abstract, opt_abstract=oab)
            res["save_s"] = time.perf_counter() - t
            res["saved_bad"] = held_to_files(job["ckpt"], ZERO_STEPS, params,
                                             state, abstract, oab, lay)
            _, _, met = step(params, state, next(stream(lay)))
            res["post_loss"] = float(met["loss"])
        out[f"zero{stage}"] = res
        del params, state, step, data
    lay4 = layout(*ZERO_DP4, 1)
    ab4 = transformer.abstract_params(cfg, lay4)
    oab4 = opt_state_abstract(ab4, lay4, opt)
    t = time.perf_counter()
    p4, o4, _ = store.restore(job["ckpt"], ZERO_STEPS, ab4, oab4, device=dev,
                              layout=lay4)
    out["restore_s"] = time.perf_counter() - t
    out["restored_step"] = o4.step
    out["restored_bad"] = held_to_files(job["ckpt"], ZERO_STEPS, p4, o4, ab4,
                                        oab4, lay4)
    dist.destroy_process_group()
    return out


def phase_zero(card, ckpt):
    """34: ZeRO 0, 1 and 2 at dp2 x (2,2,1) on 8 ranks sharing the card
    (``rank_zero``): the stages' losses and gnorms within 1e-2 of one
    another, every rank's launches exact (RANK_LAYOUTS' dp2 step, once a
    microbatch), stage 0's moment bytes over stage 1's within ZERO_RATIO
    on every rank, stage 2's f32 accumulation buffer (counted from its
    ZeRO specs) within ZERO_RATIO of stage 1's; peak memory and step
    time.  Then 35's
    first half: every rank's saved shards and its blocks restored at
    ZERO_DP4 bit for bit the checkpoint's files."""
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)
    t = time.perf_counter()
    res = run_rank_job({"kind": "zero", "layout": "dp2", "ckpt": str(ckpt),
                        "device": RANK_DEVICE},
                       torchrun=RANK_DEVICE == "cuda")
    wall = time.perf_counter() - t
    want = rank_train_launches("dp2", steps=ZERO_STEPS * ZERO_MB,
                               layers=RANK_TRAIN_LAYERS)
    stages = [f"zero{s}" for s in (0, 1, 2)]
    ref = res[0]["zero0"]
    for r, rr in enumerate(res):
        for s in stages:
            x = rr[s]
            check(x["launches"] == want, f"34 {s} rank {r}: launches "
                  f"{x['launches']} != {want}")
            check(x["k1_routes"]["tc"] == want["K1"]
                  and x["k2_routes"]["tc"] == want["K2"]
                  and x["k2_bwd_routes"]["tc"] == want["K2 bwd"],
                  f"34 {s} rank {r}: routes {x['k1_routes']} "
                  f"{x['k2_routes']} {x['k2_bwd_routes']}")
            check(all(map(math.isfinite, x["losses"])), f"34 {s}: "
                  f"{x['losses']}")
            check(max(abs(a - b) for a, b in zip(
                x["losses"] + x["gnorms"], ref["losses"] + ref["gnorms"]))
                  <= 1e-2, f"34 {s} rank {r}: losses {x['losses']} gnorms "
                  f"{x['gnorms']} against stage 0's {ref['losses']} "
                  f"{ref['gnorms']}")
        ratio = rr["zero0"]["moment_bytes"] / rr["zero1"]["moment_bytes"]
        check(ZERO_RATIO[0] <= ratio <= ZERO_RATIO[1], f"34 rank {r}: "
              f"moment bytes ratio {ratio:.3f}")
        check(rr["zero2"]["moment_bytes"] == rr["zero1"]["moment_bytes"],
              f"34 rank {r}: stage 2's moments {rr['zero2']['moment_bytes']}")
        acc = rr["zero1"]["acc_bytes"] / rr["zero2"]["acc_bytes"]
        check(ZERO_RATIO[0] <= acc <= ZERO_RATIO[1], f"34 rank {r}: "
              f"accumulation buffer ratio {acc:.3f}")
        check(not rr["zero1"]["saved_bad"], f"35 rank {r}: saved leaves "
              f"differ from the files: {rr['zero1']['saved_bad']}")
        check(not rr["restored_bad"] and rr["restored_step"] == ZERO_STEPS,
              f"35 rank {r}: restored at dp4, leaves {rr['restored_bad']} "
              f"differ (step {rr['restored_step']})")
    numbers = {}
    for s in stages:
        x = [rr[s] for rr in res]
        numbers[s] = {
            "losses": x[0]["losses"], "gnorms": x[0]["gnorms"],
            "t_step": x[0]["t_step"],
            "moment_gb_by_rank": [y["moment_bytes"] / 1e9 for y in x],
            "acc_gb_by_rank": [y["acc_bytes"] / 1e9 for y in x],
            "param_gb_by_rank": [y["param_bytes"] / 1e9 for y in x],
            "mem_peak_gib_by_rank": [y["mem_peak_gib"] for y in x],
            "launches_per_rank": x[0]["launches"]}
        print(f"[34] {s}: tinyllama-1.1b full width cut to "
              f"{RANK_TRAIN_LAYERS} layers, bf16 {ZERO_B}x{TRAIN_S}, "
              f"{ZERO_MB} microbatches, AdamW at dp2 x (2,2,1) on 8 ranks "
              f"sharing {card} (gloo): losses "
              + " ".join(f"{v:.4f}" for v in x[0]["losses"]) + ", gnorms "
              + " ".join(f"{v:.4f}" for v in x[0]["gnorms"])
              + "; step times " + " ".join(f"{v:.3f}" for v in
                                           x[0]["t_step"])
              + " s (rank 0; first = warm-up); per rank: moments "
              f"{min(y['moment_bytes'] for y in x) / 1e9:.4f}-"
              f"{max(y['moment_bytes'] for y in x) / 1e9:.4f} GB, f32 "
              f"accumulation {min(y['acc_bytes'] for y in x) / 1e9:.4f}-"
              f"{max(y['acc_bytes'] for y in x) / 1e9:.4f} GB, parameters "
              f"{x[0]['param_bytes'] / 1e9:.4f} GB, peak memory "
              + (" ".join(f"{y['mem_peak_gib']:.2f}" for y in x) + " GiB"
                 if x[0]["mem_peak_gib"] is not None else "not measured"))
    one = res[0]
    moments = [rr["zero0"]["moment_bytes"] / rr["zero1"]["moment_bytes"]
               for rr in res]
    acc = [rr["zero1"]["acc_bytes"] / rr["zero2"]["acc_bytes"] for rr in res]
    print("[34] stage 0 / stage 1 moment bytes a rank "
          + " ".join(f"{x:.3f}" for x in moments) + f" (limits {ZERO_RATIO});"
          " stage 1 / stage 2 accumulation " + " ".join(f"{x:.3f}" for x in
                                                        acc)
          + f"; {wall:.1f} s for the world")
    print(f"[35] stage 1 saved at step {ZERO_STEPS} in "
          f"{one['zero1']['save_s']:.1f} s (rank 0), every rank's shards "
          f"bit for bit the files; restored at dp4 x (1,1,2) in "
          f"{one['restore_s']:.1f} s, every leaf bit for bit; the next "
          f"step's loss at dp2 {one['zero1']['post_loss']:.4f}")
    numbers["save_s"] = one["zero1"]["save_s"]
    numbers["restore_dp4_s"] = one["restore_s"]
    numbers["post_loss_dp2"] = one["zero1"]["post_loss"]
    numbers["wall_s"] = wall
    return numbers


def phase_ckpt_layouts(card, ckpt, post_loss):
    """35: ``repro_torch.launch.train --ckpt-dir`` resumes phase 34's
    stage-1 checkpoint at ZERO_RESUME (dp 4, 4 ranks) and on one rank
    (each trains step ZERO_STEPS + 1 on its stream's first batch): both
    losses within 1e-2 of the dp2 world's next step; the ranks' launches
    exact (path train_ckpt_dp4); the one rank's restored leaves bit for
    bit the files.  The directory is removed afterwards."""
    import shutil
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import opt_state_abstract
    n_dp, n_model, cube = ZERO_RESUME
    nranks = n_dp * n_model
    argv = ["--arch", "tinyllama-1.1b", "--layers", str(RANK_TRAIN_LAYERS),
            "--steps", str(ZERO_STEPS + 1), "--batch", str(ZERO_B),
            "--seq", str(TRAIN_S), "--lr", "3e-4", "--warmup", "20",
            "--log-every", "1", "--ckpt-dir", str(ckpt)]
    t = time.perf_counter()
    res = run_rank_job({"kind": "train", "layout": "ckpt_dp4", "argvs": [[
        *argv, "--device", RANK_DEVICE, "--backend", "gloo", "--dp",
        str(n_dp), "--model", str(n_model), "--cube",
        ",".join(map(str, cube))]], "backend": "gloo",
        "device": RANK_DEVICE}, torchrun=RANK_DEVICE == "cuda",
        nranks=nranks)
    res = [r[0] for r in res]
    wall = time.perf_counter() - t
    want = rank_train_launches("dp4", {"dp4": ZERO_RESUME},
                               layers=RANK_TRAIN_LAYERS, steps=1)
    for r, rr in enumerate(res):
        check(rr["launches"] == want, f"35 dp4 rank {r}: launches "
              f"{rr['launches']} != {want}")
        check(rr["k1_routes"]["tc"] == want["K1"]
              and rr["k2_routes"]["tc"] == want["K2"]
              and rr["k2_bwd_routes"]["tc"] == want["K2 bwd"],
              f"35 dp4 rank {r}: routes {rr['k1_routes']} "
              f"{rr['k2_routes']} {rr['k2_bwd_routes']}")
    dp4_loss = res[0]["losses"]
    check(len(dp4_loss) == 1 and abs(dp4_loss[0] - post_loss) <= 1e-2,
          f"35 dp4: resumed loss {dp4_loss} against dp2's {post_loss}")
    reset_launches()
    t1 = time.perf_counter()
    one = train.main([*argv, "--device", RANK_DEVICE])
    if RANK_DEVICE == "cuda":
        torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    one_launches = dict(read_launches(), **read_split_launches())
    want1 = rank_train_launches("one", {"one": (1, 1, (1, 1, 1))},
                                layers=RANK_TRAIN_LAYERS, steps=1)
    check(one_launches == want1, f"35 one rank: launches {one_launches} "
          f"!= {want1}")
    check_k1_routes(one_launches, "35", "one-rank resume")
    check_k2_routes(one_launches, "35", "one-rank resume")
    check(one["start"] == ZERO_STEPS and len(one["losses"]) == 1
          and abs(one["losses"][0] - post_loss) <= 1e-2,
          f"35 one rank: resumed {one} against dp2's {post_loss}")
    cfg = zero_cfg()
    lay = ParallelPlan().validate().build()
    ab = transformer.abstract_params(cfg, lay)
    from repro_torch.config import OptimConfig
    oab = opt_state_abstract(ab, lay, OptimConfig())
    params, state, _ = store.restore(str(ckpt), ZERO_STEPS, ab, oab,
                                     device=RANK_DEVICE, layout=lay)
    bad = held_to_files(ckpt, ZERO_STEPS, params, state, ab, oab, lay)
    check(not bad, f"35 one rank: restored leaves {bad} differ")
    del params, state
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"[35] launch.train --ckpt-dir resumed step {ZERO_STEPS} at dp"
          f"{n_dp} x ({','.join(map(str, cube))}) on {nranks} ranks sharing "
          f"{card}: loss {dp4_loss[0]:.4f} in "
          f"{wall:.1f} s; on one rank: loss {one['losses'][0]:.4f} in "
          f"{one_s:.1f} s, its restored leaves bit for bit; against dp2's "
          f"{post_loss:.4f} (tol 1e-2)")
    return ({"dp4_loss": dp4_loss[0], "one_rank_loss": one["losses"][0],
             "dp4_wall_s": wall, "one_rank_s": one_s},
            {"train_ckpt_dp4": {k: nranks * n for k, n in
                                res[0]["launches"].items()},
             "train_ckpt_one": one_launches})


def optimizer_share(dev, name):
    """One tinyllama-1.1b training step (phase 8's) under ``name``'s
    optimizer, after one warm-up step, under torch.profiler: the step's
    wall time, the device span of the train step's "optimizer" range, and
    the state's bytes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get("tinyllama-1.1b")
    layout = ParallelPlan().validate(mode="train").build()
    abstract = transformer.abstract_params(cfg, layout)
    params = init_params(abstract, torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    opt = OptimConfig(name=name, lr=3e-4, warmup=20, total_steps=TRAIN_STEPS)
    state = adamw_init(params, layout, abstract, opt)
    step = make_train_step(cfg, layout, opt)
    data = TokenStream(cfg, ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train"),
                       DataConfig(seed=0), dev)
    params, state, _ = step(params, state, next(data))
    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(met["loss"].item()), f"36 {name}: loss")
    spans = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.name == "optimizer" and e.device_type == DeviceType.CUDA]
    leaves = (tree_leaves(state.m) if state.m is not None else []) + \
        tree_leaves(state.v)
    return {"wall_ms": wall_ms, "optimizer_ms": sum(spans) if spans else None,
            "state_gb": sum(t.nbytes for t in leaves) / 1e9}


def phase_adafactor(card, dev, adamw_tel):
    """36: Adafactor on one card through ``repro_torch.launch.train``:
    phase 8's run (tinyllama-1.1b, full depth, TRAIN_B x TRAIN_S,
    TRAIN_STEPS steps) beside its AdamW, step time, peak memory, the
    state's bytes and the optimizer's share of a profiled step; then
    mixtral-8x7b cut to ADA_MIX_LAYERS (the depth AdamW's moments cannot
    hold beside its weights), ADA_MIX_STEPS steps; launches exact."""
    import gc
    import torch
    launches, _, _, tel = phase_train(
        card, tag="36", cut=("--optimizer", "adafactor"))
    share = {n: optimizer_share(dev, n) for n in ("adamw", "adafactor")}
    for n, s in share.items():
        frac = (f"{s['optimizer_ms'] / s['wall_ms'] * 100:.1f}% of the step"
                if s["optimizer_ms"] is not None else "not measured")
        print(f"[36] tinyllama-1.1b {n}: one profiled step "
              f"{s['wall_ms']:.1f} ms, the optimizer range "
              + (f"{s['optimizer_ms']:.1f} ms on the device ({frac})"
                 if s["optimizer_ms"] is not None else "not measured")
              + f"; state {s['state_gb']:.4f} GB on {card}")
    print(f"[36] tinyllama-1.1b Adafactor against phase 8's AdamW: steady "
          f"{tel['t_step_s']:.3f} against {adamw_tel['t_step_s']:.3f} s a "
          f"step, peak {tel['mem_peak_bytes'] / 2 ** 30:.2f} against "
          f"{adamw_tel['mem_peak_bytes'] / 2 ** 30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    mix_l, _, _, mix_tel = phase_train(
        card, "mixtral-8x7b", ADA_MIX_STEPS, mix_launches(ADA_MIX_LAYERS),
        tag="36m", layers=ADA_MIX_LAYERS, cut=("--optimizer", "adafactor"))
    return ({"train_adafactor": train_numbers(tel, optimizer_share=share),
             "train_mixtral_adafactor": train_numbers(
                 mix_tel, layers=ADA_MIX_LAYERS)},
            {"train_adafactor": launches,
             "train_mixtral_adafactor": mix_l})


def train_numbers(tel, **more):
    """The numbers of a training run's telemetry that the JSON lines
    carry."""
    return dict(more, t_step_s=tel["t_step_s"],
                tokens_per_s=tel["tokens_per_s"], mfu=tel["mfu"],
                mem_peak_gib=tel["mem_peak_bytes"] / 2 ** 30,
                t_step=tel["series"]["t_step"], loss=tel["series"]["loss"])


@contextlib.contextmanager
def param_alloc():
    """A list of the bytes ``torch.cuda.memory_allocated`` grew by in each
    call of ``repro_torch.core.params.init_params`` made inside it on a
    card (the launcher builds its parameters through it); nothing for the
    CPU."""
    import torch
    from repro_torch.core import params
    real, got = params.init_params, []

    def wrapped(abstract, generator, device, *a, **k):
        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
        out = real(abstract, generator, device, *a, **k)
        if cuda:
            torch.cuda.synchronize(dev)
            got.append(torch.cuda.memory_allocated(dev) - before)
        return out
    params.init_params = wrapped
    try:
        yield got
    finally:
        params.init_params = real


def start_dryrun():
    """Phase 38's dry run started now in a subprocess on the CPU (no card
    visible, one thread), its output to ``build/chip_smoke_dryrun.log``;
    stopped at exit if it still runs.  (process, log file, path, start on
    the wall clock)."""
    import atexit
    import os
    path = ROOT / "build" / "chip_smoke_dryrun.log"
    path.parent.mkdir(parents=True, exist_ok=True)
    log = open(path, "w")
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRY_ARGV],
        cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return proc, log, path, time.time()


def run_layout(rr, rank=0):
    """Rank ``rank``'s Layout of a ``RankRun`` as the launcher builds it
    (``rank_layout``; its islands in ``rr.chunks`` chunks above 1)."""
    lay = rank_layout(rr.lname, rank, rr.layouts)
    if rr.chunks > 1:
        lay = dataclasses.replace(lay, overlap=True,
                                  overlap_chunks=rr.chunks)
    return lay


def phase_dryrun(run, train_runs, runs, zero_numbers, alloc_30r):
    """38: the dry run's lines (``start_dryrun``'s subprocess) and its
    trace and memory model held to what the card measured in 30, 33, 34
    and 37 (``runs``: their ``RankRun``s, ``train_runs`` their results)
    and 30r (``alloc_30r``: arch -> the parameters' bytes); see the
    module docstring.  The numbers, for the JSON line."""
    import dataclasses as dc
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.core.topology import make_layout, single_device_layout
    from repro_torch.launch import dryrun
    proc, log, path, t_start = run
    t = time.perf_counter()
    try:
        rc = proc.wait(timeout=max(1.0, DRY_TIMEOUT_S - (time.time()
                                                        - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"38: the dry run outlived {DRY_TIMEOUT_S} s")
    finally:
        log.close()
    waited = time.perf_counter() - t
    text = path.read_text()
    for line in text.splitlines():
        print("[38] " + line)
    # from its start to its last line (the log's last write)
    ran = path.stat().st_mtime - t_start
    print(f"[38] the dry run ran {ran:.1f} s on the CPU beside phases 2-37 "
          f"(waited {waited:.1f} s for it here)")
    check(rc == 0 and " FAIL" not in text, f"38: the dry run exited {rc}")
    ok = {arch: next((ln for ln in text.splitlines()
                      if ln.startswith(f"{arch} x train_4k x 1pod")
                      and " OK flops=" in ln), None) for arch in DRY_TRACED}
    check(all(ok.values()), f"38: no OK trace for "
          f"{[a for a, ln in ok.items() if ln is None]}")
    out = {"dryrun_s": ran, "waited_s": waited, "bytes": {}, "opt": {},
           "param": {}}
    # the trace at each launcher run's plan: rank 0's bytes (at pp 2 each
    # stage's first rank's) against what the card's ranks counted
    for rr in runs:
        res = train_runs[rr.name]
        cfg = dc.replace(get(rr.arch), n_layers=RANK_TRAIN_LAYERS)
        lay = run_layout(rr)
        per = lay.n_devices // (lay.n_data * lay.size("pp"))
        pred = {}
        for r in range(0, lay.n_devices // lay.n_data, per):
            got = dryrun.trace_step(cfg, run_layout(rr, r), TRAIN_B, TRAIN_S,
                                    OptimConfig())["collectives"]
            by = {k: v for k, v in got["by_kind"].items() if v}
            counts = {k: v for k, v in got["counts"].items() if v}
            check(by == res["bytes_by_kind_per_rank_step"][r]
                  and counts == res["counts_by_kind_per_rank_step"][r],
                  f"38 {rr.name} rank {r}: the trace's bytes {by} counts "
                  f"{counts} against the card's "
                  f"{res['bytes_by_kind_per_rank_step'][r]} "
                  f"{res['counts_by_kind_per_rank_step'][r]}")
            pred[r] = by
        out["bytes"][rr.name] = pred
        print(f"[38] {rr.name} ({rr.tag}): the trace's bytes a step by kind "
              + "; ".join(f"rank {r} " + ", ".join(
                  f"{k} {v:.6g}" for k, v in by.items())
                  for r, by in pred.items())
              + " equal the card's ranks' (comm.bytes_moved)")
    # the opt line at phase 34's plans
    shape = ShapeConfig("smoke", TRAIN_S, ZERO_B, "train")
    for stage in (0, 1, 2):
        n_dp, n_model, cube = RANK_LAYOUTS["dp2"]
        lay = make_layout(1, n_dp, n_model, "3d", cube, zero_stage=stage,
                          microbatches=ZERO_MB)
        mm = dryrun.memory_model(zero_cfg(), lay, shape, OptimConfig())
        pred = mm["opt_gib"] * 2 ** 30
        meas = [g * 1e9 for g in zero_numbers[f"zero{stage}"][
            "moment_gb_by_rank"]]
        err = max(abs(pred / m - 1) for m in meas)
        check(err <= DRY_TOL, f"38 zero{stage}: opt {pred:.6g} B against "
              f"the moments {meas}")
        out["opt"][f"zero{stage}"] = {"model_bytes": pred,
                                      "measured_bytes": meas, "err": err}
    # the param line at 30r's one rank and each rank of 30's runs
    shape = ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train")
    cases = [(f"30r {arch}", dc.replace(get(arch),
                                        n_layers=RANK_TRAIN_LAYERS),
              single_device_layout(), [alloc_30r.get(arch)])
             for arch in ("tinyllama-1.1b", MOON)]
    cases += [(f"{rr.tag} {rr.name}",
               dc.replace(get(rr.arch), n_layers=RANK_TRAIN_LAYERS),
               run_layout(rr),
               train_runs[rr.name]["param_alloc_by_rank"]) for rr in runs]
    for label, cfg, lay, meas in cases:
        if RANK_DEVICE != "cuda":
            continue
        pred = dryrun.memory_model(cfg, lay, shape,
                                   OptimConfig())["param_gib"] * 2 ** 30
        check(all(m is not None for m in meas), f"38 {label}: {meas}")
        err = max(abs(pred / m - 1) for m in meas)
        check(err <= DRY_TOL, f"38 {label}: params {pred:.6g} B against "
              f"memory_allocated {meas}")
        out["param"][label] = {"model_bytes": pred, "measured_bytes": meas,
                               "err": err}
    print("[38] the memory model against the card (within "
          f"{DRY_TOL:.0%}): " + "; ".join(
              f"opt {k} {v['model_bytes'] / 1e9:.4f} GB, err "
              f"{v['err']:.2e}" for k, v in out["opt"].items()) + "; "
          + "; ".join(f"params {k} {v['model_bytes'] / 1e9:.4f} GB, err "
                      f"{v['err']:.2e}" for k, v in out["param"].items()))
    return out


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(f"chip_smoke on {card}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()

    def timed(fn, *args, **kw):
        """fn's result, with the seconds it took printed after it."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        print(f"    ({fn.__name__} took {time.perf_counter() - t:.1f} s)")
        return out
    timed(phase_build)
    dry_run = start_dryrun()
    k1_numbers = timed(phase_k1, dev)
    k1_numbers["decode"]["decode_max_m_measured"] = timed(
        phase_k1_threshold, dev)
    k1_ranks, k1_ranks_err = timed(phase_k1_ranks, dev)
    k1_base, k1_base_err = timed(phase_k1_ranks, dev, BASE_LAYOUTS, "2b")
    k1_ranks.update(k1_base)
    k1_ranks_err = max(k1_ranks_err, k1_base_err)
    k4_numbers = timed(phase_k4, dev)
    k4_numbers["shapes"].update(timed(phase_k4_latent, dev))
    k4_numbers["shapes"].update(timed(phase_k4_cross, dev))
    k3_numbers = timed(phase_k3, dev)
    k3_numbers["two_phase"] = timed(phase_k3_split, dev)
    k3_numbers["shapes"].update(timed(phase_k3_base, dev))
    k2_numbers = timed(phase_k2, dev)
    k2_numbers["shapes"]["mla"] = timed(phase_k2_mla, dev)
    k2_numbers["shapes"].update(timed(phase_k2_whisper, dev))
    k2_rank_shapes, k2_ranks_err = timed(phase_k2_ranks, dev)
    k2_numbers["shapes"].update(k2_rank_shapes)
    k2_base_shapes, k2_base_err = timed(phase_k2_ranks, dev, K2_BASE_SHAPES,
                                        "5b")
    k2_numbers["shapes"].update(k2_base_shapes)
    k2_numbers["max_abs_err"] = max(k2_numbers["max_abs_err"], k2_ranks_err,
                                    k2_base_err)
    timed(phase_two_layer, dev)
    timed(phase_two_layer, dev, "bfloat16")
    timed(phase_two_layer_train, dev)
    # one sequence of 256: the CPU side of gemma's 256000-word head is
    # the slow part of these two
    timed(phase_two_layer_train, dev, "paper-transformer", seed=6, rows=1,
          seq=256)
    timed(phase_two_layer_train, dev, "gemma-2b", seed=7, rows=1, seq=256)
    serve_launches, serve_routes, serve_k2, serve_k4, ttft7 = timed(
        phase_serve, card, k4_numbers["ms"])
    bf16 = timed(served_model, dev)
    f32 = timed(served_model, dev, "float32", 4, n=4, max_new=8)
    prefix_numbers = timed(phase_prefix, bf16, f32, card, ttft7)
    gather_numbers = timed(phase_gather, bf16, f32, card)
    spec_numbers = timed(phase_spec, bf16, f32, card)
    del bf16, f32
    spec_k4 = sum(v["k4_by_path"]["spec_draft"]
                  for v in spec_numbers.values())
    zserve_launches, zserve_routes, zserve_k4, zserve_eng, \
        zserve_numbers = timed(phase_serve_zamba2, card)
    zserve_numbers["breakdown"] = timed(phase_decode_breakdown_zamba2,
                                        zserve_eng, card)
    del zserve_eng
    train_launches, train_routes, train_k2, train_tel = timed(phase_train,
                                                              card)
    timed(phase_breakdown, dev, card)
    k1_train, k1_train_err = timed(phase_k1_train, dev)
    k5_numbers = timed(phase_k5, dev)
    timed(phase_two_layer_zamba2, dev)
    timed(phase_two_layer_zamba2_serve, dev)
    zamba_launches, zamba_routes, zamba_k2, _ = timed(
        phase_train, card, "zamba2-1.2b", Z_STEPS, Z_LAUNCHES, tag="13")
    timed(phase_breakdown, dev, card, "zamba2-1.2b", tag="14")
    timed(phase_two_layer_xlstm, dev)
    timed(phase_two_layer_xlstm_serve, dev)
    xserve_launches, xserve_routes, _, xserve_numbers = timed(
        phase_serve_state, card, "xlstm-350m", "7x", X_SERVE_STEP,
        xlstm_step_bytes)
    xlstm_launches, xlstm_routes, xlstm_k2, xlstm_tel = timed(
        phase_train, card, "xlstm-350m", X_STEPS, X_LAUNCHES, tag="17")
    xlstm_numbers = train_numbers(xlstm_tel)
    # an eighth of the sequence: the sLSTM's per-token loop makes a full
    # step hundreds of thousands of kernels for the profiler to record,
    # and the profile's time grows faster than the sequence (4 x 512 took
    # 81 s on an H100, 4 x 256 31 s)
    xlstm_numbers["breakdown"] = timed(phase_breakdown, dev, card,
                                       "xlstm-350m", tag="18",
                                       seq=TRAIN_S // 8)
    xlstm_numbers["block_share"] = timed(phase_xlstm_blocks, dev, card,
                                         xlstm_tel["t_step_s"])
    xlstm_numbers["checkpoint"] = timed(phase_ckpt_roundtrip, card)
    timed(phase_two_layer_moe, dev)
    timed(phase_two_layer_moe_serve, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mserve_launches, mserve_routes, mserve_k2, mserve_k4, moe_numbers = \
        timed(phase_serve_mixtral, card)
    gc.collect()
    torch.cuda.empty_cache()
    mix_launches, mix_routes, mix_k2, mix_tel = timed(
        phase_train, card, "mixtral-8x7b", MIX_STEPS, MIX_LAUNCHES,
        tag="21", layers=MIX_TRAIN_LAYERS)
    moe_numbers = {"serve_mixtral": moe_numbers, "train_mixtral":
                   train_numbers(mix_tel, layers=MIX_TRAIN_LAYERS)}
    moe_numbers["train_mixtral"]["breakdown"] = timed(
        phase_breakdown, dev, card, "mixtral-8x7b", tag="22",
        layers=MIX_TRAIN_LAYERS, op_group=moe_op_group)
    gc.collect()
    torch.cuda.empty_cache()
    ds_model = timed(phase_two_layer_deepseek, dev)
    timed(phase_two_layer_deepseek_serve, dev, ds_model)
    del ds_model
    gc.collect()
    torch.cuda.empty_cache()
    dserve_launches, dserve_routes, dserve_k2, dserve_k4, ds_numbers = \
        timed(phase_serve_deepseek, card)
    gc.collect()
    torch.cuda.empty_cache()
    ds_launches, ds_routes, ds_k2, ds_tel = timed(
        phase_train, card, "deepseek-v3-671b", DS_STEPS, DS_LAUNCHES,
        tag="24", layers=DS_TRAIN_LAYERS, batch=DS_TRAIN_B, cut=DS_TRAIN_CUT,
        k2_route="simt")
    series = ds_tel["series"]
    print("[24] deepseek-v3 training losses by step: " + "; ".join(
        f"step {i + 1} xent {series['xent'][i]:.4f} aux "
        f"{series['aux'][i]:.5f} mtp {series['mtp'][i]:.4f}"
        for i in range(DS_STEPS)))
    ds_numbers = {"serve_deepseek": ds_numbers, "train_deepseek": {
        "layers": DS_TRAIN_LAYERS, "experts": DS_TRAIN_EXPERTS,
        "batch": [DS_TRAIN_B, TRAIN_S], "t_step_s": ds_tel["t_step_s"],
        "tokens_per_s": ds_tel["tokens_per_s"], "mfu": ds_tel["mfu"],
        "mem_peak_gib": ds_tel["mem_peak_bytes"] / 2 ** 30,
        **{k: series[k] for k in ("loss", "xent", "aux", "mtp", "t_step")}}}
    gc.collect()
    torch.cuda.empty_cache()
    ds_numbers["train_deepseek"]["breakdown"] = timed(
        phase_breakdown, dev, card, "deepseek-v3-671b", tag="25",
        layers=DS_TRAIN_LAYERS, rows=DS_TRAIN_B, op_group=ds_op_group,
        change=lambda cfg: ds_train_cfg())
    gc.collect()
    torch.cuda.empty_cache()
    w_model = timed(phase_two_layer_whisper, dev)
    timed(phase_two_layer_whisper_decode, dev, *w_model)
    del w_model
    wserve_launches, wserve_routes, wserve_k4, wserve_numbers = timed(
        phase_serve_state, card, "whisper-medium", "7w", W_SERVE_STEP,
        functools.partial(state_step_bytes, "whisper-medium"))
    gc.collect()
    torch.cuda.empty_cache()
    w_launches, w_routes, w_k2, w_tel = timed(
        phase_train, card, "whisper-medium", W_STEPS, W_LAUNCHES, tag="27",
        seq=W_TEXT)
    modality_numbers = {"serve_whisper": wserve_numbers,
                        "train_whisper": train_numbers(
                            w_tel, batch=[TRAIN_B, W_TEXT],
                            frames=W_FRAMES)}
    modality_numbers["train_whisper"]["breakdown"] = timed(
        phase_breakdown, dev, card, "whisper-medium", tag="27p", seq=W_TEXT,
        op_group=launching_op_group, host_steps=3)
    gc.collect()
    torch.cuda.empty_cache()
    vserve_launches, vserve_routes, vserve_k4, \
        modality_numbers["serve_internvl"] = timed(
            phase_serve_state, card, "internvl2-2b", "7v", V_SERVE_STEP,
            functools.partial(state_step_bytes, "internvl2-2b"))
    gc.collect()
    torch.cuda.empty_cache()
    v_launches, v_routes, v_k2, v_tel = timed(
        phase_train, card, "internvl2-2b", V_STEPS, V_LAUNCHES, tag="28")
    modality_numbers["train_internvl"] = train_numbers(
        v_tel, batch=[TRAIN_B, TRAIN_S], patches=V_PATCHES)
    gc.collect()
    torch.cuda.empty_cache()
    modality_numbers["train_internvl"]["breakdown"] = timed(
        phase_breakdown, dev, card, "internvl2-2b", tag="28p",
        op_group=launching_op_group, host_steps=3)

    gc.collect()
    torch.cuda.empty_cache()
    ranks_numbers = {"grads_f32": timed(phase_ranks_grads, dev)}
    # the one-rank run that phases 30 and 33 are held to: phase 8's path
    # cut to their depth
    alloc_30r = {}
    with param_alloc() as alloc:
        cut_launches, _, _, cut_tel = timed(
            phase_train, card, steps=RANK_STEPS,
            per_step=step_launches(RANK_TRAIN_LAYERS), tag="30r",
            layers=RANK_TRAIN_LAYERS)
    alloc_30r["tinyllama-1.1b"] = alloc[0] if alloc else None
    cut_losses = cut_tel["series"]["loss"]
    # and the one that phase 30's Moonlight run is held to: [dense, moe]
    gc.collect()
    torch.cuda.empty_cache()
    with param_alloc() as alloc:
        moon_cut_launches, _, _, moon_cut_tel = timed(
            phase_train, card, MOON, steps=RANK_STEPS,
            per_step=moon_launches(RANK_TRAIN_LAYERS), tag="30r",
            layers=RANK_TRAIN_LAYERS)
    alloc_30r[MOON] = alloc[0] if alloc else None
    gc.collect()
    torch.cuda.empty_cache()
    # 30, 37 and 33: the launcher's runs in one torchrun world
    runs = (rank_runs(RANK_LAYOUTS, overlap=("cube",), steps=RANK_CUT_STEPS)
            + rank_runs(PP_LAYOUTS, tag="37", steps=RANK_CUT_STEPS)
            + rank_runs({"1d": BASE_LAYOUTS["1d"]}, tag="33",
                        later_tol=1e-2, steps=RANK_CUT_STEPS)
            + rank_runs({"2d": BASE_LAYOUTS["2d"]}, tag="33",
                        later_tol=None, steps=RANK_CUT_STEPS)
            + rank_runs({"cube": RANK_LAYOUTS["cube"]}, arch=MOON,
                        ref=moon_cut_tel["series"]["loss"], prefix="moe_"))
    train_runs = timed(phase_ranks_train, card, cut_losses, runs,
                       layers=RANK_TRAIN_LAYERS)
    ranks_numbers["train"] = {k: train_runs[k]
                              for k in ("cube", "overlap", "dp2")}
    ranks_numbers["train_pp"] = {"pp2": train_runs["pp2"]}
    ranks_numbers["train_moe"] = {"moe_cube": train_runs["moe_cube"],
                                  "one_rank": train_numbers(moon_cut_tel)}
    base_numbers = {"grads_f32": timed(phase_base_grads, dev),
                    "train": {k: train_runs[k] for k in ("1d", "2d")}}
    gc.collect()
    torch.cuda.empty_cache()
    zero_ckpt = ROOT / "build" / "chip_smoke_zero_ckpt"
    zero_numbers = timed(phase_zero, card, zero_ckpt)
    zero_numbers["ckpt"], ckpt_paths = timed(
        phase_ckpt_layouts, card, zero_ckpt, zero_numbers["post_loss_dp2"])
    gc.collect()
    torch.cuda.empty_cache()
    ada_numbers, ada_paths = timed(phase_adafactor, card, dev, train_tel)
    dry_numbers = timed(phase_dryrun, dry_run, train_runs, runs,
                        zero_numbers, alloc_30r)
    # each layout's launches over its 8 ranks (ZeRO's: every rank runs
    # the same; pp's: each stage its own)
    rank_paths = {f"train_ranks_{lname}": v["launches_world"]
                  for lname, v in (*ranks_numbers["train"].items(),
                                   *ranks_numbers["train_pp"].items(),
                                   ("moe_cube", train_runs["moe_cube"]),
                                   *base_numbers["train"].items())}
    rank_paths.update({f"train_ranks_{s}": {
        k: RANKS * n for k, n in zero_numbers[s][
            "launches_per_rank"].items()} for s in ("zero0", "zero1",
                                                    "zero2")})
    rank_paths["train_cut"] = cut_launches
    rank_paths["train_cut_moe"] = moon_cut_launches
    # the checkpoint's resumes and the Adafactor runs: K1 and K2 all tc
    rank_paths.update(ckpt_paths)
    rank_paths.update(ada_paths)

    paths = (("serve", serve_launches), ("train", train_launches),
             ("train_zamba2", zamba_launches),
             ("serve_zamba2", zserve_launches),
             ("train_xlstm", xlstm_launches),
             ("serve_xlstm", xserve_launches),
             ("serve_mixtral", mserve_launches),
             ("train_mixtral", mix_launches),
             ("serve_deepseek", dserve_launches),
             ("train_deepseek", ds_launches),
             ("serve_whisper", wserve_launches),
             ("train_whisper", w_launches),
             ("serve_internvl", vserve_launches),
             ("train_internvl", v_launches))

    def launched(*names, **more):
        by = {path: sum(counts.get(n, 0) for n in names)
              for path, counts in (*paths, *rank_paths.items())}
        by.update(more)
        return dict(launches=sum(by.values()), launches_by_path=by)
    k1_tc, k1_dec = k1_numbers["tc"], k1_numbers["decode"]
    for arch, agg in k1_train.items():
        k1_tc.update({f"train_{arch}_{k}": v for k, v in agg.items()})
    k1_tc["max_abs_err"] = max(k1_tc["max_abs_err"], k1_train_err,
                               k1_ranks_err)
    for name, agg in k1_ranks.items():
        k1_tc.update({f"train_{name}_{k}": v for k, v in agg.items()})
    k1_paths = (("serve", serve_routes), ("train", train_routes),
                ("train_zamba2", zamba_routes),
                ("serve_zamba2", zserve_routes),
                ("train_xlstm", xlstm_routes), ("serve_xlstm", xserve_routes),
                ("serve_mixtral", mserve_routes),
                ("train_mixtral", mix_routes),
                ("serve_deepseek", dserve_routes),
                ("train_deepseek", ds_routes),
                ("serve_whisper", wserve_routes),
                ("train_whisper", w_routes),
                ("serve_internvl", vserve_routes),
                ("train_internvl", v_routes))
    by_route = {r: sum(routes[r] for _, routes in k1_paths)
                for r in serve_routes}
    k2_by_route = {key: {r: sum(p[key][r] for p in (
        serve_k2, train_k2, zamba_k2, xlstm_k2, mserve_k2, mix_k2,
        dserve_k2, ds_k2, w_k2, v_k2)) + (sum(
            c[key] for c in rank_paths.values()) if r == "tc" else 0)
        for r in serve_k2[key]} for key in serve_k2}

    # every K1 launch of the rank runs took the tc route (phase 30)
    by_route["tc"] += sum(c["K1"] for c in rank_paths.values())

    def k1_launched(route):
        by = {path: routes[route] for path, routes in k1_paths}
        by.update({path: c["K1"] if route == "tc" else 0
                   for path, c in rank_paths.items()})
        return dict(launches=sum(by.values()), launches_by_path=by,
                    launches_by_route=by_route)
    ratios = {"decode step": k1_dec["ms"] / k1_dec["library_ms"],
              "prefill": k1_tc["ms"] / k1_tc["library_ms"]}
    ratios.update({f"{a} train step": v["ms"] / v["library_ms"]
                   for a, v in k1_train.items()})
    print("[15] K1 / torch.matmul summed over each path's GEMMs, called "
          "from the host (target 1.5x, limit 3x): " + ", ".join(
              f"{k} {v:.2f}x" for k, v in ratios.items())
          + "; device time (CUDA graph): decode step "
          f"{k1_dec['device_ms'] / k1_dec['library_device_ms']:.2f}x, "
          f"prefill {k1_tc['device_ms'] / k1_tc['library_device_ms']:.2f}x")
    kernels = [
        dict(name="K1 matmul, tc route (prefill, training)", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_hopper.cu",
             replaces="src/repro/kernels/matmul.py:30",
             **k1_launched("tc"), **k1_tc),
        dict(name="K1 matmul, decode route", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_hopper.cu",
             replaces="src/repro/kernels/matmul.py:30",
             **k1_launched("decode"), **k1_dec),
        dict(name="K2 flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_hopper.cu "
                    "(tc), src/repro_torch/kernels/csrc/flash_attention.cu "
                    "(simt)",
             replaces="src/repro/kernels/flash_attention.py:24",
             **launched("K2", "K2 bwd"), launches_by_route=k2_by_route,
             **k2_numbers),
        dict(name="K3 rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:19",
             **launched("K3", "K3 bwd", "K3 moments", "K3 apply",
                        "K3 bwd dot", "K3 bwd apply"), **k3_numbers),
        dict(name="K4 paged_flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode_hopper.cu "
                    "(split), src/repro_torch/kernels/csrc/paged_decode.cu "
                    "(simt)",
             replaces="src/repro/kernels/paged_decode.py:72",
             **launched("K4", spec_draft=spec_k4,
                        serve_gather_view=gather_numbers["k4"]),
             launches_by_route={r: serve_k4[r] + zserve_k4[r]
                                + mserve_k4[r] + dserve_k4[r]
                                + wserve_k4[r] + vserve_k4[r] + (
                 spec_k4 + gather_numbers["k4"] if r == "split" else 0)
                 for r in serve_k4},
             launches_combine=(serve_launches["K4 combine"]
                               + zserve_launches["K4 combine"]
                               + mserve_launches["K4 combine"] + spec_k4
                               + gather_numbers["k4"]
                               + wserve_launches["K4 combine"]
                               + vserve_launches["K4 combine"]),
             **k4_numbers),
        dict(name="K5 ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:23",
             **launched("K5", "K5 bwd"), **k5_numbers),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_by_path", "launches_by_route",
             "decode_max_m_measured", "device_ms", "library_device_ms",
             "simt_ms", "fwd_ms", "bwd_ms", "simt_fwd_ms", "simt_bwd_ms",
             "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms", "fwd_bound_ms",
             "bwd_bound_ms", "fwd_device_ms", "bwd_device_ms",
             "library_fwd_device_ms", "fwd_host_ms", "bwd_host_ms",
             "bwd_kernels_ms", "library_bwd_ms", "norm_err", "kernels_ms",
             "shapes", "launch_floor_ms", "launches_combine",
             "decode_layer_kernels", "contiguous_layer_kernels",
             "two_phase") + tuple(
                 f"train_{arch}_{k}" for arch in ("tinyllama", "zamba2",
                                                  "mixtral", "moonlight",
                                                  "deepseek", "whisper",
                                                  "internvl2", "rank_cube",
                                                  "rank_dp2", "rank_1d",
                                                  "rank_2d")
                 for k in ("ms", "simt_ms", "plain_ms", "library_ms",
                           "bound_ms"))
    print("serving paths: " + json.dumps({
        "prefix_cache": prefix_numbers, "gather_view": gather_numbers,
        "speculative": spec_numbers,
        "serve_zamba2": zserve_numbers, "serve_xlstm": xserve_numbers}))
    print("xlstm training: " + json.dumps(xlstm_numbers))
    print("moe: " + json.dumps(moe_numbers))
    print("deepseek: " + json.dumps(ds_numbers))
    print("modality families: " + json.dumps(modality_numbers))
    print("3-D cube across ranks (8 ranks on one card, gloo through the "
          "host): " + json.dumps(ranks_numbers))
    print("1-D and 2-D baselines across ranks (8 ranks on one card, gloo "
          "through the host) and the comm check: " + json.dumps(base_numbers))
    print("ZeRO across ranks and checkpoints across layouts (8 ranks on one "
          "card, gloo through the host): " + json.dumps(zero_numbers))
    print("Adafactor: " + json.dumps(ada_numbers))
    print("dry run: " + json.dumps(dry_numbers))
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [
        {k: kn[k] for k in keys + extra if k in kn} for kn in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        sys.exit(rank_job(sys.argv[2]))
    sys.exit(main())
