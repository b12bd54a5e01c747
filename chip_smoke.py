#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. Device and build: where a card is present but CUDA does not start,
   up to CUDA_WAIT_S of fresh-process tries, then the script runs again
   (with no card it exits 2 at once); the card's name and power limit,
   TF32 off, the six CUDA libraries built from ``src/repro_torch/csrc``
   (one ``nvcc`` each, all at once).
2. Every kernel body against its plain PyTorch version at full width
   (d 1536, K 16, k 8; bf16 and fp32; int8 rows for the ``_q`` bodies):
   ids equal but where two classes are within TIE_RTOL of the row's top-1
   (the rows that part are counted), values within the stated tolerance. Times per case: the
   kernel's wrapper, its plain version and the library call as the host
   calls them (``ms``: CUDA events around each Python call, median of 25
   after warm-up; the wrapper's host work is inside), the wrapper and the
   library call on the device alone (``device_ms``: 20 calls captured in
   one CUDA graph, replayed between two events, over the count; median of
   5 replays), and the wrapper's host µs per call (50 calls enqueued back
   to back).
   ``lasso_prune``: fp32 at N 16,384 and, once the model exists, bf16 on
   its seeded (16, 152,064, 1536) head with the stand-in mask (the shape
   the repack gives it) and with every row alive; masks equal, norms
   within rtol 1e-5, the threshold at the midpoint of two adjacent sorted
   norms at least 8 fp32 ulps apart (relative; the kernel and its plain
   version differ by at most one) so no row ties it, nearest to the 25th
   percentile of the alive rows' norms (within 0.01 of it for the stand-in
   mask, whose threshold the adapt phase prunes at).
   ``flash_attention`` against ``ref.flash_attention_ref`` at qwen2-1.5b's
   attention shape (B 1, H 12, H_kv 2, dh 128, bf16) for S 16, 200, 2047
   and 2048 (the main path's; the tensor-core body), the CUDA-core body on
   the same S 2048 inputs, fp32 at S 2048 (the CUDA-core body's main
   path) and at H = H_kv = 2, dh 64, S 256, bf16 views that are not
   dense, and fp32 at S 2048 with dh 64 and 256 (the CUDA-core body's
   other head-dim classes), and the tensor-core body at the other configs'
   attention: llama3.2-3b (H 24, H_kv 8, S 2048), granite-20b (H 48, H_kv
   1, S 1024), lm-100m (H 12, H_kv 4, dh 64, S 512), olmoe-1b-7b (H 16,
   H_kv 16, S 2048), qwen3-moe-235b-a22b (H 64, H_kv 4, S 1024) and
   internvl2-26b (H 48, H_kv 8, S 512), each with its
   schedule's makespan in kv-tile steps and the µs per step; each case
   must launch the body ``select_body`` names, each element within
   ``repro_torch.testing.flash_attention_limit`` (bf16: one rounding of p,
   2^-8·(softmax(s)·|v|), plus 2^-7·|o|); the yardstick is
   ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)``.
   ``dss_topk_fused`` (bf16 B 8, the main case; B 1 and 128; fp32 B 8; the
   local half of a gate at e_base 8) and ``dss_topk_fused_q`` (int8 rows, B
   8, 1 and 128): expert ids equal, no -inf on a served token; the yardstick
   is u calls, one ``topk(h[idx_e] @ W[e]^T)`` for each of the u distinct
   experts the tokens chose (int8 rows read as bf16), u in the case name.
   ``dss_topk`` (bf16 B 8 on 8 distinct experts, one of them with 5 real
   rows, the main case; fp32 the same; bf16 B 64 and 300 on shared
   experts, whose yardstick is u calls as the fused kernel's): no -inf
   emitted, the short expert's tail (-1e9, -1).
   ``dss_topk_grouped`` through the body ``select_body`` names: the decode
   bodies at C 1 with every slot live (the main cases) and on a real
   dispatch (B 8 through ``gate_top1`` and ``_group_tokens``: at most 8
   live experts, every slot compared, empty ones too; the yardstick one
   ``topk(buf[e] @ W[e]^T)`` per live expert), the tensor-core bodies at
   C 256 for bf16 tokens (their main case the batch path's shape, V_pad
   12,032; also V_pad 12,000 with an all-padding expert), the CUDA-core
   tiled bodies at C 256 for fp32 tokens (their main case the fp32 batch
   path's shape, every slot live), the tensor-core bodies at a speculative
   verify step's head (B 40: C 5 or 10) for qwen2-1.5b and the wide heads
   of phase 6b (c) (``VERIFY_HEADS``, device ms). The main cases of the
   two-launch bodies
   (``dss_topk_fused``, the grouped decode bodies) are split by kernel
   with the profiler (``kernels_split_ms``). The capacity sweeps: the
   decode body beside the tensor-core body (bf16 tokens on bf16 rows and
   their int8 table; it sets ``TILED_ABOVE``) and beside the CUDA-core
   tiled body (fp32 tokens on fp32 rows and their int8 table; it sets
   ``SIMT_TILED_ABOVE``), through ``launch_body`` at C 1, 2, 4, 8, 16, 32,
   48, 64, 128 and 256 (and 3), each checked and timed on the device
   alone. Then the tiled bodies on a real dispatch (2048 fp32 tokens
   through ``gate_top1`` and ``_group_tokens`` at C 256; yardstick one
   fp32 ``bmm`` + ``topk`` over (K, C, d)). These grouped cases run last
   in phase 2, on a generator of their own.
   The head-path step: ``serve_topk`` at qwen2-1.5b's head shape on a
   stand-in fp table and its int8 table at B 1, 8, 40, 64 and 2048 (C 1,
   1, 5, 8, 256; B 40 is a speculative verify step at 8 slots and gamma 4)
   with bf16 tokens, and on an fp32 copy of the table and its int8
   table at B 64 and 2048 with fp32 tokens, through jnp, grouped,
   cuda_grouped and cuda_fused, and on the fp tables cuda_pertoken,
   interleaved round-robin, device time from the profiler; every path's
   ids equal jnp's but at near-ties (TIE_RTOL of the row's top-1;
   cuda_pertoken's bf16 fold FOLD_RTOL; the count is printed), and
   ``auto``'s pick within 1.5x the fastest path.
3. The slice: qwen2-1.5b at full width (28 layers, seeded weights, a
   seeded stand-in for a trained expert mask) served by ``ServeSession``
   through 8 slots, 12 requests (one prompt of 2048 tokens: its prefill
   runs the flash_attention kernel over 16 kv tiles of 128 rows).
   Every session here keeps the overflow breaker off and must end on the
   kernel it names; like every session of phases 3, 5 and 6 it runs the
   default decode step (the backbone captured once as a CUDA graph and
   replayed, the head eager after it) and must have captured exactly once
   (``stats()["decode_graphs"] == 1``).
   (fp) For each ``kernel=`` of cuda_fused, cuda_grouped, auto and jnp:
   once as a user calls ``run()`` (tokens/s), once with every prefill and
   decode step synchronized and timed; greedy streams token-identical.
   (int8) ``quantize='int8'`` sessions, each run once, instrumented:
   (a) flip threshold 1.0, every expert on int8 rows, through
   cuda_fused, cuda_grouped, auto and jnp; (b) a ``quantize_table`` table
   with half the experts on fp fallback rows, through cuda_fused,
   cuda_grouped and jnp; each group token-identical; (c) the default
   threshold 0.0, its exactness report printed.
   (per-token) One ``cuda_pertoken`` session on the fp table, held
   against the fp jnp session (its g fold rounds h to bf16, so a stream
   may leave only at a top-1/top-2 gap below 2^-7 relative).
   Each group resets the launch counters before it and reads them after:
   every kernel body of its path must have launched (flash_attention's
   tensor-core body in every session's prefill, its CUDA-core body never),
   the plain head's counts stay 0.
   (batch) ``serve_topk(kernel='auto')`` over 2048 bf16 hidden states at
   once on the fp head table and its int8 table, through whatever path
   ``auto`` picks (printed; ``cuda_grouped`` runs the tensor-core bodies
   at capacity 256); then 2048 fp32 hidden states through an fp32 copy of
   the head table and its int8 table, ``kernel='auto'`` too (its pick
   printed; ``cuda_grouped`` runs the CUDA-core tiled bodies). Counts set
   to 0 just before each group and read just after: the bodies of the path
   ``auto`` picked must launch, no other grouped body; held
   against the plain ``grouped`` path (ids equal but at near-ties).
4. Decode-step profile: 8 residents at prompt length 512, for cuda_fused
   and jnp on the fp table and cuda_fused on the int8 table, each twice on
   identical requests: the eager step (``decode_graph=False``), then the
   default (the graph). After the admitting step and the graph's warm-up
   steps: step ms (median of 20), then ``torch.profiler`` over 5 steps for
   device-busy time, the device's idle share, device ops, host launches
   and host syncs per step, ``decode_graphs``, and the ten device ops that
   take the most time; for the graph also its memory pool (MiB) and one
   replay's device ms by CUDA events. The greedy streams must be
   token-identical and the graph session must have captured once.
5. Adapt: qwen2-1.5b at full width on ``skew_gate`` params (every token
   to expert 0: at capacity factor 2.0, K 16 and 8 slots, 7 of 8 tokens
   overflow), 8 requests. (i) One ``repack_for_traffic`` (re-prune at the
   25th percentile of alive-row norms, mitosis of expert 0) swapped into
   ``cuda_grouped``, ``cuda_fused`` and ``jnp`` sessions at the same
   decode step: streams agree (or leave at a near-tie), v_pad shrinks.
   (ii) The online loop (``AdaptPolicy``, breaker off) on
   ``cuda_grouped``: one swap, the window's overflow rate falls, rows
   pruned, v_pad shrinks, ``lasso_prune`` launched and its plain version
   never called, ``decode_builds == 1 + n_swaps``.
   (iii) The breaker trips twice (capacity x2, then the ``cuda_fused``
   kernel, which must launch after trip 2), streams equal an unswapped
   ``jnp`` session's. (iv) An int8 session (flip threshold
   1.0) adapted once stays quantized, with a fresh gate report, and its
   int8 grouped body launches after the swap. Every kernel body of the
   path (both grouped bodies, ``gate_top1``, the fused body,
   ``lasso_prune``) must have launched. Every session keeps one decode
   graph across its swap or its trips (``decode_graphs == 1``). Repack,
   swap and lasso times are printed.
6. Prefill: qwen2-1.5b at full width. (a) One 2048-token whole-prompt
   prefill through the kernel against the same prefill with the plain
   attention (``chunked_causal_attention``) swapped in by this script:
   top-k values within 2^-4 of the top-1 and ids apart only at a near-tie
   (within twice that), exactly 28 launches of the tensor-core body and
   none of the CUDA-core body, and neither plain function called on the
   kernel run. (a2) The same prompt through an fp32 copy of the model (the
   CUDA-core body's path): 28 launches of that body, none of the other,
   top-k values within 1e-4 of the top-1 against the plain attention; then
   warm (median of 3 and one profiled; with ``--parent`` also through the
   parent's CUDA-core body).
   (b) Five sessions
   (8 slots, ``kernel='auto'``, max_seq_len 2304): (A) contiguous,
   whole-prompt; (B) contiguous, ``prefill_chunk=256``; (C) paged,
   whole-prompt; (D) paged, chunked, prefix sharing; (E) as D with the
   arena at 60% of the most pages D held at once and two priority classes.
   12 greedy requests of 32 new tokens: 8 share a 1024-token system prompt
   (4 chunks) with distinct 16-300-token tails, 4 are unrelated (16-2048
   tokens). C must equal A and D equal B token for token; A against B and E
   against D: while a stream agrees, its top-1 value and top-1 gate
   probability within 2^-4 of the reference's at each emission, and it may
   leave only where the reference ranks its token, or the expert it chose,
   within twice that (the gate is watched by wrapping ``heads.head_topk``
   for these sessions); D saves >= 28 prefix
   chunks; E preempts and completes every request; every page is free
   after a paged session. Prefill ms (median, total; the model's calls,
   without the cache insert) and decode-step ms per session.
6b. Spec (``spec_phase``). (a) Speculative decoding: llama3.2-3b at full
   width in bf16 (28 layers, d 3072, GQA 24/8, V 128,256, K 16; seeded
   weights, the seeded stand-in mask), 8 slots, 8 greedy prompts of
   16-512 tokens, 32 new tokens, ``kernel='auto'``, the default graphs.
   Four sessions on the same requests: the baseline (no draft), a
   self-draft (gamma 4), a shallow draft (llama3.2-3b's widths, 2 layers,
   its own seed; gamma 4) and the self-draft paged with chunked prefill
   (chunk 128), and the self-draft without the draft's backfill (what
   ``repro`` does; its accept rate printed, not required). Each runs twice: once as a user calls ``run()``
   (tokens/s), once instrumented (a ``Recorder``: verify ms as the replay
   plus the head, draft ms per call and per step, medians over the calls
   replayed from the graphs; each emission's head and gate). The steady
   state's tokens/s: tokens emitted per verify step over (verify ms +
   draft ms per step); the baseline's: 8 over its decode step ms. Every speculative greedy stream is held to the baseline's
   by ``_held_within_drift`` (BF16_DRIFT; partings only at token or gate
   near-ties, counted and printed); the self-draft accepts at least
   SPEC_ACCEPT_MIN of its proposals; a sampled self-draft run
   (temperature 0.8, top-k 8, fixed seeds) repeats token for token; the
   baseline captures one decode graph, each speculative session one draft
   graph and one verify graph and no decode graph; every page is free
   after the paged session; the verify head's body (what ``auto`` picks
   at B 40), the fused decode body (the draft's and prefill's heads) and
   the tensor-core attention body launch. (b) granite-20b at full width
   (52 layers, d 6144, MQA 48/1, gelu, V 49,152, K 8), 8 prompts of
   16-1024 tokens, 16 new tokens: layer 0's attention of the 1024-token
   prompt through ``flash_attention_wgmma`` at H 48, H_kv 1, every
   element within ``flash_attention_limit``; every stream finite; 52
   tensor-core attention launches per prefill; the decode step's median
   ms beside the backbone's bytes bound. (c) ``serve_topk`` at the head
   shapes of llama3.2-3b, granite-20b and deepseek-67b (K 16/8/8, d
   3072/6144/8192, V_pad from each stand-in mask) on seeded stand-in fp
   and int8 tables at B 8 and 40: cuda_grouped, cuda_fused and (fp)
   cuda_pertoken against jnp, ids equal but at near-ties and values
   within VAL_ATOL/VAL_RTOL (cuda_pertoken against its own plain version,
   its ids against jnp's at FOLD_RTOL); device ms per call from the
   profiler. Also at the heads of olmoe-1b-7b, qwen3-moe-235b-a22b and
   internvl2-26b (K 8/16/8, d 2048/4096/6144).
6c. Families (``family_phase``): the moe and vlm families at full width,
   each model freed before the next, each part's seconds printed.
   (a) olmoe-1b-7b at full width and depth (16 layers, d 2048, MHA 16/16,
   64 experts top-8, f 1024, V 50,304, K 8; seeded weights, the seeded
   stand-in mask), 8 slots, 8 greedy prompts of 16-2048 tokens, 24 new
   tokens: sessions A (``kernel='auto'``, the default decode graph), B
   (the plain head, ``jnp``), C (paged, chunked prefill of 128, ``auto``)
   and D (chunked 128, ``jnp``); A held to B and C to D by
   ``_held_within_drift`` at TIE_RTOL (the backbones are the same code on
   the same inputs, the heads exact). The attention: one 2048-token
   prefill with each of its 16 ``flash_attention_wgmma`` calls held per
   element to ``flash_attention_limit`` on its own inputs, then with the
   plain attention swapped in: bf16 roundings move the MoE router, so the
   two runs' routes are compared and, in the first layer where a token's
   expert set differs, every such expert must sit within ROUTER_TIE of
   the k-th router probability (a near-tie); the flips per layer are
   printed. The 2048-token request served alone equals its stream in the
   batch token for token; each session captures one decode graph,
   completes every request, keeps ``stats()`` finite; every page is free
   after C; A launches the decode head's body (what ``auto`` picks at B 8)
   and the tensor-core attention body. The decode step: its
   median (replay + head), one replay by CUDA events beside the bound of
   reading every expert once (``moe_expert_bytes``: 12.9 GB, 3.85 ms at
   3.35 TB/s) and the backbone's bytes bound, the 16 MoE blocks alone at
   B 8 (a CUDA graph of their own) as a share of the replay, and the
   profiler's top device ops of a replay; the 2048-token prefill ms (in
   session A, then warm: median of 3 and one profiled); peak memory. An
   int8-table session (flip threshold 1.0) serves with its experts on int8
   rows (an ``_q`` body launches); a self-draft session (gamma 4) runs
   twice token for token, its accept rate printed, its verify head's body
   (``auto`` at B 40) and its decode head's body launched.
   (b) qwen3-moe-235b-a22b at full width with 2 of its 94 layers (128
   experts top-8, H 64, H_kv 4, dh 128, V 151,936, K 16; the whole head
   before packing): layer 0's attention of a 1024-token prompt through
   ``flash_attention_wgmma`` against the plain version, every element
   within ``flash_attention_limit``; 4 greedy streams of 16 tokens
   complete and finite, one decode graph; ``serve_topk(kernel='auto')`` on
   its table at B 8 and 40 against ``jnp`` (ids equal but at near-ties).
   (c) internvl2-26b at full width and depth (48 layers, d 6144, GQA 48/8,
   V 92,553, K 8): layer 0's attention of 256 stub patches + 256 tokens
   within the limit; the whole prefill of that input through the kernels
   (48 tensor-core attention launches) against the plain path (``jnp``
   head, plain attention): ids equal but at near-ties, values within
   BF16_DRIFT of the top-1, both timed on the first call and warm (median
   of 3); then a text-only session of 4 streams.
6e. Encdec (``encdec_phase``): whisper-base at full width and depth (6
   encoder and 6 decoder layers, d 512, MHA 8/8, V 51,865, K 8) and
   paper-envi at full width (2 + 2 layers, d 256, V 7,709, K 8), seeded
   weights and the seeded stand-in mask, each freed before the next. 8
   requests of 1500 seeded stub frames (``input_specs``) and a 64-token
   target prefix: one prefill, the self cache grown to 448 positions
   (``encdec.pad_self_cache``; whisper's decoder context), 64 greedy
   decode steps, through ``kernel=`` auto, cuda_fused, cuda_grouped and
   jnp. Streams equal jnp's but at counted near-ties (TIE_RTOL), values
   within phase 2's tolerance, each path's bodies launched (jnp none of
   the head's), every value finite; each decoder prefill attention call
   through ``flash_attention_wgmma`` (one a layer) held per element to
   ``flash_attention_limit``; ``serve_topk`` at B 8 on the model's table
   through cuda_fused and cuda_grouped against jnp. Printed: encode and
   prefill ms (first call, then warm median of 3), the eager decode
   step's median ms beside its bytes bound (``encdec_decode_bytes``:
   decoder weights, the bf16 cross K/V and self cache read once, the
   chosen experts' rows), one profiled step (device-busy ms, idle share,
   device ops, top ops), the head's device ms, peak memory.
6f. Mesh (``mesh_phase``; it runs right after phase 6, on phase 3's
   qwen2-1.5b): a 1-rank NCCL group over a file store and a 1x1 mesh. (a)
   ``serve_topk_sharded`` on the head (K 16, d 1536, k 8, V_pad 12,032;
   the fp table and an int8 table with every odd expert on fallback rows)
   at B 1, 8, 40 and 2048 through auto, cuda_fused, cuda_grouped,
   cuda_pertoken (fp) and jnp: ids and values bit for bit
   ``serve_topk``'s on the same path, each path's bodies launched, the
   device ms of both (profiler; the difference is the merge's cost at ep
   1) and host µs (not timed: jnp, and the int8 table, at B 2048, where
   the fallback experts' gather fixup takes ~0.2 s a call). (b) Each
   model rank's local half at ep 2 and 4 on this one card, one shard
   after another (``table_shard``; ``serve_topk_local_half``: cuda_fused
   at ``e_base`` = r·K_loc, cuda_grouped on the owned tokens at the
   global capacity) at B 8 and 2048, then ``merge_carries``: ids bit for
   bit ``serve_topk``'s, values within rtol 1e-6 / atol 2e-6, the shards'
   counts concatenated equal to its counts, no -inf in a carry, the
   bodies launched; per-shard device ms but for the int8 table at B 2048
   (not a multi-card measurement). (c) ``ServeSession(mesh=1x1)``,
   replicated and ``param_mode='fsdp'``, through cuda_fused and auto on
   phase 3's 12 requests: streams equal phase 3's, one decode graph, the
   bodies launched; tokens/s beside phase 3's and the rank's resident
   parameter bytes; each session holds every slot's cache (one data row:
   ``local_slots`` whole, ``cache_bytes`` the whole cache's). (d) A
   data-2 mesh's slot-split decode emulated on the card
   (``testing.mesh_rows.decode_data_rows``): each data row's 4 of the 8
   slots (phase 3's first 8 prompts, 32 greedy emissions) stepped in turn
   on its own half cache through the backbone and the cuda_fused head,
   the rows merged, against the same decode on the whole cache: the
   prefill's emission bit for bit, then BF16_DRIFT while the streams agree
   and partings only at a near-tie (``_held_within_drift``); each row's
   cache half the whole's bytes. The group is destroyed before phase 6b.
7. Train: lm-100m, the repo's real-hardware training preset
   (``examples/train_lm_dssoftmax.py:31-37``: 12 layers, d 768, 12 heads,
   kv 4, d_ff 2048, V 50,304, K 8), built here, at full width in bf16 on
   seeded weights and ``TopicLMStream`` batches of 8 x 512 tokens.
   (a0) Every parameter gets a finite, non-zero gradient from one
   ``value_and_grad`` and no kernel body launches (the train path is the
   differentiable plain code). (a) The port's ``Trainer`` runs 24 steps
   with mitosis 8 -> 16 at step 12 and checkpoints at 16 and 24: step ms
   (median), tokens/s, peak ``max_memory_allocated``, the step's model
   FLOPs (the count printed) as a share of the 989 TFLOP/s bf16 peak, CE at
   the first and last step (it must fall), expert sizes, ``memory_ratio``,
   checkpoint seconds. (a1) Three more steps under ``torch.profiler``:
   device-busy ms, idle share, device ops, host launches and syncs per
   step, the top device ops. (a2) The last checkpoint removed, a fresh
   Trainer resumes at 16 (the restored state must equal the saved one bit
   for bit) and runs to 24: its final state bit-identical to the
   uninterrupted run's, or, where a CUDA scatter sums in another order,
   params within 2·lr per resumed step, moments and the CE curve within
   rtol 1e-3, masks equal (which one is printed). (b) The trained head
   packed (``pack_experts``) and served by ``ServeSession`` on the trained
   params through cuda_fused, cuda_grouped, auto and jnp (8 greedy prompts
   of the corpus, 16 new tokens): streams token-identical to jnp's, or
   parting only at a near-tie (counted), every path's kernel bodies
   launched; ``serve_topk`` over 256 hidden states of the trained model
   (every 16th position of a held-out batch) on each path against the
   top-k of ``logits_dense`` restricted to the trained mask: ids equal but
   at near-ties, values within the kernel tolerance.
7m. Mesh training (``mesh_train_phase``, after phase 7): a 1-rank NCCL
   group over a file store and a 1x1 mesh. (a) lm-100m at full width from
   phase 7's seeded state on its batches and schedule, 6 steps of
   microbatches 2 through ``make_train_step(mesh=)`` and through the plain
   step (the mesh step's params stay blocks, read through its
   ``TrainParamGather``, which at 1x1 returns each block itself): params,
   moments, masks and metrics equal under phase 7 (a2)'s rule (which held
   is printed); step ms beside the plain step's, then both steps timed in
   turns from one state on one batch (plain, mesh, mesh, plain, twice, as
   ``tools/mesh_step_turns.py``), the rank's resident train-state bytes
   and peak ``max_memory_allocated``; the step launches no kernel body.
   (b) olmoe-1b-7b at full width (d 2048, E 64, top-8, f 1024): one
   layer's expert-parallel FFN at ep 2, 4 and 8, each shard's part
   (``moe.moe_ep_local``) run one after another and summed in bf16, on
   a bf16 batch of 4 x 512, against ``moe_block``: the forward within the
   sum of half a bf16 ulp of each partial and of each running sum, plus
   half an ulp of the reference (the largest excess printed); the
   gradients of x, the router and every expert slice within
   MESH_EP_GRAD_TOL of each leaf's largest. Then a 2-layer olmoe-1b-7b
   through 3 mesh steps at 1x1 (the expert-parallel FFN with one shard)
   against the plain step under (a)'s rule. (c) (a)'s mesh-trained head
   packed and served by ``ServeSession(mesh=1x1)`` through cuda_fused and
   auto on 8 greedy prompts: streams token-identical to the same sessions
   on the plain-trained head where (a) held bit for bit (else the parted
   streams are counted), the path's bodies launched. The group is
   destroyed at the end.
7d. The dry-run (``dryrun_phase``, after phase 7m): cells one card runs
   at 1x1, traced on meta tensors by ``launch.dryrun`` (the plain train
   step; a session's step without a mesh), then run on the card, each
   prediction held. (a) Phase 7's lm-100m train step (its batch of 8 x
   512, microbatches 1): the traced argument bytes equal
   ``tree_shard_bytes`` of the card's state and batch exactly; the traced
   step peak (peak less arguments) against ``max_memory_allocated`` less
   ``memory_allocated`` at entry (after ``reset_peak_memory_stats``, one
   step warmed up), within ``launch.dryrun.PEAK_RTOL`` and ``PEAK_ATOL``;
   the counted flops against ``train_model_flops`` (the ratio printed,
   within DRYRUN_FLOPS_RATIO); the step's ms (synced host clock) beside the
   roofline's step time.
   (b) qwen2-1.5b's decode step at phase 4's shape (8 slots, MAX_SEQ
   positions, the stand-in mask's table, the params the session reads:
   the gate, not the trained experts) and a 2048-token prefill into a
   1-slot cache: argument bytes and peak held as in (a); the decode's
   read-once bytes of weights and cache equal ``backbone_bytes`` at a full
   cache plus the gate; the traced op bytes and the roofline's bound
   beside the eager step's and the backbone graph replay's ms. (b2) Rank
   0 of a 2x1 mesh at (b)'s decode shape: the cache a session allocates
   on the card for its 4 slots (``serve_cache_block``) equals the dry-run's
   traced 2x1 rank-0 cache argument to the byte, half the 1x1 cell's. (c)
   One production cell per shape kind on the ``single`` mesh (qwen2-1.5b
   train_4k, prefill_32k, decode_32k; deepseek-67b train_4k) traced in a
   fake world of 256 ranks: fits, bottleneck and seconds printed; all
   four must fit (``DRYRUN_MUST_FIT``: a serving rank holds its block of
   the slots, a training rank its blocks of the state and one layer or
   expert gathered at a time).
Every profile opens with a head of one-element adds that it does not
count, and must find the device record of each launch after them, or it
is taken again with a longer head (``traced``): Kineto loses the records
of a profile's first launches, more as the process ages
(``tools/profiler_window.py``). The ``[profiler]`` line says how many
profiles were taken again.
8. Report: one ``{"kernels": [...]}`` line (thirteen kernel bodies, each
   with its host-timed and device-only times), the card line, and as the
   last line ``{"ok": true, "device": {...}}``.

With ``--parent DIR`` (an unpacked checkout of the parent commit, e.g.
``git archive HEAD~1 | tar -x -C build/parent``) phase 2 also builds the
parent's ``dss_topk.cu``, ``flash_attention.cu`` and ``dss_topk_grouped.cu``
and times their bodies beside this tree's on the same inputs in this
process (``[parent]`` lines, ``against_parent`` in the JSON; parent, this,
this, parent, device-only): every ``dss_topk`` case, the CUDA-core
``flash_attention`` cases at S 2048, every tensor-core ``flash_attention``
case, and the tensor-core grouped bodies at C 256 and at ``VERIFY_HEADS``;
the tensor-core bodies' outputs must equal the parent's bit for bit
(``bit_identical_to_parent``). Phase 6 (a) and (a2) also profile the warm
prefill through the parent's attention body.

Without CUDA it exits with code 2 and prints no result. It imports only
torch, numpy and the port.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of bytes / memory rate and operations / the rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Value tolerance, kernel vs plain version on the same inputs: both sum
# the same exact fp32 products (bf16 operands are widened) over d = 1536
# in different orders, so they differ by fp32 rounding only.
VAL_ATOL, VAL_RTOL = 1e-3, 1e-5
# A greedy stream may leave the plain session's only at a near-tie: the
# reference's top-1 and top-2 values closer than this (relative), i.e.
# within the accumulation-order differences above.
TIE_RTOL = 1e-5
# cuda_pertoken rounds g·h to bf16 before the product (as the reference's
# per-token path does), so its stream may leave the plain one where the
# reference's top-1 and top-2 are closer than one bf16 step (2^-7 relative).
FOLD_RTOL = 2.0 ** -7

SEED = 0
GRAPH_CALLS = 20             # calls per CUDA graph for device-only kernel times
# the head-path step: every exact serve path, interleaved round-robin, each
# timed over HEAD_CALLS calls by the profiler; auto's pick within AUTO_SLACK
# times the fastest
HEAD_PATHS = ("jnp", "grouped", "cuda_grouped", "cuda_fused")
# the per-token path serves fp tables only
FP_HEAD_PATHS = HEAD_PATHS + ("cuda_pertoken",)
HEAD_ROUNDS, HEAD_CALLS, AUTO_SLACK = 3, 5, 1.5
# prefill's last position, decode at 8 slots, a speculative verify step at
# 8 slots and gamma 4 (8 x 5 rows), a verify step at 8 slots and gamma 7, a
# whole prompt scored at once (C 1, 1, 5, 8 and 256 at cf 2.0, K 16)
HEAD_BATCHES = (1, 8, 40, 64, 2048)
# fp32 tokens (an fp32 copy of the table): a verify step's size and a whole
# prompt (C 8 and 256)
HEAD_BATCHES_FP32 = (64, 2048)
# the batch path: hidden states scored at once through serve_topk (C 256 at
# cf 2.0 and K 16: the grouped kernel's tensor-core bodies for bf16 tokens,
# its CUDA-core tiled bodies for fp32)
BATCH_B = 2048
N_SLOTS, K_TOP, NEW_TOKENS = 8, 8, 32
# On the card every bf16 whole-prompt prefill runs the flash_attention
# kernel's tensor-core body (128-row tiles); the 2048-token prompt visits 16
# kv tiles for its last query tile, and most others end on a ragged tile.
FLASH_TILE = 128
# the two bodies of flash_attention (kernels/flash_attention.py::select_body)
FLASH_TC, FLASH_SIMT = "flash_attention_wgmma", "flash_attention"
PROMPT_LENS = (16, 1536, 40, 300, 1100, 64, 700, 24, 512, 90, 2048, 200)
MAX_SEQ = max(PROMPT_LENS) + NEW_TOKENS - 1
SAMPLED = 5                  # this request samples at temperature 0.8
SESSION_KERNELS = ("cuda_fused", "cuda_grouped", "auto", "jnp")
INT8_ALL_KERNELS = ("cuda_fused", "cuda_grouped", "auto", "jnp")      # (a)
INT8_FB_KERNELS = ("cuda_fused", "cuda_grouped", "jnp")               # (b)
# kernel bodies each serve path must launch (dispatch by table kind)
NEEDS = {("cuda_fused", False): ("dss_topk_fused",),
         ("cuda_grouped", False): ("gate_top1", "dss_topk_grouped"),
         ("auto", False): ("dss_topk_fused",),
         ("cuda_fused", True): ("dss_topk_fused_q",),
         ("cuda_grouped", True): ("gate_top1", "dss_topk_grouped_q"),
         ("auto", True): ("dss_topk_fused_q",),
         ("cuda_pertoken", False): ("gate_top1", "dss_topk"),
         ("jnp", False): (), ("jnp", True): ()}
PROFILE_PROMPT, PROFILE_STEPS, PROFILE_TRACED = 512, 20, 5
# lasso_prune: the kernel sums its fp32 squares in another order than the
# plain version (one fp32 ulp apart at most, at d 1536 on the H100); each
# threshold is the midpoint of a gap of 8 ulps (FP32_SAFE_GAP) between two
# adjacent alive norms; the main path's must land within PRUNE_SLACK of the
# quantile.
LASSO_RTOL, LASSO_ATOL = 1e-5, 1e-6
PRUNE_QUANTILE, PRUNE_SLACK = 0.25, 0.01
# adapt phase: 8 requests fill the 8 slots; 24 new tokens give the breaker
# (window 8) room for both trips
ADAPT_PROMPT_LENS = (16, 40, 24, 64, 90, 32, 48, 200)
ADAPT_NEW, SWAP_AT = 24, 6
ADAPT_SEQ = max(ADAPT_PROMPT_LENS) + ADAPT_NEW - 1
ADAPT_KERNELS = ("cuda_grouped", "cuda_fused", "jnp")
BREAKER_OFF = 1.1            # overflow_threshold above any rate
# kernel bodies the adapt path must launch: the grouped and fused decode
# paths, the int8 grouped body of (iv), and the repack's re-prune
ADAPT_NEEDS = ("gate_top1", "dss_topk_grouped", "dss_topk_fused", "dss_topk_grouped_q",
               "lasso_prune")
# prefill phase: max_seq_len divisible by the page size and the chunk; 8
# requests behind a 1024-token system prompt (4 chunks) with distinct tails,
# then 4 unrelated prompts (the 2048-token one keeps the kernel's multi-tile
# case in the sessions)
PREFILL_SEQ, PAGE_SIZE, PREFILL_CHUNK = 2304, 16, 256
SYSTEM_LEN = 1024
SHARED_TAILS = (16, 300, 40, 257, 64, 128, 200, 23)
OTHER_LENS = (2048, 16, 700, 1500)
ARENA_SHARE = 0.6            # session E's arena, of the most pages D held
E_SUBMIT_AT = 3              # E: the shared-prefix class arrives after 3 steps
# Two backbones that round differently (the kernel against the plain
# einsums; a resumed request's re-prefill against its decode steps) drift
# apart through 28 layers of bf16 hidden states. A fixed allowance holds
# them: at each emission while the streams agree, the top-1 value and the
# top-1 gate probability within BF16_DRIFT of the reference's (relative, 16
# units of bf16 roundoff); a stream may leave the reference only where the
# reference puts the other stream's token, or the expert it chose, within
# twice that of its top-1.
BF16_DRIFT = 2.0 ** -4
# The fp32 prefill through the kernel against the plain einsums: fp32
# roundoff through 28 layers, held to repro's own fp32 rtol.
FP32_DRIFT = 1e-4
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync", "cudaEventSynchronize")
# host-side runtime calls that put work on the device, one per kernel, copy,
# fill or graph
LAUNCH_OPS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
              "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# ``--parent DIR``: an unpacked checkout of the parent commit. Its
# dss_topk.cu, flash_attention.cu and dss_topk_grouped.cu are built with
# this tree's nvcc flags and their bodies timed beside this tree's on the
# same inputs in this process (parent, this tree, this tree, parent;
# device-only). Without the option none of this runs.
PARENT = None
PARENT_SOURCES = ("dss_topk", "flash_attention", "dss_topk_grouped")
# A host whose card is present but whose CUDA driver does not initialize yet
# (as while an HGX board's fabric manager starts) is given this long, tried
# again every CUDA_RETRY_S seconds in a fresh process, before the script
# gives up; a host with no card gives up at once.
CUDA_WAIT_S, CUDA_RETRY_S = 240, 10
CUDA_WAITED = "CHIP_SMOKE_CUDA_WAITED"   # set in the re-executed process


class SmokeFailure(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_present() -> bool:
    """Whether the host shows an NVIDIA card, whether or not CUDA starts."""
    if any(Path("/dev").glob("nvidia[0-9]*")):
        return True
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return out.returncode == 0 and "GPU" in out.stdout


def wait_for_cuda() -> bool:
    """Whether CUDA came up in a fresh process within CUDA_WAIT_S, on a host
    with a card where it failed in this one. CUDA's state is fixed for the
    life of a process, so each try is a new one; the caller re-executes the
    script when this returns True. Each failure's reason goes to stderr."""
    if os.environ.get(CUDA_WAITED) or not card_present():
        return False
    probe = "import torch; torch.cuda.init(); print(torch.cuda.device_count())"
    deadline = time.monotonic() + CUDA_WAIT_S
    while time.monotonic() < deadline:
        time.sleep(CUDA_RETRY_S)
        try:
            r = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                               timeout=120)
        except subprocess.TimeoutExpired:
            print("chip_smoke: a CUDA probe took over 120 s", file=sys.stderr, flush=True)
            continue
        if r.returncode == 0 and r.stdout.strip() not in ("", "0"):
            return True
        why = (r.stderr.strip().splitlines() or ["no card counted"])[-1]
        print(f"chip_smoke: CUDA not up yet: {why}", file=sys.stderr, flush=True)
    return False


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median time of one ``fn()`` call in ms over ``reps`` runs, between
    two CUDA events around the Python call: the host's work in the call
    (the wrapper's checks, allocations, launches) is inside the span."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device time of one ``fn()`` in ms, the host's work left out: ``calls``
    calls captured in one CUDA graph, the graph replayed between two events
    (median of ``replays``), divided by ``calls``. The launch counters are
    put back as they were before the capture: a captured call enqueues no
    launch, and the replays do not pass through the wrappers."""
    import torch

    from repro_torch.kernels import ops

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm the allocator on the capture's stream
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    counts = ops.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for name, wrapper, attr in ops.BODIES:
        setattr(wrapper, attr, counts[name])
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def host_us(fn, calls: int = 50) -> float:
    """The host's time in one ``fn()`` call in µs: ``calls`` calls enqueued
    back to back on a synchronized device, without waiting for them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wgmma_registers(log: str) -> dict:
    """The tensor-core grouped bodies' registers and spills from the build
    log (``-Xptxas -v``), one line per body: ptxas's count at launch and
    each token tile's spill stores and loads; the consumer and producer
    warpgroups' counts after setmaxnreg (``kConsumerRegs`` /
    ``kProducerRegs``) come from the wrapper's mirror. Raises if a token
    tile spills or ptxas serializes its products (C75xx)."""
    grouped = _grouped()
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"wgmma_kernelILi(\d+)ELb([01])E", line)
        if m is None:
            continue
        body = grouped.WGMMA + ("_q" if m.group(2) == "1" else "")
        if "(C75" in line:
            raise SmokeFailure(f"{body} N {m.group(1)}: ptxas serializes the products: {line}")
        if "Compiling entry" not in line:
            continue
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 2])
        regs = re.search(r"Used (\d+) registers", lines[i + 3])
        out.setdefault(body, {})[int(m.group(1))] = {
            "registers": int(regs.group(1)), "spill_stores": int(spills.group(1)),
            "spill_loads": int(spills.group(2))}
    for body, tiles in out.items():
        launch = max(t["registers"] for t in tiles.values())
        print(f"[build] {body}: consumers {grouped.WGMMA_CONSUMER_REGS} registers, producer "
              f"{grouped.WGMMA_PRODUCER_REGS} (setmaxnreg; {launch} at launch); spill "
              f"stores/loads by token tile "
              + ", ".join(f"N {n}: {t['spill_stores']}/{t['spill_loads']}"
                          for n, t in sorted(tiles.items())), flush=True)
        if any(t["spill_stores"] or t["spill_loads"] for t in tiles.values()):
            raise SmokeFailure(f"{body}: the consumers spill ({tiles})")
    if sorted(out) != sorted([grouped.WGMMA, grouped.WGMMA + "_q"]):
        raise SmokeFailure(f"the build log names no tensor-core grouped bodies ({sorted(out)})")
    return out


# ---------------------------------------------------------------------------
# The parent commit's bodies (``--parent``), timed in this process
# ---------------------------------------------------------------------------

_PARENT_LIBS: dict = {}


def build_parent() -> dict:
    """Build ``PARENT``'s libraries of PARENT_SOURCES into
    ``build/parent_kernels/`` (one nvcc each, started together) and load
    them; returns seconds per library."""
    import ctypes

    from repro_torch.kernels import _build

    csrc = Path(PARENT) / "src" / "repro_torch" / "csrc"
    out_dir = ROOT / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                                  str(out_dir / f"{n}.so"), str(csrc / f"{n}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in PARENT_SOURCES}
    seconds = {}
    for n, p in procs.items():
        log, _ = p.communicate(timeout=900)
        seconds[n] = time.perf_counter() - t0
        if p.returncode != 0:
            raise SmokeFailure(f"the parent's {n}.cu did not build:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{n}.so"))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _PARENT_LIBS[n] = lib
    # the parent's C signatures, from its own _build.py
    signatures = _parent_module("_build").SIGNATURES
    for n, entry in (("dss_topk", "dss_topk"), ("flash_attention", "flash_attention"),
                     ("dss_topk_grouped", "dss_topk_grouped_wgmma")):
        getattr(_PARENT_LIBS[n], entry).argtypes = signatures[entry]
    return seconds


def _parent_module(name: str):
    """The parent's ``repro_torch/kernels/<name>.py``, loaded from its tree
    (imports resolve to this tree's package): its launch plans and C
    signatures, which may differ from this tree's."""
    import importlib.util

    key = f"module {name}"
    if key not in _PARENT_LIBS:
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", Path(PARENT) / "src" / "repro_torch" / "kernels" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PARENT_LIBS[key] = mod
    return _PARENT_LIBS[key]


def parent_dss_topk(w, ids, hs, e, k):
    """The parent's dss_topk body (the streaming retrieval, the same C
    signature as this tree's) with this tree's launch plan."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.dss_topk import launch_plan
    from repro_torch.kernels.retrieve_stream import row_vec_bytes

    K, v_pad, d = w.shape
    B = hs.shape[0]
    plan = launch_plan(B, K, v_pad, d, w.dtype)
    out_v = torch.empty((B, k), dtype=torch.float32, device=hs.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=hs.device)
    part_v = torch.empty((plan.max_chunks, B, k), dtype=torch.float32, device=hs.device)
    part_p = torch.empty((plan.max_chunks, B, k), dtype=torch.int32, device=hs.device)
    n_sel = torch.empty((1,), dtype=torch.int32, device=hs.device)
    lib = _PARENT_LIBS["dss_topk"]
    err = lib.dss_topk(w.data_ptr(), ids.data_ptr(), hs.data_ptr(), e.data_ptr(),
                       out_v.data_ptr(), out_i.data_ptr(), part_v.data_ptr(), part_p.data_ptr(),
                       n_sel.data_ptr(), K, B, v_pad, d, k, plan.grid,
                       row_vec_bytes(d, w.element_size(), w.data_ptr()), _build.dtype_code(hs),
                       torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "parent dss_topk")
    return out_v, out_i


def parent_flash(q, k, v, body: str):
    """The parent's flash_attention body ``body`` (``FLASH_SIMT`` or
    ``FLASH_TC``) on the same views."""
    import torch

    from repro_torch.kernels import _build

    B, H, S, dh = q.shape
    o = torch.empty_like(q)
    lib = _PARENT_LIBS["flash_attention"]
    err = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *o.stride()[:3], B, H, k.shape[1], S, dh, _build.dtype_code(q),
                              int(body == FLASH_TC), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "parent flash_attention")
    return o


def parent_grouped_wgmma(w, ids, buf, g_buf, k, scales):
    """The parent's tensor-core grouped body on the same inputs, with the
    parent's plan (``wgmma_plan`` from its tree)."""
    import torch

    from repro_torch.kernels import _build

    K, v_pad, d = w.shape
    C = buf.shape[1]
    mod = _parent_module("dss_topk_grouped")
    plan = mod.wgmma_plan(K, C, v_pad, k, scales is not None)
    out_v = torch.empty((K, C, k), dtype=torch.float32, device=buf.device)
    out_i = torch.empty((K, C, k), dtype=torch.int32, device=buf.device)
    part_v = part_i = None
    if plan.nsplit > 1:
        part_v = torch.empty((plan.nsplit, K, C, k), dtype=torch.float32, device=buf.device)
        part_i = torch.empty((plan.nsplit, K, C, k), dtype=torch.int32, device=buf.device)
    # a parent whose body takes a spill area gets one
    spill = ([torch.empty((mod.wgmma_spill_pairs(plan, K), 2), dtype=torch.float32,
                          device=buf.device).data_ptr()]
             if hasattr(mod, "wgmma_spill_pairs") else [])
    lib = _PARENT_LIBS["dss_topk_grouped"]
    err = lib.dss_topk_grouped_wgmma(
        buf.data_ptr(), g_buf.data_ptr(), w.data_ptr(), ids.data_ptr(), _build.ptr(scales),
        out_v.data_ptr(), out_i.data_ptr(), _build.ptr(part_v), _build.ptr(part_i), *spill, K,
        C, v_pad, d, k, plan.n_tile, plan.nsplit, plan.tiles_per_split, plan.stages,
        _build.weight_code(w), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "parent dss_topk_grouped_wgmma")
    return out_v, out_i


def bit_identical_to_parent(results, name, case, got, parent_fn) -> None:
    """With ``--parent``: whether this tree's output equals the parent's
    body's on the same inputs bit for bit (recorded and printed; the tensor-
    core bodies keep their products' order, so they must)."""
    import torch

    if PARENT is None:
        return
    want = parent_fn()
    same = all(torch.equal(a, b) for a, b in zip(got if isinstance(got, tuple) else (got,),
                                                 want if isinstance(want, tuple) else (want,)))
    results.setdefault("bit_identical_to_parent", []).append(
        {"name": name, "case": case, "equal": same})
    print(f"[parent] {name:17s} {case:46s} bit for bit the parent's: {same}", flush=True)
    if not same:
        raise SmokeFailure(f"{name} {case}: the output differs from the parent's body")


def against_parent(results, name, case, this_fn, parent_fn) -> None:
    """With ``--parent``: the parent's body and this tree's on the same
    inputs, device-only, timed parent, this, this, parent."""
    if PARENT is None:
        return
    fns = {"parent": parent_fn, "this": this_fn}
    t = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        t[who].append(device_ms(fns[who]))
    results.setdefault("against_parent", []).append(
        {"name": name, "case": case, "parent_device_ms": t["parent"], "device_ms": t["this"]})
    print(f"[parent] {name:17s} {case:46s} parent {t['parent'][0]:.4f} / {t['parent'][1]:.4f} "
          f"ms, this tree {t['this'][0]:.4f} / {t['this'][1]:.4f} ms (device)", flush=True)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _table(gen, K, v_pad, d, dtype, empty_expert=None):
    """A packed-table stand-in: expert e holds a random number of real
    rows (ids >= 0) followed by padding (-1); ``empty_expert`` is all
    padding."""
    import torch

    dev = "cuda"
    w = torch.randn((K, v_pad, d), generator=gen, device=dev).mul_(d ** -0.5).to(dtype)
    sizes = torch.randint(v_pad * 3 // 4, v_pad + 1, (K,), generator=gen, device=dev)
    if empty_expert is not None:
        sizes[empty_expert] = 0
    pos = torch.arange(v_pad, device=dev)
    ids = torch.randperm(K * v_pad, generator=gen, device=dev).reshape(K, v_pad)
    ids = torch.where(pos[None, :] < sizes[:, None], ids, -1).to(torch.int32)
    w = torch.where((ids >= 0)[..., None], w, torch.zeros((), dtype=dtype, device=dev))
    return w.contiguous(), ids


def _parted_rows(label, gv, gi, wv, wi, rtol=TIE_RTOL) -> int:
    """Top-k rows (last axis) whose ids differ between a kernel and its
    plain version; each must part only at a near-tie (``rtol`` of the row's
    plain top-1, ``_topk_parts_only_at_ties``). Returns their number."""
    import torch

    k = gi.shape[-1]
    gv, gi, wv, wi = (x.reshape(-1, k) for x in (gv, gi, wv, wi))
    rows = torch.nonzero((gi != wi).any(1))[:, 0].tolist()
    for r in rows:
        _topk_parts_only_at_ties(f"{label} row {r}", gv[r], gi[r], wv[r], wi[r],
                                 rtol * abs(float(wv[r, 0])))
    return len(rows)


def _compare(name, case, got, want, rtol=VAL_RTOL, atol=VAL_ATOL):
    """Max |value difference| over entries both report finite, and the
    number of top-k rows whose ids part from the plain version's; raise
    unless sentinels agree, ids agree but at near-ties (``_parted_rows``;
    a 1-D result, the gate's expert ids, exactly) and values are within
    tolerance. The kernels sum in another order than the plain version (the
    tensor-core bodies inside wgmma), so on random data two classes within
    fp32 rounding of each other may swap."""
    import torch

    (gv, gi), (wv, wi) = got, want
    fin = torch.isfinite(wv)
    if not torch.equal(fin, torch.isfinite(gv)):
        raise SmokeFailure(f"{name} {case}: non-finite entries differ from the plain version")
    diff = (gv[fin] - wv[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if gi.dim() == 1:
        if not torch.equal(gi, wi):
            raise SmokeFailure(f"{name} {case}: {int((gi != wi).sum())} ids differ from the "
                               "plain version")
        parted = 0
    else:
        parted = _parted_rows(f"{name} {case}", gv, gi, wv, wi)
    if not torch.allclose(gv[fin], wv[fin], rtol=rtol, atol=atol):
        raise SmokeFailure(f"{name} {case}: values differ by up to {err}")
    return err, parted


def kernel_times(kernel, plain, library) -> dict:
    """The times of one case: the kernel's wrapper, its plain version and
    the library call as the host calls them (``time_ms``); the wrapper and
    the library call on the device alone (``device_ms``); the wrapper's
    host µs per call (``host_us``)."""
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain), "library_ms": time_ms(library),
            "device_ms": device_ms(kernel), "library_device_ms": device_ms(library),
            "host_us": host_us(kernel)}


def _times_text(t: dict) -> str:
    return (f"kernel {t['ms']:9.4f} ms (device {t['device_ms']:9.4f}, host {t['host_us']:6.1f} "
            f"us)  plain {t['plain_ms']:9.4f} ms  library {t['library_ms']:9.4f} ms (device "
            f"{t['library_device_ms']:9.4f})")


def report_case(results, name, case, got, want, times, nbytes, flops, dtype, main=False,
                rtol=VAL_RTOL, atol=VAL_ATOL):
    """Check one kernel case against its plain version and record its
    times (``kernel_times``) and bound (``main``: the shape the main path
    gives the body)."""
    from repro_torch.kernels import ops

    err, parted = _compare(name, case, got, want, rtol, atol)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    row = {"name": name, "case": case, **times, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "rows_parted_at_ties": parted, "main_path_shape": main}
    results.setdefault("cases", []).append(row)
    print(f"[kernel] {name:17s} {case:38s} {_times_text(times)}  bound {b_ms:.4f} ms "
          f"({b_by})  max|dv| {err:.3g}  rows parted at ties {parted}  launches "
          f"{ops.launch_counts()[name]}", flush=True)
    if main:
        results.setdefault("main", {})[name] = row


def _grouped():
    """The grouped kernel's wrapper module (``select_body``, ``launch_body``,
    the body names); the package binds the name ``dss_topk_grouped`` to the
    wrapper function itself."""
    return importlib.import_module("repro_torch.kernels.dss_topk_grouped")


def kernel_split(results, name, fn) -> None:
    """The kernels of one wrapper call on the device, by the profiler (over
    GRAPH_CALLS calls): ``results["kernels_split_ms"][name]``."""
    split = device_ms_by_op(fn, calls=GRAPH_CALLS)
    results.setdefault("kernels_split_ms", {})[name] = split
    short = {op: (re.search(r"(\w+_kernel)", op) or re.search(r"(\w+)", op)).group(1)
             for op in split}
    print(f"[kernel] {name} by kernel (device ms): "
          + "  ".join(f"{short[op]} {t:.4f}" for op, t in split.items()), flush=True)


def grouped_dispatch_case(results, gen, quantized: bool) -> None:
    """The grouped decode body on a real dispatch: B 8 tokens through
    ``gate_top1`` and the serve path's ``_group_tokens`` at C 1 (K 16, d
    1536, V_pad 12,032, k 8; bf16 rows, or their int8 table), so at most 8
    experts hold a live slot. Every slot is compared (empty ones too, no
    -inf emitted); the bound counts the live experts' rows, the live
    slots' tokens, g_buf and the outputs; the yardstick is one
    ``topk(buf[e] @ W[e]^T)`` per live expert e (u calls; int8 rows read
    as bf16)."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable, _group_tokens, quantize_table
    from repro_torch.kernels import ops, ref

    grouped = _grouped()
    K, d, v_pad, k, B, C = 16, 1536, 12032, 8, 8, 1
    bf16 = torch.bfloat16
    w, ids = _table(gen, K, v_pad, d, bf16)
    kw, name, row_extra = {}, grouped.DECODE, 0
    if quantized:
        qt = quantize_table(ServeTable(ids=ids, weights=w))
        w, kw["scales"], name, row_extra = qt.qweights, qt.scales, grouped.DECODE + "_q", 4
        del qt
    gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(bf16)
    h = torch.randn((B, d), generator=gen, device="cuda").to(bf16)
    e, g = ops.gate_top1(gw, h)
    buf, g_buf, _, _ = _group_tokens(h, g, e, K, C)
    got = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    want = ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw)
    if bool(torch.isinf(got[0]).any()):
        raise SmokeFailure(f"{name}: an internal -inf reached an output")
    live = torch.nonzero((g_buf != 0).any(1))[:, 0].tolist()
    n_live_slots = int((g_buf != 0).sum())
    yard = [(buf[x], w[x] if not quantized else w[x].to(bf16)) for x in live]
    rows_read = sum(int((ids[x] >= 0).sum()) for x in live)
    flops = 2 * sum(int((ids[x] >= 0).sum()) * int((g_buf[x] != 0).sum()) for x in live) * d
    nbytes = (rows_read * (d * w.element_size() + 4 + row_extra) + n_live_slots * d * 2
              + K * C * 4 + K * C * k * 8)
    report_case(results, name, f"{'int8 rows, ' if quantized else ''}bf16 real dispatch B={B} "
                f"C={C} u={len(live)}", got, want,
                kernel_times(lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw),
                             lambda: ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw),
                             lambda: [torch.topk(b @ we.T, k) for b, we in yard]),
                nbytes, flops, bf16)
    del yard, w


SWEEP_CAPACITIES = (1, 2, 3, 4, 8, 16, 32, 48, 64, 128, 256)


def capacity_sweep(results, gen) -> None:
    """The grouped bodies beside the decode body at every capacity of
    SWEEP_CAPACITIES on K 16, d 1536, V_pad 12,032, k 8, every slot live
    (``launch_body``): bf16 tokens on bf16 rows and their int8 table
    against the tensor-core body, fp32 tokens on fp32 rows and their int8
    table against the CUDA-core tiled body. Each run is checked against the
    plain version and timed on the device alone (``device_ms``). The bf16
    rows set ``dss_topk_grouped.TILED_ABOVE``, the fp32 rows
    ``SIMT_TILED_ABOVE``: each line says which body is faster at each
    capacity and which one ``select_body`` runs."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable, quantize_table
    from repro_torch.kernels import ref

    grouped = _grouped()
    K, d, v_pad, k = 16, 1536, 12032, 8
    rows = []
    for tok, other in ((torch.bfloat16, grouped.WGMMA), (torch.float32, grouped.TILED)):
        short = "wgmma" if other == grouped.WGMMA else "tiled"
        for kind in ("fp", "int8"):
            w, ids = _table(gen, K, v_pad, d, tok)
            sc = None
            if kind == "int8":
                qt = quantize_table(ServeTable(ids=ids, weights=w))
                w, sc = qt.qweights, qt.scales
                del qt
            label = f"{str(tok)[6:]} tokens, {'int8' if sc is not None else str(tok)[6:]} rows"
            for C in SWEEP_CAPACITIES:
                buf = torch.randn((K, C, d), generator=gen, device="cuda").to(tok)
                g_buf = torch.rand((K, C), generator=gen, device="cuda") + 0.01
                want = ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, scales=sc)
                t, parted = {}, {}
                for body in (grouped.DECODE, other):
                    run = functools.partial(grouped.launch_body, w, ids, buf, g_buf, k, sc, body)
                    parted[body] = _compare(body, f"sweep {label} C={C}", run(), want)[1]
                    t[body] = device_ms(run)
                row = {"tokens": str(tok)[6:], "rows": str(tok)[6:] if kind == "fp" else "int8",
                       "C": C, "decode_ms": t[grouped.DECODE],
                    f"{short}_ms": t[other], "select_body": grouped.select_body(C, tok),
                    "rows_parted_at_ties": parted}
                rows.append(row)
                print(f"[sweep] {label} C={C:3d}: decode {t[grouped.DECODE]:9.4f} ms  {short} "
                      f"{t[other]:9.4f} ms (device)  faster: "
                      f"{'decode' if t[grouped.DECODE] <= t[other] else short}; "
                      f"select_body runs {row['select_body']}", flush=True)
                del buf, want
            del w
    results["capacity_sweep"] = rows


def kernel_phase(results: dict) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    grouped = _grouped()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    K, d, k = 16, 1536, 8
    bf16, f32 = torch.bfloat16, torch.float32
    report = functools.partial(report_case, results)

    # -- gate_top1 --------------------------------------------------------
    for dtype, B, main in ((bf16, 8, True), (bf16, 2048, False), (f32, 8, False)):
        gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
        h = torch.randn((B, d), generator=gen, device="cuda").to(dtype)
        got = ops.gate_top1(gw, h)
        want = ref.gate_top1_ref(gw, h)
        eb = h.element_size()
        report("gate_top1", f"{str(dtype)[6:]} B={B} K={K} d={d}",
               (got[1], got[0]), (want[1], want[0]),
               kernel_times(lambda: ops.gate_top1(gw, h),
                            lambda: ref.gate_top1_ref(gw, h),
                            lambda: torch.softmax(h.float() @ gw.float().T, -1).max(-1)),
               (B * d + K * d) * eb + B * 8, 2 * B * K * d, dtype, main)

    # -- dss_topk_grouped: each case runs the body select_body names ------
    cases = (
        # decode: B = 8 slots, capacity round(8/16*2) = 1, every slot live
        (bf16, 1, 12032, None, True),
        # prefill-sized batch B = 2048 at cf 2.0 → C = 256 (the tensor-core
        # body); one expert all padding and a v_pad that no 128-row tile
        # divides
        (bf16, 256, 12000, 3, False),
        # the fp32 batch path's shape (the CUDA-core tiled body)
        (f32, 256, 12032, None, True),
    )
    for dtype, C, v_pad, empty, main in cases:
        w, ids = _table(gen, K, v_pad, d, dtype, empty)
        buf = torch.randn((K, C, d), generator=gen, device="cuda").to(dtype)
        g_buf = torch.rand((K, C), generator=gen, device="cuda")
        got = ops.dss_topk_grouped(w, ids, buf, g_buf, k)
        want = ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k)
        if empty is not None:
            pad = got[1][empty]
            if not (bool((pad == -1).all()) and bool((got[0][empty] == -1e9).all())):
                raise SmokeFailure("dss_topk_grouped: the all-padding expert must emit (-1e9, -1)")
        eb = w.element_size()
        real_rows = int((ids >= 0).sum())
        case = f"{str(dtype)[6:]} C={C} v_pad={v_pad}" + (f" empty e{empty}" if empty is not None else "")
        name = grouped.select_body(C, dtype)
        report(name, case, got, want,
               kernel_times(lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k),
                            lambda: ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k),
                            lambda: torch.topk(torch.bmm(buf, w.transpose(1, 2)), k)),
               real_rows * (d * eb + 4) + K * C * (d * eb + 4) + K * C * k * 8,
               2 * C * real_rows * d, dtype, main)
        if main and name == grouped.DECODE:
            kernel_split(results, name, lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k))
    del w, buf

    # -- dss_topk_fused and dss_topk_fused_q -----------------------------
    from repro_torch.core.dssoftmax import ServeTable, quantize_table

    def fused_case(name, gw, w, ids, h, e_base, K_loc, main, scales=None):
        """One fused case against its plain version; the yardstick is one
        topk(h[idx_e] @ W[e]^T) per distinct chosen expert e (u calls, the
        rows the kernel reads; int8 rows read as bf16), index lists made
        outside the timed call."""
        kw = {} if scales is None else {"scales": scales}
        got = ops.dss_topk_fused(gw, w, ids, h, k, e_base=e_base, **kw)
        want = ref.dss_topk_fused_ref(gw, w, ids, h, k, e_base, scales=scales)
        if not torch.equal(got[2], want[2]):
            raise SmokeFailure(f"{name}: expert ids differ from the plain version")
        local = want[2].long() - e_base
        mine = (local >= 0) & (local < K_loc)
        if e_base and not (bool((got[1][~mine] == -1).all()) and bool(mine.any())):
            raise SmokeFailure(f"{name}: foreign tokens must emit id -1")
        if bool(torch.isinf(got[0][mine]).any()):
            raise SmokeFailure(f"{name}: an internal -inf reached a served token")
        sel = torch.unique(local[mine]).tolist()
        yard = [(torch.nonzero(local == e)[:, 0],
                 w[e] if scales is None else w[e].to(torch.bfloat16)) for e in sel]
        rows_read = sum(int((ids[e] >= 0).sum()) for e in sel)
        flops = 2 * h.shape[0] * gw.shape[0] * d + 2 * sum(
            int((ids[e] >= 0).sum()) for e in local[mine].tolist()) * d
        row_bytes = d * w.element_size() + 4 + (4 if scales is not None else 0)  # + id, scale
        dt = h.dtype
        report(name, f"{'int8 rows, ' if scales is not None else ''}{str(dt)[6:]} "
               f"B={h.shape[0]} e_base={e_base} K={K_loc} u={len(yard)}", got[:2], want[:2],
               kernel_times(lambda: ops.dss_topk_fused(gw, w, ids, h, k, e_base=e_base, **kw),
                            lambda: ref.dss_topk_fused_ref(gw, w, ids, h, k, e_base,
                                                           scales=scales),
                            lambda: [torch.topk(h[i] @ we.T, k) for i, we in yard]),
               rows_read * row_bytes + (h.shape[0] + gw.shape[0]) * d * h.element_size()
               + h.shape[0] * (k * 8 + 4), flops, dt, main)
        del yard
        if main:
            kernel_split(results, name, lambda: ops.dss_topk_fused(gw, w, ids, h, k,
                                                                   e_base=e_base, **kw))

    v_pad = 12032
    cases = ((bf16, 8, 0, K, True), (bf16, 1, 0, K, False), (bf16, 128, 0, K, False),
             (f32, 8, 0, K, False),
             # the local half of a 16-expert gate: e_base 8, K 8
             (bf16, 128, 8, K // 2, False))
    for dtype, B, e_base, K_loc, main in cases:
        gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
        w, ids = _table(gen, K_loc, v_pad, d, dtype)
        h = torch.randn((B, d), generator=gen, device="cuda").to(dtype)
        fused_case("dss_topk_fused", gw, w, ids, h, e_base, K_loc, main)
    del w
    # int8 rows, bf16 gate and tokens
    gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(bf16)
    w, ids = _table(gen, K, v_pad, d, bf16)
    qt = quantize_table(ServeTable(ids=ids, weights=w))
    del w
    for B, main in ((8, True), (1, False), (128, False)):
        h = torch.randn((B, d), generator=gen, device="cuda").to(bf16)
        fused_case("dss_topk_fused_q", gw, qt.qweights, ids, h, 0, K, main, scales=qt.scales)
    del qt

    # -- dss_topk_grouped_q: int8 rows, bf16 tokens (decode at C 1, the
    # tensor-core body at C 256) and fp32 tokens (the tiled body at C 256,
    # the fp32 batch path's shape) ------------------------------------------
    for tok, C, v_pad, empty, main in ((bf16, 1, 12032, None, True),
                                       (bf16, 256, 12000, 3, False),
                                       (f32, 256, 12032, None, True)):
        w, ids = _table(gen, K, v_pad, d, tok, empty)
        qt = quantize_table(ServeTable(ids=ids, weights=w))
        q, sc = qt.qweights, qt.scales
        del w, qt
        qb = q.to(tok)  # the yardstick reads the rows as the tokens' type
        buf = torch.randn((K, C, d), generator=gen, device="cuda").to(tok)
        g_buf = torch.rand((K, C), generator=gen, device="cuda")
        got = ops.dss_topk_grouped(q, ids, buf, g_buf, k, scales=sc)
        want = ref.dss_topk_grouped_ref(q, ids, buf, g_buf, k, scales=sc)
        if empty is not None and not (bool((got[1][empty] == -1).all())
                                      and bool((got[0][empty] == -1e9).all())):
            raise SmokeFailure("dss_topk_grouped_q: the all-padding expert must emit (-1e9, -1)")
        real_rows = int((ids >= 0).sum())
        name = grouped.select_body(C, tok) + "_q"
        report(name,
               f"int8 rows, {str(tok)[6:]} C={C} v_pad={v_pad}"
               + (f" empty e{empty}" if empty is not None else ""),
               got, want,
               kernel_times(lambda: ops.dss_topk_grouped(q, ids, buf, g_buf, k, scales=sc),
                            lambda: ref.dss_topk_grouped_ref(q, ids, buf, g_buf, k, scales=sc),
                            lambda: torch.topk(torch.bmm(buf, qb.transpose(1, 2)), k)),
               real_rows * (d + 4 + 4) + K * C * (d * buf.element_size() + 4) + K * C * k * 8,
               2 * C * real_rows * d, tok, main)
        if main and C == 1:
            kernel_split(results, name,
                         lambda: ops.dss_topk_grouped(q, ids, buf, g_buf, k, scales=sc))
        del q, qb, buf

    # -- dss_topk: per token, fp rows, one expert with 5 real rows --------
    for dtype, main in ((bf16, True), (f32, False)):
        B, v_pad = 8, 12032
        w, ids = _table(gen, K, v_pad, d, dtype)
        ids[5, 5:] = -1
        w[5, 5:] = 0
        e = torch.randperm(K, generator=gen, device="cuda")[:B].to(torch.int32)
        e[0] = 5
        g = torch.rand((B,), generator=gen, device="cuda") * 0.5 + 0.5
        h = torch.randn((B, d), generator=gen, device="cuda").to(dtype)
        hs = (h.float() * g[:, None]).to(dtype)
        got = ops.dss_topk(w, ids, h, e, g, k)
        want = ref.dss_topk_ref(w, ids, hs, e, k)
        if not (bool((got[1][0, 5:] == -1).all()) and bool((got[0][0, 5:] == -1e9).all())):
            raise SmokeFailure("dss_topk: the tail of an expert with 5 real rows "
                               "must be (-1e9, -1)")
        el = e.long()
        eb = w.element_size()
        uniq = torch.unique(el)
        rows_read = int((ids[uniq] >= 0).sum())
        flops = 2 * sum(int((ids[x] >= 0).sum()) for x in el.tolist()) * d
        case = f"{str(dtype)[6:]} B={B} K={K} (expert 5: 5 rows)"
        report("dss_topk", case, got, want,
               kernel_times(lambda: ops.dss_topk_kernel(w, ids, hs, e, k),
                            lambda: ref.dss_topk_ref(w, ids, hs, e, k),
                            lambda: torch.topk(torch.bmm(w[el], hs[:, :, None])[:, :, 0], k)),
               rows_read * (d * eb + 4) + B * (d * eb + 4) + B * k * 8,
               flops, dtype, main)
        against_parent(results, "dss_topk", case, lambda: ops.dss_topk_kernel(w, ids, hs, e, k),
                       lambda: parent_dss_topk(w, ids, hs, e, k))

    del w, h, hs
    pertoken_shared_cases(results)

    # -- lasso_prune: fp32 rows, half of them alive; the full-width bf16
    # head comes in lasso_phase, once the model exists
    w = torch.randn((K, 16384, d), generator=gen, device="cuda").mul_(d ** -0.5)
    mask = torch.rand((K, 16384), generator=gen, device="cuda") < 0.5
    lasso_case(results, "N=16384, half alive", w, mask, main=False)
    del w, mask
    flash_cases(results, gen)
    head_path_step(results, gen)
    grouped_cases(results)


def pertoken_shared_cases(results) -> None:
    """dss_topk where tokens share experts: B 64 and 300 bf16 tokens on
    random experts of the K 16 table (d 1536, V_pad 12,032, k 8), on a
    generator of their own (so every later case draws the inputs it always
    drew). Every expert is read once per group of its tokens; the bound
    counts each needed expert's rows once; the yardstick is one
    ``topk(hs[idx_e] @ W[e]^T)`` per distinct expert (u calls, index lists
    made outside the timed call)."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    K, d, k, v_pad, bf16 = 16, 1536, 8, 12032, torch.bfloat16
    w, ids = _table(gen, K, v_pad, d, bf16)
    for B in (64, 300):
        e = torch.randint(0, K, (B,), generator=gen, device="cuda").to(torch.int32)
        hs = torch.randn((B, d), generator=gen, device="cuda").to(bf16)
        got = ops.dss_topk_kernel(w, ids, hs, e, k)
        want = ref.dss_topk_ref(w, ids, hs, e, k)
        if bool(torch.isinf(got[0]).any()):
            raise SmokeFailure(f"dss_topk B={B}: an internal -inf reached an output")
        el = e.long()
        uniq = torch.unique(el).tolist()
        yard = [(torch.nonzero(el == x)[:, 0], w[x]) for x in uniq]
        real = (ids >= 0).sum(1)
        case = f"bf16 B={B} K={K} shared experts u={len(uniq)}"
        report_case(results, "dss_topk", case, got, want,
                    kernel_times(lambda: ops.dss_topk_kernel(w, ids, hs, e, k),
                                 lambda: ref.dss_topk_ref(w, ids, hs, e, k),
                                 lambda: [torch.topk(hs[i] @ we.T, k) for i, we in yard]),
                    int(real[uniq].sum()) * (d * 2 + 4) + B * (d * 2 + 4) + B * k * 8,
                    2 * int(real[el].sum()) * d, bf16)
        against_parent(results, "dss_topk", case, lambda: ops.dss_topk_kernel(w, ids, hs, e, k),
                       lambda: parent_dss_topk(w, ids, hs, e, k))
        del got, want, yard
        torch.cuda.empty_cache()


def grouped_cases(results) -> None:
    """The grouped kernel's cases that the earlier phase-2 cases did not
    have, on a generator of their own (so every earlier case draws the
    inputs it always drew): the tensor-core bodies' main cases at the batch
    path's shape (C 256, V_pad 12,032), the decode bodies on a real
    dispatch, and the capacity sweep."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable, quantize_table
    from repro_torch.kernels import ops, ref

    grouped = _grouped()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    K, d, v_pad, k, C = 16, 1536, 12032, 8, 256
    bf16 = torch.bfloat16
    for quantized in (False, True):
        w, ids = _table(gen, K, v_pad, d, bf16)
        sc, row_extra, yard_w = None, 0, w
        if quantized:
            qt = quantize_table(ServeTable(ids=ids, weights=w))
            w, sc, row_extra, yard_w = qt.qweights, qt.scales, 4, qt.qweights.to(bf16)
            del qt
        buf = torch.randn((K, C, d), generator=gen, device="cuda").to(bf16)
        g_buf = torch.rand((K, C), generator=gen, device="cuda")
        name = grouped.select_body(C, bf16) + ("_q" if quantized else "")
        real_rows = int((ids >= 0).sum())
        report_case(results, name, f"{'int8 rows, ' if quantized else ''}bf16 C={C} "
                    f"v_pad={v_pad} (batch path)",
                    ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc),
                    ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, scales=sc),
                    kernel_times(lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc),
                                 lambda: ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k,
                                                                  scales=sc),
                                 lambda: torch.topk(torch.bmm(buf, yard_w.transpose(1, 2)), k)),
                    real_rows * (d * w.element_size() + 4 + row_extra) + K * C * (d * 2 + 4)
                    + K * C * k * 8, 2 * C * real_rows * d, bf16, main=True)
        case = f"{'int8 rows, ' if quantized else ''}C={C} v_pad={v_pad}"
        bit_identical_to_parent(results, name, case,
                                ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc),
                                lambda: parent_grouped_wgmma(w, ids, buf, g_buf, k, sc))
        against_parent(results, name, case,
                       lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc),
                       lambda: parent_grouped_wgmma(w, ids, buf, g_buf, k, sc))
        del w, yard_w, buf
    grouped_head_cases(results)
    for quantized in (False, True):
        grouped_dispatch_case(results, gen, quantized)
    capacity_sweep(results, gen)
    for quantized in (False, True):
        tiled_dispatch_case(results, gen, quantized)
    tiled_schedule(results, gen)


# The tensor-core grouped body at a speculative verify step's head (B 40:
# 8 slots, gamma 4; capacity factor 2): qwen2-1.5b's and the wide heads of
# phase 6b (c), V_pad from their stand-in masks. (name, K, C, d, V_pad)
VERIFY_HEADS = (("qwen2-1.5b", 16, 5, 1536, 12032), ("llama3.2-3b", 16, 5, 3072, 10112),
                ("granite-20b", 8, 10, 6144, 7808), ("deepseek-67b", 8, 10, 8192, 16128),
                ("olmoe-1b-7b", 8, 10, 2048, 7936), ("qwen3-moe-235b-a22b", 16, 5, 4096, 12032),
                ("internvl2-26b", 8, 10, 6144, 14592))


def grouped_head_cases(results) -> None:
    """The tensor-core grouped body at VERIFY_HEADS on seeded stand-in
    tables (every slot live), fp and int8 rows: against its plain version
    (ids equal but at near-ties), device-only ms, and with ``--parent`` the
    parent's body on the same inputs (bit for bit, and timed parent, this,
    this, parent), on a generator of their own."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable, quantize_table
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    k, bf16 = 8, torch.bfloat16
    for arch, K, C, d, v_pad in VERIFY_HEADS:
        w, ids = _table(gen, K, v_pad, d, bf16)
        buf = torch.randn((K, C, d), generator=gen, device="cuda").to(bf16)
        g_buf = torch.rand((K, C), generator=gen, device="cuda")
        for quantized in (False, True):
            sc = None
            if quantized:
                qt = quantize_table(ServeTable(ids=ids, weights=w))
                w, sc = qt.qweights, qt.scales
                del qt
            name = _grouped().select_body(C, bf16) + ("_q" if quantized else "")
            case = f"{arch} head{', int8 rows' if quantized else ''} C={C} d={d} v_pad={v_pad}"
            got = ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc)
            err, parted = _compare(name, case, got,
                                   ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, scales=sc))
            dev = device_ms(lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc))
            plan = _grouped().wgmma_plan(K, C, v_pad, k, quantized)
            results.setdefault("verify_heads", []).append(
                {"name": name, "case": case, "device_ms": dev, "max_abs_err": err,
                 "rows_parted_at_ties": parted, "plan": plan._asdict()})
            print(f"[kernel] {name:17s} {case:50s} device {dev:.4f} ms  max|dv| {err:.3g}  rows "
                  f"parted at ties {parted}  plan {tuple(plan)}", flush=True)
            bit_identical_to_parent(results, name, case, got,
                                    lambda: parent_grouped_wgmma(w, ids, buf, g_buf, k, sc))
            against_parent(results, name, case,
                           lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k, scales=sc),
                           lambda: parent_grouped_wgmma(w, ids, buf, g_buf, k, sc))
        del w, buf
    torch.cuda.empty_cache()


def tiled_schedule(results, gen) -> None:
    """The tiled body's schedule against chunks of one size, in the same
    run: fp32 tokens at C 256 (K 16, d 1536, V_pad 12,032, k 8) on fp32 rows
    and their int8 table, every slot live and on a real dispatch (B 2048
    through ``gate_top1``), each through ``launch_body`` with its plan
    (chunks of one row tile for the last waves of items) and with
    ``tiled_plan(..., tail_waves=0)``, timed interleaved (plan, uniform,
    uniform, plan; device-only). Both must give the same outputs."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable, _group_tokens, quantize_table
    from repro_torch.kernels import ops

    grouped = _grouped()
    K, d, v_pad, k, B = 16, 1536, 12032, 8, BATCH_B
    C = int(max(1, round(B / K * 2.0)))
    w32, ids = _table(gen, K, v_pad, d, torch.float32)
    qt = quantize_table(ServeTable(ids=ids, weights=w32))
    buf = torch.randn((K, C, d), generator=gen, device="cuda")
    g_buf = torch.rand((K, C), generator=gen, device="cuda") + 0.01
    gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5)
    h = torch.randn((B, d), generator=gen, device="cuda")
    e, g = ops.gate_top1(gw, h)
    rbuf, rg, _, _ = _group_tokens(h, g, e, K, C)
    rows = []
    for kind, w, sc in (("fp32", w32, None), ("int8", qt.qweights, qt.scales)):
        plans = {"plan": grouped.tiled_plan(K, C, v_pad, k, sc is not None),
                 "uniform": grouped.tiled_plan(K, C, v_pad, k, sc is not None, tail_waves=0)}
        for traffic, (b, gb) in (("every slot live", (buf, g_buf)), ("real dispatch", (rbuf, rg))):
            runs = {name: functools.partial(grouped.launch_body, w, ids, b, gb, k, sc,
                                            grouped.TILED, plan)
                    for name, plan in plans.items()}
            got = {name: run() for name, run in runs.items()}
            if not all(torch.equal(x, y) for x, y in zip(got["plan"], got["uniform"])):
                raise SmokeFailure(f"tiled schedule ({kind} rows, {traffic}): the two plans "
                                   "disagree")
            t = {name: [] for name in runs}
            for name in ("plan", "uniform", "uniform", "plan"):
                t[name].append(device_ms(runs[name]))
            row = {"rows": kind, "traffic": traffic, "plan": list(plans["plan"]),
                   "uniform": list(plans["uniform"]), "plan_ms": t["plan"],
                   "uniform_ms": t["uniform"]}
            rows.append(row)
            print(f"[schedule] tiled, fp32 tokens, {kind} rows, C={C}, {traffic}: plan "
                  f"{tuple(plans['plan'][:5])} {t['plan'][0]:.4f} / {t['plan'][1]:.4f} ms, "
                  f"one chunk size {tuple(plans['uniform'][:5])} {t['uniform'][0]:.4f} / "
                  f"{t['uniform'][1]:.4f} ms (device)", flush=True)
    results["tiled_schedule"] = rows
    del w32, qt, buf, rbuf


def tiled_dispatch_case(results, gen, quantized: bool) -> None:
    """The CUDA-core tiled body on a real dispatch: B 2048 fp32 tokens
    through ``gate_top1`` and the serve path's ``_group_tokens`` at C 256
    (K 16, d 1536, V_pad 12,032, k 8; fp32 rows, or their int8 table), the
    fp32 batch path's buffers, where some token tiles hold no live slot.
    Every slot is compared (empty ones too, no -inf emitted). The bound
    counts what this dispatch needs: the products of the live slots with
    their experts' real rows at the fp32 rate, and the bytes of those rows,
    the live slots' tokens, g_buf and the outputs; the yardstick stays one
    fp32 ``topk(bmm(buf, W^T))`` over (K, C, d)."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable, _group_tokens, quantize_table
    from repro_torch.kernels import ops, ref

    grouped = _grouped()
    K, d, v_pad, k, B = 16, 1536, 12032, 8, BATCH_B
    C = int(max(1, round(B / K * 2.0)))
    f32 = torch.float32
    w, ids = _table(gen, K, v_pad, d, f32)
    kw, yard_w, row_extra = {}, w, 0
    if quantized:
        qt = quantize_table(ServeTable(ids=ids, weights=w))
        w, kw["scales"], yard_w, row_extra = qt.qweights, qt.scales, qt.qweights.float(), 4
        del qt
    gw = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5)
    h = torch.randn((B, d), generator=gen, device="cuda")
    e, g = ops.gate_top1(gw, h)
    buf, g_buf, _, _ = _group_tokens(h, g, e, K, C)
    name = grouped.select_body(C, f32) + ("_q" if quantized else "")
    got = ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw)
    want = ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw)
    if bool(torch.isinf(got[0]).any()):
        raise SmokeFailure(f"{name}: an internal -inf reached an output")
    live_slots = (g_buf != 0).sum(1)
    real = (ids >= 0).sum(1)
    n_tile = grouped.tiled_plan(K, C, v_pad, k).n_tile
    live_tiles = int((g_buf.view(K, C // n_tile, n_tile) != 0).any(-1).sum())
    flops = 2 * int((live_slots * real).sum()) * d
    nbytes = (int(real[live_slots > 0].sum()) * (d * w.element_size() + 4 + row_extra)
              + int(live_slots.sum()) * d * 4 + K * C * 4 + K * C * k * 8)
    report_case(results, name, f"{'int8 rows, ' if quantized else ''}fp32 real dispatch B={B} "
                f"C={C} live token tiles {live_tiles} of {K * C // n_tile}", got, want,
                kernel_times(lambda: ops.dss_topk_grouped(w, ids, buf, g_buf, k, **kw),
                             lambda: ref.dss_topk_grouped_ref(w, ids, buf, g_buf, k, **kw),
                             lambda: torch.topk(torch.bmm(buf, yard_w.transpose(1, 2)), k)),
                nbytes, flops, f32)
    results.setdefault("tiled_dispatch", {})[name] = {
        "live_slots_per_expert": live_slots.tolist(), "live_token_tiles": live_tiles,
        "token_tiles": K * C // n_tile}
    del w, yard_w, buf


def device_ms_by_op(fn, calls: int = HEAD_CALLS) -> dict:
    """Device time of one ``fn()`` in ms per device op (kernel or copy),
    from the profiler over ``calls`` calls after one warm call."""
    import torch

    def body():
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    fn()
    return {op: us / 1e3 / calls for op, us in traced("device_ms_by_op", body).by_op().items()}


def profiled_device_ms(fn, calls: int = HEAD_CALLS) -> float:
    """Device time of one ``fn()`` in ms: its device ops summed."""
    return sum(device_ms_by_op(fn, calls).values())


def head_path_step(results: dict, gen) -> None:
    """``serve_topk`` through every exact path at qwen2-1.5b's head shape
    (K 16, d 1536, V_pad 12,032, k 8): bf16 tokens on a stand-in fp table
    and its int8 table at every B of HEAD_BATCHES, and fp32 tokens on an
    fp32 copy of that table and its int8 table at every B of
    HEAD_BATCHES_FP32; the paths interleaved round-robin, each call's device
    time from the profiler (median of HEAD_ROUNDS rounds). Fails if the path
    ``auto`` picks takes more than AUTO_SLACK times the fastest, or if a
    path's ids part from the jnp path's anywhere but at a near-tie
    (``_parted_rows``: the paths sum in different orders)."""
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import registry

    K, d, v_pad, k = 16, 1536, 12032, 8
    bf16, f32 = torch.bfloat16, torch.float32
    w, ids = _table(gen, K, v_pad, d, bf16)
    fp = ds.ServeTable(ids=ids, weights=w)
    fp32 = ds.ServeTable(ids=ids, weights=w.float())
    groups = ((bf16, {"fp": fp, "int8": ds.quantize_table(fp)}, HEAD_BATCHES),
              (f32, {"fp32": fp32, "fp32 int8": ds.quantize_table(fp32)}, HEAD_BATCHES_FP32))
    gate = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(bf16)
    rows, failed = [], []
    for tok, tables, batches in groups:
        gw = gate.to(tok)
        for B in batches:
            h = torch.randn((B, d), generator=gen, device="cuda").to(tok)
            for kind, table in tables.items():
                paths = HEAD_PATHS if "int8" in kind else FP_HEAD_PATHS
                want = ds.serve_topk(gw, table, h, k, kernel="jnp")
                # cuda_pertoken rounds g·h to the token dtype before the product
                parted = {path: _parted_rows(f"head path {path} ({kind}, B={B})",
                                             *ds.serve_topk(gw, table, h, k, kernel=path), *want,
                                             rtol=FOLD_RTOL if path == "cuda_pertoken"
                                             and tok == bf16 else TIE_RTOL)
                          for path in paths}
                del want
                times = {path: [] for path in paths}
                for _ in range(HEAD_ROUNDS):
                    for path in paths:
                        times[path].append(profiled_device_ms(
                            lambda: ds.serve_topk(gw, table, h, k, kernel=path)))
                for path, t in times.items():
                    if min(t) <= 0:
                        raise SmokeFailure(f"head path {path} ({kind}, B={B}): the profiler "
                                           f"saw no device time in {t}")
                med = {path: statistics.median(t) for path, t in times.items()}
                pick = registry.resolve_kernel("auto", ds.serve_kernel_context(table, h, k))
                fastest = min(med, key=med.get)
                # the tokens over capacity, which the grouped paths fix up by
                # the gather path after the kernel
                over = int(ds.serve_topk(gw, table, h, k, kernel="cuda_grouped",
                                         with_stats=True)[2]["overflow"].sum())
                row = {"table": kind, "tokens": str(tok)[6:], "B": B, "device_ms": med,
                       "grouped_overflow": over, "auto": pick, "fastest": fastest,
                       "auto_over_fastest": med[pick] / med[fastest],
                       "rows_parted_from_jnp_at_ties": parted}
                rows.append(row)
                print(f"[head] {kind:9s} B={B}: " + "  ".join(
                    f"{path} {t:.4f}" for path, t in med.items())
                    + f" ms (device)  auto -> {pick} ({row['auto_over_fastest']:.2f}x the fastest, "
                    f"{fastest}); grouped overflow {over} tokens; rows parted from jnp at "
                    f"near-ties {parted}", flush=True)
                if med[pick] > AUTO_SLACK * med[fastest]:
                    failed.append(f"{kind} B={B}: auto picks {pick}, {med[pick]:.4f} ms, against "
                                  f"{fastest} {med[fastest]:.4f} ms")
    results["head_path"] = rows
    if failed:
        raise SmokeFailure("auto's head-path pick is slow: " + "; ".join(failed))


def flash_cases(results, gen) -> None:
    """flash_attention against its plain version. Inputs are (B, S, heads,
    dh) tensors passed as (B, heads, S, dh) views, as attention_block passes
    them; each case runs the body ``select_body`` gives it, and its counter
    must rise. At the bf16 main shape the CUDA-core body also runs on the
    same inputs (``launch_body``), so both bodies are timed on one card; the
    CUDA-core body's own main shape is the fp32 prefill's. Bound: 4·dh
    flops per unmasked (query, key) pair, S(S+1)/2 pairs per head, at the
    tensor-core rate of the type (fp32: the CUDA-core rate); q, k, v read
    and o written once. The limit is per element
    (``repro_torch.testing.flash_attention_limit``): fp32 repro's 1e-4 /
    1e-5; bf16 one rounding of p, 2^-8·(softmax(s)·|v|), plus the two
    outputs' own rounding, 2^-7·|o|."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import (launch_body, select_body, simt_tile,
                                                     wgmma_schedule)
    from repro_torch.testing import flash_attention_limit

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, H, H_kv, S, dh, dtype, main, strided, forced body, generator)
    cases = [(1, 12, 2, S, 128, bf16, S == 2048, False, None, gen) for S in (16, 200, 2047, 2048)]
    cases += [(1, 12, 2, 2048, 128, bf16, False, False, FLASH_SIMT, gen),
              (1, 12, 2, 2048, 128, f32, True, False, None, gen),
              (1, 2, 2, 256, 64, f32, False, False, None, gen),
              (1, 12, 2, 1000, 128, bf16, False, True, None, gen)]
    # the CUDA-core body's other head-dim classes, on a generator of their
    # own (so the head-path step draws what it always drew)
    own = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cases += [(1, 12, 2, 2048, dh, f32, False, False, None, own) for dh in (64, 256)]
    # the tensor-core body at the other configs' attention: llama3.2-3b
    # (24 / 8 heads, S 2048), granite-20b (48 / 1, S 1024), lm-100m (dh 64,
    # 12 / 4, S 512), olmoe-1b-7b (16 / 16, S 2048), qwen3-moe-235b-a22b
    # (64 / 4, S 1024) and internvl2-26b (48 / 8, S 512: 256 patches + 256
    # tokens), on a generator of their own too
    wide = torch.Generator(device="cuda").manual_seed(SEED + 17)
    cases += [(1, H, H_kv, S, dh, bf16, False, False, None, wide)
              for H, H_kv, S, dh in ((24, 8, 2048, 128), (48, 1, 1024, 128), (12, 4, 512, 64),
                                     (16, 16, 2048, 128), (64, 4, 1024, 128),
                                     (48, 8, 512, 128))]
    for B, H, H_kv, S, dh, dtype, main, strided, forced, case_gen in cases:
        if strided:  # every other position of wider buffers, dh sliced out
            qb = torch.randn((B, 2 * S, H, dh + 32), generator=case_gen, device="cuda").to(dtype)
            kvb = torch.randn((B, 2 * S, H_kv, 2, dh), generator=case_gen, device="cuda").to(dtype)
            q = qb[:, ::2, :, 16:16 + dh].transpose(1, 2)
            k, v = (kvb[:, ::2, :, j].transpose(1, 2) for j in (0, 1))
        else:
            q, k, v = (torch.randn((B, S, h, dh), generator=case_gen, device="cuda").to(dtype)
                       .transpose(1, 2) for h in (H, H_kv, H_kv))
        body = forced or select_body(q, k, v)
        if forced is None and (body == FLASH_TC) != (dtype == bf16):
            raise SmokeFailure(f"flash_attention S={S} {dtype}: the rule chose {body}")

        def run():
            return launch_body(q, k, v, forced) if forced else ops.flash_attention(q, k, v)

        before = ops.launch_counts()
        got = run()
        after = ops.launch_counts()
        if after[body] != before[body] + 1 or sum(after.values()) != sum(before.values()) + 1:
            raise SmokeFailure(f"flash_attention S={S} {dtype}: {body} did not launch once")
        want = ref.flash_attention_ref(q, k, v)
        diff = (got.float() - want.float()).abs()
        limit = flash_attention_limit(q, k, v, want)
        err, used = float(diff.max()), float((diff / limit).max())
        # how wide the limit is against the values it holds
        width = float(limit.median() / want.float().abs().median())
        if used > 1.0:
            raise SmokeFailure(f"{body} S={S} {dtype}: differs from the plain version by up "
                               f"to {err}, {used:.3g} of the limit")
        times = kernel_times(run, lambda: ref.flash_attention_ref(q, k, v),
                             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                    enable_gqa=True))
        eb = q.element_size()
        b_ms, b_by = bound_ms(B * S * dh * eb * (2 * H + 2 * H_kv),
                              4 * dh * B * H * S * (S + 1) / 2, dtype)
        case = (f"{str(dtype)[6:]} B={B} H={H} H_kv={H_kv} S={S} dh={dh}"
                + (" strided views" if strided else "") + (" (forced)" if forced else ""))
        row = {"name": body, "case": case, **times, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": err, "limit_used": used, "median_limit_over_median_o": width,
               "main_path_shape": main}
        if main or forced:  # the launch alone, without the wrapper's checks and rule
            row["host_us_launch_only"] = host_us(lambda: launch_body(q, k, v, body))
        if body == FLASH_SIMT:  # the build the CUDA-core body launches
            row["simt_tile"] = simt_tile(dh, dtype)._asdict()
        if body == FLASH_TC:  # the schedule's makespan in kv-tile steps, and each one's µs
            # the grid the kernel launched: one block per SM of this card
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            steps = max(sum(qt + 1 for qt, _, _ in blk) for blk in wgmma_schedule(B, H, S, sms))
            row["makespan_kv_steps"] = steps
            row["us_per_kv_step"] = times["device_ms"] * 1e3 / steps
        results.setdefault("cases", []).append(row)
        if main:
            results.setdefault("main", {})[body] = row
        print(f"[kernel] {body:21s} {case:46s} {_times_text(times)}  bound {b_ms:.4f} ms "
              f"({b_by})  max|do| {err:.3g} ({used:.3g} of the limit; median limit "
              f"{width:.3g} of the median |o|)"
              + (f"; launch alone {row['host_us_launch_only']:.1f} us on the host"
                 if "host_us_launch_only" in row else "")
              + (f"; tile {tuple(row['simt_tile'].values())}" if "simt_tile" in row else "")
              + (f"; {row['us_per_kv_step']:.3f} us per kv-tile step over a makespan of "
                 f"{row['makespan_kv_steps']}" if "makespan_kv_steps" in row else ""),
              flush=True)
        if body == FLASH_SIMT and S == 2048:
            against_parent(results, body, case, run, lambda: parent_flash(q, k, v, FLASH_SIMT))
        if body == FLASH_TC:  # every case of the tensor-core body
            bit_identical_to_parent(results, body, case, got,
                                    lambda: parent_flash(q, k, v, FLASH_TC))
            against_parent(results, body, case, run, lambda: parent_flash(q, k, v, FLASH_TC))
        del q, k, v, got, want, diff, limit
    torch.cuda.empty_cache()


def lasso_case(results, case, w, mask, main, q=PRUNE_QUANTILE) -> float:
    """``lasso_prune`` against its plain version on (w, mask) at a threshold
    near the q-quantile of the alive rows' norms; returns the threshold.
    Bound: the alive rows' bytes (a masked row is never read), the mask
    read, the norms and new mask written; one fp32 multiply-add per alive
    element."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.testing import FP32_SAFE_GAP, gamma_between

    K, N, d = w.shape
    norms = ref.lasso_prune_ref(w, mask, 0.0)[0]
    gamma = gamma_between(norms, mask, q, rel_gap=FP32_SAFE_GAP)
    quantile = float((norms[mask] < gamma).double().mean())
    del norms
    # the main path's threshold is the one the adapt phase prunes at; with
    # every row alive (2.4M norms) ties leave no safe gap near q
    if main and abs(quantile - q) > PRUNE_SLACK:
        raise SmokeFailure(f"lasso_prune {case}: the nearest safe gap lies at the "
                           f"{quantile:.5f} quantile, not near {q}")
    got = ops.lasso_prune(w, mask, gamma)
    want = ref.lasso_prune_ref(w, mask, gamma)
    if bool((got[0][~mask] != 0).any()):
        raise SmokeFailure(f"lasso_prune {case}: a masked row's norm is not 0")
    if not 0 < int(want[1].sum()) < int(mask.sum()):
        raise SmokeFailure(f"lasso_prune {case}: the threshold prunes no row or every row")
    alive = int(mask.sum())
    report_case(results, "lasso_prune", f"{str(w.dtype)[6:]} {case}", got, want,
                kernel_times(lambda: ops.lasso_prune(w, mask, gamma),
                             lambda: ref.lasso_prune_ref(w, mask, gamma),
                             lambda: torch.linalg.vector_norm(w, dim=-1,
                                                              dtype=torch.float32) * mask),
                alive * d * w.element_size() + K * N * (1 + 4 + 1), 2 * alive * d,
                torch.float32, main, LASSO_RTOL, LASSO_ATOL)
    results["cases"][-1].update(gamma=gamma, gamma_quantile=quantile,
                                rows_pruned=alive - int(want[1].sum()))
    print(f"[kernel] lasso_prune       threshold {gamma:.7g}: the nearest 8-ulp gap to the "
          f"{q:.2f} quantile lies at the {quantile:.5f} quantile of the {alive} alive "
          f"rows' norms; {alive - int(want[1].sum())} rows fall below it", flush=True)
    return gamma


def lasso_phase(results, head_w, mask) -> float:
    """Phase 2's full-width lasso_prune cases, on the model's seeded head:
    the stand-in mask (the main path's input), then every row alive.
    Returns the stand-in case's threshold (the adapt phase prunes at it)."""
    import torch

    shape = "(" + ", ".join(map(str, head_w.shape)) + ")"
    gamma = lasso_case(results, f"{shape} stand-in mask", head_w, mask, main=True)
    lasso_case(results, f"{shape} every row alive", head_w, torch.ones_like(mask), main=False)
    torch.cuda.empty_cache()
    return gamma


# ---------------------------------------------------------------------------
# Phase 3: the slice
# ---------------------------------------------------------------------------

def stand_in_mask(cfg, device):
    """A seeded stand-in for a trained DS mask: each class keeps its home
    expert (a seeded permutation mod K) and, with probability 0.25, one
    more random expert; vocab-padding classes stay masked."""
    import numpy as np
    import torch

    K, V, N = cfg.ds.num_experts, cfg.vocab_size, cfg.padded_vocab
    rng = np.random.RandomState(SEED)
    home = rng.permutation(V) % K
    extra = rng.rand(V) < 0.25
    other = (home + rng.randint(1, K, V)) % K
    mask = np.zeros((K, N), bool)
    mask[home, np.arange(V)] = True
    mask[other[extra], np.arange(V)[extra]] = True
    return torch.from_numpy(mask).to(device)


_LAST_GATE: list = []  # the gate probabilities of the head's last call, when watched


def _watch_gate():
    """Wrap ``heads.head_topk`` so each call also keeps its gate
    probabilities, fp32 softmax(h·Uᵀ) as ``gate_top1`` computes them, in
    ``_LAST_GATE``; returns a function that restores the original."""
    import torch

    from repro_torch.models import heads

    orig = heads.head_topk

    def head_topk(head_params, table, cfg, h, k, **kw):
        z = h.float() @ head_params["gate"].float().T
        _LAST_GATE[:] = [torch.softmax(z, dim=-1).cpu()]
        return orig(head_params, table, cfg, h, k, **kw)

    heads.head_topk = head_topk

    def restore():
        heads.head_topk = orig
        _LAST_GATE.clear()
    return restore


class Recorder:
    """Wraps a session's model calls (``sess.bundle``'s prefill and
    prefill_chunk, and the session's decode step ``sess._decode``: the
    backbone, replayed from its CUDA graph or eager, and the head):
    synchronized wall times, the most pages in
    use at once (``stats()["paged"]``), and each request's per-emission
    (values, ids) for divergence reports. A request's prefill time is the
    sum of its model calls (one whole-prompt prefill, or its chunks); a
    resumed request's re-prefill is timed apart and its (dropped) head
    output not recorded; the chunks of a prefill the arena cut short are
    timed apart too (``aborted_s``). While :func:`_watch_gate` watches the
    head, each emission's gate probabilities are kept beside its (values,
    ids) in ``gates``. In a speculative session the session's verify step
    (``sess._verify``: the backbone, replayed or eager, and the head over
    every block) and its draft decodes (``sess._draft_decode``) are timed
    (``verify_s``, ``draft_s``), and each emitted token is recorded with
    the verify row it came from (wrapping ``sess._emit``)."""

    def __init__(self, sess, reqs):
        import numpy as np
        import torch

        self.heads = {i: [] for i in range(len(reqs))}
        self.gates = {i: [] for i in range(len(reqs))}
        self.prefill_s, self.resume_s, self.decode_s = {}, {}, []
        self.verify_s, self.draft_s = [], []
        self.aborted_s, self.peak_pages = 0.0, 0
        paged = "paged" in sess.stats()
        index = {id(r): i for i, r in enumerate(reqs)}
        bundle = sess.bundle
        pending = [0.0]  # chunk time of the prefill under way

        def timed(fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if paged:
                self.peak_pages = max(self.peak_pages,
                                      sess.stats()["paged"]["pages_in_use"])
            return out, dt

        def ends(toks, end):
            """The queued request whose prefill sequence (its prompt, or on a
            resume prompt ++ out_tokens[:-1]) ends with ``toks`` at ``end``."""
            found = []
            for r in reqs:
                if r.status.value != "queued":
                    continue
                seq = np.concatenate([np.asarray(r.prompt, np.int64).reshape(-1),
                                      np.asarray(r.out_tokens[:-1], np.int64)])
                if len(seq) == end and (seq[end - len(toks):] == toks).all():
                    found.append(r)
            if len(found) > 1:
                raise SmokeFailure("recorder: a prefill matches two queued requests")
            return found[0] if found else None

        def done(r, dt, vals, ids):
            i = index[id(r)]
            if r.out_tokens:
                self.resume_s.setdefault(i, []).append(dt)
            else:
                self.prefill_s[i] = dt
                self.heads[i].append((vals[0].cpu(), ids[0].cpu()))
                if _LAST_GATE:
                    self.gates[i].append(_LAST_GATE[0][0])

        def prefill(p, t, batch, **kw):
            out, dt = timed(bundle.prefill, p, t, batch, **kw)
            toks = batch["tokens"][0].cpu().numpy()
            r = ends(toks, len(toks))
            if r is None:
                raise SmokeFailure("recorder: a whole-prompt prefill of no queued request")
            done(r, dt, out[0], out[1])
            return out

        def prefill_chunk(p, t, cache, tokens, pos0, n_valid, **kw):
            out, dt = timed(bundle.prefill_chunk, p, t, cache, tokens, pos0, n_valid, **kw)
            pending[0] += dt
            r = ends(tokens[0, :n_valid].cpu().numpy(), int(pos0) + int(n_valid))
            if r is not None:  # the prompt's last chunk
                done(r, pending[0], out[0], out[1])
                pending[0] = 0.0
            return out

        decode_fn = sess._decode

        def decode():
            # a prefill still under way was cut short by the arena
            self.aborted_s += pending[0]
            pending[0] = 0.0
            owners = [s.req if s is not None else None for s in sess.scheduler.slots]
            out, dt = timed(decode_fn)
            self.decode_s.append(dt)
            vals, ids = out[0].cpu(), out[1].cpu()
            for b, r in enumerate(owners):
                if r is not None:
                    self.heads[index[id(r)]].append((vals[b], ids[b]))
                    if _LAST_GATE:
                        self.gates[index[id(r)]].append(_LAST_GATE[0][b])
            return out

        sess.bundle = dataclasses.replace(bundle, prefill=prefill, prefill_chunk=prefill_chunk)
        sess._decode = decode
        if sess._draft is None:
            return
        verify_fn, draft_fn, emit_fn = sess._verify, sess._draft_decode, sess._emit
        block = {}  # slot -> (its request, the unread (vals, ids, gate) rows of its block)

        def draft_decode(tok, pos):
            out, dt = timed(draft_fn, tok, pos)
            self.draft_s.append(dt)
            return out

        def verify(blocks, pos0):
            self.aborted_s += pending[0]
            pending[0] = 0.0
            owners = [s.req if s is not None else None for s in sess.scheduler.slots]
            out, dt = timed(verify_fn, blocks, pos0)
            self.verify_s.append(dt)
            vals, ids = out[0].cpu(), out[1].cpu()
            W = vals.shape[1]
            gate = _LAST_GATE[0] if _LAST_GATE else None
            block.clear()
            for b, r in enumerate(owners):
                if r is not None:
                    block[b] = (r, [(vals[b, w], ids[b, w],
                                     None if gate is None else gate[b * W + w])
                                    for w in range(W)])
            return out

        def emit(i, slot, token):
            got = block.get(i)
            if got is not None and got[0] is slot.req and got[1]:
                v, d, g = got[1].pop(0)
                self.heads[index[id(slot.req)]].append((v, d))
                if g is not None:
                    self.gates[index[id(slot.req)]].append(g)
            return emit_fn(i, slot, token)

        sess._verify, sess._draft_decode, sess._emit = verify, draft_decode, emit


def _diverge_check(label, streams, heads, kerns, ref_kern, rtol, greedy_only=False,
                   sampled=SAMPLED):
    """Each stream of ``kerns`` must equal ``ref_kern``'s, or leave it only
    at a near-tie of the reference (top-1/top-2 gap below ``rtol``
    relative); the ``sampled`` request (None: none samples) must match
    exactly unless ``greedy_only``. Prints every divergence; returns their
    count."""
    n = 0
    for kern in kerns:
        for i, (a, b) in enumerate(zip(streams[kern], streams[ref_kern])):
            if a == b or (greedy_only and i == sampled):
                continue
            n += 1
            j = next(m for m, (x, y) in enumerate(zip(a, b)) if x != y)
            rv, ri = heads[ref_kern][i][j]
            kv, ki = heads[kern][i][j]
            gap = float(rv[0] - rv[1])
            print(f"[slice] {label}: request {i} diverges at emission {j}: {ref_kern} top-2 "
                  f"{rv[:2].tolist()} ids {ri[:2].tolist()}; {kern} top-2 "
                  f"{kv[:2].tolist()} ids {ki[:2].tolist()}; gap {gap:.3g}")
            if i == sampled or gap > rtol * max(1.0, abs(float(rv[0]))):
                raise SmokeFailure(f"{label} {kern}: stream {i} diverges from {ref_kern} "
                                   f"at emission {j} without a near-tie (gap {gap})")
    return n


def slice_phase(results: dict, card: str):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    bundle = build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    table = ds.pack_experts(params["head"], ds.DSState(mask=stand_in_mask(cfg, "cuda")))
    torch.cuda.synchronize()
    n_rows = (table.ids >= 0).sum(dim=1).tolist()
    print(f"[slice] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.padded_vocab}, K {cfg.ds.num_experts}; table v_pad {table.v_pad}, rows "
          f"per expert {min(n_rows)}..{max(n_rows)}, {table.weights.nbytes / 2**30:.3f} GiB; "
          f"init + pack {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    if not (max(PROMPT_LENS) // FLASH_TILE >= 16 and any(n % FLASH_TILE for n in PROMPT_LENS)):
        raise SmokeFailure("no prompt spans 16 kernel tiles, or none ends on a ragged tile")

    def serve(label, kern, record, tbl, **session_kw):
        t0 = time.perf_counter()
        # the breaker stays off: each session serves through the kernel it names
        sess = ServeSession(bundle, params, tbl, n_slots=N_SLOTS, max_seq_len=MAX_SEQ,
                            k=K_TOP, kernel=kern, device="cuda",
                            overflow_threshold=BREAKER_OFF, **session_kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reqs = [Request(prompt=p, sampling=SamplingParams(
            max_new_tokens=NEW_TOKENS, temperature=0.8 if i == SAMPLED else 0.0,
            seed=SEED + i)) for i, p in enumerate(prompts)]
        rec = None
        if record:
            rec = Recorder(sess, reqs)
        t0 = time.perf_counter()
        sess.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = sess.stats()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != NEW_TOKENS:
                raise SmokeFailure(f"{label} {kern}: request ended {r.status} ({r.error}) "
                                   f"with {len(r.out_tokens)} tokens")
            if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
                raise SmokeFailure(f"{label} {kern}: token outside the vocabulary")
        if st["n_admitted"] != len(prompts) or st["n_admitted"] <= N_SLOTS:
            raise SmokeFailure(f"{label} {kern}: slots were not reused ({st})")
        if st["effective_kernel"] != kern or st["breaker_trips"] != 0:
            raise SmokeFailure(f"{label} {kern}: served through {st['effective_kernel']!r} "
                               f"after {st['breaker_trips']} breaker trips")
        if st["decode_graphs"] != 1:
            raise SmokeFailure(f"{label} {kern}: {st['decode_graphs']} decode graph captures")
        return [list(r.out_tokens) for r in reqs], wall, rec, st, setup_s, sess.table

    def row_of(label, kern, streams, wall, rec, delta, **extra):
        n_tok = sum(len(t) for t in streams)
        row = {"group": label, "kernel": kern, "tokens": n_tok, "wall_s": wall,
               "tokens_per_s": n_tok / wall,
               "decode_steps": len(rec.decode_s),
               "decode_step_ms_median": 1e3 * statistics.median(rec.decode_s),
               "prefill_ms_median": 1e3 * statistics.median(rec.prefill_s.values()),
               "prefill_ms_total": 1e3 * sum(rec.prefill_s.values()),
               "prefill_ms_longest": 1e3 * rec.prefill_s[PROMPT_LENS.index(max(PROMPT_LENS))],
               "launches": delta,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, **extra}
        results.setdefault("sessions", []).append(row)
        return row

    def need_launches(label, kern, quantized, delta):
        for n in NEEDS[(kern, quantized)] + (FLASH_TC,):
            if delta[n] < 1:
                raise SmokeFailure(f"{label} {kern}: kernel {n} never launched ({delta})")
        if delta[FLASH_SIMT]:
            raise SmokeFailure(f"{label} {kern}: a bf16 prefill ran the CUDA-core "
                               f"flash_attention body ({delta})")
        if kern == "jnp" and any(c for n, c in delta.items() if n not in (FLASH_TC, FLASH_SIMT)):
            raise SmokeFailure(f"{label} jnp launched head kernels ({delta})")

    # -- (fp) the slice-1 path: four serve paths on the bf16 table --------
    streams, heads = {}, {}
    ops.reset_launch_counts()  # the fp path starts here
    for kern in SESSION_KERNELS:
        before = ops.launch_counts()
        # tokens/s from run() as a user calls it; step times and the heads
        # for divergence reports from a second, instrumented run (a sync and
        # a read-back around every prefill and decode step).
        timed, wall, _, _, _, _ = serve("fp", kern, False, table)
        streams[kern], wall_rec, rec, _, _, _ = serve("fp", kern, True, table)
        if timed != streams[kern]:
            raise SmokeFailure(f"session {kern}: two runs on the same requests gave other tokens")
        delta = {n: c - before[n] for n, c in ops.launch_counts().items()}
        need_launches("fp", kern, False, delta)
        row = row_of("fp", kern, timed, wall, rec, delta,
                     tokens_per_s_instrumented=sum(map(len, timed)) / wall_rec)
        print(f"[slice] fp kernel={kern:12s} {row['tokens']} tokens in {wall:.3f} s = "
              f"{row['tokens_per_s']:.2f} tokens/s (uninstrumented run); instrumented run: "
              f"decode step median {row['decode_step_ms_median']:.2f} ms over "
              f"{row['decode_steps']} steps, prefill median {row['prefill_ms_median']:.2f} ms "
              f"(total {row['prefill_ms_total']:.1f} ms, {max(PROMPT_LENS)}-token prompt "
              f"{row['prefill_ms_longest']:.1f} ms); launches over both runs {delta}; "
              f"card {card}", flush=True)
        heads[kern] = rec.heads
    results["main_path_launches"] = {"fp": ops.launch_counts()}
    results["fp_streams"] = streams  # phase 6f's mesh sessions must emit them
    _diverge_check("fp", streams, heads, SESSION_KERNELS[:-1], "jnp", TIE_RTOL)
    print(f"[slice] fp: greedy and sampled streams agree across {', '.join(SESSION_KERNELS)}")

    # -- (int8) quantize='int8' sessions, each run once, instrumented ------
    K = cfg.ds.num_experts
    fb_half = torch.arange(K) % 2 == 1
    fb_table = ds.quantize_table(table, fb_mask=fb_half)
    groups = (("int8 (a) all rows int8", INT8_ALL_KERNELS, table,
               dict(quantize="int8", quantize_flip_threshold=1.0)),
              ("int8 (b) half fp fallback", INT8_FB_KERNELS, fb_table, {}))
    ops.reset_launch_counts()  # the int8 path starts here
    int8_table = None
    for label, kerns, tbl, kw in groups:
        g_streams, g_heads = {}, {}
        for kern in kerns:
            before = ops.launch_counts()
            g_streams[kern], wall, rec, st, setup_s, served = serve(label, kern, True, tbl, **kw)
            if not isinstance(served, ds.QuantizedServeTable):
                raise SmokeFailure(f"{label} {kern}: the session did not serve an int8 table")
            delta = {n: c - before[n] for n, c in ops.launch_counts().items()}
            need_launches(label, kern, True, delta)
            g_heads[kern] = rec.heads
            report_ = st["quantize_report"]
            row = row_of(label, kern, g_streams[kern], wall, rec, delta,
                         setup_s=setup_s, n_fallback=served.n_fallback,
                         quantize_report=report_)
            print(f"[slice] {label} kernel={kern:12s} {row['tokens']} tokens in {wall:.3f} s = "
                  f"{row['tokens_per_s']:.2f} tokens/s (instrumented run); decode step median "
                  f"{row['decode_step_ms_median']:.2f} ms over {row['decode_steps']} steps, "
                  f"prefill median {row['prefill_ms_median']:.2f} ms; session set-up "
                  f"(calibration included) {setup_s:.2f} s; {served.n_fallback} fallback "
                  f"experts; launches {delta}; card {card}", flush=True)
            if kern == "cuda_fused" and int8_table is None:
                int8_table = served
        n_div = _diverge_check(label, g_streams, g_heads, kerns[:-1], "jnp", TIE_RTOL)
        print(f"[slice] {label}: streams agree across {', '.join(kerns)} "
              f"({n_div} near-tie divergences)", flush=True)
    results["main_path_launches"]["int8"] = ops.launch_counts()

    # (c) the default exactness gate at full width
    before = ops.launch_counts()
    c_streams, wall, rec, st, setup_s, served = serve("int8 (c) gate 0.0", "auto", True,
                                                      table, quantize="int8")
    rep = st["quantize_report"]
    row_of("int8 (c) gate 0.0", "auto", c_streams, wall, rec,
           {n: c - before[n] for n, c in ops.launch_counts().items()},
           setup_s=setup_s, n_fallback=served.n_fallback, quantize_report=rep)
    print(f"[slice] int8 (c) default gate at full width: quantize_report "
          f"n_flips_raw {rep['n_flips_raw']} of {rep['n_tokens']}, n_fallback "
          f"{rep['n_fallback']} {rep['fallback_experts']}, passed {rep['passed']}; "
          f"per-expert flip rate {[round(r, 4) for r in rep['per_expert_flip_rate']]}; "
          f"set-up {setup_s:.2f} s", flush=True)
    results["quantize_report_default"] = rep
    if not rep["passed"]:
        raise SmokeFailure(f"int8 (c): the default exactness gate did not pass ({rep})")

    # -- (per-token) cuda_pertoken on the fp table -------------------------
    ops.reset_launch_counts()  # the per-token path starts here
    p_streams, wall, rec, _, _, _ = serve("per-token", "cuda_pertoken", True, table)
    delta = ops.launch_counts()
    need_launches("per-token", "cuda_pertoken", False, delta)
    results["main_path_launches"]["pertoken"] = delta
    row = row_of("per-token", "cuda_pertoken", p_streams, wall, rec, delta)
    print(f"[slice] per-token kernel=cuda_pertoken {row['tokens']} tokens in {wall:.3f} s = "
          f"{row['tokens_per_s']:.2f} tokens/s (instrumented run); decode step median "
          f"{row['decode_step_ms_median']:.2f} ms; launches {delta}; card {card}", flush=True)
    n_div = _diverge_check("per-token", {"cuda_pertoken": p_streams, "jnp": streams["jnp"]},
                           {"cuda_pertoken": rec.heads, "jnp": heads["jnp"]},
                           ("cuda_pertoken",), "jnp", FOLD_RTOL, greedy_only=True)
    print(f"[slice] per-token: stream agrees with the fp jnp session ({n_div} divergences, "
          f"each at a gap below 2^-7 relative)", flush=True)
    return cfg, bundle, params, (("cuda_fused", table), ("jnp", table),
                                 ("cuda_fused int8", int8_table))


def _batch_bodies(pick: str, body: str, quantized: bool) -> tuple:
    """The kernel bodies a batch call through ``pick`` must launch (``body``:
    the grouped kernel's body for the call's capacity and token dtype)."""
    sfx = "_q" if quantized else ""
    return {"cuda_grouped": ("gate_top1", body + sfx), "cuda_fused": ("dss_topk_fused" + sfx,),
            "cuda_pertoken": ("gate_top1", "dss_topk")}.get(pick, ())


def batch_phase(results: dict, card: str, params, cases) -> None:
    """The batch path: ``serve_topk`` over BATCH_B hidden states at once (a
    user scoring every position of a 2048-token prompt; capacity 256 at cf
    2.0, K 16), ``kernel='auto'`` whatever path it picks (reported): (bf16)
    on the slice's fp head table and its int8 table; (fp32) fp32 hidden
    states through an fp32 copy of the head table and its int8 table
    (``cuda_grouped`` runs the CUDA-core tiled bodies). Each run is held
    against the plain ``grouped`` path: ids equal but at a near-tie
    (TIE_RTOL of the row's top-1), values within VAL_ATOL + VAL_RTOL. The
    counts are set to 0 just before each group and read just after: the
    bodies of the path that ran must launch, and no other grouped body."""
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    gate = params["head"]["gate"]
    fp, i8 = cases[0][1], cases[2][1]
    fp32 = ds.ServeTable(ids=fp.ids, weights=fp.weights.float())
    groups = (("batch", "auto", ((("fp", fp), ("int8", i8)), gate.dtype)),
              ("batch_fp32", "auto",
               ((("fp32", fp32), ("fp32 int8", ds.quantize_table(fp32))), torch.float32)))
    grouped_names = {name for name, _, _ in ops.BODIES if name.startswith("dss_topk_grouped")}
    for label, kernel, (tables, dtype) in groups:
        hs = [torch.randn((BATCH_B, gate.shape[1]), generator=gen, device="cuda").to(dtype)
              for _ in tables]
        g = gate.to(dtype)
        ops.reset_launch_counts()  # this group's path starts here
        got, need = {}, set()
        for (kind, table), h in zip(tables, hs):
            ctx = ds.serve_kernel_context(table, h, K_TOP)
            pick = registry.resolve_kernel(kernel, ctx)
            need |= set(_batch_bodies(pick, registry.grouped_body(ctx), ctx.quantized))
            got[kind], t = sync_s(lambda: ds.serve_topk(g, table, h, K_TOP, kernel=kernel))
            print(f"[batch] {kind} B={BATCH_B}: {kernel} -> {pick} ({t * 1e3:.2f} ms, "
                  f"synchronized); card {card}", flush=True)
            results.setdefault("batch_picks", {})[kind] = pick
        counts = ops.launch_counts()
        results.setdefault("main_path_launches", {})[label] = counts
        missing = [name for name in need if counts[name] < 1]
        stray = [name for name in grouped_names - need if counts[name]]
        if missing or stray:
            raise SmokeFailure(f"{label}: bodies {missing} never launched, {stray} launched "
                               f"off the path ({counts})")
        for (kind, table), h in zip(tables, hs):
            (vk, ik), (vp, ip) = got[kind], ds.serve_topk(g, table, h, K_TOP, kernel="grouped")
            if not torch.allclose(vk, vp, rtol=VAL_RTOL, atol=VAL_ATOL):
                raise SmokeFailure(f"{label} {kind}: values differ from the plain grouped path "
                                   f"by up to {float((vk - vp).abs().max())}")
            rows = torch.nonzero((ik != ip).any(1))[:, 0].tolist()
            for r in rows:
                _topk_parts_only_at_ties(f"{label} {kind} row {r}", vk[r], ik[r], vp[r], ip[r],
                                         TIE_RTOL * abs(float(vp[r, 0])))
            print(f"[batch] {kind}: ids equal the plain grouped path's on {BATCH_B - len(rows)} "
                  f"of {BATCH_B} rows, the rest apart only at near-ties; launches {counts}",
                  flush=True)
    results["batch"] = {"B": BATCH_B, "picks": results["batch_picks"],
                        "launches": {k: results["main_path_launches"][k]
                                     for k in ("batch", "batch_fp32")}}


# ---------------------------------------------------------------------------
# Phase 4: where a decode step's time goes
# ---------------------------------------------------------------------------

# Kineto's results lose the device records of a profile's first launches,
# more of them as the process ages (tools/profiler_window.py on an H100: none
# in a fresh process, 26 of 75 after 7 minutes, at times all 75; a later
# launch or a host sleep after the calls does not bring them back). So
# every profile here opens with PROFILE_HEAD one-element adds that it does
# not count, and holds each launch after them to its device record by
# correlation id (``traced``).
PROFILE_HEAD, PROFILE_ATTEMPTS = 64, 4
PROFILE_CHECKS: list = []  # one row per profile: the head, the launches lost


class Trace:
    """What one sound profile saw after its head: device records (name,
    µs), host runtime calls by name, and the body's wall seconds."""

    def __init__(self, prof, head: int, wall: float):
        recs, host = {}, []
        for e in prof.profiler.kineto_results.events():
            if "cuda" in str(e.device_type()).lower():
                if not e.is_user_annotation():
                    recs.setdefault(e.correlation_id(), []).append(
                        (e.name(), e.duration_ns() / 1e3))
            else:
                host.append((e.start_ns(), e.name(), e.correlation_id()))
        host.sort()
        launches = [(n, c) for _, n, c in host if n in LAUNCH_OPS]
        skip = {c for _, c in launches[:head]}
        body = launches[head:]
        # a launch without its record, or a replay of one graph that kept
        # fewer of its kernels' records than another
        per_graph = [len(recs.get(c, ())) for n, c in body if n == "cudaGraphLaunch"]
        self.lost = (sum(1 for _, c in body if c not in recs)
                     + sum(max(per_graph) - k for k in per_graph))
        self.device = [r for c, rs in recs.items() if c not in skip for r in rs]
        self.host = {}
        for _, n, c in host:
            if c not in skip:
                self.host[n] = self.host.get(n, 0) + 1
        self.wall = wall

    def busy_us(self) -> float:
        return sum(us for _, us in self.device)

    def by_op(self) -> dict:
        """Device µs per op name (the first 80 characters)."""
        out: dict = {}
        for n, us in self.device:
            out[n[:80]] = out.get(n[:80], 0.0) + us
        return out

    def top(self, n: int, per: float = 1.0) -> list:
        return [(k, us / 1e3 / per) for k, us in sorted(self.by_op().items(),
                                                          key=lambda kv: -kv[1])[:n]]

    def count(self, names) -> int:
        return sum(self.host.get(n, 0) for n in names)


def traced(where: str, body) -> Trace:
    """``body()`` (which returns its wall seconds) under ``torch.profiler``
    (CPU and CUDA) after PROFILE_HEAD one-element adds; again with a head
    four times as long while a launch of the body lost its device record,
    PROFILE_ATTEMPTS times in all, then SmokeFailure. ``body`` must be
    safe to run again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    head = PROFILE_HEAD
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(head):
                pad.add_(1)
            wall = body()
        t = Trace(prof, head, wall)
        PROFILE_CHECKS.append({"where": where, "head": head, "lost": t.lost,
                               "launches": t.count(LAUNCH_OPS)})
        if not t.lost:
            return t
        print(f"[profiler] {where}: {t.lost} launches of {t.count(LAUNCH_OPS)} without "
              f"their device records after a head of {head}; again", flush=True)
        head *= 4
    raise SmokeFailure(f"{where}: the profiler lost device records in {PROFILE_ATTEMPTS} tries")


def graph_pool_mib(graph):
    """The bytes the allocator holds in ``graph``'s private memory pool, in
    MiB (None where the snapshot does not name segment pools)."""
    import torch

    pool = tuple(graph.pool())
    segs = [s["total_size"] for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == pool]
    return sum(segs) / 2**20 if segs else None


def replay_ms(graph, calls: int = GRAPH_CALLS, replays: int = 5) -> float:
    """Device ms of one replay of ``graph`` (``calls`` replays between two
    CUDA events, median of ``replays``). A decode graph replayed on the same
    inputs writes the same K/V rows again."""
    import torch

    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def backbone_bytes(params, cfg, pos) -> int:
    """The bytes one decode step's backbone must move: every layer weight
    and norm once, one embedding row per slot, each slot's K and V rows up
    to its position (``pos``, the slots' positions), read once."""
    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]

    weights = sum(t.nbytes for t in leaves(params["layers"]) + leaves(params["final_norm"]))
    emb = params["embed"]["table"]
    item = emb.element_size()
    rows = len(pos) * emb.shape[1] * item
    kv = cfg.n_layers * int(sum(int(p) + 1 for p in pos)) * cfg.n_kv_heads * cfg.hd * 2 * item
    return weights + rows + kv


def profile_phase(results: dict, card: str, cfg, bundle, params, cases) -> None:
    """Each case twice on identical requests: the eager step
    (``decode_graph=False``), then the default (the backbone replayed from
    its CUDA graph). Greedy streams token-identical, one capture."""
    import numpy as np
    import torch

    from repro_torch.train import Request, SamplingParams, ServeSession
    from repro_torch.train.serve import GRAPH_WARMUP_STEPS

    rng = np.random.RandomState(SEED + 2)
    for label, table in cases:
        kern = label.split()[0]
        prompts = [rng.randint(0, cfg.vocab_size, PROFILE_PROMPT).astype(np.int32)
                   for _ in range(N_SLOTS)]
        rows = {}
        for graph in (False, None):
            sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=MAX_SEQ,
                                k=K_TOP, kernel=kern, device="cuda", decode_graph=graph)
            reqs = [Request(prompt=p, sampling=SamplingParams(
                max_new_tokens=PROFILE_STEPS + PROFILE_ATTEMPTS * PROFILE_TRACED
                + GRAPH_WARMUP_STEPS + 4))
                for p in prompts]
            for r in reqs:
                sess.submit(r)
            sess.step()  # admits (prefills) all slots and runs the first decode step
            for _ in range(GRAPH_WARMUP_STEPS):  # a graph session captures in the last
                sess.step()
            times = []
            for _ in range(PROFILE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sess.step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            def steps():
                t0 = time.perf_counter()
                for _ in range(PROFILE_TRACED):
                    sess.step()
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            mode = "eager" if graph is False else "graph"
            tr = traced(f"profile {label} {mode}", steps)
            wall, busy_us = tr.wall, tr.busy_us()
            st = sess.stats()
            row = {
                "kernel": label, "decode_graph": mode, "card": card,
                "step_ms_median": 1e3 * statistics.median(times),
                "traced_step_ms": 1e3 * wall / PROFILE_TRACED,
                "device_busy_ms_per_step": busy_us / 1e3 / PROFILE_TRACED,
                "device_idle_share": (1.0 - busy_us / 1e6 / wall) if busy_us else None,
                # the same share against the untraced steps' median: the
                # profiler's own host work lengthens the traced steps
                "device_idle_share_untraced":
                    (1.0 - busy_us / 1e3 / PROFILE_TRACED / (1e3 * statistics.median(times)))
                    if busy_us else None,
                "device_ops_per_step": len(tr.device) / PROFILE_TRACED,
                "host_launches_per_step": tr.count(LAUNCH_OPS) / PROFILE_TRACED,
                "host_syncs_and_copies_per_step": tr.count(SYNC_OPS) / PROFILE_TRACED,
                "decode_graphs": st["decode_graphs"],
                "top_device_ops_ms_per_step": tr.top(10, PROFILE_TRACED),
            }
            if graph is None:
                g = sess._graph.graph
                row["graph_pool_mib"] = graph_pool_mib(g)
                row["replay_ms"] = replay_ms(g)
                row["backbone_bytes_bound_ms"] = (
                    backbone_bytes(params, cfg, sess._pos) / HBM_BYTES_PER_S * 1e3)
            want = 1 if graph is None else 0
            if st["decode_graphs"] != want:
                raise SmokeFailure(f"profile {label} {mode}: decode_graphs "
                                   f"{st['decode_graphs']}, expected {want}")
            sess.run()  # a profile taken again stepped further: finish every stream
            rows[mode] = (row, [list(r.out_tokens) for r in reqs])
            results.setdefault("profile", []).append(row)
            print(f"[profile] {json.dumps(row)}", flush=True)
            del sess
        (eager, s_eager), (graphed, s_graph) = rows["eager"], rows["graph"]
        if s_graph != s_eager:
            bad = [i for i, (a, b) in enumerate(zip(s_graph, s_eager)) if a != b]
            raise SmokeFailure(f"profile {label}: the graph session's greedy streams leave "
                               f"the eager session's for requests {bad}")
        ratio = graphed["device_busy_ms_per_step"] / eager["device_busy_ms_per_step"]
        graphed["busy_over_eager"] = ratio
        print(f"[profile] {label}: graph against eager, streams token-identical over "
              f"{len(s_graph[0])} tokens each; step ms {eager['step_ms_median']:.3f} -> "
              f"{graphed['step_ms_median']:.3f}; device busy ms "
              f"{eager['device_busy_ms_per_step']:.3f} -> "
              f"{graphed['device_busy_ms_per_step']:.3f} ({ratio:.3f}x; the replay alone "
              f"{graphed['replay_ms']:.3f} ms by CUDA events, its bytes bound "
              f"{graphed['backbone_bytes_bound_ms']:.3f} ms); idle share traced "
              f"{eager['device_idle_share']:.3f} -> {graphed['device_idle_share']:.3f}, "
              f"untraced {eager['device_idle_share_untraced']:.3f} -> "
              f"{graphed['device_idle_share_untraced']:.3f}; host "
              f"launches {eager['host_launches_per_step']:.0f} -> "
              f"{graphed['host_launches_per_step']:.0f}; graph pool "
              f"{graphed['graph_pool_mib']} MiB; card {card}", flush=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: the adaptation path (repack, swap, the online loop, the breaker)
# ---------------------------------------------------------------------------

def _count_calls(module, name):
    """Wrap ``module.name`` so each call is counted; returns the counter
    (a list holding one int) and a function that restores the original."""
    orig, calls = getattr(module, name), [0]

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)

    setattr(module, name, counted)
    return calls, lambda: setattr(module, name, orig)


def adapt_phase(results: dict, card: str, cfg, bundle, params, mask, gamma: float) -> None:
    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import AdaptPolicy, repack_for_traffic
    from repro_torch.testing import skew_gate
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    skewed = skew_gate(params)
    state = ds.DSState(mask=mask)
    K = cfg.ds.num_experts
    rng = np.random.RandomState(SEED + 3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in ADAPT_PROMPT_LENS]
    out = results.setdefault("adapt", {"card": card, "gamma": gamma})

    def session(kern, record=False, **kw):
        sess = ServeSession(bundle, skewed, state, n_slots=N_SLOTS,
                            max_seq_len=ADAPT_SEQ, k=K_TOP, kernel=kern, device="cuda", **kw)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=ADAPT_NEW))
                for p in prompts]
        rec = None
        if record:
            rec = Recorder(sess, reqs)
        for r in reqs:
            sess.submit(r)
        return sess, reqs, rec

    def drained(label, sess, reqs):
        while sess.step():
            pass
        torch.cuda.synchronize()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != ADAPT_NEW:
                raise SmokeFailure(f"adapt {label}: request ended {r.status} ({r.error})")
        return [list(r.out_tokens) for r in reqs], sess.stats()

    plain_calls, restore = _count_calls(ref, "lasso_prune_ref")
    try:
        ops.reset_launch_counts()  # the adapt path starts here
        # -- (i) one repack swapped into three sessions at the same step ----
        sessions = {}
        for kern in ADAPT_KERNELS:
            sess, reqs, rec = session(kern, record=True, overflow_threshold=BREAKER_OFF)
            for _ in range(SWAP_AT):
                sess.step()
            sessions[kern] = (sess, reqs, rec)
        prof = sessions["cuda_grouped"][0].traffic_profile()
        if not prof.overflow_rate > 0.5:
            raise SmokeFailure(f"adapt (i): the skewed window did not overflow ({prof})")
        n_lasso = ops.launch_counts()["lasso_prune"]
        res, repack_s = sync_s(lambda: repack_for_traffic(
            skewed["head"], state, prof, prune_gamma=gamma, mitosis_overflow_threshold=0.1,
            generator=torch.Generator(device="cuda").manual_seed(SEED)))
        if res.cloned != (0,) or res.rows_pruned <= 0 \
                or ops.launch_counts()["lasso_prune"] != n_lasso + 1:
            raise SmokeFailure(f"adapt (i): repack cloned {res.cloned}, pruned "
                               f"{res.rows_pruned} rows, lasso launches "
                               f"{ops.launch_counts()['lasso_prune'] - n_lasso}")
        streams, heads, swap_s = {}, {}, {}
        v_pad_before = int(sessions["jnp"][0].table.v_pad)
        if not res.table.v_pad < v_pad_before:
            raise SmokeFailure(f"adapt (i): the re-pruned table's v_pad {res.table.v_pad} "
                               f"is not below {v_pad_before}")
        for kern, (sess, reqs, rec) in sessions.items():
            _, swap_s[kern] = sync_s(lambda: sess.swap_table(
                res.table, new_gate=res.head_params["gate"],
                capacity_factor=res.capacity_factor))
            streams[kern], st = drained(f"(i) {kern}", sess, reqs)
            heads[kern] = rec.heads
            if st["n_swaps"] != 1 or st["decode_builds"] != 2 or sess.table_version != 1 \
                    or st["decode_graphs"] != 1:
                raise SmokeFailure(f"adapt (i) {kern}: swap accounting {st}")
        n_div = _diverge_check("adapt (i)", streams, heads, ADAPT_KERNELS[:-1], "jnp",
                               TIE_RTOL, sampled=None)
        lasso_ms = results["main"]["lasso_prune"]["ms"]
        out["explicit_swap"] = {
            "rows_pruned": res.rows_pruned, "cloned": list(res.cloned),
            "K": int(res.table.ids.shape[0]), "v_pad": int(res.table.v_pad),
            "v_pad_before": v_pad_before,
            "capacity_factor": res.capacity_factor, "window_overflow_rate": prof.overflow_rate,
            "repack_s": repack_s, "swap_s": swap_s, "lasso_ms": lasso_ms,
            "lasso_share_of_repack": lasso_ms / 1e3 / repack_s, "near_tie_divergences": n_div}
        print(f"[adapt] (i) repack of the skewed window (overflow {prof.overflow_rate:.3f}): "
              f"{res.rows_pruned} rows pruned at gamma {gamma:.6g}, cloned {res.cloned}, K "
              f"{K} -> {res.table.ids.shape[0]}, v_pad {v_pad_before} "
              f"-> {res.table.v_pad}, capacity factor {res.capacity_factor:.3g}; repack "
              f"{repack_s * 1e3:.1f} ms wall, lasso_prune kernel {lasso_ms:.4f} ms "
              f"({100 * lasso_ms / 1e3 / repack_s:.2f}% of it); swap wall ms "
              f"{ {k: round(v * 1e3, 3) for k, v in swap_s.items()} }; streams agree across "
              f"{', '.join(ADAPT_KERNELS)} ({n_div} near-tie divergences); card {card}",
              flush=True)
        del sessions, res

        # -- (ii) the online loop on cuda_grouped, breaker off --------------
        policy = AdaptPolicy(interval=SWAP_AT, min_window_steps=4, overflow_threshold=0.05,
                             mitosis_overflow_threshold=0.1, max_swaps=1, prune_gamma=gamma,
                             seed=SEED)
        n_lasso = ops.launch_counts()["lasso_prune"]
        sess, reqs, _ = session("cuda_grouped", overflow_threshold=BREAKER_OFF,
                                adapt_policy=policy)
        v_pad_first = int(sess.table.v_pad)
        before = None
        while True:
            more = sess.step()
            st = sess.stats()
            if st["n_swaps"] == 0:
                before = st["overflow_rate_window"]
            if not more:
                break
        _, st = drained("(ii)", sess, reqs)
        after = st["overflow_rate_window"]
        fails = [msg for ok, msg in (
            (st["n_swaps"] >= 1, "no swap"),
            (before is not None and after < before, f"window overflow {before} -> {after}"),
            (st["rows_pruned"] > 0, "no row pruned"),
            (ops.launch_counts()["lasso_prune"] - n_lasso >= 1, "lasso_prune never launched"),
            (st["decode_builds"] == 1 + st["n_swaps"], f"decode_builds {st['decode_builds']}"),
            (st["decode_graphs"] == 1, f"decode_graphs {st['decode_graphs']}"),
            (sess.table.v_pad < v_pad_first, f"v_pad {v_pad_first} -> {sess.table.v_pad}"),
        ) if not ok]
        if fails:
            raise SmokeFailure(f"adapt (ii): {'; '.join(fails)}")
        out["online_loop"] = {k: st[k] for k in (
            "n_swaps", "decode_builds", "decode_graphs", "rows_pruned", "effective_capacity_factor",
            "overflow_rate_window", "breaker_trips")}
        out["online_loop"].update(overflow_rate_window_before=before, v_pad_before=v_pad_first,
                                  v_pad=int(sess.table.v_pad))
        print(f"[adapt] (ii) AdaptPolicy on cuda_grouped: {st['n_swaps']} swap(s), window "
              f"overflow {before:.3f} -> {after:.3f}, {st['rows_pruned']} rows pruned, "
              f"v_pad {v_pad_first} -> {sess.table.v_pad}, "
              f"capacity factor -> {st['effective_capacity_factor']:.3g}, decode_builds "
              f"{st['decode_builds']}", flush=True)
        del sess

        # -- (iii) the breaker: trip 1, then trip 2 to the fused kernel ------
        sess, reqs, rec = session("cuda_grouped", record=True)
        fused_first, fused_at_trip2 = ops.launch_counts()["dss_topk_fused"], None
        while sess.step():
            if fused_at_trip2 is None and sess.stats()["breaker_trips"] == 2:
                fused_at_trip2 = ops.launch_counts()["dss_topk_fused"]
        b_streams, st = drained("(iii)", sess, reqs)
        fused_after = ops.launch_counts()["dss_topk_fused"] - (fused_at_trip2 or 0)
        if st["breaker_trips"] != 2 or st["effective_kernel"] != "cuda_fused" \
                or st["effective_capacity_factor"] != 2 * cfg.ds.capacity_factor \
                or st["decode_builds"] != 3 or st["decode_graphs"] != 1 \
                or fused_at_trip2 != fused_first or fused_after < 1:
            raise SmokeFailure(f"adapt (iii): breaker state {st}; dss_topk_fused launches "
                               f"before trip 2 {(fused_at_trip2 or fused_first) - fused_first}, "
                               f"after it {fused_after}")
        plain, plain_reqs, plain_rec = session("jnp", record=True)
        p_streams, _ = drained("(iii) plain", plain, plain_reqs)
        n_div = _diverge_check("adapt (iii)", {"breaker": b_streams, "jnp": p_streams},
                               {"breaker": rec.heads, "jnp": plain_rec.heads}, ("breaker",),
                               "jnp", TIE_RTOL, sampled=None)
        out["breaker"] = {k: st[k] for k in ("breaker_trips", "effective_kernel",
                                              "effective_capacity_factor", "decode_builds",
                                              "decode_graphs", "overflow_rate")}
        out["breaker"]["fused_launches_after_trip_2"] = fused_after
        print(f"[adapt] (iii) breaker: {st['breaker_trips']} trips, capacity factor "
              f"{st['effective_capacity_factor']}, then kernel {st['effective_kernel']!r} "
              f"(dss_topk_fused launched {fused_after} times after trip 2); streams agree "
              f"with an unswapped jnp session ({n_div} near-tie divergences)", flush=True)
        del sess, plain

        # -- (iv) an int8 session stays quantized across a swap -------------
        sess, reqs, _ = session("cuda_grouped", overflow_threshold=BREAKER_OFF,
                                quantize="int8", quantize_flip_threshold=1.0,
                                adapt_policy=dataclasses.replace(policy, interval=10**9))
        for _ in range(SWAP_AT):
            sess.step()
        rep_before = sess.stats()["quantize_report"]
        _, swap_q_s = sync_s(sess.adapt_now)
        # the repack raises the capacity (cf 25.5 at K 17: C 12), so the int8
        # grouped body after the swap is the one select_body names for it
        int8_bodies = [n for n, _, _ in ops.BODIES
                       if n.startswith("dss_topk_grouped") and n.endswith("_q")]
        before_q = {n: ops.launch_counts()[n] for n in int8_bodies}
        _, st = drained("(iv)", sess, reqs)
        rep_after = st["quantize_report"]
        after_q = {n: ops.launch_counts()[n] - before_q[n] for n in int8_bodies}
        n_q = sum(after_q.values())
        if not isinstance(sess.table, ds.QuantizedServeTable) or st["n_swaps"] != 1 \
                or st["decode_graphs"] != 1 \
                or len(rep_after["per_expert_flip_rate"]) != K + 1 \
                or len(rep_before["per_expert_flip_rate"]) != K or n_q < 1:
            raise SmokeFailure(f"adapt (iv): after the swap the table is "
                               f"{type(sess.table).__name__}, report {rep_after}, "
                               f"int8 launches since {n_q}")
        out["int8"] = {"adapt_now_s": swap_q_s, "n_fallback_after": rep_after["n_fallback"],
                       "int8_launches_after_swap": after_q}
        print(f"[adapt] (iv) int8 session: adapt_now (repack + gate + swap) "
              f"{swap_q_s * 1e3:.1f} ms wall; still int8 after the swap (K {K + 1}, "
              f"{rep_after['n_fallback']} fallback experts, report refreshed); int8 grouped "
              f"bodies launched after it {after_q}", flush=True)
        del sess
    finally:
        restore()
    if plain_calls[0]:
        raise SmokeFailure(f"adapt: lasso_prune's plain version ran {plain_calls[0]} times")
    counts = ops.launch_counts()
    results["main_path_launches"]["adapt"] = counts
    missing = [n for n in ADAPT_NEEDS if counts[n] < 1]
    if missing:
        raise SmokeFailure(f"adapt: kernels {missing} never launched ({counts})")
    print(f"[adapt] launches over the adapt path: {counts}", flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6: prefill (the flash_attention kernel, chunked prefill, the paged
# cache with prefix sharing and preemption)
# ---------------------------------------------------------------------------

def sync_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _topk_parts_only_at_ties(label, vk, ik, vp, ip, tol) -> None:
    """Kernel top-k (vk, ik) against the plain one (vp, ip): at every rank
    where the ids differ, the id the kernel put there must hold a plain
    value within ``tol`` of the plain value at that rank."""
    for j in range(len(ip)):
        if int(ik[j]) == int(ip[j]):
            continue
        at = (ip == ik[j]).nonzero()
        gap = abs(float(vp[int(at[0])] - vp[j])) if len(at) else abs(float(vk[j] - vp[j]))
        if gap > tol:
            raise SmokeFailure(f"{label}: rank {j} id {int(ik[j])} against plain {int(ip[j])} "
                               f"at a gap of {gap:.4g} > {tol:.4g}")


def _held_within_drift(label, a_run, ref_run, rtol=BF16_DRIFT, tag="prefill") -> dict:
    """Each request's greedy stream against the reference's; a run is
    (streams, Recorder) with the gate watched. While the streams agree,
    each emission's top-1 value and top-1 gate probability stay within
    ``rtol`` of the reference's (relative). Where a stream leaves, the
    reference must hold a near-tie within ``2·rtol``: where the stream
    chose the reference's expert, of the token (the reference ranks that
    stream's token within 2·rtol of its top-1; a token outside its top-k
    counts at the k-th value, a lower bound of the gap); where it chose
    another expert, of the gate (the reference puts that expert's
    probability within 2·rtol of its top-1 expert's; the head scales an
    expert's values by it). Returns the readings: the largest
    drifts and gaps (relative) and the partings by kind."""
    (streams, rec), (streams_ref, ref) = a_run, ref_run
    read = {"max_drift": 0.0, "max_gate_drift": 0.0, "max_token_gap": 0.0,
            "max_gate_gap": 0.0, "token_ties": 0, "gate_ties": 0}
    for i, (a, b) in enumerate(zip(streams, streams_ref)):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        for j in range(n):
            top, got = float(ref.heads[i][j][0][0]), float(rec.heads[i][j][0][0])
            g_top, g_got = float(ref.gates[i][j].max()), float(rec.gates[i][j].max())
            d, gd = abs(got - top) / abs(top), abs(g_got - g_top) / g_top
            if d > rtol or gd > rtol:
                raise SmokeFailure(f"{label}: request {i} emission {j}: top-1 value {got} "
                                   f"against {top}, gate {g_got} against {g_top}: "
                                   f"{d:.3g} and {gd:.3g} relative")
            read["max_drift"] = max(read["max_drift"], d)
            read["max_gate_drift"] = max(read["max_gate_drift"], gd)
        if n == len(a):
            continue
        rv, ri = ref.heads[i][n]
        at = (ri == a[n]).nonzero()
        other = float(rv[int(at[0])]) if len(at) else float(rv[-1])
        gap = (float(rv[0]) - other) / abs(float(rv[0]))
        g_ref, e_ref, e_a = ref.gates[i][n], int(ref.gates[i][n].argmax()), \
            int(rec.gates[i][n].argmax())
        g_gap = float(g_ref[e_ref] - g_ref[e_a]) / float(g_ref[e_ref])
        # another expert's tokens are other rows: only the gate explains it
        kind = "gate" if e_a != e_ref else "token"
        if (g_gap if kind == "gate" else gap) > 2 * rtol:
            kind = None
        print(f"[{tag}] {label}: request {i} leaves the reference at emission {n}: "
              f"reference top-2 {rv[:2].tolist()} ids {ri[:2].tolist()}, token {a[n]} "
              f"{'at ' + format(other, '.6g') if len(at) else 'outside its top-k'} (gap "
              f"{gap:.3g} of the top-1); experts {e_ref} / {e_a}, gate gap {g_gap:.3g}: "
              f"{kind or 'no'} near-tie", flush=True)
        if kind is None:
            raise SmokeFailure(f"{label}: request {i} leaves the reference at emission {n} "
                               f"without a near-tie (token gap {gap:.3g}, experts {e_ref} / "
                               f"{e_a}, gate gap {g_gap:.3g})")
        read[f"{kind}_ties"] += 1
        read[f"max_{kind}_gap"] = max(read[f"max_{kind}_gap"], gap if kind == "token" else g_gap)
    return read


def warm_prefill_profile(prefill, label="(a)") -> dict:
    """Where a warm whole-prompt prefill's time goes: three more calls
    (median ms, each to a synchronize), then one under ``torch.profiler``:
    device-busy ms, the device's idle share, device ops, the
    flash_attention kernels' device ms, the five ops that take most."""
    import torch

    warm = [sync_s(prefill)[1] * 1e3 for _ in range(3)]
    tr = traced(f"prefill {label}", lambda: sync_s(prefill)[1])
    wall, busy_ms = tr.wall, tr.busy_us() / 1e3
    flash_ms = sum(us for n, us in tr.device
                   if "fa_wgmma_kernel" in n or "fa_simt_kernel" in n
                   or "flash_attention_kernel" in n) / 1e3
    rec = {"ms_median_of_3": statistics.median(warm), "traced_ms": wall * 1e3,
           "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "device_ops": len(tr.device), "flash_attention_device_ms": flash_ms,
           "top_device_ops_ms": tr.top(5)}
    print(f"[prefill] {label} warm: {json.dumps(rec)}", flush=True)
    return rec


def fp32_prefill(results, cfg, params, table, tokens) -> dict:
    """The CUDA-core flash_attention body's path: one whole-prompt prefill
    of qwen2-1.5b in fp32 (the seeded bf16 weights and serve table widened;
    full width, 28 layers), which takes that body by the rule, against the
    same prefill with ``chunked_causal_attention`` swapped in: exactly 28
    launches of the CUDA-core body and none of the tensor-core body, top-k
    values within FP32_DRIFT of the top-1 and ids apart only at a near-tie
    (within twice that). Returns the record; the launch counts land in
    ``main_path_launches["prefill_fp32"]``."""
    import torch

    from repro_torch.core.dssoftmax import ServeTable
    from repro_torch.kernels import ops
    from repro_torch.models import build, layers

    def widen(x):
        if isinstance(x, dict):
            return {k: widen(v) for k, v in x.items()}
        return x.float() if torch.is_tensor(x) and x.is_floating_point() else x

    cfg32 = cfg.replace(dtype="float32")
    bundle32 = build(cfg32, device="cuda")
    # the DS head reads the gate and the serve table; its expert rows stay
    p32 = {k: widen(v) for k, v in params.items() if k != "head"}
    p32["head"] = {k: (v if k == "experts" else widen(v)) for k, v in params["head"].items()}
    t32 = ServeTable(ids=table.ids, weights=table.weights.float())

    def prefill():
        return bundle32.prefill(p32, t32, {"tokens": tokens}, k=K_TOP, kernel="auto")

    ops.reset_launch_counts()  # the fp32 prefill path starts here
    (vk, ik, _), t_kernel = sync_s(prefill)
    counts = ops.launch_counts()
    if counts[FLASH_SIMT] != cfg.n_layers or counts[FLASH_TC]:
        raise SmokeFailure(f"prefill (a2) fp32: {counts[FLASH_SIMT]} CUDA-core launches for "
                           f"{cfg.n_layers} layers, {counts[FLASH_TC]} tensor-core ({counts})")
    results.setdefault("main_path_launches", {})["prefill_fp32"] = counts
    warm = {"this": warm_prefill_profile(prefill, "(a2) fp32")}
    orig = layers.flash_attention
    if PARENT is not None:  # the same warm prefill through the parent's body
        layers.flash_attention = lambda q, k, v, device: parent_flash(q, k, v, FLASH_SIMT)
        try:
            warm["parent"] = warm_prefill_profile(prefill, "(a2) fp32, the parent's body")
        finally:
            layers.flash_attention = orig
    restore = _plain_attention(cfg32)
    try:
        (vp, ip, _), t_plain = sync_s(prefill)
    finally:
        restore()
    vk, ik, vp, ip = vk[0].cpu(), ik[0].cpu(), vp[0].cpu(), ip[0].cpu()
    same = ik == ip
    top = abs(float(vp[0]))
    drift = float((vk[same] - vp[same]).abs().max()) / top if bool(same.any()) else 0.0
    if drift > FP32_DRIFT:
        raise SmokeFailure(f"prefill (a2) fp32: top-k values differ by {drift:.3g} of the "
                           f"top-1 from the plain run")
    _topk_parts_only_at_ties("prefill (a2) fp32", vk, ik, vp, ip, 2 * FP32_DRIFT * top)
    del p32, t32
    torch.cuda.empty_cache()
    rec = {"tokens": int(tokens.shape[1]), "kernel_launches": counts,
           "kernel_ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
           "ids_equal": bool(same.all()), "max_drift": drift, "warm": warm}
    print(f"[prefill] (a2) fp32 copy, {tokens.shape[1]}-token prefill: {FLASH_SIMT} launched "
          f"{counts[FLASH_SIMT]} times, {FLASH_TC} {counts[FLASH_TC]}; {t_kernel * 1e3:.1f} ms "
          f"against {t_plain * 1e3:.1f} ms with chunked_causal_attention; top-k ids "
          f"{'equal' if bool(same.all()) else 'equal up to near-ties'}, values within "
          f"{drift:.3g} of the top-1 (allowed {FP32_DRIFT:.3g})", flush=True)
    return rec


def prefill_phase(results: dict, card: str, cfg, bundle, params, table) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    out = results.setdefault("prefill", {"card": card})
    V = cfg.vocab_size

    # -- (a) one 2048-token prefill: the kernel against plain attention ----
    rng = np.random.RandomState(SEED + 4)
    tokens = torch.from_numpy(rng.randint(0, V, (1, max(OTHER_LENS)))).to("cuda")

    def prefill():
        return bundle.prefill(params, table, {"tokens": tokens}, k=K_TOP, kernel="auto")

    plain_calls, restore_ref = _count_calls(ref, "flash_attention_ref")
    chunk_calls, restore_chunked = _count_calls(layers, "chunked_causal_attention")
    try:
        ops.reset_launch_counts()  # the prefill path starts here
        (vk, ik, _), t_kernel = sync_s(prefill)
        counts = ops.launch_counts()
        launches = counts[FLASH_TC]
    finally:
        restore_ref()
        restore_chunked()
    if launches != cfg.n_layers or counts[FLASH_SIMT] or plain_calls[0] or chunk_calls[0]:
        raise SmokeFailure(f"prefill (a): {launches} tensor-core kernel launches for "
                           f"{cfg.n_layers} layers, {counts[FLASH_SIMT]} on the CUDA-core body; "
                           f"plain versions called {plain_calls[0]} + {chunk_calls[0]} times")
    restore = _plain_attention(cfg)
    try:
        ops.reset_launch_counts()
        (vp, ip, _), t_plain = sync_s(prefill)
        if ops.launch_counts()[FLASH_TC] or ops.launch_counts()[FLASH_SIMT]:
            raise SmokeFailure("prefill (a): the plain run launched the kernel")
    finally:
        restore()
    orig = layers.flash_attention
    vk, ik, vp, ip = vk[0].cpu(), ik[0].cpu(), vp[0].cpu(), ip[0].cpu()
    same = ik == ip
    top = abs(float(vp[0]))
    drift = float((vk[same] - vp[same]).abs().max()) / top if bool(same.any()) else 0.0
    if drift > BF16_DRIFT:
        raise SmokeFailure(f"prefill (a): top-k values differ by {drift:.3g} of the top-1 "
                           f"from the plain run")
    _topk_parts_only_at_ties("prefill (a)", vk, ik, vp, ip, 2 * BF16_DRIFT * top)
    out["one_prefill"] = {"tokens": int(tokens.shape[1]), "kernel_launches": counts,
                          "kernel_ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
                          "ids_equal": bool(same.all()), "max_drift": drift,
                          "warm": warm_prefill_profile(prefill)}
    if PARENT is not None:  # the same warm prefill through the parent's tensor-core body
        layers.flash_attention = lambda q, k, v, device: parent_flash(q, k, v, FLASH_TC)
        try:
            out["one_prefill"]["warm_parent"] = warm_prefill_profile(
                prefill, "(a), the parent's body")
        finally:
            layers.flash_attention = orig
    print(f"[prefill] (a) {tokens.shape[1]}-token prefill: {FLASH_TC} launched {launches} "
          f"times ({cfg.n_layers} layers), plain versions never called; {t_kernel * 1e3:.1f} ms "
          f"against {t_plain * 1e3:.1f} ms with chunked_causal_attention swapped in; top-k ids "
          f"{'equal' if bool(same.all()) else 'equal up to near-ties'}, values within {drift:.3g} "
          f"of the top-1 (allowed {BF16_DRIFT:.3g}); card {card}", flush=True)

    # -- (a2) the same prompt through an fp32 copy of the model -------------
    out["fp32_prefill"] = fp32_prefill(results, cfg, params, table, tokens)

    # -- (b) five sessions -----------------------------------------------------
    rng = np.random.RandomState(SEED + 5)
    system = rng.randint(0, V, SYSTEM_LEN)
    prompts = [np.concatenate([system, rng.randint(0, V, n)]).astype(np.int32)
               for n in SHARED_TAILS]
    prompts += [rng.randint(0, V, n).astype(np.int32) for n in OTHER_LENS]
    n_shared = len(SHARED_TAILS)

    def serve(label, submit_late=False, **kw):
        sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=PREFILL_SEQ,
                            k=K_TOP, kernel="auto", overflow_threshold=BREAKER_OFF,
                            device="cuda", **kw)
        # E: the unrelated prompts (priority 0) first, the shared-prefix
        # class (priority 1) E_SUBMIT_AT steps later
        prio = [1] * n_shared + [0] * len(OTHER_LENS) if submit_late else [0] * len(prompts)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=NEW_TOKENS,
                                                          priority=pr))
                for p, pr in zip(prompts, prio)]
        rec = Recorder(sess, reqs)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, later = (reqs[n_shared:], reqs[:n_shared]) if submit_late else (reqs, [])
        for r in first:
            sess.submit(r)
        for _ in range(E_SUBMIT_AT if later else 0):
            sess.step()
        for r in later:
            sess.submit(r)
        while sess.step():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = ops.launch_counts()
        st = sess.stats()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != NEW_TOKENS:
                raise SmokeFailure(f"prefill {label}: request ended {r.status} ({r.error}) "
                                   f"with {len(r.out_tokens)} tokens")
        if st["decode_graphs"] != 1:
            raise SmokeFailure(f"prefill {label}: {st['decode_graphs']} decode graph captures")
        if "paged" in st and (st["paged"]["pages_in_use"]
                              or st["paged"]["pages_free"] != st["paged"]["pages_total"]):
            raise SmokeFailure(f"prefill {label}: pages still held after the session "
                               f"({st['paged']})")
        first_ms = [1e3 * s for s in rec.prefill_s.values()]
        row = {"session": label, "wall_s": wall, "tokens": NEW_TOKENS * len(reqs),
               "tokens_per_s": NEW_TOKENS * len(reqs) / wall,
               "prefill_ms_median": statistics.median(first_ms),
               "prefill_ms_total": sum(first_ms),
               "prefill_ms_longest": 1e3 * rec.prefill_s[n_shared],
               "resume_prefill_ms_total": 1e3 * sum(map(sum, rec.resume_s.values())),
               "aborted_prefill_ms_total": 1e3 * rec.aborted_s,
               "decode_steps": len(rec.decode_s),
               "decode_step_ms_median": 1e3 * statistics.median(rec.decode_s),
               "peak_pages": rec.peak_pages, "launches": delta, "paged": st.get("paged"),
               "card": card, **{k: v for k, v in kw.items() if k != "page_arena"}}
        if "page_arena" in kw:
            row["page_arena"] = kw["page_arena"]
        out.setdefault("sessions", []).append(row)
        print(f"[prefill] ({label}) {row['tokens']} tokens in {wall:.3f} s = "
              f"{row['tokens_per_s']:.2f} tokens/s; prefill median "
              f"{row['prefill_ms_median']:.2f} ms, total {row['prefill_ms_total']:.1f} ms "
              f"(2048-token prompt {row['prefill_ms_longest']:.1f} ms; resumes "
              f"{row['resume_prefill_ms_total']:.1f} ms); decode step median "
              f"{row['decode_step_ms_median']:.2f} ms over {row['decode_steps']} steps; "
              f"peak pages {rec.peak_pages}; paged {st.get('paged')}; launches {delta}; "
              f"card {card}", flush=True)
        if (delta[FLASH_TC] < 1 and "prefill_chunk" not in kw) or delta[FLASH_SIMT]:
            raise SmokeFailure(f"prefill {label}: whole-prompt prefill never launched "
                               f"{FLASH_TC}, or launched the CUDA-core body ({delta})")
        return [list(r.out_tokens) for r in reqs], rec, st, delta

    paged = dict(paged=True, page_size=PAGE_SIZE)
    chunked = dict(prefill_chunk=PREFILL_CHUNK)
    restore = _watch_gate()
    try:
        sA, rA, _, dA = serve("A")
        sB, rB, _, _ = serve("B", **chunked)
        sC, rC, _, _ = serve("C", **paged)
        sD, rD, stD, _ = serve("D", **paged, **chunked)
        arena = math.ceil(ARENA_SHARE * rD.peak_pages)
        sE, rE, stE, _ = serve("E", submit_late=True, page_arena=arena, **paged, **chunked)
    finally:
        restore()
    results.setdefault("main_path_launches", {})["prefill"] = dA
    for got, want, pair in ((sC, sA, "C = A"), (sD, sB, "D = B")):
        if got != want:
            bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
            raise SmokeFailure(f"prefill: {pair} fails for requests {bad}")
    ab = _held_within_drift("A/B", (sA, rA), (sB, rB))
    ed = _held_within_drift("E/D", (sE, rE), (sD, rD))
    resumed = sorted(rE.resume_s)
    same_unpreempted = all(sE[i] == sD[i] for i in range(len(sE)) if i not in resumed)
    pD, pE = stD["paged"], stE["paged"]
    fails = [msg for ok, msg in (
        (pD["prefill_chunks_saved"] >= 28, f"D saved {pD['prefill_chunks_saved']} chunks"),
        (pD["prefix_tokens_reused"] > 0, "D reused no prefix token"),
        (pE["preemptions"] > 0, "E preempted nobody"),
    ) if not ok]
    if fails:
        raise SmokeFailure(f"prefill: {'; '.join(fails)}")
    out.update(e_arena=arena, d_peak_pages=rD.peak_pages, resumed_requests=resumed,
               drift={"allowed": BF16_DRIFT, "A/B": ab, "E/D": ed},
               e_unpreempted_equal_d=same_unpreempted)
    print(f"[prefill] C = A and D = B token for token; A/B {json.dumps(ab)}; D saved "
          f"{pD['prefill_chunks_saved']} prefix chunks, reused {pD['prefix_tokens_reused']} "
          f"tokens, peak {rD.peak_pages} pages; E (arena {arena} pages) preempted "
          f"{pE['preemptions']} times (requests {resumed} resumed), E/D {json.dumps(ed)}, "
          f"unpreempted requests {'equal' if same_unpreempted else 'not all equal'} to D's; "
          f"drift allowed {BF16_DRIFT:.3g}, near-ties twice that; every request completed, "
          f"every page free", flush=True)


# ---------------------------------------------------------------------------
# Spec phase: speculative decoding at llama3.2-3b's full width, granite-20b
# served at full width, the head paths at the three new head shapes
# ---------------------------------------------------------------------------

SPEC_ARCH, SPEC_GAMMA, SPEC_NEW = "llama3.2-3b", 4, 32
SPEC_PROMPT_LENS = (16, 512, 40, 300, 100, 64, 200, 24)
SPEC_CHUNK = 128                 # the paged session's prefill chunk
SPEC_SEQ = 640                   # >= 512 + 32 - 1 + 4; a multiple of 16 and 128
SPEC_SHALLOW_LAYERS = 2          # the shallow draft: llama3.2-3b's widths, 2 layers
SPEC_ACCEPT_MIN = 0.9            # the self-draft's accept rate, at least
SPEC_SAMPLING = dict(temperature=0.8, top_k=8)
# step times are medians over the calls replayed from a graph: past the
# graph's warm-up calls (train.serve.GRAPH_WARMUP_STEPS, 3) and its capture
REPLAYED = 4
GRANITE_PROMPT_LENS = (16, 1024, 40, 300, 100, 700, 64, 200)
GRANITE_NEW = 16
GRANITE_SEQ = 1040               # >= 1024 + 16 - 1, a multiple of 16
WIDE_HEAD_ARCHS = ("llama3.2-3b", "granite-20b", "deepseek-67b", "olmoe-1b-7b",
                   "qwen3-moe-235b-a22b", "internvl2-26b")
WIDE_HEAD_BATCHES = (8, 40)      # decode at 8 slots; a verify step at 8 slots, gamma 4
WIDE_HEAD_PATHS = ("cuda_grouped", "cuda_fused", "cuda_pertoken")


def _seeded_model(arch, seed, **replace):
    """``arch`` at full width (``replace`` applied to its config) with
    seeded weights, its head packed on the seeded stand-in mask; the
    experts are dropped after packing (a session reads the gate and the
    table). Returns (cfg, bundle, params, table)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.models import build

    cfg = get_config(arch).replace(**replace)
    bundle = build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(seed))
    table = ds.pack_experts(params["head"], ds.DSState(mask=stand_in_mask(cfg, "cuda")))
    params["head"] = {"gate": params["head"]["gate"]}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return cfg, bundle, params, table


def spec_phase(results: dict, card: str) -> None:
    """(a) speculative decoding of llama3.2-3b at full width, (b)
    granite-20b served at full width, (c) the head paths at the head shapes
    of WIDE_HEAD_ARCHS."""
    import torch

    out = results.setdefault("spec", {"card": card})
    # Sessions hold reference cycles (graphs, closures over the session), so
    # a model's device memory is freed only when the collector runs: collect
    # before the next model (granite-20b's 41.6 GB, deepseek-67b's head
    # checks) needs the room.
    spec_sessions(out, card)
    gc.collect()
    torch.cuda.empty_cache()
    granite_serving(out, card)
    gc.collect()
    torch.cuda.empty_cache()
    wide_heads(out, card)
    gc.collect()
    torch.cuda.empty_cache()


def spec_sessions(out: dict, card: str) -> None:
    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model(SPEC_ARCH, SEED)
    _, d_bundle, d_params, d_table = _seeded_model(SPEC_ARCH, SEED + 7,
                                                   n_layers=SPEC_SHALLOW_LAYERS)
    print(f"[spec] (a) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, H {cfg.n_heads}, "
          f"H_kv {cfg.n_kv_heads}, vocab {cfg.padded_vocab}, K {cfg.ds.num_experts}; table "
          f"v_pad {table.v_pad}; shallow draft {SPEC_SHALLOW_LAYERS} layers (seed {SEED + 7}, "
          f"v_pad {d_table.v_pad}); init + pack {time.perf_counter() - t0:.1f} s; device "
          f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.RandomState(SEED + 8)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in SPEC_PROMPT_LENS]
    drafts = {"self": (bundle, params, table), "shallow": (d_bundle, d_params, d_table)}
    # the verify head's path and body at this batch (what auto picks)
    h40 = torch.zeros((N_SLOTS * (SPEC_GAMMA + 1), cfg.d_model), dtype=cfg.jdtype,
                      device="cuda")
    vctx = ds.serve_kernel_context(table, h40, K_TOP)
    vpath = registry.resolve_kernel("auto", vctx)
    vbody = {"cuda_grouped": registry.grouped_body(vctx), "cuda_fused": "dss_topk_fused",
             "cuda_pertoken": "dss_topk"}.get(vpath)

    def session(label, draft=None, sampled=False, record=False, backfill=True, **kw):
        sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=SPEC_SEQ,
                            k=K_TOP, kernel="auto", overflow_threshold=BREAKER_OFF,
                            device="cuda", gamma=SPEC_GAMMA,
                            draft=None if draft is None else drafts[draft], **kw)
        sess._draft_backfill = backfill  # False: repro's draft schedule
        sp = SPEC_SAMPLING if sampled else {}
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=SPEC_NEW,
                                                          seed=SEED + i, **sp))
                for i, p in enumerate(prompts)]
        rec = Recorder(sess, reqs) if record else None
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = sess.stats()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != SPEC_NEW:
                raise SmokeFailure(f"spec {label}: request ended {r.status} ({r.error}) with "
                                   f"{len(r.out_tokens)} tokens")
            if not all(0 <= x < cfg.vocab_size for x in r.out_tokens):
                raise SmokeFailure(f"spec {label}: token outside the vocabulary")
        want = ({"decode_graphs": 1, "draft_graphs": 0, "verify_graphs": 0} if draft is None
                else {"decode_graphs": 0, "draft_graphs": 1, "verify_graphs": 1})
        got = {n: st[n] for n in want}
        if got != want:
            raise SmokeFailure(f"spec {label}: graph captures {got}, want {want}")
        if "paged" in st and (st["paged"]["pages_in_use"]
                              or st["paged"]["pages_free"] != st["paged"]["pages_total"]):
            raise SmokeFailure(f"spec {label}: pages still held after the session "
                               f"({st['paged']})")
        if st["effective_kernel"] != "auto" or st["breaker_trips"]:
            raise SmokeFailure(f"spec {label}: served through {st['effective_kernel']!r}")
        return [list(r.out_tokens) for r in reqs], wall, rec, st, ops.launch_counts(), sess

    rows, runs = [], {}
    restore = _watch_gate()
    try:
        for label, draft, kw in (("baseline", None, {}), ("self-draft", "self", {}),
                                 ("shallow draft", "shallow", {}),
                                 ("self-draft, paged chunked", "self",
                                  dict(paged=True, page_size=PAGE_SIZE,
                                       prefill_chunk=SPEC_CHUNK)),
                                 ("self-draft, no backfill", "self",
                                  dict(backfill=False))):
            # tokens/s from run() as a user calls it; step times, the heads
            # and the gates from a second, instrumented run
            streams, wall, _, st, launches, sess = session(label, draft, **kw)
            again, _, rec, _, _, _ = session(label, draft, record=True, **kw)
            if again != streams:
                raise SmokeFailure(f"spec {label}: two runs on the same requests gave other "
                                   "tokens")
            runs[label] = (streams, rec)
            n_tok = sum(map(len, streams))
            row = {"session": label, "tokens": n_tok, "wall_s": wall,
                   "tokens_per_s": n_tok / wall, "launches": launches,
                   "graph_captures": {n: st[n] for n in ("decode_graphs", "draft_graphs",
                                                          "verify_graphs")},
                   "paged": st.get("paged"), "card": card, **kw}
            if draft is None:
                step = statistics.median(rec.decode_s[REPLAYED:])
                row.update(decode_step_ms_median=1e3 * step,
                           steady_tokens_per_s=N_SLOTS / step)
                row["decode_graph_pool_mib"] = graph_pool_mib(sess._graph.graph)
                if launches[FLASH_TC] < 1 or launches[FLASH_SIMT]:
                    raise SmokeFailure(f"spec {label}: prefill launches {launches}")
            else:
                spec = st["speculative"]
                verify = statistics.median(rec.verify_s[REPLAYED:])
                draft_call = statistics.median(rec.draft_s[REPLAYED:])
                calls = len(rec.draft_s) / len(rec.verify_s)  # gamma, plus the backfills
                row.update(speculative=spec, verify_ms_median=1e3 * verify,
                           draft_call_ms_median=1e3 * draft_call, draft_calls_per_step=calls,
                           draft_ms_per_step=1e3 * calls * draft_call,
                           steady_tokens_per_s=spec["emitted_per_step"]
                           / (verify + calls * draft_call),
                           verify_graph_pool_mib=graph_pool_mib(sess._verify_graph.graph),
                           draft_graph_pool_mib=graph_pool_mib(sess._draft_graph.graph))
                need = [vbody, "dss_topk_fused"] + ([] if "prefill_chunk" in kw else [FLASH_TC])
                if vpath == "cuda_grouped":
                    need.append("gate_top1")
                if any(launches[n] < 1 for n in need if n) or launches[FLASH_SIMT]:
                    raise SmokeFailure(f"spec {label}: a kernel body of the path never "
                                       f"launched (need {need}): {launches}")
            rows.append(row)
            print(f"[spec] (a) {label}: {n_tok} tokens in {wall:.3f} s = "
                  f"{row['tokens_per_s']:.2f} tokens/s"
                  + f" (steady state {row['steady_tokens_per_s']:.1f})"
                  + (f"; decode step median {row['decode_step_ms_median']:.2f} ms, graph pool "
                     f"{row['decode_graph_pool_mib']} MiB" if draft is None else
                     f"; {spec['emitted_per_step']:.3f} tokens and "
                     f"{spec['accepted_per_step']:.3f} accepted per verify step "
                     f"({spec['spec_steps']} steps), accept rate {spec['accept_rate']:.4f}; "
                     f"verify {row['verify_ms_median']:.2f} ms (replay + head, median), "
                     f"draft {row['draft_call_ms_median']:.2f} ms a call, "
                     f"{row['draft_calls_per_step']:.2f} calls and {row['draft_ms_per_step']:.2f} "
                     f"ms a step; pools verify "
                     f"{row['verify_graph_pool_mib']} MiB, draft "
                     f"{row['draft_graph_pool_mib']} MiB")
                  + f"; captures {row['graph_captures']}; launches {launches}; card {card}",
                  flush=True)
    finally:
        restore()
    base = runs["baseline"]
    drift = {label: _held_within_drift(f"{label} / baseline", run, base, tag="spec")
             for label, run in runs.items() if label != "baseline"}
    self_rate = rows[1]["speculative"]["accept_rate"]
    if self_rate < SPEC_ACCEPT_MIN:
        raise SmokeFailure(f"spec: the self-draft accepts {self_rate:.4f} of its proposals "
                           f"(< {SPEC_ACCEPT_MIN})")
    sampled = [session("sampled self-draft", "self", sampled=True)[0] for _ in range(2)]
    if sampled[0] != sampled[1]:
        raise SmokeFailure("spec: a sampled speculative run did not repeat token for token")
    out.update(sessions=rows, drift={"allowed": BF16_DRIFT, **drift},
               verify_path=vpath, verify_body=vbody, sampled_repeats=True)
    print(f"[spec] (a) every speculative greedy stream held to the baseline's (drift allowed "
          f"{BF16_DRIFT:.3g}, near-ties twice that): {json.dumps(drift)}; the verify head "
          f"(B {h40.shape[0]}) on {vpath} ({vbody}); the sampled self-draft run "
          f"({SPEC_SAMPLING}) repeats token for token; card {card}", flush=True)


def granite_serving(out: dict, card: str) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model("granite-20b", SEED)
    print(f"[spec] (b) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, H {cfg.n_heads}, "
          f"H_kv {cfg.n_kv_heads}, act {cfg.act}, vocab {cfg.padded_vocab}, K "
          f"{cfg.ds.num_experts}; table v_pad {table.v_pad}; init + pack "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.RandomState(SEED + 9)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in GRANITE_PROMPT_LENS]

    # layer 0's attention of the longest prompt's prefill, through the kernel
    long = torch.from_numpy(prompts[1][None].astype(np.int64)).to("cuda")
    _layer0_attention("(b) granite-20b layer 0", cfg, params, long, tag="spec")

    sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=GRANITE_SEQ,
                        k=K_TOP, kernel="auto", overflow_threshold=BREAKER_OFF, device="cuda")
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=GRANITE_NEW))
            for p in prompts]
    rec = Recorder(sess, reqs)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sess.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ops.launch_counts()
    st = sess.stats()
    for r in reqs:
        if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != GRANITE_NEW \
                or not all(0 <= x < cfg.vocab_size for x in r.out_tokens):
            raise SmokeFailure(f"granite: request ended {r.status} ({r.error}) with "
                               f"{r.out_tokens}")
    for i, hs in rec.heads.items():
        if not all(bool(torch.isfinite(vv).all()) for vv, _ in hs):
            raise SmokeFailure(f"granite: request {i} saw a non-finite top-k value")
    if st["decode_graphs"] != 1:
        raise SmokeFailure(f"granite: {st['decode_graphs']} decode graph captures")
    if launches[FLASH_TC] != len(prompts) * cfg.n_layers or launches[FLASH_SIMT]:
        raise SmokeFailure(f"granite: {launches[FLASH_TC]} {FLASH_TC} launches for "
                           f"{len(prompts)} prefills of {cfg.n_layers} layers ({launches})")
    # the bytes a decode step at the session's median position must move
    pos = [len(p) + GRANITE_NEW // 2 for p in prompts]
    nbytes = backbone_bytes(params, cfg, pos)
    step_ms = 1e3 * statistics.median(rec.decode_s[REPLAYED:])
    row = {"tokens": sum(len(r.out_tokens) for r in reqs), "wall_s": wall,
           "decode_step_ms_median": step_ms, "decode_steps": len(rec.decode_s),
           "backbone_bytes": nbytes, "backbone_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "prefill_ms_longest": 1e3 * rec.prefill_s[1],
           "decode_graph_pool_mib": graph_pool_mib(sess._graph.graph), "launches": launches,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    out["granite"] = row
    print(f"[spec] (b) {row['tokens']} tokens in {wall:.3f} s; decode step median "
          f"{step_ms:.2f} ms against a bytes bound of {row['backbone_bound_ms']:.2f} ms "
          f"(the backbone's {nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"the {len(prompts[1])}-token prefill {row['prefill_ms_longest']:.1f} ms; "
          f"graph pool {row['decode_graph_pool_mib']} MiB; every stream finite; launches "
          f"{launches}; peak memory {row['peak_memory_gib']:.2f} GiB; card {card}", flush=True)
    del sess, rec, params, table, bundle


def wide_heads(out: dict, card: str) -> None:
    """``serve_topk`` at the head shapes of WIDE_HEAD_ARCHS (K, d from the
    config, V_pad from its stand-in mask) on a seeded stand-in table and its
    int8 table, at B 8 and 40 with bf16 tokens: every exact path against
    jnp (ids equal but at near-ties, values within phase 2's tolerance);
    cuda_pertoken, which folds g·h to bf16, against its own plain version
    (``gate_top1_ref``, the fold, ``dss_topk_ref``) to that tolerance and
    against jnp's ids at FOLD_RTOL. Each call's device time from the
    profiler (``traced``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref, registry

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rows = []
    for arch in WIDE_HEAD_ARCHS:
        cfg = get_config(arch)
        K, d = cfg.ds.num_experts, cfg.d_model
        v_pad = -(-int(stand_in_mask(cfg, "cuda").sum(1).max()) // 128) * 128
        w, ids = _table(gen, K, v_pad, d, torch.bfloat16)
        fp = ds.ServeTable(ids=ids, weights=w)
        tables = {"fp": fp, "int8": ds.quantize_table(fp)}
        gate = torch.randn((K, d), generator=gen, device="cuda").mul_(d ** -0.5).to(torch.bfloat16)
        for B in WIDE_HEAD_BATCHES:
            h = torch.randn((B, d), generator=gen, device="cuda").to(torch.bfloat16)
            for kind, table in tables.items():
                want = ds.serve_topk(gate, table, h, K_TOP, kernel="jnp")
                ms = {"jnp": profiled_device_ms(
                    lambda: ds.serve_topk(gate, table, h, K_TOP, kernel="jnp"))}
                errs, parted, bodies = {}, {}, {}
                ctx = ds.serve_kernel_context(table, h, K_TOP)
                sfx = "_q" if kind == "int8" else ""
                needs = {"cuda_grouped": ("gate_top1", registry.grouped_body(ctx) + sfx),
                         "cuda_fused": ("dss_topk_fused" + sfx,),
                         "cuda_pertoken": ("gate_top1", "dss_topk")}
                for path in WIDE_HEAD_PATHS:
                    if path == "cuda_pertoken" and kind == "int8":
                        continue
                    ops.reset_launch_counts()
                    got = ds.serve_topk(gate, table, h, K_TOP, kernel=path)
                    torch.cuda.synchronize()
                    bodies[path] = {n: c for n, c in ops.launch_counts().items() if c}
                    case = f"{arch} {kind} B={B} {path}"
                    if any(bodies[path].get(n, 0) < 1 for n in needs[path]):
                        raise SmokeFailure(f"wide head {case}: launched {bodies[path]}, "
                                           f"needs {needs[path]}")
                    if path == "cuda_pertoken":
                        e, g = ref.gate_top1_ref(gate, h)
                        h_scaled = (h.float() * g[:, None]).to(h.dtype)
                        plain = ref.dss_topk_ref(table.weights, table.ids, h_scaled, e, K_TOP)
                        errs[path], parted[path] = _compare("wide head", case, got, plain)
                        parted[path + " ids vs jnp"] = _parted_rows(
                            f"wide head {case} (against jnp)", *got, *want, rtol=FOLD_RTOL)
                    else:
                        errs[path], parted[path] = _compare("wide head", case, got, want)
                    ms[path] = profiled_device_ms(
                        lambda: ds.serve_topk(gate, table, h, K_TOP, kernel=path))
                over = int(ds.serve_topk(gate, table, h, K_TOP, kernel="cuda_grouped",
                                         with_stats=True)[2]["overflow"].sum())
                row = {"arch": arch, "K": K, "d": d, "v_pad": v_pad, "table": kind, "B": B,
                       "capacity": ctx.capacity, "grouped_overflow": over, "device_ms": ms,
                       "max_abs_err": errs,
                       "rows_parted_at_ties": parted, "launches": bodies,
                       "auto": registry.resolve_kernel("auto", ctx)}
                rows.append(row)
                print(f"[spec] (c) {arch} head (K {K}, d {d}, V_pad {v_pad}) {kind:4s} B={B:2d} "
                      f"C={ctx.capacity}: " + "  ".join(f"{p} {t:.4f}" for p, t in ms.items())
                      + f" ms (device, profiler); auto -> {row['auto']}; grouped overflow "
                      f"{over} tokens; bodies {bodies}; max |err| {errs}; rows parted at "
                      f"near-ties {parted}", flush=True)
        del w, ids, fp, tables
        torch.cuda.empty_cache()
    out["wide_heads"] = rows


# ---------------------------------------------------------------------------
# Phase 6c: the moe and vlm families (olmoe-1b-7b at full width and depth,
# qwen3-moe-235b-a22b at full width with 2 layers, internvl2-26b at full
# width)
# ---------------------------------------------------------------------------

FAMILY_PROMPT_LENS = (16, 2048, 40, 300, 100, 700, 64, 200)
FAMILY_NEW = 24
FAMILY_CHUNK = 128
FAMILY_GAMMA = 4
# >= 2048 + 24 - 1 + gamma; a multiple of the page size and of the chunk
FAMILY_SEQ = 2176
FAMILY_SOLO = 1                  # the request also served alone (the 2048-token prompt)
QWEN3_LAYERS = 2                 # of 94: its 4.83 GB of experts a layer
QWEN3_PROMPT_LENS = (1024, 16, 300, 64)
QWEN3_NEW = 16
QWEN3_SEQ = 1040                 # >= 1024 + 16 - 1, a multiple of 16
INTERNVL_LAYERS = 48             # all of them: ~47.8 GB in bf16 with the head
INTERNVL_PATCHES, INTERNVL_TEXT = 256, 256
INTERNVL_PROMPT_LENS = (16, 200, 40, 100)
INTERNVL_NEW = 8
INTERNVL_SEQ = 224               # >= 200 + 8 - 1, a multiple of 16


def moe_expert_bytes(cfg) -> int:
    """The bytes of every layer's expert weights (w_gate, w_up, w_down):
    what a decode step reads when its tokens choose every expert, as the
    expert products of ``moe_block`` compute every expert."""
    mc = cfg.moe
    return cfg.n_layers * 3 * mc.num_experts * cfg.d_model * mc.d_ff_expert * cfg.jdtype.itemsize


def _finite_stats(label, st) -> None:
    """Every number in a session's ``stats()`` is finite."""
    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif isinstance(x, float) and not math.isfinite(x):
            raise SmokeFailure(f"{label}: stats(){path} is {x}")
    walk(st, "")


def _plain_attention(cfg):
    """Swap ``layers.flash_attention`` for the plain chunked attention;
    returns a function that restores the kernel."""
    from repro_torch.models import layers

    orig = layers.flash_attention
    layers.flash_attention = lambda q, k, v, device: layers.chunked_causal_attention(
        cfg, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
    return lambda: setattr(layers, "flash_attention", orig)


def _layer0_attention(label, cfg, params, tokens, patches=None, tag="family") -> float:
    """Layer 0's causal attention of one prompt through ``ops.flash_attention``
    (it must launch the tensor-core body once) against the plain version,
    every element within ``flash_attention_limit``; returns the largest
    share of the limit used."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers, transformer
    from repro_torch.testing import flash_attention_limit

    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    batch = {"tokens": tokens} if patches is None else {"tokens": tokens, "patches": patches}
    x, positions, _ = transformer.embed_inputs(params, cfg, batch)
    x = layers.rmsnorm({"scale": params["layers"]["ln1"]["scale"][0]}, x)
    q, k, v = (t.transpose(1, 2) for t in layers._project_qkv(lp, cfg, x, positions))
    before = ops.launch_counts()
    o = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    if after[FLASH_TC] != before[FLASH_TC] + 1 or after[FLASH_SIMT] != before[FLASH_SIMT]:
        raise SmokeFailure(f"{label}: layer 0's attention did not run {FLASH_TC} once "
                           f"({before} -> {after})")
    want = ref.flash_attention_ref(q, k, v)
    worst = float(((o.float() - want.float()).abs() / flash_attention_limit(q, k, v, want)).max())
    if worst > 1.0:
        raise SmokeFailure(f"{label}: flash_attention at H {cfg.n_heads}, H_kv "
                           f"{cfg.n_kv_heads}, dh {cfg.hd} exceeds its limit ({worst:.3g} of it)")
    print(f"[{tag}] {label}: {FLASH_TC} at H {cfg.n_heads}, H_kv {cfg.n_kv_heads}, S "
          f"{q.shape[2]}, dh {cfg.hd}: every element within flash_attention_limit (largest "
          f"{worst:.3g} of it)", flush=True)
    return worst


def family_phase(results: dict, card: str) -> None:
    """(a) olmoe-1b-7b served at full width and depth, (b) qwen3-moe-235b-a22b
    at full width with QWEN3_LAYERS layers and its whole head, (c)
    internvl2-26b at full width with INTERNVL_LAYERS layers and a stub
    patch prefix; each model freed before the next."""
    import torch

    out = results.setdefault("family", {"card": card})
    for fn in (olmoe_serving, qwen3_moe_serving, internvl2_serving):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(out, card)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[family] {fn.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)


def olmoe_serving(out: dict, card: str) -> None:
    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry
    from repro_torch.models import moe
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model("olmoe-1b-7b", SEED)
    mc = cfg.moe
    print(f"[family] (a) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, H {cfg.n_heads}, "
          f"H_kv {cfg.n_kv_heads}, {mc.num_experts} experts top-{mc.top_k} (f "
          f"{mc.d_ff_expert}), vocab {cfg.padded_vocab}, K {cfg.ds.num_experts}; table v_pad "
          f"{table.v_pad}; init + pack {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.RandomState(SEED + 20)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in FAMILY_PROMPT_LENS]
    # the verify head's path and body at this batch (what auto picks)
    h40 = torch.zeros((N_SLOTS * (FAMILY_GAMMA + 1), cfg.d_model), dtype=cfg.jdtype,
                      device="cuda")
    vctx = ds.serve_kernel_context(table, h40, K_TOP)
    vpath = registry.resolve_kernel("auto", vctx)
    vbody = {"cuda_grouped": registry.grouped_body(vctx), "cuda_fused": "dss_topk_fused",
             "cuda_pertoken": "dss_topk"}[vpath]
    # the decode head's (B = N_SLOTS)
    dctx = ds.serve_kernel_context(table, h40[:N_SLOTS], K_TOP)
    dpath = registry.resolve_kernel("auto", dctx)
    dbody = {"cuda_grouped": registry.grouped_body(dctx), "cuda_fused": "dss_topk_fused",
             "cuda_pertoken": "dss_topk"}[dpath]

    def session(label, kernel="auto", which=None, draft=False, record=True, **kw):
        sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=FAMILY_SEQ,
                            k=K_TOP, kernel=kernel, overflow_threshold=BREAKER_OFF,
                            device="cuda", **(dict(draft=(bundle, params, table),
                                                   gamma=FAMILY_GAMMA) if draft else {}), **kw)
        reqs = [Request(prompt=prompts[i],
                        sampling=SamplingParams(max_new_tokens=FAMILY_NEW))
                for i in (range(len(prompts)) if which is None else which)]
        rec = Recorder(sess, reqs) if record else None
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = ops.launch_counts()
        st = sess.stats()
        for r in reqs:
            if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != FAMILY_NEW \
                    or not all(0 <= x < cfg.vocab_size for x in r.out_tokens):
                raise SmokeFailure(f"olmoe {label}: request ended {r.status} ({r.error}) with "
                                   f"{r.out_tokens}")
        if rec is not None:
            for i, hs in rec.heads.items():
                if not all(bool(torch.isfinite(v).all()) for v, _ in hs):
                    raise SmokeFailure(f"olmoe {label}: request {i} saw a non-finite value")
        want = ({"decode_graphs": 0, "draft_graphs": 1, "verify_graphs": 1} if draft
                else {"decode_graphs": 1})
        if {n: st[n] for n in want} != want:
            raise SmokeFailure(f"olmoe {label}: graph captures "
                               f"{ {n: st[n] for n in want} }, want {want}")
        if "paged" in st and (st["paged"]["pages_in_use"]
                              or st["paged"]["pages_free"] != st["paged"]["pages_total"]):
            raise SmokeFailure(f"olmoe {label}: pages still held ({st['paged']})")
        if st["effective_kernel"] != kernel or st["breaker_trips"]:
            raise SmokeFailure(f"olmoe {label}: served through {st['effective_kernel']!r}")
        _finite_stats(f"olmoe {label}", st)
        streams = [list(r.out_tokens) for r in reqs]
        print(f"[family] (a) {label}: {sum(map(len, streams))} tokens in {wall:.3f} s; "
              f"captures { {n: st[n] for n in want} }; launches "
              f"{ {n: c for n, c in launches.items() if c} }", flush=True)
        return streams, rec, st, launches, sess, wall

    restore_gate = _watch_gate()
    try:
        sA, rA, _, lA, sessA, wallA = session("A kernels (auto)")
        sB, rB, _, _, _, _ = session("B plain head (jnp)", kernel="jnp")
        sC, rC, stC, _, _, _ = session("C paged chunked (auto)", paged=True, page_size=PAGE_SIZE,
                                       prefill_chunk=FAMILY_CHUNK)
        sD, rD, _, _, _, _ = session("D chunked plain head (jnp)", kernel="jnp",
                                     prefill_chunk=FAMILY_CHUNK)
    finally:
        restore_gate()
    # the backbones are the same code on the same inputs: only the head's
    # path differs, and both heads are exact
    ab = _held_within_drift("olmoe A/B", (sA, rA), (sB, rB), rtol=TIE_RTOL, tag="family")
    cd = _held_within_drift("olmoe C/D", (sC, rC), (sD, rD), rtol=TIE_RTOL, tag="family")
    need = (dbody, FLASH_TC)
    if any(lA[n] < 1 for n in need) or lA[FLASH_SIMT]:
        raise SmokeFailure(f"olmoe A: a kernel body of the path never launched (need {need}): "
                           f"{lA}")
    attention = olmoe_prefill_attention(cfg, bundle, params, table, prompts[FAMILY_SOLO])
    solo, _, _, _, _, _ = session("solo (request 1 alone)", which=[FAMILY_SOLO], record=False)
    if solo[0] != sA[FAMILY_SOLO]:
        raise SmokeFailure("olmoe: request 1 served alone differs from its stream in the batch")

    # the decode step: the graph's replay, its bound, where its time goes
    g = sessA._graph.graph
    replay = replay_ms(g)
    step_ms = 1e3 * statistics.median(rA.decode_s[REPLAYED:])
    expert_bytes = moe_expert_bytes(cfg)
    pos = [len(p) + FAMILY_NEW for p in prompts]
    nbytes = backbone_bytes(params, cfg, pos)
    x8 = torch.randn((N_SLOTS, 1, cfg.d_model), generator=torch.Generator(device="cuda")
                     .manual_seed(SEED + 21), device="cuda").to(cfg.jdtype)
    lps = [{k: v[i] for k, v in params["layers"]["moe"].items()} for i in range(cfg.n_layers)]
    moe_ms = device_ms(lambda: [moe.moe_block(lp, cfg, x8) for lp in lps], calls=4)
    tr = traced("family olmoe decode replay", lambda: sync_s(
        lambda: [g.replay() for _ in range(3)])[1])
    top = tr.top(10, 3)
    decode = {"step_ms_median": step_ms, "replay_ms": replay,
              "expert_bytes": expert_bytes,
              "expert_bytes_bound_ms": 1e3 * expert_bytes / HBM_BYTES_PER_S,
              "backbone_bytes": nbytes, "backbone_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
              "moe_blocks_device_ms": moe_ms, "moe_share_of_replay": moe_ms / replay,
              "replay_device_busy_ms": tr.busy_us() / 1e3 / 3,
              "replay_device_ops": len(tr.device) / 3, "top_device_ops_ms": top,
              "graph_pool_mib": graph_pool_mib(g)}
    prefill_ms = 1e3 * rA.prefill_s[FAMILY_SOLO]
    long = torch.from_numpy(prompts[FAMILY_SOLO][None].astype(np.int64)).to("cuda")
    warm = warm_prefill_profile(lambda: bundle.prefill(params, table, {"tokens": long},
                                                       k=K_TOP, kernel="auto"),
                                "(6c) olmoe-1b-7b, 2048 tokens")
    print(f"[family] (a) decode step: {step_ms:.3f} ms (median, replay + head), one replay "
          f"{replay:.3f} ms (CUDA events) against the expert-bytes bound "
          f"{decode['expert_bytes_bound_ms']:.3f} ms ({expert_bytes / 1e9:.2f} GB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) and the backbone's "
          f"{decode['backbone_bound_ms']:.3f} ms; the {cfg.n_layers} MoE blocks alone "
          f"{moe_ms:.3f} ms ({decode['moe_share_of_replay']:.1%} of the replay); top device ops "
          f"of a replay {json.dumps(top)}; prefill of {len(long[0])} tokens {prefill_ms:.1f} "
          f"ms in session A, warm {warm['ms_median_of_3']:.1f} ms; card {card}", flush=True)
    del x8, lps, sessA

    # int8 table: every expert on int8 rows (flip threshold 1.0)
    _, _, st8, l8, _, _ = session("int8 (flip threshold 1.0)", record=False,
                                   quantize="int8", quantize_flip_threshold=1.0)
    rep = st8["quantize_report"]
    if rep["n_fallback"] >= cfg.ds.num_experts or not any(
            c for n, c in l8.items() if n.endswith("_q")):
        raise SmokeFailure(f"olmoe int8: no expert served from int8 rows ({rep['n_fallback']} "
                           f"fallbacks; launches {l8})")
    # the self-draft, twice
    spec = [session(f"self-draft gamma {FAMILY_GAMMA} run {i}", draft=True, record=False)
            for i in (1, 2)]
    if spec[0][0] != spec[1][0]:
        raise SmokeFailure("olmoe: a speculative run did not repeat token for token")
    sp = spec[0][2]["speculative"]
    ls = spec[0][3]
    if ls[vbody] < 1 or ls[dbody] < 1:
        raise SmokeFailure(f"olmoe speculative: the verify head's {vbody} or the draft's "
                           f"{dbody} never launched ({ls})")
    out["olmoe"] = {
        "layers": cfg.n_layers, "v_pad": table.v_pad, "tokens": sum(map(len, sA)),
        "wall_s_A": wallA, "decode": decode, "prefill_ms_2048": prefill_ms,
        "prefill_2048_warm": warm,
        "drift": {"allowed": TIE_RTOL, "A/B": ab, "C/D": cd}, "solo_equal": True,
        "prefill_attention": attention,
        "launches_A": lA, "int8": {"n_fallback": rep["n_fallback"], "launches": l8},
        "speculative": sp, "verify_path": vpath, "verify_body": vbody,
        "decode_path": dpath, "decode_body": dbody,
        "speculative_launches": ls, "pages_C": stC["paged"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    print(f"[family] (a) A/B {json.dumps(ab)}; C/D {json.dumps(cd)} (drift allowed "
          f"{TIE_RTOL:.3g}); request 1 alone equals its stream; int8 {rep['n_fallback']} "
          f"fallback experts of {cfg.ds.num_experts}; self-draft accept rate "
          f"{sp['accept_rate']:.4f} ({sp['emitted_per_step']:.3f} tokens a verify step), two runs "
          f"token for token, verify head on {vpath} ({vbody}), decode head on {dpath} "
          f"({dbody}); peak memory "
          f"{out['olmoe']['peak_memory_gib']:.2f} GiB; card {card}", flush=True)
    del params, table, bundle, spec


ROUTER_TIE = 2.0 ** -5           # a routing flip's router gap, at most (relative)


def olmoe_prefill_attention(cfg, bundle, params, table, prompt) -> dict:
    """One whole-prompt prefill of ``prompt`` with every attention call
    recorded: each of the L calls through ``flash_attention_wgmma``, held
    per element within ``flash_attention_limit`` against the plain version
    on the same inputs. Then the same prefill with the plain attention
    swapped in: bf16 attention rounds otherwise, and the MoE router turns
    a rounding into another expert where two experts' probabilities are
    near-equal, after which the two runs' hidden states part by far more
    than the drift rule allows. So the runs' routes are compared layer by
    layer: in the first layer where a token's expert set differs, every
    expert only one run chose must sit within ROUTER_TIE of the k-th
    probability in both runs (a near-tie of the router). Returns the
    readings."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers, moe
    from repro_torch.testing import flash_attention_limit

    tokens = torch.from_numpy(prompt[None].astype("int64")).to("cuda")
    K = cfg.moe.top_k

    def run(plain):
        calls, routes = [], []
        orig_attn, orig_route = layers.flash_attention, moe.route

        def attn(q, k, v, device):
            o = orig_attn(q, k, v, device=device)
            calls.append((q, k, v, o))
            return o

        def route(p, c, x):
            out = orig_route(p, c, x)
            routes.append((out[0][0].cpu(), out[2][0].cpu()))   # probs (S, E), top_e (S, K)
            return out

        restore = _plain_attention(cfg) if plain else None
        if not plain:
            layers.flash_attention = attn
        moe.route = route
        try:
            ops.reset_launch_counts()
            vals, ids, _ = bundle.prefill(params, table, {"tokens": tokens}, k=K_TOP,
                                          kernel="jnp")
            torch.cuda.synchronize()
        finally:
            moe.route = orig_route
            layers.flash_attention = orig_attn
            if restore is not None:
                restore()
        return vals[0].cpu(), ids[0].cpu(), calls, routes, ops.launch_counts()

    vk, ik, calls, rk, counts = run(False)
    if counts[FLASH_TC] != cfg.n_layers or counts[FLASH_SIMT] or len(calls) != cfg.n_layers:
        raise SmokeFailure(f"olmoe prefill: {len(calls)} attention calls, launches {counts}")
    used = []
    for q, k, v, o in calls:
        want = ref.flash_attention_ref(q, k, v)
        used.append(float(((o.float() - want.float()).abs()
                           / flash_attention_limit(q, k, v, want)).max()))
        del want
    del calls
    if max(used) > 1.0:
        raise SmokeFailure(f"olmoe prefill: an attention call exceeds flash_attention_limit "
                           f"({max(used):.3g} of it)")
    vp, ip, _, rp, _ = run(True)
    flips, first, worst = [], None, 0.0
    for layer, ((pk, ek), (pp, ep)) in enumerate(zip(rk, rp)):
        differ = (ek.sort(-1).values != ep.sort(-1).values).any(-1)
        flips.append(int(differ.sum()))
        if first is not None or not bool(differ.any()):
            continue
        first = layer
        kth_k, kth_p = pk.sort(-1, descending=True).values[:, K - 1], \
            pp.sort(-1, descending=True).values[:, K - 1]
        for t in differ.nonzero()[:, 0].tolist():
            only = set(ek[t].tolist()) ^ set(ep[t].tolist())
            for e in only:
                gap = max(float((kth_k[t] - pk[t, e]).abs() / kth_k[t]),
                          float((kth_p[t] - pp[t, e]).abs() / kth_p[t]))
                worst = max(worst, gap)
                if gap > ROUTER_TIE:
                    raise SmokeFailure(f"olmoe prefill: layer {layer}, token {t}: expert {e} "
                                       f"chosen by one run only at a router gap of {gap:.3g} "
                                       f"(> {ROUTER_TIE:.3g})")
    top = abs(float(vp[0]))
    rec = {"tokens": int(tokens.shape[1]), "attention_limit_used": used,
           "routing_flips_per_layer": flips, "first_layer_with_a_flip": first,
           "first_flips_max_router_gap": worst, "ids_equal_to_plain": bool((ik == ip).all()),
           "top1_drift_from_plain": abs(float(vk[0]) - float(vp[0])) / top}
    print(f"[family] (a) prefill of {tokens.shape[1]} tokens: {cfg.n_layers} calls of {FLASH_TC}, "
          f"each within flash_attention_limit (largest {max(used):.3g} of it); against the plain "
          f"attention the router parts at {flips} tokens a layer, first in layer {first}, each "
          f"there at a router near-tie (largest gap {worst:.3g}, allowed {ROUTER_TIE:.3g}); top-k "
          f"ids {'equal' if rec['ids_equal_to_plain'] else 'not equal'} to the plain run's, "
          f"top-1 {rec['top1_drift_from_plain']:.3g} apart (relative)", flush=True)
    return rec


def qwen3_moe_serving(out: dict, card: str) -> None:
    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, registry
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model("qwen3-moe-235b-a22b", SEED,
                                               n_layers=QWEN3_LAYERS)
    print(f"[family] (b) {cfg.name}: {cfg.n_layers} of 94 layers, d {cfg.d_model}, H "
          f"{cfg.n_heads}, H_kv {cfg.n_kv_heads}, dh {cfg.hd}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k}, vocab {cfg.padded_vocab}, K {cfg.ds.num_experts}; table v_pad "
          f"{table.v_pad}; init + pack {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.RandomState(SEED + 22)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in QWEN3_PROMPT_LENS]
    worst = _layer0_attention("(b) qwen3-moe layer 0", cfg, params,
                              torch.from_numpy(prompts[0][None].astype(np.int64)).to("cuda"))
    sess = ServeSession(bundle, params, table, n_slots=len(prompts), max_seq_len=QWEN3_SEQ,
                        k=K_TOP, kernel="auto", overflow_threshold=BREAKER_OFF, device="cuda")
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=QWEN3_NEW)) for p in prompts]
    rec = Recorder(sess, reqs)
    ops.reset_launch_counts()
    sess.run(reqs)
    launches = ops.launch_counts()
    st = sess.stats()
    for i, r in enumerate(reqs):
        if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != QWEN3_NEW \
                or not all(bool(torch.isfinite(v).all()) for v, _ in rec.heads[i]):
            raise SmokeFailure(f"qwen3-moe: request {i} ended {r.status} ({r.error}) or saw a "
                               "non-finite value")
    if st["decode_graphs"] != 1 or launches[FLASH_TC] != len(prompts) * cfg.n_layers:
        raise SmokeFailure(f"qwen3-moe: {st['decode_graphs']} decode graphs, launches {launches}")
    _finite_stats("qwen3-moe", st)
    # the head at B 8 and 40 through auto against jnp
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    gate = params["head"]["gate"]
    heads_ = {}
    for B in (8, 40):
        h = torch.randn((B, cfg.d_model), generator=gen, device="cuda").to(cfg.jdtype)
        ctx = ds.serve_kernel_context(table, h, K_TOP)
        ops.reset_launch_counts()
        got = ds.serve_topk(gate, table, h, K_TOP, kernel="auto")
        torch.cuda.synchronize()
        bodies = {n: c for n, c in ops.launch_counts().items() if c}
        if not bodies:
            raise SmokeFailure(f"qwen3-moe head B={B}: auto launched no kernel body")
        err, parted = _compare("qwen3-moe head", f"B={B} auto",
                               got, ds.serve_topk(gate, table, h, K_TOP, kernel="jnp"))
        heads_[B] = {"auto": registry.resolve_kernel("auto", ctx), "capacity": ctx.capacity,
                     "bodies": bodies,
                     "max_abs_err": err, "rows_parted_at_ties": parted,
                     "device_ms": profiled_device_ms(
                         lambda: ds.serve_topk(gate, table, h, K_TOP, kernel="auto"))}
    out["qwen3_moe"] = {
        "layers": cfg.n_layers, "v_pad": table.v_pad, "layer0_attention_limit_used": worst,
        "decode_step_ms_median": 1e3 * statistics.median(rec.decode_s[REPLAYED:]),
        "prefill_ms_1024": 1e3 * rec.prefill_s[0], "launches": launches, "heads": heads_,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    print(f"[family] (b) {len(prompts)} streams of {QWEN3_NEW} tokens, finite; decode step "
          f"{out['qwen3_moe']['decode_step_ms_median']:.2f} ms (median); the 1024-token prefill "
          f"{out['qwen3_moe']['prefill_ms_1024']:.1f} ms; heads {json.dumps(heads_)}; peak "
          f"memory {out['qwen3_moe']['peak_memory_gib']:.2f} GiB; card {card}", flush=True)
    del sess, rec, params, table, bundle


def internvl2_serving(out: dict, card: str) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model("internvl2-26b", SEED,
                                               n_layers=INTERNVL_LAYERS)
    print(f"[family] (c) {cfg.name}: {cfg.n_layers} of 48 layers, d {cfg.d_model}, H "
          f"{cfg.n_heads}, H_kv {cfg.n_kv_heads}, vocab {cfg.padded_vocab}, K "
          f"{cfg.ds.num_experts}; table v_pad {table.v_pad}; init + pack "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    tokens = torch.randint(0, cfg.vocab_size, (1, INTERNVL_TEXT), generator=gen, device="cuda")
    patches = torch.randn((1, INTERNVL_PATCHES, cfg.d_model), generator=gen, device="cuda")
    batch = {"tokens": tokens, "patches": patches}
    worst = _layer0_attention("(c) internvl2 layer 0 (patches + text)", cfg, params, tokens,
                              patches)

    def prefill(kernel):
        return bundle.prefill(params, table, batch, k=K_TOP, kernel=kernel)

    ops.reset_launch_counts()
    (vk, ik, ck), t_kernel = sync_s(lambda: prefill("auto"))
    counts = ops.launch_counts()
    if counts[FLASH_TC] != cfg.n_layers or counts[FLASH_SIMT] \
            or ck.k.shape[2] != INTERNVL_PATCHES + INTERNVL_TEXT:
        raise SmokeFailure(f"internvl2 prefill: launches {counts}, cache {tuple(ck.k.shape)}")
    restore = _plain_attention(cfg)
    try:
        ops.reset_launch_counts()
        (vp, ip, _), t_plain = sync_s(lambda: prefill("jnp"))
        if any(ops.launch_counts().values()):
            raise SmokeFailure(f"internvl2: the plain prefill launched {ops.launch_counts()}")
    finally:
        restore()
    del ck
    # warm: the median of 3 calls each, kernels and plain
    warm_kernel = statistics.median(1e3 * sync_s(lambda: prefill("auto"))[1] for _ in range(3))
    restore = _plain_attention(cfg)
    try:
        warm_plain = statistics.median(1e3 * sync_s(lambda: prefill("jnp"))[1] for _ in range(3))
    finally:
        restore()
    vk, ik, vp, ip = vk[0].cpu(), ik[0].cpu(), vp[0].cpu(), ip[0].cpu()
    same = ik == ip
    top = abs(float(vp[0]))
    drift = float((vk[same] - vp[same]).abs().max()) / top if bool(same.any()) else 0.0
    if drift > BF16_DRIFT:
        raise SmokeFailure(f"internvl2 prefill: top-k values differ by {drift:.3g} of the top-1")
    _topk_parts_only_at_ties("internvl2 prefill", vk, ik, vp, ip, 2 * BF16_DRIFT * top)
    # a short text-only session
    rng = np.random.RandomState(SEED + 25)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in INTERNVL_PROMPT_LENS]
    sess = ServeSession(bundle, params, table, n_slots=len(prompts), max_seq_len=INTERNVL_SEQ,
                        k=K_TOP, kernel="auto", overflow_threshold=BREAKER_OFF, device="cuda")
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=INTERNVL_NEW))
            for p in prompts]
    sess.run(reqs)
    st = sess.stats()
    if st["decode_graphs"] != 1 or any(
            r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != INTERNVL_NEW
            for r in reqs):
        raise SmokeFailure(f"internvl2 text session: {st['decode_graphs']} decode graphs, "
                           f"{[r.status for r in reqs]}")
    _finite_stats("internvl2", st)
    out["internvl2"] = {
        "layers": cfg.n_layers, "v_pad": table.v_pad, "layer0_attention_limit_used": worst,
        "prefill_tokens": INTERNVL_PATCHES + INTERNVL_TEXT, "kernel_launches": counts,
        "kernel_ms": 1e3 * t_kernel, "plain_ms": 1e3 * t_plain,
        "kernel_ms_warm_median_of_3": warm_kernel, "plain_ms_warm_median_of_3": warm_plain,
        "ids_equal": bool(same.all()),
        "max_drift": drift, "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": card}
    print(f"[family] (c) prefill of {INTERNVL_PATCHES} patches + {INTERNVL_TEXT} tokens: "
          f"{FLASH_TC} launched {counts[FLASH_TC]} times; {1e3 * t_kernel:.1f} ms against "
          f"{1e3 * t_plain:.1f} ms plain (jnp head, chunked attention) on the first call, "
          f"{warm_kernel:.1f} against {warm_plain:.1f} ms warm (median of 3); top-k ids "
          f"{'equal' if bool(same.all()) else 'equal up to near-ties'}, values within "
          f"{drift:.3g} of the top-1 (allowed {BF16_DRIFT:.3g}); text-only session of "
          f"{len(prompts)} streams complete; peak memory "
          f"{out['internvl2']['peak_memory_gib']:.2f} GiB; card {card}", flush=True)
    del sess, params, table, bundle


# ---------------------------------------------------------------------------
# Phase 6d: the state families (mamba2-130m, zamba2-7b)
# ---------------------------------------------------------------------------

STATE_PROMPT_LENS = (16, 512, 40, 300, 100, 200, 64, 24)
STATE_NEW = 24
STATE_CHUNK = 128
STATE_GAMMA = 4
STATE_SEQ = 640                  # >= 512 + 24 - 1 + gamma; a multiple of 16 and of 128
STATE_SYSTEM = 256               # the shared system prompt: two whole chunks
STATE_TAILS = (16, 100, 40, 64)
PREEMPT_LENS = (100, 40)         # the resident (priority 0), then the arrival (priority 5)
ZAMBA_PROMPT_LENS = (16, 300, 40, 100)
ZAMBA_NEW = 16
ZAMBA_SEQ = 384                  # >= 300 + 16 - 1; a multiple of 16 and of 128
ZAMBA_PREFILL = 2048             # the whole-prompt prefill held call by call


def state_bytes(cfg) -> tuple:
    """One slot's recurrent state in bytes: (ssm, conv), summed over the
    layers (fp32 (H, P, N) and the (W-1, conv_dim) conv tail a layer)."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    ssm = cfg.n_layers * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
    conv = cfg.n_layers * (cfg.ssm_conv_width - 1) * conv_dim * cfg.jdtype.itemsize
    return ssm, conv


def state_decode_bytes(cfg, weight_bytes: int, shared_bytes: int, embed_row_bytes: int,
                       pos) -> dict:
    """The bytes one decode step of a state family must move over the slots
    at positions ``pos``: the layers' weights once, the shared block's once
    per application, one embedding row a slot, each slot's conv/ssm state
    read and written, and each application's K and V rows up to each
    slot's position read."""
    from repro_torch.models.hybrid import n_attn_apps

    apps = n_attn_apps(cfg)
    ssm, conv = state_bytes(cfg)
    state = 2 * len(pos) * (ssm + conv)
    kv = apps * int(sum(int(p) + 1 for p in pos)) * 2 * max(cfg.n_kv_heads, 1) * \
        max(cfg.hd, 1) * cfg.jdtype.itemsize if apps else 0
    parts = {"weights": weight_bytes, "shared_block": apps * shared_bytes,
             "embedding_rows": len(pos) * embed_row_bytes, "state_read_write": state,
             "kv_read": kv}
    return {**parts, "total": sum(parts.values())}


def _tree_bytes(t) -> int:
    return sum(_tree_bytes(v) for v in t.values()) if isinstance(t, dict) else t.nbytes


def state_phase(results: dict, card: str) -> None:
    """(a) mamba2-130m at full width and depth, (b) zamba2-7b at full width
    and all 81 layers; each model freed before the next."""
    import torch

    out = results.setdefault("state", {"card": card})
    for fn in (mamba2_serving, zamba2_serving):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn(out, card)
        gc.collect()
        torch.cuda.empty_cache()
        out.setdefault("seconds", {})[fn.__name__] = time.perf_counter() - t0
        print(f"[state] {fn.__name__}: {time.perf_counter() - t0:.1f} s; card {card}", flush=True)


def _head_body(table, B, d, dtype) -> tuple:
    """(path, body) ``auto`` takes for the head at batch ``B``."""
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import registry

    h = torch.zeros((B, d), dtype=dtype, device="cuda")
    ctx = ds.serve_kernel_context(table, h, K_TOP)
    path = registry.resolve_kernel("auto", ctx)
    return path, {"cuda_grouped": registry.grouped_body(ctx), "cuda_fused": "dss_topk_fused",
                  "cuda_pertoken": "dss_topk"}[path]


def _state_session(tag, cfg, bundle, params, table, prompts, new, seq, kernel="auto",
                   record=True, draft=False, priorities=None, **kw):
    """Serve ``prompts`` in one session on the card; checks every request
    completed with in-vocabulary tokens, the graph captures, pages and
    state pages all free after, finite stats. Returns (streams, Recorder,
    stats, launches, session, wall s)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    sess = ServeSession(bundle, params, table, n_slots=kw.pop("n_slots", N_SLOTS),
                        max_seq_len=seq, k=K_TOP, kernel=kernel,
                        overflow_threshold=BREAKER_OFF, device="cuda",
                        **(dict(draft=(bundle, params, table), gamma=STATE_GAMMA) if draft
                           else {}), **kw)
    reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=new)) for p in prompts]
    rec = Recorder(sess, reqs) if record else None
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    sess.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, st = ops.launch_counts(), sess.stats()
    for r in reqs:
        if r.status is not RequestStatus.COMPLETED or len(r.out_tokens) != new \
                or not all(0 <= x < cfg.vocab_size for x in r.out_tokens):
            raise SmokeFailure(f"{tag}: request ended {r.status} ({r.error}) with "
                               f"{r.out_tokens}")
    if rec is not None:
        for i, hs in rec.heads.items():
            if not all(bool(torch.isfinite(v).all()) for v, _ in hs):
                raise SmokeFailure(f"{tag}: request {i} saw a non-finite value")
    graphs = kw.get("decode_graph", None) is not False
    want = ({"decode_graphs": 0, "draft_graphs": int(graphs), "verify_graphs": int(graphs)}
            if draft else {"decode_graphs": int(graphs)})
    if {n: st[n] for n in want} != want:
        raise SmokeFailure(f"{tag}: graph captures {({n: st[n] for n in want})}, want {want}")
    pg = st.get("paged")
    if pg is not None and (pg["pages_in_use"] or pg["state_pages_in_use"]
                           or pg["pages_free"] != pg["pages_total"]):
        raise SmokeFailure(f"{tag}: pages still held ({pg})")
    if st["effective_kernel"] != kernel or st["breaker_trips"]:
        raise SmokeFailure(f"{tag}: served through {st['effective_kernel']!r}")
    _finite_stats(tag, st)
    streams = [list(r.out_tokens) for r in reqs]
    print(f"[state] {tag}: {sum(map(len, streams))} tokens in {wall:.3f} s; captures "
          f"{({n: st[n] for n in want})}; launches {({n: c for n, c in launches.items() if c})}",
          flush=True)
    return streams, rec, st, launches, sess, wall


def _decode_replay(tag, sess, rec, cfg, params, prompts, new, card) -> dict:
    """The decode graph's replay (CUDA events) beside the bytes bound of
    :func:`state_decode_bytes` at the slots' final positions."""
    g = sess._graph.graph
    replay = replay_ms(g)
    step = 1e3 * statistics.median(rec.decode_s[REPLAYED:])
    pos = [len(p) + new for p in prompts] + [0] * (sess.n_slots - len(prompts))
    weights = _tree_bytes(params["layers"]) + _tree_bytes(params["final_norm"])
    shared = _tree_bytes(params.get("shared_attn", {}))
    emb = params["embed"]["table"]
    nbytes = state_decode_bytes(cfg, weights, shared, emb.shape[1] * emb.element_size(), pos)
    bound = 1e3 * nbytes["total"] / HBM_BYTES_PER_S
    tr = traced(f"state {tag} decode replay", lambda: sync_s(
        lambda: [g.replay() for _ in range(3)])[1])
    rec_ = {"replay_ms": replay, "step_ms_median": step, "bytes": nbytes, "bound_ms": bound,
            "replay_over_bound": replay / bound, "graph_pool_mib": graph_pool_mib(g),
            "replay_device_busy_ms": tr.busy_us() / 1e3 / 3,
            "replay_device_ops": len(tr.device) / 3, "top_device_ops_ms": tr.top(6, 3),
            "slots": sess.n_slots, "card": card}
    print(f"[state] {tag} decode: one replay {replay:.3f} ms (CUDA events; step with the head "
          f"{step:.3f} ms median) against the bytes bound {bound:.3f} ms ({nbytes['total'] / 1e9:.3f}"
          f" GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: weights {nbytes['weights'] / 1e9:.3f}, shared "
          f"block {nbytes['shared_block'] / 1e9:.3f}, state read+written "
          f"{nbytes['state_read_write'] / 1e9:.3f}, K/V {nbytes['kv_read'] / 1e9:.4f} GB) over "
          f"{sess.n_slots} slots; {rec_['replay_device_ops']:.0f} device ops a replay, busy "
          f"{rec_['replay_device_busy_ms']:.3f} ms; top {json.dumps(rec_['top_device_ops_ms'])}; "
          f"card {card}", flush=True)
    return rec_


def mamba2_serving(out: dict, card: str) -> None:
    import numpy as np
    import torch

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model("mamba2-130m", SEED)
    ssm, conv = state_bytes(cfg)
    print(f"[state] (a) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, H {cfg.ssm_nheads}, P {cfg.ssm_headdim}, N {cfg.ssm_state}, conv "
          f"{cfg.ssm_conv_width}, vocab {cfg.padded_vocab}, K {cfg.ds.num_experts}; table v_pad "
          f"{table.v_pad}; a slot's state {ssm / 1e6:.3f} MB ssm + {conv / 1e6:.4f} MB conv; "
          f"init + pack {time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.RandomState(SEED + 30)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in STATE_PROMPT_LENS]
    dpath, dbody = _head_body(table, N_SLOTS, cfg.d_model, cfg.jdtype)
    vpath, vbody = _head_body(table, N_SLOTS * (STATE_GAMMA + 1), cfg.d_model, cfg.jdtype)
    run = functools.partial(_state_session, cfg=cfg, bundle=bundle, params=params, table=table)
    t = time.perf_counter()
    restore = _watch_gate()
    try:
        sA, rA, _, lA, sessA, wallA = run("(a) A auto", prompts=prompts, new=STATE_NEW,
                                          seq=STATE_SEQ)
        sB, rB, _, _, _, _ = run("(a) B plain head (jnp)", prompts=prompts, new=STATE_NEW,
                                 seq=STATE_SEQ, kernel="jnp")
        sS, rS, stS, lS, sessS, _ = run(f"(a) self-draft gamma {STATE_GAMMA}", prompts=prompts,
                                        new=STATE_NEW, seq=STATE_SEQ, draft=True)
    finally:
        restore()
    ab = _held_within_drift("mamba2 A/B", (sA, rA), (sB, rB), rtol=TIE_RTOL, tag="state")
    spec_drift = _held_within_drift("mamba2 self-draft / A", (sS, rS), (sA, rA), tag="state")
    if lA[dbody] < 1 or lS[vbody] < 1 or lS[dbody] < 1:
        raise SmokeFailure(f"mamba2: a head body never launched (decode {dbody}, verify "
                           f"{vbody}): A {lA}, self-draft {lS}")
    sE, _, _, _, _, _ = run("(a) A eager", prompts=prompts, new=STATE_NEW, seq=STATE_SEQ,
                            record=False, decode_graph=False)
    if sE != sA:
        raise SmokeFailure("mamba2: the decode graph's streams differ from the eager step's")
    t_core = time.perf_counter() - t
    # paged chunked: 4 requests behind one system prompt of whole chunks
    t = time.perf_counter()
    system = rng.randint(0, cfg.vocab_size, STATE_SYSTEM)
    shared = [np.concatenate([system, rng.randint(0, cfg.vocab_size, n)]).astype(np.int32)
              for n in STATE_TAILS]
    paged = dict(paged=True, page_size=PAGE_SIZE, prefill_chunk=STATE_CHUNK, record=False,
                 prompts=shared, new=STATE_NEW, seq=STATE_SEQ)
    sP, _, stP, _, _, _ = run("(a) paged chunked, prefix sharing", **paged)
    sQ, _, stQ, _, _, _ = run("(a) paged chunked, no sharing", prefix_sharing=False, **paged)
    pg = stP["paged"]
    saved = (len(shared) - 1) * (STATE_SYSTEM // STATE_CHUNK)
    if sP != sQ or pg["prefix_hits"] != len(shared) - 1 or pg["prefill_chunks_saved"] != saved:
        raise SmokeFailure(f"mamba2 prefix sharing: streams equal {sP == sQ}, {pg}")
    # preemption: one state page for two slots; the resident resumes by
    # re-prefilling prompt ++ its tokens in chunks (the SSD dual form, not
    # the recurrence that built its state), so its stream is held to the
    # uncontended one by the drift rule
    pair = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in PREEMPT_LENS]
    paged2 = dict(n_slots=2, paged=True, page_size=PAGE_SIZE, prefill_chunk=STATE_CHUNK)
    from repro_torch.train import Request, SamplingParams, ServeSession

    restore = _watch_gate()
    try:
        sess = ServeSession(bundle, params, table, max_seq_len=STATE_SEQ, k=K_TOP,
                            kernel="auto", overflow_threshold=BREAKER_OFF, device="cuda",
                            state_arena=1, prefix_sharing=False, **paged2)
        reqs = [Request(prompt=p, sampling=SamplingParams(max_new_tokens=STATE_NEW, priority=pr))
                for p, pr in zip(pair, (0, 5))]
        rec = Recorder(sess, reqs)
        sess.submit(reqs[0])
        for _ in range(3):
            sess.step()
        sess.submit(reqs[1])
        sess.run()
        contended = [list(r.out_tokens) for r in reqs]
        uncontended = run("(a) the pair uncontended", prompts=pair, new=STATE_NEW,
                          seq=STATE_SEQ, **paged2)
    finally:
        restore()
    pre = sess.stats()["paged"]
    if pre["preemptions"] < 1 or pre["state_pages_in_use"] or any(
            len(s) != STATE_NEW for s in contended):
        raise SmokeFailure(f"mamba2 preemption: {pre}, {contended}")
    pre_drift = _held_within_drift("mamba2 preempted / uncontended", (contended, rec),
                                   uncontended[:2], tag="state")
    pre_equal = contended == uncontended[0]
    # int8 table: every expert on int8 rows (flip threshold 1.0)
    _, _, st8, l8, _, _ = run("(a) int8 (flip threshold 1.0)", prompts=prompts, new=STATE_NEW,
                              seq=STATE_SEQ, record=False, quantize="int8",
                              quantize_flip_threshold=1.0)
    rep = st8["quantize_report"]
    if rep["n_fallback"] >= cfg.ds.num_experts or not any(
            c for n, c in l8.items() if n.endswith("_q")):
        raise SmokeFailure(f"mamba2 int8: no expert served from int8 rows ({rep['n_fallback']} "
                           f"fallbacks; launches {l8})")
    t_modes = time.perf_counter() - t
    decode = _decode_replay("(a) mamba2-130m", sessA, rA, cfg, params, prompts, STATE_NEW, card)
    sp = stS["speculative"]
    out["mamba2"] = {
        "layers": cfg.n_layers, "v_pad": table.v_pad, "tokens": sum(map(len, sA)),
        "wall_s_A": wallA, "decode": decode,
        "drift": {"A/B": ab, "A/B allowed": TIE_RTOL, "self-draft/A": spec_drift,
                  "self-draft allowed": BF16_DRIFT},
        "graph_equals_eager": True, "launches_A": lA, "decode_path": dpath,
        "decode_body": dbody, "verify_path": vpath, "verify_body": vbody,
        "speculative": sp, "speculative_launches": lS,
        "verify_ms_median": 1e3 * statistics.median(rS.verify_s[REPLAYED:]),
        "prefix_sharing": pg, "no_sharing_equal": True, "preemption": pre,
        "preemption_drift": pre_drift, "preempted_streams_equal": pre_equal,
        "int8": {"n_fallback": rep["n_fallback"], "launches": l8},
        "seconds": {"A_B_spec_eager": t_core, "paged_preempt_int8": t_modes},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    print(f"[state] (a) A/B {json.dumps(ab)} (allowed {TIE_RTOL:.3g}); the graph equals the "
          f"eager step token for token; self-draft accept rate {sp['accept_rate']:.4f} "
          f"({sp['emitted_per_step']:.3f} tokens a verify step), held to A "
          f"{json.dumps(spec_drift)}; prefix sharing {pg['prefix_hits']} hits, "
          f"{pg['prefill_chunks_saved']} chunks saved, streams equal to the unshared session's; "
          f"{pre['preemptions']} preemption(s), streams {'equal to' if pre_equal else 'held to'} "
          f"the uncontended run's {json.dumps(pre_drift)}; int8 "
          f"{rep['n_fallback']} fallback experts of {cfg.ds.num_experts}; decode head {dpath} "
          f"({dbody}), verify head {vpath} ({vbody}); {t_core:.1f} + {t_modes:.1f} s; card "
          f"{card}", flush=True)
    del sessA, sessS, sess, params, table, bundle


def zamba2_prefill_attention(cfg, bundle, params, table, tokens) -> dict:
    """One whole-prompt prefill with every shared-attention call recorded:
    each of the 13 through ``flash_attention_wgmma`` at dh 112, held per
    element within ``flash_attention_limit`` against the plain version on
    the same inputs; then the prefill with the plain attention swapped in:
    top-k values within BF16_DRIFT of the top-1, ids apart only at
    near-ties."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    from repro_torch.models.hybrid import n_attn_apps
    from repro_torch.testing import flash_attention_limit

    apps = n_attn_apps(cfg)
    calls = []
    orig = layers.flash_attention

    def attn(q, k, v, device):
        o = orig(q, k, v, device=device)
        calls.append((q, k, v, o))
        return o

    def prefill():
        return bundle.prefill(params, table, {"tokens": tokens}, k=K_TOP, kernel="auto")

    layers.flash_attention = attn
    try:
        ops.reset_launch_counts()
        (vk, ik, cache), t_kernel = sync_s(prefill)
        counts = ops.launch_counts()
    finally:
        layers.flash_attention = orig
    if counts[FLASH_TC] != apps or counts[FLASH_SIMT] or len(calls) != apps \
            or cache.attn_k.shape[:3] != (apps, 1, tokens.shape[1]):
        raise SmokeFailure(f"zamba2 prefill: {len(calls)} attention calls, launches {counts}, "
                           f"cache {tuple(cache.attn_k.shape)}")
    del cache
    used = []
    for q, k, v, o in calls:
        want = ref.flash_attention_ref(q, k, v)
        used.append(float(((o.float() - want.float()).abs()
                           / flash_attention_limit(q, k, v, want)).max()))
        del want
    dh = calls[0][0].shape[-1]
    del calls
    if max(used) > 1.0 or dh != 112:
        raise SmokeFailure(f"zamba2 prefill: an attention call exceeds flash_attention_limit "
                           f"({max(used):.3g} of it) at dh {dh}")
    warm = statistics.median(1e3 * sync_s(prefill)[1] for _ in range(2))
    restore = _plain_attention(cfg)
    try:
        (vp, ip, _), t_plain = sync_s(prefill)
    finally:
        restore()
    vk, ik, vp, ip = vk[0].cpu(), ik[0].cpu(), vp[0].cpu(), ip[0].cpu()
    same = ik == ip
    top = abs(float(vp[0]))
    drift = float((vk[same] - vp[same]).abs().max()) / top if bool(same.any()) else 0.0
    if drift > BF16_DRIFT:
        raise SmokeFailure(f"zamba2 prefill: top-k values differ by {drift:.3g} of the top-1")
    _topk_parts_only_at_ties("zamba2 prefill", vk, ik, vp, ip, 2 * BF16_DRIFT * top)
    rec = {"tokens": int(tokens.shape[1]), "attention_calls": apps, "dh": dh,
           "attention_limit_used": used, "kernel_launches": counts, "kernel_ms": 1e3 * t_kernel,
           "kernel_ms_warm_median_of_2": warm, "plain_ms": 1e3 * t_plain,
           "ids_equal_to_plain": bool(same.all()), "top1_drift_from_plain": drift}
    print(f"[state] (b) prefill of {tokens.shape[1]} tokens: {apps} shared-attention calls of "
          f"{FLASH_TC} at H {cfg.n_heads}, H_kv {cfg.n_kv_heads}, dh {dh}, each within "
          f"flash_attention_limit (largest {max(used):.3g} of it); {1e3 * t_kernel:.1f} ms (warm "
          f"{warm:.1f}) against {1e3 * t_plain:.1f} ms with the plain attention; top-k ids "
          f"{'equal' if rec['ids_equal_to_plain'] else 'equal up to near-ties'}, values within "
          f"{drift:.3g} of the top-1 (allowed {BF16_DRIFT:.3g})", flush=True)
    return rec


def _drift_readings(a_run, ref_run) -> dict:
    """The drift rule's readings without the rule: per request, the
    emissions on which the greedy streams agree and the largest top-1 value
    drift (relative) over them."""
    (streams, rec), (ref_streams, ref) = a_run, ref_run
    agree, worst = [], 0.0
    for i, (a, b) in enumerate(zip(streams, ref_streams)):
        n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        agree.append(n)
        for j in range(n):
            top = float(ref.heads[i][j][0][0])
            worst = max(worst, abs(float(rec.heads[i][j][0][0]) - top) / abs(top))
    return {"emissions_agreeing": agree, "of": [len(a) for a in streams],
            "max_top1_drift": worst}


def _first_layer_handoff(cfg, bundle, params, table, prompt) -> dict:
    """Layer 0's (conv, ssm) state after ``prompt`` prefilled whole and in
    STATE_CHUNK chunks: before any later layer compounds a rounding, each
    within one bf16 ulp (2^-8) of its largest magnitude."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models.hybrid import HybridCache
    from repro_torch.models.model_zoo import cache_specs

    tok = torch.from_numpy(prompt[None].astype("int64")).to("cuda")
    _, _, whole = bundle.prefill(params, table, {"tokens": tok}, k=K_TOP, kernel="jnp")
    specs = cache_specs(cfg, ShapeConfig(name="h", seq_len=ZAMBA_SEQ, global_batch=1,
                                         kind="decode"))
    cache = HybridCache(*(torch.zeros(sp.shape, dtype=sp.dtype, device="cuda") for sp in specs))
    S = tok.shape[1]
    for lo in range(0, S, STATE_CHUNK):
        n = min(STATE_CHUNK, S - lo)
        buf = torch.zeros((1, STATE_CHUNK), dtype=torch.long, device="cuda")
        buf[0, :n] = tok[0, lo:lo + n]
        bundle.prefill_chunk(params, table, cache, buf, lo, n, k=K_TOP, kernel="jnp")
    rel = {n: float((getattr(cache, n)[0].float() - getattr(whole, n)[0].float()).abs().max())
           / float(getattr(whole, n)[0].float().abs().max()) for n in ("conv", "ssm")}
    if max(rel.values()) > 2.0 ** -8:
        raise SmokeFailure(f"zamba2: layer 0's state after a chunked prefill of {S} tokens "
                           f"differs from the whole prompt's by {rel} (relative)")
    return {"tokens": S, "chunk": STATE_CHUNK, **rel}


def zamba2_serving(out: dict, card: str) -> None:
    """zamba2-7b at full width, all 81 layers, seeded weights. At this
    depth the greedy streams are chaotic in bf16: one rounding of the 13
    attention calls (the plain attention against the kernel, whole
    prompts) already moves a stream's top-1 by up to ~6% within 16 tokens
    (my chip call 3, PR 27), so chunked against whole-prompt prefill is
    not held to the 2^-4 drift rule. What is held: the paged chunked
    session equals the contiguous chunked one token for token; layer 0's
    state after a chunked prefill equals the whole prompt's within a bf16
    ulp; each attention call of a 2048-token prefill is within
    ``flash_attention_limit``; the heads' paths agree at TIE_RTOL; the
    graph equals the eager step."""
    import numpy as np
    import torch

    from repro_torch.models.hybrid import n_attn_apps
    from repro_torch.models.model_zoo import paged_cache_specs
    from repro_torch.serve.paged_cache import N_RESERVED

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model("zamba2-7b", SEED)
    ssm, conv = state_bytes(cfg)
    n_params = sum(x.numel() for x in _flat({n: t for n, t in params.items() if n != "head"}))
    print(f"[state] (b) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, d_inner "
          f"{cfg.d_inner}, H {cfg.ssm_nheads}, N {cfg.ssm_state}; shared block applied "
          f"{n_attn_apps(cfg)} times (attention H {cfg.n_heads}, H_kv {cfg.n_kv_heads}, dh "
          f"{cfg.hd}; MLP {cfg.d_ff}); {n_params / 1e9:.3f} B backbone parameters; vocab "
          f"{cfg.padded_vocab}, K {cfg.ds.num_experts}; table v_pad {table.v_pad}; a slot's state "
          f"{ssm / 1e6:.3f} MB ssm + {conv / 1e6:.3f} MB conv; init + pack "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    tokens = torch.randint(0, cfg.vocab_size, (1, ZAMBA_PREFILL), generator=gen, device="cuda")
    attention = zamba2_prefill_attention(cfg, bundle, params, table, tokens)
    rng = np.random.RandomState(SEED + 32)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in ZAMBA_PROMPT_LENS]
    dpath, dbody = _head_body(table, N_SLOTS, cfg.d_model, cfg.jdtype)
    run = functools.partial(_state_session, cfg=cfg, bundle=bundle, params=params, table=table,
                            prompts=prompts, new=ZAMBA_NEW, seq=ZAMBA_SEQ)
    chunked = dict(prefill_chunk=STATE_CHUNK)
    t = time.perf_counter()
    restore = _watch_gate()
    try:
        sA, rA, _, lA, sessA, wallA = run("(b) A auto")
        sB, rB, _, _, _, _ = run("(b) B plain head (jnp)", kernel="jnp")
        sC, rC, stC, _, sessC, _ = run("(b) C paged chunked (auto)", paged=True,
                                       page_size=PAGE_SIZE, **chunked)
        sD, rD, _, _, _, _ = run("(b) D contiguous chunked (auto)", **chunked)
        plain = _plain_attention(cfg)
        try:
            sP, rP, _, _, _, _ = run("(b) A with the plain attention")
        finally:
            plain()
    finally:
        restore()
    arena = {n: tuple(leaf.shape) for n, leaf in zip(sessC._cache._fields, sessC._cache)}
    arena_gb = {n: leaf.nbytes / 1e9 for n, leaf in zip(sessC._cache._fields, sessC._cache)}
    specs = paged_cache_specs(cfg, 2, PAGE_SIZE, N_RESERVED + 4 * N_SLOTS)
    if arena["ssm"] != specs.ssm.shape:
        raise SmokeFailure(f"zamba2: the paged state arena is {arena['ssm']}, not "
                           f"{specs.ssm.shape}")
    del sessC
    ab = _held_within_drift("zamba2 A/B", (sA, rA), (sB, rB), rtol=TIE_RTOL, tag="state")
    # paging changes addressing only: the paged session equals the
    # contiguous one with the same chunking, token for token
    if sC != sD:
        raise SmokeFailure("zamba2: the paged chunked session's streams differ from the "
                           "contiguous chunked session's")
    # chunked against whole-prompt prefill: the drift rule's readings (not
    # held: see the docstring), beside the same readings for one rounding
    # of the attention alone
    da, pa = _drift_readings((sD, rD), (sA, rA)), _drift_readings((sP, rP), (sA, rA))
    layer0 = _first_layer_handoff(cfg, bundle, params, table, prompts[1])
    if lA[dbody] < 1 or lA[FLASH_TC] < len(prompts) or lA[FLASH_SIMT]:
        raise SmokeFailure(f"zamba2 A: a kernel body of the path never launched (need {dbody}, "
                           f"{FLASH_TC}): {lA}")
    sE, _, _, _, _, _ = run("(b) A eager", record=False, decode_graph=False)
    if sE != sA:
        raise SmokeFailure("zamba2: the decode graph's streams differ from the eager step's")
    t_sessions = time.perf_counter() - t
    decode = _decode_replay("(b) zamba2-7b", sessA, rA, cfg, params, prompts, ZAMBA_NEW, card)
    out["zamba2"] = {
        "layers": cfg.n_layers, "shared_block_applications": n_attn_apps(cfg),
        "backbone_parameters": n_params, "v_pad": table.v_pad, "prefill": attention,
        "decode": decode, "wall_s_A": wallA, "tokens": sum(map(len, sA)),
        "drift": {"A/B": ab, "A/B allowed": TIE_RTOL, "chunked/A": da,
                  "plain attention/A": pa}, "paged_equals_contiguous_chunked": True,
        "layer0_handoff": layer0,
        "graph_equals_eager": True, "launches_A": lA, "decode_path": dpath,
        "decode_body": dbody, "paged_arena_shapes": arena, "paged_arena_gb": arena_gb,
        "pages_C": stC["paged"], "seconds_sessions": t_sessions,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    print(f"[state] (b) A/B {json.dumps(ab)} (allowed {TIE_RTOL:.3g}); the paged chunked "
          f"session equals the contiguous chunked one token for token; chunked against whole "
          f"prompt {json.dumps(da)}, the plain attention against the kernel "
          f"{json.dumps(pa)} (top-1 drift while the streams agree); layer 0's handed-on state, "
          f"chunked against whole {json.dumps(layer0)}; the graph equals the eager step token "
          f"for token; paged "
          f"arena {json.dumps(arena)} = {json.dumps({n: round(g, 3) for n, g in arena_gb.items()})}"
          f" GB; decode head {dpath} ({dbody}); sessions {t_sessions:.1f} s; peak memory "
          f"{out['zamba2']['peak_memory_gib']:.2f} GiB; card {card}", flush=True)
    del sessA, params, table, bundle


def _flat(t):
    for v in t.values():
        yield from (_flat(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# Phase 6e: the encdec family (whisper-base at full width and depth,
# paper-envi at full width)
# ---------------------------------------------------------------------------

ENCDEC_ARCHS = ("whisper-base", "paper-envi")
ENCDEC_PREFIX = 64               # the target prefix each request brings
ENCDEC_NEW = 64                  # greedy decode steps after the prefill
ENCDEC_SEQ = 448                 # the self cache: whisper's decoder context (arXiv:2212.04356)
ENCDEC_KERNELS = ("auto", "cuda_fused", "cuda_grouped", "jnp")
ENCDEC_HEAD_PATHS = ("cuda_fused", "cuda_grouped")


def encdec_decode_bytes(cfg, dec_weight_bytes: int, pos, frames: int, experts: int,
                        v_pad: int) -> dict:
    """The bytes one encdec decode step must move over the slots at
    positions ``pos``: the decoder's weights once, each slot's token and
    position rows, each layer's cross K and V (``frames`` rows a slot) and
    self K and V up to the slot's position read once, and the head's gate
    with the rows of the ``experts`` distinct experts the slots chose
    (``v_pad`` rows each)."""
    item = cfg.jdtype.itemsize
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * item              # a position's K and V
    parts = {"decoder_weights": dec_weight_bytes,
             "embedding_rows": 2 * len(pos) * cfg.d_model * item,
             "cross_kv": cfg.n_layers * len(pos) * frames * kv_row,
             "self_kv": cfg.n_layers * int(sum(int(p) + 1 for p in pos)) * kv_row,
             "head": (cfg.ds.num_experts + experts * v_pad) * cfg.d_model * item}
    return {**parts, "total": sum(parts.values())}


def encdec_phase(results: dict, card: str) -> None:
    """(a) whisper-base at full width and depth, (b) paper-envi at full
    width; each model freed before the next."""
    import torch

    out = results.setdefault("encdec", {"card": card})
    for arch in ENCDEC_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        encdec_serving(out, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
        out.setdefault("seconds", {})[arch] = time.perf_counter() - t0
        print(f"[encdec] {arch}: {time.perf_counter() - t0:.1f} s; card {card}", flush=True)


def _encdec_serve(bundle, params, table, batch, kern, record_attention=False):
    """One prefill of ``batch`` and ENCDEC_NEW greedy decode steps on the
    self cache grown to ENCDEC_SEQ, through head path ``kern``. Returns
    (streams, heads: per request the (vals, ids) of each emission, the
    decode steps' synchronized seconds, the launch counts, the decoder's
    attention calls (q, k, v, o) when ``record_attention``, the final
    cache, the prefill's synchronized seconds)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import encdec, layers

    calls, orig = [], layers.flash_attention

    def attn(q, k, v, device):
        o = orig(q, k, v, device=device)
        calls.append((q, k, v, o))
        return o

    ops.reset_launch_counts()
    if record_attention:
        layers.flash_attention = attn
    try:
        (vals, ids, cache), prefill_s = sync_s(lambda: bundle.prefill(params, table, batch,
                                                                      k=K_TOP, kernel=kern))
    finally:
        layers.flash_attention = orig
    cache = encdec.pad_self_cache(cache, ENCDEC_SEQ)
    B = ids.shape[0]
    emitted = [(vals.cpu(), ids.cpu())]
    pos = torch.full((B,), ENCDEC_PREFIX, dtype=torch.long, device="cuda")
    step_s = []
    for _ in range(ENCDEC_NEW):
        (vals, ids, cache), dt = sync_s(lambda: bundle.decode_step(
            params, table, cache, ids[:, 0], pos, k=K_TOP, kernel=kern))
        step_s.append(dt)
        emitted.append((vals.cpu(), ids.cpu()))
        pos += 1
    launches = ops.launch_counts()
    streams = [[int(e[1][b, 0]) for e in emitted] for b in range(B)]
    heads = [[(e[0][b], e[1][b]) for e in emitted] for b in range(B)]
    return streams, heads, step_s, launches, calls, cache, prefill_s


def encdec_serving(out: dict, card: str, arch: str) -> None:
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops, ref
    from repro_torch.models import encdec
    from repro_torch.models.model_zoo import input_specs
    from repro_torch.testing import flash_attention_limit

    t0 = time.perf_counter()
    cfg, bundle, params, table = _seeded_model(arch, SEED)
    tag = "(a)" if arch == "whisper-base" else "(b)"
    spec = input_specs(cfg, ShapeConfig("encdec", ENCDEC_PREFIX, N_SLOTS, "prefill"))
    F = spec["frames"].shape[1]
    rng = np.random.RandomState(SEED + 40)
    frames = torch.from_numpy(rng.normal(size=(N_SLOTS, F, cfg.d_model)).astype(np.float32)
                              ).to("cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (N_SLOTS, ENCDEC_PREFIX))).to("cuda")
    batch = {"frames": frames, "tokens": tokens}
    print(f"[encdec] {tag} {arch}: {cfg.n_encoder_layers} + {cfg.n_layers} layers, d "
          f"{cfg.d_model}, H {cfg.n_heads}/{cfg.n_kv_heads}, dh {cfg.hd}, d_ff {cfg.d_ff}, "
          f"{cfg.act}, vocab {cfg.padded_vocab}, K {cfg.ds.num_experts}, table v_pad "
          f"{table.v_pad}; {N_SLOTS} requests of {F} frames and {ENCDEC_PREFIX} target tokens, "
          f"{ENCDEC_NEW} greedy steps, self cache {ENCDEC_SEQ}; init + pack "
          f"{time.perf_counter() - t0:.1f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    # encode and prefill: the first call, then warm (median of 3)
    with torch.no_grad():
        memory, enc_first = sync_s(lambda: encdec.encode(params, cfg, frames.to(cfg.jdtype)))
        if memory.shape != (N_SLOTS, F, cfg.d_model) or not bool(torch.isfinite(memory).all()):
            raise SmokeFailure(f"encdec {arch}: encoder memory {tuple(memory.shape)}, finite "
                               f"{bool(torch.isfinite(memory).all())}")
        del memory
        enc_warm = [sync_s(lambda: encdec.encode(params, cfg, frames.to(cfg.jdtype)))[1]
                    for _ in range(3)]
        runs = {kern: _encdec_serve(bundle, params, table, batch, kern,
                                    record_attention=kern == "auto") for kern in ENCDEC_KERNELS}
        first_prefill = runs["auto"][6]
        pre_warm = [sync_s(lambda: bundle.prefill(params, table, batch, k=K_TOP,
                                                  kernel="auto"))[1] for _ in range(3)]
    # every decoder prefill call through the tensor-core attention, held per
    # element to flash_attention_limit
    calls = runs["auto"][4]
    used = []
    for q, k, v, o in calls:
        want = ref.flash_attention_ref(q, k, v)
        used.append(float(((o.float() - want.float()).abs()
                           / flash_attention_limit(q, k, v, want)).max()))
    del calls
    runs["auto"] = runs["auto"][:4] + ((),) + runs["auto"][5:]
    if len(used) != cfg.n_layers or max(used) > 1.0:
        raise SmokeFailure(f"encdec {arch}: {len(used)} decoder attention calls, largest share "
                           f"of flash_attention_limit {max(used, default=0):.3g}")
    # each path's bodies; streams equal to jnp's but at counted near-ties
    dpath, dbody = _head_body(table, N_SLOTS, cfg.d_model, cfg.jdtype)
    needs = {"auto": ("gate_top1", dbody) if dpath == "cuda_grouped" else (dbody,),
             "cuda_fused": NEEDS[("cuda_fused", False)],
             "cuda_grouped": NEEDS[("cuda_grouped", False)], "jnp": ()}
    head_bodies = {n for n, _, _ in ops.BODIES} - {FLASH_TC, FLASH_SIMT}
    launches = {}
    for kern, (streams, heads, _, counts, *_) in runs.items():
        launches[kern] = {n: c for n, c in counts.items() if c}
        if counts[FLASH_TC] != cfg.n_layers or counts[FLASH_SIMT]:
            raise SmokeFailure(f"encdec {arch} {kern}: attention launches {launches[kern]}")
        if any(counts[n] < 1 for n in needs[kern]) or (
                kern == "jnp" and any(counts[n] for n in head_bodies)):
            raise SmokeFailure(f"encdec {arch} {kern}: launched {launches[kern]}, needs "
                               f"{needs[kern]}")
        for b, hs in enumerate(heads):
            for vals, ids in hs:
                if not bool(torch.isfinite(vals).all()) or not bool(
                        ((ids >= 0) & (ids < cfg.vocab_size)).all()):
                    raise SmokeFailure(f"encdec {arch} {kern}: request {b} emitted {vals} "
                                       f"{ids}")
    streams = {k: r[0] for k, r in runs.items()}
    heads = {k: r[1] for k, r in runs.items()}
    parted = _diverge_check(f"encdec {arch}", streams, heads, ENCDEC_KERNELS[:3], "jnp",
                            TIE_RTOL, sampled=None)
    errs = {}
    for kern in ENCDEC_KERNELS[:3]:
        got, want = [], []
        for a, b, ha, hb in zip(streams[kern], streams["jnp"], heads[kern], heads["jnp"]):
            n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
            got += ha[:n + 1]
            want += hb[:n + 1]
        gv, gi = torch.stack([v for v, _ in got]), torch.stack([i for _, i in got])
        wv, wi = torch.stack([v for v, _ in want]), torch.stack([i for _, i in want])
        errs[kern] = _compare(f"encdec {arch}", kern, (gv, gi), (wv, wi))
    # the decoder's head at B 8 on this model's table, phase 2 style
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    gate = params["head"]["gate"]
    h = torch.randn((N_SLOTS, cfg.d_model), generator=gen, device="cuda").to(cfg.jdtype)
    want = ds.serve_topk(gate, table, h, K_TOP, kernel="jnp")
    head = {"jnp_device_ms": profiled_device_ms(
        lambda: ds.serve_topk(gate, table, h, K_TOP, kernel="jnp"))}
    for path in ENCDEC_HEAD_PATHS:
        ops.reset_launch_counts()
        got = ds.serve_topk(gate, table, h, K_TOP, kernel=path)
        torch.cuda.synchronize()
        if any(ops.launch_counts()[n] < 1 for n in NEEDS[(path, False)]):
            raise SmokeFailure(f"encdec {arch} head {path}: launched {ops.launch_counts()}")
        head[path] = {"max_abs_err_parted": _compare(f"encdec {arch} head", path, got, want),
                      "device_ms": profiled_device_ms(
                          lambda: ds.serve_topk(gate, table, h, K_TOP, kernel=path))}
    # the decode step: eager median, one profiled step, its bytes bound
    step_ms = 1e3 * statistics.median(runs["auto"][2][1:])
    cache = runs["auto"][5]
    last = torch.tensor([s[-1] for s in streams["auto"]], device="cuda")
    pos = torch.full((N_SLOTS,), ENCDEC_PREFIX + ENCDEC_NEW, dtype=torch.long, device="cuda")

    def step():
        with torch.no_grad():
            return sync_s(lambda: bundle.decode_step(params, table, cache, last, pos, k=K_TOP,
                                                     kernel="auto"))[1]
    step()
    tr = traced(f"encdec {arch} decode step", step)
    busy = tr.busy_us() / 1e3
    with torch.no_grad():  # the experts this step's hidden states choose
        h_step = bundle.decode_hidden(params, cache, last, pos)
    experts = int(torch.unique(ref.gate_top1_ref(gate, h_step)[0]).numel())
    dec_bytes = _tree_bytes(params["dec_layers"]) + _tree_bytes(params["dec_norm"])
    nbytes = encdec_decode_bytes(cfg, dec_bytes, [ENCDEC_PREFIX + ENCDEC_NEW] * N_SLOTS, F,
                                 experts, table.v_pad)
    bound = 1e3 * nbytes["total"] / HBM_BYTES_PER_S
    rec = {"layers": [cfg.n_encoder_layers, cfg.n_layers], "d": cfg.d_model, "frames": F,
           "v_pad": table.v_pad,
           "encode_ms_first": 1e3 * enc_first,
           "encode_ms_warm_median": 1e3 * statistics.median(enc_warm),
           "prefill_ms_first": 1e3 * first_prefill,
           "prefill_ms_warm_median": 1e3 * statistics.median(pre_warm),
           "decode_step_ms_median": step_ms,
           "step_traced_ms": tr.wall * 1e3, "step_device_busy_ms": busy,
           "step_device_idle_share": 1.0 - busy / (tr.wall * 1e3),
           "step_device_ops": len(tr.device), "step_top_device_ops_ms": tr.top(6),
           "step_bytes": nbytes, "step_bound_ms": bound, "step_over_bound": step_ms / bound,
           "attention_limit_used": used, "launches": launches, "decode_path": dpath,
           "decode_body": dbody, "streams_parted_at_ties": parted,
           "max_abs_err_parted": errs, "head_b8": head,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    out[arch] = rec
    print(f"[encdec] {tag} {arch}: encode {rec['encode_ms_first']:.2f} ms first, "
          f"{rec['encode_ms_warm_median']:.3f} warm; prefill {rec['prefill_ms_first']:.2f} ms "
          f"first, {rec['prefill_ms_warm_median']:.3f} warm (median of 3); {cfg.n_layers} "
          f"{FLASH_TC} calls each within flash_attention_limit (largest {max(used):.3g} of it); "
          f"streams of {', '.join(ENCDEC_KERNELS[:3])} equal to jnp's but {parted} parted at "
          f"near-ties; max |dv| and rows parted {json.dumps(errs)}; decode head {dpath} "
          f"({dbody}); launches {json.dumps(launches)}", flush=True)
    print(f"[encdec] {tag} {arch} decode step (eager): {step_ms:.3f} ms median against the "
          f"bytes bound {bound:.4f} ms ({nbytes['total'] / 1e6:.2f} MB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: decoder weights "
          f"{nbytes['decoder_weights'] / 1e6:.2f}, cross K/V {nbytes['cross_kv'] / 1e6:.2f}, "
          f"self K/V {nbytes['self_kv'] / 1e6:.2f}, head {nbytes['head'] / 1e6:.2f} MB over "
          f"{experts} experts); one traced step {rec['step_traced_ms']:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {rec['step_device_idle_share']:.3f}, "
          f"{len(tr.device)} device ops; top {json.dumps(rec['step_top_device_ops_ms'])}; head "
          f"at B {N_SLOTS} (device ms): jnp {head['jnp_device_ms']:.4f}, "
          + ", ".join(f"{p} {head[p]['device_ms']:.4f}" for p in ENCDEC_HEAD_PATHS)
          + f"; peak memory {rec['peak_memory_gib']:.2f} GiB; card {card}", flush=True)
    del runs, cache, params, table, bundle


# ---------------------------------------------------------------------------
# Phase 7: training (lm-100m at full width) and serving the trained table
# ---------------------------------------------------------------------------

# lm-100m, the repo's real-hardware training preset, as
# examples/train_lm_dssoftmax.py:31-37 writes it (12 layers, d 768, 12
# heads, kv 4, d_ff 2048, V 50,304 padded to 50,688, K 8; bf16, remat
# 'layer'); mitosis takes it to K 16 at TRAIN_MITOSIS_AT.
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS, TRAIN_MITOSIS_AT, TRAIN_CKPT_AT = 24, 12, 16
# the example's lr and warm-up (cosine over the run, as its total_steps
# is its --steps)
TRAIN_LR, TRAIN_WARMUP = 1e-3, 20
TRAIN_PROFILED = 3
TRAIN_PROMPT_LENS = (16, 40, 100, 300, 24, 64, 200, 500)
TRAIN_NEW = 16
# hidden states for serve_topk against logits_dense: every 16th position
# of a held-out batch (8 x 32 rows)
TRAIN_HIDDEN_STRIDE = 16


def lm_100m_config():
    from repro_torch.configs.base import DSSoftmaxConfig, ModelConfig

    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab_size=50304,
        head="ds", ds=DSSoftmaxConfig(num_experts=8, lambda_lasso=1e-5,
                                      lambda_expert=1e-5,
                                      prune_task_loss_threshold=6.0),
    )


def train_model_flops(cfg, params, tokens: int) -> dict:
    """Model FLOPs of one train step (forward and backward, no recompute):
    6·N·T for the layer weights, 12·L·H·dh·S per token for attention
    (the non-causal count of PaLM's appendix B), 6·T·N_pad·d for the DS
    head's logits (each token against its expert's whole table) and
    6·T·K·d for its gate."""
    n_layer = sum(v.numel() for v in _leaves(params["layers"]))
    K = params["head"]["gate"].shape[0]
    out = {"layer_weights": 6 * n_layer * tokens,
           "attention": 12 * cfg.n_layers * cfg.n_heads * cfg.hd * TRAIN_SEQ * tokens,
           "head_logits": 6 * tokens * cfg.padded_vocab * cfg.d_model,
           "head_gate": 6 * tokens * K * cfg.d_model}
    out["total"] = sum(out.values())
    return out


def _leaves(tree):
    from repro_torch.utils import flatten_dict

    return list(flatten_dict(tree).values())


def train_phase(results: dict, card: str) -> None:
    import shutil

    import torch

    from repro_torch.checkpoint import checkpointer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataPipeline, TopicLMStream
    from repro_torch.models import build
    from repro_torch.train import Trainer

    cfg = lm_100m_config()
    out = results.setdefault("train", {"card": card, "config": dataclasses.asdict(cfg)})
    ckpt_root = ROOT / "build" / "chip_train"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    stream = TopicLMStream(vocab=cfg.vocab_size, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=SEED)
    batch_at = lambda i: {"tokens": torch.from_numpy(stream.batch_at(i)).cuda()}  # noqa: E731

    def trainer(hooks=None):
        pipe = DataPipeline(lambda i: {"tokens": stream.batch_at(i)})
        tcfg = TrainConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP,
                           ckpt_dir=str(ckpt_root), ckpt_every=TRAIN_CKPT_AT, keep_ckpts=2,
                           seed=SEED)
        tr = Trainer(build(cfg, device="cuda"), tcfg, iter(pipe), pipeline=pipe,
                     mitosis_steps={TRAIN_MITOSIS_AT: 2 * cfg.ds.num_experts},
                     hooks=hooks or {})
        ckpt_s = []
        save = tr._checkpoint

        def timed_checkpoint(step, state):  # the time the loop waits on a save
            t0 = time.perf_counter()
            save(step, state)
            ckpt_s.append((step, time.perf_counter() - t0))

        tr._checkpoint = timed_checkpoint
        return tr, pipe, ckpt_s

    # each checkpoint's background write (npz, fsync, rename), timed on
    # its thread
    write_s, real_write = [], checkpointer.save

    def timed_write(path, tree, *, meta=None):
        t0 = time.perf_counter()
        real_write(path, tree, meta=meta)
        write_s.append((os.path.basename(path), time.perf_counter() - t0))

    checkpointer.save = timed_write
    try:
        _train_and_serve(cfg, out, stream, batch_at, trainer, write_s, ckpt_root)
    finally:
        checkpointer.save = real_write


def _train_and_serve(cfg, out, stream, batch_at, trainer, write_s, ckpt_root) -> None:
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.core import mitosis
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import topk_stable
    from repro_torch.models import transformer
    from repro_torch.train import Request, SamplingParams, ServeSession
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.utils import flatten_dict

    card = out["card"]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # (a0) every parameter of the full-width model gets a finite, non-zero
    # gradient on the card, and the train step launches no kernel body
    tr, _, ckpt_a = trainer()
    t0 = time.perf_counter()
    state0 = tr.init_state(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = {k: sum(v.numel() for v in _leaves(state0.params[k]))
                for k in state0.params}
    ops.reset_launch_counts()
    (loss0, _), grads = value_and_grad(tr.bundle, state0.params, state0.ds_state, batch_at(0))
    bad = [k for k, g in flatten_dict(grads).items()
           if not (torch.isfinite(g.float()).all() and g.float().abs().sum() > 0)]
    if bad or not torch.isfinite(loss0):
        raise SmokeFailure(f"train: parameters without a finite non-zero gradient: {bad}")
    if any(ops.launch_counts().values()):
        raise SmokeFailure(f"train: the train step launched kernel bodies {ops.launch_counts()}")
    out["params"] = n_params
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}), K {cfg.ds.num_experts}, {cfg.dtype}, "
          f"remat {cfg.remat}; params {json.dumps(n_params)}; init {init_s:.1f} s; all "
          f"{len(flatten_dict(grads))} parameters get a finite non-zero gradient, no kernel "
          f"body launched", flush=True)
    del grads

    # (a) the uninterrupted run: mitosis 8 -> 16, a checkpoint at 16
    snaps = {}
    tr.hooks["on_step"] = lambda s, m, st: snaps.setdefault(s, st) if s == TRAIN_CKPT_AT - 1 \
        else None
    t0 = time.perf_counter()
    final = tr.train(state=state0)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = tr.metrics_history
    dts = [m["dt"] for m in hist]
    step_s = statistics.median(dts)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(tr.cfg, final.params, tokens)
    sizes = final.ds_state.mask.sum(dim=1).tolist()
    K_final = final.params["head"]["gate"].shape[0]
    if K_final != 2 * cfg.ds.num_experts or tr.cfg.ds.num_experts != K_final:
        raise SmokeFailure(f"train: mitosis left K {K_final} (cfg {tr.cfg.ds.num_experts})")
    ce = [m["ce"] for m in hist]
    if not all(np.isfinite([m["loss"] for m in hist])) or not ce[-1] < ce[0]:
        raise SmokeFailure(f"train: CE did not fall ({ce[0]} -> {ce[-1]}) or a loss is not finite")
    out["run"] = {
        "steps": len(hist), "wall_s": wall, "step_ms_median": 1e3 * step_s,
        "step_ms_first": 1e3 * dts[0], "step_ms_mitosis": 1e3 * dts[TRAIN_MITOSIS_AT],
        "tokens_per_s": tokens / step_s, "peak_memory_gib": peak / 2**30,
        "model_flops_per_step": flops, "mfu_bf16_peak": flops["total"] / step_s
        / PEAK_FLOPS["bfloat16"],
        "ce_first": ce[0], "ce_last": ce[-1], "ce": ce,
        "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
        "grad_norm_last": hist[-1]["grad_norm"], "drop_frac_last": hist[-1]["ds_drop_frac"],
        "drop_frac": [m["ds_drop_frac"] for m in hist], "load": [m["ds_load"] for m in hist],
        "expert_sizes": sizes, "memory_ratio": mitosis.memory_ratio(final.ds_state),
        "checkpoint_blocking_s": ckpt_a, "checkpoint_write_s": list(write_s),
        "step_ms_after_checkpoint": 1e3 * dts[TRAIN_CKPT_AT]}
    print(f"[train] (a) {len(hist)} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens in {wall:.1f} s: "
          f"step ms median {1e3 * step_s:.2f} (first {1e3 * dts[0]:.1f}, after mitosis "
          f"{1e3 * dts[TRAIN_MITOSIS_AT]:.1f}) = {tokens / step_s:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB; model FLOPs per step {json.dumps(flops)} = "
          f"{out['run']['mfu_bf16_peak']:.4f} of the 989 TFLOP/s bf16 peak; CE "
          f"{ce[0]:.4f} -> {ce[-1]:.4f}; K {cfg.ds.num_experts} -> {K_final}; expert sizes "
          f"{sizes}; memory_ratio {out['run']['memory_ratio']:.3f}; checkpoints: the loop "
          f"waits {[(s, round(t, 2)) for s, t in ckpt_a]} (step, s), the background writes "
          f"take {[(p, round(t, 2)) for p, t in write_s]}, the step after the first "
          f"{1e3 * dts[TRAIN_CKPT_AT]:.1f} ms; card {card}", flush=True)
    # CE is over the tokens that fit their expert's capacity: the share
    # that did not, and the load term, say what the gate did meanwhile
    print(f"[train] (a) per step: tokens over capacity (ds_drop_frac) "
          f"{[round(d, 4) for d in out['run']['drop_frac']]}; load term "
          f"{[round(v, 4) for v in out['run']['load']]}; CE {[round(c, 4) for c in ce]}",
          flush=True)

    # (a1) a few steps profiled on the trained state (not kept)
    step_fn = tr._step_fn
    batches = [batch_at(TRAIN_STEPS + i) for i in range(TRAIN_PROFILED + 1)]
    st, _ = step_fn(final, batches[0])
    del st
    torch.cuda.synchronize()
    def steps():
        t0 = time.perf_counter()
        for b in batches[1:]:
            st, m = step_fn(final, b)
            del st, m
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    tr_prof = traced("train (a1)", steps)
    wall, busy_us = tr_prof.wall, tr_prof.busy_us()
    prof_row = {
        "traced_step_ms": 1e3 * wall / TRAIN_PROFILED,
        "device_busy_ms_per_step": busy_us / 1e3 / TRAIN_PROFILED,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_idle_share_untraced": 1.0 - busy_us / 1e3 / TRAIN_PROFILED / (1e3 * step_s),
        "device_ops_per_step": len(tr_prof.device) / TRAIN_PROFILED,
        "host_launches_per_step": tr_prof.count(LAUNCH_OPS) / TRAIN_PROFILED,
        "host_syncs_and_copies_per_step": tr_prof.count(SYNC_OPS) / TRAIN_PROFILED,
        "top_device_ops_ms_per_step": tr_prof.top(12, TRAIN_PROFILED)}
    out["profile"] = prof_row
    print(f"[train] (a1) profiled {TRAIN_PROFILED} steps: {json.dumps(prof_row)}", flush=True)
    del batches

    # (a2) resume: drop the final checkpoint, a fresh Trainer (a K-8
    # bundle) resumes at TRAIN_CKPT_AT and runs to the end
    tr_r, pipe_r, ckpt_r = trainer()
    if tr_r.mgr.all_steps() != [TRAIN_CKPT_AT, TRAIN_STEPS]:
        raise SmokeFailure(f"train: checkpoints {tr_r.mgr.all_steps()}")
    shutil.rmtree(tr_r.mgr.step_dir(TRAIN_STEPS))
    snap = snaps[TRAIN_CKPT_AT - 1]
    t0 = time.perf_counter()
    restored, meta = tr_r.mgr.restore(like=snap)
    restore_s = time.perf_counter() - t0
    fs, fr = flatten_dict(snap), flatten_dict(restored)
    if set(fs) != set(fr) or not all(torch.equal(fs[k], fr[k]) and fs[k].dtype == fr[k].dtype
                                     for k in fs):
        raise SmokeFailure("train: the restored checkpoint differs from the state it saved")
    del restored, fr
    resumed = tr_r.train()
    if tr_r.metrics_history[0]["step"] != TRAIN_CKPT_AT or pipe_r.state.step != TRAIN_STEPS \
            or tr_r.cfg.ds.num_experts != K_final:
        raise SmokeFailure(f"train: the resumed run started at "
                           f"{tr_r.metrics_history[0]['step']}, pipeline at "
                           f"{pipe_r.state.step}, K {tr_r.cfg.ds.num_experts}")
    fa, fb = flatten_dict(final), flatten_dict(resumed)
    exact = [k for k in fa if torch.equal(fa[k], fb[k])]
    diff = {k: float((fa[k].float() - fb[k].float()).abs().max()) for k in fa if k not in exact}
    ce_r = [m["ce"] for m in tr_r.metrics_history]
    ce_a = ce[TRAIN_CKPT_AT:]
    out["resume"] = {"bit_identical": len(exact) == len(fa), "leaves": len(fa),
                     "leaves_equal": len(exact), "max_abs_diff": diff, "ce_resumed": ce_r,
                     "restore_s": restore_s, "restore_bit_identical": True,
                     "checkpoint_blocking_s": ckpt_r}
    print(f"[train] (a2) resumed at step {TRAIN_CKPT_AT} from a fresh K-{cfg.ds.num_experts} "
          f"Trainer (restore {restore_s:.1f} s, restored state bit-identical to the saved "
          f"one): final state {'bit-identical' if len(exact) == len(fa) else 'not bit-identical'}"
          f" to the uninterrupted run ({len(exact)} of {len(fa)} leaves equal"
          f"{'; max |diff| ' + json.dumps(diff) if diff else ''}); CE over the resumed steps "
          f"{[round(c, 5) for c in ce_r]} against {[round(c, 5) for c in ce_a]}", flush=True)
    if len(exact) != len(fa):  # bit for bit: a non-deterministic kernel fails here
        raise SmokeFailure("train: the resumed run left the uninterrupted one")
    del resumed, snap, snaps, fa, fb, fs, tr_r
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) serve the trained table through the kernels
    bundle, params, state = tr.bundle, final.params, final.ds_state
    del tr
    table = ds.pack_experts(params["head"], state)
    torch.cuda.synchronize()
    print(f"[train] (b) trained table: K {table.ids.shape[0]}, v_pad {table.v_pad}, d "
          f"{cfg.d_model}, {table.weights.dtype}", flush=True)
    rng_prompts = [stream.batch_at(10_000 + i)[0, :n] for i, n in enumerate(TRAIN_PROMPT_LENS)]
    max_seq = max(TRAIN_PROMPT_LENS) + TRAIN_NEW
    streams, heads, serve_rows = {}, {}, []
    for kern in SESSION_KERNELS:
        sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=max_seq,
                            k=K_TOP, kernel=kern, device="cuda", overflow_threshold=BREAKER_OFF)
        reqs = [Request(prompt=p.astype(np.int32),
                        sampling=SamplingParams(max_new_tokens=TRAIN_NEW))
                for p in rng_prompts]
        rec = Recorder(sess, reqs)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sess.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = ops.launch_counts()
        st = sess.stats()
        for r in reqs:
            if len(r.out_tokens) != TRAIN_NEW or not all(0 <= t < cfg.vocab_size
                                                         for t in r.out_tokens):
                raise SmokeFailure(f"train serve {kern}: a stream of {len(r.out_tokens)} tokens "
                                   f"or a token outside the vocabulary")
        need = NEEDS[(kern, False)] if kern != "auto" else ()
        if any(delta[n] < 1 for n in need + (FLASH_TC,)) or delta[FLASH_SIMT] or (
                kern == "auto" and not any(c for n, c in delta.items()
                                           if n not in (FLASH_TC, FLASH_SIMT))) or (
                kern == "jnp" and any(c for n, c in delta.items()
                                      if n not in (FLASH_TC, FLASH_SIMT))):
            raise SmokeFailure(f"train serve {kern}: launches {delta}")
        if st["effective_kernel"] != kern or st["decode_graphs"] != 1:
            raise SmokeFailure(f"train serve {kern}: {st['effective_kernel']}, "
                               f"{st['decode_graphs']} decode graphs")
        streams[kern], heads[kern] = [list(r.out_tokens) for r in reqs], rec.heads
        row = {"kernel": kern, "wall_s": wall,
               "decode_step_ms_median": 1e3 * statistics.median(rec.decode_s),
               "launches": {n: c for n, c in delta.items() if c}}
        serve_rows.append(row)
        print(f"[train] (b) serve kernel={kern:12s} {json.dumps(row)}", flush=True)
        del sess
    n_div = _diverge_check("train serve", streams, heads, SESSION_KERNELS[:-1], "jnp",
                           TIE_RTOL, sampled=None)
    out["serve"] = {"sessions": serve_rows, "divergences": n_div}
    print(f"[train] (b) greedy streams over the trained table: "
          f"{'token-identical' if n_div == 0 else f'{n_div} near-tie divergences'} across "
          f"{', '.join(SESSION_KERNELS)}", flush=True)

    # serve_topk over real hidden states against logits_dense on the trained mask
    with torch.no_grad():
        toks = torch.from_numpy(stream.batch_at(20_000)[:, :-1]).cuda()
        x, pos, _ = transformer.embed_inputs(params, bundle.cfg, {"tokens": toks})
        h, _ = transformer.forward_hidden(params, bundle.cfg, x, pos)
        h = h[:, ::TRAIN_HIDDEN_STRIDE].reshape(-1, cfg.d_model).contiguous()
        z, (eidx, _, _) = ds.logits_dense(params["head"], state, h, bundle.cfg.ds)
        z = torch.where(state.mask[eidx.long()], z, float("-inf"))
        wv, wi = topk_stable(z, K_TOP)
        del z
        topk_rows = {}
        for kern in SESSION_KERNELS:
            ops.reset_launch_counts()
            gv, gi = ds.serve_topk(params["head"]["gate"], table, h, K_TOP, kernel=kern,
                                   capacity_factor=bundle.cfg.ds.capacity_factor,
                                   device=h.device)
            delta = {n: c for n, c in ops.launch_counts().items() if c}
            if kern != "jnp" and not delta:
                raise SmokeFailure(f"train serve_topk {kern}: no kernel launched")
            err, parted = _compare("train serve_topk", kern, (gv, gi.long()), (wv, wi.long()))
            topk_rows[kern] = {"max_abs_err": err, "rows_parted_at_ties": parted,
                               "launches": delta}
    out["serve_topk"] = {"rows": h.shape[0], **topk_rows}
    print(f"[train] (b) serve_topk over {h.shape[0]} hidden states of the trained model "
          f"against top-{K_TOP} of logits_dense on the trained mask: {json.dumps(topk_rows)}",
          flush=True)
    del params, state, final, table, h
    torch.cuda.empty_cache()


MESH_BATCHES = (1, 8, 40, 2048)     # phase 6f (a): decode, a verify step, a whole prompt
MESH_LOCAL_BATCHES = (8, 2048)      # phase 6f (b)
MESH_EPS = (2, 4)
MESH_SESSION_KERNELS = ("cuda_fused", "auto")
# the bodies a head path launches, by family (the grouped kernel's body
# depends on the capacity, so any of its six counts)
_MESH_BODIES = {"cuda_fused": ("dss_topk_fused", "dss_topk_fused_q"),
                "cuda_grouped": ("dss_topk_grouped", "dss_topk_grouped_q",
                                 "dss_topk_grouped_wgmma", "dss_topk_grouped_wgmma_q",
                                 "dss_topk_grouped_tiled", "dss_topk_grouped_tiled_q"),
                "cuda_pertoken": ("dss_topk",)}


def _mesh_bodies_launched(label, path, delta) -> None:
    """``path``'s bodies launched in ``delta`` (``auto``: whichever path it
    took); ``jnp`` launches no head body."""
    head = {n: c for n, c in delta.items() if not n.startswith("flash_attention")}
    if path == "jnp":
        if any(head.values()):
            raise SmokeFailure(f"{label}: jnp launched head kernels ({head})")
        return
    fams = list(_MESH_BODIES) if path == "auto" else [path]
    if not any(head[n] for f in fams for n in _MESH_BODIES[f]):
        raise SmokeFailure(f"{label}: no {path} body launched ({head})")


def mesh_phase(results: dict, card: str, cfg, bundle, params, cases) -> None:
    """Phase 6f: serving on a mesh, on the one card: (a) the sharded head
    in a 1-rank NCCL group, (b) the ep 2 and 4 local halves one shard after
    another, merged, (c) 1x1 mesh sessions at full width. The process group
    is torn down before the next phase."""
    import tempfile

    from repro_torch.launch import mesh as lmesh

    store = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "store"
    t0 = time.perf_counter()
    lmesh.init_distributed("cuda", store=str(store), rank=0, world_size=1)
    mesh = lmesh.parse_mesh("1x1", device="cuda")
    out = {"nccl_init_s": time.perf_counter() - t0,
           "nccl_socket_ifname": os.environ.get("NCCL_SOCKET_IFNAME")}
    print(f"[mesh] a 1-rank NCCL group over a file store and a 1x1 mesh in "
          f"{out['nccl_init_s']:.2f} s (NCCL_SOCKET_IFNAME={out['nccl_socket_ifname']}); "
          f"card {card}", flush=True)
    try:
        fp = cases[0][1]
        K = cfg.ds.num_experts
        int8 = ds_quantize_half(fp, K)
        _mesh_head(out, card, mesh, params["head"]["gate"], {"fp": fp, "int8": int8})
        _mesh_local_halves(out, card, params["head"]["gate"], {"fp": fp, "int8": int8}, cfg)
        _mesh_sessions(out, card, mesh, cfg, bundle, params, fp, results)
        _mesh_data_rows(out, card, cfg, bundle, params, fp)
    finally:
        lmesh.destroy()
    results["mesh"] = out


def ds_quantize_half(table, K):
    """The int8 table with every odd expert on exact fallback rows (the even
    ones stay on int8 rows): the fused path's owner-rank fixup runs."""
    import torch

    from repro_torch.core import dssoftmax as ds

    return ds.quantize_table(table, fb_mask=torch.arange(K) % 2 == 1)


def _mesh_head(out, card, mesh, gate, tables) -> None:
    """(a) ``serve_topk_sharded`` in the 1-rank NCCL group against
    ``serve_topk`` on the same path: bit for bit, bodies launched, device ms
    of each (the difference is the merge's cost at ep 1) and host µs."""
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    d, k = gate.shape[1], K_TOP
    rows = []
    for tname, table in tables.items():
        shard = ds.shard_table(table, mesh)
        paths = ("auto", "cuda_fused", "cuda_grouped") + (
            ("cuda_pertoken",) if tname == "fp" else ()) + ("jnp",)
        for B in MESH_BATCHES:
            h = torch.randn((B, d), generator=gen, device="cuda").to(gate.dtype)
            for path in paths:
                label = f"mesh (a) {tname} B={B} {path}"
                ops.reset_launch_counts()
                got = ds.serve_topk_sharded(gate, shard, h, k, mesh=mesh, kernel=path)
                torch.cuda.synchronize()
                delta = ops.launch_counts()
                _mesh_bodies_launched(label, path, delta)
                want = ds.serve_topk(gate, table, h, k, kernel=path)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise SmokeFailure(f"{label}: the sharded head is not bit-identical to "
                                       "serve_topk on the same path")
                if not torch.isfinite(got[0]).all():
                    raise SmokeFailure(f"{label}: a non-finite value reached the output")
                row = {"table": tname, "B": B, "path": path,
                       "launches": {n: c for n, c in delta.items() if c}}
                # untimed: jnp at 2048 tokens, and the int8 table at 2048, whose
                # half on fallback rows spends ~0.2 s a call in the gather fixup
                if B != max(MESH_BATCHES) or (path != "jnp" and tname == "fp"):
                    row["sharded_device_ms"] = profiled_device_ms(
                        lambda: ds.serve_topk_sharded(gate, shard, h, k, mesh=mesh, kernel=path))
                    row["serve_topk_device_ms"] = profiled_device_ms(
                        lambda: ds.serve_topk(gate, table, h, k, kernel=path))
                    row["sharded_host_us"] = host_us(
                        lambda: ds.serve_topk_sharded(gate, shard, h, k, mesh=mesh, kernel=path),
                        calls=10)
                    row["serve_topk_host_us"] = host_us(
                        lambda: ds.serve_topk(gate, table, h, k, kernel=path), calls=10)
                    print(f"[mesh] (a) {tname:4s} B={B:4d} {path:13s} bit-identical; device "
                          f"{row['sharded_device_ms']:.4f} ms sharded vs "
                          f"{row['serve_topk_device_ms']:.4f} ms serve_topk; host "
                          f"{row['sharded_host_us']:.0f} vs {row['serve_topk_host_us']:.0f} "
                          f"µs/call; launches {row['launches']}; card {card}", flush=True)
                rows.append(row)
    out["head"] = rows


def _mesh_local_halves(out, card, gate, tables, cfg) -> None:
    """(b) Each rank's local half at ep 2 and 4, one shard after another on
    this one card, through ``cuda_fused`` (``e_base`` = r·K_loc) and
    ``cuda_grouped`` (owned tokens, capacity from the global K), then the
    merge over the stacked carries: ids equal ``serve_topk``'s bit for bit,
    values within rtol 1e-6 / atol 2e-6 (a rank's gather fixup multiplies
    only its own tokens), the concatenated counts equal its counts (K 16
    divides both degrees), no -inf."""
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    d, k, cf = gate.shape[1], K_TOP, cfg.ds.capacity_factor
    rows = []
    for tname, table in tables.items():
        for B in MESH_LOCAL_BATCHES:
            h = torch.randn((B, d), generator=gen, device="cuda").to(gate.dtype)
            for path in ("cuda_fused", "cuda_grouped"):
                want = ds.serve_topk(gate, table, h, k, kernel=path, capacity_factor=cf,
                                     with_stats=True)
                for ep in MESH_EPS:
                    label = f"mesh (b) {tname} B={B} {path} ep={ep}"
                    shards = [ds.table_shard(table, ep, r) for r in range(ep)]
                    K_loc = shards[0].local.ids.shape[0]
                    ops.reset_launch_counts()
                    halves = [ds.serve_topk_local_half(gate, s, h, k, path, capacity_factor=cf,
                                                       with_stats=True) for s in shards]
                    torch.cuda.synchronize()
                    delta = ops.launch_counts()
                    _mesh_bodies_launched(label, path, delta)
                    if any(torch.isinf(v).any() for v, _, _, _ in halves):
                        raise SmokeFailure(f"{label}: a kernel's -inf reached a carry")
                    v, i = ds.merge_carries(torch.stack([x[0] for x in halves]),
                                            torch.stack([x[1] for x in halves]),
                                            halves[0][2], K_loc)
                    disp = torch.cat([x[3]["dispatched"] for x in halves])[:table.ids.shape[0]]
                    over = torch.cat([x[3]["overflow"] for x in halves])[:table.ids.shape[0]]
                    if not torch.equal(i, want[1]):
                        raise SmokeFailure(f"{label}: the merged ids are not bit-identical to "
                                           "serve_topk's")
                    try:
                        torch.testing.assert_close(v, want[0], rtol=1e-6, atol=2e-6)
                    except AssertionError as e:
                        raise SmokeFailure(f"{label}: merged values off serve_topk's: {e}")
                    bitwise = torch.equal(v, want[0])
                    if not (torch.equal(disp, want[2]["dispatched"])
                            and torch.equal(over, want[2]["overflow"])):
                        raise SmokeFailure(f"{label}: the shards' counts disagree with "
                                           "serve_topk's")
                    ms = None if (tname == "int8" and B == max(MESH_LOCAL_BATCHES)) else [
                        profiled_device_ms(lambda s=s: ds.serve_topk_local_half(
                            gate, s, h, k, path, capacity_factor=cf)) for s in shards]
                    row = {"table": tname, "B": B, "path": path, "ep": ep, "shard_device_ms": ms,
                           "overflow": int(over.sum()), "values_bitwise": bitwise,
                           "launches": {n: c for n, c in delta.items() if c}}
                    rows.append(row)
                    print(f"[mesh] (b) {tname:4s} B={B:4d} {path:12s} ep={ep}: merged ids "
                          f"bit-identical, values {'bit-identical' if bitwise else 'within 1e-6'}"
                          f", counts equal; per-shard device ms "
                          f"{ms and [round(x, 4) for x in ms]} (one card running each shard "
                          f"in turn, not a multi-card measurement); launches {row['launches']}; "
                          f"card {card}", flush=True)
    out["local_halves"] = rows


def _mesh_sessions(out, card, mesh, cfg, bundle, params, table, results) -> None:
    """(c) ``ServeSession(mesh=1x1)`` and ``param_mode='fsdp'`` at full width
    on phase 3's requests: streams equal phase 3's sessions without a mesh,
    one decode graph, the path's bodies launched; tokens/s beside phase 3's,
    the rank's resident parameter bytes."""
    import numpy as np
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.train import Request, RequestStatus, SamplingParams, ServeSession

    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    base_tps = {r["kernel"]: r["tokens_per_s"] for r in results["sessions"] if r["group"] == "fp"}
    rows = []
    for mode in ("replicated", "fsdp"):
        for kern in MESH_SESSION_KERNELS:
            label = f"mesh (c) {mode} {kern}"
            ops.reset_launch_counts()
            sess = ServeSession(bundle, params, table, n_slots=N_SLOTS, max_seq_len=MAX_SEQ,
                                k=K_TOP, kernel=kern, mesh=mesh, param_mode=mode, device="cuda",
                                overflow_threshold=BREAKER_OFF)
            reqs = [Request(prompt=p, sampling=SamplingParams(
                max_new_tokens=NEW_TOKENS, temperature=0.8 if i == SAMPLED else 0.0,
                seed=SEED + i)) for i, p in enumerate(prompts)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = sess.stats()
            delta = ops.launch_counts()
            if any(r.status is not RequestStatus.COMPLETED for r in reqs):
                raise SmokeFailure(f"{label}: a request did not complete")
            if [list(r.out_tokens) for r in reqs] != results["fp_streams"][kern]:
                raise SmokeFailure(f"{label}: the streams differ from phase 3's session "
                                   "without a mesh")
            if st["decode_graphs"] != 1:
                raise SmokeFailure(f"{label}: {st['decode_graphs']} decode graph captures")
            here, whole = sess.cache_bytes()
            blk = sess.local_slots
            if blk.splits or (blk.offset, blk.count) != (0, N_SLOTS) or here != whole:
                raise SmokeFailure(f"{label}: one data row must hold every slot's cache "
                                   f"(slots {blk}, {here} of {whole} bytes)")
            for n in NEEDS[(kern, False)] + (FLASH_TC,):
                if delta[n] < 1:
                    raise SmokeFailure(f"{label}: kernel {n} never launched ({delta})")
            n_tok = sum(len(r.out_tokens) for r in reqs)
            row = {"mode": mode, "kernel": kern, "tokens": n_tok, "wall_s": wall,
                   "tokens_per_s": n_tok / wall, "no_mesh_tokens_per_s": base_tps.get(kern),
                   "resident_param_bytes": sharding.tree_shard_bytes(sess.params),
                   "resident_cache_bytes": here,
                   "launches": {n: c for n, c in delta.items() if c}}
            rows.append(row)
            print(f"[mesh] (c) {mode:10s} kernel={kern:10s} streams equal phase 3's; "
                  f"{row['tokens_per_s']:.2f} tokens/s vs {row['no_mesh_tokens_per_s']:.2f} "
                  f"without a mesh; resident params {row['resident_param_bytes'] / 2**30:.3f} "
                  f"GiB and cache {here / 2**30:.3f} GiB (all {N_SLOTS} slots: one data row) "
                  f"on this rank; one decode graph; launches {row['launches']}; "
                  f"card {card}", flush=True)
            del sess
    out["sessions"] = rows


MESH_DATA_ROWS = 2                # phase 6f (d): the emulated data rows
MESH_ROWS_KERNEL = "cuda_fused"


def _mesh_data_rows(out, card, cfg, bundle, params, table) -> None:
    """(d) A data-2 mesh's slot-split decode emulated on the one card
    (``testing.mesh_rows.decode_data_rows``): each data row's block of the
    8 slots stepped in turn against its own block cache, through the
    backbone and the head, the rows' outputs merged; held against the same
    decode on the whole cache: the prefill's emission bit for bit, then the
    drift rule (``_held_within_drift``, BF16_DRIFT) while the streams agree,
    parting only at a near-tie. Each row's cache holds half the whole's
    bytes; the head's bodies and the prefill's attention kernel launched."""
    import types

    import numpy as np
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.testing.mesh_rows import decode_data_rows

    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS[:N_SLOTS]]
    runs = {}
    for n_rows in (1, MESH_DATA_ROWS):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        runs[n_rows] = decode_data_rows(bundle, params, table, prompts, n_rows=n_rows,
                                        new_tokens=NEW_TOKENS, max_seq_len=MAX_SEQ, k=K_TOP,
                                        kernel=MESH_ROWS_KERNEL, device="cuda")
        torch.cuda.synchronize()
        runs[n_rows].wall_s = time.perf_counter() - t0
        runs[n_rows].launches = {n: c for n, c in ops.launch_counts().items() if c}
        for n in NEEDS[(MESH_ROWS_KERNEL, False)] + (FLASH_TC,):
            if runs[n_rows].launches.get(n, 0) < 1:
                raise SmokeFailure(f"mesh (d) {n_rows} rows: kernel {n} never launched")
    whole, split = runs[1], runs[MESH_DATA_ROWS]
    label = f"mesh (d) {MESH_DATA_ROWS} data rows in turn"
    for i in range(N_SLOTS):
        (v0, i0), (v1, i1) = whole.heads[i][0], split.heads[i][0]
        if not (torch.equal(v0, v1) and torch.equal(i0, i1)):
            raise SmokeFailure(f"{label}: slot {i}'s prefill emission differs")
    tail = lambda r: types.SimpleNamespace(  # noqa: E731 — emissions after the prefill's
        heads=[h[1:] for h in r.heads], gates=[g[1:] for g in r.gates])
    read = _held_within_drift(label, ([t[1:] for t in split.tokens], tail(split)),
                              ([t[1:] for t in whole.tokens], tail(whole)), tag="mesh")
    bitwise = split.tokens == whole.tokens and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for ha, hb in zip(split.heads, whole.heads) for a, b in zip(ha, hb))
    row_bytes = [sharding.tree_shard_bytes(c) for c in split.caches]
    whole_bytes = sharding.tree_shard_bytes(whole.caches[0])
    if any(b * MESH_DATA_ROWS != whole_bytes for b in row_bytes):
        raise SmokeFailure(f"{label}: row caches {row_bytes} against the whole {whole_bytes}")
    out["data_rows"] = {"rows": MESH_DATA_ROWS, "kernel": MESH_ROWS_KERNEL,
                        "streams_equal": split.tokens == whole.tokens, "bitwise": bitwise,
                        **read, "row_cache_bytes": row_bytes, "whole_cache_bytes": whole_bytes,
                        "wall_s": {"whole": whole.wall_s, "rows": split.wall_s},
                        "launches": split.launches}
    print(f"[mesh] (d) {N_SLOTS} slots over {MESH_DATA_ROWS} emulated data rows, each row's "
          f"{N_SLOTS // MESH_DATA_ROWS} slots stepped in turn on its own cache "
          f"({row_bytes[0] / 2**30:.3f} GiB a row of {whole_bytes / 2**30:.3f}), "
          f"{MESH_ROWS_KERNEL} head: {NEW_TOKENS} greedy emissions a slot "
          f"{'bit for bit the whole cache' + chr(39) + 's' if bitwise else 'within the drift rule'}"
          f" (max drift {read['max_drift']:.3g}, gate {read['max_gate_drift']:.3g}; partings "
          f"at token/gate near-ties {read['token_ties']}/{read['gate_ties']}); wall "
          f"{whole.wall_s:.2f} s whole, {split.wall_s:.2f} s in rows; launches "
          f"{split.launches}; card {card}", flush=True)
    del runs, whole, split
    torch.cuda.empty_cache()


MESH_TRAIN_STEPS, MESH_TRAIN_MICRO = 6, 2       # phase 7m (a)
MESH_EP_SHARDS = (2, 4, 8)                      # phase 7m (b)
MESH_EP_BATCH, MESH_EP_SEQ = 4, 512
MESH_OLMOE_LAYERS, MESH_OLMOE_STEPS = 2, 3
# phase 7m (b): each EP gradient against moe_block's, per leaf, within this
# share of the leaf's largest magnitude (4 bf16 ulps there: bf16 cotangents
# summed over the shards in another order)
MESH_EP_GRAD_TOL = 2.0 ** -6


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (fp32; 2^-133 at 0)."""
    import torch

    e = torch.floor(torch.log2(torch.clamp(x.float().abs(), min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _hold_states(label, got, want, lr_sum: float) -> str:
    """Phase 7 (a2)'s rule on two TrainStates (``want`` may wait on the
    host): bit for bit, or params within 2·Σlr, moments within rtol 1e-3
    (of each leaf's largest), masks equal; → which held."""
    import torch

    from repro_torch.utils import flatten_dict

    fg, fw = flatten_dict(got), flatten_dict(want)
    if set(fg) != set(fw):
        raise SmokeFailure(f"{label}: the states hold other leaves")
    if all(torch.equal(fg[k], fw[k].to(fg[k].device)) and fg[k].dtype == fw[k].dtype
           for k in fw):
        return "bit for bit"
    for k in fw:
        a, b = fg[k], fw[k].to(fg[k].device)
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                raise SmokeFailure(f"{label}: {k} differs")
            continue
        diff = float((a.float() - b.float()).abs().max())
        if k.startswith("params/"):
            ok = diff <= 2 * lr_sum
        elif k.startswith("opt/step"):
            ok = diff == 0
        else:
            ok = diff <= 1e-3 * float(b.float().abs().max())
        if not ok:
            raise SmokeFailure(f"{label}: {k} differs by {diff}")
    return "within phase 7 (a2)'s rule"


def _timed_steps(step, state, batches):
    """Run ``step`` over ``batches`` → (final state, metrics per step, step ms
    per step, CUDA-synchronized)."""
    import torch

    hist, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist, ms


def mesh_train_phase(results: dict, card: str) -> None:
    """Phase 7m: training on a mesh, on the one card, in a 1-rank NCCL group
    over a file store and a 1x1 mesh: (a) lm-100m through
    ``make_train_step(mesh=)`` against the plain step, (b) olmoe-1b-7b's
    expert-parallel FFN at ep 2, 4 and 8 one shard after another, and a
    2-layer olmoe-1b-7b through the mesh step, (c) (a)'s mesh-trained head
    served by ``ServeSession(mesh=1x1)`` (run right after (a), so (a)'s
    states leave the card before olmoe's arrive). The group is destroyed
    at the end."""
    import tempfile

    import torch

    from repro_torch.launch import mesh as lmesh

    store = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "store"
    lmesh.init_distributed("cuda", store=str(store), rank=0, world_size=1)
    mesh = lmesh.parse_mesh("1x1", device="cuda")
    out = {"card": card}
    try:
        _mesh_serve_trained(out, card, mesh, *_mesh_train_lm(out, card, mesh))
        torch.cuda.empty_cache()
        _mesh_ep_ffn(out, card)
        _mesh_train_olmoe(out, card, mesh)
    finally:
        lmesh.destroy()
        torch.cuda.empty_cache()
    results["mesh_train"] = out


def _mesh_steps(label, card, cfg, mesh, batches, micro, sched=None, lr=TRAIN_LR,
                turns=False):
    """The plain step and the mesh step from the same seeded state over the
    same batches → (row, plain final state on the host, mesh final state,
    bundle). Each run starts from its own seeded init and the steps alone
    hold its state (at most two states on the card at once); the plain
    run's end waits on the host. ``turns``: then both steps timed in turns
    from one seeded state on the first batch (:func:`_step_turns`)."""
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.optim import adam_init
    from repro_torch.train.train_step import TrainState, make_train_step
    from repro_torch.utils import tree_map

    bundle = build(cfg, device="cuda")

    def state0():
        params, ds_state = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
        return TrainState(params, adam_init(params), ds_state)

    tcfg = TrainConfig(lr=lr, microbatches=micro, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    plain_step = make_train_step(bundle, tcfg, sched)
    plain, p_hist, p_ms = _timed_steps(plain_step, state0(), batches)
    plain = tree_map(lambda t: t.cpu(), plain)
    held_state = list(sharding.shard_train_state(mesh, state0()))
    specs = held_state.pop()
    mesh_step = make_train_step(bundle, tcfg, sched, mesh=mesh, shardings=specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with sharding.record_collectives() as rec:
        meshed, m_hist, m_ms = _timed_steps(mesh_step, held_state.pop(), batches)
    peak = torch.cuda.max_memory_allocated()
    if any(ops.launch_counts().values()):
        raise SmokeFailure(f"{label}: the mesh step launched kernel bodies {ops.launch_counts()}")
    lrs = [float(sched(i)) if sched else lr for i in range(len(batches))]
    held = _hold_states(label, meshed, plain, sum(lrs))
    for i, (a, b) in enumerate(zip(m_hist, p_hist)):
        for k in b:
            same = a[k] == b[k] or abs(a[k] - b[k]) <= 1e-3 * abs(b[k])
            if not same or not math.isfinite(a[k]):
                raise SmokeFailure(f"{label}: step {i} {k} {a[k]} against the plain step's {b[k]}")
    row = {"steps": len(batches), "microbatches": micro, "held": held,
           "metrics_equal": m_hist == p_hist,
           "step_ms_median": statistics.median(m_ms[1:]),
           "plain_step_ms_median": statistics.median(p_ms[1:]),
           "resident_train_state_bytes": sharding.tree_shard_bytes(meshed),
           "peak_memory_bytes": peak, "collectives": len(rec),
           "loss": [m["loss"] for m in m_hist], "ce": [m["ce"] for m in m_hist],
           "grad_norm": [m["grad_norm"] for m in m_hist]}
    print(f"[mesh_train] {label}: {len(batches)} steps, microbatches {micro}, the mesh step "
          f"against the plain step: {held}; metrics {'equal' if row['metrics_equal'] else 'within rtol 1e-3'}; "
          f"step ms median {row['step_ms_median']:.2f} (plain {row['plain_step_ms_median']:.2f}); "
          f"resident train state {row['resident_train_state_bytes'] / 2**30:.3f} GiB on this "
          f"rank; peak {peak / 2**30:.2f} GiB; {len(rec)} collectives; CE "
          f"{[round(c, 4) for c in row['ce']]}; card {card}", flush=True)
    if turns:
        s0 = state0()
        row["turns"] = _step_turns({"plain": (plain_step, s0),
                                    "mesh": (mesh_step, sharding.shard_train_state(mesh, s0)[0])},
                                   batches[0])
        del s0
        t = row["turns"]
        print(f"[mesh_train] {label} in turns (plain, mesh, mesh, plain, twice; the last "
              f"{MESH_TURN_STEPS - 1} of {MESH_TURN_STEPS} steps a turn, one state, one batch): "
              f"plain {t['plain']['median']:.2f} ms, mesh {t['mesh']['median']:.2f} ms (median; "
              f"mesh/plain {t['mesh']['median'] / t['plain']['median']:.4f}); card {card}",
              flush=True)
    return row, plain, meshed, bundle


MESH_TURN_STEPS = 4  # a turn's steps; the first is dropped


def _step_turns(steps: dict, batch) -> dict:
    """``{name: (step, state)}`` of two steps timed in turns, as
    ``tools/mesh_step_turns.py`` times them: plain, mesh, mesh, plain,
    twice; each turn runs MESH_TURN_STEPS steps from the same state and
    keeps the last MESH_TURN_STEPS - 1 (synced host clock) → {name:
    {"median", "all"}} in ms."""
    import torch

    out = {k: [] for k in steps}
    for name in ("plain", "mesh", "mesh", "plain") * 2:
        step, state = steps[name]
        for i in range(MESH_TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = step(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            del new, m
            if i:
                out[name].append(1e3 * dt)
    return {k: {"median": statistics.median(v), "all": v} for k, v in out.items()}


MESH_PLACEMENT_SPECS = ("1x2", "2x1", "2x2", "8x1", "4x2")


def _mesh_train_lm(out, card, mesh):
    """(a) lm-100m at full width: phase 7's seeded state and batches, its
    schedule, MESH_TRAIN_STEPS steps of microbatches 2."""
    import torch

    from repro_torch.data import TopicLMStream
    from repro_torch.launch import dryrun
    from repro_torch.optim import make_schedule

    cfg = lm_100m_config()
    stream = TopicLMStream(vocab=cfg.vocab_size, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=SEED)
    batches = [{"tokens": torch.from_numpy(stream.batch_at(i)).cuda()}
               for i in range(MESH_TRAIN_STEPS)]
    sched = make_schedule("cosine", TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    row, plain, meshed, bundle = _mesh_steps("(a) lm-100m", card, cfg, mesh, batches,
                                             MESH_TRAIN_MICRO, sched, turns=True)
    row["placement_counts"] = {
        s: dryrun.train_state_bytes(dict(zip(("data", "model"), map(int, s.split("x")))), plain)
        for s in MESH_PLACEMENT_SPECS}
    out["lm_100m"] = row
    print(f"[mesh_train] (a) lm-100m placed on wider meshes (the dry-run's counts from the "
          f"shapes, not measured: a rank's resident train-state bytes): "
          f"{json.dumps(row['placement_counts'])}", flush=True)
    return bundle, plain, meshed, stream


def _ep_inputs(cfg, gen):
    import torch

    from repro_torch.models import moe

    params = {k: v[0] for k, v in moe.init_moe(gen, cfg, 1, device="cuda").items()}
    x = torch.randn((MESH_EP_BATCH, MESH_EP_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.jdtype)
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    return params, x, dy


def _ep_grads(params, x, run):
    """``run(params, x)`` → (y, load loss, Σ y·dy + load) → (y, load, the
    objective's gradients with respect to x and every param)."""
    import torch

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xr = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y, load, obj = run(leaves, xr)
        grads = torch.autograd.grad(obj, [xr] + list(leaves.values()))
    return y.detach(), load.detach(), dict(zip(["x"] + list(leaves), grads))


def _mesh_ep_ffn(out, card):
    """(b) One layer of olmoe-1b-7b's MoE at full width, bf16 x (4, 512,
    2048): the expert-parallel FFN at ep 2, 4 and 8, each shard's part
    (``moe.moe_ep_local``) run one after another on the card and summed in
    bf16, against ``moe_block``: the forward within the bf16 roundings of
    the partial sums, every gradient within MESH_EP_GRAD_TOL of its leaf's
    largest."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params, x, dy = _ep_inputs(cfg, gen)
    E = cfg.moe.num_experts

    def whole(p, xr):
        y, aux = moe.moe_block(p, cfg, xr)
        return y, aux.load_loss, torch.sum(y.float() * dy) + aux.load_loss

    y_ref, load_ref, g_ref = _ep_grads(params, x, whole)
    rows = []
    for n in MESH_EP_SHARDS:
        parts = []

        def ep(p, xr):
            probs, top_p, top_e, slot, valid = moe.route(p, cfg, xr)
            parts.clear()
            y = None
            for m in range(n):
                blk = {k: p[k][m * (E // n):(m + 1) * (E // n)]
                       for k in ("w_gate", "w_up", "w_down")}
                part = moe.moe_ep_local(blk, cfg, xr, top_e, top_p, slot, valid, m, n)
                parts.append(part.detach())
                y = part if y is None else y + part
            aux = moe.switch_aux(probs, top_e, valid)
            return y, aux.load_loss, torch.sum(y.float() * dy) + aux.load_loss

        y, load, g = _ep_grads(params, x, ep)
        # the partials' roundings, each running sum's, and the reference's
        bound = sum(0.5 * _bf16_ulp(p) for p in parts) + 0.5 * _bf16_ulp(y_ref)
        run = parts[0].float()
        for p in parts[1:]:
            run = (run + p.float()).to(torch.bfloat16).float()
            bound = bound + 0.5 * _bf16_ulp(run)
        excess = float(((y.float() - y_ref.float()).abs() - bound).max())
        if excess > 0:
            raise SmokeFailure(f"mesh_train (b) ep {n}: the forward leaves the bf16 bound by "
                               f"{excess}")
        errs = {}
        for k, want in g_ref.items():
            got = g[k]
            errs[k] = float((got.float() - want.float()).abs().max()
                            / want.float().abs().max())
            if not errs[k] <= MESH_EP_GRAD_TOL:
                raise SmokeFailure(f"mesh_train (b) ep {n}: the {k} gradient differs by "
                                   f"{errs[k]} of its largest")
        row = {"ep": n, "forward_largest_excess": excess,
               "forward_max_abs_err": float((y.float() - y_ref.float()).abs().max()),
               "grad_rel_err": errs}
        rows.append(row)
        print(f"[mesh_train] (b) olmoe-1b-7b EP FFN at ep {n} (one shard after another, B "
              f"{MESH_EP_BATCH} x S {MESH_EP_SEQ}, bf16): forward within the bf16 rounding "
              f"bound (largest excess {excess:.3e}, max |err| "
              f"{row['forward_max_abs_err']:.3e}); gradients of x, the router and every "
              f"expert slice within {MESH_EP_GRAD_TOL} of each leaf's largest "
              f"({json.dumps({k: round(v, 6) for k, v in errs.items()})}); card {card}",
              flush=True)
    out["ep_ffn"] = rows


def _mesh_train_olmoe(out, card, mesh):
    """(b) olmoe-1b-7b at full width with MESH_OLMOE_LAYERS layers through
    MESH_OLMOE_STEPS mesh steps at 1x1 (the EP region with one shard)
    against the plain step, on phase 7's batches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TopicLMStream
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b").replace(n_layers=MESH_OLMOE_LAYERS)
    if not moe.expert_parallel(cfg, mesh):
        raise SmokeFailure("olmoe at 1x1 does not take the expert-parallel FFN")
    stream = TopicLMStream(vocab=cfg.vocab_size, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=SEED)
    batches = [{"tokens": torch.from_numpy(stream.batch_at(i)).cuda()}
               for i in range(MESH_OLMOE_STEPS)]
    row, plain, meshed, _ = _mesh_steps(f"(b) olmoe-1b-7b, {MESH_OLMOE_LAYERS} layers", card,
                                        cfg, mesh, batches, 1)
    out["olmoe"] = row
    del plain, meshed
    torch.cuda.empty_cache()


def _mesh_serve_trained(out, card, mesh, bundle, plain, meshed, stream):
    """(c) (a)'s mesh-trained head packed and served by
    ``ServeSession(mesh=1x1)`` through cuda_fused and auto on 8 greedy
    prompts, against the same sessions on the plain-trained head."""
    import numpy as np
    import torch

    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.train import Request, SamplingParams, ServeSession
    from repro_torch.utils import tree_map

    specs = sharding.train_state_shardings(mesh, plain)
    whole = sharding.gather_tree(mesh, meshed, specs)
    plain = type(plain)(params=tree_map(lambda t: t.cuda(), plain.params), opt=None,
                        ds_state=tree_map(lambda t: t.cuda(), plain.ds_state))
    prompts = [stream.batch_at(10_000 + i)[0, :n] for i, n in enumerate(TRAIN_PROMPT_LENS)]
    max_seq = max(TRAIN_PROMPT_LENS) + TRAIN_NEW
    streams, rows = {}, []
    for name, st in (("mesh", whole), ("plain", plain)):
        table = ds.pack_experts(st.params["head"], st.ds_state)
        for kern in MESH_SESSION_KERNELS:
            sess = ServeSession(bundle, st.params, table, n_slots=N_SLOTS, max_seq_len=max_seq,
                                k=K_TOP, kernel=kern, mesh=mesh, device="cuda",
                                overflow_threshold=BREAKER_OFF)
            reqs = [Request(prompt=p.astype(np.int32),
                            sampling=SamplingParams(max_new_tokens=TRAIN_NEW)) for p in prompts]
            ops.reset_launch_counts()
            sess.run(reqs)
            torch.cuda.synchronize()
            delta = ops.launch_counts()
            _mesh_bodies_launched(f"mesh_train (c) {name} {kern}", kern, delta)
            streams[(name, kern)] = [list(r.out_tokens) for r in reqs]
            rows.append({"head": name, "kernel": kern,
                         "launches": {n: c for n, c in delta.items() if c}})
            del sess
    held = out["lm_100m"]["held"]
    partings = {}
    for kern in MESH_SESSION_KERNELS:
        a, b = streams[("mesh", kern)], streams[("plain", kern)]
        partings[kern] = sum(x != y for x, y in zip(a, b))
        if held == "bit for bit" and partings[kern]:
            raise SmokeFailure(f"mesh_train (c) {kern}: the mesh-trained head's streams differ "
                               "from the plain-trained head's")
    out["serve"] = {"sessions": rows, "streams_parted": partings}
    print(f"[mesh_train] (c) the mesh-trained lm-100m head served by ServeSession(mesh=1x1) "
          f"through {', '.join(MESH_SESSION_KERNELS)}: streams against the plain-trained "
          f"head's: {'token-identical' if not any(partings.values()) else partings} "
          f"(phase 7m (a) held {held}); bodies launched {json.dumps(rows)}; card {card}",
          flush=True)


# counted flops over train_model_flops: the remat recompute of each layer's
# forward (+1/3 of the layers'), the chunked attention's causal blocks
# (about half PaLM's non-causal count) and the DS head's losses' extra
# products move it off 1
DRYRUN_FLOPS_RATIO = (0.8, 1.6)
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
                ("qwen2-1.5b", "decode_32k"), ("deepseek-67b", "train_4k"))
# every one must fit a card: a serving rank holds its block of the slots, a
# training rank its blocks of the state and one layer or expert gathered
DRYRUN_MUST_FIT = DRYRUN_CELLS


def dryrun_phase(results: dict, card: str) -> None:
    """Phase 7d: the dry-run's predictions against the card, (a) training,
    (b) serving, (c) production cells traced on the host."""
    import torch

    out = {"card": card}
    try:
        _dryrun_train(out, card)
        torch.cuda.empty_cache()
        _dryrun_serve(out, card)
        torch.cuda.empty_cache()
        _dryrun_rank_cache(out, card)
    finally:
        torch.cuda.empty_cache()
    _dryrun_production(out)
    results["dryrun"] = out


def _dryrun_rank_cache(out, card):
    """(b2) Rank 0 of a 2x1 mesh serving phase 4's decode shape (8 slots x
    MAX_SEQ): the cache the session allocates on the card for its block of
    the slots (``serve_cache_block`` of the rank, ``ServeSession``'s
    allocator) against the dry-run's traced 2x1 rank-0 cache argument, to
    the byte, and half the 1x1 cell's."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models.model_zoo import cache_specs
    from repro_torch.testing.mesh_rows import row_mesh
    from repro_torch.train.serve import _zeros

    cfg = get_config("qwen2-1.5b")
    shape = ShapeConfig(name="phase4_decode", seq_len=MAX_SEQ, global_batch=N_SLOTS,
                        kind="decode")
    one = dryrun.trace_cell(None, cfg, shape).arguments["cache"]
    with fake_world(2):
        mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
        traced = dryrun.trace_cell(mesh, cfg, shape).arguments["cache"]
    blk = sharding.serve_cache_block(row_mesh(2, 0), N_SLOTS)
    cache = _zeros(cache_specs(cfg, ShapeConfig(name="rank0", seq_len=MAX_SEQ,
                                                global_batch=blk.count, kind="decode")),
                   torch.device("cuda"))
    have, want = sharding.tree_shard_bytes(cache), sharding.tree_shard_bytes(traced)
    whole = sharding.tree_shard_bytes(one)
    if have != want or 2 * want != whole:
        raise SmokeFailure(f"dryrun (b2): the 2x1 rank 0's cache on the card {have} bytes, "
                           f"traced {want}, the 1x1 cell's {whole}")
    out["rank_cache"] = {"mesh": "2x1", "rank": 0, "slots": [blk.offset, blk.offset + blk.count],
                         "card_bytes": have, "traced_bytes": want, "whole_bytes": whole}
    print(f"[dryrun] (b2) qwen2-1.5b decode, 2x1 rank 0 (slots [{blk.offset}, "
          f"{blk.offset + blk.count}) of {N_SLOTS} x {MAX_SEQ}): cache on the card {have} bytes "
          f"= the dry-run's traced rank-0 cache argument, half the 1x1 cell's {whole}; card "
          f"{card}", flush=True)
    del cache


def _step_peak(fn):
    """(fn's result, the bytes it allocated above what was allocated at
    entry, at its peak)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entry = torch.cuda.memory_allocated()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - entry


def _hold_prediction(label, rec, have_args: int, card_peak: int) -> dict:
    """Hold a dry-run record's argument bytes (exactly) and step peak
    (within ``launch.dryrun.PEAK_RTOL``/``PEAK_ATOL``) against the card's."""
    from repro_torch.launch import dryrun

    m = rec["memory"]
    if m["argument_bytes"] != have_args:
        raise SmokeFailure(f"dryrun {label}: traced argument bytes {m['argument_bytes']} "
                           f"against the card's {have_args}")
    pred = m["step_bytes"]
    slack = dryrun.PEAK_RTOL * pred + dryrun.PEAK_ATOL
    if abs(card_peak - pred) > slack:
        raise SmokeFailure(f"dryrun {label}: traced step peak {pred} against the card's "
                           f"{card_peak} (margin {slack:.0f})")
    return {"argument_bytes": have_args, "step_peak_traced": pred, "step_peak_card": card_peak,
            "peak_ratio": card_peak / pred, "trace_s": rec["trace_s"],
            "cost": {k: rec["cost"][k] for k in ("flops", "bytes", "ops", "kernel_calls")},
            "roofline": rec["roofline"]}


def _dryrun_train(out, card):
    """(a) lm-100m's plain train step: predicted, then run."""
    import torch

    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data import TopicLMStream
    from repro_torch.distributed.sharding import tree_shard_bytes
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.optim import adam_init
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = lm_100m_config()
    shape = ShapeConfig(name="lm100m_train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        kind="train")
    rec = dryrun.run_cell(None, "1x1", cfg.name, shape.name, cfg=cfg, shape=shape,
                          microbatches=1)
    bundle = build(cfg, device="cuda")
    params, ds_state = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    state = TrainState(params, adam_init(params), ds_state)
    stream = TopicLMStream(vocab=cfg.vocab_size, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=SEED)
    batch = {"tokens": torch.from_numpy(stream.batch_at(0)).cuda()}
    step = make_train_step(bundle, TrainConfig(lr=TRAIN_LR, microbatches=1))
    warm, _ = step(state, batch)  # lazy library state (cuBLAS) comes up outside the measure
    del warm
    (new, _), peak = _step_peak(lambda: step(state, batch))
    del new
    row = _hold_prediction("(a) lm-100m train", rec,
                           tree_shard_bytes(state) + tree_shard_bytes(batch), peak)
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        del new
    model = train_model_flops(cfg, params, TRAIN_BATCH * TRAIN_SEQ)["total"]
    ratio = rec["cost"]["flops"] / model
    lo, hi = DRYRUN_FLOPS_RATIO
    if not lo <= ratio <= hi:
        raise SmokeFailure(f"dryrun (a): counted flops {rec['cost']['flops']:.4e} are "
                           f"{ratio:.3f}x train_model_flops {model:.4e}, outside "
                           f"{DRYRUN_FLOPS_RATIO}")
    row.update({"train_model_flops": model, "flops_ratio": ratio,
                "step_ms_median": statistics.median(ms),
                "roofline_step_ms": 1e3 * rec["roofline"]["step_time_s"]})
    out["train"] = row
    print(f"[dryrun] (a) lm-100m train step: argument bytes {row['argument_bytes']} equal; step "
          f"peak traced {row['step_peak_traced'] / 2**30:.3f} GiB, card "
          f"{row['step_peak_card'] / 2**30:.3f} GiB ({row['peak_ratio']:.4f}x); counted flops "
          f"{rec['cost']['flops']:.4e} = {ratio:.4f}x train_model_flops {model:.4e}; step "
          f"{row['step_ms_median']:.2f} ms (median of 3) against the roofline's "
          f"{row['roofline_step_ms']:.2f} ms ({rec['roofline']['bottleneck']}, "
          f"{rec['cost']['bytes']:.4e} op bytes); traced in {rec['trace_s']:.1f} s; card {card}",
          flush=True)


def _dryrun_serve(out, card):
    """(b) qwen2-1.5b's decode step at phase 4's shape and a 2048-token
    prefill: predicted, then run."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import dssoftmax as ds
    from repro_torch.distributed.sharding import tree_shard_bytes
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.models.model_zoo import cache_specs

    cfg = get_config("qwen2-1.5b")
    bundle = build(cfg, device="cuda")
    params, _ = bundle.init(torch.Generator(device="cuda").manual_seed(SEED))
    table = ds.pack_experts(params["head"], ds.DSState(mask=stand_in_mask(cfg, "cuda")))
    gate_bytes = params["head"]["gate"].nbytes
    params = dict(params, head={"gate": params["head"]["gate"]})  # what a session reads
    torch.cuda.empty_cache()

    def zeros_cache(shape):
        specs = cache_specs(cfg, shape)
        return type(specs)(*(torch.zeros(sp.shape, dtype=sp.dtype, device="cuda")
                             for sp in specs))

    # decode at phase 4's shape
    shape = ShapeConfig(name="phase4_decode", seq_len=MAX_SEQ, global_batch=N_SLOTS,
                        kind="decode")
    rec = dryrun.run_cell(None, "1x1", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape,
                          v_pad=table.v_pad)
    cache = zeros_cache(shape)
    tok = torch.arange(N_SLOTS, dtype=torch.int32, device="cuda")
    pos = torch.tensor([min(n, MAX_SEQ - 1) for n in PROMPT_LENS[:N_SLOTS]], dtype=torch.int32,
                       device="cuda")
    step = lambda: bundle.decode_step(  # noqa: E731
        params, table, cache, tok, pos, with_stats=True)
    step()
    _, peak = _step_peak(step)
    have = tree_shard_bytes({"p": params, "t": table, "c": cache, "b": {"tok": tok, "pos": pos}})
    row = _hold_prediction("(b) qwen2-1.5b decode", rec, have, peak)
    read = rec["memory"]["read_once_bytes_by_kind"]
    traced_read = read.get("params", 0) + read.get("cache", 0)
    full = backbone_bytes(params, cfg, [MAX_SEQ - 1] * N_SLOTS) + gate_bytes
    if traced_read != full:
        raise SmokeFailure(f"dryrun (b): traced read-once bytes of weights and cache "
                           f"{traced_read} against backbone_bytes at a full cache plus the "
                           f"gate {full}")
    row["step_ms"] = time_ms(step, reps=10)
    hidden = lambda: bundle.decode_hidden(params, cache, tok, pos)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            hidden()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hidden()
    row["backbone_replay_ms"] = replay_ms(graph)
    del graph
    row.update({"read_once_bytes": traced_read, "backbone_bytes_full_cache": full,
                "roofline_step_ms": 1e3 * rec["roofline"]["step_time_s"]})
    out["decode"] = row
    print(f"[dryrun] (b) qwen2-1.5b decode, {N_SLOTS} slots x {MAX_SEQ}: argument bytes {have} "
          f"equal; step peak traced {row['step_peak_traced'] / 2**20:.1f} MiB, card "
          f"{row['step_peak_card'] / 2**20:.1f} MiB ({row['peak_ratio']:.4f}x); read-once "
          f"weights and cache {traced_read} = backbone_bytes at a full cache + the gate; op "
          f"bytes {rec['cost']['bytes']:.4e}, roofline {row['roofline_step_ms']:.4f} ms "
          f"({rec['roofline']['bottleneck']}) against the eager step {row['step_ms']:.3f} ms "
          f"and the backbone graph replay {row['backbone_replay_ms']:.3f} ms; card {card}",
          flush=True)
    del cache, step, hidden
    torch.cuda.empty_cache()

    # a 2048-token prefill into a 1-slot cache
    shape = ShapeConfig(name="prefill_2048", seq_len=2048, global_batch=1, kind="prefill")
    rec = dryrun.run_cell(None, "1x1", "qwen2-1.5b", shape.name, cfg=cfg, shape=shape,
                          v_pad=table.v_pad)
    cache = zeros_cache(shape)
    rng = np.random.RandomState(SEED + 7)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 2048))
                                        .astype(np.int32)).cuda()}
    call = lambda: bundle.prefill(params, table, batch)  # noqa: E731
    call()
    _, peak = _step_peak(call)
    have = tree_shard_bytes({"p": params, "t": table, "c": cache, "b": batch})
    row = _hold_prediction("(b) qwen2-1.5b prefill 2048", rec, have, peak)
    row["ms"] = time_ms(call, reps=5)
    row["roofline_ms"] = 1e3 * rec["roofline"]["step_time_s"]
    out["prefill"] = row
    print(f"[dryrun] (b) qwen2-1.5b prefill of 2048 tokens: argument bytes {have} equal; peak "
          f"traced {row['step_peak_traced'] / 2**20:.1f} MiB, card "
          f"{row['step_peak_card'] / 2**20:.1f} MiB ({row['peak_ratio']:.4f}x); op bytes "
          f"{rec['cost']['bytes']:.4e}, flops {rec['cost']['flops']:.4e}, roofline "
          f"{row['roofline_ms']:.3f} ms ({rec['roofline']['bottleneck']}) against "
          f"{row['ms']:.3f} ms; card {card}", flush=True)


def _dryrun_production(out):
    """(c) production cells on the single mesh, traced in a fake world of
    256 ranks on this host."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    rows = []
    with fake_world(256):
        mesh = make_production_mesh()
        for arch, shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(mesh, "single", arch, shape)
            m, rf = rec["memory"], rec["roofline"]
            if (arch, shape) in DRYRUN_MUST_FIT and not m["fits"]:
                raise SmokeFailure(f"dryrun (c): {arch} {shape} does not fit a card "
                                   f"(peak {m['peak_bytes'] / 2**30:.2f} GiB a rank)")
            rows.append({"arch": arch, "shape": shape, "fits": m["fits"],
                         "peak_bytes": m["peak_bytes"], "argument_bytes": m["argument_bytes"],
                         "bottleneck": rf["bottleneck"], "step_time_s": rf["step_time_s"],
                         "trace_s": rec["trace_s"], "wall_s": rec["wall_s"]})
    out["production"] = rows
    print(f"[dryrun] (c) production cells, single mesh (32 x 8, a fake world on the host): "
          f"{json.dumps(rows)}", flush=True)


def main() -> int:
    import torch

    global PARENT
    args = sys.argv[1:]
    if args:
        if len(args) != 2 or args[0] != "--parent" or not Path(args[1]).is_dir():
            print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
            return 2
        PARENT = Path(args[1]).resolve()
    if not torch.cuda.is_available():
        if wait_for_cuda():
            print("chip_smoke: CUDA is up in a fresh process; running again", file=sys.stderr,
                  flush=True)
            sys.stdout.flush()
            os.environ[CUDA_WAITED] = "1"
            os.execv(sys.executable, [sys.executable, str(Path(__file__).resolve()), *args])
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    per_lib = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(per_lib) or 'nothing (cached)'}; "
          f"per library {json.dumps({n: round(s, 2) for n, s in per_lib.items()})}")
    for n in _build.SOURCES:  # registers, spills and ptxas warnings (wgmma serialized: C75xx)
        for line in _build.build_log(n).splitlines():
            if "Used" in line or "warning" in line or "(C75" in line or (
                    "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                print(f"[build] {n}: {line.strip()}")
    results_regs = wgmma_registers(_build.build_log("dss_topk_grouped"))

    results: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                     "wgmma_registers": results_regs}
    phase_s = results.setdefault("phase_s", {"build": time.perf_counter() - t0})
    if PARENT is not None:
        print(f"[build] the parent's {PARENT_SOURCES} from {PARENT}: "
              f"{json.dumps({n: round(x, 2) for n, x in build_parent().items()})} s", flush=True)

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        print(f"[time] {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    timed("kernels", kernel_phase, results)
    cfg, bundle, params, cases = timed("slice", slice_phase, results, card)
    timed("batch", batch_phase, results, card, params, cases)
    mask = stand_in_mask(cfg, "cuda")
    gamma = timed("lasso", lasso_phase, results, params["head"]["experts"], mask)
    timed("profile", profile_phase, results, card, cfg, bundle, params, cases)
    timed("adapt", adapt_phase, results, card, cfg, bundle, params, mask, gamma)
    timed("prefill", prefill_phase, results, card, cfg, bundle, params, cases[0][1])
    timed("mesh", mesh_phase, results, card, cfg, bundle, params, cases)
    del bundle, params, cases
    gc.collect()
    torch.cuda.empty_cache()
    timed("spec", spec_phase, results, card)
    timed("family", family_phase, results, card)
    timed("state", state_phase, results, card)
    timed("encdec", encdec_phase, results, card)
    timed("train", train_phase, results, card)
    timed("mesh_train", mesh_train_phase, results, card)
    timed("dryrun", dryrun_phase, results, card)

    from repro_torch.kernels import ops

    csrc = "src/repro_torch/csrc/"
    # body -> (source, the TPU kernel it replaces, the path whose run counts it)
    bodies = {
        "gate_top1": ("gate_top1.cu", "src/repro/kernels/gate_top1.py:43", "fp"),
        "dss_topk_grouped": ("dss_topk_grouped.cu", "src/repro/kernels/dss_topk_grouped.py:221",
                             "fp"),
        "dss_topk_grouped_q": ("dss_topk_grouped.cu",
                               "src/repro/kernels/dss_topk_grouped.py:148", "int8"),
        "dss_topk_grouped_wgmma": ("dss_topk_grouped.cu",
                                   "src/repro/kernels/dss_topk_grouped.py:221", "batch"),
        "dss_topk_grouped_wgmma_q": ("dss_topk_grouped.cu",
                                     "src/repro/kernels/dss_topk_grouped.py:148", "batch"),
        "dss_topk_grouped_tiled": ("dss_topk_grouped.cu",
                                   "src/repro/kernels/dss_topk_grouped.py:221", "batch_fp32"),
        "dss_topk_grouped_tiled_q": ("dss_topk_grouped.cu",
                                     "src/repro/kernels/dss_topk_grouped.py:148", "batch_fp32"),
        "dss_topk_fused": ("dss_topk_fused.cu", "src/repro/kernels/dss_topk_fused.py:197", "fp"),
        "dss_topk_fused_q": ("dss_topk_fused.cu", "src/repro/kernels/dss_topk_fused.py:120",
                             "int8"),
        "dss_topk": ("dss_topk.cu", "src/repro/kernels/dss_topk.py:110", "pertoken"),
        "lasso_prune": ("lasso_prune.cu", "src/repro/kernels/lasso_prune.py:41", "adapt"),
        "flash_attention_wgmma": ("flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:91", "prefill"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:91",
                            "prefill_fp32"),
    }
    if set(bodies) != {name for name, _, _ in ops.BODIES}:
        raise SmokeFailure("the report does not list every kernel body")
    kernels = []
    for name, (src, replaces, path) in bodies.items():
        m = results["main"][name]
        launches = results["main_path_launches"][path][name]
        if launches < 1:
            raise SmokeFailure(f"{name} never launched on its main path ({path})")
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "device_ms": m["device_ms"], "host_us": m["host_us"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                        "library_device_ms": m["library_device_ms"]})
    results["profile_checks"] = PROFILE_CHECKS
    again = [c for c in PROFILE_CHECKS if c["lost"]]
    print(f"[profiler] {len(PROFILE_CHECKS)} profiles, {len(again)} of them taken again "
          f"after a launch lost its device record (heads {sorted({c['head'] for c in again})}, "
          f"at most {max((c['lost'] for c in again), default=0)} lost)", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
