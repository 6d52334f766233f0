#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one H100 and the CUDA
toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and hidden):

  1. device   the card's name and power limit (nvidia-smi)
  2. build    the CUDA kernels from src/repro_torch/kernels/csrc, one nvcc
              process per source, all started together
  3. kernels  every kernel of the serving path against its plain PyTorch
              version at the serving shapes (bf16, Hq 32, Hkv 4, head 64,
              S 2048), with the times of the kernel, the plain version and
              one PyTorch library call (a yardstick the port never calls),
              and the least time the card could take (the roofline bound),
              with TFLOP/s, GB/s and the share of the bound; chunk
              attention at T 512 and at T 8 deep in the cache (the split-
              column path, which the planner must choose); the paged
              kernels over an arena of 257 pages of 64 rows (block tables
              a random permutation of pages 1..256, scratch page 0 full of
              large finite garbage), also timed beside the dense kernel on
              the equivalent contiguous cache, plus a page_size 16
              correctness case (bf16 chunk attention copies pages by TMA
              at 64 and gathers them at 16); paged chunk output must
              equal the dense kernel's on the same K/V, and so must paged
              decode at page sizes 64, 16 and 5; a decoded row alone
              must equal the same row in the batch of 8, dense and paged,
              and so must a chunk row alone at T 8 and 512 (page sizes
              64 and 16); rmsnorm at a decode tick's rows (8 x 2048, 8 x
              2560), a prefill group and the train step's rows, with the
              launch floor (an empty kernel timed the same way)
  4. forward  full-width tinyllama_1_1b (22 layers, bf16, seeded random
              weights): one 512-token prefill chunk and one decode step
              with the kernels and with the plain versions, logits compared
  5. serve    16 mixed-length requests (16..1500 prompt tokens, 32 new
              tokens each) through ServingEngine (max_batch 8, max_seq_len
              2048, prefill_chunk 512, prefill_batch 8); the launch counters
              are set to 0 just before and read just after, and the XFA
              profile shard is loaded back
  5b. paged   the same requests through the paged pool (page_size 64):
              257 pages (the contiguous pool's 16384 rows; the page gate
              never waits) must give the same greedy tokens as phase 5;
              65 pages (a quarter of them) must back-pressure admission,
              complete every request and return every page, with the page
              gauges in its profile shard
  3b. train kernels  the training kernels against their plain versions:
              flash attention forward and backward at the training shape
              (q [4,32,2048,64], k/v [4,4,2048,64], bf16, causal), plus a
              ragged (S = 2000), a non-causal Sq != Sk, a softcap, a G = 5
              head-dim-128 (q [1,40,1024,128], k/v [1,8,1024,128]) and an
              explicit sm_scale 0.0917 case for correctness, and the
              rmsnorm backward at x [4,2048,2048]; timed beside their plain
              versions, one PyTorch library call each (SDPA and its
              autograd backward, F.rms_norm's backward) and their bounds,
              with the flash kernels' TFLOP/s and share of the bound; both
              flash kernels also timed beside SDPA at q [1,40,2048,128],
              k/v [1,8,2048,128] causal (a log line).  The flash forward
              also as training runs it (keep_f32: o kept in f32 for the
              backward's delta), in every case: its o and lse the
              inference kernel's bits, o32 rounding to o and within the
              tolerance of the plain version computed in f32; timed at
              the training shape as the entry's `training` sub-entry (and
              so at each training layout: phases 3d, 3f, 3g, 3h and the
              head-dim-80 case of phase 10's kernels)
  6. train    full-width tinyllama_1_1b (22 layers, bf16, the config's own
              remat) trained for TRAIN_STEPS steps of batch 4 x 2048 from
              SyntheticLMData through the port's Trainer, launch counters
              set to 0 just before and read just after; every loss and
              grad norm finite; step time, tokens/s and model FLOPs
              utilisation; the checkpoint saved in the run restores into an
              equal state; then one loss_fn + backward at batch 1 x 1024
              with the kernels and with the plain versions, the loss and
              every gradient leaf compared; a torch.profiler window over
              one more step (device time by kernel, busy share, the flash
              kernels' share of device time)
  7. profile  a torch.profiler window over a short second serving run: the
              device time by kernel and the device's busy share
  3c. hybrid kernels  the kernels of the hybrid path at its shapes: the
              SSD scan (ssd_scan) at the serving shape (x [8,512,80,64]
              bf16, N 64, chunk 128) with and without a carried state, one
              row (x [1,512,80,64], timed too), a padded case (L 300) and a
              small-chunk case (L 16); chunk and decode attention at Hq =
              Hkv = 32, head dim 80, and their paged twins there at page
              sizes 16 and 64 (equal to the dense kernels); rmsnorm_add
              at [8,512,2560]; each against its plain version and timed
              beside it, its bound and (where one exists) a library call
  8. hybrid   full-width zamba2_2_7b (54 Mamba2 layers + a shared
              attention block every 6, seeded random weights): one
              512-token prefill chunk and one decode step with the kernels
              and with the plain versions, in bf16 (each held against the
              f32 plain model) and in f32 (held to each other); the same
              prompt as 4 x 128-token chunks gives the whole prompt's SSM
              state and logits (f32); then the 16 requests of phase 5 through
              ServingEngine with the launch counters set to 0 just before
              and read just after (ssd_scan, rmsnorm, chunk_attention and
              decode_attention must all run), the profile shard loaded
              back, a second run with max_cache_pages set giving the same
              greedy tokens (the hybrid keeps the contiguous cache), and a
              torch.profiler window over a short third run
  10. hybrid train  full-width zamba2_2_7b (54 Mamba2 layers, 9 shared-
              block calls at 32 heads of 80, bf16, remat dots_saveable)
              trained for HYBRID_TRAIN_STEPS steps of batch 4 x 2048 from
              SyntheticLMData through the port's Trainer (AdamW at the
              reference's defaults, no checkpoint), launch counters set to
              0 just before and read just after (ssd_scan and its backward,
              both flash kernels, rmsnorm and its backward must all run);
              every loss and grad norm finite, dispatch_step x 4 in the
              profile shard; step time, tokens/s, MFU by a hybrid
              model-FLOPs count (checked against the static-cost layer's
              FLOPs of one loss_fn) and peak memory; a torch.profiler
              window over one more step (busy share, the SSD and flash
              kernels' shares); one loss_fn + backward at batch 1 x 1024
              with the kernels and with the plain versions, in f32 (loss
              to 1e-4 relative, each gradient leaf to 1e-3 relative L2)
              and in bf16 (each leaf no further from the f32 plain
              gradient than the plain bf16 one, within 1.25x); then
              ssd_scan_backward against its plain version at the training
              shape (x [4,2048,80,64], bf16 and f32, with and without h0
              and dh_final) and at 1 x 512, two launches bitwise equal,
              each of its launches' own device time (torch.profiler) and
              its plan, and flash attention forward and backward at head
              dim 80 (q/k/v [4,32,2048,80] causal, bf16 and f32; Sq 1024
              against Sk 2048; non-causal Sq 512), each timed beside its plain
              version, its bound and (flash) SDPA.  It runs before phase 9
  3d. moe kernels  the attention kernels at phi3.5-moe's shapes (32 q / 8
              kv heads of 128, G 4), with every check of phase 3g: decode
              (q [8,32,128], k/v [8,8,2048,128]), chunk attention at T 512
              and T 8, their paged twins at page sizes 64 and 16 and the
              flash pair at q [4,32,2048,128], k/v [4,8,2048,128] causal,
              each timed beside its plain version, its bound and SDPA
  3e. mla kernels  the four serving attention kernels in their latent
              form (csrc/mla_attention.cu: 16 q heads over one latent kv
              head read in place, K rows [ckv | krope] of 512 + 64 columns,
              V rows ckv, 512 columns out, sm_scale 192 ** -0.5), in f32
              and bf16: decode (q [8,16,576], ckv [8,2048,512], krope
              [8,2048,64], kv_len 0, 1, ragged and 2048), chunk at T 512
              and T 8 at per-row offsets, their paged twins over two
              arenas through one block table at page sizes 64 (TMA) and
              16 (the gather; decode also 5), each against its plain
              version, the reference's k/v route (2e-2 bf16, 2e-5 f32);
              paged equal to dense and a row alone equal to its batch
              row; ptxas's registers, spills and shared memory for the
              library; the bf16 kernels timed beside their plain
              versions, both bounds (in place and the k/v form) and SDPA
              on the k/v form built outside the timed call, its backend
              named
  3f. mla train kernels  the flash pair at MLA training's head dims: q/k
              at dn + dr = 192, v at its own width dv = 128 (q/k
              [4,16,2048,192], v [4,16,2048,128], causal, sm_scale 192 **
              -0.5), in bf16 and f32, also Sq 1024 against Sk 2048 and a
              ragged S 1000, against the plain versions (2e-2 bf16, 2e-5
              f32), two backward launches bitwise equal; ptxas's registers
              and spills of the (192, 128) kernels; the bf16 pair timed
              beside its plain version, its bound (the useful FLOPs) and
              SDPA on the padded form (v zero-padded to 192), its backend
              named
  3g. dense kernels  the attention kernels at the dense family's new head
              layouts: granite-20b's MQA (48 q heads over one kv head of
              128: three decode blocks a (row, kv head)) and internvl2-1b's
              14 q over 2 kv heads of 64 (G 7), bf16: decode (q [8,Hq,D],
              k/v [8,Hkv,2048,D], kv_len 0, 1, ragged and 2048; the empty
              row zeros), chunk at T 512 and T 8 (the split path) at
              per-row offsets, the paged twins at page sizes 64 and 16,
              equal (torch.equal) to the dense kernel on the same K/V
              (decode also at 5), a row alone equal to its batch row
              (decode and chunk, dense and paged), the flash pair at q
              [4,Hq,2048,D] causal with two backward launches bitwise
              equal; the same kernels in f32 (the flash pair at q
              [1,Hq,1024,D]); rmsnorm at a decode tick's and a prefill
              group's rows and its backward at the training rows, 6144
              (granite) and 896 (internvl) wide, bf16 and f32; each
              against its plain version per entry (2e-2 bf16, 2e-5 f32;
              the bf16 flash dk and dv, sums over G x 2048 products an
              entry, against the plain backward with p rounded to bf16
              as the kernel's tensor-core operand is), the bf16
              cases timed beside their plain versions, their bounds and
              SDPA or F.rms_norm; ptxas's registers and spills of the
              instantiations these shapes launch (G and the width are
              runtime arguments)
  11. moe serve  phi3_5_moe_42b at its published widths, cut to
              MOE_SERVE_LAYERS of its 32 layers (the whole model does not
              fit the card, and the run's time is cut for phases 20 and
              20b; seeded random weights, shared by the runs):
              one MoE layer's forward and emits at [8, 512] and [8, 1]
              under torch.cuda.set_sync_debug_mode("error"); the 16
              requests of phase 5 contiguous, then paged (257 pages), with
              tok/s, TTFT, decode gap and peak memory, and from
              engine.table each expert's load share, max/mean load and
              the dropped choices, the loads summing to top_k x the
              tokens the engine ran through the model (pad rows and
              columns included) x the MoE layers and the count to its
              forward calls x the MoE layers; a torch.profiler window
              over a short run; the same pair at capacity_factor
              MOE_DROP_FREE (nothing drops; MOE_DROP_FREE_LAYERS layers)
              must give 16 of 16 equal token streams (at the config's 1.25
              the count is logged: pad columns past a row's granted pages
              read scratch page 0 and take capacity); then the model at
              MOE_CHECK_LAYERS layers,
              kernels vs plain logits in f32 (1e-3) and bf16 (no further
              from the f32 plain model than the plain bf16 model, within
              1.25x), with the share of top-k choices the runs differ on
  12. moe train  phi3_5_moe_42b at its widths and MOE_TRAIN_LAYERS layers,
              batch 4 x 2048, MOE_TRAIN_STEPS steps through the port's
              Trainer (remat dots_saveable, AdamW) with its XFA session:
              launch counters set to 0 just before and read just after;
              losses, aux losses and grad norms finite; the profile
              shard's device group holds train_step x MOE_TRAIN_STEPS and
              loads summing to top_k x 4 x 2048 x the layers x the steps;
              step time, tokens/s, MFU by the active parameters' FLOPs
              (held to the static-cost layer's FLOPs of one loss_fn) and
              peak memory; a torch.profiler window over one more step
  13. mla serve  deepseek_v2_lite_16b at its published widths and
              MLA_SERVE_LAYERS of its 27 layers (all 27 fit the card; cut
              for the run's time; seeded random weights):
              one MLA + MoE layer's forward at [8, 512] and [8, 1],
              contiguous and paged, under set_sync_debug_mode("error");
              the 16 requests of phase 5 contiguous, then paged (257
              pages), with tok/s, TTFT, decode gap, peak memory (under 75
              GB) and the fold's invariants (loads summing to top_k x
              tokens x the MoE layers, the count to calls x them); a
              torch.profiler window (busy share, the latent kernels'
              and the copy kernels' launches and shares); the same pair at
              capacity_factor MLA_DROP_FREE (nothing drops) must give 16
              of 16 equal token streams; then the model at 4 layers,
              kernels vs plain logits in f32 and bf16, as phase 11's,
              the bf16 pair held to the ratio with its top-k choices
              pinned to the f32 plain model's (unpinned numbers logged)
  14. mla train  deepseek_v2_lite_16b at its published widths, cut to
              MLA_TRAIN_LAYERS of its 27 layers (1 dense + 3 MoE, 2.25B
              params), batch 4 x 2048 from SyntheticLMData, MLA_TRAIN_STEPS
              steps through the port's Trainer (remat dots_saveable,
              AdamW) with its XFA session: the expanded MLA branch runs
              the flash pair at q/k 192 and v 128; launch counters set to
              0 just before and read just after (both flash kernels,
              rmsnorm and its backward must run); losses, aux losses and
              grad norms finite; the shard's device group holds
              train_step x steps and loads summing to top_k x 4 x 2048 x
              3 x steps; step time, tokens/s, MFU (the static-cost FLOPs,
              held to the static-cost layer's FLOPs of one loss_fn, plus
              the wkv_b expansion and o_proj, which register none) and
              peak memory (under 80 GB); a torch.profiler window over one
              more step; one loss_fn + backward at batch 1 x 1024 with the
              kernels and with the plain versions, in f32 (loss to 1e-4
              relative, each leaf to 1e-3 relative L2) and in bf16 (each
              leaf no further from the f32 plain gradient than the plain
              bf16 one, within 1.25x, top-k choices pinned to the f32
              plain model's; the unpinned numbers logged)
  15. granite serve  granite_20b at its published widths and
              GRANITE_SERVE_LAYERS of its 52 layers (all 52 fit the card;
              cut for the run's time; seeded random weights):
              one dense MQA layer's forward at [8, 512] and [8, 1],
              contiguous and paged, under set_sync_debug_mode("error"); the
              16 requests of phase 5 contiguous, then paged (257 pages),
              whose 16 token streams must be equal, with the launch
              counters read around each run, tok/s, TTFT, decode gap
              (against the 12.1 ms a tick takes to read the weights) and
              peak memory (under 75 GB); a torch.profiler window (busy
              share, the attention and rmsnorm kernels' shares); then
              granite, qwen3_14b (G 5, qk-norm) and starcoder2_7b (G 9,
              ungated) at their widths and 4 layers: one prefill chunk and
              one decode step, kernels vs plain logits in f32 (1e-3) and
              bf16 (no further from the f32 plain model than the plain
              bf16 model, within 1.25x)
  16. granite train  granite_20b at its widths, cut to 4 of 52 layers
              (2.12B params, ~34 GB of state), batch 4 x 2048, 4 steps
              through the port's Trainer with its XFA session: the flash
              pair at G 48, D 128, rmsnorm and its backward must run;
              losses and grad norms finite; the shard holds dispatch_step
              x 4; step time, tokens/s, MFU (its FLOPs held to the
              static-cost layer's of one loss_fn at 1e-6) and peak memory
              (under 80 GB); a profiled step; one loss_fn + backward at
              batch 1 x 1024, kernels vs plain, in f32 (loss 1e-4, leaves
              1e-3) and bf16 (ratio 1.25)
  17. internvl  internvl2_1b (the vlm: the dense stack behind a patch
              projection) at its published widths and all 24 layers,
              bf16.  Serve, through the model API: 8 rows of 256 patches
              of 1024 features projected into the prefix, bulk-prefilled
              with a 512-token text chunk, a bucket-padded 512-token
              continuation at per-row valid lengths 16..512, 32 greedy
              decode ticks at per-row offsets; contiguous, then paged
              (page size 64, the prefix through forward_chunk_paged),
              launch counters read around each (rmsnorm, chunk and decode
              attention or their paged twins); the tokens must be equal;
              prefill time and decode tok/s logged; the logits of the
              prefill, the continuation and the first tick, kernels vs
              plain, in f32 (1e-3) and bf16 (ratio 1.25) at full depth.
              Train: batch 4 x 2048 (1792 text and 256 patch positions a
              row), 6 steps through the Trainer (the flash pair at G 7,
              D 64; MFU held to the static costs, plus the patch
              projection, which registers none; peak memory), a profiled
              step, and the batch 1 x 1024 gradient check with the
              frontend/w leaf among the leaves
  3h. audio kernels  the kernels of the enc-dec's path at seamless's
              shapes (16 q over 16 kv heads of 64, G 1), f32 and bf16:
              decode against the whole source (q [8,16,64], k/v
              [8,16,1024,64] and a ragged 1000 rows, every kv_len = S),
              chunk attention at T 128 and T 8 at per-row offsets in a
              1024-row cache, the flash forward non-causal at the serving
              cross-attention (Sq 128 against Sk 1024, Sq 8 against 1000),
              the flash pair non-causal at q, k, v [4,16,2048,64] (f32 at
              [1,16,2048,64]) with two backward launches bitwise equal,
              rmsnorm and its backward 1024 wide; each against its plain
              version per entry (2e-2 bf16, 2e-5 f32), the bf16 cases
              timed beside their plain versions, their bounds (non-causal
              FLOPs) and SDPA or F.rms_norm
  3i. modal mesh kernels  the flash pair at internvl2's local heads under
              --mesh 1x2 (7 q over 1 kv head of 64, causal) at q
              [2,7,1024,64], as phase 3g's flash cases: against the plain
              versions, two backward launches bitwise equal, timed beside
              the plain versions, the bound and SDPA (sub-entry g7_hkv1;
              its launches are those of internvl's rank 0 in phase 23)
  18. seamless serve  seamless_m4t_large_v2 (the enc-dec: 24 encoder and
              24 decoder layers, d_model 1024, 16 heads of 64, ungated
              d_ff 8192, vocab 256206, a stub frames frontend of 1024
              features) at its published widths and full depth, bf16,
              served through the model API (the engine's clients send
              token prompts only): 8 rows of 1024 seeded frames encoded
              once with a prompt bucket-padded to 128 at valid 8..128, a
              64-token continuation without frames (the cross cache read
              as it lies), 32 greedy decode ticks (self-attention at pos +
              1, cross-attention at kv_len = 1024 for every row); launch
              counts exact; prefill ms, decode tok/s, peak memory, busy
              share (a profiler window); logits kernels vs plain in f32
              (1e-3) and bf16 (ratio 1.25); rows 0 and 5 alone give their
              batch rows' tokens (f32; the bf16 count logged)
  18b. seamless train  the same model at full depth, batch 4 x 2048 (2048
              frames and 2048 tokens a row), 6 steps through the Trainer:
              the flash pair non-causal in the encoder and the
              cross-attention, causal in the decoder; MFU held to the
              static costs at 1e-6, plus the frontend projection, which
              registers none; peak memory; a profiled step; the batch 1 x
              1024 gradient check with frontend/w, the encoder's and the
              cross-attention's leaves among the leaves
  19. xlstm serve  xlstm_1_3b (48 blocks as 6 super-blocks of 7 mLSTM +
              1 sLSTM, d_model 2048, 4 heads, mLSTM head width 1024, chunk
              128, vocab 50304) at its widths and full depth: the prompt
              whole vs in 4 chunks (f32: logits and the carried mLSTM and
              sLSTM state within 1e-3); then, cut to XLSTM_SERVE_LAYERS
              (8) blocks for the run's time, the 16 requests of phase 5
              through the engine's contiguous recurrent state (rmsnorm
              the only kernel: its launches exact for the engine's
              forwards), tok/s, TTFT, decode gap, peak memory
  19b. xlstm train  the same model at XLSTM_TRAIN_LAYERS (16) of its 48
              blocks, batch 4 x 1024 (cut from 4 x 2048: the sLSTM
              loop's eager launches set the step time),
              XLSTM_TRAIN_STEPS (2) steps through the Trainer with each super-block rematerialized
              whole (remat full, see XLSTM_TRAIN_REMAT): step time, peak
              memory, MFU by the static costs (held at 1e-6) plus the
              cells' chunkwise products and the sLSTM FFN, which register
              none; no profiled step (a step launches ~0.4M kernels, more
              than a profiler window should hold); the gradient check at
              the fixed limits (f32 1e-4 / 1e-3, bf16 ratio 1.25) at one
              super-block (8 blocks) and 1 x 256 (XLSTM_GRAD_LAYERS,
              XLSTM_GRAD_SHAPE), where a one-ulp move of the norms must
              move the plain f32 gradient less than 1e-3
  20. mesh train  tinyllama_1_1b at its published widths, cut to
              MESH_LAYERS of its 22 layers for the run's time, through
              the launcher (`repro_torch.launch.train`),
              MESH_STEPS steps of batch 4 x 1024 with 2 microbatches, the
              deferred gradient reduce and int8 compression: on one rank
              (the launcher's main in this process: `run_launcher`),
              then under torchrun at --mesh 1x2 (tensor parallel 2: 16 q
              over 2 kv heads a rank) and 2x1 (data parallel 2, ZeRO-1),
              two ranks sharing the card over gloo with CUDA tensors (the
              gloo collectives refused on CUDA tensors run on host copies,
              printed); every rank's losses within MESH_LOSS_REL_TOL of
              the one-rank run's, its kernel launches (the rmsnorm and
              flash pairs on its shard) and collectives printed, its step
              times logged beside the card (no measure of parallel speed);
              then, first in phase 22's world of 2 spawned ranks, one
              loss_fn + backward
              at batch 2 x 1024 under 1x2 and 2x1, gathered: f32 against
              the one-rank f32 kernel run (loss 1e-4 relative, each leaf
              1e-3 relative L2), bf16 each leaf no further from the f32
              plain gradient than the one-rank bf16 kernel run's, within
              1.25x.  Each mesh rank's recorded step (XFA's L3 flows,
              `check_flows`): as many flows per kind as
              collective_counts() over the step, none in `app`, the
              attention's and the loss's all-reduces on 'model' at 1x2,
              the gradient's all-reduces under `grads` and the ZeRO
              all-gathers under `optimizer` on 'data' at 2x1; rank 0's
              report shows the collectives section
  20b. cp decode context-parallel decode, q [8,32,64], k/v
              [8,4,2048,64], the cache's sequence split over the 2 ranks
              (rank 1's half empty for 5 of the 8 rows), bf16 and f32,
              against the one-rank decode kernel on the whole cache
              (2e-2 / 2e-5 abs + rel), and each rank's decode launches,
              in phase 22's world after phase 20's gradient check
  21. moe mesh train  phi3_5_moe_42b at its published widths, cut to
              MOE_MESH_LAYERS (2) of its 32 layers as phase 12, through
              the launcher, MOE_MESH_STEPS steps of batch 2 x 1024 at
              capacity_factor 8 (drop-free): on one rank (in this
              process), then under torchrun at --mesh 1x2 (expert
              parallel 2: the a2a MoE
              dispatch, 8 of 16 experts a rank, tokens exchanged by
              all-to-all over 'model'; attention 16 q over 4 kv heads a
              rank and half the vocab), two ranks sharing the card over
              gloo; each rank's state reckoned before (1.43B params a
              rank) and its peak printed, the two peaks' sum under 80 GB;
              every rank's losses within MESH_LOSS_REL_TOL of the
              one-rank run's, its kernel launches (the rmsnorm and flash
              pairs), the fold's invariant (loads summing to top_k x
              tokens x layers x steps, nothing dropped) on each rank and
              the two ranks' tables equal; each rank's recorded step
              (`check_flows`): MOE_A2A_PER_LAYER all-to-alls a layer
              (forward, remat's recompute, backward), each under `moe`
              on 'model' with E x C_loc x 4096 x 2 input bytes, per-kind
              counts equal to collective_counts(), none in `app`; rank
              0's report shows the collectives section.  Then, in phase
              22's world of 2 spawned ranks, one loss_fn + backward at 1
              x 1024 under 1x2 at MOE_MESH_GRAD_LAYERS (1) layer, each
              leaf gathered: f32 against the
              one-rank f32 kernel run (loss 1e-4, leaves 1e-3), bf16 no
              further from the f32 plain gradient than the one-rank bf16
              kernel run's, within 1.25x, the top-k choices pinned; each
              rank's attention takes 16 q heads
  22. family mesh train  deepseek_v2_lite_16b (MLA, 64 experts top 6 + 2
              shared) at 2 of its 27 layers (the dense one and one MoE
              layer) at capacity_factor 11 (drop-free), and zamba2_2_7b
              at 12 of its 54 layers (two super-blocks: the tied block's
              gradient sums over two calls), both at their published
              widths, through `mesh_case_phase` as phase 21:
              FAMILY_MESH_STEPS steps of batch 2 x 1024 on one rank and
              at --mesh 1x2 (deepseek: MLA split by heads, 8 a rank, the
              a2a MoE with 32 experts a rank, the shared experts and the
              dense MLP column/row; zamba2: the Mamba2 blocks split by
              ssm heads, 40 a rank, B and C whole, the gated norm over
              the gathered row, the shared block's 16 heads a rank), each
              rank's state reckoned and peak printed, the peaks' sum
              under 80 GB; losses within MESH_LOSS_REL_TOL of one rank's,
              the rmsnorm and flash pairs (and zamba2's ssd_scan pair)
              launched on each rank, deepseek's fold invariant (nothing
              dropped), the ranks' tables equal; the recorded step's
              flows: deepseek's attention all-reduces and MoE
              all-to-alls (E x C_loc x 2048 x 2 bytes) on 'model',
              zamba2's `ssm` all-reduces and all-gathers on 'model', none
              in `app`.  Then both gradient checks, one after the other
              and after phase 21's, in one world of 2 spawned ranks
              (deepseek's
              bf16 pair pinned, the unpinned reading logged), each rank's
              kernels taking the local shapes: the flash pair at (192,
              128) with 8 heads; ssd_scan with 40 heads and the flash
              pair at D 80 with 16 heads.  The world first sends bf16
              and f32 CUDA tensors both ways between its two ranks
              (`parallel.mesh.send` / `recv`: host copies under gloo),
              each received bit for bit
  23. vlm, audio, ssm mesh train  internvl2_1b at all 24 layers (256 of
              the 1024 positions a row are the patches' prefix),
              seamless_m4t_large_v2 at 4 + 4 of its 24 + 24 layers and
              xlstm_1_3b at 8 of its 48 blocks (one super-block), at
              their published widths, through `mesh_case_phase` as phase
              22: FAMILY_MESH_STEPS steps of batch 2 x 1024 on one rank
              and at --mesh 1x2 (internvl: the frontend projection split
              by columns and gathered, 7 q over 1 kv head a rank;
              seamless: the frames' projection gathered, 8 heads a rank
              in the encoder, the decoder and the cross-attention;
              xlstm: the mLSTM and sLSTM blocks split by heads, 2 a
              rank, the sLSTM's y gathered, its FFN split), with phase
              22's checks; the flows at their sites: the frontend's
              all-gather under `embed` and the attention all-reduces, or
              the `mlstm` all-reduces and the `slstm` all-gathers and
              all-reduces, on 'model'.  Their gradient checks in phase
              22's world after phase 22's: internvl and seamless at 2
              layers (1 + 1) and 1 x 1024, xlstm at one super-block and 1
              x 256; each rank's kernels at the local shapes: flash at 7
              q over 1 kv head of 64 (causal) for internvl, 8 over 8 of
              64 (causal and not) for seamless, and rmsnorm at widths
              896, 1024 and 2048.  Phases 20, 22 and 23 each start their
              mesh worlds at once, after their one-rank runs (the note
              at MESH_RUNS)
  9. diagnose the port's own profile CLI (`python -m repro_torch.profile`,
              a subprocess) over the profile dirs that phases 5 (tinyllama
              serve), 6 (train), 8 (zamba2 serve), 10 (zamba2 train), 11
              and 12 (phi3.5-moe serve and train), 14 (deepseek train),
              15 and 16 (granite serve and train), 17 (internvl train),
              18b (seamless train), 19 and 19b (xlstm serve and train)
              20 and 21 (the three mesh runs: each report must merge
              both ranks' shards) kept: `diagnose --json` and `report --json`
              on each (the phi3.5-moe, its 1x2 and the deepseek train
              reports must show the device group), `timeline --json` on
              the tinyllama serve dir; each must exit 0 with JSON that
              parses, and the findings by severity, the first five, each
              component's Wait share and the five edges with the most
              self time are logged (findings are results, not failures).  Then the fleet stream: the
              port's Collector on 127.0.0.1 in a thread, a tinyllama serve
              of 8 requests x 16 new tokens and a 2-step train at batch
              4 x 2048, both with xfa_collector set; every publish() must
              report its deltas acked (no error, nothing pending), each
              run's spool must reduce to the edges and counts of its local
              profile dir, and `diagnose --fleet` over the spool must exit
              0 and name both runs

It prints the kernels line ({"kernels": [...]}), a summary of each serve
phase (tok/s, TTFT p50 / p95, the XFA prefill_chunk mean), the card's
name and power limit, and last {"ok": true, "device": {...}}.  Each kernel's launches
come from the serving or training run of its own path (ssd_scan_backward
and the flash kernels' head-dim-80 numbers: phase 10; the head-dim-128
numbers: phases 11 and 12; the head-dim-576 numbers: phase 13; the
(192, 128) numbers, and every kernel's mla_train_launches: phase 14;
the g48_d128 and width_6144 numbers: phases 15 and 16; the g7_d64 and
width_896 numbers: phase 17; the g1_d64 and width_1024 numbers: phases
18 and 18b; xlstm's rmsnorm launches, logged beside: phases 19 and 19b;
each mesh rank's launches, `mesh_launches`: phases 20, 20b, 21,
22 and 23, the keys "moe ep rank r" and "moe grads rank r" phase 21's,
"deepseek 1x2 rank r", "deepseek grads rank r", "zamba2 1x2 rank r" and
"zamba2 grads rank r" phase 22's, "internvl ...", "seamless ..." and
"xlstm ..." phase 23's);
rmsnorm_add has
no model path in either package, so its launches are those of its
correctness checks in phase 3c.  Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, FrozenSet, NamedTuple, Tuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
#: the byte-compiled modules of the run's processes (`cache_bytecode`), in
#: the checkout's build dir (listed in .gitignore)
PYCACHE = ROOT / "build" / "pycache"
#: one temporary root per run: the profile dirs phases 5-8 and 10 write, kept
#: for phase 9 to diagnose, and the fleet spool (removed at exit)
RUN_ROOT = Path()

HBM_BYTES_S = 3.35e12           # H100 SXM device memory rate (data sheet)
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, per dtype
L2_FLUSH_BYTES = 256 << 20      # > the 50 MB L2: each timed launch starts cold
HOST_LEAD_CYCLES = 1_000_000    # ~0.5 ms of device spin before each timed call

# tolerances (kernel vs plain version, both bf16): one bf16 ulp near 1 is
# 7.8e-3 and the kernels sum in another order -> 2e-2, as tests/test_kernels.py
KERNEL_TOL = 2e-2
# full-width logits, kernels vs plain versions: relative L2 error; bf16
# rounding differences compound over 22 layers
LOGITS_REL_TOL = 5e-2
# full-width training step, kernels vs plain versions (bf16): the loss to
# 1e-2 relative (a mean over 1024 tokens of values near log(32000)), each
# gradient leaf to 5e-2 relative L2 (bf16 rounding compounds over 22
# layers forward and back, as for the logits)
LOSS_REL_TOL = 1e-2
GRAD_REL_TOL = 5e-2
# full-width zamba2 (54 Mamba2 layers + 9 shared-block calls), kernels vs
# plain versions.  In f32 both sum in another order only: relative L2
# 1e-3 (a full-width f32 run measured 1.8e-5).  In bf16 a fixed bound says
# nothing: bf16 rounding puts this 63-block random-weight model ~9.6% from
# its f32 self, and kernels vs plain ~8% apart (one chip run), so the
# kernels' bf16 logits must be no further from the f32 plain model's than
# the plain bf16 model's are, within 1.25x
HYBRID_F32_TOL = 1e-3
HYBRID_BF16_RATIO = 1.25
# SSD final state h (f32 in both versions, from the same bf16-rounded
# inputs): they differ by the f32 order of sums over up to 512 steps and
# expf against torch.exp, a few ulp of values up to ~20 -> 1e-3 abs + rel
STATE_TOL = 1e-3
TRAIN_STEPS = 6
#: kernels of the training path (their launches come from phase 6)
TRAIN_KERNELS = ("flash_attention", "flash_attention_backward",
                 "rmsnorm_backward")
#: the flash kernels' device symbols (flash_attention.cu), for their share
#: of the train step's device time
FLASH_KERNEL_NAMES = ("fwd_kernel", "dkdv_kernel", "dq_kernel",
                      "flash_delta_kernel")
#: kernels of the hybrid path only (their launches come from phase 8)
HYBRID_KERNELS = ("ssd_scan",)
#: the kernel no model calls in either package: launches from phase 3c
PATHLESS_KERNELS = ("rmsnorm_add",)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cache_bytecode() -> None:
    """Keep the byte-compiled modules of this process and of every process
    it starts (torchrun's ranks, spawned worlds) under PYCACHE: where the
    interpreter's own .pyc files are missing, each fresh process compiles
    torch's modules from source again (5.5 of a fresh launcher process's
    14.1 s before its first step ended, a cProfile on NVIDIA H100 80GB
    HBM3, 700.00 W)."""
    PYCACHE.mkdir(parents=True, exist_ok=True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(PYCACHE)


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    cache_bytecode()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global RUN_ROOT
    RUN_ROOT = Path(tempfile.mkdtemp(prefix="chip_smoke-"))
    try:
        run(torch)
    finally:
        shutil.rmtree(RUN_ROOT, ignore_errors=True)


def run(torch) -> None:
    t_start = time.monotonic()
    smi = device_line()
    log(f"[device] {smi}  torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import build
    t0 = time.monotonic()
    paths = build.build()
    log(f"[build] {len(paths)} libraries in {time.monotonic() - t0:.1f}s")
    for name in paths:
        for kernel, regs, spills in ptxas_report(build.build_log(name)):
            log(f"[build] {name}: {kernel}: {regs} registers, {spills} bytes "
                f"spill stores")

    kernels = check_kernels(torch) + check_train_kernels(torch)
    hybrid_entries, pathless_counts = check_hybrid_kernels(torch, kernels)
    kernels += hybrid_entries
    check_layout(torch, kernels, "head_dim_128", *MOE_HEADS, seed=7)
    check_mla_kernels(torch, kernels)
    check_mla_train_kernels(torch, kernels)
    check_dense_kernels(torch, kernels, build.build_log)
    check_audio_kernels(torch, kernels)
    check_flash_pair(torch, kernels, MODAL_FLASH_KEY, *MODAL_FLASH,
                     MODAL_FLASH_SHAPE,
                     torch.Generator(device="cuda").manual_seed(31))
    forward_phase(torch)
    counts, stats, outputs = serve_phase(torch)
    paged_counts = paged_phase(torch, stats, outputs)
    train_counts, train = train_phase(torch)
    profile_phase(torch)
    hybrid_counts, hybrid = hybrid_phase(torch)
    hybrid_train_counts, hybrid_train, ssd_bwd = hybrid_train_phase(torch,
                                                                    kernels)
    kernels.append(ssd_bwd)
    moe_counts, moe_paged_counts, moe = moe_serve_phase(torch)
    moe_train_counts, moe_train = cut_train_phase(
        torch, moe_cfg(MOE_TRAIN_LAYERS), "moe-train", 12, MOE_TRAIN_SHAPE,
        MOE_TRAIN_STEPS)
    mla_counts, mla_paged_counts, mla = mla_serve_phase(torch)
    mla_train_counts, mla_train = mla_train_phase(torch)
    granite_counts, granite_paged_counts, granite = granite_serve_phase(torch)
    granite_train_counts, granite_train = granite_train_phase(torch)
    vlm_counts, vlm_paged_counts, vlm = vlm_serve_phase(torch)
    vlm_train_counts, vlm_train = vlm_train_phase(torch)
    audio_counts, audio = audio_serve_phase(torch)
    audio_train_counts, audio_train = audio_train_phase(torch)
    xlstm_counts, xlstm = xlstm_serve_phase(torch)
    xlstm_train_counts, xlstm_train = xlstm_train_phase(torch)
    mesh_launches = mesh_train_phase(torch)
    mesh_launches.update(moe_mesh_phase(torch))
    mesh_launches.update(family_mesh_phase(torch))
    diagnose_phase(torch)
    # each new layout's and width's launches: the run of the model that
    # serves or trains at it (paged kernels: its paged run)
    layout_runs = {
        "g48_d128": (granite_counts, granite_paged_counts,
                     granite_train_counts),
        "g7_d64": (vlm_counts, vlm_paged_counts, vlm_train_counts),
        "width_6144": (granite_counts, granite_paged_counts,
                       granite_train_counts),
        "width_896": (vlm_counts, vlm_paged_counts, vlm_train_counts),
        AUDIO_KEY: (audio_counts, None, audio_train_counts),
        AUDIO_WIDTH[0]: (audio_counts, None, audio_train_counts)}

    for k in kernels:
        # each kernel's launches in the run of its own path
        name = k["name"]
        if name in PATHLESS_KERNELS:
            log(f"[kernels] {name} has no model path in either package: "
                f"its launches are those of its phase 3c checks")
        k["launches"] = (train_counts if name in TRAIN_KERNELS
                         else hybrid_counts if name in HYBRID_KERNELS
                         else hybrid_train_counts
                         if name in HYBRID_TRAIN_KERNELS
                         else pathless_counts if name in PATHLESS_KERNELS
                         else paged_counts if name.endswith("_paged")
                         else counts)[name]
        if k["launches"] <= 0:
            fail(f"kernel {name} was not launched on its path")
        if "head_dim_80" in k and name in TRAIN_KERNELS:
            # the flash kernels at head dim 80: the zamba2 train run
            k["head_dim_80"]["launches"] = hybrid_train_counts[name]
        if "head_dim_128" in k:
            # G 4 at head dim 128: the phi3.5-moe serve (paged: its paged
            # run) and train runs
            k["head_dim_128"]["launches"] = (
                moe_train_counts if name in TRAIN_KERNELS
                else moe_paged_counts if name.endswith("_paged")
                else moe_counts)[name]
            if k["head_dim_128"]["launches"] <= 0:
                fail(f"kernel {name} was not launched on phi3.5-moe's path")
        if "head_dim_576" in k:
            # D 576, G 16: the deepseek serve, contiguous and paged
            k["head_dim_576"]["launches"] = (
                mla_paged_counts if name.endswith("_paged")
                else mla_counts)[name]
            if k["head_dim_576"]["launches"] <= 0:
                fail(f"kernel {name} was not launched on deepseek's path")
        if "head_dim_192" in k:
            # q/k 192, v 128: the deepseek train run
            k["head_dim_192"]["launches"] = mla_train_counts[name]
            if k["head_dim_192"]["launches"] <= 0:
                fail(f"kernel {name} was not launched on deepseek's "
                     f"training path")
        if mla_train_counts.get(name):
            # every kernel of the deepseek training path, by its run
            k["mla_train_launches"] = mla_train_counts[name]
        for key, (serve_c, paged_c, train_c) in layout_runs.items():
            if key in k:
                k[key]["launches"] = (
                    train_c if name in TRAIN_KERNELS
                    else paged_c if name.endswith("_paged")
                    else serve_c)[name]
                if k[key]["launches"] <= 0:
                    fail(f"kernel {name} was not launched on the path of "
                         f"its {key} entry")
        if MODAL_FLASH_KEY in k:
            # 7 q over one kv head: internvl2's attention at 1x2 (phase 23)
            k[MODAL_FLASH_KEY]["launches"] = mesh_launches[
                "internvl 1x2 rank 0"][name]
            if k[MODAL_FLASH_KEY]["launches"] <= 0:
                fail(f"kernel {name} was not launched at G 7 over one kv "
                     f"head on internvl's rank at 1x2")
        mesh = {key: c[name] for key, c in mesh_launches.items()
                if c.get(name)}
        if mesh:
            # each rank's launches in phases 20 (its shard of tinyllama's
            # training) and 20b (its half of the cache)
            k["mesh_launches"] = mesh
        if name in ("rmsnorm", "rmsnorm_backward"):
            # xlstm's norms run the kernel at width 2048 (the entry's
            # width), in its serve and train runs
            k["xlstm_launches"] = {"serve": xlstm_counts[name],
                                   "train": xlstm_train_counts[name]}
            log(f"[kernels] {name}: xlstm launches {k['xlstm_launches']}")
    log(json.dumps({"kernels": kernels}))
    for arch, st in (("tinyllama_1_1b", stats), ("zamba2_2_7b", hybrid),
                     (f"phi3_5_moe_42b at {MOE_SERVE_LAYERS} layers", moe),
                     (f"deepseek_v2_lite_16b at {MLA_SERVE_LAYERS} layers",
                      mla),
                     (f"granite_20b at {GRANITE_SERVE_LAYERS} layers",
                      granite),
                     (f"xlstm_1_3b at {XLSTM_SERVE_LAYERS} blocks", xlstm)):
        log(f"[serve-summary] {arch}: {st['throughput_tok_s']:.1f} tok/s, "
            f"ttft p50 {st['ttft_p50_s'] * 1e3:.1f} ms p95 "
            f"{st['ttft_p95_s'] * 1e3:.1f} ms, xfa prefill_chunk mean "
            f"{st['prefill_chunk_ms']:.2f} ms")
    log(f"[done] {time.monotonic() - t_start:.1f}s; served "
        f"{stats['throughput_tok_s']:.1f} tok/s, ttft mean "
        f"{stats['ttft_mean_s'] * 1e3:.1f} ms, launches "
        f"{json.dumps(counts)}, paged {json.dumps(paged_counts)}; trained "
        f"{train['step_ms']:.1f} ms/step, {train['tok_s']:.0f} tok/s, MFU "
        f"{100 * train['mfu']:.2f}%, busy {100 * train['busy']:.1f}%, flash "
        f"{100 * train['flash_share']:.1f}% of device time, launches "
        f"{json.dumps(train_counts)}; "
        f"hybrid served {hybrid['throughput_tok_s']:.1f} tok/s, ttft mean "
        f"{hybrid['ttft_mean_s'] * 1e3:.1f} ms, decode gap "
        f"{hybrid['decode_s_per_tok'] * 1e3:.2f} ms/token, launches "
        f"{json.dumps(hybrid_counts)}; hybrid trained "
        f"{hybrid_train['step_ms']:.1f} ms/step, "
        f"{hybrid_train['tok_s']:.0f} tok/s, MFU "
        f"{100 * hybrid_train['mfu']:.2f}%, peak "
        f"{hybrid_train['peak_gb']:.1f} GB, busy "
        f"{100 * hybrid_train['busy']:.1f}%, ssd "
        f"{100 * hybrid_train['ssd_share']:.1f}% and flash "
        f"{100 * hybrid_train['flash_share']:.1f}% of device time, launches "
        f"{json.dumps(hybrid_train_counts)}; phi3.5-moe served "
        f"{moe['throughput_tok_s']:.1f} tok/s, ttft p50 "
        f"{moe['ttft_p50_s'] * 1e3:.1f} ms, decode gap "
        f"{moe['decode_s_per_tok'] * 1e3:.2f} ms/token, peak "
        f"{moe['peak_gb']:.1f} GB, expert load max/mean "
        f"{moe['fold']['max_over_mean']:.3f}, dropped "
        f"{100 * moe['fold']['dropped_share']:.2f}% of choices, launches "
        f"{json.dumps(moe_counts)}; phi3.5-moe trained "
        f"{moe_train['step_ms']:.1f} ms/step, {moe_train['tok_s']:.0f} "
        f"tok/s, MFU {100 * moe_train['mfu']:.2f}%, peak "
        f"{moe_train['peak_gb']:.1f} GB, busy "
        f"{100 * moe_train['busy']:.1f}%, launches "
        f"{json.dumps(moe_train_counts)}; deepseek served "
        f"{mla['throughput_tok_s']:.1f} tok/s, ttft p50 "
        f"{mla['ttft_p50_s'] * 1e3:.1f} ms p95 {mla['ttft_p95_s'] * 1e3:.1f}"
        f" ms, decode gap {mla['decode_s_per_tok'] * 1e3:.2f} ms/token, "
        f"peak {mla['peak_gb']:.1f} GB, busy {100 * mla['busy']:.1f}%, "
        f"expert load max/mean {mla['fold']['max_over_mean']:.3f}, dropped "
        f"{100 * mla['fold']['dropped_share']:.2f}% of choices, launches "
        f"{json.dumps(mla_counts)}, paged {json.dumps(mla_paged_counts)}; "
        f"deepseek trained at {MLA_TRAIN_LAYERS} layers "
        f"{mla_train['step_ms']:.1f} ms/step, {mla_train['tok_s']:.0f} tok/s, "
        f"MFU {100 * mla_train['mfu']:.2f}%, peak "
        f"{mla_train['peak_gb']:.1f} GB, busy {100 * mla_train['busy']:.1f}%, "
        f"flash {100 * mla_train['flash_share']:.1f}% of device time, "
        f"launches {json.dumps(mla_train_counts)}; granite served "
        f"{granite['throughput_tok_s']:.1f} tok/s, ttft p50 "
        f"{granite['ttft_p50_s'] * 1e3:.1f} ms p95 "
        f"{granite['ttft_p95_s'] * 1e3:.1f} ms, decode gap "
        f"{granite['decode_s_per_tok'] * 1e3:.2f} ms/token, peak "
        f"{granite['peak_gb']:.1f} GB, busy {100 * granite['busy']:.1f}%, "
        f"launches {json.dumps(granite_counts)}, paged "
        f"{json.dumps(granite_paged_counts)}; granite trained at "
        f"{GRANITE_TRAIN_LAYERS} layers {granite_train['step_ms']:.1f} "
        f"ms/step, {granite_train['tok_s']:.0f} tok/s, MFU "
        f"{100 * granite_train['mfu']:.2f}%, peak "
        f"{granite_train['peak_gb']:.1f} GB, busy "
        f"{100 * granite_train['busy']:.1f}%, flash "
        f"{100 * granite_train['flash_share']:.1f}% of device time, launches "
        f"{json.dumps(granite_train_counts)}; internvl served prefill "
        f"{vlm['prefill_ms']:.1f} ms, decode {vlm['decode_tok_s']:.1f} "
        f"tok/s, launches {json.dumps(vlm_counts)}, paged "
        f"{json.dumps(vlm_paged_counts)}; internvl trained "
        f"{vlm_train['step_ms']:.1f} ms/step, {vlm_train['tok_s']:.0f} "
        f"tok/s, MFU {100 * vlm_train['mfu']:.2f}%, peak "
        f"{vlm_train['peak_gb']:.1f} GB, busy "
        f"{100 * vlm_train['busy']:.1f}%, launches "
        f"{json.dumps(vlm_train_counts)}; seamless served prefill "
        f"{audio['prefill_ms']:.1f} ms, decode {audio['decode_tok_s']:.1f} "
        f"tok/s, busy {100 * audio['busy']:.1f}%, peak "
        f"{audio['peak_gb']:.1f} GB, launches {json.dumps(audio_counts)}; "
        f"seamless trained {audio_train['step_ms']:.1f} ms/step, "
        f"{audio_train['tok_s']:.0f} tok/s, MFU "
        f"{100 * audio_train['mfu']:.2f}%, peak "
        f"{audio_train['peak_gb']:.1f} GB, busy "
        f"{100 * audio_train['busy']:.1f}%, launches "
        f"{json.dumps(audio_train_counts)}; xlstm served "
        f"{xlstm['throughput_tok_s']:.1f} tok/s, decode gap "
        f"{xlstm['decode_s_per_tok'] * 1e3:.2f} ms/token, peak "
        f"{xlstm['peak_gb']:.1f} GB; xlstm trained "
        f"{xlstm_train['step_ms']:.1f} ms/step, {xlstm_train['tok_s']:.0f} "
        f"tok/s, MFU {100 * xlstm_train['mfu']:.2f}%, peak "
        f"{xlstm_train['peak_gb']:.1f} GB, launches "
        f"{json.dumps(xlstm_train_counts)} on {smi}")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def ptxas_report(text: str, with_smem: bool = False):
    """(kernel, registers, spill store bytes[, static shared memory bytes])
    of each entry function in nvcc's -Xptxas -v report, names demangled
    where c++filt exists."""
    entries, name, spills = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            entries.append([name, int(m.group(1)), spills]
                           + ([int(smem.group(1)) if smem else 0]
                              if with_smem else []))
            name = None
    filt = shutil.which("c++filt")
    if filt and entries:
        out = subprocess.run([filt], input="\n".join(e[0] for e in entries),
                             capture_output=True, text=True, timeout=60)
        for e, full in zip(entries, out.stdout.splitlines()):
            m = re.search(r"((?:\w+::)*\w+(?:<[^>]*>)?)\(", full)
            e[0] = m.group(1) if m else full
    return [tuple(e) for e in entries]


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextmanager
def keep_dir(name: str):
    """A fresh directory under the run's temporary root, kept after the
    block (phase 9 reads the profile dirs)."""
    d = RUN_ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    yield str(d)


# ---------------------------------------------------------------- timing ----
def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call,
    with the L2 cache flushed before it and the card held busy for
    HOST_LEAD_CYCLES (both outside the events), so that a slow host
    enqueueing the call does not leave the card idle inside them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        # keep the card busy while the host enqueues the call, so the
        # events time the device and not the wrapper's host overhead
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float, dtype: str):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and operations over the dtype's peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record_kernel(torch, flush, name, src, replaces, shape, err, fn, plain,
                  library, nbytes, ops, dense=None):
    """Time a kernel, its plain version, its library yardstick and (for a
    paged kernel) the dense kernel on the equivalent contiguous cache, and
    return its entry of the kernels line (launches filled in later)."""
    b_ms, b_by = bound(nbytes, ops, "bfloat16")
    ms = time_ms(torch, fn, flush)
    plain_ms = time_ms(torch, plain, flush)
    lib_ms = time_ms(torch, library, flush) if library else None
    dense_ms = time_ms(torch, dense, flush) if dense else None
    log(f"[kernel] {name} {shape}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
        + (f"dense kernel {dense_ms:.4f} ms, " if dense else "")
        + f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e}; "
        f"{ops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s, "
        f"{100 * b_ms / ms:.1f}% of its bound"
        + (f", {ms / lib_ms:.2f}x the library call" if lib_ms else "")
        + (f", {ms / dense_ms:.3f}x the dense kernel" if dense else ""))
    e = {"name": name, "route": "cuda", "source": src,
         "replaces": replaces, "launches": 0, "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": lib_ms, "shape": shape}
    if dense:
        e["dense_ms"] = dense_ms
    return e


def max_err(torch, got, want, what: str, tol: float = KERNEL_TOL) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: kernel output is not finite")
    err = (g - w).abs()
    lim = tol + tol * w.abs()
    if not bool((err <= lim).all()):
        fail(f"{what}: kernel disagrees with its plain version (max abs "
             f"err {err.max().item():.3e}, tolerance {tol} abs + rel)")
    return err.max().item()


def chunk_work(pos_l, T: int, S: int, Hq: int, Hkv: int, D: int,
               page: int = 0):
    """Bytes and FLOPs of chunk attention (bf16) at offsets pos_l: q read
    and o written, pos, each row's visible K/V once (and its table slots,
    one int32 per page, when paged), Q K^T and P V over the visible
    pairs."""
    B = len(pos_l)
    seen = sum(min(p + t + 1, S) for p in pos_l for t in range(T))
    rows = [min(p + T, S) for p in pos_l]
    nbytes = 2.0 * 2 * B * Hq * T * D + 4 * B + sum(rows) * Hkv * D * 2 * 2
    if page:
        nbytes += 4 * sum(-(-n // page) for n in rows)
    return {"nbytes": nbytes, "ops": 4.0 * Hq * D * seen}


#: the keys of a kernels-line entry that a second shape of it keeps
SUB_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")


def sub_entry(e):
    """The numbers of a kernels-line entry at a second shape."""
    return {key: e[key] for key in SUB_KEYS + (("dense_ms",)
                                               if "dense_ms" in e else ())}


# --------------------------------------------------------------- kernels ----
def check_kernels(torch):
    """Phase 3: each kernel vs its plain version at the serving shapes, and
    its times.  Returns the entries of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf16)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    B, Hq, Hkv, S, D = 8, 32, 4, 2048, 64
    sdpa_gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    entries = []

    def record(*args, **kw):
        return record_kernel(torch, flush, *args, **kw)

    # rmsnorm: a decode tick's rows (tinyllama 2048, zamba2 2560), a full
    # prefill group and the train step's hidden states
    ws = {d: (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
          for d in (2048, 2560)}
    errs, rows = [], {}
    for shape in ((8, 1, 2048), (8, 1, 2560), (8, 512, 2048),
                  (4, 2048, 2048)):
        x, w = rnd(*shape), ws[shape[-1]]
        errs.append(max_err(torch, rms.rmsnorm(x, w), ref.rmsnorm(x, w),
                            f"rmsnorm {shape}"))
        rows[shape] = x
    # the launch floor: an empty kernel (a zero-cycle spin), timed the same way
    floor = time_ms(torch, lambda: torch.cuda._sleep(0), flush)
    timed = {}
    for shape, x in rows.items():
        d = shape[-1]
        w = ws[d]
        timed[shape] = record(
            "rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm.py:38", "x".join(map(str, shape)),
            max(errs), lambda: rms.rmsnorm(x, w), lambda: ref.rmsnorm(x, w),
            (lambda: F.rms_norm(x, (d,), w, 1e-5))
            if hasattr(F, "rms_norm") else None,
            nbytes=2.0 * x.numel() * 2 + d * 2, ops=4.0 * x.numel())
    tick, tick_z = timed[(8, 1, 2048)], timed[(8, 1, 2560)]
    log(f"[kernel] rmsnorm decode tick: 8x1x2048 {tick['ms']:.4f} ms, "
        f"8x1x2560 {tick_z['ms']:.4f} ms; launch floor (an empty kernel, "
        f"same timing) {floor:.4f} ms; bound {tick['bound_ms']:.6f} / "
        f"{tick_z['bound_ms']:.6f} ms (bytes): "
        f"{tick['ms'] - floor:.4f} / {tick_z['ms'] - floor:.4f} ms above "
        f"the floor")
    e = timed[(8, 512, 2048)]   # the prefill group: the shape that moves bytes
    e["decode_tick"] = sub_entry(tick)
    e["decode_tick_2560"] = sub_entry(tick_z)
    e["train_rows"] = sub_entry(timed[(4, 2048, 2048)])
    e["launch_floor_ms"] = floor
    entries.append(e)
    del rows, timed

    # decode_attention: mixed kv_len incl. an empty row, one row, ragged, full
    q, k, v = rnd(B, Hq, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    lens = [0, 1, 77, 1000, 1537, 2047, 2048, 513]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, (m, l) = dec.decode_attention(q, k, v, kv_len=kv_len,
                                     return_residuals=True)
    o_r, (m_r, l_r) = ref.decode_attention(q, k, v, kv_len=kv_len,
                                           return_residuals=True)
    err = max_err(torch, o, o_r, "decode_attention")
    if not bool((o[0] == 0).all()):
        fail("decode_attention: the kv_len == 0 row is not zeros")
    max_err(torch, m, m_r, "decode_attention m")
    if not torch.allclose(l, l_r, rtol=1e-3, atol=1e-3):
        fail("decode_attention: residual l disagrees with the plain version")
    err = max(err, max_err(torch, dec.decode_attention(q, k, v, kv_len=kv_len),
                           o_r, "decode_attention (no residuals)"))
    dmask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])
    dmask = dmask[:, None, None, :]
    entries.append(record(
        "decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:88",
        f"q {B}x{Hq}x{D} kv {B}x{Hkv}x{S}x{D} kv_len {lens}", err,
        lambda: dec.decode_attention(q, k, v, kv_len=kv_len),
        lambda: ref.decode_attention(q, k, v, kv_len=kv_len),
        (lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=dmask, enable_gqa=True))
        if sdpa_gqa else None,
        nbytes=2.0 * q.numel() * 2 + 4 * B + sum(lens) * Hkv * D * 2 * 2,
        ops=4.0 * sum(lens) * Hq * D))

    # chunk_attention: a short continuation chunk deep in the cache (the
    # split path: too few query tiles to fill the card) and a full
    # prefill chunk
    cases, errs = [], []
    for T, pos_l in ((8, [0, 5, 100, 1000, 2040, 333, 1500, 17]),
                     (512, [0, 512, 1024, 1536, 100, 700, 1300, 7])):
        nsplit, cols = dec.chunk_splits(Hkv, Hq // Hkv, T, S)
        log(f"[kernel] chunk_attention T={T}: S cut into {nsplit} column "
            f"range(s) of {cols} (the plan of every batch size)")
        if T == 8 and nsplit == 1:
            fail("chunk_attention T=8: the planner did not split the columns")
        qc = rnd(B, Hq, T, D)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        errs.append(max_err(torch, dec.chunk_attention(qc, k, v, pos=pos),
                            ref.chunk_attention(qc, k, v, pos=pos),
                            f"chunk_attention T={T}"))
        lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
        cmask = (torch.arange(S, device=dev)[None, None, :]
                 <= lim[:, :, None])[:, None]
        cases.append((T, pos_l, qc, pos, cmask))
    timed = []
    for T, pos_l, qc, pos, cmask in cases:
        timed.append(record(
            "chunk_attention",
            "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:434",
            f"q {B}x{Hq}x{T}x{D} kv {B}x{Hkv}x{S}x{D} pos {pos_l}", max(errs),
            lambda: dec.chunk_attention(qc, k, v, pos=pos),
            lambda: ref.chunk_attention(qc, k, v, pos=pos),
            (lambda: F.scaled_dot_product_attention(
                qc, k, v, attn_mask=cmask, enable_gqa=True))
            if sdpa_gqa else None,
            **chunk_work(pos_l, T, S, Hq, Hkv, D)))
    short, e = timed
    e["short_chunk"] = sub_entry(short)
    entries.append(e)       # the prefill chunk, T = 512, with T = 8 inside
    entries += check_paged_kernels(torch, record, k, v, lens, cases)
    del flush
    torch.cuda.empty_cache()
    return entries


PAGE = 64                       # the serving page size: one 64-row tile


def shred(torch, k, ps, perm):
    """The contiguous cache k [B, Hkv, S, D] as a page arena of ps-row
    pages: row b's virtual page j is arena page perm[b, j]; page 0 is
    scratch, filled with large finite garbage."""
    B, Hkv, S, D = k.shape
    nb = S // ps
    arena = torch.full((1 + B * nb, Hkv, ps, D), 1e4, dtype=k.dtype,
                       device=k.device)
    arena[perm.reshape(-1).long()] = k.reshape(B, Hkv, nb, ps, D) \
        .transpose(1, 2).reshape(B * nb, Hkv, ps, D)
    return arena


def tables(torch, perm, ps, limits):
    """perm with every slot past each row's limit pointed at page 0."""
    bt = perm.clone()
    for b, lim in enumerate(limits):
        bt[b, -(-lim // ps):] = 0
    return bt.contiguous()


def check_paged_kernels(torch, record, k, v, lens, cases):
    """Phase 3, paged: each paged kernel against its plain version over the
    same K/V shredded into an arena, timed beside the dense kernel on the
    contiguous cache.  `lens` and `cases` are the dense phase's decode
    lengths and chunk cases.  Returns the two entries of the kernels
    line."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    dev = k.device
    B, Hkv, S, D = k.shape
    Hq = 32
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(k.dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    errs = {"decode": [], "chunk": []}
    arenas = {}
    for ps in (PAGE, 16):   # bf16 chunk pages: by TMA at 64, gathered at 16
        nb = S // ps
        perm = (torch.randperm(B * nb, generator=gen, device=dev) + 1) \
            .to(torch.int32).reshape(B, nb)
        kp, vp = shred(torch, k, ps, perm), shred(torch, v, ps, perm)
        arenas[ps] = (kp, vp, perm)
        bt = tables(torch, perm, ps, lens)
        o = dec.decode_attention_paged(q, kp, vp, block_table=bt,
                                       kv_len=kv_len)
        errs["decode"].append(max_err(
            torch, o, ref.decode_attention_paged(q, kp, vp, block_table=bt,
                                                 kv_len=kv_len),
            f"decode_attention_paged page_size {ps}"))
        if not bool((o[kv_len == 0] == 0).all()):
            fail("decode_attention_paged: the kv_len == 0 row is not zeros")
        for T, pos_l, qc, pos, _ in cases:
            btc = tables(torch, perm, ps, [p + T for p in pos_l])
            errs["chunk"].append(check_paged_chunk(
                torch, qc, k, v, kp, vp, btc, pos,
                f"chunk_attention_paged T={T} page_size {ps}"))
    check_decode_identities(torch, q, k, v, kv_len, arenas, lens)
    check_chunk_identities(torch, k, v, arenas, cases)
    kp, vp, perm = arenas[PAGE]
    nb = S // PAGE
    src = "src/repro_torch/kernels/csrc/decode_attention.cu"
    pages = lambda limits: sum(-(-min(n, S) // PAGE) for n in limits)
    bt = tables(torch, perm, PAGE, lens)
    entries = [record(
        "decode_attention_paged", src,
        "src/repro/kernels/decode_attention.py:262",
        f"q {B}x{Hq}x{D} pages {kp.shape[0]}x{Hkv}x{PAGE}x{D} bt {B}x{nb} "
        f"kv_len {lens}", max(errs["decode"]),
        lambda: dec.decode_attention_paged(q, kp, vp, block_table=bt,
                                           kv_len=kv_len),
        lambda: ref.decode_attention_paged(q, kp, vp, block_table=bt,
                                           kv_len=kv_len),
        None,   # no one PyTorch call attends through a block table
        nbytes=2.0 * q.numel() * 2 + 4 * B + 4 * pages(lens)
        + sum(lens) * Hkv * D * 2 * 2,
        ops=4.0 * sum(lens) * Hq * D,
        dense=lambda: dec.decode_attention(q, k, v, kv_len=kv_len))]
    timed = []
    for T, pos_l, qc, pos, _ in cases:
        btc = tables(torch, perm, PAGE, [p + T for p in pos_l])
        timed.append(record(
            "chunk_attention_paged", src,
            "src/repro/kernels/decode_attention.py:373",
            f"q {B}x{Hq}x{T}x{D} pages {kp.shape[0]}x{Hkv}x{PAGE}x{D} "
            f"bt {B}x{nb} pos {pos_l}", max(errs["chunk"]),
            lambda: dec.chunk_attention_paged(qc, kp, vp, block_table=btc,
                                              pos=pos),
            lambda: ref.chunk_attention_paged(qc, kp, vp, block_table=btc,
                                              pos=pos),
            None,
            **chunk_work(pos_l, T, S, Hq, Hkv, D, page=PAGE),
            dense=lambda: dec.chunk_attention(qc, k, v, pos=pos)))
    short, e = timed
    log(f"[kernel] chunk_attention_paged T=512 page_size {PAGE}: paged / "
        f"dense {e['ms'] / e['dense_ms']:.3f} (T=8: "
        f"{short['ms'] / short['dense_ms']:.3f})")
    e["short_chunk"] = sub_entry(short)
    entries.append(e)       # the prefill chunk, T = 512, with T = 8 inside
    return entries


def check_decode_identities(torch, q, k, v, kv_len, arenas, lens):
    """Decode's two identities: the paged instance equals the dense one on
    the same K/V (torch.equal) at page sizes 64 (TMA), 16 and 5 (the
    cp.async gather; 5 over the cache padded to 2050 rows), and a row
    decoded alone equals the same row in the batch of 8, dense and
    paged (the split plan follows S only)."""
    from repro_torch.kernels import decode_attention as dec

    dev = k.device
    B, Hkv, S, D = k.shape
    dense = dec.decode_attention(q, k, v, kv_len=kv_len)
    cases = [(ps, kp, vp, tables(torch, perm, ps, lens), dense)
             for ps, (kp, vp, perm) in arenas.items()]
    pad = lambda t: torch.cat([t, t.new_zeros(B, Hkv, 2, D)], dim=2)
    k5, v5 = pad(k), pad(v)
    gen = torch.Generator(device=dev).manual_seed(5)
    perm5 = (torch.randperm(B * 410, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(B, 410)
    cases.append((5, shred(torch, k5, 5, perm5), shred(torch, v5, 5, perm5),
                  tables(torch, perm5, 5, lens),
                  dec.decode_attention(q, k5, v5, kv_len=kv_len)))
    for ps, kp, vp, bt, want in cases:
        o = dec.decode_attention_paged(q, kp, vp, block_table=bt,
                                       kv_len=kv_len)
        torch.cuda.synchronize()
        if not torch.equal(o, want):
            fail(f"decode_attention_paged page_size {ps}: the output "
                 f"differs from the dense kernel's on the same K/V")
        for i in (3, 5, 7):
            one = slice(i, i + 1)
            alone = dec.decode_attention_paged(
                q[one], kp, vp, block_table=bt[one].contiguous(),
                kv_len=kv_len[one])
            torch.cuda.synchronize()
            if not torch.equal(alone, o[one]):
                fail(f"decode_attention_paged page_size {ps}: row {i} "
                     f"alone differs from row {i} in the batch")
    for i in (3, 5, 7):
        one = slice(i, i + 1)
        alone = dec.decode_attention(q[one], k[one], v[one],
                                     kv_len=kv_len[one])
        torch.cuda.synchronize()
        if not torch.equal(alone, dense[one]):
            fail(f"decode_attention: row {i} alone differs from row {i} "
                 f"in the batch")
    log(f"[kernel] decode_attention: paged equals dense at page sizes "
        f"{sorted(c[0] for c in cases)}; rows 3, 5, 7 alone equal "
        f"themselves in the batch of {B}, dense and paged")


def check_chunk_identities(torch, k, v, arenas, cases):
    """Chunk attention's batch invariance: a row computed alone equals
    the same row in the batch of 8 (torch.equal), dense and paged at page
    sizes 64 (TMA) and 16 (the gather), at T 8 (split columns) and T 512
    (the split plan follows (Hkv, G, T, S), never B)."""
    from repro_torch.kernels import decode_attention as dec

    for T, pos_l, qc, pos, _ in cases:
        runs = [("dense", lambda q_, p_, rows: dec.chunk_attention(
            q_, k[rows], v[rows], pos=p_))]
        for ps, (kp, vp, perm) in arenas.items():
            bt = tables(torch, perm, ps, [p + T for p in pos_l])
            runs.append((f"paged page_size {ps}",
                         lambda q_, p_, rows, kp=kp, vp=vp, bt=bt:
                         dec.chunk_attention_paged(
                             q_, kp, vp, block_table=bt[rows].contiguous(),
                             pos=p_)))
        for what, run in runs:
            every = slice(None)
            batch = run(qc, pos, every)
            for i in (3, 4, 6):
                one = slice(i, i + 1)
                alone = run(qc[one].contiguous(), pos[one], one)
                torch.cuda.synchronize()
                if not torch.equal(alone, batch[one]):
                    fail(f"chunk_attention {what} T={T}: row {i} alone "
                         f"differs from row {i} in the batch")
    log(f"[kernel] chunk_attention: rows 3, 4, 6 alone equal themselves in "
        f"the batch of 8 at T {[c[0] for c in cases]}, dense and paged at "
        f"page sizes {sorted(arenas)}")


def check_paged_chunk(torch, qc, k, v, kp, vp, bt, pos, what: str) -> float:
    """The paged chunk kernel against its plain version, and equal to the
    dense kernel on the contiguous cache k, v that the arena holds (one
    arithmetic body; a masked entry adds exactly 0).  Returns the max abs
    error."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    o = dec.chunk_attention_paged(qc, kp, vp, block_table=bt, pos=pos)
    err = max_err(torch, o, ref.chunk_attention_paged(
        qc, kp, vp, block_table=bt, pos=pos), what)
    if not torch.equal(o, dec.chunk_attention(qc, k, v, pos=pos)):
        fail(f"{what}: the paged output differs from the dense kernel's on "
             f"the same K/V")
    return err


# --------------------------------------------------------- train kernels ----
TRAIN_SHAPE = (4, 32, 4, 2048, 64)      # B, Hq, Hkv, S, D of the train phase


def check_train_kernels(torch):
    """Phase 3b: the training kernels against their plain versions, and
    their times at the training shapes.  Returns their three entries of
    the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf16)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    B, Hq, Hkv, S, D = TRAIN_SHAPE
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    errs = {"fwd": [], "train": [], "bwd": []}
    # (what, B, Hq, Hkv, Sq, Sk, D, causal, softcap, sm_scale): the
    # training shape first
    cases = [("training", B, Hq, Hkv, S, S, D, True, 0.0, None),
             ("ragged S=2000", 2, Hq, Hkv, 2000, 2000, D, True, 0.0, None),
             ("non-causal Sq=512 Sk=2048", 2, Hq, Hkv, 512, 2048, D, False,
              0.0, None),
             ("softcap 30", 2, Hq, Hkv, 1024, 1024, D, True, 30.0, None),
             ("G=5 D=128 (qwen3 layout)", 1, 40, 8, 1024, 1024, 128, True,
              0.0, None),
             ("sm_scale 0.0917", 2, Hq, Hkv, 1024, 1024, D, True, 0.0,
              0.0917)]
    for what, b, hq, hkv, sq, sk, d, causal, cap, scale in cases:
        q, k, v, do = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), \
            rnd(b, hkv, sk, d), rnd(b, hq, sq, d)
        opts = dict(causal=causal, logit_softcap=cap, sm_scale=scale)
        off = dict(q_offset=sk - sq if causal else 0)
        o, lse, _ = fa.flash_attention(q, k, v, **opts)
        o_r, lse_r = ref.attention(q, k, v, return_lse=True, **opts, **off)
        errs["fwd"].append(max_err(torch, o, o_r, f"flash_attention {what}"))
        max_err(torch, lse, lse_r, f"flash_attention lse {what}")
        o32, terr = training_forward(torch, q, k, v, o, lse,
                                     f"flash_attention {what}", **opts)
        errs["train"].append(terr)
        grads = fa.flash_attention_backward(q, k, v, o_r.float(), lse_r, do,
                                            **opts)
        want = ref.attention_backward(q, k, v, o_r, lse_r, do, **opts, **off)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            errs["bwd"].append(max_err(
                torch, g, w, f"flash_attention_backward {name} {what}"))
        if what == "training":
            timed = (q, k, v, do, o, lse, o32)
        del q, k, v, do, o, lse, o32, o_r, lse_r, grads, want
        torch.cuda.empty_cache()
    log(f"[train-kernels] flash cases {[c[0] for c in cases]}: forward "
        f"max_abs_err per case {[f'{e:.3e}' for e in errs['fwd']]}, "
        f"training's forward (o32) {[f'{e:.3e}' for e in errs['train']]}, "
        f"backward (dq, dk, dv per case) "
        f"{[f'{e:.3e}' for e in errs['bwd']]}")

    q, k, v, do, o, lse, o32 = timed
    shape = f"q {B}x{Hq}x{S}x{D} kv {B}x{Hkv}x{S}x{D} causal"
    fwd_ops, bwd_ops, io = flash_work(q, k, v)
    entries = [record_kernel(
        torch, flush, "flash_attention", src,
        "src/repro/kernels/flash_attention.py:94", shape, max(errs["fwd"]),
        lambda: fa.flash_attention(q, k, v),
        lambda: ref.attention(q, k, v, q_offset=0, return_lse=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        nbytes=io + 2.0 * o.numel() + 4.0 * lse.numel(), ops=fwd_ops)]
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                         enable_gqa=True)
    entries.append(record_kernel(
        torch, flush, "flash_attention_backward", src,
        "src/repro/kernels/flash_attention.py:94 (backward of "
        "src/repro/kernels/ref.py:183)", shape, max(errs["bwd"]),
        lambda: fa.flash_attention_backward(q, k, v, o32, lse, do),
        lambda: ref.attention_backward(q, k, v, o32, lse, do, q_offset=0),
        lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                    retain_graph=True),
        # reads q, k, v, o (f32), dO, lse; writes dq, dk, dv.  Operations:
        # S and dP recomputed, dV, dK, dQ: five products, 2.5x the
        # forward's
        nbytes=2 * io + 6.0 * o.numel() + 4.0 * lse.numel(),
        ops=bwd_ops))
    entries[0]["training"] = record_training_forward(
        torch, flush, entries[0], shape, max(errs["train"]), q, k, v, o, lse,
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True))
    for what, e, ops in (("flash_attention", entries[0], fwd_ops),
                         ("flash_attention training",
                          entries[0]["training"], fwd_ops),
                         ("flash_attention_backward", entries[1], bwd_ops)):
        log(f"[train-kernels] {what} {shape}: {ops / e['ms'] / 1e9:.1f} "
            f"TFLOP/s, {100 * e['bound_ms'] / e['ms']:.1f}% of its bound, "
            f"{e['ms'] / e['library_ms']:.2f}x SDPA")
    del out, qq, kk, vv, timed, q, k, v, do, o, lse, o32
    torch.cuda.empty_cache()
    time_flash_shape(torch, flush, rnd, 1, 40, 8, 2048, 128)

    # rmsnorm backward at the train phase's hidden states
    x, dy = rnd(B, S, 2048), rnd(B, S, 2048)
    w = (1.0 + 0.1 * torch.randn(2048, generator=gen, device=dev)).to(bf16)
    dx, dw = rms.rmsnorm_backward(x, w, dy)
    dx_r, dw_r = ref.rmsnorm_backward(x, w, dy)
    err = max_err(torch, dx, dx_r, "rmsnorm_backward dx")
    # dw sums 8192 rows: held relative to its largest entry
    scale = dw_r.float().abs().max()
    err_w = max_err(torch, dw.float() / scale, dw_r.float() / scale,
                    "rmsnorm_backward dw (relative to max |dw|)")
    xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = F.rms_norm(xx, (2048,), ww, 1e-5)
    entries.append(record_kernel(
        torch, flush, "rmsnorm_backward",
        "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:38 (backward)",
        f"x {B}x{S}x2048", max(err, err_w),
        lambda: rms.rmsnorm_backward(x, w, dy),
        lambda: ref.rmsnorm_backward(x, w, dy),
        lambda: torch.autograd.grad(y, (xx, ww), dy, retain_graph=True),
        # reads x, dy, w; writes dx, dw
        nbytes=2.0 * (3 * x.numel() + 2 * 2048), ops=10.0 * x.numel()))
    del x, dy, dx, dw, dx_r, dw_r, xx, ww, y, flush
    torch.cuda.empty_cache()
    return entries


def flash_work(q, k, v, causal: bool = True):
    """(FLOPs of the forward, of the backward's five products, and bytes
    of bf16 q, k, v) for q [B, Hq, Sq, D], k [B, Hkv, Sk, D], v [B, Hkv,
    Sk, Dv] (causal: Sq == Sk): the forward's Q K^T and P V over the
    visible pairs (causal: S (S + 1) / 2 a head, else Sq Sk); the
    backward's S and dP recomputed, dV, dK and dQ (at Dv = D, 2.5x the
    forward's)."""
    B, Hq, S, D = q.shape
    Dv = v.shape[-1]
    pairs = B * Hq * (S * (S + 1) / 2 if causal else S * k.shape[2])
    return (2.0 * pairs * (D + Dv), 2.0 * pairs * (3 * D + 2 * Dv),
            2.0 * (q.numel() + k.numel() + v.numel()))


def training_forward(torch, q, k, v, o, lse, what: str, tol=KERNEL_TOL,
                     **opts):
    """Training's flash forward (keep_f32: o also in f32 before its
    rounding, which the backward's delta reads) on the inputs whose
    inference forward gave (o, lse): o and lse the same bits, o32 rounds
    to o, and o32 is within `tol` of the plain version computed in f32.
    Returns (o32, its max abs error)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    o_t, lse_t, o32 = fa.flash_attention(q, k, v, keep_f32=True, **opts)
    torch.cuda.synchronize()
    if not (torch.equal(o_t, o) and torch.equal(lse_t, lse)
            and torch.equal(o32.to(o.dtype), o)):
        fail(f"{what}: training's forward (keep_f32) differs from "
             f"inference's o or lse, or its o32 does not round to o")
    off = k.shape[2] - q.shape[2] if opts.get("causal", True) else 0
    want = ref.attention(q.float(), k.float(), v.float(), q_offset=off,
                         **opts)
    return o32, max_err(torch, o32, want, f"{what} o32 (plain in f32)", tol)


def record_training_forward(torch, flush, e, shape, err, q, k, v, o, lse,
                            library, **opts):
    """Time training's flash forward (keep_f32) at one shape beside its
    plain version, `library` and its bound (the inference forward's, plus
    o written once more in f32): the sub-entry of entry `e`."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    fwd_ops, _, io = flash_work(q, k, v, causal=opts.get("causal", True))
    off = k.shape[2] - q.shape[2] if opts.get("causal", True) else 0
    return sub_entry(record_kernel(
        torch, flush, e["name"], e["source"], e["replaces"],
        shape + ", training (keep_f32)", err,
        lambda: fa.flash_attention(q, k, v, keep_f32=True, **opts),
        lambda: ref.attention(q, k, v, q_offset=off, return_lse=True,
                              **opts),
        library, nbytes=io + 6.0 * o.numel() + 4.0 * lse.numel(),
        ops=fwd_ops))


def time_flash_shape(torch, flush, rnd, B, Hq, Hkv, S, D):
    """Phase 3b: both flash kernels at a second causal shape beside SDPA
    (forward and autograd backward), with their TFLOP/s and share of the
    bound, on a log line (the kernels line keeps TRAIN_SHAPE)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = rnd(B, Hq, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D), \
        rnd(B, Hq, S, D)
    o, lse, o32 = fa.flash_attention(q, k, v, keep_f32=True)
    fwd_ops, bwd_ops, io = flash_work(q, k, v)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                         enable_gqa=True)
    rows = [("flash_attention", fwd_ops,
             bound(io + 2.0 * o.numel() + 4.0 * lse.numel(), fwd_ops,
                   "bfloat16")[0],
             time_ms(torch, lambda: fa.flash_attention(q, k, v), flush),
             time_ms(torch, lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True), flush)),
            ("flash_attention_backward", bwd_ops,
             bound(2 * io + 6.0 * o.numel() + 4.0 * lse.numel(),
                   bwd_ops, "bfloat16")[0],
             time_ms(torch, lambda: fa.flash_attention_backward(
                 q, k, v, o32, lse, do), flush),
             time_ms(torch, lambda: torch.autograd.grad(
                 out, (qq, kk, vv), do, retain_graph=True), flush))]
    for name, ops, b_ms, ms, sdpa_ms in rows:
        log(f"[train-kernels] {name} q {B}x{Hq}x{S}x{D} kv {B}x{Hkv}x{S}x{D} "
            f"causal: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * b_ms / ms:.1f}% of its bound {b_ms:.4f} ms), SDPA "
            f"{sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x SDPA)")
    del q, k, v, do, o, lse, o32, qq, kk, vv, out
    torch.cuda.empty_cache()


# --------------------------------------------------------------- forward ----
def forward_phase(torch):
    """Phase 4: full-width logits, kernels vs plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("tinyllama_1_1b")
    mk = build_model(cfg, impl="kernel", device="cuda")
    mr = build_model(cfg, impl="ref", device="cuda")
    t0 = time.monotonic()
    params = mk.init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[forward] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f}B params ({cfg.param_dtype}) "
        f"initialised in {time.monotonic() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, T = 4, 512
    tokens = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    ck, cr = mk.init_cache(B, 2048), mr.init_cache(B, 2048)
    lk, ck, _ = mk.forward_chunk(params, tokens, None, ck, zero)
    lr, cr, _ = mr.forward_chunk(params, tokens, None, cr, zero)
    compare_logits(torch, lk, lr, (B, cfg.vocab), "prefill chunk T=512")
    nxt = torch.argmax(lk, dim=-1).to(torch.int32)
    at = torch.full((B,), T, dtype=torch.int32, device="cuda")
    lk, _, _ = mk.decode_step(params, nxt, None, ck, at)
    lr, _, _ = mr.decode_step(params, nxt, None, cr, at)
    compare_logits(torch, lk, lr, (B, cfg.vocab), "decode step")
    del params, ck, cr
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _leaf_items(tree, prefix=""):
    """(path, leaf) of a nested dict of tensors."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        yield from (_leaf_items(v, path) if isinstance(v, dict)
                    else ((path, v),))


def compare_logits(torch, got, want, shape, what):
    torch.cuda.synchronize()
    if tuple(got.shape) != shape or tuple(want.shape) != shape:
        fail(f"{what}: logits shape {tuple(got.shape)}, expected {shape}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{what}: logits are not finite")
    g, w = got.float(), want.float()
    rel = ((g - w).norm() / w.norm()).item()
    log(f"[forward] {what}: logits {shape}, max |kernel - plain| "
        f"{(g - w).abs().max().item():.4e}, max |plain| "
        f"{w.abs().max().item():.3f}, relative L2 error {rel:.3e} "
        f"(tolerance {LOGITS_REL_TOL})")
    if rel > LOGITS_REL_TOL:
        fail(f"{what}: kernel and plain logits disagree (relative L2 error "
             f"{rel:.3e} > {LOGITS_REL_TOL})")


# ----------------------------------------------------------------- serve ----
PROMPT_LENS = [16, 1500, 700, 33, 1024, 511, 513, 90,
               1200, 260, 48, 999, 1337, 128, 640, 1499]


def make_engine(torch, profile_dir: str, arch: str = "tinyllama_1_1b",
                cfg=None, params=None, **extra):
    """The serving engine of phases 5, 5b, 7, 8, 9 and 11 for `arch` (or
    `cfg`, a config cut from it), on `params` or seeded random weights
    (`extra`: more ServeConfig fields — page_size and max_cache_pages for
    the paged pool, xfa_collector for phase 9's fleet stream) and its 16
    prompts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = cfg or get_config(arch)
    model = build_model(cfg, impl="auto", device="cuda")
    engine = ServingEngine(model, model.init(0) if params is None else params,
                           ServeConfig(
        max_batch=8, max_seq_len=2048, prefill_chunk=512, prefill_batch=8,
        eos_token=-1, profile_dir=profile_dir, **extra))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    return cfg, engine, prompts


SERVE_EDGES = ("queue_wait", "ttft", "decode_token", "e2e",
               "prefill_request", "prefill_chunk", "decode_tick")
PAGE_GAUGES = ("cache_pages_in_use", "cache_page_hwm",
               "cache_pages_capacity")


def check_launch_counts(cfg, engine, counts, what: str, forwards: int = 0):
    """The launch counts of a serving run must fit the model's depth: per
    forward, the dense family runs its attention pair once per layer and
    rmsnorm 2L+1 times; the hybrid runs chunk or decode attention once per
    shared-block call (n_super), ssd_scan once per Mamba layer of a
    prefill group, and rmsnorm 2L + 2 n_super + 1 times.  The other
    attention pair (paged or dense) never runs.  The ssm family (xLSTM)
    runs no attention: rmsnorm n_mLSTM + 2 n_sLSTM + 1 times a forward,
    of the engine's `forwards`.  Returns (prefill groups, decode
    ticks, a note on the per-forward counts); for the ssm family (the
    forwards, 0, the note)."""
    if cfg.family == "ssm":
        n_s = cfg.n_layers // cfg.slstm_every
        norms = cfg.n_layers + n_s + 1
        if forwards <= 0 or counts["rmsnorm"] != norms * forwards or any(
                n for k, n in counts.items() if k != "rmsnorm"):
            fail(f"{what}: launch counts inconsistent with {cfg.name}'s "
                 f"{forwards} forwards: {counts}")
        return forwards, 0, f"per forward: rmsnorm {norms}, nothing else"
    sfx = "_paged" if engine.paged else ""
    other = "" if engine.paged else "_paged"
    L = cfg.n_layers
    calls = L // cfg.attn_every if cfg.family == "hybrid" else L
    groups = counts["chunk_attention" + sfx] / calls
    ticks = counts["decode_attention" + sfx] / calls
    norms = 2 * L + 1 + (2 * calls if cfg.family == "hybrid" else 0)
    ok = groups == int(groups) and ticks == int(ticks) and groups > 0 \
        and ticks > 0 and counts["rmsnorm"] == norms * (groups + ticks) \
        and not counts["chunk_attention" + other] \
        and not counts["decode_attention" + other] \
        and counts["ssd_scan"] == (L * groups if cfg.family == "hybrid"
                                   else 0)
    if not ok:
        fail(f"{what}: launch counts inconsistent with {cfg.name}'s depth: "
             f"{counts}")
    note = f"per forward: rmsnorm {norms}, attention {calls}" + (
        f", ssd_scan {L} per prefill group" if cfg.family == "hybrid" else "")
    return int(groups), int(ticks), note


def serve_run(torch, what: str, on_engine=None, arch: str = "tinyllama_1_1b",
              cfg=None, params=None, **paged):
    """Serve the 16 prompts (32 new tokens each) through a fresh engine
    for `arch` or `cfg` (on `params`, if given; handed to `on_engine`
    first, if given), with the launch counters set to 0 just before and
    read just after.  Checks every request, the cache and the launch
    counts, and loads the profile shard back.  Returns (engine, done,
    launch counts, latency stats, serve edges of the shard)."""
    from repro_torch.core import tracer as xfa
    from repro_torch.kernels import ops
    from repro_torch.profile import load_profile
    from repro_torch.serving import latency_stats, run_workload

    xfa.reset()          # this run's folds only, not an earlier run's
    with keep_dir(what) as prof:
        cfg, engine, prompts = make_engine(torch, prof, arch, cfg, params,
                                           **paged)
        if on_engine is not None:
            on_engine(engine)
        t0 = time.monotonic()
        engine.warm_chunk_programs()
        log(f"[{what}] warmed {len(engine.chunk_buckets())} widths x "
            f"{len(engine.batch_buckets())} batch buckets in "
            f"{time.monotonic() - t0:.1f}s")
        ops.reset_launch_counts()
        forwards = engine.forward_calls
        t0 = time.monotonic()
        done = run_workload(engine, prompts, 32, mode="closed")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        forwards = engine.forward_calls - forwards
        if len(done) != len(prompts) or not all(r.done for r in done):
            fail(f"{what}: {len(done)} of {len(prompts)} requests completed")
        for r in done:
            if r.error is not None or len(r.output) != 32 \
                    or not all(0 <= t < cfg.vocab for t in r.output):
                fail(f"{what}: request {r.uid} output is wrong: {r.output}")
        for name, leaf in _leaf_items(engine.cache):
            if not torch.isfinite(leaf).all():
                fail(f"{what}: the cache leaf {name} holds non-finite "
                     f"values")
        groups, ticks, note = check_launch_counts(cfg, engine, counts, what,
                                                  forwards)
        folded = load_profile(prof).to_folded()
        serve = {k[2]: e for k, e in folded.edges.items() if k[1] == "serve"}
        for phase in SERVE_EDGES + (PAGE_GAUGES if engine.paged else ()):
            if phase not in serve:
                fail(f"{what}: profile shard lacks the serve edge {phase}")
        if serve["ttft"].count < len(prompts):
            fail(f"{what}: ttft folded fewer times than requests served")
    stats = latency_stats(done, wall)
    stats["prefill_chunk_ms"] = \
        serve["prefill_chunk"].total_ns / serve["prefill_chunk"].count / 1e6
    log(f"[{what}] {len(done)} requests, {int(stats['tokens'])} new tokens "
        f"(prompts {min(PROMPT_LENS)}..{max(PROMPT_LENS)}, "
        f"{sum(PROMPT_LENS)} prompt tokens) in {wall:.3f}s: "
        f"{stats['throughput_tok_s']:.1f} tok/s; ttft mean "
        f"{stats['ttft_mean_s'] * 1e3:.1f} ms p50 "
        f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
        f"{stats['ttft_p95_s'] * 1e3:.1f} ms; decode "
        f"{stats['decode_s_per_tok'] * 1e3:.2f} ms/token")
    log(f"[{what}] " + (f"forwards {groups}" if cfg.family == "ssm" else
                         f"prefill groups {groups}, decode ticks {ticks}")
        + f", launches {json.dumps(counts)} ({note})")
    log(f"[{what}] xfa prefill_chunk mean {stats['prefill_chunk_ms']:.2f}"
        f" ms x {serve['prefill_chunk'].count}, decode_token mean "
        f"{serve['decode_token'].total_ns / serve['decode_token'].count / 1e6:.3f}"
        f" ms x {serve['decode_token'].count}")
    return engine, done, counts, stats, serve


def streams(done):
    """Token streams in submission order (`done` is in finishing order)."""
    return [r.output for r in sorted(done, key=lambda r: r.uid)]


def serve_phase(torch):
    """Phase 5: the main path, contiguous cache.  Returns (launch counts,
    latency stats, token streams)."""
    engine, done, counts, stats, _ = serve_run(torch, "serve")
    outputs = streams(done)
    del engine
    torch.cuda.empty_cache()
    return counts, stats, outputs


def paged_phase(torch, dense_stats, dense_outputs):
    """Phase 5b: the paged pool, (a) at the contiguous pool's capacity,
    (b) at a quarter of it.  Returns run (a)'s launch counts."""
    base = dict(page_size=PAGE)
    # (a) 257 pages: 256 usable = 16384 rows, the contiguous pool's
    # capacity; all 16 reservations total 179 pages, so the schedule is
    # phase 5's
    engine, done, counts, stats, _ = serve_run(
        torch, "paged", max_cache_pages=257, **base)
    if streams(done) != dense_outputs:
        fail("paged: greedy tokens differ from the contiguous run")
    alloc = engine.allocator
    if alloc.in_use != 0 or alloc.hwm > alloc.usable:
        fail(f"paged: allocator in_use {alloc.in_use} hwm {alloc.hwm}")
    log(f"[paged] 16 of 16 token streams equal the contiguous run; page "
        f"hwm {alloc.hwm} of {alloc.usable}; tok/s {stats['throughput_tok_s']:.1f}"
        f" vs {dense_stats['throughput_tok_s']:.1f}, ttft mean/p50/p95 "
        f"{stats['ttft_mean_s'] * 1e3:.1f}/{stats['ttft_p50_s'] * 1e3:.1f}/"
        f"{stats['ttft_p95_s'] * 1e3:.1f} ms vs "
        f"{dense_stats['ttft_mean_s'] * 1e3:.1f}/"
        f"{dense_stats['ttft_p50_s'] * 1e3:.1f}/"
        f"{dense_stats['ttft_p95_s'] * 1e3:.1f} ms, decode "
        f"{stats['decode_s_per_tok'] * 1e3:.2f} vs "
        f"{dense_stats['decode_s_per_tok'] * 1e3:.2f} ms/token (contiguous)")
    del engine
    torch.cuda.empty_cache()

    # (b) 65 pages: 64 usable = 4096 rows, a quarter of the contiguous
    # pool; the first eight requests reserve 75 pages, so admission waits
    # on pages with slots free.  The gate is wrapped to count refusals.
    refused = []

    def count_refusals(engine):
        gate = engine.scheduler.page_gate

        def counting(req):
            ok = gate(req)
            if not ok:
                refused.append(req.uid)
            return ok
        engine.scheduler.page_gate = counting

    engine, done, counts_b, _, serve = serve_run(
        torch, "paged-quarter", on_engine=count_refusals,
        max_cache_pages=65, **base)
    alloc = engine.allocator
    if alloc.in_use != 0 or not 0 < alloc.hwm <= 64:
        fail(f"paged-quarter: allocator in_use {alloc.in_use} hwm "
             f"{alloc.hwm} (must drain to 0 with hwm <= 64)")
    if not refused:
        fail("paged-quarter: the page gate never back-pressured admission")
    same = sum(a == b for a, b in zip(streams(done), dense_outputs))
    arena_mb = sum(t.numel() * t.element_size()
                   for t in engine.cache.values()) / 1e6
    gauges = {g: serve[g].count for g in PAGE_GAUGES}
    log(f"[paged-quarter] arena {arena_mb:.1f} MB; page gate refused "
        f"{len(refused)} times ({len(set(refused))} requests); page hwm "
        f"{alloc.hwm} of {alloc.usable}, in use at drain {alloc.in_use}; "
        f"{same} of {len(done)} token streams equal the contiguous run; "
        f"gauges folded {json.dumps(gauges)}; launches "
        f"{json.dumps(counts_b)}")
    del engine
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------- train ----
def model_flops_per_token(cfg, S: int) -> float:
    """Training FLOPs per token of the dense decoder at sequence length S:
    3x the forward's (forward + backward), the forward being 2 FLOPs per
    weight of every matmul plus causal attention's 4 * S/2 * d per head
    and layer (no recompute counted)."""
    d, h, f = cfg.d_model, cfg.head_dim_, cfg.d_ff
    per_layer = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h \
        + 2 * cfg.n_heads * h * d + 2 * 3 * d * f \
        + 4 * cfg.n_heads * h * (S + 1) / 2
    return 3.0 * (cfg.n_layers * per_layer + 2 * d * cfg.vocab)


def train_phase(torch):
    """Phase 6: full-width training through the Trainer, a checkpoint that
    restores equal, and kernels vs plain versions on one step.  Returns
    (launch counts of the run, its stats)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tracer as xfa
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.profile import load_profile
    from repro_torch.runtime.trainer import Trainer, init_train_state
    from repro_torch.tree import leaves_with_path

    xfa.reset()          # the shard phase 9 diagnoses: this run's folds only
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg, impl="auto", device="cuda")
    B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[3]
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=2,
                       ckpt_interval=TRAIN_STEPS)
    with keep_dir("train") as d:
        trainer = Trainer(model, tcfg, CheckpointManager(
            os.path.join(d, "ckpt"), async_save=True),
            profile_dir=os.path.join(d, "prof"))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        state, _ = trainer.run(0, SyntheticLMData(cfg, B, S), TRAIN_STEPS,
                               resume=False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = trainer.history
        if len(hist) != TRAIN_STEPS:
            fail(f"train: {len(hist)} of {TRAIN_STEPS} steps recorded")
        for h in hist:
            if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm")):
                fail(f"train: step {h['step']} loss {h['loss']} grad norm "
                     f"{h['grad_norm']} not finite")
        for name in TRAIN_KERNELS + ("rmsnorm",):
            if counts[name] <= 0:
                fail(f"train: kernel {name} was not launched: {counts}")
        folded = load_profile(os.path.join(d, "prof")).to_folded()
        steps = [e.count for k, e in folded.edges.items()
                 if k[1:] == ("runtime", "dispatch_step")]
        if steps != [TRAIN_STEPS]:
            fail(f"train: profile shard holds dispatch_step counts {steps}")
        # the checkpoint of the last step restores into an equal state
        t1 = time.monotonic()
        restored, extra = trainer.ckpt.restore(
            init_train_state(model, 1, tcfg))
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            leaves_with_path(state), leaves_with_path(restored)))
        if not same or extra != {"next_step": TRAIN_STEPS}:
            fail(f"train: the checkpoint does not restore the final state "
                 f"(equal {same}, extra {extra})")
        ckpt_gb = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(os.path.join(d, "ckpt"))
                      for f in fs) / 1e9
        restore_s = time.monotonic() - t1
        del restored
        shutil.rmtree(os.path.join(d, "ckpt"))     # phase 9 keeps prof/
    step_s = statistics.median(h["step_s"] for h in hist[1:])
    flops = model_flops_per_token(cfg, S) * B * S
    stats = {"step_ms": step_s * 1e3, "tok_s": B * S / step_s,
             "mfu": flops / step_s / PEAK_OPS_S["bfloat16"]}
    log(f"[train] {cfg.name} ({cfg.n_layers} layers, {cfg.param_dtype}, "
        f"remat {cfg.remat}), batch {B} x {S}: losses "
        f"{[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}")
    log(f"[train] step times (s) {[round(h['step_s'], 4) for h in hist]}; "
        f"median after the first {stats['step_ms']:.1f} ms = "
        f"{stats['tok_s']:.0f} tokens/s; model FLOPs "
        f"{flops / 1e12:.2f} TFLOP/step -> MFU {100 * stats['mfu']:.2f}% "
        f"of 989 TFLOP/s; peak memory {peak_gb:.1f} GB; run wall "
        f"{wall:.1f}s incl. init and the async checkpoint of "
        f"{ckpt_gb:.2f} GB (restored equal in {restore_s:.1f}s)")
    log(f"[train] launches over {TRAIN_STEPS} steps {json.dumps(counts)}")
    state, shares = profiled_step(
        torch, model, tcfg, state, SyntheticLMData(cfg, B, S).generate(
            TRAIN_STEPS), "train-profile", {"flash": FLASH_KERNEL_NAMES})
    stats.update(busy=shares["busy"], flash_share=shares["flash"])
    del state, trainer
    torch.cuda.empty_cache()
    grads_check(torch, cfg)
    return counts, stats


def grads_check(torch, cfg):
    """One loss_fn + backward at full width, batch 1 x 1024, with the
    kernels and with the plain versions on the same params and batch."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.runtime.trainer import value_and_grad
    from repro_torch.tree import leaves_with_path

    batch = SyntheticLMData(cfg, 1, 1024, seed=1).generate(0)
    params = build_model(cfg, device="cuda").init(0)
    out = {}
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device="cuda")
        loss, _, _, grads = value_and_grad(model, params, batch, None)
        out[impl] = (float(loss), leaves_with_path(grads))
        del grads
        torch.cuda.empty_cache()
    (lk, gk), (lr, gr) = out["kernel"], out["ref"]
    rel_loss = abs(lk - lr) / abs(lr)
    worst, rels = 0.0, {}
    for (name, a), (_, b) in zip(gk, gr):
        if not torch.isfinite(a).all():
            fail(f"train grads: kernel gradient {name} is not finite")
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        rels[name] = rel
        worst = max(worst, rel)
    log(f"[train] full width, batch 1 x 1024: loss kernels {lk:.6f} plain "
        f"{lr:.6f} (relative error {rel_loss:.3e}, tolerance "
        f"{LOSS_REL_TOL}); gradient relative L2 errors "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in rels.items()})} "
        f"(tolerance {GRAD_REL_TOL})")
    if rel_loss > LOSS_REL_TOL or worst > GRAD_REL_TOL:
        fail(f"train grads: kernels and plain versions disagree (loss "
             f"{rel_loss:.3e}, worst gradient leaf {worst:.3e})")
    del out
    torch.cuda.empty_cache()


def profile_phase(torch):
    """Phase 7: device time by kernel over a second, shorter serving run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import run_workload

    with keep_dir("profile-window") as prof:
        _, engine, prompts = make_engine(torch, prof)
        engine.warm_chunk_programs()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.monotonic()
            run_workload(engine, prompts[:8], 16, mode="closed")
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    breakdown(p, wall_us, "profile", "8 requests x 16 tokens")
    del engine
    torch.cuda.empty_cache()


# -------------------------------------------------------- hybrid kernels ----
SSD_SHAPE = (8, 512, 80, 64, 64, 128)   # B, L, H, P, N, chunk of phase 8


def plain_ssd(torch, x, dt, a, b, c, chunk, h0):
    """The SSD kernel's plain version with ops.ssd_scan's zero padding of L
    to a chunk multiple."""
    from repro_torch.kernels import ref

    L = x.shape[1]
    pad = (-L) % chunk

    def zp(t):
        return torch.cat([t, t.new_zeros((t.shape[0], pad)
                                         + tuple(t.shape[2:]))], dim=1)
    if pad:
        x, dt, b, c = zp(x), zp(dt), zp(b), zp(c)
    y, h = ref.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    return y[:, :L], h


def state_err(torch, got, want, what: str) -> float:
    """Max abs error of an f32 SSD state, held to STATE_TOL abs + rel."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{what}: kernel state is not finite")
    err = (got - want).abs()
    if not bool((err <= STATE_TOL + STATE_TOL * want.abs()).all()):
        fail(f"{what}: kernel state disagrees with its plain version (max "
             f"abs err {err.max().item():.3e}, tolerance {STATE_TOL} abs + "
             f"rel)")
    return err.max().item()


def check_hybrid_kernels(torch, entries):
    """Phase 3c: the hybrid path's kernels against their plain versions at
    its shapes, and their times.  Adds the head-dim-80 numbers to the
    chunk and decode attention entries of `entries`; returns (the
    ssd_scan and rmsnorm_add entries, the launch counts of rmsnorm_add's
    correctness checks)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf16)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = []

    # ssd_scan: the serving shape without and with a carried state, a
    # padded L (ops pads to the chunk) and a small chunk
    B, L, H, P, N, chunk = SSD_SHAPE
    a = -torch.exp(0.5 * torch.randn(H, generator=gen, device=dev))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs, h_errs, timed = [], [], {}
    for what, nb, l, ch, with_h0 in (("L 512 h0 none", B, L, chunk, False),
                                     ("L 512 h0 random", B, L, chunk, True),
                                     ("B 1 L 512 h0 random", 1, L, chunk,
                                      True),
                                     ("L 300 padded", B, 300, chunk, True),
                                     ("L 16 chunk 16", B, 16, 16, True)):
        x = rnd(nb, l, H, P)
        dt = F.softplus(torch.randn(nb, l, H, generator=gen, device=dev) - 2)
        b, c = rnd(nb, l, N), rnd(nb, l, N)
        h0 = torch.randn(nb, H, N, P, generator=gen, device=dev) \
            if with_h0 else None
        y, h = ops.ssd_scan(x, dt, a, b, c, chunk=ch, h0=h0, impl="kernel")
        y_r, h_r = plain_ssd(torch, x, dt, a, b, c, ch, h0)
        errs.append(max_err(torch, y, y_r, f"ssd_scan y {what}"))
        h_errs.append(state_err(torch, h, h_r, f"ssd_scan h {what}"))
        if what.endswith("L 512 h0 random"):
            timed[nb] = (x, dt, b, c, h0)
    log(f"[hybrid-kernels] ssd_scan max_abs_err per case: y "
        f"{[f'{e:.3e}' for e in errs]}, h {[f'{e:.3e}' for e in h_errs]} "
        f"(tolerance {STATE_TOL} abs + rel)")
    ssd = []
    for nb, (x, dt, b, c, h0) in timed.items():
        hg, groups, slices = ms.ssd_plan(nb, H, P, sms)
        log(f"[hybrid-kernels] ssd_scan B {nb}: {hg} head(s) a block, "
            f"{nb * groups * slices} blocks on {sms} SMs")
        # bytes: x, b, c (bf16), dt, h0 read; y (bf16), h written.
        # Operations: per (b, h, chunk) C B^T and S dtx over the T(T+1)/2
        # visible pairs, C h and the state update: 2(N+P)T(T+1)/2 + 4TNP
        ops_ssd = nb * H * (L // chunk) * (
            (N + P) * chunk * (chunk + 1) + 4.0 * chunk * N * P)
        ssd.append(record_kernel(
            torch, flush, "ssd_scan",
            "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "src/repro/kernels/mamba_scan.py:81",
            f"x {nb}x{L}x{H}x{P} b/c {nb}x{L}x{N} chunk {chunk} h0 f32",
            max(errs),
            lambda: ms.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0),
            lambda: ref.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0),
            None,   # no one PyTorch call computes the SSD scan
            nbytes=2.0 * (2 * x.numel() + b.numel() + c.numel())
            + 4.0 * (dt.numel() + a.numel() + 2 * h0.numel()), ops=ops_ssd))
    e, one = ssd
    e["batch_1"] = sub_entry(one)
    e["max_abs_err_state"] = max(h_errs)
    out.append(e)
    del x, dt, b, c, h0, timed, ssd
    torch.cuda.empty_cache()

    # rmsnorm_add at the hybrid's hidden width; its launches here are the
    # only ones (no model calls it)
    d = 2560
    xa, ra = rnd(8, 512, d), rnd(8, 512, d)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(bf16)
    before = rms.rmsnorm_add.launches
    err = 0.0
    for shape in ((8, 512, d), (3, 40)):
        xs, rs = (xa, ra) if shape[-1] == d else (rnd(*shape), rnd(*shape))
        ws = w if shape[-1] == d else w[:shape[-1]].contiguous()
        (y, s), (y_r, s_r) = rms.rmsnorm_add(xs, rs, ws), \
            ref.rmsnorm_add(xs, rs, ws)
        err = max(err, max_err(torch, y, y_r, f"rmsnorm_add y {shape}"),
                  max_err(torch, s, s_r, f"rmsnorm_add sum {shape}"))
    pathless = {"rmsnorm_add": rms.rmsnorm_add.launches - before}
    out.append(record_kernel(
        torch, flush, "rmsnorm_add", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:71", f"x, residual 8x512x{d}", err,
        lambda: rms.rmsnorm_add(xa, ra, w), lambda: ref.rmsnorm_add(xa, ra, w),
        None,   # no one PyTorch call adds and normalizes
        nbytes=2.0 * 4 * xa.numel() + 2.0 * d, ops=5.0 * xa.numel()))
    del xa, ra

    # chunk and decode attention at the shared block's shape: Hq = Hkv =
    # 32 (G = 1), head dim 80
    Bq, Hq, S, D = 8, 32, 2048, 80
    k, v = rnd(Bq, Hq, S, D), rnd(Bq, Hq, S, D)
    q = rnd(Bq, Hq, D)
    lens = [0, 1, 77, 1000, 1537, 2047, 2048, 513]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    derr = max_err(torch, dec.decode_attention(q, k, v, kv_len=kv_len),
                   ref.decode_attention(q, k, v, kv_len=kv_len),
                   "decode_attention D=80")
    dmask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])
    dmask = dmask[:, None, None, :]
    T, pos_l = 512, [0, 512, 1024, 1536, 100, 700, 1300, 7]
    qc = rnd(Bq, Hq, T, D)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    cerr = max_err(torch, dec.chunk_attention(qc, k, v, pos=pos),
                   ref.chunk_attention(qc, k, v, pos=pos),
                   "chunk_attention D=80")
    lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
    cmask = (torch.arange(S, device=dev)[None, None, :]
             <= lim[:, :, None])[:, None]
    # the paged twins over the same K/V at page sizes 64 and 16 (timed at
    # 64); paged decode must equal the dense kernel's output
    perr, dperr = 0.0, 0.0
    for ps in (16, PAGE):
        perm = (torch.randperm(Bq * (S // ps), generator=gen, device=dev)
                + 1).to(torch.int32).reshape(Bq, S // ps)
        kp, vp = shred(torch, k, ps, perm), shred(torch, v, ps, perm)
        bt = tables(torch, perm, ps, [p + T for p in pos_l])
        perr = max(perr, check_paged_chunk(
            torch, qc, k, v, kp, vp, bt, pos,
            f"chunk_attention_paged D=80 page_size {ps}"))
        dbt = tables(torch, perm, ps, lens)
        od = dec.decode_attention_paged(q, kp, vp, block_table=dbt,
                                        kv_len=kv_len)
        dperr = max(dperr, max_err(torch, od, ref.decode_attention_paged(
            q, kp, vp, block_table=dbt, kv_len=kv_len),
            f"decode_attention_paged D=80 page_size {ps}"))
        if not torch.equal(od, dec.decode_attention(q, k, v, kv_len=kv_len)):
            fail(f"decode_attention_paged D=80 page_size {ps}: the output "
                 f"differs from the dense kernel's on the same K/V")
    cases = {
        "decode_attention": (
            f"q {Bq}x{Hq}x{D} kv {Bq}x{Hq}x{S}x{D} kv_len {lens}", derr,
            lambda: dec.decode_attention(q, k, v, kv_len=kv_len),
            lambda: ref.decode_attention(q, k, v, kv_len=kv_len),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                   attn_mask=dmask),
            dict(nbytes=2.0 * q.numel() * 2 + 4 * Bq
                 + sum(lens) * Hq * D * 2 * 2, ops=4.0 * sum(lens) * Hq * D)),
        "chunk_attention": (
            f"q {Bq}x{Hq}x{T}x{D} kv {Bq}x{Hq}x{S}x{D} pos {pos_l}", cerr,
            lambda: dec.chunk_attention(qc, k, v, pos=pos),
            lambda: ref.chunk_attention(qc, k, v, pos=pos),
            lambda: F.scaled_dot_product_attention(qc, k, v,
                                                   attn_mask=cmask),
            chunk_work(pos_l, T, S, Hq, Hq, D)),
        "chunk_attention_paged": (
            f"q {Bq}x{Hq}x{T}x{D} pages {kp.shape[0]}x{Hq}x{PAGE}x{D} "
            f"bt {Bq}x{S // PAGE} pos {pos_l}", perr,
            lambda: dec.chunk_attention_paged(qc, kp, vp, block_table=bt,
                                              pos=pos),
            lambda: ref.chunk_attention_paged(qc, kp, vp, block_table=bt,
                                              pos=pos),
            None,
            dict(chunk_work(pos_l, T, S, Hq, Hq, D, page=PAGE),
                 dense=lambda: dec.chunk_attention(qc, k, v, pos=pos))),
        "decode_attention_paged": (
            f"q {Bq}x{Hq}x{D} pages {kp.shape[0]}x{Hq}x{PAGE}x{D} "
            f"bt {Bq}x{S // PAGE} kv_len {lens}", dperr,
            lambda: dec.decode_attention_paged(q, kp, vp, block_table=dbt,
                                               kv_len=kv_len),
            lambda: ref.decode_attention_paged(q, kp, vp, block_table=dbt,
                                               kv_len=kv_len),
            None,
            dict(nbytes=2.0 * q.numel() * 2 + 4 * Bq
                 + 4 * sum(-(-n // PAGE) for n in lens)
                 + sum(lens) * Hq * D * 2 * 2, ops=4.0 * sum(lens) * Hq * D,
                 dense=lambda: dec.decode_attention(q, k, v, kv_len=kv_len)))}
    for e in entries:
        if e["name"] in cases:
            shape, err, fn, plain, lib, work = cases[e["name"]]
            d80 = record_kernel(torch, flush, e["name"], e["source"],
                                e["replaces"], shape, err, fn, plain, lib,
                                **work)
            e["head_dim_80"] = sub_entry(d80)
            e["max_abs_err"] = max(e["max_abs_err"], err)
    del k, v, q, qc, kp, vp, flush
    torch.cuda.empty_cache()
    return out, pathless


# ----------------------------------------------------------- moe kernels ----
#: phi3.5-moe's attention: 32 q heads over 8 kv heads (G 4) of head dim 128
MOE_HEADS = (32, 8, 128)                # Hq, Hkv, D


#: the dense family's head layouts of phase 3g: sub-entry key -> (Hq, Hkv,
#: D).  granite-20b is MQA: 48 q heads over one kv head of 128, so a
#: decode (row, kv head) takes three blocks of DECODE_ROWS q heads;
#: internvl2-1b has 14 q over 2 kv heads of 64 (G 7)
DENSE_LAYOUTS = {"g48_d128": (48, 1, 128), "g7_d64": (14, 2, 64)}
#: rmsnorm row widths of phase 3g: sub-entry key -> (width, model)
DENSE_WIDTHS = {"width_6144": (6144, "granite_20b"),
                "width_896": (896, "internvl2_1b")}
DECODE_LENS = [0, 1, 77, 1000, 1537, 2047, 2048, 513]
CHUNK_CASES = ((512, [0, 512, 1024, 1536, 100, 700, 1300, 7]),
               (8, [0, 5, 100, 1000, 2040, 333, 1500, 17]))


def check_layout(torch, entries, key: str, Hq: int, Hkv: int, D: int,
                 seed: int):
    """Phases 3d (phi3.5-moe's layout, MOE_HEADS: G 4 at head dim 128,
    sub-entry head_dim_128) and 3g (DENSE_LAYOUTS): the attention kernels
    at one head layout (Hq q over Hkv kv heads of D), bf16: decode (kv_len
    DECODE_LENS: 0, 1, ragged and 2048; the empty row gives zeros), chunk
    attention at T 512 and T 8, their paged twins at page sizes 64 (TMA)
    and 16 (the gather), each equal to the dense kernel on the same K/V
    (decode also at page size 5), a row alone equal to its batch row
    (decode and chunk, dense and paged), and the flash pair at q
    [4,Hq,2048,D], k/v [4,Hkv,2048,D] causal with two backward launches
    bitwise equal; each against its plain version per entry at KERNEL_TOL
    (the flash backward's dk and dv against attention_backward_tc: see
    flash_backward_errs), timed beside it, its bound and SDPA; and each
    kernel in f32 against its plain version at F32_KERNEL_TOL (decode and
    chunk at the same shapes, the flash pair at q [1,Hq,1024,D]).  Adds a
    `key` sub-entry (T 8 as its short_chunk) to each kernel's entry of
    `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t_phase = time.monotonic()
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(bf16)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    tag = f"D={D} G={Hq // Hkv}"
    B, S = 8, 2048
    lens = DECODE_LENS
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    check_layout_f32(torch, gen, Hq, Hkv, D, tag)
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    q = rnd(B, Hq, D)
    dmask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])
    dmask = dmask[:, None, None, :]
    nb = S // PAGE
    arenas = {}
    for ps in (PAGE, 16):
        perm = (torch.randperm(B * (S // ps), generator=gen, device=dev)
                + 1).to(torch.int32).reshape(B, S // ps)
        arenas[ps] = (shred(torch, k, ps, perm), shred(torch, v, ps, perm),
                      perm)
    kp, vp, perm = arenas[PAGE]
    dbt = tables(torch, perm, PAGE, lens)
    od = dec.decode_attention(q, k, v, kv_len=kv_len)
    derr = max_err(torch, od, ref.decode_attention(q, k, v, kv_len=kv_len),
                   f"decode_attention {tag}")
    if not bool((od[0] == 0).all()):
        fail(f"decode_attention {tag}: the kv_len == 0 row is not zeros")
    dperr = 0.0
    for ps, (kp_, vp_, perm_) in arenas.items():
        bt_ = tables(torch, perm_, ps, lens)
        odp = dec.decode_attention_paged(q, kp_, vp_, block_table=bt_,
                                         kv_len=kv_len)
        dperr = max(dperr, max_err(torch, odp, ref.decode_attention_paged(
            q, kp_, vp_, block_table=bt_, kv_len=kv_len),
            f"decode_attention_paged {tag} page_size {ps}"))
        if not torch.equal(odp, od):
            fail(f"decode_attention_paged {tag} page_size {ps}: the output "
                 f"differs from the dense kernel's on the same K/V")
    sdpa = lambda qq, kk, vv, **kw: F.scaled_dot_product_attention(
        qq, kk, vv, enable_gqa=True, **kw)
    cases = {
        "decode_attention": [(
            f"q {B}x{Hq}x{D} kv {B}x{Hkv}x{S}x{D} kv_len {lens}", derr,
            lambda: dec.decode_attention(q, k, v, kv_len=kv_len),
            lambda: ref.decode_attention(q, k, v, kv_len=kv_len),
            lambda: sdpa(q[:, :, None], k, v, attn_mask=dmask),
            dict(nbytes=2.0 * q.numel() * 2 + 4 * B
                 + sum(lens) * Hkv * D * 2 * 2,
                 ops=4.0 * sum(lens) * Hq * D))],
        "decode_attention_paged": [(
            f"q {B}x{Hq}x{D} pages {kp.shape[0]}x{Hkv}x{PAGE}x{D} bt "
            f"{B}x{nb} kv_len {lens}", dperr,
            lambda: dec.decode_attention_paged(q, kp, vp, block_table=dbt,
                                               kv_len=kv_len),
            lambda: ref.decode_attention_paged(q, kp, vp, block_table=dbt,
                                               kv_len=kv_len),
            None,
            dict(nbytes=2.0 * q.numel() * 2 + 4 * B
                 + 4 * sum(-(-n // PAGE) for n in lens)
                 + sum(lens) * Hkv * D * 2 * 2, ops=4.0 * sum(lens) * Hq * D,
                 dense=lambda: dec.decode_attention(q, k, v, kv_len=kv_len)))],
        "chunk_attention": [], "chunk_attention_paged": []}
    chunks = []
    for T, pos_l in CHUNK_CASES:
        if T == 8 and dec.chunk_splits(Hkv, Hq // Hkv, T, S, D)[0] == 1:
            fail(f"chunk_attention {tag} T=8: the planner did not split the "
                 f"columns")
        qc = rnd(B, Hq, T, D)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        bt = tables(torch, perm, PAGE, [p + T for p in pos_l])
        cerr = max_err(torch, dec.chunk_attention(qc, k, v, pos=pos),
                       ref.chunk_attention(qc, k, v, pos=pos),
                       f"chunk_attention {tag} T={T}")
        perr = max(check_paged_chunk(
            torch, qc, k, v, kp_, vp_,
            tables(torch, perm_, ps, [p + T for p in pos_l]), pos,
            f"chunk_attention_paged {tag} T={T} page_size {ps}")
            for ps, (kp_, vp_, perm_) in arenas.items())
        lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
        cmask = (torch.arange(S, device=dev)[None, None, :]
                 <= lim[:, :, None])[:, None]
        chunks.append((T, pos_l, qc, pos, cmask))
        cases["chunk_attention"].append((
            f"q {B}x{Hq}x{T}x{D} kv {B}x{Hkv}x{S}x{D} pos {pos_l}", cerr,
            lambda qc=qc, pos=pos: dec.chunk_attention(qc, k, v, pos=pos),
            lambda qc=qc, pos=pos: ref.chunk_attention(qc, k, v, pos=pos),
            lambda qc=qc, cmask=cmask: sdpa(qc, k, v, attn_mask=cmask),
            chunk_work(pos_l, T, S, Hq, Hkv, D)))
        cases["chunk_attention_paged"].append((
            f"q {B}x{Hq}x{T}x{D} pages {kp.shape[0]}x{Hkv}x{PAGE}x{D} bt "
            f"{B}x{nb} pos {pos_l}", perr,
            lambda qc=qc, pos=pos, bt=bt: dec.chunk_attention_paged(
                qc, kp, vp, block_table=bt, pos=pos),
            lambda qc=qc, pos=pos, bt=bt: ref.chunk_attention_paged(
                qc, kp, vp, block_table=bt, pos=pos),
            None,
            dict(chunk_work(pos_l, T, S, Hq, Hkv, D, page=PAGE),
                 dense=lambda qc=qc, pos=pos: dec.chunk_attention(
                     qc, k, v, pos=pos))))
    check_decode_identities(torch, q, k, v, kv_len, arenas, lens)
    check_chunk_identities(torch, k, v, arenas, chunks)
    for e in entries:
        for i, (shape, err, fn, plain, lib, work) in enumerate(
                cases.get(e["name"], ())):
            sub = sub_entry(record_kernel(torch, flush, e["name"],
                                          e["source"], e["replaces"], shape,
                                          err, fn, plain, lib, **work))
            if i == 0:
                e[key] = sub
            else:
                e[key]["short_chunk"] = sub
            e["max_abs_err"] = max(e["max_abs_err"], err)
    del k, v, q, kp, vp, arenas, cases, chunks
    torch.cuda.empty_cache()

    del flush
    check_flash_pair(torch, entries, key, Hq, Hkv, D, (4, 2048), gen)
    log(f"[layout {tag}] {key}: {time.monotonic() - t_phase:.1f}s")


def check_flash_pair(torch, entries, key: str, Hq: int, Hkv: int, D: int,
                     shape, gen):
    """The flash pair at q [Bt,Hq,St,D], k/v [Bt,Hkv,St,D] causal (bf16;
    `shape` (Bt, St)): against the plain versions at KERNEL_TOL (the
    backward's dk and dv against attention_backward_tc), two backward
    launches bitwise equal, and the training forward; each timed beside
    its plain version, its bound and SDPA, as a `key` sub-entry of the
    flash entries of `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16)
    sdpa = lambda qq, kk, vv, **kw: F.scaled_dot_product_attention(
        qq, kk, vv, enable_gqa=True, **kw)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    tag = f"D={D} G={Hq // Hkv}"
    Bt, St = shape
    q, k, v, do = rnd(Bt, Hq, St, D), rnd(Bt, Hkv, St, D), \
        rnd(Bt, Hkv, St, D), rnd(Bt, Hq, St, D)
    o, lse, _ = fa.flash_attention(q, k, v)
    o_r, lse_r = ref.attention(q, k, v, q_offset=0, return_lse=True)
    ferr = max_err(torch, o, o_r, f"flash_attention {tag}")
    max_err(torch, lse, lse_r, f"flash_attention lse {tag}")
    o32, terr = training_forward(torch, q, k, v, o, lse,
                                 f"flash_attention {tag}")
    o_r = o_r.float()
    grads = fa.flash_attention_backward(q, k, v, o_r, lse_r, do)
    berr = flash_backward_errs(torch, grads, (q, k, v, o_r, lse_r, do), tag)
    again = fa.flash_attention_backward(q, k, v, o_r, lse_r, do)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        fail(f"flash_attention_backward {tag}: two launches differ")
    del o_r, lse_r, grads, again
    shape = f"q {Bt}x{Hq}x{St}x{D} kv {Bt}x{Hkv}x{St}x{D} causal"
    fwd_ops, bwd_ops, io = flash_work(q, k, v)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qq, kk, vv, is_causal=True)
    flash = {
        "flash_attention": (
            ferr, lambda: fa.flash_attention(q, k, v),
            lambda: ref.attention(q, k, v, q_offset=0, return_lse=True),
            lambda: sdpa(q, k, v, is_causal=True),
            dict(nbytes=io + 2.0 * o.numel() + 4.0 * lse.numel(),
                 ops=fwd_ops)),
        "flash_attention_backward": (
            berr, lambda: fa.flash_attention_backward(q, k, v, o32, lse, do),
            lambda: ref.attention_backward(q, k, v, o32, lse, do, q_offset=0),
            lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                        retain_graph=True),
            dict(nbytes=2 * io + 6.0 * o.numel() + 4.0 * lse.numel(),
                 ops=bwd_ops))}
    for e in entries:
        if e["name"] in flash:
            err, fn, plain, lib, work = flash[e["name"]]
            timed = record_kernel(torch, flush, e["name"], e["source"],
                                  e["replaces"], shape, err, fn, plain, lib,
                                  **work)
            e[key] = sub_entry(timed)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"[layout {tag}] {e['name']} {shape}: "
                f"{work['ops'] / timed['ms'] / 1e9:.1f} TFLOP/s, "
                f"{100 * timed['bound_ms'] / timed['ms']:.1f}% of its bound, "
                f"{timed['ms'] / timed['library_ms']:.2f}x SDPA")
            if e["name"] == "flash_attention":
                e[key]["training"] = train = record_training_forward(
                    torch, flush, e, shape, terr, q, k, v, o, lse,
                    lambda: sdpa(q, k, v, is_causal=True))
                e["max_abs_err"] = max(e["max_abs_err"], terr)
                log(f"[layout {tag}] flash_attention training {shape}: "
                    f"{100 * train['bound_ms'] / train['ms']:.1f}% of its "
                    f"bound, {train['ms'] / timed['ms']:.2f}x inference's "
                    f"forward")
    del q, k, v, do, o, lse, o32, qq, kk, vv, out, flash, flush
    torch.cuda.empty_cache()




def attention_backward_tc(torch, q, k, v, o, lse, do, causal=True):
    """The plain backward of ref.attention_backward (causal at Sq == Sk, or
    not causal at any Sq, Sk) with the bf16 flash kernel's tensor-core
    operands: p rounded to bf16 before dV = P^T dO, and dS rounded to bf16
    before dK = scale dS^T q and dQ = scale dS K, as the kernel (and
    FlashAttention-2) feeds its wgmma products; every product accumulates
    in f32.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    shape = (B, Hkv, Hq // Hkv, S)
    qs = (q.float() * D ** -0.5).reshape(shape + (D,))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.float())
    p = torch.exp(s - lse.float().reshape(shape)[..., None])
    if causal:
        cols = torch.arange(S, device=q.device)
        p = torch.where(cols[None, :] <= cols[:, None], p, 0.0)
    del s
    dof = do.float().reshape(shape + (-1,))
    delta = (dof * o.float().reshape(shape + (-1,))).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(torch.bfloat16).float(), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v.float())
    ds = (p * (dp - delta)).to(torch.bfloat16).float()
    del p, dp
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * D ** -0.5
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qs)
    return (dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_backward_errs(torch, grads, args, tag: str,
                        causal: bool = True) -> float:
    """The bf16 flash backward's (dq, dk, dv) per entry at KERNEL_TOL abs +
    rel: dq against its plain version (ref.attention_backward), dk and dv
    against attention_backward_tc.  Each dk, dv entry sums the G q heads'
    products over every query of its kv head (98304 at G 48, 2048
    queries), so where such a sum cancels to a small entry the bf16
    rounding of p, which the plain f32 version leaves out, is a large
    share of it: at G 48 one dv entry of 1048576 missed the plain version
    by 0.031 (kernel 0.2266, plain 0.1953, with p rounded 0.2268; NVIDIA
    H100 80GB HBM3, 700.00 W).  The plain version's dk, dv errors are
    logged beside.  Returns the largest abs error checked."""
    from repro_torch.kernels import ref

    want = ref.attention_backward(*args, causal=causal, q_offset=0)
    errs = [max_err(torch, grads[0], want[0],
                    f"flash_attention_backward dq {tag}")]
    plain = [(grads[i].float() - want[i].float()).abs().max().item()
             for i in (1, 2)]
    del want
    tc = attention_backward_tc(torch, *args, causal=causal)
    for i, name in ((1, "dk"), (2, "dv")):
        errs.append(max_err(torch, grads[i], tc[i],
                            f"flash_attention_backward {name} {tag} (bf16 "
                            f"tensor-core operands)"))
    log(f"[layout {tag}] flash_attention_backward: max abs err dq "
        f"{errs[0]:.3e} (plain), dk {errs[1]:.3e} dv {errs[2]:.3e} (bf16 "
        f"operands; plain: {plain[0]:.3e}, {plain[1]:.3e})")
    return max(errs)


def check_layout_f32(torch, gen, Hq: int, Hkv: int, D: int, tag: str):
    """Phase 3g in f32 (the FMA kernels): decode, chunk at T 512 and T 8
    and their paged twins at page size 16 at the serving shapes, and the
    flash pair at q [1,Hq,1024,D] causal, against their plain versions at
    F32_KERNEL_TOL: only the order of f32 sums differs."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    B, S, ps = 8, 2048, 16
    k, v, q = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D), rnd(B, Hq, D)
    kv_len = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    perm = (torch.randperm(B * (S // ps), generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(B, S // ps)
    kp, vp = shred(torch, k, ps, perm), shred(torch, v, ps, perm)
    bt = tables(torch, perm, ps, DECODE_LENS)
    errs = [max_err(torch, dec.decode_attention(q, k, v, kv_len=kv_len),
                    ref.decode_attention(q, k, v, kv_len=kv_len),
                    f"decode_attention f32 {tag}", F32_KERNEL_TOL),
            max_err(torch, dec.decode_attention_paged(
                q, kp, vp, block_table=bt, kv_len=kv_len),
                ref.decode_attention_paged(q, kp, vp, block_table=bt,
                                           kv_len=kv_len),
                f"decode_attention_paged f32 {tag}", F32_KERNEL_TOL)]
    for T, pos_l in CHUNK_CASES:
        qc = rnd(B, Hq, T, D)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        btc = tables(torch, perm, ps, [p + T for p in pos_l])
        errs.append(max_err(torch, dec.chunk_attention(qc, k, v, pos=pos),
                            ref.chunk_attention(qc, k, v, pos=pos),
                            f"chunk_attention f32 {tag} T={T}",
                            F32_KERNEL_TOL))
        errs.append(max_err(torch, dec.chunk_attention_paged(
            qc, kp, vp, block_table=btc, pos=pos), ref.chunk_attention_paged(
            qc, kp, vp, block_table=btc, pos=pos),
            f"chunk_attention_paged f32 {tag} T={T}", F32_KERNEL_TOL))
    del k, v, q, kp, vp
    Sf = 1024
    q, k, v, do = rnd(1, Hq, Sf, D), rnd(1, Hkv, Sf, D), rnd(1, Hkv, Sf, D), \
        rnd(1, Hq, Sf, D)
    o, lse, _ = fa.flash_attention(q, k, v)
    o_r, lse_r = ref.attention(q, k, v, q_offset=0, return_lse=True)
    errs.append(max_err(torch, o, o_r, f"flash_attention f32 {tag}",
                        F32_KERNEL_TOL))
    for n, g, w in zip(("dq", "dk", "dv"),
                       fa.flash_attention_backward(q, k, v, o_r, lse_r, do),
                       ref.attention_backward(q, k, v, o_r, lse_r, do,
                                              q_offset=0)):
        errs.append(max_err(torch, g, w, f"flash_attention_backward f32 {n} "
                            f"{tag}", F32_KERNEL_TOL))
    log(f"[layout {tag}] f32 kernels vs plain (tolerance {F32_KERNEL_TOL}): "
        f"decode, paged decode (page size {ps}), chunk and paged chunk at "
        f"T 512 and 8, flash forward and dq/dk/dv at q 1x{Hq}x{Sf}x{D}: "
        f"max abs err {[f'{e:.2e}' for e in errs]}")
    del q, k, v, do, o, lse, o_r, lse_r
    torch.cuda.empty_cache()


def check_dense_kernels(torch, entries, build_logs):
    """Phase 3g: the attention kernels at the dense family's new head
    layouts (check_layout, each of DENSE_LAYOUTS), and rmsnorm
    and its backward at the new row widths (check_width, each of
    DENSE_WIDTHS); and ptxas's registers and spills of the instantiations
    these shapes launch (G and the row width are runtime arguments: no
    new instantiation is compiled for them).  Adds the DENSE_LAYOUTS and
    DENSE_WIDTHS sub-entries to `entries`."""
    t_phase = time.monotonic()
    for i, (key, (Hq, Hkv, D)) in enumerate(DENSE_LAYOUTS.items()):
        check_layout(torch, entries, key, Hq, Hkv, D, seed=20 + i)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for key, (d, arch) in DENSE_WIDTHS.items():
        check_width(torch, entries, key, d, arch, gen, flush)
    del flush
    torch.cuda.empty_cache()
    wanted = {"rmsnorm": ("rmsnorm_kernel", "rmsnorm_bwd"),
              "decode_attention": ("<128", "<64", "128>", "64>"),
              "flash_attention": ("<128", "<64", "128>", "64>")}
    for lib, keys in wanted.items():
        for kernel, regs, spills in ptxas_report(build_logs(lib)):
            if any(s in kernel for s in keys):
                log(f"[dense-kernels] ptxas {lib}: {kernel}: {regs} "
                    f"registers, {spills} bytes spill stores (compiled "
                    f"for every layout: G and the width are runtime "
                    f"arguments)")
    log(f"[dense-kernels] phase 3g: {time.monotonic() - t_phase:.1f}s")


def check_width(torch, entries, key: str, d: int, arch: str, gen, flush):
    """Phases 3g and 3h: rmsnorm at `arch`'s row width d, the forward at a
    decode tick's rows (8 x 1) and a prefill group's (8 x 512), the
    backward at the training rows (4 x 2048), in bf16 (timed beside the
    plain version, the bound and F.rms_norm) and f32 against their plain
    versions; adds the `key` sub-entries to rmsnorm's and
    rmsnorm_backward's entries of `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    dev = torch.device("cuda")
    by_name = {e["name"]: e for e in entries}
    src = "src/repro_torch/kernels/csrc/rmsnorm.cu"
    w32 = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = F32_KERNEL_TOL if dtype == torch.float32 else KERNEL_TOL
        w = w32.to(dtype)
        for shape in ((8, 1, d), (8, 512, d)):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            err = max_err(torch, rms.rmsnorm(x, w), ref.rmsnorm(x, w),
                          f"rmsnorm {shape} {dtype}", tol)
            if dtype == torch.bfloat16:
                timed[shape] = record_kernel(
                    torch, flush, "rmsnorm", src,
                    "src/repro/kernels/rmsnorm.py:38",
                    "x".join(map(str, shape)), err,
                    lambda x=x, w=w: rms.rmsnorm(x, w),
                    lambda x=x, w=w: ref.rmsnorm(x, w),
                    lambda x=x, w=w: F.rms_norm(x, (d,), w, 1e-5),
                    nbytes=2.0 * x.numel() * 2 + d * 2,
                    ops=4.0 * x.numel())
        x = torch.randn((4, 2048, d), generator=gen, device=dev).to(dtype)
        dy = torch.randn((4, 2048, d), generator=gen,
                         device=dev).to(dtype)
        dx, dw = rms.rmsnorm_backward(x, w, dy)
        dx_r, dw_r = ref.rmsnorm_backward(x, w, dy)
        err = max_err(torch, dx, dx_r,
                      f"rmsnorm_backward dx 4x2048x{d} {dtype}", tol)
        scale = dw_r.float().abs().max()
        err = max(err, max_err(
            torch, dw.float() / scale, dw_r.float() / scale,
            f"rmsnorm_backward dw 4x2048x{d} {dtype} (relative to max "
            f"|dw|)", tol))
        again = rms.rmsnorm_backward(x, w, dy)
        torch.cuda.synchronize()
        if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
            fail(f"rmsnorm_backward 4x2048x{d} {dtype}: two launches "
                 f"differ")
        if dtype == torch.bfloat16:
            xx, ww = x.detach().requires_grad_(), \
                w.detach().requires_grad_()
            y = F.rms_norm(xx, (d,), ww, 1e-5)
            bwd = record_kernel(
                torch, flush, "rmsnorm_backward", src,
                "src/repro/kernels/rmsnorm.py:38 (backward)",
                f"x 4x2048x{d}", err,
                lambda: rms.rmsnorm_backward(x, w, dy),
                lambda: ref.rmsnorm_backward(x, w, dy),
                lambda: torch.autograd.grad(y, (xx, ww), dy,
                                            retain_graph=True),
                nbytes=2.0 * (3 * x.numel() + 2 * d),
                ops=10.0 * x.numel())
            del xx, ww, y
        del x, dy, dx, dw, dx_r, dw_r, again
    e = by_name["rmsnorm"]
    e[key] = sub_entry(timed[(8, 512, d)])
    e[key]["decode_tick"] = sub_entry(timed[(8, 1, d)])
    e["max_abs_err"] = max(e["max_abs_err"], e[key]["max_abs_err"])
    by_name["rmsnorm_backward"][key] = sub_entry(bwd)
    log(f"[width-{d}] rmsnorm at {arch}'s width {d}: plan (vectors a "
        f"thread, threads a row, rows a block) "
        f"{rms.forward_plan(d, 2)}; decode tick 8x1x{d} "
        f"{timed[(8, 1, d)]['ms']:.4f} ms, prefill group 8x512x{d} "
        f"{timed[(8, 512, d)]['ms']:.4f} ms, backward 4x2048x{d} "
        f"{bwd['ms']:.4f} ms")
    torch.cuda.empty_cache()


# ----------------------------------------------------------- mla kernels ----
#: deepseek-v2-lite's served latent attention: 16 q heads over one latent kv
#: head whose K rows are [ckv | krope] (512 + 64 columns) and V rows ckv, at
#: sm_scale (dn + dr) ** -0.5, not D ** -0.5
MLA_HEADS = (16, 512, 64)               # Hq, r, dr
MLA_SCALE = (128 + 64) ** -0.5
# f32 kernels vs their plain versions: they differ by the order of f32
# sums only -> 2e-5 abs + rel, as tests/test_torch_cuda.py
F32_KERNEL_TOL = 2e-5
MLA_SRC = "src/repro_torch/kernels/csrc/mla_attention.cu"


def shred_latent(torch, x, ps, perm):
    """A latent cache x [B, S, W] as a page arena [1 + B*S/ps, ps, W]: row
    b's virtual page j is arena page perm[b, j]; page 0 is scratch, large
    finite garbage."""
    B, S, W = x.shape
    arena = torch.full((1 + B * (S // ps), ps, W), 1e4, dtype=x.dtype,
                       device=x.device)
    arena[perm.reshape(-1).long()] = x.reshape(-1, ps, W)
    return arena


def latent_work(lens_seen, rows, B: int, Hq: int, T: int, page: int = 0):
    """Bytes and FLOPs of latent attention (bf16) in both forms.  In place:
    q read (576 columns) and o written (512), the lengths, each visible
    latent row once (1152 bytes; and its table slots when paged); Q K^T at
    576 and P V at 512 over the visible pairs.  The k/v form PR 23 ran: o
    at 576, a 1152-byte K row and a 1152-byte V row, both products at 576.
    `lens_seen`: visible (query, column) pairs per q head; `rows`: each
    row's visible cache rows."""
    r, dr = MLA_HEADS[1:]
    D = r + dr
    tables = 4 * sum(-(-n // page) for n in rows) if page else 0
    inplace = {"nbytes": 2.0 * B * Hq * T * (D + r) + 4 * B
               + sum(rows) * D * 2 + tables,
               "ops": 2.0 * Hq * lens_seen * (D + r)}
    kv = {"nbytes": 2.0 * 2 * B * Hq * T * D + 4 * B + sum(rows) * D * 2 * 2
          + tables, "ops": 4.0 * Hq * lens_seen * D}
    return inplace, kv


def sdpa_backend(torch, fn) -> str:
    """Which SDPA backend runs `fn`, by the kernels one call launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in p.key_averages() if _dev_us(e) > 0]
    if not names:
        return "not named: the profiler saw no device time"
    low = " ".join(names).lower()
    kind = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
            else "memory-efficient" if "fmha" in low or "efficient" in low
            else "math (matmuls and a softmax)")
    return f"{kind}: {'; '.join(n[:50] for n in names[:4])}"


def check_mla_kernels(torch, entries):
    """Phase 3e: the four latent attention kernels at deepseek's shapes (16
    q heads over one latent kv head read in place: ckv [8, 2048, 512],
    krope [8, 2048, 64]; sm_scale 192 ** -0.5), in f32 and bf16: decode at
    kv_len 0, 1, ragged and 2048 (with its residuals), chunk at T 512 and
    T 8 at per-row offsets, their paged twins over two arenas through one
    block table at page sizes 64 (TMA) and 16 (the gather; decode also 5),
    each against its plain version (the reference's k/v route); paged
    equal to dense and a row alone equal to its batch row (torch.equal).
    The bf16 kernels are timed beside their plain versions, both bounds
    (in place and the k/v form) and SDPA on the k/v form built before the
    timed call (its backend named).  Adds a head_dim_576 entry (T 8 as its
    short_chunk) to each kernel's entry of `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import mla_attention as mla
    from repro_torch.kernels import ref

    for kernel, regs, spills, smem in ptxas_report(
            build.build_log("mla_attention"), with_smem=True):
        log(f"[mla-kernels] ptxas: {kernel}: {regs} registers, {spills} bytes "
            f"spill stores, {smem} bytes static shared memory")
    log(f"[mla-kernels] the bf16 kernel asks for {mla.SMEM_BYTES} bytes of "
        f"dynamic shared memory a block")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)
    Hq, r, dr = MLA_HEADS
    D = r + dr
    B, S = 8, 2048
    kw = dict(sm_scale=MLA_SCALE)
    lens = [0, 1, 77, 1000, 1537, 2047, 2048, 513]
    chunks = ((512, [0, 512, 1024, 1536, 100, 700, 1300, 7]),
              (8, [0, 5, 100, 1000, 2040, 333, 1500, 17]))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    names = ("decode_attention", "decode_attention_paged", "chunk_attention",
             "chunk_attention_paged")
    for dtype, tol in ((torch.float32, F32_KERNEL_TOL),
                       (torch.bfloat16, KERNEL_TOL)):
        errs = {n: [] for n in names}       # the bf16 errors go on the line
        tag = f"D=576 G=16 {str(dtype)[6:]}"
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        ckv, krope = rnd(B, S, r), rnd(B, S, dr)
        q = rnd(B, Hq, D)
        o, (m, l) = mla.decode_attention_latent(q, ckv, krope, kv_len=kv_len,
                                                return_residuals=True, **kw)
        o_r, (m_r, l_r) = ref.decode_attention_latent(
            q, ckv, krope, kv_len=kv_len, return_residuals=True, **kw)
        errs["decode_attention"].append(
            max_err(torch, o, o_r, f"decode_attention_latent {tag}", tol))
        if not bool((o[0] == 0).all()):
            fail(f"decode_attention_latent {tag}: the kv_len == 0 row is not "
                 f"zeros")
        max_err(torch, m, m_r, f"decode_attention_latent m {tag}", tol)
        if not torch.allclose(l, l_r, rtol=1e-3, atol=1e-3):
            fail(f"decode_attention_latent {tag}: residual l disagrees with "
                 f"the plain version")
        arenas = {}
        for ps in (PAGE, 16):
            nb = S // ps
            perm = (torch.randperm(B * nb, generator=gen, device=dev) + 1) \
                .to(torch.int32).reshape(B, nb)
            cp = shred_latent(torch, ckv, ps, perm)
            rp = shred_latent(torch, krope, ps, perm)
            arenas[ps] = (cp, rp, perm)
            bt = tables(torch, perm, ps, lens)
            errs["decode_attention_paged"].append(max_err(
                torch, mla.decode_attention_latent_paged(
                    q, cp, rp, block_table=bt, kv_len=kv_len, **kw),
                ref.decode_attention_latent_paged(q, cp, rp, block_table=bt,
                                                  kv_len=kv_len, **kw),
                f"decode_attention_latent_paged {tag} page_size {ps}", tol))
        cases = []
        for T, pos_l in chunks:
            qc = rnd(B, Hq, T, D)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            dense = mla.chunk_attention_latent(qc, ckv, krope, pos=pos, **kw)
            errs["chunk_attention"].append(max_err(
                torch, dense, ref.chunk_attention_latent(qc, ckv, krope,
                                                         pos=pos, **kw),
                f"chunk_attention_latent {tag} T={T}", tol))
            for ps, (cp, rp, perm) in arenas.items():
                btc = tables(torch, perm, ps, [p + T for p in pos_l])
                what = (f"chunk_attention_latent_paged {tag} T={T} "
                        f"page_size {ps}")
                o = mla.chunk_attention_latent_paged(
                    qc, cp, rp, block_table=btc, pos=pos, **kw)
                errs["chunk_attention_paged"].append(max_err(
                    torch, o, ref.chunk_attention_latent_paged(
                        qc, cp, rp, block_table=btc, pos=pos, **kw), what,
                    tol))
                if not torch.equal(o, dense):
                    fail(f"{what}: the paged output differs from the dense "
                         f"kernel's on the same cache")
            cases.append((T, pos_l, qc, pos))
        check_latent_identities(torch, q, ckv, krope, kv_len, arenas, lens,
                                cases)
        log(f"[mla-kernels] {tag}: max abs err "
            + ", ".join(f"{n} {max(e):.3e}" for n, e in errs.items())
            + f" (tolerance {tol} abs + rel)")
        del o, o_r, m, m_r, l, l_r, dense
        if dtype == torch.float32:
            del ckv, krope, q, arenas, cases
            torch.cuda.empty_cache()

    # bf16 times, beside the plain versions, both bounds and SDPA on the
    # k/v form (built here, outside the timed call)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    k_full = torch.cat([ckv, krope], dim=-1)[:, None]
    v_lat = F.pad(ckv, (0, dr))[:, None]
    sdpa = lambda qq, **a: F.scaled_dot_product_attention(
        qq, k_full, v_lat, scale=MLA_SCALE, enable_gqa=True, **a)
    dmask = (torch.arange(S, device=dev)[None, :]
             < kv_len[:, None])[:, None, None, :]
    log(f"[mla-kernels] SDPA on the k/v form: decode ran "
        f"{sdpa_backend(torch, lambda: sdpa(q[:, :, None], attn_mask=dmask))}")
    cp, rp, perm = arenas[PAGE]
    nb = S // PAGE
    dbt = tables(torch, perm, PAGE, lens)
    dec_in, dec_kv = latent_work(sum(lens), lens, B, Hq, 1)
    dec_pin, dec_pkv = latent_work(sum(lens), lens, B, Hq, 1, page=PAGE)
    timed = {
        "decode_attention": [(
            f"q {B}x{Hq}x{D} ckv {B}x{S}x{r} krope {B}x{S}x{dr} kv_len "
            f"{lens}",
            lambda: mla.decode_attention_latent(q, ckv, krope, kv_len=kv_len,
                                                **kw),
            lambda: ref.decode_attention_latent(q, ckv, krope, kv_len=kv_len,
                                                **kw),
            lambda: sdpa(q[:, :, None], attn_mask=dmask), dec_in, dec_kv, {})],
        "decode_attention_paged": [(
            f"q {B}x{Hq}x{D} pages {cp.shape[0]}x{PAGE}x{r} + "
            f"{rp.shape[0]}x{PAGE}x{dr} bt {B}x{nb} kv_len {lens}",
            lambda: mla.decode_attention_latent_paged(
                q, cp, rp, block_table=dbt, kv_len=kv_len, **kw),
            lambda: ref.decode_attention_latent_paged(
                q, cp, rp, block_table=dbt, kv_len=kv_len, **kw),
            None, dec_pin, dec_pkv,
            dict(dense=lambda: mla.decode_attention_latent(
                q, ckv, krope, kv_len=kv_len, **kw)))],
        "chunk_attention": [], "chunk_attention_paged": []}
    for T, pos_l, qc, pos in cases:
        bt = tables(torch, perm, PAGE, [p + T for p in pos_l])
        lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
        cmask = (torch.arange(S, device=dev)[None, None, :]
                 <= lim[:, :, None])[:, None]
        seen = sum(min(p + t + 1, S) for p in pos_l for t in range(T))
        rows = [min(p + T, S) for p in pos_l]
        c_in, c_kv = latent_work(seen, rows, B, Hq, T)
        p_in, p_kv = latent_work(seen, rows, B, Hq, T, page=PAGE)
        timed["chunk_attention"].append((
            f"q {B}x{Hq}x{T}x{D} ckv {B}x{S}x{r} krope {B}x{S}x{dr} pos "
            f"{pos_l}",
            lambda qc=qc, pos=pos: mla.chunk_attention_latent(
                qc, ckv, krope, pos=pos, **kw),
            lambda qc=qc, pos=pos: ref.chunk_attention_latent(
                qc, ckv, krope, pos=pos, **kw),
            lambda qc=qc, cmask=cmask: sdpa(qc, attn_mask=cmask), c_in, c_kv,
            {}))
        timed["chunk_attention_paged"].append((
            f"q {B}x{Hq}x{T}x{D} pages {cp.shape[0]}x{PAGE}x{r} + "
            f"{rp.shape[0]}x{PAGE}x{dr} bt {B}x{nb} pos {pos_l}",
            lambda qc=qc, pos=pos, bt=bt: mla.chunk_attention_latent_paged(
                qc, cp, rp, block_table=bt, pos=pos, **kw),
            lambda qc=qc, pos=pos, bt=bt: ref.chunk_attention_latent_paged(
                qc, cp, rp, block_table=bt, pos=pos, **kw),
            None, p_in, p_kv,
            dict(dense=lambda qc=qc, pos=pos: mla.chunk_attention_latent(
                qc, ckv, krope, pos=pos, **kw))))
    log(f"[mla-kernels] SDPA on the k/v form: chunk T={cases[0][0]} ran "
        f"{sdpa_backend(torch, timed['chunk_attention'][0][3])}")
    for e in entries:
        for i, (shape, fn, plain, lib, work, kv, extra) in enumerate(
                timed.get(e["name"], ())):
            err = max(errs[e["name"]])
            full = record_kernel(torch, flush, e["name"], MLA_SRC,
                                 e["replaces"], shape, err, fn, plain, lib,
                                 **work, **extra)
            sub = sub_entry(full)
            sub["source"] = MLA_SRC
            sub["bound_kv_ms"], sub["bound_kv_by"] = bound(
                kv["nbytes"], kv["ops"], "bfloat16")
            log(f"[mla-kernels] {e['name']} {shape}: bound in place "
                f"{sub['bound_ms']:.4f} ms ({sub['bound_by']}), in the k/v "
                f"form {sub['bound_kv_ms']:.4f} ms ({sub['bound_kv_by']})")
            if i == 0:
                e["head_dim_576"] = sub
            else:
                e["head_dim_576"]["short_chunk"] = sub
            e["max_abs_err"] = max(e["max_abs_err"], err)
    log(f"[mla-kernels] decode: S cut into "
        f"{mla.plan(B, Hq, 1, S, decode=True)[1:3]} (ranges, rows); chunk at "
        f"T 8: {mla.plan(B, Hq, 8, S, decode=False)[1:3]}, at T 512: "
        f"{mla.plan(B, Hq, 512, S, decode=False)[1:3]}")
    del ckv, krope, q, cp, rp, arenas, cases, timed, flush, k_full, v_lat
    torch.cuda.empty_cache()


def check_latent_identities(torch, q, ckv, krope, kv_len, arenas, lens,
                            cases):
    """The latent kernels' identities: paged decode equals dense decode on
    the same cache (torch.equal) at page sizes 64 (TMA), 16 and 5 (the
    cp.async gather; 5 over the cache padded to 2050 rows); a row decoded
    alone equals the same row in the batch of 8, dense and paged; and a
    chunk row alone equals its batch row, dense and paged, at T 8 (split
    columns) and 512."""
    from repro_torch.kernels import mla_attention as mla

    dev = q.device
    B, S, r = ckv.shape
    kw = dict(sm_scale=MLA_SCALE)
    dense = mla.decode_attention_latent(q, ckv, krope, kv_len=kv_len, **kw)
    runs = [(ps, cp, rp, tables(torch, perm, ps, lens), dense)
            for ps, (cp, rp, perm) in arenas.items()]
    pad = lambda t: torch.cat([t, t.new_zeros(B, 2, t.shape[-1])], dim=1)
    c5, r5 = pad(ckv), pad(krope)
    gen = torch.Generator(device=dev).manual_seed(5)
    perm5 = (torch.randperm(B * 410, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(B, 410)
    runs.append((5, shred_latent(torch, c5, 5, perm5),
                 shred_latent(torch, r5, 5, perm5),
                 tables(torch, perm5, 5, lens),
                 mla.decode_attention_latent(q, c5, r5, kv_len=kv_len, **kw)))
    for ps, cp, rp, bt, want in runs:
        o = mla.decode_attention_latent_paged(q, cp, rp, block_table=bt,
                                              kv_len=kv_len, **kw)
        torch.cuda.synchronize()
        if not torch.equal(o, want):
            fail(f"decode_attention_latent_paged page_size {ps}: the output "
                 f"differs from the dense kernel's on the same cache")
        for i in (3, 5, 7):
            one = slice(i, i + 1)
            alone = mla.decode_attention_latent_paged(
                q[one], cp, rp, block_table=bt[one].contiguous(),
                kv_len=kv_len[one], **kw)
            torch.cuda.synchronize()
            if not torch.equal(alone, o[one]):
                fail(f"decode_attention_latent_paged page_size {ps}: row {i} "
                     f"alone differs from row {i} in the batch")
    for i in (3, 5, 7):
        one = slice(i, i + 1)
        alone = mla.decode_attention_latent(q[one], ckv[one], krope[one],
                                            kv_len=kv_len[one], **kw)
        torch.cuda.synchronize()
        if not torch.equal(alone, dense[one]):
            fail(f"decode_attention_latent: row {i} alone differs from row "
                 f"{i} in the batch")
    for T, pos_l, qc, pos in cases:
        chunk_runs = [("dense", lambda q_, p_, rows:
                       mla.chunk_attention_latent(q_, ckv[rows], krope[rows],
                                                  pos=p_, **kw))]
        for ps, (cp, rp, perm) in arenas.items():
            bt = tables(torch, perm, ps, [p + T for p in pos_l])
            chunk_runs.append((
                f"paged page_size {ps}",
                lambda q_, p_, rows, cp=cp, rp=rp, bt=bt:
                mla.chunk_attention_latent_paged(
                    q_, cp, rp, block_table=bt[rows].contiguous(), pos=p_,
                    **kw)))
        for what, run in chunk_runs:
            batch = run(qc, pos, slice(None))
            for i in (3, 4, 6):
                one = slice(i, i + 1)
                alone = run(qc[one].contiguous(), pos[one], one)
                torch.cuda.synchronize()
                if not torch.equal(alone, batch[one]):
                    fail(f"chunk_attention_latent {what} T={T}: row {i} "
                         f"alone differs from row {i} in the batch")
    log(f"[mla-kernels] decode: paged equals dense at page sizes "
        f"{sorted(run[0] for run in runs)}; rows 3, 5, 7 alone equal "
        f"themselves in the batch of {B}, dense and paged; chunk rows 3, 4, "
        f"6 alone equal themselves at T {[c[0] for c in cases]}, dense and "
        f"paged at page sizes {sorted(arenas)}")


# ----------------------------------------------------- mla train kernels ----
#: deepseek-v2-lite's training attention (the expanded branch): 16 heads,
#: q/k head dim dn + dr = 192, v at its own width dv = 128, G 1, causal,
#: sm_scale 192 ** -0.5, at batch 4 x 2048
MLA_TRAIN_ATTN = (4, 16, 2048, 192, 128)   # B, H, S, Dqk, Dv


def check_mla_train_kernels(torch, entries):
    """Phase 3f: the flash pair at MLA training's head dims (q/k 192, v
    128: q/k [4,16,2048,192], v [4,16,2048,128], causal, sm_scale 192 **
    -0.5) in bf16 and f32, also at Sq 1024 against Sk 2048 and at a ragged
    S 1000, against the plain versions (2e-2 abs + rel in bf16, 2e-5 in
    f32), two backward launches bitwise equal; ptxas's registers and
    spills of the (192, 128) kernels; the bf16 pair timed beside its plain
    version, its bound (the useful FLOPs: v's 128 columns) and SDPA on the
    padded form (v zero-padded to 192, built outside the timed call), its
    backend named.  Adds a head_dim_192 entry to the flash entries of
    `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t0 = time.monotonic()
    for name, regs, spills in ptxas_report(build.build_log("flash_attention")):
        if "192" in name:
            log(f"[mla-train-kernels] ptxas {name}: {regs} registers, "
                f"{spills} bytes spill stores")
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(13)
    rnd = lambda dt, *s: torch.randn(s, generator=gen, device=dev).to(dt)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    B, H, S, Dqk, Dv = MLA_TRAIN_ATTN
    opts = dict(causal=True, sm_scale=MLA_SCALE)
    errs = {"fwd": [], "train": [], "bwd": []}
    for what, dtype, b, sq, sk in (
            ("training bf16", bf16, B, S, S), ("training f32", f32, B, S, S),
            ("Sq 1024 Sk 2048 bf16", bf16, 2, 1024, S),
            ("Sq 1024 Sk 2048 f32", f32, 2, 1024, S),
            ("ragged S 1000 bf16", bf16, 2, 1000, 1000),
            ("ragged S 1000 f32", f32, 2, 1000, 1000)):
        tol = KERNEL_TOL if dtype == bf16 else F32_KERNEL_TOL
        tag = f"D 192/128 {what}"
        q, k = rnd(dtype, b, H, sq, Dqk), rnd(dtype, b, H, sk, Dqk)
        v, do = rnd(dtype, b, H, sk, Dv), rnd(dtype, b, H, sq, Dv)
        off = dict(q_offset=sk - sq)
        o, lse, _ = fa.flash_attention(q, k, v, **opts)
        o_r, lse_r = ref.attention(q, k, v, return_lse=True, **opts, **off)
        errs["fwd"].append(max_err(torch, o, o_r, f"flash_attention {tag}",
                                   tol))
        max_err(torch, lse, lse_r, f"flash_attention lse {tag}", tol)
        o32, terr = training_forward(torch, q, k, v, o, lse,
                                     f"flash_attention {tag}", tol, **opts)
        errs["train"].append(terr)
        o_r = o_r.float()
        grads = fa.flash_attention_backward(q, k, v, o_r, lse_r, do, **opts)
        want = ref.attention_backward(q, k, v, o_r, lse_r, do, **opts, **off)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            errs["bwd"].append(max_err(
                torch, g, w, f"flash_attention_backward {name} {tag}", tol))
        again = fa.flash_attention_backward(q, k, v, o_r, lse_r, do, **opts)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            fail(f"flash_attention_backward {tag}: two launches differ")
        if what == "training bf16":
            timed = (q, k, v, do, o, lse, o32)
        del q, k, v, do, o, lse, o32, o_r, lse_r, grads, want, again
        torch.cuda.empty_cache()
    log(f"[mla-train-kernels] flash D 192/128 max_abs_err (bf16 2e-2, f32 "
        f"2e-5 abs + rel): forward {[f'{e:.3e}' for e in errs['fwd']]}, "
        f"training's forward (o32) {[f'{e:.3e}' for e in errs['train']]}, "
        f"backward (dq, dk, dv per case) "
        f"{[f'{e:.3e}' for e in errs['bwd']]}; two backward launches "
        f"bitwise equal in every case")
    q, k, v, do, o, lse, o32 = timed
    shape = (f"q/k {B}x{H}x{S}x{Dqk} v {B}x{H}x{S}x{Dv} causal, sm_scale "
             f"192^-0.5")
    fwd_ops, bwd_ops, io = flash_work(q, k, v)
    # SDPA on the reference's padded form, built outside the timed calls
    vp, dop = F.pad(v, (0, Dqk - Dv)), F.pad(do, (0, Dqk - Dv))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, vp, is_causal=True,
                                                  scale=MLA_SCALE)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, vp))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                         scale=MLA_SCALE)
    log(f"[mla-train-kernels] SDPA on the padded form (v at 192) runs "
        f"{sdpa_backend(torch, sdpa)}")
    cases = {
        "flash_attention": (
            max(errs["fwd"]), lambda: fa.flash_attention(q, k, v, **opts),
            lambda: ref.attention(q, k, v, return_lse=True, **opts), sdpa,
            dict(nbytes=io + 2.0 * o.numel() + 4.0 * lse.numel(),
                 ops=fwd_ops)),
        "flash_attention_backward": (
            max(errs["bwd"]),
            lambda: fa.flash_attention_backward(q, k, v, o32, lse, do,
                                                **opts),
            lambda: ref.attention_backward(q, k, v, o32, lse, do, **opts),
            lambda: torch.autograd.grad(out, (qq, kk, vv), dop,
                                        retain_graph=True),
            dict(nbytes=2 * io + 6.0 * o.numel() + 4.0 * lse.numel(),
                 ops=bwd_ops))}
    for e in entries:
        if e["name"] in cases:
            err, fn, plain, lib, work = cases[e["name"]]
            d192 = record_kernel(torch, flush, e["name"], e["source"],
                                 e["replaces"], shape, err, fn, plain, lib,
                                 **work)
            e["head_dim_192"] = sub_entry(d192)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"[mla-train-kernels] {e['name']} {shape}: "
                f"{work['ops'] / d192['ms'] / 1e9:.1f} TFLOP/s, "
                f"{100 * d192['bound_ms'] / d192['ms']:.1f}% of its bound, "
                f"{d192['ms'] / d192['library_ms']:.2f}x SDPA")
            if e["name"] == "flash_attention":
                e["head_dim_192"]["training"] = train = \
                    record_training_forward(torch, flush, e, shape,
                                            max(errs["train"]), q, k, v, o,
                                            lse, sdpa, **opts)
                e["max_abs_err"] = max(e["max_abs_err"], max(errs["train"]))
                log(f"[mla-train-kernels] flash_attention training {shape}: "
                    f"{100 * train['bound_ms'] / train['ms']:.1f}% of its "
                    f"bound, {train['ms'] / d192['ms']:.2f}x inference's "
                    f"forward")
    del q, k, v, do, o, lse, o32, vp, dop, qq, kk, vv, out, timed, cases, \
        flush
    torch.cuda.empty_cache()
    log(f"[mla-train-kernels] phase 3f: {time.monotonic() - t0:.1f}s")


# ---------------------------------------------------------------- hybrid ----
def hybrid_forward(torch):
    """Phase 8a: full-width zamba2_2_7b logits, kernels vs plain versions
    in bf16 (each held against the f32 plain model) and in f32, and the
    prompt fed as 4 x 128-token chunks against the whole prompt (f32)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg16 = get_config("zamba2_2_7b")
    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, T = 4, 512
    tokens = torch.randint(0, cfg16.vocab, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    nxt = torch.randint(0, cfg16.vocab, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    at = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def run(cfg, impl, params):
        """(prefill logits, decode-step logits) of `impl` on `params`."""
        m = build_model(cfg, impl=impl, device="cuda")
        cache = m.init_cache(B, 2048)
        lp, cache, _ = m.forward_chunk(params, tokens, None, cache, zero)
        ld, _, _ = m.decode_step(params, nxt, None, cache, at)
        torch.cuda.synchronize()
        return lp.float(), ld.float()

    t0 = time.monotonic()
    params = build_model(cfg16, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[hybrid] {cfg16.name}: {cfg16.n_layers} Mamba2 layers + a shared "
        f"attention block every {cfg16.attn_every}, d_model {cfg16.d_model}"
        f", d_inner {cfg16.d_inner_}, {cfg16.n_ssm_heads} SSM heads of "
        f"{cfg16.ssm_head_dim}, state {cfg16.ssm_state}, "
        f"{n_params / 1e9:.3f}B params ({cfg16.param_dtype}; a_log, "
        f"dt_bias, d_skip in "
        f"{params['stack']['stack']['ssm']['a_log'].dtype}) initialised in "
        f"{time.monotonic() - t0:.1f}s")
    k16 = run(cfg16, "kernel", params)
    r16 = run(cfg16, "ref", params)
    del params
    torch.cuda.empty_cache()
    # the same seeded draws in f32 (the bf16 params are their roundings)
    p32 = build_model(cfg32, device="cuda").init(0)
    k32 = run(cfg32, "kernel", p32)
    r32 = run(cfg32, "ref", p32)
    check_precisions(torch, "hybrid", (B, cfg16.vocab), k16, r16, k32, r32)
    # the same prompt as 4 x 128-token chunks: the carried state resumes
    m = build_model(cfg32, impl="kernel", device="cuda")
    cc, whole = m.init_cache(B, 2048), m.init_cache(B, 2048)
    for i in range(4):
        lc, cc, _ = m.forward_chunk(p32, tokens[:, 128 * i:128 * (i + 1)],
                                    None, cc, zero + 128 * i)
    lw, whole, _ = m.forward_chunk(p32, tokens, None, whole, zero)
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    errs = {"logits": rel(lc.float(), lw.float())}
    for name in ("h", "conv"):
        errs[name] = rel(cc["ssm"][name].float(), whole["ssm"][name].float())
    log(f"[hybrid] 4 x 128-token chunks vs the whole prompt (f32, kernels): "
        f"relative L2 {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
        f" (tolerance {HYBRID_F32_TOL})")
    if not all(math.isfinite(v) and v <= HYBRID_F32_TOL
               for v in errs.values()):
        fail(f"hybrid: the chunked prompt's logits or SSM state differ from "
             f"the whole prompt's: {errs}")
    del p32, cc, whole
    torch.cuda.empty_cache()


def check_precisions(torch, tag: str, shape, k16, r16, k32, r32,
                     whats=("prefill chunk T=512", "decode step")):
    """Kernels (k) vs plain (r) logits of one model in bf16 and f32, each
    a tuple of logits of `shape`, one for each step of `whats`: finite; in
    f32 held to each other within HYBRID_F32_TOL relative L2; in bf16 the
    kernels no further from the f32 plain model than the plain bf16 model
    is, within HYBRID_BF16_RATIO."""
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    for i, what in enumerate(whats):
        for name, got in (("kernels bf16", k16[i]), ("plain bf16", r16[i]),
                          ("kernels f32", k32[i]), ("plain f32", r32[i])):
            if tuple(got.shape) != shape or not torch.isfinite(got).all():
                fail(f"{tag} {what}: {name} logits are not finite {shape}")
        e32 = rel(k32[i], r32[i])
        ek, er = rel(k16[i], r32[i]), rel(r16[i], r32[i])
        log(f"[{tag}] {what}: relative L2, kernels vs plain: f32 "
            f"{e32:.3e} (tolerance {HYBRID_F32_TOL}), bf16 "
            f"{rel(k16[i], r16[i]):.3e}; against the f32 plain model: "
            f"kernels bf16 {ek:.3e}, plain bf16 {er:.3e} (ratio "
            f"{ek / er:.3f}, limit {HYBRID_BF16_RATIO})")
        if e32 > HYBRID_F32_TOL or ek > HYBRID_BF16_RATIO * er:
            fail(f"{tag} {what}: kernels and plain versions disagree (f32 "
                 f"{e32:.3e}; bf16 {ek:.3e} against {er:.3e} from the f32 "
                 f"model)")


def hybrid_phase(torch):
    """Phase 8: the hybrid family's serving path.  Returns (launch counts
    of the contiguous serve run, its latency stats)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import run_workload

    hybrid_forward(torch)
    arch = "zamba2_2_7b"
    engine, done, counts, stats, _ = serve_run(torch, "hybrid-serve",
                                               arch=arch)
    for name in ("ssd_scan", "rmsnorm", "chunk_attention",
                 "decode_attention"):
        if counts[name] <= 0:
            fail(f"hybrid-serve: kernel {name} was not launched: {counts}")
    outputs = streams(done)
    del engine
    torch.cuda.empty_cache()
    # max_cache_pages set: the hybrid has no paged entry points, so the
    # engine keeps the contiguous cache and the schedule, and the tokens
    engine, done, counts_p, _, _ = serve_run(
        torch, "hybrid-pages-requested", arch=arch, page_size=PAGE,
        max_cache_pages=257)
    if engine.paged or streams(done) != outputs:
        fail(f"hybrid: with max_cache_pages the engine paged "
             f"({engine.paged}) or its tokens differ from the contiguous run")
    log(f"[hybrid-pages-requested] engine.paged {engine.paged}; 16 of 16 "
        f"token streams equal the contiguous run")
    del engine
    torch.cuda.empty_cache()
    with keep_dir("hybrid-profile-window") as prof:
        _, engine, prompts = make_engine(torch, prof, arch)
        engine.warm_chunk_programs()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.monotonic()
            run_workload(engine, prompts[:8], 16, mode="closed")
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    breakdown(p, wall_us, "hybrid-profile", "8 requests x 16 tokens")
    del engine
    torch.cuda.empty_cache()
    return counts, stats


# ---------------------------------------------------------- hybrid train ----
HYBRID_TRAIN_STEPS = 4
HYBRID_TRAIN_SHAPE = (4, 2048)          # B, S of phase 10
#: kernels whose launches come from phase 10 (the flash kernels' head-dim-80
#: numbers take theirs from it too)
HYBRID_TRAIN_KERNELS = ("ssd_scan_backward",)
#: launches a phase 10 step should make: 54 Mamba2 layers (the scan again
#: in each super-block's recompute) and 9 shared-block calls
HYBRID_STEP_LAUNCHES = {"ssd_scan": 108, "ssd_scan_backward": 54,
                        "flash_attention": 18, "flash_attention_backward": 9}
#: the SSD kernels' device symbols (mamba_scan.cu): the scan, the f32
#: backward and its sums, the bf16 backward's four launches
SSD_KERNEL_NAMES = ("ssd_kernel", "ssd_bwd_kernel", "ssd_bwd_reduce",
                    "ssd_bwd_states", "ssd_bwd_pass", "ssd_bwd_chunk",
                    "ssd_bwd_sums")
# zamba2's full-width gradients (batch 1 x 1024), kernels vs plain: in
# f32 only the order of sums differs (the f32 logits of phase 8 measured
# 1.8e-5 on an NVIDIA H100 80GB HBM3 at 700.00 W): the loss to 1e-4
# relative, each leaf to 1e-3 relative L2; in bf16 each
# leaf is held against the f32 plain gradient within HYBRID_BF16_RATIO of
# the plain bf16 gradient's distance (a fixed bf16 bound says nothing for
# this random-weight model, see HYBRID_BF16_RATIO)
HYBRID_LOSS_TOL = 1e-4
HYBRID_GRAD_TOL = 1e-3


def hybrid_model_flops_per_token(cfg, S: int) -> float:
    """Training FLOPs per token of the zamba2 hybrid at sequence length S:
    3x the forward's (forward + backward; no recompute counted), the
    forward being what its static-cost edges register: per Mamba2 layer
    in_proj, out_proj and the SSD scan (6 chunk (N + P) a head: its two
    [T, T] x [T, *] product pairs), per shared-block call the q, k, v, o
    projections, causal attention (4 head_dim S/2 a head) and the MLP,
    and the lm head."""
    d, di, n, H = cfg.d_model, cfg.d_inner_, cfg.ssm_state, cfg.n_ssm_heads
    P, h, f = cfg.ssm_head_dim, cfg.head_dim_, cfg.d_ff
    mamba = 2 * d * (2 * di + 2 * n + H) + 2 * di * d \
        + 6 * H * min(cfg.ssm_chunk, S) * (n + P)
    shared = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h \
        + 2 * cfg.n_heads * h * d + 2 * (3 if cfg.mlp_gated else 2) * d * f \
        + 4 * cfg.n_heads * h * S / 2
    return 3.0 * (cfg.n_layers * mamba + cfg.n_layers // cfg.attn_every
                  * shared + 2 * d * cfg.vocab)


def hybrid_train_phase(torch, entries):
    """Phase 10: full-width zamba2_2_7b trained through the Trainer, its
    gradients against the plain versions, and the kernels new to its path
    against theirs.  Adds the head-dim-80 numbers to the flash entries of
    `entries`; returns (launch counts of the run, its stats, the
    ssd_scan_backward entry)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tracer as xfa
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.profile import load_profile
    from repro_torch.runtime.trainer import Trainer

    t_phase = time.monotonic()
    xfa.reset()          # the shard phase 9 diagnoses: this run's folds only
    cfg = get_config("zamba2_2_7b")
    model = build_model(cfg, impl="auto", device="cuda")
    B, S = HYBRID_TRAIN_SHAPE
    tcfg = TrainConfig(total_steps=HYBRID_TRAIN_STEPS, warmup_steps=2,
                       ckpt_interval=0)
    with keep_dir("hybrid-train") as d:
        trainer = Trainer(model, tcfg, CheckpointManager(
            os.path.join(d, "ckpt")), profile_dir=os.path.join(d, "prof"))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        state, _ = trainer.run(0, SyntheticLMData(cfg, B, S),
                               HYBRID_TRAIN_STEPS, resume=False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = trainer.history
        if len(hist) != HYBRID_TRAIN_STEPS:
            fail(f"hybrid-train: {len(hist)} of {HYBRID_TRAIN_STEPS} steps "
                 f"recorded")
        for h in hist:
            if not all(math.isfinite(h[k]) for k in ("loss", "grad_norm")):
                fail(f"hybrid-train: step {h['step']} loss {h['loss']} grad "
                     f"norm {h['grad_norm']} not finite")
        for name in tuple(HYBRID_STEP_LAUNCHES) + ("rmsnorm",
                                                   "rmsnorm_backward"):
            if counts[name] <= 0:
                fail(f"hybrid-train: kernel {name} was not launched: "
                     f"{counts}")
        folded = load_profile(os.path.join(d, "prof")).to_folded()
        steps = [e.count for k, e in folded.edges.items()
                 if k[1:] == ("runtime", "dispatch_step")]
        if steps != [HYBRID_TRAIN_STEPS]:
            fail(f"hybrid-train: profile shard holds dispatch_step counts "
                 f"{steps}")
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    step_s = statistics.median(h["step_s"] for h in hist[1:])
    flops = hybrid_model_flops_per_token(cfg, S) * B * S
    stats = {"step_ms": step_s * 1e3, "tok_s": B * S / step_s,
             "mfu": flops / step_s / PEAK_OPS_S["bfloat16"],
             "peak_gb": peak_gb}
    log(f"[hybrid-train] {cfg.name} ({cfg.n_layers} Mamba2 layers + "
        f"{cfg.n_layers // cfg.attn_every} shared-block calls, "
        f"{n_params / 1e9:.3f}B params, {cfg.param_dtype}, remat "
        f"{cfg.remat}), batch {B} x {S}: losses "
        f"{[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}")
    log(f"[hybrid-train] step times (s) {[round(h['step_s'], 4) for h in hist]}"
        f"; median after the first {stats['step_ms']:.1f} ms = "
        f"{stats['tok_s']:.0f} tokens/s; model FLOPs {flops / 1e12:.2f} "
        f"TFLOP/step -> MFU {100 * stats['mfu']:.2f}% of 989 TFLOP/s; peak "
        f"memory {peak_gb:.1f} GB; run wall {wall:.1f}s incl. init")
    per_step = {k: v / HYBRID_TRAIN_STEPS for k, v in counts.items() if v}
    log(f"[hybrid-train] launches over {HYBRID_TRAIN_STEPS} steps "
        f"{json.dumps(counts)}; per step {json.dumps(per_step)} (expected "
        f"{json.dumps(HYBRID_STEP_LAUNCHES)})")
    state, shares = profiled_step(
        torch, model, tcfg, state, SyntheticLMData(cfg, B, S).generate(
            HYBRID_TRAIN_STEPS), "hybrid-train-profile",
        {"ssd": SSD_KERNEL_NAMES, "flash": FLASH_KERNEL_NAMES})
    stats.update(busy=shares["busy"], ssd_share=shares["ssd"],
                 flash_share=shares["flash"])
    del state, trainer, model
    torch.cuda.empty_cache()
    grads_precision_check(torch, cfg, "hybrid-grads",
                          flops_per_token=hybrid_model_flops_per_token)
    ssd_entry = check_hybrid_train_kernels(torch, entries)
    log(f"[hybrid-train] phase 10: {time.monotonic() - t_phase:.1f}s")
    return counts, stats, ssd_entry


def grads_precision_check(torch, cfg16, tag: str, flops_per_token=None,
                          table: bool = False, pin: bool = False,
                          require=(), shape=(1, 1024)):
    """Phases 10, 14, 16 and 17: one loss_fn + backward of `cfg16` (bf16, at its
    widths), batch 1 x 1024, with the kernels and with the plain versions
    on the same params and batch.  In f32 they are held to each other (the
    loss to HYBRID_LOSS_TOL relative, each gradient leaf to
    HYBRID_GRAD_TOL relative L2); in bf16 each leaf must be no further
    from the f32 plain gradient than the plain bf16 leaf, within
    HYBRID_BF16_RATIO.  `table`: loss_fn carries the model's fold table.
    With `pin` the bf16 pair held to the ratio runs again with every top-k
    choice pinned to the f32 plain model's (pinned_router: routing on
    rounded values flips choices, as in phase 13); the unpinned numbers
    and the share of choices the runs differ on are logged.  With
    `flops_per_token`, the static-cost layer's FLOPs of the f32 plain
    loss_fn (without the norms) are held to flops_per_token(cfg16, S) / 3
    at 1e-6.  Every leaf name of `require` must be among the gradients
    compared.  `shape`: the batch (B, S)."""
    import dataclasses
    from repro_torch.core.device_fold import STATIC_COSTS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime.trainer import value_and_grad
    from repro_torch.tree import leaves_with_path

    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    B, S = shape
    batch = SyntheticLMData(cfg16, B, S, seed=1).generate(0)
    router = moe_lib._router

    def grads(cfg, impl, params, pinned=None):
        """(loss, [(leaf name, gradient)], every router call's top-k
        indices); `pinned`: every call's top-k indices to route by."""
        t0 = time.monotonic()
        picks = []
        route = router if pinned is None else pinned_router(router, pinned)

        def spy(w, x2, c):
            out = route(w, x2, c)
            picks.append(out[1])
            return out

        model = build_model(cfg, impl=impl, device="cuda")
        moe_lib._router = spy
        try:
            loss, _, _, g = value_and_grad(model, params, batch,
                                           model.table() if table else None)
        finally:
            moe_lib._router = router
        torch.cuda.synchronize()
        log(f"[{tag}] {impl} {cfg.param_dtype}: loss_fn + backward at {B} x "
            f"{S} in {time.monotonic() - t0:.1f}s")
        for name, leaf in leaves_with_path(g):
            if not torch.isfinite(leaf).all():
                fail(f"{tag}: {impl} {cfg.param_dtype} gradient {name} is "
                     f"not finite")
        return float(loss), leaves_with_path(g), picks

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def differ(a, b):
        n = sum(x.numel() for x in a)
        return sum((x.sort(dim=-1).values != y.sort(dim=-1).values).sum()
                   .item() for x, y in zip(a, b)) / n

    def dist(run, g_ref):
        """Each leaf's relative L2 from the f32 plain gradient."""
        return {n: rel(a, b) for (n, a), (_, b) in zip(run[1], g_ref)}

    # the same seeded draws in f32 (the bf16 params are their roundings)
    p32 = build_model(cfg32, device="cuda").init(0)
    STATIC_COSTS.reset()
    l_r32, g_r32, pick_r32 = grads(cfg32, "ref", p32)
    missing = set(require) - {n for n, _ in g_r32}
    if missing:
        fail(f"{tag}: no gradient of {sorted(missing)}")
    if flops_per_token is not None:
        registered = sum(v.get("flops", 0.0) for k, v in
                         STATIC_COSTS.costs.items() if k[2] != "rmsnorm")
        want = flops_per_token(cfg16, S) / 3 * B * S
        log(f"[{tag}] forward FLOPs of one loss_fn: static-cost layer "
            f"{registered:.6e} (without the norms), "
            f"{flops_per_token.__name__} / 3 {want:.6e}")
        if abs(registered - want) > 1e-6 * want:
            fail(f"{tag}: {flops_per_token.__name__} disagrees with the "
                 f"static-cost layer ({want:.6e} against {registered:.6e})")
    routed = bool(pick_r32)
    k32 = grads(cfg32, "kernel", p32)
    e32 = dist(k32, g_r32)
    rel_loss = abs(k32[0] - l_r32) / abs(l_r32)
    log(f"[{tag}] f32, batch {B} x {S}: loss kernels {k32[0]:.6f} plain "
        f"{l_r32:.6f} (relative error {rel_loss:.3e}, tolerance "
        f"{HYBRID_LOSS_TOL}); "
        + (f"top-k choices that differ {100 * differ(k32[2], pick_r32):.4f}"
           f"%; " if routed else "")
        + f"gradient relative L2 "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in e32.items()})} "
        f"(tolerance {HYBRID_GRAD_TOL})")
    del k32, p32
    torch.cuda.empty_cache()
    if rel_loss > HYBRID_LOSS_TOL or max(e32.values()) > HYBRID_GRAD_TOL:
        fail(f"{tag}: f32 kernels and plain versions disagree (loss "
             f"{rel_loss:.3e}, worst leaf {max(e32.values()):.3e})")
    p16 = build_model(cfg16, device="cuda").init(0)
    pins = (False, True) if pin else (False,)
    out = {}
    for pinned in pins:
        for impl in ("kernel", "ref"):
            run = grads(cfg16, impl, p16, pick_r32 if pinned else None)
            out[pinned, impl] = (run[0], dist(run, g_r32), run[2])
            del run
            torch.cuda.empty_cache()
    del p16, g_r32
    torch.cuda.empty_cache()
    for pinned in pins:
        (lk, ek, pk), (lr, er, pr) = out[pinned, "kernel"], out[pinned, "ref"]
        ratio = {n: ek[n] / er[n] for n in ek}
        how = ("" if not pin else " pinned to the f32 plain choices"
               if pinned else " unpinned")
        log(f"[{tag}] bf16{how}: loss kernels {lk:.6f} plain {lr:.6f} (f32 "
            f"plain {l_r32:.6f}); "
            + (f"top-k choices that differ from the f32 plain model's: "
               f"kernels {100 * differ(pk, pick_r32):.4f}%, plain "
               f"{100 * differ(pr, pick_r32):.4f}%; " if routed else "")
            + "per leaf, relative L2 from the f32 plain gradient, kernels / "
            "plain bf16: " + json.dumps(
                {n: f"{ek[n]:.3e} / {er[n]:.3e}" for n in ek})
            + f"; worst ratio {max(ratio.values()):.3f} (limit "
            f"{HYBRID_BF16_RATIO}{', logged only' if pin != pinned else ''})")
    ek, er = out[pin, "kernel"][1], out[pin, "ref"][1]
    bad = {n: ek[n] / er[n] for n in ek if ek[n] > HYBRID_BF16_RATIO * er[n]}
    if bad:
        fail(f"{tag}: {'pinned ' if pin else ''}bf16 kernel gradients "
             f"further from the f32 plain gradients than the plain bf16 "
             f"ones: {bad}")


def ssd_bwd_work(B, L, H, P, N, chunk, elem):
    """(bytes, operations) of the SSD backward: reads x, dy, b, c (elem
    bytes), dt (f32), writes dx, db, dc (elem), ddt and da (f32); per
    (row, head, chunk) the state recompute, C B^T, S^T dy, dy dtx^T, dG B
    and dG^T C over the T(T+1)/2 visible pairs, and B dh, dy h^T, dtx dh^T,
    C^T dy over the [T, N, P] products."""
    nbytes = elem * (3 * B * L * H * P + 4 * B * L * N) \
        + 4.0 * (2 * B * L * H + 2 * H)
    ops = B * H * (L // chunk) * ((3 * N + 2 * P) * chunk * (chunk + 1)
                                  + 10.0 * chunk * N * P)
    return nbytes, ops


def ssd_bwd_launches(torch, flush, fn, calls: int = 10):
    """Each launch of one ssd_scan_backward call with its own device time
    per call (torch.profiler over `calls` calls, L2 flushed and the card
    held busy before each, as time_ms): {kernel symbol: ms}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            flush.zero_()
            torch.cuda._sleep(HOST_LEAD_CYCLES)
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in p.key_averages():
        m = re.search(r"ssd_bwd_\w+", e.key)
        if m and _dev_us(e) > 0:
            out[m.group(0)] = round(_dev_us(e) / e.count / 1e3, 4)
    if not out:
        fail("ssd_scan_backward: the profiler saw none of its launches")
    return out


def check_hybrid_train_kernels(torch, entries):
    """Phase 10 kernels: ssd_scan_backward against ref.ssd_scan_backward at
    the training shape (bf16, f32; with and without h0 and dh_final) and at
    1 x 512, each twice and bitwise equal; flash attention forward and
    backward at head dim 80 against the plain versions at the shared
    block's training shape (causal, bf16 and f32) and at Sq != Sk; timed
    beside the plain versions and SDPA.  Returns the ssd_scan_backward
    entry; adds head_dim_80 to the flash entries of `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda dt, *s: torch.randn(s, generator=gen, device=dev).to(dt)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    bf16, f32 = torch.bfloat16, torch.float32
    H, P, N, chunk = 80, 64, 64, 128
    B, L = HYBRID_TRAIN_SHAPE
    errs, timed = [], None
    for what, dtype, nb, l, with_h0 in (("training bf16", bf16, B, L, False),
                                        ("training bf16 h0 dh", bf16, B, L,
                                         True),
                                        ("training f32", f32, B, L, False),
                                        ("training f32 h0 dh", f32, B, L, True),
                                        ("1x512 bf16 h0 dh", bf16, 1, 512,
                                         True),
                                        ("1x512 bf16", bf16, 1, 512, False)):
        x, dy = rnd(dtype, nb, l, H, P), rnd(dtype, nb, l, H, P)
        b, c = rnd(dtype, nb, l, N), rnd(dtype, nb, l, N)
        dt = F.softplus(rnd(f32, nb, l, H) - 2)
        a = -torch.exp(0.5 * rnd(f32, H))
        h0 = rnd(f32, nb, H, N, P) if with_h0 else None
        dh = rnd(f32, nb, H, N, P) if with_h0 else None
        args = (x, dt, a, b, c, h0, dy, dh)
        got = ms.ssd_scan_backward(*args, chunk=chunk)
        again = ms.ssd_scan_backward(*args, chunk=chunk)
        want = ref.ssd_scan_backward(*args, chunk=chunk)
        names = ("dx", "ddt", "da", "db", "dc", "dh0")
        for name, g, w in zip(names, got, want):
            if w is not None:
                errs.append(max_err(torch, g, w,
                                    f"ssd_scan_backward {name} {what}"))
        torch.cuda.synchronize()
        if not all(g is None or torch.equal(g, h) for g, h in zip(got, again)):
            fail(f"ssd_scan_backward {what}: two launches differ")
        if what == "training bf16":
            timed = args
        del x, dy, b, c, dt, a, h0, dh, args, got, again, want
        torch.cuda.empty_cache()
    log(f"[hybrid-train-kernels] ssd_scan_backward max_abs_err per case and "
        f"gradient {[f'{e:.3e}' for e in errs]}; two launches equal in "
        f"every case")
    nbytes, ops_ssd = ssd_bwd_work(B, L, H, P, N, chunk, 2)
    ssd = record_kernel(
        torch, flush, "ssd_scan_backward",
        "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "src/repro/kernels/ref.py:505 (JAX autodiff of ssd_chunked; the "
        "Pallas kernel src/repro/kernels/mamba_scan.py:81 is forward-only)",
        f"x, dy {B}x{L}x{H}x{P} b/c {B}x{L}x{N} chunk {chunk}", max(errs),
        lambda: ms.ssd_scan_backward(*timed, chunk=chunk),
        lambda: ref.ssd_scan_backward(*timed, chunk=chunk),
        None,   # no one PyTorch call computes the SSD scan's gradient
        nbytes=nbytes, ops=ops_ssd)
    ssd["launch_ms"] = ssd_bwd_launches(
        torch, flush, lambda: ms.ssd_scan_backward(*timed, chunk=chunk))
    hg, groups = ms.ssd_bwd_plan(B, L, H, chunk,
                                 torch.cuda.get_device_properties(0)
                                 .multi_processor_count)
    log(f"[hybrid-train-kernels] ssd_scan_backward bf16 plan: {hg} heads a "
        f"block, {B * (L // chunk) * groups} blocks of states and chunk "
        f"gradients; per launch (device ms a call) "
        f"{json.dumps(ssd['launch_ms'])}, sum "
        f"{sum(ssd['launch_ms'].values()):.4f} ms (event-timed call "
        f"{ssd['ms']:.4f} ms)")
    del timed
    torch.cuda.empty_cache()

    # flash attention at the shared block's head dim
    Bq, Hq, Sf, D = B, 32, L, 80
    ferr = {"fwd": [], "train": [], "bwd": []}
    for what, dtype, sq, sk, causal in (("training bf16", bf16, Sf, Sf, True),
                                        ("training f32", f32, Sf, Sf, True),
                                        ("Sq 1024 Sk 2048 bf16", bf16, 1024,
                                         Sf, True),
                                        ("non-causal Sq 512 Sk 2048 bf16",
                                         bf16, 512, Sf, False)):
        q, do = rnd(dtype, Bq, Hq, sq, D), rnd(dtype, Bq, Hq, sq, D)
        k, v = rnd(dtype, Bq, Hq, sk, D), rnd(dtype, Bq, Hq, sk, D)
        off = dict(q_offset=sk - sq if causal else 0)
        o, lse, _ = fa.flash_attention(q, k, v, causal=causal)
        o_r, lse_r = ref.attention(q, k, v, causal=causal, return_lse=True,
                                   **off)
        ferr["fwd"].append(max_err(torch, o, o_r, f"flash_attention D=80 "
                                   f"{what}"))
        max_err(torch, lse, lse_r, f"flash_attention lse D=80 {what}")
        tol = KERNEL_TOL if dtype == bf16 else F32_KERNEL_TOL
        o32, terr = training_forward(torch, q, k, v, o, lse,
                                     f"flash_attention D=80 {what}", tol,
                                     causal=causal)
        ferr["train"].append(terr)
        grads = fa.flash_attention_backward(q, k, v, o_r.float(), lse_r, do,
                                            causal=causal)
        want = ref.attention_backward(q, k, v, o_r, lse_r, do, causal=causal,
                                      **off)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            ferr["bwd"].append(max_err(
                torch, g, w, f"flash_attention_backward {name} D=80 {what}"))
        if what == "training bf16":
            timed = (q, k, v, do, o, lse, o32)
        del q, k, v, do, o, lse, o32, o_r, lse_r, grads, want
        torch.cuda.empty_cache()
    log(f"[hybrid-train-kernels] flash D=80 max_abs_err: forward "
        f"{[f'{e:.3e}' for e in ferr['fwd']]}, training's forward (o32) "
        f"{[f'{e:.3e}' for e in ferr['train']]}, backward "
        f"{[f'{e:.3e}' for e in ferr['bwd']]}")
    q, k, v, do, o, lse, o32 = timed
    shape = f"q {Bq}x{Hq}x{Sf}x{D} kv {Bq}x{Hq}x{Sf}x{D} causal"
    fwd_ops, bwd_ops, io = flash_work(q, k, v)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
    cases = {
        "flash_attention": (
            max(ferr["fwd"]), lambda: fa.flash_attention(q, k, v),
            lambda: ref.attention(q, k, v, q_offset=0, return_lse=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            dict(nbytes=io + 2.0 * o.numel() + 4.0 * lse.numel(),
                 ops=fwd_ops)),
        "flash_attention_backward": (
            max(ferr["bwd"]),
            lambda: fa.flash_attention_backward(q, k, v, o32, lse, do),
            lambda: ref.attention_backward(q, k, v, o32, lse, do, q_offset=0),
            lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                        retain_graph=True),
            dict(nbytes=2 * io + 6.0 * o.numel() + 4.0 * lse.numel(),
                 ops=bwd_ops))}
    for e in entries:
        if e["name"] in cases:
            err, fn, plain, lib, work = cases[e["name"]]
            d80 = record_kernel(torch, flush, e["name"], e["source"],
                                e["replaces"], shape, err, fn, plain, lib,
                                **work)
            e["head_dim_80"] = sub_entry(d80)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"[hybrid-train-kernels] {e['name']} {shape}: "
                f"{work['ops'] / d80['ms'] / 1e9:.1f} TFLOP/s, "
                f"{100 * d80['bound_ms'] / d80['ms']:.1f}% of its bound, "
                f"{d80['ms'] / d80['library_ms']:.2f}x SDPA")
            if e["name"] == "flash_attention":
                e["head_dim_80"]["training"] = train = \
                    record_training_forward(
                        torch, flush, e, shape, max(ferr["train"]), q, k, v,
                        o, lse, lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True))
                e["max_abs_err"] = max(e["max_abs_err"], max(ferr["train"]))
                log(f"[hybrid-train-kernels] flash_attention training "
                    f"{shape}: {100 * train['bound_ms'] / train['ms']:.1f}% "
                    f"of its bound, {train['ms'] / d80['ms']:.2f}x "
                    f"inference's forward")
    del q, k, v, do, o, lse, o32, qq, kk, vv, out, timed, flush
    torch.cuda.empty_cache()
    return ssd


# ------------------------------------------------------------------- moe ----
MOE_ARCH = "phi3_5_moe_42b"
#: depth cuts of phi3.5-moe (32 layers of 1.300B params, 83.7 GB in bf16,
#: do not fit the 80 GB card): serving keeps 6 layers (24 fit the card,
#: 62.9 GB of weights; cut to 6 for the run's time, to make room for
#: phases 20 and 20b); training 2 (2.86B params x 16 B of state = 45.8
#: GB at batch 4 x 2048); the f32 logits check 4 (21.9 GB of f32 weights
#: beside their bf16 copy)
MOE_SERVE_LAYERS = 6
MOE_TRAIN_LAYERS = 2
MOE_CHECK_LAYERS = 4
#: capacity_factor at which nothing drops: C = max(4, int(T top_k / E cf))
#: reaches T at cf = E / top_k = 8, and no expert receives more than T
#: choices (a token picks an expert once).  The drop-free serve pair runs
#: at MOE_DROP_FREE_LAYERS: its [E, T, d_ff] expert activations took the
#: 24-layer serve to a 77.3 GB peak (NVIDIA H100 80GB HBM3); half the
#: serve depth, as that pair's 12 of 24 was
MOE_DROP_FREE = 8.0
MOE_DROP_FREE_LAYERS = 3
MOE_TRAIN_STEPS = 4
MOE_TRAIN_SHAPE = (4, 2048)             # B, S of phase 12
MOE_TRAIN_PEAK_GB = 80.0                # the card's memory (phases 12, 14)
DISPATCH = ("decoder", "moe", "dispatch")
ROUTER = ("decoder", "moe", "router")


def release(torch) -> None:
    """Free what the code before left: a paged engine holds itself in a
    reference cycle (its scheduler's page gate is its bound method), which
    only the cyclic collector frees, with the weights it serves."""
    gc.collect()
    torch.cuda.empty_cache()


def moe_cfg(layers: int, **kw):
    """phi3.5-moe at its published widths, cut to `layers` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=layers, **kw)


def moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers


def moe_fold(cfg, folded, what: str, tokens: int, calls: int) -> dict:
    """Hold a folded device table to the MoE layer's invariants: the loads
    sum to top_k x `tokens` x the MoE layers (every routed token, pad rows
    and columns included), the count is `calls` x the MoE layers, the
    router losses are finite.  Logs each expert's share of the load,
    max/mean, the dropped choices and the mean router losses; returns
    them."""
    d, r = folded.edges[DISPATCH], folded.edges[ROUTER]
    L = moe_layers(cfg)
    loads = [d.metrics[f"expert_load[{e}]"] for e in range(cfg.n_experts)]
    want = cfg.top_k * tokens * L
    if sum(loads) != want or d.count != calls * L:
        fail(f"{what}: the fold holds loads summing to {sum(loads)} (want "
             f"top_k x {tokens} tokens x {L} layers = {want}) and count "
             f"{d.count} (want {calls * L})")
    aux, z = r.metrics["aux_loss"], r.metrics["z_loss"]
    if not (math.isfinite(aux) and math.isfinite(z)):
        fail(f"{what}: router losses aux {aux} z {z} not finite")
    dropped = d.metrics["dropped_tokens"]
    out = {"load_share": [round(x / want, 5) for x in loads],
           "max_over_mean": max(loads) / (want / cfg.n_experts),
           "dropped": dropped, "dropped_share": dropped / want,
           "aux_mean": aux / d.count, "z_mean": z / d.count}
    log(f"[{what}] fold: {d.count} MoE layer calls, {int(sum(loads))} "
        f"routed choices; load share per expert {out['load_share']}; "
        f"max/mean {out['max_over_mean']:.3f}; dropped {int(dropped)} "
        f"({100 * out['dropped_share']:.2f}% of choices); mean aux "
        f"{out['aux_mean']:.4f}, z {out['z_mean']:.3f} a call")
    return out


def engine_fold(cfg, engine, what: str) -> dict:
    """The serving engine's fold table against the tokens and calls the
    engine counted (warm-up included)."""
    return moe_fold(cfg, engine.model.fold_spec.fold(engine.table), what,
                    engine.forward_tokens, engine.forward_calls)


def moe_sync_free(torch, cfg, params):
    """One MoE layer's forward and its five emits, at a prefill group's
    rows and a decode tick's, under torch.cuda.set_sync_debug_mode
    ("error"): any host sync raises."""
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import _layer

    model = build_model(cfg, device="cuda")
    lp = _layer(params["stack_moe"]["stack"], 0)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for B, S in ((8, 512), (8, 1)):
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            moe_lib.moe(lp, x, model.rt, model.table())   # cuBLAS set-up
            table = model.table()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                y, table, aux = moe_lib.moe(lp, x, model.rt, table)
            except RuntimeError as e:
                fail(f"moe layer [{B}, {S}]: a host sync in the forward: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        f = model.fold_spec.fold(table)
        loads = sum(v for k, v in f.edges[DISPATCH].metrics.items()
                    if k.startswith("expert_load"))
        if loads != cfg.top_k * B * S or f.edges[DISPATCH].count != 1 \
                or not torch.isfinite(y).all() or not math.isfinite(aux):
            fail(f"moe layer [{B}, {S}]: loads {loads}, count "
                 f"{f.edges[DISPATCH].count}, y or aux not finite")
    log(f"[moe-serve] one MoE layer's forward and its five emits at [8, 512] "
        f"and [8, 1] x {cfg.d_model} ran under set_sync_debug_mode('error') "
        f"without a host sync")


def serve_model(torch, runs, what, cfg, params, drop_free=False, **paged):
    """Serve phase 5's requests through a model of seeded weights `params`
    (`paged`: the page pool's fields), an MoE model with the engine's
    fold held to its invariants (and, `drop_free`, nothing dropped); logs
    tok/s, TTFT, decode gap and peak memory, and adds (token streams,
    launch counts, stats with peak_gb and, for an MoE model, fold) to
    `runs` under `what`."""
    torch.cuda.reset_peak_memory_stats()
    engine, done, counts, stats, _ = serve_run(torch, what, cfg=cfg,
                                               params=params, **paged)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if engine.paged != bool(paged):
        fail(f"{what}: engine.paged is {engine.paged}")
    if engine.paged and engine.allocator.in_use != 0:
        fail(f"{what}: {engine.allocator.in_use} pages in use at drain")
    fold = engine_fold(cfg, engine, what) if cfg.moe else None
    if drop_free and fold["dropped"]:
        fail(f"{what}: {fold['dropped']} choices dropped at capacity "
             f"factor {cfg.capacity_factor}")
    log(f"[{what}] {stats['throughput_tok_s']:.1f} tok/s, ttft p50 "
        f"{stats['ttft_p50_s'] * 1e3:.1f} ms p95 "
        f"{stats['ttft_p95_s'] * 1e3:.1f} ms, decode "
        f"{stats['decode_s_per_tok'] * 1e3:.2f} ms/token; peak memory "
        f"{peak:.1f} GB; {engine.forward_calls} forward calls, "
        f"{engine.forward_tokens} tokens through the model")
    runs[what] = (streams(done), counts, dict(stats, peak_gb=peak,
                                              fold=fold))
    del engine, done
    release(torch)


def profile_window(torch, tag, cfg, params, groups=None):
    """A torch.profiler window over a short contiguous serving run (8
    requests x 16 tokens): where it goes, and for each of `groups` (a
    label: substrings of device kernel names) its launches and share of
    the device time.  Returns the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import run_workload

    with keep_dir(f"{tag}-window") as prof:
        _, engine, prompts = make_engine(torch, prof, cfg=cfg, params=params)
        engine.warm_chunk_programs()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.monotonic()
            run_workload(engine, prompts[:8], 16, mode="closed")
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    rows, busy = breakdown(p, wall_us, tag, "8 requests x 16 tokens")
    for label, names in (groups or {}).items():
        hit = [e for e in rows if any(n in e.key for n in names)]
        us = sum(_dev_us(e) for e in hit)
        log(f"[{tag}] {label}: x{sum(e.count for e in hit)}, "
            f"{us / 1e3:.2f} ms, {100 * us / busy:.1f}% of device time")
    del engine, p
    release(torch)
    return busy / wall_us


def moe_serve_phase(torch):
    """Phase 11: phi3.5-moe served at its published widths and
    MOE_SERVE_LAYERS layers: the sync-free check, contiguous, then paged
    (257 pages), each with the fold's invariants, and a profiled window;
    the same pair drop-free (capacity_factor MOE_DROP_FREE, at
    MOE_DROP_FREE_LAYERS layers), whose 16 token streams must be equal;
    then the logits check.  Returns (launch counts of the contiguous run,
    of the paged run, the contiguous run's stats)."""
    from repro_torch.models import build_model

    t_phase = time.monotonic()
    release(torch)
    log(f"[moe-serve] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"at the start of phase 11")
    cfg = moe_cfg(MOE_SERVE_LAYERS)
    t0 = time.monotonic()
    params = build_model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[moe-serve] {cfg.name} at {cfg.n_layers} of 32 layers (d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top {cfg.top_k} of d_ff "
        f"{cfg.moe_d_ff}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim_}, capacity_factor {cfg.capacity_factor}): "
        f"{n_params / 1e9:.3f}B params, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.1f}"
        f" GB, initialised in {time.monotonic() - t0:.1f}s")
    moe_sync_free(torch, cfg, params)
    runs = {}
    paged = dict(page_size=PAGE, max_cache_pages=257)
    serve_model(torch, runs, "moe-serve", cfg, params)
    serve_model(torch, runs, "moe-paged", cfg, params, **paged)
    profile_window(torch, "moe-profile", cfg, params)
    del params
    release(torch)
    free = moe_cfg(MOE_DROP_FREE_LAYERS, capacity_factor=MOE_DROP_FREE)
    params = build_model(free, device="cuda").init(0)
    serve_model(torch, runs, "moe-serve-drop-free", free, params,
              drop_free=True)
    serve_model(torch, runs, "moe-paged-drop-free", free, params,
              drop_free=True, **paged)
    del params
    release(torch)
    same = sum(a == b for a, b in zip(runs["moe-serve"][0],
                                      runs["moe-paged"][0]))
    same_free = sum(a == b for a, b in zip(runs["moe-serve-drop-free"][0],
                                           runs["moe-paged-drop-free"][0]))
    log(f"[moe-paged] capacity_factor {cfg.capacity_factor}: {same} of 16 "
        f"token streams equal the contiguous run (pad columns past a row's "
        f"granted pages read scratch page 0 and are routed, so they may take "
        f"other capacity than in the contiguous run); drop-free at "
        f"{free.n_layers} layers: {same_free} of 16")
    if same_free != 16:
        fail(f"moe: drop-free, paged gives other tokens than contiguous "
             f"({same_free} of 16 streams equal)")
    moe_logits_check(torch, moe_cfg(MOE_CHECK_LAYERS), "moe-logits")
    log(f"[moe-serve] phase 11: {time.monotonic() - t_phase:.1f}s")
    return runs["moe-serve"][1], runs["moe-paged"][1], runs["moe-serve"][2]


def pinned_router(router, picks):
    """A router that takes its top-k choices from `picks` (one [T, K]
    tensor a call, in call order) and its gates from its own
    probabilities at those choices, renormalised."""
    calls = []

    def route(w, x2, cfg):
        _, _, counts, aux, z = router(w, x2, cfg)
        idx = picks[len(calls)]
        calls.append(None)
        gates = (x2.float() @ w.float()).softmax(dim=-1).gather(1, idx)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        flat = idx.reshape(-1)
        counts = counts.new_zeros(counts.shape).scatter_add_(
            0, flat, flat.new_ones(flat.shape))
        return gates, idx, counts, aux, z
    return route


def moe_logits_check(torch, cfg16, tag: str, pin: bool = False):
    """Phases 11 and 13: an MoE model cut to a few layers (`cfg16`, bf16),
    one 512-token prefill chunk and one decode step with the kernels and
    with the plain versions, in f32 (held to each other) and in bf16 (held
    against the f32 plain model within HYBRID_BF16_RATIO of the plain bf16
    model's distance: routing on rounded values makes a fixed bf16 bound
    meaningless), and the share of top-k choices on which the kernel and
    plain runs differ.  With `pin` the bf16 pair held to the ratio runs
    again with every top-k choice pinned to the f32 plain model's (gates
    from its own probabilities at those choices), so that the ratio
    compares the kernels' numerics and not which of a token's choices a
    rounding flips: deepseek's top 6 of 64 flips 1.5-8% of choices a
    layer in bf16 (NVIDIA H100 80GB HBM3, 700.00 W), and one flipped
    token of four carried 0.39 of its logits' relative L2 while pinned
    the kernels' and the plain path's agree (PERF.md §6).  The unpinned
    numbers are logged."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(9)
    B, T = 4, 512
    tokens = torch.randint(0, cfg16.vocab, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    nxt = torch.randint(0, cfg16.vocab, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    at = torch.full((B,), T, dtype=torch.int32, device="cuda")
    router = moe_lib._router

    def run(cfg, impl, params, pinned=None):
        """(prefill logits, decode logits, every call's top-k indices);
        `pinned`: every call's top-k indices to route by."""
        picks = []
        route = router if pinned is None else pinned_router(router, pinned)

        def spy(w, x2, c):
            out = route(w, x2, c)
            picks.append(out[1])
            return out
        m = build_model(cfg, impl=impl, device="cuda")
        cache = m.init_cache(B, 2048)
        moe_lib._router = spy
        try:
            lp, cache, _ = m.forward_chunk(params, tokens, m.table(), cache,
                                           zero)
            ld, _, _ = m.decode_step(params, nxt, m.table(), cache, at)
        finally:
            moe_lib._router = router
        torch.cuda.synchronize()
        return lp.float(), ld.float(), picks

    def differ(a, b):
        n = sum(x.numel() for x in a)
        return sum((x.sort(dim=-1).values != y.sort(dim=-1).values).sum()
                   .item() for x, y in zip(a, b)) / n

    p32 = build_model(cfg32, device="cuda").init(0)
    k32 = run(cfg32, "kernel", p32)
    r32 = run(cfg32, "ref", p32)
    del p32
    torch.cuda.empty_cache()
    # the same seeded draws in bf16 (their roundings)
    p16 = build_model(cfg16, device="cuda").init(0)
    k16 = run(cfg16, "kernel", p16)
    r16 = run(cfg16, "ref", p16)
    if pin:
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()
        log(f"[{tag}] unpinned bf16, relative L2 against the f32 plain "
            f"model (prefill, decode): kernels "
            f"{rel(k16[0], r32[0]):.3e}, {rel(k16[1], r32[1]):.3e}; plain "
            f"{rel(r16[0], r32[0]):.3e}, {rel(r16[1], r32[1]):.3e}")
        kp = run(cfg16, "kernel", p16, pinned=r32[2])
        rp = run(cfg16, "ref", p16, pinned=r32[2])
    del p16
    torch.cuda.empty_cache()
    log(f"[{tag}] {cfg16.name} at {cfg16.n_layers} layers: top-k "
        f"choices on which kernels and plain versions differ: f32 "
        f"{100 * differ(k32[2], r32[2]):.4f}%, bf16 "
        f"{100 * differ(k16[2], r16[2]):.4f}%; bf16 plain vs f32 plain "
        f"{100 * differ(r16[2], r32[2]):.4f}% ({len(r32[2])} MoE calls of "
        f"{B * T} and {B} tokens)")
    if pin:
        log(f"[{tag}] bf16 held to the ratio with every top-k choice pinned "
            f"to the f32 plain model's")
        k16, r16 = kp, rp
    check_precisions(torch, tag, (B, cfg16.vocab), k16, r16, k32, r32)


def moe_model_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs of the MoE decoder on a batch of B rows of S tokens:
    3x the forward's (forward + backward; no recompute counted), the
    forward being what its static-cost edges register: the active
    parameters only (per MoE layer the top_k routed experts' SwiGLU, 6 d
    moe_d_ff each, and any shared experts; the dense layers' MLP), the
    attention projections and causal attention (4 head_dim S/2 a head),
    and the lm head.  Under MLA the attention is its mla_proj edge, 2 d
    (nh (dn + dr) + r + dr), and flash at head dim dn + dr; the products
    it registers no cost for are mla_unregistered_flops'.  The
    router's d x E product registers no cost, as in the reference."""
    d = cfg.d_model
    if cfg.mla:
        dqk = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = 2 * d * (cfg.n_heads * dqk + cfg.kv_lora_rank
                        + cfg.qk_rope_dim) + 4 * cfg.n_heads * dqk * S / 2
    else:
        h = cfg.head_dim_
        attn = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h \
            + 2 * cfg.n_heads * h * d + 4 * cfg.n_heads * h * S / 2
    moe = 6 * d * cfg.moe_d_ff * (cfg.top_k + cfg.n_shared_experts)
    dense = 2 * (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
    return 3.0 * B * S * (cfg.n_layers * attn + moe_layers(cfg) * moe
                          + cfg.first_dense_layers * dense
                          + 2 * d * cfg.vocab)


def dense_model_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's; no recompute counted) of a batch
    of B rows of S positions of the dense or vlm decoder, as its
    static-cost edges register them: per position and layer the attention
    projections, causal attention (4 head_dim S/2 a head) and the MLP (2
    or 3 matmuls: ungated, as granite and starcoder2, or gated); the lm
    head on the text positions only (the vlm's first n_patches positions
    are its patch prefix, whose projection registers no cost, as in the
    reference: vlm_frontend_flops)."""
    d, h = cfg.d_model, cfg.head_dim_
    per_pos = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h \
        + 2 * cfg.n_heads * h * d + 4 * cfg.n_heads * h * S / 2 \
        + 2 * (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
    text = S - (cfg.n_patches if cfg.family == "vlm" else 0)
    return 3.0 * B * (cfg.n_layers * S * per_pos + text * 2 * d * cfg.vocab)


def vlm_frontend_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's) of the vlm's patch projection,
    which registers no static cost: 2 frontend_dim d a patch."""
    return 3.0 * 2 * cfg.frontend_dim * cfg.d_model * cfg.n_patches * B


def mla_unregistered_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's) on a batch of B rows of S tokens
    of the two MLA products the reference registers no static cost for:
    a token's latent expansion through wkv_b, 2 r nh (dn + dv), and
    o_proj, 2 nh dv d, each layer."""
    nh, dv = cfg.n_heads, cfg.v_head_dim
    return 3.0 * B * S * cfg.n_layers * (2 * cfg.kv_lora_rank * nh
                                         * (cfg.qk_nope_dim + dv)
                                         + 2 * nh * dv * cfg.d_model)


def cut_train_phase(torch, cfg, tag: str, phase: int, shape, steps: int,
                    flops=moe_model_flops, unregistered=None,
                    kernels=TRAIN_KERNELS + ("rmsnorm",), profile=True):
    """Phases 12, 14, 16 and 17: a model (`cfg`: phi3.5-moe, deepseek-v2-lite,
    whose expanded MLA branch runs the flash pair at q/k head dim 192 and v
    128, granite-20b cut in depth, or internvl2-1b) trained at its widths,
    batch `shape`, `steps` steps through the port's Trainer and its XFA
    session.  Launch counters set to 0 just before and read just after:
    each of `kernels` (by default both flash kernels, rmsnorm and its
    backward) must have run; losses,
    aux losses and grad norms finite; peak memory under MOE_TRAIN_PEAK_GB;
    the profile shard's device group (and an MoE model's fold invariants);
    step time, tokens/s, MFU by the static-cost FLOPs (`flops(cfg, B, S)`
    of a batch, held to the static-cost layer of one loss_fn at 1e-6) plus
    `unregistered(cfg, B, S)` FLOPs that the reference registers no cost
    for; with `profile`, a profiled step.  Returns (launch counts of the
    run, its stats)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tracer as xfa
    from repro_torch.core.device_fold import STATIC_COSTS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.profile import load_profile
    from repro_torch.runtime.trainer import Trainer

    t_phase = time.monotonic()
    release(torch)
    log(f"[{tag}] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"at the start of phase {phase}")
    xfa.reset()          # the shard phase 9 reads: this run's folds only
    model = build_model(cfg, impl="auto", device="cuda")
    B, S = shape
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, ckpt_interval=0)
    with keep_dir(tag) as d:
        trainer = Trainer(model, tcfg, CheckpointManager(
            os.path.join(d, "ckpt")), profile_dir=os.path.join(d, "prof"))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        state, _ = trainer.run(0, SyntheticLMData(cfg, B, S), steps,
                               resume=False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = trainer.history
        if len(hist) != steps:
            fail(f"{tag}: {len(hist)} of {steps} steps recorded")
        for h in hist:
            if not all(math.isfinite(h[k]) for k in ("loss", "aux_loss",
                                                     "grad_norm")):
                fail(f"{tag}: step {h['step']} loss {h['loss']} aux "
                     f"{h['aux_loss']} grad norm {h['grad_norm']} not finite")
        for name in kernels:
            if counts[name] <= 0:
                fail(f"{tag}: kernel {name} was not launched: {counts}")
        if peak_gb >= MOE_TRAIN_PEAK_GB:
            fail(f"{tag}: peak memory {peak_gb:.1f} GB")
        folded = load_profile(os.path.join(d, "prof")).to_folded()
        if [e.count for k, e in folded.edges.items()
                if k[1:] == ("runtime", "dispatch_step")] != [steps]:
            fail(f"{tag}: profile shard lacks dispatch_step x {steps}")
        step_edge = folded.edges.get(("app", "loss", "train_step"))
        if step_edge is None or step_edge.count != steps:
            fail(f"{tag}: the shard's device group holds train_step "
                 f"{step_edge and step_edge.count}, not {steps}")
        fold = (moe_fold(cfg, folded, tag, B * S * steps, steps)
                if cfg.moe else None)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    step_s = statistics.median(h["step_s"] for h in hist[1:])
    registered = flops(cfg, B, S)
    extra = unregistered(cfg, B, S) if unregistered else 0.0
    total = registered + extra
    stats = {"step_ms": step_s * 1e3, "tok_s": B * S / step_s,
             "mfu": total / step_s / PEAK_OPS_S["bfloat16"],
             "peak_gb": peak_gb, "fold": fold}
    log(f"[{tag}] {cfg.name} at {cfg.n_layers} layers ({n_params / 1e9:.3f}"
        f"B params, {cfg.param_dtype}, remat {cfg.remat}), batch {B} x {S}: "
        f"losses {[round(h['loss'], 4) for h in hist]}, aux "
        f"{[round(h['aux_loss'], 6) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}")
    log(f"[{tag}] step times (s) {[round(h['step_s'], 4) for h in hist]}"
        f"; median after the first {stats['step_ms']:.1f} ms = "
        f"{stats['tok_s']:.0f} tokens/s; model FLOPs {total / 1e12:.3f} "
        f"TFLOP/step"
        + (f" ({registered / 1e12:.3f} registered as static costs + "
           f"{extra / 1e12:.3f} of {unregistered.__name__})"
           if unregistered else "")
        + f" -> MFU {100 * stats['mfu']:.2f}% of 989 TFLOP/s; peak memory "
        f"{peak_gb:.1f} GB; run wall {wall:.1f}s incl. init; launches "
        f"{json.dumps(counts)}")
    # the registered FLOPs against the static-cost layer: one loss_fn
    t_check = time.monotonic()
    batch = SyntheticLMData(cfg, 1, 1024, seed=1).generate(0)
    STATIC_COSTS.reset()
    with torch.no_grad():
        model.loss_fn(state["params"], batch, model.table())
    got = sum(v.get("flops", 0.0) for k, v in STATIC_COSTS.costs.items()
              if k[2] != "rmsnorm")
    want = flops(cfg, 1, 1024) / 3
    log(f"[{tag}] forward FLOPs of one loss_fn at 1 x 1024: static-cost "
        f"layer {got:.6e} (without the norms), {flops.__name__} / 3 "
        f"{want:.6e}")
    if abs(got - want) > 1e-6 * want:
        fail(f"{tag}: {flops.__name__} disagrees with the "
             f"static-cost layer ({want:.6e} against {got:.6e})")
    if profile:
        state, shares = profiled_step(
            torch, model, tcfg, state, SyntheticLMData(cfg, B, S).generate(
                steps), f"{tag}-profile", {"flash": FLASH_KERNEL_NAMES})
        stats.update(busy=shares["busy"], flash_share=shares["flash"])
    log(f"[{tag}] train run {wall:.1f}s, static-cost check and profiled "
        f"step {time.monotonic() - t_check:.1f}s")
    del state, trainer, model
    release(torch)
    log(f"[{tag}] phase {phase}: {time.monotonic() - t_phase:.1f}s")
    return counts, stats


# ------------------------------------------------------------------- mla ----
MLA_ARCH = "deepseek_v2_lite_16b"
#: capacity_factor at which nothing drops: C = int(T top_k / E cf) =
#: int(T 6 / 64 x 11) >= T at every T, and no expert receives more than T
#: choices (a token picks an expert once)
MLA_DROP_FREE = 11.0
#: deepseek served at 6 of its 27 layers (1 dense + 5 MoE): all 27 fit
#: the card (PRs 23-27), cut for the run's time to make room for phases
#: 20 and 20b
MLA_SERVE_LAYERS = 6
MLA_CHECK_LAYERS = 4                    # 1 dense + 3 MoE layers
MLA_PEAK_GB = 75.0                      # the serve runs' ceiling


def layer_sync_free(torch, cfg, params, tag: str, what: str,
                    kind: str = "moe"):
    """The first layer of `kind` (phase 13: MLA + MoE, latent attention,
    then 64 experts top 6 and 2 shared experts; phase 15: a dense MQA
    layer) at a prefill group's rows [8, 512] and then a decode tick's
    [8, 1], against a contiguous cache and a page arena, under
    torch.cuda.set_sync_debug_mode("error"): any host sync raises."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import _layer, _stack_name, \
        decoder_layer

    model = build_model(cfg, device="cuda")
    lp = _layer(params[_stack_name(cfg, kind)]["stack"], 0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = torch.device("cuda")
    B = 8
    bt = torch.arange(1, 1 + B * 32, dtype=torch.int32, device=dev) \
        .reshape(B, 32)
    for paged in (False, True):
        one = (model.init_paged_cache(1 + B * 32, PAGE) if paged
               else model.init_cache(B, 2048))
        cache = {name: leaf[0] for name, leaf in one.items()}
        steps = []
        for at, S in ((0, 512), (512, 1)):
            x = torch.randn((B, S, cfg.d_model), generator=gen,
                            device=dev).to(torch.bfloat16)
            pos = torch.full((B,), at, dtype=torch.int32, device=dev)
            positions = pos[:, None] + torch.arange(S, device=dev)[None, :]
            steps.append((x, pos, positions))
        with torch.no_grad():
            x, pos, positions = steps[0]
            decoder_layer(lp, x, model.rt, positions, kind, model.table(),
                          cache, pos, bt if paged else None)   # set-up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for x, pos, positions in steps:
                    y, _, _ = decoder_layer(lp, x, model.rt, positions, kind,
                                            model.table(), cache, pos,
                                            bt if paged else None)
            except RuntimeError as e:
                fail(f"{tag} layer ({'paged' if paged else 'contiguous'}): a "
                     f"host sync in the forward: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if not torch.isfinite(y).all():
            fail(f"{tag} layer: the output is not finite")
    log(f"[{tag}] {what}'s forward at [8, 512] and [8, 1] x {cfg.d_model}, "
        f"contiguous and paged, ran under set_sync_debug_mode('error') "
        f"without a host sync")


def mla_serve_phase(torch):
    """Phase 13: deepseek-v2-lite served at its published widths and all
    27 layers: the sync-free check; phase 5's requests contiguous, then
    paged (257 pages), each with the fold's invariants and peak memory
    under MLA_PEAK_GB; a profiled window; the same pair drop-free
    (capacity_factor MLA_DROP_FREE), whose 16 token streams must be
    equal; then the logits check at MLA_CHECK_LAYERS layers.  Returns
    (launch counts of the contiguous run, of the paged run, the contiguous
    run's stats with the window's busy share)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.monotonic()
    release(torch)
    log(f"[mla-serve] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"at the start of phase 13")
    cfg = dataclasses.replace(get_config(MLA_ARCH),
                              n_layers=MLA_SERVE_LAYERS)
    t0 = time.monotonic()
    params = build_model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[mla-serve] {cfg.name} at {cfg.n_layers} of 27 layers (d_model "
        f"{cfg.d_model}, MLA: {cfg.n_heads} heads, latent r "
        f"{cfg.kv_lora_rank} + rope {cfg.qk_rope_dim}; {cfg.n_experts} "
        f"experts top {cfg.top_k} of d_ff {cfg.moe_d_ff} + "
        f"{cfg.n_shared_experts} shared, {cfg.first_dense_layers} dense "
        f"layer of d_ff {cfg.d_ff}; capacity_factor {cfg.capacity_factor}): "
        f"{n_params / 1e9:.3f}B params, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.1f}"
        f" GB, initialised in {time.monotonic() - t0:.1f}s")
    layer_sync_free(torch, cfg, params, "mla-serve", "one MLA + MoE layer")
    runs = {}
    paged = dict(page_size=PAGE, max_cache_pages=257)
    serve_model(torch, runs, "mla-serve", cfg, params)
    serve_model(torch, runs, "mla-paged", cfg, params, **paged)
    # the latent kernels' shares, and the copies: PR 23's k_full / v_lat
    # (a cat and a pad of the layer's cache every call) are gone
    busy = profile_window(torch, "mla-profile", cfg, params, groups={
        "latent attention kernels": ("latent_kernel",),
        "copy kernels": ("copy", "Copy")})
    free = dataclasses.replace(cfg, capacity_factor=MLA_DROP_FREE)
    serve_model(torch, runs, "mla-serve-drop-free", free, params,
              drop_free=True)
    serve_model(torch, runs, "mla-paged-drop-free", free, params,
              drop_free=True, **paged)
    del params
    release(torch)
    for what, (_, _, st) in runs.items():
        if st["peak_gb"] >= MLA_PEAK_GB:
            fail(f"{what}: peak memory {st['peak_gb']:.1f} GB, not under "
                 f"{MLA_PEAK_GB} GB")
    same = sum(a == b for a, b in zip(runs["mla-serve"][0],
                                      runs["mla-paged"][0]))
    same_free = sum(a == b for a, b in zip(runs["mla-serve-drop-free"][0],
                                           runs["mla-paged-drop-free"][0]))
    log(f"[mla-paged] capacity_factor {cfg.capacity_factor}: {same} of 16 "
        f"token streams equal the contiguous run (pad columns past a row's "
        f"granted pages read scratch page 0 and are routed, as in phase "
        f"11); drop-free (capacity_factor {MLA_DROP_FREE}): {same_free} of "
        f"16")
    if same_free != 16:
        fail(f"mla: drop-free, paged gives other tokens than contiguous "
             f"({same_free} of 16 streams equal)")
    moe_logits_check(torch, dataclasses.replace(cfg, n_layers=MLA_CHECK_LAYERS),
                     "mla-logits", pin=True)
    log(f"[mla-serve] phase 13: {time.monotonic() - t_phase:.1f}s")
    return (runs["mla-serve"][1], runs["mla-paged"][1],
            dict(runs["mla-serve"][2], busy=busy))


# ------------------------------------------------------------- mla train ----
#: deepseek-v2-lite trained at its published widths, cut to 4 of 27 layers
#: (1 dense + 3 MoE): 2.25B params x 16 B of state (bf16 params, f32
#: master weights and AdamW moments) ~36 GB, where all 27 layers' ~251 GB
#: do not fit the 80 GB card
MLA_TRAIN_LAYERS = 4
MLA_TRAIN_STEPS = 4
MLA_TRAIN_SHAPE = (4, 2048)             # B, S of phase 14


def mla_train_cfg():
    """deepseek-v2-lite at its published widths, cut to MLA_TRAIN_LAYERS."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MLA_ARCH),
                               n_layers=MLA_TRAIN_LAYERS)


def mla_train_phase(torch):
    """Phase 14: deepseek-v2-lite trained at its widths and
    MLA_TRAIN_LAYERS layers through cut_train_phase, with the wkv_b
    expansion and o_proj counted into its MFU; then grads_precision_check
    with the fold table and the router pinned, without remat (the router
    runs once a layer).  Returns (launch counts of the run, its stats)."""
    import dataclasses
    cfg = mla_train_cfg()
    out = cut_train_phase(torch, cfg, "mla-train", 14, MLA_TRAIN_SHAPE,
                          MLA_TRAIN_STEPS,
                          unregistered=mla_unregistered_flops)
    grads_precision_check(torch, dataclasses.replace(cfg, remat="none"),
                          "mla-grads", table=True, pin=True)
    return out


# ----------------------------------------------------------- granite ----
GRANITE_ARCH = "granite_20b"
GRANITE_PEAK_GB = 75.0                  # the serve runs' ceiling
#: granite served at 8 of its 52 layers: all 52 fit the card (PRs 26-27),
#: cut for the run's time to make room for phases 20, 20b (16 layers) and
#: 21 (8)
GRANITE_SERVE_LAYERS = 8
#: the logits checks of phase 15 (granite, and the two dense archs that no
#: other phase runs on the card) at their widths, cut to 4 layers
DENSE_CHECK_LAYERS = 4
DENSE_CHECK_ARCHS = (GRANITE_ARCH, "qwen3_14b", "starcoder2_7b")
#: granite-20b trained at its published widths, cut to 4 of 52 layers:
#: 2.12B params x 16 B of state (bf16 params, f32 master weights and
#: AdamW moments) ~34 GB, where all 52 layers' ~325 GB do not fit 80 GB
GRANITE_TRAIN_LAYERS = 4
GRANITE_TRAIN_STEPS = 4
GRANITE_TRAIN_SHAPE = (4, 2048)         # B, S of phase 16


def dense_logits_check(torch, cfg16, tag: str):
    """Phase 15: a dense model (`cfg16`, bf16, at its widths), one
    512-token prefill chunk and one decode step at batch 4 with the
    kernels and with the plain versions, in f32 (held to each other) and
    in bf16 (held against the f32 plain model within HYBRID_BF16_RATIO of
    the plain bf16 model's distance), by check_precisions."""
    import dataclasses
    from repro_torch.models import build_model

    t0 = time.monotonic()
    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(13)
    B, T = 4, 512
    tokens = torch.randint(0, cfg16.vocab, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    nxt = torch.randint(0, cfg16.vocab, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    at = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def run(cfg, impl, params):
        m = build_model(cfg, impl=impl, device="cuda")
        cache = m.init_cache(B, 2048)
        lp, cache, _ = m.forward_chunk(params, tokens, None, cache, zero)
        ld, _, _ = m.decode_step(params, nxt, None, cache, at)
        torch.cuda.synchronize()
        return lp.float(), ld.float()

    out = {}
    for cfg in (cfg16, cfg32):
        # the same seeded draws in both dtypes (bf16: their roundings)
        params = build_model(cfg, device="cuda").init(0)
        out[cfg.param_dtype] = (run(cfg, "kernel", params),
                                run(cfg, "ref", params))
        del params
        release(torch)
    (k16, r16), (k32, r32) = out["bfloat16"], out["float32"]
    log(f"[{tag}] {cfg16.name} at {cfg16.n_layers} layers (d_model "
        f"{cfg16.d_model}, {cfg16.n_heads} q / {cfg16.n_kv_heads} kv heads "
        f"of {cfg16.head_dim_}, d_ff {cfg16.d_ff}, "
        f"{'gated' if cfg16.mlp_gated else 'ungated'}"
        f"{', qk-norm' if cfg16.qk_norm else ''}), batch {B}:")
    check_precisions(torch, tag, (B, cfg16.vocab), k16, r16, k32, r32)
    log(f"[{tag}] {time.monotonic() - t0:.1f}s")


def granite_serve_phase(torch):
    """Phase 15: granite-20b served at its published widths and
    GRANITE_SERVE_LAYERS of its 52 layers: one dense MQA layer
    sync-free; phase 5's requests contiguous, then paged (257 pages),
    whose 16 token streams must be equal, each
    with peak memory under GRANITE_PEAK_GB; a profiled window; the decode
    gap against the weights' read; then the logits checks of
    DENSE_CHECK_ARCHS at DENSE_CHECK_LAYERS layers.  Returns (launch
    counts of the contiguous run, of the paged run, the contiguous run's
    stats with the window's busy share)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.monotonic()
    release(torch)
    cfg = dataclasses.replace(get_config(GRANITE_ARCH),
                              n_layers=GRANITE_SERVE_LAYERS)
    t0 = time.monotonic()
    params = build_model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    weight_gb = sum(t.numel() * t.element_size()
                    for t in _leaves(params)) / 1e9
    log(f"[granite-serve] {cfg.name} at {cfg.n_layers} of 52 layers "
        f"(d_model "
        f"{cfg.d_model}, {cfg.n_heads} q heads over {cfg.n_kv_heads} kv "
        f"head of {cfg.head_dim_}, ungated d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}): {n_params / 1e9:.3f}B params, {weight_gb:.1f} GB, "
        f"initialised in {time.monotonic() - t0:.1f}s")
    layer_sync_free(torch, cfg, params, "granite-serve",
                    "one dense MQA layer", kind="dense")
    runs = {}
    serve_model(torch, runs, "granite-serve", cfg, params)
    serve_model(torch, runs, "granite-paged", cfg, params, page_size=PAGE,
                max_cache_pages=257)
    busy = profile_window(torch, "granite-profile", cfg, params, groups={
        "attention kernels": ("chunk_kernel", "decode_kernel"),
        "rmsnorm kernels": ("rmsnorm_kernel",)})
    del params
    release(torch)
    for what, (_, _, st) in runs.items():
        if st["peak_gb"] >= GRANITE_PEAK_GB:
            fail(f"{what}: peak memory {st['peak_gb']:.1f} GB, not under "
                 f"{GRANITE_PEAK_GB} GB")
    same = sum(a == b for a, b in zip(runs["granite-serve"][0],
                                      runs["granite-paged"][0]))
    if same != 16:
        fail(f"granite: paged gives other tokens than contiguous ({same} of "
             f"16 streams equal)")
    st = runs["granite-serve"][2]
    floor_ms = weight_gb * 1e9 / HBM_BYTES_S * 1e3
    log(f"[granite-paged] 16 of 16 token streams equal the contiguous run; "
        f"decode gap {st['decode_s_per_tok'] * 1e3:.2f} ms/token against "
        f"{floor_ms:.2f} ms to read the {weight_gb:.1f} GB of weights once "
        f"a tick ({st['decode_s_per_tok'] * 1e3 / floor_ms:.2f}x); busy "
        f"{100 * busy:.1f}%")
    for arch in DENSE_CHECK_ARCHS:
        dense_logits_check(torch, dataclasses.replace(
            get_config(arch), n_layers=DENSE_CHECK_LAYERS), f"{arch}-logits")
    log(f"[granite-serve] phase 15: {time.monotonic() - t_phase:.1f}s")
    return (runs["granite-serve"][1], runs["granite-paged"][1],
            dict(st, busy=busy))


def granite_train_cfg():
    """granite-20b at its published widths, cut to GRANITE_TRAIN_LAYERS."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(GRANITE_ARCH),
                               n_layers=GRANITE_TRAIN_LAYERS)


def granite_train_phase(torch):
    """Phase 16: granite-20b trained at its widths and
    GRANITE_TRAIN_LAYERS layers through cut_train_phase (the flash pair at
    48 q heads over one kv head of 128); then grads_precision_check.
    Returns (launch counts of the run, its stats)."""
    cfg = granite_train_cfg()
    out = cut_train_phase(torch, cfg, "granite-train", 16,
                          GRANITE_TRAIN_SHAPE, GRANITE_TRAIN_STEPS,
                          flops=dense_model_flops)
    t0 = time.monotonic()
    grads_precision_check(torch, cfg, "granite-grads")
    log(f"[granite-grads] {time.monotonic() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ vlm ----
VLM_ARCH = "internvl2_1b"
#: the vlm's served sequence: VLM_ROWS rows, each its patch prefix and a
#: VLM_TEXT-token text chunk in one bulk prefill, a continuation
#: bucket-padded to VLM_TEXT tokens at these per-row valid lengths, then
#: VLM_TICKS greedy decode ticks at per-row offsets
VLM_ROWS = 8
VLM_TEXT = 512
VLM_VALID = [16, 512, 100, 333, 47, 260, 511, 128]
VLM_TICKS = 32
VLM_MAX_LEN = 2048
VLM_TRAIN_STEPS = 6
VLM_TRAIN_SHAPE = (4, 2048)             # B, S (256 of S the patch prefix)


def vlm_sequence(torch, model, params, inputs, paged: bool,
                 ticks: int = VLM_TICKS):
    """The served sequence through the model API, contiguous or through
    a page arena (PAGE rows a page, a shuffled block table): prefill of
    the projected patches and the text, the bucket-padded continuation,
    `ticks` greedy decode ticks.  Returns (logits of the prefill, of the
    continuation and of the first tick, the greedy tokens [B, 1 + ticks],
    prefill ms, decode ms)."""
    patches, text, cont, valid = inputs
    dev = text.device
    B = text.shape[0]
    P = patches.shape[1]
    nb = VLM_MAX_LEN // PAGE
    if paged:
        gen = torch.Generator(device=dev).manual_seed(17)
        bt = (torch.randperm(B * nb, generator=gen, device=dev) + 1) \
            .to(torch.int32).reshape(B, nb)
        cache = model.init_paged_cache(1 + B * nb, PAGE)
        chunk = lambda *a, **kw: model.forward_chunk_paged(
            *a[:5], bt, **kw)
        step = lambda *a: model.decode_step_paged(*a, bt)
    else:
        cache = model.init_cache(B, VLM_MAX_LEN)
        chunk, step = model.forward_chunk, model.decode_step
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prefix = model.project_patches(params, patches)
    l0, cache, _ = chunk(params, text, None, cache, zero,
                         prefix_embeds=prefix)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    at = zero + P + text.shape[1]
    l1, cache, _ = chunk(params, cont, None, cache, at, valid=valid)
    at = at + valid
    tok = torch.argmax(l1, dim=-1).to(torch.int32)
    out, first = [tok], None
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(ticks):
        logits, cache, _ = step(params, tok, None, cache, at)
        first = logits if first is None else first
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        at = at + 1
    torch.cuda.synchronize()
    decode_ms = (time.monotonic() - t0) * 1e3
    return (l0.float(), l1.float(), first.float()), torch.stack(out, 1), \
        prefill_ms, decode_ms


def vlm_inputs(torch, cfg, seed: int = 19):
    """Seeded patches [VLM_ROWS, n_patches, frontend_dim] f32, text and
    continuation tokens [VLM_ROWS, VLM_TEXT] and the valid lengths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = VLM_ROWS
    patches = torch.randn((B, cfg.n_patches, cfg.frontend_dim),
                          generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, B, VLM_TEXT), generator=gen,
                         device=dev, dtype=torch.int32)
    valid = torch.tensor(VLM_VALID, dtype=torch.int32, device=dev)
    cont = toks[1] * (torch.arange(VLM_TEXT, device=dev)[None, :]
                      < valid[:, None])           # the pad past valid: 0
    return patches, toks[0].contiguous(), cont.contiguous(), valid


def vlm_serve_phase(torch):
    """Phase 17, serve: internvl2-1b at its published widths and all 24
    layers, bf16, through the model API (vlm_sequence), contiguous and
    then paged (page size PAGE) with the prefix through
    forward_chunk_paged, the launch counters set to 0 just before each
    and read just after (rmsnorm, chunk and decode attention, or their
    paged twins, must run); the greedy tokens must be equal; prefill time
    and decode tok/s logged; then the logits of the prefill, the
    continuation and the first tick with the kernels against the plain
    versions, in f32 (held to each other) and bf16 (check_precisions), at
    full depth.  Returns (launch counts of the contiguous run, of the
    paged run, its stats)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    t_phase = time.monotonic()
    release(torch)
    cfg = get_config(VLM_ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    inputs = vlm_inputs(torch, cfg)
    log(f"[internvl-serve] {cfg.name} at all {cfg.n_layers} layers (d_model "
        f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim_}, patches {cfg.n_patches} x {cfg.frontend_dim} "
        f"projected to the prefix): {n_params / 1e9:.3f}B params; "
        f"{VLM_ROWS} rows of {cfg.n_patches} patches + {VLM_TEXT} tokens, a "
        f"{VLM_TEXT}-token continuation at valid {VLM_VALID}, {VLM_TICKS} "
        f"decode ticks")
    vlm_sequence(torch, model, params, inputs, False, ticks=2)   # warm-up
    runs = {}
    for paged in (False, True):
        ops.reset_launch_counts()
        _, toks, prefill_ms, decode_ms = vlm_sequence(torch, model, params,
                                                      inputs, paged)
        counts = ops.launch_counts()
        sfx, other = ("_paged", "") if paged else ("", "_paged")
        L = cfg.n_layers
        want = {"rmsnorm": (2 * L + 1) * (2 + VLM_TICKS),
                "chunk_attention" + sfx: 2 * L,
                "decode_attention" + sfx: VLM_TICKS * L,
                "chunk_attention" + other: 0, "decode_attention" + other: 0}
        if any(counts[k] != n for k, n in want.items()):
            fail(f"internvl-serve ({'paged' if paged else 'contiguous'}): launch "
                 f"counts {counts}, want {want}")
        if not ((0 <= toks) & (toks < cfg.vocab)).all():
            fail("internvl-serve: a greedy token is out of the vocabulary")
        runs[paged] = (toks, counts, {
            "prefill_ms": prefill_ms,
            "decode_tok_s": VLM_ROWS * VLM_TICKS / (decode_ms / 1e3)})
        log(f"[internvl-serve] {'paged' if paged else 'contiguous'}: prefill of "
            f"{cfg.n_patches} patches + {VLM_TEXT} tokens x {VLM_ROWS} rows "
            f"{prefill_ms:.1f} ms, {VLM_TICKS} decode ticks "
            f"{decode_ms:.1f} ms ({runs[paged][2]['decode_tok_s']:.1f} "
            f"tok/s, {decode_ms / VLM_TICKS:.2f} ms a tick); launches "
            f"{json.dumps(counts)}")
    if not torch.equal(runs[False][0], runs[True][0]):
        fail(f"internvl-serve: paged tokens differ from contiguous "
             f"({int((runs[False][0] != runs[True][0]).sum())} of "
             f"{runs[False][0].numel()})")
    log(f"[internvl-serve] paged tokens equal the contiguous ones "
        f"({runs[False][0].numel()} tokens)")
    del params, model
    release(torch)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    out = {}
    for c in (cfg, cfg32):
        params = build_model(c, device="cuda").init(0)
        out[c.param_dtype] = tuple(vlm_sequence(
            torch, build_model(c, impl=impl, device="cuda"), params, inputs,
            False, ticks=1)[0] for impl in ("kernel", "ref"))
        del params
        release(torch)
    (k16, r16), (k32, r32) = out["bfloat16"], out["float32"]
    check_precisions(torch, "internvl-logits", (VLM_ROWS, cfg.vocab), k16, r16,
                     k32, r32, whats=(
                         f"prefill {cfg.n_patches} patches + {VLM_TEXT} "
                         f"tokens", "continuation at valid lengths",
                         "first decode tick"))
    log(f"[internvl-serve] phase 17 serve: {time.monotonic() - t_phase:.1f}s")
    return runs[False][1], runs[True][1], runs[False][2]


def vlm_train_phase(torch):
    """Phase 17, train: internvl2-1b at its published widths and all 24
    layers, batch VLM_TRAIN_SHAPE (n_patches of each row's positions the
    patch prefix), VLM_TRAIN_STEPS steps through cut_train_phase (the
    flash pair at 14 q over 2 kv heads of 64; MFU adds the patch
    projection, which registers no cost); then grads_precision_check,
    frontend/w among its leaves.  Returns (launch counts of the run, its
    stats)."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    out = cut_train_phase(torch, cfg, "internvl-train", 17, VLM_TRAIN_SHAPE,
                          VLM_TRAIN_STEPS, flops=dense_model_flops,
                          unregistered=vlm_frontend_flops)
    t0 = time.monotonic()
    grads_precision_check(torch, cfg, "internvl-grads", require=("frontend/w",))
    log(f"[internvl-grads] {time.monotonic() - t0:.1f}s")
    return out


# ---------------------------------------------------------------- audio ----
AUDIO_ARCH = "seamless_m4t_large_v2"
#: seamless's attention: 16 q over 16 kv heads of 64 (G 1), phase 3h's
#: sub-entry key, and its rmsnorm rows' width
AUDIO_HEADS = (16, 16, 64)              # Hq, Hkv, D
AUDIO_KEY = "g1_d64"
AUDIO_WIDTH = ("width_1024", 1024)
#: the enc-dec's served sequence: AUDIO_ROWS rows, each AUDIO_SRC source
#: frames encoded once and a decoder prompt bucket-padded to AUDIO_PROMPT
#: tokens at these valid lengths, one AUDIO_CONT-token continuation
#: without frames, then AUDIO_TICKS greedy decode ticks
AUDIO_ROWS = 8
AUDIO_SRC = 1024
AUDIO_PROMPT = 128
AUDIO_VALID = [8, 128, 50, 77, 100, 9, 127, 64]
AUDIO_CONT = 64
AUDIO_TICKS = 32
AUDIO_MAX_LEN = 256                     # decoder cache rows
AUDIO_ALONE = (0, 5)                    # rows served alone (f32)
AUDIO_TRAIN_STEPS = 6
AUDIO_TRAIN_SHAPE = (4, 2048)           # B, S (frames 2048 x 1024 a row)
#: phase 3h's chunk attention at the decoder's self-attention: (T, per-row
#: offsets) into a 1024-row cache
AUDIO_CHUNKS = ((AUDIO_PROMPT, [0, 128, 512, 896, 7, 300, 700, 64]),
                (8, [0, 1016, 64, 511, 900, 3, 700, 256]))


def check_audio_kernels(torch, entries):
    """Phase 3h: the kernels of the enc-dec's path at seamless's shapes
    (16 q over 16 kv heads of 64), in f32 and bf16: decode against the
    whole source, every row at kv_len = S (S 1024 and the ragged 1000);
    chunk attention at T 128 and T 8 at per-row offsets; the flash
    forward non-causal at the serving cross-attention (q [8,16,128,64]
    against k/v [8,16,1024,64], q [8,16,8,64] against 1000 rows); the
    flash pair non-causal at the training shape (q, k, v [4,16,2048,64];
    f32 at [1,16,2048,64]) with two backward launches bitwise equal;
    rmsnorm and its backward 1024 wide (check_width).  Each against its
    plain version per entry (2e-2 bf16, 2e-5 f32; the bf16 dk and dv
    against the plain backward with p rounded to bf16,
    flash_backward_errs); the bf16 cases timed beside their plain
    versions, their bounds (non-causal FLOPs) and SDPA.  Adds AUDIO_KEY
    and AUDIO_WIDTH sub-entries to `entries`."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    t_phase = time.monotonic()
    dev = torch.device("cuda")
    Hq, Hkv, D = AUDIO_HEADS
    tag = f"D={D} G=1 non-causal"
    gen = torch.Generator(device=dev).manual_seed(31)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    sdpa = F.scaled_dot_product_attention
    by_name = {e["name"]: e for e in entries}
    timed = {}

    def record(name, key, shape, err, fn, plain, lib, **work):
        """Time one case; `key` "main" is the entry's own shape."""
        e = by_name[name]
        timed.setdefault(name, {})[key] = sub_entry(record_kernel(
            torch, flush, name, e["source"], e["replaces"], shape, err, fn,
            plain, lib, **work))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        return timed[name][key]

    B, S = AUDIO_ROWS, AUDIO_SRC
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        tol = KERNEL_TOL if bf16 else F32_KERNEL_TOL
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
        q = rnd(B, Hq, D)
        for Sk in (S, 1000):
            k, v = rnd(B, Hkv, Sk, D), rnd(B, Hkv, Sk, D)
            kv_len = torch.full((B,), Sk, dtype=torch.int32, device=dev)
            err = max_err(torch, dec.decode_attention(q, k, v, kv_len=kv_len),
                          ref.decode_attention(q, k, v, kv_len=kv_len),
                          f"decode_attention {tag} kv_len {Sk} {dtype}", tol)
            if bf16:
                record("decode_attention", "main" if Sk == S else "ragged",
                       f"q {B}x{Hq}x{D} kv {B}x{Hkv}x{Sk}x{D} kv_len {Sk} "
                       f"every row", err,
                       lambda q=q, k=k, v=v, n=kv_len: dec.decode_attention(
                           q, k, v, kv_len=n),
                       lambda q=q, k=k, v=v, n=kv_len: ref.decode_attention(
                           q, k, v, kv_len=n),
                       lambda q=q, k=k, v=v: sdpa(q[:, :, None], k, v),
                       nbytes=2.0 * q.numel() * 2 + 4 * B
                       + B * Sk * Hkv * D * 2 * 2, ops=4.0 * B * Sk * Hq * D)
        k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
        for T, pos_l in AUDIO_CHUNKS:
            qc = rnd(B, Hq, T, D)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            err = max_err(torch, dec.chunk_attention(qc, k, v, pos=pos),
                          ref.chunk_attention(qc, k, v, pos=pos),
                          f"chunk_attention {tag} T={T} {dtype}", tol)
            if bf16:
                lim = pos[:, None] + torch.arange(T, device=dev)[None, :]
                cmask = (torch.arange(S, device=dev)[None, None, :]
                         <= lim[:, :, None])[:, None]
                record("chunk_attention",
                       "main" if T == AUDIO_PROMPT else "short_chunk",
                       f"q {B}x{Hq}x{T}x{D} kv {B}x{Hkv}x{S}x{D} pos {pos_l}",
                       err,
                       lambda qc=qc, pos=pos: dec.chunk_attention(qc, k, v,
                                                                  pos=pos),
                       lambda qc=qc, pos=pos: ref.chunk_attention(qc, k, v,
                                                                  pos=pos),
                       lambda qc=qc, m=cmask: sdpa(qc, k, v, attn_mask=m),
                       **chunk_work(pos_l, T, S, Hq, Hkv, D))
        # the serving cross-attention: a chunk's queries against the source
        for Sq, Sk in ((AUDIO_PROMPT, S), (8, 1000)):
            qx, kx, vx = rnd(B, Hq, Sq, D), rnd(B, Hkv, Sk, D), \
                rnd(B, Hkv, Sk, D)
            o, lse, _ = fa.flash_attention(qx, kx, vx, causal=False)
            o_r, lse_r = ref.attention(qx, kx, vx, causal=False, q_offset=0,
                                       return_lse=True)
            err = max_err(torch, o, o_r, f"flash_attention {tag} Sq {Sq} Sk "
                          f"{Sk} {dtype}", tol)
            max_err(torch, lse, lse_r, f"flash_attention lse {tag} Sq {Sq} "
                    f"Sk {Sk} {dtype}", tol)
            if bf16:
                fwd_ops, _, io = flash_work(qx, kx, vx, causal=False)
                record("flash_attention",
                       "cross_chunk" if Sq == AUDIO_PROMPT else "cross_short",
                       f"q {B}x{Hq}x{Sq}x{D} kv {B}x{Hkv}x{Sk}x{D} "
                       f"non-causal", err,
                       lambda a=(qx, kx, vx): fa.flash_attention(
                           *a, causal=False),
                       lambda a=(qx, kx, vx): ref.attention(
                           *a, causal=False, q_offset=0, return_lse=True),
                       lambda a=(qx, kx, vx): sdpa(*a),
                       nbytes=io + 2.0 * o.numel() + 4.0 * lse.numel(),
                       ops=fwd_ops)
            del qx, kx, vx, o, lse, o_r, lse_r
        del q, k, v
        torch.cuda.empty_cache()
        # the flash pair at the training shape: the encoder and the
        # training cross-attention
        Bt, St = (4, 2048) if bf16 else (1, 2048)
        q, k, v, do = rnd(Bt, Hq, St, D), rnd(Bt, Hkv, St, D), \
            rnd(Bt, Hkv, St, D), rnd(Bt, Hq, St, D)
        o, lse, _ = fa.flash_attention(q, k, v, causal=False)
        o_r, lse_r = ref.attention(q, k, v, causal=False, q_offset=0,
                                   return_lse=True)
        ferr = max_err(torch, o, o_r, f"flash_attention {tag} {dtype}", tol)
        max_err(torch, lse, lse_r, f"flash_attention lse {tag} {dtype}", tol)
        o32, terr = training_forward(torch, q, k, v, o, lse,
                                     f"flash_attention {tag} {dtype}", tol,
                                     causal=False)
        o_r = o_r.float()
        grads = fa.flash_attention_backward(q, k, v, o_r, lse_r, do,
                                            causal=False)
        if bf16:
            berr = flash_backward_errs(torch, grads, (q, k, v, o_r, lse_r,
                                                      do), tag, causal=False)
        else:
            berr = max(max_err(torch, g, w, f"flash_attention_backward {n} "
                               f"{tag} f32", tol)
                       for n, g, w in zip(("dq", "dk", "dv"), grads,
                                          ref.attention_backward(
                                              q, k, v, o_r, lse_r, do,
                                              causal=False, q_offset=0)))
        again = fa.flash_attention_backward(q, k, v, o_r, lse_r, do,
                                            causal=False)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            fail(f"flash_attention_backward {tag} {dtype}: two launches "
                 f"differ")
        del o_r, lse_r, grads, again
        if bf16:
            shape = f"q {Bt}x{Hq}x{St}x{D} kv {Bt}x{Hkv}x{St}x{D} non-causal"
            fwd_ops, bwd_ops, io = flash_work(q, k, v, causal=False)
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = sdpa(qq, kk, vv)
            fwd = record(
                "flash_attention", "main", shape, ferr,
                lambda: fa.flash_attention(q, k, v, causal=False),
                lambda: ref.attention(q, k, v, causal=False, q_offset=0,
                                      return_lse=True),
                lambda: sdpa(q, k, v),
                nbytes=io + 2.0 * o.numel() + 4.0 * lse.numel(), ops=fwd_ops)
            # training's forward: o also in f32 for the backward's delta
            fe = by_name["flash_attention"]
            timed["flash_attention"]["training"] = train = \
                record_training_forward(torch, flush, fe, shape, terr, q, k,
                                        v, o, lse, lambda: sdpa(q, k, v),
                                        causal=False)
            fe["max_abs_err"] = max(fe["max_abs_err"], terr)
            bwd = record(
                "flash_attention_backward", "main", shape, berr,
                lambda: fa.flash_attention_backward(q, k, v, o32, lse, do,
                                                    causal=False),
                lambda: ref.attention_backward(q, k, v, o32, lse, do,
                                               causal=False, q_offset=0),
                lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                            retain_graph=True),
                nbytes=2 * io + 6.0 * o.numel() + 4.0 * lse.numel(),
                ops=bwd_ops)
            for name, t_, ops in (("flash_attention", fwd, fwd_ops),
                                  ("flash_attention training", train,
                                   fwd_ops),
                                  ("flash_attention_backward", bwd,
                                   bwd_ops)):
                log(f"[audio-kernels] {name} {shape}: "
                    f"{ops / t_['ms'] / 1e9:.1f} TFLOP/s, "
                    f"{100 * t_['bound_ms'] / t_['ms']:.1f}% of its bound, "
                    f"{t_['ms'] / t_['library_ms']:.2f}x SDPA")
            del qq, kk, vv, out
        log(f"[audio-kernels] {dtype}: decode (S 1024, 1000), chunk (T "
            f"{AUDIO_PROMPT}, 8), flash forward (Sq {AUDIO_PROMPT} / 8 "
            f"against Sk 1024 / 1000, and Sq = Sk = {St}) and backward "
            f"(dq/dk/dv at {Bt}x{Hq}x{St}x{D}) within {tol}")
        del q, k, v, do, o, lse, o32
        torch.cuda.empty_cache()
    # the sub-entry: the main shape's numbers, the other shapes keyed
    for name, subs in timed.items():
        by_name[name][AUDIO_KEY] = dict(
            subs.pop("main"), **subs)
    key, d = AUDIO_WIDTH
    check_width(torch, entries, key, d, AUDIO_ARCH, gen, flush)
    del flush
    torch.cuda.empty_cache()
    log(f"[audio-kernels] phase 3h: {time.monotonic() - t_phase:.1f}s")


def audio_inputs(torch, cfg, seed: int = 29):
    """Seeded frames [AUDIO_ROWS, AUDIO_SRC, frontend_dim] f32, the
    decoder prompt [AUDIO_ROWS, AUDIO_PROMPT] (0 past each row's valid
    length), the continuation [AUDIO_ROWS, AUDIO_CONT] and the valid
    lengths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = AUDIO_ROWS
    frames = torch.randn((B, AUDIO_SRC, cfg.frontend_dim), generator=gen,
                         device=dev)
    toks = torch.randint(0, cfg.vocab, (2, B, AUDIO_PROMPT), generator=gen,
                         device=dev, dtype=torch.int32)
    valid = torch.tensor(AUDIO_VALID, dtype=torch.int32, device=dev)
    prompt = toks[0] * (torch.arange(AUDIO_PROMPT, device=dev)[None, :]
                        < valid[:, None])
    return frames, prompt.contiguous(), \
        toks[1, :, :AUDIO_CONT].contiguous(), valid


def audio_sequence(torch, model, params, inputs, ticks: int):
    """The enc-dec's served sequence through the model API: the frames
    encoded and the bucket-padded prompt prefilled in one forward_chunk,
    the continuation without frames, `ticks` greedy decode ticks at
    per-row offsets.  Returns (logits of the prefill, of the continuation
    and of the first tick, the greedy tokens [B, 1 + ticks], prefill ms,
    decode ms)."""
    frames, prompt, cont, valid = inputs
    B = prompt.shape[0]
    cache = model.init_cache(B, AUDIO_MAX_LEN, src_len=frames.shape[1])
    zero = torch.zeros(B, dtype=torch.int32, device=prompt.device)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    l0, cache, _ = model.forward_chunk(params, prompt, None, cache, zero,
                                       valid, frames=frames)
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    l1, cache, _ = model.forward_chunk(params, cont, None, cache, valid)
    at = valid + cont.shape[1]
    tok = torch.argmax(l1, dim=-1).to(torch.int32)
    out, first = [tok], None
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(ticks):
        logits, cache, _ = model.decode_step(params, tok, None, cache, at)
        first = logits if first is None else first
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        at = at + 1
    torch.cuda.synchronize()
    decode_ms = (time.monotonic() - t0) * 1e3
    return (l0.float(), l1.float(), first.float()), torch.stack(out, 1), \
        prefill_ms, decode_ms


def audio_serve_phase(torch):
    """Phase 18: seamless-m4t-large-v2 at its published widths and all 24
    + 24 layers, bf16, served through the model API (audio_sequence; the
    engine's clients send token prompts only).  The launch counters are
    set to 0 just before and read just after the sequence and must be
    exactly the model's: rmsnorm 2 x 24 + 1 for the encoder and 3 x 24 + 1
    a decoder forward, flash attention once a layer of the encoder and
    once a decoder layer of each T > 1 chunk (the cross-attention), chunk
    attention once a decoder layer of each chunk, decode attention twice a
    decoder layer a tick (self and cross); prefill ms, decode tok/s, peak
    memory and, in a torch.profiler window over a shorter sequence, the
    card's busy share; then the logits of the prefill, the continuation
    and the first tick, kernels vs plain, in f32 (held to each other) and
    bf16 (check_precisions); and rows AUDIO_ALONE served alone give the
    tokens they get in the batch (f32, kernels; the bf16 count logged).
    Returns (launch counts, stats)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    t_phase = time.monotonic()
    release(torch)
    cfg = get_config(AUDIO_ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    n_params = sum(t.numel() for t in _leaves(params))
    inputs = audio_inputs(torch, cfg)
    log(f"[seamless-serve] {cfg.name} at all {cfg.enc_layers} + "
        f"{cfg.dec_layers} layers (d_model {cfg.d_model}, {cfg.n_heads} q / "
        f"{cfg.n_kv_heads} kv heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}): {n_params / 1e9:.3f}B params; {AUDIO_ROWS} "
        f"rows of {AUDIO_SRC} frames x {cfg.frontend_dim} + a prompt "
        f"bucket-padded to {AUDIO_PROMPT} at valid {AUDIO_VALID}, a "
        f"{AUDIO_CONT}-token continuation, {AUDIO_TICKS} decode ticks")
    audio_sequence(torch, model, params, inputs, ticks=2)       # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    _, toks, prefill_ms, decode_ms = audio_sequence(torch, model, params,
                                                    inputs, ticks=AUDIO_TICKS)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    Le, Ld = cfg.enc_layers, cfg.dec_layers
    want = {"rmsnorm": 2 * Le + 1 + (3 * Ld + 1) * (2 + AUDIO_TICKS),
            "flash_attention": Le + 2 * Ld, "chunk_attention": 2 * Ld,
            "decode_attention": 2 * Ld * AUDIO_TICKS,
            "flash_attention_backward": 0, "chunk_attention_paged": 0,
            "decode_attention_paged": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"seamless-serve: launch counts {counts}, want {want}")
    if not ((0 <= toks) & (toks < cfg.vocab)).all():
        fail("seamless-serve: a greedy token is out of the vocabulary")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.monotonic()
        audio_sequence(torch, model, params, inputs, ticks=8)
        wall_us = (time.monotonic() - t0) * 1e6
    rows, busy = breakdown(p, wall_us, "seamless-profile",
                           "prefill, continuation and 8 ticks")
    stats = {"prefill_ms": prefill_ms,
             "decode_tok_s": AUDIO_ROWS * AUDIO_TICKS / (decode_ms / 1e3),
             "peak_gb": peak_gb, "busy": busy / wall_us}
    log(f"[seamless-serve] prefill (encode {AUDIO_SRC} frames + "
        f"{AUDIO_PROMPT} tokens) x {AUDIO_ROWS} rows {prefill_ms:.1f} ms, "
        f"{AUDIO_TICKS} decode ticks {decode_ms:.1f} ms "
        f"({stats['decode_tok_s']:.1f} tok/s, {decode_ms / AUDIO_TICKS:.2f} "
        f"ms a tick); peak memory {peak_gb:.1f} GB; busy "
        f"{100 * stats['busy']:.1f}%; launches {json.dumps(counts)}")
    bf16_alone = []
    for r in AUDIO_ALONE:
        alone = audio_sequence(torch, model, params,
                               tuple(x[r:r + 1] for x in inputs),
                               ticks=AUDIO_TICKS)[1]
        bf16_alone.append(int((alone[0] == toks[r]).sum()))
    log(f"[seamless-serve] bf16 rows {list(AUDIO_ALONE)} alone: "
        f"{bf16_alone} of {toks.shape[1]} tokens equal their batch rows' "
        f"(logged: cuBLAS may pick other algorithms for one row, and "
        f"bf16 greedy tokens of random weights follow rounding)")
    del params, model, p, rows
    release(torch)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    out = {}
    for c in (cfg, cfg32):
        params = build_model(c, device="cuda").init(0)
        for impl in ("kernel", "ref"):
            m = build_model(c, impl=impl, device="cuda")
            f32_kernels = c is cfg32 and impl == "kernel"
            res = audio_sequence(torch, m, params, inputs,
                                 ticks=AUDIO_TICKS if f32_kernels else 1)
            out[c.param_dtype, impl] = res[0]
            if f32_kernels:
                for r in AUDIO_ALONE:
                    alone = audio_sequence(
                        torch, m, params, tuple(x[r:r + 1] for x in inputs),
                        ticks=AUDIO_TICKS)
                    if not torch.equal(alone[1][0], res[1][r]):
                        fail(f"seamless-serve: row {r} alone gives other "
                             f"tokens than in its batch (f32): "
                             f"{alone[1][0].tolist()} against "
                             f"{res[1][r].tolist()}")
                log(f"[seamless-serve] f32 kernels: rows {list(AUDIO_ALONE)}"
                    f" served alone give the {res[1].shape[1]} tokens of "
                    f"their batch rows")
            del m, res
        del params
        release(torch)
    check_precisions(torch, "seamless-logits", (AUDIO_ROWS, cfg.vocab),
                     out["bfloat16", "kernel"], out["bfloat16", "ref"],
                     out["float32", "kernel"], out["float32", "ref"],
                     whats=(f"prefill {AUDIO_SRC} frames + {AUDIO_PROMPT} "
                            f"tokens", "continuation without frames",
                            "first decode tick"))
    log(f"[seamless-serve] phase 18: {time.monotonic() - t_phase:.1f}s")
    return counts, stats


def audio_model_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's; no recompute counted) of the
    enc-dec on B rows of S frames and S tokens, as its static-cost edges
    register them: per position and encoder layer the attention
    projections, non-causal attention (4 head_dim S a head) and the MLP;
    per position and decoder layer the self-attention (causal: 4 head_dim
    S/2 a head), the cross-attention (its qkv_proj counted at the query
    length, as the reference registers it; non-causal over the S source
    rows) and the MLP; the lm head.  The frontend projection registers no
    cost (audio_frontend_flops)."""
    d, h = cfg.d_model, cfg.head_dim_
    proj = 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h \
        + 2 * cfg.n_heads * h * d
    mlp = 2 * (3 if cfg.mlp_gated else 2) * d * cfg.d_ff
    attn = 4 * cfg.n_heads * h * S
    enc = proj + attn + mlp
    dec = 2 * proj + attn / 2 + attn + mlp
    return 3.0 * B * S * (cfg.enc_layers * enc + cfg.dec_layers * dec
                          + 2 * d * cfg.vocab)


def audio_frontend_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's) of the frames' projection, which
    registers no static cost: 2 frontend_dim d a frame."""
    return 3.0 * 2 * cfg.frontend_dim * cfg.d_model * B * S


def audio_train_phase(torch):
    """Phase 18b: seamless-m4t-large-v2 at its published widths and all
    24 + 24 layers, batch AUDIO_TRAIN_SHAPE (2048 frames of 1024 features
    and 2048 tokens a row), AUDIO_TRAIN_STEPS steps through cut_train_phase
    (the flash pair non-causal in the encoder and the cross-attention,
    causal in the decoder; MFU held to the static costs and adds the
    frontend projection, which registers none; peak memory); then
    grads_precision_check with frontend/w and the cross-attention's and
    the encoder's leaves among the leaves.  Returns (launch counts, stats)."""
    from repro_torch.configs import get_config
    cfg = get_config(AUDIO_ARCH)
    out = cut_train_phase(torch, cfg, "seamless-train", 18, AUDIO_TRAIN_SHAPE,
                          AUDIO_TRAIN_STEPS, flops=audio_model_flops,
                          unregistered=audio_frontend_flops)
    t0 = time.monotonic()
    grads_precision_check(torch, cfg, "seamless-grads", require=(
        "frontend/w", "enc_stack/stack/attn/wq",
        "dec_stack/stack/cross/attn/wk"))
    log(f"[seamless-grads] {time.monotonic() - t0:.1f}s")
    return out


# ------------------------------------------------------------------ ssm ----
XLSTM_ARCH = "xlstm_1_3b"
#: phase 19 serves 8 of xlstm's 48 blocks (one of its 6 super-blocks),
#: cut for the run's time: all 48 took 42.2 s, 16 made room for phase
#: 21, 8 for phase 23 (phase 19 at 16 blocks 13.6-24.8 s over two hosts;
#: NVIDIA H100 80GB HBM3, 700.00 W); the chunk check keeps all 48
XLSTM_SERVE_LAYERS = 8
#: phase 19b: xlstm trained with the super-blocks rematerialized whole
#: (remat "full"): under the config's dots_saveable every chunk's [B, H,
#: 1024, 1024] f32 state product counts as a matmul output and is kept,
#: ~1.07 GB a mLSTM layer at 4 x 2048, ~45 GB over 42 layers.  Its batch
#: is cut from 4 x 2048 to 4 x 1024 for the run's time: a step is bound
#: by the host's eager launches of the sLSTM loop (4 x 2048: 22.6 s a
#: step, NVIDIA H100 80GB HBM3, 700.00 W); 2 steps (3 took 33.6 s), cut
#: for the run's time; and XLSTM_TRAIN_LAYERS of its 48 blocks (two
#: super-blocks), cut for phase 23 (phase 19b at 48 blocks 24.5-39.0 s
#: over two NVIDIA H100 80GB HBM3 hosts)
XLSTM_TRAIN_STEPS = 2
XLSTM_TRAIN_LAYERS = 16
XLSTM_TRAIN_SHAPE = (4, 1024)
XLSTM_TRAIN_REMAT = "full"
#: phase 19b's gradient check, held to the fixed limits of the other
#: models (f32: HYBRID_LOSS_TOL, HYBRID_GRAD_TOL; bf16: HYBRID_BF16_RATIO)
#: at the published widths and a cut depth: XLSTM_GRAD_LAYERS blocks (one
#: super-block of 7 mLSTM + 1 sLSTM) at batch XLSTM_GRAD_SHAPE.  At random
#: weights xLSTM's gradients move with the last bit of its norms, the
#: more the deeper the model: at 1 x 256 a one-ulp move of every norm
#: scale moves the plain f32 gradient under 1e-4 at 8 blocks and ~1e-1
#: at all 48 (PERF.md §2), so at full depth no fixed limit tells a right
#: gradient from a wrong one (tests/test_torch_xlstm.py: the reference's
#: gradients move as much).  At the cut that move must stay below
#: HYBRID_GRAD_TOL (checked); the full depth's readings, logged only,
#: were cut for the run's time
XLSTM_GRAD_LAYERS = 8
XLSTM_GRAD_SHAPE = (1, 256)
#: phase 19's chunk-width check: a prompt of 512 tokens a row whole, then
#: in four chunks that are no chunk multiple
XLSTM_SPLIT = (100, 200, 150, 62)


def xlstm_dims(cfg):
    """(mLSTM blocks, sLSTM blocks, mLSTM inner width, head width)."""
    n_s = cfg.n_layers // cfg.slstm_every
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    return cfg.n_layers - n_s, n_s, di, di // cfg.n_heads


def xlstm_model_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's) of xLSTM on B rows of S tokens,
    as its static-cost edges register them: per position each mLSTM
    block's projections (up, q/k/v per head, gates, down) and each sLSTM
    block's input and recurrent products, and the lm head."""
    d, H = cfg.d_model, cfg.n_heads
    n_m, n_s, di, ph = xlstm_dims(cfg)
    mlstm = 2 * (d * 2 * di + 3 * di * ph + d * 2 * H + di * d)
    slstm = 2 * (4 * d * d + 4 * d * d / H)
    return 3.0 * B * S * (n_m * mlstm + n_s * slstm + 2 * d * cfg.vocab)


def xlstm_unregistered_flops(cfg, B: int, S: int) -> float:
    """Training FLOPs (3x the forward's) that register no static cost, as
    in the reference: each mLSTM cell's chunkwise products (per position
    and head q k^T and (w . s) v over the chunk, 4 chunk ph, and the
    state's C q and v k^T, 4 ph^2) and each sLSTM block's gated FFN (3
    products of d x 4d/3)."""
    d, H = cfg.d_model, cfg.n_heads
    n_m, n_s, di, ph = xlstm_dims(cfg)
    chunk = min(cfg.ssm_chunk, S)
    cell = H * (4 * chunk * ph + 4 * ph * ph)
    ffn = 2 * 3 * d * int(d * 4 / 3)
    return 3.0 * B * S * (n_m * cell + n_s * ffn)


def xlstm_chunk_check(torch):
    """Phase 19a: full-width xlstm-1.3b in f32 (rmsnorm kernels): a
    512-token prompt a row (4 rows) whole, then as chunks XLSTM_SPLIT
    (bucket-padded to 256 under valid): the relative L2 of the logits and
    of the carried state, mLSTM (C, n, m) and sLSTM (c, n, m, h), within
    HYBRID_F32_TOL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(XLSTM_ARCH), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, impl="kernel", device="cuda")
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(37)
    B, T = 4, sum(XLSTM_SPLIT)
    toks = torch.randint(0, cfg.vocab, (B, T), generator=gen, device="cuda",
                         dtype=torch.int32)
    lw, whole, _ = model.prefill(params, {"tokens": toks}, None,
                                 model.init_cache(B, 0))
    cache, at = model.init_cache(B, 0), 0
    for n in XLSTM_SPLIT:
        chunk = torch.zeros((B, 256), dtype=torch.int32, device="cuda")
        chunk[:, :n] = toks[:, at:at + n]
        lc, cache, _ = model.forward_chunk(
            params, chunk, None, cache, at,
            torch.full((B,), n, dtype=torch.int32, device="cuda"))
        at += n
    torch.cuda.synchronize()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    errs = {"logits": rel(lc.float(), lw.float())}
    for g in ("mlstm", "slstm"):
        for k in whole[g]:
            errs[f"{g}.{k}"] = rel(cache[g][k], whole[g][k])
    log(f"[xlstm] {cfg.name} f32, {B} rows of {T} tokens whole vs chunks "
        f"{list(XLSTM_SPLIT)} (each bucket-padded to 256 under valid): "
        f"relative L2 {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
        f" (tolerance {HYBRID_F32_TOL})")
    if not all(math.isfinite(v) and v <= HYBRID_F32_TOL
               for v in errs.values()):
        fail(f"xlstm: the chunked prompt's logits or state differ from the "
             f"whole prompt's: {errs}")
    del params, model, whole, cache
    release(torch)


def xlstm_serve_phase(torch):
    """Phase 19: xlstm-1.3b at its published widths and all 48 blocks
    (6 super-blocks of 7 mLSTM + 1 sLSTM), bf16: the chunk-width check
    (xlstm_chunk_check), then at XLSTM_SERVE_LAYERS blocks the 16
    requests of phase 5 through the engine's contiguous recurrent state
    (serve_run: rmsnorm the only kernel, 2 n_super + n_mLSTM + 1 launches
    a forward), with tok/s, TTFT, decode gap and peak memory.  Returns
    (launch counts, stats)."""
    import dataclasses
    from repro_torch.configs import get_config

    t_phase = time.monotonic()
    release(torch)
    xlstm_chunk_check(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(XLSTM_ARCH)
    log(f"[xlstm-serve] served at {XLSTM_SERVE_LAYERS} of its "
        f"{cfg.n_layers} blocks, cut for the run's time")
    engine, done, counts, stats, _ = serve_run(
        torch, "xlstm-serve",
        cfg=dataclasses.replace(cfg, n_layers=XLSTM_SERVE_LAYERS))
    stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[xlstm-serve] peak memory {stats['peak_gb']:.1f} GB; phase 19 "
        f"serve: {time.monotonic() - t_phase:.1f}s")
    del engine, done
    release(torch)
    return counts, stats


def grad_spread(torch, cfg16, tag: str, shape) -> dict:
    """How far xLSTM's gradients move, logged: one loss_fn + backward of
    `cfg16` at batch `shape`, and per leaf the relative L2 from the f32
    plain gradient of the f32 kernels' gradient, of the f32 plain one when
    every norm scale moves by one f32 ulp (seeded signs), and of the bf16
    plain and kernel gradients.  Returns the largest of each over the
    leaves."""
    import dataclasses
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.runtime.trainer import value_and_grad
    from repro_torch.tree import leaves_with_path, map_with_path

    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    B, S = shape
    batch = SyntheticLMData(cfg16, B, S, seed=1).generate(0)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def moved(path, t):
        if "norm" not in path:
            return t
        inf = torch.full_like(t, math.inf)
        up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
        return torch.nextafter(t, torch.where(up, inf, -inf))

    def grads(cfg, impl, params):
        model = build_model(cfg, impl=impl, device="cuda")
        g = value_and_grad(model, params, batch, None)[3]
        return {n: v.float() for n, v in leaves_with_path(g)}

    p32 = build_model(cfg32, device="cuda").init(0)
    want = grads(cfg32, "ref", p32)
    runs = {"f32 kernels": grads(cfg32, "kernel", p32),
            "f32 plain with the norms moved one ulp": grads(
                cfg32, "ref", map_with_path(moved, p32))}
    del p32
    p16 = build_model(cfg16, device="cuda").init(0)
    runs["bf16 plain"] = grads(cfg16, "ref", p16)
    runs["bf16 kernels"] = grads(cfg16, "kernel", p16)
    del p16
    worst = {}
    for what, g in runs.items():
        d = [((g[n] - w).norm() / w.norm()).item() for n, w in want.items()]
        worst[what] = max(d)
        log(f"[{tag}] {cfg16.n_layers} blocks, batch {B} x {S}: {what}, "
            f"relative L2 from the f32 plain gradient {min(d):.3e}.."
            f"{max(d):.3e} over {len(d)} leaves")
    del runs, want
    torch.cuda.empty_cache()
    return worst


def xlstm_train_phase(torch):
    """Phase 19b: xlstm-1.3b at its published widths and
    XLSTM_TRAIN_LAYERS blocks, batch XLSTM_TRAIN_SHAPE, XLSTM_TRAIN_STEPS
    steps through
    cut_train_phase at remat XLSTM_TRAIN_REMAT (rmsnorm and its backward
    the only kernels; MFU held to the static costs, plus the cells'
    chunkwise products and the sLSTM FFN, which register none; the
    no profiled step); then grads_precision_check at XLSTM_GRAD_LAYERS
    blocks and XLSTM_GRAD_SHAPE, where a one-ulp move of the norms must
    move the plain f32 gradient less than HYBRID_GRAD_TOL (grad_spread).
    Returns (launch counts, stats)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(XLSTM_ARCH),
                              n_layers=XLSTM_TRAIN_LAYERS,
                              remat=XLSTM_TRAIN_REMAT)
    out = cut_train_phase(torch, cfg, "xlstm-train", 19, XLSTM_TRAIN_SHAPE,
                          XLSTM_TRAIN_STEPS, flops=xlstm_model_flops,
                          unregistered=xlstm_unregistered_flops,
                          kernels=("rmsnorm", "rmsnorm_backward"),
                          profile=False)
    t0 = time.monotonic()
    cut = dataclasses.replace(cfg, n_layers=XLSTM_GRAD_LAYERS)
    moved = grad_spread(torch, cut, "xlstm-grads", XLSTM_GRAD_SHAPE)[
        "f32 plain with the norms moved one ulp"]
    if moved >= HYBRID_GRAD_TOL:
        fail(f"xlstm-grads: at {XLSTM_GRAD_LAYERS} blocks a one-ulp move of "
             f"the norms moves the plain gradient {moved:.3e}, not below "
             f"the check's limit {HYBRID_GRAD_TOL}")
    grads_precision_check(torch, cut, "xlstm-grads", require=(
        "stack_mlstm/stack/mlstm/w_q", "stack_slstm/stack/slstm/r_i"),
        shape=XLSTM_GRAD_SHAPE)
    log(f"[xlstm-grads] {time.monotonic() - t0:.1f}s")
    return out


# ------------------------------------------------------------ mesh train ----
#: phase 20: tinyllama_1_1b at its published widths under --mesh, through
#: the launcher under torchrun.  One card: NCCL takes one rank per card,
#: so the two ranks share it over gloo with CUDA tensors.  Every run takes
#: 2 microbatches with the deferred gradient reduce and int8 compression,
#: the one-rank run included, so the three runs compute one function
MESH_ARCH = "tinyllama_1_1b"
#: the depth of phase 20's runs: 4 of tinyllama's 22 layers, cut for the
#: run's time alone (all 22 took phases 20 and 20b 186-270 s, 8 layers
#: and 3 steps 150.8 s; NVIDIA H100 80GB HBM3, 700.00 W); 2 steps, the
#: second the recorded one
MESH_LAYERS = 4
MESH_SHAPE = (4, 1024)                  # B, S of the launcher runs
MESH_STEPS = 2
MESH_FLAGS = ("--microbatches", "2", "--deferred-grad-reduce",
              "--grad-compression", "int8")
MESH_RUNS = (("one", None), ("tp", "1x2"), ("dp", "2x1"))
#: the launcher's mesh worlds of each of phases 20, 22 and 23 run at
#: once, after that phase's one-rank runs: a world spends most of its
#: ~20-49 s starting up and in its first step, on the host (NVIDIA H100
#: 80GB HBM3, 700.00 W; PERF.md §4), and the worlds' peaks fit the card
#: together (phase 23's three 24.1 + 18.8 + 14.4 GB, phase 22's two 24.7
#: + 19.1); their step times, logged only, include the others' load
#: each step's loss, a mesh run against the one-rank run: the first step
#: is the same weights and tokens summed in another order (~1e-3 in bf16);
#: later ones also carry that noise through AdamW's first, sign-like
#: updates and the int8 quantizer's rounding, so 1e-2 as phase 6's
#: kernels-vs-plain loss limit
MESH_LOSS_REL_TOL = 1e-2
#: the kernels each training rank must launch
MESH_KERNELS = ("rmsnorm", "rmsnorm_backward", "flash_attention",
                "flash_attention_backward")
MESH_GRAD_SHAPE = (2, 1024)             # B, S: one row a data rank at 2x1
MESH_GRAD_LOSS_TOL = 1e-4               # f32, relative
MESH_TIMEOUT_S = 600                    # a launcher run's / the world's limit
#: phase 20b: context-parallel decode over two ranks, each holding half of
#: the cache; rows 0-4 leave rank 1's half empty
CP_SHAPE = (8, 32, 4, 2048, 64)         # B, Hq, Hkv, S, D
CP_POS = (0, 1, 77, 1000, 1023, 1024, 1537, 2047)
CP_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # abs + rel, as KERNEL_TOL
#: XFA's L3 flows of each mesh run's recorded step: (component, kind,
#: axis) sites that must hold at least one collective
MESH_FLOW_SITES = {
    "tp": (("attention", "all-reduce", "model"),
           ("loss", "all-reduce", "model")),
    "dp": (("grads", "all-reduce", "data"),
           ("optimizer", "all-gather", "data")),
    "ep": (("moe", "all-to-all", "model"), ("moe", "all-gather", "model"),
           ("attention", "all-reduce", "model"))}
#: the launcher's report opens its collectives section with this line
FLOWS_HEAD = "Collective flows (wire bytes/device/step):"


class Group(NamedTuple):
    """A command running in its own process group (`start_group`)."""
    proc: Any
    what: str
    t0: float
    log: Path


def start_group(cmd, what: str, log: Path) -> Group:
    """Start `cmd` in its own process group (torchrun and its ranks), its
    standard output and errors to `log` (a pipe nobody reads while the
    group runs could fill and stall it)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="4")
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=f,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
    return Group(p, what, time.monotonic(), log)


def wait_group(g: Group, timeout_s: float = MESH_TIMEOUT_S) -> str:
    """Wait for a started group; on its time limit (from its start) the
    whole group is killed.  Returns its output; a non-zero exit fails
    the run."""
    import signal
    try:
        g.proc.wait(timeout=max(timeout_s - (time.monotonic() - g.t0), 1))
    except subprocess.TimeoutExpired:
        os.killpg(g.proc.pid, signal.SIGKILL)
        g.proc.wait()
        fail(f"{g.what}: not done in {timeout_s}s (killed)")
    out = g.log.read_text()
    if g.proc.returncode != 0:
        fail(f"{g.what}: exited {g.proc.returncode}: {out[-3000:]}")
    return out


def start_launcher(args, mesh: str, what: str, log: Path) -> Group:
    """The train launcher with `args` under --mesh `mesh` (two ranks
    sharing the card over gloo), started by torchrun in its own process
    group (`wait_group` collects it)."""
    return start_group([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", str(math.prod(
                            int(x) for x in mesh.split("x"))), "-m",
                        "repro_torch.launch.train", *args, "--mesh", mesh,
                        "--dist-backend", "gloo"], what, log)


def run_launcher(torch, args, what: str) -> str:
    """The train launcher with `args` on one rank, in this process
    (`launch.train.main`; a fresh process's start-up and first step took
    15-22 s of each one-rank reference run), its launch counters and
    peak memory reset first.  Returns its standard output."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    release(torch)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    argv, sys.argv = sys.argv, ["repro_torch.launch.train", *args]
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            rc = launcher.main()
    finally:
        sys.argv = argv
    if rc != 0:
        fail(f"{what}: the launcher returned {rc}")
    release(torch)
    return out.getvalue()


def mesh_train_phase(torch):
    """Phase 20: the launcher trains tinyllama_1_1b at its published
    widths (MESH_LAYERS layers) for MESH_STEPS steps of MESH_SHAPE, first on
    one rank, then under --mesh 1x2 (tensor parallel 2) and 2x1 (data
    parallel 2, ZeRO-1), two ranks sharing the card over gloo; each mesh
    run's losses are held to the one-rank run's, and each rank must
    launch the training kernels on its shard.  Its gradient check and
    phase 20b run in phase 22's spawned world (`mesh_grads_rank`).
    Returns {rank: launches} of the mesh runs."""
    from repro_torch.configs import get_config

    t_phase = time.monotonic()
    release(torch)
    cfg = get_config(MESH_ARCH)
    B, S = MESH_SHAPE
    log(f"[mesh-train] {cfg.name} at its published widths, cut from "
        f"{cfg.n_layers} to {MESH_LAYERS} layers for the run's time alone, "
        f"batch {B} x {S}, "
        f"{MESH_STEPS} steps, {' '.join(MESH_FLAGS)}; meshes on one card: "
        f"two ranks sharing one card over gloo (NCCL takes one rank per "
        f"card)")
    common = ["--arch", MESH_ARCH, "--device", "cuda", "--layers",
              str(MESH_LAYERS), "--steps", str(MESH_STEPS), "--batch",
              str(B), "--seq", str(S), "--ckpt-interval", "0", *MESH_FLAGS]

    def run_args(tag):
        d = RUN_ROOT / "mesh" / tag
        return d, [*common, "--ckpt-dir", str(d / "ckpt"), "--metrics-out",
                   str(d / "metrics"), "--profile-dir", str(d / "prof")]

    t0 = time.monotonic()
    outs = {"one": run_launcher(torch, run_args("one")[1],
                                "mesh-train one")}
    walls = {"one": time.monotonic() - t0}
    # the 1x2 and 2x1 worlds at once (MESH_RUNS' note)
    worlds = {tag: start_launcher(run_args(tag)[1], mesh,
                                  f"mesh-train {tag}",
                                  RUN_ROOT / "mesh" / f"{tag}.log")
              for tag, mesh in MESH_RUNS if mesh}
    for tag, g in worlds.items():
        outs[tag] = wait_group(g)
        walls[tag] = time.monotonic() - g.t0
    runs = {}
    for tag, mesh in MESH_RUNS:
        d, out = run_args(tag)[0], outs[tag]
        n = math.prod(int(x) for x in mesh.split("x")) if mesh else 1
        for line in out.splitlines():
            if line.startswith("[mesh]"):
                log(f"[mesh-train] {tag}: {line}")
        ranks = []
        for r in range(n):
            with open(d / "metrics" / f"rank{r}.json") as f:
                ranks.append(json.load(f))
        runs[tag] = ranks
        log(f"[mesh-train] {tag} ({mesh or 'one rank, in this process'}): "
            f"{n} rank(s), {walls[tag]:.1f}s wall incl. start-up")
        if mesh and FLOWS_HEAD not in out:
            fail(f"mesh-train {tag}: rank 0's report shows no collective "
                 f"flows")
    base = [h["loss"] for h in runs["one"][0]["history"]]
    launches = {}
    for tag, mesh in MESH_RUNS:
        for m in runs[tag]:
            r, hist = m["rank"], m["history"]
            losses = [h["loss"] for h in hist]
            if len(losses) != MESH_STEPS or not all(
                    math.isfinite(h[k]) for h in hist
                    for k in ("loss", "grad_norm")):
                fail(f"mesh-train {tag} rank {r}: history {hist}")
            errs = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
            if max(errs) > MESH_LOSS_REL_TOL:
                fail(f"mesh-train {tag} rank {r}: losses {losses} vs the "
                     f"one-rank run's {base}: relative errors {errs} "
                     f"(limit {MESH_LOSS_REL_TOL})")
            missing = [k for k in MESH_KERNELS if m["launches"][k] <= 0]
            if missing:
                fail(f"mesh-train {tag} rank {r}: kernels {missing} were "
                     f"not launched: {m['launches']}")
            c = m["collectives"]
            if mesh and (c["all_reduce"] <= 0 or (
                    tag == "dp" and c["all_gather"] <= 0)):
                fail(f"mesh-train {tag} rank {r}: collectives {c}")
            step_ms = statistics.median(h["step_s"] for h in hist[1:]) * 1e3
            log(f"[mesh-train] {tag} rank {r}: losses "
                f"{[round(x, 5) for x in losses]} (relative to one rank: "
                f"{[f'{e:.2e}' for e in errs]}), grad norms "
                f"{[round(h['grad_norm'], 4) for h in hist]}; step times "
                f"(s) {[round(h['step_s'], 3) for h in hist]}, median after "
                f"the first {step_ms:.1f} ms ({'two ranks sharing one card '
                'over gloo' if mesh else 'one rank'}; no measure of parallel "
                f"speed) on {device_line()}")
            log(f"[mesh-train] {tag} rank {r}: kernel launches "
                f"{json.dumps(m['launches'])}; collectives {json.dumps(c)}")
            if mesh:
                launches[f"{tag} rank {r}"] = m["launches"]
                check_flows(f"mesh-train {tag} rank {r}", m,
                            MESH_FLOW_SITES[tag])
    log(f"[mesh-train] phase 20 launcher runs (its gradient check and "
        f"phase 20b run in phase 22's world): "
        f"{time.monotonic() - t_phase:.1f}s")
    return launches


def spawn_world(target, d: Path, what: str):
    """Run `target(rank, 2, str(d))` in 2 spawned ranks; any rank that
    fails fails the run at once (its peer is killed).  Returns each
    rank's <d>/rank<r>.json."""
    import multiprocessing as mp

    d.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, 2, str(d)))
             for r in range(2)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() - t0 > MESH_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        fail(f"{what}: ranks exited {codes} after "
             f"{time.monotonic() - t0:.1f}s")
    log(f"[{what}] the world of 2 ranks: {time.monotonic() - t0:.1f}s")
    out = []
    for r in range(2):
        with open(d / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def mesh_world_launches(res: dict, r: int) -> dict:
    """Phase 20's gradient check's and phase 20b's launches on rank `r`
    of phase 22's world (`mesh_grads_rank`), checked and logged."""
    log(f"[mesh-grads] rank {r}: kernel launches "
        f"{json.dumps(res['grad_launches'])}")
    log(f"[cp-decode] rank {r}: kernel launches "
        f"{json.dumps(res['cp_launches'])}")
    if res["cp_launches"]["decode_attention"] <= 0:
        fail(f"cp-decode: rank {r} launched no decode kernel")
    return {f"grads rank {r}": res["grad_launches"],
            f"cp rank {r}": res["cp_launches"]}


def mesh_grads(torch, rank: int) -> None:
    """Phase 20, gradients: one loss_fn + backward of tinyllama_1_1b at
    its published widths and MESH_LAYERS layers, batch MESH_GRAD_SHAPE, under
    1x2 and 2x1 (the gradient summed over 'data', gathered over 'model'),
    in f32 and bf16.  Rank 0 holds each against its own one-rank runs:
    f32 against the f32 kernel run (loss MESH_GRAD_LOSS_TOL relative,
    each leaf HYBRID_GRAD_TOL relative L2), bf16 no further from the f32
    plain gradient than the one-rank bf16 kernel run's, within
    HYBRID_BF16_RATIO (PERF.md §2's rule)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import gather_tree, shard_tree
    from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                             local_value_and_grad,
                                             value_and_grad)
    from repro_torch.tree import leaves_with_path, tree_map

    cfg16 = dataclasses.replace(get_config(MESH_ARCH), n_layers=MESH_LAYERS)
    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    B, S = MESH_GRAD_SHAPE
    batch = SyntheticLMData(cfg16, B, S, seed=1).generate(0)
    p32 = build_model(cfg32, device="cuda").init(0)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
    full = {"float32": (cfg32, p32), "bfloat16": (cfg16, p16)}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    refs = {}
    if rank == 0:
        # one-rank references; these launches are comparisons, not counted
        saved = ops.launch_counts()
        for tag, (cfg, params), impl in (
                ("plain32", full["float32"], "ref"),
                ("kern32", full["float32"], "auto"),
                ("kern16", full["bfloat16"], "auto")):
            loss, _, _, g = value_and_grad(
                build_model(cfg, impl=impl, device="cuda"), params, batch,
                None)
            refs[tag] = (float(loss), dict(leaves_with_path(g)))
        for fn in ops._KERNELS:
            fn.launches = saved[fn.__name__]
    for shape in ((1, 2), (2, 1)):
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        tag = "x".join(map(str, shape))
        for dtype in ("float32", "bfloat16"):
            cfg, params = full[dtype]
            model = build_model(cfg, device="cuda")
            t0 = time.monotonic()
            with runtime_mesh(mesh):
                lay = TrainLayout(model, full_shapes(cfg), mesh)
                local = shard_tree(params, mesh, lay.param)
                loss, _, _, g = local_value_and_grad(
                    model, local, lay.local_rows(batch, 1), None, lay)
                # summed over 'data' in f32, as the trainer sums them
                g = tree_map(lambda x: mesh_lib.all_reduce(
                    x.float(), mesh, lay.batch_axes), g)
                g = dict(leaves_with_path(gather_tree(g, mesh, lay.param)))
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            del local
            if rank != 0:
                continue
            if dtype == "float32":
                want_loss, want = refs["kern32"]
                lerr = abs(float(loss) - want_loss) / abs(want_loss)
                errs = {n: rel(g[n], want[n]) for n in want}
                worst = max(errs, key=errs.get)
                log(f"[mesh-grads] {tag} f32: loss {float(loss):.6f} vs one "
                    f"rank {want_loss:.6f} (relative {lerr:.2e}); worst leaf "
                    f"{worst} {errs[worst]:.2e} relative L2; {wall:.1f}s")
                if lerr > MESH_GRAD_LOSS_TOL or errs[worst] > HYBRID_GRAD_TOL:
                    fail(f"mesh-grads {tag} f32: loss {lerr:.2e} (limit "
                         f"{MESH_GRAD_LOSS_TOL}), {worst} {errs[worst]:.2e} "
                         f"(limit {HYBRID_GRAD_TOL})")
            else:
                plain, one = refs["plain32"][1], refs["kern16"][1]
                ratios = {n: rel(g[n], plain[n]) / max(rel(one[n], plain[n]),
                                                       1e-30)
                          for n in plain}
                worst = max(ratios, key=ratios.get)
                log(f"[mesh-grads] {tag} bf16: loss {float(loss):.6f} vs one "
                    f"rank {refs['kern16'][0]:.6f}; worst leaf {worst}: "
                    f"{rel(g[worst], plain[worst]):.3e} from f32 plain vs "
                    f"the one-rank bf16 run's "
                    f"{rel(one[worst], plain[worst]):.3e} (ratio "
                    f"{ratios[worst]:.3f}, limit {HYBRID_BF16_RATIO}); "
                    f"{wall:.1f}s")
                if ratios[worst] > HYBRID_BF16_RATIO:
                    fail(f"mesh-grads {tag} bf16: {worst} ratio "
                         f"{ratios[worst]:.3f} > {HYBRID_BF16_RATIO}")
            del g
    del refs


def cp_decode(torch, rank: int) -> None:
    """Phase 20b: context-parallel decode at CP_SHAPE, the cache's
    sequence split over 2 ranks (rank 1's half empty for rows 0-4), in
    bf16 and f32, against the one-rank decode kernel on the whole cache
    (rank 0), each entry within CP_TOL abs + rel."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.context import context_parallel_decode

    B, Hq, Hkv, S, D = CP_SHAPE
    mesh = mesh_lib.make_mesh((2, 1), ("data", "model"))
    c, half = mesh.coord("data"), S // 2
    pos = torch.tensor(CP_POS, dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(20)
        q = torch.randn(B, Hq, D, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, Hkv, S, D, generator=gen, device="cuda").to(dtype)
        kl = k[:, :, c * half:(c + 1) * half].contiguous()
        vl = v[:, :, c * half:(c + 1) * half].contiguous()
        got = context_parallel_decode(q, kl, vl, pos, mesh)
        torch.cuda.synchronize()
        if rank != 0:
            continue
        saved = ops.launch_counts()
        want = ops.decode_attention(q, k, v, kv_len=pos + 1)
        for fn in ops._KERNELS:
            fn.launches = saved[fn.__name__]
        name = str(dtype)[6:]
        err = (got.float() - want.float()).abs()
        lim = CP_TOL[name] * (1 + want.float().abs())
        log(f"[cp-decode] {name} q [{B},{Hq},{D}], k/v [{B},{Hkv},{S},{D}] "
            f"over 2 ranks (kv_len {list(CP_POS)} + 1): max abs err "
            f"{float(err.max()):.3e} vs the one-rank decode kernel (limit "
            f"{CP_TOL[name]} abs + rel)")
        if not torch.isfinite(got).all() or bool((err > lim).any()):
            fail(f"cp-decode {name}: max abs err {float(err.max()):.3e}")




def check_flows(what: str, m: dict, sites, a2a=None) -> None:
    """XFA's L3 flows of the step a mesh rank's Trainer recorded (the
    launcher's metrics): per kind as many as `collective_counts()` over
    the step; no collective of the model in `app`; each of `sites`
    (component, kind, axis) holds one at least; with a2a = (count,
    input bytes), every all-to-all sits under `moe` on 'model' with
    those bytes, `count` of them."""
    import collections
    from repro_torch.parallel.mesh import flow_kind_counts
    rec = m.get("collective_flows")
    if not rec:
        fail(f"{what}: no recorded flows")
    flows = rec["flows"]
    kinds = dict(collections.Counter(f["kind"] for f in flows))
    want = flow_kind_counts(rec["collectives"])
    if kinds != want:
        fail(f"{what}: recorded flows per kind {kinds}, collective_counts "
             f"over the step {want}")
    app = [f for f in flows if f["component"] == "app"]
    if app:
        fail(f"{what}: {len(app)} collectives resolve to app: {app[:3]}")
    sites_seen = collections.Counter((f["component"], f["kind"], f["axis"])
                                     for f in flows)
    missing = [s for s in sites if not sites_seen[s]]
    if missing:
        fail(f"{what}: no collective at {missing}: {dict(sites_seen)}")
    if a2a is not None:
        count, nbytes = a2a
        got = [f for f in flows if f["kind"] == "all-to-all"]
        bad = [f for f in got if (f["component"], f["axis"],
                                  f["input_bytes"]) != ("moe", "model",
                                                        nbytes)]
        if len(got) != count or bad:
            fail(f"{what}: {len(got)} all-to-alls (want {count}), "
                 f"{len(bad)} not moe@model at {nbytes} B: {bad[:2]}")
    summ = rec["summary"]
    log(f"[flows] {what}: step {rec['step']}, {len(flows)} collectives "
        f"{json.dumps(want)}; by (component, kind, axis) "
        f"{ {'/'.join(k): n for k, n in sorted(sites_seen.items())} }; "
        f"wire bytes/device by component "
        f"{ {k: round(v) for k, v in summ['by_component'].items()} }, by "
        f"axis {summ['by_axis']}, total {summ['total_wire_bytes']:.0f}")


# -------------------------------------------------------- moe mesh train ----
#: phase 21: phi3_5_moe_42b at its published widths under --mesh 1x2
#: (expert parallel 2 over 'model', the attention and the vocab tensor
#: parallel 2), through the launcher under torchrun, against one rank;
#: the two ranks share the card over gloo, as phase 20's
MOE_MESH_LAYERS = MOE_TRAIN_LAYERS
MOE_MESH_SHAPE = (2, 1024)              # B, S of the launcher runs
MOE_MESH_STEPS = 3
#: drop-free in both runs: at capacity_factor 8 one rank's capacity is
#: int(T 2 / 16 x 8) = T and a shard's max(8, int(t_loc 2 / 16 x 8)) =
#: t_loc, and no expert gets more than one choice of a token
MOE_MESH_CF = MOE_DROP_FREE
MOE_MESH_GRAD_SHAPE = (1, 1024)         # B, S of the gradient check
#: the gradient check's depth: one MoE layer (2 and the leaves' gathers
#: took 48.1 s of the world, PR 30), cut for the run's time
MOE_MESH_GRAD_LAYERS = 1
#: all-to-alls a layer and step: the dispatch and the return in the
#: forward, again in remat's recompute (dots_saveable recomputes both:
#: their outputs are no matmul's), and their inverses in the backward
MOE_A2A_PER_LAYER = 6


class MeshCase(NamedTuple):
    """One model trained through the launcher on one rank and at --mesh
    1x2 (two ranks sharing the card over gloo) and checked against the
    one-rank run (`mesh_case_phase`), then its gradient at 1x2 against
    one rank's in a spawned world (`mesh_case_grads`)."""
    key: str                # the launches' keys and the run dir's name
    arch: str
    layers: int
    shape: Tuple[int, int]  # B, S of the launcher runs
    steps: int
    grad_shape: Tuple[int, int]
    #: the gradient check's depth (0: `layers`)
    grad_layers: int
    #: kernels each rank of the 1x2 run must launch
    kernels: Tuple[str, ...]
    #: (component, kind, axis) flow sites of the 1x2 run's recorded step
    sites: Tuple[Tuple[str, str, str], ...]
    #: the local shapes each rank's kernels take at 1x2, as `local_shapes`
    #: records them: every shape of the kinds named here and of
    #: LOCAL_KINDS (a case that names none of those takes none)
    local: FrozenSet[Tuple[Any, ...]]
    capacity_factor: float = 0.0
    #: an MoE model's bf16 gradient also unpinned (logged only)
    unpinned: bool = True
    mesh_tag: str = "1x2"
    #: the launcher runs write profile dirs (phase 9 reads phase 21's)
    profile: bool = False

    def cfg(self, layers: int = 0):
        """The config at `layers` (0: self.layers), cut as the launcher's
        --layers cuts it (an enc-dec to half encoder, half decoder)."""
        from repro_torch.configs import get_config
        from repro_torch.launch.train import cut_depth
        cfg = cut_depth(get_config(self.arch), layers or self.layers)
        if self.capacity_factor:
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=self.capacity_factor)
        return cfg


MOE_MESH = MeshCase(
    key="moe", arch=MOE_ARCH, layers=MOE_MESH_LAYERS, shape=MOE_MESH_SHAPE,
    steps=MOE_MESH_STEPS, grad_shape=MOE_MESH_GRAD_SHAPE,
    grad_layers=MOE_MESH_GRAD_LAYERS,
    kernels=MESH_KERNELS, sites=MESH_FLOW_SITES["ep"],
    local=frozenset({("attention", 16, 128, 128)}),
    capacity_factor=MOE_MESH_CF,
    unpinned=False, mesh_tag="ep", profile=True)

# --------------------------------------------------- family mesh train ----
#: phase 22: deepseek-v2-lite (MLA + 64 experts top 6 + 2 shared) and
#: zamba2-2.7b (the Mamba2 hybrid) at their published widths under --mesh
#: 1x2 through the launcher, against one rank, as phase 21.  deepseek at 2
#: of 27 layers (the dense one and one MoE layer), drop-free at
#: capacity_factor 11 >= 64 / 6 (a shard's capacity max(8, int(t_loc 6 /
#: 64 x 11)) >= t_loc); zamba2 at 12 of 54 layers (two super-blocks, so
#: the tied block's gradient sums over two calls); 2 steps each (the
#: second is the recorded one) of batch 2 x 1024
FAMILY_MESH_SHAPE = (2, 1024)
FAMILY_MESH_STEPS = 2
FAMILY_MESH = (
    MeshCase(key="deepseek", arch=MLA_ARCH, layers=2,
             shape=FAMILY_MESH_SHAPE, steps=FAMILY_MESH_STEPS,
             grad_shape=(1, 1024), grad_layers=0, kernels=MESH_KERNELS,
             sites=(("attention", "all-reduce", "model"),
                    ("moe", "all-to-all", "model"),
                    ("mlp", "all-reduce", "model")),
             local=frozenset({("attention", 8, 192, 128)}),
             capacity_factor=MLA_DROP_FREE),
    MeshCase(key="zamba2", arch="zamba2_2_7b", layers=12,
             shape=FAMILY_MESH_SHAPE, steps=FAMILY_MESH_STEPS,
             grad_shape=(1, 1024), grad_layers=0,
             kernels=MESH_KERNELS + ("ssd_scan", "ssd_scan_backward"),
             sites=(("ssm", "all-reduce", "model"),
                    ("ssm", "all-gather", "model"),
                    ("attention", "all-reduce", "model")),
             local=frozenset({("attention", 16, 80, 80),
                              ("ssd_scan", 40)})))
#: phase 23: internvl2-1b (vlm), seamless-m4t-large-v2 (audio enc-dec)
#: and xlstm-1.3b (ssm) at their published widths under --mesh 1x2
#: through the launcher, against one rank, as phase 22, 2 steps of batch
#: 2 x 1024 each.  internvl at all 24 layers (its 1024 positions a row
#: hold the 256 patches' prefix); seamless at 4 + 4 of its 24 + 24
#: layers and xlstm at one super-block (8 of 48 blocks), cut for the
#: run's time; the gradient checks at 2 layers (1 + 1) and at one
#: super-block of 1 x 256 (as phase 19b's)
MODAL_MESH = (
    MeshCase(key="internvl", arch="internvl2_1b", layers=24,
             shape=FAMILY_MESH_SHAPE, steps=FAMILY_MESH_STEPS,
             grad_shape=(1, 1024), grad_layers=2, kernels=MESH_KERNELS,
             sites=(("embed", "all-gather", "model"),
                    ("attention", "all-reduce", "model"),
                    ("mlp", "all-reduce", "model")),
             local=frozenset({("attention", 7, 64, 64),
                              ("heads", 7, 1, True), ("rmsnorm", 896)})),
    MeshCase(key="seamless", arch="seamless_m4t_large_v2", layers=8,
             shape=FAMILY_MESH_SHAPE, steps=FAMILY_MESH_STEPS,
             grad_shape=(1, 1024), grad_layers=2, kernels=MESH_KERNELS,
             sites=(("embed", "all-gather", "model"),
                    ("attention", "all-reduce", "model"),
                    ("mlp", "all-reduce", "model")),
             local=frozenset({("attention", 8, 64, 64),
                              ("heads", 8, 8, True), ("heads", 8, 8, False),
                              ("rmsnorm", 1024)})),
    MeshCase(key="xlstm", arch=XLSTM_ARCH, layers=8,
             shape=FAMILY_MESH_SHAPE, steps=FAMILY_MESH_STEPS,
             grad_shape=XLSTM_GRAD_SHAPE, grad_layers=0,
             kernels=("rmsnorm", "rmsnorm_backward"),
             sites=(("mlstm", "all-reduce", "model"),
                    ("slstm", "all-gather", "model"),
                    ("slstm", "all-reduce", "model")),
             local=frozenset({("rmsnorm", 2048)})))
MESH_CASES = {c.key: c for c in (MOE_MESH,) + FAMILY_MESH + MODAL_MESH}
#: phase 3i: the flash pair at internvl2's local heads at 1x2 (7 q over
#: 1 kv head of 64), at the batch of its phase 23 runs, timed; its
#: launches are internvl's rank 0 at 1x2
MODAL_FLASH_KEY = "g7_hkv1"
MODAL_FLASH = (7, 1, 64)                 # Hq, Hkv, D
MODAL_FLASH_SHAPE = FAMILY_MESH_SHAPE    # B, S


def mesh_state_gb(cfg, mesh_shape):
    """(params, GB of train state) of one rank at `mesh_shape`: its slice
    of every leaf (`layout_tree`: tensor and expert parallel over
    'model', the hybrid's B and C columns whole) x (2 bytes of bf16 param
    + 2 of bf16 gradient + 12 of f32 master, mu and nu)."""
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import layout_tree, local_shape
    from repro_torch.runtime.trainer import full_shapes
    from repro_torch.tree import leaves_with_path
    mesh = Mesh(mesh_shape, ("data", "model"))
    shapes = full_shapes(cfg)
    specs = dict(leaves_with_path(layout_tree(shapes, mesh, cfg)))
    n = sum(math.prod(local_shape(x.shape, specs[k], mesh))
            for k, x in leaves_with_path(shapes))
    return n, n * 16 / 1e9


def mesh_case_args(case: MeshCase, tag: str):
    """(run dir, launcher args) of `case`'s run `tag` ("one" or its mesh
    tag)."""
    d = RUN_ROOT / f"{case.key}-mesh" / tag
    B, S = case.shape
    args = ["--arch", case.arch, "--device", "cuda", "--layers",
            str(case.layers), "--steps", str(case.steps), "--batch", str(B),
            "--seq", str(S), "--ckpt-interval", "0", "--ckpt-dir",
            str(d / "ckpt"), "--metrics-out", str(d / "metrics")]
    if case.capacity_factor:
        args += ["--capacity-factor", str(case.capacity_factor)]
    if case.profile:
        args += ["--profile-dir", str(d / "prof")]
    return d, args


def mesh_case_one(torch, case: MeshCase):
    """`case`'s one-rank launcher run, in this process: (its output, its
    wall seconds)."""
    t0 = time.monotonic()
    out = run_launcher(torch, mesh_case_args(case, "one")[1],
                       f"{case.key}-mesh one")
    return out, time.monotonic() - t0


def mesh_case_world(case: MeshCase) -> Group:
    """Start `case`'s --mesh 1x2 launcher run (torchrun, in the
    background)."""
    d, args = mesh_case_args(case, case.mesh_tag)
    return start_launcher(args, "1x2", f"{case.key}-mesh {case.mesh_tag}",
                          d.parent / f"{case.mesh_tag}.log")


def mesh_cases_together(torch, cases, phase: str):
    """`mesh_case_phase` of `cases`: their one-rank runs first, then their
    1x2 worlds all at once (MESH_RUNS' note).  Returns {key:
    launches}."""
    ones = [mesh_case_one(torch, c) for c in cases]
    worlds = [mesh_case_world(c) for c in cases]
    launches = {}
    for c, one, world in zip(cases, ones, worlds):
        launches.update(mesh_case_phase(torch, c, phase, one, world))
    return launches


def mesh_case_phase(torch, case: MeshCase, phase: str, one, world: Group):
    """The launcher trains `case` at its widths and depth for its steps
    on one rank (`one`: that run's output and wall, `mesh_case_one`) and
    under --mesh 1x2 (`world`: that run started, `mesh_case_world`);
    every rank's losses within
    MESH_LOSS_REL_TOL of the one-rank run's, its kernels launched, an MoE
    model's fold invariant (nothing dropped), the ranks' fold tables
    equal and their peaks summed under the card's memory, and its
    recorded step's flows (`check_flows`; an MoE model's all-to-alls
    MOE_A2A_PER_LAYER a layer at E x C_loc x d x 2 bytes).  Returns
    {key: launches} of the mesh run's ranks."""
    from repro_torch.core.folding import FoldedTable

    t0 = time.monotonic()
    release(torch)
    cfg = case.cfg()
    what = f"{case.key}-mesh"
    B, S = case.shape
    n_one, gb_one = mesh_state_gb(cfg, (1, 1))
    n_rank, gb_rank = mesh_state_gb(cfg, (1, 2))
    log(f"[{what}] {cfg.name} at its published widths, cut to "
        f"{case.layers} layers, batch {B} x {S}, {case.steps} steps"
        + (f", capacity_factor {case.capacity_factor} (drop-free)"
           if case.capacity_factor else "")
        + f"; one rank holds {n_one / 1e9:.3f}B params ({gb_one:.1f} GB of "
        f"state at 16 B a param), a rank at 1x2 {n_rank / 1e9:.3f}B "
        f"({gb_rank:.1f} GB; two ranks {2 * gb_rank:.1f} GB of the card's "
        f"80) before activations")
    runs = {}
    for tag, mesh in (("one", None), (case.mesh_tag, "1x2")):
        d = mesh_case_args(case, tag)[0]
        n = 2 if mesh else 1
        out, wall = one if not mesh else (wait_group(world), None)
        if mesh:
            wall = time.monotonic() - world.t0
        for line in out.splitlines():
            if line.startswith("[mesh]"):
                log(f"[{what}] {tag}: {line}")
        if mesh:
            if FLOWS_HEAD not in out:
                fail(f"{what} {tag}: rank 0's report shows no collective "
                     f"flows")
            section = out[out.index(FLOWS_HEAD):].split("\n\n")
            log(f"[{what}] {tag}: rank 0's report: "
                + " | ".join(x.strip() for x in section[:12]))
        runs[tag] = [json.load(open(d / "metrics" / f"rank{r}.json"))
                     for r in range(n)]
        log(f"[{what}] {tag} ({mesh or 'one rank, in this process'}): {n} "
            f"rank(s), {wall:.1f}s wall incl. start-up")
    base = [h["loss"] for h in runs["one"][0]["history"]]
    a2a = None
    if cfg.moe:
        t_loc = B * S // 2
        c_loc = max(8, int(t_loc * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor))
        a2a = (MOE_A2A_PER_LAYER * moe_layers(cfg),
               cfg.n_experts * c_loc * cfg.d_model * 2)
    launches, folds, peaks = {}, {}, {}
    keys = ("loss", "aux_loss", "grad_norm")
    for tag, mesh in (("one", None), (case.mesh_tag, "1x2")):
        for m in runs[tag]:
            r, hist = m["rank"], m["history"]
            run_what = f"{what} {tag} rank {r}"
            losses = [h["loss"] for h in hist]
            if len(losses) != case.steps or not all(
                    math.isfinite(h[k]) for h in hist for k in keys):
                fail(f"{run_what}: history {hist}")
            errs = [abs(a - b) / abs(b) for a, b in zip(losses, base)]
            if max(errs) > MESH_LOSS_REL_TOL:
                fail(f"{run_what}: losses {losses} vs the one-rank run's "
                     f"{base}: relative errors {errs} (limit "
                     f"{MESH_LOSS_REL_TOL})")
            missing = [k for k in case.kernels if m["launches"][k] <= 0]
            if missing:
                fail(f"{run_what}: kernels {missing} were not launched: "
                     f"{m['launches']}")
            if cfg.moe:
                f = moe_fold(cfg, FoldedTable.from_json(m["device_fold"]),
                             run_what, B * S * case.steps, case.steps)
                if f["dropped"]:
                    fail(f"{run_what}: {f['dropped']} choices dropped at "
                         f"capacity_factor {case.capacity_factor}")
            folds[(tag, r)] = m["device_fold"]
            peaks[(tag, r)] = m["peak_bytes"] / 1e9
            step_ms = statistics.median(h["step_s"] for h in hist[1:]) * 1e3
            log(f"[{what}] {run_what}: losses "
                f"{[round(x, 5) for x in losses]} (relative to one rank: "
                f"{[f'{e:.2e}' for e in errs]}), aux "
                f"{[round(h['aux_loss'], 6) for h in hist]}, grad norms "
                f"{[round(h['grad_norm'], 4) for h in hist]}; step times (s) "
                f"{[round(h['step_s'], 3) for h in hist]}, median after the "
                f"first {step_ms:.1f} ms ({'two ranks sharing one card over '
                'gloo' if mesh else 'one rank'}; no measure of parallel "
                f"speed); peak {peaks[(tag, r)]:.1f} GB; on {device_line()}")
            log(f"[{what}] {run_what}: kernel launches "
                f"{json.dumps(m['launches'])}; collectives "
                f"{json.dumps(m['collectives'])}")
            if mesh:
                launches[f"{case.key} {tag} rank {r}"] = m["launches"]
                check_flows(run_what, m, case.sites, a2a)
        if mesh:
            if folds[(tag, 0)] != folds[(tag, 1)]:
                fail(f"{what} {tag}: the ranks' fold tables differ")
            total = peaks[(tag, 0)] + peaks[(tag, 1)]
            log(f"[{what}] {tag}: the two ranks' fold tables are equal; "
                f"peaks {peaks[(tag, 0)]:.1f} + {peaks[(tag, 1)]:.1f} = "
                f"{total:.1f} GB")
            if total >= MOE_TRAIN_PEAK_GB:
                fail(f"{what} {tag}: the ranks' peaks sum to {total:.1f} "
                     f"GB")
    log(f"[{what}] phase {phase} launcher runs: "
        f"{time.monotonic() - t0:.1f}s")
    return launches


def mesh_grads_world(cases, what: str):
    """Phase 20's gradient check (`mesh_grads`), phase 20b (`cp_decode`),
    the send / recv check (`p2p_check`) and the gradient checks of
    `cases` (`mesh_case_grads`), one after the other in one world of 2
    ranks spawned here.  Returns {key: launches} of each, each rank."""
    d = RUN_ROOT / what
    d.mkdir(parents=True, exist_ok=True)
    (d / "cases.json").write_text(json.dumps([c.key for c in cases]))
    launches = {}
    for r, res in enumerate(spawn_world(mesh_grads_rank, d, what)):
        launches.update(mesh_world_launches(res["tinyllama"], r))
        for c in cases:
            got = res[c.key]
            launches[f"{c.key} grads rank {r}"] = got["grad_launches"]
            log(f"[{what}] {c.key} rank {r}: kernel launches "
                f"{json.dumps(got['grad_launches'])}; local shapes "
                f"{got['shapes']}; peak {got['peak_bytes'] / 1e9:.1f} GB; "
                f"{got['seconds']:.1f}s")
    return launches


def mesh_grads_rank(rank: int, world: int, d: str) -> None:
    """One rank of `mesh_grads_world` (a spawned process)."""
    sys.path.insert(0, str(SRC))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops
    from repro_torch.parallel import mesh as mesh_lib
    mesh_lib.init_distributed("gloo", "cuda",
                              init_method=f"file://{d}/init", rank=rank,
                              world_size=world, timeout_s=MESH_TIMEOUT_S)
    # phase 20's gradient check and phase 20b, then the send / recv check
    ops.reset_launch_counts()
    mesh_grads(torch, rank)
    out = {"tinyllama": {"grad_launches": ops.launch_counts()}}
    ops.reset_launch_counts()
    cp_decode(torch, rank)
    out["tinyllama"]["cp_launches"] = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    out["p2p"] = p2p_check(torch, rank)
    for key in json.loads(Path(d, "cases.json").read_text()):
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        shapes = mesh_case_grads(torch, rank, MESH_CASES[key])
        torch.cuda.synchronize()
        out[key] = {"grad_launches": ops.launch_counts(), "shapes": shapes,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "seconds": time.monotonic() - t0}
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh_lib.shutdown()


#: the send / recv check of phase 22's world: [rows, cols] a tensor
P2P_SHAPE = (64, 1031)


def p2p_check(torch, rank: int) -> dict:
    """Each rank of the world sends a bf16 and an f32 CUDA tensor, and a
    transposed bf16 view (as a backward's gradient can be), to the other
    (`parallel.mesh.send` / `recv`, both ways, the view received into a
    transposed buffer) and holds what it received to what its peer
    sent, bit for bit (both draw the tensors from the same seeds).
    Returns {name: seconds}."""
    from repro_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    peer = 1 - mesh.coord("model")
    out = {}
    for name, dtype, transposed in (
            ("bf16", torch.bfloat16, False), ("f32", torch.float32, False),
            ("bf16 transposed", torch.bfloat16, True)):
        def draw(r):
            gen = torch.Generator(device="cuda").manual_seed(41 + r)
            t = torch.randn(P2P_SHAPE[::-1], generator=gen,
                            device="cuda").to(dtype).t()
            return t if transposed else t.contiguous()
        sent = draw(rank)
        got = torch.full_like(sent, math.nan)
        if sent.is_contiguous() == transposed:
            fail(f"p2p: the {name} tensor's layout is not the one meant")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if rank == 0:
            req = mesh_lib.send(sent, mesh, "model", peer)
            mesh_lib.recv(got, mesh, "model", peer)
            req.wait()
        else:
            mesh_lib.recv(got, mesh, "model", peer)
            mesh_lib.send(sent, mesh, "model", peer).wait()
        torch.cuda.synchronize()
        out[name] = time.monotonic() - t0
        if not torch.equal(got, draw(peer)):
            fail(f"p2p: rank {rank} received a {name} tensor that is not "
                 f"the one its peer sent")
    if rank == 0:
        log(f"[p2p] send / recv of [{P2P_SHAPE[0]}, {P2P_SHAPE[1]}] CUDA "
            f"tensors both ways over gloo (host copies): bf16, f32 and a "
            f"transposed bf16 view equal bit for bit on both ranks; "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in out.items()))
    return out


#: the kinds of `local_shapes` every MeshCase's local shapes are held to,
#: whether it names them or not
LOCAL_KINDS = frozenset({"attention", "ssd_scan"})


@contextmanager
def local_shapes(ops, seen: set):
    """Record the shapes this rank's attention, SSD scan and RMSNorm calls
    take: ("attention", q heads, q/k head dim, v head dim), ("heads", q
    heads, kv heads, causal), ("ssd_scan", heads) and ("rmsnorm",
    width)."""
    attention, ssd_scan, rmsnorm = ops.attention, ops.ssd_scan, ops.rmsnorm

    def spy_attention(q, k, v, **kw):
        seen.add(("attention", q.shape[1], q.shape[-1], v.shape[-1]))
        seen.add(("heads", q.shape[1], k.shape[1], kw.get("causal", True)))
        return attention(q, k, v, **kw)

    def spy_ssd(x, *args, **kw):
        seen.add(("ssd_scan", x.shape[2]))
        return ssd_scan(x, *args, **kw)

    def spy_rmsnorm(x, *args, **kw):
        seen.add(("rmsnorm", x.shape[-1]))
        return rmsnorm(x, *args, **kw)
    ops.attention, ops.ssd_scan, ops.rmsnorm = (spy_attention, spy_ssd,
                                                spy_rmsnorm)
    try:
        yield
    finally:
        ops.attention, ops.ssd_scan, ops.rmsnorm = attention, ssd_scan, \
            rmsnorm


def mesh_case_grads(torch, rank: int, case: MeshCase):
    """One loss_fn + backward of `case` at its widths and depth
    (case.grad_layers), batch case.grad_shape, under 1x2 (each leaf
    gathered over 'model' and compared on rank 0 one at a time), in f32 and bf16, against rank 0's
    one-rank runs, kept in host memory: f32 against the f32 kernel run
    (loss MESH_GRAD_LOSS_TOL relative, each leaf HYBRID_GRAD_TOL relative
    L2); bf16 no further from the f32 plain gradient than the one-rank
    bf16 kernel run's, within HYBRID_BF16_RATIO.  For an MoE model every
    top-k choice of both bf16 runs is pinned to the f32 plain model's
    (`pinned_router`, each rank its block of tokens; routing on
    bf16-rounded values flips choices between the runs, as in phases 11,
    13 and 14), the unpinned readings (case.unpinned) and the share of
    choices that differ logged.  Each rank's kernels must take
    case.local's shapes.  Returns the shapes seen."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import gather_leaf, shard_tree
    from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                             local_value_and_grad,
                                             value_and_grad)
    from repro_torch.tree import leaves_with_path, map_with_path, tree_map

    what = f"{case.key}-mesh-grads"
    cfg16 = case.cfg(case.grad_layers)
    cfg32 = dataclasses.replace(cfg16, param_dtype="float32",
                                compute_dtype="float32")
    pin_moe = cfg16.moe
    B, S = case.grad_shape
    T, K = B * S, cfg16.top_k
    batch = SyntheticLMData(cfg16, B, S, seed=1).generate(0)
    p32 = build_model(cfg32, device="cuda").init(0)
    router = moe_lib._router

    def routed(fn, pinned=None):
        """(fn(), every router call's top-k indices): the calls routed by
        `pinned` (one [t, K] tensor a call, in call order) when given."""
        picks = []
        route = router if pinned is None else pinned_router(router, pinned)

        def spy(w, x2, c):
            out = route(w, x2, c)
            picks.append(out[1])
            return out
        moe_lib._router = spy
        try:
            return fn(), picks
        finally:
            moe_lib._router = router

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def bf16(tree):
        return tree_map(lambda t: t.to(torch.bfloat16), tree)

    # the bf16 runs: unpinned (an MoE model's logged only), pinned
    bf16_pins = ((False,) if not pin_moe else
                 (False, True) if case.unpinned else (True,))
    runs = (("plain32", cfg32, "ref", False),
            ("kern32", cfg32, "auto", False)) + tuple(
        ("kern16 pinned" if pin else "kern16", cfg16, "auto", pin)
        for pin in bf16_pins)
    refs, n_calls = {}, torch.zeros(1, dtype=torch.int64, device="cuda")
    if rank == 0:
        # one-rank references, in host memory; these launches are
        # comparisons, not counted
        saved = ops.launch_counts()
        pins = None
        for tag, cfg, impl, pin in runs:
            params = p32 if cfg is cfg32 else bf16(p32)
            model = build_model(cfg, impl=impl, device="cuda")
            (loss, _, _, g), picks = routed(
                lambda: value_and_grad(model, params, batch, None),
                pins if pin else None)
            refs[tag] = (float(loss), {n: x.cpu() for n, x in
                                       leaves_with_path(g)}, picks)
            if tag == "plain32":
                pins = picks
            del g, params
        for fn in ops._KERNELS:
            fn.launches = saved[fn.__name__]
        n_calls.fill_(len(pins))
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    m, t_loc = mesh.coord("model"), T // mesh.size("model")
    block = None
    if pin_moe:
        # the f32 plain model's choices, to every rank (one [T, K] a call)
        mesh_lib.broadcast(n_calls, mesh, "model")
        pins = (torch.stack(refs["plain32"][2]) if rank == 0 else
                torch.zeros((int(n_calls), T, K), dtype=torch.int64,
                            device="cuda"))
        mesh_lib.broadcast(pins, mesh, "model")
        block = [p[m * t_loc:(m + 1) * t_loc] for p in pins]
    with runtime_mesh(mesh):
        lay = TrainLayout(build_model(cfg32, device="cuda"),
                          full_shapes(cfg32), mesh)
    local32 = shard_tree(p32, mesh, lay.param)
    del p32
    torch.cuda.empty_cache()
    seen = set()
    for dtype, cfg, pin in (("float32", cfg32, False),) + tuple(
            ("bfloat16", cfg16, pin) for pin in bf16_pins):
        local = local32 if dtype == "float32" else bf16(local32)
        model = build_model(cfg, device="cuda")
        t0 = time.monotonic()
        with runtime_mesh(mesh), local_shapes(ops, seen):
            (loss, _, _, g), picks = routed(
                lambda: local_value_and_grad(
                    model, local, lay.local_rows(batch, 1), None, lay),
                block if pin else None)
        one = "kern32" if dtype == "float32" else (
            "kern16 pinned" if pin else "kern16")
        errs = {}

        dists = {}

        def compare(path, x, spec):
            full = gather_leaf(mesh_lib.all_reduce(
                x.float(), mesh, lay.batch_axes), spec, mesh)
            if rank != 0:
                return
            if dtype == "float32":
                errs[path] = rel(full, refs[one][1][path].cuda())
            else:
                plain = refs["plain32"][1][path].cuda()
                dists[path] = (rel(full, plain),
                               rel(refs[one][1][path].cuda(), plain))
                errs[path] = dists[path][0] / max(dists[path][1], 1e-30)
        map_with_path(compare, g, lay.param)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        del g, local
        if rank != 0:
            continue
        want_loss, _, want_picks = refs[one]
        flips = ""
        if pin_moe:
            differ = sum(int((a.sort(-1).values
                              != b[:t_loc].sort(-1).values).sum())
                         for a, b in zip(picks, want_picks))
            flips = (f"; top-k choices of rank 0's tokens that differ from "
                     f"the one-rank run's "
                     f"{100 * differ / (len(picks) * t_loc * K):.3f}%")
        worst = max(errs, key=errs.get)
        run_what = f"1x2 {'f32' if dtype == 'float32' else 'bf16'}" + (
            " pinned" if pin else "")
        log(f"[{what}] {run_what}: loss {float(loss):.6f} vs one rank "
            f"{want_loss:.6f} (relative "
            f"{abs(float(loss) - want_loss) / abs(want_loss):.2e}){flips}; "
            f"worst leaf {worst} "
            + (f"{errs[worst]:.2e} relative L2" if dtype == "float32" else
               f"ratio {errs[worst]:.3f} of the one-rank bf16 run's "
               f"distance from the f32 plain gradient ({dists[worst][0]:.3e} "
               f"vs {dists[worst][1]:.3e} relative L2)")
            + f"; {wall:.1f}s")
        if dtype == "float32":
            lerr = abs(float(loss) - want_loss) / abs(want_loss)
            if lerr > MESH_GRAD_LOSS_TOL or errs[worst] > HYBRID_GRAD_TOL:
                fail(f"{what} f32: loss {lerr:.2e} (limit "
                     f"{MESH_GRAD_LOSS_TOL}), {worst} {errs[worst]:.2e} "
                     f"(limit {HYBRID_GRAD_TOL})")
        elif (pin or not pin_moe) and errs[worst] > HYBRID_BF16_RATIO:
            fail(f"{what} {run_what}: {worst} ratio {errs[worst]:.3f} > "
                 f"{HYBRID_BF16_RATIO}")
    del refs
    kinds = LOCAL_KINDS | {x[0] for x in case.local}
    got = {x for x in seen if x[0] in kinds}
    if got != case.local:
        fail(f"{what} rank {rank}: the kernels took local shapes "
             f"{sorted(got, key=str)}, want {sorted(case.local, key=str)}")
    return sorted(got, key=str)


def moe_mesh_phase(torch):
    """Phase 21: phi3_5_moe_42b at its widths and MOE_MESH_LAYERS layers,
    drop-free, through `mesh_case_phase` (the a2a MoE dispatch at 1x2:
    experts split over 'model', tokens exchanged by all-to-all); its
    gradient check runs in phase 22's world.  Returns {rank:
    launches}."""
    t_phase = time.monotonic()
    launches = mesh_cases_together(torch, (MOE_MESH,), "21")
    log(f"[moe-mesh] phase 21: {time.monotonic() - t_phase:.1f}s")
    return launches


def family_mesh_phase(torch):
    """Phase 22: deepseek-v2-lite and zamba2-2.7b through
    `mesh_case_phase`; phase 23: internvl2-1b, seamless-m4t-large-v2 and
    xlstm-1.3b the same way, each phase's 1x2 worlds at once (MESH_RUNS'
    note);
    then the gradient checks of phases 21, 22 and 23 one after the other
    in one spawned world (after its send / recv check).  Returns {rank:
    launches}."""
    t_phase = time.monotonic()
    launches = mesh_cases_together(torch, FAMILY_MESH, "22")
    t23 = time.monotonic()
    launches.update(mesh_cases_together(torch, MODAL_MESH, "23"))
    log(f"[modal-mesh] phase 23 launcher runs: {time.monotonic() - t23:.1f}s")
    launches.update(mesh_grads_world((MOE_MESH,) + FAMILY_MESH + MODAL_MESH,
                                     "mesh-grads"))
    log(f"[family-mesh] phases 22 and 23 (with phase 21's gradient check): "
        f"{time.monotonic() - t_phase:.1f}s")
    return launches


# -------------------------------------------------------------- diagnose ----
#: the profile dirs phase 9 diagnoses: (what, dir under the run root)
DIAGNOSED = (("tinyllama serve", "serve"), ("train", "train/prof"),
             ("zamba2 serve", "hybrid-serve"),
             ("zamba2 train", "hybrid-train/prof"),
             ("phi3.5-moe serve", "moe-serve"),
             ("phi3.5-moe train", "moe-train/prof"),
             ("deepseek train", "mla-train/prof"),
             ("granite serve", "granite-serve"),
             ("granite train", "granite-train/prof"),
             ("internvl train", "internvl-train/prof"),
             ("seamless train", "seamless-train/prof"),
             ("xlstm serve", "xlstm-serve"),
             ("xlstm train", "xlstm-train/prof"),
             ("tinyllama train at 1x2", "mesh/tp/prof"),
             ("tinyllama train at 2x1", "mesh/dp/prof"),
             ("phi3.5-moe train at 1x2", "moe-mesh/ep/prof"))
#: the mesh runs' dirs: their reports must merge both ranks' shards
MESH_PROFILES = ("mesh/tp/prof", "mesh/dp/prof", "moe-mesh/ep/prof")
#: the MoE train dirs whose report must show the device group: their
#: (config, batch shape, steps)
DEVICE_GROUPS = {
    "moe-train/prof": lambda: (moe_cfg(MOE_TRAIN_LAYERS), MOE_TRAIN_SHAPE,
                               MOE_TRAIN_STEPS),
    "mla-train/prof": lambda: (mla_train_cfg(), MLA_TRAIN_SHAPE,
                               MLA_TRAIN_STEPS),
    "moe-mesh/ep/prof": lambda: (moe_cfg(MOE_MESH_LAYERS), MOE_MESH_SHAPE,
                                 MOE_MESH_STEPS)}
FLEET_TRAIN_STEPS = 2


#: phase 9's CLI processes at a time (each a fresh interpreter reading one
#: profile dir; one after the other they took 14.8-26.2 s on NVIDIA H100
#: 80GB HBM3 hosts)
CLI_WORKERS = 6


def profile_cli(*args) -> dict:
    """One `python -m repro_torch.profile ... --json` process; it must
    exit 0 and print JSON that parses."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.profile", *map(str, args),
           "--json"]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    what = " ".join(cmd[3:5])
    if out.returncode != 0:
        fail(f"diagnose: `{what}` exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    try:
        return json.loads(out.stdout)
    except json.JSONDecodeError as e:
        fail(f"diagnose: `{what}` printed no JSON ({e}): {out.stdout[:500]}")


def log_diagnosis(what: str, diag: dict, report: dict) -> None:
    """Findings by severity, the first five, and the five edges with the
    most self time (total less time in traced children)."""
    g = diag["graph"]
    log(f"[diagnose] {what}: {g['edges']} edges, {g['components']} "
        f"components, {g['shards']} shard(s), {g['rings']} ring(s); "
        f"findings {json.dumps(diag['counts'])}")
    for f in diag["findings"][:5]:
        log(f"[diagnose] {what}: {f['severity']:4s} {f['detector']} "
            f"{f['subject']}: {f['message']}")
    inbound, wait = {}, {}
    for e in report["edges"]:
        c = e["component"]
        inbound[c] = inbound.get(c, 0) + e["total_ns"]
        wait[c] = wait.get(c, 0) + (e["total_ns"] if e["kind"] == "wait"
                                    else 0)
    log(f"[diagnose] {what}: Wait share of inbound time: " + ", ".join(
        f"{c} {100 * wait[c] / inbound[c]:.1f}% of "
        f"{inbound[c] / 1e6:.2f} ms" for c in sorted(wait) if wait[c]))
    edges = sorted(report["edges"], reverse=True,
                   key=lambda e: max(e["total_ns"] - e["child_ns"], 0))
    for e in edges[:5]:
        self_ms = max(e["total_ns"] - e["child_ns"], 0) / 1e6
        log(f"[diagnose] {what}: self {self_ms:10.2f} ms  total "
            f"{e['total_ns'] / 1e6:10.2f} ms  x{e['count']:<6d} "
            f"{e['kind']:4s} {e['caller']} -> {e['component']}.{e['api']}")


def recording(publisher) -> list:
    """Wrap `publisher.publish` to keep each call's counters (the engine
    and the Trainer drop them: publish() never raises)."""
    stats, publish = [], publisher.publish

    def recorded():
        stats.append(publish())
        return stats[-1]
    publisher.publish = recorded
    return stats


def check_stream(what: str, stats: list, local: str, spool_run: Path):
    """Every publish acked all its deltas, and the spooled run reduces to
    the local run's edges and counts."""
    from repro_torch.profile import load_profile

    if not stats or not sum(st["shipped"] for st in stats):
        fail(f"fleet {what}: nothing was published: {stats}")
    for st in stats:
        if st["errors"] or st["pending"]:
            fail(f"fleet {what}: a publish left deltas unacked: {stats}")
    if not spool_run.is_dir():
        fail(f"fleet {what}: the collector spooled nothing at {spool_run}")
    got = {k: (e.count, e.total_ns) for k, e in
           load_profile(str(spool_run)).to_folded().edges.items()}
    want = {k: (e.count, e.total_ns) for k, e in
            load_profile(local).to_folded().edges.items()}
    if got != want:
        fail(f"fleet {what}: the spool reduces to other edges or counts "
             f"than the local profile dir ({len(got)} vs {len(want)} edges)")
    log(f"[fleet] {what}: {len(stats)} publish(es), "
        f"{sum(st['shipped'] for st in stats)} snapshot(s) and "
        f"{sum(st['bytes'] for st in stats)} bytes acked; the spool reduces "
        f"to the local run's {len(want)} edges and counts")


def fleet_check(torch):
    """Phase 9, fleet: a serve and a train run stream their profile rings
    to the port's Collector on a thread of this process."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tracer as xfa
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.profile import Collector
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.serving import run_workload

    spool = RUN_ROOT / "spool"
    col = Collector(str(spool), timeout=60.0).start()
    addr = f"127.0.0.1:{col.port}"
    try:
        xfa.reset()
        with keep_dir("fleet-serve") as serve_dir:
            _, engine, prompts = make_engine(torch, serve_dir,
                                             xfa_collector=addr)
            serve_stats = recording(engine._publisher)
            done = run_workload(engine, prompts[:8], 16, mode="closed")
            engine._publisher.close()
            if len(done) != 8 or any(len(r.output) != 16 for r in done):
                fail(f"fleet serve: {len(done)} of 8 requests completed")
        del engine
        torch.cuda.empty_cache()

        cfg = get_config("tinyllama_1_1b")
        B, S = TRAIN_SHAPE[0], TRAIN_SHAPE[3]
        xfa.reset()
        with keep_dir("fleet-train") as train_dir, \
                keep_dir("fleet-train-ckpt") as ckpt_dir:
            trainer = Trainer(
                build_model(cfg, impl="auto", device="cuda"),
                TrainConfig(total_steps=FLEET_TRAIN_STEPS, warmup_steps=1,
                            ckpt_interval=0),
                CheckpointManager(ckpt_dir), profile_dir=train_dir,
                profile_interval=1, xfa_collector=addr)
            train_stats = recording(trainer._publisher)
            trainer.run(0, SyntheticLMData(cfg, B, S), FLEET_TRAIN_STEPS,
                        resume=False)
            if len(trainer.history) != FLEET_TRAIN_STEPS or not all(
                    math.isfinite(h["loss"]) for h in trainer.history):
                fail(f"fleet train: steps {trainer.history}")
        del trainer
        torch.cuda.empty_cache()
    finally:
        col.shutdown()
    check_stream("serve", serve_stats, serve_dir, spool / "fleet-serve")
    check_stream("train", train_stats, train_dir, spool / "fleet-train")
    fleet = profile_cli("diagnose", spool, "--fleet")
    names = sorted(os.path.basename(r["run_dir"]) for r in fleet["runs"])
    if not {"fleet-serve", "fleet-train"} <= set(names):
        fail(f"diagnose --fleet names the runs {names}, not both streamed "
             f"runs")
    log(f"[fleet] diagnose --fleet over the spool: runs {names}, findings "
        f"{json.dumps(fleet['counts'])}")
    for g in fleet["groups"][:5]:
        f = g["findings"][0]
        log(f"[fleet] {g['severity']:4s} {g['detector']} host {g['host']}: "
            f"{f['subject']}: {f['message']}")


def diagnose_phase(torch):
    """Phase 9: diagnose the profile dirs that the serve and train phases
    kept (DIAGNOSED) with the port's CLI, then stream a serve and a train
    run to a collector."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.monotonic()
    # the CLI's processes, each reading one dir, CLI_WORKERS at a time;
    # their results read in order
    with ThreadPoolExecutor(CLI_WORKERS) as pool:
        runs = [(what, rel,
                 pool.submit(profile_cli, "report", RUN_ROOT / rel),
                 pool.submit(profile_cli, "diagnose", RUN_ROOT / rel))
                for what, rel in DIAGNOSED]
        results = [(what, rel, r.result(), dg.result())
                   for what, rel, r, dg in runs]
    for what, rel, report, diagnosis in results:
        log_diagnosis(what, diagnosis, report)
        if rel in MESH_PROFILES:
            merged = sorted(report["meta"].get("merged_from", []))
            if merged != ["train-r0", "train-r1"]:
                fail(f"diagnose: the {what} report merges {merged}, not "
                     f"both ranks' shards")
            log(f"[diagnose] {what}: the report merges {merged}")
        if rel in DEVICE_GROUPS:
            # the device group, as the CLI reads it back from the shard
            edges = {(e["caller"], e["component"], e["api"]): e
                     for e in report["edges"]}
            step, disp = edges.get(("app", "loss", "train_step")), \
                edges.get(DISPATCH)
            cfg, (B, S), steps = DEVICE_GROUPS[rel]()
            want = cfg.top_k * B * S * moe_layers(cfg) * steps
            loads = sum(v for k, v in (disp or {}).get("metrics", {}).items()
                        if k.startswith("expert_load"))
            if step is None or step["count"] != steps or loads != want:
                fail(f"diagnose: `report` of the {what} shard shows "
                     f"train_step {step and step['count']} and loads "
                     f"{loads} (want {steps} and {want})")
            log(f"[diagnose] {what}: report shows the device group: "
                f"train_step x{step['count']}, dispatch x{disp['count']} "
                f"with loads summing to {int(loads)}, router "
                f"{edges[ROUTER]['metrics']}")
    # closed-loop serving writes its ring once, at drain: one snapshot
    tls = profile_cli("timeline", RUN_ROOT / "serve", "--min-snapshots", 1)
    for tl in tls:
        log(f"[diagnose] tinyllama serve timeline: shard {tl['stem']}, "
            f"seqs {tl['seqs']}, {len(tl['edges'])} edges")
    t1 = time.monotonic()
    fleet_check(torch)
    log(f"[diagnose] phase 9: {t1 - t0:.1f}s for the CLI over "
        f"{len(DIAGNOSED)} runs, "
        f"{time.monotonic() - t1:.1f}s for the fleet stream")


def breakdown(p, wall_us: float, tag: str, what: str):
    """Log a profiler window: device busy share, device time by kernel,
    host self time by op.  Returns (the device rows, busy device us)."""
    rows = [e for e in p.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and _dev_us(e) > 0]
    busy = sum(_dev_us(e) for e in rows)
    log(f"[{tag}] {what}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
    for e in sorted(rows, key=_dev_us, reverse=True)[:12]:
        log(f"[{tag}] {_dev_us(e) / 1e3:9.2f} ms "
            f"{100 * _dev_us(e) / busy:5.1f}%  x{e.count:<6d} {e.key[:90]}")
    # host side: self CPU time by op (what keeps the device waiting)
    host = [e for e in p.key_averages() if e.self_cpu_time_total > 0]
    cpu = sum(e.self_cpu_time_total for e in host)
    log(f"[{tag}] host self time in ops {cpu / 1e3:.1f} ms "
        f"({100 * cpu / wall_us:.1f}% of wall)")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"[{tag}] host {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"x{e.count:<6d} {e.key[:70]}")
    return rows, busy


def profiled_step(torch, model, tcfg, state, batch, tag: str, kernels):
    """One more step of a train run under torch.profiler: where it goes.
    `kernels` maps a name to device symbols whose share of the device
    time is logged.  Returns (the new state, {"busy": device busy share
    of the wall, name: share of the device time})."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.trainer import make_train_step

    step_fn = make_train_step(model, tcfg)
    B, S = batch["tokens"].shape
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.monotonic()
        state, _, _ = step_fn(state, batch, model.table())
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows, busy = breakdown(p, wall_us, tag, f"one step, batch {B} x {S}")
    shares = {"busy": busy / wall_us}
    for what, names in kernels.items():
        us = sum(_dev_us(e) for e in rows if any(n in e.key for n in names))
        shares[what] = us / busy
        log(f"[{tag}] {what} kernels {us / 1e3:.2f} ms, "
            f"{100 * us / busy:.1f}% of device time")
    return state, shares


def _dev_us(e) -> float:
    """Self device time of a profiler row (kernels, not the ops above)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v:
            return float(v)
    return 0.0


if __name__ == "__main__":
    main()
