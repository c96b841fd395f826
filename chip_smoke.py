#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases env,build,kernel,...]

Phases, each printing one JSON line:

  env           torch / CUDA versions and the card (nvidia-smi name, power limit)
  build         nvcc build of every kernel of the serving path, from csrc/
  kernel        each kernel against its plain PyTorch version on the card, in
                bf16, at its path's shapes and at edge shapes, with planted
                faults that must read above each limit (for the decode
                kernels B and K5 also in their split algorithm: a middle
                split's partial dropped, the combine's rescale left out),
                two launches of A, B, C, D, F, G, dh, dW, K5, K8 and K8's
                absmax bit-equal, K8's scales bit-equal to the plain
                version's, its time, the plain version's, the library
                call's (SDPA for attention, fused AdamW, F.linear +
                F.cross_entropy for the fused CE, vector_norm(inf) for the
                absmax) and the bound; B, K5 and K8 also by device time;
                E's per-block sums of u^2 and K7's ratio * ||u|| against
                their plain sums, E also timed with them;
                each of A, B, C, D and K5 also at head_dim 96; A, C and D
                with block-sparse layouts (the train_sparse shape, blocks of
                64 that straddle the tiles, GQA, an all-zero row block),
                their faults (the layout ignored, one live tile dropped from
                a list, the partial-tile element mask left out) above the
                limit, the tiles each walked equal to its lists' lengths,
                and at the train_sparse shape timed against dense A / C / D
                and SDPA given the layout as a boolean mask; C and D through
                flash_attention(..., return_lse=True) with an lse cotangent
                (dense, GQA with ALiBi, a layout with an empty row block)
                against their plain versions fed delta - log2(e) dlse, the
                cotangent left out planted as the fault; A, B and K5 at
                head_dim 256 (GPT-J's heads: A at a 2048-token prefill with
                and without a pad mask, B and K5 at 8 rows of 16 heads and
                at G 8), timed against SDPA at Hd 256 (A, K5); C and D at
                head_dim 256 (GPT-J's train micro-batch B 4, S 2048, H 16,
                causal, also with a pad mask and a fully masked row; GQA with
                ALiBi and a mask; full attention) with the backward faults
                and a kv head shifted planted, two launches bit-equal, timed
                against SDPA's backward at Hd 256, and at 256 also with a
                block layout (Fixed at S 2048, BigBird blocks of 64 under
                GQA) and with an lse cotangent; the int8
                dequant kernel at Llama-2-7B's MLP shape, q_groups 1 and
                64, bit-equal to its plain twin (limit 0), each row read
                with its neighbour's scales and truncation instead of
                rounding planted above it; A, C and D at BERT-large's
                attention ([32, 512, 16 x 64], non-causal, a quarter of the
                rows padded as mask_bias) and A at CLIP ViT-L/14's text
                ([16, 77, 12 x 64], causal) and vision ([8, 257, 16 x 64])
                towers, with the padding mask dropped and the causal flag
                flipped planted too, timed against SDPA (the padding as an
                additive mask), and at a ragged S of the data-efficiency
                curriculum ([32, 360, 16 x 64], padded), A there and at the
                encoder shapes through its op dstpu::flash_fwd, the path a
                training forward takes; A, C and D with Hd-64 bidirectional layouts
                (the sparse BERT's BigBird block 128 at S 1024, timed, and
                blocks of 64); F, G, dh and dW at BERT's MLM head (N 4096
                gathered rows, D 1024, V 30522, the decoder bias, the tied
                embedding read in place), timed; S (the NHWC bias adds, its
                three forms) at the denoiser's [2, 64, 64, 320] and the VAE's
                [1, 512, 512, 128] bf16 activations, bit-equal to its plain
                twin (limit 0), timed against a + bias; A at the denoiser's
                self-attention ([2, 4096, 8 x 40], non-causal), timed
  slice_parity  Llama-7B width cut to 2 layers: the same seeded weights served
                on the card (kernels) and on the CPU (plain versions, fp32);
                the CPU's greedy tokens fed to both sides' paged prefill and
                decode steps, every position's logits within LOGIT_ULP_TOL,
                faults planted in kernel A through the model above it
  serve         full Llama-2-7B (32 layers, bf16, random seeded weights)
                through init_inference + generate_batch with the default
                serving config; the kernels' launch counters must match the
                scheduler's prefill and decode actions
  serve_async   Llama-2-7B cut to 8 layers on the default serving config through the
                async serving front-end (AsyncServingEngine): two replays of
                a seeded arrival trace identical (actions and tokens); planted
                step faults under replay (a per-request prefill fault retries,
                a fault past max_request_retries quarantines, rows unchanged;
                an engine-fatal decode fault restarts once, rows unchanged
                but where one first parts at a near-tie); generate_batch and
                the loop on its thread with every prompt at once, alternated;
                the loop with the prompts at seeded offsets, two over HTTP
                with SSE and one more request cancelled mid-decode (rows
                against generate_batch's by the near-tie rule, SSE tokens
                the handle's, free blocks back to their start, A = L x
                prefills and B = L x decode steps, /healthz 200 then 503,
                /metrics against the registry, TTFT / TPOT); one controller
                action moving prefill_chunk a rung and the next prefill's
                chunks following it
  serve_tier    Llama-2-7B cut to 8 layers with the tiered KV cache (serving.kv_host,
                128 host blocks) on a 48-block device pool: turn 1 (the serve
                prompts), a filler wave that reclaims every block of turn 1
                into host RAM, turn 2 (each turn-1 row and 64 new tokens):
                fetched blocks bit-equal to their spill (limit 0), turn 2
                prefilling only its tails, A = L x prefills and B = L x
                decode steps, turn 2's rows against the tier off and against
                a device pool that hits on the device (near-tie rule), turn 2
                again under a persistent fetch fault (recompute), the pool
                drained with no live block; spill and fetch GB/s and ms a
                block, turn 2's TTFT against recompute, host RSS, device peak
  serve_fleet   two replicas of Llama-2-7B cut to 8 layers on the card behind the replica
                router, one weight tree (equal data_ptrs) and one host KV
                tier: a session trace replayed twice with equal decisions,
                rows against generate_batch (near-tie rule); roles
                prefill,decode handing every prompt of a block or more over
                through the host tier; a persistent decode fault on r0 until
                its breaker opens, every request completing on r1 (/healthz
                503 for r0, 200 for the router); the fleet against one loop,
                threaded, tokens/s and the device peak
  serve_gptj    GPT-J-6B at full width (EleutherAI/gpt-j-6b's
                config.json as a dict through GPTJPolicy; cut 28 -> 14
                layers, 16 heads x 256, rotary 64 interleaved, untied head with its
                bias; seeded bf16 weights) serving the serve phase's prompts
                through generate_batch (A, then B, at Hd 256) and static
                generate over their first 32 tokens (then K5): rows
                against the same weights with attention_backend "xla" by
                the near-tie rule, teacher-forced logits of three prompts
                within LOGIT_ULP_TOL with A reading the next kv head planted
                above it, A = L x prefills, B = L x decodes, K5 = L x
                (generated - 1); TTFT / TPOT p50, tokens/s, peak memory
  serve_int8    Llama-2-7B cut to 8 layers with dtype "int8" (q_groups 1): bytes at rest
                against the bf16 engine's, the serve phase's prompts on A, B
                and the dequant kernel (7 L + 1 launches a forward), TTFT /
                TPOT, tokens/s and peak memory beside the bf16 engine's; the
                same int8 params with the dequant's plain twin: rows equal,
                teacher-forced logits within LOGIT_ULP_TOL (0 read), a
                kernel-A fault above it; a fused decode step's device ms by
                class, int8 against bf16; the bf16 engine's top-1 agreement
                (printed, not gated)
  moe_generate  DeepSpeed-MoE 350M+MoE-128 (d 1024, 16 heads x 64, 128
                experts of d_ff 4096, top-1, capacity 1.0) cut to 6 of its 12
                MoE layers (6.4 B expert parameters, seeded bf16 weights drawn
                on the card) through init_inference + generate on an [8, 512]
                batch, 64 new tokens: tokens/s, prefill ms, ms a decode step,
                peak memory, each layer's expert counts and share of tokens
                over capacity (at most 0.9, layer 0 0.25); K5 = L x
                (generated - 1), A 0; against the same weights with attention_backend
                "xla": the tokens rerouted and rows parted with each side's
                own routing printed, then rows (near-tie rule) and three
                rows' teacher-forced logits (within LOGIT_ULP_TOL, K5's kv
                head shifted above it) with the card replaying the
                reference's routing decisions
  spec_parity   Llama-7B width cut to 2 layers: the CPU's greedy tokens fed
                in windows of 1-8 tokens through forward_paged_verify on the
                card (bf16, kernel B once per window position) and on the CPU
                (fp32, plain versions), every live window position's logits
                within LOGIT_ULP_TOL, and within it of the card's own
                teacher-forced decode steps; kernel B handed pos instead of
                pos + t planted through the model above it
  spec_serve    Llama-2-7B cut to 8 layers with serving.speculative ngram, k 4, on 8
                repetitive prompts (64 new tokens each): spec off, spec on
                with the n-gram proposer, and spec on with an oracle proposer
                (the spec-off output's next tokens), all of them and with its
                third candidate wrong; tokens/s, accepted tokens a fused
                step, stats, launches of A = L x prefills and B = L x
                (decodes + 8 x verifies), verify steps in the oracle runs,
                rows equal to spec off but where they first part at a
                near-tie of the spec-off logits
  generate_parity  Llama-7B width cut to 2 layers: the CPU's static
                generate tokens fed to forward_cached on the card (bf16,
                dense decode kernel) and on the CPU (fp32, plain versions);
                every position's logits within LOGIT_ULP_TOL, a dense-decode
                fault planted through the model above it
  generate      full Llama-2-7B (32 layers, bf16) through init_inference +
                generate on an [8, 512] prompt batch, 64 new tokens, greedy:
                tokens/s, prefill ms, ms per decode step, peak memory; the
                dense decode kernel launched 32 x (generated - 1) times
  train_parity  Llama-7B width cut to 1 layer: the same seeded weights and
                batches trained 3 steps through initialize + train_batch on
                the card (bf16, kernels) and on the CPU (fp32, plain
                versions), fused cross-entropy "on" in both; each leaf's
                first gradient (with a fault planted in the attention and CE
                backward kernels, which must read above the limit),
                per-step losses and each leaf's update must agree
  train         Llama-7B width cut to 8 layers (bf16, random seeded weights)
                through initialize + train_batch with the slice's training
                config (FusedAdam, WarmupLR, clipping, gas 2) on one
                [8, 2048] token batch, fused cross-entropy "auto" (or as
                --fused-ce says): 1 warm-up + 5 timed steps, every loss
                finite and falling, the kernels' launch counters per step
                equal to 2 L gas (A), L gas (C, D), one per leaf (E) and gas
                (each fused CE kernel; 0 with --fused-ce off)
  train_gptj    GPT-J-6B width (16 heads x 256): first train_parity's
                gradient and loss check at 1 layer on [2, 512] (C's and D's
                faults planted; no step compared), then
                8 layers through the train phase's configuration (A, C, D at
                Hd 256, E, K3): 1 warm-up + 5 timed steps, losses finite and
                falling, launches per step the train rule; step ms, tokens/s,
                MFU, peak memory
  moe_train     DeepSpeed-MoE 350M+MoE-128 cut to 2 layers (2.2 B parameters)
                through the train phase's configuration at micro 2 x gas 2:
                1 warm-up + 5 timed steps, losses finite and falling, A = 2 L
                gas, C = D = L gas, E once a leaf, no K3; the aux loss
  train_lamb_parity  Llama-7B width cut to 1 layer: FusedLamb + MoQ
                (quantize_training, nearest rounding, 10 -> 8 bits within the
                run) through initialize + train_batch on the card (bf16,
                kernels) and on the CPU (bf16 compute params over fp32
                masters, plain versions); per-step losses, each leaf's master
                update and the Quantizer's state must agree
  train_lamb    Llama-7B width cut to 8 layers through initialize +
                train_batch with FusedLamb and MoQ (64 groups, 16 -> 8 bits,
                period 2, symmetric, stochastic rounding), the train phase's
                batch, clipping, WarmupLR and fused CE: 1 warm-up + 5 timed
                steps, every loss finite and falling, per step the LAMB
                moments and apply kernels once per port leaf, the ratio kernel
                once per JAX leaf, the stochastic-rounding kernel and its
                absmax kernel once per port leaf of each quantized JAX leaf
  sparse_parity train_parity for the sparse path: Llama-7B width cut to 1
                layer with the Fixed sparsity config at S 1024; A, C and D
                walk the layout on the card, their plain layout-aware
                versions run on the CPU; the layout ignored (dense causal)
                planted on the card must read above the gradient limit
  train_sparse  replace_self_attention(Llama-7B width cut to 8 layers, Fixed
                sparsity: block 128, 4 local blocks, 1 global,
                unidirectional) at S 4096, micro 2 x gas 2, through
                initialize + train_batch with the train phase's config: 1
                warm-up + 5 timed steps, every loss finite and falling, per
                step A = 2 L gas and C = D = L gas launches, the tiles they
                walked equal to the layout's live blocks; then the same
                step with sparse attention off
  resume        Llama-7B width cut to 1 layer (S 2048, micro 2 x gas 2, the
                train phase's config) trained from the engine's own dataloader
                (64 seeded motif samples, shuffled): run U takes 6 steps; run R
                takes 3, saves a crash-safe tag (async: the snapshot, then the
                persist), and a new engine from another init seed auto_resumes
                and takes 3 more. R's losses at steps 4-6 and every master
                after step 6 must be bit-equal to U's, the launches per step
                the train phase's rule; planted faults must read above that
                limit (a resume without the optimizer states, a load without
                the data fast-forward), and an explicit load of the tag with
                one byte of state.npz flipped must raise and leave the
                engine's state untouched. Bytes a tag, snapshot ms, save and
                load s (GB/s; a load without the manifest's verification and
                the verification alone too), peak memory, free disk; the tag
                is deleted
  ingest        full Llama-2-7B from an HF-format checkpoint: seeded bf16 weights
                at the LlamaPolicy config of the published config.json written
                as safetensors shards (<= 5 GB each) with an index under
                .ingest_ckpt/ in the checkout, loaded by init_inference(<dir>,
                dtype="bf16"): every leaf bit-equal to those written; the serve
                phase's prompts through the loaded engine and an engine given
                the weights in memory, every token equal (limit 0), A = L x
                prefills, B = L x decode steps; q_proj and k_proj left
                un-transposed planted in the load (tokens or teacher-forced
                logits must differ above LOGIT_ULP_TOL), a shard dropped from
                the index or missing on disk must raise. Load s and GB/s, host
                peak RSS, device peak memory. Then gpt2 125m, bloom 560m and
                gpt-neox 20b at their published widths cut to 2 layers, each
                written and loaded on the card (bf16) and on the CPU (fp32),
                teacher-forced logits within LOGIT_ULP_TOL; and a Megatron
                meta json (GPT-2-medium width, 2 layers, tp 2, version 0)
                serving tokens equal to the same weights given directly. The
                checkpoints are deleted
  telemetry     full Llama-2-7B served with telemetry={"events": True} and
                without, the serve phase's prompts, 4 pairs of fresh engines
                alternating which goes first: tokens equal (limit 0),
                tokens/s of each serve, TTFT / TPOT p50 and p99 from the metrics
                registry, A = L x (prefill_steps - prefill_chunks) and B = L x
                decode_steps from the registry's counters, the snapshot and
                the exported serving trace valid (tools/validate_trace.py),
                the same host syncs on and off; the decode.tick clock within
                10 % of CUDA-event time over the same steps with 100 ms of
                device time planted after each decode forward, and a copy of the decode
                step that stops its clock before the token read outside it;
                then the train phase's configuration 3 steps with telemetry
                on and 3 off from the same seeded state: losses bit-equal,
                launches per step the train rule, one host sync a step on and
                none off (counted through the accelerator), train/mfu within
                3 % of flops_per_token x tokens/s / peak on the phase's clock
  client_opt    the train phase's configuration with a client optimizer,
                foreach torch.optim.AdamW over the masters, and the engine-built
                FusedAdam from the same seeded state: the grads the client
                optimizer receives at step 1 equal E's (per-leaf fingerprints,
                limit 0), the masters after step 1 equal AdamW applied by hand
                (limit 0) and two planted faults (the WarmupLR factor on top,
                the clip twice) read above 0, launches per step the train
                rule with no E, losses finite and falling; step ms, tokens/s,
                MFU, peak memory and the optimizer's time by CUDA events
                beside the engine-built step ms and E's time
  health        the train phase's configuration with telemetry.health
                (sentinels), metrics_port 0 and the sampler, 5 steps on and 5
                off: losses bit-equal, host syncs 1 / 0 a step, the timed
                steps' ms and peak memory on and off, 3 steps' sentinels
                against a plain fp64 recomputation on the card (the update
                norm lr ||u|| from the step's moments),
                /metrics scraped between steps, the CLI's health and top over
                the sampler's JSONL; an inf planted in a master with sentinels
                off (unseen) and on (nonfinite 1, a valid debug bundle); the
                port refused after teardown; then full Llama-2-7B serving the
                serve phase's prompts with events on: cli trace <rid> phases
                summing to each request's time, TTFT p99 and a TTFT
                objective's burn rate
  serve_stream  ZeRO-Inference from host RAM: Llama-2-7B cut to 16 layers with
                zero.offload_param.device "cpu" (the layers in one pinned host
                slab, two layer buffers on the card, copies on a copy stream)
                on generate's [8, 512] prompts, 16 new tokens (cut from 64 for
                time): rows equal (limit 0) to a resident engine's generate on
                the same weights, K5 = L x 15, A 0, device peak under
                embedding + head + 2 layers + the KV workspace + 1.5 GB,
                teacher-forced logits equal to the resident's and two layers'
                buffers swapped planted above LOGIT_ULP_TOL; prefill ms, ms a
                decode step, tokens/s and peak beside the resident engine's,
                the stream's GB/s against one plain pinned copy's, the copy
                stream's busy share of a decode step, host RSS
  serve_stream_nvme  the same model cut to 2 layers with device "nvme" under
                .zero_inference/ (free disk checked first): rows equal to the
                cpu-mode streamed engine (limit 0), K5 = L x 15, the swap dir
                gone once the engine is released; the layer files' read GB/s
                (warm) and whether O_DIRECT was taken
  train_offload ZeRO-Offload: the train cell's configuration with AdamW and
                offload_optimizer.device "cpu" (OFFLOAD_LAYERS layers, the host
                state within 60 % of MemTotal), 1 + 5 steps: losses finite and
                falling, A = 2 L gas, C = D = L gas, each K3 kernel gas, E 0 a
                step; at 2 layers against the device optimizer (E) from the
                same seeded state: grads at steps 1-2 equal (limit 0), masters
                after step 2 within 1e-6 of each leaf's largest; the masters
                following load_module_state_dict, and not refreshed planted
                above 1e-6; 1 layer on NVMe bit-equal to cpu mode after 3
                steps; step ms split into device accumulation, D2H, host
                optimizer and H2D, tokens/s, MFU, peaks, host RSS
  encoder_parity  the encoders, card (bf16, kernels) against CPU (fp32,
                plain), 1 layer of each published width: BERT-large's MLM
                logits at every valid position and pooled output on [4, 512]
                rows of seeded lengths under an attention mask
                (LOGIT_ULP_TOL; the padding mask dropped, causal attention
                and A's kv head shifted above it); its MLM-loss gradients
                (gather budget 0.25) through the train path, no step, 3 of
                the 4 rows full-length (train_parity's limit; delta left out
                of C and of D, D's last q tile skipped and the mask dropped
                in the backward above it); the same for a sparse
                BERT (BigBird block 128, bidirectional) at S 1024, the
                layout ignored above it; CLIP ViT-L/14's text [8, 77] and
                vision [4, 224, 224, 3] hidden states and pooled outputs
                (LOGIT_ULP_TOL; text non-causal and vision causal above it).
                The seeded weights' q / k and v / o projections are scaled
                (attention_weighted) so that attention moves the outputs
  bert_serve    BERT-large (24 layers) from a BertForMaskedLM-layout HF
                checkpoint of seeded fp32 weights written under
                .encoder_ckpt/ and loaded through the bert policy (bf16):
                64 fill-mask requests of lengths 32..512 (15 % [MASK]) in
                padded batches of 16 with an attention mask; sequences/s,
                valid tokens/s, ms a batch p50 / max, peak memory; leaves and
                top-1 at every masked position equal to the in-memory
                engine's (limit 0), A = 24 x batches, C, D, K3 0, generate
                refused
  bert_train    BERT-large MLM pre-training as the JAX bench builds it: micro
                32 x 512, AdamW 1e-4, bf16, no remat, fused CE, gather
                budget 0.25, a quarter of the rows padded: 1 warm-up + 5
                timed steps, losses finite and falling, per step A, C, D 24,
                F, G, dh, dW 1, E once a leaf (396); step ms, tokens/s, MFU,
                peak memory
  clip_encode   CLIP ViT-L/14 (text 12, vision 24 layers) from a CLIPModel
                HF checkpoint of seeded fp32 weights through the clip policy
                into a DSClipEncoder (bf16): 64 prompts padded with EOT to 77
                (batches of 16) and 32 images (batches of 8); prompts/s,
                images/s, ms a batch, peak memory; leaves and both towers'
                outputs equal to the in-memory encoders' (limit 0), A = 12 a
                text batch and 24 an image batch
  compress_parity  the compression path, card against CPU: 1 layer at
                BERT-large's width, every technique's compress_params leaves
                (fp32) and the compress_train path's (bf16), redundancy_clean
                and student_initialization bit-equal (limit 0; the sparse
                threshold at k + 1 above it, head pruning raising alike on
                the stacked leaf), the compressed MLM logits on [4, 512]
                within LOGIT_ULP_TOL (the sparse mask left out above it),
                the compressed loss's gradients within train_parity's limit
                (an STE with a zero gradient above it); 1 layer at
                Llama-2-7B's width in fp32 with 4-bit activation fake-quant:
                leaves bit-equal, logits within LOGIT_ULP_TOL (the MLP's
                fake-quant left out above it), the act-quant transition
                through the engine (A 2, C, D, each K3 kernel 1 a step);
                Eigenvalue._power_iterate from one v0, 5 iterations within
                1e-3 relative (the mask not applied to the HVP above it)
  compress_train  a 12-layer student of the seeded BERT-large (teacher
                layers 1, 3, ..., 23 through student_initialization),
                init_compression with 8-bit grouped weight quant on attn and
                mlp from step 0 and l1 sparse pruning (0.5) on mlp from step
                4, trained as bert_train for 6 steps with the
                CompressionScheduler: losses finite and falling, each
                technique active from its offset, per step A, C, D 12, F, G,
                dh, dW 1, E once a leaf; step ms (the transitions marked),
                tokens/s, MFU, compress_params ms, peak; redundancy_clean of
                the trained params served fill-mask, every masked top-1 the
                CompressedModel's (limit 0), A 12 a batch
  moq_eigenvalue  BERT-large (24 layers, fp32, plain attention, micro 2 x
                512) with quantize_training 12 -> 8 bits, stochastic (K8),
                and its eigenvalue schedule over 24 layer blocks: the
                eigenvalues computed at both steps, each block's value and
                iterations, the HVPs' ms; every period after a switch the
                factor rule of the step's own mean (limit 0), per step E
                once a leaf and K8 and its absmax once a quantized leaf, no
                A, C, D or K3 inside the HVPs
  train_remat   the train cell (Llama-2-7B width, 8 layers, S 2048, micro 4
                x gas 2) under the remat policies full, selective, dots and
                offload_dots: the step-1 loss and every gradient bit-equal to
                full's (limit 0), A's forwards in the backward (L, 0 under
                selective); then 3 steps each: step ms, tokens/s, the device
                peak beside the reckoned saved bytes, A, C, D a step (A 16
                under selective, 32 under the others), offload_dots' pinned
                host bytes; the peaks ordered offload_dots within 0.5 GB of
                full < selective < dots
  train_data_efficiency  BERT-large MLM as bert_train fed by the
                data-efficiency pipeline: 2048 seeded rows in an mmap indexed
                dataset under .data_efficiency/ (deleted after), a
                DataAnalyzer seqlen metric, a DeepSpeedDataSampler over its
                curriculum into the engine's dataloader, the engine's seqlen
                curriculum (128 -> 512, step 8), random-LTD on layers 1..22
                (bert_sample_tokens, 128 -> 512 over 20 steps), PLD theta
                after each step: 6 steps, each step's S and kept count the
                schedulers', the rows a fresh sampler's order, A, C, D 24 a
                step at the kept and full S; step ms, tokens/s, losses
  diffusers     Stable Diffusion v1.5's first UNet level at full width (batch 2
                for classifier-free guidance, 64 x 64 latents; conv_in, a
                ResNet block with the time bias through nhwc_bias_add and the
                residual through nhwc_bias_add_add, self-attention over 4096
                tokens through A, GEGLU, conv_out) through DSUNet's CUDA graph
                and eagerly, 20 calls each alternated: outputs bit-equal, A
                once and S 8 times a call (replays x the captured launches);
                DSVAE's encode (conv 3 -> 128 at 512 x 512, a ResNet block)
                and decode (conv_in 4 -> 512 at 64 x 64, a ResNet block)
                graphs bit-equal to eager; donate_latents; one step at a
                16 x 16 latent, card bf16 against CPU fp32, within
                LOGIT_ULP_TOL, A's kv head shifted above it
  tiled_linear  TiledLinear at Llama-2-7B's MLP up-projection (4096 -> 11008,
                tiled 4 x 4, x [4, 2048, 4096] bf16), both lowerings, forward
                and backward against the dense product within 2 bf16 ulps of
                each row's largest; ms and device peak against dense
  autotune      the autotuner on the train cell (8 layers, S 2048), fast mode,
                ZeRO stage 0, micro-batches 1, 2 and 4: each trial's estimate
                beside its peak, its launches by the train rule, the winner
                the best measured, ds_config_optimal.json trains one step
  tooling       OnDevice(meta) of the full Llama-2-7B (nothing allocated,
                shapes of a real 1-layer build), the flops profiler on
                bert_train's model at 2 layers ([32, 512]: products as
                reckoned, A counting 0), dscli report and dscli elastic -w 1
                as subprocesses, initialize taking the elastic plan's batch
  comm          comm/ over NCCL at one rank (init_distributed(rank=0,
                world_size=1)): every collective on fp32 and bf16 tensors
                (SUM, AVG, MAX, MIN, PRODUCT; tiled and stacked gathers,
                reduce_scatter_tensor, all_to_all_single, broadcast,
                ring_send_recv, barrier) against numpy's values for JAX's
                one-device mesh (limit 0; PRODUCT within 1e-6 relative), the
                comms logger's count and bytes per op equal to the calls;
                then dscli bench at 1, 8, 64 and 256 MB (algbw, busbw, the
                card's name and power limit)
  launch        python -m deepspeed_tpu_torch.cli run --num_gpus 1 spawns
                one rank (this script behind --worker launch; its stdout in
                .chip_check/launch/logs) that trains the train cell for 3
                steps on NCCL at world 1, its gradients averaged over dp; its
                losses and every state tensor equal to the same 3 steps run
                here without a process group (limit 0), its launches the
                train rule; then DSElasticAgent over the comm checks as a
                worker that fails its first attempt: SUCCEEDED, 1 restart
  zero          cli run --num_gpus 1 spawns one NCCL rank (--worker zero) that
                trains the train cell (Llama-2-7B width, 8 layers, bf16,
                micro 4 x gas 2, S 2048) 3 steps at ZeRO stage 0, 1, 2 and 3
                (AdamW on kernel E; stage 3 under the default remat, each
                layer gathered in its block) and the train_lamb cell's
                LAMB (K7) with MoQ (K8, stochastic) at stages 0 and 2:
                every stage's losses and every state tensor, gathered,
                bit-equal to stage 0's (limit 0: over one rank a partition
                is the whole unit), its launches per step by the train rule,
                its collectives' count and bytes (comms logger, one more
                step), step ms and the device peak; beside them the bytes a
                rank would hold at dp 2, 4 and 8, reckoned from the
                partition sizes
  kernels       every ported kernel with its launches in the serve, spec_serve
                (its oracle run), generate, train, train_lamb, train_sparse,
                resume, ingest, telemetry, client_opt, health, serve_async,
                serve_tier, serve_fleet, serve_gptj, serve_int8, train_gptj,
                moe_generate, moe_train, serve_stream, serve_stream_nvme,
                train_offload, bert_serve, bert_train, clip_encode,
                compress_train, moq_eigenvalue, train_remat,
                train_data_efficiency, diffusers, autotune, tooling, launch
                and zero phases
                (the encoder shapes in rows of their own; A, C and D with a
                layout in
                rows of their own, as A, B, C, D and K5 at head_dim 256; C's
                and D's rows also carry their readings with an lse cotangent)
  profile       (only with --phases profile) the serve phase's prompts through
                fresh engines after a warm-up: warm tokens/s, device kernel
                time by class under torch.profiler, the device's idle share
  train_profile (only with --phases train_profile) one warm train step of the
                train phase's configuration under torch.profiler: device
                time by class and the device's idle share
  train_lamb_profile (only with --phases train_lamb_profile) the same for
                the train_lamb phase's configuration: K7's three kernels,
                K8 and its absmax kernel among the classes
  generate_profile (only with --phases generate_profile) the generate
                phase's call after a warm-up, timed and then under
                torch.profiler: device time by class and the idle share
  train_sparse_profile (only with --phases train_sparse_profile) the
                train_profile breakdown for the train_sparse configuration
  health_profile (only with --phases health_profile) the train_profile
                breakdown with telemetry.health on (the sentinels' passes)

The last line is {"ok": true, "device": {...}}. Any failure raises, so the
script exits non-zero and prints no result line; it also exits non-zero
without a CUDA device. It imports neither jax nor deepspeed_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

PHASES = ("env", "build", "kernel", "slice_parity", "serve", "serve_async", "serve_tier",
          "serve_fleet", "serve_gptj", "serve_int8", "moe_generate", "spec_parity",
          "spec_serve",
          "generate_parity", "generate",
          "train_parity", "train", "train_gptj", "moe_train", "train_lamb_parity",
          "train_lamb", "sparse_parity",
          "train_sparse", "resume", "ingest", "telemetry", "client_opt", "health",
          "serve_stream", "serve_stream_nvme", "train_offload", "encoder_parity",
          "bert_serve", "bert_train", "clip_encode", "compress_parity", "compress_train",
          "moq_eigenvalue", "train_remat", "train_data_efficiency", "diffusers",
          "tiled_linear", "autotune", "tooling", "comm", "launch", "zero", "kernels",
          "profile",
          "train_profile", "train_lamb_profile", "generate_profile", "train_sparse_profile",
          "health_profile")
DEFAULT_PHASES = PHASES[:-6]      # the six profiles run only when asked for
# Kernel vs plain version, bf16 outputs: the largest difference in each output
# row (over head_dim), in bf16 ulps of that row's largest |plain| value, so
# one limit holds at every output scale (a row over 500 keys is ~20x smaller
# than a row over one key). The limit sits 2 ulps above the worst sound
# reading on an H100, 1.02 for either kernel (PERF.md §6); planted faults
# must read above it, or the check could not tell them from a sound kernel.
ULP_TOL = 3.0
LSE_TOL = 1e-4                  # log2-domain lse: sound reads <= 4e-6, a dropped key >= 0.016
# slice_parity / generate_parity: teacher-forced logits, bf16 card vs fp32 CPU,
# per position in bf16 ulps of its largest |CPU logit| (PERF.md section 6)
LOGIT_ULP_TOL = 8.0
# Backward kernels C and D: the same ulp measure, with each row's magnitude
# floored at 2^-10 of the gradient's largest value: a dq row of a query that
# sees one key (or a dk row of a key that one query sees) is dp - delta's
# rounding residue, ~1e-6 of the row scale, and differs between any two
# correct summation orders.
GRAD_FLOOR = 2.0**-10
ADAM_TOL = 1e-6                 # kernel E: u, m, v error relative to the largest plain value
SQ_TOL = 1e-5                   # kernel E: the blocks' sum of u^2 against the plain sum
CE_TOL = 1e-4                   # kernel F: nll and log2-domain lse, absolute fp32 (PERF.md §6)
DB_TOL = 1e-4                   # kernel G: db relative to its largest plain value
FP32_PEAK_TFLOPS = 67.0         # H100 SXM fp32 outside the tensor cores (data sheet)
LAMB_RATIO_TOL = 1e-6           # fused LAMB trust ratio, relative (p, m, v: ADAM_TOL)
# K8 against its plain twin fed the kernel's own Philox noise: the share of
# elements that differ (the same fp32 operations: 0 expected; planted faults
# differ in a large share)
SR_MISMATCH_TOL = 1e-6
MOQ_TRAIN = {"enabled": True, "quantize_groups": 64,
             "quantize_bits": {"start_bits": 16, "target_bits": 8},
             "quantize_schedule": {"quantize_period": 2},
             "quantize_algo": {"q_type": "symmetric", "q_rounding": "stochastic"}}
LAMB_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
               "gradient_accumulation_steps": 2,
               "optimizer": {"type": "FusedLamb",
                             "params": {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-6,
                                        "weight_decay": 0.01}},
               "scheduler": {"type": "WarmupLR",
                             "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                        "warmup_num_steps": 2}},
               "gradient_clipping": 1.0, "bf16": {"enabled": True},
               "fused_cross_entropy": "auto", "quantize_training": MOQ_TRAIN}
TRAIN_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "FusedAdam",
                              "params": {"lr": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8,
                                         "weight_decay": 0.1}},
                "scheduler": {"type": "WarmupLR",
                              "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4,
                                         "warmup_num_steps": 2}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "fused_cross_entropy": "auto"}
TRAIN_LAYERS = 8                # Llama-2-7B width, depth cut 32 -> 8 (PERF.md section 4)
TRAIN_SEQ = 2048
TRAIN_STEPS = 6                 # 1 warm-up + 5 timed
SPARSE_SEQ = 4096               # train_sparse: Llama-2's published context
SPARSE_PARITY_SEQ = 1024        # sparse_parity: two local windows of the Fixed layout
RESUME_LAYERS = 1               # resume: Llama-2-7B width, depth cut 32 -> 1 (PERF.md section 4)
RESUME_SAMPLES = 64             # resume's dataset: seeded motifs repeated to TRAIN_SEQ
RESUME_STEPS = 6                # run U; run R takes half, saves, resumes, takes the rest
RESUME_CONFIG = {**TRAIN_CONFIG, "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
                 "gradient_accumulation_steps": 2}
# where resume writes its tag: inside the checkout (git-ignored), deleted after
RESUME_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".resume_ckpt")
PARITY_LAYERS = 1               # train_parity's depth: its fp32 CPU side is most of the run
PARITY_LOSS_TOL = 3e-2          # absolute, bf16 card vs fp32 CPU (PERF.md section 6)
PARITY_UPDATE_TOL = 0.5         # |card update - CPU update| / |CPU update|, per leaf
# |card grad - CPU grad| / |CPU grad| per leaf, first batch at the initial
# weights (Adam does not normalise these); planted faults in kernels C and D
# must read above it (PERF.md section 6)
PARITY_GRAD_TOL = 0.1
# the encoder phases (BERT-large, CLIP ViT-L/14; section "the encoder families")
ENCODER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".encoder_ckpt")
BERT_CLS, BERT_SEP, BERT_MASK = 101, 102, 103     # bert-large-uncased's special ids
CLIP_BOS, CLIP_EOT = 49406, 49407                 # CLIP's start and end of text
MLM_RATE = 0.15                 # positions set to [MASK] (and labelled) in each sequence
BERT_BUDGET = 0.25              # mlm_gather_budget: the JAX bench's
BERT_MICRO = 32                 # bert_train: the JAX bench's micro-batch
BERT_SEQ = 512
BERT_PARITY_BATCH = 4           # encoder_parity's BERT rows ([4, 512], lengths 64..512)
BERT_FULL_ROWS = 3              # of them full-length in the gradient check (D's tile fault)
BERT_SPARSE_SEQ = 1024          # encoder_parity's sparse BERT (BigBird, block 128)
BERT_SERVE_REQUESTS = 64        # bert_serve: fill-mask requests of lengths 32..512
BERT_SERVE_BATCH = 16
CLIP_PROMPTS, CLIP_TEXT_BATCH = 64, 16      # clip_encode: prompts padded with EOT to 77
CLIP_IMAGES, CLIP_IMAGE_BATCH = 32, 8       # clip_encode: seeded 224 x 224 images
CLIP_PARITY_TEXT, CLIP_PARITY_IMAGES = 8, 4
ENCODER_DTYPE = "bf16"          # the engines' dtype on the card


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def row_ulp_errs(out, ref, floor=0.0):
    """Largest |out - ref| of each row (the last axis) in bf16 ulps of the
    row's largest |ref|; the ulp of x in [2^e, 2^(e+1)) is 2^(e-7). With
    ``floor`` > 0 a row's magnitude is at least ``floor`` times the
    tensor's largest |ref|; without, a row that should be all zeros reads
    inf unless ``out`` is zero there too. One reading a row."""
    import torch
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs().amax(-1)
    mag = ref.abs().amax(-1).clamp(min=floor * float(ref.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return torch.where(diff == 0, torch.zeros_like(diff), diff / ulp)


def ulp_err(out, ref, floor=0.0):
    """The worst row of :func:`row_ulp_errs`."""
    return float(row_ulp_errs(out, ref, floor).max())


def cuda_ms(fn, reps=30, warmup=5):
    """Median time of ``fn`` on the card over ``reps`` runs (CUDA events)."""
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


def device_ms_by_class(fn, reps=20):
    """Device time of one call of ``fn`` by kernel class (:func:`_kernel_class`),
    from torch.profiler over ``reps`` calls after a warm-up (no host time,
    unlike :func:`cuda_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_class, _ = _device_time(prof)
    return {c: ms / reps for c, ms in by_class.items()}


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: every kernel it launches."""
    return sum(device_ms_by_class(fn, reps).values())


def bound(nbytes, flops, peak_tflops=None):
    """Least time the card could take (ms) and what bounds it: the bytes over
    the card's memory rate, the FLOPs over the peak for their type (default
    the dense bf16 tensor-core peak; the accelerator's table of published
    rates)."""
    from deepspeed_tpu_torch.accelerator import get_accelerator
    acc = get_accelerator("cuda")
    check(acc.memory_bandwidth() > 0 and acc.peak_tflops() > 0,
          "no published peak rates for this card in the accelerator table")
    t_bytes = nbytes / acc.memory_bandwidth() * 1e3
    t_ops = flops / ((peak_tflops or acc.peak_tflops()) * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------- #

def phase_env(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    state["card"] = card
    mem = meminfo()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         checkout_disk_free_gb=shutil.disk_usage(os.path.dirname(RESUME_DIR)).free / 1e9,
         mem_total_gb=mem["MemTotal"] / 1e9, mem_available_gb=mem["MemAvailable"] / 1e9,
         cpu_cores=os.cpu_count(), cpu_model=cpu_model())


_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dkv256_kernel", "paged_decode_kernel", "paged_decode_combine_kernel", "dense_decode_kernel",
                 "dense_decode_combine_kernel", "fused_adam_kernel",
                 "fused_ce_fwd_kernel", "fused_ce_combine_kernel", "fused_ce_ds_kernel",
                 "fused_ce_db_kernel", "ce_dh_gemm_kernel", "ce_dw_gemm_kernel",
                 "lamb_moments_kernel", "lamb_ratio_kernel", "lamb_apply_kernel",
                 "sr_quantize_kernel", "sr_absmax_kernel", "sr_scale_kernel",
                 "dequant_int8_vec_kernel", "dequant_int8_scalar_kernel",
                 "spatial_bias_add_kernel")


def ptxas_summary(log):
    """Registers, static shared memory and spill bytes of every kernel
    instantiation from nvcc's ``-Xptxas=-v`` output, folded to one line per
    (kernel, dtype, head dim): the most of each over its other template
    arguments; and every ptxas warning (a wgmma serialised, setmaxnreg
    ignored)."""
    import re
    rows, warnings = {}, []
    for text in log.values():
        key = None
        for ln in text.splitlines():
            if "warning" in ln.lower():
                warnings.append(ln.strip()[:200])
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
            if m:
                name = m.group(1)
                kern = next((k for k in _KERNEL_NAMES if k in name), name[:40])
                dt = "bf16" if "bfloat16" in name else "fp16" if "__half" in name else ""
                hd = re.search(r"Li(64|96|128|256)E", name)
                key = f"{kern} {dt} hd{hd.group(1)}" if hd else f"{kern} {dt}".strip()
                rows.setdefault(key, {"registers": 0, "smem_bytes": 0, "spill_bytes": 0})
            if key is None:
                continue
            r = re.search(r"Used (\d+) registers", ln)
            if r:
                rows[key]["registers"] = max(rows[key]["registers"], int(r.group(1)))
            sm = re.search(r"(\d+) bytes smem", ln)
            if sm:
                rows[key]["smem_bytes"] = max(rows[key]["smem_bytes"], int(sm.group(1)))
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if sp:
                rows[key]["spill_bytes"] = max(rows[key]["spill_bytes"],
                                               int(sp.group(1)) + int(sp.group(2)))
    return rows, warnings


# kernels that must not spill: those on TMA + wgmma, the two decode kernels
# (split + cp.async ring) with their combine kernels, and K8 with its scale
# pass
_NO_SPILL_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                     "flash_bwd_dkv256_kernel", "fused_ce_fwd_kernel", "fused_ce_ds_kernel", "ce_dh_gemm_kernel",
                     "ce_dw_gemm_kernel", "paged_decode_kernel", "paged_decode_combine_kernel",
                     "dense_decode_kernel", "dense_decode_combine_kernel", "sr_quantize_kernel",
                     "sr_absmax_kernel", "sr_scale_kernel", "dequant_int8_vec_kernel",
                     "dequant_int8_scalar_kernel", "spatial_bias_add_kernel")


def spilling_kernels(rows):
    """The spill bytes of every row of a kernel that must not spill and does."""
    return {k: r["spill_bytes"] for k, r in rows.items()
            if k.split()[0] in _NO_SPILL_KERNELS and r["spill_bytes"]}


def phase_build(state):
    """nvcc of every kernel with ptxas's report. A, C, D, F, G, dh and dW
    take their rings as dynamic shared memory, which ptxas does not count:
    it is read from the libraries. ptxas reports the 384-thread launch
    bound's 168 registers; setmaxnreg moves the consumer warpgroups to 232
    (F, G, dh, dW, A) or 240 (C, D) at run time. Fails if ptxas spills in
    any of them, or in the decode kernels B and K5 or their combine kernels
    (every dtype, head dim and group size), or in K8 or its scale pass."""
    from deepspeed_tpu_torch.ops.kernels import build
    seconds, log = build.build(ptxas_verbose=True)
    rows, warnings = ptxas_summary(log)
    gemm_smem = build.load("fused_cross_entropy").ds_ce_gemm_smem_bytes()
    fwd, bwd = build.load("flash_attention"), build.load("flash_attention_bwd")
    attn_smem = {f"{k} hd{hd}": fn(hd) for hd in (64, 128, 256)
                 for k, fn in (("flash_fwd_kernel", fwd.ds_flash_fwd_smem_bytes),
                               ("flash_bwd_dq_kernel", bwd.ds_flash_dq_smem_bytes),
                               ("flash_bwd_dkv_kernel", bwd.ds_flash_dkv_smem_bytes))}
    emit("build", seconds=seconds, built=sorted(log), ptxas=rows, ptxas_warnings=warnings,
         ce_dynamic_smem_bytes=gemm_smem, attention_dynamic_smem_bytes=attn_smem)
    spills = spilling_kernels(rows)
    check(not spills, f"ptxas spills in kernels that must not spill: {spills}")


def _flash_case(gen, B, S, H, KV, Hd, causal, alibi, mask):
    import torch
    dev, dt = "cuda", torch.bfloat16
    q = torch.randn((B, S, H, Hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, S, KV, Hd), generator=gen, device=dev).to(dt)
    v = torch.randn((B, S, KV, Hd), generator=gen, device=dev).to(dt)
    slopes = (torch.rand((H,), generator=gen, device=dev) * 0.3 + 0.05) if alibi else None
    mask_bias = None
    if mask:
        keep = torch.rand((B, S), generator=gen, device=dev) > 0.2
        keep[:, 0] = keep[:, -1] = True     # the last key stays live for the planted fault
        mask_bias = torch.where(keep, 0.0, -1e9).float()
    return q, k, v, mask_bias, causal, slopes


def _flash_faults(fa, q, k, v, mask_bias, causal, slopes):
    """The plain version with a kernel fault planted: the kv head index off
    by one, and the last key skipped (as a kernel that drops the partial
    last k/v tile would for its last row)."""
    import torch
    drop = torch.zeros(q.shape[:2], device=q.device)
    drop[:, -1] = -1e9
    if mask_bias is not None:
        drop = drop + mask_bias
    return {
        "kv_head_shifted": fa.flash_attention_plain(q, k.roll(1, 2), v.roll(1, 2), mask_bias,
                                                    causal, slopes),
        "last_key_dropped": fa.flash_attention_plain(q, k, v, drop, causal, slopes),
    }


def _paged_case(gen, B, H, KV, Hd, bs, n_max, pos, bias, alibi):
    import torch
    dev, dt = "cuda", torch.bfloat16
    nb = B * n_max + 1
    kp = torch.randn((nb, bs, KV, Hd), generator=gen, device=dev).to(dt)
    vp = torch.randn((nb, bs, KV, Hd), generator=gen, device=dev).to(dt)
    q = torch.randn((B, H, Hd), generator=gen, device=dev).to(dt)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1   # block 0 stays the dummy
    bt = perm[:B * n_max].reshape(B, n_max).to(torch.int32).contiguous()
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    pad = (torch.randn((B, n_max * bs), generator=gen, device=dev) * 0.2) if bias else None
    slopes = (torch.rand((H,), generator=gen, device=dev) * 0.3 + 0.05) if alibi else None
    return q, kp, vp, bt, pos_t, pad, slopes


def _paged_faults(pda, q, kp, vp, bt, pos_t, pad, slopes):
    """The plain version with a kernel fault planted: the kv head index off
    by one, and the last live block skipped in every row that has more than
    one (at pos 128 that block holds 1 key of 129)."""
    import torch
    bs = kp.shape[1]
    kpos = torch.arange(bt.shape[1] * bs, device=q.device)
    start = (pos_t.long() // bs * bs)[:, None]
    last = (kpos[None, :] >= start) & (start > 0)
    drop = torch.where(last, -1e9, 0.0)
    if pad is not None:
        drop = drop + pad
    return {
        "kv_head_shifted": pda.paged_decode_attention_plain(q, kp.roll(1, 2), vp.roll(1, 2),
                                                            bt, pos_t, pad, slopes),
        "last_block_dropped": pda.paged_decode_attention_plain(q, kp, vp, bt, pos_t, drop,
                                                               slopes),
    }


def _split_faults(partials, dtype, merge, mid=True):
    """Faults planted in the decode kernels' split algorithm (plain per-split
    partials ``(m, l, acc, live)`` and the plain ``merge``): the middle live
    split's partial dropped in every row with three or more (with ``mid``:
    not under ALiBi, whose slopes leave a middle split of a long history
    below a bf16 ulp of the output), and a combine that leaves out the
    e^(m_s - M) rescale (rows with two or more splits)."""
    m, l, acc, live = partials
    n_live = live.sum(-1)
    faults = {}
    if mid and int(n_live.max()) >= 3:
        mid = live.clone()
        rows = (n_live >= 3).nonzero().flatten()
        mid[rows, n_live[rows] // 2] = False
        faults["mid_split_dropped"] = merge(m, l, acc, mid, dtype)
    if int(n_live.max()) >= 2:
        faults["combine_unscaled"] = merge(m, l, acc, live, dtype, rescale=False)
    return faults


def _repeat(name, case, run, o, rec, failures):
    """A second launch must give the same bits (splits merged in order)."""
    import torch
    rec["repeat_bit_equal"] = bool(torch.equal(o, run()))
    if not rec["repeat_bit_equal"]:
        failures.append(f"{name} {case}: two launches differ")


def _hold(name, case, outs, refs, faults, failures, floor=0.0):
    """Kernel outputs against their plain versions in bf16 ulps (the worst
    of the outputs; ``floor`` as in :func:`ulp_err`), and against each
    planted fault, which must read above the limit. Returns the readings;
    failures are collected so every case prints before the phase fails."""
    import torch
    tol = ULP_TOL
    worst = lambda rs: max(ulp_err(o, r, floor) for o, r in zip(outs, rs))
    err = worst(refs)
    fault_err = {f: worst(r) for f, r in faults.items()}
    if not all(torch.isfinite(o.float()).all().item() for o in outs):
        failures.append(f"{name} {case}: non-finite output")
    if not err <= tol:
        failures.append(f"{name} {case}: {err} bf16 ulps > {tol}")
    for f, e in fault_err.items():
        if not e > tol:
            failures.append(f"{name} {case}: planted fault {f} reads {e} ulps <= {tol}")
    return {"max_abs_err": max(float((o.float() - r.float()).abs().max())
                               for o, r in zip(outs, refs)),
            "ulp_err": err, "ulp_tol": tol, "ulp_floor": floor, "fault_ulp_err": fault_err}


def phase_kernel(state, seed):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the head-dim-96 and block-layout cases draw from their own generator,
    # so every other case sees the same inputs as before they were added
    gen96 = torch.Generator(device="cuda").manual_seed(seed + 96)
    genlse = torch.Generator(device="cuda").manual_seed(seed + 11)
    pick = lambda name: gen96 if name.startswith("hd96") else gen
    results = state.setdefault("kernel_results", {})
    failures = []

    # A: (B, S, H, KV, Hd, causal, alibi, mask); "slice" = a Llama-7B
    # prefill at the 512-token bucket, "train_slice" = one micro-batch of
    # the train phase (its forward and remat recompute)
    flash_cases = {
        "slice": (1, 512, 32, 32, 128, True, False, False),
        "train_slice": (4, TRAIN_SEQ, 32, 32, 128, True, False, False),
        "gqa4_unaligned": (2, 300, 32, 8, 128, True, False, False),
        "gpt2_hd64": (2, 200, 12, 12, 64, True, False, False),
        "alibi_mask_full": (2, 130, 8, 2, 64, False, True, True),
        "alibi_mask_causal_hd128": (1, 257, 16, 16, 128, True, True, True),
        "hd96_gqa4_mask": (2, 300, 16, 4, 96, True, False, True),
        "hd96_neox20b": (1, 2048, 64, 64, 96, True, False, False),
    }
    for name, (B, S, H, KV, Hd, causal, alibi, mask) in flash_cases.items():
        args = _flash_case(pick(name), B, S, H, KV, Hd, causal, alibi, mask)
        o, lse = fa.flash_attention(*args, return_lse=True)
        ro, rlse = fa.flash_attention_plain(*args)
        faults = _flash_faults(fa, *args)
        torch.cuda.synchronize()
        rec = {"kernel": "flash_attention_fwd", "case": name, "shape": [B, S, H, KV, Hd],
               "causal": causal, "alibi": alibi, "mask": mask,
               **_hold("flash_attention_fwd", name, [o], [ro],
                       {f: [r[0]] for f, r in faults.items()}, failures)}
        rec["lse_err"] = float((lse - rlse).abs().max())
        rec["lse_tol"] = LSE_TOL
        rec["fault_lse_err"] = float((lse - faults["last_key_dropped"][1]).abs().max())
        if not rec["lse_err"] <= LSE_TOL:
            failures.append(f"flash {name}: lse err {rec['lse_err']} > {LSE_TOL}")
        if not rec["fault_lse_err"] > LSE_TOL:
            failures.append(f"flash {name}: lse of last_key_dropped reads "
                            f"{rec['fault_lse_err']} <= {LSE_TOL}")
        if name in ("train_slice", "gqa4_unaligned"):     # no split, no atomics: same bits
            o2, lse2 = fa.flash_attention(*args, return_lse=True)
            rec["repeat_bit_equal"] = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
            if not rec["repeat_bit_equal"]:
                failures.append(f"flash {name}: two launches differ")
            del o2, lse2
        if name in ("slice", "train_slice", "gpt2_hd64"):   # the serve, train and Hd 64 call sites
            q, k, v = args[0], args[1], args[2]
            rec["ms"] = cuda_ms(lambda: fa.flash_attention(*args))
            rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(*args), reps=10, warmup=2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rec["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
            elem = q.element_size()
            nbytes = elem * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S
            flops = 4 * B * H * Hd * (S * (S + 1) // 2)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
            if name == "slice":
                results["flash_attention_fwd"] = rec
        if name == "hd96_neox20b":      # gpt_neox 20b's heads: what the zero padding costs
            padded = [fa.pad_head_dim(x, 128) for x in args[:3]]
            rec["ms"] = cuda_ms(lambda: fa.flash_attention(*args))
            rec["prepadded_hd128_ms"] = cuda_ms(
                lambda: fa.flash_attention(*padded, *args[3:], scale=96**-0.5))
            del padded
        emit("kernel", **rec)

    # B: (B, H, KV, Hd, bs, n_max, pos, bias, alibi); "slice" = a Llama-7B
    # fused decode step: 8 rows at ragged depths, 16-block tables;
    # "serve_width" = the serve's real table (n_max 4096 / 128), one row at
    # its last slot (32 live splits), one at 0 (31 empty splits)
    paged_cases = {
        "slice": (8, 32, 32, 128, 128, 16, [543, 31, 127, 128, 300, 0, 511, 255], False, False),
        "serve_width": (8, 32, 32, 128, 128, 32, [4095, 0, 543, 31, 1000, 2047, 128, 300],
                        False, False),
        "gqa4_bias_alibi": (3, 32, 8, 128, 128, 4, [127, 128, 511], True, True),
        "gpt2_hd64_boundaries": (4, 12, 12, 64, 128, 8, [0, 255, 256, 1023], False, False),
        "g2_hd64_bs256_bias": (2, 8, 4, 64, 256, 3, [255, 700], True, False),
        "g8_alibi": (2, 16, 2, 128, 128, 2, [5, 200], False, True),
        "hd96_gqa4_bias": (3, 16, 4, 96, 128, 6, [0, 300, 767], True, False),
    }
    for name, (B, H, KV, Hd, bs, n_max, pos, bias, alibi) in paged_cases.items():
        q, kp, vp, bt, pos_t, pad, slopes = _paged_case(pick(name), B, H, KV, Hd, bs, n_max, pos,
                                                       bias, alibi)
        run = lambda: pda.paged_decode_attention_cuda(q, kp, vp, bt, pos_t, pad, slopes)
        plain = lambda: pda.paged_decode_attention_plain(q, kp, vp, bt, pos_t, pad, slopes)
        o, ro = run(), plain()
        faults = _paged_faults(pda, q, kp, vp, bt, pos_t, pad, slopes)
        faults.update(_split_faults(pda.paged_decode_partials_plain(q, kp, vp, bt, pos_t, pad,
                                                                    slopes),
                                    q.dtype, pda.merge_partials_plain, mid=not alibi))
        torch.cuda.synchronize()
        rec = {"kernel": "paged_decode_attention", "case": name,
               "shape": [B, H, KV, Hd, bs, n_max], "pos": pos, "bias": bias, "alibi": alibi,
               **_hold("paged_decode_attention", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures)}
        if name == "slice":
            _repeat("paged_decode_attention", name, run, o, rec, failures)
            rec["ms"] = cuda_ms(run)
            rec["device_ms"] = device_ms(run)
            rec["plain_ms"] = cuda_ms(plain, reps=20)
            rec["library_ms"] = None
            elem = q.element_size()
            live = sum(p + 1 for p in pos)
            nbytes = (elem * (2 * q.numel() + 2 * live * KV * Hd)
                      + 4 * bt.numel() + 4 * B)
            flops = 4 * live * H * Hd
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops)
            results["paged_decode_attention"] = rec
        emit("kernel", **rec)
    _check_dense_decode(pick, results, failures)
    _check_backward_kernels(pick, fa, results, failures)
    _check_sparse_kernels(gen96, fa, results, failures)
    _check_lse_backward(genlse, fa, results, failures)
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    _check_fused_adam(gen, fad, results, failures)
    _check_fused_ce(gen, results, failures)
    _check_fused_lamb(gen, results, failures)
    _check_sr_quantize(gen, results, failures)
    _check_hd256(torch.Generator(device="cuda").manual_seed(seed + 256), results, failures)
    _check_bwd_hd256(torch.Generator(device="cuda").manual_seed(seed + 257), fa, results,
                     failures)
    _check_dequant_int8(torch.Generator(device="cuda").manual_seed(seed + 8), results, failures)
    _check_encoder_attention(torch.Generator(device="cuda").manual_seed(seed + 64), fa, results,
                             failures)
    _check_spatial_bias_add(torch.Generator(device="cuda").manual_seed(seed + 25), results,
                            failures)
    _check_sd_attention(torch.Generator(device="cuda").manual_seed(seed + 40), fa, results,
                        failures)
    check(not failures, "kernel checks failed: " + "; ".join(failures))


# GPT-J-6B's attention (16 heads x 256, MHA): A at its 2048-token prefill,
# B at a serve step of 8 rows, K5 at static generate's 8 rows
HD256_FLASH = {"gptj_prefill": (1, 2048, 16, 16, 256, True, False, False),
               "gptj_prefill_mask": (1, 2048, 16, 16, 256, True, False, True),
               "hd256_gqa4_alibi_mask": (2, 300, 8, 2, 256, True, True, True)}
HD256_PAGED = {"gptj_slice": (8, 16, 16, 256, 128, 16, [543, 31, 127, 128, 300, 0, 511, 255],
                              False, False),
               "hd256_g8_bias_alibi": (2, 16, 2, 256, 128, 4, [5, 400], True, True)}
HD256_DENSE = {"gptj_slice": (8, 16, 16, 256, 1024, 575, False, False),
               "hd256_g8_bias_alibi": (2, 16, 2, 256, 384, 383, True, True)}


def _check_hd256(gen, results, failures):
    """A, B and K5 at head dim 256 (GPT-J's heads) against their plain
    versions under the phase's per-row measure, with the phase's planted
    faults (and the decode kernels' split faults); two launches bit-equal;
    at GPT-J's shapes the time, the plain version's, the bound and SDPA at
    Hd 256 for A and K5 (no PyTorch call computes B)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda
    for name, (B, S, H, KV, Hd, causal, alibi, mask) in HD256_FLASH.items():
        args = _flash_case(gen, B, S, H, KV, Hd, causal, alibi, mask)
        run = lambda: fa.flash_attention(*args, return_lse=True)
        (o, lse), (ro, rlse) = run(), fa.flash_attention_plain(*args)
        faults = _flash_faults(fa, *args)
        torch.cuda.synchronize()
        rec = {"kernel": "flash_attention_fwd", "case": name, "shape": [B, S, H, KV, Hd],
               "causal": causal, "alibi": alibi, "mask": mask,
               **_hold("flash_attention_fwd", name, [o], [ro],
                       {f: [r[0]] for f, r in faults.items()}, failures)}
        rec["lse_err"] = float((lse - rlse).abs().max())
        if not rec["lse_err"] <= LSE_TOL:
            failures.append(f"flash {name}: lse err {rec['lse_err']} > {LSE_TOL}")
        o2, lse2 = run()
        rec["repeat_bit_equal"] = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        if not rec["repeat_bit_equal"]:
            failures.append(f"flash {name}: two launches differ")
        if name == "gptj_prefill":
            q, k, v = args[:3]
            rec["ms"] = cuda_ms(lambda: fa.flash_attention(*args))
            rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(*args), reps=5, warmup=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rec["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
            nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * B * H * Hd * (S * (S + 1) // 2))
            results["flash_attention_fwd_hd256"] = rec
        del o, lse, ro, rlse, faults, o2, lse2
        emit("kernel", **rec)
    for name, (B, H, KV, Hd, bs, n_max, pos, bias, alibi) in HD256_PAGED.items():
        q, kp, vp, bt, pos_t, pad, slopes = _paged_case(gen, B, H, KV, Hd, bs, n_max, pos, bias,
                                                       alibi)
        run = lambda: pda.paged_decode_attention_cuda(q, kp, vp, bt, pos_t, pad, slopes)
        plain = lambda: pda.paged_decode_attention_plain(q, kp, vp, bt, pos_t, pad, slopes)
        o, ro = run(), plain()
        faults = _paged_faults(pda, q, kp, vp, bt, pos_t, pad, slopes)
        faults.update(_split_faults(pda.paged_decode_partials_plain(q, kp, vp, bt, pos_t, pad,
                                                                    slopes),
                                    q.dtype, pda.merge_partials_plain, mid=not alibi))
        torch.cuda.synchronize()
        rec = {"kernel": "paged_decode_attention", "case": name,
               "shape": [B, H, KV, Hd, bs, n_max], "pos": pos, "bias": bias, "alibi": alibi,
               **_hold("paged_decode_attention", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures)}
        _repeat("paged_decode_attention", name, run, o, rec, failures)
        if name == "gptj_slice":
            rec["ms"] = cuda_ms(run)
            rec["device_ms"] = device_ms(run)
            rec["plain_ms"] = cuda_ms(plain, reps=20)
            rec["library_ms"] = None
            live = sum(p + 1 for p in pos)
            nbytes = (q.element_size() * (2 * q.numel() + 2 * live * KV * Hd)
                      + 4 * bt.numel() + 4 * B)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * live * H * Hd)
            results["paged_decode_attention_hd256"] = rec
        emit("kernel", **rec)
    for name, (B, H, KV, Hd, Smax, pos, bias, alibi) in HD256_DENSE.items():
        q = torch.randn((B, H, Hd), generator=gen, device="cuda").to(torch.bfloat16)
        ck = torch.randn((B, Smax, KV, Hd), generator=gen, device="cuda").to(torch.bfloat16)
        cv = torch.randn((B, Smax, KV, Hd), generator=gen, device="cuda").to(torch.bfloat16)
        pad = (torch.randn((B, Smax), generator=gen, device="cuda") * 0.2) if bias else None
        slopes = ((torch.rand((H,), generator=gen, device="cuda") * 0.3 + 0.05) if alibi
                  else None)
        run = lambda: dda.decode_attention_cuda(q, ck, cv, pos, pad, slopes)
        plain = lambda: dda.decode_attention_plain(q, ck, cv, pos, pad, slopes)
        o, ro = run(), plain()
        faults = _dense_faults(dda, q, ck, cv, pos, pad, slopes)
        faults.update(_split_faults(dda.decode_partials_plain(q, ck, cv, pos, pad, slopes),
                                    q.dtype, dda.merge_partials_plain, mid=not alibi))
        torch.cuda.synchronize()
        rec = {"kernel": "dense_decode_attention", "case": name,
               "shape": [B, H, KV, Hd, Smax], "pos": pos, "bias": bias, "alibi": alibi,
               **_hold("dense_decode_attention", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures)}
        _repeat("dense_decode_attention", name, run, o, rec, failures)
        if name == "gptj_slice":
            rec["ms"] = cuda_ms(run)
            rec["device_ms"] = device_ms(run)
            rec["plain_ms"] = cuda_ms(plain, reps=20)
            qt = (q * Hd**-0.5).reshape(B, H, 1, Hd)
            kt = ck[:, :pos + 1].transpose(1, 2).contiguous()
            vt = cv[:, :pos + 1].transpose(1, 2).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
            rec["library_ms"] = cuda_ms(sdpa)
            rec["library"] = "SDPA of one query over the live prefix"
            nbytes = q.element_size() * (2 * q.numel() + 2 * B * (pos + 1) * KV * Hd)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * B * (pos + 1) * H * Hd)
            results["dense_decode_attention_hd256"] = rec
        emit("kernel", **rec)


# C and D at head dim 256 (GPT-J's heads): (B, S, H, KV, Hd, causal, alibi,
# mask, masked_row); "gptj_train" = one micro-batch of the train_gptj phase
HD256_BWD = {"gptj_train": (4, TRAIN_SEQ, 16, 16, 256, True, False, False, False),
             "gptj_train_mask": (4, TRAIN_SEQ, 16, 16, 256, True, False, True, True),
             "hd256_gqa4_alibi_mask": (2, 300, 8, 2, 256, True, True, True, False),
             "hd256_full_gqa4": (2, 130, 4, 1, 256, False, False, True, True)}


def _check_bwd_hd256(gen, fa, results, failures):
    """C and D at head dim 256 (C on 32-key k/v stages, D as its own 64-key
    kernel, flash_attention_bwd.cu) against their plain versions under the
    phase's per-row measure, with :func:`_bwd_faults` planted and a kv head
    shifted (k and v rolled one kv head) above the limit; two launches of
    each bit-equal; at GPT-J's train shape the time, the plain version's,
    SDPA's backward at Hd 256 and the bound."""
    import torch
    for name, (B, S, H, KV, Hd, causal, alibi, mask, masked_row) in HD256_BWD.items():
        args, kw = _bwd_case(gen, fa, B, S, H, KV, Hd, causal, alibi, mask, masked_row)
        dq = fa.flash_attention_dq(*args, **kw)
        dk, dv = fa.flash_attention_dkv(*args, **kw)
        again = (fa.flash_attention_dq(*args, **kw), *fa.flash_attention_dkv(*args, **kw))
        rdq = fa.flash_attention_dq_plain(*args, **kw)
        rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
        fdq, fdkv = _bwd_faults(fa, args, kw)
        if KV > 1:
            shifted = (args[0], args[1].roll(1, 2), args[2].roll(1, 2)) + args[3:]
            fdq["kv_head_shifted"] = fa.flash_attention_dq_plain(*shifted, **kw)
            fdkv["kv_head_shifted"] = fa.flash_attention_dkv_plain(*shifted, **kw)
        torch.cuda.synchronize()
        shape = {"shape": [B, S, H, KV, Hd], "causal": causal, "alibi": alibi, "mask": mask,
                 "fully_masked_row": masked_row}
        rec_c = {"kernel": "flash_attention_bwd_dq", "case": name, **shape,
                 **_hold("flash_attention_bwd_dq", name, [dq], [rdq],
                         {f: [r] for f, r in fdq.items()}, failures, GRAD_FLOOR),
                 "repeat_bit_equal": bool(torch.equal(dq, again[0]))}
        rec_d = {"kernel": "flash_attention_bwd_dkv", "case": name, **shape,
                 **_hold("flash_attention_bwd_dkv", name, [dk, dv], [rdk, rdv],
                         {f: list(r) for f, r in fdkv.items()}, failures, GRAD_FLOOR),
                 "repeat_bit_equal": bool(torch.equal(dk, again[1]) and torch.equal(dv, again[2]))}
        for rec in (rec_c, rec_d):
            if not rec["repeat_bit_equal"]:
                failures.append(f"{rec['kernel']} {name}: two launches differ")
        del again, rdq, rdk, rdv, fdq, fdkv
        if name == "gptj_train":
            q, k, v, do = args[:4]
            elem = q.element_size()
            tri = B * H * (S * (S + 1) // 2) * Hd * 2        # one causal S x S x Hd product
            rows_bytes = 2 * 4 * B * H * S
            rec_c["ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, **kw))
            rec_d["ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*args, **kw))
            rec_c["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dq_plain(*args, **kw),
                                        reps=3, warmup=1)
            rec_d["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dkv_plain(*args, **kw),
                                        reps=3, warmup=1)
            lib = _sdpa_backward_ms(q, k, v, do, True)
            rec_c["library_ms"] = rec_d["library_ms"] = lib
            rec_c["library"] = rec_d["library"] = "SDPA backward at Hd 256 (dq, dk, dv together)"
            rec_c["bound_ms"], rec_c["bound_by"] = bound(
                elem * (2 * q.numel() + k.numel() + v.numel() + do.numel()) + rows_bytes, 3 * tri)
            rec_d["bound_ms"], rec_d["bound_by"] = bound(
                elem * (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) + rows_bytes,
                4 * tri)
            results["flash_attention_bwd_dq_hd256"] = rec_c
            results["flash_attention_bwd_dkv_hd256"] = rec_d
        del args, dq, dk, dv
        emit("kernel", **rec_c)
        emit("kernel", **rec_d)


# A, C and D at the encoders' shapes (Hd 64): BERT-large's attention in
# bert_train ([32, 512, 16 heads], non-causal, a quarter of the rows padded,
# the padding as mask_bias), and A at CLIP ViT-L/14's text tower (a batch of
# 16 prompts, 77 tokens, 12 heads, causal) and vision tower (8 images, 257
# tokens, 16 heads, non-causal)
# "ltd": BERT-large at a ragged S of the data-efficiency curriculum (the
# train_data_efficiency phase's step 3), A through its op dstpu::flash_fwd
ENCODER_FLASH = {"bert": (BERT_MICRO, BERT_SEQ, 16, 64, False, True),
                 "clip_text": (CLIP_TEXT_BATCH, 77, 12, 64, True, False),
                 "clip_vision": (CLIP_IMAGE_BATCH, 257, 16, 64, False, False),
                 "ltd": (BERT_MICRO, 360, 16, 64, False, True)}


def padding_bias(gen, B, S, share=0.25):
    """A key-padding mask_bias ``[B, S]`` (0 keep, -1e9 drop): ``share`` of
    the rows padded past a length drawn in 64..S-1, and the lengths."""
    import torch
    lengths = torch.full((B,), S, dtype=torch.long)
    rows = torch.randperm(B, generator=gen, device=gen.device)[:int(B * share)].cpu()
    lengths[rows] = torch.randint(64, S, (len(rows),), generator=gen, device=gen.device).cpu()
    keep = torch.arange(S)[None] < lengths[:, None]
    return torch.where(keep, 0.0, -1e9).float().to(gen.device), lengths


def _check_encoder_attention(gen, fa, results, failures):
    """A, C and D at the encoder shapes (ENCODER_FLASH) against their plain
    versions under the phase's per-row measures, with the phase's planted
    faults, the padding mask dropped and the causal flag flipped above the
    limit, two launches bit-equal (A once through its op
    ``dstpu::flash_fwd``, the path a training forward takes, once through
    the wrapper); each timed with its plain version, SDPA (the padding as
    an additive float mask; its backward for C and D) and the bound of the
    pairs this run's lengths leave. C and D at "bert" and "ltd"."""
    import torch
    import torch.nn.functional as F
    for name, (B, S, H, Hd, causal, padded) in ENCODER_FLASH.items():
        dev, dt = "cuda", torch.bfloat16
        q, k, v = (torch.randn((B, S, H, Hd), generator=gen, device=dev).to(dt) for _ in range(3))
        mb, lengths = padding_bias(gen, B, S) if padded else (None, torch.full((B,), S))
        kw = {"mask_bias": mb, "causal": causal}
        o, lse = fa.flash_fwd(q, k, v, mb, None, None, causal, None)
        ro, rlse = fa.flash_attention_plain(q, k, v, mb, causal)
        faults = {f: r[0] for f, r in _flash_faults(fa, q, k, v, mb, causal, None).items()}
        faults["causal_flipped"] = fa.flash_attention_plain(q, k, v, mb, not causal)[0]
        if padded:
            faults["padding_mask_dropped"] = fa.flash_attention_plain(q, k, v, None, causal)[0]
        o2, lse2 = fa.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        shape = {"shape": [B, S, H, H, Hd], "causal": causal, "padded_rows": int(
            (lengths < S).sum()), "lengths_padded": sorted(int(x) for x in lengths if x < S)}
        rec = {"kernel": "flash_attention_fwd", "case": name, **shape,
               **_hold("flash_attention_fwd", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures),
               "lse_err": float((lse - rlse).abs().max()),
               "repeat_bit_equal": bool(torch.equal(o, o2) and torch.equal(lse, lse2))}
        if not rec["lse_err"] <= LSE_TOL:
            failures.append(f"flash {name}: lse err {rec['lse_err']} > {LSE_TOL}")
        if not rec["repeat_bit_equal"]:
            failures.append(f"flash {name}: two launches differ")
        del ro, rlse, faults, o2, lse2
        # the (query, key) pairs the function needs: every query over its
        # row's live keys (below the diagonal when causal)
        live = lengths.double()
        pairs = int((live * S).sum()) * H if not causal else B * H * S * (S + 1) // 2
        elem = q.element_size()
        mask_bytes = 4 * B * S if padded else 0
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_mask = None if mb is None else mb[:, None, None, :].to(dt)
        rec["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
        rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, mb, causal),
                                  reps=3, warmup=1)
        rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, is_causal=causal))
        rec["library"] = "SDPA" + (" with the padding as an additive mask" if padded else "")
        rec["bound_ms"], rec["bound_by"] = bound(
            elem * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S + mask_bytes,
            4 * pairs * Hd)
        results[f"flash_attention_fwd_{name}"] = rec
        emit("kernel", **rec)
        if name not in ("bert", "ltd"):
            del q, k, v, o, lse
            continue
        do = torch.randn(q.shape, generator=gen, device=dev).to(dt)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq = fa.flash_attention_dq(*args, **kw)
        dk, dv = fa.flash_attention_dkv(*args, **kw)
        again = (fa.flash_attention_dq(*args, **kw), *fa.flash_attention_dkv(*args, **kw))
        rdq = fa.flash_attention_dq_plain(*args, **kw)
        rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
        fdq, fdkv = _bwd_faults(fa, args, kw)
        unmasked = {**kw, "mask_bias": None}
        fdq["padding_mask_dropped"] = fa.flash_attention_dq_plain(*args, **unmasked)
        fdkv["padding_mask_dropped"] = fa.flash_attention_dkv_plain(*args, **unmasked)
        torch.cuda.synchronize()
        rec_c = {"kernel": "flash_attention_bwd_dq", "case": name, **shape,
                 **_hold("flash_attention_bwd_dq", name, [dq], [rdq],
                         {f: [r] for f, r in fdq.items()}, failures, GRAD_FLOOR),
                 "repeat_bit_equal": bool(torch.equal(dq, again[0]))}
        rec_d = {"kernel": "flash_attention_bwd_dkv", "case": name, **shape,
                 **_hold("flash_attention_bwd_dkv", name, [dk, dv], [rdk, rdv],
                         {f: list(r) for f, r in fdkv.items()}, failures, GRAD_FLOOR),
                 "repeat_bit_equal": bool(torch.equal(dk, again[1]) and torch.equal(dv, again[2]))}
        del again, rdq, rdk, rdv, fdq, fdkv
        rows_bytes = 2 * 4 * B * H * S
        rec_c["ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, **kw))
        rec_d["ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*args, **kw))
        rec_c["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dq_plain(*args, **kw), reps=3,
                                    warmup=1)
        rec_d["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dkv_plain(*args, **kw), reps=3,
                                    warmup=1)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        fwd = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)
        both = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do.transpose(1, 2))
        lib = cuda_ms(both, reps=10) - cuda_ms(fwd, reps=10)
        for rec_x in (rec_c, rec_d):
            rec_x["library_ms"] = lib
            rec_x["library"] = ("SDPA backward with the padding as an additive mask (dq, dk, "
                                "dv together)")
            if not rec_x["repeat_bit_equal"]:
                failures.append(f"{rec_x['kernel']} {name}: two launches differ")
        one = 2 * pairs * Hd                     # one live S x S x Hd product, in FLOPs
        rec_c["bound_ms"], rec_c["bound_by"] = bound(
            elem * (2 * q.numel() + k.numel() + v.numel() + do.numel()) + rows_bytes + mask_bytes,
            3 * one)
        rec_d["bound_ms"], rec_d["bound_by"] = bound(
            elem * (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) + rows_bytes
            + mask_bytes, 4 * one)
        results[f"flash_attention_bwd_dq_{name}"] = rec_c
        results[f"flash_attention_bwd_dkv_{name}"] = rec_d
        emit("kernel", **rec_c)
        emit("kernel", **rec_d)
        del q, k, v, o, lse, do, delta, args, dq, dk, dv, qg, kg, vg
        torch.cuda.empty_cache()


# Llama-2-7B's MLP matrix w_gate / w_up [d_model, d_ff], at q_groups 1 (the
# engine's default) and 64
DEQUANT_CASES = {"llama7b_w_up_g1": (4096, 11008, 1), "llama7b_w_up_g64": (4096, 11008, 64)}


def _check_dequant_int8(gen, results, failures):
    """The int8 dequant kernel against its plain twin: one fp32 product and
    one rounding an element on both sides, so bit-equal (limit 0), with two
    planted faults above it (each row read with its neighbour's scales; the
    product rounded toward zero instead of to nearest); time, the plain
    version's and the bound (bytes); no single PyTorch call computes it."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import dequant_int8 as dq
    for name, (R, C, groups) in DEQUANT_CASES.items():
        q = torch.randint(-127, 128, (R, C), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand((R, groups), generator=gen, device="cuda") * 1e-3 + 1e-5
        run = lambda: dq.dequant_int8(q, scale, torch.bfloat16)
        plain = lambda: dq.dequant_int8_plain(q, scale, torch.bfloat16)
        got, want = run(), plain()
        wide = dq.dequant_int8_plain(q, scale, torch.float32)
        toward_zero = (wide.view(torch.int32) & ~0xFFFF).view(torch.float32).to(torch.bfloat16)
        faults = {"neighbour_row_scales": dq.dequant_int8_plain(q, scale.roll(1, 0)),
                  "rounded_toward_zero": toward_zero}
        torch.cuda.synchronize()
        bits = lambda x: x.view(torch.int16)
        differ = lambda x: int((bits(x) != bits(want)).sum())
        rec = {"kernel": "dequant_int8", "case": name, "shape": [R, C], "groups": groups,
               "elements_differing": differ(got), "limit": 0,
               "fault_elements_differing": {f: differ(x) for f, x in faults.items()},
               "max_abs_err": float((got.float() - want.float()).abs().max())}
        rec["repeat_bit_equal"] = bool(torch.equal(bits(got), bits(run())))
        if rec["elements_differing"] != 0 or not rec["repeat_bit_equal"]:
            failures.append(f"dequant_int8 {name}: {rec['elements_differing']} elements differ "
                            f"from the plain twin (repeat equal {rec['repeat_bit_equal']})")
        for f, n in rec["fault_elements_differing"].items():
            if not n > 0:
                failures.append(f"dequant_int8 {name}: planted fault {f} reads 0")
        rec["ms"] = cuda_ms(run)
        rec["device_ms"] = device_ms(run)
        rec["plain_ms"] = cuda_ms(plain, reps=10)
        rec["library_ms"] = None
        rec["bound_ms"], rec["bound_by"] = bound(R * C + 4 * R * groups + 2 * R * C, R * C,
                                                 FP32_PEAK_TFLOPS)
        if name == "llama7b_w_up_g1":
            results["dequant_int8"] = rec
        del got, want, wide, toward_zero, faults
        emit("kernel", **rec)


def _dense_faults(dda, q, ck, cv, pos, pad, slopes):
    """The plain version with a kernel fault planted: the kv head index off
    by one, and the last live 128-key block dropped (from pos 128 on) or,
    below that, the key past pos left unmasked."""
    import torch
    faults = {"kv_head_shifted": dda.decode_attention_plain(q, ck.roll(1, 2), cv.roll(1, 2),
                                                            pos, pad, slopes)}
    if pos >= 128:
        drop = torch.zeros(ck.shape[:2], device=q.device)
        drop[:, pos // 128 * 128:] = -1e9
        if pad is not None:
            drop = drop + pad
        faults["last_block_dropped"] = dda.decode_attention_plain(q, ck, cv, pos, drop, slopes)
    else:
        faults["key_past_pos_unmasked"] = dda.decode_attention_plain(q, ck, cv, pos + 1, pad,
                                                                     slopes)
    return faults


def _check_dense_decode(pick, results, failures):
    """The dense decode kernel (TPU K5) against its plain version at the
    generate phase's shape (Llama-7B heads, 8 rows, a 1024-slot workspace at
    pos 575), at a 4096-slot workspace at its last slot (32 splits) and at
    edge shapes, with faults planted in the plain version and in its split
    algorithm; two launches bit-equal and timed at the generate shape
    against SDPA of one query over the live prefix."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    dev, dt = "cuda", torch.bfloat16
    # (B, H, KV, Hd, Smax, pos, bias, alibi)
    cases = {
        "slice": (GEN_BATCH, 32, 32, 128, GEN_SMAX, GEN_PROMPT + GEN_MAX_NEW - 1, False, False),
        "gqa4_pos0_bias": (2, 32, 8, 128, 256, 0, True, False),
        "gqa8_last_slot_alibi": (3, 16, 2, 128, 384, 383, False, True),
        "gpt2_hd64_bias_alibi": (2, 12, 12, 64, 512, 200, True, True),
        "smax4096_last_slot": (GEN_BATCH, 32, 32, 128, 4096, 4095, False, False),
        "hd96_gqa8_bias_alibi": (2, 16, 2, 96, 512, 400, True, True),
    }
    for name, (B, H, KV, Hd, Smax, pos, bias, alibi) in cases.items():
        gen = pick(name)
        q = torch.randn((B, H, Hd), generator=gen, device=dev).to(dt)
        ck = torch.randn((B, Smax, KV, Hd), generator=gen, device=dev).to(dt)
        cv = torch.randn((B, Smax, KV, Hd), generator=gen, device=dev).to(dt)
        pad = (torch.randn((B, Smax), generator=gen, device=dev) * 0.2) if bias else None
        slopes = (torch.rand((H,), generator=gen, device=dev) * 0.3 + 0.05) if alibi else None
        run = lambda: dda.decode_attention_cuda(q, ck, cv, pos, pad, slopes)
        plain = lambda: dda.decode_attention_plain(q, ck, cv, pos, pad, slopes)
        o, ro = run(), plain()
        faults = _dense_faults(dda, q, ck, cv, pos, pad, slopes)
        faults.update(_split_faults(dda.decode_partials_plain(q, ck, cv, pos, pad, slopes),
                                    q.dtype, dda.merge_partials_plain, mid=not alibi))
        torch.cuda.synchronize()
        rec = {"kernel": "dense_decode_attention", "case": name,
               "shape": [B, H, KV, Hd, Smax], "pos": pos, "bias": bias, "alibi": alibi,
               **_hold("dense_decode_attention", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures)}
        if name == "slice":
            _repeat("dense_decode_attention", name, run, o, rec, failures)
            rec["ms"] = cuda_ms(run)
            rec["device_ms"] = device_ms(run)
            rec["plain_ms"] = cuda_ms(plain, reps=20)
            G = H // KV
            qt = (q * Hd**-0.5).reshape(B, H, 1, Hd)
            kt = ck[:, :pos + 1].transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vt = cv[:, :pos + 1].transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=1.0)
            rec["library_ms"] = cuda_ms(sdpa)
            rec["library_device_ms"] = device_ms(sdpa)
            rec["library"] = "SDPA of one query over the live prefix (GQA repeated outside)"
            live = B * (pos + 1) * KV * Hd
            nbytes = q.element_size() * (2 * q.numel() + 2 * live)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * B * (pos + 1) * H * Hd)
            results["dense_decode_attention"] = rec
        emit("kernel", **rec)


def _ce_case(gen, N, D, V, bias, tied, masked):
    """Inputs of the fused CE kernels: h [N, D] (unit rows, as after the
    final norm), W [D, V] (std 0.02; a [V, D] embedding read as W.T when
    tied), bias, labels, and the nll coefficient of a masked mean."""
    import torch
    dev, dt = "cuda", torch.bfloat16
    h = torch.randn((N, D), generator=gen, device=dev).to(dt)
    shape = (V, D) if tied else (D, V)
    w = (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt)
    w = w.T if tied else w
    b = (torch.randn((V,), generator=gen, device=dev) * 0.5) if bias else None
    labels = torch.randint(0, V, (N,), generator=gen, device=dev, dtype=torch.int32)
    valid = torch.ones((N,), device=dev)
    if masked:
        valid[torch.rand((N,), generator=gen, device=dev) < 0.1] = 0.0
    return h, w, b, labels, valid / valid.sum().clamp(min=1)


def _ce_faults(fce, h, w, b, labels, lse, coef, ds):
    """Plain versions with a kernel fault planted. F: the last vocab tile
    dropped, the gold logit read one column off; aimed at its wgmma
    mainloop and split: one 64-deep K chunk in the middle of D dropped, and
    one 256-wide vocab tile's partial (the one holding the label nearest V /
    2) left out of the combine. G: the onehot not
    subtracted, the last token tile skipped. dh: the 32-wide K chunk that
    holds the first token's label dropped, W's rows shifted by one. dW: the
    last 32 tokens dropped, h's rows shifted by one. Aimed at the wgmma
    mainloop of G, dh and dW: one 64-deep K chunk in the middle of the
    reduction dropped (a ring slot skipped; in dh the chunk that holds the
    label nearest V / 2), and the output's columns permuted within one
    64-wide block (16-byte chunks swapped in pairs, as a swizzle off by one;
    in G and dW the first whole block that holds a label)."""
    import torch
    N, V = ds.shape
    D = h.shape[1]
    drop = torch.zeros((V,), device=h.device) if b is None else b.clone()
    drop[(V - 1) // 128 * 128:] = -1e30
    mid = lambda n: (n + 63) // 64 // 2 * 64          # the middle 64-deep chunk of n
    h_cut = h.clone()
    h_cut[:, mid(D):mid(D) + 64] = 0
    part = fce.fused_ce_fwd_tiles_plain(h, w, b, labels)
    vt = int(labels[(labels - V // 2).abs().argmin()]) // 256
    f = {"last_vocab_tile_dropped": fce.fused_ce_fwd_plain(h, w, drop, labels),
         "gold_one_column_off": fce.fused_ce_fwd_plain(h, w, b, (labels + 1) % V),
         "mid_k_chunk_dropped": fce.fused_ce_fwd_plain(h_cut, w, b, labels),
         "vocab_tile_left_out": fce.fused_ce_combine_plain(
             torch.cat([part[:, :vt], part[:, vt + 1:]], dim=1))}
    swz = torch.arange(64, device=h.device) ^ 8

    def swizzled(x, c0):
        y = x.clone()
        y[:, c0:c0 + 64] = x[:, c0:c0 + 64][:, swz]
        return y

    c_lab = next(c for c in (int(x) // 64 * 64 for x in labels.tolist()) if c + 64 <= V)
    rds, _ = fce.fused_ce_ds_plain(h, w, b, labels, lse, coef)
    onehot = torch.zeros_like(rds, dtype=torch.float32)
    onehot[torch.arange(N, device=h.device), labels.long()] = coef
    cut = rds.clone()
    cut[(N - 1) // 128 * 128:] = 0
    g = {"onehot_not_subtracted": (rds.float() + onehot).to(rds.dtype),
         "last_token_tile_skipped": cut,
         "mid_k_chunk_dropped": fce.fused_ce_ds_plain(h_cut, w, b, labels, lse, coef)[0],
         "cols_swizzled_in_64_block": swizzled(rds, c_lab)}
    k_cut = ds.clone()
    k0 = int(labels[0]) // 32 * 32
    k_cut[:, k0:k0 + 32] = 0
    v_mid = int(labels[(labels - V // 2).abs().argmin()]) // 64 * 64
    k_mid = ds.clone()
    k_mid[:, v_mid:v_mid + 64] = 0
    rdh = fce.fused_ce_dh_plain(ds, w)
    dh = {"gold_k_chunk_dropped": fce.fused_ce_dh_plain(k_cut, w),
          "w_rows_shifted": fce.fused_ce_dh_plain(ds, w.roll(1, 0)),
          "mid_k_chunk_dropped": fce.fused_ce_dh_plain(k_mid, w),
          "cols_swizzled_in_64_block": swizzled(rdh, 0)}
    t_cut = ds.clone()
    t_cut[(N - 1) // 32 * 32:] = 0
    t_mid = ds.clone()
    t_mid[mid(N):mid(N) + 64] = 0
    dw = {"last_k_chunk_dropped": fce.fused_ce_dw_plain(h, t_cut),
          "h_rows_shifted": fce.fused_ce_dw_plain(h.roll(1, 0), ds),
          "mid_k_chunk_dropped": fce.fused_ce_dw_plain(h, t_mid),
          "cols_swizzled_in_64_block": swizzled(fce.fused_ce_dw_plain(h, ds), c_lab)}
    return f, g, dh, dw


def _ce_library_ms(h, w, labels):
    """The yardsticks: F.linear + F.cross_entropy forward, and its autograd
    backward (forward + backward minus forward) for G, dh and dW together."""
    import torch
    import torch.nn.functional as F
    hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()
    lab = labels.long()
    fwd = lambda: F.cross_entropy(F.linear(hh, ww.T), lab)
    both = lambda: torch.autograd.grad(fwd(), (hh, ww))
    f_ms = cuda_ms(fwd, reps=10)
    return f_ms, cuda_ms(both, reps=10) - f_ms


def _check_fused_ce(gen, results, failures):
    """Kernels F, G and the dh / dW products (TPU K3) against their plain
    versions at the train phase's micro-batch (N 8192, D 4096, V 32000,
    Llama's untied head) and at edge shapes: GPT-2's tied head (V 50257,
    read as embed.T) with a bias, an untied V 50257 W (copied into padded
    rows), N and V off the tiles, a reduction off the 64-deep chunk, masked
    tokens. Each kernel is fed the plain version's inputs (G the plain lse,
    the products the plain ds), so each is held alone. At the slice shape
    two launches of F, G, dh and dW must also be bit-equal, and two of F at
    the tied GPT-2 shape."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
    # (N, D, V, bias, tied, masked)
    cases = {
        "slice": (TRAIN_CONFIG["train_micro_batch_size_per_gpu"] * TRAIN_SEQ, 4096, 32000,
                  False, False, True),
        "gpt2_tied_bias": (1000, 768, 50257, True, True, True),
        "ragged_bias": (300, 512, 1000, True, False, True),
        # an untied W [768, 50257]: its rows are copied into padded rows for TMA
        "untied_v50257_bias": (1000, 768, 50257, True, False, True),
        # K % 64 != 0 in all three products (D 776, V 1000, N 1000), and M and
        # N end in partial 128- and 256-wide tiles in each
        "ragged_k": (1000, 776, 1000, False, False, True),
        # BERT-large's MLM head in bert_train: the 4096 gathered positions
        # (budget 0.25 of 32 x 512), the decoder bias, W the tied word
        # embedding [30522, 1024] read in place (V x 2 bytes is no multiple
        # of 16, but the embedding's rows are D long)
        "bert_mlm": (int(BERT_MICRO * BERT_SEQ * BERT_BUDGET), 1024, 30522, True, True, True),
    }
    for name, (N, D, V, bias, tied, masked) in cases.items():
        h, w, b, labels, coef = _ce_case(gen, N, D, V, bias, tied, masked)
        nll, lse = fce.fused_ce_fwd(h, w, b, labels)
        rnll, rlse = fce.fused_ce_fwd_plain(h, w, b, labels)
        ds, db = fce.fused_ce_ds(h, w, b, labels, rlse, coef)
        rds, rdb = fce.fused_ce_ds_plain(h, w, b, labels, rlse, coef)
        dh, dw = fce.fused_ce_dh(rds, w), fce.fused_ce_dw(h, rds, w)
        rdh, rdw = fce.fused_ce_dh_plain(rds, w), fce.fused_ce_dw_plain(h, rds)
        f_f, f_g, f_dh, f_dw = _ce_faults(fce, h, w, b, labels, rlse, coef, rds)
        torch.cuda.synchronize()
        shape = {"shape": [N, D, V], "bias": bias, "tied": tied, "masked": masked}
        ce_err = lambda x, y: float((x - y).abs().max())
        rec_f = {"kernel": "fused_ce_fwd", "case": name, **shape,
                 "max_abs_err": max(ce_err(lse, rlse), ce_err(nll, rnll)),
                 "lse_err": ce_err(lse, rlse), "nll_err": ce_err(nll, rnll), "tol": CE_TOL,
                 "fault_err": {k: max(ce_err(lse, r[1]), ce_err(nll, r[0]))
                               for k, r in f_f.items()}}
        if not (torch.isfinite(nll).all() and rec_f["max_abs_err"] <= CE_TOL):
            failures.append(f"fused_ce_fwd {name}: {rec_f['max_abs_err']} > {CE_TOL}")
        for k, e in rec_f["fault_err"].items():
            if not e > CE_TOL:
                failures.append(f"fused_ce_fwd {name}: planted fault {k} reads {e} <= {CE_TOL}")
        if name in ("slice", "gpt2_tied_bias", "bert_mlm"):   # no split-K, no atomics: same bits
            nll2, lse2 = fce.fused_ce_fwd(h, w, b, labels)
            rec_f["repeat_bit_equal"] = bool(torch.equal(nll, nll2) and torch.equal(lse, lse2))
            if not rec_f["repeat_bit_equal"]:
                failures.append(f"fused_ce_fwd {name}: two launches differ")
            del nll2, lse2
        # G is held on ds and on ds without its gold column: a row's ulp is
        # set by its gold entry (about -coef), which hides the softmax part
        # (coef p, p ~ 1 / V) that a dropped K chunk of the logits moves
        gold = torch.zeros(ds.shape, dtype=torch.bool, device=h.device)
        gold[torch.arange(N, device=h.device), labels.long()] = True
        soft = lambda x: x.float().masked_fill(gold, 0.0)
        rec_g = {"kernel": "fused_ce_ds", "case": name, **shape,
                 **_hold("fused_ce_ds", name, [ds, soft(ds)], [rds, soft(rds)],
                         {k: [r, soft(r)] for k, r in f_g.items()}, failures, GRAD_FLOOR)}
        if bias:
            rec_g["db_rel_err"] = float((db - rdb).abs().max() / rdb.abs().max())
            if not rec_g["db_rel_err"] <= DB_TOL:
                failures.append(f"fused_ce_ds {name}: db {rec_g['db_rel_err']} > {DB_TOL}")
        rec_dh = {"kernel": "fused_ce_dh_gemm", "case": name, **shape,
                  **_hold("fused_ce_dh_gemm", name, [dh], [rdh],
                          {k: [r] for k, r in f_dh.items()}, failures, GRAD_FLOOR)}
        rec_dw = {"kernel": "fused_ce_dw_gemm", "case": name, **shape,
                  **_hold("fused_ce_dw_gemm", name, [dw], [rdw],
                          {k: [r] for k, r in f_dw.items()}, failures, GRAD_FLOOR)}
        if name in ("slice", "bert_mlm"):
            again = (fce.fused_ce_ds(h, w, b, labels, rlse, coef), fce.fused_ce_dh(rds, w),
                     fce.fused_ce_dw(h, rds, w))
            for rec, x, y in ((rec_g, ds, again[0][0]), (rec_dh, dh, again[1]),
                              (rec_dw, dw, again[2])):
                rec["repeat_bit_equal"] = bool(torch.equal(x, y))
                if not rec["repeat_bit_equal"]:
                    failures.append(f"{rec['kernel']} {name}: two launches differ")
            del again
            elem = h.element_size()
            flops = 2 * N * D * V
            in_bytes = elem * (h.numel() + w.numel()) + 4 * N
            rec_f["ms"] = cuda_ms(lambda: fce.fused_ce_fwd(h, w, b, labels), reps=10)
            rec_g["ms"] = cuda_ms(lambda: fce.fused_ce_ds(h, w, b, labels, rlse, coef), reps=10)
            rec_dh["ms"] = cuda_ms(lambda: fce.fused_ce_dh(rds, w), reps=10)
            rec_dw["ms"] = cuda_ms(lambda: fce.fused_ce_dw(h, rds, w), reps=10)
            rec_f["plain_ms"] = cuda_ms(lambda: fce.fused_ce_fwd_plain(h, w, b, labels),
                                        reps=3, warmup=1)
            rec_g["plain_ms"] = cuda_ms(
                lambda: fce.fused_ce_ds_plain(h, w, b, labels, rlse, coef), reps=3, warmup=1)
            rec_dh["plain_ms"] = cuda_ms(lambda: fce.fused_ce_dh_plain(rds, w), reps=3, warmup=1)
            rec_dw["plain_ms"] = cuda_ms(lambda: fce.fused_ce_dw_plain(h, rds), reps=3, warmup=1)
            f_ms, bwd_ms = _ce_library_ms(h, w, labels)
            rec_f["library_ms"] = f_ms
            rec_f["library"] = "F.linear + F.cross_entropy forward"
            for rec in (rec_g, rec_dh, rec_dw):
                rec["library_ms"] = bwd_ms
                rec["library"] = "F.linear + F.cross_entropy backward (G, dh and dW together)"
            rec_f["bound_ms"], rec_f["bound_by"] = bound(in_bytes + 8 * N, flops)
            rec_g["bound_ms"], rec_g["bound_by"] = bound(in_bytes + 8 * N + elem * N * V, flops)
            rec_dh["bound_ms"], rec_dh["bound_by"] = bound(elem * (N * V + D * V + N * D),
                                                           flops)
            rec_dw["bound_ms"], rec_dw["bound_by"] = bound(elem * (h.numel() + N * V + D * V),
                                                           flops)
            sfx = "" if name == "slice" else "_bert"
            results.update({"fused_ce_fwd" + sfx: rec_f, "fused_ce_ds" + sfx: rec_g,
                            "fused_ce_dh_gemm" + sfx: rec_dh, "fused_ce_dw_gemm" + sfx: rec_dw})
        for rec in (rec_f, rec_g, rec_dh, rec_dw):
            emit("kernel", **rec)
        del h, w, nll, lse, rnll, rlse, ds, rds, dh, dw, rdh, rdw, f_f, f_g, f_dh, f_dw, gold
        torch.cuda.empty_cache()


def _bwd_case(gen, fa, B, S, H, KV, Hd, causal, alibi, mask, masked_row):
    """Inputs of the backward kernels from kernel A's own output and lse:
    ``(q, k, v, do, lse, delta)`` and the keyword arguments."""
    import torch
    q, k, v, mask_bias, causal, slopes = _flash_case(gen, B, S, H, KV, Hd, causal, alibi, mask)
    if masked_row:
        mask_bias[-1] = float("-inf")          # every key of the last batch row masked
    kw = {"mask_bias": mask_bias, "causal": causal, "alibi_slopes": slopes}
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), kw


def _bwd_faults(fa, args, kw):
    """The plain backward with a kernel fault planted. Both kernels: the last
    key tile skipped (the keys past the last multiple of 64 dropped from the
    sums), delta not subtracted. C also, aimed at its ring and its two
    warpgroups: one 64-key k/v stage skipped in the middle of the causal
    range (keys from the 64-multiple below S / 2), and each 128-row q tile's
    lse and delta read from the other warpgroup's rows (rows shifted by 64
    within the tile; rows past S read lse = 1e30, delta = 0). D also: the
    last q tile skipped and, for G > 1, dk / dv taken from the first query
    head of each group only."""
    import torch
    q, k, v, do, lse, delta = args
    B, S, H, _ = q.shape
    KV = k.shape[2]

    def keys_dropped(k0):
        drop = torch.zeros((B, S), device=q.device)
        drop[:, k0:k0 + 64] = -1e9
        return {**kw, "mask_bias": drop if kw["mask_bias"] is None else drop + kw["mask_bias"]}

    no_tile = keys_dropped((S - 1) // 64 * 64)
    zero_delta = (q, k, v, do, lse, torch.zeros_like(delta))
    n128 = -(-S // 128) * 128
    swap = (torch.arange(n128, device=q.device) ^ 64)[:S]   # row r reads row r ^ 64 of its tile
    pad = lambda x, value: torch.nn.functional.pad(x, (0, n128 - S), value=value)
    rows_shifted = (q, k, v, do, pad(lse, 1e30)[..., swap].contiguous(),
                    pad(delta, 0.0)[..., swap].contiguous())
    dq = {"last_key_tile_skipped": fa.flash_attention_dq_plain(*args, **no_tile),
          "delta_not_subtracted": fa.flash_attention_dq_plain(*zero_delta, **kw),
          "mid_kv_stage_skipped": fa.flash_attention_dq_plain(
              *args, **keys_dropped(S // 2 // 64 * 64)),
          "lse_delta_rows_shifted_64": fa.flash_attention_dq_plain(*rows_shifted, **kw)}
    dkv = {"last_key_tile_skipped": fa.flash_attention_dkv_plain(*args, **no_tile),
           "delta_not_subtracted": fa.flash_attention_dkv_plain(*zero_delta, **kw)}
    lse_cut = lse.clone()
    lse_cut[:, :, (S - 1) // 64 * 64:] = 1e30                  # p = 0 for the last q tile
    dkv["last_q_tile_skipped"] = fa.flash_attention_dkv_plain(q, k, v, do, lse_cut, delta, **kw)
    G = H // KV
    if G > 1:
        first = lambda x: x.reshape(B, x.shape[1], KV, G, -1)[:, :, :, 0].contiguous()
        rows = lambda x: x.reshape(B, KV, G, S)[:, :, 0].contiguous()
        slopes = kw["alibi_slopes"]
        kw1 = {**kw, "alibi_slopes": None if slopes is None else slopes.reshape(KV, G)[:, 0]}
        dkv["group_not_summed"] = fa.flash_attention_dkv_plain(
            first(q), k, v, first(do), rows(lse), rows(delta), **kw1)
    return dq, dkv


def _sdpa_backward_ms(q, k, v, do, causal):
    """The yardstick for C + D: SDPA's backward on the same q / k / v / do,
    timed as forward + backward minus forward (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    both = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    return cuda_ms(both, reps=10) - cuda_ms(fwd, reps=10)


def _check_backward_kernels(pick, fa, results, failures):
    """Kernels C and D against their plain versions at the train path's
    shape and at edge shapes; timed at the Hd 128 and Hd 64 call sites.
    Two launches of C and of D must give the same bits at the train shape
    and in a GQA case."""
    import torch
    # (B, S, H, KV, Hd, causal, alibi, mask, masked_row); "slice" = one
    # micro-batch of the train phase (Llama-7B heads, S 2048)
    cases = {
        "slice": (4, TRAIN_SEQ, 32, 32, 128, True, False, False, False),
        "gpt2_hd64": (2, 1024, 12, 12, 64, True, False, False, False),
        "gqa4_ragged_s200": (1, 200, 32, 8, 128, True, False, False, False),
        "gqa8_alibi": (2, 256, 16, 2, 128, True, True, False, False),
        "mask_fully_masked_row": (2, 192, 8, 8, 128, True, False, True, True),
        "full_alibi_mask_gqa4_hd64": (2, 130, 4, 1, 64, False, True, True, False),
        "hd96_gqa4_alibi": (2, 256, 16, 4, 96, True, True, False, False),
        "hd96_neox20b": (1, 2048, 64, 64, 96, True, False, False, False),
    }
    for name, (B, S, H, KV, Hd, causal, alibi, mask, masked_row) in cases.items():
        args, kw = _bwd_case(pick(name), fa, B, S, H, KV, Hd, causal, alibi, mask, masked_row)
        dq = fa.flash_attention_dq(*args, **kw)
        dk, dv = fa.flash_attention_dkv(*args, **kw)
        rdq = fa.flash_attention_dq_plain(*args, **kw)
        rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
        fdq, fdkv = _bwd_faults(fa, args, kw)
        again = None
        if name in ("slice", "gqa4_ragged_s200"):
            again = (fa.flash_attention_dq(*args, **kw), *fa.flash_attention_dkv(*args, **kw))
        torch.cuda.synchronize()
        shape = {"shape": [B, S, H, KV, Hd], "causal": causal, "alibi": alibi, "mask": mask,
                 "fully_masked_row": masked_row}
        rec_c = {"kernel": "flash_attention_bwd_dq", "case": name, **shape,
                 **_hold("flash_attention_bwd_dq", name, [dq], [rdq],
                         {f: [r] for f, r in fdq.items()}, failures, GRAD_FLOOR)}
        rec_d = {"kernel": "flash_attention_bwd_dkv", "case": name, **shape,
                 **_hold("flash_attention_bwd_dkv", name, [dk, dv], [rdk, rdv],
                         {f: list(r) for f, r in fdkv.items()}, failures, GRAD_FLOOR)}
        if again is not None:                  # no split, no atomics: same bits
            rec_c["repeat_bit_equal"] = bool(torch.equal(dq, again[0]))
            rec_d["repeat_bit_equal"] = bool(torch.equal(dk, again[1]) and
                                             torch.equal(dv, again[2]))
            for rec in (rec_c, rec_d):
                if not rec["repeat_bit_equal"]:
                    failures.append(f"{rec['kernel']} {name}: two launches differ")
            del again
        if name in ("slice", "gpt2_hd64"):     # the Hd 128 and Hd 64 call sites
            q, k, v, do = args[:4]
            elem = q.element_size()
            tri = B * H * (S * (S + 1) // 2) * Hd * 2        # one causal S x S x Hd product
            rows_bytes = 2 * 4 * B * H * S                   # lse, delta
            rec_c["ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, **kw))
            rec_d["ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*args, **kw))
            rec_c["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dq_plain(*args, **kw),
                                        reps=3, warmup=1)
            rec_d["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dkv_plain(*args, **kw),
                                        reps=3, warmup=1)
            lib = _sdpa_backward_ms(q, k, v, do, True)
            rec_c["library_ms"] = rec_d["library_ms"] = lib
            rec_c["library"] = rec_d["library"] = "SDPA backward (dq, dk, dv together)"
            rec_c["bound_ms"], rec_c["bound_by"] = bound(
                elem * (2 * q.numel() + k.numel() + v.numel() + do.numel()) + rows_bytes, 3 * tri)
            rec_d["bound_ms"], rec_d["bound_by"] = bound(
                elem * (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) + rows_bytes,
                4 * tri)
            if name == "slice":
                results["flash_attention_bwd_dq"] = rec_c
                results["flash_attention_bwd_dkv"] = rec_d
        if name == "hd96_neox20b":      # gpt_neox 20b's heads: what the zero padding costs
            padded = [fa.pad_head_dim(x, 128) for x in args[:4]] + list(args[4:])
            hd96 = {**kw, "scale": 96**-0.5}
            rec_c["ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, **kw))
            rec_d["ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*args, **kw))
            rec_c["prepadded_hd128_ms"] = cuda_ms(lambda: fa.flash_attention_dq(*padded, **hd96))
            rec_d["prepadded_hd128_ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*padded, **hd96))
            del padded
        emit("kernel", **rec_c)
        emit("kernel", **rec_d)


# The layout cases of A, C and D: (B, S, H, KV, Hd, layout, causal, faults);
# "train_sparse" = one micro-batch of the train_sparse phase (Llama-7B heads,
# S 4096, the Fixed layout: 192 of 528 causal 128-blocks a head),
# "block64" = BigBird blocks of 64 (tiles straddle them: partial tiles in
# every kernel), "gqa4" = per-head BigBird layouts with H 32 over KV 8 (D sums
# over the group's own lists), "zero_row_block" = a random layout with an
# all-zero row block (o = 0, lse = 1e30, zero gradients there)
SPARSE_CASES = {
    "train_sparse": (2, SPARSE_SEQ, 32, 32, 128, "fixed128", True,
                     ("layout_ignored", "tile_dropped")),
    "block64": (1, 1024, 8, 8, 128, "bigbird64", False,
                ("layout_ignored", "tile_dropped", "partial_mask_left_out")),
    "gqa4": (1, 2048, 32, 8, 128, "bigbird128", False, ("layout_ignored", "tile_dropped")),
    "zero_row_block": (2, 1024, 8, 8, 128, "zero_row", True, ("layout_ignored",)),
    "hd256_fixed128": (1, TRAIN_SEQ, 16, 16, 256, "fixed128", True,
                       ("layout_ignored", "tile_dropped")),
    "hd256_block64_gqa2": (1, 1024, 8, 4, 256, "bigbird64", False,
                           ("layout_ignored", "tile_dropped", "partial_mask_left_out")),
    # the sparse BERT of encoder_parity (BERT-large heads, BigBird block 128,
    # bidirectional, S 1024), and blocks of 64 at Hd 64
    "bert_sparse_hd64": (2, 1024, 16, 16, 64, "bigbird128", False,
                         ("layout_ignored", "tile_dropped")),
    "hd64_block64": (1, 1024, 16, 16, 64, "bigbird64", False,
                     ("layout_ignored", "tile_dropped", "partial_mask_left_out")),
}


def sparse_layout(kind, H, S):
    """The block layouts of the sparse cases (CPU int64 ``[H, nb, nb]``)."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    if kind == "fixed128":
        return sparse_config(H).make_layout(S)
    if kind.startswith("bigbird"):
        return sa.BigBirdSparsityConfig(num_heads=H, block=int(kind[7:]),
                                        different_layout_per_head=True).make_layout(S)
    gen = torch.Generator().manual_seed(S + H)
    lay = (torch.rand((H, S // 128, S // 128), generator=gen) > 0.5).long()
    lay[0, 3] = 0                              # head 0's rows 384..511 attend nothing
    return lay


def sparse_config(H):
    """The train_sparse path's sparsity: Fixed, block 128, 4 local blocks, 1
    global, unidirectional."""
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    return FixedSparsityConfig(num_heads=H, block=128, num_local_blocks=4, num_global_blocks=1,
                               attention="unidirectional")


def _atoms(keep, S):
    """A kept-block mask ``[H, nb, nb]`` refined to 64-token blocks (every
    kernel tile is whole 64-token blocks when the layout block is 64 or 128)."""
    r = S // keep.shape[-1] // 64
    return keep.repeat_interleave(r, 1).repeat_interleave(r, 2)


def _layout_faults(fa, kernel, keep, S, causal, KV, wanted):
    """Layouts that plant a fault in ``kernel`` ("fwd" A, "dq" C, "dkv" D),
    each to feed its plain version: the whole layout ignored (None: dense
    attention), the middle live tile of the longest live-tile list dropped,
    and each partial tile taken whole (its element mask left out)."""
    import torch
    H = keep.shape[0]
    tq, tk = fa._TILES[kernel]
    out = {}
    if "layout_ignored" in wanted:
        out["layout_ignored"] = None
    if "tile_dropped" in wanted:
        offsets, entries = fa.live_tiles(keep, S, causal, kernel, KV)
        lengths = offsets[1:] - offsets[:-1]
        row = int(lengths.argmax())
        code = int(entries[int(offsets[row]) + int(lengths[row]) // 2]) >> 1
        atoms = _atoms(keep, S).clone()
        if kernel == "dkv":            # row = (kv head, key tile); code = (group head, q tile)
            nq = -(-S // tq)
            h = row // (-(-S // tk)) * (H // KV) + code // nq
            qt, kt = code % nq, row % (-(-S // tk))
        else:                          # row = (head, q tile); code = k tile
            h, qt, kt = row // (-(-S // tq)), row % (-(-S // tq)), code
        atoms[h, qt * tq // 64:(qt + 1) * tq // 64, kt * tk // 64:(kt + 1) * tk // 64] = False
        out["tile_dropped"] = atoms
    if "partial_mask_left_out" in wanted:
        live, full = fa._tile_grid(keep, S, tq, tk, causal)
        check(bool((live & ~full).any()), f"{kernel}: the case has no partial tile")
        whole = live.repeat_interleave(tq // 64, 1).repeat_interleave(tk // 64, 2)
        n = S // 64
        out["partial_mask_left_out"] = whole[:, :n, :n] | _atoms(keep, S)
    return out


def _sdpa_mask(keep, S, causal, device):
    """The layout as SDPA's boolean ``[1, H, S, S]`` mask (True = attend)."""
    import torch
    lb = S // keep.shape[-1]
    tok = keep.to(device).repeat_interleave(lb, 1).repeat_interleave(lb, 2)
    if causal:
        tok &= torch.ones((S, S), dtype=torch.bool, device=device).tril()
    return tok[None]


def live_pairs(keep, S, causal):
    """Token pairs the kept blocks hold (below the diagonal when causal),
    summed over heads: the work a layout leaves."""
    lb = S // keep.shape[-1]
    if not causal:
        return int(keep.sum()) * lb * lb
    nb = keep.shape[-1]
    diag = keep[:, range(nb), range(nb)].sum()
    return int(keep.sum() - diag) * lb * lb + int(diag) * lb * (lb + 1) // 2


def _check_sparse_kernels(gen, fa, results, failures):
    """A, C and D with a block layout against their layout-aware plain
    versions (the per-row ulp measures; lse within LSE_TOL), with the
    layout's faults planted in each plain version (above the limit), two
    launches bit-equal, the tiles each kernel walked equal to its lists'
    lengths; at the train_sparse shape timed against the plain versions,
    dense A / C / D on the same inputs and SDPA with the layout as a
    boolean mask (its backward for C + D)."""
    import torch
    import torch.nn.functional as F
    for name, (B, S, H, KV, Hd, kind, causal, wanted) in SPARSE_CASES.items():
        lay = sparse_layout(kind, H, S)
        keep = fa._layout_keep(lay, S, H, causal)
        q, k, v, _, _, _ = _flash_case(gen, B, S, H, KV, Hd, causal, False, False)
        kw = {"causal": causal, "block_layout": lay}
        fa.reset_tile_counts()
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta)
        dq = fa.flash_attention_dq(*args, **kw)
        dk, dv = fa.flash_attention_dkv(*args, **kw)
        walked = fa.tile_counts()
        want_walked = {kern: B * len(fa.live_tiles(keep, S, causal, kern, KV)[1])
                       for kern in ("fwd", "dq", "dkv")}
        again = fa.flash_attention(q, k, v, return_lse=True, **kw)
        again = (*again, fa.flash_attention_dq(*args, **kw), *fa.flash_attention_dkv(*args, **kw))
        ro, rlse = fa.flash_attention_plain(q, k, v, **kw)
        rdq = fa.flash_attention_dq_plain(*args, **kw)
        rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
        plant = lambda kern, fn: {
            f: fn({**kw, "block_layout": lf})
            for f, lf in _layout_faults(fa, kern, keep, S, causal, KV, wanted).items()}
        f_fwd = plant("fwd", lambda k_: fa.flash_attention_plain(q, k, v, **k_))
        f_dq = plant("dq", lambda k_: fa.flash_attention_dq_plain(*args, **k_))
        f_dkv = plant("dkv", lambda k_: fa.flash_attention_dkv_plain(*args, **k_))
        torch.cuda.synchronize()
        shape = {"shape": [B, S, H, KV, Hd], "layout": kind, "causal": causal,
                 "live_blocks": int(keep.sum()), "blocks": H * keep.shape[-1] ** 2}
        recs = {
            "fwd": {"kernel": "flash_attention_fwd_layout",
                    **_hold("flash_attention_fwd_layout", name, [o], [ro],
                            {f: [r[0]] for f, r in f_fwd.items()}, failures)},
            "dq": {"kernel": "flash_attention_bwd_dq_layout",
                   **_hold("flash_attention_bwd_dq_layout", name, [dq], [rdq],
                           {f: [r] for f, r in f_dq.items()}, failures, GRAD_FLOOR)},
            "dkv": {"kernel": "flash_attention_bwd_dkv_layout",
                    **_hold("flash_attention_bwd_dkv_layout", name, [dk, dv], [rdk, rdv],
                            {f: list(r) for f, r in f_dkv.items()}, failures, GRAD_FLOOR)},
        }
        rec_a = recs["fwd"]
        rec_a["lse_err"] = float((lse - rlse).abs().max())
        if not rec_a["lse_err"] <= LSE_TOL:
            failures.append(f"flash layout {name}: lse err {rec_a['lse_err']} > {LSE_TOL}")
        for kern, rec in recs.items():
            outs = {"fwd": (o, lse), "dq": (dq,), "dkv": (dk, dv)}[kern]
            reps = {"fwd": again[:2], "dq": again[2:3], "dkv": again[3:]}[kern]
            rec.update(case=name, **shape, tiles_walked=walked[kern],
                       tiles_in_lists=want_walked[kern],
                       repeat_bit_equal=all(torch.equal(a, b) for a, b in zip(outs, reps)))
            if rec["tiles_walked"] != rec["tiles_in_lists"]:
                failures.append(f"{rec['kernel']} {name}: walked {rec['tiles_walked']} tiles, "
                                f"its lists hold {rec['tiles_in_lists']}")
            if not rec["repeat_bit_equal"]:
                failures.append(f"{rec['kernel']} {name}: two launches differ")
        if kind == "zero_row":
            rows = slice(384, 512)
            dead = (float(o[:, rows, 0].float().abs().max()) == 0.0
                    and bool((lse[:, 0, rows] == 1e30).all())
                    and float(dq[:, rows, 0].float().abs().max()) == 0.0)
            rec_a["dead_rows_zero"] = dead
            if not dead:
                failures.append(f"flash layout {name}: a row with no live key is not o = 0, "
                                "lse = 1e30, dq = 0")
        del again, f_fwd, f_dq, f_dkv, ro, rdq, rdk, rdv
        if name in ("train_sparse", "bert_sparse_hd64"):
            pairs = live_pairs(keep, S, causal) * B
            elem = q.element_size()
            one = 2 * pairs * Hd                   # one live S x S x Hd product, in FLOPs
            rows_bytes = 2 * 4 * B * H * S
            recs["fwd"]["ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
            recs["dq"]["ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, **kw))
            recs["dkv"]["ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*args, **kw))
            recs["fwd"]["dense_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
            recs["dq"]["dense_ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, causal=causal))
            recs["dkv"]["dense_ms"] = cuda_ms(
                lambda: fa.flash_attention_dkv(*args, causal=causal))
            # device time too: by CUDA events a call of these short kernels
            # also reads the wrapper's host time
            for kern, run, dense in (
                    ("fwd", lambda: fa.flash_attention(q, k, v, **kw),
                     lambda: fa.flash_attention(q, k, v, causal=causal)),
                    ("dq", lambda: fa.flash_attention_dq(*args, **kw),
                     lambda: fa.flash_attention_dq(*args, causal=causal)),
                    ("dkv", lambda: fa.flash_attention_dkv(*args, **kw),
                     lambda: fa.flash_attention_dkv(*args, causal=causal))):
                recs[kern]["device_ms"] = device_ms(run)
                recs[kern]["dense_device_ms"] = device_ms(dense)
            recs["fwd"]["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                                              reps=3, warmup=1)
            recs["dq"]["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dq_plain(*args, **kw),
                                             reps=3, warmup=1)
            recs["dkv"]["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dkv_plain(*args, **kw),
                                              reps=3, warmup=1)
            mask = _sdpa_mask(keep, S, causal, q.device)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            recs["fwd"]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=10)
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            fwd = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            both = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do.transpose(1, 2))
            lib = cuda_ms(both, reps=10) - cuda_ms(fwd, reps=10)
            recs["dq"]["library_ms"] = recs["dkv"]["library_ms"] = lib
            recs["fwd"]["library"] = "SDPA with the layout as a boolean [1, H, S, S] mask"
            recs["dq"]["library"] = recs["dkv"]["library"] = (
                "SDPA backward with the boolean mask (dq, dk, dv together)")
            del mask, qg, kg, vg
            recs["fwd"]["bound_ms"], recs["fwd"]["bound_by"] = bound(
                elem * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S, 2 * one)
            recs["dq"]["bound_ms"], recs["dq"]["bound_by"] = bound(
                elem * (2 * q.numel() + k.numel() + v.numel() + do.numel()) + rows_bytes, 3 * one)
            recs["dkv"]["bound_ms"], recs["dkv"]["bound_by"] = bound(
                elem * (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) + rows_bytes,
                4 * one)
            for kern, rec in recs.items():
                rec["live_pair_share_of_causal"] = pairs / (B * H * S * (S + 1) // 2)
                if name == "train_sparse":      # the kernels' row: the train_sparse path
                    results[rec["kernel"]] = rec
        for rec in recs.values():
            emit("kernel", **rec)


# The differentiable lse: (B, S, H, KV, Hd, causal, alibi, layout); "dense" =
# the Llama-7B heads at S 1024, "gqa4_alibi" = GQA 4 under ALiBi,
# "zero_row" = the sparse cases' random layout whose head 0 rows 384..511
# keep no key (lse = 1e30 there: the lse cotangent must drop out)
LSE_CASES = {
    "dense": (2, 1024, 32, 32, 128, True, False, None),
    "gqa4_alibi": (2, 512, 32, 8, 128, True, True, None),
    "zero_row": (2, 1024, 8, 8, 128, True, False, "zero_row"),
    "hd256_gptj": (2, 1024, 16, 16, 256, True, False, None),
}


def lse_delta(o, do, dlse):
    """C's and D's row term for a loss on both o and the log2-domain lse:
    delta' = sum(do * o) - log2(e) * dlse, fp32 ``[B, H, S]``."""
    import math
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    return (delta - dlse.float() / math.log(2.0)).contiguous()


def _check_lse_backward(gen, fa, results, failures):
    """C and D through the two-output Function of ``flash_attention(...,
    return_lse=True)`` with a nonzero lse cotangent: dq, dk, dv against the
    plain versions fed delta' (the per-row ulp measures), the cotangent left
    out (delta unchanged) planted as the fault, two backward passes
    bit-equal, one launch of each kernel a backward; at the dense case the
    kernels timed with delta' against their bound and plain versions."""
    import torch
    for name, (B, S, H, KV, Hd, causal, alibi, kind) in LSE_CASES.items():
        q, k, v, _, causal, slopes = _flash_case(gen, B, S, H, KV, Hd, causal, alibi, False)
        kw = {"causal": causal, "alibi_slopes": slopes,
              "block_layout": None if kind is None else sparse_layout(kind, H, S)}
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        dlse = torch.randn((B, H, S), generator=gen, device="cuda")
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]

        def backward():
            o, lse = fa.flash_attention(*leaves, return_lse=True, **kw)
            return (o, lse), torch.autograd.grad((o, lse), leaves, (do, dlse))

        n = (fa.dq_launches, fa.dkv_launches)
        (o, lse), (dq, dk, dv) = backward()
        launched = (fa.dq_launches - n[0], fa.dkv_launches - n[1])
        _, again = backward()
        o, lse = o.detach(), lse.detach()
        args = (q, k, v, do, lse, lse_delta(o, do, dlse))
        rdq = fa.flash_attention_dq_plain(*args, **kw)
        rdk, rdv = fa.flash_attention_dkv_plain(*args, **kw)
        dropped = args[:5] + (lse_delta(o, do, torch.zeros_like(dlse)),)
        fdq = fa.flash_attention_dq_plain(*dropped, **kw)
        fdk, fdv = fa.flash_attention_dkv_plain(*dropped, **kw)
        torch.cuda.synchronize()
        shape = {"case": name, "shape": [B, S, H, KV, Hd], "causal": causal, "alibi": alibi,
                 "layout": kind, "launches_a_backward": list(launched)}
        rec_c = {"kernel": "flash_attention_bwd_dq_lse", **shape,
                 **_hold("flash_attention_bwd_dq_lse", name, [dq], [rdq],
                         {"lse_cotangent_left_out": [fdq]}, failures, GRAD_FLOOR)}
        rec_d = {"kernel": "flash_attention_bwd_dkv_lse", **shape,
                 **_hold("flash_attention_bwd_dkv_lse", name, [dk, dv], [rdk, rdv],
                         {"lse_cotangent_left_out": [fdk, fdv]}, failures, GRAD_FLOOR)}
        rec_c["repeat_bit_equal"] = bool(torch.equal(dq, again[0]))
        rec_d["repeat_bit_equal"] = bool(torch.equal(dk, again[1]) and torch.equal(dv, again[2]))
        if launched != (1, 1):
            failures.append(f"lse backward {name}: C and D launched {launched} times, not once")
        for rec in (rec_c, rec_d):
            if not rec["repeat_bit_equal"]:
                failures.append(f"{rec['kernel']} {name}: two backward passes differ")
        if kind == "zero_row":
            rows = slice(384, 512)
            dead = (bool((lse[:, 0, rows] == 1e30).all())
                    and float(dq[:, rows, 0].float().abs().max()) == 0.0)
            rec_c["dead_rows_zero"] = dead
            if not dead:
                failures.append(f"lse backward {name}: a row with no live key has lse != 1e30 "
                                "or dq != 0")
        del again, rdq, rdk, rdv, fdq, fdk, fdv
        if name in ("dense", "hd256_gptj"):
            elem = q.element_size()
            tri = B * H * (S * (S + 1) // 2) * Hd * 2
            rows_bytes = 2 * 4 * B * H * S
            rec_c["ms"] = cuda_ms(lambda: fa.flash_attention_dq(*args, **kw))
            rec_d["ms"] = cuda_ms(lambda: fa.flash_attention_dkv(*args, **kw))
            rec_c["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dq_plain(*args, **kw),
                                        reps=3, warmup=1)
            rec_d["plain_ms"] = cuda_ms(lambda: fa.flash_attention_dkv_plain(*args, **kw),
                                        reps=3, warmup=1)
            rec_c["library_ms"] = rec_d["library_ms"] = None     # no PyTorch call takes dlse
            rec_c["bound_ms"], rec_c["bound_by"] = bound(
                elem * (2 * q.numel() + k.numel() + v.numel() + do.numel()) + rows_bytes, 3 * tri)
            rec_d["bound_ms"], rec_d["bound_by"] = bound(
                elem * (q.numel() + 2 * k.numel() + 2 * v.numel() + do.numel()) + rows_bytes,
                4 * tri)
            tag = "" if name == "dense" else "_hd256"
            results[f"flash_attention_bwd_dq{tag}_lse"] = rec_c
            results[f"flash_attention_bwd_dkv{tag}_lse"] = rec_d
        emit("kernel", **rec_c)
        emit("kernel", **rec_d)


def _check_fused_adam(gen, fad, results, failures):
    """Kernel E against its plain version on the engine's call (emit param
    in place on the fp32 master, fp32 grad, AdamW with weight decay, step
    3) at the train path's largest leaf (the 32000 x 4096 embedding), emit
    update on a 1e6-element leaf and a ragged 1000-element leaf, plus a
    bf16 emit-param case; timed at the largest leaf against
    torch.optim.AdamW(fused=True). Emit param writes into p itself."""
    import torch
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, adam_w_mode=True)
    # (n, p dtype, emit, p scale, lr): the bf16 emit-param case takes unit
    # weights and a large lr, so that a fault moves p by more than a bf16 ulp
    cases = {"embedding_leaf": (32000 * 4096, torch.float32, "param", 0.02, 3e-4),
             "leaf_1e6": (1_000_000, torch.float32, "update", 0.02, 3e-4),
             "ragged_1000": (1000, torch.float32, "update", 0.02, 3e-4),
             "bf16_param_4099": (4099, torch.bfloat16, "param", 1.0, 1e-2)}
    for name, (n, p_dtype, emit_, scale, lr) in cases.items():
        p = torch.randn(n, generator=gen, device="cuda").mul_(scale).to(p_dtype)
        g = torch.randn(n, generator=gen, device="cuda").mul_(1e-3)
        # moments as one earlier step of the same betas left them
        g_prev = torch.randn(n, generator=gen, device="cuda").mul_(1e-3)
        m = g_prev * (1 - kw["b1"])
        v = g_prev.square_().mul_(1 - kw["b2"])
        del g_prev
        bc = fad.bias_corrections(3, kw["b1"], kw["b2"])
        ref = fad.fused_adam_plain(p, g, m, v, lr, *bc, emit=emit_, **kw)
        faults = {
            "bias_correction_one_step_behind": fad.fused_adam_plain(
                p, g, m, v, lr, *fad.bias_corrections(2, kw["b1"], kw["b2"]), emit=emit_,
                **kw),
            "weight_decay_dropped": fad.fused_adam_plain(
                p, g, m, v, lr, *bc, emit=emit_, **{**kw, "weight_decay": 0.0}),
        }
        m0, v0 = m.clone(), v.clone()
        dest = p if emit_ == "param" else None
        sq = torch.full((fad.adam_blocks(n),), float("nan"), device="cuda")
        out = fad.fused_adam_step(p, g, m, v, step=3, lr=lr, emit=emit_, out=dest, sq=sq, **kw)
        torch.cuda.synchronize()
        rel = lambda outs, refs: max(float((a.float() - b.float()).abs().max()
                                           / b.float().abs().max()) for a, b in zip(outs, refs))
        err = rel((out, m, v), ref)
        fault_err = {f: rel((out, m, v), r) for f, r in faults.items()}
        # the blocks' partial sums of u^2 (the health sentinel's update norm)
        sq_err = abs(float(sq.double().sum()) - float(ref[3])) / float(ref[3])
        if not sq_err <= SQ_TOL:
            failures.append(f"fused_adam {name}: sum of u^2 relative error {sq_err} > {SQ_TOL}")
        if not err <= ADAM_TOL:
            failures.append(f"fused_adam {name}: relative error {err} > {ADAM_TOL}")
        for f, e in fault_err.items():
            if not e > ADAM_TOL:
                failures.append(f"fused_adam {name}: planted fault {f} reads {e} <= {ADAM_TOL}")
        rec = {"kernel": "fused_adam", "case": name, "n": n, "p_dtype": str(p_dtype),
               "emit": emit_, "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                                 for a, b in zip((out, m, v), ref)),
               "rel_err": err, "rel_tol": ADAM_TOL, "fault_rel_err": fault_err,
               "sq_rel_err": sq_err, "sq_rel_tol": SQ_TOL}
        if name == "embedding_leaf":
            m.copy_(m0)
            v.copy_(v0)
            rec["ms"] = cuda_ms(lambda: fad.fused_adam_step(p, g, m, v, step=3, lr=lr,
                                                            emit=emit_, out=dest, **kw))
            # with the sentinels' partial sums of u^2 (health on)
            rec["ms_with_sq"] = cuda_ms(lambda: fad.fused_adam_step(
                p, g, m, v, step=3, lr=lr, emit=emit_, out=dest, sq=sq, **kw))
            rec["plain_ms"] = cuda_ms(lambda: fad.fused_adam_plain(p, g, m, v, lr, *bc,
                                                                   emit=emit_, **kw), reps=10)
            param = torch.nn.Parameter(p.clone())
            param.grad = g
            opt = torch.optim.AdamW([param], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                                    weight_decay=0.1, fused=True)
            opt.step()                         # creates the state
            opt.state[param]["exp_avg"].copy_(m0)
            opt.state[param]["exp_avg_sq"].copy_(v0)
            rec["library_ms"] = cuda_ms(opt.step)
            rec["library"] = "torch.optim.AdamW(fused=True).step()"
            # p, g, m, v read; u, m, v written (fp32); ~15 fp32 ops an element
            rec["bound_ms"], rec["bound_by"] = bound(n * (4 * 4 + 3 * 4), 15 * n,
                                                     peak_tflops=FP32_PEAK_TFLOPS)
            results["fused_adam"] = rec
            del param, opt
        emit("kernel", **rec)
        del p, g, m, v, m0, v0, ref, faults, out
        torch.cuda.empty_cache()


def _lamb_plain_group(fl, ps, gs, ms, vs, lr, bc1, bc2, kw, skip_first_block=False):
    """One LAMB group step in plain PyTorch (pure): the new p's, m's, v's and
    the ratio. ``skip_first_block`` plants a fault: the ratio's sums leave
    out the elements that block 0 of leaf 0 reads."""
    import torch
    out_m, out_v, us = [], [], []
    p_sq = u_sq = 0.0
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        m2, v2, u = fl._moments_plain(p, g, m, v, bc1, bc2, kw["b1"], kw["b2"], kw["eps"],
                                      kw["weight_decay"])
        pf = p.float()
        sp, su = pf * pf, u * u
        if skip_first_block and i == 0:
            n = p.numel()
            e = torch.arange(n, device=p.device)
            keep = ((e // 8) % (fl.lamb_blocks(n) * 256) >= 256) | (e >= n // 8 * 8)
            sp, su = sp * keep, su * keep
        p_sq = p_sq + sp.double().sum()
        u_sq = u_sq + su.double().sum()
        out_m.append(m2)
        out_v.append(v2)
        us.append(u)
        del sp, su
    ratio = fl.ratio_plain(p_sq, u_sq)
    out_p = [(p.float() - lr * (ratio * u)).to(p.dtype) for p, u in zip(ps, us)]
    return out_p, out_m, out_v, ratio


def _check_fused_lamb(gen, results, failures):
    """K7 (moments per leaf, one ratio per group, apply per leaf) against its
    plain version on the engine's call: fp32 masters, grads, step 3, at the
    train path's largest leaf (the 32000 x 4096 embedding, one leaf) and
    largest group (w_up over 8 layers, one ratio across the 8 leaves), plus
    ragged leaves with bf16 grads. Planted faults: bias correction dropped,
    weight decay dropped from u, the first block's partial sums skipped. The
    params have unit scale and wd is 0.1, so that a dropped decay term moves
    the ratio and p above the limit in one step. Timed at the embedding
    leaf, kernel by kernel."""
    import torch
    from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl
    kw = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.1)
    lr, step = 1e-3, 3
    bc1, bc2 = fl.bias_corrections(step, kw["b1"], kw["b2"])
    cases = {"embedding_leaf": (1, 32000 * 4096, torch.float32),
             "w_up_group_8_layers": (8, 4096 * 11008, torch.float32),
             "ragged_3x4099_bf16_grads": (3, 4099, torch.bfloat16)}
    for name, (L, n, g_dtype) in cases.items():
        randn = lambda s: torch.randn(n, generator=gen, device="cuda").mul_(s)
        ps = [randn(1.0) for _ in range(L)]
        # leaf 0's first 2048 elements (the vectors block 0 takes first) 10x
        # larger, as a few large rows would be: block 0's partials then hold a
        # share of sum p^2 unlike their share of sum u^2, so the planted
        # skipped-partial fault moves the ratio (with uniform statistics the
        # two shares cancel to ~4e-7)
        ps[0][:2048].mul_(10.0)
        gs = [randn(1e-3).to(g_dtype) for _ in range(L)]
        ms, vs = [], []
        for _ in range(L):          # moments as two earlier steps left them
            g_prev = randn(1e-3)
            ms.append(g_prev * (1 - kw["b1"]))
            vs.append(g_prev.square_().mul_(1 - kw["b2"]))
            del g_prev
        pk, mk, vk = ([x.clone() for x in xs] for xs in (ps, ms, vs))
        ratio = fl.lamb_group_step(pk, gs, mk, vk, step=step, lr=lr, **kw)
        torch.cuda.synchronize()

        def reading(ref):
            rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
                      for xs, rs in zip((pk, mk, vk), ref[:3]) for a, b in zip(xs, rs))
            return rel, abs(float(ratio) - float(ref[3])) / float(ref[3])

        ref = _lamb_plain_group(fl, ps, gs, ms, vs, lr, bc1, bc2, kw)
        rel, ratio_rel = reading(ref)
        max_abs = max(float((a.float() - b.float()).abs().max())
                      for xs, rs in zip((pk, mk, vk), ref[:3]) for a, b in zip(xs, rs))
        ratio_plain = float(ref[3])
        del ref
        faults = {}
        for fault in ("bias_correction_dropped", "weight_decay_dropped",
                      "first_block_partial_skipped"):
            f_ref = _lamb_plain_group(
                fl, ps, gs, ms, vs, lr, *((1.0, 1.0) if fault == "bias_correction_dropped"
                                          else (bc1, bc2)),
                {**kw, "weight_decay": 0.0} if fault == "weight_decay_dropped" else kw,
                skip_first_block=fault == "first_block_partial_skipped")
            faults[fault] = max(reading(f_ref))
            del f_ref
        if not (rel <= ADAM_TOL and ratio_rel <= LAMB_RATIO_TOL):
            failures.append(f"fused_lamb {name}: p/m/v {rel} (limit {ADAM_TOL}), ratio "
                            f"{ratio_rel} (limit {LAMB_RATIO_TOL})")
        for f, e in faults.items():
            if not e > max(ADAM_TOL, LAMB_RATIO_TOL):
                failures.append(f"fused_lamb {name}: planted fault {f} reads {e}")
        rec = {"kernel": "fused_lamb", "case": name, "leaves": L, "n_per_leaf": n,
               "g_dtype": str(g_dtype), "max_abs_err": max_abs, "rel_err": rel,
               "rel_tol": ADAM_TOL, "ratio": float(ratio), "ratio_plain": ratio_plain,
               "ratio_rel_err": ratio_rel, "ratio_tol": LAMB_RATIO_TOL, "fault_err": faults}
        del pk, mk, vk
        if name == "embedding_leaf":
            p, g, m, v = ps[0], gs[0], ms[0], vs[0]
            blocks = fl.lamb_blocks(n)
            part = torch.empty((blocks, 2), dtype=torch.float64, device="cuda")
            akw = dict(bc1=bc1, bc2=bc2, eps=kw["eps"], weight_decay=kw["weight_decay"])
            mom = lambda: fl.lamb_moments(p, g, m, v, part, b1=kw["b1"], b2=kw["b2"], **akw)
            mom()
            # ratio * ||u|| (the health sentinel's update norm over lr)
            unorm, unorm_plain = torch.zeros(1, device="cuda"), torch.zeros(1)
            r = fl.lamb_ratio(part, unorm)
            fl.lamb_ratio(part.cpu(), unorm_plain)
            rec["unorm_rel_err"] = abs(float(unorm) - float(unorm_plain)) / float(unorm_plain)
            if not rec["unorm_rel_err"] <= LAMB_RATIO_TOL:
                failures.append(f"fused_lamb {name}: ratio * ||u|| relative error "
                                f"{rec['unorm_rel_err']} > {LAMB_RATIO_TOL}")
            parts = {
                "fused_lamb_moments": (
                    mom, lambda: fl._moments_plain(p, g, m, v, bc1, bc2, kw["b1"], kw["b2"],
                                                   kw["eps"], kw["weight_decay"]),
                    bound(n * (4 * 4 + 2 * 4) + 16 * blocks, 20 * n, FP32_PEAK_TFLOPS)),
                "fused_lamb_ratio": (
                    lambda: fl.lamb_ratio(part, unorm),
                    lambda: fl.ratio_plain(*part.sum(0)),
                    bound(16 * blocks + 8, 2 * blocks, FP32_PEAK_TFLOPS)),
                "fused_lamb_apply": (
                    lambda: fl.lamb_apply(p, m, v, r, lr=lr, **akw),
                    lambda: p.float() - lr * (r * fl.lamb_u_plain(p, m, v, bc1, bc2, kw["eps"],
                                                                   kw["weight_decay"])),
                    bound(n * (3 * 4 + 4), 12 * n, FP32_PEAK_TFLOPS)),
            }
            for kname, (run, plain, (b_ms, b_by)) in parts.items():
                results[kname] = {**rec, "kernel": kname, "ms": cuda_ms(run),
                                  "plain_ms": cuda_ms(plain, reps=10, warmup=2),
                                  "library_ms": None, "library": "none (no single PyTorch "
                                  "call computes a LAMB step)", "bound_ms": b_ms,
                                  "bound_by": b_by}
            # one pass that kept u would move 28 B an element; the two passes 40
            rec["one_pass_bound_ms"] = bound(28 * n, 0)[0]
            rec["two_pass_bound_ms"] = bound(40 * n, 0)[0]
            rec["ms_by_kernel"] = {k: results[k]["ms"] for k in parts}
            del part, r
        emit("kernel", **rec)
        del ps, gs, ms, vs
        torch.cuda.empty_cache()


def _sr_plain(qk, leaves, groups, bits, seed, fault=None):
    """K8's plain twin over the leaves of one stacked tensor, fed the
    kernel's own Philox draws, or a planted fault: the draws shifted
    arithmetically (u in [-0.5, 0.5)), round to nearest, one stream for
    every block (the counter restarting every 1024 elements)."""
    import torch
    scale, qmax, gs = qk._span_scales(leaves, groups, bits)
    outs, off = [], 0
    for t in leaves:
        n = t.numel()
        x = t.reshape(-1).float()
        s = scale[torch.arange(off, off + n, device=t.device) // gs]
        if fault == "round_to_nearest":
            q = torch.round(x / s)
        else:
            w = qk.philox_words(seed, off, n, t.device,
                                counter_mod=256 if fault == "one_stream_per_block" else 0)
            if fault == "arithmetic_shift":
                u = (torch.where(w >= 2**31, w - 2**32, w) >> 8).float() * 2.0**-24
            else:
                u = (w & 0xFFFFFF).float() * 2.0**-24
            del w
            q = torch.floor(x / s + u)
        outs.append((torch.clamp(q, -qmax - 1, qmax) * s).to(t.dtype).reshape(t.shape))
        off += n
    return outs


def _sr_leaves(gen, dtype, shapes, views):
    """Seeded leaves of one stacked tensor. With ``views`` they are carved
    out of one buffer at odd element offsets (a gap of one element before
    each), so their addresses sit off 16-byte boundaries, as views of a
    flat buffer would."""
    import torch
    sizes = [int(torch.Size(sh).numel()) for sh in shapes]
    if not views:
        return [torch.randn(sh, generator=gen, device="cuda").mul_(0.02).to(dtype)
                for sh in shapes]
    buf = torch.randn(sum(sizes) + 2 * len(sizes) + 1, generator=gen,
                      device="cuda").mul_(0.02).to(dtype)
    leaves, at = [], 3
    for sh, n in zip(shapes, sizes):
        leaves.append(buf[at:at + n].view(sh))
        at += n + 1
    return leaves


def _group_pieces(leaves, groups):
    """max |x| of every (group, leaf) piece of the stacked view, as
    {group: [piece maxima in leaf order]} (fp32 on the card)."""
    total = sum(t.numel() for t in leaves)
    gs, pieces, off = total // groups, {}, 0
    for t in leaves:
        flat, n = t.reshape(-1), t.numel()
        for g in range(off // gs, (off + n - 1) // gs + 1):
            lo, hi = max(g * gs, off) - off, min((g + 1) * gs, off + n) - off
            pieces.setdefault(g, []).append(flat[lo:hi].float().abs().amax())
        off += n
    return pieces


def _scale_faults(qk, leaves, groups, bits):
    """Planted faults of the scale pass: scales as amax times the fp32
    reciprocal of qmax (what a CUDA tensor divided by a Python number
    computes), and, where a group spans leaves, the piece that holds its max
    left out of it."""
    import torch
    qmax = 2.0 ** (bits - 1) - 1
    pieces = _group_pieces(leaves, groups)
    amax = torch.stack([torch.stack(ps).max() for _, ps in sorted(pieces.items())])
    one = torch.ones_like(amax)
    recip = amax * torch.full((), 1.0 / qmax, dtype=torch.float32, device=amax.device)
    faults = {"reciprocal_scale": torch.where(recip == 0, one, recip)}
    if any(len(ps) > 1 for ps in pieces.values()):
        dropped = torch.stack([torch.stack(ps).sort().values[-2] if len(ps) > 1
                               else torch.stack(ps).max() for _, ps in sorted(pieces.items())])
        faults["piece_left_out"] = torch.where(dropped == 0, one, qk._div(dropped, qmax))
    return faults


def _time_sr_quantize(qk, x, groups, bits, rec, results):
    """Times at one leaf, in place: the quantization kernel alone (CUDA
    events and device time), its plain version, the absmax pass (its
    kernels' device time, the torch scale pass it replaces, the library's
    group max), and the whole span call. Emits the absmax record."""
    import torch
    n, elem = x.numel(), x.element_size()
    scale, qmax, gs = qk.span_scales([x], groups, bits)
    plain_scale = qk._span_scales([x], groups, bits)[0]
    quantize = lambda: qk._kernel(x, x, scale, gs, 0, qmax, 7)
    rec["ms"] = cuda_ms(quantize)
    rec["device_ms"] = device_ms(quantize)
    flat = x.reshape(groups, -1)
    rec["plain_ms"] = cuda_ms(lambda: qk.sr_quantize_plain(
        flat, scale[:, None], qmax, qk.philox_uniform(7, 0, n, "cuda").reshape(
            groups, -1)), reps=3, warmup=1)
    rec["library_ms"] = None
    rec["library"] = ("none (torch.fake_quantize_* rounds to nearest; no PyTorch call "
                      "rounds stochastically)")
    # x read and written once, the scales once; ~31 operations an element
    # (Philox4x32-10 shared by four, then the rounding)
    rec["bound_ms"], rec["bound_by"] = bound(2 * elem * n + 4 * groups, 31 * n,
                                             FP32_PEAK_TFLOPS)
    span = lambda: qk.ds_sr_quantize_span([x], groups, bits, seed=7, out=[x])
    rec["span_ms"] = cuda_ms(span)
    rec["span_device_ms"] = device_ms(span)
    results["sr_quantize"] = rec

    scales = lambda: qk.span_scales([x], groups, bits)
    by_class = device_ms_by_class(scales)
    abs_rec = {"kernel": "sr_absmax", "case": "embedding_leaf", "shape": list(x.shape),
               "groups": groups, "bits": bits,
               "max_abs_err": float((scale - plain_scale).abs().max()),
               "ms": cuda_ms(scales), "device_ms": by_class.get("sr_absmax"),
               "call_device_ms": sum(by_class.values()),
               "plain_ms": cuda_ms(lambda: qk._span_scales([x], groups, bits)),
               "library_ms": cuda_ms(lambda: torch.linalg.vector_norm(
                   flat, float("inf"), dim=1, dtype=torch.float32)),
               "library": "torch.linalg.vector_norm(ord=inf, dim=1): max |x| a group, "
                          "without the division"}
    # x read once, the scales written once; one max an element
    abs_rec["bound_ms"], abs_rec["bound_by"] = bound(elem * n + 4 * groups, n, FP32_PEAK_TFLOPS)
    results["sr_absmax"] = abs_rec
    emit("kernel", **abs_rec)


def _check_sr_quantize(gen, results, failures):
    """K8 and its group-absmax scale pass on the card. Scales: the kernel's
    against the plain version's (torch amax per group piece, correctly
    rounded division), bit for bit; planted faults read above 0 (the
    reciprocal scale where a case has >= 1000 groups, so that some group
    is certain to round differently; the max piece of a group spanning
    leaves left out, where one does). Quantization: against its plain twin
    fed the same Philox draws, bit for bit (the share of differing elements
    must be <= SR_MISMATCH_TOL, each planted fault's above it), out of place
    and in place. Cases: the train path's largest leaf (the embedding, 64
    groups, 16 bits: the run's first bit width), the w_up leaves of 8
    layers with 43 groups of 2^23 elements, which span layers (8 bits),
    leaves at odd stacked offsets and odd addresses with 11-element groups,
    fp16 and fp32. Each kernel repeats bit for bit. Then the statistics on
    x = (k + 0.3) s: every output is floor(x/s) s or (floor(x/s) + 1) s,
    the mean over 64 seeds is within 4 sigma of x, a seed repeats bit for
    bit, and adjacent blocks' rounding is uncorrelated (|r| within 4 /
    sqrt(N)). Timed at the embedding leaf, in place: the quantization
    kernel, the absmax pass, the whole span call, the torch scale pass
    they replace."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    # dtype, leaf shapes, groups, bits, leaves carved at odd addresses
    cases = {"embedding_leaf": (bf16, [(32000, 4096)], 64, 16, False),
             "w_up_8_layers_43_groups": (bf16, [(4096, 11008)] * 8, 43, 8, False),
             "odd_offsets_and_addresses": (bf16, [(3, 1001)] * 5, 1365, 8, True),
             "fp16_3_layers": (fp16, [(1024, 1000)] * 3, 5, 16, False),
             "fp32_odd_addresses": (fp32, [(777, 1001)] * 3, 7, 8, True)}
    for name, (dtype, shapes, groups, bits, views) in cases.items():
        leaves = _sr_leaves(gen, dtype, shapes, views)
        scale, qmax, gs = qk.span_scales(leaves, groups, bits)
        plain_scale = qk._span_scales(leaves, groups, bits)[0]
        scale_diff = lambda ref: int((scale != ref).sum())
        scale_err = scale_diff(plain_scale)
        scale_faults = {f: scale_diff(r) for f, r in
                        _scale_faults(qk, leaves, groups, bits).items()}
        required = [f for f in scale_faults
                    if f == "piece_left_out" or groups >= 1000]
        scale_repeat = bool(torch.equal(scale, qk.span_scales(leaves, groups, bits)[0]))
        got = qk.ds_sr_quantize_span(leaves, groups, bits, seed=7)
        repeat = all(torch.equal(a, b) for a, b in
                     zip(got, qk.ds_sr_quantize_span(leaves, groups, bits, seed=7)))
        if views:
            base = leaves[0]._base.clone()
            in_place = [base[t.storage_offset():t.storage_offset() + t.numel()].view(t.shape)
                        for t in leaves]
        else:
            in_place = [t.clone() for t in leaves]
        qk.ds_sr_quantize_span(in_place, groups, bits, seed=7, out=in_place)
        torch.cuda.synchronize()

        def share(outs, ref):
            diff = sum(int((a != b).sum()) for a, b in zip(outs, ref))
            return diff / sum(t.numel() for t in leaves)

        ref = _sr_plain(qk, leaves, groups, bits, 7)
        err = max(share(got, ref), share(in_place, ref))
        max_abs = max(float((a.float() - b.float()).abs().max())
                      for outs in (got, in_place) for a, b in zip(outs, ref))
        del ref, in_place
        faults = {}
        for fault in ("arithmetic_shift", "round_to_nearest", "one_stream_per_block"):
            faults[fault] = share(got, _sr_plain(qk, leaves, groups, bits, 7, fault))
        if not err <= SR_MISMATCH_TOL:
            failures.append(f"sr_quantize {name}: {err} of the elements differ")
        for f, e in faults.items():
            if not e > SR_MISMATCH_TOL:
                failures.append(f"sr_quantize {name}: planted fault {f} reads {e}")
        if scale_err:
            failures.append(f"sr_absmax {name}: {scale_err} of {groups} scales differ")
        for f in required:
            if not scale_faults[f] > 0:
                failures.append(f"sr_absmax {name}: planted fault {f} reads 0")
        if not (repeat and scale_repeat):
            failures.append(f"sr_quantize {name}: two launches differ "
                            f"(quantization {repeat}, scales {scale_repeat})")
        rec = {"kernel": "sr_quantize", "case": name, "dtype": str(dtype).split(".")[-1],
               "leaves": len(shapes), "shape": list(shapes[0]), "groups": groups,
               "group_size": gs, "bits": bits, "odd_addresses": views,
               "offsets": [sum(int(torch.Size(sh).numel()) for sh in shapes[:i])
                           for i in range(len(shapes))],
               "max_abs_err": max_abs, "mismatch_share": err,
               "mismatch_tol": SR_MISMATCH_TOL, "fault_mismatch_share": faults,
               "scales_differing": scale_err, "scale_faults_differing": scale_faults,
               "scale_faults_required": required, "repeat_bit_equal": repeat,
               "scale_repeat_bit_equal": scale_repeat}
        if name == "embedding_leaf":
            _time_sr_quantize(qk, leaves[0], groups, bits, rec, results)
        emit("kernel", **rec)
        del leaves, got
        torch.cuda.empty_cache()

    # statistics on a grid: x = (k + 0.3) s, s a power of two, 64 groups
    s, qmax = 2.0**-4, 127
    k = torch.randint(-20, 20, (64, 16384), generator=gen, device="cuda")
    x = ((k + 0.3) * s).to(torch.bfloat16)
    x[:, 0] = qmax * s                          # each group's max: scale = s exactly
    xf = x.float()
    lo = torch.floor(xf / s) * s
    outs = torch.stack([qk.ds_sr_quantize(x, 64, 8, seed=i).float() for i in range(64)])
    support = bool(((outs == lo) | (outs == lo + s)).all())
    frac = xf / s - torch.floor(xf / s)
    sigma = float((s * s * frac * (1 - frac) / 64).mean().sqrt()) / xf.numel() ** 0.5
    bias = abs(float((outs.mean(0) - xf).mean()))
    repeat = bool(torch.equal(qk.ds_sr_quantize(x, 64, 8, seed=3),
                              qk.ds_sr_quantize(x, 64, 8, seed=3)))
    up = (outs[0] != lo).float().reshape(-1, 1024)        # one 1024-element block a row
    a, b = up[:-1].reshape(-1), up[1:].reshape(-1)
    corr = float(torch.corrcoef(torch.stack([a, b]))[0, 1])
    corr_tol = 4 / a.numel() ** 0.5
    stats = {"kernel": "sr_quantize", "case": "grid_statistics", "support_exact": support,
             "mean_bias": bias, "mean_bias_tol": 4 * sigma, "seed_repeats": repeat,
             "adjacent_block_corr": corr, "corr_tol": corr_tol}
    if not (support and bias <= 4 * sigma and repeat and abs(corr) <= corr_tol):
        failures.append(f"sr_quantize statistics: {stats}")
    emit("kernel", **stats)
    del k, x, xf, lo, outs, up
    torch.cuda.empty_cache()


def paged_logits(engine, tokens, n_prompt):
    """Teacher-forced logits of the serving path: the engine's own paged
    prefill of ``tokens[:n_prompt]`` (kernel A on the card) on a scratch
    pool, then one paged decode step (kernel B) for each later token of
    ``tokens``. Returns ``[len(tokens) - n_prompt + 1, vocab]`` fp32 on the
    CPU: the logits at the prompt's last position and after each fed token,
    whatever the engine would have sampled."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T
    cfg, dev = engine.module.config, engine.device
    n = len(tokens)
    Tb = -(-n_prompt // 128) * 128
    blocks = -(-max(Tb, n) // 128)
    pools = engine.module.init_paged_cache(blocks + 1, 128, dtype=engine.dtype, device=dev)
    toks = torch.as_tensor(tokens, dtype=torch.long)
    prompt = torch.zeros((1, Tb), dtype=torch.long, device=dev)
    prompt[0, :n_prompt] = toks[:n_prompt]
    slots = torch.arange(Tb, device=dev) + 128                # blocks 1.., in order
    table = torch.arange(1, blocks + 1, dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        logits, _ = T.forward_paged_prefill(cfg, engine.params, prompt, pools, slots,
                                            n_prompt - 1)
        out = [logits[0].float().cpu()]
        for p in range(n_prompt, n):
            pos = torch.tensor([p], dtype=torch.int32, device=dev)
            logits, _ = T.forward_paged_decode(cfg, engine.params, toks[p:p + 1].to(dev)[None],
                                               pools, table, pos)
            out.append(logits[0].float().cpu())
    return torch.stack(out)


def cached_logits(engine, ids, n_prompt):
    """Teacher-forced logits of static generate: ``forward_cached`` over the
    right-padded 128-bucket of ``ids[:, :n_prompt]`` at pos 0, then one
    ``forward_cached`` step (the dense decode kernel on the card) for each
    later column of ``ids``. Returns ``[B, ids.shape[1], vocab]`` fp32 on the
    CPU: every prompt position's logits and those after each fed token."""
    import torch
    B, n = ids.shape
    dev = engine.device
    bucket = -(-n_prompt // 128) * 128
    ids = torch.as_tensor(ids, dtype=torch.long)
    # a workspace of whole 128-slot tiles, as generate's: the dense decode
    # kernel's envelope
    cache = engine.module.init_cache(B, -(-max(bucket, n) // 128) * 128, dtype=engine.dtype,
                                     device=dev)
    prompt = torch.zeros((B, bucket), dtype=torch.long, device=dev)
    prompt[:, :n_prompt] = ids[:, :n_prompt]
    # an MoE engine's prefill keeps the bucket's padding out of expert capacity
    kw = ({"valid": (torch.arange(bucket, device=dev) < n_prompt).float().expand(B, bucket)}
          if getattr(engine, "_is_moe", False) else {})
    with torch.no_grad():
        logits, cache = engine.module.forward_cached(engine.params, prompt, cache, 0, **kw)
        out = [logits[:, :n_prompt].float().cpu()]
        for p in range(n_prompt, n):
            logits, cache = engine.module.forward_cached(engine.params, ids[:, p:p + 1].to(dev),
                                                         cache, p)
            out.append(logits[:, -1:].float().cpu())
    return torch.cat(out, dim=1)


def logit_parity(got, want, faults):
    """Teacher-forced logits (one row a position) against the CPU's with
    phase kernel's per-row measure: each position's largest difference in
    bf16 ulps of its largest |CPU logit|. Every position is compared; each
    planted fault's logits must read above LOGIT_ULP_TOL. Returns the
    record and the failures."""
    import torch
    errs = row_ulp_errs(got, want)
    rec = {"positions_compared": int(errs.numel()), "ulp_err": float(errs.max()),
           "ulp_err_median": float(errs.median()), "ulp_tol": LOGIT_ULP_TOL,
           "fault_ulp_err": {f: float(row_ulp_errs(x, want).max()) for f, x in faults.items()}}
    failures = []
    if not bool(torch.isfinite(got).all()):
        failures.append("non-finite logits")
    if not rec["ulp_err"] <= LOGIT_ULP_TOL:
        failures.append(f"logits differ by {rec['ulp_err']} bf16 ulps > {LOGIT_ULP_TOL}")
    for f, e in rec["fault_ulp_err"].items():
        if not e > LOGIT_ULP_TOL:
            failures.append(f"planted fault {f} reads {e} ulps <= {LOGIT_ULP_TOL}")
    return rec, failures


@contextlib.contextmanager
def planted_attention_fault(fault):
    """A kernel fault fed through the model inside the ``with`` body, where
    the model calls the kernel: "flash_kv_head_shifted" (kernel A reads the
    next kv head), "flash_last_key_tile_dropped" (kernel A skips the last
    128-key tile: a ragged tile lost) or "decode_kv_head_shifted" (the dense
    decode kernel reads the next kv head)."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T
    name = "decode_attention" if fault.startswith("decode_") else "flash_attention"
    real = getattr(T, name)
    if fault == "flash_last_key_tile_dropped":
        def faulted(q, k, v, mask_bias=None, **kw):
            B, S = q.shape[:2]
            drop = torch.zeros((B, S), device=q.device)
            drop[:, (S - 1) // 128 * 128:] = -1e9
            return real(q, k, v, mask_bias=drop if mask_bias is None else drop + mask_bias, **kw)
    else:
        def faulted(q, k, v, *args, **kw):
            return real(q, k.roll(1, 2), v.roll(1, 2), *args, **kw)
    setattr(T, name, faulted)
    try:
        yield
    finally:
        setattr(T, name, real)


def _parity_engines(seed):
    """Llama-7B width at 2 layers: the same seeded weights served on the card
    (bf16, kernels) and on the CPU (fp32, plain versions)."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    model = llama("7b", n_layer=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda", dtype=torch.bfloat16)
    gpu = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16", device="cuda")
    cpu = deepspeed_tpu_torch.init_inference(
        model, params=params.map(lambda t: t.to("cpu", torch.float32)), dtype="fp32",
        device="cpu")
    return model, gpu, cpu


def phase_slice_parity(state, seed):
    """The serving path, teacher-forced: the CPU's greedy tokens (prompt +
    8 new) fed to the card's paged prefill and decode steps and to the
    CPU's; the logits at every generated position held with logit_parity,
    a kernel-A fault planted through the model on the card."""
    import numpy as np
    import torch

    model, gpu, cpu = _parity_engines(seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.config.vocab_size, size=n) for n in (40, 130, 200)]
    max_new = 8
    want_tokens = cpu.generate_batch(prompts, max_new_tokens=max_new)
    got_tokens = gpu.generate_batch(prompts, max_new_tokens=max_new)
    got, want = [], []
    faults = {f: [] for f in ("flash_kv_head_shifted", "flash_last_key_tile_dropped")}
    for p, w in zip(prompts, want_tokens):
        w = np.asarray(w)
        check(w.shape == (p.size + max_new,), f"CPU output shape {w.shape}")
        toks = w[:-1]                     # the last token is sampled, never fed
        want.append(paged_logits(cpu, toks, p.size))
        got.append(paged_logits(gpu, toks, p.size))
        for f in faults:
            with planted_attention_fault(f):
                faults[f].append(paged_logits(gpu, toks, p.size))
    same = sum(int(np.array_equal(np.asarray(g), np.asarray(w)))
               for g, w in zip(got_tokens, want_tokens))
    rec, failures = logit_parity(torch.cat(got), torch.cat(want),
                                 {f: torch.cat(x) for f, x in faults.items()})
    del gpu, cpu
    torch.cuda.empty_cache()
    emit("slice_parity", layers=model.config.n_layer, d_model=model.config.d_model,
         prompts=[int(p.size) for p in prompts], new_tokens=max_new,
         greedy_rows_equal=same, **rec)
    check(not failures, "slice_parity failed: " + "; ".join(failures))


def _llama7b(seed):
    """Full-size Llama-2-7B with random bf16 weights drawn on the card."""
    import torch
    from deepspeed_tpu_torch.models import llama
    model = llama("7b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return model, model.init_params(gen, device="cuda", dtype=torch.bfloat16)


SHARED_PREFIX_TOKENS = 256      # the prefix two of the serve prompts share
# serve_async, serve_tier and serve_fleet: Llama-2-7B cut 32 -> 8 layers to
# keep the default run inside its time limit (their loops, tiers and
# routers are what they hold; the serve cell keeps all 32)
SERVE_LOOP_LAYERS = 8


def _llama7b_cut(seed, n_layer):
    """``_llama7b(seed)`` with its first ``n_layer`` layers only (as it is
    when it has no more): the dropped layers are freed and the device's peak
    counter restarts, so a phase's peak holds only the layers it serves."""
    import dataclasses
    from deepspeed_tpu_torch.models.transformer import ParamTree
    model, params = _llama7b(seed)
    if model.config.n_layer <= n_layer:
        return model, params
    tree = params.to_dict()
    del params
    tree["layers"] = tree["layers"][:n_layer]
    cut = ParamTree(tree)
    del tree
    _free()
    _reset_peak()
    return type(model)(dataclasses.replace(model.config, n_layer=n_layer)), cut


def _serve_prompts(cfg, seed):
    """12 prompts of 32-512 tokens; two share a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    shared = rng.integers(0, cfg.vocab_size, size=SHARED_PREFIX_TOKENS)
    lengths = (32, 77, 128, 200, 256, 300, 384, 450, 512, 64)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    prompts.insert(2, np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=60)]))
    prompts.insert(6, np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=140)]))
    return prompts


SERVE_MAX_NEW = 32
GEN_BATCH, GEN_PROMPT, GEN_MAX_NEW = 8, 512, 64
# the workspace generate allocates: min(max_seq 2048, max(576, max_out_tokens 1024))
GEN_SMAX = 1024


def phase_serve(state, seed):
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    from deepspeed_tpu_torch.accelerator import get_accelerator
    acc = get_accelerator("cuda")
    acc.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params = _llama7b(seed)
    cfg = model.config
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = _serve_prompts(cfg, seed)
    max_new = SERVE_MAX_NEW

    fa.launches = 0
    pda.launches = 0
    t0 = time.perf_counter()
    outs = engine.generate_batch(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a_launches, b_launches = fa.launches, pda.launches

    actions = engine._last_serve_actions
    for p, o in zip(prompts, outs):
        o = np.asarray(o)
        check(o.shape == (p.size + max_new,), f"output shape {o.shape} for prompt {p.size}")
        check(np.array_equal(o[:p.size], p), "output does not start with its prompt")
        check(((o >= 0) & (o < cfg.vocab_size)).all(), "token outside the vocabulary")
    generated = sum(np.asarray(o).size - p.size for p, o in zip(prompts, outs))
    check(actions.get("prefill_chunk", 0) > 0, f"no prefix-cache hit: {actions}")
    check(a_launches > 0 and a_launches == cfg.n_layer * actions.get("prefill", 0),
          f"flash launches {a_launches} != {cfg.n_layer} x prefills {actions}")
    check(b_launches > 0 and b_launches == cfg.n_layer * actions.get("decode", 0),
          f"paged launches {b_launches} != {cfg.n_layer} x decodes {actions}")
    state["launches"] = {"flash_attention_fwd": a_launches,
                         "paged_decode_attention": b_launches}
    emit("serve", model="llama-2-7b", layers=cfg.n_layer, dtype="bf16",
         requests=len(prompts), prompt_tokens=[int(p.size) for p in prompts],
         max_new_tokens=max_new, generated_tokens=int(generated), wall_s=wall,
         tokens_per_s=generated / wall, init_s=init_s,
         peak_mem_gb=acc.max_memory_allocated() / 1e9,
         memory=acc.memory_report(), actions=actions,
         stats=engine._last_serve_stats, launches=state["launches"],
         card=state.get("card"))
    del engine
    torch.cuda.empty_cache()


SPEC_K = 4                      # serving.speculative.k of the spec phases
SPEC_WB = 1 << SPEC_K.bit_length()   # the engine's verify window: 8
SPEC_MAX_NEW = 64
SPEC_PARITY_NEW = 16


def verify_logits(engine, rows, W=SPEC_WB):
    """Teacher-forced logits of the verify step: each row ``(tokens,
    n_prompt)`` prefilled (the engine's paged prefill) on a scratch pool,
    then its own tokens fed in windows of 1 .. W (a pending token and its
    candidates; the width cycles with the row and the step) right-padded
    to ``W``, every row in one ``forward_paged_verify`` a step, rows that are
    done idle on the dummy block. Returns per row ``[len(tokens) - n_prompt,
    vocab]`` fp32 on the CPU: the logits after each fed token (the rows of
    :func:`paged_logits` after its first)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import transformer as T
    cfg, dev, bs = engine.module.config, engine.device, 128
    n_max = -(-(max(len(t) for t, _ in rows) + W) // bs)
    pools = engine.module.init_paged_cache(1 + len(rows) * n_max, bs, dtype=engine.dtype,
                                           device=dev)
    tables = [np.arange(1 + i * n_max, 1 + (i + 1) * n_max, dtype=np.int32)
              for i in range(len(rows))]

    def slots_of(table, start, nv, width):
        t = np.arange(width)
        p = start + t
        return np.where(t < nv, table[np.minimum(p // bs, n_max - 1)] * bs + p % bs, p % bs)

    with torch.no_grad():
        for (tokens, n_prompt), table in zip(rows, tables):
            Tb = -(-n_prompt // bs) * bs
            prompt = torch.zeros((1, Tb), dtype=torch.long)
            prompt[0, :n_prompt] = torch.as_tensor(np.asarray(tokens[:n_prompt]))
            T.forward_paged_prefill(cfg, engine.params, prompt.to(dev), pools,
                                    torch.as_tensor(slots_of(table, 0, n_prompt, Tb)).to(dev),
                                    n_prompt - 1)
        starts = [n for _, n in rows]
        outs = [[] for _ in rows]
        step = 0
        while any(s < len(t) for s, (t, _) in zip(starts, rows)):
            toks = np.zeros((len(rows), W), np.int64)
            slots = np.stack([slots_of(np.zeros(1, np.int32), 0, 0, W)] * len(rows))
            bt = np.zeros((len(rows), n_max), np.int32)
            pos = np.zeros((len(rows),), np.int32)
            nvs = []
            for i, ((tokens, _), table) in enumerate(zip(rows, tables)):
                nv = min(1 + (i + step) % W, len(tokens) - starts[i])
                nvs.append(max(nv, 0))
                if nv <= 0:
                    continue
                toks[i, :nv] = tokens[starts[i]:starts[i] + nv]
                slots[i] = slots_of(table, starts[i], nv, W)
                bt[i], pos[i] = table, starts[i]
            logits, _ = engine.module.forward_paged_verify(
                engine.params, torch.as_tensor(toks).to(dev), pools, torch.as_tensor(bt).to(dev),
                torch.as_tensor(slots).to(dev), torch.as_tensor(pos).to(dev))
            for i, nv in enumerate(nvs):
                outs[i].append(logits[i, :nv].float().cpu())
                starts[i] += nv
            step += 1
    return [torch.cat(o) for o in outs]


@contextlib.contextmanager
def planted_verify_fault(W=SPEC_WB):
    """Kernel B handed each window query at the window's ``pos`` instead of
    ``pos + t`` inside the ``with`` body (the verify step calls it for t =
    0 .. W - 1 in order, a layer at a time): query t then misses the
    window's keys 1 .. t and reads ALiBi / position at the wrong offset."""
    from deepspeed_tpu_torch.models import transformer as T
    real = T.paged_decode_attention
    calls = [0]

    def faulted(q, kp, vp, block_tables, pos, **kw):
        t = calls[0] % W
        calls[0] += 1
        return real(q, kp, vp, block_tables, pos - t, **kw)

    T.paged_decode_attention = faulted
    try:
        yield
    finally:
        T.paged_decode_attention = real


def phase_spec_parity(state, seed):
    """The verify step, teacher-forced: the CPU's greedy tokens (prompt + 16
    new) fed in windows through forward_paged_verify on the card (bf16,
    kernel B once per window position) and on the CPU (fp32, plain
    versions), the logits at every live window position held with
    logit_parity; the card's verify logits also held to its own
    teacher-forced decode steps on the same tokens; kernel B handed pos
    instead of pos + t planted on the card above the limit."""
    import numpy as np
    import torch

    model, gpu, cpu = _parity_engines(seed)
    rng = np.random.default_rng(seed + 5)
    prompts = [rng.integers(0, model.config.vocab_size, size=n) for n in (40, 130, 200)]
    want_tokens = cpu.generate_batch(prompts, max_new_tokens=SPEC_PARITY_NEW)
    rows = [(np.asarray(w)[:-1], p.size) for p, w in zip(prompts, want_tokens)]
    for (toks, _), p in zip(rows, prompts):
        check(toks.size == p.size + SPEC_PARITY_NEW - 1, f"CPU output of {toks.size + 1} tokens")
    want = torch.cat(verify_logits(cpu, rows))
    got = torch.cat(verify_logits(gpu, rows))
    decode = torch.cat([paged_logits(gpu, t, n)[1:] for t, n in rows])
    with planted_verify_fault():
        fault = torch.cat(verify_logits(gpu, rows))
    rec_cpu, failures = logit_parity(got, want, {"verify_pos_not_advanced": fault})
    rec_dec, fail_dec = logit_parity(got, decode, {"verify_pos_not_advanced": fault})
    del gpu, cpu
    torch.cuda.empty_cache()
    emit("spec_parity", layers=model.config.n_layer, d_model=model.config.d_model,
         prompts=[int(p.size) for p in prompts], new_tokens=SPEC_PARITY_NEW, window=SPEC_WB,
         card_vs_cpu=rec_cpu, verify_vs_card_decode=rec_dec)
    failures += [f"verify vs the card's decode: {f}" for f in fail_dec]
    check(not failures, "spec_parity failed: " + "; ".join(failures))


def spec_prompts(cfg, seed, n=8):
    """``n`` repetitive prompts: a seeded random motif of 8-32 tokens
    repeated to 128-512 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    return [np.resize(rng.integers(0, cfg.vocab_size, size=int(rng.integers(8, 33))),
                      int(rng.integers(128, 513))) for _ in range(n)]


class OracleProposer:
    """A proposer that knows the answer: the next ``k`` tokens of the
    spec-off output whose prefix the request's sequence is (nothing once a
    request has left every such output). With ``wrong_at`` the candidate at
    that index is replaced by the next token id (a rejection mid-window)."""

    def __init__(self, outputs, vocab, wrong_at=None):
        import numpy as np
        self.outputs = [np.asarray(o, np.int32) for o in outputs]
        self.vocab, self.wrong_at = vocab, wrong_at

    def propose(self, seq, k):
        import numpy as np
        seq = np.asarray(seq, np.int32)
        for o in self.outputs:
            if o.size > seq.size and np.array_equal(o[:seq.size], seq):
                cands = o[seq.size:seq.size + k].copy()
                if self.wrong_at is not None and cands.size > self.wrong_at:
                    cands[self.wrong_at] = (cands[self.wrong_at] + 1) % self.vocab
                return cands
        return np.zeros((0,), np.int32)


def spec_launches(n_layer, actions, window=SPEC_WB):
    """Launches a serve must make: A once a layer a prefill (a prefill chunk
    takes the einsum), B once a layer a decode step and ``window`` times a
    layer a verify step."""
    return {"flash_attention_fwd": n_layer * actions.get("prefill", 0),
            "paged_decode_attention": n_layer * (actions.get("decode", 0)
                                                 + window * actions.get("verify", 0))}


def near_tie(logits, tol=LOGIT_ULP_TOL):
    """Whether a position's two largest logits lie within ``tol`` bf16 ulps
    of its largest |logit| of each other (where two right implementations
    may pick different tokens)."""
    import math
    top = sorted(float(x) for x in logits.float().topk(2).values)
    ulp = 2.0 ** (math.floor(math.log2(float(logits.float().abs().max()))) - 7)
    return top[1] - top[0] <= tol * ulp


def _serve_with_proposer(engine, prompts, max_new, proposer):
    """generate_batch with the session's proposer replaced."""
    session = engine.open_serve_session(max_new=max_new)
    session.sched.spec_proposer = proposer
    try:
        for p in prompts:
            session.add(p)
        while session.step():
            pass
    finally:
        session.close()
    session.end()
    done = sorted(session.sched.finished, key=lambda r: r.rid)
    check(all(r.error is None for r in done), "a request retired without completing")
    return [r.output for r in done]


def _divergences(engine, prompts, got, want, judged=None):
    """Rows of ``got`` that differ from ``want``: (row, first differing
    generated index, whether ``want``'s teacher-forced decode logits there
    are a near-tie). ``judged`` keeps each (row, index) judgment for the
    next call against the same ``want``."""
    import numpy as np
    judged = {} if judged is None else judged
    out = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        g, w = np.asarray(g), np.asarray(w)
        diff = np.nonzero(g != w)[0] if g.shape == w.shape else [min(g.size, w.size)]
        if len(diff):
            j = int(diff[0])
            if (i, j) not in judged:
                judged[i, j] = bool(j >= p.size and
                                    near_tie(paged_logits(engine, w[:j], p.size)[-1]))
            out.append({"row": i, "index": j - p.size, "near_tie": judged[i, j]})
    return out


# spec_serve's runs: (speculative mode, proposer: None = the engine's own
# n-gram proposer, else the index of the wrong candidate of an oracle, -1
# for none)
SPEC_RUNS = {"off": ("off", None), "ngram": ("ngram", None), "oracle": ("ngram", -1),
             "oracle_2_of_4": ("ngram", 2)}


def phase_spec_serve(state, seed):
    """Llama-2-7B cut to SERVE_LOOP_LAYERS with n-gram speculation (k 4) on the default serving
    config, one model for every run: 8 repetitive prompts served with
    speculation off, with the n-gram proposer, with an oracle proposer (the
    spec-off output's next tokens) and with an oracle whose third candidate
    is wrong (two of four accepted), after a short warm-up serve; tokens/s,
    accepted tokens a fused step, the scheduler's stats; launches of A and
    B equal to spec_launches; verify steps in the oracle runs; the rows of
    the speculating runs equal to spec off but where they first part at a
    near-tie."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    acc = get_accelerator("cuda")
    acc.reset_peak_memory_stats()
    model, params = _llama7b_cut(seed, SERVE_LOOP_LAYERS)
    cfg = model.config
    prompts = spec_prompts(cfg, seed)

    def serve(mode, ps, max_new, proposer=None):
        engine = deepspeed_tpu_torch.init_inference(
            model, params=params, dtype="bf16",
            serving={"speculative": {"mode": mode, "k": SPEC_K}})
        fa.launches = 0
        pda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if proposer is None:
            outs = engine.generate_batch(ps, max_new_tokens=max_new)
        else:
            outs = _serve_with_proposer(engine, ps, max_new, proposer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
        rec = (outs, wall, launches, dict(engine._last_serve_actions),
               dict(engine._last_serve_stats))
        del engine
        torch.cuda.empty_cache()
        return rec

    warm = [p[:100] for p in prompts[:2]]       # first launches, cuBLAS's and the allocator's
    serve("ngram", warm, 8, OracleProposer(serve("off", warm, 8)[0], cfg.vocab_size))
    runs, outs, failures = {}, {}, []
    for label, (mode, wrong) in SPEC_RUNS.items():
        proposer = None if wrong is None else OracleProposer(
            outs["off"], cfg.vocab_size, None if wrong < 0 else wrong)
        outs[label], wall, launches, actions, stats = serve(mode, prompts, SPEC_MAX_NEW, proposer)
        for p, o in zip(prompts, outs[label]):
            o = np.asarray(o)
            check(o.shape == (p.size + SPEC_MAX_NEW,), f"{label}: output shape {o.shape}")
            check(np.array_equal(o[:p.size], p), f"{label}: output does not start with its prompt")
            check(((o >= 0) & (o < cfg.vocab_size)).all(), f"{label}: token outside the vocabulary")
        want = spec_launches(cfg.n_layer, actions)
        if launches != want or not all(launches.values()):
            failures.append(f"{label}: launches {launches}, expected {want} from {actions}")
        if wrong is not None and not stats["verify_steps"] > 0:
            failures.append(f"{label}: no verify step")
        steps = stats["decode_steps"] + stats["verify_steps"]
        generated = sum(np.asarray(o).size - p.size for p, o in zip(prompts, outs[label]))
        runs[label] = {"wall_s": wall, "generated_tokens": int(generated),
                       "tokens_per_s": generated / wall,
                       "accepted_tokens_a_fused_step": stats["emitted_tokens"] / steps,
                       "ms_a_fused_step": wall * 1e3 / steps, "actions": actions,
                       "stats": stats, "launches": launches}
    ref = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16")
    judged = {}
    for label in list(SPEC_RUNS)[1:]:
        div = _divergences(ref, prompts, outs[label], outs["off"], judged)
        runs[label]["rows_equal_to_off"] = len(prompts) - len(div)
        runs[label]["near_tie_rows"] = sum(d["near_tie"] for d in div)
        runs[label]["divergences"] = div
        failures += [f"{label}: row {d['row']} parts from spec off at generated token "
                     f"{d['index']}, not a near-tie" for d in div if not d["near_tie"]]
    del ref, params
    torch.cuda.empty_cache()
    state["spec_launches"] = runs["oracle"]["launches"]
    emit("spec_serve", model="llama-2-7b", layers=cfg.n_layer, dtype="bf16", k=SPEC_K,
         window=SPEC_WB, requests=len(prompts), prompt_tokens=[int(p.size) for p in prompts],
         max_new_tokens=SPEC_MAX_NEW, runs=runs, peak_mem_gb=acc.max_memory_allocated() / 1e9,
         card=state.get("card"))
    check(not failures, "spec_serve failed: " + "; ".join(failures))


def phase_generate_parity(state, seed):
    """Static generate, teacher-forced: the CPU's greedy tokens (engine.generate,
    [2, 100] + 8) fed to forward_cached on the card (bf16, the dense decode
    kernel) and on the CPU (fp32, plain versions); the logits at every
    prompt position and after each fed token held with logit_parity, a
    dense-decode fault planted through the model on the card."""
    import numpy as np
    import torch

    model, gpu, cpu = _parity_engines(seed)
    P, max_new = 100, 8
    ids = np.random.default_rng(seed + 4).integers(0, model.config.vocab_size, size=(2, P))
    want_ids = cpu.generate(ids, max_new_tokens=max_new)
    got_ids = gpu.generate(ids, max_new_tokens=max_new)
    check(got_ids.shape == want_ids.shape == (2, P + max_new),
          f"shapes {got_ids.shape} vs {want_ids.shape}")
    toks = want_ids[:, :-1]
    want = cached_logits(cpu, toks, P)
    got = cached_logits(gpu, toks, P)
    with planted_attention_fault("decode_kv_head_shifted"):
        fault = cached_logits(gpu, toks, P)
    rec, failures = logit_parity(got.flatten(0, 1), want.flatten(0, 1),
                                 {"decode_kv_head_shifted": fault.flatten(0, 1)})
    # the dense decode kernel's positions alone (the prompt's go through the einsum)
    rec["decode_ulp_err"] = float(row_ulp_errs(got[:, P:], want[:, P:]).max())
    rec["decode_positions_compared"] = int(got[:, P:].shape[0] * got[:, P:].shape[1])
    same = int(sum(np.array_equal(g, w) for g, w in zip(got_ids, want_ids)))
    del gpu, cpu
    torch.cuda.empty_cache()
    emit("generate_parity", layers=model.config.n_layer, d_model=model.config.d_model,
         batch=[2, P], new_tokens=max_new, greedy_rows_equal=same, **rec)
    check(not failures, "generate_parity failed: " + "; ".join(failures))


def _generate_engine(seed):
    import numpy as np
    import deepspeed_tpu_torch
    model, params = _llama7b(seed)
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16")
    ids = np.random.default_rng(seed + 5).integers(0, model.config.vocab_size,
                                                   size=(GEN_BATCH, GEN_PROMPT))
    return model, engine, ids


def phase_generate(state, seed):
    """Full Llama-2-7B static generate: a warm-up and a timed prefill-only
    call (max_new_tokens 1: prefill plus the first token), then the timed
    full call with the dense decode kernel's counter read around it."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda

    acc = get_accelerator("cuda")
    t0 = time.perf_counter()
    model, engine, ids = _generate_engine(seed)
    cfg = model.config
    engine.generate(ids, max_new_tokens=1)          # allocates the workspace, warms up
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    acc.reset_peak_memory_stats()
    dda.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=GEN_MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dda.launches
    generated = out.shape[1] - GEN_PROMPT
    check(out.shape == (GEN_BATCH, GEN_PROMPT + GEN_MAX_NEW), f"output shape {out.shape}")
    check(np.array_equal(out[:, :GEN_PROMPT], ids), "output does not start with its prompt")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token outside the vocabulary")
    check(engine._workspace[1] == GEN_SMAX, f"workspace Smax {engine._workspace[1]}")
    want = cfg.n_layer * (generated - 1)
    check(launches == want, f"dense decode launches {launches} != {cfg.n_layer} x "
                            f"({generated} - 1)")
    state.setdefault("gen_launches", {})["dense_decode_attention"] = launches
    emit("generate", model="llama-2-7b", layers=cfg.n_layer, dtype="bf16",
         batch=[GEN_BATCH, GEN_PROMPT], max_new_tokens=GEN_MAX_NEW, workspace_smax=GEN_SMAX,
         generated_tokens=int(GEN_BATCH * generated), wall_s=wall,
         tokens_per_s=GEN_BATCH * generated / wall, prefill_ms=prefill_s * 1e3,
         decode_ms_per_step=(wall - prefill_s) / (generated - 1) * 1e3, init_s=init_s,
         peak_mem_gb=acc.max_memory_allocated() / 1e9, memory=acc.memory_report(),
         launches={"dense_decode_attention": launches}, card=state.get("card"))
    del engine
    torch.cuda.empty_cache()


def phase_generate_profile(state, seed):
    """Where the generate phase's time goes (not in the default run): its
    call after a warm-up, once timed with the host clock and once under
    torch.profiler (device time by class, the idle share against the timed
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, engine, ids = _generate_engine(seed)
    engine.generate(ids, max_new_tokens=GEN_MAX_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.generate(ids, max_new_tokens=GEN_MAX_NEW)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(ids, max_new_tokens=GEN_MAX_NEW)
        torch.cuda.synchronize()
    by_class, top = _device_time(prof)
    busy_ms = sum(by_class.values())
    emit("generate_profile", card=state.get("card"), timed_wall_ms=wall_ms,
         tokens_per_s_warm=GEN_BATCH * GEN_MAX_NEW / wall_ms * 1e3, device_busy_ms=busy_ms,
         device_idle_share=1.0 - busy_ms / wall_ms, device_ms_by_class=by_class,
         top_kernels=top)
    del engine
    torch.cuda.empty_cache()


def _train_engine(model, params, config, device=None, optimizer=None):
    import deepspeed_tpu_torch
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config,
                                          device=device, optimizer=optimizer)[0]


def _grads(engine, batch):
    """The parameter gradients of the engine's loss at its current params,
    summed over the micro-batches of ``batch`` (fp32, on the CPU), through
    the engine's forward and autograd, and the micro-batches' mean loss;
    nothing is applied."""
    import torch
    named = list(engine.state.params.named_parameters())
    gas = engine.gradient_accumulation_steps()
    micro = len(batch["input_ids"]) // gas
    total, loss_sum = {}, 0.0
    for i in range(gas):
        loss = engine({k: x[i * micro:(i + 1) * micro] for k, x in batch.items()})
        # a leaf the loss does not reach (BERT's pooler under the MLM loss) reads zero
        grads = torch.autograd.grad(loss.float(), [p for _, p in named], allow_unused=True)
        loss_sum += float(loss.detach())
        for (n, p), g in zip(named, grads):
            g = (torch.zeros_like(p) if g is None else g).float().cpu()
            total[n] = g if n not in total else total[n].add_(g)
    return total, loss_sum / gas


@contextlib.contextmanager
def _planted(fault):
    """Kernel C, D or G fed a faulted input wherever the model's backward
    calls it, inside the ``with`` body: delta not subtracted in dq
    ("dq_delta_not_subtracted") or in dk ("dkv_delta_not_subtracted"), the
    last q tile's rows left out of dk and dv ("dkv_last_q_tile_skipped":
    lse = 1e30 there, so p = 0), or G's onehot at the next vocab column
    ("ce_ds_labels_shifted")."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
    if fault == "ce_ds_labels_shifted":
        mod, name = fce, "fused_ce_ds"
        real = fce.fused_ce_ds

        def faulted(h, w, bias, labels, lse, coef):
            return real(h, w, bias, (labels + 1) % w.shape[1], lse, coef)
    else:
        mod = fa
        name = "flash_attention_dq" if fault.startswith("dq_") else "flash_attention_dkv"
        real = getattr(fa, name)

        def faulted(q, k, v, do, lse, delta, *args):
            if fault.endswith("_delta_not_subtracted"):
                delta = torch.zeros_like(delta)
            else:
                lse = lse.clone()
                lse[:, :, (q.shape[1] - 1) // 64 * 64:] = 1e30
            return real(q, k, v, do, lse, delta, *args)

    setattr(mod, name, faulted)
    try:
        yield
    finally:
        setattr(mod, name, real)


def phase_train_parity(state, seed):
    """Llama-7B width at PARITY_LAYERS: the same fp32 weights and batches on the
    card (bf16 params, fp32 masters, kernels) and on the CPU (fp32, plain
    versions), fused cross-entropy "on" in both (K3's kernels on the card,
    its plain version on the CPU). First the gradients of the first batch
    at the initial weights: each leaf's within PARITY_GRAD_TOL of the CPU's
    (relative norm), and the same read with a fault planted in kernel C, D
    or G above it (G's on the head leaf). Then 3 train_batch steps: per-step losses agree within
    PARITY_LOSS_TOL; each leaf's update (final - initial) on the card is
    within PARITY_UPDATE_TOL of the CPU's, relative to the CPU update's
    norm."""
    from deepspeed_tpu_torch.models import llama
    _train_parity("train_parity", seed, llama("7b", n_layer=PARITY_LAYERS), 2, 256,
                  {f: (lambda f=f: _planted(f), "head" if f.startswith("ce_") else "worst")
                   for f in ("dq_delta_not_subtracted", "dkv_last_q_tile_skipped",
                             "ce_ds_labels_shifted")})


def phase_sparse_parity(state, seed):
    """:func:`phase_train_parity` for the sparse train path: Llama-7B width at
    PARITY_LAYERS with the train_sparse phase's sparsity config
    (replace_self_attention) at S SPARSE_PARITY_SEQ (two 512-token local
    windows, so the layout drops pairs) on two rows (gas 2): A, C and D
    walk the layout on the card, their plain layout-aware versions run on
    the CPU. The planted fault: the layout ignored on the card
    (dense causal attention), which must read above the gradient limit."""
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.sparse_attention import replace_self_attention
    model = replace_self_attention(llama("7b", n_layer=PARITY_LAYERS), sparse_config(32),
                                   max_seq=SPARSE_PARITY_SEQ)
    _train_parity("sparse_parity", seed, model, 2, SPARSE_PARITY_SEQ,
                  {"layout_ignored": (_layout_ignored, "worst")})


@contextlib.contextmanager
def _layout_ignored():
    """Inside the ``with`` body the block-sparse kernels run without their
    layout (dense causal attention) wherever the sparse model calls them."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    real = fa.flash_attention

    def faulted(q, k, v, *args, block_layout=None, **kw):
        return real(q, k, v, *args, **kw)

    fa.flash_attention = faulted
    try:
        yield
    finally:
        fa.flash_attention = real


def _train_parity(phase, seed, model, B, S, faults, steps=3, batch_fn=None, grad_floor=0.0,
                  prepare=None):
    """The card (bf16, kernels) against the CPU (fp32, plain versions) for
    ``model`` on [B, S] batches, as :func:`phase_train_parity` says;
    ``faults``: name -> (context manager planting it, the leaf read: "worst"
    or "head"); ``steps`` train_batch steps compared after the gradients
    (with 0 the gradient pass's loss is the one compared, and no update);
    ``batch_fn(rng)`` makes a batch (default: seeded input_ids);
    ``grad_floor`` > 0 floors each leaf's CPU gradient norm, the measure's
    denominator, at that share of the largest leaf's (a leaf whose exact
    gradient is zero, BERT's key bias under the softmax, holds only
    rounding); ``prepare(params)`` adjusts the seeded initial weights."""
    import numpy as np
    import torch

    mcfg = getattr(model, "config_model", model.config)     # a CompressedModel's model config
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    init = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
    if prepare is not None:
        init = prepare(init)
    cpu_init = init.map(lambda t: t.to("cpu"))
    config = {**TRAIN_CONFIG, "train_batch_size": B, "train_micro_batch_size_per_gpu": 1,
              "gradient_accumulation_steps": B, "fused_cross_entropy": "on"}
    cpu_config = {k: v for k, v in config.items() if k != "bf16"}
    gpu = _train_engine(model, init, config, device=CHECK_DEVICE)
    del init
    cpu = _train_engine(model, cpu_init, cpu_config, device="cpu")
    rng = np.random.default_rng(seed + 3)
    batch_fn = batch_fn or (lambda r: {"input_ids": r.integers(0, mcfg.vocab_size,
                                                               size=(B, S))})
    batches = [batch_fn(rng) for _ in range(max(steps, 1))]
    failures = []

    want_g, want_loss = _grads(cpu, batches[0])
    floor = max(1e-30, grad_floor * max(float(w.norm()) for w in want_g.values()))
    grad_rel = lambda got: {n: float((got[n] - w).norm() / w.norm().clamp(min=floor))
                            for n, w in want_g.items()}
    got_g, got_loss = _grads(gpu, batches[0])
    grads = grad_rel(got_g)
    del got_g
    worst_g = max(grads, key=grads.get)
    if not grads[worst_g] <= PARITY_GRAD_TOL:
        failures.append(f"leaf {worst_g} gradient differs by {grads[worst_g]} of the CPU's")
    fault_grads = {}
    for fault, (planted, leaf) in faults.items():
        with planted():
            rel = grad_rel(_grads(gpu, batches[0])[0])
        fault_grads[fault] = {"worst": max(rel.values()), "head": rel.get("lm_head"),
                              "median": float(np.median(list(rel.values())))}
        if not fault_grads[fault][leaf] > PARITY_GRAD_TOL:
            failures.append(f"planted fault {fault} reads {fault_grads[fault]} "
                            f"<= {PARITY_GRAD_TOL}")
    del want_g

    pairs = [(got_loss, want_loss)] if not steps else \
        [(float(gpu.train_batch(b)), float(cpu.train_batch(b))) for b in batches]
    losses = []
    for got, want in pairs:
        losses.append({"card_bf16": got, "cpu_fp32": want, "diff": got - want})
        if not (np.isfinite(got) and abs(got - want) <= PARITY_LOSS_TOL):
            failures.append(f"loss {got} on the card vs {want} on the CPU")
    updates = {}
    if steps:
        init_named = dict(cpu_init.named_parameters())
        cpu_named = dict(cpu.state.params.named_parameters())
        for name, master in gpu.state.master.items():
            w0 = init_named[name].detach()
            d_cpu = cpu_named[name].detach() - w0
            d_gpu = master.to("cpu") - w0
            updates[name] = float((d_gpu - d_cpu).norm() / d_cpu.norm().clamp(min=1e-30))
        worst = max(updates, key=updates.get)
        if not updates[worst] <= PARITY_UPDATE_TOL:
            failures.append(f"leaf {worst} update differs by {updates[worst]} of the CPU's")
    del gpu, cpu
    _free()
    emit(phase, layers=mcfg.n_layer, d_model=mcfg.d_model,
         batch=[B, S], steps=steps, grad_floor=grad_floor,
         grad_rel_diff_worst={worst_g: grads[worst_g]},
         grad_rel_diff_median=float(np.median(list(grads.values()))), grad_tol=PARITY_GRAD_TOL,
         fault_grad_rel_diff=fault_grads, losses=losses, loss_tol=PARITY_LOSS_TOL,
         **({"update_rel_diff_worst": {worst: updates[worst]},
             "update_rel_diff_median": float(np.median(list(updates.values()))),
             "update_tol": PARITY_UPDATE_TOL} if steps else {}))
    check(not failures, f"{phase} failed: " + "; ".join(failures))


def _train_setup(seed, config=None, sparse=False, seq=TRAIN_SEQ, optimizer=None):
    """The train phase's engine (Llama-2-7B width, TRAIN_LAYERS layers,
    random bf16 weights drawn on the card; ``config`` default TRAIN_CONFIG;
    ``optimizer`` a client optimizer) and its one token batch of ``seq``
    tokens a row; with ``sparse`` the model takes the train_sparse path's
    sparsity config."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.sparse_attention import replace_self_attention

    config = config or TRAIN_CONFIG
    model = llama("7b", n_layer=TRAIN_LAYERS)
    if sparse:
        model = replace_self_attention(model, sparse_config(model.config.n_head), max_seq=seq)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda", dtype=torch.bfloat16)
    engine = _train_engine(model, params, config, optimizer=optimizer)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 2)
    tokens = rng.integers(0, model.config.vocab_size, size=(config["train_batch_size"], seq))
    return model, engine, {"input_ids": torch.from_numpy(tokens).cuda()}


def _sparse_train_config():
    """The train_sparse path's config: the train phase's, at micro 2 x gas 2."""
    return {**TRAIN_CONFIG, "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2}


def _timed_steps(engine, batch, steps):
    """``steps`` train_batch calls: losses, host-clock seconds, and the
    kernels' launches (and A / C / D's walked tiles) of each step."""
    import torch
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    losses, step_s, per_step = [], [], []
    for _ in range(steps):
        before = _train_counters()
        fa.reset_tile_counts()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch))
        _sync()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        after = _train_counters()
        per_step.append({**{k: after[k] - before[k] for k in after},
                         **{f"tiles_{k}": n for k, n in fa.tile_counts().items()}})
    return losses, step_s, per_step


def _train_counters():
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    return {"flash_attention_fwd": fa.launches, "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches, "fused_adam": fad.launches,
            "fused_ce_fwd": fce.fwd_launches, "fused_ce_ds": fce.ds_launches,
            "fused_ce_dh_gemm": fce.dh_launches, "fused_ce_dw_gemm": fce.dw_launches,
            "fused_lamb_moments": fl.moments_launches, "fused_lamb_ratio": fl.ratio_launches,
            "fused_lamb_apply": fl.apply_launches, "sr_quantize": qk.launches,
            "sr_absmax": qk.scale_launches}


def _reset_train_counters():
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    fa.launches = fa.dq_launches = fa.dkv_launches = fad.launches = 0
    fce.fwd_launches = fce.ds_launches = fce.dh_launches = fce.dw_launches = 0
    fl.moments_launches = fl.ratio_launches = fl.apply_launches = 0
    qk.launches = qk.scale_launches = 0


def train_launch_rule(engine, leaves_per_layer=9, other_leaves=3, fused_ce=True):
    """The kernels' launches in one train_batch of the train phase's path:
    A twice a layer a micro-step (forward and remat recompute), C and D once,
    E once a parameter leaf (Llama: 9 a layer and 3 others), each fused CE
    kernel once a micro-step (the head lies outside remat; 0 with the plain
    head, and for a model whose loss has no fused head)."""
    cfg = engine.module.config
    gas = engine.gradient_accumulation_steps()
    leaves = len(list(engine.state.params.parameters()))
    check(leaves == leaves_per_layer * cfg.n_layer + other_leaves, f"{leaves} parameter leaves")
    ce = gas if fused_ce and engine._config.fused_cross_entropy != "off" else 0
    return {"flash_attention_fwd": 2 * cfg.n_layer * gas,
            "flash_attention_bwd_dq": cfg.n_layer * gas,
            "flash_attention_bwd_dkv": cfg.n_layer * gas,
            "fused_adam": leaves,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"), ce)}


def phase_train(state, seed):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator

    acc = get_accelerator("cuda")
    t0 = time.perf_counter()
    model, engine, batch = _train_setup(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.config
    want = train_launch_rule(engine)
    acc.reset_peak_memory_stats()

    _reset_train_counters()
    losses, step_s, per_step = _timed_steps(engine, batch, TRAIN_STEPS)
    launches = _train_counters()

    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    for k, n in want.items():
        check(all(s[k] == n for s in per_step), f"{k} launches per step {per_step} != {n}")
        check(launches[k] == n * TRAIN_STEPS, f"{k} launches {launches[k]}")
    state["train_launches"] = launches
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    timed = step_s[1:]
    step = statistics.median(timed)
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak = acc.peak_tflops()
    emit("train", model="llama-2-7b width", layers=cfg.n_layer, seq=TRAIN_SEQ, dtype="bf16",
         config=TRAIN_CONFIG, params=model.num_parameters, losses=losses,
         step_s=step_s, step_ms_median_timed=step * 1e3, tokens_per_step=tokens,
         tokens_per_s=tokens / step, model_tflops_per_s=flops_tok * tokens / step / 1e12,
         mfu=flops_tok * tokens / step / (peak * 1e12), peak_tflops=peak,
         flops_per_token=flops_tok, init_s=init_s,
         peak_mem_gb=acc.max_memory_allocated() / 1e9, memory=acc.memory_report(),
         launches=launches, launches_per_step=want, card=state.get("card"))
    del engine, batch
    torch.cuda.empty_cache()


def phase_train_lamb_parity(state, seed):
    """Llama-7B width at PARITY_LAYERS with FusedLamb and MoQ (nearest
    rounding, 10 -> 8 bits with period 1, so the bits drop within the run):
    the same fp32 weights and [1, 256] batches for 3 train_batch steps on the
    card (bf16 compute params over fp32 masters, kernels) and on the CPU (the
    same precision, plain versions). MoQ quantizes the compute params, which
    the next update overwrites from the masters; an fp32 engine keeps no
    masters and accumulates the quantization in its weights, so the CPU side
    runs bf16 too, to compute the same function. Per-step losses within
    PARITY_LOSS_TOL, each leaf's master update within PARITY_UPDATE_TOL of
    the CPU's, the Quantizer's state equal."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import llama

    model = llama("7b", n_layer=PARITY_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = model.init_params(gen, device="cuda", dtype=torch.float32)
    cpu_init = init.map(lambda t: t.to("cpu"))
    S = 256
    moq = {**MOQ_TRAIN, "quantize_groups": 1,
           "quantize_bits": {"start_bits": 10, "target_bits": 8},
           "quantize_schedule": {"quantize_period": 1},
           "quantize_algo": {"q_type": "symmetric", "q_rounding": "nearest"}}
    config = {**LAMB_CONFIG, "train_batch_size": 1, "train_micro_batch_size_per_gpu": 1,
              "gradient_accumulation_steps": 1, "quantize_training": moq}
    gpu = _train_engine(model, init, config)
    del init
    cpu = _train_engine(model, cpu_init, config, device="cpu")
    rng = np.random.default_rng(seed + 6)
    batches = [{"input_ids": rng.integers(0, model.config.vocab_size, size=(1, S))}
               for _ in range(3)]
    failures, losses, qstates = [], [], []
    for batch in batches:
        got, want = float(gpu.train_batch(batch)), float(cpu.train_batch(batch))
        losses.append({"card_bf16": got, "cpu_bf16": want, "diff": got - want})
        if not (np.isfinite(got) and abs(got - want) <= PARITY_LOSS_TOL):
            failures.append(f"loss {got} on the card vs {want} on the CPU")
        qstates.append(gpu.quantizer.state_dict() == cpu.quantizer.state_dict())
    if not all(qstates):
        failures.append(f"Quantizer state differs: {gpu.quantizer.state_dict()} vs "
                        f"{cpu.quantizer.state_dict()}")
    updates = {}
    init_named = dict(cpu_init.named_parameters())
    for name, master in gpu.state.master.items():
        w0 = init_named[name].detach()
        d_cpu = cpu.state.master[name] - w0
        d_gpu = master.to("cpu") - w0
        updates[name] = float((d_gpu - d_cpu).norm() / d_cpu.norm().clamp(min=1e-30))
    worst = max(updates, key=updates.get)
    if not updates[worst] <= PARITY_UPDATE_TOL:
        failures.append(f"leaf {worst} update differs by {updates[worst]} of the CPU's")
    bits = sorted({v["bits"] for v in gpu.quantizer.state_dict()["leaf_state"].values()})
    del gpu, cpu
    torch.cuda.empty_cache()
    emit("train_lamb_parity", layers=model.config.n_layer, d_model=model.config.d_model,
         batch=[1, S], steps=len(batches), optimizer="FusedLamb", moq=moq, losses=losses,
         loss_tol=PARITY_LOSS_TOL, quantizer_state_equal=qstates, bits_at_end=bits,
         update_rel_diff_worst={worst: updates[worst]},
         update_rel_diff_median=float(np.median(list(updates.values()))),
         update_tol=PARITY_UPDATE_TOL)
    check(not failures, "train_lamb_parity failed: " + "; ".join(failures))


def phase_train_lamb(state, seed):
    """The train phase's model and batch with LAMB_CONFIG (FusedLamb, MoQ
    with stochastic rounding): 1 warm-up + 5 timed steps; every loss finite
    and falling; per step, the K7 moments and apply kernels once per port
    leaf, the ratio kernel once per JAX leaf, K8 and its absmax kernel once
    per port leaf of each JAX leaf of stacked rank >= 2, and the attention
    and CE kernels as in the train phase (no Adam)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.runtime.utils import jax_leaves

    acc = get_accelerator("cuda")
    t0 = time.perf_counter()
    model, engine, batch = _train_setup(seed, LAMB_CONFIG)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.config
    gas = engine.gradient_accumulation_steps()
    named = dict(engine.state.params.named_parameters())
    groups = jax_leaves(named)
    quantized = sum(len(ns) for path, ns in groups.items()
                    if named[ns[0]].dim() + (path[0] == "layers") >= 2)
    want = {"flash_attention_fwd": 2 * cfg.n_layer * gas,
            "flash_attention_bwd_dq": cfg.n_layer * gas,
            "flash_attention_bwd_dkv": cfg.n_layer * gas,
            "fused_adam": 0,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"),
                            0 if LAMB_CONFIG["fused_cross_entropy"] == "off" else gas),
            "fused_lamb_moments": len(named), "fused_lamb_apply": len(named),
            "fused_lamb_ratio": len(groups), "sr_quantize": quantized,
            "sr_absmax": quantized}
    check((len(named), len(groups), quantized) == (9 * cfg.n_layer + 3, 12,
                                                   9 * cfg.n_layer + 2),
          f"{len(named)} port leaves, {len(groups)} JAX leaves, {quantized} quantized")
    acc.reset_peak_memory_stats()

    _reset_train_counters()
    losses, step_s, per_step = _timed_steps(engine, batch, TRAIN_STEPS)
    launches = _train_counters()

    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    for k, n in want.items():
        check(all(s[k] == n for s in per_step), f"{k} launches per step {per_step} != {n}")
        check(launches[k] == n * TRAIN_STEPS, f"{k} launches {launches[k]}")
    state["train_lamb_launches"] = launches
    tokens = LAMB_CONFIG["train_batch_size"] * TRAIN_SEQ
    step = statistics.median(step_s[1:])
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak = acc.peak_tflops()
    qstate = engine.quantizer.state_dict()
    emit("train_lamb", model="llama-2-7b width", layers=cfg.n_layer, seq=TRAIN_SEQ,
         dtype="bf16", config=LAMB_CONFIG, params=model.num_parameters, losses=losses,
         step_s=step_s, step_ms_median_timed=step * 1e3, tokens_per_step=tokens,
         tokens_per_s=tokens / step, model_tflops_per_s=flops_tok * tokens / step / 1e12,
         mfu=flops_tok * tokens / step / (peak * 1e12), init_s=init_s,
         peak_mem_gb=acc.max_memory_allocated() / 1e9, launches=launches,
         launches_per_step=want, quantizer_qsteps=qstate["qsteps"],
         quantizer_bits={k: v["bits"] for k, v in qstate["leaf_state"].items()},
         card=state.get("card"))
    del engine, batch
    torch.cuda.empty_cache()


def phase_train_sparse(state, seed):
    """The sparse train path at full width: replace_self_attention(Llama-2-7B
    width at TRAIN_LAYERS, the Fixed sparsity config, max_seq SPARSE_SEQ)
    through initialize + train_batch at micro 2 x gas 2 with the train
    phase's optimizer, schedule, clipping, bf16, remat and fused CE: 1
    warm-up + 5 timed steps, every loss finite and falling, per step A = 2 L
    gas, C = D = L gas launches and the tiles they walked equal to the
    layout's live blocks (A: one 128 x 128 tile a block, C and D: two). Then
    the same step with sparse_attention off at the same shape (1 warm-up +
    3 timed). MFU counts the attention pairs each step computes (causal,
    and kept by the layout)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    acc = get_accelerator("cuda")
    config = _sparse_train_config()
    runs = {}
    for label, sparse, steps in (("sparse", True, TRAIN_STEPS), ("dense", False, 4)):
        t0 = time.perf_counter()
        model, engine, batch = _train_setup(seed, config, sparse=sparse, seq=SPARSE_SEQ)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = model.config
        gas, micro = engine.gradient_accumulation_steps(), config["train_micro_batch_size_per_gpu"]
        S, H, L = SPARSE_SEQ, cfg.n_head, cfg.n_layer
        keep = fa._layout_keep(sparse_config(H).make_layout(S), S, H, True)
        pairs = live_pairs(keep, S, True) / H if sparse else S * (S + 1) // 2
        acc.reset_peak_memory_stats()
        _reset_train_counters()
        losses, step_s, per_step = _timed_steps(engine, batch, steps)
        check(all(np.isfinite(losses)), f"non-finite {label} train loss: {losses}")
        check(losses[-1] < losses[0], f"the {label} loss did not fall: {losses}")
        want = {"flash_attention_fwd": 2 * L * gas, "flash_attention_bwd_dq": L * gas,
                "flash_attention_bwd_dkv": L * gas}
        if sparse:
            n_live = int(keep.sum())        # 128-token blocks: A walks one tile a block
            want.update(tiles_fwd=2 * L * gas * micro * n_live,
                        tiles_dq=L * gas * micro * 2 * n_live,
                        tiles_dkv=L * gas * micro * 2 * n_live)
            # every kernel's launches over the run; A, C and D ran with the
            # layout, so they count in the layout rows of the kernels line
            total = {k: sum(s[k] for s in per_step) for k in _train_counters()}
            state["train_sparse_launches"] = {
                (k + "_layout" if k.startswith("flash_attention") else k): n
                for k, n in total.items()}
        for k, n in want.items():
            check(all(s[k] == n for s in per_step), f"{label}: {k} per step {per_step} != {n}")
        tokens = config["train_batch_size"] * S
        step = statistics.median(step_s[1:])
        flops_tok = 6.0 * model.num_parameters + 12.0 * L * cfg.d_model * pairs / S
        runs[label] = {
            "losses": losses, "step_s": step_s, "step_ms_median_timed": step * 1e3,
            "tokens_per_s": tokens / step, "flops_per_token": flops_tok,
            "attention_pairs_per_head": pairs,
            "mfu": flops_tok * tokens / step / (acc.peak_tflops() * 1e12),
            "peak_mem_gb": acc.max_memory_allocated() / 1e9, "init_s": init_s,
            "launches_per_step": {k: per_step[-1][k] for k in want},
            "launches": {k: sum(s[k] for s in per_step) for k in _train_counters()}}
        if sparse:
            runs[label]["live_blocks"] = int(keep.sum())
            runs[label]["causal_blocks"] = H * (keep.shape[-1] * (keep.shape[-1] + 1) // 2)
        check(batch["input_ids"].shape == (config["train_batch_size"], S), "batch shape")
        check(runs[label]["peak_mem_gb"] < 80, f"{label}: peak memory {runs[label]}")
        del engine, batch
        torch.cuda.empty_cache()
    emit("train_sparse", model="llama-2-7b width", layers=TRAIN_LAYERS, seq=SPARSE_SEQ,
         dtype="bf16", config=config, sparsity="Fixed block 128, 4 local, 1 global, "
         "unidirectional", peak_tflops=acc.peak_tflops(), card=state.get("card"), **runs)


def resume_dataset(vocab, seed, n=RESUME_SAMPLES, seq=TRAIN_SEQ):
    """``n`` seeded samples, each a random motif of 8-32 tokens repeated to
    ``seq`` tokens (as spec_prompts makes its prompts): the loss falls on
    them, and a replayed or skipped batch changes it."""
    import numpy as np
    rng = np.random.default_rng(seed + 11)
    return [{"input_ids": np.resize(rng.integers(0, vocab, size=int(rng.integers(8, 33))),
                                    seq).astype(np.int32)} for _ in range(n)]


def resume_engine(data, seed, init_seed, config=None, device=None, model=None):
    """The resume phase's engine: Llama-2-7B width at RESUME_LAYERS (or
    ``model``), random bf16 weights from ``init_seed``, fed by the engine's
    own dataloader over ``data`` shuffled with ``seed``."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

    config = config or RESUME_CONFIG
    device = torch.device(device or "cuda")
    model = model or llama("7b", n_layer=RESUME_LAYERS)
    gen = torch.Generator(device=device).manual_seed(init_seed)
    params = model.init_params(gen, device=device, dtype=torch.bfloat16)
    engine = deepspeed_tpu_torch.initialize(model=model, model_parameters=params,
                                            config=config, training_data=data,
                                            device=device)[0]
    del params
    engine.set_dataloader(DeepSpeedDataLoader(
        data, batch_size=config["train_micro_batch_size_per_gpu"], shuffle=True, seed=seed))
    return engine


def tag_bytes(tag_dir):
    return sum(os.path.getsize(os.path.join(tag_dir, f)) for f in os.listdir(tag_dir))


def state_bytes(engine):
    """Bytes of the engine's checkpointed state: every leaf of its state
    tree, each stored once (a tag adds its meta, manifest and npz headers)."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _flatten_tree, _state_tree
    import math
    return sum(math.prod(leaf.shape) * leaf.dtype.itemsize
               for leaf in _flatten_tree(_state_tree(engine)).values())


def state_fingerprint(engine):
    """Every leaf of the engine's training state as the int64 sum of its
    elements' bits (one number a tensor), the counters and scaler as
    numbers, and the dropout stream's state: equal before and after a load
    that must not touch the engine."""
    import torch
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _flatten_tree, _state_tree
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, leaf in _flatten_tree(_state_tree(engine)).items():
        if hasattr(leaf, "tensors"):
            out[k] = [int(t.detach().view(bits[t.element_size()]).sum(dtype=torch.int64))
                      for t in leaf.tensors]
        else:
            out[k] = leaf.snapshot().item()
    out["rng"] = engine._rng.get_state().tolist()
    return out


def loss_gap(got, want):
    """The largest |got - want| / |want| over the steps."""
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def phase_resume(state, seed):
    """Train, save, get killed, resume: run U takes RESUME_STEPS train_batch
    calls from the engine's own dataloader; run R takes half, saves a tag
    (async, so the snapshot and the persist time apart) and frees the
    engine, and a new engine from another init seed auto_resumes and takes
    the rest. The losses must be finite (every batch is new data: six steps
    need not lower them); the resumed losses and masters must be bit-equal
    to U's (the limit is 0); a resume without the optimizer states and a load without
    the data fast-forward must read above it; a flipped byte in state.npz
    must make an explicit load raise and leave the engine untouched."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import (
        STATE_FILE, CheckpointCorruptError)
    from deepspeed_tpu_torch.utils import fault_injection as fi

    acc = get_accelerator("cuda")
    config = RESUME_CONFIG
    half = RESUME_STEPS // 2
    data = resume_dataset(32000, seed)
    no_verify = {**config, "checkpoint": {"verify_on_load": False}}
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    acc.reset_peak_memory_stats()
    _reset_train_counters()
    out = {}
    try:
        # ---- run U: uninterrupted ----
        engine = resume_engine(data, seed, seed + 100)
        want = train_launch_rule(engine)
        need = state_bytes(engine)
        free = shutil.disk_usage(os.path.dirname(RESUME_DIR)).free
        check(free > 1.05 * need, f"the disk holds {free / 1e9:.1f} GB free, a tag needs "
              f"{need / 1e9:.1f} GB: resume cannot save its tag here")
        losses_u, step_s, per_step = _timed_steps(engine, None, RESUME_STEPS)
        masters_u = {n: m.cpu() for n, m in engine.state.master.items()}
        del engine
        torch.cuda.empty_cache()

        # ---- run R: 3 steps, save, free; a new engine resumes ----
        engine = resume_engine(data, seed, seed + 100)
        losses_r, _, steps_r = _timed_steps(engine, None, half)
        per_step += steps_r
        t0 = time.perf_counter()
        engine.save_checkpoint(RESUME_DIR, asynchronous=True)
        snapshot_s = time.perf_counter() - t0
        engine.flush_checkpoints()
        save_s = time.perf_counter() - t0
        engine.destroy()
        del engine
        torch.cuda.empty_cache()
        tag = f"global_step{half}"
        nbytes = tag_bytes(os.path.join(RESUME_DIR, tag))

        engine = resume_engine(data, seed, seed + 200)
        t0 = time.perf_counter()
        path, _ = engine.auto_resume(RESUME_DIR)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        check(path is not None and path.endswith(tag), f"auto_resume found {path}")
        check(engine.global_steps == half, f"resumed at step {engine.global_steps}")
        more, _, steps_r = _timed_steps(engine, None, RESUME_STEPS - half)
        per_step += steps_r
        losses_r += more
        launches = _train_counters()
        mismatched = [n for n, m in engine.state.master.items()
                      if not torch.equal(m.cpu(), masters_u[n])]
        del engine, masters_u
        torch.cuda.empty_cache()
        # every batch is new data, so six steps need not lower the loss
        check(all(np.isfinite(losses_u)), f"run U's losses are not finite: {losses_u}")
        check(losses_r[half:] == losses_u[half:],
              f"resumed losses {losses_r[half:]} != uninterrupted {losses_u[half:]}")
        check(not mismatched, f"masters after step {RESUME_STEPS} differ: {mismatched}")
        for k, n in want.items():
            check(all(s[k] == n for s in per_step), f"resume: {k} per step {per_step} != {n}")
        state["resume_launches"] = {k: launches[k] for k in want}

        # ---- planted faults, each against the limit 0 ----
        faults = {}
        for name, kw in (("no_optimizer_states", {"load_optimizer_states": False,
                                                  "load_data_progress": True}),
                         ("no_fast_forward", {})):
            engine = resume_engine(data, seed, seed + 300, config=no_verify)
            t0 = time.perf_counter()
            engine.load_checkpoint(RESUME_DIR, **kw)
            torch.cuda.synchronize()
            unverified_load_s = time.perf_counter() - t0
            got = [float(engine.train_batch()) for _ in range(RESUME_STEPS - half)]
            faults[name] = loss_gap(got, losses_u[half:])
            check(faults[name] > 0.0, f"planted fault {name} reads {faults[name]}")
            if name == "no_fast_forward":
                # the corrupt tag's load, with the manifest verified as by default
                engine._config.checkpoint_config.verify_on_load = True
                before = state_fingerprint(engine)
                fi.bit_flip(os.path.join(RESUME_DIR, tag, STATE_FILE))
                t0 = time.perf_counter()
                try:
                    engine.load_checkpoint(RESUME_DIR, tag=tag)
                    raised = False
                except CheckpointCorruptError:
                    raised = True
                verify_s = time.perf_counter() - t0     # the hash of every byte, then the raise
                check(raised, "a load of the tag with a flipped byte did not raise")
                check(state_fingerprint(engine) == before,
                      "the failed load of the corrupt tag touched the engine's state")
            del engine
            torch.cuda.empty_cache()
        out = dict(losses_uninterrupted=losses_u, losses_resumed=losses_r, step_s=step_s,
                   resumed_equal=True, fault_loss_gap=faults, limit=0.0,
                   corrupt_load="raised CheckpointCorruptError, state untouched",
                   tag_bytes=nbytes, state_bytes=need, snapshot_ms=snapshot_s * 1e3,
                   save_s=save_s, save_gb_per_s=nbytes / save_s / 1e9,
                   load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
                   unverified_load_s=unverified_load_s, verify_s=verify_s,
                   disk_free_gb=free / 1e9, peak_mem_gb=acc.max_memory_allocated() / 1e9,
                   launches=state["resume_launches"], launches_per_step=want)
    finally:
        shutil.rmtree(RESUME_DIR, ignore_errors=True)
    emit("resume", model="llama-2-7b width", layers=RESUME_LAYERS, seq=TRAIN_SEQ,
         dtype="bf16", config=config, samples=RESUME_SAMPLES, steps=RESUME_STEPS,
         card=state.get("card"), **out)


# --------------------------------------------------------------------- #
# ingest: HF-format checkpoints written from seeded weights, loaded, served

INGEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".ingest_ckpt")
SHARD_BYTES = 5 * 10**9          # the shard size HF writes by default ("5GB")
# The published config.json files, written out by their numbers
# (meta-llama/Llama-2-7b-hf, gpt2, bigscience/bloom-560m,
# EleutherAI/gpt-neox-20b; torch_dtype is that of the files written here).
# The three families are cut to INGEST_FAMILY_LAYERS layers (PERF.md section 4).
LLAMA2_7B_HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
                "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
                "max_position_embeddings": 4096, "rms_norm_eps": 1e-05, "rope_scaling": None,
                "hidden_act": "silu", "tie_word_embeddings": False, "bos_token_id": 1,
                "eos_token_id": 2, "torch_dtype": "bfloat16"}
INGEST_FAMILIES = {
    "gpt2-125m": {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
                  "vocab_size": 50257, "n_positions": 1024, "n_embd": 768, "n_layer": 12,
                  "n_head": 12, "layer_norm_epsilon": 1e-05, "activation_function": "gelu_new",
                  "torch_dtype": "bfloat16"},
    "bloom-560m": {"architectures": ["BloomForCausalLM"], "model_type": "bloom",
                   "vocab_size": 250880, "hidden_size": 1024, "n_layer": 24, "n_head": 16,
                   "layer_norm_epsilon": 1e-05, "torch_dtype": "bfloat16"},
    "gpt-neox-20b": {"architectures": ["GPTNeoXForCausalLM"], "model_type": "gpt_neox",
                     "vocab_size": 50432, "hidden_size": 6144, "num_hidden_layers": 44,
                     "num_attention_heads": 64, "intermediate_size": 24576,
                     "max_position_embeddings": 2048, "rotary_pct": 0.25,
                     "rotary_emb_base": 10000, "layer_norm_eps": 1e-05,
                     "use_parallel_residual": True, "tie_word_embeddings": False,
                     "hidden_act": "gelu", "torch_dtype": "bfloat16"},
}
INGEST_FAMILY_LAYERS = 2
INGEST_DEVICE = "cuda"           # the card; the CPU tests run the phase on "cpu"
INGEST_PROMPTS = (40, 130)       # the families' and the Megatron model's prompt lengths
INGEST_FAMILY_NEW = 8
_LAYER_KEY = {"gpt2": "n_layer", "bloom": "n_layer", "gpt_neox": "num_hidden_layers",
              "llama": "num_hidden_layers"}
_ST_DTYPE = {"torch.bfloat16": "BF16", "torch.float16": "F16", "torch.float32": "F32"}


def _nbytes(shape, dtype):
    import math
    import torch
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def write_safetensors(path, entries):
    """One safetensors file (an 8-byte little-endian header length, the JSON
    header, the raw bytes: the inverse of the port's reader) from
    ``entries``, (name, shape, dtype, make) with ``make()`` giving the tensor
    on any device; one tensor is copied to the host at a time. Wider dtypes
    go first, so every offset is aligned to its dtype. Returns the file's
    bytes."""
    import struct
    import torch
    entries = sorted(entries, key=lambda e: -torch.empty((), dtype=e[2]).element_size())
    header, offset = {}, 0
    for name, shape, dtype, _ in entries:
        n = _nbytes(shape, dtype)
        header[name] = {"dtype": _ST_DTYPE[str(dtype)], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, shape, dtype, make in entries:
            with torch.no_grad():
                t = make().to(dtype).contiguous().cpu()
            check(tuple(t.shape) == tuple(shape), f"{name}: shape {tuple(t.shape)} != {shape}")
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + offset


def write_hf_checkpoint(d, hf_config, entries, shard_bytes=None):
    """An HF checkpoint directory: config.json, safetensors shards of at
    most ``shard_bytes`` (SHARD_BYTES) of tensors each, in ``entries``'
    order, and model.safetensors.index.json. Returns the shards' bytes."""
    shard_bytes = shard_bytes or SHARD_BYTES
    os.makedirs(d, exist_ok=True)
    shards, size = [[]], 0
    for e in entries:
        n = _nbytes(e[1], e[2])
        if shards[-1] and size + n > shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(e)
        size += n
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(os.path.join(d, fname), shard)
        weight_map.update({e[0]: fname for e in shard})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(_nbytes(e[1], e[2]) for e in entries)},
                   "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    return total


def hf_entries(model_type, cfg, params, dtype):
    """The HF tensors of the port's tree ``params`` for ``model_type``
    (llama, gpt2, bloom or gpt_neox), as write_safetensors entries: the
    inverse of each policy's ``map_params`` (nn.Linear weights back to
    [out, in]; GPT-2's Conv1D weights stay [in, out]; bloom / neox qkv fused
    per head [H, 3, Hd])."""
    import torch
    H, Hd, D = cfg.n_head, cfg.head_dim, cfg.d_model
    out = []

    def put(name, shape, make):
        out.append((name, tuple(shape), dtype, make))

    def plain(name, t):
        put(name, t.shape, lambda: t)

    def linear(name, t):
        put(name, t.shape[::-1], lambda: t.t())

    def norm(prefix, p):
        plain(prefix + ".weight", p["scale"])
        if p.get("bias") is not None:
            plain(prefix + ".bias", p["bias"])

    def cat(name, ts, dim):
        shape = list(ts[0].shape)
        shape[dim] *= len(ts)
        put(name, shape, lambda: torch.cat(ts, dim))

    def headwise(prefix, a):
        qkv = [a[k] for k in ("wq", "wk", "wv")]
        put(prefix + ".weight", (3 * H * Hd, D), lambda: torch.stack(
            [w.t().reshape(H, Hd, D) for w in qkv], 1).reshape(3 * H * Hd, D))
        b = [a[k] for k in ("bq", "bk", "bv")]
        put(prefix + ".bias", (3 * H * Hd,), lambda: torch.stack(
            [x.reshape(H, Hd) for x in b], 1).reshape(3 * H * Hd))

    def mlp(prefix, m):
        linear(prefix + "dense_h_to_4h.weight", m["w_up"])
        plain(prefix + "dense_h_to_4h.bias", m["b_up"])
        linear(prefix + "dense_4h_to_h.weight", m["w_down"])
        plain(prefix + "dense_4h_to_h.bias", m["b_down"])

    embed, layers = params["embed"], params["layers"]
    if model_type == "llama":
        plain("model.embed_tokens.weight", embed["tokens"])
        for i, lp in enumerate(layers):
            p = f"model.layers.{i}."
            norm(p + "input_layernorm", lp["ln_attn"])
            for k, n in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
                linear(f"{p}self_attn.{n}.weight", lp["attn"][k])
            norm(p + "post_attention_layernorm", lp["ln_mlp"])
            for k, n in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
                linear(f"{p}mlp.{n}.weight", lp["mlp"][k])
        norm("model.norm", params["ln_f"])
        linear("lm_head.weight", params["lm_head"])
    elif model_type == "gpt2":
        plain("transformer.wte.weight", embed["tokens"])
        plain("transformer.wpe.weight", embed["positions"])
        for i, lp in enumerate(layers):
            p, a, m = f"transformer.h.{i}.", lp["attn"], lp["mlp"]
            norm(p + "ln_1", lp["ln_attn"])
            cat(p + "attn.c_attn.weight", [a["wq"], a["wk"], a["wv"]], 1)
            cat(p + "attn.c_attn.bias", [a["bq"], a["bk"], a["bv"]], 0)
            plain(p + "attn.c_proj.weight", a["wo"])
            plain(p + "attn.c_proj.bias", a["bo"])
            norm(p + "ln_2", lp["ln_mlp"])
            for k, n in (("w_up", "c_fc.weight"), ("b_up", "c_fc.bias"),
                         ("w_down", "c_proj.weight"), ("b_down", "c_proj.bias")):
                plain(p + "mlp." + n, m[k])
        norm("transformer.ln_f", params["ln_f"])
    elif model_type == "bloom":
        plain("transformer.word_embeddings.weight", embed["tokens"])
        norm("transformer.word_embeddings_layernorm", embed["ln"])
        for i, lp in enumerate(layers):
            p, a = f"transformer.h.{i}.", lp["attn"]
            norm(p + "input_layernorm", lp["ln_attn"])
            headwise(p + "self_attention.query_key_value", a)
            linear(p + "self_attention.dense.weight", a["wo"])
            plain(p + "self_attention.dense.bias", a["bo"])
            norm(p + "post_attention_layernorm", lp["ln_mlp"])
            mlp(p + "mlp.", lp["mlp"])
        norm("transformer.ln_f", params["ln_f"])
    elif model_type == "gpt_neox":
        plain("gpt_neox.embed_in.weight", embed["tokens"])
        for i, lp in enumerate(layers):
            p, a = f"gpt_neox.layers.{i}.", lp["attn"]
            norm(p + "input_layernorm", lp["ln_attn"])
            headwise(p + "attention.query_key_value", a)
            linear(p + "attention.dense.weight", a["wo"])
            plain(p + "attention.dense.bias", a["bo"])
            norm(p + "post_attention_layernorm", lp["ln_mlp"])
            mlp(p + "mlp.", lp["mlp"])
        norm("gpt_neox.final_layer_norm", params["ln_f"])
        linear("embed_out.weight", params["lm_head"])
    else:
        raise ValueError(f"no HF writer for model_type {model_type!r}")
    return out


def megatron_state_dict(params):
    """The Megatron-GPT names of a GPT-2-style tree (learned positions,
    biases, layernorm), torch [out, in] weights, fused qkv in the version-0
    block layout [q | k | v]: the inverse of ``map_megatron_params``."""
    import torch
    sd = {"word_embeddings.weight": params["embed"]["tokens"],
          "position_embeddings.weight": params["embed"]["positions"],
          "transformer.final_layernorm.weight": params["ln_f"]["scale"],
          "transformer.final_layernorm.bias": params["ln_f"]["bias"]}
    for i, lp in enumerate(params["layers"]):
        p, a, m = f"transformer.layers.{i}.", lp["attn"], lp["mlp"]
        sd.update({
            p + "input_layernorm.weight": lp["ln_attn"]["scale"],
            p + "input_layernorm.bias": lp["ln_attn"]["bias"],
            p + "attention.query_key_value.weight": torch.cat(
                [a["wq"].t(), a["wk"].t(), a["wv"].t()], 0),
            p + "attention.query_key_value.bias": torch.cat([a["bq"], a["bk"], a["bv"]]),
            p + "attention.dense.weight": a["wo"].t(),
            p + "attention.dense.bias": a["bo"],
            p + "post_attention_layernorm.weight": lp["ln_mlp"]["scale"],
            p + "post_attention_layernorm.bias": lp["ln_mlp"]["bias"],
            p + "mlp.dense_h_to_4h.weight": m["w_up"].t(),
            p + "mlp.dense_h_to_4h.bias": m["b_up"],
            p + "mlp.dense_4h_to_h.weight": m["w_down"].t(),
            p + "mlp.dense_4h_to_h.bias": m["b_down"]})
    return sd


def write_megatron_checkpoint(d, params, tp):
    """A version-0 ds_inference checkpoint of ``params`` at TP degree
    ``tp``: one torch file per rank (each column- or row-parallel tensor
    split by the loader's merge strategies, fused qkv split q/k/v-aware) and
    the meta json. Returns the meta json's path."""
    import torch
    from deepspeed_tpu_torch.checkpoint.reshape_utils import split_qkv_shards, split_tp_shards
    from deepspeed_tpu_torch.module_inject.megatron import megatron_merge_strategies
    os.makedirs(d, exist_ok=True)
    strategies = megatron_merge_strategies(0)
    ranks = [{} for _ in range(tp)]
    for name, t in megatron_state_dict(params).items():
        t = t.detach().cpu().contiguous()
        strat = next((s for k, s in strategies.items() if k in name), None)
        if strat is None:
            pieces = [t] * tp
        elif isinstance(strat, tuple):
            pieces = split_qkv_shards(t, strat[0], tp)
        else:
            pieces = split_tp_shards(t, strat, tp)
        for r, piece in zip(ranks, pieces):
            r[name] = piece.clone()     # a view would save its whole storage
    files = [f"mp_rank_{r:02d}_model_states.pt" for r in range(tp)]
    for fname, sd in zip(files, ranks):
        torch.save({"module": sd}, os.path.join(d, fname))
    meta = os.path.join(d, "checkpoints.json")
    with open(meta, "w") as f:
        json.dump({"type": "Megatron", "checkpoints": files, "base_dir": d, "version": 0}, f)
    return meta


@contextlib.contextmanager
def untransposed_qk():
    """The planted fault of phase ingest: inside the ``with`` body the llama
    policy leaves q_proj and k_proj as stored ([out, in] read as [in, out]),
    which square Llama-width matrices let through without a shape error."""
    from deepspeed_tpu_torch.module_inject import policies
    real = policies.POLICIES["llama"]

    class Untransposed(policies.LlamaPolicy):
        def map_params(self, get, cfg):
            def raw(name):
                t = get(name)
                return t.t() if name.endswith(("q_proj.weight", "k_proj.weight")) else t
            return super().map_params(raw, cfg)

    policies.POLICIES["llama"] = Untransposed()
    try:
        yield
    finally:
        policies.POLICIES["llama"] = real


def missing_shard_faults(d, load):
    """``load(d)`` with the first shard's entries dropped from the index
    (the first tensor read has no file: KeyError) and with the last shard
    missing on disk (FileNotFoundError before any read). Returns what each
    raised (None where nothing did); the directory is restored."""
    idx = os.path.join(d, "model.safetensors.index.json")
    with open(idx) as f:
        index = json.load(f)
    files = sorted(set(index["weight_map"].values()))
    out = {}
    try:
        with open(idx, "w") as f:
            json.dump({"weight_map": {n: s for n, s in index["weight_map"].items()
                                      if s != files[0]}}, f)
        try:
            load(d)
            out["shard_dropped_from_index"] = None
        except KeyError as e:
            out["shard_dropped_from_index"] = f"KeyError: {e}"
    finally:
        with open(idx, "w") as f:
            json.dump(index, f)
    gone = os.path.join(d, files[-1])
    os.rename(gone, gone + ".moved")
    try:
        load(d)
        out["shard_missing_on_disk"] = None
    except FileNotFoundError as e:
        out["shard_missing_on_disk"] = f"FileNotFoundError: {e}"
    finally:
        os.rename(gone + ".moved", gone)
    return out


def _equal_leaves(got, want):
    """Names of the leaves of ``want`` that ``got`` lacks or holds other bits for."""
    import torch
    got = dict(got.named_parameters())
    return [n for n, w in want.named_parameters()
            if n not in got or not torch.equal(got[n], w)]


def serve_launch_rule(cfg, actions):
    """The serving path's launches: A once a layer per prefill, B once a
    layer per decode step."""
    return {"flash_attention_fwd": cfg.n_layer * actions.get("prefill", 0),
            "paged_decode_attention": cfg.n_layer * actions.get("decode", 0)}


def prefill_launch_rule(cfg, prefills):
    """Kernel A's launches in ``prefills`` paged prefills."""
    return cfg.n_layer * prefills


def host_rss_gb():
    """This process's resident set now (VmRSS of /proc/self/status), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


@contextlib.contextmanager
def sampled_host_peak(every_s=0.005):
    """``[peak]``: the largest resident set (GB) seen while the ``with`` body
    runs, sampled from a thread every ``every_s`` (the body's copies release
    the interpreter lock). getrusage's ru_maxrss keeps the whole run's peak,
    earlier phases' included, and nothing here may reset it."""
    import threading
    stop = threading.Event()
    peak = [host_rss_gb()]

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], host_rss_gb())
            stop.wait(every_s)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield peak
    finally:
        stop.set()
        sampler.join(timeout=5)
        check(not sampler.is_alive(), "the RSS sampler did not stop")
        peak[0] = max(peak[0], host_rss_gb())


def _family_parity(name, hf, seed):
    """One family at INGEST_FAMILY_LAYERS layers: seeded bf16 weights written
    as an HF checkpoint, loaded on the card (bf16, kernels) and on the CPU
    (fp32, plain versions); the CPU's greedy tokens fed to both sides'
    paged prefill and decode steps, held with logit_parity."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject import policy_for
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda
    hf = {**hf, _LAYER_KEY[hf["model_type"]]: INGEST_FAMILY_LAYERS}
    cfg = policy_for(hf["model_type"]).zoo_config(hf)
    gen = torch.Generator(device=INGEST_DEVICE).manual_seed(seed + 1)
    params = CausalLM(cfg).init_params(gen, device=INGEST_DEVICE, dtype=torch.bfloat16)
    d = os.path.join(INGEST_DIR, name)
    nbytes = write_hf_checkpoint(d, hf, hf_entries(hf["model_type"], cfg, params,
                                                   torch.bfloat16))
    gpu = deepspeed_tpu_torch.init_inference(d, dtype="bf16", device=INGEST_DEVICE)
    bad = _equal_leaves(gpu.params, params)
    del params
    cpu = deepspeed_tpu_torch.init_inference(d, dtype="fp32", device="cpu")
    rng = np.random.default_rng(seed + 21)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in INGEST_PROMPTS]
    want_tokens = cpu.generate_batch(prompts, max_new_tokens=INGEST_FAMILY_NEW)
    got, want = [], []
    fa.launches = pda.launches = 0
    for p, w in zip(prompts, want_tokens):
        toks = np.asarray(w)[:-1]
        got.append(paged_logits(gpu, toks, p.size))
        want.append(paged_logits(cpu, toks, p.size))
    launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
    rec, failures = logit_parity(torch.cat(got), torch.cat(want), {})
    del gpu, cpu
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    check(not bad, f"{name}: loaded leaves differ from those written: {bad}")
    check(launches["flash_attention_fwd"] == prefill_launch_rule(cfg, len(prompts)),
          f"{name}: kernel A launches {launches}")
    check(not failures, f"{name}: " + "; ".join(failures))
    return {"layers": cfg.n_layer, "d_model": cfg.d_model, "head_dim": cfg.head_dim,
            "vocab": cfg.vocab_size, "pos_embedding": cfg.pos_embedding,
            "rope_dim": cfg.rope_dim, "checkpoint_bytes": nbytes, "prompts": list(INGEST_PROMPTS),
            "new_tokens": INGEST_FAMILY_NEW, "leaves_equal": True,
            "teacher_forced_launches": launches, **rec}


def _megatron_serve(seed, model=None):
    """A ds_inference meta json of GPT-2-medium width at 2 layers, tp 2,
    version 0: served through init_inference(model, checkpoint=meta) with
    tokens equal to the same weights given directly. The vocabulary is
    Megatron's padded 50304 (--make-vocab-size-divisible-by 128), which the
    vocab-parallel embedding splits over the ranks."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, gpt2_medium
    model = model or CausalLM(dataclasses.replace(
        gpt2_medium().config, n_layer=INGEST_FAMILY_LAYERS, vocab_size=50304))
    gen = torch.Generator(device=INGEST_DEVICE).manual_seed(seed + 2)
    params = model.init_params(gen, device=INGEST_DEVICE, dtype=torch.bfloat16)
    meta = write_megatron_checkpoint(os.path.join(INGEST_DIR, "megatron"), params, tp=2)
    loaded = deepspeed_tpu_torch.init_inference(model, checkpoint=meta, dtype="bf16",
                                                device=INGEST_DEVICE)
    bad = _equal_leaves(loaded.params, params)
    direct = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16",
                                                device=INGEST_DEVICE)
    rng = np.random.default_rng(seed + 22)
    prompts = [rng.integers(0, model.config.vocab_size, size=n) for n in INGEST_PROMPTS]
    got = loaded.generate_batch(prompts, max_new_tokens=INGEST_FAMILY_NEW)
    want = direct.generate_batch(prompts, max_new_tokens=INGEST_FAMILY_NEW)
    equal = sum(int(np.array_equal(g, w)) for g, w in zip(got, want))
    del loaded, direct, params
    torch.cuda.empty_cache()
    check(not bad, f"megatron: loaded leaves differ from those written: {bad}")
    check(equal == len(prompts), f"megatron: {equal} of {len(prompts)} rows equal")
    return {"d_model": model.config.d_model, "n_head": model.config.n_head,
            "layers": model.config.n_layer, "tp": 2, "version": 0,
            "rows_equal": equal, "prompts": list(INGEST_PROMPTS),
            "new_tokens": INGEST_FAMILY_NEW, "leaves_equal": True}


def phase_ingest(state, seed):
    """Serve a full-size Llama-2-7B from an HF-format checkpoint: seeded bf16
    weights (init_params at the LlamaPolicy config of the published
    config.json) written as safetensors shards with an index, loaded by
    init_inference(<dir>, dtype="bf16"), every leaf bit-equal to those
    written; the serve phase's prompts through the loaded engine and an
    engine given the weights in memory, every token equal (limit 0), A = L
    x prefills and B = L x decode steps on the loaded engine; planted
    faults (q_proj and k_proj left un-transposed; a shard dropped from the
    index or missing on disk) must show or raise. Then three more families
    at 2 layers held to the CPU, and a Megatron meta json."""
    import dataclasses
    import resource
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject import load_hf_checkpoint, policy_for
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    acc = get_accelerator("cuda")
    model = CausalLM(policy_for("llama").zoo_config(LLAMA2_7B_HF))
    cfg = model.config
    gen = torch.Generator(device=INGEST_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=INGEST_DEVICE, dtype=torch.bfloat16)
    entries = hf_entries("llama", cfg, params, torch.bfloat16)
    need = sum(_nbytes(e[1], e[2]) for e in entries)
    shutil.rmtree(INGEST_DIR, ignore_errors=True)
    free = shutil.disk_usage(os.path.dirname(INGEST_DIR)).free
    check(free > 1.05 * need, f"the disk holds {free / 1e9:.1f} GB free, the checkpoint "
          f"needs {need / 1e9:.1f} GB: ingest cannot write it here")
    out = {}
    try:
        t0 = time.perf_counter()
        nbytes = write_hf_checkpoint(INGEST_DIR, LLAMA2_7B_HF, entries)
        write_s = time.perf_counter() - t0
        del entries
        shards = sorted(f for f in os.listdir(INGEST_DIR) if f.endswith(".safetensors"))
        rss_before = host_rss_gb()
        torch.cuda.synchronize()
        acc.reset_peak_memory_stats()
        resident = acc.max_memory_allocated()      # the peak since the reset: what is held now
        with sampled_host_peak() as rss_peak:
            t0 = time.perf_counter()
            loaded = deepspeed_tpu_torch.init_inference(INGEST_DIR, dtype="bf16",
                                                        device=INGEST_DEVICE)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        load_peak = acc.max_memory_allocated() - resident
        bad = _equal_leaves(loaded.params, params)
        check(not bad, f"loaded leaves differ from those written: {bad}")
        check(dataclasses.asdict(loaded.module.config) == dataclasses.asdict(cfg),
              f"loaded config {loaded.module.config} != {cfg}")

        prompts = _serve_prompts(cfg, seed)
        fa.launches = pda.launches = 0
        t0 = time.perf_counter()
        outs = loaded.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
        actions = dict(loaded._last_serve_actions)
        del loaded
        torch.cuda.empty_cache()
        memory = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16",
                                                    device=INGEST_DEVICE)
        want = memory.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
        equal = sum(int(np.array_equal(g, w)) for g, w in zip(outs, want))
        generated = sum(np.asarray(o).size - p.size for p, o in zip(prompts, outs))
        check(equal == len(prompts), f"{equal} of {len(prompts)} rows equal the in-memory "
              "engine's")
        check(actions.get("prefill", 0) > 0 and actions.get("decode", 0) > 0,
              f"the serve ran no prefill or no decode step: {actions}")
        check(launches == serve_launch_rule(cfg, actions),
              f"launches {launches} != {cfg.n_layer} x prefills, x decodes {actions}")
        state["ingest_launches"] = launches

        # ---- planted faults ----
        with untransposed_qk():
            faulted = deepspeed_tpu_torch.init_inference(INGEST_DIR, dtype="bf16",
                                                         device=INGEST_DEVICE)
        fault_outs = faulted.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
        rows_differ = sum(int(not np.array_equal(g, w)) for g, w in zip(fault_outs, want))
        toks = np.asarray(want[0])[:-1]
        fault_ulp = float(row_ulp_errs(paged_logits(faulted, toks, prompts[0].size),
                                       paged_logits(memory, toks, prompts[0].size)).max())
        del faulted, memory, params
        torch.cuda.empty_cache()
        check(rows_differ > 0 or fault_ulp > LOGIT_ULP_TOL,
              f"the un-transposed q/k load reads {fault_ulp} ulps and changes no row")
        raised = missing_shard_faults(
            INGEST_DIR, lambda d: load_hf_checkpoint(d, dtype=torch.bfloat16,
                                                     device=INGEST_DEVICE))
        check(all(raised.values()), f"a missing shard did not raise: {raised}")
        shutil.rmtree(INGEST_DIR, ignore_errors=True)

        families = {name: _family_parity(name, hf, seed) for name, hf in INGEST_FAMILIES.items()}
        out = dict(checkpoint_bytes=nbytes, shards=len(shards), write_s=write_s,
                   write_gb_per_s=nbytes / write_s / 1e9, load_s=load_s,
                   load_gb_per_s=nbytes / load_s / 1e9,
                   host_rss_gb_before_load=rss_before, host_peak_rss_gb=rss_peak[0],
                   process_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                   * 1024 / 1e9,
                   device_load_peak_gb=load_peak / 1e9, resident_before_load_gb=resident / 1e9,
                   leaves_equal=True, requests=len(prompts), max_new_tokens=SERVE_MAX_NEW,
                   generated_tokens=int(generated), serve_s=serve_s,
                   tokens_per_s=generated / serve_s, rows_equal_in_memory=equal, limit=0,
                   actions=actions, launches=launches,
                   fault_untransposed_qk={"rows_differ": rows_differ, "ulp_err": fault_ulp,
                                          "ulp_tol": LOGIT_ULP_TOL},
                   fault_missing_shard=raised, families=families,
                   megatron=_megatron_serve(seed), disk_free_gb=free / 1e9)
    finally:
        shutil.rmtree(INGEST_DIR, ignore_errors=True)
    emit("ingest", model="llama-2-7b (HF format, seeded bf16 weights)", layers=cfg.n_layer,
         dtype="bf16", max_seq=cfg.max_seq, norm_eps=cfg.norm_eps, card=state.get("card"),
         **out)


def phase_train_profile(state, seed):
    """Where one warm train step's time goes (not in the default run): a
    warm-up step, a step timed with the host clock, and a step under
    torch.profiler, whose device events give kernel time by class and the
    device's idle share against the timed step."""
    _profile_train_step(state, seed, "train_profile", TRAIN_CONFIG)


def phase_train_lamb_profile(state, seed):
    """:func:`phase_train_profile` for the train_lamb phase's configuration
    (FusedLamb and MoQ): K7's three kernels, K8 and its absmax kernel each
    a class of their own (not in the default run)."""
    _profile_train_step(state, seed, "train_lamb_profile", LAMB_CONFIG)


def phase_train_sparse_profile(state, seed):
    """:func:`phase_train_profile` for the train_sparse phase's
    configuration (the sparse model at SPARSE_SEQ, micro 2 x gas 2)."""
    _profile_train_step(state, seed, "train_sparse_profile", _sparse_train_config(),
                        sparse=True, seq=SPARSE_SEQ)


def phase_health_profile(state, seed):
    """:func:`phase_train_profile` with ``telemetry.health`` on (its
    sentinels gathered in the update), to set beside train_profile's
    breakdown (not in the default run)."""
    _profile_train_step(state, seed, "health_profile",
                        {**TRAIN_CONFIG, "telemetry": {"health": {"enabled": True}}})


def _profile_train_step(state, seed, phase, config, sparse=False, seq=TRAIN_SEQ):
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, engine, batch = _train_setup(seed, config, sparse=sparse, seq=seq)
    engine.train_batch(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batch)
        torch.cuda.synchronize()
    by_class, top = _device_time(prof)
    busy_ms = sum(by_class.values())
    emit(phase, card=state.get("card"), timed_step_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
         device_ms_by_class=by_class, top_kernels=top)
    del engine, batch
    torch.cuda.empty_cache()


def _kernel_class(name):
    n = name.lower()
    for kernel, cls in (("flash_fwd_kernel", "flash_attention_fwd"),
                        ("flash_bwd_dq_kernel", "flash_bwd_dq"),
                        ("flash_bwd_dkv_kernel", "flash_bwd_dkv"),
                        ("fused_adam_kernel", "fused_adam"),
                        ("paged_decode_kernel", "paged_decode_attention"),
                        ("paged_decode_combine_kernel", "paged_decode_attention"),
                        ("dense_decode_kernel", "dense_decode_attention"),
                        ("dense_decode_combine_kernel", "dense_decode_attention"),
                        ("fused_ce_fwd_kernel", "fused_ce_fwd"),
                        ("fused_ce_combine_kernel", "fused_ce_fwd"),
                        ("fused_ce_ds_kernel", "fused_ce_ds"),
                        ("fused_ce_db_kernel", "fused_ce_ds"),
                        ("ce_dh_gemm_kernel", "fused_ce_dh_gemm"),
                        ("ce_dw_gemm_kernel", "fused_ce_dw_gemm"),
                        ("lamb_moments_kernel", "fused_lamb_moments"),
                        ("lamb_ratio_kernel", "fused_lamb_ratio"),
                        ("lamb_apply_kernel", "fused_lamb_apply"),
                        ("sr_quantize_kernel", "sr_quantize"),
                        ("sr_absmax_kernel", "sr_absmax"),
                        ("sr_scale_kernel", "sr_absmax"),
                        ("dequant_int8", "dequant_int8")):
        if kernel in n:
            return cls
    if any(t in n for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul"
    return "other"


def phase_profile(state, seed):
    """Where the serve phase's time goes (not in the default run): the same
    prompts through a fresh engine twice after a warm-up serve, once timed
    with the host clock and once under torch.profiler, whose device events
    give kernel time by class and the device's idle share."""
    import torch
    import deepspeed_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    model, params = _llama7b(seed)
    prompts = _serve_prompts(model.config, seed)
    runs = {}
    for label in ("warmup", "timed", "profiled"):
        engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "profiled":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                engine.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
                torch.cuda.synchronize()
        else:
            engine.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
            torch.cuda.synchronize()
        runs[label] = {"wall_s": time.perf_counter() - t0,
                       "actions": dict(engine._last_serve_actions)}
        del engine
        torch.cuda.empty_cache()
    generated = SERVE_MAX_NEW * len(prompts)
    by_class, top = _device_time(prof)
    busy_ms = sum(by_class.values())
    # the profiler slows the host several times over, so the idle share is
    # taken against the unprofiled timed run of the same work
    wall_ms = runs["timed"]["wall_s"] * 1e3
    emit("profile", card=state.get("card"), tokens_per_s_warm=generated / runs["timed"]["wall_s"],
         runs=runs, device_busy_ms=busy_ms, timed_wall_ms=wall_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         device_ms_by_class=by_class, top_kernels=top)


def _device_time(prof):
    """Device kernel time (ms) by class from a torch.profiler run, and the
    15 kernels that took longest."""
    by_class, top = {}, []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = float(e.self_device_time_total)
        if us <= 0:
            continue
        c = _kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    return by_class, [{"ms": ms, "count": n, "name": k}
                      for ms, n, k in sorted(top, reverse=True)[:15]]


# ---- phase telemetry: the serving and training paths with telemetry on ----

TEL_TRAIN_STEPS = 3
TEL_SERVE_PAIRS = 4       # serves with telemetry on and off, alternating which goes first
CLOCK_TOL = 0.10          # summed decode.tick vs CUDA-event time over the same steps
MFU_TOL = 0.03            # train/mfu vs the phase's own MFU, relative
CLOCK_SLEEP_MS = 100.0    # device time planted at the end of each decode forward (clock check)
CLOCK_MAX_NEW = 8
TEL_DEVICE = None         # the engines' device (None: cuda:0) and serving dtype
TEL_DTYPE = "bf16"


def _validate_trace_tool():
    """``tools/validate_trace.py`` of the checkout, loaded as a tool (its
    chrome-trace checks import nothing of the package)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "validate_trace.py")
    spec = importlib.util.spec_from_file_location("validate_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reset_telemetry():
    """The process-global registry and flight recorder, emptied (the counts
    of one run must not leak into the next)."""
    from deepspeed_tpu_torch.monitor import get_flight_recorder, get_registry
    get_registry().reset()
    get_flight_recorder().clear()


def _cuda_event():
    import torch
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _device_sleep_fn(ms):
    """A callable that queues ``ms`` of device time (``torch.cuda._sleep``,
    its cycles calibrated on the card here) without waiting for it."""
    import torch
    cycles = 10_000_000
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    e0 = _cuda_event()
    torch.cuda._sleep(cycles)
    e1 = _cuda_event()
    e1.synchronize()
    n = int(cycles * ms / e0.elapsed_time(e1))
    return lambda: torch.cuda._sleep(n)


def early_clock_decode(self, reqs):
    """The planted clock fault: a copy of ``_ServeSession._decode`` whose
    ``decode.tick`` clock stops after the forward is dispatched, before the
    token read, so it times the launch queue and not the device."""
    import numpy as np
    import torch
    engine, sched, model = self.engine, self.sched, self.engine.module
    W, n_max = self.W, self.n_max
    bt = np.zeros((W, n_max), np.int32)
    pos = np.zeros((W,), np.int32)
    toks = np.zeros((W, 1), np.int64)
    for i, r in enumerate(reqs):
        bt[i, :len(r.blocks)] = r.blocks
        pos[i] = r.pos
        toks[i, 0] = r.last_token
    t0 = time.monotonic_ns()
    logits, self.pools = model.forward_paged_decode(
        engine.params, self._tensor(toks, torch.long), self.pools,
        self._tensor(bt, torch.int32), self._tensor(pos, torch.int32))
    dur = time.monotonic_ns() - t0             # the fault: before the read
    tok = self._sample(logits)
    self.ev.emit("decode.tick", t_ns=t0, dur_ns=dur, rids=[r.rid for r in reqs], n=len(reqs))
    sched.telemetry.phase("decode", dur / 1e6)
    for i, r in enumerate(reqs):
        sched.record_decode(r, int(tok[i]))


def decode_clock_ratio(engine, prompts, decode, sleep):
    """Serve ``prompts`` through ``engine`` (telemetry events on) with
    ``decode`` as the session's decode step and ``sleep`` queued at the end
    of every decode forward (device work the host does not wait for: queued
    ahead of the forward, it would fill the launch queue and stall the
    host's dispatch behind it): the summed ``decode.tick`` durations over
    the CUDA-event time of the same steps (events recorded on entry to and
    return from the step)."""
    from deepspeed_tpu_torch.inference import engine as ie
    from deepspeed_tpu_torch.monitor import get_flight_recorder
    model = engine.module
    forward = model.forward_paged_decode
    pairs = []

    def timed(self, reqs):
        e0 = _cuda_event()
        decode(self, reqs)
        pairs.append((e0, _cuda_event()))

    def slowed(*args, **kw):
        out = forward(*args, **kw)
        sleep()
        return out

    get_flight_recorder().clear()
    sound = ie._ServeSession._decode
    ie._ServeSession._decode = timed
    model.forward_paged_decode = slowed
    try:
        engine.generate_batch(prompts, max_new_tokens=CLOCK_MAX_NEW)
    finally:
        ie._ServeSession._decode = sound
        del model.forward_paged_decode
    pairs[-1][1].synchronize()
    event_ms = sum(a.elapsed_time(b) for a, b in pairs)
    ticks = [e.dur_ns for e in get_flight_recorder().snapshot() if e.kind == "decode.tick"]
    check(len(ticks) == len(pairs) > 0, f"{len(ticks)} decode.tick events, {len(pairs)} steps")
    return sum(ticks) / 1e6 / event_ms, event_ms


def registry_launch_rule(cfg, counters):
    """A and B launches of a serve from the metrics registry's step
    counters: A once a layer per whole-prompt prefill (admissions that
    scheduled prefill work less those that began with a chunk: with
    chunking off each has one), B once a layer per decode step and per
    verify-window position."""
    return {"flash_attention_fwd": cfg.n_layer * int(counters["serving/prefill_steps"]
                                                     - counters["serving/prefill_chunks"]),
            "paged_decode_attention": cfg.n_layer * int(
                counters["serving/decode_steps"]
                + SPEC_WB * counters["serving/spec_verify_steps"])}


def _tel_train(seed, telemetry):
    """The train phase's configuration, TEL_TRAIN_STEPS steps from its
    seeded state: losses (read after the steps), per-step host syncs
    through the accelerator, launches and host-clock seconds, and the
    engine's telemetry snapshot."""
    import torch
    import deepspeed_tpu_torch.accelerator.abstract_accelerator as accel
    config = dict(TRAIN_CONFIG)
    if telemetry:
        config["telemetry"] = {"events": True}
    model, engine, batch = _train_setup(seed, config)
    losses, syncs, launches, step_s = [], [], [], []
    for _ in range(TEL_TRAIN_STEPS):
        before = _train_counters()
        s0 = accel.syncs
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        syncs.append(accel.syncs - s0)
        after = _train_counters()
        launches.append({k: after[k] - before[k] for k in after})
    losses = [float(x) for x in losses]
    snap = engine.telemetry_snapshot()
    rule = train_launch_rule(engine)
    engine.destroy()
    del engine, batch
    torch.cuda.empty_cache()
    return model, losses, syncs, launches, step_s, snap, rule


def phase_telemetry(state, seed):
    """Full Llama-2-7B served with ``telemetry={"events": True}`` and
    without (the serve phase's prompts), TEL_SERVE_PAIRS pairs of fresh
    engines over one weight tree, alternating which side goes first: tokens
    equal, tokens/s of every serve, TTFT / TPOT p50 and p99 from the
    registry, A and B launches against the registry's step counters, the
    snapshot and the exported serving trace valid, the same host syncs; the
    decode clock against CUDA events with device time planted after each
    decode forward (sound within CLOCK_TOL, the early-clock copy outside it). Then the train phase's configuration for
    TEL_TRAIN_STEPS steps with telemetry on and off: losses bit-equal,
    launches equal to the train rule, one host sync a step on and none
    off, ``train/mfu`` within MFU_TOL of the phase's own."""
    import tempfile

    import numpy as np
    import torch
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.accelerator.abstract_accelerator as accel
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference import engine as ie
    from deepspeed_tpu_torch.monitor import get_flight_recorder, validate_snapshot
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    failures = []
    t_phase = time.perf_counter()
    model, params = _llama7b(seed)
    cfg = model.config
    prompts = _serve_prompts(cfg, seed)
    rng = np.random.default_rng(seed + 7)
    shared = rng.integers(0, cfg.vocab_size, size=128)
    warm = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=n)]) for n in (9, 40)]

    def engine(on):
        """A fresh engine over the one weight tree, warmed up (a prefill, a
        cache-hit chunk, decodes), so every measured serve does the same work."""
        eng = deepspeed_tpu_torch.init_inference(
            model, params=params, dtype=TEL_DTYPE, device=TEL_DEVICE,
            **({"telemetry": {"events": True}} if on else {}))
        eng.generate_batch(warm, max_new_tokens=4)
        return eng

    runs = {}
    for i in range(TEL_SERVE_PAIRS):      # alternating which side serves first
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            name = f"{'on' if on else 'off'}{i}"
            eng = engine(on)
            _reset_telemetry()
            fa.launches = pda.launches = 0
            s0 = accel.syncs
            t0 = time.perf_counter()
            outs = eng.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            gen = sum(np.asarray(o).size - p.size for p, o in zip(prompts, outs))
            runs[name] = {"outs": [np.asarray(o) for o in outs], "wall_s": wall,
                          "tokens_per_s": gen / wall, "syncs": accel.syncs - s0,
                          "a": fa.launches, "b": pda.launches,
                          "snap": eng.telemetry_snapshot(),
                          "actions": eng._last_serve_actions}
            if name == "on0":
                trace_dir = tempfile.mkdtemp(prefix="ds_telemetry_")
                trace = eng.export_serving_trace(os.path.join(trace_dir, "serve_trace.json"))
                trace_errors = _validate_trace_tool().validate_path(trace, kind="chrome")
                shutil.rmtree(trace_dir, ignore_errors=True)
                n_events = len(get_flight_recorder())
            del eng
    r_on = runs["on0"]
    rows_equal = sum(np.array_equal(a, b) for a, b in zip(r_on["outs"], runs["off0"]["outs"]))
    if rows_equal != len(prompts):
        failures.append(f"telemetry changed tokens: {rows_equal} of {len(prompts)} rows equal")
    snap = r_on["snap"]
    try:
        validate_snapshot(snap)
    except ValueError as e:
        failures.append(f"snapshot invalid: {e}")
    if trace_errors:
        failures.append(f"serving trace invalid: {trace_errors[:3]}")
    c, h = snap["counters"], snap["histograms"]
    serve_launches = {"flash_attention_fwd": r_on["a"], "paged_decode_attention": r_on["b"]}
    want = registry_launch_rule(cfg, c)
    if serve_launches != want or not (c["serving/decode_steps"] > 0
                                      and c["serving/prefill_steps"] > 0):
        failures.append(f"launches {serve_launches} != the registry's rule {want}")
    if serve_launches != serve_launch_rule(cfg, r_on["actions"]):
        failures.append(f"launches {serve_launches} != the actions' rule {r_on['actions']}")
    if h["serving/ttft_ms"]["count"] != len(prompts) or c["serving/requests"] != len(prompts):
        failures.append(f"ttft count {h['serving/ttft_ms']['count']} for {len(prompts)} requests")
    for name, r in runs.items():
        same = [np.array_equal(a, b) for a, b in zip(r["outs"], r_on["outs"])]
        if not all(same) or (r["a"], r["b"], r["syncs"]) != (r_on["a"], r_on["b"],
                                                             r_on["syncs"]):
            failures.append(f"run {name}: rows equal {sum(same)}, launches A {r['a']} B "
                            f"{r['b']}, host syncs {r['syncs']} (on0: {r_on['a']}, "
                            f"{r_on['b']}, {r_on['syncs']})")
    tps = {side: sorted(r["tokens_per_s"] for k, r in runs.items() if k.startswith(side))
           for side in ("on", "off")}
    wins_on = sum(runs[f"on{i}"]["tokens_per_s"] > runs[f"off{i}"]["tokens_per_s"]
                  for i in range(TEL_SERVE_PAIRS))

    # the decode clock against CUDA events, device time planted ahead of each step
    sleep = _device_sleep_fn(CLOCK_SLEEP_MS)
    clock_prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (96, 160)]
    on = engine(True)
    ratio, event_ms = decode_clock_ratio(on, clock_prompts, ie._ServeSession._decode, sleep)
    fault_prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (96, 160)]
    fault_ratio, fault_event_ms = decode_clock_ratio(on, fault_prompts, early_clock_decode,
                                                     sleep)
    if abs(ratio - 1.0) > CLOCK_TOL:
        failures.append(f"decode.tick / CUDA-event time {ratio:.3f} outside {CLOCK_TOL}")
    if abs(fault_ratio - 1.0) <= CLOCK_TOL:
        failures.append(f"the early-clock fault read {fault_ratio:.3f}, inside {CLOCK_TOL}")
    del on, model, params
    torch.cuda.empty_cache()

    # training with telemetry on and off from the same seeded state
    tmodel, l_on, sy_on, la_on, st_on, tsnap, rule = _tel_train(seed, True)
    _, l_off, sy_off, la_off, _, _, _ = _tel_train(seed, False)
    if l_on != l_off:
        failures.append(f"train losses differ: on {l_on}, off {l_off}")
    if sy_on != [1] * TEL_TRAIN_STEPS or sy_off != [0] * TEL_TRAIN_STEPS:
        failures.append(f"host syncs a step: on {sy_on}, off {sy_off}")
    for k, n in rule.items():
        if any(s[k] != n for s in la_on + la_off):
            failures.append(f"{k} launches a step on {[s[k] for s in la_on]}, "
                            f"off {[s[k] for s in la_off]} != {n}")
    acc = get_accelerator("cuda") if TEL_DEVICE is None else get_accelerator(TEL_DEVICE)
    peak = acc.peak_tflops()
    flops_tok = tmodel.flops_per_token(TRAIN_SEQ)
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    own_mfu = flops_tok * tokens / st_on[-1] / (peak * 1e12) if peak else 0.0
    gauge_mfu = tsnap["gauges"]["train/mfu"]
    if peak and abs(gauge_mfu / own_mfu - 1.0) > MFU_TOL:
        failures.append(f"train/mfu {gauge_mfu:.4f} vs the phase's {own_mfu:.4f}")
    if tsnap["counters"]["train/steps"] != TEL_TRAIN_STEPS:
        failures.append(f"train/steps {tsnap['counters']['train/steps']}")
    launches = dict(serve_launches)
    for k in rule:
        launches[k] = launches.get(k, 0) + sum(s[k] for s in la_on)
    state["telemetry_launches"] = launches

    hist = lambda name: {q: h[name][q] for q in ("count", "p50", "p99", "mean")}
    emit("telemetry", model="llama-2-7b", layers=cfg.n_layer, requests=len(prompts),
         max_new_tokens=SERVE_MAX_NEW, rows_equal=int(rows_equal),
         tokens_per_s={k: r["tokens_per_s"] for k, r in runs.items()},
         tokens_per_s_median_on=statistics.median(tps["on"]),
         tokens_per_s_median_off=statistics.median(tps["off"]),
         pairs_on_faster=wins_on, pairs=TEL_SERVE_PAIRS,
         wall_s={k: r["wall_s"] for k, r in runs.items()},
         ttft_ms=hist("serving/ttft_ms"), tpot_ms=hist("serving/tpot_ms"),
         queue_wait_ms=hist("serving/queue_wait_ms"),
         phase_ms={k.split("phase=")[1].split('"')[1]: v["mean"] for k, v in h.items()
                   if k.startswith("serving/phase_ms")},
         serving_counters={k: v for k, v in c.items() if k.startswith("serving/") and v},
         events=n_events, trace_valid=not trace_errors,
         host_syncs_serve={k: r["syncs"] for k, r in runs.items()},
         launches_serve=serve_launches, launches_registry_rule=want,
         decode_clock_ratio=ratio, decode_event_ms=event_ms,
         fault_early_clock_ratio=fault_ratio, fault_event_ms=fault_event_ms,
         clock_tol=CLOCK_TOL, clock_sleep_ms=CLOCK_SLEEP_MS,
         train_losses_on=l_on, train_losses_off=l_off, train_losses_equal=l_on == l_off,
         train_syncs_on=sy_on, train_syncs_off=sy_off, train_step_s_on=st_on,
         train_mfu_gauge=gauge_mfu, train_mfu_own=own_mfu, mfu_tol=MFU_TOL,
         train_step_time_ms=tsnap["histograms"]["train/step_time_ms"]["mean"],
         train_tokens_per_s=tsnap["gauges"]["train/tokens_per_sec"],
         train_launches_per_step=rule, phase_s=time.perf_counter() - t_phase,
         card=state.get("card"))
    check(not failures, "telemetry failed: " + "; ".join(failures))


# --------------------------------------------------------------------- #
# client optimizers and the health observatory (the control plane slice)

CLIENT_LR = 1e-4
CLIENT_ADAMW = {"lr": CLIENT_LR, "betas": (0.9, 0.95), "eps": 1e-8, "weight_decay": 0.1,
                "foreach": True}
CHECK_DEVICE = "cuda"     # the phases' engines (the CPU tests run them on "cpu")
CHECK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_check", "health")
HEALTH_STEPS = 5          # 3 checked against the plain recomputation, 2 timed
HEALTH_CHECKED = 3
NORM_TOL = 1e-5           # param and bucket norms against the plain recomputation, relative
UPDATE_TOL = 1e-5         # the update norm (lr ||u|| from the update vector), relative
SLO_TTFT = {"name": "ttft", "metric": "serving/ttft_ms", "kind": "latency",
            "threshold_ms": 250.0, "objective": 0.9, "windows": [1]}


def client_adamw(params):
    """The client_opt phase's optimizer: foreach AdamW over the engine's masters."""
    import torch
    return torch.optim.AdamW(params, **CLIENT_ADAMW)


def grad_fingerprint(g):
    """A leaf's gradient fingerprint: its fp64 sum and sum of squares and the
    int64 sum of its fp32 bit patterns (equal for bit-equal tensors)."""
    import torch
    g = g.detach().reshape(-1)
    d = g.double()
    return (float(d.sum()), float((d * d).sum()),
            int(g.float().view(torch.int32).to(torch.int64).sum()))


def client_launch_rule(engine):
    """The train rule for a client optimizer: the same attention and fused CE
    launches, E not at all."""
    return {**train_launch_rule(engine), "fused_adam": 0}


def _sync():
    import torch
    if CHECK_DEVICE == "cuda":
        torch.cuda.synchronize()


def _free():
    import gc
    import torch
    gc.collect()          # an engine's reference cycles hold its tensors until collected
    if CHECK_DEVICE == "cuda":
        torch.cuda.empty_cache()


def _builtin_run(seed, steps):
    """The train phase's engine-built FusedAdam from the seeded state: the
    grads kernel E receives at step 1 (fingerprints in leaf order), each
    step's losses, host-clock seconds and E's summed CUDA-event ms."""
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    model, engine, batch = _train_setup(seed)
    real = fad.fused_adam_step
    seen, e_pairs = [], []

    def timed(param, grad, *args, **kw):
        if engine.global_steps == 0:
            seen.append(grad_fingerprint(grad))
        e0 = _cuda_event()
        out = real(param, grad, *args, **kw)
        e_pairs[-1].append((e0, _cuda_event()))
        return out

    fad.fused_adam_step = timed
    losses, step_s = [], []
    try:
        for _ in range(steps):
            e_pairs.append([])
            t = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            _sync()
            step_s.append(time.perf_counter() - t)
    finally:
        fad.fused_adam_step = real
    names = list(engine._names)
    e_ms = [sum(a.elapsed_time(b) for a, b in pairs) for pairs in e_pairs]
    engine.destroy()
    del engine, batch
    _free()
    return model, dict(zip(names, seen)), losses, step_s, e_ms


def _hand_adamw(pre, grad, scale=1.0):
    """One torch.optim.AdamW step applied by hand to a copy of ``pre`` with
    ``grad * scale`` (on the phase's device)."""
    p = pre.to(CHECK_DEVICE).clone()
    p.grad = grad.to(CHECK_DEVICE) * scale if scale != 1.0 else grad.to(CHECK_DEVICE)
    client_adamw([p]).step()
    return p.detach()


def phase_client_opt(state, seed):
    """The train phase's configuration with a client optimizer
    (``CLIENT_ADAMW``, foreach AdamW over the fp32 masters) against the
    engine-built FusedAdam from the same seeded state: the grads the client
    optimizer receives at step 1 equal those kernel E receives (limit 0,
    per-leaf fingerprints: fp64 sum, fp64 sum of squares, int64 sum of the
    fp32 bits); the masters after step 1 equal torch.optim.AdamW applied by
    hand to a copy of the pre-step masters with those grads (limit 0), while
    two planted faults (the engine's WarmupLR factor applied on top of the
    client update, the clip applied twice) read above 0; per step A 2 L gas,
    C and D L gas, each fused CE kernel gas and E no launch; finite losses,
    step 6 below step 1. Step ms, tokens/s, MFU, peak memory and the
    optimizer's own time by CUDA events, beside the engine-built run's step
    ms and E's time."""
    import numpy as np
    from deepspeed_tpu_torch.accelerator import get_accelerator

    acc = get_accelerator(CHECK_DEVICE)
    failures = []
    t_phase = time.perf_counter()
    _, e_grads, b_losses, b_step_s, e_ms = _builtin_run(seed, TRAIN_STEPS)

    acc.reset_peak_memory_stats()
    config = {k: v for k, v in TRAIN_CONFIG.items() if k != "optimizer"}
    model, engine, batch = _train_setup(seed, config, optimizer=client_adamw)
    opt = engine.client_optimizer
    names = engine._client_names
    want = client_launch_rule(engine)
    real_step = opt.step
    step_pairs, captured = [], {}

    def step(*args, **kw):
        if not captured:            # step 1: the grads handed over, the pre-step masters
            held = [p for g in opt.param_groups for p in g["params"]]
            captured["grads"] = {n: grad_fingerprint(p.grad) for n, p in zip(names, held)}
            captured["pre"] = {n: (p.detach().to("cpu", copy=True),
                                   p.grad.detach().to("cpu", copy=True))
                               for n, p in zip(names, held)}
        e0 = _cuda_event()
        out = real_step(*args, **kw)
        step_pairs.append((e0, _cuda_event()))
        return out

    opt.step = step
    _reset_train_counters()
    losses, step_s, per_step = [], [], []
    hand = {}
    for i in range(TRAIN_STEPS):
        before = _train_counters()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        _sync()
        step_s.append(time.perf_counter() - t)
        after = _train_counters()
        per_step.append({k: after[k] - before[k] for k in after})
        if i == 0:
            hand = _client_hand_check(engine, captured.pop("pre"))
    launches = _train_counters()
    peak_gb = acc.max_memory_allocated() / 1e9
    opt_ms = [a.elapsed_time(b) for a, b in step_pairs]

    mism = [n for n in names if captured["grads"][n] != e_grads.get(n)]
    if len(e_grads) != len(names) or mism:
        failures.append(f"step-1 grads differ from E's at {len(mism)} leaves: {mism[:3]}")
    if hand["sound"] != 0.0:
        failures.append(f"masters after step 1 differ from AdamW by hand: {hand['sound']}")
    if not hand["coef"] < 1.0:
        failures.append(f"the clip did not bite at step 1 (coefficient {hand['coef']}): "
                        "the clip-twice fault cannot be planted")
    for fault in ("lr_factor", "clip_twice"):
        if not hand[fault] > 0.0:
            failures.append(f"the planted fault {fault} read {hand[fault]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses {losses}")
    for k, n in want.items():
        if any(s[k] != n for s in per_step):
            failures.append(f"{k} launches a step {[s[k] for s in per_step]} != {n}")
    state["client_opt_launches"] = launches
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    step = statistics.median(step_s[1:])
    b_step = statistics.median(b_step_s[1:])
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak = acc.peak_tflops()
    n_params = sum(p.numel() for p in engine.state.params.parameters())
    engine.destroy()
    del engine, batch, opt
    _free()
    emit("client_opt", model="llama-2-7b width", layers=model.config.n_layer, seq=TRAIN_SEQ,
         optimizer="torch.optim.AdamW", optimizer_args={**CLIENT_ADAMW, "betas": [0.9, 0.95]},
         params=n_params, losses=losses, step_s=step_s, step_ms_median_timed=step * 1e3,
         tokens_per_s=tokens / step,
         mfu=flops_tok * tokens / step / (peak * 1e12) if peak else None,
         peak_mem_gb=peak_gb, opt_step_ms=opt_ms,
         opt_step_ms_median_timed=statistics.median(opt_ms[1:]),
         builtin_losses=b_losses, builtin_step_s=b_step_s,
         builtin_step_ms_median_timed=b_step * 1e3, e_ms_a_step=e_ms,
         e_ms_median_timed=statistics.median(e_ms[1:]),
         grads_equal_leaves=len(names) - len(mism), leaves=len(names),
         grad_fingerprint="fp64 sum, fp64 sum of squares, int64 sum of the fp32 bits",
         hand_adamw_max_abs_diff=hand["sound"], fault_lr_factor=hand["lr_factor"],
         fault_clip_twice=hand["clip_twice"], clip_coef=hand["coef"],
         launches_per_step=want, launches=launches, phase_s=time.perf_counter() - t_phase,
         card=state.get("card"))
    check(not failures, "client_opt failed: " + "; ".join(failures))


def _client_hand_check(engine, pre):
    """After step 1: each master against torch.optim.AdamW applied by hand to
    its pre-step copy with the grad the client optimizer received (largest
    |difference|, limit 0), and the two planted faults' largest differences:
    the engine's WarmupLR factor at step 0 applied on top of that update, and
    the grad clipped a second time by the step's clip coefficient."""
    norm = float(engine._global_grad_norm)
    clip = float(engine.gradient_clipping())
    coef = min(1.0, clip / (norm + 1e-6))
    factor = float(engine._lr_fn(0)) / TRAIN_CONFIG["scheduler"]["params"]["warmup_max_lr"]
    out = {"sound": 0.0, "lr_factor": 0.0, "clip_twice": 0.0, "coef": coef}
    targets = engine.state.master or engine._param_dict(engine.state.params)
    for n, (p0, g) in pre.items():
        got = targets[n]
        sound = _hand_adamw(p0, g)
        pd = p0.to(CHECK_DEVICE)
        warm = pd + factor * (sound - pd)
        twice = _hand_adamw(p0, g, scale=coef)
        for key, t in (("sound", sound), ("lr_factor", warm), ("clip_twice", twice)):
            out[key] = max(out[key], float((t - got).abs().max()))
        del sound, warm, twice, pd
    return out


def _plain_sentinels(engine, rec):
    """Wrap the engine's update so each step appends a plain recomputation of
    its sentinel parts on the device, in fp64, from the same step's grads and
    masters (no host read): non-finite counts, the grad norm, the bucket norms
    (grouped by each leaf name's first key), the param norm and the update
    norm ``lr ||u||``, u the Adam direction recomputed in fp64 from the step's
    new moments and a copy of the pre-update masters (weight decay
    included). Returns the restore callable."""
    import torch
    real = engine._apply_update

    def wrapped(gas, grads=None):
        st = engine.state
        src = grads if grads is not None else st.acc_grads
        denom = st.scaler.loss_scale * gas
        z = lambda: torch.zeros((), dtype=torch.float64, device=engine.device)
        plain = {"nf_g": z(), "gsq": z(), "buckets": {}, "nf_p": z(), "psq": z(), "usq": z()}
        for n in engine._names:
            x = src[n].double() / denom
            sq = (x * x).sum()
            plain["nf_g"] += (~torch.isfinite(x)).sum()
            plain["gsq"] += sq
            b = n.split(".", 1)[0]
            plain["buckets"][b] = plain["buckets"].get(b, z()) + sq
            del x
        targets = st.master if st.master is not None else engine._param_dict(st.params)
        old = {n: m.detach().clone() for n, m in targets.items()}
        tx, lr, step = engine.tx, float(engine._lr_fn(st.global_steps)), st.opt_state.count + 1
        bc1, bc2 = 1.0 - tx.b1 ** step, 1.0 - tx.b2 ** step
        real(gas, grads)
        for n, m in targets.items():
            plain["nf_p"] += (~torch.isfinite(m)).sum()
            plain["psq"] += (m.double() ** 2).sum()
            u = (st.opt_state.mu[n].double() / bc1) / (
                torch.sqrt(st.opt_state.nu[n].double() / bc2) + tx.eps)
            if tx.adam_w_mode and tx.weight_decay:
                u += tx.weight_decay * old[n].double()
            del old[n]
            plain["usq"] += (u * u).sum() * (lr * lr)
            del u
        plain["norm"] = engine._global_grad_norm
        plain["sentinels"] = engine._sentinels
        rec.append(plain)

    engine._apply_update = wrapped
    return lambda: engine.__dict__.pop("_apply_update", None)


def _held_sentinels(plain, names, failures, step):
    """One step's sentinel vector against its plain recomputation."""
    import math
    from deepspeed_tpu_torch.monitor.health import sentinel_to_dict
    d = sentinel_to_dict(plain["sentinels"].cpu().tolist(), names)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    got_gn = float(plain["norm"].cpu())
    if d["grad_norm"] != got_gn:
        failures.append(f"step {step}: sentinel grad norm {d['grad_norm']} is not the "
                        f"clip's {got_gn}")
    if rel(d["grad_norm"], math.sqrt(float(plain["gsq"]))) > NORM_TOL:
        failures.append(f"step {step}: grad norm {d['grad_norm']} vs plain "
                        f"{math.sqrt(float(plain['gsq']))}")
    if (d["nonfinite_grads"], d["nonfinite_params"]) != (float(plain["nf_g"]),
                                                          float(plain["nf_p"])):
        failures.append(f"step {step}: non-finite counts {d['nonfinite_grads']}, "
                        f"{d['nonfinite_params']} vs plain {float(plain['nf_g'])}, "
                        f"{float(plain['nf_p'])}")
    pn, un = math.sqrt(float(plain["psq"])), math.sqrt(float(plain["usq"]))
    if rel(d["param_norm"], pn) > NORM_TOL:
        failures.append(f"step {step}: param norm {d['param_norm']} vs plain {pn}")
    if rel(d["update_norm"], un) > UPDATE_TOL:
        failures.append(f"step {step}: update norm {d['update_norm']} vs plain {un}")
    worst = 0.0
    for b, v in d["bucket_norms"].items():
        worst = max(worst, rel(v, math.sqrt(float(plain["buckets"][b]))))
    if worst > NORM_TOL:
        failures.append(f"step {step}: bucket norms off by {worst} relative")
    return {"grad_norm": d["grad_norm"], "param_norm": d["param_norm"],
            "param_norm_plain": pn, "update_norm": d["update_norm"], "update_norm_plain": un,
            "bucket_norm_worst_rel": worst, "update_ratio": d["update_ratio"]}


def _health_train(seed, telemetry, on_engine=None, on_step=None):
    """The train phase's configuration for HEALTH_STEPS steps from its seeded
    state (``telemetry`` its section, or None): losses, per-step host syncs
    through the accelerator, launches and host-clock seconds.
    ``on_engine(engine)`` runs once the engine is built, ``on_step(i,
    engine)`` after each step, outside the counted window. Returns the
    engine (not destroyed) with them."""
    import deepspeed_tpu_torch.accelerator.abstract_accelerator as accel
    config = dict(TRAIN_CONFIG)
    if telemetry is not None:
        config["telemetry"] = telemetry
    model, engine, batch = _train_setup(seed, config)
    if on_engine is not None:
        on_engine(engine)
    losses, syncs, launches, step_s = [], [], [], []
    for i in range(HEALTH_STEPS):
        before = _train_counters()
        s0 = accel.syncs
        t = time.perf_counter()
        losses.append(engine.train_batch(batch))
        _sync()
        step_s.append(time.perf_counter() - t)
        syncs.append(accel.syncs - s0)
        after = _train_counters()
        launches.append({k: after[k] - before[k] for k in after})
        if on_step is not None:
            on_step(i, engine)
    return model, engine, batch, [float(x) for x in losses], syncs, launches, step_s


def _reset_peak():
    from deepspeed_tpu_torch.accelerator import get_accelerator
    get_accelerator(CHECK_DEVICE).reset_peak_memory_stats()


def _peak_gb():
    from deepspeed_tpu_torch.accelerator import get_accelerator
    return get_accelerator(CHECK_DEVICE).max_memory_allocated() / 1e9


def _scrape(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read().decode()


def _cli(argv):
    """``python -m deepspeed_tpu_torch.cli`` in this process: (rc, stdout)."""
    import io
    from deepspeed_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def phase_health(state, seed):
    """The train phase's configuration with ``telemetry.health`` (sentinels,
    action dump), ``metrics_port`` 0 and the sampler (its JSONL under
    .chip_check/), HEALTH_STEPS steps on and as many off from one seeded
    state: losses bit-equal, one host sync a step on and none off, each of
    the first HEALTH_CHECKED steps' sentinels against a plain fp64
    recomputation on the card (non-finite counts equal, the grad norm the
    clip's bits, param and bucket norms within NORM_TOL, the update norm
    within UPDATE_TOL); /metrics scraped between steps parses back to the
    registry's train/ values, /healthz 200; ``cli health --once --json`` and
    ``cli top --once`` over the sampler's JSONL print the registry's loss and
    MFU. Planted: an inf in one master with sentinels forced off (the params
    read finite to the detectors), then with them on (nonfinite reads 1 and
    the debug bundle holds a snapshot that loads and a chrome trace that
    validates). After teardown the port refuses connections. Then full
    Llama-2-7B serves the serve phase's prompts with events on: ``cli trace
    <rid>`` phases sum to each request's end-to-end time in ns, prefill and
    decode non-zero, TTFT p99 and a TTFT objective's burn rate ticked once
    after the serve."""
    import json as _json

    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.monitor import get_flight_recorder, get_registry, validate_snapshot
    from deepspeed_tpu_torch.monitor.slo import SloEngine, parse_objectives
    from deepspeed_tpu_torch.monitor.top import snapshot_from_prometheus
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    failures = []
    t_phase = time.perf_counter()
    _free()                  # an earlier phase's engines, before this one's peaks
    shutil.rmtree(CHECK_DIR, ignore_errors=True)
    os.makedirs(CHECK_DIR)
    samples = os.path.join(CHECK_DIR, "samples.jsonl")
    dumps = os.path.join(CHECK_DIR, "dumps")
    telemetry = {"health": {"enabled": True, "sentinels": True, "action": "dump",
                            "dump_dir": dumps},
                 "metrics_port": 0,
                 "sampler": {"enabled": True, "path": samples, "interval_s": 3600.0}}
    _reset_telemetry()
    plain, held, scrapes = [], [], []
    restore = []

    def on_step(i, engine):
        if i < HEALTH_CHECKED:
            held.append(_held_sentinels(plain[i], engine._health.bucket_names, failures, i + 1))
        engine._tel_sampler.tick()
        status, text = _scrape(engine._tel_exporter.url)
        snap = get_registry().snapshot()
        scraped = snapshot_from_prometheus(text)
        bad = [k for k, v in snap["gauges"].items() if k.startswith("train/")
               and scraped["gauges"].get(k) != v]
        scrapes.append({"status": status, "train_gauges": sum(k.startswith("train/")
                                                               for k in snap["gauges"]),
                        "mismatched": bad})
        if i + 1 == HEALTH_CHECKED:
            restore.pop()()
            _reset_peak()         # the timed steps' peak, without the plain copies

    # the health-on engine: the plain recomputation wraps its update for the
    # checked steps
    model, eng, batch, l_on, sy_on, la_on, st_on = _health_train(
        seed, telemetry, on_engine=lambda e: restore.append(_plain_sentinels(e, plain)),
        on_step=on_step)
    peak_on = _peak_gb()
    rule = train_launch_rule(eng)
    health_launches = {k: sum(s[k] for s in la_on) for k in la_on[0]}
    status, _ = _scrape(eng._tel_exporter.url.replace("/metrics", "/healthz"))
    if status != 200:
        failures.append(f"/healthz {status}")
    if any(s["mismatched"] or s["status"] != 200 or not s["train_gauges"] for s in scrapes):
        failures.append(f"scrapes {scrapes}")
    snap = get_registry().snapshot()
    rc_h, out_h = _cli(["health", samples, "--once", "--json"])
    rc_t, out_t = _cli(["top", samples, "--once"])
    summ = _json.loads(out_h) if rc_h == 0 else {}
    loss_g, mfu_g = snap["gauges"]["train/loss"], snap["gauges"]["train/mfu"]
    if rc_h or rc_t or summ.get("loss", {}).get("loss") != loss_g or \
            summ.get("train", {}).get("mfu") != mfu_g:
        failures.append(f"cli health rc {rc_h} ({summ.get('loss')}, {summ.get('train')}) / "
                        f"top rc {rc_t} against the registry's loss {loss_g}, MFU {mfu_g}")
    if f"MFU {mfu_g:.3f}" not in out_t or f"loss {loss_g:.4g}" not in out_t:
        failures.append(f"cli top shows no MFU {mfu_g:.3f} / loss {loss_g:.4g}")

    # planted: an inf in one master, sentinels forced off, then on
    leaf = "ln_f.scale"
    param = dict(eng.state.params.named_parameters())[leaf]
    anomalies = lambda: get_registry().snapshot()["counters"].get(
        'health/anomalies{type="nonfinite"}')
    targets = eng.state.master or dict(eng.state.params.named_parameters())
    master = targets[leaf]
    keep = master.detach().clone()
    eng._sentinels_on = False
    with torch.no_grad():
        master.view(-1)[0] = float("inf")
    eng.train_batch(batch)
    off_rec = eng._health.ring[-1]
    off_reads = (off_rec.nonfinite_params, anomalies())
    if off_reads != (0.0, 0.0):
        failures.append(f"sentinels off saw the planted inf: {off_reads}")
    with torch.no_grad():
        master.copy_(keep)
        param.copy_(keep)
    eng._sentinels_on = True
    with torch.no_grad():
        master.view(-1)[0] = float("inf")
    eng.train_batch(batch)
    on_rec, on_anom = eng._health.ring[-1], anomalies()
    if on_anom != 1.0 or not on_rec.nonfinite_params >= 1:
        failures.append(f"the planted inf read anomalies {on_anom}, nonfinite_params "
                        f"{on_rec.nonfinite_params}")
    bundles = sorted(os.listdir(dumps)) if os.path.isdir(dumps) else []
    bundle_ok = False
    if len(bundles) == 1 and "nonfinite" in bundles[0]:
        b = os.path.join(dumps, bundles[0])
        try:
            with open(os.path.join(b, "telemetry.json")) as f:
                validate_snapshot(_json.load(f))
            errors = _validate_trace_tool().validate_path(os.path.join(b, "trace.json"),
                                                          kind="chrome")
            bundle_ok = not errors
            if errors:
                failures.append(f"bundle trace invalid: {errors[:3]}")
        except (OSError, ValueError) as e:
            failures.append(f"bundle snapshot: {e}")
    else:
        failures.append(f"debug bundles {bundles}")
    url = eng._tel_exporter.url
    eng.destroy()
    try:
        _scrape(url)
        failures.append("the /metrics port still answers after teardown")
        refused = False
    except OSError:
        refused = True
    del eng, batch, targets, master, keep, param     # the masters, before the off run's peak
    _free()

    get_registry().reset()
    _, _, _, l_off, sy_off, la_off, st_off = _health_train(
        seed, None, on_step=lambda i, e: _reset_peak() if i + 1 == HEALTH_CHECKED else None)
    peak_off = _peak_gb()
    _free()
    if l_on != l_off:
        failures.append(f"losses on {l_on} off {l_off}")
    if sy_on != [1] * HEALTH_STEPS or sy_off != [0] * HEALTH_STEPS:
        failures.append(f"host syncs a step: on {sy_on}, off {sy_off}")
    for k, n in rule.items():
        if any(s[k] != n for s in la_on + la_off):
            failures.append(f"{k} launches a step on {[s[k] for s in la_on]}, "
                            f"off {[s[k] for s in la_off]} != {n}")

    # the serve cell with events on: request anatomy through the CLI
    _reset_telemetry()
    smodel, params = _llama7b(seed)
    prompts = _serve_prompts(smodel.config, seed)
    engine = deepspeed_tpu_torch.init_inference(smodel, params=params, dtype=TEL_DTYPE,
                                                device=TEL_DEVICE, telemetry={"events": True})
    slo = SloEngine(parse_objectives([SLO_TTFT]), registry=get_registry())
    slo.sample()
    fa.launches = pda.launches = 0
    engine.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
    _sync()
    serve_launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
    breaches = slo.sample()
    sgauges = get_registry().snapshot()
    burn = sgauges["gauges"]['slo/burn_rate{objective="ttft",window="1"}']
    ttft = sgauges["histograms"]["serving/ttft_ms"]
    events = get_flight_recorder().write_jsonl(os.path.join(CHECK_DIR, "events.jsonl"))
    rids = sorted({e.rid for e in get_flight_recorder().snapshot() if e.kind == "req.enqueue"})
    anatomy = []
    for rid in rids:
        rc, out = _cli(["trace", str(rid), "--events", events, "--json"])
        a = _json.loads(out) if rc == 0 else None
        if a is None:
            failures.append(f"cli trace {rid} rc {rc}")
            continue
        ns = lambda ms: round(ms * 1e6)
        exact = sum(ns(v) for v in a["phases_ms"].values()) == ns(a["total_ms"])
        if not exact or not (a["phases_ms"]["prefill"] > 0 and a["phases_ms"]["decode"] > 0):
            failures.append(f"rid {rid}: phases {a['phases_ms']} total {a['total_ms']}")
        anatomy.append({"rid": rid, "total_ms": a["total_ms"], "ttft_ms": a["ttft_ms"],
                        "phases_ms": a["phases_ms"]})
    if len(anatomy) != len(prompts):
        failures.append(f"{len(anatomy)} anatomies for {len(prompts)} requests")
    get_flight_recorder().disable()
    _reset_telemetry()
    del engine, params, smodel
    _free()
    for k, n in serve_launches.items():
        health_launches[k] = health_launches.get(k, 0) + n
    state["health_launches"] = health_launches
    shutil.rmtree(CHECK_DIR, ignore_errors=True)

    emit("health", model="llama-2-7b width", layers=model.config.n_layer, seq=TRAIN_SEQ,
         losses_on=l_on, losses_off=l_off, losses_equal=l_on == l_off,
         syncs_on=sy_on, syncs_off=sy_off, step_s_on=st_on, step_s_off=st_off,
         step_ms_on_median_timed=statistics.median(st_on[HEALTH_CHECKED:]) * 1e3,
         step_ms_off_median_timed=statistics.median(st_off[HEALTH_CHECKED:]) * 1e3,
         peak_gb_timed_on=peak_on, peak_gb_timed_off=peak_off,
         sentinels=held, scrapes=scrapes, cli_loss=loss_g, cli_mfu=mfu_g,
         planted_off=list(off_reads), planted_on_anomalies=on_anom,
         planted_on_nonfinite_params=on_rec.nonfinite_params,
         bundle_valid=bundle_ok, refused_after_teardown=refused,
         serve_requests=len(prompts), anatomy=anatomy, ttft_ms_p99=ttft["p99"],
         ttft_ms_p50=ttft["p50"], slo_ttft=SLO_TTFT, slo_burn_rate=burn,
         slo_breaches=len(breaches), launches=health_launches, launches_per_step=rule,
         phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    check(not failures, "health failed: " + "; ".join(failures))


# --------------------------------------------------------------------- #
# async serving: the always-on loop over the paged engine

ASYNC_DEVICE = None       # the engines' device (None: cuda:0; the CPU test passes "cpu")
ASYNC_DTYPE = "bf16"
ASYNC_RESULT_S = 600      # the longest a handle's result is waited for
ASYNC_HTTP_ROWS = (3, 9)  # the prompts the threaded run sends through POST /v1/completions
ASYNC_CHUNK = 512         # the controller check's baseline prefill_chunk_tokens


def async_trace(n, seed):
    """The replay's seeded arrival schedule: the prompts' order and how
    many arrive before each step (0 to 2), every prompt in."""
    import numpy as np
    rng = np.random.default_rng(seed + 7)
    order = [int(i) for i in rng.permutation(n)]
    trace, i = [], 0
    while i < n:
        k = int(rng.integers(0, 3)) if i else 2
        trace.append(order[i:i + k])
        i += k
    return trace


def _cold(engine):
    """The engine's serving state as built (the pools kept): no cached
    prefix blocks, rids from 0, so that runs compared with each other start
    alike."""
    engine._paged_alloc = None
    engine._serve_rid_base = 0


def _async_replay(engine, prompts, seed, faults=(), alone=None):
    """One ``AsyncServingEngine(start=False)`` run of the seeded trace,
    driven by ``step()``: the scheduler's actions as (kind, rids), each
    prompt's generated tokens and status, restarts, and the loop's own host
    time a step (``step()`` less the session's executor). ``faults``:
    ``fail_step`` keyword dicts injected for the run; ``alone``: a prompt
    index served to its end before the trace starts."""
    import time as _time
    from deepspeed_tpu_torch.inference import AsyncServingEngine
    from deepspeed_tpu_torch.utils import fault_injection as fi
    _cold(engine)
    serving = AsyncServingEngine(engine, max_new_tokens=SERVE_MAX_NEW, start=False)
    sess, actions, exec_s = serving._session, [], [0.0]
    real_next, real_exec = sess.sched.next_action, sess._exec

    def next_action():
        a = real_next()
        if a is not None:
            items = a[1] if isinstance(a[1], list) else [a[1]]
            actions.append((a[0], [r.rid for r in items if hasattr(r, "rid")]))
        return a

    def timed_exec(action):
        t = _time.perf_counter()
        try:
            real_exec(action)
        finally:
            exec_s[0] += _time.perf_counter() - t

    sess.sched.next_action, sess._exec = next_action, timed_exec
    inj = fi.FaultInjector()
    for f in faults:
        inj.fail_step(**f)
    handles, steps, step_s = {}, 0, 0.0

    def step():
        nonlocal steps, step_s
        t = _time.perf_counter()
        alive = serving.step()
        step_s += _time.perf_counter() - t
        steps += 1
        return alive

    with fi.inject(inj):
        if alone is not None:
            handles[alone] = serving.add_request(prompts[alone])
            while step():
                pass
        for arrivals in async_trace(len(prompts), seed):
            for i in arrivals:
                if i not in handles:
                    handles[i] = serving.add_request(prompts[i])
            step()
        while step():
            pass
    serving.shutdown(drain=True)
    order = sorted(handles)
    return {"actions": actions, "tokens": [handles[i].generated for i in order],
            "status": [handles[i].status for i in order], "restarts": serving.restarts,
            "steps": steps, "loop_host_ms_a_step": (step_s - exec_s[0]) * 1e3 / steps}


def _async_threaded(engine, prompts, seed, failures):
    """The loop on its serving thread: a client thread submits the prompts
    at seeded offsets (two of them through ``POST /v1/completions`` with
    SSE), one more request is cancelled mid-decode; /healthz and /metrics
    are read over HTTP. Returns the record, the rows and the SSE tokens."""
    import http.client
    import threading
    import numpy as np
    from deepspeed_tpu_torch.inference import AsyncServingEngine, serve
    from deepspeed_tpu_torch.monitor.metrics import get_registry
    from deepspeed_tpu_torch.monitor.top import snapshot_from_prometheus
    _cold(engine)
    _reset_telemetry()          # TTFT / TPOT of this run only
    serving = AsyncServingEngine(engine, max_new_tokens=SERVE_MAX_NEW)
    server = serve.build_http_server(serving, port=0)
    port = server.server_address[1]
    http_thread = threading.Thread(target=server.serve_forever, daemon=True)
    http_thread.start()
    created = []
    real_add = serving.add_request

    def add(prompt, **kw):                 # the handles the HTTP handler makes too
        h = real_add(prompt, **kw)
        created.append((np.asarray(prompt), h))
        return h

    serving.add_request = add

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()

    free0 = serving._session.sched.allocator.num_free
    health_before = get("/healthz")[0]
    rng = np.random.default_rng(seed + 11)
    offsets = rng.uniform(0.0, 0.25, size=len(prompts))
    handles, sse = {}, {}

    def post_stream(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=ASYNC_RESULT_S)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": [int(t) for t in prompts[i]], "max_tokens": SERVE_MAX_NEW,
             "stream": True}), {"Content-Type": "application/json"})
        lines = conn.getresponse().read().decode().splitlines()
        chunks = [json.loads(x[6:]) for x in lines if x.startswith("data: {")]
        sse[i] = ([t for c in chunks for t in c["choices"][0]["token_ids"]],
                  chunks[-1]["choices"][0]["finish_reason"], "data: [DONE]" in lines)

    posters = []

    def client():
        prev = 0.0
        for i in np.argsort(offsets):
            time.sleep(float(offsets[i]) - prev)
            prev = float(offsets[i])
            if int(i) in ASYNC_HTTP_ROWS:
                t = threading.Thread(target=post_stream, args=(int(i),), daemon=True)
                t.start()
                posters.append(t)
            else:
                handles[int(i)] = serving.add_request(prompts[int(i)])

    _sync()
    t0 = time.perf_counter()
    c = threading.Thread(target=client, daemon=True)
    c.start()
    c.join()
    victim = serving.add_request(prompts[0])           # cancelled mid-decode
    next(victim.stream(timeout=ASYNC_RESULT_S))
    victim.cancel()
    rows = {i: h.result(timeout=ASYNC_RESULT_S) for i, h in handles.items()}
    for t in posters:
        t.join(ASYNC_RESULT_S)
    _sync()
    wall = time.perf_counter() - t0
    victim.result(timeout=ASYNC_RESULT_S)
    m_status, m_text = get("/metrics")
    scraped = snapshot_from_prometheus(m_text)["counters"]
    registry = get_registry().snapshot()
    serving.shutdown(drain=True, timeout=ASYNC_RESULT_S)
    health_after = get("/healthz")[0]
    server.shutdown()
    http_thread.join(60)
    free1 = serving._session.sched.allocator.num_free
    for i in ASYNC_HTTP_ROWS:
        h = next(h for p, h in created if p.size == prompts[i].size
                 and np.array_equal(p, prompts[i]) and h is not victim)
        rows[i] = h.result(timeout=1)
        if i not in sse or sse[i][0] != h.generated or sse[i][1] != "stop" or not sse[i][2]:
            failures.append(f"row {i}: the SSE stream {sse.get(i)} is not the handle's "
                            f"{h.generated}")
    serving_counters = {k: v for k, v in registry["counters"].items()
                        if k.startswith("serving/")}
    bad_scrape = {k: (scraped.get(k), v) for k, v in serving_counters.items()
                  if scraped.get(k) != v}
    if victim.status != "cancelled" or not 0 < len(victim.generated) < SERVE_MAX_NEW:
        failures.append(f"the cancelled request ended {victim.status} after "
                        f"{len(victim.generated)} tokens")
    if free1 != free0:
        failures.append(f"free blocks {free1} after the drain, {free0} at the start")
    if (health_before, health_after) != (200, 503):
        failures.append(f"/healthz read {health_before} then {health_after}, not 200 then 503")
    if m_status != 200 or bad_scrape:
        failures.append(f"/metrics {m_status}: scraped counters off the registry {bad_scrape}")
    hist = registry["histograms"]
    rec = {"wall_s": wall, "http_rows": list(ASYNC_HTTP_ROWS), "sse_rows_equal_handle":
           sum(sse.get(i, ([],))[0] == rows[i][prompts[i].size:].tolist()
               for i in ASYNC_HTTP_ROWS),
           "cancelled_generated": len(victim.generated), "free_blocks_start": free0,
           "free_blocks_after_drain": free1, "healthz": [health_before, health_after],
           "metrics_counters_checked": len(serving_counters),
           "ttft_ms": {q: hist["serving/ttft_ms"][q] for q in ("p50", "p99", "count")},
           "tpot_ms": {q: hist["serving/tpot_ms"][q] for q in ("p50", "p99", "count")},
           "actions": dict(engine._last_serve_actions)}
    return rec, [rows[i] for i in range(len(prompts))]


def _async_burst(engine, prompts):
    """The loop on its serving thread with every prompt submitted at once
    from this thread (no HTTP, no arrival spread): the same work as one
    ``generate_batch``. Returns (wall seconds, rows)."""
    from deepspeed_tpu_torch.inference import AsyncServingEngine
    _cold(engine)
    _sync()
    t0 = time.perf_counter()
    with AsyncServingEngine(engine, max_new_tokens=SERVE_MAX_NEW) as serving:
        handles = [serving.add_request(p) for p in prompts]
        rows = [h.result(timeout=ASYNC_RESULT_S) for h in handles]
    _sync()
    return time.perf_counter() - t0, rows


def _async_knob(model, params, prompt, failures):
    """One AdaptiveController action through the loop's apply_knobs: with
    ``prefill_chunk_tokens`` ASYNC_CHUNK and a TTFT burn planted, one tick
    moves prefill_chunk one rung down its ladder, and the next prefill runs
    in chunks of that size (the req.prefill_chunk events)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import AsyncServingEngine
    from deepspeed_tpu_torch.monitor import get_flight_recorder, get_registry
    from deepspeed_tpu_torch.monitor.controller import AdaptiveController, knobs_from_serving
    _reset_telemetry()
    engine = deepspeed_tpu_torch.init_inference(
        model, params=params, dtype=ASYNC_DTYPE, device=ASYNC_DEVICE,
        serving={"prefill_chunk_tokens": ASYNC_CHUNK}, telemetry={"events": True})
    serving = AsyncServingEngine(engine, max_new_tokens=2, start=False)
    knobs = knobs_from_serving(engine.config.serving, policy=serving.policy)
    ladder = next(k.ladder for k in knobs if k.name == "prefill_chunk")
    ctl = AdaptiveController(knobs, events=engine._events, apply_fn=serving.apply_knobs,
                             cooldown_ticks=1, relax_after=2)
    g = get_registry().gauge("slo/burn_rate", "error-budget burn",
                             labelnames=("objective", "window"))
    for w in ("8", "2"):
        g.labels(objective="ttft_p99", window=w).set(2.0)
    moved = [a.to_payload() for a in ctl.tick() if a.knob == "prefill_chunk"]
    h = serving.add_request(prompt)
    while serving.step():
        pass
    serving.shutdown(drain=True)
    chunks = [e.data["tokens"] for e in get_flight_recorder().snapshot()
              if e.kind == "req.prefill_chunk"]
    want = [ladder[1]] * (prompt.size // ladder[1]) + ([prompt.size % ladder[1]]
                                                       if prompt.size % ladder[1] else [])
    if [m["value"] for m in moved] != [ladder[1]] or chunks != want or h.status != "finished":
        failures.append(f"prefill_chunk moved {moved} on ladder {ladder}; the next prefill ran "
                        f"chunks {chunks}, expected {want}; status {h.status}")
    get_flight_recorder().disable()
    _reset_telemetry()
    del engine, serving
    return {"ladder": list(ladder), "moved_to": [m["value"] for m in moved],
            "prompt_tokens": int(prompt.size), "chunks": chunks}


def phase_serve_async(state, seed):
    """Llama-2-7B (SERVE_LOOP_LAYERS layers) on the serve cell's default serving config through the
    async serving front-end. ``generate_batch`` on the serve phase's 12
    prompts (32 new tokens, greedy) gives the reference rows; the seeded
    trace replayed twice through ``AsyncServingEngine(start=False)`` gives
    identical actions and tokens (limit 0); under replay, a per-request
    prefill fault retries (tokens unchanged, limit 0), a fault past
    max_request_retries quarantines its request while the other rows stay
    unchanged (limit 0), an engine-fatal decode fault restarts once and
    every row equals the unfaulted replay's but where it first parts at a
    near-tie (the restart recomputes the decoded tokens by prefill); the
    serving thread with every prompt at once (generate_batch's work) and,
    the main path's run, with the prompts at seeded offsets (two over HTTP
    with SSE, one more request cancelled mid-decode): every row equals
    generate_batch's but where it first parts at a near-tie, the SSE tokens
    are the handle's, the free
    blocks return to their start, A = L x prefills and B = L x decode steps,
    /healthz reads 200 then 503, /metrics parses back to the registry; one
    controller action moves prefill_chunk one rung and the next prefill's
    chunks follow it."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    t_phase = time.perf_counter()
    failures = []
    acc = get_accelerator("cuda" if ASYNC_DEVICE is None else ASYNC_DEVICE)
    acc.reset_peak_memory_stats()
    model, params = _llama7b_cut(seed, SERVE_LOOP_LAYERS)
    cfg = model.config
    prompts = _serve_prompts(cfg, seed)
    _reset_telemetry()
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype=ASYNC_DTYPE,
                                                device=ASYNC_DEVICE, telemetry=True)
    engine.generate_batch([p[:64] for p in prompts[:2]], max_new_tokens=2)   # warm-up
    _cold(engine)
    generated = len(prompts) * SERVE_MAX_NEW

    def timed_generate_batch():
        _cold(engine)
        _sync()
        t0 = time.perf_counter()
        rows = engine.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
        _sync()
        return time.perf_counter() - t0, rows

    # deterministic replay, twice, then the planted faults against it
    runs = [_async_replay(engine, prompts, seed) for _ in range(2)]
    if runs[0]["actions"] != runs[1]["actions"] or runs[0]["tokens"] != runs[1]["tokens"]:
        failures.append("two replays of the seeded trace differ in actions or tokens")
    base = runs[0]
    retries = int(engine.config.serving.fault.max_request_retries)
    faulted = {
        "request_prefill_pre": _async_replay(engine, prompts, seed, faults=[
            {"kind": "prefill", "count": 1, "phase": "pre"}]),
        "engine_decode_post": _async_replay(engine, prompts, seed, faults=[
            {"kind": "decode", "at_step": len(base["actions"]) * 2 // 3, "count": 1,
             "phase": "post"}]),
        "past_max_request_retries": _async_replay(engine, prompts, seed, alone=5, faults=[
            {"kind": "prefill", "count": retries + 1, "phase": "pre"}]),
    }
    f_rec = {}
    full = lambda toks: [np.concatenate([p, np.asarray(t, p.dtype)]) for p, t in zip(prompts, toks)]
    for name, r in faulted.items():
        rows_equal = sum(a == b for a, b in zip(r["tokens"], base["tokens"]))
        f_rec[name] = {"rows_equal_unfaulted": rows_equal, "restarts": r["restarts"],
                       "status": r["status"], "steps": r["steps"]}
        if name == "past_max_request_retries":
            ok = (r["status"][5] == "error" and r["status"].count("finished") == len(prompts) - 1
                  and rows_equal == len(prompts) - 1)
        elif name == "request_prefill_pre":
            ok = rows_equal == len(prompts) and r["status"] == ["finished"] * len(prompts)
        else:
            # the restart re-admits every request through a prefill over its
            # prompt and generated tokens (A over the whole sequence), where
            # the unfaulted run had decoded them one at a time (B): in bf16 a
            # row may part at a near-tie, and only there
            div = _divergences(engine, prompts, full(r["tokens"]), full(base["tokens"]))
            f_rec[name]["rows_parting_at_near_ties"] = sum(d["near_tie"] for d in div)
            f_rec[name]["divergences"] = div
            ok = (r["restarts"] == 1 and r["status"] == ["finished"] * len(prompts)
                  and all(d["near_tie"] for d in div))
        if not ok:
            failures.append(f"{name}: {f_rec[name]}")

    # generate_batch and the serving thread with every prompt at once (the
    # same work), alternated: gb, loop, loop, gb
    gb_walls, burst_walls = [], []
    for first in (True, False):
        if first:
            wall, want = timed_generate_batch()
            gb_walls.append(wall)
        wall, burst_rows = _async_burst(engine, prompts)
        burst_walls.append(wall)
        if not first:
            gb_walls.append(timed_generate_batch()[0])
    gb_actions = dict(engine._last_serve_actions)
    gb_wall, burst_wall = statistics.median(gb_walls), statistics.median(burst_walls)
    burst_div = _divergences(engine, prompts, burst_rows, want)
    failures += [f"burst row {d['row']} parts from generate_batch at generated token "
                 f"{d['index']}, not a near-tie" for d in burst_div if not d["near_tie"]]
    # the serving thread: the main path's run, launches counted around it
    fa.launches = pda.launches = 0
    threaded, rows = _async_threaded(engine, prompts, seed, failures)
    launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
    rule = serve_launch_rule(cfg, threaded["actions"])
    if launches != rule or (ASYNC_DEVICE is None and not all(launches.values())):
        failures.append(f"launches {launches} != {cfg.n_layer} x prefills, x decode steps "
                        f"{threaded['actions']}")
    state["serve_async_launches"] = launches
    div = _divergences(engine, prompts, rows, want)
    failures += [f"threaded row {d['row']} parts from generate_batch at generated token "
                 f"{d['index']}, not a near-tie" for d in div if not d["near_tie"]]
    for p, o in zip(prompts, rows):
        o = np.asarray(o)
        check(o.shape == (p.size + SERVE_MAX_NEW,) and np.array_equal(o[:p.size], p)
              and ((o >= 0) & (o < cfg.vocab_size)).all(), f"threaded row of shape {o.shape}")
    del engine
    _free()
    knob = _async_knob(model, params, prompts[8], failures)
    del params, model
    _free()
    emit("serve_async", model="llama-2-7b", layers=cfg.n_layer, dtype=ASYNC_DTYPE,
         requests=len(prompts), max_new_tokens=SERVE_MAX_NEW,
         generate_batch={"wall_s": gb_wall, "wall_s_runs": gb_walls,
                         "tokens_per_s": generated / gb_wall, "actions": gb_actions},
         threaded={**threaded, "tokens_per_s": generated / threaded["wall_s"],
                   "rows_parting_at_near_ties": len(div), "divergences": div},
         burst={"wall_s": burst_wall, "wall_s_runs": burst_walls,
                "tokens_per_s": generated / burst_wall,
                "tokens_per_s_ratio": gb_wall / burst_wall,
                "rows_parting_at_near_ties": len(burst_div), "divergences": burst_div},
         tokens_per_s_ratio=gb_wall / threaded["wall_s"],
         replay={"steps": base["steps"], "actions": len(base["actions"]),
                 "identical": runs[0]["actions"] == runs[1]["actions"]
                 and runs[0]["tokens"] == runs[1]["tokens"],
                 "loop_host_ms_a_step": [r["loop_host_ms_a_step"] for r in runs]},
         faults=f_rec, knob=knob, launches=launches, launch_rule=rule,
         peak_mem_gb=acc.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    check(not failures, "serve_async failed: " + "; ".join(failures))


# serve_tier / serve_fleet: the tiered KV cache and the replica router
TIER_BLOCKS = 48          # serve_tier's device pool: the filler wave reclaims all of turn 1
TIER_HOST_BLOCKS = 128    # serving.kv_host.max_host_blocks of both phases (8.6 GB at 7B)
TIER_FILLER = (16, 512)   # the filler wave: 16 distinct prompts of 512 tokens
TIER_FILLER_NEW = 2
TIER_SUFFIX = 64          # turn 2: turn 1's rows and 64 new tokens
TIER_XFER_BLOCKS = 8      # blocks timed through the pool's spill and fetch
TIER_DEVICE_HIT_BLOCKS = 256   # the device-hit reference's pool: both turns and the filler fit


def _chain_keys(alloc, tokens):
    """The content addresses of ``tokens``' full blocks."""
    keys, parent, bs = [], b"", alloc.block_size
    for j in range(len(tokens) // bs):
        parent = alloc.chain_key(parent, tokens[j * bs:(j + 1) * bs])
        keys.append(parent)
    return keys


def _bits_equal(a, b):
    import torch
    return bool(torch.equal(a.contiguous().view(torch.int16), b.contiguous().view(torch.int16)))


def _tier_turns(engine, prompts, filler, seed, record=None):
    """turn 1 (the serve prompts), the filler wave, turn 2 (turn 1's rows and
    TIER_SUFFIX new tokens, each row's own) through ``generate_batch``.
    ``record(name, fn)`` wraps each call (the tiered run times and counts
    them). Returns (turn-1 rows, turn-2 prompts, turn-2 rows, actions)."""
    import numpy as np
    rng = np.random.default_rng(seed + 21)
    record = record or (lambda name, fn: fn())
    actions = {}

    def serve(name, batch, max_new):
        rows = record(name, lambda: engine.generate_batch(batch, max_new_tokens=max_new))
        for k, v in engine._last_serve_actions.items():
            actions[k] = actions.get(k, 0) + v
        return rows

    rows1 = serve("turn1", prompts, SERVE_MAX_NEW)
    serve("filler", filler, TIER_FILLER_NEW)
    vocab = engine.module.config.vocab_size
    turn2 = [np.concatenate([r, rng.integers(0, vocab, size=TIER_SUFFIX)]).astype(np.int32)
             for r in rows1]
    rows2 = serve("turn2", turn2, SERVE_MAX_NEW)
    return rows1, turn2, rows2, actions


def _ttft(reg):
    h = reg.snapshot()["histograms"]["serving/ttft_ms"]
    return {q: h[q] for q in ("p50", "p99", "count")}


def _phase_ms(reg):
    """The registry's ``serving/phase_ms`` by phase: count, sum and p50."""
    import re
    out = {}
    for name, h in reg.snapshot()["histograms"].items():
        m = re.match(r'serving/phase_ms\{phase="([a-z_]+)"', name)
        if m:
            out[m.group(1)] = {q: h[q] for q in ("count", "sum", "p50")}
    return out


def _tier_engine(model, params, blocks, tier=True):
    import deepspeed_tpu_torch
    serving = {"max_num_blocks": blocks}
    if tier:
        serving["kv_host"] = {"enabled": True, "max_host_blocks": TIER_HOST_BLOCKS}
    return deepspeed_tpu_torch.init_inference(model, params=params, dtype=ASYNC_DTYPE,
                                              device=ASYNC_DEVICE, serving=serving,
                                              telemetry={"events": True})


def _xfer_rates(engine, n):
    """Spill and fetch of ``n`` of the engine's pool blocks through a pool of
    their own (the engine's tier untouched): gather and put, drained to host
    RAM; then get, the H2D copy and the scatter into the dummy block (which
    nothing reads). Wall time, device synced around each. Returns ms a block
    and GB/s each way, and whether every fetched block is bit-equal."""
    from deepspeed_tpu_torch.inference.engine import host_to_device
    from deepspeed_tpu_torch.inference.kv_host_pool import KvHostPool
    sess_pools = engine._paged_workspace[2]
    cfg = engine.module.config
    bs = int(engine.config.serving.block_size)
    hp = KvHostPool(n, (cfg.n_layer, bs, cfg.kv_heads, cfg.head_dim), engine.dtype)
    blocks = list(range(1, n + 1))
    nbytes = 2 * sess_pools["k"][:, 1].numel() * sess_pools["k"].element_size()
    _sync()
    t0 = time.perf_counter()
    for b in blocks:
        hp.put(bytes([b]), sess_pools["k"][:, b].clone(), sess_pools["v"][:, b].clone())
    hp.drain()
    _sync()
    spill_s = time.perf_counter() - t0
    equal = True
    t0 = time.perf_counter()
    for b in blocks:
        k, v = hp.get(bytes([b]))
        for pool, t in ((sess_pools["k"], k), (sess_pools["v"], v)):
            pool[:, 0].copy_(host_to_device(t, engine.device))
        equal = equal and _bits_equal(sess_pools["k"][:, 0], sess_pools["k"][:, b]) \
            and _bits_equal(sess_pools["v"][:, 0], sess_pools["v"][:, b])
    _sync()
    fetch_s = time.perf_counter() - t0
    return {"blocks": n, "block_mb": nbytes / 1e6,
            "spill_ms_a_block": spill_s * 1e3 / n, "spill_gb_s": nbytes * n / spill_s / 1e9,
            "fetch_ms_a_block": fetch_s * 1e3 / n, "fetch_gb_s": nbytes * n / fetch_s / 1e9,
            "fetched_bit_equal": equal}


def phase_serve_tier(state, seed):
    """Llama-2-7B (SERVE_LOOP_LAYERS layers) with the tiered KV cache (``serving.kv_host``,
    max_host_blocks TIER_HOST_BLOCKS) on a device pool of TIER_BLOCKS
    blocks: turn 1 (the serve prompts, 32 new tokens), a filler wave of
    distinct prompts that reclaims every block of turn 1 (demoted to host
    RAM), then turn 2 (each turn-1 row and 64 new tokens): every fetched
    block's k and v bit-equal to what was spilled (limit 0), turn 2's
    prefill tokens its prompt tokens less kv_fetch_tokens (every cached
    token fetched, no device hit), A = L x prefills and B = L x decode
    steps over the run, turn 2's rows against the same trace with the tier
    off (recompute) and with a device pool large enough to hit on the
    device, each by the near-tie rule; then the filler again and turn 2
    under a persistent kv_host_pool/fetch fault (recompute, the loop
    finishes, kv_host_errors counted); the pool drained with no live block
    and no tier inconsistency. Reports spill and fetch GB/s and ms a block,
    turn 2's TTFT with the tier and recomputing, host RSS and device
    peak."""
    import errno
    import numpy as np
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.monitor.metrics import get_registry
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda
    from deepspeed_tpu_torch.utils import fault_injection as fi

    t_phase = time.perf_counter()
    failures = []
    acc = get_accelerator("cuda" if ASYNC_DEVICE is None else ASYNC_DEVICE)
    acc.reset_peak_memory_stats()
    model, params = _llama7b_cut(seed, SERVE_LOOP_LAYERS)
    cfg = model.config
    prompts = _serve_prompts(cfg, seed)
    rng = np.random.default_rng(seed + 20)
    filler = [rng.integers(0, cfg.vocab_size, size=TIER_FILLER[1]).astype(np.int32)
              for _ in range(TIER_FILLER[0])]
    rss0 = host_rss_gb()

    # the tiered run: the main path, launches counted around it
    _reset_telemetry()
    engine = _tier_engine(model, params, TIER_BLOCKS)
    engine.generate_batch([p[:64] for p in prompts[:2]], max_new_tokens=2)    # warm-up
    _cold(engine)
    hp = engine.ensure_host_kv_pool()
    hp.clear()
    spilled, watched, marks = {}, set(), {}
    real_put = hp.put

    def put(key, k, v):
        ok = real_put(key, k, v)
        if ok and key in watched:
            spilled[key] = (k.clone(), v.clone())
        return ok

    hp.put = put
    reg = get_registry()

    def record(name, fn):
        if name == "turn2":
            # the filler wave must have reclaimed every block of turn 1
            marks["turn1_on_device"] = sum(k in engine._paged_alloc._table for k in watched)
            marks["c0"] = dict(reg.snapshot()["counters"])
            _reset_telemetry()                 # turn 2's TTFT and events alone
        _sync()
        t = time.perf_counter()
        out = fn()
        _sync()
        marks[name + "_s"] = time.perf_counter() - t
        if name == "turn1":
            for r in out:                      # turn 1's full blocks: the keys to watch
                watched.update(_chain_keys(engine._paged_alloc, np.asarray(r)[:-1]))
        return out

    fa.launches = pda.launches = 0
    with sampled_host_peak() as host_peak:
        rows1, turn2, rows2, actions = _tier_turns(engine, prompts, filler, seed, record)
    launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
    rule = serve_launch_rule(cfg, actions)
    if launches != rule or (ASYNC_DEVICE is None and not all(launches.values())):
        failures.append(f"launches {launches} != {cfg.n_layer} x prefills, x decode steps "
                        f"{actions}")
    state["serve_tier_launches"] = launches
    c2 = reg.snapshot()["counters"]
    ttft_tier, phases_tier = _ttft(reg), _phase_ms(reg)
    from deepspeed_tpu_torch.monitor import get_flight_recorder
    ev2 = get_flight_recorder().snapshot()
    prefill_tokens = sum(e.data.get("tokens", 0) for e in ev2
                         if e.kind in ("req.prefill", "req.prefill_chunk"))
    turn2_tokens = sum(int(p.size) for p in turn2)
    fetch_tokens = int(c2.get("serving/kv_fetch_tokens", 0))
    hit_tokens = int(c2.get("serving/prefix_cache_hit_tokens", 0))
    # every cached token came through the tier: fetched, or (the two prompts
    # that share a prefix) a device hit on a block the other one fetched
    # earlier in this turn
    if (marks["turn1_on_device"] or prefill_tokens != turn2_tokens - hit_tokens
            or fetch_tokens == 0 or not 0 <= hit_tokens - fetch_tokens <= SHARED_PREFIX_TOKENS
            or c2.get("serving/preemptions", 0)):
        failures.append(f"turn 2 prefilled {prefill_tokens} of {turn2_tokens} prompt tokens "
                        f"with {fetch_tokens} fetched, {hit_tokens} cached, "
                        f"{marks['turn1_on_device']} turn-1 blocks left on the device, "
                        f"{c2.get('serving/preemptions', 0)} preemptions")
    # every watched block now on the device or back in host RAM holds the
    # bits it was spilled with
    alloc = engine._paged_alloc
    pools = engine._paged_workspace[2]
    checked = unequal = 0
    for key, (k, v) in spilled.items():
        b = alloc._table.get(key)
        if b is not None:
            got = (pools["k"][:, b], pools["v"][:, b])
        elif hp.contains(key):
            hp.drain()
            ent = hp._entries[key]
            got = (ent.k, ent.v)
        else:
            continue
        checked += 1
        unequal += not (_bits_equal(got[0].to(k.device), k) and _bits_equal(got[1].to(v.device), v))
    fetched_blocks = int(c2.get("serving/kv_fetch_hits", 0))
    if unequal or checked == 0 or len(spilled) != len(watched):
        failures.append(f"{unequal} of {checked} fetched or re-spilled blocks differ from "
                        f"their spill ({len(spilled)} of {len(watched)} turn-1 blocks spilled)")
    spills = int(marks["c0"].get("serving/kv_spills", 0) + c2.get("serving/kv_spills", 0))

    # turn 2 again under a persistent fetch fault: recompute, the loop finishes
    engine.generate_batch(filler, max_new_tokens=TIER_FILLER_NEW)
    reg.reset()
    with fi.inject(fi.FaultInjector().fail_writes(errno.EIO, path_substr="kv_host_pool/fetch",
                                                  count=-1)):
        faulted = engine.generate_batch(turn2, max_new_tokens=SERVE_MAX_NEW)
    cf = reg.snapshot()["counters"]
    fault_div = _divergences(engine, turn2, faulted, rows2)
    if (cf.get("serving/kv_host_errors", 0) == 0 or cf.get("serving/kv_fetch_hits", 0)
            or not all(d["near_tie"] for d in fault_div)):
        failures.append(f"fetch fault: {cf.get('serving/kv_host_errors', 0)} errors, "
                        f"{cf.get('serving/kv_fetch_hits', 0)} fetches, rows {fault_div}")
    leaks, problems = alloc.leak_report(), alloc.host_consistency()
    if leaks or problems or alloc.num_free != alloc.capacity:
        failures.append(f"after the drain: live blocks {leaks}, tier {problems}, "
                        f"{alloc.num_free} of {alloc.capacity} blocks allocatable")
    xfer = _xfer_rates(engine, TIER_XFER_BLOCKS)
    if not xfer["fetched_bit_equal"]:
        failures.append("a block timed through the pool came back with other bits")
    host_blocks, host_gb = hp.num_blocks, hp.nbytes / 1e9
    del hp.put                            # the wrapper's cycle (hp -> put -> hp) goes
    del engine, hp, spilled, pools, alloc
    _free()

    # the references: the tier off (turn 2 recomputes), and a device pool that
    # holds both turns (turn 2 hits on the device)
    refs = {}
    for name, blocks, tier in (("recompute", TIER_BLOCKS, False),
                               ("device_hit", TIER_DEVICE_HIT_BLOCKS, False)):
        _reset_telemetry()
        ref = _tier_engine(model, params, blocks, tier=tier)
        ref.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
        ref.generate_batch(filler, max_new_tokens=TIER_FILLER_NEW)
        get_registry().reset()
        _sync()
        t = time.perf_counter()
        got = ref.generate_batch(turn2, max_new_tokens=SERVE_MAX_NEW)
        _sync()
        div = _divergences(ref, turn2, rows2, got)
        cr = get_registry().snapshot()["counters"]
        refs[name] = {"turn2_s": time.perf_counter() - t, "ttft_ms": _ttft(get_registry()),
                      "phase_ms": _phase_ms(get_registry()),
                      "prefix_cache_hit_tokens": cr.get("serving/prefix_cache_hit_tokens", 0),
                      "rows_parting_at_near_ties": len(div), "divergences": div}
        failures += [f"turn 2 row {d['row']} parts from the {name} run at generated token "
                     f"{d['index']}, not a near-tie" for d in div if not d["near_tie"]]
        del ref
        _free()
    if refs["device_hit"]["prefix_cache_hit_tokens"] == 0:
        failures.append("the device-hit reference hit nothing on the device")
    for p, o in zip(turn2, rows2):
        o = np.asarray(o)
        check(o.shape == (p.size + SERVE_MAX_NEW,) and np.array_equal(o[:p.size], p)
              and ((o >= 0) & (o < cfg.vocab_size)).all(), f"turn-2 row of shape {o.shape}")
    del params, model
    _free()
    emit("serve_tier", model="llama-2-7b", layers=cfg.n_layer, dtype=ASYNC_DTYPE,
         device_blocks=TIER_BLOCKS, max_host_blocks=TIER_HOST_BLOCKS,
         filler=list(TIER_FILLER), requests=len(prompts), max_new_tokens=SERVE_MAX_NEW,
         turn_s={k[:-2]: v for k, v in marks.items() if k.endswith("_s")},
         spills=spills, fetched_blocks=fetched_blocks, turn2_fetch_tokens=fetch_tokens,
         turn2_cached_tokens=hit_tokens,
         turn2_prompt_tokens=turn2_tokens, turn2_prefill_tokens=prefill_tokens,
         blocks_checked_bit_equal=checked, blocks_unequal=unequal,
         ttft_ms={"tier": ttft_tier, "recompute": refs["recompute"]["ttft_ms"],
                  "device_hit": refs["device_hit"]["ttft_ms"]},
         turn2_phase_ms=phases_tier, references=refs, fetch_fault={"kv_host_errors": cf.get("serving/kv_host_errors", 0),
                                       "rows_parting_at_near_ties": len(fault_div)},
         transfer=xfer, host_pool_blocks=host_blocks, host_pool_gb=host_gb,
         host_rss_gb={"start": rss0, "peak": host_peak[0]}, launches=launches,
         launch_rule=rule, peak_mem_gb=acc.max_memory_allocated() / 1e9,
         phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    check(not failures, "serve_tier failed: " + "; ".join(failures))


FLEET_SESSIONS = ("alice", None, "bob", "carol", None, "alice", "dave", None, "bob", "erin",
                  None, "carol")


def _fleet_engines(model, params, **serving):
    """Two replicas of the serve cell's engine on the one card: one weight
    tree, one host KV tier."""
    import deepspeed_tpu_torch
    cfg = {"kv_host": {"enabled": True, "max_host_blocks": TIER_HOST_BLOCKS}, **serving}
    e0 = deepspeed_tpu_torch.init_inference(model, params=params, dtype=ASYNC_DTYPE,
                                            device=ASYNC_DEVICE, serving=cfg,
                                            telemetry={"events": True})
    e1 = deepspeed_tpu_torch.init_inference(model, params=e0.params, dtype=ASYNC_DTYPE,
                                            device=ASYNC_DEVICE, serving=cfg,
                                            telemetry={"events": True})
    e1.adopt_host_kv_pool(e0.ensure_host_kv_pool())
    return [e0, e1]


def _fleet_router(engines, start=False, **kw):
    from deepspeed_tpu_torch.inference import AsyncServingEngine
    from deepspeed_tpu_torch.inference.router import ReplicaRouter
    for e in engines:
        _cold(e)
    engines[0].ensure_host_kv_pool().clear()       # no host hits from an earlier run
    return ReplicaRouter([AsyncServingEngine(e, max_new_tokens=SERVE_MAX_NEW, start=start)
                          for e in engines], **kw)


def _fleet_drive(router):
    n = 0
    while router.step():
        n += 1
        check(n < 20000, "the router did not converge")


def _fleet_replay(engines, prompts):
    """The seeded trace with session keys through the router, driven by
    ``step()``: decisions and rows."""
    r = _fleet_router(engines)
    hs = [r.add_request(p, session=s) for p, s in zip(prompts, FLEET_SESSIONS)]
    _fleet_drive(r)
    r.shutdown()
    return list(r.decisions), [h.result(1) for h in hs]


def _fleet_threaded(engines, prompts, mode):
    """Every prompt submitted at once to the fleet (``"fleet"``: the router
    over two threaded loops), to the fleet stepped from this one thread
    (``"fleet_sync"``: ``router.step()``, the replicas' steps interleaved
    without threads), or to one threaded loop on the first engine
    (``"one"``). Returns (wall seconds, rows, actions summed over the
    engines that served)."""
    from deepspeed_tpu_torch.inference import AsyncServingEngine
    for e in engines:
        _cold(e)
        e._last_serve_actions = {}
    _sync()
    t0 = time.perf_counter()
    if mode != "one":
        r = _fleet_router(engines, start=mode == "fleet")
        hs = [r.add_request(p) for p in prompts]
        if mode == "fleet_sync":
            _fleet_drive(r)
        rows = [h.result(timeout=ASYNC_RESULT_S) for h in hs]
        r.shutdown(timeout=ASYNC_RESULT_S)
    else:
        with AsyncServingEngine(engines[0], max_new_tokens=SERVE_MAX_NEW) as one:
            rows = [h.result(timeout=ASYNC_RESULT_S)
                    for h in [one.add_request(p) for p in prompts]]
    _sync()
    wall = time.perf_counter() - t0
    actions = {}
    for e in engines:
        for k, v in e._last_serve_actions.items():
            actions[k] = actions.get(k, 0) + v
    return wall, rows, actions


def phase_serve_fleet(state, seed):
    """Two replicas of Llama-2-7B (SERVE_LOOP_LAYERS layers) on the one card behind the replica
    router: one weight tree (equal data_ptrs) and one host KV tier, the
    device peak under the weights, two pools and 2 GB. The seeded trace with
    session keys driven by ``step()`` twice gives equal decisions (limit 0)
    and rows matching one engine's generate_batch by the near-tie rule.
    Roles prefill,decode: a handoff through the pool for every prompt of at
    least one block (router/handoffs), the decode replica launching A only
    for the prompts under a block (its tails are chunk prefills, which run
    no kernel), rows by the near-tie rule. A persistent engine-fatal decode
    fault pinned to r0, stepped alone until its breaker opens: every request
    completes on r1 matching a clean decode by the near-tie rule, r0's
    /healthz reads 503 and the router's 200. Reports the fleet's tokens/s
    against one loop on the same prompts, threaded, and against the fleet
    stepped from one thread (the threaded fleet is the main path's run,
    launches counted around it), and peak memory."""
    import http.client
    import threading
    import numpy as np
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference import serve
    from deepspeed_tpu_torch.monitor.metrics import get_registry
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda
    from deepspeed_tpu_torch.utils import fault_injection as fi

    t_phase = time.perf_counter()
    failures = []
    acc = get_accelerator("cuda" if ASYNC_DEVICE is None else ASYNC_DEVICE)
    acc.reset_peak_memory_stats()
    model, params = _llama7b_cut(seed, SERVE_LOOP_LAYERS)
    cfg = model.config
    prompts = _serve_prompts(cfg, seed)
    weights_gb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
    _reset_telemetry()
    engines = _fleet_engines(model, params)
    e0, e1 = engines
    shared = all(a.data_ptr() == b.data_ptr()
                 for a, b in zip(e0.params.parameters(), e1.params.parameters()))
    want = e0.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)       # the reference
    pool_gb = sum(t.numel() * t.element_size() for t in e0._paged_workspace[2].values()) / 1e9
    e1.generate_batch([p[:64] for p in prompts[:2]], max_new_tokens=2)     # both pools built
    judged = {}
    peaks = {"setup": acc.max_memory_allocated() / 1e9}   # the running peak after each part

    def near_ties(name, rows):
        div = _divergences(e0, prompts, rows, want, judged)
        failures.extend(f"{name} row {d['row']} parts from generate_batch at generated token "
                        f"{d['index']}, not a near-tie" for d in div if not d["near_tie"])
        return div

    # replay determinism
    runs = [_fleet_replay(engines, prompts) for _ in range(2)]
    if runs[0][0] != runs[1][0]:
        failures.append("two replays of the session trace routed differently")
    replay_div = near_ties("replay", runs[0][1])
    reasons = sorted({d["reason"] for d in runs[0][0]})
    peaks["replay"] = acc.max_memory_allocated() / 1e9

    # prefill -> decode handoff through the shared pool
    get_registry().reset()
    r = _fleet_router(engines, roles=["prefill", "decode"])
    per_rep = [{"flash_attention_fwd": 0, "paged_decode_attention": 0} for _ in engines]
    for i, loop in enumerate(r.replicas):
        real_step = loop.step

        def step(real_step=real_step, i=i):
            a0, b0 = fa.launches, pda.launches
            try:
                return real_step()
            finally:
                per_rep[i]["flash_attention_fwd"] += fa.launches - a0
                per_rep[i]["paged_decode_attention"] += pda.launches - b0
        loop.step = step
    hs = [r.add_request(p) for p in prompts]
    _fleet_drive(r)
    r.shutdown()
    for loop in r.replicas:
        del loop.step                      # the wrapper's cycle holds the engine
    handoff_rows = [h.result(1) for h in hs]
    bs = int(e0.config.serving.block_size)
    n_long = sum(p.size >= bs for p in prompts)
    handoffs = get_registry().snapshot()["counters"].get("router/handoffs", 0)
    decode_a = per_rep[1]["flash_attention_fwd"]
    want_a = cfg.n_layer * (len(prompts) - n_long)
    if handoffs != n_long or (ASYNC_DEVICE is None and decode_a != want_a):
        failures.append(f"{handoffs} handoffs for {n_long} prompts of a block or more; the "
                        f"decode replica launched A {decode_a} times, want {want_a}")
    handoff_div = near_ties("handoff", handoff_rows)
    peaks["handoff"] = acc.max_memory_allocated() / 1e9

    # a persistent decode fault pinned to r0: the breaker drain
    fault_cfg = e0.config.serving.fault
    for e in engines:
        e._config.serving.fault = type(fault_cfg)(max_engine_restarts=1, restart_backoff_s=0.0)
    r = _fleet_router(engines)
    servers = [serve.build_http_server(x, port=0) for x in (r, r.replicas[0])]
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        hs = [r.add_request(p) for p in prompts]
        with fi.inject(fi.FaultInjector().fail_step("decode", count=-1, phase="post")):
            n = 0
            while not r.replicas[0]._crash_loop and n < 300:
                r.replicas[0].step()
                n += 1
        _fleet_drive(r)

        def healthz(s):
            conn = http.client.HTTPConnection("127.0.0.1", s.server_address[1], timeout=60)
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                resp.read()
                return resp.status
            finally:
                conn.close()
        codes = [healthz(s) for s in servers]
    finally:
        for s in servers:
            s.shutdown()
        for t in threads:
            t.join(60)
    drain_rows = [h.result(1) if h.status == "finished" else np.asarray([], np.int32)
                  for h in hs]
    status = [h.status for h in hs]
    failovers = sum(d["reason"] == "failover" for d in r.decisions)
    r.shutdown()
    if not r.replicas[0]._crash_loop or codes != [200, 503] or status != ["finished"] * 12 \
            or not failovers:
        failures.append(f"drain: breaker {r.replicas[0]._crash_loop}, /healthz router and r0 "
                        f"{codes}, statuses {status}, {failovers} failovers")
    drain_div = near_ties("drain", drain_rows)
    peaks["drain"] = acc.max_memory_allocated() / 1e9
    for e in engines:
        e._config.serving.fault = fault_cfg

    # throughput: one loop, the fleet, the fleet from one thread, and back;
    # launches counted around the threaded fleet's runs (the main path)
    walls = {"one": [], "fleet": [], "fleet_sync": []}
    fa.launches = pda.launches = 0
    fleet_actions = {}
    for name in ("one", "fleet", "fleet_sync", "fleet_sync", "fleet", "one"):
        a0, b0 = fa.launches, pda.launches
        wall, rows, actions = _fleet_threaded(engines, prompts, name)
        walls[name].append(wall)
        if name == "fleet":
            for k, v in actions.items():
                fleet_actions[k] = fleet_actions.get(k, 0) + v
            fleet_rows = rows
        else:
            fa.launches, pda.launches = a0, b0      # the other runs are not the main path
    launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches}
    rule = serve_launch_rule(cfg, fleet_actions)
    if launches != rule or (ASYNC_DEVICE is None and not all(launches.values())):
        failures.append(f"launches {launches} != {cfg.n_layer} x prefills, x decode steps "
                        f"{fleet_actions}")
    state["serve_fleet_launches"] = launches
    fleet_div = near_ties("threaded fleet", fleet_rows)
    peak = acc.max_memory_allocated() / 1e9
    if not shared or peak > weights_gb + 2 * pool_gb + 2.0:
        failures.append(f"weights shared {shared}; device peak {peak:.2f} GB over weights "
                        f"{weights_gb:.2f} + 2 x pool {pool_gb:.2f} + 2 GB")
    for p, o in zip(prompts, fleet_rows):
        o = np.asarray(o)
        check(o.shape == (p.size + SERVE_MAX_NEW,) and np.array_equal(o[:p.size], p)
              and ((o >= 0) & (o < cfg.vocab_size)).all(), f"fleet row of shape {o.shape}")
    generated = len(prompts) * SERVE_MAX_NEW
    one_s, fleet_s = statistics.median(walls["one"]), statistics.median(walls["fleet"])
    sync_s = statistics.median(walls["fleet_sync"])
    del engines, e0, e1, r
    _free()
    del params, model
    _free()
    emit("serve_fleet", model="llama-2-7b", layers=cfg.n_layer, dtype=ASYNC_DTYPE, replicas=2,
         requests=len(prompts), max_new_tokens=SERVE_MAX_NEW, weights_shared=shared,
         weights_gb=weights_gb, pool_gb=pool_gb,
         replay={"identical": runs[0][0] == runs[1][0], "decisions": len(runs[0][0]),
                 "reasons": reasons, "rows_parting_at_near_ties": len(replay_div)},
         handoff={"handoffs": handoffs, "prompts_of_a_block": int(n_long),
                  "launches_by_replica": per_rep, "rows_parting_at_near_ties": len(handoff_div)},
         drain={"healthz_router_r0": codes, "failovers": failovers,
                "rows_parting_at_near_ties": len(drain_div)},
         throughput={"one_loop_s": walls["one"], "fleet_s": walls["fleet"],
                     "fleet_one_thread_s": walls["fleet_sync"],
                     "one_loop_tokens_per_s": generated / one_s,
                     "fleet_tokens_per_s": generated / fleet_s,
                     "fleet_one_thread_tokens_per_s": generated / sync_s,
                     "fleet_over_one": one_s / fleet_s,
                     "rows_parting_at_near_ties": len(fleet_div)},
         launches=launches, launch_rule=rule, peak_mem_gb=peak, peak_mem_gb_after=peaks,
         phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    check(not failures, "serve_fleet failed: " + "; ".join(failures))


# EleutherAI/gpt-j-6b's published config.json: the fields GPTJPolicy reads
GPTJ_6B_CONFIG = {"architectures": ["GPTJForCausalLM"], "model_type": "gptj",
                  "vocab_size": 50400, "n_positions": 2048, "n_embd": 4096, "n_layer": 28,
                  "n_head": 16, "rotary_dim": 64, "n_inner": None,
                  "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5,
                  "tie_word_embeddings": False, "bos_token_id": 50256, "eos_token_id": 50256}
GPTJ_SERVE_LAYERS = 14       # serve_gptj: GPT-J-6B cut 28 -> 14 layers (the run's clock)
GPTJ_STATIC_PROMPT = 32      # static generate: every serve prompt's first 32 tokens, one batch
GPTJ_LOGIT_ROWS = (0, 5, 10)  # serve prompts held teacher-forced (32, 256 and 512 tokens)


def _gptj6b(seed):
    """GPT-J-6B at full width, GPTJ_SERVE_LAYERS deep (GPTJPolicy over the
    published config.json; no file is read) with seeded bf16 weights drawn
    on the card, the head's bias too (so it is seen)."""
    import torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject.policies import GPTJPolicy
    model = CausalLM(GPTJPolicy().zoo_config({**GPTJ_6B_CONFIG, "n_layer": GPTJ_SERVE_LAYERS}))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda", dtype=torch.bfloat16)
    bias = params["lm_head_bias"]
    bias.data.copy_(torch.randn(bias.shape, generator=gen, device="cuda") * 0.1)
    return model, params


def _serve_timed(engine, prompts, max_new):
    """generate_batch from an emptied registry: rows, wall seconds (ends in a
    sync), generated tokens, the actions and TTFT / TPOT p50 and p99."""
    import numpy as np
    from deepspeed_tpu_torch.monitor import get_registry
    _reset_telemetry()
    t0 = time.perf_counter()
    rows = engine.generate_batch(prompts, max_new_tokens=max_new)
    _sync()
    wall = time.perf_counter() - t0
    h = get_registry().snapshot()["histograms"]
    gen = sum(np.asarray(o).size - p.size for p, o in zip(prompts, rows))
    return rows, {"wall_s": wall, "generated_tokens": int(gen), "tokens_per_s": gen / wall,
                  "actions": dict(engine._last_serve_actions),
                  "ttft_ms": {q: h["serving/ttft_ms"][q] for q in ("p50", "p99", "count")},
                  "tpot_ms": {q: h["serving/tpot_ms"][q] for q in ("p50", "p99", "count")}}


def _allocated_gb():
    """The card's allocated bytes now, GB (None on the CPU)."""
    import torch
    return torch.cuda.memory_allocated() / 1e9 if CHECK_DEVICE == "cuda" else None


def phase_serve_gptj(state, seed):
    """GPT-J-6B at full width, cut to GPTJ_SERVE_LAYERS of its 28 layers
    (16 heads x 256, rotary 64 interleaved, untied head with its bias)
    serving the serve phase's
    prompts through generate_batch (A, then B, at Hd 256) and static
    generate over their first GPTJ_STATIC_PROMPT tokens (the cached path's
    grouped einsum over the prompt, as in the JAX package, then K5), against
    the same weights with attention_backend "xla": rows by the near-tie rule,
    teacher-forced paged logits of three prompts within LOGIT_ULP_TOL of the
    reference with kernel A reading the next kv head planted above it;
    launches A = L x prefills, B = L x decodes and K5 = L x (generated - 1);
    TTFT / TPOT p50, tokens/s, peak memory."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    _reset_peak()
    t0 = time.perf_counter()
    model, params = _gptj6b(seed)
    cfg = model.config
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype=ASYNC_DTYPE,
                                                device=ASYNC_DEVICE, telemetry=True)
    xla = deepspeed_tpu_torch.init_inference(
        CausalLM(dataclasses.replace(cfg, attention_backend="xla")), params=engine.params,
        dtype=ASYNC_DTYPE, device=ASYNC_DEVICE)
    del params
    _sync()
    init_s = time.perf_counter() - t0
    prompts = _serve_prompts(cfg, seed)
    failures = []

    fa.launches = pda.launches = dda.launches = 0
    rows, serve = _serve_timed(engine, prompts, SERVE_MAX_NEW)
    launches = {"flash_attention_fwd_hd256": fa.launches,
                "paged_decode_attention_hd256": pda.launches}
    on_card = int(ASYNC_DEVICE is None)      # the CPU takes the plain versions: no launch
    rule = serve_launch_rule(cfg, serve["actions"])
    if [launches["flash_attention_fwd_hd256"], launches["paged_decode_attention_hd256"]] != \
            [on_card * rule["flash_attention_fwd"], on_card * rule["paged_decode_attention"]]:
        failures.append(f"launches {launches} off the rule {rule}")
    want = xla.generate_batch(prompts, max_new_tokens=SERVE_MAX_NEW)
    for p, o in zip(prompts, rows):
        o = np.asarray(o)
        check(o.shape == (p.size + SERVE_MAX_NEW,) and np.array_equal(o[:p.size], p),
              f"output shape {o.shape} for prompt {p.size}")
    parted = _divergences(xla, prompts, rows, want)
    if any(not d["near_tie"] for d in parted):
        failures.append(f"rows part from the xla engine off a near-tie: {parted}")

    got_l, want_l, fault_l = [], [], []
    for i in GPTJ_LOGIT_ROWS:
        w = np.asarray(want[i])[:-1]
        want_l.append(paged_logits(xla, w, prompts[i].size))
        got_l.append(paged_logits(engine, w, prompts[i].size))
        with planted_attention_fault("flash_kv_head_shifted"):
            fault_l.append(paged_logits(engine, w, prompts[i].size))
    logits, bad = logit_parity(torch.cat(got_l), torch.cat(want_l),
                               {"flash_kv_head_shifted": torch.cat(fault_l)})
    failures += bad

    ids = np.stack([p[:GPTJ_STATIC_PROMPT] for p in prompts])
    dda.launches = fa.launches = 0
    t = time.perf_counter()
    static = engine.generate(ids, max_new_tokens=SERVE_MAX_NEW)
    _sync()
    static_s = time.perf_counter() - t
    launches["dense_decode_attention_hd256"] = dda.launches
    # the prefill of static generate attends through forward_cached's
    # grouped einsum (as the JAX package's cached path does), not A
    if (dda.launches, fa.launches) != (on_card * cfg.n_layer * (SERVE_MAX_NEW - 1), 0):
        failures.append(f"static generate launched K5 {dda.launches}, A {fa.launches}: "
                        f"not {cfg.n_layer} x {SERVE_MAX_NEW - 1} and 0")
    static_want = xla.generate(ids, max_new_tokens=SERVE_MAX_NEW)
    static_parted = []
    for i, (g, w) in enumerate(zip(static, static_want)):
        diff = np.nonzero(g != w)[0]
        if diff.size:
            j = int(diff[0])
            tie = near_tie(cached_logits(xla, w[None, :j], GPTJ_STATIC_PROMPT)[0, -1])
            static_parted.append({"row": i, "index": j - GPTJ_STATIC_PROMPT, "near_tie": tie})
    if any(not d["near_tie"] for d in static_parted):
        failures.append(f"static rows part from the xla engine off a near-tie: {static_parted}")
    if on_card and not all(launches.values()):
        failures.append(f"a kernel of the path never launched: {launches}")
    state["serve_gptj_launches"] = launches
    emit("serve_gptj", model="gpt-j-6b", layers=cfg.n_layer, heads=cfg.n_head,
         head_dim=cfg.head_dim, rotary_dim=cfg.rope_dim, d_model=cfg.d_model,
         vocab=cfg.vocab_size, dtype=ASYNC_DTYPE, init_s=init_s, requests=len(prompts),
         prompt_tokens=[int(p.size) for p in prompts], max_new_tokens=SERVE_MAX_NEW,
         serve=serve, rows_parting=parted, logits=logits,
         static={"batch": list(ids.shape), "wall_s": static_s,
                 "tokens_per_s": ids.shape[0] * SERVE_MAX_NEW / static_s,
                 "rows_parting": static_parted},
         launches=launches, peak_mem_gb=_peak_gb(), card=state.get("card"))
    del engine, xla
    _free()
    check(not failures, "serve_gptj failed: " + "; ".join(failures))


GPTJ_TRAIN_LAYERS = 8          # GPT-J-6B width, depth cut 28 -> 8 (PERF.md section 4)
GPTJ_PARITY_SEQ = 512          # train_gptj's card-vs-CPU check: 1 layer, [2, 512]
# GPT-J-6B's published peak learning rate (mesh-transformer-jax's 6B config:
# lr 1.2e-4, the Adam betas 0.9 / 0.95 and weight decay 0.1 of TRAIN_CONFIG);
# at the train cell's 3e-4 its loss on the repeated batch spikes after step 4
GPTJ_TRAIN_LR = 1.2e-4


def _gptj_train_config():
    """The train phase's configuration at GPT-J-6B's learning rate."""
    opt = TRAIN_CONFIG["optimizer"]
    sched = TRAIN_CONFIG["scheduler"]
    return {**TRAIN_CONFIG,
            "optimizer": {**opt, "params": {**opt["params"], "lr": GPTJ_TRAIN_LR}},
            "scheduler": {**sched, "params": {**sched["params"],
                                              "warmup_max_lr": GPTJ_TRAIN_LR}}}


def _gptj_train_model(n_layer):
    """GPT-J-6B's published widths (GPTJ_6B_CONFIG through GPTJPolicy) at
    ``n_layer`` layers, with the zoo's training defaults (remat on)."""
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject.policies import GPTJPolicy
    return CausalLM(GPTJPolicy().zoo_config({**GPTJ_6B_CONFIG, "n_layer": n_layer}))


def _hd256_keys(launches):
    """A / C / D launch counts under the kernel table's Hd-256 row names."""
    return {(k + "_hd256" if k.startswith("flash_attention") else k): n
            for k, n in launches.items()}


def phase_train_gptj(state, seed):
    """GPT-J-6B at its published widths (16 heads x 256, d 4096, d_ff 16384,
    rotary 64 interleaved, parallel residual, vocab 50400, untied head with
    its bias) on kernels A, C and D at Hd 256, E and K3. First the
    train_parity check at 1 layer on one [2, GPTJ_PARITY_SEQ] batch (each
    leaf's gradient within PARITY_GRAD_TOL of the CPU's, C's and D's
    planted faults above it, the gradient pass's loss within
    PARITY_LOSS_TOL; no step is taken: WarmupLR's first lr is 0); then
    GPTJ_TRAIN_LAYERS layers through initialize + train_batch with the train
    phase's configuration at GPT-J's learning rate (S 2048, micro 4 x gas
    2, remat, bf16, FusedAdam, WarmupLR to GPTJ_TRAIN_LR, clip 1.0, fused
    CE on the card, so the head's bias goes through G's db): 1 warm-up + 5
    timed steps, losses finite and falling,
    per step A = 2 L gas, C = D = L gas, E once a leaf, each K3 kernel gas
    times; step ms, tokens/s, MFU, peak memory."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator

    # no compared step: the CPU's fp32 side of a 50400-word head is most of
    # the phase's time, and the first step's update would be 0
    _train_parity("train_gptj_parity", seed, _gptj_train_model(1), 2, GPTJ_PARITY_SEQ,
                  {f: (lambda f=f: _planted(f), "worst")
                   for f in ("dq_delta_not_subtracted", "dkv_last_q_tile_skipped")}, steps=0)
    acc = get_accelerator(CHECK_DEVICE)
    t0 = time.perf_counter()
    model = _gptj_train_model(GPTJ_TRAIN_LAYERS)
    cfg = model.config
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.bfloat16)
    config = _gptj_train_config()
    engine = _train_engine(model, params, config, device=CHECK_DEVICE)
    del params
    _free()
    rng = np.random.default_rng(seed + 2)
    tokens = rng.integers(0, cfg.vocab_size, size=(config["train_batch_size"], TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(tokens).to(CHECK_DEVICE)}
    _sync()
    init_s = time.perf_counter() - t0
    # per layer: ln_attn 2, wq wk wv wo, ln_mlp 2, the MLP's 4; embedding,
    # ln_f 2, lm_head and its bias
    want = train_launch_rule(engine, leaves_per_layer=12, other_leaves=5)
    acc.reset_peak_memory_stats()
    _reset_train_counters()
    losses, step_s, per_step = _timed_steps(engine, batch, TRAIN_STEPS)
    launches = _train_counters()
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    for k, n in want.items():
        check(all(s[k] == n for s in per_step), f"{k} launches per step {per_step} != {n}")
        check(launches[k] == n * TRAIN_STEPS, f"{k} launches {launches[k]}")
    state["train_gptj_launches"] = _hd256_keys(launches)
    tokens_step = config["train_batch_size"] * TRAIN_SEQ
    step = statistics.median(step_s[1:])
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak = acc.peak_tflops()
    emit("train_gptj", model="gpt-j-6b width", layers=cfg.n_layer, heads=cfg.n_head,
         head_dim=cfg.head_dim, seq=TRAIN_SEQ, dtype="bf16", config=config,
         params=model.num_parameters, losses=losses, step_s=step_s,
         step_ms_median_timed=step * 1e3, tokens_per_step=tokens_step,
         tokens_per_s=tokens_step / step, model_tflops_per_s=flops_tok * tokens_step / step / 1e12,
         mfu=flops_tok * tokens_step / step / (peak * 1e12), peak_tflops=peak,
         flops_per_token=flops_tok, init_s=init_s, peak_mem_gb=acc.max_memory_allocated() / 1e9,
         launches=_hd256_keys(launches), launches_per_step=_hd256_keys(want),
         card=state.get("card"))
    del engine, batch
    _free()


# DeepSpeed-MoE's 350M+MoE-128 (Rajbhandari et al., arXiv:2201.05596, Table 1;
# the reference deepspeed/moe/layer.py defaults): the Megatron GPT-350M
# backbone (d 1024, 24 layers, 16 heads x 64, vocab 50257, learned positions,
# LayerNorm, biases, tied embeddings, S 2048) with 128 GeLU experts of d_ff
# 4096, top-1, capacity factor 1.0 in training and at eval, min capacity 4,
# aux loss 0.01. The zoo puts an MoE MLP in every layer (the published model
# in every other one): PERF.md section 4 gives each phase's cut.
MOE_350M_128 = dict(vocab_size=50257, n_layer=24, n_head=16, d_model=1024, max_seq=2048,
                    pos_embedding="learned", norm="layernorm", activation="gelu",
                    tie_embeddings=True, attn_bias=True)
MOE_128 = dict(num_experts=128, k=1, capacity_factor=1.0, eval_capacity_factor=1.0,
               min_capacity=4, aux_loss_coef=0.01, expert_ff_mult=4)
# the published model's 12 MoE layers (its 12 dense ones dropped), cut to 6
# to keep the default run inside its time limit
MOE_GENERATE_LAYERS = 6
MOE_TRAIN_LAYERS = 2
MOE_BATCH, MOE_PROMPT, MOE_MAX_NEW = 8, 512, 64
MOE_LOGIT_ROWS = (0, 3, 6)     # rows held teacher-forced
# The prefill's share of tokens past their expert's capacity, per layer.
# Seeded random weights collapse the routing with depth: the hidden states
# gain a component common to all tokens layer by layer, and top-1's argmax
# does not change with the gate's scale, so no gate draw undoes it (PERF.md
# section 4). Every layer must keep a tenth of its tokens (a gate sending
# all to one expert reads 1 - C / T = 0.992); layer 0, whose inputs are
# the embeddings, must route near balance (a random gate over isotropic
# inputs drops about 7 % at capacity factor 1: Poisson(32) loads).
MOE_MAX_OVER_CAPACITY = 0.9
MOE_LAYER0_MAX_OVER = 0.25


def _moe350m(n_layer, **over):
    from deepspeed_tpu_torch.models.moe_lm import MoECausalLM, MoEConfig
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    return MoECausalLM(TransformerConfig(**{**MOE_350M_128, "n_layer": n_layer, **over}),
                       MoEConfig(**MOE_128))


@contextlib.contextmanager
def routing_tape(tape, replay=False):
    """Record each top-1 routing decision of the MoE model (the dispatch
    mask ``[T, E, C]`` of every routed MLP call, in call order) into
    ``tape``, or with ``replay`` route by the recorded masks, the combine
    weights still each call's own gate probabilities. Routing is a
    discontinuous function of the hidden state: replaying the reference's
    decisions holds the kernels to the reference where an attention
    difference of an ulp would flip a near-tie gate argmax."""
    import torch
    from deepspeed_tpu_torch.moe import sharded_moe
    real = sharded_moe.top1gating
    recorded = iter(tape)

    def taped(logits, *args, **kw):
        l_aux, combine, dispatch, counts = real(logits, *args, **kw)
        if not replay:
            tape.append(dispatch)
            return l_aux, combine, dispatch, counts
        d = next(recorded)
        check(d.shape == dispatch.shape, f"replayed routing {tuple(d.shape)} for a call of "
                                         f"{tuple(dispatch.shape)}")
        gates = torch.softmax(logits.float(), dim=-1)
        return l_aux, d.float() * gates[:, :, None], d, counts

    sharded_moe.top1gating = taped
    try:
        yield
    finally:
        sharded_moe.top1gating = real


def phase_moe_generate(state, seed):
    """DeepSpeed-MoE 350M+MoE-128 at MOE_GENERATE_LAYERS layers (128
    experts a layer, 12.9 B expert parameters, seeded bf16 weights drawn on
    the card) through init_inference + generate on one [8, 512] batch, 64
    new tokens, greedy: the prompt through forward_cached's grouped einsum
    and the routed experts (capacity 32 a layer at 4096 tokens), each new
    token through K5 (L x (generated - 1) launches, A none); tokens/s,
    prefill ms, ms a decode step, peak memory, each layer's expert counts
    in the prefill and its share of tokens over capacity (bounded by
    MOE_MAX_OVER_CAPACITY, layer 0 by MOE_LAYER0_MAX_OVER). Against the same weights with attention_backend "xla":
    the tokens each routed with its own decisions (the layers' tokens routed
    differently and the rows that part, printed), then the card's generate
    replaying the reference's routing (routing_tape): rows by the near-tie
    rule, teacher-forced logits of MOE_LOGIT_ROWS within LOGIT_ULP_TOL with
    K5 reading the next kv head planted above it."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.moe_lm import MoECausalLM
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    _reset_peak()
    t0 = time.perf_counter()
    model = _moe350m(MOE_GENERATE_LAYERS)
    cfg, L = model.config, model.config.n_layer
    dev = "cuda" if ASYNC_DEVICE is None else ASYNC_DEVICE
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[ASYNC_DTYPE]
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed), device=dev,
                               dtype=dtype)
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype=ASYNC_DTYPE,
                                                device=ASYNC_DEVICE)
    xla = deepspeed_tpu_torch.init_inference(
        MoECausalLM(dataclasses.replace(cfg, attention_backend="xla"), model.moe),
        params=engine.params, dtype=ASYNC_DTYPE, device=ASYNC_DEVICE)
    del params
    _sync()
    init_s = time.perf_counter() - t0
    expert_params = sum(lp["mlp"][k].numel() for lp in engine.params["layers"]
                        for k in ("w_up", "b_up", "w_down", "b_down"))
    ids = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size,
                                                   size=(MOE_BATCH, MOE_PROMPT))
    on_card = int(ASYNC_DEVICE is None)
    failures = []

    model.exp_counts_sink = []
    t = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    _sync()
    prefill_s = time.perf_counter() - t
    counts = torch.stack(model.exp_counts_sink[:L]).cpu()
    model.exp_counts_sink = None
    cap = max(-(-MOE_BATCH * MOE_PROMPT // model.moe.num_experts), model.moe.min_capacity)
    experts = {"capacity": cap,
               "max": counts.max(dim=1).values.tolist(),
               "idle": (counts == 0).sum(dim=1).tolist(),
               "tokens_over_capacity": (counts - cap).clamp(min=0).sum(dim=1).tolist(),
               "layer0": counts[0].tolist()}
    share = [n / (MOE_BATCH * MOE_PROMPT) for n in experts["tokens_over_capacity"]]
    experts["share_over_capacity"] = share
    if not (max(share) <= MOE_MAX_OVER_CAPACITY and share[0] <= MOE_LAYER0_MAX_OVER):
        failures.append(f"tokens over capacity by layer {share}: past {MOE_MAX_OVER_CAPACITY} "
                        f"(layer 0: {MOE_LAYER0_MAX_OVER})")
    dda.launches = fa.launches = 0
    t = time.perf_counter()
    free = engine.generate(ids, max_new_tokens=MOE_MAX_NEW)
    _sync()
    full_s = time.perf_counter() - t
    launches = {"dense_decode_attention": dda.launches, "flash_attention_fwd": fa.launches}
    if (dda.launches, fa.launches) != (on_card * L * (MOE_MAX_NEW - 1), 0):
        failures.append(f"generate launched K5 {dda.launches}, A {fa.launches}: not "
                        f"{L} x {MOE_MAX_NEW - 1} and 0")
    check(free.shape == (MOE_BATCH, MOE_PROMPT + MOE_MAX_NEW) and
          np.array_equal(free[:, :MOE_PROMPT], ids), f"output shape {free.shape}")
    peak = _peak_gb()

    # the reference with its own routing recorded, the card's own routing
    # against it, then the card replaying it
    ref_tape, own_tape = [], []
    with routing_tape(ref_tape):
        want = xla.generate(ids, max_new_tokens=MOE_MAX_NEW)
    with routing_tape(own_tape):
        engine.generate(ids, max_new_tokens=MOE_MAX_NEW)
    rerouted = [int((a != b).any(dim=(1, 2)).sum()) for a, b in zip(own_tape[:L], ref_tape[:L])]
    del own_tape
    with routing_tape(ref_tape, replay=True):
        got = engine.generate(ids, max_new_tokens=MOE_MAX_NEW)
    del ref_tape
    firsts = {}
    for name, rows in (("own_routing", free), ("replayed_routing", got)):
        for i, (g, w) in enumerate(zip(rows, want)):
            diff = np.nonzero(g != w)[0]
            if diff.size:
                firsts.setdefault(name, []).append((i, int(diff[0])))
    parted = {}
    if firsts:
        jmax = max(j for rows in firsts.values() for _, j in rows)
        ref_logits = cached_logits(xla, want[:, :jmax], MOE_PROMPT)
        for name, rows in firsts.items():
            parted[name] = [{"row": i, "index": j - MOE_PROMPT,
                             "near_tie": near_tie(ref_logits[i, j - 1])} for i, j in rows]
        del ref_logits
    if any(not d["near_tie"] for d in parted.get("replayed_routing", [])):
        failures.append(f"rows replaying the reference's routing part off a near-tie: "
                        f"{parted['replayed_routing']}")

    rows3 = want[list(MOE_LOGIT_ROWS), :-1]
    tape = []
    with routing_tape(tape):
        want_l = cached_logits(xla, rows3, MOE_PROMPT)
    with routing_tape(tape, replay=True):
        got_l = cached_logits(engine, rows3, MOE_PROMPT)
    with routing_tape(tape, replay=True), planted_attention_fault("decode_kv_head_shifted"):
        fault_l = cached_logits(engine, rows3, MOE_PROMPT)
    del tape
    V = cfg.vocab_size
    logits, bad = logit_parity(got_l.reshape(-1, V), want_l.reshape(-1, V),
                               {"decode_kv_head_shifted": fault_l.reshape(-1, V)})
    failures += bad
    del got_l, want_l, fault_l
    if on_card and not all(launches[k] for k in ("dense_decode_attention",)):
        failures.append(f"a kernel of the path never launched: {launches}")
    state["moe_generate_launches"] = launches
    generated = MOE_BATCH * MOE_MAX_NEW
    emit("moe_generate", model="deepspeed-moe 350m+moe-128", layers=L, d_model=cfg.d_model,
         heads=cfg.n_head, experts=model.moe.num_experts, expert_params=expert_params,
         params=model.num_parameters, dtype=ASYNC_DTYPE, init_s=init_s,
         batch=[MOE_BATCH, MOE_PROMPT], max_new_tokens=MOE_MAX_NEW,
         prefill_ms=prefill_s * 1e3, decode_ms_per_step=(full_s - prefill_s) / (MOE_MAX_NEW - 1)
         * 1e3, wall_s=full_s, tokens_per_s=generated / full_s, expert_counts=experts,
         tokens_rerouted_in_prefill=rerouted, rows_parting=parted, logits=logits,
         launches=launches, peak_mem_gb=peak, card=state.get("card"))
    del engine, xla
    _free()
    check(not failures, "moe_generate failed: " + "; ".join(failures))


def phase_moe_train(state, seed):
    """DeepSpeed-MoE 350M+MoE-128 at MOE_TRAIN_LAYERS layers (2.2 B
    parameters) through initialize + train_batch with the train phase's
    configuration at micro 2 x gas 2 (S 2048, remat, bf16, FusedAdam,
    WarmupLR, clip 1.0; RTS on): 1 warm-up + 5 timed steps, losses finite
    and falling, per step A = 2 L gas, C = D = L gas and E once a leaf (the
    MoE loss runs over full logits: no K3); step ms, tokens/s, MFU (the
    active parameters a token), peak memory and the aux loss."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator

    acc = get_accelerator(CHECK_DEVICE)
    t0 = time.perf_counter()
    model = _moe350m(MOE_TRAIN_LAYERS)
    cfg = model.config
    config = {**TRAIN_CONFIG, "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2}
    params = model.init_params(torch.Generator(device=CHECK_DEVICE).manual_seed(seed),
                               device=CHECK_DEVICE, dtype=torch.bfloat16)
    engine = _train_engine(model, params, config, device=CHECK_DEVICE)
    del params
    _free()
    tokens = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size,
                                                      size=(config["train_batch_size"], TRAIN_SEQ))
    batch = {"input_ids": torch.from_numpy(tokens).to(CHECK_DEVICE)}
    _sync()
    init_s = time.perf_counter() - t0
    # per layer: ln_attn 2, wq wk wv wo and their biases, ln_mlp 2, gate_w and
    # the experts' 4; the embedding, the positions, ln_f 2 (tied head)
    want = train_launch_rule(engine, leaves_per_layer=17, other_leaves=4, fused_ce=False)
    acc.reset_peak_memory_stats()
    _reset_train_counters()
    losses, step_s, per_step = _timed_steps(engine, batch, TRAIN_STEPS)
    launches = _train_counters()
    check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    for k, n in want.items():
        check(all(s[k] == n for s in per_step), f"{k} launches per step {per_step} != {n}")
        check(launches[k] == n * TRAIN_STEPS, f"{k} launches {launches[k]}")
    peak_gb = acc.max_memory_allocated() / 1e9
    with torch.no_grad():
        micro = {"input_ids": batch["input_ids"][:config["train_micro_batch_size_per_gpu"]]}
        _, aux = model.forward(engine.state.params, micro["input_ids"], train=True)
    state["moe_train_launches"] = launches
    tokens_step = config["train_batch_size"] * TRAIN_SEQ
    step = statistics.median(step_s[1:])
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak = acc.peak_tflops()
    emit("moe_train", model="deepspeed-moe 350m+moe-128", layers=cfg.n_layer,
         experts=model.moe.num_experts, seq=TRAIN_SEQ, dtype="bf16", config=config,
         params=model.num_parameters, losses=losses, aux_loss_after=float(aux),
         aux_loss_coef=model.moe.aux_loss_coef, step_s=step_s,
         step_ms_median_timed=step * 1e3, tokens_per_step=tokens_step,
         tokens_per_s=tokens_step / step, model_tflops_per_s=flops_tok * tokens_step / step / 1e12,
         mfu=flops_tok * tokens_step / step / (peak * 1e12), peak_tflops=peak,
         flops_per_token=flops_tok, init_s=init_s, peak_mem_gb=peak_gb, launches=launches,
         launches_per_step=want, card=state.get("card"))
    del engine, batch
    _free()


INT8_TWIN_ROWS = (0, 10)        # serve prompts held teacher-forced against the twin (32, 512)
INT8_TOP1_ROWS = (0, 3, 5, 10)  # and for the bf16 engine's top-1 agreement
SERVE_INT8_LAYERS = 8           # serve_int8: Llama-2-7B cut 32 -> 8 layers (the run's clock)


@contextlib.contextmanager
def plain_dequant():
    """Inside the ``with`` body every int8 weight dequantizes through the
    kernel's plain twin (the torch expression) on the card: the reference
    run of phase serve_int8, and nowhere else."""
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.kernels import dequant_int8 as dq
    real = quant.dequant_int8
    quant.dequant_int8 = dq.dequant_int8_plain
    try:
        yield
    finally:
        quant.dequant_int8 = real


def _decode_step_ms(engine, prompts):
    """Device ms by kernel class of one fused paged decode step over the
    rows of ``prompts`` (each at its prompt's depth), on a scratch pool."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T
    cfg, dev = engine.module.config, engine.device
    B = len(prompts)
    n_max = max(-(-(p.size + 1) // 128) for p in prompts)
    pools = engine.module.init_paged_cache(B * n_max + 1, 128, dtype=engine.dtype, device=dev)
    table = (torch.arange(B * n_max, dtype=torch.int32, device=dev) + 1).reshape(B, n_max)
    pos = torch.tensor([p.size for p in prompts], dtype=torch.int32, device=dev)
    tok = torch.zeros((B, 1), dtype=torch.long, device=dev)

    def step():
        with torch.no_grad():
            T.forward_paged_decode(cfg, engine.params, tok, pools, table, pos)

    by_class = device_ms_by_class(step, reps=5)
    del pools
    return {"total": sum(by_class.values()), **by_class}


def _fresh_serve(engine, prompts):
    """:func:`_serve_timed` from an empty prefix cache (the pools kept), so
    that every serve of the phase takes the same actions."""
    engine._paged_alloc = None
    return _serve_timed(engine, prompts, SERVE_MAX_NEW)


def phase_serve_int8(state, seed):
    """Llama-2-7B at full width cut to SERVE_INT8_LAYERS layers with dtype
    "int8" (weight-only, q_groups 1): bytes at rest (memory_allocated after init) against the
    bf16 engine's; the serve phase's prompts through generate_batch on A, B
    and the dequant kernel (7 x L + 1 launches a forward), then the same
    int8 params with the dequant's plain twin on the card: rows equal
    (limit 0) and teacher-forced logits within LOGIT_ULP_TOL (0 expected:
    the kernel is bit-equal), kernel A reading the next kv head planted
    above it; a fused decode step's device ms by class, int8 against bf16;
    serves alternated int8, bf16, bf16, int8, each from an empty prefix
    cache: tokens/s, TTFT / TPOT p50 and peak memory; the bf16 engine's
    top-1 agreement with the int8 engine, teacher-forced over the bf16
    engine's tokens (printed, not gated)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import quant
    from deepspeed_tpu_torch.ops.kernels import dequant_int8 as dq
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    failures = []
    _free()
    base = _allocated_gb()
    t0 = time.perf_counter()
    model, params = _llama7b_cut(seed, SERVE_INT8_LAYERS)
    cfg = model.config
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype="int8",
                                                device=ASYNC_DEVICE, telemetry=True)
    del params
    _free()
    init_s = time.perf_counter() - t0
    at_rest = {"int8_allocated_gb": None if base is None else _allocated_gb() - base,
               "int8_tree_gb": quant.tree_nbytes(engine.params) / 1e9}
    wq = engine.params["layers"][0]["attn"]["wq"]
    check(isinstance(wq, quant.Quantized8) and wq.q.dtype == torch.int8
          and wq.scale.dtype == torch.float32, "the int8 engine's weights are not int8")
    prompts = _serve_prompts(cfg, seed)

    _reset_peak()
    fa.launches = pda.launches = dq.launches = 0
    rows, serve = _fresh_serve(engine, prompts)
    launches = {"flash_attention_fwd": fa.launches, "paged_decode_attention": pda.launches,
                "dequant_int8": dq.launches}
    serve["peak_mem_gb"] = _peak_gb()
    acts = serve["actions"]
    rule = {**serve_launch_rule(cfg, acts), "dequant_int8": (7 * cfg.n_layer + 1) * sum(
        acts.get(a, 0) for a in ("prefill", "prefill_chunk", "decode"))}
    if ASYNC_DEVICE is not None:      # the CPU takes the plain versions: nothing launches
        rule = {k: 0 for k in rule}
    if launches != rule:
        failures.append(f"launches {launches} off the rule {rule}")
    for p, o in zip(prompts, rows):
        o = np.asarray(o)
        check(o.shape == (p.size + SERVE_MAX_NEW,) and np.array_equal(o[:p.size], p),
              f"output shape {o.shape} for prompt {p.size}")

    with plain_dequant():
        dq.launches = 0
        twin_rows, twin_serve = _fresh_serve(engine, prompts)
        twin_launches = dq.launches
        twin_l = [paged_logits(engine, np.asarray(rows[i])[:-1], prompts[i].size)
                  for i in INT8_TWIN_ROWS]
    if twin_launches:
        failures.append(f"the twin run launched the dequant kernel {twin_launches} times")
    if twin_serve["actions"] != acts:
        failures.append(f"the twin run took other actions: {twin_serve['actions']}")
    rows_equal = sum(np.array_equal(np.asarray(a), np.asarray(b))
                     for a, b in zip(rows, twin_rows))
    if rows_equal != len(prompts):
        failures.append(f"{len(prompts) - rows_equal} rows differ from the twin's")
    got_l, fault_l = [], []
    for i in INT8_TWIN_ROWS:
        w = np.asarray(rows[i])[:-1]
        got_l.append(paged_logits(engine, w, prompts[i].size))
        with planted_attention_fault("flash_kv_head_shifted"):
            fault_l.append(paged_logits(engine, w, prompts[i].size))
    logits, bad = logit_parity(torch.cat(got_l), torch.cat(twin_l),
                               {"flash_kv_head_shifted": torch.cat(fault_l)})
    failures += bad
    step_int8 = _decode_step_ms(engine, prompts[:8]) if ASYNC_DEVICE is None else None
    _free()

    mid = _allocated_gb()
    model_bf, params = _llama7b_cut(seed, SERVE_INT8_LAYERS)
    bf16 = deepspeed_tpu_torch.init_inference(model_bf, params=params, dtype=ASYNC_DTYPE,
                                              device=ASYNC_DEVICE, telemetry=True)
    del params
    _free()
    at_rest["bf16_allocated_gb"] = None if mid is None else _allocated_gb() - mid
    at_rest["bf16_tree_gb"] = quant.tree_nbytes(bf16.params) / 1e9
    if at_rest["int8_tree_gb"] >= at_rest["bf16_tree_gb"]:
        failures.append(f"int8 weights at rest {at_rest} not below bf16's")
    step_bf16 = _decode_step_ms(bf16, prompts[:8]) if ASYNC_DEVICE is None else None
    # the speed comparison, alternated on one card: int8 (above), bf16, bf16, int8
    bf_rows, bf_serve = _fresh_serve(bf16, prompts)
    bf_serve_2 = _fresh_serve(bf16, prompts)[1]
    int8_serve_2 = _fresh_serve(engine, prompts)[1]
    agree = total = 0
    for i in INT8_TOP1_ROWS:
        w = np.asarray(bf_rows[i])
        lg = paged_logits(engine, w[:-1], prompts[i].size)
        agree += int((lg.argmax(-1).numpy() == w[prompts[i].size:]).sum())
        total += lg.shape[0]
    state["serve_int8_launches"] = launches
    emit("serve_int8", model="llama-2-7b", layers=cfg.n_layer, dtype="int8",
         q_groups=int(engine.config.quant.weight.q_groups), init_s=init_s,
         requests=len(prompts), max_new_tokens=SERVE_MAX_NEW, at_rest=at_rest,
         serve=serve, serve_again=int8_serve_2, bf16_serve=bf_serve, bf16_serve_again=bf_serve_2,
         launches=launches, launch_rule=rule,
         twin={"rows_equal": int(rows_equal), "launches": twin_launches, "logits": logits},
         decode_step_device_ms={"int8": step_int8, "bf16": step_bf16},
         bf16_top1_agreement={"positions": total, "agree": agree,
                              "share": agree / max(total, 1)},
         card=state.get("card"))
    del engine, bf16
    _free()
    check(not failures, "serve_int8 failed: " + "; ".join(failures))


# ----------------------------------------------------------------------- #
# host offload: ZeRO-Inference weight streaming, ZeRO-Offload of the optimizer

STREAM_DTYPE = "bf16"
STREAM_MAX_NEW = 16             # serve_stream: generate's [8, 512] batch, cut 64 -> 16 new (time)
STREAM_LAYERS = 16              # serve_stream: Llama-2-7B cut 32 -> 16 layers (the run's clock)
STREAM_NVME_LAYERS = 2          # serve_stream_nvme: Llama-2-7B cut 32 -> 2 layers (disk, time)
STREAM_TF_ROWS = 2              # rows of the output held teacher-forced
STREAM_PEAK_MARGIN = 1.5e9      # device peak over embedding + head + 2 layers + KV workspace
STREAM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".zero_inference")
OFFLOAD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".offload_nvme")
# train_offload's depth: 18 B a parameter of host state within 60 % of the
# card machine's MemTotal (108.4 GB): 16 layers (3.50 B parameters, 63.0
# GB) fit, 24 do not; cut to 12 (2.69 B, 48.4 GB) after a default run at
# 16 took 1155.7 s of its 1200, and to 8 (1.88 B, 33.8 GB) when the
# compression phases added 62 s to a 1112.6 s run (PERF.md section 4)
OFFLOAD_LAYERS = 4              # train_offload: Llama-2-7B cut 32 -> 4 layers (the run's clock)
OFFLOAD_CHECK_LAYERS = 2        # the depth held against the E engine
OFFLOAD_NVME_LAYERS = 1         # the NVMe run held bit-equal to cpu mode
OFFLOAD_NVME_STEPS = 3
# host bytes a parameter under ZeRO-Offload: fp32 master and two moments, the
# pinned fp32 grad and bf16 param staging; the depth must fit this share of
# the machine's MemTotal
OFFLOAD_HOST_BYTES = 18
OFFLOAD_HOST_SHARE = 0.6
MASTER_TOL = 1e-6               # E's own limit: master difference / the leaf's largest master


def cpu_model():
    """The host CPU's model name (/proc/cpuinfo)."""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return None


def meminfo():
    """MemTotal and MemAvailable of /proc/meminfo, bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            if k in ("MemTotal", "MemAvailable"):
                out[k] = int(v.split()[0]) * 1024
    return out


def _stream_model(seed, n_layer=None):
    """Llama-2-7B (``n_layer`` None: its 32 layers) with seeded bf16 weights
    drawn on the phase's device."""
    import torch
    from deepspeed_tpu_torch.models import llama
    model = llama("7b") if n_layer is None else llama("7b", n_layer=n_layer)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    return model, model.init_params(gen, device=CHECK_DEVICE, dtype=torch.bfloat16)


def stream_zero(device, nvme_path=None):
    off = {"device": device}
    if nvme_path:
        off["nvme_path"] = nvme_path
    return {"stage": 3, "offload_param": off}


@contextlib.contextmanager
def swapped_layers(engine, a=0, b=1):
    """A planted fault in a host-RAM streamed engine: layers ``a`` and ``b``
    fetched into each other's place."""
    real = engine._fetch_submit
    engine._fetch_submit = lambda i: real({a: b, b: a}.get(i, i))
    try:
        yield
    finally:
        del engine._fetch_submit


def stream_tf_logits(engine, rows):
    """Teacher-forced logits of ``rows`` [B, T] through the cached path at
    pos 0 on a fresh cache, fp32 on the host: a streamed engine's
    ``forward``, a resident engine's ``forward_cached`` (the same blocks)."""
    import torch
    with torch.no_grad():
        if engine._stream_weights:
            out = engine.forward(rows)
        else:
            ids = engine._ids(rows)
            cache = engine.module.init_cache(ids.shape[0], ids.shape[1], dtype=engine.dtype,
                                             device=engine.device)
            out = engine.module.forward_cached(engine.params, ids, cache, 0)[0]
    return out.float().cpu().reshape(-1, out.shape[-1])


def _timed_generate(engine, ids, max_new):
    """A warm-up call with one new token (the workspace), a timed one (the
    prefill and the first token), then the timed full call with the
    decode kernels' counters set to 0 just before and read just after."""
    from deepspeed_tpu_torch.ops.kernels import decode_attention as dda
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    engine.generate(ids, max_new_tokens=1)
    _sync()
    t = time.perf_counter()
    engine.generate(ids, max_new_tokens=1)
    _sync()
    prefill_s = time.perf_counter() - t
    dda.launches = fa.launches = 0
    t = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=max_new)
    _sync()
    wall = time.perf_counter() - t
    launches = {"dense_decode_attention": dda.launches, "flash_attention_fwd": fa.launches}
    gen = out.shape[1] - ids.shape[1]
    return out, {"wall_s": wall, "prefill_ms": prefill_s * 1e3,
                 "decode_ms_per_step": (wall - prefill_s) / max(gen - 1, 1) * 1e3,
                 "tokens_per_s": out.shape[0] * gen / wall, "launches": launches}


def stream_launch_rule(n_layer, generated):
    """K5 once a layer a decode step (the prompt takes the cached path's
    einsum, not A); 0 on the CPU, where the plain versions run."""
    on = CHECK_DEVICE == "cuda"
    return {"dense_decode_attention": n_layer * (generated - 1) if on else 0,
            "flash_attention_fwd": 0}


def pinned_copy_gbps(nbytes):
    """One plain host-to-card copy of ``nbytes`` from pinned memory (CUDA
    events, median of 5), GB/s; None on the CPU."""
    if CHECK_DEVICE != "cuda":
        return None
    import torch
    from deepspeed_tpu_torch.ops.aio import HostSlab
    src = HostSlab(nbytes, pin=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src.bytes, non_blocking=True), reps=5, warmup=2)
    del dst
    return nbytes / ms / 1e6


def phase_serve_stream(state, seed):
    """ZeRO-Inference from host RAM: Llama-2-7B cut to STREAM_LAYERS (seeded
    bf16 weights) with ``zero.offload_param.device="cpu"``, its layers in one pinned
    host slab and two layer buffers on the card, on generate's [8, 512]
    prompts with STREAM_MAX_NEW new tokens. Rows equal (limit 0) to a
    resident engine's generate on the same weights (both run cached_block
    and K5 a layer); K5 = L x (new - 1), A 0; device peak under embedding +
    head + 2 layers + the KV workspace + STREAM_PEAK_MARGIN (counted from
    what the card held before the phase); teacher-forced
    logits equal to the resident's (limit 0) and two layers' buffers
    swapped planted above LOGIT_ULP_TOL. Prefill ms, ms a decode step,
    tokens/s beside the resident engine's, its peak, the stream's GB/s and
    its bound (L layers over one plain pinned copy's rate), the copy
    stream's busy share of a decode step, host RSS."""
    import numpy as np
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator

    acc = get_accelerator(CHECK_DEVICE)
    failures = []
    t_phase = time.perf_counter()
    # what earlier phases still hold on the card (caches, workspaces) is not
    # the streamed engine's: the peak gate counts from it
    held = _allocated_gb() or 0.0
    model, params = _stream_model(seed, STREAM_LAYERS)
    cfg = model.config
    L = cfg.n_layer
    ids = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size,
                                                   size=(GEN_BATCH, GEN_PROMPT))
    resident = deepspeed_tpu_torch.init_inference(model, params=params, dtype=STREAM_DTYPE,
                                                  device=CHECK_DEVICE)
    del params
    acc.reset_peak_memory_stats()
    want, res = _timed_generate(resident, ids, STREAM_MAX_NEW)
    res["peak_mem_gb"] = acc.max_memory_allocated() / 1e9
    want_logits = stream_tf_logits(resident, want[:STREAM_TF_ROWS])

    t0 = time.perf_counter()
    streamed = deepspeed_tpu_torch.init_inference(model, params=resident.params,
                                                  dtype=STREAM_DTYPE, device=CHECK_DEVICE,
                                                  zero=stream_zero("cpu"))
    _sync()
    init_s = time.perf_counter() - t0
    del resident
    _free()
    layer_bytes = streamed._stream_layout.nbytes
    resident_bytes = sum(p.numel() * p.element_size() for p in streamed.params.parameters())
    acc.reset_peak_memory_stats()
    streamed._copy_timing = [] if CHECK_DEVICE == "cuda" else None
    got, run = _timed_generate(streamed, ids, STREAM_MAX_NEW)
    copies, streamed._copy_timing = streamed._copy_timing, None
    peak = acc.max_memory_allocated()
    ws = sum(t.numel() * t.element_size() for t in streamed._workspace[2].values())
    peak_bound = resident_bytes + 2 * layer_bytes + ws + STREAM_PEAK_MARGIN
    rule = stream_launch_rule(L, got.shape[1] - GEN_PROMPT)
    if not np.array_equal(got, want):
        failures.append(f"streamed rows differ from the resident engine's at "
                        f"{int((got != want).any(axis=1).sum())} rows")
    if run["launches"] != rule:
        failures.append(f"launches {run['launches']} != {rule}")
    if CHECK_DEVICE == "cuda" and not peak - held * 1e9 <= peak_bound:
        failures.append(f"device peak {peak / 1e9:.3f} GB less {held:.3f} held before the phase "
                        f"over its bound {peak_bound / 1e9:.3f}")
    got_logits = stream_tf_logits(streamed, want[:STREAM_TF_ROWS])
    with swapped_layers(streamed):
        fault_logits = stream_tf_logits(streamed, want[:STREAM_TF_ROWS])
    tf = {"positions": int(got_logits.shape[0]),
          "ulp_err": float(row_ulp_errs(got_logits, want_logits).max()),
          "fault_ulp_err": {"layers_0_1_swapped":
                            float(row_ulp_errs(fault_logits, want_logits).max())}}
    if tf["ulp_err"] != 0.0:
        failures.append(f"teacher-forced logits differ from the resident's: {tf['ulp_err']} ulps")
    if not tf["fault_ulp_err"]["layers_0_1_swapped"] > LOGIT_ULP_TOL:
        failures.append(f"the swapped-layers fault reads {tf['fault_ulp_err']}")
    step_s = run["decode_ms_per_step"] / 1e3
    stream = {"layer_bytes": layer_bytes, "bytes_a_step": L * layer_bytes,
              "gb_per_s": L * layer_bytes / step_s / 1e9}
    copy_gbps = pinned_copy_gbps(layer_bytes)
    if copy_gbps is not None:
        decode = copies[L:]          # the prefill's copies come first
        busy_ms = sum(a.elapsed_time(b) for a, b in decode)
        stream.update(plain_pinned_copy_gb_per_s=copy_gbps,
                      bound_ms_a_step=L * layer_bytes / copy_gbps / 1e6,
                      copy_ms_a_layer=busy_ms / max(len(decode), 1),
                      copy_busy_share=busy_ms / (len(decode) // L) / run["decode_ms_per_step"])
    state["serve_stream_launches"] = {"dense_decode_attention":
                                      run["launches"]["dense_decode_attention"]}
    emit("serve_stream", model="llama-2-7b", layers=L, dtype=STREAM_DTYPE, offload="cpu",
         batch=[GEN_BATCH, GEN_PROMPT], max_new_tokens=STREAM_MAX_NEW,
         cut="max_new_tokens 64 -> 16 (time)", rows_equal=int((got == want).all(axis=1).sum()),
         rows=GEN_BATCH, streamed=run, resident=res, init_s=init_s,
         peak_mem_gb=peak / 1e9, held_before_gb=held, peak_bound_gb=peak_bound / 1e9,
         resident_params_gb=resident_bytes / 1e9, kv_workspace_gb=ws / 1e9,
         host_slab_gb=L * streamed._stream_layout.stride / 1e9, stream=stream,
         teacher_forced=tf, host_rss_gb=host_rss_gb(), launch_rule=rule,
         phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    del streamed
    _free()
    check(not failures, "serve_stream failed: " + "; ".join(failures))


def o_direct_ok(path):
    """Whether ``path``'s file system takes O_DIRECT (the engine's aligned
    reads then bypass the page cache)."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECT", 0))
    except OSError:
        return False
    os.close(fd)
    return hasattr(os, "O_DIRECT")


def phase_serve_stream_nvme(state, seed):
    """ZeRO-Inference from NVMe: Llama-2-7B cut to STREAM_NVME_LAYERS layers
    with ``device="nvme"`` under STREAM_DIR (free disk checked first): rows
    equal (limit 0) to the cpu-mode streamed engine at the same depth, K5 =
    L x (new - 1), the engine's swap dir gone once it is released. The read
    GB/s of every layer file into pinned staging (warm: the files were
    written at init) and whether O_DIRECT was taken."""
    import numpy as np
    import deepspeed_tpu_torch

    failures = []
    t_phase = time.perf_counter()
    model, params = _stream_model(seed, STREAM_NVME_LAYERS)
    cfg = model.config
    L = cfg.n_layer
    need = sum(p.numel() * p.element_size() for p in params.parameters()) + 2e9
    os.makedirs(STREAM_DIR, exist_ok=True)
    free = shutil.disk_usage(STREAM_DIR).free
    check(free > need, f"serve_stream_nvme needs {need / 1e9:.1f} GB of disk under "
                       f"{STREAM_DIR}, {free / 1e9:.1f} GB free")
    ids = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size,
                                                   size=(GEN_BATCH, GEN_PROMPT))
    ram = deepspeed_tpu_torch.init_inference(model, params=params, dtype=STREAM_DTYPE,
                                             device=CHECK_DEVICE, zero=stream_zero("cpu"))
    want, ram_run = _timed_generate(ram, ids, STREAM_MAX_NEW)
    del ram
    _free()
    t0 = time.perf_counter()
    nvme = deepspeed_tpu_torch.init_inference(model, params=params, dtype=STREAM_DTYPE,
                                              device=CHECK_DEVICE,
                                              zero=stream_zero("nvme", STREAM_DIR))
    _sync()
    init_s = time.perf_counter() - t0
    del params
    _free()
    swap_dir = nvme._swap_dir
    files = sorted(f for f in os.listdir(swap_dir) if f.endswith(".swp"))
    if len(files) != L:
        failures.append(f"{len(files)} layer files in the swap dir, not {L}")
    direct = o_direct_ok(os.path.join(swap_dir, files[0]))
    t = time.perf_counter()
    for i in range(L):
        nvme._fetch_finish(nvme._fetch_submit(i))
    read_s = time.perf_counter() - t
    stride = nvme._stream_layout.stride
    got, run = _timed_generate(nvme, ids, STREAM_MAX_NEW)
    rule = stream_launch_rule(L, got.shape[1] - GEN_PROMPT)
    if not np.array_equal(got, want):
        failures.append(f"NVMe rows differ from cpu mode's at "
                        f"{int((got != want).any(axis=1).sum())} rows")
    if run["launches"] != rule:
        failures.append(f"launches {run['launches']} != {rule}")
    state["serve_stream_nvme_launches"] = {"dense_decode_attention":
                                           run["launches"]["dense_decode_attention"]}
    del nvme
    _free()
    released = not os.path.exists(swap_dir)
    if not released:
        failures.append(f"swap dir {swap_dir} left after the engine was released")
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    emit("serve_stream_nvme", model="llama-2-7b", layers=L, dtype=STREAM_DTYPE, offload="nvme",
         cut=f"layers 32 -> {L} (disk, time); max_new_tokens 64 -> {STREAM_MAX_NEW}",
         batch=[GEN_BATCH, GEN_PROMPT], rows_equal=int((got == want).all(axis=1).sum()),
         rows=GEN_BATCH, nvme=run, cpu_mode=ram_run, init_s=init_s,
         read={"bytes": L * stride, "s": read_s, "gb_per_s": L * stride / read_s / 1e9,
               "o_direct": direct,
               "note": "warm: the files were written at init, so reads may come from the "
                       "page cache"},
         swap_dir_removed=released, disk_free_gb=free / 1e9, launch_rule=rule,
         phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    check(not failures, "serve_stream_nvme failed: " + "; ".join(failures))


def _offload_model(n_layer):
    """Llama-2-7B's widths at ``n_layer`` layers (the train cell's model)."""
    from deepspeed_tpu_torch.models import llama
    return llama("7b", n_layer=n_layer)


def offload_config(device="cpu", nvme_path=None):
    """The train cell's configuration with AdamW (the host optimizer takes
    Adam, AdamW and Adagrad) and ``offload_optimizer`` on ``device``
    ("none": the device optimizer, kernel E)."""
    opt = TRAIN_CONFIG["optimizer"]
    off = {"device": device, **({"nvme_path": nvme_path} if nvme_path else {})}
    return {**TRAIN_CONFIG, "optimizer": {"type": "AdamW", "params": dict(opt["params"])},
            "zero_optimization": {"stage": 2, "offload_optimizer": off}}


def _offload_setup(seed, n_layer, config):
    """The engine from seeded bf16 weights drawn on the phase's device, and
    the train cell's one token batch."""
    import numpy as np
    import torch
    model = _offload_model(n_layer)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.bfloat16)
    engine = _train_engine(model, params, config, device=CHECK_DEVICE)
    del params
    _free()
    rng = np.random.default_rng(seed + 2)
    tokens = rng.integers(0, model.config.vocab_size,
                          size=(config["train_batch_size"], TRAIN_SEQ))
    return model, engine, {"input_ids": torch.from_numpy(tokens).to(CHECK_DEVICE)}


def offload_launch_rule(engine):
    """The train rule with the optimizer on the host: E never launches."""
    return {**train_launch_rule(engine), "fused_adam": 0}


def _watch_boundary(engine, name, grads, after=None):
    """Wrap the engine's boundary method ``name`` so each call first appends
    the fingerprints of the accumulated (still scaled) grads to ``grads``,
    and calls ``after()`` once it returns."""
    real = getattr(engine, name)

    def boundary(*args, **kw):
        grads.append({n: grad_fingerprint(g) for n, g in engine.state.acc_grads.items()})
        out = real(*args, **kw)
        if after is not None:
            after()
        return out

    setattr(engine, name, boundary)


def offload_master_errs(engine, want):
    """Each port leaf's host master against ``want`` (name -> fp32 tensor):
    the largest |difference| over the leaf's largest |want|."""
    import torch
    out = {}
    for key, names in engine._offload_groups.items():
        for n, v in zip(names, engine._offload.layer_views(key)):
            w = want[n].to(v.device, torch.float32)
            out[n] = float((v - w).abs().max() / w.abs().max().clamp(min=1e-30))
    return out


def offload_reload_err(engine):
    """load_module_state_dict with every param negated, then the host
    masters against the loaded values (largest relative difference): 0 when
    the masters follow the load."""
    import torch
    neg = engine.state.params.map(lambda t: -t.detach())
    engine.load_module_state_dict(neg)
    want = engine._offload_flat(engine._param_dict(neg))
    errs = [float((m - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-30))
            for k, m in engine._offload.masters().items()]
    del neg
    return max(errs)


@contextlib.contextmanager
def offload_split(engine):
    """Time each boundary of the steps run inside, one dict a step: the D2H
    and H2D copies by CUDA events recorded around them on the stream (no
    added sync; host clock on the CPU), the host optimizer's pass on the
    host clock (it runs after the D2H's own sync)."""
    rec = []
    real = {n: getattr(engine, n) for n in ("_offload_d2h", "_offload_update", "_offload_h2d")}
    clock = _cuda_event if CHECK_DEVICE == "cuda" else time.perf_counter

    def wrap(name, part, mark):
        def run(*args, **kw):
            if part == "d2h":
                rec.append({})
            a = mark()
            out = real[name](*args, **kw)
            rec[-1][part] = (a, mark())
            return out
        return run

    for name, part, mark in (("_offload_d2h", "d2h", clock),
                             ("_offload_update", "host", time.perf_counter),
                             ("_offload_h2d", "h2d", clock)):
        setattr(engine, name, wrap(name, part, mark))
    try:
        yield rec
    finally:
        for name in real:
            delattr(engine, name)


def split_ms(rec, step_s):
    """Medians over the timed steps (all but the first) of D2H, host
    optimizer and H2D ms, and of the device accumulation: the step's rest."""
    ms = lambda a, b: (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)
    rows = []
    for parts, s in zip(rec, step_s):
        row = {part: ms(*ab) for part, ab in parts.items()}
        row["accumulation"] = s * 1e3 - row["d2h"] - row["host"] - row["h2d"]
        rows.append(row)
    timed = rows[1:] or rows
    return {f"{k}_ms": statistics.median(r[k] for r in timed)
            for k in ("accumulation", "d2h", "host", "h2d")}


def _offload_nvme_run(seed, device, reload=None):
    """OFFLOAD_NVME_LAYERS layers with the optimizer on ``device`` for
    OFFLOAD_NVME_STEPS steps: the losses and the host masters after. With
    ``reload`` (a dict), the engine then takes the load_module_state_dict
    check, sound and with the masters' refresh planted out."""
    nvme = OFFLOAD_DIR if device == "nvme" else None
    _, engine, batch = _offload_setup(seed, OFFLOAD_NVME_LAYERS, offload_config(device, nvme))
    losses = [float(engine.train_batch(batch)) for _ in range(OFFLOAD_NVME_STEPS)]
    masters = {k: v.clone() for k, v in engine._offload.masters().items()}
    if reload is not None:
        reload["sound"] = offload_reload_err(engine)
        engine._offload.load_masters = lambda masters: None
        reload["fault"] = offload_reload_err(engine)
    engine.destroy()
    del engine, batch
    _free()
    return losses, masters


def phase_train_offload(state, seed):
    """ZeRO-Offload: the train cell's configuration (Llama-2-7B widths, S
    2048, remat, micro 4 x gas 2, AdamW, WarmupLR, clip 1.0, bf16, fused CE)
    with ``offload_optimizer.device="cpu"``. First, at OFFLOAD_CHECK_LAYERS
    layers from the same seeded state as the device optimizer (kernel E),
    2 steps each: the grads at steps 1 and 2 equal (per-leaf fingerprints,
    limit 0; step 1's WarmupLR lr is 0, so step 2's is the first update),
    each leaf's master after step 2 within MASTER_TOL of its largest value.
    Then OFFLOAD_LAYERS layers (the host state,
    OFFLOAD_HOST_BYTES a parameter, within OFFLOAD_HOST_SHARE of MemTotal),
    1 + 5 steps: losses finite, step 6 below step 1, per step A 2 L gas, C =
    D = L gas, each K3 kernel gas, E 0; each step split into D2H and H2D
    (CUDA events, no added sync), the host optimizer (host clock) and the
    device accumulation (the rest). Last,
    OFFLOAD_NVME_LAYERS layers on NVMe bit-equal to cpu mode after
    OFFLOAD_NVME_STEPS steps (losses and masters), and the cpu-mode engine's
    masters following a load_module_state_dict (0) and, not refreshed,
    planted above MASTER_TOL. Step ms, tokens/s, MFU,
    device peaks beside the E engine's, host RSS peak."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator

    acc = get_accelerator(CHECK_DEVICE)
    failures = []
    t_phase = time.perf_counter()
    mem = meminfo()
    n_params = _offload_model(OFFLOAD_LAYERS).num_parameters
    host_need = OFFLOAD_HOST_BYTES * n_params
    check(host_need <= OFFLOAD_HOST_SHARE * mem["MemTotal"],
          f"train_offload at {OFFLOAD_LAYERS} layers needs {host_need / 1e9:.1f} GB of host "
          f"state, over {OFFLOAD_HOST_SHARE} of MemTotal {mem['MemTotal'] / 1e9:.1f} GB")

    # the device optimizer (kernel E) from the same seeded state: its grads
    # at steps 1 and 2, its masters after step 2 and its peak
    acc.reset_peak_memory_stats()
    _, e_engine, batch = _offload_setup(seed, OFFLOAD_CHECK_LAYERS, offload_config("none"))
    e_grads = []
    _watch_boundary(e_engine, "_apply_update", e_grads)
    e_losses = [float(e_engine.train_batch(batch)) for _ in range(2)]
    _sync()
    e_peak = acc.max_memory_allocated() / 1e9
    e_masters = {n: m.to("cpu", copy=True) for n, m in e_engine.state.master.items()}
    e_engine.destroy()
    del e_engine, batch
    _free()

    acc.reset_peak_memory_stats()
    _, engine, batch = _offload_setup(seed, OFFLOAD_CHECK_LAYERS, offload_config("cpu"))
    grads, master_errs = [], {}
    _watch_boundary(engine, "_host_step", grads,
                    lambda: master_errs.update(offload_master_errs(engine, e_masters))
                    if engine.global_steps == 2 else None)
    check_losses = [float(engine.train_batch(batch)) for _ in range(2)]
    _sync()
    check_peak = acc.max_memory_allocated() / 1e9
    del engine._host_step, e_masters
    engine.destroy()
    del engine, batch
    _free()
    grad_mism = [n for i in range(2) for n in e_grads[i] if grads[i][n] != e_grads[i][n]]
    if grad_mism:
        failures.append(f"grads at steps 1-2 differ from E's at {len(grad_mism)} leaves: "
                        f"{grad_mism[:3]}")
    worst = max(master_errs.values())
    if not worst <= MASTER_TOL:
        failures.append(f"masters after step 2 differ from E's by {worst} > {MASTER_TOL}")

    parts_s = {"check": time.perf_counter() - t_phase}
    acc.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, engine, batch = _offload_setup(seed, OFFLOAD_LAYERS, offload_config("cpu"))
    _sync()
    init_s = time.perf_counter() - t0
    cfg = model.config
    want = offload_launch_rule(engine)
    _reset_train_counters()
    with sampled_host_peak() as rss, offload_split(engine) as split:
        losses, step_s, per_step = _timed_steps(engine, batch, TRAIN_STEPS)
    launches = _train_counters()
    peak = acc.max_memory_allocated() / 1e9
    breakdown = split_ms(split, step_s)
    engine.destroy()
    del engine, batch
    _free()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"losses {losses}")
    for k, n in want.items():
        if any(s[k] != n for s in per_step):
            failures.append(f"{k} launches a step {[s[k] for s in per_step]} != {n}")

    parts_s["main"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reload = {}
    cpu_losses, cpu_masters = _offload_nvme_run(seed, "cpu", reload)
    if reload["sound"] != 0.0:
        failures.append(f"masters after load_module_state_dict read {reload['sound']}")
    if not reload["fault"] > MASTER_TOL:
        failures.append(f"the masters-not-refreshed fault reads {reload['fault']}")
    need = 12 * sum(v.numel() for v in cpu_masters.values())   # fp32 master and moments
    os.makedirs(OFFLOAD_DIR, exist_ok=True)
    free = shutil.disk_usage(OFFLOAD_DIR).free
    check(free > need, f"train_offload's NVMe run needs {need / 1e9:.1f} GB of disk, "
                       f"{free / 1e9:.1f} GB free")
    try:
        nvme_losses, nvme_masters = _offload_nvme_run(seed, "nvme")
    finally:
        shutil.rmtree(OFFLOAD_DIR, ignore_errors=True)
    nvme_equal = nvme_losses == cpu_losses and all(
        torch.equal(nvme_masters[k], m) for k, m in cpu_masters.items())
    if not nvme_equal:
        failures.append(f"NVMe run differs from cpu mode: losses {nvme_losses} vs {cpu_losses}")
    parts_s["nvme"] = time.perf_counter() - t0

    state["train_offload_launches"] = launches
    tokens = TRAIN_CONFIG["train_batch_size"] * TRAIN_SEQ
    step = statistics.median(step_s[1:])
    flops_tok = model.flops_per_token(TRAIN_SEQ)
    peak_tf = acc.peak_tflops()
    emit("train_offload", model="llama-2-7b width", layers=cfg.n_layer, seq=TRAIN_SEQ,
         dtype="bf16", offload="cpu", config=offload_config("cpu"), params=n_params,
         host_state_gb=host_need / 1e9, mem_total_gb=mem["MemTotal"] / 1e9,
         losses=losses, step_s=step_s, step_ms_median_timed=step * 1e3,
         split=breakdown, tokens_per_s=tokens / step,
         mfu=flops_tok * tokens / step / (peak_tf * 1e12) if peak_tf else None,
         init_s=init_s, peak_mem_gb=peak, host_rss_peak_gb=rss[0],
         launches=launches, launches_per_step=want,
         check_layers=OFFLOAD_CHECK_LAYERS, check_peak_mem_gb=check_peak,
         e_engine_peak_mem_gb=e_peak, e_losses=e_losses, check_losses=check_losses,
         grads_equal_leaves=len(e_grads[0]) - len(set(grad_mism)),
         master_err_worst=worst, master_tol=MASTER_TOL, reload_err=reload["sound"],
         fault_masters_not_refreshed=reload["fault"], nvme_layers=OFFLOAD_NVME_LAYERS,
         nvme_losses=nvme_losses, cpu_losses=cpu_losses, nvme_bit_equal=nvme_equal,
         parts_s=parts_s, phase_s=time.perf_counter() - t_phase, card=state.get("card"))
    check(not failures, "train_offload failed: " + "; ".join(failures))


# ----------------------------------------------------------------------- #
# the encoder families: BERT-large and CLIP ViT-L/14

# HF bert-large-uncased's config.json, written out by its numbers (the MLM
# head tied; BertForMaskedLM carries no pooler)
BERT_LARGE_HF = {"architectures": ["BertForMaskedLM"], "model_type": "bert",
                 "vocab_size": 30522, "hidden_size": 1024, "num_hidden_layers": 24,
                 "num_attention_heads": 16, "intermediate_size": 4096, "hidden_act": "gelu",
                 "max_position_embeddings": 512, "type_vocab_size": 2,
                 "layer_norm_eps": 1e-12, "position_embedding_type": "absolute",
                 "pad_token_id": 0, "torch_dtype": "float32"}
# HF openai/clip-vit-large-patch14's config.json (text and vision towers)
CLIP_L14_HF = {"architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": 768,
               "logit_scale_init_value": 2.6592, "torch_dtype": "float32",
               "text_config": {"vocab_size": 49408, "hidden_size": 768,
                               "intermediate_size": 3072, "num_hidden_layers": 12,
                               "num_attention_heads": 12, "max_position_embeddings": 77,
                               "hidden_act": "quick_gelu", "layer_norm_eps": 1e-05,
                               "bos_token_id": 49406, "eos_token_id": 2, "pad_token_id": 1,
                               "projection_dim": 768},
               "vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                                 "num_hidden_layers": 24, "num_attention_heads": 16,
                                 "image_size": 224, "patch_size": 14,
                                 "hidden_act": "quick_gelu", "layer_norm_eps": 1e-05,
                                 "projection_dim": 768}}


def bert_large(n_layer=None, **over):
    """BERT-large with its MLM head from BERT_LARGE_HF (through BertPolicy's
    config), ``n_layer`` layers (default all 24); ``over``: BertConfig
    fields (remat, the gather budget)."""
    import dataclasses
    from deepspeed_tpu_torch.module_inject.policies import BertPolicy
    hf = {**BERT_LARGE_HF, "num_hidden_layers": n_layer or BERT_LARGE_HF["num_hidden_layers"]}
    model = BertPolicy().build_model(BertPolicy().zoo_config(hf), hf, {"mlm": {}})
    return type(model)(dataclasses.replace(model.config, **over), with_mlm_head=True)


def clip_l14(text_layers=None, vision_layers=None):
    """CLIP ViT-L/14's two towers with their projections from CLIP_L14_HF
    (through CLIPPolicy's configs), cut to the given depths."""
    from deepspeed_tpu_torch.module_inject.policies import CLIPPolicy
    tc = {**CLIP_L14_HF["text_config"],
          "num_hidden_layers": text_layers or CLIP_L14_HF["text_config"]["num_hidden_layers"]}
    vc = {**CLIP_L14_HF["vision_config"],
          "num_hidden_layers": vision_layers or CLIP_L14_HF["vision_config"]["num_hidden_layers"]}
    hf = {**CLIP_L14_HF, "text_config": tc, "vision_config": vc}
    return CLIPPolicy().build_model(None, hf, {"text": {"embed": 0, "text_projection": 0},
                                               "vision": {"patch_embed": 0,
                                                          "visual_projection": 0}})


def bert_hf_config(cfg):
    """The config.json of a BertForMaskedLM of ``cfg`` (a BertConfig):
    BERT_LARGE_HF itself at its published sizes."""
    return {**BERT_LARGE_HF, "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
            "num_hidden_layers": cfg.n_layer, "num_attention_heads": cfg.n_head,
            "intermediate_size": cfg.d_ff, "max_position_embeddings": cfg.max_seq,
            "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.norm_eps}


def clip_hf_config(enc):
    """The config.json of a CLIPModel of ``enc``'s towers (a DSClipEncoder):
    CLIP_L14_HF itself at its published sizes."""
    t, v = enc.text.config, enc.vision.config
    sizes = lambda c: {"hidden_size": c.d_model, "intermediate_size": c.d_ff,
                       "num_hidden_layers": c.n_layer, "num_attention_heads": c.n_head,
                       "projection_dim": t.projection_dim}
    return {**CLIP_L14_HF, "projection_dim": t.projection_dim,
            "text_config": {**CLIP_L14_HF["text_config"], **sizes(t),
                            "vocab_size": t.vocab_size, "max_position_embeddings": t.max_seq},
            "vision_config": {**CLIP_L14_HF["vision_config"], **sizes(v),
                              "image_size": v.image_size, "patch_size": v.patch_size}}


def mlm_batch(vocab, B, S, seed, lengths=None, rate=MLM_RATE, full_rows=0):
    """Fill-mask rows: [CLS] seeded ids [SEP], padded with 0 past each row's
    length (seeded in 64..S unless given; the first ``full_rows`` rows of
    length S), ``rate`` of each row's inner
    positions set to [MASK] and labelled with the id they hid (-100
    elsewhere). Returns numpy ``input_ids``, ``attention_mask``,
    ``token_type_ids``, ``labels`` and the lengths."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(64, S + 1, size=B)
        lengths[:full_rows] = S
    lengths = np.asarray(lengths)
    pos = np.arange(S)[None]
    valid = pos < lengths[:, None]
    ids = np.where(valid, rng.integers(1000, vocab, size=(B, S)), 0)
    ids[:, 0] = BERT_CLS
    ids[np.arange(B), lengths - 1] = BERT_SEP
    inner = valid & (pos > 0) & (pos < lengths[:, None] - 1)
    masked = inner & (rng.random((B, S)) < rate)
    labels = np.where(masked, ids, -100)
    return {"input_ids": np.where(masked, BERT_MASK, ids).astype(np.int64),
            "attention_mask": valid.astype(np.int64),
            "token_type_ids": np.zeros((B, S), np.int64),
            "labels": labels.astype(np.int64)}, lengths


def clip_prompts(n, seed, S=77):
    """``n`` CLIP token rows: [BOS], seeded ids, [EOT], padded with EOT to
    ``S`` as CLIP pads (lengths seeded in 8..S)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = np.full((n, S), CLIP_EOT, np.int64)
    for i, L in enumerate(rng.integers(8, S + 1, size=n)):
        ids[i, 0] = CLIP_BOS
        ids[i, 1:L - 1] = rng.integers(300, CLIP_BOS, size=L - 2)
    return ids


def clip_images(n, seed, size=224):
    """``n`` seeded NHWC images [n, size, size, 3], normalised pixels."""
    import numpy as np
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def bert_hf_entries(params, dtype):
    """The HF ``BertForMaskedLM`` tensors of the port's BERT tree (the
    inverse of ``BertPolicy.map_params``: nn.Linear weights back to [out,
    in]; no pooler, the decoder tied to the word embeddings), as
    write_safetensors entries."""
    out = []

    def put(name, t, tr=False):
        shape = tuple(t.shape[::-1]) if tr else tuple(t.shape)
        out.append((name, shape, dtype, (lambda t=t: t.t()) if tr else (lambda t=t: t)))

    def ln(name, p):
        put(name + ".weight", p["scale"])
        put(name + ".bias", p["bias"])

    e, pre = params["embed"], "bert.embeddings."
    put(pre + "word_embeddings.weight", e["tokens"])
    put(pre + "position_embeddings.weight", e["positions"])
    put(pre + "token_type_embeddings.weight", e["token_type"])
    ln(pre + "LayerNorm", e["ln"])
    for i, lp in enumerate(params["layers"]):
        p, a, m = f"bert.encoder.layer.{i}.", lp["attn"], lp["mlp"]
        for hf, w, b in (("attention.self.query", "wq", "bq"), ("attention.self.key", "wk", "bk"),
                         ("attention.self.value", "wv", "bv"),
                         ("attention.output.dense", "wo", "bo")):
            put(p + hf + ".weight", a[w], tr=True)
            put(p + hf + ".bias", a[b])
        ln(p + "attention.output.LayerNorm", lp["ln_attn"])
        put(p + "intermediate.dense.weight", m["w_up"], tr=True)
        put(p + "intermediate.dense.bias", m["b_up"])
        put(p + "output.dense.weight", m["w_down"], tr=True)
        put(p + "output.dense.bias", m["b_down"])
        ln(p + "output.LayerNorm", lp["ln_mlp"])
    h = params["mlm"]
    put("cls.predictions.transform.dense.weight", h["w"], tr=True)
    put("cls.predictions.transform.dense.bias", h["b"])
    ln("cls.predictions.transform.LayerNorm", h["ln"])
    put("cls.predictions.bias", h["decoder_bias"])
    return out


def clip_hf_entries(params, dtype, patch_size):
    """The HF ``CLIPModel`` tensors of the port's two-tower tree (the
    inverse of ``CLIPPolicy.map_params``: the patch embedding back to a
    conv weight [D, 3, ps, ps]), as write_safetensors entries."""
    out = []

    def put(name, t, make=None, shape=None):
        out.append((name, tuple(shape or t.shape), dtype, make or (lambda t=t: t)))

    def linear(name, w, b=None):
        put(name + ".weight", w, lambda w=w: w.t(), tuple(w.shape[::-1]))
        if b is not None:
            put(name + ".bias", b)

    def ln(name, p):
        put(name + ".weight", p["scale"])
        put(name + ".bias", p["bias"])

    def tower(pre, layers):
        for i, lp in enumerate(layers):
            p, a, m = f"{pre}encoder.layers.{i}.", lp["attn"], lp["mlp"]
            for hf, w, b in (("q_proj", "wq", "bq"), ("k_proj", "wk", "bk"),
                             ("v_proj", "wv", "bv"), ("out_proj", "wo", "bo")):
                linear(p + "self_attn." + hf, a[w], a[b])
            ln(p + "layer_norm1", lp["ln_attn"])
            ln(p + "layer_norm2", lp["ln_mlp"])
            linear(p + "mlp.fc1", m["w_up"], m["b_up"])
            linear(p + "mlp.fc2", m["w_down"], m["b_down"])

    t, v = params["text"], params["vision"]
    put("text_model.embeddings.token_embedding.weight", t["embed"]["tokens"])
    put("text_model.embeddings.position_embedding.weight", t["embed"]["positions"])
    tower("text_model.", t["layers"])
    ln("text_model.final_layer_norm", t["ln_f"])
    linear("text_projection", t["text_projection"])
    pe = v["patch_embed"]
    D = pe.shape[1]
    put("vision_model.embeddings.patch_embedding.weight", pe,
        lambda: pe.reshape(patch_size, patch_size, 3, D).permute(3, 2, 0, 1),
        (D, 3, patch_size, patch_size))
    put("vision_model.embeddings.class_embedding", v["class_token"])
    put("vision_model.embeddings.position_embedding.weight", v["positions"])
    ln("vision_model.pre_layrnorm", v["ln_pre"])
    tower("vision_model.", v["layers"])
    ln("vision_model.post_layernorm", v["ln_f"])
    linear("visual_projection", v["visual_projection"])
    put("logit_scale", params["logit_scale"])
    return out


def _row_parity(pairs, faults):
    """:func:`logit_parity` over several outputs at once: ``pairs`` maps a
    name to (card, CPU) rows (one row a position or sequence), ``faults``
    a name to {output: faulted card rows}; the worst row of each output and
    of each fault (over the outputs it has) are reported."""
    import torch
    rec, failures = {}, []
    for name, (got, want) in pairs.items():
        sub = {f: rows[name] for f, rows in faults.items() if name in rows}
        r, fl = logit_parity(got, want, sub)
        rec[name] = r
        failures += [f"{name}: {x}" for x in fl]
        del sub
    check(all(torch.isfinite(g).all() for g, _ in pairs.values()), "non-finite outputs")
    return rec, failures


@contextlib.contextmanager
def _mask_dropped_in_backward():
    """Inside the ``with`` body kernels C and D run without the padding
    mask wherever the model's backward calls them (A keeps it)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    real = {n: getattr(fa, n) for n in ("flash_attention_dq", "flash_attention_dkv")}

    def faulted(fn):
        def run(q, k, v, do, lse, delta, mask_bias=None, *args, **kw):
            return fn(q, k, v, do, lse, delta, None, *args, **kw)
        return run

    for n, fn in real.items():
        setattr(fa, n, faulted(fn))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(fa, n, fn)


def attention_weighted(params, qk=3.0, vo=5.0):
    """``params`` with every layer's q and k projections scaled by ``qk`` and
    v and o by ``vo``, in place: at the init's std 0.02 attention is near
    uniform and its output small beside the residual, so faults in A move
    the encoders' outputs by less than LOGIT_ULP_TOL; scaled, each row
    attends to a few keys and the attention output is of the residual's
    size. Returns ``params``."""
    import torch
    with torch.no_grad():
        for lp in params["layers"]:
            for key, f in (("wq", qk), ("wk", qk), ("wv", vo), ("wo", vo)):
                lp["attn"][key].mul_(f)
    return params


def _bert_parity_forward(seed):
    """BERT-large width at 1 layer: MLM logits at every valid position and
    the pooled output, card (bf16) against CPU (fp32)."""
    import dataclasses
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    model = bert_large(1)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = attention_weighted(model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32))
    gpu = deepspeed_tpu_torch.init_inference(model, params=params, dtype=ENCODER_DTYPE,
                                             device=CHECK_DEVICE)
    cpu = deepspeed_tpu_torch.init_inference(model, params=params.map(lambda t: t.to("cpu")),
                                             dtype="fp32", device="cpu")
    del params
    batch, lengths = mlm_batch(model.config.vocab_size, BERT_PARITY_BATCH, BERT_SEQ, seed + 21)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    valid = torch.as_tensor(mask > 0)
    logits = lambda eng, m=mask: eng.forward(ids, attention_mask=m)[valid.to(eng.device)] \
        .float().cpu()
    pooled = lambda eng, mdl=model: mdl(eng.params, ids, None, torch.as_tensor(mask))[1] \
        .float().cpu()
    with torch.no_grad():
        want = {"mlm_logits": logits(cpu), "pooled": pooled(cpu)}
        del cpu
        got = {"mlm_logits": logits(gpu), "pooled": pooled(gpu)}
        causal = type(model)(model.config, with_mlm_head=True)
        causal.zoo_cfg = dataclasses.replace(causal.zoo_cfg, causal=True)
        faults = {"padding_mask_dropped": {"mlm_logits": logits(gpu, None)},
                  "causal": {"mlm_logits": causal.forward(gpu.params, ids, torch.as_tensor(
                      mask, device=gpu.device))[valid.to(gpu.device)].float().cpu()}}
        with planted_attention_fault("flash_kv_head_shifted"):
            faults["kv_head_shifted"] = {"mlm_logits": logits(gpu), "pooled": pooled(gpu)}
    rec, failures = _row_parity({k: (got[k], want[k]) for k in got}, faults)
    rec.update(batch=[BERT_PARITY_BATCH, BERT_SEQ], lengths=[int(x) for x in lengths],
               positions=int(valid.sum()))
    del gpu
    _free()
    return rec, failures


def _clip_parity(seed):
    """CLIP ViT-L/14 width at 1 layer a tower: text [8, 77] and vision [4,
    224, 224, 3], hidden states (one row a token) and pooled (one row a
    sequence), card (bf16) against CPU (fp32)."""
    import dataclasses
    import torch
    enc = clip_l14(1, 1)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 31)
    tp = attention_weighted(enc.text.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32))
    vp = attention_weighted(enc.vision.init_params(gen, device=CHECK_DEVICE,
                                                   dtype=torch.float32))
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[ENCODER_DTYPE]
    ids = clip_prompts(CLIP_PARITY_TEXT, seed + 32, enc.text.config.max_seq)
    images = clip_images(CLIP_PARITY_IMAGES, seed + 33, enc.vision.config.image_size)
    rows = lambda out: {"hidden": out[0].reshape(-1, out[0].shape[-1]).float().cpu(),
                        "pooled": out[1].float().cpu()}

    def run(tower, params, x, device, dtype, **zoo):
        t = type(tower)(tower.config)
        t.zoo_cfg = dataclasses.replace(t.zoo_cfg, **zoo)
        p = params.map(lambda a: a.to(device, dtype))
        with torch.no_grad():
            return rows(t(p, torch.as_tensor(x).to(device)))

    text_want = run(enc.text, tp, ids, "cpu", torch.float32)
    vis_want = run(enc.vision, vp, images, "cpu", torch.float32)
    text_got = run(enc.text, tp, ids, CHECK_DEVICE, dt)
    vis_got = run(enc.vision, vp, images, CHECK_DEVICE, dt)
    faults = {"text_non_causal": {f"text_{k}": v for k, v in
                                  run(enc.text, tp, ids, CHECK_DEVICE, dt, causal=False).items()},
              "vision_causal": {f"vision_{k}": v for k, v in
                                run(enc.vision, vp, images, CHECK_DEVICE, dt,
                                    causal=True).items()}}
    pairs = {**{f"text_{k}": (text_got[k], text_want[k]) for k in text_got},
             **{f"vision_{k}": (vis_got[k], vis_want[k]) for k in vis_got}}
    rec, failures = _row_parity(pairs, faults)
    rec.update(text_batch=list(ids.shape), image_batch=list(images.shape))
    return rec, failures


def phase_encoder_parity(state, seed):
    """The encoder path, card (bf16, kernels) against CPU (fp32, plain
    versions), each model at 1 layer of its published width: BERT-large's
    MLM logits at every valid position and its pooled output on [4, 512]
    rows of seeded lengths under an attention mask (LOGIT_ULP_TOL; the
    padding mask dropped, causal attention and A's kv head shifted above
    it); BERT-large's gradients of the MLM loss (gather budget 0.25) on the
    same shape through the train path, no step, BERT_FULL_ROWS rows
    full-length (each leaf within PARITY_GRAD_TOL of the CPU's, the norm
    floored at GRAD_FLOOR of the largest leaf's; delta left out of C and
    of D, D's last q tile skipped and the mask dropped in the backward
    above it); the same for a sparse BERT
    (replace_self_attention, BigBird block 128, bidirectional) at S 1024,
    A, C and D walking the layout at Hd 64 (the layout ignored above the
    limit); CLIP ViT-L/14's text [8, 77] and vision [4, 224, 224, 3]
    hidden states and pooled outputs (LOGIT_ULP_TOL; text run non-causal
    and vision run causal above it)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          replace_self_attention)
    failures = []
    rec, f = _bert_parity_forward(seed)
    emit("encoder_parity", check="bert_forward", **rec)
    failures += f
    # D's faults: delta left out of dk, and the last q tile left out of dk
    # and dv, which reads only where a row's last tile holds masked labels:
    # BERT_FULL_ROWS of the gradient batch are full-length
    grad_faults = {f: (lambda f=f: _planted(f), "worst")
                   for f in ("dq_delta_not_subtracted", "dkv_delta_not_subtracted",
                             "dkv_last_q_tile_skipped")}
    grad_faults["mask_dropped_in_backward"] = (_mask_dropped_in_backward, "worst")
    for name, model, B, S, faults in (
            ("bert_grads", bert_large(1, remat=False, mlm_gather_budget=BERT_BUDGET),
             BERT_PARITY_BATCH, BERT_SEQ, grad_faults),
            ("sparse_bert_grads",
             replace_self_attention(bert_large(1, remat=False, mlm_gather_budget=BERT_BUDGET),
                                    BigBirdSparsityConfig(num_heads=bert_large(1).config.n_head,
                                                          block=128),
                                    max_seq=BERT_SPARSE_SEQ),
             2, BERT_SPARSE_SEQ, {"layout_ignored": (_layout_ignored, "worst")})):
        try:
            _train_parity(f"encoder_parity_{name}", seed, model, B, S, faults, steps=0,
                          grad_floor=GRAD_FLOOR, prepare=attention_weighted,
                          batch_fn=lambda rng, B=B, S=S, V=model.config.vocab_size: mlm_batch(
                              V, B, S, int(rng.integers(1 << 30)), full_rows=BERT_FULL_ROWS)[0])
        except RuntimeError as e:
            failures.append(str(e))
    rec, f = _clip_parity(seed)
    emit("encoder_parity", check="clip_forward", **rec)
    failures += f
    check(not failures, "encoder_parity failed: " + "; ".join(failures))


def bert_serve_launch_rule(n_layer, batches):
    """bert_serve's launches: A once a layer a batch forward; no backward,
    no fused CE, no decode kernel."""
    return {"flash_attention_fwd": n_layer * batches, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_ce_fwd": 0, "fused_ce_ds": 0,
            "fused_ce_dh_gemm": 0, "fused_ce_dw_gemm": 0}


def clip_launch_rule(text_layers, vision_layers, text_batches, image_batches):
    """clip_encode's launches of A in each tower: one a layer a batch."""
    return {"text": text_layers * text_batches, "image": vision_layers * image_batches}


def bert_train_launch_rule(engine):
    """bert_train's launches a step (gas 1, no remat, fused CE on): A, C and
    D once a layer, F, G, dh and dW once, E once a port leaf (16 a layer
    and 12 others: the embeddings' 5, the pooler's 2, the MLM head's 5)."""
    cfg = engine.module.config
    leaves = len(list(engine.state.params.parameters()))
    check(leaves == 16 * cfg.n_layer + 12, f"{leaves} parameter leaves")
    return {"flash_attention_fwd": cfg.n_layer, "flash_attention_bwd_dq": cfg.n_layer,
            "flash_attention_bwd_dkv": cfg.n_layer, "fused_adam": leaves,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"), 1)}


def _serve_batches(requests, size):
    """Fill-mask requests (id rows of their own lengths) in batches of
    ``size``, each padded with 0 to its longest row: (input_ids,
    attention_mask) numpy pairs."""
    import numpy as np
    out = []
    for i in range(0, len(requests), size):
        rows = requests[i:i + size]
        S = max(len(r) for r in rows)
        ids = np.zeros((len(rows), S), np.int64)
        mask = np.zeros((len(rows), S), np.int64)
        for j, r in enumerate(rows):
            ids[j, :len(r)] = r
            mask[j, :len(r)] = 1
        out.append((ids, mask))
    return out


def _launch_counts():
    return {k: v for k, v in _train_counters().items()
            if k.startswith(("flash", "fused_ce"))}


def _disk_check(need_bytes):
    os.makedirs(ENCODER_DIR, exist_ok=True)
    free = shutil.disk_usage(ENCODER_DIR).free
    check(free > 2 * need_bytes, f"{free / 1e9:.1f} GB free under {ENCODER_DIR}, "
          f"{2 * need_bytes / 1e9:.1f} GB needed")
    return free


def phase_bert_serve(state, seed):
    """BERT-large at full depth (24 layers) served from an HF checkpoint: a
    BertForMaskedLM-layout safetensors checkpoint of seeded fp32 weights
    (1.34 GB, no pooler) written under ENCODER_DIR and loaded by
    init_inference(<dir>, dtype="bf16") through BertPolicy; 64 fill-mask
    requests of seeded lengths 32..512 (15 % of their inner positions
    [MASK]) in padded batches of 16 with an attention mask: sequences/s,
    valid tokens/s, ms a batch p50 / max, peak memory. Gates: the loaded
    leaves bit-equal to the in-memory engine's on the same weights, the
    top-1 id at every masked position equal to that engine's (limit 0), A
    = 24 x batches with C, D and the fused CE at 0, generate refused with
    the encoder ValueError."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    model = bert_large()
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
    for leaf in params["pooler"].parameters():      # a BertForMaskedLM has no pooler
        leaf.data.zero_()
    entries = bert_hf_entries(params, torch.float32)
    need = sum(_nbytes(e[1], e[2]) for e in entries)
    free = _disk_check(need)
    d = os.path.join(ENCODER_DIR, "bert-large")
    failures = []
    try:
        t0 = time.perf_counter()
        written = write_hf_checkpoint(d, bert_hf_config(model.config), entries)
        write_s = time.perf_counter() - t0
        del entries
        t0 = time.perf_counter()
        engine = deepspeed_tpu_torch.init_inference(d, dtype=ENCODER_DTYPE, device=CHECK_DEVICE)
        _sync()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    ref = deepspeed_tpu_torch.init_inference(model, params=params, dtype=ENCODER_DTYPE,
                                             device=CHECK_DEVICE)
    del params
    _free()
    check(type(engine.module).__name__ == "BertModel", f"loaded {type(engine.module).__name__}")
    unequal = _equal_leaves(engine.params, ref.params)
    if unequal:
        failures.append(f"loaded leaves differ from the in-memory engine's: {unequal[:5]}")
    rng = np.random.default_rng(seed + 41)
    lengths = rng.integers(32, BERT_SEQ + 1, size=BERT_SERVE_REQUESTS)
    batch, _ = mlm_batch(model.config.vocab_size, BERT_SERVE_REQUESTS, BERT_SEQ, seed + 42,
                         lengths=lengths)
    requests = [batch["input_ids"][i, :n] for i, n in enumerate(lengths)]
    batches = _serve_batches(requests, BERT_SERVE_BATCH)
    with torch.no_grad():
        engine.forward(batches[0][0], attention_mask=batches[0][1])      # warm-up
        _sync()
        _reset_peak()
        _reset_train_counters()
        ms, top1 = [], []
        t_all = time.perf_counter()
        for ids, mask in batches:
            t = time.perf_counter()
            logits = engine.forward(ids, attention_mask=mask)
            top1.append(logits.argmax(-1))
            _sync()
            ms.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t_all
        launches = _launch_counts()
        peak = _peak_gb()
        ref_top1 = [ref.forward(ids, attention_mask=mask).argmax(-1) for ids, mask in batches]
    rule = bert_serve_launch_rule(model.config.n_layer, len(batches))
    if CHECK_DEVICE == "cuda" and {k: launches[k] for k in rule} != rule:
        failures.append(f"launches {launches} != rule {rule}")
    masked_pos = [torch.as_tensor(ids == BERT_MASK).to(t.device) for (ids, _), t in
                  zip(batches, top1)]
    differ = sum(int((a[m] != b[m]).sum()) for a, b, m in zip(top1, ref_top1, masked_pos))
    n_masked = sum(int(m.sum()) for m in masked_pos)
    if differ:
        failures.append(f"{differ} of {n_masked} masked positions' top-1 differ from the "
                        "in-memory engine's")
    refusal = None
    try:
        engine.generate(batches[0][0][:1, :8], max_new_tokens=2)
        failures.append("generate ran on a BertModel")
    except ValueError as e:
        refusal = str(e)
        if "is an encoder" not in refusal:
            failures.append(f"generate refused with {refusal!r}")
    del engine, ref
    _free()
    state["bert_serve_launches"] = {"flash_attention_fwd_bert": launches["flash_attention_fwd"]}
    valid_tokens = int(sum(lengths))
    emit("bert_serve", layers=model.config.n_layer, requests=BERT_SERVE_REQUESTS,
         batch=BERT_SERVE_BATCH, padded_lengths=[int(ids.shape[1]) for ids, _ in batches],
         valid_tokens=valid_tokens, masked_positions=n_masked, top1_differ=differ,
         sequences_per_s=BERT_SERVE_REQUESTS / wall, valid_tokens_per_s=valid_tokens / wall,
         batch_ms=ms, batch_ms_p50=float(np.percentile(ms, 50)),
         batch_ms_max=float(max(ms)), peak_mem_gb=peak,
         checkpoint_bytes=written, write_s=write_s, load_s=load_s,
         load_gbps=written / load_s / 1e9, disk_free_gb=free / 1e9, launches=launches,
         launch_rule=rule, generate_refused=refusal)
    check(not failures, "bert_serve failed: " + "; ".join(failures))


def phase_bert_train(state, seed):
    """BERT-large MLM pre-training at full depth as the JAX bench builds it
    (bench.py build_bert_bench_engine): micro 32 x S 512, gas 1, AdamW (lr
    1e-4, wd 0.01), bf16, no remat, fused CE "auto", mlm_gather_budget 0.25,
    seeded bf16 weights drawn on the card; one seeded batch (a quarter of
    its rows padded, 15 % of inner positions masked), 1 warm-up + 5 timed
    steps: step ms, tokens/s, MFU from flops_per_token(512) against the
    card's peak, peak memory. Gates: losses finite, the last below the
    first; per step the launch rule (A, C, D 24, F, G, dh, dW once, E
    once a port leaf)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    model = bert_large(remat=False, mlm_gather_budget=BERT_BUDGET)
    config = {"train_batch_size": BERT_MICRO, "train_micro_batch_size_per_gpu": BERT_MICRO,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": ENCODER_DTYPE == "bf16"}, "fused_cross_entropy": "auto"}
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE,
                               dtype=torch.bfloat16 if ENCODER_DTYPE == "bf16" else torch.float32)
    _reset_peak()
    engine = _train_engine(model, params, config, device=CHECK_DEVICE)
    del params
    B = BERT_MICRO
    lengths = np.full(B, BERT_SEQ)
    rng = np.random.default_rng(seed + 51)
    padded = rng.choice(B, B // 4, replace=False)
    lengths[padded] = rng.integers(64, BERT_SEQ, size=B // 4)
    batch, _ = mlm_batch(model.config.vocab_size, B, BERT_SEQ, seed + 52, lengths=lengths)
    batch = {k: torch.as_tensor(v, device=CHECK_DEVICE) for k, v in batch.items()}
    rule = bert_train_launch_rule(engine)
    losses, step_s, per_step = _timed_steps(engine, batch, TRAIN_STEPS)
    peak = _peak_gb()
    failures = []
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses}")
    if CHECK_DEVICE == "cuda":
        for i, s in enumerate(per_step):
            got = {k: s[k] for k in rule}
            if got != rule:
                failures.append(f"step {i + 1} launches {got} != rule {rule}")
    timed = step_s[1:]
    step_ms = float(np.median(timed)) * 1e3
    tokens = B * BERT_SEQ
    peak_tflops = get_accelerator(CHECK_DEVICE).peak_tflops()
    fpt = model.flops_per_token(BERT_SEQ)
    mfu = (tokens / (step_ms / 1e3)) * fpt / (peak_tflops * 1e12) if peak_tflops else None
    state["bert_train_launches"] = {
        f"{k}_bert": sum(s[k] for s in per_step)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                  "fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm", "fused_ce_dw_gemm")}
    state["bert_train_launches"]["fused_adam"] = sum(s["fused_adam"] for s in per_step)
    emit("bert_train", layers=model.config.n_layer, batch=[B, BERT_SEQ],
         lengths_padded=sorted(int(x) for x in lengths[padded]),
         masked_labels=int((batch["labels"] != -100).sum()),
         gather_k=-(-round(BERT_BUDGET * B * BERT_SEQ) // 128) * 128,
         params=sum(p.numel() for p in engine.state.params.parameters()), losses=losses,
         step_ms=[s * 1e3 for s in step_s], step_ms_median=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3), flops_per_token=fpt, peak_tflops=peak_tflops,
         mfu=mfu, peak_mem_gb=peak, launches_per_step=per_step, launch_rule=rule)
    del engine
    _free()
    check(not failures, "bert_train failed: " + "; ".join(failures))


def phase_clip_encode(state, seed):
    """CLIP ViT-L/14 at full depth (text 12 layers, vision 24) through an HF
    checkpoint: a CLIPModel-layout safetensors checkpoint of seeded fp32
    weights (1.71 GB) written under ENCODER_DIR, loaded by
    init_inference(<dir>, dtype="bf16") through CLIPPolicy into a
    DSClipEncoder; 64 prompts padded with EOT to 77 (batches of 16) and 32
    seeded images (batches of 8): prompts/s, images/s, ms a batch, peak
    memory. Gates: the loaded leaves bit-equal to the in-memory tree's,
    hidden states and pooled features of both towers equal to the
    in-memory encoders' (limit 0), A = 12 a text batch and 24 an image
    batch."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import ParamTree
    enc = clip_l14()
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    tree = ParamTree({"text": enc.text.init_params(gen, device=CHECK_DEVICE).to_dict(),
                      "vision": enc.vision.init_params(gen, device=CHECK_DEVICE).to_dict(),
                      "logit_scale": torch.tensor(CLIP_L14_HF["logit_scale_init_value"],
                                                  device=CHECK_DEVICE)})
    entries = clip_hf_entries(tree, torch.float32, enc.vision.config.patch_size)
    need = sum(_nbytes(e[1], e[2]) for e in entries)
    free = _disk_check(need)
    d = os.path.join(ENCODER_DIR, "clip-vit-large-patch14")
    try:
        t0 = time.perf_counter()
        written = write_hf_checkpoint(d, clip_hf_config(enc), entries)
        write_s = time.perf_counter() - t0
        del entries
        t0 = time.perf_counter()
        engine = deepspeed_tpu_torch.init_inference(d, dtype=ENCODER_DTYPE, device=CHECK_DEVICE)
        _sync()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    failures = []
    loaded = engine.module
    check(type(loaded).__name__ == "DSClipEncoder", f"loaded {type(loaded).__name__}")
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[ENCODER_DTYPE]
    ref_params = tree.map(lambda t: t.to(CHECK_DEVICE, dt))
    del tree
    unequal = _equal_leaves(engine.params, ref_params)
    if unequal:
        failures.append(f"loaded leaves differ from the in-memory tree's: {unequal[:5]}")
    prompts = clip_prompts(CLIP_PROMPTS, seed + 61, enc.text.config.max_seq)
    images = clip_images(CLIP_IMAGES, seed + 62, enc.vision.config.image_size)
    text_b = [prompts[i:i + CLIP_TEXT_BATCH] for i in range(0, len(prompts), CLIP_TEXT_BATCH)]
    image_b = [images[i:i + CLIP_IMAGE_BATCH] for i in range(0, len(images), CLIP_IMAGE_BATCH)]
    p = engine.params
    loaded.encode_text(p["text"], text_b[0])
    loaded.encode_image(p["vision"], image_b[0])           # warm-up
    _sync()
    _reset_peak()
    _reset_train_counters()

    def timed(fn, batches, params):
        outs, ms = [], []
        for x in batches:
            t = time.perf_counter()
            outs.append(fn(params, x))
            _sync()
            ms.append((time.perf_counter() - t) * 1e3)
        return outs, ms

    text_out, text_ms = timed(loaded.encode_text, text_b, p["text"])
    a_text = _launch_counts()["flash_attention_fwd"]
    image_out, image_ms = timed(loaded.encode_image, image_b, p["vision"])
    launches = _launch_counts()
    a_image = launches["flash_attention_fwd"] - a_text
    peak = _peak_gb()
    ref = clip_l14()
    differ = {}
    for name, outs, fn, sub, batches in (
            ("text", text_out, ref.encode_text, ref_params["text"], text_b),
            ("image", image_out, ref.encode_image, ref_params["vision"], image_b)):
        bad = 0
        for got, x in zip(outs, batches):
            want = fn(sub, x)
            bad += sum(int((g != w).sum()) for g, w in zip(got, want))
        differ[name] = bad
        if bad:
            failures.append(f"{name}: {bad} elements differ from the in-memory encoder's")
    rule = clip_launch_rule(enc.text.config.n_layer, enc.vision.config.n_layer, len(text_b),
                            len(image_b))
    if CHECK_DEVICE == "cuda" and {"text": a_text, "image": a_image} != rule:
        failures.append(f"A launched {a_text} times for text, {a_image} for images; "
                        f"rule {rule}")
    state["clip_encode_launches"] = {"flash_attention_fwd_clip_text": a_text,
                                     "flash_attention_fwd_clip_vision": a_image}
    del engine, ref_params, text_out, image_out
    _free()
    emit("clip_encode", text_layers=enc.text.config.n_layer,
         vision_layers=enc.vision.config.n_layer, prompts=CLIP_PROMPTS,
         text_batch=CLIP_TEXT_BATCH, images=CLIP_IMAGES, image_batch=CLIP_IMAGE_BATCH,
         prompts_per_s=CLIP_PROMPTS / (sum(text_ms) / 1e3),
         images_per_s=CLIP_IMAGES / (sum(image_ms) / 1e3), text_batch_ms=text_ms,
         image_batch_ms=image_ms, peak_mem_gb=peak, elements_differ=differ,
         checkpoint_bytes=written, write_s=write_s, load_s=load_s, disk_free_gb=free / 1e9,
         launches=launches, launch_rule=rule)
    check(not failures, "clip_encode failed: " + "; ".join(failures))


# ----------------------------------------------------------------------- #
# compression: QAT fake-quant, pruning, layer reduction, the MoQ eigenvalue
# schedule (compress_parity, compress_train, moq_eigenvalue)

COMPRESS_STUDENT_LAYERS = 12            # BERT-large's 24 reduced to every second layer
COMPRESS_STEPS = 6
COMPRESS_SERVE_REQUESTS = 16            # one fill-mask batch of the served student
COMPRESS_GROUPS = 64                    # weight quant groups over each flattened stacked leaf
COMPRESS_CONFIG = {"compression_training": {
    "layer_reduction": {"enabled": True, "keep_number_layer": COMPRESS_STUDENT_LAYERS,
                        "teacher_layer": list(range(1, 24, 2))},
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "quantize_groups": COMPRESS_GROUPS,
                              "quantization_type": "symmetric", "schedule_offset": 0},
        "different_groups": {"wq": {"params": {"start_bits": 8, "target_bits": 8},
                                    "modules": ["attn", "mlp"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "method": "l1", "schedule_offset": 4},
        "different_groups": {"sp": {"params": {"dense_ratio": 0.5}, "modules": ["mlp"]}}}}}
# activation fake-quant (a causal LM's: the JAX package's BertConfig has no
# act_quant_bits, so init_compression refuses it on a BertModel in both
# packages); 4 bits in the parity check, where the MLP's fake-quant left
# out must move fp32 logits past LOGIT_ULP_TOL, 8 in the engine run
COMPRESS_ACT = lambda bits, offset=0: {"activation_quantization": {
    "shared_parameters": {"enabled": True, "quantization_type": "symmetric",
                          "range_calibration": "dynamic", "schedule_offset": offset},
    "different_groups": {"aq": {"params": {"bits": bits}}}}}
COMPRESS_PARITY_ACT_BITS = 4
# the forward check's MLP weights x this (1: at BERT-large's width the MLP's
# output is of the residual's size, so the sparse mask left out shows)
COMPRESS_MLP_SCALE = 1.0
COMPRESS_LLAMA_PARITY = (2, 256)        # the act-quant forward's rows, fp32 on both sides
COMPRESS_ACT_STEPS = 3                  # the act-quant engine run: offset 1 of 3 steps
COMPRESS_ACT_SEQ = 512
EV_PARITY_BATCH = (2, 128)              # _power_iterate card vs CPU: BERT-large width, 1 layer
EV_PARITY_ITERS = 5
EV_ITER_TOL = 1e-3                      # each iteration's eigenvalue, relative
# moq_eigenvalue: BERT-large at 24 layers in fp32 (the JAX engine's HVP
# refuses bf16 params), plain attention, micro-batch cut 32 -> 2 for the
# double backward's time and memory
MOQ_EV_MICRO = 2
MOQ_EV_STEPS = 2
MOQ_EV_MAX_ITER = 2
MOQ_EV_CONFIG = {"enabled": True, "quantize_groups": 64,
                 "quantize_bits": {"start_bits": 12, "target_bits": 8},
                 "quantize_schedule": {"quantize_period": 1},
                 "quantize_algo": {"q_type": "symmetric", "q_rounding": "stochastic"},
                 "eigenvalue": {"enabled": True, "max_iter": MOQ_EV_MAX_ITER, "tol": 1e-2,
                                "layer_name": "layers", "layer_num": 24}}


def compress_llama(n_layer=1, **over):
    """Llama-2-7B's configuration at ``n_layer`` layers (the compression
    parity's causal LM; ``over``: TransformerConfig fields)."""
    import dataclasses
    from deepspeed_tpu_torch.models import CausalLM, llama
    base = llama("7b", n_layer=n_layer)
    return CausalLM(dataclasses.replace(base.config, **over)) if over else base


def _tree_leaves(tree):
    """A param tree's tensors by name (compress_params returns nested dicts)."""
    from deepspeed_tpu_torch.models.transformer import ParamTree
    tree = tree if isinstance(tree, ParamTree) else ParamTree(tree)
    return dict(tree.named_parameters())


def tree_mismatch(got, want):
    """Elements of ``got``'s leaves that differ from ``want``'s (bit for bit,
    on the CPU), and the leaves they lie in."""
    import torch
    g, w = _tree_leaves(got), _tree_leaves(want)
    check(g.keys() == w.keys(), "the trees' leaves differ")
    bad = {n: int((g[n].detach().cpu() != w[n].detach().cpu()).sum()) for n in g
           if g[n].dtype == w[n].dtype and not torch.equal(g[n].detach().cpu(),
                                                           w[n].detach().cpu())}
    bad.update({n: g[n].numel() for n in g if g[n].dtype != w[n].dtype})
    return sum(bad.values()), sorted(bad)[:4]


@contextlib.contextmanager
def planted_compress_fault(fault):
    """A compression fault inside the ``with`` body: the sparse / row /
    channel threshold taken at k + 1 ("threshold_k_plus_1"), the sparse
    mask not applied ("sparse_mask_left_out"), the STE's gradient zero
    ("ste_zero_gradient"), or the MLP's activation fake-quant left out
    ("mlp_act_quant_left_out")."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch.compression import functional as cf
    from deepspeed_tpu_torch.models import transformer as T
    if fault == "threshold_k_plus_1":
        mod, name = cf, "_kth_largest"
        real = cf._kth_largest
        faulted = lambda x, k: real(x, k + 1)
    elif fault == "sparse_mask_left_out":
        mod, name = cf, "sparse_mask"
        real = cf.sparse_mask
        faulted = lambda w, ratio: torch.ones_like(w)
        cf._MASK_FNS["sparse"] = faulted
    elif fault == "ste_zero_gradient":
        mod, name = cf._FakeQuantize, "backward"
        real = cf._FakeQuantize.__dict__["backward"]
        faulted = staticmethod(lambda ctx, g: (torch.zeros_like(g), None, None, None))
    else:
        mod, name = T, "mlp"
        real = T.mlp
        faulted = lambda cfg, x, lp: real(dataclasses.replace(cfg, act_quant_bits=0), x, lp)
    setattr(mod, name, faulted)
    try:
        yield
    finally:
        setattr(mod, name, real)
        cf._MASK_FNS["sparse"] = cf.sparse_mask


def _compress_leaves(model, params, cfg, fault=None):
    """compress_params of ``params`` under ``cfg`` (no autograd), optionally
    inside a planted fault."""
    import torch
    from deepspeed_tpu_torch.compression import init_compression
    wrapped = init_compression(model, cfg)
    with torch.no_grad(), (planted_compress_fault(fault) if fault
                           else contextlib.nullcontext()):
        return wrapped.compress_params(params)


def _compress_technique_configs():
    """Every technique alone (fp32) and the compress_train path's (bf16)."""
    g = lambda tech, params, modules=None, **shared: {"compression_training": {tech: {
        "shared_parameters": {"enabled": True, "schedule_offset": 0, **shared},
        "different_groups": {"g": {"params": params,
                                   **({"modules": modules} if modules else {})}}}}}
    return {"wq_sym_grouped": g("weight_quantization", {"start_bits": 8},
                                quantize_groups=COMPRESS_GROUPS),
            "wq_asym_4bit_attn": g("weight_quantization", {"start_bits": 4}, ["attn"],
                                   quantization_type="asymmetric"),
            "sparse_mlp": g("sparse_pruning", {"dense_ratio": 0.5}, ["mlp"]),
            "row_w_up": g("row_pruning", {"dense_ratio": 0.5}, ["w_up"]),
            "channel_mlp": g("channel_pruning", {"dense_ratio": 0.5}, ["mlp"])}


def _compress_leaf_parity(name, model, params, failures, techniques, path_dtype):
    """Card against CPU, bit for bit: each technique's compress_params in
    fp32, the compress_train path's (without layer reduction) in
    ``path_dtype``, the sparse threshold taken at k + 1 above 0; head
    pruning raising alike on the stacked leaf."""
    import torch
    path = {"compression_training": {k: v for k, v in COMPRESS_CONFIG[
        "compression_training"].items() if k != "layer_reduction"}}
    rec = {}
    cpu = params.map(lambda t: t.to("cpu"))
    for tech, cfg in {**techniques, "path_" + str(path_dtype).split(".")[-1]: path}.items():
        dt = path_dtype if tech.startswith("path") else torch.float32
        p_gpu, p_cpu = params.map(lambda t: t.to(dt)), cpu.map(lambda t: t.to(dt))
        n_bad, where = tree_mismatch(_compress_leaves(model, p_gpu, cfg),
                                     _compress_leaves(model, p_cpu, cfg))
        rec[tech] = {"elements_differing": n_bad, "leaves": where}
        if n_bad:
            failures.append(f"{name} {tech}: {n_bad} elements differ from the CPU's in {where}")
        if tech.startswith("sparse"):
            # after the fake-quant (the path) the k-th and (k+1)-th largest
            # magnitudes are often one grid level, so the fault is read here
            n_fault, _ = tree_mismatch(_compress_leaves(model, p_gpu, cfg, "threshold_k_plus_1"),
                                       _compress_leaves(model, p_cpu, cfg))
            rec[tech]["fault_threshold_k_plus_1"] = n_fault
            if not n_fault > 0:
                failures.append(f"{name} {tech}: the k + 1 threshold reads 0 elements")
        del p_gpu, p_cpu
    raised = []
    for p in (params, cpu):
        try:
            _compress_leaves(model, p, {"compression_training": {"head_pruning": {
                "shared_parameters": {"enabled": True},
                "different_groups": {"h": {"params": {"dense_ratio": 0.5, "num_heads": 16},
                                           "modules": ["attn.wo"]}}}}})
            raised.append(None)
        except Exception as e:          # the JAX package's ZeroDivisionError on [L, H*Hd, D]
            raised.append(type(e).__name__)
    rec["head_pruning_stacked_raises"] = raised
    if raised[0] is None or raised[0] != raised[1]:
        failures.append(f"{name}: head pruning on the stacked leaf raised {raised} (card, CPU)")
    return rec


def _bert_compress_forward(seed, failures):
    """The compressed BERT's MLM logits (the path's weight quant and
    sparsity, 1 layer at BERT-large's width, the encoder_parity batch): the
    card in bf16 against the CPU in fp32 on the same bf16-rounded weights,
    every valid position within LOGIT_ULP_TOL; the sparse mask left out on
    the card above it."""
    import torch
    from deepspeed_tpu_torch.compression import init_compression
    path = {"compression_training": {k: v for k, v in COMPRESS_CONFIG[
        "compression_training"].items() if k != "layer_reduction"}}
    model = bert_large(1)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 61)
    params = attention_weighted(model.init_params(gen, device=CHECK_DEVICE,
                                                  dtype=torch.float32))
    with torch.no_grad():
        for lp in params["layers"]:
            for key in ("w_up", "w_down"):
                lp["mlp"][key].mul_(COMPRESS_MLP_SCALE)
    params = params.map(lambda t: t.to(torch.bfloat16))
    cpu = params.map(lambda t: t.to("cpu", torch.float32))
    batch, _ = mlm_batch(model.config.vocab_size, BERT_PARITY_BATCH, BERT_SEQ, seed + 21)
    ids, mask = (torch.as_tensor(batch[k]) for k in ("input_ids", "attention_mask"))
    valid = mask > 0
    wrapped = init_compression(model, path)
    run = lambda p, dev: wrapped.forward(p, ids.to(dev), mask.to(dev))[valid.to(dev)] \
        .float().cpu()
    with torch.no_grad():
        want = run(cpu, "cpu")
        got = run(params, CHECK_DEVICE)
        with planted_compress_fault("sparse_mask_left_out"):
            fault = run(params, CHECK_DEVICE)
    rec, f = logit_parity(got, want, {"sparse_mask_left_out": fault})
    failures += [f"bert forward: {x}" for x in f]
    return rec


def _llama_act_quant_forward(seed, failures):
    """1 layer at Llama-2-7B's width, fp32 with plain attention on both
    sides, the path's weight quant and sparsity and
    COMPRESS_PARITY_ACT_BITS-bit activation fake-quant: the card's
    compress_params leaves bit-equal to the CPU's; the logits of the
    compressed forward on them (the quantizers' inputs agree to fp32
    rounding, so few round to another level) within LOGIT_ULP_TOL of the
    CPU's; the MLP's fake-quant left out above it."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.compression import init_compression
    model = compress_llama(1, attention_backend="xla", remat=False)
    cfg = {"compression_training": {
        **{k: v for k, v in COMPRESS_CONFIG["compression_training"].items()
           if k != "layer_reduction"}, **COMPRESS_ACT(COMPRESS_PARITY_ACT_BITS)}}
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 62)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
    wrapped = init_compression(model, cfg)
    check(wrapped.model.config.act_quant_bits == COMPRESS_PARITY_ACT_BITS, "act quant not wired")
    with torch.no_grad():
        got_p = wrapped.compress_params(params)
        want_p = wrapped.compress_params(params.map(lambda t: t.to("cpu")))
    n_bad, where = tree_mismatch(got_p, want_p)
    if n_bad:
        failures.append(f"llama path fp32: {n_bad} elements differ from the CPU's in {where}")
    B, S = COMPRESS_LLAMA_PARITY
    ids = torch.as_tensor(np.random.default_rng(seed + 63).integers(
        0, model.config.vocab_size, (B, S)))
    run = lambda p, dev: wrapped.model.forward(p, ids.to(dev)).reshape(B * S, -1).float().cpu()
    with torch.no_grad():
        want = run(want_p, "cpu")
        got = run(got_p, CHECK_DEVICE)
        with planted_compress_fault("mlp_act_quant_left_out"):
            fault = run(got_p, CHECK_DEVICE)
    r, f = logit_parity(got, want, {"mlp_act_quant_left_out": fault})
    failures += [f"llama act-quant forward: {x}" for x in f]
    del params, got_p, want_p
    _free()
    return {"leaves_fp32_differing": n_bad, "forward": {**r, "batch": [B, S],
                                                        "act_bits": COMPRESS_PARITY_ACT_BITS}}


def _act_quant_engine_run(seed, failures):
    """The activation-quant transition through the engine on the card: 1
    layer at Llama-2-7B's width, bf16, kernels, act quant (8 bits) from
    step 2 of 3: losses finite; per step A 2 (remat), C 1, D 1 and each
    fused CE kernel once, before and after the transition."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.compression import CompressionScheduler, init_compression
    wrapped = init_compression(compress_llama(1), {"compression_training": COMPRESS_ACT(
        8, offset=1)})
    sched = CompressionScheduler(wrapped)
    config = {**TRAIN_CONFIG, "train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 1}
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 64)
    engine = _train_engine(wrapped, wrapped.init_params(gen, device=CHECK_DEVICE,
                                                        dtype=torch.bfloat16),
                           config, device=CHECK_DEVICE)
    batch = {"input_ids": torch.as_tensor(np.random.default_rng(seed + 65).integers(
        0, wrapped.config_model.vocab_size, (2, COMPRESS_ACT_SEQ)), device=CHECK_DEVICE)}
    bits, per_step, losses = [], [], []
    for _ in range(COMPRESS_ACT_STEPS):
        bits.append(wrapped.model.config.act_quant_bits)
        l, _, s = _timed_steps(engine, batch, 1)
        losses += l
        per_step += s
        sched.step()
    rule = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"), 1)}
    if bits != [0] + [8] * (COMPRESS_ACT_STEPS - 1):
        failures.append(f"act quant bits by step {bits}")
    if not all(np.isfinite(losses)):
        failures.append(f"act-quant run losses {losses}")
    if CHECK_DEVICE == "cuda":
        for i, s in enumerate(per_step):
            if {k: s[k] for k in rule} != rule:
                failures.append(f"act-quant run step {i + 1} launches {s} != {rule}")
    del engine
    _free()
    return {"act_bits_by_step": bits, "losses": losses, "launch_rule": rule,
            "launches_per_step": [{k: s[k] for k in rule} for s in per_step]}


def _eigen_parity(seed, failures):
    """Eigenvalue._power_iterate from one seeded v0 over EV_PARITY_ITERS
    iterations (tol 0), block layer 0 of BERT-large's width at 1 layer,
    fp32, plain attention: each iteration's eigenvalue on the card within
    EV_ITER_TOL of the CPU's; the mask not applied to the HVP (the whole
    Hessian's iteration) above it."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue, hvp_model
    model = hvp_model(bert_large(1, remat=False))
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 66)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
    B, S = EV_PARITY_BATCH
    batch, _ = mlm_batch(model.config.vocab_size, B, S, seed + 67, full_rows=B)
    names = [n for n, _ in params.named_parameters()]
    r = np.random.default_rng(seed + 68)
    v0 = {n: torch.as_tensor(r.standard_normal(tuple(p.shape)).astype(np.float32))
          for n, p in params.named_parameters()}

    def iterate(p, dev, masked=True):
        for t in p.parameters():
            t.requires_grad_(True)
        ev = Eigenvalue(max_iter=EV_PARITY_ITERS, tol=0.0)
        mask = ev.layer_masks(p, "layers", 1)[0] if masked else dict.fromkeys(names, 1.0)
        named = dict(p.named_parameters())
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        hvp = ev._hvp_fn(lambda q: model.loss(q, b), [named[n] for n in names])
        hist = []
        ev._power_iterate(hvp, p, [v0[n].to(dev) for n in names], [mask[n] for n in names],
                          1.0, history=hist)
        return hist

    want = iterate(params.map(lambda t: t.to("cpu")), "cpu")
    got = iterate(params, CHECK_DEVICE)
    fault = iterate(params, CHECK_DEVICE, masked=False)
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    fault_rel = max(abs(g - w) / abs(w) for g, w in zip(fault, want))
    if not (len(got) == EV_PARITY_ITERS and max(rel) <= EV_ITER_TOL):
        failures.append(f"power iteration differs from the CPU's by {rel}")
    if not fault_rel > EV_ITER_TOL:
        failures.append(f"planted fault mask_not_applied reads {fault_rel}")
    del params
    _free()
    return {"batch": [B, S], "iterations": EV_PARITY_ITERS, "card": got, "cpu": want,
            "rel_diff": rel, "tol": EV_ITER_TOL, "fault_mask_not_applied_rel": fault_rel}


def phase_compress_parity(state, seed):
    """The compression path, card against CPU. 1 layer at BERT-large's
    width: every technique's compress_params leaves in fp32 and the
    compress_train path's in bf16 (weight quant and sparsity on the stacked
    leaves), redundancy_clean, and student_initialization (2 layers -> 1),
    bit-equal (limit 0; the threshold taken at k + 1 above it; head pruning
    raising alike on the stacked leaf); the compressed MLM logits on [4,
    512] within LOGIT_ULP_TOL; each leaf's gradient of the compressed MLM
    loss within PARITY_GRAD_TOL by the encoder_parity rule (an STE with a
    zero gradient above it). 1 layer at Llama-2-7B's width: the path's
    leaves in bf16 bit-equal, the act-quant forward (fp32) within
    LOGIT_ULP_TOL (the MLP's fake-quant left out above it), and the
    activation-quant transition through the engine with its launches.
    Eigenvalue._power_iterate: each of 5 iterations within EV_ITER_TOL (the
    mask not applied to the HVP above it)."""
    import torch
    from deepspeed_tpu_torch.compression import (init_compression, redundancy_clean,
                                                 student_initialization)
    failures = []
    model = bert_large(1)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 60)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
    leaves = _compress_leaf_parity("bert", model, params, failures,
                                   _compress_technique_configs(), torch.bfloat16)
    path = {"compression_training": {k: v for k, v in COMPRESS_CONFIG[
        "compression_training"].items() if k != "layer_reduction"}}
    with torch.no_grad():
        clean, _ = tree_mismatch(redundancy_clean(params, path),
                                 redundancy_clean(params.map(lambda t: t.to("cpu")), path))
        teacher = bert_large(2).init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
        lr_cfg = {"compression_training": {"layer_reduction": {
            "enabled": True, "keep_number_layer": 1, "teacher_layer": [1]}}}
        student = init_compression(bert_large(2), lr_cfg).init_params(gen, device=CHECK_DEVICE)
        s_gpu = student_initialization(student, teacher, lr_cfg)
        s_cpu = student_initialization(student.map(lambda t: t.to("cpu")),
                                       teacher.map(lambda t: t.to("cpu")), lr_cfg)
        init_bad, _ = tree_mismatch(s_gpu, s_cpu)
        copied = torch.equal(s_gpu["layers"][0]["attn"]["wq"], teacher["layers"][1]["attn"]["wq"])
    if clean or init_bad or not copied:
        failures.append(f"redundancy_clean {clean} / student_initialization {init_bad} elements "
                        f"differ from the CPU's; teacher layer 1 copied: {copied}")
    del params, teacher, student, s_gpu, s_cpu
    _free()
    emit("compress_parity", check="bert_leaves", layers=1, techniques=leaves,
         redundancy_clean_differing=clean, student_init_differing=init_bad)
    emit("compress_parity", check="bert_forward", **_bert_compress_forward(seed, failures))
    wrapped = init_compression(bert_large(1, remat=False, mlm_gather_budget=BERT_BUDGET), path)
    try:
        # bf16-rounded fp32 weights on both sides: the card's bf16 cast is
        # exact, so its fake-quant and masks see the CPU's values
        _train_parity("compress_parity_bert_grads", seed, wrapped, BERT_PARITY_BATCH, BERT_SEQ,
                      {"ste_zero_gradient": (lambda: planted_compress_fault("ste_zero_gradient"),
                                             "worst")},
                      steps=0, grad_floor=GRAD_FLOOR,
                      prepare=lambda p: attention_weighted(p).map(
                          lambda t: t.to(torch.bfloat16).float()),
                      batch_fn=lambda rng, V=wrapped.config_model.vocab_size: mlm_batch(
                          V, BERT_PARITY_BATCH, BERT_SEQ, int(rng.integers(1 << 30)),
                          full_rows=BERT_FULL_ROWS)[0])
    except RuntimeError as e:
        failures.append(str(e))
    emit("compress_parity", check="llama", **_llama_act_quant_forward(seed, failures))
    emit("compress_parity", check="act_quant_engine", **_act_quant_engine_run(seed, failures))
    emit("compress_parity", check="eigenvalue", **_eigen_parity(seed, failures))
    check(not failures, "compress_parity failed: " + "; ".join(failures))


def compress_train_launch_rule(engine):
    """compress_train's launches a step (gas 1, no remat, fused CE on, the
    student's 12 layers): A, C and D once a layer, F, G, dh and dW once, E
    once a port leaf (16 a layer and 12 others)."""
    n = engine.module.config_model.n_layer
    leaves = len(list(engine.state.params.parameters()))
    check(leaves == 16 * n + 12, f"{leaves} parameter leaves")
    return {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n, "fused_adam": leaves,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"), 1)}


def phase_compress_train(state, seed):
    """The compression recipe on BERT-large: the seeded 24-layer teacher of
    bert_train, a 12-layer student (layer_reduction, teacher_layer 1, 3,
    ..., 23, student_initialization), init_compression with 8-bit grouped
    weight quant on attn and mlp from step 0 and l1 sparse pruning (0.5) on
    mlp from step 4; trained as bert_train trains (micro 32 x 512, AdamW
    1e-4 wd 0.01, bf16, fused CE, gather budget 0.25), the
    CompressionScheduler stepped after each of 6 steps: step ms (the
    transitions marked), tokens/s, MFU on the student's flops_per_token(512),
    compress_params ms (CUDA events), peak memory. Gates: losses finite,
    the last below the first; each technique active from its offset; per
    step the launch rule. Then redundancy_clean of the trained params
    served through init_inference (fill-mask, one batch of 16 requests):
    every masked top-1 equal to the CompressedModel's forward (limit 0), A
    12 a batch."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.compression import (CompressionScheduler, init_compression,
                                                 redundancy_clean, student_initialization)
    failures = []
    dtype = torch.bfloat16 if ENCODER_DTYPE == "bf16" else torch.float32
    teacher_model = bert_large(remat=False, mlm_gather_budget=BERT_BUDGET)
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    teacher = teacher_model.init_params(gen, device=CHECK_DEVICE, dtype=dtype)
    wrapped = init_compression(teacher_model, COMPRESS_CONFIG)
    _sync()
    t = time.perf_counter()
    student = student_initialization(wrapped.init_params(gen, device=CHECK_DEVICE, dtype=dtype),
                                     teacher, COMPRESS_CONFIG)
    _sync()
    init_s = time.perf_counter() - t
    tl = COMPRESS_CONFIG["compression_training"]["layer_reduction"]["teacher_layer"]
    if not all(torch.equal(student["layers"][i]["mlp"]["w_up"], teacher["layers"][j]["mlp"]["w_up"])
               for i, j in enumerate(tl)):
        failures.append("a student layer is not its teacher layer")
    del teacher
    _free()
    config = {"train_batch_size": BERT_MICRO, "train_micro_batch_size_per_gpu": BERT_MICRO,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": ENCODER_DTYPE == "bf16"}, "fused_cross_entropy": "auto"}
    _reset_peak()
    engine = _train_engine(wrapped, student, config, device=CHECK_DEVICE)
    del student
    sched = CompressionScheduler(wrapped)
    B = BERT_MICRO
    lengths = np.full(B, BERT_SEQ)
    rng = np.random.default_rng(seed + 51)
    padded = rng.choice(B, B // 4, replace=False)
    lengths[padded] = rng.integers(64, BERT_SEQ, size=B // 4)
    batch, _ = mlm_batch(wrapped.config_model.vocab_size, B, BERT_SEQ, seed + 52, lengths=lengths)
    batch = {k: torch.as_tensor(v, device=CHECK_DEVICE) for k, v in batch.items()}
    rule = compress_train_launch_rule(engine)
    losses, step_s, per_step, active = [], [], [], []
    for _ in range(COMPRESS_STEPS):
        active.append({r.technique: wrapped._active[id(r)] for r in wrapped.rules})
        lo, st, ps = _timed_steps(engine, batch, 1)
        losses += lo
        step_s += st
        per_step += ps
        sched.step()
    peak = _peak_gb()
    offsets = {r.technique: int(r.params["schedule_offset"]) for r in wrapped.rules}
    want_active = [{t: i >= o for t, o in offsets.items()} for i in range(COMPRESS_STEPS)]
    if active != want_active:
        failures.append(f"active sets {active} != {want_active}")
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        failures.append(f"loss did not fall: {losses}")
    if CHECK_DEVICE == "cuda":
        for i, s in enumerate(per_step):
            if {k: s[k] for k in rule} != rule:
                failures.append(f"step {i + 1} launches {({k: s[k] for k in rule})} != {rule}")
    with torch.no_grad():
        compress_ms = cuda_ms(lambda: wrapped.compress_params(engine.state.params), reps=5,
                              warmup=1) if CHECK_DEVICE == "cuda" else None
        cleaned = redundancy_clean(engine.state.params, COMPRESS_CONFIG)
    serve = deepspeed_tpu_torch.init_inference(wrapped.model, params=cleaned,
                                               dtype=ENCODER_DTYPE, device=CHECK_DEVICE)
    r2 = np.random.default_rng(seed + 53)
    s_len = r2.integers(32, BERT_SEQ + 1, size=COMPRESS_SERVE_REQUESTS)
    sb, _ = mlm_batch(wrapped.config_model.vocab_size, COMPRESS_SERVE_REQUESTS, BERT_SEQ,
                      seed + 54, lengths=s_len)
    batches = _serve_batches([sb["input_ids"][i, :n] for i, n in enumerate(s_len)],
                             BERT_SERVE_BATCH)
    serve_ms, top1 = [], []
    with torch.no_grad():
        serve.forward(batches[0][0], attention_mask=batches[0][1])      # warm-up
        _sync()
        _reset_train_counters()
        for ids, mask in batches:
            t = time.perf_counter()
            top1.append(serve.forward(ids, attention_mask=mask).argmax(-1))
            _sync()
            serve_ms.append((time.perf_counter() - t) * 1e3)
        serve_launches = _launch_counts()
        dev = top1[0].device
        ref = [wrapped.forward(engine.state.params, torch.as_tensor(ids, device=dev),
                               torch.as_tensor(mask, device=dev)).argmax(-1)
               for ids, mask in batches]
    masked = [torch.as_tensor(ids == BERT_MASK, device=dev) for ids, _ in batches]
    differ = sum(int((a[m] != b[m]).sum()) for a, b, m in zip(top1, ref, masked))
    n_masked = sum(int(m.sum()) for m in masked)
    if differ:
        failures.append(f"{differ} of {n_masked} masked top-1 differ from the CompressedModel's")
    n = wrapped.config_model.n_layer
    serve_rule = bert_serve_launch_rule(n, len(batches))
    if CHECK_DEVICE == "cuda" and {k: serve_launches[k] for k in serve_rule} != serve_rule:
        failures.append(f"serve launches {serve_launches} != {serve_rule}")
    timed = step_s[1:]
    step_ms = float(np.median(timed)) * 1e3
    tokens = B * BERT_SEQ
    peak_tflops = get_accelerator(CHECK_DEVICE).peak_tflops()
    fpt = wrapped.flops_per_token(BERT_SEQ)
    mfu = (tokens / (step_ms / 1e3)) * fpt / (peak_tflops * 1e12) if peak_tflops else None
    state["compress_train_launches"] = {
        f"{k}_bert": sum(s[k] for s in per_step)
        for k in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                  "fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm", "fused_ce_dw_gemm")}
    state["compress_train_launches"]["fused_adam"] = sum(s["fused_adam"] for s in per_step)
    state["compress_train_launches"]["flash_attention_fwd_bert"] += \
        serve_launches["flash_attention_fwd"]
    emit("compress_train", teacher_layers=24, student_layers=n, teacher_layer=tl,
         batch=[B, BERT_SEQ], config=COMPRESS_CONFIG, student_init_s=init_s,
         params=sum(p.numel() for p in engine.state.params.parameters()), losses=losses,
         step_ms=[s * 1e3 for s in step_s], active_by_step=active,
         transitions={t: o for t, o in offsets.items()}, step_ms_median=step_ms,
         tokens_per_s=tokens / (step_ms / 1e3), flops_per_token=fpt, peak_tflops=peak_tflops,
         mfu=mfu, compress_params_ms=compress_ms, peak_mem_gb=peak,
         launches_per_step=per_step, launch_rule=rule, serve_requests=COMPRESS_SERVE_REQUESTS,
         serve_batch_ms=serve_ms, masked_positions=n_masked, top1_differ=differ,
         serve_launches=serve_launches, serve_launch_rule=serve_rule, card=state.get("card"))
    del engine, serve, cleaned
    _free()
    check(not failures, "compress_train failed: " + "; ".join(failures))


def moq_launch_rule(engine):
    """moq_eigenvalue's launches a step: E once a port leaf; K8 and its
    absmax once a port leaf of each JAX leaf of stacked rank >= 2 (the
    stochastic symmetric MoQ, as train_lamb); no A, C, D or fused CE (fp32,
    plain attention)."""
    from deepspeed_tpu_torch.runtime.utils import jax_leaves
    named = dict(engine.state.params.named_parameters())
    q = sum(len(ns) for path, ns in jax_leaves(named).items()
            if named[ns[0]].dim() + (path[0] == "layers") >= 2)
    return {"fused_adam": len(named), "sr_quantize": q, "sr_absmax": q,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_ce_fwd": 0}


def phase_moq_eigenvalue(state, seed):
    """The MoQ eigenvalue schedule on BERT-large at 24 layers: fp32 (the
    JAX engine's HVP refuses bf16 params), plain attention, micro 2 x 512
    (cut from 32 for the double backward), AdamW, quantize_training 12 ->
    8 bits, period 1, stochastic rounding (K8), eigenvalue over 24 layer
    blocks, max_iter MOQ_EV_MAX_ITER; MOQ_EV_STEPS steps, the eigenvalues
    computed at each (a switch is pending): each block's eigenvalue and
    iterations, the HVPs' ms (CUDA events), the step ms. Gates: computed at
    least twice; every leaf's period after a switch (old << 1) x (1 +
    floor(4 x the step's mean)) for the stacked layer leaves and x 1 for
    the others (limit 0); per step the launch rule; A, C, D and the fused
    CE 0 inside the HVPs."""
    import math
    import numpy as np
    import torch
    failures = []
    model = bert_large(remat=False, mlm_gather_budget=BERT_BUDGET, attention_backend="xla")
    config = {"train_batch_size": MOQ_EV_MICRO, "train_micro_batch_size_per_gpu": MOQ_EV_MICRO,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "quantize_training": MOQ_EV_CONFIG}
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 70)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.float32)
    _reset_peak()
    engine = _train_engine(model, params, config, device=CHECK_DEVICE)
    del params
    ev = engine.eigenvalue
    check(ev is not None and engine.quantizer.q_eigenvalue, "the eigenvalue schedule is off")
    computed = []
    real = ev.compute_eigenvalue

    def timed(*a, **k):
        _sync()
        before = _train_counters()
        t = time.perf_counter()
        vals = real(*a, **k)
        _sync()
        after = _train_counters()
        computed.append({"values": vals, "iterations": list(ev.iterations),
                         "ms": (time.perf_counter() - t) * 1e3,
                         "launches": {k2: after[k2] - before[k2] for k2 in after
                                      if after[k2] != before[k2]}})
        return vals
    ev.compute_eigenvalue = timed
    batch, _ = mlm_batch(model.config.vocab_size, MOQ_EV_MICRO, BERT_SEQ, seed + 71,
                         full_rows=MOQ_EV_MICRO)
    batch = {k: torch.as_tensor(v, device=CHECK_DEVICE) for k, v in batch.items()}
    rule = moq_launch_rule(engine)
    losses, step_s, per_step, switches = [], [], [], []
    for step in range(MOQ_EV_STEPS):
        before = {k: dict(v) for k, v in engine.quantizer.state_dict()["leaf_state"].items()}
        n_before = len(computed)
        lo, st, ps = _timed_steps(engine, batch, 1)
        losses += lo
        step_s += st
        per_step += ps
        after = engine.quantizer.state_dict()["leaf_state"]
        mean = (sum(computed[-1]["values"]) / len(computed[-1]["values"])
                if len(computed) > n_before else None)
        for key, st_ in after.items():
            old = before.get(key, {"bits": MOQ_EV_CONFIG["quantize_bits"]["start_bits"],
                                   "period": MOQ_EV_CONFIG["quantize_schedule"]["quantize_period"]})
            if st_["bits"] == old["bits"]:
                continue
            layers = key.startswith("['layers']")
            factor = 1 + math.floor(mean * 4) if layers and mean is not None else 1
            switches.append({"step": step + 1, "leaf": key, "old": old["period"],
                             "new": st_["period"], "factor": factor})
            if st_["period"] != (old["period"] << 1) * factor:
                failures.append(f"step {step + 1} {key}: period {st_['period']} != "
                                f"({old['period']} << 1) x {factor}")
    peak = _peak_gb()
    if len(computed) < 2:
        failures.append(f"eigenvalues computed {len(computed)} times")
    if not all(np.isfinite(losses)):
        failures.append(f"non-finite losses {losses}")
    if CHECK_DEVICE == "cuda":
        for i, s in enumerate(per_step):
            if {k: s[k] for k in rule} != rule:
                failures.append(f"step {i + 1} launches {({k: s[k] for k in rule})} != {rule}")
        inside = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                  "fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm", "fused_ce_dw_gemm")
        for c in computed:
            if any(c["launches"].get(k, 0) for k in inside):
                failures.append(f"kernels launched inside the HVPs: {c['launches']}")
    state["moq_eigenvalue_launches"] = {k: sum(s[k] for s in per_step)
                                        for k in ("fused_adam", "sr_quantize", "sr_absmax")}
    hvps = [sum(c["iterations"]) for c in computed]
    emit("moq_eigenvalue", layers=model.config.n_layer, batch=[MOQ_EV_MICRO, BERT_SEQ],
         dtype="fp32", attention="xla", config=MOQ_EV_CONFIG, losses=losses,
         step_ms=[s * 1e3 for s in step_s],
         eigen=[{"block_eigenvalues": c["values"], "iterations": c["iterations"],
                 "mean": sum(c["values"]) / len(c["values"]), "ms": c["ms"],
                 "launches_inside": c["launches"]} for c in computed],
         hvps=hvps, ms_per_hvp=[c["ms"] / max(h, 1) for c, h in zip(computed, hvps)],
         switches=switches[:8], n_switches=len(switches),
         quantizer_bits={k: v["bits"] for k, v in
                         engine.quantizer.state_dict()["leaf_state"].items()},
         peak_mem_gb=peak, launches_per_step=per_step, launch_rule=rule,
         card=state.get("card"))
    del engine
    _free()
    check(not failures, "moq_eigenvalue failed: " + "; ".join(failures))


# ------------------------------------------------------------------ #
# the training extras: the remat policies, and the data-efficiency pipeline
# (a seqlen curriculum over a sampler, random-LTD, progressive layer drop)

REMAT_POLICIES = ("full", "selective", "dots", "offload_dots")
REMAT_STEPS = 3                 # a policy's train_batch steps: step ms = median of steps 2-3
REMAT_SEQ = TRAIN_SEQ
REMAT_OFFLOAD_SLACK_GB = 0.5    # offload_dots' device peak within this of full's
DE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".data_efficiency")
DE_SAMPLES = 2048               # rows of the seeded indexed dataset, a quarter padded
DE_STEPS = 6
DE_CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 128,
                 "max_difficulty": BERT_SEQ, "schedule_type": "fixed_linear",
                 "schedule_config": {"total_curriculum_step": 5, "difficulty_step": 8}}
DE_LTD = {"random_ltd_schedule": {"min_value": 128, "max_value": BERT_SEQ,
                                  "schedule_type": "fixed_linear",
                                  "schedule_config": {"require_steps": 20, "seq_per_step": 16}}}
DE_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}


def remat_llama():
    """train_remat's model: the train cell's (Llama-2-7B width, TRAIN_LAYERS)."""
    from deepspeed_tpu_torch.models import llama
    return llama("7b", n_layer=TRAIN_LAYERS)


def remat_reckoned_gb(cfg, tokens):
    """What each policy keeps beyond "full" a micro-step of ``tokens``,
    reckoned from the shapes (bf16 products, fp32 lse): "selective" the q,
    k, v, wo and ff_down products and kernel A's o (4 D + 2 KV Hd a token)
    and lse (H floats); "dots" every product (3 D + 2 KV Hd + 2 d_ff);
    "offload_dots" none on the device."""
    D, KVD, H = cfg.d_model, cfg.kv_heads * cfg.head_dim, cfg.n_head
    per_layer = {"selective": 2 * (4 * D + 2 * KVD) + 4 * H,
                 "dots": 2 * (3 * D + 2 * KVD + 2 * cfg.ff_dim), "offload_dots": 0}
    return {p: cfg.n_layer * tokens * b / 1e9 for p, b in per_layer.items()}


@contextlib.contextmanager
def attention_calls():
    """The attention wrappers' calls inside the ``with`` body, as (name,
    S): A's forward ("flash_attention"), C and D, through
    ``flash_attention._dispatch``, which every one of them passes on the
    card and on the CPU alike."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    calls, real = [], fa._dispatch

    def spy(cuda_fn, plain_fn, name, q, *args):
        calls.append((name, int(q.shape[1])))
        return real(cuda_fn, plain_fn, name, q, *args)
    fa._dispatch = spy
    try:
        yield calls
    finally:
        fa._dispatch = real


def _bits(t):
    """``t``'s bit patterns as integers (bit-equality with NaNs and -0 told apart)."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def phase_train_remat(state, seed):
    """The train cell (Llama-2-7B width at TRAIN_LAYERS, S 2048, micro 4 x
    gas 2, FusedAdam, bf16, fused CE) under each remat policy. First the
    step-1 loss and every gradient at the same weights and batch, through
    the engine's forward and autograd, under "full" and then each other
    policy: bit-equal (limit 0), A's forwards in each micro-step's backward
    counted (L, or 0 under "selective"). Then REMAT_STEPS train_batch steps a
    policy: step ms (median of steps 2-3), tokens/s, the device peak of its
    steps against "full"'s beside the reckoned bytes, A, C and D launches a
    step, the pinned host bytes held at the peak (offload_dots). Gates: the
    bit-equality; A 2 L gas a step (L gas under "selective"), C and D L gas;
    on the card the launch rule and the peaks ordered offload_dots within
    REMAT_OFFLOAD_SLACK_GB of full < selective < dots; losses finite."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
    model = remat_llama()
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.bfloat16)
    engine = _train_engine(model, params, TRAIN_CONFIG, device=CHECK_DEVICE)
    cfg = model.config          # with the engine's fused_cross_entropy
    del params
    _free()
    B = TRAIN_CONFIG["train_batch_size"]
    tokens = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, size=(B, REMAT_SEQ))
    batch = {"input_ids": torch.from_numpy(tokens).to(CHECK_DEVICE)}
    gas = engine.gradient_accumulation_steps()
    micro, L = B // gas, cfg.n_layer
    leaves = [p for _, p in engine.state.params.named_parameters()]
    failures, grad_check, want = [], {}, None
    with attention_calls() as calls:
        for policy in REMAT_POLICIES:
            model.config = dataclasses.replace(cfg, remat=policy)
            got, reruns = [], []
            for i in range(gas):
                loss = engine({k: x[i * micro:(i + 1) * micro] for k, x in batch.items()})
                calls.clear()
                grads = torch.autograd.grad(loss.float(), leaves)
                engine._cached_loss = None
                reruns.append(sum(1 for c in calls if c[0] == "flash_attention"))
                got.append((_bits(loss.detach()), [_bits(g) for g in grads]))
                del loss, grads
            if want is None:
                want, differ = got, 0
            else:
                differ = sum(int((a != b).sum()) for (_, ga), (_, gb) in zip(got, want)
                             for a, b in zip(ga, gb))
                differ += sum(int((la != lb).sum()) for (la, _), (lb, _) in zip(got, want))
            grad_check[policy] = {"elements_differing": differ, "a_in_backward": reruns}
            if differ:
                failures.append(f"{policy}: {differ} loss and gradient elements differ from full's")
            rerun = 0 if policy == "selective" else L
            if reruns != [rerun] * gas:
                failures.append(f"{policy}: A ran {reruns} times in the backward, not {rerun}")
            del got
        del want
        _free()
        runs, per_policy_launches = {}, {}
        rule = train_launch_rule(engine)
        reckoned = remat_reckoned_gb(cfg, micro * REMAT_SEQ)
        for policy in REMAT_POLICIES:
            model.config = dataclasses.replace(cfg, remat=policy)
            _free()
            _reset_peak()
            ck.reset_stats()
            calls.clear()
            losses, step_s, per_step = _timed_steps(engine, batch, REMAT_STEPS)
            a_calls = sum(1 for c in calls if c[0] == "flash_attention") / REMAT_STEPS
            want_a = (1 if policy == "selective" else 2) * L * gas
            if a_calls != want_a:
                failures.append(f"{policy}: A called {a_calls} times a step, not {want_a}")
            if not all(np.isfinite(losses)):
                failures.append(f"{policy}: non-finite losses {losses}")
            rule_p = {**rule, "flash_attention_fwd": want_a}
            if CHECK_DEVICE == "cuda":
                for i, s in enumerate(per_step):
                    if {k: s[k] for k in rule_p} != rule_p:
                        failures.append(f"{policy} step {i + 1} launches "
                                        f"{({k: s[k] for k in rule_p})} != {rule_p}")
            step_ms = float(np.median(step_s[1:])) * 1e3
            runs[policy] = {
                "losses": losses, "step_ms": [s * 1e3 for s in step_s],
                "step_ms_median_steps_2_3": step_ms,
                "tokens_per_s": B * REMAT_SEQ / (step_ms / 1e3), "peak_mem_gb": _peak_gb(),
                "reckoned_over_full_gb": reckoned[policy] if policy != "full" else 0.0,
                "a_c_d_a_step": [per_step[-1][k] for k in ("flash_attention_fwd",
                                                             "flash_attention_bwd_dq",
                                                             "flash_attention_bwd_dkv")],
                "pinned_host_gb_at_peak": ck.stats["host_bytes_peak"] / 1e9,
                "saved_gb_a_step": ck.stats["saved_bytes"] / 1e9 / REMAT_STEPS}
            per_policy_launches[policy] = per_step
    peaks = {p: r["peak_mem_gb"] for p, r in runs.items()}
    for p, r in runs.items():
        r["peak_over_full_gb"] = peaks[p] - peaks["full"]
    if CHECK_DEVICE == "cuda":
        if not peaks["full"] < peaks["selective"] < peaks["dots"]:
            failures.append(f"device peaks not ordered full < selective < dots: {peaks}")
        if not peaks["offload_dots"] <= peaks["full"] + REMAT_OFFLOAD_SLACK_GB:
            failures.append(f"offload_dots' peak {peaks['offload_dots']:.2f} GB over full's "
                            f"{peaks['full']:.2f} + {REMAT_OFFLOAD_SLACK_GB}")
        if not runs["offload_dots"]["pinned_host_gb_at_peak"] > 0:
            failures.append("offload_dots held no pinned host memory")
    keys = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
            "fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm", "fused_ce_dw_gemm", "fused_adam")
    state["train_remat_launches"] = {
        k: sum(s[k] for steps in per_policy_launches.values() for s in steps) for k in keys}
    emit("train_remat", model="llama-2-7b width", layers=L, seq=REMAT_SEQ, micro=micro, gas=gas,
         config=TRAIN_CONFIG, grad_check=grad_check, policies=runs,
         reckoned_over_full_gb=reckoned, launches_per_step=per_policy_launches,
         launch_rule=rule, card=state.get("card"))
    model.config = cfg
    del engine, batch
    _free()
    check(not failures, "train_remat failed: " + "; ".join(failures))


class DEDataset:
    """train_data_efficiency's samples: row i of the indexed dataset (its
    real tokens) padded with 0 to BERT_SEQ, MLM_RATE of its inner positions
    masked from a generator seeded by the row (as ``mlm_batch`` builds a
    row). ``read`` records the rows asked for, in order."""

    def __init__(self, ds, seed):
        self.ds, self.seed, self.read = ds, seed, []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        import numpy as np
        self.read.append(int(i))
        toks = np.asarray(self.ds[i], np.int64)
        n = len(toks)
        pos = np.arange(BERT_SEQ)
        ids = np.zeros(BERT_SEQ, np.int64)
        ids[:n] = toks
        rng = np.random.default_rng([self.seed, int(i)])
        masked = (pos > 0) & (pos < n - 1) & (rng.random(BERT_SEQ) < MLM_RATE)
        return {"input_ids": np.where(masked, BERT_MASK, ids),
                "attention_mask": (pos < n).astype(np.int64),
                "token_type_ids": np.zeros(BERT_SEQ, np.int64),
                "labels": np.where(masked, ids, -100)}


def de_rows(vocab, seed):
    """DE_SAMPLES fill-mask rows' tokens ([CLS] seeded ids [SEP]): a quarter
    of them shorter than BERT_SEQ, at lengths seeded in 64..BERT_SEQ-1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = np.full(DE_SAMPLES, BERT_SEQ)
    short = rng.choice(DE_SAMPLES, DE_SAMPLES // 4, replace=False)
    lengths[short] = rng.integers(64, BERT_SEQ, size=len(short))
    rows = []
    for n in lengths:
        row = rng.integers(1000, vocab, size=n)
        row[0], row[-1] = BERT_CLS, BERT_SEP
        rows.append(row)
    return rows


def ltd_bert(base):
    """``base`` (a BertModel) as a model whose layers 1..L-2 run under
    random-LTD, wired as a user of the package wires it: a subclass whose
    forward wraps those blocks in ``RandomLayerTokenDrop`` over the per-row
    token sets of ``bert_sample_tokens`` (``keep`` tokens of each row, drawn
    from ``ltd_gen``), layers 0 and L-1 on every token. The caller sets
    ``keep`` each step; ``seen`` records each forward's (S, keep)."""
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.ops.random_ltd.dropping_utils import bert_sample_tokens
    from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import RandomLayerTokenDrop

    class LTDBert(type(base)):

        def __call__(self, params, input_ids, token_type_ids=None, attention_mask=None,
                     rng=None):
            import torch
            cfg = self.zoo_cfg
            emb = params["embed"]
            input_ids = torch.as_tensor(input_ids, device=emb["tokens"].device).long()
            B, S = input_ids.shape
            x = emb["tokens"][input_ids] + emb["positions"][:S][None]
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + emb["token_type"][torch.as_tensor(token_type_ids, device=x.device).long()]
            x = T._norm(cfg, x, emb["ln"])
            k_embed, k_layers = (T._seeds(rng, 2) if rng is not None and cfg.dropout
                                 else (None, None))
            x = T._dropout(cfg, x, T._generator(k_embed, x.device))
            mask = None if attention_mask is None else torch.as_tensor(attention_mask,
                                                                       device=x.device)
            mb = T.key_mask_bias(mask)
            layers = list(params["layers"])
            seeds = T._seeds(T._generator(k_layers, "cpu") if cfg.dropout else None, len(layers))
            keep = min(self.keep or S, S)
            idx = None
            if keep < S:
                idx, _ = bert_sample_tokens(keep, S, B, layers=len(layers) - 2, rng=self.ltd_gen)
            self.seen.append((S, keep))
            policy = T._remat(cfg.remat)
            for l, (lp, seed) in enumerate(zip(layers, seeds)):
                def layer(h, m, lp=lp, seed=seed):
                    pos = torch.arange(h.shape[1], device=h.device)[None].expand(h.shape[:2])
                    if policy is None:
                        return T.block(cfg, h, lp, pos, m, seed)
                    return T.remat(policy, T.block, cfg, h, lp, pos, m, seed)
                if idx is not None and 0 < l < len(layers) - 1:
                    x = RandomLayerTokenDrop(layer)(x, None, keep, mb, indices=idx[l - 1])
                else:
                    x = layer(x, mb)
            pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
            return x, pooled

    model = LTDBert(base.config, with_mlm_head=True)
    model.keep, model.ltd_gen, model.seen = None, None, []
    return model


def phase_train_data_efficiency(state, seed):
    """BERT-large MLM as bert_train (micro 32 x 512, AdamW 1e-4 wd 0.01,
    bf16, fused CE, gather budget 0.25, no remat; nothing cut) fed by the
    data-efficiency pipeline: DE_SAMPLES seeded rows written with
    ``MMapIndexedDatasetBuilder`` under DE_DIR (a quarter shorter than 512),
    a ``DataAnalyzer`` seqlen metric over them, a ``DeepSpeedDataSampler``
    drawing from its curriculum over that metric into the engine's
    ``DeepSpeedDataLoader``; the engine's config: the seqlen curriculum of
    data_efficiency.data_sampling (128 -> 512 in 5 steps, step 8),
    progressive_layer_drop (theta 0.5, gamma 0.001), activation_checkpointing
    with its defaults; random-LTD on layers 1..22 (``ltd_bert``) at the
    ``RandomLTDScheduler``'s count (128 -> 512 over 20 steps, 16 a step).
    DE_STEPS steps: S and the kept count, step ms, tokens/s on the valid
    tokens trained, losses, theta (``progressive_layer_drop.update_state``
    after each step, as a user calls it: nothing in either package does).
    Gates: each step's S the port's CurriculumScheduler's and its kept
    count the RandomLTDScheduler's, below S; an S that is not a multiple of
    64; the rows read the order of a fresh sampler with the same seed;
    losses finite; A, C and D 24 a step, at [32, keep, 16 x 64] on layers
    1..22 and at [32, S, 16 x 64] on layers 0 and 23 (and on the card the
    counters)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import (
        CurriculumScheduler)
    from deepspeed_tpu_torch.runtime.data_pipeline.data_routing import RandomLTDScheduler
    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling import (
        DataAnalyzer, DeepSpeedDataSampler, MMapIndexedDataset, MMapIndexedDatasetBuilder,
        load_metric_values)
    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_analyzer import (
        get_metric_value_percentiles)
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

    base = bert_large(remat=False, mlm_gather_budget=BERT_BUDGET)
    model = ltd_bert(base)
    L = model.config.n_layer
    config = {"train_batch_size": BERT_MICRO, "train_micro_batch_size_per_gpu": BERT_MICRO,
              "gradient_accumulation_steps": 1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
              "bf16": {"enabled": ENCODER_DTYPE == "bf16"}, "fused_cross_entropy": "auto",
              "data_efficiency": {"enabled": True, "seed": seed + 60, "data_sampling": {
                  "enabled": True, "curriculum_learning": DE_CURRICULUM}},
              "progressive_layer_drop": DE_PLD, "activation_checkpointing": {}}
    failures = []
    shutil.rmtree(DE_DIR, ignore_errors=True)
    os.makedirs(DE_DIR)
    try:
        t0 = time.perf_counter()
        prefix = os.path.join(DE_DIR, "bert_rows")
        builder = MMapIndexedDatasetBuilder(prefix, dtype=np.int32)
        for row in de_rows(model.config.vocab_size, seed + 61):
            builder.add_item(row)
        builder.finalize()
        ds = MMapIndexedDataset(prefix)
        DataAnalyzer(ds, ["seqlen"], [len], os.path.join(DE_DIR, "analysis")).run()
        values = load_metric_values(os.path.join(DE_DIR, "analysis"), "seqlen")
        pct = get_metric_value_percentiles(os.path.join(DE_DIR, "analysis"), "seqlen")
        data_s = time.perf_counter() - t0

        def sampler():
            return DeepSpeedDataSampler(
                DE_SAMPLES, micro_batch_size=BERT_MICRO, data_parallel_rank=0,
                data_parallel_size=1, curriculum_scheduler=CurriculumScheduler(
                    dict(DE_CURRICULUM)), difficulties=values, seed=seed + 62)
        dataset = DEDataset(ds, seed + 63)
        gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
        params = model.init_params(gen, device=CHECK_DEVICE, dtype=torch.bfloat16
                                   if ENCODER_DTYPE == "bf16" else torch.float32)
        engine = _train_engine(model, params, config, device=CHECK_DEVICE)
        del params
        engine.set_dataloader(DeepSpeedDataLoader(dataset, BERT_MICRO, data_sampler=sampler()))
        model.ltd_gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed + 64)
        ltd, want_ltd = RandomLTDScheduler(DE_LTD), RandomLTDScheduler(DE_LTD)
        want_curr = CurriculumScheduler(dict(DE_CURRICULUM))
        check(engine.curriculum_scheduler is not None and engine.pld_enabled(),
              "the curriculum or PLD is off")
        rule = bert_train_launch_rule(engine)
        steps = []
        with attention_calls() as calls:
            for step in range(1, DE_STEPS + 1):
                model.keep = ltd.update_seq(step)
                calls.clear()
                before = _train_counters()
                t = time.perf_counter()
                loss = float(engine.train_batch())
                _sync()
                dt = time.perf_counter() - t
                after = _train_counters()
                engine.progressive_layer_drop.update_state(engine.global_steps)
                S, keep = model.seen[-1]
                rows = dataset.read[-BERT_MICRO:]
                valid = int(sum(min(int(values[i]), S) for i in rows))
                steps.append({"step": step, "S": S, "keep": keep, "ms": dt * 1e3, "loss": loss,
                              "theta": engine.get_pld_theta(), "valid_tokens": valid,
                              "tokens_per_s": valid / dt,
                              "layer_token_share": (2 * S + (L - 2) * keep) / (L * S),
                              "calls": sorted({(n, s, calls.count((n, s))) for n, s in calls}),
                              "launches": {k: after[k] - before[k] for k in after}})
                want_s, want_k = want_curr.update_difficulty(step), want_ltd.update_seq(step)
                if (S, keep) != (want_s, want_k) or not keep < S:
                    failures.append(f"step {step}: S {S}, keep {keep}; the schedulers give "
                                    f"{want_s}, {want_k}")
                difficulty = engine.curriculum_scheduler.get_current_difficulty()
                if difficulty != S:
                    failures.append(f"step {step}: the engine's difficulty {difficulty} != {S}")
                for name in ("flash_attention", "flash_attention_dq", "flash_attention_dkv"):
                    seqs = sorted(s for n, s in calls if n == name)
                    if seqs != sorted([keep] * (L - 2) + [S] * 2):
                        failures.append(f"step {step}: {name} at {seqs}")
                if CHECK_DEVICE == "cuda":
                    got = {k: steps[-1]["launches"][k] for k in rule}
                    if got != rule:
                        failures.append(f"step {step} launches {got} != rule {rule}")
        fresh = [i for b, _ in zip(sampler(), range(DE_STEPS)) for i in b]
        if dataset.read[:len(fresh)] != fresh:
            failures.append("the rows read are not a fresh sampler's order")
        losses = [s["loss"] for s in steps]
        if not all(np.isfinite(losses)):
            failures.append(f"non-finite losses {losses}")
        if all(s["S"] % 64 == 0 for s in steps):
            failures.append("no step ran a ragged S")
        timed = steps[1:]
        keys = ("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm", "fused_ce_dw_gemm")
        state["train_data_efficiency_launches"] = {
            **{f"{k}_ltd": sum(s["launches"][k] for s in steps)
               for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")},
            **{f"{k}_bert": sum(s["launches"][k] for s in steps) for k in keys},
            "fused_adam": sum(s["launches"]["fused_adam"] for s in steps)}
        emit("train_data_efficiency", layers=L, batch=[BERT_MICRO, BERT_SEQ],
             samples=DE_SAMPLES, rows_short=int((values < BERT_SEQ).sum()),
             seqlen_percentiles=pct, data_s=data_s, curriculum=DE_CURRICULUM, random_ltd=DE_LTD,
             ltd_layers=[1, L - 2], pld=DE_PLD, steps=[{k: v for k, v in s.items()
                                                         if k != "launches"} for s in steps],
             tokens_per_s_steps_2_6=sum(s["valid_tokens"] for s in timed)
             / sum(s["ms"] for s in timed) * 1e3,
             losses=losses, theta=[s["theta"] for s in steps], peak_mem_gb=_peak_gb(),
             launch_rule=rule, launches_per_step=[s["launches"] for s in steps],
             card=state.get("card"))
        del engine
    finally:
        shutil.rmtree(DE_DIR, ignore_errors=True)
    _free()
    check(not failures, "train_data_efficiency failed: " + "; ".join(failures))


# ----------------------------------------------------------------------- #
# Stable Diffusion wrappers (DSUNet / DSVAE on CUDA graphs, kernel S),
# TiledLinear, the autotuner and the one-card tooling

# Stable Diffusion v1.5's first UNet level at full width
# (runwayml/stable-diffusion-v1-5 unet/config.json: in_channels 4,
# block_out_channels[0] 320, attention_head_dim 8, norm_num_groups 32,
# sample_size 64, time embedding 4 x 320) and its VAE's widths
# (vae/config.json: latent_channels 4, block_out_channels [128, 256, 512, 512],
# sample_size 512). Cross-attention is left out (A takes equal q and kv
# lengths).
SD_UNET = {"in_channels": 4, "channels": 320, "heads": 8, "groups": 32, "ff": 1280,
           "temb": 1280, "latent": 64, "eps": 1e-5}
SD_VAE = {"in_channels": 3, "latent": 4, "enc_channels": 128, "dec_channels": 512,
          "groups": 32, "image": 512, "eps": 1e-6}
SD_BATCH = 2                    # classifier-free guidance: the conditional and unconditional halves
SD_STEPS = 20                   # denoiser calls through DSUNet, and as many eager, alternated
SD_PARITY_LATENT = 16           # the card-vs-CPU step: a 16 x 16 latent
SD_QK_SCALE = 3.0               # q / k weights scaled: attention peaked, faults reach the output
SD_S_PER_CALL = 8               # S a denoiser call: conv_in, 2 in the ResNet, 5 in attention
SD_VAE_S_PER_CALL = 3           # S an encode or decode call: the conv's bias, 2 in the ResNet


def _card_dtype():
    """bf16 on the card; fp32 where the CPU tests run the phases."""
    import torch
    return torch.bfloat16 if CHECK_DEVICE == "cuda" else torch.float32


def sd_unet_params(gen, device, dtype, width=None):
    """Seeded weights of the denoiser (``width``: SD_UNET's keys). Conv
    weights are ``[out, in, 3, 3]`` (channels-last memory on the card, the
    layout cuDNN's NHWC kernels read), matmul weights ``[in, out]``."""
    import torch
    w_ = width or SD_UNET
    C, Cin, F, T = w_["channels"], w_["in_channels"], w_["ff"], w_["temb"]

    def rnd(*shape, std=1.0, base=0.0):
        x = torch.randn(shape, generator=gen, device=device) * std + base
        return x.to(dtype)

    def conv(cout, cin):
        x = rnd(cout, cin, 3, 3, std=(9 * cin) ** -0.5)
        return x.to(memory_format=torch.channels_last) if x.is_cuda else x

    def lin(i, o, scale=1.0):
        return rnd(i, o, std=scale * i**-0.5)

    def norm(n):
        return rnd(n, std=0.1, base=1.0), rnd(n, std=0.1)

    gn1, gn2, gn, ln1, ln3, gno = (norm(C) for _ in range(6))
    return {
        "conv_in_w": conv(C, Cin), "conv_in_b": rnd(C, std=0.1),
        "time_w1": lin(C, T), "time_b1": rnd(T, std=0.1),
        "time_w2": lin(T, T), "time_b2": rnd(T, std=0.1),
        "res": {"gn1_w": gn1[0], "gn1_b": gn1[1], "conv1_w": conv(C, C), "conv1_b": rnd(C, std=0.1),
                "temb_w": lin(T, C), "temb_b": rnd(C, std=0.1),
                "gn2_w": gn2[0], "gn2_b": gn2[1], "conv2_w": conv(C, C),
                "conv2_b": rnd(C, std=0.1)},
        "attn": {"gn_w": gn[0], "gn_b": gn[1], "proj_in_w": lin(C, C), "proj_in_b": rnd(C, std=0.1),
                 "ln1_w": ln1[0], "ln1_b": ln1[1], "wq": lin(C, C, SD_QK_SCALE),
                 "wk": lin(C, C, SD_QK_SCALE), "wv": lin(C, C), "wo": lin(C, C),
                 "bo": rnd(C, std=0.1), "ln3_w": ln3[0], "ln3_b": ln3[1],
                 "ff_w": lin(C, 2 * F), "ff_b": rnd(2 * F, std=0.1), "ff2_w": lin(F, C),
                 "ff2_b": rnd(C, std=0.1), "proj_out_w": lin(C, C), "proj_out_b": rnd(C, std=0.1)},
        "out_gn_w": gno[0], "out_gn_b": gno[1], "conv_out_w": conv(Cin, C),
        "conv_out_b": rnd(Cin, std=0.1),
    }


def sd_vae_params(gen, device, dtype, width=None):
    """Seeded weights of the VAE's first encoder level (conv 3 -> 128 and a
    ResNet block) and its decoder's entry (conv_in 4 -> 512 and a ResNet
    block)."""
    import torch
    w_ = width or SD_VAE

    def rnd(*shape, std=1.0, base=0.0):
        return (torch.randn(shape, generator=gen, device=device) * std + base).to(dtype)

    def conv(cout, cin):
        x = rnd(cout, cin, 3, 3, std=(9 * cin) ** -0.5)
        return x.to(memory_format=torch.channels_last) if x.is_cuda else x

    def level(cin, c):
        return {"conv_w": conv(c, cin), "conv_b": rnd(c, std=0.1),
                "res": {"gn1_w": rnd(c, std=0.1, base=1.0), "gn1_b": rnd(c, std=0.1),
                        "conv1_w": conv(c, c), "conv1_b": rnd(c, std=0.1),
                        "gn2_w": rnd(c, std=0.1, base=1.0), "gn2_b": rnd(c, std=0.1),
                        "conv2_w": conv(c, c), "conv2_b": rnd(c, std=0.1)}}
    return {"encoder": level(w_["in_channels"], w_["enc_channels"]),
            "decoder": level(w_["latent"], w_["dec_channels"])}


def _sd_conv(x, w, b=None):
    """A 3 x 3, padding 1 convolution of an NHWC activation (cuDNN; the view
    handed to it is channels-last memory)."""
    import torch.nn.functional as F
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1).contiguous()


def _sd_group_norm(x, w, b, groups, eps):
    import torch.nn.functional as F
    return F.group_norm(x.permute(0, 3, 1, 2), groups, w, b, eps).permute(0, 2, 3, 1).contiguous()


def _sd_attention(q, k, v):
    """The denoiser's self-attention: kernel A, non-causal, no mask (a
    module-level name, so a fault can be planted where the model calls it)."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    return fa.flash_attention(q, k, v, causal=False)


def _sd_resnet(x, p, temb_bias, groups, eps):
    """A ResNet block (diffusers ``ResnetBlock2D`` at equal widths): the
    time bias through ``nhwc_bias_add``, the residual through
    ``nhwc_bias_add_add``."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.spatial import kernels as sk
    h = _sd_conv(F.silu(_sd_group_norm(x, p["gn1_w"], p["gn1_b"], groups, eps)), p["conv1_w"])
    bias = p["conv1_b"] if temb_bias is None else p["conv1_b"] + temb_bias
    h = sk.nhwc_bias_add(h, bias)
    h = _sd_conv(F.silu(_sd_group_norm(h, p["gn2_w"], p["gn2_b"], groups, eps)), p["conv2_w"])
    return sk.nhwc_bias_add_add(h, p["conv2_b"], x)


def _sd_time_embedding(p, timestep, C):
    """SD's sinusoidal timestep embedding (flip_sin_to_cos, 10000^(-i/half))
    through the two-layer time MLP."""
    import math
    import torch
    import torch.nn.functional as F
    half = C // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=timestep.device,
                                                        dtype=torch.float32) / half)
    arg = timestep.float().reshape(1) * freqs
    emb = torch.cat([torch.cos(arg), torch.sin(arg)]).to(p["time_w1"].dtype)
    return F.silu(emb @ p["time_w1"] + p["time_b1"]) @ p["time_w2"] + p["time_b2"]


def sd_denoiser(p, latents, timestep, context=None, width=None):
    """One denoiser call: latents ``[N, H, W, 4]`` NHWC and a 0-dim timestep
    (one for the CFG pair) to the noise prediction ``[N, H, W, 4]``.
    conv_in, a ResNet block with the time embedding, a transformer block
    (GroupNorm, proj_in, self-attention over the H*W tokens through A,
    GEGLU feed-forward, proj_out, the residual), conv_out. Reads nothing
    from the device, so a CUDA graph can hold it."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.spatial import kernels as sk
    w_ = width or SD_UNET
    C, G, eps, heads = w_["channels"], w_["groups"], w_["eps"], w_["heads"]
    temb = _sd_time_embedding(p, timestep, C)
    temb_bias = F.silu(temb) @ p["res"]["temb_w"] + p["res"]["temb_b"]
    h = sk.nhwc_bias_add(_sd_conv(latents, p["conv_in_w"]), p["conv_in_b"])
    h = _sd_resnet(h, p["res"], temb_bias, G, eps)
    a = p["attn"]
    N, H, W, _ = h.shape
    S = H * W
    x = _sd_group_norm(h, a["gn_w"], a["gn_b"], G, 1e-6).reshape(N, S, C)
    x = sk.nhwc_bias_add(x @ a["proj_in_w"], a["proj_in_b"])
    n = F.layer_norm(x, (C,), a["ln1_w"], a["ln1_b"], 1e-5)
    q, k, v = ((n @ a[w]).reshape(N, S, heads, C // heads) for w in ("wq", "wk", "wv"))
    o = _sd_attention(q, k, v).reshape(N, S, C)
    x = sk.nhwc_bias_add_add(o @ a["wo"], a["bo"], x)
    n = F.layer_norm(x, (C,), a["ln3_w"], a["ln3_b"], 1e-5)
    u, gate = sk.nhwc_bias_add(n @ a["ff_w"], a["ff_b"]).chunk(2, dim=-1)
    x = sk.nhwc_bias_add_add((u * F.gelu(gate)) @ a["ff2_w"], a["ff2_b"], x)
    h = sk.nhwc_bias_add_add(x @ a["proj_out_w"], a["proj_out_b"], h.reshape(N, S, C))
    h = F.silu(_sd_group_norm(h.reshape(N, H, W, C), p["out_gn_w"], p["out_gn_b"], G, eps))
    return _sd_conv(h, p["conv_out_w"], p["conv_out_b"])


def _sd_vae_level(p, x, width):
    from deepspeed_tpu_torch.ops.spatial import kernels as sk
    w_ = width or SD_VAE
    h = sk.nhwc_bias_add(_sd_conv(x, p["conv_w"]), p["conv_b"])
    return _sd_resnet(h, p["res"], None, w_["groups"], w_["eps"])


def sd_vae_encode(p, images, width=None):
    """The VAE encoder's first level: conv 3 -> 128 at the image's size and
    one ResNet block (NHWC)."""
    return _sd_vae_level(p["encoder"], images, width)


def sd_vae_decode(p, latents, width=None):
    """The VAE decoder's entry: conv_in 4 -> 512 at the latent's size and
    one ResNet block (NHWC)."""
    return _sd_vae_level(p["decoder"], latents, width)


@contextlib.contextmanager
def sd_kv_head_shifted():
    """Kernel A fed the next kv head, where the denoiser calls it."""
    global _sd_attention
    real = _sd_attention
    _sd_attention = lambda q, k, v: real(q, k.roll(1, 2), v.roll(1, 2))
    try:
        yield
    finally:
        _sd_attention = real


def _sd_counts():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.spatial import kernels as sk
    return {"flash_attention_fwd_sd": fa.launches, "spatial_bias_add": sk.launches}


def _sd_reset():
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.spatial import kernels as sk
    fa.launches = sk.launches = 0


def _sd_sample_ulps(got, want):
    """Each sample's largest difference in bf16 ulps of its largest |want|."""
    return float(row_ulp_errs(got.reshape(got.shape[0], -1),
                              want.reshape(want.shape[0], -1)).max())


def _sd_card_vs_cpu(seed):
    """One denoiser step at a SD_PARITY_LATENT latent: the card in bf16
    (kernels) against the CPU in fp32 (plain versions) on the same
    bf16-rounded weights and inputs, each sample within LOGIT_ULP_TOL bf16
    ulps of its largest CPU value; A fed the next kv head must read above."""
    import torch
    gen = torch.Generator().manual_seed(seed + 5)
    p32 = sd_unet_params(gen, "cpu", torch.bfloat16)
    lat = torch.randn((SD_BATCH, SD_PARITY_LATENT, SD_PARITY_LATENT, SD_UNET["in_channels"]),
                      generator=gen).to(torch.bfloat16)
    t = torch.tensor(500.0)
    from deepspeed_tpu_torch.models.transformer import map_tree
    cpu_p = map_tree(lambda x: x.float(), p32)
    dev_p = map_tree(lambda x: x.to(CHECK_DEVICE, memory_format=torch.channels_last)
                     if x.dim() == 4 else x.to(CHECK_DEVICE), p32)
    if CHECK_DEVICE != "cuda":        # the CPU tests: both sides fp32
        dev_p = cpu_p
    want = sd_denoiser(cpu_p, lat.float(), t)
    dev_lat = lat.to(CHECK_DEVICE) if CHECK_DEVICE == "cuda" else lat.float()
    got = sd_denoiser(dev_p, dev_lat, t.to(CHECK_DEVICE)).float().cpu()
    with sd_kv_head_shifted():
        fault = sd_denoiser(dev_p, dev_lat, t.to(CHECK_DEVICE)).float().cpu()
    rec = {"latent": [SD_BATCH, SD_PARITY_LATENT, SD_PARITY_LATENT],
           "ulp_err": _sd_sample_ulps(got, want), "ulp_tol": LOGIT_ULP_TOL,
           "fault_ulp_err": {"kv_head_shifted": _sd_sample_ulps(fault, want)},
           "finite": bool(torch.isfinite(got).all())}
    failures = []
    if not rec["finite"]:
        failures.append("card-vs-CPU denoiser step: non-finite output")
    if not rec["ulp_err"] <= LOGIT_ULP_TOL:
        failures.append(f"card-vs-CPU denoiser step: {rec['ulp_err']} ulps > {LOGIT_ULP_TOL}")
    if not rec["fault_ulp_err"]["kv_head_shifted"] > LOGIT_ULP_TOL:
        failures.append(f"card-vs-CPU denoiser step: kv_head_shifted reads "
                        f"{rec['fault_ulp_err']['kv_head_shifted']} <= {LOGIT_ULP_TOL}")
    return rec, failures


def _timed(fn):
    """``(result, ms)``: one call on the host clock, ending in a sync."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def phase_diffusers(state, seed):
    """Stable Diffusion v1.5's first UNet level (SD_UNET, batch 2 for
    classifier-free guidance) through ``DSUNet`` (one CUDA graph) and
    eagerly, SD_STEPS calls each, alternated on the same evolving latents:
    every step's outputs bit-equal; A once a call and S SD_S_PER_CALL
    times, counted for the graph as replays x the launches its capture
    recorded; ms a step each way. ``DSVAE`` at SD v1.5's VAE widths: the
    encode graph (conv 3 -> 128 at 512 x 512 and a ResNet block) and the
    decode graph (conv_in 4 -> 512 at 64 x 64 and a ResNet block), each
    bit-equal to eager. ``donate_latents`` writes into the caller's
    latents. Then one step at a 16 x 16 latent, card bf16 against CPU fp32
    (:func:`_sd_card_vs_cpu`)."""
    import torch
    from deepspeed_tpu_torch.models import DSUNet, DSVAE
    dev, dt = CHECK_DEVICE, _card_dtype()
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = sd_unet_params(gen, dev, dt)
    L = SD_UNET["latent"]
    lat0 = torch.randn((SD_BATCH, L, L, SD_UNET["in_channels"]), generator=gen,
                       device=dev).to(dt)
    failures = []

    # launches of one eager call, then the capture (its warm-up runs the
    # function once more, eagerly)
    _sd_reset()
    t = torch.tensor(999.0, device=dev)
    sd_denoiser(p, lat0, t)
    per_call = _sd_counts()
    unet = DSUNet(sd_denoiser)
    _sd_reset()
    unet(p, lat0, t)
    setup = _sd_counts()
    graphed = unet.captures == 1
    captured = {k: setup[k] - per_call[k] if graphed else 0 for k in setup}

    _sd_reset()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    replays0 = unet.replays
    lat = lat0.clone()
    graph_ms, eager_ms, differ = [], [], []
    for i in range(SD_STEPS):
        t = torch.tensor(999.0 - 50.0 * i, device=dev)
        pair = []
        for mode in ((0, 1) if i % 2 == 0 else (1, 0)):
            fn = (lambda: unet(p, lat, t)) if mode == 0 else (lambda: sd_denoiser(p, lat, t))
            out, ms = _timed(fn)
            (graph_ms if mode == 0 else eager_ms).append(ms)
            pair.append((mode, out))
        g = dict(pair)[0]
        e = dict(pair)[1]
        differ.append(int((_bits(g) != _bits(e)).sum()))
        lat = (lat.float() - 0.05 * g.float()).to(dt)     # an Euler-like update, both ways alike
    counts = _sd_counts()
    replays = unet.replays - replays0
    launches = {k: counts[k] + replays * captured[k] for k in counts}
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda" else None
    rec = {"unet": {"latents": list(lat0.shape), "dtype": str(dt), "steps": SD_STEPS,
                    "captures": unet.captures, "replays": replays,
                    "per_call_launches": per_call, "captured_launches": captured,
                    "launches": launches, "elements_differing_per_step": differ,
                    "graph_ms_median": statistics.median(graph_ms),
                    "eager_ms_median": statistics.median(eager_ms),
                    "graph_ms": graph_ms, "eager_ms": eager_ms, "peak_gb": peak,
                    "finite": bool(torch.isfinite(lat.float()).all())}}
    want = {"flash_attention_fwd_sd": 2 * SD_STEPS,
            "spatial_bias_add": 2 * SD_STEPS * SD_S_PER_CALL}
    if dev == "cuda":     # the plain versions on the CPU launch nothing
        if per_call != {"flash_attention_fwd_sd": 1, "spatial_bias_add": SD_S_PER_CALL}:
            failures.append(f"an eager denoiser call launched {per_call}")
        if not graphed or captured != per_call:
            failures.append(f"the capture recorded {captured} (captures {unet.captures})")
        if launches != want:
            failures.append(f"denoiser launches {launches}, expected {want}")
    if any(differ):
        failures.append(f"graph and eager outputs differ: {differ} elements a step")
    if not rec["unet"]["finite"]:
        failures.append("non-finite latents after the loop")

    # donate_latents: the result lands in the caller's tensor
    donor = DSUNet(sd_denoiser, donate_latents=True)
    buf = lat0.clone()
    want_out = sd_denoiser(p, lat0, torch.tensor(999.0, device=dev))
    got = donor(p, buf, torch.tensor(999.0, device=dev))
    rec["donate_latents"] = {"same_tensor": got.data_ptr() == buf.data_ptr() or dev != "cuda",
                             "bit_equal": bool(torch.equal(_bits(got), _bits(want_out)))}
    if not all(rec["donate_latents"].values()):
        failures.append(f"donate_latents: {rec['donate_latents']}")
    del donor, buf, got, want_out

    # the VAE: two graphs, each bit-equal to eager
    vp = sd_vae_params(gen, dev, dt)
    vae = DSVAE(encode_fn=sd_vae_encode, decode_fn=sd_vae_decode)
    img = torch.randn((1, SD_VAE["image"], SD_VAE["image"], SD_VAE["in_channels"]),
                      generator=gen, device=dev).to(dt)
    z = torch.randn((1, L, L, SD_VAE["latent"]), generator=gen, device=dev).to(dt)
    vae_rec = {}
    for name, call, eager, x in (("encode", vae.encode, sd_vae_encode, img),
                                 ("decode", vae.decode, sd_vae_decode, z)):
        call(vp, x)                                 # capture
        _sd_reset()
        (g, g_ms), (e, e_ms) = _timed(lambda: call(vp, x)), _timed(lambda: eager(vp, x))
        n_s = _sd_counts()["spatial_bias_add"]
        n = int((_bits(g) != _bits(e)).sum())
        vae_rec[name] = {"input": list(x.shape), "output": list(g.shape),
                         "elements_differing": n, "graph_ms": g_ms, "eager_ms": e_ms,
                         "s_launches_eager": n_s}
        if n:
            failures.append(f"DSVAE.{name}: {n} elements differ from eager")
        if dev == "cuda" and n_s != SD_VAE_S_PER_CALL:
            failures.append(f"an eager VAE {name} launched S {n_s} times")
        del g, e
    vae_rec["replays"] = vae.replays
    rec["vae"] = vae_rec
    del vae, vp, img, z

    rec["card_vs_cpu"], more = _sd_card_vs_cpu(seed)
    failures += more
    state["diffusers_launches"] = launches
    emit("diffusers", **rec)
    check(not failures, "diffusers failed: " + "; ".join(failures))


TILED_SHAPE = (4, 2048, 4096, 11008)    # x [4, 2048, 4096] into Llama-2-7B's MLP up-projection
TILED_SPLITS = (4, 4)                   # in_splits, out_splits
TILED_ULP_TOL = 2.0


def phase_tiled_linear(state, seed):
    """``TiledLinear`` at Llama-2-7B's MLP up-projection (4096 -> 11008,
    tiled 4 x 4) on x ``[4, 2048, 4096]``: both lowerings (one einsum; the
    loop over out-rows of tiles) against the dense product, forward and
    backward: outputs, dx and dW (tiled back to dense) within TILED_ULP_TOL
    bf16 ulps of each row's largest dense value; the tile grid read
    transposed must read above it. Each lowering's forward and forward +
    backward ms against dense, and its device peak."""
    import torch
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear
    B, S, Din, Dout = TILED_SHAPE
    dev, dt = CHECK_DEVICE, _card_dtype()
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, Din), generator=gen, device=dev).to(dt)
    w = (torch.randn((Din, Dout), generator=gen, device=dev) * Din**-0.5).to(dt)
    dy = torch.randn((B, S, Dout), generator=gen, device=dev).to(dt)

    def fwd_bwd(fn, weight):
        xr, wr = x.detach().requires_grad_(), weight.detach().requires_grad_()
        y = fn(xr, wr)
        y.backward(dy)
        return y.detach(), xr.grad, wr.grad

    def peak_of(fn):
        if dev != "cuda":
            return None
        _sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        _sync()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    dense = lambda xr, wr: xr @ wr
    y0, dx0, dw0 = fwd_bwd(dense, w)
    timer = cuda_ms if dev == "cuda" else (lambda fn, reps=1, warmup=0: _timed(fn)[1])
    rec = {"shape": list(TILED_SHAPE), "splits": list(TILED_SPLITS), "dtype": str(dt),
           "ulp_tol": TILED_ULP_TOL,
           "dense": {"fwd_ms": timer(lambda: dense(x, w), reps=10),
                     "fwd_bwd_ms": timer(lambda: fwd_bwd(dense, w), reps=5),
                     "peak_gb": peak_of(lambda: fwd_bwd(dense, w))}}
    failures = []
    for scan in (False, True):
        tl = TiledLinear(Din, Dout, *TILED_SPLITS, bias=False, scan_tiles=scan)
        wt = tl.from_dense(w)["w"]
        run = lambda xr, wr: tl({"w": wr}, xr)
        y, dx, dwt = fwd_bwd(run, wt)
        dw = tl.to_dense({"w": dwt})
        errs = {"out": ulp_err(y, y0), "dx": ulp_err(dx, dx0), "dw": ulp_err(dw, dw0)}
        # a fault: the tile grid read with its in and out splits swapped
        fault = ulp_err(tl({"w": wt.transpose(0, 1)}, x).detach(), y0)
        name = "scan_tiles" if scan else "einsum"
        rec[name] = {"ulp_err": errs, "fault_ulp_err": {"grid_transposed": fault},
                     "fwd_ms": timer(lambda: run(x, wt), reps=10),
                     "fwd_bwd_ms": timer(lambda: fwd_bwd(run, wt), reps=5),
                     "peak_gb": peak_of(lambda: fwd_bwd(run, wt))}
        for k, e in errs.items():
            if not e <= TILED_ULP_TOL:
                failures.append(f"{name} {k}: {e} bf16 ulps > {TILED_ULP_TOL}")
        if not fault > TILED_ULP_TOL:
            failures.append(f"{name}: the transposed grid reads {fault} <= {TILED_ULP_TOL}")
        del y, dx, dwt, dw, wt
    emit("tiled_linear", **rec)
    check(not failures, "tiled_linear failed: " + "; ".join(failures))


AUTOTUNE_MICRO = (1, 4)          # min and max micro-batch: 1, 2 and 4 measured
AUTOTUNE_PROFILE = (1, 3)        # start_profile_step, end_profile_step: 1 warm + 2 timed steps
AUTOTUNE_SEQ = TRAIN_SEQ
AUTOTUNE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_check", "autotune")


def autotune_llama():
    """autotune's model: the train cell's (Llama-2-7B width, TRAIN_LAYERS)."""
    from deepspeed_tpu_torch.models import llama
    return llama("7b", n_layer=TRAIN_LAYERS)


def autotune_launch_rule(model, params, gas, steps):
    """The kernels' launches of ``steps`` train_batch calls of the train cell
    without remat (the autotuner's fast mode searches remat "none"): A, C
    and D once a layer a micro-step, each fused CE kernel once a
    micro-step, E once a parameter leaf a step."""
    L = model.config.n_layer
    leaves = len(list(params.parameters()))
    return {"flash_attention_fwd": L * gas * steps, "flash_attention_bwd_dq": L * gas * steps,
            "flash_attention_bwd_dkv": L * gas * steps, "fused_adam": leaves * steps,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"), gas * steps)}


def phase_autotune(state, seed):
    """The autotuner on the train cell (TRAIN_CONFIG, S TRAIN_SEQ), fast
    mode, ZeRO stage 0, micro-batches 1, 2 and 4, profile steps 1-3: each
    trial's estimate beside its measured device peak and its launches
    against the train rule; the winner the best of the measured records;
    ``ds_config_optimal.json`` (with its model overrides applied) trains
    one step through ``initialize``. The results directory is deleted
    after."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.autotuning import Autotuner, AutotuningConfig, apply_optimal
    dev, dt = CHECK_DEVICE, _card_dtype()
    model = autotune_llama()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed), device=dev,
                               dtype=dt)
    base = {k: v for k, v in TRAIN_CONFIG.items() if k != "train_batch_size"}
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    cfg = AutotuningConfig(fast=True, zero_stages=[0],
                           min_train_micro_batch_size_per_gpu=AUTOTUNE_MICRO[0],
                           max_train_micro_batch_size_per_gpu=AUTOTUNE_MICRO[1],
                           start_profile_step=AUTOTUNE_PROFILE[0],
                           end_profile_step=AUTOTUNE_PROFILE[1], results_dir=AUTOTUNE_DIR)
    at = Autotuner(model, params, base, cfg, seq_len=AUTOTUNE_SEQ, device=dev)
    steps = max(1, cfg.start_profile_step) + max(1, cfg.end_profile_step - cfg.start_profile_step)
    gas = base["gradient_accumulation_steps"]
    trials, failures = [], []
    real = at.measure

    def measured(cand):
        _reset_train_counters()
        t0 = time.perf_counter()
        val = real(cand)
        got = {k: v for k, v in _train_counters().items() if v}
        want = autotune_launch_rule(model, params, gas, steps)
        est = at.estimate_bytes(cand)
        trials.append({"candidate": cand.name(), "metric": val, "seconds": time.perf_counter() - t0,
                       "est_gb": est / 1e9, "peak_gb": (at.last_peak_bytes or 0) / 1e9 or None,
                       "launches": got})
        if dev == "cuda" and got != want:
            failures.append(f"{cand.name()}: launches {got}, expected {want}")
        return val
    at.measure = measured
    try:
        best = at.tune()
        measured_recs = [r for r in at.records if r.metric_val is not None]
        winner = max(measured_recs, key=lambda r: r.metric_val)
        with open(os.path.join(AUTOTUNE_DIR, "ds_config_optimal.json")) as f:
            optimal = json.load(f)
        if best["train_micro_batch_size_per_gpu"] != winner.candidate.micro_batch:
            failures.append(f"the optimal micro-batch {best['train_micro_batch_size_per_gpu']} "
                            f"is not the best measured {winner.candidate.name()}")
        if optimal != best:
            failures.append("ds_config_optimal.json is not the returned config")
        if len(measured_recs) != len(at._mbs_list()):
            failures.append(f"{len(measured_recs)} trials measured")
        # the optimal config trains one step through initialize
        tuned, config = apply_optimal(model, optimal)
        _reset_train_counters()
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=tuned, model_parameters=params,
                                                         config=config, device=dev)
        micro = engine.train_micro_batch_size_per_gpu()
        ids = np.random.default_rng(seed).integers(0, model.config.vocab_size,
                                                   size=(micro * gas, AUTOTUNE_SEQ))
        loss = float(engine.train_batch({"input_ids": ids}))
        step_launches = {k: v for k, v in _train_counters().items() if v}
        if not np.isfinite(loss):
            failures.append(f"the optimal config's step: loss {loss}")
        if dev == "cuda" and step_launches != autotune_launch_rule(model, params, gas, 1):
            failures.append(f"the optimal config's step launched {step_launches}")
        del engine
        _free()
    finally:
        shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    launches = {}
    for t in trials:
        for k, v in t["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for k, v in step_launches.items():
        launches[k] = launches.get(k, 0) + v
    state["autotune_launches"] = launches
    emit("autotune", trials=trials, optimal=optimal, winner=winner.candidate.name(),
         optimal_step_loss=loss, budget_gb=at.hbm_budget() / 1e9, launches=launches)
    check(not failures, "autotune failed: " + "; ".join(failures))


TOOLING_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_check", "tooling")
TOOLING_BERT = (2, 32, 512)      # the flops profile: bert_train's model at 2 layers, [32, 512]
ELASTIC_SECTION = {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [2, 4],
                   "min_gpus": 1, "max_gpus": 8, "version": 0.2}


def _tree_shapes(tree):
    from deepspeed_tpu_torch.models.transformer import map_tree
    return map_tree(lambda t: (tuple(t.shape), t.dtype), tree.to_dict())


def bert_products(cfg, B, S, plain_attention=False):
    """The product flops of one BertModel MLM forward at [B, S], reckoned
    from the shapes: a layer's q, k, v, o and two FFN matmuls, the pooler
    (the [CLS] rows), the MLM transform and the tied decoder. Attention's
    two products run inside kernel A and count 0; with
    ``plain_attention`` (its plain version, on the CPU) they count
    2 B H S^2 Hd each."""
    N, D, F, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab_size
    attn = 4 * B * S * S * D if plain_attention else 0
    return float(cfg.n_layer * (2 * N * (4 * D * D + 2 * D * F) + attn) + 2 * B * D * D
                 + 2 * N * D * D + 2 * N * D * V)


def _dscli(*argv):
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.cli", *argv],
                          capture_output=True, text=True, timeout=600, cwd=repo, env=env)


def phase_tooling(state, seed):
    """The one-card tooling. OnDevice(meta): the full Llama-2-7B built on
    the meta device leaves ``memory_allocated`` unchanged, with the shapes
    (and dtype override) of a real 1-layer build's layer and outer leaves.
    The flops profiler: bert_train's model at 2 layers on [32, 512] with
    its padding mask, the profile's product flops equal to the reckoned
    products, A launched and counting 0. ``dscli report`` in a subprocess
    exits 0 and names the card as nvidia-smi does. ``dscli elastic -w 1``
    prints the in-process plan, and ``initialize`` takes its batch from it."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import OnDevice
    from deepspeed_tpu_torch.elasticity import compute_elastic_config
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
    dev, dt = CHECK_DEVICE, _card_dtype()
    failures = []

    # OnDevice(meta)
    alloc = lambda: torch.cuda.memory_allocated() if dev == "cuda" else 0
    before = alloc()
    t0 = time.perf_counter()
    with OnDevice(dtype=dt, device="meta"):
        meta = tooling_llama().init_params(device=dev)
    meta_s = time.perf_counter() - t0
    grown = alloc() - before
    real_model = tooling_llama(n_layer=1)
    real = real_model.init_params(torch.Generator(device=dev).manual_seed(seed), device=dev,
                                  dtype=dt)
    ms, rs = _tree_shapes(meta), _tree_shapes(real)
    n_meta = sum(p.numel() for p in meta.parameters())
    on_meta = all(p.is_meta for p in meta.parameters())
    same = (all(ms[k] == rs[k] for k in rs if k != "layers")
            and all(layer == rs["layers"][0] for layer in ms["layers"]))
    rec = {"on_device_meta": {"params": n_meta, "layers": len(ms["layers"]),
                              "allocated_bytes_grown": grown, "all_meta": on_meta,
                              "shapes_equal_real_build": same, "seconds": meta_s}}
    if grown != 0 or not on_meta or not same:
        failures.append(f"OnDevice(meta): {rec['on_device_meta']}")
    del meta, real, real_model

    # the flops profiler
    L, B, S = TOOLING_BERT
    model = bert_large(n_layer=L, attention_backend="flash")
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed), device=dev,
                               dtype=dt)
    batch, _ = mlm_batch(model.config.vocab_size, B, S, seed)
    ids = torch.as_tensor(batch["input_ids"], device=dev)
    mask = torch.as_tensor(batch["attention_mask"], device=dev)
    fa.launches = 0
    prof = FlopsProfiler(model=model)
    prof.profile_fn(model.forward, params, ids, mask)
    out_file = os.path.join(TOOLING_DIR, "flops.txt")
    os.makedirs(TOOLING_DIR, exist_ok=True)
    prof.print_model_profile(output_file=out_file)
    with open(out_file) as f:
        written = f.read()
    want = bert_products(model.config, B, S, plain_attention=dev != "cuda")
    rec["flops_profiler"] = {"shape": [L, B, S], "products": prof.breakdown.get("dot_general"),
                             "products_reckoned": want, "total": prof.get_total_flops(),
                             "breakdown": prof.breakdown, "a_launches": fa.launches,
                             "params": prof.get_total_params(),
                             "written": written.strip().splitlines()}
    if prof.breakdown.get("dot_general") != want:
        failures.append(f"profiled products {prof.breakdown.get('dot_general')} != {want}")
    if "conv_general_dilated" in prof.breakdown:
        failures.append("a convolution counted in a BERT forward")
    if fa.launches != (L if dev == "cuda" else 0):
        failures.append(f"A launched {fa.launches} times in the profiled forward")
    state["tooling_launches"] = {"flash_attention_fwd_bert": fa.launches}

    # dscli report
    res = _dscli("report")
    card = state.get("card", "").split(",")[0].strip()
    rec["report"] = {"rc": res.returncode, "names_card": bool(card) and card in res.stdout,
                     "card": card, "tail": res.stdout.strip().splitlines()[-6:]}
    if res.returncode != 0 or (dev == "cuda" and not rec["report"]["names_card"]):
        failures.append(f"dscli report: rc {res.returncode}, card {card!r} named "
                        f"{rec['report']['names_card']}: {res.stderr[-500:]}")

    # dscli elastic, and initialize taking its batch from the plan
    config = {"elasticity": ELASTIC_SECTION, "bf16": {"enabled": dev == "cuda"},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}}
    path = os.path.join(TOOLING_DIR, "elastic.json")
    with open(path, "w") as f:
        json.dump(config, f)
    res = _dscli("elastic", path, "-w", "1")
    batch_sz, micro, gas = compute_elastic_config(config, world_size=1)
    line = f"world_size=1: train_batch={batch_sz}, micro_batch={micro}, " \
           f"gradient_accumulation_steps={gas}"
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, device=dev,
        config={**config, "train_batch_size": batch_sz, "train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": gas})
    got = (engine.train_batch_size(), engine.train_micro_batch_size_per_gpu(),
           engine.gradient_accumulation_steps())
    rec["elastic"] = {"rc": res.returncode, "printed": res.stdout.strip(),
                      "in_process": [batch_sz, micro, gas], "engine": list(got)}
    if res.returncode != 0 or res.stdout.strip() != line:
        failures.append(f"dscli elastic printed {res.stdout.strip()!r}, expected {line!r}")
    if got != (batch_sz, micro, gas):
        failures.append(f"initialize took batch {got}, the plan {(batch_sz, micro, gas)}")
    del engine, params, model
    shutil.rmtree(TOOLING_DIR, ignore_errors=True)
    emit("tooling", **rec)
    check(not failures, "tooling failed: " + "; ".join(failures))


def tooling_llama(n_layer=None):
    """OnDevice's model: Llama-2-7B (``n_layer`` layers; default all 32)."""
    from deepspeed_tpu_torch.models import llama
    return llama("7b", **({"n_layer": n_layer} if n_layer else {}))


# the multi-process phases (comm, launch): comm/ over NCCL at one rank, the
# launcher spawning the train cell's rank, the elastic agent
LAUNCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_check", "launch")
LAUNCH_STEPS = 3
LAUNCH_MODEL = None          # None: llama("7b", n_layer=TRAIN_LAYERS); else TransformerConfig kwargs
COMM_SHAPE = (4, 1024)       # the phase's fp32 and bf16 tensors
COMM_PRODUCT_BF16 = 64       # the bf16 PRODUCT's elements (its roundings are the card's own)
COMM_BENCH_SIZES = ((1 << 20, 64 << 20), (256 << 20, 256 << 20))   # dscli bench: 1, 8, 64, 256 MB
COMM_PRODUCT_TOL = 1e-6      # PRODUCT, relative: numpy's log / exp against the card's


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bf16_round(x):
    """``x`` (fp32 numpy) rounded to bf16 by round-to-nearest-even, as fp32."""
    import numpy as np
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _product_want(x, bf16):
    """JAX's sign-aware PRODUCT over one rank, in numpy: sign(x) exp(log|x|),
    each op rounded to bf16 for a bf16 tensor."""
    import numpy as np
    r = _bf16_round if bf16 else (lambda a: a.astype(np.float32))
    return r(np.sign(x) * r(np.exp(r(np.log(np.abs(x))))))


def comm_checks(seed):
    """Every collective of ``comm`` at one rank on its own process group
    (nccl on the card, gloo on the CPU), on fp32 and bf16 tensors, against
    the values numpy gives for JAX's one-device mesh: the identity, but
    PRODUCT's formula. Limit 0; PRODUCT within COMM_PRODUCT_TOL relative.
    The comms logger's count and bytes per op must equal the calls made.
    Returns the record; raises on a failure. The process group is destroyed,
    and MASTER_ADDR / MASTER_PORT (a free port where unset) restored, before
    returning."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    import deepspeed_tpu_torch.comm as dist

    device = CHECK_DEVICE
    saved = {k: os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT")}
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    os.environ.setdefault("MASTER_PORT", str(_free_port()))
    try:
        t0 = time.perf_counter()
        dist.init_distributed(dist_backend="nccl" if device == "cuda" else "gloo", rank=0,
                              world_size=1, verbose=False)
        init_s = time.perf_counter() - t0
        check(dist.has_process_group() and tdist.get_world_size() == 1,
              "init_distributed(rank=0, world_size=1) made no process group")
        backend = tdist.get_backend()
        check(backend == ("nccl" if device == "cuda" else "gloo"), f"backend {backend}")
        dist.init_mesh({"dp": 1})
        cl = dist.comms_logger()
        cl.comms_dict = {}
        dist.configure(enabled=True, prof_all=True)
        rng = np.random.default_rng(seed + 26)
        calls, failures, gaps = {}, [], {}

        def called(name, t):
            sizes = calls.setdefault(name, {})
            nbytes = t.numel() * t.element_size()
            sizes[nbytes] = sizes.get(nbytes, 0) + 1

        for dt in ("fp32", "bf16"):
            tdt = torch.float32 if dt == "fp32" else torch.bfloat16
            x = rng.standard_normal(COMM_SHAPE).astype(np.float32)
            want = _bf16_round(x) if dt == "bf16" else x
            t = torch.from_numpy(x).to(device=device, dtype=tdt)
            cases = {f"all_reduce_{op}": (lambda op=op: dist.all_reduce(
                t, op=getattr(dist.ReduceOp, op)), "all_reduce", want)
                for op in ("SUM", "AVG", "MAX", "MIN")}
            cases.update({
                "all_gather_tiled": (lambda: dist.all_gather(t), "all_gather", want),
                "all_gather_stacked": (lambda: dist.all_gather(t, tiled=False), "all_gather",
                                       want[None]),
                "reduce_scatter_tensor": (lambda: dist.reduce_scatter_tensor(None, t),
                                          "reduce_scatter", want),
                "all_to_all_single": (lambda: dist.all_to_all_single(t), "all_to_all", want),
                "broadcast": (lambda: dist.broadcast(t, src=0), "broadcast", want),
                "ring_send_recv": (lambda: dist.ring_send_recv(t, shift=1), "ppermute", want),
            })
            for name, (fn, log_name, w) in cases.items():
                got = fn().float().cpu().numpy()
                called(log_name, t)
                gap = float(np.abs(got - w).max()) if got.shape == w.shape else float("inf")
                gaps[f"{name}_{dt}"] = gap
                if gap != 0.0:
                    failures.append(f"{name} {dt}: {gap} from numpy")
            n = COMM_SHAPE[0] * COMM_SHAPE[1] if dt == "fp32" else COMM_PRODUCT_BF16
            p = (rng.uniform(0.5, 2.0, n) * np.where(rng.random(n) < 0.4, -1.0, 1.0))
            p = p.astype(np.float32)
            p = _bf16_round(p) if dt == "bf16" else p
            tp = torch.from_numpy(p).to(device=device, dtype=tdt)
            got = dist.all_reduce(tp, op=dist.ReduceOp.PRODUCT).float().cpu().numpy()
            called("all_reduce", tp)
            w = _product_want(p, dt == "bf16")
            gap = float(np.abs(got - w).max() / np.abs(w).max())
            gaps[f"all_reduce_PRODUCT_{dt}"] = gap
            if not gap <= COMM_PRODUCT_TOL:
                failures.append(f"PRODUCT {dt}: {gap} relative from numpy")
        b = dist.barrier()
        called("all_reduce", b)
        if float(b.abs().sum()) != 0.0:
            failures.append("barrier returned non-zero")
        records = {name: {size: rec[0] for size, rec in sizes.items()}
                   for name, sizes in cl.comms_dict.items()}
        if records != calls:
            failures.append(f"comms logger records {records} != calls {calls}")
        op_ms = {name: {str(size): {"count": v["count"], "avg_ms": v["avg_latency_ms"]}
                        for size, v in sizes.items()}
                 for name, sizes in cl.log_all(print_log=False).items()}
        dist.configure(enabled=False)
        check(not failures, "comm failed: " + "; ".join(failures))
        return {"backend": backend, "init_s": init_s, "gaps": gaps, "records": {
            k: {str(s): c for s, c in v.items()} for k, v in records.items()},
            "op_ms": op_ms}
    finally:
        dist.configure(enabled=False)
        dist.destroy_process_group()
        _restore_env(saved)


def _restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _bench_table(text):
    rows = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[0] in ("all_reduce", "all_gather", "reduce_scatter",
                                            "all_to_all", "broadcast"):
            rows.append({"op": parts[0], "bytes": int(parts[1]), "latency_us": float(parts[2]),
                         "algbw_GBps": float(parts[3]), "busbw_GBps": float(parts[4])})
    return rows


def _bench_sizes(lo, hi):
    sizes, size = [], lo
    while size <= hi:
        sizes.append(size)
        size *= 8
    return sizes


def phase_comm(state, seed):
    """comm/ at one rank over NCCL: :func:`comm_checks`, then ``dscli
    bench`` (in this process, its own world of one) at 1 MB to 256 MB,
    its table with the card's name and power limit."""
    import io

    from deepspeed_tpu_torch import cli

    t0 = time.perf_counter()
    rec = comm_checks(seed)
    checks_s = time.perf_counter() - t0
    text = []
    for lo, hi in COMM_BENCH_SIZES:
        # bench sets MASTER_ADDR / MASTER_PORT where unset (a free port), as
        # its own process would
        saved = {k: os.environ.pop(k, None) for k in ("MASTER_ADDR", "MASTER_PORT")}
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(["bench", "--minsize", str(lo), "--maxsize", str(hi),
                          "--device", CHECK_DEVICE])
        finally:
            _restore_env(saved)
        text.append(buf.getvalue())
    table = _bench_table("\n".join(text))
    header = [line for t in text for line in t.splitlines() if line.startswith("comm bench")]
    want = sorted((op, size) for op in ("all_reduce", "all_gather", "reduce_scatter",
                                        "all_to_all", "broadcast")
                  for lo, hi in COMM_BENCH_SIZES for size in _bench_sizes(lo, hi))
    emit("comm", **rec, checks_s=checks_s, bench=table, bench_header=header,
         seconds=time.perf_counter() - t0, card=state.get("card"))
    check(sorted((r["op"], r["bytes"]) for r in table) == want,
          f"dscli bench printed {[(r['op'], r['bytes']) for r in table]}, expected {want}")
    check(all(r["latency_us"] > 0 and r["algbw_GBps"] >= 0 for r in table),
          "a bench row with no time")


def _launch_setup(seed):
    """The launch phase's engine on CHECK_DEVICE, its model (Llama-2-7B
    width at TRAIN_LAYERS, or LAUNCH_MODEL) and one seeded token batch: the
    same in the launched rank and in this process."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, llama

    cuda = CHECK_DEVICE == "cuda"
    model = llama("7b", n_layer=TRAIN_LAYERS) if LAUNCH_MODEL is None \
        else CausalLM(TransformerConfig(**LAUNCH_MODEL))
    config = TRAIN_CONFIG if cuda else {**TRAIN_CONFIG, "bf16": {"enabled": False}}
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE,
                               dtype=torch.bfloat16 if cuda else torch.float32)
    engine = _train_engine(model, params, config, device=CHECK_DEVICE)
    del params
    _free()
    rng = np.random.default_rng(seed + 2)
    seq = TRAIN_SEQ if LAUNCH_MODEL is None else LAUNCH_MODEL["max_seq"]
    tokens = rng.integers(0, model.config.vocab_size, size=(config["train_batch_size"], seq))
    return engine, {"input_ids": torch.from_numpy(tokens).to(CHECK_DEVICE)}


def _json_round(x):
    return json.loads(json.dumps(x))


def worker_launch(out, seed):
    """The launched rank: the kernels from the build cache, the train cell
    for LAUNCH_STEPS steps on the process group the launcher's variables
    make, its losses, state fingerprint and launches written to
    ``out/result.json``."""
    t_start = time.time()
    import torch

    import deepspeed_tpu_torch.comm as dist
    rec = {"t_start": t_start, "torch_import_s": time.time() - t_start,
           "env": {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE",
                                                  "CUDA_VISIBLE_DEVICES", "MASTER_PORT")}}
    if CHECK_DEVICE == "cuda":
        from deepspeed_tpu_torch.ops.kernels import build
        t = time.perf_counter()
        _, log = build.build()
        for name in build.SOURCES:
            build.load(name)
        rec.update(build_cache_s=time.perf_counter() - t, built=sorted(log))
    t = time.perf_counter()
    engine, batch = _launch_setup(seed)
    _sync()
    rec["init_s"] = time.perf_counter() - t
    import torch.distributed as tdist
    rec.update(process_group=dist.has_process_group(), backend=tdist.get_backend()
               if dist.has_process_group() else None,
               world=tdist.get_world_size() if dist.has_process_group() else None,
               dp=list(engine._dp or ()), flat=engine._flat_grads is not None,
               device=str(engine.device))
    _reset_train_counters()
    losses, step_s, per_step = _timed_steps(engine, batch, LAUNCH_STEPS)
    rec.update(losses=losses, step_s=step_s, per_step=per_step,
               fingerprint=_json_round(state_fingerprint(engine)),
               launch_rule=train_launch_rule(engine) if CHECK_DEVICE == "cuda" else {})
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(rec, f)
    del engine
    dist.destroy_process_group()
    return 0


def worker_elastic(out, seed):
    """The elastic agent's worker: attempt 0 exits 1 at once; later
    attempts run :func:`comm_checks` on the agent's rank environment."""
    attempt = int(os.environ["DSTPU_RESTART_COUNT"])
    with open(os.path.join(out, f"attempt_{attempt}"), "w") as f:
        f.write(os.environ.get("RANK", ""))
    if attempt == 0:
        return 1
    rec = comm_checks(seed)
    with open(os.path.join(out, "elastic.json"), "w") as f:
        json.dump({"attempt": attempt, "backend": rec["backend"]}, f)
    return 0


def _worker_cmd(kind, out, seed):
    return [os.path.abspath(__file__), "--worker", kind, "--worker-out", out, "--seed", str(seed),
            "--worker-device", CHECK_DEVICE,
            *(["--worker-model", json.dumps(LAUNCH_MODEL)] if LAUNCH_MODEL else [])]


def phase_launch(state, seed):
    """The launcher end to end: ``python -m deepspeed_tpu_torch.cli run
    --num_gpus 1`` spawns one rank of the train cell (this script behind
    ``--worker launch``) through the runner and launch.py, its stdout in
    LAUNCH_DIR/logs; its LAUNCH_STEPS losses and state must equal the same
    steps run here without a process group (limit 0), its launches the
    train rule. Then DSElasticAgent runs the comm checks as a worker that
    fails its first attempt: SUCCEEDED after 1 restart."""
    import torch

    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.elasticity import DSElasticAgent, WorkerSpec, WorkerState

    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    os.makedirs(LAUNCH_DIR)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    _free()
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.cli", "run", "--num_gpus", "1",
         f"--master_port={_free_port()}",
         f"--enable_each_rank_log={os.path.join(LAUNCH_DIR, 'logs')}",
         *_worker_cmd("launch", LAUNCH_DIR, seed)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    run_s = time.time() - t0
    if proc.returncode != 0:
        log = os.path.join(LAUNCH_DIR, "logs", "rank_0.log")
        tail = open(log).read()[-4000:] if os.path.exists(log) else ""
        raise RuntimeError(f"cli run exited {proc.returncode}: {proc.stderr[-2000:]}\n{tail}")
    with open(os.path.join(LAUNCH_DIR, "result.json")) as f:
        rank = json.load(f)

    check(not dist.has_process_group(), "the reference run must have no process group")
    t = time.perf_counter()
    engine, batch = _launch_setup(seed)
    _sync()
    init_s = time.perf_counter() - t
    check(engine._dp is None, "the in-process engine averaged over a process group")
    _reset_train_counters()
    losses, step_s, per_step = _timed_steps(engine, batch, LAUNCH_STEPS)
    fingerprint = _json_round(state_fingerprint(engine))
    del engine, batch
    _free()

    failures = []
    if rank["env"]["CUDA_VISIBLE_DEVICES"] != "0" or rank["env"]["WORLD_SIZE"] != "1":
        failures.append(f"rank environment {rank['env']}")
    want_backend = "nccl" if CHECK_DEVICE == "cuda" else "gloo"
    if not (rank["process_group"] and rank["backend"] == want_backend and rank["world"] == 1
            and rank["dp"] == ["dp"] and rank["flat"]):
        failures.append(f"the rank trained without a {want_backend} data-parallel group: "
                        f"{ {k: rank[k] for k in ('process_group', 'backend', 'world', 'dp')} }")
    if rank.get("built"):
        failures.append(f"the rank compiled {rank['built']} (the build cache missed)")
    if rank["losses"] != losses:
        failures.append(f"launched losses {rank['losses']} != in-process {losses}")
    if rank["fingerprint"] != fingerprint:
        diff = sorted(k for k in fingerprint if rank["fingerprint"].get(k) != fingerprint[k])
        failures.append(f"launched state differs from the in-process run's in {diff[:8]}")
    for k, n in rank["launch_rule"].items():
        if any(s[k] != n for s in rank["per_step"]):
            failures.append(f"{k} launches per step {[s[k] for s in rank['per_step']]} != {n}")
    state["launch_launches"] = {k: sum(s[k] for s in rank["per_step"])
                                for k in rank["launch_rule"]}

    # the elastic agent over the comm checks; attempt 0 fails
    agent_dir = os.path.join(LAUNCH_DIR, "elastic")
    os.makedirs(agent_dir)
    t = time.perf_counter()
    spec = WorkerSpec(entrypoint=[sys.executable, *_worker_cmd("elastic", agent_dir, seed)],
                      local_world_size=1, max_restarts=2, monitor_interval=0.2,
                      master_port=_free_port())
    res = DSElasticAgent(spec, env={"PYTHONPATH": env["PYTHONPATH"]}).run()
    elastic_s = time.perf_counter() - t
    attempts = sorted(f for f in os.listdir(agent_dir) if f.startswith("attempt_"))
    if res.state != WorkerState.SUCCEEDED or res.restarts != 1 or \
            attempts != ["attempt_0", "attempt_1"]:
        failures.append(f"elastic agent: {res.state} after {res.restarts} restarts, {attempts}")
    emit("launch", steps=LAUNCH_STEPS, losses=losses, launched_losses=rank["losses"],
         fingerprint_equal=rank["fingerprint"] == fingerprint,
         spawn_s=rank["t_start"] - t0, run_s=run_s, torch_import_s=rank["torch_import_s"],
         build_cache_s=rank.get("build_cache_s"), built=rank.get("built"),
         launched_init_s=rank["init_s"], launched_step_s=rank["step_s"], init_s=init_s,
         step_s=step_s, launches_per_step=rank["per_step"], launch_rule=rank["launch_rule"],
         rank_env=rank["env"], backend=rank["backend"],
         elastic={"state": res.state.value, "restarts": res.restarts,
                  "return_codes": res.return_codes, "attempts": attempts,
                  "seconds": elastic_s},
         card=state.get("card"))
    check(not failures, "launch failed: " + "; ".join(failures))
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)


ZERO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_check", "zero")
ZERO_STEPS = 3
#: the zero phase's runs: (tag, ZeRO stage, LAMB); each holds to the
#: stage-0 run of its optimizer
ZERO_RUNS = (("adamw_stage0", 0, False), ("adamw_stage1", 1, False),
             ("adamw_stage2", 2, False), ("adamw_stage3", 3, False),
             ("lamb_stage0", 0, True), ("lamb_stage2", 2, True))
ZERO_RECKON_WORLDS = (2, 4, 8)


def _zero_config(stage, lamb):
    """The train cell's config (AdamW through FusedAdam) or the train_lamb
    cell's (FusedLamb with MoQ, stochastic rounding on K8) at ZeRO
    ``stage``, gas 2."""
    cfg = {**(LAMB_CONFIG if lamb else TRAIN_CONFIG), "zero_optimization": {"stage": stage}}
    if CHECK_DEVICE != "cuda":
        cfg["bf16"] = {"enabled": False}
    return cfg


def _zero_shapes(engine):
    """Every leaf's name and full shape, partitioned or not."""
    if engine._zero is not None:
        return [(n, engine._zero.shape(n)) for n in engine._names]
    return [(n, tuple(p.shape)) for n, p in engine.state.params.named_parameters()]


def zero_launch_rule(engine, lamb):
    """The kernels' launches in one train_batch of a ZeRO run: A twice a
    layer a micro-step (forward and remat recompute), C and D once, each
    fused CE kernel once a micro-step; E (or K7's moments and apply) once a
    leaf segment this rank updates (every leaf over one rank), K7's ratio
    once a JAX leaf; with LAMB, MoQ's K8 and its absmax kernel once a port
    leaf of each JAX leaf of stacked rank >= 2 (the compute params are
    whole at stages 1-2), as in the train_lamb phase."""
    from deepspeed_tpu_torch.runtime.utils import jax_leaves
    cfg = engine.module.config
    gas = engine.gradient_accumulation_steps()
    segments = len(engine._zero.names) if engine._zero is not None else len(engine._names)
    ce = gas if engine._config.fused_cross_entropy != "off" else 0
    rule = {"flash_attention_fwd": 2 * cfg.n_layer * gas,
            "flash_attention_bwd_dq": cfg.n_layer * gas,
            "flash_attention_bwd_dkv": cfg.n_layer * gas,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"), ce)}
    shapes = dict(_zero_shapes(engine))
    quantized = sum(len(ns) for path, ns in jax_leaves(list(shapes)).items()
                    if len(shapes[ns[0]]) + (path[0] == "layers") >= 2) if lamb else 0
    if lamb:
        rule.update(fused_adam=0, fused_lamb_moments=segments, fused_lamb_apply=segments,
                    fused_lamb_ratio=len(engine._groups))
    else:
        rule.update(fused_adam=segments, fused_lamb_moments=0, fused_lamb_apply=0,
                    fused_lamb_ratio=0)
    rule.update(sr_quantize=quantized, sr_absmax=quantized)
    return rule


def zero_reckoned_bytes(engine, stage, worlds=ZERO_RECKON_WORLDS):
    """The bytes one rank would hold at each data-parallel world, reckoned
    from the flat units' partition sizes (not measured: one card): compute
    params in the compute dtype, fp32 masters (mixed precision), the
    optimizer's two fp32 moments, the accumulation buffer."""
    import torch
    from deepspeed_tpu_torch.runtime.zero.partition import build_units, held_elements
    shapes = _zero_shapes(engine)
    cbytes = torch.finfo(engine.compute_dtype).bits // 8
    gbytes = torch.finfo(engine.grad_acc_dtype).bits // 8
    out = {}
    for n in worlds:
        held = held_elements(build_units(shapes, n), stage, engine.zero_rules)
        parts = {"params": held["params"] * cbytes,
                 "master": held["master"] * 4 if engine.mixed_precision else 0,
                 "optimizer": 2 * held["master"] * 4, "grads": held["grads"] * gbytes}
        out[str(n)] = {**parts, "total": sum(parts.values())}
    return out


def _zero_setup(seed):
    """The zero phase's model (Llama-2-7B width at TRAIN_LAYERS, or
    LAUNCH_MODEL), its seeded params on CHECK_DEVICE and one token batch."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, llama

    cuda = CHECK_DEVICE == "cuda"
    model = llama("7b", n_layer=TRAIN_LAYERS) if LAUNCH_MODEL is None \
        else CausalLM(TransformerConfig(**LAUNCH_MODEL))
    gen = torch.Generator(device=CHECK_DEVICE).manual_seed(seed)
    params = model.init_params(gen, device=CHECK_DEVICE,
                               dtype=torch.bfloat16 if cuda else torch.float32)
    rng = np.random.default_rng(seed + 2)
    seq = TRAIN_SEQ if LAUNCH_MODEL is None else LAUNCH_MODEL["max_seq"]
    tokens = rng.integers(0, model.config.vocab_size, size=(TRAIN_CONFIG["train_batch_size"], seq))
    return model, params, {"input_ids": torch.from_numpy(tokens).to(CHECK_DEVICE)}


def _comms_summary(cl):
    """The comms logger's records as count and bytes per op."""
    return {name: {"count": sum(r[0] for r in sizes.values()),
                   "bytes": sum(size * r[0] for size, r in sizes.items())}
            for name, sizes in cl.comms_dict.items()}


def worker_zero(out, seed):
    """The zero phase's rank: each of ZERO_RUNS from the same seeded params
    on the launcher's process group, its losses, state fingerprint,
    launches, step times, device peak and (one more step with the comms
    logger on) collectives written to ``out/result.json``."""
    t_start = time.time()
    import torch

    import deepspeed_tpu_torch.comm as dist
    rec = {"t_start": t_start,
           "env": {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "CUDA_VISIBLE_DEVICES")}}
    cuda = CHECK_DEVICE == "cuda"
    if cuda:
        from deepspeed_tpu_torch.ops.kernels import build
        _, log = build.build()
        for name in build.SOURCES:
            build.load(name)
        rec["built"] = sorted(log)
    model, params, batch = _zero_setup(seed)
    runs = {}
    for tag, stage, lamb in ZERO_RUNS:
        _free()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        engine = _train_engine(model, params, _zero_config(stage, lamb), device=CHECK_DEVICE)
        _sync()
        init_s = time.perf_counter() - t
        _reset_train_counters()
        losses, step_s, per_step = _timed_steps(engine, batch, ZERO_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        fingerprint = _json_round(state_fingerprint(engine))
        cl = dist.comms_logger()
        cl.comms_dict = {}
        dist.configure(enabled=True, prof_all=True)
        engine.train_batch(batch)
        _sync()
        dist.configure(enabled=False)
        runs[tag] = {"stage": stage, "optimizer": "FusedLamb" if lamb else "FusedAdam",
                     "moq": engine.quantizer is not None, "losses": losses, "step_s": step_s, "per_step": per_step,
                     "fingerprint": fingerprint, "peak_gb": peak, "init_s": init_s,
                     "held_bytes": engine.zero_held_bytes(),
                     "describe": engine.zero_rules.describe(),
                     "partitioned": engine._zero is not None,
                     "group": list(engine._zero.group) if engine._zero is not None else None,
                     "units": len(engine._zero.units) if engine._zero is not None else None,
                     "comms_per_step": _comms_summary(cl),
                     "launch_rule": zero_launch_rule(engine, lamb) if cuda else {},
                     "reckoned_bytes_per_rank": zero_reckoned_bytes(engine, stage)}
        del engine
    import torch.distributed as tdist
    rec.update(runs=runs, backend=tdist.get_backend() if dist.has_process_group() else None,
               world=tdist.get_world_size() if dist.has_process_group() else None)
    with open(os.path.join(out, "result.json"), "w") as f:
        json.dump(rec, f)
    del params
    dist.destroy_process_group()
    return 0


def phase_zero(state, seed):
    """ZeRO stages 1-3 end to end on the card: ``cli run --num_gpus 1``
    spawns one NCCL rank (``--worker zero``) that runs ZERO_RUNS; every
    stage must give its optimizer's stage-0 losses and state bit for bit
    (limit 0), launch the train rule's kernels each step, and issue the
    collectives of its stage (the all-gather that refreshes the params,
    and the reduce-scatter of the gradients from stage 2)."""
    shutil.rmtree(ZERO_DIR, ignore_errors=True)
    os.makedirs(ZERO_DIR)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    _free()
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.cli", "run", "--num_gpus", "1",
         f"--master_port={_free_port()}",
         f"--enable_each_rank_log={os.path.join(ZERO_DIR, 'logs')}",
         *_worker_cmd("zero", ZERO_DIR, seed)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600)
    run_s = time.time() - t0
    if proc.returncode != 0:
        log = os.path.join(ZERO_DIR, "logs", "rank_0.log")
        tail = open(log).read()[-4000:] if os.path.exists(log) else ""
        raise RuntimeError(f"cli run exited {proc.returncode}: {proc.stderr[-2000:]}\n{tail}")
    with open(os.path.join(ZERO_DIR, "result.json")) as f:
        rank = json.load(f)
    failures = []
    want_backend = "nccl" if CHECK_DEVICE == "cuda" else "gloo"
    if rank["backend"] != want_backend or rank["world"] != 1:
        failures.append(f"the rank ran on {rank['backend']} at world {rank['world']}")
    if rank.get("built"):
        failures.append(f"the rank compiled {rank['built']} (the build cache missed)")
    runs = rank["runs"]
    launches = {}
    for tag, stage, lamb in ZERO_RUNS:
        r = runs[tag]
        ref = runs["lamb_stage0" if lamb else "adamw_stage0"]
        if stage > 0 and r["losses"] != ref["losses"]:
            failures.append(f"{tag} losses {r['losses']} != stage 0's {ref['losses']}")
        if stage > 0 and r["fingerprint"] != ref["fingerprint"]:
            diff = sorted(k for k in ref["fingerprint"]
                          if r["fingerprint"].get(k) != ref["fingerprint"][k])
            failures.append(f"{tag}: state differs from stage 0's in {diff[:8]}")
        if r["partitioned"] != (stage > 0) or r["moq"] != lamb:
            failures.append(f"{tag}: partitioned {r['partitioned']}, MoQ {r['moq']}")
        for k, n in r["launch_rule"].items():
            if any(s[k] != n for s in r["per_step"]):
                failures.append(f"{tag}: {k} launches per step {[s[k] for s in r['per_step']]} "
                                f"!= {n}")
        comms = r["comms_per_step"]
        if stage > 0 and not comms.get("all_gather", {}).get("count"):
            failures.append(f"{tag}: no all-gather refreshed the params ({comms})")
        if stage > 1 and not comms.get("reduce_scatter", {}).get("count"):
            failures.append(f"{tag}: no reduce-scatter of the gradients ({comms})")
        if stage > 0:
            for k in r["launch_rule"]:
                launches[k] = launches.get(k, 0) + sum(s[k] for s in r["per_step"])
    state["zero_launches"] = launches
    emit("zero", steps=ZERO_STEPS, runs={tag: {k: v for k, v in r.items() if k != "fingerprint"}
                                         for tag, r in runs.items()},
         fingerprints_equal={tag: runs[tag]["fingerprint"] == runs[
             "lamb_stage0" if lamb else "adamw_stage0"]["fingerprint"]
             for tag, _, lamb in ZERO_RUNS},
         reckoned_note="reckoned_bytes_per_rank: computed from the partition sizes, not "
                       "measured (one card); peak_gb is the measured world-1 peak",
         spawn_s=rank["t_start"] - t0, run_s=run_s, backend=rank["backend"],
         card=state.get("card"))
    check(not failures, "zero failed: " + "; ".join(failures))
    shutil.rmtree(ZERO_DIR, ignore_errors=True)


# kernel S at the denoiser's activation (batch 2, 64 x 64, 320 channels) and
# the VAE encoder's (1, 512 x 512, 128 channels)
SPATIAL_CASES = {"sd_unet_320": (2, 64, 64, 320), "sd_vae_128": (1, 512, 512, 128)}


def _check_spatial_bias_add(gen, results, failures):
    """Kernel S against its plain twin (the torch chain), each of the three
    forms at SPATIAL_CASES in bf16: bit-equal (limit 0: the same fp32 adds,
    rounded after each), two launches bit-equal, and planted faults above
    0 (the bias read from the neighbouring channel; the residual forms'
    adds rounded once instead of after each). Time, the plain version's,
    the bound (bytes over 3.35 TB/s) and, for the first form, the library
    call ``a + bias``; the first form at the denoiser's shape is the
    kernels line's row."""
    import torch
    from deepspeed_tpu_torch.ops.spatial import kernels as sk
    forms = {"bias_add": (sk.nhwc_bias_add, sk.nhwc_bias_add_plain),
             "bias_add_add": (sk.nhwc_bias_add_add, sk.nhwc_bias_add_add_plain),
             "bias_add_bias_add": (sk.nhwc_bias_add_bias_add, sk.nhwc_bias_add_bias_add_plain)}
    bits = lambda x: x.view(torch.int16)
    for case, shape in SPATIAL_CASES.items():
        C = shape[-1]
        dt = torch.bfloat16
        a = torch.randn(shape, generator=gen, device="cuda").to(dt)
        other = torch.randn(shape, generator=gen, device="cuda").to(dt)
        bias = (torch.randn((C,), generator=gen, device="cuda") * 0.5).to(dt)
        obias = (torch.randn((C,), generator=gen, device="cuda") * 0.5).to(dt)
        for mode, (form, (run_fn, plain_fn)) in enumerate(forms.items()):
            args = (a, bias) + ((other,) if mode >= 1 else ()) + ((obias,) if mode == 2 else ())
            run = lambda: run_fn(*args)
            plain = lambda: plain_fn(*args)
            got, want = run(), plain()
            wide = sum(x.float() if x.dim() > 1 else x.float().reshape(1, 1, 1, C)
                       for x in args)
            faults = {"neighbour_channel_bias": plain_fn(a, bias.roll(1), *args[2:])}
            if mode >= 1:
                faults["rounded_once"] = wide.to(dt)
            torch.cuda.synchronize()
            differ = lambda x: int((bits(x) != bits(want)).sum())
            rec = {"kernel": "spatial_bias_add", "case": case, "form": form,
                   "shape": list(shape), "elements_differing": differ(got), "limit": 0,
                   "fault_elements_differing": {f: differ(x) for f, x in faults.items()},
                   "max_abs_err": float((got.float() - want.float()).abs().max())}
            rec["repeat_bit_equal"] = bool(torch.equal(bits(got), bits(run())))
            if rec["elements_differing"] != 0 or not rec["repeat_bit_equal"]:
                failures.append(f"spatial_bias_add {case} {form}: {rec['elements_differing']} "
                                f"elements differ (repeat equal {rec['repeat_bit_equal']})")
            for f, n in rec["fault_elements_differing"].items():
                if not n > 0:
                    failures.append(f"spatial_bias_add {case} {form}: planted fault {f} reads 0")
            rec["ms"] = cuda_ms(run)
            rec["plain_ms"] = cuda_ms(plain)
            rec["library_ms"] = cuda_ms(lambda: a + bias) if mode == 0 else None
            n_in = 1 if mode == 0 else 2
            nbytes = 2 * a.numel() * (n_in + 1) + 2 * C * (2 if mode == 2 else 1)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, a.numel() * (1, 2, 3)[mode],
                                                     FP32_PEAK_TFLOPS)
            if case == "sd_unet_320" and mode == 0:
                results["spatial_bias_add"] = rec
            del got, want, wide, faults
            emit("kernel", **rec)


# A at the denoiser's self-attention: batch 2, 4096 tokens, 8 heads x 40
# (padded to 64 by the wrapper), non-causal, no mask
SD_FLASH = (SD_BATCH, 4096, 8, 8, 40, False, False, False)


def _check_sd_attention(gen, fa, results, failures):
    """A at SD_FLASH against its plain version (the ulp measure of phase
    kernel, the kv head shifted and the last key dropped planted), two
    launches bit-equal, timed against SDPA; the bound counts the 40 real
    columns of each head."""
    import torch
    import torch.nn.functional as F
    B, S, H, KV, Hd, causal, alibi, mask = SD_FLASH
    args = _flash_case(gen, B, S, H, KV, Hd, causal, alibi, mask)
    run = lambda: fa.flash_attention(*args)
    o, ro = run(), fa.flash_attention_plain(*args)[0]
    faults = _flash_faults(fa, *args)
    torch.cuda.synchronize()
    rec = {"kernel": "flash_attention_fwd", "case": "sd_unet_self_attention",
           "shape": [B, S, H, KV, Hd], "causal": causal,
           **_hold("flash_attention_fwd", "sd_unet_self_attention", [o], [ro],
                   {f: [r[0]] for f, r in faults.items()}, failures)}
    _repeat("flash_attention_fwd", "sd_unet_self_attention", run, o, rec, failures)
    q, k, v = args[:3]
    rec["ms"] = cuda_ms(run)
    rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(*args), reps=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * B * H * Hd * S * S)
    results["flash_attention_fwd_sd"] = rec
    del o, ro, faults
    emit("kernel", **rec)


def phase_kernels(state):
    res = state.get("kernel_results", {})
    serve = state.get("launches", {})
    spec = state.get("spec_launches", {})
    gen = state.get("gen_launches", {})
    train = state.get("train_launches", {})
    train_lamb = state.get("train_lamb_launches", {})
    train_sparse = state.get("train_sparse_launches", {})
    resume = state.get("resume_launches", {})
    ingest = state.get("ingest_launches", {})
    telemetry = state.get("telemetry_launches", {})
    client_opt = state.get("client_opt_launches", {})
    health = state.get("health_launches", {})
    serve_async = state.get("serve_async_launches", {})
    serve_tier = state.get("serve_tier_launches", {})
    serve_fleet = state.get("serve_fleet_launches", {})
    serve_gptj = state.get("serve_gptj_launches", {})
    serve_int8 = state.get("serve_int8_launches", {})
    train_gptj = state.get("train_gptj_launches", {})
    moe_generate = state.get("moe_generate_launches", {})
    moe_train = state.get("moe_train_launches", {})
    serve_stream = state.get("serve_stream_launches", {})
    serve_stream_nvme = state.get("serve_stream_nvme_launches", {})
    train_offload = state.get("train_offload_launches", {})
    bert_serve = state.get("bert_serve_launches", {})
    bert_train = state.get("bert_train_launches", {})
    clip_encode = state.get("clip_encode_launches", {})
    compress_train = state.get("compress_train_launches", {})
    moq_eigenvalue = state.get("moq_eigenvalue_launches", {})
    train_remat = state.get("train_remat_launches", {})
    train_data_efficiency = state.get("train_data_efficiency_launches", {})
    diffusers = state.get("diffusers_launches", {})
    autotune = state.get("autotune_launches", {})
    tooling = state.get("tooling_launches", {})
    launch = state.get("launch_launches", {})
    zero = state.get("zero_launches", {})
    rows = []
    meta = {
        "flash_attention_fwd": (
            "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:127 (_fwd_kernel; also "
            "_packed_fwd_kernel :272)"),
        "paged_decode_attention": (
            "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
            "deepspeed_tpu/ops/pallas/paged_decode_attention.py:46 (_kernel)"),
        "flash_attention_bwd_dq": (
            "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:182 (_dq_kernel; also "
            "_packed_dq_kernel :318)"),
        "flash_attention_bwd_dkv": (
            "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:218 (_dkv_kernel; also "
            "_packed_dkv_kernel :351)"),
        "fused_adam": (
            "deepspeed_tpu_torch/csrc/fused_adam.cu",
            "deepspeed_tpu/ops/adam/fused_adam_kernel.py:47 (_adam_kernel)"),
        "dense_decode_attention": (
            "deepspeed_tpu_torch/csrc/dense_decode_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:45 (_kernel)"),
        "fused_ce_fwd": (
            "deepspeed_tpu_torch/csrc/fused_cross_entropy.cu",
            "deepspeed_tpu/ops/pallas/fused_cross_entropy.py:66 (_fwd_kernel)"),
        "fused_ce_ds": (
            "deepspeed_tpu_torch/csrc/fused_cross_entropy.cu",
            "deepspeed_tpu/ops/pallas/fused_cross_entropy.py:120 (_dh_kernel) and :142 "
            "(_dw_kernel): their shared ds and db"),
        "fused_ce_dh_gemm": (
            "deepspeed_tpu_torch/csrc/fused_cross_entropy.cu",
            "deepspeed_tpu/ops/pallas/fused_cross_entropy.py:120 (_dh_kernel)"),
        "fused_ce_dw_gemm": (
            "deepspeed_tpu_torch/csrc/fused_cross_entropy.cu",
            "deepspeed_tpu/ops/pallas/fused_cross_entropy.py:142 (_dw_kernel)"),
        "fused_lamb_moments": (
            "deepspeed_tpu_torch/csrc/fused_lamb.cu",
            "deepspeed_tpu/ops/lamb/fused_lamb_kernel.py:38 (_lamb_kernel: moments, u, "
            "sum p^2 and sum u^2)"),
        "fused_lamb_ratio": (
            "deepspeed_tpu_torch/csrc/fused_lamb.cu",
            "deepspeed_tpu/ops/lamb/fused_lamb_kernel.py:38 (_lamb_kernel: the norms' "
            "reduction across its sequential grid)"),
        "fused_lamb_apply": (
            "deepspeed_tpu_torch/csrc/fused_lamb.cu",
            "deepspeed_tpu/ops/lamb/fused_lamb_kernel.py:38 (_lamb_kernel: u, applied as "
            "p - lr ratio u)"),
        "sr_quantize": (
            "deepspeed_tpu_torch/csrc/sr_quantize.cu",
            "deepspeed_tpu/ops/quantizer/kernels.py:80 (_sr_kernel)"),
        "sr_absmax": (
            "deepspeed_tpu_torch/csrc/sr_quantize.cu",
            "deepspeed_tpu/ops/quantizer/kernels.py:48 (_sym_scale: the group max |x| / qmax "
            "that XLA fuses before the pallas_call :102; not a pallas_call site)"),
        "flash_attention_fwd_hd256": (
            "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:127 (_fwd_kernel at head_dim 256)"),
        "paged_decode_attention_hd256": (
            "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
            "deepspeed_tpu/ops/pallas/paged_decode_attention.py:46 (_kernel at head_dim 256)"),
        "dense_decode_attention_hd256": (
            "deepspeed_tpu_torch/csrc/dense_decode_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:45 (_kernel at head_dim 256)"),
        "flash_attention_bwd_dq_hd256": (
            "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:182 (_dq_kernel at head_dim 256)"),
        "flash_attention_bwd_dkv_hd256": (
            "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:218 (_dkv_kernel at head_dim 256)"),
        "dequant_int8": (
            "deepspeed_tpu_torch/csrc/dequant_int8.cu",
            "deepspeed_tpu/ops/quant.py:35 (Quantized8.dequant, which XLA fuses into the "
            "matmul's operand read; not a pallas_call site)"),
        "spatial_bias_add": (
            "deepspeed_tpu_torch/csrc/spatial_bias_add.cu",
            "deepspeed_tpu/ops/spatial/kernels.py:17-30 (nhwc_bias_add, nhwc_bias_add_add, "
            "nhwc_bias_add_bias_add, which XLA fuses into one elementwise pass each; not a "
            "pallas_call site)"),
        "flash_attention_fwd_sd": (
            "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:127 (_fwd_kernel; Stable Diffusion "
            "v1.5's first UNet level: 4096 tokens, 8 heads x 40 padded to 64, non-causal)"),
    }
    for kern, (line, what) in {"flash_attention_fwd": (127, "_fwd_kernel"),
                               "flash_attention_bwd_dq": (182, "_dq_kernel"),
                               "flash_attention_bwd_dkv": (218, "_dkv_kernel")}.items():
        meta[kern + "_layout"] = (
            meta[kern][0], f"deepspeed_tpu/ops/pallas/flash_attention.py:{line} ({what} "
            "with has_layout: the block-sparse layout, _layout_spec :523)")
        meta[kern + "_bert"] = (
            meta[kern][0], f"deepspeed_tpu/ops/pallas/flash_attention.py:{line} ({what}; "
            "BERT-large: head_dim 64, non-causal, a padding mask_bias)")
        meta[kern + "_ltd"] = (
            meta[kern][0], f"deepspeed_tpu/ops/pallas/flash_attention.py:{line} ({what}; "
            "BERT-large under the seqlen curriculum and random-LTD: head_dim 64, "
            "non-causal, a padding mask_bias, S and kept counts not multiples of 64; "
            f"checked at S {ENCODER_FLASH['ltd'][1]})")
    for tower in ("clip_text", "clip_vision"):
        meta[f"flash_attention_fwd_{tower}"] = (
            meta["flash_attention_fwd"][0],
            "deepspeed_tpu/ops/pallas/flash_attention.py:127 (_fwd_kernel; CLIP ViT-L/14's "
            + ("text tower: head_dim 64, S 77, causal)" if tower == "clip_text"
               else "vision tower: head_dim 64, S 257, non-causal)"))
    for kern in ("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm", "fused_ce_dw_gemm"):
        meta[kern + "_bert"] = (meta[kern][0], meta[kern][1] + "; BERT-large's tied MLM head "
                                "with the decoder bias, V 30522")
    for name, (source, replaces) in meta.items():
        r = res.get(name, {})
        by_path = {p: n[name] for p, n in (("serve", serve), ("spec_serve", spec),
                                           ("generate", gen), ("train", train),
                                           ("train_lamb", train_lamb),
                                           ("train_sparse", train_sparse),
                                           ("resume", resume), ("ingest", ingest),
                                           ("telemetry", telemetry),
                                           ("client_opt", client_opt), ("health", health),
                                           ("serve_async", serve_async),
                                           ("serve_tier", serve_tier),
                                           ("serve_fleet", serve_fleet),
                                           ("serve_gptj", serve_gptj),
                                           ("serve_int8", serve_int8),
                                           ("train_gptj", train_gptj),
                                           ("moe_generate", moe_generate),
                                           ("moe_train", moe_train),
                                           ("serve_stream", serve_stream),
                                           ("serve_stream_nvme", serve_stream_nvme),
                                           ("train_offload", train_offload),
                                           ("bert_serve", bert_serve),
                                           ("bert_train", bert_train),
                                           ("clip_encode", clip_encode),
                                           ("compress_train", compress_train),
                                           ("moq_eigenvalue", moq_eigenvalue),
                                           ("train_remat", train_remat),
                                           ("train_data_efficiency", train_data_efficiency),
                                           ("diffusers", diffusers), ("autotune", autotune),
                                           ("tooling", tooling), ("launch", launch),
                                           ("zero", zero))
                   if name in n}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(by_path.values()) if by_path else None,
                     "launches_by_path": by_path, "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms")})
        lse = res.get(name + "_lse")
        if lse:             # C and D fed delta - log2(e) dlse: flash_lse's backward (:579)
            rows[-1]["with_lse_cotangent"] = {
                k: lse.get(k) for k in ("shape", "max_abs_err", "ulp_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by")}
    print(json.dumps({"kernels": rows}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--fused-ce", choices=("auto", "on", "off"), default="auto",
                    help="fused_cross_entropy of the train and train_profile phases "
                         "(off: the plain vocab head, to compare against)")
    # a rank that phase launch spawns through the launcher (or the elastic
    # agent's worker): its record goes to --worker-out, not to stdout
    ap.add_argument("--worker", choices=("launch", "elastic", "zero"), help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", help=argparse.SUPPRESS)
    ap.add_argument("--worker-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--worker-model", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    TRAIN_CONFIG["fused_cross_entropy"] = args.fused_ce
    if args.worker:
        global CHECK_DEVICE, LAUNCH_MODEL
        CHECK_DEVICE = args.worker_device
        LAUNCH_MODEL = json.loads(args.worker_model) if args.worker_model else None
        worker = {"launch": worker_launch, "elastic": worker_elastic,
                  "zero": worker_zero}[args.worker]
        return worker(args.worker_out, args.seed)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401  (fails outside a checkout)

    state = {}
    t0 = time.perf_counter()
    seconds = {}
    for p in PHASES:
        if p not in phases:
            continue
        fn = globals()[f"phase_{p}"]
        t = time.perf_counter()
        if p not in ("env", "build", "kernels"):
            fn(state, args.seed)
        else:
            fn(state)
        # what a phase left in reference cycles (an HTTP server's handler
        # class holds its serving loop) goes before the next one allocates
        _free()
        seconds[p] = time.perf_counter() - t
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=seconds)
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
