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
                cotangent left out planted as the fault
  slice_parity  Llama-7B width cut to 2 layers: the same seeded weights served
                on the card (kernels) and on the CPU (plain versions, fp32);
                the CPU's greedy tokens fed to both sides' paged prefill and
                decode steps, every position's logits within LOGIT_ULP_TOL,
                faults planted in kernel A through the model above it
  serve         full Llama-2-7B (32 layers, bf16, random seeded weights)
                through init_inference + generate_batch with the default
                serving config; the kernels' launch counters must match the
                scheduler's prefill and decode actions
  serve_async   full Llama-2-7B on the default serving config through the
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
  spec_parity   Llama-7B width cut to 2 layers: the CPU's greedy tokens fed
                in windows of 1-8 tokens through forward_paged_verify on the
                card (bf16, kernel B once per window position) and on the CPU
                (fp32, plain versions), every live window position's logits
                within LOGIT_ULP_TOL, and within it of the card's own
                teacher-forced decode steps; kernel B handed pos instead of
                pos + t planted through the model above it
  spec_serve    full Llama-2-7B with serving.speculative ngram, k 4, on 8
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
  resume        Llama-7B width cut to 2 layers (S 2048, micro 2 x gas 2, the
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
  kernels       every ported kernel with its launches in the serve, spec_serve
                (its oracle run), generate, train, train_lamb, train_sparse,
                resume, ingest, telemetry, client_opt, health and serve_async
                phases (A, C and D with a layout in rows of
                their own; C's and D's rows also carry their readings with an lse
                cotangent)
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

PHASES = ("env", "build", "kernel", "slice_parity", "serve", "serve_async", "spec_parity",
          "spec_serve",
          "generate_parity", "generate",
          "train_parity", "train", "train_lamb_parity", "train_lamb", "sparse_parity",
          "train_sparse", "resume", "ingest", "telemetry", "client_opt", "health", "kernels",
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
RESUME_LAYERS = 2               # resume: Llama-2-7B width, depth cut 32 -> 2 (PERF.md section 4)
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
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         checkout_disk_free_gb=shutil.disk_usage(os.path.dirname(RESUME_DIR)).free / 1e9)


_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "paged_decode_kernel", "paged_decode_combine_kernel", "dense_decode_kernel",
                 "dense_decode_combine_kernel", "fused_adam_kernel",
                 "fused_ce_fwd_kernel", "fused_ce_combine_kernel", "fused_ce_ds_kernel",
                 "fused_ce_db_kernel", "ce_dh_gemm_kernel", "ce_dw_gemm_kernel",
                 "lamb_moments_kernel", "lamb_ratio_kernel", "lamb_apply_kernel",
                 "sr_quantize_kernel", "sr_absmax_kernel", "sr_scale_kernel")


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
                hd = re.search(r"Li(64|96|128)E", name)
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
                     "fused_ce_fwd_kernel", "fused_ce_ds_kernel", "ce_dh_gemm_kernel",
                     "ce_dw_gemm_kernel", "paged_decode_kernel", "paged_decode_combine_kernel",
                     "dense_decode_kernel", "dense_decode_combine_kernel", "sr_quantize_kernel",
                     "sr_absmax_kernel", "sr_scale_kernel")


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
    attn_smem = {f"{k} hd{hd}": fn(hd) for hd in (64, 128)
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
    check(not failures, "kernel checks failed: " + "; ".join(failures))


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
        if name in ("slice", "gpt2_tied_bias"):   # no split-K, no atomics: same bits
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
        if name == "slice":
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
            results.update({"fused_ce_fwd": rec_f, "fused_ce_ds": rec_g,
                            "fused_ce_dh_gemm": rec_dh, "fused_ce_dw_gemm": rec_dw})
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
        if name == "train_sparse":
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
        if name == "dense":
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
            results["flash_attention_bwd_dq_lse"] = rec_c
            results["flash_attention_bwd_dkv_lse"] = rec_d
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
    cache = engine.module.init_cache(B, max(bucket, n), dtype=engine.dtype, device=dev)
    prompt = torch.zeros((B, bucket), dtype=torch.long, device=dev)
    prompt[:, :n_prompt] = ids[:, :n_prompt]
    with torch.no_grad():
        logits, cache = engine.module.forward_cached(engine.params, prompt, cache, 0)
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


def _serve_prompts(cfg, seed):
    """12 prompts of 32-512 tokens; two share a 256-token prefix."""
    import numpy as np
    rng = np.random.default_rng(seed + 1)
    shared = rng.integers(0, cfg.vocab_size, size=256)
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
    """Full Llama-2-7B with n-gram speculation (k 4) on the default serving
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
    model, params = _llama7b(seed)
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
    the engine's forward and autograd; nothing is applied."""
    import torch
    named = list(engine.state.params.named_parameters())
    gas = engine.gradient_accumulation_steps()
    micro = len(batch["input_ids"]) // gas
    total = {}
    for i in range(gas):
        loss = engine({k: x[i * micro:(i + 1) * micro] for k, x in batch.items()})
        grads = torch.autograd.grad(loss.float(), [p for _, p in named])
        for (n, _), g in zip(named, grads):
            g = g.float().cpu()
            total[n] = g if n not in total else total[n].add_(g)
    return total


@contextlib.contextmanager
def _planted(fault):
    """Kernel C, D or G fed a faulted input wherever the model's backward
    calls it, inside the ``with`` body: delta not subtracted in dq
    ("dq_delta_not_subtracted"), the last q tile's rows left out of dk and
    dv ("dkv_last_q_tile_skipped": lse = 1e30 there, so p = 0), or G's
    onehot at the next vocab column ("ce_ds_labels_shifted")."""
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
            if fault == "dq_delta_not_subtracted":
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
    windows, so the layout drops pairs): A, C and D walk the layout on the
    card, their plain layout-aware versions run on the CPU. The planted
    fault: the layout ignored on the card (dense causal attention), which
    must read above the gradient limit."""
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


def _train_parity(phase, seed, model, B, S, faults):
    """The card (bf16, kernels) against the CPU (fp32, plain versions) for
    ``model`` on [B, S] batches, as :func:`phase_train_parity` says;
    ``faults``: name -> (context manager planting it, the leaf read: "worst"
    or "head")."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = model.init_params(gen, device="cuda", dtype=torch.float32)
    cpu_init = init.map(lambda t: t.to("cpu"))
    config = {**TRAIN_CONFIG, "train_batch_size": B, "train_micro_batch_size_per_gpu": 1,
              "fused_cross_entropy": "on"}
    cpu_config = {k: v for k, v in config.items() if k != "bf16"}
    gpu = _train_engine(model, init, config)
    del init
    cpu = _train_engine(model, cpu_init, cpu_config, device="cpu")
    rng = np.random.default_rng(seed + 3)
    batches = [{"input_ids": rng.integers(0, model.config.vocab_size, size=(B, S))}
               for _ in range(3)]
    failures = []

    want_g = _grads(cpu, batches[0])
    grad_rel = lambda got: {n: float((got[n] - w).norm() / w.norm().clamp(min=1e-30))
                            for n, w in want_g.items()}
    grads = grad_rel(_grads(gpu, batches[0]))
    worst_g = max(grads, key=grads.get)
    if not grads[worst_g] <= PARITY_GRAD_TOL:
        failures.append(f"leaf {worst_g} gradient differs by {grads[worst_g]} of the CPU's")
    fault_grads = {}
    for fault, (planted, leaf) in faults.items():
        with planted():
            rel = grad_rel(_grads(gpu, batches[0]))
        fault_grads[fault] = {"worst": max(rel.values()), "head": rel["lm_head"],
                              "median": float(np.median(list(rel.values())))}
        if not fault_grads[fault][leaf] > PARITY_GRAD_TOL:
            failures.append(f"planted fault {fault} reads {fault_grads[fault]} "
                            f"<= {PARITY_GRAD_TOL}")
    del want_g

    losses = []
    for batch in batches:
        got, want = float(gpu.train_batch(batch)), float(cpu.train_batch(batch))
        losses.append({"card_bf16": got, "cpu_fp32": want, "diff": got - want})
        if not (np.isfinite(got) and abs(got - want) <= PARITY_LOSS_TOL):
            failures.append(f"loss {got} on the card vs {want} on the CPU")
    updates = {}
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
    torch.cuda.empty_cache()
    emit(phase, layers=model.config.n_layer, d_model=model.config.d_model,
         batch=[B, S], steps=len(batches),
         grad_rel_diff_worst={worst_g: grads[worst_g]},
         grad_rel_diff_median=float(np.median(list(grads.values()))), grad_tol=PARITY_GRAD_TOL,
         fault_grad_rel_diff=fault_grads, losses=losses, loss_tol=PARITY_LOSS_TOL,
         update_rel_diff_worst={worst: updates[worst]},
         update_rel_diff_median=float(np.median(list(updates.values()))),
         update_tol=PARITY_UPDATE_TOL)
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
        torch.cuda.synchronize()
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


def train_launch_rule(engine):
    """The kernels' launches in one train_batch of the train phase's path:
    A twice a layer a micro-step (forward and remat recompute), C and D once,
    E once a parameter leaf, each fused CE kernel once a micro-step (the
    head lies outside remat; 0 with the plain head)."""
    cfg = engine.module.config
    gas = engine.gradient_accumulation_steps()
    leaves = len(list(engine.state.params.parameters()))
    check(leaves == 9 * cfg.n_layer + 3, f"{leaves} parameter leaves")
    return {"flash_attention_fwd": 2 * cfg.n_layer * gas,
            "flash_attention_bwd_dq": cfg.n_layer * gas,
            "flash_attention_bwd_dkv": cfg.n_layer * gas,
            "fused_adam": leaves,
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"),
                            0 if engine._config.fused_cross_entropy == "off" else gas)}


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
                        ("sr_scale_kernel", "sr_absmax")):
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
    """Full Llama-2-7B on the serve cell's default serving config through the
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
    model, params = _llama7b(seed)
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
    }
    for kern, (line, what) in {"flash_attention_fwd": (127, "_fwd_kernel"),
                               "flash_attention_bwd_dq": (182, "_dq_kernel"),
                               "flash_attention_bwd_dkv": (218, "_dkv_kernel")}.items():
        meta[kern + "_layout"] = (
            meta[kern][0], f"deepspeed_tpu/ops/pallas/flash_attention.py:{line} ({what} "
            "with has_layout: the block-sparse layout, _layout_spec :523)")
    for name, (source, replaces) in meta.items():
        r = res.get(name, {})
        by_path = {p: n[name] for p, n in (("serve", serve), ("spec_serve", spec),
                                           ("generate", gen), ("train", train),
                                           ("train_lamb", train_lamb),
                                           ("train_sparse", train_sparse),
                                           ("resume", resume), ("ingest", ingest),
                                           ("telemetry", telemetry),
                                           ("client_opt", client_opt), ("health", health),
                                           ("serve_async", serve_async))
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
    args = ap.parse_args(argv)
    TRAIN_CONFIG["fused_cross_entropy"] = args.fused_ce
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
        seconds[p] = time.perf_counter() - t
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=seconds)
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
