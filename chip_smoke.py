#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases env,build,kernel,...]

Phases, each printing one JSON line:

  env           torch / CUDA versions and the card (nvidia-smi name, power limit)
  build         nvcc build of every kernel of the serving path, from csrc/
  kernel        each kernel against its plain PyTorch version on the card, in
                bf16, at its path's shapes and at edge shapes, with planted
                faults that must read above each limit, two launches of A, C,
                D, F, G, dh and dW bit-equal, its time, the plain
                version's, the library call's (SDPA for attention, fused
                AdamW, F.linear + F.cross_entropy for the fused CE) and the
                bound
  slice_parity  Llama-7B width cut to 2 layers: the same seeded weights served
                on the card (kernels) and on the CPU (plain versions, fp32);
                the CPU's greedy tokens fed to both sides' paged prefill and
                decode steps, every position's logits within LOGIT_ULP_TOL,
                faults planted in kernel A through the model above it
  serve         full Llama-2-7B (32 layers, bf16, random seeded weights)
                through init_inference + generate_batch with the default
                serving config; the kernels' launch counters must match the
                scheduler's prefill and decode actions
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
                once per JAX leaf, the stochastic-rounding kernel once per
                port leaf of each quantized JAX leaf
  kernels       every ported kernel with its launches in the serve, generate,
                train and train_lamb phases
  profile       (only with --phases profile) the serve phase's prompts through
                fresh engines after a warm-up: warm tokens/s, device kernel
                time by class under torch.profiler, the device's idle share
  train_profile (only with --phases train_profile) one warm train step of the
                train phase's configuration under torch.profiler: device
                time by class and the device's idle share
  generate_profile (only with --phases generate_profile) the generate
                phase's call after a warm-up, timed and then under
                torch.profiler: device time by class and the idle share

The last line is {"ok": true, "device": {...}}. Any failure raises, so the
script exits non-zero and prints no result line; it also exits non-zero
without a CUDA device. It imports neither jax nor deepspeed_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

PHASES = ("env", "build", "kernel", "slice_parity", "serve", "generate_parity", "generate",
          "train_parity", "train", "train_lamb_parity", "train_lamb", "kernels", "profile",
          "train_profile", "generate_profile")
DEFAULT_PHASES = PHASES[:-3]      # the three profiles run only when asked for
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
         count=torch.cuda.device_count(), nvidia_smi=card)


_KERNEL_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "paged_decode_kernel", "dense_decode_kernel", "fused_adam_kernel",
                 "fused_ce_fwd_kernel", "fused_ce_combine_kernel", "fused_ce_ds_kernel",
                 "fused_ce_db_kernel", "ce_dh_gemm_kernel", "ce_dw_gemm_kernel",
                 "lamb_moments_kernel", "lamb_ratio_kernel", "lamb_apply_kernel",
                 "sr_quantize_kernel")


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
                hd = re.search(r"Li(64|128)E", name)
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


# the kernels on TMA + wgmma: ptxas must spill nothing in them
_WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                  "fused_ce_fwd_kernel", "fused_ce_ds_kernel", "ce_dh_gemm_kernel",
                  "ce_dw_gemm_kernel")


def wgmma_spills(rows):
    """The spill bytes of every TMA + wgmma kernel row that has any."""
    return {k: r["spill_bytes"] for k, r in rows.items()
            if k.split()[0] in _WGMMA_KERNELS and r["spill_bytes"]}


def phase_build(state):
    """nvcc of every kernel with ptxas's report. A, C, D, F, G, dh and dW
    take their rings as dynamic shared memory, which ptxas does not count:
    it is read from the libraries. ptxas reports the 384-thread launch
    bound's 168 registers; setmaxnreg moves the consumer warpgroups to 232
    (F, G, dh, dW, A) or 240 (C, D) at run time. Fails if ptxas spills in
    any of them."""
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
    spills = wgmma_spills(rows)
    check(not spills, f"ptxas spills in the TMA + wgmma kernels: {spills}")


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
    }
    for name, (B, S, H, KV, Hd, causal, alibi, mask) in flash_cases.items():
        args = _flash_case(gen, B, S, H, KV, Hd, causal, alibi, mask)
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
        emit("kernel", **rec)

    # B: (B, H, KV, Hd, bs, n_max, pos, bias, alibi); "slice" = a Llama-7B
    # fused decode step: 8 rows at ragged depths, 16-block tables
    paged_cases = {
        "slice": (8, 32, 32, 128, 128, 16, [543, 31, 127, 128, 300, 0, 511, 255], False, False),
        "gqa4_bias_alibi": (3, 32, 8, 128, 128, 4, [127, 128, 511], True, True),
        "gpt2_hd64_boundaries": (4, 12, 12, 64, 128, 8, [0, 255, 256, 1023], False, False),
        "g2_hd64_bs256_bias": (2, 8, 4, 64, 256, 3, [255, 700], True, False),
        "g8_alibi": (2, 16, 2, 128, 128, 2, [5, 200], False, True),
    }
    for name, (B, H, KV, Hd, bs, n_max, pos, bias, alibi) in paged_cases.items():
        q, kp, vp, bt, pos_t, pad, slopes = _paged_case(gen, B, H, KV, Hd, bs, n_max, pos,
                                                       bias, alibi)
        run = lambda: pda.paged_decode_attention(q, kp, vp, bt, pos_t, pad_bias=pad,
                                                 alibi_slopes=slopes)
        plain = lambda: pda.paged_decode_attention_plain(q, kp, vp, bt, pos_t, pad, slopes)
        o, ro = run(), plain()
        faults = _paged_faults(pda, q, kp, vp, bt, pos_t, pad, slopes)
        torch.cuda.synchronize()
        rec = {"kernel": "paged_decode_attention", "case": name,
               "shape": [B, H, KV, Hd, bs, n_max], "pos": pos, "bias": bias, "alibi": alibi,
               **_hold("paged_decode_attention", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures)}
        if name == "slice":
            rec["ms"] = cuda_ms(run)
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
    _check_dense_decode(gen, results, failures)
    _check_backward_kernels(gen, fa, results, failures)
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


def _check_dense_decode(gen, results, failures):
    """Kernel G5 (the dense decode kernel, TPU K5) against its plain version
    at the generate phase's shape (Llama-7B heads, 8 rows, a 1024-slot
    workspace at pos 575) and at edge shapes; timed at the generate shape
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
    }
    for name, (B, H, KV, Hd, Smax, pos, bias, alibi) in cases.items():
        q = torch.randn((B, H, Hd), generator=gen, device=dev).to(dt)
        ck = torch.randn((B, Smax, KV, Hd), generator=gen, device=dev).to(dt)
        cv = torch.randn((B, Smax, KV, Hd), generator=gen, device=dev).to(dt)
        pad = (torch.randn((B, Smax), generator=gen, device=dev) * 0.2) if bias else None
        slopes = (torch.rand((H,), generator=gen, device=dev) * 0.3 + 0.05) if alibi else None
        run = lambda: dda.decode_attention(q, ck, cv, pos, pad_bias=pad, alibi_slopes=slopes)
        plain = lambda: dda.decode_attention_plain(q, ck, cv, pos, pad, slopes)
        o, ro = run(), plain()
        faults = _dense_faults(dda, q, ck, cv, pos, pad, slopes)
        torch.cuda.synchronize()
        rec = {"kernel": "dense_decode_attention", "case": name,
               "shape": [B, H, KV, Hd, Smax], "pos": pos, "bias": bias, "alibi": alibi,
               **_hold("dense_decode_attention", name, [o], [ro],
                       {f: [r] for f, r in faults.items()}, failures)}
        if name == "slice":
            rec["ms"] = cuda_ms(run)
            rec["plain_ms"] = cuda_ms(plain, reps=20)
            G = H // KV
            qt = (q * Hd**-0.5).reshape(B, H, 1, Hd)
            kt = ck[:, :pos + 1].transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            vt = cv[:, :pos + 1].transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
            rec["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                               scale=1.0))
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


def _check_backward_kernels(gen, fa, results, failures):
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
    }
    for name, (B, S, H, KV, Hd, causal, alibi, mask, masked_row) in cases.items():
        args, kw = _bwd_case(gen, fa, B, S, H, KV, Hd, causal, alibi, mask, masked_row)
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
        out = fad.fused_adam_step(p, g, m, v, step=3, lr=lr, emit=emit_, out=dest, **kw)
        torch.cuda.synchronize()
        rel = lambda outs, refs: max(float((a.float() - b.float()).abs().max()
                                           / b.float().abs().max()) for a, b in zip(outs, refs))
        err = rel((out, m, v), ref)
        fault_err = {f: rel((out, m, v), r) for f, r in faults.items()}
        if not err <= ADAM_TOL:
            failures.append(f"fused_adam {name}: relative error {err} > {ADAM_TOL}")
        for f, e in fault_err.items():
            if not e > ADAM_TOL:
                failures.append(f"fused_adam {name}: planted fault {f} reads {e} <= {ADAM_TOL}")
        rec = {"kernel": "fused_adam", "case": name, "n": n, "p_dtype": str(p_dtype),
               "emit": emit_, "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                                 for a, b in zip((out, m, v), ref)),
               "rel_err": err, "rel_tol": ADAM_TOL, "fault_rel_err": fault_err}
        if name == "embedding_leaf":
            m.copy_(m0)
            v.copy_(v0)
            rec["ms"] = cuda_ms(lambda: fad.fused_adam_step(p, g, m, v, step=3, lr=lr,
                                                            emit=emit_, out=dest, **kw))
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
            r = fl.lamb_ratio(part)
            parts = {
                "fused_lamb_moments": (
                    mom, lambda: fl._moments_plain(p, g, m, v, bc1, bc2, kw["b1"], kw["b2"],
                                                   kw["eps"], kw["weight_decay"]),
                    bound(n * (4 * 4 + 2 * 4) + 16 * blocks, 20 * n, FP32_PEAK_TFLOPS)),
                "fused_lamb_ratio": (
                    lambda: fl.lamb_ratio(part),
                    lambda: fl.ratio_plain(*part.sum(0)),
                    bound(16 * blocks + 4, 2 * blocks, FP32_PEAK_TFLOPS)),
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


def _check_sr_quantize(gen, results, failures):
    """K8 against its plain twin fed the same Philox draws, bit for bit
    (the share of differing elements must be <= SR_MISMATCH_TOL, each
    planted fault's above it), at the train path's largest leaf (the
    embedding, 64 groups, 16 bits: the run's first bit width) and at the
    w_up leaves of 8 layers with 43 groups of 2^23 elements, which span
    layers (8 bits). Then its statistics on x = (k + 0.3) s: every output is
    floor(x/s) s or (floor(x/s) + 1) s, the mean over 64 seeds is within 4
    sigma of x, a seed repeats bit for bit, and adjacent blocks' rounding is
    uncorrelated (|r| within 4 / sqrt(N)). Timed at the embedding leaf, in
    place, the kernel alone (the scales are torch amax outside it)."""
    import torch
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    cases = {"embedding_leaf": (1, (32000, 4096), 64, 16),
             "w_up_8_layers_43_groups": (8, (4096, 11008), 43, 8)}
    for name, (L, shape, groups, bits) in cases.items():
        leaves = [torch.randn(shape, generator=gen, device="cuda").mul_(0.02)
                  .to(torch.bfloat16) for _ in range(L)]
        got = qk.ds_sr_quantize_span(leaves, groups, bits, seed=7)
        torch.cuda.synchronize()

        def share(ref):
            diff = sum(int((a != b).sum()) for a, b in zip(got, ref))
            return diff / sum(t.numel() for t in leaves)

        ref = _sr_plain(qk, leaves, groups, bits, 7)
        err = share(ref)
        max_abs = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
        del ref
        faults = {}
        for fault in ("arithmetic_shift", "round_to_nearest", "one_stream_per_block"):
            faults[fault] = share(_sr_plain(qk, leaves, groups, bits, 7, fault))
        if not err <= SR_MISMATCH_TOL:
            failures.append(f"sr_quantize {name}: {err} of the elements differ")
        for f, e in faults.items():
            if not e > SR_MISMATCH_TOL:
                failures.append(f"sr_quantize {name}: planted fault {f} reads {e}")
        rec = {"kernel": "sr_quantize", "case": name, "leaves": L, "shape": list(shape),
               "groups": groups, "bits": bits, "max_abs_err": max_abs, "mismatch_share": err,
               "mismatch_tol": SR_MISMATCH_TOL, "fault_mismatch_share": faults}
        if name == "embedding_leaf":
            x = leaves[0]
            scale, qmax, gs = qk._span_scales([x], groups, bits)
            n = x.numel()
            rec["ms"] = cuda_ms(lambda: qk._kernel(x, x, scale, gs, 0, qmax, 7))
            flat = x.reshape(groups, -1)
            rec["plain_ms"] = cuda_ms(lambda: qk.sr_quantize_plain(
                flat, scale[:, None], qmax, qk.philox_uniform(7, 0, n, "cuda").reshape(
                    groups, -1)), reps=3, warmup=1)
            rec["library_ms"] = None
            rec["library"] = ("none (torch.fake_quantize_* rounds to nearest; no PyTorch call "
                              "rounds stochastically)")
            # bf16 read and written once, the scales once; ~31 operations an
            # element (Philox4x32-10 shared by four, then the rounding)
            rec["bound_ms"], rec["bound_by"] = bound(4 * n + 4 * groups, 31 * n,
                                                     FP32_PEAK_TFLOPS)
            results["sr_quantize"] = rec
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


def _train_engine(model, params, config, device=None):
    import deepspeed_tpu_torch
    return deepspeed_tpu_torch.initialize(model=model, model_parameters=params, config=config,
                                          device=device)[0]


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
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import llama

    model = llama("7b", n_layer=PARITY_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = model.init_params(gen, device="cuda", dtype=torch.float32)
    cpu_init = init.map(lambda t: t.to("cpu"))
    B, S = 2, 256
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
    for fault in ("dq_delta_not_subtracted", "dkv_last_q_tile_skipped", "ce_ds_labels_shifted"):
        with _planted(fault):
            rel = grad_rel(_grads(gpu, batches[0]))
        fault_grads[fault] = {"worst": max(rel.values()), "head": rel["lm_head"],
                              "median": float(np.median(list(rel.values())))}
        read = fault_grads[fault]["head" if fault.startswith("ce_") else "worst"]
        if not read > PARITY_GRAD_TOL:
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
    emit("train_parity", layers=model.config.n_layer, d_model=model.config.d_model,
         batch=[B, S], steps=len(batches),
         grad_rel_diff_worst={worst_g: grads[worst_g]},
         grad_rel_diff_median=float(np.median(list(grads.values()))), grad_tol=PARITY_GRAD_TOL,
         fault_grad_rel_diff=fault_grads, losses=losses, loss_tol=PARITY_LOSS_TOL,
         update_rel_diff_worst={worst: updates[worst]},
         update_rel_diff_median=float(np.median(list(updates.values()))),
         update_tol=PARITY_UPDATE_TOL)
    check(not failures, "train_parity failed: " + "; ".join(failures))


def _train_setup(seed, config=None):
    """The train phase's engine (Llama-2-7B width, TRAIN_LAYERS layers,
    random bf16 weights drawn on the card; ``config`` default TRAIN_CONFIG)
    and its one token batch."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import llama

    model = llama("7b", n_layer=TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda", dtype=torch.bfloat16)
    engine = _train_engine(model, params, config or TRAIN_CONFIG)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 2)
    tokens = rng.integers(0, model.config.vocab_size,
                          size=(TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ))
    return model, engine, {"input_ids": torch.from_numpy(tokens).cuda()}


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
            "fused_lamb_apply": fl.apply_launches, "sr_quantize": qk.launches}


def _reset_train_counters():
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import fused_cross_entropy as fce
    from deepspeed_tpu_torch.ops.lamb import fused_lamb_kernel as fl
    from deepspeed_tpu_torch.ops.quantizer import kernels as qk
    fa.launches = fa.dq_launches = fa.dkv_launches = fad.launches = 0
    fce.fwd_launches = fce.ds_launches = fce.dh_launches = fce.dw_launches = 0
    fl.moments_launches = fl.ratio_launches = fl.apply_launches = qk.launches = 0


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
    gas = engine.gradient_accumulation_steps()
    leaves = len(list(engine.state.params.parameters()))
    want = {"flash_attention_fwd": 2 * cfg.n_layer * gas,     # forward + remat recompute
            "flash_attention_bwd_dq": cfg.n_layer * gas,
            "flash_attention_bwd_dkv": cfg.n_layer * gas,
            "fused_adam": leaves,
            # the vocab head lies outside remat: each CE kernel once a micro-step
            **dict.fromkeys(("fused_ce_fwd", "fused_ce_ds", "fused_ce_dh_gemm",
                             "fused_ce_dw_gemm"),
                            0 if TRAIN_CONFIG["fused_cross_entropy"] == "off" else gas)}
    check(leaves == 9 * cfg.n_layer + 3, f"{leaves} parameter leaves")
    acc.reset_peak_memory_stats()

    _reset_train_counters()
    losses, step_s, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = _train_counters()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        after = _train_counters()
        per_step.append({k: after[k] - before[k] for k in after})
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
    leaf, the ratio kernel once per JAX leaf, K8 once per port leaf of each
    JAX leaf of stacked rank >= 2, and the attention and CE kernels as in
    the train phase (no Adam)."""
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
            "fused_lamb_ratio": len(groups), "sr_quantize": quantized}
    check((len(named), len(groups), quantized) == (9 * cfg.n_layer + 3, 12,
                                                   9 * cfg.n_layer + 2),
          f"{len(named)} port leaves, {len(groups)} JAX leaves, {quantized} quantized")
    acc.reset_peak_memory_stats()

    _reset_train_counters()
    losses, step_s, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = _train_counters()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        after = _train_counters()
        per_step.append({k: after[k] - before[k] for k in after})
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


def phase_train_profile(state, seed):
    """Where one warm train step's time goes (not in the default run): a
    warm-up step, a step timed with the host clock, and a step under
    torch.profiler, whose device events give kernel time by class and the
    device's idle share against the timed step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _, engine, batch = _train_setup(seed)
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
    emit("train_profile", card=state.get("card"), timed_step_ms=wall_ms,
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
                        ("dense_decode_kernel", "dense_decode_attention"),
                        ("fused_ce_fwd_kernel", "fused_ce_fwd"),
                        ("fused_ce_combine_kernel", "fused_ce_fwd"),
                        ("fused_ce_ds_kernel", "fused_ce_ds"),
                        ("fused_ce_db_kernel", "fused_ce_ds"),
                        ("ce_dh_gemm_kernel", "fused_ce_dh_gemm"),
                        ("ce_dw_gemm_kernel", "fused_ce_dw_gemm"),
                        ("lamb_moments_kernel", "fused_lamb_moments"),
                        ("lamb_ratio_kernel", "fused_lamb_ratio"),
                        ("lamb_apply_kernel", "fused_lamb_apply"),
                        ("sr_quantize_kernel", "sr_quantize")):
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


def phase_kernels(state):
    res = state.get("kernel_results", {})
    serve = state.get("launches", {})
    gen = state.get("gen_launches", {})
    train = state.get("train_launches", {})
    train_lamb = state.get("train_lamb_launches", {})
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
    }
    for name, (source, replaces) in meta.items():
        r = res.get(name, {})
        by_path = {p: n[name] for p, n in (("serve", serve), ("generate", gen), ("train", train),
                                           ("train_lamb", train_lamb)) if name in n}
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(by_path.values()) if by_path else None,
                     "launches_by_path": by_path, "max_abs_err": r.get("max_abs_err"),
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms")})
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
