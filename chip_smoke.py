#!/usr/bin/env python3
"""Smoke run of deepspeed_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases env,build,kernel,...]

Phases, each printing one JSON line:

  env           torch / CUDA versions and the card (nvidia-smi name, power limit)
  build         nvcc build of every kernel of the serving path, from csrc/
  kernel        each kernel against its plain PyTorch version on the card, in
                bf16, at the serving path's shapes and at edge shapes, with
                its time, the plain version's, the library call's (SDPA for
                flash attention) and the bound
  slice_parity  Llama-7B width cut to 2 layers: the same seeded weights served
                on the card (kernels) and on the CPU (plain versions, fp32);
                greedy tokens must agree wherever the CPU's top-2 logit
                margin exceeds the bf16 tolerance
  serve         full Llama-2-7B (32 layers, bf16, random seeded weights)
                through init_inference + generate_batch with the default
                serving config; the kernels' launch counters must match the
                scheduler's prefill and decode actions
  train_parity  Llama-7B width cut to 2 layers: the same seeded weights and
                batches trained 3 steps through initialize + train_batch on
                the card (bf16, kernels) and on the CPU (fp32, plain
                versions); per-step losses and each leaf's update must agree
  train         Llama-7B width cut to 8 layers (bf16, random seeded weights)
                through initialize + train_batch with the slice's training
                config (FusedAdam, WarmupLR, clipping, gas 2) on one
                [8, 2048] token batch: 1 warm-up + 5 timed steps, every loss
                finite and falling, the kernels' launch counters per step
                equal to 2 L gas (A), L gas (C, D) and one per leaf (E)
  kernels       every ported kernel with its launches in the serve and train
                phases
  profile       (only with --phases profile) the serve phase's prompts through
                fresh engines after a warm-up: warm tokens/s, device kernel
                time by class under torch.profiler, the device's idle share
  train_profile (only with --phases train_profile) one warm train step of the
                train phase's configuration under torch.profiler: device
                time by class and the device's idle share

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

PHASES = ("env", "build", "kernel", "slice_parity", "serve", "train_parity", "train", "kernels",
          "profile", "train_profile")
DEFAULT_PHASES = PHASES[:-2]      # "profile" and "train_profile" run only when asked for
# Kernel vs plain version, bf16 outputs: the largest difference in each output
# row (over head_dim), in bf16 ulps of that row's largest |plain| value, so
# one limit holds at every output scale (a row over 500 keys is ~20x smaller
# than a row over one key). The limit sits 2 ulps above the worst sound
# reading on an H100, 1.02 for either kernel (PERF.md §6); planted faults
# must read above it, or the check could not tell them from a sound kernel.
ULP_TOL = 3.0
LSE_TOL = 1e-4                  # log2-domain lse: sound reads <= 4e-6, a dropped key >= 0.016
MARGIN_TOL = 0.1                # logit units: bf16 serving vs fp32 CPU reference
# Backward kernels C and D: the same ulp measure, with each row's magnitude
# floored at 2^-10 of the gradient's largest value: a dq row of a query that
# sees one key (or a dk row of a key that one query sees) is dp - delta's
# rounding residue, ~1e-6 of the row scale, and differs between any two
# correct summation orders.
GRAD_FLOOR = 2.0**-10
ADAM_TOL = 1e-6                 # kernel E: u, m, v error relative to the largest plain value
FP32_PEAK_TFLOPS = 67.0         # H100 SXM fp32 outside the tensor cores (data sheet)
TRAIN_CONFIG = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "FusedAdam",
                              "params": {"lr": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8,
                                         "weight_decay": 0.1}},
                "scheduler": {"type": "WarmupLR",
                              "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4,
                                         "warmup_num_steps": 2}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "fused_cross_entropy": "off"}
TRAIN_LAYERS = 8                # Llama-2-7B width, depth cut 32 -> 8 (PERF.md section 4)
TRAIN_SEQ = 2048
TRAIN_STEPS = 6                 # 1 warm-up + 5 timed
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


def ulp_err(out, ref, floor=0.0):
    """Largest |out - ref| of each row (the last axis) in bf16 ulps of the
    row's largest |ref|; the ulp of x in [2^e, 2^(e+1)) is 2^(e-7). With
    ``floor`` > 0 a row's magnitude is at least ``floor`` times the
    tensor's largest |ref|; without, a row that should be all zeros reads
    inf unless ``out`` is zero there too."""
    import torch
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs().amax(-1)
    mag = ref.abs().amax(-1).clamp(min=floor * float(ref.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / ulp).max())


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
                 "paged_decode_kernel", "fused_adam_kernel")


def ptxas_summary(log):
    """Registers and spill bytes of every kernel instantiation from nvcc's
    ``-Xptxas=-v`` output, folded to one line per (kernel, dtype, head dim):
    the most registers and spill bytes over its other template arguments."""
    import re
    rows = {}
    for text in log.values():
        key = None
        for ln in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
            if m:
                name = m.group(1)
                kern = next((k for k in _KERNEL_NAMES if k in name), name[:40])
                dt = "bf16" if "bfloat16" in name else "fp16" if "__half" in name else ""
                hd = re.search(r"Li(64|128)E", name)
                key = f"{kern} {dt} hd{hd.group(1)}" if hd else f"{kern} {dt}".strip()
                rows.setdefault(key, {"registers": 0, "spill_bytes": 0})
            if key is None:
                continue
            r = re.search(r"Used (\d+) registers", ln)
            if r:
                rows[key]["registers"] = max(rows[key]["registers"], int(r.group(1)))
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if sp:
                rows[key]["spill_bytes"] = max(rows[key]["spill_bytes"],
                                               int(sp.group(1)) + int(sp.group(2)))
    return rows


def phase_build(state):
    from deepspeed_tpu_torch.ops.kernels import build
    seconds, log = build.build(ptxas_verbose=True)
    emit("build", seconds=seconds, built=sorted(log), ptxas=ptxas_summary(log))


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
    _check_backward_kernels(gen, fa, results, failures)
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    _check_fused_adam(gen, fad, results, failures)
    check(not failures, "kernel checks failed: " + "; ".join(failures))


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
    sums), delta not subtracted. D also: the last q tile skipped and, for
    G > 1, dk / dv taken from the first query head of each group only."""
    import torch
    q, k, v, do, lse, delta = args
    B, S, H, _ = q.shape
    KV = k.shape[2]
    drop = torch.zeros((B, S), device=q.device)
    drop[:, (S - 1) // 64 * 64:] = -1e9
    if kw["mask_bias"] is not None:
        drop = drop + kw["mask_bias"]
    no_tile = {**kw, "mask_bias": drop}
    zero_delta = (q, k, v, do, lse, torch.zeros_like(delta))
    dq = {"last_key_tile_skipped": fa.flash_attention_dq_plain(*args, **no_tile),
          "delta_not_subtracted": fa.flash_attention_dq_plain(*zero_delta, **kw)}
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
    shape and at edge shapes; timed at the Hd 128 and Hd 64 call sites."""
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
        torch.cuda.synchronize()
        shape = {"shape": [B, S, H, KV, Hd], "causal": causal, "alibi": alibi, "mask": mask,
                 "fully_masked_row": masked_row}
        rec_c = {"kernel": "flash_attention_bwd_dq", "case": name, **shape,
                 **_hold("flash_attention_bwd_dq", name, [dq], [rdq],
                         {f: [r] for f, r in fdq.items()}, failures, GRAD_FLOOR)}
        rec_d = {"kernel": "flash_attention_bwd_dkv", "case": name, **shape,
                 **_hold("flash_attention_bwd_dkv", name, [dk, dv], [rdk, rdv],
                         {f: list(r) for f, r in fdkv.items()}, failures, GRAD_FLOOR)}
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


def _last_logits(engine, tokens):
    """Logits at the last position of ``tokens`` through the engine's own
    paged prefill on a scratch pool (the margin probe of slice_parity)."""
    import torch
    from deepspeed_tpu_torch.models import transformer as T
    n = len(tokens)
    Tb = -(-n // 128) * 128
    pools = engine.module.init_paged_cache(Tb // 128 + 1, 128, dtype=engine.dtype,
                                           device=engine.device)
    toks = torch.zeros((1, Tb), dtype=torch.long, device=engine.device)
    toks[0, :n] = torch.as_tensor(tokens, dtype=torch.long)
    slots = torch.arange(Tb, device=engine.device) + 128     # blocks 1.., in order
    logits, _ = T.forward_paged_prefill(engine.module.config, engine.params, toks,
                                        pools, slots, n - 1)
    return logits[0].float()


def phase_slice_parity(state, seed):
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    model = llama("7b", n_layer=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda", dtype=torch.bfloat16)
    gpu = deepspeed_tpu_torch.init_inference(model, params=params, dtype="bf16",
                                             device="cuda")
    cpu = deepspeed_tpu_torch.init_inference(
        model, params=params.map(lambda t: t.to("cpu", torch.float32)), dtype="fp32",
        device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.config.vocab_size, size=n) for n in (40, 130, 200)]
    max_new = 8
    got = gpu.generate_batch(prompts, max_new_tokens=max_new)
    want = cpu.generate_batch(prompts, max_new_tokens=max_new)
    compared = diverged = 0
    for p, g, w in zip(prompts, got, want):
        g, w = np.asarray(g), np.asarray(w)
        check(g.shape == w.shape, f"length mismatch {g.shape} vs {w.shape}")
        mism = np.nonzero(g != w)[0]
        n_ok = (mism[0] if mism.size else g.size) - p.size
        compared += n_ok
        if mism.size:
            top2 = torch.topk(_last_logits(cpu, w[:mism[0]]), 2).values
            margin = float(top2[0] - top2[1])
            check(margin < MARGIN_TOL,
                  f"greedy tokens diverge at {mism[0]} where the CPU margin {margin} "
                  f">= {MARGIN_TOL}")
            diverged += 1
    del gpu, cpu, params
    torch.cuda.empty_cache()
    emit("slice_parity", layers=model.config.n_layer, d_model=model.config.d_model,
         prompts=len(prompts), tokens_compared=int(compared),
         near_tie_divergences=diverged, margin_tol=MARGIN_TOL)


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
def _planted(fa, fault):
    """Kernel C or D fed a faulted input wherever the model's backward calls
    it, inside the ``with`` body: delta not subtracted in dq
    ("dq_delta_not_subtracted"), or the last q tile's rows left out of dk
    and dv ("dkv_last_q_tile_skipped": lse = 1e30 there, so p = 0)."""
    import torch
    name = "flash_attention_dq" if fault.startswith("dq_") else "flash_attention_dkv"
    real = getattr(fa, name)

    def faulted(q, k, v, do, lse, delta, *args):
        if fault == "dq_delta_not_subtracted":
            delta = torch.zeros_like(delta)
        else:
            lse = lse.clone()
            lse[:, :, (q.shape[1] - 1) // 64 * 64:] = 1e30
        return real(q, k, v, do, lse, delta, *args)

    setattr(fa, name, faulted)
    try:
        yield
    finally:
        setattr(fa, name, real)


def phase_train_parity(state, seed):
    """Llama-7B width at 2 layers: the same fp32 weights and batches on the
    card (bf16 params, fp32 masters, kernels) and on the CPU (fp32, plain
    versions). First the gradients of the first batch at the initial
    weights: each leaf's within PARITY_GRAD_TOL of the CPU's (relative
    norm), and the same read with a fault planted in kernel C or D above
    it. Then 3 train_batch steps: per-step losses agree within
    PARITY_LOSS_TOL; each leaf's update (final - initial) on the card is
    within PARITY_UPDATE_TOL of the CPU's, relative to the CPU update's
    norm."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    model = llama("7b", n_layer=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = model.init_params(gen, device="cuda", dtype=torch.float32)
    cpu_init = init.map(lambda t: t.to("cpu"))
    B, S = 2, 256
    config = {**TRAIN_CONFIG, "train_batch_size": B, "train_micro_batch_size_per_gpu": 1}
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
    for fault in ("dq_delta_not_subtracted", "dkv_last_q_tile_skipped"):
        with _planted(fa, fault):
            rel = grad_rel(_grads(gpu, batches[0]))
        fault_grads[fault] = {"worst": max(rel.values()),
                              "median": float(np.median(list(rel.values())))}
        if not fault_grads[fault]["worst"] > PARITY_GRAD_TOL:
            failures.append(f"planted fault {fault} reads {fault_grads[fault]} <= {PARITY_GRAD_TOL}")
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


def _train_setup(seed):
    """The train phase's engine (Llama-2-7B width, TRAIN_LAYERS layers,
    random bf16 weights drawn on the card) and its one token batch."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models import llama

    model = llama("7b", n_layer=TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_params(gen, device="cuda", dtype=torch.bfloat16)
    engine = _train_engine(model, params, TRAIN_CONFIG)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 2)
    tokens = rng.integers(0, model.config.vocab_size,
                          size=(TRAIN_CONFIG["train_batch_size"], TRAIN_SEQ))
    return model, engine, {"input_ids": torch.from_numpy(tokens).cuda()}


def _train_counters():
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    return {"flash_attention_fwd": fa.launches, "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches, "fused_adam": fad.launches}


def phase_train(state, seed):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.ops.adam import fused_adam_kernel as fad
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

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
            "fused_adam": leaves}
    check(leaves == 9 * cfg.n_layer + 3, f"{leaves} parameter leaves")
    acc.reset_peak_memory_stats()

    fa.launches = fa.dq_launches = fa.dkv_launches = fad.launches = 0
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
                        ("paged_decode_kernel", "paged_decode_attention")):
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
    train = state.get("train_launches", {})
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
    }
    for name, (source, replaces) in meta.items():
        r = res.get(name, {})
        by_path = {p: n[name] for p, n in (("serve", serve), ("train", train)) if name in n}
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
    args = ap.parse_args(argv)
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
    for p in PHASES:
        if p not in phases:
            continue
        fn = globals()[f"phase_{p}"]
        if p not in ("env", "build", "kernels"):
            fn(state, args.seed)
        else:
            fn(state)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
