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
  kernels       every ported kernel with its launches in the serve phase
  profile       (only with --phases profile) the serve phase's prompts through
                fresh engines after a warm-up: warm tokens/s, device kernel
                time by class under torch.profiler, the device's idle share

The last line is {"ok": true, "device": {...}}. Any failure raises, so the
script exits non-zero and prints no result line; it also exits non-zero
without a CUDA device. It imports neither jax nor deepspeed_tpu.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

PHASES = ("env", "build", "kernel", "slice_parity", "serve", "kernels", "profile")
DEFAULT_PHASES = PHASES[:-1]      # "profile" runs only when asked for
# Kernel vs plain version, bf16 outputs: the largest difference in each output
# row (over head_dim), in bf16 ulps of that row's largest |plain| value, so
# one limit holds at every output scale (a row over 500 keys is ~20x smaller
# than a row over one key). The limit sits 2 ulps above the worst sound
# reading on an H100, 1.02 for either kernel (PERF.md §6); planted faults
# must read above it, or the check could not tell them from a sound kernel.
ULP_TOL = 3.0
LSE_TOL = 1e-4                  # log2-domain lse: sound reads <= 4e-6, a dropped key >= 0.016
MARGIN_TOL = 0.1                # logit units: bf16 serving vs fp32 CPU reference


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def ulp_err(out, ref):
    """Largest |out - ref| of each row (the last axis) in bf16 ulps of the
    row's largest |ref|; the ulp of x in [2^e, 2^(e+1)) is 2^(e-7). A row
    that should be all zeros reads inf unless ``out`` is zero there too."""
    import torch
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs().amax(-1)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().amax(-1))) - 7)
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


def bound(nbytes, flops):
    """Least time the card could take (ms) and what bounds it: the bytes over
    the card's memory rate, the bf16 FLOPs over its dense tensor-core peak
    (the accelerator's table of published rates)."""
    from deepspeed_tpu_torch.accelerator import get_accelerator
    acc = get_accelerator("cuda")
    check(acc.memory_bandwidth() > 0 and acc.peak_tflops() > 0,
          "no published peak rates for this card in the accelerator table")
    t_bytes = nbytes / acc.memory_bandwidth() * 1e3
    t_ops = flops / (acc.peak_tflops() * 1e12) * 1e3
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


def phase_build(state):
    from deepspeed_tpu_torch.ops.kernels import build
    seconds, log = build.build(ptxas_verbose=True)
    ptxas = {n: [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln][:8]
             for n, text in log.items()}
    emit("build", seconds=seconds, built=sorted(log), ptxas=ptxas)


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


def _hold(name, case, out, ref, faults, failures):
    """Kernel output against its plain version in bf16 ulps, and against each
    planted fault, which must read above the limit. Returns the readings;
    failures are collected so every case prints before the phase fails."""
    import torch
    tol = ULP_TOL
    err = ulp_err(out, ref)
    fault_err = {f: ulp_err(out, r) for f, r in faults.items()}
    if not torch.isfinite(out.float()).all().item():
        failures.append(f"{name} {case}: non-finite output")
    if not err <= tol:
        failures.append(f"{name} {case}: {err} bf16 ulps > {tol}")
    for f, e in fault_err.items():
        if not e > tol:
            failures.append(f"{name} {case}: planted fault {f} reads {e} ulps <= {tol}")
    return {"max_abs_err": float((out.float() - ref.float()).abs().max()),
            "ulp_err": err, "ulp_tol": tol, "fault_ulp_err": fault_err}


def phase_kernel(state, seed):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa
    from deepspeed_tpu_torch.ops.kernels import paged_decode_attention as pda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = state.setdefault("kernel_results", {})
    failures = []

    # A: (B, S, H, KV, Hd, causal, alibi, mask); "slice" = a Llama-7B
    # prefill at the 512-token bucket
    flash_cases = {
        "slice": (1, 512, 32, 32, 128, True, False, False),
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
               **_hold("flash_attention_fwd", name, o, ro,
                       {f: r[0] for f, r in faults.items()}, failures)}
        rec["lse_err"] = float((lse - rlse).abs().max())
        rec["lse_tol"] = LSE_TOL
        rec["fault_lse_err"] = float((lse - faults["last_key_dropped"][1]).abs().max())
        if not rec["lse_err"] <= LSE_TOL:
            failures.append(f"flash {name}: lse err {rec['lse_err']} > {LSE_TOL}")
        if not rec["fault_lse_err"] > LSE_TOL:
            failures.append(f"flash {name}: lse of last_key_dropped reads "
                            f"{rec['fault_lse_err']} <= {LSE_TOL}")
        if name in ("slice", "gpt2_hd64"):      # the Hd 128 and Hd 64 call sites
            q, k, v = args[0], args[1], args[2]
            rec["ms"] = cuda_ms(lambda: fa.flash_attention(*args))
            rec["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(*args), reps=20)
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
               **_hold("paged_decode_attention", name, o, ro, faults, failures)}
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
    check(not failures, "kernel checks failed: " + "; ".join(failures))


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


def _kernel_class(name):
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_attention_fwd"
    if "paged_decode_kernel" in n:
        return "paged_decode_attention"
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
    busy_ms = sum(by_class.values())
    # the profiler slows the host several times over, so the idle share is
    # taken against the unprofiled timed run of the same work
    wall_ms = runs["timed"]["wall_s"] * 1e3
    emit("profile", card=state.get("card"), tokens_per_s_warm=generated / runs["timed"]["wall_s"],
         runs=runs, device_busy_ms=busy_ms, timed_wall_ms=wall_ms,
         device_idle_share=1.0 - busy_ms / wall_ms,
         device_ms_by_class=by_class,
         top_kernels=[{"ms": ms, "count": n, "name": k}
                      for ms, n, k in sorted(top, reverse=True)[:15]])


def phase_kernels(state):
    res = state.get("kernel_results", {})
    launches = state.get("launches", {})
    rows = []
    meta = {
        "flash_attention_fwd": (
            "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:127 (_fwd_kernel; also "
            "_packed_fwd_kernel :272)"),
        "paged_decode_attention": (
            "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
            "deepspeed_tpu/ops/pallas/paged_decode_attention.py:46 (_kernel)"),
    }
    for name, (source, replaces) in meta.items():
        r = res.get(name, {})
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches.get(name), "max_abs_err": r.get("max_abs_err"),
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
        if p in ("kernel", "slice_parity", "serve", "profile"):
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
