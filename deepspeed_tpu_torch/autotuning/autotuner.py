"""The autotuner (counterpart of ``deepspeed_tpu/autotuning/autotuner.py``;
reference ``deepspeed/autotuning/autotuner.py:39``: experiment generation,
grid / random tuners with early stopping, ``ds_config_optimal.json``).

As in the JAX package, the reference's multi-process experiment scheduler
becomes two in-process phases:

1. **prune**: every candidate's live bytes for one train step are
   estimated and checked against the card's memory budget, without
   running a step. The JAX package reads XLA's ``memory_analysis()`` of
   the compiled step; torch has no ahead-of-time compile, so the port
   reckons the step's activations from the model's shapes and the
   candidate's remat policy (:func:`activation_bytes`), beside the same
   analytic state bytes (parameters, fp32 masters, Adam moments, grads)
   divided as ZeRO divides them. A run prints the estimate beside the
   trial's measured peak.
2. **measure**: survivors run ``end_profile_step`` real steps through the
   port's ``initialize``; the tuner (grid, random or model-based, with
   early stopping) ranks them by throughput (tokens/s) or latency and
   writes ``ds_config_optimal.json`` + ``autotuning_results.json``.

One card: ``_shard_factor`` is 1 at world size 1 (no mesh), the budget is
the card's total memory, and each trial's engine is released (every
reference dropped, ``gc.collect()``, ``torch.cuda.empty_cache()``) before
the next one is built.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.autotuning.config import (METRIC_THROUGHPUT, TUNER_MODELBASED,
                                                   TUNER_RANDOM, AutotuningConfig)
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.pytree import tree_leaves

_GIB = 1024**3


@dataclasses.dataclass
class Candidate:
    stage: int
    micro_batch: int
    remat: Any
    loss_chunk: int

    def config_overrides(self) -> Dict[str, Any]:
        return {
            "train_micro_batch_size_per_gpu": self.micro_batch,
            "zero_optimization": {"stage": self.stage},
        }

    def apply_to(self, base: Dict[str, Any]) -> Dict[str, Any]:
        """Merged config with the batch triad made consistent: the tuned
        micro-batch wins; a pinned train_batch_size would otherwise trip the
        triad check for most candidates."""
        cfg = _merge(copy.deepcopy(base), self.config_overrides())
        cfg.pop("train_batch_size", None)
        return cfg

    def name(self) -> str:
        return f"z{self.stage}_mbs{self.micro_batch}_remat-{self.remat}_chunk{self.loss_chunk}"


@dataclasses.dataclass
class Record:
    candidate: Candidate
    pruned: bool
    est_bytes: int
    metric_val: Optional[float] = None  # tokens/s (throughput) or s/step (latency)
    peak_bytes: Optional[int] = None    # the trial's device peak (max_memory_allocated)


_REMAT = {"none": None, False: None, None: None, True: "full", "full": "full"}


def activation_bytes(model, cand: Candidate, seq_len: int, compute_bytes: int,
                     fused_ce: Optional[str] = None) -> int:
    """Live activation bytes of one micro-step of a zoo causal LM under
    ``cand``, reckoned from the shapes (0 for a model without a transformer
    config): what autograd keeps a token of a layer (the norms' inputs and
    outputs, q, k and v, the attention output and its fp32 lse, the MLP's
    products and activations), all layers of it without remat; under a
    remat policy each layer's input, one layer's set during its recompute,
    and what the policy keeps beyond "full" ("selective": the q, k, v, wo
    and ff_down products and A's o and lse; "dots": every product;
    "offload_dots": nothing on the device). The fused CE head keeps no
    logits; the plain head keeps fp32 logits and their gradient (a
    ``loss_chunk`` of rows at a time)."""
    cfg = getattr(model, "config", None)
    needed = ("n_layer", "d_model", "n_head", "head_dim", "kv_heads", "ff_dim", "vocab_size")
    if cfg is None or not all(hasattr(cfg, n) for n in needed):
        return 0
    N = cand.micro_batch * seq_len
    L, D, H, F = cfg.n_layer, cfg.d_model, cfg.n_head, cfg.ff_dim
    KVD = cfg.kv_heads * cfg.head_dim
    gated = getattr(cfg, "activation", "swiglu") == "swiglu"
    e = compute_bytes
    layer = (6 * D + 2 * KVD + (4 if gated else 2) * F) * e + 4 * H
    policy = _REMAT.get(cand.remat, cand.remat)
    if policy is None:
        kept = L * layer
    else:
        extra = {"selective": (4 * D + 2 * KVD) * e + 4 * H,
                 "dots": (3 * D + 2 * KVD + 2 * F) * e}.get(policy, 0)
        kept = L * (D * e + extra) + layer
    mode = fused_ce or getattr(cfg, "fused_cross_entropy", "auto")
    rows = min(cand.loss_chunk, N) if cand.loss_chunk else N
    head = 0 if mode != "off" else 2 * 4 * rows * cfg.vocab_size
    return int(N * kept + head)


class Autotuner:
    """Search (zero stage, micro-batch, remat policy, loss chunk) for a model.

    ``model``: a zoo model (``CausalLM``-like: ``.config`` dataclass with
    ``remat`` / ``loss_chunk`` fields, ``.loss``, ``.init_params``) or any
    ``loss_fn(params, batch)``: plain callables tune stage x micro-batch
    only. ``batch_fn(mbs) -> batch dict`` supplies one micro-batch; zoo
    causal LMs get a seeded synthetic-token default. ``device`` is where the
    trials run (default ``cuda:0``; ``"cpu"`` runs the kernels' plain
    versions).
    """

    def __init__(self, model, model_parameters=None, base_config: Optional[Dict] = None,
                 autotuning_config: Optional[AutotuningConfig] = None,
                 batch_fn: Optional[Callable[[int], Any]] = None,
                 seq_len: Optional[int] = None, device=None):
        self.model = model
        self.base_config = copy.deepcopy(dict(base_config or {}))
        at = dict(self.base_config.get("autotuning", {}))
        at.pop("enabled", None)
        self.config = autotuning_config or AutotuningConfig(**at)
        self.device = torch.device(device or "cuda:0")
        self.params = (model_parameters if model_parameters is not None
                       else model.init_params(torch.Generator(device=self.device).manual_seed(0),
                                              device=self.device))
        self._records: List[Record] = []

        mcfg = getattr(model, "config", None)
        self._tunable_model = (mcfg is not None and dataclasses.is_dataclass(mcfg)
                               and hasattr(mcfg, "remat") and hasattr(mcfg, "loss_chunk"))
        self.seq_len = seq_len or (getattr(mcfg, "max_seq", None) or 128)
        self.vocab = getattr(mcfg, "vocab_size", 32000)
        self.batch_fn = batch_fn or self._default_batch_fn

    # ------------------------------------------------------------------ #

    def _default_batch_fn(self, mbs: int):
        rng = np.random.default_rng(0)
        return {"input_ids": rng.integers(0, self.vocab, size=(mbs, self.seq_len)).astype(np.int32)}

    def _variant(self, cand: Candidate):
        """Model with the candidate's remat / loss_chunk applied."""
        if not self._tunable_model:
            return self.model
        return _with_overrides(self.model, remat=cand.remat, loss_chunk=cand.loss_chunk)

    def _loss_fn(self, model):
        return model.loss if hasattr(model, "loss") else model

    def _compute_bytes(self) -> int:
        c = self.base_config
        low = any((c.get(k) or {}).get("enabled") for k in ("bf16", "bfloat16", "fp16"))
        return 2 if low else 4

    # --------------------------- phase 1: prune --------------------------- #

    def hbm_budget(self) -> int:
        """The memory one step may use: the configured bytes, else the
        card's total memory, times ``hbm_fraction`` (16 GiB on the CPU, the
        JAX package's fallback when the device reports none)."""
        if self.config.hbm_budget_bytes:
            return int(self.config.hbm_budget_bytes * self.config.hbm_fraction)
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            return int(total * self.config.hbm_fraction)
        return int(16 * _GIB * self.config.hbm_fraction)

    def _shard_factor(self, stage: int, what: str) -> int:
        """How many ways ZeRO divides this state class at a given stage:
        the data-parallel size of the base config's mesh (1 without one,
        as on one card)."""
        mesh_axes = self.base_config.get("mesh") or {}
        dp = 1
        for ax in ("dp", "fsdp"):
            v = mesh_axes.get(ax, 1)
            if v and v > 0:
                dp *= v
        gates = {"master_opt": 1, "grads": 2, "params": 3}
        return dp if stage >= gates[what] else 1

    def estimate_bytes(self, cand: Candidate) -> int:
        """Live bytes for one train step: analytic state bytes (with ZeRO
        shard division) + the step's activations (:func:`activation_bytes`).

        The JAX package's state terms (bf16 compute params, fp32 masters,
        Adam's two moments, fp32 grads), plus two that the port's engine
        holds and the JAX step does not: the params the tuner hands to
        every trial (``model_parameters``, on the trial's device, kept
        beside the engine's own copy) and the backward's ``param.grad`` in
        the compute dtype, all alive when the backward ends."""
        leaves = [t for t in tree_leaves(self.params) if isinstance(t, torch.Tensor)]
        psize = sum(t.numel() for t in leaves)
        n_param_bytes = 2 * psize      # bf16 compute params
        n_master_bytes = 4 * psize     # fp32 master
        n_opt_bytes = 8 * psize        # adam m+v fp32
        n_grad_bytes = 4 * psize       # fp32 grads
        held = sum(t.numel() * t.element_size() for t in leaves
                   if t.device.type == self.device.type)
        backward_grads = self._compute_bytes() * psize
        state = (n_param_bytes // self._shard_factor(cand.stage, "params")
                 + (n_master_bytes + n_opt_bytes) // self._shard_factor(cand.stage, "master_opt")
                 + (n_grad_bytes + backward_grads) // self._shard_factor(cand.stage, "grads"))
        return held + state + activation_bytes(self._variant(cand), cand, self.seq_len,
                                               self._compute_bytes(),
                                               self.base_config.get("fused_cross_entropy"))

    def prune(self, cand: Candidate) -> Tuple[bool, int]:
        """(fits, estimated_bytes). An estimate that fails counts as pruned."""
        try:
            est = self.estimate_bytes(cand)
        except Exception as e:  # noqa: BLE001 - any failure = unusable config
            logger.warning(f"autotuning: {cand.name()} could not be estimated ({e}); pruned")
            return False, 1 << 62
        return est <= self.hbm_budget(), est

    # -------------------------- phase 2: measure -------------------------- #

    def measure(self, cand: Candidate) -> float:
        """Run the candidate through the real engine; returns the metric
        (tokens/s for throughput, s/step for latency). The trial's device
        peak lands in ``last_peak_bytes``; its engine is released before
        this returns."""
        import deepspeed_tpu_torch

        model = self._variant(cand)
        config = cand.apply_to(self.base_config)
        config.setdefault("steps_per_print", 0)
        config.pop("autotuning", None)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.last_peak_bytes = None
        engine = None
        try:
            engine, _, _, _ = deepspeed_tpu_torch.initialize(
                model=model, model_parameters=self.params, config=config, device=self.device)
            batch = self.batch_fn(cand.micro_batch)
            gas = engine.gradient_accumulation_steps()
            full = {k: np.concatenate([np.asarray(x)] * gas, axis=0) for k, x in batch.items()}
            warm = self.config.start_profile_step
            steps = max(1, self.config.end_profile_step - warm)
            for _ in range(max(1, warm)):
                loss = engine.train_batch(full)
            float(loss)
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = engine.train_batch(full)
            float(loss)
            dt = (time.perf_counter() - t0) / steps
            if cuda:
                self.last_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        finally:
            del engine
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        tokens = cand.micro_batch * self.seq_len * gas
        return (tokens / dt) if self.config.metric == METRIC_THROUGHPUT else dt

    # ------------------------------ search ------------------------------ #

    def _mbs_list(self) -> List[int]:
        lo = self.config.min_train_micro_batch_size_per_gpu
        hi = self.config.max_train_micro_batch_size_per_gpu or max(lo, 512)
        out, m = [], lo
        while m <= hi:
            out.append(m)
            m *= 2
        return out

    def candidates(self) -> List[Candidate]:
        remats = ["none"] if self.config.fast or not self._tunable_model \
            else list(self.config.remat_policies)
        chunks = [0] if self.config.fast or not self._tunable_model \
            else list(self.config.loss_chunks)
        if len(chunks) > 1:
            # loss_chunk only matters on the plain head: with the fused CE
            # kernels forced on, the chunk values run the same step and the
            # axis would multiply the grid for meaningless candidates
            mcfg = getattr(self.model, "config", None)
            if getattr(mcfg, "fused_cross_entropy", None) == "on":
                chunks = [0]
        cands = [Candidate(stage=s, micro_batch=m, remat=r, loss_chunk=c)
                 for s in self.config.zero_stages
                 for m in self._mbs_list()
                 for r in remats
                 for c in chunks]
        if self.config.tuner_type == TUNER_RANDOM and len(cands) > self.config.tuner_num_trials:
            cands = random.Random(0).sample(cands, self.config.tuner_num_trials)
        # gridsearch is NOT truncated by tuner_num_trials: a stage-major cut
        # would silently drop whole ZeRO stages; early stopping bounds work
        return cands

    def tune(self) -> Dict[str, Any]:
        """Run the search; returns the optimal merged config dict and writes
        ``ds_config_optimal.json`` / ``autotuning_results.json``."""
        budget = self.hbm_budget()
        logger.info(f"autotuning: memory budget {budget / _GIB:.2f} GiB, "
                    f"metric={self.config.metric}, tuner={self.config.tuner_type}")

        if self.config.tuner_type == TUNER_MODELBASED:
            best = self._search_model_based()
        else:
            best = self._search_sequential()

        if best is None:
            raise RuntimeError("autotuning: no candidate fit the memory budget")
        optimal = self.optimal_config(best.candidate)
        self._write_results(optimal)
        return optimal

    def _prune_record(self, cand: Candidate) -> Record:
        fits, est = self.prune(cand)
        rec = Record(candidate=cand, pruned=not fits, est_bytes=est)
        self._records.append(rec)
        if not fits:
            logger.info(f"autotuning: prune {cand.name()} "
                        f"(~{est / _GIB:.2f} GiB > budget)")
        return rec

    def _measure_record(self, rec: Record) -> bool:
        """Measure one survivor in place; False (and ``pruned``) on failure.
        A fault of the device or of a kernel (a CUDA error other than out of
        memory, a kernel that does not build) raises: it is no property of
        the candidate, and the trials after it would run on a broken
        context."""
        self.last_peak_bytes = None
        try:
            rec.metric_val = self.measure(rec.candidate)
        except Exception as e:  # noqa: BLE001 - record + keep searching
            if _device_fault(e):
                raise
            logger.warning(f"autotuning: {rec.candidate.name()} failed to run "
                           f"({e}); skipped")
            rec.pruned = True
            return False
        rec.peak_bytes = getattr(self, "last_peak_bytes", None)
        logger.info(f"autotuning: {rec.candidate.name()} -> {rec.metric_val:.1f} "
                    f"({self.config.metric})")
        return True

    def _search_sequential(self) -> Optional[Record]:
        """Grid / random order: prune + measure candidates as they come."""
        best: Optional[Record] = None
        stale = 0
        for cand in self.candidates():
            rec = self._prune_record(cand)
            if rec.pruned or not self._measure_record(rec):
                continue
            if best is None or self._better(rec.metric_val, best.metric_val):
                best, stale = rec, 0
            else:
                stale += 1
                if stale >= self.config.tuner_early_stopping:
                    logger.info("autotuning: early stopping")
                    break
        return best

    def _search_model_based(self) -> Optional[Record]:
        """Cost-model-steered measure order (reference
        ``autotuning/tuner/model_based_tuner.py``): prune the whole space,
        measure a few spread-out seeds, then repeatedly fit the model on
        everything measured and measure the best-predicted survivor next,
        reaching the winner in fewer measured trials than walking the grid."""
        from deepspeed_tpu_torch.autotuning.cost_model import CostModel, featurize

        survivors = [r for r in (self._prune_record(c) for c in self.candidates())
                     if not r.pruned]
        if not survivors:
            return None

        best: Optional[Record] = None

        def run(rec: Record) -> bool:
            nonlocal best
            if not self._measure_record(rec):
                return False
            if best is None or self._better(rec.metric_val, best.metric_val):
                best = rec
                return True
            return False

        n_seed = min(self.config.tuner_num_seed_trials, len(survivors))
        seed_idx = sorted({round(i * (len(survivors) - 1) / max(1, n_seed - 1))
                           for i in range(n_seed)})
        for i in seed_idx:
            run(survivors[i])

        model = CostModel()
        stale, trials = 0, sum(r.metric_val is not None for r in survivors)
        while trials < self.config.tuner_num_trials:
            done = [r for r in survivors if r.metric_val is not None]
            pending = [r for r in survivors
                       if r.metric_val is None and not r.pruned]
            if not done or not pending:
                break
            model.fit([featurize(r.candidate, r.est_bytes) for r in done],
                      [r.metric_val for r in done])
            preds = model.predict([featurize(r.candidate, r.est_bytes)
                                   for r in pending])
            pick = int(np.argmax(preds) if self.config.metric == METRIC_THROUGHPUT
                       else np.argmin(preds))
            improved = run(pending[pick])
            trials += 1
            stale = 0 if improved else stale + 1
            if stale >= self.config.tuner_early_stopping:
                logger.info("autotuning: early stopping (model-based)")
                break
        return best

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.config.metric == METRIC_THROUGHPUT else a < b

    def optimal_config(self, cand: Candidate) -> Dict[str, Any]:
        cfg = cand.apply_to(self.base_config)
        cfg.pop("autotuning", None)
        if self._tunable_model:
            cfg["model_overrides"] = {"remat": cand.remat, "loss_chunk": cand.loss_chunk}
        return cfg

    def _write_results(self, optimal: Dict[str, Any]) -> None:
        d = self.config.results_dir
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "ds_config_optimal.json"), "w") as f:
            json.dump(optimal, f, indent=2)
        rows = [{"candidate": dataclasses.asdict(r.candidate), "pruned": r.pruned,
                 "est_bytes": int(r.est_bytes), "metric": r.metric_val,
                 "peak_bytes": r.peak_bytes}
                for r in self._records]
        with open(os.path.join(d, "autotuning_results.json"), "w") as f:
            json.dump({"metric": self.config.metric, "records": rows}, f, indent=2)

    @property
    def records(self) -> List[Record]:
        return self._records


def _device_fault(e: Exception) -> bool:
    """Whether ``e`` is a CUDA error other than out of memory, or a kernel
    that failed to build."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    msg = str(e)
    return "CUDA" in msg or "nvcc" in msg or type(e).__name__ == "AcceleratorError"


def _merge(base: Dict, over: Dict) -> Dict:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            base[k] = _merge(dict(base[k]), v)
        else:
            base[k] = v
    return base


def _with_overrides(model, **over):
    """``model`` rebuilt on its config with ``over`` (a remat policy named
    "none" / "full" as the config's False / True), its param dtype kept."""
    if "remat" in over:
        over["remat"] = {"none": False, "full": True}.get(over["remat"], over["remat"])
    tuned = type(model)(dataclasses.replace(model.config, **over))
    if hasattr(model, "param_dtype"):
        tuned.param_dtype = model.param_dtype
    return tuned


def apply_optimal(model, optimal: Dict[str, Any]):
    """``(model, config)`` to train with a ``ds_config_optimal.json``: the
    model with its ``model_overrides`` applied (remat policy, loss chunk,
    ...) and the config without them, ready for ``initialize``."""
    config = copy.deepcopy(optimal)
    over = config.pop("model_overrides", None)
    return (_with_overrides(model, **over) if over else model), config


def autotune(model, model_parameters=None, config: Optional[Dict] = None, **kw) -> Dict[str, Any]:
    """One-call tuning: returns the optimal config dict (reference
    ``deepspeed.autotuner`` CLI flow as a library call)."""
    return Autotuner(model, model_parameters, config, **kw).tune()
