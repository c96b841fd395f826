"""Training engine: the single-device training path of
``deepspeed_tpu/runtime/engine.py`` in PyTorch.

``DeepSpeedEngine.train_batch`` runs one global batch: ``gas`` micro-steps of
forward + backward, each micro-step's gradients added to fp32 accumulation
buffers and then released, and one optimizer update (``_apply_update``):
unscale by ``loss_scale * gas``, skip on an fp16 overflow, clip on the
pre-clip global norm, ``master <- master - lr * u`` per leaf with ``u`` the
optimizer's descent direction (one kernel E launch that writes the master
in place for the Adam family) and the scheduled lr taken before the step
counter moves, and the compute-dtype params refreshed from the masters in
place. LAMB's trust ratio spans one JAX leaf (all layers of a stacked leaf),
so it updates each group of per-layer leaves at once: the moments pass over
every leaf of the group, then the group's ratio on the device, then the
apply pass. With ``quantize_training`` enabled, ``train_batch`` then
fake-quantizes the compute-dtype params (MoQ, ``runtime/quantize.py``) as the
JAX engine's ``_quantize_step`` does. With ``gas == 1`` the micro-step's gradients feed the update directly
in the compute dtype, with no buffers, as the JAX engine's fused path does.
The ``forward`` / ``backward`` / ``step`` trio gives the same result.

Where the JAX engine compiles the whole batch into one program over
immutable arrays, the port runs eagerly and updates in place: gradients
live in ``param.grad`` only until they are accumulated, and the update runs
leaf by leaf, so one unscaled fp32 gradient is alive at a time. The state is the JAX
``TrainState``'s fields as attributes of :class:`TrainState`.

Settings outside this slice (a client optimizer, the dataloader, offload,
the 1-bit optimizers, pipeline and multi-device runs, ...) raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional

import torch

from deepspeed_tpu_torch.accelerator.real_accelerator import resolve_device
from deepspeed_tpu_torch.config.core import DeepSpeedConfig
from deepspeed_tpu_torch.models.transformer import ParamTree, map_tree
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.loss_scaler import (LossScaleState, has_overflow,
                                                     make_loss_scale_state)
from deepspeed_tpu_torch.runtime.loss_scaler import update as scaler_update
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.quantize import quantizer_from_config
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, global_norm, jax_leaves
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.not_ported import not_ported

_DTYPES = {None: torch.float32, "fp32": torch.float32, "fp16": torch.float16,
           "bf16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """What one update reads and writes (the JAX engine's ``TrainState``)."""
    params: ParamTree                        # compute-dtype params (requires_grad)
    master: Optional[Dict[str, torch.Tensor]]  # fp32 masters by leaf name (None for fp32)
    opt_state: Any                           # the optimizer's state (runtime/optimizers.py)
    acc_grads: Optional[Dict[str, torch.Tensor]]  # accumulation buffers (None: gas 1)
    scaler: LossScaleState
    micro_steps: int = 0
    global_steps: int = 0
    skipped_steps: int = 0


def _loss_fn_of(model) -> Callable:
    if callable(model) and not hasattr(model, "loss"):
        fn = model
    elif hasattr(model, "loss"):
        fn = model.loss
    else:
        raise TypeError("model must be a loss callable loss_fn(params, batch[, rng]) or expose .loss")
    try:
        n_args = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_args = 2
    if n_args >= 3:
        return fn
    return lambda params, batch, rng: fn(params, batch)


class DeepSpeedEngine:

    def __init__(self, model, config: Optional[Any] = None, model_parameters=None,
                 optimizer=None, lr_scheduler=None, training_data=None, device=None):
        if optimizer is not None:
            not_ported("a client optimizer", "queue 1: training step (client optimizers)")
        if training_data is not None:
            not_ported("training_data (the engine's dataloader)",
                       "queue 1: training step (dataloader)")
        self.client_model = model
        self.loss_fn = _loss_fn_of(model)
        self._config = DeepSpeedConfig(config if config is not None else {})
        # a JSON-level "fused_cross_entropy" beats the model config's default
        fce = self._config.fused_cross_entropy
        mcfg = getattr(model, "config", None)
        if fce is not None and mcfg is not None and hasattr(mcfg, "fused_cross_entropy"):
            model.config = dataclasses.replace(mcfg, fused_cross_entropy=fce)
            mcfg = model.config
        self.device = resolve_device(device)

        # ---- precision ----
        if self.bfloat16_enabled():
            self.compute_dtype = torch.bfloat16
        elif self.fp16_enabled():
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.mixed_precision = self.compute_dtype != torch.float32
        if (self.device.type == "cuda" and not self.mixed_precision
                and getattr(mcfg, "attention_backend", "auto") != "xla"):
            raise ValueError("the CUDA attention kernels take fp16/bf16: train with bf16 (or "
                             "fp16) enabled on the GPU")
        acc_name = self._config.gradient_accumulation_dtype
        # gas 1 feeds the micro-step grads straight to the update in compute
        # dtype; with gas > 1 grads accumulate in fp32 (the JAX engine's rule)
        if acc_name is None and self.gradient_accumulation_steps() == 1:
            self.grad_acc_dtype = self.compute_dtype
        else:
            self.grad_acc_dtype = _DTYPES[acc_name]

        # ---- optimizer ----
        self.tx = build_optimizer(self._config.optimizer_name, self._config.optimizer_params)
        self._optimizer_name = self._config.optimizer_name or "adamw"

        # ---- MoQ (quantize_training) ----
        self.quantizer = (quantizer_from_config(self._config.quantize_training)
                          if self._config.quantize_training_enabled else None)
        self._moq_seen_skipped = 0

        # ---- lr schedule ----
        self.lr_scheduler = None
        base_lr = (self._config.optimizer_params or {}).get("lr", 1e-3)
        if lr_scheduler is not None and hasattr(lr_scheduler, "schedule_fn"):
            self._lr_fn = lr_scheduler.schedule_fn
            self.lr_scheduler = lr_scheduler
        elif callable(lr_scheduler):
            self._lr_fn = lr_scheduler
        elif self._config.scheduler_name is not None:
            params = self._config.scheduler_params or {}
            self._lr_fn = lr_schedules.get_lr_schedule_fn(self._config.scheduler_name, params)
            self.lr_scheduler = getattr(lr_schedules, self._config.scheduler_name)(**params)
        else:
            self._lr_fn = lambda step: base_lr

        # ---- state ----
        if model_parameters is None:
            if not hasattr(model, "init_params"):
                raise ValueError("model_parameters is required (or model must expose init_params)")
            # seeded random init on the device (the JAX engine's key(0))
            gen = torch.Generator(device=self.device).manual_seed(0)
            model_parameters = model.init_params(gen, device=self.device)
        self.state = self._init_state(model_parameters)
        self._rng = torch.Generator().manual_seed(42)   # dropout stream (the JAX DS_SEED default)
        self._cached_loss = None
        self._losses = None
        self._global_grad_norm = None
        self._skipped_before_step = None
        log_dist(f"DeepSpeedEngine ready: optimizer={self._optimizer_name}, "
                 f"dtype={self.compute_dtype}, device={self.device}, "
                 f"micro_bs={self.train_micro_batch_size_per_gpu()} x "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ #
    # state

    def _init_state(self, model_parameters) -> TrainState:
        tree = model_parameters.to_dict() if isinstance(model_parameters, ParamTree) \
            else model_parameters
        dev = self.device
        params = ParamTree(map_tree(
            lambda a: torch.as_tensor(a).detach().to(dev, self.compute_dtype, copy=True), tree),
            requires_grad=True)
        self._names = [n for n, _ in params.named_parameters()]
        self._groups = list(jax_leaves(self._names).values())
        master = None
        if self.mixed_precision:
            fp32 = ParamTree(map_tree(
                lambda a: torch.as_tensor(a).detach().to(dev, torch.float32, copy=True), tree))
            master = {n: p.data for n, p in fp32.named_parameters()}
        target = master if master is not None else self._param_dict(params)
        opt_state = self.tx.init(target)
        if self.fp16_enabled() and self._config.fp16_config.dynamic_loss_scale:
            args = self._config.dynamic_loss_scale_args
            scaler = make_loss_scale_state(init_scale=args["init_scale"],
                                           scale_window=args["scale_window"],
                                           min_scale=args["min_scale"],
                                           delayed_shift=args["delayed_shift"])
        elif self.fp16_enabled():
            scaler = make_loss_scale_state(init_scale=self._config.loss_scale or 1.0, dynamic=False)
        else:
            scaler = make_loss_scale_state(init_scale=1.0, dynamic=False)
        state = TrainState(params=params, master=master, opt_state=opt_state, acc_grads=None,
                           scaler=scaler)
        self.state = state
        if self._uses_acc_grad_buffers():
            self._ensure_acc_grads()
        return state

    @staticmethod
    def _param_dict(params: ParamTree) -> Dict[str, torch.Tensor]:
        return dict(params.named_parameters())

    def _uses_acc_grad_buffers(self) -> bool:
        """Whether train_batch reads the accumulation buffers (gas > 1)."""
        return self.gradient_accumulation_steps() != 1

    def _ensure_acc_grads(self) -> None:
        """Allocate the accumulation buffers (gas > 1, or the trio)."""
        if self.state.acc_grads is None:
            self.state.acc_grads = {
                n: torch.zeros(p.shape, dtype=self.grad_acc_dtype, device=p.device)
                for n, p in self.state.params.named_parameters()}

    def load_train_state(self, params=None, master=None, opt_state=None,
                         global_steps: Optional[int] = None) -> None:
        """Carry a training state in (e.g. one taken from the JAX package
        with ``checkpoint.from_jax``): ``params`` a tree of the model's
        layout, ``master`` and the optimizer state's tensors by leaf name
        (an ``AdamState``, ``SGDState``, ``LionState`` or ``AdagradState``
        of the engine's optimizer). Values are copied into the engine's own
        tensors; what is not given stays."""
        named = self._param_dict(self.state.params)
        with torch.no_grad():
            if params is not None:
                tree = params.to_dict() if isinstance(params, ParamTree) else params
                src = dict(ParamTree(tree).named_parameters())
                for n, p in named.items():
                    p.copy_(src[n])
                if self.state.master is not None and master is None:
                    for n, m in self.state.master.items():
                        m.copy_(src[n])
            if master is not None:
                for n, m in self.state.master.items():
                    m.copy_(master[n])
                    named[n].copy_(m)
            if opt_state is not None:
                mine = self.state.opt_state
                if type(opt_state) is not type(mine):
                    raise TypeError(f"{type(opt_state).__name__} given, the engine's "
                                    f"{self._optimizer_name} keeps a {type(mine).__name__}")
                for field in mine.FIELDS:
                    for n in self._names:
                        getattr(mine, field)[n].copy_(getattr(opt_state, field)[n])
                mine.count = int(opt_state.count)
        if global_steps is not None:
            self.state.global_steps = int(global_steps)

    # ------------------------------------------------------------------ #
    # the step's parts

    def _batch_to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, x in batch.items():
            t = torch.as_tensor(x)
            out[k] = t.to(self.device, torch.long if not t.is_floating_point() else t.dtype)
        return out

    def _micro_grads(self, batch) -> torch.Tensor:
        """Loss of one micro-batch; the loss-scaled grads land in the
        params' ``.grad`` (compute dtype)."""
        out = self.loss_fn(self.state.params, batch, self._rng)
        loss = out[0] if isinstance(out, tuple) else out
        (loss.float() * self.state.scaler.loss_scale).backward()
        return loss.detach()

    def _accumulate(self) -> None:
        """Add each leaf's ``.grad`` to its buffer and release it."""
        acc = self.state.acc_grads
        for n, p in self.state.params.named_parameters():
            g = p.grad
            if g is None:        # a leaf the loss does not reach: zero grad
                continue
            # a wider buffer adds the narrow grad exactly; a narrower one
            # rounds it first, as ``a + g.astype(acc_dtype)`` does
            acc[n].add_(g if acc[n].dtype in (g.dtype, torch.float32) else g.to(acc[n].dtype))
            p.grad = None

    def _apply_update(self, gas: int, grads: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Unscale, (fp16) skip on overflow, clip on the pre-clip global norm,
        update leaf by leaf, refresh the compute params from the masters in
        place. ``grads``: the gas == 1 micro-step grads; default the
        accumulation buffers, which are zeroed afterwards."""
        st = self.state
        from_buffers = grads is None
        denom = st.scaler.loss_scale * gas
        if from_buffers:
            # fp32 buffers are unscaled in place (they are zeroed after)
            grads = {n: (g.div_(denom) if g.dtype == torch.float32 else g.float() / denom)
                     for n, g in st.acc_grads.items()}
            unscaled = grads.__getitem__
        else:
            unscaled = lambda n: grads[n].float() / denom
        names = self._names
        overflow = bool(has_overflow(unscaled(n) for n in names)) if self.fp16_enabled() \
            else False
        clip = float(self.gradient_clipping() or 0.0)
        norm = global_norm(unscaled(n) for n in names) if clip > 0.0 else None
        self._global_grad_norm = norm
        lr = float(self._lr_fn(st.global_steps))
        if not overflow:
            st.opt_state.count += 1
            params = self._param_dict(st.params)
            targets = st.master if st.master is not None else params

            def clipped(n):
                g = unscaled(n)
                if clip > 0.0:
                    clip_grad_norm_([g], clip, norm=norm)
                return g

            with torch.no_grad():
                if self.tx.group_update is not None:
                    # one trust ratio per JAX leaf; the compute params are
                    # refreshed after the group's apply pass
                    for group in self._groups:
                        self.tx.group_update(st.opt_state, group, clipped, targets, lr)
                        if st.master is not None:
                            for n in group:
                                params[n].copy_(targets[n])
                else:
                    for n in names:
                        self.tx.leaf_update(st.opt_state, n, clipped(n), targets[n], lr)
                        if st.master is not None:
                            params[n].copy_(targets[n])
        st.scaler = scaler_update(st.scaler, overflow)
        if from_buffers:
            for g in st.acc_grads.values():
                g.zero_()
        st.global_steps += 1
        st.skipped_steps += int(overflow)

    # ------------------------------------------------------------------ #
    # public API

    def train_batch(self, batch=None, data_iter=None):
        """Run one full training batch (gas micro-steps + update). ``batch``
        is a dict whose leaves have leading dim ``gas * micro_bs``; returns
        the mean loss (a 0-dim tensor on the device)."""
        if data_iter is not None or batch is None:
            not_ported("train_batch without a batch (data_iter / the engine's dataloader)",
                       "queue 1: training step (dataloader)")
        gas = self.gradient_accumulation_steps()
        micro_bs = self.train_micro_batch_size_per_gpu()
        expected = gas * micro_bs
        lead = next(iter(batch.values())).shape[0]
        if lead != expected:
            raise ValueError(
                f"train_batch leading dim {lead} != gas({gas}) * micro_bs({micro_bs}) * dp(1) "
                f"= {expected}")
        batch = {k: x.reshape((gas, -1) + tuple(x.shape[1:]))
                 for k, x in self._batch_to_device(batch).items()}
        self._skipped_before_step = self.state.skipped_steps
        if gas == 1:
            loss = self._micro_grads({k: x[0] for k, x in batch.items()})
            self.state.micro_steps += 1
            grads = {}
            for n, p in self.state.params.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad
                grads[n] = g.to(self.grad_acc_dtype)
                p.grad = None
            self._apply_update(1, grads)
            del grads
        else:
            self._ensure_acc_grads()
            losses = []
            for i in range(gas):
                losses.append(self._micro_grads({k: x[i] for k, x in batch.items()}))
                self._accumulate()
            self.state.micro_steps += gas
            self._apply_update(gas)
            loss = torch.stack(losses).mean()
        if self.quantizer is not None:
            self._quantize_step()
        self._losses = loss
        self._report_progress(loss)
        return loss

    def _quantize_step(self) -> None:
        """MoQ after the update (the JAX engine's ``_quantize_step``, run by
        ``train_batch`` only): walk the per-leaf bit schedule and
        fake-quantize the compute-dtype params in place, never the fp32
        masters. An fp16 overflow step skipped its update and does not
        advance the schedule."""
        overflow = False
        if self.fp16_enabled():
            cur = self.state.skipped_steps
            overflow = cur > self._moq_seen_skipped
            self._moq_seen_skipped = cur
        self.quantizer.quantize_tree(self._param_dict(self.state.params), overflow=overflow)

    def forward(self, batch):
        """Loss of one micro-batch, with its graph kept for ``backward``."""
        out = self.loss_fn(self.state.params, self._batch_to_device(batch), self._rng)
        loss = out[0] if isinstance(out, tuple) else out
        self._cached_loss = loss
        self._losses = loss.detach()
        return loss

    __call__ = forward

    def backward(self, loss=None, batch=None, allreduce_gradients=True, release_loss=False):
        """Back-propagate the loss of the last ``forward()`` (or of
        ``batch``, run here) at the loss scale and accumulate its grads."""
        if batch is not None:
            self.forward(batch)
        if self._cached_loss is None:
            raise RuntimeError("backward() called before forward(); pass batch= explicitly if needed")
        (self._cached_loss.float() * self.state.scaler.loss_scale).backward()
        self._cached_loss = None
        self._ensure_acc_grads()
        self._accumulate()
        self.state.micro_steps += 1
        return self._losses

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.state.micro_steps % self.gradient_accumulation_steps() == 0

    def step(self, lr_kwargs=None):
        """Apply the optimizer update at the accumulation boundary (no-op
        otherwise)."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._skipped_before_step = self.state.skipped_steps
        self._apply_update(self.gradient_accumulation_steps())
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._report_progress(self._losses)

    def eval_batch(self, batch):
        """Evaluation loss, deterministic (no dropout) and without grads."""
        with torch.no_grad():
            out = self.loss_fn(self.state.params, self._batch_to_device(batch), None)
        return out[0] if isinstance(out, tuple) else out

    def _report_progress(self, loss) -> None:
        spp = self.steps_per_print()
        if spp and self.state.global_steps % spp == 0:
            log_dist(f"step={self.state.global_steps}, skipped={self.state.skipped_steps}, "
                     f"lr={self.get_lr()}, loss={float(loss)}", ranks=[0])

    # ------------------------------------------------------------------ #
    # accessors

    def train_batch_size(self) -> int:
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self) -> int:
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self) -> int:
        return self._config.gradient_accumulation_steps

    def gradient_clipping(self) -> float:
        return self._config.gradient_clipping

    def fp16_enabled(self) -> bool:
        return self._config.fp16_enabled

    def bfloat16_enabled(self) -> bool:
        return self._config.bfloat16_enabled

    def steps_per_print(self) -> int:
        return self._config.steps_per_print

    def was_step_applied(self) -> bool:
        """True when the most recent boundary step updated params (not an
        fp16 overflow skip)."""
        if self._skipped_before_step is None:
            return False
        return self.state.skipped_steps == self._skipped_before_step

    @property
    def global_steps(self) -> int:
        return self.state.global_steps

    @property
    def skipped_steps(self) -> int:
        return self.state.skipped_steps

    def get_lr(self):
        return [float(self._lr_fn(self.state.global_steps))]

    def get_global_grad_norm(self) -> Optional[float]:
        """The pre-clip global gradient norm of the last update (computed
        for clipping; None before the first update or with clipping off)."""
        return None if self._global_grad_norm is None else float(self._global_grad_norm)

    @property
    def loss_scale(self) -> float:
        return float(self.state.scaler.loss_scale)

    @property
    def module(self):
        return self.client_model

    @property
    def optimizer(self):
        return self.tx
