"""ZeRO-Offload / ZeRO-Infinity host optimizer, the counterpart of
``deepspeed_tpu/runtime/zero/offload.py``.

The fp32 masters and the Adam or Adagrad moments live in host RAM
(``device="cpu"``) or on NVMe through the aio engine (``"nvme"``), keyed by
the JAX package's leaf keys (``layers.attn.wq``, ...) as flat fp32 buffers
of the stacked leaf: one ``cpu_adam`` (or ``cpu_adagrad``) call a JAX leaf,
and the state is the JAX layout key for key and shape for shape, so
``state_dict()`` and a tag's ``offload_state_p0.npz`` cross-load between
the packages. The port's per-layer tensors are views of those buffers
(:meth:`HostOffloadOptimizer.layer_views`). The update writes the bf16
params into caller-given staging buffers in the same pass (the reference's
``ds_adam_step_plus_copy``), which the engine copies to the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.utils.logging import logger


def nonfinite(g: torch.Tensor) -> bool:
    """Whether ``g`` holds a NaN or an inf: the JAX optimizer's check, a
    float64 sum (finite fp32 values cannot overflow it). An fp32 sum is the
    fast path, 20x quicker on the host: it is finite only when every element
    is, and a non-finite one is confirmed in float64."""
    return not (bool(torch.isfinite(g.sum(dtype=torch.float32)))
                or bool(torch.isfinite(g.sum(dtype=torch.float64))))


def stacked(key: str) -> bool:
    """Whether the JAX leaf ``key`` stacks the layers (``[n_layer, ...]``)."""
    return key.startswith("layers.")


class HostOffloadOptimizer:
    """Adam / AdamW / Adagrad over host-resident (or NVMe-resident) state.

    ``model_parameters`` maps each JAX leaf key, in the JAX flatten order,
    to its tensors: one, or the per-layer tensors of a stacked leaf in layer
    order; their values become the fp32 masters."""

    def __init__(self, model_parameters: Dict[str, Sequence[torch.Tensor]], *,
                 optimizer_name: str = "adamw", optimizer_params: Optional[dict] = None,
                 device: str = "cpu", nvme_path: Optional[str] = None,
                 aio_config: Optional[dict] = None, grad_clip: float = 0.0):
        optimizer_params = dict(optimizer_params or {})
        self.grad_clip = grad_clip
        self.device = device
        name = (optimizer_name or "adamw").lower()
        if name in ("adam", "adamw"):
            from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
            adamw = name == "adamw" or optimizer_params.get("adam_w_mode", False)
            self.opt = DeepSpeedCPUAdam(
                lr=optimizer_params.get("lr", 1e-3),
                betas=tuple(optimizer_params.get("betas", (0.9, 0.999))),
                eps=optimizer_params.get("eps", 1e-8),
                weight_decay=optimizer_params.get("weight_decay", 0.0), adamw_mode=adamw)
            self._state_attrs = {"exp_avg": "_m", "exp_avg_sq": "_v"}
        elif name == "adagrad":
            from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
            self.opt = DeepSpeedCPUAdagrad(lr=optimizer_params.get("lr", 1e-2),
                                           eps=optimizer_params.get("eps", 1e-10),
                                           weight_decay=optimizer_params.get("weight_decay", 0.0))
            self._state_attrs = {"exp_avg_sq": "_h"}
        else:
            raise ValueError(f"offload_optimizer supports adam/adamw/adagrad on host, got '{name}'")

        self._order: List[str] = list(model_parameters)
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._masters: Dict[str, torch.Tensor] = {}
        for key, tensors in model_parameters.items():
            tensors = list(tensors)
            lead = (len(tensors),) if stacked(key) else ()
            self._shapes[key] = lead + tuple(tensors[0].shape)
            master = torch.empty(sum(t.numel() for t in tensors), dtype=torch.float32)
            off = 0
            for t in tensors:
                master[off:off + t.numel()].copy_(t.detach().reshape(-1))
                off += t.numel()
            self._masters[key] = master

        self.swapper = None
        if device == "nvme":
            from deepspeed_tpu_torch.runtime.swap_tensor import PartitionedOptimizerSwapper
            if not nvme_path:
                raise ValueError("offload_optimizer device=nvme requires nvme_path")
            self.swapper = PartitionedOptimizerSwapper(
                nvme_path, aio_config, state_keys=("master",) + tuple(self._state_attrs))
            for key in self._order:
                self.swapper.register_partition(key, self._masters[key])
            self._masters = {}  # the masters live on NVMe now
            logger.info(f"offloaded optimizer state for {len(self._order)} tensors to NVMe "
                        f"at {nvme_path}")

    # ------------------------------------------------------------------ #
    def _clip_coef(self, grads: Dict[str, torch.Tensor]) -> float:
        sq = 0.0
        for g in grads.values():
            gf = g.float()
            sq += float(torch.dot(gf, gf))
        return min(1.0, self.grad_clip / (sq**0.5 + 1e-6))

    def step(self, grads: Dict[str, torch.Tensor], lr: float,
             out: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[Dict[str, torch.Tensor], bool]:
        """One update. ``grads`` maps each key to its flat unscaled fp32 (or
        bf16) host gradient; a clip scales them in place. ``out`` maps each
        key to a bf16 buffer that receives the updated params in the same
        pass. Returns (staged updated params by key: the ``out`` buffers, or
        the fp32 masters without them; overflow flag); on overflow nothing
        is updated."""
        if any(nonfinite(g) for g in grads.values()):
            return {}, True
        if self.grad_clip > 0:
            coef = self._clip_coef(grads)
            if coef != 1.0:
                grads = {k: (g.mul_(coef) if g.dtype == torch.float32 else g.float() * coef)
                         for k, g in grads.items()}

        staged: Dict[str, torch.Tensor] = {}
        self.opt.begin_step(lr=lr)
        if self.swapper is not None:
            def step_fn(key, numel, states):
                # the swapped-in buffers are this key's state while it steps
                # (step_all writes them back to NVMe)
                for state_name, attr in self._state_attrs.items():
                    getattr(self.opt, attr)[key] = states[state_name][:numel]
                dst = None if out is None else out[key]
                self.opt.step(key, states["master"][:numel], grads[key], param_out_bf16=dst)
                staged[key] = dst if dst is not None else states["master"][:numel].clone()
            self.swapper.step_all(step_fn)
            # the buffers return to the swapper's pool: keeping views would
            # alias other keys' data
            for attr in set(self._state_attrs.values()):
                getattr(self.opt, attr).clear()
        else:
            for key in self._order:
                dst = None if out is None else out[key]
                self.opt.step(key, self._masters[key], grads[key], param_out_bf16=dst)
                staged[key] = dst if dst is not None else self._masters[key]
        return staged, False

    # ------------------------------------------------------------------ #
    def masters(self) -> Dict[str, torch.Tensor]:
        """Flat fp32 masters by key (live buffers in cpu mode, copies read
        back from NVMe)."""
        if self.swapper is not None:
            return {k: self.swapper.read_master(k) for k in self._order}
        return dict(self._masters)

    def layer_views(self, key: str, flat: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """``flat`` (default the key's master, cpu mode) as the port's
        tensors: one view a layer of a stacked leaf, else one view."""
        flat = self._masters[key] if flat is None else flat
        shape = self._shapes[key]
        if not stacked(key):
            return [flat.view(shape)]
        n = flat.numel() // shape[0]
        return [flat[i * n:(i + 1) * n].view(shape[1:]) for i in range(shape[0])]

    def load_masters(self, masters: Dict[str, torch.Tensor]) -> None:
        for k, v in masters.items():
            v = torch.as_tensor(v, dtype=torch.float32).reshape(-1)
            if self.swapper is not None:
                self.swapper.write_state(k, "master", v)
            else:
                self._masters[k].copy_(v)

    def state_dict(self) -> dict:
        """The JAX layout: ``step``, ``lr``, ``masters`` and each moment by
        key, flat fp32 numpy arrays (cpu mode's masters are live views)."""
        if self.swapper is not None:
            # the authoritative state is in the swap files
            sd = {"step": self.opt.step_count, "lr": self.opt.lr, "masters": {}}
            for state_name in self._state_attrs:
                sd[state_name] = {}
            for k in self._order:
                sd["masters"][k] = self.swapper.read_state(k, "master").numpy()
                for state_name in self._state_attrs:
                    sd[state_name][k] = self.swapper.read_state(k, state_name).numpy()
            return sd
        sd = self.opt.state_dict()
        sd["masters"] = {k: m.numpy() for k, m in self._masters.items()}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        sd = dict(sd)
        masters = sd.pop("masters", None)
        if self.swapper is not None:
            self.opt.step_count = int(sd.get("step", 0))
            self.opt.lr = float(sd.get("lr", self.opt.lr))
            for k in self._order:
                if masters and k in masters:
                    self.swapper.write_state(k, "master", masters[k])
                for state_name in self._state_attrs:
                    if state_name in sd and k in sd[state_name]:
                        self.swapper.write_state(k, state_name, sd[state_name][k])
            return
        self.opt.load_state_dict(sd)
        if masters:
            self.load_masters(masters)

    @property
    def order(self) -> List[str]:
        return list(self._order)
