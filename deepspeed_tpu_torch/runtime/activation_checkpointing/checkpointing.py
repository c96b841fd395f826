"""Activation checkpointing and the remat policies (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py`` and of
the JAX model's ``_remat_policy``).

A checkpointed call runs ``torch.utils.checkpoint`` (non-reentrant), which
saves the call's inputs and recomputes its body in the backward. A policy
decides which of the body's dispatcher ops keep their outputs instead, the
counterparts of the JAX package's ``jax.checkpoint`` policies:

- ``"full"``: nothing (the reference's save-only-inputs ``CheckpointFunction``);
- ``"selective"``: the outputs named ``q_proj``, ``k_proj``, ``v_proj``,
  ``wo_out`` and ``ff_down`` (:func:`checkpoint_name`), and kernel A's
  ``(o, lse)`` (the op ``dstpu::flash_fwd``, the JAX ``flash_o`` /
  ``flash_lse``, of which ``attn_out`` is a view), so the backward runs C and
  D on the saved o and lse and the recompute skips A and those products;
  the d_ff-wide up and gate products are recomputed
  (``save_only_these_names``);
- ``"dots"``: every ``mm`` / ``addmm`` output, the 2-D-weight products that
  ``x @ W`` and ``F.linear`` reach (``dots_with_no_batch_dims_saveable``:
  ``bmm`` has a batch dim, and kernel A is not a product, so it re-runs);
- ``"offload_dots"``: the same outputs copied to pinned host memory in the
  forward and handed back to the device, in call order, in place of the
  product in the recompute (``offload_dot_with_no_batch_dims``).

A saved op is not run in the recompute: its output comes from the stash.
Eager PyTorch has no dead-code elimination, so a name marks the op that
produces the named tensor (the product, before a bias add, which the
recompute repeats), not an identity after it: saving an identity's output
would still run the product it copies. ``dstpu::flash_fwd``'s outputs are
saved as they are.

``configure`` / ``checkpoint`` / ``checkpoint_wrapper`` keep the JAX module's
surface: ``cpu_checkpointing`` selects ``"offload_dots"``; the other fields
are recorded with no effect on one device. ``RNGStatesTracker`` keeps named
``torch.Generator`` streams; ``fork`` hands out a fresh generator seeded from
the named stream, the counterpart of splitting a JAX key.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_fwd

POLICIES = ("full", "selective", "dots", "offload_dots")
#: the names "selective" saves (the JAX policy's, less attn_out, which is a
#: view of kernel A's saved o)
SELECTIVE_NAMES = frozenset(("q_proj", "k_proj", "v_proj", "attn_out", "wo_out", "ff_down"))

_config: Dict[str, Any] = {
    "partition_activations": False,
    "contiguous_memory_optimization": False,
    "cpu_checkpointing": False,
    "number_checkpoints": None,
    "synchronize_checkpoint_boundary": False,
    "profile": False,
    "configured": False,
}

#: bytes the policies saved since :func:`reset_stats`: ``saved_bytes`` in all
#: (device and host), ``host_bytes`` the pinned host copies held now,
#: ``host_bytes_peak`` their most at once
stats = {"saved_bytes": 0, "host_bytes": 0, "host_bytes_peak": 0}


def reset_stats() -> None:
    for key in stats:
        stats[key] = 0


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None) -> None:
    """Reference ``configure()`` (``checkpointing.py:789``)."""
    cfg = None
    if deepspeed_config is not None:
        if hasattr(deepspeed_config, "activation_checkpointing_config"):
            cfg = deepspeed_config.activation_checkpointing_config
        elif isinstance(deepspeed_config, dict):
            from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
                DeepSpeedActivationCheckpointingConfig)
            cfg = DeepSpeedActivationCheckpointingConfig(
                **deepspeed_config.get("activation_checkpointing", {}))
    if cfg is not None:
        _config.update(
            partition_activations=cfg.partition_activations,
            contiguous_memory_optimization=cfg.contiguous_memory_optimization,
            cpu_checkpointing=cfg.cpu_checkpointing,
            number_checkpoints=cfg.number_checkpoints,
            synchronize_checkpoint_boundary=cfg.synchronize_checkpoint_boundary,
            profile=cfg.profile)
    for key, val in (("partition_activations", partition_activations),
                     ("contiguous_memory_optimization", contiguous_checkpointing),
                     ("number_checkpoints", num_checkpoints),
                     ("cpu_checkpointing", checkpoint_in_cpu),
                     ("synchronize_checkpoint_boundary", synchronize),
                     ("profile", profile)):
        if val is not None:
            _config[key] = val
    _config["configured"] = True


def is_configured() -> bool:
    return _config["configured"]


def reset() -> None:
    for key in _config:
        _config[key] = False if isinstance(_config[key], bool) else None
    _config["configured"] = False


# ------------------------------------------------------------------ #
# names and policies

_region = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the products computed inside the ``with`` body (the
    counterpart of ``jax.ad_checkpoint.checkpoint_name`` on their output):
    ``"selective"`` saves the ``mm`` / ``addmm`` outputs of a region named
    in :data:`SELECTIVE_NAMES`."""
    outer = getattr(_region, "name", None)
    _region.name = name
    try:
        yield
    finally:
        _region.name = outer


_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _saves(policy: str, func) -> bool:
    """Whether ``policy`` keeps the output of the op ``func`` called now."""
    if func in _DOTS:
        return policy != "selective" or getattr(_region, "name", None) in SELECTIVE_NAMES
    return policy == "selective" and func is flash_fwd._opoverload


class _Stash:
    """The outputs one checkpointed call saved, in call order. Under
    ``"offload_dots"`` a CUDA output is copied to pinned host memory (a
    failed pinned allocation raises: nothing stays on the device instead)
    and back, both on the compute stream. In stream order the caching
    allocator reuses the output's block as soon as the forward drops it; a
    copy on a side stream would hold the block until the host saw the copy
    end, and the host runs ahead of the device by up to the whole forward,
    so every output would stay on the device until then."""

    def __init__(self, policy: str):
        self.policy = policy
        self.saved = []
        self.taken = 0

    def put(self, out) -> None:
        if self.policy == "offload_dots" and out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            self.saved.append((host, out.device))
            stats["host_bytes"] += host.nbytes
            stats["host_bytes_peak"] = max(stats["host_bytes_peak"], stats["host_bytes"])
            stats["saved_bytes"] += host.nbytes
            return
        # detached: the op's own output object gets its autograd history
        # after this returns, and the recompute's op takes a history of its own
        outs = tuple(t.detach() for t in (out if isinstance(out, tuple) else (out,)))
        self.saved.append((outs if isinstance(out, tuple) else outs[0], None))
        stats["saved_bytes"] += sum(t.nbytes for t in outs)

    def take(self):
        if self.taken >= len(self.saved):
            # each kept output goes to the one recompute that consumes it
            # (as torch's selective checkpoint allows one backward)
            raise RuntimeError(f"remat policy {self.policy!r}: a second backward through "
                               "one checkpointed call; its kept outputs were consumed")
        out, device = self.saved[self.taken]
        self.saved[self.taken] = None
        self.taken += 1
        if device is None:
            return out
        stats["host_bytes"] -= out.nbytes
        return out.to(device, non_blocking=True)


class _SaveMode(TorchDispatchMode):
    """The forward of a checkpointed call: stash what the policy keeps."""

    def __init__(self, stash: _Stash):
        super().__init__()
        self.stash = stash

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _saves(self.stash.policy, func):
            self.stash.put(out)
        return out


class _ReplayMode(TorchDispatchMode):
    """The recompute: a kept op's output from the stash, every other op run."""

    def __init__(self, stash: _Stash):
        super().__init__()
        self.stash = stash

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _saves(self.stash.policy, func):
            return self.stash.take()
        return func(*args, **(kwargs or {}))


def _contexts(policy: str):
    stash = _Stash(policy)
    return _SaveMode(stash), _ReplayMode(stash)


def remat(policy: str, function: Callable, *args):
    """``function(*args)`` checkpointed under ``policy`` (one of
    :data:`POLICIES`)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} (expected one of {POLICIES})")
    if policy == "full":
        return _torch_checkpoint(function, *args, use_reentrant=False)
    return _torch_checkpoint(function, *args, use_reentrant=False,
                             context_fn=functools.partial(_contexts, policy))


def _policy() -> str:
    """The configured policy: host offload of the products under
    ``cpu_checkpointing``, else full remat (save nothing but the inputs)."""
    return "offload_dots" if _config["cpu_checkpointing"] else "full"


def checkpoint(function: Callable, *args):
    """Reference ``checkpoint(function, *args)`` (``CheckpointFunction``,
    ``checkpointing.py:474``): run ``function`` saving only its inputs (or
    the configured policy's outputs); recompute in backward."""
    return remat(_policy(), function, *args)


def checkpoint_wrapper(function: Callable) -> Callable:
    """Decorator form of :func:`checkpoint`, with the policy configured now."""
    policy = _policy()

    @functools.wraps(function)
    def wrapped(*args):
        return remat(policy, function, *args)
    return wrapped


# ------------------------------------------------------------------ #
# RNG tracking (reference CudaRNGStatesTracker, checkpointing.py:121)

_MODEL_PARALLEL_RNG = "model-parallel-rng"


class RNGStatesTracker:
    """Named generator streams; ``fork`` returns a fresh ``torch.Generator``
    per call within a name, deterministically (the counterpart of forked
    CUDA RNG states and of the JAX package's split keys)."""

    def __init__(self):
        self.states: Dict[str, torch.Generator] = {}

    def reset(self) -> None:
        self.states = {}

    def get_states(self) -> Dict[str, torch.Tensor]:
        """Each stream's generator state (a copy)."""
        return {name: g.get_state() for name, g in self.states.items()}

    def set_states(self, states: Dict[str, torch.Tensor]) -> None:
        self.states = {}
        for name, st in states.items():
            g = torch.Generator()
            g.set_state(st)
            self.states[name] = g

    def add(self, name: str, seed: int) -> None:
        if name in self.states:
            raise ValueError(f"rng state {name} already exists")
        self.states[name] = torch.Generator().manual_seed(seed)

    def fork(self, name: str = _MODEL_PARALLEL_RNG, device="cpu") -> torch.Generator:
        """Advance the named stream and return a fresh generator on ``device``."""
        if name not in self.states:
            raise ValueError(f"rng state {name} was never seeded")
        seed = int(torch.randint(0, 2**62, (1,), generator=self.states[name]))
        return torch.Generator(device=device).manual_seed(seed)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_seed(seed: int, tp_rank: int = 0) -> None:
    """Reference ``model_parallel_cuda_manual_seed`` (``:198``): the model-
    parallel stream is offset per TP rank so dropout differs across ranks
    while the default stream stays identical."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG, seed + 2718 + tp_rank)
