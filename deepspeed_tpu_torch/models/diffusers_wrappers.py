"""Diffusers model wrappers (UNet / VAE) on CUDA graphs (counterpart of
``deepspeed_tpu/models/diffusers_wrappers.py``; reference
``deepspeed/model_implementations/diffusers/unet.py`` and ``vae.py``).

The JAX package jits the wrapped function: one compiled program per input
shape, replayed by the denoising loop. The port does what the reference
does on a GPU: one ``torch.cuda.CUDAGraph`` per input signature, so each
call of the loop replays a fixed graph instead of launching every kernel
from Python. ``DSVAE`` keeps separate encode and decode graphs.

- **The signature** is the shape, dtype and device of every tensor
  argument, the value of every other argument, and the ``data_ptr`` of
  every parameter leaf: a graph reads its params in place, so a new params
  tree is captured again, never replayed against the old one, and the
  graphs of the old tree are dropped.
- **Python numbers.** ``jax.jit`` traces a Python int or float argument
  (a denoising loop's timestep) as an abstract value and compiles once.
  On the graph path the port turns each such argument (not a bool) into a
  0-dim tensor on the call's device (int64 or float32), copied into a
  static buffer like any tensor, so a loop over timesteps replays one
  graph.
- **Capture.** The inputs are copied into static buffers, the function
  runs once on a side stream (kernels build and libraries load outside
  the capture), then once under capture; every call replays the graph
  after copying its inputs into the static buffers.
- **The result.** By default a copy that later calls do not overwrite.
  ``donate_latents=True`` writes it into the caller's ``latents`` and
  returns that tensor, in place of XLA's buffer donation: the caller must
  not read the old latents after the call.
- **CPU tensors** run the function eagerly (there is no graph there).

Nothing falls back: mixed devices raise, and a failed capture raises. The
wrapped function must not read the device from the host (``.item()``,
``bool(tensor)``): a capture cannot hold such a read. The kernel wrappers'
launch counters tick when a graph is captured, not when it replays;
``replays`` counts the replays of each wrapper.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deepspeed_tpu_torch.utils.pytree import tree_leaves

__all__ = ["DSUNet", "DSVAE"]


def _tensor_key(t: torch.Tensor):
    return (tuple(t.shape), t.dtype, t.device, t.stride())


def signature(params, args: Tuple, kwargs: Dict[str, Any]):
    """The key of a call: every params leaf's shape, dtype, device and
    ``data_ptr``; every tensor argument's shape, dtype, device and strides;
    the value of every other argument."""
    p = tuple((_tensor_key(t), t.data_ptr()) if isinstance(t, torch.Tensor) else ("value", t)
              for t in tree_leaves(params))
    a = tuple(_tensor_key(t) if isinstance(t, torch.Tensor) else ("value", repr(t))
              for t in tree_leaves([args, [kwargs[k] for k in sorted(kwargs)]]))
    return p, tuple(sorted(kwargs)), a


def call_device(params, args: Tuple, kwargs: Dict[str, Any]) -> Optional[torch.device]:
    """The one device of the call's tensors (None without any); raises when
    they lie on more than one."""
    devices = {t.device for t in tree_leaves([params, args, kwargs])
               if isinstance(t, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"diffusers wrapper: tensors on more than one device: "
                         f"{sorted(map(str, devices))}")
    return next(iter(devices), None)


def uses_graph(device: Optional[torch.device]) -> bool:
    """Whether a call on ``device`` runs through a CUDA graph (CUDA tensors)
    or eagerly (CPU tensors, the caller's choice)."""
    return device is not None and device.type == "cuda"


def _numbers_as_tensors(x, device):
    """``x`` with every Python int or float (not a bool) in it a 0-dim
    tensor on ``device``."""
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return torch.tensor(x, device=device)
    if isinstance(x, dict):
        return {k: _numbers_as_tensors(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numbers_as_tensors(v, device) for v in x)
    return x


def _static(x):
    """A static buffer holding ``x`` (a tensor argument), else ``x``."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _static(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_static(v) for v in x)
    return x


def _copy_into(static, x):
    if isinstance(static, torch.Tensor):
        static.copy_(x)
    elif isinstance(static, dict):
        for k in static:
            _copy_into(static[k], x[k])
    elif isinstance(static, (list, tuple)):
        for s, v in zip(static, x):
            _copy_into(s, v)


def capture_graph(run: Callable[[], Any]):
    """Capture ``run`` (a call of the wrapped function on its static
    buffers) in a CUDA graph: one warm-up call on a side stream, then the
    capture. Returns ``(replay, static_out)``; raises if the capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            static_out = run()
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture failed: {e}") from e
    return graph.replay, static_out


class _GraphCache:
    """One captured graph per call signature of ``fn(params, *args, **kw)``."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graphs: Dict[Any, Tuple[Callable, Any, Tuple, Dict]] = {}
        self.params_key = None        # the params part of every key in ``graphs``
        self.captures = 0
        self.replays = 0

    def run(self, params, args: Tuple, kwargs: Dict[str, Any]):
        """The static output of a replay (a graph's own buffer), or the
        eager result for CPU tensors; the second value says which."""
        with torch.no_grad():
            device = call_device(params, args, kwargs)
            if not uses_graph(device):
                return self.fn(params, *args, **kwargs), False
            args, kwargs = _numbers_as_tensors((args, kwargs), device)
            key = signature(params, args, kwargs)
            if key[0] != self.params_key:      # a new params tree: the old graphs read freed leaves
                self.graphs.clear()
                self.params_key = key[0]
            entry = self.graphs.get(key)
            if entry is None:
                s_args, s_kw = _static(args), _static(kwargs)
                replay, out = capture_graph(lambda: self.fn(params, *s_args, **s_kw))
                entry = self.graphs[key] = (replay, out, s_args, s_kw)
                self.captures += 1
            replay, out, s_args, s_kw = entry
            _copy_into(s_args, args)
            _copy_into(s_kw, kwargs)
            replay()
            self.replays += 1
            return out, True


def _result(out, graphed: bool, into: Optional[torch.Tensor] = None):
    if not graphed:
        return out
    if into is not None:
        if not isinstance(out, torch.Tensor) or out.shape != into.shape \
                or out.dtype != into.dtype:
            raise ValueError("donate_latents needs an output of the latents' shape and dtype")
        return into.copy_(out)
    return _static(out)


class DSUNet:
    """Wrap a functional UNet ``apply(params, latents, timestep, context)``.

    ``donate_latents=True`` writes the output into ``latents`` (the
    reference's static-graph-buffer effect, ``diffusers/unet.py``
    ``_graph_replay``): only safe when the caller does NOT read latents
    after the call (``latents = unet(...)`` style loops). The standard
    ``noise_pred = unet(...); scheduler.step(noise_pred, t, latents)`` loop
    reads latents again, so donation is OFF by default.
    """

    def __init__(self, apply_fn: Callable, donate_latents: bool = False):
        self.apply_fn = apply_fn
        self.donate_latents = donate_latents
        self._graphs = _GraphCache(apply_fn)

    @property
    def replays(self) -> int:
        return self._graphs.replays

    @property
    def captures(self) -> int:
        return self._graphs.captures

    def __call__(self, params, latents, timestep, context=None, **kw):
        out, graphed = self._graphs.run(params, (latents, timestep, context), kw)
        return _result(out, graphed, latents if self.donate_latents else None)


class DSVAE:
    """Wrap a functional VAE with separate encode and decode graphs (the
    reference captures two graphs, ``vae.py``)."""

    def __init__(self, encode_fn: Callable = None, decode_fn: Callable = None):
        self._encode = _GraphCache(encode_fn) if encode_fn else None
        self._decode = _GraphCache(decode_fn) if decode_fn else None

    @property
    def replays(self) -> int:
        return sum(g.replays for g in (self._encode, self._decode) if g is not None)

    def encode(self, params, images, *a, **kw):
        if self._encode is None:
            raise ValueError("no encode_fn configured")
        return _result(*self._encode.run(params, (images,) + a, kw))

    def decode(self, params, latents, *a, **kw):
        if self._decode is None:
            raise ValueError("no decode_fn configured")
        return _result(*self._decode.run(params, (latents,) + a, kw))
