"""Engine-level checkpoint save / load (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/engine.py``), in the JAX package's
format, so a tag written by either package loads into the other.

A tag is the crash-safe two-phase format of :mod:`.safe_engine`: one
``state.npz`` of flat dotted-key host arrays plus ``meta.json``, committed
atomically under a per-file blake2b ``manifest.json``. The state tree has the
JAX engine's layout: the per-layer leaves stacked into ``[n_layer, ...]``
leaves under ``params``, ``master`` and ``acc_grads``; the loss scaler and
the counters as 0-d arrays of the JAX dtypes; the optimizer state as
``opt_state_flat.leaf_<i>`` in the JAX engine's flatten order for the same
config (``runtime/optimizers.jax_state_layout``), with ``meta.json``'s
``opt_state_labels`` naming each leaf as the JAX engine does.

The port updates its tensors in place, so the device -> host snapshot is
finished before ``save_checkpoint`` returns, in sync and async modes alike:
each stacked leaf is one preallocated host tensor that every layer's slice is
copied into. Only the persist step runs on the async writer's thread. Loads
are all-or-nothing: every byte is verified and decoded in host memory, each
leaf's shape checked against the engine's own, before any tensor is touched;
then the decoded arrays are copied into the engine's tensors slice by slice
(no second device copy). An auto-resolved tag that fails walks back to the
newest intact one.

A client optimizer's ``state_dict()`` tensors flatten into
``opt_state_flat.leaf_<i>`` in its param order, state keys sorted within a
param; ``meta.json`` records ``optimizer: "client"``, one
``opt_state_labels`` entry a leaf (``path`` ``client.state[<param>].<key>``,
``param`` the port leaf) and the groups' JSON-able hyperparameters, and a
load hands the tensors back through the optimizer's ``load_state_dict``. A
tag whose optimizer state does not match the engine's (an engine-built tag
into a client engine, a client tag into an engine-built one, another
client optimizer's) raises as a missing state leaf, the JAX loader's
structure mismatch; with ``load_optimizer_states=False`` the rest loads.

An engine under ZeRO-Offload writes its host optimizer's state beside
``state.npz`` as ``offload_state_p0.npz`` (``masters|<JAX leaf key>``,
``exp_avg|...``, ``exp_avg_sq|...``, ``step``, ``lr``: the JAX engine's
file) and no ``opt_state_flat`` leaves, and reads it back when it loads the
optimizer states.

The dropout stream is a torch generator, not a threefry key: a tag carries
its state as ``__torch_rng_state__`` beside the ``__rng_key_data__`` the JAX
loader reads (``key(DS_SEED)``'s data, which the JAX engine starts from). A
tag the JAX package wrote has no torch state: the port then keeps its own
stream and warns once.
"""

from __future__ import annotations

import copy
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.checkpoint_engine import safe_engine
from deepspeed_tpu_torch.runtime.checkpoint_engine.safe_engine import (
    MANIFEST, META_FILE, STATE_FILE, CheckpointCorruptError, CheckpointPayload,
    CheckpointWriteError)
from deepspeed_tpu_torch.runtime.optimizers import jax_state_layout
from deepspeed_tpu_torch.runtime.utils import jax_leaves, keystr
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.not_ported import not_ported
from deepspeed_tpu_torch.utils.pytree import leaf_paths

RNG_KEY = "__rng_key_data__"
TORCH_RNG_KEY = "__torch_rng_state__"


def _tag_dir(save_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(save_dir), str(tag))


# --------------------------------------------------------------------- #
# the state tree: JAX leaves over the engine's own tensors

class _Leaf:
    """One JAX leaf held as the engine's tensors: one tensor, or the
    per-layer tensors of a stacked ``[n_layer, ...]`` leaf."""

    def __init__(self, tensors: List[torch.Tensor], stacked: bool):
        self.tensors = tensors
        self.stacked = stacked
        self.shape = ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)
        self.dtype = tensors[0].dtype

    def snapshot(self) -> torch.Tensor:
        """A host copy: one preallocated tensor, each layer copied in."""
        host = torch.empty(self.shape, dtype=self.dtype)
        with torch.no_grad():
            if self.stacked:
                for i, t in enumerate(self.tensors):
                    host[i].copy_(t)
            else:
                host.copy_(self.tensors[0])
        return host

    def restore(self, a) -> None:
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        with torch.no_grad():
            if self.stacked:
                for i, t in enumerate(self.tensors):
                    t.copy_(src[i])
            else:
                self.tensors[0].copy_(src)


class _Scalar:
    """A 0-d leaf the engine keeps as a Python number."""

    shape = ()

    def __init__(self, get: Callable[[], Any], put: Callable[[Any], None], dtype):
        self.get, self.put, self.dtype = get, put, np.dtype(dtype)

    def snapshot(self) -> np.ndarray:
        return np.asarray(self.get(), self.dtype)

    def restore(self, a) -> None:
        self.put(np.asarray(a).item())


class _ZeroLeaf:
    """One JAX leaf of a ZeRO-partitioned engine's state
    (``runtime/zero/state.py``): read by gathering each layer's unit (a
    collective: every rank reads the leaves in the same order), written by
    each rank into the part it holds. ``kind``: "params", "master", "acc" or
    ``("opt", field)``."""

    def __init__(self, zero, kind, names: List[str], stacked: bool, dtype, opt_state=None):
        self.zero, self.kind, self.names, self.stacked = zero, kind, names, stacked
        self.opt_state = opt_state
        self.shape = ((len(names),) if stacked else ()) + zero.shape(names[0])
        self.dtype = dtype

    @property
    def tensors(self) -> List[torch.Tensor]:
        return [self.zero.leaf(self.kind, n, self.opt_state) for n in self.names]

    def snapshot(self) -> torch.Tensor:
        host = torch.empty(self.shape, dtype=self.dtype)
        for i, n in enumerate(self.names):
            (host[i] if self.stacked else host).copy_(self.zero.leaf(self.kind, n, self.opt_state))
        return host

    def restore(self, a) -> None:
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        for i, n in enumerate(self.names):
            self.zero.set_leaf(self.kind, n, src[i] if self.stacked else src, self.opt_state)


def _nest(groups, named=None, make=None) -> Dict[str, Any]:
    """The JAX tree of leaves over the engine's tensors ``named`` (or of the
    leaves ``make(names, stacked)`` builds)."""
    if make is None:
        make = lambda names, stacked: _Leaf([named[n] for n in names], stacked)
    out: Dict[str, Any] = {}
    for path, names in groups.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make(names, path[0] == "layers")
    return out


def _zero_nest(engine, groups, kind, dtype, opt_state=None) -> Dict[str, Any]:
    return _nest(groups, make=lambda names, stacked: _ZeroLeaf(engine._zero, kind, names, stacked,
                                                               dtype, opt_state))


_CLIENT_PATH = re.compile(r"^client\.state\[(\d+)\]\.(.+)$")


def _client_fields(engine):
    """A client optimizer's state tensors in its param order, keys sorted
    within a param: ``(label, leaf)``."""
    opt = engine.client_optimizer
    zero = getattr(engine, "_zero", None)
    if zero is not None and zero.world > 1:
        not_ported("a client optimizer's state under ZeRO stages 1-3 over several ranks",
                   "queue 1: client optimizer state under ZeRO")
    held = [p for g in opt.param_groups for p in g["params"]]
    out = []
    for i, (p, name) in enumerate(zip(held, engine._client_names)):
        st = opt.state.get(p, {})
        for key in sorted(st):
            if isinstance(st[key], torch.Tensor):
                out.append(({"moment": None, "param": name, "path": f"client.state[{i}].{key}"},
                            _Leaf([st[key]], False)))
    return out


def _client_groups(opt) -> List[Dict[str, Any]]:
    """The optimizer's param groups' JSON-able hyperparameters."""
    ok = lambda v: isinstance(v, (int, float, str, bool, type(None))) or (
        isinstance(v, (list, tuple)) and all(isinstance(x, (int, float)) for x in v))
    return [{k: (list(v) if isinstance(v, tuple) else v) for k, v in g.items()
             if k != "params" and ok(v)} for g in opt.param_groups]


def _check_opt_state(engine, meta) -> None:
    """Raise, as the JAX loader does on a state-structure mismatch, when
    the tag's optimizer state is not the engine's kind: client against
    engine-built, or another client optimizer (its type, or a label that
    names another leaf or, once the engine's optimizer holds state,
    differs from the engine's)."""
    labels = meta.get("opt_state_labels") or []
    tag_client = meta.get("optimizer") == "client"
    opt = engine.client_optimizer
    if opt is None:
        ok = not tag_client
    else:
        names = engine._client_names
        ok = tag_client and (meta.get("client_optimizer") or {}).get("type") == type(opt).__name__
        for lab in labels if ok else ():
            m = _CLIENT_PATH.match(str(lab.get("path", "")))
            if m is None or int(m.group(1)) >= len(names) or \
                    lab.get("param") != names[int(m.group(1))]:
                ok = False
                break
        mine = _opt_state_labels(engine)
        if ok and mine and labels != mine:
            ok = False
    if not ok:
        raise KeyError(
            f"checkpoint is missing state leaf 'opt_state_flat' of the engine's "
            f"{engine._optimizer_name} optimizer (the tag holds "
            f"{meta.get('optimizer', 'an engine-built')} optimizer state, "
            f"{len(labels)} leaves)")


def _client_state(engine, meta, flat) -> Dict[int, Dict[str, torch.Tensor]]:
    """The tag's client optimizer state as ``{param index: {key: tensor}}``
    (host tensors), each param-shaped entry checked against its leaf."""
    held = [p for g in engine.client_optimizer.param_groups for p in g["params"]]
    out: Dict[int, Dict[str, torch.Tensor]] = {}
    for i, lab in enumerate(meta.get("opt_state_labels") or []):
        key = f"opt_state_flat.leaf_{i}"
        if key not in flat:
            raise KeyError(f"checkpoint is missing state leaf {key!r}")
        m = _CLIENT_PATH.match(lab["path"])
        idx, name = int(m.group(1)), m.group(2)
        a = flat[key]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        if t.dim() and tuple(t.shape) != tuple(held[idx].shape):
            raise ValueError(f"checkpoint leaf {key!r} ({lab['path']}) has shape "
                             f"{tuple(t.shape)}, the engine's is {tuple(held[idx].shape)}")
        out.setdefault(idx, {})[name] = t
    return out


def _opt_fields(engine):
    """The optimizer state's JAX leaves in flatten order: ``(label, leaf)``
    (a client optimizer's: :func:`_client_fields`)."""
    if engine.client_optimizer is not None:
        return _client_fields(engine)
    if getattr(engine, "_offload", None) is not None:
        return []           # the host optimizer's state: offload_state_p0.npz
    cfg = engine._config
    prefix, fields = jax_state_layout(cfg.optimizer_name, cfg.optimizer_params)
    opt = engine.state.opt_state
    groups = jax_leaves(engine._names)
    zero = getattr(engine, "_zero", None)
    out = []
    for field in fields:
        if field == "count":
            def put(v, opt=opt):
                opt.count = int(v)
            out.append(({"moment": None, "param": "", "path": prefix + ".count"},
                        _Scalar(lambda: opt.count, put, np.int32)))
            continue
        named = getattr(opt, field)
        moment = field if field in ("mu", "nu") else None
        for path, names in groups.items():
            stacked = path[0] == "layers"
            leaf = _ZeroLeaf(zero, ("opt", field), names, stacked, torch.float32, opt) \
                if zero is not None else _Leaf([named[n] for n in names], stacked)
            out.append(({"moment": moment, "param": ".".join(path) if moment else "",
                         "path": prefix + "." + field + keystr(path)}, leaf))
    return out


def _opt_state_labels(engine):
    """One label per ``opt_state_flat`` leaf (flatten order), as the JAX
    engine writes them: {"moment": "mu"|"nu"|None, "param": dotted path or
    "", "path": keystr}."""
    return [label for label, _ in _opt_fields(engine)]


def _state_tree(engine, with_opt: bool = True) -> Dict[str, Any]:
    state = engine.state
    groups = jax_leaves(engine._names)

    def scaler(field, dtype, cast):
        def put(v):
            state.scaler = state.scaler._replace(**{field: cast(v)})
        return _Scalar(lambda: getattr(state.scaler, field), put, dtype)

    def counter(field):
        return _Scalar(lambda: getattr(state, field),
                       lambda v: setattr(state, field, int(v)), np.int32)

    zero = getattr(engine, "_zero", None)
    if zero is not None:
        # the partitioned state's full leaves, gathered as they are read
        zero.clear_cache()
        params = _zero_nest(engine, groups, "params", engine.compute_dtype)
        acc = _zero_nest(engine, groups, "acc", zero.grad_acc_dtype)
    else:
        params = _nest(groups, engine._param_dict(state.params))
        # the gas-1 path keeps no buffers: an empty container vanishes
        acc = _nest(groups, state.acc_grads) if state.acc_grads is not None else {}
    tree: Dict[str, Any] = {
        "params": params,
        "acc_grads": acc,
        "scaler": {
            "loss_scale": scaler("loss_scale", np.float32, float),
            "good_steps": scaler("good_steps", np.int32, int),
            "hysteresis": scaler("hysteresis", np.int32, int),
        },
        "counters": {f: counter(f) for f in ("micro_steps", "global_steps", "skipped_steps")},
    }
    if state.master is not None:
        tree["master"] = _zero_nest(engine, groups, "master", torch.float32) \
            if zero is not None else _nest(groups, state.master)
    if with_opt:
        tree["opt_state_flat"] = {f"leaf_{i}": leaf
                                  for i, (_, leaf) in enumerate(_opt_fields(engine))}
    return tree


def _flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """dict/list/tuple tree -> {'a.b.0.c': leaf}: the shared dotted-key
    scheme (utils.pytree.leaf_paths) with sequence descent. Empty
    containers vanish (they carry no data; the load template re-supplies
    them)."""
    return leaf_paths(tree, prefix, descend_sequences=True)


def _rebuild_from_flat(template, flat: Dict[str, Any], prefix: str = ""):
    """Walk the TEMPLATE structure, pulling each leaf from ``flat`` by its
    dotted key — missing keys are a structure mismatch (KeyError)."""
    if isinstance(template, dict):
        return {k: _rebuild_from_flat(v, flat, prefix + str(k) + ".")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_rebuild_from_flat(v, flat, prefix + str(i) + ".")
               for i, v in enumerate(template)]
        return type(template)(seq) if isinstance(template, tuple) else seq
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint is missing state leaf {key!r}")
    return flat[key]


def _checkpoint_cfg(engine):
    """The training ``CheckpointConfig``, defaulted when the engine's config
    carries none."""
    from deepspeed_tpu_torch.config.core import CheckpointConfig
    ccfg = getattr(engine._config, "checkpoint_config", None)
    return ccfg if isinstance(ccfg, CheckpointConfig) else CheckpointConfig()


def _notify_ckpt_result(engine, ok: bool, steps: Optional[int]) -> None:
    """The health observatory's checkpoint hook (its ``ckpt_failure``
    detector), for an engine with ``telemetry.health`` on."""
    health = getattr(engine, "_health", None)
    if health is not None and hasattr(health, "observe_checkpoint"):
        try:
            health.observe_checkpoint(ok, step=steps)
        except Exception as e:
            logger.warning(f"health checkpoint observation failed: {e}")


# --------------------------------------------------------------------- #
# save

def _build_meta(engine, tag: str, client_state) -> Dict[str, Any]:
    """The checkpoint meta dict (the JAX engine's fields)."""
    meta = {
        "tag": tag,
        "global_steps": int(engine.global_steps),
        "micro_steps": int(engine.micro_steps),
        "skipped_steps": int(engine.skipped_steps),
        "ds_config": engine._config._param_dict,
        "lr_scheduler": engine.lr_scheduler.state_dict() if engine.lr_scheduler is not None else None,
        "client_state": client_state or {},
        "framework_version": 1,
        "data_progress": dict(getattr(engine, "_data_progress", {}) or {}),
    }
    if getattr(engine, "quantizer", None) is not None:
        # MoQ host schedule: a resumed run must continue mid-schedule
        meta["moq_state"] = engine.quantizer.state_dict()
    if engine.client_optimizer is not None:
        # an engine-built tag's meta stays the JAX engine's, key for key
        meta["optimizer"] = "client"
        meta["client_optimizer"] = {"type": type(engine.client_optimizer).__name__,
                                    "param_groups": _client_groups(engine.client_optimizer)}
    meta["opt_state_labels"] = _opt_state_labels(engine)
    return meta


OFFLOAD_FILE = "offload_state_p0.npz"
_OFFLOAD_GROUPS = ("masters", "exp_avg", "exp_avg_sq")


def _offload_arrays(sd: Dict[str, Any], copy: bool = False) -> Dict[str, Any]:
    """A host optimizer's state_dict as the JAX package's '|'-keyed npz
    arrays (``masters|layers.attn.wq``, ...). ``copy`` for async saves: cpu
    mode's masters are the live buffers the next step updates in place."""
    out: Dict[str, Any] = {"step": np.asarray(sd.get("step", 0)),
                           "lr": np.asarray(sd.get("lr", 0.0))}
    for group in _OFFLOAD_GROUPS:
        for k, v in sd.get(group, {}).items():
            out[f"{group}|{k}"] = np.array(v, copy=True) if copy else v
    return out


def _read_offload(path: str) -> Optional[Dict[str, Any]]:
    """A tag's ``offload_state_p0.npz`` as a host optimizer state_dict, or
    None when the tag has none."""
    f = os.path.join(path, OFFLOAD_FILE)
    if not os.path.exists(f):
        return None
    with np.load(f) as z:
        sd = {"step": int(z["step"]), "lr": float(z["lr"]),
              **{g: {} for g in _OFFLOAD_GROUPS}}
        for name in z.files:
            if "|" in name:
                group, key = name.split("|", 1)
                sd[group][key] = z[name]
    return sd


def _snapshot_arrays(engine, keep: bool = True) -> Dict[str, Any]:
    """Phase 1 of a save: every leaf of the state tree copied to the host
    (bf16 leaves stay torch tensors, the rest become numpy), plus the RNG
    arrays. ``keep=False``: a ZeRO rank that does not write reads every
    leaf for the gathers and keeps nothing."""
    arrays: Dict[str, Any] = {}
    for k, leaf in _flatten_tree(_state_tree(engine)).items():
        a = leaf.snapshot()
        if not keep:
            continue
        arrays[k] = a.numpy() if isinstance(a, torch.Tensor) and \
            a.dtype not in safe_engine._RAW_BITS else a
    arrays[RNG_KEY] = np.asarray([0, engine._rng_seed % 2**32], np.uint32)
    arrays[TORCH_RNG_KEY] = engine._rng.get_state().numpy()
    return arrays


def save_engine_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                           client_state=None, save_latest: bool = True,
                           asynchronous: Optional[bool] = None, write: bool = True) -> bool:
    """Save a tag. ``write=False``: a ZeRO rank other than the writer takes
    part in the snapshot's gathers and writes nothing."""
    if not write:
        _snapshot_arrays(engine, keep=False)
        return True
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    tag = str(tag)
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    ccfg = _checkpoint_cfg(engine)
    if asynchronous is None:
        asynchronous = bool(ccfg.async_save)

    # ---- phase 1: device -> host snapshot on the caller's thread, done
    # before returning: the next step overwrites the tensors in place ----
    t0 = time.perf_counter()
    steps = int(engine.global_steps)
    arrays = _snapshot_arrays(engine)
    meta = _build_meta(engine, tag, client_state)
    meta["format"] = "safe-v1"
    if asynchronous:
        # the writer thread serializes this later; live references
        # (ds_config, schedules) must not tear under concurrent mutation
        meta = copy.deepcopy(meta)
    extra = {}
    if getattr(engine, "_offload", None) is not None:
        # the host optimizer's state beside the device state, as the JAX
        # engine writes it
        extra[OFFLOAD_FILE] = _offload_arrays(engine._offload.state_dict(), copy=asynchronous)
    payload = CheckpointPayload(tag=tag, arrays=arrays, meta=meta, extra_npz=extra,
                                global_steps=steps, update_latest=save_latest)
    mets = safe_engine._ckpt_metrics()
    mets["snapshot_ms"].observe((time.perf_counter() - t0) * 1e3)
    dur = int((time.perf_counter() - t0) * 1e9)
    safe_engine._emit_ckpt_event("ckpt.snapshot", t_ns=time.monotonic_ns() - dur,
                                 dur_ns=dur, step=steps, tag=tag,
                                 asynchronous=bool(asynchronous))

    if asynchronous:
        writer = engine._checkpoint_writer()
        # runtime config changes (e.g. retention) apply to future jobs
        writer.keep_last = ccfg.keep_last
        writer.retries = ccfg.retries
        writer.retry_backoff_s = ccfg.retry_backoff_s
        writer.submit(save_dir, payload)
        log_dist(f"Queued async checkpoint {tag} for {save_dir} "
                 f"(depth {writer.queue_depth})", ranks=[0])
        return True

    # ---- phase 2 inline (synchronous save) ----
    t1 = time.perf_counter()
    try:
        total = safe_engine.write_tag(
            save_dir, payload, retries=ccfg.retries,
            retry_backoff_s=ccfg.retry_backoff_s, keep_last=ccfg.keep_last)
    except CheckpointWriteError:
        mets["failures"].inc()
        _notify_ckpt_result(engine, False, steps)
        raise
    mets["save_ms"].observe((time.perf_counter() - t1) * 1e3)
    mets["bytes"].observe(total)
    mets["saves"].inc()
    _notify_ckpt_result(engine, True, steps)
    log_dist(f"Saved checkpoint {tag} to {_tag_dir(save_dir, tag)} "
             f"({total / 1e6:.2f} MB)", ranks=[0])
    return True


# --------------------------------------------------------------------- #
# load

def _read_verified(path: str, verify: bool) -> Dict[str, Any]:
    """The tag's decoded state arrays, read while another thread hashes
    every file against the manifest (hashlib and the zip reader release
    the GIL on large buffers); nothing is returned unless the tag
    verifies, and a failed verification is the error reported."""
    state_file = os.path.join(path, STATE_FILE)
    if not verify:
        return safe_engine.read_npz(state_file)
    with ThreadPoolExecutor(max_workers=1) as pool:
        report = pool.submit(safe_engine.verify_tag, path)
        try:
            flat, read_error = safe_engine.read_npz(state_file), None
        except Exception as e:
            flat, read_error = None, e
        rep = report.result()
    if not rep.intact:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed verification: " + "; ".join(rep.errors))
    if read_error is not None:
        raise read_error
    return flat


def _prepare_tag_load(engine, path: str, verify: bool, load_optimizer_states: bool = True):
    """Stage everything a load needs in host memory — verified manifest,
    decoded state arrays rebuilt against the engine's template with each
    leaf's shape checked, parsed meta, a client optimizer's state — without
    touching the engine. Raises on any missing/corrupt piece; the caller
    decides walk-back vs abort. Without ``load_optimizer_states`` the tag's
    optimizer state is neither checked nor read."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    if (not os.path.isfile(os.path.join(path, MANIFEST))
            and os.path.isdir(os.path.join(path, "state"))):
        not_ported("legacy orbax checkpoint tags", "queue 1: checkpoint ingestion (orbax)")
    client = engine.client_optimizer is not None
    template = _state_tree(engine, with_opt=load_optimizer_states and not client)
    flat = _read_verified(path, verify)
    rng_data = flat.pop(RNG_KEY, None)
    torch_rng = flat.pop(TORCH_RNG_KEY, None)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    client_state = None
    if load_optimizer_states:
        _check_opt_state(engine, meta)
        if client:
            client_state = _client_state(engine, meta, flat)
    restored = _rebuild_from_flat(template, flat)
    leaves = _flatten_tree(template)
    for k, a in _flatten_tree(restored).items():
        if tuple(a.shape) != leaves[k].shape:
            raise ValueError(f"checkpoint leaf {k!r} has shape {tuple(a.shape)}, "
                             f"the engine's is {leaves[k].shape}")
    offload_sd = None
    if getattr(engine, "_offload", None) is not None and load_optimizer_states:
        offload_sd = _read_offload(path)
    return {"path": path, "template": template, "restored": restored, "meta": meta,
            "rng_data": rng_data, "torch_rng": torch_rng, "client_state": client_state,
            "offload_sd": offload_sd}


def _apply_prepared(engine, prepared, load_optimizer_states: bool,
                    load_module_only: bool, load_data_progress: bool) -> None:
    """The only function that mutates the engine — runs strictly after
    every read and check succeeded (all-or-nothing)."""
    leaves = _flatten_tree(prepared["template"])
    restored = _flatten_tree(prepared["restored"])
    for k, leaf in leaves.items():
        if load_module_only and not k.startswith("params."):
            continue
        if k.startswith("opt_state_flat.") and not load_optimizer_states:
            continue
        leaf.restore(restored[k])
    if getattr(engine, "_zero", None) is not None:
        engine._zero.clear_cache()

    meta = prepared["meta"]
    if prepared["offload_sd"] is not None and not load_module_only:
        engine._offload.load_state_dict(prepared["offload_sd"])
    if prepared["client_state"] is not None and not load_module_only:
        _load_client_state(engine.client_optimizer, prepared["client_state"],
                           (meta.get("client_optimizer") or {}).get("param_groups") or [])
    if engine.lr_scheduler is not None and meta.get("lr_scheduler"):
        engine.lr_scheduler.load_state_dict(meta["lr_scheduler"])
    if getattr(engine, "quantizer", None) is not None and meta.get("moq_state"):
        engine.quantizer.load_state_dict(meta["moq_state"])
    engine._moq_seen_skipped = engine.state.skipped_steps

    if prepared["torch_rng"] is not None:
        engine._rng.set_state(torch.from_numpy(np.asarray(prepared["torch_rng"], np.uint8)))
    elif prepared["rng_data"] is not None:
        logger.warning(f"checkpoint {prepared['path']} carries the JAX package's threefry "
                       "key, which cannot seed the port's dropout stream: the stream "
                       "continues from its current state")

    progress = meta.get("data_progress") or {}
    engine._data_progress = {
        "consumed_samples": int(progress.get("consumed_samples", 0)),
        "iterations": int(progress.get("iterations", 0)),
    }
    if load_data_progress and progress.get("iterations"):
        engine._fast_forward_data(int(progress["iterations"]))


def _load_client_state(opt, state, groups) -> None:
    """The tag's state and group hyperparameters into the client optimizer
    through its own ``load_state_dict`` (which places each tensor as the
    optimizer keeps it)."""
    sd = opt.state_dict()
    for g, saved in zip(sd["param_groups"], groups):
        for k, v in saved.items():
            if k in g and k != "params":
                g[k] = tuple(v) if isinstance(g[k], tuple) else v
    sd["state"] = state
    opt.load_state_dict(sd)


def load_engine_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                           load_optimizer_states: bool = True,
                           load_module_only: bool = False,
                           strict: bool = False,
                           load_data_progress: bool = False):
    """Resolve, verify, stage, then apply. Auto-resolved tags (``tag=None``)
    walk back newest-first past corrupt/partial tags to the newest intact
    one. ``strict=True`` turns the silent ``(None, {})`` for a missing
    ``latest``/directory into ``FileNotFoundError``. A checkpoint that
    EXISTS but is corrupt (with no intact fallback) always raises
    :class:`CheckpointCorruptError` — data loss is never silent."""
    load_dir = os.path.abspath(load_dir)
    try:
        # a crash mid tag-overwrite leaves the tag only as .tmp/.old
        # survivors; promote them before resolving candidates
        safe_engine.recover_interrupted(load_dir)
    except OSError:
        pass
    verify = _checkpoint_cfg(engine).verify_on_load

    explicit = tag is not None
    candidates = []
    if explicit:
        candidates = [str(tag)]
    else:
        latest = safe_engine._latest_target(load_dir)
        if latest:
            candidates.append(latest)
        for rep in safe_engine.list_tags(load_dir):
            if rep.tag not in candidates:
                candidates.append(rep.tag)
        if not candidates:
            if strict:
                raise FileNotFoundError(
                    f"no 'latest' file or checkpoint tags in {load_dir}")
            logger.warning(f"No checkpoint found at {load_dir}; "
                           f"cannot auto-resolve tag")
            return None, {}

    errors = []
    for cand in candidates:
        path = _tag_dir(load_dir, cand)
        try:
            prepared = _prepare_tag_load(engine, path, verify=verify,
                                         load_optimizer_states=load_optimizer_states)
        except FileNotFoundError as e:
            errors.append(f"{cand}: {e}")
            if explicit:
                if strict:
                    raise
                logger.warning(str(e))
                return None, {}
            continue
        except Exception as e:
            errors.append(f"{cand}: {e}")
            if explicit:
                raise CheckpointCorruptError(
                    f"checkpoint tag {cand} is unusable: {e}") from e
            logger.warning(f"checkpoint {cand} unusable ({e}); "
                           f"walking back to an older tag")
            continue
        _apply_prepared(engine, prepared, load_optimizer_states,
                        load_module_only, load_data_progress)
        if cand != candidates[0]:
            logger.warning(
                f"resumed from {cand} after skipping "
                f"{candidates.index(cand)} corrupt/partial newer tag(s)")
        log_dist(f"Loaded checkpoint {cand} from {path} "
                 f"(step {engine.global_steps})", ranks=[0])
        return path, prepared["meta"].get("client_state", {})

    raise CheckpointCorruptError(
        f"no intact checkpoint in {load_dir}: " + "; ".join(errors))
