"""Crash-safe two-phase checkpoint storage (the port's copy of
``deepspeed_tpu/runtime/checkpoint_engine/safe_engine.py``; the files it
writes are the JAX package's, byte for byte in layout).

CheckFreq-style decoupling (Mohan et al., FAST '21): the *snapshot* (device →
host copy) happens on the training thread and is cheap; the *persist*
(serialize + fsync + atomic publish) runs here — inline for synchronous
saves, or on :class:`AsyncCheckpointWriter`'s background thread with a
bounded queue for stall-free training.

Durability contract, in commit order:

1. Everything for a tag is written into ``<save_dir>/.tmp.<tag>``; each file
   is fsynced as it closes.
2. ``manifest.json`` — per-file blake2b + byte size, computed by **re-reading
   the persisted bytes** (the manifest attests to what is actually on disk,
   not what we meant to write) — is written last inside the temp dir.
3. The temp dir is fsynced and atomically renamed to ``<save_dir>/<tag>``;
   the parent dir is fsynced. A tag directory therefore either exists with a
   complete manifest or does not exist at all.
4. Only then is ``latest`` updated, itself via tmp + fsync + rename.
5. Retention GC (``keep_last``) runs last and never deletes the newest
   *verified* tag nor the tag ``latest`` points to.

A crash at any byte leaves either the previous consistent state (steps 1-3
incomplete: only ``.tmp.*`` debris, swept on the next save) or the new one.
Transient I/O errors (ENOSPC/EIO from flaky or full storage) are retried
with exponential backoff from a clean temp dir; a fault that outlives the
retry budget surfaces as :class:`CheckpointWriteError` — never as a
half-published tag.

All file writes flow through ``utils.fault_injection.guarded_write`` so the
fault-injection harness can deterministically kill, fail, or delay any byte.

Arrays are numpy or torch tensors. bf16 has no numpy dtype here (no
``ml_dtypes``): a bf16 tensor is written as its raw ``uint16`` bits under
``key::dt=bfloat16``, as the JAX package writes an ``ml_dtypes.bfloat16``
array, and such a key decodes back to a torch bf16 tensor.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import signal as _signal
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.utils.fault_injection import SimulatedCrash
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.not_ported import not_ported

MANIFEST = "manifest.json"
STATE_FILE = "state.npz"
META_FILE = "meta.json"
MANIFEST_FORMAT = 1
_DTYPE_TAG = "::dt="
_HASH_CHUNK = 1 << 20


def _emit_ckpt_event(kind: str, **data) -> None:
    """Flight-recorder hook for the checkpoint phases (snapshot is emitted
    by the engine-side save path; serialize/commit/retry here). Disabled
    recorder = one flag check; diagnostics never fail a save."""
    try:
        from deepspeed_tpu_torch.monitor.events import get_flight_recorder
        get_flight_recorder().emit(kind, **data)
    except Exception:
        pass


class CheckpointWriteError(RuntimeError):
    """A checkpoint save failed after exhausting its retry budget. The
    previous committed checkpoints are untouched."""


class CheckpointCorruptError(RuntimeError):
    """A checkpoint tag failed manifest verification (and walk-back was
    disallowed or found no intact tag)."""


# --------------------------------------------------------------------- #
# low-level durable I/O

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_bytes_durable(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        fault_injection.guarded_write(f, data, path)
        f.flush()
        os.fsync(f.fileno())


def atomic_write_text(path: str, text: str) -> None:
    """tmp + fsync + rename + dir fsync: readers see the old content or the
    new, never a torn write."""
    tmp = path + ".tmp"
    _write_bytes_durable(tmp, text.encode())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


class _InjectedFile:
    """File wrapper routing writes through the fault-injection harness;
    everything else (tell/seek/flush — zipfile needs them) delegates."""

    def __init__(self, f, path: str):
        self._f = f
        self._path = path

    def write(self, data) -> int:
        fault_injection.guarded_write(self._f, data, self._path)
        return len(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


# --------------------------------------------------------------------- #
# array (de)serialization — flat {dotted key: ndarray} <-> one npz

def _descr_roundtrips(dt: np.dtype) -> bool:
    import warnings
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.lib.format.descr_to_dtype(
                np.lib.format.dtype_to_descr(dt)) == dt
    except Exception:
        return False


# the torch dtype numpy lacks, by the ml_dtypes name the JAX package writes
_RAW_BITS = {torch.bfloat16: "bfloat16"}


def _raw_bits(t: torch.Tensor) -> np.ndarray:
    """A host bf16 tensor as its raw uint16 bits."""
    return t.view(torch.int16).numpy().view(np.uint16)


def encode_arrays(flat: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """npz cannot represent non-native dtypes (bf16, fp8): store their raw
    bits as unsigned ints under ``key::dt=<name>``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype in _RAW_BITS:
                out[k + _DTYPE_TAG + _RAW_BITS[v.dtype]] = _raw_bits(v)
                continue
            v = v.numpy()
        a = np.asarray(v)
        if _descr_roundtrips(a.dtype):
            out[k] = a
        else:
            out[k + _DTYPE_TAG + a.dtype.name] = a.view(
                np.dtype(f"u{a.dtype.itemsize}"))
    return out


def _decode(bits: np.ndarray, name: str):
    """Raw bits under ``::dt=<name>``: a torch bf16 tensor for bfloat16, a
    numpy array where numpy knows the name."""
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)
    return bits.view(np.dtype(name))


def decode_arrays(npz) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in npz.files:
        if _DTYPE_TAG in k:
            base, name = k.split(_DTYPE_TAG, 1)
            out[base] = _decode(npz[k], name)
        else:
            out[k] = npz[k]
    return out


def write_npz(path: str, flat: Dict[str, Any]) -> None:
    """np.savez-compatible container written through the injected file (so
    every byte is fault-injectable), with the zip close guarded: an injected
    crash/fault mid-stream must propagate, not the ZipFile destructor's
    complaint about the abandoned handle."""
    import zipfile

    from numpy.lib import format as npformat

    encoded = encode_arrays(flat)
    with open(path, "wb") as raw:
        zf = zipfile.ZipFile(_InjectedFile(raw, path), mode="w",
                             compression=zipfile.ZIP_STORED, allowZip64=True)
        try:
            for k, a in encoded.items():
                with zf.open(k + ".npy", "w", force_zip64=True) as member:
                    npformat.write_array(member, np.asarray(a),
                                         allow_pickle=False)
        finally:
            try:
                zf.close()
            except BaseException:
                # mid-fault: the stream is already broken — the original
                # exception (OSError / SimulatedCrash) is what matters
                if not fault_injection.active():
                    raise
        raw.flush()
        os.fsync(raw.fileno())


def read_npz(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return decode_arrays(z)


def _blake2b_file(path: str) -> Tuple[str, int]:
    h = hashlib.blake2b(digest_size=16)
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


# --------------------------------------------------------------------- #
# tag payload + write

@dataclasses.dataclass
class CheckpointPayload:
    """Everything one committed tag persists. ``arrays`` are HOST numpy
    (phase 1 already happened); ``extra_npz`` maps extra file names (e.g.
    ``offload_state_p0.npz``) to their own flat array dicts."""
    tag: str
    arrays: Dict[str, Any]
    meta: Dict[str, Any]
    extra_npz: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    global_steps: Optional[int] = None
    update_latest: bool = True


def _tmp_dir(save_dir: str, tag: str) -> str:
    return os.path.join(save_dir, f".tmp.{tag}")


# tags currently being written in THIS process (writer thread or inline
# save): retention sweep and crash recovery must not touch their temp/aside
# dirs — e.g. a synchronous emergency save racing a still-draining async job
_IN_FLIGHT_LOCK = threading.Lock()
_IN_FLIGHT: Dict[str, int] = {}


def _mark_in_flight(save_dir: str, tag: str, delta: int) -> None:
    key = os.path.join(os.path.abspath(save_dir), tag)
    with _IN_FLIGHT_LOCK:
        n = _IN_FLIGHT.get(key, 0) + delta
        if n > 0:
            _IN_FLIGHT[key] = n
        else:
            _IN_FLIGHT.pop(key, None)


def _tag_in_flight(save_dir: str, tag: str) -> bool:
    key = os.path.join(os.path.abspath(save_dir), tag)
    with _IN_FLIGHT_LOCK:
        return key in _IN_FLIGHT


def _is_tag_dir(save_dir: str, name: str) -> bool:
    if name.startswith(".") or name.endswith(".old"):
        return False
    p = os.path.join(save_dir, name)
    if not os.path.isdir(p):
        return False
    return (os.path.isfile(os.path.join(p, MANIFEST))
            or os.path.isdir(os.path.join(p, "state"))     # legacy orbax
            or os.path.isfile(os.path.join(p, META_FILE)))


def _write_tag_once(save_dir: str, payload: CheckpointPayload) -> int:
    """One attempt at steps 1-3 of the durability contract. Returns the
    committed byte total. Raises OSError on I/O faults (retryable) and lets
    SimulatedCrash propagate untouched."""
    tag_dir = os.path.join(save_dir, payload.tag)
    tmp = _tmp_dir(save_dir, payload.tag)
    if os.path.isdir(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    t_ser = time.monotonic_ns()
    write_npz(os.path.join(tmp, STATE_FILE), payload.arrays)
    for name, flat in payload.extra_npz.items():
        write_npz(os.path.join(tmp, name), flat)
    _write_bytes_durable(
        os.path.join(tmp, META_FILE),
        json.dumps(payload.meta, indent=2, default=str).encode())

    files: Dict[str, Dict[str, Any]] = {}
    total = 0
    for name in sorted(os.listdir(tmp)):
        digest, size = _blake2b_file(os.path.join(tmp, name))
        files[name] = {"blake2b": digest, "bytes": size}
        total += size
    manifest = {"format": MANIFEST_FORMAT, "tag": payload.tag,
                "global_steps": payload.global_steps,
                "created_unix": time.time(), "files": files}
    _write_bytes_durable(os.path.join(tmp, MANIFEST),
                         json.dumps(manifest, indent=2).encode())
    _fsync_dir(tmp)
    t_commit = time.monotonic_ns()
    _emit_ckpt_event("ckpt.serialize", t_ns=t_ser, dur_ns=t_commit - t_ser,
                     step=payload.global_steps, tag=payload.tag, bytes=total)

    if os.path.isdir(tag_dir):
        # overwriting an existing tag: park it aside so there is never a
        # moment with a half-published dir under the tag name
        aside = tag_dir + ".old"
        if os.path.isdir(aside):
            shutil.rmtree(aside, ignore_errors=True)
        os.replace(tag_dir, aside)
        os.replace(tmp, tag_dir)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.replace(tmp, tag_dir)
    _fsync_dir(save_dir)
    _emit_ckpt_event("ckpt.commit", t_ns=t_commit,
                     dur_ns=time.monotonic_ns() - t_commit,
                     step=payload.global_steps, tag=payload.tag, bytes=total)
    return total


def _retry_os(fn, what: str, retries: int, retry_backoff_s: float):
    """Run ``fn``, retrying OSErrors with exponential backoff; budget
    exhaustion surfaces as :class:`CheckpointWriteError` so callers'
    failure accounting (metrics, health detector) always sees it."""
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            attempt += 1
            if attempt > max(retries, 0):
                raise CheckpointWriteError(
                    f"{what} failed after {attempt} attempt(s): {e}") from e
            _emit_ckpt_event("ckpt.retry", what=what, attempt=attempt,
                             error=str(e))
            delay = retry_backoff_s * (2 ** (attempt - 1))
            logger.warning(
                f"{what}: transient error ({e}); "
                f"retry {attempt}/{retries} in {delay:.2g}s")
            if delay > 0:
                time.sleep(delay)


def write_tag(save_dir: str, payload: CheckpointPayload, *,
              retries: int = 3, retry_backoff_s: float = 0.5,
              keep_last: int = 0) -> int:
    """The full commit sequence with retry-with-backoff around the write
    attempt. Returns committed bytes; raises :class:`CheckpointWriteError`
    when the fault outlives the budget. ``latest`` moves only after the tag
    is durably committed."""
    save_dir = os.path.abspath(save_dir)
    os.makedirs(save_dir, exist_ok=True)
    _mark_in_flight(save_dir, payload.tag, +1)
    try:
        try:
            total = _retry_os(lambda: _write_tag_once(save_dir, payload),
                              f"checkpoint {payload.tag}: save",
                              retries, retry_backoff_s)
        except CheckpointWriteError:
            shutil.rmtree(_tmp_dir(save_dir, payload.tag), ignore_errors=True)
            raise
    finally:
        _mark_in_flight(save_dir, payload.tag, -1)
    if payload.update_latest:
        # a straggling async job must not move `latest` BACKWARD past a tag
        # a later save already committed (e.g. a sync emergency save that
        # gave up draining the writer) — the pointer only ever advances
        cur = _latest_target(save_dir)
        cur_steps = None
        if cur and cur != payload.tag:
            cur_dir = os.path.join(save_dir, cur)
            if os.path.isdir(cur_dir):
                cur_steps = _tag_steps_hint(cur_dir, cur)
        if (payload.global_steps is not None and cur_steps is not None
                and cur_steps > payload.global_steps):
            logger.warning(
                f"checkpoint {payload.tag} (step {payload.global_steps}) "
                f"committed, but latest already points at newer {cur} "
                f"(step {cur_steps}); pointer not moved backward")
        else:
            # the pointer write shares the retry budget: the tag is already
            # durable here, and a transient fault on `latest` must not escape
            # as a raw OSError that bypasses failure accounting
            _retry_os(lambda: atomic_write_text(
                          os.path.join(save_dir, "latest"), payload.tag),
                      f"checkpoint {payload.tag}: latest pointer",
                      retries, retry_backoff_s)
    if keep_last > 0:
        try:
            # the tag just committed is verified by construction (manifest
            # hashed from re-read bytes) — no need to re-hash it for GC
            gc_tags(save_dir, keep_last, assume_intact=(payload.tag,))
        except Exception as e:   # GC must never fail a committed save
            logger.warning(f"checkpoint retention GC failed: {e}")
    return total


def unflatten_dotted(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a.b.c': leaf} -> nested dicts: the inverse of the save-side
    flattening for dict-only trees (integer segments stay string keys; the
    offline tools walk dict sections only)."""
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def read_state_tree(tag_dir: str) -> Dict[str, Any]:
    """The offline tools' reader of ONE tag's state tree: a ``state.npz``
    written by either package, rebuilt to nested dicts (bf16 leaves as
    torch bf16 tensors, the rest numpy). A legacy orbax ``state/`` tag is
    refused."""
    npz_path = os.path.join(tag_dir, STATE_FILE)
    if os.path.isfile(npz_path):
        flat = read_npz(npz_path)
        flat.pop("__rng_key_data__", None)
        flat.pop("__torch_rng_state__", None)
        return unflatten_dotted(flat)
    if os.path.isdir(os.path.join(tag_dir, "state")):
        not_ported("legacy orbax checkpoint tags", "queue 1: checkpoint ingestion (orbax)")
    raise FileNotFoundError(
        f"no checkpoint state ({STATE_FILE} or state/) under {tag_dir}")


# --------------------------------------------------------------------- #
# verification / discovery / retention

@dataclasses.dataclass
class TagReport:
    tag: str
    path: str
    intact: bool
    legacy: bool = False
    global_steps: Optional[int] = None
    errors: List[str] = dataclasses.field(default_factory=list)


def _tag_steps_hint(path: str, tag: str) -> Optional[int]:
    """Cheap ordering key: manifest (no hashing) > meta.json > trailing int
    in the tag name."""
    for name in (MANIFEST, META_FILE):
        p = os.path.join(path, name)
        if os.path.isfile(p):
            try:
                with open(p) as f:
                    steps = json.load(f).get("global_steps")
                if steps is not None:
                    return int(steps)
            except (ValueError, OSError):
                pass
    digits = ""
    for ch in reversed(tag):
        if ch.isdigit():
            digits = ch + digits
        elif digits:
            break
    return int(digits) if digits else None


def verify_tag(path: str) -> TagReport:
    """Full integrity check of one tag directory: manifest present and
    parseable, every listed file present with matching size and blake2b.
    Legacy (orbax-format) tags have no manifest and report
    ``legacy=True, intact=True`` — loadable but unverifiable."""
    tag = os.path.basename(path.rstrip(os.sep))
    rep = TagReport(tag=tag, path=path, intact=False)
    if not os.path.isdir(path):
        rep.errors.append("missing directory")
        return rep
    man_path = os.path.join(path, MANIFEST)
    if not os.path.isfile(man_path):
        if os.path.isdir(os.path.join(path, "state")):
            rep.legacy = True
            rep.intact = True
            rep.global_steps = _tag_steps_hint(path, tag)
            rep.errors.append("legacy orbax tag: no manifest to verify")
            return rep
        rep.errors.append(f"missing {MANIFEST}")
        return rep
    try:
        with open(man_path) as f:
            man = json.load(f)
        files = man["files"]
    except (ValueError, KeyError, OSError) as e:
        rep.errors.append(f"{MANIFEST} unreadable: {e}")
        return rep
    rep.global_steps = man.get("global_steps")
    for name, info in files.items():
        fpath = os.path.join(path, name)
        if not os.path.isfile(fpath):
            rep.errors.append(f"{name}: missing")
            continue
        digest, size = _blake2b_file(fpath)
        if size != info.get("bytes"):
            rep.errors.append(
                f"{name}: size {size} != manifest {info.get('bytes')}")
        elif digest != info.get("blake2b"):
            rep.errors.append(f"{name}: blake2b mismatch")
    # meta must also parse — a valid hash of an unparseable meta cannot
    # happen via corruption, but guard the contract anyway
    meta_p = os.path.join(path, META_FILE)
    if META_FILE in files and not rep.errors:
        try:
            with open(meta_p) as f:
                json.load(f)
        except (ValueError, OSError) as e:
            rep.errors.append(f"{META_FILE}: unparseable: {e}")
    rep.intact = not rep.errors
    return rep


def list_tags(save_dir: str) -> List[TagReport]:
    """Shallow reports (no hashing) for every tag dir, newest first by
    global-steps hint (mtime breaks ties)."""
    save_dir = os.path.abspath(save_dir)
    if not os.path.isdir(save_dir):
        return []
    reps = []
    for name in os.listdir(save_dir):
        if not _is_tag_dir(save_dir, name):
            continue
        path = os.path.join(save_dir, name)
        reps.append(TagReport(
            tag=name, path=path, intact=True,
            legacy=not os.path.isfile(os.path.join(path, MANIFEST)),
            global_steps=_tag_steps_hint(path, name)))
    def _key(r: TagReport):
        steps = r.global_steps if r.global_steps is not None else -1
        try:
            mtime = os.path.getmtime(r.path)
        except OSError:
            mtime = 0.0
        return (steps, mtime)
    reps.sort(key=_key, reverse=True)
    return reps


def newest_intact_tag(save_dir: str,
                      exclude: Sequence[str] = (),
                      assume_intact: Sequence[str] = ()) -> Optional[TagReport]:
    """Walk tags newest-first, full-verifying each, and return the first
    intact one (legacy tags count as intact-by-assumption). Tags named in
    ``assume_intact`` skip the hashing pass — used for a tag whose manifest
    was just computed from re-read persisted bytes, i.e. verified by
    construction."""
    for rep in list_tags(save_dir):
        if rep.tag in exclude:
            continue
        if rep.tag in assume_intact:
            return rep
        full = verify_tag(rep.path)
        if full.intact:
            return full
    return None


def recover_interrupted(save_dir: str) -> List[str]:
    """Heal the overwrite crash window: replacing an existing tag parks the
    old copy at ``<tag>.old`` before renaming the fully-written
    ``.tmp.<tag>`` into place, so there is an instant where the tag name
    does not exist. A crash there leaves both survivors — which the debris
    sweep would otherwise delete. Promote the complete temp copy (it must
    verify against its own manifest), else restore the parked old copy.
    Returns recovered tag names."""
    save_dir = os.path.abspath(save_dir)
    if not os.path.isdir(save_dir):
        return []
    recovered: List[str] = []
    # temp copies first: when both survive, the fully-written new copy wins
    for prefix_pass in (True, False):
        for name in os.listdir(save_dir):
            if prefix_pass:
                if not name.startswith(".tmp."):
                    continue
                tag = name[len(".tmp."):]
            else:
                if not name.endswith(".old"):
                    continue
                tag = name[:-len(".old")]
            if not tag or os.path.isdir(os.path.join(save_dir, tag)):
                continue
            if _tag_in_flight(save_dir, tag):
                continue   # a live writer owns these files, not a crash
            src = os.path.join(save_dir, name)
            if prefix_pass and not verify_tag(src).intact:
                continue   # half-written attempt: normal debris
            try:
                os.replace(src, os.path.join(save_dir, tag))
                _fsync_dir(save_dir)
                recovered.append(tag)
                logger.warning(f"checkpoint {tag}: recovered from "
                               f"interrupted overwrite ({name})")
            except OSError as e:
                logger.warning(f"checkpoint recovery of {name} failed: {e}")
    return recovered


def _latest_target(save_dir: str) -> Optional[str]:
    p = os.path.join(save_dir, "latest")
    try:
        with open(p) as f:
            return f.read().strip()
    except OSError:
        return None


def gc_tags(save_dir: str, keep_last: int,
            protect: Sequence[str] = (),
            assume_intact: Sequence[str] = ()) -> List[str]:
    """Keep the ``keep_last`` newest tags. Never deletes the tag ``latest``
    points to, anything in ``protect``, or — the invariant that makes
    retention safe under corruption — the newest tag that actually verifies
    intact, even when it has aged past the window. Also sweeps stale
    ``.tmp.*`` / ``*.old`` debris from crashed writes (after promoting any
    interrupted-overwrite survivors back to their tag). Returns deleted
    tag names."""
    save_dir = os.path.abspath(save_dir)
    recover_interrupted(save_dir)
    reps = list_tags(save_dir)
    victims = reps[keep_last:] if keep_last > 0 else []
    deleted: List[str] = []
    keep = set(protect)
    latest = _latest_target(save_dir)
    if latest:
        keep.add(latest)
    if victims:
        newest_ok = newest_intact_tag(save_dir, assume_intact=assume_intact)
        if newest_ok is not None:
            keep.add(newest_ok.tag)
    for rep in victims:
        if rep.tag in keep:
            continue
        shutil.rmtree(rep.path, ignore_errors=True)
        deleted.append(rep.tag)
    for name in os.listdir(save_dir):
        if name.startswith(".tmp."):
            owner = name[len(".tmp."):]
        elif name.endswith(".old"):
            owner = name[:-len(".old")]
        else:
            continue
        if _tag_in_flight(save_dir, owner):
            continue   # belongs to a save still running in this process
        shutil.rmtree(os.path.join(save_dir, name), ignore_errors=True)
    if deleted:
        _fsync_dir(save_dir)
    return deleted


# --------------------------------------------------------------------- #
# metrics

def _ckpt_metrics():
    """The checkpoint series of the process-global metrics registry."""
    from deepspeed_tpu_torch.monitor.metrics import get_registry
    reg = get_registry()
    return {
        "save_ms": reg.histogram(
            "checkpoint/save_ms",
            "persist phase wall time per tag (serialize+fsync+commit)"),
        "snapshot_ms": reg.histogram(
            "checkpoint/snapshot_ms",
            "device->host snapshot wall time on the training thread"),
        "bytes": reg.histogram(
            "checkpoint/bytes", "committed bytes per checkpoint tag"),
        "queue_depth": reg.gauge(
            "checkpoint/queue_depth",
            "async writer jobs queued or in flight"),
        "saves": reg.counter("checkpoint/saves", "committed checkpoint tags"),
        "failures": reg.counter(
            "checkpoint/failures",
            "saves failed after exhausting the retry budget"),
    }


# --------------------------------------------------------------------- #
# the bounded background writer

class _Job:
    def __init__(self, save_dir: str, payload: CheckpointPayload):
        self.save_dir = save_dir
        self.payload = payload
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.crashed = False


class AsyncCheckpointWriter:
    """One daemon thread draining a bounded queue of checkpoint jobs.
    ``submit`` blocks when ``max_pending`` snapshots are already in flight
    (backpressure — host memory for snapshots is bounded). Failures are
    recorded (metrics + ``on_result`` callback + log), never raised on the
    training thread; ``drain`` surfaces the most recent error."""

    def __init__(self, max_pending: int = 2, retries: int = 3,
                 retry_backoff_s: float = 0.5, keep_last: int = 0,
                 on_result: Optional[Callable[[bool, Optional[int]], None]] = None):
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.keep_last = keep_last
        self.on_result = on_result
        self._q: "queue.Queue[Optional[_Job]]" = queue.Queue(
            maxsize=max(1, max_pending))
        self._in_flight = 0
        # reentrant: a SIGTERM handler draining the writer may interrupt the
        # main thread inside submit's critical section — a plain Lock would
        # deadlock the emergency save
        self._lock = threading.RLock()
        self._idle = threading.Condition(self._lock)
        self.last_error: Optional[BaseException] = None
        self.completed = 0
        self.failed = 0
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, name="ckpt-writer", daemon=True)
        self._thread.start()

    # ---- producer side ---- #

    def submit(self, save_dir: str, payload: CheckpointPayload) -> _Job:
        if self._stopped:
            raise RuntimeError("checkpoint writer already stopped")
        job = _Job(os.path.abspath(save_dir), payload)
        with self._lock:
            self._in_flight += 1
        self._q.put(job)          # blocks at max_pending: bounded memory
        self._set_depth()
        return job

    def drain(self, timeout: Optional[float] = None,
              raise_on_error: bool = False) -> Optional[BaseException]:
        """Wait until every submitted job has been persisted (or failed).
        Returns the last error seen during the drained window, and raises
        it instead when ``raise_on_error``."""
        with self._idle:
            ok = self._idle.wait_for(lambda: self._in_flight == 0,
                                     timeout=timeout)
        if not ok:
            raise TimeoutError("checkpoint writer did not drain in time")
        err = self.last_error
        if err is not None and raise_on_error:
            self.last_error = None
            raise err
        return err

    def stop(self, drain: bool = True) -> None:
        if self._stopped:
            return
        if drain:
            try:
                self.drain()
            except Exception:
                pass
        self._stopped = True
        self._q.put(None)
        self._thread.join(timeout=30)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._in_flight

    def _set_depth(self) -> None:
        try:
            _ckpt_metrics()["queue_depth"].set(self.queue_depth)
        except Exception:
            pass

    # ---- the writer thread ---- #

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            mets = _ckpt_metrics()
            t0 = time.perf_counter()
            ok = False
            try:
                total = write_tag(job.save_dir, job.payload,
                                  retries=self.retries,
                                  retry_backoff_s=self.retry_backoff_s,
                                  keep_last=self.keep_last)
                mets["save_ms"].observe((time.perf_counter() - t0) * 1e3)
                mets["bytes"].observe(total)
                mets["saves"].inc()
                self.completed += 1
                ok = True
            except SimulatedCrash as e:
                # the simulated process death: leave the disk exactly as a
                # real crash would; only the harness bookkeeping survives
                job.crashed = True
                job.error = e
                self.last_error = e
            except BaseException as e:
                job.error = e
                self.last_error = e
                self.failed += 1
                mets["failures"].inc()
                logger.error(
                    f"async checkpoint {job.payload.tag} failed: {e}")
            finally:
                with self._idle:
                    self._in_flight -= 1
                    self._idle.notify_all()
                self._set_depth()
                job.done.set()
                if self.on_result is not None and not job.crashed:
                    try:
                        self.on_result(ok, job.payload.global_steps)
                    except Exception as cb_err:
                        logger.warning(
                            f"checkpoint on_result callback failed: {cb_err}")


# --------------------------------------------------------------------- #
# preemption (SIGTERM/SIGINT) grace handler

class PreemptionHandler:
    """Preemption / maintenance grace handling: on SIGTERM (and
    optionally SIGINT) drain the async writer, take a synchronous emergency
    save, then exit with the conventional ``128+signum`` so supervisors see
    a signal death. Re-entrant signals during the save are ignored."""

    def __init__(self, engine, save_dir: str,
                 signals: Sequence[int] = (_signal.SIGTERM, _signal.SIGINT),
                 exit_on_signal: bool = True):
        self.engine = engine
        self.save_dir = save_dir
        self.signals = tuple(signals)
        self.exit_on_signal = exit_on_signal
        self._prev: Dict[int, Any] = {}
        self._installed = False
        self._handling = False

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        for sig in self.signals:
            self._prev[sig] = _signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False

    def _handle(self, signum, frame) -> None:
        if self._handling:
            return
        self._handling = True
        name = _signal.Signals(signum).name
        logger.warning(
            f"{name} received: draining checkpoint writer and taking an "
            f"emergency save to {self.save_dir}")
        try:
            self.engine.emergency_save(self.save_dir)
        except Exception as e:
            logger.error(f"emergency save failed: {e}")
        finally:
            self.uninstall()
            self._handling = False
            if self.exit_on_signal:
                sys.exit(128 + signum)
