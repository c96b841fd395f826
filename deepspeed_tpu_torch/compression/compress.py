"""Compression entry points, the counterpart of
``deepspeed_tpu/compression/compress.py`` (reference ``init_compression``
``:92`` / ``redundancy_clean`` ``:120``).

:func:`init_compression` returns a model whose loss / forward applies the
configured QAT fake-quant and pruning to matching parameters (matched by
dotted-path substring, the analogue of the reference's ``different_groups``
module-name patterns), and :func:`redundancy_clean` burns the transforms into
the param tree for deployment.

The transforms act on the JAX package's **stacked** leaves. The port keeps
one tensor a layer (``layers.{i}.mlp.w_up``) where the JAX package keeps one
``[n_layer, ...]`` leaf (``layers.mlp.w_up``), and a transform of the stack
is not the transform of each layer: ``sparse_mask`` takes one threshold over
all layers, ``row_mask`` sums over the layer axis, ``fake_quantize``'s
groups run over the flattened stack, and the rank test passes the stacked
``[L, D]`` biases and norm scales. So :meth:`CompressedModel.compress_params`
regroups the port's leaves into the JAX leaves
(:func:`~deepspeed_tpu_torch.runtime.utils.jax_leaves`), matches each rule's
patterns against the JAX dotted key (``layers.mlp.w_up``), tests the rank
on the stacked shape, transforms ``torch.stack`` of the layers and hands
each layer its slice (``unbind``), so autograd carries each layer's
gradient back to its own leaf.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Any, Dict, List

import torch
from torch import nn

from deepspeed_tpu_torch.compression import functional as F
from deepspeed_tpu_torch.compression.config import (ACTIVATION_QUANTIZATION, CHANNEL_PRUNING,
                                                    DIFFERENT_GROUPS, HEAD_PRUNING,
                                                    LAYER_REDUCTION, ROW_PRUNING,
                                                    SHARED_PARAMETERS, SPARSE_PRUNING,
                                                    WEIGHT_QUANTIZATION, get_compression_config)
from deepspeed_tpu_torch.models.transformer import ParamTree
from deepspeed_tpu_torch.runtime.utils import jax_leaves
from deepspeed_tpu_torch.utils.logging import logger, warn_once

_TECHNIQUES = (WEIGHT_QUANTIZATION, SPARSE_PRUNING, ROW_PRUNING, HEAD_PRUNING, CHANNEL_PRUNING)


class _GroupRule:
    """One ``different_groups`` entry: which params + which technique params."""

    def __init__(self, technique: str, name: str, params: Dict, modules: List[str]):
        self.technique = technique
        self.name = name
        self.params = params
        self.modules = modules  # substring patterns over dotted param paths; ["*"] = all

    def matches(self, dotted: str) -> bool:
        return any(m == "*" or m in dotted for m in self.modules)


def _collect_rules(compression_config: Dict) -> List[_GroupRule]:
    rules: List[_GroupRule] = []
    for technique in _TECHNIQUES:
        tcfg = compression_config.get(technique, {})
        shared = tcfg.get(SHARED_PARAMETERS, tcfg)
        if not shared.get("enabled", False):
            continue
        groups = tcfg.get(DIFFERENT_GROUPS, {})
        if not groups:
            continue
        for gname, gcfg in groups.items():
            params = dict(gcfg.get("params", {}))
            params["schedule_offset"] = shared.get("schedule_offset", 0)
            # the shared parameters override the group's own
            params.update({k: v for k, v in shared.items()
                           if k not in ("enabled", DIFFERENT_GROUPS)})
            modules = gcfg.get("modules", ["*"])
            rules.append(_GroupRule(technique, gname, params, modules))
    return rules


def _apply_rule(technique: str, w, params: Dict):
    if technique == WEIGHT_QUANTIZATION:
        bits = int(params.get("start_bits", params.get("target_bits", 8)))
        sym = params.get("quantization_type", "symmetric") == "symmetric"
        groups = int(params.get("quantize_groups", 1))
        return F.fake_quantize(w, bits, sym, groups)
    if technique == SPARSE_PRUNING:
        return F.prune(w, "sparse", float(params.get("dense_ratio", 0.5)))
    if technique == ROW_PRUNING:
        return F.prune(w, "row", float(params.get("dense_ratio", 0.5)))
    if technique == CHANNEL_PRUNING:
        return F.prune(w, "channel", float(params.get("dense_ratio", 0.5)))
    if technique == HEAD_PRUNING:
        return F.prune(w, "head", float(params.get("dense_ratio", 0.5)),
                       num_heads=int(params.get("num_heads", 1)))
    return w


def _load_config(deepspeed_config):
    if isinstance(deepspeed_config, str):
        import json
        with open(deepspeed_config) as f:
            return json.load(f)
    return deepspeed_config


def _children(tree):
    """(key, child) pairs of a param tree node: a ParamTree, a ModuleList of
    per-layer trees, a dict or a list."""
    if isinstance(tree, ParamTree):
        return [(k, getattr(tree, k)) for k in tree._keys]
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree's tensors by dotted name (``layers.0.attn.wq``); an int8
    ``Quantized8`` leaf is left out (no compression rule reads it)."""
    kids = _children(tree)
    if kids is None:
        return {prefix[:-1]: tree} if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in kids:
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


def _rebuild(tree, new: Dict[str, torch.Tensor], prefix: str = ""):
    """The tree as nested dicts and lists, each leaf named in ``new``
    replaced (the others kept as the same tensor objects)."""
    kids = _children(tree)
    if kids is None:
        return new.get(prefix[:-1], tree)
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [_rebuild(v, new, f"{prefix}{k}.") for k, v in kids]
    return {k: _rebuild(v, new, f"{prefix}{k}.") for k, v in kids}


class CompressedModel:
    """Wraps a model: the configured transforms are applied to matching
    params (per the scheduler's active set) before every forward / loss."""

    def __init__(self, model, compression_config: Dict):
        self.model = model
        self.config = compression_config
        self.rules = _collect_rules(compression_config)
        self._active = {id(r): True for r in self.rules}  # scheduler toggles
        self.compression_epoch = 0
        self._act_rule = None
        if model is not None:
            # structural rewiring first (layer reduction is not scheduled)
            model = self._rewire(model, self._layer_reduction_changes(compression_config))
            self._plain_model = model
            act_changes, act_rule = self._act_quant_changes(compression_config)
            if act_changes:
                # activation quant is a scheduled technique like the others:
                # it rides self.rules so CompressionScheduler honors its
                # schedule_offset by flipping between the two model variants
                self._act_model = self._rewire(model, act_changes)
                self._act_rule = act_rule
                self.rules.append(act_rule)
                self._active[id(act_rule)] = True
                model = self._act_model
            self.model = model
        if hasattr(model, "config"):
            self.config_model = model.config

    @staticmethod
    def _act_quant_changes(compression_config: Dict):
        """Config section -> TransformerConfig field changes for activation
        fake-quant (reference QuantAct layers, basic_layer.py:118-860)."""
        act = compression_config.get(ACTIVATION_QUANTIZATION, {})
        shared = act.get(SHARED_PARAMETERS, act)
        if not shared.get("enabled", False):
            return {}, None
        groups = act.get(DIFFERENT_GROUPS, {})
        bit_set = {int(g.get("params", {}).get("bits", 8)) for g in groups.values()} or {8}
        if len(bit_set) > 1:
            raise ValueError(
                f"activation_quantization groups request different bit widths "
                f"{sorted(bit_set)}; per-module scoped activation quant is not "
                "supported (the fake-quant applies at every attention/MLP "
                "input) — use one bit width")
        scoped = [m for g in groups.values() for m in g.get("modules", ["*"])
                  if m != "*"]
        if scoped:
            warn_once(f"activation_quantization 'modules' patterns {scoped} are "
                      "applied GLOBALLY (every attention/MLP input) — scoped "
                      "activation quant is not supported")
        if str(shared.get("range_calibration", "dynamic")) == "static":
            warn_once("activation_quantization range_calibration='static' "
                      "uses dynamic per-tensor ranges here (no calibration "
                      "momentum state in the functional design)")
        changes = dict(act_quant_bits=next(iter(bit_set)),
                       act_quant_sym=shared.get("quantization_type",
                                                "symmetric") == "symmetric")
        rule_params = {k: v for k, v in shared.items()
                       if k not in ("enabled", DIFFERENT_GROUPS)}
        rule_params.setdefault("schedule_offset", 0)
        rule = _GroupRule(ACTIVATION_QUANTIZATION, "activation_quantization",
                          rule_params, ["*"])
        return changes, rule

    @staticmethod
    def _layer_reduction_changes(compression_config: Dict) -> Dict:
        lr = compression_config.get(LAYER_REDUCTION, {})
        if not lr.get("enabled", False):
            return {}
        teacher_layer = list(lr.get("teacher_layer") or [])
        keep = int(lr.get("keep_number_layer", len(teacher_layer)))
        if keep <= 0:
            raise ValueError("layer_reduction needs keep_number_layer "
                             "(or teacher_layer) in the config")
        if teacher_layer and keep != len(teacher_layer):
            raise ValueError(
                f"layer_reduction keep_number_layer={keep} inconsistent with "
                f"teacher_layer (length {len(teacher_layer)}): "
                "student_initialization would reject this config later")
        return {"n_layer": keep}

    @staticmethod
    def _rewire(model, changes: Dict):
        """Apply TransformerConfig field changes on a COPY of the model."""
        if not changes:
            return model
        if not (hasattr(model, "config")
                and all(hasattr(model.config, k) for k in changes)):
            raise ValueError(
                f"compression config requests model-side rewrites {changes} "
                "but the model has no compatible TransformerConfig; zoo "
                "models (or a config with these fields) are required")
        model = copy.copy(model)
        model.config = dataclasses.replace(model.config, **changes)
        if hasattr(model, "zoo_cfg"):
            # models deriving a config (BertModel.zoo_cfg) would keep
            # computing with the stale one
            if not hasattr(model.config, "zoo"):
                raise ValueError(
                    f"cannot rewire {type(model).__name__}: it caches a "
                    "derived zoo_cfg its config cannot rebuild")
            model.zoo_cfg = model.config.zoo()
        return model

    def replace_model_config(self, **changes) -> None:
        """Model config fields that the training engine sets (a JSON-level
        ``fused_cross_entropy``), applied to both variants that
        :meth:`set_active` switches between, so neither keeps the old
        value after an activation-quant transition."""
        acting = self.model is getattr(self, "_act_model", None)
        self._plain_model = self._rewire(self._plain_model, changes)
        if self._act_rule is not None:
            self._act_model = self._rewire(self._act_model, changes)
        self.model = self._act_model if acting else self._plain_model
        self.config_model = self.model.config

    def set_active(self, rule: _GroupRule, active: bool) -> None:
        if self._active.get(id(rule)) != active:
            # what the model computes changed; the JAX engine drops its
            # compiled programs on this count (the eager port has none)
            self.compression_epoch += 1
        self._active[id(rule)] = active
        if rule is self._act_rule:
            self.model = self._act_model if active else self._plain_model

    def compress_params(self, params):
        """Apply every active transform to its matching JAX leaves. Returns
        ``params`` when no transform applies, else the tree as nested dicts
        and lists with the transformed layers' slices in place."""
        active_rules = [r for r in self.rules if self._active.get(id(r), True)]
        if not active_rules:
            return params
        leaves = _leaves(params)
        new = {}
        for path, names in jax_leaves(leaves).items():
            dotted = ".".join(path)
            rules = [r for r in active_rules if r.matches(dotted)]
            stacked = path[0] == "layers" and len(path) > 1
            xs = [leaves[n] for n in names]
            if not rules or xs[0].dim() + (1 if stacked else 0) < 2:
                continue
            x = torch.stack(xs) if stacked else xs[0]
            for rule in rules:
                x = _apply_rule(rule.technique, x, rule.params)
            new.update(zip(names, x.unbind(0) if stacked else (x,)))
        return _rebuild(params, new) if new else params

    # model-protocol passthrough. The engine adapts to the model's arity
    # (some losses take an rng, some don't) — forward only what the wrapped
    # model accepts so the adapter sees the true signature through us.
    def loss(self, params, batch, *args, **kwargs):
        try:
            n_extra = len(inspect.signature(self.model.loss).parameters) - 2
        except (TypeError, ValueError):
            n_extra = len(args)
        return self.model.loss(self.compress_params(params), batch,
                               *args[:max(0, n_extra)], **kwargs)

    def forward(self, params, *args, **kwargs):
        return self.model.forward(self.compress_params(params), *args, **kwargs)

    def __call__(self, params, *args, **kwargs):
        return self.forward(params, *args, **kwargs)

    def __getattr__(self, name):
        if name == "model" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.model, name)


def init_compression(model, deepspeed_config, mpu=None):
    """Reference ``init_compression`` (``compress.py:92``): returns the
    compression-wrapped model. ``deepspeed_config``: dict or path."""
    ccfg = get_compression_config(_load_config(deepspeed_config))
    wrapped = CompressedModel(model, ccfg)
    logger.info(f"init_compression: {len(wrapped.rules)} compression group(s) active")
    return wrapped


@torch.no_grad()
def redundancy_clean(model_or_params, deepspeed_config, mpu=None):
    """Reference ``redundancy_clean`` (``compress.py:120``): burn the
    transforms into the params for deployment. Takes the raw param tree +
    the ds config (NOT a CompressedModel — pass ``engine.state.params``).
    A ParamTree comes back as a ParamTree (frozen, as serving takes it);
    leaves no rule touches share their storage with the input, as the JAX
    package returns the same arrays."""
    deepspeed_config = _load_config(deepspeed_config)
    if isinstance(model_or_params, CompressedModel):
        raise ValueError("pass the param tree: redundancy_clean(params, config)")
    ccfg = get_compression_config(deepspeed_config)
    shell = CompressedModel(model=None, compression_config=ccfg)
    out = shell.compress_params(model_or_params)
    if isinstance(model_or_params, ParamTree) and not isinstance(out, ParamTree):
        return ParamTree(out)
    return out


def _tree(params) -> Dict[str, Any]:
    """A param tree's top level as a dict (sub-trees as they are)."""
    return {k: v for k, v in _children(params)} if isinstance(params, ParamTree) else params


@torch.no_grad()
def student_initialization(student_params, teacher_params, deepspeed_config):
    """Layer-reduction student init (reference ``compression/compress.py:164``
    ``student_initialization``): re-initialize the student's layers from the
    configured teacher layers, and copy the non-layer modules.

    ``teacher_layer`` indexes the teacher's per-layer list as the JAX
    package indexes its stacked layer axis; ``other_module_name`` lists
    top-level subtrees to copy (default: every non-"layers" top-level entry,
    i.e. embed / ln_f / lm_head). Returns a new student tree (a ParamTree
    for a ParamTree) whose teacher parts are copies, so training the student
    leaves the teacher as it was; inputs are not mutated.
    """
    lr = get_compression_config(_load_config(deepspeed_config)).get(LAYER_REDUCTION, {})
    if not lr.get("enabled", False):
        raise ValueError("student_initialization needs compression_training."
                         "layer_reduction.enabled=true")
    teacher_layer = list(lr.get("teacher_layer") or [])
    if not teacher_layer:
        raise ValueError("layer_reduction.teacher_layer is required")
    student, teacher = _tree(student_params), _tree(teacher_params)
    if "layers" not in student or "layers" not in teacher:
        raise ValueError("student_initialization expects zoo param trees "
                         "with a stacked 'layers' subtree")
    n_student = len(student["layers"])
    if n_student != len(teacher_layer):
        raise ValueError(f"student has {n_student} layers but teacher_layer "
                         f"names {len(teacher_layer)} source layers")

    copied = lambda sub: _rebuild(sub, {n: t.detach().clone() for n, t in _leaves(sub).items()})
    out = {k: _rebuild(v, {}) for k, v in student.items()}
    teacher_layers = list(teacher["layers"])
    out["layers"] = [copied(teacher_layers[int(i)]) for i in teacher_layer]
    others = lr.get("other_module_name")
    if others is None:
        others = [k for k in teacher if k != "layers"]
    for name in others:
        if name not in teacher:
            raise KeyError(f"other_module_name entry {name!r} not in the "
                           f"teacher tree (has {sorted(teacher)})")
        if name not in student:
            raise KeyError(f"other_module_name entry {name!r} not in the "
                           f"student tree (has {sorted(student)}); "
                           "a silently skipped module would train from "
                           "random init")
        out[name] = copied(teacher[name])
    return ParamTree(out) if isinstance(student_params, ParamTree) else out
