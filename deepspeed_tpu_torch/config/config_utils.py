"""Typed config base class without pydantic (counterpart of
``deepspeed_tpu/config/config_utils.py``).

A config is a ``@dataclass(init=False)`` subclass of :class:`ConfigModel`,
built from keyword arguments: field names or their aliases
(``field(metadata={"alias": "tp"})``), nested sub-configs from dicts
(:func:`sub`), scalar fields coerced to their default's type. Unknown keys
raise: a misspelt option must not be silently ignored. A field marked
``deprecated`` (``metadata={"deprecated": True, "new_param": "a.b"}``) warns
when set and writes its value through to the replacement. As in the
reference, a value of ``"auto"`` means "keep the default".
"""

from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Any, Dict

from deepspeed_tpu_torch.utils.logging import logger


def sub(cls, alias: str = None):
    """A nested sub-config field: defaults to ``cls()``, accepts a dict or
    an instance."""
    meta = {"config": cls}
    if alias:
        meta["alias"] = alias
    return dataclasses.field(default_factory=cls, metadata=meta)


def alias(default, name: str, **meta):
    """A field with a second accepted key (``max_tokens`` for
    ``max_out_tokens``)."""
    if isinstance(default, (list, dict)):
        return dataclasses.field(default_factory=lambda: type(default)(default),
                                 metadata={"alias": name, **meta})
    return dataclasses.field(default=default, metadata={"alias": name, **meta})


def _default(f: dataclasses.Field):
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    raise TypeError(f"config field {f.name} has no default")


class ConfigModel:
    """Base for all typed sub-configs (subclasses are
    ``@dataclasses.dataclass(init=False)``)."""

    def __init__(self, **data):
        fields = {f.name: f for f in dataclasses.fields(self)}
        aliases = {f.metadata["alias"]: n for n, f in fields.items()
                   if "alias" in f.metadata}
        given: Dict[str, Any] = {}
        for key, value in data.items():
            name = aliases.get(key, key)
            if name not in fields:
                raise ValueError(f"{type(self).__name__}: unknown config key {key!r} "
                                 f"(known: {sorted(fields)})")
            if name in given:
                raise ValueError(f"{type(self).__name__}: {key!r} given twice "
                                 "(as the field and as its alias)")
            if isinstance(value, str) and value == "auto" and name != "replace_method":
                continue
            given[name] = value
        for name, f in fields.items():
            value = given[name] if name in given else _default(f)
            setattr(self, name, self._coerce(f, value))
        self._fields_set = set(given)
        for name, f in fields.items():
            if f.metadata.get("deprecated") and name in given:
                self._process_deprecated_field(name, f)

    @staticmethod
    def _coerce(f: dataclasses.Field, value):
        cls = f.metadata.get("config")
        if cls is not None and isinstance(value, dict):
            return cls(**value)
        if value is None or isinstance(value, ConfigModel):
            return value
        default = f.default
        if isinstance(default, bool):
            if not isinstance(value, bool):
                raise ValueError(f"config field {f.name} expects a bool, got {value!r}")
            return value
        if type(default) in (int, float) and not isinstance(value, bool):
            return type(default)(value)
        return value

    def _process_deprecated_field(self, name: str, f: dataclasses.Field) -> None:
        new_field = f.metadata.get("new_param", "")
        logger.warning(f"Config parameter {name} is deprecated"
                       + (f" use {new_field} instead" if new_field else ""))
        if not new_field:
            return
        parts = new_field.split(".")
        if parts[0] in self._fields_set and len(parts) == 1:
            raise ValueError(f"Cannot provide deprecated parameter '{name}' and "
                             f"replacing parameter '{new_field}' together")
        obj = reduce(getattr, parts[:-1], self)
        setattr(obj, parts[-1], getattr(self, name))


def deep_update(base: dict, override: dict) -> dict:
    """Recursive dict merge returning a new dict (the JAX package's
    ``config_utils.deep_update``, read by ``compression/config.py``)."""
    import copy

    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = v
    return out
