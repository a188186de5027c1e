"""Minimal Hydra/OmegaConf-compatible config tree (copy of the JAX package's
``utils/config.py``, which the port may not import).

The reference drives every entry point from a YAML config tree with dotted CLI
overrides and ``${a.b}`` interpolation (reference: ``src/train.py:433``,
``config/base.yaml:105``). Hydra/OmegaConf are not available in this
environment, so this module implements the subset the framework needs:

- ``load_config(path)``     -> ``ConfigNode`` from a YAML file
- dotted overrides          -> ``model.fusion_type=early``,
                               ``dataset.modalities=[imu_hand,heart_rate]``
- interpolation             -> ``${model.fusion_type}`` resolved lazily
- attribute + item access, ``.get(key, default)``, ``to_container(resolve=)``

Values in overrides are parsed with YAML semantics (so ``1e-3`` -> float,
``true`` -> bool, ``[a,b]`` -> list), matching how Hydra treats CLI args.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class _ConfigYamlLoader(yaml.SafeLoader):
    """SafeLoader with a float resolver that accepts ``1e-3`` notation.

    PyYAML's YAML-1.1 resolver only treats ``1.0e-3`` as a float; scientific
    notation without a decimal point parses as a string. OmegaConf (the
    reference's config engine) accepts ``1e-3`` — so do we.
    """


_ConfigYamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
        |[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str):
    return yaml.load(text, Loader=_ConfigYamlLoader)


class ConfigNode(Mapping):
    """A nested attr-dict with ``${path}`` interpolation against its root."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, _root: Optional["ConfigNode"] = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", _root if _root is not None else self)
        if data:
            for key, value in data.items():
                self._data[key] = self._wrap(value)

    # -- construction -----------------------------------------------------
    def _wrap(self, value: Any) -> Any:
        if isinstance(value, ConfigNode):
            node = ConfigNode(_root=self._root)
            node._data.update(value._data)
            self._reroot(node)
            return node
        if isinstance(value, Mapping):
            node = ConfigNode(_root=self._root)
            for k, v in value.items():
                node._data[k] = node._wrap(v)
            return node
        if isinstance(value, list):
            return [self._wrap(v) for v in value]
        return value

    def _reroot(self, node: "ConfigNode") -> None:
        object.__setattr__(node, "_root", self._root)
        for v in node._data.values():
            if isinstance(v, ConfigNode):
                node._reroot(v)

    # -- interpolation ----------------------------------------------------
    def _resolve_value(self, value: Any) -> Any:
        if isinstance(value, str) and "${" in value:
            full = _INTERP_RE.fullmatch(value)
            if full:  # whole-string interpolation keeps the referent's type
                return self._root._select(full.group(1))
            return _INTERP_RE.sub(
                lambda m: str(self._root._select(m.group(1))), value
            )
        if isinstance(value, list):
            return [self._resolve_value(v) for v in value]
        return value

    def _select(self, dotted: str) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, ConfigNode):
                if part not in node._data:
                    raise KeyError(f"Interpolation key not found: '{dotted}'")
                node = node._data[part]
            else:
                raise KeyError(f"Interpolation key not found: '{dotted}'")
        return self._resolve_value(node) if not isinstance(node, ConfigNode) else node

    # -- access -----------------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(str(exc)) from exc

    def __getitem__(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(f"Missing config key: '{key}'")
        return self._resolve_value(self._data[key])

    def __setattr__(self, key: str, value: Any) -> None:
        if key.startswith("_"):
            object.__setattr__(self, key, value)
        else:
            self._data[key] = self._wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = self._wrap(value)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self[key]
        return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self[k]) for k in self._data]

    def values(self):
        return [self[k] for k in self._data]

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_container(resolve=False)!r})"

    def __deepcopy__(self, memo) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_container(resolve=False), memo))

    # -- conversion -------------------------------------------------------
    def to_container(self, resolve: bool = True) -> Dict[str, Any]:
        def unwrap(value: Any) -> Any:
            if isinstance(value, ConfigNode):
                return {k: unwrap(v) for k, v in value._data.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        if not resolve:
            return unwrap(self)
        return unwrap_resolved(self)

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_container(resolve=True), sort_keys=False)

    # -- mutation ---------------------------------------------------------
    def merge(self, other: Mapping) -> None:
        """Recursively merge ``other`` into this node (other wins)."""
        for key, value in (other._data if isinstance(other, ConfigNode) else other).items():
            if (
                key in self._data
                and isinstance(self._data[key], ConfigNode)
                and isinstance(value, (Mapping, ConfigNode))
            ):
                self._data[key].merge(value)
            else:
                self._data[key] = self._wrap(value)

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node._data or not isinstance(node._data[part], ConfigNode):
                node._data[part] = ConfigNode(_root=self._root)
            node = node._data[part]
        node._data[parts[-1]] = node._wrap(value)


def unwrap_resolved(node: ConfigNode) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key in node._data:
        value = node[key]
        if isinstance(value, ConfigNode):
            out[key] = unwrap_resolved(value)
        elif isinstance(value, list):
            out[key] = [unwrap_resolved(v) if isinstance(v, ConfigNode) else v for v in value]
        else:
            out[key] = value
    return out


def _parse_yaml_value(text: str) -> Any:
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def parse_overrides(overrides: List[str]) -> Dict[str, Any]:
    """Parse Hydra-style ``a.b=c`` CLI overrides into {dotted: value}."""
    parsed: Dict[str, Any] = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(
                f"Malformed override '{item}' (expected key=value syntax)"
            )
        key, raw = item.split("=", 1)
        key = key.lstrip("+")  # hydra "+new.key=value" additions
        parsed[key] = _parse_yaml_value(raw)
    return parsed


def load_config(
    path: str | Path,
    overrides: Optional[List[str]] = None,
) -> ConfigNode:
    """Load a YAML config file and apply dotted CLI overrides.

    Preset files (e.g. ``config/fusion_strategies.yaml``) carry a
    ``defaults: [base, ...]`` list plus named preset sections; the defaults
    are loaded (relative to the file) and deep-merged first, and a
    ``preset=<section>`` override selects a section to merge on top::

        python src/train.py --config-name fusion_strategies preset=uncertainty_fusion
    """
    path = Path(path)
    with path.open("r", encoding="utf-8") as handle:
        raw = _yaml_load(handle.read()) or {}
    parsed = parse_overrides(overrides or [])
    preset = parsed.pop("preset", None)

    defaults = raw.pop("defaults", None)
    if defaults:
        # every remaining top-level key must be a preset SECTION (a mapping);
        # a scalar like a stray top-level ``seed: 7`` would otherwise be
        # silently dropped — presets-with-defaults files have no "shared
        # override" slot (put shared keys in a defaults file instead)
        bad = sorted(k for k, v in raw.items() if not isinstance(v, dict))
        if bad:
            raise ValueError(
                f"Top-level key(s) {bad} in {path.name} are not preset "
                "sections; in a 'defaults:' preset file every other "
                "top-level key must be a mapping (move shared settings "
                "into one of the defaults files)"
            )
        cfg = ConfigNode({})
        for name in defaults:
            base_path = path.parent / (
                name if str(name).endswith(".yaml") else f"{name}.yaml"
            )
            with base_path.open("r", encoding="utf-8") as handle:
                cfg.merge(_yaml_load(handle.read()) or {})
        if preset is not None:
            if preset not in raw:
                raise ValueError(
                    f"Unknown preset '{preset}' in {path.name} "
                    f"(available: {sorted(raw)})"
                )
            cfg.merge(raw[preset])
    else:
        if preset is not None:
            raise ValueError(
                f"preset={preset} given but {path.name} has no 'defaults:' "
                "preset structure"
            )
        cfg = ConfigNode(raw)

    for dotted, value in parsed.items():
        cfg.set_dotted(dotted, value)
    return cfg


def to_container(cfg: ConfigNode, resolve: bool = True) -> Dict[str, Any]:
    return cfg.to_container(resolve=resolve)

