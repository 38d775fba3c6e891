"""Config/flag system: nested dataclass-ish configs from CLI args or files.

JAX-native replacement for the reference's Boost.program_options bundles
(ref: core/recorders/data_record_po.hpp, ctrl/ss_systems/satellite_modeling_po.hpp:289,
ctrl/path_planning/path_planner_options_po.hpp:48 — each domain exposes
``get_*_po_desc`` / ``get_*_from_po``; complex configs are serialized objects
referenced from flags, run_CRS_planner.cpp:228,386).

Here a Config is a plain nested dict with dotted-path access; sources merge in
order: defaults < file (JSON) < CLI ``--dotted.key=value`` overrides.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Optional


class Config(dict):
    """Nested dict with dotted-path get/set and attribute access."""

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value):
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def merged(self, other: Dict) -> "Config":
        out = Config(json.loads(json.dumps(self)))

        def rec(dst, src):
            for k, v in src.items():
                if isinstance(v, dict) and isinstance(dst.get(k), dict):
                    rec(dst[k], v)
                else:
                    dst[k] = v

        rec(out, other)
        return out

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v


def _parse_value(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.startswith("[") or s.startswith("{"):
        return json.loads(s)
    return s


def config_from_args(argv: Iterable[str], defaults: Optional[Dict] = None) -> Config:
    """Parse ``--a.b.c=value`` style overrides (the program-options veneer).
    A bare ``--config=path.json`` loads and merges a file first."""
    cfg = Config(defaults or {})
    overrides = []
    for arg in argv:
        if not arg.startswith("--"):
            continue
        key, _, val = arg[2:].partition("=")
        if key == "config":
            cfg = cfg.merged(config_from_file(val))
        else:
            # flag spelling --mc-runs maps to key mc_runs (dots keep nesting)
            key = key.replace("-", "_")
            overrides.append((key, _parse_value(val) if val else True))
    for key, val in overrides:
        cfg.set_path(key, val)
    return cfg


def config_from_file(path: str) -> Config:
    with open(path) as f:
        return Config(json.load(f))
