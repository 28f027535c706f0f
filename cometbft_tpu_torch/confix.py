"""Config tooling: view / get / set / diff / migrate.

Reference: internal/confix (the `cometbft config` command group) —
upgrade a node's persisted config across versions, show effective
values, and edit keys in place.  The persisted file here is the JSON
override tree read by cmd._load_config (section -> {key: value});
this module normalizes it against the live dataclass schema.  A copy
of cometbft_tpu/confix.py: the same renames, drops, duration parsing,
change-log texts and file bytes, over the port's config.py.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

from .config import Config

# legacy-key renames across config versions (reference:
# confix/migrations — e.g. v0.34 fast_sync -> blocksync.enable,
# v0.38 timeout_prevote/timeout_precommit folded into timeout_vote)
_RENAMES: dict[tuple[str, str], tuple[str, str]] = {
    ("base", "fast_sync"): ("blocksync", "enable"),
    ("consensus", "timeout_prevote"): ("consensus", "timeout_vote_ns"),
    ("consensus", "timeout_precommit"): ("consensus",
                                         "timeout_vote_ns"),
}

# keys the reference dropped entirely (confix removes them)
_DROPPED: set[tuple[str, str]] = {
    ("mempool", "version"),
    ("blocksync", "version"),
    ("fastsync", "version"),
    ("p2p", "upnp"),
}

_DUR_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(ns|us|ms|s|m|h)\s*$")
_DUR_NS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000,
           "m": 60 * 1_000_000_000, "h": 3600 * 1_000_000_000}


def parse_duration_ns(v: Any) -> Optional[int]:
    """Go-style duration string ("500ms", "3s", "1h") or bare number
    of seconds -> nanoseconds; None if not a duration."""
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return int(v * 1_000_000_000)
    if isinstance(v, str):
        m = _DUR_RE.match(v)
        if m:
            return int(float(m.group(1)) * _DUR_NS[m.group(2)])
    return None


def config_path(home: str) -> str:
    return os.path.join(home, "config", "config.json")


def load_overrides(home: str) -> dict:
    path = config_path(home)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def save_overrides(home: str, overrides: dict) -> None:
    path = config_path(home)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(overrides, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    """Apply a section->key override tree onto a Config (the single
    loader used by the CLI, the node, and set_value validation)."""
    for section, values in overrides.items():
        target = getattr(cfg, section, None)
        if target is None:
            continue
        for k, v in (values or {}).items():
            if hasattr(target, k):
                setattr(target, k, v)
    return cfg


def effective_config(home: str) -> Config:
    cfg = Config()
    cfg.base.home = home
    return apply_overrides(cfg, load_overrides(home))


def config_to_dict(cfg: Config) -> dict:
    return {f.name: dataclasses.asdict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def diff_from_defaults(home: str) -> dict:
    """Overrides that differ from the built-in defaults, plus entries
    the schema doesn't know (reference: confix diff)."""
    defaults = config_to_dict(Config())
    out: dict = {}
    for section, values in load_overrides(home).items():
        dsec = defaults.get(section)
        for k, v in (values or {}).items():
            if dsec is None or k not in dsec:
                out.setdefault(section, {})[k] = {
                    "value": v, "status": "unknown"}
            elif dsec[k] != v:
                out.setdefault(section, {})[k] = {
                    "value": v, "default": dsec[k],
                    "status": "changed"}
    return out


def migrate(home: str, dry_run: bool = False) -> list[str]:
    """Normalize the persisted overrides against the current schema:
    apply renames, convert duration strings to _ns integers, drop
    dead keys.  Returns a human-readable change log (reference:
    confix migrate, which rewrites the TOML through a plan)."""
    overrides = load_overrides(home)
    schema = config_to_dict(Config())
    log: list[str] = []
    # (sec, key, value, legacy?) after rename/convert; applied in two
    # passes so an EXPLICIT new-style key always beats a legacy alias
    # that maps onto it, regardless of file order
    resolved: list[tuple[str, str, Any, bool]] = []
    for section, values in overrides.items():
        for k, v in (values or {}).items():
            sec, key, legacy = section, k, False
            if (sec, key) in _DROPPED:
                log.append(f"dropped {sec}.{key} (obsolete)")
                continue
            if (sec, key) in _RENAMES:
                nsec, nkey = _RENAMES[(sec, key)]
                log.append(f"renamed {sec}.{key} -> {nsec}.{nkey}")
                sec, key, legacy = nsec, nkey, True
            dsec = schema.get(sec)
            if dsec is None:
                log.append(f"dropped {sec}.{key} (unknown section)")
                continue
            if key not in dsec:
                # a duration key may have lost its _ns suffix
                if key + "_ns" in dsec:
                    ns = parse_duration_ns(v)
                    if ns is not None:
                        log.append(
                            f"converted {sec}.{key}={v!r} -> "
                            f"{sec}.{key}_ns={ns}")
                        key, v, legacy = key + "_ns", ns, True
                    else:
                        log.append(
                            f"dropped {sec}.{key} (bad duration "
                            f"{v!r})")
                        continue
                else:
                    log.append(f"dropped {sec}.{key} (unknown key)")
                    continue
            elif key.endswith("_ns") and isinstance(v, str):
                ns = parse_duration_ns(v)
                if ns is None:
                    log.append(f"dropped {sec}.{key} (bad duration "
                               f"{v!r})")
                    continue
                log.append(f"converted {sec}.{key}={v!r} -> {ns}")
                v = ns
            resolved.append((sec, key, v, legacy))
    new: dict = {}
    for want_legacy in (False, True):
        for sec, key, v, legacy in resolved:
            if legacy != want_legacy:
                continue
            dest = new.setdefault(sec, {})
            if key in dest and dest[key] != v:
                log.append(f"conflict: kept {sec}.{key}="
                           f"{dest[key]!r}, ignored legacy value "
                           f"{v!r}")
                continue
            dest[key] = v
    if not dry_run and (log or overrides != new):
        save_overrides(home, new)
    return log


def get_value(home: str, dotted: str) -> Any:
    section, _, key = dotted.partition(".")
    cfg = effective_config(home)
    target = getattr(cfg, section, None)
    if target is None or not hasattr(target, key):
        raise KeyError(dotted)
    return getattr(target, key)


def set_value(home: str, dotted: str, raw: str) -> Any:
    """Persist one key (reference: confix set).  The value is parsed
    as JSON when possible, as a duration for _ns keys, else kept as a
    string."""
    section, _, key = dotted.partition(".")
    schema = config_to_dict(Config())
    if section not in schema or key not in schema[section]:
        raise KeyError(dotted)
    try:
        value: Any = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    if key.endswith("_ns") and isinstance(value, str):
        ns = parse_duration_ns(value)
        if ns is None:
            raise ValueError(f"{dotted}: bad duration {raw!r}")
        value = ns
    # type + semantic checks BEFORE persisting: a value the node
    # would refuse to boot with must be rejected here
    default = schema[section][key]
    if default is not None and value is not None:
        if isinstance(default, bool) != isinstance(value, bool) or \
                not isinstance(value, (type(default), int)
                               if isinstance(default, float)
                               else type(default)):
            raise ValueError(
                f"{dotted}: expected {type(default).__name__}, "
                f"got {type(value).__name__}")
    overrides = load_overrides(home)
    overrides.setdefault(section, {})[key] = value
    from .config import ConfigError, validate_basic
    try:
        validate_basic(apply_overrides(Config(), overrides))
    except ConfigError as e:
        raise ValueError(f"{dotted}: rejected by validation: {e}")
    save_overrides(home, overrides)
    return value
