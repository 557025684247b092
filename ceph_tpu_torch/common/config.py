"""Layered config with a typed option table (reference: src/common/config.{h,cc}
:: md_config_t; option declarations in src/common/options/*.yaml.in).

Sources layer exactly as the reference's: compiled defaults < conf file <
mon centralized config < environment < CLI overrides < runtime `set`.
Options carry type, default, bounds/enum, a `runtime`-updatable flag and a
doc string; observers get change notification (reference: md_config_obs_t).

EC profiles are deliberately NOT here — they are per-pool key=value maps in
the OSDMap (SURVEY.md §5.6), handled by ceph_tpu.ec.registry.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

from .lockdep import make_lock

# Source levels, low to high precedence (reference: config layering §5.6).
LEVEL_DEFAULT = 0
LEVEL_FILE = 1
LEVEL_MON = 2
LEVEL_ENV = 3
LEVEL_CMDLINE = 4
LEVEL_OVERRIDE = 5

_LEVEL_NAMES = {
    LEVEL_DEFAULT: "default",
    LEVEL_FILE: "file",
    LEVEL_MON: "mon",
    LEVEL_ENV: "env",
    LEVEL_CMDLINE: "cmdline",
    LEVEL_OVERRIDE: "override",
}


class ConfigError(ValueError):
    pass


@dataclass(frozen=True)
class Option:
    """One declared option (reference: Option in src/common/options.h)."""

    name: str
    type: type  # int | float | bool | str
    default: Any
    doc: str = ""
    min: float | None = None
    max: float | None = None
    enum: tuple[str, ...] | None = None
    runtime: bool = False  # updatable on a live daemon

    def parse(self, value: Any) -> Any:
        try:
            if self.type is bool and isinstance(value, str):
                low = value.strip().lower()
                if low in ("true", "1", "yes", "on"):
                    value = True
                elif low in ("false", "0", "no", "off"):
                    value = False
                else:
                    raise ValueError(value)
            else:
                value = self.type(value)
        except (TypeError, ValueError) as e:
            raise ConfigError(
                f"option {self.name}: cannot parse {value!r} as {self.type.__name__}"
            ) from e
        if self.min is not None and value < self.min:
            raise ConfigError(f"option {self.name}: {value} < min {self.min}")
        if self.max is not None and value > self.max:
            raise ConfigError(f"option {self.name}: {value} > max {self.max}")
        if self.enum is not None and value not in self.enum:
            raise ConfigError(
                f"option {self.name}: {value!r} not in {list(self.enum)}"
            )
        return value


class OptionTable:
    """Declared-options registry (reference: the generated option table)."""

    def __init__(self, options: list[Option] = ()):  # type: ignore[assignment]
        self._options: dict[str, Option] = {}
        for o in options:
            self.add(o)

    def add(self, opt: Option) -> None:
        if opt.name in self._options:
            raise ConfigError(f"duplicate option {opt.name}")
        opt.parse(opt.default)  # defaults must self-validate
        self._options[opt.name] = opt

    def get(self, name: str) -> Option:
        try:
            return self._options[name]
        except KeyError:
            raise ConfigError(f"unknown option {name!r}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._options

    def names(self) -> list[str]:
        return sorted(self._options)


@dataclass
class _Value:
    by_level: dict[int, Any] = field(default_factory=dict)


class Config:
    """Layered values over an OptionTable, with observers."""

    def __init__(self, table: OptionTable, values: dict[str, Any] | None = None):
        self._table = table
        self._values: dict[str, _Value] = {}
        self._observers: list[tuple[tuple[str, ...], Callable[[str, Any], None]]] = []
        self._lock = make_lock("config::values")
        if values:
            for k, v in values.items():
                self.set(k, v, level=LEVEL_OVERRIDE)

    @property
    def table(self) -> OptionTable:
        return self._table

    def get(self, name: str) -> Any:
        opt = self._table.get(name)
        with self._lock:
            val = self._values.get(name)
            if val and val.by_level:
                return val.by_level[max(val.by_level)]
        return opt.default

    def get_expanded(self, name: str) -> Any:
        """get() plus metavariable expansion for path-like string
        options (reference: config $name/$pid expansion in
        md_config_t::expand_meta) — so one cluster-wide override like
        `$name.asok` yields a distinct path per daemon."""
        val = self.get(name)
        if isinstance(val, str) and "$" in val:
            val = (val.replace("$name", str(self.get("name")))
                      .replace("$pid", str(os.getpid())))
        return val

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def source(self, name: str) -> str:
        """Which layer supplies the effective value."""
        self._table.get(name)
        with self._lock:
            val = self._values.get(name)
            level = max(val.by_level) if val and val.by_level else LEVEL_DEFAULT
        return _LEVEL_NAMES[level]

    def set(self, name: str, value: Any, level: int = LEVEL_OVERRIDE) -> Any:
        opt = self._table.get(name)
        parsed = opt.parse(value)
        with self._lock:
            before = self.get(name)
            self._values.setdefault(name, _Value()).by_level[level] = parsed
            after = self.get(name)
            observers = list(self._observers) if after != before else []
        for keys, cb in observers:
            if name in keys:
                cb(name, after)
        return parsed

    def rm(self, name: str, level: int) -> None:
        self._table.get(name)
        with self._lock:
            val = self._values.get(name)
            if val:
                val.by_level.pop(level, None)

    # -- sources ----------------------------------------------------------
    def parse_file(self, path: str) -> None:
        """Minimal ini-style conf (reference: ceph.conf): `name = value`
        lines; `[section]` headers are accepted and ignored (the framework
        is single-entity per process); `#`/`;` comments."""
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.split("#", 1)[0].split(";", 1)[0].strip()
                if not line or line.startswith("["):
                    continue
                if "=" not in line:
                    raise ConfigError(f"{path}:{lineno}: expected name = value")
                name, value = (s.strip() for s in line.split("=", 1))
                name = name.replace(" ", "_")
                if name in self._table:
                    self.set(name, value, level=LEVEL_FILE)

    def parse_env(self, environ: dict[str, str] | None = None) -> None:
        """CEPH_TPU_<OPTION_NAME> environment overrides."""
        environ = os.environ if environ is None else environ
        for name in self._table.names():
            env_key = "CEPH_TPU_" + name.upper()
            if env_key in environ:
                self.set(name, environ[env_key], level=LEVEL_ENV)

    def parse_argv(self, argv: list[str]) -> list[str]:
        """Consume `--name value` / `--name=value` pairs for declared
        options; returns unrecognized args for the caller's own parser."""
        rest: list[str] = []
        i = 0
        while i < len(argv):
            arg = argv[i]
            if arg.startswith("--"):
                body = arg[2:]
                if "=" in body:
                    name, value = body.split("=", 1)
                    name = name.replace("-", "_")
                    if name in self._table:
                        self.set(name, value, level=LEVEL_CMDLINE)
                        i += 1
                        continue
                else:
                    name = body.replace("-", "_")
                    if name in self._table and i + 1 < len(argv):
                        self.set(name, argv[i + 1], level=LEVEL_CMDLINE)
                        i += 2
                        continue
            rest.append(arg)
            i += 1
        return rest

    # -- observation / introspection --------------------------------------
    def add_observer(self, names: list[str], cb: Callable[[str, Any], None]) -> None:
        """cb(name, new_value) after an effective-value change (reference:
        md_config_obs_t::handle_conf_change)."""
        for n in names:
            self._table.get(n)
        with self._lock:
            self._observers.append((tuple(names), cb))

    def remove_observer(self, cb: Callable[[str, Any], None]) -> None:
        """Deregister a conf-change observer (identity match on cb): a
        stopped daemon must not keep reacting to injectargs through a
        callback that closes over dead state."""
        with self._lock:
            self._observers = [
                (names, c) for names, c in self._observers if c is not cb
            ]

    def show_config(self) -> dict[str, Any]:
        return {n: self.get(n) for n in self._table.names()}

    def diff(self) -> dict[str, dict[str, Any]]:
        """Non-default values with their source (reference: `config diff`)."""
        out = {}
        for n in self._table.names():
            v = self.get(n)
            if v != self._table.get(n).default:
                out[n] = {"value": v, "source": self.source(n)}
        return out
