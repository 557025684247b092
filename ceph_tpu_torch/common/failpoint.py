"""Named failpoints — a process-wide, seeded fault-injection registry
(reference: the scattered ceph `*_inject_*` debug options, unified the way
FreeBSD's fail(9) / libfiu structure theirs; qa/tasks/thrashosds.py is the
harness that composes them, in the reference package qa/thrasher.py).

A subsystem marks an injection site with a NAME and whatever context it
can cheaply supply::

    from ceph_tpu_torch.common.failpoint import failpoint, FailpointError

    try:
        failpoint("osd.store.write_before_commit", entity=self.whoami)
    except FailpointError:
        ...  # behave as if the fault really happened

and an operator (or the thrasher) arms the site with an ACTION SPEC::

    registry().set("osd.store.write_before_commit", "times(2,error)")
    registry().add("msgr.frame.recv", "error",
                   match={"entity": "osd.1", "peer": "osd.4"})  # netsplit

Specs form a tiny combinator language, every stochastic choice drawn from
ONE registry-wide seeded RNG so a failure schedule replays bit-exactly:

    off                    never fire
    error                  raise FailpointError
    error(OSError)         raise a named builtin instead
    delay(0.25)            sleep 0.25 s, then continue
    crash                  raise FailpointCrash (simulated daemon death)
    prob(0.3, SPEC)        fire SPEC with probability 0.3 (seeded RNG)
    times(2, SPEC)         fire SPEC for the first 2 matched hits, then off
    every(5, SPEC)         fire SPEC on every 5th matched hit

Entries are settable three ways (all land in the same registry):
- ``Config``: the ``failpoint`` option ("name=spec;name=spec", scoped to
  that daemon's hits) plus the subsumed legacy options
  ``ms_inject_socket_failures``, ``osd_debug_inject_read_err`` and
  ``osd_debug_inject_dispatch_delay`` (see LEGACY_OPTIONS);
- the admin socket: ``failpoint set|list|rm|seed`` and ``injectargs``;
- ``ceph_tpu.tools.ceph_cli``: ``ceph daemon <asok> failpoint ...`` /
  ``ceph daemon <asok> injectargs --option value``.

The registry is process-wide because a LocalCluster runs many daemons in
one interpreter: cross-daemon schedules (netsplits between OSD pairs) need
one place to stand.  Per-daemon scoping comes from the ``match`` dict —
config/admin-socket entries match on the owning CephContext, thrasher
entries on entity names.
"""
from __future__ import annotations

import random
import threading
import time

from .lockdep import make_lock


class FailpointError(Exception):
    """Default exception an ``error`` action raises at a failpoint site."""


class FailpointCrash(FailpointError):
    """Raised by the ``crash`` action — simulated sudden daemon death.
    Sites re-raise it past their normal fault handling so it propagates
    like a real abort would."""


# builtin exceptions an `error(Name)` spec may raise; a closed set so a
# spec arriving over the admin socket can't name arbitrary attributes
_ERROR_TYPES = {
    "FailpointError": FailpointError,
    "OSError": OSError,
    "IOError": OSError,
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


class FailpointSpecError(ValueError):
    pass


# -- actions ---------------------------------------------------------------
class _Action:
    """fire(rng) decides whether this hit takes the effect (mutating any
    combinator state); invoke(name) performs it.  Split so the registry
    can run fire() under its lock but invoke() (which may sleep or raise)
    outside it."""

    def fire(self, rng: random.Random) -> bool:
        return True

    def invoke(self, name: str) -> None:
        pass

    def describe(self) -> str:
        return "off"


class _Off(_Action):
    def fire(self, rng):
        return False


class _Error(_Action):
    def __init__(self, exc_name: str = "FailpointError"):
        if exc_name not in _ERROR_TYPES:
            raise FailpointSpecError(
                f"unknown error type {exc_name!r}; one of "
                f"{sorted(_ERROR_TYPES)}"
            )
        self.exc_name = exc_name

    def invoke(self, name):
        raise _ERROR_TYPES[self.exc_name](f"failpoint {name!r} injected error")

    def describe(self):
        return ("error" if self.exc_name == "FailpointError"
                else f"error({self.exc_name})")


class _Delay(_Action):
    def __init__(self, sec: float):
        if sec < 0:
            raise FailpointSpecError(f"negative delay {sec}")
        self.sec = sec

    def invoke(self, name):
        time.sleep(self.sec)

    def describe(self):
        return f"delay({self.sec:g})"


class _Crash(_Action):
    def invoke(self, name):
        raise FailpointCrash(f"failpoint {name!r} injected crash")

    def describe(self):
        return "crash"


class _Prob(_Action):
    def __init__(self, p: float, inner: _Action):
        if not 0.0 <= p <= 1.0:
            raise FailpointSpecError(f"probability {p} outside [0, 1]")
        self.p = p
        self.inner = inner

    def fire(self, rng):
        # draw unconditionally so the RNG stream depends only on the hit
        # sequence, not on nested combinator state — replays stay aligned
        draw = rng.random()
        return draw < self.p and self.inner.fire(rng)

    def invoke(self, name):
        self.inner.invoke(name)

    def describe(self):
        return f"prob({self.p:g},{self.inner.describe()})"


class _Times(_Action):
    """Fire the inner spec for the first n EXECUTIONS, then go dormant."""

    def __init__(self, n: int, inner: _Action):
        if n < 0:
            raise FailpointSpecError(f"negative times count {n}")
        self.n = n
        self.done = 0
        self.inner = inner

    def fire(self, rng):
        if self.done >= self.n:
            return False
        if not self.inner.fire(rng):
            return False
        self.done += 1
        return True

    def invoke(self, name):
        self.inner.invoke(name)

    def describe(self):
        return f"times({self.n},{self.inner.describe()})"


class _Every(_Action):
    """Fire the inner spec on every nth matched hit (legacy
    ms_inject_socket_failures cadence)."""

    def __init__(self, n: int, inner: _Action):
        if n < 1:
            raise FailpointSpecError(f"every() needs n >= 1, got {n}")
        self.n = n
        self.count = 0
        self.inner = inner

    def fire(self, rng):
        self.count += 1
        return self.count % self.n == 0 and self.inner.fire(rng)

    def invoke(self, name):
        self.inner.invoke(name)

    def describe(self):
        return f"every({self.n},{self.inner.describe()})"


def _split_args(body: str) -> list[str]:
    """Split a combinator body on top-level commas only."""
    parts, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth < 0:
                raise FailpointSpecError(f"unbalanced parens in {body!r}")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth:
        raise FailpointSpecError(f"unbalanced parens in {body!r}")
    parts.append("".join(cur))
    return parts


def parse_spec(spec: str) -> _Action:
    """Parse one action spec string into a (stateful) action tree."""
    s = spec.strip()
    if not s:
        raise FailpointSpecError("empty failpoint spec")
    if "(" not in s:
        if s == "off":
            return _Off()
        if s == "error":
            return _Error()
        if s == "crash":
            return _Crash()
        raise FailpointSpecError(f"bad failpoint spec {s!r}")
    head, _, rest = s.partition("(")
    head = head.strip()
    if not rest.endswith(")"):
        raise FailpointSpecError(f"bad failpoint spec {s!r}")
    body = rest[:-1].strip()
    if head == "error":
        return _Error(body)
    if head == "delay":
        try:
            return _Delay(float(body))
        except ValueError as e:
            raise FailpointSpecError(f"bad delay {body!r}") from e
    args = _split_args(body)
    if len(args) != 2:
        raise FailpointSpecError(
            f"{head}() takes (arg, spec), got {len(args)} args in {s!r}"
        )
    inner = parse_spec(args[1])
    try:
        if head == "prob":
            return _Prob(float(args[0]), inner)
        if head == "times":
            return _Times(int(args[0]), inner)
        if head == "every":
            return _Every(int(args[0]), inner)
    except FailpointSpecError:
        raise
    except ValueError as e:
        raise FailpointSpecError(f"bad {head}() argument {args[0]!r}") from e
    raise FailpointSpecError(f"unknown combinator {head!r}")


# -- registry --------------------------------------------------------------
class _Entry:
    __slots__ = ("eid", "spec", "action", "match", "hits")

    def __init__(self, eid: int, spec: str, action: _Action,
                 match: dict | None):
        self.eid = eid
        self.spec = spec
        self.action = action
        self.match = dict(match) if match else None
        self.hits = 0

    def matches(self, ctx: dict) -> bool:
        if self.match is None:
            return True
        return all(ctx.get(k) == v for k, v in self.match.items())


class FailpointRegistry:
    """Process-wide named-failpoint table.  All combinator state and the
    RNG live behind one lock; effects (sleep/raise) run outside it."""

    def __init__(self, seed: int | None = None):
        self._lock = make_lock("failpoint::registry")
        self._entries: dict[str, list[_Entry]] = {}
        self._rng = random.Random(seed)
        self._next_id = 1

    # -- configuration ----------------------------------------------------
    def seed(self, n: int) -> None:
        """Reset the RNG driving prob() so a schedule replays bit-exactly
        (combined with re-arming the same specs in the same order)."""
        with self._lock:
            self._rng = random.Random(n)

    def set(self, name: str, spec: str, match: dict | None = None) -> int:
        """Replace this owner's assignment for `name` ("off" clears it).
        Ownership is the match dict: entries under the same name with a
        DIFFERENT match (another daemon's config, a thrasher netsplit)
        are left alone.  Returns the entry id (0 when cleared)."""
        action = parse_spec(spec)
        norm = dict(match) if match else None
        with self._lock:
            entries = [
                e for e in self._entries.get(name, []) if e.match != norm
            ]
            if not isinstance(action, _Off):
                e = _Entry(self._next_id, spec, action, norm)
                self._next_id += 1
                entries.append(e)
            else:
                e = None
            if entries:
                self._entries[name] = entries
            else:
                self._entries.pop(name, None)
            return e.eid if e else 0

    def add(self, name: str, spec: str, match: dict | None = None) -> int:
        """Append an entry (several matchers can coexist under one name —
        the netsplit shape).  Returns its id for targeted remove()."""
        action = parse_spec(spec)
        if isinstance(action, _Off):
            return 0
        with self._lock:
            e = _Entry(self._next_id, spec, action, match)
            self._next_id += 1
            self._entries.setdefault(name, []).append(e)
            return e.eid

    def remove(self, name: str, eid: int | None = None,
               match: dict | None = None) -> int:
        """Drop entries under `name`: all of them, one by id, or those
        whose match dict equals `match`.  Returns how many went."""
        with self._lock:
            entries = self._entries.get(name, [])
            if eid is None and match is None:
                self._entries.pop(name, None)
                return len(entries)
            keep = [
                e for e in entries
                if not ((eid is not None and e.eid == eid)
                        or (match is not None and e.match == match))
            ]
            removed = len(entries) - len(keep)
            if keep:
                self._entries[name] = keep
            else:
                self._entries.pop(name, None)
            return removed

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def configured(self, name: str) -> bool:
        return name in self._entries

    def list(self) -> dict[str, list[dict]]:
        """Serializable view (the admin-socket `failpoint list` payload)."""
        with self._lock:
            return {
                name: [
                    {
                        "id": e.eid,
                        "spec": e.spec,
                        "state": e.action.describe(),
                        "match": (
                            {k: str(v) for k, v in e.match.items()}
                            if e.match else None
                        ),
                        "hits": e.hits,
                    }
                    for e in entries
                ]
                for name, entries in sorted(self._entries.items())
            }

    # -- the hot path ------------------------------------------------------
    def hit(self, name: str, **ctx) -> None:
        """Evaluate a failpoint site.  The first matching entry whose
        action elects to fire performs its effect: error/crash raise,
        delay sleeps, off does nothing."""
        entries = self._entries.get(name)
        if not entries:
            return
        fired: _Action | None = None
        with self._lock:
            for e in entries:
                if not e.matches(ctx):
                    continue
                e.hits += 1
                if e.action.fire(self._rng):
                    fired = e.action
                    break
        if fired is not None:
            fired.invoke(name)


_registry = FailpointRegistry()


# The catalogue of every failpoint site the daemons mark — the single
# list docs/fault_injection.md's name table and the thrasher's arming
# code are held to.  cephlint CL4 (ceph_tpu/qa/analyzer) statically
# cross-checks sites <-> this set <-> the docs table, so adding a site
# without registering + documenting it fails tier-1.
KNOWN_FAILPOINTS = frozenset({
    "msgr.frame.send",
    "msgr.frame.recv",
    "osd.dispatch",
    "osd.ec.shard_read",
    "osd.write_batcher.flush",
    "osd.read_batcher.gather",
    "osd.recovery.push",
    "osd.recovery.pull",
    "osd.recovery.tick",
    "osd.scrub.start",
    "osd.scrub.shard",
    "osd.store.write_before_commit",
    "osd.store.write_after_commit",
    "mon.paxos.propose",
    "mon.paxos.commit",
    "mon.election.start",
    "mon.tick",
    "tpu.backend.probe",
    "storm.stub.recv",
})


def registry() -> FailpointRegistry:
    return _registry


def failpoint(name: str, **ctx) -> None:
    """Module-level site marker — `failpoint("osd.scrub.shard", ...)`."""
    _registry.hit(name, **ctx)


# -- Config integration ----------------------------------------------------
# Legacy scattered inject options, subsumed: option name -> (failpoint
# name, value -> spec).  The observer installed by bind_config() keeps the
# registry in step with the option, scoped to the owning context's hits.
LEGACY_OPTIONS = {
    "ms_inject_socket_failures": (
        "msgr.frame.send",
        lambda v: f"every({int(v)},error)" if int(v) else "off",
    ),
    "osd_debug_inject_read_err": (
        "osd.ec.shard_read",
        lambda v: "error" if v else "off",
    ),
    "osd_debug_inject_dispatch_delay": (
        "osd.dispatch",
        lambda v: f"delay({float(v)})" if float(v) > 0 else "off",
    ),
}


def parse_failpoint_option(value: str) -> list[tuple[str, str]]:
    """Validate a `failpoint` option string ("name=spec;name=spec") in
    full — every spec must parse — and return its (name, spec) pairs.
    Shared by the config observer and injectargs pre-validation so a bad
    spec can never take effect partially."""
    parts: list[tuple[str, str]] = []
    for part in (value or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, spec = part.partition("=")
        if not sep:
            raise FailpointSpecError(f"expected name=spec, got {part!r}")
        parse_spec(spec.strip())
        parts.append((name.strip(), spec.strip()))
    return parts


def bind_config(cct) -> None:
    """Route a context's config through the registry: the legacy inject
    options and the generic `failpoint` option, each scoped (via match)
    to hits tagged with this context.  Applies current values
    immediately, then tracks changes through the observer."""
    conf = cct.conf
    match = {"cct": cct}
    # names the `failpoint` option currently owns for this context — so a
    # later shorter option string retires exactly the names it armed
    # (legacy options share the match dict, so retired names re-sync
    # from any still-set legacy option below)
    option_owned: set[str] = set()

    def apply_failpoint_option(value: str) -> None:
        # validated in full before arming anything: a bad spec mid-list
        # must not leave earlier assignments armed but outside
        # option_owned (unretirable through the option)
        parts = parse_failpoint_option(value)
        seen = set()
        for name, spec in parts:
            _registry.set(name, spec, match=match)
            seen.add(name)
        for name in option_owned - seen:
            _registry.remove(name, match=match)
            # a legacy inject option may have replaced (same match) the
            # entry this name tracked; removing it above must not leave
            # that still-set option silently disarmed — re-sync it
            for opt, (fp_name, to_spec) in LEGACY_OPTIONS.items():
                if fp_name == name and opt in conf.table:
                    v = conf.get(opt)
                    if v != conf.table.get(opt).default:
                        _registry.set(fp_name, to_spec(v), match=match)
        option_owned.clear()
        option_owned.update(seen)

    def on_change(name: str, value) -> None:
        if name == "failpoint":
            apply_failpoint_option(value)
            return
        fp_name, to_spec = LEGACY_OPTIONS[name]
        _registry.set(fp_name, to_spec(value), match=match)

    names = [n for n in LEGACY_OPTIONS if n in conf.table] + ["failpoint"]
    conf.add_observer(names, on_change)
    for n in names:
        v = conf.get(n)
        if v != conf.table.get(n).default:
            on_change(n, v)


def unbind(cct) -> None:
    """Drop every registry entry this context's config installed (called
    from CephContext.shutdown so dead daemons don't leave armed
    failpoints behind)."""
    match = {"cct": cct}
    for name in list(_registry.list()):
        _registry.remove(name, match=match)


def apply_runtime_options(cct, pairs) -> dict:
    """Validated runtime config application — the injectargs core,
    shared by the admin-socket command and the QoS controller's
    MQoSSettings push (both are 'injectargs over a different
    transport').  Validates the WHOLE list (existence, runtime flag,
    value parse) before applying anything: a bad option mid-list must
    not leave the earlier ones silently applied behind an error."""
    pairs = [(name, value) for name, value in pairs]
    for name, value in pairs:
        opt = cct.conf.table.get(name)
        if not opt.runtime:
            raise ValueError(
                f"option {name!r} is not runtime-updatable"
            )
        opt.parse(value)
        if name == "failpoint":
            # opt.parse only checks it's a string; the observer
            # raising on a bad spec mid-apply would break the
            # nothing-applied-on-error contract
            parse_failpoint_option(value)
    return {
        name: cct.conf.set(name, value) for name, value in pairs
    }


def register_admin_commands(cct) -> None:
    """`failpoint set|add|rm|list|seed` + `injectargs` on a daemon's admin
    socket (reference: ceph's `ceph daemon ... config set` /
    injectargs)."""
    ask = cct.admin_socket
    match = {"cct": cct}

    def _fp_cmd(cmd: dict):
        sub = cmd.get("sub", "list")
        if sub == "list":
            return _registry.list()
        if sub == "seed":
            _registry.seed(int(cmd["seed"]))
            return {"seeded": int(cmd["seed"])}
        name = cmd.get("name", "")
        if not name:
            raise ValueError("failpoint name required")
        if sub == "set":
            eid = _registry.set(name, cmd.get("spec", "off"), match=match)
            return {name: cmd.get("spec", "off"), "id": eid}
        if sub == "add":
            eid = _registry.add(name, cmd.get("spec", "off"), match=match)
            return {name: cmd.get("spec", "off"), "id": eid}
        if sub == "rm":
            # scoped like set/add: retire THIS daemon's entry only, so an
            # operator's rm can't silently heal a thrasher netsplit or
            # another daemon's config-armed failpoint under the same name
            n = _registry.remove(name, match=match)
            return {"removed": n}
        raise ValueError(f"unknown failpoint subcommand {sub!r}")

    def _injectargs(cmd: dict):
        """`injectargs --name value [--name=value ...]`: runtime config
        application, the reference's `ceph daemon ... injectargs`."""
        argv = (cmd.get("args") or "").split()
        pairs: list[tuple[str, str]] = []
        i = 0
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("--"):
                raise ValueError(f"expected --option, got {arg!r}")
            body = arg[2:]
            if "=" in body:
                name, _, value = body.partition("=")
                i += 1
            else:
                name = body
                if i + 1 >= len(argv):
                    raise ValueError(f"--{name} needs a value")
                value = argv[i + 1]
                i += 2
            pairs.append((name.replace("-", "_"), value))
        return apply_runtime_options(cct, pairs)

    ask.register_command(
        "failpoint", _fp_cmd,
        "failpoint sub=set|add|rm|list|seed [name=<fp> spec=<spec>] "
        "[seed=<n>] — set/add/rm act on this daemon's entries",
    )
    ask.register_command(
        "injectargs", _injectargs,
        "injectargs args='--option value ...' (runtime options only)",
    )
