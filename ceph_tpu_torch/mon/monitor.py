"""Monitor daemon (reference: src/mon/Monitor.{h,cc}; SURVEY.md §2.5).

One Monitor = messenger + Elector + Paxos + PaxosServices (OSDMonitor).
The monmap is static for a cluster's lifetime (the reference can grow it;
vstart-style clusters here fix it at boot).  Peons forward nothing: a
command sent to a peon is NACKed with the leader's rank and the client
redials (the reference routes instead — same outcome, simpler machinery).

Subscriptions (reference: Monitor::handle_subscribe): a client subscribes
to "osdmap" from an epoch; every commit pushes the new full maps to all
subscribers.
"""
from __future__ import annotations

import queue
import threading
import time

from ..common.failpoint import FailpointCrash, failpoint
from ..common.lockdep import make_lock
from ..msg import Dispatcher, Messenger, MPing
from ..msg.messenger import POLICY_LOSSLESS_PEER
from ..osd.osdmap import OSDMap
from ..store.kv import KeyValueDB, MemKV
from .elector import Elector
from .messages import (
    MMonCommand,
    MMonCommandAck,
    MMonElection,
    MMonPaxos,
    MMonSubscribe,
    MOSDAlive,
    MOSDBoot,
    MOSDFailure,
    MOSDMapMsg,
)
from .osd_monitor import OSDMonitor

STATE_PROBING = "probing"
STATE_ELECTING = "electing"
STATE_LEADER = "leader"
STATE_PEON = "peon"


class MonMap:
    """reference: src/mon/MonMap.h — name → rank (sorted) + address, plus
    the cluster fsid that fences off foreign-cluster daemons."""

    def __init__(self, addrs: dict[str, tuple[str, int]], fsid: str | None = None):
        import uuid

        self.addrs = dict(addrs)
        self._names = sorted(addrs)  # rank order = sorted names
        self.fsid = fsid or str(uuid.uuid4())

    def ranks(self) -> list[int]:
        return list(range(len(self._names)))

    def name_of(self, rank: int) -> str:
        return self._names[rank]

    def rank_of(self, name: str) -> int | None:
        try:
            return self._names.index(name)
        except ValueError:
            return None

    def addr_of(self, rank: int) -> tuple[str, int]:
        return self.addrs[self._names[rank]]

    def size(self) -> int:
        return len(self._names)


class Monitor(Dispatcher):
    def __init__(
        self,
        cct,
        name: str,  # bare mon name, e.g. "a"
        monmap: MonMap,
        store: KeyValueDB | None = None,
        initial_osdmap: OSDMap | None = None,
    ):
        self.cct = cct
        self.name = name
        self.monmap = monmap
        rank = monmap.rank_of(name)
        if rank is None:
            raise ValueError(f"mon {name!r} not in monmap")
        self.rank = rank
        self.store = store if store is not None else MemKV()
        self.state = STATE_PROBING
        self.leader_rank: int | None = None
        self.quorum: list[int] = []
        self.messenger = Messenger.create(cct, f"mon.{name}")
        self.messenger.default_policy = POLICY_LOSSLESS_PEER
        self.messenger.add_dispatcher(self)
        self.messenger.auth_gen_provider = lambda: (
            self.osdmon.osdmap.auth_gens.get("mon", 1)
            if getattr(self, "osdmon", None) is not None
            and self.osdmon.osdmap is not None else 1
        )
        self.messenger.bind(monmap.addr_of(rank))
        self.elector = Elector(self)
        from .paxos import Paxos

        self.paxos = Paxos(self, self.store)
        self.osdmon = OSDMonitor(self, initial_osdmap)
        # conn -> next osdmap epoch wanted
        self._subs: dict[object, int] = {}
        self._subs_lock = make_lock("mon::subs")
        # (client, session, tid) -> completed command result, so a retried
        # command (ack lost / slow proposal) is answered, not re-executed
        self._cmd_results: dict[tuple, tuple[int, object]] = {}
        self._cmd_inflight: set[tuple] = set()
        self._cmd_lock = make_lock("mon::cmd")
        # All cross-connection sends go through sender threads.  Paxos
        # and elector handlers run on connection reader threads (holding
        # that connection's session lock) and take subsystem locks; if
        # those subsystems also sent directly while holding their locks,
        # the two lock orders would deadlock (session→subsystem vs
        # subsystem→session).  Queueing breaks the cycle.  One queue+thread
        # PER PEER (plus one for subscriber publishes): a single shared
        # sender dialing a dead-but-not-refusing peer would stall every
        # queued election/paxos message behind a 10 s connect timeout,
        # livelocking quorum formation (advisor r1 finding).
        self._sendqs: dict[object, "queue.Queue"] = {}
        self._send_threads: list[threading.Thread] = []
        self._sendq_lock = make_lock("mon::sendq")
        # serializes election-outcome state writes against shutdown's
        # reset: win/lose_election (reader threads) vs shutdown
        self._state_lock = make_lock("mon::state")
        self._tick_thread: threading.Thread | None = None
        self._stop_event = threading.Event()

    @property
    def _stopped(self) -> bool:
        return self._stop_event.is_set()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.messenger.start()
        self.elector.start_election()
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name=f"mon.{self.name}-tick", daemon=True
        )
        self._tick_thread.start()

    def shutdown(self) -> None:
        self._stop_event.set()
        # a stopped mon must not keep reporting itself leader: harness
        # code (LocalCluster._leader) and peers probing state would
        # otherwise keep consulting a corpse's stale map view.  Under
        # _state_lock AFTER setting the stop event: an election outcome
        # that raced past the event check holds the lock while writing,
        # so this reset strictly follows it — and any later outcome sees
        # the event and returns
        with self._state_lock:
            self.state = STATE_PROBING
            self.leader_rank = None
        try:
            self.elector.stop()
        except Exception as e:
            self.cct.dout("mon", 0,
                          f"mon.{self.name} elector stop raised "
                          f"(continuing teardown): {e!r}")
        with self._sendq_lock:
            for q in self._sendqs.values():
                q.put(None)
            threads = list(self._send_threads)
        if (self._tick_thread is not None
                and self._tick_thread is not threading.current_thread()):
            # current_thread guard: an injected tick crash shuts the mon
            # down from the tick thread itself (joining self raises).
            # Joined BEFORE the messenger goes away: the tick loop
            # sends through it (teardown reverses bring-up)
            self._tick_thread.join(timeout=5)
        try:
            self.messenger.shutdown()
        except Exception as e:
            self.cct.dout("mon", 0,
                          f"mon.{self.name} messenger shutdown raised: "
                          f"{e!r}")
        for t in threads:
            t.join(timeout=5)
        close = getattr(self.store, "close", None)
        if close:
            try:
                close()
            except Exception as e:
                self.cct.dout("mon", 0,
                              f"mon.{self.name} store close raised: {e!r}")
        # the context goes last: its admin socket serves debug commands
        # right up until the daemon is gone
        self.cct.shutdown()

    def _sendq_for(self, key) -> "queue.Queue":
        """Per-peer (or 'publish') queue, sender thread created lazily."""
        with self._sendq_lock:
            q = self._sendqs.get(key)
            if q is None:
                q = queue.Queue()
                if self._stopped:
                    # racing with shutdown(): park messages in a dead queue
                    # instead of spawning a thread nobody will ever join
                    return q
                self._sendqs[key] = q
                t = threading.Thread(
                    target=self._send_loop, args=(key, q),
                    name=f"mon.{self.name}-send-{key}", daemon=True,
                )
                self._send_threads.append(t)
                t.start()
            return q

    def _send_loop(self, key, q: "queue.Queue") -> None:
        while True:
            try:
                # bounded wait: a mon killed without draining its send
                # queues (thrasher hard-kill) never enqueues the None
                # sentinel, and an unbounded get() would leak this
                # thread; the timeout re-checks _stopped instead
                item = q.get(timeout=5.0)
            except queue.Empty:
                if self._stopped:
                    return
                continue
            if item is None or self._stopped:
                return
            try:
                if key == "publish":
                    self._publish_osdmap_now()
                else:
                    self.messenger.connect(
                        self.monmap.addr_of(key)
                    ).send_message(item)
            except (OSError, ConnectionError):
                pass  # elections / paxos timeouts handle the silence
            except Exception as e:
                self.cct.dout("mon", 0, f"mon.{self.name} send failed: {e!r}")

    def _tick_loop(self) -> None:
        interval = self.cct.conf.get("mon_tick_interval")
        while not self._stop_event.wait(interval):
            if self._stopped:
                return
            try:
                self.tick()
            except FailpointCrash:
                # injected daemon death: a dead tick loop alone would
                # leave a ZOMBIE that still answers election proposes
                # (and, as lowest rank, keeps winning while never
                # driving maps) — take the whole mon down so the quorum
                # genuinely re-forms without it
                self.cct.dout("mon", 0,
                              f"mon.{self.name} crashed (injected)")
                try:
                    self.shutdown()
                except Exception as e:
                    self.cct.dout("mon", 0,
                                  f"mon.{self.name} crash-shutdown "
                                  f"raised: {e!r}")
                return
            except Exception as e:
                self.cct.dout("mon", 0, f"mon.{self.name} tick failed: {e!r}")

    def tick(self) -> None:
        # "mon.tick": delay simulates a stalled mon (missed lease-probe
        # windows); error skips the tick via _tick_loop's handler
        failpoint("mon.tick", cct=self.cct, entity=f"mon.{self.name}")
        # one consistent snapshot under mon::state — the tick thread
        # racing election-outcome writes read state/leader_rank unlocked
        # (cephrace CR1 Monitor.leader_rank)
        with self._state_lock:
            state, leader_rank = self.state, self.leader_rank
        if state == STATE_LEADER:
            self.osdmon.tick()
        elif state == STATE_PEON and leader_rank is not None:
            # leader liveness probe: a dead leader triggers re-election
            # (reference: peons' lease timeout; SURVEY.md §5.3)
            try:
                conn = self.messenger.connect(
                    self.monmap.addr_of(leader_rank)
                )
                conn.send_message(MPing("leader-probe"))
            except (OSError, ConnectionError):
                self.cct.dout("mon", 1, f"mon.{self.name}: leader unreachable")
                self.elector.start_election()

    # -- election plumbing (Elector callbacks) ----------------------------
    def majority(self) -> int:
        return self.monmap.size() // 2 + 1

    def other_ranks(self) -> list[int]:
        return [r for r in self.monmap.ranks() if r != self.rank]

    def rank_of(self, entity_name: str) -> int | None:
        if not entity_name.startswith("mon."):
            return None
        return self.monmap.rank_of(entity_name[4:])

    def set_electing(self) -> None:
        # every other state write serializes under mon::state; this one
        # ran bare (under only the elector's lock) until cephrace caught
        # it racing an is_leader probe
        with self._state_lock:
            self.state = STATE_ELECTING

    def win_election(self, epoch: int, quorum: list[int]) -> None:
        with self._state_lock:
            # a victory dispatched on a reader thread mid-shutdown must
            # not resurrect the corpse as leader: shutdown sets the stop
            # event BEFORE taking this lock for its reset, so either we
            # see the event here, or our writes land before the reset
            if self._stop_event.is_set():
                return
            self.state = STATE_LEADER
            self.leader_rank = self.rank
            self.quorum = quorum
        self.cct.dout(
            "mon", 1, f"mon.{self.name} won election epoch {epoch}, quorum {quorum}"
        )
        # leader_init blocks on the collect round; run it off the elector's
        # calling thread (often a reader holding a session lock)
        threading.Thread(  # noqa: CL13 — fire-and-forget by design: leader_init must leave the elector's reader thread (session-lock order) and checks _stopped itself
            target=self._leader_init_async, args=(epoch,),
            name=f"mon.{self.name}-leader-init", daemon=True,
        ).start()

    def _leader_init_async(self, epoch: int) -> None:
        try:
            if self.paxos.leader_init() and self.is_leader():
                self.osdmon.refresh()
                self.osdmon.on_elected_leader()
                self.publish_osdmap()
        except Exception as e:
            self.cct.dout("mon", 0, f"leader init failed: {e!r}")

    def lose_election(self, epoch: int, leader: int, quorum: list[int]) -> None:
        with self._state_lock:
            if self._stop_event.is_set():
                return
            self.state = STATE_PEON
            self.leader_rank = leader
            self.quorum = quorum

    def is_leader(self) -> bool:
        # under mon::state: election outcomes and shutdown write state
        # under this lock, and an unlocked probe here was the first race
        # cephrace caught in a live run (CR1 Monitor.state)
        with self._state_lock:
            return self.state == STATE_LEADER

    def send_mon(self, rank: int, msg) -> None:
        """Queue a message to a peer mon; safe to call while holding any
        subsystem lock (the sender thread does the socket work)."""
        if hasattr(msg, "fsid"):
            msg.fsid = self.monmap.fsid
        self._sendq_for(rank).put(msg)

    # -- paxos callback ----------------------------------------------------
    def on_paxos_commit(self, version: int) -> None:
        self.osdmon.refresh()
        self.publish_osdmap()

    # -- subscriptions -----------------------------------------------------
    def publish_osdmap(self) -> None:
        """Queue a push of new epochs to subscribers (runs on the sender
        thread — callers may hold the paxos lock)."""
        self._sendq_for("publish").put(True)

    def _publish_osdmap_now(self) -> None:
        cur = self.osdmon.epoch
        if cur == 0:
            return
        with self._subs_lock:
            subs = list(self._subs.items())
        for conn, want in subs:
            if want > cur:
                continue
            maps = {}
            for e in range(want, cur + 1):
                j = self.osdmon.get_map_json(e)
                if j is not None:
                    maps[str(e)] = j
            if not maps:
                continue
            try:
                conn.send_message(MOSDMapMsg(maps=maps))
                with self._subs_lock:
                    if conn in self._subs:
                        self._subs[conn] = cur + 1
            except (OSError, ConnectionError):
                with self._subs_lock:
                    self._subs.pop(conn, None)

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, (MMonElection, MMonPaxos)):
            # fsid fence: a zombie mon of another cluster incarnation that
            # reconnects to a reused port must not poison elections/paxos
            # (reference: every daemon checks the cluster fsid)
            if msg.fsid != self.monmap.fsid:
                return True
        if isinstance(msg, MMonElection):
            self.elector.handle(conn, msg)
        elif isinstance(msg, MMonPaxos):
            self.paxos.handle(conn, msg)
        elif isinstance(msg, MMonCommand):
            self._handle_command(conn, msg)
        elif isinstance(msg, MMonSubscribe):
            self._handle_subscribe(conn, msg)
        elif isinstance(msg, MOSDBoot):
            if self.is_leader():
                self.osdmon.handle_boot(msg.osd, (msg.host, msg.port))
            else:
                self._forward_to_leader(msg)
        elif isinstance(msg, MOSDFailure):
            # pin the original reporter before any peon→leader forward so
            # corroboration counts distinct OSDs, not forwarding mons
            if not msg.reporter:
                msg.reporter = msg.src
            if self.is_leader():
                self.osdmon.handle_failure(msg.target, msg.reporter)
            else:
                self._forward_to_leader(msg)
        elif isinstance(msg, MOSDAlive):
            # same reporter pinning + leader routing as MOSDFailure: the
            # retraction must drain the LEADER's corroboration set, and
            # must count as the original OSD, not a forwarding peon
            if not msg.reporter:
                msg.reporter = msg.src
            if self.is_leader():
                self.osdmon.handle_alive(msg.target, msg.reporter)
            else:
                self._forward_to_leader(msg)
        elif isinstance(msg, MPing):
            pass
        else:
            return False
        return True

    def _forward_to_leader(self, msg) -> None:
        """Peons route daemon reports to the leader (reference: Monitor
        forward_request_leader).  Payload fields carry everything the
        OSDMonitor needs (incl. MOSDFailure.reporter, pinned above), so a
        fresh message with copied fields is a faithful forward."""
        with self._state_lock:
            leader = self.leader_rank
        if leader is None or leader == self.rank:
            return
        fresh = type(msg)(**{f: getattr(msg, f) for f in msg.FIELDS})
        self.send_mon(leader, fresh)

    def ms_handle_reset(self, conn) -> None:
        with self._subs_lock:
            self._subs.pop(conn, None)

    def _handle_subscribe(self, conn, msg: MMonSubscribe) -> None:
        what = msg.what or {}
        if "osdmap" in what:
            with self._subs_lock:
                self._subs[conn] = int(what["osdmap"]) or 1
            self.publish_osdmap()

    # -- commands ----------------------------------------------------------
    def _handle_command(self, conn, msg: MMonCommand) -> None:
        cmd = msg.cmd or {}
        prefix = cmd.get("prefix", "")
        # dedup key includes the per-client random session id: two client
        # processes sharing the default entity name ('client.admin') and
        # tid counters starting at 0 must not collide (advisor r1 finding)
        key = (msg.src, msg.session, msg.tid)
        with self._cmd_lock:
            done = self._cmd_results.get(key)
            if done is None and key in self._cmd_inflight:
                return  # retry of a command still executing; first ack wins
            if done is None:
                self._cmd_inflight.add(key)
        if done is not None:
            try:
                conn.send_message(
                    MMonCommandAck(tid=msg.tid, retval=done[0], result=done[1])
                )
            except (OSError, ConnectionError):
                pass
            return
        # answerable by any mon, quorum or not
        if prefix == "mon stat":
            retval, result = 0, {
                "name": self.name, "rank": self.rank, "state": self.state,
                "leader": self.leader_rank, "quorum": self.quorum,
                "monmap": {
                    n: list(a) for n, a in self.monmap.addrs.items()
                },
            }
        elif not self.is_leader():
            retval, result = -307, {
                "error": "not leader",
                "leader": self.leader_rank,
                "leader_addr": (
                    list(self.monmap.addr_of(self.leader_rank))
                    if self.leader_rank is not None else None
                ),
            }
        elif prefix in ("status", "health", "health detail"):
            # `health detail` is the same payload — checks carry their
            # `detail` lines always; the CLI decides how much to render
            retval, result = 0, self._status()
        elif self.osdmon.osdmap is None:
            # elected but the initial map hasn't committed yet
            retval, result = -11, "cluster still forming, retry"
        elif prefix.startswith("config-key ") \
                or prefix.startswith("config "):
            try:
                retval, result = self._handle_config_command(cmd)
            except Exception as e:
                self.cct.dout("mon", 0, f"command {prefix!r} failed: {e!r}")
                retval, result = -22, f"command failed: {e}"
        else:
            try:
                retval, result = self.osdmon.handle_command(cmd)
            except Exception as e:
                self.cct.dout("mon", 0, f"command {prefix!r} failed: {e!r}")
                retval, result = -22, f"command failed: {e}"
        with self._cmd_lock:
            self._cmd_inflight.discard(key)
            # transient NACKs aren't final results; let retries re-run
            if retval not in (-307, -11):
                self._cmd_results[key] = (retval, result)
                while len(self._cmd_results) > 256:
                    self._cmd_results.pop(next(iter(self._cmd_results)))
        try:
            conn.send_message(
                MMonCommandAck(tid=msg.tid, retval=retval, result=result)
            )
        except (OSError, ConnectionError):
            pass

    # -- central config + config-key store (reference: MonMonmap-era
    # ConfigMonitor src/mon/ConfigMonitor.cc and the config-key KV of
    # src/mon/ConfigKeyService.cc; both paxos-replicated) --------------
    _CFG_SECTIONS = ("global", "mon", "osd", "mds", "mgr", "client")

    def _handle_config_command(self, cmd: dict) -> tuple[int, object]:
        prefix = cmd.get("prefix", "")
        if prefix == "config-key set":
            key = cmd.get("key", "")
            if not key:
                return -22, "key required"
            val = cmd.get("val", "")
            ok = self.paxos.propose([(1, f"ck/{key}",
                                      str(val).encode())])
            return (0, f"set {key}") if ok else (-110, "timed out")
        if prefix == "config-key get":
            v = self.store.get(f"ck/{cmd.get('key', '')}")
            return (0, v.decode()) if v is not None else (-2, "no key")
        if prefix == "config-key rm":
            ok = self.paxos.propose([(2, f"ck/{cmd.get('key', '')}",
                                      b"")])
            return (0, "removed") if ok else (-110, "timed out")
        if prefix == "config-key ls":
            return 0, sorted(
                k[len("ck/"):] for k, _v in self.store.iterate("ck/"))
        if prefix == "config-key exists":
            v = self.store.get(f"ck/{cmd.get('key', '')}")
            return (0, "exists") if v is not None else (-2, "no key")
        if prefix == "config set":
            who = cmd.get("who", "")
            name = cmd.get("name", "")
            base = who.split(".", 1)[0]
            if base not in self._CFG_SECTIONS:
                return -22, f"bad section {who!r}"
            try:
                self.cct.conf.table.get(name)
            except KeyError:
                return -2, f"unknown option {name!r}"
            ok = self.paxos.propose([
                (1, f"config/{who}/{name}",
                 str(cmd.get("value", "")).encode()),
            ])
            return (0, f"{who}/{name} set") if ok \
                else (-110, "timed out")
        if prefix == "config rm":
            ok = self.paxos.propose([
                (2, f"config/{cmd.get('who', '')}/"
                    f"{cmd.get('name', '')}", b""),
            ])
            return (0, "removed") if ok else (-110, "timed out")
        if prefix == "config dump":
            out = []
            for k, v in self.store.iterate("config/"):
                who, _, name = k[len("config/"):].rpartition("/")
                out.append({"section": who, "name": name,
                            "value": v.decode()})
            return 0, sorted(out, key=lambda e: (e["section"],
                                                 e["name"]))
        if prefix == "config get":
            # entity view: global < type section < exact daemon id —
            # the same precedence the daemon applies at boot
            who = cmd.get("who", "")
            base = who.split(".", 1)[0]
            out: dict[str, str] = {}
            for section in ("global", base, who):
                if not section:
                    continue
                for k, v in self.store.iterate(f"config/{section}/"):
                    out[k.rsplit("/", 1)[1]] = v.decode()
            return 0, out
        return -95, f"unknown config command {prefix!r}"

    def _status(self) -> dict:
        """reference: `ceph -s` (src/mon/Monitor.cc get_cluster_status +
        health checks from src/mon/health_check.h)."""
        osd = self.osdmon._stat()
        checks = {}
        m = self.osdmon.osdmap
        if m is not None:
            down = [
                o for o in range(m.max_osd)
                if m.exists(o) and not m.is_up(o)
            ]
            if down:
                checks["OSD_DOWN"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"{len(down)} osds down",
                    "osds": down,
                }
            if m.flags & {"noout", "nodown", "noup"}:
                checks["OSDMAP_FLAGS"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"flags {sorted(m.flags)} set",
                }
            full = sorted(
                p.name for p in m.pools.values()
                if "full_quota" in getattr(p, "flags", ())
            )
            if full:
                # reference: POOL_FULL health check from pool quota flags
                checks["POOL_FULL"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"{len(full)} pool(s) reached quota: "
                               f"{', '.join(full)}",
                    "pools": full,
                }
            untagged = sorted(
                p.name for p in m.pools.values()
                if not p.application and p.tier_of < 0
            )
            if untagged:
                # reference: POOL_APP_NOT_ENABLED (mgr health checks) —
                # cache tiers inherit their base pool's application
                checks["POOL_APP_NOT_ENABLED"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"{len(untagged)} pool(s) have no "
                               f"application enabled: "
                               f"{', '.join(untagged)}",
                    "pools": untagged,
                }
            no_rep = sorted(
                p.name for p in m.pools.values()
                if sum(1 for o in range(m.max_osd)
                       if m.exists(o) and m.is_up(o) and m.is_in(o))
                < p.min_size
            )
            if no_rep:
                # reference: PG_AVAILABILITY — too few live OSDs to meet
                # a pool's write quorum anywhere
                checks["PG_AVAILABILITY"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"{len(no_rep)} pool(s) below min_size "
                               f"capacity: {', '.join(no_rep)}",
                    "pools": no_rep,
                }
        # usage + pg-state summary from the mgr digest, when one has
        # arrived (reference: `ceph -s` data/pgs sections via PGMap)
        usage = {}
        pgs_by_state: dict[str, int] = {}
        progress_out: dict | None = None
        ts_digest = getattr(self.osdmon, "mgr_digest", None)
        # a dead mgr's last digest must not masquerade as current
        # forever: past the stale-report age, drop the sections (the
        # missing lines in `ceph -s` ARE the signal the mgr is gone)
        max_age = self.cct.conf.get("mgr_stale_report_age")
        if ts_digest is not None \
                and time.monotonic() - ts_digest[0] <= max_age:
            digest = ts_digest[1]
            slow = digest.get("slow_ops") or {}
            if slow:
                # reference: the SLOW_OPS health warning from optracker
                # complaint counts streamed through the mgr.  The count
                # is the OSDs' STICKY count (in-flight + recently
                # completed slow), and the detail lines name each op's
                # dominant stage (cephmeter forensics)
                n = sum(slow.values())
                slow_detail = digest.get("slow_ops_detail") or {}
                checks["SLOW_OPS"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"{n} slow ops on "
                               f"{', '.join(sorted(slow))}",
                    "daemons": sorted(slow),
                    "detail": [
                        f"{d}: {line}"
                        for d in sorted(slow)
                        for line in (slow_detail.get(d) or [])
                    ][:12],
                }
            backend = digest.get("backend_health") or {}
            deg = sorted(
                d for d, bh in backend.items()
                if (bh.get("sentinel") or {}).get("state") == "degraded"
            )
            if deg:
                # the accelerator analog of DEVICE_HEALTH: the backend
                # sentinel latched `degraded` on these daemons — kernels
                # are being served by the fallback path, perf numbers
                # reflect the fallback silicon (docs/observability.md)
                checks["TPU_BACKEND_DEGRADED"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"device backend degraded on "
                               f"{len(deg)} daemon(s): "
                               f"{', '.join(deg)}",
                    "daemons": deg,
                    "detail": [
                        f"{d}: "
                        f"{(backend[d].get('sentinel') or {}).get('reason')}"
                        f" (since "
                        f"{(backend[d].get('sentinel') or {}).get('since')})"
                        for d in deg
                    ],
                }
            latched = sorted(d for d, bh in backend.items()
                             if bh.get("fallback"))
            if latched:
                # a codec latched a kernel fallback (the reference's
                # one-shot Pallas -> XLA downgrade; the port's codecs
                # record none): alert until cleared (clear_kernel_fallback)
                details = []
                for d in latched:
                    for kern, rec in sorted(
                            (backend[d].get("fallback") or {}).items()):
                        details.append(
                            f"{d}: {kern} {rec.get('from')} -> "
                            f"{rec.get('to')} ({rec.get('reason')})")
                checks["KERNEL_FALLBACK_LATCHED"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"kernel fallback latched on "
                               f"{len(latched)} daemon(s): "
                               f"{', '.join(latched)}",
                    "daemons": latched,
                    "detail": details,
                }
            # cephheal: degraded-redundancy + stalled-recovery checks
            # from the pg_info counts and the progress-module snapshot
            # the digest now carries (docs/observability.md)
            pg_info = digest.get("pg_info") or {}
            deg_pgs = {
                pgid: int(info.get("degraded") or 0)
                for pgid, info in pg_info.items()
                if int(info.get("degraded") or 0) > 0
            }
            if deg_pgs:
                # reference: PG_DEGRADED ("Degraded data redundancy")
                total_deg = sum(deg_pgs.values())
                worst = sorted(deg_pgs.items(), key=lambda kv: -kv[1])
                checks["PG_DEGRADED"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"Degraded data redundancy: "
                               f"{total_deg} object copies degraded, "
                               f"{len(deg_pgs)} pg(s) degraded",
                    "pgs": sorted(deg_pgs),
                    "detail": [
                        f"pg {pgid} is degraded ({n} object copies)"
                        for pgid, n in worst[:6]
                    ],
                }
            prog = digest.get("progress") or {}
            stalled = prog.get("stalled") or []
            failing = prog.get("failing") or {}
            if stalled or failing:
                # recovery is owed (degraded > 0) but the drain rate is
                # ~zero past the grace, or a PG's recovery pass raises
                # every tick — either way the self-heal plane is stuck,
                # which a degraded count alone cannot distinguish from
                # slow-but-progressing recovery
                names = sorted({e["pgid"] for e in stalled}
                               | set(failing))
                detail = [
                    f"pg {e['pgid']}: {e['degraded']} object copies "
                    f"degraded, no progress for {e['stalled_for']}s"
                    for e in stalled[:6]
                ] + [
                    f"pg {pgid}: recovery failing on {rec.get('daemon')}"
                    f" ({rec.get('count')} consecutive ticks): "
                    f"{rec.get('error')}"
                    for pgid, rec in sorted(failing.items())[:6]
                ]
                checks["RECOVERY_STALLED"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"recovery stalled on {len(names)} "
                               f"pg(s): {', '.join(names[:8])}",
                    "pgs": names,
                    "detail": detail,
                }
            if prog.get("events") is not None:
                progress_out = {
                    "events": prog.get("events") or [],
                    "stalled": stalled,
                }
            # cephplace: data-distribution imbalance from the placement
            # module's skew snapshot — raised only while the balancer is
            # idle or off (an active balancer mid-convergence would just
            # flap the check), cleared when deviations converge under
            # mgr_placement_max_deviation
            pl = digest.get("placement") or {}
            imbalanced = pl.get("imbalanced") or []
            if imbalanced and not pl.get("balancer_busy"):
                names = [e.get("pool") for e in imbalanced]
                thr = pl.get("max_deviation_threshold")
                checks["PG_IMBALANCE"] = {
                    "severity": "HEALTH_WARN",
                    "message": f"{len(imbalanced)} pool(s) exceed the "
                               f"placement deviation bound ({thr} PG "
                               f"shards) with an idle balancer: "
                               f"{', '.join(map(str, names))}",
                    "pools": names,
                    "detail": [
                        f"pool {e.get('pool')!r}: max deviation "
                        f"{e.get('max_deviation')} PG shards (stddev "
                        f"{e.get('stddev')}, score {e.get('score')})"
                        for e in imbalanced[:6]
                    ],
                }
            st = (digest.get("df") or {}).get("stats") or {}
            usage = {
                "total_bytes": st.get("total_bytes", 0),
                "total_used_raw_bytes": st.get("total_used_raw_bytes", 0),
                "total_avail_bytes": st.get("total_avail_bytes", 0),
            }
            for info in (digest.get("pg_info") or {}).values():
                s = info.get("state", "unknown")
                pgs_by_state[s] = pgs_by_state.get(s, 0) + 1
        return {
            "health": {
                "status": "HEALTH_WARN" if checks else "HEALTH_OK",
                "checks": checks,
            },
            "quorum": self.quorum,
            "leader": self.leader_rank,
            "osdmap": osd,
            "usage": usage,
            "pgs_by_state": pgs_by_state,
            # cephheal: in-flight recovery events for the `ceph status`
            # one-line progress bar (None = no progress data yet)
            "progress": progress_out,
            "paxos": {
                "version": self.paxos.last_committed,
                "pn": self.paxos.accepted_pn,
            },
        }
