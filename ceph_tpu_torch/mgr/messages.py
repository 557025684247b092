"""Mgr wire messages (reference: src/messages/MMgrReport.h — daemons
stream perf-counter snapshots to the active mgr; MMgrOpen's session
handshake collapses into the report itself here)."""
from __future__ import annotations

from ..mon.messages import _JsonMessage
from ..msg.message import register_message


@register_message
class MMgrReport(_JsonMessage):
    """Daemon -> mgr perf snapshot.

    daemon: entity name ("osd.3"); counters: {subsystem: {name: value}}
    (the PerfCountersCollection dump); epoch: the daemon's map epoch so the
    mgr can spot laggards; stats: free-form daemon stats (pg counts,
    store bytes) for modules that want more than counters; schema:
    {subsystem: {name: {type, description}}} (PerfCountersCollection
    schema) so the prometheus exporter renders real HELP text and the
    right TYPE (counter/gauge/histogram) instead of guessing."""

    MSG_TYPE = 120
    FIELDS = ("daemon", "counters", "epoch", "stats", "schema")


@register_message
class MQoSSettings(_JsonMessage):
    """Mgr -> daemon QoS retune push (cephqos; docs/qos.md).

    Rides BACK over the connection the daemon's MMgrReport arrived on
    (no new dialing, no admin-socket dependency).  ``options`` is a
    {name: value} map applied through the daemon's injectargs core
    (validate-all-then-apply, runtime options only); ``classes`` maps
    an mClock class name — the cephmeter "client/pool" identity — to
    its [reservation, weight, limit]; ``qos_epoch`` is the controller's
    monotonically increasing push counter, so a stale/reordered push
    never rolls settings back."""

    MSG_TYPE = 122
    FIELDS = ("qos_epoch", "options", "classes")
