"""The port's copies of the reference's runtime modules (common/ and
osd/read_cache.py), on the CPU: the option table is the reference's
whole, each package keeps its own failpoint registry, the read cache
answers a scenario as the reference's does, and the two parts that
changed — the tracer's device profiling (torch.profiler and NVTX in
place of jax.profiler) and the sentinel's per-device probe — work
without a card.
"""
import json

import pytest

from ceph_tpu.common import failpoint as ref_failpoint
from ceph_tpu.common.options import default_options as ref_options
from ceph_tpu.common.throttle import Throttle as RefThrottle
from ceph_tpu.osd.read_cache import ReadCache as RefReadCache
from ceph_tpu_torch.common import failpoint, kernel_telemetry
from ceph_tpu_torch.common.context import CephContext
from ceph_tpu_torch.common.options import default_options
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.common.tracer import TRACER, device_trace, kernel_annotation
from ceph_tpu_torch.osd.read_cache import ReadCache


def test_option_table_is_the_references():
    ours, theirs = default_options(), ref_options()
    names = sorted(theirs.names())
    assert sorted(ours.names()) == names
    for name in names:
        a, b = ours.get(name), theirs.get(name)
        assert (a.type, a.default, a.runtime) == (b.type, b.default, b.runtime), name


def test_failpoint_registries_are_separate():
    """Arming the port's registry leaves the reference's alone, and the
    port's site raises the port's own error."""
    failpoint.registry().clear()
    ref_failpoint.registry().clear()
    try:
        failpoint.registry().set("osd.write_batcher.flush", "times(1,error)")
        ref_failpoint.failpoint("osd.write_batcher.flush")  # not armed there
        with pytest.raises(failpoint.FailpointError):
            failpoint.failpoint("osd.write_batcher.flush")
        failpoint.failpoint("osd.write_batcher.flush")  # times(1) spent
    finally:
        failpoint.registry().clear()


def _cache_scenario(cls):
    """The reference test's read-cache scenario; every answer in order."""
    seen = []
    cache = cls(max_bytes=256)
    key = ("1.0", "a")
    seen += [cache.enabled(), cache.get(key, 5)]
    cache.put(key, 5, b"v5" * 8, 16)
    seen += [cache.get(key, 5), cache.get(key, 6), cache.get(key, 5)]
    cache.put(key, 6, b"v6" * 8, 16)
    seen.append(cache.get(key, None))
    cache.put(key, 6, b"v6" * 8, 16)
    cache.put(key, None, b"x", 1)
    cache.put(("1.0", "big"), 1, b"z" * 512, 512)
    seen.append(cache.stats()["entries"])
    cache.invalidate(key)
    seen += [cache.get(key, 6), cache.stats()]
    cache = cls(max_bytes=200)
    for oid in "xy":
        cache.put(("p", oid), 1, oid.encode() * 100, 100)
    seen.append(cache.get(("p", "x"), 1))
    cache.put(("p", "z"), 1, b"z" * 100, 100)
    seen += [cache.get(("p", "y"), 1), cache.get(("p", "x"), 1), cache.stats()]
    cache.set_max_bytes(0)
    seen += [cache.enabled(), cache.stats()]
    return seen


def test_read_cache_matches_reference():
    assert _cache_scenario(ReadCache) == _cache_scenario(RefReadCache)


def test_throttle_matches_reference():
    seen = []
    for cls in (Throttle, RefThrottle):
        t = cls("t", 10)
        seen.append([t.get_or_fail(6), t.get_or_fail(6), t.current, t.get(4, timeout=0.1),
                     t.current, t.put(10), t.current])
    assert seen[0] == seen[1]


def test_kernel_annotation_and_device_trace_on_the_cpu(tmp_path):
    """With tracing on, a kernel launch sits in a named torch.profiler
    range (``cephtrace:<name>#trace=<id>+<more>``); device_trace writes a
    Chrome trace holding it.  With tracing off the annotation is null."""
    import torch

    was = TRACER.enabled
    TRACER.enable(True)
    try:
        with device_trace(str(tmp_path)):
            with kernel_annotation("ec_encode_inline", ["t1", "t2"]):
                torch.ones(4).sum()
    finally:
        TRACER.enable(was)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "cephtrace:ec_encode_inline#trace=t1+1" in names
    TRACER.enable(False)
    try:
        with kernel_annotation("off"):
            pass
    finally:
        TRACER.enable(was)


def test_sentinel_probe_without_a_card(monkeypatch):
    """The probe names the CUDA runtime's state; the per-device rows have
    one row per CUDA device, or one ``cpu:0`` row without a card (the
    device the daemons run on then); the forced state synthesizes."""
    import torch

    want = "cuda" if torch.cuda.is_available() else "cpu"
    monkeypatch.delenv("CEPH_TPU_SENTINEL_STATE", raising=False)
    assert kernel_telemetry.default_probe() == want
    rows = kernel_telemetry.probe_device_rows()
    n = torch.cuda.device_count()
    assert [r["device"] for r in rows] == (
        [f"cuda:{i}" for i in range(n)] if n else ["cpu:0"])
    assert all(r["ok"] for r in rows)
    monkeypatch.setenv("CEPH_TPU_SENTINEL_STATE", "degraded:test wedge")
    with pytest.raises(RuntimeError, match="test wedge"):
        kernel_telemetry.default_probe()
    assert kernel_telemetry.probe_device_rows()[0]["ok"] is False


def test_context_admin_commands_without_the_fallback_latch(tmp_path):
    """The port's context serves the reference's admin surface minus
    ``clear_kernel_fallback``: the port has no fallback to clear."""
    from ceph_tpu.common.context import CephContext as RefContext

    conf = {"ec_batch_window_ms": 5.0}
    cct = CephContext("osd.7", overrides={**conf, "admin_socket": str(tmp_path / "a.asok")})
    ref = RefContext("osd.7", overrides={**conf, "admin_socket": str(tmp_path / "b.asok")})
    try:
        ours = set(cct.admin_socket.execute({"prefix": "help"}))
        theirs = set(ref.admin_socket.execute({"prefix": "help"}))
        assert ours == theirs - {"clear_kernel_fallback"}
        got = cct.admin_socket.execute({"prefix": "config get", "var": "ec_batch_window_ms"})
        assert got == {"ec_batch_window_ms": 5.0}
    finally:
        cct.shutdown()
        ref.shutdown()


# ---- crc32c and the buffer list ----


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 4096, 65537])
def test_crc32c_native_python_and_reference_agree(n):
    """The port's crc32c (its own build of the native library, hardware
    and table paths) equals its Python fallback and the reference's."""
    import numpy as np

    from ceph_tpu.common.crc32c import crc32c as ref_crc32c
    from ceph_tpu_torch import native_oracle
    from ceph_tpu_torch.common.crc32c import _crc32c_py, crc32c

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert native_oracle.available()
    for seed in (0xFFFFFFFF, 0, 0x1234ABCD):
        want = ref_crc32c(data, seed)
        assert crc32c(data, seed) == want
        assert native_oracle.crc32c(data, seed) == want
        assert native_oracle.crc32c(data, seed, _sw=True) == want
        assert _crc32c_py(data, seed) == want
    assert _crc32c_py(b"123456789", 0xFFFFFFFF) ^ 0xFFFFFFFF == 0xE3069283
    half = n // 2
    assert crc32c(data[half:], seed=crc32c(data[:half])) == crc32c(data)


def test_native_oracle_builds_outside_native_and_matches_the_tables():
    """The port's loader compiles native/'s sources into
    build/ceph_tpu_torch/ and writes nothing under native/; the oracle's
    CRUSH_LN_TABLE header holds the port's table."""
    import re
    from pathlib import Path

    import numpy as np

    from ceph_tpu_torch import native_oracle
    from ceph_tpu_torch.crush.ln_table import CRUSH_LN_TABLE

    native = Path(native_oracle.__file__).resolve().parents[1] / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    path = native_oracle._library_path()
    assert path.parent.name == "ceph_tpu_torch" and path.parent.parent.name == "build"
    assert path.exists() and native_oracle.available()
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before
    body = (native / "crush_tables.h").read_text()
    vals = [int(v) for v in re.findall(r"-?\d+", body[body.index("{") + 1:body.rindex("}")])]
    np.testing.assert_array_equal(np.asarray(vals, dtype=np.int64), CRUSH_LN_TABLE)
    # the GF oracle answers as the reference's does
    from ceph_tpu import native_oracle as ref_oracle

    np.testing.assert_array_equal(native_oracle.cauchy_good(8, 4), ref_oracle.cauchy_good(8, 4))


def test_buffer_list_matches_reference():
    """The same appends, substr, claim, alignment and typed encodes give
    the same bytes and crc in both packages, and each decodes the other's."""
    import numpy as np

    from ceph_tpu.common.buffer import BufferList as RefBL
    from ceph_tpu.common.buffer import BufferListIterator as RefIt
    from ceph_tpu_torch.common.buffer import BufferList, BufferListIterator

    def build(BL):
        rng = np.random.default_rng(5)
        bl = BL(b"abc")
        bl.append(b"def").append(bytearray(b"gh")).append_zero(3)
        for i in range(6):
            bl.append(rng.integers(0, 256, 100 + i, dtype=np.uint8).tobytes())
        other = BL(b"xx")
        other.claim_append(BL(b"yy"))
        bl.claim_append(other)
        bl.append_u8(7).append_u16(300).append_u32(70000).append_u64(1 << 40)
        bl.append_str("héllo").append_str(b"\x00\xff")
        sub = bl.substr(2, 300)
        aligned = BL(b"abcde")
        aligned.rebuild_aligned(4)
        return (bytes(bl), len(bl), bl.crc32c(), bl.crc32c(0), bytes(sub), sub.crc32c(),
                bytes(aligned), aligned.is_contiguous(), len(other))

    got = build(BufferList)
    assert got == build(RefBL)
    assert got[7] and got[8] == 0 and got[6] == b"abcde\0\0\0"
    tail = got[0][-(1 + 2 + 4 + 8 + 4 + 6 + 4 + 2):]
    for It in (BufferListIterator, RefIt):
        it = It(tail)
        assert (it.get_u8(), it.get_u16(), it.get_u32(), it.get_u64()) == (7, 300, 70000, 1 << 40)
        assert (it.get_str(), it.get_str_bytes(), it.remaining()) == ("héllo", b"\x00\xff", 0)
        with pytest.raises(EOFError):
            it.get_u8()
    with pytest.raises(IndexError):
        BufferList(b"0123456789").substr(5, 6)
