"""Compressor plugin registry (reference: src/compressor —
Compressor::create + the zlib/snappy/zstd/lz4 plugins; SURVEY.md §2.7).

Mirrors the EC plugin registry's shape: plugins self-register, creation
goes through one factory, and unavailable native libraries surface as a
clean error instead of an import crash (snappy/zstd/lz4 gate on their
modules being importable; zlib is stdlib and always present).

    c = Compressor.create("zlib")
    blob = c.compress(data)
    assert c.decompress(blob) == data
"""
from __future__ import annotations


class CompressorError(Exception):
    pass


class Compressor:
    """Plugin contract (reference: src/compressor/Compressor.h)."""

    NAME = ""

    def compress(self, data: bytes) -> bytes:  # pragma: no cover - abstract
        raise NotImplementedError

    def decompress(self, data: bytes) -> bytes:  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def create(name: str) -> "Compressor":
        cls = _REGISTRY.get(name)
        if cls is None:
            raise CompressorError(
                f"unknown compressor {name!r}; available: {available()}"
            )
        return cls()


_REGISTRY: dict[str, type] = {}


def register(cls: type) -> type:
    _REGISTRY[cls.NAME] = cls
    return cls


def available() -> list[str]:
    return sorted(_REGISTRY)


@register
class ZlibCompressor(Compressor):
    NAME = "zlib"

    def __init__(self, level: int = 5):
        self.level = level

    def compress(self, data: bytes) -> bytes:
        import zlib

        return zlib.compress(bytes(data), self.level)

    def decompress(self, data: bytes) -> bytes:
        import zlib

        try:
            return zlib.decompress(bytes(data))
        except zlib.error as e:
            raise CompressorError(f"zlib: {e}") from e

    def decompress_bounded(self, data: bytes, max_out: int) -> bytes:
        """Inflate at most max_out bytes (decompression-bomb guard for
        untrusted frames): a stream that would exceed the bound raises
        instead of allocating it."""
        import zlib

        d = zlib.decompressobj()
        try:
            out = d.decompress(bytes(data), max_out)
        except zlib.error as e:
            raise CompressorError(f"zlib: {e}") from e
        if d.unconsumed_tail or (d.decompress(b"", 1) if not d.eof else b""):
            raise CompressorError(
                f"zlib: inflated stream exceeds bound ({max_out})"
            )
        return out


def _try_register_optional() -> None:
    """snappy / zstd / lz4 exist only if their modules are importable —
    the plugin-.so-present gate of the reference's registry."""
    try:
        import snappy  # type: ignore[import-not-found]

        @register
        class SnappyCompressor(Compressor):
            NAME = "snappy"

            def compress(self, data: bytes) -> bytes:
                return snappy.compress(bytes(data))

            def decompress(self, data: bytes) -> bytes:
                try:
                    return snappy.decompress(bytes(data))
                except Exception as e:
                    raise CompressorError(f"snappy: {e}") from e
    except ImportError:
        pass
    try:
        import zstandard  # type: ignore[import-not-found]

        @register
        class ZstdCompressor(Compressor):
            NAME = "zstd"

            def compress(self, data: bytes) -> bytes:
                return zstandard.ZstdCompressor().compress(bytes(data))

            def decompress(self, data: bytes) -> bytes:
                try:
                    return zstandard.ZstdDecompressor().decompress(bytes(data))
                except Exception as e:
                    raise CompressorError(f"zstd: {e}") from e

            def decompress_bounded(self, data: bytes,
                                   max_out: int) -> bytes:
                try:
                    return zstandard.ZstdDecompressor().decompress(
                        bytes(data), max_output_size=max_out)
                except Exception as e:
                    raise CompressorError(f"zstd: {e}") from e
    except ImportError:
        pass
    try:
        import lz4.frame  # type: ignore[import-not-found]

        @register
        class Lz4Compressor(Compressor):
            NAME = "lz4"

            def compress(self, data: bytes) -> bytes:
                return lz4.frame.compress(bytes(data))

            def decompress(self, data: bytes) -> bytes:
                try:
                    return lz4.frame.decompress(bytes(data))
                except Exception as e:
                    raise CompressorError(f"lz4: {e}") from e
    except ImportError:
        pass


_try_register_optional()
