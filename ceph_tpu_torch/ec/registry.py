"""Plugin registry — profile-driven codec selection (counterpart of
ceph_tpu/ec/registry.py; the port keeps its own singleton).

Re-design of the reference's dlopen plugin registry (reference:
src/erasure-code/ErasureCodePlugin.{h,cc} :: ErasureCodePluginRegistry):
a plugin is a factory object registered under its profile name, and
``plugin=torch`` in an EC profile selects the CUDA codec the way
``plugin=isa`` selects ISA-L in the reference.  A profile that names no
plugin gets ``torch``.

Profiles are per-pool key=value maps, e.g. {"plugin": "torch",
"technique": "cauchy_good", "k": "8", "m": "4"}.  ``factory()``
validates by instantiating, as OSDMonitor validates ``osd
erasure-code-profile set`` (reference: src/mon/OSDMonitor.cc), and takes
the ``device`` the codec runs on (``cuda`` unless ``"cpu"`` is asked).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from threading import Lock

from .interface import ErasureCodeInterface, InvalidProfile


class ErasureCodePlugin(ABC):
    """Factory for codec instances (reference: ErasureCodePlugin.h ::
    ErasureCodePlugin::factory)."""

    @abstractmethod
    def factory(self, profile: dict, device=None) -> ErasureCodeInterface: ...


class ErasureCodePluginRegistry:
    """Singleton name -> plugin map (reference: ErasureCodePlugin.cc ::
    ErasureCodePluginRegistry::instance / add / factory)."""

    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = Lock()

    def __init__(self):
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self._lock = Lock()

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
                _register_defaults(cls._instance)
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise KeyError(f"erasure code plugin {name!r} already registered")
            self._plugins[name] = plugin

    def names(self) -> list[str]:
        return sorted(self._plugins)

    def factory(self, profile: dict, device=None) -> ErasureCodeInterface:
        """Instantiate the codec a profile names (reference:
        ErasureCodePluginRegistry::factory).  Raises InvalidProfile for an
        unknown plugin or a profile the plugin rejects."""
        name = profile.get("plugin", "torch")
        plugin = self._plugins.get(name)
        if plugin is None:
            raise InvalidProfile(
                f"unknown erasure code plugin {name!r}; known: {self.names()}"
            )
        return plugin.factory(dict(profile), device=device)


def _register_defaults(reg: ErasureCodePluginRegistry) -> None:
    # imported here to avoid import cycles (the plugins import the registry)
    from .plugins.clay import ClayPlugin
    from .plugins.rs import RSPlugin
    from .plugins.shec import ShecPlugin

    reg.add("torch", RSPlugin(backend="torch"))  # CUDA kernels (the default)
    reg.add("numpy", RSPlugin(backend="numpy"))  # pure-numpy referee
    reg.add("shec", ShecPlugin())
    reg.add("clay", ClayPlugin())
