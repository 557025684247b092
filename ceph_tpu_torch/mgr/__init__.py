"""Manager plane (reference: src/mgr + src/pybind/mgr; SURVEY.md §2.5)."""
from .daemon import MgrDaemon
from .module import MgrModule, MODULE_REGISTRY

__all__ = ["MgrDaemon", "MgrModule", "MODULE_REGISTRY"]
