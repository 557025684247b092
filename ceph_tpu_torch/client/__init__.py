"""Client stack: Objecter op engine + librados-style API (counterpart of
ceph_tpu/client; reference: src/osdc/Objecter.cc, src/librados).

Ported so far: the Objecter and ``Rados``.  RBD, its mirror daemon and
the striper come with a later slice."""
from .objecter import Objecter
from .rados import Rados

__all__ = ["Objecter", "Rados"]
