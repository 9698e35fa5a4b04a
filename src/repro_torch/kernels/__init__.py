"""Hand-written CUDA kernels for Hopper, their wrappers and oracles.

<name>.py = the kernel's wrappers, launch counters and plain versions;
csrc/<name>.cu = the CUDA source, built by ``_build`` at the first launch
(never at import); ops.py = the padded entry points; ref.py = the plain
oracle every kernel is held to.

The JAX package exports its entry points ``backproject_subline``,
``backproject_onehot`` and ``backproject_banded`` under the names of the
kernel modules. Here those names are the kernel modules (their wrappers,
counters and plain versions); the entry points of the same names are in
``ops``.
"""

from . import (backproject_banded, backproject_onehot,  # noqa: F401
               backproject_subline, ops)
from .ref import backproject_ref  # noqa: F401
