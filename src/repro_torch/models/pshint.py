"""Activation-sharding hints (sequence parallelism), context-scoped.

Model code stays mesh-agnostic: it calls ``constrain(x, "residual")`` at
layer boundaries, ``"heads"`` on the attention projections and
``"ffn"`` on the MLP's hidden activations, as the JAX package's model
does at the same sites; drivers opt in by installing a policy (a dict
kind -> ``launch.sharding.NamedSharding`` or ``P``) with
:func:`activation_policy`. Without a policy the call returns ``x``.

What a hint does on the port's mesh: nothing to the values, and nothing
to where they lie. The JAX package hands the spec to XLA
(``with_sharding_constraint``), which may then split the activation over
the mesh. The port's in-process mesh (``launch.sharding``) runs each
batch replica's compute whole on one entry, so there is no layout for a
hint to constrain: under a policy ``constrain`` checks the spec against
the tensor as the reference does (rank, divisibility) and returns ``x``
itself. A layout hint never changes a number.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

_POLICY: Dict[str, object] = {}


@contextlib.contextmanager
def activation_policy(policy: Dict[str, object]):
    """policy: {"residual": NamedSharding(mesh, P(batch, seq, feature)),
    ...}; the previous policy comes back on exit."""
    global _POLICY
    old = _POLICY
    _POLICY = dict(policy)
    try:
        yield
    finally:
        _POLICY = old


def constrain(x, kind: str = "residual"):
    """``x``, unchanged: the layout hint of ``kind`` under the installed
    policy (none: no hint). A spec of another rank than ``x``, or one
    whose axes do not divide its dims, leaves the layout to the runtime,
    as the reference's does."""
    sharding = _POLICY.get(kind)
    if sharding is None:
        return x
    spec = getattr(sharding, "spec", sharding)
    if x.ndim != len(spec):
        return x
    mesh = getattr(sharding, "mesh", None)
    if mesh is not None:
        for dim, ax in zip(x.shape, spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            if dim % math.prod(mesh.axis_size(a) for a in axes) != 0:
                return x   # not divisible: leave the layout to the runtime
    return x
