"""State carried across from the JAX package.

For CT the state both packages share is the acquisition geometry and
the projection stack; for the LM substrate, the parameters and the
training state. These functions take them over from plain Python and
numpy values, so the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.geometry import CTGeometry


def geometry_from_reference(fields: Mapping) -> CTGeometry:
    """A :class:`CTGeometry` from the field mapping of another package's
    geometry record (``dataclasses.asdict(geom)``).

    Raises ``ValueError`` on a missing or unknown field.
    """
    names = {f.name for f in dataclasses.fields(CTGeometry)}
    missing, extra = names - set(fields), set(fields) - names
    if missing or extra:
        raise ValueError(
            f"geometry fields do not match CTGeometry: missing "
            f"{sorted(missing)}, unknown {sorted(extra)}")
    kw = dict(fields)
    kw["voxel_size"] = tuple(float(v) for v in kw["voxel_size"])
    kw["det_spacing"] = tuple(float(v) for v in kw["det_spacing"])
    return CTGeometry(**kw)


def host_float32(a) -> np.ndarray:
    """Array ``a`` as C-contiguous float32 host memory that torch may
    wrap: ``a`` itself where it already is, else a converted copy."""
    arr = np.ascontiguousarray(a, np.float32)
    if not arr.flags.writeable:     # e.g. a view of another framework's
        arr = arr.copy()            # buffer: torch wants writable memory
    return arr


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A float32 tensor on ``device`` (``None`` -> the CUDA card) holding
    the values of array ``a`` (on the CPU it may share ``a``'s memory)."""
    dev = resolve_device(device)
    return torch.from_numpy(host_float32(a)).to(dev)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


# the JAX package's stacked subtrees: every leaf under one of these
# carries a leading layer (or unit) axis, which the port unstacks into
# ``{prefix}.{index}.{rest}``
STACKED = ("layers", "lead_layers", "units", "trail", "enc_layers",
           "dec_layers")


def tree_by_name(tree: Mapping) -> Dict[str, np.ndarray]:
    """Another package's LM tree (the parameters, or any tree shaped like
    them: a gradient, an AdamW moment) by the port's parameter names, as
    float32 numpy arrays: nested keys join with ``.``, and every leaf
    under a subtree of ``STACKED`` is unstacked along its leading layer
    axis into ``{prefix}.{index}.{rest}``."""
    flat = {}
    for name, arr in _flatten(tree).items():
        arr = np.array(arr, np.float32)    # a writable copy
        prefix, _, rest = name.partition(".")
        if prefix in STACKED and rest:
            for layer in range(arr.shape[0]):
                flat[f"{prefix}.{layer}.{rest}"] = arr[layer]
        else:
            flat[name] = arr
    return flat


def lm_params_from_reference(model, tree: Mapping):
    """Load another package's LM parameter tree into ``model`` (a module
    from ``repro_torch.models.build_model``) and return the model.

    ``tree`` is the JAX package's parameter pytree, of any family, as
    nested dicts of numpy arrays: ``embed``, ``ln_f``, ``layers`` and,
    untied, ``unembed``; DeepSeek-V2's ``lead_layers``, routed and shared
    experts (``moe``, ``moe.shared``) and MLA projections; the hybrid
    ``units`` and ``trail``; RWKV's ``ln_in`` and time/channel mixes; the
    ``enc_layers``/``dec_layers`` with ``ln_enc``/``ln_dec``; the vlm
    projector ``vlm``. Every leaf under a subtree of ``STACKED`` has the
    reference's leading layer axis. Weights are stored ``(d_in, d_out)``
    on both sides, so nothing is transposed. Values pass through float32
    (exact for float32, bfloat16 and float16) and land in each
    parameter's dtype on its device. Raises ``ValueError`` on a missing
    or unknown leaf, or a shape that does not match.
    """
    flat = tree_by_name(tree)
    params = dict(model.named_parameters())
    missing, extra = set(params) - set(flat), set(flat) - set(params)
    if missing or extra:
        raise ValueError(
            f"parameter tree does not match the model: missing "
            f"{sorted(missing)}, unknown {sorted(extra)}")
    with torch.no_grad():
        for name, p in params.items():
            arr = flat[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(arr.shape)}, the "
                                 f"model has {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return model


def train_state_from_reference(model, state):
    """The port's ``launch.train.TrainState`` from another package's.

    ``state`` is the JAX package's ``TrainState(params, opt)`` with
    ``opt`` an ``AdamWState(step, m, v)``, as numpy arrays (any objects
    with those attributes). The parameters load into ``model``
    (``lm_params_from_reference``) and turn on gradients; ``m`` and
    ``v`` map by name (``tree_by_name``) to float32 tensors beside them.
    """
    from repro_torch.launch.train import TrainState
    from repro_torch.optim import AdamWState

    lm_params_from_reference(model, state.params)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)

    def moments(tree):
        flat = tree_by_name(tree)
        if set(flat) != set(params):
            raise ValueError("optimizer state does not match the model's "
                             "parameters")
        return {n: torch.from_numpy(flat[n]).to(p.device)
                for n, p in params.items()}

    dev = next(iter(params.values())).device
    opt = AdamWState(
        step=torch.tensor(int(np.asarray(state.opt.step)),
                          dtype=torch.int32, device=dev),
        m=moments(state.opt.m), v=moments(state.opt.v))
    return TrainState(params=params, opt=opt)
