"""Serving: batched prefill + decode with continuous batching.

``BatchedServer`` is the JAX package's host-scale server with slot-based
continuous batching (examples/serve_lm_torch.py), ported as it behaves:
the first prefill's cache is copied into every slot, and every decode
step advances all active slots at one shared position. It serves every
family whose prefill takes tokens alone (dense, moe, hybrid, ssm): a
decode state is a nested dict of tensors, each with its batch on axis
1. As in the reference, it passes only ``{"tokens": ...}`` to
``prefill``, so an encdec model (which needs ``"frames"``) or a vlm
model (``"patches"``) raises ``KeyError`` at admission.
``shard_decode_step`` runs the decode step on an in-process mesh
(``launch.sharding``): parameters and decode state laid out by the
reference's rules.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


def make_decode_fn(model):
    """``decode_step(cache, token, pos) -> (logits, cache)`` of ``model``
    (a module from ``models.build_model``; it holds the parameters)."""

    def decode_step(cache, token, pos):
        return model.decode_step(cache, token, pos)

    return decode_step


def decode_state_like(model, batch: int, max_len: int):
    """The decode state's shapes and dtypes, as ``meta`` tensors."""
    return model.init_decode_state(batch, max_len, device="meta")


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def shard_decode_step(model, mesh, abstract_params, batch: int,
                      max_len: int):
    """The decode step of ``model`` on ``mesh``. Returns ``(fn,
    cache_like, cspecs)`` as the reference does: ``cache_like`` the
    decode state's ``meta`` tensors, ``cspecs`` its specs
    (``sharding.cache_specs``, batch on dim 1 over ``("pod", "data")``).

    The parameters are laid out now, by ``sharding.param_specs(
    abstract_params)``, from ``model``'s current values. ``fn(cache,
    token, pos) -> (logits, cache)``: ``cache`` laid out by ``cspecs``
    (a tree of ``ShardedTensor``, updated in place and returned) or a
    plain decode state, which is laid out, stepped and written back in
    place (so ``BatchedServer`` can decode through ``fn``). Each batch
    replica all-gathers the parameters into ``model`` on its first entry
    (which must lie on ``model``'s device) and its share of the state (the blocks over the other axes), runs the
    unsharded decode step on it, and each entry keeps its own block of
    the result; the logits, (batch, 1, V) float32, are all-gathered onto
    the mesh's first entry. ``model``'s own parameters are the gather's
    target (they hold the laid-out values after a call).
    """
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.train import _check_replicas

    pspecs = shd.param_specs(abstract_params, mesh)
    cache_like = decode_state_like(model, batch, max_len)
    cspecs = shd.cache_specs(cache_like, mesh, model.cfg)
    params = {n: shd.ShardedTensor.scatter(p, shd.NamedSharding(mesh,
                                                                pspecs[n]))
              for n, p in model.named_parameters()}
    cshard = _tree_map(lambda s: shd.NamedSharding(mesh, s), cspecs)
    tok_sharding = shd.NamedSharding(
        mesh, shd.P(shd._batch_axes(mesh, batch), None))
    axes = tok_sharding.axes()
    firsts = sorted(shd.replicas(mesh, axes),
                    key=lambda e: shd.layout(tok_sharding,
                                             (batch, 1)).index[e])
    _check_replicas(model, mesh, firsts)
    home = mesh.devices[0]
    tparams = dict(model.named_parameters())

    def fn(cache, token, pos):
        plain = not isinstance(next(iter(_leaves(cache))), shd.ShardedTensor)
        scache = _tree_map(shd.lay_out, cache, cshard)
        stok = shd.lay_out(torch.as_tensor(token, device=home)
                           if not isinstance(token, shd.ShardedTensor)
                           else token, tok_sharding)
        parts = []
        for first in firsts:
            with shd.on_entry(first):
                for n, st in params.items():
                    st.gather_into(tparams[n].data)
                share = _tree_map(lambda st: st.gather_region(first, axes),
                                  scache)
                logits, share = model.decode_step(share, stok.blocks[first],
                                                  pos)
                _tree_map(lambda st, v: st.write_region(first, axes, v),
                          scache, share)
                parts.append(logits)
        out = torch.empty((batch,) + tuple(parts[0].shape[1:]),
                          dtype=parts[0].dtype, device=home)
        with shd.collective("all-gather", out.numel() * out.element_size()):
            n = batch // len(parts)
            for i, part in enumerate(parts):
                out[i * n:(i + 1) * n].copy_(part)
        if not plain:
            return out, scache
        _tree_map(lambda st, c: st.gather_into(c, record=False), scache,
                  cache)
        return out, cache

    return fn, cache_like, cspecs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# host-scale continuous-batching server
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Slot-based continuous batching over a fixed decode batch.

    Admission: waiting requests claim free slots; their prompts are
    prefilled one slot at a time. Every decode step advances ALL active
    slots by one token (greedy). ``model`` is the module that holds the
    parameters (``models.build_model``, or one whose weights were carried
    across with ``convert.lm_params_from_reference``); it runs on its own
    device.
    """

    def __init__(self, cfg, model, *, slots: int = 4, max_len: int = 256):
        if model.cfg != cfg:
            raise ValueError(f"the model was built for {model.cfg.name}, "
                             f"not {cfg.name}")
        self.model = model
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.requests: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)
        self._cache = None
        self._decode = make_decode_fn(model)

    # -- single-slot prefill (the model API is batch-first, so B=1) --------
    def _prefill_slot(self, slot: int, req: Request):
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.model.device)[None, :]
        logits, cache1, pos = self.model.prefill({"tokens": tokens},
                                                 self.max_len)
        if self._cache is None:
            # the first prefill's cache fills every slot
            self._cache = _tree_map(
                lambda a: torch.cat([a] * self.slots, dim=1), cache1)
        else:
            def put(full, one):
                full[:, slot:slot + 1] = one.to(full.dtype)
            _tree_map(put, self._cache, cache1)
        self.pos[slot] = int(pos)
        req.out.append(int(torch.argmax(logits[0, -1])))

    def submit(self, req: Request) -> bool:
        for s in range(self.slots):
            if self.requests[s] is None:
                self.requests[s] = req
                self._prefill_slot(s, req)
                return True
        return False

    def step(self):
        """One decode step for all active slots (greedy)."""
        active = [s for s, r in enumerate(self.requests)
                  if r is not None and not r.done]
        if not active or self._cache is None:
            return
        toks = np.zeros((self.slots, 1), np.int64)
        for s in active:
            toks[s, 0] = self.requests[s].out[-1]
        # slots share one position a decode call: the server decodes at
        # the largest active position, and a slot's entries past its own
        # position are whatever the cache holds there (the reference's
        # behaviour, kept)
        pos = int(max(self.pos[s] for s in active))
        logits, self._cache = self._decode(
            self._cache, torch.as_tensor(toks, device=self.model.device),
            pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for s in active:
            r = self.requests[s]
            r.out.append(int(nxt[s]))
            self.pos[s] += 1
            if len(r.out) >= r.max_new_tokens:
                r.done = True
                self.requests[s] = None   # free the slot

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if all(r is None for r in self.requests):
                break
            self.step()
