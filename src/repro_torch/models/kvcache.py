"""KV caches of the attention families, in the JAX package's layouts.

A cache is a dict of tensors with a stacked leading layer axis:

  full      (L, B, S, KVH, hd) k + v   -- dense / GQA archs
  window    (L, B, W, KVH, hd) k + v   -- sliding-window ring buffers

The decode step writes each new token's entries in place. The latent
(MLA), recurrent and RWKV states come with their families (ROADMAP.md
queue 1 steps 2a and 2b).
"""

from __future__ import annotations

import torch


def full_cache(n_layers, batch, max_len, n_kv, head_dim, dtype,
               device=None):
    shape = (n_layers, batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def window_cache(n_layers, batch, window, n_kv, head_dim, dtype,
                 device=None):
    shape = (n_layers, batch, window, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
