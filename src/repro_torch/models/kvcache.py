"""KV caches of the attention families, in the JAX package's layouts.

A cache is a dict of tensors with a stacked leading layer axis:

  full      (L, B, S, KVH, hd) k + v          -- dense / GQA / MoE archs
  mla       (L, B, S, kv_lora) c + (L,B,S,dr) kr -- DeepSeek-V2 latent cache
  window    (L, B, W, KVH, hd) k + v          -- sliding-window ring buffers
  recurrent (L, B, lru_width) h + conv tail   -- RG-LRU layers
  rwkv      (L, B, H, hd, hd) S + shift state -- RWKV-6

The decode step writes each new token's entries in place. Recurrent and
RWKV states are float32 where the reference keeps them so.
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


def mla_cache(n_layers, batch, max_len, kv_lora, rope_dim, dtype,
              device=None):
    return {
        "c": torch.zeros((n_layers, batch, max_len, kv_lora), dtype=dtype,
                         device=device),
        "kr": torch.zeros((n_layers, batch, max_len, rope_dim), dtype=dtype,
                          device=device),
    }


def recurrent_state(n_layers, batch, lru_width, conv_width, dtype,
                    device=None):
    return {
        "h": torch.zeros((n_layers, batch, lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((n_layers, batch, conv_width - 1, lru_width),
                            dtype=dtype, device=device),
    }


def rwkv_state(n_layers, batch, n_heads, head_size, d_model, dtype,
               device=None):
    return {
        "S": torch.zeros((n_layers, batch, n_heads, head_size, head_size),
                         dtype=torch.float32, device=device),
        "x_tm": torch.zeros((n_layers, batch, d_model), dtype=dtype,
                            device=device),
        "x_cm": torch.zeros((n_layers, batch, d_model), dtype=dtype,
                            device=device),
    }
