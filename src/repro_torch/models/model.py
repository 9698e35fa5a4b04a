"""Model dispatcher: the uniform API over the architecture families.

    model = build_model(cfg, seed=0)          # an nn.Module on the card
    logits, aux = model(batch)                # teacher-forced forward
    logits, cache, pos = model.prefill(batch, max_len)
    logits, cache = model.decode_step(cache, token, pos)
    cache = model.init_decode_state(batch_size, max_len)
    batch = model.dummy_batch(shape, seed)    # seeded tokens and labels

The parameters live in the module; ``init_params`` returns them by name
and ``abstract_params`` their shapes and dtypes (on the ``meta``
device). Only the ``dense`` family builds in this port so far: ``moe``
waits for ROADMAP.md queue 1 step 2a, and ``encdec``, ``hybrid``,
``ssm`` and ``vlm`` for step 2b. The training objective is step 2c.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch._device import resolve_device

from . import transformer
from .kvcache import full_cache
from .layers import generator


# --------------------------------------------------------------------------
# analytic parameter counts (roofline's 6*N*D)
# --------------------------------------------------------------------------

def _hybrid_units(cfg):
    """(full macro-units, trailing layers, pattern) of a hybrid stack
    (the JAX package's ``models.hybrid.n_units``)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    full = cfg.n_layers // len(pat)
    trail = cfg.n_layers - full * len(pat)
    return full, trail, pat


def count_params_analytic(cfg, active_only: bool = False) -> int:
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    def attn_params():
        if cfg.mla is not None:
            m = cfg.mla
            return (d * H * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * m.kv_lora_rank + m.kv_lora_rank
                    + m.kv_lora_rank * H * m.qk_nope_dim
                    + m.kv_lora_rank * H * m.v_head_dim
                    + d * m.qk_rope_dim + H * m.v_head_dim * d)
        n = d * H * hd + 2 * d * KVH * hd + H * hd * d
        if cfg.qkv_bias:
            n += H * hd + 2 * KVH * hd
        return n

    def mlp_params(dff):
        mult = 3 if cfg.activation == "swiglu" else 2
        return mult * d * dff

    if cfg.family == "ssm":
        hd_r = cfg.rwkv_head_size
        Hn = d // hd_r
        tm = (6 * d + d * 5 * cfg.rwkv_ddlora + 5 * cfg.rwkv_ddlora * d
              + d + d * cfg.rwkv_decay_lora + cfg.rwkv_decay_lora * d
              + Hn * hd_r + 5 * d * d + 2 * d)
        cm = 2 * d + d * ff + ff * d + d * d
        return V * d + L * (tm + cm + 4 * d) + d * V + 4 * d

    if cfg.family == "hybrid":
        w = cfg.lru_width
        bw = w // H
        rec = (2 * d * w + cfg.conv_width * w + w
               + 2 * (H * bw * bw + w) + w + w * d)
        att = attn_params()
        per_mlp = mlp_params(ff)
        full, trail, pat = _hybrid_units(cfg)
        n_rec = sum(1 for k in pat if k == "rec") * full + trail
        n_att = sum(1 for k in pat if k == "attn") * full
        return (V * d + n_rec * (rec + per_mlp + 2 * d)
                + n_att * (att + per_mlp + 2 * d) + d)

    if cfg.family == "encdec":
        enc = cfg.n_enc_layers * (attn_params() + mlp_params(ff) + 2 * d)
        cross = L * (attn_params())
        dec = L * (attn_params() + mlp_params(ff) + 3 * d)
        return V * d + enc + dec + cross + 2 * d + d * V

    # dense / moe / vlm backbones
    n = V * d + 2 * d  # embed + final norm
    if not cfg.tie_embeddings:
        n += d * V
    m = cfg.moe
    n_lead = m.first_dense_layers if m else 0
    if m is not None:
        expert = mlp_params(m.d_ff_expert)
        router = d * m.num_experts
        shared = m.num_shared * mlp_params(m.d_ff_shared or m.d_ff_expert)
        active = (m.top_k * expert + router + shared + attn_params() + 2 * d)
        total = (m.num_experts * expert + router + shared + attn_params()
                 + 2 * d)
        per_layer = active if active_only else total
        n += (L - n_lead) * per_layer
        n += n_lead * (attn_params()
                       + mlp_params(m.first_dense_d_ff or ff) + 2 * d)
    else:
        n += L * (attn_params() + mlp_params(ff) + 2 * d)
    if cfg.family == "vlm":
        n += cfg.frontend_dim * d + d * d + 2 * d  # patch projector MLP
    return n


# --------------------------------------------------------------------------
# the dense model
# --------------------------------------------------------------------------

class DenseLM(transformer.TransformerLM):
    """``build_model``'s module for the ``dense`` family: the stack's
    parameters (:class:`~repro_torch.models.transformer.TransformerLM`)
    with the reference's serving API. Batches are dicts of integer
    tensors (``"tokens"``, ``"labels"``) on the model's device."""

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch: Dict[str, torch.Tensor]):
        """Teacher-forced logits (B, S, V) float32 and the aux loss."""
        return transformer.lm_forward(self, batch["tokens"], self.cfg)

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        return transformer.lm_prefill(self, batch["tokens"], self.cfg,
                                      max_len)

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """One token a sequence at position ``pos``; the cache is updated
        in place and returned."""
        return transformer.lm_decode_step(self, cache, token, pos, self.cfg)

    def init_decode_state(self, batch_size: int, max_len: int, device=None):
        cfg = self.cfg
        return full_cache(cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                          cfg.head_dim_, cfg.np_dtype,
                          self.device if device is None else device)

    def dummy_batch(self, shape, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Tokens and labels drawn from a generator seeded with ``seed``
        on the model's device; as in the reference, both draws start
        from the same seed, so labels equal tokens."""
        B, S = shape.global_batch, shape.seq_len
        dev = self.device

        def draw():
            return torch.randint(0, self.cfg.vocab_size, (B, S),
                                 generator=generator(seed, dev), device=dev)
        return {"tokens": draw(), "labels": draw()}


def build_model(cfg, *, seed: int = 0, device=None) -> DenseLM:
    """The model of ``cfg`` on ``device`` (``None`` -> the CUDA card), its
    weights drawn from a generator seeded with ``seed`` on that device.
    ``device="meta"`` builds the abstract model: shapes and dtypes, no
    storage and no draws."""
    fam = cfg.family
    if fam in ("encdec", "hybrid", "ssm", "vlm"):
        from repro_torch.runtime.executor import _unported
        raise _unported(f"the {fam} family ({cfg.name})", "2b")
    if fam == "moe":
        from repro_torch.runtime.executor import _unported
        raise _unported(f"the moe family ({cfg.name})", "2a")
    if fam != "dense":
        raise ValueError(f"unknown family {fam}")
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    model = DenseLM(cfg, dev)
    if dev.type != "meta":
        model.reset_parameters(generator(seed, dev))
    return model


def init_params(cfg, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """The parameters of ``build_model(cfg, seed=seed)`` by name."""
    return dict(build_model(cfg, seed=seed, device=device).state_dict())


def abstract_params(cfg) -> Dict[str, torch.Tensor]:
    """The parameters' shapes and dtypes, as ``meta`` tensors by name."""
    return dict(build_model(cfg, device="meta").state_dict())
