"""Model dispatcher: the uniform API over the architecture families.

    model = build_model(cfg, seed=0)          # an nn.Module on the card
    logits, aux = model(batch)                # teacher-forced forward
    logits, cache, pos = model.prefill(batch, max_len)
    logits, cache = model.decode_step(cache, token, pos)
    cache = model.init_decode_state(batch_size, max_len)
    batch = model.dummy_batch(shape, seed)    # seeded tokens and labels

Families: dense | moe (incl. MLA) | encdec | hybrid | ssm | vlm. The
parameters live in the module; ``init_params`` returns them by name and
``abstract_params`` their shapes and dtypes (on the ``meta`` device).
As in the JAX package, the frontends are stubs: an encdec batch carries
precomputed ``"frames"`` (B, S_enc, d_model) and a vlm batch precomputed
``"patches"`` (B, frontend_tokens, frontend_dim); the backbone is real.
The training objective (``loss``) is ROADMAP.md queue 1 step 2c, and
``input_specs`` (the dry-run's) step 2d.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch._device import resolve_device

from . import encdec, hybrid, ssm, transformer
from .kvcache import full_cache, mla_cache
from .layers import _gelu, _param, dense_init, embed, generator


# --------------------------------------------------------------------------
# analytic parameter counts (roofline's 6*N*D)
# --------------------------------------------------------------------------

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
        full, trail, pat = hybrid.n_units(cfg)
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
# the models: each family's parameters with the reference's serving API
# --------------------------------------------------------------------------

class _Serving:
    """What every family's model shares: its device and seeded dummy
    batches. Batches are dicts of tensors on the model's device."""

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _draw_tokens(self, B, S, seed):
        return torch.randint(0, self.cfg.vocab_size, (B, S),
                             generator=generator(seed, self.device),
                             device=self.device)

    def _draw_normal(self, shape, seed):
        return torch.randn(shape, generator=generator(seed, self.device),
                           device=self.device, dtype=torch.float32)

    def dummy_batch(self, shape, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Tokens and labels drawn from a generator seeded with ``seed``
        on the model's device; as in the reference, every draw starts
        from the same seed, so labels equal tokens."""
        B, S = shape.global_batch, shape.seq_len
        return {"tokens": self._draw_tokens(B, S, seed),
                "labels": self._draw_tokens(B, S, seed)}


class VlmProjector(torch.nn.Module):
    """The vision stub's projector: ``proj1`` (frontend_dim, d),
    ``proj2`` (d, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.proj1 = _param((cfg.frontend_dim, cfg.d_model), cfg.np_dtype,
                            device)
        self.proj2 = _param((cfg.d_model, cfg.d_model), cfg.np_dtype,
                            device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for w in (self.proj1, self.proj2):
                w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))


class LM(_Serving, transformer.TransformerLM):
    """``build_model``'s module for the ``dense``, ``moe`` and ``vlm``
    families: the stack's parameters (:class:`~repro_torch.models.
    transformer.TransformerLM`), with the vision projector ``vlm`` for
    the vlm family, and the reference's serving API.

    ``moe_stats``, when set to a dict, gathers the routed layers'
    assignments and capacity drops over decode steps
    (``moe.moe_mlp``'s ``stats``)."""

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        if cfg.family == "vlm":
            self.vlm = VlmProjector(cfg, device)
        self.moe_stats = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        super().reset_parameters(gen)
        if self.cfg.family == "vlm":
            self.vlm.reset_parameters(gen)

    def _embeds(self, batch):
        """The stack's input: token embeddings, after the projected patch
        embeddings for the vlm family (the reference's ``_vlm_embed``)."""
        tok = embed(self.embed, batch["tokens"])
        if self.cfg.family != "vlm":
            return tok
        h = _gelu(batch["patches"].to(self.cfg.np_dtype) @ self.vlm.proj1)
        return torch.cat([h @ self.vlm.proj2, tok], dim=1)

    def forward(self, batch: Dict[str, torch.Tensor]):
        """Teacher-forced logits (B, S, V) float32 and the aux loss (over
        the patch tokens too for the vlm family)."""
        x = self._embeds(batch)
        B, S, _ = x.shape
        h, aux, _ = transformer.forward_embeds(
            self, x, self.cfg, transformer._positions(B, S, x.device))
        return transformer.logits_from_hidden(self, h, self.cfg), aux

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        """(last logits, cache, pos). A vlm cache holds the patch tokens
        and the text, so it is at least that long."""
        x = self._embeds(batch)
        B, S, _ = x.shape
        max_len = max(max_len, S)
        h, _, (lead, stack) = transformer.forward_embeds(
            self, x, self.cfg, transformer._positions(B, S, x.device),
            collect_cache=True)
        cache = transformer._caches_to_struct(self.cfg, stack, lead, B, S,
                                              max_len)
        return (transformer.logits_from_hidden(self, h[:, -1:], self.cfg),
                cache, S)

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        """One token a sequence at position ``pos``; the cache is updated
        in place and returned."""
        return transformer.lm_decode_step(self, cache, token, pos, self.cfg,
                                          moe_stats=self.moe_stats)

    def init_decode_state(self, batch_size: int, max_len: int, device=None):
        cfg = self.cfg
        dev = self.device if device is None else device
        if cfg.mla is not None:
            return mla_cache(cfg.n_layers, batch_size, max_len,
                             cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim,
                             cfg.np_dtype, dev)
        return full_cache(cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                          cfg.head_dim_, cfg.np_dtype, dev)

    def dummy_batch(self, shape, seed: int = 0) -> Dict[str, torch.Tensor]:
        b = super().dummy_batch(shape, seed)
        if self.cfg.family == "vlm":
            b["patches"] = self._draw_normal(
                (shape.global_batch, self.cfg.frontend_tokens,
                 self.cfg.frontend_dim), seed)
        return b


class EncDecModel(_Serving, encdec.EncDecLM):
    """The ``encdec`` family: batches carry ``"frames"`` and
    ``"tokens"``."""

    def forward(self, batch: Dict[str, torch.Tensor]):
        enc_out = encdec.encode(self, batch["frames"], self.cfg)
        logits, _ = encdec.decode_seq(self, batch["tokens"], enc_out,
                                      self.cfg)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        return encdec.encdec_prefill(self, batch["frames"], batch["tokens"],
                                     self.cfg, max_len)

    def decode_step(self, cache: dict, token: torch.Tensor, pos):
        return encdec.encdec_decode_step(self, cache, token, pos, self.cfg)

    def init_decode_state(self, batch_size: int, max_len: int, device=None):
        """The self-attention cache and cross K/V over an encoder sequence
        of the same length (as the reference sizes it)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                 cfg.head_dim_)
        dev = self.device if device is None else device
        return {k: torch.zeros(shape, dtype=cfg.np_dtype, device=dev)
                for k in ("k", "v", "ck", "cv")}

    def dummy_batch(self, shape, seed: int = 0) -> Dict[str, torch.Tensor]:
        b = super().dummy_batch(shape, seed)
        b["frames"] = self._draw_normal(
            (shape.global_batch, shape.seq_len, self.cfg.d_model), seed)
        return b


class HybridModel(_Serving, hybrid.HybridLM):
    """The ``hybrid`` family: an O(window) decode state, whatever
    ``max_len``."""

    def forward(self, batch: Dict[str, torch.Tensor]):
        return hybrid.hybrid_forward(self, batch["tokens"], self.cfg)

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        del max_len
        tokens = batch["tokens"]
        logits, (units, trail) = hybrid.hybrid_forward(
            self, tokens, self.cfg, collect_state=True)
        state = {"units": units}
        if trail is not None:
            state["trail"] = trail
        return logits[:, -1:], state, tokens.shape[1]

    def decode_step(self, state: dict, token: torch.Tensor, pos):
        return hybrid.hybrid_decode_step(self, state, token, pos, self.cfg)

    def init_decode_state(self, batch_size: int, max_len: int, device=None):
        del max_len
        return hybrid.init_hybrid_state(
            self.cfg, batch_size, self.device if device is None else device)


class RwkvModel(_Serving, ssm.RwkvLM):
    """The ``ssm`` family (RWKV-6): an O(1) decode state."""

    def forward(self, batch: Dict[str, torch.Tensor]):
        return ssm.rwkv_forward(self, batch["tokens"], self.cfg)

    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        del max_len
        return ssm.rwkv_prefill(self, batch["tokens"], self.cfg)

    def decode_step(self, state: dict, token: torch.Tensor, pos):
        return ssm.rwkv_decode_step(self, state, token, pos, self.cfg)

    def init_decode_state(self, batch_size: int, max_len: int, device=None):
        del max_len
        return ssm.init_rwkv_state(
            self.cfg, batch_size, self.device if device is None else device)


MODELS = {"dense": LM, "moe": LM, "vlm": LM, "encdec": EncDecModel,
          "hybrid": HybridModel, "ssm": RwkvModel}


def build_model(cfg, *, seed: int = 0, device=None) -> torch.nn.Module:
    """The model of ``cfg`` on ``device`` (``None`` -> the CUDA card), its
    weights drawn from a generator seeded with ``seed`` on that device.
    ``device="meta"`` builds the abstract model: shapes and dtypes, no
    storage and no draws."""
    if cfg.family not in MODELS:
        raise ValueError(f"unknown family {cfg.family}")
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    model = MODELS[cfg.family](cfg, dev)
    if dev.type != "meta":
        model.reset_parameters(generator(seed, dev))
    return model


def init_params(cfg, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """The parameters of ``build_model(cfg, seed=seed)`` by name."""
    return dict(build_model(cfg, seed=seed, device=device).state_dict())


def abstract_params(cfg) -> Dict[str, torch.Tensor]:
    """The parameters' shapes and dtypes, as ``meta`` tensors by name."""
    return dict(build_model(cfg, device="meta").state_dict())
