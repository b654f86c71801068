"""Shared transformer layers: RMSNorm, RoPE, chunked GQA attention, MLP/MoE.

The port of ``repro.models.layers``.  Plain functions on tensors (params
are dicts of tensors under the reference's names); the logical-axis
constraints are checked by name (``dist/sharding.constrain``) and place
nothing, since the port's LM runs on one device.

Numerics follow the reference step for step, so that bf16 rounds where it
rounds there: RMSNorm normalises in f32 and scales in the input dtype,
the QK product comes out in the input dtype before it widens to f32, the
softmax runs in f32 and its probabilities narrow to ``v``'s dtype before
the PV product, and the MoE gates narrow to the activations' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import ShardingRules, constrain
from repro_torch.kernels.topk.ref import topk_ref

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # decode (S==1): merge single-token groups into groups of this many
    # tokens before routing — capacity slots shrink by the same factor
    decode_group: int = 0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    mlp_type: str = "swiglu"          # swiglu | gelu | relu2
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16  # activation/weight compute dtype
    q_chunk: int = 1024               # attention query-chunk (memory ceiling)
    remat: bool = True                # checkpoint each layer in train_step
    remat_policy: str = "full"        # full | dots
    tie_embeddings: bool = False

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        n_mats = 3 if self.mlp_type == "swiglu" else 2
        if self.moe is not None:
            mlp = self.moe.n_experts * n_mats * d * f + d * self.moe.n_experts
        else:
            mlp = n_mats * d * f
        embed = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp + 2 * d) + embed + d

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params
        d, f = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_type == "swiglu" else 2
        dense_total = self.n_params - self.n_layers * self.moe.n_experts * n_mats * d * f
        return dense_total + self.n_layers * self.moe.top_k * n_mats * d * f


# ---------------------------------------------------------------------------
# Basic ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split.  x: (..., S, H, hd); positions:
    (..., S), one row for the batch or one per batch row."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mlp_act(cfg: LMConfig, wi_out: torch.Tensor,
             wg_out: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return F.silu(wg_out) * wi_out
    if cfg.mlp_type == "gelu":
        return F.gelu(wi_out, approximate="tanh")  # jax.nn.gelu's default
    if cfg.mlp_type == "relu2":
        r = F.relu(wi_out)
        return r * r
    raise ValueError(cfg.mlp_type)


# ---------------------------------------------------------------------------
# Attention (GQA + RoPE), query-chunked for long-context memory control
# ---------------------------------------------------------------------------


def _per_row(v: Any, device: torch.device) -> torch.Tensor:
    """A scalar or a (B,) vector as a (1, 1) or (B, 1) int64 tensor."""
    return torch.as_tensor(v, device=device).to(torch.int64).reshape(-1, 1)


def attention(
    q: torch.Tensor,             # (B, S, H, hd) post-RoPE
    k: torch.Tensor,             # (B, T, K, hd) post-RoPE
    v: torch.Tensor,             # (B, T, K, hd)
    *,
    q_offset: Any,               # absolute position of q[:, 0]: scalar or (B,)
    kv_len: Any = None,          # valid cache length: scalar or (B,)
    causal: bool = True,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Chunked softmax attention: loops over query chunks so the live score
    block is (B, K, G, C, T) instead of (B, H, S, T).  Head h reads kv-head
    h // G.  ``q_offset`` and ``kv_len`` may differ per batch row (the
    decode engine's slots)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    kv_pos = torch.arange(T, device=q.device)
    q_offset = _per_row(q_offset, q.device)
    kv_valid = kv_pos < (T if kv_len is None else _per_row(kv_len, q.device))
    kv_valid = kv_valid.reshape(-1, 1, T)                   # (1|B, 1, T)

    def one_chunk(qc: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
        # qc: (B, C, H, hd); c0: (1|B, 1) absolute position of qc[:, 0]
        C = qc.shape[1]
        qg = qc.reshape(B, C, K, G, hd)
        s = torch.einsum("bckgh,btkh->bkgct", qg, k).to(torch.float32) * scale
        mask = kv_valid
        if causal:
            q_pos = c0 + torch.arange(C, device=q.device)      # (1|B, C)
            mask = mask & (q_pos[:, :, None] >= kv_pos)        # (1|B, C, T)
        s = torch.where(mask[:, None, None], s, -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgct,btkh->bckgh", p, v)
        return o.reshape(B, C, H, hd)

    if S <= q_chunk:
        return one_chunk(q, q_offset)
    if S % q_chunk:
        raise ValueError(f"query length {S} is not a multiple of the "
                         f"chunk {q_chunk}")
    return torch.cat([one_chunk(q[:, i:i + q_chunk], q_offset + i)
                      for i in range(0, S, q_chunk)], dim=1)


def attention_block(
    x: torch.Tensor,             # (B, S, D)
    p: Params,                   # wq, wk, wv, wo, attn_norm
    cfg: LMConfig,
    rules: ShardingRules,
    *,
    positions: torch.Tensor,     # (S,) absolute positions, or (B, S)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k,v) (B,T,K,hd)
    cache_len: Optional[torch.Tensor] = None,  # scalar or (B,)
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Pre-norm attention with optional KV cache.  Returns (out, new_kv).

    With a cache, the new keys and values are written INTO ``cache`` (in
    place) at each row's ``cache_len``, clamped as the reference's
    ``dynamic_update_slice`` clamps it: a write that would run past T
    starts at T - S instead.  The valid length is ``cache_len + S``,
    unclamped, as there."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    kx = (h @ p["wk"]).reshape(B, S, K, hd)
    vx = (h @ p["wv"]).reshape(B, S, K, hd)
    pos = positions if positions.dim() == 2 else positions[None, :]
    q = rope(q, pos, cfg.rope_theta)
    kx = rope(kx, pos, cfg.rope_theta)
    q = constrain(q, rules, "batch", None,
                  rules.if_divisible("heads", H), None)
    kx = constrain(kx, rules, "batch", rules.if_divisible("seq", S),
                   rules.if_divisible("kv_heads", K), None)

    if cache is not None:
        ck, cv = cache
        T = ck.shape[1]
        start = torch.zeros((), dtype=torch.int64, device=x.device) \
            if cache_len is None else _per_row(cache_len, x.device)
        t_idx = (start.clamp(0, T - S)
                 + torch.arange(S, device=x.device)).expand(B, S)
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S)
        ck.index_put_((b_idx, t_idx), kx.to(ck.dtype))
        cv.index_put_((b_idx, t_idx), vx.to(cv.dtype))
        o = attention(
            q, ck, cv, q_offset=pos[:, 0], kv_len=start + S,
            causal=True, q_chunk=cfg.q_chunk,
        )
        new_kv = (ck, cv)
    else:
        o = attention(q, kx, vx, q_offset=pos[:, 0], causal=True,
                      q_chunk=cfg.q_chunk)
        new_kv = (kx, vx)

    out = o.reshape(B, S, H * hd) @ p["wo"]
    return constrain(out, rules, "batch", "seq", "act_embed"), new_kv


# ---------------------------------------------------------------------------
# Dense MLP and MoE (capacity-dropped dispatch, EP over 'expert')
# ---------------------------------------------------------------------------


def dense_mlp(x: torch.Tensor, p: Params, cfg: LMConfig,
              rules: ShardingRules) -> torch.Tensor:
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    wi_out = h @ p["wi"]
    wg_out = h @ p["wg"] if cfg.mlp_type == "swiglu" else None
    act = _mlp_act(cfg, wi_out, wg_out)
    act = constrain(act, rules, "batch", "seq", "ff")
    return act @ p["wo_mlp"]


def moe_mlp(x: torch.Tensor, p: Params, cfg: LMConfig,
            rules: ShardingRules) -> torch.Tensor:
    """Token-choice top-k MoE with per-GROUP capacity (GShard grouping).

    Tokens are grouped by batch row; each token's k choices rank within
    the group by a token-major cumsum, and a choice past the capacity C
    goes to the drop slot E*C.  Dispatch writes each kept choice into its
    own (expert, rank) slot: every kept slot receives exactly one token,
    so a plain indexed write equals the reference's scatter-add without
    atomics (the drop slot, which several choices may hit, is discarded).
    Combine gathers each choice's slot and weights it by its gate.
    """
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    B, S, D = x.shape
    orig_shape = (B, S, D)
    g = cfg.moe.decode_group
    if S == 1 and g > 1 and B % g == 0:
        x = x.reshape(B // g, g, D)   # (G groups, g tokens) — slots /g
        B, S = B // g, g
    E, topk = cfg.moe.n_experts, cfg.moe.top_k
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)

    router_logits = torch.einsum(
        "bsd,de->bse", h.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(router_logits, dim=-1)             # (B, S, E)
    # lax.top_k's order: ties to the lower expert
    gates, eidx = topk_ref(probs.reshape(B * S, E), topk)
    gates = gates.reshape(B, S, topk)
    eidx = eidx.reshape(B, S, topk).to(torch.int64)
    gates = (gates / (gates.sum(-1, keepdim=True) + 1e-9)).to(x.dtype)

    C = max(topk, int(cfg.moe.capacity_factor * S * topk / E))
    eflat = eidx.reshape(B, S * topk)                        # token-major slots
    onehot = F.one_hot(eflat, E)                             # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) - 1                    # rank within group
    pos = torch.gather(pos, 2, eflat[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, eflat * C + pos, E * C)         # E*C = drop slot

    trep = torch.repeat_interleave(h, topk, dim=1)           # (B, S*k, D)
    buf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=x.device)
    b_idx = torch.arange(B, device=x.device)[:, None].expand_as(slot)
    buf = buf.index_put((b_idx, slot), trep)
    xe = buf[:, : E * C].reshape(B, E, C, D)
    xe = constrain(xe, rules, "batch", "expert", None, None)

    wi_out = torch.einsum("becd,edf->becf", xe, p["wi"])
    wg_out = (torch.einsum("becd,edf->becf", xe, p["wg"])
              if cfg.mlp_type == "swiglu" else None)
    act = _mlp_act(cfg, wi_out, wg_out)
    ye = torch.einsum("becf,efd->becd", act, p["wo_mlp"])
    ye = constrain(ye, rules, "batch", "expert", None, None)

    out_slots = torch.cat(
        [ye.reshape(B, E * C, D),
         torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)], dim=1)
    y = torch.gather(out_slots, 1, slot[..., None].expand(B, S * topk, D))
    y = (y.reshape(B, S, topk, D) * gates[..., None]).sum(dim=2)
    return y.reshape(orig_shape)


def mlp_block(x: torch.Tensor, p: Params, cfg: LMConfig,
              rules: ShardingRules) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_mlp(x, p, cfg, rules)
    return dense_mlp(x, p, cfg, rules)
