"""Decoder-only LM family (dense + MoE, GQA), shared by all 5 LM archs.

The port of ``repro.models.transformer``.  Params keep the reference's
tree and stacked ``(L, ...)`` shapes, so carrying weights across is a copy
with no renames (:func:`params_from_numpy`).  The reference's
``lax.scan`` over the stacked layers is a loop over ``l`` here, and its
``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant): policy
``"full"`` recomputes the whole layer in backward, ``"dots"`` saves the
outputs of the products with no batch dimension (the projections, the
reference's ``dots_with_no_batch_dims_saveable``) and recomputes the rest.

Entry points run on the card unless the caller asks for the CPU
(``init_params(..., device="cpu")``); a missing card raises.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.dist.sharding import ShardingRules, constrain
from repro_torch.models import check_device, params_from_numpy  # noqa: F401
from repro_torch.models.layers import (
    LMConfig,
    Params,
    attention_block,
    mlp_block,
    rms_norm,
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: LMConfig) -> Params:
    """The params tree's shapes (the reference's ``init_params`` tree)."""
    d, hd, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    H, K, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layers = {
        "attn_norm": (L, d), "mlp_norm": (L, d),
        "wq": (L, d, H * hd), "wk": (L, d, K * hd),
        "wv": (L, d, K * hd), "wo": (L, H * hd, d),
    }
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        layers["router"] = (L, d, E)
        layers["wi"] = (L, E, d, F)
        if cfg.mlp_type == "swiglu":
            layers["wg"] = (L, E, d, F)
        layers["wo_mlp"] = (L, E, F, d)
    else:
        layers["wi"] = (L, d, F)
        if cfg.mlp_type == "swiglu":
            layers["wg"] = (L, d, F)
        layers["wo_mlp"] = (L, F, d)
    out: Params = {"embed": (cfg.vocab, d), "final_norm": (d,),
                   "layers": layers}
    if not cfg.tie_embeddings:
        out["unembed"] = (d, cfg.vocab)
    return out


def init_params(cfg: LMConfig, seed: int = 0, *,
                device: Any = "cuda") -> Params:
    """Seeded params in ``cfg.dtype``: norms one, every matrix drawn from
    N(0, 0.02^2) in f32 by one ``torch.Generator`` on ``device``, in a
    fixed order.  The draws differ from the reference's ``jax.random``;
    to hold the two against each other, carry the reference's params
    across with :func:`params_from_numpy`."""
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = param_shapes(cfg)

    def w(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * 0.02).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {name: (ones(s) if name.endswith("norm") else w(s))
              for name, s in shapes["layers"].items()}
    params: Params = {"embed": w(shapes["embed"]),
                      "final_norm": ones(shapes["final_norm"]),
                      "layers": layers}
    if "unembed" in shapes:
        params["unembed"] = w(shapes["unembed"])
    return params


def param_shardings(cfg: LMConfig, rules: ShardingRules) -> Params:
    """Per-dimension mesh axes of every param (2-D FSDP x TP layout).

    Every sharded dim is divisibility-guarded: e.g. granite-moe's vocab
    49155 cannot shard over 16 and replicates instead.  Where the rules
    map ``moe_ff`` onto the mesh axes ``embed`` takes (the
    ``serve_weights`` variant), an expert weight would name one mesh axis
    twice, which JAX refuses (``DuplicateSpecError``); its d_model then
    stays whole on each device, so the experts' weights are fully
    resident (EP x TP), as that variant intends."""
    s = rules.spec
    d = rules.if_divisible
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qdim = cfg.n_heads * cfg.head_dim
    kdim = cfg.n_kv_heads * cfg.head_dim
    emb_d = d("embed", D)
    layers = {
        "attn_norm": s("stack", None),
        "mlp_norm": s("stack", None),
        "wq": s("stack", emb_d, d("heads", qdim)),
        "wk": s("stack", emb_d, d("kv_heads", kdim)),
        "wv": s("stack", emb_d, d("kv_heads", kdim)),
        "wo": s("stack", d("heads", qdim), emb_d),
    }
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        moe_f = d("moe_ff", F)
        used = set(_axes(rules, moe_f))
        emb_e = emb_d if not used & set(_axes(rules, emb_d)) else None
        layers["router"] = s("stack", emb_d, None)
        layers["wi"] = s("stack", d("expert", E), emb_e, moe_f)
        if cfg.mlp_type == "swiglu":
            layers["wg"] = s("stack", d("expert", E), emb_e, moe_f)
        layers["wo_mlp"] = s("stack", d("expert", E), moe_f, emb_e)
    else:
        layers["wi"] = s("stack", emb_d, d("ff", F))
        if cfg.mlp_type == "swiglu":
            layers["wg"] = s("stack", emb_d, d("ff", F))
        layers["wo_mlp"] = s("stack", d("ff", F), emb_d)
    out: Params = {
        "embed": s(d("vocab", V), emb_d),
        "final_norm": s(None),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        out["unembed"] = s(emb_d, d("vocab", V))
    return out


def _axes(rules: ShardingRules, name: Optional[str]) -> Tuple[str, ...]:
    axes = rules.spec(name)[0]
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products with no batch dimension (``mm``/``addmm``: the
    projections); recompute everything else, the attention's batched
    products included."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer(x, lp, cfg, rules, positions, cache, cache_len):
    a, new_kv = attention_block(x, lp, cfg, rules, positions=positions,
                                cache=cache, cache_len=cache_len)
    x = x + a
    x = x + mlp_block(x, lp, cfg, rules)
    x = constrain(x, rules, "batch",
                  rules.if_divisible("seq", x.shape[1]), "act_embed")
    return x, new_kv


def _remat_layer(x, lp, cfg, rules, positions):
    return _layer(x, lp, cfg, rules, positions, None, None)[0]


def forward(
    params: Params,
    tokens: torch.Tensor,                # (B, S) int
    cfg: LMConfig,
    rules: ShardingRules,
    *,
    positions: Optional[torch.Tensor] = None,   # (S,) or (B, S)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L,B,T,K,hd) x2
    cache_len: Any = None,               # int, scalar tensor or (B,)
    return_cache: bool = False,
):
    """Logits (B, S, V) in ``cfg.dtype``; with ``return_cache`` also the KV
    cache.  Given a ``cache``, the step's keys and values are written into
    it in place and the same tensors come back; without one, the cache is
    the prompt's (L, B, S, K, hd).

    Token ids must lie in [0, vocab): the reference's ``jnp.take`` fills
    an id out of range with NaN, while the port's row gather raises."""
    B, S = tokens.shape
    dev = tokens.device
    if cache_len is not None:
        cache_len = torch.as_tensor(cache_len, device=dev)
    if positions is None:
        positions = torch.arange(S, device=dev)
    x = params["embed"].index_select(0, tokens.reshape(-1)).reshape(
        B, S, -1).to(cfg.dtype)
    seq_ax = rules.if_divisible("seq", S)
    x = constrain(x, rules, "batch", seq_ax, "act_embed")

    # one view per layer; unbind's backward stacks the layers' gradients
    names = list(params["layers"])
    per_layer = [dict(zip(names, ws)) for ws in
                 zip(*(params["layers"][n].unbind(0) for n in names))]
    remat = (cfg.remat and torch.is_grad_enabled() and cache is None
             and not return_cache)
    if remat:
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)

        kw = {}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
    ks, vs = [], []
    for l, lp in enumerate(per_layer):
        if remat:
            x = checkpoint(_remat_layer, x, lp, cfg, rules, positions,
                           use_reentrant=False, **kw)
            continue
        kv = None if cache is None else (cache[0][l], cache[1][l])
        x, (nk, nv) = _layer(x, lp, cfg, rules, positions, kv, cache_len)
        if return_cache and cache is None:
            ks.append(nk)
            vs.append(nv)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    unembed = params.get("unembed")
    if unembed is None:
        unembed = params["embed"].T
    logits = x @ unembed.to(cfg.dtype)                      # (B, S, V)
    logits = constrain(logits, rules, "batch", seq_ax,
                       rules.if_divisible("vocab", cfg.vocab))
    if return_cache:
        new_cache = cache if cache is not None else (torch.stack(ks),
                                                     torch.stack(vs))
        return logits, new_cache
    return logits


def lm_loss(
    params: Params,
    batch: Dict[str, torch.Tensor],      # tokens (B,S), labels (B,S)
    cfg: LMConfig,
    rules: ShardingRules,
) -> torch.Tensor:
    """Mean next-token cross-entropy, its logsumexp in f32."""
    logits = forward(params, batch["tokens"], cfg, rules).to(torch.float32)
    labels = batch["labels"].to(torch.int64)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_step(
    params: Params,
    tokens: torch.Tensor,                # (B, S) the prompt
    cfg: LMConfig,
    rules: ShardingRules,
):
    """Prompt pass: returns (last-position logits, KV cache (L,B,S,K,hd))."""
    logits, cache = forward(params, tokens, cfg, rules, return_cache=True)
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(
    params: Params,
    token: torch.Tensor,                 # (B, 1) newest token
    cache: Tuple[torch.Tensor, torch.Tensor],  # (L,B,T,K,hd) x2, T = max ctx
    cache_len: Any,                      # current cache fill: scalar or (B,)
    cfg: LMConfig,
    rules: ShardingRules,
):
    """One autoregressive step against a pre-filled KV cache, written in
    place.  ``cache_len`` may differ per row (the decode engine's slots):
    each row then reads its own position and valid length."""
    cache_len = torch.as_tensor(cache_len, device=token.device)
    positions = (cache_len.reshape(-1, 1) if cache_len.dim() else cache_len) \
        + torch.arange(1, device=token.device)
    logits, new_cache = forward(
        params, token, cfg, rules,
        positions=positions, cache=cache, cache_len=cache_len,
        return_cache=True,
    )
    return logits[:, -1], new_cache


def make_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device: Any = "cuda"):
    """Empty KV cache (L, B, T, K, hd) x 2."""
    dt = dtype or cfg.dtype
    dev = check_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def cache_shardings(cfg: LMConfig, rules: ShardingRules):
    spec = rules.spec("stack", "batch", "seq",
                      rules.if_divisible("kv_heads", cfg.n_kv_heads), None)
    return spec, spec
