"""RecSys model family: DLRM, BST, AutoInt, Two-Tower retrieval.

The port of ``repro.models.recsys``, as plain PyTorch (the reference's are
plain ``jnp``):

* ``embedding_bag`` — ragged multi-hot lookup: a row gather and a masked
  sum or mean over the bag (-1 marks padding).  A table's gradient is
  dense, as under ``jnp.take``: the gather's backward writes a zero
  tensor of the table's shape and adds the rows in.
* Row-sharded embedding tables: big tables (Criteo 1TB / MLPerf: ~188M
  rows) name 'table_rows' in their specs.  Placed over the devices of
  the 'model' axis (``dist/sharding.place_rows``, or ``dlrm_init``'s
  ``devices``) such a table is a ``RowShardedTable`` of contiguous row
  blocks, and :func:`embedding_lookup` routes each id to its block and
  brings only the looked-up rows to the lead device.

The Two-Tower ``retrieval_cand`` step (``configs/recsys_archs.py``)
scores one user against 1M precomputed item-tower vectors through the
``pem_score``, ``topk`` and ``mmr`` kernels.

Params keep the reference's trees (dicts and lists), so the reference's
weights carry across with :func:`params_from_numpy`.  Init functions draw
on the card unless the caller asks for the CPU (``device="cpu"``), and
give empty tensors on the meta device (the dry run).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (AbstractMesh, RowShardedTable,
                                       ShardingRules, constrain,
                                       default_rules, place_leaf)
from repro_torch.models import Draws, params_from_numpy  # noqa: F401

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------


def embedding_lookup(table: Any, idx: torch.Tensor) -> torch.Tensor:
    """Single-value lookup: (V, D) x (B,) -> (B, D) on ``idx``'s device,
    from a whole table or a :class:`RowShardedTable`."""
    if isinstance(table, RowShardedTable):
        return _sharded_lookup(table, idx)
    return table.index_select(0, idx.reshape(-1).long())


def _sharded_lookup(table: RowShardedTable, idx: torch.Tensor) -> torch.Tensor:
    """Each id routed to its row block (``id // block``); each block's
    device gathers its own rows, which come back to ``idx``'s device and
    are scattered into the output at their positions.  Rows are copied,
    never summed, so the result is bit-equal to a lookup in the whole
    table, and only the B looked-up rows cross between devices."""
    ids = idx.reshape(-1).long()
    owner = torch.div(ids, table.block, rounding_mode="floor")
    counts = torch.bincount(owner, minlength=table.n_shards).tolist()
    if len(counts) > table.n_shards:
        raise IndexError(f"an id is past the table's {table.shape[0]} rows")
    order = torch.argsort(owner, stable=True)
    out = torch.empty((ids.numel(), table.shape[1]), dtype=table.dtype,
                      device=ids.device)
    for s, (pos, blk) in enumerate(zip(order.split(counts), table.blocks)):
        if not counts[s]:
            continue
        local = (ids.index_select(0, pos) - s * table.block).to(blk.device)
        out.index_copy_(0, pos, blk.index_select(0, local).to(ids.device))
        table.routed[s] += counts[s]
    return out


def embedding_bag(
    table: Any,               # (V, D): a tensor or a RowShardedTable
    idx: torch.Tensor,        # (B, L) int, padded with -1
    mode: str = "sum",
) -> torch.Tensor:
    """Manual EmbeddingBag: gather + masked reduce over the bag dim."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    mask = (idx >= 0).to(table.dtype)                     # (B, L)
    safe = torch.clamp(idx, min=0)
    vecs = embedding_lookup(table, safe).view(*idx.shape, table.shape[1])
    s = torch.sum(vecs * mask[..., None], dim=1)
    if mode == "sum":
        return s
    return s / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)


def mlp(x: torch.Tensor, ws: Sequence[torch.Tensor],
        bs: Sequence[torch.Tensor], final_act: bool = False) -> torch.Tensor:
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1 or final_act:
            x = F.relu(x)
    return x


def _init_mlp(draw: Draws, dims: Sequence[int]) -> Tuple[List, List]:
    ws = [draw.normal((a, b), (2.0 / a) ** 0.5)
          for a, b in zip(dims[:-1], dims[1:])]
    return ws, [draw.zeros((b,)) for b in dims[1:]]


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    # softplus as jax.nn.softplus computes it: log(1 + e^x), no threshold
    softplus = torch.logaddexp(logits, torch.zeros_like(logits))
    return torch.mean(softplus - labels * logits)


def _softmax_f32(sc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Attention weights in f32, cast back to the model's dtype."""
    return torch.softmax(sc.to(torch.float32), dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# DLRM (MLPerf config) [arXiv:1906.00091]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    embed_dim: int = 128
    vocab_sizes: Tuple[int, ...] = ()
    bot_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    dtype: torch.dtype = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def padded_vocab_sizes(self) -> Tuple[int, ...]:
        """Row counts padded to 512 so row-sharded tables split evenly on
        any production mesh (standard embedding-table padding); lookups
        only ever index < the published vocab size."""
        return tuple((v + 511) // 512 * 512 for v in self.vocab_sizes)


# tables smaller than this are replicated instead of row-sharded
_SHARD_MIN_ROWS = 4096


def dlrm_init(cfg: DLRMConfig, seed: int = 0, *, device: Any = "cuda",
              devices: Optional[Sequence[Any]] = None) -> Params:
    """Seeded DLRM params on ``device``.  With ``devices`` (S of them, the
    mesh's 'model' axis, the first the lead) they are placed as
    :func:`dlrm_shardings` lays them out while they are drawn: each table
    is drawn whole on ``device`` from the same generator in the same order,
    then split into S row blocks (or moved whole to the lead) and freed, so
    the placed values equal the unplaced init's and no device holds more
    than one whole table beside its blocks."""
    draw = Draws(seed, device, cfg.dtype)
    specs = None if devices is None else dlrm_shardings(cfg, default_rules(
        AbstractMesh((1, len(devices)), ("data", "model"))))

    def put(t, key, j):
        if specs is None:
            return t
        return place_leaf(t, specs[key][j], devices, f"{key}/{j}")

    tables = [put(draw.uniform((v, cfg.embed_dim), 1.0 / v ** 0.5),
                  "tables", i)
              for i, v in enumerate(cfg.padded_vocab_sizes)]
    n_int = cfg.n_sparse + 1
    d_inter = (n_int * (n_int - 1)) // 2
    bw, bb = _init_mlp(draw, (cfg.n_dense,) + cfg.bot_mlp)
    tw, tb = _init_mlp(draw, (cfg.bot_mlp[-1] + d_inter,) + cfg.top_mlp)
    params = {"tables": tables, "bot_w": bw, "bot_b": bb, "top_w": tw,
              "top_b": tb}
    for k in ("bot_w", "bot_b", "top_w", "top_b"):
        params[k] = [put(t, k, j) for j, t in enumerate(params[k])]
    return params


def dlrm_shardings(cfg: DLRMConfig, rules: ShardingRules) -> Params:
    s = rules.spec
    return {
        "tables": [
            s("table_rows" if v >= _SHARD_MIN_ROWS else None, None)
            for v in cfg.padded_vocab_sizes
        ],
        "bot_w": [s(None, None)] * len(cfg.bot_mlp),
        "bot_b": [s(None)] * len(cfg.bot_mlp),
        "top_w": [s(None, None)] * len(cfg.top_mlp),
        "top_b": [s(None)] * len(cfg.top_mlp),
    }


def dlrm_forward(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: DLRMConfig, rules: ShardingRules) -> torch.Tensor:
    dense = batch["dense"].to(cfg.dtype)                  # (B, 13)
    sparse = batch["sparse"]                              # (B, 26) int
    x = mlp(dense, params["bot_w"], params["bot_b"], final_act=True)  # (B, D)
    embs = [embedding_lookup(t, sparse[:, i])
            for i, t in enumerate(params["tables"])]
    z = torch.stack([x] + embs, dim=1)                    # (B, 27, D)
    z = constrain(z, rules, "batch", None, None)
    inter = torch.bmm(z, z.transpose(1, 2))               # pairwise dots
    n_int = z.shape[1]
    # jnp.triu_indices(n, k=1)'s order: row-major over i < j
    iu, ju = torch.triu_indices(n_int, n_int, offset=1, device=z.device)
    flat = inter[:, iu, ju]                               # (B, n(n-1)/2)
    top_in = torch.cat([x, flat], dim=1)
    return mlp(top_in, params["top_w"], params["top_b"])[:, 0]   # (B,)


def dlrm_loss(params, batch, cfg: DLRMConfig, rules) -> torch.Tensor:
    return bce_with_logits(dlrm_forward(params, batch, cfg, rules),
                           batch["labels"])


# ---------------------------------------------------------------------------
# BST — Behavior Sequence Transformer [arXiv:1905.06874]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str
    vocab_items: int = 2_000_000
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    d_ff: int = 128
    mlp_dims: Tuple[int, ...] = (1024, 512, 256, 1)
    n_other_feats: int = 8
    dtype: torch.dtype = torch.float32


def bst_init(cfg: BSTConfig, seed: int = 0, *, device: Any = "cuda") -> Params:
    draw = Draws(seed, device, cfg.dtype)
    D = cfg.embed_dim
    p: Params = {
        "item_table": draw.uniform((cfg.vocab_items, D),
                                   1.0 / cfg.vocab_items ** 0.5),
        "pos_table": draw.normal((cfg.seq_len + 1, D), 0.02),
        "blocks": [],
    }

    def w(a, b):
        return draw.normal((a, b), (2.0 / a) ** 0.5)

    for _ in range(cfg.n_blocks):
        p["blocks"].append({
            "wq": w(D, D), "wk": w(D, D), "wv": w(D, D), "wo": w(D, D),
            "ff1": w(D, cfg.d_ff), "ff2": w(cfg.d_ff, D),
            "ln1": draw.ones((D,)), "ln2": draw.ones((D,)),
        })
    flat_in = (cfg.seq_len + 1) * D + cfg.n_other_feats
    p["mlp_w"], p["mlp_b"] = _init_mlp(draw, (flat_in,) + cfg.mlp_dims)
    return p


def _ln(x, scale):
    """Layer norm without a bias, rsqrt(v + 1e-6) as the reference's."""
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + 1e-6) * scale


def bst_forward(params: Params, batch: Dict[str, torch.Tensor],
                cfg: BSTConfig, rules: ShardingRules) -> torch.Tensor:
    hist = batch["hist"]                                  # (B, S) int
    target = batch["target"]                              # (B,) int
    other = batch["other"].to(cfg.dtype)                  # (B, n_other)
    B = hist.shape[0]
    seq = torch.cat([hist, target[:, None]], dim=1)       # (B, S+1)
    x = embedding_lookup(params["item_table"], seq).view(
        B, cfg.seq_len + 1, -1)
    x = x + params["pos_table"][None]
    x = constrain(x, rules, "batch", None, None)
    H, D = cfg.n_heads, cfg.embed_dim
    hd = D // H
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q = (h @ blk["wq"]).view(B, -1, H, hd)
        k = (h @ blk["wk"]).view(B, -1, H, hd)
        v = (h @ blk["wv"]).view(B, -1, H, hd)
        sc = torch.einsum("bshd,bthd->bhst", q, k) * (hd ** -0.5)
        a = _softmax_f32(sc, cfg.dtype)
        o = torch.einsum("bhst,bthd->bshd", a, v).reshape(B, -1, D)
        x = x + o @ blk["wo"]
        h = _ln(x, blk["ln2"])
        x = x + F.relu(h @ blk["ff1"]) @ blk["ff2"]
    flat = torch.cat([x.reshape(B, -1), other], dim=1)
    return mlp(flat, params["mlp_w"], params["mlp_b"])[:, 0]


def bst_loss(params, batch, cfg: BSTConfig, rules) -> torch.Tensor:
    return bce_with_logits(bst_forward(params, batch, cfg, rules),
                           batch["labels"])


# ---------------------------------------------------------------------------
# AutoInt [arXiv:1810.11921]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str
    n_fields: int = 39
    vocab_per_field: int = 100_000
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    dtype: torch.dtype = torch.float32


def autoint_init(cfg: AutoIntConfig, seed: int = 0, *,
                 device: Any = "cuda") -> Params:
    draw = Draws(seed, device, cfg.dtype)
    p: Params = {
        "table": draw.uniform((cfg.n_fields * cfg.vocab_per_field,
                               cfg.embed_dim), 1.0 / cfg.vocab_per_field ** 0.5),
        "layers": [],
    }
    d_in, d_out = cfg.embed_dim, cfg.n_heads * cfg.d_attn
    for _ in range(cfg.n_attn_layers):
        s = (2.0 / d_in) ** 0.5
        p["layers"].append({name: draw.normal((d_in, d_out), s)
                            for name in ("wq", "wk", "wv", "wres")})
        d_in = d_out
    p["out_w"] = draw.normal((cfg.n_fields * d_in, 1), 0.02)
    p["out_b"] = draw.zeros((1,))
    return p


def autoint_forward(params: Params, batch: Dict[str, torch.Tensor],
                    cfg: AutoIntConfig, rules: ShardingRules) -> torch.Tensor:
    sparse = batch["sparse"]                               # (B, F) int
    B, Fn = sparse.shape
    offset = torch.arange(Fn, device=sparse.device,
                          dtype=torch.int64) * cfg.vocab_per_field
    x = embedding_lookup(params["table"], sparse.long() + offset[None])
    x = x.view(B, Fn, cfg.embed_dim)
    x = constrain(x, rules, "batch", None, None)
    H, da = cfg.n_heads, cfg.d_attn
    for lp in params["layers"]:
        q = (x @ lp["wq"]).view(B, Fn, H, da)
        k = (x @ lp["wk"]).view(B, Fn, H, da)
        v = (x @ lp["wv"]).view(B, Fn, H, da)
        sc = torch.einsum("bfhd,bghd->bhfg", q, k) * (da ** -0.5)
        a = _softmax_f32(sc, cfg.dtype)
        o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, Fn, H * da)
        x = F.relu(o + x @ lp["wres"])
    return (x.reshape(B, -1) @ params["out_w"] + params["out_b"])[:, 0]


def autoint_loss(params, batch, cfg: AutoIntConfig, rules) -> torch.Tensor:
    return bce_with_logits(autoint_forward(params, batch, cfg, rules),
                           batch["labels"])


# ---------------------------------------------------------------------------
# Two-Tower retrieval [Yi et al., RecSys'19]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    vocab_user: int = 5_000_000
    vocab_item: int = 10_000_000
    hist_len: int = 20
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    dtype: torch.dtype = torch.float32


def twotower_init(cfg: TwoTowerConfig, seed: int = 0, *,
                  device: Any = "cuda") -> Params:
    draw = Draws(seed, device, cfg.dtype)
    user = draw.uniform((cfg.vocab_user, cfg.embed_dim),
                        1.0 / cfg.vocab_user ** 0.5)
    item = draw.uniform((cfg.vocab_item, cfg.embed_dim),
                        1.0 / cfg.vocab_item ** 0.5)
    uw, ub = _init_mlp(draw, (2 * cfg.embed_dim,) + cfg.tower_mlp)
    iw, ib = _init_mlp(draw, (cfg.embed_dim,) + cfg.tower_mlp)
    return {"user_table": user, "item_table": item,
            "user_w": uw, "user_b": ub, "item_w": iw, "item_b": ib}


def _unit(u: torch.Tensor) -> torch.Tensor:
    return u / torch.clamp(torch.linalg.vector_norm(u, dim=-1, keepdim=True),
                           min=1e-6)


def user_tower(params: Params, batch, cfg: TwoTowerConfig,
               rules) -> torch.Tensor:
    ue = embedding_lookup(params["user_table"], batch["user_id"])
    he = embedding_bag(params["item_table"], batch["hist"], mode="mean")
    x = torch.cat([ue, he], dim=1)
    return _unit(mlp(x, params["user_w"], params["user_b"]))


def item_tower(params: Params, item_ids: torch.Tensor, cfg: TwoTowerConfig,
               rules) -> torch.Tensor:
    ie = embedding_lookup(params["item_table"], item_ids)
    return _unit(mlp(ie, params["item_w"], params["item_b"]))


def twotower_loss(params, batch, cfg: TwoTowerConfig, rules) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction."""
    u = user_tower(params, batch, cfg, rules)                # (B, D)
    v = item_tower(params, batch["pos_item"], cfg, rules)    # (B, D)
    logits = (u @ v.T) / 0.05                                # temperature
    logq = batch.get("logq")
    if logq is not None:
        logits = logits - logq[None, :]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits)
    return torch.mean(logz - gold)


def retrieval_scores(
    params: Params,
    batch,
    candidate_matrix: torch.Tensor,   # (N_cand, D) PRECOMPUTED item-tower out
    cfg: TwoTowerConfig,
    rules: ShardingRules,
) -> torch.Tensor:
    """Score one/few queries against the full candidate corpus: (N, B).
    The ``retrieval_cand`` step scores through the kernels instead
    (``configs/recsys_archs.py``)."""
    u = user_tower(params, batch, cfg, rules)                # (B, D)
    cand = constrain(candidate_matrix, rules, "candidates", None)
    return cand @ u.T
