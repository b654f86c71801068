"""The four assigned recsys architectures.

The port of ``repro.configs.recsys_archs``.  Shapes (assignment):
    train_batch    batch=65,536        -> train_step
    serve_p99      batch=512           -> serve_step (forward)
    serve_bulk     batch=262,144       -> serve_step (offline scoring)
    retrieval_cand batch=1, 1M cands   -> retrieval scoring. For two-tower
                   this is the paper's PEM surface (modulated scoring +
                   top-k + MMR over a 1M-row candidate matrix) through the
                   three kernels (``configs/flexvec.pem_serve_step``); for
                   the pointwise CTR models it lowers bulk candidate
                   scoring.

``build`` gives each cell's step over meta tensors of the global shapes;
:meth:`RecsysArch.step_cost` is the port's own count of one device's step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import (ArchSpec, LoweredSpec, ShapeCell, meta,
                                      named_leaves, train_spec)
from repro_torch.configs.flexvec import pem_serve_step, step_work
from repro_torch.data import recsys as RD
from repro_torch.data.recsys import CRITEO_1TB_VOCAB_SIZES
from repro_torch.dist.sharding import ShardingRules, default_rules
from repro_torch.models import recsys as R
from repro_torch.roofline.analysis import KernelWork, StepCost
from repro_torch.train.optimizer import loss_and_grads

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

POOL, OVER = 500, 1500    # retrieval_cand: MMR picks 500 of the top 1,500


class RecsysArch(ArchSpec):
    family = "recsys"

    def __init__(self, arch_id: str, source: str, cfg, init_fn, loss_fn,
                 fwd_fn, batch_fn, shardings_fn, smoke_cfg):
        self.arch_id = arch_id
        self.source = source
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg
        self._init = init_fn             # (cfg, seed, device=) -> params
        self._loss = loss_fn
        self._fwd = fwd_fn
        self._batch = batch_fn           # (cfg, batch_size) -> struct dict+specs
        self._shardings = shardings_fn   # (cfg, params, rules) -> spec tree

    def cells(self) -> Dict[str, ShapeCell]:
        out = {}
        for name, s in SHAPES.items():
            desc = f"batch={s['batch']}"
            if name == "retrieval_cand":
                desc += f" n_candidates={s['n_candidates']}"
                if self.arch_id != "two-tower-retrieval":
                    desc += " (pointwise CTR: lowered as bulk candidate scoring)"
            out[name] = ShapeCell(name=name, kind=s["kind"], desc=desc)
        return out

    def _retrieval(self, shape: str) -> bool:
        return shape == "retrieval_cand" and self.arch_id == "two-tower-retrieval"

    def model_flops(self, shape: str) -> float:
        s = SHAPES[shape]
        if self._retrieval(shape):
            # step scores a PRECOMPUTED candidate matrix: dot per candidate
            # + one user tower + MMR over the oversample pool (B=1)
            D = self.cfg.tower_mlp[-1]
            dims = (2 * self.cfg.embed_dim,) + self.cfg.tower_mlp
            tower = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
            return (2.0 * s["n_candidates"] * D + tower
                    + 2.0 * POOL * OVER * D)
        b = s["batch"] if shape != "retrieval_cand" else s["n_candidates"]
        per_ex = _flops_per_example(self.arch_id, self.cfg)
        mult = 3.0 if s["kind"] == "train" else 1.0
        return mult * per_ex * b

    def cost_corrections(self, shape: str, chips: int):
        """The reference's analytic MMR term (its XLA count sees one
        step); the port's count already holds every K3 step."""
        if self._retrieval(shape):
            D = self.cfg.tower_mlp[-1]
            per_iter = 4.0 * OVER * D + 6.0 * OVER
            return (POOL - 1) * per_iter, (POOL - 1) * OVER * D * 4.0
        return 0.0, 0.0

    def _meta_params(self, rules: ShardingRules):
        params = self._init(self.cfg, device="meta")
        return params, self._shardings(self.cfg, params, rules)

    def _meta_leaves(self, rules: ShardingRules):
        """The params' meta leaves, each with its spec, and the tree's
        structure to rebuild them."""
        params, specs = self._meta_params(rules)
        leaves, tdef = pytree.tree_flatten(params)
        return [meta(t.shape, t.dtype, sp) for t, (_, sp) in
                zip(leaves, named_leaves(specs))], tdef

    def build(self, shape: str, mesh: Any, rules: ShardingRules) -> LoweredSpec:
        s = SHAPES[shape]
        cfg = self.cfg
        if self._retrieval(shape):
            return self._build_retrieval(s, rules)
        batch_size = s["batch"] if shape != "retrieval_cand" else s["n_candidates"]
        struct, bspec = self._batch(cfg, batch_size)
        bspec = bspec(rules)
        batch = {k: meta(shp, dt, bspec[k]) for k, (shp, dt) in struct.items()}
        desc = f"{self.arch_id}/{shape}"
        if s["kind"] == "train":
            loss_fn = self._loss
            params, specs = self._meta_params(rules)
            return train_spec(lambda p, b: loss_fn(p, b, cfg, rules), params,
                              specs, batch, desc)
        p, tdef = self._meta_leaves(rules)
        names, n = list(batch), len(p)
        fwd = self._fwd

        def serve_step(*args):
            return fwd(pytree.tree_unflatten(list(args[:n]), tdef),
                       dict(zip(names, args[n:])), cfg, rules)

        return LoweredSpec(fn=serve_step, args=tuple(p) + tuple(batch.values()),
                           static_desc=desc)

    def _build_retrieval(self, s, rules: ShardingRules) -> LoweredSpec:
        """Two-tower retrieval_cand: the paper's Phase-2 on 1M candidates
        (:func:`retrieval_step`)."""
        cfg = self.cfg
        shards = max(rules.size_of("candidates"), 1)
        N = (s["n_candidates"] + shards - 1) // shards * shards  # pad to shard
        D = cfg.tower_mlp[-1]
        p, tdef = self._meta_leaves(rules)
        i32, f32 = torch.int32, torch.float32
        rest = (meta((1,), i32, rules.spec(None)),
                meta((1, cfg.hist_len), i32, rules.spec(None, None)),
                meta((N, D), f32, rules.spec("candidates", None)),
                meta((N,), f32, rules.spec("candidates")))
        n = len(p)

        def step(*args):
            uid, hist, cand, days = args[n:]
            return retrieval_step(pytree.tree_unflatten(list(args[:n]), tdef),
                                  {"user_id": uid, "hist": hist}, cand, days,
                                  cfg, rules)

        return LoweredSpec(fn=step, args=tuple(p) + rest,
                           static_desc=f"{self.arch_id}/retrieval_cand")

    def step_cost(self, shape: str, rules: ShardingRules) -> StepCost:
        s = SHAPES[shape]
        if self._retrieval(shape):
            return retrieval_step_cost(self.cfg, s["n_candidates"], rules)
        b = s["batch"] if shape != "retrieval_cand" else s["n_candidates"]
        params, specs = self._meta_params(rules)
        return recsys_step_cost(self.arch_id, self.cfg, params, specs, b,
                                s["kind"] == "train", rules)

    def smoke_run(self, device: Any = "cuda") -> Dict[str, Any]:
        """The reference's smoke path on ``device`` (the card unless the
        caller asks for the CPU): the smoke config's loss and gradients
        and its forward on a seeded batch of 16."""
        from repro_torch.launch.mesh import make_local_mesh

        rules = default_rules(make_local_mesh(device))
        cfg = self.smoke_cfg
        params = self._init(cfg, 0, device=device)
        data = smoke_data(self.arch_id, cfg, 16, device)
        loss, grads = loss_and_grads(
            lambda p, b: self._loss(p, b, cfg, rules), params, data)
        with torch.no_grad():
            fwd_out = self._fwd(params, data, cfg, rules)
        return {
            "loss": float(loss),
            "grad_finite": all(bool(torch.isfinite(x).all())
                               for x in pytree.tree_leaves(grads)),
            "fwd_shape": tuple(fwd_out.shape),
        }


def retrieval_step(params, batch, cand: torch.Tensor, days: torch.Tensor,
                   cfg: R.TwoTowerConfig, rules: ShardingRules):
    """Two-tower ``retrieval_cand``: the user tower, then the paper's
    Phase 2 over the (N, D) precomputed item-tower vectors in PEM's fixed
    order (similarity -> decay:30 -> top 1,500 -> MMR 500, lambda 0.7):
    ``pem_serve_step`` with q_pre the user vector and q_sup zero, so K1
    scores decay * (cand @ u), K2 takes the top 1,500, the pool's rows are
    gathered and K3 picks 500.  Returns ``(final_idx, final_scores)``,
    each (B, 500), ids as int32 candidate rows in selection order."""
    with torch.no_grad():
        u = R.user_tower(params, batch, cfg, rules)           # (B, D)
    q = u.T.contiguous()
    return pem_serve_step(cand, days, q, torch.zeros_like(q), pool=POOL,
                          over=OVER)


def _mlp_flops(dims) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def _flops_per_example(arch_id: str, cfg) -> float:
    """Analytic forward FLOPs per example (matmul-dominated terms)."""
    if arch_id == "dlrm-mlperf":
        n_int = cfg.n_sparse + 1
        inter = 2.0 * n_int * n_int * cfg.embed_dim
        d_inter = n_int * (n_int - 1) // 2
        return (_mlp_flops((cfg.n_dense,) + cfg.bot_mlp)
                + inter
                + _mlp_flops((cfg.bot_mlp[-1] + d_inter,) + cfg.top_mlp))
    if arch_id == "bst":
        S, D = cfg.seq_len + 1, cfg.embed_dim
        attn = cfg.n_blocks * (4 * 2.0 * S * D * D + 2 * 2.0 * S * S * D
                               + 2.0 * S * D * cfg.d_ff * 2)
        return attn + _mlp_flops((S * D + cfg.n_other_feats,) + cfg.mlp_dims)
    if arch_id == "autoint":
        F = cfg.n_fields
        d_in, total = cfg.embed_dim, 0.0
        for _ in range(cfg.n_attn_layers):
            d_out = cfg.n_heads * cfg.d_attn
            total += 4 * 2.0 * F * d_in * d_out + 2 * 2.0 * F * F * d_out
            d_in = d_out
        return total + 2.0 * F * d_in
    if arch_id == "two-tower-retrieval":
        # retrieval path: item tower per candidate + dot
        return (_mlp_flops((cfg.embed_dim,) + cfg.tower_mlp)
                + 2.0 * cfg.tower_mlp[-1])
    raise KeyError(arch_id)


def _example_work(arch_id: str, cfg, train: bool) -> Tuple[int, int, float]:
    """(table rows an example gathers, their width, dense forward
    operations an example) of the step the cell runs: the pointwise
    models' forward, or the two-tower user tower (its serve step) and,
    training, the item tower over the positive."""
    if arch_id == "dlrm-mlperf":
        return cfg.n_sparse, cfg.embed_dim, _flops_per_example(arch_id, cfg)
    if arch_id == "bst":
        return cfg.seq_len + 1, cfg.embed_dim, _flops_per_example(arch_id, cfg)
    if arch_id == "autoint":
        return cfg.n_fields, cfg.embed_dim, _flops_per_example(arch_id, cfg)
    E, tower = cfg.embed_dim, cfg.tower_mlp
    user = _mlp_flops((2 * E,) + tower)
    if train:
        return 2 + cfg.hist_len, E, user + _mlp_flops((E,) + tower)
    return 1 + cfg.hist_len, E, user


def recsys_step_cost(arch_id: str, cfg, params, specs, batch: int,
                     train: bool, rules: ShardingRules) -> StepCost:
    """One device's count of a pointwise step (train or forward) over its
    share of the batch ('batch' axes), tables row-sharded by their specs.

    Work: the embedding gathers (the rows read and written; training adds
    each table's dense gradient, as under ``jnp.take``: the device's block
    written, the rows added in); the dense layers (per-example operations
    from the shapes, the dense params read and each example's gathered
    input; three passes when training); for two-tower training the
    in-batch (B, B) logits over the gathered item vectors; then AdamW over
    the device's params.  Collectives: the gathered rows from the tables'
    row shards (an all-to-all, and its reverse for the rows' gradients),
    the all-reduce of the replicated params' gradients over the data
    axes, and for two-tower training the item vectors' all-gather.
    Temporaries: the gathered rows, three times when training (kept for
    the backward and their gradient), and two-tower's logits."""
    es = 4
    dp = rules.size_of("batch")
    b_l = batch / dp
    rows, width, dense = _example_work(arch_id, cfg, train)
    passes = 3.0 if train else 1.0
    table_local = dense_local = n_local = 0.0
    tp = 1  # the row shards of the most sharded table
    for (name, t), (_, sp) in zip(named_leaves(params), named_leaves(specs)):
        block = rules.block_shape(tuple(t.shape), sp)
        n_local += math.prod(block)
        if "table" in name:
            table_local += math.prod(block) * es
            tp = max(tp, t.shape[0] // block[0])
        else:
            dense_local += math.prod(block) * es
    gathered = b_l * rows * width * es
    kernels = {
        "embedding": KernelWork(flops=0.0, nbytes=2.0 * gathered + (
            table_local + gathered if train else 0.0)),
        "dense": KernelWork(
            flops=dense * b_l * passes,
            nbytes=(dense_local + gathered + b_l * 4.0) * passes),
    }
    coll: Dict[str, float] = {}
    if tp > 1:
        coll["all-to-all"] = (2.0 if train else 1.0) * gathered * (tp - 1) / tp
    temp = gathered * passes
    if train:
        kernels["adamw"] = KernelWork(flops=14.0 * n_local,
                                      nbytes=n_local * (3 * es + 16))
        if dp > 1:
            coll["all-reduce"] = 2.0 * dense_local * (dp - 1) / dp
        if arch_id == "two-tower-retrieval":
            D = cfg.tower_mlp[-1]
            kernels["logits"] = KernelWork(
                flops=2.0 * b_l * batch * D * passes,
                nbytes=(b_l * D + batch * D + b_l * batch) * es * passes)
            temp += passes * b_l * batch * es
            if dp > 1:
                coll["all-gather"] = batch * D * es * (dp - 1) / dp
    return StepCost(kernels=kernels, collectives=coll, temp_bytes=temp)


def retrieval_step_cost(cfg: R.TwoTowerConfig, n_candidates: int,
                        rules: ShardingRules) -> StepCost:
    """One device's count of :func:`retrieval_step`: the user tower (its
    rows and weights read, its operations), then the kernels as
    ``configs/flexvec.step_work(n, 1, 1500, 500, d=256)`` counts them, K1
    on the device's candidate rows and, as the one-stage flexvec step
    does, K2 over all N after the (N, 1) panel's all-gather; the pool's
    rows summed over the ranks (an all-reduce)."""
    shards = max(rules.size_of("candidates"), 1)
    n = (n_candidates + shards - 1) // shards * shards
    n_local = n // shards
    E, tower = cfg.embed_dim, cfg.tower_mlp
    D = tower[-1]
    dims = (2 * E,) + tower
    w_bytes = sum((a + 1) * b for a, b in zip(dims[:-1], dims[1:])) * 4.0
    work = step_work(n_local, 1, OVER, POOL, d=D)
    work["user_tower"] = KernelWork(
        flops=_mlp_flops(dims), nbytes=(1 + cfg.hist_len) * E * 4.0 + w_bytes)
    coll: Dict[str, float] = {}
    if shards > 1:
        from repro_torch.configs.flexvec import topk_work

        work["topk"] = topk_work(1, n, OVER)
        coll["all-gather"] = n * 4.0
        coll["all-reduce"] = OVER * D * 4.0
    temp = max(n * 4.0 + OVER * 12.0, OVER * 12.0 + OVER * D * 4.0)
    return StepCost(kernels=work, collectives=coll, temp_bytes=temp)


def smoke_data(arch_id: str, cfg, b: int, device: Any,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """A seeded batch of ``b`` from ``data/recsys.py`` on ``device``."""
    if arch_id == "dlrm-mlperf":
        raw = RD.dlrm_batch(b, cfg.n_dense, cfg.vocab_sizes, seed)
    elif arch_id == "bst":
        raw = RD.bst_batch(b, cfg.seq_len, cfg.vocab_items, cfg.n_other_feats,
                           seed)
    elif arch_id == "autoint":
        raw = RD.autoint_batch(b, cfg.n_fields, cfg.vocab_per_field, seed)
    elif arch_id == "two-tower-retrieval":
        raw = RD.twotower_batch(b, cfg.vocab_user, cfg.vocab_item,
                                cfg.hist_len, seed)
    else:
        raise KeyError(arch_id)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


# ---------------------------------------------------------------------------
# each model's batch: ({name: (shape, dtype)}, specs)
# ---------------------------------------------------------------------------

_I32, _F32 = torch.int32, torch.float32


def _dlrm_batch(cfg: R.DLRMConfig, b: int):
    struct = {
        "dense": ((b, cfg.n_dense), _F32),
        "sparse": ((b, cfg.n_sparse), _I32),
        "labels": ((b,), _F32),
    }
    return struct, lambda r: {
        "dense": r.spec("batch", None),
        "sparse": r.spec("batch", None),
        "labels": r.spec("batch"),
    }


def _bst_batch(cfg: R.BSTConfig, b: int):
    struct = {
        "hist": ((b, cfg.seq_len), _I32),
        "target": ((b,), _I32),
        "other": ((b, cfg.n_other_feats), _F32),
        "labels": ((b,), _F32),
    }
    return struct, lambda r: {
        "hist": r.spec("batch", None),
        "target": r.spec("batch"),
        "other": r.spec("batch", None),
        "labels": r.spec("batch"),
    }


def _autoint_batch(cfg: R.AutoIntConfig, b: int):
    struct = {
        "sparse": ((b, cfg.n_fields), _I32),
        "labels": ((b,), _F32),
    }
    return struct, lambda r: {
        "sparse": r.spec("batch", None),
        "labels": r.spec("batch"),
    }


def _twotower_batch(cfg: R.TwoTowerConfig, b: int):
    struct = {
        "user_id": ((b,), _I32),
        "hist": ((b, cfg.hist_len), _I32),
        "pos_item": ((b,), _I32),
        "logq": ((b,), _F32),
    }
    return struct, lambda r: {
        "user_id": r.spec("batch"),
        "hist": r.spec("batch", None),
        "pos_item": r.spec("batch"),
        "logq": r.spec("batch"),
    }


def _dlrm_shardings(cfg: R.DLRMConfig, params, rules: ShardingRules):
    return R.dlrm_shardings(cfg, rules)


def _tables_sharded(*names: str) -> Callable:
    """Every param replicated but the named tables, row-sharded."""

    def shardings(cfg, params, rules: ShardingRules):
        spec = pytree.tree_map(lambda _: rules.spec(), params)
        for name in names:
            spec[name] = rules.spec("table_rows", None)
        return spec

    return shardings


# ---------------------------------------------------------------------------
# The four archs (published configs)
# ---------------------------------------------------------------------------

_dlrm_cfg = R.DLRMConfig(
    name="dlrm-mlperf", n_dense=13, embed_dim=128,
    vocab_sizes=CRITEO_1TB_VOCAB_SIZES,
    bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
)
_dlrm_smoke = dataclasses.replace(
    _dlrm_cfg, name="dlrm-smoke",
    vocab_sizes=tuple(min(v, 50) for v in CRITEO_1TB_VOCAB_SIZES),
    bot_mlp=(32, 16), top_mlp=(32, 16, 1), embed_dim=16,
)

_bst_cfg = R.BSTConfig(
    name="bst", vocab_items=2_097_152, embed_dim=32, seq_len=20,
    n_blocks=1, n_heads=8, d_ff=128, mlp_dims=(1024, 512, 256, 1),
)
_bst_smoke = dataclasses.replace(
    _bst_cfg, name="bst-smoke", vocab_items=500, seq_len=8,
    mlp_dims=(32, 16, 1), d_ff=32,
)

_autoint_cfg = R.AutoIntConfig(
    name="autoint", n_fields=39, vocab_per_field=131_072, embed_dim=16,
    n_attn_layers=3, n_heads=2, d_attn=32,
)
_autoint_smoke = dataclasses.replace(
    _autoint_cfg, name="autoint-smoke", n_fields=8, vocab_per_field=50,
)

_twotower_cfg = R.TwoTowerConfig(
    name="two-tower-retrieval", vocab_user=4_194_304, vocab_item=8_388_608,
    hist_len=20, embed_dim=256, tower_mlp=(1024, 512, 256),
)
_twotower_smoke = dataclasses.replace(
    _twotower_cfg, name="twotower-smoke", vocab_user=300, vocab_item=500,
    hist_len=8, embed_dim=32, tower_mlp=(64, 32),
)

RECSYS_ARCHS = [
    RecsysArch("dlrm-mlperf", "arXiv:1906.00091; MLPerf Criteo 1TB",
               _dlrm_cfg, R.dlrm_init, R.dlrm_loss, R.dlrm_forward,
               _dlrm_batch, _dlrm_shardings, _dlrm_smoke),
    RecsysArch("bst", "arXiv:1905.06874 (Alibaba)",
               _bst_cfg, R.bst_init, R.bst_loss, R.bst_forward,
               _bst_batch, _tables_sharded("item_table"), _bst_smoke),
    RecsysArch("autoint", "arXiv:1810.11921",
               _autoint_cfg, R.autoint_init, R.autoint_loss, R.autoint_forward,
               _autoint_batch, _tables_sharded("table"), _autoint_smoke),
    RecsysArch("two-tower-retrieval", "Yi et al. RecSys'19 (YouTube)",
               _twotower_cfg, R.twotower_init, R.twotower_loss,
               lambda p, b, c, r: R.user_tower(p, b, c, r),
               _twotower_batch, _tables_sharded("user_table", "item_table"),
               _twotower_smoke),
]
