"""FLEXVEC itself as a servable architecture (the paper's system).

The port of ``repro.configs.flexvec``.  A cell serves a BATCH of agent
queries through the Phase-2 engine: fused modulated scoring over the
corpus (the ``pem_score`` kernel), the top-``over`` pool of each query
(``topk``), a gather of the pool's rows, and greedy MMR diverse selection
of ``pool`` of them (``mmr``).

corpus_240k / corpus_1m mirror the paper's two headline corpus sizes
(§4.1/§4.3); corpus_67m is the beyond-paper scale point (67M chunks x 128d
x f32 = 34 GB, row-sharded = 134 MB a device over 256).  Its (N, B) f32
panel alone is 68.7 GB at B = 256, so it runs only as a dry run over the
production mesh, as in the reference.

Each kernel's work is counted once here (:func:`step_work` and its
parts): the dry run's roofline (``launch/dryrun.py``) and the bound
column of ``chip_smoke.py`` read the same count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchSpec, LoweredSpec, ShapeCell, meta
from repro_torch.dist.sharding import ShardingRules
from repro_torch.kernels.mmr.ops import mmr_select
from repro_torch.kernels.mmr.ref import mmr_ref
from repro_torch.kernels.pem_score.ops import pem_score
from repro_torch.kernels.pem_score.ref import pem_score_days_ref
from repro_torch.kernels.topk.ops import topk
from repro_torch.kernels.topk.ref import topk_ref
from repro_torch.roofline.analysis import KernelWork, StepCost

SHAPES = {
    "corpus_240k": dict(n=240_000, batch=64, pool=500, over=1500),
    "corpus_1m": dict(n=1_000_000, batch=64, pool=500, over=1500),
    "corpus_67m": dict(n=67_108_864, batch=256, pool=500, over=1500),
}

DIM = 128         # Nomic Embed v1.5, Matryoshka-truncated (paper §2.1)
HALF_LIFE = 30.0  # the step's decay: 1 / (1 + days / 30)
LAMBDA = 0.7      # the MMR blend


# -- the count of each kernel's work (one device, one call) -----------------


def pem_score_work(n: int, d: int, b: int, esize: int) -> KernelWork:
    """K1: the corpus, both query panels and the rows' ages read once, the
    (N, B) panel written once; 2 * N * d * 2B useful operations, issued as
    split-TF32 products (three for an f32 corpus, two for bf16)."""
    return KernelWork(flops=4.0 * n * d * b,
                      nbytes=n * d * esize + 2 * d * b * 4 + n * 4 + n * b * 4,
                      peak="tf32", passes=3 if esize == 4 else 2)


def topk_work(b: int, n: int, k: int) -> KernelWork:
    """K2: the (B, N) panel read once, k values and indices written; one
    comparison a score."""
    return KernelWork(flops=float(b * n), nbytes=b * n * 4 + b * k * 8)


def gather_work(b: int, over: int, d: int, esize: int) -> KernelWork:
    """The pool's rows: the ids and the rows read, f32 rows written."""
    return KernelWork(flops=0.0, nbytes=b * over * (4 + d * esize + d * 4))


def mmr_work(b: int, live: int, k: int, d: int, bucket: int = 0) -> KernelWork:
    """K3: the live pool's rows and the (B, bucket) relevance read once,
    the picks written; one similarity row (2 * live * d) a step, k steps.
    ``bucket`` is the pool's width with padding (``live`` if 0)."""
    bucket = bucket or live
    return KernelWork(flops=2.0 * b * k * live * d,
                      nbytes=b * (live * d + bucket) * 4 + b * k * 8)


def step_work(n: int, b: int, over: int, pool: int, *, d: int = DIM,
              esize: int = 4, b_mmr: int = 0) -> Dict[str, KernelWork]:
    """Each kernel of one serving step over n rows and b queries (K3 over
    ``b_mmr`` of them where the batch is split, else all b)."""
    return {"pem_score": pem_score_work(n, d, b, esize),
            "topk": topk_work(b, n, over),
            "gather": gather_work(b, over, d, esize),
            "mmr": mmr_work(b_mmr or b, over, pool, d)}


# -- the step -----------------------------------------------------------------


def _rows(corpus: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, over, d) f32 rows of the pool: a bf16 corpus's rows are widened
    to f32, as the reference's ``mmr_ref`` does."""
    rows = corpus.index_select(0, ids.reshape(-1).long())
    return rows.view(*ids.shape, corpus.shape[1]).to(torch.float32)


def _mmr(emb, rel, k):
    return mmr_select(emb, rel, k, LAMBDA)


def _pick(emb, v, i, pool: int, diverse: Callable = _mmr):
    """MMR over the pool's rows; the picks' corpus rows and relevance."""
    sel, _ = diverse(emb, v, pool)
    sel = sel.long()
    return torch.gather(i, 1, sel), torch.gather(v, 1, sel)


def _serve(corpus, days, q_pre, q_sup, pool, over,
           score: Callable, select: Callable, diverse: Callable):
    b = q_pre.shape[1]
    half_lives = torch.full((b,), HALF_LIFE, device=corpus.device)
    v, i = select(score(corpus, q_pre, q_sup, days, half_lives), over)
    return _pick(_rows(corpus, i), v, i, pool, diverse)


def _panel(corpus, q_pre, q_sup, days, half_lives):
    """K1 into a (B, N) panel, the layout K2 reads."""
    panel = torch.empty((q_pre.shape[1], corpus.shape[0]),
                        dtype=torch.float32, device=corpus.device)
    pem_score(corpus, q_pre, q_sup, days_ago=days, half_lives=half_lives,
              out=panel.T)
    return panel


def pem_serve_step(corpus, days, q_pre, q_sup, *, pool: int, over: int):
    """The paper's Phase 2 for a batch of queries on one device.

    scores = decay * (M @ q_pre) + M @ q_sup, decay = 1 / (1 + days / 30)
    top-`over` pool -> MMR(lambda=0.7) -> `pool` selected ids + scores.

    K1 (``pem_score``) writes the (B, N) panel, K2 (``topk``) selects each
    query's top ``over``, the pool's rows are gathered (widened to f32),
    and K3 (``mmr_select``) picks ``pool`` of them.  On CPU tensors the
    wrappers run the kernels' plain versions; on meta tensors (the dry
    run) they return shapes.  Returns ``(ids, values)``, each (B, pool),
    ids as int32 corpus rows in selection order.
    """
    return _serve(corpus, days, q_pre, q_sup, pool, over, _panel, topk, _mmr)


def pem_serve_step_plain(corpus, days, q_pre, q_sup, *, pool: int, over: int):
    """:func:`pem_serve_step` on the kernels' plain PyTorch versions, on
    any device: the yardstick ``chip_smoke.py`` holds the card's step to."""
    return _serve(
        corpus, days, q_pre, q_sup, pool, over,
        lambda m, qp, qs, dd, hl: pem_score_days_ref(m, qp, qs, dd, hl).T,
        topk_ref,
        lambda e, r, k: mmr_ref(e, r, k, torch.full(
            (r.shape[0],), LAMBDA, device=r.device)))


def _world(group) -> Tuple[int, int]:
    """(world size, rank) of ``group``, as ``make_pem_topk`` reads them:
    one rank where no process group is initialised."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return 1, 0
    world = dist.get_world_size(group)
    return world, dist.get_rank(group) if world > 1 else 0


def _pool_rows(corpus: torch.Tensor, ids: torch.Tensor, group) -> torch.Tensor:
    """(B, over, d) f32 rows of the merged pool when the corpus rows are
    sharded: each rank copies the rows of its own block (rank r holds rows
    [r * n_local, (r + 1) * n_local)) into zeros, and an ``all_reduce``
    sums the blocks; each element has one non-zero term, so the sum is the
    row exactly."""
    world, rank = _world(group)
    if world == 1:
        return _rows(corpus, ids)
    import torch.distributed as dist

    n_local = corpus.shape[0]
    local = ids.long() - rank * n_local
    mine = (local >= 0) & (local < n_local)
    rows = torch.zeros((*ids.shape, corpus.shape[1]), dtype=torch.float32,
                       device=corpus.device)
    rows[mine] = corpus[local[mine]].to(torch.float32)
    dist.all_reduce(rows, group=group)
    return rows


def _mmr_split(emb, v, i, pool: int, group):
    """K3 over this rank's share of the batch (rank r takes queries
    [r * B / W, (r + 1) * B / W)); the picks of every rank gathered in
    rank order, so every rank returns the whole batch's."""
    world, rank = _world(group)
    if world == 1:
        return _pick(emb, v, i, pool)
    import torch.distributed as dist

    share = v.shape[0] // world
    mine = slice(rank * share, (rank + 1) * share)
    out = []
    for t in _pick(emb[mine], v[mine], i[mine], pool):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous(), group=group)
        out.append(torch.cat(parts))
    return tuple(out)


class FlexvecArch(ArchSpec):
    family = "retrieval"

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 mmr_vmem: bool = False, two_stage: bool = False,
                 arch_id: str = "flexvec"):
        """Hillclimb knobs:
        dtype     — corpus matrix dtype (bf16 halves the scoring stream);
        mmr_vmem  — account MMR, in ``cost_corrections``, with the pool
                    resident on chip (ONE read) instead of the reference's
                    jnp loop re-reading it every step; the port's K3 keeps
                    the pool on chip (registers and shared memory) either
                    way;
        two_stage — shard-local scoring and top-k with a union merge
                    (``dist/pem_sharded.make_pem_topk``) instead of the
                    global top-k over the gathered (N, B) panel."""
        self.arch_id = arch_id
        self.source = "this paper"
        self.dtype = dtype
        self.mmr_vmem = mmr_vmem
        self.two_stage = two_stage
        # MMR over the batch's shards (> 1: split the queries over the
        # 'batch' axis' ranks instead of repeating every step on each)
        self.mmr_shards = 1

    def cells(self) -> Dict[str, ShapeCell]:
        return {
            name: ShapeCell(
                name=name, kind="retrieval",
                desc=f"corpus={s['n']} queries={s['batch']} pool={s['pool']}",
                beyond_assignment=True,
            )
            for name, s in SHAPES.items()
        }

    def cost_corrections(self, shape: str, chips: int):
        """The reference's analytic MMR term: XLA's ``cost_analysis``
        counts its ``fori_loop`` body once, so it adds the remaining
        (pool-1) iterations (replicated per device): per iter per query a
        one-hot matmul (2*over*d) + the sim matvec (2*over*d) + O(over)
        elementwise.  With mmr_vmem the pool stays resident on chip, so
        memory sees ONE pool read; the per-iteration traffic drops to the
        O(over) state vectors.  The port's own count (:meth:`step_cost`)
        already holds every K3 step: the dry run reports this beside it."""
        s = SHAPES[shape]
        b_local = max(1, s["batch"] // max(self.mmr_shards, 1))
        per_iter = b_local * (4.0 * s["over"] * DIM + 6.0 * s["over"])
        extra_flops = (s["pool"] - 1) * per_iter
        if self.mmr_vmem:
            extra_bytes = (s["pool"] - 1) * b_local * 3 * s["over"] * 4.0
        else:
            extra_bytes = (s["pool"] - 1) * b_local * (
                s["over"] * DIM * 4.0 + 3 * s["over"] * 4.0)
        return extra_flops, extra_bytes

    def model_flops(self, shape: str) -> float:
        s = SHAPES[shape]
        N, B, pool, over = s["n"], s["batch"], s["pool"], s["over"]
        scoring = 2.0 * N * DIM * B * 2          # two effective directions
        mmr = 2.0 * B * pool * over * DIM        # k x n pairwise updates
        return scoring + mmr

    def _layout(self, shape: str, rules: ShardingRules):
        """(padded rows, corpus shards, K3's queries a device)."""
        s = SHAPES[shape]
        shards = max(rules.size_of("corpus"), 1)
        n = (s["n"] + shards - 1) // shards * shards  # pad to the shard grid
        split = (rules.size_of("batch")
                 if self.two_stage and self.mmr_shards > 1 else 1)
        if s["batch"] % split:
            raise ValueError(f"{shape}: {s['batch']} queries do not split "
                             f"over {split} MMR shards")
        return n, shards, s["batch"] // split

    def step_cost(self, shape: str, rules: ShardingRules) -> StepCost:
        """One device's step.  two_stage: K1 and K2 on the device's rows,
        the union merge (a second K2 over shards * over candidates and an
        all-gather of them as (f32 score, int64 row) pairs), the pool's
        rows summed over the ranks (an all-reduce of f32 rows) and K3 over
        the device's share of the batch (its picks all-gathered).  One
        stage over sharded rows: K1 on the device's rows, the (N, B) panel
        all-gathered as the reference's global top-k does, then K2 over
        all N and K3 over the whole batch on every device."""
        s = SHAPES[shape]
        b, over, pool = s["batch"], s["over"], s["pool"]
        n, shards, b_mmr = self._layout(shape, rules)
        n_local = n // shards
        esize = torch.empty((), dtype=self.dtype).element_size()
        work = step_work(n_local, b, over, pool, esize=esize, b_mmr=b_mmr)
        coll: Dict[str, float] = {}
        panel_cols = n_local
        if shards > 1:
            coll["all-reduce"] = b * over * DIM * 4.0
            if self.two_stage:
                work["topk"] = topk_work(b, n_local, min(over, n_local))
                work["topk_merge"] = topk_work(b, shards * over, over)
                coll["all-gather"] = shards * over * b * 12.0
            else:
                work["topk"] = topk_work(b, n, over)
                coll["all-gather"] = n * b * 4.0
                panel_cols = n
        if b_mmr < b:
            coll["all-gather"] = coll.get("all-gather", 0.0) + b * pool * 12.0
        cands = b * over * 12.0
        temp = max(b * panel_cols * 4.0 + cands,
                   cands + b * over * DIM * 4.0 + b * pool * 12.0)
        return StepCost(kernels=work, collectives=coll, temp_bytes=temp)

    def build(self, shape: str, mesh: Any, rules: ShardingRules) -> LoweredSpec:
        s = SHAPES[shape]
        n, _, _ = self._layout(shape, rules)
        b, pool, over = s["batch"], s["pool"], s["over"]
        f32 = torch.float32
        args = (meta((n, DIM), self.dtype, rules.spec("corpus", None)),
                meta((n,), f32, rules.spec("corpus")),
                meta((DIM, b), f32, rules.spec(None, None)),
                meta((DIM, b), f32, rules.spec(None, None)))

        if self.two_stage:
            from repro_torch.dist.pem_sharded import make_pem_topk

            group = rules.group("corpus")
            mmr_group = rules.group("batch") if self.mmr_shards > 1 else None
            local_topk = make_pem_topk(over, half_life=HALF_LIFE, group=group)

            def step(corpus, days, q_pre, q_sup):
                # stage 1: shard-local scoring + local top-over, union
                # merge (the collective carries shards*over*B candidates,
                # NOT the N*B panel)
                i, v = local_topk(corpus, days, q_pre, q_sup)   # (B, over)
                # stage 2: the pool's rows + MMR; the queries are
                # independent, so with mmr_shards > 1 each rank takes its
                # share of the batch instead of repeating every step
                return _mmr_split(_pool_rows(corpus, i, group), v, i, pool,
                                  mmr_group)

            return LoweredSpec(fn=step, args=args, per_device=True,
                               static_desc=f"flexvec/{shape}/two_stage")

        group = rules.group("corpus")
        if group is not None and _world(group)[0] > 1:
            raise ValueError("one-stage flexvec runs on one device; shard the "
                             "corpus with two_stage=True")

        def step(corpus, days, q_pre, q_sup):
            return pem_serve_step(corpus, days, q_pre, q_sup,
                                  pool=pool, over=over)

        return LoweredSpec(fn=step, args=args, static_desc=f"flexvec/{shape}")

    def smoke_run(self) -> Dict[str, Any]:
        gen = torch.Generator().manual_seed(0)
        corpus = torch.randn(512, DIM, generator=gen)
        corpus = corpus / corpus.norm(dim=1, keepdim=True)
        days = torch.rand(512, generator=gen) * 90.0
        q = torch.randn(DIM, 2, generator=gen)
        idx, val = pem_serve_step(corpus, days, q, -0.5 * q, pool=8, over=24)
        return {
            "idx_shape": tuple(idx.shape),
            "val_finite": bool(torch.isfinite(val).all()),
            "loss": float(val.mean()),
        }


FLEXVEC_ARCHS = [FlexvecArch()]
