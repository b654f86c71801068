"""The five assigned LM architectures (published configs, exact dims).

The port of ``repro.configs.lm``.  Shapes (assignment):
    train_4k     seq 4096  global_batch 256   -> train_step
    prefill_32k  seq 32768 global_batch 32    -> prefill (serve)
    decode_32k   seq 32768 global_batch 128   -> decode_step (1 tok, KV cache)
    long_500k    seq 524288 global_batch 1    -> decode; SKIPPED for these
                 pure full-attention archs per assignment, but run as a
                 beyond-assignment cell since decode against a KV cache is
                 linear in context.

``build`` gives each cell's step over meta tensors of the global shapes
(the reference's ``pjit`` view); the dry run runs it on the meta device.
The reference counts each step's work with XLA's ``cost_analysis`` over
unrolled probes; the port has no compiler, so :meth:`LMArch.step_cost`
counts one device's step from the shapes (:func:`lm_step_cost`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchSpec, LoweredSpec, ShapeCell, meta
from repro_torch.dist.sharding import ShardingRules, default_rules
from repro_torch.models import transformer as T
from repro_torch.models.layers import LMConfig, MoEConfig
from repro_torch.roofline.analysis import KernelWork, StepCost
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         init_opt_state, loss_and_grads)

_SKIP_500K = (
    "long_500k requires sub-quadratic attention; this arch is pure "
    "full-attention (published config) -> skipped per assignment. A "
    "beyond-assignment decode lowering (linear-in-context KV-cache decode "
    "with sequence-sharded cache) is reported separately."
)

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def lm_train_step(cfg: LMConfig, rules: ShardingRules, ocfg: AdamWConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss's gradient and one AdamW update (in place)."""

    def loss_fn(params, batch):
        return T.lm_loss(params, batch, cfg, rules)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, metrics = adamw_update(ocfg, params, grads,
                                                  opt_state)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def decode_rules(rules: ShardingRules, batch: int) -> ShardingRules:
    """A decode batch that cannot shard over the data axes (long_500k's
    batch 1) sequence-shards the KV cache over them instead (context
    parallelism for decode)."""
    if batch % max(rules.size_of("batch"), 1) == 0:
        return rules
    new_rules = dict(rules.rules)
    new_rules["seq"] = rules.rules["batch"]
    new_rules["batch"] = None
    return dataclasses.replace(rules, rules=new_rules)


def _leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _tree(names: List[str], values) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in zip(names, values):
        *parents, leaf = name.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


class LMArch(ArchSpec):
    family = "lm"

    def __init__(self, arch_id: str, source: str, cfg: LMConfig, smoke_cfg: LMConfig):
        self.arch_id = arch_id
        self.source = source
        self.cfg = cfg
        self.smoke_cfg = smoke_cfg

    def cells(self) -> Dict[str, ShapeCell]:
        out = {}
        for name, s in LM_SHAPES.items():
            skip = _SKIP_500K if name == "long_500k" else None
            out[name] = ShapeCell(
                name=name, kind=s["kind"],
                desc=f"seq={s['seq']} batch={s['batch']}",
                skip_reason=skip,
                beyond_assignment=(name == "long_500k"),
            )
        return out

    def model_flops(self, shape: str) -> float:
        s = LM_SHAPES[shape]
        n = self.cfg.n_active_params
        if s["kind"] == "train":
            return 6.0 * n * s["batch"] * s["seq"]
        if s["kind"] == "prefill":
            return 2.0 * n * s["batch"] * s["seq"]
        # decode: one token per sequence + KV-cache attention reads
        cfg = self.cfg
        att = 4.0 * s["batch"] * cfg.n_heads * cfg.head_dim * s["seq"] * cfg.n_layers
        return 2.0 * n * s["batch"] + att

    # -- dry-run steps ----------------------------------------------------------

    def build(self, shape: str, mesh: Any, rules: ShardingRules) -> LoweredSpec:
        cfg = self.cfg
        s = LM_SHAPES[shape]
        B, S = s["batch"], s["seq"]
        if s["kind"] == "decode":
            rules = decode_rules(rules, B)
        shapes = _leaves(T.param_shapes(cfg))
        specs = dict(_leaves(T.param_shardings(cfg, rules)))
        names = [n for n, _ in shapes]
        params = [meta(shp, cfg.dtype, specs[n]) for n, shp in shapes]
        i32 = torch.int32
        desc = f"{self.arch_id}/{shape}"
        n_p = len(names)

        if s["kind"] == "train":
            moments = [meta(p.shape, torch.float32, p.spec)
                       for p in params * 2]
            batch = [meta((B, S), i32, rules.spec("batch", "seq"))
                     for _ in range(2)]
            step = lm_train_step(cfg, rules, AdamWConfig())

            def train_step(*args):
                p = _tree(names, args[:n_p])
                opt = OptState(0, _tree(names, args[n_p:2 * n_p]),
                               _tree(names, args[2 * n_p:3 * n_p]))
                tokens, labels = args[3 * n_p:]
                p, opt, metrics = step(p, opt, {"tokens": tokens,
                                                "labels": labels})
                return tuple(v for _, v in _leaves(p)) + tuple(
                    v for _, v in _leaves(opt.m)) + tuple(
                    v for _, v in _leaves(opt.v)) + (metrics["loss"],
                                                      metrics["grad_norm"])

            return LoweredSpec(fn=train_step,
                               args=tuple(params + moments + batch),
                               static_desc=desc)

        if s["kind"] == "prefill":
            tokens = meta((B, S), i32, rules.spec("batch", "seq"))

            def prefill(*args):
                logits, (k, v) = T.prefill_step(_tree(names, args[:n_p]),
                                                args[n_p], cfg, rules)
                return logits, k, v

            return LoweredSpec(fn=prefill, args=tuple(params) + (tokens,),
                               static_desc=desc)

        # decode: one new token against a KV cache of length seq
        cspec = T.cache_shardings(cfg, rules)[0]
        cshape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        cache = [meta(cshape, cfg.dtype, cspec) for _ in range(2)]
        token = meta((B, 1), i32, rules.spec("batch", None))
        clen = meta((), i32, rules.spec())

        def decode(*args):
            logits, (k, v) = T.decode_step(
                _tree(names, args[:n_p]), args[n_p], tuple(args[n_p + 1:n_p + 3]),
                args[n_p + 3], cfg, rules)
            return logits, k, v

        return LoweredSpec(fn=decode,
                           args=tuple(params) + (token, *cache, clen),
                           static_desc=desc)

    def step_cost(self, shape: str, rules: ShardingRules) -> StepCost:
        s = LM_SHAPES[shape]
        if s["kind"] == "decode":
            rules = decode_rules(rules, s["batch"])
        return lm_step_cost(self.cfg, s["kind"], s["batch"], s["seq"], rules)

    # -- smoke ----------------------------------------------------------------

    def smoke_run(self) -> Dict[str, Any]:
        from repro_torch.launch.mesh import make_local_mesh

        cfg = self.smoke_cfg
        rules = default_rules(make_local_mesh("cpu"))
        params = T.init_params(cfg, 0, device="cpu")
        B, S = 2, 16
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
        batch = {"tokens": tokens, "labels": tokens}
        logits_last, cache = T.prefill_step(params, tokens, cfg, rules)
        big = T.make_cache(cfg, B, S + 4, device="cpu")
        for b, c in zip(big, cache):
            b[:, :, :S] = c
        dec_logits, _ = T.decode_step(params, tokens[:, :1], big, S, cfg, rules)
        step = lm_train_step(cfg, rules, AdamWConfig())
        _, _, metrics = step(params, init_opt_state(params), batch)
        return {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "logits_shape": tuple(logits_last.shape),
            "decode_shape": tuple(dec_logits.shape),
            "vocab": cfg.vocab,
        }


# -- the count of one device's step ------------------------------------------


def _shards(rules: ShardingRules, name: str, dim: int) -> int:
    return rules.size_of(rules.if_divisible(name, dim))


def moe_groups(cfg: LMConfig, kind: str, batch: int, seq: int) -> Tuple[int, int, int]:
    """(groups, tokens a group, capacity C) of the MoE routing: a batch row
    is a group, and a decode batch merges ``decode_group`` rows into one
    where it divides (``layers.moe_mlp``)."""
    S = 1 if kind == "decode" else seq
    g = cfg.moe.decode_group
    groups = batch
    if S == 1 and g > 1 and batch % g == 0:
        groups, S = batch // g, g
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    return groups, S, max(k, int(cfg.moe.capacity_factor * S * k / E))


def lm_step_cost(cfg: LMConfig, kind: str, batch: int, seq: int,
                 rules: ShardingRules) -> StepCost:
    """One device's count of an LM step, kernel by kernel, from the shapes.

    Work: each product's 2*m*n*k operations and its inputs and outputs
    (weights as gathered for compute, activations, the KV cache) — the
    projections, QK and PV over the full context (no causal saving), the
    dense MLP or the router and the experts over E*C slots a group, the
    unembedding, and for training the loss and the AdamW pass over the
    device's params, m and v.  Training counts three passes (forward and
    two for backward) plus, under remat, the recomputed forward: all of it
    under ``"full"``; under ``"dots"`` only the products with batch
    dimensions (attention, experts), which the policy does not save.

    Collectives by op: the FSDP all-gather of every weight sharded over
    'embed' (forward, backward, and the remat forward) and the
    reduce-scatter of its gradient; the all-reduce of the other gradients
    over 'batch'; the TP all-reduces over 'model' of the attention and
    dense MLP outputs; the MoE dispatch and combine as all-to-all over
    'expert' (and, where the experts' columns shard over 'data', the
    tokens' all-gather over it); a sequence-sharded cache's softmax
    partials."""
    es = torch.empty((), dtype=cfg.dtype).element_size()
    peak = "bf16" if cfg.dtype in (torch.bfloat16, torch.float16) else "f32"
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    train = kind == "train"
    S = 1 if kind == "decode" else seq            # new tokens a row
    T_kv = seq                                    # context each attends
    dp = rules.size_of("batch")
    sp = rules.size_of("seq") if kind == "decode" else 1
    tp = rules.size_of("act_embed")
    th = _shards(rules, "heads", H * hd)
    tk = _shards(rules, "kv_heads", K * hd)
    tv = _shards(rules, "vocab", V)
    B_loc = batch / dp
    N = B_loc * S                                 # tokens on this device
    n_mats = 3 if cfg.mlp_type == "swiglu" else 2

    def work(flops, nbytes, passes=1.0):
        return KernelWork(flops=flops * passes, nbytes=nbytes * passes,
                          peak=peak)

    # passes over a product: forward, two for backward, and the remat
    # forward where the policy recomputes it ("dots" saves the products
    # without batch dimensions: the projections, the dense MLP, the router)
    remat_full = train and cfg.remat and cfg.remat_policy != "dots"
    saved = (4.0 if remat_full else 3.0) if train else 1.0
    batched = (4.0 if cfg.remat else 3.0) if train else 1.0
    outer = 3.0 if train else 1.0                 # outside the layers

    kernels: Dict[str, KernelWork] = {}
    qkv = (2 * H / th + 2 * K / tk) * hd          # q, o, k, v columns
    kernels["attn_proj"] = work(
        L * 2.0 * N * D * qkv,
        L * (D * qkv * es + N * (2 * D + qkv) * es), saved)
    kv_rows = B_loc * (T_kv / sp) * (K / tk) * hd
    kernels["attention"] = work(
        L * 4.0 * B_loc * (H / th) * S * (T_kv / sp) * hd,
        L * (2 * N * (H / th) * hd + 2 * kv_rows) * es, batched)
    if cfg.moe is None:
        tf = _shards(rules, "ff", F)
        kernels["mlp"] = work(
            L * 2.0 * N * D * F * n_mats / tf,
            L * (n_mats * D * F / tf + 2 * N * D) * es, saved)
    else:
        E = cfg.moe.n_experts
        te = _shards(rules, "expert", E)
        groups, _, C = moe_groups(cfg, kind, batch, seq)
        slots = groups / dp * (E / te) * C        # this device's E*C slots
        mff = _shards(rules, "moe_ff", F)
        kernels["router"] = work(L * 2.0 * N * D * E,
                                 L * (D * E * 4 + N * (D * es + E * 4)), saved)
        kernels["moe"] = work(
            L * 2.0 * slots * D * F * n_mats,
            L * ((E / te) * n_mats * D * F / mff + 2 * slots * D) * es,
            batched)
    kernels["unembed"] = work(2.0 * N * D * V / tv,
                              (D * V / tv + N * D + N * V / tv) * es, outer)
    n_local = sum(math.prod(rules.block_shape(shp, spec))
                  for (_, shp), (_, spec) in zip(
                      _leaves(T.param_shapes(cfg)),
                      _leaves(T.param_shardings(cfg, rules))))
    if train:
        kernels["loss"] = work(4.0 * N * V / tv, N * V / tv * 4 + N * 4,
                               outer)
        kernels["adamw"] = KernelWork(flops=14.0 * n_local,
                                      nbytes=n_local * (3 * es + 16))

    # collectives, bytes one device moves
    coll: Dict[str, float] = {}

    def add(op, nbytes):
        if nbytes > 0:
            coll[op] = coll.get(op, 0.0) + nbytes

    # a weight's FSDP shards: its block with 'embed' sharded against its
    # block with 'embed' whole
    whole = dataclasses.replace(rules, rules={**rules.rules, "embed": None})
    gathers = (2.0 + (1.0 if remat_full else 0.0)) if train else 1.0
    for (_, shp), (_, spec), (_, spec_whole) in zip(
            _leaves(T.param_shapes(cfg)),
            _leaves(T.param_shardings(cfg, rules)),
            _leaves(T.param_shardings(cfg, whole))):
        block = math.prod(rules.block_shape(shp, spec)) * es
        gathered = math.prod(rules.block_shape(shp, spec_whole)) * es
        if gathered > block:
            add("all-gather", gathers * (gathered - block))
            if train:
                add("reduce-scatter", gathered - block)
        elif train and dp > 1:
            add("all-reduce", 2.0 * block * (dp - 1) / dp)
    ring = 2.0 * (tp - 1) / tp
    tp_outputs = 1 if cfg.moe is not None else 2  # attention (+ dense MLP)
    add("all-reduce", saved * L * tp_outputs * ring * N * D * es)
    if tv > 1:
        add("all-reduce", outer * 2.0 * N * 4)    # the vocab-sharded softmax
    if sp > 1:
        add("all-reduce", L * 2.0 * B_loc * H * hd * 4)
    if cfg.moe is not None:
        xe = slots * D * es
        add("all-to-all", batched * L * 2.0 * xe * (te - 1) / te)
        if mff > 1:  # the experts' columns over 'data': the tokens gather
            add("all-gather", batched * L * 2.0 * xe * (mff - 1))

    # the largest set of temporaries held at once
    logits = N * V / tv * (4 + es)
    layer_acts = N * (4 * D + qkv + n_mats * F) * es \
        + B_loc * (H / th) * S * (T_kv / sp) * 4
    if train:
        kept = N * D * es if cfg.remat else layer_acts
        temp = L * kept + layer_acts + logits + n_local * es
    elif kind == "prefill":
        temp = 2 * kv_rows * L * es + layer_acts + logits
    else:
        temp = layer_acts + logits
    return StepCost(kernels=kernels, collectives=coll, temp_bytes=temp)


def _smoke_of(cfg: LMConfig) -> LMConfig:
    """Same family (mlp type, GQA ratio, MoE-ness), tiny dims."""
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(n_experts=min(8, cfg.moe.n_experts), top_k=min(2, cfg.moe.top_k))
    kv = max(1, min(2, cfg.n_kv_heads))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=kv, head_dim=16,
        d_ff=96 if moe is None else 32,
        vocab=128, dtype=torch.float32, q_chunk=8, remat=False, moe=moe,
    )


def _mk(arch_id, source, **kw) -> LMArch:
    cfg = LMConfig(name=arch_id, **kw)
    return LMArch(arch_id, source, cfg, _smoke_of(cfg))


LM_ARCHS = [
    # 88L d6144 48H MQA(kv=1) dff 24576 vocab 49152, non-gated GELU (~34B)
    _mk("granite-34b", "arXiv:2405.04324; hf",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab=49152, mlp_type="gelu"),
    # 32L d3072 24H GQA(kv=8) dff 9216 vocab 256000, squared-ReLU (~4B)
    _mk("minitron-4b", "arXiv:2407.14679; hf",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=9216, vocab=256000, mlp_type="relu2"),
    # 24L d2048 16H GQA(kv=8) dff 8192 vocab 92544, SwiGLU (~1.9B)
    _mk("internlm2-1.8b", "arXiv:2403.17297; hf",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=92544, mlp_type="swiglu"),
    # 24L d1024 16H GQA(kv=8) per-expert dff 512, MoE 32e top-8 (~1.4B/0.4B)
    _mk("granite-moe-1b-a400m", "hf:ibm-granite/granite-3.0-1b-a400m-base",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155, mlp_type="swiglu",
        moe=MoEConfig(n_experts=32, top_k=8)),
    # 94L d4096 64H GQA(kv=4) per-expert dff 1536, MoE 128e top-8 (~235B/22B)
    _mk("qwen3-moe-235b-a22b", "hf:Qwen/Qwen3-30B-A3B (scaled cfg per assignment)",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936, mlp_type="swiglu",
        moe=MoEConfig(n_experts=128, top_k=8)),
]
