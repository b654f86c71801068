"""The port's LM configs and layers against the reference, on the CPU.

The same seeded numpy inputs go through ``repro.models`` (JAX, on a 1x1
mesh with Auto axes) and ``repro_torch.models`` (``device="cpu"``), the
weights carried across by ``params_from_numpy``: RMSNorm, RoPE (per-row
positions too), the three dense MLPs, chunked and unchunked attention
with ``kv_len``, the attention block's cache write and its clamp, and the
MoE with drops and with ``decode_group``.  Tolerances: 1e-5 for f32
layers, 1e-4 for gradients, 2e-2 for bf16 (``tests/test_kernels.py``).
The transformer is in ``test_torch_lm_model.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lm as RL  # noqa: E402
from repro.models import layers as RLy  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import lm as TL  # noqa: E402
from repro_torch.dist.sharding import constrain  # noqa: E402
from repro_torch.models import layers as TLy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train.optimizer import loss_and_grads  # noqa: E402

from lm_parity import (BF16_TOL, GRAD_TOL, TOL, both_params, err,  # noqa: E402
                       r_rules, small_cfg, t_cfg, t_rules)

SMOKE = [a.arch_id for a in RL.LM_ARCHS]  # MQA, relu2, swiglu, MoE x2


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", SMOKE)
def test_configs_and_param_tree_match(arch_id):
    ra = {a.arch_id: a for a in RL.LM_ARCHS}[arch_id]
    ta = {a.arch_id: a for a in TL.LM_ARCHS}[arch_id]
    assert ta.source == ra.source
    for tc, rc in ((ta.cfg, ra.cfg), (ta.smoke_cfg, ra.smoke_cfg)):
        assert tc == t_cfg(rc)
        assert (tc.n_params, tc.n_active_params) == (rc.n_params,
                                                    rc.n_active_params)
    shapes = jax.eval_shape(lambda: RT.init_params(ra.cfg, jax.random.key(0)))
    want = jax.tree.map(lambda s: tuple(s.shape), shapes)
    assert TT.param_shapes(ta.cfg) == want
    params = TT.init_params(ta.smoke_cfg, 0, device="cpu")
    assert sum(p.numel() for p in jax.tree.leaves(
        jax.tree.map(lambda t: t, params, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))) == ta.smoke_cfg.n_params


def test_init_params_is_seeded_and_needs_a_card_by_default():
    cfg = TL.LM_ARCHS[2].smoke_cfg
    a = TT.init_params(cfg, 3, device="cpu")
    b = TT.init_params(cfg, 3, device="cpu")
    c = TT.init_params(cfg, 4, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_params(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.make_cache(cfg, 1, 8)


def test_constrain_checks_names_and_returns_its_input():
    rules = t_rules()
    x = torch.ones(2, 3)
    assert constrain(x, rules, "batch", None, "act_embed") is x
    with pytest.raises(KeyError, match="unknown logical axis"):
        constrain(x, rules, "batch", "nope")


# -- basic ops ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_and_rope_match(dtype):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    tol = TOL if dtype == "f32" else BF16_TOL
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    got = TLy.rms_norm(torch.from_numpy(x).to(td),
                       torch.from_numpy(scale).to(td), 1e-6)
    want = jax.jit(RLy.rms_norm)(jnp.asarray(x, jd), jnp.asarray(scale, jd))
    assert got.dtype == td and err(got, want) <= tol
    pos = np.array([3, 4, 5, 6, 7])
    got = TLy.rope(torch.from_numpy(x).to(td), torch.from_numpy(pos)[None],
                   10_000.0)
    rope = jax.jit(RLy.rope, static_argnums=2)
    want = rope(jnp.asarray(x, jd), jnp.asarray(pos)[None], 10_000.0)
    assert got.dtype == td and err(got, want) <= tol
    # positions per row: each row as the reference rotates it alone
    rows = np.array([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13]])
    got = TLy.rope(torch.from_numpy(x).to(td), torch.from_numpy(rows), 500.0)
    for b in range(2):
        want = rope(jnp.asarray(x[b:b + 1], jd), jnp.asarray(rows[b])[None],
                    500.0)
        assert err(got[b:b + 1], want) <= tol


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_mlp_matches(mlp_type, dtype):
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rc = small_cfg(mlp_type=mlp_type, dtype=jd)
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    lp_r = jax.tree.map(lambda w: w[0], rp["layers"])
    lp_t = {k: v[0] for k, v in tp["layers"].items()}
    x = np.random.default_rng(1).standard_normal((2, 6, 32)).astype(np.float32)
    got = TLy.mlp_block(torch.from_numpy(x).to(tc.dtype), lp_t, tc, t_rules())
    rules = r_rules()
    want = jax.jit(lambda x, lp: RLy.mlp_block(x, lp, rc, rules))(
        jnp.asarray(x, jd), lp_r)
    assert err(got, want) <= (TOL if dtype == "f32" else BF16_TOL)


# -- attention ----------------------------------------------------------------


@pytest.mark.parametrize("S,q_chunk", [(8, 8), (16, 4)])   # one chunk / four
@pytest.mark.parametrize("kv_len", [None, 11])
def test_attention_matches(S, q_chunk, kv_len):
    rng = np.random.default_rng(2)
    B, T, H, K, hd = 2, 16, 4, 2, 8
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    off = T - S if kv_len is None else 3
    got = TLy.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), q_offset=off, kv_len=kv_len,
                        q_chunk=q_chunk)
    attn = jax.jit(functools.partial(RLy.attention, q_chunk=q_chunk))
    want = attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                q_offset=jnp.int32(off),
                kv_len=None if kv_len is None else jnp.int32(kv_len))
    assert err(got, want) <= TOL
    # per-row offsets and lengths: each row as the reference sees it alone
    offs, lens = np.array([2, 7]), np.array([5, 12])
    got = TLy.attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                        torch.from_numpy(v), q_offset=torch.from_numpy(offs),
                        kv_len=torch.from_numpy(lens), q_chunk=q_chunk)
    for b in range(B):
        want = attn(jnp.asarray(q[b:b + 1, :1]), jnp.asarray(k[b:b + 1]),
                    jnp.asarray(v[b:b + 1]), q_offset=jnp.int32(offs[b]),
                    kv_len=jnp.int32(lens[b]))
        assert err(got[b:b + 1], want) <= TOL
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TLy.attention(torch.from_numpy(q[:, :6]), torch.from_numpy(k),
                      torch.from_numpy(v), q_offset=0, q_chunk=4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_block_with_a_cache_matches(dtype):
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rc = small_cfg(dtype=jd)
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    lp_r = jax.tree.map(lambda w: w[0], rp["layers"])
    lp_t = {k: v[0] for k, v in tp["layers"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ck = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((2, 12, 2, 8)).astype(np.float32)
    tol = TOL if dtype == "f32" else BF16_TOL
    rules = r_rules()
    block = jax.jit(lambda x, lp, pos, cache, n: RLy.attention_block(
        x, lp, rc, rules, positions=pos, cache=cache, cache_len=n))
    for start in (4, 11):   # 11 + 3 > 12: the write clamps to T - S = 9
        cache_t = (torch.from_numpy(ck).to(tc.dtype),
                   torch.from_numpy(cv).to(tc.dtype))
        got, (gk, gv) = TLy.attention_block(
            torch.from_numpy(x).to(tc.dtype), lp_t, tc, t_rules(),
            positions=torch.arange(start, start + 3), cache=cache_t,
            cache_len=start)
        want, (wk, wv) = block(
            jnp.asarray(x, jd), lp_r, jnp.arange(start, start + 3),
            (jnp.asarray(ck, jd), jnp.asarray(cv, jd)), jnp.int32(start))
        assert gk is cache_t[0] and gv is cache_t[1]   # written in place
        assert err(got, want) <= tol
        assert err(gk, wk) <= tol and err(gv, wv) <= tol
    # the clamp: a write past T lands at T - S, the rows before it kept
    assert err(gk[:, :9], torch.from_numpy(ck[:, :9]).to(tc.dtype)) == 0.0


# -- MoE ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["drops", "decode_group", "decode_rows",
                                  "bf16"])
def test_moe_mlp_matches(case):
    moe = RLy.MoEConfig(n_experts=4, top_k=2,
                        capacity_factor=0.5 if case == "drops" else 2.0,
                        decode_group=4 if case.startswith("decode") else 0)
    jd = jnp.bfloat16 if case == "bf16" else jnp.float32
    rc = small_cfg(moe=moe, d_ff=16, dtype=jd)
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    lp_r = jax.tree.map(lambda w: w[0], rp["layers"])
    lp_t = {k: v[0] for k, v in tp["layers"].items()}
    B, S = {"decode_group": (8, 1), "decode_rows": (6, 1)}.get(case, (2, 12))
    x = np.random.default_rng(4).standard_normal((B, S, 32)).astype(np.float32)
    got = TLy.moe_mlp(torch.from_numpy(x).to(tc.dtype), lp_t, tc, t_rules())
    rules = r_rules()
    want = jax.jit(lambda x, lp: RLy.moe_mlp(x, lp, rc, rules))(
        jnp.asarray(x, jd), lp_r)
    assert err(got, want) <= (BF16_TOL if case == "bf16" else TOL)


def test_moe_gradients_match_with_drops():
    moe = RLy.MoEConfig(n_experts=4, top_k=2, capacity_factor=0.5)
    rc = small_cfg(moe=moe, d_ff=16)
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    x = np.random.default_rng(5).standard_normal((2, 12, 32)).astype(np.float32)

    def r_loss(lp, x):
        return jnp.sum(RLy.moe_mlp(x, lp, rc, r_rules()) ** 2)

    lp_r = jax.tree.map(lambda w: w[0], rp["layers"])
    gr = jax.jit(jax.grad(r_loss))(lp_r, jnp.asarray(x))
    lp_t = {k: v[0].clone() for k, v in tp["layers"].items()}
    _, gt = loss_and_grads(
        lambda lp, xx: torch.sum(TLy.moe_mlp(xx, lp, tc, t_rules()) ** 2),
        lp_t, torch.from_numpy(x))
    for name in ("router", "wi", "wg", "wo_mlp", "mlp_norm"):
        assert err(gt[name], gr[name]) <= GRAD_TOL, name


def test_smoke_run_passes_the_reference_smoke_assertions():
    for ta in TL.LM_ARCHS:
        out = ta.smoke_run()
        assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
        assert out["logits_shape"] == (2, ta.smoke_cfg.vocab)
        assert out["decode_shape"] == (2, ta.smoke_cfg.vocab)
