"""The port's transformer against the reference, on the CPU: forward,
loss, gradients, prefill and decode for each LM arch's smoke config (MQA
with gelu, relu2, swiglu, and MoE), bf16, per-row decode lengths, remat
and out-of-range token ids.  Helpers and tolerances: ``lm_parity.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import lm as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import lm as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train.optimizer import loss_and_grads  # noqa: E402

from lm_parity import (BF16_TOL, GRAD_TOL, TOL, both_params, err,  # noqa: E402
                       f32, r_params, r_rules, small_cfg, t_cfg, t_rules)

SMOKE = [a.arch_id for a in RL.LM_ARCHS]  # MQA, relu2, swiglu, MoE x2


# -- the transformer ----------------------------------------------------------


def _tokens(rcfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32))


def reference_run(arch_id):
    """The reference's forward, loss and gradients on 2 x 16 tokens, and
    its prefill of 2 x 8 and two decode steps, jitted once per config (the
    two MoE archs' smoke configs differ only by name)."""
    rc = {a.arch_id: a for a in RL.LM_ARCHS}[arch_id].smoke_cfg
    return _reference_run(dataclasses.replace(rc, name="smoke"))


@functools.lru_cache(maxsize=None)
def _reference_run(rc):
    rules = r_rules()
    rp = r_params(rc)
    toks, labs = _tokens(rc)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}

    def loss_and_logits(p, b):
        logits = RT.forward(p, b["tokens"], rc, rules)
        return RT.lm_loss(p, b, rc, rules), logits

    # one compile for the loss, its gradients and the logits; one for the
    # prefill and both decode steps (each step's token is the last's argmax)
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(rp, batch)

    def serve(p, prompt, first):
        plog, pcache = RT.prefill_step(p, prompt, rc, rules)
        cache = tuple(jax.lax.dynamic_update_slice(b, c, (0, 0, 0, 0, 0))
                      for b, c in zip(RT.make_cache(rc, 2, 16), pcache))
        steps, nxt = [], first
        for ln in (8, 9):
            dlog, cache = RT.decode_step(p, nxt, cache, jnp.int32(ln), rc,
                                         rules)
            steps.append((nxt, dlog, cache))
            nxt = jnp.argmax(dlog, -1).astype(jnp.int32)[:, None]
        return (plog, pcache), steps

    prefill, steps = jax.jit(serve)(rp, jnp.asarray(toks[:, :8]),
                                    jnp.asarray(toks[:, :1]))
    steps = [(np.asarray(n), d, c) for n, d, c in steps]
    return dict(toks=toks, labs=labs, logits=logits, loss=loss, grads=grads,
                prefill=prefill, steps=steps)


@pytest.mark.parametrize("arch_id", SMOKE)
def test_forward_loss_and_grads_match(arch_id):
    rc = {a.arch_id: a for a in RL.LM_ARCHS}[arch_id].smoke_cfg
    tc = t_cfg(rc)
    _, tp = both_params(rc)
    ref = reference_run(arch_id)
    toks, labs = ref["toks"], ref["labs"]
    got = TT.forward(tp, torch.from_numpy(toks), tc, t_rules())
    assert err(got, ref["logits"]) <= TOL
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    tl, tg = loss_and_grads(lambda p, b: TT.lm_loss(p, b, tc, t_rules()),
                            tp, tb)
    assert abs(float(tl) - float(ref["loss"])) <= GRAD_TOL
    for path, g in jax.tree_util.tree_flatten_with_path(ref["grads"])[0]:
        node = tg
        for p in path:
            node = node[p.key]
        assert err(node, g) <= GRAD_TOL, path


@pytest.mark.parametrize("arch_id", SMOKE)
def test_prefill_and_decode_match(arch_id):
    rc = {a.arch_id: a for a in RL.LM_ARCHS}[arch_id].smoke_cfg
    tc = t_cfg(rc)
    _, tp = both_params(rc)
    ref = reference_run(arch_id)
    rlog, rcache = ref["prefill"]
    tlog, tcache = TT.prefill_step(tp, torch.from_numpy(ref["toks"][:, :8]),
                                   tc, t_rules())
    assert err(tlog, rlog) <= TOL
    for a, b in zip(tcache, rcache):
        assert tuple(a.shape) == b.shape and err(a, b) <= TOL
    big_t = TT.make_cache(tc, 2, 16, device="cpu")
    for b, c in zip(big_t, tcache):
        b[:, :, :8] = c
    for ln, (nxt, rlog, rcache) in zip((8, 9), ref["steps"]):
        tlog, big_t = TT.decode_step(tp, torch.from_numpy(nxt), big_t, ln, tc,
                                     t_rules())
        assert err(tlog, rlog) <= TOL
        for a, b in zip(big_t, rcache):
            assert err(a, b) <= TOL


def test_decode_with_per_row_lengths_equals_each_row_alone():
    rc = small_cfg()
    tc = t_cfg(rc)
    _, tp = both_params(rc)
    rng = np.random.default_rng(6)
    cache = tuple(torch.from_numpy(rng.standard_normal(
        (2, 3, 10, 2, 8)).astype(np.float32)) for _ in range(2))
    token = torch.tensor([[5], [9], [1]])
    lens = torch.tensor([2, 7, 4])
    got, batched = TT.decode_step(tp, token, tuple(c.clone() for c in cache),
                                  lens, tc, t_rules())
    for b in range(3):
        one = tuple(c[:, b:b + 1].clone() for c in cache)
        want, one = TT.decode_step(tp, token[b:b + 1], one, int(lens[b]), tc,
                                   t_rules())
        assert err(got[b:b + 1], want) <= TOL
        for x, y in zip(batched, one):
            assert err(x[:, b:b + 1], y) <= TOL


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_changes_no_value(policy):
    """Recomputing the layers in backward gives the plain run's loss and
    gradients bit for bit (the plain run is held against the reference in
    ``test_forward_loss_and_grads_match``)."""
    tc = dataclasses.replace(TL.LM_ARCHS[3].smoke_cfg, remat=True,
                             remat_policy=policy)       # MoE: every op kind
    plain = dataclasses.replace(tc, remat=False)
    tp = TT.init_params(tc, 0, device="cpu")
    toks, labs = _tokens(tc)
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    tl, tg = loss_and_grads(lambda p, b: TT.lm_loss(p, b, tc, t_rules()),
                            tp, tb)
    pl, pg = loss_and_grads(lambda p, b: TT.lm_loss(p, b, plain, t_rules()),
                            tp, tb)
    assert float(tl) == float(pl)
    for name in tg["layers"]:
        assert torch.equal(tg["layers"][name], pg["layers"][name]), name
    assert torch.equal(tg["embed"], pg["embed"])


def test_bf16_forward_within_bf16_tolerance():
    ra = RL.LM_ARCHS[3]   # MoE
    rc = dataclasses.replace(ra.smoke_cfg, dtype=jnp.bfloat16)
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    # bf16 -> f32 -> bf16 carries the reference's weights bit for bit
    assert np.array_equal(f32(tp["layers"]["wq"]),
                          np.asarray(rp["layers"]["wq"].astype(jnp.float32)))
    toks, _ = _tokens(rc)
    got = TT.forward(tp, torch.from_numpy(toks), tc, t_rules())
    rules = r_rules()
    want = jax.jit(lambda p, t: RT.forward(p, t, rc, rules))(
        rp, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    assert err(got, want) <= BF16_TOL


def test_out_of_range_tokens_fill_in_the_reference_and_raise_in_the_port():
    """``jnp.take``'s default mode fills an out-of-range row with NaN, so
    the reference's logits turn NaN (every position: the masked PV terms
    are 0 * NaN); the port's row gather refuses the id."""
    rc = small_cfg()
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    toks = np.array([[1, 2, rc.vocab + 5, 3]], np.int32)
    rules = r_rules()
    got = np.asarray(jax.jit(lambda p, t: RT.forward(p, t, rc, rules))(
        rp, jnp.asarray(toks)))
    assert np.isnan(got).all()
    with pytest.raises((IndexError, RuntimeError)):
        TT.forward(tp, torch.from_numpy(toks), tc, t_rules())


