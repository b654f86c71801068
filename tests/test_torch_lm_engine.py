"""The port's continuous-batching decode engine against the reference's.

Both engines serve the same requests (seeded numpy prompts) with the same
weights (the reference's, carried across by ``params_from_numpy``), in
f32: the token ids must be equal, request for request, dense and MoE,
with more requests than slots, with EOS, and with a ``decode_group`` that
the reference's vmapped step never applies to its one-token slots.  The
port's engine also equals its own sequential ``prefill_step`` +
``decode_step``.  Helpers: ``lm_parity.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as RLy  # noqa: E402
from repro.serve import lm_engine as RE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import lm_engine as TE  # noqa: E402

from lm_parity import (TOL, both_params, r_rules, small_cfg, t_cfg,  # noqa: E402
                       t_rules)

MOE = RLy.MoEConfig(n_experts=4, top_k=2, decode_group=4)
CONFIGS = {"dense": small_cfg(n_layers=2, d_model=32, d_ff=64, vocab=64,
                              q_chunk=16),
           "moe": small_cfg(n_layers=2, d_model=32, d_ff=16, vocab=64,
                            q_chunk=16, moe=MOE)}


def _requests(seed, n, max_new, eos=None, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, 64, int(rng.integers(lo, hi))).astype(
        np.int32), max_new_tokens=max_new, eos_id=eos) for _ in range(n)]


def _serve(kind, specs, n_slots, max_ctx=48, engines=None):
    """(reference requests, port requests, reference stats, port stats)."""
    rc = CONFIGS[kind]
    rp, tp = both_params(rc)
    r_eng = RE.LMDecodeEngine(rc, rp, r_rules(), n_slots=n_slots,
                              max_ctx=max_ctx)
    t_eng = TE.LMDecodeEngine(t_cfg(rc), tp, t_rules(), n_slots=n_slots,
                              max_ctx=max_ctx)
    r_reqs = [RE.DecodeRequest(**s) for s in specs]
    t_reqs = [TE.DecodeRequest(**s) for s in specs]
    out = r_reqs, t_reqs, r_eng.run(list(r_reqs)), t_eng.run(list(t_reqs))
    if engines is not None:
        engines.extend([r_eng, t_eng])
    return out


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_engine_tokens_equal_the_reference_engine(kind):
    """Seven requests through four slots: slots recycled mid-flight, free
    slots stepped at their stale lengths, and (MoE) four slots that
    ``decode_group`` = 4 would merge into one group of four tokens, whose
    capacity would drop choices."""
    engines = []
    r_reqs, t_reqs, r_stats, t_stats = _serve(kind, _requests(0, 7, 6), 4,
                                              engines=engines)
    assert [r.tokens for r in t_reqs] == [r.tokens for r in r_reqs]
    # the caches too: layer 1's keys and values carry layer 0's MoE output
    for a, b in zip(engines[1].cache, engines[0].cache):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) <= TOL
    assert all(r.done for r in t_reqs)
    for key in ("requests", "decode_steps", "mean_occupancy"):
        assert t_stats[key] == r_stats[key], key
    assert t_stats["decode_tokens"] == sum(len(r.tokens) - 1 for r in t_reqs)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_eos_and_the_context_limit_match_the_reference(kind):
    probe = _requests(1, 1, 3)
    r_reqs, t_reqs, _, _ = _serve(kind, probe, 1)
    eos = t_reqs[0].tokens[1]
    specs = [dict(probe[0], max_new_tokens=20, eos_id=eos)] + _requests(
        2, 3, 40, lo=10, hi=14)          # these run into max_ctx = 24
    r_reqs, t_reqs, r_stats, t_stats = _serve(kind, specs, 2, max_ctx=24)
    assert [r.tokens for r in t_reqs] == [r.tokens for r in r_reqs]
    assert len(t_reqs[0].tokens) < 1 + 20              # stopped on EOS
    assert t_stats["decode_steps"] == r_stats["decode_steps"]


def test_engine_equals_sequential_decode():
    rc = CONFIGS["moe"]
    tc = t_cfg(rc)
    _, tp = both_params(rc)
    eng = TE.LMDecodeEngine(tc, tp, t_rules(), n_slots=3, max_ctx=48)
    specs = _requests(3, 4, 5)
    reqs = [TE.DecodeRequest(**s) for s in specs]
    eng.run(list(reqs))
    for s, r in zip(specs, reqs):
        prompt = torch.from_numpy(s["prompt"])[None]
        logits, cache = TT.prefill_step(tp, prompt, tc, t_rules())
        big = TT.make_cache(tc, 1, 48, device="cpu")
        for b, c in zip(big, cache):
            b[:, :, :prompt.shape[1]] = c
        toks = [int(torch.argmax(logits[0]))]
        for ln in range(prompt.shape[1], prompt.shape[1] + 5):
            lg, big = TT.decode_step(tp, torch.tensor([[toks[-1]]]), big, ln,
                                     tc, t_rules())
            toks.append(int(torch.argmax(lg[0])))
        assert r.tokens == toks


def test_a_prompt_past_the_context_is_refused():
    tc = t_cfg(CONFIGS["dense"])
    _, tp = both_params(CONFIGS["dense"])
    eng = TE.LMDecodeEngine(tc, tp, t_rules(), n_slots=1, max_ctx=8)
    with pytest.raises(ValueError, match="exceeds max_ctx"):
        eng.submit(TE.DecodeRequest(prompt=np.zeros(9, np.int32)))

