"""PNA's edge-chunked path against the reference, on the CPU.

``repro_torch.models.pna`` takes the edge-chunked path (one
``_ChunkedAggregate`` a layer, each layer under ``torch.utils.checkpoint``)
where the whole-edge path's temporaries pass a byte budget; these tests
force it on small graphs by a small ``edge_budget`` (or a ``chunk`` given
to the layer).  Against ``repro.models.pna`` with the reference's params
carried across: one layer's output and gradients at 1 chunk, 3 chunks and
an uneven last chunk, and ``forward``/``loss_fn`` on the sampler's
subgraph, a molecule batch (the graph task) and a graph with padded-only
and empty segments and tied messages; in f64 (the reference under x64)
every value within 1e-5, in f32 beside twice the reference's own f32
error.  Ties that straddle a chunk boundary split their gradient evenly;
the maxima and minima are bit-equal to the whole-edge path's; and the
bytes a chunked step saves do not grow with the edge count.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.data import graph as RDG  # noqa: E402
from repro.models import pna as RP  # noqa: E402
from repro_torch.configs import gnn as TG  # noqa: E402
from repro_torch.models import pna as TP  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

from lm_parity import TOL, r_rules, t_rules  # noqa: E402
from test_torch_gnn import _batches, _both_params, _cfgs  # noqa: E402

F64 = {torch.float64: True, torch.float32: False}


def _budget(n_edges, cfg, n_chunks):
    """An ``edge_budget`` that splits ``n_edges`` into ``n_chunks``
    chunks, the last one shorter where they do not divide evenly."""
    per_edge = TP._edge_bytes(cfg.d_hidden, torch.finfo(cfg.dtype).bits // 8)
    chunk = -(-n_edges // n_chunks)
    assert TP.edge_chunk(n_edges, cfg.d_hidden, cfg.dtype,
                         chunk * per_edge) == chunk
    return chunk * per_edge


def _check(t, r64, r32=None):
    """Each of ``t`` within 1e-5 (of the value's scale past 1) of the
    reference's f64 value, plus twice the reference's own f32 error where
    ``r32`` is given."""
    for i, (a, b) in enumerate(zip(t, r64)):
        slack = 0.0 if r32 is None else 2.0 * float(np.abs(r32[i] - b).max())
        scale = max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= TOL * scale + slack, i


def _np(xs):
    return [np.asarray(x, np.float64) if not isinstance(x, torch.Tensor)
            else x.detach().double().numpy() for x in xs]


# -- one layer ---------------------------------------------------------------


def _layer_graph(n=14, e=48, d=16, seed=3):
    """``e`` edges over ``n`` nodes: node 0 receives only padded edges,
    node 1 none, and edges 10-21 repeat edges 0-11 (so the same messages
    recur in other chunks)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(2, n, e)
    src[10:22], dst[10:22] = src[0:12], dst[0:12]
    dst[:3] = 0
    w = np.ones(e)
    w[:3] = 0.0
    w[-2:] = 0.0                       # padded edges elsewhere too
    h = rng.standard_normal((n, d))
    return h, src, dst, w


def _layer_both(dtype, chunk):
    """The layer's output and the gradients of a random cotangent with
    respect to h and the layer's params: (port, reference f64, reference
    in ``dtype``)."""
    rc, tc = _cfgs(dtype=dtype)
    h, src, dst, w = _layer_graph(d=tc.d_hidden)
    cot = np.random.default_rng(4).standard_normal(h.shape)
    outs = {}
    for x64 in (True, False) if dtype == torch.float32 else (True,):
        with jax.enable_x64(x64):
            rdt = jnp.float64 if x64 else jnp.float32
            rp, _ = _both_params(dataclasses.replace(rc, dtype=rdt), tc,
                                 tie_channels=5)
            lp = rp["layers"][0]

            def f(h_, lp_):
                return RP.pna_layer(h_, lp_, jnp.asarray(src),
                                    jnp.asarray(dst),
                                    jnp.asarray(w, rdt), rc)

            out, vjp = jax.vjp(f, jnp.asarray(h, rdt), lp)
            g_h, g_lp = vjp(jnp.asarray(cot, rdt))
            outs[x64] = _np([out, g_h] + [g_lp[k] for k in sorted(g_lp)])
    _, tp = _both_params(dataclasses.replace(rc, dtype=jnp.float32), tc,
                         tie_channels=5)
    lp = {k: v.requires_grad_(True) for k, v in tp["layers"][0].items()}
    th = torch.tensor(h, dtype=dtype, requires_grad=True)
    out = TP.pna_layer(th, lp, torch.from_numpy(src), torch.from_numpy(dst),
                       torch.tensor(w, dtype=dtype), tc, chunk)
    grads = torch.autograd.grad(out, [th] + [lp[k] for k in sorted(lp)],
                                torch.tensor(cot, dtype=dtype))
    return _np([out, *grads]), outs[True], outs.get(False)


@pytest.mark.parametrize("chunk", [48, 16, 20],
                         ids=["1_chunk", "3_chunks", "uneven_last_chunk"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_chunked_layer_matches_the_reference(chunk, dtype):
    """One layer on 48 edges in chunks of 48, 16 and 20 (20, 20, 8), with
    a padded-only node, an empty node, repeated edges and five message
    channels at exactly 0 after the ReLU (every segment's max and min tie
    there, across chunks): the output and the gradients of h, msg_w,
    msg_b, upd_w and upd_b."""
    t, r64, r32 = _layer_both(dtype, chunk)
    _check(t, r64, r32)


# -- forward and loss_fn -----------------------------------------------------


def _run_both(task, dtype):
    """(loss, logits, grad leaves) of the port on the chunked path (3
    chunks, the last shorter) and of the reference, in ``dtype``; f64 runs
    the reference under x64."""
    rc, tc = _cfgs("graph" if task == "graph" else "node", dtype,
                   **({"n_graphs": 8} if task == "graph" else {}))
    with jax.enable_x64(F64[dtype]):
        rp, tp = _both_params(rc, tc, tie_channels=6 if task == "tied" else 0)
        rb, tb = _batches(task)
        rules = r_rules()

        def ref(p, b):
            return RP.loss_fn(p, b, rc, rules), RP.forward(p, b, rc, rules)

        (r_loss, r_logits), r_grads = jax.jit(
            jax.value_and_grad(ref, has_aux=True))(rp, rb)
        r = _np([r_loss, r_logits] + jax.tree.leaves(r_grads))
    budget = _budget(tb["edge_src"].shape[0], tc, 3)
    rules_ = t_rules()
    loss, grads = TO.loss_and_grads(
        lambda p, b: TP.loss_fn(p, b, tc, rules_, budget), tp, tb)
    with torch.no_grad():
        logits = TP.forward(tp, tb, tc, rules_, budget)
    t = _np([loss, logits] + torch.utils._pytree.tree_leaves(grads))
    assert [x.shape for x in t] == [x.shape for x in r]
    return t, r


@pytest.mark.parametrize("task", ["node", "graph", "tied"])
def test_chunked_forward_loss_and_grads_match(task):
    """``loss_fn``'s loss and gradients and ``forward``'s logits on the
    chunked path against the reference: in f64 every value within 1e-5;
    in f32 within 1e-5 plus twice the reference's own f32 error against
    its f64 run (the attenuation scaler carries the std aggregator's f32
    cancellation on: see ``test_torch_gnn.py``)."""
    t64, r64 = _run_both(task, torch.float64)
    _check(t64, r64)
    t32, r32 = _run_both(task, torch.float32)
    _check(t32, r64, r32)


# -- ties, sentinels and bits --------------------------------------------------


def _aggregate(h, w_msg, b_msg, src, dst, edge_w, chunk):
    return TP._ChunkedAggregate.apply(h, w_msg, b_msg, src, dst, edge_w,
                                      chunk)


def _whole(h, w_msg, b_msg, src, dst, edge_w):
    msgs = F.relu(TP._message_inputs(h, src, dst) @ w_msg + b_msg)
    return TP._segment_reduce(msgs, dst, h.shape[0], edge_w)


def test_ties_across_chunk_boundaries_split_evenly():
    """Node 0 receives the same edge six times, two a chunk: its message
    ties for the max and the min across three chunks.  A cotangent of 3
    on its max (channel 0) and of 2 on its min (channel 1) reaches msg_b
    whole, a sixth through each message; node 2's max moves from one chunk
    to a larger message in the next (its tie count restarts).  Every
    gradient equals the whole-edge path's."""
    d = 4
    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((5, d)), requires_grad=True)
    w_msg = torch.tensor(0.1 * rng.standard_normal((2 * d, d)),
                         requires_grad=True)
    b_msg = torch.tensor([5.0, 5.0, 0.0, 0.0], dtype=torch.float64,
                         requires_grad=True)            # z > 0 in 0 and 1
    src = torch.tensor([1, 1, 1, 1, 1, 1, 3, 3, 4, 4])
    dst = torch.tensor([0, 0, 0, 0, 0, 0, 2, 2, 2, 2])
    edge_w = torch.ones(10, dtype=torch.float64)
    cot = [torch.zeros(5, d, dtype=torch.float64) for _ in range(4)]
    cot[1][0, 0], cot[2][0, 1] = 3.0, 2.0
    outs = _aggregate(h, w_msg, b_msg, src, dst, edge_w, 2)
    g = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cot)),
                            (h, w_msg, b_msg))
    assert g[2][0].item() == 3.0 and g[2][1].item() == 2.0
    # node 2 and the whole cotangent: the whole-edge path's gradients
    cot = [torch.tensor(rng.standard_normal((5, d))) for _ in range(4)]
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(_whole(h, w_msg, b_msg, src, dst,
                                                 edge_w), cot)),
        (h, w_msg, b_msg))
    got = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(
            _aggregate(h, w_msg, b_msg, src, dst, edge_w, 2), cot)),
        (h, w_msg, b_msg))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _extremes_graph(n=400, e=3000):
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(0, n, e))
    dst = torch.from_numpy(rng.integers(1, n, e))
    edge_w = torch.ones(e)
    dst[-10:] = 0                       # node 0: only padded in-edges
    edge_w[-10:] = 0.0
    return {"edge_src": src, "edge_dst": dst, "edge_w": edge_w}


@pytest.mark.parametrize("chunk", [1000, 777, 64])
def test_chunked_extremes_are_bit_equal_to_the_whole_edge_path(chunk):
    """On 3,000 f32 edges over 400 nodes (ten padded, one node with only
    padded in-edges) in chunks of 1,000, 777 and 64: max and min bit-equal
    to the whole-edge path's, the count too, mean and std within
    rounding."""
    g = _extremes_graph()
    rng = np.random.default_rng(1)
    d = 16
    h = torch.tensor(rng.standard_normal((400, d)), dtype=torch.float32)
    w_msg = torch.tensor(rng.standard_normal((2 * d, d)) / 6,
                         dtype=torch.float32)
    b_msg = torch.tensor(rng.standard_normal(d) - 0.5, dtype=torch.float32)
    args = (h, w_msg, b_msg, g["edge_src"], g["edge_dst"], g["edge_w"])
    with torch.no_grad():
        got = _aggregate(*args, chunk)
        want = _whole(*args)
    for name, a, b in zip(("mean", "max", "min", "std", "cnt"), got, want):
        if name in ("max", "min", "cnt"):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# -- memory ------------------------------------------------------------------


def _saved_bytes(fn, keep):
    """Bytes of the tensors autograd saves while ``fn`` runs, but for
    those that share storage with ``keep`` (the graph's own arrays)."""
    skip = {t.untyped_storage().data_ptr() for t in keep}
    total = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in skip:
            total.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(total), out


def _graph_batch(n_edges, dtype):
    g = RDG.make_graph(300, n_edges, 24, n_classes=5, seed=0)
    b = TG.graph_batch(g, "cpu")
    b["edge_src"], b["edge_dst"] = b["edge_src"].long(), b["edge_dst"].long()
    b["edge_mask"] = b["edge_mask"].to(dtype)
    return b


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_chunked_step_saves_no_edge_sized_tensor(dtype):
    """A step on the chunked path (chunks of 128 edges) saves as many
    bytes for the backward at E = 1,200 as at 4E, beside the graph's own
    arrays, through ``forward`` and through one layer alone; the
    whole-edge path's grow by at least the added edges' message inputs;
    and the 4E step's
    gradients equal the whole-edge path's."""
    _, cfg = _cfgs(dtype=dtype)
    esize = torch.finfo(dtype).bits // 8
    per_edge = TP._edge_bytes(cfg.d_hidden, esize)
    params = TP.init_params(cfg, 0, device="cpu")
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_(True)
    rules = t_rules()
    saved = {}
    for e in (1200, 4800):
        b = _graph_batch(e, dtype)
        keep = [b["edge_src"], b["edge_dst"], b["edge_mask"]]
        for budget in (per_edge * 128, TP.EDGE_BUDGET):
            saved[e, budget], _ = _saved_bytes(
                lambda: TP.loss_fn(params, b, cfg, rules, budget), keep)
        h = torch.randn(300, cfg.d_hidden, dtype=dtype, requires_grad=True)
        saved[e, "layer"], _ = _saved_bytes(
            lambda: TP.pna_layer(h, params["layers"][0], b["edge_src"],
                                 b["edge_dst"], b["edge_mask"], cfg, 128),
            keep)
    assert saved[1200, per_edge * 128] == saved[4800, per_edge * 128]
    assert saved[1200, "layer"] == saved[4800, "layer"]
    assert saved[4800, TP.EDGE_BUDGET] - saved[1200, TP.EDGE_BUDGET] >= \
        3600 * 2 * cfg.d_hidden * esize    # at least the message inputs
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_(False)
    got = TO.loss_and_grads(
        lambda p, bb: TP.loss_fn(p, bb, cfg, rules, per_edge * 128), params,
        b)
    want = TO.loss_and_grads(
        lambda p, bb: TP.loss_fn(p, bb, cfg, rules), params, b)
    for a, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)


def test_the_path_is_chosen_from_the_shapes():
    """ogb_products' padded 61,859,328 edges at d = 75 pass the budget (in
    chunks of about 1.9M edges in f32); minibatch_lg, full_graph_sm and
    molecule keep the whole-edge path."""
    d = 75
    n, e = TG._shape_dims(TG.GNN_SHAPES["ogb_products"])
    assert (n, e) == (2_449_408, 61_859_328)
    chunk = TP.edge_chunk(e, d, torch.float32)
    assert chunk is not None and 1_500_000 <= chunk <= 2_000_000
    assert -(-e // chunk) == 33
    for shape in ("minibatch_lg", "full_graph_sm", "molecule"):
        _, e = TG._shape_dims(TG.GNN_SHAPES[shape])
        assert TP.edge_chunk(e, d, torch.float32) is None, shape
