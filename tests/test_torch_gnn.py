"""The port's GNN family (PNA) against the reference, on the CPU.

The data module's arrays (``make_graph``, ``make_molecule_batch``,
``CSRGraph``, ``sample_subgraph``) equal the reference's from the same
seeds.  PNA's forward, loss and gradients at the smoke config, on the
node task (a subgraph drawn by the real sampler, padded edges into the
sink), the graph task (a molecule batch) and a hand-made graph with empty
segments and tied ReLU-zero maxima, hold to 1e-5 (gradients 1e-4) against
``repro.models.pna`` with the reference's params carried across, in f64
and in f32 (there beside the reference's own f32 rounding); one AdamW
step against the reference's ``adamw_update``; the segment maxima's
gradient split evenly among tied messages, as JAX's.  The arch's cells,
``model_flops`` and ``cost_corrections`` equal the reference's, each cell
runs in the dry run on both production meshes, and the launcher runs the
smoke path on the CPU.  Helpers and tolerances: ``lm_parity.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gnn as RG  # noqa: E402
from repro.data import graph as RDG  # noqa: E402
from repro.models import pna as RP  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import named_leaves, train_step_fn  # noqa: E402
from repro_torch.configs import gnn as TG  # noqa: E402
from repro_torch.data import graph as TDG  # noqa: E402
from repro_torch.dist import tuned as TTu  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import pna as TP  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

from lm_parity import GRAD_TOL, TOL, err, np_tree, r_rules, t_rules  # noqa: E402


def _same_graph(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


# -- data/graph.py ------------------------------------------------------------


@pytest.mark.parametrize("args", [(400, 1600, 24, 5, 0, True),
                                  (300, 900, 8, 3, 7, False)])
def test_make_graph_equals_the_reference(args):
    _same_graph(TDG.make_graph(*args), RDG.make_graph(*args))


def test_molecule_batch_equals_the_reference():
    _same_graph(TDG.make_molecule_batch(8, 10, 20, 24, 5, 1),
                RDG.make_molecule_batch(8, 10, 20, 24, 5, 1))


@pytest.mark.parametrize("fanouts", [(4, 3), (15, 10)])
def test_csr_and_sampler_equal_the_reference(fanouts):
    tg = TDG.make_graph(400, 1600, 24, n_classes=5, seed=0)
    rg = RDG.make_graph(400, 1600, 24, n_classes=5, seed=0)
    tc = TDG.CSRGraph(400, tg.edge_src, tg.edge_dst)
    rc = RDG.CSRGraph(400, rg.edge_src, rg.edge_dst)
    for name in ("nbr", "indptr"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(rc, name))
        assert getattr(tc, name).dtype == getattr(rc, name).dtype
    seeds = np.arange(0, 64, 2)
    _same_graph(TDG.sample_subgraph(tg, tc, seeds, fanouts,
                                    np.random.default_rng(3)),
                RDG.sample_subgraph(rg, rc, seeds, fanouts,
                                    np.random.default_rng(3)))
    assert TDG._max_nodes(32, fanouts) == RDG._max_nodes(32, fanouts)
    assert TDG._max_edges(32, fanouts) == RDG._max_edges(32, fanouts)


def test_csr_of_ids_past_16_bits_equals_the_reference():
    """Node ids above 65,535 (the CSR's sort takes 16-bit halves) and
    many equal destinations (its stability)."""
    rng = np.random.default_rng(9)
    n, e = 200_003, 50_000
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[::7] = n - 1
    src = rng.integers(0, n, e).astype(np.int32)
    tc, rc = TDG.CSRGraph(n, src, dst), RDG.CSRGraph(n, src, dst)
    np.testing.assert_array_equal(tc.nbr, rc.nbr)
    np.testing.assert_array_equal(tc.indptr, rc.indptr)


# -- models/pna.py ---------------------------------------------------------------


def _cfgs(task="node", dtype=torch.float32, **kw):
    rdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    rc = RP.PNAConfig(name="pna-smoke", n_layers=2, d_hidden=16, d_feat=24,
                      n_classes=5, task=task, dtype=rdt, **kw)
    tc = TP.PNAConfig(dtype=dtype, **{
        f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)
        if f.name != "dtype"})
    return rc, tc


def _node_batch():
    g = RDG.make_graph(400, 1600, 24, n_classes=5, seed=0)
    csr = RDG.CSRGraph(400, g.edge_src, g.edge_dst)
    return RDG.sample_subgraph(g, csr, np.arange(32), [4, 3],
                               np.random.default_rng(0))


def _tied_batch():
    """Twelve nodes: node 0 receives only padded edges (a segment whose
    count is 0 but whose max/min see sentinels), nodes 1-2 receive nothing
    (empty segments), the rest receive real edges, some duplicated so
    their messages tie exactly."""
    rng = np.random.default_rng(5)
    n, e = 12, 40
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(3, n, e).astype(np.int32)
    dst[:4] = 0
    src[20:30], dst[20:30] = src[10:20], dst[10:20]   # duplicate edges
    mask = np.ones(e, bool)
    mask[:4] = False
    return RDG.GraphBatch(
        feats=rng.standard_normal((n, 24)).astype(np.float32), edge_src=src,
        edge_dst=dst, labels=rng.integers(0, 5, n).astype(np.int32),
        node_mask=np.ones(n, bool), edge_mask=mask)


def _batches(task):
    g = _node_batch() if task == "node" else (
        _tied_batch() if task == "tied" else
        RDG.make_molecule_batch(8, 10, 20, 24, n_classes=5, seed=1))
    arrays = {k: getattr(g, k) for k in ("feats", "edge_src", "edge_dst",
                                         "labels", "node_mask", "edge_mask")}
    if g.graph_ids is not None:
        arrays["graph_ids"] = g.graph_ids
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            TG.graph_batch(g, "cpu"))


def _both_params(rc, tc, seed=0, tie_channels=0):
    """The reference's seeded params (drawn in f32, then in the config's
    dtype) and the port's copy; ``tie_channels`` message channels get a
    bias of -100, so every message is exactly 0 there after the ReLU and
    each segment's max and min tie."""
    rp = RP.init_params(dataclasses.replace(rc, dtype=jnp.float32),
                        jax.random.key(seed))
    for lp in rp["layers"]:
        lp["msg_b"] = lp["msg_b"].at[:tie_channels].set(-100.0)
    tp = TP.params_from_numpy(np_tree(rp), tc, "cpu")
    return jax.tree.map(lambda x: x.astype(rc.dtype), rp), tp


def _leaves(tree):
    return jax.tree.leaves(tree)


def _run_both(task, dtype):
    """(loss, logits, grad leaves) of the reference and of the port on the
    task's batch in ``dtype``; f64 runs the reference under x64."""
    rc, tc = _cfgs("graph" if task == "graph" else "node", dtype,
                   **({"n_graphs": 8} if task == "graph" else {}))
    with jax.enable_x64(dtype == torch.float64):
        rp, tp = _both_params(rc, tc, tie_channels=6 if task == "tied" else 0)
        rb, tb = _batches(task)
        rules = r_rules()

        def ref(p, b):
            return RP.loss_fn(p, b, rc, rules), RP.forward(p, b, rc, rules)

        (r_loss, r_logits), r_grads = jax.jit(
            jax.value_and_grad(ref, has_aux=True))(rp, rb)
        r = [np.asarray(r_loss), np.asarray(r_logits)] + [
            np.asarray(g) for g in _leaves(r_grads)]
    t_rules_ = t_rules()
    loss, grads = TO.loss_and_grads(
        lambda p, b: TP.loss_fn(p, b, tc, t_rules_), tp, tb)
    with torch.no_grad():
        logits = TP.forward(tp, tb, tc, t_rules_)
    t = [loss, logits] + torch.utils._pytree.tree_leaves(grads)
    assert [tuple(x.shape) for x in t] == [x.shape for x in r]
    return [x.detach().to(torch.float64).numpy() for x in t], [
        x.astype(np.float64) for x in r]


def _scale(x):
    return max(1.0, float(np.abs(x).max()))


@pytest.mark.parametrize("task", ["node", "graph", "tied"])
def test_pna_forward_loss_and_grads_match(task):
    """In f64 on both sides: loss and logits within 1e-5, gradients within
    1e-4 (of the value's scale where it exceeds 1).  In f32 the same
    tolerances plus twice the reference's own f32 error against its f64
    run: the attenuation scaler gives a node without in-edges (every leaf
    of a sampled subgraph, the sink) std * 2.5 / 1e-5, about 790, so the
    update's f32 sums cancel terms of ~10^3 into logits of ~10^2, and
    both frameworks round there by about 2e-2 (the node task)."""
    t64, r64 = _run_both(task, torch.float64)
    t32, r32 = _run_both(task, torch.float32)
    for i, (a, b) in enumerate(zip(t64, r64)):
        tol = TOL if i < 2 else GRAD_TOL
        assert float(np.abs(a - b).max()) <= tol * _scale(b), i
    for i, (a, b, c) in enumerate(zip(t32, r32, r64)):
        tol = TOL if i < 2 else GRAD_TOL
        slack = 2.0 * float(np.abs(b - c).max())
        assert float(np.abs(a - b).max()) <= tol * _scale(b) + slack, i


def test_segment_extremes_split_tied_gradients_evenly_as_jax():
    """Messages with exact ties (zeros, and equal values within a
    segment), a padded edge and an empty segment: every aggregate and the
    gradient of a random cotangent through all five outputs equal JAX's;
    a tied maximum's gradient is split evenly among its messages."""
    msgs = np.array([[0.0, 1.0], [0.0, 1.0], [0.0, 0.5], [2.0, 0.0],
                     [2.0, 0.0], [3.0, 3.0], [0.0, 0.0]], np.float32)
    dst = np.array([0, 0, 0, 1, 1, 1, 3], np.int32)
    w = np.array([1, 1, 1, 1, 1, 1, 0], np.float32)   # the last is padding
    n = 4                                              # node 2 is empty
    rng = np.random.default_rng(0)
    cot = [rng.standard_normal((n, 2)).astype(np.float32) for _ in range(4)]
    cot.append(rng.standard_normal(n).astype(np.float32))

    def r_fn(m):
        return RP._segment_reduce(m, jnp.asarray(dst), n, jnp.asarray(w))

    r_out, vjp = jax.vjp(r_fn, jnp.asarray(msgs))
    (r_grad,) = vjp(tuple(jnp.asarray(c) for c in cot))
    tm = torch.from_numpy(msgs).requires_grad_(True)
    t_out = TP._segment_reduce(tm, torch.from_numpy(dst).long(), n,
                               torch.from_numpy(w))
    (t_grad,) = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(t_out, cot)), tm)
    for t, r in zip(t_out, r_out):
        assert err(t, r) <= TOL
    assert err(t_grad, r_grad) <= TOL
    # the max of segment 0's first channel (0.0) ties three ways: its
    # cotangent is split in thirds (plus mean/std/min terms, equal on both)
    only_max = [np.zeros((n, 2), np.float32)] * 4 + [np.zeros(n, np.float32)]
    only_max[1] = np.zeros((n, 2), np.float32)
    only_max[1][0, 0] = 3.0
    (g,) = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum()
            for o, c in zip(TP._segment_reduce(
                tm, torch.from_numpy(dst).long(), n, torch.from_numpy(w)),
                only_max)), tm)
    np.testing.assert_array_equal(g[:3, 0].numpy(), [1.0, 1.0, 1.0])


@pytest.mark.parametrize("task,dtype", [("node", torch.float64),
                                        ("graph", torch.float32)])
def test_pna_adamw_step_matches_the_reference(task, dtype):
    """One step of each side's train step with the cells' ``AdamWConfig()``
    (gradients, bf16 compression, the clip, AdamW) from the same params:
    params within 1e-5, moments and the gradient norm within 1e-4.  The
    sampler's subgraph runs in f64 (its f32 logits round by ~2e-2, see
    above), the molecules in f32."""
    rc, tc = _cfgs(task, dtype, **({"n_graphs": 8} if task == "graph"
                                    else {}))
    with jax.enable_x64(dtype == torch.float64):
        rp, tp = _both_params(rc, tc)
        rb, tb = _batches(task)
        rules = r_rules()
        ocfg = RO.AdamWConfig()

        @jax.jit
        def r_step(p, b):
            loss, grads = jax.value_and_grad(RP.loss_fn)(p, b, rc, rules)
            return RO.adamw_update(ocfg, p, grads, RO.init_opt_state(p))

        r_new, r_state, r_metrics = r_step(rp, rb)
        r_sets = [[np.asarray(x, np.float64) for x in _leaves(t)]
                  for t in (r_new, r_state.m, r_state.v)]
        r_norm = float(r_metrics["grad_norm"])
    t_rules_ = t_rules()
    step = train_step_fn(lambda p, b: TP.loss_fn(p, b, tc, t_rules_),
                         TO.AdamWConfig())
    t_new, t_state, t_metrics = step(tp, TO.init_opt_state(tp), tb)
    assert abs(float(t_metrics["grad_norm"]) - r_norm) <= GRAD_TOL * max(
        1.0, r_norm)
    for t, rs, tol in zip((t_new, t_state.m, t_state.v), r_sets,
                          (TOL, GRAD_TOL, GRAD_TOL)):
        for a, b in zip(torch.utils._pytree.tree_leaves(t), rs):
            assert float(np.abs(a.double().numpy() - b).max()) <= tol


def test_init_params_shapes_match_and_meta_is_empty():
    rc, tc = _cfgs()
    rp = RP.init_params(rc, jax.random.key(0))
    tp = TP.init_params(tc, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in named_leaves(tp)} == \
        {k: tuple(v.shape) for k, v in named_leaves(rp)}
    again = TP.init_params(tc, 3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(tp),
        torch.utils._pytree.tree_leaves(again)))
    on_meta = TP.init_params(tc, device="meta")
    assert all(x.device.type == "meta"
               for x in torch.utils._pytree.tree_leaves(on_meta))


# -- configs/gnn.py and the dry run --------------------------------------------


def test_pna_cells_and_flops_equal_the_reference():
    arch, ref = get_arch("pna"), RG.PNAArch()
    assert arch.family == ref.family == "gnn" and arch.source == ref.source
    assert {n: dataclasses.asdict(c) for n, c in arch.cells().items()} \
        == {n: dataclasses.asdict(c) for n, c in ref.cells().items()}
    for shape in arch.cells():
        assert arch.model_flops(shape) == ref.model_flops(shape)
        assert arch.cost_corrections(shape, 256) == (0.0, 0.0)
        assert TG._shape_dims(TG.GNN_SHAPES[shape]) == \
            RG._shape_dims(RG.GNN_SHAPES[shape])


@pytest.mark.parametrize("shape", list(TG.GNN_SHAPES))
def test_pna_cells_run_on_both_meshes(shape):
    arch = get_arch("pna")
    n_leaves = 4 + 4 * arch.n_layers
    for multi_pod in (False, True):
        out = dryrun.run_cell("pna", shape, multi_pod)
        rules = TTu.get_rules("default",
                              make_production_mesh(multi_pod=multi_pod))
        cost = arch.step_cost(shape, rules)
        chips = 512 if multi_pod else 256
        assert out["hlo_flops"] == cost.flops * chips > 0
        assert out["hlo_bytes"] == cost.nbytes * chips
        assert out["collective_bytes"] == cost.collective_bytes * chips
        assert out["model_flops"] == arch.model_flops(shape)
        assert out["outputs"][-2:] == [[], []]          # loss, grad norm
        assert len(out["outputs"]) == 3 * n_leaves + 2
        assert {"message", "aggregate", "update", "adamw"} <= set(
            out["kernels"])


def test_pna_smoke_run_and_the_launcher_on_the_cpu(monkeypatch, capsys):
    out = get_arch("pna").smoke_run(device="cpu")
    assert np.isfinite(out["loss"]) and out["grad_finite"]
    assert out["graph_logits_shape"] == (8, 5)
    assert np.isfinite(out["graph_loss"])
    monkeypatch.setattr("sys.argv", ["train", "--arch", "pna", "--device",
                                     "cpu"])
    launch_train.main()
    printed = capsys.readouterr().out
    assert "family=gnn" in printed and "'grad_finite': True" in printed
