"""The port's recsys family against the reference, on the CPU.

The four batch makers of ``data/recsys.py`` equal the reference's from
the same seeds.  At each arch's smoke config, with the reference's params
carried across (``params_from_numpy``): DLRM, BST, AutoInt and two-tower
forward, loss and gradients hold to 1e-5 (gradients 1e-4) against
``repro.models.recsys``, and one train step of each against the
reference's ``adamw_update``.  The two-tower ``retrieval_cand`` step
(user tower, then K1 -> K2 -> K3 through their plain versions here) at
4,096 candidates x 32 picks the reference's 500-of-1,500 ids exactly;
K1's plain version takes d = 256 (the published item vectors) and equals
``pem_score_ref``.  The 16 cells' ``cells()``, ``model_flops`` and
``cost_corrections`` equal the reference's, each runs in the dry run on
both production meshes, and the launcher runs the smoke path on the CPU.
Helpers and tolerances: ``lm_parity.py``.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import recsys_archs as RRA  # noqa: E402
from repro.data import recsys as RDR  # noqa: E402
from repro.kernels.pem_score.ref import pem_score_ref as r_pem_ref  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import recsys_archs as TRA  # noqa: E402
from repro_torch.configs.base import named_leaves, train_step_fn  # noqa: E402
from repro_torch.data import recsys as TDR  # noqa: E402
from repro_torch.dist import tuned as TTu  # noqa: E402
from repro_torch.kernels.pem_score.ops import pem_score  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

from lm_parity import GRAD_TOL, TOL, err, np_tree, r_rules, t_rules  # noqa: E402

IDS = ["dlrm-mlperf", "bst", "autoint", "two-tower-retrieval"]
REF = {a.arch_id: a for a in RRA.RECSYS_ARCHS}


def _same_batch(a, b):
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- data/recsys.py ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 11])
def test_batches_equal_the_reference(seed):
    assert TDR.CRITEO_1TB_VOCAB_SIZES == RDR.CRITEO_1TB_VOCAB_SIZES
    _same_batch(TDR.dlrm_batch(64, 13, TDR.CRITEO_1TB_VOCAB_SIZES, seed),
                RDR.dlrm_batch(64, 13, RDR.CRITEO_1TB_VOCAB_SIZES, seed))
    _same_batch(TDR.bst_batch(64, 20, 5000, 8, seed),
                RDR.bst_batch(64, 20, 5000, 8, seed))
    _same_batch(TDR.autoint_batch(64, 39, 1000, seed),
                RDR.autoint_batch(64, 39, 1000, seed))
    _same_batch(TDR.twotower_batch(64, 300, 500, 20, seed),
                RDR.twotower_batch(64, 300, 500, 20, seed))


# -- models/recsys.py ------------------------------------------------------------


def _both(arch_id, dtype=torch.float32):
    """(reference arch, its smoke config, the port's, the reference's
    params, the port's copy, the reference's batch, the port's)."""
    ref, port = REF[arch_id], get_arch(arch_id)
    tcfg = dataclasses.replace(port.smoke_cfg, dtype=dtype)
    rcfg = dataclasses.replace(ref.smoke_cfg, dtype={
        torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype])
    rp = ref._init(ref.smoke_cfg, jax.random.key(0))
    tp = TR.params_from_numpy(np_tree(rp), tcfg, "cpu")
    rp = jax.tree.map(lambda x: x.astype(rcfg.dtype), rp)
    rb = RRA._smoke_data(arch_id, ref.smoke_cfg, 16)
    tb = TRA.smoke_data(arch_id, port.smoke_cfg, 16, "cpu")
    return ref, rcfg, port, tcfg, rp, tp, rb, tb


@pytest.mark.parametrize("arch_id", IDS)
def test_forward_loss_and_grads_match(arch_id):
    ref, rcfg, port, tcfg, rp, tp, rb, tb = _both(arch_id)
    for k in rb:
        np.testing.assert_array_equal(np.asarray(rb[k]), tb[k].numpy())
    rules = r_rules()

    def r_fn(p, b):
        return ref._loss(p, b, rcfg, rules), ref._fwd(p, b, rcfg, rules)

    (r_loss, r_out), r_grads = jax.jit(jax.value_and_grad(
        r_fn, has_aux=True))(rp, rb)
    tr = t_rules()
    loss, grads = TO.loss_and_grads(
        lambda p, b: port._loss(p, b, tcfg, tr), tp, tb)
    with torch.no_grad():
        out = port._fwd(tp, tb, tcfg, tr)
    assert tuple(out.shape) == r_out.shape
    assert err(out, r_out) <= TOL
    assert abs(float(loss) - float(r_loss)) <= TOL
    r_named = dict(named_leaves(jax.tree.map(np.asarray, r_grads)))
    t_named = dict(named_leaves(grads))
    assert set(r_named) == set(t_named)
    for name, g in t_named.items():
        assert err(g, r_named[name]) <= GRAD_TOL, name


def test_embedding_bag_and_dense_table_gradient():
    """Sum and mean bags with -1 padding (an all-padding bag is zero) and
    the table's gradient dense, as under ``jnp.take``, against the
    reference."""
    from repro.models import recsys as RR

    rng = np.random.default_rng(2)
    table = rng.standard_normal((9, 4)).astype(np.float32)
    idx = np.array([[0, 3, 3, -1], [-1, -1, -1, -1], [8, 1, 2, 5]], np.int32)
    cot = rng.standard_normal((3, 4)).astype(np.float32)
    for mode in ("sum", "mean"):
        r_out, vjp = jax.vjp(lambda t: RR.embedding_bag(t, jnp.asarray(idx),
                                                        mode),
                             jnp.asarray(table))
        (r_grad,) = vjp(jnp.asarray(cot))
        t = torch.from_numpy(table).requires_grad_(True)
        out = TR.embedding_bag(t, torch.from_numpy(idx), mode)
        (grad,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), t)
        assert not grad.is_sparse and grad.shape == (9, 4)
        assert err(out, r_out) <= TOL and err(grad, r_grad) <= TOL
    with pytest.raises(ValueError):
        TR.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), "max")


@pytest.mark.parametrize("arch_id", IDS)
def test_train_step_matches_the_reference(arch_id):
    """One step of each side's train step with the cells' ``AdamWConfig()``
    (gradients, bf16 compression, the clip, AdamW): params within 1e-5,
    moments and the gradient norm within 1e-4."""
    ref, rcfg, port, tcfg, rp, tp, rb, tb = _both(arch_id)
    rules = r_rules()
    ocfg = RO.AdamWConfig()

    @jax.jit
    def r_step(p, b):
        loss, grads = jax.value_and_grad(ref._loss)(p, b, rcfg, rules)
        return RO.adamw_update(ocfg, p, grads, RO.init_opt_state(p))

    r_new, r_state, r_metrics = r_step(rp, rb)
    tr = t_rules()
    step = train_step_fn(lambda p, b: port._loss(p, b, tcfg, tr),
                         TO.AdamWConfig())
    t_new, t_state, t_metrics = step(tp, TO.init_opt_state(tp), tb)
    r_norm = float(r_metrics["grad_norm"])
    assert abs(float(t_metrics["grad_norm"]) - r_norm) <= GRAD_TOL * max(
        1.0, r_norm)
    for t, r, tol in ((t_new, r_new, TOL), (t_state.m, r_state.m, GRAD_TOL),
                      (t_state.v, r_state.v, GRAD_TOL)):
        r_named = dict(named_leaves(jax.tree.map(np.asarray, r)))
        for name, x in named_leaves(t):
            assert err(x, r_named[name]) <= tol, name


def test_init_shapes_match_and_meta_is_empty():
    for arch_id in IDS:
        ref, port = REF[arch_id], get_arch(arch_id)
        r_shapes = {k: tuple(v.shape) for k, v in named_leaves(
            ref._init(ref.smoke_cfg, jax.random.key(0)))}
        tp = port._init(port.smoke_cfg, 1, device="cpu")
        assert {k: tuple(v.shape) for k, v in named_leaves(tp)} == r_shapes
        on_meta = port._init(port.cfg, device="meta")   # published sizes
        assert all(v.device.type == "meta" for _, v in named_leaves(on_meta))
    # the two-tower item table: 8,388,608 x 256 = 2^31 elements
    items = dict(named_leaves(get_arch("two-tower-retrieval")._init(
        get_arch("two-tower-retrieval").cfg, device="meta")))["item_table"]
    assert items.numel() == 2 ** 31


# -- the retrieval_cand step ----------------------------------------------------


def test_pem_score_plain_takes_d256_and_equals_the_reference():
    rng = np.random.default_rng(256)
    n, d, b = 3000, 256, 3
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    qp = rng.standard_normal((d, b)).astype(np.float32)
    qs = (rng.standard_normal((d, b)) * 0.3).astype(np.float32)
    days = rng.uniform(0, 90, n).astype(np.float32)
    decay = (1.0 / (1.0 + days / 30.0)).astype(np.float32)
    want = np.asarray(r_pem_ref(jnp.asarray(m), jnp.asarray(qp),
                                jnp.asarray(qs), jnp.asarray(decay)))
    got = pem_score(torch.from_numpy(m), torch.from_numpy(qp),
                    torch.from_numpy(qs), torch.from_numpy(decay))
    per_plan = pem_score(torch.from_numpy(m), torch.from_numpy(qp),
                         torch.from_numpy(qs), days_ago=torch.from_numpy(days),
                         half_lives=torch.full((b,), 30.0))
    assert got.shape == (n, b)
    assert err(got, want) <= TOL and err(per_plan, want) <= TOL


def _reference_retrieval(n, seed):
    """The reference's retrieval_cand step at the smoke config over n
    seeded unit candidates (its ``_build_retrieval``, on a 1x1 mesh with
    Auto axes), and its inputs."""
    ref = copy.copy(REF["two-tower-retrieval"])
    ref.cfg = ref.smoke_cfg
    rules = r_rules()
    rp = ref._init(ref.cfg, jax.random.key(0))
    spec = ref._build_retrieval(dict(n_candidates=n), rules.mesh, rules,
                                rp, None)
    rng = np.random.default_rng(seed)
    cand = rng.standard_normal((n, ref.cfg.tower_mlp[-1])).astype(np.float32)
    cand /= np.linalg.norm(cand, axis=1, keepdims=True)
    days = rng.uniform(0, 90, n).astype(np.float32)
    raw = RDR.twotower_batch(1, ref.cfg.vocab_user, ref.cfg.vocab_item,
                             ref.cfg.hist_len, seed)
    batch = {k: raw[k] for k in ("user_id", "hist")}
    idx, val = jax.jit(spec.fn)(rp, {k: jnp.asarray(v) for k, v in
                                     batch.items()},
                                jnp.asarray(cand), jnp.asarray(days))
    return rp, batch, cand, days, np.asarray(idx), np.asarray(val)


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_step_picks_the_reference_ids(seed):
    n = 4096
    rp, batch, cand, days, r_idx, r_val = _reference_retrieval(n, seed)
    port = get_arch("two-tower-retrieval")
    cfg = port.smoke_cfg
    tp = TR.params_from_numpy(np_tree(rp), cfg, "cpu")
    idx, val = TRA.retrieval_step(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(cand), torch.from_numpy(days), cfg, t_rules())
    assert idx.shape == val.shape == (1, TRA.POOL) == r_idx.shape
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), r_idx)
    assert err(val, r_val) <= TOL
    assert len(set(idx[0].tolist())) == TRA.POOL


# -- configs/recsys_archs.py and the dry run -----------------------------------


@pytest.mark.parametrize("arch_id", IDS)
def test_cells_flops_and_corrections_equal_the_reference(arch_id):
    arch, ref = get_arch(arch_id), REF[arch_id]
    assert arch.family == ref.family == "recsys" and arch.source == ref.source
    assert {n: dataclasses.asdict(c) for n, c in arch.cells().items()} \
        == {n: dataclasses.asdict(c) for n, c in ref.cells().items()}
    for shape in arch.cells():
        assert arch.model_flops(shape) == ref.model_flops(shape)
        for chips in (256, 512):
            assert arch.cost_corrections(shape, chips) == \
                ref.cost_corrections(shape, chips)
    for f in dataclasses.fields(arch.cfg):
        if f.name != "dtype":
            assert getattr(arch.cfg, f.name) == getattr(ref.cfg, f.name)
            assert getattr(arch.smoke_cfg, f.name) == getattr(ref.smoke_cfg,
                                                              f.name)


@pytest.mark.parametrize("arch_id", IDS)
def test_recsys_cells_run_on_both_meshes(arch_id):
    arch = get_arch(arch_id)
    for shape, cell in arch.cells().items():
        for multi_pod in (False, True):
            out = dryrun.run_cell(arch_id, shape, multi_pod)
            rules = TTu.get_rules("default",
                                  make_production_mesh(multi_pod=multi_pod))
            cost = arch.step_cost(shape, rules)
            chips = 512 if multi_pod else 256
            assert out["hlo_flops"] == cost.flops * chips > 0
            assert out["hlo_bytes"] == cost.nbytes * chips
            assert out["collective_bytes"] == cost.collective_bytes * chips
            assert out["model_flops"] == arch.model_flops(shape)
            assert (out["cost_corrections"]["flops"],
                    out["cost_corrections"]["bytes"]) == \
                arch.cost_corrections(shape, chips)
            if cell.kind == "train":
                assert out["outputs"][-2:] == [[], []]   # loss, grad norm
                assert "adamw" in out["kernels"]
            elif arch_id == "two-tower-retrieval" and shape == "retrieval_cand":
                assert out["outputs"] == [[1, 500], [1, 500]]
                assert {"pem_score", "topk", "gather", "mmr",
                        "user_tower"} <= set(out["kernels"])
            else:
                b = 1_000_000 if shape == "retrieval_cand" else \
                    TRA.SHAPES[shape]["batch"]
                assert out["outputs"][0][0] == b


def test_retrieval_cost_counts_the_kernels_at_d256():
    """K1's bytes at 1M x 256 f32 on one device: the candidates (1.024
    GB), both query columns, the ages and the (N, 1) panel."""
    from repro_torch.configs.flexvec import pem_score_work

    rules = TTu.get_rules("default", make_production_mesh())
    cost = get_arch("two-tower-retrieval").step_cost("retrieval_cand", rules)
    local = 1_000_000 // rules.size_of("candidates")
    assert cost.kernels["pem_score"] == pem_score_work(local, 256, 1, 4)
    assert cost.kernels["mmr"].flops == 2.0 * 500 * 1500 * 256
    assert cost.kernels["topk"].nbytes == 1_000_000 * 4 + 1500 * 8


def test_recsys_smoke_run_and_the_launcher_on_the_cpu(monkeypatch, capsys):
    for arch_id in IDS:
        out = get_arch(arch_id).smoke_run(device="cpu")
        assert np.isfinite(out["loss"]) and out["grad_finite"]
        assert out["fwd_shape"] == ((16, 32) if arch_id == IDS[-1]
                                    else (16,))
    monkeypatch.setattr("sys.argv", ["train", "--arch", "bst", "--device",
                                     "cpu"])
    launch_train.main()
    printed = capsys.readouterr().out
    assert "family=recsys" in printed and "'grad_finite': True" in printed
