"""Row-sharded recsys tables on the CPU, against the reference.

A test-only DLRM config at the smoke widths, with each Criteo vocabulary
capped at 8,192 instead of 50, so that the tables of 7,168-8,192 padded
rows reach ``_SHARD_MIN_ROWS`` and really shard.  The reference's
``dlrm_init`` weights, carried across by ``params_from_numpy``, are placed
by ``RecsysArch.place`` over ``["cpu"] * S``: the serve step's logits and
the loss are bit-equal to the port's unsharded forward and within ``TOL``
of the reference's ``dlrm_forward``.  Each block holds R/S rows and a
small table stays whole; a placed ``dlrm_init`` equals the unplaced one;
a shard count that does not divide raises, naming the table; a bag over
a placed table with -1 padding equals the whole table's; BST's, AutoInt's
and two-tower's placed tables give their unplaced forwards bit for bit.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.utils._pytree as pytree  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import recsys as RDR  # noqa: E402
from repro.models import recsys as RR  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import recsys_archs as TRA  # noqa: E402
from repro_torch.dist.sharding import (AbstractMesh, RowShardedTable,  # noqa: E402
                                       default_rules, place_rows)
from repro_torch.launch.mesh import local_model_devices  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402

from lm_parity import TOL, err, np_tree, r_rules  # noqa: E402

CAP = 8_192
VOCAB = tuple(min(v, CAP) for v in RDR.CRITEO_1TB_VOCAB_SIZES)
WIDTHS = dict(bot_mlp=(32, 16), top_mlp=(32, 16, 1), embed_dim=16)
B = 64


def _rules(s):
    mesh = AbstractMesh((1, s), ("data", "model"))
    return mesh, default_rules(mesh)


def _arch():
    """dlrm-mlperf's arch at the test config."""
    arch = copy.copy(get_arch("dlrm-mlperf"))
    arch.cfg = dataclasses.replace(arch.cfg, name="dlrm-shard-test",
                                   vocab_sizes=VOCAB, **WIDTHS)
    return arch


@pytest.fixture(scope="module")
def dlrm():
    """(the port's arch, the reference's params and batch, the port's)."""
    arch = _arch()
    rcfg = RR.DLRMConfig(name="dlrm-shard-test", vocab_sizes=VOCAB, **WIDTHS)
    rp = RR.dlrm_init(rcfg, jax.random.key(0))
    rb = {k: jnp.asarray(v) for k, v in
          RDR.dlrm_batch(B, 13, VOCAB, seed=5).items()}
    r_out = jax.jit(lambda p, b: RR.dlrm_forward(p, b, rcfg, r_rules()))(
        rp, rb)
    tp = TR.params_from_numpy(np_tree(rp), arch.cfg, "cpu")
    # the port's key order (jax.tree sorts a dict's keys), which the serve
    # step's flattened arguments follow
    tp = {k: tp[k] for k in TR.dlrm_init(arch.cfg, device="meta")}
    tb = TRA.smoke_data("dlrm-mlperf", arch.cfg, B, "cpu", seed=5)
    return arch, np.asarray(r_out), tp, tb


def test_the_test_config_shards_tables():
    padded = _arch().cfg.padded_vocab_sizes
    big = [v for v in padded if v >= TR._SHARD_MIN_ROWS]
    assert len(big) == 15 and max(big) == CAP and min(big) == 7_168
    assert len(padded) - len(big) == 11


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_placed_forward_is_bit_equal_and_near_the_reference(dlrm, shards):
    arch, r_out, tp, tb = dlrm
    mesh, rules = _rules(shards)
    placed = arch.place(tp, rules, ["cpu"] * shards)
    assert sum(isinstance(t, RowShardedTable)
               for t in placed["tables"]) == 15
    spec = arch.build("serve_p99", mesh, rules)
    with torch.no_grad():
        got = spec.fn(*pytree.tree_leaves(placed), *tb.values())
        want = TR.dlrm_forward(tp, tb, arch.cfg, rules)
        loss = TR.dlrm_loss(placed, tb, arch.cfg, rules)
        want_loss = TR.dlrm_loss(tp, tb, arch.cfg, rules)
    assert tuple(got.shape) == (B,)
    assert torch.equal(got, want)
    assert torch.equal(loss, want_loss)
    assert err(got, r_out) <= TOL
    for t in placed["tables"]:
        if isinstance(t, RowShardedTable):
            assert sum(t.routed) == 2 * B   # the serve step and the loss


def test_blocks_hold_their_rows_and_small_tables_stay_whole(dlrm):
    arch, _, tp, _ = dlrm
    placed = arch.place(tp, _rules(4)[1], ["cpu"] * 4)
    for whole, t, rows in zip(tp["tables"], placed["tables"],
                              arch.cfg.padded_vocab_sizes):
        if rows < TR._SHARD_MIN_ROWS:
            assert isinstance(t, torch.Tensor) and torch.equal(t, whole)
            continue
        assert t.shape == (rows, 16) and t.block == rows // 4
        assert t.n_shards == 4 and t.dtype == torch.float32
        for s, blk in enumerate(t.blocks):
            assert blk.shape == (rows // 4, 16)
            assert torch.equal(blk, whole[s * t.block:(s + 1) * t.block])
    for k in ("bot_w", "bot_b", "top_w", "top_b"):
        for a, b in zip(placed[k], tp[k]):
            assert isinstance(a, torch.Tensor) and torch.equal(a, b)


def test_placed_init_equals_the_unplaced_init():
    cfg = _arch().cfg
    whole = TR.dlrm_init(cfg, 3, device="cpu")
    placed = TR.dlrm_init(cfg, 3, device="cpu", devices=["cpu"] * 4)
    for w, p in zip(whole["tables"], placed["tables"]):
        if isinstance(p, RowShardedTable):
            assert p.n_shards == 4
            p = torch.cat(p.blocks)
        assert torch.equal(w, p)
    for k in ("bot_w", "bot_b", "top_w", "top_b"):
        for a, b in zip(whole[k], placed[k]):
            assert torch.equal(a, b)


def test_a_shard_count_that_does_not_divide_raises(dlrm):
    arch, _, tp, _ = dlrm
    with pytest.raises(ValueError, match=r"tables/0: 8192 rows .* 3 row"):
        arch.place(tp, _rules(3)[1], ["cpu"] * 3)
    with pytest.raises(ValueError, match="tables/0"):
        TR.dlrm_init(arch.cfg, 0, device="cpu", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="'model' axis"):
        arch.place(tp, _rules(2)[1], ["cpu"] * 4)


def test_a_missing_card_raises(monkeypatch, dlrm):
    arch, _, tp, _ = dlrm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_model_devices(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        arch.place(tp, _rules(2)[1], ["cuda:0"] * 2)
    assert local_model_devices(4, "cpu") == ["cpu"] * 4


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_over_a_placed_table_equals_the_whole_table(mode):
    g = torch.Generator().manual_seed(7)
    table = torch.randn(8_192, 16, generator=g)
    idx = torch.randint(0, 8_192, (32, 6), generator=g, dtype=torch.int32)
    idx[::3, 4:] = -1
    idx[5] = -1                                   # an all-padding bag
    placed = place_rows([table], [("model", None)], ["cpu"] * 4)[0]
    assert torch.equal(TR.embedding_bag(placed, idx, mode),
                       TR.embedding_bag(table, idx, mode))
    assert torch.equal(TR.embedding_lookup(placed, idx[1]),
                       table[idx[1].long()])
    with pytest.raises(IndexError):
        TR.embedding_lookup(placed, torch.tensor([8_192]))


@pytest.mark.parametrize("arch_id", ["bst", "autoint", "two-tower-retrieval"])
def test_other_archs_forward_on_placed_tables(arch_id):
    arch = copy.copy(get_arch(arch_id))
    arch.cfg = arch.smoke_cfg
    params = arch._init(arch.cfg, 0, device="cpu")
    placed = arch.place(params, _rules(4)[1], ["cpu"] * 4)
    assert any(isinstance(t, RowShardedTable) for t in placed.values())
    batch = TRA.smoke_data(arch_id, arch.cfg, 16, "cpu")
    rules = _rules(4)[1]
    with torch.no_grad():
        assert torch.equal(arch._fwd(placed, batch, arch.cfg, rules),
                           arch._fwd(params, batch, arch.cfg, rules))
