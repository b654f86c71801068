"""The port's training stack against the reference, on the CPU.

AdamW over several steps (warmup, the clip, bf16 leaves, compressed
gradients), its learning-rate schedule, gradient accumulation, the
synthetic token stream batch for batch, and a short ``Trainer`` loss
trajectory, each held against ``repro.train`` / ``repro.data`` on the
same seeded inputs (1e-4 for gradients and losses over steps).  Then the
port's own fault tolerance: exact resume, bit-exact bf16 checkpoints,
``latest_step`` and ``prune``, the loud shape mismatch, the watchdog and
the elastic replanner, and the launcher on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import loader as RD  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import elastic as REl  # noqa: E402
from repro.train import loop as RLoop  # noqa: E402
from repro.train import optimizer as RO  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.lm import lm_train_step  # noqa: E402
from repro_torch.data import loader as TD  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train import elastic as TEl  # noqa: E402
from repro_torch.train import loop as TLoop  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

from lm_parity import (GRAD_TOL, both_params, err, r_params,  # noqa: E402
                       r_rules, small_cfg, t_cfg, t_rules)


def _tree(rng, bf16_leaf=True):
    """A small params tree: f32 matrices, and a bf16 one (its values
    exactly representable, so both sides start from the same bits)."""
    t = {"a": rng.standard_normal((4, 6)).astype(np.float32),
         "n": {"b": rng.standard_normal(5).astype(np.float32)}}
    if bf16_leaf:
        t["n"]["c"] = np.asarray(jnp.asarray(
            rng.standard_normal((3, 3)), jnp.bfloat16).astype(jnp.float32))
    return t


def _r_tree(t):
    out = {"a": jnp.asarray(t["a"]), "n": {"b": jnp.asarray(t["n"]["b"])}}
    if "c" in t["n"]:
        out["n"]["c"] = jnp.asarray(t["n"]["c"], jnp.bfloat16)
    return out


def _t_tree(t):
    out = {"a": torch.from_numpy(t["a"].copy()),
           "n": {"b": torch.from_numpy(t["n"]["b"].copy())}}
    if "c" in t["n"]:
        out["n"]["c"] = torch.from_numpy(t["n"]["c"].copy()).to(torch.bfloat16)
    return out


@pytest.mark.parametrize("compress", [True, False])
def test_adamw_matches_over_steps_with_warmup_and_clip(compress):
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8, clip_norm=2.0,
               compress_grads=compress)
    rcfg, tcfg = RO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    start = _tree(rng)
    rp, tp = _r_tree(start), _t_tree(start)
    rs, ts = RO.init_opt_state(rp), TO.init_opt_state(tp)
    update = jax.jit(lambda p, g, s: RO.adamw_update(rcfg, p, g, s))
    clipped = 0
    for step in range(8):
        g = _tree(rng)
        scale = 3.0 if step % 2 else 0.1   # every other step is clipped
        g = jax.tree.map(lambda x: x * scale, g)
        rp, rs, rm = update(rp, _r_tree(g), rs)
        tp, ts, tm = TO.adamw_update(tcfg, tp, _t_tree(g), ts)
        clipped += float(rm["grad_norm"]) > 2.0
        assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= \
            GRAD_TOL * float(rm["grad_norm"])
        assert tm["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert ts.step == int(rs.step) == step + 1
        for path, a in jax.tree_util.tree_flatten_with_path(rp)[0]:
            node = tp
            for p in path:
                node = node[p.key]
            assert node.dtype == {jnp.float32: torch.float32,
                                  jnp.bfloat16: torch.bfloat16}[a.dtype.type]
            tol = 2e-2 if a.dtype == jnp.bfloat16 else GRAD_TOL
            assert err(node, a) <= tol, (step, path)
        assert err(ts.m["a"], rs.m["a"]) <= GRAD_TOL
        assert err(ts.v["n"]["b"], rs.v["n"]["b"]) <= GRAD_TOL
    assert 0 < clipped < 8
    # the reference's state carried across continues where it stopped
    carried = TO.opt_state_from_numpy(jax.tree.map(np.asarray, rs), "cpu")
    assert carried.step == ts.step and carried.m["n"]["c"].dtype == \
        torch.float32
    for a, b in zip(jax.tree.leaves(carried.v), jax.tree.leaves(ts.v)):
        assert err(a, b) <= GRAD_TOL


def test_lr_schedule_matches():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        want = float(RO.lr_schedule(RO.AdamWConfig(**cfg), jnp.int32(step)))
        assert TO.lr_schedule(TO.AdamWConfig(**cfg), step) == \
            pytest.approx(want, rel=1e-6)


def test_grad_accum_matches_the_reference_and_the_full_batch():
    rc = small_cfg()
    tc = t_cfg(rc)
    rp, tp = both_params(rc)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 64, (4, 8)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    ocfg = dict(lr=1e-2, warmup_steps=1)
    rules = r_rules()
    rstep = jax.jit(RO.make_grad_accum_step(
        lambda p, b: RT.lm_loss(p, b, rc, rules), RO.AdamWConfig(**ocfg), 2))
    rp2, _, rm = rstep(rp, RO.init_opt_state(rp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = TO.make_grad_accum_step(
        lambda p, b: TT.lm_loss(p, b, tc, t_rules()), TO.AdamWConfig(**ocfg), 2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp2, _, tm = tstep(tp, TO.init_opt_state(tp), tb)
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= GRAD_TOL
    assert abs(float(tm["grad_norm"]) - float(rm["grad_norm"])) <= GRAD_TOL
    assert err(tp2["layers"]["wq"], rp2["layers"]["wq"]) <= GRAD_TOL
    # one microbatch of all four rows: the same mean-loss gradient
    _, full = TO.loss_and_grads(
        lambda p, b: TT.lm_loss(p, b, tc, t_rules()),
        TT.params_from_numpy(jax.tree.map(np.asarray, rp), tc, "cpu"), tb)
    _, accum = TO.loss_and_grads(
        lambda p, b: sum(TT.lm_loss(p, {k: v[i:i + 2] for k, v in b.items()},
                                    tc, t_rules()) for i in (0, 2)) / 2,
        TT.params_from_numpy(jax.tree.map(np.asarray, rp), tc, "cpu"), tb)
    assert err(full["embed"], accum["embed"]) <= 1e-6


def test_data_stream_matches_batch_for_batch():
    for seed, start in ((0, 0), (7, 5)):
        cfg = dict(vocab=97, batch=3, seq_len=11, seed=seed)
        r = RD.SyntheticLMStream(RD.LMDataConfig(**cfg), step=start)
        t = TD.SyntheticLMStream(TD.LMDataConfig(**cfg), step=start)
        for _ in range(4):
            a, b = r.next_batch(), t.next_batch()
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        assert t.state_dict() == r.state_dict() == {"step": start + 4}
    loader = TD.PrefetchLoader(TD.SyntheticLMStream(TD.LMDataConfig(**cfg)))
    try:
        first = loader.next()
    finally:
        loader.close()
    ref = RD.SyntheticLMStream(RD.LMDataConfig(**cfg)).next_batch()
    assert np.array_equal(first["tokens"], ref["tokens"])


def _r_trainer(rc, steps):
    rules = r_rules()
    rp = r_params(rc)
    ocfg = RO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)

    def step_fn(params, opt_state, batch):
        loss, grads = jax.value_and_grad(RT.lm_loss)(params, batch, rc, rules)
        params, opt_state, metrics = RO.adamw_update(ocfg, params, grads,
                                                     opt_state)
        return params, opt_state, {"loss": loss, **metrics}

    stream = RD.SyntheticLMStream(RD.LMDataConfig(vocab=64, batch=4,
                                                  seq_len=16))
    return rp, RLoop.Trainer(
        jax.jit(step_fn), rp, RO.init_opt_state(rp), stream,
        RLoop.TrainLoopConfig(total_steps=steps, log_every=1),
        to_batch=lambda b: {k: jnp.asarray(v) for k, v in b.items()})


def _t_trainer(tc, params, steps, ckpt_dir=None, ckpt_every=50):
    ocfg = TO.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps)
    stream = TD.SyntheticLMStream(TD.LMDataConfig(vocab=64, batch=4,
                                                  seq_len=16))
    return TLoop.Trainer(
        lm_train_step(tc, t_rules(), ocfg), params, TO.init_opt_state(params),
        stream,
        TLoop.TrainLoopConfig(total_steps=steps, log_every=1,
                              ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
        to_batch=lambda b: {k: torch.from_numpy(v) for k, v in b.items()})


def test_trainer_loss_trajectory_matches():
    rc = small_cfg()
    rp, rtr = _r_trainer(rc, 6)
    tc = t_cfg(rc)
    ttr = _t_trainer(tc, TT.params_from_numpy(jax.tree.map(np.asarray, rp),
                                              tc, "cpu"), 6)
    want = [h["loss"] for h in rtr.run()["history"]]
    got = [h["loss"] for h in ttr.run()["history"]]
    assert len(got) == len(want) == 6
    assert np.max(np.abs(np.array(got) - np.array(want))) <= GRAD_TOL
    assert got[-1] < got[0]


# -- the port's own fault tolerance -------------------------------------------


def _params(tc, seed=0):
    return TT.init_params(tc, seed, device="cpu")


def test_resume_is_exact(tmp_path):
    tc = t_cfg(small_cfg())
    whole = _t_trainer(tc, _params(tc), 6)
    whole.run()
    first = _t_trainer(tc, _params(tc), 6, ckpt_dir=str(tmp_path),
                       ckpt_every=3)
    first.run(3)
    assert C.latest_step(tmp_path) == 3
    again = _t_trainer(tc, _params(tc, seed=9), 6, ckpt_dir=str(tmp_path),
                       ckpt_every=3)
    assert again.try_resume() and again.step == 3
    assert again.stream.state_dict() == {"step": 3}
    again.run()
    for name, w in whole.params["layers"].items():
        assert torch.equal(w, again.params["layers"][name]), name
    assert torch.equal(whole.opt_state.v["embed"], again.opt_state.v["embed"])
    assert again.opt_state.step == 6 and C.latest_step(tmp_path) == 6


def test_checkpoint_restores_bf16_bit_for_bit(tmp_path):
    tc = dataclasses.replace(t_cfg(small_cfg()), dtype=torch.bfloat16)
    params = _params(tc)
    state = TO.init_opt_state(params)
    state.m["embed"].normal_()
    C.save(tmp_path, 7, {"params": params, "opt_state": state},
           extra={"data_state": {"step": 7}})
    meta = json.loads((tmp_path / "ckpt_7.json").read_text())
    assert "params/layers/wq" in meta["keys"]
    assert "opt_state/step" in meta["keys"] and "opt_state/m/embed" in meta["keys"]
    assert "params/embed" in meta["bfloat16"]
    like = {"params": _params(tc, seed=5),
            "opt_state": TO.init_opt_state(_params(tc, seed=5))}
    tree, step, extra = C.restore(tmp_path, like)
    assert step == 7 and extra == {"data_state": {"step": 7}}
    assert tree["opt_state"].step == 0 and isinstance(tree["opt_state"].step,
                                                      int)
    for name, w in params["layers"].items():
        got = tree["params"]["layers"][name]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), w.view(torch.int16))
    assert torch.equal(tree["opt_state"].m["embed"], state.m["embed"])


def test_restore_refuses_a_shape_mismatch_and_a_missing_key(tmp_path):
    tc = t_cfg(small_cfg())
    C.save(tmp_path, 1, {"params": _params(tc)})
    wide = t_cfg(small_cfg(d_model=48))
    with pytest.raises(ValueError, match="params/embed: shape"):
        C.restore(tmp_path, {"params": _params(wide)})
    with pytest.raises(KeyError, match="checkpoint missing"):
        C.restore(tmp_path, {"params": _params(tc), "extra": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        C.restore(tmp_path / "empty", {"params": _params(tc)})


def test_latest_step_and_prune(tmp_path):
    for s in (1, 2, 3, 4):
        C.save(tmp_path, s, {"x": torch.full((2,), float(s))})
    (tmp_path / "ckpt_9.npz").write_bytes(b"")   # no metadata: incomplete
    assert C.latest_step(tmp_path) == 4
    C.prune(tmp_path, keep=2)
    left = sorted(p.name for p in tmp_path.glob("ckpt_*.npz"))
    assert left == ["ckpt_4.npz", "ckpt_9.npz"]
    assert C.latest_step(tmp_path / "none") is None
    ck = C.AsyncCheckpointer(tmp_path / "async", keep=1)
    x = {"x": torch.zeros(3)}
    ck.save(5, x)
    x["x"] += 1             # the snapshot was taken at save()
    ck.save(6, x)
    ck.wait()
    tree, step, _ = C.restore(tmp_path / "async", {"x": torch.ones(3)})
    assert step == 6 and torch.equal(tree["x"], torch.ones(3))
    assert C.latest_step(tmp_path / "async") == 6
    assert not (tmp_path / "async" / "ckpt_5.npz").exists()


def test_watchdog_and_replan_match_the_reference():
    times = [1.0] * 8 + [5.0] + [1.0] * 3 + [1.02, 9.0]
    r, t = REl.StepWatchdog(), TEl.StepWatchdog()
    assert [t.observe(x) for x in times] == [r.observe(x) for x in times]
    assert t.events == r.events and len(t.events) == 2
    for n, mp in ((512, 16), (496, 16), (17, 16)):
        assert TEl.replan_mesh(n, mp) == REl.replan_mesh(n, mp)
    with pytest.raises(ValueError, match="cannot fit"):
        TEl.replan_mesh(8, 16)
    plan = TEl.ElasticPlan.on_failure(512, 16, 16)
    assert dataclasses.asdict(plan) == dataclasses.asdict(
        REl.ElasticPlan.on_failure(512, 16, 16))
    assert plan.mesh_shape == (31, 16)


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, monkeypatch, capsys):
    argv = ["train", "--arch", "internlm2-1.8b", "--steps", "4", "--batch",
            "2", "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "2", "--device", "cpu"]
    monkeypatch.setattr("sys.argv", argv)
    launch_train.main()
    out = capsys.readouterr().out
    assert "final loss" in out and C.latest_step(tmp_path) == 4
    monkeypatch.setattr("sys.argv", argv[:4] + ["6"] + argv[5:] + ["--resume"])
    launch_train.main()
    assert "resumed from step 4" in capsys.readouterr().out
    assert C.latest_step(tmp_path) == 6
    with pytest.raises(KeyError, match="Queue 1 item 5"):
        get_arch("pna")
