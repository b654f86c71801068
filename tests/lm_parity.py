"""Shared helpers of the LM parity tests (``tests/test_torch_lm*.py``,
``test_torch_train.py``): the reference's 1x1 mesh with Auto axes (jax >=
0.5's ``make_mesh`` defaults to Explicit axes, which the reference's
``with_sharding_constraint`` refuses), the port's config of a reference
config, and the reference's params carried across by ``params_from_numpy``.
Reference calls are jitted: one compile a function instead of one an op.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.dist.sharding import default_rules as r_default_rules
from repro.models import layers as RLy
from repro_torch.dist.sharding import AbstractMesh
from repro_torch.dist.sharding import default_rules as t_default_rules
from repro_torch.models import layers as TLy
from repro_torch.models import transformer as TT

TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def r_rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return r_default_rules(mesh)


def t_rules():
    return t_default_rules(AbstractMesh((1, 1), ("data", "model")))


def t_cfg(rcfg, **changes):
    """The port's LMConfig with the reference config's fields."""
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(TLy.LMConfig)
          if f.name not in ("dtype", "moe")}
    kw["dtype"] = {jnp.float32: torch.float32,
                   jnp.bfloat16: torch.bfloat16}[rcfg.dtype]
    if rcfg.moe is not None:
        kw["moe"] = TLy.MoEConfig(**dataclasses.asdict(rcfg.moe))
    kw.update(changes)
    return TLy.LMConfig(**kw)


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), tree)


@functools.lru_cache(maxsize=None)
def r_params(rcfg, seed=0):
    """Seeded params in the reference's tree and shapes (as
    ``RT.init_params`` makes them; ``test_torch_lm.py`` checks the shapes)
    and in its dtype: matrices N(0, 0.02^2), norms 1 + N(0, 0.1^2), drawn
    with numpy instead of ``jax.random``, which costs a compile a config."""
    rng = np.random.default_rng(seed)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else jnp.asarray(
            (1.0 + 0.1 * rng.standard_normal(v)) if k.endswith("norm")
            else 0.02 * rng.standard_normal(v), rcfg.dtype)
            for k, v in tree.items()}

    return draw(TT.param_shapes(t_cfg(rcfg)))


def both_params(rcfg, seed=0):
    """The reference's params and the port's copy of them."""
    rp = r_params(rcfg, seed)
    return rp, TT.params_from_numpy(np_tree(rp), t_cfg(rcfg), "cpu")


def f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().to(torch.float32).numpy()


def err(a, b):
    return float(np.max(np.abs(f32(a) - f32(b))))


def small_cfg(**kw):
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=48, vocab=64, dtype=jnp.float32, q_chunk=8,
                remat=False)
    base.update(kw)
    return RLy.LMConfig(**base)


