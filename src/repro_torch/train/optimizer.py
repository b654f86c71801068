"""AdamW with the reference's distributed-training conveniences.

The port of ``repro.train.optimizer``:

* gradient compression: grads are cast to bf16 (what the reference puts
  on the data-parallel all-reduce) and widened to f32 for the moments
  (``compress_grads``);
* global-norm clipping over every leaf, decoupled weight decay, linear
  warmup + cosine decay, the learning rate of the step before the
  increment and the bias correction of the step after it.

Params, ``m`` and ``v`` are updated in place, one tensor at a time, so a
full-width step holds f32 temporaries of one tensor, never an f32 copy
of every gradient.  ``OptState.step`` is a host integer: the learning
rate is computed on the host in f32, as the reference computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = True   # bf16 gradients, f32 moments


class OptState(NamedTuple):
    step: int           # updates taken
    m: Params           # f32, param-shaped
    v: Params           # f32, param-shaped


def init_opt_state(params: Params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=0, m=pytree.tree_map(zeros, params),
                    v=pytree.tree_map(zeros, params))


def opt_state_from_numpy(state: Any, device: Any = "cuda") -> OptState:
    """The reference's ``OptState`` (numpy leaves) as the port's."""
    from repro_torch.models.transformer import check_device

    dev = check_device(device)

    def conv(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return OptState(step=int(state.step), m=pytree.tree_map(conv, state.m),
                    v=pytree.tree_map(conv, state.v))


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Warmup then cosine, in f32 as the reference computes it."""
    f32 = np.float32
    warm = np.minimum(f32(1.0), f32(step + 1) / f32(max(1, cfg.warmup_steps)))
    prog = np.clip(f32(step - cfg.warmup_steps)
                   / f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
    return float(f32(cfg.lr) * warm * (f32(0.1) + f32(0.9) * cos))


def _widen(cfg: AdamWConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.compress_grads:
        g = g.to(torch.bfloat16)
    return g.to(torch.float32)


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Params,
    grads: Params,
    state: OptState,
) -> Tuple[Params, OptState, Dict[str, Any]]:
    """One AdamW step over every leaf, in place; returns (params, state,
    {"grad_norm": 0-d tensor, "lr": float})."""
    p_leaves, spec = pytree.tree_flatten(params)
    g_leaves = pytree.tree_leaves(grads)
    m_leaves = pytree.tree_leaves(state.m)
    v_leaves = pytree.tree_leaves(state.v)
    if not (len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves)):
        raise ValueError("params, grads and moments differ in structure")

    sq = None
    for g in g_leaves:
        g32 = _widen(cfg, g)
        part = torch.sum(g32 * g32)
        sq = part if sq is None else sq + part
    gnorm = torch.sqrt(sq)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))

    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        g32 = _widen(cfg, g)
        if scale is not None:
            g32 = g32 * scale
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32 * (1 - b2) * g32)
        p32 = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pytree.tree_unflatten(p_leaves, spec), OptState(step, state.m,
                                                           state.v), metrics


def loss_and_grads(loss_fn: Callable, params: Params,
                   batch: Any) -> Tuple[torch.Tensor, Params]:
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss (detached)
    and the gradient of every leaf, in the params' tree and dtypes."""
    leaves, spec = pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
        # a leaf the loss does not use gets zeros, as under JAX
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_grad_accum_step(loss_fn: Callable, cfg: AdamWConfig, n_micro: int):
    """Gradient accumulation: ``n_micro`` microbatches per optimizer
    update (batch leaves carry leading dim n_micro*mb).  Exact: equal-size
    microbatches of a mean loss give the global gradient."""

    def step(params, opt_state, batch):
        micro = pytree.tree_map(
            lambda x: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:]),
            batch)
        gsum, losses = None, []
        for i in range(n_micro):
            mb = pytree.tree_map(lambda x: x[i], micro)
            loss, g = loss_and_grads(loss_fn, params, mb)
            g32 = pytree.tree_map(lambda t: t.to(torch.float32), g)
            gsum = g32 if gsum is None else pytree.tree_map(torch.add, gsum,
                                                            g32)
            losses.append(loss)
        grads = pytree.tree_map(lambda g: g / n_micro, gsum)
        params, opt_state, metrics = adamw_update(cfg, params, grads,
                                                  opt_state)
        return params, opt_state, {"loss": torch.stack(losses).mean(),
                                   **metrics}

    return step
