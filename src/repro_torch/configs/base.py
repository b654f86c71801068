"""Common machinery for architecture specs and dry-run cells.

The port of ``repro.configs.base``.  Where the reference hands
``jax.ShapeDtypeStruct``s with shardings to ``jax.jit(...).lower``, a
:class:`LoweredSpec` here holds meta-device tensors, each carrying its
rules spec, and the dry run (``launch/dryrun.py``) runs the step on the
meta device: every kernel wrapper returns its outputs' shapes there and
launches nothing.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.dist.sharding import ShardingRules, Spec
from repro_torch.roofline.analysis import StepCost
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         loss_and_grads)


@dataclasses.dataclass
class ShapeCell:
    """One (arch x input-shape) dry-run unit."""

    name: str
    kind: str                      # train | prefill | decode | serve | retrieval
    desc: str
    skip_reason: Optional[str] = None  # e.g. long_500k on full-attention archs
    beyond_assignment: bool = False    # extra cells we run anyway


@dataclasses.dataclass
class LoweredSpec:
    """A step and its inputs, as the dry run and the card take them.

    ``args`` are meta tensors of the GLOBAL shapes, each with a ``spec``
    attribute (its per-dimension mesh axes; :func:`meta`).
    ``per_device`` says what ``fn`` takes: each device's block of every
    arg (the program one device runs, the reference's ``shard_map``), or,
    when False, the global arrays (its ``pjit``); on a 1x1 mesh the two
    are the same.  The reference's ``donate_argnums`` has no counterpart:
    it names XLA buffers a jitted call may reuse, and PyTorch runs eagerly
    on buffers the caller owns.
    """

    fn: Callable
    args: Tuple[torch.Tensor, ...]
    per_device: bool = False
    static_desc: str = ""

    def call_args(self, rules: ShardingRules) -> Tuple[torch.Tensor, ...]:
        """Meta tensors of the shapes ``fn`` takes on one device."""
        if not self.per_device:
            return self.args
        return tuple(meta(rules.block_shape(a.shape, a.spec), a.dtype, a.spec)
                     for a in self.args)


def meta(shape: Tuple[int, ...], dtype: torch.dtype, spec: Spec) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` laid out by ``spec`` (its
    ``spec`` attribute): the reference's ``with_sharding`` of a
    ShapeDtypeStruct."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    t.spec = tuple(spec)
    return t


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a tree of dicts and lists, in the order
    ``torch.utils._pytree`` flattens it; anything else (a tensor, a spec
    tuple) is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def train_step_fn(loss_fn: Callable, ocfg: AdamWConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of ``loss_fn(params, batch)`` and one AdamW update (in
    place), the reference's ``train_step``."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(loss_fn, params, batch)
        params, opt_state, metrics = adamw_update(ocfg, params, grads,
                                                  opt_state)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def train_spec(loss_fn: Callable, params: Any, specs: Any,
               batch: Dict[str, torch.Tensor], desc: str) -> LoweredSpec:
    """A cell's train step over meta params (``params``, laid out by the
    matching tree ``specs``) and a meta ``batch`` (each tensor with its
    ``spec``): ``args`` are the params', m's and v's leaves, then the
    batch's tensors; the step returns the three sets of leaves updated,
    the loss and the gradient norm."""
    leaves, tdef = pytree.tree_flatten(params)
    p = [meta(t.shape, t.dtype, sp)
         for t, (_, sp) in zip(leaves, named_leaves(specs))]
    moments = [meta(t.shape, torch.float32, t.spec) for t in p * 2]
    names = list(batch)
    n = len(p)
    step = train_step_fn(loss_fn, AdamWConfig())

    def fn(*args):
        def tree(part):
            return pytree.tree_unflatten(list(part), tdef)

        opt = OptState(0, tree(args[n:2 * n]), tree(args[2 * n:3 * n]))
        new_p, opt, metrics = step(tree(args[:n]), opt,
                                   dict(zip(names, args[3 * n:])))
        return (*pytree.tree_leaves(new_p), *pytree.tree_leaves(opt.m),
                *pytree.tree_leaves(opt.v), metrics["loss"],
                metrics["grad_norm"])

    return LoweredSpec(fn=fn, args=tuple(p + moments + list(batch.values())),
                       static_desc=desc)


class ArchSpec(abc.ABC):
    """One selectable architecture (``--arch``)."""

    arch_id: str
    family: str                    # lm | gnn | recsys | retrieval
    source: str                    # public-literature citation

    @abc.abstractmethod
    def cells(self) -> Dict[str, ShapeCell]:
        ...

    @abc.abstractmethod
    def build(self, shape: str, mesh: Any, rules: ShardingRules) -> LoweredSpec:
        """Build the step and its meta inputs for a cell."""

    @abc.abstractmethod
    def smoke_run(self) -> Dict[str, Any]:
        """Reduced-config forward/train step; returns diagnostics (loss,
        shapes) for the per-arch smoke tests.  The LM and flexvec archs'
        run on the CPU; the GNN and recsys archs' take ``device=`` (the
        card by default), which ``launch/train.py`` passes."""

    @abc.abstractmethod
    def step_cost(self, shape: str, rules: ShardingRules) -> StepCost:
        """One device's count of the cell's step: each kernel's work, the
        collectives' bytes and the intermediates' bytes.  The port has no
        compiler to count them; the dry run's roofline reads this."""

    def cost_corrections(self, shape: str, chips: int) -> Tuple[float, float]:
        """Work the reference adds to XLA's count by hand (flops, bytes a
        device); none unless an architecture says so."""
        return 0.0, 0.0

    def model_flops(self, shape: str) -> Optional[float]:
        """Analytic useful-work FLOPs for the cell (6ND convention for LM
        training, 2ND for forward-only; analytic op counts elsewhere).
        Used for the roofline's MODEL_FLOPS / FLOPs ratio."""
        return None
