"""Logical-axis sharding rules.

The port of ``repro.dist.sharding``.  Config code names LOGICAL axes
("batch", "heads", "corpus", ...); a :class:`ShardingRules` maps each
logical axis to zero or more MESH axes.  The same config code then runs
unchanged on a 1x1 local mesh (one card, or the CPU when asked), the
16x16 single-pod mesh or the 2x16x16 multi-pod mesh: only the rules
change.  Specs are derived, never written inline at call sites.

A mesh is one of two things here:

* a ``torch.distributed.device_mesh.DeviceMesh`` where the devices exist
  (the ranks of an initialised process group, one card each): its axes
  carry process groups, and :meth:`ShardingRules.group` hands the one a
  logical axis shards over to the collectives;
* an :class:`AbstractMesh`, axis names and sizes with no devices, for the
  production layouts that no one machine has (the dry run's meshes).

Vocabulary (every logical axis any spec in the tree may name):

    batch, seq, stack, embed, act_embed, heads, kv_heads, ff, moe_ff,
    expert, vocab            — LM family (FSDP x TP layout)
    nodes, edges             — GNN row sharding
    candidates, table_rows   — recsys corpus / embedding tables
    corpus                   — flexvec retrieval row sharding

``constrain`` is the reference's ``with_sharding_constraint`` by logical
names.  The reference runs its LM on a 1x1 mesh only (the trainer, the
decode engine) and only lowers it on the production meshes, so the port's
``constrain`` checks the names and places nothing.

What is placed are params: :func:`place_rows` lays a param tree out by
its spec tree over a list of devices standing for the mesh's 'model'
axis, each leaf whose rows name 'model' (a recsys table's 'table_rows')
as a :class:`RowShardedTable` of contiguous row blocks, every other leaf
whole on the lead device.  That is how XLA holds the reference's tables
given several devices; the lookup that reads such a table is
``models/recsys.embedding_lookup``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

# A logical axis maps to: no mesh axis (replicate), one mesh axis, or a
# tuple of mesh axes (the dim is divided over their product, major-first).
MeshAxes = Union[None, str, Tuple[str, ...]]
# The per-dimension mesh axes of a tensor: the content of a JAX
# PartitionSpec, as a tuple.
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh by its axis sizes and names alone (the argument order of
    ``jax.sharding.AbstractMesh``): no devices, no process groups."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _as_tuple(axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mesh + {logical axis -> mesh axes} mapping."""

    mesh: Any   # AbstractMesh or torch.distributed.device_mesh.DeviceMesh
    rules: Dict[str, MeshAxes]

    # -- lookup ------------------------------------------------------------

    def _axes(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        if name not in self.rules:
            raise KeyError(
                f"unknown logical axis {name!r}; known: {sorted(self.rules)}"
            )
        return self.rules[name]

    def spec(self, *names: Optional[str]) -> Spec:
        """Per-dimension mesh axes of a tensor whose dims carry these
        logical names (what the reference's PartitionSpec holds).

        ``spec()`` (no args) is fully replicated; ``None`` entries are
        replicated dims.  Passing ``if_divisible(...)`` results is the
        idiomatic divisibility-guarded form.
        """
        return tuple(self._axes(n) for n in names)

    def size_of(self, name: Optional[str]) -> int:
        """Number of shards the logical axis is divided into (1 = replicated)."""
        shape = mesh_shape(self.mesh)
        size = 1
        for a in _as_tuple(self._axes(name)):
            size *= shape[a]
        return size

    def if_divisible(self, name: str, dim: int) -> Optional[str]:
        """``name`` if ``dim`` splits evenly over its mesh axes, else None.

        Input shardings require exact divisibility (e.g. a 49155-row vocab
        cannot shard over 16 — it replicates instead).
        """
        return name if dim % self.size_of(name) == 0 else None

    def block_shape(self, shape: Tuple[int, ...], spec: Spec) -> Tuple[int, ...]:
        """The shape of one device's block of a tensor laid out by ``spec``:
        each dim divided by the product of its mesh axes' sizes (which must
        divide it)."""
        sizes = mesh_shape(self.mesh)
        out = []
        for dim, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
            parts = 1
            for a in _as_tuple(axes):
                parts *= sizes[a]
            if dim % parts:
                raise ValueError(f"dim {dim} does not split over {axes} "
                                 f"({parts} shards)")
            out.append(dim // parts)
        return tuple(out)

    def group(self, name: str):
        """The process group the logical axis shards over: on a
        ``DeviceMesh``, the group of its mesh axis (of the one larger than
        1 where it names several); None on an :class:`AbstractMesh`, where
        a step runs as one rank."""
        if isinstance(self.mesh, AbstractMesh):
            return None
        sizes = mesh_shape(self.mesh)
        axes = _as_tuple(self._axes(name))
        wide = [a for a in axes if sizes[a] > 1] or list(axes[:1])
        if len(wide) != 1:
            raise NotImplementedError(
                f"{name!r} maps to mesh axes {axes}: the port shards it over "
                f"the process group of exactly one of them")
        return self.mesh.get_group(wide[0])


def constrain(x: Any, rules: ShardingRules, *names: Optional[str]) -> Any:
    """The reference's logical-name sharding constraint: every name must be
    one of the rules' logical axes (an unknown one raises ``KeyError``, as
    :meth:`ShardingRules.spec` does), and ``x`` comes back unchanged.  An
    activation stays where it is computed: the port's LM runs on one
    device, the dry run counts collectives from the rules
    (``configs/lm.py``), and what is placed over devices is a recsys
    model's tables (:func:`place_rows`), whose lookups bring their rows
    to the lead device."""
    rules.spec(*names)
    return x


# -- placement: params over the devices of the 'model' axis -------------------


@dataclasses.dataclass(eq=False)
class RowShardedTable:
    """A (V, D) table held as S contiguous row blocks: block ``s``, rows
    ``s * block`` to ``(s + 1) * block``, on ``blocks[s].device`` (several
    blocks may share a device).  ``routed[s]`` counts the ids looked up
    in block ``s`` since the caller last zeroed it."""

    blocks: List[torch.Tensor]
    shape: Tuple[int, int]
    block: int
    dtype: torch.dtype
    routed: List[int] = dataclasses.field(init=False)

    def __post_init__(self):
        self.routed = [0] * len(self.blocks)

    @property
    def n_shards(self) -> int:
        return len(self.blocks)


def place_leaf(t: torch.Tensor, spec: Spec, devices: Sequence[Any],
               name: str = "") -> Any:
    """One param placed by its spec over ``devices`` (S of them, standing
    for the mesh's 'model' axis; the first is the lead): rows that name
    'model' split into S contiguous blocks, a copy on each device (S must
    divide the rows), anything else a whole tensor on the lead device."""
    from repro_torch.models import check_device

    devs = [check_device(d) for d in devices]
    axes = [_as_tuple(a) for a in spec]
    if any("model" in a for a in axes[1:]):
        raise NotImplementedError(f"{name}: only rows are placed over "
                                  f"'model', spec {spec}")
    if not axes or "model" not in axes[0]:
        return t.detach().to(devs[0])
    n, s = t.shape[0], len(devs)
    if n % s:
        raise ValueError(f"{name}: {n} rows do not split into {s} row "
                         f"blocks")
    blk = n // s
    blocks = [t[j * blk:(j + 1) * blk].detach().to(d, copy=True)
              for j, d in enumerate(devs)]
    return RowShardedTable(blocks, tuple(t.shape), blk, t.dtype)


def place_rows(params: Any, specs: Any, devices: Sequence[Any]) -> Any:
    """``params`` (a tree of dicts and lists) placed leaf by leaf with
    :func:`place_leaf` by the spec tree ``specs`` of the same structure
    (a ``*_shardings`` result); a leaf that does not split names its path."""

    def walk(p, s, path):
        if isinstance(p, dict):
            return {k: walk(v, s[k], f"{path}{k}/") for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, sv, f"{path}{j}/")
                    for j, (v, sv) in enumerate(zip(p, s))]
        return place_leaf(p, s, devices, path.rstrip("/"))

    if not devices:
        raise ValueError("no devices to place on")
    return walk(params, specs, "")


def default_rules(mesh: Any) -> ShardingRules:
    """The baseline layout: FSDP over the data axes x TP over the model axis.

    On the multi-pod mesh the 'pod' axis joins the data group, so batch and
    FSDP-sharded weight dims divide over pod*data.  The corpus maps to
    'data' only (16 shards on the production mesh) — the ``corpus_all``
    variant (dist/tuned.py) spreads it over every device.
    """
    names = tuple(mesh_shape(mesh))
    data: MeshAxes = ("pod", "data") if "pod" in names else "data"
    return ShardingRules(
        mesh=mesh,
        rules={
            # LM family --------------------------------------------------
            "batch": data,        # activations: data parallel
            "seq": None,          # decode fallback remaps this (configs/lm.py)
            "stack": None,        # the scanned layer-stack dim
            "embed": data,        # weights: FSDP on d_model
            "act_embed": "model",  # activations: TP on d_model
            "heads": "model",
            "kv_heads": "model",
            "ff": "model",
            "moe_ff": None,       # pure EP+FSDP; 'serve_weights' maps to data
            "expert": "model",
            "vocab": "model",
            # GNN ---------------------------------------------------------
            "nodes": data,
            "edges": data,
            # recsys ------------------------------------------------------
            "candidates": data,
            "table_rows": "model",
            # flexvec retrieval -------------------------------------------
            "corpus": "data",
        },
    )
