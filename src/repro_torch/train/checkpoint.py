"""Checkpointing: atomic, device-agnostic, async-capable.

The port of ``repro.train.checkpoint``:

* trees (dicts, tuples, the ``OptState`` NamedTuple) are flattened to
  path-keyed arrays in an .npz (``params/embed``, ``opt_state/step``,
  ``opt_state/m/layers/wq``, ...) + JSON metadata (step, data-iterator
  state);
* writes go to a temp file then ``os.replace()`` — a crash mid-save never
  corrupts the latest checkpoint;
* arrays are saved from host copies: a restart may run on another device;
  ``restore()`` places each leaf on the device of the tree it restores
  into;
* ``AsyncCheckpointer`` offloads serialization to a background thread.

numpy has no bfloat16 (and the card's machine no ``ml_dtypes``): a bf16
tensor is saved as its 16-bit patterns (``int16``) and restored bit for
bit; the metadata lists those keys.  The reference's own files, which
store bf16 through ``ml_dtypes``, are not read.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

_SEP = "/"


def _path_str(p) -> str:
    if hasattr(p, "key"):
        return str(p.key)
    if hasattr(p, "idx"):
        return f"#{p.idx}"
    if hasattr(p, "name"):
        return str(p.name)
    return str(p)


def _key(path) -> str:
    return _SEP.join(_path_str(p) for p in path)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], list]:
    """Path-keyed host arrays of every leaf, and the keys of bf16 leaves."""
    flat, bf16 = {}, []
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        key = _key(path)
        flat[key] = _host(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16.append(key)
    return flat, bf16


def save(
    ckpt_dir: str | Path,
    step: int,
    tree: Any,
    extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Atomic checkpoint write -> <dir>/ckpt_<step>.npz (+ .json)."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat, bf16 = _flatten(tree)
    tmp = ckpt_dir / f".tmp_ckpt_{step}.npz"
    final = ckpt_dir / f"ckpt_{step}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    meta = {"step": step, "extra": extra or {}, "keys": sorted(flat),
            "bfloat16": sorted(bf16)}
    tmp_meta = ckpt_dir / f".tmp_ckpt_{step}.json"
    tmp_meta.write_text(json.dumps(meta))
    os.replace(tmp, final)                       # atomic on POSIX
    os.replace(tmp_meta, ckpt_dir / f"ckpt_{step}.json")
    return final


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.glob("ckpt_*.npz"):
        m = re.match(r"ckpt_(\d+)\.npz", p.name)
        if m and (ckpt_dir / f"ckpt_{m.group(1)}.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _leaf(key: str, arr: np.ndarray, like: Any, bf16: set) -> Any:
    if not isinstance(like, torch.Tensor):
        expect = np.asarray(like)
        if arr.shape != expect.shape:
            raise ValueError(f"{key}: shape {arr.shape} != {expect.shape}")
        return arr.astype(expect.dtype).item() if expect.ndim == 0 \
            else arr.astype(expect.dtype)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                         f"{tuple(like.shape)}")
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if key in bf16:
        t = t.view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


def restore(
    ckpt_dir: str | Path,
    like: Any,
    step: Optional[int] = None,
) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure, dtypes and devices of ``like``.  A key
    the checkpoint lacks raises ``KeyError``; a shape that differs raises
    ``ValueError``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    meta = json.loads((ckpt_dir / f"ckpt_{step}.json").read_text())
    bf16 = set(meta.get("bfloat16", ()))
    paths, spec = pytree.tree_flatten_with_path(like)
    leaves = []
    with np.load(ckpt_dir / f"ckpt_{step}.npz") as data:
        for path, leaf in paths:
            key = _key(path)
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            leaves.append(_leaf(key, data[key], leaf, bf16))
    return pytree.tree_unflatten(leaves, spec), step, meta.get("extra", {})


def prune(ckpt_dir: str | Path, keep: int = 3) -> None:
    """Keep the newest `keep` checkpoints (bounded disk on long runs)."""
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(
        int(re.match(r"ckpt_(\d+)\.npz", p.name).group(1))
        for p in ckpt_dir.glob("ckpt_*.npz")
        if re.match(r"ckpt_(\d+)\.npz", p.name)
    )
    for s in steps[:-keep]:
        for suffix in (".npz", ".json"):
            try:
                (ckpt_dir / f"ckpt_{s}{suffix}").unlink()
            except FileNotFoundError:
                pass


class AsyncCheckpointer:
    """Background-thread checkpoint writer: snapshot on the caller thread
    (device -> host copy), serialize/write off-thread."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()
        host = pytree.tree_map(   # snapshot now: host copies
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else x), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host, extra)
                prune(self.ckpt_dir, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
