"""The model families: the LM (shared layers and the decoder-only
transformer), PNA (GNN) and the recsys models.

Their entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); :func:`check_device` is where a missing card raises."""

from typing import Any

import torch


def check_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the model runs on the card; pass "
                           "device='cpu' to run on the CPU")
    return dev


class Draws:
    """Seeded initial values on ``device``: one ``torch.Generator`` drawn
    from in call order, each draw in f32 and cast to ``dtype``.  On the
    meta device (the dry run's params) every draw is an empty tensor of
    its shape, so one init function gives both."""

    def __init__(self, seed: int, device: Any, dtype: torch.dtype):
        self.dev = check_device(device)
        self.dtype = dtype
        self.gen = (None if self.dev.type == "meta"
                    else torch.Generator(device=self.dev).manual_seed(seed))

    def _empty(self, shape):
        return torch.empty(shape, dtype=self.dtype, device=self.dev)

    def normal(self, shape, std: float) -> torch.Tensor:
        if self.gen is None:
            return self._empty(shape)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.dev)
        return x.mul_(std).to(self.dtype)

    def uniform(self, shape, s: float) -> torch.Tensor:
        """U(-s, s)."""
        if self.gen is None:
            return self._empty(shape)
        # in place: a two-tower item table is 8.6 GB in f32
        u = torch.rand(shape, generator=self.gen, dtype=torch.float32,
                       device=self.dev)
        return u.mul_(2 * s).sub_(s).to(self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.dev)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.dev)


def params_from_numpy(tree: Any, cfg: Any, device: Any = "cuda") -> Any:
    """The reference's params tree (numpy arrays in nested dicts and
    lists; bf16 leaves passed as f32, since bf16 -> f32 -> bf16 is exact)
    as the port's tensors in ``cfg.dtype`` on ``device``."""
    import numpy as np

    dev = check_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.tensor(np.asarray(x), dtype=cfg.dtype, device=dev)

    return conv(tree)
