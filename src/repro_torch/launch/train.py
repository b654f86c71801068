"""Training launcher: ``--arch`` selects an assigned architecture.

The port of ``repro.launch.train``.  The LM architectures train their
reduced (smoke) config by default and their published config with
``--full``; real steps, checkpoints and resume, on the card unless
``--device cpu`` asks for the CPU.  The GNN and recsys architectures are
not ported yet: ``get_arch`` raises for them (ROADMAP Queue 1 item 5).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --steps 50 [--ckpt-dir DIR] [--resume] [--full] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ASSIGNED, get_arch
from repro_torch.configs.lm import lm_train_step
from repro_torch.dist.sharding import default_rules
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.loop import TrainLoopConfig, Trainer
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def lm_trainer(arch, args, rules) -> Trainer:
    """A :class:`Trainer` of ``arch``'s smoke config (its published one
    with ``args.full``) on ``args.device``: seeded params, AdamW with ten
    warmup steps, the synthetic token stream."""
    from repro_torch.data.loader import LMDataConfig, SyntheticLMStream
    from repro_torch.models import transformer as T

    cfg = arch.smoke_cfg if not args.full else arch.cfg
    params = T.init_params(cfg, args.seed, device=args.device)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    stream = SyntheticLMStream(
        LMDataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq))
    dev = torch.device(args.device)
    return Trainer(
        lm_train_step(cfg, rules, ocfg), params, init_opt_state(params),
        stream,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        log_every=max(1, args.steps // 10),
                        ckpt_dir=args.ckpt_dir),
        to_batch=lambda b: {k: torch.from_numpy(v).to(dev)
                            for k, v in b.items()},
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ASSIGNED)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the full published config (the card's scale)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    arch = get_arch(args.arch)
    rules = default_rules(make_local_mesh(args.device))
    trainer = lm_trainer(arch, args, rules)
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  "
              f"{h['sec_per_step']*1e3:7.1f} ms")
    print(f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
