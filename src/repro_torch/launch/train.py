"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --device cpu --steps 200 --workdir /tmp/run1

``--reduced`` trains the CPU-sized config of the same family; without
it the full config trains at ``--batch`` x ``--seq-len`` on one card
(where the reference launches its production pod).  ``--device``
defaults to the card.  A rerun on the same ``--workdir`` resumes from
its latest checkpoint.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

from ..configs import ARCHS, get_config, reduced
from ..configs.base import ShapeSpec
from ..data import TokenStream, make_batch_iterator
from ..train import Trainer, TrainerConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--microbatches", type=int, default=1)
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Tuple[Trainer, TokenStream]:
    """The trainer and its token stream for parsed ``args``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeSpec("custom", "train", args.seq_len, args.batch)
    b, s = shape.global_batch, shape.seq_len
    stream = TokenStream(cfg.vocab, b, s, seed=args.seed)
    extra = {}
    if cfg.enc_dec:
        extra["enc_embeds"] = np.ones((b, s, cfg.d_model), np.float32)
    if cfg.vision_stub:
        nv = min(cfg.n_vision_tokens, s)
        extra["vision_embeds"] = np.ones((b, nv, cfg.d_model), np.float32)
        extra["positions3"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()
    tcfg = TrainerConfig(workdir=args.workdir, num_steps=args.steps,
                         save_every=args.save_every, lr=args.lr,
                         microbatches=args.microbatches)
    trainer = Trainer(cfg, shape, tcfg, make_batch_iterator(stream, extra),
                      data_state=stream.state, device=args.device)
    return trainer, stream


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    trainer, _ = build(args)
    result = trainer.train(seed=args.seed)
    print("final:", result)
    return result


if __name__ == "__main__":
    main()
