"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --device cpu --steps 200 --workdir /tmp/run1

``--reduced`` trains the CPU-sized config of the same family; without
it the full config trains at ``--batch`` x ``--seq-len`` on one card
(where the reference launches its production pod).  ``--device``
defaults to the card.  A rerun on the same ``--workdir`` resumes from
its latest checkpoint, on whatever mesh or device the rerun has.

``--mesh host`` trains on a ("data", "model") host mesh, one process
per device and ``--model`` devices on the "model" axis, as the
reference's launcher trains on its host mesh (the production plan has
no devices here, so the full config too trains across the cards
present):

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --mesh host \
      --model 2 --arch qwen1.5-4b --reduced --steps 20

(``--device cpu`` makes each process a gloo rank on the CPU.)  Rank 0
alone prints ``final:`` and writes ``metrics.jsonl`` and checkpoints.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..configs import ARCHS, get_config, reduced
from ..configs.base import ModelConfig, ShapeSpec
from ..data import TokenStream, make_batch_iterator
from ..train import Trainer, TrainerConfig
from .mesh import make_host_mesh


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
    ap.add_argument("--mesh", choices=["none", "host"], default="none",
                    help="host: a mesh of one device per process "
                    "(launch under torch.distributed.run)")
    ap.add_argument("--model", type=int, default=1,
                    help="size of the host mesh's \"model\" axis")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, cfg: Optional[ModelConfig] = None
          ) -> Tuple[Trainer, TokenStream]:
    """The trainer and its token stream for parsed ``args``; ``cfg``, where
    given, is trained in place of the config that ``args`` name."""
    if cfg is None:
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
    where = ({"mesh": make_host_mesh(model=args.model, device=args.device)}
             if args.mesh == "host" else {"device": args.device})
    trainer = Trainer(cfg, shape, tcfg, make_batch_iterator(stream, extra),
                      data_state=stream.state, **where)
    return trainer, stream


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    own_group = args.mesh == "host" and not dist.is_initialized()
    try:
        trainer, _ = build(args)
        result = trainer.train(seed=args.seed)
        if trainer.is_writer:
            print("final:", result)
    finally:
        if own_group and dist.is_initialized():   # the mesh started it
            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
