"""End-to-end training on ``repro_torch``: train the "lm-100m" widening
of a reduced LM (50.35 M parameters with qwen1.5-4b's recipe) for a few
hundred steps on ``--device``, with checkpoints + auto-resume.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200

(Equivalent to `python -m repro_torch.launch.train --arch gemma2-2b
--reduced`; this script widens the model and shows the loss curve.)
A rerun on the same ``--workdir`` with more ``--steps`` resumes from
the last checkpoint.  ``examples/train_lm.py``
is the same script on the JAX package.
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import TokenStream, make_batch_iterator
from repro_torch.kernels.backend import resolve_device
from repro_torch.train import Trainer, TrainerConfig


def build_config(arch: str):
    """The "lm-100m" config: ``arch``'s reduced config, widened."""
    return dataclasses.replace(
        reduced(get_config(arch)),
        name="lm-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab=32_768,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # no card: refuse now

    cfg = build_config(args.arch)
    shape = ShapeSpec("train", "train", seq_len=256, global_batch=8)
    stream = TokenStream(cfg.vocab, shape.global_batch, shape.seq_len, seed=0)
    data = make_batch_iterator(stream)
    tcfg = TrainerConfig(workdir=args.workdir, num_steps=args.steps,
                         save_every=50, log_every=10, lr=3e-4)
    trainer = Trainer(cfg, shape, tcfg, data, data_state=stream.state,
                      device=device)
    result = trainer.train()
    print("done:", result)
    print(f"metrics: {args.workdir}/metrics.jsonl")
    return result


if __name__ == "__main__":
    main()
