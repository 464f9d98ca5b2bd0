"""Batched serving example on ``repro_torch``: prefill + decode over a
request queue with slot-based batching (reduced config on ``--device``).

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

``examples/serve_lm.py`` is the same example on the JAX package.  Its
parameters come from ``jax.random.PRNGKey(0)`` and these from a
``torch.Generator`` seeded 0 on the device, so the served tokens differ;
the same parameters give the same tokens (``serve``).
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import lm
from repro_torch.serving import BatchServer, Request


def serve(cfg, params, device):
    """Serve the example's 10 requests (12 new tokens each) with 4 slots
    and ``max_len`` 96; returns the finished requests and the seconds
    ``serve`` took."""
    server = BatchServer(cfg, params, batch_slots=4, max_len=96,
                         device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, 8 + i % 5),
                    max_new_tokens=12)
            for i in range(10)]
    t0 = time.time()
    done = server.serve(reqs)
    return done, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced(ARCHS["qwen1.5-4b"])
    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=device)
    done, dt = serve(cfg, params, device)
    total_tokens = sum(len(r.output) for r in done)
    for r in done[:4]:
        print(f"req {r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
    print(f"\n{len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s on "
          f"{device.type.upper()})")
    return done, dt


if __name__ == "__main__":
    main()
