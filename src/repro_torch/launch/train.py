"""Training driver of the port (twin of repro.launch.train).

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --steps 50 [--reduced] [--batch 8] [--seq 128] [--ckpt-dir ckpts] \
      [--log-every 10] [--device cuda]

Runs on the card unless ``--device cpu`` is given. Weights are seeded
(``--seed``), the data is the synthetic Markov stream, paligemma's and
whisper's modality inputs are the reference's zero stubs, and a run with
``--ckpt-dir`` resumes from the latest checkpoint there.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.training import optimizer
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.train_step import make_train_step


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> list:
    """Runs the driver on `argv` (None: sys.argv); `device` overrides
    ``--device``. Returns the losses of the steps run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} params~{cfg.total_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} device={dev}")

    params = M.init_params(cfg, args.seed, device=dev)
    opt_cfg = optimizer.AdamWConfig(lr=args.lr, warmup_steps=20,
                                    total_steps=args.steps)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, opt_cfg)

    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      batch_size=args.batch,
                                      seed=args.seed))
    start = 0
    if args.ckpt_dir and (s := ckpt.latest_step(args.ckpt_dir)) is not None:
        params, opt_state, meta = ckpt.restore(args.ckpt_dir, s, params,
                                               opt_state)
        start = meta["step"]
        print(f"resumed from step {start}")

    dt = M.param_dtype(cfg)
    # training-throughput logging: real tokens/s over real elapsed time,
    # outside the serving path and its virtual clock entirely
    t0 = time.perf_counter()          # repro: noqa[clock-discipline]
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step).items()}
        if cfg.num_image_tokens:
            batch["image_embeds"] = torch.zeros(
                (args.batch, cfg.num_image_tokens, cfg.d_model), dtype=dt,
                device=dev)
        if cfg.is_encoder_decoder:
            batch["enc_frames"] = torch.zeros(
                (args.batch, cfg.encoder_seq_len, cfg.d_model), dtype=dt,
                device=dev)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if (step + 1) % args.log_every == 0:
            rate = (step + 1 - start) * args.batch * args.seq \
                / (time.perf_counter() - t0)  # repro: noqa[clock-discipline]
            print(f"step {step+1:5d} loss {float(loss):.4f} "
                  f"({rate:.0f} tok/s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, params, opt_state)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, params, opt_state)
    if losses:
        print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
              f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
