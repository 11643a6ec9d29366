"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cuda|cpu]`` (the JAX package's ``launch/train.py``,
same flags and defaults).

``--smoke`` trains the reduced same-family config (CPU-runnable); without
it the published config trains on one card (the production meshes are
planned, not run: ``launch/dryrun.py``). Training is checkpointed and
resumable: kill it mid-run and rerun the same command to continue from
the last checkpoint.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import model_zoo
from repro_torch.training.data import SyntheticEncDecData, SyntheticLMData
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="xlstm-350m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if model_zoo.is_encdec(cfg):
        data = SyntheticEncDecData(cfg.vocab_size, args.seq, args.batch,
                                   cfg.d_model)
    else:
        data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch)

    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={args.device}")
    trainer = Trainer(cfg, data, AdamWConfig(lr=args.lr, warmup_steps=20),
                      num_microbatches=args.microbatches,
                      checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      device=args.device)
    hist = trainer.run(args.steps)
    print(f"final loss {hist[-1]:.4f} (start {hist[0]:.4f})")
    return hist


if __name__ == "__main__":
    main()
