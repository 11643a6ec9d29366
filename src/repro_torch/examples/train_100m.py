"""End-to-end training driver: a ~100M-parameter dense LM on the synthetic
pipeline for a few hundred steps with checkpoint/restart (the JAX
package's ``examples/train_100m.py``).

The default config is sized down (~14M) so the example finishes in minutes
on the CPU; pass ``--full-100m`` for the real 100M run (same code path).

  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200]
      [--full-100m] [--device cuda|cpu]
"""
import argparse
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.training.data import SyntheticLMData
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import Trainer


def make_cfg(full: bool) -> ModelConfig:
    if full:  # ~100M params
        return ModelConfig(name="lm-100m", family="dense", num_layers=12,
                           d_model=768, num_heads=12, num_kv_heads=12,
                           d_ff=2048, vocab_size=8192, dtype="float32",
                           max_seq_len=512)
    return ModelConfig(name="lm-14m", family="dense", num_layers=6,
                       d_model=384, num_heads=6, num_kv_heads=6,
                       d_ff=1024, vocab_size=4096, dtype="float32",
                       max_seq_len=256)


def make_trainer(cfg, batch: int, seq: int, checkpoint_dir: str,
                 device="cuda") -> Trainer:
    """The example's data, AdamW(6e-4, warmup 50) and a checkpoint every
    50 steps."""
    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=0)
    return Trainer(cfg, data, AdamWConfig(lr=6e-4, warmup_steps=50),
                   checkpoint_dir=checkpoint_dir, checkpoint_every=50,
                   device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.full_100m)
    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="train100m_")
    trainer = make_trainer(cfg, args.batch, args.seq, ckpt, args.device)
    print(f"model {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params; "
          f"resuming from step {trainer.step}; checkpoints -> {ckpt}")
    hist = trainer.run(args.steps, log_every=10)
    print(f"loss: {hist[0]:.3f} -> {hist[-1]:.3f} "
          f"(rerun the same command to resume from the last checkpoint)")
    return hist


if __name__ == "__main__":
    main()
