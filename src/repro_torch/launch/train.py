"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains an architecture of ``repro_torch.configs`` on the synthetic topic
corpus through the :class:`~repro_torch.train.Trainer` (checkpoints,
auto-resume, preemption handling): text only, and for an encdec arch each
batch also carries stub encoder frames, ``RandomState(i).normal`` of shape
(batch, frames, d) for batch ``i``, as ``repro.launch.train`` makes them.
Runs on CUDA unless given ``--device cpu``; ``--reduced`` takes the small
config of the same family. The moe, vlm, ssm, hybrid and encdec train
losses are held against ``repro`` on the CPU; the dense family has trained
on the card, and the moe family at reduced depth (``chip_smoke.py`` phase
7m).
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataPipeline, TopicLMStream
from repro_torch.models import build
from repro_torch.models.model_zoo import encoder_frames
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="small config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    bundle = build(cfg, device=args.device)
    stream = TopicLMStream(vocab=cfg.vocab_size, seq_len=args.seq, batch=args.batch, seed=0)

    def batch_fn(i):
        b = {"tokens": stream.batch_at(i)}
        if cfg.family == "encdec":
            b["frames"] = np.random.RandomState(i).normal(
                size=(args.batch, encoder_frames(cfg), cfg.d_model)).astype(np.float32)
        return b

    pipe = DataPipeline(batch_fn)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps, warmup_steps=10,
                       ckpt_dir=args.ckpt_dir, ckpt_every=max(10, args.steps // 4))
    trainer = Trainer(bundle, tcfg, iter(pipe), pipeline=pipe,
                      hooks={"on_step": lambda s, m, st: (s % 10 == 0) and print(
                          f"step {s} loss={m['loss']:.3f} dt={m['dt']*1e3:.0f}ms")})
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
