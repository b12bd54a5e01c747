"""lm-100m's plain train step against ``make_train_step(mesh=1x1)`` in turns.

Both steps start from one seeded state on one batch of 8 x 512 tokens
(microbatches 2, phase 7's schedule) in a 1-rank NCCL group, in the order
plain, mesh, mesh, plain, twice; each turn runs 4 steps and keeps the
last 3 (host clock around a synchronized step). Then one step of each
under ``torch.profiler``: device ms summed over ops, and the host ops
that took longest.

    python3 tools/mesh_step_turns.py

Needs one CUDA card; builds no kernel (the train path runs none).
"""
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data import TopicLMStream  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adam_init, make_schedule  # noqa: E402
from repro_torch.train.train_step import TrainState, make_train_step  # noqa: E402


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    lmesh.init_distributed("cuda", store=tempfile.mkdtemp() + "/s", rank=0, world_size=1)
    mesh = lmesh.parse_mesh("1x1", device="cuda")
    cfg = c.lm_100m_config()
    bundle = build(cfg, device="cuda")
    p, st = bundle.init(torch.Generator(device="cuda").manual_seed(c.SEED))
    state = TrainState(p, adam_init(p), st)
    stream = TopicLMStream(vocab=cfg.vocab_size, seq_len=c.TRAIN_SEQ, batch=c.TRAIN_BATCH,
                           seed=c.SEED)
    batch = {"tokens": torch.from_numpy(stream.batch_at(0)).cuda()}
    sched = make_schedule("cosine", c.TRAIN_LR, c.TRAIN_WARMUP, c.TRAIN_STEPS)
    tcfg = TrainConfig(lr=c.TRAIN_LR, microbatches=c.MESH_TRAIN_MICRO,
                       warmup_steps=c.TRAIN_WARMUP, total_steps=c.TRAIN_STEPS)
    _, specs = sharding.shard_train_state(mesh, state)
    steps = {"plain": make_train_step(bundle, tcfg, sched),
             "mesh": make_train_step(bundle, tcfg, sched, mesh=mesh, shardings=specs)}
    out = {k: [] for k in steps}
    for name in ("plain", "mesh", "mesh", "plain", "plain", "mesh", "mesh", "plain"):
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = steps[name](state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            del new, m
            if i:
                out[name].append(1e3 * dt)
    print(c.card_line())
    print(json.dumps({k: {"median": statistics.median(v), "all": [round(x, 2) for x in v]}
                      for k, v in out.items()}))
    for name in ("plain", "mesh"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            new, m = steps[name](state, batch)
            torch.cuda.synchronize()
        del new, m
        ev = prof.key_averages()
        dev = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:6]
        print(name, "device ms", round(dev, 2),
              "top host", [(e.key, round(e.cpu_time_total / 1e3, 1)) for e in top])
    lmesh.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
