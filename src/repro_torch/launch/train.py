"""Training launcher (port of `repro.launch.train`).

Runs a config end to end with the whole training path: the synthetic data
pipeline, AdamW with global-norm clipping and the cosine schedule,
remat and microbatching as the config sets them, the fault-tolerant
checkpoint / restart loop with straggler flags, and CRAM-compressed
checkpoints in the reference's format.  The initial weights are the
reference's for `jax.random.key(--seed)` (`init_lm_reference`, and
`init_whisper` for whisper-base, which trains on the pipeline's
`frames`) and the batches the reference's for `--seed`, so a run's
losses follow the reference launcher's step by step.  The printed report has the
reference's keys.

  python -m repro_torch.launch.train --preset lm20m --steps 300 \
      --batch 8 --ckpt-every 50 --inject-fault 150
  python -m repro_torch.launch.train --device cpu --preset lm2m --steps 14 \
      --batch 2 --ckpt-every 5 --inject-fault 8 --seed 3

Runs on the card by default (`--device cuda`); `--device cpu` runs on
the CPU.  Without `--ckpt-dir` the checkpoints go to a new temporary
directory that is removed at the end, so every run starts at step 0.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from .. import configs
from ..data import DataConfig, make_batch_iterator
from ..device import resolve_device
from ..models import ModelConfig, build, count_params, smoke_config
from ..models.transformer import init_lm_reference
from ..models.whisper import init_whisper
from ..optim.adamw import adamw_init, make_train_step
from ..runtime.ft import LoopConfig, SimulatedFault, run_with_restarts

PRESETS = {
    # ~20M-param LM for the end-to-end example
    "lm20m": ModelConfig(
        name="lm20m", family="dense", n_layers=4, d_model=384, n_heads=6,
        n_kv_heads=6, head_dim=64, d_ff=1024, vocab=8192, max_seq=256,
        microbatches=1, remat=False, attn_q_chunk=128, attn_k_chunk=128,
        xent_chunk=128, dtype=torch.float32, param_dtype=torch.float32),
    "lm2m": ModelConfig(
        name="lm2m", family="dense", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=2048, max_seq=128,
        microbatches=1, remat=False, attn_q_chunk=64, attn_k_chunk=64,
        xent_chunk=64, dtype=torch.float32, param_dtype=torch.float32),
}


def build_config(args) -> ModelConfig:
    if args.preset:
        return PRESETS[args.preset]
    cfg = configs.get(configs.canonical(args.arch))
    return smoke_config(cfg) if args.smoke else cfg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", default=None, choices=[*PRESETS, None])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one, removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--codec", default="cram")
    ap.add_argument("--inject-fault", type=int, default=0,
                    help="raise a SimulatedFault once at this step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args)
    seq = args.seq or min(cfg.max_seq, 256)
    print(f"training {cfg.name}: {count_params(cfg)/1e6:.1f}M params, "
          f"batch {args.batch} x seq {seq}")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=args.batch,
                      seed=args.seed, family=cfg.family,
                      d_model=cfg.d_model,
                      n_image_tokens=cfg.n_image_tokens)
    live = {}

    init = init_whisper if cfg.family == "encdec" else init_lm_reference

    def make_state():
        live["model"] = build(cfg, device=device,
                              params=init(cfg, args.seed, device))
        return adamw_init(live["model"], cfg.optimizer_dtype)

    def make_step_fn():
        return make_train_step(live["model"], lr_peak=args.lr,
                               lr_total=args.steps)

    def make_batch_iter(start_step):
        return make_batch_iterator(dcfg, start_step=start_step)

    fired = {"done": False}

    def injector(step):
        if step == args.inject_fault and not fired["done"]:
            fired["done"] = True
            raise SimulatedFault(f"injected at step {step}")

    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        loop_cfg = LoopConfig(total_steps=args.steps,
                              ckpt_every=args.ckpt_every,
                              ckpt_dir=args.ckpt_dir or tmp,
                              codec=args.codec)
        t0 = time.time()
        res, _ = run_with_restarts(
            make_step_fn, make_state, make_batch_iter, loop_cfg,
            fault_injector=injector if args.inject_fault else None)
        wall = time.time() - t0
    out = {
        "name": cfg.name, "steps": res.final_step, "wall_s": round(wall, 1),
        "loss_first10": round(float(np.mean(res.losses[:10])), 4),
        "loss_last10": round(float(np.mean(res.losses[-10:])), 4),
        "restarts": res.restarts,
        "straggler_flags": len(res.straggler_flags),
        "mean_step_ms": round(1e3 * float(np.mean(res.step_times)), 1),
    }
    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({**out, "losses": res.losses}, f)
    return out


if __name__ == "__main__":
    main()
