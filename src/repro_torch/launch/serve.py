"""Serving launcher: model decode + continuous-batching CRAM-KV tier
(port of `repro.launch.serve`).

Runs a model of any family (dense, moe, ssm, hybrid, vlm, encdec) end
to end — prefill token by token, then greedy step decoding with the
stacked cache — and mirrors the first attention block's real layer-0 KV
stream through the serve tier (`repro_torch.serving.ServeLoop`; none for
the ssm family, which has no attention, nor, as in the reference, for
whisper's encdec, which decodes against the zero cross K/V of
`init_cache(B, max_len)`: the launcher has no frames to encode): a
fixed pool of `--slots` lanes with slot reuse, staggered admits every
`--admit-rate` steps (each prompt ingested by one bulk pack), per-step
decode appends through the fused megastep, and a compressed host spill
tier behind the lanes (`--spill-pages` caps it).  With `--slots` below
`--batch`, cold sequences spill compressed and wake on their next decode
step; every crossing books one ledger `spill` row.  `--kv-policy auto`
lets the AutoTuner pick both tiers' packings from the prompts' KV.  The
printed report has the reference's keys.

  python -m repro_torch.launch.serve --arch phi4_mini_3_8b --no-smoke \
      --batch 4 --slots 2 --admit-rate 4 --kv-policy auto --spill-pages 64

Runs on the card by default (`--device cuda`); `--device cpu` runs the
plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import configs
from ..bandwidth import AutoTuner, Ledger
from ..device import resolve_device
from ..models import ModelConfig, build, smoke_config
from ..serving import ServeLoop
from .steps import make_serve_step
from .train import PRESETS

PAGE = 16   # serve-tier tokens per KV page


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_tier(args, cfg, cache, ledger, *, prompt_len, total_tokens,
                device):
    """Continuous-batching mirror of one layer's KV stream: staggered
    admits (whole prompt in one bulk pack, or straight to the spill tier
    when the pool is full and the newcomer is the coldest), per-step
    decode appends in waves of `--slots`, retire at the end of the
    stream; spill crossings happen whenever live > slots.  The stream is
    the first super-block's KV of the first position (in sorted `b{j}`
    order) that holds an attention cache, as the reference picks it
    (zamba2: the shared block)."""
    key = next(k for k in sorted(cache) if k.startswith("b")
               and "attn" in cache[k])
    kcache = cache[key]["attn"]["k"][0]             # (B, T, hkv, hd)
    vcache = cache[key]["attn"]["v"][0]
    B = kcache.shape[0]
    P, T = prompt_len, total_tokens
    n_need = -(-T // PAGE)
    kw = dict(slots=args.slots or B, max_pages=max(n_need, 2), page=PAGE,
              n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
              spill_pages=args.spill_pages, ledger=ledger,
              fused=not args.unfused, migrate_budget=args.migrate_budget,
              async_spill=not args.sync_spill, device=device)
    choices = None
    if args.kv_policy == "auto":
        # auto picks both tiers' packings; --kv-packing and
        # --spill-packing apply to the explicit policies only
        loop, ch = ServeLoop.auto(AutoTuner(), kcache[:, :P],
                                  vcache[:, :P], **kw)
        choices = {tier: c.as_dict() for tier, c in ch.items()}
    else:
        loop = ServeLoop(policy=args.kv_policy, packing=args.kv_packing,
                         spill_packing=args.spill_packing, **kw)
    admit_every = max(args.admit_rate, 1)
    admit_at = {i: i * admit_every for i in range(B)}
    fed: dict[int, int] = {}                  # seq -> tokens consumed
    step_no = 0
    while len(fed) < B or any(t < T for t in fed.values()):
        for i in range(B):
            if admit_at[i] == step_no:
                loop.prefill(i, kcache[i, :P], vcache[i, :P])
                fed[i] = P
        kvs = {i: (kcache[i, fed[i]:fed[i] + 1],
                   vcache[i, fed[i]:fed[i] + 1])
               for i in loop.seqs if fed[i] < T}
        if kvs:
            loop.step_all(kvs)
            for i in kvs:
                fed[i] += 1
                if fed[i] >= T:
                    loop.retire(i)
        step_no += 1
    obs = loop.observe_tiers()
    return {
        **loop.summary(),
        "serve_steps": step_no,
        "policy": args.kv_policy,
        "policy_choice": choices,
        "tier_observations": obs or None,
    }


def _timed_decode(serve_step, prompts, cache, *, gen, device):
    """Prefill and step decode as two separately timed regions, each ended
    by a device synchronise; tokens are copied to the host after both."""
    P = prompts.shape[1]
    t0 = time.perf_counter()
    for i in range(P - 1):
        serve_step(prompts[:, i:i + 1], cache, i)
    _sync(device)
    prefill_wall = time.perf_counter() - t0
    generated = []
    tok = prompts[:, -1:]
    t1 = time.perf_counter()
    for i in range(P - 1, P + gen - 1):
        tok, cache = serve_step(tok, cache, i)
        generated.append(tok)
    _sync(device)
    decode_wall = time.perf_counter() - t1
    gen_arr = torch.cat(generated, dim=1).cpu().numpy()
    return gen_arr, cache, prefill_wall, decode_wall


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="phi4_mini_3_8b")
    ap.add_argument("--preset", default=None, choices=[*PRESETS])
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduce the arch to CPU-smoke size (--no-smoke "
                         "runs the published shape)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--slots", type=int, default=0,
                    help="serve-tier batch lanes (0 = one per sequence; "
                         "fewer than --batch exercises the spill tier)")
    ap.add_argument("--spill-pages", type=int, default=None,
                    help="host spill-tier capacity in pages (default "
                         "unbounded)")
    ap.add_argument("--admit-rate", type=int, default=1,
                    help="admit one new sequence every N serve steps")
    ap.add_argument("--kv-policy", default="dynamic",
                    choices=["dynamic", "static", "off", "auto"])
    ap.add_argument("--kv-packing", default="pair", choices=["pair", "quad"],
                    help="hot-tier packing (ignored with --kv-policy auto, "
                         "where the AutoTuner picks per tier)")
    ap.add_argument("--spill-packing", default="quad",
                    choices=["off", "pair", "quad"],
                    help="spill-tier packing (auto overrides it)")
    ap.add_argument("--migrate-budget", type=int, default=1,
                    help="page-group columns re-laid per decode step while "
                         "a gate flip / packing switch migrates the cache")
    ap.add_argument("--unfused", action="store_true",
                    help="append / repack / account as separate calls "
                         "instead of the fused megastep")
    ap.add_argument("--sync-spill", action="store_true",
                    help="re-encode spill payloads inline on evict instead "
                         "of on the background worker")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def main(argv=None, *, params: dict | None = None,
         config: ModelConfig | None = None) -> dict:
    """Run the launcher; `params` (a state dict) replaces the random init,
    so a caller can run the port on the reference's weights; `config`
    replaces the one `--arch` / `--preset` / `--smoke` would pick (a
    depth-cut config, say)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if config is not None:
        cfg = config
    elif args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = configs.get(args.arch)
        if args.smoke:
            cfg = smoke_config(cfg)
    model = build(cfg, device=device, seed=args.seed, params=params)
    rng = np.random.default_rng(args.seed)
    B, P, G = args.batch, args.prompt_len, args.gen
    max_len = P + G
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, P)).astype(np.int64)).to(device)
    serve_step = make_serve_step(model)

    # warm-up on a throwaway cache so tokens_per_s excludes first-call cost
    serve_step(prompts[:, :1], model.init_cache(B, max_len), 0)
    _sync(device)
    cache = model.init_cache(B, max_len)
    gen, cache, prefill_wall, decode_wall = _timed_decode(
        serve_step, prompts, cache, gen=G, device=device)

    ledger = Ledger("serve")
    kv_stats = None
    if cfg.family in ("dense", "moe", "vlm", "hybrid"):
        kv_stats = _serve_tier(args, cfg, cache, ledger, prompt_len=P,
                               total_tokens=P + G - 1, device=device)
    out = {
        "name": cfg.name, "batch": B, "prompt_len": P, "generated": G,
        "prefill_tokens_per_s": round(B * (P - 1)
                                      / max(prefill_wall, 1e-9), 1),
        "tokens_per_s": round(B * G / max(decode_wall, 1e-9), 1),
        "sample": gen[0][:16].tolist(),
        "serve_tier": kv_stats,
        "traffic": ledger.as_dict(),
    }
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
