#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one card and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. the card's name and power limit; build of the CUDA kernels from
     `src/repro_torch/csrc` (nvcc, one process per source, in parallel),
     with every kernel's registers and spills, K7's SASS instruction
     count (cuobjdump) and E1's shared memory;
  2. kernels against their plain versions: at the phi4-mini-3.8B KV
     geometry (page 16, 8 KV heads, head_dim 128, 24 query heads) K1/K2
     (window pack) bit-exact on a 32-group and a 64-group window, each
     with a group whose only out-of-range delta sits in its last chunk,
     and K3 (decode on the compressed cache) within atol = rtol = 2e-3
     (summation order, __expf) with the bytes exact; the page codecs'
     group pack (K1/K2) and unpack (K4/K5) bit-exact at three shapes (one
     group, six groups and two by three groups of an odd geometry), pack
     -> unpack the identity where a group fits; K7 (the compressibility
     scan) bit-exact on all four outputs at 1, 301, 1024 and 2^20 lines,
     two of them at keys other than the default, with every marker class
     planted and each planted line's class held, and on 2^20 lines of the
     boundary image (`boundary_image`: each line at one edge of the FPC
     classes, the BDI modes, zero runs and the Marker-IL test, kinds
     shuffled across every warp); K6 (single-sequence
     decode) within 2e-3 at four slot counts, three of them not a multiple
     of the lanes, one sequence with no valid token; then K3 and K6 at the
     reference's other head geometries (page 8, Hkv 1, Hq 1, head_dim 16;
     Hkv 1, Hq 4, head_dim 32; Hkv 32, Hq 32, head_dim 80; Hkv 8, Hq 96,
     head_dim 128, a group of 12), K3 within 2e-3 with the bytes exact and
     K6 within 2e-3 and equal to K3's row of every sequence; E1 (the trace
     engine's scan) on every scheme row of the registry x libq / pr_twi /
     mix3 at 4,000 events, at the default SimConfig and at a second one
     (64 sets x 4 ways, 32 metadata sets, compress_clean off), in one
     launch and in chunks of 1,000 and of 1,537: every carry tensor equal
     (torch.equal) to the plain version's;
  3. training, first, while the card is empty: `make_train_step` at the
     full published phi4-mini-3.8B shape (32 layers, random weights) for
     3 steps and zamba2-2.7b (54 layers) for 2, batch 4 x 256 tokens, the
     configs' own microbatches (4) and remat, bf16 compute, float32
     parameters and moments, one synthetic batch repeated: per step the
     loss (finite; phi4's falls), gnorm, wall, device time
     (torch.profiler), busy share, peak memory, the model FLOPs' share of
     the bf16 peak and the AdamW update's wall beside its 28 B/param byte
     bound ("train train_phi4" / "train train_zamba2" lines); the README's
     training example through the launcher (`--preset lm20m --steps 300
     --batch 8 --ckpt-every 50 --inject-fault 150`, cram checkpoints): 300
     steps, one restart, the loss fallen, the restored state bit-exact
     against the state saved at step 150, each kept manifest's raw and
     stored bytes ("train launcher" lines); each decoder arch at smoke
     size in float32, 3 train steps on the CPU and twice on the card from
     the same weights and batches: losses, parameters and a decode step
     after training within 1e-4, the two card runs bit-identical ("train
     parity" lines); whisper-base (the encdec family) at its published
     width and depth through the train launcher, 3 steps at batch 8 x
     `--seq 448` (per step loss, wall, device time, busy share, peak
     memory: "whisper train" lines), and whisper at smoke size in float32,
     one train step, the encoder, `prefill_cross` and 4 decode steps on
     the CPU and twice on the card within 1e-4, greedy tokens equal, the
     card runs bit-identical ("whisper parity"); then the multi-device
     runtime's collective paths in a world of one rank under NCCL (the
     machine has one card, and NCCL refuses two ranks on one card): the
     compressed-gradient DP step at phi4-mini-3.8B's full width, 2 steps
     of each of `off`, `static` and `dynamic` at batch 2 x 512, four
     leaves' updates torch.equal to p - lr * g by hand (g quantized with
     the error feedback where the gate is on), the ledger's wire bytes
     equal to the tree's raw / int8 bytes, with loss, gate, rel_err,
     counter, wall and peak memory ("multi-device dp" lines); GPipe over
     32 layers of tanh(x @ W) at d 3,072 with 4 microbatches of 2 x 512,
     outputs and gradients torch.equal to the layers in sequence
     ("multi-device gpipe"); the train launcher's lm20m checkpoint
     restored and resharded onto the `shrink_mesh` grid, every local
     shard equal to its leaf ("multi-device elastic"); and in the same
     world the model cell (`launch/steps.py:build_cell`, placed by
     `place_cell` on a (1, 1) ("data", "model") mesh): phi4-mini-3.8B at
     its published width, `--seed` weights, train_4k (batch cut 256 ->
     2), prefill_32k (32 -> 2, and 4 of 32 layers) and decode_32k (128
     -> 8, a random 32,767-token prefix in the cache), each step under
     `launch/hlo_analysis.py:analyze_step` (flops, collectives by type,
     argument bytes a device holds beside HBM_BYTES) held against the
     unsharded step on the same weights and inputs (loss and four leaves
     within 1e-5 relative, logits within 1e-4, next tokens and written
     cache rows torch.equal), then timed alone (wall, device time, busy
     share, peak memory): "cell" lines; then the dry run
     (`launch/dryrun.py`), in processes of its own, as many at once as
     the host has cores, each in a fake world: the same three cells
     counted on fake CUDA tensors in a world of one rank, their flops,
     collectives and argument bytes equal to the "cell" lines' and their
     predicted peak (argument + temp bytes) within 10% of the measured
     one, phi4-mini's four STANDARD_SHAPES on the (32, 8) mesh in a world
     of 256 through the dry run's CLI (decode_32k through
     `launch/perf.py` over base, no_fsdp and bf16_params), each ok or
     skipped with no probe error, its argument bytes equal to
     `argument_table`'s, its peak beside 80 GB (train_4k's within it) and
     its roofline terms, and mamba2-130m's and olmoe-1b-7b's train_4k on
     (32, 8), ok with no probe error: "dryrun" lines; then
     the serve launcher at the full published phi4-mini-3.8B shape (32
     layers, random weights), once with pair and once with quad packing,
     with the wall time of model build, model decode and serve tier, and
     the device time of one decode step from torch.profiler; then the
     README's spill command (`--batch 4 --slots 2 --admit-rate 4
     --kv-policy auto --spill-pages 64`, async spill), printing the
     AutoTuner's per-tier choices and observation windows, and the same
     command with `--kv-policy dynamic --kv-packing pair --spill-packing
     quad`; both must evict and wake, with the ledger's kv-evict /
     kv-restore spill rows counting the crossings; then each decoder arch
     at smoke size in float32 on the CPU and on the card, same weights, 4
     decode steps within 1e-4 with equal greedy tokens and two card runs
     bit-identical ("zoo parity" lines), and the model zoo's other
     families through the same launcher at their published width
     (random weights, batch 4, prompt 32, 32 generated; ZOO_RUNS):
     olmoe-1b-7b with pair and with quad and the spill tier, zamba2-2.7b
     (the shared attention block's KV), mamba2-130m (no attention cache:
     no serve tier, no traffic), and llama-3.2-vision-90b and
     llama4-maverick-400b-a17b cut to one super-block (5 and 2 layers),
     each with its walls, decode step device time, busy share and peak
     device memory ("zoo" lines), the card freed between runs; then
     whisper-base at its published width and depth through the same
     launcher (batch 4, prompt 32, 32 generated; no serve tier and no
     traffic, as in the reference: "whisper serve" line);
  4. the serve tier alone: 200-token prompts in 8 slots (6 compressible,
     1 incompressible, 1 alternating), 48 decode steps each followed by an
     attend, every attend held against the plain attention on the same
     state, K6 on each sequence's physical view at the last step equal
     to that sequence's row of K3's output (torch.equal: one device body,
     one split), and the final physical
     state bit-exact against the per-slot rebuild (which packs with the
     plain version); then the page-codec round trip on the last step's
     physical view: every packed slot through the registry's unpack (K4 or
     K5) bit-exact against the plain decode, and the unpacked pages
     through the registry's pack (K1 or K2) back to the same slot and base;
     then a short serve tier at the reference's serving-test geometry
     (page 8, one KV head, one query head, head_dim 16; 4 slots, 8 decode
     steps, pair and quad), every attend through ServeLoop.attend on the
     card held against the plain attention, and `shard=True` on the card's
     one device equal to `shard=False`; then the serve tier with the spill
     tier churning (hot pair with spill quad, then hot quad with spill
     pair): the serve-attend stream's 8 sequences in 4 slots, 48 steps
     through step_all, so every step evicts and wakes 4, every attend held
     against the plain attention, every sequence woken at the end
     bit-exact against a never-spilled twin loop with 8 slots on the CPU,
     spill rows equal to the crossings, and the host wall of one evict,
     one restore and the worker's encode and decode;
  5. the compressibility scan of the Fig. 4 memory image at
     n_lines_each = 2^21 (15,728,640 lines, 1,006,632,960 bytes, resident
     on the card) in one K7 launch through the `hybrid` codec's scan
     backend, the first 4,096 lines of each source held against the numpy
     codec and marker reference, and the Fig. 4 statistics printed; then
     the trace simulator through E1: the golden stats
     (`tests/golden/engine_stats.json`) in one launch and through
     `simulate("dynamic", chunk_size=5000)`, the full suite (27 workloads
     x 10 scheme rows, 20,000 events) in one launch against the committed
     JAX fixture (`tests/fixtures/torch_engine_sweep.json`), and the
     paper's sweep (`sweep_workloads`, 27 x 10 at 200,000 events) in one
     launch, equal to the same sweep in chunks of 50,000, with each
     scheme's geomean and lowest speedup, mean LLP accuracy and metadata
     share of accesses ("trace sim:" lines); then the multi-device
     runtime's shardings on the one card, over device lists that name it
     several times: the sharded attend at the serve-attend geometry, pair
     and quad, in 2 and 4 slot shards (one K3 launch a shard, torch.equal
     to `shard=False`), and the paper sweep in 3 workload shards (one E1
     launch a shard, every stat equal to the one-launch sweep, each
     shard's device time: "multi-device shard" lines); then, outside the
     paths, the
     launch audit's ten entries (`repro_torch.analysis.launch_audit`) on
     the card, each recorded call under
     `torch.cuda.set_sync_debug_mode("error")`: its LAUNCHES equal to the
     kernel calls of `tests/golden/torch_launch_audit.json`, its hard
     invariants held, its aten op count printed beside the device
     operations torch.profiler records for it ("audit" lines);
  6. every kernel launch of phases 3 to 5, held against the plain version
     on a copy of the inputs that launch was given (K7 in chunks of 2^20
     lines over every line; E1 over the first 256 events of each launch,
     from its input carry): bit-exact for K1, K2, K4, K5, K7 and E1, within
     atol = rtol = 2e-3 for K3 (bytes exact, and bit for bit the flat
     entry's on the same view: a launch of the in-place entry is kept as
     the physical view of its cache) and K6.  A1's launches (the
     model's decode attention, one or two a layer that attends the cache
     in every decode step) are counted, not copied: a copy of each
     layer's cache would not fit beside the model.  Its output is held
     against the plain version on the CPU through the models by the "zoo
     parity" and "whisper parity" lines, and at the decode cells' shapes
     in phase 7;
  7. timings of every kernel at the shapes phases 3 to 5 gave it, beside
     its plain version, its bound and, for K3 and K6,
     scaled_dot_product_attention on the materialised K/V: device time
     (calls captured in one CUDA graph, CUDA events, median of replays)
     and one eager call with the host's dispatch; K7's plain version,
     which walks the image in chunks, is timed eagerly with CUDA events.
     Then K3 and K6 once more at a long-context shape (B = 8 sequences of
     4,096 all-compressible tokens, every token valid: 256 flat slots),
     each checked once (K3 within 2e-3 with bytes exact, K6 equal to K3's
     row) and timed the same way, so that their byte bound is well above
     launch latency; K3's in-place entry, which the serve tier's attend
     takes on the card, at the serve attend's shape and at the kv_long
     cell's (32 sessions of 16k-57k tokens at its 2,048-group bucket,
     sliced out of a wider state made on the card), pair and quad: bit
     for bit the flat route (the physical view copied, then K3 on it)
     and timed beside it, beside K3 on a ready view and beside the view
     copy alone ("timing [k3-in-place]"); K1/K2 at the prefill window (B = 8, W = 8) and at
     the zoo's serve windows of olmoe (Hkv 16, D2 256) and zamba2 (Hkv
     32, D2 160; K2 on a synthetic window of the same shape, since zamba2
     runs pair only: "timing [zoo-window]"), and beside every K1/K2 row
     the device time of one copy_ of the window's bytes; K3 and K6 at
     phase 2's other head geometries; beside K7's row the device time of
     an int32 sum of each line's 16 words over the same image (reads it
     once, writes 4 B a line), and K7 on each Fig. 4
     source's slice of the image ("timing [scan-source]"); the group pack
     (K1/K2 on whole page groups) at a bulk shape, the KV of 8 sequences x
     4,096 tokens of one layer at the phi4 KV geometry (2,048 pages, 128
     MiB: 1,024 pair / 512 quad groups, made on the card from a seeded
     torch.Generator, every eighth group misfit only at its last element),
     bit-exact against `pagepack` before it is timed ("timing
     [bulk-group]"); E1 at the paper's sweep (host time of the traces,
     device time of the one launch, median of 3, its byte bound) and on
     the sweep's first 2,000 events beside its plain version ("timing
     [engine]"), and each lane's own time in one more launch of the
     sweep, from the device clock at its first and last event, with the
     five slowest lanes and the slowest of each row ("engine lanes");
     A1, the model's decode attention, at the two decode cells' shapes,
     first against its plain version in float32 ("gqa decode"), then
     beside its byte bound, the plain chunk loop and
     `scaled_dot_product_attention` ("timing [gqa-decode]": two
     launches a call with several splits, one with one).
     Every timing row carries `kernels_per_call`: the device operations
     one call of the wrapper puts on the card after a warm-up, counted
     from torch.profiler's record of the CUDA calls that enqueue them;
     the group pack and E1 must be exactly one.

Phases 3 to 5 drive thirty-one paths (phi4 and zamba2 training, the
training launcher, whisper's training, the DP step, GPipe, elastic
re-meshing, the model cell, the dry run, launcher pair and quad, the
spill launcher with auto and with pair, the six zoo runs, whisper's
serving, serve attend pair and quad, the small serve attend, serve churn
pair and quad, page codec pair and quad, scan, trace simulator, the
sharded attend, the sharded sweep);
the launch counters are set to 0 just before each and read just after it,
and every kernel a path runs must have launched in it.  A1 must launch
once a layer that attends the cache in each of the path's decode steps on
the card (`decode_step` of a model; layers counted from its cache).  The
last two lines are the kernels' JSON record and {"ok": true, "device":
{...}}.  It needs one CUDA card and a checkout of the repository around
it.  `--report PATH` also writes the full report as JSON.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
PAGE, N_KV, HEAD_DIM, N_HEADS = 16, 8, 128, 24
ATOL = RTOL = 2e-3

LONG_BATCH, LONG_TOKENS = 8, 4096   # phase 7's long-context attention shape
BULK_SEQS, BULK_TOKENS = 8, 4096    # phase 7's bulk group pack: one layer's KV
SCAN_LINES_EACH = 2 ** 21       # Fig. 4 corpus: 15,728,640 lines, ~1.0 GB
SCAN_CHUNK = 2 ** 20            # lines per plain-version chunk on the card

_BDI_CU = "src/repro_torch/csrc/bdi_pack.cu"
_ATT_CU = "src/repro_torch/csrc/cram_attention.cu"
KERNELS = {
    "pack_pair": (_BDI_CU, "src/repro/kernels/bdi_pack.py:60"),
    "pack_quad": (_BDI_CU, "src/repro/kernels/bdi_pack.py:118"),
    "decode_attention_pair": (_ATT_CU,
                              "src/repro/kernels/cram_attention.py:309"),
    "decode_attention_quad": (_ATT_CU,
                              "src/repro/kernels/cram_attention.py:309"),
    "pack_pair_group": (_BDI_CU, "src/repro/kernels/bdi_pack.py:60"),
    "pack_quad_group": (_BDI_CU, "src/repro/kernels/bdi_pack.py:118"),
    "unpack_pair": (_BDI_CU, "src/repro/kernels/bdi_pack.py:75"),
    "unpack_quad": (_BDI_CU, "src/repro/kernels/bdi_pack.py:133"),
    "decode_single_pair": (_ATT_CU,
                           "src/repro/kernels/cram_attention.py:137"),
    "decode_single_quad": (_ATT_CU,
                           "src/repro/kernels/cram_attention.py:137"),
    "compress_scan": ("src/repro_torch/csrc/compress_scan.cu",
                      "src/repro/kernels/compress_scan.py:280"),
    # no pallas_call: the reference's lax.scan of the engine step
    # (engine.py:221-378), vmapped at core/batchsim.py:45-58
    "engine_scan": ("src/repro_torch/csrc/engine_scan.cu",
                    "src/repro/core/engine.py:378"),
}
PACK_OUTPUTS = ("slots", "overflow", "strips", "lay", "fit")
SCAN_OUTPUTS = ("sizes", "fpc", "bdi", "status")
# the paths of the main path, each with the kernels it must launch
# (A1, "gqa_decode", wherever a model decodes through its own cache on the
# card)
PATHS = {
    "launcher_pair": ("pack_pair", "gqa_decode"),
    "launcher_quad": ("pack_quad", "gqa_decode"),
    # the README's spill command: --kv-policy auto gates both tiers off on
    # random-weight KV, so only the model's decode attention is required;
    # the same command with --kv-policy dynamic --kv-packing pair must pack
    "launcher_spill": ("gqa_decode",),
    "launcher_spill_pair": ("pack_pair", "gqa_decode"),
    "serve_attend_pair": ("pack_pair", "decode_attention_pair",
                          "decode_single_pair"),
    "serve_attend_quad": ("pack_quad", "decode_attention_quad",
                          "decode_single_quad"),
    "serve_attend_small": ("pack_pair", "pack_quad", "decode_attention_pair",
                           "decode_attention_quad"),
    "serve_churn_pair": ("pack_pair", "decode_attention_pair"),
    "serve_churn_quad": ("pack_quad", "decode_attention_quad"),
    "page_codec_pair": ("unpack_pair", "pack_pair_group"),
    "page_codec_quad": ("unpack_quad", "pack_quad_group"),
    "scan": ("compress_scan",),
    "trace_sim": ("engine_scan",),
    # the model zoo at full width (ZOO_RUNS): each family's first attention
    # cache through the serve tier, and the model's decode attention; mamba2
    # has no attention, so no kernel
    "zoo_olmoe_pair": ("pack_pair", "gqa_decode"),
    "zoo_olmoe_quad_spill": ("pack_quad", "gqa_decode"),
    "zoo_zamba2_pair": ("pack_pair", "gqa_decode"),
    "zoo_mamba2": (),
    "zoo_vision_pair": ("pack_pair", "gqa_decode"),
    "zoo_maverick_pair": ("pack_pair", "gqa_decode"),
    # training (TRAIN_RUNS and the launcher's README example) runs no
    # kernel of the port: the reference's training path has no pallas_call
    "train_phi4": (),
    "train_zamba2": (),
    "train_launcher": (),
    # whisper-base on both launchers: no serve tier (the reference's serve
    # launcher runs none for the encdec family); its decoder's self and
    # cross attention decode through A1
    "whisper_train": (),
    "whisper_serve": ("gqa_decode",),
    # the multi-device runtime: the sharded attend and the sharded sweep
    # launch one K3 / E1 a shard; the DP step, GPipe and elastic
    # re-meshing run no kernel of the port (the reference's have no
    # pallas_call)
    "multi_shard_attend": ("decode_attention_pair", "decode_attention_quad"),
    "multi_shard_sweep": ("engine_scan",),
    "multi_dp": (),
    "multi_gpipe": (),
    "multi_elastic": (),
    # the model cell: its steps reach none of K1-K7 or E1 (the reference's
    # model steps have no pallas_call); decode_32k's attention is A1, a
    # launch a layer on the rank's shard (`decode_on_shards`) and in the
    # unsharded step it is held against
    "multi_cell": ("gqa_decode",),
    # the dry run counts cells on fake tensors: no kernel
    "dryrun": (),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def kernel_resources(cuda_lib) -> list[str]:
    """One line per compiled kernel: its name and template arguments, its
    registers and spills, from the build's ptxas report."""
    import re

    funcs = ("window_fit_kernel", "window_write_kernel", "pack_pages_kernel",
             "unpack_pages_kernel", "cram_decode_kernel",
             "cram_decode_single_kernel", "cram_decode_combine",
             "compress_scan_kernel", "engine_scan_kernel",
             "gqa_decode_split_kernel", "gqa_decode_merge_kernel")
    lines = []
    for r in cuda_lib.ptxas_report():
        mangled = r["kernel"]
        name = next((f for f in funcs if f"{len(f)}{f}" in mangled), mangled)
        args = re.findall(r"Li(\d+)E", mangled.split(name, 1)[-1])
        if name == "gqa_decode_split_kernel":     # the K/V element type
            args.insert(0, "bf16" if "bfloat16" in mangled
                        else "f16" if "6__half" in mangled else "f32")
        if name == "cram_decode_kernel":          # K3's addressing
            args[4:] = ["in place" if "LeafSlots" in mangled else "flat"]
        label = f"{name}<{', '.join(args)}>" if args else name
        lines.append(f"{label}: {r['registers']} registers, spill stores "
                     f"{r['spill_stores']} B, loads {r['spill_loads']} B")
    return sorted(lines)


def engine_smem_line() -> str:
    """E1's dynamic shared memory a CTA at the default SimConfig (it has
    no static shared memory; ptxas reports registers and spills)."""
    from repro_torch.compression.predictor import LCT_ENTRIES
    from repro_torch.core.engine import SimConfig, engine_tables
    from repro_torch.kernels.engine_scan import smem_bytes

    c = SimConfig()
    n = smem_bytes(c.llc_sets, c.llc_ways, c.meta_sets, c.meta_ways,
                   LCT_ENTRIES, engine_tables(c)["probe"].shape[-1])
    return (f"engine_scan_kernel: {n} B of dynamic shared memory a CTA at "
            "the default SimConfig")


def sass_count(cuda_lib, stem: str, kernel: str) -> str:
    """`kernel`'s SASS instructions in the object `csrc/<stem>.cu` built
    into the bound library, counted from `cuobjdump -sass`: all, and
    without NOPs."""
    import re
    import shutil

    lib = pathlib.Path(cuda_lib.load()._name)
    obj = lib.parent / f"{stem}_{lib.stem.rsplit('_', 1)[1]}.o"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    body = next(f for f in dump.split("Function : ")[1:]
                if kernel in f.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
    nops = sum(op.split()[0] == "NOP" for op in ops)
    return f"{kernel}: {len(ops)} SASS instructions, {len(ops) - nops} " \
        "without NOP"


# ------------------------------------------------- the Fig. 4 memory image

def fig4_corpus(n_lines_each: int = 4096, seed: int = 0) -> dict:
    """A copy of `benchmarks/fig4_compressibility.py:_corpus`: realistic
    memory contents by source (model weights fp32/bf16, optimizer moments,
    token ids, pointers, zero-heavy buffers, text, random bytes), each
    n_lines_each 64-byte lines except bf16 weights (half as many)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_bytes = n_lines_each * 64
    out = {}
    w = (rng.standard_normal(n_bytes // 4) * 0.02).astype("<f4")
    out["weights_fp32"] = w.view(np.uint8)
    out["weights_bf16"] = np.ascontiguousarray(
        w.astype("<f4").view("<u4") >> 16).astype("<u2").view(np.uint8)
    m = (rng.standard_normal(n_bytes // 4) * 1e-8).astype("<f4")
    m[rng.random(m.shape) < 0.6] = 0.0
    out["adam_moments"] = m.view(np.uint8)
    ids = rng.integers(0, 32000, n_bytes // 4).astype("<i4")
    out["token_ids"] = ids.view(np.uint8)
    ptr = (2**20 + np.cumsum(rng.integers(0, 64, n_bytes // 8))).astype(
        "<i8")
    out["pointers"] = ptr.view(np.uint8)
    z = np.zeros(n_bytes, np.uint8)
    nz = rng.random(n_bytes) < 0.05
    z[nz] = rng.integers(1, 255, int(nz.sum()))
    out["sparse_zero"] = z
    txt = rng.choice(
        np.frombuffer(b"the quick brown fox jumps over 0123456789,. \n",
                      np.uint8), n_bytes)
    out["text_ascii"] = txt
    out["random"] = rng.integers(0, 256, n_bytes).astype(np.uint8)
    return {k: v[: n_bytes] for k, v in out.items()}


def pair_fit_stats(sizes) -> tuple[float, float]:
    """A copy of `benchmarks/fig4_compressibility.py:pair_fit_stats`:
    P(adjacent line pair compresses to <=64B, <=60B), the Fig. 4 statistic."""
    import numpy as np

    from repro_torch.compression.framing import PAYLOAD_BUDGET

    sizes = np.asarray(sizes)
    n = sizes.shape[0] - sizes.shape[0] % 2
    pair = sizes[0:n:2] + sizes[1:n:2]
    return float((pair <= 64).mean()), float((pair <= PAYLOAD_BUDGET).mean())


# ------------------------------------------------------------ recording

class Recorder:
    """Keeps a copy of the inputs and outputs of every launch a CUDA
    wrapper makes while a path is driven (or, for a wrapper made with
    `copy=False`, only that it launched), with the path and the ServeLoop
    or model call it came from ("prefill", "step_all", "attend",
    "model_step" or "other"), and counts the ServeLoop calls and the
    models' decode steps of each path on the card (a twin on the CPU, or
    a step on fake tensors, which launches nothing, is not counted)."""

    def __init__(self, torch):
        self.torch = torch
        self.calls: list = []
        self.loop_calls: dict = {}
        # path -> models' decode steps on the card, and the set of the
        # counts of layers whose attention reads the cache in them
        self.model_steps: dict = {}
        self.attending: dict = {}
        self.path = None
        self.part = "other"

    def _clone(self, x):
        if self.torch.is_tensor(x):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(self._clone(y) for y in x)
        if isinstance(x, dict):
            return {k: self._clone(v) for k, v in x.items()}
        return x

    def wrap(self, name_of, fn, launches: dict, copy: bool = True,
             as_flat=None):
        """`as_flat(args, kw)`, where given, keeps a launch as the
        arguments of another entry of the same kernel (copies made from
        the inputs: K3's in-place launches as the flat entry's)."""
        def wrapped(*args, **kw):
            if self.path is None:
                return fn(*args, **kw)
            inputs, kept_kw = None, dict(kw)
            if as_flat is not None:
                inputs, kept_kw = as_flat(args, kw)
            elif copy:
                inputs = [self._clone(a) for a in args]
            before = sum(launches.values())
            outs = fn(*args, **kw)
            if sum(launches.values()) > before:
                self.calls.append({
                    "name": name_of(args, kw), "path": self.path,
                    "part": self.part, "args": inputs, "kw": kept_kw,
                    "outs": self._clone(outs) if copy else None})
            return outs
        return wrapped

    def wrap_model_step(self, fn):
        """A model's `decode_step(token, cache, index, ...)`: counted with
        the layers that attend its cache (`attending_layers`) where the
        token is a tensor on the card, its launches in part
        "model_step"."""
        from torch._subclasses.fake_tensor import is_fake

        def wrapped(model, token, cache, *args, **kw):
            # a DTensor's local shard, read without an op (the cell's
            # step runs under analyze_step's dispatch mode)
            local = getattr(token, "_local_tensor", token)
            if (self.path is not None and local.device.type == "cuda"
                    and not is_fake(local)):
                self.model_steps[self.path] = (
                    self.model_steps.get(self.path, 0) + 1)
                self.attending.setdefault(self.path, set()).add(
                    attending_layers(cache))
            outer, self.part = self.part, "model_step"
            try:
                return fn(model, token, cache, *args, **kw)
            finally:
                self.part = outer
        return wrapped

    def wrap_part(self, part: str, fn):
        def wrapped(loop, *args, **kw):
            if self.path is not None and loop.cache.device.type == "cuda":
                key = (self.path, part)
                self.loop_calls[key] = self.loop_calls.get(key, 0) + 1
            outer, self.part = self.part, part
            try:
                return fn(loop, *args, **kw)
            finally:
                self.part = outer
        return wrapped

    def most_frequent(self, name, paths):
        """(args, kw) of the first call of the shape `name` was launched
        with most often on `paths`, or None."""
        by_shape: dict = {}
        for c in self.calls:
            if c["name"] != name or c["path"] not in paths:
                continue
            shape = tuple(tuple(a.shape) for a in _tensors(c["args"]))
            by_shape.setdefault(shape, []).append(c)
        if not by_shape:
            return None
        first = max(by_shape.values(), key=len)[0]
        return first["args"], first["kw"]


def in_place_as_flat(torch, args, kw):
    """A launch of K3's in-place entry (q, cache, valid_per_page,
    predictor) as the flat entry's arguments over `physical_view` of the
    same cache, which it must equal bit for bit: new tensors, so the
    launch's inputs are kept as they were."""
    from repro_torch.kernels import ops

    q, cache, valid, pred = args
    lanes = kw.get("lanes", 2)
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    slots, strips, markers, fvalid = pv(cache, valid)
    return ([q.clone(), slots.contiguous(), strips.contiguous(),
             markers.contiguous(), fvalid.to(torch.int32).contiguous(),
             pred.to(torch.int32).contiguous()],
            dict(kw, shared_cache=cache["slots"].dim() == 4))


def attending_layers(cache: dict) -> int:
    """The layers whose attention reads a model's decode cache in one
    step: the leading (layers) dim of each self ("k") and cross ("xk") K
    cache in it, nested dicts walked."""
    n = 0
    for key, x in cache.items():
        if isinstance(x, dict):
            n += attending_layers(x)
        elif key in ("k", "xk"):
            n += x.shape[0]
    return n


def _tensors(args):
    """The tensors among args, tuples of tensors flattened."""
    for a in args:
        if isinstance(a, (tuple, list)):
            yield from _tensors(a)
        elif hasattr(a, "shape"):
            yield a


# ----------------------------------------------------------------- timing

def _event_ms(torch, fn, reps: int) -> float:
    """Median over `reps` of the CUDA-event time around one fn()."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def call_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Time of one eager call, host dispatch included (what the serve step
    pays): median of `reps` after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _event_ms(torch, fn, reps)


def device_ms(torch, fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call: `inner` calls captured back to back in one
    CUDA graph, so the host's dispatch between launches is not counted;
    median over `reps` replays, divided by `inner`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(torch, graph.replay, reps) / inner


# CUDA API calls (runtime `cuda*` and low-level `cu*`) that put work on the
# card's stream
ENQUEUE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                 "cudaMemcpy", "cuMemcpy")


def kernels_per_call(torch, fn) -> int | None:
    """The device operations (kernel launches, and any memset or copy)
    that one call of fn puts on the card after a warm-up call: the CUDA
    API calls that enqueue them, as torch.profiler's CUDA activity records
    them (its device-side records miss the kernels launched from the
    port's own library, so those are not what is counted); None when the
    profiler recorded no such call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.key.startswith(ENQUEUE_CALLS))
    return n or None


def nbytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------- phase 2: kernels

def kv_window(torch, rng, b, w, lanes, kinds, device, page=PAGE, hkv=N_KV,
              hd=HEAD_DIM):
    """(B, W, lanes, page, Hkv, 2 hd) int16 window; kinds[b] is
    "compressible", "incompressible" or "mixed" (alternating groups)."""
    from repro_torch.kv import synthetic_kv_stream
    from repro_torch.kv.cache import kv_bits

    t = w * lanes * page
    rows = []
    for kind in kinds:
        kc, vc = synthetic_kv_stream(rng, 1, t, hkv, hd)
        ki, vi = synthetic_kv_stream(rng, 1, t, hkv, hd, compressible=False)
        if kind == "incompressible":
            kc, vc = ki, vi
        elif kind == "mixed":
            span = lanes * page
            for g in range(1, w, 2):
                kc[:, g * span:(g + 1) * span] = ki[:, g * span:(g + 1) * span]
                vc[:, g * span:(g + 1) * span] = vi[:, g * span:(g + 1) * span]
        rows.append(kv_bits(kc[0], vc[0], device))
    win = torch.stack(rows).reshape(b, w, lanes, page, hkv, 2 * hd)
    return win.contiguous()


def misfit_last_vector(win, b, w) -> None:
    """Push the last element of group (b, w)'s last page out of the delta
    range of its base row: a misfit that only the group's last 16-byte
    vector, and so only its last window-pack chunk, sees."""
    base = int(win[b, w, 0, 0, -1, -1])
    win[b, w, -1, -1, -1, -1] = base + 300 if base < 2**14 else base - 300


def check_pack(torch, rng, device) -> dict:
    """K1/K2 against the plain version on a 32-group and a 64-group window
    (the prefill shape, B = 8, W = 8), each with one compressible group
    that misfits only in its last chunk; returns the largest |difference|
    seen on any output, by kernel name (0 when bit-exact)."""
    from repro_torch.kernels import bdi_pack

    errs = {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nvec = PAGE * N_KV * 2 * HEAD_DIM // 8
    for b, w in ((4, 8), (8, 8)):
        kinds = (["compressible", "incompressible", "mixed", "compressible"]
                 * 2)[:b]
        enabled = torch.ones(b, dtype=torch.bool, device=device)
        enabled[3] = False
        chunk_vecs, chunks = bdi_pack.window_chunks(b * w, nvec, sms)
        for lanes in (2, 4):
            win = kv_window(torch, rng, b, w, lanes, kinds, device)
            win[3, 5, :, PAGE // 2:] = 0          # a partial page group
            misfit_last_vector(win, 0, 2)
            mk = torch.from_numpy(rng.integers(-2**15, 2**15, (w, 2)).astype(
                "int16")).to(device)
            got = bdi_pack.pack_window_cuda(win, mk, enabled)
            torch.cuda.synchronize()
            want = bdi_pack.pack_window_plain(win, mk, enabled)
            err = 0
            for name, g, r in zip(PACK_OUTPUTS, got, want, strict=True):
                err = max(err, (g.int() - r.int()).abs().max().item())
                if not torch.equal(g, r):
                    fail(f"K{1 if lanes == 2 else 2} B={b} W={w} {name} "
                         "differs from the plain version")
            fit = got[4]
            if not (bool(fit[0, 1]) and not bool(fit[0, 2])):
                fail(f"K{1 if lanes == 2 else 2} B={b} W={w}: the group with "
                     "a misfit in its last chunk only was not told apart "
                     "from its neighbour")
            name = "pack_pair" if lanes == 2 else "pack_quad"
            errs[name] = max(errs.get(name, 0.0), float(err))
            print(f"kernel check: pack lanes={lanes} B={b} W={w} bit-exact on "
                  f"5 outputs ({chunks} chunks of {chunk_vecs} vectors a "
                  f"group, the last of {nvec - chunk_vecs * (chunks - 1)}; "
                  f"fit per group {fit.sum().item()}/{b * w}, the last-chunk "
                  "misfit seen)")
    return errs


PHI4_GEOMETRY = (PAGE, N_KV, N_HEADS, HEAD_DIM)
# (page, Hkv, Hq, head_dim) the reference computes beyond the phi4 shape:
# its serving tests, its kernel sweep and smoke configs (head_dim 32),
# zamba2_2_7b's head_dim 80 and mistral_large_123b's group of 12
GEOMETRIES = ((8, 1, 1, 16), (16, 1, 4, 32), (16, 32, 32, 80),
              (16, 8, 96, 128))


def attention_inputs(torch, rng, lanes, b, n_groups, device, shared=False,
                     geometry=PHI4_GEOMETRY):
    """Per-sequence (or shared) compressed caches from mixed streams, a
    ragged valid mask (zero-valid lanes, partial pages) and a predictor
    with mismatches, in the flat physical view."""
    from repro_torch.kernels import ops

    page, hkv, hq, hd = geometry
    kinds = ["compressible", "mixed", "incompressible", "compressible"]
    caches = []
    for i in range(1 if shared else b):
        win = kv_window(torch, rng, 1, n_groups, lanes, [kinds[i % 4]],
                        device, page, hkv, hd)
        build = ops.build_cram_cache if lanes == 2 else ops.build_cram_cache_quad
        caches.append(build(win.reshape(-1, page, hkv, 2 * hd)))
    keys = ("slots", "slots_overflow", "strips", "packed_mask")
    if shared:
        cache = {k: caches[0][k] for k in keys}
    else:
        cache = {k: torch.stack([c[k] for c in caches]) for k in keys}
    cache["markers"] = caches[0]["markers"]
    lead = () if shared else (b,)
    tokens = torch.from_numpy(rng.integers(
        1, n_groups * lanes * page, lead or (1,))).to(device)
    if not shared:
        tokens[1] = 0                               # a zero-valid lane
    pages = torch.arange(n_groups * lanes, device=device)
    valid = torch.clamp(tokens.reshape(-1, 1) - pages * page, 0, page)
    valid = valid.reshape(*lead, -1).to(torch.int32)
    pred = cache["packed_mask"].clone()
    flip = torch.from_numpy(rng.random(tuple(pred.shape)) < 0.3).to(device)
    pred = pred ^ flip
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    slots, strips, markers, fvalid = pv(cache, valid)
    q = torch.from_numpy(rng.standard_normal(
        (b, hq, hd)).astype("float32")).to(device)
    return (q, slots.contiguous(), strips.contiguous(), markers.contiguous(),
            fvalid.to(torch.int32).contiguous(),
            pred.to(torch.int32).contiguous())


def check_attention_once(torch, args, kw, label) -> float:
    from repro_torch.kernels import cram_attention as ca

    out, byts = ca.cram_decode_attention_batched_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref, ref_b = ca.cram_decode_attention_batched_plain(*args, **kw)
    if not torch.isfinite(out).all():
        fail(f"K3 {label}: non-finite output")
    if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL):
        fail(f"K3 {label}: max |diff| {(out - ref).abs().max().item():.3e} "
             f"beyond atol=rtol={ATOL}")
    if not torch.equal(byts, ref_b):
        fail(f"K3 {label}: bytes {byts.tolist()} != {ref_b.tolist()}")
    return (out - ref).abs().max().item()


def check_attention(torch, rng, device) -> dict:
    """K3 against the plain version; returns the largest |difference| by
    kernel name."""
    errs = {}
    for lanes in (2, 4):
        for shared in (False, True):
            args = attention_inputs(torch, rng, lanes, 8, 8, device,
                                    shared=shared)
            for bg in (1, 4):
                kw = dict(lanes=lanes, block_groups=bg, shared_cache=shared)
                err = check_attention_once(
                    torch, args, kw, f"lanes={lanes} shared={shared} "
                    f"block_groups={bg}")
                print(f"kernel check: decode lanes={lanes} shared={shared} "
                      f"block_groups={bg} max|diff| {err:.3e}, bytes exact")
                name = ("decode_attention_pair" if lanes == 2
                        else "decode_attention_quad")
                errs[name] = max(errs.get(name, 0.0), err)
    return errs


def check_geometries(torch, rng, device) -> tuple[dict, dict]:
    """K3 and K6 at the reference's other head geometries (GEOMETRIES), B =
    8 sequences of 8 page groups: K3 within ATOL of its plain version with
    the bytes exact, and K6 on each sequence equal to K3's row under
    torch.equal.  Returns the largest |difference| by kernel name, and the
    inputs by geometry label for phase 7."""
    from repro_torch.kernels import cram_attention as ca

    errs, inputs = {}, {}
    for geometry in GEOMETRIES:
        page, hkv, hq, hd = geometry
        for lanes in (2, 4):
            kind = "pair" if lanes == 2 else "quad"
            label = f"page={page} Hkv={hkv} Hq={hq} head_dim={hd} {kind}"
            args = attention_inputs(torch, rng, lanes, 8, 8, device,
                                    geometry=geometry)
            kw = {"lanes": lanes}
            err = check_attention_once(torch, args, kw, label)
            out, _ = ca.cram_decode_attention_batched_cuda(*args, **kw)
            q, slots, strips, markers, valid, _ = args
            single = 0.0
            for i in range(q.shape[0]):
                one = (q[i].contiguous(), slots[i], strips[i], markers,
                       valid[i])
                got = ca.cram_decode_attention_cuda(*one, **kw)
                if not torch.equal(got, out[i]):
                    fail(f"K6 {label}: sequence {i} differs from K3's row")
                single = max(single, _close(
                    torch, f"K6 {label} sequence {i}", got,
                    ca.cram_decode_attention_plain(*one, **kw)))
            for name, e in ((f"decode_attention_{kind}", err),
                            (f"decode_single_{kind}", single)):
                errs[name] = max(errs.get(name, 0.0), e)
            inputs[label] = (lanes, args)
            print(f"kernel check: decode {label}: K3 max|diff| {err:.3e}, "
                  f"bytes exact; K6 max|diff| {single:.3e} and equal to K3's "
                  "row on each of 8 sequences")
    return errs, inputs


def delta_pages(torch, rng, lanes, lead, page, hkv, d2, device):
    """`lanes` int16 pages of shape lead + (page, Hkv, D2): every other
    group within the codec's delta range of its base row, the rest not."""
    import numpy as np

    g = int(np.prod(lead)) if lead else 1
    row = rng.integers(-3000, 3000, (g, 1, hkv, d2))
    spread = 100 if lanes == 2 else 6
    fits = np.arange(g) % 2 == 0
    pages = []
    for _ in range(lanes):
        noise = np.where(fits[:, None, None, None],
                         rng.integers(-spread, spread, (g, page, hkv, d2)),
                         rng.integers(-2**14, 2**14, (g, page, hkv, d2)))
        pages.append((row + noise).astype("int16"))
    pages[0][:, 0] = row[:, 0]                  # lane A's token-0 row
    return [torch.from_numpy(x.reshape(*lead, page, hkv, d2)).to(device)
            for x in pages]


def page_codec(lanes: int):
    """The registry's page codec of a `lanes`-page group (its pack_pages /
    unpack_pages are the group pack's plain versions)."""
    from repro_torch.compression import get_codec

    return get_codec("int8-delta" if lanes == 2 else "int4-delta")


def check_page_codecs(torch, rng, device) -> dict:
    """The page codecs' group pack (K1/K2) and unpack (K4/K5) against
    the registry's plain versions (`compression.pagepack`), bit-exact, at
    three shapes; pack -> unpack the identity on every fitting group.
    Returns the largest |difference| by kernel."""
    from repro_torch.kernels import bdi_pack

    errs = {}
    d2 = 2 * HEAD_DIM
    shapes = (((), PAGE, N_KV, d2), ((6,), PAGE, N_KV, d2),
              ((2, 3), 5, 3, 16))
    for lanes in (2, 4):
        plain_pack = page_codec(lanes).pack_pages
        plain_unpack = page_codec(lanes).unpack_pages
        for lead, page, hkv, dd in shapes:
            pages = delta_pages(torch, rng, lanes, lead, page, hkv, dd, device)
            packed, base, ok = bdi_pack.pack_pages_cuda(pages)
            torch.cuda.synchronize()
            ok_p, packed_p, base_p = plain_pack(*pages)
            if not (torch.equal(ok, ok_p) and torch.equal(packed, packed_p)
                    and torch.equal(base, base_p)):
                fail(f"group pack lanes={lanes} {lead}: differs from the "
                     "plain version")
            got = bdi_pack.unpack_pages_cuda(packed, base, lanes)
            torch.cuda.synchronize()
            for j, (a, b) in enumerate(zip(got, plain_unpack(packed, base),
                                           strict=True)):
                if not torch.equal(a, b):
                    fail(f"K{4 if lanes == 2 else 5} {lead} lane {j}: "
                         "differs from the plain version")
            g = ok.numel()
            fit = ok.reshape(g)
            for a, pg in zip(got, pages, strict=True):
                if not torch.equal(a.reshape(g, -1)[fit],
                                   pg.reshape(g, -1)[fit]):
                    fail(f"lanes={lanes} {lead}: pack -> unpack is not the "
                         "identity on a fitting group")
            print(f"kernel check: group pack + unpack lanes={lanes} groups "
                  f"{lead or '(1)'} of {(page, hkv, dd)} bit-exact, "
                  f"{int(fit.sum())}/{g} fit, round trip exact")
        tag = "pair" if lanes == 2 else "quad"
        errs[f"pack_{tag}_group"] = errs[f"unpack_{tag}"] = 0.0
    return errs


def scan_image(rng, n, key, plant: bool):
    """(n, 64) uint8 lines of every FPC/BDI family; with `plant`, each
    marker class at spread slots of `key`'s family.  Returns (lines,
    {slot: expected LineStatus})."""
    import numpy as np

    from repro_torch.compression.marker import LineStatus
    from repro_torch.kernels.compress_scan import (device_il_words,
                                                   device_markers)

    lines = rng.integers(0, 256, (n, 64)).astype(np.uint8)
    lines[0::7] = 0
    lines[1::7] = np.tile(rng.integers(0, 256, 8).astype(np.uint8), 8)
    for r, elems in ((2, (2**40 + rng.integers(-300, 300, (n, 8))).astype(
            "<i8")), (3, rng.integers(-100, 100, (n, 16)).astype("<i4")),
            (4, (1000 + rng.integers(-120, 120, (n, 32))).astype("<i2"))):
        k = len(lines[r::7])
        lines[r::7] = elems[:k].view(np.uint8).reshape(k, 64)
    want = {}
    if not plant:
        return lines, want
    classes = (LineStatus.COMP2, LineStatus.COMP4, LineStatus.INVALID,
               LineStatus.MAYBE_INVERTED, LineStatus.MAYBE_INVERTED,
               LineStatus.MAYBE_INVERTED)
    slots = np.linspace(1, n - 1, 4 * len(classes)).astype(np.int64)
    m2, m4 = device_markers(slots, key)
    il = device_il_words(slots, key)
    for i, slot in enumerate(slots):
        kind = i % len(classes)
        tail = (m2[i], m4[i], None, ~m2[i], ~m4[i], None)[kind]
        if tail is not None:
            lines[slot, -4:] = np.frombuffer(tail.tobytes(), np.uint8)
        else:
            words = il[i] if kind == 2 else ~il[i]
            lines[slot] = words.astype("<u4").view(np.uint8)
        want[int(slot)] = int(classes[kind])
    return lines, want


def boundary_image(rng, n, key):
    """(n, 64) uint8 lines that each sit at one edge of K7's rules,
    shuffled so that every warp of 32 lines mixes kinds: for each BDI mode
    (B, d) lines that fit it and lines one element past it, with immediates
    and deltas at -lim, -lim + 1, lim - 2, lim - 1 (lim = 2^(8d-1)), the
    base first, in the middle or last, bases at the element width's ends
    so that deltas wrap; FPC words at +-8, +-128, +-32768 and their
    neighbours, pad16, half-se8 and repb words, zero runs of 7, 8, 9 and 16
    words; rep8, all-zero and random lines; lines whose first word, first
    15 words or all 16 are slot i's Marker-IL words at `key`, or their
    complements."""
    import numpy as np

    from repro_torch.kernels.compress_scan import device_il_words

    def mode_lines(m, b, d, fit):
        # values as uint64, wrapping mod 2^64, cut to the element width
        k, lim, half = 64 // b, 1 << (8 * d - 1), 1 << (8 * b - 1)
        u64 = np.uint64
        edges = np.array([-lim, -lim + 1, lim - 2, lim - 1, 0, 1, -1])

        def near(size):  # an edge or a uniform draw from [-lim, lim)
            v = rng.integers(-lim, lim, size)
            pick = rng.random(size) < 0.5
            v[pick] = rng.choice(edges, int(pick.sum()))
            return v.astype(u64)

        pos = rng.choice([0, k // 2, k - 1], m)
        far = np.array([lim, -lim - 1, half - 1, -half, half - 2, lim + 1,
                        -lim - 2], dtype=np.int64)
        base = rng.choice(far, m)
        wide = rng.random(m) < 0.3        # or a uniform non-immediate draw
        draw = rng.integers(lim, half, m, dtype=np.int64)
        base[wide] = np.where(rng.random(int(wide.sum())) < 0.5, 1, -1) \
            * draw[wide]
        base = base.astype(u64)
        e = near((m, k))
        after = np.arange(k)[None, :] > pos[:, None]
        from_base = after & (rng.random((m, k)) < 0.7)
        e = np.where(from_base, base[:, None] + near((m, k)), e)
        rows = np.arange(m)
        e[rows, pos] = base
        if not fit:    # one later element (or the first) just out of reach
            j = np.minimum(pos + 1 + rng.integers(0, k, m) % (k - pos),
                           k - 1)
            j = np.where(pos == k - 1, 0, j)
            step = np.where(rng.random(m) < 0.5, lim, -lim - 1)
            e[rows, j] = base + step.astype(u64)
        return e.astype(f"<u{b}").view(np.uint8).reshape(m, 64)

    def fpc_lines(m):
        pool = np.array([0, 7, 8, -8, -9, 127, 128, -128, -129, 32767, 32768,
                         -32768, -32769, 0x70000, 0x12340000, 0x7FFF0000,
                         0x007FFF80, 0xFF80007F, 0x00800000, 0x0080FF7F,
                         0xABABABAB, 0x80808080, 0x7F7F7F7F, 0x01010101,
                         0x01010100, 1 << 31, -1], dtype=np.int64)
        w = rng.choice(pool, (m, 16))
        rand = rng.random((m, 16)) < 0.2
        w[rand] = rng.integers(0, 1 << 32, int(rand.sum()))
        run = rng.choice([0, 7, 8, 9, 16], m)
        start = rng.integers(0, 17, m) % (17 - run)
        cols = np.arange(16)[None, :]
        w[(cols >= start[:, None]) & (cols < (start + run)[:, None])] = 0
        return (w & 0xFFFFFFFF).astype("<u4").view(np.uint8).reshape(m, 64)

    kinds = [lambda m, b=b, d=d, f=f: mode_lines(m, b, d, f)
             for b, d in ((8, 1), (8, 2), (8, 4), (4, 1), (4, 2), (2, 1))
             for f in (True, False)]
    kinds += [fpc_lines, fpc_lines,
              lambda m: np.zeros((m, 64), np.uint8),
              lambda m: np.tile(rng.integers(0, 256, (m, 8)).astype(
                  np.uint8), (1, 8)),
              lambda m: rng.integers(0, 256, (m, 64)).astype(np.uint8)]
    per = -(-n // len(kinds))
    lines = np.concatenate([kind(per) for kind in kinds])
    lines = lines[rng.permutation(lines.shape[0])[:n]].copy()
    slots = rng.choice(n, min(n, max(1, n // 64)), replace=False)
    il = device_il_words(slots, key)
    words = lines.view("<u4")
    for s, row, how in zip(slots, il, rng.integers(0, 6, slots.size),
                           strict=True):
        row = row if how % 2 == 0 else ~row
        cut = (1, 15, 16)[how // 2]
        words[s, :cut] = row[:cut]
    return lines


def check_scan(torch, rng, device) -> dict:
    """K7 against its plain version on the card, bit-exact on all four
    outputs, at four image sizes and three keys, every marker class planted
    and each planted line's class held; then on 2^20 lines of the boundary
    image."""
    import numpy as np

    from repro_torch.compression.framing import DEFAULT_MARKER_KEY
    from repro_torch.compression.marker import LineStatus
    from repro_torch.kernels import compress_scan as cs

    for n, key, plant in ((1, DEFAULT_MARKER_KEY, False),
                          (301, 0xDEADBEEF, True),
                          (1024, DEFAULT_MARKER_KEY, True),
                          (2 ** 20, 0x1234ABCD, True),
                          (2 ** 20, 0xDEADBEEF, None)):
        if plant is None:
            lines, want = boundary_image(rng, n, key), {}
        else:
            lines, want = scan_image(rng, n, key, plant)
        img = torch.from_numpy(lines).to(device)
        got = cs.compress_scan_cuda(img, key=key)
        torch.cuda.synchronize()
        ref = cs.compress_scan_plain(img, key=key)
        for name in SCAN_OUTPUTS:
            if not torch.equal(got[name], ref[name]):
                bad = int((got[name] != ref[name]).sum())
                fail(f"K7 N={n} key={key:#x}: {name} differs from the plain "
                     f"version on {bad} lines")
        status = got["status"].cpu().numpy()
        for slot, cls in want.items():
            if status[slot] != cls:
                fail(f"K7 N={n}: planted slot {slot} classed {status[slot]}, "
                     f"expected {cls}")
        if plant and set(status.tolist()) != {int(c) for c in LineStatus}:
            fail(f"K7 N={n}: classes {sorted(set(status.tolist()))}, "
                 "expected every LineStatus")
        if n <= 4096 and not np.array_equal(
                status, cs.classify_image_ref(lines, key)):
            fail(f"K7 N={n}: status differs from classify_image_ref")
        bdi = np.unique(got["bdi"].cpu().numpy()).tolist()
        print(f"kernel check: scan N={n} key={key:#x}"
              f"{' boundary image' if plant is None else ''} bit-exact on 4 "
              f"outputs, {len(want)} planted lines classed as expected, "
              f"status counts {np.bincount(status, minlength=5).tolist()}, "
              f"BDI payloads {bdi}")
    return {"compress_scan": 0.0}


def check_single_decode(torch, rng, device) -> dict:
    """K6 against its plain version within atol = rtol = ATOL at four slot
    counts (three not a multiple of the lanes) over one sequence's physical
    view; sequence 1 has no valid token."""
    from repro_torch.kernels import cram_attention as ca

    errs = {}
    for lanes in (2, 4):
        q, slots, strips, markers, valid, _ = attention_inputs(
            torch, rng, lanes, 3, 4, device)
        n_all = slots.shape[1]
        for seq, n in ((0, n_all), (1, n_all - 1), (2, n_all - 3), (0, 1)):
            args = [x[:n].contiguous() for x in (slots[seq], strips[seq],
                                                 markers, valid[seq])]
            out = ca.cram_decode_attention_cuda(q[seq].contiguous(), *args,
                                                lanes=lanes)
            torch.cuda.synchronize()
            ref = ca.cram_decode_attention_plain(q[seq], *args, lanes=lanes)
            label = f"K6 lanes={lanes} n={n} seq={seq}"
            if not torch.isfinite(out).all():
                fail(f"{label}: non-finite output")
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL):
                fail(f"{label}: max |diff| {err:.3e} beyond atol=rtol={ATOL}")
            name = f"decode_single_{'pair' if lanes == 2 else 'quad'}"
            errs[name] = max(errs.get(name, 0.0), err)
            print(f"kernel check: single decode lanes={lanes} n={n} "
                  f"(valid tokens {int(args[3].sum())}) max|diff| {err:.3e}")
    return errs


# ------------------------------------------------------- phases 3, 4 and 5

def _timed(torch, walls: dict, outs: dict, name: str, fn):
    """fn, with its wall time (ended by a device synchronise) added to
    walls[name] and its last result kept in outs[name]."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        outs[name] = fn(*args, **kw)
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return outs[name]
    return wrapped


def weight_bytes(tree) -> int:
    """Bytes of the tensors a decode step reads: the model's weights in
    the compute dtype (every expert's, since each has a capacity row;
    whisper's decoder positions, of which a step reads one row, left
    out)."""
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for k, v in tree.items()
                   if k != "pos_dec")
    if isinstance(tree, list):
        return sum(weight_bytes(v) for v in tree)
    return 0 if tree is None else nbytes(tree)


def check_logits(torch, model, batch: int, label: str) -> None:
    """One decode step of the launcher's model from a fresh cache: the
    logits must be (batch, vocab) and finite."""
    tok = torch.zeros((batch, 1), dtype=torch.int64,
                      device=model.embed.device)
    logits = model.decode_step(tok, model.init_cache(batch, 1), 0)
    if (tuple(logits.shape) != (batch, model.config.vocab)
            or not torch.isfinite(logits).all()):
        fail(f"launcher {label}: decode logits {tuple(logits.shape)}, "
             f"finite {bool(torch.isfinite(logits).all())}")


def decode_device_ms(torch, model, batch: int, steps: int = 4):
    """Device time of one greedy decode step of `model` from
    torch.profiler (the kernels' own durations), or None when the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(batch, steps + 1)
    tok = torch.zeros((batch, 1), dtype=torch.int64,
                      device=model.embed.device)
    model.decode_step(tok, cache, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, steps + 1):
            model.decode_step(tok, cache, i)
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us * 1e-3 / steps if dev_us else None


LAUNCHER_ARGV = ["--arch", "phi4_mini_3_8b", "--no-smoke", "--batch", "4",
                 "--prompt-len", "32", "--gen", "32"]
# the README's serve command (`--slots` below `--batch`: the spill tier)
SPILL_ARGV = ["--slots", "2", "--admit-rate", "4", "--spill-pages", "64"]


def run_launcher(torch, label: str, argv: list, *, config=None,
                 profile: bool = True) -> dict:
    """The serve launcher with `argv` (and `config`, a depth-cut config,
    where given); returns its report with the wall seconds of model
    build, model prefill + decode and serve tier under "walls" (and, with
    `profile`, the device time of one decode step) and the peak device
    memory of the run.  Every sequence must be admitted and retired, and
    with `--slots` below the batch the serve tier must have evicted and
    woken, and the ledger's kv-evict / kv-restore spill rows must count
    the crossings.  A model with no attention cache (the ssm family) has
    no serve tier: its report must say so and book no traffic.  One more
    decode step of the model must give finite (batch, vocab) logits.
    Whisper has no serve tier either, as under the reference's launcher."""
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    walls: dict = {}
    outs: dict = {}
    parts = {"build": serve.build, "_timed_decode": serve._timed_decode,
             "_serve_tier": serve._serve_tier}
    for name, fn in parts.items():
        setattr(serve, name, _timed(torch, walls, outs, name, fn))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            report = serve.main(argv, config=config)
    finally:
        for name, fn in parts.items():
            setattr(serve, name, fn)
    step_ms = 1e3 * report["batch"] / report["tokens_per_s"]
    model = outs.pop("build")
    report["weights_read_gb"] = weight_bytes(model.decode_weights()) / 1e9
    check_logits(torch, model, report["batch"], label)
    dev_ms = decode_device_ms(torch, model, report["batch"]) if profile \
        else None
    del model
    report["walls"] = {"model_build_s": walls["build"],
                       "model_prefill_decode_s": walls["_timed_decode"],
                       "serve_tier_s": walls.get("_serve_tier"),
                       "decode_step_ms": step_ms,
                       "decode_step_device_ms": dev_ms,
                       "decode_device_busy_share": (
                           None if dev_ms is None else dev_ms / step_ms)}
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for key in ("prefill_tokens_per_s", "tokens_per_s"):
        if not math.isfinite(report[key]) or report[key] <= 0:
            fail(f"launcher {label}: {key} = {report[key]}")
    st = report["serve_tier"]
    # no serve tier: the ssm family (no attention cache) and whisper (as in
    # the reference's launcher)
    ssm = config is not None and config.family in ("ssm", "encdec")
    if (st is None) != ssm or (ssm and report["traffic"]):
        fail(f"launcher {label}: serve tier {st}, traffic "
             f"{report['traffic']}")
    if st is None:
        return report
    if not (st["admitted"] == st["retired"] == report["batch"]):
        fail(f"launcher {label}: admitted {st['admitted']} retired "
             f"{st['retired']}")
    rows = [row for tc in report["traffic"].values() for ev in tc.values()
            for row in ev.values()]
    if not rows or any(v < 0 for row in rows for v in row.values()):
        fail(f"launcher {label}: missing or negative ledger rows ("
             f"accumulator overflow): {report['traffic']}")
    if "--slots" in argv:
        kv = report["traffic"].get("kv", {})
        spilled = {d: kv.get(f"kv-{d}", {}).get("spill", {}).get("count", 0)
                   for d in ("evict", "restore")}
        if st["evicted"] <= 0 or st["woken"] <= 0:
            fail(f"launcher {label}: evicted {st['evicted']} woken "
                 f"{st['woken']}, expected both > 0")
        if (spilled["evict"] != st["evicted"] + st["spilled_direct"]
                or spilled["restore"] != st["woken"]):
            fail(f"launcher {label}: spill rows {spilled} against evicted "
                 f"{st['evicted']} + spilled_direct {st['spilled_direct']}, "
                 f"woken {st['woken']}")
    return report


# the model zoo's families at full width (phase 3): path -> (arch, layers
# kept (None: the published depth), launcher flags).  Vision and maverick
# keep one super-block: at full depth 90 B and 400 B parameters do not fit
# one 80 GB card.
ZOO_ARGV = ["--no-smoke", "--batch", "4", "--prompt-len", "32", "--gen", "32"]
ZOO_RUNS = {
    "zoo_olmoe_pair": ("olmoe_1b_7b", None, ["--kv-packing", "pair"]),
    "zoo_olmoe_quad_spill": ("olmoe_1b_7b", None, [
        "--slots", "2", "--admit-rate", "4", "--kv-policy", "dynamic",
        "--kv-packing", "quad", "--spill-packing", "pair",
        "--spill-pages", "64"]),
    "zoo_zamba2_pair": ("zamba2_2_7b", None, ["--kv-packing", "pair"]),
    "zoo_mamba2": ("mamba2_130m", None, []),
    "zoo_vision_pair": ("llama_3_2_vision_90b", 5, ["--kv-packing", "pair"]),
    "zoo_maverick_pair": ("llama4_maverick_400b_a17b", 2,
                          ["--kv-packing", "pair"]),
}


ZOO_PARITY_STEPS = 4


def check_zoo_decode(torch, device) -> dict:
    """Each decoder arch at smoke size in float32 (the size the CPU tests
    hold against the reference), on the same random weights on the CPU
    and on the card: ZOO_PARITY_STEPS decode steps fed the CPU's greedy
    tokens (the vlm with its cross gates opened, with and without image
    embeddings), logits within atol = rtol = 1e-4 and the greedy tokens
    equal, and a second run on the card bit-identical to the first (the
    MoE's dispatch and combine are deterministic).  Also the MoE
    router's ties on the card: the lower expert index first.  Returns the
    largest |difference| by arch."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.models.moe import moe_route

    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25] * 4], device=device)
    if moe_route(probs, 2, 2).eidx.tolist() != [[1, 2], [0, 1]]:
        fail("zoo: the MoE router broke a tie towards a higher expert")
    errs = {}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke(arch)
        if cfg.family == "encdec":      # check_whisper_parity
            continue
        params = build(cfg, device="cpu", seed=0).state_dict()
        for name in params:         # open the vlm's cross gates
            if name.endswith(".gate"):
                params[name] = torch.tensor(0.7)
        cpu = build(cfg, device="cpu", params=params)
        card = build(cfg, device=device, params=params)
        rng = np.random.default_rng(5)
        b = 4
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)))
        kw = [{}]
        if cfg.family == "vlm":
            kw.append({"image_embeds": torch.from_numpy(rng.standard_normal(
                (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))})
        err = 0.0
        for k in kw:
            k_card = {n: t.to(device) for n, t in k.items()}
            caches = [m.init_cache(b, ZOO_PARITY_STEPS)
                      for m in (cpu, card, card)]
            t = tok
            for i in range(ZOO_PARITY_STEPS):
                want = cpu.decode_step(t, caches[0], i, **k)
                got = [card.decode_step(t.to(device), c, i, **k_card)
                       for c in caches[1:]]
                if not torch.equal(got[0], got[1]):
                    fail(f"zoo {arch}: two card runs differ at step {i}")
                got = got[0].cpu()
                err = max(err, (got - want).abs().max().item())
                if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
                    fail(f"zoo {arch}: step {i} logits differ from the "
                         f"CPU's by {err:.3e}")
                t = torch.argmax(want, -1, keepdim=True)
                if not torch.equal(torch.argmax(got, -1, keepdim=True), t):
                    fail(f"zoo {arch}: step {i} greedy tokens differ")
        errs[arch] = err
        images = " with and without images" if len(kw) > 1 else ""
        print(f"zoo parity: {arch} ({cfg.family}, smoke size, float32): "
              f"{ZOO_PARITY_STEPS} steps{images}, max|diff| {err:.3e} "
              "against the CPU, greedy tokens equal, two card runs "
              "bit-identical")
    return errs


def run_zoo(torch, path: str, card: str) -> dict:
    """One zoo path through the launcher, with random weights, at the
    published width and the depth ZOO_RUNS keeps; prints its line and
    frees the card."""
    import gc

    from repro_torch import configs
    from repro_torch.models import count_params

    arch, layers, flags = ZOO_RUNS[path]
    full = configs.get(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    t0 = time.perf_counter()
    r = run_launcher(torch, path, ["--arch", arch] + ZOO_ARGV + flags,
                     config=cfg, profile="--slots" not in flags)
    gc.collect()
    torch.cuda.empty_cache()
    depth = (f"{cfg.n_layers} layers" if layers is None else
             f"{cfg.n_layers} of {full.n_layers} layers (depth cut)")
    r["zoo"] = {"arch": arch, "n_layers": cfg.n_layers,
                "published_layers": full.n_layers,
                "params": count_params(cfg),
                "param_dtype": str(cfg.param_dtype), "flags": flags}
    walls, st = r["walls"], r["serve_tier"]
    tier_s = walls["serve_tier_s"]
    tier = "none (no attention cache)" if st is None else ", ".join(
        f"{k} {st[k]}" for k in ("admitted", "retired", "evicted", "woken",
                                 "spilled_direct", "serve_steps",
                                 "hot_packing", "decode_saving"))
    print(f"zoo {path}: {arch}, {depth}, {r['zoo']['params'] / 1e9:.3f} B "
          f"params ({r['zoo']['param_dtype']}), peak memory "
          f"{r['peak_memory_gb']:.2f} GB; weights read a step "
          f"{r['weights_read_gb']:.3f} GB, bound "
          f"{r['weights_read_gb'] * 1e12 / HBM_BYTES_PER_S:.3f} ms; "
          f"{time.perf_counter() - t0:.1f} s "
          f"(model build {walls['model_build_s']:.2f} s, model prefill + "
          f"decode {walls['model_prefill_decode_s']:.3f} s, serve tier "
          f"{'none' if tier_s is None else f'{tier_s:.3f} s'}); decode step "
          f"{walls['decode_step_ms']:.2f} ms, of it on the device "
          f"{walls['decode_step_device_ms']} ms, busy share "
          f"{walls['decode_device_busy_share']}; decode {r['tokens_per_s']} "
          f"tokens/s, prefill {r['prefill_tokens_per_s']} tokens/s; serve "
          f"tier: {tier}; card {card}")
    return r


# ------------------------------------------------- phase 3: training

BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
# full-width training runs: path -> (arch, train steps, layers kept (None:
# the published depth)); batch TRAIN_BATCH x TRAIN_SEQ tokens, the
# config's own microbatches and remat, bf16 compute, float32 params and
# moments
TRAIN_RUNS = {"train_phi4": ("phi4_mini_3_8b", 3, None),
              "train_zamba2": ("zamba2_2_7b", 2, None)}
TRAIN_BATCH, TRAIN_SEQ = 4, 256
# the README's training example (its checkpoint directory is added)
TRAIN_LAUNCHER_ARGV = ["--preset", "lm20m", "--steps", "300", "--batch",
                       "8", "--ckpt-every", "50", "--inject-fault", "150"]
TRAIN_FAULT_STEP = 150
TRAIN_PARITY_STEPS = 3


def _free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _step_device_ms(torch, prof) -> tuple[float | None, dict]:
    """A profiled step's device time (ms) and its split by kernel kind:
    {kind: [ms, kernels]}, kinds by the kernel's name."""
    kinds = (("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
             ("reduction", ("reduce", "softmax", "norm")),
             ("elementwise", ("elementwise", "vectorized", "unrolled")),
             ("copy / index", ("copy", "memcpy", "memset", "index",
                               "gather", "scatter", "cat")))
    split: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = next((k for k, subs in kinds if any(x in name for x in subs)),
                    "other")
        row = split.setdefault(kind, [0.0, 0])
        row[0] += e.self_device_time_total * 1e-3
        row[1] += e.count
    total = sum(v[0] for v in split.values())
    return (total or None), split


def train_full_width(torch, path: str, card: str) -> dict:
    """TRAIN_RUNS[path]: random weights (a seeded torch.Generator) at the
    published width, `make_train_step` on one synthetic batch repeated
    each step; per step the loss, gnorm, wall (ended by a synchronise),
    device time (torch.profiler, the kernels' own durations), busy share,
    peak device memory, and the AdamW update's synchronised wall beside
    its byte bound (28 B a parameter: read param, grad, m, v, write
    param, m, v, in float32).  The loss must be finite; with three or
    more steps it must fall.  The card is freed after."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build, count_params
    from repro_torch.optim import adamw

    arch, steps, layers = TRAIN_RUNS[path]
    full = configs.get(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device="cuda", seed=0)
    state = adamw.adamw_init(model, cfg.optimizer_dtype)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    state_gb = torch.cuda.memory_allocated() / 1e9
    batch = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        family=cfg.family, d_model=cfg.d_model,
        n_image_tokens=cfg.n_image_tokens)).batch(0)
    step = adamw.make_train_step(model, lr_peak=1e-2, lr_total=steps)
    flops = 6 * count_params(cfg) * TRAIN_BATCH * TRAIN_SEQ
    opt_bound_ms = 28 * n_params / HBM_BYTES_PER_S * 1e3
    opt_ms: list = []
    update = adamw._update

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*a, **kw)
        torch.cuda.synchronize()
        opt_ms.append(1e3 * (time.perf_counter() - t))
        return out

    depth = (f"{cfg.n_layers} layers" if layers is None else
             f"{cfg.n_layers} of {full.n_layers} layers (depth cut)")
    print(f"train {path}: {arch}, {depth}, {n_params / 1e9:.3f} B params "
          f"({count_params(cfg) / 1e9:.3f} B counted), batch {TRAIN_BATCH} "
          f"x seq {TRAIN_SEQ}, microbatches {cfg.microbatches}, remat "
          f"{cfg.remat}, compute {cfg.dtype}, params {cfg.param_dtype}, "
          f"moments {cfg.optimizer_dtype}; build {build_s:.2f} s, state "
          f"{state_gb:.2f} GB; model FLOPs a step 6 N tokens = "
          f"{flops / 1e12:.2f} TFLOP; card {card}")
    rows = []
    adamw._update = timed_update
    try:
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats()
            # the card's activity only: recording the host's ops of a
            # step (tens of thousands) would add seconds to its wall
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                state, m = step(state, batch)
                loss, gnorm = float(m["loss"]), float(m["gnorm"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            dev, split = _step_device_ms(torch, prof)
            row = {"step": i, "loss": loss, "gnorm": gnorm,
                   "wall_ms": wall * 1e3, "device_ms": dev,
                   "busy_share": None if dev is None else dev / (wall * 1e3),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "adamw_ms": opt_ms[-1],
                   "adamw_share": opt_ms[-1] / (wall * 1e3),
                   "bf16_peak_share": flops / (wall * BF16_PEAK_FLOPS)}
            rows.append(row)
            print(f"train {path}: step {i} loss {loss:.6f} gnorm "
                  f"{gnorm:.4f}; wall {row['wall_ms']:.1f} ms (under the "
                  f"profiler), device {dev if dev is None else round(dev, 1)}"
                  f" ms, busy share {row['busy_share']}; peak memory "
                  f"{row['peak_memory_gb']:.2f} GB; model FLOPs "
                  f"{row['bf16_peak_share']:.4f} of the bf16 peak; AdamW "
                  f"{opt_ms[-1]:.1f} ms ({row['adamw_share']:.3f} of the "
                  f"step), byte bound {opt_bound_ms:.1f} ms "
                  f"(28 B x {n_params} params at 3.35 TB/s); card {card}")
        row["device_split"] = split
        print(f"train {path}: step {steps - 1} device time by kernel kind, "
              "ms (kernels): " + ", ".join(
                  f"{k} {v[0]:.1f} ({v[1]})" for k, v in sorted(
                      split.items(), key=lambda kv: -kv[1][0])))
    finally:
        adamw._update = update
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train {path}: losses {losses}")
    if steps >= 3 and not losses[-1] < losses[0]:
        fail(f"train {path}: the loss did not fall: {losses}")
    del model, state, step, m
    _free_card(torch)
    return {"arch": arch, "n_layers": cfg.n_layers,
            "published_layers": full.n_layers, "params": n_params,
            "counted_params": count_params(cfg), "build_s": build_s,
            "state_gb": state_gb, "model_tflop": flops / 1e12,
            "adamw_bound_ms": opt_bound_ms, "steps": rows}


def train_launcher_phase(torch, card: str, ckpt_dir: str) -> dict:
    """The README's training example through the launcher on the card
    (the default `cram` codec), checkpointing into `ckpt_dir` (which the
    multi-device phase restores from): 300 steps, a fault at step 150,
    one restart from the checkpoint of step 150.  The report must say
    every step ran, with one restart and the loss fallen; the state the
    restart restored must equal, bit for bit, the state saved at step 150
    (host copies of both); prints each committed manifest's raw and
    stored bytes and the mean step time."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.runtime import ft

    saved, restored = {}, []
    save_async, restore_into = ckpt.CheckpointManager.save_async, \
        ft.restore_into

    def keep_save(mgr, step, tree):
        if step == TRAIN_FAULT_STEP:
            saved["state"] = ckpt._host_copy(tree)
        return save_async(mgr, step, tree)

    def keep_restore(state, rest):
        out = restore_into(state, rest)
        restored.append(ckpt._host_copy(out))
        return out

    ckpt.CheckpointManager.save_async = keep_save
    ft.restore_into = keep_restore
    buf = io.StringIO()
    try:
        tmp = ckpt_dir
        with contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            report = train.main(TRAIN_LAUNCHER_ARGV + [
                "--ckpt-dir", tmp, "--json-out", f"{tmp}/report.json"])
            wall = time.perf_counter() - t0
            losses = json.loads(pathlib.Path(
                f"{tmp}/report.json").read_text())["losses"]
            manifests = {s: ckpt.read_manifest(tmp, s) for s in sorted(
                int(p.name.split("_")[1])
                for p in pathlib.Path(tmp).glob("step_*"))}
    finally:
        ckpt.CheckpointManager.save_async = save_async
        ft.restore_into = restore_into
    steps = int(TRAIN_LAUNCHER_ARGV[TRAIN_LAUNCHER_ARGV.index("--steps") + 1])
    if report["steps"] != steps or report["restarts"] != 1:
        fail(f"train launcher: {report}")
    if not report["loss_last10"] < report["loss_first10"]:
        fail(f"train launcher: the loss did not fall: {report}")
    if len(restored) != 1 or "state" not in saved:
        fail(f"train launcher: {len(restored)} restores, step "
             f"{TRAIN_FAULT_STEP} saved: {'state' in saved}")
    want, got = saved["state"], restored[0]
    for f in ("params", "m", "v"):
        a, b = getattr(want, f), getattr(got, f)
        if a.keys() != b.keys() or not all(torch.equal(a[k], b[k])
                                           for k in a):
            fail(f"train launcher: restored {f} differ from the state "
                 f"saved at step {TRAIN_FAULT_STEP}")
    for f in ("step", "dyn_counter"):
        if not torch.equal(getattr(want, f), getattr(got, f)):
            fail(f"train launcher: restored {f} differs")
    sizes = {s: {"raw_bytes": sum(x["raw_bytes"] for x in m["leaves"]),
                 "stored_bytes": sum(x["stored_bytes"] for x in m["leaves"]),
                 "codecs": sorted({x["codec"] for x in m["leaves"]})}
             for s, m in manifests.items()}
    print(f"train launcher: {' '.join(TRAIN_LAUNCHER_ARGV)}: steps "
          f"{report['steps']}, restarts {report['restarts']}, loss_first10 "
          f"{report['loss_first10']}, loss_last10 {report['loss_last10']}, "
          f"straggler_flags {report['straggler_flags']}, mean_step_ms "
          f"{report['mean_step_ms']}, wall {wall:.1f} s; card {card}")
    print(f"train launcher: state restored at step {TRAIN_FAULT_STEP} "
          f"bit-exact against the state saved there "
          f"({sum(t.numel() for t in want.params.values())} params, "
          f"moments, step, dyn_counter)")
    for s, z in sizes.items():
        print(f"train launcher: checkpoint step {s}: raw {z['raw_bytes']} "
              f"B, stored {z['stored_bytes']} B "
              f"({z['stored_bytes'] / z['raw_bytes']:.4f} of raw), codecs "
              f"{z['codecs']}")
    return {"report": report, "wall_s": wall, "losses": losses,
            "checkpoints": sizes}


def check_train_parity(torch, device) -> dict:
    """Each decoder arch at smoke size in float32: TRAIN_PARITY_STEPS
    train steps on the CPU and twice on the card from the same weights
    (the vlm's cross gates opened) on the same synthetic batches; the
    card's losses and final parameters within atol = rtol = 1e-4 of the
    CPU's, a decode step after training within 1e-4, and the two card
    runs equal under torch.equal.  Returns the largest |difference| by
    arch."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim import adamw_init, make_train_step

    errs = {}
    for arch in configs.ARCHS:
        cfg = configs.get_smoke(arch)
        if cfg.family == "encdec":      # check_whisper_parity
            continue
        params = build(cfg, device="cpu", seed=0).state_dict()
        for name in params:
            if name.endswith(".gate"):
                params[name] = torch.tensor(0.7)
        data = SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=64, global_batch=2, family=cfg.family,
            d_model=cfg.d_model, n_image_tokens=cfg.n_image_tokens))
        tok = torch.from_numpy(
            np.random.default_rng(5).integers(0, cfg.vocab, (2, 1)))
        runs = []
        for dev in ("cpu", device, device):
            model = build(cfg, device=dev,
                          params={k: v.clone() for k, v in params.items()})
            state = adamw_init(model)
            step = make_train_step(model, lr_peak=1e-2)
            losses = []
            for i in range(TRAIN_PARITY_STEPS):
                state, m = step(state, data.batch(i))
                losses.append(m["loss"].detach().cpu())
            logits = model.decode_step(tok.to(dev), model.init_cache(2, 1),
                                       0).cpu()
            runs.append((torch.stack(losses), {
                k: p.detach().cpu() for k, p in model.named_parameters()},
                logits))
        (l_cpu, p_cpu, d_cpu), (l_a, p_a, d_a), (l_b, p_b, d_b) = runs
        if not (torch.equal(l_a, l_b) and torch.equal(d_a, d_b)
                and all(torch.equal(p_a[k], p_b[k]) for k in p_a)):
            fail(f"train parity {arch}: two card runs differ")
        pairs = [(l_a, l_cpu), (d_a, d_cpu)] + [(p_a[k], p_cpu[k])
                                                for k in p_cpu]
        err = max((a - b).abs().max().item() for a, b in pairs)
        if not all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                   for a, b in pairs):
            fail(f"train parity {arch}: the card differs from the CPU by "
                 f"{err:.3e}")
        errs[arch] = err
        print(f"train parity: {arch} ({cfg.family}, smoke size, float32): "
              f"{TRAIN_PARITY_STEPS} train steps, losses "
              f"{[round(float(x), 6) for x in l_a]}, max|diff| {err:.3e} "
              "against the CPU (losses, params, decode logits after "
              "training), two card runs bit-identical")
    return errs


# --------------------------------------- whisper-base, the encdec family

WHISPER = "whisper_base"
WHISPER_PARITY_STEPS = 4
WHISPER_ENC_LEN = 32
# the train launcher at Whisper's decoder context (448 tokens); its final
# checkpoint (1.05 GB of float32 state) in the raw codec, which writes it
# in seconds where the cram codec's host encoder takes tens of them
WHISPER_TRAIN_ARGV = ["--arch", WHISPER, "--steps", "3", "--batch", "8",
                      "--seq", "448", "--ckpt-every", "50", "--codec", "raw"]


def check_whisper_parity(torch, device) -> float:
    """Whisper at smoke size in float32 (2 + 2 layers), on the same
    weights on the CPU and twice on the card: one train step on a
    synthetic batch with frames, then the encoder over frames,
    `prefill_cross` and WHISPER_PARITY_STEPS greedy decode steps fed the
    CPU's tokens; loss, parameters, encoder output, cross K/V and logits
    within atol = rtol = 1e-4, greedy tokens equal, the two card runs
    bit-identical.  Returns the largest |difference|."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import build
    from repro_torch.models.whisper import init_whisper
    from repro_torch.optim import adamw_init, make_train_step

    cfg = configs.get_smoke(WHISPER)
    params = init_whisper(cfg, 0, "cpu")
    batch = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=64, global_batch=2, family=cfg.family,
        d_model=cfg.d_model)).batch(0)
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, WHISPER_ENC_LEN, cfg.d_model)).astype(np.float32))
    runs, feed = [], None            # feed: the CPU's input tokens
    for dev in ("cpu", device, device):
        model = build(cfg, device=dev,
                      params={k: v.clone() for k, v in params.items()})
        state = adamw_init(model)
        state, m = make_train_step(model, lr_peak=1e-2)(state, batch)
        enc = model.encode(frames.to(dev))
        cache = model.prefill_cross(enc, model.init_cache(
            4, WHISPER_PARITY_STEPS, enc_len=WHISPER_ENC_LEN))
        tok = torch.zeros((4, 1), dtype=torch.int64)
        inputs, logits, greedy = [], [], []
        for i in range(WHISPER_PARITY_STEPS):
            inputs.append(tok if feed is None else feed[i])
            out = model.decode_step(inputs[-1].to(dev), cache, i).cpu()
            logits.append(out)
            greedy.append(torch.argmax(out, -1, keepdim=True))
            tok = greedy[-1]
        feed = feed or inputs
        runs.append({"loss": m["loss"].detach().cpu()[None],
                     "enc": enc.detach().cpu(),
                     "xk": cache["xk"].cpu(), "xv": cache["xv"].cpu(),
                     "logits": torch.stack(logits),
                     "greedy": torch.stack(greedy),
                     **{k: p.detach().cpu()
                        for k, p in model.named_parameters()}})
    cpu, a, b = runs
    if not all(torch.equal(a[k], b[k]) for k in a):
        fail("whisper parity: two card runs differ")
    if not torch.equal(a["greedy"], cpu["greedy"]):
        fail("whisper parity: greedy tokens differ from the CPU's")
    err = max((a[k] - cpu[k]).abs().max().item() for k in cpu
              if k != "greedy")
    if not all(torch.allclose(a[k], cpu[k], atol=1e-4, rtol=1e-4)
               for k in cpu if k != "greedy"):
        fail(f"whisper parity: the card differs from the CPU by {err:.3e}")
    print(f"whisper parity: {WHISPER} (encdec, smoke size, float32, "
          f"{cfg.enc_layers} + {cfg.dec_layers} layers): one train step "
          f"(loss {float(a['loss']):.6f}), encoder over {WHISPER_ENC_LEN} "
          f"frames, prefill_cross and {WHISPER_PARITY_STEPS} decode steps, "
          f"max|diff| {err:.3e} against the CPU (loss, params, encoder "
          "output, cross K/V, logits), greedy tokens equal, two card runs "
          "bit-identical")
    return err


def whisper_train_phase(torch, card: str) -> dict:
    """The train launcher on whisper-base at its published width and
    depth (6 + 6 layers, random weights: the reference's draws for
    `--seed 0`) for 3 steps at batch 8 x `--seq 448` (the decoder's
    context; the pipeline's frames are 448 x 512), the config's
    microbatches (4) and remat, bf16 compute, a raw checkpoint at the
    end: per step the loss, wall, device time
    (torch.profiler, the kernels' own durations; the launcher's step
    times include the profiler's start and stop), busy share and peak
    device memory, and the final checkpoint's wall and bytes.  Every
    step must run, and the losses be finite."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train
    from repro_torch.models import count_params

    _free_card(torch)
    rows, profs, saves = [], [], []
    make_step, save_async = train.make_train_step, \
        ckpt.CheckpointManager.save_async

    def profiled_steps(model, **kw):
        step = make_step(model, **kw)

        def run(state, batch):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                state, m = step(state, batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            profs.append(prof)
            rows.append({"loss": loss, "wall_ms": wall,
                         "peak_memory_gb":
                             torch.cuda.max_memory_allocated() / 1e9})
            return state, m
        return run

    def timed_save(mgr, step, tree):
        t = time.perf_counter()
        save_async(mgr, step, tree)
        mgr.wait()
        saves.append((step, time.perf_counter() - t))

    train.make_train_step = profiled_steps
    ckpt.CheckpointManager.save_async = timed_save
    buf = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            report = train.main(WHISPER_TRAIN_ARGV + ["--ckpt-dir", tmp])
            wall = time.perf_counter() - t0
            manifest = ckpt.read_manifest(tmp, saves[-1][0])
    finally:
        train.make_train_step = make_step
        ckpt.CheckpointManager.save_async = save_async
    for r, prof in zip(rows, profs, strict=True):
        r["device_ms"], r["device_split"] = _step_device_ms(torch, prof)
        r["busy_share"] = (None if r["device_ms"] is None
                           else r["device_ms"] / r["wall_ms"])
    raw = sum(x["raw_bytes"] for x in manifest["leaves"])
    stored = sum(x["stored_bytes"] for x in manifest["leaves"])
    cfg = configs.get(WHISPER)
    steps = int(WHISPER_TRAIN_ARGV[WHISPER_TRAIN_ARGV.index("--steps") + 1])
    if report["steps"] != steps or len(rows) != steps or \
            not all(math.isfinite(r["loss"]) for r in rows):
        fail(f"whisper train: {report}, {len(rows)} steps profiled")
    print(f"whisper train: {WHISPER} through the train launcher, "
          f"{cfg.enc_layers} + {cfg.dec_layers} layers, "
          f"{count_params(cfg) / 1e6:.1f} M params counted, "
          f"{' '.join(WHISPER_TRAIN_ARGV)}: microbatches "
          f"{cfg.microbatches}, remat {cfg.remat}, compute {cfg.dtype}; "
          f"launcher wall {wall:.1f} s, of it the final checkpoint "
          f"{saves[-1][1]:.1f} s ({raw} B raw, {stored} B stored, "
          f"{stored / raw:.4f}); mean_step_ms {report['mean_step_ms']} "
          f"(with the profiler's start and stop); card {card}")
    for i, r in enumerate(rows):
        print(f"whisper train: step {i} loss {r['loss']:.6f}; wall "
              f"{r['wall_ms']:.1f} ms (under the profiler), device "
              f"{r['device_ms'] if r['device_ms'] is None else round(r['device_ms'], 1)}"
              f" ms, busy share {r['busy_share']}; peak memory "
              f"{r['peak_memory_gb']:.2f} GB; card {card}")
    print("whisper train: last step's device time by kernel kind, ms "
          "(kernels): " + ", ".join(
              f"{k} {v[0]:.1f} ({v[1]})" for k, v in sorted(
                  rows[-1]["device_split"].items(), key=lambda kv: -kv[1][0])))
    _free_card(torch)
    return {"report": report, "wall_s": wall, "steps": rows,
            "checkpoint": {"step": saves[-1][0], "wall_s": saves[-1][1],
                           "raw_bytes": raw, "stored_bytes": stored}}


def whisper_serve_phase(torch, card: str) -> dict:
    """The serve launcher on whisper-base at its published width and
    depth (random weights), batch 4, prompt 32, 32 generated: as the
    reference's launcher, the decode runs against the zero cross K/V of
    `init_cache` and there is no serve tier and no traffic.  Prints its
    walls, the decode step's device time and busy share, and peak
    memory."""
    from repro_torch import configs
    from repro_torch.models import count_params

    cfg = configs.get(WHISPER)
    t0 = time.perf_counter()
    r = run_launcher(torch, "whisper_serve", ["--arch", WHISPER] + ZOO_ARGV,
                     config=cfg)
    _free_card(torch)
    walls = r["walls"]
    print(f"whisper serve: {WHISPER}, {cfg.enc_layers} + {cfg.dec_layers} "
          f"layers, {count_params(cfg) / 1e6:.1f} M params counted "
          f"({cfg.param_dtype}), {' '.join(ZOO_ARGV)}: peak memory "
          f"{r['peak_memory_gb']:.2f} GB; weights read a step "
          f"{r['weights_read_gb']:.4f} GB, bound "
          f"{r['weights_read_gb'] * 1e12 / HBM_BYTES_PER_S:.4f} ms; "
          f"{time.perf_counter() - t0:.1f} s (model build "
          f"{walls['model_build_s']:.2f} s, model prefill + decode "
          f"{walls['model_prefill_decode_s']:.3f} s); decode step "
          f"{walls['decode_step_ms']:.2f} ms, of it on the device "
          f"{walls['decode_step_device_ms']} ms, busy share "
          f"{walls['decode_device_busy_share']}; decode {r['tokens_per_s']} "
          f"tokens/s, prefill {r['prefill_tokens_per_s']} tokens/s; "
          f"serve_tier {r['serve_tier']}, traffic {r['traffic']}; sample "
          f"{r['sample']}; card {card}")
    return r


def audit_phase(torch, card: str) -> dict:
    """The launch audit's entries (`repro_torch.analysis.launch_audit`)
    on the card, each recorded call under
    `torch.cuda.set_sync_debug_mode("error")`: its LAUNCHES equal to the
    golden's kernel calls, the device-independent counts and the hard
    invariants held, and beside its aten op count (outside the kernel
    wrappers, on the card and in the CPU golden) the device operations
    torch.profiler records for the call (the CUDA calls that enqueue
    them)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import launch_audit as la

    golden = json.loads(la.GOLDEN_PATH.read_text())
    recorded = la._recorded
    device_ops: dict = {}

    def profiled(fn, device, **kw):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = recorded(fn, device, **kw)
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.key.startswith(ENQUEUE_CALLS))
        device_ops[current] = device_ops.get(current, 0) + n
        return out

    report = {}
    la._recorded = profiled
    try:
        for current in la.ENTRIES:
            report.update(la.audit("cuda", names=[current]))
    finally:
        la._recorded = recorded
    bad = la.hard_violations(report, la.known_syncs(golden))
    bad += la.compare(report, golden, keys=la.DEVICE_FREE)
    out = {}
    for name, e in report.items():
        want = golden["entries"][name]["pinned"]
        launched = e["info"].get("launches") or {}
        if launched != want["kernel_calls"]:
            bad.append(f"{name}: LAUNCHES {launched}, golden kernel calls "
                       f"{want['kernel_calls']}")
        out[name] = {"launches": launched, "pinned": e["pinned"],
                     "device_ops": device_ops.get(name), "inplace":
                     e["inplace"], "f64": e["f64"]}
        print(f"audit {name}: LAUNCHES {launched} (golden kernel calls "
              f"{want['kernel_calls']}); aten ops outside the kernels "
              f"{e['pinned'].get('aten_ops')} on the card "
              f"({want.get('aten_ops')} in the CPU golden), device "
              f"operations {device_ops.get(name)} (torch.profiler); host "
              f"syncs {e['pinned']['host_syncs']} (none raised under "
              f"set_sync_debug_mode('error')); in place {e['inplace']}; "
              f"f64 {e['f64']}; card {card}")
    if bad:
        fail("audit: " + "; ".join(bad))
    return out


def attend_stream(rng, n: int, total: int):
    """k/v (n, total, N_KV, HEAD_DIM) float32 at the phi4 KV geometry:
    sequences 0-5 compressible, 6 incompressible, 7 alternating 64-token
    runs of both."""
    from repro_torch.kv import synthetic_kv_stream

    k, v = synthetic_kv_stream(rng, n, total, N_KV, HEAD_DIM)
    ki, vi = synthetic_kv_stream(rng, n, total, N_KV, HEAD_DIM,
                                 compressible=False)
    k[6], v[6] = ki[6], vi[6]
    for t0 in range(64, total, 128):
        k[7, t0:t0 + 64], v[7, t0:t0 + 64] = (ki[7, t0:t0 + 64],
                                              vi[7, t0:t0 + 64])
    return k, v


def serve_attend_phase(torch, packing: str, device, *, slots=8,
                       prompt=200, steps=48, rng_seed=7) -> dict:
    """ServeLoop at the phi4 KV geometry; each attend is compared with the
    plain attention on the same state.  Slots 0-5 are compressible, slot 6
    incompressible and slot 7 alternates 64-token runs of both: the
    compressible tokens are within one bf16 ulp of each other, so only the
    others give scores that differ across tokens, and the check fails
    unless the reference output of slot 6 is far from the plain mean of
    its V (so it sees the softmax weights, not only the lane decode).
    Returns the loop and the max |diff| seen."""
    import numpy as np

    from repro_torch.kernels import cram_attention as ca
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeLoop

    rng = np.random.default_rng(rng_seed)
    total = prompt + steps
    k, v = attend_stream(rng, slots, total)
    v6 = torch.from_numpy(v[6]).to(device).to(torch.bfloat16).float()
    loop = ServeLoop(slots=slots, max_pages=-(-total // PAGE), page=PAGE,
                     n_kv=N_KV, head_dim=HEAD_DIM, policy="static",
                     packing=packing, device=device)
    for i in range(slots):
        loop.prefill(i, k[i, :prompt], v[i, :prompt])
    worst, spread = 0.0, math.inf
    lanes = loop.cache.group_lanes
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    for step in range(steps):
        t = prompt + step
        loop.step_all({i: (k[i, t:t + 1], v[i, t:t + 1])
                       for i in range(slots)})
        q = rng.standard_normal((slots, N_HEADS, HEAD_DIM)).astype("float32")
        out = loop.attend({i: q[i] for i in range(slots)})
        c = loop.cache
        n = c._active_bucket()
        kc = c._kernel_cache(n)
        s, st, mk, fv = pv(kc, c._valid(n))
        ref, _ = ca.cram_decode_attention_batched_plain(
            torch.from_numpy(q).to(device), s, st, mk, fv,
            kc["packed_mask"], lanes=lanes)
        got = torch.stack([out[i] for i in range(slots)])
        if not torch.isfinite(got).all():
            fail(f"serve attend {packing}: non-finite output")
        if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
            fail(f"serve attend {packing} step {step}: max |diff| "
                 f"{(got - ref).abs().max().item():.3e}")
        worst = max(worst, (got - ref).abs().max().item())
        mean_v = v6[:t + 1].mean(0).repeat_interleave(N_HEADS // N_KV, 0)
        spread = min(spread, (ref[6] - mean_v).abs().max().item())
    # K6 on each sequence's physical view against its row of K3's output
    # (the reference's per-sequence parity relation), at the last step: the
    # two run one device body on the same split, so they agree bit for bit
    qd = torch.from_numpy(q).to(device)
    single_err = 0.0
    for i in range(slots):
        one = ca.cram_decode_attention(qd[i], s[i], st[i], mk, fv[i],
                                       lanes=lanes)
        err = (one - got[i]).abs().max().item()
        if not torch.equal(one, got[i]):
            fail(f"serve attend {packing}: K6 on sequence {i} is {err:.3e} "
                 "from its row of K3, not equal")
        single_err = max(single_err, err)
    print(f"serve attend {packing}: K6 on each of {slots} sequences equal "
          "to K3's row (torch.equal)")
    if spread < 10 * ATOL:
        fail(f"serve attend {packing}: the incompressible slot's output is "
             f"within {spread:.3e} of the mean of its V; the check would "
             "not see wrong softmax weights")
    print(f"serve attend {packing}: slot 6 output at least {spread:.3e} "
          "from the mean of its V (the weights matter)")
    if (loop.cache.state["traffic"] < 0).any():
        fail(f"serve attend {packing}: a ledger accumulator went negative "
             "(overflow)")
    return {"loop": loop, "max_abs_err": worst, "spread": spread,
            "single_vs_batched": single_err, "view": (s, st, mk)}


CHURN_SEQS, CHURN_SLOTS = 8, 4


def _spill_timers(torch, walls: dict):
    """Wrap the spill tier's evict (capture + hand-off), restore (wake into
    a free slot: join, decode or take the prefetch, copy to the card,
    repack), and the worker's encode and decode, adding each call's host
    wall to walls[name]; returns the originals.  The main-thread two end
    with a device synchronise."""
    from repro_torch.serving import SpillStore

    names = {"evict": "evict", "restore": "restore", "encode": "_encode",
             "decode": "_decode_pages"}
    originals = {}
    for label, attr in names.items():
        fn = getattr(SpillStore, attr)
        originals[attr] = fn
        sync = label in ("evict", "restore")

        def wrapped(*a, _fn=fn, _label=label, _sync=sync, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            if _sync:
                torch.cuda.synchronize()
            walls.setdefault(_label, []).append(time.perf_counter() - t0)
            return out
        setattr(SpillStore, attr, wrapped)
    return originals


def serve_churn_phase(torch, hot: str, spill: str, device, card: str, *,
                      prompt=200, steps=48, rng_seed=7) -> dict:
    """The serve tier alone at the phi4 KV geometry with the spill tier
    churning: the serve-attend stream's 8 sequences in 4 slots, hot
    packing `hot`, spill packing `spill`, async spill; 48 decode steps
    through step_all, each naming all 8, so every step evicts and wakes 4;
    after each step the resident sequences attend, held against the plain
    attention on the same state.  At the end every sequence is woken and
    its physical state must equal, bit for bit, that of a twin ServeLoop
    with 8 slots on the CPU that never spilled and was fed the same
    stream (the twin runs the kernels' plain versions).  The spill rows
    must count evicts + wakes + spill-direct admits and the spill tier
    must save bytes.  Prints the host wall of one evict, one restore and
    the worker's encode and decode (median and max)."""
    import numpy as np

    from repro_torch.kernels import cram_attention as ca
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeLoop, SpillStore

    rng = np.random.default_rng(rng_seed)
    total = prompt + steps
    n = CHURN_SEQS
    k, v = attend_stream(rng, n, total)
    kw = dict(max_pages=-(-total // PAGE), page=PAGE, n_kv=N_KV,
              head_dim=HEAD_DIM, policy="static", packing=hot)
    walls: dict = {}
    originals = _spill_timers(torch, walls)
    try:
        loop = ServeLoop(slots=CHURN_SLOTS, spill_packing=spill,
                         device=device, **kw)
        twin = ServeLoop(slots=n, device="cpu", **kw)
        for i in range(n):
            loop.prefill(i, k[i, :prompt], v[i, :prompt])
            twin.prefill(i, k[i, :prompt], v[i, :prompt])
        lanes = loop.cache.group_lanes
        pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
        worst = 0.0
        for step in range(steps):
            t = prompt + step
            kvs = {i: (k[i, t:t + 1], v[i, t:t + 1]) for i in range(n)}
            loop.step_all(kvs)
            twin.step_all(kvs)
            q = rng.standard_normal((n, N_HEADS, HEAD_DIM)).astype("float32")
            act = loop.active_seqs()
            if len(act) != CHURN_SLOTS:
                fail(f"serve churn {hot}/{spill} step {step}: {len(act)} "
                     f"resident sequences, expected {CHURN_SLOTS}")
            out = loop.attend({i: q[i] for i in act})
            c = loop.cache
            nb = c._active_bucket()
            kc = c._kernel_cache(nb)
            s, st, mk, fv = pv(kc, c._valid(nb))
            qs = torch.zeros((CHURN_SLOTS, N_HEADS, HEAD_DIM),
                             dtype=torch.float32, device=device)
            for i in act:
                qs[loop.seqs[i].slot] = torch.from_numpy(q[i]).to(device)
            ref, _ = ca.cram_decode_attention_batched_plain(
                qs, s, st, mk, fv, kc["packed_mask"], lanes=lanes)
            got = torch.stack([out[i] for i in act])
            want = torch.stack([ref[loop.seqs[i].slot] for i in act])
            worst = max(worst, _close(
                torch, f"serve churn {hot}/{spill} step {step}", got, want))
        twin.cache.repack()
        for i in range(n):
            loop.wake(i)
            loop.cache.repack()
            got = loop.cache.slot_physical_state(loop.seqs[i].slot)
            want = twin.cache.slot_physical_state(twin.seqs[i].slot)
            for key in want:
                if not torch.equal(got[key].cpu(), want[key]):
                    fail(f"serve churn {hot}/{spill}: woken sequence {i} "
                         f"{key} differs from the never-spilled twin")
        summary = loop.summary()
    finally:
        for attr, fn in originals.items():
            setattr(SpillStore, attr, fn)
    counts = loop.counts
    rows = {d: loop.ledger.total("spill", consumer="kv",
                                 tensor_class=f"kv-{d}")["count"]
            for d in ("evict", "restore")}
    if (rows["evict"] != counts["evicted"] + counts["spilled_direct"]
            or rows["restore"] != counts["woken"]):
        fail(f"serve churn {hot}/{spill}: spill rows {rows} against "
             f"{counts}")
    if counts["evicted"] < CHURN_SLOTS * steps:
        fail(f"serve churn {hot}/{spill}: {counts['evicted']} evicts over "
             f"{steps} steps, expected at least {CHURN_SLOTS} a step")
    saving = summary["spill_tier"]["saving"]
    if saving <= 0:
        fail(f"serve churn {hot}/{spill}: spill saving {saving}")
    if (loop.cache.state["traffic"] < 0).any():
        fail(f"serve churn {hot}/{spill}: a ledger accumulator went "
             "negative (overflow)")
    ms = {name: {"n": len(w), "median_ms": 1e3 * statistics.median(w),
                 "max_ms": 1e3 * max(w)} for name, w in walls.items()}
    print(f"serve churn {hot}/{spill}: {n} sequences in {CHURN_SLOTS} slots, "
          f"{steps} steps: evicted {counts['evicted']}, woken "
          f"{counts['woken']}, spilled direct {counts['spilled_direct']}; "
          f"spill rows {rows}; spill saving {saving}, decode saving "
          f"{summary['decode_saving']}; every attend within {ATOL} of the "
          f"plain attention (max |diff| {worst:.3e}); every woken sequence "
          "bit-exact against the never-spilled twin")
    print(f"serve churn {hot}/{spill}: host wall per call, median / max ms "
          f"(card {card}): " + "; ".join(
              f"{name} {m['median_ms']:.3f} / {m['max_ms']:.3f} "
              f"({m['n']} calls)" for name, m in ms.items()))
    return {"counts": dict(counts), "spill_tier": summary["spill_tier"],
            "decode_saving": summary["decode_saving"], "max_abs_err": worst,
            "host_ms": ms}


SMALL_PAGE, SMALL_HKV, SMALL_HQ, SMALL_HD = 8, 1, 1, 16


def serve_small_phase(torch, device, steps: int = 8) -> dict:
    """ServeLoop at the reference's serving-test geometry (page 8, one KV
    head, one query head, head_dim 16), pair then quad: 4 slots with
    prompts of 5, 8, 16 and 25 tokens (slot 2 incompressible, the others
    compressible), `steps` decode steps, each followed by an attend on the
    card held against the plain attention on the same state.  At the last
    step `shard=True` must equal `shard=False` on the card's one device
    (with more cards visible it must raise: the sharded attend is not
    ported).  Returns the max |diff| seen."""
    import numpy as np

    from repro_torch.kernels import cram_attention as ca
    from repro_torch.kernels import ops
    from repro_torch.kv import synthetic_kv_stream
    from repro_torch.serving import ServeLoop

    rng = np.random.default_rng(16)
    prompts = (5, 8, 16, 25)
    total = max(prompts) + steps
    worst = 0.0
    for packing in ("pair", "quad"):
        k, v = synthetic_kv_stream(rng, 4, total, SMALL_HKV, SMALL_HD)
        ki, vi = synthetic_kv_stream(rng, 4, total, SMALL_HKV, SMALL_HD,
                                     compressible=False)
        k[2], v[2] = ki[2], vi[2]
        loop = ServeLoop(slots=4, max_pages=-(-total // SMALL_PAGE),
                         page=SMALL_PAGE, n_kv=SMALL_HKV, head_dim=SMALL_HD,
                         policy="static", packing=packing, device=device)
        for i, p in enumerate(prompts):
            loop.prefill(i, k[i, :p], v[i, :p])
        lanes = loop.cache.group_lanes
        pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
        for step in range(steps):
            loop.step_all({i: (k[i, p + step:p + step + 1],
                               v[i, p + step:p + step + 1])
                           for i, p in enumerate(prompts)})
            q = rng.standard_normal((4, SMALL_HQ, SMALL_HD)).astype("float32")
            out = loop.attend({i: q[i] for i in range(4)})
            c = loop.cache
            n = c._active_bucket()
            kc = c._kernel_cache(n)
            s, st, mk, fv = pv(kc, c._valid(n))
            ref, _ = ca.cram_decode_attention_batched_plain(
                torch.from_numpy(q).to(device), s, st, mk, fv,
                kc["packed_mask"], lanes=lanes)
            got = torch.stack([out[i] for i in range(4)])
            worst = max(worst, _close(
                torch, f"serve attend small {packing} step {step}", got, ref))
        qs = {i: q[i] for i in range(4)}
        n_cards = torch.cuda.device_count()
        sharded = loop.attend(qs, shard=True)
        single = loop.attend(qs, shard=False)
        if not all(torch.equal(sharded[i], single[i]) for i in range(4)):
            fail(f"serve attend small {packing}: shard=True over {n_cards} "
                 "card(s) differs from shard=False")
        shard_note = (f"shard=True over {n_cards} card(s) equal to "
                      "shard=False")
        print(f"serve attend small {packing}: page {SMALL_PAGE}, Hkv "
              f"{SMALL_HKV}, Hq {SMALL_HQ}, head_dim {SMALL_HD}, {steps} "
              f"steps, every attend within {ATOL} of the plain attention; "
              f"{shard_note}")
    return {"max_abs_err": worst}


def page_codec_roundtrip(torch, view, packing: str) -> dict:
    """The registry's page-codec device pair on a serve cache: every slot
    whose strip marker matches goes through the unpack (K4 or K5), held
    bit-exact against the plain decode of the physical view; the pages it
    gives go through the pack (K1 or K2) and must give back the slot, its
    base row and a fit."""
    from repro_torch.compression import get_codec
    from repro_torch.kernels.ref import decode_slots, strip_is_packed

    slots, strips, markers = view
    lanes = 2 if packing == "pair" else 4
    pack, unpack = get_codec("int8-delta" if lanes == 2
                             else "int4-delta").pallas()
    is_packed = strip_is_packed(strips, markers)
    d2 = slots.shape[-1]
    packed = slots[is_packed].contiguous()
    base = strips[is_packed][..., :d2].contiguous()
    groups = packed.shape[0]
    if groups == 0:
        fail(f"page codec {packing}: no packed slot to round-trip")
    pages = unpack(packed, base)
    want = decode_slots(slots, strips, is_packed, lanes)[is_packed]
    for j, page in enumerate(pages):
        if not torch.equal(page, want[:, j]):
            fail(f"page codec {packing}: unpacked lane {j} differs from the "
                 "plain decode")
    again, again_base, ok = pack(*pages)
    if not (bool(ok.all()) and torch.equal(again, packed)
            and torch.equal(again_base, base)):
        fail(f"page codec {packing}: pack(unpack(slot)) is not the slot")
    print(f"page codec {packing}: {groups} packed groups of "
          f"{is_packed.numel()} slots unpacked bit-exact and packed back to "
          "the same slots")
    return {"groups": groups, "slots": is_packed.numel()}


def scan_phase(torch, device) -> dict:
    """The compressibility scan of the Fig. 4 memory image at
    SCAN_LINES_EACH lines per source, resident on the card, in one launch
    of the `hybrid` codec's scan backend, as `benchmarks/run.py`'s
    compress sweep does.  Returns its statistics and wall times."""
    import numpy as np

    from repro_torch.compression import get_codec
    from repro_torch.kernels.compress_scan import classify_image_ref

    t0 = time.perf_counter()
    names, images = zip(*sorted(fig4_corpus(SCAN_LINES_EACH).items()),
                        strict=True)
    lines = np.concatenate([v.reshape(-1, 64) for v in images])
    t_corpus = time.perf_counter() - t0
    img = torch.from_numpy(lines).to(device)
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0 - t_corpus
    scan = get_codec("hybrid").scan()
    t1 = time.perf_counter()
    out = scan(img)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t1
    host = {k: v.cpu().numpy() for k, v in out.items()}
    del img

    def stats(sizes, status):
        p64, p60 = pair_fit_stats(sizes)
        uniq, cnt = np.unique(status, return_counts=True)
        return {"pair_fits_64B": p64, "pair_fits_60B": p60,
                "mean_size": float(sizes.mean()),
                "status_counts": {int(u): int(c)
                                  for u, c in zip(uniq, cnt, strict=True)}}

    per_source, ofs = {}, 0
    for name, image in zip(names, images, strict=True):
        n = image.size // 64
        head = image.reshape(-1, 64)[:4096]
        sl = slice(ofs, ofs + head.shape[0])
        # the registry's host sizes; bdi's carries its 1-byte mode header
        checks = {"sizes": get_codec("hybrid").size_fn(head),
                  "fpc": get_codec("fpc").size_fn(head),
                  "bdi": get_codec("bdi").size_fn(head) - 1,
                  "status": classify_image_ref(head, first_slot=ofs)}
        for key, want in checks.items():
            if not np.array_equal(host[key][sl], want):
                fail(f"scan: {name} {key} of the first 4096 lines differs "
                     "from the numpy reference")
        per_source[name] = {"lines": n, **stats(host["sizes"][ofs:ofs + n],
                                                host["status"][ofs:ofs + n])}
        ofs += n
    report = {"per_source": per_source,
              "overall": stats(host["sizes"], host["status"]),
              "lines_scanned": int(lines.shape[0]),
              "bytes_scanned": int(lines.nbytes),
              "wall_s": {"corpus_host": t_corpus, "copy_to_card": t_copy,
                         "scan": t_scan,
                         "total": time.perf_counter() - t0}}
    o = report["overall"]
    print(f"scan: {report['lines_scanned']} lines ({report['bytes_scanned']} "
          f"bytes) in one launch; overall pair_fits_64B {o['pair_fits_64B']}"
          f", pair_fits_60B {o['pair_fits_60B']}, mean size "
          f"{o['mean_size']}, status counts {o['status_counts']}; first 4096 "
          "lines of each source equal the numpy codec and marker reference")
    for name, st in per_source.items():
        print(f"scan: {name}: p64 {st['pair_fits_64B']}, p60 "
              f"{st['pair_fits_60B']}, mean size {st['mean_size']}, status "
              f"{st['status_counts']}")
    print(f"scan: wall corpus {t_corpus:.2f} s, copy to card {t_copy:.3f} s, "
          f"scan call {t_scan * 1e3:.3f} ms")
    return report


def check_final_state(torch, loop, packing) -> None:
    """After a repack, every slot's physical rows bit-exact against the
    per-slot rebuild, which packs on the host with the plain version."""
    c = loop.cache
    c.repack()
    for slot in range(loop.n_slots):
        phys = c.slot_physical_state(slot)
        want = c.slot_reference_state(slot)
        for key in phys:
            if not torch.equal(phys[key], want[key]):
                fail(f"serve attend {packing}: slot {slot} {key} differs "
                     "from the per-slot rebuild")
    s = loop.summary()
    if s["decode_saving"] <= 0:
        fail(f"serve attend {packing}: decode saving {s['decode_saving']}")
    print(f"serve attend {packing}: final state bit-exact on {loop.n_slots} "
          f"slots, decode saving {s['decode_saving']}")


# --------------------------------------------- the trace simulator (E1)

SIM_CFG2 = dict(llc_sets=64, llc_ways=4, meta_sets=32,
                compress_clean=False)       # a second SimConfig
SIM_CHECK_NAMES = ("libq", "pr_twi", "mix3")
SIM_CHECK_EVENTS = 4_000        # E1 against its plain version (phase 2)
SIM_PIN_EVENTS = 20_000         # the committed JAX fixture
SIM_PAPER_EVENTS = 200_000      # the paper's sweep
SIM_PAPER_CHUNK = 50_000
SIM_PREFIX_EVENTS = 2_000       # the paper sweep's first events: E1 beside
                                # its plain version (phase 7)
SIM_LANE_EVENTS = 20_000        # one lane beside all lanes (phase 7)
SIM_REPLAY_EVENTS = 256         # phase 6: events of a recorded launch
                                # replayed through the plain version
SIM_FIXTURE = "tests/fixtures/torch_engine_sweep.json"
SIM_GOLDEN = "tests/golden/engine_stats.json"
CARRY_NAMES = ("tag", "lru", "valid", "dirty", "pf", "mem_state", "lct",
               "mtag", "mlru", "mdirty", "mclock", "counter", "clock",
               "stats")


def carry_leaves(carry) -> list:
    (tag, lru, valid, dirty, pf, mem, lct, meta, counter, clock,
     stats) = carry
    return [tag, lru, valid, dirty, pf, mem, lct, *meta, counter, clock,
            stats]


def clone_carry(carry) -> tuple:
    return tuple(tuple(x.clone() for x in c) if isinstance(c, tuple)
                 else c.clone() for c in carry)


def carry_equal(torch, label, got, want) -> None:
    for name, g, w in zip(CARRY_NAMES, carry_leaves(got), carry_leaves(want),
                          strict=True):
        if g.dtype != w.dtype or not torch.equal(g, w):
            fail(f"{label}: carry tensor {name} differs")


def sim_inputs(torch, cfg, rows, names, n_events, seed, device):
    """(flags, params, addrs, is_write, pair_ab, pair_cd, quad) on the card
    for scheme rows x workloads, and the host seconds the traces took."""
    from repro_torch.core import batchsim, schemes
    from repro_torch.core.engine import trace_tensors

    t0 = time.perf_counter()
    _, _, *trace = batchsim.stack_workloads(names, n_events, seed)
    host_s = time.perf_counter() - t0
    flags = torch.as_tensor(schemes.flags_matrix(rows), device=device)
    params = torch.as_tensor(schemes.params_matrix(rows, cfg), device=device)
    return (flags, params, *trace_tensors(cfg, *trace, device)), host_s


def sim_run(torch, cfg, inputs, *, chunk=None, plain=False, events=None):
    """A fresh carry advanced over the first `events` events (all when
    None): E1 in one launch, or one per `chunk` events, or its plain
    version on the same tensors."""
    from repro_torch.core.engine import (build_engine, device_tables,
                                         engine_consts, run_trace)
    from repro_torch.kernels import engine_scan as es

    flags, params, a, w, pab, pcd, pq = inputs
    t = a.shape[1] if events is None else events
    if not plain:
        return run_trace(cfg, flags, params, a[:, :t], w[:, :t], pab, pcd,
                         pq, chunk_size=chunk, device=a.device)
    carry = build_engine(cfg).init_state(params, a.shape[0], device=a.device)
    return es.engine_scan_plain(carry, flags, params, a[:, :t], w[:, :t],
                                pab, pcd, pq, device_tables(cfg, a.device),
                                engine_consts(cfg))


def check_engine_scan(torch, device) -> tuple[dict, float]:
    """E1 against its plain version on the card: every registry row x
    libq / pr_twi / mix3 at 4,000 events, at the default SimConfig and a
    second one; one launch, chunks of 1,000 and chunks of 1,537 (a ragged
    last one) must each leave every carry tensor equal (torch.equal) to
    the plain version's.  Returns the error record and the plain
    version's wall time per event."""
    from repro_torch.core import schemes
    from repro_torch.core.engine import SimConfig

    plain_ms = []
    for label, kw in (("default", {}), ("second", SIM_CFG2)):
        cfg = SimConfig(**kw)
        inputs, _ = sim_inputs(torch, cfg, schemes.names(), SIM_CHECK_NAMES,
                               SIM_CHECK_EVENTS, 0, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = sim_run(torch, cfg, inputs, plain=True)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3 / SIM_CHECK_EVENTS)
        for chunk in (None, 1000, 1537):
            got = sim_run(torch, cfg, inputs, chunk=chunk)
            torch.cuda.synchronize()
            carry_equal(torch, f"E1 {label} config, chunk {chunk}", got, want)
        lanes = inputs[0].shape[0] * inputs[2].shape[0]
        print(f"kernel check: engine scan {label} config ({lanes} lanes x "
              f"{SIM_CHECK_EVENTS} events): every carry tensor equal to the "
              f"plain version's, one launch and chunks of 1000 and 1537; "
              f"plain {plain_ms[-1]:.3f} ms an event (wall)")
    return {"engine_scan": 0.0}, statistics.mean(plain_ms)


def geomean(xs) -> float:
    return math.exp(statistics.mean(math.log(x) for x in xs))


def paper_summary(out: dict) -> dict:
    """Per scheme over the workloads: geomean and lowest speedup, mean LLP
    accuracy, and the metadata share of accesses (mean over workloads)."""
    schemes_ = next(iter(out.values()))["schemes"]
    rows = {}
    for sch in schemes_:
        per = [w["schemes"][sch] for w in out.values()]
        rows[sch] = {
            "geomean_speedup": geomean(p["speedup"] for p in per),
            "min_speedup": min(p["speedup"] for p in per),
            "mean_llp_accuracy": statistics.mean(p["llp_accuracy"]
                                                 for p in per),
            "metadata_share": statistics.mean(
                p["breakdown"]["metadata"] / max(p["accesses"], 1)
                for p in per)}
    return rows


def launched(what: str, expected: int, fn):
    """fn(), which must launch E1 exactly `expected` times."""
    from repro_torch.kernels import engine_scan as es

    before = es.LAUNCHES["engine_scan"]
    out = fn()
    n = es.LAUNCHES["engine_scan"] - before
    if n != expected:
        fail(f"{what}: {n} E1 launches, expected {expected}")
    return out


def trace_sim_phase(torch, device) -> dict:
    """The trace simulator's main path on the card, every sweep through E1:
    the golden (six paper schemes x libq / pr_twi / mix3, 12,000 events,
    seed 1) in one launch and `simulate("dynamic", chunk_size=5000)` per
    workload; the full suite (27 workloads x 10 rows, 20,000 events, seed
    0) in one launch against the committed JAX fixture; the paper's sweep
    (27 x 10 at 200,000 events) through `sweep` in one launch,
    equal to the same sweep in chunks of 50,000 on every stat (the
    summaries `sweep_workloads` gives, from its traces and one-launch
    stats, which the multi-device phase's sharded sweep reuses)."""
    import numpy as np

    from repro_torch.core import batchsim, memsim, schemes
    from repro_torch.core.traces import all_workload_names

    golden = json.loads((ROOT / SIM_GOLDEN).read_text())
    names = tuple(golden["stats"]["cram"])
    _, _, *trace = batchsim.stack_workloads(names, golden["n_events"],
                                            golden["seed"])
    stats = launched("golden sweep", 1, lambda: batchsim.sweep(
        memsim.SCHEMES, *trace, device=device))
    for si, sch in enumerate(memsim.SCHEMES):
        for wi, name in enumerate(names):
            if stats[si, wi].tolist() != golden["stats"][sch][name]:
                fail(f"golden: {sch} / {name} differs")
    for wi, name in enumerate(names):
        r = launched("simulate dynamic", 3, lambda i=wi: memsim.simulate(
            "dynamic", *(x[i] for x in trace), chunk_size=5_000,
            device=device))
        if [r.stats[k] for k in golden["stat_names"]] != \
                golden["stats"]["dynamic"][name]:
            fail(f"golden: simulate dynamic / {name} in chunks differs")
    print(f"trace sim: golden ({len(memsim.SCHEMES)} schemes x {names}, "
          f"{golden['n_events']} events) equal in one launch; "
          "simulate('dynamic', chunk_size=5000) equal on each workload")

    pin = json.loads((ROOT / SIM_FIXTURE).read_text())
    _, _, *trace = batchsim.stack_workloads(pin["workloads"], pin["n_events"],
                                            pin["seed"])
    stats = launched("full-suite sweep", 1, lambda: batchsim.sweep(
        pin["rows"], *trace, device=device))
    if stats.tolist() != pin["stats"]:
        bad = int((stats != np.asarray(pin["stats"])).any(-1).sum())
        fail(f"full-suite pin: {bad} lanes differ from the JAX fixture")
    print(f"trace sim: full suite ({len(pin['rows'])} rows x "
          f"{len(pin['workloads'])} workloads, {pin['n_events']} events) "
          f"equal to the JAX fixture (jax {pin['jax_version']}, reference "
          f"{pin['reference_commit'][:7]})")

    rows = schemes.names()
    names = all_workload_names()
    sim_rows = batchsim.with_baseline(rows)
    t0 = time.perf_counter()
    _, fs, *trace = batchsim.stack_workloads(names, SIM_PAPER_EVENTS, 0)
    stats = launched("paper sweep", 1, lambda: batchsim.sweep(
        sim_rows, *trace, device=device))
    paper = batchsim.summarize_sweep(names, fs, rows, sim_rows, stats)
    wall = time.perf_counter() - t0
    chunked = launched(
        "paper sweep in chunks", SIM_PAPER_EVENTS // SIM_PAPER_CHUNK,
        lambda: batchsim.sweep(sim_rows, *trace, chunk_size=SIM_PAPER_CHUNK,
                               device=device))
    if not np.array_equal(chunked, stats):
        fail("paper sweep: chunks of 50000 differ from one launch")
    summary = paper_summary(paper)
    print(f"trace sim: paper sweep ({len(rows)} rows x {len(paper)} "
          f"workloads, {SIM_PAPER_EVENTS} events) in {wall:.2f} s of wall "
          f"time, traces and summaries included; chunks of "
          f"{SIM_PAPER_CHUNK} equal")
    for sch, r in summary.items():
        print(f"trace sim: {sch}: geomean speedup {r['geomean_speedup']:.4f}, "
              f"lowest {r['min_speedup']:.4f}, mean LLP accuracy "
              f"{r['mean_llp_accuracy']:.4f}, metadata share of accesses "
              f"{r['metadata_share']:.4f}")
    for bad in [s for s, r in summary.items()
                if not math.isfinite(r["geomean_speedup"])]:
        fail(f"paper sweep: {bad} has a non-finite speedup")
    return {"paper": summary, "paper_wall_s": wall,
            "paper_inputs": (sim_rows, trace, stats)}


# ------------------------------------------------------- multi-device phase
# The driver's machine holds one card and NCCL refuses two ranks on one
# card: the shardings that need no collective run over device lists that
# name the card several times, and the collective paths (DP step, GPipe,
# elastic re-meshing) in a world of one rank under NCCL.

SHARD_ATTEND_SPLITS = (2, 4)    # device lists of the sharded attend
SHARD_SWEEP_SPLIT = 3           # the paper sweep's 27 workloads in 3 shards
DP_ARCH, DP_BATCH, DP_SEQ, DP_STEPS, DP_LR = "phi4_mini_3_8b", 2, 512, 2, 1e-4
DP_POLICIES = ("off", "static", "dynamic")
# leaves whose update is held against p - lr * g by hand (the tied
# embedding, two layers' weights, a norm)
DP_CHECK = ("embed", "blocks.0.attn.wq", "blocks.31.mlp.w2", "final_ln")
GP_LAYERS, GP_D, GP_MICRO, GP_MB, GP_SEQ = 32, 3072, 4, 2, 512


@contextlib.contextmanager
def nccl_world_of_one(torch):
    """A process group of one rank under NCCL on card 0, over a free
    localhost port; destroyed on exit."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_attend_phase(torch, loops: dict, device, card: str) -> dict:
    """The sharded attend at the serve-attend geometry (phi4 KV: 8 slots,
    page 16, 8 KV heads, D2 256; the serve-attend paths' final caches),
    pair and quad, over device lists naming the card 2 and 4 times: one
    K3 launch a shard, every output torch.equal to `shard=False`."""
    import numpy as np

    from repro_torch.kernels import cram_attention as ca
    from repro_torch.serving import shard_kv_attend

    rng = np.random.default_rng(17)
    out = {}
    for packing, loop in loops.items():
        key = f"decode_attention_{packing}"
        slots = loop.n_slots
        q = torch.from_numpy(rng.standard_normal(
            (slots, N_HEADS, HEAD_DIM)).astype(np.float32)).to(device)
        single = shard_kv_attend(loop.cache, q, shard=False)
        row = {"single_ms": call_ms(torch, lambda: shard_kv_attend(
            loop.cache, q, shard=False), reps=5, warmup=1)}
        for k in SHARD_ATTEND_SPLITS:
            devs = [device] * k
            before = ca.LAUNCHES[key]
            got = shard_kv_attend(loop.cache, q, devices=devs)
            torch.cuda.synchronize()
            if ca.LAUNCHES[key] - before != k:
                fail(f"shard attend {packing} x{k}: "
                     f"{ca.LAUNCHES[key] - before} K3 launches, expected {k}")
            if not torch.equal(got, single):
                fail(f"shard attend {packing} x{k}: differs from shard=False "
                     f"by {(got - single).abs().max().item():.3e}")
            row[f"x{k}_ms"] = call_ms(torch, lambda d=devs: shard_kv_attend(
                loop.cache, q, devices=d), reps=5, warmup=1)
        print(f"multi-device shard attend {packing}: {slots} slots, page "
              f"{PAGE}, {N_KV} KV heads, D2 {2 * HEAD_DIM}: "
              + ", ".join(f"{k} shards {k} K3 launches torch.equal to "
                          f"shard=False, {row[f'x{k}_ms']:.3f} ms a call"
                          for k in SHARD_ATTEND_SPLITS)
              + f"; one launch {row['single_ms']:.3f} ms (CUDA events around "
              f"one eager call, median of 5); card {card}")
        out[packing] = row
    return out


def shard_sweep_phase(torch, device, paper_inputs, card: str) -> dict:
    """The paper sweep (27 workloads x 10 rows, 200,000 events: the trace
    sim path's traces) with its workload axis in SHARD_SWEEP_SPLIT shards
    on the card: one E1 launch a shard, every stat equal to the one-launch
    sweep of the trace sim path."""
    import numpy as np

    from repro_torch.core import batchsim

    rows, trace, want = paper_inputs
    devs = [device] * SHARD_SWEEP_SPLIT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = launched("sharded paper sweep", SHARD_SWEEP_SPLIT,
                   lambda: batchsim.sweep(rows, *trace, device=device,
                                          devices=devs))
    wall = time.perf_counter() - t0
    if not np.array_equal(got, want):
        bad = int((got != want).any(-1).sum())
        fail(f"sharded paper sweep: {bad} lanes differ from one launch")
    return {"shards": SHARD_SWEEP_SPLIT, "wall_s": wall,
            "lanes": int(got.shape[0] * got.shape[1])}


def shard_sweep_times(torch, device, paper_inputs) -> list:
    """Each shard of the sharded paper sweep once more, alone, its trace
    already on the card: device time (CUDA events) of its fresh carry and
    E1 launch.  Outside the path."""
    from repro_torch.core import schemes
    from repro_torch.core.engine import (SimConfig, launch_trace,
                                         raise_refused, trace_tensors)

    rows, trace, _ = paper_inputs
    cfg = SimConfig()
    flags = torch.as_tensor(schemes.flags_matrix(rows), device=device)
    params = torch.as_tensor(schemes.params_matrix(rows, cfg), device=device)
    per = len(trace[0]) // SHARD_SWEEP_SPLIT
    times = []
    for i in range(SHARD_SWEEP_SPLIT):
        part = trace_tensors(cfg, *(x[i * per:(i + 1) * per] for x in trace),
                             device)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        _, err = launch_trace(cfg, flags, params, *part, device=device)
        ev1.record()
        ev1.synchronize()
        raise_refused([err])
        times.append(ev0.elapsed_time(ev1))
    return times


def dp_phase(torch, device, card: str) -> dict:
    """The compressed-gradient DP step at phi4-mini-3.8B's full width
    (random weights from seed 0, float32 parameters) in the world of one
    rank: DP_STEPS steps of each policy at batch DP_BATCH x DP_SEQ, each
    from the same weights' current values.  Each step's update of the
    DP_CHECK leaves must be torch.equal to p - lr * g by hand, g being the
    gradient autograd left on the leaf (a post-accumulate hook's copy),
    quantized with the error feedback of the step before where the gate
    was on; the ledger's wire bytes must equal `tree_wire_bytes` /
    `int8_wire_bytes` of phi4's tree for each step's gate.  Prints loss,
    gate, rel_err, counter and wall a step, and the peak memory."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.bandwidth import Ledger
    from repro_torch.bandwidth.adapters import int8_wire_bytes, tree_wire_bytes
    from repro_torch.compression.gate import COUNTER_INIT, ENABLE_THRESHOLD
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.optim import grad_compress as gc

    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get(DP_ARCH)
    model = build(cfg, device=device, seed=0)
    params = dict(model.named_parameters())
    err = {k: torch.zeros(p.shape, dtype=torch.float32, device=device)
           for k, p in params.items()}
    mesh = make_host_mesh(device_type=device.type)
    rng = np.random.default_rng(23)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (DP_BATCH, DP_SEQ)).astype(np.int32)).to(device)
        for k in ("tokens", "labels")}
    raw, int8 = tree_wire_bytes(params), int8_wire_bytes(params)
    grads = {}
    hooks = [params[k].register_post_accumulate_grad_hook(
        lambda p, k=k: grads.__setitem__(k, p.grad.detach().clone()))
        for k in DP_CHECK]
    out = {}
    try:
        for policy in DP_POLICIES:
            for e in err.values():
                e.zero_()
            counter = torch.tensor(COUNTER_INIT, dtype=torch.int32,
                                   device=device)
            led = Ledger()
            step = gc.make_dp_compressed_step(model, mesh, lr=DP_LR,
                                              policy=policy, ledger=led)
            rows, sent = [], 0
            for i in range(DP_STEPS):
                before = {k: params[k].detach().clone() for k in DP_CHECK}
                err0 = {k: err[k].clone() for k in DP_CHECK}
                on = policy == "static" or (
                    policy == "dynamic" and int(counter) >= ENABLE_THRESHOLD)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, _, counter, loss = step(params, err, counter, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if step.last["enabled"] != on:
                    fail(f"dp {policy} step {i}: gate {step.last['enabled']},"
                         f" expected {on}")
                for k in DP_CHECK:
                    g = grads[k]
                    if on:
                        q, scale = gc.quantize_int8(g.float() + err0[k])
                        g = gc.dequantize(q, scale).to(g.dtype)
                    want = (before[k].float() - DP_LR * g.float()).to(
                        before[k].dtype)
                    if not torch.equal(params[k].detach(), want):
                        fail(f"dp {policy} step {i}: {k} is not p - lr * g "
                             "by hand")
                sent += int8 if on else raw
                rel = step.last["rel_err"]
                rows.append({"loss": float(loss), "enabled": on,
                             "rel_err": None if rel is None else float(rel),
                             "counter": int(counter), "wall_s": wall})
                if not math.isfinite(rows[-1]["loss"]):
                    fail(f"dp {policy} step {i}: non-finite loss")
            t = led.total("write", consumer="grad")
            if (t["raw_bytes"], t["compressed_bytes"]) != (raw * DP_STEPS,
                                                           sent):
                fail(f"dp {policy}: ledger {t}, expected raw "
                     f"{raw * DP_STEPS}, sent {sent}")
            out[policy] = {"steps": rows, "ledger_raw": t["raw_bytes"],
                           "ledger_sent": t["compressed_bytes"]}
            print(f"multi-device dp {policy}: {DP_ARCH} full width, batch "
                  f"{DP_BATCH} x {DP_SEQ}, " + "; ".join(
                      f"step {i}: loss {r['loss']:.4f}, gate "
                      f"{'on' if r['enabled'] else 'off'}, rel_err "
                      f"{r['rel_err'] if r['rel_err'] is None else round(r['rel_err'], 5)}, "
                      f"counter {r['counter']}, wall {r['wall_s']:.3f} s"
                      for i, r in enumerate(rows))
                  + f"; ledger raw {t['raw_bytes']} B, sent "
                  f"{t['compressed_bytes']} B; updates of {len(DP_CHECK)} "
                  f"leaves torch.equal to p - lr * g by hand; card {card}")
    finally:
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"multi-device dp: tree {raw} B raw, {int8} B as int8; peak "
          f"memory {peak:.2f} GB; card {card}")
    return {"policies": out, "tree_bytes": raw, "int8_bytes": int8,
            "peak_gb": peak}


def gpipe_phase(torch, device, card: str) -> dict:
    """`gpipe_apply` over GP_LAYERS layers of tanh(x @ W) at d GP_D
    (float32 weights, N(0, 1 / d)), GP_MICRO microbatches of GP_MB x
    GP_SEQ, one stage in the world of one rank: the outputs and every W's
    gradient (of the sum of the squared outputs) torch.equal to the
    layers applied to each microbatch in sequence under autograd."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime.pipeline import gpipe_apply, split_stages

    _free_card(torch)
    mesh = init_device_mesh(device.type, (1,), mesh_dim_names=("stage",))
    gen = torch.Generator(device=device).manual_seed(29)
    w = (torch.randn((GP_LAYERS, GP_D, GP_D), generator=gen, device=device)
         / math.sqrt(GP_D)).requires_grad_()
    x = torch.randn((GP_MICRO, GP_MB, GP_SEQ, GP_D), generator=gen,
                    device=device)

    def stage_fn(ws, h):
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gpipe_apply(split_stages(w, 1), x, mesh=mesh, stage_fn=stage_fn)
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w2 = w.detach().clone().requires_grad_()
    seq = torch.stack([stage_fn(w2, x[m]) for m in range(GP_MICRO)])
    (seq ** 2).sum().backward()
    if not torch.equal(out, seq):
        fail(f"gpipe: outputs differ from the layers in sequence by "
             f"{(out - seq).abs().max().item():.3e}")
    if not torch.equal(w.grad, w2.grad):
        fail(f"gpipe: gradients differ from sequential autograd by "
             f"{(w.grad - w2.grad).abs().max().item():.3e}")
    print(f"multi-device gpipe: {GP_LAYERS} layers of tanh(x @ W) at d "
          f"{GP_D}, {GP_MICRO} microbatches of {GP_MB} x {GP_SEQ}, one "
          f"stage: outputs and every gradient torch.equal to the layers in "
          f"sequence; forward + backward {wall:.3f} s wall; card {card}")
    return {"wall_s": wall}


def elastic_phase(torch, device, ckpt_dir: str, card: str) -> dict:
    """The lm20m checkpoint the train launcher path wrote, restored and
    placed by `reshard_tree` on the grid `shrink_mesh` leaves when no rank
    failed, built in the world of one rank: every local shard torch.equal
    to its full leaf."""
    from repro_torch.checkpoint.ckpt import latest_step, load_checkpoint
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import build, param_axes
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.elastic import reshard_tree, shrink_mesh

    cfg = PRESETS["lm20m"]
    step = latest_step(ckpt_dir)
    if step is None:
        fail(f"elastic: no committed checkpoint in {ckpt_dir}")
    t0 = time.perf_counter()
    like = adamw_init(build(cfg, device="cpu"))
    state, _ = load_checkpoint(ckpt_dir, step, like)
    grid = shrink_mesh(set())
    placed = reshard_tree(state.params, param_axes(cfg),
                          grid.build(device.type))
    wall = time.perf_counter() - t0
    for k, leaf in state.params.items():
        local = placed[k].to_local()
        if not torch.equal(local.cpu(), leaf):
            fail(f"elastic: the local shard of {k} differs from its leaf")
    print(f"multi-device elastic: lm20m checkpoint of step {step} restored "
          f"and resharded onto a {grid.shape} grid: {len(placed)} leaves, "
          f"every local shard torch.equal to its leaf; {wall:.2f} s wall; "
          f"card {card}")
    return {"step": step, "leaves": len(placed), "wall_s": wall}


# the model cell: phi4-mini at full width on a (1, 1) mesh, each
# STANDARD_SHAPE's batch cut to what one card holds, {cell: (batch,
# layers or None for all)}; prefill_32k also cut to 4 of 32 layers (at 32
# layers a 2 x 32,768 prefill is 1.4 M eager kernels and 45.7 s of device
# time a run, and the phase runs it three times)
CELL_ARCH, CELL_SEED = "phi4_mini_3_8b", 0
CELL_CUTS = {"train_4k": (2, None), "prefill_32k": (2, 4),
             "decode_32k": (8, None)}
# the train cell's state starts at this step, the end of `cosine_lr`'s
# warm-up: the step's rate is the peak, so the step moves every parameter
CELL_STEP = 100


def _cell_fill_cache(torch, cache: dict, seed: int) -> None:
    """A random prefix in every K/V leaf of a decode cache (placed or
    plain), drawn layer by layer from one seeded generator of the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for j in sorted(cache):
        for name in ("k", "v"):
            leaf = cache[j]["attn"][name]
            t = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            for layer in t:
                layer.normal_(generator=gen)


def _device_ms_raw(torch, prof) -> float | None:
    """The summed duration of a profile's device activities (kernels,
    copies, sets), read from the raw kineto events: `key_averages` would
    first build an event object for each of the ~10^5 kernels of a step
    (a minute of host time)."""
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda)
    return total / 1e6 or None


def _cell_timed(torch, fn, args) -> dict:
    """One more call of a cell's step under torch.profiler: wall (to a
    synchronise), device time, busy share, peak memory."""
    from torch.profiler import ProfilerActivity, profile

    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = _device_ms_raw(torch, prof)
    return {"wall_s": wall, "device_ms": dev,
            "busy_share": None if dev is None else dev / (wall * 1e3),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _host(t):
    """A copy of `t` on the host (a CPU tensor copied too)."""
    return t.to("cpu", copy=True)


def _rel(got, want) -> float:
    """max |got - want| over max |want| (float32, on the host)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def cell_phase(torch, device, card: str) -> dict:
    """The model cell at phi4-mini-3.8B's full width on a (1, 1) mesh of
    the world of one rank, for train_4k, prefill_32k and decode_32k at
    the CELL_CUTS cuts: built by `build_cell` (FSDP placements), placed
    by `place_cell` from CELL_SEED, run once under `analyze_step` and
    held against the unsharded step, then timed alone; the cell and the
    unsharded model never share the card.  Both train states (zero
    moments, as `adamw_init` makes them) start at step CELL_STEP, where
    the rate is the peak: the checked leaves are the loss, the four
    DP_CHECK parameters after the update and both their moments (m = 0.1
    x clip scale x g, v = 0.05 x (clip scale x g)^2).  On one rank the
    gradients are bit-exact, so the parameters are too (a reordered
    gradient sum would move a parameter by up to 2 x 0.45 x lr and
    fail)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.hlo_analysis import analyze_step, argument_bytes
    from repro_torch.launch.mesh import HBM_BYTES, make_host_mesh
    from repro_torch.launch.steps import (build_cell, make_prefill_step,
                                          make_serve_step, place_cell)
    from repro_torch.models import SHAPES_BY_NAME, ShapeSpec, build
    from repro_torch.optim.adamw import adamw_init, make_train_step

    full = configs.get(CELL_ARCH)
    mesh = make_host_mesh(device_type=device.type)
    out = {}
    for name, (batch, layers) in CELL_CUTS.items():
        cfg = full if layers is None else full.replace(n_layers=layers)
        std = SHAPES_BY_NAME[name]
        shape = ShapeSpec(name, std.seq_len, batch, std.kind)
        b, s = batch, std.seq_len
        rng = np.random.default_rng(31)
        _free_card(torch)
        walls = {}
        t0 = time.perf_counter()
        fn, specs, shards, _ = build_cell(cfg, shape, mesh)
        held_spec = argument_bytes(specs, shards)
        if shape.kind == "decode":
            tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
            args = place_cell(fn, specs, shards, (tok, None, s - 1),
                              seed=CELL_SEED, device=device)
            _cell_fill_cache(torch, args[2], CELL_SEED)
        else:
            data = {k: rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
                    for k in (("tokens", "labels") if shape.kind == "train"
                              else ("tokens",))}
            args = place_cell(fn, specs, shards, (data,), seed=CELL_SEED,
                              device=device)
            if shape.kind == "train":
                args[0].step.to_local().fill_(CELL_STEP)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = analyze_step(fn, *args)
        torch.cuda.synchronize()
        analysed_s = time.perf_counter() - t0
        stats = {k: r[k] for k in ("flops", "collectives", "argument_bytes")}
        if shape.kind == "train":
            st, m = r["out"]
            got = {"loss": _host(m["loss"].detach()),
                   **{k: _host(st.params[k].detach().full_tensor())
                      for k in DP_CHECK},
                   **{f"{n} {k}": _host(getattr(st, n)[k].full_tensor())
                      for n in ("m", "v") for k in DP_CHECK}}
        elif shape.kind == "prefill":
            got = {"logits": _host(r["out"].full_tensor())}
        else:
            nxt, cache = r["out"]
            got = {"next": _host(nxt.full_tensor()),
                   **{n: _host(cache["b0"]["attn"][n].to_local()[:, :, s - 1])
                      for n in ("k", "v")}}
        del r
        walls["copy_s"] = time.perf_counter() - t0 - analysed_s
        t1 = time.perf_counter()
        timed = _cell_timed(torch, fn, args)
        walls["timed_s"] = time.perf_counter() - t1
        del fn, args, specs, shards
        if shape.kind == "train":
            del st, m
        elif shape.kind == "decode":
            del nxt, cache
        _free_card(torch)
        # the unsharded step on the same weights and inputs
        t1 = time.perf_counter()
        model = build(cfg, device=device, seed=CELL_SEED)
        if shape.kind == "train":
            state = adamw_init(model, cfg.optimizer_dtype)
            state.step.fill_(CELL_STEP)
            state, m = make_train_step(model)(state, {
                k: torch.from_numpy(v).to(device) for k, v in data.items()})
            want = {"loss": _host(m["loss"].detach()),
                    **{k: _host(state.params[k].detach()) for k in DP_CHECK},
                    **{f"{n} {k}": _host(getattr(state, n)[k])
                       for n in ("m", "v") for k in DP_CHECK}}
            del state, m
        elif shape.kind == "prefill":
            want = {"logits": _host(make_prefill_step(model)(
                {"tokens": torch.from_numpy(data["tokens"]).to(device)}))}
        else:
            cache = model.init_cache(b, s)
            _cell_fill_cache(torch, cache, CELL_SEED)
            nxt, cache = make_serve_step(model)(
                torch.from_numpy(tok).to(device), cache, s - 1)
            want = {"next": _host(nxt),
                    **{n: _host(cache["b0"]["attn"][n][:, :, s - 1])
                       for n in ("k", "v")}}
            del cache, nxt
        del model
        _free_card(torch)
        walls["unsharded_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        if shape.kind == "decode":
            diff = {k: float((got[k].float() - want[k].float()).abs().max())
                    for k in got}
            ok = all(torch.equal(got[k], want[k]) for k in got)
            rule = "torch.equal"
        else:
            diff = {k: _rel(got[k], want[k]) for k in got}
            tol = 1e-5 if shape.kind == "train" else 1e-4
            ok = all(d <= tol for d in diff.values())
            rule = f"within {tol:g} relative"
        if not ok:
            fail(f"cell {name}: the cell's step differs from the unsharded "
                 f"step: {diff}")
        walls["check_s"] = time.perf_counter() - t1
        for k, v in got.items():
            if v.is_floating_point() and not torch.isfinite(v).all():
                fail(f"cell {name}: non-finite {k}")
        depth = (f"{cfg.n_layers} layers" if layers is None else
                 f"{cfg.n_layers} of {full.n_layers} layers (depth cut)")
        print(f"cell {name}: {CELL_ARCH} full width ({depth}, d "
              f"{cfg.d_model}, vocab {cfg.vocab}), mesh (1, 1) ('data', "
              f"'model'), FSDP placements; batch cut {std.global_batch} -> "
              f"{b} sequences of {s}; placed in {place_s:.2f} s; held "
              f"against the unsharded step: {rule}, largest difference "
              + ", ".join(f"{k} {v:.3g}" for k, v in diff.items())
              + f"; card {card}")
        c = stats["collectives"]
        dev = timed["device_ms"]
        print(f"cell {name}: step wall {timed['wall_s']:.3f} s (under the "
              f"profiler), device {dev if dev is None else round(dev, 1)} ms, "
              f"busy share {timed['busy_share']}, peak memory "
              f"{timed['peak_gb']:.2f} GB; the analysed run {analysed_s:.3f} "
              f"s; the phase's other walls: " + ", ".join(
                  f"{k} {v:.2f}" for k, v in walls.items()) + f"; card {card}")
        print(f"cell {name}: analyze_step flops {stats['flops']:.6g} "
              f"(one device); collectives {c['total_ops']} ops, "
              f"{c['total_bytes']} B: counts {c['counts_by_type']}, bytes "
              f"{c['bytes_by_type']}; argument bytes a device holds "
              f"{stats['argument_bytes']} ({held_spec} from the specs), "
              f"{stats['argument_bytes'] / HBM_BYTES:.4f} of HBM_BYTES "
              f"{HBM_BYTES}; card {card}")
        if stats["argument_bytes"] != held_spec:
            fail(f"cell {name}: {stats['argument_bytes']} argument bytes "
                 f"placed, {held_spec} by the specs")
        out[name] = {"batch": b, "seq": s, "layers": cfg.n_layers,
                     "cut_from": std.global_batch, "diff": diff,
                     "place_s": place_s, "analysed_s": analysed_s,
                     "walls": walls, **timed, **stats}
    return out


# the dry run (launch/dryrun.py) on the card's machine: phi4-mini's three
# cells at CELL_CUTS counted in a fake world of one rank, phi4-mini's
# STANDARD_SHAPES and DRYRUN_TRAIN's train_4k on the (32, 8) mesh in a
# fake world of 256, each count in a process of its own (the default
# process group is global), as many at once as the host has cores, the
# longest first (DRYRUN_ORDER); a process that outlives DRYRUN_TIMEOUT
# fails the phase
DRYRUN_TIMEOUT = 600
# train cells whose count once failed on the card's torch: the SSM's and
# the MoE's sums on a mesh (their probes too)
DRYRUN_TRAIN = ("mamba2_130m", "olmoe_1b_7b")
# the jobs by their count's wall on the card's host, longest first
DRYRUN_ORDER = ("prefill_32k", "card b", "train_4k", "olmoe_1b_7b",
                "mamba2_130m", "card a", "decode_32k", "long_500k")
DRYRUN_VARIANTS = ("base", "no_fsdp", "bf16_params")
PEAK_TOL = 0.10                 # predicted peak against the measured one
_DRY_CARD = """
import json, sys, time
from repro_torch import configs
from repro_torch.launch.dryrun import depth_count, fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import SHAPES_BY_NAME, ShapeSpec
fake_world(1)
mesh = make_host_mesh(device_type="cuda")
full = configs.get(sys.argv[1])
out = {}
for name, (batch, layers) in json.loads(sys.argv[2]).items():
    cfg = full if layers is None else full.replace(n_layers=layers)
    std = SHAPES_BY_NAME[name]
    t = time.perf_counter()
    out[name] = depth_count(cfg, ShapeSpec(name, std.seq_len, batch,
                                           std.kind), mesh, device="cuda")
    out[name]["count_s"] = time.perf_counter() - t
print(json.dumps(out))
"""


def dryrun_phase(torch, cells: dict, card: str) -> dict:
    """The dry run, in processes of its own started together: (1) the
    card check, phi4-mini's train_4k / decode_32k and prefill_32k cells
    at the CELL_CUTS shapes counted by `dryrun.depth_count` on fake CUDA
    tensors in a fake world of one rank ((1, 1) mesh), held against the
    cell phase's `analyze_step` of the same cells in this run (`cells`):
    flops, collectives and argument bytes equal, the predicted peak
    (argument + temp bytes) within PEAK_TOL of the measured
    `max_memory_allocated`; (2) the production mesh, `python -m
    repro_torch.launch.dryrun` for phi4-mini x the four STANDARD_SHAPES
    on (32, 8) in a fake world of 256 (decode_32k through `python -m
    repro_torch.launch.perf` over DRYRUN_VARIANTS, whose base row is the
    cell), every cell ok or skipped and without a probe error, its
    argument bytes equal to `hlo_analysis.argument_table`'s, the train_4k
    cell's peak within HBM_BYTES (FSDP gathers the weights, not the
    batch); (3) DRYRUN_TRAIN's train_4k cells on (32, 8), each ok and
    without a probe error."""
    from repro_torch.launch.dryrun import OUT_DIR
    from repro_torch.launch.hlo_analysis import argument_table
    from repro_torch.launch.perf import LOG as PERF_LOG
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.models import STANDARD_SHAPES

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    py = [sys.executable]
    card_cuts = {"a": {k: CELL_CUTS[k] for k in ("train_4k", "decode_32k")},
                 "b": {"prefill_32k": CELL_CUTS["prefill_32k"]}}
    jobs = {f"card {k}": py + ["-c", _DRY_CARD, CELL_ARCH, json.dumps(v)]
            for k, v in card_cuts.items()}
    for shape in STANDARD_SHAPES:
        if shape.name == "decode_32k":
            jobs[shape.name] = py + [
                "-m", "repro_torch.launch.perf", "--arch", CELL_ARCH,
                "--shape", shape.name, "--force", "--variants",
                *DRYRUN_VARIANTS]
        else:
            jobs[shape.name] = py + [
                "-m", "repro_torch.launch.dryrun", "--arch", CELL_ARCH,
                "--shape", shape.name, "--force"]
    for arch in DRYRUN_TRAIN:
        jobs[arch] = py + ["-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", "train_4k", "--force"]
    queue = sorted(jobs, key=lambda k: DRYRUN_ORDER.index(k)
                   if k in DRYRUN_ORDER else len(DRYRUN_ORDER))
    slots = max(1, os.cpu_count() or 1)
    logs = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    t0 = time.perf_counter()
    procs, starts = {}, {}
    outs, walls = {}, {}
    try:
        while len(walls) < len(jobs):
            while queue and len(procs) - len(walls) < slots:
                k = queue.pop(0)
                starts[k] = time.perf_counter() - t0
                with open(logs / f"{k}.out", "w") as o, \
                        open(logs / f"{k}.err", "w") as e:
                    procs[k] = subprocess.Popen(jobs[k], cwd=ROOT, env=env,
                                                stdout=o, stderr=e)
            if time.perf_counter() - t0 > DRYRUN_TIMEOUT:
                late = sorted(set(jobs) - set(walls))
                fail(f"dryrun {late}: no result within {DRYRUN_TIMEOUT} s")
            for k, proc in list(procs.items()):
                if k not in walls and proc.poll() is not None:
                    walls[k] = time.perf_counter() - t0 - starts[k]
                    outs[k] = (logs / f"{k}.out").read_text()
                    if proc.returncode:
                        fail(f"dryrun {k}: exit {proc.returncode}: "
                             f"{outs[k][-2000:]}"
                             f"{(logs / f'{k}.err').read_text()[-3000:]}")
            time.sleep(0.2)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(logs, ignore_errors=True)
    phase_s = time.perf_counter() - t0

    # (1) the card check
    got = {}
    for k in card_cuts:
        got.update(json.loads(outs[f"card {k}"].strip().splitlines()[-1]))
    out = {"card": {}, "production": {}, "walls": walls, "phase_s": phase_s}
    for name, cell in cells.items():
        d = got[name]
        pred, meas = d["peak_bytes"], cell["peak_gb"] * 1e9
        ratio = pred / meas
        print(f"dryrun card {name}: {CELL_ARCH} at the cell's cut ("
              f"{cell['layers']} layers, batch {cell['batch']} of "
              f"{cell['seq']}), fake CUDA tensors in a fake world of one "
              f"rank, counted at depths {d['counted_at']} in "
              f"{d['count_s']:.1f} s: flops {d['flops']:.6g} (cell "
              f"{cell['flops']:.6g}), collectives "
              f"{d['collectives']['total_ops']} ops "
              f"{d['collectives']['total_bytes']} B (cell "
              f"{cell['collectives']['total_ops']} ops "
              f"{cell['collectives']['total_bytes']} B), argument bytes "
              f"{d['argument_bytes']} (cell {cell['argument_bytes']}), bytes "
              f"accessed {d['bytes_accessed']}, predicted peak "
              f"{pred / 1e9:.3f} GB (argument {d['argument_bytes'] / 1e9:.3f}"
              f" + temp {d['memory_analysis']['temp_size_in_bytes'] / 1e9:.3f}"
              f"), measured {cell['peak_gb']:.3f} GB, ratio {ratio:.4f}; "
              f"card {card}")
        if d["flops"] != cell["flops"]:
            fail(f"dryrun card {name}: {d['flops']} flops, the cell ran "
                 f"{cell['flops']}")
        for key in ("bytes_by_type", "counts_by_type"):
            if d["collectives"][key] != cell["collectives"][key]:
                fail(f"dryrun card {name}: collectives {key} "
                     f"{d['collectives'][key]}, the cell's "
                     f"{cell['collectives'][key]}")
        if d["argument_bytes"] != cell["argument_bytes"]:
            fail(f"dryrun card {name}: {d['argument_bytes']} argument "
                 f"bytes, the cell held {cell['argument_bytes']}")
        if abs(ratio - 1) > PEAK_TOL:
            fail(f"dryrun card {name}: predicted peak {pred} B is "
                 f"{ratio:.4f} of the measured {meas:.0f} B")
        out["card"][name] = {**{k: d[k] for k in (
            "flops", "bytes_accessed", "collectives", "memory_analysis",
            "peak_bytes", "count_s", "counted_at")}, "measured_peak_gb":
            cell["peak_gb"], "ratio": ratio}

    # (2) the production mesh
    table = {r["shape"]: r["fsdp"] for r in argument_table()
             if r["arch"] == CELL_ARCH}
    for shape in STANDARD_SHAPES:
        tag = f"{CELL_ARCH}__{shape.name}__32x8"
        r = json.loads((OUT_DIR / f"{tag}.json").read_text())
        if not (r.get("ok") or r.get("skipped")) or "probe_error" in r:
            fail(f"dryrun {tag}: {r.get('error') or r.get('probe_error')}")
        out["production"][shape.name] = r
        if r.get("skipped"):
            print(f"dryrun {tag}: skipped ({r['reason']})")
            continue
        held = r["memory_analysis"]["argument_size_in_bytes"]
        if held != table[shape.name]:
            fail(f"dryrun {tag}: {held} argument bytes, argument_table "
                 f"{table[shape.name]}")
        roof = r["roofline"]
        fits = "fits" if r["peak_bytes"] <= HBM_BYTES else "does not fit"
        if shape.name == "train_4k" and r["peak_bytes"] > HBM_BYTES:
            fail(f"dryrun {tag}: peak {r['peak_bytes']} B over HBM_BYTES "
                 f"{HBM_BYTES}")
        print(f"dryrun {tag}: {r['chips']} fake ranks, device "
              f"{r['device']}, counted at depths {r['counted_at']} in "
              f"{r['count_s']} s; argument bytes {held} (argument_table "
              f"{table[shape.name]}), peak {r['peak_bytes'] / 1e9:.3f} GB "
              f"beside HBM_BYTES {HBM_BYTES / 1e9:g} GB: {fits}; flops "
              f"{r['flops']:.6g}, bytes accessed {r['bytes_accessed']}, "
              f"collectives {r['collectives']['total_bytes']} B; roofline "
              f"(probes) compute {roof['compute_s']:.6g} s, memory "
              f"{roof['memory_s']:.6g} s, collective "
              f"{roof['collective_s']:.6g} s, dominant {roof['dominant']}")
    # (3) the train cells that once failed on the card's torch
    for arch in DRYRUN_TRAIN:
        tag = f"{arch}__train_4k__32x8"
        r = json.loads((OUT_DIR / f"{tag}.json").read_text())
        if not r.get("ok") or "probe_error" in r:
            fail(f"dryrun {tag}: {r.get('error') or r.get('probe_error')}")
        out["production"][arch] = r
        roof = r["roofline"]
        print(f"dryrun {tag}: {r['chips']} fake ranks, device "
              f"{r['device']}, counted at depths {r['counted_at']} in "
              f"{r['count_s']} s, probes without error; peak "
              f"{r['peak_bytes'] / 1e9:.3f} GB beside HBM_BYTES "
              f"{HBM_BYTES / 1e9:g} GB; flops {r['flops']:.6g}, collectives "
              f"{r['collectives']['total_bytes']} B; roofline (probes) "
              f"compute {roof['compute_s']:.6g} s, memory "
              f"{roof['memory_s']:.6g} s, collective "
              f"{roof['collective_s']:.6g} s, dominant {roof['dominant']}")
    out["perf"] = json.loads(PERF_LOG.read_text())[-1]["rows"]
    for row in out["perf"]:
        if "error" in row:
            fail(f"dryrun perf {row['variant']}: {row['error']}")
        print(f"dryrun perf {CELL_ARCH} decode_32k {row['variant']}: bound "
              f"{row['bound_s']:.6g} s (compute {row['compute_s']:.6g}, "
              f"memory {row['memory_s']:.6g}, collective "
              f"{row['collective_s']:.6g}, dominant {row['dominant']}), "
              f"argument bytes {row['arg_bytes']}, temp bytes "
              f"{row['temp_bytes']}")
    print(f"dryrun: phase {phase_s:.1f} s on {slots} host cores; process "
          "walls (started at) " + ", ".join(
              f"{k} {v:.1f} s ({starts[k]:.1f})" for k, v in walls.items())
          + f"; card {card}")
    return out


def _check_engine_scan(torch, label, args, kw, outs):
    """A recorded E1 launch replayed from its input carry over its first
    SIM_REPLAY_EVENTS events, by the plain version and by E1 again: every
    carry tensor equal (the whole launch is held against the one-launch /
    chunked runs, the golden and the JAX fixture in its path)."""
    from repro_torch.kernels import engine_scan as es

    carry, flags, params, a, w, pab, pcd, pq, tables, consts = args
    k = min(a.shape[1], SIM_REPLAY_EVENTS)
    trace = (a[:, :k], w[:, :k], pab, pcd, pq)
    want = es.engine_scan_plain(clone_carry(carry), flags, params, *trace,
                                tables, consts)
    got, err = es.engine_scan_cuda(clone_carry(carry), flags, params,
                                   *trace, tables, consts)
    es.raise_refused([err])
    carry_equal(torch, label, got, want)
    if k == a.shape[1]:
        carry_equal(torch, label, outs[0], want)
    return 0.0, (tuple(carry[0].shape[:2]), a.shape[1]), \
        f"bit-exact on every carry tensor over the first {k} events"


def engine_bound(torch, cfg, inputs, events: int, carry) -> float:
    """E1's byte bound in ms for one launch over the trace's first `events`
    events from the zero state, counted from this run's data (`carry` is
    the launch's final carry) at HBM_BYTES_PER_S, in 32-byte sectors where
    the access is scattered:
      * the trace read once (a 4-byte address and a write flag an event a
        workload; every scheme lane of a workload shares its row);
      * every lane's small state (LLC arrays, metadata cache, LCT, clocks,
        stats) read once and written once;
      * mem_state read at the sectors of the groups the lane's workload
        touches (from the zero state the first touch of a group is a miss,
        which reads it) and written at the sectors whose final state is
        not S_U (only an eviction writes mem_state);
      * the three fit bitmaps read at the sectors of a workload's groups
        that some lane left compressed (the eviction that did it read them).
    It is far below the real floor, the chain of dependent reads inside a
    lane (`one_lane_us_per_event` in the engine's timing row)."""
    from repro_torch.compression.predictor import LCT_ENTRIES
    from repro_torch.kernels.engine_scan import N_STATS

    flags, params, a, w, pab, pcd, pq = inputs
    n_s, n_w = flags.shape[0], a.shape[0]
    sector = 32
    n_sec = -(-cfg.n_groups // sector)
    touched = torch.zeros((n_w, n_sec), dtype=torch.bool, device=a.device)
    touched.scatter_(1, (a[:, :events] >> 2).long() // sector, True)
    left = carry[5].ne(0)
    pad = n_sec * sector - cfg.n_groups
    if pad:
        left = torch.cat([left, left.new_zeros(n_s, n_w, pad)], -1)
    written = left.view(n_s, n_w, n_sec, sector).any(-1)
    sw, mm = cfg.llc_sets * cfg.llc_ways, cfg.meta_sets * cfg.meta_ways
    small = 5 * 4 * sw + 2 * 4 * mm + mm + LCT_ENTRIES + 4 * (3 + N_STATS)
    moved = (n_w * events * 5 + 2 * n_s * n_w * small
             + sector * (n_s * int(touched.sum()) + int(written.sum())
                         + 3 * int(written.any(0).sum())))
    return moved / HBM_BYTES_PER_S * 1e3


def engine_lanes(torch, cfg, inputs, rows, names, events: int) -> dict:
    """Which lanes set the length of one E1 launch of the paper sweep:
    each lane's device clock (%globaltimer) at the start and the end of
    its events, from one more launch from the zero state.  Prints the
    five slowest lanes (scheme row, workload, us an event, share of
    events that missed the LLC) and the slowest lane of each row."""
    from repro_torch.core.engine import (build_engine, device_tables,
                                         engine_consts)
    from repro_torch.kernels import engine_scan as es

    flags, params, a, w, pab, pcd, pq = inputs
    n_w = a.shape[0]
    carry = build_engine(cfg).init_state(params, n_w, device=a.device)
    ns = torch.zeros((flags.shape[0] * n_w, 2), dtype=torch.int64,
                     device=a.device)
    _, err = es.engine_scan_cuda(carry, flags, params, a[:, :events],
                                 w[:, :events], pab, pcd, pq,
                                 device_tables(cfg, a.device),
                                 engine_consts(cfg), lane_ns=ns)
    es.raise_refused([err])
    t = ns.cpu().double()
    us = ((t[:, 1] - t[:, 0]) / 1e3 / events).tolist()
    miss = (carry[-1].reshape(-1, es.N_STATS)[:, es.ST_LLC_MISSES].cpu()
            .double() / events).tolist()
    lane = [{"row": rows[i // n_w], "workload": names[i % n_w],
             "us_per_event": us[i], "miss_share": miss[i]}
            for i in range(len(us))]
    slowest = sorted(lane, key=lambda r: -r["us_per_event"])
    by_row = {r: max(x["us_per_event"] for x in lane if x["row"] == r)
              for r in rows}
    out = {"span_ms": float(t[:, 1].max() - t[:, 0].min()) / 1e6,
           "start_spread_ms": float(t[:, 0].max() - t[:, 0].min()) / 1e6,
           "median_us_per_event": statistics.median(us),
           "slowest": slowest[:5], "slowest_by_row": by_row}
    print(f"engine lanes: paper sweep {len(lane)} lanes x {events} events, "
          f"one launch: first start to last end {out['span_ms']:.3f} ms, "
          f"starts within {out['start_spread_ms']:.3f} ms; median lane "
          f"{out['median_us_per_event']:.4f} us an event; slowest five: "
          + "; ".join(f"{r['row']} / {r['workload']} "
                      f"{r['us_per_event']:.4f} us an event, miss share "
                      f"{r['miss_share']:.4f}" for r in slowest[:5]))
    print("engine lanes: slowest lane of each row, us an event: "
          + ", ".join(f"{r} {v:.4f}" for r, v in by_row.items()))
    return out


def engine_rows(torch, device, plain_event_ms: float) -> dict:
    """E1 at the paper's sweep (27 x 10 lanes, 200,000 events): host time
    of the traces, device time of one launch (CUDA events, median of 3,
    each from a fresh carry), its byte bound and the device operations one
    wrapper call enqueues; then the sweep's first 2,000 events by E1 and by
    its plain version on the same tensors (equal carries), each timed."""
    from repro_torch.core import schemes
    from repro_torch.core.engine import SimConfig, build_engine
    from repro_torch.core.traces import all_workload_names
    from repro_torch.kernels.engine_scan import ERR_KINDS, raise_refused

    cfg = SimConfig()
    inputs, host_s = sim_inputs(torch, cfg, schemes.names(),
                                all_workload_names(), SIM_PAPER_EVENTS, 0,
                                device)
    flags, params, a, w, pab, pcd, pq = inputs
    eng = build_engine(cfg)

    def kernel_ms(events, rows=slice(None), loads=slice(None)):
        """E1 over the first `events` events of the given scheme rows and
        workloads from a fresh carry: CUDA-event time of the launch, median
        of 3; and the last carry."""
        fl, pr = flags[rows], params[rows]
        trace = (a[loads, :events], w[loads, :events], pab[loads],
                 pcd[loads], pq[loads])
        times = []
        for _ in range(3):
            carry = eng.init_state(pr, trace[0].shape[0], device=device)
            err = torch.zeros(ERR_KINDS, dtype=torch.int32, device=device)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            eng.run_chunk(carry, fl, pr, *trace, err=err)
            ev1.record()
            ev1.synchronize()
            raise_refused([err])
            times.append(ev0.elapsed_time(ev1))
        return statistics.median(times), carry

    sweep_ms, sweep_carry = kernel_ms(SIM_PAPER_EVENTS)
    lanes_row = engine_lanes(torch, cfg, inputs, schemes.names(),
                             all_workload_names(), SIM_PAPER_EVENTS)
    # the per-event rate of one lane beside all lanes over the same events
    # (cram on libq): equal rates mean the chain inside a lane bounds E1
    cram = schemes.names().index("cram")
    libq = all_workload_names().index("libq")
    lane_ms, _ = kernel_ms(SIM_LANE_EVENTS, slice(cram, cram + 1),
                           slice(libq, libq + 1))
    lanes_ms, _ = kernel_ms(SIM_LANE_EVENTS)
    prefix_ms, got = kernel_ms(SIM_PREFIX_EVENTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sim_run(torch, cfg, inputs, plain=True, events=SIM_PREFIX_EVENTS)
    torch.cuda.synchronize()
    prefix_plain_ms = (time.perf_counter() - t0) * 1e3
    carry_equal(torch, "E1 on the paper sweep's first events", got, want)
    carry = eng.init_state(params, a.shape[0], device=device)
    err = torch.zeros(ERR_KINDS, dtype=torch.int32, device=device)
    kpc = kernels_per_call(torch, lambda: eng.run_chunk(
        carry, flags, params, a[:, :SIM_PREFIX_EVENTS],
        w[:, :SIM_PREFIX_EVENTS], pab, pcd, pq, err=err))
    raise_refused([err])
    if kpc != 1:
        fail(f"engine scan: {kpc} device operations a call, expected one")
    lanes = flags.shape[0] * a.shape[0]
    row = {
        "shape": [flags.shape[0], a.shape[0], SIM_PREFIX_EVENTS],
        "ms": prefix_ms, "plain_ms": prefix_plain_ms,
        "bound_ms": engine_bound(torch, cfg, inputs, SIM_PREFIX_EVENTS,
                                 got),
        "bound_by": "bytes", "library_ms": None, "kernels_per_call": kpc,
        "sweep_shape": [flags.shape[0], a.shape[0], SIM_PAPER_EVENTS],
        "sweep_ms": sweep_ms,
        "sweep_bound_ms": engine_bound(torch, cfg, inputs,
                                       SIM_PAPER_EVENTS, sweep_carry),
        "sweep_us_per_event": sweep_ms * 1e3 / SIM_PAPER_EVENTS,
        "plain_ms_per_event_check": plain_event_ms,
        "one_lane_us_per_event": lane_ms * 1e3 / SIM_LANE_EVENTS,
        "all_lanes_us_per_event": lanes_ms * 1e3 / SIM_LANE_EVENTS,
        # the latency floor: the events run one after another at one
        # lane's measured rate
        "chain_floor_ms": lane_ms * SIM_PREFIX_EVENTS / SIM_LANE_EVENTS,
        "sweep_chain_floor_ms": lane_ms * SIM_PAPER_EVENTS / SIM_LANE_EVENTS,
        "traces_host_s": host_s, "lanes": lanes_row}
    print(f"timing [engine] engine_scan: paper sweep {lanes} lanes x "
          f"{SIM_PAPER_EVENTS} events: host traces {host_s:.2f} s; device "
          f"time: kernel {sweep_ms:.3f} ms (median of 3), "
          f"{row['sweep_us_per_event']:.4f} us an event, bound "
          f"{row['sweep_bound_ms']:.4f} ms (bytes), one lane's chain "
          f"{row['sweep_chain_floor_ms']:.3f} ms, library none; kernels "
          f"per call {kpc}; plain version {plain_event_ms:.3f} ms an event "
          f"at {len(SIM_CHECK_NAMES) * 10} lanes x {SIM_CHECK_EVENTS} events "
          f"(wall); first {SIM_PREFIX_EVENTS} events: kernel "
          f"{prefix_ms:.3f} ms, plain {prefix_plain_ms:.1f} ms (wall), bound "
          f"{row['bound_ms']:.4f} ms (bytes), one lane's chain "
          f"{row['chain_floor_ms']:.3f} ms; first {SIM_LANE_EVENTS} events: "
          f"one lane (cram / libq) {row['one_lane_us_per_event']:.4f} us an "
          f"event, {lanes} lanes {row['all_lanes_us_per_event']:.4f} us an "
          "event")
    return {"engine_scan": row}


# ------------------------------------------ phase 6: the main path's calls

def _check_window_pack(torch, label, args, kw, outs):
    from repro_torch.kernels import bdi_pack

    want = bdi_pack.pack_window_plain(*args)
    for key, g, r in zip(PACK_OUTPUTS, outs, want, strict=True):
        if not torch.equal(g, r):
            fail(f"{label}: {key} differs from the plain version")
    return 0.0, tuple(args[0].shape), "bit-exact on 5 outputs"


def _check_batched_decode(torch, label, args, kw, outs):
    from repro_torch.kernels import cram_attention as ca

    out, byts = outs
    ref, ref_b = ca.cram_decode_attention_batched_plain(*args, **kw)
    err = _close(torch, label, out, ref)
    if not torch.equal(byts, ref_b):
        fail(f"{label}: bytes {byts.tolist()} != {ref_b.tolist()}")
    # the flat entry on the physical view: an in-place launch (kept as its
    # view) gives its bits, and so does a flat launch again
    flat, flat_b = ca.cram_decode_attention_batched_cuda(*args, **kw)
    if not (torch.equal(out.view(torch.int32), flat.view(torch.int32))
            and torch.equal(byts, flat_b)):
        fail(f"{label}: not bit for bit the flat entry's output and bytes")
    return err, tuple(args[1].shape), (f"within atol=rtol={ATOL}, bytes "
                                       "exact, bit for bit the flat entry")


def _check_single_decode(torch, label, args, kw, outs):
    from repro_torch.kernels import cram_attention as ca

    ref = ca.cram_decode_attention_plain(*args, **kw)
    return (_close(torch, label, outs, ref), tuple(args[1].shape),
            f"within atol=rtol={ATOL}")


def _close(torch, label, out, ref) -> float:
    if not torch.isfinite(out).all():
        fail(f"{label}: non-finite output")
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL):
        fail(f"{label}: max |diff| {err:.3e} beyond atol=rtol={ATOL}")
    return err


def _check_group_pack(torch, label, args, kw, outs):
    pages = args[0]
    plain = page_codec(len(pages)).pack_pages
    ok, packed, base = plain(*pages)
    for key, g, r in zip(("packed", "base", "ok"), outs, (packed, base, ok),
                         strict=True):
        if not torch.equal(g, r):
            fail(f"{label}: {key} differs from the plain version")
    return 0.0, tuple(pages[0].shape), "bit-exact on 3 outputs"


def _check_unpack(torch, label, args, kw, outs):
    packed, base, lanes = args
    plain = page_codec(lanes).unpack_pages
    for j, (g, r) in enumerate(zip(outs, plain(packed, base), strict=True)):
        if not torch.equal(g, r):
            fail(f"{label}: lane {j} differs from the plain version")
    return 0.0, tuple(packed.shape), f"bit-exact on {lanes} pages"


def _check_scan(torch, label, args, kw, outs):
    """The one-launch scan against the plain version on the card, in
    chunks of SCAN_CHUNK lines (each at its own first slot) over every
    line."""
    from repro_torch.kernels import compress_scan as cs

    lines = args[0]
    for o in range(0, lines.shape[0], SCAN_CHUNK):
        want = cs.compress_scan_plain(lines[o:o + SCAN_CHUNK], first_slot=o,
                                      **kw)
        for key in SCAN_OUTPUTS:
            if not torch.equal(outs[key][o:o + SCAN_CHUNK], want[key]):
                fail(f"{label}: {key} differs from the plain version in the "
                     f"chunk at line {o}")
    return 0.0, tuple(lines.shape), "bit-exact on 4 outputs, every line"


MAIN_PATH_CHECKS = {
    "pack_pair": _check_window_pack, "pack_quad": _check_window_pack,
    "decode_attention_pair": _check_batched_decode,
    "decode_attention_quad": _check_batched_decode,
    "decode_single_pair": _check_single_decode,
    "decode_single_quad": _check_single_decode,
    "pack_pair_group": _check_group_pack, "pack_quad_group": _check_group_pack,
    "unpack_pair": _check_unpack, "unpack_quad": _check_unpack,
    "compress_scan": _check_scan,
    "engine_scan": _check_engine_scan,
}


def check_main_path(torch, rec) -> dict:
    """Every launch the main path made, held against the plain version on
    a copy of its inputs (the checker of each kernel above).  Returns by
    kernel the calls checked, their distinct shapes and the largest
    |difference|."""
    seen: dict = {}
    for i, c in enumerate(rec.calls):
        if c["args"] is None:       # counted, not copied (A1)
            continue
        name = c["name"]
        label = f"{name} launch {i} ({c['path']}, {c['part']})"
        err, shape, how = MAIN_PATH_CHECKS[name](torch, label, c["args"],
                                                 c["kw"], c["outs"])
        s = seen.setdefault(name, {"calls": 0, "shapes": set(),
                                   "max_abs_err": 0.0, "how": how})
        s["calls"] += 1
        s["shapes"].add(shape)
        s["max_abs_err"] = max(s["max_abs_err"], err)
    counted = sum(c["args"] is None for c in rec.calls)
    print(f"main-path check: gqa_decode: {counted} launches counted, not "
          "copied (held against the plain version by the zoo and whisper "
          "parity lines and in phase 7)")
    for name, s in seen.items():
        s["shapes"] = sorted(s["shapes"])
        print(f"main-path check: {name}: {s['calls']} launches at "
              f"{len(s['shapes'])} shapes {s['shapes']}, max|diff| "
              f"{s['max_abs_err']:.3e} {s.pop('how')}")
    return seen


# -------------------------------------------------------- phase 7: timings

def _bound(moved: int) -> tuple[float, str]:
    """Every kernel's floor is counted in bytes (each input read once, each
    output written once, over 3.35 TB/s): integer compares and shifts (K1,
    K2, K4, K5) and per live position 4 flops per element against 2 bytes
    of K||V (K3, K6) are far below the card's rates for the bytes they
    move; K7's integer work has no row in the peak-rate table the port
    measures against, so its bytes (80 per line) are the floor counted."""
    return moved / HBM_BYTES_PER_S * 1e3, "bytes"


def pack_bound(args) -> tuple[float, str]:
    win, mk, en = args[:3]
    b, w, lanes, page, hkv, d2 = win.shape
    moved = (nbytes(win) + nbytes(mk) + nbytes(en)       # read
             + nbytes(win)                               # slots + overflow
             + b * w * hkv * (d2 + 2) * 2 + 2 * b * w)   # strips, lay, fit
    return _bound(moved)


def attention_bound(torch, args, kw) -> tuple[float, str]:
    """K3 and (with pred None and a batch of one) K6: the live rows of the
    slots this run's valid counts reach, their strips, q, markers, valid,
    the predictor and the outputs."""
    q, slots, strips, markers, valid, pred = args
    shared = kw.get("shared_cache", False)
    b, hq, d = q.shape
    n, page, hkv, d2 = slots.shape[-4:]
    v = valid if not shared else valid[None]
    top = torch.clamp(v.max(-1).values, max=page)          # live rows/slot
    dead = (v.sum((-1, -2)) == 0)[:, None]                 # no valid: all
    rows = int(torch.where(dead, torch.full_like(top, page), top).sum())
    live_slots = int((torch.where(dead, torch.ones_like(top), top) > 0).sum())
    moved = (nbytes(q) + rows * hkv * d2 * 2 + live_slots * hkv * (d2 + 2) * 2
             + nbytes(markers) + nbytes(valid) + b * hq * d * 4)
    if pred is not None:
        moved += nbytes(pred) + b * 8                      # + the byte pair
    return _bound(moved)


def sdpa_call(torch, args, kw):
    """scaled_dot_product_attention on the already-materialised bf16 K/V of
    the same inputs, as a zero-argument call (a yardstick; the port never
    calls it)."""
    from repro_torch.kernels.ref import decode_slots, strip_is_packed

    q, slots, strips, markers, valid = args[:5]
    lanes = kw["lanes"]
    b, hq, d = q.shape
    if kw.get("shared_cache"):
        slots, strips, valid = slots[None], strips[None], valid[None]
        slots, strips, valid = (x.expand(b, *x.shape[1:])
                                for x in (slots, strips, valid))
    n, page, hkv, d2 = slots.shape[-4:]
    pages = decode_slots(slots, strips, strip_is_packed(strips, markers),
                         lanes)
    kv = pages.reshape(b, n * lanes * page, hkv, d2).view(torch.bfloat16)
    g = hq // hkv                                        # (B, Hq, T, D)
    k = kv[..., :d].repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vv = kv[..., d:].repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(page, device=q.device) < valid[..., None]).reshape(
        b, 1, 1, -1)
    qb = q.to(torch.bfloat16)[:, :, None, :]             # (B, Hq, 1, D)
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qb, k, vv, attn_mask=mask)


def timing_spec(torch, name, args, kw) -> dict:
    """For kernel `name` on the inputs of one main-path launch: its shape,
    the kernel call, the plain call, the library call (or None) and the
    bound."""
    from repro_torch.kernels import bdi_pack
    from repro_torch.kernels import compress_scan as cs
    from repro_torch.kernels import cram_attention as ca

    if name in ("pack_pair", "pack_quad"):
        win = args[0]
        copy = torch.empty_like(win)
        return {"shape": win.shape,
                "kernel": lambda: bdi_pack.pack_window_cuda(*args),
                "plain": lambda: bdi_pack.pack_window_plain(*args),
                "library": None, "bound": pack_bound(args),
                "floor": ("copy_floor_ms", lambda: copy.copy_(win))}
    if name.startswith("decode_attention"):
        return {"shape": args[1].shape,
                "kernel": lambda: ca.cram_decode_attention_batched_cuda(
                    *args, **kw),
                "plain": lambda: ca.cram_decode_attention_batched_plain(
                    *args, **kw),
                "library": sdpa_call(torch, args, kw),
                "bound": attention_bound(torch, args, kw)}
    if name.startswith("decode_single"):
        one = (args[0][None], args[1][None], args[2][None], args[3],
               args[4][None], None)
        return {"shape": args[1].shape,
                "kernel": lambda: ca.cram_decode_attention_cuda(*args, **kw),
                "plain": lambda: ca.cram_decode_attention_plain(*args, **kw),
                "library": sdpa_call(torch, one, kw),
                "bound": attention_bound(torch, one, kw)}
    if name.endswith("_group"):
        pages = args[0]
        plain = page_codec(len(pages)).pack_pages
        groups = pages[0].numel() // math.prod(pages[0].shape[-3:])
        moved = (sum(nbytes(x) for x in pages) + nbytes(pages[0])
                 + nbytes(pages[0][..., 0, :, :]) + groups)   # ok: a byte
        return {"shape": pages[0].shape,
                "kernel": lambda: bdi_pack.pack_pages_cuda(pages),
                "plain": lambda: plain(*pages), "library": None,
                "bound": _bound(moved)}
    if name.startswith("unpack"):
        packed, base, lanes = args
        plain = page_codec(lanes).unpack_pages
        moved = nbytes(packed) + nbytes(base) + lanes * nbytes(packed)
        return {"shape": packed.shape,
                "kernel": lambda: bdi_pack.unpack_pages_cuda(packed, base,
                                                             lanes),
                "plain": lambda: plain(packed, base), "library": None,
                "bound": _bound(moved)}
    lines = args[0]
    n = lines.shape[0]
    return {"shape": lines.shape,
            "kernel": lambda: cs.compress_scan_cuda(lines, **kw),
            "plain": lambda: [cs.compress_scan_plain(
                lines[o:o + SCAN_CHUNK], first_slot=o, **kw)
                for o in range(0, n, SCAN_CHUNK)],
            "library": None, "bound": _bound(n * 64 + 4 * 4 * n),
            "floor": ("sum_floor_ms", word_sum(torch, lines))}


def word_sum(torch, lines):
    """A yardstick beside K7 that the port never calls: the int32 sum of
    each line's 16 words, which reads the image once and writes 4 B a
    line."""
    words = lines.view(torch.int32)
    return lambda: torch.sum(words, dim=1, dtype=torch.int32)


def measure(torch, name, spec) -> dict:
    """Device and eager-call times of one timing spec, beside its plain
    version, its bound and, for K3 and K6, the library call.  The scan's
    plain version walks a gigabyte in chunks and is timed eagerly (CUDA
    events around the call, three calls after one warm-up), not in a CUDA
    graph."""
    r = {"shape": list(spec["shape"])}
    big = name == "compress_scan"
    r["kernels_per_call"] = kernels_per_call(torch, spec["kernel"])
    r["ms"] = device_ms(torch, spec["kernel"], reps=10 if big else 20,
                        inner=3 if big else 10)
    r["call_ms"] = call_ms(torch, spec["kernel"], reps=5 if big else 20)
    if big:
        r["plain_ms"] = r["plain_call_ms"] = call_ms(
            torch, spec["plain"], reps=3, warmup=1)
    else:
        r["plain_ms"] = device_ms(torch, spec["plain"])
        r["plain_call_ms"] = call_ms(torch, spec["plain"])
    if spec["library"] is None:
        r["library_ms"] = r["library_call_ms"] = None
    else:
        r["library_ms"] = device_ms(torch, spec["library"])
        r["library_call_ms"] = call_ms(torch, spec["library"])
    r["bound_ms"], r["bound_by"] = spec["bound"]
    if "floor" in spec:     # a copy_ of a window's bytes, K7's word sum
        key, fn = spec["floor"]
        r[key] = device_ms(torch, fn, reps=10 if big else 20,
                           inner=3 if big else 10)
    return r


def print_rows(phase: str, rows: dict) -> None:
    def fmt(x):
        return "none" if x is None else f"{x:.4f} ms"

    for name, r in rows.items():
        floor = "".join(f", {label} {fmt(r[key])}"
                        for key, label in FLOORS.items() if key in r)
        print(f"timing [{phase}] {name} shape {r['shape']}: device time: "
              f"kernel {fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library "
              f"{fmt(r['library_ms'])}, bound {fmt(r['bound_ms'])} "
              f"({r['bound_by']}){floor}; kernels per call "
              f"{r['kernels_per_call']}; one eager call: kernel "
              f"{fmt(r['call_ms'])}, plain {fmt(r['plain_call_ms'])}, "
              f"library {fmt(r['library_call_ms'])}")


FLOORS = {"copy_floor_ms": "copy_ of the same bytes",
          "sum_floor_ms": "int32 sum of each line's words"}


def timing_rows(torch, rec, phase: str, paths) -> dict:
    """`measure` of every kernel at the most frequent shape the main path
    gave it."""
    rows = {}
    for name in KERNELS:
        saved = rec.most_frequent(name, paths)
        if saved is not None:
            rows[name] = measure(torch, name,
                                 timing_spec(torch, name, *saved))
    print_rows(phase, rows)
    return rows


def scan_source_rows(torch, rec, per_source: dict) -> dict:
    """K7 on each Fig. 4 source's slice of the scan path's image, beside
    the slice's byte bound and its int32 word sum.  Timing only: a slice's
    lines sit at other slot indices than in the image."""
    from repro_torch.kernels import compress_scan as cs

    lines = rec.most_frequent("compress_scan", ("scan",))[0][0]
    rows, ofs = {}, 0
    for name, st in per_source.items():
        part = lines[ofs:ofs + st["lines"]]
        ofs += st["lines"]
        n = part.shape[0]
        call = functools.partial(cs.compress_scan_cuda, part)
        r = {"lines": n, "kernels_per_call": kernels_per_call(torch, call),
             "ms": device_ms(torch, call, reps=10, inner=3),
             "bound_ms": _bound(n * 64 + 4 * 4 * n)[0],
             "sum_floor_ms": device_ms(torch, word_sum(torch, part), reps=10,
                                       inner=3)}
        rows[name] = r
        print(f"timing [scan-source] {name} lines {n}: device time: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes), "
              f"int32 sum of each line's words {r['sum_floor_ms']:.4f} ms; "
              f"kernels per call {r['kernels_per_call']}")
    return rows


def long_context_inputs(torch, rng, lanes, device):
    """B = LONG_BATCH sequences of LONG_TOKENS all-compressible synthetic
    tokens at the phi4 KV geometry, every token valid, a perfect
    predictor: the flat physical view (LONG_TOKENS / PAGE = 256 flat
    slots) as K3 takes it."""
    from repro_torch.kernels import ops
    from repro_torch.kv import synthetic_kv_stream
    from repro_torch.kv.cache import kv_bits

    k, v = synthetic_kv_stream(rng, LONG_BATCH, LONG_TOKENS, N_KV, HEAD_DIM)
    pages = kv_bits(k, v, device).reshape(
        LONG_BATCH, LONG_TOKENS // PAGE, PAGE, N_KV, 2 * HEAD_DIM)
    build = ops.build_cram_cache if lanes == 2 else ops.build_cram_cache_quad
    caches = [build(p) for p in pages]
    keys = ("slots", "slots_overflow", "strips", "packed_mask")
    cache = {key: torch.stack([c[key] for c in caches]) for key in keys}
    cache["markers"] = caches[0]["markers"]
    valid = torch.full((LONG_BATCH, LONG_TOKENS // PAGE), PAGE,
                       dtype=torch.int32, device=device)
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    slots, strips, markers, fvalid = pv(cache, valid)
    q = torch.from_numpy(rng.standard_normal(
        (LONG_BATCH, N_HEADS, HEAD_DIM)).astype("float32")).to(device)
    pred = cache["packed_mask"].to(torch.int32).contiguous()
    packed = float(cache["packed_mask"].float().mean())
    return (q, slots.contiguous(), strips.contiguous(), markers.contiguous(),
            fvalid.to(torch.int32).contiguous(), pred), packed


def long_context_rows(torch, device) -> dict:
    """K3 at B = 8 over 256 flat slots (4,096 tokens a sequence) and K6 on
    its first sequence, each checked once against its plain version (K6
    against K3's row bit for bit) and then measured as the main path's
    kernels are."""
    import numpy as np

    from repro_torch.kernels import cram_attention as ca

    rng = np.random.default_rng(11)
    rows = {}
    for lanes, kind in ((2, "pair"), (4, "quad")):
        args, packed = long_context_inputs(torch, rng, lanes, device)
        kw = {"lanes": lanes}
        err = check_attention_once(torch, args, kw, f"long-context {kind}")
        out, _ = ca.cram_decode_attention_batched_cuda(*args, **kw)
        one = (args[0][0], args[1][0], args[2][0], args[3], args[4][0])
        got = ca.cram_decode_attention_cuda(*one, **kw)
        if not torch.equal(got, out[0]):
            fail(f"long-context {kind}: K6 differs from K3's row 0")
        print(f"long-context {kind}: {packed:.4f} of the groups packed; K3 "
              f"max|diff| {err:.3e}, bytes exact; K6 equal to K3's row 0")
        for name, call in ((f"decode_attention_{kind}", args),
                           (f"decode_single_{kind}", one)):
            rows[name] = measure(torch, name,
                                 timing_spec(torch, name, call, kw))
    print_rows("long-context", rows)
    return rows


# K3 in place against the flat route: (label, sessions, groups attended,
# groups in the state, token range of a session); the serve attend's
# shape, and the kv_long cell's 32 sessions of 16k-57k tokens at its
# 2,048-group bucket, sliced out of a wider state
IN_PLACE_SHAPES = (("serve", 8, 16, 20, (200, 248)),
                   ("kv_long", 32, 4096, 4608, (16384, 57344)))


def in_place_inputs(torch, device, lanes, sessions, flat_slots, flat_state,
                    tokens, seed):
    """A serve-tier state made on the card from a seeded generator: every
    fourth session incompressible (raw groups, zero strips), the others
    packed (strip base rows, the marker on every head's tail), overflow
    slots of packed groups non-zero garbage, values bf16 bit patterns of
    magnitude 2^-7 to 2^7 (deltas against them stay finite); the attend's view of it as the tier
    hands it over (`kernel_cache_slice`, valid counts sliced out of the
    state's width, the layout as the predictor)."""
    import numpy as np

    from repro_torch.compression.framing import (DEFAULT_MARKER_KEY,
                                                 DOMAIN_PAIR, DOMAIN_QUAD)
    from repro_torch.kernels.ref import slot_markers
    from repro_torch.kv.cache import kernel_cache_slice

    gen = torch.Generator(device=device).manual_seed(seed)
    n, n_state = flat_slots // lanes, flat_state // lanes
    d2 = 2 * HEAD_DIM

    def draw(shape):       # bf16 bits: exponents 2^-7 .. 2^7, either sign
        x = torch.randint(0x3C00, 0x4300, shape, generator=gen,
                          device=device, dtype=torch.int16)
        sign = torch.randint(0, 2, shape, generator=gen, device=device,
                             dtype=torch.int16).mul_(0x4000)
        return x.sub_(sign).sub_(sign)

    over = ((sessions, n_state) if lanes == 2
            else (sessions, n_state, lanes - 1))
    packed = (torch.arange(sessions, device=device) % 4 != 3)[:, None] \
        .expand(sessions, n_state).contiguous()
    markers = torch.from_numpy(slot_markers(
        n_state, DEFAULT_MARKER_KEY,
        domain=DOMAIN_PAIR if lanes == 2 else DOMAIN_QUAD).view(np.int32)
        .copy()).to(device)
    strips = torch.zeros((sessions, n_state, N_KV, d2 + 2),
                         dtype=torch.int16, device=device)
    strips[..., :d2] = draw((sessions, n_state, N_KV, d2))
    strips[..., d2:] = markers.view(torch.int16).reshape(n_state, 1, 2)
    strips *= packed[..., None, None]
    st = {"slots": draw((sessions, n_state, PAGE, N_KV, d2)),
          "slots_overflow": draw(over + (PAGE, N_KV, d2)),
          "strips": strips, "packed_mask": packed, "markers": markers}
    rng = np.random.default_rng(seed)
    toks = rng.integers(tokens[0], tokens[1] + 1, sessions)
    pages = np.arange(flat_state)
    valid = torch.from_numpy(np.clip(toks[:, None] - pages[None] * PAGE, 0,
                                     PAGE).astype(np.int32)).to(device)
    cache = kernel_cache_slice(st, n)
    q = torch.from_numpy(rng.standard_normal(
        (sessions, N_HEADS, HEAD_DIM)).astype("float32")).to(device)
    return q, cache, valid[:, :flat_slots], cache["packed_mask"]


def in_place_row(torch, label, lanes, q, cache, valid, pred) -> dict:
    """One shape of `in_place_rows`: the check, then the timings."""
    from repro_torch.kernels import cram_attention as ca
    from repro_torch.kernels import ops

    kind = "pair" if lanes == 2 else "quad"
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    kw = {"lanes": lanes}

    def view():
        s, st, mk, v = pv(cache, valid)
        return (s.contiguous(), st.contiguous(), mk.contiguous(),
                v.to(torch.int32).contiguous(),
                pred.to(torch.int32).contiguous())

    args = view()

    def in_place():
        return ca.cram_decode_attention_in_place_cuda(q, cache, valid, pred,
                                                      **kw)

    def k3_flat():
        return ca.cram_decode_attention_batched_cuda(q, *args, **kw)

    def route():
        return ca.cram_decode_attention_batched_cuda(q, *view(), **kw)

    (out, byts), (ref, ref_b) = in_place(), k3_flat()
    torch.cuda.synchronize()
    if not (torch.equal(out.view(torch.int32), ref.view(torch.int32))
            and torch.equal(byts, ref_b)):
        fail(f"k3-in-place {label} {kind}: not bit for bit the flat route's "
             "output and bytes")
    timed = functools.partial(device_ms, torch, **(
        {"reps": 5, "inner": 2} if label == "kv_long" else {}))
    return {"kernels_per_call": kernels_per_call(torch, in_place),
            "in_place_ms": timed(in_place), "k3_flat_ms": timed(k3_flat),
            "view_ms": timed(view), "flat_route_ms": timed(route),
            "view_bytes": sum(nbytes(x) for x in args[:3])}


def in_place_rows(torch, device) -> dict:
    """K3's in-place entry (the serve tier's attend on the card) beside the
    flat route it replaced (the physical view copied out of the cache,
    then K3 on it) at the serve attend's and the kv_long cell's shapes,
    pair and quad: the two outputs and byte columns checked equal bit for
    bit, then the device time of each in a CUDA graph (ten calls at the
    serve shape, two at kv_long's) and of the view copy alone ("timing
    [k3-in-place]")."""
    rows = {}
    for label, sessions, flat, flat_state, tokens in IN_PLACE_SHAPES:
        for lanes, kind in ((2, "pair"), (4, "quad")):
            inputs = in_place_inputs(torch, device, lanes, sessions, flat,
                                     flat_state, tokens,
                                     seed=lanes * 1000 + sessions)
            r = {"sessions": sessions, "flat_slots": flat,
                 "state_flat_slots": flat_state,
                 **in_place_row(torch, label, lanes, *inputs)}
            del inputs
            torch.cuda.empty_cache()
            rows[f"{label}_{kind}"] = r
            print(f"timing [k3-in-place] {label} {kind}: {sessions} "
                  f"sessions x {flat} flat slots of a {flat_state}-slot "
                  f"state: output and bytes bit for bit the flat route's; "
                  f"device time: in place {r['in_place_ms']:.4f} ms, flat "
                  f"route {r['flat_route_ms']:.4f} ms (view copy "
                  f"{r['view_ms']:.4f} ms of {r['view_bytes'] / 1e9:.3f} "
                  f"GB, K3 on it {r['k3_flat_ms']:.4f} ms); kernels per "
                  f"call {r['kernels_per_call']}")
    return rows


# A1 at the decode cells' shapes: (name, B, T, length, Hkv, Hq, head_dim)
GQA_SHAPES = (("phi4_decode_ctx2k", 48, 3072, 2304, 8, 24, 128),
              ("olmoe_decode_chat", 1024, 256, 192, 16, 16, 128))


def _gqa_bound(q, k, length) -> tuple[float, str]:
    """A1's floor: the valid K/V rows of every sequence, q and the output
    once at 3.35 TB/s, or 4 x valid positions x Hq x head_dim FLOPs at the
    float32 rate, whichever is longer."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    moved = (2 * b * length * hkv * d * k.element_size()
             + 2 * b * hq * d * q.element_size())
    return max(_bound(moved),
               (4.0 * b * length * hq * d / 67e12 * 1e3, "float32 flops"))


def _gqa_plain(torch, q, k, v, length):
    """The port's decode attention before A1: the plain chunk loop in 1,024
    position chunks, normalised and cast as `chunked_decode_attention`
    does off the card."""
    from repro_torch.models.attention import decode_attention_state_plain

    m, l, o = decode_attention_state_plain(q, k, v, length, 1024)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def gqa_decode_rows(torch, device) -> dict:
    """A1 (`kernels/gqa_decode.py`, through `models/attention.py`'s two
    entries) at the two decode cells' shapes, bf16
    K/V and q: its output (largest |difference| over the largest value)
    and its state (over the rms) against the plain version in float32 on
    the same inputs, then its device time beside its byte bound (the valid K/V rows,
    q and the output once), the plain chunk loop the port ran before it
    (bf16, 1,024-position chunks) and `scaled_dot_product_attention`
    over the valid rows (`library_ms`, a yardstick the port never
    calls)."""
    from repro_torch.kernels import gqa_decode as gd
    from repro_torch.models import attention

    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}
    for name, b, t, length, hkv, hq, d in GQA_SHAPES:
        g = torch.Generator(device=device).manual_seed(7)
        q = torch.randn((b, hq, d), generator=g, device=device).to(bf16)
        k = torch.randn((b, t, hkv, d), generator=g, device=device).to(bf16)
        v = torch.randn((b, t, hkv, d), generator=g, device=device).to(bf16)
        pm, pl, po = attention.decode_attention_state_plain(
            q.to(f32), k.to(f32), v.to(f32), length, t)
        m, l, o = attention.decode_attention_state(q, k, v, length)
        out = attention.chunked_decode_attention(q, k, v, length)
        want = po / pl[..., None]

        def rel(got, ref):
            return float((got.to(f32) - ref).abs().max()
                         / ref.pow(2).mean().sqrt())

        # the output is rounded to bf16: within 2^-8 of the largest value
        errs = {"out": float((out.to(f32) - want).abs().max()
                             / want.abs().max()),
                "m": rel(m, pm), "l": rel(l, pl), "o": rel(o, po)}
        if errs["out"] > 2.0 ** -8 or max(errs["m"], errs["l"],
                                          errs["o"]) > 2e-5:
            fail(f"gqa decode {name}: differs from the plain version in "
                 f"float32: {errs}")
        width, splits = gd.split_geometry(b, hkv, hq, t)
        print(f"gqa decode {name}: B {b} T {t} length {length} Hkv {hkv} "
              f"Hq {hq} head_dim {d}, {splits} splits of {width}: "
              f"against the float32 plain version: output |diff| / max "
              f"{errs['out']:.3e} (bf16), |diff| / rms m {errs['m']:.3e}, l "
              f"{errs['l']:.3e}, o {errs['o']:.3e}")
        del pm, pl, po, want
        q4 = q[:, :, None]
        kv = (k[:, :length].transpose(1, 2), v[:, :length].transpose(1, 2))
        spec = {"shape": (b, t, hkv, d),
                "kernel": lambda q=q, k=k, v=v, n=length:
                    attention.chunked_decode_attention(q, k, v, n),
                "plain": lambda q=q, k=k, v=v, n=length:
                    _gqa_plain(torch, q, k, v, n),
                "library": lambda q4=q4, kv=kv:
                    torch.nn.functional.scaled_dot_product_attention(
                        q4, *kv, enable_gqa=True),
                "bound": _gqa_bound(q, k, length)}
        rows[name] = measure(torch, "gqa_decode", spec)
        rows[name].update(errs=errs, splits=splits, width=width,
                          length=length)
        del q, k, v, q4, kv
        torch.cuda.empty_cache()
    print_rows("gqa-decode", rows)
    for name, r in rows.items():
        want = 1 if r["splits"] == 1 else 2
        if r["kernels_per_call"] != want:
            fail(f"gqa decode {name}: {r['kernels_per_call']} device "
                 f"operations a call, expected {want}")
    return rows


def prefill_window_rows(torch, device) -> dict:
    """K1 and K2 at the prefill window (B = 8 sequences, W = 8 groups,
    64 groups at the phi4 KV geometry; compressible, incompressible and
    mixed sequences), timed as the main path's kernels are."""
    import numpy as np

    rng = np.random.default_rng(8)
    kinds = ["compressible", "incompressible", "mixed", "compressible"] * 2
    enabled = torch.ones(8, dtype=torch.bool, device=device)
    rows = {}
    for lanes, name in ((2, "pack_pair"), (4, "pack_quad")):
        win = kv_window(torch, rng, 8, 8, lanes, kinds, device)
        mk = torch.from_numpy(rng.integers(-2**15, 2**15, (8, 2)).astype(
            "int16")).to(device)
        rows[name] = measure(torch, name,
                             timing_spec(torch, name, (win, mk, enabled), {}))
    print_rows("prefill-window", rows)
    return rows


# the serve windows of the zoo's KV geometries: label -> paths, (Hkv, hd)
ZOO_WINDOWS = {
    "olmoe": (("zoo_olmoe_pair", "zoo_olmoe_quad_spill"), (16, 128)),
    "zamba2": (("zoo_zamba2_pair",), (32, 80)),
}


def zoo_window_rows(torch, rec, device) -> dict:
    """K1 and K2 at the serve windows of olmoe (Hkv 16, D2 256) and zamba2
    (Hkv 32, D2 160): the window each kernel was launched with most often
    on the geometry's zoo paths; where no path launched the kernel
    (zamba2 runs pair only), a synthetic window of the other kernel's
    (B, W) at that geometry (compressible, incompressible and mixed
    sequences).  Timed as the main path's kernels are, beside a copy_ of
    the window's bytes."""
    import numpy as np

    rng = np.random.default_rng(22)
    rows = {}
    for label, (paths, (hkv, hd)) in ZOO_WINDOWS.items():
        saved = {name: rec.most_frequent(name, paths)
                 for name in ("pack_pair", "pack_quad")}
        for lanes, name in ((2, "pack_pair"), (4, "pack_quad")):
            if saved[name] is not None:
                args = saved[name][0]
            else:
                (other,) = [v for v in saved.values() if v is not None]
                b, w = other[0][0].shape[:2]
                kinds = ["compressible", "incompressible", "mixed",
                         "compressible"] * (-(-b // 4))
                win = kv_window(torch, rng, b, w, lanes, kinds[:b], device,
                                hkv=hkv, hd=hd)
                args = (win, *other[0][1:3])
            if args[0].shape[-2:] != (hkv, 2 * hd):
                fail(f"zoo window {label}: {tuple(args[0].shape)} is not "
                     f"the Hkv {hkv}, D2 {2 * hd} geometry")
            rows[f"{label} {name}"] = measure(
                torch, name, timing_spec(torch, name, args, {}))
    print_rows("zoo-window", rows)
    return rows


def geometry_rows(torch, inputs: dict) -> dict:
    """K3 on phase 2's inputs at each of the reference's other head
    geometries (B = 8 sequences of 8 page groups: 16 pair / 32 quad flat
    slots), and K6 on its first sequence, timed as the main path's kernels
    are."""
    rows = {}
    for label, (lanes, args) in inputs.items():
        kind = "pair" if lanes == 2 else "quad"
        kw = {"lanes": lanes}
        one = (args[0][0].contiguous(), args[1][0], args[2][0], args[3],
               args[4][0])
        for name, call in ((f"decode_attention_{kind}", args),
                           (f"decode_single_{kind}", one)):
            rows[f"{name} {label}"] = measure(
                torch, name, timing_spec(torch, name, call, kw))
    print_rows("geometry", rows)
    return rows


def bulk_group_pages(torch, lanes, device) -> list:
    """The KV of BULK_SEQS sequences x BULK_TOKENS tokens of one layer at
    the phi4 KV geometry (2,048 pages of 64 KiB, 128 MiB) as `lanes` (G,
    page, Hkv, D2) int16 tensors, made on the card from a seeded
    torch.Generator: every delta within the codec's range of its group's
    base row (lane A's token-0 row), except that every eighth group has the
    last element of its last lane pushed 300 past that row."""
    d2 = 2 * HEAD_DIM
    groups = BULK_SEQS * BULK_TOKENS // PAGE // lanes
    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    lim = 128 if lanes == 2 else 8

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device,
                             dtype=torch.int16)

    row = draw(-3000, 3000, (groups, 1, N_KV, d2))
    pages = [row + draw(-lim, lim, (groups, PAGE, N_KV, d2))
             for _ in range(lanes)]
    pages[0][:, 0] = row[:, 0]
    pages[-1][::8, -1, -1, -1] = row[::8, 0, -1, -1] + 300
    return pages


def bulk_group_rows(torch, device) -> dict:
    """The group pack at the bulk shape: pair and quad held bit-exact
    against `pagepack` (packed, base and ok, the misfit groups told
    apart), then measured as the main path's kernels are."""
    from repro_torch.kernels import bdi_pack

    rows = {}
    for lanes, name in ((2, "pack_pair_group"), (4, "pack_quad_group")):
        pages = bulk_group_pages(torch, lanes, device)
        outs = bdi_pack.pack_pages_cuda(pages)
        torch.cuda.synchronize()
        _check_group_pack(torch, f"bulk-group {name}", (pages,), {}, outs)
        ok = outs[2]
        if not torch.equal(ok, torch.arange(ok.numel(), device=device) % 8
                           != 0):
            fail(f"bulk-group {name}: ok is not false exactly on every "
                 "eighth group")
        print(f"bulk-group {name}: {ok.numel()} groups of {lanes} pages "
              f"({sum(nbytes(x) for x in pages)} bytes) bit-exact against "
              f"pagepack, {int(ok.sum())} fit, the last-element misfit of "
              "every eighth group seen")
        rows[name] = measure(torch, name,
                             timing_spec(torch, name, (pages,), {}))
        del pages, outs, ok
    print_rows("bulk-group", rows)
    return rows


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=pathlib.Path, default=None,
                    help="also write the full report (launcher reports, "
                         "every timing) as JSON to this path")
    opts = ap.parse_args(argv)
    report_path = opts.report
    import torch

    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        return _main(torch, t_start, ckpt_dir, report_path)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _main(torch, t_start, ckpt_dir, report_path) -> int:
    """The phases (see the module docstring); `ckpt_dir` holds the train
    launcher path's checkpoints."""
    import numpy as np

    from repro_torch.kernels import bdi_pack, cuda_lib
    from repro_torch.kernels import compress_scan as cs
    from repro_torch.kernels import cram_attention as ca
    from repro_torch.kernels import engine_scan as es
    from repro_torch.kernels import gqa_decode as gd

    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # phase 1: build
    cuda_lib.load()
    print(f"build: {cuda_lib.build_seconds():.2f} s")
    for line in kernel_resources(cuda_lib):
        print(f"build: {line}")
    print(f"build: "
          f"{sass_count(cuda_lib, 'compress_scan', 'compress_scan_kernel')}")
    print(f"build: {engine_smem_line()}")

    # phase 2: kernels against their plain versions
    rng = np.random.default_rng(0)
    errs = {**check_pack(torch, rng, device),
            **check_attention(torch, rng, device),
            **check_page_codecs(torch, rng, device),
            **check_scan(torch, rng, device),
            **check_single_decode(torch, rng, device)}
    e1_errs, plain_event_ms = check_engine_scan(torch, device)
    errs.update(e1_errs)
    geo_errs, geo_inputs = check_geometries(torch, rng, device)
    errs = {name: max(e, geo_errs.get(name, 0.0)) for name, e in errs.items()}
    print(f"phase 2: {time.perf_counter() - t_start:.1f} s")

    # phases 3 to 5: thirty-one paths, each with the launch counters from 0
    from repro_torch.serving import ServeLoop

    rec = Recorder(torch)
    bdi_pack.pack_window_cuda = rec.wrap(
        lambda a, kw: "pack_pair" if a[0].shape[2] == 2 else "pack_quad",
        bdi_pack.pack_window_cuda, bdi_pack.LAUNCHES)
    ca.cram_decode_attention_batched_cuda = rec.wrap(
        lambda a, kw: ("decode_attention_pair" if kw.get("lanes", 2) == 2
                       else "decode_attention_quad"),
        ca.cram_decode_attention_batched_cuda, ca.LAUNCHES)
    ca.cram_decode_attention_in_place_cuda = rec.wrap(
        lambda a, kw: ("decode_attention_pair" if kw.get("lanes", 2) == 2
                       else "decode_attention_quad"),
        ca.cram_decode_attention_in_place_cuda, ca.LAUNCHES,
        as_flat=functools.partial(in_place_as_flat, torch))
    ca.cram_decode_attention_cuda = rec.wrap(
        lambda a, kw: ("decode_single_pair" if kw.get("lanes", 2) == 2
                       else "decode_single_quad"),
        ca.cram_decode_attention_cuda, ca.LAUNCHES)
    bdi_pack.pack_pages_cuda = rec.wrap(
        lambda a, kw: ("pack_pair_group" if len(a[0]) == 2
                       else "pack_quad_group"),
        bdi_pack.pack_pages_cuda, bdi_pack.LAUNCHES)
    bdi_pack.unpack_pages_cuda = rec.wrap(
        lambda a, kw: "unpack_pair" if a[2] == 2 else "unpack_quad",
        bdi_pack.unpack_pages_cuda, bdi_pack.LAUNCHES)
    cs.compress_scan_cuda = rec.wrap(lambda a, kw: "compress_scan",
                                     cs.compress_scan_cuda, cs.LAUNCHES)
    es.engine_scan_cuda = rec.wrap(lambda a, kw: "engine_scan",
                                   es.engine_scan_cuda, es.LAUNCHES)
    gd.gqa_decode_cuda = rec.wrap(lambda a, kw: "gqa_decode",
                                  gd.gqa_decode_cuda, gd.LAUNCHES, copy=False)
    launches = (bdi_pack.LAUNCHES, ca.LAUNCHES, cs.LAUNCHES, es.LAUNCHES,
                gd.LAUNCHES)
    for part in ("prefill", "step_all", "attend"):
        setattr(ServeLoop, part, rec.wrap_part(part, getattr(ServeLoop, part)))
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.models.whisper import Whisper

    for cls in (DecoderLM, Whisper):
        cls.decode_step = rec.wrap_model_step(cls.decode_step)
    by_path: dict = {}

    def drive(path, fn):
        for counts in launches:
            for key in counts:
                counts[key] = 0
        rec.path = path
        try:
            result = fn()
        finally:
            rec.path = None
        got = {k: v for counts in launches for k, v in counts.items()}
        for name in PATHS[path]:
            if got[name] == 0:
                fail(f"{path}: the {name} kernel never launched")
        calls = [c for c in rec.calls if c["path"] == path]
        if len(calls) != sum(got.values()):
            fail(f"{path}: {len(calls)} launches recorded, counters say "
                 f"{got}")
        steps = rec.loop_calls.get((path, "step_all"), 0)
        # A1 in the models' decode steps: once a layer that attends the
        # cache (a merge launch is not a call)
        model_steps = rec.model_steps.get(path, 0)
        layers = rec.attending.get(path, set())
        a1 = sum(c["name"] == "gqa_decode" and c["part"] == "model_step"
                 for c in calls)
        if len(layers) > 1 or a1 != model_steps * sum(layers):
            fail(f"{path}: {a1} A1 calls in {model_steps} decode steps "
                 f"whose caches are read by {sorted(layers)} layers")
        by_path[path] = {}
        for name in PATHS[path]:
            mine = [c for c in calls if c["name"] == name]
            prefill = sum(c["part"] == "prefill" for c in mine)
            if name == "gqa_decode":
                n, decode = model_steps, a1
            else:
                n = steps
                decode = sum(c["part"] in ("step_all", "attend")
                             for c in mine)
            by_path[path][name] = {
                "launches": got[name], "prefill": prefill,
                "decode_steps": n,
                "per_decode_step": decode / n if n else None}
        print(f"launches [{path}]: {by_path[path]}")
        return result

    # phase 3, first: training, while the card is empty
    t0 = time.perf_counter()
    training = {path: drive(path, lambda p=path: train_full_width(
        torch, p, card)) for path in TRAIN_RUNS}
    training["launcher"] = drive("train_launcher",
                                 lambda: train_launcher_phase(
                                     torch, card, ckpt_dir))
    training["parity"] = check_train_parity(torch, device)
    training["whisper"] = drive("whisper_train",
                                lambda: whisper_train_phase(torch, card))
    training["whisper_parity"] = check_whisper_parity(torch, device)
    print(f"training: {time.perf_counter() - t0:.1f} s")

    # the multi-device runtime's collective paths, in a world of one rank
    # under NCCL, while the card is still nearly empty
    t0 = time.perf_counter()
    multi = {}
    with nccl_world_of_one(torch):
        multi["dp"] = drive("multi_dp", lambda: dp_phase(torch, device,
                                                         card))
        multi["gpipe"] = drive("multi_gpipe",
                               lambda: gpipe_phase(torch, device, card))
        multi["elastic"] = drive("multi_elastic", lambda: elastic_phase(
            torch, device, ckpt_dir, card))
        print(f"multi-device collectives: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        multi["cell"] = drive("multi_cell",
                              lambda: cell_phase(torch, device, card))
        print(f"cell: {time.perf_counter() - t0:.1f} s")
    _free_card(torch)
    t0 = time.perf_counter()
    multi["dryrun"] = drive("dryrun", lambda: dryrun_phase(
        torch, multi["cell"], card))
    print(f"dryrun: {time.perf_counter() - t0:.1f} s")

    reports = {}
    launchers = {
        "pair": ("launcher_pair", ["--kv-packing", "pair"]),
        "quad": ("launcher_quad", ["--kv-packing", "quad"]),
        "spill": ("launcher_spill", SPILL_ARGV + ["--kv-policy", "auto"]),
        "spill_pair": ("launcher_spill_pair", SPILL_ARGV + [
            "--kv-policy", "dynamic", "--kv-packing", "pair",
            "--spill-packing", "quad"]),
    }
    for label, (path, extra) in launchers.items():
        t0 = time.perf_counter()
        reports[label] = r = drive(
            path, lambda lb=label, x=extra: run_launcher(
                torch, lb, LAUNCHER_ARGV + x, profile="--slots" not in x))
        walls, st = r["walls"], r["serve_tier"]
        print(f"launcher {label}: {time.perf_counter() - t0:.1f} s "
              f"(model build {walls['model_build_s']:.2f} s, model prefill + "
              f"decode {walls['model_prefill_decode_s']:.3f} s, serve tier "
              f"{walls['serve_tier_s']:.3f} s over "
              f"{st['serve_steps']} steps; decode "
              f"step {walls['decode_step_ms']:.2f} ms, of it on the device "
              f"{walls['decode_step_device_ms']} ms, busy share "
              f"{walls['decode_device_busy_share']}), "
              f"decode {r['tokens_per_s']} tokens/s, prefill "
              f"{r['prefill_tokens_per_s']} tokens/s; card {card}")
        if "--slots" in extra:
            print(f"launcher {label}: {' '.join(extra)}: admitted "
                  f"{st['admitted']}, retired {st['retired']}, evicted "
                  f"{st['evicted']}, woken {st['woken']}, spilled direct "
                  f"{st['spilled_direct']}, hot packing {st['hot_packing']}, "
                  f"spill tier {st['spill_tier']}")
            print(f"launcher {label}: policy_choice "
                  f"{json.dumps(st['policy_choice'])}; tier_observations "
                  f"{json.dumps(st['tier_observations'])}")
    zoo_parity = check_zoo_decode(torch, device)
    zoo = {path: drive(path, lambda p=path: run_zoo(torch, p, card))
           for path in ZOO_RUNS}
    t0 = time.perf_counter()
    zoo["whisper_serve"] = drive("whisper_serve",
                                 lambda: whisper_serve_phase(torch, card))
    print(f"whisper serve path: {time.perf_counter() - t0:.1f} s")
    phases = {}
    for packing in ("pair", "quad"):
        phases[packing] = drive(
            f"serve_attend_{packing}",
            lambda p=packing: serve_attend_phase(torch, p, device))
    small = drive("serve_attend_small",
                  lambda: serve_small_phase(torch, device))
    churn = {}
    for hot, spill in (("pair", "quad"), ("quad", "pair")):
        t0 = time.perf_counter()
        churn[hot] = drive(
            f"serve_churn_{hot}",
            lambda h=hot, sp=spill: serve_churn_phase(torch, h, sp, device,
                                                      card))
        print(f"serve churn {hot}/{spill}: {time.perf_counter() - t0:.1f} s "
              f"wall (card {card})")
    codec = {}
    for packing, ph in phases.items():
        check_final_state(torch, ph["loop"], packing)
        print(f"serve attend {packing}: attend max |diff| vs plain "
              f"{ph['max_abs_err']:.3e}")
        codec[packing] = drive(
            f"page_codec_{packing}",
            lambda v=ph["view"], p=packing: page_codec_roundtrip(torch, v, p))
    t0 = time.perf_counter()
    scan_report = drive("scan", lambda: scan_phase(torch, device))
    if by_path["scan"]["compress_scan"]["launches"] != 1:
        fail(f"scan: {by_path['scan']} launches, expected exactly one")
    print(f"scan path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sim = drive("trace_sim", lambda: trace_sim_phase(torch, device))
    print(f"trace sim path: {time.perf_counter() - t0:.1f} s")
    # the multi-device runtime's shardings on the one card: device lists
    # naming it several times
    t0 = time.perf_counter()
    multi["shard_attend"] = drive(
        "multi_shard_attend", lambda: shard_attend_phase(
            torch, {p: ph["loop"] for p, ph in phases.items()}, device,
            card))
    paper_inputs = sim.pop("paper_inputs")
    multi["shard_sweep"] = ss = drive(
        "multi_shard_sweep",
        lambda: shard_sweep_phase(torch, device, paper_inputs, card))
    ss["shard_ms"] = shard_sweep_times(torch, device, paper_inputs)
    del paper_inputs
    print(f"multi-device shard sweep: paper sweep {ss['lanes']} lanes x "
          f"{SIM_PAPER_EVENTS} events in {ss['shards']} shards: "
          f"{by_path['multi_shard_sweep']['engine_scan']['launches']} E1 "
          f"launches, every stat equal to the one-launch sweep; "
          f"{ss['wall_s']:.3f} s wall (synchronised, summaries excluded); "
          f"each shard alone: " + ", ".join(f"{t:.3f} ms"
                                           for t in ss["shard_ms"])
          + f" (device time, CUDA events); card {card}")
    print(f"multi-device shardings: {time.perf_counter() - t0:.1f} s")
    # the launch audit holds its own LAUNCHES against its golden; outside
    # a path, so that no launch copy of this script is in its counts
    t0 = time.perf_counter()
    audit = audit_phase(torch, card)
    print(f"audit: {time.perf_counter() - t0:.1f} s")

    # phase 6: every launch of phases 3 to 5 against its plain version
    t0 = time.perf_counter()
    main_path = check_main_path(torch, rec)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")

    # phase 7: timings at the shapes of phases 3 to 5
    t0 = time.perf_counter()
    timing = {
        "launcher": timing_rows(torch, rec, "launcher",
                                ("launcher_pair", "launcher_quad")),
        "serve-attend": timing_rows(torch, rec, "serve-attend",
                                    ("serve_attend_pair",
                                     "serve_attend_quad")),
        "page-codec": timing_rows(torch, rec, "page-codec",
                                  ("page_codec_pair", "page_codec_quad")),
        "scan": timing_rows(torch, rec, "scan", ("scan",)),
        "scan-source": scan_source_rows(torch, rec,
                                        scan_report["per_source"]),
        "long-context": long_context_rows(torch, device),
        "k3-in-place": in_place_rows(torch, device),
        "prefill-window": prefill_window_rows(torch, device),
        "zoo-window": zoo_window_rows(torch, rec, device),
        "geometry": geometry_rows(torch, geo_inputs),
        "bulk-group": bulk_group_rows(torch, device),
        "engine": engine_rows(torch, device, plain_event_ms),
        "gqa-decode": gqa_decode_rows(torch, device)}
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    for phase in ("page-codec", "bulk-group"):
        for name in ("pack_pair_group", "pack_quad_group"):
            n = timing[phase][name]["kernels_per_call"]
            if n != 1:
                fail(f"{phase} {name}: {n} device operations a call, "
                     "expected one launch")
    main_rows = {**timing["serve-attend"], **timing["page-codec"],
                 **timing["scan"], **timing["engine"]}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = main_rows[name]
        paths = {path: per[name] for path, per in by_path.items()
                 if name in per}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"] for p in paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(errs[name], main_path[name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "kernels_per_call": r["kernels_per_call"],
            **{k: r[k] for k in ("shape", "sweep_shape", "sweep_ms",
                                 "sweep_bound_ms", "chain_floor_ms",
                                 "sweep_chain_floor_ms") if k in r}})
    if report_path is not None:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(
            {"card": card, "launcher": reports, "zoo": zoo,
             "training": training,
             "zoo_parity": zoo_parity,
             "kernels": kernels,
             "ptxas": cuda_lib.ptxas_report(),
             "main_path_checks": main_path, "scan": scan_report,
             "page_codec": codec, "serve_attend_small": small,
             "serve_churn": churn, "trace_sim": sim, "audit": audit,
             "multi_device": multi,
             "single_vs_batched": {p: ph["single_vs_batched"]
                                   for p, ph in phases.items()},
             "timing": timing}, indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
