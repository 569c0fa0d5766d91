"""Run one `torch.distributed` world of CPU ranks (gloo) for a test.

`run_world(body, n)` runs a launcher in a subprocess; the launcher picks
a free localhost port and starts `n` rank processes, each of which joins
the gloo world over tcp, sets one thread and runs `body` (Python source)
with `RANK`, `WORLD` and `OUT` (a directory for results) defined.  Every
rank has a hard timeout: a hung rank is killed and the test fails with
each rank's stderr, instead of running the suite into its time limit."""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = """
import datetime, sys
import torch
import torch.distributed as dist
RANK, WORLD, PORT, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{PORT}",
                        world_size=WORLD, rank=RANK,
                        timeout=datetime.timedelta(seconds=60))
"""

LAUNCHER = """
import json, os, socket, subprocess, sys, time
spec = json.loads(sys.argv[1])
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
logs = [open(os.path.join(spec["out"], f"rank{r}.log"), "w")
        for r in range(spec["n"])]
procs = [subprocess.Popen([sys.executable, "-c", spec["code"], str(r),
                           str(spec["n"]), port, spec["out"]],
                          stdout=logs[r], stderr=subprocess.STDOUT)
         for r in range(spec["n"])]
deadline = time.monotonic() + spec["timeout"]
failed = []
for r, p in enumerate(procs):
    try:
        p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        p.wait()
        failed.append(f"rank {r} timed out")
    if p.returncode:
        failed.append(f"rank {r} exited {p.returncode}")
for r, log in enumerate(logs):
    log.close()
    if failed:
        with open(log.name) as f:
            failed.append(f"--- rank {r}\\n" + f.read()[-2500:])
if failed:
    sys.exit("\\n".join(failed))
"""


def run_world(body: str, n: int, out_dir, *, timeout: float = 75.0) -> None:
    """Run `body` on every rank of an n-rank gloo world; results are what
    the ranks write under `out_dir`.  Raises AssertionError when a rank
    fails or the world outlives `timeout` seconds."""
    code = RANK + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    spec = json.dumps({"code": code, "n": n, "out": str(out_dir),
                       "timeout": timeout})
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    proc = subprocess.run([sys.executable, "-c", LAUNCHER, spec],
                          capture_output=True, text=True, env=env,
                          timeout=timeout + 30)
    assert proc.returncode == 0, proc.stderr[-6000:]


def start_jax(body: str, out_dir, *, devices: int = 4):
    """Start `body` in a JAX process of `devices` forced host devices (the
    reference's oracle), with `OUT` (a directory for results) defined;
    `finish` waits for it.  It runs while the test runs the port."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count={devices}")
        os.environ["JAX_PLATFORMS"] = "cpu"
        OUT = {str(out_dir)!r}
    """) + textwrap.dedent(body)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    log = open(os.path.join(str(out_dir), "jax_oracle.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def finish(proc, *, timeout: float = 80.0) -> None:
    """Wait for a `start_jax` process; it must exit 0 within `timeout`."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.log.close()
    with open(proc.log.name) as f:
        log = f.read()
    assert proc.returncode == 0, log[-6000:]
