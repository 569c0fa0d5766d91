"""kv.host_ms (ms): the host's own time a tier step in the program's serve
spans, from `repro_torch.obs.snapshot()`: the wall time of `serve.step`,
`serve.attend`, `serve.admit` and `serve.retire` (each called at the top
level of a step, so none holds another), less the wall time of the
`host.sync` spans inside them (each device-to-host read and each copy
of a host array to the card opens one: the host may wait there for the
card's stream), over the number of `serve.attend` spans (one a step).

The program records only while a torch profiler runs, so the snapshot
covers the harness's two traced passes and nothing else (set-up, the
measured window and the check run with no profiler); dividing by the
attends makes it a value a step whatever the number of passes.  Both
passes run under the profiler, whose own cost a launch the host pays.
None where the program has no `repro_torch.obs` or opened no
`serve.attend`."""

SERVE = ("serve.step", "serve.attend", "serve.admit", "serve.retire")


def read(record):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.snapshot()["spans"]
    steps = spans.get("serve.attend", {}).get("n", 0)
    if not steps:
        return None
    wall = sum(spans[n]["wall_s"] for n in SERVE if n in spans)
    sync = spans.get("host.sync", {}).get("wall_s", 0.0)
    return 1e3 * (wall - sync) / steps
