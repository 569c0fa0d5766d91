"""The plain reference against the port at smoke size on the CPU: the
decoder's logits and cache rows (float32 on both sides, so they agree to
rounding), and the tier's attends and its layout, group by group.

  PYTHONPATH=src python -m pytest portbench/tests -q
"""

from __future__ import annotations

import pytest
import torch

from cells import run

from portbench import yardstick
from portbench.reference import kv as kvref

LOOSE = {"logit_gap": 1.0, "cache_rel_err": 1.0}


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_decoder_reference_equals_the_port_in_float32(kind):
    r = run(kind, limits=LOOSE, dtype="float32", control=True)
    got = r["readings"]
    assert got["logit_gap"] < 1e-4 and got["mismatch_share"] == 0.0
    assert got["cache_rel_err"] < 1e-5
    assert r["attempted"] >= 8 * 12


def test_kv_reference_equals_the_port():
    r = run("kv", limits={"attend_err": 1e-4, "layout_bytes_gap": 0,
                          "raw_bytes_gap": 0}, control=True, seconds=1.0)
    got = r["readings"]
    assert r["correct"]
    assert got["attend_err"] < 1e-5
    assert got["layout_bytes_gap"] == 0 and got["raw_bytes_gap"] == 0
    # a retirement and an admission by bulk pack happened in the window
    assert r["attempted"] > 4 * 32


def test_layout_equals_the_ports_packed_mask():
    """Group by group: the reference's fit of each live group against the
    packed mask the port's cache lays, for a compressible session, an
    incompressible one and one that alternates, at lengths that end on a
    group, inside one and on a page."""
    from repro_torch.serving import ServeLoop

    loop = ServeLoop(slots=3, max_pages=16, page=16, n_kv=2, head_dim=16,
                     policy="dynamic", packing="pair", device="cpu")
    slot, strip = yardstick.slot_bytes(16, 2, 16)
    streams = []
    for sid, comp in enumerate((True, False, True)):
        k, v = yardstick.kv_tokens("cpu", 7, sid, 0, 200, 2, 16, chunk=64,
                                   compressible=comp)
        if sid == 2:                       # one incompressible page
            ki, vi = yardstick.kv_tokens("cpu", 8, sid, 0, 200, 2, 16,
                                         chunk=64, compressible=False)
            k[48:64], v[48:64] = ki[48:64], vi[48:64]
        streams.append((k, v))
    lengths = [96, 77, 112]
    for sid, (k, v) in enumerate(streams):
        loop.prefill(sid, k[:lengths[sid]], v[:lengths[sid]])
    for _ in range(23):
        loop.step_all({sid: (k[lengths[sid]:lengths[sid] + 1],
                             v[lengths[sid]:lengths[sid] + 1])
                       for sid, (k, v) in enumerate(streams)})
        lengths = [n + 1 for n in lengths]
        for sid, (k, v) in enumerate(streams):
            lay = kvref.Layout(k[:lengths[sid]], v[:lengths[sid]], page=16,
                               slot=slot, strip=strip)
            n, span = lengths[sid], 32
            done, fill = divmod(n, span)
            want = list(lay.prefix_fit[:done, -1])
            if fill:
                want.append(bool(lay.prefix_fit[done, fill - 1]
                                 and lay.zero_fit[done]))
            rec = loop.seqs[sid]
            got = loop.cache.state["packed_mask"][rec.slot, :len(want)]
            assert got.tolist() == want, (sid, n)
    assert any(lay.prefix_fit[:, -1]) and not all(
        kvref.Layout(*streams[1], page=16, slot=slot,
                     strip=strip).prefix_fit[:, -1])
    assert torch.equal(loop.cache.state["packed_mask"][2, 1], torch.tensor(
        False))
