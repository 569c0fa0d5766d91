"""The check against a broken program, at smoke size on the CPU: the
harness's run with the look for a card skipped and the timed path
broken underneath must come out not correct, once for each fault a
serving cell can have, and so must the control (the reference in a
precision below the configuration's, put in the program's place).

Each small cell compares the numbers its full-size cell compares
(`portbench/workloads/`), with limits set at this size the way the
cell's were: above the sound program's reading and below the control's.

  PYTHONPATH=src python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from cells import run

WORKLOADS = pathlib.Path(__file__).resolve().parents[1] / "workloads"
COMPARED = {kind: list(json.loads((WORKLOADS / f"{cell}.json").read_text())
                       ["limits"])
            for kind, cell in (("dense", "phi4_mini.decode_ctx2k"),
                               ("moe", "olmoe_1b_7b.decode_chat"),
                               ("kv", "phi4_mini.kv_long"))}
# at this size: above the sound readings, below the control's
LIMITS = {"dense": {"own_gap": 0.0, "logit_gap": 0.03, "cache_rel_err": 0.04},
          "moe": {"own_gap": 0.0, "logit_gap_p50": 0.05, "logit_gap": 0.3,
                  "cache_rel_err": 0.04},
          "kv": {"attend_err": 3e-4, "layout_bytes_gap": 0,
                 "raw_bytes_gap": 0}}


def _limits(kind):
    return {k: LIMITS[kind][k] for k in COMPARED[kind]}


@pytest.mark.parametrize("kind", ["dense", "moe", "kv"])
def test_sound_program_is_correct_and_control_is_not(kind):
    r = run(kind, limits=_limits(kind), control=True)
    assert r["correct"], r["numbers"]
    ctrl = r["control"]
    assert any(ctrl[k] > v for k, v in _limits(kind).items()), ctrl


# ------------------------------------------------------------ decode faults

def _decode_fault(monkeypatch, fault: str):
    from repro_torch.launch import steps
    from repro_torch.models import attention, transformer

    if fault == "state_unchanged":
        apply = attention.attention_apply

        def no_write(p, cfg, x, *, cache=None, **kw):
            if cache is not None:
                cache = {k: t.clone() for k, t in cache.items()}
            return apply(p, cfg, x, cache=cache, **kw)

        monkeypatch.setattr(transformer, "attention_apply", no_write)
    elif fault == "half_batch":
        decode = transformer.DecoderLM.decode_step

        def half(self, token, cache, index, **kw):
            logits = decode(self, token, cache, index, **kw)
            b = logits.shape[0] // 2
            logits[b:] = logits[:b]
            return logits

        monkeypatch.setattr(transformer.DecoderLM, "decode_step", half)
    elif fault == "token_altered":
        make = steps.make_serve_step

        def altered(model):
            step = make(model)
            calls = [0]

            def serve(token, cache, index, **kw):
                tok, cache = step(token, cache, index, **kw)
                calls[0] += 1
                if calls[0] == 5:
                    tok = tok.clone()
                    tok[1] = (tok[1] + 1) % model.config.vocab
                return tok, cache
            return serve

        monkeypatch.setattr(steps, "make_serve_step", altered)


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_decode_fault_is_not_correct(monkeypatch, kind, fault):
    _decode_fault(monkeypatch, fault)
    r = run(kind, limits=_limits(kind), seconds=0.3)
    assert not r["correct"], r["numbers"]


# ---------------------------------------------------------------- kv faults

def _kv_fault(monkeypatch, fault: str):
    from repro_torch.serving import loop, slots

    if fault == "state_unchanged":
        def frozen(self, slot_ids, k, v, *, budget=0):
            z = torch.zeros(self.batch, dtype=torch.int32)
            return {"raw_per_seq": z, "cram_per_seq": z}

        monkeypatch.setattr(slots.SlotKVCache, "megastep", frozen)
    elif fault == "half_batch":
        attend = loop.ServeLoop.attend

        def half(self, q_by_seq, **kw):
            ids = sorted(q_by_seq)
            keep = ids[:len(ids) // 2]
            out = attend(self, {s: q_by_seq[s] for s in keep}, **kw)
            return {s: out[keep[i % len(keep)]] for i, s in enumerate(ids)}

        monkeypatch.setattr(loop.ServeLoop, "attend", half)
    elif fault == "answer_altered":
        attend = loop.ServeLoop.attend

        def altered(self, q_by_seq, **kw):
            out = attend(self, q_by_seq, **kw)
            sid = sorted(out)[1]
            out[sid] = out[sid].clone()
            out[sid][0, 0] += 0.01
            return out

        monkeypatch.setattr(loop.ServeLoop, "attend", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_kv_fault_is_not_correct(monkeypatch, fault):
    _kv_fault(monkeypatch, fault)
    r = run("kv", limits=_limits("kv"), seconds=0.5)
    assert not r["correct"], r["numbers"]
