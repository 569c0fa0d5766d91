"""Checkpoints in the reference's on-disk format, with the CRAM codec
(port of `repro.checkpoint.ckpt`).

Layout: <dir>/step_<n>/
    manifest.msgpack   — leaf keys, files, shapes, dtypes, codecs, sizes,
                         sha1s and the save's traffic rows
    leaf_<i>.bin       — raw or CRAM-compressed little-endian bytes
    COMMIT             — written last; `latest_step` trusts no step without

A tree is a `TrainState` or a nested dict of tensors or numpy arrays.  Its
leaves are written in the reference's order under the reference's keys: a
`TrainState` as `.params/...`, `.m/...`, `.v/...`, `.step` and
`.dyn_counter`, its layers stacked as the reference's `blocks/b{j}`
leaves (`repro_torch.convert.params_to_jax`), dict keys sorted.  So the
files and the manifest bytes equal the reference's for the same state,
and a checkpoint of either package restores in the other.  Writes go to
a temporary directory and are renamed into place; `CheckpointManager`
writes on a background thread from host copies it takes first.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..bandwidth import AutoTuner, Ledger
from ..bandwidth.adapters import (checkpoint_leaf_event,
                                  checkpoint_restore_event)
from ..convert import params_from_jax, params_to_jax
from ..optim.adamw import TrainState
from .codec import cram_compress_bytes, cram_decompress_bytes, pad_to_lines
from .manifest import packb, unpackb

_STATE_FIELDS = ("params", "m", "v", "step", "dyn_counter")
# dtype names of the manifest (numpy's) for the torch dtypes a leaf holds
_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
           torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _paths(tree, prefix: str = ""):
    """(key, leaf) of a nested dict, keys sorted at every level."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _paths(v, key)
        else:
            yield key, v


def _leaves_with_paths(tree) -> list:
    if isinstance(tree, TrainState):
        out = []
        for f in _STATE_FIELDS:
            v = getattr(tree, f)
            if isinstance(v, dict):
                out += list(_paths(params_to_jax(v, tree.per), f".{f}"))
            else:
                out.append((f".{f}", v))
        return out
    if isinstance(tree, dict):
        return list(_paths(tree)) or [("root", tree)]
    return [("root", tree)]


def _host_bytes(leaf) -> tuple[bytes, str, list]:
    """A leaf's little-endian bytes, numpy dtype name and shape."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _DTYPES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), name, list(leaf.shape)
    arr = np.asarray(leaf)
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()
    return torch.from_numpy(arr)


def _line_codec_of(codec: str) -> str:
    """'cram' -> 'bdi' (the default), 'cram:<name>' -> name."""
    return codec.split(":", 1)[1] if ":" in codec else "bdi"


def save_checkpoint(directory, step: int, tree, *, codec: str = "cram",
                    ledger: Ledger | None = None,
                    tuner: AutoTuner | None = None) -> Path:
    """codec: 'raw' | 'cram[:line-codec][+zstd]' | 'auto'.

    'cram' streams every leaf through one registered line codec (default
    bdi; 'cram:fpc' / 'cram:hybrid' pick another).  'auto' lets the
    AutoTuner pick the line codec per leaf from its 64-byte lines, and
    stores a leaf plain where no codec makes it smaller.  Each leaf's
    (raw, stored) bytes are booked in a ledger and read back from it into
    the manifest, whose "traffic" is that ledger; a shared `ledger` also
    gets the save's rows."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    local = Ledger("checkpoint")
    auto = codec == "auto"
    if auto and tuner is None:
        tuner = AutoTuner()
    zstd = codec.endswith("+zstd")
    base = codec[: -len("+zstd")] if zstd else codec
    manifest = {"step": step,
                "codec": "cram:auto" if auto else codec, "leaves": []}
    for i, (key, leaf) in enumerate(_leaves_with_paths(tree)):
        raw, dtype, shape = _host_bytes(leaf)
        if auto:
            leaf_codec = tuner.choose_ckpt_codec(pad_to_lines(raw),
                                                 tensor_class=key).choice
            blob = (raw if leaf_codec == "raw"
                    else cram_compress_bytes(raw, codec=leaf_codec))
            if len(blob) >= len(raw):     # the stream's framing ate the win
                leaf_codec, blob = "raw", raw
        elif base.startswith("cram"):
            leaf_codec = _line_codec_of(base)
            blob = cram_compress_bytes(raw, use_zstd=zstd, codec=leaf_codec)
        else:
            leaf_codec, blob = "raw", raw
        fname = f"leaf_{i:05d}.bin"
        (tmp / fname).write_bytes(blob)
        raw_n, stored_n = checkpoint_leaf_event(
            local, key=key, raw_len=len(raw), stored_len=len(blob),
            dtype=dtype)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": shape, "dtype": dtype,
            "raw_bytes": raw_n, "stored_bytes": stored_n,
            "codec": leaf_codec, "framed": blob is not raw,
            "sha1": hashlib.sha1(blob).hexdigest(),
        })
    manifest["traffic"] = local.as_dict()
    if ledger is not None:
        ledger.merge(local)
    (tmp / "manifest.msgpack").write_bytes(packb(manifest))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def read_manifest(directory, step: int) -> dict:
    path = Path(directory) / f"step_{step:08d}" / "manifest.msgpack"
    return unpackb(path.read_bytes())


def load_checkpoint(directory, step: int | None, tree_like, *,
                    ledger: Ledger | None = None):
    """Restore into the structure of `tree_like` (a `TrainState` or a
    nested dict; shapes must match).  Returns (tree, manifest): a
    `TrainState` comes back as one whose params and moments are CPU
    tensors in the port's layout, a dict as a dict of CPU tensors.  A
    `ledger` books the restore's read traffic."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = unpackb((d / "manifest.msgpack").read_bytes())
    by_key = {m["key"]: m for m in manifest["leaves"]}
    out = {}
    for key, leaf in _leaves_with_paths(tree_like):
        m = by_key[key]
        if list(m["shape"]) != list(leaf.shape):
            raise ValueError(f"{key}: stored shape {m['shape']}, expected "
                             f"{list(leaf.shape)}")
        blob = (d / m["file"]).read_bytes()
        if hashlib.sha1(blob).hexdigest() != m["sha1"]:
            raise ValueError(f"checksum mismatch for {key}")
        framed = m.get("framed", manifest["codec"].startswith("cram"))
        raw = cram_decompress_bytes(blob) if framed else blob
        if ledger is not None:
            checkpoint_restore_event(ledger, key=key, raw_len=len(raw),
                                     stored_len=len(blob), dtype=m["dtype"])
        out[key] = _from_bytes(raw, m["dtype"], m["shape"])
    return _unflatten(tree_like, out), manifest


def _unflatten(like, leaves: dict):
    if isinstance(like, TrainState):
        fields = {}
        for f in _STATE_FIELDS:
            v = getattr(like, f)
            if isinstance(v, dict):
                pre = f".{f}/"
                sub = {}
                for key, t in leaves.items():
                    if key.startswith(pre):
                        _nest(sub, key[len(pre):].split("/"), t)
                fields[f] = params_from_jax(sub)
            else:
                fields[f] = leaves[f".{f}"]
        return TrainState(**fields, per=like.per)
    if isinstance(like, dict):
        out: dict = {}
        for key, t in leaves.items():
            _nest(out, key.split("/"), t)
        return out
    return leaves["root"]


def _nest(tree: dict, path: list, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "COMMIT").exists()]
    return max(steps) if steps else None


def _host_copy(tree):
    """A copy of every tensor of `tree` on the host, taken now: the port's
    optimizer updates its tensors in place, so a save that reads them
    later would see a later step (`.cpu()` of a CPU tensor is the tensor
    itself, hence the clone)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            return x.clone() if x.device.type == "cpu" else x.cpu()
        return np.array(x, copy=True)

    if isinstance(tree, TrainState):
        return TrainState(**{f: _host_copy(getattr(tree, f))
                             for f in _STATE_FIELDS}, per=tree.per)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    return copy(tree)


class CheckpointManager:
    """Async writer with bounded retention."""

    def __init__(self, directory, *, keep: int = 3, codec: str = "cram",
                 ledger: Ledger | None = None,
                 tuner: AutoTuner | None = None):
        self.directory = Path(directory)
        self.keep = keep
        self.codec = codec
        self.ledger = ledger if ledger is not None else Ledger("checkpoint")
        self.tuner = tuner
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree) -> None:
        """Copy `tree` to the host now, then write it on a thread."""
        self.wait()
        host_tree = _host_copy(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree,
                                codec=self.codec, ledger=self.ledger,
                                tuner=self.tuner)
                self._gc()
            except BaseException as e:       # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like):
        self.wait()
        return load_checkpoint(self.directory, None, tree_like)

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*")
                       if (p / "COMMIT").exists())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
