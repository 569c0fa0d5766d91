"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Every `csrc/*.cu` compiles to an object with its own `nvcc` process, all
started together, and the objects link into one shared library under the
git-ignored `build/kernels/` directory of the checkout; the file name
carries a hash of the sources, so an edited source rebuilds.  The build
runs at first use — `load()` is called only by a wrapper about to launch
a kernel on a CUDA tensor — never at import, so the CPU tests import every
module on a machine without `nvcc`.

Each C entry point returns `cudaGetLastError()`; `check()` raises on a
non-zero code.  Pointers and the stream travel as `c_void_p`.  The
compiles run with `-Xptxas -v`; `ptxas_report()` gives each kernel's
registers and spills from the build of the library in use.

`kernel_wrapper` marks each kernel's dispatching wrapper (the function
that runs the plain version on a CPU tensor and launches the kernel on a
CUDA tensor), so that the launch audit (`repro_torch.analysis.
launch_audit`) sees every call of it, on either device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")
# compression.framing's marker multipliers, which the sources take as
# CRAM_<name> defines instead of retyping them
FRAMING_DEFINES = ("M2_MULT", "M4_MULT", "IL_MULT")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_uint32
SIGNATURES = {
    # win, marker_lanes, enabled, B, W, lanes, page, hkv, d2, chunk_vecs,
    # chunks, flags, slots, over, strips, lay, fit, stream
    "cram_layout_window": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P],
    # q, slots, strips, markers, valid, pred, B, hq, D, n, page, hkv, lanes,
    # kk, shared, scale, slot_bytes, strip_bytes, part_m, part_l, part_acc,
    # part_bytes, out, bytes, stream
    "cram_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P,
                              _P, _P, _P],
    # q, slots, over, strips, markers, mask, valid, pred, six batch strides
    # (slots, over, strips, mask, valid, pred), B, hq, D, n_groups, page,
    # hkv, lanes, kk, scale, slot_bytes, strip_bytes, part_m, part_l,
    # part_acc, part_bytes, out, bytes, stream
    "cram_decode_attention_leaves": [_P] * 8 + [_L] * 6 + [_I] * 8
                                    + [_F, _I, _I] + [_P] * 7,
    # q, slots, strips, markers, valid, hq, D, n, page, hkv, lanes, kk,
    # scale, part_m, part_l, part_acc, out, stream
    "cram_decode_attention_single": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _F, _P, _P, _P, _P, _P],
    # page_a, page_b, page_c, page_d, G, lanes, page, hkv, d2, cluster,
    # chunk_vecs, packed, base, ok, stream
    "cram_pack_pages": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P],
    # packed, base, G, lanes, page, hkv, d2, out, stream
    "cram_unpack_pages": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    # lines, n, key, out, stream
    "cram_compress_scan": [_P, _L, _U, _P, _P],
    # &EngineArgs, dynamic shared memory bytes, refusal flags, stream
    "cram_engine_scan": [_P, _L, _P, _P],
    # q, k, v, q_sb, q_sh, B, T, hkv, hq, D, kv_type, q_type, length,
    # width, splits, state, part_m, part_l, part_o, m, l, o, stream
    "cram_gqa_decode": [_P, _P, _P, _L, _L] + [_I] * 11 + [_P] * 7,
}

_state: dict = {"lib": None, "build_seconds": None}

# observers of the kernel wrappers' calls (the launch audit's recorder);
# empty outside an audit
OBSERVERS: list = []
# observers of the FLOPs a kernel computes, which no aten op shows to a
# dispatch mode (`launch/hlo_analysis.analyze_step`'s recorder); empty
# outside it
FLOP_OBSERVERS: list = []


def count_flops(n: float) -> None:
    """Report `n` FLOPs a kernel launch computed to FLOP_OBSERVERS."""
    for observe in FLOP_OBSERVERS:
        observe(n)


def kernel_wrapper(launch_key):
    """Decorate a kernel's dispatching wrapper: while OBSERVERS is not
    empty, each observer's `enter(name)` / `exit(name)` bracket the call,
    `name = launch_key(*args, **kw)` being the kernel's key in its
    module's LAUNCHES (a constant string stands for itself)."""
    key = (launch_key if callable(launch_key)
           else lambda *a, **kw: launch_key)

    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not OBSERVERS:
                return fn(*args, **kw)
            name = key(*args, **kw)
            for obs in OBSERVERS:
                obs.enter(name)
            try:
                return fn(*args, **kw)
            finally:
                for obs in OBSERVERS:
                    obs.exit(name)
        return call
    return deco


def build_dir() -> pathlib.Path:
    """`build/kernels/` at the root of the checkout."""
    return CSRC.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def framing_defines() -> tuple[str, ...]:
    """`-DCRAM_<name>=<value>u` for each of FRAMING_DEFINES, the values
    read from `compression.framing`."""
    from ..compression import framing

    return tuple(f"-DCRAM_{name}={getattr(framing, name):#x}u"
                 for name in FRAMING_DEFINES)


def build() -> pathlib.Path:
    """Compile every source in parallel and link the shared library."""
    sources = sorted(CSRC.glob("*.cu"))
    defines = framing_defines()
    digest = hashlib.sha256()
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + defines).encode())
    tag = digest.hexdigest()[:16]
    out_dir = build_dir()
    lib_path = out_dir / f"libcram_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    ptxas_path = lib_path.with_suffix(".ptxas.txt")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out_dir / f"{src.stem}_{tag}.o" for src in sources]
    procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *defines, "-Xptxas", "-v", "-c",
                 str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs, strict=True)]
    failures, logs = [], []
    for src, proc in zip(sources, procs, strict=True):
        log, _ = proc.communicate()
        logs.append(log)
        if proc.returncode:
            failures.append(f"{src.name}:\n{log}")
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    ptxas_path.write_text("".join(logs))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                           "-o", str(tmp)],
                          capture_output=True, text=True, check=False)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed\n{link.stdout}{link.stderr}")
    tmp.replace(lib_path)
    return lib_path


def load() -> ctypes.CDLL:
    """The bound library, built on first call."""
    if _state["lib"] is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        _state["build_seconds"] = time.perf_counter() - t0
    return _state["lib"]


def parse_ptxas(log: str) -> list[dict]:
    """Per kernel of an `nvcc -Xptxas -v` log (mangled name): registers,
    spill stores and loads in bytes."""
    out = []
    for block in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        out.append({"kernel": block.split("'", 1)[0],
                    "registers": int(regs.group(1)),
                    "spill_stores": int(spill.group(1)),
                    "spill_loads": int(spill.group(2))})
    return out


def ptxas_report() -> list[dict]:
    """`parse_ptxas` of the build log of the library `load()` bound (empty
    before a load, or for a library built without the log)."""
    if _state["lib"] is None:
        return []
    log = pathlib.Path(_state["lib"]._name).with_suffix(".ptxas.txt")
    return parse_ptxas(log.read_text()) if log.exists() else []


def build_seconds() -> float | None:
    """Wall time of the first `load()` (build included), or None."""
    return _state["build_seconds"]


def check(code: int, name: str) -> None:
    if code:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def ptr(tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(tensor.data_ptr())
