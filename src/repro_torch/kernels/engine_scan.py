"""E1: the trace engine's scan over a chunk of events, for every lane.

The reference compiles the engine's step into one XLA loop (`lax.scan` in
`repro.core.engine.build_engine.run_chunk`, vmapped over schemes and
workloads in `repro.core.batchsim`).  Here a lane is one (scheme,
workload) pair: lane `si * W + wi` runs scheme row `si` (its flags and
params) over workload `wi`'s trace and fit bitmaps.  Every event of the
chunk is applied in order, in every lane.

  * `engine_scan_plain` — the plain PyTorch version: a Python loop over
    the chunk's events, each event one batched step over all lanes with
    the reference's ops in the reference's order (no host sync).  The CPU
    tests use it, and `chip_smoke.py` holds the kernel against it.
  * `engine_scan_cuda` — the CUDA kernel `csrc/engine_scan.cu`: one
    launch per chunk, one CTA of two warps per lane.
  * `engine_scan` — dispatches on the trace's device: a CPU tensor runs
    the plain version, a CUDA tensor launches the kernel or raises.

All three update the carry in place (the reference returns a new one).
The plain version returns the carry; the kernel and the dispatcher return
(carry, err): `err` is the launch's ERR_KINDS int32 refusal flags on its
device (None from the plain version, which is given only inputs the host
has checked).  The launch does not wait for the card: whoever returns a
result to the host reads the flags with it (`fetch_checked`,
`raise_refused`) and raises ValueError for a refused input.

The carry is the reference's tuple with leading dims (S, W):
  tag, lru, valid, dirty, pf     (S, W, sets, ways) int32
  mem_state                      (S, W, n_groups) int8
  lct                            (S, W, LCT_ENTRIES) int8
  (mtag, mlru, mdirty, mclock)   (S, W, meta_sets, meta_ways) int32, int32,
                                 bool; (S, W) int32
  counter, clock                 (S, W) int32
  stats                          (S, W, N_STATS) int32
flags (S, N_FLAGS) and params (S, N_PARAMS) int32 are per scheme row;
addrs (W, T) int32 and is_write (W, T) bool per workload, any row stride
with unit column stride; pair_ab / pair_cd / quad (W, n_groups) bool.
`tables` are the engine's lookup tables as int32 tensors on the lanes'
device (`core.engine.engine_tables`); `consts` its scalar constants.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

# the engine's layouts, as in `core/engine.py` (which re-exports them)
(ST_READ_PROBES, ST_DEMAND_READS, ST_WB_DIRTY, ST_WB_CLEAN, ST_IL_WRITES,
 ST_META_READS, ST_META_WB, ST_META_HITS, ST_PF_INSTALLED, ST_PF_USED,
 ST_PRED_TOTAL, ST_PRED_HIT, ST_LLC_HITS, ST_LLC_MISSES, ST_PF_EXTRA_ACCESS,
 N_STATS) = range(16)
(FLAG_COMP, FLAG_LLP, FLAG_META, FLAG_NEXTLINE, FLAG_IDEAL, FLAG_DYNAMIC,
 FLAG_LCT_UPDATE, N_FLAGS) = range(8)
(PARAM_LCT_SIZE, PARAM_SAMPLE_THRESH, PARAM_COUNTER_INIT, PARAM_META_SETS,
 N_PARAMS) = range(5)

TABLE_NAMES = ("wb_dirty", "wb_clean", "il", "new_state", "probe", "loc",
               "lanes_in_slot", "lane_level", "set_hash")
CONST_NAMES = ("enable_threshold", "counter_max", "hash_mult",
               "lines_per_page", "groups_per_meta")
SMEM_LIMIT = 232_448        # dynamic shared memory a block may use (H100)
MEM_STATES = 5              # mem_state values (S_U .. S_Q)
LANE_MASKS = 16             # valid / dirty / pf masks of a group
EVICT_ENTRIES = 2 * MEM_STATES * 8 * LANE_MASKS * LANE_MASKS
EVICT_COLUMNS = TABLE_NAMES[:4]     # packed into one word an entry
EVICT_BITS = 3
META_QUEUE = 64             # metadata-cache requests a batch of 32 events
ERR_KINDS = 3               # refusal flags a launch sets (REFUSALS)
_PACKED: list = []          # (columns, their versions, packed): recent packs
# what E1 refuses as it runs, by the index of its flag (ERR_* in
# csrc/engine_scan.cu)
REFUSALS = ("a trace address lies outside [0, 4 * n_groups)",
            "a params row's LCT size or metadata sets lie outside [1, what "
            "the carry holds]",
            "the carry holds a value outside the engine's tables (mem_state, "
            "LCT level, valid / dirty mask or victim tag)")

# kernel launches; only the CUDA path counts
LAUNCHES = {"engine_scan": 0}


def _first(mask, n: int):
    """Index of the first True along the last axis (n where there is none)
    — `jnp.argmax` of a bool row when one is set."""
    idx = torch.arange(n, device=mask.device)
    return torch.where(mask, idx, n).amin(-1)


def _first_min(x, n: int):
    """`jnp.argmin` along the last axis: the first index of the minimum."""
    return _first(x == x.amin(-1, keepdim=True), n)


def _meta_probe(mtag, mlru, mdirty, mclock, ar, mline, make_dirty: bool,
                meta_sets, mw: int):
    """One metadata-cache access per lane (the reference's `meta_probe`):
    the way it would write, the values it would write there and the stat
    deltas; the caller applies them where its gate is set."""
    ms = mline % meta_sets
    row = mtag[ar, ms]
    match = row == (mline + 1)[:, None]
    hit = match.any(-1)
    empty = row == 0
    vic = torch.where(empty.any(-1), _first(empty, mw),
                      _first_min(mlru[ar, ms], mw))
    way = torch.where(hit, _first(match, mw), vic)
    old_dirty = mdirty[ar, ms, way]
    vic_dirty = ~hit & (row[ar, way] != 0) & old_dirty
    new_dirty = (hit & old_dirty) | make_dirty
    return ms, way, new_dirty, hit, vic_dirty


def _apply_meta(carry_meta, ar, gate, probe, mline):
    """Write one probe's result into the lanes where `gate` is set (the
    reference's `_sel_state`: a probe applies as a whole or not at all)."""
    mtag, mlru, mdirty, mclock = carry_meta
    ms, way, new_dirty, _, _ = probe
    mclock.copy_(torch.where(gate, mclock + 1, mclock))
    mtag[ar, ms, way] = torch.where(gate, mline + 1, mtag[ar, ms, way])
    mlru[ar, ms, way] = torch.where(gate, mclock, mlru[ar, ms, way])
    mdirty[ar, ms, way] = torch.where(gate, new_dirty, mdirty[ar, ms, way])


def engine_scan_plain(carry, flags, params, addrs, is_write, pair_ab,
                      pair_cd, quad, tables: dict, consts: dict):
    """Plain version: the reference's step, batched over the S x W lanes,
    one event after another.  Updates `carry` in place and returns it."""
    (tag, lru, valid, dirty, pf, mem_state, lct, (mtag, mlru, mdirty,
     mclock), counter, clock, stats) = carry
    n_s, n_w, sets, ways = tag.shape
    n_lanes = n_s * n_w
    dev = tag.device
    # lane views of the carry (in place: every write lands in the carry)
    tag, lru, valid, dirty, pf = (x.view(n_lanes, sets, ways)
                                  for x in (tag, lru, valid, dirty, pf))
    mem_state = mem_state.view(n_lanes, -1)
    lct = lct.view(n_lanes, -1)
    mw = mtag.shape[-1]
    mtag, mlru, mdirty = (x.view(n_lanes, -1, mw)
                          for x in (mtag, mlru, mdirty))
    mclock, counter, clock = (x.view(n_lanes)
                              for x in (mclock, counter, clock))
    stats = stats.view(n_lanes, N_STATS)
    meta = (mtag, mlru, mdirty, mclock)

    ar = torch.arange(n_lanes, device=dev)
    wi = ar % n_w
    si = ar // n_w
    fl = flags.to(dev, torch.int32)[si] > 0
    pr = params.to(dev, torch.int32)[si]
    f_comp, f_llp, f_meta, f_next, f_ideal, f_dyn, f_lct = (
        fl[:, k] for k in (FLAG_COMP, FLAG_LLP, FLAG_META, FLAG_NEXTLINE,
                           FLAG_IDEAL, FLAG_DYNAMIC, FLAG_LCT_UPDATE))
    lct_size = pr[:, PARAM_LCT_SIZE].to(torch.int64)
    sample_thresh = pr[:, PARAM_SAMPLE_THRESH]
    meta_sets = pr[:, PARAM_META_SETS]
    t = {k: tables[k].to(dev) for k in TABLE_NAMES}
    enable = consts["enable_threshold"]
    cmax = consts["counter_max"]
    hash_mult = consts["hash_mult"]
    lpp = consts["lines_per_page"]
    gpm = consts["groups_per_meta"]
    lanes_addr = addrs[wi].to(torch.int32)
    lanes_wr = is_write[wi].to(torch.bool)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)

    for e in range(lanes_addr.shape[1]):
        addr = lanes_addr[:, e]
        wr = lanes_wr[:, e]
        g = addr >> 2
        lane = addr & 3
        lane_bit = one << lane
        s = g % sets
        clock += 1

        row_tag = tag[ar, s]
        match = row_tag == (g + 1)[:, None]
        tag_hit = match.any(-1)
        way = torch.where(tag_hit, _first(match, ways), 0)
        v_here = torch.where(tag_hit, valid[ar, s, way], 0)
        hit = tag_hit & ((v_here & lane_bit) != 0)
        miss = ~hit
        sampled = t["set_hash"][s] < sample_thresh
        dyn_on = counter >= enable
        pf_bit = hit & ((pf[ar, s, way] & lane_bit) != 0)

        # fetch accounting (miss path)
        st = mem_state[ar, g].to(torch.int64)
        pidx = ((((addr // lpp).to(torch.int64) * hash_mult) & 0xFFFFFFFF)
                % lct_size)
        pred_level = lct[ar, pidx].to(torch.int64)
        lane64 = lane.to(torch.int64)
        probes = torch.where(f_llp & (lane != 0),
                             t["probe"][st, lane64, pred_level], one)
        true_slot = t["loc"][st, lane64]
        obt_next = lane_bit | torch.where(lane < 3, lane_bit << 1, zero)
        obtained = torch.where(
            f_comp, t["lanes_in_slot"][st, true_slot.to(torch.int64)],
            torch.where(f_next, obt_next, lane_bit))

        # victim: merge into the existing way when the group tag is present
        empty = row_tag == 0
        vway = torch.where(
            tag_hit, way,
            torch.where(empty.any(-1), _first(empty, ways),
                        _first_min(lru[ar, s], ways)))
        row_v = row_tag[ar, vway]
        evicting = miss & ~tag_hit & (row_v != 0)
        # an empty victim way gives vg = -1: indexing wraps it to the last
        # group, as JAX does, and every use is gated by `evicting`
        vg = (row_v - 1).to(torch.int64)
        vst = mem_state[ar, vg].to(torch.int32)
        v_valid = valid[ar, s, vway]
        v_dirty = dirty[ar, s, vway]

        ev_enabled = torch.where(f_dyn, (sampled | dyn_on).to(torch.int32),
                                 f_comp.to(torch.int32))
        eidx = ((((((ev_enabled * 5 + vst) * 2
                    + pair_ab[wi, vg].to(torch.int32)) * 2
                   + pair_cd[wi, vg].to(torch.int32)) * 2
                  + quad[wi, vg].to(torch.int32)) * 16 + v_valid) * 16
                + v_dirty).to(torch.int64)
        wb_d = torch.where(evicting, t["wb_dirty"][eidx], zero)
        wb_c = torch.where(evicting, t["wb_clean"][eidx], zero)
        ilw = torch.where(evicting, t["il"][eidx], zero)
        ns = torch.where(evicting, t["new_state"][eidx], vst)
        wb_c = torch.where(f_ideal, zero, wb_c)
        ilw = torch.where(f_ideal, zero, ilw)

        # stats (added once, at the end of the event: nothing reads them)
        d = [zero] * N_STATS
        d[ST_LLC_HITS] = hit
        d[ST_LLC_MISSES] = miss
        d[ST_PF_USED] = hit & pf_bit
        d[ST_DEMAND_READS] = miss
        d[ST_READ_PROBES] = torch.where(miss, probes, zero)
        d[ST_WB_DIRTY] = wb_d
        d[ST_WB_CLEAN] = wb_c
        d[ST_IL_WRITES] = ilw
        need_pred = f_llp & miss & (lane > 0)
        d[ST_PRED_TOTAL] = need_pred
        d[ST_PRED_HIT] = need_pred & (probes == 1)
        d[ST_PF_EXTRA_ACCESS] = f_next & miss

        # dynamic cost/benefit counter (gated; others keep their init)
        cost = (torch.where(evicting & sampled, wb_c + ilw, zero)
                + torch.where(miss & sampled, probes - 1, zero))
        benefit = (hit & pf_bit & sampled).to(torch.int32)
        counter.copy_(torch.where(
            f_dyn, torch.clamp(counter + benefit - cost, 0, cmax), counter))

        # explicit metadata cache: two gated probes, demand miss first,
        # then the victim's dirty update against the state after the first
        mline = g // gpm
        p1 = _meta_probe(mtag, mlru, mdirty, mclock, ar, mline, False,
                         meta_sets, mw)
        apply1 = f_meta & miss
        _apply_meta(meta, ar, apply1, p1, mline)
        vmline = vg.to(torch.int32) // gpm
        p2 = _meta_probe(mtag, mlru, mdirty, mclock, ar, vmline, True,
                         meta_sets, mw)
        apply2 = f_meta & evicting & (ns != vst)
        _apply_meta(meta, ar, apply2, p2, vmline)
        d[ST_META_READS] = ((apply1 & ~p1[3]).to(torch.int32)
                            + (apply2 & ~p2[3]).to(torch.int32))
        d[ST_META_WB] = ((apply1 & p1[4]).to(torch.int32)
                         + (apply2 & p2[4]).to(torch.int32))
        d[ST_META_HITS] = ((apply1 & p1[3]).to(torch.int32)
                           + (apply2 & p2[3]).to(torch.int32))

        # LCT update (frozen when FLAG_LCT_UPDATE is off: cram-nollp)
        obs = t["lane_level"][st, lane64].to(torch.int8)
        lct[ar, pidx] = torch.where(f_lct & miss, obs, lct[ar, pidx])

        mem_state[ar, vg] = torch.where(evicting, ns.to(torch.int8),
                                        mem_state[ar, vg])

        # LLC array updates (hit and miss merged)
        new_valid_miss = torch.where(tag_hit, v_here | obtained, obtained)
        prev_pf = torch.where(tag_hit, pf[ar, s, vway], zero)
        fresh = (obtained & ~torch.where(tag_hit, v_here, zero)
                 & ~lane_bit)
        new_pf_miss = (prev_pf | fresh) & ~lane_bit
        popc = (fresh & 1) + ((fresh >> 1) & 1) + ((fresh >> 2) & 1) + (
            (fresh >> 3) & 1)
        d[ST_PF_INSTALLED] = torch.where(miss, popc, zero)
        wr_bit = torch.where(wr, lane_bit, zero)
        new_dirty_miss = torch.where(tag_hit, dirty[ar, s, vway], zero) | wr_bit

        uway = torch.where(hit, way, vway)
        new_tag = torch.where(hit, row_tag[ar, way], g + 1)
        new_valid = torch.where(hit, v_here, new_valid_miss)
        new_dirty = torch.where(hit, dirty[ar, s, way] | wr_bit,
                                new_dirty_miss)
        new_pf = torch.where(hit, pf[ar, s, way] & ~lane_bit, new_pf_miss)
        tag[ar, s, uway] = new_tag
        lru[ar, s, uway] = clock
        valid[ar, s, uway] = new_valid
        dirty[ar, s, uway] = new_dirty
        pf[ar, s, uway] = new_pf
        stats += torch.stack([x.to(torch.int32).expand(n_lanes) for x in d],
                             1)
    return carry


# ----------------------------------------------------------------- CUDA


class _Args(ctypes.Structure):
    """`EngineArgs` of `csrc/engine_scan.cu`: every field 8 bytes wide,
    pointers then integers, in the C struct's order."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "tag", "lru", "valid", "dirty", "pf", "mem_state", "lct", "mtag",
        "mlru", "mdirty", "mclock", "counter", "clock", "stats", "flags",
        "params", "addrs", "is_write", "pair_ab", "pair_cd", "quad",
        "evict", *TABLE_NAMES[len(EVICT_COLUMNS):], "lane_ns")]
                + [(n, ctypes.c_longlong) for n in (
                    "n_schemes", "n_workloads", "addr_stride",
                    "write_stride", "n_events", "sets", "ways", "n_groups",
                    "meta_sets", "meta_ways", "lct_entries", "n_levels",
                    *CONST_NAMES)])


def smem_bytes(sets: int, ways: int, meta_sets: int, meta_ways: int,
               lct_entries: int, n_levels: int) -> int:
    """Dynamic shared memory of one CTA (`smem_layout` in the CUDA
    source), each region rounded up to 16 bytes: the lane's state (the
    five LLC arrays, the metadata cache's tag and LRU arrays as int32, its
    dirty bits and the LCT as bytes), the shadow (a byte an LLC way), the
    packed eviction table (16 bits an entry), PROBE (5 x 4 x n_levels),
    LOC, LANES_IN_SLOT and LANE_LEVEL (5 x 4 each) as int32, and the
    metadata-cache queue (two batches of 64 int32 requests, two counts)."""
    def up(n):
        return (n + 15) // 16 * 16
    slot_table = MEM_STATES * 4
    return (5 * up(4 * sets * ways) + 2 * up(4 * meta_sets * meta_ways)
            + up(meta_sets * meta_ways) + up(lct_entries)
            + up(sets * ways) + up(2 * EVICT_ENTRIES)
            + up(4 * slot_table * n_levels) + 3 * up(4 * slot_table)
            + up(4 * 2 * META_QUEUE) + up(4 * 2))


def pack_evict_table(tables: dict):
    """The eviction table's four int32 columns as one 16-bit word an
    entry, 3 bits a column: wb_dirty | wb_clean << 3 | il << 6 |
    new_state << 9 (int16 on the columns' device).  Made once for a set
    of column tensors (kept with them, and made again after an in-place
    change to one), so a launch enqueues nothing else.  Raises ValueError
    when a column holds a value outside [0, 8)."""
    cols = tuple(tables[k] for k in EVICT_COLUMNS)
    versions = tuple(c._version for c in cols)
    for held, vers, packed in _PACKED:
        if vers == versions and all(h is c for h, c in zip(held, cols)):
            return packed
    for name, c in zip(EVICT_COLUMNS, cols, strict=True):
        lo, hi = int(c.min()), int(c.max())
        if lo < 0 or hi >= 1 << EVICT_BITS:
            raise ValueError(f"eviction table column {name} holds values in "
                             f"[{lo}, {hi}], outside the [0, "
                             f"{1 << EVICT_BITS}) its {EVICT_BITS} packed "
                             "bits hold")
    packed = sum(c << (EVICT_BITS * k) for k, c in enumerate(cols))
    _PACKED.insert(0, (cols, versions, packed.to(torch.int16)))
    del _PACKED[4:]
    return _PACKED[0][2]


def _check(name, x, dtype, shape, dev):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != dev:
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def engine_scan_cuda(carry, flags, params, addrs, is_write, pair_ab,
                     pair_cd, quad, tables: dict, consts: dict, *,
                     err=None, lane_ns=None):
    """The CUDA kernel on the contract of `engine_scan_plain`: one launch
    for the whole chunk, the carry updated in place; returns (carry,
    err).  Shapes, types and tables are checked here; addresses, params
    rows and carry values by the kernel as it runs: a lane that would
    index outside its slice or a table (where the reference would clamp)
    stops and sets its kind's flag in `err`, which the launch does not
    wait for.  `err` is a zeroed int32 (ERR_KINDS,) tensor on the card,
    made here when not given; a run of chunks passes one for all of them.
    `lane_ns`, when given, is an (S * W, 2) int64 tensor on the card that
    receives each lane's device clock (%globaltimer, ns) when it starts
    and ends its events."""
    (tag, lru, valid, dirty, pf, mem_state, lct, (mtag, mlru, mdirty,
     mclock), counter, clock, stats) = carry
    dev = addrs.device
    if dev.type != "cuda":
        raise ValueError(f"addrs must be a CUDA tensor, got {dev}")
    n_s, n_w, sets, ways = tag.shape
    n_groups = mem_state.shape[-1]
    ms_alloc, mw = mtag.shape[-2:]
    lead = (n_s, n_w)
    for name, x in (("tag", tag), ("lru", lru), ("valid", valid),
                    ("dirty", dirty), ("pf", pf)):
        _check(name, x, torch.int32, lead + (sets, ways), dev)
    _check("mem_state", mem_state, torch.int8, lead + (n_groups,), dev)
    _check("lct", lct, torch.int8, lead + (lct.shape[-1],), dev)
    _check("mtag", mtag, torch.int32, lead + (ms_alloc, mw), dev)
    _check("mlru", mlru, torch.int32, lead + (ms_alloc, mw), dev)
    _check("mdirty", mdirty, torch.bool, lead + (ms_alloc, mw), dev)
    for name, x in (("mclock", mclock), ("counter", counter),
                    ("clock", clock)):
        _check(name, x, torch.int32, lead, dev)
    _check("stats", stats, torch.int32, lead + (N_STATS,), dev)
    _check("flags", flags, torch.int32, (n_s, N_FLAGS), dev)
    _check("params", params, torch.int32, (n_s, N_PARAMS), dev)
    n_events = addrs.shape[-1]
    _check("addrs", addrs, torch.int32, (n_w, n_events), dev)
    _check("is_write", is_write, torch.bool, (n_w, n_events), dev)
    for name, x in (("pair_ab", pair_ab), ("pair_cd", pair_cd),
                    ("quad", quad)):
        _check(name, x, torch.bool, (n_w, n_groups), dev)
    state = (tag, lru, valid, dirty, pf, mem_state, lct, mtag, mlru, mdirty,
             mclock, counter, clock, stats, flags, params, pair_ab, pair_cd,
             quad)
    if not all(x.is_contiguous() for x in state):
        raise ValueError("the carry, flags, params and fit bitmaps must be "
                         "contiguous")
    if addrs.stride(-1) != 1 or is_write.stride(-1) != 1:
        raise ValueError("addrs and is_write need a unit column stride")
    n_levels = tables["probe"].shape[-1]
    shapes = dict.fromkeys(EVICT_COLUMNS, (EVICT_ENTRIES,))
    shapes.update(dict.fromkeys(("loc", "lanes_in_slot", "lane_level"),
                                (MEM_STATES, 4)),
                  probe=(MEM_STATES, 4, n_levels), set_hash=(sets,))
    for name in TABLE_NAMES:
        x = tables[name]
        if x.dtype != torch.int32 or x.device != dev or \
                not x.is_contiguous() or tuple(x.shape) != shapes[name]:
            raise ValueError(f"table {name} must be contiguous int32 "
                             f"{shapes[name]} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if err is None:
        err = torch.zeros(ERR_KINDS, dtype=torch.int32, device=dev)
    _check("err", err, torch.int32, (ERR_KINDS,), dev)
    if lane_ns is not None:
        _check("lane_ns", lane_ns, torch.int64, (n_s * n_w, 2), dev)
        if not lane_ns.is_contiguous():
            raise ValueError("lane_ns must be contiguous")
    smem = smem_bytes(sets, ways, ms_alloc, mw, lct.shape[-1], n_levels)
    if smem > SMEM_LIMIT:
        raise ValueError(f"one lane's state and the tables need {smem} bytes "
                         "of shared memory, above the block limit of "
                         f"{SMEM_LIMIT}")
    if n_events == 0 or n_s * n_w == 0:
        return carry, err
    evict = pack_evict_table(tables)
    p = cuda_lib.ptr
    args = _Args(
        *(p(x).value for x in (tag, lru, valid, dirty, pf, mem_state, lct,
                               mtag, mlru, mdirty, mclock, counter, clock,
                               stats, flags, params, addrs, is_write,
                               pair_ab, pair_cd, quad)),
        p(evict).value,
        *(p(tables[k]).value for k in TABLE_NAMES[len(EVICT_COLUMNS):]),
        None if lane_ns is None else p(lane_ns).value,
        n_s, n_w, addrs.stride(0), is_write.stride(0), n_events, sets, ways,
        n_groups, ms_alloc, mw, lct.shape[-1], n_levels,
        *(int(consts[k]) for k in CONST_NAMES))
    with torch.cuda.device(dev):
        code = cuda_lib.load().cram_engine_scan(
            ctypes.byref(args), smem, p(err), cuda_lib.stream_ptr(addrs))
    cuda_lib.check(code, "cram_engine_scan")
    LAUNCHES["engine_scan"] += 1
    return carry, err


@cuda_lib.kernel_wrapper("engine_scan")
def engine_scan(carry, flags, params, addrs, is_write, pair_ab, pair_cd,
                quad, tables: dict, consts: dict, *, err=None):
    """Advance every lane's carry over the chunk's events, in place;
    returns (carry, err).  A CPU trace runs the plain version (err None);
    a CUDA trace launches E1 with the refusal flags `err` (made when not
    given) or raises."""
    if addrs.device.type == "cuda":
        return engine_scan_cuda(carry, flags, params, addrs, is_write,
                                pair_ab, pair_cd, quad, tables, consts,
                                err=err)
    return engine_scan_plain(carry, flags, params, addrs, is_write, pair_ab,
                             pair_cd, quad, tables, consts), err


def _raise(codes) -> None:
    """ValueError for the first refusal flag set in `codes` (rows of
    ERR_KINDS flags, any number of them)."""
    hit = np.asarray(codes).reshape(-1, ERR_KINDS).any(0)
    for kind, flagged in enumerate(hit):
        if flagged:
            raise ValueError(f"engine scan refused its input: "
                             f"{REFUSALS[kind]}")


def raise_refused(errs) -> None:
    """Read every pending refusal flag tensor of `errs` (None entries are
    the plain version's and refuse nothing) in one copy to the host, and
    raise ValueError for a refused input."""
    errs = [e for e in errs if e is not None]
    if errs:
        _raise(torch.stack([e.to(errs[0].device) for e in errs]).cpu())


def fetch_checked(result, errs) -> np.ndarray:
    """`result` (an int32 tensor) as a numpy array, copied to the host in
    one transfer with every pending refusal flag tensor of `errs`; raises
    ValueError for a refused input before anything is returned."""
    flags = [e.to(result.device).reshape(-1) for e in errs if e is not None]
    host = torch.cat([result.reshape(-1), *flags]).cpu().numpy()
    n = result.numel()
    _raise(host[n:])
    return host[:n].reshape(tuple(result.shape))
