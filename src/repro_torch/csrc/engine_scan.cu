// E1: the trace engine's scan, every event of a chunk for every lane.
//
// Replaces: the step of `src/repro/core/engine.py:221-378` (`run_chunk`, a
// `lax.scan` over the trace), vmapped over schemes and workloads at
// `src/repro/core/batchsim.py:45-58`.  No `pallas_call`: the reference
// compiles that loop with XLA.  A lane is one (scheme row, workload) pair;
// lane `si * W + wi` runs scheme row si's flags and params over workload
// wi's trace and fit bitmaps.
//
// What bounds it: the chain of dependent steps inside a lane, one event
// after another (each event reads the state the previous one wrote: the
// LLC set, the metadata cache, the LCT, mem_state), with at most a few
// hundred lanes (270 at the paper's 10 rows x 27 workloads), so at most
// 3 CTAs per SM.  The bytes moved (trace, fit bitmaps, state) are far
// below what the card could move in the same time.
//
// What the design does about that: no global-memory round trip sits on
// the chain.  One CTA of two warps per lane.  The first warp stages the
// lane's small state (the five LLC arrays, the LCT) and the tables into
// dynamic shared memory, runs the events in lockstep, and writes the
// state back.
//   * The trace ring: thread t holds the slot of event `base + t` of the
//     current batch of 32: its group, set, LCT index, write and sampling
//     bits, and the group's mem_state and three fit bits, fetched one
//     batch ahead (the next batch's loads are in flight while the current
//     one runs).  Event j takes its slot from thread j by shuffles.  A
//     fetched mem_state goes stale when its group is evicted before the
//     event that uses it, so every eviction `mem[vg] = ns` patches each
//     slot of the current batch whose group is vg, and records ns for the
//     next batch's slots whose loads are in flight.
//   * The shadow: one byte beside each LLC way holds its group's
//     mem_state and fit bits, written when the group is installed (and at
//     launch for the ways the incoming carry holds).  Only an eviction
//     writes mem_state, and only at the group it evicts, so a resident
//     group's state is the one it was installed with: the victim's state
//     and fit bits come from the shadow, not from global memory.  A carry
//     the engine never makes (a group held in two ways, or outside its
//     set) breaks that, and the lane then reads the victim's state from
//     mem_state as before.
//   * The set searches: up to 32 ways, thread w reads way w and votes
//     give the first match, the first empty way and the first LRU
//     minimum; above that, thread t reads ways t, t + 32, ... and the
//     warp reduces.
//   * Tables in shared memory: the eviction table's four columns packed
//     3 bits each into one 16-bit word an entry (the wrapper packs them
//     and refuses values outside [0, 8)), PROBE, LOC, LANES_IN_SLOT and
//     LANE_LEVEL; SET_HASH is read only when a slot is fetched.
//   * The metadata cache (explicit-metadata rows only) is the second
//     warp's: nothing else the step computes reads it, so the first warp
//     queues its accesses in order in shared memory (the demand miss's
//     line, then the victim's dirty update when its state changes), a
//     batch of 32 events at a time, and the second warp runs them while
//     the first runs the next batch.  In every other row the second warp
//     returns at once.
// Every thread of a warp computes every value of an event and makes
// every store itself (the same value to the same address), so a thread's
// later read of an address follows its own write of it in program order;
// one __syncwarp() between an event's reads of the state and its writes
// keeps a thread that runs ahead from writing what another has yet to
// read.

// Semantics held bit for bit (the plain version, kernels/engine_scan.py,
// is the oracle): first index wins in every tag, empty-way and LRU search
// (strict `<`); an empty victim way gives vg = -1, whose reads the
// reference gates by `evicting` — here they are not made unless
// evicting; the LCT index wraps mod 2^32 (uint32_t); the two metadata
// probes apply whole or not at all, demand miss first; the order of
// updates within an event is stats, counter, probe 1, probe 2, LCT,
// mem_state[vg], then the LLC arrays at the update way.
//
// Indices from the caller are checked where they would leave a lane's
// slice or a table (JAX clamps them; here they are refused): an address
// outside [0, 4 * n_groups), a params row whose LCT size or metadata sets
// exceed what the carry holds, and carry values that index the tables
// (mem_state, LCT levels, valid/dirty masks, victim tags), each in the
// event that would use it.  A lane that finds one stops there and sets
// its kind's flag in the launch's own int32 flag array on the device; the
// entry point does not wait, and the caller reads the flags when it copies
// a result to the host.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// the engine's layouts (core/engine.py: ST_*, FLAG_*, PARAM_*)
enum {
  ST_READ_PROBES = 0, ST_DEMAND_READS = 1, ST_WB_DIRTY = 2, ST_WB_CLEAN = 3,
  ST_IL_WRITES = 4, ST_META_READS = 5, ST_META_WB = 6, ST_META_HITS = 7,
  ST_PF_INSTALLED = 8, ST_PF_USED = 9, ST_PRED_TOTAL = 10, ST_PRED_HIT = 11,
  ST_LLC_HITS = 12, ST_LLC_MISSES = 13, ST_PF_EXTRA_ACCESS = 14,
  N_STATS = 15
};
enum {
  FLAG_COMP = 0, FLAG_LLP = 1, FLAG_META = 2, FLAG_NEXTLINE = 3,
  FLAG_IDEAL = 4, FLAG_DYNAMIC = 5, FLAG_LCT_UPDATE = 6, N_FLAGS = 7
};
enum {
  PARAM_LCT_SIZE = 0, PARAM_SAMPLE_THRESH = 1, PARAM_COUNTER_INIT = 2,
  PARAM_META_SETS = 3, N_PARAMS = 4
};
constexpr int GROUP_LANES = 4;   // lines in a group (addr & 3)
constexpr int MEM_STATES = 5;    // mem_state values (S_U .. S_Q)
constexpr int LANE_MASKS = 16;   // valid / dirty / pf masks of a group
constexpr int EVICT_ENTRIES = 2 * MEM_STATES * 8 * LANE_MASKS * LANE_MASKS;
constexpr int EVICT_BITS = 3;    // each eviction-table column, packed
constexpr int SLOT_TABLE = MEM_STATES * GROUP_LANES;  // LOC, LANES_IN_SLOT..
// what a lane refused, one flag each in the caller's flag array
enum { ERR_ADDRESS = 0, ERR_PARAMS = 1, ERR_CARRY = 2, ERR_KINDS = 3 };

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;   // no way found
// a mem_state held in 3 bits: 0..4 as they are, any value outside them
// (a carry the tables cannot index) as BAD, which every check refuses
constexpr int BAD_STATE = 7;
// a ring slot's `info` word and a shadow byte share the low six bits,
// state * 8 + fits, where fits = pair_ab * 4 + pair_cd * 2 + quad: the
// eviction table's index of (state, fits), as the reference orders them
enum {
  INFO_FQ = 1, INFO_FC = 2, INFO_FA = 4, INFO_STATE_SHIFT = 3,
  INFO_STATE = 7 << INFO_STATE_SHIFT, INFO_WR = 1 << 6, INFO_SAMPLED = 1 << 7,
  INFO_LANE_SHIFT = 8, INFO_OK = 1 << 10
};

// Every field is 8 bytes wide, in the order of `_Args` in
// kernels/engine_scan.py.
struct EngineArgs {
  int32_t* tag; int32_t* lru; int32_t* valid; int32_t* dirty; int32_t* pf;
  int8_t* mem_state; int8_t* lct;
  int32_t* mtag; int32_t* mlru; uint8_t* mdirty; int32_t* mclock;
  int32_t* counter; int32_t* clock; int32_t* stats;
  const int32_t* flags; const int32_t* params;
  const int32_t* addrs; const uint8_t* is_write;
  const uint8_t* pair_ab; const uint8_t* pair_cd; const uint8_t* quad;
  const uint16_t* evict;           // the eviction table, packed
  const int32_t* probe; const int32_t* loc; const int32_t* lanes_in_slot;
  const int32_t* lane_level; const int32_t* set_hash;
  long long* lane_ns;              // (lanes, 2) or null: start, end (ns)
  long long n_schemes, n_workloads, addr_stride, write_stride, n_events;
  long long sets, ways, n_groups, meta_sets, meta_ways, lct_entries;
  long long n_levels;
  long long enable_threshold, counter_max, hash_mult, lines_per_page;
  long long groups_per_meta;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__host__ __device__ __forceinline__ long long up16(long long n) {
  return (n + 15) / 16 * 16;
}

// Dynamic shared memory of one CTA, region by region, each rounded up to
// 16 bytes: the five LLC arrays, the metadata cache's tag and LRU arrays
// (int32), its dirty bytes, the LCT, the shadow (a byte a way), the
// packed eviction table (16 bits an entry), PROBE, LOC, LANES_IN_SLOT and
// LANE_LEVEL (int32), and the metadata-cache queue (two batches of
// requests and their two counts, int32).  `smem_bytes` in
// kernels/engine_scan.py counts the same.
constexpr int QUEUE = 2 * WARP;        // requests a batch: two an event
__host__ __device__ __forceinline__ long long smem_layout(
    long long sw, long long mm, long long lct, long long n_levels) {
  return 5 * up16(4 * sw) + 2 * up16(4 * mm) + up16(mm) + up16(lct)
         + up16(sw) + up16(2 * EVICT_ENTRIES)
         + up16(4 * SLOT_TABLE * n_levels) + 3 * up16(4 * SLOT_TABLE)
         + up16(4 * 2 * QUEUE) + up16(4 * 2);
}

__device__ __forceinline__ int state_code(int v) {
  return (unsigned)v < (unsigned)MEM_STATES ? v : BAD_STATE;
}

// The first match of `want`, the first empty way (NONE when there is
// none) and the first LRU minimum (strict `<`) among n ways.  Up to 32
// ways, thread w reads way w: votes give the first match and the first
// empty way, a min-reduction then a vote the first LRU minimum.  Above
// that, thread t reads ways t, t + 32, ... and the warp reduces each.
struct Found { unsigned match, empty, lru; };

__device__ __forceinline__ Found set_search(const int32_t* tags,
                                            const int32_t* lrus, int n,
                                            int want) {
  Found f;
  if (n <= WARP) {
    const int w = threadIdx.x & (WARP - 1);
    const bool in = w < n;
    const int tg = in ? tags[w] : 0;
    const int l = in ? lrus[w] : INT_MAX;
    const unsigned bm = __ballot_sync(FULL, in && tg == want);
    const unsigned be = __ballot_sync(FULL, in && tg == 0);
    const int lmin = __reduce_min_sync(FULL, l);
    const unsigned bl = __ballot_sync(FULL, in && l == lmin);
    f.match = bm ? __ffs(bm) - 1 : NONE;
    f.empty = be ? __ffs(be) - 1 : NONE;
    f.lru = __ffs(bl) - 1;
    return f;
  }
  unsigned m = NONE, e = NONE, li = NONE;
  int lv = INT_MAX;
  for (int w = threadIdx.x & (WARP - 1); w < n; w += WARP) {
    const int tg = tags[w];
    const int l = lrus[w];
    if (m == NONE && tg == want) m = w;
    if (e == NONE && tg == 0) e = w;
    if (li == NONE || l < lv) { lv = l; li = w; }
  }
  f.match = __reduce_min_sync(FULL, m);
  f.empty = __reduce_min_sync(FULL, e);
  const int lmin = __reduce_min_sync(FULL, lv);
  f.lru = __reduce_min_sync(FULL, lv == lmin ? li : NONE);
  return f;
}

// x / d and x % d for x >= 0 by a divisor fixed for the launch, with a
// shift and a mask when d is a power of two (the defaults' metadata sets
// and groups per metadata line are)
struct Div {
  int d, shift;
  bool pow2;
  __device__ void set(int v) {
    d = v;
    pow2 = v > 0 && (v & (v - 1)) == 0;
    shift = pow2 ? __ffs(v) - 1 : 0;
  }
  __device__ __forceinline__ int div(int x) const {
    return pow2 ? x >> shift : x / d;
  }
  __device__ __forceinline__ int mod(int x) const {
    return pow2 ? x & (d - 1) : x % d;
  }
};

// One ring slot: what event `e` needs that does not depend on the
// events before it, and its group's fetched mem_state and fit bits.
struct Slot { int g, base, pidx, info; };

// One lane: its inputs, its state in shared memory, its scheme row.
struct Lane {
  const int32_t* addrs; const uint8_t* is_write;
  int8_t* mem; const uint8_t* fab; const uint8_t* fcd; const uint8_t* fq;
  const int32_t* set_hash;
  int32_t *tag, *lru, *valid, *dirty, *pf, *mtag, *mlru;
  uint8_t *mdirty, *shadow;
  int8_t* lct;
  const uint16_t* evict;
  const int32_t *probe, *loc, *lis, *ll;
  int* queue;                      // [2][QUEUE] requests, then [2] counts
  long long n;
  unsigned n_groups;
  int sets, ways, mw, lpp, n_levels, sample_thresh, enable, cmax;
  uint32_t hash_mult, lct_size;
  Div gpm, meta_sets;
  bool comp, llp, next, ideal, dyn, lct_update, canonical;
};

// One metadata-cache access (the reference's `meta_probe` followed by
// `_sel_state` with apply = true) of line `mline`, a dirty update when
// `make_dirty`.
__device__ __forceinline__ void meta_access(const Lane& L, int mline,
                                            bool make_dirty, int& mclock,
                                            int* st) {
  const int base = L.meta_sets.mod(mline) * L.mw;
  const Found f = set_search(L.mtag + base, L.mlru + base, L.mw, mline + 1);
  const bool hit = f.match != NONE;
  const int i = base + (int)(hit ? f.match
                             : (f.empty != NONE ? f.empty : f.lru));
  const bool old_dirty = L.mdirty[i] != 0;
  const bool vic_dirty = !hit && L.mtag[i] != 0 && old_dirty;
  __syncwarp();   // read before any thread writes
  L.mtag[i] = mline + 1;
  mclock += 1;
  L.mlru[i] = mclock;
  L.mdirty[i] = ((hit && old_dirty) || make_dirty) ? 1 : 0;
  st[ST_META_READS] += hit ? 0 : 1;
  st[ST_META_WB] += vic_dirty ? 1 : 0;
  st[ST_META_HITS] += hit ? 1 : 0;
}

// The trace's address and write flag of event e (0 past the chunk's end).
__device__ __forceinline__ void fetch_event(const Lane& L, long long e,
                                            int& addr, int& wr) {
  addr = 0;
  wr = 0;
  if (e < L.n) {
    addr = __ldg(L.addrs + e);
    wr = __ldg(L.is_write + e);
  }
}

// The group's mem_state and fit bits, as raw loads (none for a group
// outside [0, n_groups): the event refuses its address).
__device__ __forceinline__ void fetch_group(const Lane& L, int addr,
                                            int& st, int& fa, int& fc,
                                            int& fq) {
  const int g = addr >> 2;
  st = fa = fc = fq = 0;
  if ((unsigned)g < L.n_groups) {
    st = L.mem[g];
    fa = __ldg(L.fab + g);
    fc = __ldg(L.fcd + g);
    fq = __ldg(L.fq + g);
  }
}

__device__ __forceinline__ Slot make_slot(const Lane& L, int addr, int wr,
                                          int st, int fa, int fc, int fq) {
  Slot s;
  s.g = addr >> 2;
  const bool ok = (unsigned)s.g < L.n_groups;
  const int set = ok ? floormod(s.g, L.sets) : 0;
  s.base = set * L.ways;
  const uint32_t page = (uint32_t)floordiv(addr, L.lpp);
  s.pidx = (int)((page * L.hash_mult) % L.lct_size);
  const bool sampled = ok && __ldg(L.set_hash + set) < L.sample_thresh;
  s.info = (state_code(st) << INFO_STATE_SHIFT) | (fa ? INFO_FA : 0)
           | (fc ? INFO_FC : 0)
           | (fq ? INFO_FQ : 0) | (wr ? INFO_WR : 0)
           | (sampled ? INFO_SAMPLED : 0) | ((addr & 3) << INFO_LANE_SHIFT)
           | (ok ? INFO_OK : 0);
  return s;
}

__device__ __forceinline__ Slot shfl_slot(const Slot& s, int j) {
  Slot o;
  o.g = __shfl_sync(FULL, s.g, j);
  o.base = __shfl_sync(FULL, s.base, j);
  o.pidx = __shfl_sync(FULL, s.pidx, j);
  o.info = __shfl_sync(FULL, s.info, j);
  return o;
}

// A ring slot's state after an eviction wrote `ns` to group vg.
__device__ __forceinline__ void patch(Slot& s, int vg, int ns) {
  if (s.g == vg) s.info = (s.info & ~INFO_STATE) | (ns << INFO_STATE_SHIFT);
}

// The two warps of an explicit-metadata lane meet here (named barrier 1;
// barrier 0 is left to __syncthreads): one batch of metadata-cache
// requests changes hands, its writes ordered before the reader's reads.
__device__ __forceinline__ void handoff() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// A batch of the metadata queue: its requests and its count word (the
// count, and FINAL in the last batch).
constexpr int FINAL = 1 << 16;
__device__ __forceinline__ int* queue_batch(const Lane& L, int k) {
  return L.queue + (k & 1) * QUEUE;
}
__device__ __forceinline__ int& queue_count(const Lane& L, int k) {
  return L.queue[2 * QUEUE + (k & 1)];
}

// Every event of the lane, in order, by the lane's first warp.  META: the
// scheme row keeps explicit metadata; its metadata-cache accesses (the
// demand miss's line, and the victim's when its state changes) go in
// order into the queue, a batch of 32 events at a time, for the second
// warp (run_meta), since nothing else the step computes reads the
// metadata cache.  Stops at an event that refuses an input, its flag set
// in `err`; `qk` and `qc` are then the batch and the count of requests
// not yet handed over.
template <bool META>
__device__ __forceinline__ void run_events(const Lane& L, int* st,
                                           int& clock, int& counter,
                                           int& qk, int& qc,
                                           volatile int* err) {
  const int t = threadIdx.x & (WARP - 1);
  // the ring: `cur` holds the current batch's slots; the next batch's
  // addresses are in (n_addr, n_wr) and its group loads in flight in
  // (n_st, n_fa, n_fc, n_fq); n_patch is what an eviction of this batch
  // wrote to the next slot's group (-1: none)
  int addr, wr, gst, gfa, gfc, gfq;
  fetch_event(L, t, addr, wr);
  fetch_group(L, addr, gst, gfa, gfc, gfq);
  Slot cur = make_slot(L, addr, wr, gst, gfa, gfc, gfq);
  int n_addr, n_wr;
  fetch_event(L, WARP + t, n_addr, n_wr);
  for (long long b = 0; b < L.n; b += WARP) {
    int n_st, n_fa, n_fc, n_fq, nn_addr, nn_wr;
    fetch_group(L, n_addr, n_st, n_fa, n_fc, n_fq);
    fetch_event(L, b + 2 * WARP + t, nn_addr, nn_wr);
    const int n_g = n_addr >> 2;
    int n_patch = -1;
    const int len = (int)(L.n - b < WARP ? L.n - b : WARP);
    int* q = META ? queue_batch(L, qk) : nullptr;
    Slot e = shfl_slot(cur, 0);
    for (int j = 0; j < len; ++j) {
      // the next event's slot, shuffled now so that its latency hides
      // behind this event (patched below like the ring)
      Slot nx = shfl_slot(cur, j + 1);
      if (!(e.info & INFO_OK)) {
        if (t == 0) err[ERR_ADDRESS] = 1;
        return;
      }
      const int g = e.g, base = e.base, info = e.info;
      const uint32_t pidx = (uint32_t)e.pidx;
      const int lanei = (info >> INFO_LANE_SHIFT) & 3;
      const int lane_bit = 1 << lanei;
      clock += 1;

      // the set's tag search: first match, first empty, first LRU min
      const Found f = set_search(L.tag + base, L.lru + base, L.ways, g + 1);
      // the miss path's lookups, made before the event knows it misses
      // (indices clamped into the tables; a state or level outside them
      // is refused below, before any of these is used)
      const int sg = (info & INFO_STATE) >> INFO_STATE_SHIFT;
      const int sgc = (sg < MEM_STATES ? sg : 0) * GROUP_LANES;
      const int pred_raw = L.lct[pidx];
      const int predc = (unsigned)pred_raw < (unsigned)L.n_levels ? pred_raw
                                                                   : 0;
      const int probe_v = L.probe[(sgc + lanei) * L.n_levels + predc];
      const int lis_v = L.lis[sgc + L.loc[sgc + lanei]];
      const int level = L.ll[sgc + lanei];

      // the update way: the tag's way on a tag hit, else the victim (the
      // first empty way, else the first LRU minimum); every read of the
      // LLC arrays is at it
      const bool tag_hit = f.match != NONE;
      const int i = base + (int)(tag_hit ? f.match
                                 : (f.empty != NONE ? f.empty : f.lru));
      const int row_v = L.tag[i];
      const int v_valid = L.valid[i];
      const int v_dirty = L.dirty[i];
      const int v_pf = L.pf[i];
      const int sh = L.shadow[i];
      const int vg = row_v - 1;
      // a carry the engine never makes: the victim's state from mem_state
      const int v_mem = (!L.canonical && row_v != 0
                         && (unsigned)vg < L.n_groups) ? L.mem[vg] : 0;
      // every read of the event's state is made: no thread writes before
      // all have read (each thread writes the same values itself)
      __syncwarp();
      const int v_here = tag_hit ? v_valid : 0;
      const bool hit = tag_hit && (v_here & lane_bit) != 0;
      const bool miss = !hit;
      const bool sampled = (info & INFO_SAMPLED) != 0;
      const bool dyn_on = counter >= L.enable;
      const bool pf_bit = hit && (v_pf & lane_bit) != 0;
      const bool evicting = miss && !tag_hit && row_v != 0;

      // the demand group's state from the ring, the victim's from the
      // shadow (vg only when evicting: on an empty victim way it is -1);
      // a carry value outside the tables is refused here, in one place
      const int st_g = miss ? sg : 0, pred = miss ? pred_raw : 0;
      const int vst = evicting ? (L.canonical ? sh >> INFO_STATE_SHIFT
                                              : v_mem) : 0;
      if ((evicting && ((unsigned)vg >= L.n_groups
                        || (unsigned)v_valid >= LANE_MASKS
                        || (unsigned)v_dirty >= LANE_MASKS))
          || (unsigned)st_g >= MEM_STATES || (unsigned)vst >= MEM_STATES
          || (unsigned)pred >= (unsigned)L.n_levels) {
        if (t == 0) err[ERR_CARRY] = 1;
        return;
      }

      // fetch accounting (miss path)
      int probes = 1, obtained = 0;
      if (miss) {
        if (L.llp && lanei != 0) probes = probe_v;
        const int obt_next = lane_bit | (lanei < 3 ? lane_bit << 1 : 0);
        obtained = L.comp ? lis_v : (L.next ? obt_next : lane_bit);
      }

      int wb_d = 0, wb_c = 0, ilw = 0, ns = vst;
      if (evicting) {
        const int ev_en = L.dyn ? ((sampled || dyn_on) ? 1 : 0)
                                : (L.comp ? 1 : 0);
        // the reference's index (((((ev_en * 5 + vst) * 2 + fa) * 2 + fc)
        // * 2 + fq) * 16 + valid) * 16 + dirty; the shadow's low six bits
        // are vst * 8 + fits (the fallback's vst replaces its state)
        const int sfit = (vst << INFO_STATE_SHIFT) | (sh & 7);
        const int eidx = ((ev_en * MEM_STATES * 8 + sfit) * LANE_MASKS
                          + v_valid) * LANE_MASKS + v_dirty;
        const int ev = L.evict[eidx];
        constexpr int M = (1 << EVICT_BITS) - 1;
        wb_d = ev & M;
        wb_c = (ev >> EVICT_BITS) & M;
        ilw = (ev >> (2 * EVICT_BITS)) & M;
        ns = (ev >> (3 * EVICT_BITS)) & M;
      }
      if (L.ideal) { wb_c = 0; ilw = 0; }

      // explicit metadata cache: the demand miss's access (group g), then
      // the victim's dirty update (~vg) when its state changes
      if (META) {
        if (miss) q[qc++] = g;
        if (evicting && ns != vst) q[qc++] = ~vg;
      }

      // stats (demand reads and next-line extra accesses are counted from
      // the misses when the lane ends)
      st[ST_LLC_HITS] += hit ? 1 : 0;
      st[ST_LLC_MISSES] += miss ? 1 : 0;
      st[ST_PF_USED] += (hit && pf_bit) ? 1 : 0;
      st[ST_READ_PROBES] += miss ? probes : 0;
      st[ST_WB_DIRTY] += wb_d;
      st[ST_WB_CLEAN] += wb_c;
      st[ST_IL_WRITES] += ilw;
      const bool need_pred = L.llp && miss && lanei > 0;
      st[ST_PRED_TOTAL] += need_pred ? 1 : 0;
      st[ST_PRED_HIT] += (need_pred && probes == 1) ? 1 : 0;

      // dynamic cost/benefit counter
      if (L.dyn) {
        const int cost = ((evicting && sampled) ? wb_c + ilw : 0)
                         + ((miss && sampled) ? probes - 1 : 0);
        const int benefit = (hit && pf_bit && sampled) ? 1 : 0;
        int c = counter + benefit - cost;
        counter = c < 0 ? 0 : (c > L.cmax ? L.cmax : c);
      }

      // LCT update (frozen when FLAG_LCT_UPDATE is off: cram-nollp)
      if (L.lct_update && miss) L.lct[pidx] = (int8_t)level;

      // the eviction's write, and the ring's slots of the same group
      if (evicting) {
        L.mem[vg] = (int8_t)ns;
        patch(cur, vg, ns);
        patch(nx, vg, ns);
        if (n_g == vg) n_patch = ns;
      }

      // LLC arrays at the update way
      const int wr_bit = (info & INFO_WR) ? lane_bit : 0;
      L.lru[i] = clock;
      if (hit) {
        L.dirty[i] = v_dirty | wr_bit;
        L.pf[i] = v_pf & ~lane_bit;
      } else {
        const int prior = tag_hit ? v_here : 0;
        const int fresh = obtained & ~prior & ~lane_bit;
        st[ST_PF_INSTALLED] += __popc(fresh & 15);
        const int prev_pf = tag_hit ? v_pf : 0;
        const int prev_dirty = tag_hit ? v_dirty : 0;
        L.tag[i] = g + 1;
        L.valid[i] = prior | obtained;
        L.dirty[i] = prev_dirty | wr_bit;
        L.pf[i] = (prev_pf | fresh) & ~lane_bit;
        if (!tag_hit) L.shadow[i] = (uint8_t)(info & 63);
      }
      e = nx;
    }
    if (META) {
      queue_count(L, qk) = qc;
      handoff();
      ++qk;
      qc = 0;
    }
    // the next batch becomes current, its state patched where this batch
    // evicted its group
    cur = make_slot(L, n_addr, n_wr, n_st, n_fa, n_fc, n_fq);
    if (n_patch >= 0)
      cur.info = (cur.info & ~INFO_STATE) | (n_patch << INFO_STATE_SHIFT);
    n_addr = nn_addr;
    n_wr = nn_wr;
  }
}

// The metadata cache of an explicit-metadata lane, by its second warp:
// each batch of requests the first warp hands over, in order (a group g
// is the demand miss's line, ~vg the victim's dirty update), until the
// batch marked FINAL.
__device__ __forceinline__ void run_meta(const Lane& L, int* st,
                                         int& mclock) {
  for (int k = 0;; ++k) {
    handoff();
    const int* q = queue_batch(L, k);
    const int word = queue_count(L, k);
    const int n = word & (FINAL - 1);
    for (int r = 0; r < n; ++r) {
      const int req = q[r];
      meta_access(L, L.gpm.div(req < 0 ? ~req : req), req < 0, mclock, st);
    }
    if (word & FINAL) return;
  }
}

__global__ void __launch_bounds__(2 * WARP)
engine_scan_kernel(const EngineArgs a, volatile int* err) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x & (WARP - 1);
  const bool meta_warp = threadIdx.x >= WARP;
  const long long lane = blockIdx.x;
  const int si = (int)(lane / a.n_workloads);
  const int wi = (int)(lane % a.n_workloads);
  const int sw = (int)(a.sets * a.ways);
  const int mm = (int)(a.meta_sets * a.meta_ways);
  const int n_lct = (int)a.lct_entries;
  const int n_levels = (int)a.n_levels;

  Lane L;
  L.tag = reinterpret_cast<int32_t*>(smem);
  L.lru = L.tag + up16(4LL * sw) / 4;
  L.valid = L.lru + up16(4LL * sw) / 4;
  L.dirty = L.valid + up16(4LL * sw) / 4;
  L.pf = L.dirty + up16(4LL * sw) / 4;
  L.mtag = L.pf + up16(4LL * sw) / 4;
  L.mlru = L.mtag + up16(4LL * mm) / 4;
  L.mdirty = reinterpret_cast<uint8_t*>(L.mlru + up16(4LL * mm) / 4);
  L.lct = reinterpret_cast<int8_t*>(L.mdirty + up16(mm));
  L.shadow = reinterpret_cast<uint8_t*>(L.lct + up16(n_lct));
  uint16_t* s_evict = reinterpret_cast<uint16_t*>(L.shadow + up16(sw));
  int32_t* s_probe = reinterpret_cast<int32_t*>(
      s_evict + up16(2LL * EVICT_ENTRIES) / 2);
  int32_t* s_loc = s_probe + up16(4LL * SLOT_TABLE * n_levels) / 4;
  int32_t* s_lis = s_loc + up16(4LL * SLOT_TABLE) / 4;
  int32_t* s_ll = s_lis + up16(4LL * SLOT_TABLE) / 4;
  L.evict = s_evict; L.probe = s_probe; L.loc = s_loc; L.lis = s_lis;
  L.ll = s_ll;
  L.queue = s_ll + up16(4LL * SLOT_TABLE) / 4;

  const int32_t* fl = a.flags + si * N_FLAGS;
  const int32_t* pr = a.params + si * N_PARAMS;
  const bool f_meta = fl[FLAG_META] > 0;
  const int lct_param = pr[PARAM_LCT_SIZE];
  const int meta_sets = pr[PARAM_META_SETS];
  const bool params_ok = lct_param >= 1 && lct_param <= n_lct
                         && meta_sets >= 1 && meta_sets <= a.meta_sets;
  L.mw = (int)a.meta_ways;
  L.gpm.set((int)a.groups_per_meta);
  L.meta_sets.set(meta_sets);

  if (meta_warp) {
    // the second warp: an explicit-metadata lane's metadata cache
    if (!f_meta) return;
    int32_t* g_mtag = a.mtag + lane * mm;
    int32_t* g_mlru = a.mlru + lane * mm;
    uint8_t* g_mdirty = a.mdirty + lane * mm;
    for (int i = t; i < mm; i += WARP) {
      L.mtag[i] = g_mtag[i]; L.mlru[i] = g_mlru[i];
      L.mdirty[i] = g_mdirty[i];
    }
    int mclock = a.mclock[lane];
    int st[N_STATS];
    for (int k = ST_META_READS; k <= ST_META_HITS; ++k)
      st[k] = a.stats[lane * N_STATS + k];
    __syncwarp();
    run_meta(L, st, mclock);
    __syncwarp();
    for (int i = t; i < mm; i += WARP) {
      g_mtag[i] = L.mtag[i]; g_mlru[i] = L.mlru[i];
      g_mdirty[i] = L.mdirty[i];
    }
    if (t == 0) {
      if (a.lane_ns != nullptr) a.lane_ns[2 * lane + 1] = globaltimer();
      a.mclock[lane] = mclock;
      for (int k = ST_META_READS; k <= ST_META_HITS; ++k)
        a.stats[lane * N_STATS + k] = st[k];
    }
    return;
  }

  // the first warp: everything else
  int32_t* g_tag = a.tag + lane * sw;
  int32_t* g_lru = a.lru + lane * sw;
  int32_t* g_valid = a.valid + lane * sw;
  int32_t* g_dirty = a.dirty + lane * sw;
  int32_t* g_pf = a.pf + lane * sw;
  int8_t* g_lct = a.lct + lane * n_lct;
  L.mem = a.mem_state + lane * a.n_groups;
  L.fab = a.pair_ab + wi * a.n_groups;
  L.fcd = a.pair_cd + wi * a.n_groups;
  L.fq = a.quad + wi * a.n_groups;
  L.n_groups = (unsigned)a.n_groups;

  // stage the lane's state and the tables; fill the shadow of every way
  // the carry holds, and check that no group is held twice or outside
  // its set (the shadow's invariant)
  bool placed = true;
  for (int i = t; i < sw; i += WARP) {
    const int tg = g_tag[i];
    L.tag[i] = tg; L.lru[i] = g_lru[i]; L.valid[i] = g_valid[i];
    L.dirty[i] = g_dirty[i]; L.pf[i] = g_pf[i];
    const unsigned vg = (unsigned)(tg - 1);
    int sh = 0;
    if (tg != 0 && vg < L.n_groups) {
      sh = (state_code(L.mem[vg]) << INFO_STATE_SHIFT)
           | (__ldg(L.fab + vg) ? INFO_FA : 0)
           | (__ldg(L.fcd + vg) ? INFO_FC : 0)
           | (__ldg(L.fq + vg) ? INFO_FQ : 0);
      const int set = i / (int)a.ways;
      placed &= floormod((int)vg, (int)a.sets) == set;
      for (int j = set * (int)a.ways; j < i; ++j) placed &= g_tag[j] != tg;
    }
    L.shadow[i] = (uint8_t)sh;
  }
  L.canonical = __all_sync(FULL, placed);
  for (int i = t; i < n_lct; i += WARP) L.lct[i] = g_lct[i];
  for (int i = t; i < EVICT_ENTRIES; i += WARP) s_evict[i] = __ldg(a.evict + i);
  for (int i = t; i < SLOT_TABLE * n_levels; i += WARP)
    s_probe[i] = __ldg(a.probe + i);
  for (int i = t; i < SLOT_TABLE; i += WARP) {
    s_loc[i] = __ldg(a.loc + i);
    s_lis[i] = __ldg(a.lanes_in_slot + i);
    s_ll[i] = __ldg(a.lane_level + i);
  }
  __syncwarp();

  L.comp = fl[FLAG_COMP] > 0; L.llp = fl[FLAG_LLP] > 0;
  L.next = fl[FLAG_NEXTLINE] > 0; L.ideal = fl[FLAG_IDEAL] > 0;
  L.dyn = fl[FLAG_DYNAMIC] > 0; L.lct_update = fl[FLAG_LCT_UPDATE] > 0;
  if (!params_ok && t == 0) err[ERR_PARAMS] = 1;
  L.addrs = a.addrs + wi * a.addr_stride;
  L.is_write = a.is_write + wi * a.write_stride;
  L.set_hash = a.set_hash;
  L.n = params_ok ? a.n_events : 0;
  L.sets = (int)a.sets; L.ways = (int)a.ways;
  L.lpp = (int)a.lines_per_page; L.n_levels = n_levels;
  L.sample_thresh = pr[PARAM_SAMPLE_THRESH];
  L.enable = (int)a.enable_threshold; L.cmax = (int)a.counter_max;
  L.hash_mult = (uint32_t)a.hash_mult; L.lct_size = (uint32_t)lct_param;

  int counter = a.counter[lane], clock = a.clock[lane];
  int st[N_STATS];
#pragma unroll
  for (int k = 0; k < N_STATS; ++k) st[k] = a.stats[lane * N_STATS + k];
  const long long t_start = globaltimer();
  const int misses0 = st[ST_LLC_MISSES];
  int qk = 0, qc = 0;
  if (L.n > 0) {
    if (f_meta) run_events<true>(L, st, clock, counter, qk, qc, err);
    else run_events<false>(L, st, clock, counter, qk, qc, err);
  }
  if (f_meta) {
    // the last batch of requests (perhaps empty), marked FINAL
    queue_count(L, qk) = qc | FINAL;
    handoff();
  }
  const int misses = st[ST_LLC_MISSES] - misses0;
  st[ST_DEMAND_READS] += misses;
  st[ST_PF_EXTRA_ACCESS] += L.next ? misses : 0;
  if (t == 0) {
    if (a.lane_ns != nullptr) {
      a.lane_ns[2 * lane] = t_start;
      if (!f_meta) a.lane_ns[2 * lane + 1] = globaltimer();
    }
    a.counter[lane] = counter;
    a.clock[lane] = clock;
#pragma unroll
    for (int k = 0; k < N_STATS; ++k)
      if (!f_meta || k < ST_META_READS || k > ST_META_HITS)
        a.stats[lane * N_STATS + k] = st[k];
  }
  __syncwarp();
  for (int i = t; i < sw; i += WARP) {
    g_tag[i] = L.tag[i]; g_lru[i] = L.lru[i]; g_valid[i] = L.valid[i];
    g_dirty[i] = L.dirty[i]; g_pf[i] = L.pf[i];
  }
  for (int i = t; i < n_lct; i += WARP) g_lct[i] = L.lct[i];
}

// Launches E1 on `stream` and returns without waiting: 0 or a cudaError.
// `err` points to ERR_KINDS int32 flags on the launch's device, zero
// before the first launch of a run; a lane that refuses an input sets its
// kind's flag to 1 (the carry then holds each lane's state as far as it
// got).  Launches on other devices or streams share nothing.
extern "C" int cram_engine_scan(const EngineArgs* args, long long smem,
                                int* err, void* stream) {
  const EngineArgs a = *args;
  const long long lanes = a.n_schemes * a.n_workloads;
  if (lanes <= 0 || lanes > 0x7FFFFFFFLL || a.n_events <= 0 || smem <= 0
      || a.n_groups <= 0 || a.n_groups > 0x7FFFFFFFLL || a.n_levels <= 0
      || err == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long expect = smem_layout(a.sets * a.ways,
                                       a.meta_sets * a.meta_ways,
                                       a.lct_entries, a.n_levels);
  if (smem != expect) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      engine_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  engine_scan_kernel<<<(unsigned)lanes, 2 * WARP, (size_t)smem,
                       (cudaStream_t)stream>>>(a, err);
  return (int)cudaGetLastError();
}
