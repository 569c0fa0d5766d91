// E1: the trace engine's scan, every event of a chunk for every lane.
//
// Replaces: the step of `src/repro/core/engine.py:221-378` (`run_chunk`, a
// `lax.scan` over the trace), vmapped over schemes and workloads at
// `src/repro/core/batchsim.py:45-58`.  No `pallas_call`: the reference
// compiles that loop with XLA.  A lane is one (scheme row, workload) pair;
// lane `si * W + wi` runs scheme row si's flags and params over workload
// wi's trace and fit bitmaps.
//
// What bounds it: the chain of dependent reads inside a lane, one event
// after another (each event reads the state the previous one wrote: the
// LLC set, the metadata cache, the LCT, mem_state), with at most a few
// hundred lanes (270 at the paper's 10 rows x 27 workloads), so at most
// about 2 CTAs per SM.  The bytes moved (trace, fit bitmaps, state) are
// far below what the card could move in the same time.
//
// What the design does about that: one CTA of one warp per lane.  The
// warp stages the lane's small state into dynamic shared memory (the five
// LLC arrays, the metadata cache, the LCT), one thread runs the events in
// order against it, and the warp writes it back.  Only mem_state (one
// byte per group, 256 KiB a lane at the defaults), the trace and the fit
// bitmaps stay in global memory; every scheme lane of a workload reads
// the same trace row.  A hit touches shared memory only; a miss reads
// mem_state[g], an eviction reads mem_state[vg] and the three fit bits,
// started together.  The tables (eviction table, PROBE, LOC,
// LANES_IN_SLOT, LANE_LEVEL, SET_HASH) come in as tensors built from the
// port's numpy tables.
//
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
// (mem_state, LCT levels, valid/dirty masks, victim tags).  A lane that
// finds one stops there and sets a flag in mapped host memory; the entry
// point waits for the launch and returns the flag as a negative code.

#include <cstdint>
#include <mutex>
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
// what a lane refused, one flag each; returned as -(1 + kind)
enum { ERR_ADDRESS = 0, ERR_PARAMS = 1, ERR_CARRY = 2, ERR_KINDS = 3 };

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
  const int32_t* evt_wb_dirty; const int32_t* evt_wb_clean;
  const int32_t* evt_il; const int32_t* evt_new_state;
  const int32_t* probe; const int32_t* loc; const int32_t* lanes_in_slot;
  const int32_t* lane_level; const int32_t* set_hash;
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

__host__ __device__ __forceinline__ long long up16(long long n) {
  return (n + 15) / 16 * 16;
}

// One metadata-cache access, applied (the caller gates it): the
// reference's `meta_probe` followed by `_sel_state` with apply = true.
__device__ __forceinline__ void meta_probe(int32_t* mtag, int32_t* mlru,
                                           uint8_t* mdirty, int& mclock,
                                           int mw, int meta_sets, int mline,
                                           bool make_dirty, int& reads,
                                           int& wbs, int& hits) {
  const int ms = floormod(mline, meta_sets);
  int32_t* row = mtag + ms * mw;
  int32_t* lrow = mlru + ms * mw;
  uint8_t* drow = mdirty + ms * mw;
  int hw = -1, ew = -1, lw = 0;
  int lmin = lrow[0];
  for (int w = 0; w < mw; ++w) {
    const int tg = row[w];
    if (hw < 0 && tg == mline + 1) hw = w;
    if (ew < 0 && tg == 0) ew = w;
    const int lv = lrow[w];
    if (lv < lmin) { lmin = lv; lw = w; }
  }
  const bool hit = hw >= 0;
  const int way = hit ? hw : (ew >= 0 ? ew : lw);
  const bool old_dirty = drow[way] != 0;
  const bool vic_dirty = !hit && row[way] != 0 && old_dirty;
  row[way] = mline + 1;
  mclock += 1;
  lrow[way] = mclock;
  drow[way] = ((hit && old_dirty) || make_dirty) ? 1 : 0;
  reads += hit ? 0 : 1;
  wbs += vic_dirty ? 1 : 0;
  hits += hit ? 1 : 0;
}

__global__ void __launch_bounds__(32)
engine_scan_kernel(const EngineArgs a, volatile int* err) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long lane = blockIdx.x;
  const int si = (int)(lane / a.n_workloads);
  const int wi = (int)(lane % a.n_workloads);
  const int sw = (int)(a.sets * a.ways);
  const int mm = (int)(a.meta_sets * a.meta_ways);
  const int n_lct = (int)a.lct_entries;

  int32_t* s_tag = reinterpret_cast<int32_t*>(smem);
  int32_t* s_lru = s_tag + up16(4LL * sw) / 4;
  int32_t* s_valid = s_lru + up16(4LL * sw) / 4;
  int32_t* s_dirty = s_valid + up16(4LL * sw) / 4;
  int32_t* s_pf = s_dirty + up16(4LL * sw) / 4;
  int32_t* s_mtag = s_pf + up16(4LL * sw) / 4;
  int32_t* s_mlru = s_mtag + up16(4LL * mm) / 4;
  uint8_t* s_mdirty = reinterpret_cast<uint8_t*>(s_mlru + up16(4LL * mm) / 4);
  int8_t* s_lct = reinterpret_cast<int8_t*>(s_mdirty + up16(mm));

  int32_t* g_tag = a.tag + lane * sw;
  int32_t* g_lru = a.lru + lane * sw;
  int32_t* g_valid = a.valid + lane * sw;
  int32_t* g_dirty = a.dirty + lane * sw;
  int32_t* g_pf = a.pf + lane * sw;
  int32_t* g_mtag = a.mtag + lane * mm;
  int32_t* g_mlru = a.mlru + lane * mm;
  uint8_t* g_mdirty = a.mdirty + lane * mm;
  int8_t* g_lct = a.lct + lane * n_lct;

  for (int i = threadIdx.x; i < sw; i += blockDim.x) {
    s_tag[i] = g_tag[i]; s_lru[i] = g_lru[i]; s_valid[i] = g_valid[i];
    s_dirty[i] = g_dirty[i]; s_pf[i] = g_pf[i];
  }
  for (int i = threadIdx.x; i < mm; i += blockDim.x) {
    s_mtag[i] = g_mtag[i]; s_mlru[i] = g_mlru[i]; s_mdirty[i] = g_mdirty[i];
  }
  for (int i = threadIdx.x; i < n_lct; i += blockDim.x) s_lct[i] = g_lct[i];
  __syncthreads();

  if (threadIdx.x == 0) {
    const int32_t* fl = a.flags + si * N_FLAGS;
    const int32_t* pr = a.params + si * N_PARAMS;
    const bool f_comp = fl[FLAG_COMP] > 0, f_llp = fl[FLAG_LLP] > 0;
    const bool f_meta = fl[FLAG_META] > 0, f_next = fl[FLAG_NEXTLINE] > 0;
    const bool f_ideal = fl[FLAG_IDEAL] > 0, f_dyn = fl[FLAG_DYNAMIC] > 0;
    const bool f_lct = fl[FLAG_LCT_UPDATE] > 0;
    const int lct_param = pr[PARAM_LCT_SIZE];
    const uint32_t lct_size = (uint32_t)lct_param;
    const int sample_thresh = pr[PARAM_SAMPLE_THRESH];
    const int meta_sets = pr[PARAM_META_SETS];
    const bool params_ok = lct_param >= 1 && lct_param <= n_lct
                           && meta_sets >= 1 && meta_sets <= a.meta_sets;
    if (!params_ok) err[ERR_PARAMS] = 1;
    const int sets = (int)a.sets, ways = (int)a.ways;
    const int mw = (int)a.meta_ways, n_levels = (int)a.n_levels;
    const int enable = (int)a.enable_threshold, cmax = (int)a.counter_max;
    const uint32_t hash_mult = (uint32_t)a.hash_mult;
    const int lpp = (int)a.lines_per_page, gpm = (int)a.groups_per_meta;

    int mclock = a.mclock[lane], counter = a.counter[lane];
    int clock = a.clock[lane];
    int st[N_STATS];
#pragma unroll
    for (int k = 0; k < N_STATS; ++k) st[k] = a.stats[lane * N_STATS + k];

    const int32_t* __restrict__ arow = a.addrs + wi * a.addr_stride;
    const uint8_t* __restrict__ wrow = a.is_write + wi * a.write_stride;
    int8_t* __restrict__ mem = a.mem_state + lane * a.n_groups;
    const uint8_t* __restrict__ fab = a.pair_ab + wi * a.n_groups;
    const uint8_t* __restrict__ fcd = a.pair_cd + wi * a.n_groups;
    const uint8_t* __restrict__ fq = a.quad + wi * a.n_groups;

    const long long n = params_ok ? a.n_events : 0;
    const unsigned n_groups = (unsigned)a.n_groups;
    int next_addr = __ldg(arow);
    int next_wr = __ldg(wrow);
    for (long long e = 0; e < n; ++e) {
      const int addr = next_addr;
      const bool wr = next_wr != 0;
      if (e + 1 < n) {
        next_addr = __ldg(arow + e + 1);
        next_wr = __ldg(wrow + e + 1);
      }
      const int g = addr >> 2;
      if ((unsigned)g >= n_groups) { err[ERR_ADDRESS] = 1; break; }
      const int lanei = addr & 3;
      const int lane_bit = 1 << lanei;
      const int s = floormod(g, sets);
      clock += 1;

      // the set's tag search: first match, first empty, first LRU minimum
      const int base = s * ways;
      int way = 0, ew = -1, lw = 0;
      bool tag_hit = false;
      int lmin = s_lru[base];
      for (int w = 0; w < ways; ++w) {
        const int tg = s_tag[base + w];
        if (!tag_hit && tg == g + 1) { tag_hit = true; way = w; }
        if (ew < 0 && tg == 0) ew = w;
        const int lv = s_lru[base + w];
        if (lv < lmin) { lmin = lv; lw = w; }
      }
      const int v_here = tag_hit ? s_valid[base + way] : 0;
      const bool hit = tag_hit && (v_here & lane_bit) != 0;
      const bool miss = !hit;
      const bool sampled = __ldg(a.set_hash + s) < sample_thresh;
      const bool dyn_on = counter >= enable;
      const bool pf_bit = hit && (s_pf[base + way] & lane_bit) != 0;

      // victim: merge into the existing way when the group tag is present
      const int vway = tag_hit ? way : (ew >= 0 ? ew : lw);
      const int row_v = s_tag[base + vway];
      const bool evicting = miss && !tag_hit && row_v != 0;
      const int vg = row_v - 1;
      const int v_valid = s_valid[base + vway];
      const int v_dirty = s_dirty[base + vway];
      if (evicting && ((unsigned)vg >= n_groups
                       || (unsigned)v_valid >= LANE_MASKS
                       || (unsigned)v_dirty >= LANE_MASKS)) {
        err[ERR_CARRY] = 1;
        break;
      }

      // this event's global reads, started together (vg only when evicting:
      // on an empty victim way it is -1)
      int st_g = 0, vst = 0, fa = 0, fc = 0, fqv = 0;
      if (miss) st_g = mem[g];
      if (evicting) {
        vst = mem[vg];
        fa = __ldg(fab + vg); fc = __ldg(fcd + vg); fqv = __ldg(fq + vg);
      }
      uint32_t pidx = 0;
      int pred = 0;
      if (miss) {
        const uint32_t page = (uint32_t)floordiv(addr, lpp);
        pidx = (page * hash_mult) % lct_size;
        pred = s_lct[pidx];
      }
      if ((unsigned)st_g >= MEM_STATES || (unsigned)vst >= MEM_STATES
          || (unsigned)pred >= (unsigned)n_levels) {
        err[ERR_CARRY] = 1;
        break;
      }

      // fetch accounting (miss path)
      int probes = 1, obtained = 0;
      if (miss) {
        if (f_llp && lanei != 0)
          probes = __ldg(a.probe + (st_g * GROUP_LANES + lanei) * n_levels
                         + pred);
        const int true_slot = __ldg(a.loc + st_g * GROUP_LANES + lanei);
        const int obt_next = lane_bit | (lanei < 3 ? lane_bit << 1 : 0);
        obtained = f_comp
            ? __ldg(a.lanes_in_slot + st_g * GROUP_LANES + true_slot)
            : (f_next ? obt_next : lane_bit);
      }

      int wb_d = 0, wb_c = 0, ilw = 0, ns = vst;
      if (evicting) {
        const int ev_en = f_dyn ? ((sampled || dyn_on) ? 1 : 0)
                                : (f_comp ? 1 : 0);
        const int eidx =
            (((((ev_en * MEM_STATES + vst) * 2 + fa) * 2 + fc) * 2 + fqv)
                 * LANE_MASKS + v_valid) * LANE_MASKS + v_dirty;
        wb_d = __ldg(a.evt_wb_dirty + eidx);
        wb_c = __ldg(a.evt_wb_clean + eidx);
        ilw = __ldg(a.evt_il + eidx);
        ns = __ldg(a.evt_new_state + eidx);
      }
      if (f_ideal) { wb_c = 0; ilw = 0; }

      // stats
      st[ST_LLC_HITS] += hit ? 1 : 0;
      st[ST_LLC_MISSES] += miss ? 1 : 0;
      st[ST_PF_USED] += (hit && pf_bit) ? 1 : 0;
      st[ST_DEMAND_READS] += miss ? 1 : 0;
      st[ST_READ_PROBES] += miss ? probes : 0;
      st[ST_WB_DIRTY] += wb_d;
      st[ST_WB_CLEAN] += wb_c;
      st[ST_IL_WRITES] += ilw;
      const bool need_pred = f_llp && miss && lanei > 0;
      st[ST_PRED_TOTAL] += need_pred ? 1 : 0;
      st[ST_PRED_HIT] += (need_pred && probes == 1) ? 1 : 0;
      st[ST_PF_EXTRA_ACCESS] += (f_next && miss) ? 1 : 0;

      // dynamic cost/benefit counter
      if (f_dyn) {
        const int cost = ((evicting && sampled) ? wb_c + ilw : 0)
                         + ((miss && sampled) ? probes - 1 : 0);
        const int benefit = (hit && pf_bit && sampled) ? 1 : 0;
        int c = counter + benefit - cost;
        counter = c < 0 ? 0 : (c > cmax ? cmax : c);
      }

      // explicit metadata cache: demand miss first, then the victim's
      // dirty update against the state the first probe left
      if (f_meta && miss)
        meta_probe(s_mtag, s_mlru, s_mdirty, mclock, mw, meta_sets,
                   floordiv(g, gpm), false, st[ST_META_READS],
                   st[ST_META_WB], st[ST_META_HITS]);
      if (f_meta && evicting && ns != vst)
        meta_probe(s_mtag, s_mlru, s_mdirty, mclock, mw, meta_sets,
                   floordiv(vg, gpm), true, st[ST_META_READS],
                   st[ST_META_WB], st[ST_META_HITS]);

      // LCT update (frozen when FLAG_LCT_UPDATE is off: cram-nollp)
      if (f_lct && miss)
        s_lct[pidx] = (int8_t)__ldg(a.lane_level + st_g * GROUP_LANES + lanei);

      if (evicting) mem[vg] = (int8_t)ns;

      // LLC arrays at the update way
      const int i = base + (hit ? way : vway);
      const int wr_bit = wr ? lane_bit : 0;
      s_lru[i] = clock;
      if (hit) {
        s_dirty[i] = s_dirty[i] | wr_bit;
        s_pf[i] = s_pf[i] & ~lane_bit;
      } else {
        const int prior = tag_hit ? v_here : 0;
        const int fresh = obtained & ~prior & ~lane_bit;
        st[ST_PF_INSTALLED] += __popc(fresh & 15);
        const int prev_pf = tag_hit ? s_pf[i] : 0;
        const int prev_dirty = tag_hit ? s_dirty[i] : 0;
        s_tag[i] = g + 1;
        s_valid[i] = prior | obtained;
        s_dirty[i] = prev_dirty | wr_bit;
        s_pf[i] = (prev_pf | fresh) & ~lane_bit;
      }
    }

    a.mclock[lane] = mclock;
    a.counter[lane] = counter;
    a.clock[lane] = clock;
#pragma unroll
    for (int k = 0; k < N_STATS; ++k) a.stats[lane * N_STATS + k] = st[k];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < sw; i += blockDim.x) {
    g_tag[i] = s_tag[i]; g_lru[i] = s_lru[i]; g_valid[i] = s_valid[i];
    g_dirty[i] = s_dirty[i]; g_pf[i] = s_pf[i];
  }
  for (int i = threadIdx.x; i < mm; i += blockDim.x) {
    g_mtag[i] = s_mtag[i]; g_mlru[i] = s_mlru[i]; g_mdirty[i] = s_mdirty[i];
  }
  for (int i = threadIdx.x; i < n_lct; i += blockDim.x) g_lct[i] = s_lct[i];
}

// Launches E1 on `stream` and waits for it.  Returns 0, a cudaError, or
// -(1 + kind) when a lane refused an input (ERR_*); the carry then holds
// each lane's state as far as it got.
extern "C" int cram_engine_scan(const EngineArgs* args, long long smem,
                                void* stream) {
  const EngineArgs a = *args;
  const long long lanes = a.n_schemes * a.n_workloads;
  if (lanes <= 0 || lanes > 0x7FFFFFFFLL || a.n_events <= 0 || smem <= 0
      || a.n_groups <= 0 || a.n_groups > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const long long expect = 5 * up16(4 * a.sets * a.ways)
      + 2 * up16(4 * a.meta_sets * a.meta_ways)
      + up16(a.meta_sets * a.meta_ways) + up16(a.lct_entries);
  if (smem != expect) return (int)cudaErrorInvalidValue;

  // one set of flags for the process, in mapped host memory: the kernel
  // writes them without a copy being enqueued
  static std::mutex mu;
  static int* host_err = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t err = cudaSuccess;
  if (host_err == nullptr) {
    err = cudaHostAlloc(reinterpret_cast<void**>(&host_err),
                        ERR_KINDS * sizeof(int),
                        cudaHostAllocMapped | cudaHostAllocPortable);
    if (err != cudaSuccess) { host_err = nullptr; return (int)err; }
  }
  int* dev_err = nullptr;
  err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&dev_err),
                                 host_err, 0);
  if (err != cudaSuccess) return (int)err;
  volatile int* flags = host_err;
  for (int k = 0; k < ERR_KINDS; ++k) flags[k] = 0;

  err = cudaFuncSetAttribute(engine_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  engine_scan_kernel<<<(unsigned)lanes, 32, (size_t)smem,
                       (cudaStream_t)stream>>>(a, dev_err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamSynchronize((cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < ERR_KINDS; ++k)
    if (flags[k]) return -(1 + k);
  return 0;
}
