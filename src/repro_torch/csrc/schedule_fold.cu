// The store's request fold: every request of a decode step routed through
// the DaeMon selection unit (§4.2) and priced on the shared module bank
// (§4.1 partitioned channels), and on the owning replica's NIC bank in a
// replicated store, in sequence order and then request order.
//
// Replaces the reference's `lax.scan` over a step's requests
// (repro/core/daemon_store.py, `_schedule`). The reference has no Pallas
// kernel for it: on the TPU the scan compiles into the step. Run as plain
// PyTorch it is ~219 small launches a request.
//
// What bounds it is the chain of requests, not bytes. Every request reads
// the module bank that the request before it left (busy clocks, byte
// ledgers, demand EMAs, the carried partition ratio), so a step's requests
// form one dependent chain. The state is a few KB: B sequences of P page
// and S sub-block inflight entries, and nine floats per module. The
// design:
//   * one block. Warp 0 walks the chain. The other warps stream the
//     sequences' engine rows through two buffers in shared memory: while
//     warp 0 walks sequence q, they write sequence q - 1 out and load
//     sequence q + 1, so the walk never waits on device memory;
//   * the module and NIC banks live in shared memory for the whole launch
//     and are written out once at the end. After each sequence, warp 0
//     writes that sequence's snapshot of the bank's page clocks and ratios
//     (the telemetry series reads them);
//   * each request's CAM scans (find, first free entry, occupancy over the
//     P page entries and the S sub-block entries) are warp ballots, where
//     the lowest index wins, as argmax's first maximum does. Lane 0 does
//     the request's scalar arithmetic and writes what changes;
//   * the f32 arithmetic is the plain version's, op for op and in its
//     order, each op rounded on its own (`__fadd_rn` and friends, never
//     fused into an FMA). A bytes constant over a bandwidth is a
//     reciprocal and a product, as torch evaluates `float / tensor`; an
//     occupancy is the count times the f32 reciprocal of the size, as
//     torch's CUDA mean is; a constant is the f32 rounding of the double;
//   * nothing is written in place: every output is a fresh buffer, the
//     unchanged leaves copied into it.
//
// Plain C interface, loaded with ctypes. The launcher takes the pointers,
// integers and floats as three host arrays in the order the wrapper
// (kernels/schedule_fold.py, `_PTRS`) lays them out, runs on the caller's
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLeaves = 9;            // the bank leaves the fold carries
constexpr int kNumPtrs = 69;
constexpr int kNumInts = 14;
constexpr int kNumFloats = 11;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kHashMult = 2654435769u;   // fabric._HASH_MULT, unsigned
// the 1e-6 floor of the bandwidth and demand clamps, rounded as torch does
constexpr float kMinBw = static_cast<float>(1e-6);
constexpr int8_t kScheduled = 1;

// FabricState's field order
enum Leaf { kLineBusy, kPageBusy, kWbBusy, kLineBytes, kPageBytes,
            kWbBytes, kRatio, kLineRate, kPageRate };

struct Bank {
    const float* in[kLeaves];
    const float* bw;          // (M,)
    const float* sched_t;     // (K,)
    const float* mult;        // (K, M)
    const float* health;      // (K, M)
    float* out[kLeaves];
    int m, k;
};

struct Engine {               // EngineState, leaves (B, P) and (B, S)
    int32_t* page_key;
    int8_t* page_state;
    float* page_arrival;
    float* page_issue;
    int8_t* page_dirty;
    int32_t* sb_key;
    float* sb_arrival;
};

struct Args {
    Engine in, out;
    Bank mem, nic;
    const int32_t* need;      // (B, R)
    const int32_t* offs;      // (B, R)
    const uint8_t* hit;       // (B, R) bool
    const float* clock;       // 0-d
    const int64_t* cus;       // (B,) NIC unit of each sequence
    const uint8_t* active;    // 0-d bool NIC gate
    uint8_t* line_sent;       // (B, R) bool
    uint8_t* page_sent;       // (B, R) bool
    float* stalls;            // (B, R)
    float* seen_busy;         // (B, M)
    float* seen_ratio;        // (B, M)
    int b, r, p, s, lpp, placement, affinity, selection, adaptive, has_nic;
    float nominal, line_wire, page_wire, r_idle, ema_alpha, ema_keep, gain,
        ratio_min, ratio_max, big, big_half;
};

// One sequence's engine rows in shared memory.
struct Rows {
    int32_t* page_key;
    float* page_arrival;
    float* page_issue;
    int32_t* sb_key;
    float* sb_arrival;
    int8_t* page_state;
    int8_t* page_dirty;
};

__host__ __device__ inline size_t round16(size_t x) {
    return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t rows_bytes(int p, int s) {
    return round16(static_cast<size_t>(p) * 14 + static_cast<size_t>(s) * 8);
}

__host__ __device__ inline size_t banks_bytes(int m, int c) {
    return round16(sizeof(float) * kLeaves * static_cast<size_t>(m + c));
}

__device__ Rows rows_at(unsigned char* base, int p, int s) {
    Rows e;
    e.page_key = reinterpret_cast<int32_t*>(base);
    e.page_arrival = reinterpret_cast<float*>(e.page_key + p);
    e.page_issue = e.page_arrival + p;
    e.sb_key = reinterpret_cast<int32_t*>(e.page_issue + p);
    e.sb_arrival = reinterpret_cast<float*>(e.sb_key + s);
    e.page_state = reinterpret_cast<int8_t*>(e.sb_arrival + s);
    e.page_dirty = e.page_state + p;
    return e;
}

// Sequence q's rows between device memory and shared memory, element i by
// the thread t0 + j * nt: a thread that writes a buffer out and then loads
// the next sequence into it touches the same elements in the same order.
__device__ void load_rows(const Engine& g, Rows e, int q, int p, int s,
                          int t0, int nt) {
    const size_t op = static_cast<size_t>(q) * p;
    const size_t os = static_cast<size_t>(q) * s;
    for (int i = t0; i < p; i += nt) {
        e.page_key[i] = g.page_key[op + i];
        e.page_state[i] = g.page_state[op + i];
        e.page_arrival[i] = g.page_arrival[op + i];
        e.page_issue[i] = g.page_issue[op + i];
        e.page_dirty[i] = g.page_dirty[op + i];
    }
    for (int i = t0; i < s; i += nt) {
        e.sb_key[i] = g.sb_key[os + i];
        e.sb_arrival[i] = g.sb_arrival[os + i];
    }
}

__device__ void store_rows(const Engine& g, Rows e, int q, int p, int s,
                           int t0, int nt) {
    const size_t op = static_cast<size_t>(q) * p;
    const size_t os = static_cast<size_t>(q) * s;
    for (int i = t0; i < p; i += nt) {
        g.page_key[op + i] = e.page_key[i];
        g.page_state[op + i] = e.page_state[i];
        g.page_arrival[op + i] = e.page_arrival[i];
        g.page_issue[op + i] = e.page_issue[i];
        g.page_dirty[op + i] = e.page_dirty[i];
    }
    for (int i = t0; i < s; i += nt) {
        g.sb_key[os + i] = e.sb_key[i];
        g.sb_arrival[os + i] = e.sb_arrival[i];
    }
}

// ------------------------------------------------- torch's f32 semantics
__device__ __forceinline__ float fadd(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
    return __fdiv_rn(a, b);
}
// `c / t` for a Python float c and a tensor t: t.reciprocal() * c
__device__ __forceinline__ float rdiv(float c, float t) {
    return __fmul_rn(__frcp_rn(t), c);
}
__device__ __forceinline__ bool is_nan(float x) { return x != x; }
// torch.maximum / torch.minimum as torch's CUDA kernels compute them: a
// NaN operand wins, the first if both are
__device__ __forceinline__ float tmax(float a, float b) {
    return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
    return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}
// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return is_nan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// ------------------------------------------------ integer semantics
// torch's `%` and floor division on int32: the result takes the divisor's
// sign
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
    int32_t r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t b) {
    const int32_t q = a / b;
    return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// fabric.place: page id -> module
__device__ int place(int32_t pid, const Args& a) {
    const int32_t m = a.mem.m;
    if (a.placement == 0) return floor_mod(pid, m);           // interleave
    if (a.placement == 1) {                                    // hash
        const uint32_t mixed =
            (static_cast<uint32_t>(pid) * kHashMult) & 0x7fffffffu;
        return static_cast<int32_t>(mixed >> 8) % m;
    }
    return floor_mod(floor_div(pid, a.affinity), m);           // affinity
}

// fabric._segment: searchsorted(sched_t, now, right=True) - 1, clamped
// (the binary search of torch's kernel, so an unsorted schedule agrees)
__device__ int segment(const Bank& bk, float now) {
    int lo = 0, hi = bk.k;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(bk.sched_t[mid] > now)) lo = mid + 1;
        else hi = mid;
    }
    const int seg = lo - 1;
    return seg < 0 ? 0 : (seg > bk.k - 1 ? bk.k - 1 : seg);
}

// fabric.link_bw_at: bw[mc] * mult[seg, mc] * health[seg, mc]
__device__ float bw_at(const Bank& bk, int seg, int mc) {
    const int flat = seg * bk.m + mc;
    return fmul(fmul(bk.bw[mc], bk.mult[flat]), bk.health[flat]);
}

struct Served {
    float line_done, page_done;
};

// fabric.serve_dual_at on unit `u` of a bank held in shared memory
// (`sm`, leaf-major, `n` units), partitioned, both transfers ready at
// `clock`, with the unit's carried ratio `ratio`.
__device__ Served serve(float* sm, int n, int u, float bw, float ratio,
                        float clock, bool line_gate, bool page_gate,
                        const Args& a) {
    float* line_busy = sm + kLineBusy * n + u;
    float* page_busy = sm + kPageBusy * n + u;
    float* line_bytes = sm + kLineBytes * n + u;
    float* page_bytes = sm + kPageBytes * n + u;
    float* line_rate = sm + kLineRate * n + u;
    float* page_rate = sm + kPageRate * n + u;
    const float line_share = ratio;
    const float page_share = fsub(1.0f, ratio);
    // bandwidth.occupy_busy, line then page channel
    const float line_done = fadd(
        tmax(clock, *line_busy),
        rdiv(a.line_wire, clamp_min(fmul(bw, line_share), kMinBw)));
    const float page_done = fadd(
        tmax(clock, *page_busy),
        rdiv(a.page_wire, clamp_min(fmul(bw, page_share), kMinBw)));
    if (line_gate) *line_busy = line_done;
    if (page_gate) *page_busy = page_done;
    const float line_in = line_gate ? a.line_wire : 0.0f;
    const float page_in = page_gate ? a.page_wire : 0.0f;
    *line_bytes = fadd(*line_bytes, line_in);
    *page_bytes = fadd(*page_bytes, page_in);
    *line_rate = fadd(fmul(*line_rate, a.ema_keep), fmul(line_in, a.ema_alpha));
    *page_rate = fadd(fmul(*page_rate, a.ema_keep), fmul(page_in, a.ema_alpha));
    return {line_done, page_done};
}

// bandwidth.adapt_ratio through fabric.adapt_ratio_at on module `mc`
__device__ float adapt(const float* mem, int m, int mc, float bw,
                       float clock, float line_occ, float page_occ,
                       const Args& a) {
    const float line_bl = clamp_min(fsub(mem[kLineBusy * m + mc], clock), 0.0f);
    const float page_bl = clamp_min(fsub(mem[kPageBusy * m + mc], clock), 0.0f);
    const float tau = rdiv(a.page_wire, clamp_min(bw, kMinBw));
    const float occ_t = fmul(fadd(line_occ, page_occ), tau);
    const float load_t = fadd(fadd(line_bl, page_bl), occ_t);
    const float saturation = fdiv(load_t, fadd(load_t, tau));
    const float ratio = mem[kRatio * m + mc];
    const float line_demand = mem[kLineRate * m + mc];
    const float page_demand = mem[kPageRate * m + mc];
    const float total = fadd(line_demand, page_demand);
    const float byte_prop =
        total > kMinBw ? fdiv(line_demand, clamp_min(total, kMinBw))
                       : a.r_idle;
    const float sat = clamp(saturation, 0.0f, 1.0f);
    const float target =
        fadd(fmul(sat, byte_prop), fmul(fsub(1.0f, sat), a.r_idle));
    return clamp(fadd(ratio, fmul(fsub(target, ratio), a.gain)),
                 a.ratio_min, a.ratio_max);
}

struct Scan {
    int found;      // first page entry holding the page, -1 if none
    int free_page;  // first empty page entry, -1 if none
    int free_sb;    // first empty sub-block entry, -1 if none
    int used_page;  // page entries in use
    int used_sb;    // sub-block entries in use
};

// The request's CAM scans over one sequence's rows, by warp ballots; every
// lane gets the same result.
__device__ Scan scan(const Rows& e, int32_t pid, int p, int s, int lane) {
    Scan sc{-1, -1, -1, 0, 0};
    int free_p = 0, free_s = 0;
    for (int base = 0; base < p; base += 32) {
        const int i = base + lane;
        const int32_t key = i < p ? e.page_key[i] : 0;
        const unsigned hit = __ballot_sync(kFull, i < p && key == pid);
        const unsigned empty = __ballot_sync(kFull, i < p && key < 0);
        if (sc.found < 0 && hit) sc.found = base + __ffs(hit) - 1;
        if (sc.free_page < 0 && empty) sc.free_page = base + __ffs(empty) - 1;
        free_p += __popc(empty);
    }
    for (int base = 0; base < s; base += 32) {
        const int i = base + lane;
        const unsigned empty =
            __ballot_sync(kFull, i < s && e.sb_key[i] < 0);
        if (sc.free_sb < 0 && empty) sc.free_sb = base + __ffs(empty) - 1;
        free_s += __popc(empty);
    }
    sc.used_page = p - free_p;
    sc.used_sb = s - free_s;
    return sc;
}

// Warp 0: sequence q's R requests, in order, on its rows `e`.
__device__ void walk(const Args& a, int q, const Rows& e, float* mem,
                     float* nic, int seg_mem, int seg_nic, float clock,
                     bool active, int lane) {
    const int m = a.mem.m;
    // utilization(): the count times 1/size, as torch's CUDA mean
    const float per_page = __fdiv_rn(1.0f, static_cast<float>(a.p));
    const float per_sb = __fdiv_rn(1.0f, static_cast<float>(a.s));
    for (int i = 0; i < a.r; ++i) {
        const int at = q * a.r + i;
        const int32_t pid = a.need[at];
        const Scan sc = scan(e, pid, a.p, a.s, lane);
        if (lane == 0) {
            const int32_t off = floor_mod(a.offs[at], a.lpp);
            const bool miss = a.hit[at] == 0;
            const int mc = place(pid, a);
            const float bw = bw_at(a.mem, seg_mem, mc);
            const float page_backlog =
                clamp_min(fsub(mem[kPageBusy * m + mc], clock), 0.0f);
            const float pressure =
                fdiv(page_backlog, fadd(page_backlog, a.nominal));
            // engine.select_granularity
            const float page_util = fmul(static_cast<float>(sc.used_page),
                                         per_page);
            const float sb_util = fmul(static_cast<float>(sc.used_sb), per_sb);
            const bool found = sc.found >= 0;
            const int pidx = found ? sc.found : 0;
            const bool send_page = !found && sc.free_page >= 0;
            const bool issued = found && e.page_issue[pidx] <= clock;
            const bool line_if_inflight =
                sb_util < fadd(page_util, pressure) && !issued;
            const bool selected = found ? line_if_inflight : true;
            const bool send_line =
                (a.selection ? selected : true) && sc.free_sb >= 0;
            if (a.adaptive)
                mem[kRatio * m + mc] = adapt(mem, m, mc, bw, clock, sb_util,
                                             page_util, a);
            const float ratio = mem[kRatio * m + mc];
            const float page_share = fsub(1.0f, ratio);
            const bool do_page = miss && send_page;
            const bool do_line = miss && send_line;
            const float pending = found ? e.page_arrival[pidx] : a.big;
            const Served mod = serve(mem, m, mc, bw, ratio, clock, do_line,
                                     do_page, a);
            Served done = mod;
            if (a.has_nic) {              // compute_plane.serve_dual_two_leg
                const int cu = static_cast<int>(a.cus[q]);
                const int n = a.nic.m;
                const Served leg = serve(
                    nic, n, cu, bw_at(a.nic, seg_nic, cu),
                    nic[kRatio * n + cu], clock, do_line && active,
                    do_page && active, a);
                if (active) {
                    done.line_done = tmax(mod.line_done, leg.line_done);
                    done.page_done = tmax(mod.page_done, leg.page_done);
                }
            }
            // issue = transmission start on the module channel (§4.2)
            const float page_start = fsub(
                mod.page_done,
                rdiv(a.page_wire, clamp_min(fmul(bw, page_share), kMinBw)));
            if (do_page) {                // engine.schedule_page
                const int j = sc.free_page;
                e.page_key[j] = pid;
                e.page_state[j] = kScheduled;
                e.page_arrival[j] = done.page_done;
                e.page_issue[j] = page_start;
                e.page_dirty[j] = 0;
            }
            if (do_line) {                // engine.schedule_line
                const int j = sc.free_sb;
                e.sb_key[j] = static_cast<int32_t>(
                    static_cast<uint32_t>(pid) * static_cast<uint32_t>(a.lpp)
                    + static_cast<uint32_t>(off));
                e.sb_arrival[j] = done.line_done;
            }
            float served_at = tmin(do_line ? done.line_done : a.big,
                                   tmin(do_page ? done.page_done : a.big,
                                        pending));
            if (served_at >= a.big_half) served_at = fadd(clock, a.nominal);
            a.line_sent[at] = do_line;
            a.page_sent[at] = do_page;
            a.stalls[at] =
                miss ? clamp_min(fsub(served_at, clock), 0.0f) : 0.0f;
        }
        __syncwarp();
    }
    for (int j = lane; j < m; j += 32) {
        a.seen_busy[static_cast<size_t>(q) * m + j] = mem[kPageBusy * m + j];
        a.seen_ratio[static_cast<size_t>(q) * m + j] = mem[kRatio * m + j];
    }
}

__global__ void __launch_bounds__(kThreads)
schedule_fold_kernel(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x;
    const int m = a.mem.m;
    const int c = a.has_nic ? a.nic.m : 0;
    float* mem = reinterpret_cast<float*>(smem);
    float* nic = mem + kLeaves * m;
    unsigned char* rows = smem + banks_bytes(m, c);
    const Rows buf[2] = {rows_at(rows, a.p, a.s),
                         rows_at(rows + rows_bytes(a.p, a.s), a.p, a.s)};
    for (int i = tid; i < kLeaves * m; i += kThreads)
        mem[i] = a.mem.in[i / m][i % m];
    for (int i = tid; i < kLeaves * c; i += kThreads)
        nic[i] = a.nic.in[i / c][i % c];
    if (a.b > 0) load_rows(a.in, buf[0], 0, a.p, a.s, tid, kThreads);
    __syncthreads();

    const float clock = *a.clock;
    const bool active = a.has_nic && *a.active != 0;
    const int seg_mem = segment(a.mem, clock);
    const int seg_nic = a.has_nic ? segment(a.nic, clock) : 0;
    for (int q = 0; q < a.b; ++q) {
        if (tid < 32) {
            walk(a, q, buf[q & 1], mem, nic, seg_mem, seg_nic, clock, active,
                 tid);
        } else {
            const Rows& other = buf[(q + 1) & 1];
            if (q > 0)
                store_rows(a.out, other, q - 1, a.p, a.s, tid - 32,
                           kThreads - 32);
            if (q + 1 < a.b)
                load_rows(a.in, other, q + 1, a.p, a.s, tid - 32,
                          kThreads - 32);
        }
        __syncthreads();
    }
    if (a.b > 0)
        store_rows(a.out, buf[(a.b - 1) & 1], a.b - 1, a.p, a.s, tid,
                   kThreads);
    for (int i = tid; i < kLeaves * m; i += kThreads)
        a.mem.out[i / m][i % m] = mem[i];
    for (int i = tid; i < kLeaves * c; i += kThreads)
        a.nic.out[i / c][i % c] = nic[i];
}

Bank bank_from(void* const* ptrs, int m, int k) {
    Bank bk;
    for (int l = 0; l < kLeaves; ++l)
        bk.in[l] = static_cast<const float*>(ptrs[l]);
    bk.bw = static_cast<const float*>(ptrs[kLeaves]);
    bk.sched_t = static_cast<const float*>(ptrs[kLeaves + 1]);
    bk.mult = static_cast<const float*>(ptrs[kLeaves + 2]);
    bk.health = static_cast<const float*>(ptrs[kLeaves + 3]);
    for (int l = 0; l < kLeaves; ++l)
        bk.out[l] = static_cast<float*>(ptrs[kLeaves + 4 + l]);
    bk.m = m;
    bk.k = k;
    return bk;
}

Engine engine_from(void* const* ptrs) {
    Engine e;
    e.page_key = static_cast<int32_t*>(ptrs[0]);
    e.page_state = static_cast<int8_t*>(ptrs[1]);
    e.page_arrival = static_cast<float*>(ptrs[2]);
    e.page_issue = static_cast<float*>(ptrs[3]);
    e.page_dirty = static_cast<int8_t*>(ptrs[4]);
    e.sb_key = static_cast<int32_t*>(ptrs[5]);
    e.sb_arrival = static_cast<float*>(ptrs[6]);
    return e;
}

}  // namespace

// ptrs: the engine's 7 leaves in and out, the module bank's 9 leaves and 4
// link arrays in and its 9 leaves out, the same for the NIC bank (null
// without one), then the requests, clock, units, gate and the 5 outputs.
// ints: B, R, P, S, M, K, C, K of the NIC link, lines per page, placement
// (0 interleave, 1 hash, 2 affinity), affinity block, selection, adaptive
// ratio, NIC present. floats: nominal, line wire bytes, page wire bytes,
// seed ratio, EMA alpha, 1 - alpha, controller gain, ratio bounds, BIG,
// BIG / 2.
extern "C" int schedule_fold_launch(void* const* ptrs, int n_ptrs,
                                    const int* ints, int n_ints,
                                    const float* floats, int n_floats,
                                    void* stream) {
    if (n_ptrs != kNumPtrs || n_ints != kNumInts || n_floats != kNumFloats)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    a.in = engine_from(ptrs);
    a.out = engine_from(ptrs + 7);
    a.mem = bank_from(ptrs + 14, ints[4], ints[5]);
    a.nic = bank_from(ptrs + 36, ints[6], ints[7]);
    a.need = static_cast<const int32_t*>(ptrs[58]);
    a.offs = static_cast<const int32_t*>(ptrs[59]);
    a.hit = static_cast<const uint8_t*>(ptrs[60]);
    a.clock = static_cast<const float*>(ptrs[61]);
    a.cus = static_cast<const int64_t*>(ptrs[62]);
    a.active = static_cast<const uint8_t*>(ptrs[63]);
    a.line_sent = static_cast<uint8_t*>(ptrs[64]);
    a.page_sent = static_cast<uint8_t*>(ptrs[65]);
    a.stalls = static_cast<float*>(ptrs[66]);
    a.seen_busy = static_cast<float*>(ptrs[67]);
    a.seen_ratio = static_cast<float*>(ptrs[68]);
    a.b = ints[0];
    a.r = ints[1];
    a.p = ints[2];
    a.s = ints[3];
    a.lpp = ints[8];
    a.placement = ints[9];
    a.affinity = ints[10];
    a.selection = ints[11];
    a.adaptive = ints[12];
    a.has_nic = ints[13];
    a.nominal = floats[0];
    a.line_wire = floats[1];
    a.page_wire = floats[2];
    a.r_idle = floats[3];
    a.ema_alpha = floats[4];
    a.ema_keep = floats[5];
    a.gain = floats[6];
    a.ratio_min = floats[7];
    a.ratio_max = floats[8];
    a.big = floats[9];
    a.big_half = floats[10];
    if (a.b < 0 || a.r < 0 || a.p < 1 || a.s < 1 || a.mem.m < 1 ||
        a.mem.k < 1 || a.lpp < 1 || a.affinity < 1 ||
        (a.has_nic && (a.nic.m < 1 || a.nic.k < 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int c = a.has_nic ? a.nic.m : 0;
    const size_t smem = banks_bytes(a.mem.m, c) + 2 * rows_bytes(a.p, a.s);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            schedule_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    schedule_fold_kernel<<<1, kThreads, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}
