// The fused residency transaction of the DaeMon KV store: several blocks
// per sequence.
//
// Replaces the TPU kernel repro/kernels/residency_fused.py::
// fused_residency_step (Pallas, grid = batch). Per sequence, in order:
// landing compaction, policy-scored victim choice per set, same-set
// overflow drop, dirty-victim writeback list, insert, landed-row copy
// remote -> pool, CAM probe gated by ready <= clock, pool -> output
// gather for every request, and the hit touch (age max, RRPV min, dirty
// OR). The pools are updated in place; the metadata comes back in new
// tensors.
//
// What bounds it on an H100: bytes, and the latency of the dependent
// steps between them. Per sequence the step copies all S*W slots of
// metadata (17 B each: page, age, ready, rrpv, dirty) from input to
// output, moves every landed row and every requested row (K and V, 32 KB
// each at the serving shape), and makes a few decisions over the sets it
// touches. One block per sequence would put the serving batch of 8 on 8
// of the 132 SMs, and the decisions are a chain of dependent steps, so
// the design spreads the bytes and shortens the chain:
//   * runs C blocks per sequence (2 to 32, as many as keep the grid
//     resident at 2 blocks per SM: 32 at the serving batch of 8, 4 at the
//     store benchmark's 64);
//   * splits the bytes over the blocks: ranks 1..C-1 each copy a share of
//     the sets the step does not touch straight from input to output, 16
//     bytes a thread, their loads issued before the bitmap of touched sets
//     exists, and a share of the columns of every row copy;
//   * stages only the sets the step can touch (the landed lanes' sets and
//     the requests' sets, a bitmap built from the inputs) and decides in
//     every block: the decisions are a few hundred bytes of shared memory
//     and cost less than passing them between blocks (a thread-block
//     cluster with rank 0 deciding and publishing through distributed
//     shared memory measured no faster). Rank 0 writes the decisions and
//     the touched sets out;
//   * needs no barrier between the landing stores and the gathers: a
//     request whose slot is a landing victim of this step reads its row
//     from remote[clamp(pid)], which is what the landing writes there,
//     and every other request reads a pool row this step does not write;
//     each block prefetches its rows' lines into L2 while it decides;
//   * decides per warp, not per block, where the set has at most 32
//     ways: one warp per touched set sorts its (score, way) keys once
//     with a shuffle bitonic sort (the stable argsort of the plain
//     version; a warp argmin where one lane lands there) and lands the
//     set's lanes, lane ranks come from __match_any_sync over 32-lane
//     chunks and a running count per set, and one warp probes each
//     request. Sets of more ways (the fully associative 1 x N table)
//     keep the block-wide path: each lane takes the successor of its
//     set's previous victim in (score, way) order by one block argmin;
//   * computes scores as repro.core.residency._score computes them, in
//     f32 with every product and sum rounded on its own (__fmul_rn /
//     __fadd_rn, and the build passes -fmad=false), so victim ties break
//     exactly as in the plain version;
//   * the touch resolves duplicate slots as max / min / OR, which does
//     not depend on the order of the requests.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // row vectors in flight per thread
constexpr int kMinBlocks = 2;    // resident blocks per SM the grid assumes
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRrpvMax = 3.0f;
constexpr float kRrpvInsert = 2.0f;
constexpr float kRrpvHit = 0.0f;

struct Args {
    const int32_t* page;
    const float* age;
    const float* ready;
    const uint8_t* dirty;
    const float* rrpv;
    const uint8_t* landed;
    const int32_t* landed_pages;
    const int32_t* needed;
    const uint8_t* writes;
    const float* clock;
    const uint8_t* touch_refresh;
    const float* dirty_penalty;
    const uint8_t* rrip;
    uint4* kpool;
    uint4* vpool;
    const uint4* remote_k;
    const uint4* remote_v;
    int32_t* out_page;
    float* out_age;
    float* out_ready;
    uint8_t* out_dirty;
    float* out_rrpv;
    int32_t* out_evicted;
    float* out_n_evict;
    uint8_t* out_hit;
    uint4* k_local;
    uint4* v_local;
    int sets, ways, inflight, lanes, requests, touched;
    int blocks, sets_per_cta, cols_per_cta, meta_vec;
    long long remote_rows, vecs_per_row;
};

// Shared memory of one block, carved from one dynamic buffer.
struct Smem {
    int32_t* page;      // TW staged slots (TW = touched sets * W)
    float* age;
    float* ready;
    float* rrpv;
    int* lsrc;          // remote row landed in the slot this step, or -1
    int* lane_at;       // per staged set: its landing lanes by rank
    int* pid;           // K lanes: landed page id
    int* pos;           //   staged position of the lane's set
    int* rank;          //   rank within the set, -1: dropped
    int* vslot;         //   staged victim slot (block path)
    int* prev;          //   previous lane of the same set (block path)
    int* land_src;      //   row copy: remote row, -1: no landing
    int* land_dst;      //   row copy: slot in the sequence's pool
    int* tset;          // T: touched set ids, ascending
    int* cnt;           //   landing lanes of the set
    int* last;          //   last lane of the set so far (block path)
    int* wprefix;       // per bitmap word: set bits in earlier words
    unsigned* bitmap;   // S bits: set may be touched this step
    int* rslot;         // R: staged probe slot
    int* rhit;          //    hit
    int* req_src;       //    row source: slot >= 0, -(row+1) remote
    float* redf;        // kWarps + 1 reduction scratch
    int* redi;
    int* misc;          // [0] evictions, [1] landing lanes, [2] T
    float* scal;        // clock, dirty penalty, touch refresh, rrip
    int* lp;            // P: the sequence's landed page ids
    int* needed;        // R: requested page ids
    uint8_t* landed;    // P: landed flags
    uint8_t* writes;    // R: write flags
    uint8_t* dirty;     // TW
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline int smem_layout(int sets, int ways, int inflight,
                                           int lanes, int requests,
                                           int touched, unsigned char* base,
                                           Smem* sm) {
    const int tw = touched * ways;
    const int nwords = (sets + 31) / 32;
    int off = 0;
    auto take = [&](int bytes) {
        unsigned char* p = base ? base + off : nullptr;
        off = align16(off + bytes);
        return p;
    };
    Smem s;
    s.page = reinterpret_cast<int32_t*>(take(4 * tw));
    s.age = reinterpret_cast<float*>(take(4 * tw));
    s.ready = reinterpret_cast<float*>(take(4 * tw));
    s.rrpv = reinterpret_cast<float*>(take(4 * tw));
    s.lsrc = reinterpret_cast<int*>(take(4 * tw));
    s.lane_at = reinterpret_cast<int*>(take(4 * tw));
    s.pid = reinterpret_cast<int*>(take(4 * lanes));
    s.pos = reinterpret_cast<int*>(take(4 * lanes));
    s.rank = reinterpret_cast<int*>(take(4 * lanes));
    s.vslot = reinterpret_cast<int*>(take(4 * lanes));
    s.prev = reinterpret_cast<int*>(take(4 * lanes));
    s.land_src = reinterpret_cast<int*>(take(4 * lanes));
    s.land_dst = reinterpret_cast<int*>(take(4 * lanes));
    s.tset = reinterpret_cast<int*>(take(4 * touched));
    s.cnt = reinterpret_cast<int*>(take(4 * touched));
    s.last = reinterpret_cast<int*>(take(4 * touched));
    s.wprefix = reinterpret_cast<int*>(take(4 * nwords));
    s.bitmap = reinterpret_cast<unsigned*>(take(4 * nwords));
    s.rslot = reinterpret_cast<int*>(take(4 * requests));
    s.rhit = reinterpret_cast<int*>(take(4 * requests));
    s.req_src = reinterpret_cast<int*>(take(4 * requests));
    s.redf = reinterpret_cast<float*>(take(4 * (kWarps + 1)));
    s.redi = reinterpret_cast<int*>(take(4 * (kWarps + 1)));
    s.misc = reinterpret_cast<int*>(take(4 * 4));
    s.scal = reinterpret_cast<float*>(take(4 * 4));
    s.lp = reinterpret_cast<int*>(take(4 * inflight));
    s.needed = reinterpret_cast<int*>(take(4 * requests));
    s.landed = take(inflight);
    s.writes = take(requests);
    s.dirty = take(tw);
    if (sm) *sm = s;
    return off;
}

__device__ __forceinline__ int floor_mod(int a, int m) {
    int r = a % m;
    return r < 0 ? r + m : r;
}

__device__ __forceinline__ bool key_less(float s1, int w1, float s2,
                                         int w2) {
    return s1 < s2 || (s1 == s2 && w1 < w2);
}

__device__ __forceinline__ unsigned lanemask_lt() {
    return (1u << (threadIdx.x & 31)) - 1u;
}

// Block-wide reductions. Every thread of the block must call them; the
// result is returned to all threads. `red` is shared scratch of kWarps+1.
__device__ float block_min(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1)
        v = fminf(v, __shfl_xor_sync(kFull, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = red[0];
        for (int i = 1; i < kWarps; ++i) m = fminf(m, red[i]);
        red[kWarps] = m;
    }
    __syncthreads();
    return red[kWarps];
}

__device__ float block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = red[0];
        for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
        red[kWarps] = m;
    }
    __syncthreads();
    return red[kWarps];
}

// Lexicographic (score, way) argmin; way INT_MAX means "no candidate".
__device__ int block_argmin(float s, int w, float* reds, int* redw) {
    for (int o = 16; o > 0; o >>= 1) {
        float s2 = __shfl_xor_sync(kFull, s, o);
        int w2 = __shfl_xor_sync(kFull, w, o);
        if (key_less(s2, w2, s, w)) { s = s2; w = w2; }
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        reds[threadIdx.x >> 5] = s;
        redw[threadIdx.x >> 5] = w;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float bs = reds[0];
        int bw = redw[0];
        for (int i = 1; i < kWarps; ++i)
            if (key_less(reds[i], redw[i], bs, bw)) { bs = reds[i]; bw = redw[i]; }
        redw[kWarps] = bw;
    }
    __syncthreads();
    return redw[kWarps];
}

// Exclusive prefix sum of x over the block; *total gets the block sum.
__device__ int block_exclusive_scan(int x, int* red, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
    }
    __syncthreads();
    if (lane == 31) red[warp] = incl;
    __syncthreads();
    if (threadIdx.x == 0) {
        int run = 0;
        for (int i = 0; i < kWarps; ++i) {
            int t = red[i];
            red[i] = run;
            run += t;
        }
        red[kWarps] = run;
    }
    __syncthreads();
    int out = red[warp] + incl - x;
    *total = red[kWarps];
    return out;
}

// Ascending (score, way) bitonic sort of one key per lane across a warp.
__device__ __forceinline__ void warp_sort(float& s, int& w) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            const float os = __shfl_xor_sync(kFull, s, j);
            const int ow = __shfl_xor_sync(kFull, w, j);
            const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
            const bool other_less = key_less(os, ow, s, w);
            if (keep_min == other_less) { s = os; w = ow; }
        }
    }
}

// Eviction score of staged slot i: repro.core.residency._score, op for op.
__device__ __forceinline__ float slot_score(int i, float amin, float span,
                                            float dpen, bool rrip,
                                            const Smem& m) {
    const float a = m.age[i];
    if (rrip)
        return __fadd_rn(__fmul_rn(__fsub_rn(kRrpvMax, m.rrpv[i]), span),
                         __fsub_rn(a, amin));
    return __fadd_rn(a, m.dirty[i] ? __fmul_rn(dpen, span) : 0.0f);
}

// Staged position of set s (its bit must be set): earlier set bits.
__device__ __forceinline__ int set_pos(const Smem& m, int s) {
    return m.wprefix[s >> 5]
        + __popc(m.bitmap[s >> 5] & ((1u << (s & 31)) - 1u));
}

// Every block: stage the sequence's small inputs (one trip to memory),
// then mark the sets this step may touch — the sets of all landed
// in-flight slots and of all requests.
__device__ void load_inputs(const Args& a, const Smem& m, int b) {
    const int S = a.sets, P = a.inflight, R = a.requests;
    const int nwords = (S + 31) / 32;
    for (int i = threadIdx.x; i < P; i += kThreads) {
        m.landed[i] = a.landed[(long long)b * P + i];
        m.lp[i] = a.landed_pages[(long long)b * P + i];
    }
    for (int r = threadIdx.x; r < R; r += kThreads) {
        m.needed[r] = a.needed[(long long)b * R + r];
        m.writes[r] = a.writes[(long long)b * R + r];
    }
    if (threadIdx.x == 0) {
        m.scal[0] = *a.clock;
        m.scal[1] = *a.dirty_penalty;
        m.scal[2] = *a.touch_refresh != 0 ? 1.0f : 0.0f;
        m.scal[3] = *a.rrip != 0 ? 1.0f : 0.0f;
    }
    for (int i = threadIdx.x; i < nwords; i += kThreads) m.bitmap[i] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < P + R; i += kThreads) {
        int s = -1;
        if (i < P) {
            if (m.landed[i]) s = floor_mod(max(m.lp[i], 0), S);
        } else {
            s = floor_mod(m.needed[i - P], S);
        }
        if (s >= 0) atomicOr(&m.bitmap[s >> 5], 1u << (s & 31));
    }
    __syncthreads();
}

// Ranks 1..C-1 copy the metadata of their share of the sets that the
// step does not touch, input -> output, without shared memory: 16 bytes
// a thread where the geometry allows it (meta_vec bit 0: the 4-byte
// arrays, bit 1: dirty), else one slot a thread. The first vectors of
// each thread are loaded before the bitmap exists (`meta_preload`), so
// that trip to memory overlaps the inputs' trip; their stores wait for it.
struct MetaCopy {
    long long base, e0, e1;     // the sequence's first slot; the range
    int ways;
    bool vec4, vec16;
    uint4 x[2][4];              // preloaded page/age/ready/rrpv vectors
    uint4 d;                    // preloaded dirty vector
    bool have[2], have_d;
};

__device__ __forceinline__ void meta_load(const Args& a, long long v,
                                          uint4 (&x)[4]) {
    x[0] = __ldg(reinterpret_cast<const uint4*>(a.page) + v);
    x[1] = __ldg(reinterpret_cast<const uint4*>(a.age) + v);
    x[2] = __ldg(reinterpret_cast<const uint4*>(a.ready) + v);
    x[3] = __ldg(reinterpret_cast<const uint4*>(a.rrpv) + v);
}

__device__ __forceinline__ void meta_store(const Args& a, long long v,
                                           const uint4 (&x)[4]) {
    reinterpret_cast<uint4*>(a.out_page)[v] = x[0];
    reinterpret_cast<uint4*>(a.out_age)[v] = x[1];
    reinterpret_cast<uint4*>(a.out_ready)[v] = x[2];
    reinterpret_cast<uint4*>(a.out_rrpv)[v] = x[3];
}

__device__ __forceinline__ bool untouched(const Smem& m, const MetaCopy& c,
                                         long long e) {
    const int s = static_cast<int>(e - c.base) / c.ways;
    return ((m.bitmap[s >> 5] >> (s & 31)) & 1u) == 0u;
}

__device__ void meta_preload(const Args& a, int b, int rank, MetaCopy& c) {
    const int W = a.ways;
    const int s0 = (rank - 1) * a.sets_per_cta;
    const int s1 = max(s0, min(a.sets, s0 + a.sets_per_cta));
    c.ways = W;
    c.base = static_cast<long long>(b) * a.sets * W;
    c.e0 = c.base + static_cast<long long>(s0) * W;
    c.e1 = c.base + static_cast<long long>(s1) * W;
    c.vec4 = (a.meta_vec & 1) != 0;
    c.vec16 = (a.meta_vec & 2) != 0;
    const long long v = c.e0 / 4 + threadIdx.x;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        c.have[u] = c.vec4 && v + u * kThreads < c.e1 / 4;
        if (c.have[u]) meta_load(a, v + u * kThreads, c.x[u]);
    }
    const long long vd = c.e0 / 16 + threadIdx.x;
    c.have_d = c.vec16 && vd < c.e1 / 16;
    if (c.have_d) c.d = __ldg(reinterpret_cast<const uint4*>(a.dirty) + vd);
}

__device__ void copy_untouched(const Args& a, const Smem& m,
                               const MetaCopy& c) {
    const long long v0 = c.e0 / 4 + threadIdx.x;
    if (c.vec4) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (c.have[u] && untouched(m, c, 4 * (v0 + u * kThreads)))
                meta_store(a, v0 + u * kThreads, c.x[u]);
        for (long long v = v0 + 2 * kThreads; v < c.e1 / 4;
             v += 2 * kThreads) {
            uint4 x[2][4];
            bool take[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const long long vv = v + u * kThreads;
                take[u] = vv < c.e1 / 4 && untouched(m, c, 4 * vv);
                if (take[u]) meta_load(a, vv, x[u]);
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
                if (take[u]) meta_store(a, v + u * kThreads, x[u]);
        }
    } else {
        for (long long e = c.e0 + threadIdx.x; e < c.e1; e += kThreads) {
            if (!untouched(m, c, e)) continue;
            a.out_page[e] = a.page[e];
            a.out_age[e] = a.age[e];
            a.out_ready[e] = a.ready[e];
            a.out_rrpv[e] = a.rrpv[e];
        }
    }
    if (c.vec16) {
        const long long vd = c.e0 / 16 + threadIdx.x;
        const uint4* src = reinterpret_cast<const uint4*>(a.dirty);
        uint4* dst = reinterpret_cast<uint4*>(a.out_dirty);
        if (c.have_d && untouched(m, c, 16 * vd)) dst[vd] = c.d;
        for (long long v = vd + kThreads; v < c.e1 / 16; v += kThreads)
            if (untouched(m, c, 16 * v)) dst[v] = __ldg(src + v);
    } else {
        for (long long e = c.e0 + threadIdx.x; e < c.e1; e += kThreads)
            if (untouched(m, c, e)) a.out_dirty[e] = a.dirty[e] ? 1 : 0;
    }
}

// Ranks 1..C-1, once the touched sets are staged and the lanes ranked:
// pull their column share of the rows this step will likely copy into
// L2 while the victims and the probe are decided — every landing lane's
// remote rows, and each request's pool row where the pre-step table holds
// its page (else its set's way 0); a landing may change the slot a
// request reads, so these are hints only. One prefetch per 128-byte
// line, issued by the SM that will copy the line, so that its address
// translation is warm as well.
__device__ __forceinline__ void prefetch_line(const uint4* p) {
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

__device__ void prefetch_rows(const Args& a, const Smem& m, int b,
                              int rank, int n_do) {
    const long long vpr = a.vecs_per_row;
    const long long c0 = static_cast<long long>(rank - 1) * a.cols_per_cta;
    const long long c1 = min(vpr, c0 + a.cols_per_cta);
    if (c0 >= c1) return;
    const int lines = static_cast<int>((c1 - c0 + 7) / 8);   // 8 vectors
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = threadIdx.x; i < n_do * lines; i += kThreads) {
        const int j = i / lines;
        const long long pg = m.pid[j];
        const long long r = pg < 0 ? 0
            : (pg >= a.remote_rows ? a.remote_rows - 1 : pg);
        const long long v = r * vpr + c0 + 8 * (i - j * lines);
        prefetch_line(a.remote_k + v);
        prefetch_line(a.remote_v + v);
    }
    const int S = a.sets, W = a.ways;
    const long long mb = static_cast<long long>(b) * S * W;
    for (int r = warp; r < a.requests; r += kWarps) {
        const int pg = m.needed[r];
        const int t = set_pos(m, floor_mod(pg, S));
        int way = 0;
        for (int w0 = 0; w0 < W; w0 += 32) {
            const int w = w0 + lane;
            const unsigned hitm = __ballot_sync(
                kFull, w < W && m.page[t * W + w] == pg);
            if (hitm) { way = w0 + __ffs(hitm) - 1; break; }
        }
        const long long slot = mb + static_cast<long long>(m.tset[t]) * W
            + way;
        for (int l = lane; l < lines; l += 32) {
            prefetch_line(a.kpool + slot * vpr + c0 + 8 * l);
            prefetch_line(a.vpool + slot * vpr + c0 + 8 * l);
        }
    }
}

// The insert of lane j into staged slot v of touched set t: the
// writeback entry (written out by rank 0 alone), the eviction count, the
// new metadata and the row copy it takes. Victims are distinct slots, so
// a lane reads its victim and overwrites it with no barrier between
// lanes.
__device__ __forceinline__ void land(const Args& a, const Smem& m, int b,
                                     int j, int v, int t, float clock,
                                     bool writer) {
    int ev = -1;
    const int vp = m.page[v];
    if (vp >= 0) {
        atomicAdd(&m.misc[0], 1);
        if (m.dirty[v]) ev = vp;
    }
    const int pg = m.pid[j];
    m.page[v] = pg;
    m.age[v] = clock;
    m.ready[v] = clock;
    m.dirty[v] = 0;
    m.rrpv[v] = kRrpvInsert;
    const long long r = pg < 0 ? 0
        : (pg >= a.remote_rows ? a.remote_rows - 1 : pg);
    m.lsrc[v] = static_cast<int>(r);
    if (writer) a.out_evicted[static_cast<long long>(b) * a.lanes + j] = ev;
    m.land_src[j] = static_cast<int>(r);
    m.land_dst[j] = m.tset[t] * a.ways + (v - t * a.ways);
}

// Every block: stage the touched sets, decide the landings and the
// probes, and leave every decision and the row copies in shared memory;
// rank 0 also writes the decisions out.
__device__ void decide(const Args& a, const Smem& m, int b, int rank) {
    const bool writer = rank == 0;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int S = a.sets, W = a.ways, P = a.inflight, K = a.lanes;
    const int R = a.requests;
    const int nwords = (S + 31) / 32;
    const float clock = m.scal[0];
    const float dpen = m.scal[1];
    const bool rrip = m.scal[3] != 0.0f;

    // ---- touched sets: ascending list from the bitmap
    for (int t = tid; t < a.touched; t += kThreads) {
        m.cnt[t] = 0;
        m.last[t] = -1;
    }
    if (tid == 0) m.misc[0] = 0;
    if (nwords <= 32) {                 // one warp scans and lists
        if (warp == 0) {
            unsigned bits = lane < nwords ? m.bitmap[lane] : 0u;
            const int c = __popc(bits);
            int incl = c;
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += y;
            }
            int at = incl - c;
            if (lane < nwords) m.wprefix[lane] = at;
            while (bits) {
                const int bit = __ffs(bits) - 1;
                bits &= bits - 1u;
                m.tset[at++] = lane * 32 + bit;
            }
            if (lane == 31) m.misc[2] = incl;
        }
    } else {
        int n = 0;
        for (int base = 0; base < nwords; base += kThreads) {
            const int i = base + tid;
            const int c = i < nwords ? __popc(m.bitmap[i]) : 0;
            int chunk = 0;
            const int ex = block_exclusive_scan(c, m.redi, &chunk);
            if (i < nwords) m.wprefix[i] = n + ex;
            n += chunk;
        }
        __syncthreads();
        for (int i = tid; i < nwords; i += kThreads) {
            unsigned bits = m.bitmap[i];
            int at = m.wprefix[i];
            while (bits) {
                const int bit = __ffs(bits) - 1;
                bits &= bits - 1u;
                m.tset[at++] = i * 32 + bit;
            }
        }
        if (tid == 0) m.misc[2] = n;
    }
    __syncthreads();
    const int n_t = m.misc[2];

    // ---- stage the touched sets' metadata: the first two slots of each
    // thread are loaded now and stored after the compaction and the ranks,
    // which need only the inputs, so the trip to memory overlaps them
    const long long mb = static_cast<long long>(b) * S * W;
    const int tw = n_t * W;
    int32_t pg[2];
    float ag[2], rd[2], rr[2];
    uint8_t dt[2];
    auto stage_load = [&](int e, int u) {
        const int t = e / W;
        const long long g = mb + static_cast<long long>(m.tset[t]) * W
            + (e - t * W);
        pg[u] = a.page[g];
        ag[u] = a.age[g];
        rd[u] = a.ready[g];
        rr[u] = a.rrpv[g];
        dt[u] = a.dirty[g];
    };
    auto stage_store = [&](int e, int u) {
        m.page[e] = pg[u];
        m.age[e] = ag[u];
        m.ready[e] = rd[u];
        m.rrpv[e] = rr[u];
        m.dirty[e] = dt[u] ? 1 : 0;
        m.lsrc[e] = -1;
    };
#pragma unroll
    for (int u = 0; u < 2; ++u)
        if (tid + u * kThreads < tw) stage_load(tid + u * kThreads, u);

    // ---- landing compaction: lane j <- the j-th landed in-flight slot,
    // by warp ballots and a sum over the warps' counts
    int n_landed = 0;
    for (int base = 0; base < P; base += kThreads) {
        const int i = base + tid;
        const bool flag = i < P && m.landed[i];
        const unsigned bal = __ballot_sync(kFull, flag);
        if (lane == 0) m.redi[warp] = __popc(bal);
        __syncthreads();
        int before = 0, chunk = 0;
        for (int w = 0; w < kWarps; ++w) {
            const int c = m.redi[w];
            before += w < warp ? c : 0;
            chunk += c;
        }
        const int j = n_landed + before + __popc(bal & lanemask_lt());
        if (flag && j < K) m.pid[j] = m.lp[i];
        n_landed += chunk;
        __syncthreads();
    }
    const int n_do = min(n_landed, K);

    // ---- lane ranks within their sets, by one warp over 32-lane chunks:
    // __match_any_sync groups a chunk's lanes by set, a running count per
    // set carries the rank across chunks. Lane j of rank r < W is listed
    // at lane_at[t * W + r]; a lane past W (overflow) lands nowhere.
    if (warp == 0) {
        for (int base = 0; base < n_do; base += 32) {
            const int j = base + lane;
            const bool active = j < n_do;
            const int p = active ? set_pos(m, floor_mod(max(m.pid[j], 0), S))
                                 : -1;
            const unsigned grp = __match_any_sync(kFull, p);
            const unsigned below = grp & lanemask_lt();
            int rk = 0, prev = -1;
            if (active) {
                rk = m.cnt[p] + __popc(below);
                prev = below ? base + 31 - __clz(below) : m.last[p];
            }
            __syncwarp();
            if (active && below == 0) {
                m.cnt[p] += __popc(grp);
                m.last[p] = base + 31 - __clz(grp);
            }
            __syncwarp();
            if (active) {
                m.pos[j] = p;
                m.rank[j] = rk < W ? rk : -1;
                m.prev[j] = prev;
                if (rk < W) {
                    m.lane_at[p * W + rk] = j;
                } else {
                    m.land_src[j] = -1;
                    if (writer)
                        a.out_evicted[static_cast<long long>(b) * K + j] = -1;
                }
            }
        }
    }
    for (int j = n_do + tid; writer && j < K; j += kThreads)
        a.out_evicted[static_cast<long long>(b) * K + j] = -1;
#pragma unroll
    for (int u = 0; u < 2; ++u)
        if (tid + u * kThreads < tw) stage_store(tid + u * kThreads, u);
    for (int e = tid + 2 * kThreads; e < tw; e += kThreads) {
        stage_load(e, 0);
        stage_store(e, 0);
    }
    __syncthreads();
    if (!writer) prefetch_rows(a, m, b, rank, n_do);

    // ---- victims and the inserts
    if (W <= 32) {
        // one warp per touched set with landings sorts its (score, way)
        // keys once (a warp argmin where one lane lands there); its lane
        // r then lands the set's rank-r lane in the r-th way
        for (int t = warp; t < n_t; t += kWarps) {
            const int cnt = m.cnt[t];
            if (cnt == 0) continue;                      // warp-uniform
            const int e = t * W + lane;
            const bool valid = lane < W;
            float lo = valid ? m.age[e] : INFINITY;
            float hi = valid ? m.age[e] : -INFINITY;
            for (int o = 16; o > 0; o >>= 1) {
                lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
                hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
            }
            const float span = __fadd_rn(__fsub_rn(hi, lo), 1.0f);
            float sc = valid ? slot_score(e, lo, span, dpen, rrip, m)
                             : INFINITY;
            int way = valid ? lane : 32 + lane;
            if (cnt == 1) {
                for (int o = 16; o > 0; o >>= 1) {
                    const float os = __shfl_xor_sync(kFull, sc, o);
                    const int ow = __shfl_xor_sync(kFull, way, o);
                    if (key_less(os, ow, sc, way)) { sc = os; way = ow; }
                }
            } else {
                warp_sort(sc, way);
            }
            if (lane < min(cnt, W))
                land(a, m, b, m.lane_at[t * W + lane], t * W + way, t, clock,
                     writer);
        }
    } else {
        // block-wide: lane j takes the successor of its set's previous
        // victim in (score, way) order — the rank-j way of the stable order
        for (int j = 0; j < n_do; ++j) {
            if (m.rank[j] < 0) continue;                // uniform: shared
            const int row = m.pos[j] * W;
            float lo = INFINITY, hi = -INFINITY;
            for (int w = tid; w < W; w += kThreads) {
                lo = fminf(lo, m.age[row + w]);
                hi = fmaxf(hi, m.age[row + w]);
            }
            const float amin = block_min(lo, m.redf);
            const float amax = block_max(hi, m.redf);
            const float span = __fadd_rn(__fsub_rn(amax, amin), 1.0f);
            const int prev = m.prev[j];
            const int pw = prev >= 0 ? m.vslot[prev] - row : -1;
            const float ps = prev >= 0
                ? slot_score(row + pw, amin, span, dpen, rrip, m) : 0.0f;
            float best_s = INFINITY;
            int best_w = INT_MAX;
            for (int w = tid; w < W; w += kThreads) {
                const float sc = slot_score(row + w, amin, span, dpen, rrip,
                                            m);
                if ((prev < 0 || key_less(ps, pw, sc, w))
                    && key_less(sc, w, best_s, best_w)) {
                    best_s = sc;
                    best_w = w;
                }
            }
            const int vw = block_argmin(best_s, best_w, m.redf, m.redi);
            if (tid == 0) m.vslot[j] = row + vw;
            __syncthreads();
        }
        // all victims are chosen from the pre-step scores; then insert
        for (int j = tid; j < n_do; j += kThreads)
            if (m.rank[j] >= 0)
                land(a, m, b, j, m.vslot[j], m.pos[j], clock, writer);
    }
    __syncthreads();

    // ---- CAM probe of every request within its set (post-insert): one
    // warp per request, the first matching way
    for (int r = warp; r < R; r += kWarps) {
        const int pg = m.needed[r];
        const int t = set_pos(m, floor_mod(pg, S));
        const int row = t * W;
        int way = W;
        for (int w0 = 0; w0 < W; w0 += 32) {
            const int w = w0 + lane;
            const unsigned hitm = __ballot_sync(kFull,
                                                w < W && m.page[row + w] == pg);
            if (hitm) { way = w0 + __ffs(hitm) - 1; break; }
        }
        if (lane == 0) {
            const bool present = way < W;
            const int slot = row + (present ? way : 0);
            const bool hit = present && m.ready[slot] <= clock;
            m.rslot[r] = slot;
            m.rhit[r] = hit ? 1 : 0;
            if (writer) a.out_hit[(long long)b * R + r] = hit ? 1 : 0;
            const int l = m.lsrc[slot];
            m.req_src[r] = l >= 0 ? -(l + 1) : m.tset[t] * W + (slot - row);
        }
    }
    if (tid == 0) {
        m.misc[1] = n_do;
        if (writer) a.out_n_evict[b] = static_cast<float>(m.misc[0]);
    }
    __syncthreads();
}

// Rank 0, once decided: the touch, then the staged sets written out.
__device__ void finish(const Args& a, const Smem& m, int b) {
    const int W = a.ways, R = a.requests;
    const float clock = m.scal[0];
    const bool touch_refresh = m.scal[2] != 0.0f;
    if (threadIdx.x == 0) {
        // duplicates resolve as max / min / OR
        for (int r = 0; r < R; ++r) {
            const int slot = m.rslot[r];
            const bool hit = m.rhit[r] != 0;
            const float age_val = (hit && touch_refresh) ? clock : 0.0f;
            const float rr_val = hit ? kRrpvHit : kRrpvMax;
            if (age_val > m.age[slot]) m.age[slot] = age_val;
            if (rr_val < m.rrpv[slot]) m.rrpv[slot] = rr_val;
            if (hit && m.writes[r]) m.dirty[slot] = 1;
        }
    }
    __syncthreads();
    const long long mb = static_cast<long long>(b) * a.sets * W;
    const int tw = m.misc[2] * W;
    for (int e = threadIdx.x; e < tw; e += kThreads) {
        const int t = e / W;
        const long long g = mb + static_cast<long long>(m.tset[t]) * W
            + (e - t * W);
        a.out_page[g] = m.page[e];
        a.out_age[g] = m.age[e];
        a.out_ready[g] = m.ready[e];
        a.out_rrpv[g] = m.rrpv[e];
        a.out_dirty[g] = m.dirty[e];
    }
}

// Ranks 1..C-1: their column share of every row copy — each
// request's row -> k_local / v_local, then the landings remote -> pool.
__device__ void copy_rows(const Args& a, const Smem& m, int b, int rank) {
    const long long vpr = a.vecs_per_row;
    const long long c0 = static_cast<long long>(rank - 1) * a.cols_per_cta;
    const long long c1 = min(vpr, c0 + a.cols_per_cta);
    if (c0 >= c1) return;
    const int ncols = static_cast<int>(c1 - c0);
    const int n_land = m.misc[1];
    const int R = a.requests;
    const long long pool0 = static_cast<long long>(b) * a.sets * a.ways;
    const long long out0 = static_cast<long long>(b) * R;
    const int total = (R + n_land) * ncols;
    for (int g = threadIdx.x; g < total; g += kThreads * kUnroll) {
        uint4 xk[kUnroll], xv[kUnroll];
        long long dst[kUnroll];
        bool to_pool[kUnroll], take[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int gg = g + u * kThreads;
            take[u] = gg < total;
            if (!take[u]) continue;
            const int item = gg / ncols;
            const int col = gg - item * ncols;
            const long long c = c0 + col;
            if (item < R) {
                const int x = m.req_src[item];
                if (x >= 0) {
                    const long long s = (pool0 + x) * vpr + c;
                    xk[u] = a.kpool[s];
                    xv[u] = a.vpool[s];
                } else {
                    const long long s = static_cast<long long>(-(x + 1)) * vpr
                        + c;
                    xk[u] = __ldg(a.remote_k + s);
                    xv[u] = __ldg(a.remote_v + s);
                }
                dst[u] = (out0 + item) * vpr + c;
                to_pool[u] = false;
            } else {
                const int src = m.land_src[item - R];
                take[u] = src >= 0;
                if (!take[u]) continue;
                xk[u] = __ldg(a.remote_k + src * vpr + c);
                xv[u] = __ldg(a.remote_v + src * vpr + c);
                dst[u] = (pool0 + m.land_dst[item - R]) * vpr + c;
                to_pool[u] = true;
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (!take[u]) continue;
            if (to_pool[u]) {
                a.kpool[dst[u]] = xk[u];
                a.vpool[dst[u]] = xv[u];
            } else {
                a.k_local[dst[u]] = xk[u];
                a.v_local[dst[u]] = xv[u];
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
residency_fused_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Smem m;
    smem_layout(a.sets, a.ways, a.inflight, a.lanes, a.requests, a.touched,
                smem, &m);
    const int rank = blockIdx.x % a.blocks;
    const int b = blockIdx.x / a.blocks;
    if (rank == 0) {
        load_inputs(a, m, b);
        decide(a, m, b, rank);
        finish(a, m, b);
    } else {
        MetaCopy c;
        meta_preload(a, b, rank, c);
        load_inputs(a, m, b);
        copy_untouched(a, m, c);
        decide(a, m, b, rank);
        copy_rows(a, m, b, rank);
    }
}

}  // namespace

extern "C" int residency_fused_smem_bytes(int sets, int ways, int inflight,
                                          int lanes, int requests,
                                          int touched) {
    return smem_layout(sets, ways, inflight, lanes, requests, touched,
                       nullptr, nullptr);
}

extern "C" int residency_fused_launch(
    const void* page, const void* age, const void* ready, const void* dirty,
    const void* rrpv, const void* landed, const void* landed_pages,
    const void* needed, const void* writes, const void* clock,
    const void* touch_refresh, const void* dirty_penalty, const void* rrip,
    void* kpool, void* vpool, const void* remote_k, const void* remote_v,
    void* out_page, void* out_age, void* out_ready, void* out_dirty,
    void* out_rrpv, void* out_evicted, void* out_n_evict, void* out_hit,
    void* k_local, void* v_local, int batch, int sets, int ways,
    int inflight, int lanes, int requests, int touched, int blocks,
    int sets_per_cta, int cols_per_cta, long long remote_rows,
    long long row_bytes, void* stream) {
    Args a;
    a.page = static_cast<const int32_t*>(page);
    a.age = static_cast<const float*>(age);
    a.ready = static_cast<const float*>(ready);
    a.dirty = static_cast<const uint8_t*>(dirty);
    a.rrpv = static_cast<const float*>(rrpv);
    a.landed = static_cast<const uint8_t*>(landed);
    a.landed_pages = static_cast<const int32_t*>(landed_pages);
    a.needed = static_cast<const int32_t*>(needed);
    a.writes = static_cast<const uint8_t*>(writes);
    a.clock = static_cast<const float*>(clock);
    a.touch_refresh = static_cast<const uint8_t*>(touch_refresh);
    a.dirty_penalty = static_cast<const float*>(dirty_penalty);
    a.rrip = static_cast<const uint8_t*>(rrip);
    a.kpool = static_cast<uint4*>(kpool);
    a.vpool = static_cast<uint4*>(vpool);
    a.remote_k = static_cast<const uint4*>(remote_k);
    a.remote_v = static_cast<const uint4*>(remote_v);
    a.out_page = static_cast<int32_t*>(out_page);
    a.out_age = static_cast<float*>(out_age);
    a.out_ready = static_cast<float*>(out_ready);
    a.out_dirty = static_cast<uint8_t*>(out_dirty);
    a.out_rrpv = static_cast<float*>(out_rrpv);
    a.out_evicted = static_cast<int32_t*>(out_evicted);
    a.out_n_evict = static_cast<float*>(out_n_evict);
    a.out_hit = static_cast<uint8_t*>(out_hit);
    a.k_local = static_cast<uint4*>(k_local);
    a.v_local = static_cast<uint4*>(v_local);
    a.sets = sets;
    a.ways = ways;
    a.inflight = inflight;
    a.lanes = lanes;
    a.requests = requests;
    a.touched = touched;
    a.blocks = blocks;
    a.sets_per_cta = sets_per_cta;
    a.cols_per_cta = cols_per_cta;
    a.remote_rows = remote_rows;
    a.vecs_per_row = row_bytes / 16;
    auto aligned = [](const void* p) {
        return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
    };
    a.meta_vec = 0;
    if (ways % 4 == 0 && aligned(page) && aligned(age) && aligned(ready)
        && aligned(rrpv) && aligned(out_page) && aligned(out_age)
        && aligned(out_ready) && aligned(out_rrpv))
        a.meta_vec |= 1;
    if (ways % 16 == 0 && aligned(dirty) && aligned(out_dirty))
        a.meta_vec |= 2;
    const int smem = residency_fused_smem_bytes(sets, ways, inflight, lanes,
                                                requests, touched);
    // raise the kernel's shared memory limit once per new maximum
    static int smem_allowed = 48 * 1024;
    if (smem > smem_allowed) {
        cudaError_t err = cudaFuncSetAttribute(
            residency_fused_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_allowed = smem;
    }
    if (batch > 0) {
        residency_fused_kernel<<<batch * blocks, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
