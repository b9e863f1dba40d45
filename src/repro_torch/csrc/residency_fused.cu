// The fused residency transaction of the DaeMon KV store, one CTA per
// sequence.
//
// Replaces the TPU kernel repro/kernels/residency_fused.py::
// fused_residency_step (Pallas, grid = batch). Per sequence, in order:
// landing compaction, policy-scored victim choice per set, same-set
// overflow drop, dirty-victim writeback list, insert, landed-row copy
// remote -> pool, CAM probe gated by ready <= clock, pool -> output
// gather for every request, and the hit touch (age max, RRPV min, dirty
// OR). The pools are updated in place.
//
// What bounds it on an H100: bytes. The metadata work is a few passes
// over the sequence's S*W slots in shared memory, while every landed page
// and every request moves a whole (page, KV, D) row (32 KB at the serving
// shape) through device memory. The design:
//   * the sequence's (S, W) metadata (page, age, ready, rrpv, dirty: 17 B
//     per slot) is staged once in dynamic shared memory and written back
//     once; above 48 KB the launcher raises the block's limit;
//   * the landing compaction is a block prefix sum over the P in-flight
//     slots;
//   * victims are chosen without sorting and without the Pallas kernel's
//     one-hot (k, S, W) / (S, W, W) tensors: a landing lane needs only
//     the rank-r victim of its own set, which is the successor, in
//     (score, way) order, of the victim of the previous lane in that set,
//     so each lane costs one block-wide argmin over its set's W ways
//     (ties to the lower way, as the reference's stable argsort);
//   * scores are computed as repro.core.residency._score computes them,
//     in f32 with every product and sum rounded on its own
//     (__fmul_rn/__fadd_rn, and the build passes -fmad=false), so victim
//     ties break exactly as in the plain version;
//   * row copies (landing and gather) use all threads with 16-byte
//     vectors; a barrier separates the landing stores from the gathers;
//   * the touch resolves duplicate slots as max/min/OR with one thread
//     walking the R requests, which is deterministic and R is small.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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
    const float* params;        // clock, touch_refresh, dirty_penalty, rrip
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
    int sets, ways, inflight, lanes, requests;
    long long remote_rows, vecs_per_row;
};

__device__ __forceinline__ int floor_mod(int a, int m) {
    int r = a % m;
    return r < 0 ? r + m : r;
}

__device__ __forceinline__ bool key_less(float s1, int w1, float s2,
                                         int w2) {
    return s1 < s2 || (s1 == s2 && w1 < w2);
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

__device__ int block_min_int(int v, int* red) {
    for (int o = 16; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(kFull, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        int m = red[0];
        for (int i = 1; i < kWarps; ++i) m = min(m, red[i]);
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

// Eviction score of slot i: repro.core.residency._score, op for op.
__device__ __forceinline__ float slot_score(int i, float amin, float span,
                                            float dpen, bool rrip,
                                            const float* age,
                                            const uint8_t* dirty,
                                            const float* rrpv) {
    const float a = age[i];
    if (rrip)
        return __fadd_rn(__fmul_rn(__fsub_rn(kRrpvMax, rrpv[i]), span),
                         __fsub_rn(a, amin));
    return __fadd_rn(a, dirty[i] ? __fmul_rn(dpen, span) : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
residency_fused_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int S = a.sets, W = a.ways, N = S * W;
    const int P = a.inflight, K = a.lanes, R = a.requests;
    const long long vpr = a.vecs_per_row;

    int32_t* s_page = reinterpret_cast<int32_t*>(smem);
    float* s_age = reinterpret_cast<float*>(s_page + N);
    float* s_ready = s_age + N;
    float* s_rrpv = s_ready + N;
    int* s_pid = reinterpret_cast<int*>(s_rrpv + N);  // K lanes
    int* s_vway = s_pid + K;                          // victim way
    int* s_rank = s_vway + K;                         // -1: dropped
    int* s_prev = s_rank + K;                         // prev same-set lane
    int* s_slot = s_prev + K;                         // R probe slots
    int* s_hit = s_slot + R;                          // R hits
    float* s_redf = reinterpret_cast<float*>(s_hit + R);  // kWarps + 1
    int* s_redi = reinterpret_cast<int*>(s_redf + 32);    // kWarps + 1
    int* s_misc = s_redi + 32;                        // [0] evictions
    uint8_t* s_dirty = reinterpret_cast<uint8_t*>(s_misc + 4);  // N

    const float clock = a.params[0];
    const bool touch_refresh = a.params[1] > 0.5f;
    const float dpen = a.params[2];
    const bool rrip = a.params[3] > 0.5f;

    // ---- stage the sequence's metadata
    const long long mb = static_cast<long long>(b) * N;
    for (int i = tid; i < N; i += kThreads) {
        s_page[i] = a.page[mb + i];
        s_age[i] = a.age[mb + i];
        s_ready[i] = a.ready[mb + i];
        s_rrpv[i] = a.rrpv[mb + i];
        s_dirty[i] = a.dirty[mb + i] ? 1 : 0;
    }
    if (tid == 0) s_misc[0] = 0;

    // ---- landing compaction: lane j <- the j-th landed in-flight slot
    int n_landed = 0;
    for (int base = 0; base < P; base += kThreads) {
        const int i = base + tid;
        const int flag = (i < P && a.landed[(long long)b * P + i]) ? 1 : 0;
        int chunk = 0;
        const int lane = n_landed + block_exclusive_scan(flag, s_redi,
                                                         &chunk);
        if (flag && lane < K)
            s_pid[lane] = a.landed_pages[(long long)b * P + i];
        n_landed += chunk;
        __syncthreads();
    }
    const int n_do = min(n_landed, K);
    __syncthreads();

    // ---- lane ranks within their sets (same-set overflow drops)
    for (int j = tid; j < n_do; j += kThreads) {
        const int s = floor_mod(max(s_pid[j], 0), S);
        int rank = 0, prev = -1;
        for (int i = 0; i < j; ++i) {
            if (floor_mod(max(s_pid[i], 0), S) == s) { ++rank; prev = i; }
        }
        s_rank[j] = rank < W ? rank : -1;
        s_prev[j] = prev;
    }
    __syncthreads();

    // ---- victims: lane j takes the successor of its set's previous
    // victim in (score, way) order — the rank-j way of the stable order
    for (int j = 0; j < n_do; ++j) {
        if (s_rank[j] < 0) continue;              // uniform: shared value
        const int s = floor_mod(max(s_pid[j], 0), S);
        const int row = s * W;
        float lo = INFINITY, hi = -INFINITY;
        for (int w = tid; w < W; w += kThreads) {
            lo = fminf(lo, s_age[row + w]);
            hi = fmaxf(hi, s_age[row + w]);
        }
        const float amin = block_min(lo, s_redf);
        const float amax = block_max(hi, s_redf);
        const float span = __fadd_rn(__fsub_rn(amax, amin), 1.0f);
        const int prev = s_prev[j];
        const int pw = prev >= 0 ? s_vway[prev] : -1;
        const float ps = prev >= 0
            ? slot_score(row + pw, amin, span, dpen, rrip, s_age, s_dirty,
                         s_rrpv)
            : 0.0f;
        float best_s = INFINITY;
        int best_w = INT_MAX;
        for (int w = tid; w < W; w += kThreads) {
            const float sc = slot_score(row + w, amin, span, dpen, rrip,
                                        s_age, s_dirty, s_rrpv);
            if ((prev < 0 || key_less(ps, pw, sc, w))
                && key_less(sc, w, best_s, best_w)) {
                best_s = sc;
                best_w = w;
            }
        }
        const int vw = block_argmin(best_s, best_w, s_redf, s_redi);
        if (tid == 0) s_vway[j] = vw;
        __syncthreads();
    }

    // ---- writeback list and eviction count (victims read before insert)
    const long long eb = static_cast<long long>(b) * K;
    for (int j = tid; j < K; j += kThreads) {
        int ev = -1;
        if (j < n_do && s_rank[j] >= 0) {
            const int v = floor_mod(max(s_pid[j], 0), S) * W + s_vway[j];
            const int vp = s_page[v];
            if (vp >= 0) {
                atomicAdd(&s_misc[0], 1);
                if (s_dirty[v]) ev = vp;
            }
        }
        a.out_evicted[eb + j] = ev;
    }
    __syncthreads();

    // ---- insert the landed pages: clean remote copies, ready = clock
    for (int j = tid; j < n_do; j += kThreads) {
        if (s_rank[j] < 0) continue;
        const int v = floor_mod(max(s_pid[j], 0), S) * W + s_vway[j];
        s_page[v] = s_pid[j];
        s_age[v] = clock;
        s_ready[v] = clock;
        s_dirty[v] = 0;
        s_rrpv[v] = kRrpvInsert;
    }
    if (tid == 0) a.out_n_evict[b] = static_cast<float>(s_misc[0]);

    // ---- landed rows: remote -> pool at the victim slots (all threads)
    const long long land_work = static_cast<long long>(n_do) * vpr;
    for (long long e = tid; e < land_work; e += kThreads) {
        const int j = static_cast<int>(e / vpr);
        const long long c = e - static_cast<long long>(j) * vpr;
        if (s_rank[j] < 0) continue;
        const int v = floor_mod(max(s_pid[j], 0), S) * W + s_vway[j];
        long long src = s_pid[j];
        src = src < 0 ? 0 : (src >= a.remote_rows ? a.remote_rows - 1 : src);
        const long long dst = (static_cast<long long>(b) * N + v) * vpr + c;
        a.kpool[dst] = __ldg(a.remote_k + src * vpr + c);
        a.vpool[dst] = __ldg(a.remote_v + src * vpr + c);
    }
    __syncthreads();   // landing stores land before the hit gathers

    // ---- CAM probe of every request within its set (post-insert)
    for (int r = 0; r < R; ++r) {
        const int pg = a.needed[(long long)b * R + r];
        const int s = floor_mod(pg, S);
        int first = INT_MAX;
        for (int w = tid; w < W; w += kThreads)
            if (s_page[s * W + w] == pg) first = min(first, w);
        const int way = block_min_int(first, s_redi);
        if (tid == 0) {
            const bool present = way < W;
            const int slot = s * W + (present ? way : 0);
            s_slot[r] = slot;
            s_hit[r] = present && s_ready[slot] <= clock;
            a.out_hit[(long long)b * R + r] = s_hit[r] ? 1 : 0;
        }
        __syncthreads();
    }

    // ---- gather: pool -> per-request output, hit or not
    const long long gather_work = static_cast<long long>(R) * vpr;
    for (long long e = tid; e < gather_work; e += kThreads) {
        const int r = static_cast<int>(e / vpr);
        const long long c = e - static_cast<long long>(r) * vpr;
        const long long src = (static_cast<long long>(b) * N + s_slot[r])
            * vpr + c;
        const long long dst = (static_cast<long long>(b) * R + r) * vpr + c;
        a.k_local[dst] = a.kpool[src];
        a.v_local[dst] = a.vpool[src];
    }

    // ---- touch: duplicates resolve as max / min / OR, in request order
    if (tid == 0) {
        for (int r = 0; r < R; ++r) {
            const int slot = s_slot[r];
            const bool hit = s_hit[r] != 0;
            const float age_val = (hit && touch_refresh) ? clock : 0.0f;
            const float rr_val = hit ? kRrpvHit : kRrpvMax;
            if (age_val > s_age[slot]) s_age[slot] = age_val;
            if (rr_val < s_rrpv[slot]) s_rrpv[slot] = rr_val;
            if (hit && a.writes[(long long)b * R + r]) s_dirty[slot] = 1;
        }
    }
    __syncthreads();

    // ---- write the metadata back
    for (int i = tid; i < N; i += kThreads) {
        a.out_page[mb + i] = s_page[i];
        a.out_age[mb + i] = s_age[i];
        a.out_ready[mb + i] = s_ready[i];
        a.out_rrpv[mb + i] = s_rrpv[i];
        a.out_dirty[mb + i] = s_dirty[i];
    }
}

}  // namespace

extern "C" int residency_fused_smem_bytes(int sets, int ways, int lanes,
                                          int requests) {
    const int n = sets * ways;
    return 16 * n + 16 * lanes + 8 * requests + 4 * (32 + 32 + 4) + n;
}

extern "C" int residency_fused_launch(
    const void* page, const void* age, const void* ready, const void* dirty,
    const void* rrpv, const void* landed, const void* landed_pages,
    const void* needed, const void* writes, const void* params,
    void* kpool, void* vpool, const void* remote_k, const void* remote_v,
    void* out_page, void* out_age, void* out_ready, void* out_dirty,
    void* out_rrpv, void* out_evicted, void* out_n_evict, void* out_hit,
    void* k_local, void* v_local, int batch, int sets, int ways,
    int inflight, int lanes, int requests, long long remote_rows,
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
    a.params = static_cast<const float*>(params);
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
    a.remote_rows = remote_rows;
    a.vecs_per_row = row_bytes / 16;
    const int smem = residency_fused_smem_bytes(sets, ways, lanes, requests);
    // raise the block's dynamic shared memory limit once per new maximum
    static int smem_allowed = 48 * 1024;
    if (smem > smem_allowed) {
        cudaError_t err = cudaFuncSetAttribute(
            residency_fused_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_allowed = smem;
    }
    if (batch > 0) {
        residency_fused_kernel<<<batch, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
