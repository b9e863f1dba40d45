// Decode's weight products: out[e, m, n] = sum_k A[e, m, k] * W[e, k, n]
// (W laid out [e][k][n], "KN") or sum_k A[e, m, k] * W[e, n, k] ("NK"),
// for bf16 A and W with at most 64 rows of A: each bf16 x bf16 product
// exact, the products summed in f32, the output f32.
//
// Replaces no TPU kernel: the reference computes these products inside
// XLA's step as `jnp.einsum(..., preferred_element_type=F32)`. The port's
// `layers.dot` widened both operands to f32 and ran an f32 einsum, which
// makes an f32 copy of every weight on every decode step (three times the
// weight's bytes moved, and 1.16 GiB of memory for qwen3-1.7b's head).
// Here each weight element is read once, in bf16.
//
// What bounds it on an H100: at M <= 64 rows the product does at most 64
// operations a weight byte against the ~295 at which the tensor cores,
// not device memory, become the limit, so it is bound by reading W. The
// design:
//   * the weight is the A operand of `mma.sync.m16n8k16` (16 of its
//     output columns a tile) and A's rows are the B operand (8 a tile):
//     M pads to a multiple of 8, not of 16;
//   * each thread loads the weight straight into registers in 8-byte
//     (KN: 4 columns of one k) or 16-byte (NK: 8 k of one column) loads,
//     the streaming path (`ld.global.cs`), the warp's loads covering whole
//     sectors. A product sums over k in any order, so the thread's k
//     positions of the mma fragment are taken where its loads put them
//     (the same positions in both operands): no shared memory and no
//     transpose for the weight; in the KN layout two loaded k rows are
//     paired into one register with a byte permute;
//   * each warp keeps two 32-deep chunks of loads in flight ahead of its
//     mma's;
//   * a block is 8 warps: 2 across 64 output columns, 4 splitting its
//     share of K; where the columns times E give fewer blocks than fill
//     the card twice (narrow N: q, k, v, o, down, the router), a thread
//     block cluster of up to 8 blocks splits K further. Partial sums are
//     added in a fixed order, first the block's warps through shared
//     memory, then the cluster's blocks in rank order through distributed
//     shared memory, by rank 0: no atomics, so two launches give the same
//     bits.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsN = 2;                     // warps across the columns
constexpr int kWarpsK = 4;                     // warps across K
constexpr int kThreads = 32 * kWarpsN * kWarpsK;
constexpr int kWarpCols = 32;                  // output columns of a warp
constexpr int kBlockCols = kWarpsN * kWarpCols;
constexpr int kChunk = 32;                     // k of one loop step
constexpr int kMaxRows = 64;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp's registers for one chunk of 32 k. KN: thread (g, t) holds
// W[k + 16 s + 4 t + r][c + 4 g .. c + 4 g + 3] for step s, r = 0..3, and
// A[8 i + g][k + 16 s + 4 t .. + 3] for tile i. NK: W[c + 16 j + 8 h +
// g][k + 8 t .. + 7] for j, h = 0..1, and A[8 i + g][k + 8 t .. + 7].
template <int kTiles, bool kNK>
struct Chunk;

template <int kTiles>
struct Chunk<kTiles, false> {
    uint2 w[2][4];
    uint2 x[2][kTiles];
};

template <int kTiles>
struct Chunk<kTiles, true> {
    uint4 w[2][2];
    uint4 x[kTiles];
};

template <int kTiles, bool kNK, int kDepth>
__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const uint16_t* __restrict__ a, long long sae,
                     long long sam, const uint16_t* __restrict__ w,
                     long long swe, long long swr, float* __restrict__ out,
                     long long soe, long long som, int m, int k, int n) {
    constexpr int kRegs = kTiles * 2 * 4;      // accumulators a thread
    extern __shared__ float red[];             // (kWarpsK-1) x kWarpsN x
                                               // kRegs x 32
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wn = warp % kWarpsN, wk = warp / kWarpsN;
    const int e = blockIdx.y;
    const int ks = gridDim.z, rank = blockIdx.z;
    const int col0 = blockIdx.x * kBlockCols + wn * kWarpCols;
    const uint16_t* ae = a + e * sae;
    const uint16_t* we = w + e * swe;

    // this warp's chunks: share rank * kWarpsK + wk of ks * kWarpsK
    const int chunks = k / kChunk;
    const int parts = ks * kWarpsK, part = rank * kWarpsK + wk;
    const int c_begin = static_cast<int>(
        static_cast<long long>(part) * chunks / parts);
    const int c_end = static_cast<int>(
        static_cast<long long>(part + 1) * chunks / parts);

    const uint16_t* xrow[kTiles];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
        const int row = 8 * i + g;
        xrow[i] = row < m ? ae + row * sam : nullptr;
    }
    // KN: the thread's 4 columns; NK: its 4 weight rows (j, h)
    const uint16_t* wrow[kNK ? 4 : 1];
    if constexpr (kNK) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int col = col0 + 16 * (r >> 1) + 8 * (r & 1) + g;
            wrow[r] = col < n ? we + col * swr : nullptr;
        }
    } else {
        const int col = col0 + 4 * g;
        wrow[0] = col < n ? we + col : nullptr;
    }

    auto load = [&](Chunk<kTiles, kNK>& f, int c) {
        if constexpr (kNK) {
            const int kk = c * kChunk + 8 * t;
#pragma unroll
            for (int r = 0; r < 4; ++r)
                f.w[r >> 1][r & 1] =
                    wrow[r] ? __ldcs(reinterpret_cast<const uint4*>(
                                  wrow[r] + kk))
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int i = 0; i < kTiles; ++i)
                f.x[i] = xrow[i] ? __ldg(reinterpret_cast<const uint4*>(
                                       xrow[i] + kk))
                                 : make_uint4(0u, 0u, 0u, 0u);
        } else {
            const int kk = c * kChunk + 4 * t;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    f.w[s][r] =
                        wrow[0] ? __ldcs(reinterpret_cast<const uint2*>(
                                      wrow[0] + (kk + 16 * s + r) * swr))
                                : make_uint2(0u, 0u);
#pragma unroll
                for (int i = 0; i < kTiles; ++i)
                    f.x[s][i] =
                        xrow[i] ? __ldg(reinterpret_cast<const uint2*>(
                                      xrow[i] + kk + 16 * s))
                                : make_uint2(0u, 0u);
            }
        }
    };

    float acc[kTiles][2][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

    auto compute = [&](const Chunk<kTiles, kNK>& f) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                uint32_t a0, a1, a2, a3;
                if constexpr (kNK) {
                    // rows g (h 0) and g + 8 (h 1) of tile j; k pairs
                    // (4 s, 4 s + 1) and (4 s + 2, 4 s + 3) of the load
                    a0 = s ? f.w[j][0].z : f.w[j][0].x;
                    a1 = s ? f.w[j][1].z : f.w[j][1].x;
                    a2 = s ? f.w[j][0].w : f.w[j][0].y;
                    a3 = s ? f.w[j][1].w : f.w[j][1].y;
                } else {
                    // tile j's row g is column 4 g + j, row g + 8 column
                    // 4 g + 2 + j; k rows (0, 1) and (2, 3) paired
                    const uint32_t sel = j ? 0x7632u : 0x5410u;
                    a0 = __byte_perm(f.w[s][0].x, f.w[s][1].x, sel);
                    a1 = __byte_perm(f.w[s][0].y, f.w[s][1].y, sel);
                    a2 = __byte_perm(f.w[s][2].x, f.w[s][3].x, sel);
                    a3 = __byte_perm(f.w[s][2].y, f.w[s][3].y, sel);
                }
#pragma unroll
                for (int i = 0; i < kTiles; ++i) {
                    uint32_t b0, b1;
                    if constexpr (kNK) {
                        b0 = s ? f.x[i].z : f.x[i].x;
                        b1 = s ? f.x[i].w : f.x[i].y;
                    } else {
                        b0 = f.x[s][i].x;
                        b1 = f.x[s][i].y;
                    }
                    mma_bf16(acc[i][j], a0, a1, a2, a3, b0, b1);
                }
            }
        }
    };

    Chunk<kTiles, kNK> f[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
        if (c_begin + d < c_end) load(f[d], c_begin + d);
    for (int c = c_begin; c < c_end; c += kDepth) {
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
            if (c + d < c_end) {
                compute(f[d]);
                if (c + d + kDepth < c_end) load(f[d], c + d + kDepth);
            }
        }
    }

    // the block's warps across K, added in warp order by warp wk = 0
    float* flat = &acc[0][0][0];
    if (wk > 0) {
        float* dst = red + ((wk - 1) * kWarpsN + wn) * kRegs * 32;
#pragma unroll
        for (int r = 0; r < kRegs; ++r) dst[r * 32 + lane] = flat[r];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
        for (int q = 1; q < kWarpsK; ++q) {
            const float* src = red + ((q - 1) * kWarpsN + wn) * kRegs * 32;
#pragma unroll
            for (int r = 0; r < kRegs; ++r) flat[r] += src[r * 32 + lane];
        }
    }
    if (ks > 1) {
        // the cluster's blocks, added in rank order by rank 0; each warp
        // writes the slot only it read above
        cg::cluster_group cluster = cg::this_cluster();
        float* mine = red + wn * kRegs * 32;
        if (wk == 0) {
#pragma unroll
            for (int r = 0; r < kRegs; ++r) mine[r * 32 + lane] = flat[r];
        }
        cluster.sync();
        if (rank == 0 && wk == 0) {
            for (int q = 1; q < ks; ++q) {
                const float* src = cluster.map_shared_rank(mine, q);
#pragma unroll
                for (int r = 0; r < kRegs; ++r)
                    flat[r] += src[r * 32 + lane];
            }
        }
        cluster.sync();              // the other ranks' shared memory lives
        if (rank != 0) return;
    }
    if (wk != 0) return;

    float* oe = out + e * soe;
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int row = 8 * i + 2 * t + (q & 1);
                const int h = q >> 1;        // mma row g (0) or g + 8 (1)
                const int col = kNK ? col0 + 16 * j + 8 * h + g
                                    : col0 + 4 * g + 2 * h + j;
                if (row < m && col < n) oe[row * som + col] = acc[i][j][q];
            }
        }
    }
}

template <int kTiles, bool kNK>
cudaError_t launch(const uint16_t* a, long long sae, long long sam,
                   const uint16_t* w, long long swe, long long swr,
                   float* out, long long soe, long long som, int e, int m,
                   int k, int n, int ks, cudaStream_t stream) {
    constexpr int kDepth = kTiles >= 8 ? 1 : 2;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + kBlockCols - 1) / kBlockCols, e, ks);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(kWarpsK - 1) * kWarpsN *
                           kTiles * 8 * 32 * sizeof(float);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = ks;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, decode_matmul_kernel<kTiles, kNK, kDepth>, a, sae, sam, w,
        swe, swr, out, soe, som, m, k, n);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool kNK>
cudaError_t launch_tiles(const uint16_t* a, long long sae, long long sam,
                         const uint16_t* w, long long swe, long long swr,
                         float* out, long long soe, long long som, int e,
                         int m, int k, int n, int ks, cudaStream_t stream) {
    if (m <= 8)
        return launch<1, kNK>(a, sae, sam, w, swe, swr, out, soe, som, e, m,
                              k, n, ks, stream);
    if (m <= 16)
        return launch<2, kNK>(a, sae, sam, w, swe, swr, out, soe, som, e, m,
                              k, n, ks, stream);
    if (m <= 32)
        return launch<4, kNK>(a, sae, sam, w, swe, swr, out, soe, som, e, m,
                              k, n, ks, stream);
    return launch<8, kNK>(a, sae, sam, w, swe, swr, out, soe, som, e, m, k,
                          n, ks, stream);
}

}  // namespace

// a: A's element [0][0][0]; sae, sam its strides (elements) over e and m,
// k contiguous. w: W's element [0][0][0]; swe its stride over e, swr over
// its rows (k for KN, n for NK), the other axis contiguous. out: f32, its
// strides soe, som, n contiguous. ks: the blocks of a cluster across K
// (1, 2, 4 or 8). KN needs 8-byte alignment and strides in multiples of 4
// elements, NK 16 bytes and 8; K a multiple of 32; 1 <= m <= 64.
extern "C" int decode_matmul_launch(const void* a, long long sae,
                                    long long sam, const void* w,
                                    long long swe, long long swr, void* out,
                                    long long soe, long long som, int e,
                                    int m, int k, int n, int nk, int ks,
                                    void* stream) {
    const long long vec = nk ? 8 : 4;
    const bool ok =
        e >= 1 && e <= 65535 && m >= 1 && m <= kMaxRows && k >= kChunk &&
        k % kChunk == 0 && n >= 1 && (nk || n % 4 == 0) &&
        (ks == 1 || ks == 2 || ks == 4 || ks == kMaxCluster) &&
        reinterpret_cast<uintptr_t>(a) % (2 * vec) == 0 &&
        reinterpret_cast<uintptr_t>(w) % (2 * vec) == 0 && sae % vec == 0 &&
        sam % vec == 0 && swe % vec == 0 && swr % vec == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pa = static_cast<const uint16_t*>(a);
    const auto* pw = static_cast<const uint16_t*>(w);
    auto* po = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        nk ? launch_tiles<true>(pa, sae, sam, pw, swe, swr, po, soe, som, e,
                                m, k, n, ks, s)
           : launch_tiles<false>(pa, sae, sam, pw, swe, swr, po, soe, som, e,
                                 m, k, n, ks, s);
    return static_cast<int>(err);
}
