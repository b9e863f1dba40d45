// Paged row gather: out[l] = pool[idx[l]], a negative index counting
// from the end and the index then clamped to [0, P-1] (the reference's
// jnp indexing), or zeros where the optional row mask is 0. One launch
// may gather the same rows from two pools of one shape (the store's K
// and V tiers), with one index list and one mask.
//
// Replaces the TPU kernel repro/kernels/paged_gather.py::paged_gather, a
// scalar-prefetched Pallas grid that copies one (page, H, D) block per
// grid step. On an H100 the gather is a pure copy, bound by bytes: each
// output row is read once from the pool and written once, with no
// arithmetic to hide. At the store's shapes the copy is small (32 rows of
// 32 KB at the serving shape, 1 MB read), so what bounds it in practice
// is how many bytes are in flight when the launch begins (one block per
// row would use 32 of the 132 SMs). The design:
//   * cuts every row into chunks of kThreads * U 16-byte vectors and
//     gives each chunk its own block: 8 KB chunks (U = 4) while that
//     makes fewer than 4 blocks per SM, so 32 rows of 32 KB are 128
//     blocks, one per SM; 16 KB chunks (U = 8) for longer gathers, where
//     the blocks would queue anyway and fewer, fuller ones keep more bytes
//     in flight per resident thread (256 rows: 512 blocks);
//   * has every thread issue all U loads of its chunk (from both pools
//     when it gathers two) through the read-only path before its first
//     store, so a block keeps its whole chunk in flight;
//   * reads the row index once per block from device memory (no host
//     round trip, no scalar prefetch). Masked rows skip their read and
//     store zeros, which is how the store's critical fetch skips rows that
//     hit locally without asking the host whether any row missed.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr long long kManyBlocks = 4 * 132;   // 4 blocks per H100 SM

template <bool kPair, int kUnroll>
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const uint4* __restrict__ pool0,
                    const uint4* __restrict__ pool1,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask,
                    uint4* __restrict__ out0, uint4* __restrict__ out1,
                    long long num_rows, long long vecs_per_row,
                    long long chunks_per_row) {
    constexpr long long kChunk = kThreads * kUnroll;   // vectors per block
    const long long l = blockIdx.x / chunks_per_row;
    const long long c0 = (blockIdx.x - l * chunks_per_row) * kChunk;
    const long long n = min(kChunk, vecs_per_row - c0);
    uint4* dst0 = out0 + l * vecs_per_row + c0;
    uint4* dst1 = kPair ? out1 + l * vecs_per_row + c0 : nullptr;
    if (mask != nullptr && mask[l] == 0) {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (long long e = threadIdx.x; e < n; e += kThreads) {
            dst0[e] = zero;
            if (kPair) dst1[e] = zero;
        }
        return;
    }
    long long p = idx[l];
    if (p < 0) p += num_rows;                  // numpy-style from the end
    p = p < 0 ? 0 : (p >= num_rows ? num_rows - 1 : p);
    const uint4* src0 = pool0 + p * vecs_per_row + c0;
    const uint4* src1 = kPair ? pool1 + p * vecs_per_row + c0 : nullptr;
    uint4 x0[kUnroll], x1[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const long long e = threadIdx.x + u * kThreads;
        if (e < n) {
            x0[u] = __ldg(src0 + e);
            if (kPair) x1[u] = __ldg(src1 + e);
        }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const long long e = threadIdx.x + u * kThreads;
        if (e < n) {
            dst0[e] = x0[u];
            if (kPair) dst1[e] = x1[u];
        }
    }
}

template <int kUnroll>
int launch(const void* pool0, const void* pool1, const void* idx,
           const void* mask, void* out0, void* out1, long long num_out,
           long long num_rows, long long vpr, long long chunks,
           cudaStream_t s) {
    const long long blocks = num_out * chunks;
    if (blocks > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(static_cast<unsigned>(blocks));
    const auto* i = static_cast<const int32_t*>(idx);
    const auto* m = static_cast<const uint8_t*>(mask);
    if (pool1 != nullptr) {
        paged_gather_kernel<true, kUnroll><<<grid, kThreads, 0, s>>>(
            static_cast<const uint4*>(pool0),
            static_cast<const uint4*>(pool1), i, m,
            static_cast<uint4*>(out0), static_cast<uint4*>(out1), num_rows,
            vpr, chunks);
    } else {
        paged_gather_kernel<false, kUnroll><<<grid, kThreads, 0, s>>>(
            static_cast<const uint4*>(pool0), nullptr, i, m,
            static_cast<uint4*>(out0), nullptr, num_rows, vpr, chunks);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool1 and out1 may be null (one pool); num_out rows of row_bytes each.
extern "C" int paged_gather_launch(const void* pool0, const void* pool1,
                                   const void* idx, const void* mask,
                                   void* out0, void* out1, int num_out,
                                   long long num_rows, long long row_bytes,
                                   void* stream) {
    const long long vpr = row_bytes / 16;
    if (num_out <= 0 || vpr <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long chunks4 = (vpr + 4 * kThreads - 1) / (4 * kThreads);
    if (num_out * chunks4 < kManyBlocks)
        return launch<4>(pool0, pool1, idx, mask, out0, out1, num_out,
                         num_rows, vpr, chunks4, s);
    const long long chunks8 = (vpr + 8 * kThreads - 1) / (8 * kThreads);
    return launch<8>(pool0, pool1, idx, mask, out0, out1, num_out, num_rows,
                     vpr, chunks8, s);
}
