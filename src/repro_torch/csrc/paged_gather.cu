// Paged row gather: out[l] = pool[idx[l]], a negative index counting
// from the end and the index then clamped to [0, P-1] (the reference's
// jnp indexing), or zeros where the optional row mask is 0.
//
// Replaces the TPU kernel repro/kernels/paged_gather.py::paged_gather, a
// scalar-prefetched Pallas grid that copies one (page, H, D) block per
// grid step. On an H100 the gather is a pure copy and is bound by bytes:
// each output row is read once from the pool and written once, and there
// is no arithmetic to hide. The design therefore only has to keep the
// copy at full width: one block per output row, every thread moving
// 16-byte vectors (uint4) with neighbouring threads on neighbouring
// addresses, the index read once per block from device memory (no host
// round trip, no scalar prefetch needed). Masked rows skip their read and
// store zeros, which is how the store's critical fetch skips the rows
// that hit locally without asking the host whether any row missed.
//
// Plain C interface, loaded with ctypes. The launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const uint4* __restrict__ pool,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ mask,
                    uint4* __restrict__ out, long long num_rows,
                    long long vecs_per_row) {
    const long long l = blockIdx.x;
    uint4* dst = out + l * vecs_per_row;
    if (mask != nullptr && mask[l] == 0) {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (long long e = threadIdx.x; e < vecs_per_row; e += kThreads)
            dst[e] = zero;
        return;
    }
    long long p = idx[l];
    if (p < 0) p += num_rows;                  // numpy-style from the end
    p = p < 0 ? 0 : (p >= num_rows ? num_rows - 1 : p);
    const uint4* src = pool + p * vecs_per_row;
    for (long long e = threadIdx.x; e < vecs_per_row; e += kThreads)
        dst[e] = __ldg(src + e);
}

}  // namespace

extern "C" int paged_gather_launch(const void* pool, const void* idx,
                                   const void* mask, void* out,
                                   int num_out, long long num_rows,
                                   long long row_bytes, void* stream) {
    if (num_out > 0) {
        paged_gather_kernel<<<num_out, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint4*>(pool),
            static_cast<const int32_t*>(idx),
            static_cast<const uint8_t*>(mask), static_cast<uint4*>(out),
            num_rows, row_bytes / 16);
    }
    return static_cast<int>(cudaGetLastError());
}
