// BDI (base + delta-immediate) row compression of int32 words.
//
//   compress:   per row of B words, base = x[0], delta = x - base wrapped
//               to int32, ok = every delta in [-128, 128), deltas clipped
//               to int8;
//   decompress: out = ok ? base + delta (wrapped to int32) : raw.
//
// Replaces the TPU kernels repro/kernels/bdi.py::bdi_compress (:38) and
// ::bdi_decompress (:58), Pallas grids over (8, B) VMEM tiles. Those
// compute x - base and base + delta in int32 with wraparound (the
// reference's int64 casts are int32 without jax's x64 mode); here the
// arithmetic is done on uint32, where wraparound is defined, and only the
// result is read as signed.
//
// On an H100 both passes are bound by bytes (a subtract, two compares and
// a clip per 4-byte word). So:
// - compress gives each row to one warp (8 rows per 256-thread block):
//   lane l loads the row's int4 vectors l, l+32, ... (16-byte loads),
//   writes the four clipped deltas of each as one 32-bit word, and the
//   row's ok is one warp vote (__all_sync); lane 0 writes base and ok.
// - decompress is elementwise over 4-word groups: each thread reads four
//   int8 deltas as one 32-bit word and writes one 16-byte int4, and reads
//   the 16-byte raw group only for rows that did not compress, so a
//   compressible row never touches its raw copy.
//
// Plain C interface, loaded with ctypes. Each launch allocates nothing,
// runs on the caller's stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a block width it was not built for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupsPerThread = 4;

__device__ __forceinline__ uint32_t delta_byte(uint32_t x, uint32_t base,
                                               bool& fits) {
    const int32_t d = static_cast<int32_t>(x - base);
    fits = fits && d >= -128 && d < 128;
    const int32_t c = d < -128 ? -128 : (d > 127 ? 127 : d);
    return static_cast<uint32_t>(static_cast<uint8_t>(
        static_cast<int8_t>(c)));
}

// V int4 vectors per lane: a row holds B = 128 * V words.
template <int V>
__global__ void __launch_bounds__(kThreads)
bdi_compress_kernel(const uint4* __restrict__ x, int32_t* __restrict__ base,
                    uint32_t* __restrict__ deltas, int8_t* __restrict__ ok,
                    long long rows) {
    const long long row = static_cast<long long>(blockIdx.x) * kWarps
        + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;              // whole warp leaves together
    const uint4* src = x + row * (32 * V);
    const uint32_t b = __ldg(reinterpret_cast<const uint32_t*>(src));
    uint32_t* dst = deltas + row * (32 * V);
    bool fits = true;
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const uint4 v = __ldg(src + j * 32 + lane);
        dst[j * 32 + lane] = delta_byte(v.x, b, fits)
            | (delta_byte(v.y, b, fits) << 8)
            | (delta_byte(v.z, b, fits) << 16)
            | (delta_byte(v.w, b, fits) << 24);
    }
    fits = __all_sync(0xffffffffu, fits);
    if (lane == 0) {
        base[row] = static_cast<int32_t>(b);
        ok[row] = fits ? 1 : 0;
    }
}

__device__ __forceinline__ uint32_t rebuild(uint32_t b, uint32_t word,
                                            int k) {
    const int8_t d = static_cast<int8_t>((word >> (8 * k)) & 0xffu);
    return b + static_cast<uint32_t>(static_cast<int32_t>(d));
}

// Group g holds words 4g..4g+3 of the flat (N, B) array, all in row
// g / groups_per_row.
__global__ void __launch_bounds__(kThreads)
bdi_decompress_kernel(const int32_t* __restrict__ base,
                      const uint32_t* __restrict__ deltas,
                      const int8_t* __restrict__ ok,
                      const uint4* __restrict__ raw, uint4* __restrict__ out,
                      long long groups, int groups_per_row) {
    const long long first = static_cast<long long>(blockIdx.x)
        * (kThreads * kGroupsPerThread) + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kGroupsPerThread; ++k) {
        const long long g = first + k * kThreads;
        if (g < groups) {
            const long long row = g / groups_per_row;
            if (__ldg(ok + row) != 0) {
                const uint32_t b = static_cast<uint32_t>(__ldg(base + row));
                const uint32_t w = __ldg(deltas + g);
                out[g] = make_uint4(rebuild(b, w, 0), rebuild(b, w, 1),
                                    rebuild(b, w, 2), rebuild(b, w, 3));
            } else {
                out[g] = __ldg(raw + g);
            }
        }
    }
}

template <int V>
void launch_compress(const void* x, void* base, void* deltas, void* ok,
                     long long rows, cudaStream_t stream) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    bdi_compress_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
        static_cast<const uint4*>(x), static_cast<int32_t*>(base),
        static_cast<uint32_t*>(deltas), static_cast<int8_t*>(ok), rows);
}

}  // namespace

// x (rows, block) int32 -> base (rows,) int32, deltas (rows, block) int8,
// ok (rows,) int8.
extern "C" int bdi_compress_launch(const void* x, void* base, void* deltas,
                                   void* ok, long long rows, int block,
                                   void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (rows > 0) {
        switch (block) {
            case 128: launch_compress<1>(x, base, deltas, ok, rows, stream);
                break;
            case 256: launch_compress<2>(x, base, deltas, ok, rows, stream);
                break;
            case 512: launch_compress<4>(x, base, deltas, ok, rows, stream);
                break;
            case 1024: launch_compress<8>(x, base, deltas, ok, rows, stream);
                break;
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// base (rows,) int32, deltas (rows, block) int8, ok (rows,) int8, raw
// (rows, block) int32 -> out (rows, block) int32.
extern "C" int bdi_decompress_launch(const void* base, const void* deltas,
                                     const void* ok, const void* raw,
                                     void* out, long long rows, int block,
                                     void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (block != 128 && block != 256 && block != 512 && block != 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long groups = rows * (block / 4);
    if (groups > 0) {
        const long long per_block = kThreads * kGroupsPerThread;
        bdi_decompress_kernel<<<static_cast<unsigned>(
                                    (groups + per_block - 1) / per_block),
                                kThreads, 0, stream>>>(
            static_cast<const int32_t*>(base),
            static_cast<const uint32_t*>(deltas),
            static_cast<const int8_t*>(ok), static_cast<const uint4*>(raw),
            static_cast<uint4*>(out), groups, block / 4);
    }
    return static_cast<int>(cudaGetLastError());
}
